"""MiT-B0 and ViT with its SimpleFeaturePyramid at bf16 against rba_tpu called op by op on
the CPU: each output's equal and one-ulp shares recorded, the least one-ulp share held
at its recorded floor (``tests/test_torch_backbones_bf16.py`` says how).  MiT equals
rba_tpu bit for bit at every output."""
import pytest

from tests.test_torch_backbones_bf16 import bf16_shares_case
from tests.torch_port_common import default_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("default_threads")  # the shares' recorded floors


@pytest.mark.parametrize("family", ["mit_b0", "vit_sfp"])
def test_backbone_bf16_shares(family, request):
    bf16_shares_case(family, request)
