"""The port's dataset tables and catalog against rba_tpu's: the Mapillary → Cityscapes
LUT and the other taxonomies, every category table, the metadata functions, the names
the catalog registers and the metadata of each (one case per name).  All equal."""
import numpy as np
import pytest

from rba_tpu.data import catalog as jcatalog
from rba_tpu.data import categories as jcategories
from rba_tpu.data import taxonomies as jtaxonomies
from rba_tpu_torch.data import catalog as tcatalog
from rba_tpu_torch.data import categories as tcategories
from rba_tpu_torch.data import taxonomies as ttaxonomies
from tests.torch_port_common import catalogs_restored

TABLES = ["COCO_STUFF_10K_CATEGORIES", "COCO_PANOPTIC_CATEGORIES", "MAPILLARY_VISTAS_CATEGORIES",
          "MAPILLARY_VISTAS_PANOPTIC_CATEGORIES", "STREET_HAZARDS_CLASSES", "OPEN_PANOPTIC_UNKNOWN_CLASSES"]
METADATA = ["coco_stuff_10k_metadata", "mapillary_metadata", "mapillary_panoptic_metadata",
            "street_hazards_metadata"]

with catalogs_restored():
    jcatalog.register_standard_datasets("datasets")
    STANDARD_NAMES = jcatalog.registered()


def test_mapillary_to_cityscapes_lut():
    assert np.array_equal(ttaxonomies.MAPILLARY_TO_CITYSCAPES_IDS, jtaxonomies.MAPILLARY_TO_CITYSCAPES_IDS)
    assert ttaxonomies.MAPILLARY_TO_CITYSCAPES_IDS.dtype == np.int32
    for size in (256, 70):
        got, want = ttaxonomies.mapillary_to_cityscapes_lut(size), jtaxonomies.mapillary_to_cityscapes_lut(size)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    lut = ttaxonomies.mapillary_to_cityscapes_lut()
    assert lut[65] == 255 and sorted(set(lut[:66]) - {255}) == list(range(19))  # void and all 19 classes


def test_other_taxonomies():
    for name in ("CITYSCAPES_CLASSES", "CITYSCAPES_THING_CLASSES", "STREET_HAZARDS_CLASSES",
                 "STREET_HAZARDS_ANOMALY_ID"):
        assert getattr(ttaxonomies, name) == getattr(jtaxonomies, name), name
    assert np.array_equal(ttaxonomies.CITYSCAPES_PALETTE, jtaxonomies.CITYSCAPES_PALETTE)


@pytest.mark.parametrize("name", TABLES)
def test_category_tables(name):
    got, want = getattr(tcategories, name), getattr(jcategories, name)
    assert got == want
    assert len(got) == {"COCO_STUFF_10K_CATEGORIES": 171, "COCO_PANOPTIC_CATEGORIES": 133,
                        "MAPILLARY_VISTAS_CATEGORIES": 66, "MAPILLARY_VISTAS_PANOPTIC_CATEGORIES": 65,
                        "STREET_HAZARDS_CLASSES": 14, "OPEN_PANOPTIC_UNKNOWN_CLASSES": 16}[name]


@pytest.mark.parametrize("name", METADATA)
def test_metadata_functions(name):
    assert getattr(tcatalog, name)() == getattr(jcatalog, name)()


def test_mapillary_void_is_the_ignore_label():
    """Position 65 of the 66-row table is void--unlabeled, not evaluated: the 65 classes
    before it are the stuff classes, and 65 is the ignore label."""
    meta = tcatalog.mapillary_metadata()
    assert tcategories.MAPILLARY_VISTAS_CATEGORIES[65][0] == "void--unlabeled"
    assert len(meta["stuff_classes"]) == 65 and meta["ignore_label"] == 65


def test_registered_names_equal(tmp_path):
    with catalogs_restored():
        tcatalog.register_standard_datasets(str(tmp_path))
        jcatalog.register_standard_datasets(str(tmp_path))
        assert tcatalog.registered() == jcatalog.registered() == STANDARD_NAMES
        assert not hasattr(tcatalog, "_not_ported")


@pytest.mark.parametrize("name", STANDARD_NAMES)
def test_standard_metadata(tmp_path, name):
    with catalogs_restored():
        tcatalog.register_standard_datasets(str(tmp_path))
        jcatalog.register_standard_datasets(str(tmp_path))
        assert tcatalog.metadata(name) == jcatalog.metadata(name)
