"""The whole request's share of the card's bf16 dense peak, in %: the operations of the
request's images (``workcount.image_flops``, from the configuration's shapes and any
backbone file it names) over the median request time of the traced run's unprofiled
requests."""

from benchmark import workcount


def read(run):
    flops = run.batch * workcount.image_flops(run.config["model"], run.height, run.width, run.backbone)
    return 100.0 * flops / run.unprofiled_s / workcount.PEAK_BF16_FLOPS
