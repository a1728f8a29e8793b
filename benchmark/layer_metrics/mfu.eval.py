"""The evaluation's share of the card's bf16 dense peak, in %: the operations of an image
(``workcount.image_flops``, with any backbone file the configuration names) times the
images per second of the traced run's unprofiled passes."""

from benchmark import workcount


def read(run):
    flops = workcount.image_flops(run.config["model"], run.height, run.width, run.backbone)
    return 100.0 * flops / run.unprofiled_s / workcount.PEAK_BF16_FLOPS
