"""The relative-position attention core's share of its roofline, in %: the least time of
a request's attention cores (the backbone file's ``attention_work``: q·kᵀ, p·v and the
two position products at the bf16 peak, or q, k, v and the output once in bf16 at the
HBM bandwidth, the larger) over the device time inside the ``rel_pos_attention`` spans."""

from benchmark import workcount

SPAN = "rel_pos_attention"


def read(run):
    work = getattr(run.backbone, "attention_work", None)
    if work is None or SPAN not in run.trace.device_spans:
        return None
    model = run.config["model"]
    flops, nbytes = work(model, *workcount.padded_hw(model, run.height, run.width), run.batch)
    seconds = run.trace.busy_in_spans([SPAN])
    return 100.0 * workcount.least_seconds(flops, nbytes, workcount.PEAK_BF16_FLOPS) * run.units / seconds
