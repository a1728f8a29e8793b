"""Kernel B's share of its roofline, in %: the least time of a request's RbA tail
(``workcount.fused_rba_work``: bytes at the HBM bandwidth, or the class contraction at
the rate of an fp32-accurate product on the tensor cores, the larger) over the device
time inside the ``rba_tail`` span."""

from benchmark import workcount

SPAN = "rba_tail"


def read(run):
    if SPAN not in run.trace.device_spans:
        return None
    seconds = run.trace.busy_in_spans([SPAN])
    flops, nbytes = workcount.fused_rba_work(run.config["model"], run.height, run.width, run.batch)
    return 100.0 * workcount.least_seconds(flops, nbytes, workcount.PEAK_SPLIT_TF32_FLOPS) * run.units / seconds
