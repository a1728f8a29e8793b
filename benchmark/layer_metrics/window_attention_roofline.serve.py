"""Kernel A's share of its roofline, in %: the least time of a request's window attention
(``workcount.window_attention_work``: bytes at the HBM bandwidth or operations at the
bf16 peak, the larger) over the device time of the kernels named below."""

from benchmark import workcount

KERNELS = ("window_attention_mma_kernel", "window_attention_kernel")


def read(run):
    seconds = run.trace.kernel_s(KERNELS)
    if not seconds:
        return None
    flops, nbytes = workcount.window_attention_work(run.config["model"], run.height, run.width, run.batch)
    return 100.0 * workcount.least_seconds(flops, nbytes, workcount.PEAK_BF16_FLOPS) * run.units / seconds
