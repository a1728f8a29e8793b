"""Device busy ms per request of Kernel A: the operations that start inside the port's
``window_attention`` device spans (one per call of ``kernels/window_attention.py``
``window_attention``, which launches the kernel and nothing else on the device)."""

SPAN = "window_attention"


def read(run):
    if SPAN not in run.trace.device_spans:
        return None
    return run.trace.busy_in_spans([SPAN]) * 1e3 / run.units
