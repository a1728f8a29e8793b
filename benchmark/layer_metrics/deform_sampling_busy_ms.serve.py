"""Device busy ms per request of the deformable sampling (``ops/deform_sampling.py``'s
``deform_sampling`` span, one per encoder layer)."""

SPAN = "deform_sampling"


def read(run):
    if SPAN not in run.trace.device_spans:
        return None
    return run.trace.busy_in_spans([SPAN]) * 1e3 / run.units
