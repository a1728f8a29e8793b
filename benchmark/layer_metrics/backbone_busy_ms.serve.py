"""Device busy ms per request of the ``backbone`` span: the device operations that
start inside its device-side span."""

SPAN = "backbone"


def read(run):
    if SPAN not in run.trace.device_spans:
        return None
    return run.trace.busy_in_spans([SPAN]) * 1e3 / run.units
