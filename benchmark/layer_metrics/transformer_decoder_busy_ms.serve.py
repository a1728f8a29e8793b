"""Device busy ms per request of the ``transformer_decoder`` span: the device operations that
start inside its device-side span."""

SPAN = "transformer_decoder"


def read(run):
    if SPAN not in run.trace.device_spans:
        return None
    return run.trace.busy_in_spans([SPAN]) * 1e3 / run.units
