"""Device busy ms per request of the frames' upload: the operations that start inside the
port's ``upload`` device span (``maskformer_infer_rba`` copying the uint8 frames to the
card, before ``preprocess``)."""

SPAN = "upload"


def read(run):
    if SPAN not in run.trace.device_spans:
        return None
    return run.trace.busy_in_spans([SPAN]) * 1e3 / run.units
