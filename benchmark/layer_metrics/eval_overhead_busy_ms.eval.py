"""Device busy ms per image outside the model's layer spans during the evaluation: the
evaluator's label upload and casts, its histograms and its range reductions
(``evalx/evaluator.py``, ``evalx/metrics.py``)."""

SPANS = ("preprocess", "backbone", "pixel_decoder", "transformer_decoder", "rba_tail")


def read(run):
    if "backbone" not in run.trace.device_spans:
        return None
    return run.trace.busy_outside_spans(SPANS) * 1e3 / run.units
