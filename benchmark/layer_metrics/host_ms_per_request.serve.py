"""Host ms per request inside the entry's layer spans (``maskformer_infer_rba``'s
``record_function`` spans, profiler on): the time the host spends launching a request."""

SPANS = ("preprocess", "backbone", "pixel_decoder", "transformer_decoder", "rba_tail")


def read(run):
    if not run.trace.span_count("backbone"):
        return None
    return run.trace.host_span_s(SPANS) * 1e3 / run.units
