"""Device operations (kernels, copies, fills) per request: those that start inside the
port's ``request`` span on the device.  The profiler mirrors a span on the device from
the first to the last operation whose innermost span it is, so the request's operations
are those inside the device spans of the request and of every span it opens.  A count,
the same for every request of a configuration and traffic; ``None`` without the
``request`` span."""
import bisect

REQUEST = "request"
OPENED = ("upload", "preprocess", "backbone", "window_attention", "pixel_decoder", "deform_sampling",
          "transformer_decoder", "rba_tail")  # the spans a request opens inside it


def read(run):
    if REQUEST not in run.trace.host_spans:
        return None
    starts = [op[0] for op in run.trace.device]
    inside = set()
    for name in (REQUEST, *OPENED):
        for start, end in run.trace.device_spans.get(name, ()):
            inside.update(range(bisect.bisect_left(starts, start), bisect.bisect_left(starts, end)))
    return len(inside) / run.units
