"""Device busy ms per request of the spatial-reduction attention's core: the operations
that start inside the port's ``sr_attention`` device spans (one per MiT block, around
q·kᵀ, the scale, the softmax with its casts and the product with v)."""

SPAN = "sr_attention"


def read(run):
    if SPAN not in run.trace.device_spans:
        return None
    return run.trace.busy_in_spans([SPAN]) * 1e3 / run.units
