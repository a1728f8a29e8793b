"""Device busy ms per request of the relative-position attention's core: the operations
that start inside the port's ``rel_pos_attention`` device spans (one per ViTDet or MViT
block, around q·kᵀ, the position tables' resampling and gathers, both position products,
the casts, the softmax and the product with v)."""

SPAN = "rel_pos_attention"


def read(run):
    if SPAN not in run.trace.device_spans:
        return None
    return run.trace.busy_in_spans([SPAN]) * 1e3 / run.units
