"""Device busy ms per request of MViT's q/k/v pooling: the operations that start inside
the port's ``qkv_pool`` device spans (one per MViT block, around the three 3x3 depthwise
pooling convs and their LayerNorms)."""

SPAN = "qkv_pool"


def read(run):
    if SPAN not in run.trace.device_spans:
        return None
    return run.trace.busy_in_spans([SPAN]) * 1e3 / run.units
