"""p50_ms: median latency of the requests due in the window, from due time to answer."""
from harness.readers import latency_ms


def read(ctx):
    return latency_ms(ctx, 50.0)
