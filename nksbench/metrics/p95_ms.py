"""p95_ms: 95th percentile latency of the requests due in the window, from due time to answer; failed requests count as never answered."""
from harness.readers import latency_ms


def read(ctx):
    return latency_ms(ctx, 95.0)
