"""dispatch_ms (.stream, .batch): the engine's dispatch timer (PipelineStats.t_dispatch_s: centring, K6, select, sort, id lookup, readback) per query of the window, ms."""
from harness.readers import per_query_ms


def read(ctx):
    return per_query_ms(ctx, "dispatch_s")
