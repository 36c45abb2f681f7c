"""pack_ms (.stream, .batch): the engine's packing timer (PipelineStats.t_pack_s: host id packing, upload, device gather) per query of the window, ms."""
from harness.readers import per_query_ms


def read(ctx):
    return per_query_ms(ctx, "pack_s")
