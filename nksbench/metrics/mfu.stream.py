"""mfu.stream: the anchor-star operations of the window's answered requests over the summed wall of the engine's query_batch calls at the fp32 peak, %. An open loop's work a window second is set by its rate, so the window's length would tell nothing."""
from harness.readers import mfu


def read(ctx):
    return mfu(ctx, ctx.spans.wall_s())
