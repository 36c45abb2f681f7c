"""mfu.batch: the anchor-star operations that the window's answered queries need, over the window's seconds at the fp32 peak, %."""
from harness.readers import mfu


def read(ctx):
    return mfu(ctx, ctx.win.window_s)
