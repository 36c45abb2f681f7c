"""k6_roofline (.stream, .batch): the summed bound of the window's anchor-star searches over the fused kernels' device time in the trace, %."""
from harness.readers import roofline


def read(ctx):
    return roofline(ctx, "k6")
