"""setup_s: seconds from the process start to the window, on the host clock: imports, the corpus made from the seed, the engine built (corpus upload, its cost-model calibration, kernel builds or loads), the warm-up."""


def read(ctx):
    return ctx.setup_s
