"""qps: queries answered in the window over the window's whole length (host clock)."""


def read(ctx):
    return ctx.answered() / ctx.win.window_s if ctx.win.window_s else None
