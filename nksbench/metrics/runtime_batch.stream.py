"""runtime_batch.stream: mean coalesced batch of the serving runtime over the window (RuntimeStats: batched queries over batches)."""


def read(ctx):
    rt = ctx.win.runtime
    return rt["batched_queries"] / rt["batches"] if rt and rt["batches"] \
        else None
