"""generator_lag_ms.stream: 99th percentile of how late the client submitted a request after its due time, ms."""
import numpy as np


def read(ctx):
    lag = ctx.win.lag_s
    return float(np.percentile(lag, 99.0)) * 1e3 if lag is not None \
        and len(lag) else None
