"""The 95th percentile over every call of the window (linear between order
statistics) of the host time from handing a block to the receiver until
its frames' fields and bytes are on the host, in ms."""

import numpy as np


def read(ctx):
    return float(np.percentile(np.asarray(ctx.window.latencies_s, np.float64), 95)) * 1e3
