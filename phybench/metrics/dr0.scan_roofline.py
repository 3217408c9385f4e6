"""Share (%) of its roofline that the block receiver's scan reaches at
SF12: the least time one H100 could take for the call's scan by the
frozen count of :mod:`.scan_bound` (bytes at 3.35 TB/s, or operations
at 67 TFLOP/s in float32, the larger), over the device time per call of
the ``front`` range of ``lora_phy_tpu_torch/models/sync.py``."""

from ..traffic.generator import call_size
from .range_reads import device_ms
from .scan_bound import scan_bound_s

RANGES = ("front",)


def read(ctx):
    front_ms = device_ms(ctx.trace, RANGES)
    if front_ms is None:
        return None
    bound_s, _ = scan_bound_s(call_size(ctx.config, ctx.traffic)[0], 1 << ctx.config["sf"])
    return 100.0 * bound_s * 1e3 / front_ms
