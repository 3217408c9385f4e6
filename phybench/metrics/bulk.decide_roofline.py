"""Share (%) of its roofline that the demodulator's per-symbol stage
reaches in the bulk call, whatever implements it: the least time one
H100 could take for the call's rows by the frozen count of
:mod:`.kernel_bound` (one N-point FFT, derotation, |.|^2 and first-max a
row; bytes at 3.35 TB/s, or operations at 67 TFLOP/s in float32, the
larger), over the device time per call of the program's ``planar.decide``
range (``lora_phy_tpu_torch/ops/planar.py`` ``demodulate_planar``)."""

from ..traffic.generator import call_size, payload_symbol_count
from .kernel_bound import fused_demod_bound_s
from .range_reads import device_ms

RANGES = ("planar.decide",)


def read(ctx):
    decide_ms = device_ms(ctx.trace, RANGES)
    if decide_ms is None:
        return None
    # one row a symbol window: the sync pair and the payload of every frame
    rows = call_size(ctx.config, ctx.traffic)[1] * (2 + payload_symbol_count(ctx.config))
    bound_s, _ = fused_demod_bound_s(rows, 1 << ctx.config["sf"])
    return 100.0 * bound_s * 1e3 / decide_ms
