"""Share (%) of its roofline that the hand kernel ``csrc/fused_demod.cu``
reaches in the bulk call: the least time one H100 could take for the
call's rows by the frozen count of :mod:`.kernel_bound` (bytes at 3.35
TB/s, or operations at 67 TFLOP/s in float32, the larger), over the
kernel's device time per call in the trace, found by its name."""

from ..traffic.generator import call_size, payload_symbol_count
from .kernel_bound import fused_demod_bound_s

KERNEL = "fused_demod"


def read(ctx):
    t = ctx.trace
    kernel_s = sum(s for name, s in t.kernels.items() if KERNEL in name)
    if kernel_s <= 0:
        return None
    # one row a symbol window: the sync pair and the payload of every frame
    rows = call_size(ctx.config, ctx.traffic)[1] * (2 + payload_symbol_count(ctx.config))
    bound_s, _ = fused_demod_bound_s(rows, 1 << ctx.config["sf"])
    return 100.0 * bound_s / (kernel_s / t.calls)
