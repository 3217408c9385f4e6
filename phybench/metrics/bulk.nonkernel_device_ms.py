"""Device busy ms per call of the bulk call outside the hand kernel:
``dechirp_planar``, the demodulator's front (scale scan, estimate,
window gather) and ``decode_payload``, with the readout's copies."""

KERNEL = "fused_demod"


def read(ctx):
    t = ctx.trace
    if t.events == 0:
        return None
    kernel_s = sum(s for name, s in t.kernels.items() if KERNEL in name)
    return (t.busy_s - kernel_s) / t.calls * 1e3
