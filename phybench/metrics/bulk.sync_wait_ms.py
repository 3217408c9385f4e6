"""Host ms per call that the bulk call spends waiting in its host syncs:
the host time of the program's ``host_sync`` ranges
(``lora_phy_tpu_torch/utils/profiling.py`` ``host_sync``; the copy of N
in ``ops/planar.py`` ``detect_planar`` and each plane's ``t_off == 0``
read in ``models/modem.py`` ``_shifted_symbol_gather``). The host is
blocked while the queue drains; the device is not idle then."""

from .range_reads import host_ms

RANGES = ("host_sync",)


def read(ctx):
    return host_ms(ctx.trace, RANGES[0])
