"""Host ms per call that the gateway receiver spends waiting in its host
syncs: the host time of the program's ``host_sync`` ranges inside
``lora_phy_tpu_torch/models/sync.py`` ``receive_block_planar`` (on the
circular path the copy of N in ``ops/planar.py`` ``detect_planar``, in
the ``estimator`` stage)."""

from .range_reads import host_ms

RANGES = ("host_sync",)


def read(ctx):
    return host_ms(ctx.trace, RANGES[0])
