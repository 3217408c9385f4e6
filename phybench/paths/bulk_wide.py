"""The bulk coded decoder as a user calls it where the hand kernel
``fused_demod`` cannot run: N > 128 (SF8-12), at any of the three
bandwidths at osr 1. A batch of frame-aligned captures through
``lora_phy_tpu_torch.ops.planar.dechirp_planar``, then
``demodulate_planar(fused=False)`` (the exact float32 route, whose
per-symbol stage above N = 128 is the torch four-step of ``ops/fft.py``),
then ``lora_phy_tpu_torch.models.coded.decode_payload``, all on the
device; the bytes, ``crc_ok`` and ``fec_errors`` read to the host, as in
:mod:`.bulk`.

At osr 1 the samples are taken at the bandwidth's own rate, so the
bandwidth sets the sample rate and nothing else: the chirps are those of
``LoraParams``'s default scale 1. (``LoraParams(bw=...)`` above 125 kHz
selects the reference library's own tone spacing, under which symbols
``N / 4`` apart share a bin at 500 kHz; docs/SEMANTICS.md.)"""

from __future__ import annotations

import torch

from . import bulk

# the readers carry the ranges they read; none of them names the
# ``planar.fourstep`` range nested in ``planar.decide``
RANGES = ()

BANDWIDTHS_HZ = (125_000, 250_000, 500_000)


class System(bulk.System):
    """The program under test for a ``bulk_wide`` configuration."""

    def __init__(self, config: dict, device: torch.device):
        from lora_phy_tpu_torch import LoraParams
        from lora_phy_tpu_torch.models import coded
        from lora_phy_tpu_torch.ops import planar

        if config["osr"] != 1 or config["bw_hz"] not in BANDWIDTHS_HZ:
            raise ValueError("the wide bulk path is set up for osr 1 at 125, 250 or 500 kHz")
        self.planar, self.coded = planar, coded
        self.params = LoraParams(sf=config["sf"], sync_word=config["sync_word"])
        self.cfg = coded.CodedConfig(sf=config["sf"], cr=config["cr"], crc=config["crc"],
                                     whiten=config["whiten"])
        self.config = config

    def device(self, item):
        """Dechirp, demodulate on the exact float32 route, decode: device
        tensors."""
        dr, di = self.planar.dechirp_planar(item.xr, item.xi, self.params)
        res = self.planar.demodulate_planar(dr, di, self.params, fused=False)
        payload, crc_ok, fec = self.coded.decode_payload(
            res.symbols, self.config["payload_bytes"], self.cfg)
        return res, payload, crc_ok, fec
