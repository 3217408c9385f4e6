"""The bulk coded decoder as a user calls it: a batch of frame-aligned
captures through ``lora_phy_tpu_torch.ops.planar.dechirp_planar``, then
``demodulate_planar(fused=True)`` (the exact float32 path through the
hand-written kernel ``csrc/fused_demod.cu``), then
``lora_phy_tpu_torch.models.coded.decode_payload``, all on the device;
the bytes, ``crc_ok`` and ``fec_errors`` read to the host."""

from __future__ import annotations

import numpy as np
import torch

# the program's record_function ranges that the traced run attributes:
# none yet on this path
RANGES = ()


class System:
    """The program under test for a ``bulk`` configuration."""

    def __init__(self, config: dict, device: torch.device):
        from lora_phy_tpu_torch import LoraParams
        from lora_phy_tpu_torch.models import coded
        from lora_phy_tpu_torch.ops import planar

        if config["osr"] != 1 or config["bw_hz"] != 125_000:
            raise ValueError("the bulk path is set up for osr 1 at 125 kHz")
        self.planar, self.coded = planar, coded
        self.params = LoraParams(sf=config["sf"], sync_word=config["sync_word"])
        self.cfg = coded.CodedConfig(sf=config["sf"], cr=config["cr"], crc=config["crc"],
                                     whiten=config["whiten"])
        self.config = config

    def device(self, item):
        """Dechirp, demodulate, decode: device tensors."""
        dr, di = self.planar.dechirp_planar(item.xr, item.xi, self.params)
        res = self.planar.demodulate_planar(dr, di, self.params, fused=True)
        payload, crc_ok, fec = self.coded.decode_payload(
            res.symbols, self.config["payload_bytes"], self.cfg)
        return res, payload, crc_ok, fec

    def readout(self, handle) -> dict:
        """What the user reads: bytes, crc_ok and fec_errors on the host."""
        _, payload, crc_ok, fec = handle
        return {"bytes": payload.cpu().numpy(), "crc_ok": crc_ok.cpu().numpy(),
                "fec_errors": fec.cpu().numpy()}

    def outputs(self, handle, host: dict) -> dict:
        """What the check compares: the host part, and the demodulator's
        symbols, sync word and offsets of the same call."""
        res = handle[0]
        out = dict(host)
        out.update(symbols=res.symbols.cpu().numpy().astype(np.int64),
                   sync=res.sync_word.cpu().numpy().astype(np.int64),
                   cfo=res.cfo.cpu().numpy().astype(np.float64),
                   time_offset=res.time_offset.cpu().numpy().astype(np.float64))
        return out
