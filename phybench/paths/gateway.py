"""The gateway receiver as a user calls it: one block of every channel
through ``lora_phy_tpu_torch.models.sync.receive_block_planar`` on the
device, then every lane's fields and symbols read to the host in one
copy each, and the found frames' bytes decoded there by
``lora_phy_tpu_torch.models.modem.decode``."""

from __future__ import annotations

import numpy as np
import torch

# the program's record_function ranges that the traced run attributes: the
# block receiver's stages (``lora_phy_tpu_torch/models/sync.py``), by the
# names they have there; a metric reads a range by its name
RANGES = ("front", "gather", "probes", "sections", "dechirp", "estimator", "demod", "sro")


class System:
    """The program under test for a ``gateway`` configuration."""

    def __init__(self, config: dict, device: torch.device):
        from lora_phy_tpu_torch import LoraParams
        from lora_phy_tpu_torch.models import modem, sync

        if config["osr"] != 1 or config["bw_hz"] != 125_000:
            raise ValueError("the gateway path is set up for osr 1 at 125 kHz")
        self.sync, self.modem = sync, modem
        self.params = LoraParams(sf=config["sf"], sync_word=config["sync_word"])
        self.config = config
        self.n_payload = 2 * config["payload_bytes"]

    def device(self, item):
        """The device part of a call: the receiver's BlockFrames."""
        c = self.config
        return self.sync.receive_block_planar(
            item.xr, item.xi, self.params, self.n_payload, max_frames=c["max_frames"],
            preamble_len=c["preamble_len"], min_power_db=c["min_power_db"])

    def readout(self, blk) -> dict:
        """The host part: fields and symbols of every lane on the host,
        the found frames' bytes decoded there."""
        fields = torch.stack([blk.found.to(torch.float64), blk.start.to(torch.float64),
                              blk.cfo_bins.to(torch.float64), blk.sync.to(torch.float64),
                              blk.cfo.to(torch.float64), blk.time_offset.to(torch.float64),
                              blk.snr_db.to(torch.float64), blk.sro_ppm.to(torch.float64)]).cpu()
        symbols = blk.symbols.cpu()
        found = fields[0] != 0
        out = {"found": found.numpy(), "start": fields[1].numpy().astype(np.int64),
               "cfo_bins": fields[2].numpy().astype(np.int64),
               "sync": fields[3].numpy().astype(np.int64), "cfo": fields[4].numpy(),
               "time_offset": fields[5].numpy(), "snr_db": fields[6].numpy(),
               "sro_ppm": fields[7].numpy(), "symbols": symbols.numpy().astype(np.int64)}
        payload = np.zeros((*found.shape, self.config["payload_bytes"]), np.uint8)
        payload[found.numpy()] = self.modem.decode(symbols[found]).numpy()
        out["bytes"] = payload
        return out

    def outputs(self, handle, host: dict) -> dict:
        """What the check compares: everything the readout brought back."""
        return host
