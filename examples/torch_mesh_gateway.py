#!/usr/bin/env python3
"""A resumable multi-channel gateway on a device mesh, on the PyTorch port
— the twin of ``examples/mesh_gateway.py``.

A ``(channel, time)`` mesh receives a continuous multi-channel IQ stream
block by block — every block rides ONE sharded call (scan + seam halos +
demod), the host carries only a fixed-length tail — and the whole
receiver checkpoints to a file at any block boundary and resumes
bit-exactly (frames straddling the checkpoint boundary included).

The mesh is 2 x 2 shards of ``--device`` (default the first CUDA card;
``--device=cpu`` for the CPU): shards may share one device, as the port's
meshes do (``lora_phy_tpu_torch.parallel.mesh``).

    python examples/torch_mesh_gateway.py --device=cpu
"""

import os
import pathlib
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from lora_phy_tpu_torch import LoraParams, device_of  # noqa: E402
from lora_phy_tpu_torch.models import modem, stream  # noqa: E402
from lora_phy_tpu_torch.parallel import mesh as meshlib  # noqa: E402
from lora_phy_tpu_torch.parallel.stream import (  # noqa: E402
    MeshStreamDemodulator,
    load_mesh_state,
    save_mesh_state,
)


def main(argv=None) -> int:
    name = None
    for a in (sys.argv[1:] if argv is None else argv):
        if a.startswith("--device="):
            name = a.split("=", 1)[1]
        else:
            raise SystemExit(f"unknown flag {a}")
    dev = device_of(None, name)
    p = LoraParams(sf=7)
    n_channels = 2
    m = meshlib.make_mesh(n_channel=n_channels, n_time=2, devices=[dev] * 4)
    rx = MeshStreamDemodulator(p, n_payload_symbols=8, mesh=m, max_frames=2)

    # --- synthesize a 3-block stream with frames at arbitrary positions,
    # one straddling every block boundary --------------------------------
    B = 16384
    n_blocks = 3
    frame_len = stream.frame_overhead_samples(p) + 8 * p.step
    rng = np.random.RandomState(0)
    xr = torch.zeros((n_channels, n_blocks * B), dtype=torch.float32, device=dev)
    xi = torch.zeros_like(xr)
    placed = {}
    for c in range(n_channels):
        starts = [4000 + 57 * c + b * B for b in range(n_blocks)]
        starts += [b * B - frame_len // 2 + 31 * c for b in range(1, n_blocks)]
        for s in starts:
            pl = rng.randint(0, 256, 4).astype(np.uint8)
            fr, fi = stream.frame_modulate_planar(modem.encode(pl, device=dev), p)
            xr[c, s: s + frame_len] = fr
            xi[c, s: s + frame_len] = fi
            placed[(c, s)] = pl

    # --- feed blocks; checkpoint+restart between blocks 1 and 2 ---------
    ckpt = os.path.join(tempfile.mkdtemp(), "gateway.ckpt")
    state = rx.init_state(n_channels)
    recovered = {}
    for b in range(n_blocks):
        if b == 2:
            save_mesh_state(state, ckpt)
            print(f"[block {b}] checkpointed to {ckpt}; simulating restart")
            rx = MeshStreamDemodulator(p, 8, m, max_frames=2)  # fresh process
            state = load_mesh_state(ckpt, device=dev)
        state, frames = rx.process(
            state, xr[:, b * B: (b + 1) * B], xi[:, b * B: (b + 1) * B])
        for f in frames:
            payload = modem.decode(f["symbols"]).cpu().numpy()
            recovered[(f["channel"], f["start"])] = payload
            print(f"[block {b}] ch{f['channel']} @{f['start']}: "
                  f"{payload.tobytes().hex()} snr={f['snr_db']:.1f} dB")

    assert set(recovered) == set(placed), "frame set mismatch"
    for key, pl in placed.items():
        assert np.array_equal(recovered[key], pl), key
    print(f"all {len(placed)} frames recovered exactly once "
          f"({rx.t_size} time shards, {n_channels} channels, "
          "checkpoint/restart mid-stream)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
