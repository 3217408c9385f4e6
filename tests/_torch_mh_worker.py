"""Worker process of tests/test_torch_multihost.py: the port's
multi-process mesh over gloo. Each process joins the process group, owns
half of the time axis (four CPU shards), and checks, against the port's
single-device functions on the full stream:

* COLLECTIVES: pmax, both ring permutes and shard 0's broadcast across
  the process seam, value for value;
* PARITY: the planar streaming demod (cross-process halos, amplitude
  pmax and estimate broadcast), symbols and sync gathered from both
  processes, a loud second half so the pmax crosses the seam;
* SCAN: the sharded frame scan with a frame straddling the process seam,
  claimed once at its global start.

Imports torch and the port only. Usage:
python tests/_torch_mh_worker.py <process_id> <num_processes> <host:port>
"""

import os
import sys

proc_id, nproc, coord = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from lora_phy_tpu_torch import LoraParams  # noqa: E402
from lora_phy_tpu_torch.models import modem, sync  # noqa: E402
from lora_phy_tpu_torch.models import stream as streammod  # noqa: E402
from lora_phy_tpu_torch.ops import planar  # noqa: E402
from lora_phy_tpu_torch.parallel import mesh as meshlib  # noqa: E402
from lora_phy_tpu_torch.parallel import multihost  # noqa: E402
from lora_phy_tpu_torch.parallel.stream import (  # noqa: E402
    demodulate_stream_planar, receive_stream_block_planar)

CPU = torch.device("cpu")
SHARDS = 4                               # local time shards per process


def check(ok, msg):
    if not ok:
        raise AssertionError(msg)


def collectives(m):
    t_total = m.n_time
    x = torch.arange(2 * 4 * t_total, dtype=torch.float32).reshape(2, -1)
    local = multihost.global_stream_array(
        m, x[:, proc_id * 4 * SHARDS:(proc_id + 1) * 4 * SHARDS])

    def body(shard, blk):
        mx = yield meshlib.pmax(blk.amax(dim=-1))
        right = yield meshlib.ppermute(blk[:, :1], -1)
        left = yield meshlib.ppermute(blk[:, -1:], 1)
        first = yield meshlib.psum_first(blk[:, 0] + shard.t_idx)
        return shard.t_idx, mx, right, left, first

    for row in meshlib.run_shards(m, body, local.blocks):
        for t, mx, right, left, first in row:
            check(torch.equal(mx, x.amax(dim=-1)), f"pmax at {t}: {mx}")
            want_r = x[:, 4 * t + 4:4 * t + 5] if t < t_total - 1 else torch.zeros(2, 1)
            want_l = x[:, 4 * t - 1:4 * t] if t > 0 else torch.zeros(2, 1)
            check(torch.equal(right, want_r), f"right halo at {t}: {right}")
            check(torch.equal(left, want_l), f"left halo at {t}: {left}")
            check(torch.equal(first, x[:, 0]), f"broadcast at {t}: {first}")
    print(f"COLLECTIVES OK process {proc_id}/{nproc}", flush=True)


def parity(m, p, rng):
    n_channels = 2
    payloads = rng.randint(0, 256, (n_channels, 31)).astype(np.uint8)
    re, im = planar.modulate_planar(modem.encode(torch.from_numpy(payloads)), p)
    dr, di = planar.dechirp_planar(re, im, p)
    half = dr.shape[-1] // 2
    dr[:, half:] *= 2.5                  # the amplitude max lives in process 1
    di[:, half:] *= 2.5
    t_local = dr.shape[-1] // nproc
    sl = slice(proc_id * t_local, (proc_id + 1) * t_local)
    xr = multihost.global_stream_array(m, dr[:, sl])
    xi = multihost.global_stream_array(m, di[:, sl])
    syms, sync_word, cfo, _ = demodulate_stream_planar(xr, xi, p, m)
    check(syms.shape == (n_channels, t_local // p.step), f"local symbols {syms.shape}")
    all_syms = multihost.process_allgather(syms, m)
    ref = planar.demodulate_planar(dr, di, p)
    check(torch.equal(all_syms[:, 2:], ref.symbols), "symbols differ from one device")
    check(torch.equal(sync_word, ref.sync_word), "sync differs from one device")
    check(torch.allclose(cfo, ref.cfo, rtol=0, atol=1e-6), "cfo differs from one device")
    check(torch.equal(modem.decode(all_syms[:, 2:]), torch.from_numpy(payloads)),
          "decoded payloads differ")
    print(f"PARITY OK process {proc_id}/{nproc}", flush=True)


def scan(m, p, rng):
    n_pay = 8
    frame_len = streammod.frame_overhead_samples(p) + n_pay * p.step
    total = 4096 * m.n_time
    sr = torch.zeros(1, total)
    si = torch.zeros(1, total)
    placed = {}
    for off in (500, total // nproc - frame_len // 2):
        pl = rng.randint(0, 256, n_pay // 2).astype(np.uint8)
        fr, fi = streammod.frame_modulate_planar(modem.encode(torch.from_numpy(pl)), p)
        sr[0, off: off + frame_len] = fr
        si[0, off: off + frame_len] = fi
        placed[off] = pl
    t_loc = total // nproc
    ssl = slice(proc_id * t_loc, (proc_id + 1) * t_loc)
    blk = receive_stream_block_planar(multihost.global_stream_array(m, sr[:, ssl]),
                                      multihost.global_stream_array(m, si[:, ssl]),
                                      p, n_pay, m, max_frames=2)
    gf = multihost.process_allgather(blk.found, m)
    gs = multihost.process_allgather(blk.start, m)
    gsym = multihost.process_allgather(blk.symbols, m, dim=1)
    ks = torch.nonzero(gf[0]).flatten().tolist()
    got = {int(gs[0, k]): modem.decode(gsym[0, k]).numpy() for k in ks}
    check(set(got) == set(placed), f"frames at {sorted(got)}, placed {sorted(placed)}")
    for off, pl in placed.items():
        check(np.array_equal(got[off], pl), f"frame at {off} decodes wrong")
    ref = sync.receive_block_planar(sr, si, p, n_pay, max_frames=4)
    check(sorted(ref.start[ref.found].tolist()) == sorted(placed),
          "the single-device receiver disagrees")
    print(f"SCAN OK process {proc_id}/{nproc} (frame straddles the process seam "
          f"at {total // nproc})", flush=True)


def main() -> int:
    multihost.initialize(coordinator_address=coord, num_processes=nproc,
                         process_id=proc_id, backend="gloo")
    m = meshlib.make_mesh(n_channel=1, n_time=SHARDS * nproc, devices=[CPU] * SHARDS)
    check(m.shape == {"channel": 1, "time": SHARDS * nproc}, m)
    check(m.time_base == SHARDS * proc_id and m.group is not None, m)
    p = LoraParams(sf=7)
    rng = np.random.RandomState(7)               # the same data in every process
    collectives(m)
    parity(m, p, rng)
    scan(m, p, rng)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
