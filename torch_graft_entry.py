"""Entry points of the PyTorch/CUDA port, the twins of those of
``__graft_entry__.py``.

``entry(device=None)``             — the single-card forward step on the
                                     flagship model (batched multi-channel
                                     dechirped demodulation, tiny sizes).
``dryrun_multichip(n, device=None)`` — builds an n-shard (channel x time)
                                     mesh and runs one full sharded step of
                                     each receive path on tiny shapes,
                                     printing the JAX twin's lines.

Both run the planar (split re/im float32) pipeline end to end, TX
included, on ``device`` (default the first CUDA card; without one they
raise unless given ``device="cpu"``). The mesh's shards share that
device, as ``chip_smoke.py``'s mesh phase runs them: a mesh here is the
port's grid of ``torch.device``s (``lora_phy_tpu_torch.parallel.mesh``).

    python -c "import torch_graft_entry as g; g.dryrun_multichip(8, device='cpu')"
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lora_phy_tpu_torch import LoraParams, device_of
from lora_phy_tpu_torch.models import modem
from lora_phy_tpu_torch.models import sic as sicmod
from lora_phy_tpu_torch.models import soft as softmod
from lora_phy_tpu_torch.models import stream as streammod
from lora_phy_tpu_torch.models import sync as syncmod
from lora_phy_tpu_torch.models.coded import CodedConfig, payload_symbol_count
from lora_phy_tpu_torch.ops import impair as impairmod
from lora_phy_tpu_torch.ops import planar
from lora_phy_tpu_torch.ops.channelizer import synthesize_channels_planar
from lora_phy_tpu_torch.parallel import mesh as meshlib
from lora_phy_tpu_torch.parallel.stream import (
    demodulate_stream,
    demodulate_stream_planar,
    receive_adaptive_stream_planar,
    receive_blind_stream_planar,
    receive_stream_block_planar,
)


def entry(device=None):
    """``(forward, (xr, xi))``: SF7, 2 channels x 8 random bytes
    (``RandomState(0)``) encoded, modulated and dechirped as planes on
    ``device``; ``forward(re, im)`` is ``demodulate_planar``'s
    ``(symbols, sync_word)`` at its defaults (float32, the plain path)."""
    dev = device_of(None, device)
    params = LoraParams(sf=7)
    n_channels, payload_len = 2, 8
    rng = np.random.RandomState(0)
    payloads = rng.randint(0, 256, (n_channels, payload_len)).astype(np.uint8)
    syms = modem.encode(payloads, device=dev)
    xr, xi = planar.modulate_planar(syms, params)
    xr, xi = planar.dechirp_planar(xr, xi, params)

    def forward(re, im):
        res = planar.demodulate_planar(re, im, params)
        return res.symbols, res.sync_word

    return forward, (xr, xi)


def _per_channel(m: meshlib.Mesh, fn, *xs):
    """``fn`` on each channel block of ``xs`` (``[channels, ...]``, laid
    out by :func:`~lora_phy_tpu_torch.parallel.mesh.channel_sharding`),
    run once per channel block on the first time shard's device: the
    single-device program that JAX's jit runs on every block of a
    channel-sharded batch. A tuple result (``BlockFrames``, planes) comes
    back field by field, the blocks concatenated along channels on the
    mesh's home device."""
    sh = meshlib.channel_sharding(m)
    grid = meshlib.run_shards(
        m, lambda shard, *blocks: fn(*blocks) if shard.t_idx == m.time_base else None,
        *(meshlib.blocks_of(x, sh) for x in xs))
    outs = [row[0] for row in grid]
    fields = [meshlib.join([[o[i]] for o in outs], None, m.home)
              for i in range(len(outs[0]))]
    return type(outs[0])(*fields) if hasattr(outs[0], "_fields") else tuple(fields)


def _host(x) -> np.ndarray:
    return x.cpu().numpy()


def dryrun_multichip(n_devices: int, device=None) -> None:
    """One sharded step of each receive path on an ``n_devices``-shard
    mesh (``n_time`` 2 where ``n_devices`` is even), every shard on
    ``device``: the streaming demod (planar and complex), the
    seam-straddling frame scan, the wideband channelizer receiver, SIC,
    blind SF, the adaptive (explicit-header) receiver, soft decoding and
    the multipath-robust receiver. Asserts each path's frames and bytes
    and prints ``__graft_entry__.dryrun_multichip``'s lines."""
    dev = device_of(None, device)
    n_time = 2 if n_devices % 2 == 0 else 1
    n_channel = n_devices // n_time
    m = meshlib.make_mesh(n_channel=n_channel, n_time=n_time, devices=[dev] * n_devices)

    params = LoraParams(sf=7)
    payload_len = 7  # -> 14 symbols + 2 sync = 16 symbols, divisible by n_time
    rng = np.random.RandomState(1)
    payloads = rng.randint(0, 256, (n_channel, payload_len)).astype(np.uint8)

    # --- planar (deployment) path: TX + dechirp + time-sharded streaming
    # demod ---------------------------------------------------------------
    syms_tx = modem.encode(payloads, device=dev)
    re, im = planar.modulate_planar(syms_tx, params)
    dr, di = planar.dechirp_planar(re, im, params)
    sh = meshlib.stream_sharding(m)
    out_syms, sync, _, _ = demodulate_stream_planar(
        meshlib.device_put(dr, sh), meshlib.device_put(di, sh), params, m)
    decoded = _host(modem.decode(out_syms[..., 2:]))
    assert np.array_equal(decoded, payloads), "planar multichip demod mismatch"
    assert bool((sync == params.sync_word).all())

    # --- complex path: complex64 is native on every torch device, so it
    # runs wherever the planar one does (JAX runs it on the CPU only) ------
    dech = modem.dechirp(modem.modulate(syms_tx, params), params)
    c_syms = demodulate_stream(meshlib.device_put(dech, sh), params, m)[0]
    assert torch.equal(c_syms, out_syms), "complex/planar multichip divergence"

    # --- raw-stream frame-SYNC scan on the mesh: frames at arbitrary
    # positions, STRADDLING the time-shard seam where one exists ----------
    n_pay = payload_len * 2
    frame_len = streammod.frame_overhead_samples(params) + n_pay * params.step
    block = 4096
    total = n_time * block
    scan_r = torch.zeros((n_channel, total), dtype=torch.float32, device=dev)
    scan_i = torch.zeros_like(scan_r)
    starts = []
    for c in range(n_channel):
        off = (block - frame_len // 2 + 13 * c) if n_time > 1 else (500 + 13 * c)
        fr, fi = streammod.frame_modulate_planar(syms_tx[c], params)
        scan_r[c, off: off + frame_len] = fr
        scan_i[c, off: off + frame_len] = fi
        starts.append(off)
    blk = receive_stream_block_planar(
        meshlib.device_put(scan_r, sh), meshlib.device_put(scan_i, sh),
        params, n_pay, m, max_frames=2)
    found, bstart = _host(blk.found), _host(blk.start)
    for c in range(n_channel):
        hit = np.flatnonzero(found[c])
        assert hit.size == 1, "scan-path frame count"
        k = int(hit[0])
        assert int(bstart[c, k]) == starts[c]
        dec = _host(modem.decode(blk.symbols[c, k]))
        assert np.array_equal(dec, payloads[c]), "scan-path decode mismatch"
    print("dryrun scan-path OK: seam-straddling frames found + decoded "
          f"(starts {starts})")

    # --- wideband channelize + scan, channel-sharded batch ---------------
    kch = 4
    gap = torch.zeros((n_channel, 600), dtype=torch.float32, device=dev)
    fr_all, fi_all = streammod.frame_modulate_planar(syms_tx, params)
    sr_ = torch.cat([gap, fr_all, gap], dim=-1)
    si_ = torch.cat([gap, fi_all, gap], dim=-1)
    F = sr_.shape[-1]
    wb_r = torch.zeros((n_channel, kch, F), dtype=torch.float32, device=dev)
    wb_i = torch.zeros_like(wb_r)
    wb_r[:, 1], wb_i[:, 1] = sr_, si_                  # sub-channel 1
    wr, wi = synthesize_channels_planar(wb_r, wb_i, kch, taps_per_branch=15)
    wblk = _per_channel(m, lambda r, i: syncmod.receive_wideband_planar(
        r, i, kch, params, n_pay, max_frames=1, taps_per_branch=15), wr, wi)
    wfound = _host(wblk.found)                          # [C, kch, 1]
    assert wfound[:, 1].all() and wfound[:, [0, 2, 3]].sum() == 0
    for c in range(n_channel):
        dec = _host(modem.decode(wblk.symbols[c, 1, 0]))
        assert np.array_equal(dec, payloads[c]), "wideband decode mismatch"
    print(f"dryrun wideband OK: K={kch} channelize+scan sharded over "
          f"{n_channel} mesh channels")

    # --- SIC peel, channel-sharded batch: strong+weak collision per
    # channel; peel the strong frame on the mesh, weak frame decodes ------
    weak_pl = (payloads + 13).astype(np.uint8)
    weak_syms = modem.encode(weak_pl, device=dev)
    sfr, sfi = streammod.frame_modulate_planar(syms_tx, params, amplitude=1.0)
    wfr, wfi = streammod.frame_modulate_planar(weak_syms, params, amplitude=0.25)
    off_s, off_w = 2 * params.step, 7 * params.step
    t_sic = off_w + frame_len + 4 * params.step
    xr = torch.zeros((n_channel, t_sic), dtype=torch.float32, device=dev)
    xi = torch.zeros_like(xr)
    xr[:, off_s: off_s + frame_len] += sfr
    xi[:, off_s: off_s + frame_len] += sfi
    xr[:, off_w: off_w + frame_len] += wfr
    xi[:, off_w: off_w + frame_len] += wfi

    def receive(r, i):
        return syncmod.receive_block_planar(r, i, params, n_pay, max_frames=2,
                                            min_power_db=-30.0)

    blk1 = _per_channel(m, receive, xr, xi)
    f1, st1 = _host(blk1.found), _host(blk1.start)
    assert all((f1[c] & (st1[c] == off_s)).any() for c in range(n_channel))
    ks = torch.as_tensor([int(np.flatnonzero(f1[c] & (st1[c] == off_s))[0])
                          for c in range(n_channel)], device=blk1.symbols.device)
    rows = torch.arange(n_channel, device=ks.device)

    def peel(r, i, sym, st, cf, sw):
        # the per-channel cancellation (JAX vmaps it over the batch)
        out = [sicmod.cancel_frame_planar(r[j], i[j], sym[j], st[j], cf[j], params,
                                          sync_word=sw[j])[:2]
               for j in range(r.shape[0])]
        return torch.stack([o[0] for o in out]), torch.stack([o[1] for o in out])

    rr, ri = _per_channel(
        m, peel, xr, xi, blk1.symbols[rows, ks], blk1.start[rows, ks].to(torch.int32),
        (blk1.cfo_bins[rows, ks] + blk1.cfo[rows, ks]).to(torch.float32),
        blk1.sync[rows, ks].to(torch.uint8))
    blk2 = _per_channel(m, receive, rr, ri)
    f2, st2 = _host(blk2.found), _host(blk2.start)
    for c in range(n_channel):
        kw = np.flatnonzero(f2[c] & (st2[c] == off_w))
        assert kw.size == 1, "SIC peel did not free the weak frame"
        dec = _host(modem.decode(blk2.symbols[c, int(kw[0])]))
        assert np.array_equal(dec, weak_pl[c]), "weak-frame decode mismatch"
    print(f"dryrun SIC OK: strong frame peeled on {n_channel} mesh "
          "channels, weak collision partner decoded")

    # --- blind-SF receive on the mesh: per-SF sharded scan fan-out; each
    # channel carries a frame at a DIFFERENT spreading factor -------------
    blk_b = 8192                        # >= SF8 frame+margin halo, step-aligned
    tot_b = n_time * blk_b
    b_r = torch.zeros((n_channel, tot_b), dtype=torch.float32, device=dev)
    b_i = torch.zeros_like(b_r)
    blind_sfs = [7 + (c % 2) for c in range(n_channel)]
    blind_pl = []
    for c, sf in enumerate(blind_sfs):
        pc = dataclasses.replace(params, sf=sf)
        pl = (payloads[c][: 4] + c).astype(np.uint8)
        fr, fi = streammod.frame_modulate_planar(modem.encode(pl, device=dev), pc)
        off = 3 * pc.step + 11 * c
        b_r[c, off: off + fr.shape[-1]] = fr
        b_i[c, off: off + fi.shape[-1]] = fi
        blind_pl.append((sf, off, pl))
    bres = receive_blind_stream_planar(
        meshlib.device_put(b_r, sh), meshlib.device_put(b_i, sh), params, 8, m,
        sfs=(7, 8), max_frames=2)
    brows = syncmod.blind_frames(bres)
    assert [(r["index"][0], r["sf"], r["start"]) for r in brows] == [
        (c, sf, off) for c, (sf, off, _) in enumerate(blind_pl)], brows
    for r in brows:
        dec = _host(modem.decode(r["symbols"]))
        assert np.array_equal(dec, blind_pl[r["index"][0]][2]), "blind decode"
    print(f"dryrun blind-SF OK: per-channel SFs {blind_sfs} discriminated "
          "and decoded on the mesh")

    # --- adaptive (explicit-header) receive on the mesh: sharded scan +
    # host header loop + one second sharded pass at the longest length ----
    a_pl = [b"mesh hdr %d!" % c + b"x" * (3 * (c % 3)) for c in range(n_channel)]
    a_off = [(blk_b - 500 + 7 * c) if n_time > 1 else (400 + 300 * c)
             for c in range(n_channel)]                # straddle the seam
    a_s = torch.zeros((n_channel, tot_b), dtype=torch.complex64, device=dev)
    for c in range(n_channel):
        iq = streammod.frame_encode(np.frombuffer(bytearray(a_pl[c]), np.uint8),
                                    CodedConfig(sf=7, cr=2), params, device=dev)
        a_s[c, a_off[c]: a_off[c] + iq.numel()] = iq
    ares = receive_adaptive_stream_planar(
        meshlib.device_put(a_s.real.contiguous(), sh),
        meshlib.device_put(a_s.imag.contiguous(), sh), params, m, max_frames=2)
    assert [(r["channel"], r["start"], r["payload"]) for r in ares] == [
        (c, a_off[c], a_pl[c]) for c in range(n_channel)], ares
    assert all(r["info"]["crc_ok"] for r in ares)
    print("dryrun adaptive OK: header-driven variable-length frames "
          f"decoded on the mesh (lengths {[len(x) for x in a_pl]})")

    # --- soft-decision decode on the mesh: sharded receiver returns
    # true-bin-order payload spectra; ML codeword correlation decodes the
    # coded payload from them ---------------------------------------------
    s_pl = [b"soft %d" % c for c in range(n_channel)]
    s_cfg = CodedConfig(sf=7, cr=4, crc=True)
    s_nsym = payload_symbol_count(len(s_pl[0]), s_cfg)
    s_npay = 8 + s_nsym
    s_flen = streammod.frame_overhead_samples(params) + s_npay * params.step
    s_r = torch.zeros((n_channel, tot_b), dtype=torch.float32, device=dev)
    s_i = torch.zeros_like(s_r)
    s_off = [(blk_b - s_flen // 2 + 31 * c) if n_time > 1 else (300 + 40 * c)
             for c in range(n_channel)]                # straddle the seam
    for c in range(n_channel):
        iq = streammod.frame_encode(np.frombuffer(bytearray(s_pl[c]), np.uint8), s_cfg, params,
                                    device=dev)
        s_r[c, s_off[c]: s_off[c] + iq.numel()] = iq.real
        s_i[c, s_off[c]: s_off[c] + iq.numel()] = iq.imag
    # the JAX twin's noise: numpy draws, float32, added on the device
    nz = np.random.RandomState(23)
    s_r += torch.from_numpy(nz.randn(n_channel, tot_b).astype(np.float32) * 0.15).to(dev)
    s_i += torch.from_numpy(nz.randn(n_channel, tot_b).astype(np.float32) * 0.15).to(dev)
    sblk, sspec = receive_stream_block_planar(
        meshlib.device_put(s_r, sh), meshlib.device_put(s_i, sh), params, s_npay, m,
        max_frames=2, min_power_db=-30.0, with_spectra=True)
    sfound, sstart = _host(sblk.found), _host(sblk.start)
    for c in range(n_channel):
        hit = np.flatnonzero(sfound[c])
        assert hit.size == 1 and sstart[c, hit[0]] == s_off[c], "soft mesh sync"
        pay, crc_ok, _ = softmod.decode_payload_soft(
            sspec[c, int(hit[0]), 8: 8 + s_nsym], len(s_pl[c]), s_cfg)
        assert bool(crc_ok), "soft mesh CRC"
        assert _host(pay).tobytes() == s_pl[c], "soft mesh payload"
    print(f"dryrun soft OK: {n_channel} seam-straddling coded frames "
          "soft-decoded (ML correlation) from mesh-sharded spectra")

    # --- multipath-robust receive (pre_acc=3) on the mesh: two-ray
    # channel, accumulated-spectrum sync + noncoherent combining ---------
    r_r = torch.zeros((n_channel, tot_b), dtype=torch.float32, device=dev)
    r_i = torch.zeros_like(r_r)
    r_off = [(blk_b - frame_len // 2 + 17 * c) if n_time > 1
             else (450 + 30 * c) for c in range(n_channel)]
    rfr, rfi = streammod.frame_modulate_planar(syms_tx, params)
    for c in range(n_channel):
        r_r[c, r_off[c]: r_off[c] + frame_len] = rfr[c]
        r_i[c, r_off[c]: r_off[c] + frame_len] = rfi[c]
    taps_re = np.zeros(4, np.float32)
    taps_re[0], taps_re[3] = 1.0, 0.95                 # two-ray 0.95@3
    r_r, r_i = impairmod.apply_multipath_planar(r_r, r_i, taps_re, np.zeros(4, np.float32))
    r_r = r_r + torch.from_numpy(nz.randn(n_channel, tot_b).astype(np.float32) * 0.05).to(dev)
    r_i = r_i + torch.from_numpy(nz.randn(n_channel, tot_b).astype(np.float32) * 0.05).to(dev)
    rblk = receive_stream_block_planar(
        meshlib.device_put(r_r, sh), meshlib.device_put(r_i, sh), params, n_pay, m,
        max_frames=2, min_power_db=-30.0, pre_acc=3)
    rfound, rstart = _host(rblk.found), _host(rblk.start)
    for c in range(n_channel):
        hit = [int(k) for k in np.flatnonzero(rfound[c])
               if abs(int(rstart[c, k]) - r_off[c]) <= params.step]
        assert hit, "robust mesh sync"
        dec = _host(modem.decode(rblk.symbols[c, hit[0]]))
        assert np.array_equal(dec, payloads[c]), "robust mesh decode"
    print(f"dryrun robust OK: {n_channel} two-ray seam-straddling frames "
          "decoded with pre_acc=3 on the mesh")

    print(
        f"dryrun_multichip OK: mesh={n_channel}x{n_time} "
        f"({n_devices} devices), {tuple(out_syms.shape)} symbols, planar TX+RX, "
        "sync verified; scan-path + wideband + SIC + blind-SF + adaptive "
        "+ soft + robust mesh paths OK"
    )
