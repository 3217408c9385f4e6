"""Streaming RX: continuous IQ (file or stdin, cf32/ci16/ci8) -> frames.

The port's twin of ``lora_phy_tpu/runners/rx_stream.py``, flag for flag
and mode for mode: native ingest (format conversion through
``runtime/lora_runtime.cpp``, :mod:`..runtime`), fixed-size block +
overlap carry buffering, and the device-side block receiver
(:func:`..models.sync.receive_block_planar`: scan, candidate selection,
window extraction and the preamble-anchored demod of up to
``--max-frames`` frames per block). One line per decoded frame:

    frame @SAMPLE sync=0xNN cfo_bins=N snr=S.SdB sro=+P.Pppm payload=HEX

Buffering contract: each processed buffer = ``carry ++ block`` where the
carry is one worst-case frame plus a symbol, so every frame fully inside
the stream is fully inside at least one buffer; duplicates from the
overlap are suppressed by absolute start index. The carry lives on the
device and is always exactly the real stream (a short tail chunk is
processed unpadded), so ``--checkpoint=PATH`` resumes without a gap; the
checkpoint file is the JAX twin's (``re``, ``im``, ``base``,
``reported``, ``n_frames``; adaptive mode: ``tail_re``, ``tail_im``,
``consumed``, ``n_frames``), and a file written by either package
resumes in the other.

Modes: ``--sf=auto`` (the block receiver at SF7-12 on the same buffer,
each line tagged ``sf=N``), ``--channels=K`` (the polyphase analysis bank
and the block receiver on every sub-channel, ``ch=N``), ``--sic`` (the
collision receiver, ``sic=PASS``; per sub-channel with ``--channels``),
``--robust`` (``pre_acc=3``), ``--cad`` (the activity gate before each
buffer), ``--frontend-correct`` (blind per-block DC/IQ-imbalance
correction), ``--invert-iq``, ``--soft`` (Hamming84 ML detection from the
receiver's spectra on the block paths), ``--adaptive [--soft] [--ldro]``
(gateway mode: self-describing coded frames, pairs with ``tx_stream
--coded``), ``--json`` (one JSON object per frame), ``--any-sync``.
``--mesh=T`` time-shards the plain block receiver over T devices (the
CUDA cards from ``--device`` on, or T shards sharing the CPU with
``--device=cpu``): every fed block runs ONE
:func:`..parallel.stream.receive_stream_block_planar` through
:class:`..parallel.stream.MeshStreamDemodulator`, and ``--checkpoint``
writes the mesh carry (the JAX twin's keys, plus ``reported``, which the
JAX twin's loader ignores). Unlike the JAX twin's mesh loop, the
near-start dedupe set is pruned behind the carry and seeded on resume,
as on the single-device path of both packages.

Host reads: per block one copy of the found frames' fields and decoded
bytes for each SF (and the CAD flags under ``--cad``); the adaptive and
SIC receivers read what their JAX twins read. The input planes go to the
device once per block.

Flags: ``--in=FILE|-`` ``--sf=N|auto`` ``--cr`` ``--bw`` ``--osr`` ``--sync``
``--format=cf32|ci16|ci8`` ``--scale`` ``--payload-len=BYTES``
``--block=SAMPLES`` ``--max-frames=K`` ``--thresh=DB`` ``--taps=N``
``--preamble=N`` ``--checkpoint=PATH`` ``--quiet`` and the mode flags
above, plus ``--device=`` (default the first CUDA card; ``--device=cpu``).
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import sys

import numpy as np
import torch

from ._cli import DEVICE_FLAG, bandwidth_flag, device_from, params_from, parse_flags

_FORMATS = {"cf32": (np.float32, 8), "ci16": (np.int16, 4), "ci8": (np.int8, 2)}
_ROW_FIELDS = ("found", "start", "cfo_bins", "sync", "snr_db", "sro_ppm")


def found_rows(blk, payload: torch.Tensor) -> list[tuple[int, dict]]:
    """The found frames of a ``BlockFrames`` with leading shape ``()`` or
    ``(C,)``, with their decoded bytes ``payload`` ``[..., K, B]``, read
    to the host in ONE copy: ``(channel, row)`` pairs, channel-major and
    in receiver order within a channel (the JAX twin's loop order). Each
    row holds ``k``, ``start``, ``cfo_bins``, ``sync``, ``snr_db``,
    ``sro_ppm`` (float32 values, exact in float64) and ``payload`` bytes."""
    k_max = blk.found.shape[-1]
    fields = torch.stack([getattr(blk, f).to(torch.float64) for f in _ROW_FIELDS])
    flat = torch.cat([fields.reshape(-1),
                      payload.to(torch.float64).reshape(-1)]).cpu().numpy()
    nf = fields.numel()
    f = flat[:nf].reshape(len(_ROW_FIELDS), -1, k_max)
    pay = flat[nf:].astype(np.uint8).reshape(f.shape[1], k_max, -1)
    rows = []
    for chan in range(f.shape[1]):
        for k in np.flatnonzero(f[0, chan]):
            rows.append((chan, {
                "k": int(k), "start": int(f[1, chan, k]),
                "cfo_bins": int(f[2, chan, k]), "sync": int(f[3, chan, k]),
                "snr_db": float(f[4, chan, k]), "sro_ppm": float(f[5, chan, k]),
                "payload": pay[chan, k].tobytes()}))
    return rows


def main(argv=None) -> int:
    flags = parse_flags(sys.argv[1:] if argv is None else argv, {
        "in": (str, ""),
        "sf": (lambda v: v if v == "auto" else int(v), 7),
        "cr": (int, 1),
        "bw": (bandwidth_flag, None),
        "osr": (int, 1),
        "sync": (lambda v: int(v, 0), 0x12),
        "format": (str, "cf32"),
        "scale": (float, 1.0),
        "payload-len": (int, 16),
        "block": (int, 1 << 16),
        "max-frames": (int, 8),
        "thresh": (float, -30.0),
        "checkpoint": (str, ""),
        "quiet": (None, False),
        "channels": (int, 0),
        "taps": (int, 7),             # polyphase taps/branch (wideband)
        "preamble": (int, 8),
        "any-sync": (None, False),
        "sic": (None, False),
        "invert-iq": (None, False),
        "cad": (None, False),
        "adaptive": (None, False),
        "soft": (None, False),
        "json": (None, False),
        "robust": (None, False),      # multipath-robust receive (pre_acc=3)
        "frontend-correct": (None, False),
        "ldro": (None, False),        # adaptive mode: low-data-rate payload
        "mesh": (int, 0),             # time-shard the receive over N devices
        "device": DEVICE_FLAG,
    })
    if flags["format"] not in _FORMATS:
        print(f"Unknown --format={flags['format']}", file=sys.stderr)
        return 1
    if flags["sic"] and flags["sf"] == "auto":
        print("--sic requires a fixed --sf", file=sys.stderr)
        return 1
    if flags["cad"] and flags["channels"]:
        print("--cad requires a single channel (the gate dechirps at the "
              "input rate)", file=sys.stderr)
        return 1
    if flags["adaptive"] and (flags["channels"] or flags["sf"] == "auto"
                              or flags["sic"]):
        print("--adaptive requires a fixed --sf, a single channel and no "
              "--sic", file=sys.stderr)
        return 1
    if flags["soft"] and not flags["adaptive"] and flags["sic"]:
        print("--soft applies to --adaptive (LLR/ML coded decode) or to "
              "the plain/wideband/blind/mesh block paths (Hamming84 ML "
              "detection) — not --sic (the peel needs its own decisions)",
              file=sys.stderr)
        return 1
    if flags["robust"] and flags["adaptive"]:
        print("--robust applies to the block receive paths, not "
              "--adaptive (serial header-driven sync)", file=sys.stderr)
        return 1
    if flags["mesh"] and (flags["sic"] or flags["adaptive"] or flags["cad"]
                          or flags["channels"] or flags["sf"] == "auto"):
        print("--mesh time-shards the plain block receiver: fixed --sf, "
              "single channel, no --sic/--adaptive/--cad", file=sys.stderr)
        return 1
    dev = device_from(flags)
    if dev is None:
        return 1

    blind = flags["sf"] == "auto"
    base_flags = dict(flags, sf=7) if blind else flags
    params = params_from({k: v for k, v in base_flags.items()
                          if v is not None})
    # --sf=auto: run the block receiver at every SF on the same buffer;
    # buffer geometry sizes to the WORST-CASE (largest-SF) frame so every
    # candidate fits
    sf_list = [7, 8, 9, 10, 11, 12] if blind else [params.sf]
    params_by_sf = [dataclasses.replace(params, sf=sf) for sf in sf_list]

    from .. import runtime
    from ..models import modem, stream, sync
    from ..models import sic as sic_model

    dtype, bytes_per_sample = _FORMATS[flags["format"]]
    n_payload_symbols = flags["payload-len"] * 2      # simple Hamming84 chain
    npre = flags["preamble"]
    frame_lens = {
        p.sf: (stream.frame_overhead_samples(p, npre)
               + n_payload_symbols * p.step) for p in params_by_sf
    }
    frame_len = max(frame_lens.values())
    kch = flags["channels"]                           # 0 = single channel
    rate = max(kch, 1)                                # wideband:channel ratio
    carry_len = rate * (frame_len + max(p.step for p in params_by_sf))
    block = max(flags["block"], rate * frame_len)     # a frame must fit
    block = -(-block // rate) * rate                  # multiple of K

    carry_re = torch.zeros(carry_len, device=dev)
    carry_im = torch.zeros(carry_len, device=dev)
    base = -carry_len                                  # abs index of carry[0]
    reported: set[tuple[int, int, int]] = set()        # (sf, chan, abs start)
    n_frames = 0
    n_skipped = 0                                      # CAD-gated buffers

    ckpt = pathlib.Path(flags["checkpoint"]) if flags["checkpoint"] else None
    if (ckpt and ckpt.exists() and not flags["adaptive"]
            and not flags["mesh"]):
        with np.load(ckpt) as z:
            carry_re = torch.from_numpy(np.asarray(z["re"], np.float32)).to(dev)
            carry_im = torch.from_numpy(np.asarray(z["im"], np.float32)).to(dev)
            base = int(z["base"])
            reported = set((int(f), int(c), int(s))
                           for f, c, s in z["reported"].reshape(-1, 3))
            n_frames = int(z["n_frames"])

    src = (sys.stdin.buffer if flags["in"] in ("", "-")
           else open(flags["in"], "rb"))

    def read_block(count):
        """The next ``count`` samples as (re, im) planes on the device,
        or None at the end of the input."""
        raw = src.read(count * bytes_per_sample)
        if not raw:
            return None
        n = len(raw) // bytes_per_sample
        arr = np.frombuffer(raw[: n * bytes_per_sample], dtype)
        re, im = runtime.to_planar(arr, flags["scale"])
        re, im = torch.from_numpy(re).to(dev), torch.from_numpy(im).to(dev)
        if flags["invert-iq"]:
            im = -im     # LoRaWAN-downlink convention (conjugate input)
        return re, im

    if flags["adaptive"]:
        # gateway mode: self-describing frames (explicit header carries
        # length/CR/CRC), arbitrary payload sizes in one stream, CRC
        # verification per frame; --soft decodes payloads from the
        # symbol spectra (ML codeword correlation)
        adapt = stream.AdaptiveStreamDemodulator(params, preamble_len=npre,
                                                 soft=flags["soft"],
                                                 ldro=flags["ldro"],
                                                 min_power_db=flags["thresh"],
                                                 device=dev)
        astate = adapt.init_state()
        if ckpt and ckpt.exists():
            # adaptive checkpoints carry the complex tail + frame count
            # (the JAX twin's format, distinct from the planar-carry one)
            with np.load(ckpt) as z:
                tail = (z["tail_re"] + 1j * z["tail_im"]).astype(np.complex64)
                astate = stream.StreamState(torch.from_numpy(tail).to(dev),
                                            int(z["consumed"]))
                n_frames = int(z["n_frames"])
        try:
            while True:
                planes = read_block(block)
                if planes is None:
                    break
                astate, got = adapt.process(astate, torch.complex(*planes))
                for pos, payload, info in got:
                    n_frames += 1
                    crc = (("ok" if info.get("crc_ok") else "bad")
                           if info["crc"] else "off")
                    if flags["json"]:
                        rec = {"start": pos, "len": info["length"],
                               "cr": f"4/{4 + info['cr']}", "crc": crc,
                               "cfo_bins": info["cfo_bins"],
                               "payload": payload.hex()}
                        if "soft_margin" in info:
                            rec["soft_margin"] = round(
                                info["soft_margin"], 2)
                        print(json.dumps(rec), flush=True)
                        continue
                    soft_tag = (f" margin={info['soft_margin']:.1f}"
                                if "soft_margin" in info else "")
                    print(f"frame @{pos} len={info['length']} "
                          f"cr=4/{4 + info['cr']} crc={crc} "
                          f"cfo_bins={info['cfo_bins']}{soft_tag} "
                          f"payload={payload.hex()}", flush=True)
        finally:
            if src is not sys.stdin.buffer:
                src.close()
        if ckpt:
            tail = astate.tail.cpu().numpy()
            with open(ckpt, "wb") as f:   # exact path (savez appends .npz)
                np.savez(f, tail_re=tail.real.astype(np.float32),
                         tail_im=tail.imag.astype(np.float32),
                         consumed=np.int64(astate.consumed),
                         n_frames=np.int64(n_frames))
        if not flags["quiet"]:
            print(f"{n_frames} frames", file=sys.stderr)
        return 0

    def aliased_sync(p):
        # at BW250/500 the demodulated bin is s*bw_scale mod N
        # (docs/SEMANTICS.md "BW250/500 bin aliasing"), so the recovered
        # sync word aliases the same way; compare against THAT
        shift = (p.sf - 4) if p.sf > 4 else 0
        scale = int(round(p.scale))

        def nib(v):
            return ((((v & 0xF) << shift) * scale % p.n) >> shift) & 0xF

        return (nib(p.sync_word >> 4) << 4) | nib(p.sync_word)

    expected_sync = {p.sf: aliased_sync(p) for p in params_by_sf}

    def report(row, p, chan, buf_base):
        """Print one frame unless it fails the sync filter or was already
        reported; ``row["payload"]`` holds its decoded bytes (from the ML
        detector under ``--soft``)."""
        nonlocal n_frames
        if not flags["any-sync"] and row["sync"] != expected_sync[p.sf]:
            # the sync word is the network filter: rejects transition-band
            # chirp leakage that picks up a bogus sync on quiet channels
            return
        # abs position in WIDEBAND samples (channel streams run at 1/K
        # rate; the analysis bank aligns channel frame m to input m*K)
        abs_start = buf_base + row["start"] * rate
        # overlap re-detections and bin-jitter run splits can move the
        # candidate a few samples: same-channel starts within half a
        # frame are the same frame. Under --sic overlapping frames are
        # the point — only a symbol of jitter is the same frame there.
        near = (p.step if flags["sic"] else frame_lens[p.sf] // 2) * rate
        if any(f == p.sf and c == chan and abs(s - abs_start) < near
               for f, c, s in reported):
            return
        reported.add((p.sf, chan, abs_start))
        n_frames += 1
        payload = row["payload"]
        if flags["json"]:
            rec = {"start": abs_start, "sync": row["sync"],
                   "cfo_bins": row["cfo_bins"],
                   "snr_db": round(row["snr_db"], 2),
                   "sro_ppm": round(row["sro_ppm"], 2),
                   "payload": payload.hex()}
            if kch:
                rec["channel"] = chan
            if blind:
                rec["sf"] = p.sf
            if "sic_pass" in row:
                rec["sic_pass"] = row["sic_pass"]
            print(json.dumps(rec), flush=True)
            return
        ch = f"ch={chan} " if kch else ""
        sf_tag = f"sf={p.sf} " if blind else ""
        sic_tag = (f"sic={row['sic_pass']} " if "sic_pass" in row else "")
        print(f"frame {ch}{sf_tag}@{abs_start} "
              f"sync=0x{row['sync']:02x} "
              f"cfo_bins={row['cfo_bins']} "
              f"snr={row['snr_db']:.1f}dB "
              f"sro={row['sro_ppm']:+.1f}ppm "
              f"{sic_tag}payload={payload.hex()}", flush=True)

    if flags["mesh"]:
        # time-sharded streaming: every fed block rides ONE sharded
        # receive over a (1 x T) mesh (seam halos, global starts), with the
        # fixed-length tail carry + exact-start dedupe of
        # MeshStreamDemodulator; the near-start dedupe above still guards
        # bin-jitter re-finds
        from ..parallel import mesh as meshlib
        from ..parallel.stream import (MeshStreamDemodulator,
                                       load_mesh_state, save_mesh_state)

        t_shards = flags["mesh"]
        if dev.type == "cuda":
            count = torch.cuda.device_count()
            devs = [torch.device("cuda", ((dev.index or 0) + i) % count)
                    for i in range(count)]
        else:
            devs = [dev] * t_shards                # shards share the CPU
        if t_shards > len(devs):
            print(f"--mesh={t_shards} exceeds {len(devs)} devices",
                  file=sys.stderr)
            return 1
        m = meshlib.make_mesh(n_channel=1, n_time=t_shards,
                              devices=devs[:t_shards])
        rx = MeshStreamDemodulator(
            params, n_payload_symbols, m, max_frames=flags["max-frames"],
            preamble_len=npre, min_power_db=flags["thresh"],
            pre_acc=3 if flags["robust"] else 1,
            with_spectra=flags["soft"])
        # minimum fed block: per-shard (keep+B)/T must hold frame+margin
        min_b = max(rx.unit, rx.halo * t_shards - rx.keep)
        min_b = -(-min_b // rx.unit) * rx.unit
        mb = -(-max(block, min_b) // rx.unit) * rx.unit
        state = rx.init_state(1)
        if ckpt and ckpt.exists():
            state = load_mesh_state(ckpt, device=m.home)
            n_frames = int(state.n_frames)
            with np.load(ckpt) as z:
                if "reported" in z:
                    reported = set((int(f), int(c), int(s))
                                   for f, c, s in z["reported"].reshape(-1, 3))

        def mesh_rows(frames):
            """The block's frames with their bytes, decoded in one batch."""
            if not frames:
                return frames
            if flags["soft"]:
                from ..models import soft as softmod

                pay = softmod.hamming84_ml_decode(
                    torch.stack([r["spectra"] for r in frames]),
                    scale=int(round(params.scale)))
            else:
                pay = modem.decode(torch.stack([r["symbols"] for r in frames]))
            for row, b in zip(frames, pay.cpu().numpy()):
                row["payload"] = b.tobytes()
            return frames

        pend_re = pend_im = torch.zeros(0, device=m.home)
        try:
            eof = False
            while not eof:
                planes = read_block(mb)
                if planes is not None:
                    pend_re = torch.cat([pend_re, planes[0].to(m.home)])
                    pend_im = torch.cat([pend_im, planes[1].to(m.home)])
                else:
                    eof = True
                    if pend_re.numel() == 0:
                        break
                    # zero-pad the final chunk up to a VALID fed block
                    # (>= min_b so the per-shard halo check holds; the pad
                    # region is silence and yields no frames)
                    tgt = max(min_b, -(-pend_re.numel() // rx.unit) * rx.unit)
                    z = torch.zeros(tgt - pend_re.numel(), device=m.home)
                    pend_re = torch.cat([pend_re, z])
                    pend_im = torch.cat([pend_im, z])
                while pend_re.numel() >= mb or (eof and pend_re.numel()):
                    cut = min(mb, pend_re.numel())
                    state, frames = rx.process(
                        state, pend_re[None, :cut], pend_im[None, :cut])
                    pend_re, pend_im = pend_re[cut:], pend_im[cut:]
                    for row in mesh_rows(frames):
                        report(row, params, 0, 0)
                    # starts behind the carry can never be reported again
                    reported = {t for t in reported
                                if t[2] >= state.consumed - frame_len}
        finally:
            if src is not sys.stdin.buffer:
                src.close()
        if ckpt:
            save_mesh_state(state._replace(n_frames=n_frames), ckpt,
                            reported=np.asarray(sorted(reported),
                                                np.int64).reshape(-1, 3))
        if not flags["quiet"]:
            print(f"{n_frames} frames ({t_shards} time shards)",
                  file=sys.stderr)
        return 0

    def sic_rows(xr, xi, p):
        """The collision receiver's frames with their bytes (one copy)."""
        rows, _ = sic_model.receive_sic_planar(
            xr, xi, p, n_payload_symbols,
            max_frames=flags["max-frames"], preamble_len=npre,
            min_power_db=flags["thresh"],
            max_iters=flags["max-frames"],
            pre_acc=3 if flags["robust"] else 1,
        )
        if rows:
            payload = modem.decode(torch.stack([r["symbols"] for r in rows])).cpu().numpy()
            for row, pay in zip(rows, payload):
                row["payload"] = pay.tobytes()
        return rows

    def block_payload(res, p):
        """(BlockFrames, decoded bytes [..., K, B]) of a receiver result:
        argmax + syndrome, or the ML detector on the spectra (--soft)."""
        if not flags["soft"]:
            return res, modem.decode(res.symbols)
        blk, spec = res
        from ..models import soft as softmod

        return blk, softmod.hamming84_ml_decode(spec, scale=int(round(p.scale)))

    def process(buf_re, buf_im, buf_base):
        for p in params_by_sf:
            if kch:
                pad = (-buf_re.shape[-1]) % rate
                if pad:
                    z = torch.zeros(pad, device=dev)
                    br, bi = torch.cat([buf_re, z]), torch.cat([buf_im, z])
                else:
                    br, bi = buf_re, buf_im
                if flags["sic"]:
                    # collision receive per sub-channel: channelize once,
                    # then peel each channel's overlapping frames
                    from ..ops.channelizer import channelize_planar

                    cr, ci = channelize_planar(br, bi, kch, flags["taps"])
                    for chan in range(kch):
                        for row in sic_rows(cr[chan], ci[chan], p):
                            report(row, p, chan, buf_base)
                    continue
                res = sync.receive_wideband_planar(
                    br, bi, kch, p, n_payload_symbols,
                    max_frames=flags["max-frames"], preamble_len=npre,
                    taps_per_branch=flags["taps"],
                    min_power_db=flags["thresh"],
                    pre_acc=3 if flags["robust"] else 1,
                    with_spectra=flags["soft"],
                )
                for chan, row in found_rows(*block_payload(res, p)):
                    report(row, p, chan, buf_base)
            elif flags["sic"]:
                # collision receive: peel frames in power order (exact-TX
                # resynthesis + LS gain fit + subtract, models/sic.py) so
                # overlapping same-SF frames all decode
                for row in sic_rows(buf_re, buf_im, p):
                    report(row, p, 0, buf_base)
            else:
                res = sync.receive_block_planar(
                    buf_re, buf_im, p, n_payload_symbols,
                    max_frames=flags["max-frames"], preamble_len=npre,
                    min_power_db=flags["thresh"],
                    pre_acc=3 if flags["robust"] else 1,
                    with_spectra=flags["soft"],
                )
                for _, row in found_rows(*block_payload(res, p)):
                    report(row, p, 0, buf_base)

    try:
        while True:
            planes = read_block(block)
            if planes is None:
                break
            re, im = planes
            if flags["frontend-correct"]:
                # blind per-block DC/IQ-imbalance correction (identity on
                # silent blocks — the estimator guards its statistics)
                from ..ops.impair import (compensate_frontend_planar,
                                          estimate_frontend_planar)

                re, im = compensate_frontend_planar(
                    re, im, *estimate_frontend_planar(re, im))
            # a short tail chunk is processed unpadded, so the carry stays
            # exactly the real stream and --checkpoint resume is gap-free
            buf_re = torch.cat([carry_re, re])
            buf_im = torch.cat([carry_im, im])
            if flags["cad"]:
                # listen-before-process: the SX126x-style activity gate
                # probes every 4th window at each candidate SF and skips
                # the full receive on silent buffers (one host read)
                active = bool(torch.stack([
                    sync.cad_planar(buf_re, buf_im, p, threshold_db=flags["thresh"])[0]
                    for p in params_by_sf]).any())
                if not active:
                    n_skipped += 1
                else:
                    process(buf_re, buf_im, base)
            else:
                process(buf_re, buf_im, base)
            keep = min(carry_len, buf_re.shape[-1])
            base += buf_re.shape[-1] - keep             # abs index of carry[0]
            carry_re = buf_re[buf_re.shape[-1] - keep:]
            carry_im = buf_im[buf_im.shape[-1] - keep:]
            # keep the dedupe set bounded: starts behind the carry can
            # never be reported again
            reported = {t for t in reported
                        if t[2] >= base - frame_len * rate}
    finally:
        if src is not sys.stdin.buffer:
            src.close()

    if ckpt:
        with open(ckpt, "wb") as f:       # exact path (savez appends .npz)
            np.savez(f, re=carry_re.cpu().numpy(), im=carry_im.cpu().numpy(),
                     base=np.int64(base),
                     reported=np.asarray(sorted(reported),
                                         np.int64).reshape(-1, 3),
                     n_frames=np.int64(n_frames))
    if not flags["quiet"]:
        cad_note = (f" ({n_skipped} buffers CAD-skipped)"
                    if flags["cad"] else "")
        print(f"{n_frames} frames{cad_note}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
