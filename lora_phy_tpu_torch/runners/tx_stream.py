"""Streaming TX: payload list -> one continuous framed IQ stream.

The port's twin of ``lora_phy_tpu/runners/tx_stream.py``, flag for flag.
Each input line is a hex payload; every payload becomes a full LoRa frame
(preamble + sync + 2.25 downchirps + data, models/stream.frame_modulate)
after ``--gap`` samples of silence, written as cf32/ci16/ci8 interleaved
IQ through the native conversion runtime (:mod:`..runtime`). The output
of

    python -m lora_phy_tpu_torch.runners.tx_stream --payloads=list.txt --out=s.iq
    python -m lora_phy_tpu_torch.runners.rx_stream --in=s.iq --payload-len=N

round-trips frame for frame, and its bytes equal the JAX twin's for the
same flags.

``--invert-iq`` conjugates the output (the LoRaWAN downlink convention).
``--coded`` emits self-describing frames (explicit header carrying
length/CR/CRC + the full coded chain, models/stream.frame_encode) that
``rx_stream --adaptive`` decodes with no prior payload-size knowledge;
``--cr`` selects 4/5..4/8, ``--crc`` appends the CRC16 trailer.

Flags: ``--payloads=FILE|-`` (hex lines; or ``--payload=HEX`` repeated
count times via ``--count``) ``--out=FILE|-`` ``--sf`` ``--cr`` ``--bw``
``--osr`` ``--sync`` ``--gap=SAMPLES`` ``--format=cf32|ci16|ci8``
``--ampl`` ``--invert-iq`` ``--coded`` ``--crc`` ``--ldro`` ``--preamble=N``
``--device=`` (default the first CUDA card; ``--device=cpu``).

Frames are synthesised on the device: plain frames in batches of up to
:data:`BATCH` consecutive payloads of one length (one call and one host
copy per batch), coded frames one at a time, as their lengths differ.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ._cli import DEVICE_FLAG, bandwidth_flag, device_from, params_from, parse_flags

_FORMATS = {"cf32", "ci16", "ci8"}
BATCH = 256


def _write(out, fmt: str, re: np.ndarray, im: np.ndarray) -> None:
    from .. import runtime

    cf32 = runtime.from_planar(re, im)
    if fmt == "cf32":
        out.write(cf32.tobytes())
    elif fmt == "ci16":
        out.write(np.clip(np.round(cf32 * 32767), -32768, 32767)
                  .astype(np.int16).tobytes())
    else:
        out.write(np.clip(np.round(cf32 * 127), -128, 127)
                  .astype(np.int8).tobytes())


def main(argv=None) -> int:
    flags = parse_flags(sys.argv[1:] if argv is None else argv, {
        "payloads": (str, ""),
        "payload": (str, ""),
        "count": (int, 1),
        "out": (str, "-"),
        "sf": (int, 7),
        "cr": (int, 1),
        "bw": (bandwidth_flag, None),
        "osr": (int, 1),
        "sync": (lambda v: int(v, 0), 0x12),
        "gap": (int, 1024),
        "format": (str, "cf32"),
        "ampl": (float, 1.0),
        "continuous-chirp": (None, False),
        "invert-iq": (None, False),
        "coded": (None, False),
        "crc": (None, False),
        "ldro": (None, False),
        "preamble": (int, 8),
        "device": DEVICE_FLAG,
    })
    if flags["format"] not in _FORMATS:
        print(f"Unknown --format={flags['format']}", file=sys.stderr)
        return 1
    if flags["payload"]:
        payload_hex = [flags["payload"]] * flags["count"]
    elif flags["payloads"]:
        src = (sys.stdin if flags["payloads"] == "-"
               else open(flags["payloads"]))
        payload_hex = [l.strip() for l in src if l.strip()]
        if src is not sys.stdin:
            src.close()
    else:
        print("Need --payload=HEX or --payloads=FILE", file=sys.stderr)
        return 1
    dev = device_from(flags)
    if dev is None:
        return 1
    params = params_from({k: v for k, v in flags.items() if v is not None})
    payloads = []
    for hx in payload_hex:
        try:
            payloads.append(np.frombuffer(bytes.fromhex(hx), np.uint8))
        except ValueError:
            print(f"Bad hex payload: {hx!r}", file=sys.stderr)
            return 1
    if flags["coded"]:
        too_long = [len(p) for p in payloads if len(p) > 255]
        if too_long:                                 # 8-bit header length field
            print(f"--coded payload too long ({too_long[0]} > 255 bytes)",
                  file=sys.stderr)
            return 1
        if not 1 <= flags["cr"] <= 4:                # 3-bit header CR field
            print(f"--coded needs --cr in 1..4, got {flags['cr']}",
                  file=sys.stderr)
            return 1

    from ..models import modem, stream

    out = (sys.stdout.buffer if flags["out"] in ("", "-")
           else open(flags["out"], "wb"))
    gap = flags["gap"]
    sign = np.float32(-1.0 if flags["invert-iq"] else 1.0)
    n = 0
    try:
        if flags["coded"]:
            # self-describing frames: explicit header (length/CR/CRC) + the
            # full coded chain, decodable by `rx_stream --adaptive`
            from ..models.coded import CodedConfig

            cfg = CodedConfig(sf=params.sf, cr=flags["cr"], crc=flags["crc"],
                              ldro=flags["ldro"])
            for payload in payloads:
                iq = stream.frame_encode(torch.from_numpy(payload.copy()).to(dev), cfg,
                                         params, preamble_len=flags["preamble"])
                iq = iq.cpu().numpy()
                if flags["ampl"] != 1.0:
                    iq = (iq * np.float32(flags["ampl"])).astype(np.complex64)
                burst = np.concatenate([np.zeros(gap, np.complex64), iq])
                _write(out, flags["format"], burst.real.astype(np.float32),
                       sign * burst.imag.astype(np.float32))
                n += burst.size
        else:
            k = 0
            while k < len(payloads):
                j = k + 1
                while (j < len(payloads) and j - k < BATCH
                       and len(payloads[j]) == len(payloads[k])):
                    j += 1
                pay = torch.from_numpy(np.stack(payloads[k:j])).to(dev)
                fr, fi = stream.frame_modulate_planar(
                    modem.encode(pay), params, flags["preamble"],
                    amplitude=flags["ampl"])
                zeros = torch.zeros(j - k, gap, device=dev)
                re = torch.cat([zeros, fr], dim=-1).reshape(-1).cpu().numpy()
                im = torch.cat([zeros, fi], dim=-1).reshape(-1).cpu().numpy()
                _write(out, flags["format"], re, sign * im)
                n += re.size
                k = j
    finally:
        if out is not sys.stdout.buffer:
            out.close()
    print(f"wrote {n} samples ({len(payload_hex)} frames)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
