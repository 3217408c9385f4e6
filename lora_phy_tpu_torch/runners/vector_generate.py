"""Golden-vector generator: full-stage dumps + base64 + SHA256 manifest —
the port's twin of ``lora_phy_tpu/runners/vector_generate.py``.

Equivalent of the reference's ``generate_lora_phy_vectors``
(reference: runners/lora_phy_vector_generate.cpp:128-275): same flags
(``--sf --seed --bytes --osr --bw --out --window --cfo-bins --time-offset``,
plus ``--device=``), same stage files (payload.bin, pre_interleave.csv,
post_interleave.csv, iq_samples.csv, demod_symbols.csv, deinterleave.csv,
decoded.bin, plus iq_samples_offset.csv when impairments are requested),
base64-encoded with a manifest.json of SHA256 hashes.

The chain (encode, modulate, dechirp, demodulate, decode, the impairment
injectors) runs on the device; the stage files are written from numpy
arrays of the JAX twin's dtypes (uint8, uint16, complex64) with its format
strings, so equal values give byte-equal files.

As in the JAX twin, the demod stage uses the *working* dechirped path, so
``decoded.bin`` equals ``payload.bin``; ``--quirk-compat`` reproduces the
reference's broken integrated goldens instead.
"""

from __future__ import annotations

import pathlib
import sys

import numpy as np
import torch

from .. import device_of
from ..models import modem
from ..ops import coding
from ..ops.impair import apply_cfo, apply_time_shift
from ..utils.manifest import b64_encode_file, write_manifest
from ._cli import (DEVICE_FLAG, bandwidth_flag, device_from, params_from,
                   parse_flags, window_flag)


def _int_lines(values: np.ndarray) -> str:
    return "".join(f"{v}\n" for v in values.tolist())


def _iq_lines(iq: np.ndarray) -> str:
    """``f"{s.real:g},{s.imag:g}\\n"`` per complex64 sample, as the JAX
    twin writes it: ``tolist`` of the float32 planes gives their exact
    values as Python floats, which format as the float32 scalars do."""
    return "".join(f"{r:g},{i:g}\n"
                   for r, i in zip(iq.real.tolist(), iq.imag.tolist()))


def generate(out_dir, params, seed=1, byte_count=16, cfo_bins=0.0,
             time_offset=0.0, quirk_compat=False, b64=True, device=None):
    """Write the stage files of one payload to ``out_dir`` (returned):
    the payload from ``np.random.RandomState(seed)``, the chain on
    ``device`` (default: the first CUDA card)."""
    dev = device_of(None, device)
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)

    rng = np.random.RandomState(seed)
    payload = rng.randint(0, 256, byte_count).astype(np.uint8)
    payload_t = torch.from_numpy(payload).to(dev)

    sf = params.sf
    nibble_count = byte_count * 2
    cw_count = -(-nibble_count // sf) * sf
    rdd = 4
    blocks = cw_count // sf
    symbol_count = blocks * (4 + rdd)

    # pre-interleave stage: Hamming84 codeword per nibble, zero padded
    nibbles = torch.zeros(cw_count, dtype=torch.uint8, device=dev)
    nibbles[:nibble_count] = coding.bytes_to_nibbles(payload_t)
    pre_interleave = coding.hamming84_encode(nibbles)

    symbols = modem.encode(payload_t)
    iq = modem.modulate(symbols, params)

    # demodulate: working path by default, integrated-quirk on request
    if quirk_compat:
        res = modem.demodulate_integrated(iq, params, quirk_compat=True)
    else:
        res = modem.demodulate(modem.dechirp(iq, params), params)
    got = res.symbols.to(torch.int32)
    demod = torch.zeros(symbol_count, dtype=torch.int32, device=dev)
    k = min(symbol_count, got.numel())
    demod[:k] = got[:k]

    # deinterleave stage artifact, kept for file-level parity with the
    # reference's pipeline (it deinterleaves symbols the TX never
    # interleaved)
    deinter = coding.diagonal_deinterleave(demod, sf, rdd)
    if quirk_compat:
        dec_nib, _, _ = coding.hamming84_decode(deinter)
        decoded = coding.nibbles_to_bytes(dec_nib[:nibble_count])
    else:
        # working path: the demod symbols ARE the Hamming84 codewords
        decoded = modem.decode(demod[:nibble_count])

    impaired = None
    if cfo_bins != 0.0 or time_offset != 0.0:
        impaired = iq
        if cfo_bins:
            impaired = apply_cfo(impaired, cfo_bins, 1 << sf, params.osr)
        if time_offset:
            impaired = apply_time_shift(impaired, int(round(time_offset)))

    def host(t, dtype):
        return t.cpu().numpy().astype(dtype)

    (out / "payload.bin").write_bytes(payload.tobytes())
    (out / "pre_interleave.csv").write_text(_int_lines(host(pre_interleave, np.uint8)))
    (out / "post_interleave.csv").write_text(_int_lines(host(symbols, np.uint16)))
    (out / "iq_samples.csv").write_text(_iq_lines(host(iq, np.complex64)))
    (out / "demod_symbols.csv").write_text(_int_lines(host(demod, np.uint16)))
    (out / "deinterleave.csv").write_text(_int_lines(host(deinter, np.uint16)))
    (out / "decoded.bin").write_bytes(host(decoded, np.uint8).tobytes())
    if impaired is not None:
        (out / "iq_samples_offset.csv").write_text(
            _iq_lines(host(impaired, np.complex64)))

    if b64:
        for f in sorted(out.iterdir()):
            if f.suffix in (".bin", ".csv"):
                b64_encode_file(f)
    write_manifest(out)
    return out


def main(argv=None) -> int:
    flags = parse_flags(sys.argv[1:] if argv is None else argv, {
        "sf": (int, 7),
        "seed": (int, 1),
        "bytes": (int, 16),
        "osr": (int, 1),
        "bw": (bandwidth_flag, None),
        "out": (str, ""),
        "window": (window_flag, None),
        "cfo-bins": (float, 0.0),
        "time-offset": (float, 0.0),
        "quirk-compat": (None, False),
        "no-b64": (None, False),
        "device": DEVICE_FLAG,
    })
    if not flags["out"]:
        print("--out=SUBDIR required", file=sys.stderr)
        return 1
    dev = device_from(flags)
    if dev is None:
        return 1
    params = params_from({k: v for k, v in flags.items() if v is not None})
    out = pathlib.Path("vectors/lora_phy") / flags["out"]
    generate(out, params, seed=flags["seed"], byte_count=flags["bytes"],
             cfo_bins=flags["cfo-bins"], time_offset=flags["time-offset"],
             quirk_compat=flags["quirk-compat"], b64=not flags["no-b64"],
             device=dev)
    print(f"vectors written to {out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
