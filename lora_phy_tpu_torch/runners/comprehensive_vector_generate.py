"""Comprehensive binary vector generator — the port's twin of
``lora_phy_tpu/runners/comprehensive_vector_generate.py``.

Equivalent of the reference's ``generate_comprehensive_vectors``
(reference: runners/comprehensive_vector_generate.cpp:46-105): writes
``hamming_tests.bin`` (Hamming84 records for all 16 nibbles) and
``modulation_tests.bin`` (SF x payload matrix, demodulated on
``--device=``) in the corpus record format (:mod:`..utils.vectors`).
"""

from __future__ import annotations

import pathlib
import sys

import torch

from ..models import modem
from ..ops import coding
from ..utils.params import LoraParams
from ..utils.vectors import VectorRecord, write_binary_vectors
from ._cli import DEVICE_FLAG, device_from, parse_flags

PAYLOADS = [b"Hello", b"Test123", b"AAAAAAAAAA", b"\x00\x01\x02\x03",
            b"LoRa TPU"]


def main(argv=None) -> int:
    flags = parse_flags(sys.argv[1:] if argv is None else argv, {
        "out": (str, "vectors_binary_out"),
        "device": DEVICE_FLAG,
    })
    dev = device_from(flags)
    if dev is None:
        return 1
    out = pathlib.Path(flags["out"])
    out.mkdir(parents=True, exist_ok=True)

    # Hamming84 records: encoded codeword for every nibble in `extra`
    codewords = coding.hamming84_encode(
        torch.arange(16, dtype=torch.uint8, device=dev)).cpu().tolist()
    hamming = []
    for nib, cw in enumerate(codewords):
        hamming.append(VectorRecord("no_error", bytes([nib]), 0, "4/8",
                                    bytes([cw])))
        for bit in range(8):
            hamming.append(VectorRecord("single_error", bytes([nib]), 0,
                                        "4/8", bytes([cw ^ (1 << bit)])))
    write_binary_vectors(out / "hamming_tests.bin", hamming)

    # modulation records: per SF x payload, demod symbols in `extra`
    modulation = []
    for sf in (7, 8, 9, 10, 11, 12):
        p = LoraParams(sf=sf)
        for payload in PAYLOADS:
            data = torch.frombuffer(bytearray(payload), dtype=torch.uint8).to(dev)
            iq = modem.modulate(modem.encode(data), p)
            res = modem.demodulate(modem.dechirp(iq, p), p)
            extra = res.symbols.cpu().numpy().astype("<u2").tobytes()
            modulation.append(VectorRecord("modulation", payload, sf, "4/8",
                                           extra))
    write_binary_vectors(out / "modulation_tests.bin", modulation)
    print(f"wrote {out}/hamming_tests.bin ({len(hamming)} records), "
          f"{out}/modulation_tests.bin ({len(modulation)} records)",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
