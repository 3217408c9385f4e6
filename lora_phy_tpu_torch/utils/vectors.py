"""Reader and writer of the reference's binary test-vector record format —
the port's own copy of ``lora_phy_tpu/utils/vectors.py`` (pure Python)
(reference: scripts/create_binary_vectors.py:33-69, the corpus in the
reference's ``vectors_binary/``): little-endian, ``u32 count`` header, then
per record: len-prefixed ``test_type``, len-prefixed ``payload``,
``u32 spread_factor``, len-prefixed ``coding_rate``, len-prefixed extra data.
"""

from __future__ import annotations

import dataclasses
import struct


@dataclasses.dataclass
class VectorRecord:
    test_type: str
    payload: bytes
    spread_factor: int
    coding_rate: str
    extra: bytes


def load_binary_vectors(path) -> list[VectorRecord]:
    records: list[VectorRecord] = []
    with open(path, "rb") as f:
        (count,) = struct.unpack("<I", f.read(4))

        def rd(n: int) -> bytes:
            b = f.read(n)
            if len(b) != n:   # truncated/corrupt file: fail loudly, not
                raise ValueError(   # with silently short payloads
                    f"truncated vector file {path}: wanted {n} bytes, "
                    f"got {len(b)}")
            return b

        def lp() -> bytes:
            (n,) = struct.unpack("<I", rd(4))
            return rd(n)

        for _ in range(count):
            test_type = lp().decode("utf-8")
            payload = lp()
            (sf,) = struct.unpack("<I", rd(4))
            cr = lp().decode("utf-8")
            extra = lp()
            records.append(VectorRecord(test_type, payload, sf, cr, extra))
    return records


def write_binary_vectors(path, records) -> None:
    """Writer for the same record format (inverse of
    :func:`load_binary_vectors`), used by the comprehensive vector
    generator (reference: runners/comprehensive_vector_generate.cpp:46-105)."""
    with open(path, "wb") as f:
        f.write(struct.pack("<I", len(records)))
        for rec in records:
            tt = rec.test_type.encode("utf-8")
            f.write(struct.pack("<I", len(tt)))
            f.write(tt)
            f.write(struct.pack("<I", len(rec.payload)))
            f.write(rec.payload)
            f.write(struct.pack("<I", rec.spread_factor))
            cr = rec.coding_rate.encode("utf-8")
            f.write(struct.pack("<I", len(cr)))
            f.write(cr)
            f.write(struct.pack("<I", len(rec.extra)))
            f.write(rec.extra)
