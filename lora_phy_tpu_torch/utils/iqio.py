"""IQ sample file IO — float32 interleaved (re, im), the reference's wire
format (reference: runners/tx_runner.cpp:133-138, runners/rx_runner.cpp:64-76,
tests/gr_lora_sdr_interop.cpp:8-19). The port's own copy of
``lora_phy_tpu/utils/iqio.py`` (NumPy only)."""

from __future__ import annotations

import sys

import numpy as np


def read_iq(path_or_file) -> np.ndarray:
    """Read float32 interleaved IQ pairs -> complex64 array."""
    if path_or_file in ("-", None):
        raw = sys.stdin.buffer.read()
        flat = np.frombuffer(raw, dtype=np.float32)
    else:
        flat = np.fromfile(str(path_or_file), dtype=np.float32)
    flat = flat[: (len(flat) // 2) * 2]
    return (flat[0::2] + 1j * flat[1::2]).astype(np.complex64)


def write_iq(path_or_file, samples) -> None:
    """Write complex64 samples as float32 interleaved IQ pairs."""
    samples = np.asarray(samples, dtype=np.complex64)
    flat = np.empty(samples.size * 2, dtype=np.float32)
    flat[0::2] = samples.real
    flat[1::2] = samples.imag
    if path_or_file in ("-", None):
        sys.stdout.buffer.write(flat.tobytes())
        sys.stdout.buffer.flush()
    else:
        flat.tofile(str(path_or_file))


def append_iq(path, samples, mode: str = "ab") -> None:
    """Append complex64 samples to an IQ file (``mode="wb"`` truncates
    first) — for streaming sinks that must not rewrite a growing file."""
    samples = np.asarray(samples, dtype=np.complex64)
    flat = np.empty(samples.size * 2, dtype=np.float32)
    flat[0::2] = samples.real
    flat[1::2] = samples.imag
    with open(str(path), mode) as f:
        f.write(flat.tobytes())
