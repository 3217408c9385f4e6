"""Modem configuration types of the PyTorch port — its own copy of
``lora_phy_tpu/utils/params.py`` (the reference's ``lora_params`` /
``lora_metrics`` contract, include/lora_phy/phy.hpp:29-92), so the port
imports nothing of the JAX package.

``LoraParams`` is a frozen, hashable dataclass: functions of the port key
their constant-table caches on it. :func:`from_fields` carries any object
with the same field names (such as the JAX package's ``LoraParams``) over.
"""

from __future__ import annotations

import dataclasses
import enum
import math

import numpy as np


class Bandwidth(enum.IntEnum):
    """Supported LoRa bandwidths in Hz (reference: phy.hpp:37-41)."""

    BW_125 = 125_000
    BW_250 = 250_000
    BW_500 = 500_000


class Window(enum.IntEnum):
    """Optional analysis window (reference: phy.hpp:29-32)."""

    NONE = 0
    HANN = 1


def bw_to_hz(bw: Bandwidth) -> float:
    return float(int(bw))


def bw_scale(bw: Bandwidth) -> float:
    """Chirp sweep scale relative to 125 kHz (reference: phy.hpp:47-49)."""
    return bw_to_hz(bw) / 125_000.0


@dataclasses.dataclass(frozen=True)
class LoraParams:
    """Static modem parameters (reference: phy.hpp:51-58).

    ``sf``       spreading factor (N = 2**sf samples/symbol)
    ``bw``       operating bandwidth
    ``cr``       coding-rate index (1..4 -> 4/5..4/8)
    ``osr``      oversampling ratio (>= 1)
    ``window``   optional analysis window applied before the DFT
    ``sync_word`` two-nibble network sync word
    ``continuous_chirp`` TX fold convention: False reproduces the
                 reference modulator bit-for-bit (its intra-symbol
                 frequency fold leaves a 2*pi/osr phase jump); True folds
                 one sample later, bit-identical at osr=1 and exact at any
                 osr (docs/SEMANTICS.md).
    """

    sf: int = 7
    bw: Bandwidth = Bandwidth.BW_125
    cr: int = 1
    osr: int = 1
    window: Window = Window.NONE
    sync_word: int = 0x12
    continuous_chirp: bool = False

    def __post_init__(self):
        if not (2 <= self.sf <= 12):
            raise ValueError(f"sf must be in [2, 12], got {self.sf}")
        if self.osr < 1:
            raise ValueError(f"osr must be >= 1, got {self.osr}")
        if not (0 <= self.sync_word <= 0xFF):
            raise ValueError(f"sync_word must be a byte, got {self.sync_word}")

    @property
    def n(self) -> int:
        """Base samples per symbol (2**sf)."""
        return 1 << self.sf

    @property
    def step(self) -> int:
        """Oversampled samples per symbol."""
        return self.n * self.osr

    @property
    def scale(self) -> float:
        return bw_scale(self.bw)


@dataclasses.dataclass
class LoraMetrics:
    """Metrics from the last demodulate/decode (reference: phy.hpp:65-69)."""

    crc_ok: bool = False
    cfo: float = 0.0
    time_offset: float = 0.0


def _window_table(params: LoraParams) -> np.ndarray | None:
    """The [N] float32 Hann window of ``params`` (src/phy/LoRaDemod.cpp:17-22),
    or None without a window. JAX twin:
    ``lora_phy_tpu/models/modem.py:_window_table``."""
    if params.window == Window.NONE:
        return None
    n = params.n
    i = np.arange(n, dtype=np.float32)
    return (0.5 - 0.5 * np.cos(2.0 * np.float32(math.pi) * i / np.float32(n - 1))).astype(
        np.float32
    )


def from_fields(obj) -> LoraParams:
    """The port's :class:`LoraParams` with the field values of ``obj``, any
    object that has ``LoraParams``'s field names as attributes (the JAX
    package's ``LoraParams``, a namespace, another dataclass). Enum fields
    are rebuilt from their integer values."""
    kw = {f.name: getattr(obj, f.name) for f in dataclasses.fields(LoraParams)}
    kw["bw"] = Bandwidth(int(kw["bw"]))
    kw["window"] = Window(int(kw["window"]))
    return LoraParams(**kw)
