"""Profile matrix loader — the port's own copy of
``lora_phy_tpu/utils/profiles.py``.

The reference drives its test matrix from ``tests/profiles.yaml`` parsed by
a hand-rolled line parser duplicated across four files (reference:
tests/e2e_chain_test.cpp:25-52, tests/performance_test.cpp:28-55,
tests/awgn_sweep_gtest.cpp:24-50, tests/awgn_sweep.py:45-78). This is the
single shared implementation, accepting the same minimal YAML subset.
"""

from __future__ import annotations

import dataclasses
import pathlib

from .params import Bandwidth, LoraParams, Window


@dataclasses.dataclass(frozen=True)
class Profile:
    name: str
    sf: int
    bw: int
    cr: str
    dir: str = ""

    @property
    def cr_index(self) -> int:
        """cr '4/5'..'4/8' -> RDD index 1..4."""
        if "/" in self.cr:
            return int(self.cr.split("/")[1]) - 4
        return int(self.cr or 1)

    def params(self, osr: int = 1, window: Window = Window.NONE,
               sync_word: int = 0x12) -> LoraParams:
        return LoraParams(
            sf=self.sf, bw=Bandwidth(self.bw), cr=self.cr_index, osr=osr,
            window=window, sync_word=sync_word,
        )


def load_profiles(path) -> list[Profile]:
    """Parse the reference's profiles.yaml dialect: '-' starts a profile,
    'key: value' lines fill it, '#' comments."""
    profiles: list[Profile] = []
    current: dict = {}

    def flush():
        # only real profile entries (the 'profiles:' section header line
        # also lands in `current` but carries none of the profile keys)
        if any(k in current for k in ("name", "sf", "bw", "cr")):
            profiles.append(
                Profile(
                    name=current.get("name", ""),
                    sf=int(current.get("sf", 0)),
                    bw=int(current.get("bw", 0)),
                    cr=current.get("cr", ""),
                    dir=current.get("dir", ""),
                )
            )

    for raw in pathlib.Path(path).read_text().splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line.startswith("-"):
            flush()
            current = {}
            line = line[1:].strip()   # '- name: x' carries the first key
            if not line:
                continue
        if ":" not in line:
            continue
        key, val = (x.strip() for x in line.split(":", 1))
        current[key] = val
    flush()
    return profiles


DEFAULT_PROFILES = [
    Profile("sf7_bw125_cr45", 7, 125000, "4/5"),
    Profile("sf7_bw125_cr47", 7, 125000, "4/7"),
    Profile("sf8_bw125_cr45", 8, 125000, "4/5"),
]
