"""Shared CLI flag parsing for the port's runners — ``parse_flags``,
``bandwidth_flag``, ``window_flag`` and ``params_from`` are copies of the
JAX twin's (``lora_phy_tpu/runners/_cli.py``), accepting the same flag
spellings (reference: runners/tx_runner.cpp:39-71).

Where the JAX twin pins JAX to the CPU (``use_cpu``), every runner here
takes ``--device=`` (:data:`DEVICE_FLAG`): the first CUDA card by default,
``--device=cpu`` for the CPU. :func:`device_from` resolves it; without a
card and without ``--device=cpu`` the runner prints one line and exits 1.
"""

from __future__ import annotations

import sys

import torch

from .. import device_of
from ..utils.params import Bandwidth, LoraParams, Window

# spec entry of the --device flag: "" = the default device (device_of)
DEVICE_FLAG = (str, "")


def parse_flags(argv, spec: dict):
    """Parse ``--key=value`` / bare ``--flag`` args per ``spec``
    {name: (converter_or_None, default)}. Returns dict; exits on unknown."""
    out = {k: v[1] for k, v in spec.items()}
    for arg in argv:
        if arg in ("--help", "-h"):
            flags = " ".join(
                f"[--{k}{'' if conv is None else '=V'}]" for k, (conv, _) in spec.items()
            )
            print(f"Usage: {sys.argv[0]} {flags}", file=sys.stderr)
            raise SystemExit(0)
        if not arg.startswith("--"):
            print(f"Unknown argument: {arg}", file=sys.stderr)
            raise SystemExit(1)
        body = arg[2:]
        key, sep, val = body.partition("=")
        if key not in spec:
            print(f"Unknown argument: {arg}", file=sys.stderr)
            raise SystemExit(1)
        conv = spec[key][0]
        if conv is None:
            out[key] = True
            continue
        if not sep:
            print(f"Flag --{key} requires a value: --{key}=V", file=sys.stderr)
            raise SystemExit(1)
        try:
            out[key] = conv(val)
        except ValueError:
            print(f"Invalid value for --{key}: {val!r}", file=sys.stderr)
            raise SystemExit(1)
    return out


def bandwidth_flag(val: str) -> Bandwidth:
    hz = int(val)
    try:
        return Bandwidth(hz)
    except ValueError:
        print("Unsupported bandwidth", file=sys.stderr)
        raise SystemExit(1)


def window_flag(val: str) -> Window:
    return Window.HANN if val == "hann" else Window.NONE


def params_from(flags) -> LoraParams:
    return LoraParams(
        sf=flags.get("sf", 7),
        bw=flags.get("bw", Bandwidth.BW_125),
        cr=flags.get("cr", 1),
        osr=flags.get("osr", 1),
        window=flags.get("window", Window.NONE),
        sync_word=flags.get("sync", 0x12),
        continuous_chirp=bool(flags.get("continuous-chirp", False)),
    )


def device_from(flags) -> torch.device | None:
    """The device of ``--device`` (default: the first CUDA card). Prints
    one line to stderr and returns None when it names no usable device
    (no card, or an unknown name); the runner then exits 1."""
    name = flags.get("device") or None
    if name is None:
        try:
            return device_of(None)
        except RuntimeError:
            print("no CUDA device: pass --device=cpu to run on the CPU", file=sys.stderr)
            return None
    try:
        dev = torch.device(name)
    except (RuntimeError, ValueError):
        print(f"Invalid value for --device: {name!r}", file=sys.stderr)
        return None
    if dev.type == "cuda" and not torch.cuda.is_available():
        print(f"no CUDA device for --device={name}: pass --device=cpu to run on "
              "the CPU", file=sys.stderr)
        return None
    return dev
