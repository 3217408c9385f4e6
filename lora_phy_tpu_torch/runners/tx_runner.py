"""TX runner: hex payload -> encode -> modulate -> float32 IQ file/stdout.

The port's twin of ``lora_phy_tpu/runners/tx_runner.py``, flag for flag
as the reference's ``tx_runner`` (reference: runners/tx_runner.cpp:32-141):
``--payload=HEX [--sf=N] [--cr=N] [--bw=HZ] [--out=FILE|--stdout]``, plus
``--device=`` (default the first CUDA card; ``--device=cpu``).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..models import modem
from ..utils.iqio import write_iq
from ._cli import DEVICE_FLAG, bandwidth_flag, device_from, params_from, parse_flags


def main(argv=None) -> int:
    flags = parse_flags(sys.argv[1:] if argv is None else argv, {
        "payload": (str, ""),
        "sf": (int, 7),
        "cr": (int, 1),
        "bw": (bandwidth_flag, None),
        "osr": (int, 1),
        "out": (str, ""),
        "stdout": (None, False),
        "continuous-chirp": (None, False),
        "device": DEVICE_FLAG,
    })
    dev = device_from(flags)
    if dev is None:
        return 1
    hexstr = flags["payload"]
    if not hexstr or len(hexstr) % 2 != 0:
        print("Invalid or missing --payload hex", file=sys.stderr)
        return 1
    payload = np.frombuffer(bytes.fromhex(hexstr), dtype=np.uint8)
    params = params_from({k: v for k, v in flags.items() if v is not None})

    symbols = modem.encode(torch.from_numpy(payload.copy()).to(dev))
    iq = modem.modulate(symbols, params).cpu().numpy()

    if flags["stdout"] or not flags["out"]:
        write_iq("-", iq)
    else:
        write_iq(flags["out"], iq)
        print(f"wrote {iq.size} samples to {flags['out']}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
