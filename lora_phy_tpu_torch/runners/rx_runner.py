"""RX runner: IQ file/stdin -> demodulate -> decode -> hex payload.

The port's twin of ``lora_phy_tpu/runners/rx_runner.py``, flag for flag
as the reference's ``rx_runner`` (reference: runners/rx_runner.cpp:23-137):
``[--in=FILE] [--sf=N] [--cr=N] [--bw=HZ] [--report-offsets]``, plus
``--device=`` (default the first CUDA card; ``--device=cpu``).

By default uses the *working* receive path (external dechirp +
``demodulate``; SURVEY.md §3.3). Pass ``--integrated`` for the
quirk-compatible integrated path, ``--raw`` if the input is already
dechirped; both go through the port's :mod:`..models.modem`.
"""

from __future__ import annotations

import sys

import torch

from ..models import modem
from ..utils.iqio import read_iq
from ._cli import DEVICE_FLAG, bandwidth_flag, device_from, params_from, parse_flags


def main(argv=None) -> int:
    flags = parse_flags(sys.argv[1:] if argv is None else argv, {
        "in": (str, ""),
        "sf": (int, 7),
        "cr": (int, 1),
        "bw": (bandwidth_flag, None),
        "osr": (int, 1),
        "report-offsets": (None, False),
        "integrated": (None, False),
        "raw": (None, False),
        "device": DEVICE_FLAG,
    })
    dev = device_from(flags)
    if dev is None:
        return 1
    params = params_from({k: v for k, v in flags.items() if v is not None})

    samples = read_iq(flags["in"] or "-")
    step = params.step
    usable = (samples.size // step) * step
    if usable < 2 * step:
        print("Input too short", file=sys.stderr)
        return 1
    x = torch.from_numpy(samples[:usable].copy()).to(dev)

    if flags["integrated"]:
        res = modem.demodulate_integrated(x, params)
    else:
        res = modem.demodulate(x if flags["raw"] else modem.dechirp(x, params), params)

    decoded = modem.decode_with_crc(res.symbols)
    print(decoded.payload.cpu().numpy().tobytes().hex())
    if flags["report-offsets"]:
        crc_ok, cfo, t_off, sync = torch.stack([
            decoded.crc_ok.to(torch.float64), res.cfo.to(torch.float64),
            res.time_offset.to(torch.float64), res.sync_word.to(torch.float64)]).tolist()
        print(
            f"crc_ok={int(bool(crc_ok))} cfo={cfo:.6f} "
            f"time_offset={t_off:.6f} "
            f"sync=0x{int(sync):02x}",
            file=sys.stderr,
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
