"""AWGN sweep runner — CSV (+ optional PNG plots) for BER/PER vs SNR; the
port's twin of ``lora_phy_tpu/runners/awgn_sweep.py``.

Equivalent of the reference's ``tests/awgn_sweep.py`` CLI
(reference: tests/awgn_sweep.py:293-346): flags ``--out --packets
--payload-bytes --snr-start --snr-stop --snr-step`` and the same CSV
schema, driven by the batched channel model (:mod:`..models.awgn`) on
``--device=`` (default the first CUDA card; ``--device=cpu``).
"""

from __future__ import annotations

import pathlib
import sys

from ..models import awgn
from ..utils.profiles import DEFAULT_PROFILES, load_profiles
from ._cli import DEVICE_FLAG, device_from, parse_flags


def main(argv=None) -> int:
    flags = parse_flags(sys.argv[1:] if argv is None else argv, {
        "out": (str, "awgn_sweep"),
        "packets": (int, 100),
        "payload-bytes": (int, 16),
        "snr-start": (float, 0.0),
        "snr-stop": (float, 12.0),
        "snr-step": (float, 0.5),
        "profiles": (str, ""),
        "plots": (None, False),
        "device": DEVICE_FLAG,
    })
    dev = device_from(flags)
    if dev is None:
        return 1
    out_dir = pathlib.Path(flags["out"])
    out_dir.mkdir(parents=True, exist_ok=True)

    profiles = (
        load_profiles(flags["profiles"]) if flags["profiles"] else DEFAULT_PROFILES
    )
    rows = awgn.sweep(
        profiles,
        snr_start=flags["snr-start"], snr_stop=flags["snr-stop"],
        snr_step=flags["snr-step"], packets=flags["packets"],
        payload_len=flags["payload-bytes"], device=dev,
    )
    awgn.write_csv(rows, out_dir / "awgn_sweep.csv")

    if flags["plots"]:
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            print("matplotlib unavailable; skipping plots", file=sys.stderr)
        else:
            for p in profiles:
                pr = [r for r in rows if r["sf"] == p.sf and r["cr"] == p.cr]
                snrs = [r["snr_db"] for r in pr]
                plt.figure()
                plt.semilogy(snrs, [max(r["ber"], 1e-9) for r in pr], label="BER")
                plt.semilogy(snrs, [max(r["per"], 1e-9) for r in pr], label="PER")
                plt.xlabel("SNR (dB)")
                plt.ylabel("Error rate")
                plt.title(f"SF{p.sf} BW{p.bw/1000:.0f}k CR{p.cr}")
                plt.grid(True, which="both")
                plt.legend()
                plt.tight_layout()
                plt.savefig(out_dir / f"{p.name}.png")
                plt.close()

    print(f"sweep written to {out_dir}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
