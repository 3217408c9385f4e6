"""Performance regression gate — the port's own copy of
``lora_phy_tpu/runners/compare_perf.py`` (pure Python); equivalent of the reference's
scripts/compare_perf.py:28-44: compare a new perf CSV against a baseline
CSV per profile; fail if throughput drops or per-symbol cost rises.

CSV schema (reference: tests/performance_test.cpp:126-133):
``run_id,profile,sf,N,pps,cycles_per_symbol`` — our runs write
``us_per_symbol`` in place of rdtsc cycles (wall-clock per symbol).
"""

from __future__ import annotations

import csv
import sys


def load(path):
    rows = {}
    with open(path) as f:
        for row in csv.DictReader(f):
            rows[row["profile"]] = row
    return rows


def compare(baseline_path, new_path, tolerance=0.0):
    base, new = load(baseline_path), load(new_path)
    errors = []
    for profile, b in base.items():
        n = new.get(profile)
        if n is None:
            errors.append(f"missing profile in new run: {profile}")
            continue
        if float(n["pps"]) < float(b["pps"]) * (1.0 - tolerance):
            errors.append(
                f"{profile}: pps dropped {float(b['pps']):.1f} -> {float(n['pps']):.1f}"
            )
        cost_key = "us_per_symbol" if "us_per_symbol" in n else "cycles_per_symbol"
        if cost_key in b and float(n[cost_key]) > float(b[cost_key]) * (1.0 + tolerance):
            errors.append(
                f"{profile}: {cost_key} rose {float(b[cost_key]):.1f} -> "
                f"{float(n[cost_key]):.1f}"
            )
    return errors


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if len(args) not in (2, 3):
        print(f"Usage: {sys.argv[0]} BASELINE.csv NEW.csv [tolerance]", file=sys.stderr)
        return 2
    tol = float(args[2]) if len(args) == 3 else 0.0
    errors = compare(args[0], args[1], tol)
    for e in errors:
        print(e, file=sys.stderr)
    if errors:
        print("FAIL: performance regression", file=sys.stderr)
        return 1
    print("OK: no regression", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
