"""Vector-directory regression comparator (SHA256 of every file must match)
— the port's twin of ``lora_phy_tpu/runners/compare_vectors.py``, equivalent
of the reference's scripts/compare_vectors.py:17-61. Exit codes: 2 for
usage, 1 for a mismatch, 0 for equal directories."""

from __future__ import annotations

import sys

from ..utils.manifest import compare_dirs


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if len(args) != 2:
        print(f"Usage: {sys.argv[0]} DIR_A DIR_B", file=sys.stderr)
        return 2
    errors = compare_dirs(args[0], args[1])
    for e in errors:
        print(e, file=sys.stderr)
    if errors:
        print(f"FAIL: {len(errors)} mismatches", file=sys.stderr)
        return 1
    print("OK: directories match", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
