"""Run a Pothos ``.pth`` topology on the port's flowgraph runtime — the
twin of ``lora_phy_tpu/runners/topology_runner.py`` (models/flowgraph.py
is the engine).

    python -m lora_phy_tpu_torch.runners.topology_runner \\
        --file=lora_simulation.pth --ticks=4 --sf=7 [--device=cpu]

Prints the graph's size, one line per message a probe captured, and the
last decoder/demod signal summaries. ``--sf=N`` / ``--mtu=N`` /
``--sync=0xNN`` override the file's globals; ``--seed=N`` seeds the noise
sources. The graph runs on ``--device`` (default the first CUDA card).
"""

from __future__ import annotations

import sys

from ._cli import DEVICE_FLAG, device_from, parse_flags

SPEC = {
    "file": (str, ""),
    "ticks": (int, 4),
    "sf": (int, 0),
    "mtu": (int, 0),
    "sync": (lambda v: int(v, 0), -1),
    "seed": (int, 0),
    "device": DEVICE_FLAG,
}


def main(argv=None) -> int:
    flags = parse_flags(sys.argv[1:] if argv is None else argv, SPEC)
    if not flags["file"]:
        print("Usage: topology_runner --file=PATH.pth [--ticks=N] "
              "[--sf=N] [--mtu=N] [--sync=0xNN] [--seed=N] [--device=D]",
              file=sys.stderr)
        return 1
    dev = device_from(flags)
    if dev is None:
        return 1

    from ..models import flowgraph as fg

    overrides = {}
    if flags["sf"]:
        overrides["SF"] = flags["sf"]
    if flags["mtu"]:
        overrides["MTU"] = flags["mtu"]
    if flags["sync"] >= 0:
        overrides["SYNC"] = flags["sync"]

    topo = fg.load_topology(flags["file"], seed=flags["seed"],
                            overrides=overrides or None, device=dev)
    print(f"{len(topo.blocks)} blocks, {len(topo.wires)} wires, "
          f"{len(topo.signal_wires)} signal wires")
    log = topo.run(flags["ticks"])

    for name, block in sorted(topo.blocks.items()):
        for cap in block.captured:
            if "in" in cap:
                print(f"{name} <- {bytes(cap['in'])!r}")
    for name in sorted(log):
        outs = [o for o in log[name] if o]
        if not outs:
            continue
        last = outs[-1]
        if "dropped" in last:
            print(f"{name}: dropped={last['dropped']}")
        if "snr" in last:
            print(f"{name}: snr={last['snr']:.1f} dB error={last.get('error')}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
