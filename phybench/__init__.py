"""The benchmark of ``lora_phy_tpu_torch`` on one NVIDIA H100.

One run of one cell: ``python3 -m phybench.run --workload <name> --seed
<n> --seconds <s> --trace <0|1>`` from the root of a checkout (see
:mod:`phybench.run`). ``BENCHMARK.json`` names the cells and metrics;
everything that belongs to one configuration, traffic mix, cell or
metric is a file of its own here, found by its name:
``configs/<config>.json``, ``traffic/<traffic>.json`` (read by
``traffic/generator.py``), ``workloads/<cell>.json``,
``paths/<path>.py`` (the program's entry a configuration drives, and
the names of the program's ranges its trace is attributed to) and
``metrics/<metric>.py`` (the reader of one end-to-end or per-layer
metric). ``reference/`` is the plain reference that
decides ``correct``; it imports nothing of the program.
"""
