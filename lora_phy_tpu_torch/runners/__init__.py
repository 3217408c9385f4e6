"""Command-line runners of the PyTorch port, one per JAX twin in
``lora_phy_tpu/runners``; run each as ``python -m
lora_phy_tpu_torch.runners.<name>``:

- the radio: ``tx_runner``, ``rx_runner``, ``tx_stream``, ``rx_stream``,
  ``gr_decode``, ``topology_runner``;
- sweeps and diagnostics: ``awgn_sweep``, ``sic_sweep``, ``scope``;
- golden vectors: ``vector_generate``, ``vector_dump``,
  ``compare_vectors``, ``comprehensive_vector_generate``;
- performance: ``perf_test``, ``compare_perf``, ``roofline``,
  ``bench_scaling``.

Every runner that computes does so on the first CUDA card unless given
``--device=`` (``--device=cpu`` for the CPU); ``compare_vectors`` and
``compare_perf`` only read files."""
