"""Command-line runners of the PyTorch port, one per JAX twin in
``lora_phy_tpu/runners``; run each as ``python -m
lora_phy_tpu_torch.runners.<name>``. Every runner computes on the first
CUDA card unless given ``--device=`` (``--device=cpu`` for the CPU)."""
