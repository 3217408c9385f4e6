"""lora_phy_tpu_torch — the LoRa PHY framework on PyTorch and CUDA.

A port of :mod:`lora_phy_tpu` (the JAX reference, which stays beside it)
to PyTorch, with the one Pallas kernel of the JAX package rewritten by
hand in CUDA C++ for Hopper (``csrc/fused_demod.cu``). Every function
mirrors its JAX twin file for file:

  ops/coding.py       the coding primitives: Hamming 8/4 and 7/4, parity
                      5/4 and 6/4, Gray, nibbles, bit pack, whiteners,
                      SX1272 CRC16, checksums, diagonal interleavers
  ops/chirp.py        integer-lattice chirp emitter (table gather / trig),
                      the complex modulate_symbols / base_downchirp and
                      the AWGN model chirps
  ops/fft.py          FFT backends (torch.fft, the four-step DFT matmul)
  ops/detect.py       the complex detector (argmax, powers, fractional bin)
  ops/planar.py       planar (re, im) TX, dechirp and demodulation, the
                      preamble estimators, estimate / compensate offsets
  ops/fused_demod.py  the fused scale + derotate + FFT + argmax kernel's
                      wrapper and its plain PyTorch twin
  ops/impair.py       channel injectors (CFO, shift, AWGN, SRO, multipath,
                      front end) and the blind front-end corrector
  ops/channelizer.py  polyphase analysis and synthesis filter banks
  models/modem.py     encode / decode, the complex demodulators and the
                      offsets API
  models/coded.py     the coded chain (CRC, whitening, FEC, interleaving,
                      Gray) and the explicit header
  models/soft.py      soft decoding: max-log LLRs, ML codeword decoding
  models/stream.py    frame synthesis, frame sync, the serial and adaptive
                      (header-driven) receivers, the block-wise receiver
  models/sync.py      the frame-sync scan, the block receiver (plain and
                      multipath-robust), CAD, blind SF, the wideband
                      receiver
  models/sic.py       the collision receiver (successive interference
                      cancellation)
  models/awgn.py      the AWGN Monte Carlo (BER/PER sweeps)
  models/gr_interop.py  gr-lora_sdr frames: decode and encode
  models/flowgraph.py the block-graph runtime for Pothos .pth topologies
  parallel/           device meshes and the per-shard runner, the
                      time-sharded streaming receivers, the
                      multi-process layer (torch.distributed)
  runtime.py          ctypes binding to the native ingest runtime
                      (runtime/lora_runtime.cpp, built with g++)
  runners/            the command line (python -m
                      lora_phy_tpu_torch.runners.<name>): tx_runner,
                      rx_runner, tx_stream, rx_stream, awgn_sweep,
                      gr_decode, topology_runner, bench_scaling
  utils/params.py     LoraParams, Window, Bandwidth (the port's own copy)
  utils/iqio.py, utils/profiles.py, utils/stats.py
                      IQ file IO, the profile matrix, Wilson intervals

Functions take tensors and compute on the device those tensors live on;
functions that create a tensor from nothing take ``device=``, which
defaults to the first CUDA card (:func:`device_of`). The port imports
nothing of the JAX package; ``utils.params.from_fields`` carries a JAX
``LoraParams`` over.

The parity contract is float32 on every device, so TF32 is switched off
here, once, at import.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .utils.params import (  # noqa: F401
    Bandwidth,
    LoraMetrics,
    LoraParams,
    Window,
    bw_scale,
    from_fields,
)

__version__ = "0.1.0"

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def device_of(x=None, device=None) -> torch.device:
    """The device to compute on: ``device`` when given, else the device of
    the tensor ``x``, else the first CUDA card. Never falls back to the
    CPU: without a card it raises, and CPU work asks for it explicitly
    (a CPU tensor or ``device="cpu"``)."""
    if device is not None:
        return torch.device(device)
    if isinstance(x, torch.Tensor):
        return x.device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device (torch.cuda.is_available() is false) and no "
            "device given: pass a CPU tensor or device='cpu' to run on the CPU")
    return torch.device("cuda", 0)


def device_table(builder, *args, device) -> object:
    """``builder(*args)`` (a NumPy table builder) with every ndarray in its
    result moved to ``device`` once and cached, so the constant tables are
    built by the same NumPy code as the JAX package's and uploaded once."""
    return _device_table(builder, args, torch.device(device))


@functools.lru_cache(maxsize=64)
def _device_table(builder, args, device):
    def put(a):
        if isinstance(a, np.ndarray):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)
        return a

    out = builder(*args)
    if isinstance(out, tuple):
        return tuple(put(a) for a in out)
    return put(out)
