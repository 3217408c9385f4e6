"""lora_phy_tpu_torch — the LoRa PHY framework on PyTorch and CUDA.

A port of :mod:`lora_phy_tpu` (the JAX reference, which stays beside it)
to PyTorch, with the one Pallas kernel of the JAX package rewritten by
hand in CUDA C++ for Hopper (``csrc/fused_demod.cu``) and the opt-in
``precision="bf16"`` decisions on the bf16 tensor cores in a second
hand-written kernel (``csrc/bf16_decide.cu``); ``dechirp_planar`` runs as
one pass of a third (``csrc/dechirp.cu``) and the demodulator's shifted
windows of a fourth (``csrc/windows.cu``) on the card. Imports point one
way, ``runners -> parallel -> models -> ops -> utils``; a function that
does not sit in its JAX twin's file names the twin in its docstring:

  ops/coding.py       the coding primitives: Hamming 8/4 and 7/4, parity
                      5/4 and 6/4, Gray, nibbles, bit pack, whiteners,
                      SX1272 CRC16, checksums, diagonal interleavers
  ops/chirp.py        integer-lattice chirp emitter (table gather / trig),
                      the complex modulate_symbols / base_downchirp,
                      gen_chirp and the AWGN model chirps
  ops/fft.py          FFT backends (torch.fft, the four-step DFT matmul)
                      and the planar DFT of the demodulators
  ops/detect.py       the complex detector (argmax, powers, fractional bin)
  ops/planar.py       planar (re, im) TX, dechirp and demodulation (f32,
                      or bf16 DFT operands), the preamble estimators,
                      estimate / compensate offsets; above the ops below
  ops/dechirp.py, ops/windows.py
                      the dechirp and window-gather kernels' wrappers and
                      their eager twins
  ops/fused_demod.py  the fused scale + derotate + FFT + argmax kernel's
                      wrapper and its plain PyTorch twin
  ops/bf16_decide.py  the bf16 derotate + DFT + argmax kernel's wrapper
                      and its plain PyTorch version
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
                      gr_decode, topology_runner, bench_scaling; the
                      golden-vector tools vector_generate, vector_dump,
                      compare_vectors, comprehensive_vector_generate; the
                      perf tools perf_test, compare_perf, roofline; the
                      diagnostics sic_sweep and scope
  utils/params.py     LoraParams, Window, Bandwidth (the port's own copy)
  utils/iqio.py, utils/profiles.py, utils/stats.py
                      IQ file IO, the profile matrix, Wilson intervals
  utils/manifest.py, utils/vectors.py
                      vector-directory manifests (base64, SHA256) and the
                      binary vector record format (own copies)
  utils/profiling.py  torch.profiler traces and the demod roofline at the
                      H100's published peaks

Functions take tensors and compute on the device those tensors live on;
functions that create a tensor from nothing take ``device=``, which
defaults to the first CUDA card (:func:`device_of`). The port imports
nothing of the JAX package; ``utils.params.from_fields`` carries a JAX
``LoraParams`` over.

The parity contract is float32 on every device (bf16 only where a caller
asks for ``precision="bf16"`` / ``mxu_dtype``), so TF32 is switched off
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
