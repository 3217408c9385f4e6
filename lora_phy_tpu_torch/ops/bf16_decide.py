"""bf16 decision stage: optional CFO derotation, the N-point DFT with bf16
operands and float32 sums, |.|² and the first-max argmax over the
natural bins, for N = 4..4096 (SF2-12) — the ``precision="bf16"``
decisions of :func:`.planar.demodulate_planar` and
``argmax_bins_planar(mxu_dtype=torch.bfloat16)``.

It ports no Pallas kernel: in JAX this is jnp code that XLA fuses
(``lora_phy_tpu/ops/planar.py``: ``_mm``, ``_dft_mag2_scrambled``,
``argmax_bins_planar``, and their use in ``demodulate_planar`` after
``_rotated_windows_planar``). On a CUDA tensor :func:`bf16_decide_rows`
launches the hand-written CUDA C++ kernel ``csrc/bf16_decide.cu`` (bf16
tensor cores, built for sm_90a at first use, see :mod:`.._build`), which
keeps the derotated planes and the spectrum out of device memory; on a
CPU tensor it runs the plain PyTorch version
:func:`bf16_decide_rows_reference`. There is no other route: a CUDA call
either launches the kernel or raises.

Kernel and plain version round the same values to bf16 (the derotation
op by op, the tables from the same float32 numpy builders) and multiply
exactly; only the order of the float32 sums differs (the tensor cores'
accumulation is not IEEE-sequential), so their bins agree except at
near-ties (:func:`near_tie`).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..utils.profiling import launch_range
from . import planar

# Launches of the CUDA kernel in this process: one per call of
# bf16_decide_rows on CUDA tensors, so a run can show that its path went
# through the kernel.
LAUNCHES = 0

# N the kernel takes: every power of two of LoraParams' SF2-12
KERNEL_N = tuple(1 << sf for sf in range(2, 13))
# N served by the wgmma design (A from registers, tables in the layout of
# wgmma_layout), and by the four-step on wgmma (both operands from shared
# memory); N = 16 runs mma.sync with A from registers (k permuted as for
# wgmma, one warp a 32-row task), N = 4, 8 mma.sync through shared memory
N16_N = 16
WGMMA_N = (32, 64, 128)
FOURSTEP_N = (256, 512, 1024, 2048, 4096)
# the four-step's tiling (Fs<n1, n2> in csrc/bf16_decide.cu): N -> (frame
# rows a tile, warpgroups a block, blocks an SM); a tile's stage-1 rows
# (rb, i1) fill one m64 tile, four at N = 256
FOURSTEP_TILE = {256: (16, 2, 2), 512: (4, 2, 2), 1024: (2, 2, 2), 2048: (2, 3, 1),
                 4096: (1, 3, 1)}


def design(n: int) -> str:
    """The kernel design that serves N: ``"wgmma"`` (N = 32, 64, 128),
    ``"wgmma-fourstep"`` (N = 256..4096), ``"mma.sync-warp"`` (N = 16: A
    from registers, one warp a task) or ``"mma.sync"`` (N = 4, 8)."""
    if n in WGMMA_N:
        return "wgmma"
    if n == N16_N:
        return "mma.sync-warp"
    return "wgmma-fourstep" if n in FOURSTEP_N else "mma.sync"


def near_tie(n: int) -> float:
    """Relative gap between a row's two largest |.|² below which kernel and
    plain version may pick different bins, and the relative difference
    their peaks may show. At N <= 128 only the order of float32 sums of up
    to 2N exact products differs: 1e-5. At N > 128 a sum-order difference
    in stage 1 can move one bf16 rounding of a stage-2 operand b_i by one
    bf16 step (at most 2^-7 |b_i|), which moves |y|² by at most
    2 * 2^-7 |b_i| / |y| <= 2^-6 of the peak (|y_peak| >= max |b_i|)."""
    return 1e-5 if n <= 128 else 2.0 ** -6


def _derotate(yr: torch.Tensor, yi: torch.Tensor, n: int, cr, si, rows_per_rot: int):
    """``fr = yr*cr - yi*si``, ``fi = yr*si + yi*cr`` with row r rotated by
    rotation ``r // rows_per_rot`` (each op rounded on its own, as
    :func:`.planar._rotated_windows_planar`)."""
    if cr is None:
        return yr, yi
    b = cr.shape[0]
    y3r, y3i = yr.reshape(b, rows_per_rot, n), yi.reshape(b, rows_per_rot, n)
    c, s = cr[:, None, :], si[:, None, :]
    fr = y3r * c - y3i * s
    fi = y3r * s + y3i * c
    return fr.reshape(-1, n), fi.reshape(-1, n)


def bf16_decide_rows_reference(yr: torch.Tensor, yi: torch.Tensor, n: int,
                               cr: torch.Tensor | None = None,
                               si: torch.Tensor | None = None,
                               rows_per_rot: int = 1, with_peak: bool = False):
    """Plain PyTorch version of the kernel: the derotation, then exactly
    ``argmax_bins_planar(fr, fi, n, mxu_dtype=torch.bfloat16)`` in torch
    ops (int32 bins, and the float32 peak |.|² with ``with_peak``)."""
    fr, fi = _derotate(yr, yi, n, cr, si, rows_per_rot)
    return planar._argmax_bins_ops(fr, fi, n, torch.bfloat16, with_peak)


def _pair_tables(m: np.ndarray, k: int, kp: int, np_: int):
    """``(Wr.T, Wi.T)`` of a combined [2k, 2k] matrix ``[[Wr, Wi], [-Wi, Wr]]``,
    zero-padded to [np_, kp] float32 ([bin][k], the kernel's layout)."""
    wr, wi = m[:k, :k], m[:k, k:]
    if not (np.array_equal(m[k:, :k], -wi) and np.array_equal(m[k:, k:], wr)):
        raise ValueError("the combined DFT matrix is not [[Wr, Wi], [-Wi, Wr]]")
    out = []
    for w in (wr, wi):
        t = np.zeros((np_, kp), np.float32)
        t[:k, :k] = w.T
        out.append(t)
    return out


def _wgmma_columns(k: int) -> np.ndarray:
    """Column of the [bins, k] table held at each k slot of the tables of
    the kernels whose A comes from registers (wgmma at N = 32..128, the
    N = 16 mma.sync kernel): in k-step s (slots 16s..16s+15), slots 2t,
    2t+1, 2t+8, 2t+9 of the A fragment take columns 16s + 4t .. 16s + 4t
    + 3, so that a thread reads its four samples of a row as one float4."""
    p = np.arange(k) % 16
    return (np.arange(k) // 16) * 16 + 4 * ((p % 8) // 2) + 2 * (p // 8) + p % 2


def wgmma_layout(wt: np.ndarray, permute: bool = True) -> np.ndarray:
    """A [bins, k] table (``Wr.T`` or ``Wi.T``) in the wgmma kernels'
    shared-memory order, flat: k permuted by :func:`_wgmma_columns` (the
    N = 32..128 kernel, whose A comes from registers; not with
    ``permute=False``, the four-step's), then 8 x 8 core matrices of 8 bins
    x 8 k (row-major, 128 bytes of bf16), core matrix (b, c) of 8-bin group
    b and 8-deep k group c at position ``b * (k / 8) + c``: the canonical
    no-swizzle K-major layout of a wgmma operand, with LBO = 128 bytes (k
    groups) and SBO = 16 k bytes (bin groups)."""
    bins, k = wt.shape
    slotted = wt[:, _wgmma_columns(k)] if permute else wt
    return np.ascontiguousarray(
        slotted.reshape(bins // 8, 8, k // 8, 8).transpose(0, 2, 1, 3).reshape(-1))


def wgmma_unlayout(flat: np.ndarray, bins: int, k: int, permute: bool = True) -> np.ndarray:
    """The inverse of :func:`wgmma_layout`: the [bins, k] table back."""
    slotted = np.asarray(flat).reshape(bins // 8, k // 8, 8, 8).transpose(0, 2, 1, 3)
    if not permute:
        return np.ascontiguousarray(slotted.reshape(bins, k))
    wt = np.empty((bins, k), slotted.dtype)
    wt[:, _wgmma_columns(k)] = slotted.reshape(bins, k)
    return wt


def _fragment_index(n2: int):
    """(row, k2) of each entry of the four-step's twiddle planes in the
    kernel's order (warp w, n-tile j, lane, c), flat: the stage-1
    accumulator element c of n-tile j of lane (g, t) of warp w is tile row
    ``16 w + g + 8 (c // 2)``, bin ``k2 = 8 j + 2 t + c % 2``."""
    w, j, lane, c = np.meshgrid(np.arange(4), np.arange(n2 // 8), np.arange(32), np.arange(4),
                                indexing="ij")
    row = 16 * w + lane // 4 + 8 * (c // 2)
    k2 = 8 * j + 2 * (lane % 4) + c % 2
    return row.reshape(-1), k2.reshape(-1)


def fourstep_twiddles(tw: np.ndarray) -> np.ndarray:
    """A [n1, n2] float32 twiddle plane in the four-step kernel's fragment
    order, flat [64 * n2]: a thread reads its four accumulators' twiddles
    of an n-tile as one float4 (tile row r is (rb, i1 = r % n1))."""
    n1, n2 = tw.shape
    row, k2 = _fragment_index(n2)
    return np.ascontiguousarray(tw[row % n1, k2], np.float32)


@functools.lru_cache(maxsize=32)
def _kernel_tables(n: int, device: torch.device):
    """The kernel's constants on ``device``: bf16 DFT tables rounded by torch
    from the port's own float32 numpy builders (the same bits the plain
    version's ``_mm`` rounds to), and for N > 128 the stage-2 tables and the
    float32 twiddles. ``(wa_r, wa_i, wb_r, wb_i, twr, twi)``, None where the
    N <= 128 kernel takes nothing. At N in :data:`WGMMA_N` the tables are
    flat [N * N] in :func:`wgmma_layout`'s order; at N = 16 [16, 16] with k
    permuted by :func:`_wgmma_columns`; at N = 4, 8 [8, 16] zero-padded;
    at N > 128 flat [n2 * n2]
    (stage 1) and [n1 * n1] (stage 2) in ``wgmma_layout(permute=False)``'s,
    and the twiddles flat [64 * n2] in :func:`fourstep_twiddles`'."""
    def bf16(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16).to(device)

    if n in WGMMA_N:
        wa = _pair_tables(planar._combined_dft_mat(n), n, n, n)
        return bf16(wgmma_layout(wa[0])), bf16(wgmma_layout(wa[1])), None, None, None, None
    if n == N16_N:
        wa = _pair_tables(planar._combined_dft_mat(n), n, n, n)
        cols = _wgmma_columns(n)
        return bf16(wa[0][:, cols]), bf16(wa[1][:, cols]), None, None, None, None
    if n <= 128:
        wa = _pair_tables(planar._combined_dft_mat(n), n, max(n, 16), max(n, 8))
        return bf16(wa[0]), bf16(wa[1]), None, None, None, None
    m2, m1r, twr, twi, n1, n2 = planar._scrambled_mats(n)
    wa = [wgmma_layout(t, permute=False) for t in _pair_tables(m2, n2, n2, n2)]
    wb = [wgmma_layout(t, permute=False) for t in _pair_tables(m1r, n1, n1, n1)]
    tw = [torch.from_numpy(fourstep_twiddles(a)).to(device) for a in (twr, twi)]
    return bf16(wa[0]), bf16(wa[1]), bf16(wb[0]), bf16(wb[1]), tw[0], tw[1]


def _check(yr, yi, n, cr, si, rows_per_rot):
    if n not in KERNEL_N:
        raise ValueError(f"N must be a power of two in {KERNEL_N[0]}..{KERNEL_N[-1]}, got {n}")
    if yr.dim() != 2 or tuple(yr.shape) != tuple(yi.shape) or yr.shape[1] != n:
        raise ValueError(f"yr / yi must be [rows, {n}], got {tuple(yr.shape)} / "
                         f"{tuple(yi.shape)}")
    if (cr is None) != (si is None):
        raise ValueError("give both rotation planes cr and si, or neither")
    if rows_per_rot < 1:
        raise ValueError(f"rows_per_rot must be >= 1, got {rows_per_rot}")
    named = {"yr": yr, "yi": yi}
    if cr is not None:
        b, rem = divmod(yr.shape[0], rows_per_rot)
        if rem or tuple(cr.shape) != (b, n) or tuple(si.shape) != (b, n):
            raise ValueError(f"cr / si must be [rows / rows_per_rot, {n}] = [{b}, {n}] "
                             f"(rows {yr.shape[0]}, rows_per_rot {rows_per_rot}), got "
                             f"{tuple(cr.shape)} / {tuple(si.shape)}")
        named.update(cr=cr, si=si)
    for name, t in named.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != yr.device:
            raise ValueError(f"{name} is on {t.device}, yr on {yr.device}")
        if t.device.type == "cuda" and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device.type == "cuda" and t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary (the kernel "
                             f"reads it as float4)")


def bf16_decide_rows(yr: torch.Tensor, yi: torch.Tensor, n: int,
                     cr: torch.Tensor | None = None, si: torch.Tensor | None = None,
                     rows_per_rot: int = 1, with_peak: bool = False):
    """bf16 decisions over [rows, N] float32 pre-rotation windows ``yr``,
    ``yi``, derotated first by the [rows / rows_per_rot, N] planes ``cr``,
    ``si`` when given (row r by plane ``r // rows_per_rot``). Returns [rows]
    int32 bins, and with ``with_peak`` also the [rows] float32 peak |.|²."""
    global LAUNCHES
    _check(yr, yi, n, cr, si, rows_per_rot)
    if yr.device.type == "cpu":
        return bf16_decide_rows_reference(yr, yi, n, cr, si, rows_per_rot, with_peak)
    if yr.device.type != "cuda":
        raise ValueError(f"no bf16 decision kernel for device {yr.device}")

    from .._build import load_library

    lib = load_library()
    wa_r, wa_i, wb_r, wb_i, twr, twi = _kernel_tables(n, yr.device)
    rows = yr.shape[0]
    out = torch.empty(rows, dtype=torch.int32, device=yr.device)
    peak = torch.empty(rows, dtype=torch.float32, device=yr.device) if with_peak else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(yr.device), launch_range("bf16_decide.launch"):
        stream = torch.cuda.current_stream(yr.device).cuda_stream
        rc = lib.lora_bf16_decide(
            ptr(yr), ptr(yi), ptr(cr), ptr(si), ctypes.c_longlong(rows),
            ctypes.c_longlong(rows_per_rot), ctypes.c_int(n), ptr(wa_r), ptr(wa_i),
            ptr(wb_r), ptr(wb_i), ptr(twr), ptr(twi), ptr(out), ptr(peak), stream)
    if rc != 0:
        msg = lib.lora_cuda_error_string(rc).decode()
        raise RuntimeError(f"bf16_decide kernel launch failed: CUDA error {rc} ({msg})")
    LAUNCHES += 1
    return (out, peak) if with_peak else out
