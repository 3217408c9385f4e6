"""Framed LoRa streams: frame synthesis and the block-wise stream receiver
— the PyTorch twin of the planar part of ``lora_phy_tpu/models/stream.py``.

A frame is ``preamble_len`` base upchirps, 2 sync-word upchirps, 2.25
base downchirps, then the payload upchirps (the standard LoRa frame the
reference documents in scripts/create_golden_vectors.cpp:95-140).
:class:`BatchStreamDemodulator` feeds fixed blocks of a continuous stream
through :func:`.sync.receive_block_planar` and carries the unconsumed
tail; the tail and the blocks stay on the device.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import LoraParams, device_of, device_table
from . import sync

QUARTER_DEN = 4  # 2.25 downchirps: 2 full + step/4 samples


def frame_overhead_samples(params: LoraParams, preamble_len: int = 8) -> int:
    """Samples before the payload symbols: preamble + 2 sync + 2.25 down."""
    step = params.step
    return (preamble_len + 2) * step + 2 * step + step // QUARTER_DEN


@functools.lru_cache(maxsize=16)
def _down_section(n: int, osr: int, scale: float, amplitude: float):
    """(re, im) float32 planes of the phase-continuous 2.25-symbol
    downchirp, from the float64 host oracle (as the JAX twin)."""
    from ..ops.chirp import gen_chirp_np

    step = n * osr
    down, _ = gen_chirp_np(n, osr, 2 * step + step // QUARTER_DEN, 0.0,
                           down=True, ampl=amplitude, bw_scale=scale)
    return (np.ascontiguousarray(down.real.astype(np.float32)),
            np.ascontiguousarray(down.imag.astype(np.float32)))


def frame_modulate_planar(symbols, params: LoraParams,
                          preamble_len: int = 8, amplitude: float = 1.0,
                          sync_symbols=None, device=None):
    """Full frames as (re, im) float32 planes, bit-exact with the JAX
    twin: [..., S] symbols -> each [..., overhead + S*step]. ``symbols``
    is a tensor, computed on where it lives, or an integer array together
    with ``device=``.

    ``sync_symbols``: optional ``[..., 2]`` sync-chirp symbol values that
    override ``params.sync_word`` (a frame resynthesized with the sync
    word a receiver recovered)."""
    from ..ops.chirp import _mod_chirps_planar, modulate_symbols_planar

    dev = device_of(symbols, device)
    symbols = torch.as_tensor(symbols, device=dev)
    step = params.step
    lead = symbols.shape[:-1]
    if sync_symbols is None:
        br, bi = modulate_symbols_planar(
            symbols, params.sf, params.osr, params.scale, amplitude,
            params.sync_word, params.continuous_chirp)
    else:
        sync_symbols = torch.as_tensor(sync_symbols, device=dev)
        allsyms = torch.cat([sync_symbols.to(torch.int32),
                             symbols.to(torch.int32)], dim=-1)
        ampl_c = float(np.clip(amplitude, -1.0, 1.0))
        re_c, im_c = _mod_chirps_planar(
            allsyms, params.n, params.osr, int(round(params.scale * 8)),
            ampl_c, params.continuous_chirp)
        br = re_c.reshape(*re_c.shape[:-2], -1)
        bi = im_c.reshape(*im_c.shape[:-2], -1)
    zeros = torch.zeros(*lead, preamble_len - 2, dtype=torch.int32, device=dev)
    pr, pi = modulate_symbols_planar(
        zeros, params.sf, params.osr, params.scale, amplitude, 0x00,
        params.continuous_chirp)
    down = device_table(_down_section, params.n, params.osr, params.scale,
                        float(amplitude), device=dev)
    out = []
    for body, pre, d in ((br, pr, down[0]), (bi, pi, down[1])):
        out.append(torch.cat(
            [pre[..., : preamble_len * step], body[..., : 2 * step],
             d.expand(*lead, d.shape[-1]), body[..., 2 * step:]], dim=-1))
    return tuple(out)


class PlanarStreamState(NamedTuple):
    """Stream carry of :class:`BatchStreamDemodulator`: the unconsumed
    tail planes (device tensors) and the absolute sample index of the
    tail's first sample."""

    tail_re: torch.Tensor
    tail_im: torch.Tensor
    consumed: int

    @classmethod
    def from_numpy(cls, tail_re, tail_im, consumed, device=None):
        """The carry from host arrays — e.g. the fields of the JAX
        package's ``PlanarStreamState`` — on ``device`` (default: the
        first CUDA card), so a stream resumes in the port."""
        dev = device_of(None, device)
        return cls(torch.tensor(np.asarray(tail_re, np.float32), device=dev),
                   torch.tensor(np.asarray(tail_im, np.float32), device=dev),
                   int(consumed))


class BatchStreamDemodulator:
    """Block-wise frame receiver: per block, the scan, candidate
    selection, window extraction, CFO derotation, dechirp and demod of up
    to ``max_frames`` frames run through :func:`.sync.receive_block_planar`
    on the device; the host reads the few per-frame fields it needs to
    report frames and place the carry. Feed blocks of any size."""

    def __init__(self, params: LoraParams, n_payload_symbols: int,
                 preamble_len: int = 8, max_frames: int = 8, device=None):
        self.params = params
        self.n_payload_symbols = n_payload_symbols
        self.preamble_len = preamble_len
        self.max_frames = max_frames
        self.device = device
        self.frame_len = (
            frame_overhead_samples(params, preamble_len)
            + n_payload_symbols * params.step
        )

    def init_state(self) -> PlanarStreamState:
        z = torch.zeros(0, dtype=torch.float32,
                        device=device_of(None, self.device))
        return PlanarStreamState(z, z, 0)

    def process(self, state: PlanarStreamState, block_re, block_im):
        """Returns ``(new_state, frames)``, ``frames`` a list of
        ``(abs_start, symbols [S] int32 tensor, sync, cfo_bins)``."""
        dev = state.tail_re.device
        buf_re = torch.cat([state.tail_re, torch.as_tensor(
            block_re, dtype=torch.float32, device=dev)])
        buf_im = torch.cat([state.tail_im, torch.as_tensor(
            block_im, dtype=torch.float32, device=dev)])
        base = state.consumed
        blk = sync.receive_block_planar(
            buf_re, buf_im, self.params, self.n_payload_symbols,
            self.max_frames, self.preamble_len,
        )
        found, starts, syncs, cfo_bins = (
            t.cpu().tolist() for t in (blk.found, blk.start, blk.sync,
                                       blk.cfo_bins))
        frames = []
        last_end = 0
        for k in np.flatnonzero(found):
            frames.append((base + starts[k], blk.symbols[k], syncs[k],
                           cfo_bins[k]))
            last_end = starts[k] + self.frame_len
        size = buf_re.shape[0]
        if all(found):
            # the block may hold more than max_frames: keep everything
            # after the last extracted frame for the next pass
            offset = last_end
        else:
            offset = max(last_end, size - self.frame_len - self.params.step)
        offset = max(0, min(offset, size))
        new_state = PlanarStreamState(buf_re[offset:], buf_im[offset:],
                                      base + offset)
        return new_state, frames
