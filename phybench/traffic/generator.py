"""The benchmark's one traffic generator: it reads a traffic mix (a JSON
file of parameters beside this module) and the cell's configuration, and
makes the pool of distinct inputs that a run cycles through, on the
device, from the seed. It uses the benchmark's own modulator and coding
(:mod:`phybench.reference.chirp`, :mod:`phybench.reference.coding`) and
nothing of the program.

Two layouts:

``channel_blocks``  ``channels`` independent channels of one block of
    ``block_samples`` samples each; in every channel-block
    ``frames_per_block`` whole frames at random, non-overlapping starts
    (at least ``gap_windows`` symbol windows apart and ``edge_windows``
    from either end), each with its own payload, SNR, CFO and carrier
    phase, over AWGN at one floor. A frame is ``preamble_len`` up-chirps,
    the two sync-word chirps, 2.25 down-chirps, then the payload chirps.
``aligned_frames``  a ``batch`` of frame-aligned captures: the two
    sync-word chirps then the payload chirps, each frame with its own
    payload, SNR, CFO and carrier phase, over AWGN.

A frame at SNR ``s`` (dB, per sample) has amplitude
``full_scale_peak * 10**((s - snr_db[1]) / 20)``, so the loudest frame
peaks at ``full_scale_peak`` and the noise power is that of the loudest
frame less ``snr_db[1]`` dB.

The seed fixes everything: the per-frame draws come from a NumPy PCG64
generator and the noise from a ``torch.Generator`` on the device, both
seeded from it. Every seed gives the same shapes, frame counts and SNR
range; only the values move.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..reference import chirp, coding


@dataclasses.dataclass
class PoolItem:
    """One input of the pool: planes on the device and what was sent."""

    xr: torch.Tensor          # [..., T] float32
    xi: torch.Tensor
    payloads: np.ndarray      # [..., B] uint8 (frames in the layout's order)
    starts: np.ndarray | None # [C, F] frame starts (channel_blocks)


def sync_symbols(sf: int, sync_word: int) -> tuple[int, int]:
    """The two sync-word chirp symbols: each nibble shifted to the top of
    the symbol."""
    shift = max(sf - 4, 0)
    return ((sync_word >> 4) & 0xF) << shift, (sync_word & 0xF) << shift


def frame_phase(symbols: np.ndarray, config: dict, device) -> torch.Tensor:
    """[F, L] float64 chirp phases of frames carrying ``symbols`` [F, S]:
    the preamble (``preamble_len`` > 0 only), the sync pair, the 2.25
    down-chirps (with a preamble), the payload."""
    n = 1 << config["sf"]
    f = symbols.shape[0]
    table = torch.as_tensor(chirp.up_phase_table(n), device=device)
    sw = np.array(sync_symbols(config["sf"], config["sync_word"]))
    body = np.concatenate([np.broadcast_to(sw, (f, 2)), symbols], axis=-1) % n
    body_idx = torch.as_tensor(body, device=device)
    carry = torch.arange(body.shape[1], device=device, dtype=torch.float64) * math.pi
    body_ph = (table[body_idx] + carry[:, None]).reshape(f, -1)     # [F, (S+2) N]
    pre = config.get("preamble_len", 0)
    if not pre:
        return body_ph
    pre_ph = (table[0][None, :] + math.pi * torch.arange(pre, device=device,
                                                           dtype=torch.float64)[:, None])
    down = torch.as_tensor(chirp.down_phase(n, 2 * n + n // 4), device=device)
    return torch.cat([pre_ph.reshape(1, -1).expand(f, -1), body_ph[:, : 2 * n],
                      down.expand(f, -1), body_ph[:, 2 * n:]], dim=-1)


def _payload_symbols(config: dict, payloads: np.ndarray) -> np.ndarray:
    if config["coding"] == "simple":
        return coding.encode_simple(payloads)
    return coding.encode_coded(payloads, config["sf"], config["cr"])


def _modulate(config, payloads, snr, cfo, theta, amp_peak, snr_hi, device, chunk=8192):
    """[F, L] complex frames as two float32 planes, in chunks of frames."""
    n = 1 << config["sf"]
    syms = _payload_symbols(config, payloads)
    out_r, out_i = [], []
    for a in range(0, syms.shape[0], chunk):
        sl = slice(a, a + chunk)
        ph = frame_phase(syms[sl], config, device)
        t = torch.arange(ph.shape[1], device=device, dtype=torch.float64)
        cf = torch.as_tensor(cfo[sl], device=device)[:, None]
        ph = ph + (2.0 * math.pi / n) * cf * t + torch.as_tensor(theta[sl], device=device)[:, None]
        amp = torch.as_tensor(amp_peak * 10.0 ** ((snr[sl] - snr_hi) / 20.0), device=device)[:, None]
        out_r.append((amp * torch.cos(ph)).to(torch.float32))
        out_i.append((amp * torch.sin(ph)).to(torch.float32))
        del ph, t
    return torch.cat(out_r), torch.cat(out_i)


def frame_samples(config: dict) -> int:
    n = 1 << config["sf"]
    pre = config.get("preamble_len", 0)
    overhead = (pre + 2) * n + (2 * n + n // 4 if pre else 0)
    return overhead + payload_symbol_count(config) * n


def call_size(config: dict, traffic: dict) -> tuple[int, int]:
    """(samples a plane, frames sent) in one pool item: one call's input."""
    if traffic["layout"] == "channel_blocks":
        return (traffic["channels"] * config["block_samples"],
                traffic["channels"] * traffic["frames_per_block"])
    frames = int(np.prod(traffic["batch"]))
    return frames * frame_samples(config), frames


def payload_symbol_count(config: dict) -> int:
    if config["coding"] == "simple":
        return 2 * config["payload_bytes"]
    return coding.coded_symbol_count(config["payload_bytes"], config["sf"], config["cr"])


def _noise_sigma(traffic):
    """Per-component noise standard deviation."""
    return traffic["full_scale_peak"] * 10.0 ** (-traffic["snr_db"][1] / 20.0) / math.sqrt(2.0)


def _channel_blocks(config, traffic, rng, gen, device) -> PoolItem:
    n = 1 << config["sf"]
    c, t_len = traffic["channels"], config["block_samples"]
    f = traffic["frames_per_block"]
    length = frame_samples(config)
    gap, edge = traffic["gap_windows"] * n, traffic["edge_windows"] * n
    slack = t_len - 2 * edge - f * length - (f - 1) * gap
    if slack < 0:
        raise ValueError("frames_per_block frames do not fit the block")
    # non-overlapping starts: sorted uniform draws of the slack
    offs = np.sort(rng.integers(0, slack + 1, size=(c, f)), axis=-1)
    starts = edge + offs + np.arange(f) * (length + gap)
    count = c * f
    payloads = rng.integers(0, 256, size=(count, config["payload_bytes"]), dtype=np.uint8)
    snr = rng.uniform(*traffic["snr_db"], size=count)
    cfo = rng.uniform(*traffic["cfo_bins"], size=count)
    theta = rng.uniform(0.0, 2.0 * math.pi, size=count)
    fr, fi = _modulate(config, payloads, snr, cfo, theta, traffic["full_scale_peak"],
                       traffic["snr_db"][1], device)
    sigma = _noise_sigma(traffic)
    xr = torch.randn(c, t_len, generator=gen, device=device).mul_(sigma)
    xi = torch.randn(c, t_len, generator=gen, device=device).mul_(sigma)
    base = (torch.arange(c, device=device)[:, None] * t_len
            + torch.as_tensor(starts, device=device)).reshape(-1, 1)
    idx = (base + torch.arange(length, device=device)).reshape(-1)
    xr.view(-1).index_add_(0, idx, fr.reshape(-1))
    xi.view(-1).index_add_(0, idx, fi.reshape(-1))
    return PoolItem(xr, xi, payloads.reshape(c, f, -1), starts)


def _aligned_frames(config, traffic, rng, gen, device) -> PoolItem:
    shape = tuple(traffic["batch"])
    count = int(np.prod(shape))
    payloads = rng.integers(0, 256, size=(count, config["payload_bytes"]), dtype=np.uint8)
    snr = rng.uniform(*traffic["snr_db"], size=count)
    cfo = rng.uniform(*traffic["cfo_bins"], size=count)
    theta = rng.uniform(0.0, 2.0 * math.pi, size=count)
    xr, xi = _modulate(config, payloads, snr, cfo, theta, traffic["full_scale_peak"],
                       traffic["snr_db"][1], device)
    sigma = _noise_sigma(traffic)
    xr.add_(torch.randn(xr.shape, generator=gen, device=device), alpha=sigma)
    xi.add_(torch.randn(xi.shape, generator=gen, device=device), alpha=sigma)
    length = xr.shape[-1]
    return PoolItem(xr.reshape(*shape, length), xi.reshape(*shape, length),
                    payloads.reshape(*shape, -1), None)


LAYOUTS = {"channel_blocks": _channel_blocks, "aligned_frames": _aligned_frames}


def make_pool(config: dict, traffic: dict, seed: int, device) -> list[PoolItem]:
    """The ``traffic["pool"]`` distinct inputs of a run, from ``seed``."""
    rng = np.random.Generator(np.random.PCG64(seed % 2 ** 63))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(0, 2 ** 62)))
    layout = LAYOUTS[traffic["layout"]]
    return [layout(config, traffic, rng, gen, device) for _ in range(traffic["pool"])]
