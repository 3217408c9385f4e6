"""Device meshes for multi-channel / streaming demodulation — the PyTorch
twin of ``lora_phy_tpu/parallel/mesh.py``.

The scale-out axes are the JAX twin's:

* ``channel`` — independent radio channels (embarrassingly parallel);
* ``time``    — consecutive blocks of one continuous stream, with
                overlap-save halo exchange between neighbouring shards.

A :class:`Mesh` is an ``[n_channel, n_time]`` grid of ``torch.device``s
inside one process, the counterpart of a ``jax.sharding.Mesh`` over local
devices. Shards may share a device (``[cuda:0] * 4`` runs four time
shards on one card, ``[cpu] * 8`` is the JAX suite's eight virtual CPU
devices). With ``torch.distributed`` initialised the grid spans the
processes: each process owns every channel row and a contiguous range of
time shards (``time_base`` onwards), and the halo and reductions at a
process seam go over the process group.

:func:`run_shards` is the counterpart of ``shard_map``: it runs ONE
per-shard body on every shard of the local grid. A body is a generator
that yields a collective (:func:`pmax`, :func:`ppermute`,
:func:`psum_first`) wherever the JAX body calls one and receives the
result; the runner advances every shard to its next collective, performs
it across the grid with plain tensor moves and reductions, and resumes
them. Shards launch on their own devices in turn, so on one card the
launches of a body are multiplied by the number of shards.
"""

from __future__ import annotations

import types
from typing import Any, NamedTuple

import numpy as np
import torch

CHANNEL_AXIS = "channel"
TIME_AXIS = "time"


class Mesh:
    """``devices``: the local ``[n_channel, n_time_local]`` grid (an object
    ndarray of ``torch.device``); ``n_time``: the global time-axis length;
    ``time_base``: the global index of the first local time shard;
    ``group``: the process group the grid spans (None in one process)."""

    def __init__(self, devices, n_time: int | None = None, time_base: int = 0,
                 group=None):
        self.devices = np.asarray(devices, dtype=object)
        if self.devices.ndim != 2:
            raise ValueError("mesh devices must be a 2-D [channel, time] grid")
        self.n_time = int(n_time if n_time is not None else self.devices.shape[1])
        self.time_base = int(time_base)
        self.group = group

    @property
    def shape(self) -> dict:
        """``{CHANNEL_AXIS: n_channel, TIME_AXIS: n_time}`` (global)."""
        return {CHANNEL_AXIS: self.devices.shape[0], TIME_AXIS: self.n_time}

    @property
    def local_time(self) -> int:
        return self.devices.shape[1]

    @property
    def home(self) -> torch.device:
        """The device results are assembled on: shard (0, 0)'s."""
        return self.devices[0, 0]

    def __repr__(self) -> str:
        return (f"Mesh({self.devices.shape[0]}x{self.n_time}, "
                f"time_base={self.time_base}, devices={self.devices.tolist()})")


def _visible_devices() -> list:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device (torch.cuda.is_available() is false) and no "
            "devices given: pass devices=[torch.device('cpu')] * k to build "
            "a mesh of CPU shards")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_channel: int | None = None, n_time: int | None = None,
              devices=None) -> Mesh:
    """Build a ``(channel, time)`` mesh over the available devices.

    Defaults: all devices on the channel axis (the common multi-channel
    receiver layout); pass ``n_time`` to carve a streaming axis.
    ``devices`` defaults to the visible CUDA cards; entries may repeat.

    With ``torch.distributed`` initialised, ``devices`` are this process's
    and the mesh spans ``world_size`` times as many: the global time axis
    is split into equal contiguous ranges, one per rank in rank order."""
    devices = list(devices if devices is not None else _visible_devices())
    devices = [torch.device(d) for d in devices]
    world, rank, group = 1, 0, None
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        world = torch.distributed.get_world_size()
        rank = torch.distributed.get_rank()
        group = torch.distributed.group.WORLD
    total = len(devices) * world
    if n_channel is None and n_time is None:
        n_channel, n_time = total, 1
    elif n_channel is None:
        n_channel = total // n_time
    elif n_time is None:
        n_time = total // n_channel
    if n_channel * n_time != total:
        raise ValueError(f"mesh {n_channel}x{n_time} != {total} devices")
    if n_time % world:
        raise ValueError(
            f"mesh time axis {n_time} does not split over {world} processes: "
            "each process owns a contiguous range of time shards")
    t_local = n_time // world
    grid = np.empty((n_channel, t_local), dtype=object)
    for i, d in enumerate(devices):
        grid[i // t_local, i % t_local] = d
    return Mesh(grid, n_time, rank * t_local, group)


# ---------------------------------------------------------------------------
# Shardings: [channels, ...] tensors as blocks on the grid
# ---------------------------------------------------------------------------

class Sharding(NamedTuple):
    """How a ``[channels, ...]`` tensor lies on ``mesh``: contiguous channel
    blocks, and with ``time`` contiguous blocks of the last axis along the
    time axis (else every time shard of a row holds the whole row)."""

    mesh: Mesh
    time: bool


def channel_sharding(mesh: Mesh) -> Sharding:
    """[channels, ...] tensors sharded along the channel axis."""
    return Sharding(mesh, False)


def stream_sharding(mesh: Mesh) -> Sharding:
    """[channels, samples] tensors sharded channel x time."""
    return Sharding(mesh, True)


class ShardedTensor(NamedTuple):
    """A tensor placed by :func:`device_put`: ``blocks[c][t]`` is the block
    of local shard (c, t), on that shard's device. In a multi-process mesh
    the blocks cover this process's time range only."""

    sharding: Sharding
    blocks: tuple


def _split(x: torch.Tensor, parts: int, dim: int, what: str) -> list:
    size = x.shape[dim]
    if size % parts:
        raise ValueError(f"{what} of {size} does not split into {parts} equal shards")
    return list(torch.split(x, size // parts, dim=dim))


def device_put(x, sharding: Sharding) -> ShardedTensor:
    """Place the GLOBAL tensor (or array) ``x`` on the mesh: each shard gets
    its block on its device. A block on its own device stays a view (no
    copy); an array goes to each device once."""
    mesh = sharding.mesh
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    rows = _split(x, mesh.devices.shape[0], 0, "channel axis")
    blocks = []
    for c, row in enumerate(rows):
        if sharding.time:
            cols = _split(row, mesh.n_time, -1, "time axis")
            cols = cols[mesh.time_base: mesh.time_base + mesh.local_time]
        else:
            cols = [row] * mesh.local_time
        blocks.append(tuple(b.to(mesh.devices[c, t]) for t, b in enumerate(cols)))
    return ShardedTensor(sharding, tuple(blocks))


def blocks_of(x, sharding: Sharding) -> tuple:
    """The block grid of ``x``: a :class:`ShardedTensor` on the same mesh
    as it is, anything else through :func:`device_put` (a global tensor)."""
    if isinstance(x, ShardedTensor):
        if x.sharding.mesh is not sharding.mesh or x.sharding.time != sharding.time:
            raise ValueError("input is sharded over another mesh or layout")
        return x.blocks
    return device_put(x, sharding).blocks


def join(grid, time_axis: int | None, device) -> torch.Tensor:
    """A result grid ``[c][t]`` of tensors as one tensor on ``device``:
    rows concatenated along ``time_axis`` (None: time-replicated, the
    first local shard's), then the rows along axis 0; a lone block is
    returned as it is."""
    rows = []
    for row in grid:
        if time_axis is None or len(row) == 1:
            rows.append(row[0].to(device))
        else:
            rows.append(torch.cat([b.to(device) for b in row], dim=time_axis))
    return rows[0] if len(rows) == 1 else torch.cat(rows, dim=0)


# ---------------------------------------------------------------------------
# The per-shard runner and its collectives
# ---------------------------------------------------------------------------

class Shard(NamedTuple):
    """What a per-shard body knows of its place (``axis_index`` /
    ``axis_size`` of the JAX body): the global time index and size."""

    t_idx: int
    t_size: int


class _Collective(NamedTuple):
    kind: str
    value: Any
    shift: int = 0


def pmax(x: torch.Tensor) -> _Collective:
    """``jax.lax.pmax(x, time_axis)``: the max over the time shards of a
    channel row (exact)."""
    return _Collective("pmax", x)


def ppermute(x: torch.Tensor, shift: int) -> _Collective:
    """The ring permute along the time axis with the edge shards masked:
    ``shift=-1`` delivers shard t+1's value to shard t (my head to my left
    neighbour), the last shard receiving zeros; ``shift=+1`` delivers
    shard t-1's, shard 0 receiving zeros. At one time shard nothing is
    sent."""
    if shift not in (-1, 1):
        raise ValueError("shift must be -1 or +1")
    return _Collective("ppermute", x, shift)


def psum_first(x: torch.Tensor) -> _Collective:
    """``psum(x * (t_idx == 0), time_axis)``: time shard 0's value on every
    shard of its row (the sum of one value and zeros, taken as the value)."""
    return _Collective("psum_first", x)


def _comm_device(mesh: Mesh) -> torch.device:
    """Where tensors cross the process group: the card under NCCL, host
    memory under gloo (which moves CPU tensors only)."""
    if torch.distributed.get_backend(mesh.group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _all_reduce(mesh: Mesh, rows: list, op) -> list:
    """``rows`` (one tensor per channel row) reduced with ``op`` across the
    processes; the result of each row on its input's device."""
    cdev = _comm_device(mesh)
    buf = torch.stack([r.to(cdev) for r in rows])
    torch.distributed.all_reduce(buf, op=op, group=mesh.group)
    return [b.to(r.device) for b, r in zip(buf, rows)]


def _do_pmax(mesh, vals, shift):
    rows = []
    for row in vals:
        acc = row[0]
        for v in row[1:]:
            acc = torch.maximum(acc, v.to(acc.device))
        rows.append(acc)
    if mesh.group is not None:
        rows = _all_reduce(mesh, rows, torch.distributed.ReduceOp.MAX)
    return [[r.to(mesh.devices[c, t]) for t in range(mesh.local_time)]
            for c, r in enumerate(rows)]


def _do_psum_first(mesh, vals, shift):
    rows = [row[0] for row in vals]
    if mesh.group is not None:
        if mesh.time_base != 0:
            rows = [torch.zeros_like(r) for r in rows]
        rows = _all_reduce(mesh, rows, torch.distributed.ReduceOp.SUM)
    return [[r.to(mesh.devices[c, t]) for t in range(mesh.local_time)]
            for c, r in enumerate(rows)]


def _do_ppermute(mesh, vals, shift):
    n_loc = mesh.local_time
    out = [[None] * n_loc for _ in vals]
    for c, row in enumerate(vals):
        for t in range(n_loc):
            src = t - shift                         # local index of the sender
            g_src = mesh.time_base + src
            dev = mesh.devices[c, t]
            if 0 <= src < n_loc:
                out[c][t] = row[src].to(dev)
            elif not 0 <= g_src < mesh.n_time:      # past a global edge
                out[c][t] = torch.zeros_like(row[t])
    if mesh.group is not None:
        _seam_exchange(mesh, vals, out, shift)
    return out


def _seam_exchange(mesh, vals, out, shift):
    """The ppermute's values that cross a process seam, over the group in
    one ``batch_isend_irecv``: all channel rows in one message each way."""
    dist = torch.distributed
    rank, world = dist.get_rank(mesh.group), dist.get_world_size(mesh.group)
    n_loc = mesh.local_time
    cdev = _comm_device(mesh)
    # shift -1: my first shard's value goes to rank-1's last shard;
    # shift +1: my last shard's value goes to rank+1's first shard
    send_t, recv_t, to, frm = ((0, n_loc - 1, rank - 1, rank + 1) if shift == -1
                               else (n_loc - 1, 0, rank + 1, rank - 1))
    ops, buf = [], None
    if 0 <= to < world:
        msg = torch.stack([row[send_t].to(cdev) for row in vals]).contiguous()
        ops.append(dist.P2POp(dist.isend, msg, to, mesh.group))
    if 0 <= frm < world:
        buf = torch.empty((len(vals),) + tuple(vals[0][recv_t].shape),
                          dtype=vals[0][recv_t].dtype, device=cdev)
        ops.append(dist.P2POp(dist.irecv, buf, frm, mesh.group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if buf is not None:
        for c in range(len(vals)):
            out[c][recv_t] = buf[c].to(mesh.devices[c, recv_t])


_COLLECTIVES = {"pmax": _do_pmax, "psum_first": _do_psum_first, "ppermute": _do_ppermute}


def run_shards(mesh: Mesh, body, *grids, **kwargs):
    """Run ``body(shard, *blocks, **kwargs)`` on every local shard (the
    ``shard_map`` counterpart). ``grids`` are block grids (``[c][t]``, see
    :func:`blocks_of`). A generator body yields collectives and receives
    their results; every shard must yield the same collective at the same
    step. Returns the grid of the bodies' return values."""
    n_c, n_loc = mesh.devices.shape
    keys = [(c, t) for c in range(n_c) for t in range(n_loc)]
    gens, results = {}, {}
    for c, t in keys:
        shard = Shard(mesh.time_base + t, mesh.n_time)
        out = body(shard, *(g[c][t] for g in grids), **kwargs)
        if isinstance(out, types.GeneratorType):
            gens[(c, t)] = out
        else:
            results[(c, t)] = out
    sent = {k: None for k in gens}
    while gens:
        reqs = {}
        for k, gen in list(gens.items()):
            try:
                reqs[k] = gen.send(sent[k])
            except StopIteration as stop:
                results[k] = stop.value
                del gens[k]
        if not reqs:
            break
        if len(reqs) != len(keys) or len({(r.kind, r.shift) for r in reqs.values()}) != 1:
            raise RuntimeError("shards disagree on the next collective")
        first = next(iter(reqs.values()))
        vals = [[reqs[(c, t)].value for t in range(n_loc)] for c in range(n_c)]
        got = _COLLECTIVES[first.kind](mesh, vals, first.shift)
        sent = {(c, t): got[c][t] for c, t in keys}
    return [[results[(c, t)] for t in range(n_loc)] for c in range(n_c)]
