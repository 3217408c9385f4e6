"""Multi-process scale-out — the PyTorch twin of
``lora_phy_tpu/parallel/multihost.py``.

Every process runs the same program; :func:`initialize` joins them into
one ``torch.distributed`` process group, :func:`.mesh.make_mesh` then
builds the global ``(channel, time)`` grid in which each process owns
every channel row and a contiguous range of time shards, and
:func:`global_stream_array` places each process's local time block on its
shards. The streaming bodies (:mod:`.stream`) run unchanged: the halo at
a process seam goes over the group (``batch_isend_irecv``), the amplitude
pmax and the estimate's broadcast become ``all_reduce`` after the local
reduction. gloo moves CPU tensors only, so under gloo those crossings go
through host memory; under NCCL they stay on the card (NCCL refuses two
ranks on one GPU).
"""

from __future__ import annotations

import numpy as np
import torch

from .mesh import Mesh, ShardedTensor, stream_sharding


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str | None = None) -> None:
    """Join the multi-process group (a no-op for one process).
    ``coordinator_address`` is ``host:port`` (or ``tcp://host:port``) of
    rank 0; ``backend`` defaults to NCCL with a card, gloo without."""
    if num_processes is None or num_processes <= 1:
        return
    addr = coordinator_address
    if "://" not in addr:
        addr = f"tcp://{addr}"
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    torch.distributed.init_process_group(backend, init_method=addr,
                                         world_size=num_processes,
                                         rank=process_id)


def global_stream_array(mesh: Mesh, local_block) -> ShardedTensor:
    """This process's part of the global ``[channels, T]`` stream from its
    local time block ``[channels, T / n_processes]`` (processes ingest
    consecutive stream segments): channel blocks x its local time shards,
    each on its shard's device."""
    if not isinstance(local_block, torch.Tensor):
        local_block = torch.from_numpy(np.ascontiguousarray(local_block))
    n_c, n_loc = mesh.devices.shape
    if local_block.shape[0] % n_c or local_block.shape[-1] % n_loc:
        raise ValueError(f"local block {tuple(local_block.shape)} does not split "
                         f"into {n_c} x {n_loc} equal shards")
    rows = torch.split(local_block, local_block.shape[0] // n_c, dim=0)
    blocks = tuple(
        tuple(b.to(mesh.devices[c, t]) for t, b in enumerate(
            torch.split(row, row.shape[-1] // n_loc, dim=-1)))
        for c, row in enumerate(rows))
    return ShardedTensor(stream_sharding(mesh), blocks)


def process_allgather(x: torch.Tensor, mesh: Mesh, dim: int = -1) -> torch.Tensor:
    """A time-sharded result's process-local part joined with every other
    process's along ``dim`` (rank order = time order): the global result,
    on every process. The identity in one process."""
    if mesh.group is None:
        return x
    dist = torch.distributed
    cdev = (torch.device("cuda", torch.cuda.current_device())
            if dist.get_backend(mesh.group) == "nccl" else torch.device("cpu"))
    y = x.to(cdev, torch.uint8 if x.dtype == torch.bool else x.dtype).contiguous()
    parts = [torch.empty_like(y) for _ in range(dist.get_world_size(mesh.group))]
    dist.all_gather(parts, y, group=mesh.group)
    return torch.cat(parts, dim=dim).to(x.device, x.dtype)


def scaling_report(samples_per_s_1chip: float, samples_per_s_n: float,
                   n_devices: int) -> dict:
    """Scaling-efficiency record (north-star metric: >= 90%)."""
    ideal = samples_per_s_1chip * n_devices
    return {
        "devices": n_devices,
        "samples_per_s": samples_per_s_n,
        "ideal_samples_per_s": ideal,
        "efficiency": samples_per_s_n / ideal if ideal else 0.0,
    }
