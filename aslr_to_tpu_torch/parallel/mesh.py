"""The process group of a run over several devices, and its one-axis mesh.

PyTorch counterpart of ``aslr_to_tpu/parallel/mesh.py``. JAX runs one
process a host and spreads a mesh over that host's devices; the port runs
one process a device, joined by ``torch.distributed``: NCCL between cards,
Gloo on the CPU and where ranks share a card. :func:`distributed_init`
starts the group (a no-op for one process, as in JAX), and
:func:`make_batch_mesh` stands for JAX's one-axis mesh over the scenario
batch: this process's rank, the group's size, the rank's device, the
backend, and the device that the collectives' tensors live on.

JAX's ``batch_sharding`` and ``replicated_sharding`` have no counterpart
of their own: every rank holds the replicated tensors whole, and takes its
rows of a ``[B, ...]`` tensor with :meth:`BatchMesh.shard`.

The processes come from ``torchrun --nproc-per-node=N`` or from
:mod:`.launch`. Both give each one ``RANK``, ``LOCAL_RANK``,
``WORLD_SIZE``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``,
which :func:`distributed_init` reads for the arguments it is not given.
"""
from __future__ import annotations

import dataclasses
import os
import sys
from typing import ClassVar, Optional

import torch
import torch.distributed as dist

BATCH_AXIS = "batch"

# the device that distributed_init gave this process (the group itself is
# torch.distributed's, process-wide)
_rank_device: dict = {}


@dataclasses.dataclass(frozen=True)
class BatchMesh:
    """One axis of ``size`` ranks over the scenario batch, seen from rank
    ``rank``. ``device`` is where this rank solves (None on the one-rank
    mesh outside a group: the problem's own device); ``collective_device``
    is where the tensors of its collectives live (the card under NCCL, the
    CPU under Gloo; None without a group)."""

    rank: int
    size: int
    device: Optional[torch.device]
    backend: Optional[str]
    collective_device: Optional[torch.device]
    axis: ClassVar[str] = BATCH_AXIS

    def rows(self, batch: int) -> slice:
        """This rank's contiguous rows of a batch of ``batch`` scenarios:
        ``batch / size`` of them, from ``batch / size * rank``. A batch
        that the ranks do not divide raises, as JAX's sharding does."""
        if batch % self.size:
            raise ValueError(f"a batch of {batch} scenarios does not split into {self.size} "
                             f"equal shards")
        per = batch // self.size
        return slice(per * self.rank, per * (self.rank + 1))

    def shard(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of ``t [B, ...]``."""
        return t[self.rows(t.shape[0])]

    def barrier(self):
        """Wait for every rank of the group (nothing on one rank)."""
        if self.size > 1:
            if self.backend == "nccl":
                dist.barrier(device_ids=[self.device.index])
            else:
                dist.barrier()


def _env_int(name: str, default=None) -> int:
    value = os.environ.get(name)
    if value is None:
        if default is None:
            raise ValueError(f"distributed_init: {name} is neither given nor in the "
                             f"environment (start the ranks with torchrun or "
                             f"aslr_to_tpu_torch.parallel.launch)")
        return default
    return int(value)


def distributed_init(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device=None,
                     backend: Optional[str] = None) -> BatchMesh:
    """Join this process to a group of ``num_processes`` (default
    ``WORLD_SIZE``) as rank ``process_id`` (default ``RANK``) through the
    coordinator ``host:port`` (default ``MASTER_ADDR:MASTER_PORT``), and
    return :func:`make_batch_mesh`'s mesh. A no-op for one process.

    The rank's device is ``device``, else its own card: ``cuda:LOCAL_RANK``
    modulo the host's cards (``LOCAL_RANK`` defaults to the rank). It is
    made the current CUDA device here, before anything launches a kernel:
    the kernel library serves the device current at its first launch
    (``kernels/build.py::lib``). No card and no ``device`` raises.

    The backend is ``backend`` where the caller names it. Otherwise NCCL
    when the rank is on a card and the host's ranks (``LOCAL_WORLD_SIZE``,
    default every rank) are no more than its cards, so that each rank has a
    card of its own; else Gloo (ranks on the CPU, or ranks that share a
    card, which NCCL refuses). The choice and its reason are printed to
    standard error."""
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE", 1)
    if num_processes <= 1:
        return make_batch_mesh()
    if process_id is None:
        process_id = _env_int("RANK")
    if coordinator_address is None:
        addr = os.environ.get("MASTER_ADDR")
        if addr is None:
            raise ValueError("distributed_init: no coordinator_address, and MASTER_ADDR is not "
                             "in the environment")
        coordinator_address = f"{addr}:{_env_int('MASTER_PORT')}"
    local_rank = _env_int("LOCAL_RANK", process_id)
    local_size = _env_int("LOCAL_WORLD_SIZE", num_processes)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if device is None:
        if not cards:
            raise RuntimeError("distributed_init found no CUDA device: pass device='cpu' to "
                               "run the ranks on the CPU")
        device = torch.device("cuda", local_rank % cards)
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(device)
    if backend is not None:
        why = "named by the caller"
    elif device.type != "cuda":
        backend, why = "gloo", f"the ranks run on the {device.type}"
    elif local_size <= cards:
        backend, why = "nccl", f"{local_size} ranks on this host's {cards} card(s), a card each"
    else:
        backend, why = "gloo", f"{local_size} ranks share this host's {cards} card(s)"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    _rank_device["device"] = device
    print(f"distributed_init: rank {process_id} of {num_processes} on {device}, backend "
          f"{backend}: {why}", file=sys.stderr, flush=True)
    return make_batch_mesh()


def make_batch_mesh(n_devices: Optional[int] = None) -> BatchMesh:
    """The one-axis mesh over the scenario batch: in an initialized group,
    every rank of it (``n_devices``, where given, must be the group's
    size); outside a group, one rank, this process, solving the whole
    batch on the problem's device (as a one-device JAX mesh does). A mesh
    of several devices in one process has no counterpart: start a process
    a device. JAX's ``axis`` argument has no counterpart: the one axis is
    ``BATCH_AXIS``."""
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(f"make_batch_mesh({n_devices}) outside a process group: start a "
                             f"process a device (torchrun or aslr_to_tpu_torch.parallel.launch) "
                             f"and call distributed_init in each")
        return BatchMesh(0, 1, None, None, None)
    size = dist.get_world_size()
    if n_devices not in (None, size):
        raise ValueError(f"make_batch_mesh({n_devices}) in a group of {size} ranks")
    device = _rank_device.get("device")
    if device is None:
        raise RuntimeError("the process group was not started by distributed_init, so this "
                           "rank's device is not known")
    backend = dist.get_backend()
    return BatchMesh(dist.get_rank(), size, device, backend,
                     device if backend == "nccl" else torch.device("cpu"))
