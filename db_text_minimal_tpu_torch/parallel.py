"""Data parallelism over processes with ``torch.distributed``.

Counterpart of ``db_text_minimal_tpu/parallel/__init__.py``'s multi-host
half (``initialize_multihost``, ``local_batch_slice``; ``auto_data_mesh``'s
even split). The JAX trainer runs one program over a mesh of every host's
devices, with the batch split over the ``data`` axis: its batch norm, loss
and confusion counts are those of the GLOBAL batch (``hps.batch_size``),
and XLA inserts the collectives. Here each process runs one card, loads
``order[rank::world]`` of each epoch (``data.DataLoader``) and holds the
model in ``DistributedDataParallel``, which averages the gradients; the
global semantics come from two differentiable collectives:

- ``all_reduce_sum``: the batch norms' sums over every process's batch
  (``models.layers.BatchNorm2d`` when ``wrap_model`` gives it the group);
- ``gather_batch``: every process's maps, so the loss is the global
  batch's, the same on each process.

Each process's backward then gives ``world`` times its share of the global
gradient, and DDP's average their sum: the full-batch gradient. In a group
of one the process's batch is the global batch: the model is still in
DDP, but neither collective runs (on one H100 the per-layer sums tripled a
step's time at batch 4).

The JAX ``(data, model)`` mesh and ``spatial_sharding`` (GSPMD row sharding
with halos that XLA inserts) have no counterpart here (ROADMAP).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def initialize_distributed(coordinator_address: str | None,
                           num_processes: int | None,
                           process_id: int | None, device="cuda") -> None:
    """Join the process group at ``tcp://<coordinator_address>``: NCCL on
    CUDA (each process on card ``process_id`` modulo the cards it sees),
    gloo on the CPU. A no-op without an address, as in JAX."""
    if coordinator_address is None:
        return
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(
        backend="nccl" if device.type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_batch_slice(global_batch_size: int) -> int:
    """The batch of one process when ``hps.batch_size`` is the global
    batch: it must split evenly over the processes."""
    world = world_size()
    if global_batch_size % world:
        raise ValueError(f"the global batch {global_batch_size} does not "
                         f"split over {world} processes")
    return global_batch_size // world


class _AllReduceSum(torch.autograd.Function):
    """Sum over the processes; the gradient is summed likewise."""

    @staticmethod
    def forward(ctx, x):
        x = x.clone()
        dist.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


class _GatherBatch(torch.autograd.Function):
    """Every process's tensor, joined along dim 0 in rank order; the
    gradient of each process's part is summed over the processes."""

    @staticmethod
    def forward(ctx, x):
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, x.contiguous())
        ctx.rows = x.shape[0]
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        dist.all_reduce(grad)
        start = dist.get_rank() * ctx.rows
        return grad[start:start + ctx.rows]


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    return _AllReduceSum.apply(x)


def gather_batch(x: torch.Tensor) -> torch.Tensor:
    """The global batch of ``x`` (the same batch size on every process);
    differentiable when ``x`` requires grad."""
    if x.requires_grad:
        return _GatherBatch.apply(x)
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts)


def wrap_model(model: torch.nn.Module) -> torch.nn.Module:
    """``model`` in ``DistributedDataParallel``, its batch norms computing
    their statistics over every process's batch when there is more than
    one. The running statistics are then equal everywhere, so DDP
    broadcasts no buffers."""
    from .models.layers import BatchNorm2d

    if world_size() > 1:
        for module in model.modules():
            if isinstance(module, BatchNorm2d):
                module.process_group = dist.group.WORLD
    device = next(model.parameters()).device
    return torch.nn.parallel.DistributedDataParallel(
        model, device_ids=[device] if device.type == "cuda" else None,
        broadcast_buffers=False)
