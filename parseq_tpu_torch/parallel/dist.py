"""The port's process group (counterpart of parseq_tpu/parallel/mesh.py).

Data parallelism is the reference's only way to distribute (DDP,
SURVEY.md §2.5). The JAX package runs it as one SPMD program over a
('data',) mesh; the port runs one process a rank, joined by
torch.distributed:

- each rank's device is `cuda:LOCAL_RANK % device_count`, or the CPU;
- the backend is NCCL when every rank of a host has a card of its own, and
  gloo when ranks share a card (NCCL refuses two ranks on one device) and
  on the CPU. It is chosen once and logged; one that fails to start raises,
  and a rank never drops to the CPU;
- `replicate`'s counterpart is `broadcast_module` (rank 0's parameters and
  buffers at the start), `global_batch`'s each rank loading its own rows of
  the global batch (data/loader.py:shard_positions).

Without a process group every function here acts as the only rank.
"""

from __future__ import annotations

import logging
import os
import socket

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

TORCHRUN_ENV = ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR', 'MASTER_PORT')


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def is_main() -> bool:
    return rank() == 0


def backend(device_type: str, local_world_size: int, device_count: int) -> str:
    """'nccl' when each of a host's ranks has a card of its own, else 'gloo'."""
    if device_type == 'cuda' and local_world_size <= device_count:
        return 'nccl'
    return 'gloo'


def rank_device(device_type: str, local_rank: int) -> torch.device:
    if device_type == 'cpu':
        return torch.device('cpu')
    if device_type != 'cuda':
        raise ValueError(f'device type {device_type!r}: cuda or cpu')
    if not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: pass --device cpu to train on the CPU')
    return torch.device('cuda', local_rank % torch.cuda.device_count())


def init(rank: int, world_size: int, local_rank: int, local_world_size: int, addr: str,
         port: int | str, device_type: str = 'cuda') -> torch.device:
    """Join the process group as `rank` of `world_size`; returns this rank's device."""
    device = rank_device(device_type, local_rank)
    count = torch.cuda.device_count() if device.type == 'cuda' else 0
    name = backend(device.type, local_world_size, count)
    if device.type == 'cuda':
        torch.cuda.set_device(device)
    dist.init_process_group(name, init_method=f'tcp://{addr}:{port}', rank=rank,
                            world_size=world_size)
    log.info(f'rank {rank} of {world_size}: backend {name} on {device} '
             f'({local_world_size} ranks on this host, {count} cards)')
    return device


def init_from_env(device_type: str = 'cuda') -> torch.device:
    """Join the process group torchrun describes in the environment (RANK,
    WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT), as
    jax.distributed.initialize() reads its own."""
    missing = [k for k in TORCHRUN_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f'trainer.multihost needs torchrun\'s environment; missing {missing}')
    env = os.environ
    return init(int(env['RANK']), int(env['WORLD_SIZE']), int(env['LOCAL_RANK']),
                int(env.get('LOCAL_WORLD_SIZE', env['WORLD_SIZE'])), env['MASTER_ADDR'],
                env['MASTER_PORT'], device_type)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def launch(fn, n: int, args=(), device_type: str = 'cuda'):
    """fn(device, *args) on `n` ranks of this host: spawned processes joined
    on 127.0.0.1 at a free port. Raises when a rank fails."""
    level = logging.getLogger().getEffectiveLevel()
    torch.multiprocessing.spawn(_rank_main, args=(n, free_port(), device_type, fn, args, level),
                                nprocs=n, join=True)


def _rank_main(rank, n, port, device_type, fn, args, level):
    logging.basicConfig(level=level)  # a spawned process logs as its parent does
    device = init(rank, n, rank, n, '127.0.0.1', port, device_type)
    try:
        fn(device, *args)
    finally:
        dist.destroy_process_group()


def all_reduce_(tensor):
    """Sum `tensor` over the ranks, in place; returns it."""
    if world_size() > 1:
        dist.all_reduce(tensor)
    return tensor


def all_reduce_flat_(tensors):
    """Sum each tensor of the list over the ranks, in place, through one
    all-reduce over a flat buffer of the first tensor's dtype (the
    counterpart of XLA's psum of a gradient tree)."""
    if world_size() == 1 or not tensors:
        return tensors
    flat = torch.cat([t.reshape(-1).to(tensors[0].dtype) for t in tensors])
    dist.all_reduce(flat)
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))
    return tensors


class _SumOverRanks(torch.autograd.Function):
    """All-reduce sum whose backward all-reduces the incoming gradient: each
    rank's input reaches every rank's output."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def sum_over_ranks(x):
    """Differentiable sum of `x` over the ranks (batch-norm statistics)."""
    return _SumOverRanks.apply(x) if world_size() > 1 else x


@torch.no_grad()
def broadcast_module(module):
    """Rank 0's parameters and buffers into every rank's `module`."""
    if world_size() > 1:
        for t in [*module.parameters(), *module.buffers()]:
            dist.broadcast(t.data, 0)


def broadcast_object(obj):
    """Rank 0's picklable `obj` on every rank (tensors in it: on the CPU)."""
    if world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]
