"""Differentiable collectives for the contrastive loss (counterpart of
tvts_tpu/parallel/collectives.py), over torch.distributed's default group.

They carry the JAX package's transposes, not the reference's:
- `all_gather_embeddings`: forward all_gather + concat along the batch axis
  (rank order); backward reduce_scatter with SUM of the cotangent, which is
  `jax.lax.all_gather`'s transpose (`psum_scatter`). Every rank's loss is the
  whole loss, so each rank's local embeddings get world x their gradient;
- `pmean`: forward all_reduce / world; backward the cotangent summed over
  ranks / world.
With train/step.py's SUM all-reduce of the parameter gradients, a step's
gradient is world x the gradient of the same loss on the whole batch in one
process, as the JAX package's sharded step computes it. The reference's
AllGather_multi keeps only the local slice in its backward and DDP averages,
which gives the contrastive term at 1/world and the sort term at 1x of that
gradient (ROADMAP.md §3).
Without a process group both are the identity.
"""

from __future__ import annotations

import torch


def _group_size() -> int:
    """World size of the default group, 0 where none is started."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 0


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, world: int) -> torch.Tensor:
        import torch.distributed as dist

        ctx.world = world
        out = x.new_empty((world * x.shape[0], *x.shape[1:]))
        dist.all_gather_into_tensor(out, x.contiguous())
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        import torch.distributed as dist

        out = g.new_empty((g.shape[0] // ctx.world, *g.shape[1:]))
        dist.reduce_scatter_tensor(out, g.contiguous(), op=dist.ReduceOp.SUM)
        return out, None


class _PMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, world: int) -> torch.Tensor:
        import torch.distributed as dist

        ctx.world = world
        out = x.clone()
        dist.all_reduce(out)
        return out / world

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        import torch.distributed as dist

        g = g.clone()
        dist.all_reduce(g)
        return g / ctx.world, None


def all_gather_embeddings(x: torch.Tensor) -> torch.Tensor:
    """[B_local, ...] -> [world * B_local, ...], ranks in order."""
    world = _group_size()
    return _AllGather.apply(x, world) if world else x


def pmean(x: torch.Tensor) -> torch.Tensor:
    """The mean of x over the ranks."""
    world = _group_size()
    return _PMean.apply(x, world) if world else x
