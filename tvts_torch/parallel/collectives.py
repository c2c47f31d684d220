"""Differentiable collectives for the contrastive loss (counterpart of
tvts_tpu/parallel/collectives.py), over a process group: the mesh's data
group (parallel/mesh.py; the dp x fsdp ranks, which hold different rows;
tp ranks hold the same rows, and gathering them too would repeat rows in
the similarity matrix), or the default group where none is given.

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


def _group_size(group=None) -> int:
    """Size of `group` (None: the default group), 0 where none is started."""
    import torch.distributed as dist

    return dist.get_world_size(group) if dist.is_available() and dist.is_initialized() else 0


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, world: int, group) -> torch.Tensor:
        import torch.distributed as dist

        ctx.world, ctx.group = world, group
        out = x.new_empty((world * x.shape[0], *x.shape[1:]))
        dist.all_gather_into_tensor(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        import torch.distributed as dist

        out = g.new_empty((g.shape[0] // ctx.world, *g.shape[1:]))
        dist.reduce_scatter_tensor(out, g.contiguous(), op=dist.ReduceOp.SUM, group=ctx.group)
        return out, None, None


class _PMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, world: int, group) -> torch.Tensor:
        import torch.distributed as dist

        ctx.world, ctx.group = world, group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out / world

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        import torch.distributed as dist

        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g / ctx.world, None, None


def all_gather_embeddings(x: torch.Tensor, group=None) -> torch.Tensor:
    """[B_local, ...] -> [ranks * B_local, ...], the group's ranks in order."""
    world = _group_size(group)
    return _AllGather.apply(x, world, group) if world else x


def pmean(x: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of x over the group's ranks."""
    world = _group_size(group)
    return _PMean.apply(x, world, group) if world else x
