"""Sequence parallelism over the video tokens (counterpart of the JAX
`token_partition`, tvts_tpu/models/space_time_vit.py:161-170): the tower's
token activations [B, S, D] (S = 1 + T * n_keep, CLS first) split over the
mesh's sp group, DeepSpeed-Ulysses style.

The JAX package constrains the activations to P(("dp", "fsdp"), "sp", None)
after `ln_pre` and after every block and lets GSPMD reshard around the
divided-attention einsums. Here the resharding is explicit:
- `TokenShard.split`: after the stem (which runs whole on every rank), each
  sp rank keeps its own contiguous slice of L = ceil(S / sp) rows of S,
  padded with zero rows to sp * L. LayerNorms, qkv, proj, LayerScale and the
  MLP are token-local and run on the slice; the pad rows never meet a real
  one;
- `TokenShard.to_heads` / `to_tokens`, around the attention core
  (models/layers.py `var_attention`): an all-to-all turns the qkv product's
  sequence slices into head slices, so the core sees the whole S for H / sp
  of the rank's heads (H: its heads under tp), the pad rows stripped; the
  core's output goes back by the opposite all-to-all before `proj`. Each
  all-to-all's backward is the opposite one. The divided space and time
  cores, the global CLS row and the H9 kernel run head by head as in one
  process. Where sp does not divide the heads, the module instead
  all-gathers the qkv product's tokens over sp (backward: the sum over sp,
  reduce-scattered), runs the core on all of its heads and keeps its own
  rows of the output: the same numbers;
- `TokenShard.gather`: after the last block, the tokens all-gathered whole
  for `pool` (ln_post, proj, the sort head's order tokens). Its backward
  keeps this rank's slice of the gradient, which every sp rank computes
  alike.

So each sp rank back-propagates through its own tokens only: a parameter
used between the split and the gather (the stem, every block) ends the
backward with a partial gradient, summed over the sp group by the train
step (train/step.py); one used outside that window (the text tower, the
sort head, ln_post, proj) gets the same whole gradient on every sp rank and
is not summed. The kernel paths (ops/fused_forward.py) keep the tokens whole
on every sp rank, as the JAX kernel paths do ("sp does not cross kernels",
__graft_entry__.py:140): their gradients are whole and take no sp sum.

A tower splits its tokens where it carries the partition and a mesh with a
started process group is active (parallel/mesh.active_mesh), whatever the
sp group's size, 1 included; else it runs whole, as one process.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from tvts_torch.parallel.mesh import active_mesh

TOKEN_PARTITION = (("dp", "fsdp"), "sp", None)  # the JAX spec, the only one taken


def check_partition(partition) -> tuple | None:
    """None, or the JAX spec (("dp", "fsdp"), "sp", None); any other raises."""
    if partition is None:
        return None
    spec = tuple(tuple(a) if isinstance(a, list) else a for a in partition)
    if spec != TOKEN_PARTITION:
        raise ValueError(f"token_partition {partition!r}: only None or the JAX spec "
                         f"{TOKEN_PARTITION!r} (the batch over the data axes, the tokens "
                         "over sp) is taken")
    return TOKEN_PARTITION


def _all_gather(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """[size, *x.shape]: every rank's x."""
    import torch.distributed as dist

    out = x.new_empty((size * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out.unflatten(0, (size, -1))


def _all_to_all(x: torch.Tensor, group, size: int, scatter: int, gather: int) -> torch.Tensor:
    """Chunk j of x along `scatter` to rank j; the chunks received,
    concatenated along `gather` in rank order."""
    import torch.distributed as dist

    send = torch.stack(x.chunk(size, scatter)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), gather)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, shard: "TokenShard", scatter: int, gather: int):
        ctx.args = shard, scatter, gather
        return _all_to_all(x, shard.group, shard.size, scatter, gather)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        shard, scatter, gather = ctx.args
        return _all_to_all(g, shard.group, shard.size, gather, scatter), None, None, None


class _GatherTokens(torch.autograd.Function):
    """Forward: [B, L, C] slices -> [B, sp * L, C]; backward: this rank's
    slice of a gradient every rank computes alike."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, shard: "TokenShard"):
        ctx.shard = shard
        return _all_gather(x, shard.group, shard.size).transpose(0, 1).flatten(1, 2)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        s = ctx.shard
        return g.narrow(1, s.rank * s.local, s.local).contiguous(), None


class _GatherTokensSum(_GatherTokens):
    """_GatherTokens whose backward sums the ranks' gradients, each different,
    and keeps this rank's slice of the sum (a reduce-scatter)."""

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        import torch.distributed as dist

        s = ctx.shard
        send = g.unflatten(1, (s.size, s.local)).transpose(0, 1).contiguous()
        out = send.new_empty(send.shape[1:])
        dist.reduce_scatter_tensor(out, send.flatten(0, 1), op=dist.ReduceOp.SUM, group=s.group)
        return out, None


@dataclasses.dataclass(frozen=True)
class TokenShard:
    """This rank's share of a tower's S tokens over the sp group (module
    notes): rows [rank * local, (rank + 1) * local) of S padded to
    size * local."""
    group: object
    size: int
    rank: int
    tokens: int  # S

    @property
    def local(self) -> int:
        return -(-self.tokens // self.size)

    @property
    def pad(self) -> int:
        return self.size * self.local - self.tokens

    def split(self, x: torch.Tensor) -> torch.Tensor:
        """[B, S, D] whole -> this rank's [B, L, D], zero rows past S."""
        if self.pad:
            x = F.pad(x, (0, 0, 0, self.pad))
        return x.narrow(1, self.rank * self.local, self.local)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """[B, L, D] slices -> [B, S, D] whole on every rank."""
        return _GatherTokens.apply(x, self).narrow(1, 0, self.tokens)

    def to_heads(self, qkv: torch.Tensor, heads: int, d: int) -> tuple[torch.Tensor, int]:
        """The qkv product of this rank's tokens [B, L, 3 * heads * d], its
        rows in (3, heads, d) order -> (the product over all S tokens, the
        heads it holds): heads / sp of them, or all `heads` where sp does not
        divide them (module notes)."""
        if heads % self.size:
            return _GatherTokensSum.apply(qkv, self).narrow(1, 0, self.tokens), heads
        B, L, _ = qkv.shape
        out = _AllToAll.apply(qkv.view(B, L, 3, heads, d), self, 3, 1)
        return out.flatten(2).narrow(1, 0, self.tokens), heads // self.size

    def to_tokens(self, out: torch.Tensor, heads: int) -> torch.Tensor:
        """The attention output over all S tokens [B, S, held * d] of
        to_heads' held heads -> this rank's tokens over all `heads`
        [B, L, heads * d]."""
        if self.pad:
            out = F.pad(out, (0, 0, 0, self.pad))
        if heads % self.size:
            return out.narrow(1, self.rank * self.local, self.local)
        return _AllToAll.apply(out, self, 1, 2)


def token_shard(partition, tokens: int) -> TokenShard | None:
    """The share of `tokens` this rank holds for a tower carrying
    `partition`; None: the tokens stay whole (no partition, or no active mesh
    with a started process group)."""
    if partition is None:
        return None
    mesh = active_mesh()
    if mesh is None or mesh.sp_group is None:
        return None
    import torch.distributed as dist

    return TokenShard(mesh.sp_group, dist.get_world_size(mesh.sp_group),
                      dist.get_rank(mesh.sp_group), tokens)
