"""Tensor parallelism over the mesh's tp group (counterpart of the `tp`
rules of tvts_tpu/parallel/partition.py:20-54): Megatron's column -> row
pairing on explicit local shards.

Which tensors: the modules that carry a `TP_LAYOUT` (models/layers.py
`VarAttention`, `SelfAttention`, `Mlp`; models/sort.py `SortAttention`,
`SortMlp`), so the video tower's `attn` and `timeattn`, the CLIP text
tower, the v2 sort head, and v1's JointViT and sort head. DistilBERT's
`q_lin` ... `lin2` match no JAX rule and stay replicated, as does every
other tensor. A layout names each sharded parameter's kind:
- "qkv": the fused qkv weight [3D, D] and bias [3D], column-parallel and
  cut by heads: rank t keeps q, k and v of heads [t H/tp, (t+1) H/tp), its
  rows in (3, H/tp, d) order, so the local slice's `.chunk(3, dim=-1)` is
  still q, k, v. Gathered, the ranks' rows are in (tp, 3, H/tp, d) order,
  which the gather turns back into the reference (3, H, d) order. The JAX
  package cuts the fused output contiguously (P("fsdp", "tp")) and lets
  GSPMD reshard around it; the numbers are the same;
- "col": `c_fc` / `fc1` weight and bias, rows cut contiguously;
- "row": `proj` / `out_proj` / `c_proj` / `fc2` weight, columns cut
  contiguously. Their biases stay whole and are added once, after the sum.
A module is sharded only where every tensor of its layout divides as the
JAX rule's `_divisible` asks on the same mesh (the input width by fsdp, the
output width by tp) and, for attention, its heads by tp; else the whole
module stays replicated, with the same numbers.

The eager path computes with the local heads and hidden width: the blocks
read `.weight` / `.bias` into functions (models/layers.py `var_attention`,
`self_attention`, `mlp`), which take the module's `tp_group` and place
`copy_to_tp` (identity forward, all-reduce backward) before the column
product and `row_linear` (all-reduce forward, identity backward) for the
row product. Parameters replicated over tp get the same gradient on
every tp rank, so no reduction over tp follows the backward.

The kernel paths take whole weights (parallel/partition.whole, which calls
`gathered`): inside the window each sharded module's parameters are the
all-gathered, reference-ordered tensors and its `tp_group` is None; the
gather's backward keeps this rank's slice of the whole gradient, which every
tp rank computes alike from the same batch. That is the JAX kernel step's
shard_map with the parameters in as P() (tvts_tpu/ops/fused_forward.py:
757-770).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

_TAG = "_tp_layout"  # on a sharded parameter: (kind, group)
_UNIT = "_tp_modules"  # on a unit (a block): its sharded modules, which `gathered` swaps
_ROOT = "_tp_sharded"  # on the model tp_shard sharded


def _size_rank(group) -> tuple[int, int]:
    import torch.distributed as dist

    return dist.get_world_size(group), dist.get_rank(group)


def shard(full: torch.Tensor, kind: str, rank: int, size: int) -> torch.Tensor:
    """Rank `rank`'s slice of a whole tensor of the given kind (module notes)."""
    if kind == "qkv":
        return full.unflatten(0, (3, size, -1))[:, rank].flatten(0, 1)
    return full.chunk(size, 1 if kind == "row" else 0)[rank]


def assemble(stacked: torch.Tensor, kind: str) -> torch.Tensor:
    """The whole tensor from the ranks' slices stacked along a new dim 0."""
    if kind == "qkv":
        return stacked.unflatten(1, (3, -1)).transpose(0, 1).flatten(0, 2)
    if kind == "row":
        return stacked.transpose(0, 1).flatten(1, 2)
    return stacked.flatten(0, 1)


def _all_gather(local: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist

    size, _ = _size_rank(group)
    out = local.new_empty((size * local.shape[0], *local.shape[1:]))
    dist.all_gather_into_tensor(out, local.contiguous(), group=group)
    return out.unflatten(0, (size, -1))


class _Gather(torch.autograd.Function):
    """Forward: the whole tensor from every tp rank's slice; backward: this
    rank's slice of the whole gradient (every tp rank computes it alike)."""

    @staticmethod
    def forward(ctx, local: torch.Tensor, kind: str, group) -> torch.Tensor:
        ctx.kind, ctx.size_rank = kind, _size_rank(group)
        return assemble(_all_gather(local, group), kind)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        size, rank = ctx.size_rank
        return shard(g, ctx.kind, rank, size).contiguous(), None, None


class _CopyToTP(torch.autograd.Function):
    """Identity forward; the cotangent all-reduced over tp in the backward."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        import torch.distributed as dist

        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromTP(torch.autograd.Function):
    """All-reduce over tp forward; identity backward."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        import torch.distributed as dist

        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g, None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    """Before a column-parallel product (x itself without a group)."""
    return x if group is None else _CopyToTP.apply(x, group)


def row_linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               group) -> torch.Tensor:
    """x @ weight.T + bias in x's dtype; with a group, weight is this rank's
    columns: the partial products are summed over tp, then the bias is
    added once."""
    if group is None:
        return F.linear(x, weight.to(x.dtype), bias.to(x.dtype))
    return _ReduceFromTP.apply(F.linear(x, weight.to(x.dtype)), group) + bias.to(x.dtype)


def _owner(module: nn.Module, key: str) -> tuple[nn.Module, str]:
    path, _, name = key.rpartition(".")
    return (module.get_submodule(path) if path else module), name


def _divisible(module: nn.Module, size: int, fsdp: int) -> bool:
    """The JAX rule's `_divisible` for every tensor of the module's layout on
    a (fsdp, tp) mesh, and the heads by tp (module notes)."""
    if getattr(module, "num_heads", size) % size:
        return False
    for key, kind in module.TP_LAYOUT.items():
        t = getattr(*_owner(module, key))
        if t.dim() == 1:
            ok = t.shape[0] % size == 0
        else:  # torch's [out, in]: the JAX kernel [in, out]
            out_dim, in_dim = t.shape
            ok = (in_dim % size == 0 and out_dim % fsdp == 0) if kind == "row" else \
                (in_dim % fsdp == 0 and out_dim % size == 0)
        if not ok:
            return False
    return True


def shardable(model: nn.Module, size: int, fsdp: int = 1) -> list[tuple[str, nn.Module]]:
    """(name, module) of every module of `model` tp_shard shards on a mesh of
    this tp and fsdp."""
    return [(name, m) for name, m in model.named_modules()
            if hasattr(m, "TP_LAYOUT") and _divisible(m, size, fsdp)]


def tp_shard(model: nn.Module, mesh) -> nn.Module:
    """Cut `model` in place into this rank's tp slices (module notes), at any
    tp size, 1 included. The parameters are whole and equal on every rank
    (parallel/partition.shard_params broadcasts them first); build the
    optimizer afterwards."""
    if mesh.tp_group is None:
        raise ValueError("tp_shard needs a mesh with a started process group")
    size, rank = _size_rank(mesh.tp_group)
    chosen = {id(m) for _, m in shardable(model, size, mesh.fsdp)}
    for unit in model.fsdp_units():
        mods = [m for m in unit.modules() if id(m) in chosen]
        for m in mods:
            with torch.no_grad():
                for key, kind in m.TP_LAYOUT.items():
                    owner, name = _owner(m, key)
                    p = owner._parameters[name]
                    setattr(owner, name, nn.Parameter(shard(p.detach(), kind, rank, size).clone(),
                                                      requires_grad=p.requires_grad))
            m.tp_group = mesh.tp_group
        setattr(unit, _UNIT, mods)
    setattr(model, _ROOT, True)
    tag(model)
    return model


def tag(model: nn.Module) -> None:
    """Mark each sharded parameter with its (kind, group): the optimizer's
    state is matched to a layout through its parameters. FSDP2 replaces the
    parameters, so parallel/partition.fsdp_shard tags them again."""
    for m in sharded_modules(model):
        for key, kind in m.TP_LAYOUT.items():
            owner, name = _owner(m, key)
            setattr(owner._parameters[name], _TAG, (kind, m.tp_group))


def unit_modules(unit: nn.Module) -> list[nn.Module]:
    """The sharded modules of a unit (a block), which `gathered` swaps."""
    return getattr(unit, _UNIT, [])


def is_tp_sharded(model: nn.Module) -> bool:
    return getattr(model, _ROOT, False)


def sharded_modules(model: nn.Module) -> list[nn.Module]:
    return [m for unit in model.fsdp_units() for m in unit_modules(unit)] \
        if is_tp_sharded(model) else []


def layouts(model: nn.Module) -> dict[str, tuple[str, object]]:
    """{state_dict name: (kind, group)} of the sharded tensors."""
    names = {id(m): name for name, m in model.named_modules()}
    return {f"{names[id(m)]}.{key}": (kind, m.tp_group)
            for m in sharded_modules(model) for key, kind in m.TP_LAYOUT.items()}


def param_layout(p: torch.Tensor) -> tuple[str, object] | None:
    return getattr(p, _TAG, None)


def full(local: torch.Tensor, layout) -> torch.Tensor:
    """The whole tensor of a sharded one (a collective; no autograd)."""
    kind, group = layout
    with torch.no_grad():
        return assemble(_all_gather(local, group), kind)


def local_part(whole: torch.Tensor, layout) -> torch.Tensor:
    """This rank's slice of a whole tensor."""
    kind, group = layout
    size, rank = _size_rank(group)
    return shard(whole, kind, rank, size)


@contextlib.contextmanager
def gathered(modules: list):
    """Each module's parameters whole and its tp_group None inside (module
    notes); the local parameters and the group back on exit."""
    saved = []
    try:
        for m in modules:
            for key, kind in m.TP_LAYOUT.items():
                owner, name = _owner(m, key)
                local = owner._parameters[name]
                saved.append((owner, name, local))
                owner._parameters[name] = _Gather.apply(local, kind, m.tp_group)
            saved.append((m, None, m.tp_group))
            m.tp_group = None
        yield
    finally:
        for owner, name, value in reversed(saved):
            if name is None:
                owner.tp_group = value
            else:
                owner._parameters[name] = value
