"""Parameter and batch placement (counterpart of
tvts_tpu/parallel/partition.py).

- `shard_params`: every rank takes rank 0's parameters and buffers (a
  broadcast: the replicated layout of DDP); with the mesh's tp > 1 it then
  cuts them into this rank's tp slices (parallel/tensor_parallel.tp_shard),
  and with fsdp > 1 it shards what it holds (`fsdp_shard`);
- `fsdp_shard`: FSDP2 `fully_shard` over the mesh's ("dp", "fsdp") sub-mesh
  (HSDP): the parameters (under tp, this rank's tp slices), their gradients
  and the optimizer state built afterwards are split over the fsdp axis
  (dim 0, torch.chunk's pieces) and replicated over dp. One unit a
  residual block of every tower (the model's `fsdp_units()`) and the root
  for the rest. The JAX package picks a sharded axis per matrix
  (`param_partition_spec`), a TPU layout; the update is the same. The
  weights stay f32 masters, gathered in f32 and cast at their use (no
  mixed-precision policy, so no rounding moves against the JAX package).
  FSDP2 averages the gradients over dp x fsdp, never over tp: the gradient
  of the whole batch's loss (train/step.py), as the JAX mesh step's. Any
  group size shards, 1 included;
- `whole(module, fn, *args)`: `fn(*args)` with `module`'s parameters whole:
  inside its FSDP2 forward window, and under tp with its blocks' tp slices
  gathered into the reference-ordered tensors
  (parallel/tensor_parallel.gathered). The kernel paths
  (ops/fused_forward.py, ops/text_attention.py) read a block's parameters
  directly and never call its `forward`, so without this FSDP2 would
  neither gather them before the kernels nor reduce-scatter their
  gradients after the backward, and the kernels would see tp slices.
  `fn`'s tensors come in through `args`, where FSDP2 hangs its backward
  hooks. Without sharding it is `fn(*args)`;
- `full_state_dict`, `full_optimizer_state`: the gathered state, every
  rank taking part (a collective: over fsdp, then over tp), for a
  checkpoint in the reference layout; `load_full_state_dict`,
  `load_full_optimizer_state`: each rank keeps its own slice of a full
  state (its tp slice, then its fsdp shard of it), as a resume needs;
- `shard_batch`: this rank's part of a global batch, the part of its place
  in the data group (tp ranks take the same part). The Trainer does not
  need it: each rank's ShardedLoader yields its own disjoint samples
  (data/loader.py), which are the rank-local batch as they are. The JAX
  package places the global batch with a bare device_put
  (tvts_tpu/parallel/partition.py:75) and leaves the split to GSPMD.
"""

from __future__ import annotations

import functools

import torch

from tvts_torch.parallel import tensor_parallel as tp
from tvts_torch.parallel.mesh import Mesh

_WHOLE = "_fsdp_whole"  # the forward method fsdp_shard registers on each unit


def shard_params(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Broadcast rank 0's parameters and buffers to every rank, in place;
    then, with tp > 1, cut them into tp slices and, with fsdp > 1, shard
    them. Build the optimizer afterwards."""
    if mesh.distributed:
        import torch.distributed as dist

        with torch.no_grad():
            for t in [*model.parameters(), *model.buffers()]:
                dist.broadcast(t.data, src=0)
    if mesh.tp > 1:
        tp.tp_shard(model, mesh)
    if mesh.fsdp > 1:
        fsdp_shard(model, mesh)
    return model


def _call(fn, *args, **kwargs):
    return fn(*args, **kwargs)


def fsdp_shard(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Shard `model` in place over the mesh's fsdp axis (module notes): the
    units of `model.fsdp_units()`, then the root."""
    from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method

    if mesh.device_mesh is None:
        raise ValueError("fsdp_shard needs a mesh with a started process group")
    for unit in [*model.fsdp_units(), model]:
        fully_shard(unit, mesh=mesh.data_mesh)
        setattr(unit, _WHOLE, _call)
        register_fsdp_forward_method(unit, _WHOLE)
    tp.tag(model)  # FSDP2 made new parameters
    return model


def is_fsdp(model: torch.nn.Module) -> bool:
    """True for a model fsdp_shard sharded (without importing FSDP2)."""
    return hasattr(model, _WHOLE)


def is_sharded(model: torch.nn.Module) -> bool:
    """True for a model sharded over fsdp or tp."""
    return is_fsdp(model) or tp.is_tp_sharded(model)


def _gathered_call(modules, fn, *args, **kwargs):
    with tp.gathered(modules):
        return fn(*args, **kwargs)


def whole(module: torch.nn.Module, fn, *args, **kwargs):
    """fn(*args, **kwargs) with `module`'s parameters whole (module notes)."""
    modules = tp.unit_modules(module)
    if modules:
        fn = functools.partial(_gathered_call, modules, fn)
    method = getattr(module, _WHOLE, None)
    return fn(*args, **kwargs) if method is None else method(fn, *args, **kwargs)


def _dtensor():
    from torch.distributed.tensor import DTensor

    return DTensor


def _full(t):
    return t.full_tensor() if isinstance(t, _dtensor()) else t


def full_state_dict(model: torch.nn.Module) -> dict:
    """model.state_dict() with each shard gathered whole, over fsdp and then
    over tp (on every rank): the reference layout."""
    layouts = tp.layouts(model)
    out = {}
    for k, v in model.state_dict().items():
        v = _full(v)
        out[k] = tp.full(v, layouts[k]) if k in layouts else v
    return out


def _is_moment(key: str, value) -> bool:
    """An optimizer state tensor laid out as its parameter (not the step)."""
    return torch.is_tensor(value) and key != "step" and value.dim() > 0


def full_optimizer_state(optimizer: torch.optim.Optimizer) -> dict:
    """optimizer.state_dict() with each sharded state tensor gathered whole,
    over fsdp and then over tp: the unsharded optimizer's layout (on every
    rank)."""
    params = [p for group in optimizer.param_groups for p in group["params"]]
    sd = optimizer.state_dict()
    state = {}
    for i, st in sd["state"].items():
        layout = tp.param_layout(params[i])
        state[i] = {k: tp.full(_full(v), layout) if layout and _is_moment(k, v) else _full(v)
                    for k, v in st.items()}
    sd["state"] = state
    return sd


def _local_part(like, full: torch.Tensor) -> torch.Tensor:
    """This rank's part of `full` for the DTensor `like`: torch.chunk's piece
    along each sharded dim, as FSDP2 and DTensor cut it."""
    from torch.distributed.tensor import Shard

    mesh = like.device_mesh
    for dim, (placement, coord) in enumerate(zip(like.placements, mesh.get_coordinate())):
        if isinstance(placement, Shard):
            pieces = full.chunk(mesh.size(dim), placement.dim)
            full = pieces[coord] if coord < len(pieces) else full.narrow(placement.dim, 0, 0)
    local = like.to_local()
    if full.shape != local.shape:
        raise ValueError(f"a full tensor of {tuple(full.shape)} does not cut into this rank's "
                         f"shard of {tuple(local.shape)}")
    return full.to(local.device)


def load_full_state_dict(model: torch.nn.Module, state_dict: dict) -> None:
    """load_state_dict(state_dict, strict=True) of a full state; a sharded
    model keeps each rank's own slice of it (its tp slice, then its fsdp
    shard of that)."""
    if not is_sharded(model):
        model.load_state_dict(state_dict, strict=True)
        return
    current = model.state_dict()
    missing = sorted(set(current) - set(state_dict))
    unexpected = sorted(set(state_dict) - set(current))
    if missing or unexpected:
        raise KeyError(f"state dict mismatch: missing {missing}, unexpected {unexpected}")
    DTensor = _dtensor()
    layouts = tp.layouts(model)
    with torch.no_grad():
        for name, t in current.items():
            full = state_dict[name]
            if name in layouts:
                full = tp.local_part(full, layouts[name])
            if isinstance(t, DTensor):
                t.to_local().copy_(_local_part(t, full))
            else:
                t.copy_(full)


def load_full_optimizer_state(optimizer: torch.optim.Optimizer, state: dict) -> None:
    """optimizer.load_state_dict of a full state (full_optimizer_state's
    layout); each state tensor of a sharded parameter becomes this rank's
    slice of it (tp, then fsdp), in the dtype the load gave it."""
    optimizer.load_state_dict(state)
    DTensor = _dtensor()
    for p, st in optimizer.state.items():
        layout = tp.param_layout(p)
        for k, v in st.items():
            if not _is_moment(k, v) or isinstance(v, DTensor):
                continue
            if layout is not None and v.shape != p.shape:
                v = st[k] = tp.local_part(v, layout).clone()
            if isinstance(p, DTensor) and v.shape == p.shape:
                st[k] = DTensor.from_local(_local_part(p, v).clone(), p.device_mesh,
                                           p.placements, shape=p.shape, stride=p.stride())


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's contiguous 1/(dp x fsdp) of a global batch, at its place
    in the data group (tp ranks take the same part). The clip-major text
    rows [n_trans * B, ...] are cut per clip, so the rank keeps its own
    videos' clips, still clip-major (tvts_tpu/train/step.py:203-220)."""
    B, n = batch["video"].shape[0], mesh.data_size
    if B % n:
        raise ValueError(f"batch of {B} videos does not split over {n} data ranks")
    per = B // n
    part = slice(mesh.data_rank * per, (mesh.data_rank + 1) * per)
    out = {}
    for key, value in batch.items():
        if key == "text_ids" and value.shape[0] != B:
            n = value.shape[0] // B
            out[key] = value.reshape(n, B, *value.shape[1:])[:, part].reshape(
                n * per, *value.shape[1:])
        else:
            out[key] = value[part]
    return out
