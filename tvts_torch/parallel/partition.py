"""Parameter and batch placement for data-parallel training (counterpart of
tvts_tpu/parallel/partition.py, dp only).

- `shard_params`: every rank takes rank 0's parameters and buffers
  (a broadcast): the replicated layout of DDP;
- `shard_batch`: this rank's part of a global batch. The Trainer does not
  need it: each rank's ShardedLoader yields its own disjoint samples
  (data/loader.py), which are the rank-local batch as they are. The JAX
  package places the global batch with a bare device_put
  (tvts_tpu/parallel/partition.py:75) and leaves the split to GSPMD.
"""

from __future__ import annotations

import torch

from tvts_torch.parallel.mesh import Mesh

def shard_params(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Broadcast rank 0's parameters and buffers to every rank, in place."""
    if mesh.distributed:
        import torch.distributed as dist

        with torch.no_grad():
            for t in [*model.parameters(), *model.buffers()]:
                dist.broadcast(t.data, src=0)
    return model


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's contiguous 1/world of a global batch. The clip-major text
    rows [n_trans * B, ...] are cut per clip, so the rank keeps its own
    videos' clips, still clip-major (tvts_tpu/train/step.py:203-220)."""
    B = batch["video"].shape[0]
    if B % mesh.world:
        raise ValueError(f"batch of {B} videos does not split over {mesh.world} ranks")
    per = B // mesh.world
    part = slice(mesh.rank * per, (mesh.rank + 1) * per)
    out = {}
    for key, value in batch.items():
        if key == "text_ids" and value.shape[0] != B:
            n = value.shape[0] // B
            out[key] = value.reshape(n, B, *value.shape[1:])[:, part].reshape(
                n * per, *value.shape[1:])
        else:
            out[key] = value[part]
    return out
