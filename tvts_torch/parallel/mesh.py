"""Process groups and the (dp, fsdp, sp, tp) device mesh (counterpart of
tvts_tpu/parallel/mesh.py).

The reference's only parallelism is NCCL data-parallel DDP plus an embedding
all_gather (SURVEY §2.10); the JAX package adds the `fsdp` axis (parameter
and optimizer-state sharding, replacing the reference's optional DeepSpeed
path) and `tp` (Megatron tensor parallelism over heads and the MLP's hidden
width). Here one process a card: dp = world / (fsdp * sp * tp), and the
ranks form a 4-D `DeviceMesh` named ("dp", "fsdp", "sp", "tp"), rank r at
((d * fsdp + f) * sp + s) * tp + t, the JAX mesh's device order
(tvts_tpu/parallel/mesh.py:27-42). Two groups follow from it:
- the data group: the dp x fsdp ranks that share this rank's (sp, tp)
  coordinates, in rank order. The batch is split over it and replicated
  over tp (the JAX batch's P(("dp", "fsdp"))): the contrastive all-gather,
  the sort mean and the gradient reduction run over it
  (parallel/collectives.py, train/step.py), and the loaders read its
  coordinates (`active_mesh`);
- the tp group: the tp ranks that share this rank's data coordinates;
  parallel/tensor_parallel.py shards the heads and the MLP's hidden width
  over it.
parallel/partition.py shards over the fsdp axis of the ("dp", "fsdp")
sub-mesh.

`create_mesh` starts the default process group from a coordinator address
(`--coordinator host:port --num_processes N --process_id i`, the JAX
script's flags) or from torchrun's environment (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT); with neither, it starts none and the
collectives of train/step.py are not run. NCCL on the card, gloo on the CPU,
and never one for the other.

Out of scope for now: `sp > 1` (sequence parallelism over the video
tokens), the JAX package's own extension on its plain path
(tvts_tpu/models/space_time_vit.py:161-170); ROADMAP.md item M2d-sp queues
it. It raises.
"""

from __future__ import annotations

import dataclasses
import os

import torch

AXES = ("dp", "fsdp", "sp", "tp")
_active = None  # the mesh create_mesh started and has not closed


@dataclasses.dataclass
class Mesh:
    """This process's place: rank, world size, its device, the backend of
    the process group it started (None: no group, one process), the fsdp,
    sp and tp factors and, with a group, the 4-D DeviceMesh and the data and
    tp groups (module notes)."""
    rank: int = 0
    world: int = 1
    device: torch.device = dataclasses.field(default_factory=lambda: torch.device("cpu"))
    backend: str | None = None
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    device_mesh: object = None  # torch.distributed.device_mesh.DeviceMesh
    data_group: object = None  # a ProcessGroup; None: the default group
    tp_group: object = None

    @property
    def distributed(self) -> bool:
        return self.backend is not None

    @property
    def dp(self) -> int:
        return self.world // (self.fsdp * self.sp * self.tp)

    @property
    def data_size(self) -> int:
        """The ranks the batch is split over: dp x fsdp."""
        return self.dp * self.fsdp

    @property
    def data_rank(self) -> int:
        """This rank's place in the data group: d * fsdp + f."""
        return self.rank // (self.sp * self.tp)

    @property
    def data_mesh(self):
        """The ("dp", "fsdp") sub-mesh of this rank (FSDP2 shards over it)."""
        return None if self.device_mesh is None else self.device_mesh["dp", "fsdp"]

    def close(self) -> None:
        """Destroy the process group this mesh started."""
        import torch.distributed as dist

        global _active
        if _active is self:
            _active = None
        if self.distributed and dist.is_initialized():
            dist.destroy_process_group()
        self.backend, self.device_mesh, self.data_group, self.tp_group = None, None, None, None

    def __enter__(self) -> "Mesh":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def active_mesh() -> Mesh | None:
    """The mesh create_mesh started and has not closed, else None."""
    return _active


def create_mesh(fsdp: int = 1, tp: int = 1, sp: int = 1, coordinator: str | None = None,
                num_processes: int | None = None, process_id: int | None = None,
                device: str | torch.device = "cuda") -> Mesh:
    """The (dp, fsdp, sp, tp) mesh of this process, its process group started
    where a coordinator or torchrun's environment names one; dp = world /
    (fsdp * sp * tp). `device`: "cuda" (this process's card: LOCAL_RANK under
    torchrun, else process_id modulo the cards) or "cpu"."""
    if sp > 1:
        raise NotImplementedError(
            "sp > 1 (sequence parallelism) is the JAX package's own extension on its plain "
            "path; the port has not taken it yet: ROADMAP.md item M2d-sp")
    for name, value in (("fsdp", fsdp), ("tp", tp), ("sp", sp)):
        if value < 1:
            raise ValueError(f"{name} must be >= 1, got {value}")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("create_mesh: no CUDA device; pass device='cpu' to train on the CPU")
    env = os.environ
    if coordinator is not None:
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator needs --num_processes and --process_id")
        init, world, rank = f"tcp://{coordinator}", num_processes, process_id
        local = int(env.get("LOCAL_RANK", rank))
    elif "RANK" in env and "WORLD_SIZE" in env:  # torchrun
        init, world, rank = "env://", int(env["WORLD_SIZE"]), int(env["RANK"])
        local = int(env.get("LOCAL_RANK", 0))
    else:
        init, world = None, 1
    if world % (fsdp * sp * tp):
        raise ValueError(f"fsdp={fsdp} x sp={sp} x tp={tp} does not divide the world of "
                         f"{world} processes")
    if init is None:
        return Mesh(device=device)
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if device.type == "cuda":
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank,
                            device_id=device if backend == "nccl" else None)
    mesh = init_device_mesh(device.type, (world // (fsdp * sp * tp), fsdp, sp, tp),
                            mesh_dim_names=AXES)
    data_group = None
    if sp * tp > 1:  # one group for each (sp, tp) coordinate; every rank makes them all
        data_group, _ = dist.new_subgroups_by_enumeration(
            [list(range(c, world, sp * tp)) for c in range(sp * tp)])
    global _active
    _active = Mesh(rank=rank, world=world, device=device, backend=backend, fsdp=fsdp, tp=tp,
                   sp=sp, device_mesh=mesh, data_group=data_group,
                   tp_group=mesh["tp"].get_group())
    return _active
