"""Process groups and the (dp, fsdp) device mesh (counterpart of
tvts_tpu/parallel/mesh.py).

The reference's only parallelism is NCCL data-parallel DDP plus an embedding
all_gather (SURVEY §2.10); the JAX package adds the `fsdp` axis (parameter
and optimizer-state sharding, replacing the reference's optional DeepSpeed
path). Here one process a card: dp = world / fsdp, and the ranks form a 2-D
`DeviceMesh` named ("dp", "fsdp"), rank r at (r // fsdp, r % fsdp) as the
JAX mesh's devices, so the batch's rank order is the JAX package's
P(("dp", "fsdp")) order. The contrastive all-gather and the sort mean run
over the whole world (parallel/collectives.py), as the JAX step's
axis_names=("dp", "fsdp"); parallel/partition.py shards over the fsdp axis.

`create_mesh` starts the default process group from a coordinator address
(`--coordinator host:port --num_processes N --process_id i`, the JAX
script's flags) or from torchrun's environment (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT); with neither, it starts none and the
collectives of train/step.py are not run. NCCL on the card, gloo on the CPU,
and never one for the other.

Out of scope for now: `tp > 1` (tensor parallelism) and `sp > 1` (sequence
parallelism over the video tokens) are the JAX package's own extensions,
plain path only (tvts_tpu/parallel/partition.py:27-38,
tvts_tpu/models/space_time_vit.py:161-170); ROADMAP.md item M2d queues them.
Both raise.
"""

from __future__ import annotations

import dataclasses
import os

import torch

AXES = ("dp", "fsdp")


@dataclasses.dataclass
class Mesh:
    """This process's place: rank, world size, its device, the backend of
    the process group it started (None: no group, one process), the fsdp
    factor and, with a group, the ("dp", "fsdp") DeviceMesh."""
    rank: int = 0
    world: int = 1
    device: torch.device = dataclasses.field(default_factory=lambda: torch.device("cpu"))
    backend: str | None = None
    fsdp: int = 1
    device_mesh: object = None  # torch.distributed.device_mesh.DeviceMesh

    @property
    def distributed(self) -> bool:
        return self.backend is not None

    @property
    def dp(self) -> int:
        return self.world // self.fsdp

    def close(self) -> None:
        """Destroy the process group this mesh started."""
        import torch.distributed as dist

        if self.distributed and dist.is_initialized():
            dist.destroy_process_group()
        self.backend, self.device_mesh = None, None

    def __enter__(self) -> "Mesh":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _refuse(name: str, value: int, what: str) -> None:
    if value > 1:
        raise NotImplementedError(
            f"{name} > 1 ({what}) is the JAX package's own extension on its plain path; the "
            "port has not taken it yet: ROADMAP.md item M2d")


def create_mesh(fsdp: int = 1, tp: int = 1, sp: int = 1, coordinator: str | None = None,
                num_processes: int | None = None, process_id: int | None = None,
                device: str | torch.device = "cuda") -> Mesh:
    """The (dp, fsdp) mesh of this process, its process group started where
    a coordinator or torchrun's environment names one; dp = world / fsdp.
    `device`: "cuda" (this process's card: LOCAL_RANK under torchrun, else
    process_id modulo the cards) or "cpu"."""
    _refuse("tp", tp, "tensor parallelism")
    _refuse("sp", sp, "sequence parallelism")
    if fsdp < 1:
        raise ValueError(f"fsdp must be >= 1, got {fsdp}")
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
    if world % fsdp:
        raise ValueError(f"fsdp={fsdp} does not divide the world of {world} processes")
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
    mesh = init_device_mesh(device.type, (world // fsdp, fsdp), mesh_dim_names=AXES)
    return Mesh(rank=rank, world=world, device=device, backend=backend, fsdp=fsdp,
                device_mesh=mesh)
