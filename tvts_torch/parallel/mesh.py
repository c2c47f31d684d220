"""Process groups for data-parallel training (counterpart of
tvts_tpu/parallel/mesh.py).

The reference's only parallelism is NCCL data-parallel DDP plus an embedding
all_gather (SURVEY §2.10): here one process a card, dp = the world size.
`create_mesh` starts the default process group from a coordinator address
(`--coordinator host:port --num_processes N --process_id i`, the JAX
script's flags) or from torchrun's environment (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT); with neither, it starts none and
the collectives of train/step.py are not run. NCCL on the card, gloo on the
CPU, and never one for the other.

Out of scope: `fsdp > 1` (parameter and optimizer-state sharding) is
ROADMAP.md item M2c; `tp > 1` (tensor parallelism) and `sp` are the JAX
package's own extensions, which the reference lacks
(tvts_tpu/parallel/mesh.py:10-15). Both raise.
"""

from __future__ import annotations

import dataclasses
import os

import torch


@dataclasses.dataclass
class Mesh:
    """This process's place: rank, world size, its device, and the backend of
    the process group it started (None: no group, one process)."""
    rank: int = 0
    world: int = 1
    device: torch.device = dataclasses.field(default_factory=lambda: torch.device("cpu"))
    backend: str | None = None

    @property
    def distributed(self) -> bool:
        return self.backend is not None

    def close(self) -> None:
        """Destroy the process group this mesh started."""
        import torch.distributed as dist

        if self.distributed and dist.is_initialized():
            dist.destroy_process_group()
        self.backend = None

    def __enter__(self) -> "Mesh":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def create_mesh(fsdp: int = 1, tp: int = 1, coordinator: str | None = None,
                num_processes: int | None = None, process_id: int | None = None,
                device: str | torch.device = "cuda") -> Mesh:
    """The data-parallel mesh of this process, its process group started
    where a coordinator or torchrun's environment names one. `device`:
    "cuda" (this process's card: LOCAL_RANK under torchrun, else process_id
    modulo the cards) or "cpu"."""
    if fsdp > 1:
        raise NotImplementedError("fsdp > 1 (parameter and optimizer-state sharding) is not "
                                  "ported: ROADMAP.md item M2c")
    if tp > 1:
        raise NotImplementedError("tp > 1: tensor parallelism is the JAX package's own "
                                  "extension, which the reference lacks; the port leaves it out")
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
        return Mesh(device=device)
    import torch.distributed as dist

    if device.type == "cuda":
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank,
                            device_id=device if backend == "nccl" else None)
    return Mesh(rank=rank, world=world, device=device, backend=backend)
