"""Checkpoints with the reference's monitor / best semantics, on torch.save
(counterpart of tvts_tpu/utils/checkpoint.py; reference
v2/base/base_trainer.py:119-247).

- every `save_period` epochs `checkpoint-epoch{N}.pth`, and `model_best.pth`
  when the monitored value improves ("min val_loss_0" style monitor
  strings); `step{N}.pth` every `save_every_steps` optimizer steps. The JAX
  package writes orbax directories of the same names without the suffix;
- each file is the reference trainer's layout, as
  utils/convert.save_reference_checkpoint writes it: {arch, epoch,
  state_dict (`module.`-prefixed reference names), optimizer (the
  optimizer's state dict), monitor_best, config} plus `step`, the optimizer
  steps taken (the milestone LR schedule's count). `epoch` is the last
  epoch the file has completed (a step file: the epochs before its own), so
  a resume continues at epoch + 1; `build_model(load_checkpoint=...)` loads
  its `state_dict` strictly;
- the monitor's best is updated before the epoch's files are written, so a
  file's `monitor_best` includes that epoch, as the reference writes it;
- only the process that `writes` (rank 0) touches the disk; every process
  keeps the same monitor, and every process gathers the state of a model
  sharded by parallel/partition.shard_params (over fsdp, then over tp: a
  collective), so the file is always the reference layout: full tensors
  in `state_dict` (the qkv rows back in the reference (3, H, d) order),
  the optimizer's state dict as an unsharded optimizer holds it. A file
  written under any fsdp and tp loads strictly into an unsharded
  `build_model`, and a resume under any fsdp and tp re-shards it.
"""

from __future__ import annotations

import math
import os
import re

import torch

from tvts_torch.parallel.partition import full_optimizer_state, full_state_dict, is_sharded
from tvts_torch.utils.convert import save_reference_checkpoint


class Monitor:
    """'min val_loss_0' / 'max R1' / 'off' (base_trainer.py:40-52)."""

    def __init__(self, spec: str = "off"):
        self.spec = spec
        if spec == "off":
            self.mode, self.metric = "off", None
            self.best = 0.0
        else:
            self.mode, self.metric = spec.split()
            if self.mode not in ("min", "max"):
                raise ValueError(f"monitor {spec!r}: mode must be min or max")
            self.best = math.inf if self.mode == "min" else -math.inf

    def improved(self, log: dict) -> bool:
        """True (and `best` updated) when log's metric is at least as good as best."""
        if self.mode == "off" or self.metric not in log:
            return False
        val = log[self.metric]
        better = val <= self.best if self.mode == "min" else val >= self.best
        if better:
            self.best = val
        return better


class CheckpointManager:
    def __init__(self, save_dir: str, save_period: int = 1, monitor: str = "off",
                 arch: str = "", config: dict | None = None, writes: bool = True):
        self.save_dir = os.path.abspath(str(save_dir))
        self.save_period = save_period
        self.monitor = Monitor(monitor)
        self.arch, self.config, self.writes = arch, config or {}, writes
        if writes:
            os.makedirs(self.save_dir, exist_ok=True)

    def path(self, tag: str) -> str:
        """The file of `tag`; a path to an existing file is taken as it is."""
        return tag if os.path.isfile(tag) else os.path.join(self.save_dir, f"{tag}.pth")

    def _save(self, tags: list[str], epoch: int, state: dict) -> None:
        """Write `state` under each tag (rank 0); a sharded model's state is
        gathered on every rank first."""
        model, optimizer = state["model"], state.get("optimizer")
        if is_sharded(model):  # a collective: every rank gathers
            model = full_state_dict(model)
            optimizer = None if optimizer is None else full_optimizer_state(optimizer)
        elif optimizer is not None:
            optimizer = optimizer.state_dict()
        if not self.writes:
            return
        for tag in tags:
            save_reference_checkpoint(model, self.path(tag), self.arch, epoch=epoch,
                                      config=self.config, monitor_best=self.monitor.best,
                                      optimizer=optimizer, step=state.get("step"))

    def save_epoch(self, epoch: int, state: dict, val_log: dict | None = None) -> list[str]:
        """After epoch `epoch` (1-based): the periodic file and, on a monitor
        improvement, model_best. `state`: {"model", "optimizer", "step"}; the
        downstream scripts save {"model"} alone (an empty optimizer, no step).
        Returns the tags written."""
        best = val_log is not None and self.monitor.improved(val_log)
        tags = ([f"checkpoint-epoch{epoch}"] if epoch % self.save_period == 0 else []) \
            + (["model_best"] if best else [])
        if tags:
            self._save(tags, epoch, state)
        return tags

    def save_step(self, step: int, state: dict, epoch: int = 0) -> None:
        """A mid-epoch file after `step` optimizer steps, in epoch `epoch` + 1."""
        self._save([f"step{int(step)}"], epoch, state)

    def restore(self, tag: str) -> dict:
        """The checkpoint dict of `tag` (or of a path), tensors on the CPU."""
        return torch.load(self.path(tag), map_location="cpu", weights_only=True)

    def latest_epoch(self) -> int | None:
        eps = [int(m.group(1)) for f in os.listdir(self.save_dir)
               if (m := re.fullmatch(r"checkpoint-epoch(\d+)\.pth", f))] \
            if os.path.isdir(self.save_dir) else []
        return max(eps) if eps else None
