"""The pretraining loop (counterpart of tvts_tpu/train/trainer.py; reference
v2/trainer/trainer.py `Trainer_TVTSv2_*` and v2/base/base_trainer.py
`Multi_BaseTrainer_dist`).

Batch preparation (`prepare_batch`, reference trainer.py:465-473): a collated
loader batch -> the numeric arrays of the train step (train/step.py):
- text: the per-clip transcripts concatenated clip-major, then CLIP-tokenized
  with truncation (`clip_tokenize_fn`), or for TVTS v1 WordPiece-tokenized
  with an attention mask (`wordpiece_tokenize_fn`); YT-Temporal gives 4
  transcripts a clip (the sort loss on), WebVid 1 (off);
- a 2-D `label` (YT-Temporal's arange(num_clips) per clip) becomes `labels`.

`Trainer`:
- one optimizer step per loader per iteration, round robin; the epoch's
  length is the `epoch_loader`'s (an index or a dataset name), by default the
  YT-Temporal loader's (reference trainer.py:76-79), capped by
  max_samples_per_epoch; the other loaders restart when they run out;
- each loader's batches go prepare_batch -> data/prefetch.py (two in
  flight) -> the step;
- the per-step aux scalars stay on the device and are fetched in one copy a
  `log_step` window (and before a step checkpoint): no host sync a step;
- optional validation before epoch 1 (`init_val`) and after every epoch:
  embeddings and sort accuracy -> similarity matrix -> the metrics, resolved
  by name in ops/metrics.py -> `val_loss_{i}`, which is the sort accuracy
  ratio (1.0 without sort labels), a reference quirk kept (trainer.py:585-597,
  630-631); across ranks the embeddings, sort counts and metas are
  gathered over the mesh's data group first (tp ranks hold the same rows),
  so every rank's metrics, monitor and model_best are the whole validation
  set's, each row once (the JAX package computes them from each process's
  own part);
- checkpoints (utils/checkpoint.py) after every epoch and every
  `save_every_steps` steps, and `resume` from one: parameters, optimizer
  state, the LR schedule's step count and the monitor's best;
- a torch.profiler trace of steps [start, stop) of the first epoch into
  `profile_dir`, with the program's spans on (utils/profiling: the train
  step's phases and the loader's wait, `tvts::data_wait`).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from tvts_torch.data.prefetch import prefetch_to_device
from tvts_torch.eval.embed import verbose
from tvts_torch.ops import metrics as metrics_mod
from tvts_torch.ops.sim import sim_matrix
from tvts_torch.parallel.collectives import all_gather_embeddings
from tvts_torch.parallel.mesh import Mesh
from tvts_torch.parallel.partition import load_full_optimizer_state, load_full_state_dict
from tvts_torch.text.tokenizer import tokenize_openclip
from tvts_torch.train.step import make_eval_step, make_train_step

# the validation metrics, by their names in ops/metrics.py
VAL_METRICS = ("t2v_metrics", "v2t_metrics")
AUX_KEYS = ("loss", "loss_ct", "loss_ce", "sort_acc")


def clip_tokenize_fn(context_length: int = 77):
    """Default text pipeline: CLIP BPE, truncate (the v2 towers)."""

    def fn(texts):
        return {"text_ids": tokenize_openclip(texts, context_length=context_length)}

    return fn


def wordpiece_tokenize_fn(vocab_path: str | None = None, max_length: int = 50):
    """The TVTS v1 text pipeline: DistilBERT WordPiece ids and their attention
    mask, padded to max_length (reference v1/trainer/trainer.py:130-131)."""
    from tvts_torch.text.wordpiece import WordPieceTokenizer

    tk = WordPieceTokenizer(vocab_path)

    def fn(texts):
        enc = tk(texts, max_length=max_length)
        return {"text_ids": enc["input_ids"], "attention_mask": enc["attention_mask"]}

    return fn


def _cast(a, dtype):
    a = np.asarray(a)
    return a if a.dtype == dtype else a.astype(dtype)


def _numeric(a) -> bool:
    """True for arrays (or nested lists) of bools and numbers."""
    try:
        return np.asarray(a).dtype.kind in "biuf"
    except ValueError:  # a ragged nested list: not one array
        return False


def prepare_batch(batch: dict, context_length: int = 77, tokenize_fn=None) -> dict:
    """Collated loader batch -> numpy arrays for the train step: "video"
    float32, "keep_ind" int32, "text_ids" (clip-major), and "labels" int32
    where the batch has a 2-D "label".

    A batch that already carries "text_ids" (tokenized at collate time) is not
    tokenized again; its arrays are cast as above and its keys that are not
    numbers (strings, meta) dropped. The JAX package returns such a batch as
    it is (trainer.py:68-69), strings and all."""
    if "text_ids" in batch:
        text = {k: np.asarray(v) for k, v in batch.items()
                if k not in ("video", "keep_ind", "label") and _numeric(v)}
    else:
        captions = batch["text"]
        if isinstance(captions, list) and captions and isinstance(captions[0], list):
            flat = [cap for clip_caps in captions for cap in clip_caps]  # clip-major concat
        else:
            flat = list(captions)
        text = (tokenize_fn or clip_tokenize_fn(context_length))(flat)
    out = {"video": _cast(batch["video"], np.float32),
           "keep_ind": _cast(batch["keep_ind"], np.int32)}
    out.update(text)
    if "label" in batch and np.ndim(batch["label"]) == 2:
        out["labels"] = _cast(batch["label"], np.int32)
    return out


class Trainer:
    """The epoch loop over `model` (trained in place) and `optimizer`
    (train/optim.make_optimizer); `opt_cfg` sets the milestone LR schedule.
    `mesh` (parallel/mesh.create_mesh) with a started process group makes
    the step the mesh one (the gradient of every rank's batch together, as
    the JAX Trainer's `make_train_step` over its mesh); a model sharded by
    parallel/partition.shard_params (fsdp, tp) trains, validates, saves
    gathered and resumes re-sharded. An epoch's samples are counted over the
    data ranks (dp x fsdp), as the loaders split them. Batches and validation
    run on the model's device.
    Keyword arguments as the JAX package's Trainer."""

    def __init__(self, model, optimizer, opt_cfg, data_loaders, valid_loaders=None,
                 epochs: int = 10, mesh: Mesh | None = None, ckpt_manager=None,
                 init_val: bool = False, max_samples_per_epoch: int | None = None,
                 context_length: int = 77, log_step: int = 50, writer=None, tokenize_fn=None,
                 apply_fn=None, save_every_steps: int | None = None, visualizer=None,
                 temperature: float = 0.05, epoch_loader: int | str | None = None,
                 profile_dir: str | None = None, profile_steps: tuple[int, int] = (10, 13)):
        self.model, self.optimizer = model, optimizer
        self.data_loaders = list(data_loaders)
        self.valid_loaders = list(valid_loaders or [])
        self.epochs = epochs
        self.device = next(model.parameters()).device
        self.mesh = mesh if mesh is not None else Mesh(device=self.device)
        self.ckpt = ckpt_manager
        self.init_val = init_val
        self.max_samples_per_epoch = max_samples_per_epoch
        self.context_length = context_length
        self.log_step = log_step
        self.writer = writer
        self.tokenize_fn = tokenize_fn
        self.save_every_steps = save_every_steps
        self.visualizer = visualizer
        self.epoch_loader = epoch_loader
        self.profile_dir = profile_dir
        self.profile_steps = profile_steps
        self.start_epoch = 1
        self.train_step = make_train_step(model, optimizer, opt_cfg, temperature, apply_fn,
                                          self.mesh)
        self.eval_step = make_eval_step(model, temperature, apply_fn)

    def _len_epoch(self) -> int:
        n = None
        if isinstance(self.epoch_loader, int):
            n = len(self.data_loaders[self.epoch_loader])
        elif isinstance(self.epoch_loader, str):
            for dl in self.data_loaders:
                if str(getattr(getattr(dl, "dataset", None), "dataset_name", "")) \
                        == self.epoch_loader:
                    n = len(dl)
            if n is None:
                raise ValueError(f"trainer.epoch_loader={self.epoch_loader!r} matches no "
                                 "loader dataset_name")
        else:  # the YT-Temporal loader, else the first
            for dl in self.data_loaders:
                if str(getattr(getattr(dl, "dataset", None), "dataset_name", "")) \
                        .startswith("YT"):
                    n = len(dl)
        if n is None:
            n = len(self.data_loaders[0])
        if self.max_samples_per_epoch:
            per_step = self.data_loaders[0].batch_size * max(
                1, self.data_loaders[0].num_processes)
            n = min(n, self.max_samples_per_epoch // per_step)
        return max(n, 1)

    def _pipeline(self, dl):
        """prepare_batch -> the device, two batches in flight."""
        prepared = (prepare_batch(raw, self.context_length, self.tokenize_fn) for raw in dl)
        return prefetch_to_device(prepared, size=2, device=self.device)

    def _state(self) -> dict:
        return {"model": self.model, "optimizer": self.optimizer, "step": self.train_step.count}

    def resume(self, tag: str | None = None) -> int:
        """Restore parameters, optimizer state, the step count and the
        monitor's best from a checkpoint (a tag in the save directory or a
        path; None: the latest epoch's, if any). Returns the next epoch."""
        if self.ckpt is None:
            raise ValueError("resume: no checkpoint manager configured")
        if tag is None:
            latest = self.ckpt.latest_epoch()
            if latest is None:
                return 1
            tag = f"checkpoint-epoch{latest}"
        ckpt = self.ckpt.restore(tag)
        load_full_state_dict(self.model, {k.removeprefix("module."): v
                                          for k, v in ckpt["state_dict"].items()})
        load_full_optimizer_state(self.optimizer, ckpt["optimizer"])
        self.train_step.count = int(ckpt["step"])
        self.ckpt.monitor.best = ckpt["monitor_best"]
        self.start_epoch = int(ckpt["epoch"]) + 1
        print(f"resumed from {tag}; continuing at epoch {self.start_epoch}")
        return self.start_epoch

    def train(self) -> dict:
        log = {}
        if self.init_val and self.valid_loaders and self.start_epoch == 1:
            log.update(self._valid_epoch(0))
        for epoch in range(self.start_epoch, self.epochs + 1):
            log = self._train_epoch(epoch)
            if self.valid_loaders:
                log.update(self._valid_epoch(epoch))
            if self.ckpt is not None:
                self.ckpt.save_epoch(epoch, self._state(), val_log=log)
            print(f"epoch {epoch}: " + ", ".join(
                f"{k}={v:.4f}" for k, v in log.items() if np.isscalar(v)))
        return log

    def _flush_aux(self, pending: list, totals: list) -> dict | None:
        """One device -> host copy of the buffered aux scalars: adds the
        losses to `totals`, writes them, and returns the last step's aux."""
        if not pending:
            return None
        rows = torch.stack([torch.stack([aux[k].float() for k in AUX_KEYS])
                            for _, _, aux in pending]).tolist()
        for (dl_idx, step, _), row in zip(pending, rows):
            totals[dl_idx] += row[0]
            if self.writer is not None:
                self.writer(f"loss_train_{dl_idx}", row[0], step)
        pending.clear()
        return dict(zip(AUX_KEYS, rows[-1]))

    def _train_epoch(self, epoch: int) -> dict:
        from tvts_torch.utils.profiling import annotate, trace

        for dl in self.data_loaders:
            dl.set_epoch(epoch)
        len_epoch = self._len_epoch()
        iters = [self._pipeline(dl) for dl in self.data_loaders]
        totals = [0.0] * len(self.data_loaders)
        t0 = time.time()
        pending = []  # (loader, step, aux of device scalars)
        prof = None
        try:
            for batch_idx in range(len_epoch):
                if (self.profile_dir is not None and epoch == self.start_epoch
                        and batch_idx == self.profile_steps[0]):
                    prof = trace(self.profile_dir)
                    prof.__enter__()
                for dl_idx in range(len(self.data_loaders)):
                    with annotate("data_wait"):
                        try:
                            batch = next(iters[dl_idx])
                        except StopIteration:
                            iters[dl_idx] = self._pipeline(self.data_loaders[dl_idx])
                            batch = next(iters[dl_idx])
                    aux = self.train_step(batch)
                    step = self.train_step.count
                    pending.append((dl_idx, step, aux))
                    if (self.save_every_steps and step % self.save_every_steps == 0
                            and self.ckpt is not None):
                        self._flush_aux(pending, totals)
                        self.ckpt.save_step(step, self._state(), epoch=epoch - 1)
                if batch_idx % self.log_step == 0:
                    last = self._flush_aux(pending, totals)
                    if last is not None:
                        print(f"Train Epoch: {epoch} [{batch_idx}/{len_epoch}] "
                              f"Loss_ct: {last['loss_ct']:.6f} Loss_ce: {last['loss_ce']:.6f} "
                              f"steps/s: {(batch_idx + 1) / (time.time() - t0):.2f}", flush=True)
                if prof is not None and batch_idx + 1 >= self.profile_steps[1]:
                    prof.__exit__(None, None, None)
                    prof = None
        finally:
            if prof is not None:  # a short epoch or a failure inside the window
                prof.__exit__(None, None, None)
        self._flush_aux(pending, totals)
        return {f"loss_{i}": totals[i] / len_epoch for i in range(len(self.data_loaders))}

    def _gather(self, rows: torch.Tensor) -> torch.Tensor:
        """Every data rank's rows, in rank order (this rank's alone without a
        group)."""
        with torch.no_grad():
            return all_gather_embeddings(rows, self.mesh.data_group) if self.mesh.distributed \
                else rows

    def _valid_epoch(self, epoch: int) -> dict:
        log = {}
        for dl_idx, dl in enumerate(self.valid_loaders):
            txts, vids, metas = [], [], []
            sort_correct, sort_num = 0.0, 0
            for raw in dl:
                batch = {k: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                         for k, a in prepare_batch(raw, self.context_length,
                                                   self.tokenize_fn).items()}
                out = self.eval_step(batch)
                txts.append(out["text_emb"].float())
                vids.append(out["video_emb"].float())
                metas.extend(raw.get("meta", []))
                if "sort_acc" in out:
                    bsz = batch["video"].shape[0]
                    sort_correct += out["sort_acc"].item() * bsz
                    sort_num += bsz
            if not txts:
                continue
            txt, vid = self._gather(torch.cat(txts)), self._gather(torch.cat(vids))
            if self.mesh.distributed:
                import torch.distributed as dist

                counts = torch.tensor([sort_correct, sort_num], dtype=torch.float64,
                                      device=self.device)
                dist.all_reduce(counts, group=self.mesh.data_group)
                sort_correct, sort_num = counts[0].item(), int(counts[1].item())
                gathered = [None] * self.mesh.data_size
                dist.all_gather_object(gathered, metas, group=self.mesh.data_group)
                metas = [m for part in gathered for m in part]
            sims = sim_matrix(txt.cpu(), vid.cpu()).numpy()
            log[f"val_loss_{dl_idx}"] = sort_correct / sort_num if sort_num else 1.0
            for name in VAL_METRICS:
                res = getattr(metrics_mod, name)(sims)
                verbose(epoch=epoch, metrics=res, name=f"val_{dl_idx}", mode=name)
                log[f"val_{dl_idx}_{name}_R1"] = res["R1"]
            if sort_num:
                acc = sort_correct / sort_num
                log[f"val_{dl_idx}_sort_acc"] = acc
                print(f"Top-1 Accuracy for Frame Prediction: {acc:.4f}")
            if self.visualizer is not None and metas:
                meta = {"paths": [m.get("paths", "") for m in metas],
                        "raw_captions": [m.get("raw_captions", "") for m in metas]}
                self.visualizer.visualize_ranking(sims, epoch, meta)
            if self.writer is not None:
                for k, v in log.items():
                    if np.isscalar(v):
                        self.writer(k, float(v), self.train_step.count)
        return log
