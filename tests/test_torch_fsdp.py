"""Parameter and optimizer-state sharding (`--fsdp`) on the CPU: two gloo
ranks in fresh interpreters that never import JAX (spawned once for the
module, as tests/test_torch_distributed.py spawns its own), held against the
JAX package's fsdp mesh step on two of tests/conftest.py's CPU devices:
(a) `create_mesh(fsdp=2)`: dp 1 x fsdp 2, a ("dp", "fsdp") DeviceMesh;
    every rank starts from rank 0's weights;
(b) one SGD(lr=1) step of the sharded model, so a delta is a gradient,
    against JAX `make_train_step` on `create_mesh(dp=1, fsdp=2)` with
    `shard_params`: the gradient of the whole batch's loss, within 2e-5 of
    each tensor's largest delta; then two AdamW steps (a YT-Temporal batch,
    then a WebVid one without sort labels) against the JAX optimizer; each
    rank holds its half of every large matrix and of its moments;
(c) the kernel path's plain versions (`train_apply` on CPU tensors, the
    checkpointed plain time sub-path, a frozen text block) under fsdp 2
    against the eager sharded step: an SGD delta within 2e-5, then two
    steps of the bf16-first-moment AdamW (`mu_dtype="bfloat16"`);
(d) a checkpoint written under fsdp 2 holds full tensors in the reference
    layout; a fresh sharded model and optimizer loaded from it hold each
    rank's shards bit for bit, and step on bit for bit;
(e) the train CLIs on 2 ranks: `train_dist_TVTSv2 --fsdp 2` against
    `--fsdp 1` (the dp step) step by step and in the epoch file a strict
    `build_model` loads; `-r` under `--fsdp 2` restores parameters, AdamW
    state and step count bit for bit and continues as the straight run;
    `train_dist_TVTS --fsdp 2` against `--fsdp 1`.
Plus `create_mesh`'s refusals (fsdp or tp that does not divide the world;
sp).
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("cv2")

import chip_smoke  # noqa: E402
from tests.test_torch_distributed import (  # noqa: E402
    REL,
    _close,
    _jax_side,
    _moment,
    make_config,
    registries,
    step_batches,
    step_fields,
    trainer_fields,
)
from tests.test_torch_dryrun import run_ranks  # noqa: E402
from tests.test_torch_trainer import pretrain_tree, seeded_checkpoint, write_config  # noqa: E402

WORLD = 2
B = 2  # videos a rank
ADAMW_ATOL = 1e-5  # a tenth of one AdamW step at lr_new (tests/test_torch_distributed.py)

WORKER = r"""
import dataclasses, json, os, random, socket, sys, time
from functools import partial
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
spec = json.load(open(os.path.join(work, "spec.json")))

def port(name):
    # rank 0 picks a free port just before the group starts and publishes it:
    # a port picked long before may meanwhile serve another connection
    path = os.path.join(work, f"{name}.port")
    if rank == 0:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            free = s.getsockname()[1]
        with open(path + ".tmp", "w") as f:
            f.write(str(free))
        os.replace(path + ".tmp", path)
        return free
    for _ in range(6000):
        if os.path.exists(path):
            return int(open(path).read())
        time.sleep(0.05)
    raise TimeoutError(path)

from tvts_torch.models import configs as pc

def make_config(f):
    return pc.TVTSv2Config(name=f["name"], vision=pc.VisionConfig(**f["vision"]),
                           text=pc.TextConfig(**f["text"]), sort=pc.SortConfig(**f["sort"]))

for arch, fields in spec["archs"].items():
    pc.MODEL_REGISTRY[arch] = lambda f=fields: make_config(f)
from tvts_torch.models.tvts_v2 import TVTSv2
from tvts_torch.ops.fused_forward import train_apply
from tvts_torch.parallel.mesh import create_mesh
from tvts_torch.parallel.partition import (full_optimizer_state, full_state_dict, is_sharded,
                                           load_full_optimizer_state, load_full_state_dict,
                                           shard_batch, shard_params)
from tvts_torch.train.optim import OptimizerConfig, make_optimizer
from tvts_torch.train.step import make_train_step
from tvts_torch.utils.checkpoint import CheckpointManager

init = torch.load(os.path.join(work, "step.pth"))

def batch_of(name):
    return {k: torch.from_numpy(v) for k, v in np.load(os.path.join(work, name)).items()}

def numpy(sd):
    return {k: v.numpy() for k, v in sd.items()}

def named_state(model, opt, key):
    state = full_optimizer_state(opt)["state"]
    index = {id(p): i for i, p in enumerate(p for g in opt.param_groups for p in g["params"])}
    return {n: state[index[id(p)]][key].float().numpy() for n, p in model.named_parameters()
            if id(p) in index and index[id(p)] in state}

def sharded_model(mesh, perturb=False):
    model = TVTSv2(make_config(spec["archs"]["STEP"]))
    model.load_state_dict(init)
    model.train()
    if perturb and rank:  # other weights here: shard_params must give this rank rank 0's
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1.0)
    shard_params(model, mesh)
    assert is_sharded(model)
    return model

def sgd_delta(model, batch, apply_fn=None):
    trainable = [p for p in model.parameters() if p.requires_grad]
    sgd = torch.optim.SGD([{"params": trainable, "lr": 1.0, "base_lr": 1.0}])
    aux = make_train_step(model, sgd, OptimizerConfig(), apply_fn=apply_fn, mesh=mesh)(batch)
    return {k: (v - init[k]).numpy() for k, v in full_state_dict(model).items()}, aux

out = {}
with create_mesh(fsdp=2, coordinator=f"localhost:{port('steps')}", num_processes=world,
                 process_id=rank, device="cpu") as mesh:
    dm = mesh.device_mesh
    out["mesh"] = [mesh.dp, mesh.fsdp, list(dm.mesh_dim_names), dm.mesh.tolist()]
    ytt, web = shard_batch(batch_of("ytt.npz"), mesh), shard_batch(batch_of("webvid.npz"), mesh)
    # (a), (b) rank 0's weights, sharded; one SGD delta
    model = sharded_model(mesh, perturb=True)
    out["broadcast"] = all(torch.equal(v, init[k]) for k, v in full_state_dict(model).items())
    out["param_numel"] = {n: [p.to_local().numel(), p.numel()] for n, p in model.named_parameters()}
    out["sgd"], aux = sgd_delta(model, ytt)
    out["sgd_aux"] = {k: v.item() for k, v in aux.items()}
    # two AdamW steps, then a checkpoint written under fsdp 2 (d)
    model = sharded_model(mesh)
    ocfg = OptimizerConfig(text_layers=2, text_tune_layers=1)
    opt = make_optimizer(model, ocfg)
    step = make_train_step(model, opt, ocfg, mesh=mesh)
    step(ytt)
    step(web)
    out["adamw"] = numpy(full_state_dict(model))
    out["moments"] = {m: named_state(model, opt, key)
                      for m, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq"))}
    out["moment_numel"] = {n: [opt.state[p]["exp_avg"].to_local().numel(), p.numel()]
                           for n, p in model.named_parameters() if p in opt.state}
    ckpt = CheckpointManager(os.path.join(work, "ckpt"), arch="TVTSv2_TINY_STEP",
                             writes=rank == 0)
    ckpt.save_epoch(1, {"model": model, "optimizer": opt, "step": step.count})
    dist.barrier()
    saved = ckpt.restore("checkpoint-epoch1")
    again = sharded_model(mesh)
    opt2 = make_optimizer(again, ocfg)
    load_full_state_dict(again, {k.removeprefix("module."): v
                                 for k, v in saved["state_dict"].items()})
    load_full_optimizer_state(opt2, saved["optimizer"])
    step2 = make_train_step(again, opt2, ocfg, mesh=mesh)
    step2.count = saved["step"]
    local = lambda t: t.to_local() if hasattr(t, "to_local") else torch.as_tensor(t)
    out["resumed"] = all(torch.equal(local(a), local(b)) for a, b in
                         zip(again.parameters(), model.parameters())) and all(
        type(v) is type(opt.state[p][k]) and torch.equal(local(v), local(opt.state[p][k]))
        for q, p in zip(again.parameters(), model.parameters()) if p in opt.state
        for k, v in opt2.state[q].items())
    step(ytt)
    step2(ytt)
    out["resumed_step"] = all(torch.equal(a.to_local(), b.to_local()) for a, b in
                              zip(again.parameters(), model.parameters()))
    # (c) the kernel path's plain versions against the eager path, both sharded
    kernels = partial(train_apply, time_kernel=False, text_tune_from=1)
    bf16 = OptimizerConfig(text_layers=2, text_tune_layers=1, mu_dtype="bfloat16")
    for label, apply_fn in (("eager", None), ("kernels", kernels)):
        model = sharded_model(mesh)
        opt = make_optimizer(model, bf16)  # freezes text block 0, as text_tune_from=1
        delta, aux = sgd_delta(model, ytt, apply_fn)
        load_full_state_dict(model, init)
        step = make_train_step(model, opt, bf16, apply_fn=apply_fn, mesh=mesh)
        step(ytt)
        step(web)
        out[label] = {"sgd": delta, "loss": aux["loss"].item(),
                      "adamw": numpy(full_state_dict(model)),
                      "mu_dtype": str(next(iter(opt.state.values()))["mu"].dtype),
                      "nu": named_state(model, opt, "nu")}
    out["mu_numel"] = {n: [opt.state[p]["mu"].to_local().numel(), p.numel()]
                       for n, p in model.named_parameters() if p in opt.state}

# (e) the train CLIs: --fsdp 2 and --fsdp 1 on the same 2 ranks
from tvts_torch.data import datasets as datasets_mod, ytt as ytt_mod
from tvts_torch.train import step as step_mod, trainer as trainer_mod

def reseeded(cls, seed):  # an item is the same whichever rank or run loads it
    get_item = cls.__getitem__

    def item_of(self, item):
        random.seed(seed + item)
        return get_item(self, item)

    cls.__getitem__ = item_of

reseeded(ytt_mod.YTTemporal, 1000)
reseeded(datasets_mod.WebVid, 2000)
steps, resume_state = [], {}
call, resume = step_mod.TrainStep.__call__, trainer_mod.Trainer.resume

def recorded(self, batch):
    aux = call(self, batch)
    steps.append({k: v.item() for k, v in aux.items()})
    return aux

def checked_resume(self, tag=None):
    nxt = resume(self, tag)
    saved = torch.load(tag, map_location="cpu", weights_only=True)
    full = full_state_dict(self.model)
    opt = full_optimizer_state(self.optimizer)["state"]
    resume_state.update(
        parameters=all(torch.equal(v, saved["state_dict"][f"module.{k}"])
                       for k, v in full.items()),
        adamw=sorted(opt) == sorted(saved["optimizer"]["state"]) and all(
            torch.equal(torch.as_tensor(v), torch.as_tensor(saved["optimizer"]["state"][i][k]))
            for i, st in opt.items() for k, v in st.items()),
        step=[self.train_step.count, saved["step"]], next_epoch=nxt)
    return nxt

step_mod.TrainStep.__call__ = recorded
trainer_mod.Trainer.resume = checked_resume

def run(cli, argv, name):
    steps.clear()
    trainer = cli.main([*argv, "--device", "cpu", "--no-bf16", "--coordinator",
                        f"localhost:{port(name)}", "--num_processes", str(world),
                        "--process_id", str(rank)])
    return {"steps": list(steps), "count": trainer.train_step.count,
            "save_dir": trainer.ckpt.save_dir}

from tvts_torch.cli import train_dist_TVTS as v1_cli, train_dist_TVTSv2 as v2_cli
from tvts_torch.models import distilbert, tvts_v1

cli_runs = {}
for name, config, fsdp in (("v2_fsdp2", "fsdp2.json", "2"), ("v2_fsdp1", "fsdp1.json", "1")):
    cli_runs[name] = run(v2_cli, ["-c", os.path.join(work, config), "--fsdp", fsdp], name)
epoch1 = os.path.join(cli_runs["v2_fsdp2"]["save_dir"], "checkpoint-epoch1.pth")
cli_runs["v2_resumed"] = run(v2_cli, ["-c", os.path.join(work, "resumed.json"), "--fsdp", "2",
                                      "-r", epoch1], "v2_resumed")
cli_runs["v2_resumed"]["resume"] = dict(resume_state)
v1 = spec["v1"]
v1_cli.TVTSv1Config = lambda num_frames=16: tvts_v1.TVTSv1Config(
    **{**v1, "num_frames": num_frames, "text": distilbert.DistilBertConfig(**v1["text"])})
for name, config, fsdp in (("v1_fsdp2", "v1_fsdp2.json", "2"),
                           ("v1_fsdp1", "v1_fsdp1.json", "1")):
    cli_runs[name] = run(v1_cli, ["-c", os.path.join(work, config), "--fsdp", fsdp,
                                  "--bert_vocab", os.path.join(work, "vocab.txt")], name)
out["cli"] = cli_runs
out["jax_modules"] = sorted(m for m in sys.modules
                            if m.split(".")[0] in ("jax", "flax", "optax", "orbax", "tvts_tpu"))
torch.save(out, os.path.join(work, f"out{rank}.pt"))
"""


def _v1_fields():
    """tests/test_torch_v1.py's tiny v1 arch at the tree's 32², as a dict."""
    from tests.test_torch_v1 import tiny_config
    from tvts_torch.models import distilbert, tvts_v1

    cfg = tiny_config(tvts_v1.TVTSv1Config, distilbert.DistilBertConfig)
    return dataclasses.asdict(dataclasses.replace(cfg, img_size=32))


def _v1_configs(work, base, ckpt):
    """v1-dist-yt-pt.json over the tiny tree's YT-Temporal videos, one epoch."""
    ytt = base["data_loader"][0]["args"]
    args = {k: ytt[k] for k in ("data_dir", "meta_root", "num_workers", "batch_size", "reader")}
    args.update(patches_per_frame=4, mask_ratio=0.5,
                video_params={"input_res": 32, "num_frames": 4, "loading": "lax"})
    for fsdp in (1, 2):
        path = chip_smoke.v1_config(str(work / f"v1_fsdp{fsdp}.json"), chip_smoke.V1_CONFIG,
                                    {"YTTemporal": args},
                                    {"epochs": 1, "save_dir": str(work / f"v1_{fsdp}")})
        config = json.loads(open(path).read())
        config["arch"]["args"]["load_checkpoint"] = ckpt
        with open(path, "w") as f:
            json.dump(config, f)


@pytest.fixture(scope="module")
def ranks(registries, tmp_path_factory):
    """Run the worker on WORLD gloo ranks; (work dir, each rank's results)."""
    from tests.test_wordpiece import VOCAB
    from tvts_torch.models import distilbert, tvts_v1
    from tvts_torch.models.factory import build_model

    work = tmp_path_factory.mktemp("fsdp")
    cfg, _ = build_model("TVTSv2_TINY_STEP", eval_mode=False, device="cpu")
    seeded_checkpoint(work / "step.pth", arch="TVTSv2_TINY_STEP")
    for name, batch in zip(("ytt", "webvid"), step_batches(cfg)):
        np.savez(work / f"{name}.npz", **batch)
    base = pretrain_tree(work / "data", B, n_ytt=2 * WORLD * B, n_webvid=WORLD * B,
                         val=WORLD * B)
    init = seeded_checkpoint(work / "trainer.pth")
    for name in ("fsdp2", "fsdp1", "resumed"):
        write_config(base, work / f"{name}.json", work / name, checkpoint=init, epochs=2)
    fields = _v1_fields()
    model = tvts_v1.TVTSv1(tvts_v1.TVTSv1Config(**{
        **fields, "num_frames": 16, "text": distilbert.DistilBertConfig(**fields["text"])}))
    model.reset_parameters(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(4)
    torch.save({k: v + 0.02 * torch.randn(v.shape, generator=gen)
                for k, v in model.state_dict().items()}, work / "v1.pth")
    _v1_configs(work, base, str(work / "v1.pth"))
    (work / "vocab.txt").write_text("\n".join(VOCAB + sorted(set(chip_smoke.WORDS))) + "\n")
    with open(work / "spec.json", "w") as f:
        json.dump({"archs": {"STEP": step_fields(), "TVTSv2_TINY_TRAIN": trainer_fields()},
                   "v1": _v1_fields()}, f)
    with open(work / "worker.py", "w") as f:
        f.write(WORKER)
    logs = run_ranks([[sys.executable, str(work / "worker.py"), str(r), str(WORLD), str(work)]
                      for r in range(WORLD)], work, timeout=400)
    for rc, log in logs:
        assert rc == 0, log[-4000:]
    return work, [torch.load(work / f"out{r}.pt", weights_only=False) for r in range(WORLD)]


def test_workers_never_import_jax(ranks):
    _, outs = ranks
    assert [out["jax_modules"] for out in outs] == [[], []]


def test_mesh_and_rank0_weights(ranks):
    _, outs = ranks
    for out in outs:
        assert out["mesh"] == [1, 2, ["dp", "fsdp", "sp", "tp"], [[[[0]], [[1]]]]]
        assert out["broadcast"]


def test_each_rank_holds_half_of_each_matrix_and_its_moments(ranks):
    """The parameters, AdamW's moments and the bf16 first moment of the
    mu_dtype optimizer, each cut in two over the fsdp ranks."""
    _, outs = ranks
    for key in ("param_numel", "moment_numel", "mu_numel"):
        per_rank = [out[key] for out in outs]
        assert sorted(per_rank[0]) == sorted(per_rank[1])
        for name, (local, total) in per_rank[0].items():
            assert local + per_rank[1][name][0] == total, (key, name)
            if total >= 1024:  # a large matrix: split in two halves (torch.chunk's rows)
                assert abs(local - total / 2) <= total / 2 / 8, (key, name, local, total)
    assert per_rank[0]["text_token_embedding.weight"][0] < per_rank[0][
        "text_token_embedding.weight"][1]


def _jax_fsdp_mesh():
    import jax

    from tvts_tpu.parallel import create_mesh

    return create_mesh(dp=1, fsdp=WORLD, devices=jax.devices()[:WORLD])


def test_fsdp_sgd_step_equals_the_jax_fsdp_step(ranks):
    import jax
    import optax

    from tvts_tpu.parallel import shard_batch, shard_params
    from tvts_tpu.train.step import create_train_state, make_train_step
    from tvts_tpu.utils.torch_convert import export_state_dict

    work, outs = ranks
    model, params, (ytt, _) = _jax_side(work)
    tx = optax.sgd(1.0)
    mesh = _jax_fsdp_mesh()
    with mesh:
        state = create_train_state(shard_params(params, mesh), tx)
        state, aux = make_train_step(model, tx, donate=False)(state, shard_batch(ytt, mesh))
    delta = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b), state.params, params)
    want = export_state_dict(delta, ddp_prefix=False)
    for out in outs:
        _close(out["sgd"], want)
        for key in ("loss", "loss_ct", "loss_ce", "sort_acc"):
            np.testing.assert_allclose(out["sgd_aux"][key], float(aux[key]), rtol=1e-5)


def test_fsdp_adamw_steps_equal_the_jax_fsdp_steps(ranks):
    import jax

    from tvts_tpu.parallel import shard_batch, shard_params
    from tvts_tpu.train.optim import OptimizerConfig, freeze_mask, make_optimizer
    from tvts_tpu.train.step import create_train_state, make_train_step
    from tvts_tpu.utils.torch_convert import export_state_dict

    work, outs = ranks
    model, params, batches = _jax_side(work)
    ocfg = OptimizerConfig(text_layers=2, text_tune_layers=1)
    tx = make_optimizer(params, ocfg)
    mesh = _jax_fsdp_mesh()
    with mesh:
        state = create_train_state(shard_params(params, mesh), tx)
        step = make_train_step(model, tx, donate=False, freeze_mask=freeze_mask(params, ocfg))
        for batch in batches:
            state, _ = step(state, shard_batch(batch, mesh))
    want = export_state_dict(jax.tree.map(np.asarray, state.params), ddp_prefix=False)
    moments = {m: export_state_dict(_moment(state.opt_state, m), ddp_prefix=False)
               for m in ("mu", "nu")}
    for out in outs:
        _close(out["moments"]["mu"], moments["mu"])
        _close(out["moments"]["nu"], moments["nu"], rel=2 * REL)
        assert sorted(out["adamw"]) == sorted(want)
        for key, w in want.items():
            np.testing.assert_allclose(out["adamw"][key], w, rtol=0, atol=ADAMW_ATOL,
                                       err_msg=key)


def test_kernel_path_plain_versions_equal_the_eager_path_under_fsdp(ranks):
    _, outs = ranks
    for out in outs:
        eager, kernels = out["eager"], out["kernels"]
        assert kernels["loss"] == pytest.approx(eager["loss"], abs=1e-5)
        _close(kernels["sgd"], eager["sgd"])
        assert kernels["mu_dtype"] == eager["mu_dtype"] == "torch.bfloat16"
        _close(kernels["nu"], eager["nu"], rel=2 * REL)
        for key, w in eager["adamw"].items():
            np.testing.assert_allclose(kernels["adamw"][key], w, rtol=0, atol=ADAMW_ATOL,
                                       err_msg=key)
        # the frozen text block took no update on either path
        key = "text_model.resblocks.0.attn.in_proj_weight"
        assert np.array_equal(kernels["adamw"][key], eager["adamw"][key])


def test_checkpoint_under_fsdp_reloads_into_shards_bit_for_bit(ranks):
    from tvts_torch.models.factory import build_model

    work, outs = ranks
    assert all(out["resumed"] and out["resumed_step"] for out in outs)
    path = work / "ckpt" / "checkpoint-epoch1.pth"
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    assert ckpt["step"] == 2 and ckpt["arch"] == "TVTSv2_TINY_STEP"
    # the unsharded layout: full tensors, an int-keyed optimizer state
    _, model = build_model("TVTSv2_TINY_STEP", load_checkpoint=str(path), eval_mode=False,
                           device="cpu")
    for key, value in model.state_dict().items():
        assert np.array_equal(value.numpy(), outs[0]["adamw"][key]), key
    assert all(isinstance(i, int) for i in ckpt["optimizer"]["state"])
    shapes = {tuple(st["exp_avg"].shape) for st in ckpt["optimizer"]["state"].values()}
    assert shapes <= {tuple(v.shape) for v in model.state_dict().values()}


def _relative_close(got: dict, want: dict, rel=REL):
    for key, w in want.items():
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(got[key], w, rtol=0, atol=rel * scale + 1e-7, err_msg=key)


def test_train_clis_under_fsdp_2_match_fsdp_1(ranks):
    from tvts_torch.models.factory import build_model

    work, outs = ranks
    for out in outs:
        runs = out["cli"]
        for arch in ("v2", "v1"):
            got, want = runs[f"{arch}_fsdp2"], runs[f"{arch}_fsdp1"]
            assert got["count"] == want["count"] == len(want["steps"]) > 0
            for g, w in zip(got["steps"], want["steps"]):
                assert g.keys() == w.keys()
                for k in w:
                    assert g[k] == pytest.approx(w[k], abs=REL), (arch, k)
        assert any(s["loss_ce"] == 0 for s in runs["v2_fsdp2"]["steps"])  # WebVid steps
    # the epoch files, strictly loaded: the fsdp 2 run's within 1e-5 of the dp run's
    models = {name: build_model("TVTSv2_TINY_TRAIN", eval_mode=False, device="cpu",
                                load_checkpoint=os.path.join(
                                    outs[0]["cli"][f"v2_{name}"]["save_dir"],
                                    "checkpoint-epoch2.pth"))[1].state_dict()
              for name in ("fsdp2", "fsdp1")}
    for key, w in models["fsdp1"].items():
        np.testing.assert_allclose(models["fsdp2"][key].numpy(), w.numpy(), rtol=0,
                                   atol=ADAMW_ATOL, err_msg=key)


def test_resume_under_fsdp_is_bit_for_bit(ranks):
    _, outs = ranks
    for out in outs:
        runs = out["cli"]
        res = runs["v2_resumed"]["resume"]
        n = len(runs["v2_fsdp2"]["steps"]) // 2
        assert res["parameters"] and res["adamw"] and res["next_epoch"] == 2
        assert res["step"] == [n, n]
        # epoch 2 after the resume steps as the straight run's epoch 2, bit for bit
        assert runs["v2_resumed"]["steps"] == runs["v2_fsdp2"]["steps"][n:]
        assert runs["v2_resumed"]["count"] == runs["v2_fsdp2"]["count"]
    straight = torch.load(os.path.join(outs[0]["cli"]["v2_fsdp2"]["save_dir"],
                                       "checkpoint-epoch2.pth"), weights_only=True)
    resumed = torch.load(os.path.join(outs[0]["cli"]["v2_resumed"]["save_dir"],
                                      "checkpoint-epoch2.pth"), weights_only=True)
    for key, value in straight["state_dict"].items():
        assert torch.equal(resumed["state_dict"][key], value), key
    for i, state in straight["optimizer"]["state"].items():
        for key, value in state.items():
            assert torch.equal(torch.as_tensor(resumed["optimizer"]["state"][i][key]),
                               torch.as_tensor(value)), (i, key)


def test_create_mesh_refuses_what_it_cannot_shard():
    from tvts_torch.parallel.mesh import create_mesh

    with pytest.raises(ValueError, match="does not divide"):
        create_mesh(fsdp=2, device="cpu")
    with pytest.raises(ValueError, match="does not divide"):
        create_mesh(fsdp=2, coordinator="localhost:1", num_processes=3, process_id=0,
                    device="cpu")
    with pytest.raises(ValueError, match="does not divide"):
        create_mesh(tp=2, coordinator="localhost:1", num_processes=3, process_id=0,
                    device="cpu")
    with pytest.raises(NotImplementedError, match="M2d-sp"):
        create_mesh(device="cpu", sp=2)
