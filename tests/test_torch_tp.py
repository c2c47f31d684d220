"""Tensor parallelism (`--tp`) on the CPU: gloo ranks in fresh interpreters
that never import JAX (spawned once a world for the module, as
tests/test_torch_fsdp.py spawns its own), held against the JAX package's
tp mesh steps on tests/conftest.py's CPU devices:
(a) which tensors are sharded: the port's tp set, mapped to the reference
    names through utils/convert.py, is the JAX rule's set (the leaves whose
    `param_shardings` spec names "tp") tower by tower, for TVTSv2 (video,
    text, sort) and TVTS v1 (JointViT, sort; DistilBERT none), on a
    dp 2 x fsdp 2 x tp 2 mesh;
(b) the plain step on dp 2 x fsdp 2 x tp 2, 8 ranks: an SGD(lr=1) step (a
    delta is a gradient) against `tests/test_train_step.py:140-141`'s JAX
    mesh step on `create_mesh(dp=2, fsdp=2, tp=2)`, within 2e-5 of each
    tensor's largest delta, the loss within 2e-5; then one AdamW step, every
    parameter within 1e-5; every rank holds its tp slice (the qkv rows of
    its heads), and a checkpoint written under tp x fsdp is the reference
    layout and reloads into each rank's slices bit for bit;
(c) the kernel path (`train_apply`; the kernels' plain versions on CPU
    tensors) on dp 1 x tp 2 against the JAX fused apply (Pallas in
    interpret mode) on the same mesh: the loss and an SGD delta within 2e-5
    of each tensor's largest, where that exceeds 1e-2 of the largest of
    all, else within 2e-5 of the largest of all;
(d) the train CLIs at `--tp 2` on 2 ranks against the JAX scripts at
    `--tp 2` on two CPU devices: every step's loss within 2e-5 and the
    validation logs (sort counts and similarity table over the data group)
    equal to 1e-6;
(e) the `--tp 2` epoch file loads strictly into an unsharded `build_model`,
    bit for bit the ranks' gathered parameters; `-r` under `--tp 2` restores
    parameters, AdamW state and step count bit for bit and runs epoch 2 as
    the straight run does.
"""

import json
import os
import random
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
    registries,  # noqa: F401  (a fixture)
    step_batches,
    step_fields,
    trainer_fields,
)
from tests.test_torch_dryrun import run_ranks  # noqa: E402
from tests.test_torch_fsdp import WORKER as FSDP_WORKER  # noqa: E402
from tests.test_torch_fsdp import _v1_fields  # noqa: E402
from tests.test_torch_trainer import (  # noqa: E402
    ARCH,
    fast_jax_init,
    pretrain_tree,
    seeded_checkpoint,
    write_config,
)

B = 2  # videos a data rank
ADAMW_ATOL = 1e-5  # a tenth of one AdamW step at lr_new (tests/test_torch_distributed.py)

# the fsdp worker's preamble: the rank's arguments, `port`, the tiny archs
PREAMBLE = FSDP_WORKER[:FSDP_WORKER.index("init = torch.load")]

ITEM_SEED = 1000  # a YT-Temporal item draws from random.seed(ITEM_SEED + its index)

WORKER = PREAMBLE + f"ITEM_SEED = {ITEM_SEED}\n" + r"""
from tvts_torch.parallel import tensor_parallel as tp

mode = sys.argv[4]
init = torch.load(os.path.join(work, "step.pth"))

def batch_of(name):
    return {k: torch.from_numpy(v) for k, v in np.load(os.path.join(work, name)).items()}

def numpy(sd):
    return {k: v.numpy() for k, v in sd.items()}

def local(t):
    return (t.to_local() if hasattr(t, "to_local") else torch.as_tensor(t)).detach()

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
    return {k: (v - init[k]).numpy() for k, v in full_state_dict(model).items()}, \
        {k: v.item() for k, v in aux.items()}

out = {}
if mode == "plain":  # (a), (b): dp 2 x fsdp 2 x tp 2
    with create_mesh(fsdp=2, tp=2, coordinator=f"localhost:{port('plain')}",
                     num_processes=world, process_id=rank, device="cpu") as mesh:
        dm = mesh.device_mesh
        out["mesh"] = [mesh.dp, mesh.fsdp, mesh.sp, mesh.tp, mesh.data_rank,
                       dist.get_rank(mesh.tp_group), dist.get_rank(mesh.data_group),
                       list(dm.mesh_dim_names), list(dm.shape)]
        ytt = shard_batch(batch_of("ytt.npz"), mesh)
        out["batch_rows"] = ytt["video"].reshape(len(ytt["video"]), -1)[:, :4].tolist()
        model = sharded_model(mesh, perturb=True)
        out["tp_names"] = sorted(tp.layouts(model))
        out["broadcast"] = all(torch.equal(v, init[k]) for k, v in full_state_dict(model).items())
        qkv = model.video_model.transformer.resblocks[0].attn.qkv.weight
        out["qkv_local"] = [list(qkv.shape), local(qkv).clone().numpy()]
        out["sgd"], out["sgd_aux"] = sgd_delta(model, ytt)
        model = sharded_model(mesh)
        ocfg = OptimizerConfig(text_layers=2, text_tune_layers=1)
        opt = make_optimizer(model, ocfg)
        step = make_train_step(model, opt, ocfg, mesh=mesh)
        out["adamw_aux"] = {k: v.item() for k, v in step(ytt).items()}
        out["adamw"] = numpy(full_state_dict(model))
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
        out["resumed"] = all(torch.equal(local(a), local(b)) for a, b in
                             zip(again.parameters(), model.parameters())) and all(
            type(v) is type(opt.state[p][k]) and torch.equal(local(v), local(opt.state[p][k]))
            for q, p in zip(again.parameters(), model.parameters()) if p in opt.state
            for k, v in opt2.state[q].items())
        step(ytt)
        step2(ytt)
        out["resumed_step"] = all(torch.equal(local(a), local(b)) for a, b in
                                  zip(again.parameters(), model.parameters()))
else:  # (c), (d), (e): dp 1 x tp 2
    with create_mesh(tp=2, coordinator=f"localhost:{port('kernels')}", num_processes=world,
                     process_id=rank, device="cpu") as mesh:
        ytt = shard_batch(batch_of("ytt.npz"), mesh)
        out["kernels"] = sgd_delta(sharded_model(mesh), ytt, train_apply)

    from tvts_torch.data import ytt as ytt_mod
    from tvts_torch.train import step as step_mod, trainer as trainer_mod

    get_item = ytt_mod.YTTemporal.__getitem__

    def item_of(self, item):  # an item is the same whichever run loads it, as in the JAX runs
        random.seed(ITEM_SEED + item)
        return get_item(self, item)

    ytt_mod.YTTemporal.__getitem__ = item_of

    steps, vals, resume_state = [], [], {}
    call, resume = step_mod.TrainStep.__call__, trainer_mod.Trainer.resume
    valid = trainer_mod.Trainer._valid_epoch

    def recorded(self, batch):
        aux = call(self, batch)
        steps.append({k: v.item() for k, v in aux.items()})
        return aux

    def recorded_valid(self, epoch):
        log = valid(self, epoch)
        vals.append((epoch, {k: float(v) for k, v in log.items() if np.isscalar(v)}))
        return log

    def checked_resume(self, tag=None):
        nxt = resume(self, tag)
        saved = torch.load(tag, map_location="cpu", weights_only=True)
        whole = full_state_dict(self.model)
        opt = full_optimizer_state(self.optimizer)["state"]
        resume_state.update(
            parameters=all(torch.equal(v, saved["state_dict"][f"module.{k}"])
                           for k, v in whole.items()),
            adamw=sorted(opt) == sorted(saved["optimizer"]["state"]) and all(
                torch.equal(torch.as_tensor(v),
                            torch.as_tensor(saved["optimizer"]["state"][i][k]))
                for i, st in opt.items() for k, v in st.items()),
            step=[self.train_step.count, saved["step"]], next_epoch=nxt)
        return nxt

    step_mod.TrainStep.__call__ = recorded
    trainer_mod.Trainer._valid_epoch = recorded_valid
    trainer_mod.Trainer.resume = checked_resume

    def run(cli, argv, name):
        steps.clear()
        vals.clear()
        trainer = cli.main([*argv, "--device", "cpu", "--no-bf16", "--tp", "2", "--coordinator",
                            f"localhost:{port(name)}", "--num_processes", str(world),
                            "--process_id", str(rank)])
        model = trainer.model
        return {"steps": list(steps), "vals": list(vals), "count": trainer.train_step.count,
                "save_dir": trainer.ckpt.save_dir,
                "local": {k: local(v).numpy() for k, v in model.state_dict().items()},
                "kinds": {k: kind for k, (kind, _) in tp.layouts(model).items()}}

    from tvts_torch.cli import train_dist_TVTS as v1_cli, train_dist_TVTSv2 as v2_cli
    from tvts_torch.models import distilbert, tvts_v1

    cli_runs = {"v2": run(v2_cli, ["-c", os.path.join(work, "v2.json")], "v2")}
    # each rank names its run directory by its own clock: the epoch file is in rank 0's
    epoch1 = os.path.join(published("v2.save_dir", str(cli_runs["v2"]["save_dir"])),
                          "checkpoint-epoch1.pth")
    cli_runs["v2_resumed"] = run(v2_cli, ["-c", os.path.join(work, "resumed.json"), "-r", epoch1],
                                 "v2_resumed")
    cli_runs["v2_resumed"]["resume"] = dict(resume_state)
    v1 = spec["v1"]
    v1_cli.TVTSv1Config = lambda num_frames=16: tvts_v1.TVTSv1Config(
        **{**v1, "num_frames": num_frames, "text": distilbert.DistilBertConfig(**v1["text"])})
    cli_runs["v1"] = run(v1_cli, ["-c", os.path.join(work, "v1.json"), "--bert_vocab",
                                  os.path.join(work, "vocab.txt")], "v1_tp")
    out["cli"] = cli_runs
out["jax_modules"] = sorted(m for m in sys.modules
                            if m.split(".")[0] in ("jax", "flax", "optax", "orbax", "tvts_tpu"))
torch.save(out, os.path.join(work, f"out{rank}.pt"))
"""


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spawn(work, world: int, mode: str, timeout: float) -> list:
    logs = run_ranks([[sys.executable, str(work / "worker.py"), str(r), str(world), str(work),
                       mode] for r in range(world)], work, timeout=timeout)
    for rc, log in logs:
        assert rc == 0, log[-4000:]
    return [torch.load(work / f"out{r}.pt", weights_only=False) for r in range(world)]


def _common(work):
    from tvts_torch.models.factory import build_model

    cfg, _ = build_model("TVTSv2_TINY_STEP", eval_mode=False, device="cpu")
    seeded_checkpoint(work / "step.pth", arch="TVTSv2_TINY_STEP")
    for name, batch in zip(("ytt", "webvid"), step_batches(cfg)):
        np.savez(work / f"{name}.npz", **batch)
    with open(work / "spec.json", "w") as f:
        json.dump({"archs": {"STEP": step_fields(), "TVTSv2_TINY_TRAIN": trainer_fields()},
                   "v1": _v1_fields()}, f)
    with open(work / "worker.py", "w") as f:
        f.write(WORKER)


@pytest.fixture(scope="module")
def plain8(registries, tmp_path_factory):  # noqa: F811
    """(work dir, the 8 ranks' results) of dp 2 x fsdp 2 x tp 2."""
    work = tmp_path_factory.mktemp("tp_plain")
    _common(work)
    return work, _spawn(work, 8, "plain", timeout=400)


def _v1_config(work, base, ckpt):
    """v1-dist-yt-pt.json over the tiny tree's YT-Temporal videos."""
    ytt = base["data_loader"][0]["args"]
    args = {k: ytt[k] for k in ("data_dir", "meta_root", "num_workers", "batch_size", "reader")}
    args.update(patches_per_frame=4, mask_ratio=0.5,
                video_params={"input_res": 32, "num_frames": 4, "loading": "lax"})
    path = chip_smoke.v1_config(str(work / "v1.json"), chip_smoke.V1_CONFIG, {"YTTemporal": args},
                                {"epochs": 1, "save_dir": str(work / "v1")})
    config = json.loads(open(path).read())
    config["arch"]["args"]["load_checkpoint"] = ckpt
    with open(path, "w") as f:
        json.dump(config, f)


@pytest.fixture(scope="module")
def two(registries, tmp_path_factory):  # noqa: F811
    """(work dir, the 2 ranks' results) of dp 1 x tp 2: the kernel step, the
    CLIs and the resume."""
    from tests.test_wordpiece import VOCAB
    from tvts_torch.models import distilbert, tvts_v1

    work = tmp_path_factory.mktemp("tp_two")
    _common(work)
    base = pretrain_tree(work / "data", B, n_ytt=2 * B, n_webvid=B, val=B)
    init = seeded_checkpoint(work / "trainer.pth")
    for name in ("v2", "resumed"):
        write_config(base, work / f"{name}.json", work / name, loaders=1, checkpoint=init,
                     epochs=2)
    fields = _v1_fields()
    model = tvts_v1.TVTSv1(tvts_v1.TVTSv1Config(**{
        **fields, "num_frames": 16, "text": distilbert.DistilBertConfig(**fields["text"])}))
    model.reset_parameters(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(4)
    torch.save({k: v + 0.02 * torch.randn(v.shape, generator=gen)
                for k, v in model.state_dict().items()}, work / "v1.pth")
    _v1_config(work, base, str(work / "v1.pth"))
    (work / "vocab.txt").write_text("\n".join(VOCAB + sorted(set(chip_smoke.WORDS))) + "\n")
    return work, _spawn(work, 2, "two", timeout=400)


def _jax_mesh(**axes):
    import jax

    from tvts_tpu.parallel import create_mesh

    n = int(np.prod(list(axes.values())))
    return create_mesh(devices=jax.devices()[:n], **axes)


def test_workers_never_import_jax(plain8, two):
    assert [out["jax_modules"] for out in plain8[1] + two[1]] == [[]] * 10


# ---------------------------------------------------------------------------
# (a) which tensors are sharded
# ---------------------------------------------------------------------------
def _jax_tp_set(params, convert) -> set:
    """The reference names of the JAX leaves whose sharding names "tp" on a
    dp 2 x fsdp 2 x tp 2 mesh."""
    import jax

    from tvts_tpu.parallel.partition import param_shardings

    def names_tp(spec) -> bool:
        axes = [a for entry in spec if entry is not None
                for a in (entry if isinstance(entry, tuple) else (entry,))]
        return "tp" in axes

    specs = param_shardings(params, _jax_mesh(dp=2, fsdp=2, tp=2))
    flags = jax.tree.map(lambda p, s: np.full(np.shape(p), float(names_tp(s.spec))), params, specs)
    return {k for k, v in convert(flags).items() if v.size and v.flat[0] == 1.0}


def _by_tower(names) -> dict:
    towers: dict = {}
    for name in names:
        towers.setdefault(name.split(".")[0], set()).add(name)
    return towers


def test_the_tp_set_is_the_jax_rules_for_v2(plain8):
    from tvts_torch.models.tvts_v2 import TVTSv2
    from tvts_torch.parallel.tensor_parallel import shardable
    from tvts_torch.utils.convert import state_dict_from_jax

    work, outs = plain8
    _, params, _ = _jax_side(work)
    want = _jax_tp_set(params, state_dict_from_jax)
    towers = _by_tower(want)
    assert sorted(towers) == ["pred_model", "text_model", "video_model"]
    assert any(".timeattn." in n for n in towers["video_model"])
    from tvts_torch.models import configs

    model = TVTSv2(configs.MODEL_REGISTRY["TVTSv2_TINY_STEP"]())
    got = {f"{name}.{key}" for name, m in shardable(model, 2, 2) for key in m.TP_LAYOUT}
    assert _by_tower(got) == towers
    for out in outs:  # what tp_shard sharded on the 8 ranks
        assert _by_tower(out["tp_names"]) == towers


def test_the_tp_set_is_the_jax_rules_for_v1():
    import jax

    from tests.test_torch_v1 import inputs, jax_module, tiny_config
    from tvts_torch.models import distilbert, tvts_v1
    from tvts_torch.parallel.tensor_parallel import shardable
    from tvts_torch.utils.convert import v1_state_dict_from_jax

    jax_v1 = jax_module("models.tvts_v1")
    jcfg = tiny_config(jax_v1.TVTSv1Config, jax_module("models.distilbert").DistilBertConfig)
    video, keep, ids, mask = inputs(tiny_config(tvts_v1.TVTSv1Config,
                                                distilbert.DistilBertConfig))
    shapes = jax.eval_shape(lambda: jax_v1.TVTSv1(jcfg).init(
        jax.random.PRNGKey(0), video[:1], ids[:4], mask[:4], keep[:1])["params"])
    params = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    want = _jax_tp_set(params, v1_state_dict_from_jax)
    towers = _by_tower(want)
    assert sorted(towers) == ["pred_model", "video_model"]  # no DistilBERT tensor
    model = tvts_v1.TVTSv1(tiny_config(tvts_v1.TVTSv1Config, distilbert.DistilBertConfig))
    got = {f"{name}.{key}" for name, m in shardable(model, 2, 2) for key in m.TP_LAYOUT}
    assert got == want


def test_tp_layouts_round_trip_and_fall_back_where_heads_do_not_divide():
    """shard / assemble invert each other; a qkv slice is its heads' q, k and
    v rows; 3 heads over tp 2 stay replicated (module notes)."""
    from tvts_torch.models.layers import VarAttention
    from tvts_torch.parallel.tensor_parallel import assemble, shard, shardable

    H, d, size = 4, 8, 2
    full = torch.arange(3 * H * d * 5, dtype=torch.float32).reshape(3 * H * d, 5)
    for kind, t in (("qkv", full), ("col", full), ("row", full.t().contiguous()),
                    ("qkv", full[:, 0]), ("col", full[:, 0])):
        parts = [shard(t, kind, r, size) for r in range(size)]
        assert torch.equal(assemble(torch.stack(parts), kind), t), kind
    q, k, v = shard(full, "qkv", 1, size).chunk(3)
    assert torch.equal(q, full[H // size * d:H * d]) and torch.equal(k, full[(H + 2) * d:2 * H * d])
    assert torch.equal(v, full[(2 * H + 2) * d:])
    assert shardable(VarAttention(24, 3), 2) == [] and len(shardable(VarAttention(24, 4), 2)) == 1


# ---------------------------------------------------------------------------
# (b) the plain step on dp 2 x fsdp 2 x tp 2
# ---------------------------------------------------------------------------
def test_mesh_rank_order_and_the_data_split(plain8):
    work, outs = plain8
    ytt = dict(np.load(work / "ytt.npz"))["video"]
    for r, out in enumerate(outs):
        d, t = r // 2, r % 2  # ((d * fsdp + f) * sp + s) * tp + t, the JAX order
        assert out["mesh"] == [2, 2, 1, 2, d, t, d, ["dp", "fsdp", "sp", "tp"], [2, 2, 1, 2]]
        # tp ranks take the same rows: the data rank's quarter of the batch
        np.testing.assert_array_equal(out["batch_rows"],
                                      ytt[d:d + 1].reshape(1, -1)[:, :4])
        assert out["broadcast"]


def test_each_rank_holds_the_qkv_rows_of_its_heads(plain8):
    work, outs = plain8
    init = torch.load(work / "step.pth")["video_model.transformer.resblocks.0.attn.qkv.weight"]
    D, heads = init.shape[1], 4
    d = D // heads
    for r, out in enumerate(outs):
        shape, local = out["qkv_local"]
        t = r % 2
        assert shape == [3 * D // 2, D]  # the tp slice; FSDP2 keeps half of its rows
        rows = [init[j * D + (t * heads // 2) * d:j * D + (t + 1) * heads // 2 * d]
                for j in range(3)]
        f = (r // 2) % 2
        np.testing.assert_array_equal(local, torch.cat(rows).chunk(2)[f].numpy())


def test_plain_sgd_step_equals_the_jax_tp_mesh_step(plain8):
    import jax
    import optax

    from tvts_tpu.parallel import shard_batch, shard_params
    from tvts_tpu.train.step import create_train_state, make_train_step
    from tvts_tpu.utils.torch_convert import export_state_dict

    work, outs = plain8
    model, params, (ytt, _) = _jax_side(work)
    tx = optax.sgd(1.0)
    mesh = _jax_mesh(dp=2, fsdp=2, tp=2)
    with mesh:
        state = create_train_state(shard_params(params, mesh), tx)
        state, aux = make_train_step(model, tx, donate=False)(state, shard_batch(ytt, mesh))
    delta = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b), state.params, params)
    want = export_state_dict(delta, ddp_prefix=False)
    for out in outs:
        _close(out["sgd"], want)
        for key in ("loss", "loss_ct", "loss_ce", "sort_acc"):
            np.testing.assert_allclose(out["sgd_aux"][key], float(aux[key]), rtol=REL)


def test_plain_adamw_step_equals_the_jax_tp_mesh_step(plain8):
    import jax

    from tvts_tpu.parallel import shard_batch, shard_params
    from tvts_tpu.train.optim import OptimizerConfig, freeze_mask, make_optimizer
    from tvts_tpu.train.step import create_train_state, make_train_step
    from tvts_tpu.utils.torch_convert import export_state_dict

    work, outs = plain8
    model, params, (ytt, _) = _jax_side(work)
    ocfg = OptimizerConfig(text_layers=2, text_tune_layers=1)
    tx = make_optimizer(params, ocfg)
    mesh = _jax_mesh(dp=2, fsdp=2, tp=2)
    with mesh:
        state = create_train_state(shard_params(params, mesh), tx)
        step = make_train_step(model, tx, donate=False, freeze_mask=freeze_mask(params, ocfg))
        state, aux = step(state, shard_batch(ytt, mesh))
    want = export_state_dict(jax.tree.map(np.asarray, state.params), ddp_prefix=False)
    for out in outs:
        np.testing.assert_allclose(out["adamw_aux"]["loss"], float(aux["loss"]), rtol=REL)
        assert sorted(out["adamw"]) == sorted(want)
        for key, w in want.items():
            np.testing.assert_allclose(out["adamw"][key], w, rtol=0, atol=ADAMW_ATOL,
                                       err_msg=key)


def test_checkpoint_under_tp_and_fsdp_is_the_reference_layout(plain8):
    from tvts_torch.models.factory import build_model

    work, outs = plain8
    assert all(out["resumed"] and out["resumed_step"] for out in outs)
    path = work / "ckpt" / "checkpoint-epoch1.pth"
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    _, model = build_model("TVTSv2_TINY_STEP", load_checkpoint=str(path), eval_mode=False,
                           device="cpu")
    for key, value in model.state_dict().items():
        assert np.array_equal(value.numpy(), outs[0]["adamw"][key]), key
    # the optimizer state in the unsharded layout: every moment a whole tensor's shape
    shapes = {tuple(st["exp_avg"].shape) for st in ckpt["optimizer"]["state"].values()}
    assert shapes <= {tuple(v.shape) for v in model.state_dict().values()}


# ---------------------------------------------------------------------------
# (c) the kernel path on dp 1 x tp 2
# ---------------------------------------------------------------------------
def test_kernel_step_equals_the_jax_fused_apply_on_the_tp_mesh(two):
    import jax
    import jax.numpy as jnp

    from tvts_tpu.models import configs as jax_configs
    from tvts_tpu.ops.fused_forward import make_fused_train_apply
    from tvts_tpu.parallel import shard_batch, shard_params
    from tvts_tpu.train.step import make_loss_fn
    from tvts_tpu.utils.torch_convert import export_state_dict

    work, outs = two
    model, params, (ytt, _) = _jax_side(work)
    cfg = jax_configs.MODEL_REGISTRY["TVTSv2_TINY_STEP"]()
    v = cfg.vision
    mesh = _jax_mesh(dp=1, tp=2)
    apply_fn = make_fused_train_apply(
        model, cfg, num_frames=v.num_frames, n_keep=v.n_keep, dtype=jnp.float32, time_chunk=8,
        space_mode="pallas_v10", space_fpp=4, time_mode="pallas_tps", text_mode="pallas",
        sort_mode="pallas", interpret=True, mesh=mesh)
    with mesh:
        (loss, aux), grads = jax.jit(jax.value_and_grad(
            make_loss_fn(model, apply_fn=apply_fn), has_aux=True))(
            shard_params(params, mesh), shard_batch(ytt, mesh))
    want = export_state_dict(jax.tree.map(lambda g: -np.asarray(g), grads), ddp_prefix=False)
    top = max(float(np.abs(w).max()) for w in want.values())
    for out in outs:
        got, got_aux = out["kernels"]
        np.testing.assert_allclose(got_aux["loss"], float(loss), rtol=REL)
        assert sorted(got) == sorted(want)
        for key, w in want.items():
            scale = float(np.abs(w).max())
            # the zero-init time attention's tiny gradients: held to the global scale
            atol = REL * (scale if scale > 1e-2 * top else top) + 1e-7
            np.testing.assert_allclose(got[key], w, rtol=0, atol=atol, err_msg=key)


# ---------------------------------------------------------------------------
# (d), (e) the train CLIs at --tp 2
# ---------------------------------------------------------------------------
def _reseeded(mp):
    """The JAX package's YT-Temporal items drawn as the workers draw theirs."""
    from tvts_tpu.data import ytt

    get_item = ytt.YTTemporal.__getitem__

    def item_of(self, item):
        random.seed(ITEM_SEED + item)
        return get_item(self, item)

    mp.setattr(ytt.YTTemporal, "__getitem__", item_of)


def _two_device_mesh(mp):
    import jax

    import tvts_tpu.parallel as parallel

    original = parallel.create_mesh
    mp.setattr(parallel, "create_mesh", lambda **kw: original(devices=jax.devices()[:2], **kw))


def test_v2_cli_at_tp_2_matches_the_jax_script(two):
    from tests.test_torch_cli import load_script
    from tests.test_torch_trainer import record_run
    from tvts_tpu.train import trainer as jax_trainer
    from tvts_tpu.utils import logging as jax_logging

    work, outs = two
    config = json.loads(open(work / "v2.json").read())
    config["trainer"]["save_dir"] = str(work / "jax_v2")
    with open(work / "jax_v2.json", "w") as f:
        json.dump(config, f)
    mp = pytest.MonkeyPatch()
    try:
        fast_jax_init(mp)
        _two_device_mesh(mp)
        _reseeded(mp)
        mp.setattr(sys, "argv", ["train", "-c", str(work / "jax_v2.json"), "--no-bf16",
                                 "--tp", "2"])
        want = record_run(jax_trainer.Trainer, jax_logging.ScalarWriter,
                          load_script("train_dist_TVTSv2").main)
    finally:
        mp.undo()
    losses = [v for *_, v in want.losses()]
    assert len(losses) == 2 * 2  # 2 epochs x 2 YT-Temporal batches
    for out in outs:
        run = out["cli"]["v2"]
        assert run["count"] == len(run["steps"]) == len(losses)
        np.testing.assert_allclose([s["loss"] for s in run["steps"]], losses, rtol=0, atol=REL)
        assert [e for e, _ in run["vals"]] == [e for e, _ in want.val] == [0, 1, 2]
        for (_, g), (_, w) in zip(run["vals"], want.val):
            assert sorted(g) == sorted(w) and "val_0_sort_acc" in g
            for key in w:
                assert g[key] == pytest.approx(w[key], abs=1e-6), key


def test_v1_cli_at_tp_2_matches_the_jax_script(two):
    from tests.test_torch_cli import load_script
    from tests.test_torch_v1 import jax_module
    from tests.test_torch_v1_train import _f32_zero_init_jax, _recorded, _tiny

    work, outs = two
    config = json.loads(open(work / "v1.json").read())
    config["trainer"]["save_dir"] = str(work / "jax_v1")
    with open(work / "jax_v1.json", "w") as f:
        json.dump(config, f)
    want = []
    mp = pytest.MonkeyPatch()
    try:
        _f32_zero_init_jax(mp)
        _two_device_mesh(mp)
        _reseeded(mp)
        mp.setattr(jax_module("models.tvts_v1"), "TVTSv1Config",
                   _tiny(jax_module("models.tvts_v1"), jax_module("models.distilbert")))
        _recorded(mp, jax_module("train.trainer"), "make_train_step", want)
        mp.setattr(sys, "argv", ["train_dist_TVTS", "-c", str(work / "jax_v1.json"),
                                 "--bert_vocab", str(work / "vocab.txt"), "--tp", "2"])
        load_script("train_dist_TVTS").main()
    finally:
        mp.undo()
    for out in outs:
        got = out["cli"]["v1"]["steps"]
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert g.keys() == w.keys() and g["loss_ce"] > 0
            for k in w:
                assert g[k] == pytest.approx(w[k], abs=REL), k


def _assembled(outs, run: str) -> dict:
    """The whole state of a CLI run from the two ranks' local tensors."""
    from tvts_torch.parallel.tensor_parallel import assemble

    first, second = outs[0]["cli"][run], outs[1]["cli"][run]
    kinds = first["kinds"]
    assert kinds and kinds == second["kinds"]
    return {k: assemble(torch.stack([torch.from_numpy(v), torch.from_numpy(second["local"][k])]),
                        kinds[k]) if k in kinds else torch.from_numpy(v)
            for k, v in first["local"].items()}


def test_tp_2_epoch_file_loads_unsharded_bit_for_bit_and_resume_reshards(two):
    from tvts_torch.models import distilbert, tvts_v1
    from tvts_torch.models.factory import build_model, build_v1_model

    work, outs = two
    runs = outs[0]["cli"]
    # the epoch file: the reference layout, the ranks' slices put together, bit for bit
    _, model = build_model(ARCH, eval_mode=False, device="cpu", load_checkpoint=os.path.join(
        runs["v2"]["save_dir"], "checkpoint-epoch2.pth"))
    whole = _assembled(outs, "v2")
    for key, value in model.state_dict().items():
        assert torch.equal(whole[key], value), key
    fields = _v1_fields()
    cfg = tvts_v1.TVTSv1Config(**{**fields, "num_frames": 16,
                                  "text": distilbert.DistilBertConfig(**fields["text"])})
    v1 = build_v1_model(cfg, device="cpu", load_checkpoint=os.path.join(
        runs["v1"]["save_dir"], "checkpoint-epoch1.pth"))
    whole = _assembled(outs, "v1")
    assert not any(k.startswith("text_model.") for k in outs[0]["cli"]["v1"]["kinds"])
    for key, value in v1.state_dict().items():
        assert torch.equal(whole[key], value), key
    # -r under --tp 2 re-shards the file: state and epoch 2 as the straight run's
    for out in outs:
        runs = out["cli"]
        res = runs["v2_resumed"]["resume"]
        assert res["parameters"] and res["adamw"] and res["next_epoch"] == 2
        assert res["step"] == [2, 2]
        assert runs["v2_resumed"]["steps"] == runs["v2"]["steps"][2:]
        assert runs["v2_resumed"]["vals"] == runs["v2"]["vals"][2:]
        assert runs["v2_resumed"]["count"] == runs["v2"]["count"]
    straight = torch.load(os.path.join(outs[0]["cli"]["v2"]["save_dir"], "checkpoint-epoch2.pth"),
                          weights_only=True)
    resumed = torch.load(os.path.join(outs[0]["cli"]["v2_resumed"]["save_dir"],
                                      "checkpoint-epoch2.pth"), weights_only=True)
    for key, value in straight["state_dict"].items():
        assert torch.equal(resumed["state_dict"][key], value), key
