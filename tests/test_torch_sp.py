"""Sequence parallelism (the JAX `token_partition`, M2d-sp) on the CPU: eight
gloo ranks in fresh interpreters that never import JAX, spawned once for the
module, through three meshes in turn (tests/test_sequence_parallel.py's
setup: tiny_config("openai"), S = 9 tokens, so the pad rows run):
(a) dp 2 x sp 2 x tp 2: an SGD(lr=1) step of the eager model carrying the
    partition (a delta is a gradient: the stem's and the blocks' partial
    gradients summed over sp, the rest whole) and one AdamW step, against
    the JAX mesh step with `token_partition` on tests/conftest.py's CPU
    devices, computed once while the ranks run: each delta within 2e-5 of
    its tensor's largest, every updated parameter within 2e-5, the loss
    within 2e-5; the kernel path (`train_apply`, tokens whole on every sp
    rank, no sp sum) against the port's one-process kernel step; a
    checkpoint written under sp is the reference layout, reloads into each
    rank's slices bit for bit and steps on bit for bit;
(b) fsdp 2 x sp 2 x tp 2 (the dry run's n = 8) and sp 4 x tp 2 (2 local
    heads that sp 4 does not divide: the all-gather fallback), both against
    the port's one-process step, which the other port tests hold to JAX;
    the checkpoint of (a) loads into the fsdp 2 x sp 2 x tp 2 slices bit for
    bit;
(c) the mesh's rank order and groups, and the batch split over the data
    ranks only.
Plus the token shard's arithmetic and the partition's refusals in one
process.
"""

import sys

import numpy as np
import pytest
import torch

pytest.importorskip("cv2")

from tests.test_torch_distributed import REL, _close, _jax_side, registries  # noqa: E402,F401
from tests.test_torch_dryrun import start_ranks, wait_ranks  # noqa: E402
from tests.test_torch_tp import PREAMBLE, _common, _jax_mesh  # noqa: E402

WORLD = 8
ATOL = 2e-5  # an updated parameter against the reference step
SPEC = (("dp", "fsdp"), "sp", None)
MESHES = {"dp2_sp2_tp2": {"sp": 2, "tp": 2}, "fsdp2_sp2_tp2": {"fsdp": 2, "sp": 2, "tp": 2},
          "sp4_tp2": {"sp": 4, "tp": 2}}

WORKER = PREAMBLE + r"""
from tvts_torch.parallel import sequence_parallel as sp_mod

init = torch.load(os.path.join(work, "step.pth"))
whole_batch = {k: torch.from_numpy(v) for k, v in np.load(os.path.join(work, "ytt.npz")).items()}
meshes = json.loads(sys.argv[4])
ocfg = OptimizerConfig(text_layers=2, text_tune_layers=1)

calls = {}  # the sp Functions' forward calls over the last step
applies = {name: getattr(sp_mod, name).apply  # each bound to its class, before any is wrapped
           for name in ("_AllToAll", "_GatherTokens", "_GatherTokensSum")}
for name, apply in applies.items():
    def counting(*args, _apply=apply, _name=name):
        calls[_name] = calls.get(_name, 0) + 1
        return _apply(*args)
    getattr(sp_mod, name).apply = counting

def numpy(sd):  # copies: an unsharded parameter is its state_dict tensor, which steps on
    return {k: v.clone().numpy() for k, v in sd.items()}

def local(t):
    return (t.to_local() if hasattr(t, "to_local") else torch.as_tensor(t)).detach()

def model_on(mesh, partition=sp_mod.TOKEN_PARTITION):
    model = TVTSv2(make_config(spec["archs"]["STEP"]), token_partition=partition)
    model.load_state_dict(init)
    model.train()
    shard_params(model, mesh)
    return model

def sgd_delta(mesh, batch, apply_fn=None, partition=sp_mod.TOKEN_PARTITION):
    model = model_on(mesh, partition)
    trainable = [p for p in model.parameters() if p.requires_grad]
    sgd = torch.optim.SGD([{"params": trainable, "lr": 1.0, "base_lr": 1.0}])
    calls.clear()
    aux = make_train_step(model, sgd, OptimizerConfig(), apply_fn=apply_fn, mesh=mesh)(batch)
    return {"delta": {k: (v - init[k]).numpy() for k, v in full_state_dict(model).items()},
            "aux": {k: v.item() for k, v in aux.items()}, "calls": dict(calls)}

def adamw(mesh, batch):
    model = model_on(mesh)
    opt = make_optimizer(model, ocfg)
    step = make_train_step(model, opt, ocfg, mesh=mesh)
    aux = {k: v.item() for k, v in step(batch).items()}
    return model, opt, step, {"params": numpy(full_state_dict(model)), "aux": aux}

def same(a, b):
    return all(torch.equal(local(x), local(y)) for x, y in zip(a.parameters(), b.parameters()))

out = {}
for name, axes in meshes.items():
    with create_mesh(**axes, coordinator=f"localhost:{port(name)}", num_processes=world,
                     process_id=rank, device="cpu") as mesh:
        res = out[name] = {}
        res["mesh"] = [mesh.dp, mesh.fsdp, mesh.sp, mesh.tp, mesh.data_rank,
                       dist.get_rank(mesh.sp_group), dist.get_world_size(mesh.sp_group),
                       dist.get_rank(mesh.tp_group), dist.get_rank(mesh.data_group)]
        batch = shard_batch(whole_batch, mesh)
        res["rows"] = batch["video"].reshape(len(batch["video"]), -1)[:, :4].tolist()
        res["sgd"] = sgd_delta(mesh, batch)
        model, opt, step, res["adamw"] = adamw(mesh, batch)
        path = os.path.join(work, "ckpt", "checkpoint-epoch1.pth")
        if name == "dp2_sp2_tp2":
            res["kernels"] = sgd_delta(mesh, batch, train_apply, partition=None)
            ckpt = CheckpointManager(os.path.join(work, "ckpt"), arch="TVTSv2_TINY_STEP",
                                     writes=rank == 0)
            ckpt.save_epoch(1, {"model": model, "optimizer": opt, "step": step.count})
            dist.barrier()
        saved = torch.load(path, map_location="cpu", weights_only=True)
        again = model_on(mesh)
        opt2 = make_optimizer(again, ocfg)
        load_full_state_dict(again, {k.removeprefix("module."): v
                                     for k, v in saved["state_dict"].items()})
        load_full_optimizer_state(opt2, saved["optimizer"])
        res["reloaded"] = all(torch.equal(v, saved["state_dict"][f"module.{k}"])
                              for k, v in full_state_dict(again).items())
        if name == "dp2_sp2_tp2":  # the same layout: the state and the next step bit for bit
            step2 = make_train_step(again, opt2, ocfg, mesh=mesh)
            step2.count = saved["step"]
            res["resumed"] = same(again, model) and all(
                torch.equal(local(v), local(opt.state[p][k]))
                for q, p in zip(again.parameters(), model.parameters()) if p in opt.state
                for k, v in opt2.state[q].items())
            step(batch)
            step2(batch)
            res["resumed_step"] = same(again, model)
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


def _jax_sp_step(work) -> dict:
    """The JAX dp 2 x sp 2 x tp 2 mesh step with `token_partition`: the loss,
    the SGD(lr=1) delta and the AdamW step (the frozen text blocks' gradients
    stopped, as make_train_step's freeze mask stops them) in the reference
    layout."""
    import jax
    import optax

    from tvts_tpu.models.tvts_v2 import TVTSv2
    from tvts_tpu.parallel import shard_batch, shard_params
    from tvts_tpu.train.optim import OptimizerConfig, freeze_mask, make_optimizer
    from tvts_tpu.train.step import make_loss_fn
    from tvts_tpu.utils.torch_convert import export_state_dict

    plain, params, (ytt, _) = _jax_side(work)
    model = TVTSv2(plain.cfg, token_partition=SPEC)
    mesh = _jax_mesh(dp=2, sp=2, tp=2)
    with mesh:
        (_, aux), grads = jax.jit(jax.value_and_grad(make_loss_fn(model), has_aux=True))(
            shard_params(params, mesh), shard_batch(ytt, mesh))
    grads = jax.tree.map(np.asarray, grads)
    ocfg = OptimizerConfig(text_layers=2, text_tune_layers=1)
    tx = make_optimizer(params, ocfg)
    stopped = jax.tree.map(lambda g, f: np.zeros_like(g) if f else g, grads,
                           freeze_mask(params, ocfg))
    updates, _ = tx.update(stopped, tx.init(params), params)
    return {"aux": {k: float(v) for k, v in aux.items()},
            "sgd": export_state_dict(jax.tree.map(lambda g: -g, grads), ddp_prefix=False),
            "adamw": export_state_dict(jax.tree.map(np.asarray, optax.apply_updates(
                params, updates)), ddp_prefix=False)}


@pytest.fixture(scope="module")
def sp8(registries, tmp_path_factory):  # noqa: F811
    """(work dir, the 8 ranks' results over MESHES, the JAX sp step). The
    JAX step is computed while the ranks run."""
    import json

    work = tmp_path_factory.mktemp("sp")
    _common(work)
    (work / "sp_worker.py").write_text(WORKER)
    started = start_ranks([[sys.executable, str(work / "sp_worker.py"), str(r), str(WORLD),
                            str(work), json.dumps(MESHES)] for r in range(WORLD)], work)
    try:
        want = _jax_sp_step(work)
    finally:
        logs = wait_ranks(started, timeout=400)
    for rc, log in logs:
        assert rc == 0, log[-4000:]
    return work, [torch.load(work / f"out{r}.pt", weights_only=False) for r in range(WORLD)], want


@pytest.fixture(scope="module")
def one_process(sp8):
    """The port's unsharded steps on the whole batch: the eager SGD delta and
    AdamW step, and the kernel path's SGD delta."""
    from tvts_torch.models.tvts_v2 import TVTSv2
    from tvts_torch.ops.fused_forward import train_apply
    from tvts_torch.train.optim import OptimizerConfig, make_optimizer
    from tvts_torch.train.step import make_train_step

    work = sp8[0]
    init = torch.load(work / "step.pth")
    batch = {k: torch.from_numpy(v) for k, v in np.load(work / "ytt.npz").items()}

    def model():
        m = TVTSv2(_tiny())
        m.load_state_dict(init)
        return m.train()

    def sgd(apply_fn=None):
        m = model()
        opt = torch.optim.SGD([{"params": list(m.parameters()), "lr": 1.0, "base_lr": 1.0}])
        make_train_step(m, opt, OptimizerConfig(), apply_fn=apply_fn)(batch)
        return {k: (v - init[k]).numpy() for k, v in m.state_dict().items()}

    m = model()
    ocfg = OptimizerConfig(text_layers=2, text_tune_layers=1)
    aux = make_train_step(m, make_optimizer(m, ocfg), ocfg)(batch)
    return {"sgd": sgd(), "kernels": sgd(train_apply),
            "adamw": {k: v.numpy() for k, v in m.state_dict().items()},
            "loss": aux["loss"].item()}


def test_workers_never_import_jax(sp8):
    assert [out["jax_modules"] for out in sp8[1]] == [[]] * WORLD


# ---------------------------------------------------------------------------
# (c) the mesh
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", MESHES)
def test_mesh_rank_order_groups_and_the_data_split(sp8, name):
    work, outs, _ = sp8
    axes = {"dp": 1, "fsdp": 1, "sp": 1, "tp": 1, **MESHES[name]}
    axes["dp"] = WORLD // (axes["fsdp"] * axes["sp"] * axes["tp"])
    video = dict(np.load(work / "ytt.npz"))["video"]
    per = len(video) // (axes["dp"] * axes["fsdp"])
    for r, out in enumerate(outs):
        # r = ((d * fsdp + f) * sp + s) * tp + t, the JAX mesh's order
        t, s, data = r % axes["tp"], r // axes["tp"] % axes["sp"], r // (axes["tp"] * axes["sp"])
        assert out[name]["mesh"] == [axes["dp"], axes["fsdp"], axes["sp"], axes["tp"], data, s,
                                     axes["sp"], t, data]
        # the batch split over the data ranks and replicated over sp and tp
        np.testing.assert_array_equal(out[name]["rows"],
                                      video[data * per:(data + 1) * per].reshape(per, -1)[:, :4])


# ---------------------------------------------------------------------------
# (a) dp 2 x sp 2 x tp 2 against the JAX sp mesh step
# ---------------------------------------------------------------------------
def test_sp_sgd_step_equals_the_jax_sp_mesh_step(sp8):
    _, outs, want = sp8
    for out in outs:
        got = out["dp2_sp2_tp2"]["sgd"]
        _close(got["delta"], want["sgd"])  # the stem, blocks, ln_post / proj, text, sort
        for key in ("loss", "loss_ct", "loss_ce", "sort_acc"):
            np.testing.assert_allclose(got["aux"][key], want["aux"][key], rtol=REL)
        # 2 blocks x 2 attention modules x 2 all-to-alls, one gather before pool
        assert got["calls"] == {"_AllToAll": 8, "_GatherTokens": 1}


def test_sp_adamw_step_equals_the_jax_sp_mesh_step(sp8):
    _, outs, want = sp8
    for out in outs:
        got = out["dp2_sp2_tp2"]["adamw"]
        np.testing.assert_allclose(got["aux"]["loss"], want["aux"]["loss"], rtol=REL)
        assert sorted(got["params"]) == sorted(want["adamw"])
        for key, w in want["adamw"].items():
            np.testing.assert_allclose(got["params"][key], w, rtol=0, atol=ATOL, err_msg=key)


def test_kernel_step_on_the_sp_mesh_takes_whole_tokens(sp8, one_process):
    """train_apply under sp: the tokens whole on every sp rank, no sp sum."""
    for out in sp8[1]:
        got = out["dp2_sp2_tp2"]["kernels"]
        assert got["calls"] == {}
        _close(got["delta"], one_process["kernels"])


def test_checkpoint_under_sp_is_the_reference_layout(sp8):
    from tvts_torch.models.factory import build_model

    work, outs, _ = sp8
    for out in outs:
        assert out["dp2_sp2_tp2"]["resumed"] and out["dp2_sp2_tp2"]["resumed_step"]
        assert all(out[name]["reloaded"] for name in MESHES)
    path = work / "ckpt" / "checkpoint-epoch1.pth"
    _, model = build_model("TVTSv2_TINY_STEP", load_checkpoint=str(path), eval_mode=False,
                           device="cpu")
    for key, value in model.state_dict().items():
        assert np.array_equal(value.numpy(), outs[0]["dp2_sp2_tp2"]["adamw"]["params"][key]), key


# ---------------------------------------------------------------------------
# (b) fsdp 2 x sp 2 x tp 2 and the head fallback against one process
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,calls", [
    ("fsdp2_sp2_tp2", {"_AllToAll": 8, "_GatherTokens": 1}),
    ("sp4_tp2", {"_GatherTokensSum": 4, "_GatherTokens": 1}),  # 2 local heads over sp 4
])
def test_sp_steps_equal_the_unsharded_step(sp8, one_process, name, calls):
    for out in sp8[1]:
        got = out[name]
        assert got["sgd"]["calls"] == calls
        _close(got["sgd"]["delta"], one_process["sgd"])
        np.testing.assert_allclose(got["adamw"]["aux"]["loss"], one_process["loss"], rtol=REL)
        for key, w in one_process["adamw"].items():
            np.testing.assert_allclose(got["adamw"]["params"][key], w, rtol=0, atol=ATOL,
                                       err_msg=key)


# ---------------------------------------------------------------------------
# one process
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("size", [1, 2, 4])
def test_token_shard_splits_into_padded_contiguous_slices(size):
    from tvts_torch.parallel.sequence_parallel import TokenShard

    x = torch.randn(2, 9, 5)
    parts = [TokenShard(None, size, r, 9).split(x) for r in range(size)]
    local = -(-9 // size)
    assert all(p.shape == (2, local, 5) for p in parts)
    whole = torch.cat(parts, 1)
    assert torch.equal(whole[:, :9], x) and not whole[:, 9:].any()


def _tiny():
    from tests.test_torch_distributed import make_config, step_fields
    from tvts_torch.models import configs as pc

    return make_config(pc, step_fields())


def test_token_partition_takes_only_the_jax_spec():
    from tvts_torch.models.tvts_v2 import TVTSv2

    cfg = _tiny()
    for bad in (("dp", "sp", None), (("dp", "fsdp"), None, "sp")):
        with pytest.raises(ValueError, match="token_partition"):
            TVTSv2(cfg, token_partition=bad)
    model = TVTSv2(cfg, token_partition=[["dp", "fsdp"], "sp", None])
    assert model.video_model.token_partition == SPEC
    names = {n for n, p in model.named_parameters()
             if any(p is q for q in model.sp_parameters())}
    assert "video_model.conv1.weight" in names and "video_model.ln_pre.weight" in names
    assert not any(n.startswith(("video_model.ln_post", "video_model.proj", "text", "pred"))
                   for n in names)
    assert TVTSv2(cfg).sp_parameters() == []


def test_without_a_mesh_the_partition_runs_whole():
    from tvts_torch.models.tvts_v2 import TVTSv2

    cfg = _tiny()
    plain, parted = TVTSv2(cfg), TVTSv2(cfg, token_partition=SPEC)
    plain.reset_parameters(torch.Generator().manual_seed(0))
    parted.load_state_dict(plain.state_dict())
    rng = np.random.default_rng(0)
    v = cfg.vision
    video = torch.from_numpy(rng.normal(size=(2, v.num_frames, 3, v.input_resolution,
                                              v.input_resolution)).astype(np.float32))
    with torch.no_grad():
        a, b = plain.compute_video(video), parted.compute_video(video)
    assert all(torch.equal(x, y) for x, y in zip(a, b))



def test_remat_under_the_partition_on_one_rank():
    """On a 1-rank gloo group the sp code path runs at sp 1 (every
    collective a copy): the remat tower carrying the partition gives the
    step without either, bit for bit."""
    import socket

    from tvts_torch.models.tvts_v2 import TVTSv2
    from tvts_torch.parallel.mesh import create_mesh
    from tvts_torch.train.optim import OptimizerConfig
    from tvts_torch.train.step import make_train_step

    cfg = _tiny()
    v = cfg.vision
    rng = np.random.default_rng(3)
    batch = {"video": torch.from_numpy(rng.normal(size=(2, v.num_frames, 3, v.input_resolution,
                                                        v.input_resolution)).astype(np.float32)),
             "keep_ind": torch.from_numpy(np.stack([rng.permutation(v.patches_per_frame)[:v.n_keep]
                                                    for _ in range(2)])),
             "text_ids": torch.from_numpy(rng.integers(1, 119, (2 * cfg.num_clips, 16))),
             "labels": torch.from_numpy(np.tile(np.arange(cfg.num_clips), (2, 1)))}
    init = TVTSv2(cfg)
    init.reset_parameters(torch.Generator().manual_seed(0))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    deltas = []
    with create_mesh(coordinator=f"localhost:{port}", num_processes=1, process_id=0,
                     device="cpu") as mesh:
        for partition, remat, on in ((None, False, None), (SPEC, True, mesh)):
            model = TVTSv2(cfg, remat=remat, token_partition=partition)
            model.load_state_dict(init.state_dict())
            sgd = torch.optim.SGD([{"params": list(model.parameters()), "lr": 1.0,
                                    "base_lr": 1.0}])
            make_train_step(model, sgd, OptimizerConfig(), mesh=on)(batch)
            deltas.append(model.state_dict())
    for key, value in deltas[0].items():
        assert torch.equal(deltas[1][key], value), key
