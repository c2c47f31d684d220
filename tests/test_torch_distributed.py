"""Data-parallel training over torch.distributed on the CPU: two gloo ranks in
fresh interpreters (they import torch and the port, never JAX), spawned
once for the module as tests/test_multiprocess.py spawns its workers, held
against the JAX package on a 2-device mesh of tests/conftest.py's CPU
devices:
(a) `all_gather_embeddings` and `pmean`, forward and backward: the JAX
    transposes (reduce_scatter SUM; the cotangent's sum over ranks / world);
(b) the sharded step with SGD(lr=1) on both sides, so a parameter's delta is
    its gradient, against `make_sharded_train_step` with `optax.sgd(1.0)`,
    within 2e-5 of each tensor's largest delta; that delta is world x the
    gradient of the whole batch in one process; then two AdamW steps (a
    YT-Temporal batch, then a WebVid one, which leaves the sort head without
    a gradient) against the JAX optimizer; `shard_params` gives every rank
    rank 0's weights;
(b') the step the Trainer builds over the same mesh, with SGD(lr=1), against
    the JAX package's `make_train_step` on a 2-device dp mesh (what its
    Trainer runs): the gradient of the whole batch's loss, 1x;
(c) the Trainer through the train CLI on 2 ranks: disjoint training indices,
    the validation metrics of the init validation equal to a one-process run
    on the same val set (each item reseeds `random` from its index, so an
    item is the same whichever rank loads it), model_best.pth written once,
    by rank 0.
"""

import json
import os
import random
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("cv2")

from tests.test_torch_trainer import pretrain_tree, seeded_checkpoint, write_config  # noqa: E402
from tvts_torch.models import configs as port_configs  # noqa: E402

WORLD = 2
B = 2  # videos a rank
REL = 2e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def step_fields():
    """A small TVTSv2 (tests/test_tvtsv2_parity.py's tiny_config("openai"))."""
    return dict(
        name="tiny_step",
        vision=dict(input_resolution=32, patch_size=16, width=64, layers=2, heads=4,
                    output_dim=48, num_frames=4, mask_ratio=0.5, pool_style="openai",
                    act="quick_gelu"),
        text=dict(context_length=16, vocab_size=120, width=64, layers=2, heads=4, output_dim=48),
        sort=dict(embed_dim=48, num_heads=4, num_classes=4))


def trainer_fields():
    from tests.test_torch_trainer import tiny_config

    cfg = tiny_config(port_configs)
    return dict(name=cfg.name, vision=vars(cfg.vision), text=vars(cfg.text), sort=vars(cfg.sort))


def make_config(mod, f):
    return mod.TVTSv2Config(name=f["name"], vision=mod.VisionConfig(**f["vision"]),
                            text=mod.TextConfig(**f["text"]), sort=mod.SortConfig(**f["sort"]))


WORKER = r"""
import json, os, random, socket, sys, time
import numpy as np
import torch

torch.set_num_threads(1)
rank, world, port_a, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]

def published_port(name):
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

spec = json.load(open(os.path.join(work, "spec.json")))
from tvts_torch.models import configs as pc

def make_config(f):
    return pc.TVTSv2Config(name=f["name"], vision=pc.VisionConfig(**f["vision"]),
                           text=pc.TextConfig(**f["text"]), sort=pc.SortConfig(**f["sort"]))

for arch, fields in spec["archs"].items():
    pc.MODEL_REGISTRY[arch] = lambda f=fields: make_config(f)
from tvts_torch.models.tvts_v2 import TVTSv2
from tvts_torch.parallel.collectives import all_gather_embeddings, pmean
from tvts_torch.parallel.mesh import create_mesh
from tvts_torch.parallel.partition import shard_batch, shard_params
from tvts_torch.train.optim import OptimizerConfig, make_optimizer
from tvts_torch.train.step import make_sharded_train_step

def batch_of(name):
    return {k: torch.from_numpy(v) for k, v in np.load(os.path.join(work, name)).items()}

out = {}
with create_mesh(coordinator=f"localhost:{port_a}", num_processes=world, process_id=rank,
                 device="cpu") as mesh:
    assert (mesh.rank, mesh.world, mesh.backend) == (rank, world, "gloo")
    # (a) the collectives
    x, w = torch.from_numpy(np.load(os.path.join(work, "x.npy"))), \
        torch.from_numpy(np.load(os.path.join(work, "w.npy")))
    xl = shard_batch({"video": x}, mesh)["video"].clone().requires_grad_()
    gathered = all_gather_embeddings(xl)
    loss = (gathered * w).sum() + pmean((xl ** 2).sum())
    loss.backward()
    out["collectives"] = {"gathered": gathered.detach().numpy(), "grad": xl.grad.numpy(),
                          "loss": loss.item()}
    # (b) the sharded step: SGD(lr=1), then AdamW on a YT-Temporal and a WebVid batch
    model = TVTSv2(make_config(spec["archs"]["STEP"]))
    init = torch.load(os.path.join(work, "step.pth"))
    model.load_state_dict(init)
    model.train()
    if rank:  # other weights here: shard_params must give this rank rank 0's
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1.0)
    shard_params(model, mesh)
    out["broadcast"] = all(torch.equal(v, init[k]) for k, v in model.state_dict().items())
    ytt, web = shard_batch(batch_of("ytt.npz"), mesh), shard_batch(batch_of("webvid.npz"), mesh)
    sgd = torch.optim.SGD([{"params": list(model.parameters()), "lr": 1.0, "base_lr": 1.0}])
    aux = make_sharded_train_step(model, sgd, OptimizerConfig(), mesh)(ytt)
    out["sgd"] = {k: (v - init[k]).numpy() for k, v in model.state_dict().items()}
    out["sgd_aux"] = {k: v.item() for k, v in aux.items()}
    # (b') the step the Trainer builds over the mesh, SGD(lr=1)
    from tvts_torch.train.trainer import Trainer

    model.load_state_dict(init)
    sgd = torch.optim.SGD([{"params": list(model.parameters()), "lr": 1.0, "base_lr": 1.0}])
    Trainer(model, sgd, OptimizerConfig(), [], mesh=mesh).train_step(ytt)
    out["trainer_sgd"] = {k: (v - init[k]).numpy() for k, v in model.state_dict().items()}
    model.load_state_dict(init)
    ocfg = OptimizerConfig(text_layers=2, text_tune_layers=1)
    step = make_sharded_train_step(model, make_optimizer(model, ocfg), ocfg, mesh)
    step(ytt)
    step(web)
    out["adamw"] = {k: v.numpy() for k, v in model.state_dict().items()}
    out["adamw_count"] = step.count
    state = step.optimizer.state
    out["moments"] = {m: {k: state[p][key].numpy() for k, p in model.named_parameters()
                          if p in state} for m, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq"))}

# (c) the Trainer through the train CLI
from tvts_torch.data import loader as loader_mod, ytt as ytt_mod
from tvts_torch.train import trainer as trainer_mod

indices, vals = [], []
local_indices, get_item = loader_mod.ShardedLoader._local_indices, ytt_mod.YTTemporal.__getitem__

def recorded_indices(self):
    idx = local_indices(self)
    if self.dataset.split == "train":
        indices.append([self.epoch, idx.tolist()])
    return idx

def reseeded_item(self, item):
    random.seed(1000 + item)
    return get_item(self, item)

valid_epoch = trainer_mod.Trainer._valid_epoch

def recorded_valid(self, epoch):
    log = valid_epoch(self, epoch)
    vals.append([epoch, log])
    return log

loader_mod.ShardedLoader._local_indices = recorded_indices
ytt_mod.YTTemporal.__getitem__ = reseeded_item
trainer_mod.Trainer._valid_epoch = recorded_valid
from tvts_torch.cli import train_dist_TVTSv2 as cli

trainer = cli.main(["-c", os.path.join(work, "trainer.json"), "--no-bf16", "--device", "cpu",
                    "--coordinator", f"localhost:{published_port('trainer')}",
                    "--num_processes", str(world),
                    "--process_id", str(rank)])
out["trainer"] = {"indices": indices, "val": vals, "count": trainer.train_step.count,
                  "writes": trainer.ckpt.writes, "writer": trainer.writer is not None}
out["jax_modules"] = sorted(m for m in sys.modules
                            if m.split(".")[0] in ("jax", "flax", "optax", "orbax", "tvts_tpu"))
torch.save(out, os.path.join(work, f"out{rank}.pt"))
"""


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def step_batches(cfg, seed=0):
    """A YT-Temporal batch of WORLD * B videos (4 clip-major transcripts each,
    sort labels) and a WebVid one (one caption each, no labels)."""
    rng = np.random.default_rng(seed)
    v, t = cfg.vision, cfg.text
    n = WORLD * B

    def ids(rows):
        a = rng.integers(1, t.vocab_size - 2, size=(rows, t.context_length)).astype(np.int32)
        a[:, -1] = t.vocab_size - 1
        return a

    def base():
        return {"video": rng.normal(size=(n, v.num_frames, 3, v.input_resolution,
                                          v.input_resolution)).astype(np.float32),
                "keep_ind": np.stack([np.sort(rng.permutation(v.patches_per_frame)[:v.n_keep])
                                      for _ in range(n)]).astype(np.int32)}

    ytt = dict(base(), text_ids=ids(cfg.num_clips * n),
               labels=np.stack([rng.permutation(cfg.num_clips) for _ in range(n)]).astype(np.int32))
    return ytt, dict(base(), text_ids=ids(n))


@pytest.fixture(scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def registries():
    from tvts_tpu.models import configs as jax_configs

    mp = pytest.MonkeyPatch()
    for arch, fields in (("TVTSv2_TINY_STEP", step_fields()),
                         ("TVTSv2_TINY_TRAIN", trainer_fields())):
        mp.setitem(jax_configs.MODEL_REGISTRY, arch, lambda f=fields: make_config(jax_configs, f))
        mp.setitem(port_configs.MODEL_REGISTRY, arch, lambda f=fields: make_config(port_configs, f))
    yield
    mp.undo()


@pytest.fixture(scope="module")
def ranks(one_thread, registries, tmp_path_factory):
    """Run the worker on WORLD gloo ranks; (work dir, each rank's results)."""
    from tvts_torch.models.factory import build_model

    work = tmp_path_factory.mktemp("ranks")
    rng = np.random.default_rng(5)
    np.save(work / "x.npy", rng.standard_normal((WORLD * B, 8)).astype(np.float32))
    np.save(work / "w.npy", rng.standard_normal((WORLD * B, 8)).astype(np.float32))
    cfg, _ = build_model("TVTSv2_TINY_STEP", eval_mode=False, device="cpu")
    seeded_checkpoint(work / "step.pth", arch="TVTSv2_TINY_STEP")
    for name, batch in zip(("ytt", "webvid"), step_batches(cfg)):
        np.savez(work / f"{name}.npz", **batch)
    base = pretrain_tree(work / "data", B, n_ytt=4 * B, n_webvid=B, val=4 * B)
    write_config(base, work / "trainer.json", work / "results", loaders=1, epochs=1,
                 checkpoint=seeded_checkpoint(work / "trainer.pth"))
    with open(work / "spec.json", "w") as f:
        json.dump({"archs": {"STEP": step_fields(), "TVTSv2_TINY_TRAIN": trainer_fields()}}, f)
    with open(work / "worker.py", "w") as f:
        f.write(WORKER)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, str(work / "worker.py"), str(r), str(WORLD), port,
                               str(work)], env=env, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return work, [torch.load(work / f"out{r}.pt", weights_only=False) for r in range(WORLD)]


def test_workers_never_import_jax(ranks):
    _, outs = ranks
    assert [out["jax_modules"] for out in outs] == [[], []]


def test_collectives_equal_the_jax_transposes(ranks):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from tvts_tpu.parallel.collectives import all_gather_embeddings

    work, outs = ranks
    x, w = np.load(work / "x.npy"), np.load(work / "w.npy")
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("dp",))

    def local(xl, w):  # the gradient taken on each device, as the sharded step takes it
        def loss(xl):
            gathered = all_gather_embeddings(xl, "dp")
            return jnp.sum(gathered * w) + jax.lax.pmean(jnp.sum(xl ** 2), "dp"), gathered

        (value, gathered), dx = jax.value_and_grad(loss, has_aux=True)(xl)
        return value, gathered, dx

    fn = jax.shard_map(local, mesh=mesh, in_specs=(P("dp"), P()),
                       out_specs=(P(), P(), P("dp")), check_vma=False)
    loss, gathered, grad = fn(x, w)
    for r, out in enumerate(outs):
        got = out["collectives"]
        np.testing.assert_allclose(got["gathered"], np.asarray(gathered), rtol=0, atol=0)
        np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-6)
        part = slice(r * B, (r + 1) * B)
        np.testing.assert_allclose(got["grad"], np.asarray(grad)[part], rtol=1e-6, atol=1e-6)
        # reduce_scatter SUM: world x the slice of w; pmean's backward: 1 x d(sum xl^2)
        np.testing.assert_allclose(got["grad"], WORLD * w[part] + 2 * x[part], rtol=1e-6,
                                   atol=1e-6)


def _jax_side(work):
    """(JAX model, its parameter tree from step.pth, the two batches)."""
    from tvts_tpu.models import configs as jax_configs
    from tvts_tpu.models.tvts_v2 import TVTSv2
    from tvts_tpu.utils.torch_convert import convert_state_dict

    cfg = jax_configs.MODEL_REGISTRY["TVTSv2_TINY_STEP"]()
    sd = {k: v.numpy() for k, v in torch.load(work / "step.pth").items()}
    batches = [dict(np.load(work / f"{n}.npz")) for n in ("ytt", "webvid")]
    return TVTSv2(cfg), convert_state_dict(sd), batches


def _close(got: dict, want: dict, rel=REL):
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(got[key], w, rtol=0, atol=rel * scale + 1e-7, err_msg=key)


def test_sharded_sgd_step_equals_jax_and_is_world_times_the_whole_batch_gradient(ranks):
    import jax
    import optax

    from tvts_tpu.parallel import create_mesh
    from tvts_tpu.train.step import create_train_state, make_sharded_train_step
    from tvts_tpu.utils.torch_convert import export_state_dict
    from tvts_torch.models.factory import build_model
    from tvts_torch.train.optim import OptimizerConfig
    from tvts_torch.train.step import make_train_step

    work, outs = ranks
    assert all(out["broadcast"] for out in outs)
    model, params, (ytt, _) = _jax_side(work)
    tx = optax.sgd(1.0)
    step = make_sharded_train_step(model, tx, create_mesh(devices=jax.devices()[:WORLD]),
                                   donate=False)
    state, aux = step(create_train_state(params, tx), ytt)
    delta = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b), state.params, params)
    want = export_state_dict(delta, ddp_prefix=False)
    for out in outs:
        _close(out["sgd"], want)
        for key in ("loss", "loss_ct", "loss_ce", "sort_acc"):
            np.testing.assert_allclose(out["sgd_aux"][key], float(aux[key]), rtol=1e-5)
    # the same SGD step on the whole batch in one process: half the delta
    _, whole = build_model("TVTSv2_TINY_STEP", load_checkpoint=str(work / "step.pth"),
                           eval_mode=False, device="cpu")
    init = {k: v.clone() for k, v in whole.state_dict().items()}
    sgd = torch.optim.SGD([{"params": list(whole.parameters()), "lr": 1.0, "base_lr": 1.0}])
    make_train_step(whole, sgd, OptimizerConfig())({k: torch.from_numpy(v) for k, v in ytt.items()})
    one = {k: WORLD * (v - init[k]).numpy() for k, v in whole.state_dict().items()}
    _close(outs[0]["sgd"], one)


def test_trainer_step_equals_the_jax_mesh_step(ranks):
    """The Trainer's step at world 2 updates with the gradient of the whole
    batch's loss, as the JAX Trainer's make_train_step over a dp mesh does
    (tvts_tpu/train/trainer.py:137-140); it once took the sharded
    step, 2x that gradient."""
    import jax
    import optax

    from tvts_tpu.parallel import create_mesh, shard_batch, shard_params
    from tvts_tpu.train.step import create_train_state, make_train_step
    from tvts_tpu.utils.torch_convert import export_state_dict

    work, outs = ranks
    model, params, (ytt, _) = _jax_side(work)
    tx = optax.sgd(1.0)
    mesh = create_mesh(dp=WORLD, devices=jax.devices()[:WORLD])
    with mesh:
        state = create_train_state(shard_params(params, mesh), tx)
        state, _ = make_train_step(model, tx, donate=False)(state, shard_batch(ytt, mesh))
    delta = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b), state.params, params)
    want = export_state_dict(delta, ddp_prefix=False)
    for out in outs:
        _close(out["trainer_sgd"], want)


def test_sharded_adamw_steps_equal_jax(ranks):
    import jax

    from tvts_tpu.parallel import create_mesh
    from tvts_tpu.train.optim import OptimizerConfig, freeze_mask, make_optimizer
    from tvts_tpu.train.step import create_train_state, make_sharded_train_step
    from tvts_tpu.utils.torch_convert import export_state_dict

    work, outs = ranks
    model, params, batches = _jax_side(work)
    ocfg = OptimizerConfig(text_layers=2, text_tune_layers=1)
    tx = make_optimizer(params, ocfg)
    step = make_sharded_train_step(model, tx, create_mesh(devices=jax.devices()[:WORLD]),
                                   donate=False, freeze_mask=freeze_mask(params, ocfg))
    state = create_train_state(params, tx)
    for batch in batches:
        state, _ = step(state, batch)
    want = export_state_dict(jax.tree.map(np.asarray, state.params), ddp_prefix=False)
    moments = {m: export_state_dict(_moment(state.opt_state, m), ddp_prefix=False)
               for m in ("mu", "nu")}
    init = {k: v.numpy() for k, v in torch.load(work / "step.pth").items()}
    for out in outs:
        assert out["adamw_count"] == 2
        # the moments are linear in the gradients (and their squares): as the SGD deltas
        _close(out["moments"]["mu"], moments["mu"])
        _close(out["moments"]["nu"], moments["nu"], rel=2 * REL)
        # the parameters within a tenth of one step at lr_new (1e-4): Adam moves an
        # element whose gradient is rounding noise (the keys' bias) by any part of a step
        assert sorted(out["adamw"]) == sorted(want)
        for key, w in want.items():
            np.testing.assert_allclose(out["adamw"][key], w, rtol=0, atol=1e-5, err_msg=key)
    # the WebVid step moved the sort head (zero gradient, decayed moments) as JAX does
    key = "pred_model.head.weight"
    assert not np.array_equal(outs[0]["adamw"][key], init[key])
    assert (outs[0]["moments"]["mu"][key] != 0).all()


def _moment(opt_state, name: str) -> dict:
    """The `name` (mu / nu) leaves of every optimizer group's Adam state as
    one parameter tree (frozen parameters have none)."""
    import jax

    tree: dict = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(opt_state)[0]:
        attrs = [getattr(k, "name", None) for k in path]
        if name not in attrs:
            continue
        keys = [k.key for k in path[attrs.index(name) + 1:]]
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = np.asarray(leaf)
    return tree


def test_trainer_on_two_ranks(ranks, monkeypatch):
    from tvts_torch.cli import train_dist_TVTSv2 as cli
    from tvts_torch.data import ytt as ytt_mod
    from tvts_torch.train import trainer as trainer_mod

    work, outs = ranks
    results = [out["trainer"] for out in outs]
    # each rank's own samples: one epoch, 2 steps of B
    (e0, idx0), (e1, idx1) = (r["indices"][0] for r in results)
    assert e0 == e1 == 1 and len(idx0) == len(idx1) == 2 * B
    assert set(idx0).isdisjoint(idx1) and sorted(idx0 + idx1) == list(range(4 * B))
    assert [r["count"] for r in results] == [2, 2]
    assert [(r["writes"], r["writer"]) for r in results] == [(True, True), (False, False)]
    # the init validation over both ranks' halves of the val set equals one process's
    vals = []
    get_item = ytt_mod.YTTemporal.__getitem__

    def reseeded_item(self, item):
        random.seed(1000 + item)
        return get_item(self, item)

    valid_epoch = trainer_mod.Trainer._valid_epoch

    def recorded_valid(self, epoch):
        vals.append((epoch, valid_epoch(self, epoch)))
        return vals[-1][1]

    monkeypatch.setattr(ytt_mod.YTTemporal, "__getitem__", reseeded_item)
    monkeypatch.setattr(trainer_mod.Trainer, "_valid_epoch", recorded_valid)
    config = json.loads((work / "trainer.json").read_text())
    config["trainer"].update(epochs=0, save_dir=str(work / "one"))
    (work / "one.json").write_text(json.dumps(config))
    cli.main(["-c", str(work / "one.json"), "--no-bf16", "--device", "cpu"])
    want = dict(vals)[0]
    assert want["val_loss_0"] != 1.0  # sort labels were counted
    for r in results:
        got = dict((e, log) for e, log in r["val"])[0]
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key] == pytest.approx(want[key], abs=1e-9), key
    assert [e for e, _ in results[0]["val"]] == [0, 1]
    # model_best.pth once, in rank 0's run directory; rank 1 made none
    runs = os.listdir(work / "results" / "models" / config["name"])
    assert len(runs) == 1
    found = [os.path.join(d, f) for d, _, files in os.walk(work / "results") for f in files
             if f == "model_best.pth"]
    assert len(found) == 1
