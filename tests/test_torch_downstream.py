"""The port's SSV2 downstream modules on the CPU against the JAX package:
- FinetuneViT (tests/test_downstream.py's tiny arch: 32² x 4 frames, depth
  2) on the same seeded weights: f32 logits and gradients within 2e-5 (also
  through `remat`), bf16 logits cosine >= 0.999, the sinusoid table equal;
- the weight maps: finetune_state_dict_from_jax round trip through the JAX
  package's convert_v1_state_dict bit for bit, and load_pretrain_video_tower
  from a JAX JointViT's weights and from a reference-layout .pth (VideoMAE
  q/v biases) equal to the JAX merge;
- three layer-decayed AdamW steps (a warmup that ends inside them, a
  clip_grad small enough that the per-group clip acts) in finetune and
  linear-probe mode against make_finetune_optimizer + make_cls_train_step:
  every loss and parameter within 2e-5 (the attention k biases apart, as in
  tests/test_torch_v1_train.py), the frozen backbone bit for bit;
- Mixup (both branches), one_hot, RandomErasing, EmaParams,
  MultiViewAccumulator and v2v_retrieval_metrics (with ties) equal;
- VideoClsDataset items bit for bit in its three modes under the same
  `random.seed`, on cv2-written clips read through the cv2 backend by both.
One thread; the JAX functions run jitted."""

import random

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

import chip_smoke  # noqa: E402
from tvts_torch.downstream import cls_dataset as port_ds  # noqa: E402
from tvts_torch.downstream import engine as port_engine  # noqa: E402
from tvts_torch.downstream import mixup as port_mixup  # noqa: E402
from tvts_torch.downstream import model as port_model  # noqa: E402
from tvts_torch.downstream import random_erasing as port_erasing  # noqa: E402
from tvts_torch.downstream import zero_v2v as port_v2v  # noqa: E402
from tvts_torch.utils import convert as port_convert  # noqa: E402

F32_ATOL = 2e-5
COS_BF16 = 0.999
ARCH = dict(num_classes=7, img_size=32, patch_size=16, embed_dim=64, depth=2, heads=4,
            num_frames=4, tubelet_size=2)
B = 4


def jax_module(name):
    import importlib

    return importlib.import_module(f"tvts_tpu.{name}")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _noisy(params, seed, scale=0.02):
    import jax

    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: np.asarray(x) + scale * rng.standard_normal(x.shape)
                        .astype(np.float32), params)


@pytest.fixture(scope="module")
def ft():
    """(JAX FinetuneViT, its params with noise on every leaf, video)."""
    import jax

    jm = jax_module("downstream.model").FinetuneViT(**ARCH)
    video = np.random.default_rng(0).standard_normal((B, 4, 3, 32, 32)).astype(np.float32)
    params = _noisy(jax.jit(jm.init)(jax.random.PRNGKey(0), video[:1])["params"], 1)
    return jm, params, video


def port_finetune(params, remat=False):
    m = port_model.FinetuneViT(**ARCH, remat=remat)
    m.load_state_dict({k: torch.tensor(v) for k, v in
                       port_convert.finetune_state_dict_from_jax(params).items()}, strict=True)
    return m


def _cos(a, b):
    return (np.sum(a * b, -1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(b, axis=-1)).min()


# ---------------------------------------------------------------------------
# FinetuneViT
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_finetune_vit_f32_logits_and_gradients_equal_jax(ft, remat):
    import jax
    import jax.numpy as jnp

    jm, params, video = ft
    r = np.random.default_rng(2).standard_normal((B, ARCH["num_classes"])).astype(np.float32)
    want_logits = np.asarray(jax.jit(lambda p: jm.apply({"params": p}, video))(params))
    grads = jax.jit(jax.grad(lambda p: jnp.sum(jm.apply({"params": p}, video) * r)))(params)
    jgrads = port_convert.finetune_state_dict_from_jax(jax.tree.map(np.asarray, grads))
    m = port_finetune(params, remat)
    logits = m(torch.from_numpy(video))
    (logits * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(logits.detach().numpy(), want_logits, rtol=0, atol=F32_ATOL)
    names = ("blocks.1.mlp.fc1.weight", "blocks.0.attn.qkv.weight", "patch_embed.proj.weight",
             "fc_norm.weight", "head.weight")
    for name in names:
        got = dict(m.named_parameters())[name].grad.numpy()
        scale = max(1.0, float(np.abs(jgrads[name]).max()))
        np.testing.assert_allclose(got, jgrads[name], rtol=0, atol=F32_ATOL * scale, err_msg=name)


def test_finetune_vit_bf16_logits_cosine(ft):
    import jax
    import jax.numpy as jnp

    _, params, video = ft
    jm = jax_module("downstream.model").FinetuneViT(**ARCH, dtype=jnp.bfloat16)
    want = np.asarray(jax.jit(lambda p: jm.apply({"params": p}, video))(params), np.float32)
    m = port_finetune(params)
    m.set_compute_dtype(torch.bfloat16)
    with torch.no_grad():
        got = m(torch.from_numpy(video))
    assert got.dtype == torch.bfloat16 and got.shape == want.shape == (B, ARCH["num_classes"])
    assert _cos(got.float().numpy(), want) >= COS_BF16


def test_sinusoid_table_equal():
    want = jax_module("downstream.model").sinusoid_table(1568, 768)
    np.testing.assert_array_equal(port_model.sinusoid_table(1568, 768), want)
    np.testing.assert_array_equal(port_model.sinusoid_table(8, 6),
                                  jax_module("downstream.model").sinusoid_table(8, 6))


# ---------------------------------------------------------------------------
# weight maps and the pretrained tower
# ---------------------------------------------------------------------------
def test_carry_over_round_trip_bit_for_bit(ft):
    import jax

    _, params, _ = ft
    sd = port_convert.finetune_state_dict_from_jax(params)
    assert set(sd) == set(port_model.FinetuneViT(**ARCH).state_dict())
    back = jax_module("utils.torch_convert").convert_v1_state_dict(
        {f"video_model.{k}": v for k, v in sd.items()})["video_model"]
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def pretrained():
    """(JAX JointViT params with noise on every leaf, the JAX FinetuneViT init)."""
    import jax

    video = np.zeros((1, 4, 3, 32, 32), np.float32)
    jv = jax_module("models.joint_vit").JointViT(img_size=32, patch_size=16, embed_dim=64,
                                                  depth=2, heads=4, num_frames=4,
                                                  tubelet_size=2)
    pre = _noisy(jax.jit(lambda k: jv.init(k, video, None))(jax.random.PRNGKey(1))["params"], 3)
    jm = jax_module("downstream.model").FinetuneViT(**ARCH)
    init = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0), video)["params"])
    return pre, init


def _assert_state_equal(model, want: dict):
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_load_pretrain_video_tower_from_jax_weights(pretrained):
    pre, init = pretrained
    jax_dm = jax_module("downstream.model")
    merged = jax_dm.load_pretrain_video_tower(init, {"video_model": pre})
    m = port_finetune(init)
    names = port_model.load_pretrain_video_tower(
        m, port_convert.v1_state_dict_from_jax({"video_model": pre}))
    assert names and all(n.startswith(("blocks.", "patch_embed.")) for n in names)
    _assert_state_equal(m, port_convert.finetune_state_dict_from_jax(merged))
    # fc_norm and head stay at their initial values
    np.testing.assert_array_equal(m.head.weight.detach().numpy(), init["head"]["kernel"].T)


def test_load_pretrain_video_tower_from_reference_pth(pretrained, tmp_path):
    """A reference-layout v1 .pth (`module.video_model.*`, VideoMAE q/v biases
    with no qkv bias, other towers beside it) through the JAX package's
    from_torch load and the port's."""
    pre, init = pretrained
    sd = port_convert.v1_state_dict_from_jax({"video_model": pre})
    ref = {}
    for k, v in sd.items():
        if k.endswith("attn.qkv.bias"):
            D = v.shape[0] // 3
            ref[k[:-len("qkv.bias")] + "q_bias"] = v[:D]
            ref[k[:-len("qkv.bias")] + "v_bias"] = v[2 * D:]
        else:
            ref[k] = v
    ref["txt_proj.1.weight"] = np.ones((3, 64), np.float32)
    path = tmp_path / "v1.pth"
    torch.save({"state_dict": {f"module.{k}": torch.from_numpy(np.ascontiguousarray(v))
                               for k, v in ref.items()}}, path)
    jax_sd = jax_module("utils.torch_convert").load_torch_state_dict(str(path))
    merged = jax_module("downstream.model").load_pretrain_video_tower(init, jax_sd,
                                                                      from_torch=True)
    m = port_finetune(init)
    port_model.load_pretrain_video_tower(m, port_convert.load_reference_state_dict(str(path)))
    _assert_state_equal(m, port_convert.finetune_state_dict_from_jax(merged))


# ---------------------------------------------------------------------------
# the layer-decayed optimizer and the train step
# ---------------------------------------------------------------------------
CLIP = 0.3  # below some groups' gradient norm and above others'


@pytest.mark.parametrize("linear_probe", [False, True], ids=["finetune", "linear"])
def test_three_layer_decayed_steps_equal_jax(ft, linear_probe):
    import jax

    jm, params, video = ft
    jax_engine = jax_module("downstream.engine")
    kw = dict(epochs=2, steps_per_epoch=2, warmup_epochs=1, num_layers=ARCH["depth"],
              clip_grad=CLIP, linear_probe=linear_probe)
    tx, jscales = jax_engine.make_finetune_optimizer(params, 1e-3, 0.05, **kw)
    state = jax_module("train.step").create_train_state(jax.tree.map(np.copy, params), tx)
    step = jax_engine.make_cls_train_step(jm, tx, donate=False)
    rng = np.random.default_rng(5)
    batches = [(rng.standard_normal(video.shape).astype(np.float32),
                port_mixup.one_hot(rng.integers(0, ARCH["num_classes"], B), ARCH["num_classes"],
                                   0.1)) for _ in range(3)]
    want = []
    for v, t in batches:
        state, loss = step(state, v, t)
        want.append(float(loss))

    m = port_finetune(params, remat=True)
    before = {k: v.clone() for k, v in m.state_dict().items()}
    opt, scales = port_engine.make_finetune_optimizer(m, 1e-3, 0.05, **kw)
    assert scales == pytest.approx(jscales)
    train_step = port_engine.make_cls_train_step(m, opt)
    got = [float(train_step(torch.from_numpy(v), torch.from_numpy(t))) for v, t in batches]
    assert got == pytest.approx(want, abs=F32_ATOL)
    assert opt.count == 3
    # the per-group clip acted in some group and not in another at step 0
    norms = _group_norms(params, *batches[0], jm, linear_probe)
    assert min(norms) < CLIP < max(norms)
    trained = port_convert.finetune_state_dict_from_jax(jax.tree.map(np.asarray, state.params))
    for name, value in m.state_dict().items():
        got_p, want_p = value.numpy(), trained[name]
        if linear_probe and not name.startswith(("head.", "fc_norm.")):
            assert torch.equal(value, before[name]), name  # frozen: bit for bit
        if name.endswith("attn.qkv.bias"):  # the k biases' gradient is rounding noise
            D = got_p.shape[0] // 3
            got_p, want_p = np.delete(got_p, np.s_[D:2 * D]), np.delete(want_p, np.s_[D:2 * D])
        np.testing.assert_allclose(got_p, want_p, atol=F32_ATOL, rtol=0, err_msg=name)
    if linear_probe:
        assert not torch.equal(m.head.weight, before["head.weight"])


def _group_norms(params, video, targets, jm, linear_probe):
    """Each optimizer group's gradient norm at step 0 (the JAX gradients)."""
    import jax

    jax_engine = jax_module("downstream.engine")
    grads = jax.grad(lambda p: jax_engine.soft_ce(jm.apply({"params": p}, video), targets))(
        params)
    sd = port_convert.finetune_state_dict_from_jax(jax.tree.map(np.asarray, grads))
    labels = port_engine.param_labels(port_model.FinetuneViT(**ARCH), ARCH["depth"],
                                      linear_probe)
    sums: dict = {}
    for name, g in sd.items():
        if labels[name] != "frozen":
            sums[labels[name]] = sums.get(labels[name], 0.0) + float(np.sum(g.astype(np.float64)
                                                                           ** 2))
    return [s ** 0.5 for s in sums.values()]


def test_cosine_schedule_and_layer_ids_equal_jax():
    jax_engine = jax_module("downstream.engine")
    want = jax_engine.cosine_schedule(1e-3, 1e-6, epochs=10, steps_per_epoch=7, warmup_epochs=2)
    got = port_engine.cosine_schedule(1e-3, 1e-6, epochs=10, steps_per_epoch=7, warmup_epochs=2)
    for s in (0, 1, 13, 14, 15, 40, 69, 70, 200):
        assert np.float32(got(s)) == pytest.approx(float(want(s)), rel=1e-6, abs=0), s
    m = port_model.FinetuneViT(**ARCH)
    for name, _ in m.named_parameters():
        top = name.split(".")
        path = ((f"blocks_{top[1]}",) + tuple(top[2:])) if top[0] == "blocks" else tuple(top)
        assert port_engine.layer_id_for_param(name, 2) == jax_engine.layer_id_for_param(path, 2)


def test_soft_ce_dtype_order():
    import jax.numpy as jnp

    rng = np.random.default_rng(7)
    logits = rng.standard_normal((5, 11)).astype(np.float32) * 3
    targets = port_mixup.one_hot(rng.integers(0, 11, 5), 11, 0.1)
    jax_engine = jax_module("downstream.engine")
    for dtype in ("float32", "bfloat16"):
        want = float(jax_engine.soft_ce(jnp.asarray(logits, getattr(jnp, dtype)), targets))
        got = port_engine.soft_ce(torch.from_numpy(logits).to(getattr(torch, dtype)),
                                  torch.from_numpy(targets))
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(want, abs=2e-5 if dtype == "float32" else 2e-2)


# ---------------------------------------------------------------------------
# mixup, erasing, EMA, the multi-view merge, v2v
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("switch_prob", [0.0, 1.0], ids=["mixup", "cutmix"])
def test_mixup_equal(switch_prob):
    J = jax_module("downstream.mixup")
    video = np.random.default_rng(0).standard_normal((4, 2, 3, 9, 13)).astype(np.float32)
    labels = np.array([0, 3, 2, 4])
    for seed in range(5):
        want = J.Mixup(num_classes=5, switch_prob=switch_prob,
                       rng=np.random.default_rng(seed))(video, labels)
        got = port_mixup.Mixup(num_classes=5, switch_prob=switch_prob,
                               rng=np.random.default_rng(seed))(video, labels)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    # prob 0 and no alpha: smoothed one-hot
    for kw in ({"prob": 0.0}, {"mixup_alpha": 0.0, "cutmix_alpha": 0.0}):
        w = J.Mixup(num_classes=5, rng=np.random.default_rng(1), **kw)(video, labels)[1]
        g = port_mixup.Mixup(num_classes=5, rng=np.random.default_rng(1), **kw)(video, labels)[1]
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(port_mixup.one_hot(labels, 5, 0.1, lam=0.3,
                                                     flipped=labels[::-1]),
                                  J.one_hot(labels, 5, 0.1, lam=0.3, flipped=labels[::-1]))


@pytest.mark.parametrize("mode,cube", [("pixel", True), ("pixel", False), ("const", True)])
def test_random_erasing_equal(mode, cube):
    J = jax_module("downstream.random_erasing")
    clip = np.random.default_rng(0).standard_normal((4, 3, 17, 29)).astype(np.float32)
    for seed in range(8):
        kw = dict(probability=0.7, mode=mode, cube=cube, max_count=2)
        gj, gp = np.random.default_rng(seed), np.random.default_rng(seed)
        want = J.RandomErasing(rng=gj, **kw)(clip)
        got = port_erasing.RandomErasing(rng=gp, **kw)(clip)
        np.testing.assert_array_equal(got, want)
        assert gj.bit_generator.state == gp.bit_generator.state


def test_ema_equal(ft):
    import jax

    _, params, _ = ft
    ema_j = jax_module("downstream.engine").EmaParams(params, decay=0.9999)
    m = port_finetune(params)
    ema_p = port_engine.EmaParams(m, decay=0.9999)
    rng = np.random.default_rng(4)
    for _ in range(3):
        params = jax.tree.map(lambda x: x + rng.standard_normal(x.shape).astype(np.float32),
                              params)
        ema_j.update(params)
        m.load_state_dict({k: torch.tensor(v) for k, v in
                           port_convert.finetune_state_dict_from_jax(params).items()})
        ema_p.update(m)
    want = port_convert.finetune_state_dict_from_jax(jax.tree.map(np.asarray, ema_j.params))
    for k, v in ema_p.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)


def test_multiview_accumulator_and_v2v_equal():
    Je, Jv = jax_module("downstream.engine"), jax_module("downstream.zero_v2v")
    rng = np.random.default_rng(3)
    accs = [Je.MultiViewAccumulator(6, 9), port_engine.MultiViewAccumulator(6, 9)]
    for _ in range(4):
        idx = rng.integers(0, 5, 7)  # sample 5 has no view
        logits = rng.standard_normal((7, 9)).astype(np.float32)
        labels = rng.integers(0, 9, 7)
        for acc in accs:
            acc.add(idx, logits, labels)
    assert accs[1].merge() == accs[0].merge()
    np.testing.assert_array_equal(accs[1].count, accs[0].count)
    # ties: repeated features and labels; a query with no same-label clip
    feats = rng.standard_normal((12, 8)).astype(np.float32)
    feats[6:] = feats[:6]
    feats[3] = feats[4]
    labels = np.array([0, 1, 1, 2, 2, 3, 0, 1, 1, 2, 2, 7])
    for k in (1, 10):
        assert port_v2v.v2v_retrieval_metrics(feats, labels, k) == \
            Jv.v2v_retrieval_metrics(feats, labels, k)


# ---------------------------------------------------------------------------
# VideoClsDataset
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def cls_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ssv2"))
    return chip_smoke.ssv2_tree(root, {"train": 3, "val": 2, "test": 2},
                                clip=(21, 12, (48, 80)), workers=4)[0]


@pytest.mark.parametrize("mode,split", [("train", "train"), ("validation", "val"),
                                        ("test", "test")])
def test_video_cls_dataset_items_bit_for_bit(cls_tree, mode, split):
    J = jax_module("downstream.cls_dataset")
    kw = dict(mode=mode, num_frames=8, input_size=32, short_side_size=40,
              test_num_segment=2, test_num_crop=3, reader="cv2")
    csv = f"{cls_tree}/{split}.csv"
    want_ds, got_ds = J.VideoClsDataset(csv, cls_tree, **kw), port_ds.VideoClsDataset(csv,
                                                                                       cls_tree,
                                                                                       **kw)
    assert len(got_ds) == len(want_ds) == (2 * 2 * 3 if mode == "test" else
                                           len(want_ds.samples))
    repeats = 6 if mode == "train" else 1  # several draws of the augmentation
    for seed in range(repeats):
        random.seed(seed)
        want = [want_ds[i] for i in range(len(want_ds))]
        random.seed(seed)
        got = [got_ds[i] for i in range(len(got_ds))]
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            assert g["video"].dtype == np.float32 and g["video"].shape == (8, 3, 32, 32)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
