"""The port's TVTS v1 family on the CPU against the JAX package: the
WordPiece tokenizer (token for token, ids and mask), DistilBertEncoder,
JointViT (per-tube keep sets and none) and TVTSv1 (all three outputs) on
the same seeded weights (f32 within 2e-5; bf16 embeddings cosine >= 0.999),
the weight maps (the carry-over round trip through the JAX package's
convert_v1_state_dict bit for bit; a reference-layout checkpoint with
VideoMAE q/v biases and HF DistilBERT keys, and an MAE 2-D patch embed,
loaded as the JAX package loads them), and the CC3M and tar image datasets'
items bit for bit on cv2-written PNGs (RGB, grey, RGBA), train and val, under
the same `random.seed`. Tiny arch of tests/test_v1_train.py:33-38, one
thread; the JAX functions run jitted."""

import io
import os
import random
import tarfile

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from tests.test_wordpiece import VOCAB  # noqa: E402
from tvts_torch.models import distilbert as port_distilbert  # noqa: E402
from tvts_torch.models import tvts_v1 as port_v1  # noqa: E402
from tvts_torch.utils import convert as port_convert  # noqa: E402

F32_ATOL = 2e-5
COS_BF16 = 0.999
B = 2


def jax_module(name):
    import importlib

    return importlib.import_module(f"tvts_tpu.{name}")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_config(cfg_cls, bert_cls, num_frames=4):
    """tests/test_v1_train.py's tiny arch."""
    return cfg_cls(
        img_size=64, patch_size=16, embed_dim=64, depth=2, heads=4, num_frames=num_frames,
        tubelet_size=2, projection_dim=32, sort_heads=4, mask_ratio=0.5, max_text_len=16,
        text=bert_cls(vocab_size=len(VOCAB) + 70, max_position_embeddings=32, dim=64,
                      hidden_dim=128, n_layers=2, n_heads=4))


def inputs(cfg, seed=0):
    """Seeded clips, per-tube keep sets, and clip-major ids with padded masks
    (CLS first, each row a different length, one full row)."""
    rng = np.random.default_rng(seed)
    video = rng.standard_normal((B, cfg.num_frames, 3, cfg.img_size, cfg.img_size))
    keep = np.stack([np.stack([rng.permutation(cfg.patches_per_frame)[:cfg.n_keep]
                               for _ in range(cfg.n_tubes)]) for _ in range(B)])
    n, L = cfg.num_clips, cfg.max_text_len
    ids = rng.integers(5, cfg.text.vocab_size, (n * B, L))
    mask = np.zeros((n * B, L), np.int32)
    for r in range(n * B):
        k = L if r == 0 else int(rng.integers(1, L))
        mask[r, :k] = 1
    ids[:, 0] = 2
    ids = np.where(mask > 0, ids, 0)
    return video.astype(np.float32), keep.astype(np.int32), ids.astype(np.int32), mask


@pytest.fixture(scope="module")
def models():
    """(JAX module, JAX params with seeded noise on every leaf, the port's
    f32 TVTSv1 on the same weights, its config, the inputs)."""
    import jax

    jax_v1 = jax_module("models.tvts_v1")
    jcfg = tiny_config(jax_v1.TVTSv1Config, jax_module("models.distilbert").DistilBertConfig)
    pcfg = tiny_config(port_v1.TVTSv1Config, port_distilbert.DistilBertConfig)
    video, keep, ids, mask = inputs(pcfg)
    jm = jax_v1.TVTSv1(jcfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), video[:1], ids[:4], mask[:4],
                              keep[:1])["params"]
    rng = np.random.default_rng(1)
    params = jax.tree.map(lambda x: np.asarray(x) + 0.02 * rng.standard_normal(x.shape)
                          .astype(np.float32), params)
    pm = port_v1.TVTSv1(pcfg)
    pm.load_state_dict({k: torch.from_numpy(v) for k, v in
                        port_convert.v1_state_dict_from_jax(params).items()}, strict=True)
    return jax_v1, jcfg, params, pm, (video, keep, ids, mask)


def jax_apply(jax_v1, jcfg, params, dtype, method, *args):
    import jax
    import jax.numpy as jnp

    module = jax_v1.TVTSv1(jcfg, dtype=getattr(jnp, dtype))
    out = jax.jit(lambda p, *a: module.apply({"params": p}, *a, method=method))(params, *args)
    return jax.tree.map(lambda x: np.asarray(x, np.float32), out)


def _cos(a, b):
    a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
    return (np.sum(a * b, -1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(b, axis=-1)).min()


def _close(got, want, dtype):
    got = got.detach().float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)
    else:
        assert _cos(got, want) >= COS_BF16


# ---------------------------------------------------------------------------
# WordPiece
# ---------------------------------------------------------------------------
EXTRA = ["cafe", "resume", "我", "爱", "?", "-", "over"] + [f"w{i}" for i in range(30)]
TEXTS = [
    "A Person is PLAYING the Guitar on Stage!",            # case
    "Café résumé ÉTÉ naïve",                                # accents
    "the dog's run?! -- un-believ-able... (runs)",          # punctuation
    "我爱the guitar 爱 我",                                   # CJK spacing
    "x" * 101 + " a " + "y" * 100,                          # over 100 characters: [UNK]
    " ".join(f"w{i}" for i in range(30)),                   # truncation
    "a\x00 person​\tis\n\rplaying�",               # control characters
    "",
    "unbelievable doggy runs, runs.",
]


@pytest.fixture(scope="module")
def vocab_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    p.write_text("\n".join(VOCAB + EXTRA) + "\n")
    return str(p)


@pytest.mark.parametrize("max_length", [8, 16, 50])
def test_wordpiece_equals_jax(vocab_file, max_length):
    from tvts_torch.text.wordpiece import WordPieceTokenizer

    jax_tk = jax_module("text.wordpiece").WordPieceTokenizer(vocab_file)
    tk = WordPieceTokenizer(vocab_file)
    for t in TEXTS:
        assert tk.tokenize(t) == jax_tk.tokenize(t), t
    assert tk.tokenize(TEXTS[4]) == ["[UNK]", "a", "[UNK]"]
    got, want = tk(TEXTS, max_length=max_length), jax_tk(TEXTS, max_length=max_length)
    for k in ("input_ids", "attention_mask"):
        assert got[k].dtype == want[k].dtype and got[k].shape == (len(TEXTS), max_length)
        np.testing.assert_array_equal(got[k], want[k])
    assert got["input_ids"][TEXTS.index("")].tolist()[:3] == [tk.cls_id, tk.sep_id, tk.pad_id]


def test_wordpiece_vocab_from_environment(vocab_file, monkeypatch):
    from tvts_torch.text.wordpiece import WordPieceTokenizer

    monkeypatch.setenv("TVTS_TPU_BERT_VOCAB", vocab_file)
    assert WordPieceTokenizer().vocab == WordPieceTokenizer(vocab_file).vocab
    monkeypatch.setenv("TVTS_TPU_BERT_VOCAB", vocab_file + ".missing")
    with pytest.raises(FileNotFoundError, match="TVTS_TPU_BERT_VOCAB"):
        WordPieceTokenizer()


# ---------------------------------------------------------------------------
# the towers and the model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_distilbert_equals_jax(models, dtype):
    jax_v1, jcfg, params, pm, (_, _, ids, mask) = models
    want = jax_apply(jax_v1, jcfg, params, dtype, lambda m, i, a: m.text_model(i, a), ids, mask)
    pm.set_compute_dtype(getattr(torch, dtype))
    with torch.no_grad():
        got = pm.text_model(torch.from_numpy(ids), torch.from_numpy(mask))
    pm.set_compute_dtype(None)
    assert got.dtype == getattr(torch, dtype) and got.shape == want.shape
    # padded positions attend to the unpadded ones only; every row is compared
    _close(got, want, dtype)


@pytest.mark.parametrize("per_tube", [True, False], ids=["keep_ind", "no_keep_ind"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_joint_vit_equals_jax(models, dtype, per_tube):
    jax_v1, jcfg, params, pm, (video, keep, _, _) = models
    keep = keep if per_tube else None
    want = jax_apply(jax_v1, jcfg, params, dtype, lambda m, v, k: m.video_model(v, k),
                     video, keep)
    pm.set_compute_dtype(getattr(torch, dtype))
    with torch.no_grad():
        got = pm.video_model(torch.from_numpy(video),
                             None if keep is None else torch.from_numpy(keep))
    pm.set_compute_dtype(None)
    n = jcfg.n_keep if per_tube else jcfg.patches_per_frame
    assert got.shape == want.shape == (B, 1 + jcfg.n_tubes * n, jcfg.embed_dim)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tvts_v1_equals_jax(models, dtype):
    jax_v1, jcfg, params, pm, (video, keep, ids, mask) = models
    want = jax_apply(jax_v1, jcfg, params, dtype, None, video, ids, mask, keep)
    pm.set_compute_dtype(getattr(torch, dtype))
    with torch.no_grad():
        got = pm(torch.from_numpy(video), torch.from_numpy(ids), torch.from_numpy(mask),
                 torch.from_numpy(keep))
    pm.set_compute_dtype(None)
    shapes = [(B, jcfg.projection_dim), (B, jcfg.projection_dim), (B, 4, 4)]
    assert [tuple(g.shape) for g in got] == [w.shape for w in want] == shapes
    for g, w in zip(got[:2], want[:2]):  # text and video embeddings
        _close(g, w, dtype)
    if dtype == "float32":
        _close(got[2], want[2], dtype)  # the sort logits
    # one transcript a clip: no sort head, as in the JAX package
    n1 = pm(torch.from_numpy(video), torch.from_numpy(ids[:B]), torch.from_numpy(mask[:B]),
            torch.from_numpy(keep))
    assert n1[2] is None


def test_bf16_mask_bias_rounds_to_minus_inf(models):
    """finfo(float32).min, built in float32, is -inf in bf16 and stays finite
    in f32; a padded key then takes no weight, and no row is all masked."""
    *_, pm, (_, _, ids, mask) = models
    for dtype, finite in ((torch.float32, True), (torch.bfloat16, False)):
        bias = torch.where(torch.tensor(0) > 0, 0.0, torch.finfo(torch.float32).min).to(dtype)
        assert bool(torch.isfinite(bias)) is finite
    pm.set_compute_dtype(torch.bfloat16)
    with torch.no_grad():
        out = pm.text_model(torch.from_numpy(ids), torch.from_numpy(mask))
    pm.set_compute_dtype(None)
    assert torch.isfinite(out.float()).all()


# ---------------------------------------------------------------------------
# the weight maps
# ---------------------------------------------------------------------------
def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def test_carry_over_round_trip(models):
    _, _, params, pm, _ = models
    jax_convert = jax_module("utils.torch_convert")
    sd = port_convert.v1_state_dict_from_jax(params)
    assert sorted(sd) == sorted(pm.state_dict())
    back, want = dict(_leaves(jax_convert.convert_v1_state_dict(sd))), dict(_leaves(params))
    assert back.keys() == want.keys()
    for path, arr in want.items():
        assert back[path].dtype == arr.dtype and np.array_equal(back[path], arr), path


def test_reference_checkpoint_loads_as_jax(models, tmp_path):
    """A reference-layout v1 checkpoint (DDP prefix, VideoMAE q/v biases,
    HF DistilBERT keys under `distilbert.` with position_ids, a logit_scale)
    and an MAE 2-D checkpoint (--mae_init) give the JAX package's tree."""
    _, _, params, pm, _ = models
    jax_convert = jax_module("utils.torch_convert")
    rng = np.random.default_rng(5)
    sd = port_convert.v1_state_dict_from_jax(params)
    ref = {}
    for k, v in sd.items():
        if k.endswith(".attn.qkv.bias"):
            D = v.shape[0] // 3
            ref[k[:-len("qkv.bias")] + "q_bias"] = rng.standard_normal(D).astype(np.float32)
            ref[k[:-len("qkv.bias")] + "v_bias"] = rng.standard_normal(D).astype(np.float32)
        elif k.startswith("text_model."):
            ref["text_model.distilbert." + k[len("text_model."):]] = v
        else:
            ref[k] = v
    ref["text_model.distilbert.embeddings.position_ids"] = np.arange(32)[None]
    ref["logit_scale"] = np.ones((), np.float32)
    ref = {f"module.{k}": torch.from_numpy(np.asarray(v)) for k, v in ref.items()}
    torch.save({"state_dict": ref}, tmp_path / "v1.pth")

    want = dict(_leaves(jax_convert.convert_v1_state_dict(
        jax_convert.load_torch_state_dict(str(tmp_path / "v1.pth")))))
    loaded = port_convert.convert_v1_state_dict(
        port_convert.load_reference_state_dict(str(tmp_path / "v1.pth")))
    model = port_v1.TVTSv1(pm.cfg)
    model.load_state_dict(loaded, strict=True)
    got = dict(_leaves(jax_convert.convert_v1_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()})))
    assert got.keys() == want.keys()
    for path in want:
        assert np.array_equal(got[path], want[path]), path

    # --mae_init: a 2-D patch embed and bias-free qkv with q/v biases
    D, p = pm.cfg.embed_dim, pm.cfg.patch_size
    mae = {"patch_embed.proj.weight": rng.standard_normal((D, 3, p, p)),
           "patch_embed.proj.bias": rng.standard_normal(D),
           "blocks.0.attn.qkv.weight": rng.standard_normal((3 * D, D)),
           "blocks.0.attn.q_bias": rng.standard_normal(D),
           "blocks.0.attn.v_bias": rng.standard_normal(D),
           "norm.weight": rng.standard_normal(D)}
    torch.save({k: torch.tensor(v, dtype=torch.float32) for k, v in mae.items()},
               tmp_path / "mae.pth")
    jsd = jax_convert.inflate_mae_2d_to_3d(
        jax_convert.load_torch_state_dict(str(tmp_path / "mae.pth")))
    # MAE's pretraining keys (mask_token, the decoder) raise in the JAX
    # package's converter; the port's overlay reports them unused
    mae["mask_token"] = rng.standard_normal((1, 1, D))
    torch.save({k: torch.tensor(v, dtype=torch.float32) for k, v in mae.items()},
               tmp_path / "mae.pth")
    want = dict(_leaves(jax_convert.convert_v1_state_dict(
        {f"video_model.{k}": v for k, v in jsd.items()})))
    psd = port_convert.inflate_mae_2d_to_3d(
        port_convert.load_reference_state_dict(str(tmp_path / "mae.pth")))
    got = port_convert.convert_v1_state_dict({f"video_model.{k}": v for k, v in psd.items()})
    assert got["video_model.patch_embed.proj.weight"].shape == (D, 3, 2, p, p)
    missing, unused = port_convert.merge_params(model, got)
    assert unused == ["video_model.mask_token"]
    tree = dict(_leaves(jax_convert.convert_v1_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()})))
    for path, arr in want.items():
        if path in tree:
            assert np.array_equal(tree[path], arr.astype(np.float32)), path
    assert ("video_model", "patch_embed", "kernel") in want


# ---------------------------------------------------------------------------
# CC3M and tar images
# ---------------------------------------------------------------------------
def _image(rng, h, w, kind):
    """A smooth uint8 image, BGR / grey / BGRA as cv2 writes it."""
    base = cv2.GaussianBlur(rng.integers(0, 256, (h, w, 4), dtype=np.uint8), (5, 5), 2)
    if kind == "grey":
        return base[..., 0]
    if kind == "rgba":
        base[..., 3][rng.random((h, w)) < 0.2] = 0
        return base
    return base[..., :3]


IMAGES = [((90, 70), "rgb"), ((300, 400), "rgb"), ((257, 255), "grey"), ((120, 160), "rgba"),
          ((256, 256), "rgb"), ((40, 500), "rgba")]


@pytest.fixture(scope="module")
def cc3m_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("cc3m")
    rng = np.random.default_rng(7)
    rows = []
    for i, ((h, w), kind) in enumerate(IMAGES):
        name = f"{i:03d}.png"
        img = _image(rng, h, w, kind)
        for split in ("training", "validation"):
            os.makedirs(root / split, exist_ok=True)
            assert cv2.imwrite(str(root / split / name), img)
        rows.append(f"caption {i} of a {kind} image\t{name}")
    for split in ("train", "val"):
        (root / f"cc3m_{split}.tsv").write_text("caption\tfilename\n" + "\n".join(rows) + "\n")
    with tarfile.open(root / "shard0.tar", "w") as tar:
        for i, ((h, w), kind) in enumerate(IMAGES):
            data = cv2.imencode(".png", _image(rng, h, w, kind))[1].tobytes()
            info = tarfile.TarInfo(f"img_{i:03d}.png")
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
    (root / "tarimages_train.tsv").write_text(
        "caption\ttar\tmember\n" + "".join(f"tar caption {i}\tshard0.tar\timg_{i:03d}.png\n"
                                           for i in range(len(IMAGES))))
    return str(root)


def _items(cls, tree, split, video_params, n_items):
    ds = cls("ConceptualCaptions3M" if "Captions" in cls.__name__ else "TarImages", {},
             video_params, tree, split=split, meta_root=tree, patches_per_frame=16,
             mask_ratio=0.5, per_tube_masks=8)
    random.seed(99)
    return [ds[i] for i in range(n_items)]


@pytest.mark.parametrize("name,split", [("ConceptualCaptions3M", "train"),
                                        ("ConceptualCaptions3M", "val"),
                                        ("TextImageTarDataset", "train")])
def test_image_items_equal_jax(cc3m_tree, name, split):
    from tvts_torch.data import image_datasets as port_img

    video_params = {"input_res": 64, "num_frames": 2, "loading": "strict"}
    n = 2 * len(IMAGES)  # each image twice: other random crops and flips
    want = _items(getattr(jax_module("data.image_datasets"), name), cc3m_tree, split,
                  video_params, n)
    got = _items(getattr(port_img, name), cc3m_tree, split, video_params, n)
    frames = 1 if name == "TextImageTarDataset" else 2
    for g, w in zip(got, want):
        assert g["video"].dtype == w["video"].dtype == np.float32
        assert g["video"].shape == w["video"].shape == (frames, 3, 64, 64)
        assert np.array_equal(g["video"], w["video"])
        assert np.array_equal(g["keep_ind"], w["keep_ind"]) and g["keep_ind"].shape == (8,)
        assert g["text"] == w["text"] and g["meta"] == w["meta"]


def test_image_jpeg_decode_against_pillow():
    """OpenCV's and Pillow's JPEG decoders: the level of difference, recorded
    (0 with this container's OpenCV and Pillow), and held within 2 units of
    255 a pixel; the lax path gives a black image on an undecodable file."""
    from PIL import Image

    from tvts_torch.data.image_datasets import decode_image

    rng = np.random.default_rng(11)
    worst = 0
    for q in (60, 95):
        img = _image(rng, 120, 160, "rgb")
        data = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, q])[1].tobytes()
        pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB")).astype(int)
        worst = max(worst, int(np.abs(decode_image(data).astype(int) - pil).max()))
    print(f"JPEG: max |OpenCV - Pillow| = {worst} of 255")
    assert worst <= 2
    with pytest.raises(ValueError, match="cannot decode"):
        decode_image(b"not an image")
