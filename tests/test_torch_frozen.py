"""The Frozen-style transforms and encoder (M5b) against the JAX package on
the CPU, one test per test of the JAX modules
(tests/test_clip_transforms.py, test_video_transforms_v1.py,
test_frozen_video_transformer.py):
- tvts_torch/data/clip_transforms.py and
  tvts_torch/downstream/video_transforms.py bit for bit the JAX modules on
  seeded uint8 clips (Pillow frames on the JAX side, arrays here), with the
  same seeds for the stdlib `random` and the same np.random.Generator draws;
- tvts_torch/downstream/video_transformer.py's SpaceTimeTransformer within
  2e-5 in f32 of the flax module at depth 2 and width 64, its weights
  carried by utils/convert.frozen_state_dict_from_jax, also on a clip
  shorter than num_frames.
Also Pillow's NEAREST affine and Convert.c's HSV round trip that they rest
on, against Pillow itself (a third of all colours).
"""

import random

import numpy as np
import pytest
import torch
from PIL import Image

from tvts_tpu.data import clip_transforms as JCT
from tvts_tpu.downstream import video_transforms as JVT
from tvts_torch.data import clip_transforms as CT
from tvts_torch.downstream import video_transforms as VT

TOL = 2e-5  # the Frozen tower in f32 against flax (PARITY.md §2.4)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def clip():
    return np.random.default_rng(0).integers(0, 255, size=(3, 48, 64, 3)).astype(np.uint8)


@pytest.fixture
def fclip():
    return np.random.default_rng(0).uniform(size=(3, 3, 48, 64)).astype(np.float32)


def seeded(fn, seed: int):
    """fn() after random.seed(seed): the stdlib draws of a JAX-side call and of
    its twin start alike."""
    random.seed(seed)
    return fn()


def same(got, want):
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def pil(frames):
    return [Image.fromarray(f) for f in frames]


def arrays(frames):
    return np.stack([np.asarray(f) for f in frames])


# ---------------------------------------------------------------------------
# clip_transforms
# ---------------------------------------------------------------------------
def test_resize_shorter_side(clip):
    for interp in ("nearest", "bilinear", "bicubic"):
        for size in (24, (20, 30), 48, 100):
            same(CT.Resize(size, interp)(clip), JCT.Resize(size, interp)(clip))
        for seed in range(3):
            same(seeded(lambda: CT.RandomResize(interpolation=interp)(clip), seed),
                 seeded(lambda: JCT.RandomResize(interpolation=interp)(clip), seed))


def test_crops(clip):
    for seed in range(4):
        same(seeded(lambda: CT.RandomCrop(32)(clip), seed),
             seeded(lambda: JCT.RandomCrop(32)(clip), seed))
        same(seeded(lambda: CT.CornerCrop(24)(clip), seed),
             seeded(lambda: JCT.CornerCrop(24)(clip), seed))
    same(CT.CenterCrop(32)(clip), JCT.CenterCrop(32)(clip))
    for pos in CT.CornerCrop.POSITIONS:
        same(CT.CornerCrop(24, pos)(clip), JCT.CornerCrop(24, pos)(clip))


def test_flip_and_rotation(clip):
    for p in (1.0, 0.0, 0.5):
        for seed in range(3):
            same(seeded(lambda: CT.RandomHorizontalFlip(p)(clip), seed),
                 seeded(lambda: JCT.RandomHorizontalFlip(p)(clip), seed))
    square = clip[:, :, :48]
    for degrees in (30, 180, (90, 90), (180, 180), (270, 270)):
        for c in (clip, square):
            for seed in range(3):
                same(seeded(lambda: CT.RandomRotation(degrees)(c), seed),
                     seeded(lambda: JCT.RandomRotation(degrees)(c), seed))


def test_color_jitter_consistent_across_frames(clip):
    for seed in range(4):
        same(seeded(lambda: CT.ColorJitter(0.5, 0.5, 0.5, 0.1)(clip), seed),
             seeded(lambda: JCT.ColorJitter(0.5, 0.5, 0.5, 0.1)(clip), seed))
        rng_args = [dict(rng=np.random.default_rng(seed)) for _ in range(2)]
        same(CT.ColorJitter(0.4, 0, 0.4, 0.5, **rng_args[0])(clip),
             JCT.ColorJitter(0.4, 0, 0.4, 0.5, **rng_args[1])(clip))
    base = np.full((4, 16, 16, 3), 100, dtype=np.uint8)
    out = seeded(lambda: CT.ColorJitter(0.5, 0.5, 0.5, 0.1)(base), 0)
    for f in out[1:]:
        np.testing.assert_array_equal(out[0], f)  # one factor set a clip


def test_to_tensor_and_normalize(clip):
    t = CT.ClipToTensor()(clip)
    same(t, JCT.ClipToTensor()(clip))
    same(CT.ClipToTensor(div_255=False)(clip), JCT.ClipToTensor(div_255=False)(clip))
    same(CT.Normalize()(t), JCT.Normalize()(t))


def test_compose(clip):
    def pipe(m):
        return m.Compose([m.Resize(32, "bicubic"), m.CenterCrop(32), m.ColorJitter(0.3, 0.3),
                          m.ClipToTensor(), m.Normalize()])

    same(seeded(lambda: pipe(CT)(clip), 5), seeded(lambda: pipe(JCT)(clip), 5))


def test_nearest_affine_and_hsv_are_pillows():
    """What the transforms rest on: Geometry.c's NEAREST affine (rotations,
    the scale-only path, a fill) and Convert.c's RGB -> HSV -> RGB, over every
    colour."""
    from tvts_torch.downstream.randaug import NEAREST, _affine, _rotate

    rng = np.random.default_rng(7)
    for _ in range(60):
        h, w = (int(v) for v in rng.integers(3, 50, 2))
        img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        angle = float(rng.uniform(-200, 200))
        same(_rotate(img[None], angle, resample=NEAREST, fillcolor=0)[0],
             Image.fromarray(img).rotate(angle))
        m = tuple(float(v) for v in rng.uniform(-1.5, 1.5, 6) * [1, 1, 9, 1, 1, 9])
        for matrix in (m, (m[0], 0.0, m[2], 0.0, m[4], m[5])):
            same(_affine(img[None], matrix, NEAREST, (128, 7, 9))[0],
                 Image.fromarray(img).transform((w, h), Image.AFFINE, matrix, Image.NEAREST,
                                                fillcolor=(128, 7, 9)))
    for red in np.arange(256)[::3].reshape(2, 43):  # every green and blue, a third of the reds
        every = np.arange(256 ** 2, dtype=np.int64)
        colours = np.stack(np.broadcast_arrays(red[:, None], every >> 8, every & 255), -1)
        colours = colours.astype(np.uint8).reshape(-1, 4096, 3)
        same(CT.rgb_to_hsv(colours), Image.fromarray(colours).convert("HSV"))
        same(CT.hsv_to_rgb(colours), Image.fromarray(colours, "HSV").convert("RGB"))


# ---------------------------------------------------------------------------
# video_transforms
# ---------------------------------------------------------------------------
def test_uniform_crop_matches(fclip):
    for idx in (0, 1, 2):
        for scale_size in (None, 40, 56):
            boxes = np.array([[5.0, 6.0, 40.0, 40.0]], dtype=np.float32)
            got, gb = VT.uniform_crop(fclip, 32, idx, boxes=boxes, scale_size=scale_size)
            want, wb = JVT.uniform_crop(fclip, 32, idx, boxes=boxes, scale_size=scale_size)
            same(got, want)
            same(gb, wb)


def test_grayscale_and_blend_match(fclip):
    same(VT.grayscale(fclip), JVT.grayscale(fclip))
    other = fclip[::-1].copy()
    same(VT.blend(fclip, other, 0.3), JVT.blend(fclip, other, 0.3))


def test_boxes_match():
    boxes = np.array([[5.0, 6.0, 40.0, 40.0], [0.0, 0.0, 70.0, 50.0]], dtype=np.float32)
    same(VT.crop_boxes(boxes, 3, 4), JVT.crop_boxes(boxes, 3, 4))
    same(VT.clip_boxes_to_image(boxes, 48, 64), JVT.clip_boxes_to_image(boxes, 48, 64))


def test_color_normalization_matches(fclip):
    mean, std = [0.45, 0.45, 0.45], [0.225, 0.225, 0.225]
    same(VT.color_normalization(fclip, mean, std), JVT.color_normalization(fclip, mean, std))
    eigval = [0.2175, 0.0188, 0.0045]
    eigvec = [[-0.5675, 0.7192, 0.4009], [-0.5808, -0.0045, -0.8140], [-0.5836, -0.6948, 0.4203]]
    same(VT.lighting_jitter(fclip, 0.1, eigval, eigvec, rng=np.random.default_rng(1)),
         JVT.lighting_jitter(fclip, 0.1, eigval, eigvec, rng=np.random.default_rng(1)))


def test_random_crop_contract(fclip):
    for seed in range(3):
        got = VT.random_crop(fclip, 32, rng=np.random.default_rng(seed))[0]
        same(got, JVT.random_crop(fclip, 32, rng=np.random.default_rng(seed))[0])


def test_horizontal_flip_contract(fclip):
    boxes = np.array([[2.0, 3.0, 10.0, 20.0]], dtype=np.float32)
    for prob in (1.0, 0.5, 0.0):
        got = VT.horizontal_flip(prob, fclip, boxes=boxes, rng=np.random.default_rng(0))
        want = JVT.horizontal_flip(prob, fclip, boxes=boxes, rng=np.random.default_rng(0))
        same(got[0], want[0])
        same(got[1], want[1])


def test_short_side_scale_jitter_contract(fclip):
    for inverse in (False, True):
        for seed in range(3):
            got, _ = VT.random_short_side_scale_jitter(
                fclip, 36, 60, inverse_uniform_sampling=inverse, rng=np.random.default_rng(seed))
            want, _ = JVT.random_short_side_scale_jitter(
                fclip, 36, 60, inverse_uniform_sampling=inverse, rng=np.random.default_rng(seed))
            same(got, want)


def test_random_resized_crop_shapes(fclip):
    for seed in range(3):
        for fn in ("random_resized_crop", "random_resized_crop_with_shift"):
            same(getattr(VT, fn)(fclip, 32, 40, rng=np.random.default_rng(seed)),
                 getattr(JVT, fn)(fclip, 32, 40, rng=np.random.default_rng(seed)))
        same(VT.random_sized_crop_img(fclip[0], 24, rng=np.random.default_rng(seed)),
             JVT.random_sized_crop_img(fclip[0], 24, rng=np.random.default_rng(seed)))


def test_three_crop(fclip, clip):
    same(VT.ThreeCrop(32)(fclip), JVT.ThreeCrop(32)(fclip))
    same(VT.ThreeCrop(32)(list(clip)), JVT.ThreeCrop(32)(pil(clip)))
    assert VT.ThreeCrop(32)(fclip).shape == (9, 3, 32, 32)


def test_create_random_augment_runs(clip):
    for interp in ("bilinear", "bicubic", "nearest"):
        for seed in range(3):
            got = VT.create_random_augment(32, "rand-m9-n3-mstd0.5", interp,
                                           rng=np.random.default_rng(seed))(clip)
            want = JVT.create_random_augment(32, "rand-m9-n3-mstd0.5", interp,
                                             rng=np.random.default_rng(seed))(pil(clip))
            same(got, arrays(want))
    assert VT.create_random_augment(32)(clip) is clip


def test_color_jitter_runs(fclip):
    for seed in range(3):
        same(VT.color_jitter(fclip, 0.4, 0.4, 0.4, rng=np.random.default_rng(seed)),
             JVT.color_jitter(fclip, 0.4, 0.4, 0.4, rng=np.random.default_rng(seed)))


def test_rrc_and_interpolation_get_params_matches():
    for scale, ratio in (((4.0, 4.0), (1.0, 1.0)), ((0.08, 1.0), (3 / 4, 4 / 3)),
                         ((0.9, 1.0), (3.0, 4.0))):
        ours = VT.RandomResizedCropAndInterpolation((8, 8), scale=scale, ratio=ratio)
        theirs = JVT.RandomResizedCropAndInterpolation((8, 8), scale=scale, ratio=ratio)
        for seed in range(20):
            assert ours.get_params(60, 40, np.random.default_rng(seed)) == \
                theirs.get_params(60, 40, np.random.default_rng(seed))
    with pytest.raises(ValueError):
        VT.RandomResizedCropAndInterpolation(8, scale=(1.0, 0.5))


def test_rrc_and_interpolation_call_shapes():
    img = np.random.default_rng(3).integers(0, 256, (40, 60, 3)).astype(np.uint8)
    clip = np.stack([img, img[::-1], 255 - img])
    for interp in ("random", "bilinear", "bicubic", "nearest", "lanczos"):
        for seed in range(3):
            def make(m):
                return m.RandomResizedCropAndInterpolation(
                    (16, 24), rng=np.random.default_rng(seed), interpolation=interp)

            same(make(VT)(img), np.asarray(make(JVT)(Image.fromarray(img))))
            same(make(VT)(clip), arrays(make(JVT)(pil(clip))))
            same(make(VT)(list(clip)), arrays(make(JVT)(list(pil(clip)))))
    assert repr(make(VT)) == repr(make(JVT))


@pytest.mark.parametrize("auto_augment", [None, "rand-m7-n2-mstd0.5-inc1"])
def test_transforms_imagenet_train_pipeline(auto_augment):
    img = np.random.default_rng(1).integers(0, 255, (48, 56, 3)).astype(np.uint8)
    clip = np.stack([img, img[:, ::-1], img // 2])
    # a named interpolation reaches RandAugment's geometric ops, where both
    # modules raise as Pillow does: "random" under RandAugment
    named = "random" if auto_augment else "bicubic"
    for kw in (dict(re_prob=0.5, re_mode="pixel"), dict(interpolation=named, vflip=0.5,
                                                        color_jitter=(0.3, 0.2, 0.1))):
        for seed in range(3):
            def make(m):
                return m.transforms_imagenet_train(img_size=32, auto_augment=auto_augment,
                                                   rng=np.random.default_rng(seed), **kw)

            ours, theirs = make(VT), make(JVT)
            same(ours(img), theirs(Image.fromarray(img)))
            same(ours(clip), theirs(pil(clip)))
    out = ours(clip)
    assert out.shape == (3, 3, 32, 32) and out.dtype == np.float32


def test_transforms_imagenet_train_separate_stages():
    img = np.random.default_rng(2).integers(0, 255, (40, 40, 3)).astype(np.uint8)
    ours = VT.transforms_imagenet_train(img_size=24, separate=True, rng=np.random.default_rng(0))
    theirs = JVT.transforms_imagenet_train(img_size=24, separate=True,
                                           rng=np.random.default_rng(0))
    p, q = ours[0](img), theirs[0](Image.fromarray(img))
    same(p, np.asarray(q))
    s, t = ours[1](p), theirs[1](q)
    same(s, np.asarray(t))
    same(ours[2](s), theirs[2](t))


def test_transforms_imagenet_train_rejects_unknown_aa():
    with pytest.raises(NotImplementedError):
        VT.transforms_imagenet_train(auto_augment="augmix-m3")


# ---------------------------------------------------------------------------
# video_transformer
# ---------------------------------------------------------------------------
def _frozen_pair(representation_size=None):
    """(flax module, seeded params, the port's module with the same weights)
    at depth 2, width 64, 4 frames of 32², 7 classes. The params take the
    shapes of the flax init (traced, not run) and seeded values on every
    leaf: the zero-init time attention and embeddings made real."""
    import jax
    import jax.numpy as jnp

    from tvts_tpu.downstream.video_transformer import SpaceTimeTransformer as JaxFrozen
    from tvts_torch.downstream.video_transformer import SpaceTimeTransformer
    from tvts_torch.utils.convert import frozen_state_dict_from_jax

    kw = dict(img_size=32, patch_size=16, num_classes=7, embed_dim=64, depth=2, num_heads=4,
              num_frames=4, representation_size=representation_size)
    model = JaxFrozen(**kw)
    video = jnp.zeros((1, 3, 4, 32, 32), jnp.float32)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), video)["params"])
    rng = np.random.default_rng(4)
    params = jax.tree_util.tree_map_with_path(
        lambda path, s: ((path[-1].key == "scale") + 0.05 * rng.standard_normal(s.shape))
        .astype(np.float32), shapes)
    port = SpaceTimeTransformer(**kw)
    port.load_state_dict({k: torch.from_numpy(v)
                          for k, v in frozen_state_dict_from_jax(params).items()})
    return model, params, port.eval()


@pytest.fixture(scope="module")
def frozen():
    return _frozen_pair()


@pytest.mark.parametrize("representation_size", [None, 32])
def test_frozen_space_time_transformer_parity(frozen, representation_size):
    from tests.test_frozen_video_transformer import convert_frozen_sd

    model, params, port = frozen if representation_size is None else \
        _frozen_pair(representation_size)
    # the reference names: the JAX test's map from a reference state dict inverts ours
    back = convert_frozen_sd(port.state_dict())
    flat = {k: v for k, v in _leaves(back)}
    assert sorted(flat) == sorted(k for k, _ in _leaves(params))
    for k, v in _leaves(params):
        np.testing.assert_array_equal(flat[k], v)
    video = np.random.default_rng(0).normal(size=(2, 3, 4, 32, 32)).astype(np.float32)
    want = np.asarray(model.apply({"params": params}, video))
    with torch.no_grad():
        got = port(torch.from_numpy(video)).numpy()
        feats = port(torch.from_numpy(video), return_features=True).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * max(1.0, np.abs(want).max()))
    head = params["head"]  # the features are the head's input
    np.testing.assert_allclose(feats @ head["kernel"] + head["bias"], want, rtol=0,
                               atol=TOL * max(1.0, np.abs(want).max()))


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield ".".join(prefix + (k,)), np.asarray(v)


def test_frozen_short_clip_truncation(frozen):
    """pos / temporal embeds truncate for clips shorter than num_frames."""
    model, params, port = frozen
    video = np.random.default_rng(1).normal(size=(1, 3, 3, 32, 32)).astype(np.float32)
    want = np.asarray(model.apply({"params": params}, video))
    with torch.no_grad():
        got = port(torch.from_numpy(video)).numpy()
    assert got.shape == (1, 7) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
