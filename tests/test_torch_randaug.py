"""The port's RandAugment (numpy, no PIL) against the JAX module's, which
calls Pillow frame by frame:
- every op of OPS bit for bit, on seeded uint8 clips of odd and full sizes
  (37x53, 224x224) holding a random frame, a smooth one, a constant one and
  one of two grey levels, at magnitudes over [0, 10] with both signs of
  `_neg` (both of Image.blend's branches), the geometric ops with BILINEAR
  and BICUBIC; posterize at 0 and 8 bits, the enhance ops at factor 0 and 1;
- RandAugment(num_ops=4, magnitude=7) (the dataset's) and the parser's
  weighted and increasing sets on a 4-frame clip from two generators seeded
  alike: equal frames and equal generator states after;
- the parser on tests/test_randaug_parity.py's four strings."""

import numpy as np
import pytest

from tvts_torch.downstream import randaug as P

LEVELS = (0.0, 2.5, 5.0, 7.0, 8.6, 10.0)
SIZES = ((37, 53), (224, 224))


def jax_randaug():
    from tvts_tpu.downstream import randaug

    return randaug


class _Sign:
    """An rng whose random() makes `_neg` keep (0.0) or negate (1.0) the value."""

    def __init__(self, value: float):
        self.value = value

    def random(self):
        return self.value


def clip(shape, seed=0) -> np.ndarray:
    """[4, H, W, 3] uint8: random, smooth, constant, two grey levels."""
    h, w = shape
    rng = np.random.default_rng((seed, h, w))
    frames = rng.integers(0, 256, size=(4, h, w, 3), dtype=np.uint8)
    yy, xx = np.mgrid[:h, :w]
    smooth = ((np.sin(xx / 7.0) + np.cos(yy / 5.0)) * 60 + 128).astype(np.uint8)
    frames[1] = np.stack([smooth, smooth[::-1], 255 - smooth], -1)
    frames[2] = (77, 200, 3)
    frames[3] = np.where((xx + yy)[..., None] % 3 == 0, 10, 250).astype(np.uint8)
    return frames


def jax_op(name, frames, args, resample):
    from PIL import Image

    J = jax_randaug()
    fn, _, geometric = J.OPS[name]
    kw = {"fillcolor": J._FILL, "resample": resample} if geometric else {}
    return np.stack([np.asarray(fn(Image.fromarray(f), *args, **kw)) for f in frames])


def op_args(name):
    """The op's arguments from its level function over LEVELS and both signs,
    plus its edge cases."""
    J = jax_randaug()
    _, level_fn, _ = J.OPS[name]
    if level_fn is None:
        return [()]
    hp = dict(J._HPARAMS_DEFAULT)
    args = {level_fn(level, hp, _Sign(sign)) for level in LEVELS for sign in (0.0, 1.0)}
    if name.startswith("Posterize"):
        args |= {(0,), (8,)}
    if name in ("Color", "Contrast", "Brightness", "Sharpness"):
        args |= {(0.0,), (1.0,)}
    return sorted(args)


def test_op_names_and_level_functions_equal():
    J = jax_randaug()
    assert list(P.OPS) == list(J.OPS)
    assert P.RAND_TRANSFORMS == J.RAND_TRANSFORMS
    assert P.RAND_INCREASING_TRANSFORMS == J.RAND_INCREASING_TRANSFORMS
    assert P._RAND_CHOICE_WEIGHTS_0 == J._RAND_CHOICE_WEIGHTS_0
    hp = dict(J._HPARAMS_DEFAULT)
    for name in J.OPS:
        jf, pf = J.OPS[name][1], P.OPS[name][1]
        assert (jf is None) == (pf is None) and J.OPS[name][2] == P.OPS[name][2]
        for level in LEVELS:
            for sign in (0.0, 1.0):
                if jf is not None:
                    assert pf(level, hp, _Sign(sign)) == jf(level, hp, _Sign(sign)), name


@pytest.mark.parametrize("name", list(P.OPS))
def test_op_bit_for_bit_pillow(name):
    from PIL import Image

    geometric = P.OPS[name][2]
    resamples = ((Image.BILINEAR, P.BILINEAR), (Image.BICUBIC, P.BICUBIC)) if geometric \
        else ((None, None),)
    fn = P.OPS[name][0]
    for shape in SIZES:
        frames = clip(shape)
        for args in op_args(name):
            for pil_rs, port_rs in resamples:
                kw = {"fillcolor": P._FILL, "resample": port_rs} if geometric else {}
                got = fn(frames, *args, **kw)
                want = jax_op(name, frames, args, pil_rs)
                assert got.dtype == np.uint8 and got.shape == frames.shape
                np.testing.assert_array_equal(got, want, err_msg=f"{name}{args} {shape} {pil_rs}")
                # one frame alone, as the ops also take [H, W, 3]
                np.testing.assert_array_equal(fn(frames[1], *args, **kw), want[1])


@pytest.mark.parametrize("config", [None, "rand-m9-n4-mstd0.5-inc1", "rand-mstd1-w0"],
                         ids=["dataset", "increasing", "weighted"])
@pytest.mark.parametrize("seed", range(6))
def test_rand_augment_clip_and_generator_equal(config, seed):
    J = jax_randaug()
    frames = clip((48, 64), seed)
    gj, gp = np.random.default_rng(seed), np.random.default_rng(seed)
    if config is None:  # what cls_dataset builds
        ja, pa = J.RandAugment(num_ops=4, magnitude=7, rng=gj), P.RandAugment(num_ops=4,
                                                                               magnitude=7, rng=gp)
    else:
        ja, pa = J.rand_augment_transform(config, rng=gj), P.rand_augment_transform(config,
                                                                                     rng=gp)
    for _ in range(3):
        want, got = ja(frames), pa(frames)
        np.testing.assert_array_equal(got, want)
    assert gp.bit_generator.state == gj.bit_generator.state


@pytest.mark.parametrize("config", ["rand-m7-n4-mstd0.5-inc1", "rand-m9-n3-mstd0.5",
                                    "rand-mstd1-w0", "rand-m5-n2-inc1"])
def test_parser_equal(config):
    J = jax_randaug()
    want, got = J.rand_augment_transform(config), P.rand_augment_transform(config)
    assert got.num_ops == want.num_ops
    assert [o.name for o in got.ops] == [o.name for o in want.ops]
    assert [(o.magnitude, o.magnitude_std, o.prob, o.fill) for o in got.ops] == \
        [(o.magnitude, o.magnitude_std, o.prob, o.fill) for o in want.ops]
    if want.choice_weights is None:
        assert got.choice_weights is None
    else:
        np.testing.assert_array_equal(got.choice_weights, want.choice_weights)
    with pytest.raises(ValueError):
        P.rand_augment_transform("auto-m7")
