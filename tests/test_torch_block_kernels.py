"""The plain versions of the four Hopper sub-path kernels (what the wrappers
run on a CPU tensor) against the Pallas functions they replace, run in
interpret mode in float32 with the exact softmax (smv="base"). The port keeps
tokens row-major [B, 1+T*N, D]; the Pallas kernels take the d-major
xT = x[:, 1:].reshape(B, T, N, D).swapaxes(-1, -2) plus the CLS row.
Tolerance atol 3e-5 / rtol 1e-4 (float32, summation order only)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tvts_torch.ops import block_kernels as bk

pytestmark = pytest.mark.kernels

ATOL, RTOL = 3e-5, 1e-4
B, T, N, D, H = 2, 4, 6, 32, 4


def _arrays(seed):
    rng = np.random.default_rng(seed)

    def a(*shape, std=1.0, base=0.0):
        return (base + std * rng.standard_normal(shape)).astype(np.float32)

    return dict(x=a(B, 1 + T * N, D), base=a(B, 1 + T * N, D),
                ln_w=a(D, std=0.1, base=1.0), ln_b=a(D, std=0.1),
                wqkv=a(D, 3 * D, std=0.1), bqkv=a(3 * D, std=0.1),
                wproj=a(D, D, std=0.1), bproj=a(D, std=0.1),
                wfc=a(D, 4 * D, std=0.1), bfc=a(4 * D, std=0.1),
                wpr=a(4 * D, D, std=0.1), bpr=a(D, std=0.1))


def _dmajor(x):
    """[B, S, D] numpy -> (xT [B, T, D, N], cls [B, 1, D]) as jax arrays."""
    xT = np.swapaxes(x[:, 1:].reshape(B, T, N, D), -1, -2)
    return jnp.asarray(xT), jnp.asarray(x[:, :1])


def _rowmajor(oT, ocls):
    patches = np.swapaxes(np.asarray(oT), -1, -2).reshape(B, T * N, D)
    return np.concatenate([np.asarray(ocls), patches], axis=1)


def _torch(a, *names, linear=()):
    """Tensors of `a`; names in `linear` go to the nn.Linear [out, in] layout."""
    return [torch.from_numpy(np.ascontiguousarray(a[n].T if n in linear else a[n]))
            for n in names]


def _jax(a, *names):
    return [jnp.asarray(a[n]) for n in names]


ATTN = ("ln_w", "ln_b", "wqkv", "bqkv", "wproj", "bproj")


def test_time_plain_matches_pallas():
    from tvts_tpu.ops.pallas_block_attention import fused_time_attention_block_v7

    a = _arrays(0)
    want = _rowmajor(*fused_time_attention_block_v7(
        *_dmajor(a["x"]), *_jax(a, *ATTN), num_heads=H, smv="base", interpret=True))
    got = bk.fused_time_block(*_torch(a, "x", *ATTN, linear=("wqkv", "wproj")),
                              num_frames=T, num_heads=H)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_space_plain_matches_pallas():
    from tvts_tpu.ops.pallas_block_attention import fused_space_attention_block_v9

    a = _arrays(1)
    xT, cls = _dmajor(a["x"])
    baseT, basecls = _dmajor(a["base"])
    want = _rowmajor(*fused_space_attention_block_v9(
        xT, baseT, cls, basecls, *_jax(a, *ATTN), num_heads=H, fpp=2, smv="base",
        interpret=True))
    got = bk.fused_space_block(*_torch(a, "x", "base", *ATTN, linear=("wqkv", "wproj")),
                               num_frames=T, num_heads=H)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_mlp_plain_matches_pallas(act):
    from tvts_tpu.ops.pallas_block_attention import fused_mlp_block_v7

    a = _arrays(2)
    mlp = ("ln_w", "ln_b", "wfc", "bfc", "wpr", "bpr")
    want = _rowmajor(*fused_mlp_block_v7(*_dmajor(a["x"]), *_jax(a, *mlp), act=act,
                                         interpret=True))
    got = bk.fused_mlp_block(*_torch(a, "x", *mlp, linear=("wfc", "wpr")), act=act)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_cls_only_plain_matches_pallas():
    from tvts_tpu.ops.pallas_block_attention import fused_space_cls_only_v7

    a = _arrays(3)
    xT, cls = _dmajor(a["x"])
    want = fused_space_cls_only_v7(xT, cls, jnp.asarray(a["base"][:, :1]),
                                   *_jax(a, *ATTN), num_heads=H, interpret=True)
    x, base, *w = _torch(a, "x", "base", *ATTN, linear=("wqkv", "wproj"))
    got = bk.fused_space_cls_only(x, base[:, :1], *w, num_frames=T, num_heads=H)
    assert got.shape == (B, 1, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_wrappers_on_cpu_run_plain_and_count_no_launch():
    a = _arrays(4)
    bk.reset_launch_counts()
    x, base, *w = _torch(a, "x", "base", *ATTN, linear=("wqkv", "wproj"))
    out = bk.fused_space_block(x, base, *w, num_frames=T, num_heads=H)
    torch.testing.assert_close(out, bk.space_block_plain(x, base, *w, T, H), rtol=0, atol=0)
    assert bk.launch_counts() == {fn.__name__: 0 for fn in bk.KERNELS}


def test_wrappers_reject_bad_geometry_and_devices():
    a = _arrays(5)
    x, *w = _torch(a, "x", *ATTN, linear=("wqkv", "wproj"))
    with pytest.raises(ValueError, match="1 \\+ 5"):
        bk.fused_time_block(x, *w, num_frames=5, num_heads=H)
    with pytest.raises(ValueError, match="no kernel"):
        bk.fused_time_block(x.to("meta"), *w, num_frames=T, num_heads=H)
    with pytest.raises(ValueError, match="activation"):
        bk.fused_mlp_block(x, *w[:2], *_torch(a, "wfc", "bfc", "wpr", "bpr"), act="relu")
