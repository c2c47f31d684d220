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


# ---------------------------------------------------------------------------
# the arithmetic of the Hopper designs, in plain torch (float32)
# ---------------------------------------------------------------------------
def _partial(logits, v):
    """(m, l, acc) of one online-softmax partial over the last axis."""
    m = logits.max(-1).values
    p = torch.exp(logits - m[..., None])
    return m, p.sum(-1), (p[..., None] * v).sum(-2)


@pytest.mark.parametrize("T, N, Hh, d", [(1, 5, 2, 80), (4, 6, 3, 64), (12, 7, 2, 16)])
def test_cls_row_fold_equals_the_full_softmax_row(T, N, Hh, d):
    """H2's fold: the CLS query as one more query row of each frame's block
    (keys: frame t's patches, plus the CLS key in frame 0 only), T f32
    partials (m, l, acc) merged in frame order as cls_combine_kernel does,
    equal the CLS row over all 1 + T*N keys, and its lse."""
    rng = np.random.default_rng(T * 100 + N)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, Hh, 1 + T * N, d)).astype(np.float32))
               for _ in range(3))
    scale = d ** -0.5
    s = (q[:, :, :1] @ k.transpose(-1, -2))[:, :, 0] * scale  # [B, H, S]
    want = torch.softmax(s, -1)[..., None].mul(v).sum(-2)
    want_lse = torch.logsumexp(s, -1)
    parts = []
    for t in range(T):
        keys = list(range(1 + t * N, 1 + (t + 1) * N)) + ([0] if t == 0 else [])
        parts.append(_partial(s[..., keys], v[:, :, keys]))
    mx = torch.stack([m for m, _, _ in parts]).max(0).values
    lsum, acc = 0, 0
    for m, l, a in parts:  # fixed order, no atomics
        w = torch.exp(m - mx)
        lsum, acc = lsum + w * l, acc + w[..., None] * a
    torch.testing.assert_close(acc / lsum[..., None], want, atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(mx + torch.log(lsum), want_lse, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("T, N, Hh, d", [(1, 5, 2, 80), (3, 7, 2, 64)])
def test_space_core_on_cpu_matches_jax_attention(T, N, Hh, d):
    """H2's core entry (block_kernels.space_core) on CPU rows [B, S, 3D]: its
    plain version equals the JAX package's divided space attention on every
    row, the CLS row over every token included, and its lse equals the
    log-sum-exp of the scaled logits of each row."""
    from tvts_tpu.ops.attention import divided_space_time_attention as jax_attention

    rng = np.random.default_rng(T * 10 + d)
    S = 1 + T * N
    qkv = rng.standard_normal((2, S, 3 * Hh * d)).astype(np.float32)
    out, lse = bk.space_core(torch.from_numpy(qkv), T, Hh, with_lse=True)
    q, k, v = (jnp.asarray(t.reshape(2, S, Hh, d).transpose(0, 2, 1, 3))  # [B, H, S, d]
               for t in np.split(qkv, 3, axis=-1))
    want = np.asarray(jax_attention(q * d ** -0.5, k, v, T, N, "space"))
    np.testing.assert_allclose(out.numpy(), want.transpose(0, 2, 1, 3).reshape(2, S, Hh * d),
                               atol=ATOL, rtol=RTOL)
    s_cls = np.einsum("bhd,bhjd->bhj", np.asarray(q[:, :, 0]) * d ** -0.5, np.asarray(k))
    np.testing.assert_allclose(lse[:, :, 0].numpy(),
                               np.log(np.exp(s_cls).sum(-1)), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("d, n_max", [(64, 783), (80, 639)])
def test_space_core_frame_limit(d, n_max):
    """The space core stages a frame's 1 + N key and value rows (and the CLS
    row's P, a float a key) in one block's shared memory (227 KB on the
    H100): N = n_max fits, one more raises."""
    assert bk.space_core_smem(196, 64) == 2 * 208 * 72 * 2 + 4 * 65 * 4  # B/16: ~61 KB
    bk._check_space_frame(n_max, d)
    assert bk.space_core_smem(n_max, d) <= bk.SMEM_OPTIN < bk.space_core_smem(n_max + 1, d)
    with pytest.raises(ValueError, match=f"at most {n_max} patches"):
        bk._check_space_frame(n_max + 1, d)


def _cls_only_absorbed(x, basecls, ln_w, ln_b, wqkv, bqkv, wproj, bproj, H, chunk):
    """H4's absorbed form (csrc/cls_pool.cuh) in plain torch: u_h = Wk_h^T q_h
    / sqrt(d), logits y . u_h (q_h . bk_h drops out of the softmax), z_h =
    sum_j p_hj y_j merged over row chunks, att_h = Wv_h z_h / l + bv_h. No k
    or v is formed."""
    from tvts_torch.models.layers import layer_norm_f32

    B, S, D = x.shape
    d = D // H
    y = layer_norm_f32(x, ln_w, ln_b)
    q = y[:, 0] @ wqkv[:D].T + bqkv[:D]  # [B, D]
    wk = wqkv[D:2 * D].reshape(H, d, D)
    u = torch.einsum("bhi,hic->bhc", q.reshape(B, H, d), wk) * d ** -0.5
    parts = [_partial(torch.einsum("bjc,bhc->bhj", y[:, r:r + chunk], u),
                      y[:, None, r:r + chunk]) for r in range(0, S, chunk)]
    mx = torch.stack([m for m, _, _ in parts]).max(0).values
    lsum, z = 0, 0
    for m, l, a in parts:
        w = torch.exp(m - mx)
        lsum, z = lsum + w * l, z + w[..., None] * a
    z = z / lsum[..., None]  # [B, H, D]
    wv = wqkv[2 * D:].reshape(H, d, D)
    att = torch.einsum("hic,bhc->bhi", wv, z).reshape(B, D) + bqkv[2 * D:]
    return basecls + (att @ wproj.T + bproj)[:, None]


@pytest.mark.parametrize("T, N, D, Hh", [(4, 6, 32, 4), (1, 6, 160, 2), (3, 5, 128, 2)])
def test_cls_only_absorbed_form_matches_plain_and_pallas(T, N, D, Hh):
    from tvts_tpu.ops.pallas_block_attention import fused_space_cls_only_v7

    rng = np.random.default_rng(T * 10 + D)

    def a(*shape, std=1.0, base=0.0):
        return (base + std * rng.standard_normal(shape)).astype(np.float32)

    x, base = a(2, 1 + T * N, D), a(2, 1 + T * N, D)
    w = dict(ln_w=a(D, std=0.1, base=1.0), ln_b=a(D, std=0.1), wqkv=a(D, 3 * D, std=0.1),
             bqkv=a(3 * D, std=0.1), wproj=a(D, D, std=0.1), bproj=a(D, std=0.1))
    xT = jnp.asarray(np.swapaxes(x[:, 1:].reshape(2, T, N, D), -1, -2))
    want = np.asarray(fused_space_cls_only_v7(xT, jnp.asarray(x[:, :1]), jnp.asarray(base[:, :1]),
                                              *(jnp.asarray(w[n]) for n in ATTN),
                                              num_heads=Hh, interpret=True))
    tw = [torch.from_numpy(np.ascontiguousarray(w[n].T if n in ("wqkv", "wproj") else w[n]))
          for n in ATTN]
    xt, bt = torch.from_numpy(x), torch.from_numpy(base[:, :1])
    plain = bk.space_cls_only_plain(xt, bt, *tw, T, Hh)
    for chunk in (16, 5):  # one chunk, and several with a ragged last one
        got = _cls_only_absorbed(xt, bt, *tw, Hh, chunk)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("B, S, slots", [(64, 2353, 264), (1, 2353, 264), (7, 589, 264),
                                         (16, 3073, 132), (300, 2353, 264), (2, 17, 16)])
def test_cls_chunks_cover_every_row_once(B, S, slots):
    C, R = bk.cls_chunks(B, S, slots)
    assert R % 16 == 0 and C * R >= S and (C - 1) * R < S  # no chunk empty
    assert C * B >= min(slots, -(-S // 16) * B)  # at least a wave of blocks
    assert C * B <= max(2 * slots, B)  # at most two waves


def test_wrappers_on_cpu_run_plain_and_count_no_launch():
    a = _arrays(4)
    bk.reset_launch_counts()
    x, base, *w = _torch(a, "x", "base", *ATTN, linear=("wqkv", "wproj"))
    out = bk.fused_space_block(x, base, *w, num_frames=T, num_heads=H)
    torch.testing.assert_close(out, bk.space_block_plain(x, base, *w, T, H), rtol=0, atol=0)
    y, stats = bk.ln_rows(x[0], w[0], w[1])
    assert y.dtype == x.dtype and stats.shape == (x.shape[1], 2)
    assert bk.launch_counts() == {fn.__name__: 0 for fn in bk.COUNTED}
    assert "ln_rows" in bk.launch_counts()
    assert bk.gemm_counts() == {"ln_gemm.tiles": 0, "ln_gemm.blocks": 0}


def test_wrappers_reject_bad_geometry_and_devices():
    a = _arrays(5)
    x, *w = _torch(a, "x", *ATTN, linear=("wqkv", "wproj"))
    with pytest.raises(ValueError, match="1 \\+ 5"):
        bk.fused_time_block(x, *w, num_frames=5, num_heads=H)
    with pytest.raises(ValueError, match="no kernel"):
        bk.fused_time_block(x.to("meta"), *w, num_frames=T, num_heads=H)
    with pytest.raises(ValueError, match="activation"):
        bk.fused_mlp_block(x, *w[:2], *_torch(a, "wfc", "bfc", "wpr", "bpr"), act="relu")


# ---------------------------------------------------------------------------
# ln_gemm's launch plan (the checks its wrapper makes before every launch)
# ---------------------------------------------------------------------------
def _attention_products(M, D):
    """(M, N, K, lda, ldy, ldres, out bytes): qkv, proj; the backward's dattn
    and dxln (f32)."""
    return [(M, 3 * D, D, D, 3 * D, 0, 2), (M, D, D, D, D, D, 2),
            (M, D, D, D, D, 0, 2), (M, D, 3 * D, 3 * D, D, 0, 4)]


def _mlp_products(M, D, hidden):
    """c_fc (bf16; f32 when the backward recomputes h), c_proj, dh, dxln."""
    return [(M, hidden, D, D, hidden, 0, 2), (M, hidden, D, D, hidden, 0, 4),
            (M, D, hidden, hidden, D, D, 2), (M, hidden, D, D, hidden, 0, 2),
            (M, D, hidden, hidden, D, 0, 4)]


def _port_products(cfg):
    """Every ln_gemm product the port issues for a model: extraction (H1-H3;
    H4 runs no ln_gemm) at B in (1, 8, 64), the train step (H5, H6, H8) at B in (1, 8, 20), the
    text tower (H7) and the sort head, with the backwards' dx products."""
    v, t, s = cfg.vision, cfg.text, cfg.sort
    D, hidden = v.width, int(v.width * v.mlp_ratio)
    S_ext, S_train = 1 + v.num_frames * v.patches_per_frame, 1 + v.num_frames * v.n_keep
    out = []
    for B in (1, 8, 64):
        out += _attention_products(B * S_ext, D) + _mlp_products(B * S_ext, D, hidden)
    for B in (1, 8, 20):
        out += _attention_products(B * S_train, D) + _mlp_products(B * S_train, D, hidden)
        M_sort = B * (S_train + cfg.num_clips)
        out += _attention_products(M_sort, s.embed_dim)
        out += _mlp_products(M_sort, s.embed_dim, int(s.embed_dim * s.mlp_ratio))
    for n_text in (1, 80, 256):
        out += _attention_products(n_text * t.context_length, t.width)
    return out


def _joint_products():
    """The ViT-g/14 joint block's products (downstream/model.vit_giant_patch14_224:
    K = 1408 at N = 4224 (a partial last 256-column tile), 1408 and 6144, and
    K = 6144 at N = 1408) at B in (1, 15, 16) clips of 2,048 tokens."""
    D, hidden = 1408, 6144
    out = []
    for B in (1, 15, 16):
        M = B * 2048
        out += [(M, 3 * D, D, D, 3 * D, 0, 2), (M, D, D, D, D, D, 2),
                (M, hidden, D, D, hidden, 0, 2), (M, D, hidden, hidden, D, D, 2)]
    return out


@pytest.mark.parametrize("arch", ["tvtsv2_b_32", "tvtsv2_b_16", "tvtsv2_h_14", "videomaev2_g14"])
def test_gemm_plan_accepts_every_product_the_port_issues(arch):
    from tvts_torch.models import configs

    BM, BN, BK = bk.GEMM_TILE
    if arch == "videomaev2_g14":
        products = _joint_products()
        assert len(products) == 12
    else:
        products = _port_products(getattr(configs, arch)())
        assert len(products) > 50
    for M, N, K, lda, ldy, ldres, out_bytes in products:
        plan = bk.gemm_plan(M, N, K, lda, ldy, ldres, out_bytes,
                            {"x": 0x7F0000000000, "w": 0x7F0000100000})
        tiles = -(-N // BN) * -(-M // BM)
        assert plan["tiles"] == tiles and plan["blocks"] == min(tiles, bk.H100_SMS)
        assert plan["box_a"] == (BK, BM) and plan["box_w"] == (BK, BN)
        assert plan["k_steps"] * BK == K
        # the ring and the epilogue buffer: what a Hopper block may take
        assert plan["smem"] >= bk.GEMM_STAGES * (BM + BN) * BK * 2 + bk.GEMM_EPI_BYTES
        assert plan["smem"] <= 232448


@pytest.mark.parametrize("tiles", [1, 131, 132, 133, 265])
def test_gemm_plan_persistent_grid(tiles):
    """One block an SM at most: a product of fewer tiles than SMs runs one
    tile a block; past that each of the SMs' blocks walks every 132nd tile
    (a ragged last wave: 133 and 265 tiles leave 1 block two or three)."""
    M = 128 * tiles  # N = 256: one column tile
    plan = bk.gemm_plan(M - 5, 256, 768, 768, 256)
    assert plan["tiles"] == tiles and plan["blocks"] == min(tiles, 132)
    walks = [len(range(b, tiles, plan["blocks"])) for b in range(plan["blocks"])]
    assert sum(walks) == tiles and max(walks) == -(-tiles // plan["blocks"])
    assert bk.gemm_plan(M, 256, 768, 768, 256, sms=66)["blocks"] == min(tiles, 66)


def test_gemm_plan_raises_naming_the_argument():
    with pytest.raises(ValueError, match="K = 96"):
        bk.gemm_plan(128, 256, 96, 96, 256)
    with pytest.raises(ValueError, match="K = 32"):
        bk.gemm_plan(128, 256, 32, 32, 256)
    with pytest.raises(ValueError, match="lda = 772"):  # 1544 bytes
        bk.gemm_plan(128, 256, 768, 772, 256)
    with pytest.raises(ValueError, match="ldy = 260"):
        bk.gemm_plan(128, 256, 768, 768, 260)
    with pytest.raises(ValueError, match="ldres = 12"):
        bk.gemm_plan(128, 256, 768, 768, 256, ldres=12)
    with pytest.raises(ValueError, match="x at 0x1002"):
        bk.gemm_plan(128, 256, 768, 768, 256, pointers={"x": 0x1002})
    with pytest.raises(ValueError, match="N = 260"):
        bk.gemm_plan(128, 260, 768, 768, 264)
    bk.gemm_plan(128, 256, 768, 768, 260, out_bytes=4)  # 1040 bytes: an f32 row may


def test_ln_gemm_wrapper_checks_the_plan_before_any_launch():
    # no library is loaded or called: the plan refuses first, and counts nothing
    bk.reset_launch_counts()
    x = torch.zeros(4, 96, dtype=torch.bfloat16)
    w = torch.zeros(64, 96, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="K = 96"):
        bk._ln_gemm(None, x, 4, 96, None, w, None, torch.empty(4, 64, dtype=torch.bfloat16))
    # the residual comes in through the bf16 output's slot of the epilogue only
    x, w = torch.zeros(4, 128, dtype=torch.bfloat16), torch.zeros(64, 128, dtype=torch.bfloat16)
    res = torch.zeros(4, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="residual"):
        bk._ln_gemm(None, x, 4, 128, None, w, None, torch.empty(4, 64), res=res, ldres=64)
    with pytest.raises(ValueError, match="residual"):
        bk._ln_gemm(None, x, 4, 128, None, w, None, torch.empty_like(res), res=res, ldres=64,
                    pre=torch.empty_like(res))
    assert bk.gemm_counts() == {"ln_gemm.tiles": 0, "ln_gemm.blocks": 0}


# ---------------------------------------------------------------------------
# the LayerNorm row pass: its plain version and the checks before a launch
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("K", [512, 768, 1024, 1280])
@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_ln_rows_plain_matches_layer_norm(K, eps):
    rng = np.random.default_rng(K)
    x = torch.from_numpy((0.5 + 2.0 * rng.standard_normal((37, K))).astype(np.float32))
    w = torch.from_numpy((1.0 + 0.1 * rng.standard_normal(K)).astype(np.float32))
    b = torch.from_numpy((0.1 * rng.standard_normal(K)).astype(np.float32))
    y, stats = bk.ln_rows_plain(x, w, b, eps)
    torch.testing.assert_close(y, torch.nn.functional.layer_norm(x, (K,), w, b, eps),
                               atol=1e-5, rtol=1e-5)
    var, mean = torch.var_mean(x.double(), -1, unbiased=False)
    torch.testing.assert_close(stats[:, 0].double(), mean, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(stats[:, 1].double(), torch.rsqrt(var + eps), atol=0, rtol=1e-5)
    # the wrapper runs the plain version on a CPU tensor, bf16 rows included
    xb = x.to(torch.bfloat16)
    got, got_stats = bk.ln_rows(xb, w, b, eps)
    want, want_stats = bk.ln_rows_plain(xb, w, b, eps)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want) and torch.equal(got_stats, want_stats)


def test_ln_rows_plan_raises_naming_the_argument():
    bk.ln_rows_plan(1, 8, 8)
    bk.ln_rows_plan(150592, 768, 2304, {"x": 0x7F0000000000})
    bk.ln_rows_plan(7, bk.LN_ROWS_MAX_K, bk.LN_ROWS_MAX_K)
    with pytest.raises(ValueError, match="M = 0"):
        bk.ln_rows_plan(0, 768, 768)
    for K in (4, 100, bk.LN_ROWS_MAX_K + 64):
        with pytest.raises(ValueError, match=f"K = {K}"):
            bk.ln_rows_plan(8, K, K + 8)
    with pytest.raises(ValueError, match="lda = 772"):  # 1544 bytes
        bk.ln_rows_plan(8, 768, 772)
    with pytest.raises(ValueError, match="lda = 512"):
        bk.ln_rows_plan(8, 768, 512)
    with pytest.raises(ValueError, match="ln_w at 0x1004"):
        bk.ln_rows_plan(8, 768, 768, {"ln_w": 0x1004})


@pytest.mark.parametrize("arch", ["tvtsv2_b_32", "tvtsv2_b_16", "tvtsv2_h_14"])
def test_ln_rows_plan_accepts_every_layer_norm_product_the_port_issues(arch):
    from tvts_torch.models import configs

    cfg = getattr(configs, arch)()
    widths = {cfg.vision.width, cfg.text.width, cfg.sort.embed_dim}
    ln_products = [(M, K, lda) for M, N, K, lda, *_ in _port_products(cfg)
                   if N in (3 * K, 4 * K) and K in widths]  # qkv and c_fc follow a LayerNorm
    assert len(ln_products) > 20
    for M, K, lda in ln_products:
        bk.ln_rows_plan(M, K, lda, {"x": 0x7F0000000000})


def test_ln_gemm_wrapper_checks_the_row_pass_before_any_launch():
    # no library is loaded or called: the row pass's plan refuses first
    bf = torch.bfloat16
    K = bk.LN_ROWS_MAX_K + 64  # a depth the product takes and the row pass does not
    x, w = torch.zeros(4, K, dtype=bf), torch.zeros(64, K, dtype=bf)
    ln = (torch.ones(K), torch.zeros(K))
    with pytest.raises(ValueError, match=f"K = {K}"):
        bk._ln_gemm(None, x, 4, K, ln, w, None, torch.empty(4, 64, dtype=bf))
    x, w = torch.zeros(4, 768, dtype=bf), torch.zeros(64, 768, dtype=bf)
    ln_w = torch.ones(769)[1:]  # 4 bytes off
    assert ln_w.data_ptr() % 16
    with pytest.raises(ValueError, match="ln_w at .* not 16-byte aligned"):
        bk._ln_gemm(None, x, 4, 768, (ln_w, torch.zeros(768)), w, None,
                    torch.empty(4, 64, dtype=bf))
    assert bk.ln_rows.launches == 0


def test_chip_smoke_gemm_fit_recovers_the_tile_model():
    """chip_smoke's fit of ln_gemm's per-tile fixed cost and per-k-step cost
    from proj (K = 768) and c_proj (K = 3072) at M = 150,592: 3,531 tiles,
    27 tiles a block over 132 SMs."""
    from chip_smoke import gemm_fit

    tiles = bk.gemm_plan(150592, 768, 768, 768, 768)["tiles"]
    assert tiles == 3531
    fixed, step = 5.8, 0.73
    rows = [dict(name=name, M=150592, N=768, K=K, ms=27 * (fixed + K // 64 * step) / 1000)
            for name, K in (("extraction proj (H1, H2)", 768), ("extraction c_proj (H3)", 3072))]
    fit = gemm_fit(rows, 132)
    assert fit["waves"] == 27
    assert fit["fixed_us"] == pytest.approx(fixed) and fit["step_us"] == pytest.approx(step)


def test_chip_smoke_small_gemm_products_run_one_tile_a_block():
    from chip_smoke import small_gemm_products

    for p in small_gemm_products():
        plan = bk.gemm_plan(p["M"], p["N"], p["K"], p["lda"], p["N"])
        assert plan["tiles"] < bk.H100_SMS and plan["blocks"] == plan["tiles"]
