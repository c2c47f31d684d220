"""The port's text side on the CPU against the JAX package: the tokenizer (ids
exactly), the eager TextTransformer against flax `apply`, the plain version of
the H7 text-attention kernel against the Pallas kernel in interpret mode, the
fused text forward (EOT-only last block) against the JAX one and `apply`, the
converter on a full TVTSv2 tree, and build_model on a reference `.pth`.
Tolerance atol 3e-5 / rtol 1e-4 in float32 (summation order only); every
parameter carries seeded noise."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from tests.test_torch_vit import ATOL, RTOL, tiny_vision
from tvts_torch.models import configs
from tvts_torch.ops.text_attention import (
    fused_text_attention_block,
    text_attention_block_plain,
    text_transformer_fused_forward,
)
from tvts_torch.text import tokenizer as port_tok
from tvts_torch.utils.convert import state_dict_from_jax

TOKENIZER_BATTERY = [
    "a photo of a cat",
    "A person is playing the guitar on stage!!",
    "don't you'll we're i'm they've she'd it's IT'S",
    "&amp;lt;b&amp;gt; fish &amp; chips &quot;quoted&quot; &#39;x&#39;",
    "naïve café résumé Ångström Ünïcödé",
    "東京の大学で勉強します 中文字符 한국어",
    "x² y³ ½ ¾ Ⅻ ⅻ ٣ ۴ ४ 𝟙 ①",
    "   whitespace\t\tand\nnewlines    everywhere  ",
    "emoji 🎉🎉 and symbols ©®™ — … ‰",
    "a\x1cb\x1fc ͅd 'ſ ſ's 'S",
    "",
    "supercalifragilisticexpialidocious " * 30,  # far more than 77 tokens
]


def tiny_text(act: str = "quick_gelu") -> dict:
    """Text tower of the toy geometry: width 64, 3 layers, 4 heads, context
    16, the full CLIP vocab (captions go through the real tokenizer)."""
    return dict(context_length=16, vocab_size=49408, width=64, layers=3, heads=4,
                output_dim=48, act=act)


def tiny_ids(seed: int, batch: int = 5, ctx: int = 16) -> np.ndarray:
    """Zero-padded ids with EOT (49407, the largest) at varied positions."""
    rng = np.random.default_rng(seed)
    ids = np.zeros((batch, ctx), np.int32)
    for row in range(batch):
        n = int(rng.integers(2, ctx + 1)) if row else ctx
        ids[row, :n] = rng.integers(1, 49406, n)
        ids[row, 0], ids[row, n - 1] = 49406, 49407
    return ids


def _noisy(params, seed):
    noise = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.02 * noise.normal(size=a.shape).astype(np.float32), params)


def jax_tvts(act: str = "quick_gelu", seed: int = 0):
    """(flax TVTSv2, full param tree with seeded noise, jax config) at toy size."""
    return _jax_tvts(act, seed)  # one cache entry however the defaults are spelled


@functools.cache
def _jax_tvts(act: str, seed: int):
    from tvts_tpu.models import configs as jc
    from tvts_tpu.models.factory import init_params
    from tvts_tpu.models.tvts_v2 import TVTSv2

    cfg = jc.TVTSv2Config(name="tiny", vision=jc.VisionConfig(**tiny_vision()),
                          text=jc.TextConfig(**tiny_text(act)),
                          sort=jc.SortConfig(embed_dim=48, num_heads=4))
    model = TVTSv2(cfg)
    return model, _noisy(init_params(model, cfg, seed=seed), seed + 1), cfg


def port_config(act: str = "quick_gelu", eval_mode: bool = False) -> configs.TVTSv2Config:
    cfg = configs.TVTSv2Config(name="tiny", vision=configs.VisionConfig(**tiny_vision()),
                               text=configs.TextConfig(**tiny_text(act)),
                               sort=configs.SortConfig(embed_dim=48, num_heads=4))
    return cfg.eval_config() if eval_mode else cfg


def port_tvts(params, act: str = "quick_gelu"):
    """The port's TVTSv2 holding a JAX full tree's weights, the sort head's too."""
    from tvts_torch.models.tvts_v2 import TVTSv2

    model = TVTSv2(port_config(act))
    sd = {k: torch.from_numpy(v) for k, v in state_dict_from_jax(params).items()}
    model.load_state_dict(sd, strict=True)
    return model.eval()


# ---------------------------------------------------------------------------
# tokenizer
# ---------------------------------------------------------------------------
@functools.cache
def _tokenizers():
    from tvts_tpu.text.tokenizer import ClipBpeTokenizer

    return port_tok.ClipBpeTokenizer(), ClipBpeTokenizer()


@pytest.mark.parametrize("text", TOKENIZER_BATTERY)
def test_tokenizer_ids_equal_jax(text):
    from tvts_tpu.text import tokenizer as jax_tok

    port, ref = _tokenizers()
    assert port.encode(text) == ref.encode(text)
    np.testing.assert_array_equal(port_tok.tokenize_openclip([text, "a cat"]),
                                  jax_tok.tokenize_openclip([text, "a cat"]))
    if len(ref.encode(text)) + 2 > 77:
        for tok in (port_tok, jax_tok):
            with pytest.raises(RuntimeError, match="too long"):
                tok.tokenize(text)
        assert port_tok.tokenize_openclip(text)[0, -1] == port.eot_id


def test_tokenizer_vocab_and_decode():
    port, ref = _tokenizers()
    assert (port.vocab_size, port.sot_id, port.eot_id) == (ref.vocab_size, 49406, 49407)
    assert port.decode(port.encode("a photo of a cat")).strip() == "a photo of a cat"
    assert port_tok.tokenize(["a cat", "a dog"]).dtype == np.int32


# Code points Python's Unicode tables leave unassigned (Cn) are left out: the
# `regex` package may carry newer tables that call some of them letters.
@settings(max_examples=60, deadline=None)
@given(st.text(alphabet=st.characters(exclude_categories=("Cs", "Cn")), max_size=40))
def test_tokenizer_ids_equal_jax_property(text):
    port, ref = _tokenizers()
    assert port.encode(text) == ref.encode(text)


# ---------------------------------------------------------------------------
# towers and the H7 kernel's plain version
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_text_transformer_matches_flax(act):
    from tvts_tpu.models.configs import TextConfig as JaxTextConfig
    from tvts_tpu.models.text import TextTransformer as JaxTextTransformer

    from tvts_torch.models.text import TextTransformer

    ids = tiny_ids(1)
    module = JaxTextTransformer(JaxTextConfig(**tiny_text(act)))
    params = _noisy(module.init(jax.random.PRNGKey(3), jnp.asarray(ids))["params"], 4)
    want = module.apply({"params": params}, jnp.asarray(ids))
    model = TextTransformer(configs.TextConfig(**tiny_text(act)))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           state_dict_from_jax({"text_model": params}).items()}, strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(ids))
        fused = text_transformer_fused_forward(model, torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(fused.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def _attention_arrays(seed, B=3, S=13, D=32):
    rng = np.random.default_rng(seed)

    def a(*shape, std=1.0, base=0.0):
        return (base + std * rng.standard_normal(shape)).astype(np.float32)

    return dict(x=a(B, S, D), ln_w=a(D, std=0.1, base=1.0), ln_b=a(D, std=0.1),
                wqkv=a(D, 3 * D, std=0.1), bqkv=a(3 * D, std=0.1), wproj=a(D, D, std=0.1),
                bproj=a(D, std=0.1))


@pytest.mark.parametrize("causal,eps", [(True, 1e-5), (False, 1e-6)])
def test_text_attention_plain_matches_pallas(causal, eps):
    from tvts_tpu.ops.pallas_text_attention import fused_text_attention_block as pallas

    a = _attention_arrays(5 + causal)
    names = ("x", "ln_w", "ln_b", "wqkv", "bqkv", "wproj", "bproj")
    want = pallas(*(jnp.asarray(a[n]) for n in names), num_heads=4, causal=causal, eps=eps,
                  interpret=True)
    args = [torch.from_numpy(np.ascontiguousarray(a[n].T if n in ("wqkv", "wproj") else a[n]))
            for n in names]
    before = fused_text_attention_block.launches
    got = fused_text_attention_block(*args, num_heads=4, causal=causal, eps=eps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(got, text_attention_block_plain(*args, 4, causal, eps),
                               rtol=0, atol=0)
    assert fused_text_attention_block.launches == before  # a CPU tensor runs the plain version
    with pytest.raises(ValueError, match="no kernel"):
        fused_text_attention_block(args[0].to("meta"), *args[1:], num_heads=4)


@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_text_fused_forward_matches_jax_fused_and_apply(act):
    from tvts_tpu.ops.pallas_text_attention import text_transformer_fused_forward as jax_fused

    model, params, cfg = jax_tvts(act)
    ids = tiny_ids(2, batch=4)
    want_apply = model.apply({"params": params}, jnp.asarray(ids),
                             method=lambda m, t: m.compute_text(t))
    want_fused = jax_fused(params["text_model"], cfg.text, jnp.asarray(ids),
                           dtype=jnp.float32, interpret=True)
    with torch.no_grad():
        got = text_transformer_fused_forward(port_tvts(params, act), torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want_fused), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_apply), atol=ATOL, rtol=RTOL)


def test_self_attention_q_tail_is_the_last_rows_of_full():
    from tvts_torch.models.layers import SelfAttention

    attn = SelfAttention(32, 4)
    attn.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.from_numpy(_attention_arrays(9)["x"])
    with torch.no_grad():
        torch.testing.assert_close(attn(x, q_tail=5), attn(x)[:, -5:])
        with pytest.raises(ValueError, match="q_tail"):
            attn(x, causal=True, q_tail=5)


# ---------------------------------------------------------------------------
# weights: converter, container, build_model
# ---------------------------------------------------------------------------
def test_state_dict_from_jax_full_tree_equals_export():
    from tvts_tpu.utils.torch_convert import export_state_dict

    _, params, _ = jax_tvts()
    want = export_state_dict(params, ddp_prefix=False)
    got = state_dict_from_jax(params)
    assert list(got) == list(want)
    for key in want:
        assert got[key].dtype == want[key].dtype == np.float32
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    # the reference names of the text tower, passed through untransposed where direct
    assert got["text_token_embedding.weight"].shape == (49408, 64)
    assert got["text_projection"].shape == (64, 48)
    assert got["text_model.resblocks.2.attn.in_proj_weight"].shape == (192, 64)
    assert "text_model.resblocks.0.attn.out_proj.bias" in got
    assert "pred_model.blocks.1.mlp.fc2.weight" in got


def test_tvts_v2_holds_the_reference_layout_without_the_sort_head():
    """The towers hold the reference layout without the sort head's keys, the
    sort head (`pred_model.*`) holds exactly its own, and the training forward
    returns the three outputs."""
    from tvts_tpu.utils.torch_convert import export_state_dict

    from tests.test_torch_vit import tiny_inputs

    _, params, cfg = jax_tvts()
    model = port_tvts(params)
    reference = set(export_state_dict(params, ddp_prefix=False))
    sort_head = {k for k in reference if k.startswith("pred_model.")}
    towers = {k for k in model.state_dict() if not k.startswith("pred_model.")}
    assert towers == reference - sort_head
    assert set(model.state_dict()) - towers == sort_head
    video, keep = tiny_inputs(3)
    ids = np.concatenate([tiny_ids(4 + c, batch=2) for c in range(cfg.num_clips)])
    with torch.no_grad():
        text_emb, video_emb, order = model(torch.from_numpy(video), torch.from_numpy(ids),
                                           torch.from_numpy(keep))
    assert text_emb.shape == video_emb.shape == (2, 48)
    assert order.shape == (2, cfg.num_clips, cfg.sort.num_classes)


def test_build_model_loads_full_reference_pth(monkeypatch, tmp_path):
    from tvts_tpu.utils.torch_convert import save_reference_checkpoint

    from tvts_torch.models.factory import build_model

    monkeypatch.setitem(configs.MODEL_REGISTRY, "tiny", port_config)
    _, params, _ = jax_tvts()
    path = str(tmp_path / "tiny.pth")
    save_reference_checkpoint(params, path, arch="tiny")
    cfg, model = build_model("tiny", load_checkpoint=path, dtype=torch.bfloat16, device="cpu")
    assert cfg.vision.mask_ratio == 0.0 and not model.training
    assert model.text_model.resblocks[0].ln_1.weight.dtype == torch.float32
    assert model.pred_model.norm.weight.dtype == torch.float32
    for key, value in state_dict_from_jax(params).items():  # the sort head loads strictly
        want = torch.from_numpy(value)
        got = model.state_dict()[key]
        torch.testing.assert_close(got.float(), want.to(got.dtype).float(), rtol=0, atol=0,
                                   msg=key)
