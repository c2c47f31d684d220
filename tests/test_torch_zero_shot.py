"""The port's zero-shot eval on the CPU against the JAX package: sim_matrix and
the retrieval metrics (ties and query masks included), sliding_window_meanpool,
and run_retrieval / run_recognition / run_ssv2_mc on the same weights and a
ragged loader. The JAX side runs its eager towers (its fused text path has no
interpret switch); the port runs both its eager towers and, with
use_fused=True, the kernels' plain versions. Tolerance atol 3e-5 / rtol 1e-4
in float32; ranks and counts exactly."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_text import jax_tvts, port_tvts
from tests.test_torch_vit import ATOL, RTOL
from tvts_torch.eval.zero_recognition import build_zero_shot_classifier, run_recognition
from tvts_torch.eval.zero_ret import run_retrieval, sliding_window_meanpool
from tvts_torch.eval.zero_ssv2_mc import run_ssv2_mc
from tvts_torch.ops import metrics
from tvts_torch.ops.sim import l2_normalize, sim_matrix

CLASSNAMES = ["running", "jumping", "eating spaghetti", "playing the guitar", "swimming",
              "riding a bike"]
TEMPLATES = ["a person {}", "a video of {}"]
CAPTIONS = ["a man runs", "a man runs", "a dog jumps over a fence", "someone cooks",
            "someone cooks", "someone cooks",
            "a very long caption that goes on and on well past the short context"]
PATHS = ["v0", "v0", "v1", "v2", "v2", "v2", "v3"]  # repeated windows of one video
N_OPT = 4


def _clips(seed: int, n: int = 7):
    rng = np.random.default_rng(seed)
    video = rng.normal(size=(n, 4, 3, 32, 32)).astype(np.float32)
    return video, np.tile(np.arange(4, dtype=np.int32), (n, 1))  # eval: every patch


class _Loader:
    """Batches of `batch_size` rows (the last ragged) of per-clip columns;
    `options` ([n_options][n_clips] strings) goes out option-major as 'text'."""

    def __init__(self, batch_size: int, **columns):
        self.batch_size, self.columns = batch_size, columns

    def __iter__(self):
        n = len(self.columns["video"])
        for i in range(0, n, self.batch_size):
            rows = slice(i, i + self.batch_size)
            batch = {k: c[rows] for k, c in self.columns.items() if k != "options"}
            if "options" in self.columns:
                batch["text"] = [opts[rows] for opts in self.columns["options"]]
            yield batch


def _retrieval_loader():
    video, keep = _clips(11)
    metas = [{"paths": p, "raw_captions": c} for p, c in zip(PATHS, CAPTIONS)]
    return _Loader(3, video=video, keep_ind=keep, text=list(CAPTIONS), meta=metas)


def _recognition_loader():
    video, keep = _clips(12)
    labels = np.random.default_rng(13).integers(0, len(CLASSNAMES), len(video))
    return _Loader(3, video=video, keep_ind=keep, label=labels)


def _mc_loader():
    video, keep = _clips(14)
    options = [[f"a person {CLASSNAMES[(k + o) % len(CLASSNAMES)]}" for k in range(len(video))]
               for o in range(N_OPT)]
    labels = np.random.default_rng(15).integers(0, N_OPT, len(video))
    return _Loader(3, video=video, keep_ind=keep, options=options, label=labels)


@functools.cache
def jax_results():
    """The JAX package's three runs on the toy TVTSv2 (context 16), once."""
    from tvts_tpu.eval import zero_recognition, zero_ret, zero_ssv2_mc

    model, params, cfg = jax_tvts()
    ctx = cfg.text.context_length
    ret = {sw: zero_ret.run_retrieval(model, params, _retrieval_loader(), sliding_window=sw,
                                      context_length=ctx) for sw in (False, True)}
    classifier = zero_recognition.build_zero_shot_classifier(model, params, CLASSNAMES,
                                                             TEMPLATES, ctx)
    rec = zero_recognition.run_recognition(model, params, _recognition_loader(), CLASSNAMES,
                                           TEMPLATES, ctx)
    mc = zero_ssv2_mc.run_ssv2_mc(model, params, _mc_loader(), ctx)
    return ret, classifier, rec, mc


@functools.cache
def port_model():
    return port_tvts(jax_tvts()[1])


# ---------------------------------------------------------------------------
# sims and metrics
# ---------------------------------------------------------------------------
def test_sim_matrix_matches_jax():
    from tvts_tpu.ops import sim as jax_sim

    rng = np.random.default_rng(0)
    a = rng.standard_normal((6, 8)).astype(np.float32)
    b = rng.standard_normal((5, 8)).astype(np.float32)
    a[2] = 0.0  # a zero row: the norm is clamped at eps, not shifted by it
    b[1] *= 1e-9
    np.testing.assert_allclose(sim_matrix(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                               np.asarray(jax_sim.sim_matrix(jnp.asarray(a), jnp.asarray(b))),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(l2_normalize(torch.from_numpy(b), eps=1e-3).numpy(),
                               np.asarray(jax_sim.l2_normalize(jnp.asarray(b), eps=1e-3)),
                               atol=ATOL, rtol=RTOL)


def _tied_sims(n_q: int, n_v: int, seed: int) -> np.ndarray:
    return np.round(np.random.default_rng(seed).uniform(-1, 1, (n_q, n_v)), 1)  # many ties


def _query_mask(n_v: int, per_video: int, seed: int) -> np.ndarray:
    mask = np.random.default_rng(seed).uniform(size=(n_v, per_video)) > 0.3
    mask[:, 0] = True  # every video keeps a caption
    return mask.astype(np.float64)


@pytest.mark.parametrize("name", ["t2v_metrics", "v2t_metrics"])
@pytest.mark.parametrize("per_video", [1, 3])
@pytest.mark.parametrize("masked", [False, True])
def test_retrieval_metrics_match_jax(name, per_video, masked):
    from tvts_tpu.ops import metrics as jax_metrics

    sims = _tied_sims(10 * per_video, 10, seed=per_video)
    mask = _query_mask(10, per_video, seed=per_video + 1) if masked else None
    got = getattr(metrics, name)(sims, None if mask is None else mask.copy())
    want = getattr(jax_metrics, name)(sims, None if mask is None else mask.copy())
    assert got == want


def test_retrieval_as_classification_and_cols2metrics_match_jax():
    from tvts_tpu.ops import metrics as jax_metrics

    rng = np.random.default_rng(5)
    sims = _tied_sims(8, 20, seed=6)
    masks = np.zeros((8, 20))
    masks[rng.integers(0, 8, 20), np.arange(20)] = 1
    masks[rng.integers(0, 8, 20), np.arange(20)] = 1  # some videos get two labels
    assert metrics.retrieval_as_classification(sims, masks) \
        == jax_metrics.retrieval_as_classification(sims, masks)
    cols = rng.integers(0, 60, 25).astype(np.float64)
    assert metrics.cols2metrics(cols, 25) == jax_metrics.cols2metrics(cols, 25)


def test_sliding_window_meanpool_matches_jax():
    from tvts_tpu.eval.zero_ret import sliding_window_meanpool as jax_pool

    rng = np.random.default_rng(7)
    vid = rng.standard_normal((8, 6)).astype(np.float32)
    txt = rng.standard_normal((8, 6)).astype(np.float32)
    # 'cap x' belongs to b.mp4 and c.mp4: both keep its FIRST row overall (row 2)
    paths = ["b.mp4", "a.mp4", "b.mp4", "a.mp4", "c.mp4", "b.mp4", "c.mp4", "a.mp4"]
    caps = ["cap b", "cap a", "cap x", "cap a2", "cap x", "cap b", "cap c", "cap a"]
    metas = [{"paths": p, "raw_captions": c} for p, c in zip(paths, caps)]
    got_v, got_t = sliding_window_meanpool(vid, txt, metas)
    want_v, want_t = jax_pool(vid, txt, metas)
    np.testing.assert_allclose(got_v, want_v, atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(got_t, want_t)
    assert got_v.shape == (3, 6) and got_t.shape == (6, 6)
    np.testing.assert_array_equal(got_t[4], txt[2])  # c.mp4's 'cap x' is row 2, not row 4


# ---------------------------------------------------------------------------
# the three runs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("use_fused", [False, True])
@pytest.mark.parametrize("sliding_window", [False, True])
def test_run_retrieval_matches_jax(use_fused, sliding_window):
    want_metrics, want_sims = jax_results()[0][sliding_window]
    got_metrics, got_sims = run_retrieval(port_model(), _retrieval_loader(),
                                          sliding_window=sliding_window, context_length=16,
                                          use_fused=use_fused)
    assert got_sims.shape == want_sims.shape == ((4, 4) if sliding_window else (7, 7))
    np.testing.assert_allclose(got_sims, want_sims, atol=ATOL, rtol=RTOL)
    assert got_metrics == want_metrics


@pytest.mark.parametrize("use_fused", [False, True])
def test_run_recognition_matches_jax(use_fused):
    _, want_w, want, _ = jax_results()
    model = port_model()
    got_w = build_zero_shot_classifier(model, CLASSNAMES, TEMPLATES, 16, use_fused)
    np.testing.assert_allclose(got_w, want_w, atol=ATOL, rtol=RTOL)
    got = run_recognition(model, _recognition_loader(), CLASSNAMES, TEMPLATES, 16,
                          use_fused=use_fused)
    assert got["logits"].shape == (7, len(CLASSNAMES))
    np.testing.assert_allclose(got["logits"] / 100, want["logits"] / 100, atol=ATOL, rtol=RTOL)
    assert (got["top1"], got["top5"]) == (want["top1"], want["top5"])


@pytest.mark.parametrize("use_fused", [False, True])
def test_run_ssv2_mc_matches_jax(use_fused):
    want = jax_results()[3]
    got = run_ssv2_mc(port_model(), _mc_loader(), context_length=16, use_fused=use_fused)
    assert got == want
    assert got["total"] == 7
