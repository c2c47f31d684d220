"""The port's YT-Temporal reader on the CPU against the JAX package: the ASR
cleaning and DTW alignment (`data/asr.py`) on seeded word lists, and
`YTTemporal` items on a tiny synthesized layout (cv2-written mp4 clips,
chip_smoke.py's ASR annotations) under the same `random.seed`, with a shared
tube mask and per-tube masks, in the train and test splits, and its retry
with a random index and its raise after max_try. Everything is equal: edit
distances, DTW paths, alignments, and items bit for bit."""

import json
import os
import random
import shutil

import numpy as np
import pytest

pytest.importorskip("cv2")

import chip_smoke  # noqa: E402
from tvts_torch.data import asr as port_asr  # noqa: E402
from tvts_torch.data import datasets as port_ds  # noqa: E402


def jax_module(name):
    import importlib

    return importlib.import_module(f"tvts_tpu.{name}")


def _words(rng, n):
    vocab = list(chip_smoke.WORDS) + ["Guitar,", "it's", "&amp;", "", "x.y", "ÉTÉ"]
    return [str(w) for w in rng.choice(vocab, n)]


def _noisy(rng, words):
    """words with case and punctuation changed and a few dropped or inserted."""
    out = []
    for w in words:
        r = rng.random()
        if r < 0.1:
            continue
        out.append(w.upper() if r < 0.3 else w + "," if r < 0.4 else w)
        if rng.random() < 0.1:
            out.append(str(rng.choice(chip_smoke.WORDS)))
    return out


# ---------------------------------------------------------------------------
# asr
# ---------------------------------------------------------------------------
def test_edit_distance_equals_jax():
    jax_asr = jax_module("data.asr")
    rng = np.random.default_rng(0)
    pairs = [("", ""), ("", "abc"), ("abc", ""), ("kitten", "sitting"), ("same", "same")]
    pairs += [(a, b) for a, b in zip(_words(rng, 200), _words(rng, 200))]
    pairs += [("".join(rng.choice(list("abcd"), rng.integers(0, 9))),
               "".join(rng.choice(list("abcd"), rng.integers(0, 9)))) for _ in range(200)]
    got = [port_asr.edit_distance(a, b) for a, b in pairs]
    assert got == [jax_asr.edit_distance(a, b) for a, b in pairs]


@pytest.mark.parametrize("n,m", [(0, 0), (1, 1), (1, 5), (6, 1), (7, 9), (23, 17), (40, 40)])
def test_dtw_path_equals_jax(n, m):
    """Small integer costs, so ties between the three moves are common."""
    jax_asr = jax_module("data.asr")
    rng = np.random.default_rng(n * 100 + m)
    cost = rng.integers(0, 4, (n, m)).astype(np.float32)
    if n and m:
        cost[rng.random((n, m)) < 0.2] = 9999.0
    assert port_asr.dtw_path(cost) == jax_asr.dtw_path(cost)
    assert port_asr.dtw_path(cost.tolist()) == jax_asr.dtw_path(cost)


@pytest.mark.parametrize("n", [0, 1, 5, 40, 150])
def test_align_using_dtw_equals_jax(n):
    jax_asr = jax_module("data.asr")
    rng = np.random.default_rng(n)
    asr_words = _words(rng, n)
    for grover in (_noisy(rng, asr_words), _words(rng, n + 50), [], asr_words):
        got = port_asr.align_using_dtw(asr_words, grover)
        assert got == jax_asr.align_using_dtw(asr_words, grover)
        assert len(got) == n


def test_clean_subtitles_and_description_equal_jax():
    jax_asr = jax_module("data.asr")
    ann = chip_smoke.asr_annotation(3, 60.0)
    ann["subtitles"] += [{"word": "", "time": 1.0}, {"word": "x;", "time": 2.0}]
    assert port_asr.clean_subtitles(ann["subtitles"]) == jax_asr.clean_subtitles(ann["subtitles"])
    assert len(port_asr.clean_subtitles(ann["subtitles"])) < len(ann["subtitles"])
    for text in ("see www.example.com/x  now\n\n\nok 😀 ☀", "plain", "  a  b \n c ",
                 "http://a.b/c?d=(e) and (f) ⬛"):
        assert port_asr.clean_description(text) == jax_asr.clean_description(text)


# ---------------------------------------------------------------------------
# YTTemporal
# ---------------------------------------------------------------------------
# two 30 s clips (the windowed branch), one 12 s clip (too short for a window:
# the whole clip) at a few frames a second, small frames
YTT = (3, 30, 2, (48, 64))


@pytest.fixture(scope="module")
def ytt_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ytt_port"))
    _, specs = chip_smoke.pretrain_trees(root, {}, ytt=YTT, webvid=(1, 2, 4, (48, 64)))
    short = next(p for p in specs if p.endswith("yt0002.mp4"))
    seed, _, fps, shape = specs[short]
    specs[short] = (seed, 12 * fps, fps, shape)
    ann = os.path.join(os.path.dirname(short), "annotations", "yt0002.json")
    with open(ann, "w") as f:
        json.dump(chip_smoke.asr_annotation(2, 12.0), f)
    chip_smoke.write_clips(specs, 2)
    meta = os.path.join(root, "meta")
    shutil.copy(os.path.join(meta, "yttemporal_train.csv"),
                os.path.join(meta, "yttemporal_val.csv"))
    return root


def _ytt(pkg, root, **kw):
    kw = {"split": "train", "mask_ratio": 0.5, **kw}
    return pkg.dataset_loader("YTTemporal", {"input": "text"},
                              {"input_res": 32, "num_frames": 3, "loading": "lax"},
                              os.path.join(root, "ytt"), meta_root=os.path.join(root, "meta"),
                              patches_per_frame=16, reader="cv2", **kw)


def _assert_item_equal(got, want, what):
    assert list(got) == list(want), what
    for key, w in want.items():
        if isinstance(w, np.ndarray):
            assert got[key].dtype == w.dtype, (what, key)
            np.testing.assert_array_equal(got[key], w, err_msg=f"{what} {key}")
        else:
            assert got[key] == w, (what, key)


@pytest.mark.parametrize("kw", [{}, {"per_tube_masks": 3}, {"split": "test", "mask_ratio": 0.0}],
                         ids=["shared-mask", "per-tube-masks", "test"])
def test_ytt_items_equal_jax(ytt_root, kw):
    got_ds, want_ds = _ytt(port_ds, ytt_root, **kw), _ytt(jax_module("data.datasets"), ytt_root,
                                                          **kw)
    assert got_ds.metadata == list(want_ds.metadata) and len(got_ds) == 3
    for seed in (0, 1):
        for i in range(len(got_ds)):
            random.seed(seed * 10 + i)
            got = got_ds[i]
            random.seed(seed * 10 + i)
            want = want_ds[i]
            _assert_item_equal(got, want, f"item {i} seed {seed}")
            assert got["video"].shape == (12, 3, 32, 32) and len(got["text"]) == 4
            np.testing.assert_array_equal(got["label"], np.arange(4))
            assert got["keep_ind"].shape == ((3, 8) if kw.get("per_tube_masks") else
                                             (16 if kw.get("split") == "test" else 8,))
    assert any(t.strip() for t in got["text"])  # the DTW-aligned transcripts are not empty


def test_ytt_retries_with_a_random_index_then_raises(ytt_root, tmp_path):
    """A missing video fails its item; the retry draws another index from the
    item's generator (so the item is the JAX package's), and max_try failures
    raise."""
    meta = tmp_path / "meta"
    meta.mkdir()
    (meta / "yttemporal_train.csv").write_text(
        "Name\nchannel9/missing.mp4\nchannel0/yt0000.mp4\nchannel1/yt0001.mp4\n")
    kw = dict(meta_root=str(meta))
    got_ds = port_ds.dataset_loader(
        "YTTemporal", {}, {"input_res": 32, "num_frames": 3}, os.path.join(ytt_root, "ytt"),
        patches_per_frame=16, reader="cv2", mask_ratio=0.5, **kw)
    want_ds = jax_module("data.datasets").dataset_loader(
        "YTTemporal", {}, {"input_res": 32, "num_frames": 3}, os.path.join(ytt_root, "ytt"),
        patches_per_frame=16, reader="cv2", mask_ratio=0.5, **kw)
    for seed in range(3):
        random.seed(seed)
        got = got_ds[0]
        random.seed(seed)
        _assert_item_equal(got, want_ds[0], f"retried item, seed {seed}")
        assert got["meta"]["paths"] != "channel9/missing.mp4"
    (meta / "yttemporal_train.csv").write_text("Name\nchannel9/missing.mp4\n")
    for ds in (port_ds, jax_module("data.datasets")):
        bad = ds.dataset_loader("YTTemporal", {}, {"input_res": 32, "num_frames": 3},
                                os.path.join(ytt_root, "ytt"), patches_per_frame=16,
                                reader="cv2", max_try=2, **kw)
        with pytest.raises(RuntimeError, match="exceeded max_try"):
            bad[0]


def test_get_caption_multi_on_a_long_annotation_equals_jax(tmp_path):
    """A 4-minute annotation of 600 ASR words (the size chip_smoke.py times)."""
    path = tmp_path / "long.json"
    path.write_text(json.dumps(chip_smoke.asr_annotation(7, 240.0)))
    cls = (port_ds.DATASET_REGISTRY["YTTemporal"], jax_module("data.ytt").YTTemporal)
    outs = []
    for ytt_cls in cls:
        ds = ytt_cls.__new__(ytt_cls)
        ds.num_clips, ds.interval = 4, 1
        outs.append(ds.get_caption_multi(str(path), np.random.default_rng(5)))
    (text, label, starts, ends, n), want = outs
    assert text == want[0] and starts == want[2] and ends == want[3] and n == want[4] == 240
    np.testing.assert_array_equal(label, want[1])
    assert sum(len(t.split()) for t in text) > 20
