"""The port's JAX-free config and data layer on the CPU against the JAX
package: frame sampling in every mode, the numpy resamplers against Pillow,
the host and device transforms, the cv2 and native readers, every dataset's
items (Python's `random` and numpy's global state seeded alike in both
packages), the pandas subsets, the sliding-window expansion, the jsfusion
caption index, the loader's batches and shards, and the config reader.
Indices, items and batches equal; the resamplers bit for bit Pillow's;
preprocess_on_device within 1e-5 where it does not resize, within
RESIZE_ATOL where it does."""

import json
import math
import os
import pickle
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")
PIL_Image = pytest.importorskip("PIL.Image")

from tests.test_datasets import write_video  # noqa: E402
from tvts_torch.data import datasets as port_ds  # noqa: E402
from tvts_torch.data import loader as port_loader  # noqa: E402
from tvts_torch.data import native_decoder as port_native  # noqa: E402
from tvts_torch.data import transforms as port_tf  # noqa: E402
from tvts_torch.data import video_reader as port_vr  # noqa: E402
from tvts_torch.ops import sampling as port_sampling  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# preprocess_on_device where it resizes: XLA rounds a sample position (up
# to ~256 in float32, one unit 1.5e-5) differently from torch at some
# outputs, which moves a weight by up to 1.5e-5 and a value by up to
# 255 * 1.5e-5 / 255 / 0.225 = 6.8e-5 after the normalisation
RESIZE_ATOL = 1e-4


def jax_module(name):
    import importlib

    return importlib.import_module(f"tvts_tpu.{name}")


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("num_frames,vlen", [(12, 300), (12, 5), (4, 1), (8, 8), (12, 241)])
@pytest.mark.parametrize("mode", ["rand", "uniform", "fix_start"])
def test_sample_frames_equal_jax(num_frames, vlen, mode):
    jax_sampling = jax_module("ops.sampling")
    kw = {"fix_start": 2} if mode == "fix_start" else {"sample": mode}
    for seed in range(3):
        want = jax_sampling.sample_frames(num_frames, vlen, rng=np.random.default_rng(seed), **kw)
        got = port_sampling.sample_frames(num_frames, vlen, rng=np.random.default_rng(seed), **kw)
        assert got == want
    with pytest.raises(ValueError):
        port_sampling.sample_frames(num_frames, 0)
    with pytest.raises(NotImplementedError):
        port_sampling.sample_frames(num_frames, vlen, sample="bogus")


def test_multi_clip_frame_indices_equal_jax():
    jax_sampling = jax_module("ops.sampling")
    for seed, args in enumerate([([1.0, 3.0], [2.5, 6.0], 30.0, 300, 3, 2),
                                 ([0.0], [0.1], 10.0, 100, 4, 4),
                                 ([5.0], [9.5], 10.0, 250, 8, 1)]):
        want = jax_sampling.multi_clip_frame_indices(*args, rng=np.random.default_rng(seed))
        got = port_sampling.multi_clip_frame_indices(*args, rng=np.random.default_rng(seed))
        assert got == want


# ---------------------------------------------------------------------------
# the resamplers against Pillow
# ---------------------------------------------------------------------------
RESIZES = [((240, 320), (268, 357)),  # MSRVTT's frames, shorter side to int(1.2 * 224)
           ((240, 320), (224, 224)),  # extraction
           ((360, 480), (268, 357)), ((240, 427), (224, 224)), ((1080, 1920), (224, 224)),
           ((100, 120), (257, 300)), ((7, 5), (3, 11)), ((224, 224), (268, 268))]


@pytest.mark.parametrize("src,dst", RESIZES, ids=[f"{s}->{d}" for s, d in RESIZES])
@pytest.mark.parametrize("method", ["NEAREST", "BILINEAR"])
def test_resamplers_bit_for_bit_pillow(src, dst, method):
    frames = np.random.default_rng(sum(src) + sum(dst)).integers(
        0, 256, (2, *src, 3), dtype=np.uint8)
    resample = getattr(PIL_Image, method)
    want = np.stack([np.asarray(PIL_Image.fromarray(f).resize(dst[::-1], resample))
                     for f in frames])
    fn = port_tf.resize_nearest if method == "NEAREST" else port_tf.resize_bilinear
    got = fn(frames, dst[::-1])
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_resamplers_bit_for_bit_pillow_random_sizes():
    rng = np.random.default_rng(9)
    for _ in range(40):
        (h, w), (oh, ow) = rng.integers(1, 420, 2), rng.integers(1, 420, 2)
        frame = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        for fn, resample in ((port_tf.resize_nearest, PIL_Image.NEAREST),
                             (port_tf.resize_bilinear, PIL_Image.BILINEAR)):
            want = np.asarray(PIL_Image.fromarray(frame).resize((ow, oh), resample))
            np.testing.assert_array_equal(fn(frame, (ow, oh)), want,
                                          err_msg=f"{fn.__name__} {(h, w)} -> {(oh, ow)}")


def test_data_layer_takes_no_pil():
    import inspect

    for mod in (port_tf, port_ds, port_vr, port_loader):
        lines = inspect.getsource(mod).splitlines()
        assert not [line for line in lines if "import PIL" in line or "from PIL" in line]


# ---------------------------------------------------------------------------
# transforms against the JAX package
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(3, 240, 320), (2, 360, 480), (2, 480, 360), (2, 268, 300)])
@pytest.mark.parametrize("mode", ["test", "train"])
def test_video_and_pixelbert_transforms_equal_jax(shape, mode):
    jax_tf = jax_module("data.transforms")
    frames = np.random.default_rng(shape[1]).integers(0, 256, (*shape, 3), dtype=np.uint8)
    for fn in ("video_transform", "pixelbert_transform"):
        want = getattr(jax_tf, fn)(frames, 224, mode, rng=np.random.default_rng(3))
        got = getattr(port_tf, fn)(frames, 224, mode, rng=np.random.default_rng(3))
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want, err_msg=fn)


@pytest.mark.parametrize("shape", [(12, 240, 320), (2, 224, 224), (2, 1080, 1920), (2, 100, 90)])
def test_extract_transform_equal_jax(shape):
    jax_tf = jax_module("data.transforms")
    frames = np.random.default_rng(shape[2]).integers(0, 256, (*shape, 3), dtype=np.uint8)
    np.testing.assert_array_equal(port_tf.extract_transform(frames),
                                  jax_tf.extract_transform(frames))


@pytest.mark.parametrize("shape,crop_xy,atol", [
    ((2, 3, 224, 224), None, 1e-5),       # decoder-side resized: no resize
    ((1, 2, 240, 320), None, RESIZE_ATOL),
    ((1, 2, 360, 480), (10, 20), RESIZE_ATOL),
    ((1, 2, 320, 240), None, RESIZE_ATOL),
    ((1, 1, 268, 300), None, RESIZE_ATOL),  # shorter side already int(1.2 * crop)
    ((1, 1, 120, 160), None, RESIZE_ATOL),  # upsampling
])
def test_preprocess_on_device_matches_jax(shape, crop_xy, atol):
    import jax.numpy as jnp

    jax_tf = jax_module("data.transforms")
    frames = np.random.default_rng(sum(shape)).integers(0, 256, (*shape, 3), dtype=np.uint8)
    want = np.asarray(jax_tf.preprocess_on_device(jnp.asarray(frames), 224, crop_xy=crop_xy))
    got = port_tf.preprocess_on_device(torch.from_numpy(frames), 224, crop_xy=crop_xy)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# the readers
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def clip_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("clip") / "clip.mp4")
    write_video(path, n_frames=45, size=80)
    return path


def _native_or_skip():
    """The port's native decoder, built here, or a skip where it cannot be built."""
    if not port_native.available():
        pytest.skip(f"native decoder not built: {port_native.unavailable_reason()}")


@pytest.mark.parametrize("backend", ["cv2", "native"])
def test_reader_frames_equal_jax(clip_path, backend):
    if backend == "native":
        _native_or_skip()
        if not jax_module("data.native_decoder").available():
            pytest.skip("the JAX package's native decoder did not build")
    jax_vr = jax_module("data.video_reader")
    assert port_vr.get_video_len(clip_path, backend) == jax_vr.get_video_len(clip_path, backend)
    assert port_vr.probe(clip_path, backend) == jax_vr.probe(clip_path, backend)
    idxs = [0, 3, 17, 17, 44, 30]
    np.testing.assert_array_equal(port_vr.read_frames_at(clip_path, idxs, backend),
                                  jax_vr.read_frames_at(clip_path, idxs, backend))
    np.testing.assert_array_equal(
        port_vr.read_frames_at(clip_path, idxs, backend, resize=(64, 48)),
        jax_vr.read_frames_at(clip_path, idxs, backend, resize=(64, 48)))
    for sample in ("rand", "uniform"):
        got, got_idx = port_vr.read_frames_sampled(clip_path, 8, sample,
                                                   rng=np.random.default_rng(4), backend=backend)
        want, want_idx = jax_vr.read_frames_sampled(clip_path, 8, sample,
                                                    rng=np.random.default_rng(4), backend=backend)
        assert got_idx == want_idx
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        port_vr.read_multi_clip(clip_path, [0.5], [3.0], 4.5, 3, 2,
                                rng=np.random.default_rng(5), backend=backend),
        jax_vr.read_multi_clip(clip_path, [0.5], [3.0], 4.5, 3, 2,
                               rng=np.random.default_rng(5), backend=backend))


def test_native_decoder_builds_into_the_port(clip_path):
    _native_or_skip()
    lib_dir = os.path.join(REPO, "tvts_torch", "_build")
    assert any(n.startswith("libtvtsdecode_") for n in os.listdir(lib_dir))
    frames = port_native.decode_frames_aug(clip_path, [1, 2], 64, crop_frac=(0.25, 0.75),
                                           hflip=True)
    want = jax_module("data.native_decoder")
    if want.available():
        np.testing.assert_array_equal(
            frames, want.decode_frames_aug(clip_path, [1, 2], 64, crop_frac=(0.25, 0.75),
                                           hflip=True))
    assert frames.shape == (2, 64, 64, 3)


def test_cv2_repeats_the_last_frame_past_the_end(clip_path):
    jax_vr = jax_module("data.video_reader")
    idxs = [40, 44, 45, 60]
    np.testing.assert_array_equal(port_vr.read_frames_at(clip_path, idxs, "cv2"),
                                  jax_vr.read_frames_at(clip_path, idxs, "cv2"))


def test_auto_backend_without_either_names_both(monkeypatch, clip_path):
    monkeypatch.setattr(port_native, "available", lambda: False)
    monkeypatch.setattr(port_vr, "_cv2", lambda: None)
    with pytest.raises(RuntimeError, match="native decoder.*OpenCV"):
        port_vr.get_video_len(clip_path)
    with pytest.raises(RuntimeError, match="OpenCV"):
        port_vr.read_frames_at(clip_path, [0], backend="cv2")


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------
VIDEO_PARAMS = {"num_frames": 4, "input_res": 64, "loading": "strict"}
CLASSES = ["ApplyEyeMakeup", "Archery", "Basketball"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """One directory with the MSRVTT, DiDeMo, LSMDC, WebVid, UCF101, HMDB51,
    K400 and SSV2-MC layouts over a few cv2-written clips."""
    root = tmp_path_factory.mktemp("tree")
    data, meta = root / "data", root / "meta"

    def clip(rel, n_frames=30, size=80):
        write_video(str(data / rel), n_frames=n_frames, size=size)

    vids = [f"video{i}" for i in range(6)]
    for i, v in enumerate(vids):
        clip(f"videos/all/{v}.mp4", n_frames=20 + 7 * i)
    anns = [{"image_id": v, "caption": f"caption {j} of {v}"}
            for j in range(3) for v in reversed(vids)]  # ids out of order in the json
    os.makedirs(meta / "msrvtt")
    (meta / "msrvtt" / "MSR_VTT.json").write_text(json.dumps({"annotations": anns}))
    split = data / "high-quality" / "structured-symlinks"
    os.makedirs(split)
    (split / "train_list_jsfusion.txt").write_text("\n".join(vids[:3]) + "\n")
    (split / "val_list_jsfusion.txt").write_text("\n".join(vids[5:2:-1]) + "\n\n")
    (split / "train_list_miech.txt").write_text("\n".join(vids[:4]) + "\n")
    (split / "test_list_miech.txt").write_text("\n".join(vids[4:]) + "\n")
    with open(split / "jsfusion_val_caption_idx.pkl", "wb") as f:
        pickle.dump({vids[5]: 2, vids[3]: 1, vids[4]: 0}, f)

    os.makedirs(meta / "didemo")
    clip("didemo/a.mp4")
    clip("didemo/b.mp4", n_frames=12)
    (meta / "didemo" / "DiDeMo_test.tsv").write_text(
        "caption\tvideo\na man walks\ta.mp4\n\"quoted\tcaption\"\tb.mp4\n")
    os.makedirs(meta / "lsmdc")
    clip("lsmdc/1004_Juno/1004_Juno_00.00.01.000-00.00.03.000.avi")
    (meta / "lsmdc" / "LSMDC16_challenge_1000_publictect.csv").write_text(
        "id\tstart\tend\tsentence\n1004_Juno_00.00.01.000-00.00.03.000\t1\t3\tSOMEONE runs\n")
    for split_name in ("train", "val"):
        for vid in ("0123", "77"):
            clip(f"webvid/{split_name}/{int(vid)}.mp4", n_frames=16)
        (meta / f"webvid_{split_name}.tsv").write_text(
            "name\tvideoid\nA cat plays\t0123\nA dog runs\t77\n")
    (meta / "label2id.json").write_text(json.dumps({c: i for i, c in enumerate(CLASSES)}))
    for ds, sub, files in (("ucf101", "ucf101", ["testlist01_new.tsv", "trainlist01_new.tsv"]),
                           ("hmdb51", "hmdb51", ["split_1_test_list.tsv",
                                                 "split_1_train_list.tsv"])):
        os.makedirs(meta / ds / "prompt")
        rows = [f"{c}/v_{c}_g0{k}.avi\t{i}" for i, c in enumerate(CLASSES) for k in range(2)]
        for rel in rows:
            clip(f"{sub}/{rel.split(chr(9))[0]}", n_frames=18)
        for name in files:
            (meta / ds / "prompt" / name).write_text("path\tlabel\n" + "\n".join(rows) + "\n")
    os.makedirs(meta / "k400" / "prompt")
    clip("k400/videos_val/x1.mp4")
    (meta / "k400" / "prompt" / "kinetics400_val_list_videos.tsv").write_text(
        "path\tlabel\nabseiling/x1.mkv\t0\n")
    os.makedirs(meta / "ssv2" / "mc")
    recs = []
    for k in range(3):
        clip(f"ssv2/videos/{k}.webm.mp4", n_frames=24)
        recs.append({"clip_name": f"{k}.webm.mp4", "answer": k,
                     "options": [f"pushing thing {o}" for o in range(5)]})
    (meta / "ssv2" / "mc" / "val.jsonl").write_text("\n".join(map(json.dumps, recs)) + "\n")
    return str(data), str(meta)


DATASETS = [
    ("MSRVTT", "msrvtt", dict(split="test", cut="jsfusion")),
    ("MSRVTT", "msrvtt", dict(split="train", cut="jsfusion")),
    ("MSRVTT", "msrvtt", dict(split="val", cut="miech")),
    ("MSRVTT", "msrvtt", dict(split="test", cut="jsfusion", sliding_window_stride=1)),
    ("DiDeMo", "didemo", dict(split="test")),
    ("LSMDC", "lsmdc", dict(split="test")),
    ("WebVid", "webvid", dict(split="train")),
    ("WebVid", "webvid", dict(split="val")),
    ("UCF101", "ucf101", dict(split="test")),
    ("HMDB51", "hmdb51", dict(split="test", mask_ratio=0.5)),
    ("HMDB51", "hmdb51", dict(split="train", mask_ratio=0.5)),
    ("Kinetics400", "k400", dict(split="test")),
    ("SSV2_mc", "ssv2", dict(split="test")),
]


def _build(pkg_loader, tree, name, sub, kw, reader="cv2", video_params=VIDEO_PARAMS):
    data, meta = tree
    data_dir = data if name == "MSRVTT" else os.path.join(data, sub)
    return pkg_loader(name, {}, dict(video_params), data_dir, meta_root=meta,
                      patches_per_frame=16, reader=reader, **kw)


def assert_items_equal(got: dict, want: dict, what=""):
    assert list(got) == list(want), what
    for key in want:
        if isinstance(want[key], np.ndarray):
            assert got[key].dtype == want[key].dtype, (what, key)
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"{what} {key}")
        else:
            assert got[key] == want[key], (what, key)


def _items(ds, seed):
    random.seed(seed)
    np.random.seed(seed)
    return [ds[i] for i in range(len(ds))]


@pytest.mark.parametrize("name,sub,kw", DATASETS,
                         ids=[f"{n}-{kw.get('split')}-{kw.get('cut', '')}"
                              f"{'-sw' if 'sliding_window_stride' in kw else ''}"
                              for n, _, kw in DATASETS])
def test_dataset_items_equal_jax(tree, name, sub, kw):
    jax_ds = jax_module("data.datasets")
    want_ds = _build(jax_ds.dataset_loader, tree, name, sub, kw)
    got_ds = _build(port_ds.dataset_loader, tree, name, sub, kw)
    assert len(got_ds) == len(want_ds) > 0
    for seed in (0, 1):
        for i, (got, want) in enumerate(zip(_items(got_ds, seed), _items(want_ds, seed))):
            assert_items_equal(got, want, f"{name} item {i}")


def test_dataset_items_equal_jax_on_the_native_reader(tree):
    _native_or_skip()
    if not jax_module("data.native_decoder").available():
        pytest.skip("the JAX package's native decoder did not build")
    jax_ds = jax_module("data.datasets")
    kw = dict(split="test", cut="jsfusion")
    want = _items(_build(jax_ds.dataset_loader, tree, "MSRVTT", "msrvtt", kw, "native"), 2)
    got = _items(_build(port_ds.dataset_loader, tree, "MSRVTT", "msrvtt", kw, "native"), 2)
    for g, w in zip(got, want):
        assert_items_equal(g, w)


def test_webvid_leading_zero_id_and_lax_loading(tree, tmp_path):
    """WebVid's all-digit id column is read as integers (0123 -> 123.mp4), and
    a missing video gives a black clip under lax loading, raises under strict."""
    data, meta = tree
    ds = _build(port_ds.dataset_loader, tree, "WebVid", "webvid", dict(split="train"))
    assert ds[0]["meta"]["paths"] == "123.mp4"
    (tmp_path / "webvid_train.tsv").write_text("name\tvideoid\nmissing\t999\n")
    lax = port_ds.WebVid("WebVid", {}, {**VIDEO_PARAMS, "loading": "lax"}, str(tmp_path),
                         meta_root=str(tmp_path), patches_per_frame=16)
    jax_lax = jax_module("data.datasets").WebVid(
        "WebVid", {}, {**VIDEO_PARAMS, "loading": "lax"}, str(tmp_path),
        meta_root=str(tmp_path), patches_per_frame=16)
    assert_items_equal(_items(lax, 3)[0], _items(jax_lax, 3)[0])
    strict = port_ds.WebVid("WebVid", {}, VIDEO_PARAMS, str(tmp_path), meta_root=str(tmp_path),
                            patches_per_frame=16)
    with pytest.raises(ValueError, match="loading is strict"):
        strict[0]


def test_read_table_types_match_pandas(tmp_path):
    pd = pytest.importorskip("pandas")
    path = tmp_path / "t.tsv"
    path.write_text("caption\tid\tscore\tflag\tspaced\tempty\tmixed\n"
                    "A cat\t0123\t1.5\tTrue\t 5\t\tx\n"
                    "\"q\tx\"\t77\tNA\tfalse\t6 \t\t1\n\n"
                    "B\t-4\t1e3\tTRUE\t7\t\tnan\n")
    df = pd.read_csv(path, sep="\t")
    columns, rows = port_ds.read_table(str(path))
    assert columns == tuple(df.columns)
    for i, row in enumerate(rows):
        for j, got in enumerate(row.values):
            want = df.iloc[i].iloc[j]
            if isinstance(want, float) and math.isnan(want):
                assert isinstance(got, float) and math.isnan(got), (i, j, got)
            else:
                assert got == want and str(got) == str(want), (i, j, got, want)
                assert isinstance(got, bool) == isinstance(want, (bool, np.bool_)), (i, j)


@pytest.mark.parametrize("n_rows", [5, 1200])
def test_random_state_subsets_match_pandas(tmp_path, n_rows):
    """WebVid's and the prompt datasets' val subset, sample(min(1000, n),
    random_state=0): the same rows in the same order as pandas."""
    pd = pytest.importorskip("pandas")
    path = tmp_path / "t.tsv"
    path.write_text("name\tvideoid\n" + "".join(f"cap {i}\t{i:05d}\n" for i in range(n_rows)))
    want = pd.read_csv(path, sep="\t").sample(min(1000, n_rows), random_state=0)
    _, rows = port_ds.read_table(str(path))
    got = port_ds.sample_rows(rows, n=min(1000, n_rows), random_state=0)
    assert [r.values for r in got] == [tuple(v) for v in want.itertuples(index=False)]
    np.random.seed(11)
    want = pd.read_csv(path, sep="\t").sample(frac=0.3)
    np.random.seed(11)
    got = port_ds.sample_rows(rows, frac=0.3)
    assert [r.values for r in got] == [tuple(v) for v in want.itertuples(index=False)]


def test_sliding_window_expansion_equals_jax(tree, tmp_path):
    """explode order and the `len(x - 1)` quirk, and a zero-length video: one
    row with fix_start NaN that loads as a failed video, as in the JAX package
    (strict raises, lax gives a black clip)."""
    data, meta = tree
    jax_ds = jax_module("data.datasets")
    empty = os.path.join(data, "videos", "all", "video3.mp4")
    saved = open(empty, "rb").read()
    try:
        open(empty, "wb").close()  # video3: no frames
        for stride in (1, 2):
            for loading in ("strict", "lax"):
                kw = dict(split="test", cut="jsfusion", sliding_window_stride=stride)
                params = {**VIDEO_PARAMS, "loading": loading}
                want = _build(jax_ds.MSRVTT, tree, "MSRVTT", "", kw, video_params=params)
                got = _build(port_ds.MSRVTT, tree, "MSRVTT", "", kw, video_params=params)
                starts = [r["fix_start"] for r in got.metadata]
                want_starts = want.metadata["fix_start"].tolist()
                assert [r.name for r in got.metadata] == list(want.metadata.index)
                assert len(starts) == len(want_starts)
                for g, w in zip(starts, want_starts):
                    assert (math.isnan(g) and math.isnan(w)) or g == w
                for i in range(len(got)):
                    if loading == "strict" and got.metadata[i].name == "video3":
                        with pytest.raises(ValueError, match="loading is strict"):
                            want[i]
                        with pytest.raises(ValueError, match="loading is strict"):
                            got[i]
                        continue
                    random.seed(i)
                    w = want[i]
                    random.seed(i)
                    assert_items_equal(got[i], w, f"stride {stride} {loading} item {i}")
    finally:
        open(empty, "wb").write(saved)


def test_jsfusion_caption_index_dict_and_pandas_pickles(tree, tmp_path, monkeypatch):
    pd = pytest.importorskip("pandas")
    data, meta = tree
    ids = ["video5", "video4", "video3"]
    path = tmp_path / "idx.pkl"
    with open(path, "wb") as f:
        pickle.dump(pd.Series([2, 0, 1], index=ids), f)
    assert port_ds.load_caption_index(str(path)) == {"video5": 2, "video4": 0, "video3": 1}
    # where pandas is missing, the pandas pickle is refused by name
    for name in [n for n in sys.modules if n == "pandas" or n.startswith("pandas.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "pandas", None)
    with pytest.raises(RuntimeError, match=r"idx\.pkl.*pandas"):
        port_ds.load_caption_index(str(path))
    monkeypatch.undo()
    with open(path, "wb") as f:
        pickle.dump([1, 2], f)
    with pytest.raises(TypeError, match="mapping"):
        port_ds.load_caption_index(str(path))


def test_dataset_loader_names_what_is_not_ported(tree):
    # every dataset of the JAX package's registry is ported: CC3M too
    assert port_ds.DATASET_REGISTRY["ConceptualCaptions3M"].__name__ == "ConceptualCaptions3M"
    assert port_ds.DATASET_REGISTRY["YTTemporal"].__name__ == "YTTemporal"
    with pytest.raises(NotImplementedError):
        port_ds.dataset_loader("Bogus", {}, VIDEO_PARAMS, tree[0])


# ---------------------------------------------------------------------------
# the loader
# ---------------------------------------------------------------------------
class ToyDataset:
    def __init__(self, n=26):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"video": np.full((2, 3), i, dtype=np.float32),
                "text": [f"clip{c} of {i}" for c in range(3)],
                "caption": f"caption {i}", "label": i, "keep_ind": np.arange(2) + i,
                "meta": {"idx": i}}


def _flat(batches):
    return [(b["video"].tolist(), b["text"], b["caption"], b["label"].tolist(),
             b["keep_ind"].tolist(), b["meta"]) for b in batches]


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("workers", [0, 3])
def test_loader_batches_equal_jax(shuffle, drop_last, workers):
    jax_loader = jax_module("data.loader")
    kw = dict(batch_size=4, shuffle=shuffle, drop_last=drop_last, num_workers=workers, seed=5)
    for rank, world in ((0, 1), (0, 2), (1, 2), (2, 3)):
        got = port_loader.ShardedLoader(ToyDataset(), process_index=rank, num_processes=world,
                                        **kw)
        want = jax_loader.ShardedLoader(ToyDataset(), process_index=rank, num_processes=world,
                                        **kw)
        for epoch in (0, 1):
            got.set_epoch(epoch)
            want.set_epoch(epoch)
            assert len(got) == len(want)
            assert _flat(got) == _flat(want)


def test_loader_process_pool_equals_its_sync_path():
    """The fork pool (use_processes=True) yields the batches of num_workers=0,
    which the test above holds to the JAX package. It runs in a fresh
    interpreter: forking this process, which holds JAX's threads, could
    deadlock."""
    code = (
        "import numpy as np\n"
        "from tvts_torch.data.loader import ShardedLoader\n"
        "class Toy:\n"
        "    def __len__(self): return 26\n"
        "    def __getitem__(self, i): return {'video': np.full((2, 3), i, np.float32),\n"
        "        'text': [f'c{c} {i}' for c in range(3)], 'label': i, 'meta': {'idx': i}}\n"
        "def flat(loader): return [(b['video'].tolist(), b['text'], b['label'].tolist(),\n"
        "                           b['meta']) for b in loader]\n"
        "for shuffle in (False, True):\n"
        "    for drop_last in (True, False):\n"
        "        for rank, world in ((0, 1), (1, 2), (2, 3)):\n"
        "            kw = dict(batch_size=4, shuffle=shuffle, drop_last=drop_last, seed=5,\n"
        "                      process_index=rank, num_processes=world)\n"
        "            want = flat(ShardedLoader(Toy(), num_workers=0, **kw))\n"
        "            got = flat(ShardedLoader(Toy(), num_workers=2, use_processes=True, **kw))\n"
        "            assert want and got == want, (shuffle, drop_last, rank)\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def _uniform_batches(loader):
    """What a loader's batches hold where the items do not depend on the
    scheduling: test-split items sample their frames uniformly; only the keep
    set draws from the item's generator (seeded from Python's shared state),
    and at mask ratio 0 it is every patch in some order."""
    return [(b["video"].tobytes(), b["text"], b["meta"], np.sort(b["keep_ind"], -1).tolist())
            for b in loader]


def test_loader_items_over_workers_equal_sync_and_jax(tree):
    """Items spread over 2 threads (and the fork pool, in a fresh interpreter:
    this process holds JAX's threads) give the batches of num_workers=0 and of
    the JAX ShardedLoader, on the MSRVTT test split (uniform sampling), with a
    ragged last batch."""
    args = ("MSRVTT", "msrvtt", dict(split="test", cut="jsfusion"))
    want = _uniform_batches(jax_module("data.loader").ShardedLoader(
        _build(jax_module("data.datasets").dataset_loader, tree, *args), batch_size=2,
        shuffle=True, drop_last=False, num_workers=0, seed=3))
    assert len(want) == 2 and len(want[-1][1]) == 1
    for workers in (0, 2):
        got = port_loader.ShardedLoader(_build(port_ds.dataset_loader, tree, *args),
                                        batch_size=2, shuffle=True, drop_last=False,
                                        num_workers=workers, seed=3)
        assert _uniform_batches(got) == want, workers
    data, meta = tree
    code = (
        "import json, numpy as np, sys\n"
        "from tvts_torch.data.datasets import dataset_loader\n"
        "from tvts_torch.data.loader import ShardedLoader\n"
        "def batches(loader): return [(b['video'].tobytes(), b['text'], b['meta'],\n"
        "    np.sort(b['keep_ind'], -1).tolist()) for b in loader]\n"
        "ds = dataset_loader('MSRVTT', {}, json.loads(sys.argv[3]), sys.argv[1],\n"
        "    meta_root=sys.argv[2], patches_per_frame=16, reader='cv2', split='test',\n"
        "    cut='jsfusion')\n"
        "kw = dict(batch_size=2, shuffle=True, drop_last=False, seed=3)\n"
        "want = batches(ShardedLoader(ds, num_workers=0, **kw))\n"
        "got = batches(ShardedLoader(ds, num_workers=2, use_processes=True, **kw))\n"
        "assert len(want) == 2 and got == want\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code, data, meta, json.dumps(VIDEO_PARAMS)],
                          cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_loader_shards_are_disjoint_at_two_processes():
    seen = []
    for rank in range(2):
        loader = port_loader.ShardedLoader(ToyDataset(), batch_size=3, shuffle=True,
                                           num_workers=2, process_index=rank, num_processes=2)
        seen.append([int(v) for b in loader for v in b["video"][:, 0, 0]])
    assert not set(seen[0]) & set(seen[1])
    assert len(seen[0]) == len(seen[1]) == 12


def test_loader_takes_the_rank_from_torch_distributed(monkeypatch):
    import torch.distributed as dist

    assert port_loader.ShardedLoader(ToyDataset(), 2).num_processes == 1
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    loader = port_loader.ShardedLoader(ToyDataset(), 2)
    assert (loader.process_index, loader.num_processes) == (1, 2)
    loader = port_loader.ShardedLoader(ToyDataset(), 2, process_index=0, num_processes=3)
    assert (loader.process_index, loader.num_processes) == (0, 3)


def test_collate_and_val_split_equal_jax():
    jax_loader = jax_module("data.loader")
    samples = [ToyDataset()[i] for i in range(3)]
    assert _flat([port_loader.default_collate(samples)]) == \
        _flat([jax_loader.default_collate(samples)])
    for frac in (0.25, 5):
        got = port_loader.make_val_split(ToyDataset(), frac, seed=3)
        want = jax_loader.make_val_split(ToyDataset(), frac, seed=3)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.indices, w.indices)
            assert g[1]["label"] == w[1]["label"]


# ---------------------------------------------------------------------------
# the config reader
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["dist-yt-web-pt-vit-b-16.json", "v1-dist-yt-pt.json"])
def test_config_parser_reads_the_jax_configs(name, tmp_path):
    from tvts_torch.utils.config import ConfigParser, CustomArgs, read_json

    path = os.path.join(REPO, "tvts_tpu", "configs", name)
    jax_config = jax_module("utils.config")
    args = type("Args", (), {"config": path, "resume": None, "epochs": 3, "save_dir": None})()
    options = [CustomArgs(["--ep", "--epochs"], int, "trainer;epochs"),
               CustomArgs(["--save_dir"], str, "trainer;save_dir")]
    got = ConfigParser.from_args(args, options, test=True)
    want = jax_config.ConfigParser.from_args(args, options, test=True)
    assert got.config == want.config
    assert got["trainer"]["epochs"] == 3 and got["trainer"] == want["trainer"]
    saved = ConfigParser({**read_json(path), "trainer": {"save_dir": str(tmp_path)}},
                         run_id="r")
    assert read_json(saved.save_dir / "config.json")["name"] == got["name"]


@pytest.mark.parametrize("spec_name,sub,overrides", [
    ("zero-msrvtt-vit-b-16.json", "msrvtt", {"cut": "jsfusion"}),
    ("zero-ucf101-vit-b-16.json", "ucf101", {}),
    ("zero-ssv2-mc-vit-b-16.json", "ssv2", {"prefix": "x", "index": 1, "cut_webvid": 3}),
])
def test_initialize_dataset_loader_equals_jax(tree, spec_name, sub, overrides):
    from tvts_torch.utils.config import ConfigParser, read_json

    data, meta = tree
    config = read_json(os.path.join(REPO, "tvts_tpu", "configs", spec_name))
    args = config["data_loader"]["args"]
    args.update(data_dir=data if sub == "msrvtt" else os.path.join(data, sub), meta_root=meta,
                num_workers=2, batch_size=2, reader="cv2", video_params=VIDEO_PARAMS,
                patches_per_frame=16, **overrides)
    test = {"split": "test", "shuffle": False}
    got_ds, got = ConfigParser(config, test=True).initialize_dataset_loader(
        config["data_loader"], test)
    want_ds, want = jax_module("utils.config").ConfigParser(
        config, test=True).initialize_dataset_loader(config["data_loader"], test)
    assert type(got_ds).__name__ == type(want_ds).__name__
    assert (got.batch_size, got.shuffle, got.num_workers, got.process_index,
            got.num_processes) == (want.batch_size, want.shuffle, want.num_workers,
                                   want.process_index, want.num_processes)
    random.seed(0)
    np.random.seed(0)
    got_batches = list(got)
    random.seed(0)
    np.random.seed(0)
    want_batches = list(want)
    assert len(got_batches) == len(want_batches) > 0
    for g, w in zip(got_batches, want_batches):
        assert list(g) == list(w)
        np.testing.assert_array_equal(g["video"], w["video"])
        assert g["text"] == w["text"] and g["meta"] == w["meta"]
