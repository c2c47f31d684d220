"""Metadata-driven video-text datasets (counterpart of
tvts_tpu/data/datasets.py), with no pandas.

The reference's `TextVideoDataset` (v2/base/base_dataset.py:18-142) and its
subclasses (v2/data_loader/*_dataset.py). Each item is the reference's dict:
{'video' [T, C, H, W] float32 normalised, 'text', 'keep_ind', 'label'
(classification and multiple choice only), 'meta'}. Kept from the reference:
- rand frame sampling for train, uniform for test; the sliding-window
  fix_start expansion for test-time temporal augmentation (:90-97);
- strict or lax loading: lax puts a black clip where a video fails (:116-123);
- zero-padding to num_frames (:128-130); a random tube keep set a sample
  (:133-138);
- each dataset's metadata format (MSRVTT cuts with the jsfusion caption-index
  pickle, DiDeMo / LSMDC tsv, WebVid tsv, HMDB51 / UCF101 / K400 prompt tsv,
  SSV2-MC jsonl).

What the JAX package does with pandas is done here with `csv`, `json`,
`pickle` and numpy, to the same rows in the same order (tests/test_torch_data.py
holds them to the JAX package):
- a tsv's first row is its header; each column's type is inferred as
  pandas' read_csv infers it (`read_table`): all integers -> int, so WebVid's
  video id 0123 names 123.mp4 as in the JAX package; numbers -> float; the
  pandas spellings of True / False -> bool; pandas' missing-value strings ->
  NaN; else str. A row is read by column position (`Row.values`, pandas'
  iloc) or by column name;
- `groupby(...).apply(list)` sorts by the key and keeps each group's caption
  order; `sample(n, random_state=0)` is np.random.RandomState(0).choice(n_rows,
  n, replace=False), and `sample(frac=f)` draws from numpy's global random
  state, as pandas does;
- `explode` keeps the row order and repeats a row once a window start; a video
  of length 0 has no start and keeps one row with fix_start NaN, which loads
  as a failed video (strict raises, lax gives a black clip), as in the JAX
  package.
Items seed their generator from Python's `random.getrandbits(63)` and train /
val captions come from `random.choice`, as in the JAX package.
"""

from __future__ import annotations

import csv
import json
import math
import os
import pickle
import random
import re

import numpy as np

from tvts_torch.data import video_reader
from tvts_torch.data.transforms import video_transform
from tvts_torch.data.ytt import YTTemporal

# read_csv's default missing-value strings
_NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"})
_INT = re.compile(r"\s*[+-]?\d+\s*")
_FLOAT = re.compile(r"\s*[+-]?(?:(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?|inf|infinity|nan)\s*",
                    re.IGNORECASE)
_BOOLS = {"True": True, "TRUE": True, "true": True,
          "False": False, "FALSE": False, "false": False}


class Row:
    """One metadata row: `values` by column position (pandas' iloc), `[name]`
    by column, `name` its index label."""

    __slots__ = ("name", "values", "columns")

    def __init__(self, name, values: tuple, columns: tuple):
        self.name, self.values, self.columns = name, values, columns

    def __getitem__(self, column):
        return self.values[self.columns.index(column)]

    def replace(self, column, value) -> "Row":
        values = list(self.values)
        if column in self.columns:
            values[self.columns.index(column)] = value
            return Row(self.name, tuple(values), self.columns)
        return Row(self.name, (*values, value), (*self.columns, column))


def _parse_column(cells: list[str | None]) -> list:
    """read_csv's type inference for one column (None: a missing cell)."""
    present = [c for c in cells if c is not None and c not in _NA_VALUES]
    missing = len(present) < len(cells)
    if not present:
        return [math.nan] * len(cells)
    if all(_INT.fullmatch(c) for c in present):
        kind = float if missing else int
    elif all(_FLOAT.fullmatch(c) for c in present):
        kind = float
    elif all(c in _BOOLS for c in present):
        kind = _BOOLS.__getitem__
    else:
        kind = str
    return [math.nan if c is None or c in _NA_VALUES else
            kind(c.strip()) if kind is int or kind is float else kind(c) for c in cells]


def read_table(path: str, sep: str = "\t", names: list[str] | None = None
               ) -> tuple[tuple, list[Row]]:
    """(columns, rows) of a delimited file as pandas.read_csv(path, sep=sep,
    names=names) reads it: the header row unless `names` is given, blank
    lines skipped, short rows padded with NaN, each column's type inferred.
    A row longer than the header raises ValueError (pandas would take the
    extra column as the index)."""
    with open(path, newline="") as f:
        lines = [line for line in csv.reader(f, delimiter=sep) if line]
    if names is None:
        if not lines:
            raise ValueError(f"{path}: no header row")
        names, lines = lines[0], lines[1:]
    columns = tuple(names)
    for i, line in enumerate(lines):
        if len(line) > len(columns):
            raise ValueError(f"{path}: row {i} has {len(line)} fields, the header {len(columns)}")
    cells = [[line[j] if j < len(line) else None for line in lines] for j in range(len(columns))]
    parsed = [_parse_column(column) for column in cells]
    return columns, [Row(i, tuple(col[i] for col in parsed), columns)
                     for i in range(len(lines))]


def sample_rows(rows: list, n: int | None = None, frac: float | None = None,
                random_state: int | None = None) -> list:
    """pandas' DataFrame.sample without replacement: `n` rows, or
    round(frac * len) rows, drawn by numpy's RandomState(random_state) or,
    without one, by numpy's global random state."""
    size = n if n is not None else round(frac * len(rows))
    rs = np.random if random_state is None else np.random.RandomState(random_state)
    return [rows[i] for i in rs.choice(len(rows), size=size, replace=False)]


def load_caption_index(path: str) -> dict:
    """The jsfusion caption index: a pickle of video id -> caption index (the
    JAX package reads it with np.load(allow_pickle=True) into a pd.Series).
    A mapping, or an object with .items() (a pandas Series, where pandas is
    installed). A pickled pandas object where pandas is not installed raises
    naming the file and pandas."""
    try:
        with open(path, "rb") as f:
            obj = pickle.load(f)
    except ModuleNotFoundError as err:
        if err.name and err.name.split(".")[0] == "pandas":
            raise RuntimeError(
                f"{path} holds a pickled pandas object, and pandas is not installed: "
                "re-save it as a plain dict of video id -> caption index") from err
        raise
    if not hasattr(obj, "items"):
        raise TypeError(f"{path}: expected a mapping of video id -> caption index, "
                        f"got {type(obj).__name__}")
    return dict(obj.items())


class TextVideoDataset:
    def __init__(self,
                 dataset_name: str,
                 text_params: dict,
                 video_params: dict,
                 data_dir: str,
                 metadata_dir: str | None = None,
                 split: str = "train",
                 cut: str | None = None,
                 subsample: float = 1,
                 sliding_window_stride: int = -1,
                 reader: str = "auto",
                 patches_per_frame: int = 196,
                 mask_ratio: float = 0.0,
                 meta_root: str = "meta_data"):
        self.dataset_name = dataset_name
        self.text_params = text_params
        self.video_params = video_params
        self.data_dir = os.path.expandvars(data_dir)
        self.metadata_dir = os.path.expandvars(metadata_dir) if metadata_dir else self.data_dir
        self.meta_root = meta_root
        self.split = split
        self.cut = cut
        self.subsample = subsample
        self.sliding_window_stride = sliding_window_stride
        self.reader = reader
        self.patches_per_frame = patches_per_frame
        self.mask_ratio = mask_ratio
        self.label_type = "caption"
        self.metadata: list = []
        self._load_metadata()
        if self.sliding_window_stride != -1:
            if self.split != "test":
                raise ValueError("fixed frame sampling is test-time only")
            self._fix_temporal_samples()

    # --- subclass hooks -------------------------------------------------
    def _load_metadata(self):
        raise NotImplementedError

    def _get_video_path(self, sample):
        raise NotImplementedError

    def _get_caption(self, sample):
        raise NotImplementedError

    # --- shared machinery ------------------------------------------------
    def _read_split_table(self, rel: str) -> list[Row]:
        """A tsv under meta_root, subsampled as the JAX package does."""
        _, rows = read_table(os.path.join(self.meta_root, rel))
        if self.subsample < 1:
            return sample_rows(rows, frac=self.subsample)
        return rows

    def _get_video_lens(self) -> list[int]:
        out = []
        for row in self.metadata:
            try:
                out.append(video_reader.get_video_len(self._get_video_path(row)[0],
                                                      backend=self.reader))
            except Exception:  # an unreadable video counts 0 frames, as in the JAX package
                out.append(0)
        return out

    def _fix_temporal_samples(self):
        """The sliding-window test expansion (base_dataset.py:90-97), with its
        quirk: the starts run to int(vlen / len(intervals)) (`len(x - 1)` is
        `len(x)`)."""
        nf = self.video_params["num_frames"]
        expanded = []
        for row, vlen in zip(self.metadata, self._get_video_lens()):
            intervals = np.linspace(start=0, stop=vlen, num=min(vlen, nf) + 1).astype(int)
            starts = np.arange(0, int(intervals[-1] / len(intervals)),
                               self.sliding_window_stride)
            for start in (starts if len(starts) else [math.nan]):
                expanded.append(row.replace("fix_start", start))
        self.metadata = expanded

    def __len__(self):
        return len(self.metadata)

    def _load_clip(self, video_fp, fix_start, rng):
        num_frames = self.video_params["num_frames"]
        res = self.video_params["input_res"]
        frame_sample = "uniform" if self.split == "test" else "rand"
        loading = self.video_params.get("loading", "strict")
        try:
            frames, _ = video_reader.read_frames_sampled(
                video_fp, num_frames, sample=frame_sample, fix_start=fix_start,
                rng=rng, backend=self.reader)
        except Exception as err:  # any failure to read the video, as in the JAX package
            if loading == "strict":
                raise ValueError(
                    f"Video loading failed for {video_fp}, loading is strict") from err
            frames = np.zeros((1, res, res, 3), dtype=np.uint8)  # lax: a black frame
        imgs = video_transform(frames, crop_size=res,
                               mode="train" if self.split == "train" else "test", rng=rng)
        final = np.zeros((num_frames, 3, res, res), dtype=np.float32)
        final[: imgs.shape[0]] = imgs
        return final

    def _tube_mask(self, rng):
        n_keep = int(self.patches_per_frame * (1 - self.mask_ratio))
        ind = rng.permutation(self.patches_per_frame)
        return ind[:n_keep].astype(np.int32)

    def __getitem__(self, item):
        rng = np.random.default_rng(random.getrandbits(63))
        sample = self.metadata[item % len(self.metadata)]
        video_fp, rel_fp = self._get_video_path(sample)
        caption = self._get_caption(sample)
        fix_start = sample["fix_start"] if self.sliding_window_stride != -1 else None
        final = self._load_clip(video_fp, fix_start, rng)
        data = {
            "video": final,
            "text": caption,
            "keep_ind": self._tube_mask(rng),
            "meta": {"raw_captions": caption, "paths": rel_fp,
                     "dataset": self.dataset_name},
        }
        if self.label_type == "label":
            data["label"] = int(sample.values[1])
        return data


# --------------------------------------------------------------------------
# retrieval datasets


class MSRVTT(TextVideoDataset):
    """MSRVTT with the miech / jsfusion / full cuts (reference
    MSRVTT_dataset.py:10-73). A row is a video: its name the video id, its
    one column the captions."""

    def _load_metadata(self):
        with open(os.path.join(self.meta_root, "msrvtt", "MSR_VTT.json")) as fid:
            annotations = json.load(fid)["annotations"]

        split_dir = os.path.join(self.metadata_dir, "high-quality", "structured-symlinks")
        js_test_cap_idx_path = None
        challenge_splits = {"val", "public_server_val", "public_server_test"}
        if self.cut == "miech":
            train_list, test_list = "train_list_miech.txt", "test_list_miech.txt"
        elif self.cut == "jsfusion":
            train_list, test_list = "train_list_jsfusion.txt", "val_list_jsfusion.txt"
            js_test_cap_idx_path = "jsfusion_val_caption_idx.pkl"
        elif self.cut in {"full-val", "full-test"}:
            train_list = "train_list_full.txt"
            test_list = "val_list_full.txt" if self.cut == "full-val" else "test_list_full.txt"
        elif self.cut in challenge_splits:
            train_list = "train_list.txt"
            test_list = f"{self.cut}_list.txt" if self.cut == "val" else f"{self.cut}.txt"
        else:
            raise ValueError(f"unrecognised MSRVTT split: {self.cut}")

        _, train_rows = read_table(os.path.join(split_dir, train_list), sep=",",
                                   names=["videoid"])
        _, test_rows = read_table(os.path.join(split_dir, test_list), sep=",",
                                  names=["videoid"])
        self.split_sizes = {"train": len(train_rows), "val": len(test_rows),
                            "test": len(test_rows)}

        keep = {row.values[0] for row in (train_rows if self.split == "train" else test_rows)}
        groups: dict = {}
        for ann in annotations:  # isin keeps the json's order, groupby each group's
            if ann["image_id"] in keep:
                groups.setdefault(ann["image_id"], []).append(ann["caption"])
        columns = ("captions",)
        self.metadata = [Row(vid, (groups[vid],), columns) for vid in sorted(groups)]
        if self.subsample < 1:
            self.metadata = sample_rows(self.metadata, frac=self.subsample)

        if js_test_cap_idx_path is not None and self.split != "train":
            caps = load_caption_index(os.path.join(split_dir, js_test_cap_idx_path))
            ids = [row.name for row in self.metadata]
            # pandas aligns the two on their index: in this order where they are
            # equal, else in the sorted union, where each id needs both
            order = ids if ids == list(caps) else sorted(set(ids) | set(caps))
            by_id = {row.name: row.values[0] for row in self.metadata}
            missing = [vid for vid in order if vid not in by_id or vid not in caps]
            if missing:
                raise ValueError(f"jsfusion caption index and the {self.split} list differ "
                                 f"on {missing[:5]}")
            self.metadata = [Row(vid, ([by_id[vid][int(caps[vid])]],), columns)
                             for vid in order]

    def _get_video_path(self, sample):
        return (os.path.join(self.data_dir, "videos", "all", sample.name + ".mp4"),
                sample.name + ".mp4")

    def _get_caption(self, sample):
        if self.split in ("train", "val") and \
                self.text_params.get("caption_sample", "rand") == "rand":
            return random.choice(sample["captions"])
        return sample["captions"][0]


class DiDeMo(TextVideoDataset):
    def _load_metadata(self):
        split_files = {"train": "didemo/DiDeMo_train.tsv",
                       "val": "didemo/DiDeMo_test.tsv",
                       "test": "didemo/DiDeMo_test.tsv"}
        self.metadata = self._read_split_table(split_files[self.split])

    def _get_video_path(self, sample):
        rel = sample.values[1]
        return os.path.join(self.data_dir, rel), rel

    def _get_caption(self, sample):
        return sample.values[0]


class LSMDC(TextVideoDataset):
    def _load_metadata(self):
        split_files = {"train": "lsmdc/LSMDC16_annos_training_real.csv",
                       "val": "lsmdc/LSMDC16_challenge_1000_publictect.csv",
                       "test": "lsmdc/LSMDC16_challenge_1000_publictect.csv"}
        self.metadata = self._read_split_table(split_files[self.split])

    def _get_video_path(self, sample):
        video_fp = sample.values[0]
        sub_path = video_fp.split(".")[0]
        remove = sub_path.split("_")[-1]
        sub_path = sub_path.replace("_" + remove, "/")
        rel = sub_path + video_fp + ".avi"
        return os.path.join(self.data_dir, rel), rel

    def _get_caption(self, sample):
        return sample.values[-1]


class WebVid(TextVideoDataset):
    def _load_metadata(self):
        split_files = {"train": "webvid_train.tsv", "val": "webvid_val.tsv"}
        self.metadata = self._read_split_table(split_files[self.split])
        if self.subsample >= 1 and self.split == "val":
            self.metadata = sample_rows(self.metadata, n=min(1000, len(self.metadata)),
                                        random_state=0)

    def _get_video_path(self, sample):
        rel = str(sample.values[1]) + ".mp4"
        return os.path.join(self.data_dir, self.split, rel), rel

    def _get_caption(self, sample):
        return [sample.values[0]]  # list-wrapped, as joint training with YT-Temporal takes it


# --------------------------------------------------------------------------
# classification / multiple-choice datasets


class _PromptClassDataset(TextVideoDataset):
    """HMDB51 / UCF101 / K400: tsv rows (relpath, label); the text is 'NULL'
    (the zero-shot classifier is built from prompts at eval time)."""

    split_files: dict = {}

    def _load_metadata(self):
        self.metadata = self._read_split_table(self.split_files[self.split])
        if self.subsample >= 1 and self.split == "val":
            self.metadata = sample_rows(self.metadata, n=min(1000, len(self.metadata)),
                                        random_state=0)
        self.label_type = "label"

    def _get_caption(self, sample):
        return "NULL"


class Kinetics400(_PromptClassDataset):
    split_files = {"train": "k400/prompt/kinetics400_train_list_videos.tsv",
                   "val": "k400/prompt/kinetics400_val_list_videos.tsv",
                   "test": "k400/prompt/kinetics400_val_list_videos.tsv"}

    def _get_video_path(self, sample):
        class_name, video_name = sample.values[0].split("/")
        if video_name.endswith(".mkv"):
            video_name = video_name[:-4] + ".mp4"
        sub = "train/train" if self.split == "train" else "videos_val"
        return os.path.join(self.data_dir, sub, video_name), video_name


class HMDB51(_PromptClassDataset):
    # the reference's HMDB51_dataset.py: split_1 lists, paths relative to data_dir
    split_files = {"train": "hmdb51/prompt/split_1_train_list.tsv",
                   "val": "hmdb51/prompt/split_1_test_list.tsv",
                   "test": "hmdb51/prompt/split_1_test_list.tsv"}

    def _get_video_path(self, sample):
        rel = sample.values[0]
        return os.path.join(self.data_dir, rel), rel


class UCF101(_PromptClassDataset):
    # the reference's UCF101_dataset.py: the trainlist01 / testlist01 tsvs
    split_files = {"train": "ucf101/prompt/trainlist01_new.tsv",
                   "val": "ucf101/prompt/testlist01_new.tsv",
                   "test": "ucf101/prompt/testlist01_new.tsv"}

    def _get_video_path(self, sample):
        rel = sample.values[0]
        return os.path.join(self.data_dir, rel), rel


class SSV2_mc(TextVideoDataset):
    """174-option multiple choice (reference SSV2_mc_dataset.py:13-73)."""

    def _load_metadata(self):
        split_files = {"val": "ssv2/mc/val.jsonl", "test": "ssv2/mc/val.jsonl"}
        self.metadata = []
        with open(os.path.join(self.meta_root, split_files[self.split])) as f:
            for line in f:
                line = line.strip()
                if line:
                    self.metadata.append(json.loads(line))

    def _get_video_path(self, sample):
        return (os.path.join(self.data_dir, "videos", sample["clip_name"]),
                os.path.join("videos", sample["clip_name"]))

    def __getitem__(self, item):
        rng = np.random.default_rng(random.getrandbits(63))
        sample = self.metadata[item % len(self.metadata)]
        video_fp, rel_fp = self._get_video_path(sample)
        final = self._load_clip(video_fp, None, rng)
        return {
            "video": final,
            "text": sample["options"],
            "label": int(sample["answer"]),
            "keep_ind": self._tube_mask(rng),
            "meta": {"raw_captions": "NULL", "paths": rel_fp,
                     "dataset": self.dataset_name},
        }


DATASET_REGISTRY = {
    "MSRVTT": MSRVTT,
    "DiDeMo": DiDeMo,
    "LSMDC": LSMDC,
    "WebVid": WebVid,
    "Kinetics400": Kinetics400,
    "HMDB51": HMDB51,
    "UCF101": UCF101,
    "SSV2_mc": SSV2_mc,
    "YTTemporal": YTTemporal,
}
# datasets of the JAX package's registry that this package does not read yet:
# name -> (the JAX reader, the ROADMAP.md item that ports it)
NOT_PORTED = {
    "ConceptualCaptions3M": ("tvts_tpu/data/image_datasets.py", "M4"),
}


def dataset_loader(dataset_name: str, *args, **kwargs):
    """Name -> dataset (reference data_loader.py:15-68)."""
    if dataset_name in NOT_PORTED:
        reader, item = NOT_PORTED[dataset_name]
        raise NotImplementedError(
            f"dataset {dataset_name} is not ported yet: its JAX reader is {reader}; "
            f"ROADMAP.md item {item} ports it")
    if dataset_name not in DATASET_REGISTRY:
        raise NotImplementedError(f"dataset {dataset_name} not implemented")
    return DATASET_REGISTRY[dataset_name](dataset_name, *args, **kwargs)
