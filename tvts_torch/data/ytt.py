"""YT-Temporal transcript-sorting dataset (counterpart of tvts_tpu/data/ytt.py;
reference v2/data_loader/YTTemporal_dataset.py), without pandas.

- metadata: a tsv with a 'Name' column of relative video paths (:80-93), read
  by `datasets.read_table` as pandas' read_csv reads it;
- per sample: a random window of `randint(3, 5) * num_clips + (num_clips - 1)`
  seconds (:114), split into num_clips sub-clips 1 s apart (:123-131);
- per clip: the DTW-denoised ASR words whose times fall inside it (:133-147);
  labels are arange(num_clips) (:149);
- frames: num_frames * num_clips rand-sampled inside the window by the
  multi-clip reader; one shared tube keep set a sample, or `per_tube_masks`
  keep sets (v1's, a different spatial set a tube);
- on a failed item, retry with a random index, max_try times, then raise (the
  JAX package's deviation from the reference's sys.exit).
Each item draws from np.random.default_rng(random.getrandbits(63)), so under
the same `random.seed` an item is bit for bit the JAX package's.
"""

from __future__ import annotations

import json
import os
import random

import numpy as np

from tvts_torch.data import video_reader
from tvts_torch.data.asr import _fix_text, align_using_dtw, clean_subtitles
from tvts_torch.data.transforms import video_transform


class YTTemporal:
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
                 meta_root: str = "meta_data",
                 num_clips: int = 4,
                 max_try: int = 5,
                 per_tube_masks: int = 0):
        # datasets.py registers this class, so its table reader is imported here
        from tvts_torch.data.datasets import read_table

        self.dataset_name = dataset_name
        self.video_params = video_params
        self.data_dir = os.path.expandvars(data_dir)
        self.split = split
        self.reader = reader
        self.num_frames = video_params["num_frames"]
        self.input_res = video_params["input_res"]
        self.num_clips = num_clips
        self.patches_per_frame = patches_per_frame
        self.mask_ratio = mask_ratio
        self.max_try = max_try
        self.per_tube_masks = per_tube_masks
        self.min_time = 4.0
        self.interval = 1

        split_files = {"train": "yttemporal_train.csv",
                       "val": "yttemporal_val.csv",
                       "test": "yttemporal_val.csv"}
        _, rows = read_table(os.path.join(meta_root, split_files[split]), sep="\t")
        self.metadata = [row["Name"] for row in rows]

    def __len__(self):
        return len(self.metadata)

    def _get_video_path(self, sample):
        return os.path.join(self.data_dir, "videos", sample), sample

    def get_caption_path(self, sample):
        return os.path.join(self.data_dir, "videos", sample.split("/")[0],
                            "annotations", sample.split("/")[-1][:-4] + ".json")

    def get_caption_multi(self, caption_json: str, rng: np.random.Generator):
        """(the num_clips transcripts, labels, clip starts, clip ends, video
        length in seconds) of one annotation file."""
        with open(caption_json) as f:
            cap = json.load(f)

        all_text = clean_subtitles(cap["subtitles"])
        words = [x["word"] for x in all_text]
        denoised_word_by_word = []
        for x in cap["denoised"]:
            denoised_word_by_word += _fix_text(x["cleanasr"]).split(" ")
        denoised = align_using_dtw(words, denoised_word_by_word)

        video_len = int(cap["info"]["duration"])
        segm_length = int(rng.integers(3, 6)) * self.num_clips \
            + self.interval * (self.num_clips - 1)
        if video_len - segm_length - 1 > 0:
            start = float(rng.integers(0, video_len - segm_length - 1)) + float(rng.random())
            end = min(video_len - 1, start + segm_length)
        else:
            start, end = 0.0, float(video_len - 1)

        clip_len = (end - start - self.interval * (self.num_clips - 1)) / self.num_clips
        start_all = [start + i * (clip_len + self.interval) for i in range(self.num_clips)]
        end_all = [cs + clip_len for cs in start_all]

        text_all = []
        for cs, ce in zip(start_all, end_all):
            text = ""
            for idx, item in enumerate(all_text):
                if cs < float(item["time"]) < ce:
                    text += denoised[idx] + " "
            text_all.append(text)
        return text_all, np.arange(self.num_clips), start_all, end_all, video_len

    def _get_sample(self, index: int, rng: np.random.Generator):
        sample = self.metadata[index]
        text_all, label, start_all, end_all, duration = self.get_caption_multi(
            self.get_caption_path(sample), rng)
        abs_fp, rel_fp = self._get_video_path(sample)
        frames = video_reader.read_multi_clip(abs_fp, start_all, end_all, duration,
                                              self.num_frames, self.num_clips, rng=rng,
                                              backend=self.reader)
        if frames.shape[0] != self.num_frames * self.num_clips:
            raise RuntimeError(f"video length not enough: {rel_fp}")
        imgs = video_transform(frames, crop_size=self.input_res,
                               mode="train" if self.split == "train" else "test", rng=rng)

        n_keep = int(self.patches_per_frame * (1 - self.mask_ratio))
        if self.per_tube_masks > 0:
            keep_ind = np.stack([rng.permutation(self.patches_per_frame)[:n_keep]
                                 for _ in range(self.per_tube_masks)]).astype(np.int32)
        else:
            keep_ind = rng.permutation(self.patches_per_frame)[:n_keep].astype(np.int32)

        return {
            "video": imgs.astype(np.float32),
            "text": text_all,                 # num_clips transcript strings
            "label": label.astype(np.int32),  # arange(num_clips)
            "keep_ind": keep_ind,
            "meta": {"paths": rel_fp, "dataset": self.dataset_name},
        }

    def __getitem__(self, index: int):
        rng = np.random.default_rng(random.getrandbits(63))
        last_err = None
        for _ in range(self.max_try + 1):
            try:
                return self._get_sample(index, rng)
            except Exception as e:  # retry with a random index (reference :215-243)
                last_err = e
                index = int(rng.integers(0, len(self.metadata)))
        raise RuntimeError(f"exceeded max_try reading {self.dataset_name}") from last_err
