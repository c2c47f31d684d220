"""MLM-style collate for the YT-Temporal dataset family (counterpart of
tvts_tpu/data/collate.py; reference v2/base/base_dataset_yt.py:183-269,
`BaseDataset.collate`): dict-of-lists batch assembly; every "image" key is
zero-padded to the batch's largest H and W into per-view [B, T, 3, H, W]
arrays; every "text" key carries (raw_text, encoding) pairs that go through an
HF-style MLM collator, giving `<key>_ids`, `<key>_labels` (all -100),
`<key>_ids_mlm`, `<key>_labels_mlm` and `<key>_masks`.

Dead code in the reference's released trainers (they CLIP-tokenize raw
strings instead), and in this package: ported for surface parity only and on
no path. The MLM collator is HF DataCollatorForLanguageModeling's rule (15%
selected; of those 80% -> [MASK], 10% -> a random token, 10% unchanged;
labels -100 outside the selection), in numpy with an explicit
np.random.Generator, so the same generator seed gives the JAX package's
arrays.
"""

from __future__ import annotations

import numpy as np


class MLMCollator:
    """HF DataCollatorForLanguageModeling equivalent (numpy).

    special_ids: token ids never selected for masking (CLS/SEP/PAD...).
    """

    def __init__(self, vocab_size: int, mask_token_id: int,
                 special_ids: tuple = (), mlm_probability: float = 0.15,
                 rng: np.random.Generator | None = None):
        self.vocab_size = vocab_size
        self.mask_token_id = mask_token_id
        self.special_ids = set(special_ids)
        self.mlm_probability = mlm_probability
        self.rng = rng or np.random.default_rng()

    def __call__(self, encodings: list) -> dict:
        """encodings: list of dicts with 'input_ids' (+ optional
        'attention_mask'). Returns {'input_ids': [B, L], 'labels': [B, L]}
        with right-zero padding to the batch max length."""
        max_len = max(len(e["input_ids"]) for e in encodings)
        B = len(encodings)
        ids = np.zeros((B, max_len), dtype=np.int64)
        special = np.ones((B, max_len), dtype=bool)  # pad counts as special
        for i, e in enumerate(encodings):
            seq = np.asarray(e["input_ids"], dtype=np.int64)
            ids[i, : len(seq)] = seq
            special[i, : len(seq)] = [int(t) in self.special_ids for t in seq]

        prob = np.full(ids.shape, self.mlm_probability)
        prob[special] = 0.0
        selected = self.rng.random(ids.shape) < prob
        labels = np.where(selected, ids, -100)

        out = ids.copy()
        # 80% of selected -> [MASK]
        replaced = selected & (self.rng.random(ids.shape) < 0.8)
        out[replaced] = self.mask_token_id
        # 10% (half of the remaining 20%) -> random token
        randomized = selected & ~replaced & (self.rng.random(ids.shape) < 0.5)
        out[randomized] = self.rng.integers(0, self.vocab_size,
                                            size=int(randomized.sum()))
        # remaining 10%: unchanged
        return {"input_ids": out, "labels": labels}


def mlm_collate(batch: list, num_frames: int, mlm_collator: MLMCollator) -> dict:
    """Reference `BaseDataset.collate` (base_dataset_yt.py:183-269).

    batch: list of sample dicts. "image" values are lists of views, each view
    [T, 3, H, W]; "text" values are (raw_text, encoding) pairs."""
    batch_size = len(batch)
    keys = {k for b in batch for k in b}
    dict_batch = {k: [b.get(k) for b in batch] for k in keys}

    img_keys = [k for k in dict_batch if "image" in k]
    img_sizes = [tuple(view.shape) for k in img_keys
                 for sample in dict_batch[k] if sample is not None
                 for view in sample]
    for size in img_sizes:
        if len(size) != 4:
            raise ValueError(f"Collate error, an image should be in shape of (T, 3, H, W), "
                             f"instead of given {size}")

    if img_keys:
        max_h = max(s[2] for s in img_sizes)
        max_w = max(s[3] for s in img_sizes)
    for k in img_keys:
        views = len(dict_batch[k][0])
        new_images = [np.zeros((batch_size, num_frames, 3, max_h, max_w),
                               dtype=np.float32) for _ in range(views)]
        for bi in range(batch_size):
            if dict_batch[k][bi] is None:
                continue
            for vi in range(views):
                orig = np.asarray(dict_batch[k][bi][vi])
                new_images[vi][bi, :, :, : orig.shape[-2],
                               : orig.shape[-1]] = orig
        dict_batch[k] = new_images

    txt_keys = [k for k in dict_batch if "text" in k]
    if txt_keys:
        encodings = [[d[1] for d in dict_batch[k]] for k in txt_keys]
        flatten = [e for enc in encodings for e in enc]
        flatten_mlms = mlm_collator(flatten)

        for i, k in enumerate(txt_keys):
            texts = [d[0] for d in dict_batch[k]]
            encs = [d[1] for d in dict_batch[k]]
            mlm_ids = flatten_mlms["input_ids"][batch_size * i:
                                                batch_size * (i + 1)]
            mlm_labels = flatten_mlms["labels"][batch_size * i:
                                                batch_size * (i + 1)]
            input_ids = np.zeros_like(mlm_ids)
            attention_mask = np.zeros_like(mlm_ids)
            for bi, enc in enumerate(encs):
                seq = np.asarray(enc["input_ids"], dtype=mlm_ids.dtype)
                mask = np.asarray(enc.get("attention_mask",
                                          np.ones(len(seq), dtype=np.int64)),
                                  dtype=mlm_ids.dtype)
                input_ids[bi, : len(seq)] = seq
                attention_mask[bi, : len(mask)] = mask
            dict_batch[k] = texts
            dict_batch[f"{k}_ids"] = input_ids
            dict_batch[f"{k}_labels"] = np.full_like(input_ids, -100)
            dict_batch[f"{k}_ids_mlm"] = mlm_ids
            dict_batch[f"{k}_labels_mlm"] = mlm_labels
            dict_batch[f"{k}_masks"] = attention_mask

    return dict_batch
