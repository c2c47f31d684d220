"""Pretraining batch preparation (counterpart of tvts_tpu/train/trainer.py:38-87;
reference v2/trainer/trainer.py:465-473): a collated loader batch -> the
numeric arrays of the train step (train/step.py).

- text: the per-clip transcripts concatenated clip-major, then CLIP-tokenized
  with truncation (`clip_tokenize_fn`); YT-Temporal gives 4 transcripts a
  clip (the sort loss on), WebVid 1 (off);
- a 2-D `label` (YT-Temporal's arange(num_clips) per clip) becomes `labels`.
The Trainer (the epoch loop, validation, checkpoints) is ROADMAP.md item M2b.
"""

from __future__ import annotations

import numpy as np

from tvts_torch.text.tokenizer import tokenize_openclip


def clip_tokenize_fn(context_length: int = 77):
    """Default text pipeline: CLIP BPE, truncate (the v2 towers)."""

    def fn(texts):
        return {"text_ids": tokenize_openclip(texts, context_length=context_length)}

    return fn


def _cast(a, dtype):
    a = np.asarray(a)
    return a if a.dtype == dtype else a.astype(dtype)


def _numeric(a) -> bool:
    """True for arrays (or nested lists) of bools and numbers."""
    try:
        return np.asarray(a).dtype.kind in "biuf"
    except ValueError:  # a ragged nested list: not one array
        return False


def prepare_batch(batch: dict, context_length: int = 77, tokenize_fn=None) -> dict:
    """Collated loader batch -> numpy arrays for the train step: "video"
    float32, "keep_ind" int32, "text_ids" (clip-major), and "labels" int32
    where the batch has a 2-D "label".

    A batch that already carries "text_ids" (tokenized at collate time) is not
    tokenized again; its arrays are cast as above and its keys that are not
    numbers (strings, meta) dropped. The JAX package returns such a batch as
    it is (trainer.py:68-69), strings and all."""
    if "text_ids" in batch:
        text = {k: np.asarray(v) for k, v in batch.items()
                if k not in ("video", "keep_ind", "label") and _numeric(v)}
    else:
        captions = batch["text"]
        if isinstance(captions, list) and captions and isinstance(captions[0], list):
            flat = [cap for clip_caps in captions for cap in clip_caps]  # clip-major concat
        else:
            flat = list(captions)
        text = (tokenize_fn or clip_tokenize_fn(context_length))(flat)
    out = {"video": _cast(batch["video"], np.float32),
           "keep_ind": _cast(batch["keep_ind"], np.int32)}
    out.update(text)
    if "label" in batch and np.ndim(batch["label"]) == 2:
        out["labels"] = _cast(batch["label"], np.int32)
    return out
