"""Zero-shot action recognition with a prompt classifier (counterpart of
tvts_tpu/eval/zero_recognition.py): per class, embed its prompts, normalise
each, average over the templates and renormalise; logits = 100 * v @ W on
the normalised video embeddings; top-1 and top-5.

Unlike the JAX package, whose classifier always runs the eager text tower,
`use_fused` reaches the text side too (ROADMAP section 3).
"""

from __future__ import annotations

import json

import numpy as np

from tvts_torch.eval.embed import _device, embed_texts, extract_embeddings, make_embed_fns

PROMPT_TEMPLATES = ["a person {}"]


def build_zero_shot_classifier(model, classnames, templates=PROMPT_TEMPLATES,
                               context_length: int = 77, use_fused: bool = False
                               ) -> np.ndarray:
    """[out, n_classes] prompt-averaged normalised text classifier."""
    embed_text, _ = make_embed_fns(model, use_fused=use_fused)
    device = _device(model)
    weights = []
    for name in classnames:
        emb = embed_texts(embed_text, [t.format(name) for t in templates], device,
                          context_length)
        emb = emb / np.linalg.norm(emb, axis=-1, keepdims=True)
        mean = emb.mean(axis=0)
        weights.append(mean / np.linalg.norm(mean))
    return np.stack(weights, axis=1)


def load_label2id(path: str) -> dict:
    """Class name -> id of meta_data/<dataset>/prompt/label2id.json; its keys
    in the file's order are the classifier's columns."""
    with open(path) as f:
        return json.load(f)


def run_recognition(model, loader, classnames, templates=PROMPT_TEMPLATES,
                    context_length: int = 77, use_fused: bool = False) -> dict:
    W = build_zero_shot_classifier(model, classnames, templates, context_length, use_fused)
    out = extract_embeddings(model, loader, with_text=False, context_length=context_length,
                             use_fused=use_fused)
    v = out["video"]
    v = v / np.linalg.norm(v, axis=-1, keepdims=True)
    logits = 100.0 * v @ W
    labels = out["labels"]
    top1 = float(np.mean(np.argmax(logits, axis=1) == labels))
    top5_idx = np.argsort(-logits, axis=1)[:, :5]
    top5 = float(np.mean(np.any(top5_idx == labels[:, None], axis=1)))
    print(f"Top-1 accuracy: {100 * top1:.2f}%  Top-5 accuracy: {100 * top5:.2f}%")
    return {"top1": top1, "top5": top5, "logits": logits}
