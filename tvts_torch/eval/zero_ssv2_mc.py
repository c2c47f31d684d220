"""SSV2 multiple-choice zero-shot eval (counterpart of
tvts_tpu/eval/zero_ssv2_mc.py): per video, embed its candidate texts as one
text batch, score them against the normalised video embedding, argmax vs the
answer index.

Unlike the JAX package, which always runs the eager towers here, `use_fused`
reaches both towers (ROADMAP section 3).
"""

from __future__ import annotations

import numpy as np
import torch

from tvts_torch.eval.embed import _device, _pad_to, embed_texts, make_embed_fns


def run_ssv2_mc(model, loader, context_length: int = 77, use_fused: bool = False) -> dict:
    """batch['text'] is option-major: [n_options][batch]."""
    embed_text, embed_video = make_embed_fns(model, use_fused=use_fused)
    device = _device(model)
    batch_size = loader.batch_size

    correct, total = 0, 0
    for batch in loader:
        n = batch["video"].shape[0]
        video = _pad_to(np.asarray(batch["video"], np.float32), batch_size)
        keep = _pad_to(np.asarray(batch["keep_ind"], np.int64), batch_size)
        v = embed_video(torch.from_numpy(video).to(device),
                        torch.from_numpy(keep).to(device)).float().cpu().numpy()[:n]
        v = v / np.linalg.norm(v, axis=-1, keepdims=True)
        labels = np.asarray(batch["label"])[:n]
        for b in range(n):
            options = [opts[b] for opts in batch["text"]]
            t = embed_texts(embed_text, options, device, context_length)
            t = t / np.linalg.norm(t, axis=-1, keepdims=True)
            correct += int(int(np.argmax(t @ v[b])) == labels[b])
            total += 1
    acc = correct / max(total, 1)
    print(f"SSV2-MC accuracy: {100 * acc:.2f}% ({correct}/{total})")
    return {"accuracy": acc, "correct": correct, "total": total}
