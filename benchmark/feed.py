"""Inputs drawn on the device from a generator seeded with the run's seed:
normalised clips, caption token ids and tube keep sets. The same seed gives
the same inputs; the program receives only these tensors.

Caption ids follow the CLIP tokenizer's layout: the start token 49406, ids
of words below it, the end token 49407 (the largest id, which the text
towers pool at), zeros after; each caption's length (with both marks) is
drawn from `caption_tokens`, and a `truncated_share` of them fill the whole
context, as a long caption cut at the context length does.
"""

from __future__ import annotations

import torch

SOT, EOT = 49406, 49407
FEED_SEED_OFFSET = 1_000_003  # the inputs' generator is not the weights' one


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed + FEED_SEED_OFFSET)


def clips(gen: torch.Generator, n_batches: int, batch: int, vision: dict, device) -> torch.Tensor:
    """[n_batches, batch, T, 3, R, R] float32 N(0, 1) clips."""
    R = vision["input_resolution"]
    return torch.randn(n_batches, batch, vision["num_frames"], 3, R, R, generator=gen,
                       device=device)


def caption_ids(gen: torch.Generator, n: int, context: int, lengths: tuple,
                truncated_share: float, device) -> torch.Tensor:
    """[n, context] int64 caption ids (module notes)."""
    lo, hi = lengths
    length = torch.randint(lo, hi + 1, (n,), generator=gen, device=device)
    cut = torch.rand(n, generator=gen, device=device) < truncated_share
    length = torch.where(cut, torch.full_like(length, context), length.clamp_max(context))
    words = torch.randint(1, SOT, (n, context), generator=gen, device=device)
    pos = torch.arange(context, device=device)[None]
    ids = torch.where(pos < length[:, None] - 1, words, torch.zeros_like(words))
    ids[:, 0] = SOT
    ids.scatter_(1, (length - 1)[:, None], EOT)
    return ids


def keep_sets(gen: torch.Generator, batch: int, patches: int, n_keep: int, device) -> torch.Tensor:
    """[batch, n_keep] int64: the first n_keep of a random permutation of a
    frame's patches, a fresh one a clip."""
    order = torch.rand(batch, patches, generator=gen, device=device).argsort(dim=1)
    return order[:, :n_keep].contiguous()
