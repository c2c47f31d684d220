"""Sub-path ranges from the benchmark's side, for `kernel_roofline`.

While `subpath_ranges()` is open, each sub-path entry of the program that
the kernel paths call (the extraction tower's H1-H4, the training
forwards of H5, H6, H8 and H7, and the backwards of their autograd
Functions) runs inside a torch.profiler range of its own,
"bench::<sub-path>#<n>", and the call's bound (benchmark/flops.py, from the
call's shapes) is listed beside the range's name. The program is left as it
was when the context closes. Where the program no longer has an entry point
named here, `resolve()` raises: the yardstick never shrinks unseen. A cell's
traffic mix lists under "subpaths" the entries its path calls, and
`kernel_roofline` reads nothing where one of them recorded no call.
"""

from __future__ import annotations

import contextlib
import importlib
import itertools

import torch

from benchmark import flops


def _video_dims(x, num_frames: int):
    B, S, D = x.shape
    return B, num_frames, (S - 1) // num_frames, D


def _attention(kind: str, saving: bool):
    def work(x, *args):
        T, H = args[-2], args[-1]
        B, T, N, D = _video_dims(x, T)
        if saving:
            return flops.saving_forward_work(kind, B, T, N, D, H)
        return flops.attention_work(kind, B, T, N, D, H, backward=False)
    return work


def _inference(kind: str):
    def work(x, *args, num_frames, num_heads, **_):
        B, T, N, D = _video_dims(x, num_frames)
        return flops.attention_work(kind, B, T, N, D, num_heads, backward=False)
    return work


def _mlp_inference(x, ln_w, ln_b, wfc, *args, **_):
    B, S, D = x.shape
    return flops.mlp_work(B * S, D, False, False, wfc.shape[0])


def _cls_only(x, basecls, *args, num_frames, num_heads, **_):
    B, S, D = x.shape
    return flops.cls_only_work(B, S, D, num_heads)


def _mlp_train(x, ln_w, ln_b, wfc, bfc, wproj, bproj, act="quick_gelu", save_hidden=False):
    B, S, D = x.shape
    return flops.mlp_work(B * S, D, False, save_hidden, wfc.shape[0])


def _text_train(x, *args, num_heads, causal=True, **_):
    B, S, D = x.shape
    return flops.text_work(B, S, D, num_heads, causal, backward=False)


# (module, attribute, work of a call from its arguments)
FORWARD = (
    ("tvts_torch.ops.fused_forward", "fused_time_block", _inference("time")),
    ("tvts_torch.ops.fused_forward", "fused_space_block", _inference("space")),
    ("tvts_torch.ops.fused_forward", "fused_mlp_block", _mlp_inference),
    ("tvts_torch.ops.fused_forward", "fused_space_cls_only", _cls_only),
    ("tvts_torch.ops.fused_forward", "time_subpath", _attention("time", saving=True)),
    ("tvts_torch.ops.fused_forward", "space_subpath", _attention("space", saving=True)),
    ("tvts_torch.ops.fused_forward", "mlp_subpath", _mlp_train),
    ("tvts_torch.ops.text_attention", "text_subpath", _text_train),
)


def _backward_work(kind: str):
    def work(ctx, g):
        B, S, D = g.shape
        if kind in ("time", "space"):
            T, H = ctx.geometry
            return flops.attention_work(kind, B, T, (S - 1) // T, D, H, backward=True)
        if kind == "mlp":
            saved = ctx.saved_tensors
            return flops.mlp_work(B * S, D, True, len(saved) > 8, saved[3].shape[0])
        H, causal, _, frozen = ctx.config
        return flops.text_work(B, S, D, H, causal, backward=True, frozen=frozen)
    return work


# (module, autograd Function, work of its backward from (ctx, g))
BACKWARD = (
    ("tvts_torch.ops.block_backward", "_TimeSubpath", _backward_work("time")),
    ("tvts_torch.ops.block_backward", "_SpaceSubpath", _backward_work("space")),
    ("tvts_torch.ops.block_backward", "_MlpSubpath", _backward_work("mlp")),
    ("tvts_torch.ops.text_attention", "_TextSubpath", _backward_work("text")),
)


def resolve() -> list:
    """(owner, attribute, original, range name, work) of every entry in
    FORWARD and BACKWARD; raises LookupError naming those the program lacks."""
    out, missing = [], []
    for module_name, attr, work in FORWARD:
        module = importlib.import_module(module_name)
        fn = getattr(module, attr, None)
        if fn is None:
            missing.append(f"{module_name}.{attr}")
        else:
            out.append((module, attr, fn, attr, work))
    for module_name, cls_name, work in BACKWARD:
        cls = getattr(importlib.import_module(module_name), cls_name, None)
        backward = None if cls is None else cls.__dict__.get("backward")
        if backward is None:
            missing.append(f"{module_name}.{cls_name}.backward")
        else:
            out.append((cls, "backward", backward, f"{cls_name}.backward", work))
    if missing:
        raise LookupError(f"sub-path entries the benchmark times are gone: {missing}")
    return out


def entry_names() -> list[str]:
    """The range names of every entry, as a mix's "subpaths" lists them."""
    return [attr for _, attr, _ in FORWARD] + [f"{cls}.backward" for _, cls, _ in BACKWARD]


@contextlib.contextmanager
def subpath_ranges():
    """Yields the list of (range name, bound ms) that the calls made while
    open fill in (module notes)."""
    calls: list = []
    counter = itertools.count()
    undo = []

    def ranged(name, fn, work):
        def call(*args, **kwargs):
            label = f"bench::{name}#{next(counter)}"
            calls.append((label, flops.bound_ms(*work(*args, **kwargs))))
            with torch.profiler.record_function(label):
                return fn(*args, **kwargs)
        return call

    entries = resolve()
    try:
        for owner, attr, original, name, work in entries:
            if attr == "backward":
                owner.backward = staticmethod(ranged(name, original.__func__, work))
            else:
                setattr(owner, attr, ranged(name, original, work))
            undo.append((owner, attr, original))
        yield calls
    finally:
        for owner, attr, original in reversed(undo):
            setattr(owner, attr, original)
