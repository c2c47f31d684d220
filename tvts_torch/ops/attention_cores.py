"""H9: the divided space-time attention cores on their own, hand-written in
CUDA C++ for Hopper, beside their plain PyTorch version
(ops/attention.py::divided_space_time_attention).

`divided_space_time_attention_fused` replaces tvts_tpu/ops/pallas_attention.py
::divided_space_time_attention_fused (:107; kernels _space_attention_fused,
:31, and _time_attention_fused, :69): q (pre-scaled), k, v [B, H, S, d] in,
[B, H, S, d] out, S = 1 + T*N; patch queries attend over their frame (space)
or their location's T frames (time) plus the CLS key, and the CLS query over
every token. Forward only, as in the JAX package (`VarAttention(use_pallas=
True)` reaches it in space mode): on the card it raises when autograd would
record q, k or v, as differentiating the Pallas call raises there.

Design: the cores of csrc/attention.cuh that H2 and H1 run on packed qkv rows,
instantiated with strided addressing, so they read q, k and v where they lie
(the head-split views of a [B, S, 3D] qkv product as well as contiguous
[B, H, S, d] tensors: no copy into a packed layout) with a logit scale of 1;
the CLS row is the split-KV kernel of the sub-paths, which the JAX package
leaves to XLA as `full_attention`. Bound on the H100: bytes (q, k, v read and
the output written once; 4 * d flops per (query, key) pair is far below the
tensor-core line at 13 to 257 keys per query).

f32 (as the JAX function takes it): the same CLS row with f32 loads and
arithmetic, and space and time cores of their own. The space core
(csrc/attention.cuh::space_core_f32_kernel) runs the bf16 core's slabs and
tiles on the tensor cores in 3xTF32: each f32 operand, the probabilities
too, split into its TF32 truncation and the remainder, three mma.sync
products a step, so it lies a few 1e-6 * max|ref| from plain f32 where one
TF32 product lies ~1e-3 * max|ref| off; it stages the frame's keys and
values in f32, which bounds N (`space_core_f32_smem`). The time core
(time_core_f32_kernel) is f32 FMA on a persistent grid of warps, each
copying its next (b, n, h) group while it computes the current one, eight
lanes a query row. Bound on the H100: the
space core's three TF32 products and its bytes weigh the same (0.069 ms at
B = 8, N = 196, d = 64; 0.171 ms for the same work in f32 FMA), the time
core's bytes.

Dispatch as in block_kernels: the plain version on a CPU tensor, the kernels
(q, k and v all bf16 or all f32; d 64 or 80; T <= 32 for the time core) on a
CUDA tensor, or raise. `.launches` counts the calls that ran the kernels on
the card, `.f32_launches` those of them in f32, `.f32_time_launches` those
in f32 and time mode.
"""

from __future__ import annotations

import ctypes

import torch

from tvts_torch.ops import block_kernels as bk
from tvts_torch.ops.attention import divided_space_time_attention
from tvts_torch.utils.profiling import spanned

DTYPES = (torch.bfloat16, torch.float32)


def space_core_f32_smem(N: int, d: int) -> int:
    """Shared memory of an f32 space-core block (csrc/attention.cuh): the
    frame's 1 + N key and value rows in f32, padded to a multiple of 8 rows
    and to d + 4 columns."""
    return 2 * (-(-(N + 1) // 8) * 8) * (d + 4) * 4


def space_core_f32_max_patches(d: int) -> int:
    """The largest N whose frame fits an f32 space-core block."""
    return bk.SMEM_OPTIN // (8 * (d + 4)) // 8 * 8 - 1


def _check_space_frame_f32(N: int, d: int) -> None:
    """Raise ValueError when a frame of N patches does not fit an f32
    space-core block. The library's tvts_space_core_f32_fits is the rule the
    launch refuses by; this is its copy, checked before the library loads and
    held equal to it on the card."""
    if space_core_f32_smem(N, d) > bk.SMEM_OPTIN:
        n_max = space_core_f32_max_patches(d)
        raise ValueError(f"{N} patches a frame at head dim {d} in f32: the space core stages a "
                         f"frame's {N + 1} key and value rows in shared memory "
                         f"({space_core_f32_smem(N, d)} bytes); at most {n_max} patches fit the "
                         f"{bk.SMEM_OPTIN} bytes a block may take")


def _cls_fold(t: torch.Tensor, name: str) -> tuple[bool, int]:
    """How the CLS-row kernel (heads at offset h * d of a row) can address
    t [B, H, S, d]: (False, batch stride) when the heads lie side by side
    (the head-split view of [B, S, H*d] rows), or (True, head stride) when
    (batch, head) fold into one batch axis (head-major, e.g. contiguous)."""
    B, H, _, d = t.shape
    bs, hs, _, _ = t.stride()
    if hs == d or H == 1:
        return False, bs
    if bs == H * hs or B == 1:
        return True, hs
    raise ValueError(f"{name}: strides {t.stride()} are neither head-split rows nor head-major; "
                     "pass a contiguous tensor")


@spanned("divided_space_time_attention_fused")
def divided_space_time_attention_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                       num_frames: int, patches_per_frame: int,
                                       mode: str) -> torch.Tensor:
    """H9. q, k, v: [B, H, S, d] with S = 1 + num_frames * patches_per_frame,
    q pre-scaled by 1/sqrt(d). Returns [B, H, S, d] (laid out as q is)."""
    if mode not in ("space", "time"):
        raise ValueError(f"unknown mode {mode!r}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must be all bf16 or all f32, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not bk._dispatch(q):
        return divided_space_time_attention(q, k, v, num_frames, patches_per_frame, mode)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("divided_space_time_attention_fused is forward only: its kernels "
                           "record no graph, so gradients through q, k and v would be dropped. "
                           "Call it under torch.no_grad(), or train without use_pallas")
    B, H, S, d = q.shape
    T, N = num_frames, patches_per_frame
    if S != 1 + T * N:
        raise ValueError(f"token count {S} != 1 + {T}*{N}")
    if d not in (64, 80):
        raise ValueError(f"head dim {d}: the kernels take 64 or 80")
    if mode == "time" and not 1 <= T <= 32:
        raise ValueError(f"{T} frames: the time core takes 1..32")
    f32 = q.dtype == torch.float32
    if mode == "space":
        (_check_space_frame_f32 if f32 else bk._check_space_frame)(N, d)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype or t.shape != q.shape:
            raise TypeError(f"{name}: the kernels take q, k and v of one shape on one card, "
                            f"got {tuple(t.shape)} on {t.device} beside q {tuple(q.shape)} on "
                            f"{q.device}")
        if t.stride(-1) != 1 or t.data_ptr() % 16 or \
                any(s * t.element_size() % 16 for s in t.stride()[:-1]):
            raise ValueError(f"{name}: rows must be contiguous and 16-byte aligned "
                             f"(strides {t.stride()})")
    if k.stride() != v.stride():
        raise ValueError(f"k and v must share strides, got {k.stride()} and {v.stride()}")
    folded, q_bs = _cls_fold(q, "q")
    kv_folded, kv_bs = _cls_fold(k, "k")
    if folded != kv_folded:
        raise ValueError("q and k/v must both be head-split rows or both head-major")
    out = (torch.empty_like(q, memory_format=torch.contiguous_format) if folded
           else torch.empty(B, S, H, d, dtype=q.dtype, device=q.device).transpose(1, 2))
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out) for s in t.stride()[:3]))
    lib = bk.library()
    with torch.cuda.device(q.device):
        bk._check(lib, lib.tvts_attention_core_strided(
            bk._ptr(q), bk._ptr(k), bk._ptr(v), bk._ptr(out), strides, B, T, N, H, d, 1.0,
            int(mode == "space"), int(f32), bk._stream(q)))
        # the CLS query over every token (full_attention in the JAX package)
        _, o_bs = _cls_fold(out, "out")
        bk._cls_row(lib, q, q_bs, k, v, kv_bs, k.stride(2), S, out, o_bs,
                    1 if folded else H, d, scale=1.0, batch=B * H if folded else B)
    divided_space_time_attention_fused.launches += 1
    divided_space_time_attention_fused.f32_launches += f32
    divided_space_time_attention_fused.f32_time_launches += f32 and mode == "time"
    return out


divided_space_time_attention_fused.launches = 0
divided_space_time_attention_fused.f32_launches = 0
divided_space_time_attention_fused.f32_time_launches = 0
