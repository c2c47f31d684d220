"""The four sub-path kernels of the B/16 extraction tower, hand-written in CUDA
C++ for Hopper (sources in tvts_torch/csrc/), each beside its plain PyTorch
version; and the build and load of the one kernel library, which also carries
the text-attention kernel of ops/text_attention.py and the training backward
kernels of ops/block_backward.py.

Layout: tokens [B, S, D] with S = 1 + T*N, CLS first, frame-major patches
(the JAX kernels' d-major xT is ``x[:, 1:].reshape(B, T, N, D).swapaxes(-1,
-2)``). Weights in the nn.Linear layout [out, in], biases in the activation
dtype, LayerNorm parameters float32.

Dispatch: on a CPU tensor a wrapper runs the plain version; on a CUDA tensor
it launches the kernel (bf16 only; d in {64, 80}, T <= 32, any N) or raises.
There is no fallback. `<wrapper>.launches` counts wrapper calls that ran the
kernel on the card: one per sub-path, however many CUDA launches it takes.

Kernel notes (replaces / bound on the card / design):
- fused_time_block replaces tvts_tpu/ops/pallas_block_attention.py::
  fused_time_attention_block_v7 (:2456). Bound by the qkv and proj products
  (2*S*D*4D flops per clip); the core is T+1 = 13 keys per query, too small
  for the tensor cores. Design: ln_gemm (LN_3 prologue) -> qkv rows; one
  warp per (b, n, h) with lane t owning query t for the core; split-KV CLS
  row; ln_gemm proj with the residual x in its epilogue.
- fused_space_block replaces fused_space_attention_block_v9 (:2964). Bound
  by the same two products; the core (N queries over 1 + N keys per frame)
  runs flash-style on the tensor cores with an online f32 softmax over
  64-key tiles, the CLS key being key 0. The proj epilogue adds `base`, the
  block input (not the time output).
- fused_mlp_block replaces fused_mlp_block_v7 (:2604). Bound by the two
  products (16*S*D^2 flops per clip). Design: ln_gemm with the LN_2
  prologue and the activation epilogue, then ln_gemm with the residual.
- fused_space_cls_only replaces fused_space_cls_only_v7 (:3339). Bound by
  the k/v product over every token (the per-frame queries are dead). Design:
  ln_gemm for k/v of all rows and for q of the CLS rows only, split-KV CLS
  row, ln_gemm proj with the residual basecls.
The CLS global row: the TPU kernels carry the online-softmax state across
sequential grid steps; CUDA blocks run in no order, so each block writes a
partial (m, l, acc) for its chunk of keys and a second kernel combines them
in a fixed order (deterministic, no atomics). Softmax is exact everywhere:
the max-free `smv="cp"` clamp of the TPU kernels is not carried over.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from tvts_torch.models.layers import layer_norm_f32, linear, mlp, var_attention
from tvts_torch.ops.attention import full_attention, merge_heads, split_heads

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "--use_fast_math", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
ACTS = {"none": 0, "quick_gelu": 1, "gelu": 2}
LN_EPS = 1e-5


# ---------------------------------------------------------------------------
# build + load
# ---------------------------------------------------------------------------
def _nvcc() -> str:
    """$CUDA_HOME/bin/nvcc, else nvcc on PATH, else the toolkit's default place."""
    cuda_home = os.environ.get("CUDA_HOME")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    for cand in candidates + [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build() -> tuple[Path, str]:
    """Compile csrc/*.cu into tvts_torch/_build/ unless a library built from
    the same sources and flags is there. Returns (library path, compiler
    output, which holds the `-Xptxas -v` register and shared-memory lines)."""
    sources = sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))
    digest = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode() + src.read_bytes())
    stem = f"libtvts_kernels_{digest.hexdigest()[:16]}"
    so, log = _BUILD / f"{stem}.so", _BUILD / f"{stem}.log"
    if so.exists() and log.exists():
        return so, log.read_text()
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = _BUILD / f"{stem}.{os.getpid()}.tmp.so"
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_CSRC / "block_kernels.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    log.write_text(proc.stdout + proc.stderr)
    os.replace(tmp, so)  # atomic: a concurrent build never loads a partial file
    return so, log.read_text()


@functools.cache
def library() -> ctypes.CDLL:
    so, _ = build()
    lib = ctypes.CDLL(str(so))
    p, i, i64, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.tvts_error_string.argtypes = [i]
    lib.tvts_error_string.restype = ctypes.c_char_p
    argtypes = {
        "tvts_ln_gemm": [p, i64, p, p, f, p, p, p, p, i64, p, p, i64, i, i, i, i, p],
        "tvts_time_core": [p, p, p, i, i, i, i, i, f, p],
        "tvts_space_core": [p, p, p, i, i, i, i, i, f, p],
        "tvts_cls_attention": [p, i64, p, p, i64, i64, i, p, i64, p, p, i, i, i, f, p],
        "tvts_text_core": [p, p, p, i, i, i, i, f, i, p],
        # training backward
        "tvts_wgrad": [p, i64, p, i64, p, p, p, p, p, i, i, i, i, i, p],
        "tvts_reduce": [p, i, i64, p, p, p],
        "tvts_ln_bwd": [p, p, p, p, p, p, p, p, i, i, i, i, p],
        "tvts_attn_delta": [p, p, i, i, i, i, p, p],
        "tvts_flash_bwd": [p, p, p, p, p, p, i, i, i, i, i, i, f, i, i, p],
        "tvts_time_bwd": [p, p, p, p, p, p, i, i, i, i, i, f, p],
        "tvts_cls_grad_combine": [p, i, i, i, i, i64, p, p],
    }
    for name, types in argtypes.items():
        fn = getattr(lib, name)
        fn.argtypes = types
        fn.restype = i
    return lib


def _check(lib: ctypes.CDLL, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel launch failed: "
                           f"{lib.tvts_error_string(err).decode()} ({err})")


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _ln_gemm(lib, x, rows, lda, ln, w, b, out, act="none", res=None, ldres=0,
             eps=LN_EPS):
    """out = act(LN?(x rows at stride lda) @ w.T + b) (+ res), on the card;
    `eps` is the LayerNorm's (1e-5 in the towers, 1e-6 in the sort head). An
    f32 `out` takes the f32 store. Returns the LayerNorm row statistics
    ([rows, 2] f32: mean, rstd) or None."""
    stats = torch.empty(rows, 2, dtype=torch.float32, device=x.device) if ln else None
    ln_w, ln_b = ln if ln else (None, None)
    f32 = out.dtype == torch.float32
    _check(lib, lib.tvts_ln_gemm(
        _ptr(x), lda, _ptr(ln_w), _ptr(ln_b), eps, _ptr(stats), _ptr(w), _ptr(b),
        _ptr(res), ldres, None if f32 else _ptr(out), _ptr(out) if f32 else None,
        out.shape[-1], rows, w.shape[0], w.shape[1], ACTS[act], _stream(x)))
    return stats


def _cls_row(lib, q, q_bstride, k, v, kv_bstride, kv_rstride, n_keys, out, out_bstride,
             num_heads, head_dim, lse=None):
    """Split-KV CLS global row: out[b] = softmax(q[b] k[b]^T / sqrt(d)) v[b];
    with `lse` [B, H, n_keys] the row's log-sum-exp goes to lse[:, :, 0]."""
    B = q.shape[0]
    n_chunks = -(-n_keys // 128)
    partial = torch.empty(B, num_heads, n_chunks, head_dim + 2, dtype=torch.float32,
                          device=q.device)
    _check(lib, lib.tvts_cls_attention(
        _ptr(q), q_bstride, _ptr(k), _ptr(v), kv_bstride, kv_rstride, n_keys, _ptr(out),
        out_bstride, _ptr(partial), _ptr(lse), B, num_heads, head_dim, head_dim ** -0.5,
        _stream(q)))


# ---------------------------------------------------------------------------
# argument checks
# ---------------------------------------------------------------------------
def _patches_per_frame(S: int, T: int) -> int:
    if T < 1 or (S - 1) % T:
        raise ValueError(f"token count {S} is not 1 + {T} * N")
    return (S - 1) // T


def _dispatch(x: torch.Tensor) -> bool:
    """True for the kernel (CUDA tensor), False for the plain version (CPU)."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return True


def _expect(name: str, t: torch.Tensor, x: torch.Tensor, dtype: torch.dtype,
            shape: tuple[int, ...]) -> None:
    if t.device != x.device:
        raise ValueError(f"{name} on {t.device}, activations on {x.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _check_geometry(D: int, num_heads: int, T: int) -> int:
    if D % num_heads:
        raise ValueError(f"width {D} not divisible by {num_heads} heads")
    d = D // num_heads
    if d not in (64, 80):
        raise ValueError(f"head dim {d}: the kernels take 64 or 80")
    if not 1 <= T <= 32:
        raise ValueError(f"{T} frames: the kernels take 1..32")
    if D % 32:
        raise ValueError(f"width {D}: the kernels take a multiple of 32")
    return d


def _check_attention_args(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, T, num_heads):
    B, S, D = x.shape
    d = _check_geometry(D, num_heads, T)
    bf = torch.bfloat16
    _expect("x", x, x, bf, (B, S, D))
    _expect("ln_w", ln_w, x, torch.float32, (D,))
    _expect("ln_b", ln_b, x, torch.float32, (D,))
    _expect("wqkv", wqkv, x, bf, (3 * D, D))
    _expect("bqkv", bqkv, x, bf, (3 * D,))
    _expect("wproj", wproj, x, bf, (D, D))
    _expect("bproj", bproj, x, bf, (D,))
    return d


# ---------------------------------------------------------------------------
# H1: time sub-path
# ---------------------------------------------------------------------------
def time_block_plain(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, num_frames, num_heads):
    """x + Proj(TimeAttn(LN_3(x))), CLS row global."""
    N = _patches_per_frame(x.shape[1], num_frames)
    return x + var_attention(layer_norm_f32(x, ln_w, ln_b), wqkv, bqkv, wproj, bproj,
                             num_frames, N, "time", num_heads)


def _attention_sub_path(core: str, x, res, ln_w, ln_b, wqkv, bqkv, wproj, bproj,
                        num_frames, num_heads, save: bool = False):
    """res + Proj(Attn(LN(x))) on the card: ln_gemm qkv rows -> `core` on the
    patch rows -> split-KV CLS row -> ln_gemm proj with the residual.

    save=True (training forward) also returns what the backward needs:
    (out, qkv [B, S, 3D], attn [B, S, D] (pre-projection), lse [B, H, S] f32
    (the per-row log-sum-exp; row 0 the CLS row), LN row stats [B*S, 2] f32)."""
    B, S, D = x.shape
    N = _patches_per_frame(S, num_frames)
    d = _check_attention_args(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, num_frames,
                              num_heads)
    _expect("residual", res, x, x.dtype, (B, S, D))
    lib = library()
    with torch.cuda.device(x.device):
        qkv = torch.empty(B, S, 3 * D, dtype=x.dtype, device=x.device)
        stats = _ln_gemm(lib, x, B * S, D, (ln_w, ln_b), wqkv, bqkv, qkv)
        attn = torch.empty_like(x)
        lse = (torch.empty(B, num_heads, S, dtype=torch.float32, device=x.device)
               if save else None)
        _check(lib, getattr(lib, core)(_ptr(qkv), _ptr(attn), _ptr(lse), B, num_frames, N,
                                       num_heads, d, d ** -0.5, _stream(x)))
        _cls_row(lib, qkv, S * 3 * D, qkv[..., D:], qkv[..., 2 * D:], S * 3 * D, 3 * D, S,
                 attn, S * D, num_heads, d, lse=lse)
        out = torch.empty_like(x)
        _ln_gemm(lib, attn, B * S, D, None, wproj, bproj, out, res=res, ldres=D)
    return (out, qkv, attn, lse, stats) if save else out


def fused_time_block(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, num_frames: int,
                     num_heads: int) -> torch.Tensor:
    """H1. x: [B, S, D] -> x + Proj(TimeAttn(LN_3(x))) [B, S, D]."""
    if not _dispatch(x):
        return time_block_plain(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, num_frames,
                                num_heads)
    out = _attention_sub_path("tvts_time_core", x, x, ln_w, ln_b, wqkv, bqkv, wproj,
                              bproj, num_frames, num_heads)
    fused_time_block.launches += 1
    return out


# ---------------------------------------------------------------------------
# H2: space sub-path
# ---------------------------------------------------------------------------
def space_block_plain(x, base, ln_w, ln_b, wqkv, bqkv, wproj, bproj, num_frames,
                      num_heads):
    """base + Proj(SpaceAttn(LN_1(x))): x the time output, base the block input."""
    N = _patches_per_frame(x.shape[1], num_frames)
    return base + var_attention(layer_norm_f32(x, ln_w, ln_b), wqkv, bqkv, wproj, bproj,
                                num_frames, N, "space", num_heads)


def fused_space_block(x, base, ln_w, ln_b, wqkv, bqkv, wproj, bproj, num_frames: int,
                      num_heads: int) -> torch.Tensor:
    """H2. x (time output), base (block input): [B, S, D] -> [B, S, D]."""
    if not _dispatch(x):
        return space_block_plain(x, base, ln_w, ln_b, wqkv, bqkv, wproj, bproj,
                                 num_frames, num_heads)
    out = _attention_sub_path("tvts_space_core", x, base, ln_w, ln_b, wqkv, bqkv, wproj,
                              bproj, num_frames, num_heads)
    fused_space_block.launches += 1
    return out


# ---------------------------------------------------------------------------
# H3: MLP sub-path
# ---------------------------------------------------------------------------
def mlp_block_plain(x, ln_w, ln_b, wfc, bfc, wproj, bproj, act):
    """x + c_proj(act(c_fc(LN_2(x))))."""
    return x + mlp(layer_norm_f32(x, ln_w, ln_b), wfc, bfc, wproj, bproj, act)


def fused_mlp_block(x, ln_w, ln_b, wfc, bfc, wproj, bproj,
                    act: str = "quick_gelu") -> torch.Tensor:
    """H3. x: [B, S, D] -> x + c_proj(act(c_fc(LN_2(x))))."""
    if act not in ("quick_gelu", "gelu"):
        raise ValueError(f"unknown activation {act!r}")
    if not _dispatch(x):
        return mlp_block_plain(x, ln_w, ln_b, wfc, bfc, wproj, bproj, act)
    B, S, D = x.shape
    hidden = wfc.shape[0]
    if D % 32 or hidden % 32:
        raise ValueError(f"width {D} / hidden {hidden}: the kernels take multiples of 32")
    bf = torch.bfloat16
    _expect("x", x, x, bf, (B, S, D))
    _expect("ln_w", ln_w, x, torch.float32, (D,))
    _expect("ln_b", ln_b, x, torch.float32, (D,))
    _expect("wfc", wfc, x, bf, (hidden, D))
    _expect("bfc", bfc, x, bf, (hidden,))
    _expect("wproj", wproj, x, bf, (D, hidden))
    _expect("bproj", bproj, x, bf, (D,))
    lib = library()
    with torch.cuda.device(x.device):
        h = torch.empty(B, S, hidden, dtype=x.dtype, device=x.device)
        _ln_gemm(lib, x, B * S, D, (ln_w, ln_b), wfc, bfc, h, act=act)
        out = torch.empty_like(x)
        _ln_gemm(lib, h, B * S, hidden, None, wproj, bproj, out, res=x, ldres=D)
    fused_mlp_block.launches += 1
    return out


# ---------------------------------------------------------------------------
# H4: CLS-only space tail
# ---------------------------------------------------------------------------
def space_cls_only_plain(x, basecls, ln_w, ln_b, wqkv, bqkv, wproj, bproj, num_frames,
                         num_heads):
    """Row 0 of space_block_plain(x, base, ...) with basecls = base[:, :1]."""
    _patches_per_frame(x.shape[1], num_frames)
    D = x.shape[-1]
    d = D // num_heads
    y = layer_norm_f32(x, ln_w, ln_b)
    k, v = linear(y, wqkv[D:], bqkv[D:]).chunk(2, dim=-1)
    q = linear(y[:, :1], wqkv[:D], bqkv[:D]) * d ** -0.5
    att = full_attention(split_heads(q, num_heads), split_heads(k, num_heads),
                         split_heads(v, num_heads))
    return basecls + linear(merge_heads(att), wproj, bproj)


def fused_space_cls_only(x, basecls, ln_w, ln_b, wqkv, bqkv, wproj, bproj,
                         num_frames: int, num_heads: int) -> torch.Tensor:
    """H4. x (time output) [B, S, D], basecls (block input CLS) [B, 1, D] ->
    the CLS row of H2 [B, 1, D]; the per-frame outputs are never computed."""
    B, S, D = x.shape
    if not _dispatch(x):
        return space_cls_only_plain(x, basecls, ln_w, ln_b, wqkv, bqkv, wproj, bproj,
                                    num_frames, num_heads)
    _patches_per_frame(S, num_frames)
    d = _check_attention_args(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, num_frames,
                              num_heads)
    _expect("basecls", basecls, x, x.dtype, (B, 1, D))
    lib = library()
    with torch.cuda.device(x.device):
        kv = torch.empty(B, S, 2 * D, dtype=x.dtype, device=x.device)
        _ln_gemm(lib, x, B * S, D, (ln_w, ln_b), wqkv[D:], bqkv[D:], kv)
        q = torch.empty(B, D, dtype=x.dtype, device=x.device)
        _ln_gemm(lib, x, B, S * D, (ln_w, ln_b), wqkv[:D], bqkv[:D], q)  # CLS rows only
        att = torch.empty(B, D, dtype=x.dtype, device=x.device)
        _cls_row(lib, q, D, kv, kv[..., D:], S * 2 * D, 2 * D, S, att, D, num_heads, d)
        out = torch.empty_like(basecls)
        _ln_gemm(lib, att, B, D, None, wproj, bproj, out, res=basecls, ldres=D)
    fused_space_cls_only.launches += 1
    return out


KERNELS = (fused_time_block, fused_space_block, fused_mlp_block, fused_space_cls_only)
for _fn in KERNELS:
    _fn.launches = 0


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in KERNELS}
