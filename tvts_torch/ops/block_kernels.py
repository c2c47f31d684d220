"""The four sub-path kernels of the B/16 extraction tower, hand-written in CUDA
C++ for Hopper (sources in tvts_torch/csrc/), each beside its plain PyTorch
version; and the build and load of the one kernel library, which also carries
the text-attention kernels of ops/text_attention.py and the training backward
kernels of ops/block_backward.py.

Layout: tokens [B, S, D] with S = 1 + T*N, CLS first, frame-major patches
(the JAX kernels' d-major xT is ``x[:, 1:].reshape(B, T, N, D).swapaxes(-1,
-2)``). Weights in the nn.Linear layout [out, in], biases in the activation
dtype, LayerNorm parameters float32.

Dispatch: on a CPU tensor a wrapper runs the plain version; on a CUDA tensor
it launches the kernel (bf16 only; d in {64, 80}, T <= 32; N up to what the
space core's shared memory holds: 783 at d = 64, 639 at d = 80) or raises.
There is no fallback. `<wrapper>.launches` counts wrapper calls that ran the
kernel on the card: one per sub-path, however many CUDA launches it takes;
`ln_rows.launches` one per LayerNorm row pass, the one inside each LayerNorm
product included.

Kernel notes (replaces / bound on the card / design):
- ln_gemm (csrc/ln_gemm.cuh) carries every product below: bound by the
  tensor cores. Persistent: min(tiles, SMs) blocks, each walking 128 x 256
  output tiles; TMA loads into a 3-stage mbarrier ring fed by one producer
  warp across tile boundaries, two consumer warpgroups on wgmma m64n256k16
  with both operands in shared memory, the epilogue written from the
  accumulators into a buffer of its own, from which a storer warp stores it
  by TMA (and into which it brings the residual by TMA) while the next
  tile's mainloop runs. `gemm_plan` checks what it takes (K a multiple of
  64, 16-byte strides and addresses) before every launch.
- ln_rows, the LayerNorm row pass before every LayerNorm product (the TPU
  kernels' LN_3 / LN_1 / LN_2 prologues on VMEM-resident x): bound by its
  bytes (x read once, LN(x) written once in bf16). One warp a row, held in
  registers; f32 two-pass statistics kept for the training backward, and
  LN(x) in bf16 into a scratch that the product reads as its A operand, so
  each row is normalised once and not once for every 256-column tile of the
  product (as the first design's in-ring prologue did; ln_gemm.cuh's notes).
  `ln_rows_plan` checks what it takes (K a multiple of 8 up to
  LN_ROWS_MAX_K, 16-byte strides and addresses).
- fused_time_block replaces tvts_tpu/ops/pallas_block_attention.py::
  fused_time_attention_block_v7 (:2456). Bound by the qkv and proj products
  (2*S*D*4D flops per clip); the core (T+1 = 13 keys per query) is bound by
  its bytes. Design: ln_rows (LN_3) -> ln_gemm qkv rows; the time core, one
  block per (b, n, group of at most 128 / T heads), the group's q, k and v
  read once into shared memory in 16-byte cp.async copies, one thread per
  query row (the first version's order of operations); split-KV CLS row;
  ln_gemm proj with the residual x in its epilogue.
- fused_space_block replaces fused_space_attention_block_v9 (:2964). Bound
  by the same two products; the core (N queries over 1 + N keys per frame)
  is bound by its bytes. Design: ln_rows (LN_1) -> ln_gemm qkv rows; the
  space core, one block per (b, t, h) staging the frame's 1 + N key and
  value rows in shared memory once (cp.async, a group per 64-key tile),
  every 16-row query slab walking them on mma.sync with an online f32
  softmax over 64-key tiles (the CLS key being key 0; only the 16-key
  chunks holding a live key run). The
  CLS query rides along as one more query row of each frame's block, which
  writes an f32 partial (m, l, acc) of its frame, its P V summed in f32 as
  the TPU kernel does (by a warp with a slab fewer); a combine kernel merges
  the T partials in a fixed order (`space_core`). The proj epilogue adds `base`,
  the block input (not the time output).
- fused_mlp_block replaces fused_mlp_block_v7 (:2604). Bound by the two
  products (16*S*D^2 flops per clip). Design: ln_rows (LN_2) -> ln_gemm
  with the activation epilogue, then ln_gemm with the residual.
- fused_space_cls_only replaces fused_space_cls_only_v7 (:3339). The
  per-frame queries are dead and k, v are linear in y = LN(x), so the CLS
  row is computed from x alone: u_h = Wk_h^T q_h / sqrt(d), logits y_j . u_h,
  z_h = sum_j p_hj y_j, att_h = Wv_h z_h + bv_h (csrc/cls_pool.cuh). Bound by
  its bytes: x read once. Design: a matvec kernel for q (LayerNorm of the
  CLS rows) and one for u; one pass over x in row chunks (LayerNorm, logits
  and P^T Y on mma.sync, an online softmax per head), f32 partials merged in
  a fixed order; matvec kernels for att and for proj with the residual
  basecls. No k or v is ever formed.
The CLS global row of H1 (and H9): the TPU kernels carry the online-softmax
state across sequential grid steps; CUDA blocks run in no order, so each
block writes a partial (m, l, acc) for its chunk of keys and a second kernel
combines them in a fixed order (deterministic, no atomics). Softmax is exact
everywhere: the max-free `smv="cp"` clamp of the TPU kernels is not carried
over.
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
from tvts_torch.utils.profiling import describe, spanned

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "--use_fast_math", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
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


def _units() -> list[tuple[str, list[str]]]:
    """(source, defines) of each translation unit: block_kernels.cu,
    weight_grad.cu, and ln_gemm.cu once for each GEMM variant that ln_gemm.cuh
    lists."""
    header = (_CSRC / "ln_gemm.cuh").read_text()
    n = sum(line.startswith("#define TVTS_GEMM_VARIANT_") for line in header.splitlines())
    return [("block_kernels.cu", []), ("weight_grad.cu", [])] + [
        ("ln_gemm.cu", [f"-DTVTS_GEMM_PART={i}"]) for i in range(n)]


def build() -> tuple[Path, str]:
    """Compile csrc/ into tvts_torch/_build/ unless a library built from the
    same sources and flags is there: every translation unit in its own nvcc,
    all at once, then one link. Returns (library path, compiler output, which
    holds the `-Xptxas -v` register and shared-memory lines)."""
    sources = sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))
    units = _units()
    digest = hashlib.sha256(" ".join(_NVCC_FLAGS).encode() + repr(units).encode())
    for src in sources:
        digest.update(src.name.encode() + src.read_bytes())
    stem = f"libtvts_kernels_{digest.hexdigest()[:16]}"
    so, log = _BUILD / f"{stem}.so", _BUILD / f"{stem}.log"
    if so.exists() and log.exists():
        return so, log.read_text()
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = _BUILD / f"{stem}.{os.getpid()}"  # per process: a concurrent build never collides
    objs = [Path(f"{tmp}.{i}.o") for i in range(len(units))]
    procs = [subprocess.Popen([_nvcc(), *_NVCC_FLAGS, *defines, "-c", "-o", str(obj),
                               str(_CSRC / src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for (src, defines), obj in zip(units, objs)]
    outputs = [proc.communicate()[0] for proc in procs]
    failed = [(unit, out) for unit, proc, out in zip(units, procs, outputs) if proc.returncode]
    if not failed:
        link = subprocess.run([_nvcc(), *_NVCC_FLAGS[:2], "-shared", "-o", f"{tmp}.so",
                               *map(str, objs)], capture_output=True, text=True)
        if link.returncode:
            failed = [("link", link.stdout + link.stderr)]
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(f"{unit}: {out}" for unit, out in failed))
    log.write_text("".join(outputs))
    os.replace(f"{tmp}.so", so)  # atomic: a concurrent build never loads a partial file
    return so, log.read_text()


@functools.cache
def library() -> ctypes.CDLL:
    so, _ = build()
    lib = ctypes.CDLL(str(so))
    p, i, i64, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.tvts_error_string.argtypes = [i]
    lib.tvts_error_string.restype = ctypes.c_char_p
    argtypes = {
        "tvts_ln_gemm": [p, i64, p, p, f, p, p, p, p, p, i64, p, p, i64, i, i, i, i, p, p, i, i,
                         p],
        "tvts_ln_rows": [p, i64, i, i, p, p, f, p, p, p],
        "tvts_time_core": [p, p, p, i, i, i, i, i, f, p],
        "tvts_space_core": [p, p, p, p, i, i, i, i, i, f, p],
        "tvts_cls_only": [p, i, i, i, i, p, p, f, p, p, p, p, p, p, p, p, p, p, p, i, i,
                          p],
        "tvts_attention_core_strided": [p, p, p, p, ctypes.POINTER(i64), i, i, i, i, i, f, i, i,
                                        p],
        "tvts_space_core_f32_fits": [i, i],
        "tvts_cls_attention": [p, i64, p, p, i64, i64, i, p, i64, p, p, i, i, i, f, i, p],
        "tvts_text_core": [p, p, p, i, i, i, i, f, i, i, p],
        "tvts_text_core_bwd": [p, p, p, p, p, p, p, i, i, i, i, i, f, i, i, p],
        # training backward
        "tvts_wgrad": [p, i64, p, i64, p, p, p, p, p, i, i, i, i, i, p],
        "tvts_reduce": [p, i, i64, p, p, p],
        "tvts_ln_bwd": [p, p, p, p, p, p, p, p, p, i, i, i, p],
        "tvts_attn_delta": [p, p, i, i, i, i, p, p],
        "tvts_flash_bwd": [p, p, p, p, p, p, i, i, i, i, i, i, f, p],
        "tvts_space_bwd": [p, p, p, p, p, p, i, i, i, i, i, f, p],
        "tvts_space_bwd_one_block": [i, i],
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


GEMM_TILE = (128, 256, 64)  # output rows, output columns, k step of a block (csrc/ln_gemm.cuh)
GEMM_STAGES = 3
GEMM_EPI_BYTES = 64 * 1024  # the epilogue buffer of a block (csrc/ln_gemm.cuh)
H100_SMS = 132


def gemm_plan(M: int, N: int, K: int, lda: int, ldy: int, ldres: int = 0,
              out_bytes: int = 2, pointers: dict[str, int] | None = None,
              sms: int = H100_SMS) -> dict:
    """The launch of ln_gemm for Y [M, N] = A [M, K at row stride lda] @ W [N, K]^T:
    the output tiles, the persistent grid (`blocks` = min(tiles, sms), one
    block an SM walking every blocks-th tile), the TMA boxes of A and W, the k
    steps and the shared memory of a block (the ring and the epilogue
    buffer). Raises ValueError, naming the argument, on what the kernel does
    not take: K not a multiple of the k step (64), a row stride that is not a
    multiple of 16 bytes, a base address (`pointers`: name -> address) that is
    not 16-byte aligned, N not a multiple of 8."""
    BM, BN, BK = GEMM_TILE
    if M < 1 or N < 1:
        raise ValueError(f"M = {M}, N = {N}: ln_gemm takes a non-empty product")
    if K < BK or K % BK:
        raise ValueError(f"K = {K}: ln_gemm takes a multiple of {BK}")
    if N % 8:
        raise ValueError(f"N = {N}: ln_gemm takes a multiple of 8")
    if lda < K:
        raise ValueError(f"lda = {lda} is shorter than K = {K}")
    for name, ld, size in (("lda", lda, 2), ("ldy", ldy, out_bytes), ("ldres", ldres, 2)):
        if ld * size % 16:
            raise ValueError(f"{name} = {ld} elements ({ld * size} bytes): ln_gemm takes row "
                             f"strides of a multiple of 16 bytes")
    for name, ptr in (pointers or {}).items():
        if ptr is not None and ptr % 16:
            raise ValueError(f"{name} at {ptr:#x} is not 16-byte aligned")
    tiles = -(-N // BN) * -(-M // BM)
    return dict(tiles=tiles, blocks=min(tiles, sms), box_a=(BK, BM), box_w=(BK, BN),
                k_steps=K // BK,
                smem=GEMM_STAGES * (BM + BN) * BK * 2 + GEMM_EPI_BYTES + 1024
                + 8 * (2 * GEMM_STAGES + 2))


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


LN_ROWS_MAX_K = 5120  # the widest row the LayerNorm row pass holds in registers (ln_gemm.cuh)


def ln_rows_plan(M: int, K: int, lda: int, pointers: dict[str, int] | None = None) -> None:
    """Raise ValueError, naming the argument, on what the LayerNorm row pass
    (csrc/ln_gemm.cuh::ln_rows_kernel) does not take: no rows, K not a
    multiple of 8 or above LN_ROWS_MAX_K, a row stride shorter than K or not a
    multiple of 16 bytes, a base address (`pointers`: name -> address) that is
    not 16-byte aligned."""
    if M < 1:
        raise ValueError(f"M = {M}: the LayerNorm row pass takes at least one row")
    if K < 8 or K % 8 or K > LN_ROWS_MAX_K:
        raise ValueError(f"K = {K}: the LayerNorm row pass takes a multiple of 8 up to "
                         f"{LN_ROWS_MAX_K}")
    if lda < K or lda % 8:
        raise ValueError(f"lda = {lda}: the LayerNorm row pass takes a row stride of at least "
                         f"K = {K} and a multiple of 16 bytes")
    for name, ptr in (pointers or {}).items():
        if ptr is not None and ptr % 16:
            raise ValueError(f"{name} at {ptr:#x} is not 16-byte aligned")


def ln_rows_plain(x, ln_w, ln_b, eps=LN_EPS):
    """The LayerNorm row pass in plain PyTorch: (LN(x) in x's dtype, the row
    statistics [rows, 2] f32: mean, rstd), in f32 with the kernel's two passes
    (mean, then the mean of squared deviations)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    rstd = torch.rsqrt((xf - mean).square().mean(-1, keepdim=True) + eps)
    y = (xf - mean) * rstd * ln_w.float() + ln_b.float()
    return y.to(x.dtype), torch.cat([mean, rstd], -1)


def ln_rows(x, ln_w, ln_b, eps: float = LN_EPS):
    """The LayerNorm row pass that precedes every LayerNorm product: x [M, K]
    (rows at any 16-byte stride, columns contiguous) -> (LN(x) [M, K]
    contiguous, the row statistics [M, 2] f32: mean, rstd). On a CPU tensor,
    ln_rows_plain."""
    if not _dispatch(x):
        return ln_rows_plain(x, ln_w, ln_b, eps)
    if x.dtype != torch.bfloat16 or x.dim() != 2 or x.stride(1) != 1:
        raise ValueError(f"x {x.dtype} of shape {tuple(x.shape)}, strides {x.stride()}: the "
                         f"row pass takes bf16 rows with contiguous columns")
    M, K = x.shape
    _expect("ln_w", ln_w, x, torch.float32, (K,))
    _expect("ln_b", ln_b, x, torch.float32, (K,))
    ln_rows_plan(M, K, x.stride(0), {"x": _ptr(x)})
    lib = library()
    with torch.cuda.device(x.device):
        y = torch.empty(M, K, dtype=x.dtype, device=x.device)
        stats = torch.empty(M, 2, dtype=torch.float32, device=x.device)
        _check(lib, lib.tvts_ln_rows(_ptr(x), x.stride(0), M, K, _ptr(ln_w), _ptr(ln_b), eps,
                                     _ptr(stats), _ptr(y), _stream(x)))
    ln_rows.launches += 1
    return y, stats


def _ln_gemm(lib, x, rows, lda, ln, w, b, out, act="none", res=None, ldres=0,
             eps=LN_EPS, pre=None, hidden=None, act_out=None):
    """out = act(LN?(x rows at stride lda) @ w.T + b) (+ res), on the card;
    `eps` is the LayerNorm's (1e-5 in the towers, 1e-6 in the sort head). An
    f32 `out` takes the f32 store. With `ln` = (ln_w, ln_b) the row pass
    (`ln_rows`) first writes LN(x) into a scratch [rows, K] bf16, which the
    product reads. Returns the LayerNorm row statistics ([rows, 2] f32: mean,
    rstd) or None.

    The H8 epilogues (csrc/ln_gemm.cuh): with `pre` (bf16, out's shape) the
    pre-activation product goes there and `out` gets the activation of the
    rounded value; with `hidden` (bf16 or f32) and `act_out` (bf16), both of
    out's shape, out = (x @ w.T) * act'(hidden) and act_out = act(hidden).
    `res` only with a bf16 `out` and neither. The plan's `blocks` (the card's
    SM count read once) is the grid the kernel launches; each launch adds its
    tiles and blocks to `_ln_gemm.tiles` / `.blocks` (`gemm_counts`)."""
    ln_w, ln_b = ln if ln else (None, None)
    f32 = out.dtype == torch.float32
    if hidden is not None:
        epi, second = (3 if hidden.dtype == torch.float32 else 2), act_out
    else:
        epi, second = (1 if pre is not None else 0), pre
    if res is not None and (f32 or epi):
        raise ValueError("ln_gemm adds a residual only to a bf16 product with no second output")
    K = w.shape[1]
    plan = gemm_plan(rows, w.shape[0], K, lda, out.shape[-1], ldres, out.element_size(),
                     {"x": _ptr(x), "w": _ptr(w), "bias": _ptr(b), "res": _ptr(res),
                      "out": _ptr(out), "second output": _ptr(second), "hidden": _ptr(hidden)},
                     sms=_sm_count(x.device.index) if x.is_cuda else H100_SMS)
    stats = xn = None
    if ln:
        ln_rows_plan(rows, K, lda, {"ln_w": _ptr(ln_w), "ln_b": _ptr(ln_b)})
        stats = torch.empty(rows, 2, dtype=torch.float32, device=x.device)
        xn = torch.empty(rows, K, dtype=torch.bfloat16, device=x.device)
    _check(lib, lib.tvts_ln_gemm(
        _ptr(x), lda, _ptr(ln_w), _ptr(ln_b), eps, _ptr(stats), _ptr(xn), _ptr(w), _ptr(b),
        _ptr(res), ldres, None if f32 else _ptr(out), _ptr(out) if f32 else None,
        out.shape[-1], rows, w.shape[0], K, ACTS[act], _ptr(second), _ptr(hidden),
        epi, plan["blocks"], _stream(x)))
    _ln_gemm.tiles += plan["tiles"]
    _ln_gemm.blocks += plan["blocks"]
    if ln:
        ln_rows.launches += 1
    return stats


SMEM_OPTIN = 227 * 1024  # shared memory one block may take on the H100 (csrc/common.cuh)


def space_core_smem(N: int, d: int) -> int:
    """Shared memory of a space-core block (csrc/attention.cuh): the frame's
    1 + N key and value rows in bf16, padded to 16 rows and to d + 8 columns,
    then the CLS row's f32 P and running max, 65 floats a 64-key tile."""
    return 4 * (-(-(N + 1) // 16) * 16) * (d + 8) + 4 * 65 * -(-(N + 1) // 64)


def _check_space_frame(N: int, d: int) -> None:
    """Raise ValueError when a frame of N patches does not fit a space-core block."""
    if space_core_smem(N, d) > SMEM_OPTIN:
        n_max = SMEM_OPTIN // (4 * (d + 8)) // 16 * 16 - 1
        while space_core_smem(n_max, d) > SMEM_OPTIN:
            n_max -= 16
        raise ValueError(f"{N} patches a frame at head dim {d}: the space core stages a "
                         f"frame's {N + 1} key and value rows in shared memory "
                         f"({space_core_smem(N, d)} bytes); at most {n_max} patches fit the "
                         f"{SMEM_OPTIN} bytes a block may take")


def _cls_row(lib, q, q_bstride, k, v, kv_bstride, kv_rstride, n_keys, out, out_bstride,
             num_heads, head_dim, lse=None, scale=None, batch=None):
    """Split-KV CLS global row: out[b] = softmax(q[b] k[b]^T * scale) v[b]
    (scale 1/sqrt(d) unless given); head h of a row sits at offset h * d.
    With `lse` [B, H, n_keys] the row's log-sum-exp goes to lse[:, :, 0].
    `batch` overrides q.shape[0] as the number of batches. q, k, v and out
    are bf16, or f32 (H9 in f32)."""
    B = q.shape[0] if batch is None else batch
    n_chunks = -(-n_keys // 128)
    partial = torch.empty(B, num_heads, n_chunks, head_dim + 2, dtype=torch.float32,
                          device=q.device)
    _check(lib, lib.tvts_cls_attention(
        _ptr(q), q_bstride, _ptr(k), _ptr(v), kv_bstride, kv_rstride, n_keys, _ptr(out),
        out_bstride, _ptr(partial), _ptr(lse), B, num_heads, head_dim,
        head_dim ** -0.5 if scale is None else scale, int(q.dtype == torch.float32),
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
    patch rows -> the CLS row (the space core's fold and combine; after the
    time core the split-KV kernel) -> ln_gemm proj with the residual.

    save=True (training forward) also returns what the backward needs:
    (out, qkv [B, S, 3D], attn [B, S, D] (pre-projection), lse [B, H, S] f32
    (the per-row log-sum-exp; row 0 the CLS row), LN row stats [B*S, 2] f32)."""
    B, S, D = x.shape
    N = _patches_per_frame(S, num_frames)
    d = _check_attention_args(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, num_frames,
                              num_heads)
    if core == "tvts_space_core":
        _check_space_frame(N, d)
    _expect("residual", res, x, x.dtype, (B, S, D))
    lib = library()
    with torch.cuda.device(x.device):
        qkv = torch.empty(B, S, 3 * D, dtype=x.dtype, device=x.device)
        stats = _ln_gemm(lib, x, B * S, D, (ln_w, ln_b), wqkv, bqkv, qkv)
        attn = torch.empty_like(x)
        lse = (torch.empty(B, num_heads, S, dtype=torch.float32, device=x.device)
               if save else None)
        if core == "tvts_space_core":  # the CLS row folded into the frames' blocks
            _space_core(lib, qkv, attn, lse, num_frames, N, num_heads, d)
        else:
            _check(lib, getattr(lib, core)(_ptr(qkv), _ptr(attn), _ptr(lse), B, num_frames, N,
                                           num_heads, d, d ** -0.5, _stream(x)))
            _cls_row(lib, qkv, S * 3 * D, qkv[..., D:], qkv[..., 2 * D:], S * 3 * D, 3 * D, S,
                     attn, S * D, num_heads, d, lse=lse)
        out = torch.empty_like(x)
        _ln_gemm(lib, attn, B * S, D, None, wproj, bproj, out, res=res, ldres=D)
    return (out, qkv, attn, lse, stats) if save else out


def _space_core(lib, qkv, out, lse, T, N, H, d):
    partial = torch.empty(qkv.shape[0], H, T, d + 2, dtype=torch.float32, device=qkv.device)
    _check(lib, lib.tvts_space_core(_ptr(qkv), _ptr(out), _ptr(lse), _ptr(partial),
                                    qkv.shape[0], T, N, H, d, d ** -0.5, _stream(qkv)))


def space_core_plain(qkv, num_frames, num_heads):
    """Every row of the space attention on packed rows qkv [B, S, 3D] (q not
    pre-scaled), in f32: patch (t, i) over the CLS key and frame t's patches,
    the CLS query over every token. -> (out [B, S, D], lse [B, H, S])."""
    B, S, D3 = qkv.shape
    T, H = num_frames, num_heads
    N = _patches_per_frame(S, T)
    d = D3 // 3 // H
    q, k, v = (t.float().reshape(B, S, H, d).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
    q = q * d ** -0.5
    qp, kp, vp = (t[:, :, 1:].reshape(B, H, T, N, d) for t in (q, k, v))
    keys = torch.cat([k[:, :, None, :1].expand(B, H, T, 1, d), kp], dim=3)  # [B, H, T, 1+N, d]
    vals = torch.cat([v[:, :, None, :1].expand(B, H, T, 1, d), vp], dim=3)
    logits = qp @ keys.transpose(-1, -2)  # [B, H, T, N, 1 + N]
    out_p = (torch.softmax(logits, -1) @ vals).reshape(B, H, T * N, d)
    cls_logits = q[:, :, :1] @ k.transpose(-1, -2)  # [B, H, 1, S]
    out_c = torch.softmax(cls_logits, -1) @ v
    out = torch.cat([out_c, out_p], dim=2).transpose(1, 2).reshape(B, S, H * d)
    lse = torch.cat([torch.logsumexp(cls_logits, -1),
                     torch.logsumexp(logits, -1).reshape(B, H, T * N)], dim=2)
    return out, lse


def space_core(qkv, num_frames: int, num_heads: int, with_lse: bool = False):
    """H2's space core alone on packed rows qkv [B, S, 3D] as ln_gemm writes
    them (q not pre-scaled): -> every row of the attention [B, S, D] (row 0
    the CLS query over every token, folded into the frames' blocks and
    combined), and with with_lse every row's log-sum-exp [B, H, S] f32. On a
    CPU tensor, space_core_plain rounded to qkv's dtype."""
    B, S, D3 = qkv.shape
    N = _patches_per_frame(S, num_frames)
    if not _dispatch(qkv):
        out, lse = space_core_plain(qkv, num_frames, num_heads)
        return (out.to(qkv.dtype), lse) if with_lse else out.to(qkv.dtype)
    d = _check_geometry(D3 // 3, num_heads, num_frames)
    _check_space_frame(N, d)
    _expect("qkv", qkv, qkv, torch.bfloat16, (B, S, D3))
    with torch.cuda.device(qkv.device):
        out = torch.empty(B, S, D3 // 3, dtype=qkv.dtype, device=qkv.device)
        lse = (torch.empty(B, num_heads, S, dtype=torch.float32, device=qkv.device)
               if with_lse else None)
        _space_core(library(), qkv, out, lse, num_frames, N, num_heads, d)
    return (out, lse) if with_lse else out


@spanned("fused_time_block")
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


@spanned("fused_space_block")
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
def mlp_block_plain(x, ln_w, ln_b, wfc, bfc, wproj, bproj, act, eps=LN_EPS):
    """x + c_proj(act(c_fc(LN_2(x))))."""
    return x + mlp(layer_norm_f32(x, ln_w, ln_b, eps), wfc, bfc, wproj, bproj, act)


def _mlp_sub_path(x, ln_w, ln_b, wfc, bfc, wproj, bproj, act: str, save_hidden: bool = False,
                  eps: float = LN_EPS):
    """x + c_proj(act(c_fc(LN_2(x)))) on the card: the LayerNorm row pass (eps
    1e-5 in the towers, 1e-6 in the joint blocks) and ln_gemm with the
    activation epilogue, then ln_gemm with the residual. Returns (out, LN row
    stats [B*S, 2] f32, h): h is the pre-activation hidden [B, S, 4D] in bf16
    with save_hidden (the activation is then taken from the rounded h), else
    None."""
    if act not in ("quick_gelu", "gelu"):
        raise ValueError(f"unknown activation {act!r}")
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
        h_act = torch.empty(B, S, hidden, dtype=x.dtype, device=x.device)
        h_pre = torch.empty_like(h_act) if save_hidden else None
        stats = _ln_gemm(lib, x, B * S, D, (ln_w, ln_b), wfc, bfc, h_act, act=act, pre=h_pre,
                         eps=eps)
        out = torch.empty_like(x)
        _ln_gemm(lib, h_act, B * S, hidden, None, wproj, bproj, out, res=x, ldres=D)
    return out, stats, h_pre


def mlp_geometry(x, ln_w, ln_b, wfc, bfc, wproj, bproj, act: str = "quick_gelu",
                 save_hidden: bool = False, **_) -> dict:
    """The span geometry of an MLP sub-path's call (utils/profiling): its
    hidden width and flags beside B, S and D."""
    return describe(x, hidden=wfc.shape[0], act=act, save_hidden=save_hidden)


@spanned("fused_mlp_block", mlp_geometry)
def fused_mlp_block(x, ln_w, ln_b, wfc, bfc, wproj, bproj, act: str = "quick_gelu", *,
                    eps: float = LN_EPS) -> torch.Tensor:
    """H3. x: [B, S, D] -> x + c_proj(act(c_fc(LN_2(x)))), the LayerNorm's
    eps 1e-5 (the towers) unless given (1e-6: the joint blocks)."""
    if act not in ("quick_gelu", "gelu"):
        raise ValueError(f"unknown activation {act!r}")
    if not _dispatch(x):
        return mlp_block_plain(x, ln_w, ln_b, wfc, bfc, wproj, bproj, act, eps)
    out, _, _ = _mlp_sub_path(x, ln_w, ln_b, wfc, bfc, wproj, bproj, act, eps=eps)
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


@spanned("fused_space_cls_only")
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
    if num_heads > 16 or D > 1280:
        raise ValueError(f"{num_heads} heads of width {D}: H4 takes at most 16 heads and a "
                         f"width of at most 1280")
    # two blocks of the pass over x fit an SM up to D = 768 (csrc/cls_pool.cuh)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    C, R = cls_chunks(B, S, sms * (2 if D <= 768 else 1))
    lib = library()
    with torch.cuda.device(x.device):
        f32 = dict(dtype=torch.float32, device=x.device)
        q, att = torch.empty(B, D, **f32), torch.empty(B, D, dtype=x.dtype, device=x.device)
        u, zf = torch.empty(B, num_heads, D, **f32), torch.empty(B, num_heads, D, **f32)
        partial = torch.empty(B, C, num_heads, D + 2, **f32)
        out = torch.empty_like(basecls)
        _check(lib, lib.tvts_cls_only(
            _ptr(x), B, S, num_heads, d, _ptr(ln_w), _ptr(ln_b), LN_EPS, _ptr(wqkv), _ptr(bqkv),
            _ptr(wproj), _ptr(bproj), _ptr(basecls), _ptr(out), _ptr(q), _ptr(u),
            _ptr(partial), _ptr(zf), _ptr(att), C, R, _stream(x)))
    fused_space_cls_only.launches += 1
    return out


def cls_chunks(B: int, S: int, slots: int) -> tuple[int, int]:
    """(C, R): H4's pass over x splits each clip's S rows into C chunks of R
    rows (a multiple of 16; C * R >= S, no chunk empty), so that the B * C
    blocks fill about two waves of the `slots` blocks the card holds at once
    (a third, nearly empty wave costs as much as a full one)."""
    C = min(max(1, 2 * slots // B), -(-S // 16))
    rows = -(-S // C)
    R = -(-rows // 16) * 16
    return -(-S // R), R


KERNELS = (fused_time_block, fused_space_block, fused_mlp_block, fused_space_cls_only)
# the sub-paths, then the LayerNorm row pass (one count per row pass: one per
# LayerNorm product, whichever sub-path or wrapper launched it)
COUNTED = (*KERNELS, ln_rows)
for _fn in COUNTED:
    _fn.launches = 0
# ln_gemm's output tiles and the persistent blocks it launched: 1 - blocks /
# tiles is the share of tiles that followed another tile in their block
_ln_gemm.tiles = _ln_gemm.blocks = 0


def reset_launch_counts() -> None:
    for fn in COUNTED:
        fn.launches = 0
    _ln_gemm.tiles = _ln_gemm.blocks = 0


def gemm_counts() -> dict[str, int]:
    return {"ln_gemm.tiles": _ln_gemm.tiles, "ln_gemm.blocks": _ln_gemm.blocks}


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in COUNTED}
