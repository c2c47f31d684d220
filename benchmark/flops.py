"""Work arithmetic: the operations and bytes of each sub-path call, the bound
they set on one H100, and the model FLOPs of a clip.

The sub-path formulas are those of the repository's chip_smoke.py, copied
here so that a change to the program cannot move the yardstick. Each input
byte is counted read once and each output byte written once (bf16 unless
said), whatever a kernel reads again, so the bound is never above what the
card could reach.

Model FLOPs (for `mfu`) count the multiply-adds the forward and backward
need, from the shapes alone: the products of every sub-path, the attention
cores over their (query, key) pairs, the patch stem and the pooling. A
backward is twice its forward, except where no weight gradient is taken
(frozen text blocks: the products' backward is once the forward, the cores'
twice; the patch stem: its weight gradient only). Recomputation is not
counted. Extraction counts what the pooled embedding needs: in the last
block only the CLS row of the space sub-path (its keys and values over every
token) and of the MLP.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate, HBM3 bandwidth
PEAK_FLOPS = 989e12
HBM_BYTES_S = 3.35e12


def attention_work(kind: str, B: int, T: int, N: int, D: int, H: int, backward: bool):
    """(flops, bytes) of a video attention sub-path at [B, 1 + T*N, D]: the
    qkv and proj products, the core over its (query, key) pairs (the CLS row
    over every token), each input read once and each output written once."""
    S = 1 + T * N
    M = B * S
    keys = T + 1 if kind == "time" else N + 1
    pairs = B * (T * N * keys + S)
    weights = 2 * 4 * D * D
    if backward:  # g, x, qkv, attn, lse in; dx, dW out
        return 16 * M * D * D + 10 * D * pairs, 2 * M * D * 7 + 4 * B * H * S + 2 * weights
    extra = 2 * M * D if kind == "space" else 0  # base
    return 8 * M * D * D + 4 * D * pairs, 4 * M * D + extra + weights


def saving_forward_work(kind: str, B: int, T: int, N: int, D: int, H: int):
    """(flops, bytes) of the training forward of H6 / H5: the inference
    sub-path plus the saved qkv rows, attention output and per-row lse."""
    S = 1 + T * N
    flops, nbytes = attention_work(kind, B, T, N, D, H, backward=False)
    return flops, nbytes + 2 * B * S * 4 * D + 4 * B * H * S


def cls_only_work(B: int, S: int, D: int, H: int):
    """(flops, bytes) of H4: x read once, the weights once, the absorbed
    products (logits and P^T Y over every row, 4 * B*S*D*H flops, and the
    CLS rows' matvecs)."""
    M = B * S
    return 4 * M * D * H + 8 * B * D * D, 2 * M * D + 8 * D * D + 4 * B * D


def mlp_work(M: int, D: int, backward: bool, save: bool, hidden: int | None = None):
    """(flops, bytes) of an MLP sub-path over M rows of width D (hidden 4D
    unless given): two products forward; backward four, and a fifth when the
    hidden is recomputed."""
    hidden = 4 * D if hidden is None else hidden
    product = 2 * M * D * hidden
    weights = 2 * 2 * D * hidden  # both matrices, bf16
    saved = 2 * M * hidden if save else 0
    if backward:  # g, x in, dx out; weights in, their gradients out
        return (4 if save else 5) * product, 3 * 2 * M * D + 2 * weights + saved
    return 2 * product, 2 * 2 * M * D + weights + saved


def text_work(B: int, S: int, D: int, H: int, causal: bool, backward: bool,
              frozen: bool = False):
    """(flops, bytes) of the H7 sub-path (forward or backward) at [B, S, D]."""
    M = B * S
    pairs = B * (S * (S + 1) // 2 if causal else S * S)
    weights = 2 * 4 * D * D
    if backward:
        gemm = 8 if frozen else 16
        return (gemm * M * D * D + 10 * D * pairs,
                2 * M * D * 7 + 4 * B * H * S + (1 if frozen else 2) * weights)
    return 8 * M * D * D + 4 * D * pairs, 4 * M * D + weights


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_FLOPS) -> float:
    """The least time the card could take: max(bytes / HBM rate, flops / peak)."""
    return max(flops / peak, nbytes / HBM_BYTES_S) * 1e3


# ---------------------------------------------------------------------------
# model FLOPs (forward products and cores; module notes for the backward)
# ---------------------------------------------------------------------------
def _block_split(S: int, D: int, hidden: int, core_pairs: int) -> tuple[float, float]:
    """(products, cores) of one pre-norm block over S rows: qkv, proj, MLP."""
    return 8 * S * D * D + 4 * S * D * hidden, 4 * D * core_pairs


def video_forward(v: dict, kept: int, cls_only_last: bool) -> tuple[float, float, float]:
    """(products, cores, stem) FLOPs of the video tower on one clip with
    `kept` patches a frame."""
    T, D = v["num_frames"], v["width"]
    hidden = int(D * v["mlp_ratio"])
    n_all = (v["input_resolution"] // v["patch_size"]) ** 2
    S = 1 + T * kept
    time_pairs = T * kept * (T + 1) + S
    space_pairs = T * kept * (kept + 1) + S
    products = cores = 0.0
    for i in range(v["layers"]):
        if cls_only_last and i == v["layers"] - 1:
            # time sub-path whole; space: q, proj and the MLP on the CLS row, k and v on all
            products += 8 * S * D * D + 4 * S * D * D + 4 * D * D + 4 * D * hidden
            cores += 4 * D * time_pairs + 4 * D * S
            continue
        products += 16 * S * D * D + 4 * S * D * hidden
        cores += 4 * D * (time_pairs + space_pairs)
    out = v["output_dim"]
    pooled_rows = 1 if cls_only_last else S
    products += 2 * pooled_rows * D * out
    stem = 2 * 3 * v["patch_size"] ** 2 * D * T * n_all
    return products, cores, stem


def text_forward(t: dict) -> list[tuple[float, float]]:
    """(products, cores) FLOPs of each text block on one sequence of the
    full context (causal), the last block on the EOT row only, then the
    projection added to the last entry."""
    L, W, hidden = t["context_length"], t["width"], 4 * t["width"]
    causal = L * (L + 1) // 2
    blocks = [_block_split(L, W, hidden, causal) for _ in range(t["layers"] - 1)]
    last_products = 4 * L * W * W + 4 * W * W + 4 * W * hidden + 2 * W * t["output_dim"]
    blocks.append((last_products, 4 * W * L))
    return blocks


def sort_forward(s: dict, video_tokens: int, n_text: int) -> tuple[float, float]:
    """(products, cores) FLOPs of the sort head on one clip: every block over
    video and text rows, the last on the text rows only, then the head."""
    E = s["embed_dim"]
    hidden = int(E * s["mlp_ratio"])
    n = video_tokens + n_text
    products = cores = 0.0
    for _ in range(s["depth"] - 1):
        p, c = _block_split(n, E, hidden, n * n)
        products, cores = products + p, cores + c
    products += (4 * n * E * E + 4 * n_text * E * E + 4 * n_text * E * hidden
                 + 2 * n_text * E * s["num_classes"])
    cores += 4 * E * n_text * n
    return products, cores


def extract_flops_per_clip(cfg: dict) -> float:
    """Model FLOPs of one clip's pooled embedding (no tube mask)."""
    v = cfg["vision"]
    n_all = (v["input_resolution"] // v["patch_size"]) ** 2
    return sum(video_forward(v, n_all, cls_only_last=True))


def train_flops_per_clip(cfg: dict, kept: int, n_trans: int, frozen_text: int) -> float:
    """Model FLOPs of one clip's forward and backward in a training step with
    `n_trans` captions a clip (the sort head runs when n_trans > 1) and the
    first `frozen_text` text blocks frozen."""
    v, t, s = cfg["vision"], cfg["text"], cfg["sort"]
    products, cores, stem = video_forward(v, kept, cls_only_last=False)
    total = 3 * (products + cores) + 2 * stem
    for i, (p, c) in enumerate(text_forward(t)):
        total += n_trans * (p * (2 if i < frozen_text else 3) + 3 * c)
    if n_trans > 1:
        tokens = 1 + v["num_frames"] * kept
        if v["pool_style"] == "openclip":
            tokens -= 1
        total += 3 * sum(sort_forward(s, tokens, n_trans))
    return total
