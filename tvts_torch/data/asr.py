"""ASR transcript cleaning and DTW alignment for YT-Temporal (counterpart of
tvts_tpu/data/asr.py; reference v2/base/base_dataset_yt.py:439-522,
`align_using_dtw`, `clean_subtitles`, `clean_description`).

The reference pulls in editdistance, tslearn, ftfy and demoji; as in the JAX
package they are written out here, with the same results:
- `edit_distance`: the Levenshtein recurrence (== editdistance.eval);
- `dtw_path`: DTW over a precomputed cost matrix (== tslearn's
  dtw_path_from_metric(metric="precomputed")), the 3-way recurrence with its
  backtrack taking the first of (diagonal, up, left) on ties;
- ftfy is optional: without it the text passes unchanged (the tokenizer, not
  this module, falls back to NFC); emoji are stripped by a regex.
The DP tables are Python lists of Python floats, which hold the float64 sums
of the JAX package's numpy arrays exactly. Stdlib `re` only.
"""

from __future__ import annotations

import re
import string

try:
    import ftfy as _ftfy

    def _fix_text(s: str) -> str:
        return _ftfy.ftfy(s)
except ImportError:
    def _fix_text(s: str) -> str:
        return s

_EMOJI_RE = re.compile(
    "[\U0001F000-\U0001FAFF\U00002600-\U000027BF\U0001F1E6-\U0001F1FF←-⇿⬀-⯿]+"
)
_URL_RE = re.compile(
    r"""(?i)\b((?:https?://|www\d{0,3}[.]|[a-z0-9.\-]+[.][a-z]{2,4}/)"""
    r"""(?:[^\s()<>]+|\(([^\s()<>]+|(\([^\s()<>]+\)))*\))+"""
    r"""(?:\(([^\s()<>]+|(\([^\s()<>]+\)))*\)|[^\s`!()\[\]{};:'".,<>?«»“”‘’]))"""
)
_PUNCT = str.maketrans("", "", string.punctuation)


def edit_distance(a: str, b: str) -> int:
    if a == b:
        return 0
    if not a or not b:
        return max(len(a), len(b))
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[len(b)]


def dtw_path(cost) -> list[tuple[int, int]]:
    """Optimal DTW path through a precomputed cost matrix [n, m] (monotone,
    steps (1, 0), (0, 1), (1, 1)), as tslearn's precomputed-metric dtw."""
    n, m = len(cost), len(cost[0]) if len(cost) else 0
    inf = float("inf")
    acc = [[0.0] + [inf] * m] + [[inf] * (m + 1) for _ in range(n)]
    for i in range(1, n + 1):
        row_c, up, row = cost[i - 1], acc[i - 1], acc[i]
        for j in range(1, m + 1):
            row[j] = float(row_c[j - 1]) + min(up[j], row[j - 1], up[j - 1])
    path = []
    i, j = n, m
    while i > 0 and j > 0:
        path.append((i - 1, j - 1))
        diag, up, left = acc[i - 1][j - 1], acc[i - 1][j], acc[i][j - 1]
        if diag <= up and diag <= left:
            i, j = i - 1, j - 1
        elif up <= left:
            i -= 1
        else:
            j -= 1
    path.reverse()
    return path


def align_using_dtw(input_asr, grover_output, radius_perc: float = 0.1,
                    radius_abs: int = 32) -> list[str]:
    """Align raw ASR words to denoised text via banded edit-distance DTW: one
    string of denoised words for each ASR word."""
    input_asr = list(input_asr)
    grover_output = list(grover_output)
    max_radius = int(max(len(input_asr) * radius_perc, radius_abs))
    if len(grover_output) > len(input_asr):
        grover_output = grover_output[: len(input_asr) + max_radius]

    asr_pre = [x.translate(_PUNCT).strip().lower() for x in input_asr]
    gro_pre = [x.translate(_PUNCT).strip().lower() for x in grover_output]
    cost = []
    for a_idx, a in enumerate(asr_pre):
        row = [9999.0] * len(gro_pre)
        for o_idx in range(max(a_idx - max_radius, 0), min(a_idx + max_radius, len(gro_pre))):
            row[o_idx] = float(edit_distance(a, gro_pre[o_idx]))
        cost.append(row)

    denoised_out: list[list[str]] = [[] for _ in input_asr]
    has_seen = -1
    for idx1, idx2 in dtw_path(cost):
        if idx1 >= len(input_asr) or idx2 >= len(grover_output):
            break
        if idx2 > has_seen:  # skip duplicate grover matches
            denoised_out[idx1].append(grover_output[idx2])
        has_seen = idx2
    return [" ".join(x) for x in denoised_out]


def clean_subtitles(subtitle_dicts: list[dict]) -> list[dict]:
    """Drop HTML-entity junk words and ftfy-fix the rest."""
    out = []
    for x in subtitle_dicts:
        word = x["word"]
        if word.startswith("&") or word.endswith(";"):
            continue
        fixed = _fix_text(word)
        if not fixed:
            continue
        out.append({**x, "word": fixed})
    return out


def clean_description(text: str) -> str:
    """Strip emojis, URLs (replaced by '%'), collapse whitespace."""
    text = _EMOJI_RE.sub("", text).strip()
    text = _URL_RE.sub("%", text)
    text = re.sub(" +", " ", text)
    text = re.sub(r"\s*\n+", "\n", text)
    return text.strip()
