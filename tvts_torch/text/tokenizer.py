"""CLIP byte-level BPE tokenizer (counterpart of tvts_tpu/text/tokenizer.py),
standard library and numpy only.

The JAX package splits words with the `regex` package's `\\p{L}` / `\\p{N}`
classes under IGNORECASE. Here the same split is rebuilt with `re` and
explicit character classes drawn from `unicodedata.category` (L* letters, N*
numbers), so the ids are identical:
- `[^\\W\\d_]` would not do: Python's `\\d` is Nd only, so `²` (No), `½` (No)
  and `Ⅻ` (Nl) would fall in the wrong branch;
- `re`'s `\\s` also matches U+001C-U+001F, which `regex` does not: whitespace
  here is `str.isspace()` without those four;
- under IGNORECASE `regex` matches U+0345 (a combining mark whose uppercase is
  a letter) with no branch at all, so it is dropped; so it is here.
Code points that Python's Unicode tables leave unassigned match the
"other" branch; a `regex` release with newer tables may call some of them
letters or numbers.

The merge table is read by path from the JAX package's data file
`tvts_tpu/assets/clip_bpe.json.gz` (nothing of `tvts_tpu` is imported), or
from another file of that format via `ClipBpeTokenizer(bpe_path=...)`.
Without ftfy the text is NFC-normalised instead of `ftfy.fix_text`-ed, as in
the JAX package.
"""

from __future__ import annotations

import functools
import gzip
import html
import json
import re
import sys
import unicodedata
from pathlib import Path

import numpy as np

try:
    import ftfy as _ftfy
except ImportError:
    _ftfy = None

SOT_TOKEN = "<|startoftext|>"
EOT_TOKEN = "<|endoftext|>"
CONTEXT_LENGTH = 77
_NUM_MERGES = 49152 - 256 - 2  # 48894, the slice CLIP takes from the vocab file
DEFAULT_BPE_PATH = (Path(__file__).resolve().parents[2] / "tvts_tpu" / "assets"
                    / "clip_bpe.json.gz")
_NO_BRANCH = {0x345}
_REGEX_EXTRA_WS = range(0x1C, 0x20)


def _char_class(pred) -> str:
    """A `re` class body of the code points where pred(cp) holds, as ranges."""
    out, start = [], None
    for cp in range(sys.maxunicode + 2):
        hit = cp <= sys.maxunicode and pred(cp)
        if hit and start is None:
            start = cp
        elif not hit and start is not None:
            a, b = re.escape(chr(start)), re.escape(chr(cp - 1))
            out.append(a if start == cp - 1 else f"{a}-{b}")
            start = None
    return "".join(out)


@functools.cache
def _patterns() -> tuple[re.Pattern, re.Pattern]:
    """(word pattern, whitespace pattern), built on first use (~1 s)."""
    cats = [unicodedata.category(chr(cp))[0] for cp in range(sys.maxunicode + 1)]
    letters = _char_class(lambda cp: cats[cp] == "L")
    numbers = _char_class(lambda cp: cats[cp] == "N")
    space = _char_class(lambda cp: chr(cp).isspace() and cp not in _REGEX_EXTRA_WS)
    other = _char_class(lambda cp: cats[cp] not in "LN" and cp not in _NO_BRANCH
                        and not (chr(cp).isspace() and cp not in _REGEX_EXTRA_WS))
    word = re.compile(r"(?i:<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d)"
                      rf"|[{letters}]+|[{numbers}]|[{other}]+")
    return word, re.compile(rf"[{space}]+")


@functools.cache
def byte_unicode_table() -> dict[int, str]:
    """GPT-2 reversible byte -> printable-unicode mapping."""
    printable = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
                 + list(range(ord("®"), ord("ÿ") + 1)))
    codes = printable[:]
    offset = 0
    for b in range(256):
        if b not in printable:
            printable.append(b)
            codes.append(256 + offset)
            offset += 1
    return dict(zip(printable, [chr(c) for c in codes]))


def _load_merges(path: str | Path) -> list[tuple[str, str]]:
    with gzip.open(path, "rt", encoding="utf-8") as f:
        return [tuple(m.split(" ")) for m in json.load(f)["merges"]]


def clean_text(text: str) -> str:
    text = _ftfy.fix_text(text) if _ftfy is not None else unicodedata.normalize("NFC", text)
    text = html.unescape(html.unescape(text)).strip()
    return _patterns()[1].sub(" ", text).strip()


class ClipBpeTokenizer:
    def __init__(self, bpe_path: str | Path | None = None):
        self.byte_encoder = byte_unicode_table()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        merges = _load_merges(bpe_path or DEFAULT_BPE_PATH)
        if len(merges) != _NUM_MERGES:
            raise ValueError(f"expected {_NUM_MERGES} merges, got {len(merges)}")
        units = list(self.byte_encoder.values())
        vocab = units + [u + "</w>" for u in units] + ["".join(p) for p in merges]
        vocab += [SOT_TOKEN, EOT_TOKEN]
        self.encoder: dict[str, int] = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.rank: dict[tuple[str, str], int] = {pair: i for i, pair in enumerate(merges)}
        self._cache: dict[str, list[str]] = {SOT_TOKEN: [SOT_TOKEN], EOT_TOKEN: [EOT_TOKEN]}

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    @property
    def sot_id(self) -> int:
        return self.encoder[SOT_TOKEN]

    @property
    def eot_id(self) -> int:
        return self.encoder[EOT_TOKEN]

    def _bpe_word(self, token: str) -> list[str]:
        """Merge a byte-unicode word into BPE subwords (word-final marker on the
        last), merging every occurrence of the best-ranked pair per step."""
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        parts = list(token[:-1]) + [token[-1] + "</w>"]
        while len(parts) > 1:
            ranked = [(self.rank[p], i) for i, p in enumerate(zip(parts, parts[1:]))
                      if p in self.rank]
            if not ranked:
                break
            i = min(ranked)[1]
            first, second = parts[i], parts[i + 1]
            merged: list[str] = []
            j = 0
            while j < len(parts):
                if j < len(parts) - 1 and parts[j] == first and parts[j + 1] == second:
                    merged.append(first + second)
                    j += 2
                else:
                    merged.append(parts[j])
                    j += 1
            parts = merged
        self._cache[token] = parts
        return parts

    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        for word in _patterns()[0].findall(clean_text(text).lower()):
            unicoded = "".join(self.byte_encoder[b] for b in word.encode("utf-8"))
            ids.extend(self.encoder[sub] for sub in self._bpe_word(unicoded))
        return ids

    def decode(self, ids) -> str:
        text = "".join(self.decoder[int(i)] for i in ids)
        raw = bytearray(self.byte_decoder[c] for c in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")


@functools.cache
def _default_tokenizer() -> ClipBpeTokenizer:
    return ClipBpeTokenizer()


def tokenize(texts, context_length: int = CONTEXT_LENGTH, truncate: bool = False,
             tokenizer: ClipBpeTokenizer | None = None) -> np.ndarray:
    """OpenAI-CLIP convention: [N, context_length] int32, zero-padded; raises
    on overflow unless truncate=True (then the last token is forced to EOT)."""
    if isinstance(texts, str):
        texts = [texts]
    tk = tokenizer or _default_tokenizer()
    out = np.zeros((len(texts), context_length), dtype=np.int32)
    for row, text in enumerate(texts):
        ids = [tk.sot_id] + tk.encode(text) + [tk.eot_id]
        if len(ids) > context_length:
            if not truncate:
                raise RuntimeError(f"Input {text!r} is too long for context length "
                                   f"{context_length}")
            ids = ids[:context_length]
            ids[-1] = tk.eot_id
        out[row, :len(ids)] = ids
    return out


def tokenize_openclip(texts, context_length: int = CONTEXT_LENGTH,
                      tokenizer: ClipBpeTokenizer | None = None) -> np.ndarray:
    """open_clip convention: always truncates, forcing the final token to EOT."""
    return tokenize(texts, context_length=context_length, truncate=True, tokenizer=tokenizer)
