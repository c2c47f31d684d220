"""BERT-style WordPiece tokenizer for the TVTS v1 DistilBERT text tower
(counterpart of tvts_tpu/text/wordpiece.py), standard library and numpy only.

HuggingFace's `distilbert-base-uncased` tokenizer as the reference uses it
(v1/trainer/trainer.py:130-131: padding, truncation, max_length=50): basic
tokenization (lowercase, accent strip, punctuation split, CJK spacing), then
greedy longest-match-first WordPiece with '##' continuations; a word over
`max_input_chars_per_word` characters is one [UNK]. It reads the standard
vocab.txt (one token per line) from `vocab_path` or the TVTS_TPU_BERT_VOCAB
environment variable, as the JAX package does.

`__call__` pads statically to max_length (the reference pads to the batch's
longest; the attention mask makes the two equal).
"""

from __future__ import annotations

import os
import unicodedata

import numpy as np


def _is_whitespace(ch):
    return ch in " \t\n\r" or unicodedata.category(ch) == "Zs"


def _is_control(ch):
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch):
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp):
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
            or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


class WordPieceTokenizer:
    def __init__(self, vocab_path: str | None = None, lowercase: bool = True,
                 max_input_chars_per_word: int = 100):
        vocab_path = vocab_path or os.environ.get("TVTS_TPU_BERT_VOCAB", "")
        if not vocab_path or not os.path.exists(vocab_path):
            raise FileNotFoundError(
                "BERT vocab.txt not found; pass vocab_path or set TVTS_TPU_BERT_VOCAB")
        with open(vocab_path, encoding="utf-8") as f:
            tokens = [line.rstrip("\n") for line in f]
        self.vocab = {tok: i for i, tok in enumerate(tokens)}
        self.inv_vocab = {i: t for t, i in self.vocab.items()}
        self.lowercase = lowercase
        self.max_chars = max_input_chars_per_word
        self.unk = "[UNK]"
        self.cls_id = self.vocab["[CLS]"]
        self.sep_id = self.vocab["[SEP]"]
        self.pad_id = self.vocab["[PAD]"]

    # --- basic tokenization ---------------------------------------------
    def _clean(self, text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    def _basic_tokens(self, text: str) -> list[str]:
        text = self._clean(text)
        text = "".join(f" {c} " if _is_cjk(ord(c)) else c for c in text)
        tokens = []
        for tok in text.split():
            if self.lowercase:
                tok = tok.lower()
                tok = "".join(c for c in unicodedata.normalize("NFD", tok)
                              if unicodedata.category(c) != "Mn")
            # split on punctuation
            cur = []
            for ch in tok:
                if _is_punctuation(ch):
                    if cur:
                        tokens.append("".join(cur))
                        cur = []
                    tokens.append(ch)
                else:
                    cur.append(ch)
            if cur:
                tokens.append("".join(cur))
        return tokens

    # --- wordpiece --------------------------------------------------------
    def _wordpiece(self, token: str) -> list[str]:
        if len(token) > self.max_chars:
            return [self.unk]
        out = []
        start = 0
        while start < len(token):
            end = len(token)
            piece = None
            while start < end:
                sub = token[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return [self.unk]
            out.append(piece)
            start = end
        return out

    def tokenize(self, text: str) -> list[str]:
        return [p for tok in self._basic_tokens(text) for p in self._wordpiece(tok)]

    def encode(self, text: str, max_length: int = 50) -> list[int]:
        ids = [self.vocab.get(t, self.vocab[self.unk]) for t in self.tokenize(text)]
        ids = ids[: max_length - 2]
        return [self.cls_id] + ids + [self.sep_id]

    def __call__(self, texts, max_length: int = 50):
        """-> {'input_ids': [N, max_length] i32, 'attention_mask': [N, max_length] i32},
        statically padded."""
        if isinstance(texts, str):
            texts = [texts]
        ids = np.full((len(texts), max_length), self.pad_id, dtype=np.int32)
        mask = np.zeros((len(texts), max_length), dtype=np.int32)
        for r, t in enumerate(texts):
            enc = self.encode(t, max_length)
            ids[r, : len(enc)] = enc
            mask[r, : len(enc)] = 1
        return {"input_ids": ids, "attention_mask": mask}
