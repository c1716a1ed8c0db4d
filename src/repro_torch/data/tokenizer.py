"""Deterministic hash-vocabulary tokenizer (copy of ``src/repro/data/tokenizer.py``).

No pretrained vocab files exist offline, so the tokenizer maps words to ids
with a stable FNV-1a hash. Vocabulary layout (shared with models/colbert.py):

    0..7    special:  [PAD] [CLS] [SEP] [MASK] [Q] [D] [UNK] [BOS]
    8..23   punctuation bucket (ColBERT's doc skiplist masks these)
    24..V   hashed word ids

Deterministic across processes/runs — the multi-host pipeline relies on it.
"""
from __future__ import annotations

import re
from typing import List

import numpy as np

PAD_ID, CLS_ID, SEP_ID, MASK_ID, Q_MARK_ID, D_MARK_ID, UNK_ID, BOS_ID = \
    range(8)
N_SPECIAL = 8
N_PUNCT = 16
FIRST_WORD_ID = N_SPECIAL + N_PUNCT

_PUNCT = ".,;:!?()[]{}\"'`-—/\\"
_TOKEN_RE = re.compile(r"[\w]+|[^\w\s]")


def _fnv1a(s: str) -> int:
    h = 0xcbf29ce484222325
    for b in s.encode("utf-8"):
        h ^= b
        h = (h * 0x100000001b3) & 0xFFFFFFFFFFFFFFFF
    return h


class HashTokenizer:
    def __init__(self, vocab_size: int = 30522):
        assert vocab_size > FIRST_WORD_ID + 1
        self.vocab_size = vocab_size
        self.n_words = vocab_size - FIRST_WORD_ID

    def word_id(self, w: str) -> int:
        return FIRST_WORD_ID + _fnv1a(w.lower()) % self.n_words

    def punct_id(self, ch: str) -> int:
        i = _PUNCT.find(ch)
        return N_SPECIAL + (i % N_PUNCT if i >= 0 else 0)

    def encode(self, text: str, max_len: int | None = None) -> List[int]:
        ids = []
        for tok in _TOKEN_RE.findall(text):
            if tok[0].isalnum() or tok[0] == "_":
                ids.append(self.word_id(tok))
            else:
                ids.append(self.punct_id(tok[0]))
            if max_len and len(ids) >= max_len:
                break
        return ids

    def encode_batch(self, texts: List[str], max_len: int) -> np.ndarray:
        out = np.zeros((len(texts), max_len), np.int32)
        for i, t in enumerate(texts):
            ids = self.encode(t, max_len)
            out[i, :len(ids)] = ids
        return out
