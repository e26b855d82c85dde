"""Deterministic toy tokenizer with token CLASSES.

Words hash into a fixed vocab; dedicated id ranges mark ENTITY tokens
(capitalized words, numbers) and SENTENCE terminators so the §3.1.2 text
complexity terms (entities/sentence, token count) are computable from token
ids alone — standing in for a production NER pass, with the same statistics.
"""
from __future__ import annotations

import re
from typing import List, Tuple

import numpy as np

PAD_ID = 0
BOS_ID = 1
EOS_ID = 2
SENT_END_ID = 3  # ". ! ?"
ENTITY_BASE = 4  # entity/numeral tokens: [4, 4+ENTITY_RANGE)
ENTITY_RANGE = 996
WORD_BASE = 1000


class ToyTokenizer:
    def __init__(self, vocab_size: int = 32_000):
        assert vocab_size > WORD_BASE + 100
        self.vocab_size = vocab_size
        self._word_range = vocab_size - WORD_BASE

    def encode(self, text: str) -> List[int]:
        ids = [BOS_ID]
        for tok in re.findall(r"[A-Za-z]+|\d+|[.!?]", text):
            if tok in ".!?":
                ids.append(SENT_END_ID)
            elif tok[0].isupper() or tok.isdigit():
                ids.append(ENTITY_BASE + (hash(tok) % ENTITY_RANGE))
            else:
                ids.append(WORD_BASE + (hash(tok) % self._word_range))
        ids.append(EOS_ID)
        return ids

    @staticmethod
    def is_entity(ids: np.ndarray) -> np.ndarray:
        return (ids >= ENTITY_BASE) & (ids < ENTITY_BASE + ENTITY_RANGE)

    @staticmethod
    def is_sentence_end(ids: np.ndarray) -> np.ndarray:
        return ids == SENT_END_ID

    def pad(self, ids: List[int], length: int) -> np.ndarray:
        out = np.full((length,), PAD_ID, np.int32)
        out[: min(len(ids), length)] = ids[:length]
        return out
