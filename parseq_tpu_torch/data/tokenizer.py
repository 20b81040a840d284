"""Tokenizers mapping text labels <-> fixed-shape integer id arrays.

Token-id layout matches the reference exactly so converted PyTorch checkpoints
keep their head/embedding row alignment
(strhub/data/utils.py:102-150):

    Tokenizer    : EOS=0, chars=1..N, BOS=N+1, PAD=N+2
    CTCTokenizer : BLANK=0, chars=1..N

TPU-first difference: `encode` returns a *fixed-shape* array padded to
``max_label_length + 2`` (BOS + chars + EOS) instead of the reference's
batch-max `pad_sequence` — static shapes are required under jit, and
pad-id positions are ignored by every loss, so results are identical.
Decoding operates on host numpy (it's string post-processing, not compute).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from itertools import groupby

import numpy as np


class BaseTokenizer(ABC):

    def __init__(self, charset: str, specials_first: tuple = (), specials_last: tuple = ()) -> None:
        self._itos = specials_first + tuple(charset) + specials_last
        self._stoi = {s: i for i, s in enumerate(self._itos)}
        self._lut = np.asarray(self._itos, dtype=object)  # id -> token string
        self.charset = charset

    def __len__(self) -> int:
        return len(self._itos)

    def _tok2ids(self, tokens: str) -> list[int]:
        return [self._stoi[s] for s in tokens]

    def _ids2tok(self, token_ids, join: bool = True):
        tokens = [self._itos[int(i)] for i in token_ids]
        return ''.join(tokens) if join else tokens

    @abstractmethod
    def encode(self, labels: list[str], max_label_length: int) -> np.ndarray:
        """Encode a batch of labels into a fixed-shape id array ``(N, L)``."""
        raise NotImplementedError

    @abstractmethod
    def _filter(self, probs: np.ndarray, ids: np.ndarray) -> tuple[np.ndarray, list[int]]:
        """Filtering applied prior to decoding (EOS truncation / CTC dedupe)."""
        raise NotImplementedError

    def decode(self, token_dists: np.ndarray, raw: bool = False) -> tuple[list, list[np.ndarray]]:
        """Decode a batch of token probability distributions ``(N, L, C)``.

        Greedy per-position argmax, then tokenizer-specific filtering
        (reference semantics: strhub/data/utils.py:79-99).
        argmax/gather run batched (one numpy pass over (N, L, C)) — the
        per-sample loop version was host-bound at high device throughput.
        """
        token_dists = np.asarray(token_dists)
        ids = token_dists.argmax(-1)  # (N, L)
        probs = np.take_along_axis(token_dists, ids[..., None], axis=-1)[..., 0]
        return self.decode_ids(ids, probs, raw=raw)

    def decode_ids(self, ids: np.ndarray, probs: np.ndarray,
                   raw: bool = False) -> tuple[list, list[np.ndarray]]:
        """Decode pre-argmaxed ids (N, L) with their picked probs (N, L).

        Lets device-side post-processing (softmax + argmax + gather on TPU)
        transfer ~100x less than the full (N, L, C) distribution tensor."""
        ids = np.asarray(ids)
        probs = np.asarray(probs)
        if raw:
            return [self._ids2tok(row, False) for row in ids], list(probs)
        return self._decode_batch(probs, ids)

    def _decode_batch(self, probs: np.ndarray, ids: np.ndarray) -> tuple[list, list[np.ndarray]]:
        """Default batched filter: per-row _filter. Subclasses vectorize."""
        batch_tokens, batch_probs = [], []
        for p_row, id_row in zip(probs, ids):
            p, i = self._filter(p_row, id_row)
            batch_tokens.append(self._ids2tok(i))
            batch_probs.append(p)
        return batch_tokens, batch_probs


class Tokenizer(BaseTokenizer):
    """BOS/EOS/PAD tokenizer for autoregressive / parallel seq2seq decoding."""

    BOS = '[B]'
    EOS = '[E]'
    PAD = '[P]'

    def __init__(self, charset: str) -> None:
        specials_first = (self.EOS,)
        specials_last = (self.BOS, self.PAD)
        super().__init__(charset, specials_first, specials_last)
        self.eos_id = self._stoi[self.EOS]
        self.bos_id = self._stoi[self.BOS]
        self.pad_id = self._stoi[self.PAD]

    def encode(self, labels: list[str], max_label_length: int) -> np.ndarray:
        """-> int32 ``(N, max_label_length + 2)``: [BOS, chars..., EOS, PAD...]."""
        L = max_label_length + 2
        out = np.full((len(labels), L), self.pad_id, dtype=np.int32)
        for n, label in enumerate(labels):
            ids = self._tok2ids(label)[: max_label_length]
            out[n, 0] = self.bos_id
            out[n, 1 : 1 + len(ids)] = ids
            out[n, 1 + len(ids)] = self.eos_id
        return out

    def _filter(self, probs: np.ndarray, ids: np.ndarray) -> tuple[np.ndarray, list[int]]:
        ids = ids.tolist()
        try:
            eos_idx = ids.index(self.eos_id)
        except ValueError:
            eos_idx = len(ids)
        # Truncate after EOS, but keep the EOS probability itself.
        return probs[: eos_idx + 1], ids[:eos_idx]

    def _decode_batch(self, probs: np.ndarray, ids: np.ndarray) -> tuple[list, list[np.ndarray]]:
        """Vectorized EOS truncation: one batched eos-position computation,
        then cheap per-row slicing/joining over <= max_label_length chars."""
        N, L = ids.shape
        is_eos = ids == self.eos_id
        eos_pos = np.where(is_eos.any(axis=1), is_eos.argmax(axis=1), L)
        tokens = [''.join(self._lut[row[:e]]) for row, e in zip(ids, eos_pos)]
        # keep the EOS probability itself (confidence includes p(EOS))
        batch_probs = [p[: e + 1] for p, e in zip(probs, eos_pos)]
        return tokens, batch_probs


class CTCTokenizer(BaseTokenizer):
    """BLANK-based tokenizer for CTC models (CRNN, TRBC)."""

    BLANK = '[B]'

    def __init__(self, charset: str) -> None:
        super().__init__(charset, specials_first=(self.BLANK,))
        self.blank_id = self._stoi[self.BLANK]

    def encode(self, labels: list[str], max_label_length: int) -> np.ndarray:
        """-> int32 ``(N, max_label_length)`` padded with BLANK (=0)."""
        out = np.full((len(labels), max_label_length), self.blank_id, dtype=np.int32)
        for n, label in enumerate(labels):
            ids = self._tok2ids(label)[:max_label_length]
            out[n, : len(ids)] = ids
        return out

    def lengths(self, labels: list[str], max_label_length: int) -> np.ndarray:
        return np.asarray([min(len(y), max_label_length) for y in labels], dtype=np.int32)

    def _filter(self, probs: np.ndarray, ids: np.ndarray) -> tuple[np.ndarray, list[int]]:
        # Best-path decode: collapse repeats, then drop blanks.
        ids = [k for k, _ in groupby(ids.tolist())]
        ids = [x for x in ids if x != self.blank_id]
        return probs, ids

    def _decode_batch(self, probs: np.ndarray, ids: np.ndarray) -> tuple[list, list[np.ndarray]]:
        """Vectorized best-path decode: repeat-collapse and blank-drop as one
        batched boolean mask (position kept iff it differs from its left
        neighbor and is not blank), then per-row joins."""
        N, L = ids.shape
        prev = np.concatenate([np.full((N, 1), -1, ids.dtype), ids[:, :-1]], axis=1)
        keep = (ids != prev) & (ids != self.blank_id)
        tokens = [''.join(self._lut[row[k]]) for row, k in zip(ids, keep)]
        return tokens, list(probs)
