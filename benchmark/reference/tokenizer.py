"""The released tokenizer's id layout and greedy decode (strhub/data/utils.py):
EOS = 0, the charset's characters 1..N, BOS = N + 1, PAD = N + 2; a read is
its characters before the first EOS."""

from __future__ import annotations

import numpy as np


class Ids:
    def __init__(self, charset):
        self.charset = charset
        self.eos, self.bos, self.pad = 0, len(charset) + 1, len(charset) + 2
        self.num_tokens = len(charset) + 3
        self.num_classes = len(charset) + 1  # BOS and PAD are never predicted

    def encode(self, labels, max_len):
        """[BOS, chars..., EOS, PAD...] of width max_len + 2, int64."""
        out = np.full((len(labels), max_len + 2), self.pad, np.int64)
        for n, label in enumerate(labels):
            ids = [1 + self.charset.index(c) for c in label[:max_len]]
            out[n, 0] = self.bos
            out[n, 1:1 + len(ids)] = ids
            out[n, 1 + len(ids)] = self.eos
        return out

    def decode(self, ids):
        """ids (B, n) -> the strings before each row's first EOS."""
        out = []
        for row in np.asarray(ids).tolist():
            end = row.index(self.eos) if self.eos in row else len(row)
            out.append(''.join(self.charset[i - 1] for i in row[:end]))
        return out
