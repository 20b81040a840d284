"""Charset handling.

Behavioral parity with the reference CharsetAdapter
(strhub/data/utils.py:26-42): case folding when the target
charset is single-case, plus regex removal of unsupported characters.
"""

from __future__ import annotations

import re

# The three canonical charsets (reference configs/charset/*.yaml).
CHARSET_36 = '0123456789abcdefghijklmnopqrstuvwxyz'
CHARSET_62 = '0123456789abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ'
CHARSET_94 = (
    '0123456789abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ'
    '!"#$%&\'()*+,-./:;<=>?@[\\]^_`{|}~'
)

CHARSETS = {'36_lowercase': CHARSET_36, '62_mixed-case': CHARSET_62, '94_full': CHARSET_94}


class CharsetAdapter:
    """Transforms labels according to the target charset."""

    def __init__(self, target_charset: str) -> None:
        self.lowercase_only = target_charset == target_charset.lower()
        self.uppercase_only = target_charset == target_charset.upper()
        self.unsupported = re.compile(f'[^{re.escape(target_charset)}]')

    def __call__(self, label: str) -> str:
        if self.lowercase_only:
            label = label.lower()
        elif self.uppercase_only:
            label = label.upper()
        return self.unsupported.sub('', label)
