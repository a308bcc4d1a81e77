"""CLIP byte-level BPE tokenizer (host side).

The port's copy of ``tricolo_tpu.clip.tokenizer``: ``clip.tokenize`` as the
reference uses it for the CLIP text encoder's inputs (context length 77,
truncation that keeps the EOT token, SOT/EOT framing). The merges file is
OpenAI CLIP's ``bpe_simple_vocab_16e6.txt.gz`` (gzip or plain text); its
path comes from the ``bpe_path`` argument or the ``TRICOLO_CLIP_BPE``
environment variable. None ships with the repository and nothing is
downloaded.

The construction is the standard byte-level BPE: UTF-8 bytes map to
printable unicode, words split by the CLIP pattern, merges applied by
rank; the vocabulary is the 256 byte symbols, their 256 ``</w>`` variants,
one entry per merge, then SOT and EOT.
"""

from __future__ import annotations

import gzip
import html
import os
import re
from functools import lru_cache

import numpy as np

CONTEXT_LENGTH = 77

# CLIP's pattern uses \p{L}/\p{N}; stdlib `re` approximates them with
# Unicode-aware classes: [^\W\d_]+ ≈ \p{L}+, \d ≈ [\p{N}], and the
# punctuation bucket is everything that is neither whitespace nor
# word-ish (plus the underscore \w wrongly absorbs).
_WORD_RE = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
    r"|[^\W\d_]+|\d|(?:[^\s\w]|_)+",
    re.IGNORECASE | re.UNICODE,
)


@lru_cache()
def _bytes_to_unicode() -> dict[int, str]:
    """Invertible byte → printable-unicode map (GPT-2/CLIP construction)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return re.sub(r"\s+", " ", text).strip().lower()


class ClipTokenizer:
    """Caption → (context_length,) int32 CLIP token ids."""

    def __init__(self, bpe_path: str | None = None):
        bpe_path = bpe_path or os.environ.get("TRICOLO_CLIP_BPE")
        if not bpe_path or not os.path.exists(bpe_path):
            raise FileNotFoundError(
                "CLIP BPE merges file not found. Point TRICOLO_CLIP_BPE (or the "
                "bpe_path argument) at bpe_simple_vocab_16e6.txt.gz from the "
                "OpenAI CLIP release."
            )
        opener = gzip.open if bpe_path.endswith(".gz") else open
        with opener(bpe_path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        # CLIP's file: a version header, then the merges (1..48894 used).
        merges = [tuple(line.split()) for line in lines[1 : 49152 - 256 - 2 + 1]
                  if line.strip()]
        self.byte_encoder = _bytes_to_unicode()
        vocab = list(self.byte_encoder.values())
        vocab += [f"{v}</w>" for v in vocab]
        vocab += ["".join(m) for m in merges]
        vocab += ["<|startoftext|>", "<|endoftext|>"]
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]
        self._cache: dict[str, list[str]] = {}

    def _bpe(self, token: str) -> list[str]:
        if token in self._cache:
            return self._cache[token]
        word = list(token[:-1]) + [token[-1] + "</w>"]
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            merged = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and (word[i], word[i + 1]) == best:
                    merged.append(word[i] + word[i + 1])
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        self._cache[token] = word
        return word

    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        for word in _WORD_RE.findall(_basic_clean(text)):
            word_bytes = "".join(self.byte_encoder[b] for b in word.encode("utf-8"))
            ids.extend(self.encoder[piece] for piece in self._bpe(word_bytes))
        return ids

    def __call__(self, text: str, context_length: int = CONTEXT_LENGTH,
                 truncate: bool = True) -> np.ndarray:
        """SOT + tokens + EOT, zero-padded to ``context_length`` (int32); a
        longer caption is cut with its last id replaced by EOT, or raises
        ValueError without ``truncate``."""
        ids = [self.sot, *self.encode(text), self.eot]
        if len(ids) > context_length:
            if not truncate:
                raise ValueError(f"caption longer than context {context_length}")
            ids = ids[:context_length]
            ids[-1] = self.eot
        out = np.zeros(context_length, dtype=np.int32)
        out[: len(ids)] = ids
        return out
