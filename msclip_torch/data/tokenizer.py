"""CLIP byte-pair-encoding tokenizer (port of ``msclip_tpu/data/tokenizer.py``).

The semantics of the reference MS-CLIP ``SimpleTokenizer``
(``lib/dataset/languages/simple_tokenizer.py:66-226``): byte-level BPE over
the public ``bpe_simple_vocab_16e6`` merge table (vocab 49408), ftfy+html
text cleaning, lowercasing, SOT/EOT framing, zero-padding and silent
truncation at the context length. Emits int32 numpy arrays: tokenization
runs on the host, and the device part of the text path starts at the
embedding lookup.

The word pattern uses the standard library's ``re``: the third-party
``regex`` package (``\\p{L}``, ``\\p{N}``) is not required. The letter and
number classes are built once from ``unicodedata`` categories (L* and N*),
so they select the same characters as ``\\p{L}`` and ``\\p{N}`` up to the
Unicode version of each library.
"""

from __future__ import annotations

import functools
import gzip
import html
import os
import re
import sys
import unicodedata
from typing import List, Union

import numpy as np

DEFAULT_BPE_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)),
    "assets",
    "bpe_simple_vocab_16e6.txt.gz",
)

try:  # ftfy is optional in this environment; gate it (reference requires it)
    import ftfy

    def _fix_text(text: str) -> str:
        return ftfy.fix_text(text)

except ImportError:  # pragma: no cover - depends on environment

    def _fix_text(text: str) -> str:
        # Fallback: NFC normalization covers ftfy's effect on well-formed
        # input (prompt templates and classnames are ASCII, where ftfy is
        # the identity).
        return unicodedata.normalize("NFC", text)


@functools.lru_cache()
def byte_to_unicode_table() -> dict:
    """Reversible byte -> printable-unicode map used by byte-level BPE.

    Printable latin bytes map to themselves; the remaining 68 bytes map to
    256+n so no token string ever contains whitespace/control characters.
    """
    printable = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    table = {b: chr(b) for b in printable}
    offset = 0
    for b in range(256):
        if b not in table:
            table[b] = chr(256 + offset)
            offset += 1
    return table


@functools.lru_cache()
def _category_class(major: str) -> str:
    """``re`` character-class body matching every code point whose Unicode
    general category starts with ``major`` ('L' letters, 'N' numbers)."""
    parts, start = [], None
    for cp in range(sys.maxunicode + 2):
        hit = (cp <= sys.maxunicode
               and unicodedata.category(chr(cp))[0] == major)
        if hit and start is None:
            start = cp
        elif not hit and start is not None:
            lo, hi = re.escape(chr(start)), re.escape(chr(cp - 1))
            parts.append(lo if start == cp - 1 else f"{lo}-{hi}")
            start = None
    return "".join(parts)


@functools.lru_cache()
def word_pattern() -> "re.Pattern":
    letters, numbers = _category_class("L"), _category_class("N")
    return re.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
        rf"|[{letters}]+|[{numbers}]|[^\s{letters}{numbers}]+",
        re.IGNORECASE,
    )


def _clean(text: str) -> str:
    text = _fix_text(text)
    text = html.unescape(html.unescape(text))
    text = re.sub(r"\s+", " ", text.strip())
    return text.strip()


class ClipTokenizer:
    """Byte-level BPE tokenizer with the CLIP vocab (49408 entries).

    Vocab layout: 256 byte symbols, 256 byte symbols + '</w>', 48894 merge
    results, then '<|startoftext|>' and '<|endoftext|>'.
    """

    def __init__(self, bpe_path: str = DEFAULT_BPE_PATH):
        self.byte_encoder = byte_to_unicode_table()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}

        with gzip.open(bpe_path) as f:
            lines = f.read().decode("utf-8").split("\n")
        # Line 0 is a header; the CLIP vocab uses the first
        # 49152-256-2 = 48894 merges.
        merge_lines = lines[1 : 49152 - 256 - 2 + 1]
        merges = [tuple(line.split()) for line in merge_lines]

        symbols = list(self.byte_encoder.values())
        vocab = symbols + [s + "</w>" for s in symbols]
        vocab += ["".join(pair) for pair in merges]
        vocab += ["<|startoftext|>", "<|endoftext|>"]

        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.merge_rank = {pair: i for i, pair in enumerate(merges)}
        self.sot_token = self.encoder["<|startoftext|>"]
        self.eot_token = self.encoder["<|endoftext|>"]
        self._bpe_cache = {
            "<|startoftext|>": ["<|startoftext|>"],
            "<|endoftext|>": ["<|endoftext|>"],
        }

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    # -- core BPE ----------------------------------------------------------
    def _bpe(self, token: str) -> List[str]:
        """Greedily merge the lowest-ranked adjacent pair until none apply."""
        cached = self._bpe_cache.get(token)
        if cached is not None:
            return cached

        parts = list(token[:-1]) + [token[-1] + "</w>"]
        if len(parts) == 1:
            return parts

        while len(parts) > 1:
            pairs = [(parts[i], parts[i + 1]) for i in range(len(parts) - 1)]
            ranked = min(
                pairs, key=lambda p: self.merge_rank.get(p, float("inf"))
            )
            if ranked not in self.merge_rank:
                break
            first, second = ranked
            merged: List[str] = []
            i = 0
            while i < len(parts):
                if (
                    i < len(parts) - 1
                    and parts[i] == first
                    and parts[i + 1] == second
                ):
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged

        self._bpe_cache[token] = parts
        return parts

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        text = _clean(text).lower()
        for word in word_pattern().findall(text):
            word_bytes = "".join(self.byte_encoder[b] for b in word.encode("utf-8"))
            ids.extend(self.encoder[part] for part in self._bpe(word_bytes))
        return ids

    def decode(self, ids) -> str:
        text = "".join(self.decoder[int(i)] for i in ids)
        raw = bytearray(self.byte_decoder[ch] for ch in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")

    # -- batch API -----------------------------------------------------------
    def tokenize(
        self, texts: Union[str, List[str]], context_length: int = 77
    ) -> np.ndarray:
        """Tokenize to a zero-padded ``[N, context_length]`` int32 array.

        Sequences longer than ``context_length`` are silently truncated
        (reference behavior, simple_tokenizer.py:163-167 — the EOT token may
        be cut off; eot-argmax pooling then picks the largest remaining id).
        """
        if isinstance(texts, str):
            texts = [texts]
        result = np.zeros((len(texts), context_length), dtype=np.int32)
        for i, text in enumerate(texts):
            ids = [self.sot_token] + self.encode(text) + [self.eot_token]
            ids = ids[:context_length]
            result[i, : len(ids)] = ids
        return result

    def encode_with_idx(self, text: str, input_idxs: List[int]):
        """Encode while tracking how word positions shift as words split
        into multiple BPE tokens (reference ``encode_with_idx``
        ``:171-201``); returns (token ids, adjusted indices)."""
        cleaned = _clean(text).lower()
        parsed = word_pattern().findall(cleaned)
        input_idxs = list(input_idxs)
        if not (len(cleaned.split(" ")) == len(text.split(" "))
                == len(parsed)):
            # re-anchor indices to the parsed word list
            for ii, input_id in enumerate(input_idxs):
                refer = text.split(" ")[input_id]
                if len(refer.split("-")) != 1:
                    refer = refer.split("-")[-1]
                hits = [pi for pi, w in enumerate(parsed) if w == refer]
                if len(hits) != 1 and hits:
                    dist = [(h - input_id) ** 2 for h in hits]
                    input_idxs[ii] = hits[dist.index(min(dist))]
                elif hits:
                    input_idxs[ii] = hits[0]

        ids: List[int] = []
        added = [0] * len(input_idxs)
        for token_idx, word in enumerate(parsed):
            word_bytes = "".join(
                self.byte_encoder[b] for b in word.encode("utf-8")
            )
            parts = self._bpe(word_bytes)
            if len(parts) > 1:
                extra = len(parts) - 1
                for ii, orig in enumerate(input_idxs):
                    if token_idx <= orig:
                        added[ii] += extra
            ids.extend(self.encoder[p] for p in parts)
        return ids, [a + i for a, i in zip(added, input_idxs)]

    def tokenize_with_idx(self, texts, context_length: int = 77,
                          input_idxs=None):
        """Single-text tokenize that also returns the token positions of
        the requested word indices (+1 for the SOT shift); reference
        ``tokenize_with_idx`` ``:203-222``."""
        if isinstance(texts, str):
            texts = [texts]
        assert len(texts) == 1
        ids, out_idxs = self.encode_with_idx(texts[0], input_idxs or [])
        ids = [self.sot_token] + ids + [self.eot_token]
        out_idxs = [i + 1 for i in out_idxs]
        result = np.zeros((1, context_length), dtype=np.int32)
        ids = ids[:context_length]
        result[0, : len(ids)] = ids
        return result, out_idxs

    def __call__(
        self, texts: Union[str, List[str]], context_length: int = 77
    ) -> np.ndarray:
        return self.tokenize(texts, context_length)



# Alias matching the reference public name (SimpleTokenizer).
SimpleTokenizer = ClipTokenizer
