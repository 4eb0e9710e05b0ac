"""Byte-level BPE tokenizer: train, encode, decode, save/load.

This package's own copy of `diffusion_llm_rs_tpu/tokenizer/bpe.py` (the JAX
package's module binds a native merge loop from its own tree; this one is
pure Python): the same merges, ids and files, so a tokenizer saved by either
package loads in the other. The base alphabet is the 256 bytes, so encoding
never needs an unknown token; merges are learned on top, and the special
tokens (`[PAD]`, `[EOS]`, `[BOS]`) sit at the top of the vocabulary.
"""

from __future__ import annotations

import json
import re
from collections import Counter
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# Word-ish pretokenization: runs of letters/digits (with a leading space glued
# on, GPT-2 style) or a single other character.
_PRETOKEN_RE = re.compile(r" ?[A-Za-z]+| ?[0-9]+| ?[^\sA-Za-z0-9]+|\s+")

DEFAULT_SPECIAL_TOKENS = ("[PAD]", "[EOS]", "[BOS]")


class BPETokenizer:
    """Byte-level BPE. Token ids: [0, 256) = raw bytes, then merges, then
    special tokens at the top of the vocab."""

    def __init__(self, merges: Sequence[Tuple[int, int]],
                 special_tokens: Sequence[str] = DEFAULT_SPECIAL_TOKENS):
        self.merges: List[Tuple[int, int]] = [tuple(m) for m in merges]
        self.special_tokens: List[str] = list(special_tokens)
        self._merge_ranks: Dict[Tuple[int, int], int] = {
            m: i for i, m in enumerate(self.merges)}
        base = 256 + len(self.merges)
        self._special_ids: Dict[str, int] = {
            tok: base + i for i, tok in enumerate(self.special_tokens)}
        # byte sequence of every id (for decode)
        self._id_bytes: List[bytes] = [bytes([b]) for b in range(256)]
        for a, b in self.merges:
            self._id_bytes.append(self._id_bytes[a] + self._id_bytes[b])

    # -- properties ---------------------------------------------------------

    @property
    def vocab_size(self) -> int:
        return 256 + len(self.merges) + len(self.special_tokens)

    @property
    def pad_id(self) -> int:
        return self._special_ids["[PAD]"]

    @property
    def eos_id(self) -> int:
        return self._special_ids["[EOS]"]

    def token_to_id(self, token: str) -> Optional[int]:
        if token in self._special_ids:
            return self._special_ids[token]
        data = token.encode("utf-8")
        for i, b in enumerate(self._id_bytes):
            if b == data:
                return i
        return None

    def id_to_token(self, idx: int) -> str:
        if idx < 256 + len(self.merges):
            return self._id_bytes[idx].decode("utf-8", errors="replace")
        rel = idx - (256 + len(self.merges))
        if 0 <= rel < len(self.special_tokens):
            return self.special_tokens[rel]
        raise ValueError(f"id {idx} out of range (vocab {self.vocab_size})")

    # -- encode / decode ----------------------------------------------------

    def _bpe_word(self, word_bytes: bytes) -> List[int]:
        ids = list(word_bytes)
        while len(ids) >= 2:
            best_rank, best_pos = None, -1
            for i in range(len(ids) - 1):
                r = self._merge_ranks.get((ids[i], ids[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_pos = r, i
            if best_rank is None:
                break
            pair = (ids[best_pos], ids[best_pos + 1])
            merged = 256 + best_rank
            # merge every occurrence of this pair in one sweep
            out, i = [], 0
            while i < len(ids):
                if i < len(ids) - 1 and (ids[i], ids[i + 1]) == pair:
                    out.append(merged)
                    i += 2
                else:
                    out.append(ids[i])
                    i += 1
            ids = out
        return ids

    def encode(self, text: str, add_eos: bool = False) -> List[int]:
        ids: List[int] = []
        for m in _PRETOKEN_RE.finditer(text):
            ids.extend(self._bpe_word(m.group().encode("utf-8")))
        if add_eos:
            ids.append(self.eos_id)
        return ids

    def decode(self, ids: Iterable[int], skip_special: bool = True) -> str:
        data = bytearray()
        n_base = 256 + len(self.merges)
        for i in ids:
            i = int(i)
            if i >= n_base:
                if not skip_special:
                    data.extend(self.id_to_token(i).encode("utf-8"))
                continue
            data.extend(self._id_bytes[i])
        return data.decode("utf-8", errors="replace")

    # -- persistence --------------------------------------------------------

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"merges": self.merges,
                       "special_tokens": self.special_tokens}, f)

    @classmethod
    def load(cls, path: str) -> "BPETokenizer":
        with open(path) as f:
            d = json.load(f)
        return cls([tuple(m) for m in d["merges"]], d["special_tokens"])

    # -- training -----------------------------------------------------------

    @classmethod
    def train(cls, texts: Iterable[str], vocab_size: int,
              special_tokens: Sequence[str] = DEFAULT_SPECIAL_TOKENS
              ) -> "BPETokenizer":
        """Classic BPE training: repeatedly merge the most frequent pair."""
        num_merges = max(vocab_size - 256 - len(special_tokens), 0)
        word_freqs: Counter = Counter()
        for text in texts:
            for m in _PRETOKEN_RE.finditer(text):
                word_freqs[m.group().encode("utf-8")] += 1
        words: List[List[int]] = [list(w) for w in word_freqs]
        freqs: List[int] = list(word_freqs.values())

        merges: List[Tuple[int, int]] = []
        next_id = 256
        for _ in range(num_merges):
            pair_counts: Counter = Counter()
            for w, f in zip(words, freqs):
                for i in range(len(w) - 1):
                    pair_counts[(w[i], w[i + 1])] += f
            if not pair_counts:
                break
            (a, b), cnt = pair_counts.most_common(1)[0]
            if cnt < 2:
                break
            merges.append((a, b))
            for w in words:
                i, out = 0, []
                while i < len(w):
                    if i < len(w) - 1 and w[i] == a and w[i + 1] == b:
                        out.append(next_id)
                        i += 2
                    else:
                        out.append(w[i])
                        i += 1
                w[:] = out
            next_id += 1
        return cls(merges, special_tokens)
