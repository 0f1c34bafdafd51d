"""GPT-2 byte-level BPE tokenizer (the OPT family's tokenizer), in plain Python.

The port's own copy of trajectorycrafter_tpu/utils/bpe.py (it imports nothing
of the JAX package).  The BLIP-2 captioner's OPT decoder emits GPT-2 BPE ids;
decoding them needs the checkpoint's ``vocab.json`` + ``merges.txt``.  No
tokenizer package: this is the published byte-level BPE algorithm (GPT-2's
encoder.py) -- a bytes<->unicode visible-character bijection, merge ranks
for encoding, and direct table lookup for decoding.
"""

from __future__ import annotations

import json
import os
from functools import lru_cache
from typing import Dict, List, Tuple


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """The GPT-2 byte<->unicode bijection: printable bytes map to themselves,
    the rest to code points starting at 256."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


class GPT2BPETokenizer:
    def __init__(self, vocab: Dict[str, int], merges: List[Tuple[str, str]],
                 special_tokens: Dict[str, int] | None = None):
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.special = dict(special_tokens or {})
        self.special_ids = set(self.special.values())
        self._cache: Dict[str, str] = {}

    @classmethod
    def from_dir(cls, path: str) -> "GPT2BPETokenizer":
        """Load from an HF checkpoint dir (vocab.json + merges.txt [+
        special_tokens_map.json])."""
        with open(os.path.join(path, "vocab.json"), encoding="utf-8") as f:
            vocab = json.load(f)
        merges = []
        with open(os.path.join(path, "merges.txt"), encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#version"):
                    continue
                a, b = line.split()
                merges.append((a, b))
        special: Dict[str, int] = {}
        sp_path = os.path.join(path, "special_tokens_map.json")
        if os.path.isfile(sp_path):
            with open(sp_path, encoding="utf-8") as f:
                smap = json.load(f)
            for v in smap.values():
                tok = v["content"] if isinstance(v, dict) else v
                if tok in vocab:
                    special[tok] = vocab[tok]
        return cls(vocab, merges, special)

    # -- encoding ------------------------------------------------------------

    def _bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            first, second = best
            new_word: List[str] = []
            i = 0
            while i < len(word):
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def _split_words(self, text: str) -> List[str]:
        """GPT-2's pre-tokenization regex, implemented directly: contraction
        suffixes, letter runs, digit runs, other-symbol runs (each of the
        last three absorbing one leading space), and whitespace runs that
        leave their last space to the following token."""
        import re

        # \p{L} -> [^\W\d_]; \p{N} -> \d; [^\s\p{L}\p{N}] -> [^\s\w]|_ (the
        # symbol class must keep '_', which python's \w wrongly claims)
        pat = re.compile(
            r"'s|'t|'re|'ve|'m|'ll|'d| ?[^\W\d_]+| ?\d+| ?(?:[^\s\w]|_)+|\s+(?!\S)|\s+",
            re.UNICODE,
        )
        return pat.findall(text)

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for word in self._split_words(text):
            mapped = "".join(self.byte_encoder[b] for b in word.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(mapped).split(" "))
        return ids

    # -- decoding ------------------------------------------------------------

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        toks = []
        for i in ids:
            i = int(i)
            if skip_special_tokens and i in self.special_ids:
                continue
            toks.append(self.decoder.get(i, ""))
        text = "".join(toks)
        data = bytes(self.byte_decoder[c] for c in text if c in self.byte_decoder)
        return data.decode("utf-8", errors="replace")
