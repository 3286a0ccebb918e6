"""CLIP's byte-level BPE tokenizer over a local ``vocab.json`` and ``merges.txt``.

Stands in for transformers' ``CLIPTokenizer`` (slow, without ``ftfy``), which
the JAX package loads: the same ids, padded to ``model_max_length`` (77).

- Text is cleaned as transformers' ``BasicTokenizer(strip_accents=False,
  do_split_on_punc=False)`` does without ftfy: control characters dropped,
  whitespace normalised, spaces around CJK ideographs, NFC, lower case.
- The special tokens (bos ``<|startoftext|>``, eos and unk ``<|endoftext|>``, and
  the pad token) are split out of the text first and map to their ids whole.
  The pad token differs by model: SD-v1.5's tokenizer pads with
  ``<|endoftext|>``, OpenCLIP-H's (I2VGen-XL) and SDXL's ``tokenizer_2`` with
  ``!``. It is read from ``special_tokens_map.json`` over
  ``tokenizer_config.json``, as transformers reads it.
- The rest is split with CLIP's pattern. transformers uses the ``regex``
  package's ``\\p{L}`` and ``\\p{N}``; Python's ``re`` has neither, and the
  classes below agree with them on letters and decimal digits. They differ on
  numerals that are not decimal digits (``²``, ``½``, Roman numerals), which
  ``re`` counts as letters and ``regex`` as numbers.
- BPE merges as in ``CLIPTokenizer.bpe``: the first line of ``merges.txt`` is
  skipped and at most 48894 merges are read.
"""

from __future__ import annotations

import json
import os
import re
import unicodedata
from functools import lru_cache
from typing import Dict, List, Sequence, Tuple

import torch

# \p{L}+ | \p{N} | [^\s\p{L}\p{N}]+ without the regex package: a "letter" is a
# word character that is no decimal digit and no underscore
_PAT = re.compile(r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[^\W\d_]+|\d|"""
                  r"""(?:[^\s\w]|_)+""", re.IGNORECASE)


@lru_cache
def bytes_to_unicode() -> Dict[int, str]:
    """CLIP's reversible map of the 256 byte values to printable characters."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF or 0x20000 <= cp <= 0x2A6DF
            or 0x2A700 <= cp <= 0x2B73F or 0x2B740 <= cp <= 0x2B81F
            or 0x2B820 <= cp <= 0x2CEAF or 0xF900 <= cp <= 0xFAFF
            or 0x2F800 <= cp <= 0x2FA1F)


def basic_clean(text: str) -> str:
    """transformers' ``BasicTokenizer.tokenize`` at CLIP's settings, joined by spaces."""
    out = []
    for ch in text:
        cp = ord(ch)
        if ch in "\t\n\r" or unicodedata.category(ch) == "Zs":
            out.append(" ")
        elif cp == 0 or cp == 0xFFFD or unicodedata.category(ch).startswith("C"):
            continue
        elif _is_cjk(cp):
            out.append(f" {ch} ")
        else:
            out.append(ch)
    text = unicodedata.normalize("NFC", "".join(out))
    return " ".join(tok.lower() for tok in text.split())


def _special(value) -> str:
    return value["content"] if isinstance(value, dict) else value


class CLIPTokenizer:
    def __init__(self, vocab: Dict[str, int], merges: Sequence[Tuple[str, str]],
                 bos_token: str = "<|startoftext|>", eos_token: str = "<|endoftext|>",
                 unk_token: str = "<|endoftext|>", pad_token: str = "<|endoftext|>",
                 model_max_length: int = 77):
        self.encoder = vocab
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.bos_token, self.eos_token, self.unk_token, self.pad_token = (
            bos_token, eos_token, unk_token, pad_token)
        self.model_max_length = model_max_length
        specials = sorted({bos_token, eos_token, unk_token, pad_token}, key=len, reverse=True)
        self._split = re.compile("(" + "|".join(re.escape(s) for s in specials) + ")")
        self._specials = set(specials)
        self.cache = {"<|startoftext|>": "<|startoftext|>", "<|endoftext|>": "<|endoftext|>"}

    @classmethod
    def from_pretrained(cls, path: str) -> "CLIPTokenizer":
        """Read a tokenizer folder (``vocab.json``, ``merges.txt``,
        ``tokenizer_config.json``, ``special_tokens_map.json``)."""
        def read_json(name):
            p = os.path.join(path, name)
            if not os.path.exists(p):
                return {}
            with open(p, encoding="utf-8") as fh:
                return json.load(fh)

        with open(os.path.join(path, "vocab.json"), encoding="utf-8") as fh:
            vocab = json.load(fh)
        with open(os.path.join(path, "merges.txt"), encoding="utf-8") as fh:
            lines = fh.read().strip().split("\n")
        merges = [tuple(m.split()) for m in lines[1:49152 - 256 - 2 + 1]]
        config = read_json("tokenizer_config.json")
        specials = {**config, **read_json("special_tokens_map.json")}
        kwargs = {k: _special(specials[k]) for k in
                  ("bos_token", "eos_token", "unk_token", "pad_token") if specials.get(k)}
        return cls(vocab, merges, model_max_length=int(config.get("model_max_length", 77)),
                   **kwargs)

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word, word[1:]))
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            merged, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def _token_id(self, token: str) -> int:
        return self.encoder.get(token, self.encoder.get(self.unk_token))

    def tokenize(self, text: str) -> List[str]:
        tokens = []
        for part in self._split.split(text):
            if part in self._specials:
                tokens.append(part)
            elif part:
                for piece in _PAT.findall(basic_clean(part)):
                    piece = "".join(self.byte_encoder[b] for b in piece.encode("utf-8"))
                    tokens.extend(self.bpe(piece).split(" "))
        return tokens

    def __call__(self, texts: Sequence[str]) -> torch.Tensor:
        """(n, model_max_length) int64 ids: bos, the first ``model_max_length - 2``
        tokens, eos, then the pad id."""
        n = self.model_max_length
        rows = []
        for text in texts:
            ids = [self._token_id(t) for t in self.tokenize(text)][: n - 2]
            ids = [self._token_id(self.bos_token)] + ids + [self._token_id(self.eos_token)]
            rows.append(ids + [self._token_id(self.pad_token)] * (n - len(ids)))
        return torch.tensor(rows, dtype=torch.int64)
