"""CLIP BPE tokenizer: pure Python.

The port's own copy of ``gmdx/models/tokenizer.py``: it loads ``vocab.json``
+ ``merges.txt`` from an SD checkpoint's ``tokenizer/`` directory (or
OpenAI's ``bpe_simple_vocab`` gz file) and reproduces the CLIP encoding:
byte-to-unicode mapping, lowercasing and whitespace cleanup, word-level BPE
with ``</w>`` end-of-word markers, bos/eos wrapping, pad-to-77 with the eos
token. The JAX package splits words with the third-party ``regex`` module
(``\\p{L}``, ``\\p{N}``); this copy does the same split by Unicode category
with the standard library, so the port needs no package beyond torch and
numpy.
"""

from __future__ import annotations

import functools
import gzip
import html
import json
import os
import re
import unicodedata
from typing import Dict, List, Sequence, Tuple

import numpy as np

_SPECIALS = ("<|startoftext|>", "<|endoftext|>")
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte -> printable-unicode map."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: Tuple[str, ...]):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


def _clean_text(text: str) -> str:
    text = html.unescape(html.unescape(text))
    text = re.sub(r"\s+", " ", text)
    return text.strip().lower()


def _kind(ch: str) -> str:
    """'L' letter, 'N' number, 'S' whitespace, 'O' anything else."""
    if ch.isspace():
        return "S"
    cat = unicodedata.category(ch)[0]
    return cat if cat in "LN" else "O"


def split_words(text: str) -> List[str]:
    """CLIP's pre-tokenizer pattern, alternatives tried in order at each
    position: the two special tokens, the contractions, a run of letters,
    one number character, a run of other non-space characters; whitespace
    separates."""
    out, i, n = [], 0, len(text)
    while i < n:
        rest = text[i:]
        hit = next((s for s in _SPECIALS + _CONTRACTIONS if rest.startswith(s)), None)
        if hit is not None:
            out.append(hit)
            i += len(hit)
            continue
        kind = _kind(text[i])
        if kind == "S":
            i += 1
            continue
        j = i + 1
        if kind != "N":
            while j < n and _kind(text[j]) == kind:
                j += 1
        out.append(text[i:j])
        i = j
    return out


class CLIPTokenizer:
    """CLIP BPE with the SD prompt contract: 77 tokens, bos + text + eos,
    eos-padded, truncating long prompts (keeping the final eos)."""

    def __init__(
        self,
        vocab: Dict[str, int],
        merges: Sequence[Tuple[str, str]],
        model_max_length: int = 77,
    ):
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in vocab.items()}
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.model_max_length = model_max_length
        self.bos_token_id = self.encoder["<|startoftext|>"]
        self.eos_token_id = self.encoder["<|endoftext|>"]
        self.pad_token_id = self.eos_token_id
        self._cache: Dict[str, str] = {s: s for s in _SPECIALS}

    @classmethod
    def from_pretrained(cls, path: str, **kwargs) -> "CLIPTokenizer":
        """Load from a diffusers/transformers tokenizer dir (vocab.json +
        merges.txt) or an OpenAI-style bpe_simple_vocab gz file."""
        if os.path.isdir(path):
            sub = os.path.join(path, "tokenizer")
            if os.path.isdir(sub):
                path = sub
            with open(os.path.join(path, "vocab.json")) as f:
                vocab = json.load(f)
            with open(os.path.join(path, "merges.txt"), encoding="utf-8") as f:
                lines = f.read().split("\n")
            merges = [tuple(ln.split()) for ln in lines if ln and not ln.startswith("#")]
            return cls(vocab, [m for m in merges if len(m) == 2], **kwargs)
        if path.endswith(".gz"):
            with gzip.open(path, "rt", encoding="utf-8") as f:
                raw = f.read().split("\n")
            merges = [tuple(m.split()) for m in raw[1 : 49152 - 256 - 2 + 1]]
            vocab_list = list(bytes_to_unicode().values())
            vocab_list = vocab_list + [v + "</w>" for v in vocab_list]
            vocab_list += ["".join(m) for m in merges]
            vocab_list += list(_SPECIALS)
            return cls({v: i for i, v in enumerate(vocab_list)}, merges, **kwargs)
        raise ValueError(f"cannot load tokenizer from {path!r}")

    @classmethod
    def tiny(cls, model_max_length: int = 77) -> "CLIPTokenizer":
        """Character-level toy tokenizer for tests (no merges)."""
        chars = list(bytes_to_unicode().values())
        vocab_list = chars + [c + "</w>" for c in chars] + list(_SPECIALS)
        return cls({v: i for i, v in enumerate(vocab_list)}, [], model_max_length)

    def _bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def tokenize(self, text: str) -> List[int]:
        ids: List[int] = []
        for tok in split_words(_clean_text(text)):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(tok).split(" "))
        return ids

    def __call__(
        self,
        text: str | Sequence[str],
        *,
        max_length: int | None = None,
        padding: str = "max_length",
        truncation: bool = True,
    ) -> Dict[str, np.ndarray]:
        """transformers-compatible call: input_ids and attention_mask as
        int32 numpy arrays of shape (B, max_length)."""
        if isinstance(text, str):
            text = [text]
        max_length = max_length or self.model_max_length
        ids_batch, mask_batch = [], []
        for t in text:
            ids = self.tokenize(t)
            if truncation:
                ids = ids[: max_length - 2]
            ids = [self.bos_token_id] + ids + [self.eos_token_id]
            mask = [1] * len(ids)
            if padding == "max_length" and len(ids) < max_length:
                pad = max_length - len(ids)
                ids = ids + [self.pad_token_id] * pad
                mask = mask + [0] * pad
            ids_batch.append(ids)
            mask_batch.append(mask)
        return {
            "input_ids": np.asarray(ids_batch, np.int32),
            "attention_mask": np.asarray(mask_batch, np.int32),
        }

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        specials = {self.bos_token_id, self.eos_token_id}
        toks = [self.decoder[int(i)] for i in ids
                if not (skip_special_tokens and int(i) in specials)]
        data = bytearray(self.byte_decoder[c] for c in "".join(toks) if c in self.byte_decoder)
        return data.decode("utf-8", errors="replace").replace("</w>", " ").strip()


__all__ = ["CLIPTokenizer", "bytes_to_unicode", "split_words"]
