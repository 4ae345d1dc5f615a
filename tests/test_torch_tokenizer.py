"""gmdx_torch's CLIP tokenizer against the JAX package's, on the same texts.

The port's copy splits words by Unicode category with the standard library
where the JAX package uses the ``regex`` module; the ids must be the same.
"""

import json

import numpy as np
import pytest

from gmdx.models.tokenizer import CLIPTokenizer as JaxTokenizer
from gmdx_torch.models.tokenizer import CLIPTokenizer, split_words

PROMPTS = [
    "",
    "a photo of a cat",
    "High Dynamic Range, HDR10 — 4000 nits peak brightness!",
    "it's the dog's toy; they'll   play\tall day",
    "café naïve 123 ½ x²",
    "<|startoftext|>tokens<|endoftext|> and &amp; entities",
    "word " * 100,  # truncated to 77 with the final eos kept
]


def _small_bpe(tmp_path):
    """A vocab.json + merges.txt with real merges over the byte alphabet."""
    from gmdx_torch.models.tokenizer import bytes_to_unicode

    chars = list(bytes_to_unicode().values())
    merges = [("h", "d"), ("hd", "r</w>"), ("p", "h"), ("o", "t"), ("ph", "ot"),
              ("phot", "o</w>"), ("a", "t</w>"), ("c", "at</w>"), ("t", "h"), ("th", "e</w>")]
    vocab = chars + [c + "</w>" for c in chars] + ["".join(m) for m in merges]
    vocab += ["<|startoftext|>", "<|endoftext|>"]
    (tmp_path / "vocab.json").write_text(json.dumps({v: i for i, v in enumerate(vocab)}))
    (tmp_path / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(" ".join(m) for m in merges) + "\n", encoding="utf-8")
    return str(tmp_path)


@pytest.mark.parametrize("source", ["tiny", "files"])
def test_tokenizer_matches_jax(tmp_path, source):
    if source == "tiny":
        ours, theirs = CLIPTokenizer.tiny(), JaxTokenizer.tiny()
    else:
        path = _small_bpe(tmp_path)
        ours, theirs = CLIPTokenizer.from_pretrained(path), JaxTokenizer.from_pretrained(path)
    got, want = ours(PROMPTS), theirs(PROMPTS)
    assert got["input_ids"].shape == (len(PROMPTS), 77)
    np.testing.assert_array_equal(got["input_ids"], want["input_ids"])
    np.testing.assert_array_equal(got["attention_mask"], want["attention_mask"])
    assert got["input_ids"][-1, -1] == ours.eos_token_id  # truncation keeps the eos
    for text, ids in zip(PROMPTS, want["input_ids"]):
        assert ours.tokenize(text) == theirs.tokenize(text)
        assert ours.decode(ids) == theirs.decode(ids)


def test_split_words_matches_jax_pattern():
    import regex

    from gmdx.models.tokenizer import _TOKEN_PATTERN, _clean_text

    for text in PROMPTS + ["a!'s b'sc", "x<|endoftext|>!<|y", "ⅻ٣ 三", "'''"]:
        clean = _clean_text(text)
        assert split_words(clean) == regex.findall(_TOKEN_PATTERN, clean), text
