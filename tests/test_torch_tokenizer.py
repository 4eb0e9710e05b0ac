"""Port parity: the byte-level BPE tokenizer against the JAX package's (which
runs its native merge loop where that library is built, else the same
Python loop)."""

import json
import pathlib

import pytest

from diffusion_llm_rs_tpu.tokenizer.bpe import BPETokenizer as JTok
from diffusion_llm_rs_tpu_torch.tokenizer.bpe import BPETokenizer as TTok

ANCHOR = str(pathlib.Path(__file__).resolve().parent.parent / "benchmarks" /
             "quality_anchor.tok.json")
CORPUS = [
    "the quick brown fox jumps over the lazy dog",
    "diffusion language models denoise token embeddings step by step",
    "quantized key value caches keep memory small and inference fast",
    "the the the quick quick 12345 12345 !!! ??? \n\n tabs\tand  spaces",
]
TEXTS = [
    "the quick brown fox", " leading space", "trailing space ", "",
    "MiXeD CaSe 42 times, 1000000!", "naïve café — ünïcödé ✓ 日本語",
    "a", "  \n\t ", "forest maybe river stone sleeps large under house",
    "x" * 40 + " " + "ab" * 30,
]


@pytest.fixture(scope="module", params=["anchor", "trained", "no-merges"])
def toks(request):
    if request.param == "anchor":
        return JTok.load(ANCHOR), TTok.load(ANCHOR)
    size = 330 if request.param == "trained" else 256
    return JTok.train(CORPUS, size), TTok.train(CORPUS, size)


def test_same_vocabulary(toks):
    j, t = toks
    assert t.merges == j.merges and t.special_tokens == j.special_tokens
    assert t.vocab_size == j.vocab_size
    assert (t.pad_id, t.eos_id) == (j.pad_id, j.eos_id)
    assert t.eos_id == t.token_to_id("[EOS]") == j.token_to_id("[EOS]")


@pytest.mark.parametrize("text", TEXTS, ids=range(len(TEXTS)))
def test_encode_decode_equal(toks, text):
    j, t = toks
    ids = t.encode(text)
    assert ids == j.encode(text)
    assert t.encode(text, add_eos=True) == j.encode(text, add_eos=True)
    assert t.decode(ids) == j.decode(ids) == text
    with_special = ids + [t.eos_id, t.pad_id]
    assert t.decode(with_special) == text
    assert t.decode(with_special, skip_special=False) == \
        j.decode(with_special, skip_special=False)


def test_token_and_id_lookups_equal(toks):
    j, t = toks
    for idx in list(range(0, t.vocab_size, 7)) + [t.vocab_size - 1]:
        assert t.id_to_token(idx) == j.id_to_token(idx)
    for tok in ("a", " the", "[PAD]", "[BOS]", "zzzzzz-not-a-token", "é"):
        assert t.token_to_id(tok) == j.token_to_id(tok)
    with pytest.raises(ValueError, match="out of range"):
        t.id_to_token(t.vocab_size)


def test_save_and_load_cross_packages(toks, tmp_path):
    j, t = toks
    pj, pt = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    j.save(pj)
    t.save(pt)
    assert json.load(open(pj)) == json.load(open(pt))
    t2, j2 = TTok.load(pj), JTok.load(pt)
    text = TEXTS[4]
    assert t2.encode(text) == j2.encode(text) == t.encode(text)
    assert t2.vocab_size == t.vocab_size


def test_training_stops_where_jax_stops():
    """No pair occurs twice: no merges, in both packages; custom special
    tokens land at the top of the vocabulary."""
    j = JTok.train(["abc"], 400, special_tokens=("[PAD]", "[EOS]", "<x>"))
    t = TTok.train(["abc"], 400, special_tokens=("[PAD]", "[EOS]", "<x>"))
    assert t.merges == j.merges == []
    assert t.token_to_id("<x>") == j.token_to_id("<x>") == 258
