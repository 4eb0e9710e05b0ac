"""Port parity: the engine's host-side stack against the JAX package's, on
the CPU.

Both engines hold the same tiny model (JAX's parameters carried across with
`weights.from_jax_params`) and the same default tokenizer, each with its own
store file in the test's directory. `process_model` (tokenize, embed,
compress, store with dedup, route, index), `prefill` with the prompt cache
(repeated, prefix-extended, shorter and diverged prompts),
`get_cached_vectors`, `tokenize_model`, the attention masks and `stats`
must give JAX's answers: counts, hits and stats equal, vectors and store
bytes bit for bit, index answers as in `test_torch_subsystems.py`.
"""

import jax
import numpy as np
import pytest
import torch

from diffusion_llm_rs_tpu import config as jcfg
from diffusion_llm_rs_tpu.engine import Engine as JEngine
from diffusion_llm_rs_tpu_torch import config as tcfg
from diffusion_llm_rs_tpu_torch.engine import Engine as TEngine
from diffusion_llm_rs_tpu_torch.weights import from_jax_params

TEXT = "hello world hello world hello"
LONG = ("the quick brown fox jumps over the lazy dog and the quick brown fox "
        "sleeps while the lazy dog jumps over the quick brown fox")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(tmp_path, **cfg_kw):
    jc = jcfg.DiffusionConfig.tiny(vocab_size=512, **cfg_kw)
    tc = tcfg.DiffusionConfig.tiny(vocab_size=512, **cfg_kw)
    je = JEngine(config=jc, prefill_config=jcfg.PrefillConfig(
        embedding_dim=jc.hidden_size),
        system_config=jcfg.SystemConfig(ssd_path=str(tmp_path / "jax.bin")))
    te = TEngine(config=tc, params=from_jax_params(
        jax.tree_util.tree_map(np.array, je.params), device="cpu"),
        prefill_config=tcfg.PrefillConfig(embedding_dim=tc.hidden_size),
        system_config=tcfg.SystemConfig(ssd_path=str(tmp_path / "torch.bin")),
        device="cpu")
    return je, te


def _same_vectors(a, b):
    assert [v.id for v in a] == [v.id for v in b]
    for u, v in zip(a, b):
        assert u.bits == v.bits and tuple(u.original_shape) == \
            tuple(v.original_shape)
        assert np.array_equal(np.asarray(u.data), v.data)
        assert (u.quant_scale, u.quant_zero_point) == \
            (v.quant_scale, v.quant_zero_point)


@pytest.mark.parametrize("text", [TEXT, LONG])
def test_process_model_equals_jax(tmp_path, text):
    je, te = _pair(tmp_path)
    for model_id in ("m", "n"):   # a second text into the same stack
        want = je.process_model(text, model_id=model_id)
        got = te.process_model(text, model_id=model_id)
        assert got == want and got["dedup_hits"] > 0
    assert te.stats() == je.stats()
    assert (tmp_path / "torch.bin").read_bytes() == \
        (tmp_path / "jax.bin").read_bytes()
    ids = list(je.dedup.locations)
    assert list(te.dedup.locations) == ids
    assert te.dedup.read_vectors(ids) == je.dedup.read_vectors(ids)
    # router: nodes, shards and edges (numpy on equal vectors) equal
    assert {k: n.shard_id for k, n in te.router.nodes.items()} == \
        {k: n.shard_id for k, n in je.router.nodes.items()}
    assert te.router.edges == je.router.edges
    # index: the same quantized matrix; queries of the token rows, whose
    # repeated words give identical rows
    assert np.array_equal(te.anns._matrix.data.numpy(),
                          np.asarray(je.anns._matrix.data))
    emb = te.tokenize_model(text)[0].embeddings
    for row in emb[:6]:
        want, got = je.anns.search(row, 5), te.anns.search(row, 5)
        assert [i for i, _ in got] == [i for i, _ in te.anns.query(row, 5)]
        assert {i for i, _ in got} <= {i for i, _ in je.anns.search(row, 40)}
        assert max(abs(a[1] - b[1]) for a, b in zip(want, got)) <= 1e-6


def test_prefill_prompt_cache_equals_jax(tmp_path):
    je, te = _pair(tmp_path)
    base = "the quick brown fox"
    prompts = [base, base, base + " jumps over the dog", base,
               "zzz qqq", "zzz", ""]
    for p in prompts:
        assert te.prefill(p) == je.prefill(p)
        assert te.prefill_prefix_hits == je.prefill_prefix_hits
        assert sorted(te._prefill_store) == sorted(je._prefill_store)
        assert te.stats() == je.stats()
    _same_vectors([je._prefill_store[k] for k in sorted(je._prefill_store)],
                  [te._prefill_store[k] for k in sorted(te._prefill_store)])
    assert te.prefill(base, cache_id="other") == je.prefill(
        base, cache_id="other")
    ids = [f"default:{i}" for i in range(6)] + ["other:0", "missing"]
    for a, b in zip(je.get_cached_vectors(ids), te.get_cached_vectors(ids)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert not te.get_cached_vectors(["missing"])[0].any()
    assert te.salience.calculate("a b") == je.salience.calculate("a b")


def test_repeated_prefill_reuses_the_stored_vectors(tmp_path):
    _, te = _pair(tmp_path)
    n1 = te.prefill("the quick brown fox jumps")
    stored = dict(te._prefill_store)
    assert te.prefill("the quick brown fox jumps") == 0
    assert te.prefill_prefix_hits == n1
    for vid, vec in stored.items():   # reused, not rebuilt
        assert te._prefill_store[vid] is vec


def test_tokenize_model_and_attention_masks_equal_jax(tmp_path):
    je, te = _pair(tmp_path)
    want = je.tokenize_model("hello tpu world", model_id="m1")
    got = te.tokenize_model("hello tpu world", model_id="m1")
    assert got[0].tokens == want[0].tokens and got[0].id == "m1"
    assert np.array_equal(got[0].embeddings, np.asarray(want[0].embeddings))
    n = len(got[0].tokens)
    mask = np.random.default_rng(0).random((n - 1, te.config.hidden_size))
    for e in (je, te):
        e.set_attention_mask("m1", mask)
    je.apply_attention_masks(want, [1])
    te.apply_attention_masks(got, [1])
    assert np.array_equal(got[0].embeddings, want[0].embeddings)
    assert got[0].offset == 1 and got[0].attention_mask is not None
    other = te.tokenize_model("hello", model_id="unmasked")
    before = other[0].embeddings.copy()
    te.apply_attention_masks(other, [0])
    assert np.array_equal(other[0].embeddings, before)


def test_quantize_weights_clears_the_prefill_memos(tmp_path):
    je, te = _pair(tmp_path)
    for e in (je, te):
        e.prefill("the quick brown fox")
        assert e._prefill_store and e._prefix_index
        e.quantize_weights(4, kernel_layout=False)
        assert not e._prefill_store and not e._prefix_index
    assert te.prefill("the quick brown fox") == je.prefill(
        "the quick brown fox")
    assert te.stats() == je.stats()


def test_stats_keys_and_default_store_name(tmp_path):
    je, te = _pair(tmp_path)
    assert sorted(te.stats()) == sorted(je.stats())
    assert te.stats()["weight_bits"] == 16
    d = tcfg.SystemConfig().ssd_path
    assert d.endswith("diffusion_llm_rs_tpu_torch_store.bin")
    assert d != jcfg.SystemConfig().ssd_path
    assert te.prefill_config.embedding_dim == te.config.hidden_size
    assert te.anns.device == te.device == torch.device("cpu")
