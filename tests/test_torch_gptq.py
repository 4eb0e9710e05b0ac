"""Port parity: GPTQ against the JAX package's, on the CPU.

The same numpy W, H and calibration inputs go through both packages'
`gptq_quantize_matrix` and `gptq_quantize_tree`; JAX's forward-process
draws in `make_calib_batches` are replayed through a noise source in its
key-split order. Scales and zero points must be bit-equal; levels equal, or
the count that differs printed with ||X (W - Wq)|| within 1e-6 relative.
Each test prints what it measured (`pytest -rP`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_llm_rs_tpu import config as jcfg_mod
from diffusion_llm_rs_tpu.engine import Engine as JEngine
from diffusion_llm_rs_tpu.models import denoiser as jdn
from diffusion_llm_rs_tpu.models import diffusion as jd
from diffusion_llm_rs_tpu.quant import core as jq
from diffusion_llm_rs_tpu.quant import gptq as jg
from diffusion_llm_rs_tpu_torch import config as tcfg_mod
from diffusion_llm_rs_tpu_torch.engine import Engine as TEngine
from diffusion_llm_rs_tpu_torch.models import diffusion as td
from diffusion_llm_rs_tpu_torch.quant import core as tq
from diffusion_llm_rs_tpu_torch.quant import gptq as tg
from diffusion_llm_rs_tpu_torch.weights import from_jax_params


@pytest.fixture(autouse=True)
def one_thread():
    """GPTQ walks the rows in a Python loop of small float64 ops: with the
    suite's six test processes on one machine, torch's thread pool costs
    each of them far more than it gives."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class KeyNoise:
    """Replays `make_calib_batches`' draws: split, then one normal per call."""

    def __init__(self, key):
        self.key = key

    def admission(self, shape):
        self.key, sub = jax.random.split(self.key)
        return torch.from_numpy(np.array(
            jax.random.normal(sub, shape, jnp.float32)))


def _dequant_err(x, w, data, scale, zp, bits, gs):
    """||X (W - Wq)|| / ||X W|| of a group-axis-0 quantization."""
    K, N = w.shape
    lv = jq.unpack_bits(jnp.asarray(data), bits, N)
    wq = ((np.asarray(lv, np.float64).reshape(K // gs, gs, N)
           - np.asarray(zp, np.float64)[:, None]) *
          np.asarray(scale, np.float64)[:, None]).reshape(K, N)
    return np.linalg.norm(x @ (w - wq)) / np.linalg.norm(x @ w)


def _compare_qt(j, t, x=None, w=None):
    """Scales and zero points bit-equal; returns the count of differing
    packed bytes (0 expected), checking the output error where any differ."""
    assert (t.bits, tuple(t.shape), t.group_size, t.axis, t.granularity) == (
        j.bits, tuple(j.shape), j.group_size, j.axis, j.granularity)
    np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale))
    np.testing.assert_array_equal(t.zero_point.numpy(),
                                  np.asarray(j.zero_point))
    diff = int((t.data.numpy() != np.asarray(j.data)).sum())
    if diff and x is not None:
        ej = _dequant_err(x, w, j.data, j.scale, j.zero_point, j.bits,
                          j.group_size)
        et = _dequant_err(x, w, t.data.numpy(), t.scale.numpy(),
                          t.zero_point.numpy(), t.bits, t.group_size)
        print(f"  {diff} bytes differ; ||X(W-Wq)|| rel JAX {ej:.6g}, port "
              f"{et:.6g}")
        assert abs(et - ej) <= 1e-6 * ej
    return diff


@pytest.mark.parametrize("bits", [4, 2])
@pytest.mark.parametrize("desc_act", [True, False])
@pytest.mark.parametrize("symmetric", [True, False])
def test_gptq_matrix_matches_jax(bits, desc_act, symmetric):
    """One dead input (a zero column of X), uneven activation scales; groups
    of 128 over K = 256. Measured: every byte equal."""
    rng = np.random.default_rng(bits * 4 + desc_act * 2 + symmetric)
    K, N = 256, 96
    x = rng.standard_normal((512, K)) * rng.random(K)
    x[:, 5] = 0.0
    w = rng.standard_normal((K, N)).astype(np.float32)
    h = x.T @ x
    j = jg.gptq_quantize_matrix(jnp.asarray(w), h, bits, group_size=128,
                                symmetric=symmetric, desc_act=desc_act)
    t = tg.gptq_quantize_matrix(torch.from_numpy(w), torch.from_numpy(h),
                                bits, group_size=128, symmetric=symmetric,
                                desc_act=desc_act)
    diff = _compare_qt(j, t, x, w.astype(np.float64))
    print(f"bits={bits} desc_act={desc_act} sym={symmetric}: {diff} of "
          f"{t.data.numel()} packed bytes differ")


def test_gptq_singular_hessian_takes_the_diagonal_fallback():
    """An indefinite H (not a Hessian a forward gives): both packages fall
    back to diagonal compensation, or both factor it; the results agree."""
    rng = np.random.default_rng(5)
    K, N = 64, 32
    h = np.diag(rng.random(K) + 0.5)
    h[0, 1] = h[1, 0] = 10.0  # not positive definite
    w = rng.standard_normal((K, N)).astype(np.float32)
    j = jg.gptq_quantize_matrix(jnp.asarray(w), h, 4, group_size=32)
    t = tg.gptq_quantize_matrix(torch.from_numpy(w), torch.from_numpy(h), 4,
                                group_size=32)
    assert _compare_qt(j, t) == 0


def test_hessian_collector_matches_jax():
    rng = np.random.default_rng(1)
    jc, tc = jg.HessianCollector(["a"]), tg.HessianCollector(["a"])
    for _ in range(3):
        x = rng.standard_normal((2, 8, 16)).astype(np.float32)
        for c, v in ((jc, jnp.asarray(x)), (tc, torch.from_numpy(x))):
            c.tap("a", v)
            c.tap("b", v)  # not collected
    assert set(tc.h) == {"a"} and tc.count == jc.count == {"a": 48}
    np.testing.assert_allclose(tc.h["a"].numpy(), jc.h["a"], rtol=1e-12,
                               atol=1e-12)


def _tiny():
    jcfg = jcfg_mod.DiffusionConfig.tiny(num_layers=2, hidden_size=64)
    tcfg = tcfg_mod.diffusion_config_from_json(jcfg_mod.to_json(jcfg))
    jparams = jdn.init_denoiser_params(jax.random.PRNGKey(0), jcfg)
    tparams = from_jax_params(jax.tree_util.tree_map(np.array, jparams),
                              device="cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.mark.parametrize("true_sequential", [True, False])
def test_gptq_tree_matches_jax(true_sequential):
    """Calibration batches from replayed draws equal JAX's; the whole tree
    quantized from the same batches equals JAX's leaf for leaf."""
    jcfg, tcfg, jparams, tparams = _tiny()
    js = jd.DiffusionSchedule.create(jcfg.num_timesteps)
    ts = td.DiffusionSchedule.create(tcfg.num_timesteps, device="cpu")
    tokens = [np.asarray(jax.random.randint(jax.random.PRNGKey(i), (2, 16), 0,
                                            jcfg.vocab_size))
              for i in range(2)]
    jb = jg.make_calib_batches(jparams, jcfg, js, tokens,
                               jax.random.PRNGKey(9))
    tb = tg.make_calib_batches(tparams, tcfg, ts, tokens,
                               KeyNoise(jax.random.PRNGKey(9)))
    assert len(tb) == len(jb) == 6
    for (jx, jt), (tx, tt) in zip(jb, tb):
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-6,
                                   atol=1e-7)
    # the same calibration inputs to both
    tb = [(torch.from_numpy(np.array(x)), torch.from_numpy(np.array(t)))
          for x, t in jb]
    jt = jg.gptq_quantize_tree(jparams, jcfg, jb, bits=4, group_size=32,
                               true_sequential=true_sequential)
    tt = tg.gptq_quantize_tree(tparams, tcfg, tb, bits=4, group_size=32,
                               true_sequential=true_sequential)
    assert isinstance(tparams["head"]["w"], torch.Tensor)  # input untouched
    diff = 0
    for name in (n for stage in tg._forward_order_names(tt) for n in stage):
        j, t = jg._get_by_path(jt, name), tg._get_by_path(tt, name)
        assert isinstance(t, tq.QuantizedTensor), name
        diff += _compare_qt(j, t)
    np.testing.assert_array_equal(tt["tok_embed"].numpy(),
                                  np.asarray(jt["tok_embed"]))
    print(f"true_sequential={true_sequential}: {diff} packed bytes differ")
    assert diff == 0


CALIB = ["the quick brown fox jumps over"]


def _leaf_arrays(leaf):
    if isinstance(leaf, torch.Tensor):
        return [leaf]
    return [a for a in (getattr(leaf, n, None) for n in
                        ("data", "scale", "zero_point", "col_scale"))
            if a is not None]


def test_engine_gptq_on_the_anchor_matches_jax():
    """`quantize_weights(4, method="gptq")` on the shipped anchor from the
    same texts and JAX's draws. Scales and zero points (static groups of the
    original weights) bit for bit, the RTN embedding too. Levels: the two
    frameworks' f32 forwards give Hessians that differ in the last bits,
    which moves a near-tie here and there, and true_sequential carries each
    moved level into every later stage's Hessian (ROADMAP C26): with two
    texts, 0 differing bytes through block 0's attention, then up to 20% of
    the bytes in the last block, 96% of the moved levels by one step. So
    the bound is end to end: denoising perplexity from JAX's noise within 2%
    (measured 0.2% at t = 10) and `generate` token for token."""
    je, te = JEngine.from_pretrained(), TEngine.from_pretrained(device="cpu")
    je.quantize_weights(4, method="gptq", calib_texts=CALIB)
    te.quantize_weights(4, method="gptq", calib_texts=CALIB,
                        noise=KeyNoise(jax.random.PRNGKey(0)))
    jl = jax.tree_util.tree_leaves_with_path(je.params)
    tl = [a for leaf in tq.tree_leaves(te.params) for a in _leaf_arrays(leaf)]
    assert len(jl) == len(tl)
    moved = 0
    for (path, a), b in zip(jl, tl):
        a, b = np.asarray(a), b.numpy()
        name = jax.tree_util.keystr(path)
        if a.dtype == np.uint8 and "tok_embed" not in name:
            moved += int((a != b).sum())  # packed levels: counted
        else:  # scales, zero points, column scales, tables, biases
            np.testing.assert_array_equal(b, a, err_msg=name)
    text = "the forest maybe river the stone quick"
    n = len(te.tokenizer.encode(text))
    noise = np.array(jax.random.normal(jax.random.PRNGKey(0),
                                       (1, n, te.config.hidden_size),
                                       jnp.float32))
    pj = je.denoising_perplexity(text, t=10)
    pt = te.denoising_perplexity(text, t=10, noise=torch.from_numpy(noise))
    print(f"{moved} packed bytes differ; perplexity JAX {pj:.4f}, port "
          f"{pt:.4f}")
    assert abs(pt - pj) <= 2e-2 * pj
    assert te.stats()["weight_bits"] == 4
    assert te.generate("the quick", max_length=6) == \
        je.generate("the quick", max_length=6)


def test_engine_gptq_truncates_texts_longer_than_the_model():
    """A calibration text longer than the model's positions (the anchor's
    built-in texts run to 42 tokens against its 32): JAX's engine fails in
    its first forward; the port calibrates on the text's first
    max_sequence_length tokens (ROADMAP C25). A tiny model of 16
    positions."""
    text = ["the quick brown fox jumps over the lazy dog " * 3]
    kw = dict(max_sequence_length=16, vocab_size=512)
    je = JEngine(config=jcfg_mod.DiffusionConfig.tiny(**kw))
    with pytest.raises(ValueError, match="exceeds max_sequence_length"):
        je.quantize_weights(4, method="gptq", calib_texts=text)
    te = TEngine(config=tcfg_mod.DiffusionConfig.tiny(**kw), device="cpu")
    assert len(te.tokenizer.encode(text[0])) > 16
    te.quantize_weights(4, method="gptq", calib_texts=text)
    assert te.stats()["weight_bits"] == 4
    assert isinstance(te.generate("the quick", max_length=2), str)
