"""Port parity: the six shipped GPTQ checkpoints in both packages, on the CPU.

`benchmarks/quality_anchor{,_real}.gptq{1,2,4}g128` are raw `QuantizedTensor`
trees of the two trained anchors (6 layers, width 256, 8 heads of 32, vocab
463, f32), made by `benchmarks/bench_quality.py` (not regenerated here). As
that bench does (`bench_quality.py:281`, `:298-306`), both packages load
each one with `load_checkpoint(path, like=<the anchor's parameters>)` and
`prepare` every 2-D leaf at act 16 and act 8, leaving a leaf that raises
`ValueError` unprepared; an `Engine` over the prepared tree then scores a
fixed text and continues a prompt. The leaves must be bit-equal, `prepare`
must raise on the same leaves and give the same kernel layout bit for bit,
`denoising_perplexity` from JAX's noise must agree, and `generate` token for
token. Each test prints what it measured (`pytest -rP`).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_llm_rs_tpu.engine import Engine as JEngine
from diffusion_llm_rs_tpu.ops import pallas_matmul as jpm
from diffusion_llm_rs_tpu.quant.core import QuantizedTensor as JQuantized
from diffusion_llm_rs_tpu.utils.serialization import (
    load_checkpoint as jload)
from diffusion_llm_rs_tpu_torch.engine import Engine as TEngine
from diffusion_llm_rs_tpu_torch.ops.int8_matmul import MatmulWeight, prepare
from diffusion_llm_rs_tpu_torch.quant.core import (QuantizedTensor,
                                                   map_leaves, tree_leaves)
from diffusion_llm_rs_tpu_torch.utils.serialization import (
    load_checkpoint as tload)

ANCHORS = ("quality_anchor", "quality_anchor_real")
CHECKPOINTS = [(a, bits) for a in ANCHORS for bits in (1, 2, 4)]
IDS = [f"{a}.gptq{bits}g128" for a, bits in CHECKPOINTS]
TEXT = "the forest maybe river the stone quick"
PROMPT = "the quick"
# every linear of the 6 layers (wqkv, wo, w1, w2), the time MLP's two and
# the head: one packed-matmul launch each a forward
PREPARED = 4 * 6 + 3
# perplexity from the same noise, relative: at act 16 the packed matmul
# rounds its f32 activations to bf16 on both sides, and a last-bit
# difference of the two frameworks' layer norms can move one rounding (C14's
# bound); at act 8 the activations are quantized per row to int8, which
# amplifies the same differences (C1, C7: 5e-3 against JAX). Measured over
# the six checkpoints: at most 2.0e-5 (act 16) and 2.8e-5 (act 8).
PPL_BOUND = {16: 2e-3, 8: 5e-3}


@pytest.fixture(autouse=True)
def one_thread():
    """Six test processes share the machine: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _path(anchor, bits):
    return f"benchmarks/{anchor}.gptq{bits}g128"


@functools.lru_cache(maxsize=None)
def _anchor(anchor):
    return (JEngine.from_pretrained(f"benchmarks/{anchor}"),
            TEngine.from_pretrained(f"benchmarks/{anchor}", device="cpu"))


@functools.lru_cache(maxsize=None)
def _loaded(anchor, bits):
    """Both packages' raw trees of one checkpoint."""
    je, te = _anchor(anchor)
    return (jload(_path(anchor, bits), like=je.params),
            tload(_path(anchor, bits), like=te.params, device="cpu"))


def _prep_jax(tree, act_bits):
    """`bench_quality.py:298-306`: (the tree, the unprepared leaves' paths)."""
    skipped = []

    def prep(path, leaf):
        if isinstance(leaf, JQuantized) and leaf.ndim == 2:
            try:
                return jpm.prepare(leaf, act_bits=act_bits)
            except ValueError:
                skipped.append(jax.tree_util.keystr(path))
        return leaf
    out = jax.tree_util.tree_map_with_path(
        prep, tree, is_leaf=lambda l: isinstance(l, JQuantized))
    return out, skipped


def _prep_port(tree, act_bits):
    skipped = []

    def prep(path, leaf):
        if isinstance(leaf, QuantizedTensor) and leaf.ndim == 2:
            try:
                return prepare(leaf, act_bits=act_bits)
            except ValueError:
                skipped.append("".join(f"[{k!r}]" if not k.isdigit()
                                       else f"[{k}]" for k in path))
        return leaf
    return map_leaves(prep, tree), skipped


@functools.lru_cache(maxsize=None)
def _engines(anchor, bits, act_bits):
    je, te = _anchor(anchor)
    jraw, traw = _loaded(anchor, bits)
    jp, _ = _prep_jax(jraw, act_bits)
    tp, _ = _prep_port(traw, act_bits)
    return (JEngine(config=je.config, tokenizer=je.tokenizer, params=jp),
            TEngine(config=te.config, tokenizer=te.tokenizer, params=tp,
                    device="cpu"))


@pytest.mark.parametrize("anchor,bits", CHECKPOINTS, ids=IDS)
def test_checkpoint_leaves_equal_jax_bit_for_bit(anchor, bits):
    jraw, traw = _loaded(anchor, bits)
    jl = jax.tree_util.tree_leaves(
        jraw, is_leaf=lambda l: isinstance(l, JQuantized))
    tl = tree_leaves(traw)
    assert len(jl) == len(tl) == 69
    quantized = 0
    for a, b in zip(jl, tl):
        if isinstance(a, JQuantized):
            quantized += 1
            assert isinstance(b, QuantizedTensor)
            assert (b.bits, tuple(b.shape), b.granularity, b.group_size,
                    b.axis, b.symmetric) == (a.bits, tuple(a.shape),
                                             a.granularity, a.group_size,
                                             a.axis, a.symmetric)
            pairs = ((a.data, b.data), (a.scale, b.scale),
                     (a.zero_point, b.zero_point))
        else:
            pairs = ((a, b),)
        for x, y in pairs:
            x = np.asarray(x)
            assert y.dtype == torch.from_numpy(x).dtype
            np.testing.assert_array_equal(y.numpy(), x)
    assert quantized == PREPARED
    print(f"{anchor}.gptq{bits}: {len(tl)} leaves bit-equal, {quantized} "
          f"quantized at {bits} bits")


@pytest.mark.parametrize("act_bits", [16, 8])
@pytest.mark.parametrize("anchor,bits", CHECKPOINTS, ids=IDS)
def test_prepare_matches_jax(anchor, bits, act_bits):
    """The same leaves prepared (all 27: every K is a multiple of 128) and
    left unprepared (none), with the kernel layout bit for bit."""
    jraw, traw = _loaded(anchor, bits)
    jp, jskip = _prep_jax(jraw, act_bits)
    tp, tskip = _prep_port(traw, act_bits)
    assert tskip == jskip == []
    jl = jax.tree_util.tree_leaves(
        jp, is_leaf=lambda l: isinstance(l, jpm.MatmulWeight))
    tl = tree_leaves(tp)
    pairs = [(a, b) for a, b in zip(jl, tl) if isinstance(b, MatmulWeight)]
    assert len(pairs) == PREPARED
    for a, b in pairs:
        assert isinstance(a, jpm.MatmulWeight)
        assert (b.bits, b.K, b.N, b.group_size, b.act_bits) == (
            a.bits, a.K, a.N, a.group_size, a.act_bits) and \
            b.act_bits == act_bits
        for x, y in ((a.data, b.data), (a.scale, b.scale),
                     (a.zero_point, b.zero_point)):
            np.testing.assert_array_equal(y.numpy(), np.asarray(x))
        if act_bits == 8:
            np.testing.assert_array_equal(b.col_scale.numpy(),
                                          np.asarray(a.col_scale))
        else:
            assert a.col_scale is None and b.col_scale is None
    print(f"{anchor}.gptq{bits} act {act_bits}: {len(pairs)} prepared, "
          f"none left")


@pytest.mark.parametrize("act_bits", [16, 8])
@pytest.mark.parametrize("anchor,bits", CHECKPOINTS, ids=IDS)
def test_denoising_perplexity_matches_jax(anchor, bits, act_bits):
    """From the noise JAX draws with PRNGKey(0), at t = 10: within
    `PPL_BOUND` relative."""
    je, te = _engines(anchor, bits, act_bits)
    n = len(te.tokenizer.encode(TEXT))
    noise = np.array(jax.random.normal(
        jax.random.PRNGKey(0), (1, n, te.config.hidden_size), jnp.float32))
    pj = je.denoising_perplexity(TEXT, t=10, seed=0)
    pt = te.denoising_perplexity(TEXT, t=10, noise=torch.from_numpy(noise))
    rel = abs(pt - pj) / pj
    print(f"{anchor}.gptq{bits} act {act_bits}: perplexity jax {pj:.6g} "
          f"port {pt:.6g}, rel {rel:.3g}")
    assert np.isfinite(pt) and rel <= PPL_BOUND[act_bits]


@pytest.mark.parametrize("anchor,bits,act_bits",
                         [("quality_anchor", 4, 16),
                          ("quality_anchor_real", 2, 8)],
                         ids=["quality_anchor.gptq4g128-act16",
                              "quality_anchor_real.gptq2g128-act8"])
def test_generate_matches_jax(anchor, bits, act_bits):
    je, te = _engines(anchor, bits, act_bits)
    out_j = je.generate(PROMPT, max_length=4)
    out_t = te.generate(PROMPT, max_length=4)
    print(f"{anchor}.gptq{bits} act {act_bits}: generate {out_t!r}")
    assert out_t == out_j and len(out_t) > 0
