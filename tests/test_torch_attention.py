"""Port parity: dense flash attention's plain twin against the Pallas kernel.

`dense_attention_plain` (what the port runs on CPU tensors, and what the CUDA
kernel is held against on the card) against the JAX `dense_attention` Pallas
kernel in interpret mode, on the same numpy inputs.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_llm_rs_tpu.models import denoiser as jdn
from diffusion_llm_rs_tpu.ops import pallas_attention as jpa
from diffusion_llm_rs_tpu_torch.models import denoiser as tdn
from diffusion_llm_rs_tpu_torch.ops import _build
from diffusion_llm_rs_tpu_torch.ops.attention import (
    dense_attention,
    dense_attention_plain,
)

# Both sides round P to bf16 before P.V and write bf16; the twin's products
# and sums run on the CPU in another order than the interpreted kernel's, so
# a P entry near a rounding boundary may land one bf16 ulp (2^-8 relative)
# apart: 1e-2 absolute is a few ulps of outputs of size ~0.3.
ATOL = 1e-2


@pytest.mark.parametrize("S", [128, 256])
def test_dense_attention_plain_matches_pallas(S):
    BH, D = 2, 16
    rng = np.random.default_rng(S)
    q, k, v = (rng.normal(size=(BH, S, D)).astype(np.float32) for _ in range(3))
    ref = jpa.dense_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    assert ref is not None
    out = dense_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)), atol=ATOL)
    # and against exact f32 softmax attention, at bf16 accuracy
    logits = np.einsum("bsd,btd->bst", q, k) / math.sqrt(D)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    exact = np.einsum("bst,btd->bsd", p / p.sum(-1, keepdims=True), v)
    np.testing.assert_allclose(out.float().numpy(), exact, atol=2e-2)


def test_dense_attention_cpu_dispatch_is_the_twin():
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 64, 32)).astype(np.float32))
               for _ in range(3))
    _build.reset_launch_counts()
    out = dense_attention(q, k, v, out_dtype=torch.float32)
    np.testing.assert_array_equal(
        out.numpy(), dense_attention_plain(q, k, v, out_dtype=torch.float32).numpy())
    assert _build.launch_counts["dense_attention"] == 0


def test_attention_einsum_path_matches_jax():
    """Short-sequence attention (the plain einsum path), with and without a
    mask."""
    B, S, H, Hd = 2, 16, 4, 8
    rng = np.random.default_rng(2)
    q, k, v = (rng.normal(size=(B, S, H, Hd)).astype(np.float32)
               for _ in range(3))
    mask = np.where(rng.random((B, 1, S, S)) < 0.2, -1e9, 0.0).astype(np.float32)
    for m in (None, mask):
        ref = jdn.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            None if m is None else jnp.asarray(m))
        out = tdn.attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v),
                            None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)


def test_attention_long_sequence_takes_dense_attention():
    """Unmasked Skv >= 1024 goes through dense_attention (the twin on the
    CPU), which agrees with the einsum path at bf16 accuracy."""
    B, S, H, Hd = 1, 1024, 2, 16
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, S, H, Hd)).astype(np.float32))
               for _ in range(3))
    flash = tdn.attention(q, k, v)
    einsum = tdn.attention(q, k, v, flash=False)
    folded = dense_attention_plain(
        *(t.transpose(1, 2).reshape(B * H, S, Hd) for t in (q, k, v)),
        out_dtype=torch.float32)
    np.testing.assert_array_equal(
        flash.numpy(), folded.reshape(B, H, S, Hd).transpose(1, 2).numpy())
    np.testing.assert_allclose(flash.numpy(), einsum.numpy(), atol=ATOL)


@pytest.mark.parametrize("D", [32, 128, 8, 24, 48, 80, 96, 256, 264, 384,
                               768])
@pytest.mark.parametrize("out", ["bfloat16", "float32"])
def test_dense_attention_plain_matches_pallas_at_other_widths(D, out):
    """Head widths 32 (the shipped anchor's) and 128, and every other width
    JAX's kernel takes that the CUDA kernel runs padded (8 to 96: inside the
    instances of 16, 32, 64 and 128), at its widest instance (256) or in its
    wide instance (264, and the heads of 384 and 768 of width 768 at 2 and 1
    heads), bf16 and f32
    output, against the interpreted kernel: P rounds to bf16 on both sides, so the
    difference is f32 summation order and the frameworks' `exp` moving an
    occasional bf16(p): 1e-2 absolute in bf16 (as above), 2e-3 relative
    Frobenius in f32."""
    BH, S = 2, 128
    rng = np.random.default_rng(D)
    q, k, v = (rng.normal(size=(BH, S, D)).astype(np.float32) for _ in range(3))
    ref = jpa.dense_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              out_dtype=getattr(jnp, out))
    assert ref is not None
    got = dense_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                out_dtype=getattr(torch, out))
    assert got.dtype == getattr(torch, out) and got.shape == (BH, S, D)
    ref = np.asarray(ref.astype(jnp.float32))
    got = got.float().numpy()
    rel = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
    print(f"dense_attention_plain vs interpreted Pallas, D={D} {out}: "
          f"max {np.abs(got - ref).max():.3g}, rel {rel:.3g}")
    np.testing.assert_allclose(got, ref, atol=ATOL)
    if out == "float32":
        assert rel < 2e-3


@pytest.mark.parametrize("out", ["bfloat16", "float32"])
def test_dense_twin_past_2048_matches_jax(out):
    """One head of 2560 (BH = 2, S = 128: inside the VMEM bound of JAX's
    kernel, which runs interpreted), which the card runs in its cluster
    kernel with two 256-column slices a block: the plain twin, and the
    k-slice schedule's model (`test_torch_wide_routing.py:
    dense_slices_model`, tiles of 32 keys, f32 out), at the tolerances of
    `test_dense_attention_plain_matches_pallas_at_other_widths`."""
    from test_torch_wide_routing import dense_slices_model

    BH, S, D = 2, 128, 2560
    rng = np.random.default_rng(D)
    q, k, v = (rng.normal(size=(BH, S, D)).astype(np.float32) for _ in range(3))
    ref = jpa.dense_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              out_dtype=getattr(jnp, out))
    assert ref is not None
    ref = np.asarray(ref.astype(jnp.float32))
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    twin = dense_attention_plain(qt, kt, vt, out_dtype=getattr(torch, out))
    assert twin.dtype == getattr(torch, out) and twin.shape == (BH, S, D)
    model = dense_slices_model(qt, kt, vt, 1.0 / math.sqrt(D))
    for name, got in (("twin", twin.float().numpy()),
                      ("k-slice model", model.numpy())):
        rel = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
        print(f"dense {name} vs interpreted Pallas, D={D} {out}: max "
              f"{np.abs(got - ref).max():.3g}, rel {rel:.3g}")
        np.testing.assert_allclose(got, ref, atol=ATOL)
        if out == "float32":
            assert rel < 2e-3


@pytest.mark.parametrize("D", [12, 20])
def test_flash_fold_takes_jax_einsum_branch_where_no_kernel_runs(D):
    """Heads of no multiple of 8: JAX's `dense_attention` returns None and
    `_flash_fold` runs its einsum; so does the port's `flash_fold`
    (`dense_attention_einsum`), on either device, and launches nothing.
    f32 on both sides, sums in another order: within 1e-5 relative, and the
    gradients (JAX's VJP on both sides) within 1e-5."""
    import jax
    BH, S = 2, 1024
    rng = np.random.default_rng(D)
    q, k, v = (rng.normal(size=(BH, S, D)).astype(np.float32) for _ in range(3))
    g = rng.normal(size=(BH, S, D)).astype(np.float32)
    sm = 1.0 / math.sqrt(D)
    assert jpa.dense_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v)) is None
    jout, vjp = jax.vjp(lambda a, b, c: jdn._flash_fold(a, b, c, sm),
                        *(jnp.asarray(a) for a in (q, k, v)))
    jgrads = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    _build.reset_launch_counts()
    tout = tdn.flash_fold(tq, tk, tv, sm)
    assert sum(_build.launch_counts.values()) == 0
    tgrads = torch.autograd.grad(tout, (tq, tk, tv), torch.from_numpy(g))
    jout = np.asarray(jout)
    rel = float(np.linalg.norm(tout.detach().numpy() - jout)
                / np.linalg.norm(jout))
    print(f"flash_fold einsum branch vs JAX, D={D}: rel {rel:.3g}")
    assert rel < 1e-5
    for a, b in zip(tgrads, jgrads):
        b = np.asarray(b)
        assert float(np.linalg.norm(a.numpy() - b) / np.linalg.norm(b)) < 1e-5
