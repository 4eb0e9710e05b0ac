"""Port parity: fused-QKV attention against the JAX package's, on the CPU.

JAX's `fused_qkv_attention` runs its Pallas kernel in interpret mode here;
the port's wrapper runs its plain version on CPU tensors. Both take the same
bf16 projection, made with numpy from a seed.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_llm_rs_tpu.ops import pallas_attention as jpa
from diffusion_llm_rs_tpu_torch.ops import attention as tat


def _qkv(B, S, D, seed=0):
    x = np.random.default_rng(seed).standard_normal((B, S, 3 * D))
    xb = jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)
    return xb, torch.from_numpy(np.asarray(xb.astype(jnp.float32)))


@pytest.mark.parametrize("S", [16, 32])
@pytest.mark.parametrize("D,H", [(64, 2), (64, 4), (128, 2), (128, 4)])
def test_fused_qkv_attention_matches_jax_kernel(S, D, H):
    """The same f32 operations in the same order; the two frameworks' sums
    and `exp` may differ in the last bit (ROADMAP C8), which can move one
    bf16 rounding of P, by 2^-9 of that weight times its value row. f32 out:
    relative Frobenius error <= 1e-5 and |d| <= 2e-5 (measured up to 3.3e-7
    and 3.7e-6, against outputs of ~0.3); bf16 out: within one bf16 ulp of
    the output, element by element."""
    _matches_jax_kernel(S, D, H)


@pytest.mark.parametrize("D,H", [(384, 2), (512, 2), (528, 2), (768, 2),
                                 (768, 1), (2048, 1), (2056, 1), (2560, 1)])
def test_fused_qkv_attention_matches_jax_kernel_at_wide_heads(D, H):
    """Heads of 192 and 256, the widest instances of the port's `wgmma`
    design; of 264, 384, 768 and 2048, which the card runs in its cluster
    kernel a block a 256-column slice; and of 2056 and 2560, past it, where
    a block takes two slices: the tolerances above."""
    _matches_jax_kernel(16, D, H)


def _matches_jax_kernel(S, D, H):
    B = 2
    xb, xt = _qkv(B, S, D, seed=S + D + H)
    for jdt, tdt, rtol, atol in ((jnp.float32, torch.float32, 0.0, 2e-5),
                                 (jnp.bfloat16, torch.bfloat16, 2.0 ** -7,
                                  1e-6)):
        want = np.asarray(jpa.fused_qkv_attention(xb, H, out_dtype=jdt)
                          .astype(jnp.float32))
        got = tat.fused_qkv_attention(xt, H, out_dtype=tdt)
        assert got.dtype == tdt and tuple(got.shape) == (B, S, D)
        got = got.float().numpy()
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        print(f"S={S} D={D} H={H} {tdt}: rel {rel:.3g}, max |d| "
              f"{np.abs(got - want).max():.3g}")
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
        assert rel <= (1e-5 if tdt == torch.float32 else 2.0 ** -8)


@pytest.mark.parametrize("D,H", [(528, 2), (768, 2), (768, 1)])
def test_qkv_cluster_schedule_matches_jax_kernel(D, H):
    """The card's schedule at heads of 264 to 2048 (the model of
    `csrc/fused_qkv_attention_wide.cu` in `test_torch_wide_routing.py`:
    256-column partials of S in rank order, tiles of 32 keys, a running
    maximum and sum in pass 1, the logits kept for pass 2) against JAX's
    interpreted kernel at S = 104 (a last tile of 8 keys), f32 out. p is
    formed as one power of two, 2^(logit log2(e) - (max log2(e) +
    log2(sum))), where JAX divides exp(logit - max) by the sum, so a p near
    a bf16 rounding boundary may round the other way and move its output by
    up to 2^-8 of p |v| (|d| <= 2e-3 here); rel Frobenius <= 1e-4, a tenth
    of the card test's bound for the kernel against the plain version."""
    from test_torch_wide_routing import qkv_cluster_model

    xb, xt = _qkv(2, 104, D, seed=D + H)
    want = np.asarray(jpa.fused_qkv_attention(xb, H, out_dtype=jnp.float32))
    got = qkv_cluster_model(xt, H, 1.0 / np.sqrt(D // H)).numpy()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    print(f"D={D} H={H}: rel {rel:.3g}, max |d| {np.abs(got - want).max():.3g}")
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)
    assert rel <= 1e-4


def test_fused_qkv_attention_sm_scale_matches_jax():
    xb, xt = _qkv(2, 16, 64, seed=3)
    want = np.asarray(jpa.fused_qkv_attention(xb, 2, sm_scale=0.3,
                                              out_dtype=jnp.float32))
    got = tat.fused_qkv_attention(xt, 2, sm_scale=0.3,
                                  out_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


# (S, 3D, heads): the boundaries of JAX's predicate. None for S % 8, a head
# width not a multiple of 8, 3D not divisible by 3 or D by the heads, and
# a whole-row footprint over 8 MiB (S = 872 at D = 768; 864 fits)
BOUNDARY = [(20, 192, 2), (64, 288, 8), (16, 190, 2), (16, 192, 5),
            (872, 2304, 12), (864, 2304, 12), (8, 48, 2), (1448, 24, 1),
            (1456, 24, 1)]


@pytest.mark.parametrize("S,threeD,H", BOUNDARY)
def test_fused_qkv_attention_returns_none_where_jax_does(S, threeD, H):
    # traced, not run: None or the shape of the kernel's output
    jax_none = jax.eval_shape(
        functools.partial(jpa.fused_qkv_attention, num_heads=H),
        jax.ShapeDtypeStruct((1, S, threeD), jnp.bfloat16)) is None
    assert tat.fused_qkv_fits((1, S, threeD), H) == (not jax_none)
    if jax_none:
        assert tat.fused_qkv_attention(
            torch.zeros((1, S, threeD), dtype=torch.bfloat16), H) is None
