"""Port parity: the gradient of folded flash attention.

`flash_fold` (`ops/attention.py`) wraps the dense attention kernel in a
`torch.autograd.Function` whose backward is JAX's `_flash_fold` VJP
(`diffusion_llm_rs_tpu/models/denoiser.py`): f32 softmax-attention
gradients recomputed from q, k and v. On the CPU its forward is the
kernel's plain twin. Both backwards run f32 einsums over the same inputs,
so they agree to f32 summation order: 1e-5 relative per gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_llm_rs_tpu.models import denoiser as jdn
from diffusion_llm_rs_tpu_torch.models import denoiser as tdn
from diffusion_llm_rs_tpu_torch.ops import _build
from diffusion_llm_rs_tpu_torch.ops.attention import (
    dense_attention_plain,
    flash_fold,
)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("D", [16, 32, 64])
def test_flash_fold_vjp_matches_jax(D):
    BH, S = 2, 128
    sm = 1.0 / np.sqrt(D)
    rng = np.random.default_rng(70 + D)
    q, k, v, g = (rng.normal(size=(BH, S, D)).astype(np.float32)
                  for _ in range(4))
    jout, vjp = jax.vjp(lambda a, b, c: jdn._flash_fold(a, b, c, sm),
                        *(jnp.asarray(x) for x in (q, k, v)))
    jgrads = vjp(jnp.asarray(g))

    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    _build.reset_launch_counts()
    tout = flash_fold(tq, tk, tv, sm)
    assert _build.launch_counts["dense_attention"] == 0  # the CPU twin
    np.testing.assert_array_equal(
        tout.detach().numpy(),
        dense_attention_plain(*(torch.from_numpy(x) for x in (q, k, v)), sm,
                              torch.float32).numpy())
    tgrads = torch.autograd.grad(tout, (tq, tk, tv), torch.from_numpy(g))
    for name, tg, jg in zip("qkv", tgrads, jgrads):
        rel = _rel(tg.numpy(), jg)
        print(f"d{name}, D={D}: rel {rel:.3g} against jax.vjp(_flash_fold)")
        assert tg.dtype == torch.float32 and rel < 1e-5
    print(f"forward, D={D}: rel {_rel(tout.detach().numpy(), jout):.3g}")


def test_long_attention_sends_gradient_to_q_k_and_v():
    """Unmasked attention at Skv >= 1024 goes through `flash_fold`: q, k and
    v get the einsum path's gradients (the same f32 formula), so the
    projections before them learn."""
    B, S, H, Hd = 1, 1024, 2, 8
    rng = np.random.default_rng(80)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, S, H, Hd))
                                .astype(np.float32)).requires_grad_()
               for _ in range(3))
    w = torch.from_numpy(rng.normal(size=(B, S, H, Hd)).astype(np.float32))
    flash = torch.autograd.grad((tdn.attention(q, k, v) * w).sum(), (q, k, v))
    einsum = torch.autograd.grad(
        (tdn.attention(q, k, v, flash=False) * w).sum(), (q, k, v))
    for a, b in zip(flash, einsum):
        assert float(a.norm()) > 0
        assert _rel(a.numpy(), b.numpy()) < 1e-5
