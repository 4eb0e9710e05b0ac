"""Phase-aware quantized sampling loop over a KV cache carried between steps.

Counterpart of `diffusion_llm_rs_tpu/models/sampler.py`: `SUPPORTED`,
`bucket_bits`, `bucket_bits_up` (fractional bit targets of the
progressive-precision schedule land on the supported power-of-two widths;
the serving routers use them too), `plan_segments` and `phase_aware_sample`.

The reverse loop t = T-1 .. 0 is cut into segments of one KV bit-width each:
prefill bits while t > T/2, then decode bits falling to min_decode_bits.
Every step attends over the *previous* step's quantized K/V, emits fresh K/V
and requantizes them at the segment's width; at a segment boundary the carry
is dequantized and requantized at the new width. With `kernel_cache` the
carry is one `QuantKV` pair per layer, read packed by the quantized-KV
attention kernel (`ops.attention.attention`); without it a `QuantizedTensor`
pair that is dequantized in front of the ordinary attention. Where the JAX
package scans each segment inside one compiled program, this port runs the
same steps eagerly in a Python loop.

Randomness comes from a noise source as in `serving` (`admission(shape)` for
the initial x, `step(shape)` once per denoise step, in execution order), or
from a `torch.Generator`, which is wrapped in one.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

from diffusion_llm_rs_tpu_torch.config import DiffusionConfig
from diffusion_llm_rs_tpu_torch.models import denoiser as dn
from diffusion_llm_rs_tpu_torch.models.diffusion import (DiffusionSchedule,
                                                         p_sample)
from diffusion_llm_rs_tpu_torch.ops.attention import QuantKV, quantize_kv
from diffusion_llm_rs_tpu_torch.quant.core import dequantize, quantize

SUPPORTED = (8, 4, 2, 1)


def bucket_bits(target: float) -> int:
    """Round a fractional target bit-width down onto a supported width."""
    for b in SUPPORTED:
        if target >= b:
            return b
    return SUPPORTED[-1]


def bucket_bits_up(target: float) -> int:
    """Smallest supported width >= target: the floor of the decode schedule
    (a configured min_decode_bits of 3 floors the schedule at 4, not 2)."""
    for b in reversed(SUPPORTED):
        if b >= target:
            return b
    return SUPPORTED[0]


def plan_segments(num_steps: int,
                  cfg: DiffusionConfig) -> List[Tuple[int, int, int]]:
    """Static (bits, t_hi, t_lo) segments for the reverse loop t = T-1 .. 0,
    in execution order (t descending); t_lo is inclusive. Prefill phase iff
    t > num_steps/2, at prefill_bits; in the decode phase the bits
    interpolate decode_bits -> min_decode_bits with progress = (half - t) /
    half, rounded down onto the supported widths but never below the
    rounded-up floor."""
    qc = cfg.quant_config
    half = num_steps // 2
    segs: List[Tuple[int, int, int]] = []
    for t in range(num_steps - 1, -1, -1):
        if not cfg.use_phase_aware_quant:
            bits = bucket_bits(cfg.kv_quant_bits or 8)
        elif t > half:
            bits = bucket_bits(qc.prefill_bits)
        elif qc.progressive_precision:
            progress = min(max((half - t) / max(half, 1), 0.0), 1.0)
            target = (qc.decode_bits * (1.0 - progress)
                      + qc.min_decode_bits * progress)
            bits = max(bucket_bits(max(target, qc.min_decode_bits)),
                       bucket_bits_up(qc.min_decode_bits))
        else:
            bits = bucket_bits(qc.decode_bits)
        if segs and segs[-1][0] == bits:
            segs[-1] = (bits, segs[-1][1], t)
        else:
            segs.append((bits, t, t))
    return segs


def _quantize_kv_pair(kv, bits: int, reciprocal: bool = False):
    """Per-token-per-head quantization of stacked K/V [L, B, S, H, Hd]: one
    (scale, zp) per (layer, batch, token, head) vector, a single group
    spanning the head_dim axis, the granularity of `quantize_kv`."""
    def q(arr):
        return quantize(arr.to(torch.float32), bits, granularity="group",
                        group_size=arr.shape[-1], axis=arr.ndim - 1,
                        reciprocal=reciprocal)
    return q(kv[0]), q(kv[1])


def _dequantize_kv_pair(qkv) -> Tuple[torch.Tensor, torch.Tensor]:
    return dequantize(qkv[0]), dequantize(qkv[1])


def _split_layers(q: QuantKV, L: int) -> List[QuantKV]:
    """A QuantKV over [L * BH, S, Hd] as L views of [BH, S, Hd]."""
    BH = q.data.shape[0] // L
    return [QuantKV(q.data[li * BH:(li + 1) * BH],
                    q.scale[li * BH:(li + 1) * BH],
                    q.zero_point[li * BH:(li + 1) * BH], q.bits, q.D)
            for li in range(L)]


def _quantize_kv_packed(kv, bits: int, reciprocal: bool = False):
    """Quantize stacked K/V [L, B, S, H, Hd] into per-layer packed `QuantKV`
    pairs ([B*H, S, Hd] layout) for the quantized-KV attention kernel. All
    layers go through one `quantize_kv` call on [L*B*H, S, Hd]: rows are
    independent, so the result equals a per-layer loop, in two launches of
    each op instead of 2 L."""
    L, B, S, H, Hd = kv[0].shape

    def fold(arr):
        return arr.permute(0, 1, 3, 2, 4).reshape(L * B * H, S, Hd)

    ks = _split_layers(quantize_kv(fold(kv[0]), bits, reciprocal), L)
    vs = _split_layers(quantize_kv(fold(kv[1]), bits, reciprocal), L)
    return tuple(zip(ks, vs))


def _requantize_packed(qkv, bits: int):
    """Segment boundary: the packed carry dequantized and quantized again at
    the new width."""
    return tuple((quantize_kv(k.dequantize(), bits),
                  quantize_kv(v.dequantize(), bits)) for k, v in qkv)


def phase_aware_sample(
    params,
    cfg: DiffusionConfig,
    schedule: DiffusionSchedule,
    shape: Tuple[int, int],          # (batch, seq_len)
    noise,
    num_steps: Optional[int] = None,
    *,
    use_cache: bool = True,
    kernel_cache: bool = True,
    forward_fn: Optional[Callable] = None,
) -> torch.Tensor:
    """Sample [batch, seq, hidden] embeddings via phase-aware quantized KV,
    on the schedule's device.

    `noise` is a noise source (`admission(shape)` gives the initial x,
    `step(shape)` each step's noise) or a `torch.Generator` on that device.
    `forward_fn(params, cfg, x, t, cached_kv=..., cached_qkv=...,
    return_kv=...)` defaults to the transformer denoiser. Returns the
    denoised embeddings; token decode is a separate readout
    (`models.denoiser.decode_tokens`)."""
    if isinstance(noise, torch.Generator):
        from diffusion_llm_rs_tpu_torch.serving import GeneratorNoise
        noise = GeneratorNoise(noise)
    batch, seq_len = shape
    T = num_steps or cfg.num_timesteps
    fwd = forward_fn or dn.denoiser_forward
    device = schedule.betas.device
    xshape = (batch, seq_len, cfg.hidden_size)

    def t_vec(t_scalar: int) -> torch.Tensor:
        return torch.full((batch,), t_scalar, dtype=torch.int64, device=device)

    def step_noise() -> torch.Tensor:
        return noise.step(xshape).to(device)

    x = noise.admission(xshape).to(device=device, dtype=torch.float32)

    if not use_cache or not cfg.use_kv_cache:
        for t in range(T - 1, -1, -1):
            z = step_noise()
            eps = fwd(params, cfg, x, t_vec(t))
            x = p_sample(schedule, x, t_vec(t), eps, noise=z)
        return x

    segments = plan_segments(T, cfg)

    # Bootstrap step (t = T-1): no cache yet, so the first step attends over
    # its own fresh K/V, quantized afterwards at the first segment's bits.
    z = step_noise()
    eps, kv = fwd(params, cfg, x, t_vec(T - 1), return_kv=True)
    x = p_sample(schedule, x, t_vec(T - 1), eps, noise=z)
    carry_bits = segments[0][0]
    requantize = _quantize_kv_packed if kernel_cache else _quantize_kv_pair
    qkv = requantize(kv, carry_bits)

    # the first segment already consumed one step (t = T-1)
    remaining = [(segments[0][0], segments[0][1] - 1, segments[0][2])]
    remaining += segments[1:]
    for bits, hi, lo in remaining:
        if hi < lo:
            continue
        if carry_bits != bits:
            # segment boundary: requantize the carry at the new width
            if kernel_cache:
                qkv = _requantize_packed(qkv, bits)
            else:
                qkv = _quantize_kv_pair(_dequantize_kv_pair(qkv), bits)
            carry_bits = bits
        for t in range(hi, lo - 1, -1):
            z = step_noise()
            if kernel_cache:
                eps, kv = fwd(params, cfg, x, t_vec(t), cached_qkv=qkv,
                              return_kv=True)
            else:
                eps, kv = fwd(params, cfg, x, t_vec(t),
                              cached_kv=_dequantize_kv_pair(qkv),
                              return_kv=True)
            # in the JAX package this requantization is compiled into the
            # segment's scan (the bootstrap's and the boundary's run eagerly)
            qkv = requantize(kv, bits, reciprocal=True)
            x = p_sample(schedule, x, t_vec(t), eps, noise=z)
    return x
