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
package scans each segment inside one compiled program, this port replays
one captured step a segment on the card (`utils.graphs`; a graph per branch
and bit-width, cached per (forward_fn, shape) while forward_fn lives), with
x, t, the noise and the carry as static buffers the step writes in place.
The bootstrap step and each boundary's requantization run eagerly, as in
JAX.

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
from diffusion_llm_rs_tpu_torch.utils import graphs

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


def _quantize_kv_stacked(kv, bits: int, reciprocal: bool = False):
    """Quantize stacked K/V [L, B, S, H, Hd] into one packed `QuantKV` pair
    over [L*B*H, S, Hd] (the carry of the packed branch; `_split_layers`
    views it per layer). Rows are independent, so the result equals a
    per-layer loop, in two launches of each op instead of 2 L."""
    L, B, S, H, Hd = kv[0].shape

    def fold(arr):
        return arr.permute(0, 1, 3, 2, 4).reshape(L * B * H, S, Hd)

    return (quantize_kv(fold(kv[0]), bits, reciprocal),
            quantize_kv(fold(kv[1]), bits, reciprocal))


def _requantize_stacked(qkv, bits: int):
    """Segment boundary: the stacked packed carry dequantized and quantized
    again at the new width (row by row, as JAX's per-layer loop)."""
    return tuple(quantize_kv(q.dequantize(), bits) for q in qkv)


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
    (`models.denoiser.decode_tokens`). On the card the steps replay
    captured graphs: `forward_fn` must draw nothing and do no host work
    (or run under `utils.graphs.disabled()`)."""
    if isinstance(noise, torch.Generator):
        from diffusion_llm_rs_tpu_torch.serving import GeneratorNoise
        noise = GeneratorNoise(noise)
    batch, seq_len = shape
    T = num_steps or cfg.num_timesteps
    fwd = forward_fn or dn.denoiser_forward
    device = schedule.betas.device
    xshape = (batch, seq_len, cfg.hidden_size)
    L = cfg.num_layers
    # the steps' Python reads the config, so their graphs are keyed by it
    cache = graphs.cache_for(fwd, (xshape, device, repr(cfg)),
                             "phase_aware_sample", device)
    xs = cache.buffer("x", lambda: torch.empty(xshape, dtype=torch.float32,
                                                 device=device))
    t_vec = cache.buffer("t", lambda: torch.empty(
        (batch,), dtype=torch.int64, device=device))
    zs = cache.buffer("noise", lambda: torch.empty(
        xshape, dtype=torch.float32, device=device))
    held = graphs.pointers(params, schedule)
    xs.copy_(noise.admission(xshape))

    def inputs(t: int) -> None:
        zs.copy_(noise.step(xshape))
        t_vec.fill_(t)

    def advance(eps) -> None:
        xs.copy_(p_sample(schedule, xs, t_vec, eps, noise=zs))

    if not use_cache or not cfg.use_kv_cache:
        def plain_step():
            advance(fwd(params, cfg, xs, t_vec))
        for t in range(T - 1, -1, -1):
            inputs(t)
            cache.run("no_cache", plain_step, held)
        return xs.clone()

    segments = plan_segments(T, cfg)

    # Bootstrap step (t = T-1), eagerly: no cache yet, so the first step
    # attends over its own fresh K/V, quantized afterwards at the first
    # segment's bits.
    inputs(T - 1)
    eps, kv = fwd(params, cfg, xs, t_vec, return_kv=True)
    advance(eps)
    carry_bits = segments[0][0]
    requantize = _quantize_kv_stacked if kernel_cache else _quantize_kv_pair
    qkv = requantize(kv, carry_bits)

    # the first segment already consumed one step (t = T-1)
    remaining = [(segments[0][0], segments[0][1] - 1, segments[0][2])]
    remaining += segments[1:]
    for bits, hi, lo in remaining:
        if hi < lo:
            continue
        if carry_bits != bits:
            # segment boundary, eagerly as in JAX: requantize the carry at
            # the new width
            if kernel_cache:
                qkv = _requantize_stacked(qkv, bits)
            else:
                qkv = _quantize_kv_pair(_dequantize_kv_pair(qkv), bits)
            carry_bits = bits
        # the segment's carry is a static buffer its step graph writes in
        # place, JAX's scan carry
        key = ("packed" if kernel_cache else "dequantized", bits)
        carry = cache.buffer(key, lambda: graphs.clone(qkv))
        graphs.copy_into(carry, qkv)
        if kernel_cache:
            layers = tuple(zip(_split_layers(carry[0], L),
                               _split_layers(carry[1], L)))

            def step(carry=carry, layers=layers, bits=bits):
                eps, kv = fwd(params, cfg, xs, t_vec, cached_qkv=layers,
                              return_kv=True)
                graphs.copy_into(carry, requantize(kv, bits, reciprocal=True))
                advance(eps)
        else:
            def step(carry=carry, bits=bits):
                eps, kv = fwd(params, cfg, xs, t_vec,
                              cached_kv=_dequantize_kv_pair(carry),
                              return_kv=True)
                graphs.copy_into(carry, requantize(kv, bits, reciprocal=True))
                advance(eps)
        for t in range(hi, lo - 1, -1):
            inputs(t)
            cache.run(key, step, held)
        qkv = carry
    return xs.clone()
