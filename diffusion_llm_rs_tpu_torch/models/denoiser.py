"""Transformer denoiser: parameters, forward pass, token readout.

Counterpart of `diffusion_llm_rs_tpu/models/denoiser.py`: a pre-LN
bidirectional transformer over continuous token embeddings x [B, S, D] with
per-sample timesteps t [B]; sinusoidal timestep embedding through a 2-layer
MLP added to every position, learned positional embeddings, fused QKV
projection, GELU MLP, eps-prediction head, weight-tied logits readout.

Parameters are a plain nested dict of tensors (same keys as the JAX tree).
Weights may be plain tensors, `Int8Weight`s (the W4A8 decoded path), packed
`MatmulWeight`s, `QuantizedTensor`s or `Fp8Tensor`s: every linear goes
through `ops.matmul.linear`, an MLP block over two `Int8Weight`s through the
`int8w_mlp` kernel (any other pair through two linears), and unmasked
attention at Skv >= 1024 through the `dense_attention` kernel. The
embedding table may be quantized too; it is dequantized where it is read.
Attention reads this step's K/V, or the previous step's: dequantized
(`cached_kv`) through the ordinary attention, or packed (`cached_qkv`, one
`QuantKV` pair per layer) through the quantized-KV kernel. A caller that owns
attention (the paged serving step) passes `attend_fn`.

`init_simple_denoiser` and `simple_denoiser_forward` are the one-matrix model
of the examples and tests.

`tap(name, input)` sees the input of every linear before it runs, named by
its weight's path ("blocks/0/mlp/w1"): GPTQ collects its Hessians through
it. With a tap the MLP takes its two linears, so the inner activation is
seen too.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from diffusion_llm_rs_tpu_torch.config import DiffusionConfig
from diffusion_llm_rs_tpu_torch.ops.attention import (attention as
                                                      quant_attention,
                                                      flash_fold)
from diffusion_llm_rs_tpu_torch.ops.matmul import Int8Weight, int8_mlp, linear

Params = Dict[str, Any]


def init_simple_denoiser(generator: torch.Generator, input_dim: int,
                         output_dim: Optional[int] = None) -> Params:
    """One [input_dim, output_dim] matrix of N(0, 0.02) draws and a zero
    bias, on the generator's device."""
    output_dim = output_dim or input_dim
    w = torch.randn((input_dim, output_dim), generator=generator,
                    dtype=torch.float32, device=generator.device) * 0.02
    return {"w": w, "b": torch.zeros((output_dim,), dtype=torch.float32,
                                     device=generator.device)}


def simple_denoiser_forward(params: Params, x: torch.Tensor,
                            t: torch.Tensor) -> torch.Tensor:
    """y = x @ W + b; the timestep is ignored."""
    del t
    return linear(x, params["w"], params["b"])


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep features [B] -> [B, dim] (f32)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) *
                      torch.arange(half, dtype=torch.float32, device=t.device)
                      / half)
    args = t.to(torch.float32)[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.nn.functional.pad(emb, (0, 1))
    return emb


def init_denoiser_params(generator: torch.Generator,
                         cfg: DiffusionConfig) -> Params:
    """Random f32 parameters on the generator's device (N(0, 1) draws scaled
    as in the JAX package; the draws themselves differ from JAX's)."""
    D = cfg.hidden_size
    M = cfg.mlp_ratio * D
    out_scale = 0.02 / math.sqrt(2 * cfg.num_layers)
    dev = generator.device

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=dev) * scale

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32, device=dev)

    def ln():
        return {"scale": torch.ones((D,), dtype=torch.float32, device=dev),
                "bias": zeros(D)}

    params: Params = {
        "tok_embed": normal((cfg.vocab_size, D), 0.02),
        "pos_embed": normal((cfg.max_sequence_length, D), 0.01),
        "time_mlp": {"w1": normal((D, 4 * D), 0.02), "b1": zeros(4 * D),
                     "w2": normal((4 * D, D), 0.02), "b2": zeros(D)},
        "ln_f": ln(),
        "head": {"w": normal((D, D), 0.02)},
        "blocks": [],
    }
    for _ in range(cfg.num_layers):
        params["blocks"].append({
            "ln1": ln(),
            "attn": {"wqkv": normal((D, 3 * D), 0.02),
                     "wo": normal((D, D), out_scale)},
            "ln2": ln(),
            "mlp": {"w1": normal((D, M), 0.02), "b1": zeros(M),
                    "w2": normal((M, D), out_scale), "b2": zeros(D)},
        })
    return params


def layer_norm(x: torch.Tensor, p: Params, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with population variance."""
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return y * p["scale"].to(x.dtype) + p["bias"].to(x.dtype)


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    B, S, D = x.shape
    return x.reshape(B, S, num_heads, D // num_heads)


def attention(
    q: torch.Tensor,  # [B, S, H, Hd]
    k: torch.Tensor,  # [B, Skv, H, Hd]
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,  # [B, 1, S, Skv] additive
    flash: bool = True,
) -> torch.Tensor:
    """Bidirectional attention. Unmasked at Skv >= 1024: the `dense_attention`
    kernel over heads folded into the batch (`flash_fold`, differentiable).
    Otherwise: f32 logits from the working-dtype operands, f32 softmax,
    probabilities cast back to the working dtype, f32 accumulation."""
    B, S, H, Hd = q.shape
    if flash and mask is None and k.shape[1] >= 1024:
        def fold(x):  # [B, S, H, Hd] -> [B*H, S, Hd]
            return x.transpose(1, 2).reshape(B * H, -1, Hd)

        out = flash_fold(fold(q), fold(k), fold(v), 1.0 / math.sqrt(Hd))
        return out.reshape(B, H, S, Hd).transpose(1, 2)
    logits = torch.einsum("bshd,bthd->bhst", q.to(torch.float32),
                          k.to(torch.float32))
    logits = logits / math.sqrt(Hd)
    if mask is not None:
        logits = logits + mask
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhst,bthd->bshd", probs.to(torch.float32),
                       v.to(torch.float32))
    return out.to(q.dtype)


def denoiser_forward(
    params: Params,
    cfg: DiffusionConfig,
    x: torch.Tensor,                 # [B, S, D] noisy embeddings
    t: torch.Tensor,                 # [B]
    cached_kv=None,
    attn_mask: Optional[torch.Tensor] = None,  # [B, S] 1 = keep
    return_kv: bool = False,
    return_hidden: bool = False,
    cached_qkv=None,
    attend_fn=None,
    flash_attn: bool = True,
    tap=None,
):
    """Predict noise eps [B, S, D] in x's dtype; with `return_kv` also this
    step's K/V stacked as [L, B, S, H, Hd], with `return_hidden` the final
    hidden state. With `cached_kv` ([L, B, Skv, H, Hd] keys and values) the
    attention of every layer reads the cache in place of this step's K/V;
    with `cached_qkv` (one packed `QuantKV` pair [B*H, Skv, Hd] per layer) it
    reads it through the quantized-KV kernel, which takes no mask.
    `attend_fn(layer_idx, q, k, v, mask) -> [B, S, H, Hd]` takes the place of
    attention in every layer; its result is cast to the working dtype.
    `tap(name, input)` is called with each linear's input, in JAX's order and
    with JAX's names."""
    has_tap = tap is not None
    if tap is None:
        def tap(name, value):
            del name, value
    B, S, D = x.shape
    if S > cfg.max_sequence_length:
        raise ValueError(
            f"sequence length {S} exceeds max_sequence_length "
            f"{cfg.max_sequence_length}")
    H = cfg.num_attention_heads
    dtype = x.dtype

    temb = timestep_embedding(t, D)
    tm = params["time_mlp"]
    tap("time_mlp/w1", temb)
    t_in = linear(temb.to(dtype), tm["w1"], tm["b1"], activation="gelu")
    tap("time_mlp/w2", t_in)
    temb = linear(t_in, tm["w2"], tm["b2"])
    h = x + params["pos_embed"][:S].to(dtype)[None] + temb[:, None, :]

    mask = None
    if attn_mask is not None:
        mask = (1.0 - attn_mask[:, None, None, :].to(torch.float32)) * -1e9

    new_ks, new_vs = [], []
    for li, blk in enumerate(params["blocks"]):
        hn = layer_norm(h, blk["ln1"])
        a = blk["attn"]
        tap(f"blocks/{li}/attn/wqkv", hn)
        qkv = linear(hn, a["wqkv"])  # [B, S, 3D]
        q = _split_heads(qkv[..., :D], H)
        k = _split_heads(qkv[..., D:2 * D], H)
        v = _split_heads(qkv[..., 2 * D:], H)
        if return_kv:
            new_ks.append(k)
            new_vs.append(v)
        if attend_fn is not None:
            # the caller owns attention (paged serving: write this step's
            # K/V into the pages, then attend over them)
            attn_out = attend_fn(li, q, k, v, mask).to(dtype)
        elif cached_qkv is not None:
            if mask is not None:
                # the quantized-KV kernel has no mask input; attending over
                # padding would be wrong
                raise ValueError(
                    "attn_mask is not supported with cached_qkv — use the "
                    "einsum path (cached_kv) or attend_fn")
            qk, qv = cached_qkv[li]
            q_r = q.transpose(1, 2).reshape(B * H, S, D // H)
            attn_out = quant_attention(q_r, qk, qv)
            attn_out = attn_out.reshape(B, H, S, D // H).transpose(1, 2)
            attn_out = attn_out.to(dtype)
        else:
            if cached_kv is not None:
                k = cached_kv[0][li].to(dtype)
                v = cached_kv[1][li].to(dtype)
            attn_out = attention(q, k, v, mask, flash=flash_attn)
        ao = attn_out.reshape(B, S, D)
        tap(f"blocks/{li}/attn/wo", ao)
        h = linear(ao, a["wo"], residual=h)

        hn = layer_norm(h, blk["ln2"])
        m = blk["mlp"]
        tap(f"blocks/{li}/mlp/w1", hn)
        if (isinstance(m["w1"], Int8Weight) and isinstance(m["w2"], Int8Weight)
                and not has_tap):
            h = int8_mlp(hn, m["w1"], m["b1"], m["w2"], m["b2"], residual=h)
        else:
            inner = linear(hn, m["w1"], m["b1"], activation="gelu")
            tap(f"blocks/{li}/mlp/w2", inner)
            h = linear(inner, m["w2"], m["b2"], residual=h)

    h = layer_norm(h, params["ln_f"])
    tap("head/w", h)
    eps = linear(h, params["head"]["w"])

    outs = [eps]
    if return_kv:
        outs.append((torch.stack(new_ks), torch.stack(new_vs)))
    if return_hidden:
        outs.append(h)
    return outs[0] if len(outs) == 1 else tuple(outs)


def _embedding_table(params: Params) -> torch.Tensor:
    emb = params["tok_embed"]
    # a plain tensor, or a quantized layout (QuantizedTensor, Int8Weight)
    return emb if isinstance(emb, torch.Tensor) else emb.dequantize()


def embed_tokens(params: Params, token_ids: torch.Tensor,
                 dtype=torch.float32) -> torch.Tensor:
    """Token ids [B, S] -> continuous embeddings [B, S, D]."""
    return _embedding_table(params)[token_ids].to(dtype)


def logits_from_hidden(params: Params, h: torch.Tensor) -> torch.Tensor:
    """Weight-tied readout: hidden [B, S, D] -> f32 logits [B, S, V]."""
    return torch.einsum("bsd,vd->bsv", h.to(torch.float32),
                        _embedding_table(params).to(torch.float32))


def decode_tokens(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Map denoised embeddings [B, S, D] to nearest-token ids [B, S]."""
    return torch.argmax(logits_from_hidden(params, x), dim=-1)
