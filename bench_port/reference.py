"""The plain reference: the served model in float32, plain PyTorch.

It imports nothing of the program. From the f32 weights of the seed
(`model.make_weights`) it works out again the quantization the
configuration states: every linear's weight int4, symmetric, in groups of
128 along K, then re-gridded onto a per-column int8 grid (the column's
largest dequantized magnitude over 127); the token table int4 symmetric
per column; the linears' inputs quantized per row to int8 (largest
magnitude over 127, rounded half to even); and, in the server, each
layer's K and V quantized per token and head at the width the request's
phase routes it to (min-max, 8 bits while t > num_steps / 2, then a
target falling from 4 to 2 bits, rounded down onto {2, 4}). Everything
else runs in float32.

`mode` names the precision of the activations: "f32" is the reference;
"fp8" rounds every activation the configuration states in bfloat16 through
float8 e4m3 with a per-row scale (the control, one step below bfloat16).

The model is the continuous-embedding diffusion LM of Diffusion-LM (Li et
al. 2022, arXiv:2205.14217) on GPT-2's pre-LN block: a sinusoidal
timestep embedding through a 2-layer GELU MLP added to every position,
learned positions, bidirectional attention, a GELU MLP, an eps head, the
DDPM posterior step, and a readout onto the token table.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from bench_port.model import Dims

FP8_MAX = 448.0


def _rounder(mode: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if mode == "f32":
        return lambda x: x
    if mode == "fp8":
        def fp8(x):
            amax = x.abs().amax(dim=-1, keepdim=True)
            s = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
            return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s
        return fp8
    raise ValueError(f"unknown precision {mode!r}")


def gelu_tanh(y: torch.Tensor) -> torch.Tensor:
    return y * (0.5 * (1.0 + torch.tanh(
        math.sqrt(2.0 / math.pi) * (y + 0.044715 * y * y * y))))


def quant_rows(x: torch.Tensor):
    """Per-row symmetric int8: (levels as f32, scales [..., 1])."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    s = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                    torch.ones_like(amax))
    return torch.round(x / s), s


def w4a8_weight(w: torch.Tensor, group: int = 128):
    """W [K, N] -> (int8 levels as f32 [K, N], column scales [N]): int4
    symmetric groups of `group` along K (scale = max|w| / 8, levels
    round(w / scale) + 8 clipped to [0, 15]), then the per-column int8 grid
    of the dequantized weight."""
    K, N = w.shape
    wg = w.reshape(K // group, group, N)
    amax = wg.abs().amax(dim=1, keepdim=True)
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 8.0),
                        torch.ones_like(amax))
    lv = torch.clamp(torch.round(wg / scale + 8.0), 0.0, 15.0)
    deq = (lv - 8.0) * scale
    cs = torch.clamp_min(deq.abs().amax(dim=(0, 1)) /
                         torch.full((N,), 127.0, device=w.device), 1e-12)
    w8 = torch.round((lv - 8.0) * (scale * (1.0 / cs))).clamp(-127.0, 127.0)
    return w8.reshape(K, N), cs


def token_table(e: torch.Tensor) -> torch.Tensor:
    """The token table [V, D] as served: int4 symmetric per column."""
    amax = e.abs().amax(dim=0, keepdim=True)
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 8.0),
                        torch.ones_like(amax))
    lv = torch.clamp(torch.round(e / scale + 8.0), 0.0, 15.0)
    return (lv - 8.0) * scale


def kv_fake_quant(z: torch.Tensor, bits: int) -> torch.Tensor:
    """Per-(token, head) min-max quantization over the head's channels,
    and back: z [..., Hd]."""
    qmax = float((1 << bits) - 1)
    mn = z.amin(dim=-1, keepdim=True)
    rng = z.amax(dim=-1, keepdim=True) - mn
    scale = torch.where(rng > 0, rng / torch.full_like(rng, qmax),
                        torch.ones_like(rng))
    zp = -mn / scale
    lv = torch.clamp(torch.round(z / scale + zp), 0.0, qmax)
    return (lv - zp) * scale


def phase_bits(d: Dims, t: int, total: int) -> int:
    """The KV width a request at step t of `total` reads: the prefill
    width while t > total // 2, then a target falling linearly from the
    decode width to the least one, rounded down onto the supported widths
    at or above the least (float32, in this order of operations)."""
    half = total // 2
    if t > half:
        return d.prefill_bits
    f32 = np.float32
    progress = np.clip(f32(half - t) / f32(max(half, 1)), f32(0), f32(1))
    target = (f32(d.decode_bits) * (f32(1) - progress) +
              f32(d.min_decode_bits) * progress)
    target = max(target, f32(d.min_decode_bits))
    widths = [b for b in (1, 2, 4, 8)
              if d.min_decode_bits <= b <= d.decode_bits]
    bits = widths[0]
    for b in widths:
        if target >= b:
            bits = b
    return bits


def respaced(T: int, n: int) -> list:
    """Timesteps T-1 .. 0 in n steps: round(linspace(T - 1, 0, n)), the
    reciprocal of n - 1 taken in float32 first; the last is 0."""
    if n == T:
        return list(range(T - 1, -1, -1))
    if n == 1:
        return [T - 1]
    inv = np.float32(1.0) / np.float32(n - 1)
    out = np.float32(T - 1) * (np.float32(1) -
                               np.arange(n - 1, dtype=np.float32) * inv)
    return [int(v) for v in np.round(out)] + [0]


class Reference:
    """The served model in plain PyTorch from f32 weights `w` (the layout
    of `model.make_weights`), on `device`."""

    def __init__(self, d: Dims, w: dict, device, mode: str = "f32"):
        self.d = d
        self.rnd = _rounder(mode)
        self.device = torch.device(device)
        g = d.weight_group

        def lin(w_, b=None):
            w8, cs = w4a8_weight(w_.to(self.device, torch.float32), g)
            return (w8, cs, None if b is None else b.to(self.device))

        tm = w["time_mlp"]
        self.time1 = lin(tm["w1"], tm["b1"])
        self.time2 = lin(tm["w2"], tm["b2"])
        self.head = lin(w["head"]["w"])
        self.pos = w["pos_embed"].to(self.device)
        self.ln_f = w["ln_f"]
        self.blocks = [dict(ln1=b["ln1"], ln2=b["ln2"],
                            qkv=lin(b["attn"]["wqkv"]),
                            wo=lin(b["attn"]["wo"]),
                            w1=lin(b["mlp"]["w1"], b["mlp"]["b1"]),
                            w2=lin(b["mlp"]["w2"], b["mlp"]["b2"]))
                       for b in w["blocks"]]
        self.table = token_table(w["tok_embed"].to(self.device))
        betas = torch.linspace(d.beta_start, d.beta_end, d.num_timesteps,
                               dtype=torch.float64)
        alphas = 1.0 - betas
        abar = torch.cumprod(alphas, 0)
        abar_prev = torch.cat([torch.ones(1, dtype=torch.float64),
                               abar[:-1]])
        self.betas, self.alphas = betas, alphas
        self.sqrt_1m_abar = torch.sqrt(1.0 - abar)
        self.post_var = betas * (1.0 - abar_prev) / (1.0 - abar)

    # -- the denoiser ------------------------------------------------------

    def linear(self, x, p, residual=None, gelu=False):
        w8, cs, b = p
        xi, sx = quant_rows(x)
        y = (xi @ w8) * sx * cs
        if b is not None:
            y = y + b
        if gelu:
            y = gelu_tanh(y)
        if residual is not None:
            y = y + residual
        return y

    @staticmethod
    def layer_norm(x, p):
        mu = x.mean(dim=-1, keepdim=True)
        var = x.var(dim=-1, unbiased=False, keepdim=True)
        return (x - mu) * torch.rsqrt(var + 1e-5) * p["scale"] + p["bias"]

    def time_embedding(self, t: torch.Tensor) -> torch.Tensor:
        D = self.d.hidden
        half = D // 2
        freqs = torch.exp(-math.log(10000.0) * torch.arange(
            half, dtype=torch.float32, device=t.device) / half)
        args = t.to(torch.float32)[:, None] * freqs[None, :]
        return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)

    def attention(self, q, k, v, kv_bits: Optional[int]):
        """q, k, v [B, L, H, Hd]; K and V through their quantization at
        `kv_bits` (None: as they are)."""
        r = self.rnd
        if kv_bits is not None:
            k, v = r(kv_fake_quant(k, kv_bits)), r(kv_fake_quant(v, kv_bits))
        Hd = q.shape[-1]
        s = torch.einsum("bqhd,bkhd->bhqk", q, k)
        p = r(torch.softmax(s / math.sqrt(Hd), dim=-1))
        return torch.einsum("bhqk,bkhd->bqhd", p, v)

    def eps(self, x: torch.Tensor, t: torch.Tensor,
            kv_bits: Optional[int] = None) -> torch.Tensor:
        """eps [B, L, D] of x [B, L, D] at timesteps t [B]."""
        r, d = self.rnd, self.d
        B, L, D = x.shape
        H = d.heads
        temb = self.time_embedding(t)
        t_in = r(self.linear(r(temb), self.time1, gelu=True))
        temb = r(self.linear(t_in, self.time2))
        h = r(r(x) + r(self.pos[:L])[None] + temb[:, None, :])
        for blk in self.blocks:
            hn = r(self.layer_norm(h, blk["ln1"]))
            qkv = r(self.linear(hn, blk["qkv"]))
            q, k, v = (qkv[..., i * D:(i + 1) * D].reshape(B, L, H, D // H)
                       for i in range(3))
            a = r(self.attention(q, k, v, kv_bits)).reshape(B, L, D)
            h = r(self.linear(a, blk["wo"], residual=h))
            hn = r(self.layer_norm(h, blk["ln2"]))
            inner = self.linear(hn, blk["w1"], gelu=True)
            h = r(self.linear(inner, blk["w2"], residual=h))
        h = r(self.layer_norm(h, self.ln_f))
        return r(self.linear(h, self.head))

    # -- the diffusion step and the readout ---------------------------------

    def p_sample(self, x, t: int, eps, noise):
        beta = float(self.betas[t])
        alpha = float(self.alphas[t])
        mean = (x - (beta / float(self.sqrt_1m_abar[t])) * eps) / \
            math.sqrt(alpha)
        if t == 0:
            return mean
        return mean + math.sqrt(float(self.post_var[t])) * noise

    def chain(self, x: torch.Tensor, timesteps: Sequence[int],
              noises: Callable[[int], torch.Tensor],
              kv_bits: Callable[[int], Optional[int]] = lambda t: None
              ) -> torch.Tensor:
        """x after the reverse steps at `timesteps` (one t for every row),
        the i-th step's noise `noises(i)`."""
        for i, t in enumerate(timesteps):
            tv = torch.full((x.shape[0],), t, dtype=torch.int64,
                            device=x.device)
            x = self.p_sample(x, t, self.eps(x, tv, kv_bits(t)), noises(i))
        return x

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """Readout [..., V] of embeddings [..., D] onto the token table."""
        return x @ self.table.T

    def token_gap(self, x: torch.Tensor, tokens: torch.Tensor) -> float:
        """Widest gap by which a served token's logit lies below the best,
        both read at the reference's embeddings x [L, D]."""
        lg = self.logits(x)
        best = lg.amax(dim=-1)
        served = lg.gather(-1, tokens.to(lg.device).long()[..., None])[..., 0]
        return float((best - served).amax())
