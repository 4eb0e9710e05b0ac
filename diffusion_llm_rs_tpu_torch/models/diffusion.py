"""DDPM diffusion core: noise schedules, forward process, losses, sampler.

Counterpart of `diffusion_llm_rs_tpu/models/diffusion.py`
(`create_beta_schedule`, `DiffusionSchedule`, `add_noise`, `p_losses`,
`p_sample`, `sample`). The posterior is the standard eps-prediction DDPM one:

    mean = (x_t - beta_t / sqrt(1 - alpha_bar_t) * eps_hat) / sqrt(alpha_t)
    var  = beta_t * (1 - alpha_bar_{t-1}) / (1 - alpha_bar_t)

The JAX sampler is a `lax.scan`; here it is a loop over the same precomputed
tables whose step, on the card, is a replayed CUDA graph (`utils.graphs`).
Randomness comes from an explicit `torch.Generator`, or is passed in (`x`,
`noises`) so a test can replay the JAX draws.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence, Tuple

import torch

from diffusion_llm_rs_tpu_torch.config import BetaSchedule
from diffusion_llm_rs_tpu_torch.utils import graphs


def create_beta_schedule(
    num_timesteps: int,
    beta_start: float = 1e-4,
    beta_end: float = 0.02,
    schedule: BetaSchedule = BetaSchedule.LINEAR,
    device="cuda",
) -> torch.Tensor:
    """Beta table [T] (f32) on `device`. Cosine follows Nichol & Dhariwal
    with s=0.008 via alpha_bar ratios, clipped at 0.999."""
    if num_timesteps <= 0:
        raise ValueError("num_timesteps must be positive")
    t = torch.arange(num_timesteps, dtype=torch.float32, device=device)
    denom = max(num_timesteps - 1, 1)
    if schedule == BetaSchedule.LINEAR:
        betas = beta_start + (beta_end - beta_start) * t / denom
    elif schedule == BetaSchedule.QUADRATIC:
        t_norm = t / denom
        betas = beta_start + (beta_end - beta_start) * t_norm * t_norm
    elif schedule == BetaSchedule.COSINE:
        s = 0.008
        steps = torch.arange(num_timesteps + 1, dtype=torch.float32,
                             device=device) / num_timesteps
        f = torch.cos((steps + s) / (1.0 + s) * math.pi / 2.0) ** 2
        abar = f / f[0]
        betas = torch.clamp(1.0 - abar[1:] / abar[:-1], 0.0, 0.999)
    else:
        raise ValueError(f"unknown schedule {schedule}")
    return betas.to(torch.float32)


def _cumprod(x: torch.Tensor, block: int = 16) -> torch.Tensor:
    """Inclusive f32 cumulative product in the order of XLA's cumulative
    reduce-window rewrite (sequential within blocks of 16, block prefixes by
    the same scan, recursively), so the tables equal the JAX package's bit
    for bit. The order matters: 1 - alpha_bar cancels near t = 0, where a
    last-bit difference in alpha_bar becomes ~1e-5 relative."""
    n = x.shape[0]
    if n <= block:
        return torch.cumprod(x, dim=0)
    nb = -(-n // block)
    padded = torch.ones(nb * block, dtype=x.dtype, device=x.device)
    padded[:n] = x
    local = padded.reshape(nb, block)
    for i in range(1, block):  # sequential f32 products within each block
        local[:, i] = local[:, i - 1] * local[:, i]
    prefix = _cumprod(local[:, -1].clone(), block)
    local[1:] = local[1:] * prefix[:-1, None]
    return local.reshape(-1)[:n]


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Precomputed schedule tables, each [T] f32, on the device given to
    `create` (the card unless the caller asks for the CPU); `sample` runs
    there."""

    betas: torch.Tensor
    alphas: torch.Tensor             # 1 - betas
    alpha_bars: torch.Tensor         # inclusive cumprod of alphas
    alpha_bars_prev: torch.Tensor    # alpha_bars shifted; abar_prev[0] = 1
    sqrt_alpha_bars: torch.Tensor
    sqrt_one_minus_alpha_bars: torch.Tensor
    posterior_variance: torch.Tensor  # beta_t*(1-abar_prev)/(1-abar)

    @property
    def num_timesteps(self) -> int:
        return self.betas.shape[0]

    @classmethod
    def create(
        cls,
        num_timesteps: int,
        beta_start: float = 1e-4,
        beta_end: float = 0.02,
        schedule: BetaSchedule = BetaSchedule.LINEAR,
        device="cuda",
    ) -> "DiffusionSchedule":
        betas = create_beta_schedule(num_timesteps, beta_start, beta_end,
                                     schedule, device)
        alphas = 1.0 - betas
        alpha_bars = _cumprod(alphas)
        alpha_bars_prev = torch.cat([torch.ones_like(alpha_bars[:1]),
                                     alpha_bars[:-1]])
        posterior_variance = betas * (1.0 - alpha_bars_prev) / (1.0 - alpha_bars)
        return cls(
            betas=betas,
            alphas=alphas,
            alpha_bars=alpha_bars,
            alpha_bars_prev=alpha_bars_prev,
            sqrt_alpha_bars=torch.sqrt(alpha_bars),
            sqrt_one_minus_alpha_bars=torch.sqrt(1.0 - alpha_bars),
            posterior_variance=posterior_variance,
        )


def _bcast(coeff_t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Reshape per-sample coefficients [B] to broadcast against x [B, ...]."""
    return coeff_t.reshape((x.shape[0],) + (1,) * (x.ndim - 1))


def _randn_like(x: torch.Tensor, generator: Optional[torch.Generator]):
    if generator is None:
        raise ValueError("provide `noise` or a torch.Generator")
    return torch.randn(x.shape, generator=generator, dtype=x.dtype,
                       device=x.device)


def add_noise(
    schedule: DiffusionSchedule,
    x_start: torch.Tensor,
    t: torch.Tensor,
    noise: Optional[torch.Tensor] = None,
    *,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward process q(x_t | x_0): sqrt(abar_t) x_0 + sqrt(1 - abar_t) eps.
    Returns (noisy, noise); `t` is a per-sample int vector [batch]."""
    if noise is None:
        noise = _randn_like(x_start, generator)
    t = torch.clamp(t, 0, schedule.num_timesteps - 1)
    sqrt_abar = _bcast(schedule.sqrt_alpha_bars[t], x_start)
    sqrt_1m = _bcast(schedule.sqrt_one_minus_alpha_bars[t], x_start)
    return sqrt_abar * x_start + sqrt_1m * noise, noise


def p_losses(
    model_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    schedule: DiffusionSchedule,
    x_start: torch.Tensor,
    t: torch.Tensor,
    noise: Optional[torch.Tensor] = None,
    *,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Per-sample MSE between predicted and actual noise."""
    noisy, noise = add_noise(schedule, x_start, t, noise, generator=generator)
    sq = (model_fn(noisy, t) - noise) ** 2
    return sq.reshape(sq.shape[0], -1).mean(dim=-1)


def p_sample(
    schedule: DiffusionSchedule,
    x_t: torch.Tensor,
    t: torch.Tensor,
    eps_pred: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One reverse step x_t -> x_{t-1}; Langevin noise except at t = 0."""
    t = torch.clamp(t, 0, schedule.num_timesteps - 1)
    beta_t = _bcast(schedule.betas[t], x_t)
    alpha_t = _bcast(schedule.alphas[t], x_t)
    sqrt_1m_abar = _bcast(schedule.sqrt_one_minus_alpha_bars[t], x_t)
    mean = (x_t - beta_t / sqrt_1m_abar * eps_pred) * torch.rsqrt(alpha_t)
    var = _bcast(schedule.posterior_variance[t], x_t)
    if noise is None:
        noise = _randn_like(x_t, generator)
    nonzero = _bcast((t > 0).to(x_t.dtype), x_t)
    return mean + nonzero * torch.sqrt(var) * noise


def respaced_timesteps(T: int, num_steps: int) -> list:
    """Timesteps T-1 .. 0; for num_steps < T, the rounded f32 linspace of
    `jnp.linspace(T - 1, 0, num_steps).round()`: start * (1 - i * (1/div)),
    with the reciprocal rounded to f32 first as XLA computes i / div, and a
    last entry of exactly 0. (At T=1000, n=7 the exact value 166.5 is a tie
    that only this order rounds as JAX does.)"""
    if num_steps == T:
        return list(range(T - 1, -1, -1))
    if num_steps == 1:
        return [T - 1]
    div = num_steps - 1
    inv = torch.tensor(1.0, dtype=torch.float32) / torch.tensor(
        float(div), dtype=torch.float32)
    out = float(T - 1) * (1 - torch.arange(div, dtype=torch.float32) * inv)
    return [int(v) for v in torch.round(out).tolist()] + [0]


def sample(
    model_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    schedule: DiffusionSchedule,
    shape: Tuple[int, ...],
    generator: Optional[torch.Generator] = None,
    num_steps: Optional[int] = None,
    *,
    x: Optional[torch.Tensor] = None,
    noises: Optional[Sequence[torch.Tensor]] = None,
    callback: Optional[Callable] = None,
) -> torch.Tensor:
    """Full reverse-diffusion loop over t = T-1 .. 0 (or `num_steps` of them,
    respaced as in the JAX package).

    The initial `x` [shape] and the noise of each step come from `generator`
    (on the device the run uses) unless given; passing both replays another
    run's draws. `callback(t, x)` observes each step, between steps.

    On the card one step is a CUDA graph replayed at every timestep (JAX's
    scan; `utils.graphs`), cached per (`model_fn`, shape) while `model_fn`
    lives: x, t and the step's noise are static buffers, the noise drawn
    outside the graph in the eager order (x, then one draw a step), so
    `model_fn` must draw nothing, read no host value and keep its tensors
    where they are. One that does host work fails to capture and raises;
    it runs under `utils.graphs.disabled()`."""
    T = schedule.num_timesteps
    ts = respaced_timesteps(T, num_steps or T)
    if noises is not None and len(noises) != len(ts):
        raise ValueError(f"{len(noises)} noise tensors for {len(ts)} steps")
    device = schedule.betas.device
    if x is None:
        if generator is None:
            raise ValueError("provide `x` or a torch.Generator")
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
    cache = graphs.cache_for(model_fn, (tuple(shape), device), "sample",
                             device)

    def buf(name, dtype, size):
        return cache.buffer(name, lambda: torch.empty(size, dtype=dtype,
                                                      device=device))
    xs = buf("x", torch.float32, shape)
    t_vec = buf("t", torch.int64, (shape[0],))
    zs = buf("noise", torch.float32, shape)
    xs.copy_(x)

    def step():
        eps = model_fn(xs, t_vec)
        xs.copy_(p_sample(schedule, xs, t_vec, eps, noise=zs))

    held = graphs.pointers(schedule)
    for i, t_scalar in enumerate(ts):
        zs.copy_(_randn_like(xs, generator) if noises is None else noises[i])
        t_vec.fill_(t_scalar)
        cache.run("step", step, held)
        if callback is not None:
            callback(t_scalar, xs.clone())
    return xs.clone()
