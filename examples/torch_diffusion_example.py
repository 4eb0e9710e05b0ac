"""Train a tiny denoiser on synthetic data, then sample from it, on the
PyTorch port.

The PyTorch twin of `examples/diffusion_example.py`: a few epochs of
`p_losses` training with `torch.optim.Adam` (lr 1e-2) in place of optax,
then the reverse-diffusion sampler. Its draws (data, timesteps, noise) come
from `torch.Generator`s, so its numbers are not JAX's (the JAX example draws
from `jax.random` keys).

Run: python examples/torch_diffusion_example.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from diffusion_llm_rs_tpu_torch.models import denoiser as dn
from diffusion_llm_rs_tpu_torch.models import diffusion as dm


def train_step(params, opt, schedule, x0, t, noise=None, generator=None):
    """One Adam step on the mean `p_losses` of the simple denoiser over
    (x0, t): `noise`, or draws from `generator`. Returns the loss."""
    opt.zero_grad()
    loss = torch.mean(dm.p_losses(
        lambda x, tt: dn.simple_denoiser_forward(params, x, tt), schedule,
        x0, t, noise, generator=generator))
    loss.backward()
    opt.step()
    return float(loss.detach())


def main(device="cuda"):
    T = 100
    feature_dim = 16
    schedule = dm.DiffusionSchedule.create(
        T, beta_start=1e-4, beta_end=0.02, schedule=dm.BetaSchedule.LINEAR,
        device=device)

    # toy dataset: two gaussian clusters (the reference trains on random data)
    gen = torch.Generator(device=device).manual_seed(0)
    centers = torch.where(
        torch.rand((512, 1), generator=gen, device=device) < 0.5, 2.0, -2.0)
    data = centers + 0.1 * torch.randn((512, feature_dim), generator=gen,
                                       device=device)

    params = dn.init_simple_denoiser(
        torch.Generator(device=device).manual_seed(1), feature_dim)
    for p in params.values():
        p.requires_grad_(True)
    opt = torch.optim.Adam(params.values(), lr=1e-2)

    for epoch in range(5):
        t = torch.randint(0, T, (data.shape[0],), generator=gen, device=device)
        loss = train_step(params, opt, schedule, data, t, generator=gen)
        print(f"epoch {epoch}: loss {loss:.4f}")

    with torch.no_grad():
        samples = dm.sample(
            lambda x, t: dn.simple_denoiser_forward(params, x, t), schedule,
            (8, feature_dim), torch.Generator(device=device).manual_seed(2),
            num_steps=50)
    print("samples:", tuple(samples.shape), "mean", float(samples.mean()))
    return samples


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(ap.parse_args().device)
