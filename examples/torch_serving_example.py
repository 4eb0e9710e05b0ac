"""Continuous-batching serving walkthrough, on the PyTorch port.

The PyTorch twin of `examples/serving_example.py`: three tiers of the same
serving stack on a tiny model (`DiffusionConfig.tiny()`: width 64, 4 heads
of 16, vocab 256).
  1. `PagedContinuousBatcher`: quantized paged-KV pools, phase-aware
     per-slot precision, one replayed step graph on the card
  2. the same batcher with salience routing: per-PAGE bit allocation from
     the in-step attention-mass proxy under the phase router's budget
  3. `ShardedPagedBatcher`: the same scheduler over a ('data', 'model')
     mesh. On the CPU: a (2, 2) mesh of 4 processes joined by gloo. On the
     card: an NCCL group of one process, (1, 1) (one card holds one NCCL
     rank).

Run: python examples/torch_serving_example.py [--device cpu]
"""

import argparse
import datetime
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from diffusion_llm_rs_tpu_torch import DiffusionConfig
from diffusion_llm_rs_tpu_torch.models import denoiser as dn
from diffusion_llm_rs_tpu_torch.parallel.mesh import (initialize_distributed,
                                                      make_mesh)
from diffusion_llm_rs_tpu_torch.parallel.serving import ShardedPagedBatcher
from diffusion_llm_rs_tpu_torch.serving import PagedContinuousBatcher, Request

STEPS = [10, 6, 14, 4]
CPU_MESH = (2, 2)


def drive(b, tag, report=True):
    for i, steps in enumerate(STEPS):
        b.submit(Request(f"{tag}{i}", seq_len=16, num_steps=steps))
    done = b.run_until_drained()
    if report:
        _report(done)
    return done


def _report(done):
    for c in sorted(done, key=lambda c: c.request_id):
        print(f"  {c.request_id}: {c.steps} steps, "
              f"{c.tokens.size} tokens, {c.latency_s * 1e3:.0f} ms")


def _sharded(params, cfg, mesh):
    return ShardedPagedBatcher(params, cfg, mesh, num_slots=2, seq_len=16,
                               page_size=8)


def _cpu_rank(rank, world, tmp):
    """One rank of the CPU mesh: its completions go back through a file."""
    torch.set_num_threads(1)
    payload = torch.load(os.path.join(tmp, "params.pt"), weights_only=False)
    initialize_distributed("gloo", f"file://{tmp}/rendezvous", world, rank,
                           timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_mesh(CPU_MESH, device="cpu")
        done = drive(_sharded(payload["params"], payload["cfg"], mesh),
                     "sharded-", report=False)
        torch.save(done, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def sharded_tier(params, cfg, device):
    """Tier 3 on `device`: rank 0's completions."""
    with tempfile.TemporaryDirectory() as tmp:
        if torch.device(device).type == "cpu":
            world = CPU_MESH[0] * CPU_MESH[1]
            print(f"3) sharded paged serving over mesh "
                  f"{dict(data=CPU_MESH[0], model=CPU_MESH[1])}")
            torch.save(dict(params=params, cfg=cfg),
                       os.path.join(tmp, "params.pt"))
            mp.spawn(_cpu_rank, args=(world, tmp), nprocs=world, join=True)
            done = torch.load(os.path.join(tmp, "rank0.pt"),
                              weights_only=False)
            _report(done)
            return done
        initialize_distributed("nccl", f"file://{tmp}/rendezvous", 1, 0)
        try:
            mesh = make_mesh((1, 1), device=device)
            print(f"3) sharded paged serving over mesh {mesh.shape}")
            return drive(_sharded(params, cfg, mesh), "sharded-")
        finally:
            dist.destroy_process_group()


def main(device="cuda", params=None, noise=None):
    """The three tiers on `device`; returns their completions by tier.
    `params` replaces the seeded random weights, and `noise(seed)` makes
    each single-process batcher's noise source (the default: a generator
    seeded with `seed` on `device`)."""
    cfg = DiffusionConfig.tiny(vocab_size=256)
    if params is None:
        params = dn.init_denoiser_params(
            torch.Generator(device=device).manual_seed(0), cfg)
    kw = {} if noise is None else dict(noise=noise(0))
    out = {}

    print("1) paged quantized-KV serving (phase-aware per-slot bits)")
    b = PagedContinuousBatcher(params, cfg, num_slots=2, seq_len=16,
                               page_size=8, attend_mode="paged",
                               device=device, **kw)
    out["phase"] = drive(b, "phase-")
    print(f"  KV pool HBM: {b.cache_memory_bytes()} bytes "
          f"(buckets {b.buckets})")

    kw = {} if noise is None else dict(noise=noise(0))
    print("2) salience-routed per-page precision")
    bs = PagedContinuousBatcher(params, cfg, num_slots=2, seq_len=16,
                                page_size=8, salience_routing=True,
                                attend_mode="paged", device=device, **kw)
    out["salient"] = drive(bs, "salient-")
    out["page_scores"] = bs.page_scores
    print(f"  page attention-mass EMA (slot 0): {bs.page_scores[0].round(3)}")

    out["sharded"] = sharded_tier(params, cfg, device)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(ap.parse_args().device)
