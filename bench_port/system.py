"""The system under test: the port's model, server and sampler, set up as
a user of the port sets them up.

This is the only module of the benchmark that imports the program
(`diffusion_llm_rs_tpu_torch`); it takes from it the served weights, the
batcher, the sampler, the kernel build, and its counters.
"""

from __future__ import annotations

import torch

from diffusion_llm_rs_tpu_torch.config import (DiffusionConfig,
                                               PhaseQuantConfig)
from diffusion_llm_rs_tpu_torch.models import denoiser as dn
from diffusion_llm_rs_tpu_torch.models.diffusion import (DiffusionSchedule,
                                                         sample)
from diffusion_llm_rs_tpu_torch.ops import _build
from diffusion_llm_rs_tpu_torch.ops.int8_matmul import mlp_fits, prepare
from diffusion_llm_rs_tpu_torch.ops.matmul import decode_to_int8
from diffusion_llm_rs_tpu_torch.quant.core import (QuantizedTensor,
                                                   quantize_tree)
from diffusion_llm_rs_tpu_torch.serving import (PagedContinuousBatcher,
                                                Request)
from diffusion_llm_rs_tpu_torch.utils.metrics import metrics

from bench_port.model import Dims

__all__ = ["Request", "config", "served_params", "batcher", "sampler",
           "kernels", "build", "counters", "launches", "decode_tokens"]

COUNTERS = ("graphs.captures", "graphs.recaptures", "graphs.replays",
            "batcher.steps", "batcher.slot_steps")


def decode_tokens(params, x):
    """The sampler's readout: x onto the token table, argmax."""
    return dn.decode_tokens(params, x)


def config(d: Dims) -> DiffusionConfig:
    return DiffusionConfig(
        num_timesteps=d.num_timesteps, hidden_size=d.hidden,
        num_layers=d.layers, num_attention_heads=d.heads,
        vocab_size=d.vocab, max_sequence_length=d.max_seq,
        beta_start=d.beta_start, beta_end=d.beta_end,
        mlp_ratio=d.inner // d.hidden, dtype="bfloat16",
        quant_config=PhaseQuantConfig(prefill_bits=d.prefill_bits,
                                      decode_bits=d.decode_bits,
                                      min_decode_bits=d.min_decode_bits))


def served_params(d: Dims, w: dict) -> dict:
    """The W4A8 decoded model (`chip_smoke.py: full_width_model`): every
    large matrix int4 symmetric in groups along K, then
    `prepare(act_bits=8)` and `decode_to_int8`; the token table stays int4
    (its K is odd); the other leaves in bf16."""
    q = quantize_tree(w, d.weight_bits, symmetric=True, granularity="group",
                      group_size=d.weight_group, axis=0)

    def prep(t):
        if isinstance(t, dict):
            return {k: prep(v) for k, v in t.items()}
        if isinstance(t, list):
            return [prep(v) for v in t]
        if isinstance(t, QuantizedTensor) and t.ndim == 2:
            try:
                return decode_to_int8(prepare(t, act_bits=d.act_bits))
            except ValueError:   # the token table: K not packable
                return t
        if isinstance(t, torch.Tensor):
            return t.to(torch.bfloat16)
        return t
    return prep(q)


def batcher(cfg: DiffusionConfig, params: dict, traffic: dict, noise,
            device) -> PagedContinuousBatcher:
    """The server as the port's command line serves: tokens only, no
    embeddings copied to the host at each retire."""
    return PagedContinuousBatcher(
        params, cfg, num_slots=traffic["slots"], seq_len=traffic["seq_len"],
        page_size=traffic["page_size"], max_chunk=traffic["max_chunk"],
        attend_mode=traffic["attend_mode"],
        attn_act_bits=traffic["attn_act_bits"], keep_embeddings=False,
        device=device, noise=noise)


def sampler(cfg: DiffusionConfig, params: dict, device):
    """The one-shot sampler as `bench.py:main` drives it, x in bf16
    through `denoiser_forward` and eps back in f32: `run(shape,
    generator, num_steps)` returns the sampled x. The step graphs live as
    long as `run`."""
    schedule = DiffusionSchedule.create(cfg.num_timesteps, cfg.beta_start,
                                        cfg.beta_end, device=device)

    def model_fn(x, t):
        return dn.denoiser_forward(params, cfg, x.to(torch.bfloat16),
                                   t).to(torch.float32)

    def run(shape, generator, num_steps):
        return sample(model_fn, schedule, shape, generator,
                      num_steps=num_steps)
    return run


def kernels(d: Dims, traffic: dict, attend_mode: str = "") -> tuple:
    """The sources whose kernels the cell launches."""
    names = ["int8_gemm"]
    if mlp_fits(d.hidden, d.inner):
        names.append("int8_mlp")
    if traffic["loop"] == "sampler":
        if traffic["seq_len"] >= 1024:
            names.append("dense_attention")
    elif attend_mode == "paged":
        names += ["paged_unpack", "batched_paged_attention"]
        if traffic["attn_act_bits"] == 8:
            names.append("paged_attention_a8")
    return tuple(names)


def build(names) -> None:
    _build.build(names)


def counters() -> dict:
    return {k: metrics.get(k) for k in COUNTERS}


def launches() -> dict:
    return dict(_build.launch_counts)
