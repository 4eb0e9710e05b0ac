"""A configuration file read into the sizes a run needs, and the f32
weights drawn from the seed.

The configuration files (`configs/<name>.json`) keep the published model's
own keys (GPT-2's `n_layer`, `n_embd`, ...) and list under `assumed` what
the source does not give: the serving length, the diffusion schedule, the
quantization the model is served at. `Dims` reads both.

`make_weights` draws every weight in one call of a generator on the
device, seeded from the run's seed, and hands out views of it in the
layout the port's denoiser reads. The reference draws the same tensor
again after the window, so the program never holds the f32 weights while
it is measured.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path

import torch

from bench_port.seeds import mix

ROOT = Path(__file__).resolve().parent


@dataclasses.dataclass(frozen=True)
class Dims:
    name: str
    layers: int
    hidden: int
    heads: int
    inner: int
    vocab: int
    max_seq: int
    num_timesteps: int
    beta_start: float
    beta_end: float
    prefill_bits: int
    decode_bits: int
    min_decode_bits: int
    weight_bits: int
    weight_group: int
    act_bits: int

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    @classmethod
    def from_json(cls, cfg: dict) -> "Dims":
        a = cfg["assumed"]
        q = a["phase_quant"]
        return cls(name=cfg["name"], layers=cfg["n_layer"],
                   hidden=cfg["n_embd"], heads=cfg["n_head"],
                   inner=cfg["n_inner"] or 4 * cfg["n_embd"],
                   vocab=cfg["vocab_size"],
                   max_seq=a["max_sequence_length"],
                   num_timesteps=a["num_timesteps"],
                   beta_start=a["beta_start"], beta_end=a["beta_end"],
                   prefill_bits=q["prefill_bits"],
                   decode_bits=q["decode_bits"],
                   min_decode_bits=q["min_decode_bits"],
                   weight_bits=a["weight_bits"],
                   weight_group=a["weight_group"], act_bits=a["act_bits"])


def load_config(name: str) -> dict:
    return json.loads((ROOT / "configs" / f"{name}.json").read_text())


def load_traffic(name: str) -> dict:
    return json.loads((ROOT / "traffic" / f"{name}.json").read_text())


def _leaves(d: Dims):
    """(path, shape, scale, offset) of every weight: a leaf is
    offset + scale * N(0, 1). Scales as the port's `init_denoiser_params`;
    biases and layer norms are drawn too, so that the comparison sees them."""
    D, F = d.hidden, d.inner
    out_scale = 0.02 / math.sqrt(2 * d.layers)
    leaves = [(("tok_embed",), (d.vocab, D), 0.02, 0.0),
              (("pos_embed",), (d.max_seq, D), 0.01, 0.0),
              (("time_mlp", "w1"), (D, 4 * D), 0.02, 0.0),
              (("time_mlp", "b1"), (4 * D,), 0.02, 0.0),
              (("time_mlp", "w2"), (4 * D, D), 0.02, 0.0),
              (("time_mlp", "b2"), (D,), 0.02, 0.0),
              (("ln_f", "scale"), (D,), 0.1, 1.0),
              (("ln_f", "bias"), (D,), 0.02, 0.0),
              (("head", "w"), (D, D), 0.02, 0.0)]
    for i in range(d.layers):
        b = ("blocks", i)
        leaves += [(b + ("ln1", "scale"), (D,), 0.1, 1.0),
                   (b + ("ln1", "bias"), (D,), 0.02, 0.0),
                   (b + ("attn", "wqkv"), (D, 3 * D), 0.02, 0.0),
                   (b + ("attn", "wo"), (D, D), out_scale, 0.0),
                   (b + ("ln2", "scale"), (D,), 0.1, 1.0),
                   (b + ("ln2", "bias"), (D,), 0.02, 0.0),
                   (b + ("mlp", "w1"), (D, F), 0.02, 0.0),
                   (b + ("mlp", "b1"), (F,), 0.02, 0.0),
                   (b + ("mlp", "w2"), (F, D), out_scale, 0.0),
                   (b + ("mlp", "b2"), (D,), 0.02, 0.0)]
    return leaves


def make_weights(d: Dims, seed: int, device) -> dict:
    """The model's f32 weights for `seed`, on `device`, as the nested dict
    the port's denoiser reads (`blocks` a list)."""
    leaves = _leaves(d)
    total = sum(math.prod(shape) for _, shape, _, _ in leaves)
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(mix(seed, "weights"))
    flat = torch.randn((total,), generator=gen, dtype=torch.float32,
                       device=device)
    tree: dict = {"blocks": [{} for _ in range(d.layers)]}
    at = 0
    for path, shape, scale, offset in leaves:
        n = math.prod(shape)
        leaf = flat[at:at + n].view(shape).mul_(scale).add_(offset)
        at += n
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {}) if isinstance(key, str) \
                else node[key]
        node[path[-1]] = leaf
    return tree
