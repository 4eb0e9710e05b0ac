"""Configuration dataclasses, JSON round-trip compatible with the JAX package.

Counterpart of `diffusion_llm_rs_tpu/config.py` (`PhaseQuantConfig`,
`WeightQuantConfig`, `DiffusionConfig`, `PrefillConfig`, `SystemConfig`,
`to_json`, `diffusion_config_from_json`). The JAX module imports its
`BetaSchedule` from a JAX module, so this package keeps its own copy of the
enum: the same JSON text loads into both packages. `SystemConfig.ssd_path`
defaults to a store file of this package's own name in the temporary
directory, so the two packages' engines never append to one file.
`mesh_shape` and `mesh_axis_names` are kept for the JSON; nothing in this
package reads them yet.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import os
import tempfile
from typing import Tuple


class BetaSchedule(str, enum.Enum):
    """Noise schedule family."""

    LINEAR = "linear"
    QUADRATIC = "quadratic"
    COSINE = "cosine"


@dataclasses.dataclass
class PhaseQuantConfig:
    """Phase-aware KV quantization settings."""

    prefill_bits: int = 8
    decode_bits: int = 4
    progressive_precision: bool = True
    min_decode_bits: int = 2


@dataclasses.dataclass
class WeightQuantConfig:
    """GPTQ-style weight quantization settings."""

    quant_method: str = "gptq"
    bits: int = 4
    group_size: int = 128
    sym: bool = True
    desc_act: bool = True
    true_sequential: bool = True
    # 16 = bf16 activations; 8 = dynamic per-token int8 activations
    act_bits: int = 16


@dataclasses.dataclass
class DiffusionConfig:
    """Model and diffusion hyperparameters (GPT-2-small-shaped defaults)."""

    num_timesteps: int = 1000
    use_phase_aware_quant: bool = True
    quant_config: PhaseQuantConfig = dataclasses.field(
        default_factory=PhaseQuantConfig)
    weight_quant: WeightQuantConfig = dataclasses.field(
        default_factory=WeightQuantConfig)
    hidden_size: int = 768
    num_layers: int = 12
    num_attention_heads: int = 12
    vocab_size: int = 50257
    max_sequence_length: int = 1024
    beta_start: float = 1e-4
    beta_end: float = 0.02
    beta_schedule: BetaSchedule = BetaSchedule.LINEAR
    use_kv_cache: bool = True
    kv_quant_bits: int = 4
    max_cache_size: int = 2 * 1024 * 1024 * 1024  # 2 GiB
    mlp_ratio: int = 4
    dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def tiny(cls, **kw) -> "DiffusionConfig":
        """Small config for tests."""
        defaults = dict(num_timesteps=50, hidden_size=64, num_layers=2,
                        num_attention_heads=4, vocab_size=256,
                        max_sequence_length=32,
                        dtype="float32")  # tests compare at f32 tolerances
        defaults.update(kw)
        return cls(**defaults)


@dataclasses.dataclass
class PrefillConfig:
    """Prefill / prompt-cache settings."""

    cache_size: int = 1024 * 1024 * 1024  # 1 GiB
    embedding_dim: int = 768
    num_quantizers: int = 4
    quant_bits: Tuple[int, ...] = (4, 8)
    max_sequence_length: int = 2048
    page_size: int = 64  # tokens per KV page


def _default_ssd_path() -> str:
    return os.path.join(tempfile.gettempdir(),
                        "diffusion_llm_rs_tpu_torch_store.bin")


@dataclasses.dataclass
class SystemConfig:
    """Top-level coordinator settings: the widths `process_model` cycles
    over, the dedup store, the memory budget."""

    quantization_bits: Tuple[int, ...] = (1, 2, 4, 8)
    ssd_path: str = dataclasses.field(default_factory=_default_ssd_path)
    hbm_size_gb: int = 16
    batch_size: int = 32
    num_blocks: int = 64
    enable_direct_io: bool = False
    dedup_buffer_size_mb: int = 256
    mesh_shape: Tuple[int, ...] = (1, 1)   # (data, model)
    mesh_axis_names: Tuple[str, ...] = ("data", "model")


def _to_jsonable(obj):
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _to_jsonable(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, BetaSchedule):
        return obj.value
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(x) for x in obj]
    return obj


def to_json(cfg) -> str:
    return json.dumps(_to_jsonable(cfg), indent=2)


def diffusion_config_from_json(s: str) -> DiffusionConfig:
    d = json.loads(s)
    if isinstance(d.get("quant_config"), dict):
        d["quant_config"] = PhaseQuantConfig(**d["quant_config"])
    if isinstance(d.get("weight_quant"), dict):
        d["weight_quant"] = WeightQuantConfig(**d["weight_quant"])
    if "beta_schedule" in d:
        d["beta_schedule"] = BetaSchedule(d["beta_schedule"])
    return DiffusionConfig(**d)
