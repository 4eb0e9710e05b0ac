"""diffusion_llm_rs_tpu_torch: the PyTorch/CUDA port of diffusion_llm_rs_tpu.

A second package beside the JAX one, ported one slice at a time; the JAX
package is the reference each piece is tested against. It imports torch and
numpy, never JAX. Its hand-written Hopper kernels (sm_90a) live in `csrc/`,
build on first use (`ops/_build.py`), and run behind wrappers that take a
plain PyTorch twin only for CPU tensors.

Ported so far: the W4A8 reverse-diffusion sampler (`config`, `quant`,
`ops`, `models.diffusion`, `models.denoiser`, `weights`), the phase-aware
cached sampler (`models.sampler`), paged quantized-KV serving (`serving`,
`cache`), the `engine.Engine` facade over packed 1/2/4/8-bit weights
(`ops.packed_matmul`) with checkpoints (`utils.serialization`), the
tokenizer (`tokenizer.bpe`), GPTQ (`quant.gptq`), the host-side stack behind
`Engine.prefill` and `process_model` (`index`, `router`, `storage`,
`models.types`, `cache.salience`, `cache.suffix_tree`) and the command line
(`python -m diffusion_llm_rs_tpu_torch`).

This module re-exports the package surface of the JAX package's
`__init__.py`; `Engine`, the batchers and the subpackages load lazily.
"""

__version__ = "0.1.0"

from diffusion_llm_rs_tpu_torch import quant
from diffusion_llm_rs_tpu_torch.config import (
    DiffusionConfig,
    PhaseQuantConfig,
    PrefillConfig,
    SystemConfig,
    WeightQuantConfig,
)


def __getattr__(name):
    # lazy imports keep `import diffusion_llm_rs_tpu_torch` light; the
    # Engine pulls in every subsystem
    if name == "Engine":
        from diffusion_llm_rs_tpu_torch.engine import Engine
        return Engine
    if name in ("ContinuousBatcher", "PagedContinuousBatcher", "Request"):
        from diffusion_llm_rs_tpu_torch import serving
        return getattr(serving, name)
    if name in ("models", "cache", "index", "router", "storage",
                "tokenizer", "ops", "utils"):
        import importlib
        return importlib.import_module(f"diffusion_llm_rs_tpu_torch.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "quant", "Engine", "DiffusionConfig", "PhaseQuantConfig", "PrefillConfig",
    "SystemConfig", "WeightQuantConfig", "ContinuousBatcher",
    "PagedContinuousBatcher", "Request",
]
