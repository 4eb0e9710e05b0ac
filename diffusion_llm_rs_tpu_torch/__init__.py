"""diffusion_llm_rs_tpu_torch: the PyTorch/CUDA port of diffusion_llm_rs_tpu.

A second package beside the JAX one, ported one slice at a time; the JAX
package is the reference each piece is tested against. It imports torch and
numpy, never JAX. Its hand-written Hopper kernels (sm_90a) live in `csrc/`,
build on first use (`ops/_build.py`), and run behind wrappers that take a
plain PyTorch twin only for CPU tensors.

Ported so far: the W4A8 reverse-diffusion sampler (`config`, `quant.core`,
`ops`, `models.diffusion`, `models.denoiser`, `weights`), paged
quantized-KV serving (`serving`, `cache`), and the `engine.Engine` facade
over packed 1/2/4/8-bit weights (`ops.packed_matmul`) with checkpoints
(`utils.serialization`), the tokenizer (`tokenizer.bpe`) and the KV-cache
manager (`cache.kv_cache`).
"""

__version__ = "0.1.0"
