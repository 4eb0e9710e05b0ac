"""Engine: the end-user facade over the denoiser, its quantized weights and
the paged serving batcher.

Counterpart of `diffusion_llm_rs_tpu/engine.py`, for the part of it that is
ported: construction (random or given parameters), `from_pretrained` (a
checkpoint with its config and tokenizer), `quantize_weights` (1/2/4/8-bit
integers by round to nearest or by GPTQ, by default repacked into the
`MatmulWeight` layout the packed matmul kernel reads; or fp8), greedy
`generate` with its exact-prefix
next-token memo, `sample` through `serving.PagedContinuousBatcher` or, with
`use_paged=False` and for sequence lengths no page size divides, through the
phase-aware sampler over a carried quantized KV cache
(`models.sampler.phase_aware_sample`), `denoising_perplexity`, the KV-cache
manager's accounting, and the model-side keys of `stats`.

Not ported yet, each raising NotImplementedError that names its ROADMAP.md
item: `prefill`, `process_model`, `tokenize_model`, `get_cached_vectors`,
the attention-mask cache and the dedup / index / router keys of `stats`
(A11). Only the ported subsystems are constructed.

Everything runs on `device`: the card unless the caller asks for the CPU.
Where the JAX package draws from a PRNG key, this one draws from a seeded
`torch.Generator` on the device, or takes the noise from the caller.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from diffusion_llm_rs_tpu_torch.cache.kv_cache import KVCacheManager
from diffusion_llm_rs_tpu_torch.config import DiffusionConfig
from diffusion_llm_rs_tpu_torch.models import denoiser as dn
from diffusion_llm_rs_tpu_torch.models.diffusion import (DiffusionSchedule,
                                                         add_noise)
from diffusion_llm_rs_tpu_torch.models.sampler import phase_aware_sample
from diffusion_llm_rs_tpu_torch.ops.matmul import Int8Weight, MatmulWeight
from diffusion_llm_rs_tpu_torch.ops.packed_matmul import prepare
from diffusion_llm_rs_tpu_torch.quant.core import (Fp8Tensor, QuantizedTensor,
                                                   map_leaves, quantize_fp8,
                                                   quantize_tree, tree_leaves)
from diffusion_llm_rs_tpu_torch.quant.gptq import (gptq_quantize_tree,
                                                   make_calib_batches)
from diffusion_llm_rs_tpu_torch.tokenizer.bpe import BPETokenizer
from diffusion_llm_rs_tpu_torch.utils.serialization import (get_metadata,
                                                            load_checkpoint)


# GPTQ's calibration texts when the caller gives none
GPTQ_SEED_TEXTS = (
    "the quick brown fox jumps over the lazy dog",
    "diffusion language models denoise token embeddings",
    "quantized key value caches keep memory small",
)


def _default_tokenizer(vocab_size: int) -> BPETokenizer:
    """Byte-level tokenizer with a small merge set trained on a seed corpus."""
    seed_corpus = [
        "the quick brown fox jumps over the lazy dog",
        "diffusion language models denoise token embeddings step by step",
        "quantized key value caches keep memory small and inference fast",
    ]
    return BPETokenizer.train(seed_corpus, min(vocab_size, 320))


def _deferred(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md item {item})")


class Engine:
    """End-to-end quantized diffusion-LM inference engine."""

    def __init__(
        self,
        config: Optional[DiffusionConfig] = None,
        prefill_config=None,
        system_config=None,
        tokenizer: Optional[BPETokenizer] = None,
        params=None,
        seed: int = 0,
        device="cuda",
    ):
        if prefill_config is not None or system_config is not None:
            raise _deferred("the prefill store and the storage / index / "
                            "router subsystems these configure", "A11")
        self.device = torch.device(device)
        self.config = config or DiffusionConfig()
        self.tokenizer = tokenizer or _default_tokenizer(self.config.vocab_size)
        if self.tokenizer.vocab_size > self.config.vocab_size:
            raise ValueError(
                f"tokenizer vocab {self.tokenizer.vocab_size} exceeds model "
                f"vocab {self.config.vocab_size}")

        if params is None:
            params = dn.init_denoiser_params(
                torch.Generator(device=self.device).manual_seed(seed),
                self.config)
        self.params = params
        self.schedule = DiffusionSchedule.create(
            self.config.num_timesteps, self.config.beta_start,
            self.config.beta_end, self.config.beta_schedule,
            device=self.device)

        self.kv_cache = KVCacheManager(
            max_cache_size=self.config.max_cache_size,
            prefill_bits=self.config.quant_config.prefill_bits,
            decode_bits=self.config.quant_config.decode_bits,
            device=self.device)
        self._weight_bits: Optional[int] = None
        # next-token memo for the greedy generate loop: the denoiser is
        # bidirectional, so the valid reuse is an exact-prefix memo. LRU-capped
        # so a long-lived engine holds memory flat.
        self._ntp_cache: OrderedDict = OrderedDict()
        self._ntp_cache_cap = 4096
        self.generate_cache_hits = 0
        # batchers keyed by (batch, seq, salience, mode): each holds page
        # pools on the device, so the LRU cap is small
        self._samplers: OrderedDict = OrderedDict()
        self._samplers_cap = 4

    # ------------------------------------------------------------------
    # weight quantization
    # ------------------------------------------------------------------

    def quantize_weights(self, bits: int, kernel_layout: bool = True,
                         method: str = "int",
                         calib_texts: Optional[Sequence[str]] = None,
                         noise=None) -> None:
        """Weight-only quantization of all large matrices, in groups along
        the contraction axis.

        method="int" packs 1/2/4/8-bit integers (round to nearest);
        method="gptq" runs GPTQ (`quant.gptq`) on the matmul weights,
        calibrated on `calib_texts` (three built-in texts if omitted) noised
        by the forward process with draws from `noise` (a noise source or a
        `torch.Generator`; by default a generator seeded with 0 on the
        device), then rounds the embedding to nearest;
        method="fp8" stores float8_e4m3fn with a per-tensor scale. With
        kernel_layout (default), 2-D int-quantized weights are repacked once
        into the packed matmul kernel's layout (`ops.packed_matmul.prepare`,
        at the config's `weight_quant.act_bits`); a matrix the layout cannot
        hold (an odd vocabulary) stays a `QuantizedTensor`.
        """
        # every memo derived from the old parameters would report their
        # behaviour: drop them all
        self._invalidate_param_memos()

        if method == "fp8":
            def _f8(path, leaf):
                if "pos_embed" in "/".join(path):  # sliced per sequence
                    return leaf
                if (isinstance(leaf, torch.Tensor) and leaf.ndim >= 2
                        and leaf.numel() >= 1024
                        and leaf.dtype.is_floating_point):
                    return quantize_fp8(leaf)
                return leaf
            self.params = map_leaves(_f8, self.params)
            self._weight_bits = 8
            return

        if method == "gptq":
            texts = list(calib_texts) if calib_texts else list(GPTQ_SEED_TEXTS)
            # at most max_sequence_length tokens a text, the window
            # `denoising_perplexity` reads (JAX's engine feeds the whole text
            # and fails on the anchor, whose texts run past its 32)
            token_batches = [
                self.tokenizer.encode(s)[: self.config.max_sequence_length]
                for s in texts]
            token_batches = [b for b in token_batches if len(b) >= 2]
            batches = make_calib_batches(self.params, self.config,
                                         self.schedule, token_batches, noise)
            self.params = gptq_quantize_tree(self.params, self.config,
                                             batches, bits=bits)
        # the lookup tables GPTQ leaves (tok_embed) round to nearest
        self.params = quantize_tree(
            self.params, bits, symmetric=self.config.weight_quant.sym,
            group_size=self.config.weight_quant.group_size)
        if kernel_layout:
            act_bits = self.config.weight_quant.act_bits

            def _prep(_, leaf):
                if isinstance(leaf, QuantizedTensor) and leaf.ndim == 2:
                    try:
                        return prepare(leaf, act_bits=act_bits)
                    except ValueError:
                        return leaf
                return leaf
            self.params = map_leaves(_prep, self.params)
        self._weight_bits = bits

    @classmethod
    def from_pretrained(cls, path: Optional[str] = None, device="cuda",
                        **kw) -> "Engine":
        """Engine over a pretrained checkpoint: config, tokenizer and trained
        weights bundled by `utils.serialization.save_checkpoint`.

        `path` is the checkpoint stem (expects `<path>.npz`, `<path>.json`,
        and the tokenizer file named in the metadata next to it); it defaults
        to the repository's `benchmarks/quality_anchor`.
        """
        if path is None:
            path = os.path.join(
                os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                "benchmarks", "quality_anchor")
        meta = get_metadata(path)
        cfg = DiffusionConfig(**meta["config"])
        tokenizer = BPETokenizer.load(
            os.path.join(os.path.dirname(path), meta["tokenizer"]))
        like = dn.init_denoiser_params(torch.Generator().manual_seed(0), cfg)
        params = load_checkpoint(path, like=like, device=device)
        return cls(config=cfg, tokenizer=tokenizer, params=params,
                   device=device, **kw)

    def _invalidate_param_memos(self) -> None:
        """Drop every cache keyed on (or derived from) self.params."""
        self._ntp_cache.clear()
        self._samplers.clear()
        # KV entries hold K/V computed from the old parameters
        self.kv_cache.clear()

    # ------------------------------------------------------------------
    # KV cache accounting
    # ------------------------------------------------------------------

    def clear_kv_cache(self) -> None:
        self.kv_cache.clear()

    def kv_cache_memory_usage(self) -> int:
        return self.kv_cache.memory_usage()

    # ------------------------------------------------------------------
    # not ported yet
    # ------------------------------------------------------------------

    def tokenize_model(self, text: str, model_id: str = "model"):
        raise _deferred("Engine.tokenize_model", "A11")

    def set_attention_mask(self, vector_id: str, mask) -> None:
        raise _deferred("the attention-mask cache", "A11")

    def apply_attention_masks(self, tokens, offsets) -> None:
        raise _deferred("the attention-mask cache", "A11")

    def process_model(self, text: str, model_id: str = "model"):
        raise _deferred("Engine.process_model", "A11")

    def prefill(self, text: str, cache_id: str = "default") -> int:
        raise _deferred("Engine.prefill", "A11")

    def get_cached_vectors(self, ids: Sequence[str]):
        raise _deferred("Engine.get_cached_vectors", "A11")

    # ------------------------------------------------------------------
    # generate
    # ------------------------------------------------------------------

    def predict_next_token(self, token_ids: Sequence[int]) -> torch.Tensor:
        """Next-token probabilities [V] from the denoiser's hidden state at
        t = 0, read through the tied embedding (f32 activations)."""
        ids = torch.tensor([list(token_ids)], dtype=torch.int64,
                           device=self.device)
        x = dn.embed_tokens(self.params, ids)
        t = torch.zeros((ids.shape[0],), dtype=torch.int64, device=self.device)
        _, h = dn.denoiser_forward(self.params, self.config, x, t,
                                   return_hidden=True)
        logits = dn.logits_from_hidden(self.params, h[:, -1:, :])[:, 0, :]
        return torch.softmax(logits, dim=-1)[0]

    def sample_token(self, probs) -> str:
        """Greedy argmax -> token string."""
        token_id = int(torch.argmax(torch.as_tensor(probs)))
        return self.tokenizer.id_to_token(token_id)

    def generate(self, prompt: str, max_length: int = 32) -> str:
        """Greedy token loop with [EOS] early stop.

        Greedy decoding is deterministic per prefix, and the bidirectional
        denoiser re-encodes every position each step, so the valid cache is
        an exact-prefix next-token memo: a repeated or shared-prefix prompt
        skips its forwards entirely (`generate_cache_hits` counts skips)."""
        ids = self.tokenizer.encode(prompt)
        if not ids:
            ids = [self.tokenizer.eos_id]
        out_ids: List[int] = []
        for _ in range(max_length):
            window = tuple(ids[-self.config.max_sequence_length:])
            next_id = self._ntp_cache.get(window)
            if next_id is None:
                probs = self.predict_next_token(list(window))
                next_id = int(torch.argmax(probs))
                self._ntp_cache[window] = next_id
                while len(self._ntp_cache) > self._ntp_cache_cap:
                    self._ntp_cache.popitem(last=False)
            else:
                self._ntp_cache.move_to_end(window)
                self.generate_cache_hits += 1
            if next_id == self.tokenizer.eos_id:
                break
            ids.append(next_id)
            out_ids.append(next_id)
        return self.tokenizer.decode(out_ids)

    # ------------------------------------------------------------------
    # diffusion sampling
    # ------------------------------------------------------------------

    def sample(self, batch_size: int = 1, seq_len: Optional[int] = None,
               num_steps: Optional[int] = None, seed: int = 0,
               return_text: bool = True, use_paged: bool = True,
               salience_routing: bool = False, attend_mode: str = "auto",
               noise=None):
        """Phase-aware quantized reverse-diffusion sampling -> text.

        use_paged (default): through the paged serving batcher
        (`serving.PagedContinuousBatcher`: per-page bit buckets, the batched
        paged kernel, optional salience routing). use_paged=False: the
        phase-aware sampler over a carried quantized KV cache
        (`phase_aware_sample`), one loop for a fixed batch; a `seq_len` that
        no page of at most 64 tokens (a multiple of 8) divides takes it too.

        Returns the decoded strings, or with return_text=False the token ids
        [batch_size, seq_len] (int64, on the host). `noise` is a noise
        source (see `serving`); by default a generator seeded with `seed` on
        the engine's device."""
        from diffusion_llm_rs_tpu_torch.serving import (GeneratorNoise,
                                                        PagedContinuousBatcher,
                                                        Request)
        seq_len = seq_len or min(32, self.config.max_sequence_length)
        T = num_steps or self.config.num_timesteps
        if noise is None:
            noise = GeneratorNoise(seed, self.device)
        # largest page <= 64 dividing seq_len and packable at 1 bit; without
        # one (seq_len=10) the paged pools cannot be built
        page = next((p for p in range(min(seq_len, 64), 0, -1)
                     if seq_len % p == 0 and p % 8 == 0), None)
        if not use_paged or page is None:
            x = phase_aware_sample(self.params, self.config, self.schedule,
                                   (batch_size, seq_len), noise, num_steps)
            token_ids = dn.decode_tokens(self.params, x).cpu()
            if not return_text:
                return token_ids
            return [self.tokenizer.decode(row.tolist()) for row in token_ids]
        skey = (batch_size, seq_len, salience_routing, attend_mode)
        b = self._samplers.get(skey)
        if b is None:
            b = PagedContinuousBatcher(
                self.params, self.config, self.schedule,
                num_slots=batch_size, seq_len=seq_len, page_size=page,
                salience_routing=salience_routing, attend_mode=attend_mode,
                device=self.device)
            self._samplers[skey] = b
            while len(self._samplers) > self._samplers_cap:
                self._samplers.popitem(last=False)
        else:
            self._samplers.move_to_end(skey)
        # pick up a later quantize_weights in both the denoise step and the
        # token readout (the two must decode with the same weights)
        b.params = self.params
        b.readout_params = self.params
        b.noise = noise
        for i in range(batch_size):
            b.submit(Request(f"sample:{seed}:{i}", seq_len=seq_len,
                             num_steps=T))
        done = {c.request_id: c for c in b.run_until_drained()}
        token_ids = torch.from_numpy(np.stack([
            np.asarray(done[f"sample:{seed}:{i}"].tokens)
            for i in range(batch_size)]))
        if not return_text:
            return token_ids
        return [self.tokenizer.decode(row.tolist()) for row in token_ids]

    # ------------------------------------------------------------------
    # quality metric: denoising perplexity
    # ------------------------------------------------------------------

    def denoising_perplexity(self, text: str, t: int = 10, seed: int = 0,
                             noise: Optional[torch.Tensor] = None) -> float:
        """Token-reconstruction perplexity after noising to step t.

        Embeds the tokens, applies the forward process to timestep t,
        predicts the noise, reconstructs x0 = (x_t - sqrt(1 - abar) *
        eps_hat) / sqrt(abar), reads logits through the tied embedding, and
        returns exp(CE). Sensitive to weight quantization. `noise`
        [1, tokens, hidden] replaces the draw from a generator seeded with
        `seed`."""
        ids = self.tokenizer.encode(text)[: self.config.max_sequence_length]
        if len(ids) < 2:
            raise ValueError("need at least 2 tokens")
        ids_t = torch.tensor([ids], dtype=torch.int64, device=self.device)
        x0 = dn.embed_tokens(self.params, ids_t)
        t_vec = torch.full((1,), t, dtype=torch.int64, device=self.device)
        if noise is None:
            noise = torch.randn(
                x0.shape, dtype=x0.dtype, device=self.device,
                generator=torch.Generator(device=self.device).manual_seed(seed))
        x_t, _ = add_noise(self.schedule, x0, t_vec,
                           noise=noise.to(self.device))
        eps_hat = dn.denoiser_forward(self.params, self.config, x_t, t_vec)
        sqrt_abar = self.schedule.sqrt_alpha_bars[t]
        sqrt_1m = self.schedule.sqrt_one_minus_alpha_bars[t]
        x0_hat = (x_t - sqrt_1m * eps_hat) / sqrt_abar
        logp = torch.log_softmax(dn.logits_from_hidden(self.params, x0_hat),
                                 dim=-1)
        tok_logp = torch.gather(logp, -1, ids_t[..., None])
        return float(torch.exp(-tok_logp.mean()))

    # ------------------------------------------------------------------

    def stats(self) -> Dict[str, float]:
        """The model-side metrics (the storage, index and router keys come
        with those subsystems)."""
        return {
            "kv_cache_bytes": self.kv_cache.memory_usage(),
            "kv_cache_entries": len(self.kv_cache),
            "weight_bits": self._weight_bits or self._infer_weight_bits(),
        }

    def _infer_weight_bits(self) -> int:
        """Stored weight width when the parameters came quantized (a
        quantized checkpoint, where quantize_weights never ran): the least
        width over the quantized leaves, 16 when there is none."""
        bits = []
        for leaf in tree_leaves(self.params):
            if isinstance(leaf, (QuantizedTensor, MatmulWeight)):
                bits.append(leaf.bits)
            elif isinstance(leaf, (Fp8Tensor, Int8Weight)):
                bits.append(8)
        return min(bits) if bits else 16
