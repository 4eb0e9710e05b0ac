"""Engine: the end-user facade over the denoiser, its quantized weights and
the paged serving batcher.

Counterpart of `diffusion_llm_rs_tpu/engine.py`: construction (random or
given parameters, with the prefill and system settings, building the
salience engine, the ANN index, the router, the dedup store and the memory
manager), `from_pretrained` (a
checkpoint with its config and tokenizer), `quantize_weights` (1/2/4/8-bit
integers by round to nearest or by GPTQ, by default repacked into the
`MatmulWeight` layout the packed matmul kernel reads; or fp8), greedy
`generate` with its exact-prefix
next-token memo, `sample` through `serving.PagedContinuousBatcher` or, with
`use_paged=False` and for sequence lengths no page size divides, through the
phase-aware sampler over a carried quantized KV cache
(`models.sampler.phase_aware_sample`), `denoising_perplexity`, the KV-cache
manager's accounting, the host-side ingestion stack (`tokenize_model`, the
attention-mask cache, `process_model`: tokenize, embed, compress, store with
dedup, route, index; `prefill` with its suffix-automaton prompt cache;
`get_cached_vectors`) and `stats` with the dedup, index and router keys.

Everything runs on `device`: the card unless the caller asks for the CPU.
Embeddings are taken on the device, compressed there a bit width at a time
(`index.anns.compress_rows`) and copied to the host once; the ANN index
keeps its quantized matrix on the device; the store, the router and the
prompt cache are host code, as in the JAX package.
Where the JAX package draws from a PRNG key, this one draws from a seeded
`torch.Generator` on the device, or takes the noise from the caller.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from diffusion_llm_rs_tpu_torch.cache.kv_cache import KVCacheManager
from diffusion_llm_rs_tpu_torch.cache.memory_manager import MemoryManager
from diffusion_llm_rs_tpu_torch.cache.salience import SalienceEngine
from diffusion_llm_rs_tpu_torch.cache.suffix_tree import SuffixTree
from diffusion_llm_rs_tpu_torch.config import (DiffusionConfig, PrefillConfig,
                                               SystemConfig)
from diffusion_llm_rs_tpu_torch.index.anns import (CompressedVector,
                                                   FusionANNS, compress_rows)
from diffusion_llm_rs_tpu_torch.models import denoiser as dn
from diffusion_llm_rs_tpu_torch.models.diffusion import (DiffusionSchedule,
                                                         add_noise)
from diffusion_llm_rs_tpu_torch.models.sampler import phase_aware_sample
from diffusion_llm_rs_tpu_torch.models.types import TokenizedVector
from diffusion_llm_rs_tpu_torch.ops.matmul import Int8Weight, MatmulWeight
from diffusion_llm_rs_tpu_torch.ops.packed_matmul import prepare
from diffusion_llm_rs_tpu_torch.quant.core import (Fp8Tensor, QuantizedTensor,
                                                   map_leaves, quantize_fp8,
                                                   quantize_tree, tree_leaves)
from diffusion_llm_rs_tpu_torch.quant.gptq import (gptq_quantize_tree,
                                                   make_calib_batches)
from diffusion_llm_rs_tpu_torch.router.router import NSRouter
from diffusion_llm_rs_tpu_torch.storage.dedup import IODedupEngine
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


class Engine:
    """End-to-end quantized diffusion-LM inference engine."""

    def __init__(
        self,
        config: Optional[DiffusionConfig] = None,
        prefill_config: Optional[PrefillConfig] = None,
        system_config: Optional[SystemConfig] = None,
        tokenizer: Optional[BPETokenizer] = None,
        params=None,
        seed: int = 0,
        device="cuda",
    ):
        self.device = torch.device(device)
        self.config = config or DiffusionConfig()
        self.prefill_config = prefill_config or PrefillConfig(
            embedding_dim=self.config.hidden_size)
        self.system_config = system_config or SystemConfig()
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
        # the host-side stack: salience, ANN index, router, dedup store,
        # memory manager
        self.salience = SalienceEngine(cache_size=self.prefill_config.cache_size)
        self.anns = FusionANNS(embedding_dim=self.config.hidden_size,
                               device=self.device)
        self.router = NSRouter()
        sc = self.system_config
        self.dedup = IODedupEngine(path=sc.ssd_path,
                                   enable_direct_io=sc.enable_direct_io,
                                   batch_size=sc.batch_size,
                                   dedup_buffer_size_mb=sc.dedup_buffer_size_mb)
        self.memory = MemoryManager(hbm_budget=sc.hbm_size_gb << 30,
                                    device=self.device)
        self._prefill_store: Dict[str, CompressedVector] = {}
        self._attention_masks: Dict[str, np.ndarray] = {}
        # prompt cache: per cache id, a suffix automaton over the prefilled
        # text and the token ids it indexed, so a repeated or extended
        # prompt skips embedding and quantizing the matched prefix
        self._prefix_index: Dict[str, Tuple[SuffixTree, List[int]]] = {}
        self.prefill_prefix_hits = 0
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
        self._prefill_store.clear()
        self._prefix_index.clear()
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
    # tokenization + attention-mask cache
    # ------------------------------------------------------------------

    def _embed(self, token_ids: Sequence[int]) -> torch.Tensor:
        """Embedding rows [n, D] (f32, on the device) of token ids."""
        ids = torch.tensor([list(token_ids)], dtype=torch.int64,
                           device=self.device)
        return dn.embed_tokens(self.params, ids)[0]

    def tokenize_model(self, text: str, model_id: str = "model"):
        """Tokenize into one TokenizedVector with the embedding rows (host
        numpy, f32)."""
        token_ids = self.tokenizer.encode(text)
        return [TokenizedVector(id=model_id, tokens=token_ids,
                                embeddings=self._embed(token_ids).cpu().numpy())]

    def set_attention_mask(self, vector_id: str, mask) -> None:
        """Cache an attention mask for a vector id."""
        self._attention_masks[vector_id] = np.asarray(mask, np.float32)

    def apply_attention_masks(self, tokens, offsets) -> None:
        """Apply the cached masks to TokenizedVectors at their offsets."""
        for tv, offset in zip(tokens, offsets):
            mask = self._attention_masks.get(tv.id)
            if mask is not None:
                tv.apply_mask(mask, offset)

    # ------------------------------------------------------------------
    # process_model: the ingestion pipeline
    # ------------------------------------------------------------------

    def process_model(self, text: str, model_id: str = "model") -> Dict[str, int]:
        """Tokenize -> embed -> compress (bit widths cycling over
        `system_config.quantization_bits`) -> dedup-store -> route -> index."""
        token_ids = self.tokenizer.encode(text)
        ids = [f"{model_id}:{i}" for i in range(len(token_ids))]
        compressed = compress_rows(self._embed(token_ids),
                                   self.system_config.quantization_bits, ids,
                                   device=self.device)
        written = self.dedup.store_vectors(compressed)
        self.router.update_routing(compressed)
        self.anns.index_compressed(compressed)
        return {"tokens": len(token_ids), "stored": written,
                "dedup_hits": self.dedup.dedup_hits}

    # ------------------------------------------------------------------
    # prefill with the prompt cache
    # ------------------------------------------------------------------

    def prefill(self, text: str, cache_id: str = "default") -> int:
        """Tokenize -> embed -> quantize -> cache -> salience -> route.

        Repeated or prefix-extended prompts reuse the prompt cache: the
        suffix automaton over the previously prefilled text proposes a
        match, position-aligned token comparison confirms it, and only the
        unmatched suffix is embedded, quantized and stored. Returns the
        number of new tokens processed."""
        token_ids = self.tokenizer.encode(text)
        if not token_ids:
            return 0
        reuse = 0
        indexed = self._prefix_index.get(cache_id)
        if indexed is not None:
            tree, old_ids = indexed
            # the automaton's longest prefix of `text` in the indexed text;
            # comparing tokens pins the match to position 0
            if tree.longest_match(text) > 0:
                max_tok = min(len(token_ids), len(old_ids))
                while reuse < max_tok and token_ids[reuse] == old_ids[reuse]:
                    reuse += 1
        new_ids = token_ids[reuse:]
        self.prefill_prefix_hits += reuse
        # a shorter or diverged prompt: drop the old tail entries, or
        # get_cached_vectors would serve the old prompt's embeddings
        if indexed is not None:
            for i in range(len(token_ids), len(indexed[1])):
                self._prefill_store.pop(f"{cache_id}:{i}", None)
        for i in range(reuse):   # matched prefix: refresh salience only
            self.salience.update(f"{cache_id}:{i}")
        if new_ids:
            ids = [f"{cache_id}:{i}" for i in range(reuse, len(token_ids))]
            compressed = compress_rows(self._embed(new_ids),
                                       self.prefill_config.quant_bits, ids,
                                       device=self.device)
            for vec in compressed:
                self._prefill_store[vec.id] = vec
                self.salience.update(vec.id)
            self.router.update_routing(compressed)
        self.salience.calculate(text)
        self._prefix_index[cache_id] = (SuffixTree(text), token_ids)
        return len(new_ids)

    def get_cached_vectors(self, ids: Sequence[str]) -> List[np.ndarray]:
        """Dequantized prefill vectors (host f32); a zero vector on a miss."""
        out = []
        for vid in ids:
            vec = self._prefill_store.get(vid)
            out.append(vec.dequantize() if vec is not None
                       else np.zeros((self.config.hidden_size,), np.float32))
        return out

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
        """The dedup store's metrics, then the KV cache's, the prefill
        store's, the index's and the router's sizes and the weight width."""
        s = dict(self.dedup.stats())
        s.update({
            "kv_cache_bytes": self.kv_cache.memory_usage(),
            "kv_cache_entries": len(self.kv_cache),
            "prefill_vectors": len(self._prefill_store),
            "indexed_vectors": len(self.anns),
            "router_nodes": len(self.router.nodes),
            "weight_bits": self._weight_bits or self._infer_weight_bits(),
        })
        return s

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
