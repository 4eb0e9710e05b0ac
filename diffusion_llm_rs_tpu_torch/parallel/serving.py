"""Sharded paged serving: continuous batching over a ('data', 'model') mesh.

Counterpart of `diffusion_llm_rs_tpu/parallel/serving.py`:

  - the slots and their quantized KV page pools split over 'data': a rank
    holds B/dp slots and their pages (pages are slot-major on the pools'
    page axis, so a slot is never split)
  - the weights split over 'model' (Megatron TP, `parallel/tp.py`):
    attention is head-local, so the batched paged-attention kernel runs
    unchanged on the rank's H/tp heads, and the pools' head-group axis
    splits over 'model' too
  - every rank draws the whole batch's noise from the same seeded source
    and keeps its slots' rows, so a 'data'-only mesh gives the
    single-process `PagedContinuousBatcher`'s trajectories bit for bit
    (JAX gets the same from per-slot keys)

The host scheduler (admission, retirement, bucket choice) is the base
class's and runs on every rank in lockstep: it reads only what every rank
holds alike. The readouts it reads back (tokens, embeddings, salience
scores) are gathered over 'data' (`_to_host`), and the salience scores are
averaged over 'model' first, so every rank sees the whole model's
attention mass.

On the card a chunk's step replays a captured CUDA graph, as the base
class's does, when every group the step's collectives run over is NCCL's
(JAX's jitted `shard_map` step): NCCL collectives can be captured, gloo's
cannot, so a gloo mesh steps eagerly. The readouts' all-gather over 'data'
stays outside the graph.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from diffusion_llm_rs_tpu_torch.config import DiffusionConfig
from diffusion_llm_rs_tpu_torch.models.diffusion import DiffusionSchedule
from diffusion_llm_rs_tpu_torch.parallel.mesh import Mesh, gather_batch
from diffusion_llm_rs_tpu_torch.parallel.tp import (place_tp_params,
                                                    tp_denoiser_forward)
from diffusion_llm_rs_tpu_torch.serving import PagedContinuousBatcher


def nccl_only(groups) -> bool:
    """Whether every process group of `groups` (None: no collective) is
    NCCL's, whose collectives a CUDA graph can hold."""
    return all(g is None or dist.get_backend(g) == "nccl" for g in groups)


class ShardedPagedBatcher(PagedContinuousBatcher):
    """`PagedContinuousBatcher` with slots and pools over 'data' and weights
    over 'model'; one rank of it runs in each process of the mesh, all fed
    the same requests.

    A chunk's step runs collectives over 'model' (the TP forward's
    all-reduces, the salience scores'); it is captured and replayed when
    that group is NCCL's, and runs eagerly over gloo. Every rank runs each
    step's collectives once, eagerly or by replay: the graph keys (buckets
    written, routing) come from the lockstep scheduler, so the ranks warm
    up, capture and replay together. A rank that captures a key again on
    its own (its pools moved) is harmless: a capture records the
    collectives and launches no communication."""

    def __init__(self, params, cfg: DiffusionConfig, mesh: Mesh,
                 schedule: Optional[DiffusionSchedule] = None,
                 num_slots: int = 8, seq_len: int = 64, seed: int = 0,
                 page_size: Optional[int] = None,
                 salience_routing: bool = False, salience_ema: float = 0.8,
                 max_chunk: int = 32, attend_mode: str = "auto",
                 attn_act_bits: int = 16,
                 keep_embeddings: bool = True,
                 hbm_budget_bytes: Optional[int] = None,
                 memory_manager=None,
                 sanitize: Optional[bool] = None, noise=None):
        self.mesh = mesh
        self.dp = mesh.shape["data"]
        self.tp = mesh.shape["model"]
        if num_slots % self.dp:
            raise ValueError(f"num_slots {num_slots} not divisible by data "
                             f"axis {self.dp}")
        if cfg.num_attention_heads % self.tp:
            raise ValueError(f"heads {cfg.num_attention_heads} not divisible "
                             f"by model axis {self.tp}")
        self._row0 = mesh.index("data") * (num_slots // self.dp)
        self.capture_steps = nccl_only([mesh.group("model")])
        super().__init__(params, cfg, schedule, num_slots, seq_len, seed,
                         page_size, salience_routing=salience_routing,
                         salience_ema=salience_ema, max_chunk=max_chunk,
                         attend_mode=attend_mode, attn_act_bits=attn_act_bits,
                         keep_embeddings=keep_embeddings,
                         hbm_budget_bytes=hbm_budget_bytes,
                         memory_manager=memory_manager, sanitize=sanitize,
                         device=mesh.device, noise=noise)
        HG = cfg.num_attention_heads // self.head_group
        if HG % self.tp:
            raise ValueError(f"head groups {HG} not divisible by model axis "
                             f"{self.tp}")
        # the step runs this rank's Megatron shard; the readout needs only
        # the (replicated) embedding table
        self.params = place_tp_params(params, mesh)
        self.readout_params = {"tok_embed": params["tok_embed"].to(
            mesh.device)}
        self._model_group = mesh.group("model")

    @property
    def _local_slots(self) -> int:
        return self.num_slots // self.dp

    @property
    def _local_heads(self) -> int:
        return self.cfg.num_attention_heads // self.tp

    def _local(self, a: torch.Tensor) -> torch.Tensor:
        return a[self._row0:self._row0 + self._local_slots]

    def _choose_head_group(self) -> int:
        g = super()._choose_head_group()
        # a rank's heads must still tile into whole page rows
        while g > 1 and self._local_heads % g:
            g //= 2
        return g

    def _forward(self, x, t, attend_fn=None) -> torch.Tensor:
        return tp_denoiser_forward(self.params, self.cfg, x, t, self.tp,
                                   self._model_group, attend_fn=attend_fn)

    def _paged_step(self, x, t, active, seq_lens, page_bits, noise, used):
        x, scores = super()._paged_step(x, t, active, seq_lens, page_bits,
                                        noise, used)
        if scores is not None and self._model_group is not None:
            # the salience proxy is head-local: average it over 'model'
            dist.all_reduce(scores, group=self._model_group)
            scores = scores / self.tp
        return x, scores

    def _to_host(self, arr: torch.Tensor):
        """Every rank's slots of a readout, in slot order (an all-gather
        over 'data'), on the host: each rank's scheduler retires and routes
        the same slots."""
        return gather_batch(arr, self.mesh, "data").cpu().numpy()
