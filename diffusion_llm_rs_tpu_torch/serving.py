"""Continuous batching of denoising steps, with the paged quantized KV cache.

Counterpart of `diffusion_llm_rs_tpu/serving.py` (its sharded subclass is
`parallel/serving.py`): `Request`, `Completion`, `ContinuousBatcher`,
`PagedContinuousBatcher`, the bit routers (`make_slot_bits_router`,
`make_slot_budget_router`, `slot_phase_bits_np`), `_quantize_pages`,
`_page_mass_proxy` and the two attention callbacks
(`_paged_attend_factory`, `_dense_attend_factory`).

A fixed pool of B slots runs one denoise step for all slots at their own
timesteps (inactive slots masked); the host loop admits queued requests into
free slots with fresh noise at t = num_steps - 1 and retires slots that pass
t = 0. The paged batcher quantizes each layer's fresh K/V into per-(slot,
layer) page ranges of one pool per bit-width, then attends over them with
`batched_paged_attention`; each slot reads the bucket its phase (or, with
salience routing, each page's salience) routes it to. Where the JAX package
jits a step and scans a chunk of steps, this port captures one step as a
CUDA graph on the card and replays it (`utils.graphs`; one cache a
batcher): a chunk is up to `max_chunk` replays, with the bit routing
computed on the device as in the JAX chunk. The slot state (x, t, the
scores) and the step's inputs are static buffers written in place, as the
pools are.

Randomness comes from a noise source with two methods, `admission(shape)`
(one [B, S, D] draw per admission wave, the admitted slots take their rows)
and `step(shape)` (one [B, S, D] draw per denoise step): `GeneratorNoise` by
default, or any object with those methods, e.g. one that replays another
run's draws. Everything runs on `device` (the card unless the caller asks
for the CPU).
"""

from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from diffusion_llm_rs_tpu_torch.cache.memory_manager import MemoryManager
from diffusion_llm_rs_tpu_torch.cache.paged import (POOL_FIELDS,
                                                    dequantize_page,
                                                    quantize_page)
from diffusion_llm_rs_tpu_torch.cache.salience import allocate_bits_torch
from diffusion_llm_rs_tpu_torch.config import DiffusionConfig
from diffusion_llm_rs_tpu_torch.models import denoiser as dn
from diffusion_llm_rs_tpu_torch.models.diffusion import (DiffusionSchedule,
                                                         p_sample)
from diffusion_llm_rs_tpu_torch.models.sampler import (SUPPORTED, bucket_bits,
                                                       bucket_bits_up)
from diffusion_llm_rs_tpu_torch.ops.paged_attention import (
    batched_paged_attention, merge_partials)
from diffusion_llm_rs_tpu_torch.quant.core import true_div
from diffusion_llm_rs_tpu_torch.utils import graphs
from diffusion_llm_rs_tpu_torch.utils.metrics import metrics
from diffusion_llm_rs_tpu_torch.utils.sanitize import (
    ReentrancyGuard, check_scheduler_invariants, sanitize_enabled)


@dataclasses.dataclass
class Request:
    request_id: str
    seq_len: int
    num_steps: int
    submitted_at: float = dataclasses.field(default_factory=time.time)


@dataclasses.dataclass
class Completion:
    request_id: str
    tokens: np.ndarray                 # [seq_len] decoded token ids
    embeddings: Optional[np.ndarray]   # [seq_len, hidden]; None unless the
    # batcher keeps embeddings
    steps: int
    # submit -> `tokens` on the host: the readout is copied after the next
    # wave's dispatch, so on the card this includes that wave's steps (the
    # JAX package stamps the dispatch of the request's last step instead)
    latency_s: float


class GeneratorNoise:
    """Standard normals from a `torch.Generator`: one seeded here on
    `device`, or one the caller owns (`seed` is then the generator, and its
    device is used)."""

    def __init__(self, seed, device="cuda"):
        if isinstance(seed, torch.Generator):
            self.device, self.generator = seed.device, seed
        else:
            self.device = torch.device(device)
            self.generator = torch.Generator(
                device=self.device).manual_seed(seed)

    def _draw(self, shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.generator,
                           dtype=torch.float32, device=self.device)

    def admission(self, shape) -> torch.Tensor:
        return self._draw(shape)

    def step(self, shape) -> torch.Tensor:
        return self._draw(shape)


class ContinuousBatcher:
    """Fixed-slot continuous batching over the diffusion denoise loop.

    On the card each step replays a captured graph (JAX's jitted step) from
    static buffers: x, written in place, and t, the active mask and the
    noise, copied in before each replay."""

    # whether the steps are captured as CUDA graphs on the card
    capture_steps = True

    def __init__(self, params, cfg: DiffusionConfig,
                 schedule: Optional[DiffusionSchedule] = None,
                 num_slots: int = 8, seq_len: int = 64, seed: int = 0,
                 keep_embeddings: bool = True,
                 sanitize: Optional[bool] = None, device="cuda",
                 noise=None):
        self.device = torch.device(device)
        self.params = params
        self.readout_params = params
        self.keep_embeddings = keep_embeddings
        self.cfg = cfg
        self.schedule = schedule or DiffusionSchedule.create(
            cfg.num_timesteps, cfg.beta_start, cfg.beta_end, cfg.beta_schedule,
            device=self.device)
        if seq_len > cfg.max_sequence_length:
            raise ValueError(
                f"seq_len {seq_len} exceeds the model's max_sequence_length "
                f"{cfg.max_sequence_length}")
        self.num_slots = num_slots
        self.seq_len = seq_len
        self.noise = noise if noise is not None else GeneratorNoise(
            seed, self.device)
        B, S, D = num_slots, seq_len, cfg.hidden_size
        # denoiser compute dtype; slot state and posterior stay f32
        self._model_dtype = (torch.bfloat16 if cfg.dtype == "bfloat16"
                             else torch.float32)
        self.x = torch.zeros((self._local_slots, S, D), dtype=torch.float32,
                             device=self.device)
        # per-slot timestep; -1 = inactive
        self.t = np.full((B,), -1, np.int64)
        self.slot_request: List[Optional[Request]] = [None] * B
        self.queue: Deque[Request] = deque()
        self.completions: Deque[Completion] = deque()
        # retired slots whose readout is launched but not yet copied to the
        # host: the copy happens after the next wave is launched
        self._pending_retires: List[tuple] = []
        self.sanitize = sanitize_enabled() if sanitize is None else sanitize
        self._guard = ReentrancyGuard("batcher.step")
        # the step graphs and their static inputs; freed with the batcher
        self._graphs = graphs.GraphCache(type(self).__name__, self.device,
                                         capture=self.capture_steps)

    @property
    def _shape(self) -> Tuple[int, int, int]:
        return (self.num_slots, self.seq_len, self.cfg.hidden_size)

    def _dev(self, arr, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(arr), dtype=dtype, device=self.device)

    def _static(self, name: str, arr, dtype) -> torch.Tensor:
        """Static input `name` of the step graphs, set to this process's
        rows of the per-slot host array `arr` (or tensor)."""
        src = self._local(torch.as_tensor(np.asarray(arr), dtype=dtype))
        buf = self._graphs.buffer(name, lambda: torch.empty(
            src.shape, dtype=dtype, device=self.device))
        return buf.copy_(src)

    def _step_noise(self) -> torch.Tensor:
        """The step's noise draw, copied into its static buffer."""
        z = self._local(self.noise.step(self._shape))
        buf = self._graphs.buffer("noise", lambda: torch.empty(
            z.shape, dtype=torch.float32, device=self.device))
        return buf.copy_(z)

    def _held(self, *trees) -> tuple:
        """Pointers of what a step graph reads in place: the weights, the
        schedule tables and `trees`."""
        return graphs.pointers(self.params, self.schedule, *trees)

    # -- what this process holds (the sharded batcher holds a 'data' shard) --

    @property
    def _local_slots(self) -> int:
        """Slots whose state this process holds and steps: all of them."""
        return self.num_slots

    def _local(self, a: torch.Tensor) -> torch.Tensor:
        """This process's rows of a per-slot tensor [num_slots, ...]."""
        return a

    def _forward(self, x, t, attend_fn=None) -> torch.Tensor:
        """The denoiser forward of a step."""
        return dn.denoiser_forward(self.params, self.cfg, x, t,
                                   attend_fn=attend_fn)

    def _to_host(self, arr: torch.Tensor) -> np.ndarray:
        """Device -> host copy of a per-slot readout (tokens, embeddings,
        page scores); the sharded batcher gathers every process's rows."""
        return arr.cpu().numpy()

    # -- one batched denoise step --------------------------------------------

    def _denoise(self, x, t, active, noise, attend_fn=None) -> torch.Tensor:
        """One reverse step for every slot at its own timestep; inactive
        slots keep their state."""
        t_clamped = torch.clamp(t, min=0)
        eps = self._forward(x.to(self._model_dtype), t_clamped,
                            attend_fn).to(torch.float32)
        x_next = p_sample(self.schedule, x, t_clamped, eps, noise=noise)
        return torch.where(active[:, None, None], x_next, x)

    # -- public API -----------------------------------------------------------

    def submit(self, request: Request) -> None:
        if request.seq_len > self.seq_len:
            raise ValueError(
                f"request seq_len {request.seq_len} > slot seq_len "
                f"{self.seq_len}")
        # num_steps=0 would admit as t=-1 (never completed); num_steps > T
        # would index the schedule out of range
        if not 1 <= request.num_steps <= self.cfg.num_timesteps:
            raise ValueError(
                f"request num_steps {request.num_steps} outside "
                f"[1, {self.cfg.num_timesteps}]")
        self.queue.append(request)
        metrics.inc("batcher.submitted")

    def active_slots(self) -> int:
        return int((self.t >= 0).sum())

    def _admit(self) -> None:
        """Admit queued requests into free slots: one [B, S, D] draw for
        the whole wave, the admitted slots take their rows."""
        fresh: List[int] = []
        for slot in range(self.num_slots):
            if self.t[slot] >= 0 or not self.queue:
                continue
            req = self.queue.popleft()
            fresh.append(slot)
            self.t[slot] = req.num_steps - 1
            self.slot_request[slot] = req
            metrics.inc("batcher.admitted")
        if fresh:
            noise = self._local(self.noise.admission(self._shape).to(
                self.device))
            mask = np.zeros((self.num_slots,), bool)
            mask[fresh] = True
            self.x.copy_(torch.where(
                self._local(self._dev(mask, torch.bool))[:, None, None],
                noise, self.x))

    def _invoke_step(self, active_mask: np.ndarray) -> None:
        """Run one denoise step, updating self.x in place."""
        t = self._static("t", self.t, torch.int64)
        active = self._static("active", active_mask, torch.bool)
        noise = self._step_noise()

        def step():
            self.x.copy_(self._denoise(self.x, t, active, noise))
        self._graphs.run("step", step, self._held())

    def step(self) -> int:
        """Admit, run denoise step(s), retire finished slots. Returns the
        number of active slots stepped. Guarded against concurrent entry;
        with `sanitize` on, slot-state invariants are checked after."""
        with self._guard():
            n = self._step_impl()
        if self.sanitize:
            check_scheduler_invariants(self)
        return n

    def _step_impl(self) -> int:
        self._admit()
        active_mask = self.t >= 0
        n_active = int(active_mask.sum())
        if n_active == 0:
            self._flush_retires()
            return 0
        self._invoke_step(active_mask)
        # the previous wave's retires: copy now, behind the step just launched
        self._flush_retires()
        finished = active_mask & (self.t == 0)
        self.t = np.where(active_mask, self.t - 1, self.t)
        metrics.inc("batcher.steps")
        metrics.inc("batcher.slot_steps", n_active)
        self._retire(finished)
        return n_active

    def _retire(self, finished: np.ndarray) -> None:
        """Launch the readout of all slots and free the finished ones; the
        copy to the host waits for `_flush_retires`. self.x is the step's
        static buffer, which the next step writes in place: the readout is
        launched now, ahead of that step, and the kept embeddings are a
        copy taken now."""
        if not finished.any():
            return
        tokens_dev = dn.decode_tokens(self.readout_params, self.x)
        x_dev = self.x.clone() if self.keep_embeddings else None
        entries = []
        for slot in np.nonzero(finished)[0]:
            entries.append((int(slot), self.slot_request[slot]))
            self.slot_request[slot] = None
            self.t[slot] = -1
            metrics.inc("batcher.completed")
        self._pending_retires.append((tokens_dev, x_dev, entries))

    def _flush_retires(self) -> None:
        """Copy launched readouts to the host as Completions, stamped
        when the copy returns."""
        for tokens_dev, x_dev, entries in self._pending_retires:
            tokens_all = self._to_host(tokens_dev)            # [B, S]
            x_host = self._to_host(x_dev) if x_dev is not None else None
            t_done = time.time()
            for slot, req in entries:
                self.completions.append(Completion(
                    request_id=req.request_id,
                    tokens=tokens_all[slot, : req.seq_len],
                    embeddings=(x_host[slot, : req.seq_len]
                                if x_host is not None else None),
                    steps=req.num_steps,
                    latency_s=t_done - req.submitted_at))
        self._pending_retires.clear()

    def run_until_drained(self, max_steps: int = 100_000) -> List[Completion]:
        """Drive the loop until queue and slots are empty."""
        steps = 0
        while (self.queue or self.active_slots()) and steps < max_steps:
            self.step()
            steps += 1
        self._flush_retires()
        out = list(self.completions)
        self.completions.clear()
        return out

    def stats(self) -> Dict[str, float]:
        self._flush_retires()
        return {
            "queued": len(self.queue),
            "active": self.active_slots(),
            "completed": len(self.completions),
        }


# ---------------------------------------------------------------------------
# Paged quantized-KV serving path
# ---------------------------------------------------------------------------


def _progress_target(cfg: DiffusionConfig, t: torch.Tensor,
                     half: torch.Tensor) -> torch.Tensor:
    """Progressive decode target in f32, in `slot_phase_bits_np`'s op order
    (so host and device pick the same bucket at every boundary)."""
    qc = cfg.quant_config
    progress = torch.clamp(
        (half - t).to(torch.float32) /
        torch.clamp_min(half, 1).to(torch.float32), 0.0, 1.0)
    target = (float(qc.decode_bits) * (1.0 - progress) +
              float(qc.min_decode_bits) * progress)
    return torch.clamp_min(target, float(qc.min_decode_bits))


def make_slot_bits_router(cfg: DiffusionConfig):
    """Per-slot KV bit-width routing on the device, the twin of
    `slot_phase_bits_np`. Returns (bucket widths, fn) where
    fn(t, total) -> int32 bits per slot: prefill bits while t > total/2,
    then decode bits falling to min_decode_bits when progressive precision
    is on, bucketed onto the supported widths."""
    qc = cfg.quant_config
    if not cfg.use_phase_aware_quant:
        bits = bucket_bits(cfg.kv_quant_bits or 8)
        return (bits,), lambda t, total: torch.full(
            t.shape, bits, dtype=torch.int32, device=t.device)
    pb = bucket_bits(qc.prefill_bits)
    db = bucket_bits(qc.decode_bits)
    if qc.progressive_precision:
        lo = bucket_bits_up(qc.min_decode_bits)  # floor never rounds down
        decode_widths = tuple(b for b in SUPPORTED if lo <= b <= db) or (db,)
    else:
        decode_widths = (db,)
    widths = tuple(sorted(set(decode_widths) | {pb}))

    def fn(t: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
        half = total // 2
        if qc.progressive_precision:
            target = _progress_target(cfg, t, half)
        else:
            target = torch.full(t.shape, float(db), device=t.device)
        dbits = torch.full(t.shape, min(decode_widths), dtype=torch.int32,
                           device=t.device)
        for b in sorted(decode_widths):  # largest width <= target
            dbits = torch.where(target >= b, b, dbits)
        return torch.where(t > half, pb, dbits).to(torch.int32)

    return widths, fn


def make_slot_budget_router(cfg: DiffusionConfig):
    """Device twin of `slot_phase_bits_np`'s float budget: the per-slot
    average-bits budget the salience allocator spends across the slot's
    pages (prefill bits while t > total/2, then the progressive target)."""
    qc = cfg.quant_config
    if not cfg.use_phase_aware_quant:
        b = float(bucket_bits(cfg.kv_quant_bits or 8))
        return lambda t, total: torch.full(t.shape, b, device=t.device)
    db = bucket_bits(qc.decode_bits)

    def fn(t: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
        half = total // 2
        if qc.progressive_precision:
            target = _progress_target(cfg, t, half)
        else:
            target = torch.full(t.shape, float(db), device=t.device)
        return torch.where(t > half, float(qc.prefill_bits),
                           target).to(torch.float32)

    return fn


def _quantize_pages(x: torch.Tensor, bits: int):
    """Per-token quantize pages [N, H, P, Hd] into the pools' token-block
    layout: data [N, H, P/vpb, Hd], scale and zp [N, H, P]."""
    N, H, P, Hd = x.shape
    d, s, z = quantize_page(x.reshape(N * H, P, Hd), bits)
    return (d.reshape(N, H, P // (8 // bits), Hd),
            s.reshape(N, H, P), z.reshape(N, H, P))


def slot_phase_bits_np(cfg: DiffusionConfig, t: np.ndarray,
                       total: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Host (numpy) twin of `make_slot_bits_router`: per-slot (bucketed bits,
    unbucketed float target). The float target is the salience router's
    per-slot bit budget."""
    t = np.asarray(t, np.int64)
    total = np.asarray(total, np.int64)
    qc = cfg.quant_config
    if not cfg.use_phase_aware_quant:
        b = float(bucket_bits(cfg.kv_quant_bits or 8))
        bits = np.full(t.shape, b, np.int32)
        return bits, np.full(t.shape, b, np.float32)
    half = total // 2
    pb = bucket_bits(qc.prefill_bits)
    db = bucket_bits(qc.decode_bits)
    if qc.progressive_precision:
        lo = bucket_bits_up(qc.min_decode_bits)  # same floor as the router
        decode_widths = tuple(b for b in SUPPORTED if lo <= b <= db) or (db,)
        # float32 in the same op order as the device router: float64 here
        # picks another bucket at some boundaries (4.0000000000000004 vs
        # 3.9999998)
        progress = np.clip(
            (half - t).astype(np.float32) /
            np.maximum(half, 1).astype(np.float32),
            np.float32(0.0), np.float32(1.0))
        target = (np.float32(qc.decode_bits) *
                  (np.float32(1.0) - progress) +
                  np.float32(qc.min_decode_bits) * progress)
        target = np.maximum(target, np.float32(qc.min_decode_bits))
    else:
        decode_widths = (db,)
        target = np.full(t.shape, float(db), np.float32)
    dbits = np.full(t.shape, min(decode_widths), np.int32)
    for b in sorted(decode_widths):
        dbits = np.where(target >= b, b, dbits)
    bits = np.where(t > half, pb, dbits).astype(np.int32)
    budget = np.where(t > half, float(qc.prefill_bits), target
                      ).astype(np.float32)
    return bits, budget


def _page_mass_proxy(q, k, *, B, S, Pg, nps, H, Hd, seq_lens, page_idx,
                     page_valid):
    """Per-page attention-mass proxy [B, nps]: softmax over pages of
    (mean valid q) . (mean valid k of the page), in f32; 0 on invalid pages
    (and on every page of an empty slot)."""
    q = q.to(torch.float32)
    k = k.to(torch.float32)
    tok_pos = (page_idx[..., None] * Pg +
               torch.arange(Pg, dtype=torch.int32, device=q.device)[None, None])
    tok_valid = (tok_pos < seq_lens[:, None, None]).to(torch.float32)
    kpage = k.reshape(B, nps, Pg, H, Hd)
    km = (torch.einsum("bnp,bnphd->bnhd", tok_valid, kpage) /
          torch.clamp_min(tok_valid.sum(2), 1.0)[..., None, None])
    qvalid = (torch.arange(S, device=q.device)[None, :]
              < seq_lens[:, None]).to(torch.float32)
    qm = (torch.einsum("bs,bshd->bhd", qvalid, q) /
          torch.clamp_min(qvalid.sum(1), 1.0)[:, None, None])
    logits = true_div(torch.einsum("bhd,bnhd->bn", qm, km), math.sqrt(Hd))
    logits = torch.where(page_valid, logits, -math.inf)
    mass = torch.softmax(logits, dim=-1)
    return torch.where(page_valid, mass, 0.0)


def _page_geometry(seq_lens: torch.Tensor, nps: int, Pg: int):
    """(page index [1, nps], valid tokens per page [B, nps], page valid
    [B, nps]) of slots holding `seq_lens` tokens."""
    page_idx = torch.arange(nps, dtype=torch.int32,
                            device=seq_lens.device)[None, :]
    nps_actual = (seq_lens + Pg - 1) // Pg
    nt = torch.clamp(seq_lens[:, None] - page_idx * Pg, 0, Pg).to(torch.int32)
    return page_idx, nt, page_idx < nps_actual[:, None]


def _dense_attend_factory(*, cfg: DiffusionConfig, B: int, S: int, Pg: int,
                          nps: int, H: int, buckets, page_bits: torch.Tensor,
                          seq_lens: torch.Tensor, scores_acc, used=None):
    """Dense fake-quant twin of `_paged_attend_factory` for short
    sequences: K/V take the same per-(token, head) quantization round trip
    at each page's routed bits (`quantize_page` / `dequantize_page`, the
    values the pools would hold), then one masked dense attention reads the
    reconstruction; no pools and no paged kernel."""
    Hd = cfg.head_dim
    page_idx, _, page_valid = _page_geometry(seq_lens, nps, Pg)
    tok_ok = torch.arange(S, device=seq_lens.device)[None, :] < seq_lens[:, None]
    addmask = (1.0 - tok_ok.to(torch.float32))[:, None, None, :] * -1e9
    tok_bits = page_bits.repeat_interleave(Pg, dim=1)          # [B, S]

    def attend_fn(li, q, k, v, mask):
        del li, mask
        if scores_acc is not None:
            scores_acc.append(_page_mass_proxy(
                q, k, B=B, S=S, Pg=Pg, nps=nps, H=H, Hd=Hd,
                seq_lens=seq_lens, page_idx=page_idx, page_valid=page_valid))

        def fq(z, bits):   # [B, S, H, Hd] quantize/dequantize round trip
            zz = z.permute(0, 2, 1, 3).reshape(B * H, S, Hd)
            out = dequantize_page(*quantize_page(zz, bits), bits)
            return out.reshape(B, H, S, Hd).permute(0, 2, 1, 3)

        kq = torch.zeros_like(k)
        vq = torch.zeros_like(v)
        for bits in buckets:
            if used is not None and bits not in used:
                continue
            sel = (tok_bits == bits)[:, :, None, None]
            kq = torch.where(sel, fq(k, bits).to(k.dtype), kq)
            vq = torch.where(sel, fq(v, bits).to(v.dtype), vq)
        return dn.attention(q, kq, vq, addmask)

    return attend_fn


def _paged_attend_factory(*, cfg: DiffusionConfig, B: int, S: int, Pg: int,
                          nps: int, L: int, H: int, G: int, buckets,
                          pt: torch.Tensor, pools, page_bits: torch.Tensor,
                          active: torch.Tensor, seq_lens: torch.Tensor,
                          scores_acc, used=None, act_bits: int = 16):
    """The per-layer paged-attention callback of the serving step.

    Pools are slot-major on the page axis: page (slot b, layer li, page j)
    is row (b*L + li)*nps + j. Each layer writes its fresh K/V pages into
    every bucket in `used` (update, then read), then reads each page from
    the bucket `page_bits` routes it to: per-bucket page tables compact the
    member pages to the front (stable sort, so uniform routing keeps the
    identity order), and the buckets' partials merge by log-sum-exp.

    With `scores_acc` a list, appends one [B, nps] attention-mass proxy per
    layer (the salience signal); with None it is never built."""
    HG = H // G
    Hd = cfg.head_dim
    page_idx, nt, page_valid = _page_geometry(seq_lens, nps, Pg)

    def to_pages(z):  # [B, S, H, Hd] -> [B*nps, H, Pg, Hd]
        z = z.permute(0, 2, 1, 3).reshape(B, H, nps, Pg, Hd)
        return z.permute(0, 2, 1, 3, 4).reshape(B * nps, H, Pg, Hd)

    def group_pages(d):  # [N, H, Pp, Hd] -> [N, HG, Pp, G*Hd]
        if G == 1:
            return d
        N, _, Pp_, _ = d.shape
        return (d.reshape(N, HG, G, Pp_, Hd).permute(0, 1, 3, 2, 4)
                .reshape(N, HG, Pp_, G * Hd))

    def attend_fn(li, q, k, v, mask):
        del mask
        if scores_acc is not None:
            scores_acc.append(_page_mass_proxy(
                q, k, B=B, S=S, Pg=Pg, nps=nps, H=H, Hd=Hd,
                seq_lens=seq_lens, page_idx=page_idx, page_valid=page_valid))
        kp, vp = to_pages(k), to_pages(v)
        rows = slice(li * nps, (li + 1) * nps)
        parts = []
        for bits in buckets:
            # every page is re-encoded each step: a bucket no slot reads this
            # step is neither quantized nor written
            if used is not None and bits not in used:
                continue
            pool = pools[bits]
            Pp = Pg // (8 // bits)
            for name, pages in (("k", kp), ("v", vp)):
                d, s, z = _quantize_pages(pages, bits)
                pool[f"{name}_data"].view(B, L * nps, HG, Pp, G * Hd)[
                    :, rows] = group_pages(d).reshape(B, nps, HG, Pp, G * Hd)
                for sc, val in (("scale", s), ("zp", z)):
                    pool[f"{name}_{sc}"].view(B, L * nps, HG, G * Pg)[
                        :, rows] = val.reshape(B, nps, HG, G * Pg)
            member = (page_bits == bits) & page_valid
            order = torch.argsort((~member).to(torch.int32), dim=1,
                                  stable=True)
            pt_b = torch.gather(pt[li], 1, order)
            nt_b = torch.gather(nt, 1, order)
            npg = torch.where(active, member.sum(dim=1), 0).to(torch.int32)
            parts.append(batched_paged_attention(
                q.permute(0, 2, 1, 3), pt_b, nt_b, npg,
                pool["k_data"], pool["k_scale"], pool["k_zp"],
                pool["v_data"], pool["v_scale"], pool["v_zp"],
                bits=bits, return_lse=True, head_group=G, act_bits=act_bits))
        out = merge_partials(parts)              # [B, H, S, Hd] f32
        return out.permute(0, 2, 1, 3)

    return attend_fn


class PagedContinuousBatcher(ContinuousBatcher):
    """Continuous batching with the quantized paged KV cache in the loop.

    Every layer of a step quantizes its fresh K/V into fixed per-(slot,
    layer) page ranges of bit-width-bucketed pools and attends over them
    with the batched paged kernel, whose page loop ends at each slot's own
    page count. Each slot reads the bucket of its phase: prefill bits while
    t > num_steps/2, then decode bits falling to min_decode_bits with
    progressive precision (`make_slot_bits_router`); with
    `salience_routing`, a per-slot budget spread over the pages by their
    attention-mass EMA (`allocate_bits_torch`).

    Every step runs in a chunk of up to `max_chunk` steps (`_run_chunk`),
    its routing on the device; max_chunk=1 steps one at a time. On the card
    a chunk replays one captured step graph per (buckets written, routing)
    (JAX's `_build_chunk`, whose scan length becomes the replay count); a
    pool that moved (a spill and a restore under an HBM budget) makes the
    graphs that read it be captured again.

    attend_mode "paged" streams the pools through the paged kernel; "dense"
    attends once over the same quantize/dequantize reconstruction and holds
    no pools; "auto" takes paged at seq_len >= 2048. attn_act_bits=8 runs
    the paged kernel's products in int8 (1-bit buckets keep bf16); the dense
    mode ignores it.
    """

    def __init__(self, params, cfg: DiffusionConfig,
                 schedule: Optional[DiffusionSchedule] = None,
                 num_slots: int = 8, seq_len: int = 64, seed: int = 0,
                 page_size: Optional[int] = None,
                 salience_routing: bool = False,
                 salience_ema: float = 0.8,
                 max_chunk: int = 32,
                 attend_mode: str = "auto",
                 attn_act_bits: int = 16,
                 keep_embeddings: bool = True,
                 hbm_budget_bytes: Optional[int] = None,
                 memory_manager=None,
                 sanitize: Optional[bool] = None,
                 device="cuda", noise=None):
        if attn_act_bits not in (8, 16):
            raise ValueError(f"attn_act_bits must be 8 or 16, "
                             f"got {attn_act_bits}")
        if max_chunk < 1:
            raise ValueError(f"max_chunk must be >= 1, got {max_chunk}")
        if attend_mode not in ("auto", "dense", "paged"):
            raise ValueError(f"unknown attend_mode {attend_mode!r}")
        if attend_mode == "auto":
            attend_mode = "paged" if seq_len >= 2048 else "dense"
        self.attn_act_bits = attn_act_bits
        self.attend_mode = attend_mode
        self.page_size = page_size or min(seq_len, 64)
        # fused steps per dispatch, in power-of-two chunks
        self.max_chunk = max_chunk
        if seq_len % self.page_size:
            raise ValueError(f"seq_len {seq_len} not divisible by page_size "
                             f"{self.page_size}")
        self.salience_routing = salience_routing
        self.salience_ema = salience_ema
        self.buckets, self._slot_bits = make_slot_bits_router(cfg)
        for bits in self.buckets:
            if self.page_size % (8 // bits):
                raise ValueError(f"page_size {self.page_size} not divisible "
                                 f"by {8 // bits} (bits={bits})")
        self.num_pages_per_slot = seq_len // self.page_size
        self.cfg = cfg
        self.head_group = self._choose_head_group()
        super().__init__(params, cfg, schedule, num_slots, seq_len, seed,
                         keep_embeddings=keep_embeddings, sanitize=sanitize,
                         device=device, noise=noise)
        # dense mode never reads pools: it allocates none
        self.pools = ({bits: self._make_pool(bits) for bits in self.buckets}
                      if self.attend_mode == "paged" else {})
        self._page_table = self._page_table_const()
        # HBM budget for the pools: idle buckets spill to the memory
        # manager's host tier and come back when the router needs them
        self.hbm_budget = hbm_budget_bytes
        self.memory = memory_manager
        self._spilled: set = set()
        if self.hbm_budget is not None and self.memory is None:
            self.memory = MemoryManager(device=self.device)
        # per-page attention-mass EMA (host) driving salience routing
        self.page_scores = np.full((num_slots, self.num_pages_per_slot),
                                   1.0 / self.num_pages_per_slot, np.float32)

    def _choose_head_group(self) -> int:
        """G heads of head_dim < 128 share one 128-wide page row, as in the
        JAX pools (G = 2 at head_dim 64)."""
        Hd, H = self.cfg.head_dim, self.cfg.num_attention_heads
        if Hd % 128 == 0:
            return 1
        if 128 % Hd == 0 and H % (128 // Hd) == 0:
            return 128 // Hd
        return 1

    def _make_pool(self, bits: int) -> Dict[str, torch.Tensor]:
        """One bucket's page pool; layers and slots own fixed ranges of the
        page axis."""
        vpb = 8 // bits
        cfg = self.cfg
        n = cfg.num_layers * self._local_slots * self.num_pages_per_slot
        H, Hd, P = self._local_heads, cfg.head_dim, self.page_size
        G = self.head_group
        HG = H // G
        d = (n, HG, P // vpb, G * Hd)
        s = (n, HG, G * P)
        dev = self.device
        return {
            "k_data": torch.zeros(d, dtype=torch.uint8, device=dev),
            "v_data": torch.zeros(d, dtype=torch.uint8, device=dev),
            "k_scale": torch.ones(s, device=dev),
            "k_zp": torch.zeros(s, device=dev),
            "v_scale": torch.ones(s, device=dev),
            "v_zp": torch.zeros(s, device=dev),
        }

    @property
    def _local_heads(self) -> int:
        """Heads whose pages this process holds and attends: all of them."""
        return self.cfg.num_attention_heads

    def _page_table_const(self) -> torch.Tensor:
        """Slot-major page id (slot b, layer li, page j) -> (b*L + li)*nps
        + j, as [L, B, nps] int32 over the process's slots."""
        B, L = self._local_slots, self.cfg.num_layers
        nps = self.num_pages_per_slot
        return self._dev((np.arange(B)[None, :, None] * L +
                          np.arange(L)[:, None, None]) * nps +
                         np.arange(nps)[None, None, :], torch.int32)

    def _make_attend(self, page_bits, active, seq_lens, scores_acc, used):
        cfg = self.cfg
        if self.attend_mode == "dense":
            return _dense_attend_factory(
                cfg=cfg, B=self._local_slots, S=self.seq_len,
                Pg=self.page_size, nps=self.num_pages_per_slot,
                H=self._local_heads, buckets=self.buckets,
                page_bits=page_bits, seq_lens=seq_lens,
                scores_acc=scores_acc, used=used)
        return _paged_attend_factory(
            cfg=cfg, B=self._local_slots, S=self.seq_len,
            Pg=self.page_size, nps=self.num_pages_per_slot,
            L=cfg.num_layers, H=self._local_heads,
            G=self.head_group, buckets=self.buckets, pt=self._page_table,
            pools=self.pools, page_bits=page_bits, active=active,
            seq_lens=seq_lens, scores_acc=scores_acc, used=used,
            act_bits=self.attn_act_bits)

    def _paged_step(self, x, t, active, seq_lens, page_bits, noise, used):
        """One denoise step through the paged (or dense fake-quant)
        attention; returns (x, per-page scores or None)."""
        scores_acc = [] if self.salience_routing else None
        attend_fn = self._make_attend(page_bits, active, seq_lens,
                                      scores_acc, used)
        x = self._denoise(x, t, active, noise, attend_fn)
        scores = (torch.stack(scores_acc).mean(dim=0)
                  if scores_acc is not None else None)
        return x, scores

    def _seq_lens(self) -> np.ndarray:
        return np.asarray([r.seq_len if r is not None else 0
                           for r in self.slot_request], np.int32)

    def _totals(self) -> np.ndarray:
        return np.asarray([r.num_steps if r is not None else 1
                           for r in self.slot_request], np.int64)

    def _admit(self) -> None:
        before = [r is not None for r in self.slot_request]
        super()._admit()
        for slot, (was, req) in enumerate(zip(before, self.slot_request)):
            if not was and req is not None:   # fresh occupant: reset salience
                self.page_scores[slot] = 1.0 / self.num_pages_per_slot

    # -- fused multi-step chunks -----------------------------------------------

    def _chunk_steps(self, active_mask: np.ndarray) -> int:
        """Steps until the next possible membership change (min active t + 1),
        capped at max_chunk and rounded down to a power of two (which fixes
        the buckets each chunk writes)."""
        c = int(self.t[active_mask].min()) + 1
        c = min(c, self.max_chunk)
        return 1 << (c.bit_length() - 1)

    def _used_buckets_chunk(self, active_mask: np.ndarray,
                            totals: np.ndarray, c: int) -> Tuple[int, ...]:
        """Union of the buckets any active slot reads over the chunk's c
        steps (host router at each offset). It must cover the device
        router's picks, or a step's attention would skip those pages: for
        decode-phase slots both neighbours of a boundary within 1e-3 of the
        float target are included."""
        qc = self.cfg.quant_config
        progressive = (self.cfg.use_phase_aware_quant and
                       qc.progressive_precision)
        if progressive:
            lo_w = bucket_bits_up(qc.min_decode_bits)
            widths = sorted(b for b in SUPPORTED
                            if lo_w <= b <= bucket_bits(qc.decode_bits)) \
                or [bucket_bits(qc.decode_bits)]

            def pick(x):
                p = widths[0]
                for b in widths:
                    if x >= b:
                        p = b
                return p

        used = set()
        for s in range(c):
            step_active = active_mask & (self.t - s >= 0)
            if not step_active.any():
                break
            tt = np.maximum(self.t - s, 0)
            bits, budget = slot_phase_bits_np(self.cfg, tt, totals)
            used.update(int(v) for v in np.unique(bits[step_active]))
            if progressive:
                decode_mask = step_active & (tt <= totals // 2)
                for x in budget[decode_mask]:
                    used.add(pick(float(x) - 1e-3))
                    used.add(pick(float(x) + 1e-3))
        return tuple(b for b in self.buckets if b in used) or (self.buckets[0],)

    def _used_buckets_chunk_salience(self, active_mask: np.ndarray,
                                     totals: np.ndarray,
                                     c: int) -> Tuple[int, ...]:
        """Buckets a salience-routed chunk can reach: the allocator starts
        every page at the floor width and upgrades while the budget lasts,
        so a width lv > floor is reachable at a step only if that step's
        surplus (budget - floor) * n_pages covers lv - floor. Budgets do not
        depend on the scores, so the bound holds for any EMA state."""
        opts = tuple(b for b in self.buckets if b >= 2) or self.buckets
        floor = min(opts)
        max_extra = 0.0
        for s in range(c):
            step_active = active_mask & (self.t - s >= 0)
            if not step_active.any():
                break
            _, budget = slot_phase_bits_np(
                self.cfg, np.maximum(self.t - s, 0), totals)
            for b in np.nonzero(step_active)[0]:
                n_valid = -(-self.slot_request[b].seq_len // self.page_size)
                # +1e-3: the device allocator compares an f32 budget; the
                # host bound errs toward inclusion
                max_extra = max(max_extra,
                                (float(budget[b]) + 1e-3 - floor) * n_valid)
        return tuple(lv for lv in opts
                     if lv == floor or (lv - floor) <= max_extra)

    def _run_chunk(self, c: int, totals: np.ndarray, seq_lens: np.ndarray,
                   used: Tuple[int, ...]) -> torch.Tensor:
        """c denoise steps on the device with no host round trip: the bit
        routing (and, with salience, the score EMA and the per-page
        allocation) advance on the device each step, in place. The
        per-slot inputs are copied into static buffers once a chunk (the
        process's rows), the noise once a step, drawn in the eager order.
        Returns the scores' static buffer."""
        self._static("t", self.t, torch.int64)
        self._static("scores", self.page_scores, torch.float32)
        self._static("totals", totals, torch.int64)
        self._static("seq_lens", seq_lens, torch.int32)
        held = self._held([self.pools[b] for b in used if b in self.pools])
        step = self._chunk_step(used)
        for _ in range(c):
            self._step_noise()
            self._graphs.run(("chunk_step", used, self.salience_routing),
                             step, held)
        return self._graphs.static["scores"]

    def _chunk_step(self, used: Tuple[int, ...]):
        """One step of a chunk over the static buffers: x, t and the scores
        advance in place (JAX's scan carry)."""
        st = self._graphs.static
        nps = self.num_pages_per_slot
        ema = self.salience_ema
        budget_fn = make_slot_budget_router(self.cfg)
        opts = tuple(b for b in self.buckets if b >= 2) or self.buckets

        def step():
            t, scores, totals = st["t"], st["scores"], st["totals"]
            _, _, page_valid = _page_geometry(st["seq_lens"], nps,
                                              self.page_size)
            active = t >= 0
            t_clamped = torch.clamp(t, min=0)
            if self.salience_routing:
                page_bits = allocate_bits_torch(
                    scores, budget_fn(t_clamped, totals), page_valid, opts)
            else:
                bits = self._slot_bits(t_clamped, totals)
                page_bits = bits[:, None].expand(-1, nps)
            x, step_scores = self._paged_step(
                self.x, t, active, st["seq_lens"], page_bits, st["noise"],
                used)
            self.x.copy_(x)
            t.copy_(torch.where(active, t - 1, t))
            if self.salience_routing:
                scores.copy_(ema * scores + (1.0 - ema) * step_scores)
        return step

    def _step_impl(self) -> int:
        """Admit, then run a chunk of fused denoise steps. Returns the
        active slots stepped."""
        self._admit()
        active_mask = self.t >= 0
        n_active = int(active_mask.sum())
        if n_active == 0:
            self._flush_retires()
            return 0
        c = self._chunk_steps(active_mask)
        totals = self._totals()
        if self.salience_routing:
            used = self._used_buckets_chunk_salience(active_mask, totals, c)
        else:
            used = self._used_buckets_chunk(active_mask, totals, c)
        self._ensure_pools(used)
        scores = self._run_chunk(c, totals, self._seq_lens(), used)
        if self.salience_routing:
            # a copy: on the CPU the host view would share the static buffer
            self.page_scores = self._to_host(scores).copy()
        # the previous wave's retires: copy now, behind the chunk just launched
        self._flush_retires()
        new_t = np.where(active_mask, self.t - c, self.t)
        metrics.inc("batcher.steps", c)
        metrics.inc("batcher.slot_steps", n_active * c)
        finished = active_mask & (new_t < 0)
        self.t = new_t
        self._retire(finished)
        return n_active

    # -- pool memory and the HBM budget ----------------------------------------

    def cache_memory_bytes(self) -> int:
        """Device bytes held by the resident page pools (packed data and
        sidecars); spilled buckets are not counted."""
        return sum(a.numel() * a.element_size()
                   for pool in self.pools.values() for a in pool.values())

    def _pool_key(self, bits: int, name: str) -> str:
        return f"kvpool:{id(self)}:{bits}:{name}"

    def spilled_buckets(self) -> Tuple[int, ...]:
        return tuple(sorted(self._spilled))

    def _spill_bucket(self, bits: int) -> None:
        pool = self.pools.pop(bits)
        for name, arr in pool.items():
            self.memory.allocate(self._pool_key(bits, name), arr, tier="host")
        self._spilled.add(bits)
        metrics.inc("batcher.pool_spills")

    def _place_pool(self, pool: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        """Device placement of a pool restored from the host tier."""
        return {name: arr.to(self.device) for name, arr in pool.items()}

    def _restore_bucket(self, bits: int) -> None:
        pool = {}
        for name in POOL_FIELDS:
            key = self._pool_key(bits, name)
            pool[name] = torch.from_numpy(np.asarray(self.memory.get(key)))
            self.memory.deallocate(key)
        self.pools[bits] = self._place_pool(pool)
        self._spilled.discard(bits)
        metrics.inc("batcher.pool_restores")

    def _ensure_pools(self, used: Tuple[int, ...]) -> None:
        """Under an HBM budget: restore the buckets this dispatch reads, then
        spill the widest idle buckets until the resident pools fit. Every
        page is rewritten each step, so a spilled pool's content is never
        read again; only capacity moves, and trajectories do not change.
        The used buckets stay resident even if they alone exceed the
        budget."""
        if self.attend_mode != "paged" or self.hbm_budget is None:
            return
        for bits in used:
            if bits not in self.pools:
                self._restore_bucket(bits)
        idle = [b for b in sorted(self.pools) if b not in used]
        while self.cache_memory_bytes() > self.hbm_budget and idle:
            self._spill_bucket(idle.pop())   # widest idle pool first
