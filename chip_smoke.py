#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

The samplers' and batchers' steps replay captured CUDA graphs by default
(`diffusion_llm_rs_tpu_torch/utils/graphs.py`); the card-against-CPU
checks and any step that copies to the host run under
`graphs.disabled()`, eagerly. Each phase logs the graphs it captured and
replayed.

Phases (any failure makes the script exit non-zero without the final line):
  1. device   - needs torch.cuda; prints `nvidia-smi` name and power limit.
  2. build    - compiles every kernel of the port (nvcc, sm_90a, one process
                per source, in parallel) and prints ptxas' registers/smem.
  3. kernels  - each kernel against its plain PyTorch twin on the card at the
                shapes of the paths below, with the tolerance stated; times
                of the kernel, the twin, one library call used only as a
                yardstick, and the least time the card could take (bound).
                The attention kernels also at the other head widths the
                port serves (32 and 128; the anchor's 8 heads of 32 in paged
                pools of 4 heads a row and pages of 8 and 32; dense
                attention timed at all three widths and with f32 out). The
                fused MLP at the sampler's M = 2048 and serving's M = 8192,
                also bit for bit against the chained kernels, with their
                time and the clusters the card runs at once. The two int8
                GEMMs (one s8 wgmma core) with the plan each shape ran,
                int8w_matmul also at serving's M = 8192; their yardsticks
                are torch._int_mm with the epilogue in torch ops over the
                weight row-major and column-major (the transposed view of
                the K-major copy), and that product alone. torch._int_mm
                takes more than 16 rows, so its yardstick at M = 8 pads the
                rows to 32 (noted). Also
                quantize_page and quantize_kv on the card against the CPU,
                bit for bit. The batched paged attention's unpack pass
                (paged_unpack) bit for bit against its twin in both layouts,
                timed at the two timed shapes, with its scratch bytes. The
                batched paged kernels also at the serving example's heads of
                16 (2 slots, S=16, pages of 8, 8/4/2 bits, act 16 and 8;
                the 4-bit case timed); quant_attention, dense_attention and
                paged_attention at heads of 16 (`DiffusionConfig.tiny()`'s
                shapes and BH=128 or Sq=1024 at S=1024, timed; each timed
                attention row's log line also notes the floor of a design
                that takes every exp on the MUFU ex2 unit, one exp a logit
                at 16 a clock an SM and `nvidia-smi clocks.max.sm`: a floor
                of these kernels, not of the card, and not in the kernels
                line). The attention kernels also at the widths of phase
                heads_wide, timed: dense attention at heads of 48 and 96
                (BH=48, beside 128) and 256 (BH=24), S=1024;
                quant_attention at heads of 48 and 96 (BH=48, beside 128)
                and 256 (BH=24), S=256; paged_attention at heads of 48
                (BH=12), 96 and 128 (BH=6) and 256 (BH=3); both batched
                paged kernels at heads_wide's serving shape (B=2, Sq=2048,
                16 pages of 128, 4-bit) with 16 heads of 48 in groups of 8,
                8 of 96, 8 of 128 and 3 of 256. The wide instances (heads
                past 256), timed at the work of heads of 128: dense
                attention at heads of 384 (BH=16) and 768 (BH=8), S=1024;
                quant_attention at 384 (BH=16) and 768 (BH=8), S=256;
                paged_attention at 384 (BH=2) and 768 (BH=1); both batched
                paged kernels and paged_unpack at heads_wide's serving shape
                with 2 heads of 384 and one of 768; and untimed at heads of
                264 (a ragged column block, packed rows of 33 bytes at 1
                bit), 520 and 2048, and past them at 2056.
                Every attention kernel runs heads of 264 to 2048 in the
                cluster kernels (csrc/wide_cluster_flash.cuh, and for
                fused-QKV attention csrc/fused_qkv_attention_wide.cu; the
                quantized-KV rows give the splits of their chain over
                clusters, the batched and fused-QKV rows the clusters of
                their instance the card runs at once), the clusters of each
                size the card runs at once are logged, and any size it
                cannot place fails the phase; past 2048 every attention
                kernel runs the same cluster design with blocks of k slices
                of 256 columns (`cluster_plan`: 5 blocks of 2 at 2056 and
                2560, 6 of 3 at 4104). fused_qkv_attention at
                B=8, S=256 and 864, width 768, with 12 heads of 64, 4 of
                192, 3 of 256 (its wgmma design) and 2 of 384 and one of 768
                (its cluster kernel). Past 2048, timed, every attention
                mode at heads of 2056 beside the cluster kernel at 2048 on
                the same work: dense (BH=3, S=1024), quant_attention (BH=3,
                S=256, 4-bit), paged_attention (BH=1, Sq=1024, 3 pages of
                128), both batched kernels and paged_unpack (B=2, Sq=2048,
                one head, 6 pages of 128 a slot), each the work of its row
                of 768 within 0.4%, and fused_qkv_attention (B=8, S=256,
                one head); and at k = 3, at one head of 4104, every mode
                (fused_qkv_attention at B=8, S=240: JAX's 8 MiB admits no
                longer row), each at its shape at 2056; untimed, the one
                head of 2560 of heads_wide's 2-layer model at its own
                shapes: quant_attention at BH=8, Sq=Skv=256 at 8, 4 and 2
                bits, both batched kernels at B=2, Sq=2048, 16 pages of
                128 a slot. The
                kernels line gives each design's wide instance as
                `wide_instance` (its first timed row, its design, source and
                C entry point, and its launches on heads_wide's heads of 384
                and 768).
  4. sampler  - the W4A8 sampler at full width (12 layers, 768 wide, 12 heads,
                vocab 50257; random weights from a seed, quantized in the
                port): B=8, S=256, 32 steps, bf16 activations, timed 5 times
                (median), then decode_tokens. Checks finite output, token
                range and the launch counts of every run (27 int8w_matmul +
                12 fused int8w_mlp per step, no chained MLP), with host CPU
                time; after a W4A8 forward no int8 weight has a K-major copy
                (each is held K-major once, ROADMAP C32); the same run
                with the model built at max_sequence_length 1024 and 4096,
                alternating; then 2 steps on the same noise against the
                plain twins on the CPU.
  5. long S   - 2 steps at B=2, S=1024, where attention runs through the
                dense_attention kernel (12 launches per forward).
  6. scan     - the phase-aware cached sampler (`phase_aware_sample`) on the
                same W4A8 model: scan_sampler (B=8, S=256, 32 steps over the
                default 8 -> 4 -> 2 bit schedule, the packed KV carry read by
                the quant_attention kernel: timed 5 times, host CPU time, peak
                memory, busy share of an 8-step run, exact launch counts, 12
                quant_attention a step after the bootstrap; 2 steps at B=2,
                S=1024; 4 steps with the dequantized carry) and scan_check (3
                steps across both segment boundaries on the card against the
                plain versions on the CPU from the same draws).
     profile  - torch.profiler over one forward at B=8, S=256: device time
                by kernel and the device-busy share.
     fused_qkv - one forward at B=8, S=256, t=500 with attend_fn running
                fused_qkv_attention on each layer's [B, S, 3D] projection:
                12 launches, eps against the einsum forward and against the
                plain versions on the CPU.
  7. cache    - PagedKVCache.attend over a salience-allocated chain of 16
                pages at three widths: one paged_attention launch per width,
                against the same cache on the CPU.
  8. serving  - the paged serving batcher at full width (the same model):
                serve_paged (S=4096, 2 slots, pages of 128, 4-bit KV,
                salience routing, 2 GiB HBM budget: JAX's long-sequence
                serving bench), serve_phase (S=2048, 4 slots, pages of 64,
                the default 8 -> 4 -> 2 phase schedule, mixed step counts),
                serve_dense (S=256, 8 slots, the dense fake-quant mode), each
                with generated tokens/s, request latency (submit to tokens
                on the host), peak memory, the device-busy share of one
                fused chunk of 8 steps (with the int8 GEMMs' and the fused
                MLP's device ms a step) and its launch counts; and
                serve_check (one step at S=512 on the card against the twins
                on the CPU from the same noise); serve_paged_a8 (serve_paged
                with attn_act_bits=8: the int8 paged kernel, 12 launches a
                step and none of the bf16 kernel, one step against the CPU,
                and a chunk over 8-, 2- and 1-bit buckets, where only the
                1-bit bucket may show the bf16 kernel).
     graphs   - (run after the engine phases) every path below that
                replays CUDA graphs by default, against itself under
                `utils.graphs.disabled()` from the same draws: the one-shot
                and scan samplers, serve_paged, serve_paged_a8,
                serve_phase, serve_dense and engine_packed; outputs bit for
                bit, launch counts equal, ms a step, busy share, captures
                and seconds a capture, peak memory, both ways; and a spill
                and restore under an HBM budget that must capture again.
  9. engine   - the `Engine` facade over packed weights, on a second model of
                the same full width built by `Engine(config=...)` from a seed
                and packed by `quantize_weights(4)`: engine_packed (bf16
                activations into the `matmul` kernel: sample B=8, S=256, 32
                steps through the paged batcher, timed, with peak memory and
                the device-busy share of a chunk; 4 steps in paged mode; a
                greedy `generate`; one `denoising_perplexity`; exact launch
                counts, 51 a forward; `sample(use_paged=False)` and
                `sample(seq_len=100)`, which no page divides, through the
                scan sampler), engine_packed_a8 (the same with
                `weight_quant.act_bits=8`, the `matmul_a8` kernel),
                engine_anchor (`Engine.from_pretrained()` on the shipped
                trained checkpoint, 8 heads of 32: fp32 `generate` on the
                card equal to the CPU token for token, perplexity of a fixed
                text under a tenth of the vocabulary before and after int4,
                `sample(seq_len=10)` through the scan sampler and
                quant_attention, `sample(attend_mode="paged")` through the
                paged kernel; launch counts > 0, tokens in range),
                train_grad (one `p_losses` gradient at S=1024 on a 2-layer
                f32 model of the anchor's widths: dense_attention with f32
                out at heads of 32 and JAX's VJP, nonzero wq/wk/wv gradients
                within 1e-2 of the einsum path's),
                heads16 (every path of `DiffusionConfig.tiny()`, 4 heads
                of 16, on the card: `Engine.sample(seq_len=10)` and
                `sample(seq_len=32, use_paged=False)` through the scan
                sampler and quant_attention, `PagedKVCache.attend` through
                paged_attention, the S=1024 one-shot sampler and a
                `p_losses` gradient through dense_attention; exact launch
                counts; scan_check, cache_attend, long_seq and train_grad
                themselves, run at tiny's widths with their bounds),
                heads_wide (every attention path at full width, W4A8, with
                8 heads of 96, 3 of 256, 2 of 384 and one of 768, the last
                two in the wide instances, and a 2-layer model of one head
                of 2560 at width 2560 for every path of the cluster design
                past 2048: the S=1024 sampler, the scan sampler and the
                paged batcher with bf16 and with int8 attention (each with
                its card-vs-CPU check and replayed bit for bit),
                `PagedKVCache.attend` and the fused-QKV forward; on the
                others: the S=1024 sampler,
                `Engine(config, params=...).sample(use_paged=False)` over
                the decoded W4A8 weights (f32 residuals into the W4A8
                kernels), the paged batcher at S=2048 with bf16
                and int8 attention, `PagedKVCache.attend`, a forward with
                `attend_fn` running fused_qkv_attention; exact launch
                counts, token ranges, card vs CPU within heads16's bounds,
                each replaying path against eager bit for bit)
                and engine_check (one packed forward on the card against
                the plain versions on the CPU, act16 and a8); engine_gptq (the anchor quantized by
                GPTQ on the card and on the CPU from the same draws: grids
                bit for bit, levels that differ counted, perplexity on both,
                `generate` on the card); engine_gptq_shipped (the six
                shipped GPTQ checkpoints, `benchmarks/quality_anchor{,_real}
                .gptq{1,2,4}g128`, loaded on the card and the CPU with the
                anchor's parameters as `like`, every 2-D leaf prepared at act
                16 and 8 as `benchmarks/bench_quality.py` does: one `matmul`
                or `matmul_a8` launch a prepared leaf in a forward (27),
                perplexity of a fixed text card vs CPU within 2e-3 at act 16
                and 5e-3 at act 8); engine_ingest (the host-side stack
                at full width, random weights: `process_model` on about 512
                tokens of repeated phrases, `prefill` of the text, again and
                prefix-extended, on the card and on a CPU engine over the
                same parameters: compressed rows, index top-k ids, router,
                prefill vectors and stats equal, the store read back, the
                prompt cache's hits; seconds by part); cli (`python -m
                diffusion_llm_rs_tpu_torch` sample, quantize --quant-method
                gptq --out, ppl --checkpoint, ingest --file, each its own
                process).
 10. parallel - the parallel stack, each path on an NCCL group of one (one
                card cannot hold two ranks) at full width: serve_sharded
                (`ShardedPagedBatcher` on a (1, 1) mesh over int4 g128
                `MatmulWeight`s, S=2048, 4 slots, pages of 64, 4 requests
                of 8 steps: tokens, tokens/s, latency and peak memory, token
                for token and launch for launch against
                `PagedContinuousBatcher`; its chunk replayed over NCCL bit
                for bit against itself under `graphs.disabled()`, with ms a
                step, busy share, captures and the NCCL kernels the profiler
                sees in a replayed chunk), tp_forward (`make_tp_forward`
                against `denoiser_forward` at act 16 and 8, B=8, S=256 and
                1024: bit for bit), moe_forward (8 experts, decoded-int8
                projections, f32 banks; dense against sorted dispatch and
                EP on an expert mesh of one against the unsharded forward,
                bit for bit; a 2-layer cut card vs CPU) and pp_sp_forward
                (a pipeline stage of one and a ring of one against
                `denoiser_forward`), each forward timed after a warm call.
 11. examples - the four torch examples (`examples/torch_*.py`) through
                their `main(device="cuda")`; the serving example's paged
                launches counted at heads of 16.
 12. summary  - a JSON line of kernels, a JSON line of the runs, then the
                device line last.

    python3 chip_smoke.py --parent DIR

also times the attention kernels (`quant_attention`, `dense_attention`,
`paged_attention` at the head widths 16, 32, 64, 96, 128, 192 and 256;
`fused_qkv_attention` at 12 heads of 64, 4 of 192, 3 of 256, 2 of 384 and
one of 768, the last two also at S = 864;
`paged_unpack` in both layouts and each batched paged kernel alone at
serve_paged's pools, heads of 16 to 256; `PARENT_SHAPES`; the wide
instances at heads of 384 and 768 as new rows, which a parent without them
does not time; past 2048, at heads of 2056 and 4104, fused-QKV,
quantized-KV, single-sequence paged and dense attention and each batched
kernel alone) of
the checkout unpacked in DIR (the
parent commit, `git archive`) and of this one, each built and timed by its
own chip_smoke.py in a process of its own (parent, this, this, parent);
the runs line carries them as `parent_kernels`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

PEAK_INT8_OPS = 1979e12   # H100 SXM dense int8 tensor-core rate
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12      # H100 SXM HBM3 bytes/s
EX2_PER_SM_CLOCK = 16     # ex2 (MUFU) results a Hopper SM gives a clock
WIDE_FROM = 256           # heads wider run the attention kernels' wide instance
# the clusters of each size (blocks) of the cluster kernels of dense and
# single-sequence paged attention (heads of 264 to 2048,
# csrc/wide_cluster_flash.cuh) the card runs at once, read by the kernels
# phase
CLUSTERS = {}
# the card's SMs and its highest SM clock (Hz), read by the device phase
CARD = {}

failures: list = []


def log(*a):
    print(*a, flush=True)


def phase(fn):
    """Run one phase; record (and print) its failure instead of raising.
    Logs the CUDA graphs the phase captured and replayed."""
    log(f"== {fn.__name__}")
    t0 = time.perf_counter()
    before = _graph_counters()
    try:
        out = fn()
    except Exception:  # a failed phase is reported and fails the run
        traceback.print_exc()
        failures.append(fn.__name__)
        out = None
    moved = _graph_counters(before)
    if moved.get("captures") or moved.get("replays"):
        log(f"  graphs: {moved['captures']:.0f} captured "
            f"({moved['recaptures']:.0f} again) in "
            f"{moved['capture_s']:.3f} s, {moved['replays']:.0f} replays")
    log(f"== {fn.__name__}: {'FAILED' if fn.__name__ in failures else 'ok'} "
        f"in {time.perf_counter() - t0:.1f} s")
    return out


GRAPH_COUNTERS = ("captures", "recaptures", "replays", "capture_s")


def _graph_counters(since=None):
    """The port's `graphs.*` counters (`utils/graphs.py`), or their change
    since `since`; empty where the package does not import."""
    try:
        from diffusion_llm_rs_tpu_torch.utils.metrics import metrics
    except ImportError:
        return {}
    now = {k: metrics.get(f"graphs.{k}") for k in GRAPH_COUNTERS}
    return now if since is None else {k: v - since.get(k, 0.0)
                                      for k, v in now.items()}


def time_ms(fn, iters=20):
    """Device time per call: `iters` calls captured in a CUDA graph and
    replayed between two CUDA events, so host launch overhead is not timed.
    A call that cannot be captured fails the phase."""
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(bytes_moved, ops, peak_ops):
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mufu_floor_ms(logits):
    """The least time the card's MUFU ex2 units take for one exp a logit,
    16 a clock on each SM at its highest SM clock (`nvidia-smi
    clocks.max.sm`). A floor of the port's attention kernels, which take
    every exp there, not of the card: exp2 can also run as a polynomial on
    the FMA pipes. Logged beside a row's `bound_ms`, never in the row."""
    return logits / (CARD["sms"] * EX2_PER_SM_CLOCK * CARD["sm_hz"]) * 1e3


# ------------------------------------------------------------------ phases --

def device():
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: no GPU")
    # "name, power.limit, clocks.max.sm": the first two fields are the line
    # `--query-gpu=name,power.limit` gives
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or smi.stdout.count(",") < 2:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    line, clock = smi.stdout.strip().rsplit(", ", 1)
    log(line)
    CARD.update(sms=torch.cuda.get_device_properties(0).multi_processor_count,
                sm_hz=float(clock.split()[0]) * 1e6)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count "
        f"{torch.cuda.device_count()}; {CARD['sms']} SMs, max SM clock "
        f"{CARD['sm_hz'] / 1e6:.0f} MHz")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain f32 references
    torch.backends.cudnn.allow_tf32 = False
    return line


def build():
    from diffusion_llm_rs_tpu_torch.ops import _build
    t0 = time.perf_counter()
    targets = _build.build()
    log(f"built {sorted(targets)} in {time.perf_counter() - t0:.1f} s")
    for name in sorted(targets):
        report = _build.build_logs.get(name)
        if report is None:
            log(f"  {name}: already built at {targets[name]}")
            continue
        log(f"  {name}.cu built in {_build.build_seconds[name]:.1f} s")
        for ln in report.splitlines():
            if "Compiling entry" in ln or "Used" in ln or "spill" in ln:
                log(f"  {name}: {ln.strip()}")


def _rand_int8(K, N, gen):
    return torch.randint(-127, 128, (K, N), generator=gen, device="cuda",
                         dtype=torch.int8)


def _int_mm_epilogue(xi, sx, w, cs, bias, gelu, residual, out_dtype):
    """Library yardstick: torch._int_mm and the epilogue in torch ops."""
    from diffusion_llm_rs_tpu_torch.ops.int8_matmul import gelu_tanh
    y = torch._int_mm(xi, w).float() * sx * cs
    if bias is not None:
        y = y + bias
    if gelu:
        y = gelu_tanh(y)
    if residual is not None:
        y = y + residual.float()
    return y.to(out_dtype)


def _int_mm_rows(xi, sx):
    """torch._int_mm takes more than 16 rows: fewer are padded with zero
    rows to 32 (the note says so beside the time)."""
    M = xi.shape[0]
    if M > 16:
        return xi, sx, None
    xi = torch.cat([xi, xi.new_zeros((32 - M, xi.shape[1]))])
    sx = torch.cat([sx, sx.new_ones((32 - M, 1))])
    return xi, sx, f"torch._int_mm at M={M} padded to 32 rows"


def _library_times(xi, sx, w_rows, w_cols, cs, bias, gelu, residual):
    """The yardsticks of an int8 GEMM: torch._int_mm with the epilogue in
    torch ops, over the [K, N] weight row-major (library_ms) and over the
    transposed view of its K-major copy, column-major B as cuBLASLt's int8
    kernels take it (library_colmajor_ms), and that product alone
    (library_colmajor_mm_ms). Both layouts are made outside the timed
    window."""
    bf16 = torch.bfloat16
    return dict(
        library_ms=time_ms(lambda: _int_mm_epilogue(
            xi, sx, w_rows, cs, bias, gelu, residual, bf16)),
        library_colmajor_ms=time_ms(lambda: _int_mm_epilogue(
            xi, sx, w_cols, cs, bias, gelu, residual, bf16)),
        library_colmajor_mm_ms=time_ms(lambda: torch._int_mm(xi, w_cols)))


def _library_label(lib):
    return (f"{lib['library_ms']:.4f} (column-major B "
            f"{lib['library_colmajor_ms']:.4f}, its product alone "
            f"{lib['library_colmajor_mm_ms']:.4f})")


def _plan_label(plan):
    side = "tokens on wgmma N" if plan["swap"] else "tokens on wgmma M"
    return f"{side}, tile {plan['tile']}, {plan['splits']} split(s)"


def _compare(out, ref, atol, rtol):
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    ok = bool((err <= atol + rtol * ref.abs()).all()) and \
        bool(torch.isfinite(out).all())
    rel = float((out - ref).norm() / ref.norm().clamp_min(1e-30))
    return float(err.max()), rel, ok


# int8w_matmul's timed shapes: the sampler's linears at M = 2048 (B=8 x
# S=256), the time-MLP's two linears at M = 8 (the second with K split over
# blocks), and serving's qkv and wo (with its residual) at M = 8192
# (serve_paged: B=2 x S=4096)
I8W_CASES = (
    # label, M, K, N, gelu, bias, residual
    ("qkv", 2048, 768, 2304, False, False, False),
    ("wo", 2048, 768, 768, False, False, True),
    ("head", 2048, 768, 768, False, False, False),
    ("time_mlp", 8, 768, 3072, True, True, False),
    ("time_mlp.w2", 8, 3072, 768, False, True, False),
    ("qkv", 8192, 768, 2304, False, False, False),
    ("wo", 8192, 768, 768, False, False, True),
)

# the packed-weight GEMMs' shapes (`_packed_kernels`)
PACKED_CASES = (
    # label, M, K, N, bits, granularity, bias, gelu, dtype, timed
    ("qkv", 2048, 768, 2304, 4, "group", False, False, "bf16", True),
    ("wo/head", 2048, 768, 768, 4, "group", False, False, "bf16", True),
    ("mlp.w1", 2048, 768, 3072, 4, "group", True, True, "bf16", True),
    ("mlp.w2", 2048, 3072, 768, 4, "group", True, False, "bf16", True),
    ("time_mlp.w1", 8, 768, 3072, 4, "group", True, True, "bf16", True),
    ("qkv one sequence", 256, 768, 2304, 4, "group", False, False, "bf16",
     True),
    ("ragged M, f32", 5, 768, 768, 4, "group", True, False, "f32", False),
    ("1-bit", 2048, 768, 768, 1, "group", True, False, "bf16", True),
    ("2-bit", 2048, 768, 768, 2, "group", True, True, "bf16", True),
    ("8-bit", 2048, 768, 768, 8, "group", True, False, "bf16", True),
    ("per-channel", 2048, 768, 2304, 4, "channel", True, False, "bf16",
     True),
)


def kernels():
    from diffusion_llm_rs_tpu_torch.ops import int8_matmul as im
    from diffusion_llm_rs_tpu_torch.ops.attention import (
        dense_attention, dense_attention_plain)

    gen = torch.Generator(device="cuda").manual_seed(1234)
    results = {name: [] for name in KERNELS}
    bad = []
    bf16, f32 = torch.bfloat16, torch.float32

    # int8w_matmul at I8W_CASES, bf16 out. The int32 products are exact on
    # both sides and the epilogue runs the same f32 operations, each rounded
    # on its own: without gelu the kernel must equal its twin bit for bit;
    # with gelu a last-bit difference in tanh may move one bf16 rounding, so
    # one bf16 ulp (2^-7 relative).
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, M, K, N, gelu, bias, resid in I8W_CASES:
        x = torch.randn((M, K), generator=gen, device="cuda").to(bf16)
        w = _rand_int8(K, N, gen)
        cs = torch.rand((1, N), generator=gen, device="cuda") * 2e-4 + 1e-5
        b = torch.randn((N,), generator=gen, device="cuda") * 0.02 if bias else None
        r = (torch.randn((M, N), generator=gen, device="cuda").to(bf16)
             if resid else None)
        act = "gelu" if gelu else None
        out = im.int8w_matmul(x, w, cs, b, act, r, out_dtype=bf16)
        ref = im.int8w_matmul_plain(x, w, cs, b, act, r, out_dtype=bf16)
        if gelu:
            tol = "|d| <= 1e-6 + 2^-7 |ref|"
            err, rel, ok = _compare(out, ref, 1e-6, 2.0 ** -7)
        else:
            tol = "bit for bit"
            err, rel, ok = _compare(out, ref, 0.0, 0.0)
        ms = time_ms(lambda: im.int8w_matmul(x, w, cs, b, act, r, out_dtype=bf16))
        plain_ms = time_ms(
            lambda: im.int8w_matmul_plain(x, w, cs, b, act, r, out_dtype=bf16), 5)
        xi, sx, lib_note = _int_mm_rows(*im.quant_rows_plain(x.float()))
        lib = _library_times(xi, sx, w, im._k_major(w).t(), cs, b, gelu, r)
        nbytes = M * K * 2 + K * N + N * 4 + (N * 4 if bias else 0) \
            + (M * N * 2 if resid else 0) + M * N * 2
        b_ms, b_by = bound(nbytes, 2 * M * K * N, PEAK_INT8_OPS)
        plan = im.gemm_plan(M, N, K, sms)
        results["int8w_matmul"].append(dict(
            shape=f"{label} M={M} K={K} N={N}", max_abs_err=err, rel_err=rel,
            tolerance=tol, ms=ms, plain_ms=plain_ms, **lib,
            library_note=lib_note, bound_ms=b_ms, bound_by=b_by,
            plan=_plan_label(plan)))
        log(f"  int8w_matmul {label}: max_abs_err {err:.3g} rel {rel:.3g} "
            f"({tol}) {'ok' if ok else 'MISMATCH'}; {ms:.4f} ms "
            f"({_plan_label(plan)}), plain {plain_ms:.4f}, library "
            f"{_library_label(lib)}, bound {b_ms:.4f} ({b_by})")
        if not ok:
            bad.append(f"int8w_matmul {label}")

    # int8w_mlp, the fused kernel, at the sampler's rows (M = 2048, B=8 x
    # S=256) and serve_paged's and serve_phase's (M = 8192): relative
    # Frobenius error <= 1e-3 against the plain version -- a last-bit
    # difference in the f32 gelu can move one requantization level of the
    # inner activation -- and bit for bit equal to the chained kernels, which
    # round every step alike
    _mlp_kernels(gen, results, bad)

    # dense_attention at S=1024: the sampler's heads of 64 (BH = 8 x 12), and
    # the same work at heads of 32 and 128, bf16 out, timed; the 2-layer
    # anchor-width training step's f32 out at heads of 32 (phase train_grad).
    # Heads of 16 (`DiffusionConfig.tiny()`, phase heads16): its S=1024
    # sampler's f32 out at B=2 x 4 heads, S=32 at the same BH, and BH=128
    # at S=1024, which fills the card, timed. The widths between and past
    # the instances of 16-128 (`heads_wide`): heads of 48 and 96 at the work
    # of heads of 128 (BH=48), run padded in the instances of 64 and 128,
    # and heads of 256 at BH=24, timed. The wide instance (heads past 256;
    # the cluster kernel up to 2048): heads of 384 and 768 at the work of
    # heads of 128 (BH=16 and 8), timed; heads of 264 (a last block of 8
    # columns), of 520 with f32 out (a cluster of 3), of 2048 with f32 out
    # (a cluster of 8) and of 2056 (blocks of 2 slices); the one head of
    # 2560 of `heads_wide`'s 2-layer model at its sampler's shape (B=2,
    # S=1024), which its sampler phase launches. Past 2048, timed:
    # heads of 2056 at BH=3, the work of the row of 768 (BH=8) within 0.4%,
    # beside the cluster kernel at 2048 on the same work, and heads of 4104
    # (blocks of 3 slices) at BH=3.
    # bf16 P: the kernel's 128-wide KV tiles rescale at other points than the
    # twin's 512-wide ones, so bf16(p) may round differently: |d| <= 1e-2 and
    # rel Frobenius <= 1e-2
    for BH, S, Dh, dtype, timed in (
            (96, 1024, 64, bf16, True), (192, 1024, 32, bf16, True),
            (48, 1024, 128, bf16, True), (16, 1024, 32, f32, False),
            (8, 1024, 16, f32, True), (8, 32, 16, bf16, True),
            (128, 1024, 16, bf16, True), (48, 1024, 48, bf16, True),
            (48, 1024, 96, bf16, True), (24, 1024, 256, bf16, True),
            (16, 1024, 384, bf16, True), (8, 1024, 768, bf16, True),
            (8, 300, 264, bf16, False), (4, 300, 520, f32, False),
            (8, 256, 2048, f32, False), (2, 256, 2056, bf16, False),
            (2, 1024, 2560, bf16, False), (3, 1024, 2056, bf16, True),
            (3, 1024, 2048, bf16, True), (3, 1024, 4104, bf16, True)):
        q, k, v = (torch.randn((BH, S, Dh), generator=gen, device="cuda")
                   .to(bf16) for _ in range(3))
        out = dense_attention(q, k, v, out_dtype=dtype)
        ref = dense_attention_plain(q, k, v, out_dtype=dtype)
        err, rel, ok = _compare(out, ref, 1e-2, 0.0)
        ok = ok and rel <= 1e-2 and out.dtype == dtype
        row = dict(shape=f"BH={BH} S={S} D={Dh} {str(dtype)[6:]} out",
                   max_abs_err=err, rel_err=rel,
                   tolerance="|d| <= 1e-2, rel Frobenius <= 1e-2",
                   wide=Dh > WIDE_FROM)
        if timed:
            row["ms"] = time_ms(lambda: dense_attention(q, k, v,
                                                        out_dtype=dtype))
            row["plain_ms"] = time_ms(lambda: dense_attention_plain(
                q, k, v, out_dtype=dtype), 5)
            nb = 8 if BH % 8 == 0 else 1  # BH=3 past 2048: one batch row
            q4, k4, v4 = (t.view(nb, BH // nb, S, Dh) for t in (q, k, v))
            row["library_ms"] = time_ms(lambda: torch.nn.functional
                                        .scaled_dot_product_attention(q4, k4, v4))
            out_bytes = BH * S * Dh * (2 if dtype == bf16 else 4)
            row["bound_ms"], row["bound_by"] = bound(
                BH * (S * Dh * 2 * 3) + out_bytes, 4 * BH * S * S * Dh,
                PEAK_BF16_FLOPS)
            mufu = mufu_floor_ms(BH * S * S)
        results["dense_attention"].append(row)
        log(f"  dense_attention {row['shape']}: max_abs_err {err:.3g} rel "
            f"{rel:.3g} {'ok' if ok else 'MISMATCH'}"
            + (f"; {row['ms']:.4f} ms, plain {row['plain_ms']:.4f}, library "
               f"{row['library_ms']:.4f}, bound {row['bound_ms']:.4f} "
               f"({row['bound_by']}); MUFU ex2 floor {mufu:.4f}"
               if timed else ""))
        if not ok:
            bad.append(f"dense_attention {row['shape']}")
    _cluster_occupancy(bad)
    _paged_kernels(gen, results, bad)
    _quant_attention_kernels(gen, results, bad)
    _packed_kernels(gen, results, bad)
    _fused_qkv_kernels(gen, results, bad)
    # the library yardsticks leave a cuBLAS workspace behind for every side
    # stream they were captured on: return them, or they count in the peak
    # memory of every later phase (a private call: skipped where torch lacks it)
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    torch.cuda.empty_cache()
    log(f"  memory held after the kernel phase: "
        f"{torch.cuda.memory_allocated() / 2**20:.1f} MiB")
    if bad:
        raise AssertionError(f"kernels disagree with their twins: {bad}")
    return results


def _cluster_occupancy(bad):
    """The clusters of the dense cluster kernel (csrc/wide_cluster_flash.cuh,
    one block an SM) the card runs at once, at every cluster size from 2
    to 8 blocks (heads of 264 to 2048), and those of its k-slice kernel
    past 2048 (logged, not kept in CLUSTERS); 0 would refuse the launch."""
    from diffusion_llm_rs_tpu_torch.ops import _build
    from diffusion_llm_rs_tpu_torch.ops.attention import cluster_plan
    fn = _build.function("dlm_dense_attention_cluster_active")
    for D in (264, 520, 776, 1032, 1288, 1544, 1800, 2048, 2056, 4104,
              10240):
        C, k = cluster_plan(D)
        n = fn(D)
        if k == 1:
            CLUSTERS[C] = n
        log(f"  dense cluster kernel at heads of {D}: clusters of {C} "
            f"blocks of {k} slice(s), {n} at once ({n * C} of "
            f"{CARD['sms']} SMs)")
        if n <= 0:
            bad.append(f"clusters of {C} blocks of {k} slice(s)")


def _mlp_kernels(gen, results, bad):
    """int8w_mlp at 768 -> 3072 -> 768 with both biases and a residual, bf16
    out, at M = 2048 and 8192: the fused kernel, the chained kernels (its
    reference, bit for bit), torch._int_mm twice with the epilogues in torch
    ops (library_ms) and the bound. Also how many clusters of the fused
    kernel the card runs at once (its waves)."""
    from diffusion_llm_rs_tpu_torch.ops import int8_matmul as im

    bf16, f32 = torch.bfloat16, torch.float32
    D, F = 768, 3072
    if not im.mlp_fits(D, F):
        raise AssertionError(f"the fused MLP kernel does not take {D} -> {F}")
    clusters = im._active_clusters(D, D)
    log(f"  int8w_mlp: clusters the card runs at once, by size: {clusters}")
    w1, w2 = _rand_int8(D, F, gen), _rand_int8(F, D, gen)
    cs1 = torch.rand((1, F), generator=gen, device="cuda") * 2e-4 + 1e-5
    cs2 = torch.rand((1, D), generator=gen, device="cuda") * 2e-4 + 1e-5
    b1 = torch.randn((F,), generator=gen, device="cuda") * 0.02
    b2 = torch.randn((D,), generator=gen, device="cuda") * 0.02
    for M in (2048, 8192):
        x = torch.randn((M, D), generator=gen, device="cuda").to(bf16)
        r = torch.randn((M, D), generator=gen, device="cuda").to(bf16)
        args = (x, w1, cs1, b1, w2, cs2, b2, r, bf16)
        out = im.int8w_mlp(*args)
        ref = im.int8w_mlp_plain(*args)
        chained = im.int8w_mlp_chained(*args)
        err, rel, _ = _compare(out, ref, 0.0, 0.0)
        same = bool(torch.equal(out, chained))
        ok = rel <= 1e-3 and same and bool(torch.isfinite(out.float()).all())
        ms = time_ms(lambda: im.int8w_mlp(*args))
        chained_ms = time_ms(lambda: im.int8w_mlp_chained(*args))
        plain_ms = time_ms(lambda: im.int8w_mlp_plain(*args), 5)

        def lib_mlp():
            xi, sx = im.quant_rows_plain(x.float())
            y1 = _int_mm_epilogue(xi, sx, w1, cs1, b1, True, None, f32)
            yi, sy = im.quant_rows_plain(y1)
            return _int_mm_epilogue(yi, sy, w2, cs2, b2, False, r, bf16)
        lib_ms = time_ms(lib_mlp)
        nbytes = M * D * 2 + D * F + F * D + (F + D) * 8 + M * D * 2 * 2
        b_ms, b_by = bound(nbytes, 2 * M * D * F * 2, PEAK_INT8_OPS)
        cluster = im.mlp_plan(M, D, F, D, clusters)["cluster"]
        results["int8w_mlp"].append(dict(
            shape=f"mlp M={M} D={D} F={F} +residual", max_abs_err=err,
            rel_err=rel, equal_to_chained=same,
            tolerance="rel Frobenius <= 1e-3; bit for bit the chained kernels",
            ms=ms, chained_ms=chained_ms, plain_ms=plain_ms, library_ms=lib_ms,
            bound_ms=b_ms, bound_by=b_by, cluster=cluster,
            active_clusters=clusters))
        log(f"  int8w_mlp (fused, clusters of {cluster}) M={M}: max_abs_err "
            f"{err:.3g} rel {rel:.3g}, "
            f"chained {'bit for bit' if same else 'DIFFERENT'} "
            f"{'ok' if ok else 'MISMATCH'}; {ms:.4f} ms, chained "
            f"{chained_ms:.4f}, plain {plain_ms:.4f}, library {lib_ms:.4f}, "
            f"bound {b_ms:.4f} ({b_by})")
        if not ok:
            bad.append(f"int8w_mlp M={M}")


# fused_qkv_attention's shapes at width 768, B=8: the sampler's S=256 and
# the largest S JAX's predicate admits at that width (864), at the model's
# 12 heads of 64 and at 4 of 192 and 3 of 256 (the wgmma design's widest
# instances), 2 of 384 and one of 768 (the cluster kernel)
QKV_HEADS = (12, 4, 3, 2, 1)
# past 2048: one head of 2056 at B=8, S=256 (JAX's predicate admits it; a
# head of 2056 at width 768 does not exist, so its work is 2.7x the row of
# 768 at S=256), blocks of 2 slices of 256 columns, beside the cluster
# kernel at 2048 (a slice a block) on the same work; and one head of 4104
# (blocks of 3 slices) at B=8, S=240, the longest row JAX's 8 MiB admits
QKV_PAST = ((8, 256, 2056, 1), (8, 256, 2048, 1), (8, 240, 4104, 1))


def _fused_qkv_kernels(gen, results, bad):
    """fused_qkv_attention at QKV_HEADS x S = 256 and 864, and QKV_PAST,
    bf16 out, against the plain version: relative Frobenius error <= 5e-3
    (the kernel's sums and CUDA's expf can move a bf16 rounding of P, and
    then of the output). Yardsticks: split + SDPA (library_ms), and the
    einsum attention of `denoiser.attention` (einsum_ms). The cluster
    kernel's rows (heads of 264 to 2048) log its clusters and the clusters
    of their size the card runs at once."""
    from diffusion_llm_rs_tpu_torch.models.denoiser import attention as einsum
    from diffusion_llm_rs_tpu_torch.ops import _build
    from diffusion_llm_rs_tpu_torch.ops import attention as at

    bf16 = torch.bfloat16
    shapes = [(8, S, 768, H) for H in QKV_HEADS for S in (256, 864)]
    for B, S, D, H in shapes + list(QKV_PAST):
        if not at.fused_qkv_fits((B, S, 3 * D), H) or (
                S > 256 and at.fused_qkv_fits((B, S + 8, 3 * D), H)):
            raise AssertionError(f"JAX's predicate: S={S} at D={D}")
        Hd = D // H
        cluster = {}
        if at.fused_qkv_instance(Hd) == "_cluster":
            cluster = dict(
                clusters=-(-S // 128) * B * H,
                blocks=at.cluster_plan(Hd)[0],
                slices_a_block=at.cluster_plan(Hd)[1],
                clusters_at_once=_build.function(
                    "dlm_fused_qkv_attention_cluster_active")(Hd))
        qkv = torch.randn((B, S, 3 * D), generator=gen, device="cuda").to(bf16)
        out = at.fused_qkv_attention(qkv, H)
        ref = at.fused_qkv_attention_plain(qkv, H)
        err, rel, _ = _compare(out, ref, 0.0, 0.0)
        ok = rel <= 5e-3 and bool(torch.isfinite(out.float()).all())
        ms = time_ms(lambda: at.fused_qkv_attention(qkv, H))
        plain_ms = time_ms(lambda: at.fused_qkv_attention_plain(qkv, H), 5)

        def heads(i):
            return qkv[..., i * D:(i + 1) * D].reshape(B, S, H, Hd)

        def sdpa():
            q, k, v = (heads(i).transpose(1, 2) for i in range(3))
            o = torch.nn.functional.scaled_dot_product_attention(q, k, v)
            return o.transpose(1, 2).reshape(B, S, D)
        lib_ms = time_ms(sdpa)
        einsum_ms = time_ms(lambda: einsum(heads(0), heads(1), heads(2)))
        nbytes = B * S * 3 * D * 2 + B * S * D * 2
        b_ms, b_by = bound(nbytes, 4 * B * H * S * S * Hd, PEAK_BF16_FLOPS)
        results["fused_qkv_attention"].append(dict(
            shape=f"B={B} S={S} D={D} H={H}", max_abs_err=err, rel_err=rel,
            tolerance="rel Frobenius <= 5e-3", ms=ms, plain_ms=plain_ms,
            library_ms=lib_ms, einsum_ms=einsum_ms, bound_ms=b_ms,
            bound_by=b_by, wide=Hd > WIDE_FROM, **cluster))
        log(f"  fused_qkv_attention B={B} S={S} D={D} H={H}: max_abs_err "
            f"{err:.3g} rel {rel:.3g} {'ok' if ok else 'MISMATCH'}; {ms:.4f} "
            f"ms, plain {plain_ms:.4f}, SDPA {lib_ms:.4f}, einsum "
            f"{einsum_ms:.4f}, bound {b_ms:.4f} ({b_by})"
            + (f"; {cluster['clusters']} clusters of {cluster['blocks']} "
               f"blocks of {cluster['slices_a_block']} slice(s), "
               f"{cluster['clusters_at_once']} at once" if cluster else ""))
        if not ok or cluster.get("clusters_at_once", 1) <= 0:
            bad.append(f"fused_qkv_attention S={S} D={D} H={H}")


def _quantized_pools(gen, n_slots, H, P, D, G, bits):
    """Pools in the JAX layout, from N(0, 1) keys and values quantized on
    the card by the port's quantize_page, heads grouped G to a row."""
    from diffusion_llm_rs_tpu_torch.cache.paged import quantize_page
    HG, Pp = H // G, P // (8 // bits)
    out = []
    for _ in range(2):
        x = torch.randn((n_slots * H, P, D), generator=gen, device="cuda")
        d, sc, zp = quantize_page(x, bits)
        d = (d.reshape(n_slots, HG, G, Pp, D).permute(0, 1, 3, 2, 4)
             .reshape(n_slots, HG, Pp, G * D).contiguous())
        out += [d, sc.reshape(n_slots, HG, G * P), zp.reshape(n_slots, HG, G * P)]
    return tuple(out)


def _dequant_sdpa(q, pt, pools, bits, G):
    """Library yardstick: every slot's pages (all full) dequantized to bf16,
    then scaled_dot_product_attention. q [B, H, Sq, D], pt [B, n]."""
    from diffusion_llm_rs_tpu_torch.ops.paged_attention import unpack_levels
    B, H, _, D = q.shape
    n = pt.shape[1]
    idx = pt.reshape(-1).long()

    def deq(data, sc, zp):
        HG, P = data.shape[1], sc.shape[2] // G
        lv = unpack_levels(data.index_select(0, idx), bits).float()
        lv = (lv.reshape(B, n, HG, P, G, D).permute(0, 2, 4, 1, 3, 5)
              .reshape(B, H, n * P, D))

        def side(a):
            return (a.index_select(0, idx).reshape(B, n, HG, G, P)
                    .permute(0, 2, 3, 1, 4).reshape(B, H, n * P, 1))
        return ((lv - side(zp)) * side(sc)).to(torch.bfloat16)

    kd, ks, kz, vd, vs, vz = pools
    return torch.nn.functional.scaled_dot_product_attention(
        q.to(torch.bfloat16), deq(kd, ks, kz), deq(vd, vs, vz))


def _paged_bound(B, H, Sq, D, P, bits, pages, tokens, peak=PEAK_BF16_FLOPS):
    """Bytes: the packed K/V and the four f32 sidecars of the pages read, q
    (bf16), out and lse (f32); operations: 4 per (query, key, channel) over
    the valid keys of each slot, at the bf16 rate or, for the int8 path, the
    int8 rate."""
    nbytes = (pages * (2 * H * (P // (8 // bits)) * D + 4 * H * P * 4)
              + B * H * Sq * D * (2 + 4) + B * H * Sq * 4)
    return bound(nbytes, 4 * H * Sq * D * tokens, peak)


def _paged_compare(out, lse, ref, ref_lse):
    """Relative Frobenius error of the output (<= 1e-2) and the largest lse
    difference (<= 1e-3): sums in another order, CUDA's expf."""
    rel = float((out - ref).norm() / ref.norm())
    lse_err = float((lse - ref_lse).abs().max())
    err = float((out - ref).abs().max())
    ok = rel <= 1e-2 and lse_err <= 1e-3 and bool(torch.isfinite(out).all())
    return err, rel, lse_err, ok


def _unpack_case(pa, label, shape, args, npages, bits, G, timed, results,
                 bad):
    """paged_unpack, in the bf16 and (bits > 1) the int8 layout, bit for bit
    against its plain twin on every live page; timed where `timed`. Bound:
    the live pages' packed K/V bytes and sidecars read, the scratch's live
    pages written."""
    q, pt, _, npg = args[:4]
    pools = args[4:]
    H, D = q.shape[1], q.shape[3]
    P = pools[0].shape[2] * (8 // bits)
    PT = pa.tile_tokens(P)
    live = sum(npages)
    for a8 in (False, True) if bits > 1 else (False,):
        got = pa.paged_unpack(pt, npg, *pools, bits=bits, head_group=G, a8=a8)
        want = pa.paged_unpack_plain(pt, npg, *pools, bits=bits, head_group=G,
                                     a8=a8)
        err = max(float((x[b, :, :k].float() - y[b, :, :k].float()).abs()
                        .max()) for x, y in zip(got, want)
                  for b, k in enumerate(npages) if k)
        same = all(torch.equal(x[b, :, :k], y[b, :, :k])
                   for x, y in zip(got, want) for b, k in enumerate(npages))
        mode = "int8" if a8 else "bf16"
        scratch = sum(t.numel() * t.element_size() for t in got)
        urow = dict(shape=f"{shape} {mode} layout", max_abs_err=err,
                    tolerance="bit for bit on every live page",
                    scratch_bytes=scratch, wide=D > WIDE_FROM)
        if timed:
            urow["ms"] = time_ms(lambda: pa.paged_unpack(
                pt, npg, *pools, bits=bits, head_group=G, a8=a8))
            urow["plain_ms"] = time_ms(lambda: pa.paged_unpack_plain(
                pt, npg, *pools, bits=bits, head_group=G, a8=a8), 3)
            urow["library_ms"] = None
            side = 4 if a8 else 3
            nbytes = live * H * (2 * (P // (8 // bits)) * D + 4 * P * 4) + \
                live * H * PT * (2 * D * (1 if a8 else 2) + side * 4)
            urow["bound_ms"], urow["bound_by"] = bound(nbytes, 0,
                                                       PEAK_BF16_FLOPS)
        results["paged_unpack"].append(urow)
        log(f"  paged_unpack {label} ({mode}): "
            f"{'bit for bit' if same else f'MISMATCH {err:.3g}'}; scratch "
            f"{scratch / 2**20:.2f} MiB"
            + (f"; {urow['ms']:.4f} ms, plain {urow['plain_ms']:.4f}, bound "
               f"{urow['bound_ms']:.4f} ({urow['bound_by']})" if timed else ""))
        if not same:
            bad.append(f"paged_unpack {label} {mode}")


def _paged_kernels(gen, results, bad):
    from diffusion_llm_rs_tpu_torch.cache.paged import quantize_page
    from diffusion_llm_rs_tpu_torch.ops import _build
    from diffusion_llm_rs_tpu_torch.ops import paged_attention as pa
    from diffusion_llm_rs_tpu_torch.ops.attention import cluster_plan

    tol = "rel Frobenius <= 1e-2, |lse| <= 1e-3"
    # quantize_page on the card equals the CPU bit for bit (true division
    # by a 0-d tensor, ROADMAP C2)
    for bits in (1, 2, 4, 8):
        x = torch.randn((24, 128, 64), generator=gen, device="cuda") * \
            torch.rand((24, 128, 1), generator=gen, device="cuda") * 10
        dev, cpu = quantize_page(x, bits), quantize_page(x.cpu(), bits)
        same = all(torch.equal(a.cpu(), b) for a, b in zip(dev, cpu))
        log(f"  quantize_page {bits}-bit card vs CPU: "
            f"{'bit for bit' if same else 'MISMATCH'}")
        if not same:
            bad.append(f"quantize_page {bits}-bit")

    # batched_paged_attention at one layer of serve_paged (B=2, Sq=4096,
    # pages of 128) and of serve_phase (B=4, Sq=2048, pages of 64); H=12,
    # G=2, 32 pages per slot. A case is (label, bits, B, Sq, P, n_pages per
    # slot, tokens of each slot's last page): a slot of 0 pages is empty; a
    # slot of fewer than 32 reads the front of its table, as a bucket's
    # compacted table in serving does. The full-table cases are timed.
    # Then the pools `_choose_head_group` builds for other head widths: the
    # shipped anchor's 8 heads of 32 in groups of 4 (rows of 128) at pages of
    # 32 (its `sample(attend_mode="paged")`) and of 8, and heads of 128 at
    # pages of 72.
    n = 32
    full = ([n, n], [128, 128])
    ragged = ([n, 0], [37, 128])
    phase = ([n, 19, 0, 7], [37, 5, 64, 64])
    g64 = (12, 2, 64)  # H, G, D
    cases = [("serve_paged shape 4-bit", 4, 2, 4096, 128, full, True, g64),
             ("serve_paged partial page + empty slot", 4, 2, 4096, 128, ragged,
              False, g64),
             ("8-bit", 8, 2, 1024, 128, full, False, g64),
             ("2-bit", 2, 2, 1024, 128, full, False, g64),
             ("1-bit", 1, 2, 1024, 128, full, False, g64),
             ("serve_phase shape 4-bit", 4, 4, 2048, 64, ([n] * 4, [64] * 4),
              True, g64)]
    cases += [(f"serve_phase compacted {bits}-bit, partial pages + empty "
               f"slot", bits, 4, 2048, 64, phase, False, g64)
              for bits in (8, 4, 2)]
    cases += [(f"anchor pages of 32 {bits}-bit", bits, 4, 32, 32,
               ([1] * 4, [32, 32, 20, 32]), False, (8, 4, 32))
              for bits in (8, 4, 2, 1)]
    cases += [("anchor pages of 8 2-bit, partial page + empty slot", 2, 2, 64,
               8, ([8, 0], [3, 8]), False, (8, 4, 32)),
              ("heads of 128, pages of 72, 4-bit", 4, 2, 300, 72,
               ([5, 2], [40, 72]), False, (4, 1, 128))]
    # the serving example's model (`DiffusionConfig.tiny()`: 4 heads of 16,
    # G = 1): 2 slots of S = 16 in pages of 8
    cases += [(f"serving example, heads of 16, {bits}-bit", bits, 2, 16, 8,
               ([2, 2], [8, 8]), bits == 4, (4, 1, 16)) for bits in (8, 4, 2)]
    # the serving shape of `heads_wide` (B=2, Sq=2048, 16 pages of 128 a
    # slot, 4-bit): heads of 96 and of 128 (8 heads, the same instance),
    # heads of 256 (its 3 heads), and the 16 heads of 48 of width 768 in
    # groups of 8 (rows of 384 lanes, where JAX's kernel runs), timed
    # and past 256, the wide instance: the 2 heads of 384 and the head of
    # 768 of width 768, timed; heads of 264 (a ragged column block), partial
    # pages of 72 and an empty slot
    cases += [(f"heads of {D} in groups of {G}, S=2048 4-bit", 4, 2, 2048,
               128, ([16, 16], [128, 128]), True, (H, G, D))
              for H, G, D in ((16, 8, 48), (8, 1, 96), (8, 1, 128),
                              (3, 1, 256), (2, 1, 384), (1, 1, 768))]
    cases += [("heads of 264, pages of 72, partial page + empty slot", 4, 2,
               300, 72, ([5, 0], [40, 72]), False, (2, 1, 264))]
    # the cluster kernels' edges: a cluster of 8 (2048) in pages of 32, and
    # past them 2056 (blocks of 2 slices)
    cases += [(f"heads of {D}, pages of 32, partial page + empty slot", 4, 2,
               100, 32, ([3, 0], [20, 32]), False, (1, 1, D))
              for D in (2048, 2056)]
    # past 2048, timed: one head of 2056 over 6 pages of 128 a slot (one
    # head cannot shrink, so the pages do: 6 x 2056 is the 16 x 768 of the
    # row of 768 within 0.4%), beside the cluster kernel at 2048 on the same
    # work, and one head of 4104 (blocks of 3 slices) over the same pages
    cases += [(f"heads of {D}, S=2048 4-bit, 6 pages a slot", 4, 2, 2048, 128,
               ([6, 6], [128, 128]), True, (1, 1, D))
              for D in (2056, 2048, 4104)]
    # the one head of 2560 of `heads_wide`'s 2-layer model at its paged
    # batcher's shape (B=2, Sq=2048, 16 pages of 128 a slot), which its
    # bf16 and int8 serving phases launch
    cases += [("heads of 2560, S=2048 4-bit, 16 pages a slot", 4, 2, 2048,
               128, ([16, 16], [128, 128]), False, (1, 1, 2560))]
    for label, bits, B, sq, P, (npages, last), timed, (H, G, D) in cases:
        pools = _quantized_pools(gen, B * n, H, P, D, G, bits)
        q = torch.randn((B, H, sq, D), generator=gen, device="cuda").to(
            torch.bfloat16)
        pt = torch.randperm(B * n, generator=gen, device="cuda").reshape(
            B, n).to(torch.int32)
        nt = torch.full((B, n), P, dtype=torch.int32, device="cuda")
        for slot, (k, tok) in enumerate(zip(npages, last)):
            if k:
                nt[slot, k - 1] = tok
        npg = torch.tensor(npages, dtype=torch.int32, device="cuda")
        args = (q, pt, nt, npg) + pools
        out, lse = pa.batched_paged_attention(*args, bits=bits, return_lse=True,
                                              head_group=G)
        ref, ref_lse = pa.batched_paged_attention_plain(
            *args, bits=bits, return_lse=True, head_group=G)
        err, rel, lse_err, ok = _paged_compare(out, lse, ref, ref_lse)
        for slot in (i for i, k in enumerate(npages) if k == 0):
            ok = ok and bool((out[slot] == 0).all()) and \
                bool((lse[slot] == pa.NEG_INF).all())
        row = dict(shape=f"{label}: B={B} H={H} D={D} G={G} Sq={sq} P={P} "
                   f"pages={npages}", max_abs_err=err, rel_err=rel,
                   lse_err=lse_err, tolerance=tol, wide=D > WIDE_FROM)
        if cluster_plan(D)[0]:  # the clusters of its instance at once
            row["clusters_at_once"] = _build.function(
                "dlm_batched_paged_attention_cluster_active")(D, P, 0)
        # the pages read and the keys attended (timed cases: whole pages,
        # as many a slot)
        n_live = sum(npages)
        keys = sum((k - 1) * P + tok for k, tok in zip(npages, last) if k)
        if timed:
            row["ms"] = time_ms(lambda: pa.batched_paged_attention(
                *args, bits=bits, head_group=G))
            row["plain_ms"] = time_ms(lambda: pa.batched_paged_attention_plain(
                *args, bits=bits, head_group=G), 3)
            row["library_ms"] = time_ms(lambda: _dequant_sdpa(
                q, pt[:, :npages[0]], pools, bits, G))
            row["bound_ms"], row["bound_by"] = _paged_bound(
                B, H, sq, D, P, bits, n_live, keys)
        results["batched_paged_attention"].append(row)
        log(f"  batched_paged_attention {label}: rel {rel:.3g} lse "
            f"{lse_err:.3g} {'ok' if ok else 'MISMATCH'}"
            + (f"; {row['ms']:.4f} ms, plain {row['plain_ms']:.4f}, library "
               f"{row['library_ms']:.4f}, bound {row['bound_ms']:.4f} "
               f"({row['bound_by']}); MUFU ex2 floor "
               f"{mufu_floor_ms(H * sq * keys):.4f}" if "ms" in row else "")
            + (f"; clusters of {cluster_plan(D)[0]}, "
               f"{row['clusters_at_once']} at once"
               if "clusters_at_once" in row else ""))
        if not ok or row.get("clusters_at_once", 1) <= 0:
            bad.append(f"batched_paged_attention {label}")
        _unpack_case(pa, label, row["shape"], args, npages, bits, G, timed,
                     results, bad)
        if bits == 1:  # 1-bit pages keep the bf16 kernel under act_bits=8
            continue
        # the int8 path on the same pools and tables. Both integer dots are
        # exact, so against its plain version only expf's last bit moves an
        # int8 level of the folded weights now and then: rel Frobenius <=
        # 5e-3, |lse| <= 1e-3. Against the bf16 kernel: the JAX package's
        # own a8-vs-exact bounds, 3.5e-2 and 2e-2 on the lse.
        out8, lse8 = pa.batched_paged_attention(
            *args, bits=bits, return_lse=True, head_group=G, act_bits=8)
        ref8, ref_lse8 = pa.batched_paged_attention_a8_plain(
            *args, bits=bits, return_lse=True, head_group=G)
        live = [i for i, k in enumerate(npages) if k]
        rel8 = float((out8 - ref8).norm() / ref8.norm())
        lse_err8 = float((lse8 - ref_lse8).abs().max())
        rel16 = float((out8 - out).norm() / out.norm())
        lse16 = float((lse8[live] - lse[live]).abs().max())
        ok8 = (rel8 <= 5e-3 and lse_err8 <= 1e-3 and rel16 <= 3.5e-2
               and lse16 <= 2e-2 and bool(torch.isfinite(out8).all()))
        for slot in (i for i, k in enumerate(npages) if k == 0):
            ok8 = ok8 and bool((out8[slot] == 0).all()) and \
                bool((lse8[slot] == pa.NEG_INF).all())
        row8 = dict(shape=row["shape"], max_abs_err=float(
            (out8 - ref8).abs().max()), rel_err=rel8, lse_err=lse_err8,
            rel_to_bf16_kernel=rel16, lse_to_bf16_kernel=lse16,
            tolerance="rel Frobenius <= 5e-3, |lse| <= 1e-3; of the bf16 "
            "kernel <= 3.5e-2, |lse| <= 2e-2", wide=D > WIDE_FROM)
        if cluster_plan(D)[0]:  # past 2048 too: blocks of k slices
            row8["clusters_at_once"] = _build.function(
                "dlm_batched_paged_attention_cluster_active")(D, P, 1)
        if timed:
            row8["ms"] = time_ms(lambda: pa.batched_paged_attention(
                *args, bits=bits, head_group=G, act_bits=8))
            row8["plain_ms"] = time_ms(
                lambda: pa.batched_paged_attention_a8_plain(
                    *args, bits=bits, head_group=G), 3)
            row8["library_ms"] = row["library_ms"]
            row8["bound_ms"], row8["bound_by"] = _paged_bound(
                B, H, sq, D, P, bits, n_live, keys, PEAK_INT8_OPS)
        results["batched_paged_attention_a8"].append(row8)
        log(f"  batched_paged_attention_a8 {label}: rel {rel8:.3g} lse "
            f"{lse_err8:.3g}; of the bf16 kernel rel {rel16:.3g} lse "
            f"{lse16:.3g} {'ok' if ok8 else 'MISMATCH'}"
            + (f"; {row8['ms']:.4f} ms, plain {row8['plain_ms']:.4f}, library "
               f"{row8['library_ms']:.4f}, bound {row8['bound_ms']:.4f} "
               f"({row8['bound_by']}); MUFU ex2 floor "
               f"{mufu_floor_ms(H * sq * keys):.4f}" if "ms" in row8 else "")
            + (f"; clusters of {cluster_plan(D)[0]}, "
               f"{row8['clusters_at_once']} at once"
               if "clusters_at_once" in row8 else ""))
        if not ok8 or row8.get("clusters_at_once", 1) <= 0:
            bad.append(f"batched_paged_attention_a8 {label}")

    # paged_attention (one sequence): PAGED_CASES, each timed with full
    # pages and checked with a partial last page
    for case in PAGED_CASES:
        BH, Sq1, n1, bits, P, D = case
        pools = _quantized_pools(gen, 2 * n1, BH, P, D, 1, bits)
        q = torch.randn((BH, Sq1, D), generator=gen, device="cuda").to(
            torch.bfloat16)
        pt = torch.randperm(2 * n1, generator=gen, device="cuda")[:n1].to(
            torch.int32)
        for label, last in (("full pages", P),
                            ("partial last page", min(50, P - 3))):
            nt = torch.full((n1,), P, dtype=torch.int32, device="cuda")
            nt[-1] = last
            args = (q, pt) + pools
            out, lse = pa.paged_attention(*args, bits=bits, page_tokens=nt,
                                          return_lse=True)
            ref, ref_lse = pa.paged_attention_plain(
                *args, bits=bits, page_tokens=nt, return_lse=True)
            err, rel, lse_err, ok = _paged_compare(out, lse, ref, ref_lse)
            row = dict(shape=_paged_label(label, *case), max_abs_err=err,
                       rel_err=rel, lse_err=lse_err, tolerance=tol,
                       wide=D > WIDE_FROM)
            if cluster_plan(D)[0]:  # the chain's splits over clusters
                row["blocks"], row["slices_a_block"] = cluster_plan(D)
                row["splits"] = _build.function(
                    "dlm_paged_attention_cluster_splits")(BH, Sq1, D, n1, P)
            if last == P:
                row["ms"] = time_ms(lambda: pa.paged_attention(
                    *args, bits=bits, page_tokens=nt))
                row["plain_ms"] = time_ms(lambda: pa.paged_attention_plain(
                    *args, bits=bits, page_tokens=nt), 5)
                row["library_ms"] = time_ms(lambda: _dequant_sdpa(
                    q[None], pt[None], pools, bits, 1))
                row["bound_ms"], row["bound_by"] = _paged_bound(
                    1, BH, Sq1, D, P, bits, n1, n1 * P)
                mufu = mufu_floor_ms(BH * Sq1 * n1 * P)
            results["paged_attention"].append(row)
            log(f"  paged_attention {row['shape']}: rel {rel:.3g} lse "
                f"{lse_err:.3g} {'ok' if ok else 'MISMATCH'}"
                + (f"; {row['splits']} split(s)" if "splits" in row else "")
                + (f"; {row['ms']:.4f} ms, plain {row['plain_ms']:.4f}, "
                   f"library {row['library_ms']:.4f}, bound "
                   f"{row['bound_ms']:.4f} ({row['bound_by']}); MUFU ex2 "
                   f"floor {mufu:.4f}" if "ms" in row else ""))
            if not ok:
                bad.append(f"paged_attention {row['shape']}")


# the single-sequence paged_attention's shapes (BH, Sq, pages, bits, P, D):
# one layer of `PagedKVCache.attend` at the sampler's widths (timed first:
# the kernels line's times); `DiffusionConfig.tiny()`'s 2 layers x 4 heads
# of 16, Sq=64 over 8 pages of 8 (phase heads16's `cache_attend`, there at
# three widths); heads of 16 at Sq=1024 over 8 pages of 128; and the
# widths of `heads_wide`: heads of 48 at the sampler's work (BH=12),
# heads of 96 beside heads of 128 at BH=6, heads of 256 at BH=3, and the
# wide instance's heads of 384 and 768 at the work of heads of 128 (BH=2
# and 1); heads of 264 at 1 bit in pages of 64 (rows of 33 bytes, 8-byte
# reads, a last block of 8 columns), of 2048 at 2 bits in pages of 32 (a
# cluster of 8) and of 2056 (blocks of 2 slices); past 2048, timed: heads
# of 2056 over 3 pages (BH cannot go below 1, so the keys shrink: 3 x 128 x
# 2056 is the 8 x 128 x 768 of the row of 768 within 0.4%), beside the
# cluster kernel at 2048 on the same work, and heads of 4104 (blocks of 3
# slices) over the same pages
PAGED_CASES = ((12, 1024, 8, 4, 128, 64), (8, 64, 8, 4, 8, 16),
               (4, 1024, 8, 4, 128, 16), (12, 1024, 8, 4, 128, 48),
               (6, 1024, 8, 4, 128, 96), (6, 1024, 8, 4, 128, 128),
               (3, 1024, 8, 4, 128, 256), (2, 1024, 8, 4, 128, 384),
               (1, 1024, 8, 4, 128, 768), (3, 200, 4, 1, 64, 264),
               (1, 200, 4, 2, 32, 2048), (1, 200, 4, 4, 64, 2056),
               (1, 1024, 3, 4, 128, 2056), (1, 1024, 3, 4, 128, 2048),
               (1, 1024, 3, 4, 128, 4104))


def _paged_label(label, BH, Sq, n, bits, P, D):
    return f"{label}: BH={BH} Sq={Sq} D={D} P={P} pages={n} {bits}-bit"


# quantized-KV attention's shapes: (label, BH, Sq, Skv, bits, timed, D)
QA_CASES = (
    ("scan_sampler shape 4-bit", 96, 256, 256, 4, True, 64),
    ("8-bit", 96, 256, 256, 8, True, 64),
    ("2-bit", 96, 256, 256, 2, True, 64),
    ("S=1024 4-bit", 24, 1024, 1024, 4, True, 64),
    ("ragged 4-bit", 96, 100, 100, 4, False, 64),
    ("ragged 1-bit", 16, 100, 100, 1, False, 64),
    # the anchor's `sample(seq_len=10)`: B=4 x 8 heads of 32
    ("anchor seq_len=10, 8-bit", 32, 10, 10, 8, False, 32),
    ("heads of 32, 1-bit", 32, 100, 100, 1, False, 32),
    ("heads of 128, 4-bit", 48, 256, 256, 4, True, 128),
    # `DiffusionConfig.tiny()`'s 4 heads of 16 (phase heads16):
    # `sample(seq_len=10)` at B=1, `sample(seq_len=32, use_paged=False)` at
    # B=2, then BH=128 at S=1024, which fills the card; every bit width
    ("tiny seq_len=10, heads of 16, 8-bit", 4, 10, 10, 8, True, 16),
    ("tiny seq_len=32, heads of 16, 4-bit", 8, 32, 32, 4, True, 16),
    ("heads of 16, S=1024 4-bit", 128, 1024, 1024, 4, True, 16),
    ("heads of 16, 2-bit", 8, 32, 32, 2, False, 16),
    ("heads of 16, ragged 1-bit", 8, 100, 100, 1, False, 16),
    # the widths of `heads_wide`: heads of 48 and 96 at the work of heads of
    # 128 above (BH=48), run padded in the instances of 64 and 128; heads of
    # 256 at its model's scan-sampler shape (B=8 x 3 heads); ragged and the
    # other bit widths untimed
    ("heads of 48, 4-bit", 48, 256, 256, 4, True, 48),
    ("heads of 96, 4-bit", 48, 256, 256, 4, True, 96),
    ("heads of 256, 4-bit", 24, 256, 256, 4, True, 256),
    ("heads of 96, ragged 1-bit", 16, 100, 100, 1, False, 96),
    ("heads of 96, 8-bit", 64, 256, 256, 8, False, 96),
    ("heads of 256, ragged 2-bit", 6, 100, 100, 2, False, 256),
    # the wide instance: heads of 384 and 768 at the work of heads of 128
    # above (BH=16 and 8), timed; heads of 264 at 1 bit (packed rows of 33
    # bytes), ragged; heads of 768 at 8 and 2 bits
    ("heads of 384, 4-bit", 16, 256, 256, 4, True, 384),
    ("heads of 768, 4-bit", 8, 256, 256, 4, True, 768),
    ("heads of 264, ragged 1-bit", 6, 100, 100, 1, False, 264),
    ("heads of 768, 8-bit", 8, 256, 256, 8, False, 768),
    ("heads of 768, ragged 2-bit", 4, 100, 130, 2, False, 768),
    # the cluster instance's edges: a cluster of 3 over a long chain at 1
    # bit (packed rows of 65 bytes), one of 8, and past them blocks of 2
    # slices (2056)
    ("heads of 520, long 1-bit", 4, 256, 999, 1, False, 520),
    ("heads of 2048, 4-bit", 2, 128, 300, 4, False, 2048),
    ("heads of 2056, ragged 4-bit", 2, 100, 130, 4, False, 2056),
    # past 2048, timed: heads of 2056 at BH=3, the work of the row of 768
    # (BH=8) within 0.4%, beside the cluster instance at 2048 on the same
    # work, and heads of 4104 (blocks of 3 slices) at BH=3
    ("heads of 2056 past the clusters, 4-bit", 3, 256, 256, 4, True, 2056),
    ("heads of 2048 at that work, 4-bit", 3, 256, 256, 4, True, 2048),
    ("heads of 4104, 4-bit", 3, 256, 256, 4, True, 4104),
    # the one head of 2560 of `heads_wide`'s 2-layer model at its scan
    # sampler's shape (B=8, Sq=Skv=256) at the sampler's 8, 4 and 2 bits,
    # where the chain splits: within 2e-3 of the split plain version and
    # 5e-3 of the chain in one run (C44)
    ("heads of 2560 at the scan sampler's shape, 8-bit", 8, 256, 256, 8,
     False, 2560),
    ("heads of 2560 at the scan sampler's shape, 4-bit", 8, 256, 256, 4,
     False, 2560),
    ("heads of 2560 at the scan sampler's shape, 2-bit", 8, 256, 256, 2,
     False, 2560))


def _qa_label(label, BH, Sq, Skv, bits, D):
    return f"{label}: BH={BH} Sq={Sq} Skv={Skv} D={D} {bits}-bit"


def _quant_attention_kernels(gen, results, bad):
    """`attention` over `QuantKV` against `attention_plain` at the kernel's
    KV tile (64 tokens; the cluster instance's 32 at heads of 264-2048, and
    its split of the chain over clusters, where the check also bounds the
    output against the chain in one run by C19's 5e-3), at
    the scan sampler's shapes: BH=96 (B=8 x 12 heads), Sq=Skv=256 at 4, 8
    and 2 bits; BH=24, S=1024 (the long-sequence run) at 4 bits; and a
    ragged Sq=Skv=100 (`Engine.sample(seq_len=100)`). Sums in another order
    and CUDA's expf, which can move a bf16 rounding of p * vs: rel Frobenius
    <= 2e-3. Library yardstick: K and V dequantized to bf16, then
    scaled_dot_product_attention. The cluster rows log the splits of their
    chain and the clusters the card runs at once. Also quantize_kv on the
    card against the CPU, bit for bit, with the IEEE division and with the
    reciprocal."""
    from diffusion_llm_rs_tpu_torch.ops import _build
    from diffusion_llm_rs_tpu_torch.ops import attention as qa

    for bits in (1, 2, 4, 8):
        x = torch.randn((24, 100, 64), generator=gen, device="cuda") * \
            torch.rand((24, 100, 1), generator=gen, device="cuda") * 10
        same = True
        for recip in (False, True):
            dev, cpu = qa.quantize_kv(x, bits, recip), \
                qa.quantize_kv(x.cpu(), bits, recip)
            same = same and all(torch.equal(a.cpu(), b) for a, b in (
                (dev.data, cpu.data), (dev.scale, cpu.scale),
                (dev.zero_point, cpu.zero_point)))
        log(f"  quantize_kv {bits}-bit card vs CPU: "
            f"{'bit for bit' if same else 'MISMATCH'}")
        if not same:
            bad.append(f"quantize_kv {bits}-bit")

    tol = "rel Frobenius <= 2e-3"
    for label, BH, Sq, Skv, bits, timed, D in QA_CASES:
        q = torch.randn((BH, Sq, D), generator=gen, device="cuda").to(
            torch.bfloat16)
        k = qa.quantize_kv(torch.randn((BH, Skv, D), generator=gen,
                                       device="cuda"), bits)
        v = qa.quantize_kv(torch.randn((BH, Skv, D), generator=gen,
                                       device="cuda"), bits)
        out = qa.attention(q, k, v)
        cluster = qa.instance(D) == "_cluster"
        tile = qa.CLUSTER_KV_TILE if cluster else qa.KERNEL_KV_TILE
        # the cluster instance's chain of tiles in its splits
        n = qa.quant_cluster_splits(BH, Sq, Skv, D, bits) \
            if cluster else 1
        ref = qa.attention_plain(q, k, v, tile=tile, splits=n)
        err, rel, _ = _compare(out, ref, 0.0, 0.0)
        ok = rel <= 2e-3 and bool(torch.isfinite(out).all())
        row = dict(shape=_qa_label(label, BH, Sq, Skv, bits, D),
                   max_abs_err=err, rel_err=rel, tolerance=tol,
                   wide=D > WIDE_FROM)
        if n > 1:  # against the chain in one run: within C19's 5e-3
            one = qa.attention_plain(q, k, v, tile=tile)
            row["rel_err_unsplit"] = _compare(out, one, 0.0, 0.0)[1]
            ok = ok and row["rel_err_unsplit"] <= 5e-3
        if cluster:  # the clusters at once, and the splits of the chain
            row["clusters_at_once"] = _build.function(
                "dlm_quant_attention_cluster_active")(D, bits)
            row["splits"] = n
        if timed:
            row["ms"] = time_ms(lambda: qa.attention(q, k, v))
            row["plain_ms"] = time_ms(lambda: qa.attention_plain(
                q, k, v, tile=tile, splits=n), 5)

            def lib():
                return torch.nn.functional.scaled_dot_product_attention(
                    q[None], k.dequantize(torch.bfloat16)[None],
                    v.dequantize(torch.bfloat16)[None])
            row["library_ms"] = time_ms(lib)
            if bits == 4 and BH % 12 == 0 and Skv % 128 == 0:
                row["two_launch_ms"] = _two_launch_ms(gen, BH, Sq, Skv, D)
            # q bf16, packed K and V, four f32 sidecars, f32 out
            nbytes = (BH * Sq * D * 2 + 2 * BH * Skv * (D * bits // 8)
                      + 4 * BH * Skv * 4 + BH * Sq * D * 4)
            row["bound_ms"], row["bound_by"] = bound(
                nbytes, 4 * BH * Sq * Skv * D, PEAK_BF16_FLOPS)
            mufu = mufu_floor_ms(BH * Sq * Skv)
        results["quant_attention"].append(row)
        log(f"  quant_attention {label}: max_abs_err {err:.3g} rel {rel:.3g} "
            f"({tol}) {'ok' if ok else 'MISMATCH'}"
            + (f"; {n} split(s) (against the chain in one run rel "
               f"{row['rel_err_unsplit']:.3g}, bound 5e-3)" if n > 1 else "")
            + (f"; {row['clusters_at_once']} clusters at once"
               if cluster else "")
            + (f"; {row['ms']:.4f} ms, plain {row['plain_ms']:.4f}, library "
               f"{row['library_ms']:.4f}, bound {row['bound_ms']:.4f} "
               f"({row['bound_by']}); MUFU ex2 floor {mufu:.4f}"
               if timed else "")
            + (f"; two launches {row['two_launch_ms']:.4f}"
               if "two_launch_ms" in row else ""))
        if not ok:
            bad.append(f"quant_attention {label}")


def _two_launch_ms(gen, BH, Sq, Skv, D):
    """What the two-launch alternative to the quantized-KV kernel would cost
    at this shape: `paged_unpack` writing every KV tile once as bf16, then
    the batched paged kernel over it, timed as `batched_paged_attention`
    over the same tokens in 4-bit pages of 128 (B = BH / 12 slots of 12
    heads). Folding vs into P instead of V would change its arithmetic, not
    its launches or its bytes."""
    from diffusion_llm_rs_tpu_torch.ops import paged_attention as pa
    B, H, P = BH // 12, 12, 128
    n = Skv // P
    pools = _quantized_pools(gen, B * n, H, P, D, 1, 4)
    q = torch.randn((B, H, Sq, D), generator=gen, device="cuda").to(
        torch.bfloat16)
    pt = torch.arange(B * n, device="cuda", dtype=torch.int32).reshape(B, n)
    nt = torch.full((B, n), P, dtype=torch.int32, device="cuda")
    npg = torch.full((B,), n, dtype=torch.int32, device="cuda")
    return time_ms(lambda: pa.batched_paged_attention(q, pt, nt, npg, *pools,
                                                      bits=4))


def _packed_weight(K, N, bits, gran, act_bits, gen):
    """A [K, N] N(0, 0.02) weight quantized and packed in the port: int
    `bits`, symmetric groups of 128 along K or per output channel."""
    from diffusion_llm_rs_tpu_torch.ops.packed_matmul import prepare
    from diffusion_llm_rs_tpu_torch.quant.core import quantize
    w = torch.randn((K, N), generator=gen, device="cuda") * 0.02
    if gran == "group":
        qt = quantize(w, bits, symmetric=True, granularity="group",
                      group_size=128, axis=0)
    else:
        qt = quantize(w, bits, granularity="channel", axis=1)
    return prepare(qt, act_bits=act_bits)


def _packed_kernels(gen, results, bad):
    """`matmul` (bf16 activations) and `matmul_a8` (int8 activations) over
    packed weights, at the engine path's shapes with int4 g128, bf16 in and
    out: M = 2048 (B=8 x S=256) for the four linears of a block, M = 8 (the
    time-MLP), M = 256 (one sequence), a ragged M = 5 with f32 in and out (a
    `generate` prompt), and once each at 1, 2 and 8 bits and per-channel.

    matmul against matmul_plain (an f32 product of the same bf16 operands,
    summed in another order): |d| <= 2e-5 + 2^-7 |ref| (one bf16 ulp), in
    f32 2e-5 + 2e-5 |ref|. matmul_a8 against a8_matmul_reference: integer
    products are exact, so bit for bit without gelu, one bf16 ulp with it;
    without gelu it must also equal int8w_matmul on decode_to_int8(w).
    Library yardsticks: the weight dequantized (or decoded to int8) once
    outside the timed window, then torch.matmul in bf16 (or torch._int_mm)
    and the epilogue in torch ops."""
    from diffusion_llm_rs_tpu_torch.ops import int8_matmul as im
    from diffusion_llm_rs_tpu_torch.ops import packed_matmul as pm
    from diffusion_llm_rs_tpu_torch.ops.matmul import decode_to_int8

    bf16, f32 = torch.bfloat16, torch.float32
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, M, K, N, bits, gran, bias, gelu, dname, timed in PACKED_CASES:
        dtype = bf16 if dname == "bf16" else f32
        x = torch.randn((M, K), generator=gen, device="cuda").to(dtype)
        b = (torch.randn((N,), generator=gen, device="cuda") * 0.02
             if bias else None)
        act = "gelu" if gelu else None
        side = 2 * (1 if gran == "channel" else K // 128) * N * 4
        nbytes = (M * K * 2 + K * bits // 8 * N + side + (N * 4 if bias else 0)
                  + M * N * 2)
        shape = f"{label}: M={M} K={K} N={N} {bits}-bit {gran}"
        for name, act_bits in (("matmul", 16), ("matmul_a8", 8)):
            w = _packed_weight(K, N, bits, gran, act_bits, gen)
            out = pm.matmul(x, w, dtype, b, act)
            if act_bits == 16:
                ref = pm.matmul_plain(x, w, b, act, dtype)
                rtol = 2.0 ** -7 if dtype == bf16 else 2e-5
                tol = f"|d| <= 2e-5 + {rtol:.3g} |ref|"
                err, rel, ok = _compare(out, ref, 2e-5, rtol)
            else:
                ref = pm.a8_matmul_reference(x, w, b, act, dtype)
                if gelu:
                    tol = "|d| <= 1e-6 + 2^-7 |ref|"
                    err, rel, ok = _compare(out, ref, 1e-6, 2.0 ** -7)
                else:
                    tol = "bit for bit, and equal to int8w_matmul on the " \
                          "decoded weight"
                    err, rel, ok = _compare(out, ref, 0.0, 0.0)
                    if dtype == bf16:  # int8w_matmul quantizes bf16 rows
                        d = decode_to_int8(w)
                        ok = ok and torch.equal(out, im.int8w_matmul(
                            x, d.data, d.col_scale, b, None, None, dtype))
            row = dict(shape=shape, max_abs_err=err, rel_err=rel,
                       tolerance=tol)
            if timed:
                row["ms"] = time_ms(lambda: pm.matmul(x, w, dtype, b, act))
                lib_ms = None
                if act_bits == 16:
                    row["plain_ms"] = time_ms(
                        lambda: pm.matmul_plain(x, w, b, act, dtype), 5)
                    wd = w.dequantize(bf16)

                    def lib():
                        y = torch.matmul(x, wd).float()
                        if b is not None:
                            y = y + b
                        return (im.gelu_tanh(y) if gelu else y).to(dtype)
                    lib_ms = time_ms(lib)
                    peak = PEAK_BF16_FLOPS
                else:
                    row["plain_ms"] = time_ms(
                        lambda: pm.a8_matmul_reference(x, w, b, act, dtype), 5)
                    xi, sx, row["library_note"] = _int_mm_rows(
                        *pm.quantize_act_i8(x))
                    d = decode_to_int8(w)
                    row.update(_library_times(
                        xi, sx, d.data, d.data.t().contiguous().t(),
                        d.col_scale, b, gelu, None))
                    lib_ms = row["library_ms"]
                    row["plan"] = _plan_label(im.gemm_plan(M, N, K, sms))
                    peak = PEAK_INT8_OPS
                row["library_ms"] = lib_ms
                row["bound_ms"], row["bound_by"] = bound(
                    nbytes + (N * 4 if act_bits == 8 else 0), 2 * M * K * N,
                    peak)
            results[name].append(row)
            lib_text = (_library_label(row) if "library_colmajor_ms" in row
                        else f"{row.get('library_ms')}")
            log(f"  {name} {shape}: max_abs_err {err:.3g} rel {rel:.3g} "
                f"({tol}) {'ok' if ok else 'MISMATCH'}"
                + (f"; {row['ms']:.4f} ms"
                   + (f" ({row['plan']})" if "plan" in row else "")
                   + f", plain {row['plain_ms']:.4f}, library {lib_text}, "
                   f"bound {row['bound_ms']:.4f} ({row['bound_by']})"
                   if timed else ""))
            if not ok:
                bad.append(f"{name} {label}")

    # quantize_fp8 on the card equals the CPU bit for bit
    from diffusion_llm_rs_tpu_torch.quant.core import quantize_fp8
    x = torch.randn((512, 257), generator=gen, device="cuda") * 3
    dev, cpu = quantize_fp8(x), quantize_fp8(x.cpu())
    same = torch.equal(dev.data.view(torch.uint8).cpu(),
                       cpu.data.view(torch.uint8)) and \
        torch.equal(dev.scale.cpu(), cpu.scale)
    log(f"  quantize_fp8 card vs CPU: {'bit for bit' if same else 'MISMATCH'}")
    if not same:
        bad.append("quantize_fp8")


def full_width_model(max_seq, heads=12, hidden=768, layers=12):
    """12L/768d/vocab-50257 model of `heads` heads (12 of 64 by default;
    `hidden` and `layers` change the width and depth) from a seeded
    generator, quantized in the port: int4 symmetric g128 ->
    prepare(act_bits=8) -> decode_to_int8; remaining f32 leaves (biases,
    norms, positions) in bf16."""
    from diffusion_llm_rs_tpu_torch.config import DiffusionConfig
    from diffusion_llm_rs_tpu_torch.models import denoiser as dn
    from diffusion_llm_rs_tpu_torch.ops.int8_matmul import prepare
    from diffusion_llm_rs_tpu_torch.ops.matmul import decode_to_int8
    from diffusion_llm_rs_tpu_torch.quant.core import QuantizedTensor, quantize_tree

    cfg = DiffusionConfig(num_timesteps=1000, hidden_size=hidden,
                          num_layers=layers, num_attention_heads=heads,
                          vocab_size=50257, max_sequence_length=max_seq,
                          dtype="bfloat16")
    params = dn.init_denoiser_params(
        torch.Generator(device="cuda").manual_seed(0), cfg)
    qparams = quantize_tree(params, 4, symmetric=True, granularity="group",
                            group_size=128, axis=0)

    def prep(t):
        if isinstance(t, dict):
            return {k: prep(v) for k, v in t.items()}
        if isinstance(t, list):
            return [prep(v) for v in t]
        if isinstance(t, QuantizedTensor) and t.ndim == 2:
            try:
                return decode_to_int8(prepare(t, act_bits=8))
            except ValueError:  # vocab-sized embedding: K not packable
                return t
        if isinstance(t, torch.Tensor) and t.dtype == torch.float32:
            return t.to(torch.bfloat16)
        return t
    return cfg, prep(qparams)


def graphs_disabled():
    """`utils.graphs.disabled()`: the port's steps run eagerly inside (no
    CUDA graph is captured or replayed)."""
    from diffusion_llm_rs_tpu_torch.utils import graphs
    return graphs.disabled()


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def _sampler(cfg, params, device, eps_log=None):
    """The one-shot sampler's schedule and model_fn: x cast to the model's
    dtype (bf16 at full width), eps back to f32."""
    from diffusion_llm_rs_tpu_torch.models import denoiser as dn
    from diffusion_llm_rs_tpu_torch.models.diffusion import DiffusionSchedule

    schedule = DiffusionSchedule.create(cfg.num_timesteps, device=device)

    def model_fn(x, t):
        eps = dn.denoiser_forward(params, cfg, x.to(getattr(torch, cfg.dtype)),
                                  t)
        if eps_log is not None:
            eps_log.append(eps.float().cpu())
        return eps.to(torch.float32)
    return schedule, model_fn


MODEL = {}
REPEATS = 5  # timed 32-step sampler runs (median reported)


def _expected_launches(cfg, steps, long_seq):
    """Per forward: 2 time-MLP + L qkv + L wo + 1 head int8w_matmul (27 at
    L = 12), L fused int8w_mlp and no chained one (L chained and no fused
    one where the fused kernel does not take the widths, `mlp_fits`: past
    width 768), and L dense_attention at Skv >= 1024."""
    from diffusion_llm_rs_tpu_torch.ops.int8_matmul import mlp_fits
    L, D = cfg.num_layers, cfg.hidden_size
    fused = mlp_fits(D, cfg.mlp_ratio * D)
    out = {"int8w_matmul": (3 + 2 * L) * steps,
           "int8w_mlp": L * steps if fused else 0,
           "int8w_mlp_chained": 0 if fused else L * steps}
    if long_seq:
        out["dense_attention"] = L * steps
    return out


def _k_major_bytes(params):
    """Bytes of the K-major copies (`_k_major`) the int8 kernels keep of the
    model's decoded int8 weights, the fused MLPs' and the other linears';
    and the bytes of the weights held K-major already, which need none."""
    from diffusion_llm_rs_tpu_torch.ops import int8_matmul as im
    from diffusion_llm_rs_tpu_torch.ops.matmul import Int8Weight
    out = {"mlp": 0, "linears": 0, "held_k_major": 0}

    def walk(t, mlp):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, mlp or k == "mlp")
        elif isinstance(t, list):
            for v in t:
                walk(v, mlp)
        elif isinstance(t, Int8Weight):
            hit = im._k_major_copies.get(id(t.data))
            if hit is not None and hit[0]() is t.data:
                out["mlp" if mlp else "linears"] += hit[2].numel()
            if t.data.t().is_contiguous():
                out["held_k_major"] += t.data.numel()
    walk(params, False)
    return out


def sampler():
    from diffusion_llm_rs_tpu_torch.models import denoiser as dn
    from diffusion_llm_rs_tpu_torch.models.diffusion import sample
    from diffusion_llm_rs_tpu_torch.ops import _build

    t0 = time.perf_counter()
    cfg, params = full_width_model(max_seq=4096)
    torch.cuda.synchronize()
    log(f"  model built and quantized in {time.perf_counter() - t0:.1f} s")
    MODEL.update(cfg=cfg, params=params)
    B, S, steps = 8, 256, 32
    schedule, model_fn = _sampler(cfg, params, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(7)
    sample(model_fn, schedule, (B, S, cfg.hidden_size), gen, num_steps=2)  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k_major = _k_major_bytes(params)
    log(f"  K-major int8 weight copies after a W4A8 forward: {k_major['mlp']} "
        f"bytes for the MLPs, {k_major['linears']} bytes for the other "
        f"linears; {k_major['held_k_major'] / 1e6:.1f} MB of int8 weights "
        f"held K-major once (ROADMAP C32)")
    if k_major["mlp"] or k_major["linears"] or not k_major["held_k_major"]:
        raise AssertionError(f"int8 weights copied K-major: {k_major}")

    expect = _expected_launches(cfg, steps, long_seq=False)
    walls, cpus = [], []
    for _ in range(REPEATS):
        _build.reset_launch_counts()
        t0, c0 = time.perf_counter(), time.process_time()
        x = sample(model_fn, schedule, (B, S, cfg.hidden_size), gen,
                   num_steps=steps)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        cpus.append(time.process_time() - c0)
        counts = dict(_build.launch_counts)
        for name, n in expect.items():
            if counts.get(name, 0) != n:
                raise AssertionError(f"{name}: {counts.get(name, 0)} "
                                     f"launches, expected {n}")
        if not bool(torch.isfinite(x).all()):
            raise AssertionError("sampler output is not finite")
    tokens = dn.decode_tokens(params, x)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    walls.sort()
    wall = walls[len(walls) // 2]
    cpu = statistics.median(cpus)
    log(f"  launches per run {counts}")
    log(f"  sample B={B} S={S} steps={steps}, {REPEATS} runs: median "
        f"{wall:.4f} s (min {walls[0]:.4f}, max {walls[-1]:.4f}), "
        f"{B * S / wall:.1f} generated tokens/s, "
        f"{B * S * steps / wall:.1f} denoise-step tokens/s, "
        f"peak memory {peak / 2**20:.1f} MiB; host CPU time per step "
        f"{cpu / steps * 1e3:.2f} ms (median run {cpu:.4f} s)")
    by_max_seq = _sampler_by_max_seq(cfg, params, (B, S, cfg.hidden_size),
                                     steps)
    if tokens.shape != (B, S) or int(tokens.min()) < 0 or \
            int(tokens.max()) >= cfg.vocab_size:
        raise AssertionError(f"token ids out of range: {tokens.shape}")

    # 2 steps on the same start and noise: kernels (card) vs twins (CPU);
    # bf16 activations round at slightly different points on the two sides
    # (layer-norm sums), which can move an act-quant level: rel <= 2e-2
    Bc = 2
    g = torch.Generator(device="cuda").manual_seed(11)
    x0 = torch.randn((Bc, S, cfg.hidden_size), generator=g, device="cuda")
    noises = [torch.randn_like(x0) for _ in range(2)]
    eps_k, eps_p = [], []
    _, fn_k = _sampler(cfg, params, "cuda", eps_k)
    with graphs_disabled():  # the eps log copies to the host each step
        xk = sample(fn_k, schedule, x0.shape, num_steps=2, x=x0,
                    noises=noises)
    cpu_params = _to(params, "cpu")
    sched_p, fn_p = _sampler(cfg, cpu_params, "cpu", eps_p)
    t0 = time.perf_counter()
    xp = sample(fn_p, sched_p, x0.shape, num_steps=2, x=x0.cpu(),
                noises=[n.cpu() for n in noises])
    log(f"  twin run on the CPU: {time.perf_counter() - t0:.1f} s")
    worst = 0.0
    for i, (a, b) in enumerate(zip(eps_k, eps_p)):
        rel = float((a - b).norm() / b.norm())
        worst = max(worst, rel)
        log(f"  step {i}: eps rel err kernels vs twins {rel:.3g}")
    rel_x = float((xk.cpu() - xp).norm() / xp.norm())
    log(f"  x after 2 steps rel err {rel_x:.3g} (bound 2e-2)")
    if worst > 2e-2 or rel_x > 2e-2:
        raise AssertionError("sampler disagrees with its twins")
    return dict(counts=counts, runs=REPEATS, wall_s=wall, walls_s=walls,
                cpu_s=cpu, tokens_per_s=B * S / wall, peak_bytes=peak,
                eps_rel_err=worst, by_max_seq=by_max_seq,
                k_major_bytes=k_major)


def _sampler_by_max_seq(cfg, params, shape, steps, runs=3):
    """The same sampler with the model built at max_sequence_length 1024
    and 4096 (this script's), runs alternating, each timed by wall and host
    CPU time: whether the position table's length moves the step."""
    from diffusion_llm_rs_tpu_torch.models.diffusion import sample

    models = {1024: full_width_model(max_seq=1024),
              cfg.max_sequence_length: (cfg, params)}
    fns = {m: _sampler(c, p, "cuda") for m, (c, p) in models.items()}
    gen = torch.Generator(device="cuda").manual_seed(13)
    times = {m: [] for m in models}
    for _ in range(runs):
        for m, (schedule, model_fn) in fns.items():
            torch.cuda.synchronize()
            t0, c0 = time.perf_counter(), time.process_time()
            sample(model_fn, schedule, shape, gen, num_steps=steps)
            torch.cuda.synchronize()
            times[m].append((time.perf_counter() - t0,
                             time.process_time() - c0))
    out = {}
    for m, ts in times.items():
        wall = statistics.median(t[0] for t in ts)
        cpu = statistics.median(t[1] for t in ts)
        out[m] = dict(wall_s=wall, cpu_s=cpu,
                      tokens_per_s=shape[0] * shape[1] / wall)
        log(f"  max_sequence_length {m}: median of {runs} runs {wall:.4f} s "
            f"({shape[0] * shape[1] / wall:.1f} generated tokens/s), host "
            f"CPU {cpu:.4f} s")
    return out


def long_seq(cfg=None, params=None, expect=None, seed=5):
    """2 steps of the one-shot sampler at B=2, S=1024 (attention through
    dense_attention), by default on the W4A8 model, with `expect` its launch
    counts (default `_expected_launches`); then eps of one forward through
    flash_fold against the einsum path's: rel <= 2e-2."""
    from diffusion_llm_rs_tpu_torch.models import denoiser as dn
    from diffusion_llm_rs_tpu_torch.models.diffusion import sample
    from diffusion_llm_rs_tpu_torch.ops import _build

    cfg = cfg or MODEL["cfg"]
    params = MODEL["params"] if params is None else params
    B, S, steps = 2, 1024, 2
    expect = expect or _expected_launches(cfg, steps, long_seq=True)
    schedule, model_fn = _sampler(cfg, params, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    x = sample(model_fn, schedule, (B, S, cfg.hidden_size), gen, num_steps=steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(_build.launch_counts)
    log(f"  launches {counts}; {steps} steps at B={B} S={S}: {wall:.4f} s")
    if not bool(torch.isfinite(x).all()):
        raise AssertionError("long-S output is not finite")
    _expect("long_seq", counts, expect)
    # the flash path against the einsum path of the same forward
    xb = x.to(getattr(torch, cfg.dtype))
    t = torch.full((B,), cfg.num_timesteps // 2, device="cuda")
    e_flash = dn.denoiser_forward(params, cfg, xb, t).float()
    e_einsum = dn.denoiser_forward(params, cfg, xb, t, flash_attn=False).float()
    rel = float((e_flash - e_einsum).norm() / e_einsum.norm())
    log(f"  eps flash vs einsum attention: rel err {rel:.3g} (bound 2e-2)")
    if rel > 2e-2:
        raise AssertionError("flash attention path disagrees with einsum path")
    return dict(counts=counts, wall_s=wall, eps_rel_err=rel)


def _device_time(fn, reps):
    """(wall ms per call, device ms per call, [(device us, calls, kernel)])
    of `reps` calls under torch.profiler; device-side events only, since an
    aten op's row repeats its kernels' time."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us / reps, ev.count // reps, ev.key))
    rows.sort(reverse=True)
    return wall_ms, sum(r[0] for r in rows) / 1e3, rows


# kernel families whose device time a step the profiled runs report: the
# int8 GEMMs (csrc/int8_gemm.cu's row quantization, product and split-K
# sum, csrc/packed_gemm.cu's act_bits=8 unpack) and the fused MLP
FAMILIES = {"int8_gemm": ("int8_gemm_kernel", "int8_gemm_reduce",
                          "quant_rows_kernel", "unpack_i8_kernel"),
            "int8_mlp": ("int8_mlp_kernel",)}


def _family_ms(rows, steps):
    """Device ms a step of each kernel family in a profiled run, logged."""
    out = {f: sum(us for us, _, key in rows if any(k in key for k in names))
           / 1e3 / steps for f, names in FAMILIES.items()}
    log("  a step: " + ", ".join(f"{f} {ms:.4f} ms" for f, ms in out.items()))
    return out


def _logged_forward(eps_log=None):
    """`forward_fn` of the scan sampler with activations in the model's
    dtype, as the other paths run it: x cast to it (bf16 at full width),
    eps back to f32 and, given `eps_log`, appended to it on the host."""
    from diffusion_llm_rs_tpu_torch.models import denoiser as dn

    def fwd(params, cfg, x, t, **kw):
        out = dn.denoiser_forward(params, cfg, x.to(getattr(torch, cfg.dtype)),
                                  t, **kw)
        eps, rest = (out[0], out[1:]) if isinstance(out, tuple) else (out, ())
        if eps_log is not None:
            eps_log.append(eps.float().cpu())
        eps = eps.to(torch.float32)
        return (eps,) + tuple(rest) if rest else eps
    return fwd


def scan_sampler():
    """`phase_aware_sample` on the W4A8 model, B=8, S=256, 32 steps over the
    default phase schedule (8 bits for t > 16, 4 at t = 16, then 2), the
    packed `QuantKV` carry read by the quant_attention kernel: 5 timed runs,
    exact launch counts (per step 27 int8w_matmul and 12 int8w_mlp; 12
    quant_attention after the bootstrap step, which has no cache); the busy
    share of an 8-step run; then 2 steps at B=2, S=1024 (bootstrap through
    dense_attention, one cached step through quant_attention) and 4 steps at
    S=256 with the dequantized carry (no quant_attention launch)."""
    from diffusion_llm_rs_tpu_torch.models import denoiser as dn
    from diffusion_llm_rs_tpu_torch.models.diffusion import DiffusionSchedule
    from diffusion_llm_rs_tpu_torch.models.sampler import (phase_aware_sample,
                                                           plan_segments)
    from diffusion_llm_rs_tpu_torch.ops import _build
    from diffusion_llm_rs_tpu_torch.serving import GeneratorNoise

    cfg, params = MODEL["cfg"], MODEL["params"]
    schedule = DiffusionSchedule.create(cfg.num_timesteps, device="cuda")
    noise = GeneratorNoise(61, "cuda")
    fwd = _logged_forward()
    B, S, steps, L = 8, 256, 32, cfg.num_layers
    segments = plan_segments(steps, cfg)
    if [b for b, _, _ in segments] != [8, 4, 2]:
        raise AssertionError(f"segments {segments}")

    def run(shape, n, **kw):
        return phase_aware_sample(params, cfg, schedule, shape, noise, n,
                                  forward_fn=fwd, **kw)

    run((B, S), 2)  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    expect = dict(_expected_launches(cfg, steps, long_seq=False),
                  quant_attention=L * (steps - 1), dense_attention=0)
    walls, cpus = [], []
    for _ in range(REPEATS):
        _build.reset_launch_counts()
        t0, c0 = time.perf_counter(), time.process_time()
        x = run((B, S), steps)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        cpus.append(time.process_time() - c0)
        counts = dict(_build.launch_counts)
        _expect("scan_sampler", counts, expect)
        if not bool(torch.isfinite(x).all()):
            raise AssertionError("scan sampler output is not finite")
    tokens = dn.decode_tokens(params, x)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    if tuple(tokens.shape) != (B, S) or int(tokens.min()) < 0 or \
            int(tokens.max()) >= cfg.vocab_size:
        raise AssertionError(f"token ids out of range: {tuple(tokens.shape)}")
    walls.sort()
    wall, cpu = walls[len(walls) // 2], statistics.median(cpus)
    log(f"  segments {segments}; launches per run {counts}")
    log(f"  phase_aware_sample B={B} S={S} steps={steps}, {REPEATS} runs: "
        f"median {wall:.4f} s (min {walls[0]:.4f}, max {walls[-1]:.4f}), "
        f"{B * S / wall:.1f} generated tokens/s, peak memory "
        f"{peak / 2**20:.1f} MiB; host CPU time per step "
        f"{cpu / steps * 1e3:.2f} ms")

    # busy share: an 8-step run by the wall clock, then under the profiler
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run((B, S), 8)
    torch.cuda.synchronize()
    wall8 = (time.perf_counter() - t0) * 1e3
    _, busy_ms, rows = _device_time(lambda: run((B, S), 8), 1)
    share = busy_ms / wall8 if rows else None
    log(f"  8 steps: wall {wall8:.2f} ms, kernels {busy_ms:.2f} ms "
        f"({'not measured' if share is None else f'{share:.1%} busy'})")
    for us, n, key in rows[:8]:
        log(f"  {us / 1e3:8.4f} ms  x{n:<4d} {key[:90]}")
    families = _family_ms(rows, 8)

    _build.reset_launch_counts()
    x = run((2, 1024), 2)
    torch.cuda.synchronize()
    long_counts = dict(_build.launch_counts)
    _expect("scan_sampler S=1024", long_counts, dict(
        _expected_launches(cfg, 2, long_seq=False), quant_attention=L,
        dense_attention=L))
    _build.reset_launch_counts()
    xf = run((B, S), 4, kernel_cache=False)
    torch.cuda.synchronize()
    deq_counts = dict(_build.launch_counts)
    _expect("scan_sampler kernel_cache=False", deq_counts, dict(
        _expected_launches(cfg, 4, long_seq=False), quant_attention=0))
    if not (bool(torch.isfinite(x).all()) and bool(torch.isfinite(xf).all())):
        raise AssertionError("scan sampler output is not finite")
    log(f"  2 steps at B=2 S=1024: launches {long_counts}; 4 steps with the "
        f"dequantized carry: launches {deq_counts}")
    return dict(counts=counts, runs=REPEATS, wall_s=wall, walls_s=walls,
                cpu_s=cpu, tokens_per_s=B * S / wall, peak_bytes=peak,
                step_wall_ms=wall8 / 8, step_device_ms=busy_ms / 8,
                busy_share=share, long_counts=long_counts,
                dequantized_counts=deq_counts, step_family_ms=families,
                top=[dict(ms=us / 1e3, calls=n, name=key[:120])
                     for us, n, key in rows[:8]])


def scan_check(cfg=None, params=None, shape=(2, 256), seed=67):
    """3 steps of `phase_aware_sample` at `shape` (t = 2 at 8 bits, t = 1
    at 4, t = 0 at 2: the carry is requantized at both segment boundaries),
    by default on the W4A8 model at B=2, S=256, on the card against the
    plain versions on the CPU from the same draws. eps of each step within
    3e-2 relative and x within 2e-2: beside the bf16 rounding points of the
    sampler's check, the carried K/V differ by a quantization level here and
    there, and the CPU's plain attention steps its softmax 256 tokens at a
    time where the kernel steps 64."""
    from diffusion_llm_rs_tpu_torch.models.diffusion import DiffusionSchedule
    from diffusion_llm_rs_tpu_torch.models.sampler import (phase_aware_sample,
                                                           plan_segments)
    from diffusion_llm_rs_tpu_torch.ops import _build
    from diffusion_llm_rs_tpu_torch.serving import GeneratorNoise

    cfg = cfg or MODEL["cfg"]
    params = MODEL["params"] if params is None else params
    if [b for b, _, _ in plan_segments(3, cfg)] != [8, 4, 2]:
        raise AssertionError(f"segments {plan_segments(3, cfg)}")
    rec = _Recorded(GeneratorNoise(seed, "cuda"))
    xs, eps = {}, {"cuda": [], "cpu": []}
    for device in ("cuda", "cpu"):
        on = params if device == "cuda" else _to(params, "cpu")
        noise = rec if device == "cuda" else _Replay(rec.draws)
        schedule = DiffusionSchedule.create(cfg.num_timesteps, device=device)
        if device == "cuda":
            torch.cuda.synchronize()
            _build.reset_launch_counts()
        t0 = time.perf_counter()
        with graphs_disabled():  # the eps log copies to the host each step
            xs[device] = phase_aware_sample(
                on, cfg, schedule, shape, noise, 3,
                forward_fn=_logged_forward(eps[device])).cpu()
        log(f"  3 steps on {device}: {time.perf_counter() - t0:.1f} s")
        if device == "cuda":
            counts = dict(_build.launch_counts)
    _expect("scan_check", counts, {"quant_attention": 2 * cfg.num_layers})
    worst = 0.0
    for i, (a, b) in enumerate(zip(eps["cuda"], eps["cpu"])):
        rel = float((a - b).norm() / b.norm())
        worst = max(worst, rel)
        log(f"  step {i}: eps rel err card vs CPU {rel:.3g}")
    rel_x = float((xs["cuda"] - xs["cpu"]).norm() / xs["cpu"].norm())
    log(f"  x after 3 steps rel err {rel_x:.3g} (bound 2e-2); worst eps "
        f"{worst:.3g} (bound 3e-2); launches {counts}")
    if not (worst <= 3e-2 and rel_x <= 2e-2):
        raise AssertionError("scan sampler disagrees with the plain versions")
    return dict(x_rel_err=rel_x, eps_rel_err=worst, counts=counts)


def profile():
    """Where one denoise step's device time goes (B=8, S=256): torch.profiler
    sums by kernel name, and the device-busy share of the step's wall time.
    Informational: a profiler that records no device time prints so."""
    from diffusion_llm_rs_tpu_torch.models import denoiser as dn

    cfg, params = MODEL["cfg"], MODEL["params"]
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((8, 256, cfg.hidden_size), generator=gen,
                    device="cuda").to(torch.bfloat16)
    t = torch.full((8,), 500, device="cuda")
    for _ in range(2):
        dn.denoiser_forward(params, cfg, x, t)
    torch.cuda.synchronize()
    wall_ms, busy_ms, rows = _device_time(
        lambda: dn.denoiser_forward(params, cfg, x, t), 3)
    if not rows:
        log("  profiler recorded no device time: breakdown not measured")
        return None
    log(f"  forward wall {wall_ms:.3f} ms (profiled), kernel time "
        f"{busy_ms:.3f} ms ({busy_ms / wall_ms:.1%} of the wall)")
    for us, n, key in rows[:15]:
        log(f"  {us / 1e3:8.4f} ms  x{n:<4d} {key[:90]}")
    return dict(forward_wall_ms=wall_ms, device_busy_ms=busy_ms,
                top=[dict(ms=us / 1e3, calls=n, name=key[:120])
                     for us, n, key in rows[:15]])


def _fused_attend(H):
    """A `denoiser_forward` `attend_fn` that runs fused_qkv_attention on the
    layer's [B, S, 3D] projection of H heads."""
    from diffusion_llm_rs_tpu_torch.ops.attention import fused_qkv_attention

    def attend(li, q, k, v, mask):
        if mask is not None:
            raise AssertionError("fused_qkv_attention takes no mask")
        B, S, _, Hd = q.shape
        qkv = torch.cat([q, k, v], dim=2).reshape(B, S, 3 * H * Hd)
        out = fused_qkv_attention(qkv, H, out_dtype=q.dtype)
        if out is None:
            raise AssertionError(f"fused_qkv_attention refused S={S}")
        return out.reshape(B, S, H, Hd)
    return attend


def fused_qkv():
    """One full-width forward of the sampler's model (B=8, S=256, t=500)
    with `attend_fn` running fused_qkv_attention on the layer's [B, S, 3D]
    projection: exactly one launch a layer; eps against the same forward
    through the default einsum attention (the same math: rel <= 2e-2, the
    sampler's bound, since bf16 rounds at other points); and the card
    against the plain versions on the CPU from the same input (rel <=
    2e-2)."""
    from diffusion_llm_rs_tpu_torch.models import denoiser as dn
    from diffusion_llm_rs_tpu_torch.ops import _build

    cfg, params = MODEL["cfg"], MODEL["params"]
    attend = _fused_attend(cfg.num_attention_heads)

    g = torch.Generator(device="cuda").manual_seed(19)
    B, S = 8, 256
    x = torch.randn((B, S, cfg.hidden_size), generator=g,
                    device="cuda").to(torch.bfloat16)
    t = torch.full((B,), 500, device="cuda")
    dn.denoiser_forward(params, cfg, x, t, attend_fn=attend)  # warm
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    e_fused = dn.denoiser_forward(params, cfg, x, t, attend_fn=attend).float()
    torch.cuda.synchronize()
    counts = dict(_build.launch_counts)
    _expect("fused_qkv", counts, {"fused_qkv_attention": cfg.num_layers,
                                  "int8w_mlp": cfg.num_layers,
                                  "dense_attention": 0})
    walls = {}
    for label, kw in (("fused", dict(attend_fn=attend)), ("einsum", {}),
                      ("fused", dict(attend_fn=attend)), ("einsum", {})):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dn.denoiser_forward(params, cfg, x, t, **kw)
        torch.cuda.synchronize()
        walls.setdefault(label, []).append((time.perf_counter() - t0) * 1e3)
    e_einsum = dn.denoiser_forward(params, cfg, x, t).float()
    rel_einsum = float((e_fused - e_einsum).norm() / e_einsum.norm())
    t0 = time.perf_counter()
    e_cpu = dn.denoiser_forward(_to(params, "cpu"), cfg, x.cpu(), t.cpu(),
                                attend_fn=attend).float()
    cpu_s = time.perf_counter() - t0
    rel_cpu = float((e_fused.cpu() - e_cpu).norm() / e_cpu.norm())
    log(f"  launches {counts}; eps vs the einsum forward rel {rel_einsum:.3g}"
        f", vs the plain versions on the CPU rel {rel_cpu:.3g} (bounds 2e-2; "
        f"CPU forward {cpu_s:.1f} s); forward wall ms fused "
        f"{walls['fused']}, einsum {walls['einsum']}")
    if not (rel_einsum <= 2e-2 and rel_cpu <= 2e-2):
        raise AssertionError("the fused-QKV forward disagrees")
    return dict(counts=counts, eps_rel_err_einsum=rel_einsum,
                eps_rel_err_cpu=rel_cpu, forward_wall_ms=walls)


def cache_attend(BH=12, S=1024, D=64, page=64, seed=31):
    """PagedKVCache.attend on the card: a chain of S tokens in pages of
    `page` (by default 1024 tokens, 16 pages of 64, at BH=12 heads of 64),
    widths allocated by salience (8/4/2 bits at an average of 4), one
    paged_attention launch per width, merged by log-sum-exp; against the
    same cache on the CPU (twins): rel <= 1e-2."""
    from diffusion_llm_rs_tpu_torch.cache.paged import PagedKVCache
    from diffusion_llm_rs_tpu_torch.ops import _build

    gen = torch.Generator(device="cuda").manual_seed(seed)
    k, v, q = (torch.randn((BH, S, D), generator=gen, device="cuda")
               for _ in range(3))
    scores = np.random.default_rng(0).random(S).astype(np.float32)
    out = {}
    for device in ("cuda", "cpu"):
        cache = PagedKVCache(bh=BH, head_dim=D, page_size=page,
                             pages_per_bits={b: S // page for b in (8, 4, 2)},
                             device=device)
        cache.append_salient("s", k.to(device), v.to(device), scores,
                             budget_bits=4.0, bit_options=(8, 4, 2))
        if device == "cuda":
            torch.cuda.synchronize()
            _build.reset_launch_counts()
        out[device] = cache.attend("s", q.to(device))
        if device == "cuda":
            torch.cuda.synchronize()
            counts = dict(_build.launch_counts)
            widths = sorted({h.bits for h in cache.page_tables["s"]})
    rel = float((out["cuda"].cpu() - out["cpu"]).norm() / out["cpu"].norm())
    log(f"  launches {counts}; widths {widths}; rel err card vs CPU {rel:.3g} "
        f"(bound 1e-2)")
    if counts.get("paged_attention", 0) != len(widths) or len(widths) < 2:
        raise AssertionError(f"paged_attention launches {counts}, expected "
                             f"one per width {widths}")
    if not rel <= 1e-2:
        raise AssertionError("PagedKVCache.attend disagrees with the CPU")
    return dict(counts=counts, widths=widths, rel_err=rel)


def heads16():
    """Every path of `DiffusionConfig.tiny()` (width 64, 2 layers, 4 heads of
    16, vocab 256, f32; random weights from a seed) on the card, through the
    entry points a user calls, each call's launch counts reset just before
    it, read just after it and checked exactly:
      - `Engine(config=tiny(vocab_size=512), device="cuda").sample(
        batch_size=1, seq_len=10, num_steps=2)` (no page divides 10: the
        scan sampler) and `sample(batch_size=2, seq_len=32, num_steps=4,
        use_paged=False)`: `phase_aware_sample`, L quant_attention launches
        a step after the bootstrap, token ids in range (the engine's
        default tokenizer has 259 ids, more than tiny's 256, in both
        packages; the port's engine tests take vocab 512 too);
      - the checks of the wider phases at tiny's widths, with their bounds:
        `scan_check` on that engine's model at B=1, S=10; `cache_attend`
        over 2 layers x 4 heads of 16, 8 pages of 8 tokens; `long_seq` and
        `train_grad` on `tiny(max_sequence_length=1024)`, B=2, S=1024 (L
        dense_attention launches a step, L for the gradient)."""
    from diffusion_llm_rs_tpu_torch.config import DiffusionConfig
    from diffusion_llm_rs_tpu_torch.engine import Engine
    from diffusion_llm_rs_tpu_torch.models import denoiser as dn
    from diffusion_llm_rs_tpu_torch.ops import _build

    cfg = DiffusionConfig.tiny(vocab_size=512)
    L, H = cfg.num_layers, cfg.num_attention_heads
    if cfg.hidden_size // H != 16:
        raise AssertionError(f"tiny config's heads: {cfg}")
    eng = Engine(config=cfg, device="cuda")
    out = {}
    for name, kw, steps in (
            ("sample(seq_len=10)", dict(batch_size=1, seq_len=10), 2),
            ("sample(seq_len=32, use_paged=False)",
             dict(batch_size=2, seq_len=32, use_paged=False), 4)):
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        tokens = eng.sample(num_steps=steps, return_text=False, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(_build.launch_counts)
        log(f"  {name}: {wall:.3f} s, launches {counts}")
        _expect(f"heads16 {name}", counts, {
            "quant_attention": L * (steps - 1), "dense_attention": 0,
            "paged_attention": 0, "batched_paged_attention": 0})
        if tuple(tokens.shape) != (kw["batch_size"], kw["seq_len"]) or \
                int(tokens.min()) < 0 or int(tokens.max()) >= cfg.vocab_size:
            raise AssertionError(f"{name}: token ids {tuple(tokens.shape)} "
                                 f"out of range")
        out[name] = dict(wall_s=wall, counts=counts)
    log("  scan_check at heads of 16")
    out["scan_check"] = scan_check(cfg, eng.params, (1, 10), seed=71)
    log("  cache_attend at heads of 16")
    out["cache_attend"] = cache_attend(BH=L * H, S=64, D=16, page=8, seed=37)
    lcfg = DiffusionConfig.tiny(max_sequence_length=1024)
    params = dn.init_denoiser_params(
        torch.Generator(device="cuda").manual_seed(41), lcfg)
    log("  long_seq at heads of 16")
    out["long_seq"] = long_seq(lcfg, params, {"dense_attention": 2 * L},
                               seed=41)
    log("  train_grad at heads of 16")
    out["train_grad"] = train_grad(lcfg, seed=41)
    total = {}
    for run in out.values():
        for k, n in run["counts"].items():
            total[k] = total.get(k, 0) + n
    out["counts"] = total
    return out


# heads of 96 and 256 (the fixed instances) and of 384 and 768 (the wide
# instances: the cluster kernels of csrc/wide_cluster_flash.cuh and
# csrc/fused_qkv_attention_wide.cu) at width 768
WIDE_HEADS = (8, 3, 2, 1)


def _replays_equal(fn):
    """Whether `fn()` captured in a CUDA graph and replayed gives the eager
    call's output bit for bit (the capture's launches are not counted)."""
    from diffusion_llm_rs_tpu_torch.ops import _build
    eager = fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), _build.recording_launches():
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with _build.recording_launches(), torch.cuda.graph(graph):
        replayed = fn()
    graph.replay()
    torch.cuda.synchronize()
    return bool(torch.equal(replayed, eager))


def heads_wide():
    """Every attention path at the repo's headline width (12 layers, width
    768, vocab 50257, W4A8 decoded weights from seed 0, as `sampler` builds
    them) with heads between, at and past the widest of the kernels' fixed
    instances: `DiffusionConfig(num_attention_heads=8)`, 8 heads of 96 (run
    in the instances of 128, zero past 96), `num_attention_heads=3`, 3 heads
    of 256, and `num_attention_heads=2` and `1`, 2 heads of 384 and one of
    768 (the wide instance of each design; JAX runs a Pallas kernel at every
    call site of all four). On each model, through the entry points a user
    calls, each call's launch counts reset just before it and checked
    exactly after it:
      - `sample` at B=2, S=1024, 2 steps: dense_attention, L a step;
      - `Engine(config, params=<the decoded W4A8 weights>)`,
        `sample(batch_size=8, seq_len=256, num_steps=8, use_paged=False)`:
        the scan sampler, whose f32 activations meet the W4A8 kernels with
        an f32 residual (ROADMAP C42), quant_attention at 8, 4 and 2 bits, L
        a step after the bootstrap;
      - `PagedContinuousBatcher` at S=2048, pages of 128, 4-bit KV, 2 slots,
        4 requests of 2 steps, with bf16 and with int8 attention
        (`attn_act_bits=8`): paged_unpack and the batched paged kernel, L a
        step;
      - `PagedKVCache.attend` (`cache_attend`, 1024 tokens in pages of 64
        at 8/4/2 bits): paged_attention, one a width;
      - `denoiser_forward(attend_fn=<fused_qkv_attention>)` at B=2, S=256,
        as phase fused_qkv runs it: fused_qkv_attention, L; the same
        forward replayed from a CUDA graph bit for bit the eager one;
    token ids in range; card against the plain versions on the CPU within
    heads16's bounds (one forward at B=1, S=1024 through the dense kernel,
    and the fused-QKV forward, eps within 2e-2; `scan_check` at B=1, S=128;
    `_step_vs_cpu` for both paged kernels; `cache_attend`'s 1e-2); and each
    replaying path, run
    again with its draws, replayed against eager bit for bit
    (`_eager_vs_replayed` over `_graph_paths` at this phase's sizes, each
    warmed by the same work before it is timed: the one-shot and the scan
    sampler at B=2 x 1024, 8 steps each; serve_paged and serve_paged_a8, 4
    requests of S=2048 and 4 steps after one alike). Then a 2-layer model
    of one head of 2560 (`full_width_model(hidden=2560, layers=2)`: blocks
    of 2 slices of 256 columns past 2048) through every path that runs the
    cluster design there: `sample` at B=2, S=1024 (dense_attention, L a
    step; one forward against the CPU), the fused-QKV forward, the scan
    sampler (`Engine.sample(use_paged=False)` at B=8, S=256, 8 steps:
    quant_attention, L a step after the bootstrap; `scan_check`), the paged
    batcher with bf16 and with int8 attention (batched_paged_attention or
    batched_paged_attention_a8, and paged_unpack, L a step; `_step_vs_cpu`
    for each), `cache_attend`, and the
    sampler, the scan sampler and both batchers replayed against eager bit
    for bit."""
    from diffusion_llm_rs_tpu_torch.engine import Engine
    from diffusion_llm_rs_tpu_torch.models import denoiser as dn
    from diffusion_llm_rs_tpu_torch.models.diffusion import (
        DiffusionSchedule, sample)
    from diffusion_llm_rs_tpu_torch.serving import PagedContinuousBatcher

    out, total, wide = {}, {}, {}
    for heads in WIDE_HEADS:
        t0 = time.perf_counter()
        cfg, params = full_width_model(max_seq=2048, heads=heads)
        L, hd = cfg.num_layers, cfg.hidden_size // heads
        MODEL.update(cfg=cfg, params=params)  # `_serve_cfg`, `_step_vs_cpu`
        log(f"  {heads} heads of {hd}: model built in "
            f"{time.perf_counter() - t0:.1f} s")
        schedule = DiffusionSchedule.create(cfg.num_timesteps, device="cuda")
        runs = {}

        def call(name, fn, want):
            res, wall, counts = _timed_part(fn)
            _expect(f"heads_wide {hd} {name}", counts, want)
            log(f"  heads of {hd}, {name}: {wall:.3f} s, launches {counts}")
            runs[name] = dict(wall_s=wall, counts=counts)
            return res

        def in_range(name, tokens, shape):
            if tuple(tokens.shape) != shape or int(tokens.min()) < 0 or \
                    int(tokens.max()) >= cfg.vocab_size:
                raise AssertionError(f"heads of {hd}, {name}: token ids "
                                     f"{tuple(tokens.shape)} out of range")

        # the one-shot sampler at S = 1024: dense_attention
        _, model_fn = _sampler(cfg, params, "cuda")
        gen = torch.Generator(device="cuda").manual_seed(5)
        x = call("sample B=2 S=1024", lambda: sample(
            model_fn, schedule, (2, 1024, cfg.hidden_size), gen, num_steps=2),
            _expected_launches(cfg, 2, long_seq=True))
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"heads of {hd}: sample is not finite")
        in_range("sample", dn.decode_tokens(params, x), (2, 1024))
        xb = torch.randn((1, 1024, cfg.hidden_size), generator=gen,
                         device="cuda").to(torch.bfloat16)
        t = torch.full((1,), 500, device="cuda")
        e_card = call("forward B=1 S=1024", lambda: dn.denoiser_forward(
            params, cfg, xb, t), {"dense_attention": L}).float().cpu()
        c0 = time.perf_counter()
        cpu_params = _to(params, "cpu")
        e_cpu = dn.denoiser_forward(cpu_params, cfg, xb.cpu(),
                                    t.cpu()).float()
        rel = float((e_card - e_cpu).norm() / e_cpu.norm())
        log(f"  heads of {hd}: eps card vs CPU at S=1024 rel {rel:.3g} "
            f"(bound 2e-2; CPU {time.perf_counter() - c0:.1f} s)")
        if not rel <= 2e-2:
            raise AssertionError(f"heads of {hd}: the S=1024 forward "
                                 f"disagrees with the CPU")
        runs["eps_rel_err_s1024"] = rel

        # fused-QKV attention through `attend_fn`, as phase fused_qkv runs
        # it (heads of 96 in the wgmma design's instance of 128, of 256 in
        # its instance of 256, past 256 in its cluster kernel): L launches,
        # the card against the plain versions on the CPU within 2e-2, and
        # the forward captured in a CUDA graph and replayed bit for bit the
        # eager one (the cluster kernel's scratch of logits stays with the
        # graph)
        _wide_fused_forward(cfg, params, cpu_params, heads, gen, call, runs)
        del cpu_params

        # the scan sampler through the engine over this model's decoded W4A8
        # weights: its f32 activations reach the W4A8 kernels with an f32
        # residual; quant_attention
        eng = Engine(config=cfg, params=params, device="cuda")
        tokens = call("Engine.sample(use_paged=False) B=8 S=256", lambda:
                      eng.sample(batch_size=8, seq_len=256, num_steps=8,
                                 use_paged=False, return_text=False),
                      {**_expected_launches(cfg, 8, long_seq=False),
                       "quant_attention": L * 7, "dense_attention": 0})
        in_range("Engine.sample", tokens, (8, 256))
        del eng
        runs["scan_check"] = scan_check(cfg, params, (1, 128), seed=73)

        # paged serving, bf16 and int8 attention
        c4 = _serve_cfg(prefill_bits=4, decode_bits=4,
                        progressive_precision=False)

        def batcher(act_bits):
            b = PagedContinuousBatcher(
                params, c4, num_slots=2, seq_len=2048, page_size=128,
                attend_mode="auto", keep_embeddings=False,
                attn_act_bits=act_bits, seed=41)
            if b.attend_mode != "paged" or b.buckets != (4,):
                raise AssertionError(f"mode {b.attend_mode}, buckets "
                                     f"{b.buckets}")
            return b

        for act_bits, kernel in ((16, "batched_paged_attention"),
                                 (8, "batched_paged_attention_a8")):
            name = f"serve S=2048 act {act_bits}"
            run = _serve(f"heads_wide {hd} {name}", batcher(act_bits),
                         [(f"r{i}", 2048, 2) for i in range(4)])
            other = ({"batched_paged_attention", "batched_paged_attention_a8"}
                     - {kernel}).pop()
            _expect(f"heads_wide {hd} {name}", run["counts"], {
                kernel: L * run["steps"], other: 0,
                "paged_unpack": L * run["steps"], "dense_attention": 0})
            runs[name] = run
            runs[f"step_check act {act_bits}"] = _step_vs_cpu(act_bits, kernel)

        # PagedKVCache.attend: paged_attention
        runs["cache_attend"] = cache_attend(BH=heads, S=1024, D=hd, page=64,
                                            seed=39)

        # each replaying path again, eager and replayed, bit for bit, as
        # the `graphs` phase runs them (warmed, then timed)
        paths = _graph_paths(cfg, params, shape=(2, 1024), steps=8,
                             serve_len=2048, serve_steps=4)
        for name, path in (("sample", "sampler"),
                           ("scan_sampler", "scan_sampler"),
                           ("serve act 16", "serve_paged"),
                           ("serve act 8", "serve_paged_a8")):
            runs[f"replayed {name}"] = _eager_vs_replayed(
                f"heads of {hd} {name}", paths[path])
        for name, r in runs.items():
            if name.startswith("replayed"):
                continue  # the same calls again
            for k, n in ((r.get("counts") or {}) if isinstance(r, dict)
                         else {}).items():
                total[k] = total.get(k, 0) + n
                if hd > WIDE_FROM:
                    wide[k] = wide.get(k, 0) + n
        out[f"heads of {hd}"] = runs
        MODEL.pop("cfg")
        MODEL.pop("params")
        del params
        gc.collect()
        torch.cuda.empty_cache()
    # past 2048: one head of 2560 at width 2560 (the cluster design with
    # blocks of 2 slices of 256 columns, clusters of 5), 2 layers (cut from
    # 12 to keep the call's time), every path that runs that design: the
    # S = 1024 sampler (dense_attention), the fused-QKV forward at S = 256,
    # the scan sampler (quant_attention at 8, 4 and 2 bits), the paged
    # batcher with bf16 and with int8 attention (batched_paged_attention,
    # batched_paged_attention_a8) and `PagedKVCache.attend` (paged_attention
    # at 8, 4 and 2 bits)
    t0 = time.perf_counter()
    cfg, params = full_width_model(max_seq=2048, heads=1, hidden=2560,
                                   layers=2)
    L = cfg.num_layers
    MODEL.update(cfg=cfg, params=params)  # `_serve_cfg`, `_step_vs_cpu`
    log(f"  one head of 2560, {L} layers: model built in "
        f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(7)
    runs = {}

    def call(name, fn, want):
        res, wall, counts = _timed_part(fn)
        _expect(f"heads_wide 2560 {name}", counts, want)
        log(f"  heads of 2560, {name}: {wall:.3f} s, launches {counts}")
        runs[name] = dict(wall_s=wall, counts=counts)
        return res

    # the one-shot sampler at S = 1024: dense_attention, L a step, and one
    # forward at B=1, S=1024 against the CPU
    schedule = DiffusionSchedule.create(cfg.num_timesteps, device="cuda")
    _, model_fn = _sampler(cfg, params, "cuda")
    x = call("sample B=2 S=1024", lambda: sample(
        model_fn, schedule, (2, 1024, cfg.hidden_size), gen, num_steps=2),
        _expected_launches(cfg, 2, long_seq=True))
    tokens = dn.decode_tokens(params, x)
    if not bool(torch.isfinite(x).all()) or tuple(tokens.shape) != (
            2, 1024) or int(tokens.min()) < 0 or \
            int(tokens.max()) >= cfg.vocab_size:
        raise AssertionError("heads of 2560: sample is not finite or its "
                             "token ids are out of range")
    xb = torch.randn((1, 1024, cfg.hidden_size), generator=gen,
                     device="cuda").to(torch.bfloat16)
    t = torch.full((1,), 500, device="cuda")
    e_card = call("forward B=1 S=1024", lambda: dn.denoiser_forward(
        params, cfg, xb, t), {"dense_attention": L}).float().cpu()
    cpu_params = _to(params, "cpu")
    e_cpu = dn.denoiser_forward(cpu_params, cfg, xb.cpu(), t.cpu()).float()
    rel = float((e_card - e_cpu).norm() / e_cpu.norm())
    log(f"  heads of 2560: eps card vs CPU at S=1024 rel {rel:.3g} (bound "
        f"2e-2)")
    if not rel <= 2e-2:
        raise AssertionError("heads of 2560: the S=1024 forward disagrees "
                             "with the CPU")
    runs["eps_rel_err_s1024"] = rel
    _wide_fused_forward(cfg, params, cpu_params, 1, gen, call, runs)
    del cpu_params

    # the scan sampler through the engine over this model's weights:
    # quant_attention at 8, 4 and 2 bits, L a step after the bootstrap
    eng = Engine(config=cfg, params=params, device="cuda")
    tokens = call("Engine.sample(use_paged=False) B=8 S=256", lambda:
                  eng.sample(batch_size=8, seq_len=256, num_steps=8,
                             use_paged=False, return_text=False),
                  {**_expected_launches(cfg, 8, long_seq=False),
                   "quant_attention": L * 7, "dense_attention": 0})
    if tuple(tokens.shape) != (8, 256) or int(tokens.min()) < 0 or \
            int(tokens.max()) >= cfg.vocab_size:
        raise AssertionError("heads of 2560: Engine.sample's token ids are "
                             "out of range")
    del eng
    runs["scan_check"] = scan_check(cfg, params, (1, 128), seed=79)

    # the paged batcher at S = 2048, pages of 128, 4-bit KV, bf16 and int8
    # attention: paged_unpack and batched_paged_attention(_a8), L a step
    for act_bits, kernel in ((16, "batched_paged_attention"),
                             (8, "batched_paged_attention_a8")):
        name = f"serve S=2048 act {act_bits}"
        batcher = PagedContinuousBatcher(
            params, _serve_cfg(prefill_bits=4, decode_bits=4,
                               progressive_precision=False),
            num_slots=2, seq_len=2048, page_size=128, attend_mode="auto",
            keep_embeddings=False, attn_act_bits=act_bits, seed=41)
        if batcher.attend_mode != "paged" or batcher.buckets != (4,):
            raise AssertionError(f"mode {batcher.attend_mode}, buckets "
                                 f"{batcher.buckets}")
        run = _serve(f"heads_wide 2560 {name}", batcher,
                     [(f"r{i}", 2048, 2) for i in range(4)])
        other = ({"batched_paged_attention", "batched_paged_attention_a8"}
                 - {kernel}).pop()
        _expect(f"heads_wide 2560 {name}", run["counts"], {
            kernel: L * run["steps"], other: 0,
            "paged_unpack": L * run["steps"], "dense_attention": 0})
        runs[name] = run
        del batcher
        runs[f"step_check act {act_bits}"] = _step_vs_cpu(act_bits, kernel)
    runs["cache_attend"] = cache_attend(BH=1, S=1024, D=2560, page=64,
                                        seed=43)

    # the samplers and the batchers again, eager and replayed, bit for bit
    paths = _graph_paths(cfg, params, shape=(2, 1024), steps=8,
                         serve_len=2048, serve_steps=4)
    for name, path in (("sample", "sampler"),
                       ("scan_sampler", "scan_sampler"),
                       ("serve act 16", "serve_paged"),
                       ("serve act 8", "serve_paged_a8")):
        runs[f"replayed {name}"] = _eager_vs_replayed(
            f"heads of 2560 {name}", paths[path])
    past = {}
    for name, r in runs.items():
        if name.startswith("replayed"):
            continue  # the same calls again
        for k, n in ((r.get("counts") or {}) if isinstance(r, dict)
                     else {}).items():
            for acc in (total, wide, past):
                acc[k] = acc.get(k, 0) + n
    out["heads of 2560 (2 layers)"] = runs
    MODEL.pop("cfg")
    MODEL.pop("params")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out["counts"] = total
    out["counts_wide"] = wide  # the launches at heads past 256
    out["counts_past_2048"] = past
    return out


def _wide_fused_forward(cfg, params, cpu_params, heads, gen, call, runs):
    """`heads_wide`'s fused-QKV path on one model: a forward with
    `attend_fn` running fused_qkv_attention at B=2, S=256, as phase
    fused_qkv runs it (L launches), the card against the plain versions on
    the CPU within 2e-2, and the forward captured in a CUDA graph and
    replayed bit for bit the eager one (the cluster kernel's scratch of
    logits stays with the graph)."""
    from diffusion_llm_rs_tpu_torch.models import denoiser as dn

    hd = cfg.hidden_size // heads
    attend = _fused_attend(heads)
    xf = torch.randn((2, 256, cfg.hidden_size), generator=gen,
                     device="cuda").to(torch.bfloat16)
    tf = torch.full((2,), 500, device="cuda")
    e_card = call(
        "fused-QKV forward B=2 S=256", lambda: dn.denoiser_forward(
            params, cfg, xf, tf, attend_fn=attend),
        {"fused_qkv_attention": cfg.num_layers,
         "dense_attention": 0}).float().cpu()
    e_cpu = dn.denoiser_forward(cpu_params, cfg, xf.cpu(), tf.cpu(),
                                attend_fn=attend).float()
    rel = float((e_card - e_cpu).norm() / e_cpu.norm())
    log(f"  heads of {hd}: fused-QKV eps card vs CPU rel {rel:.3g} "
        f"(bound 2e-2)")
    if not rel <= 2e-2:
        raise AssertionError(f"heads of {hd}: the fused-QKV forward "
                             f"disagrees with the CPU")
    runs["eps_rel_err_fused_qkv"] = rel
    runs["fused_qkv_replayed_equal"] = _replays_equal(
        lambda: dn.denoiser_forward(params, cfg, xf, tf, attend_fn=attend))
    if not runs["fused_qkv_replayed_equal"]:
        raise AssertionError(f"heads of {hd}: the replayed fused-QKV "
                             f"forward differs from the eager one")


def _serve_cfg(**quant):
    from diffusion_llm_rs_tpu_torch.config import PhaseQuantConfig
    return dataclasses.replace(MODEL["cfg"],
                               quant_config=PhaseQuantConfig(**quant))


def _busy_share(b, seq_len, steps=8):
    """Device-busy share of serving with every slot occupied, on the path
    the timed windows run: one `b.step()` that admits a request per slot,
    runs them as one fused chunk of `steps` steps and launches the readout.
    The call runs twice: timed by the wall clock alone, then under
    torch.profiler for its kernel time (the profiler slows the host, so its
    own wall is not the step's). Busy share = kernel time / unprofiled
    wall. One untimed chunk first, so a replayed path's step graph is
    captured before the timed ones."""
    from diffusion_llm_rs_tpu_torch.serving import Request
    from diffusion_llm_rs_tpu_torch.utils.metrics import metrics

    def chunk(call):
        for i in range(b.num_slots):
            b.submit(Request(f"profile{i}", seq_len, num_steps=steps))
        steps0 = metrics.get("batcher.steps")
        torch.cuda.synchronize()
        out = call()
        ran = int(metrics.get("batcher.steps") - steps0)
        done = b.run_until_drained()
        if ran != steps or len(done) != b.num_slots:
            raise AssertionError(f"profiled call ran {ran} steps, "
                                 f"{len(done)} completions")
        return out

    def timed():
        t0 = time.perf_counter()
        b.step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    chunk(b.step)
    wall_ms = chunk(timed)
    prof_wall_ms, busy_ms, rows = chunk(lambda: _device_time(b.step, 1))
    share = busy_ms / wall_ms if rows else None
    # the paged attention's two kernels (csrc/paged_unpack.cu, the attention
    # of csrc/paged_flash.cuh) a step
    unpack_ms = sum(us for us, _, key in rows if "paged_unpack_kernel" in key)
    flash_ms = sum(us for us, _, key in rows if "paged_flash_kernel" in key)
    log(f"  paged attention a step: {flash_ms / 1e3 / steps:.4f} ms attention "
        f"+ {unpack_ms / 1e3 / steps:.4f} ms unpack")
    log(f"  one chunk of {steps} steps: wall {wall_ms:.2f} ms (under the "
        f"profiler {prof_wall_ms:.2f}), kernels {busy_ms:.2f} ms; per step "
        f"{wall_ms / steps:.2f} ms wall, {busy_ms / steps:.2f} ms kernels "
        f"({'not measured' if share is None else f'{share:.1%} busy'})")
    for us, n, key in rows[:8]:
        log(f"  {us / 1e3:8.4f} ms  x{n:<4d} {key[:90]}")
    families = _family_ms(rows, steps)
    # NCCL's kernels (the sharded batcher's collectives)
    nccl = [dict(ms=us / 1e3, calls=n, name=key[:120])
            for us, n, key in rows if "nccl" in key.lower()]
    return dict(chunk_steps=steps, step_wall_ms=wall_ms / steps, nccl=nccl,
                step_profiled_wall_ms=prof_wall_ms / steps,
                step_device_ms=busy_ms / steps, busy_share=share,
                step_paged_attention_ms=flash_ms / 1e3 / steps,
                step_paged_unpack_ms=unpack_ms / 1e3 / steps,
                step_family_ms=families,
                top=[dict(ms=us / 1e3, calls=n, name=key[:120])
                     for us, n, key in rows[:8]])


def _serve(name, b, requests, kept=None):
    """Submit `requests` [(id, seq_len, steps)] at once and drain, timed from
    the first submit to the last readout; launch counts reset just before.
    Checks every token id, and every kept embedding's finiteness."""
    from diffusion_llm_rs_tpu_torch.ops import _build
    from diffusion_llm_rs_tpu_torch.serving import Request
    from diffusion_llm_rs_tpu_torch.utils.metrics import metrics

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps0 = metrics.get("batcher.steps")
    graphs0 = _graph_counters()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    for rid, seq_len, steps in requests:
        b.submit(Request(rid, seq_len, steps))
    done = b.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    moved = _graph_counters(graphs0)
    counts = dict(_build.launch_counts)
    steps = int(metrics.get("batcher.steps") - steps0)
    peak = torch.cuda.max_memory_allocated()
    if sorted(c.request_id for c in done) != sorted(r[0] for r in requests):
        raise AssertionError(f"{name}: completions {[c.request_id for c in done]}")
    vocab = b.cfg.vocab_size
    for c in done:
        if c.tokens.min() < 0 or c.tokens.max() >= vocab:
            raise AssertionError(f"{name}: token ids out of range")
        if c.embeddings is not None and not np.isfinite(c.embeddings).all():
            raise AssertionError(f"{name}: {c.request_id} is not finite")
    if kept is not None:
        kept.extend(done)
    tokens = sum(len(c.tokens) for c in done)
    lat = [c.latency_s for c in done]
    p50 = statistics.median(lat)
    out = dict(requests=len(done), tokens=tokens, steps=steps, wall_s=wall,
               tokens_per_s=tokens / wall, latency_p50_s=p50,
               latency_max_s=max(lat), peak_bytes=peak, counts=counts,
               graph_replays=moved["replays"],
               graph_captures=moved["captures"])
    log(f"  {len(done)} requests, {steps} steps in {wall:.3f} s: "
        f"{tokens / wall:.1f} generated tokens/s; latency p50 "
        f"{p50:.3f} s, max {max(lat):.3f} s; peak memory "
        f"{peak / 2**20:.1f} MiB; launches {counts}")
    return out


def _expect(name, counts, want):
    for kernel, n in want.items():
        if counts.get(kernel, 0) != n:
            raise AssertionError(f"{name}: {kernel} {counts.get(kernel, 0)} "
                                 f"launches, expected {n}")


def serve_paged():
    """JAX's long-sequence serving bench at full width: S=4096, 2 slots,
    pages of 128, 4-bit KV in both phases, salience routing, 2 GiB HBM
    budget. One warm request of 8 steps, then 4 requests of 8 steps."""
    from diffusion_llm_rs_tpu_torch.serving import PagedContinuousBatcher

    cfg = _serve_cfg(prefill_bits=4, decode_bits=4,
                     progressive_precision=False)
    b = PagedContinuousBatcher(
        MODEL["params"], cfg, num_slots=2, seq_len=4096, page_size=128,
        attend_mode="auto", salience_routing=True, hbm_budget_bytes=2 << 30,
        keep_embeddings=False, seed=41)
    if b.attend_mode != "paged" or b.buckets != (4,):
        raise AssertionError(f"mode {b.attend_mode}, buckets {b.buckets}")
    _serve("serve_paged warm", b, [("warm", 4096, 8)])
    run = _serve("serve_paged", b, [(f"r{i}", 4096, 8) for i in range(4)])
    L, steps = cfg.num_layers, run["steps"]
    _expect("serve_paged", run["counts"], {
        "batched_paged_attention": L * steps, "paged_unpack": L * steps,
        "int8w_matmul": (3 + 2 * L) * steps,
        "int8w_mlp": L * steps, "dense_attention": 0})
    run.update(_busy_share(b, 4096), pool_bytes=b.cache_memory_bytes())
    return run


def serve_paged_a8():
    """serve_paged with attn_act_bits=8: every layer of every step attends
    through the int8 paged kernel (12 launches a step, none of the bf16
    kernel). Then one a8 step against the CPU, and a chunk of 4 steps at
    S=512 whose slots walk 8 -> 2 -> 1 -> 1 bits: the 1-bit bucket, and only
    it, keeps the bf16 kernel."""
    from diffusion_llm_rs_tpu_torch.ops import _build
    from diffusion_llm_rs_tpu_torch.serving import PagedContinuousBatcher

    cfg = _serve_cfg(prefill_bits=4, decode_bits=4,
                     progressive_precision=False)
    b = PagedContinuousBatcher(
        MODEL["params"], cfg, num_slots=2, seq_len=4096, page_size=128,
        attend_mode="auto", salience_routing=True, hbm_budget_bytes=2 << 30,
        keep_embeddings=False, attn_act_bits=8, seed=41)
    if b.attend_mode != "paged" or b.buckets != (4,):
        raise AssertionError(f"mode {b.attend_mode}, buckets {b.buckets}")
    _serve("serve_paged_a8 warm", b, [("warm", 4096, 8)])
    run = _serve("serve_paged_a8", b, [(f"r{i}", 4096, 8) for i in range(4)])
    L, steps = cfg.num_layers, run["steps"]
    _expect("serve_paged_a8", run["counts"], {
        "batched_paged_attention_a8": L * steps, "batched_paged_attention": 0,
        "paged_unpack": L * steps, "int8w_matmul": (3 + 2 * L) * steps,
        "int8w_mlp": L * steps})
    run.update(_busy_share(b, 4096), pool_bytes=b.cache_memory_bytes())
    del b
    run["step_check"] = _step_vs_cpu(8, "batched_paged_attention_a8")

    cfg = _serve_cfg(prefill_bits=8, decode_bits=2, min_decode_bits=1)
    b = PagedContinuousBatcher(MODEL["params"], cfg, num_slots=2, seq_len=512,
                               page_size=64, attend_mode="paged",
                               keep_embeddings=False, attn_act_bits=8, seed=45)
    chunks = []
    pick = b._used_buckets_chunk
    b._used_buckets_chunk = lambda *a: chunks.append(pick(*a)) or chunks[-1]
    mixed = _serve("serve_paged_a8 mixed widths", b,
                   [("m0", 512, 4), ("m1", 512, 4)])
    del b._used_buckets_chunk
    want16 = sum(L * 4 for u in chunks if 1 in u)
    want8 = sum(L * 4 * len([w for w in u if w != 1]) for u in chunks)
    log(f"  mixed widths: chunks {chunks}; launches {mixed['counts']}")
    if len(chunks) != 1 or not {8, 2, 1} <= set(chunks[0]):
        raise AssertionError(f"mixed widths: chunks {chunks}")
    _expect("serve_paged_a8 mixed widths", mixed["counts"], {
        "batched_paged_attention": want16,
        "batched_paged_attention_a8": want8, "paged_unpack": want16 + want8})
    run["mixed_counts"] = mixed["counts"]
    run["mixed_buckets"] = [list(u) for u in chunks]
    return run


def serve_phase():
    """The default phase schedule (8 bits, then 4 falling to 2: buckets 2,
    4 and 8) at S=2048 with pages of 64, the page Engine.sample picks; 8
    requests alternating 16 and 6 steps over 4 slots, so admissions land
    mid-run, slots cross the phase boundary and partials merge across
    buckets."""
    from diffusion_llm_rs_tpu_torch.serving import PagedContinuousBatcher

    cfg = _serve_cfg()
    b = PagedContinuousBatcher(MODEL["params"], cfg, num_slots=4,
                               seq_len=2048, page_size=64, attend_mode="auto",
                               keep_embeddings=True, seed=43)
    if b.attend_mode != "paged" or b.buckets != (2, 4, 8):
        raise AssertionError(f"mode {b.attend_mode}, buckets {b.buckets}")
    chunks = []
    pick = b._used_buckets_chunk
    b._used_buckets_chunk = lambda *a: chunks.append(pick(*a)) or chunks[-1]
    run = _serve("serve_phase", b, [(f"p{i}", 2048, 16 if i % 2 == 0 else 6)
                                    for i in range(8)])
    del b._used_buckets_chunk
    L, steps = cfg.num_layers, run["steps"]
    n = run["counts"].get("batched_paged_attention", 0)
    multi = sum(len(u) > 1 for u in chunks)
    log(f"  {len(chunks)} chunks, {multi} of them over more than one bucket: "
        f"{chunks}")
    if not L * steps <= n <= 3 * L * steps:
        raise AssertionError(f"serve_phase: {n} paged launches for {steps} "
                             f"steps, expected {L * steps}..{3 * L * steps}")
    _expect("serve_phase", run["counts"], {
        "paged_unpack": n, "int8w_matmul": (3 + 2 * L) * steps,
        "int8w_mlp": L * steps})
    run.update(_busy_share(b, 2048), chunks=len(chunks),
               multi_bucket_chunks=multi, pool_bytes=b.cache_memory_bytes())
    return run


def serve_dense():
    """Short-S serving as JAX's serving bench runs it: S=256, 8 slots,
    pages of 128, auto (the dense fake-quant mode, no pools, no paged
    kernel); 48 requests of 12 steps."""
    from diffusion_llm_rs_tpu_torch.serving import PagedContinuousBatcher

    cfg = _serve_cfg()
    b = PagedContinuousBatcher(MODEL["params"], cfg, num_slots=8, seq_len=256,
                               page_size=128, attend_mode="auto",
                               keep_embeddings=False, seed=47)
    if b.attend_mode != "dense" or b.pools:
        raise AssertionError(f"mode {b.attend_mode}")
    _serve("serve_dense warm", b, [("warm", 256, 2)])
    run = _serve("serve_dense", b, [(f"d{i}", 256, 12) for i in range(48)])
    L, steps = cfg.num_layers, run["steps"]
    _expect("serve_dense", run["counts"], {
        "batched_paged_attention": 0, "paged_unpack": 0,
        "int8w_matmul": (3 + 2 * L) * steps, "int8w_mlp": L * steps})
    run.update(_busy_share(b, 256))
    return run


class _Recorded:
    """Noise source that keeps a CPU copy of every draw of another."""

    def __init__(self, inner):
        self.inner, self.draws = inner, []

    def admission(self, shape):
        x = self.inner.admission(shape)
        self.draws.append(x.cpu())
        return x

    step = admission


class _Replay:
    def __init__(self, draws):
        self.draws = list(draws)

    def admission(self, shape):
        return self.draws.pop(0)

    step = admission


def serve_check():
    return _step_vs_cpu(16, "batched_paged_attention")


def _step_vs_cpu(act_bits, kernel):
    """One serving step (max_chunk=1, paged, default phase config) at full
    width, S=512, 2 slots (the second 333 tokens: a partial page), pages of
    128, t=999 (8-bit prefill): kernels on the card against the twins on the
    CPU from the same noise. x within 2e-2 relative, and the step's update
    without its noise term (the eps part, beta_t / sqrt(1 - abar_t) /
    sqrt(alpha_t) * eps) within 2e-2, the sampler's eps bound: bf16 rounds
    at other points on the two sides and can move an act-quant or KV level.
    With `act_bits` 8 the step attends through the int8 paged kernel."""
    from diffusion_llm_rs_tpu_torch.models.diffusion import DiffusionSchedule
    from diffusion_llm_rs_tpu_torch.ops import _build
    from diffusion_llm_rs_tpu_torch.serving import (GeneratorNoise,
                                                    PagedContinuousBatcher,
                                                    Request)

    cfg = _serve_cfg()
    xs = {}
    rec = _Recorded(GeneratorNoise(53, "cuda"))
    for device, params, noise in (("cuda", MODEL["params"], rec),
                                  ("cpu", None, None)):
        if device == "cpu":
            params, noise = _to(MODEL["params"], "cpu"), _Replay(rec.draws)
        b = PagedContinuousBatcher(params, cfg, num_slots=2, seq_len=512,
                                   page_size=128, max_chunk=1,
                                   attend_mode="paged", keep_embeddings=False,
                                   attn_act_bits=act_bits, device=device,
                                   noise=noise)
        b.submit(Request("c0", 512, 1000))
        b.submit(Request("c1", 333, 1000))
        if device == "cuda":
            torch.cuda.synchronize()
            _build.reset_launch_counts()
        t0 = time.perf_counter()
        with graphs_disabled():  # card against CPU: both eager
            b.step()
        xs[device] = b.x.cpu()
        log(f"  one step on {device}: {time.perf_counter() - t0:.1f} s")
        if device == "cuda":
            counts = dict(_build.launch_counts)
    L = cfg.num_layers
    _expect("serve_check", counts, dict({
        name: L if name == kernel else 0 for name in (
            "batched_paged_attention", "batched_paged_attention_a8")},
        paged_unpack=L))
    sched = DiffusionSchedule.create(cfg.num_timesteps, device="cpu")
    t = 999
    base = (rec.draws[0] * torch.rsqrt(sched.alphas[t])
            + torch.sqrt(sched.posterior_variance[t]) * rec.draws[1])
    e_k, e_c = xs["cuda"] - base, xs["cpu"] - base
    rel_x = float((xs["cuda"] - xs["cpu"]).norm() / xs["cpu"].norm())
    rel_e = float((e_k - e_c).norm() / e_c.norm())
    log(f"  x rel err card vs CPU {rel_x:.3g} (bound 2e-2); eps part "
        f"{rel_e:.3g} (bound 2e-2); launches {counts}")
    if not (rel_x <= 2e-2 and rel_e <= 2e-2):
        raise AssertionError("serving step disagrees with its twins")
    return dict(x_rel_err=rel_x, eps_part_rel_err=rel_e, counts=counts)


# --------------------------------------------------------------- engine ---

ENGINE_TEXT = "the quick brown fox jumps over the lazy dog"


def _matmuls_per_forward(num_layers):
    """Linears of one denoiser forward: 2 time-MLP, 4 a block, 1 head."""
    return 2 + 4 * num_layers + 1


def _full_width_engine(act_bits):
    """`Engine` over a 12-layer, 768-wide, 12-head, vocab-50257 model with
    random weights from a seed, packed to int4 (symmetric, groups of 128) by
    `quantize_weights(4)`."""
    from diffusion_llm_rs_tpu_torch.config import (DiffusionConfig,
                                                   WeightQuantConfig)
    from diffusion_llm_rs_tpu_torch.engine import Engine
    from diffusion_llm_rs_tpu_torch.ops.matmul import MatmulWeight
    from diffusion_llm_rs_tpu_torch.quant.core import QuantizedTensor

    cfg = DiffusionConfig(num_timesteps=1000, hidden_size=768, num_layers=12,
                          num_attention_heads=12, vocab_size=50257,
                          max_sequence_length=1024, dtype="bfloat16",
                          weight_quant=WeightQuantConfig(act_bits=act_bits))
    eng = Engine(config=cfg, seed=0)
    eng.quantize_weights(4)
    p = eng.params
    # 50257 rows do not pack: the embedding stays a QuantizedTensor
    if not isinstance(p["tok_embed"], QuantizedTensor):
        raise AssertionError(f"tok_embed is {type(p['tok_embed']).__name__}")
    blk = p["blocks"][0]
    kinds = {"time_mlp.w1": p["time_mlp"]["w1"], "time_mlp.w2": p["time_mlp"]["w2"],
             "wqkv": blk["attn"]["wqkv"], "wo": blk["attn"]["wo"],
             "mlp.w1": blk["mlp"]["w1"], "mlp.w2": blk["mlp"]["w2"],
             "head.w": p["head"]["w"]}
    for name, w in kinds.items():
        if not (isinstance(w, MatmulWeight) and w.bits == 4
                and w.act_bits == act_bits and w.group_size == 128):
            raise AssertionError(f"{name} is not a packed int4 MatmulWeight")
    if eng.stats()["weight_bits"] != 4:
        raise AssertionError(f"stats {eng.stats()}")
    return eng


def _engine_packed(act_bits):
    from diffusion_llm_rs_tpu_torch.ops import _build

    kernel = "matmul_a8" if act_bits == 8 else "matmul"
    t0 = time.perf_counter()
    eng = _full_width_engine(act_bits)
    torch.cuda.synchronize()
    log(f"  engine built and packed in {time.perf_counter() - t0:.1f} s")
    cfg = eng.config
    per_fwd = _matmuls_per_forward(cfg.num_layers)
    B, S, steps = 8, 256, 32
    eng.sample(batch_size=B, seq_len=S, num_steps=2, return_text=False)  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    tokens = eng.sample(batch_size=B, seq_len=S, num_steps=steps, seed=3,
                        return_text=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(_build.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    b = eng._samplers[(B, S, False, "auto")]
    if b.attend_mode != "dense" or b.page_size != 64:
        raise AssertionError(f"mode {b.attend_mode}, page {b.page_size}")
    _expect("sample", counts, {kernel: per_fwd * steps, "int8w_matmul": 0,
                               "int8w_mlp": 0, "batched_paged_attention": 0,
                               "paged_unpack": 0})
    if tuple(tokens.shape) != (B, S) or int(tokens.min()) < 0 or \
            int(tokens.max()) >= cfg.vocab_size:
        raise AssertionError(f"token ids out of range: {tuple(tokens.shape)}")
    log(f"  sample B={B} S={S} steps={steps}: {wall:.4f} s, "
        f"{B * S / wall:.1f} generated tokens/s, peak memory "
        f"{peak / 2**20:.1f} MiB; launches {counts}")
    out = dict(counts=counts, wall_s=wall, tokens_per_s=B * S / wall,
               peak_bytes=peak)
    out.update(_busy_share(b, S))

    # the same facade in paged mode: pools, the batched paged kernel, packed
    # weights; 4 steps from t = 3 (the decode phase: bucket 2, maybe 4)
    _build.reset_launch_counts()
    tokens = eng.sample(batch_size=B, seq_len=S, num_steps=4, seed=4,
                        return_text=False, attend_mode="paged")
    torch.cuda.synchronize()
    paged = dict(_build.launch_counts)
    L = cfg.num_layers
    n = paged.get("batched_paged_attention", 0)
    if not L * 4 <= n <= 3 * L * 4 or paged.get(kernel, 0) != per_fwd * 4 \
            or paged.get("paged_unpack", 0) != n:
        raise AssertionError(f"paged mode launches {paged}")
    if int(tokens.min()) < 0 or int(tokens.max()) >= cfg.vocab_size:
        raise AssertionError("paged mode: token ids out of range")
    log(f"  sample attend_mode=paged, 4 steps: launches {paged}")

    # the scan sampler behind the facade: asked for, and taken because no
    # page divides the length; f32 activations into the packed kernel, the
    # packed KV carry into quant_attention (none in the bootstrap step)
    scan = {}
    for label, kw, n in (
            ("use_paged=False", dict(batch_size=B, seq_len=S, use_paged=False),
             8),
            ("seq_len=100", dict(batch_size=2, seq_len=100), 4)):
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        tokens = eng.sample(num_steps=n, seed=6, return_text=False, **kw)
        torch.cuda.synchronize()
        scan_s = time.perf_counter() - t0
        scan[label] = dict(_build.launch_counts)
        _expect(f"sample({label})", scan[label], {
            kernel: per_fwd * n, "quant_attention": L * (n - 1),
            "batched_paged_attention": 0, "batched_paged_attention_a8": 0,
            "paged_unpack": 0, "int8w_matmul": 0})
        if tuple(tokens.shape) != (kw["batch_size"], kw["seq_len"]) or \
                int(tokens.min()) < 0 or int(tokens.max()) >= cfg.vocab_size:
            raise AssertionError(f"sample({label}): token ids out of range")
        log(f"  sample({label}), {n} steps: {scan_s:.3f} s, launches "
            f"{scan[label]}")
    out["scan_counts"] = scan

    # greedy generate: one forward (f32 activations, ragged M) per new token
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    text = eng.generate("the quick", max_length=4)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    forwards = len(eng._ntp_cache)
    gen_counts = dict(_build.launch_counts)
    _expect("generate", gen_counts, {kernel: per_fwd * forwards,
                                     "int8w_matmul": 0})
    if not 1 <= forwards <= 4 or not isinstance(text, str):
        raise AssertionError(f"generate ran {forwards} forwards")
    again = eng.generate("the quick", max_length=4)
    if again != text or eng.generate_cache_hits != forwards:
        raise AssertionError("the next-token memo did not serve the repeat")
    _build.reset_launch_counts()
    ppl = eng.denoising_perplexity(ENGINE_TEXT, t=10)
    _expect("denoising_perplexity", dict(_build.launch_counts),
            {kernel: per_fwd})
    if not np.isfinite(ppl):
        raise AssertionError(f"perplexity {ppl}")
    log(f"  generate: {forwards} forwards in {gen_s:.3f} s, launches "
        f"{gen_counts}, {text!r}; denoising perplexity of a random model "
        f"{ppl:.1f} (finite)")
    out.update(paged_counts=paged, generate_forwards=forwards,
               generate_s=gen_s, perplexity=ppl)
    MODEL[f"engine{act_bits}"] = eng
    return out


def engine_packed():
    return _engine_packed(16)


def engine_packed_a8():
    return _engine_packed(8)


def engine_anchor():
    """The shipped trained checkpoint (6 layers, width 256, 8 heads of 32,
    vocab 463, f32 activations) through `Engine.from_pretrained()`, on the
    card and on the CPU: fp32 greedy continuations equal token for token;
    perplexity of a fixed text (noise from one CPU generator, given to both)
    under a tenth of the vocabulary, fp32 and after int4 packing; `sample`
    in range, at S=32 through the batcher's dense mode, at S=10 (which no
    page divides) through the scan sampler and `quant_attention` at heads of
    32, and at S=32 in paged mode through `batched_paged_attention` over
    pools of 4 heads a row and pages of 32."""
    from diffusion_llm_rs_tpu_torch.engine import Engine
    from diffusion_llm_rs_tpu_torch.ops import _build

    card, cpu = Engine.from_pretrained(), Engine.from_pretrained(device="cpu")
    text = "the forest maybe river the stone quick"
    n = len(card.tokenizer.encode(text))
    noise = torch.randn((1, n, card.config.hidden_size),
                        generator=torch.Generator().manual_seed(0))
    limit = card.tokenizer.vocab_size / 10
    out = {}
    for label in ("fp32", "int4"):
        if label == "int4":
            card.quantize_weights(4)
            cpu.quantize_weights(4)
        _build.reset_launch_counts()
        prompts = ("the quick", "a large house", "forest")
        got = [card.generate(p, max_length=8) for p in prompts]
        want = [cpu.generate(p, max_length=8) for p in prompts]
        ppl = card.denoising_perplexity(text, t=10, noise=noise)
        ppl_cpu = cpu.denoising_perplexity(text, t=10, noise=noise)
        tokens = card.sample(batch_size=4, seq_len=32, num_steps=8,
                             return_text=False)
        counts = dict(_build.launch_counts)
        log(f"  {label}: generate {got} (CPU {'equal' if got == want else want}); "
            f"perplexity {ppl:.3f} (CPU {ppl_cpu:.3f}, limit {limit:.1f}); "
            f"launches {counts}")
        if label == "fp32" and got != want:
            raise AssertionError("fp32 generate on the card differs from the CPU")
        if not all(isinstance(g, str) and g for g in got):
            raise AssertionError("generate returned nothing")
        if not (ppl < limit and abs(ppl - ppl_cpu) <= 2e-2 * ppl_cpu):
            raise AssertionError(f"{label} perplexity {ppl} vs CPU {ppl_cpu}")
        if int(tokens.min()) < 0 or int(tokens.max()) >= card.config.vocab_size:
            raise AssertionError("sample: token ids out of range")
        if (counts.get("matmul", 0) > 0) != (label == "int4"):
            raise AssertionError(f"{label}: matmul launches {counts}")
        out[label] = dict(generate=got, equal_to_cpu=got == want,
                          perplexity=ppl, perplexity_cpu=ppl_cpu, counts=counts)
        for name, kwargs, kernel in (
                ("seq_len=10", dict(seq_len=10), "quant_attention"),
                ("paged", dict(seq_len=32, attend_mode="paged"),
                 "batched_paged_attention")):
            _build.reset_launch_counts()
            tokens = card.sample(batch_size=4, num_steps=8, return_text=False,
                                 **kwargs)
            counts = dict(_build.launch_counts)
            log(f"  {label} sample({name}): tokens {tuple(tokens.shape)} in "
                f"[{int(tokens.min())}, {int(tokens.max())}]; launches {counts}")
            if int(tokens.min()) < 0 or \
                    int(tokens.max()) >= card.config.vocab_size:
                raise AssertionError(f"sample({name}): token ids out of range")
            if counts.get(kernel, 0) == 0:
                raise AssertionError(f"sample({name}) launched no {kernel}")
            if kernel == "batched_paged_attention" and \
                    counts.get("paged_unpack", 0) != counts[kernel]:
                raise AssertionError(f"sample({name}): {counts}")
            out[label][name] = dict(shape=list(tokens.shape), counts=counts)
    return out


def train_grad(cfg=None, seed=5):
    """One training gradient at S=1024 on `cfg`, by default a 2-layer f32
    model of the anchor's widths (256 wide, 8 heads of 32; random weights
    from a seed):
    `p_losses(...).mean().backward()` with attention through `flash_fold`
    (the dense_attention kernel with f32 out at the model's head width, then
    JAX's f32 VJP) and again through the einsum path (`flash_attn=False`). Every
    layer's q, k and v projections (the column blocks of wqkv) get a nonzero
    gradient, within 1e-2 relative of the einsum path's, the kernel's own
    bound on its output: its forward rounds q, k, v and P to bf16, which
    moves every later activation and so every gradient (the plain twin on
    the CPU: 4.1e-5)."""
    from diffusion_llm_rs_tpu_torch.config import DiffusionConfig
    from diffusion_llm_rs_tpu_torch.models import denoiser as dn
    from diffusion_llm_rs_tpu_torch.models.diffusion import (
        DiffusionSchedule, p_losses)
    from diffusion_llm_rs_tpu_torch.ops import _build

    cfg = cfg or DiffusionConfig(
        num_timesteps=1000, hidden_size=256, num_layers=2,
        num_attention_heads=8, vocab_size=463, max_sequence_length=1024,
        dtype="float32")
    g = torch.Generator(device="cuda").manual_seed(seed)
    params = dn.init_denoiser_params(g, cfg)
    wqkv = [blk["attn"]["wqkv"].requires_grad_() for blk in params["blocks"]]
    schedule = DiffusionSchedule.create(cfg.num_timesteps, device="cuda")
    x0 = torch.randn((2, 1024, cfg.hidden_size), generator=g, device="cuda")
    noise = torch.randn(x0.shape, generator=g, device="cuda")
    T = cfg.num_timesteps
    t = torch.tensor([T // 10, 7 * T // 10], device="cuda")
    grads, counts, loss = {}, {}, {}
    for flash in (True, False):
        _build.reset_launch_counts()
        loss[flash] = p_losses(
            lambda x, tt: dn.denoiser_forward(params, cfg, x, tt,
                                              flash_attn=flash),
            schedule, x0, t, noise).mean()
        grads[flash] = torch.autograd.grad(loss[flash], wqkv)
        torch.cuda.synchronize()
        counts[flash] = dict(_build.launch_counts)
    D = cfg.hidden_size
    rows = []
    for li in range(cfg.num_layers):
        for j, name in enumerate("qkv"):
            a = grads[True][li][:, j * D:(j + 1) * D]
            b = grads[False][li][:, j * D:(j + 1) * D]
            rows.append(dict(layer=li, proj=f"w{name}", norm=float(a.norm()),
                             rel=float((a - b).norm() / b.norm())))
    worst = max(r["rel"] for r in rows)
    loss = {k: float(v.detach()) for k, v in loss.items()}
    log(f"  loss {loss[True]:.6f} (einsum {loss[False]:.6f}); "
        f"launches {counts[True]} / {counts[False]}; wq/wk/wv gradient norms "
        f"{[round(r['norm'], 6) for r in rows]}; worst rel to einsum "
        f"{worst:.3g} (bound 1e-2)")
    if counts[True].get("dense_attention", 0) != cfg.num_layers or \
            counts[False].get("dense_attention", 0) != 0:
        raise AssertionError(f"dense_attention launches {counts}")
    if not all(r["norm"] > 0 and np.isfinite(r["norm"]) for r in rows):
        raise AssertionError(f"an attention projection got no gradient: {rows}")
    if worst > 1e-2:
        raise AssertionError(f"gradients differ from the einsum path: {rows}")
    return dict(loss=loss[True], loss_einsum=loss[False],
                grads=rows, counts=counts[True])


def engine_gptq():
    """`quantize_weights(4, method="gptq")` on the shipped anchor, on the
    card and on the CPU from the same calibration draws (a CPU generator
    seeded with 0 on both sides): scales and zero points bit for bit (static
    groups of the original weights); the packed bytes that differ counted
    (float64 sums in another order move near-ties, and true_sequential
    carries each into the later stages: ROADMAP C26); denoising perplexity
    of a fixed text on both within 2% and under a tenth of the vocabulary;
    then `generate` on the card through the packed kernel."""
    from diffusion_llm_rs_tpu_torch.engine import Engine
    from diffusion_llm_rs_tpu_torch.ops import _build
    from diffusion_llm_rs_tpu_torch.ops.matmul import MatmulWeight
    from diffusion_llm_rs_tpu_torch.quant.core import tree_leaves

    engines, secs = {}, {}
    for device in ("cuda", "cpu"):
        eng = Engine.from_pretrained(device=device)
        t0 = time.perf_counter()
        eng.quantize_weights(4, method="gptq",
                             noise=torch.Generator().manual_seed(0))
        if device == "cuda":
            torch.cuda.synchronize()
        secs[device] = time.perf_counter() - t0
        engines[device] = eng
    card, cpu = engines["cuda"], engines["cpu"]
    a = [l for l in tree_leaves(card.params) if isinstance(l, MatmulWeight)]
    b = [l for l in tree_leaves(cpu.params) if isinstance(l, MatmulWeight)]
    if len(a) != len(b) or len(a) != _matmuls_per_forward(
            card.config.num_layers):
        raise AssertionError(f"{len(a)} / {len(b)} packed weights")
    sides_equal = all(
        torch.equal(x.scale.cpu(), y.scale) and
        torch.equal(x.zero_point.cpu(), y.zero_point) for x, y in zip(a, b))
    moved = sum(int((x.data.cpu() != y.data).sum()) for x, y in zip(a, b))
    total = sum(y.data.numel() for y in b)
    text = "the forest maybe river the stone quick"
    n = len(card.tokenizer.encode(text))
    noise = torch.randn((1, n, card.config.hidden_size),
                        generator=torch.Generator().manual_seed(0))
    ppl = card.denoising_perplexity(text, t=10, noise=noise)
    ppl_cpu = cpu.denoising_perplexity(text, t=10, noise=noise)
    _build.reset_launch_counts()
    got = card.generate("the quick", max_length=8)
    counts = dict(_build.launch_counts)
    limit = card.tokenizer.vocab_size / 10
    log(f"  GPTQ {secs['cuda']:.2f} s on the card, {secs['cpu']:.2f} s on the "
        f"CPU; scales and zero points {'bit for bit' if sides_equal else 'DIFFER'}"
        f"; {moved} of {total} packed bytes differ; perplexity {ppl:.4f} (CPU "
        f"{ppl_cpu:.4f}, limit {limit:.1f}); generate {got!r}, launches "
        f"{counts}")
    if not sides_equal:
        raise AssertionError("GPTQ grids differ between the card and the CPU")
    if not (ppl < limit and abs(ppl - ppl_cpu) <= 2e-2 * ppl_cpu):
        raise AssertionError(f"perplexity {ppl} vs CPU {ppl_cpu}")
    if not (isinstance(got, str) and got and counts.get("matmul", 0) > 0):
        raise AssertionError(f"generate {got!r}, launches {counts}")
    return dict(gptq_s=secs, packed_bytes_differ=moved, packed_bytes=total,
                perplexity=ppl, perplexity_cpu=ppl_cpu, generate=got,
                counts=counts)


def engine_gptq_shipped():
    """The six shipped GPTQ checkpoints on the card and on the CPU: each
    loaded with `load_checkpoint(path, like=<the anchor's parameters>)`, every
    2-D leaf prepared at act 16 and at act 8 (`bench_quality.py:298-306`: a
    leaf whose `prepare` raises stays unprepared; none does), an `Engine`
    over the prepared tree; one `denoising_perplexity` of a fixed text from
    one CPU draw of noise: exactly one `matmul` (act 16) or `matmul_a8` (act
    8) launch a prepared leaf in the forward (27: the 4 linears of 6 layers,
    the time MLP's two and the head), and the card's perplexity within 2e-3
    (act 16: one bf16 rounding of the activations can move, ROADMAP C14) or
    5e-3 (act 8: an int8 level, C1, C7) of the CPU's, the bounds of
    tests/test_torch_gptq_checkpoints.py against JAX. The checkpoints are
    `benchmarks/bench_quality.py:262`'s raw QuantizedTensor trees of the two
    trained anchors."""
    import os

    from diffusion_llm_rs_tpu_torch.engine import Engine
    from diffusion_llm_rs_tpu_torch.ops import _build
    from diffusion_llm_rs_tpu_torch.ops.int8_matmul import prepare
    from diffusion_llm_rs_tpu_torch.quant.core import (QuantizedTensor,
                                                       map_leaves, tree_leaves)
    from diffusion_llm_rs_tpu_torch.utils.serialization import load_checkpoint

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "benchmarks")
    text = "the forest maybe river the stone quick"
    out, bad = {}, []
    for anchor in ("quality_anchor", "quality_anchor_real"):
        base = {d: Engine.from_pretrained(os.path.join(root, anchor),
                                          device=d) for d in ("cuda", "cpu")}
        n = len(base["cpu"].tokenizer.encode(text))
        noise = torch.randn((1, n, base["cpu"].config.hidden_size),
                            generator=torch.Generator().manual_seed(0))
        for bits in (1, 2, 4):
            path = os.path.join(root, f"{anchor}.gptq{bits}g128")
            raw = {d: load_checkpoint(path, like=e.params, device=d)
                   for d, e in base.items()}
            for act in (16, 8):
                kernel = "matmul" if act == 16 else "matmul_a8"
                ppl, prepared = {}, {}
                for d, e in base.items():
                    kept = []

                    def prep(path_, leaf):
                        if isinstance(leaf, QuantizedTensor) and leaf.ndim == 2:
                            try:
                                return prepare(leaf, act_bits=act)
                            except ValueError:
                                kept.append(path_)
                        return leaf
                    eng = Engine(config=e.config, tokenizer=e.tokenizer,
                                 params=map_leaves(prep, raw[d]), device=d)
                    prepared[d] = (sum(isinstance(l, QuantizedTensor) and
                                       l.ndim == 2 for l in
                                       tree_leaves(raw[d])) - len(kept), kept)
                    _build.reset_launch_counts()
                    ppl[d] = eng.denoising_perplexity(text, t=10, noise=noise)
                    if d == "cuda":
                        torch.cuda.synchronize()
                        counts = dict(_build.launch_counts)
                rel = abs(ppl["cuda"] - ppl["cpu"]) / ppl["cpu"]
                label = f"{anchor}.gptq{bits}g128 act {act}"
                ok = (prepared["cuda"] == prepared["cpu"] and
                      counts == {kernel: prepared["cuda"][0]} and
                      np.isfinite(ppl["cuda"]) and
                      rel <= {16: 2e-3, 8: 5e-3}[act])
                log(f"  {label}: {prepared['cuda'][0]} leaves prepared "
                    f"({len(prepared['cuda'][1])} left); perplexity on the "
                    f"card {ppl['cuda']:.6g} (CPU {ppl['cpu']:.6g}, rel "
                    f"{rel:.3g}); launches {counts} {'ok' if ok else 'BAD'}")
                if not ok:
                    bad.append(label)
                out[label] = dict(perplexity=ppl["cuda"],
                                  perplexity_cpu=ppl["cpu"], rel=rel,
                                  prepared=prepared["cuda"][0], counts=counts)
    if bad:
        raise AssertionError(f"shipped GPTQ checkpoints: {bad}")
    total = {}
    for r in out.values():
        for k, v in r["counts"].items():
            total[k] = total.get(k, 0) + v
    return dict(checkpoints=out, counts=total)


def examples():
    """The four torch examples through `main(device="cuda")`, each timed
    with its launch counts; the serving example (JAX's tiny model, 4 heads
    of 16) must launch the batched paged kernels, one `paged_unpack` each,
    and serve every request of its three tiers."""
    import importlib
    import os

    from diffusion_llm_rs_tpu_torch.ops import _build

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "examples"))
    out = {}
    for name in ("torch_serving_example", "torch_diffusion_example",
                 "torch_quantization_basic", "torch_hello_workspace"):
        mod = importlib.import_module(name)
        res, wall, counts = _timed_part(lambda: mod.main(device="cuda"))
        log(f"  {name}: {wall:.2f} s, launches {counts}")
        out[name] = dict(wall_s=wall, counts=counts)
        if name == "torch_serving_example":
            n = counts.get("batched_paged_attention", 0)
            served = {k: len(res[k]) for k in ("phase", "salient", "sharded")}
            log(f"  serving example: {n} batched paged launches at heads of "
                f"16, completions {served}")
            if n == 0 or counts.get("paged_unpack", 0) != n or \
                    set(served.values()) != {4}:
                raise AssertionError(f"serving example: {counts}, {served}")
        if name == "torch_diffusion_example" and \
                not bool(torch.isfinite(res).all()):
            raise AssertionError("diffusion example: samples not finite")
    out["counts"] = out["torch_serving_example"]["counts"]
    return out


# phrases of the ingested text: repeated, so the dedup store and the index
# see identical rows (a repeated word embeds identically)
INGEST_PHRASES = (
    "the quick brown fox jumps over the lazy dog",
    "diffusion language models denoise token embeddings step by step",
    "quantized key value caches keep memory small and inference fast",
    "the lazy dog sleeps while the quick brown fox runs",
)


def _ingest_text(tokenizer, tokens=512):
    """About `tokens` tokens of INGEST_PHRASES, cycled and joined."""
    words, i = [], 0
    while len(tokenizer.encode(" ".join(words))) < tokens:
        words += INGEST_PHRASES[i % len(INGEST_PHRASES)].split()
        i += 1
    while len(tokenizer.encode(" ".join(words))) > tokens:
        words.pop()
    return " ".join(words)


def _timed(obj, name, secs, sync):
    """Wrap obj.name to add its wall seconds (after a device sync) to
    secs[name]."""
    fn = getattr(obj, name)

    def run(*a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        sync()
        secs[name] = secs.get(name, 0.0) + time.perf_counter() - t0
        return out
    setattr(obj, name, run)


def engine_ingest():
    """The host-side stack at full width: `Engine` (12 layers, 768 wide, 12
    heads, vocab 50257, random weights from a seed) on the card, with its
    store under build/, and a second engine over the same parameters on the
    CPU. `process_model` on about 512 tokens of repeated phrases, then
    `prefill` of the text, again, and prefix-extended. Card against CPU:
    compressed rows bit for bit, the index's top 16 ids for 8 queries equal
    and their similarities within 1e-5, the router's shards and edges, the
    prefill vectors and `stats` equal, every stored vector read back, the
    prompt cache's hits as JAX's tests expect; seconds by part on each."""
    import os
    import shutil

    from diffusion_llm_rs_tpu_torch.config import (DiffusionConfig,
                                                   SystemConfig)
    from diffusion_llm_rs_tpu_torch.engine import Engine
    from diffusion_llm_rs_tpu_torch.index.anns import compress_rows
    from diffusion_llm_rs_tpu_torch.ops import _build
    from diffusion_llm_rs_tpu_torch.storage import native

    store = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                         "ingest_smoke")
    shutil.rmtree(store, ignore_errors=True)
    cfg = DiffusionConfig(num_timesteps=1000, hidden_size=768, num_layers=12,
                          num_attention_heads=12, vocab_size=50257,
                          max_sequence_length=1024, dtype="bfloat16")
    card = Engine(config=cfg, seed=0, device="cuda", system_config=SystemConfig(
        ssd_path=os.path.join(store, "card.bin")))
    cpu = Engine(config=cfg, params=_to(card.params, "cpu"),
                 tokenizer=card.tokenizer, device="cpu",
                 system_config=SystemConfig(
                     ssd_path=os.path.join(store, "cpu.bin")))
    text = _ingest_text(card.tokenizer)
    n_tok = len(card.tokenizer.encode(text))
    secs = {}
    for side, eng in (("cuda", card), ("cpu", cpu)):
        sync = torch.cuda.synchronize if side == "cuda" else (lambda: None)
        s = secs[side] = {}
        for obj, name in ((eng, "process_model"), (eng, "prefill"),
                          (eng.dedup, "store_vectors"),
                          (eng.router, "update_routing"),
                          (eng.anns, "index_compressed")):
            _timed(obj, name, s, sync)
    _build.reset_launch_counts()
    out = {}
    for side, eng in (("cuda", card), ("cpu", cpu)):
        t0 = time.perf_counter()
        r = eng.process_model(text)
        n1 = eng.prefill(text)
        n2 = eng.prefill(text)
        hits = eng.prefill_prefix_hits
        ext = text + " and the quick brown fox"
        n3 = eng.prefill(ext)
        out[side] = dict(process=r, new=(n1, n2, n3), hits=hits,
                         total=len(eng.tokenizer.encode(ext)),
                         wall_s=time.perf_counter() - t0)
        if side == "cuda":
            counts = dict(_build.launch_counts)
    c, p = out["cuda"], out["cpu"]
    log(f"  text of {n_tok} tokens; native runtime "
        f"{'built' if native.NATIVE_AVAILABLE else 'MISSING'}; card "
        f"{c['process']} new {c['new']}, CPU {p['process']} new {p['new']}; "
        f"kernel launches {counts}")
    for side in secs:
        log(f"  {side}: whole {out[side]['wall_s']:.2f} s; " + ", ".join(
            f"{k} {v:.3f} s" for k, v in secs[side].items()))
    bad = []
    if c["process"] != p["process"] or c["new"] != p["new"] or \
            c["hits"] != p["hits"]:
        bad.append("process_model / prefill counts differ")
    n1, n2, n3 = c["new"]
    if not (c["process"]["tokens"] == n_tok == n1 and n2 == 0 and
            c["hits"] == n1 and n3 == c["total"] - n1 and
            c["process"]["dedup_hits"] > 0):
        bad.append(f"prompt cache: new {c['new']}, hits {c['hits']}")
    # compressed rows: the engine's own embedding and bit widths
    ids = [f"model:{i}" for i in range(n_tok)]
    emb_c = card._embed(card.tokenizer.encode(text))
    t0 = time.perf_counter()
    rows_c = compress_rows(emb_c, card.system_config.quantization_bits, ids,
                           device="cuda")
    t_c = time.perf_counter() - t0
    rows_p = compress_rows(emb_c.cpu(), cpu.system_config.quantization_bits,
                           ids, device="cpu")
    pairs = list(zip(rows_c, rows_p)) + [
        (card._prefill_store[k], cpu._prefill_store[k])
        for k in sorted(cpu._prefill_store)]
    if sorted(card._prefill_store) != sorted(cpu._prefill_store) or any(
            not (np.array_equal(a.data, b.data) and a.bits == b.bits and
                 a.quant_scale == b.quant_scale and
                 a.quant_zero_point == b.quant_zero_point)
            for a, b in pairs):
        bad.append("compressed rows differ")
    # the index: queries of token rows (repeated words: tied rows)
    worst, tied = 0.0, 0
    for q in emb_c[: 8 * 37: 37].cpu().numpy():
        a, b = card.anns.search(q, 16), cpu.anns.search(q, 16)
        tied += len({s for _, s in a}) < len(a)
        worst = max([worst] + [abs(x[1] - y[1]) for x, y in zip(a, b)])
        if [i for i, _ in a] != [i for i, _ in b]:
            bad.append(f"top-16 ids differ: {a[:4]} vs {b[:4]}")
    if worst > 1e-5 or tied == 0:
        bad.append(f"similarities {worst}, {tied} queries with ties")
    if card.router.shard_sizes() != cpu.router.shard_sizes() or \
            card.router.edges != cpu.router.edges:
        bad.append("router shards or edges differ")
    keys = sorted(cpu._prefill_store) + ["missing"]
    if any(not np.array_equal(x, y) for x, y in zip(
            card.get_cached_vectors(keys), cpu.get_cached_vectors(keys))):
        bad.append("get_cached_vectors differ")
    if card.stats() != cpu.stats():
        bad.append(f"stats {card.stats()} vs {cpu.stats()}")
    want = {v.id: np.asarray(v.data, np.uint8).tobytes() for v in rows_c}
    got = dict(zip(ids, card.dedup.read_vectors(ids)))
    if got != want:
        bad.append("the store does not read every vector back")
    log(f"  rows, prefill vectors, router, stats and store checked; index "
        f"worst |sim| difference {worst:.3g} (bound 1e-5), {tied} of 8 "
        f"queries with tied rows; compress_rows on the card {t_c:.3f} s; "
        f"stats {card.stats()}")
    if bad:
        raise AssertionError("; ".join(bad))
    return dict(tokens=n_tok, card=c, cpu=p, seconds=secs, counts=counts,
                index_sim_worst=worst, stats=card.stats())


def cli():
    """The command line on the card, each command its own process: `sample
    --bits 4 --batch 2 --seq-len 32` (two lines of text), `quantize --bits
    4 --quant-method gptq --out <stem>` (one JSON line, the checkpoint
    written), `ppl --checkpoint <stem>` loading it (one JSON line), then
    `ingest --file <text>` (one JSON line, JAX's keys, sorted)."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    stem = os.path.join(root, "build", "cli_smoke", "anchor-gptq4")

    # the default store of `ingest` goes to the temporary directory: this one
    env = dict(os.environ, TMPDIR=os.path.dirname(stem))
    os.makedirs(os.path.dirname(stem), exist_ok=True)

    def run(*argv):
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "diffusion_llm_rs_tpu_torch", *argv],
            cwd=root, capture_output=True, text=True, timeout=300, env=env)
        dt = time.perf_counter() - t0
        log(f"  {' '.join(argv[:1])}: exit {out.returncode} in {dt:.1f} s; "
            f"stdout {out.stdout.strip()[:300]!r}")
        if out.returncode != 0:
            raise AssertionError(f"{argv[0]} failed:\n{out.stderr[-3000:]}")
        return out.stdout.strip().splitlines(), dt

    lines, t_sample = run("sample", "--bits", "4", "--batch", "2",
                          "--seq-len", "32")
    if len(lines) != 2 or not all(lines):
        raise AssertionError(f"sample printed {lines}")
    lines, t_quant = run("quantize", "--bits", "4", "--quant-method", "gptq",
                         "--out", stem)
    rec = json.loads(lines[-1])
    if rec["method"] != "gptq" or rec["bits"] != 4 or \
            not os.path.exists(stem + ".npz"):
        raise AssertionError(f"quantize printed {rec}")
    lines, t_ppl = run("ppl", "--checkpoint", stem, "--text",
                       "cat runs near the river")
    ppl = json.loads(lines[-1])
    if not (ppl["perplexity"] > 0 and ppl["bits"] == 4):
        raise AssertionError(f"ppl printed {ppl}")
    corpus = os.path.join(os.path.dirname(stem), "corpus.txt")
    with open(corpus, "w") as f:
        f.write("bird hunts near the forest then sleeps near the forest")
    lines, t_ingest = run("ingest", "--file", corpus)
    ing = json.loads(lines[-1])
    keys = {"dedup_hits", "indexed_vectors", "kv_cache_bytes",
            "kv_cache_entries", "prefill_vectors", "read_amplification",
            "router_nodes", "stored", "tokens", "unique_bytes", "vectors",
            "weight_bits"}
    if set(ing) != keys or list(ing) != sorted(ing) or not (
            ing["tokens"] > 0 and ing["stored"] > 0 and
            ing["indexed_vectors"] == ing["router_nodes"] == ing["tokens"]):
        raise AssertionError(f"ingest printed {ing}")
    return dict(sample_s=t_sample, quantize=rec, quantize_s=t_quant,
                ppl=ppl, ppl_s=t_ppl, ingest=ing, ingest_s=t_ingest)


def engine_check():
    """One full-width packed forward (B=2, S=256, bf16 activations, t=500)
    on the card against the plain versions on the CPU, from the same input,
    for act16 and a8: eps within 2e-2 relative, the sampler's bound (bf16
    rounds at other points on the two sides; on the a8 side a moved
    rounding can also move an act-quant level)."""
    from diffusion_llm_rs_tpu_torch.models import denoiser as dn
    from diffusion_llm_rs_tpu_torch.ops import _build

    g = torch.Generator(device="cuda").manual_seed(17)
    out = {}
    for act_bits in (16, 8):
        eng = MODEL[f"engine{act_bits}"]
        cfg = eng.config
        x = torch.randn((2, 256, cfg.hidden_size), generator=g,
                        device="cuda").to(torch.bfloat16)
        t = torch.full((2,), 500, device="cuda")
        _build.reset_launch_counts()
        e_card = dn.denoiser_forward(eng.params, cfg, x, t).float().cpu()
        counts = dict(_build.launch_counts)
        t0 = time.perf_counter()
        e_cpu = dn.denoiser_forward(_to(eng.params, "cpu"), cfg, x.cpu(),
                                    t.cpu()).float()
        rel = float((e_card - e_cpu).norm() / e_cpu.norm())
        log(f"  act{act_bits}: eps rel err card vs CPU {rel:.3g} (bound 2e-2); "
            f"CPU forward {time.perf_counter() - t0:.1f} s; launches {counts}")
        _expect(f"engine_check act{act_bits}", counts, {
            "matmul_a8" if act_bits == 8 else "matmul":
                _matmuls_per_forward(cfg.num_layers)})
        if not rel <= 2e-2:
            raise AssertionError(f"act{act_bits}: packed forward disagrees "
                                 "with the plain versions")
        out[f"act{act_bits}"] = dict(eps_rel_err=rel, counts=counts)
    return out


# ------------------------------------------------------------- parallel ---
# Each phase joins an NCCL group of one (a FileStore under build/dist), runs
# its path through the mesh at full width on the card, and leaves the group.
# Collectives across ranks need a second card; here every collective runs on
# a group of one.

# ----------------------------------------------------------- CUDA graphs ---

def _drain(b, requests):
    """Submit `requests` [(id, seq_len, steps)] and drain: {id: Completion}."""
    from diffusion_llm_rs_tpu_torch.serving import Request
    for rid, seq_len, steps in requests:
        b.submit(Request(rid, seq_len, steps))
    return {c.request_id: c for c in b.run_until_drained()}


def _timed_part(fn):
    """(result, wall seconds, launch counts) of `fn()`, counts from 0."""
    from diffusion_llm_rs_tpu_torch.ops import _build
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, dict(_build.launch_counts)


def _run_busy(call, steps):
    """Busy share of an unbatched run of `steps` steps: kernel time under
    torch.profiler over the unprofiled wall of the same call."""
    _, wall, _ = _timed_part(call)
    _, busy_ms, rows = _device_time(call, 1)
    return dict(step_wall_ms=wall * 1e3 / steps, step_device_ms=busy_ms / steps,
                busy_share=busy_ms / (wall * 1e3) if rows else None)


def _graph_paths(cfg, params, shape=(8, 256), steps=32, serve_len=4096,
                 serve_steps=8):
    """The paths the `graphs` phase runs both ways: name -> run(), where
    run() builds the path afresh, warms it with the same work as the timed
    part (a replayed path captures its keys there), then times it; returns
    (outputs on the host, steps timed, wall s, launch counts, busy). The
    samplers run `steps` steps at `shape` (B, S); serve_paged(_a8) 4
    requests of `serve_len` tokens and `serve_steps` steps (`heads_wide`
    runs them at its own sizes)."""
    from diffusion_llm_rs_tpu_torch.models.diffusion import (
        DiffusionSchedule, sample)
    from diffusion_llm_rs_tpu_torch.models.sampler import phase_aware_sample
    from diffusion_llm_rs_tpu_torch.serving import (GeneratorNoise,
                                                    PagedContinuousBatcher)
    from diffusion_llm_rs_tpu_torch.utils.metrics import metrics

    schedule = DiffusionSchedule.create(cfg.num_timesteps, device="cuda")
    (B, S), D = shape, cfg.hidden_size

    def gen(seed):
        return torch.Generator(device="cuda").manual_seed(seed)

    def one_shot():
        _, model_fn = _sampler(cfg, params, "cuda")
        sample(model_fn, schedule, (B, S, D), gen(7), num_steps=steps)
        x, wall, counts = _timed_part(lambda: sample(
            model_fn, schedule, (B, S, D), gen(8), num_steps=steps))
        busy = _run_busy(lambda: sample(model_fn, schedule, (B, S, D), gen(9),
                                        num_steps=8), 8)
        return dict(x=x.cpu()), steps, wall, counts, busy

    def scan():
        fwd = _logged_forward()

        def run(seed, n=steps):
            return phase_aware_sample(params, cfg, schedule, (B, S),
                                      GeneratorNoise(seed, "cuda"), n,
                                      forward_fn=fwd)
        run(61)
        x, wall, counts = _timed_part(lambda: run(62))
        busy = _run_busy(lambda: run(63, 8), 8)
        return dict(x=x.cpu()), steps, wall, counts, busy

    def serve(make, warm, reqs, seq_len):
        def run():
            b = make()
            _drain(b, warm)
            steps0 = metrics.get("batcher.steps")
            done, wall, counts = _timed_part(lambda: _drain(b, reqs))
            steps = int(metrics.get("batcher.steps") - steps0)
            out = {f"tokens {r}": c.tokens for r, c in done.items()}
            out.update({f"embeddings {r}": c.embeddings
                        for r, c in done.items() if c.embeddings is not None})
            out["x"], out["page_scores"] = b.x.cpu(), b.page_scores.copy()
            for bits, pool in b.pools.items():
                out.update({f"pool {bits} {n}": a.cpu()
                            for n, a in pool.items()})
            return out, steps, wall, counts, _busy_share(b, seq_len)
        return run

    def paged(**kw):
        base = dict(num_slots=2, seq_len=serve_len, page_size=128,
                    attend_mode="auto", salience_routing=True,
                    hbm_budget_bytes=2 << 30, keep_embeddings=False, seed=41)
        base.update(kw)
        c4 = _serve_cfg(prefill_bits=4, decode_bits=4,
                        progressive_precision=False)
        reqs = [(f"r{i}", serve_len, serve_steps) for i in range(4)]
        return serve(lambda: PagedContinuousBatcher(params, c4, **base),
                     [("warm", serve_len, serve_steps)], reqs, serve_len)

    phase_reqs = [(f"p{i}", 2048, 16 if i % 2 == 0 else 6) for i in range(8)]
    return {
        "sampler": one_shot,
        "scan_sampler": scan,
        "serve_paged": paged(),
        "serve_paged_a8": paged(attn_act_bits=8),
        "serve_phase": serve(lambda: PagedContinuousBatcher(
            params, _serve_cfg(), num_slots=4, seq_len=2048, page_size=64,
            attend_mode="auto", keep_embeddings=True, seed=43),
            phase_reqs, phase_reqs, 2048),
        "serve_dense": serve(lambda: PagedContinuousBatcher(
            params, _serve_cfg(), num_slots=8, seq_len=256, page_size=128,
            attend_mode="auto", keep_embeddings=False, seed=47),
            [(f"w{i}", 256, 12) for i in range(8)],
            [(f"d{i}", 256, 12) for i in range(48)], 256),
    }


def _engine_path(eng):
    """engine_packed both ways: `Engine.sample(8, 256, 32 steps)` through a
    new batcher (the engine's are dropped first), warmed by the same call
    from another seed."""
    B, S = 8, 256

    def run():
        eng._samplers.clear()
        eng.sample(batch_size=B, seq_len=S, num_steps=32, seed=5,
                   return_text=False)
        tokens, wall, counts = _timed_part(lambda: eng.sample(
            batch_size=B, seq_len=S, num_steps=32, seed=3,
            return_text=False))
        b = eng._samplers[(B, S, False, "auto")]
        return dict(tokens=tokens), 32, wall, counts, _busy_share(b, S)
    return run


def _eager_vs_replayed(name, run):
    """`run()` under `utils.graphs.disabled()`, then replayed (the default),
    each with its peak memory and the graphs it captured; the outputs must
    be equal bit for bit and the timed part's launch counts equal."""
    res = {}
    for mode, ctx in (("eager", graphs_disabled),
                      ("replayed", contextlib.nullcontext)):
        gc.collect()  # a cycle can hold a model's f32 leaves until then
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = _graph_counters()
        with ctx():
            out, steps, wall, counts, busy = run()
        torch.cuda.synchronize()
        moved = _graph_counters(before)
        res[mode] = dict(out=out, steps=steps, step_wall_ms=wall * 1e3 / steps,
                         peak_bytes=torch.cuda.max_memory_allocated(),
                         peak_reserved_bytes=torch.cuda.max_memory_reserved(),
                         counts=counts, busy_share=busy.get("busy_share"),
                         busy_step_wall_ms=busy.get("step_wall_ms"),
                         step_device_ms=busy.get("step_device_ms"), **moved)
    e, r = res["eager"], res["replayed"]
    differ = [k for k in e["out"] if not np.array_equal(
        np.asarray(e["out"][k]), np.asarray(r["out"][k]))]
    if sorted(e["out"]) != sorted(r["out"]) or differ:
        raise AssertionError(f"{name}: replayed differs from eager in "
                             f"{differ[:6]}")
    if e["counts"] != r["counts"] or not sum(r["counts"].values()):
        raise AssertionError(f"{name}: launches eager {e['counts']}, "
                             f"replayed {r['counts']}")
    if e["replays"] or not r["replays"] or not r["captures"]:
        raise AssertionError(f"{name}: replays eager {e['replays']}, "
                             f"replayed {r['replays']} ({r['captures']} "
                             f"captures)")
    per_capture = r["capture_s"] / r["captures"]

    def share(m):
        if m["busy_share"] is None:
            return "busy not measured"
        return (f"{m['busy_share']:.1%} busy (kernels "
                f"{m['step_device_ms']:.2f} ms a step)")
    log(f"  {name}: bit for bit ({len(e['out'])} outputs), launches equal "
        f"({sum(r['counts'].values())}); ms a step eager "
        f"{e['step_wall_ms']:.2f}, replayed {r['step_wall_ms']:.2f}; "
        f"eager {share(e)}, replayed {share(r)}; "
        f"{r['captures']:.0f} captures ({r['recaptures']:.0f} again), "
        f"{per_capture:.3f} s each, {r['replays']:.0f} replays; peak memory "
        f"allocated eager {e['peak_bytes'] / 2**20:.1f} MiB, replayed "
        f"{r['peak_bytes'] / 2**20:.1f} MiB; reserved eager "
        f"{e['peak_reserved_bytes'] / 2**20:.1f} MiB, replayed "
        f"{r['peak_reserved_bytes'] / 2**20:.1f} MiB")
    for m in res.values():
        del m["out"]
    return dict(res, capture_s_each=per_capture)


def _spill_case(cfg, params):
    """A budget of about one pool over the 8/4/2-bit buckets at S=512 spills
    and restores buckets mid-run. A restored bucket is made to land on new
    storage (the pool it replaced is held while the bucket is out), so the
    graphs that read it must be captured again; bit for bit against eager."""
    from diffusion_llm_rs_tpu_torch.cache.memory_manager import MemoryManager
    from diffusion_llm_rs_tpu_torch.serving import PagedContinuousBatcher
    from diffusion_llm_rs_tpu_torch.utils.metrics import metrics

    held = {}

    class Holding(PagedContinuousBatcher):
        def _spill_bucket(self, bits):
            held[bits] = list(self.pools[bits].values())
            super()._spill_bucket(bits)

        def _restore_bucket(self, bits):
            super()._restore_bucket(bits)
            held.pop(bits, None)

    def run():
        b = Holding(params, _serve_cfg(), num_slots=2, seq_len=512,
                    page_size=64, attend_mode="paged", max_chunk=4, seed=49,
                    keep_embeddings=False)
        b.hbm_budget = b.cache_memory_bytes() // len(b.buckets) + 1
        b.memory = MemoryManager(device=b.device)
        restores0 = metrics.get("batcher.pool_restores")
        done, wall, counts = _timed_part(lambda: _drain(
            b, [("a", 512, 24), ("b", 512, 10)]))
        restores = int(metrics.get("batcher.pool_restores") - restores0)
        out = {f"tokens {r}": c.tokens for r, c in done.items()}
        out["x"] = b.x.cpu()
        return out, 24, wall, counts, dict(restores=restores)

    res = _eager_vs_replayed("spill and restore", run)
    if not res["replayed"]["recaptures"]:
        raise AssertionError("a restored pool did not make a recapture")
    return res


def graphs():
    """Every path that replays CUDA graphs by default, against itself under
    `utils.graphs.disabled()` on the same draws: the one-shot sampler and
    the scan sampler (B=8, S=256, 32 steps), serve_paged, serve_paged_a8,
    serve_phase, serve_dense (their phases' configurations and requests)
    and engine_packed (`Engine.sample` 8 x 256, 32 steps); and a spill and
    restore under an HBM budget. Each path is warmed by the same work,
    then timed: outputs (x, tokens, embeddings, scores, pools) bit for bit,
    the timed part's launch counts equal, ms a step both ways, the busy
    share of 8 steps both ways (`_busy_share`; for the samplers an 8-step
    run), captures, recaptures and seconds a capture, and peak memory both
    ways. The W4A8 model is built again (the engine phases freed it)."""
    t0 = time.perf_counter()
    cfg, params = full_width_model(max_seq=4096)
    MODEL.update(cfg=cfg, params=params)
    log(f"  model built in {time.perf_counter() - t0:.1f} s")
    out = {}
    for name, run in _graph_paths(cfg, params).items():
        out[name] = _eager_vs_replayed(name, run)
    if "engine16" not in MODEL:
        raise AssertionError("engine_packed built no engine")
    out["engine_packed"] = _eager_vs_replayed("engine_packed",
                                              _engine_path(MODEL["engine16"]))
    out["spill"] = _spill_case(cfg, params)
    return out


def _nccl_group(name):
    import contextlib
    import os

    from diffusion_llm_rs_tpu_torch.parallel import mesh as pm

    @contextlib.contextmanager
    def group():
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "build", "dist", f"{name}-{os.getpid()}")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        if os.path.exists(path):
            os.unlink(path)
        pm.initialize_distributed("nccl", f"file://{path}", 1, 0)
        try:
            if torch.distributed.get_backend() != "nccl":
                raise AssertionError("the group is not NCCL")
            yield
        finally:
            torch.distributed.destroy_process_group()
    return group()


def _packed_full_width(max_seq, act_bits):
    """The full-width model (12 layers, 768 wide, 12 heads, vocab 50257;
    random weights from seed 0) with its linears packed to int4 (symmetric,
    groups of 128) `MatmulWeight`s at `act_bits`, the embedding table whole
    (shard_tp_params refuses a raw QuantizedTensor, and 50257 rows do not
    pack), the other f32 leaves in bf16."""
    from diffusion_llm_rs_tpu_torch.config import DiffusionConfig
    from diffusion_llm_rs_tpu_torch.models import denoiser as dn
    from diffusion_llm_rs_tpu_torch.ops.int8_matmul import prepare
    from diffusion_llm_rs_tpu_torch.quant.core import (QuantizedTensor,
                                                       map_leaves,
                                                       quantize_tree)

    cfg = DiffusionConfig(num_timesteps=1000, hidden_size=768, num_layers=12,
                          num_attention_heads=12, vocab_size=50257,
                          max_sequence_length=max_seq, dtype="bfloat16")
    params = dn.init_denoiser_params(
        torch.Generator(device="cuda").manual_seed(0), cfg)
    qparams = quantize_tree(params, 4, symmetric=True, granularity="group",
                            group_size=128, axis=0,
                            exclude=("pos_embed", "tok_embed"))

    def prep(_, t):
        if isinstance(t, QuantizedTensor):
            return prepare(t, act_bits=act_bits)
        if isinstance(t, torch.Tensor) and t.dtype == torch.float32:
            return t.to(torch.bfloat16)
        return t
    return cfg, map_leaves(prep, qparams)


def _timed_call(name, call):
    """(result, launch counts, wall and peak memory) of `call()` after one
    warm call (the first collective of a group sets NCCL up)."""
    from diffusion_llm_rs_tpu_torch.ops import _build
    call()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    out = call()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    log(f"  {name}: {wall * 1e3:.2f} ms (after a warm call), peak memory "
        f"{peak / 2**20:.1f} MiB")
    counts = dict(_build.launch_counts)
    return out, counts, dict(wall_s=wall, peak_bytes=peak)


def serve_sharded():
    """`ShardedPagedBatcher` on a (1, 1) mesh over an NCCL group of one, at
    full width over int4 g128 `MatmulWeight`s (act 16): S=2048, 4 slots,
    pages of 64, the default 8 -> 4 -> 2 phase schedule, 4 requests of 8
    steps, one warm request before. On NCCL its chunk's step is captured and
    replayed (`parallel/serving.py: nccl_only`): run under
    `graphs.disabled()` and replayed, bit for bit (tokens, x, pools), with
    equal launch counts, ms a step, busy share, captures and the NCCL kernels
    the profiler sees in a replayed chunk (a group of one may launch none).
    Token for token against `PagedContinuousBatcher` on the same parameters
    and seed (JAX's own assertion at tp = 1: the TP forward on a group of one
    is the single forward, bit for bit), with the same launch counts: 51
    `matmul` a step and the paged kernels 12 a bucket a step."""
    from diffusion_llm_rs_tpu_torch.config import PhaseQuantConfig
    from diffusion_llm_rs_tpu_torch.parallel.mesh import make_mesh
    from diffusion_llm_rs_tpu_torch.parallel.serving import ShardedPagedBatcher
    from diffusion_llm_rs_tpu_torch.serving import PagedContinuousBatcher
    from diffusion_llm_rs_tpu_torch.utils import graphs as g
    from diffusion_llm_rs_tpu_torch.utils.metrics import metrics

    cfg, params = _packed_full_width(2048, 16)
    cfg = dataclasses.replace(cfg, quant_config=PhaseQuantConfig())
    kw = dict(num_slots=4, seq_len=2048, page_size=64, attend_mode="paged",
              keep_embeddings=False, seed=61)
    warm, reqs = [("warm", 2048, 2)], [(f"s{i}", 2048, 8) for i in range(4)]
    seen = {}
    with _nccl_group("serve_sharded"):
        mesh = make_mesh((1, 1))
        b = PagedContinuousBatcher(params, cfg, **kw)
        _serve("serve_sharded single warm", b, warm)
        kept = []
        single = _serve("serve_sharded single", b, reqs, kept)
        single_tokens = {c.request_id: c.tokens for c in kept}
        single_groups = (b.buckets, b.head_group)
        del b

        def run():
            b = ShardedPagedBatcher(params, cfg, mesh, **kw)
            mode = "eager" if g.is_disabled() else "replayed"
            seen[mode] = dict(capture=b._graphs.capture,
                              groups=(b.buckets, b.head_group),
                              pool_bytes=b.cache_memory_bytes())
            _drain(b, warm)
            steps0 = metrics.get("batcher.steps")
            done, wall, counts = _timed_part(lambda: _drain(b, reqs))
            steps = int(metrics.get("batcher.steps") - steps0)
            out = {f"tokens {r}": c.tokens for r, c in done.items()}
            out["x"] = b.x.cpu()
            for bits, pool in b.pools.items():
                out.update({f"pool {bits} {n}": a.cpu()
                            for n, a in pool.items()})
            busy = _busy_share(b, 2048)
            seen[mode].update(tokens={r: c.tokens for r, c in done.items()},
                              counts=counts, nccl=busy["nccl"])
            return out, steps, wall, counts, busy
        both = _eager_vs_replayed("serve_sharded", run)
    e, r = seen["eager"], seen["replayed"]
    if not r["capture"] or not e["capture"]:
        raise AssertionError("the sharded batcher does not capture on NCCL")
    if r["groups"] != single_groups or single_groups[0] != (2, 4, 8):
        raise AssertionError(f"buckets and head groups {r['groups']}, single "
                             f"{single_groups}")
    same = sorted(r["tokens"]) == sorted(single_tokens) and all(
        np.array_equal(r["tokens"][k], single_tokens[k]) for k in single_tokens)
    log(f"  tokens equal to PagedContinuousBatcher's: {same}; launches "
        f"{r['counts']} (single {single['counts']})")
    if not same:
        raise AssertionError("the sharded batcher's tokens differ")
    if r["counts"] != single["counts"]:
        raise AssertionError("the sharded batcher launched other kernels")
    calls = sum(k["calls"] for k in r["nccl"])
    log(f"  NCCL kernels in one replayed chunk of 8 steps: "
        + (", ".join(f"{k['name']} x{k['calls']} {k['ms']:.4f} ms"
                     for k in r["nccl"]) if r["nccl"] else
           "none (NCCL launches no kernel on a group of one)")
        + f"; eager {sum(k['calls'] for k in e['nccl'])}")
    L, steps = cfg.num_layers, both["replayed"]["steps"]
    n = r["counts"].get("batched_paged_attention", 0)
    if n == 0 or n % (L * steps):
        raise AssertionError(f"{n} paged launches over {steps} steps")
    _expect("serve_sharded", r["counts"], {"matmul": (4 * L + 3) * steps,
                                           "paged_unpack": n})
    return dict(both["replayed"], eager=both["eager"], single=single,
                tokens_equal=same, pool_bytes=r["pool_bytes"],
                nccl_kernels=r["nccl"], nccl_calls=calls,
                capture_s_each=both["capture_s_each"])


def tp_forward():
    """`make_tp_forward` on a (1, 1) mesh over an NCCL group of one against
    `denoiser_forward`, full width over int4 g128 `MatmulWeight`s at act 16
    (`matmul`) and act 8 (`matmul_a8`), B=8 at S=256 and S=1024 (12
    `dense_attention` launches). Bound: bit for bit (a row-split layer's
    bias rides in model rank 0's epilogue, so a group of one runs the
    single forward's operations in its order)."""
    from diffusion_llm_rs_tpu_torch.models import denoiser as dn
    from diffusion_llm_rs_tpu_torch.parallel import tp
    from diffusion_llm_rs_tpu_torch.parallel.mesh import make_mesh

    g = torch.Generator(device="cuda").manual_seed(71)
    out, total = {}, {}
    with _nccl_group("tp_forward"):
        mesh = make_mesh((1, 1))
        for act_bits in (16, 8):
            cfg, params = _packed_full_width(1024, act_bits)
            local = tp.place_tp_params(params, mesh)
            fwd = tp.make_tp_forward(cfg, mesh)
            L = cfg.num_layers
            for S in (256, 1024):
                x = torch.randn((8, S, cfg.hidden_size), generator=g,
                                device="cuda").to(torch.bfloat16)
                t = torch.randint(0, 1000, (8,), generator=g, device="cuda")
                eps, counts, rec = _timed_call(
                    f"act{act_bits} S={S} TP forward",
                    lambda: fwd(local, x, t))
                with torch.no_grad():
                    ref = dn.denoiser_forward(params, cfg, x, t)
                diff = float((eps.float() - ref.float()).abs().max())
                log(f"  act{act_bits} S={S}: max abs vs denoiser_forward "
                    f"{diff:.3g} (bound: 0, bit for bit); launches {counts}")
                _expect(f"tp_forward act{act_bits} S={S}", counts, {
                    "matmul_a8" if act_bits == 8 else "matmul": 4 * L + 3,
                    "dense_attention": L if S >= 1024 else 0})
                if not torch.equal(eps, ref):
                    raise AssertionError("the TP forward on a group of one is "
                                         "not the single forward")
                out[f"act{act_bits}_s{S}"] = dict(rec, max_abs=diff,
                                                  counts=counts)
                for k, v in counts.items():
                    total[k] = total.get(k, 0) + v
            del local, params
    return dict(out, counts=total)


def moe_forward():
    """The MoE denoiser at full width with 8 experts: decoded-int8
    projections (int4 g128 -> act 8 -> `decode_to_int8`; `int8w_matmul`),
    f32 expert banks (about 1.8 GB), `exclude=("pos_embed", "moe")`. B=8 at
    S=256 and S=1024 (`dense_attention`): the dense dispatch against the
    sorted one (the same copies into the same slots: bit for bit), and
    the EP forward on an expert mesh of one (NCCL) against the unsharded
    forward (bit for bit); then a 2-layer cut of the same model on the card
    against the CPU (2e-2 relative, the card-vs-CPU bound of the int8
    paths)."""
    from diffusion_llm_rs_tpu_torch.config import DiffusionConfig
    from diffusion_llm_rs_tpu_torch.models import moe
    from diffusion_llm_rs_tpu_torch.ops.int8_matmul import prepare
    from diffusion_llm_rs_tpu_torch.ops.matmul import decode_to_int8
    from diffusion_llm_rs_tpu_torch.quant.core import (QuantizedTensor,
                                                       map_leaves,
                                                       quantize_tree)

    cfg = DiffusionConfig(num_timesteps=1000, hidden_size=768, num_layers=12,
                          num_attention_heads=12, vocab_size=50257,
                          max_sequence_length=1024, dtype="bfloat16")
    params = moe.init_moe_denoiser_params(
        torch.Generator(device="cuda").manual_seed(0), cfg, 8)
    q = quantize_tree(params, 4, symmetric=True, granularity="group",
                      group_size=128, axis=0, exclude=("pos_embed", "moe"))

    def prep(path, t):
        if isinstance(t, QuantizedTensor):
            try:
                return decode_to_int8(prepare(t, act_bits=8))
            except ValueError:  # vocab-sized embedding: K not packable
                return t
        if "moe" not in path and isinstance(t, torch.Tensor) \
                and t.dtype == torch.float32:
            return t.to(torch.bfloat16)
        return t
    params = map_leaves(prep, q)
    bank_bytes = sum(v.numel() * v.element_size() for blk in params["blocks"]
                     for v in blk["moe"].values())
    log(f"  expert banks {bank_bytes / 1e9:.2f} GB (f32)")
    g = torch.Generator(device="cuda").manual_seed(73)
    L = cfg.num_layers
    out, total = dict(bank_bytes=bank_bytes), {}
    with _nccl_group("moe_forward"):
        mesh = moe.make_expert_mesh(1)
        ep = moe.place_ep_params(params, mesh)
        run = moe.make_ep_forward(cfg, mesh)
        for S in (256, 1024):
            x = torch.randn((8, S, cfg.hidden_size), generator=g,
                            device="cuda").to(torch.bfloat16)
            t = torch.randint(0, 1000, (8,), generator=g, device="cuda")
            res = {}
            with torch.no_grad():
                for dispatch in ("dense", "sorted"):
                    res[dispatch] = moe.moe_denoiser_forward(
                        params, cfg, x, t, dispatch=dispatch)
            eps, counts, rec = _timed_call(f"S={S} EP forward",
                                           lambda: run(ep, x, t))
            d_sort = float((res["sorted"].float()
                            - res["dense"].float()).abs().max())
            C = -(-5 * S // 4)    # ceil(1.25 * T / E), T = 8 * S tokens
            auto = "sorted" if 8 * C > 8 * cfg.hidden_size else "dense"
            d_ep = float((eps.float() - res[auto].float()).abs().max())
            log(f"  S={S}: sorted vs dense dispatch max abs {d_sort:.3g}, EP "
                f"({auto}) vs unsharded {d_ep:.3g} (bounds: 0); launches "
                f"{counts}")
            _expect(f"moe_forward S={S}", counts, {
                "int8w_matmul": 2 * L + 3, "int8w_mlp": 0,
                "dense_attention": L if S >= 1024 else 0})
            if not (torch.equal(res["sorted"], res["dense"])
                    and torch.equal(eps, res[auto])):
                raise AssertionError("MoE dispatches or EP disagree")
            if not bool(torch.isfinite(eps).all()):
                raise AssertionError("MoE output is not finite")
            out[f"s{S}"] = dict(rec, sorted_vs_dense=d_sort,
                                ep_vs_unsharded=d_ep, counts=counts)
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
    cut = dataclasses.replace(cfg, num_layers=2)
    small = dict(params, blocks=params["blocks"][:2])
    x = torch.randn((8, 256, cfg.hidden_size), generator=g,
                    device="cuda").to(torch.bfloat16)
    t = torch.full((8,), 500, device="cuda")
    with torch.no_grad():
        e_card = moe.moe_denoiser_forward(small, cut, x, t).float().cpu()
        e_cpu = moe.moe_denoiser_forward(_to(small, "cpu"), cut, x.cpu(),
                                         t.cpu()).float()
    rel = float((e_card - e_cpu).norm() / e_cpu.norm())
    log(f"  2-layer cut, card vs CPU: rel {rel:.3g} (bound 2e-2)")
    if not rel <= 2e-2:
        raise AssertionError("the MoE forward on the card disagrees with the "
                             "CPU")
    return dict(out, card_vs_cpu_rel=rel, counts=total)


def pp_sp_forward():
    """A pipeline of one stage (2 microbatches) and a ring of one, each on an
    NCCL group of one, against `denoiser_forward` on the full-width W4A8
    decoded model: B=8, S=256, and the pipeline also at B=2, S=1024
    (`dense_attention`). Both run the MLP as two `int8w_matmul`s (no fused
    MLP; the pipeline's blocks once a microbatch) where `denoiser_forward`
    fuses it and the wo residual: 2e-2 relative, the sampler's eps
    bound."""
    from diffusion_llm_rs_tpu_torch.models import denoiser as dn
    from diffusion_llm_rs_tpu_torch.parallel import pp, sp

    cfg, params = full_width_model(max_seq=1024)
    g = torch.Generator(device="cuda").manual_seed(79)
    L = cfg.num_layers
    out, total = {}, {}
    for name, B, S in (("pp", 8, 256), ("pp", 2, 1024), ("sp", 8, 256)):
        x = torch.randn((B, S, cfg.hidden_size), generator=g,
                        device="cuda").to(torch.bfloat16)
        t = torch.randint(0, 1000, (B,), generator=g, device="cuda")
        with _nccl_group(f"{name}_forward"):
            if name == "pp":
                mesh = pp.make_stage_mesh(1)
                stage = pp.place_stage_params(pp.stack_stage_params(params, 1),
                                              mesh)
                fwd = pp.make_pp_forward(cfg, mesh, n_micro=2)
                call = lambda: fwd(params, stage, x, t)  # noqa: E731
            else:
                fwd = sp.make_sp_forward(cfg, sp.make_seq_mesh(1))
                call = lambda: fwd(params, x, t)  # noqa: E731
            eps, counts, rec = _timed_call(f"{name} B={B} S={S}", call)
        with torch.no_grad():
            ref = dn.denoiser_forward(params, cfg, x, t).float()
        rel = float((eps.float() - ref).norm() / ref.norm())
        log(f"  {name} B={B} S={S}: rel vs denoiser_forward {rel:.3g} (bound "
            f"2e-2); launches {counts}")
        blocks = 2 if name == "pp" else 1   # the pipeline's microbatches
        _expect(f"{name} S={S}", counts, {
            "int8w_matmul": 4 * L * blocks + 3, "int8w_mlp": 0,
            "dense_attention": L * blocks if S >= 1024 else 0})
        if not rel <= 2e-2:
            raise AssertionError(f"{name} forward disagrees")
        out[f"{name}_b{B}_s{S}"] = dict(rec, rel=rel, counts=counts)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    return dict(out, counts=total)


# name: (source, TPU kernel it replaces, the path whose run `launches` reads:
# the 32-step sampler for the GEMMs, the S=1024 run for dense attention,
# which the sampler at S=256 does not reach, serve_paged for the batched
# paged kernel, the PagedKVCache run for the single-sequence one, the
# engine's 32-step sample for the two packed-weight kernels, the 32-step scan
# sampler for quantized-KV attention, serve_paged with int8 attention
# activations for the int8 paged kernel, and the full-width forward of
# phase fused_qkv for fused-QKV attention)
KERNELS = {
    "int8w_matmul": ("diffusion_llm_rs_tpu_torch/csrc/int8_gemm.cu",
                     "diffusion_llm_rs_tpu/ops/pallas_matmul.py:322",
                     "sampler"),
    "int8w_mlp": ("diffusion_llm_rs_tpu_torch/csrc/int8_mlp.cu",
                  "diffusion_llm_rs_tpu/ops/pallas_matmul.py:399", "sampler"),
    "dense_attention": ("diffusion_llm_rs_tpu_torch/csrc/dense_attention.cu",
                        "diffusion_llm_rs_tpu/ops/pallas_attention.py:213",
                        "long_seq"),
    "batched_paged_attention": (
        "diffusion_llm_rs_tpu_torch/csrc/batched_paged_attention.cu",
        "diffusion_llm_rs_tpu/ops/pallas_paged_attention.py:288",
        "serve_paged"),
    "paged_unpack": ("diffusion_llm_rs_tpu_torch/csrc/paged_unpack.cu",
                     "diffusion_llm_rs_tpu/ops/pallas_paged_attention.py:391",
                     "serve_paged"),
    "paged_attention": ("diffusion_llm_rs_tpu_torch/csrc/quant_flash_paged.cu",
                        "diffusion_llm_rs_tpu/ops/pallas_paged_attention.py:34",
                        "cache_attend"),
    "quant_attention": ("diffusion_llm_rs_tpu_torch/csrc/quant_flash_contig.cu",
                        "diffusion_llm_rs_tpu/ops/pallas_attention.py:99",
                        "scan_sampler"),
    "batched_paged_attention_a8": (
        "diffusion_llm_rs_tpu_torch/csrc/paged_attention_a8.cu",
        "diffusion_llm_rs_tpu/ops/pallas_paged_attention.py:520",
        "serve_paged_a8"),
    "matmul": ("diffusion_llm_rs_tpu_torch/csrc/packed_gemm.cu",
               "diffusion_llm_rs_tpu/ops/pallas_matmul.py:203",
               "engine_packed"),
    "matmul_a8": ("diffusion_llm_rs_tpu_torch/csrc/packed_gemm.cu",
                  "diffusion_llm_rs_tpu/ops/pallas_matmul.py:293",
                  "engine_packed_a8"),
    "fused_qkv_attention": (
        "diffusion_llm_rs_tpu_torch/csrc/fused_qkv_attention.cu",
        "diffusion_llm_rs_tpu/ops/pallas_attention.py:293", "fused_qkv"),
}


# kernels whose wrapper also launches kernels of another source: matmul_a8
# unpacks in packed_gemm.cu, then quantizes and multiplies in int8_gemm.cu;
# quant_attention and paged_attention run heads of widths between their
# instances' from a padded source
# the wide instance of each attention design (heads past 256), a source of
# its own (with its C entry point at heads of 384 and 768) over
# csrc/wide_cluster_flash.cuh (WIDE_DESIGNS; past 2048 blocks of several
# slices)
WIDE_SOURCES = {
    "dense_attention": "diffusion_llm_rs_tpu_torch/csrc/dense_attention_wide.cu",
    "fused_qkv_attention":
        "diffusion_llm_rs_tpu_torch/csrc/fused_qkv_attention_wide.cu",
    "quant_attention":
        "diffusion_llm_rs_tpu_torch/csrc/quant_flash_contig_wide.cu",
    "paged_attention":
        "diffusion_llm_rs_tpu_torch/csrc/quant_flash_paged_wide.cu",
    "batched_paged_attention":
        "diffusion_llm_rs_tpu_torch/csrc/paged_flash_cluster.cu",
    "batched_paged_attention_a8":
        "diffusion_llm_rs_tpu_torch/csrc/paged_flash_cluster.cu"}
WIDE_ENTRY_POINTS = {
    "dense_attention": "dlm_dense_attention_cluster",
    "fused_qkv_attention": "dlm_fused_qkv_attention_cluster",
    "quant_attention": "dlm_quant_attention_cluster",
    "paged_attention": "dlm_paged_attention_cluster",
    "batched_paged_attention": "dlm_batched_paged_attention_cluster",
    "batched_paged_attention_a8": "dlm_batched_paged_attention_a8_cluster",
    "paged_unpack": "dlm_paged_unpack"}
WIDE_DESIGNS = {
    "dense_attention": "diffusion_llm_rs_tpu_torch/csrc/wide_cluster_flash.cuh",
    "fused_qkv_attention":
        "diffusion_llm_rs_tpu_torch/csrc/fused_qkv_attention_wide.cu",
    "quant_attention": "diffusion_llm_rs_tpu_torch/csrc/wide_cluster_flash.cuh",
    "paged_attention": "diffusion_llm_rs_tpu_torch/csrc/wide_cluster_flash.cuh",
    "batched_paged_attention":
        "diffusion_llm_rs_tpu_torch/csrc/wide_cluster_flash.cuh",
    "batched_paged_attention_a8":
        "diffusion_llm_rs_tpu_torch/csrc/wide_cluster_flash.cuh"}
WIDE_DESIGN_NOTES = {
    "diffusion_llm_rs_tpu_torch/csrc/wide_cluster_flash.cuh":
        "heads of 264-2048: a cluster of ceil(D/256) blocks a 128-query "
        "tile, each block 256 columns, partial S summed in rank order "
        "through distributed shared memory, S and P.V on wgmma; one "
        "sequence's page chain, or the contiguous KV's chain of tiles, split "
        "over clusters, merged in the launch; the contiguous KV's block-"
        "packed rows copied a block's bytes at a time and unpacked by field; "
        "the batched int8 path's S in s32 partials of 64 tokens, a page's S "
        "held for its per-page requantization, P.V in two halves; past 2048 "
        "every mode in blocks of several 256-column slices (pass 1 S, q's "
        "slice streamed from L2 a step; dense and fused-QKV attention (one "
        "kernel, slices_attention) keep S in f32 scratch and each row's max "
        "and sum; quantized-KV, one sequence's paged and the batched bf16 "
        "attention (one kernel, wide_cluster_slices, templated on how K and "
        "V arrive) per tile bf16(p * vs) or bf16(p), alpha and csum; the "
        "int8 path per page its requantized weights, alpha, sw and csum, "
        "q's int8 levels quantized once into a scratch; pass 2 P.V slice by "
        "slice)",
    "diffusion_llm_rs_tpu_torch/csrc/fused_qkv_attention_wide.cu":
        "heads of 264-2048: the two exact passes of csrc/fused_qkv_attention"
        ".cu over csrc/wide_cluster_flash.cuh's cluster (ceil(D/256) blocks "
        "a 128-query tile, each 256 columns, partial S summed in rank order, "
        "S and P.V on wgmma); pass 1's S kept in f32 scratch and read back "
        "by pass 2, which runs P.V alone; past 2048 blocks of several "
        "256-column slices, q streamed a slice a step in pass 1, pass 2 "
        "slice by slice (csrc/wide_cluster_flash.cuh: slices_attention, "
        "which dense attention runs there too)"}
ALSO_BUILT_FROM = {
    "matmul_a8": ("diffusion_llm_rs_tpu_torch/csrc/int8_gemm.cu",),
    # the heads between the instances' widths, from sources of their own
    "quant_attention": (
        "diffusion_llm_rs_tpu_torch/csrc/quant_flash_contig_padded.cu",
        WIDE_SOURCES["quant_attention"]),
    "paged_attention": (
        "diffusion_llm_rs_tpu_torch/csrc/quant_flash_paged_padded.cu",
        WIDE_SOURCES["paged_attention"]),
    "dense_attention": (WIDE_SOURCES["dense_attention"],),
    "batched_paged_attention": (WIDE_SOURCES["batched_paged_attention"],),
    "batched_paged_attention_a8": (
        WIDE_SOURCES["batched_paged_attention_a8"],),
    "fused_qkv_attention": (
        WIDE_SOURCES["fused_qkv_attention"],
        "diffusion_llm_rs_tpu_torch/csrc/wide_cluster_flash.cuh")}


# Run in a checkout (cwd), this one or an earlier commit's: the attention
# kernels of the quantized-KV design (`quant_attention`, `paged_attention`),
# `dense_attention`, and the batched paged design (`paged_unpack` in both
# layouts, then the bf16 and the int8 attention kernel alone on that
# scratch) and fused-QKV attention, built by that checkout and timed by its
# own chip_smoke.py at the
# head widths the parent served (PARENT_SHAPES: 16, 32, 64, 128, 192 and
# 256, and 96 run padded in 128, at the full-width model's heads, the
# batched kernels at serve_paged's pools), and at the wide instances' heads
# of 384 and 768 where the checkout has them (the batched kernels' through
# their cluster entry points where the checkout has those, else the wide
# ones: the same key, so the ratio is the redesign's); prints one JSON line
# of {kernel shape: ms}.
PARENT_SHAPES = dict(
    quant_attention=[(96, 256, 64, 4), (96, 256, 64, 8), (96, 256, 64, 2),
                     (24, 1024, 64, 4), (192, 256, 32, 4), (48, 256, 128, 4),
                     (384, 256, 16, 4), (32, 256, 192, 4), (24, 256, 256, 4),
                     (64, 256, 96, 4)],
    dense_attention=[(96, 1024, 64), (192, 1024, 32), (48, 1024, 128),
                     (384, 1024, 16), (32, 1024, 192), (24, 1024, 256),
                     (64, 1024, 96)],
    paged_attention=[(12, 1024, 64), (24, 1024, 32), (6, 1024, 128),
                     (48, 1024, 16), (4, 1024, 192), (3, 1024, 256),
                     (8, 1024, 96)],
    # B, H, G, D: 32 pages of 128 a slot, 4-bit, Sq = 4096
    batched=[(2, 12, 2, 64), (2, 24, 4, 32), (2, 6, 1, 128), (2, 48, 8, 16),
             (2, 4, 1, 192), (2, 3, 1, 256), (2, 8, 1, 96)],
    # the wide instances (heads past 256), which a parent without them
    # refuses: new rows, timed in this checkout only
    wide_quant=[(16, 256, 384, 4), (8, 256, 768, 4)],
    wide_dense=[(16, 1024, 384), (8, 1024, 768)],
    wide_paged=[(2, 1024, 384), (1, 1024, 768)],
    wide_batched=[(2, 2, 1, 384), (2, 1, 1, 768)],
    # the W4A8 kernels, whose epilogues took an f32 residual: the sampler's
    # qkv and wo (+ bf16 residual) at M = 2048, its MLP (M, K, F)
    int8w_matmul=[(2048, 768, 2304, False), (2048, 768, 768, True)],
    int8w_mlp=[(2048, 768, 3072)],
    # fused-QKV attention (B, S, D, H): the sampler's 12 heads of 64, and 4
    # heads of 192 and 3 of 256 (the first design's kernel in a parent
    # before the wgmma design took them, so the ratio is the redesign's),
    # and 2 heads of 384 and one of 768 at S = 256 and 864 (the first
    # design's kernel in a parent before the cluster kernel took them)
    fused_qkv=[(8, 256, 768, 12), (8, 256, 768, 4), (8, 864, 768, 4),
               (8, 256, 768, 3), (8, 864, 768, 3), (8, 256, 768, 2),
               (8, 256, 768, 1), (8, 864, 768, 2), (8, 864, 768, 1),
               # past 2048 (one head of 2056 and of 4104): the first
               # design's kernel in a parent before the cluster design took
               # them, so the ratio is the redesign's
               (8, 256, 2056, 1), (8, 240, 4104, 1)],
    # single-sequence paged attention past 2048 (BH, Sq, D, pages of 128,
    # 4-bit): csrc/wide_flash.cuh in a parent before the cluster design
    # took these heads
    past_paged=[(1, 1024, 2056, 3), (1, 1024, 4104, 3)],
    # dense attention past 2048 (BH, S, D) and the batched int8 kernel alone
    # past 2048 (B, H, D, pages of 128 a slot, 4-bit, Sq = 2048):
    # csrc/wide_flash.cuh in a parent before the cluster design took these
    # heads
    past_dense=[(3, 1024, 2056), (3, 1024, 4104)],
    past_a8=[(2, 1, 2056, 6), (2, 1, 4104, 6)],
    # quant_attention (BH, S, D, bits) and the batched bf16 kernel alone (B,
    # H, D, pages of 128 a slot, 4-bit, Sq = 2048) past 2048:
    # csrc/wide_flash.cuh in a parent before the cluster design took these
    # heads
    past_quant=[(3, 256, 2056, 4), (3, 256, 4104, 4)],
    past_bf16=[(2, 1, 2056, 6), (2, 1, 4104, 6)])
PARENT_CODE = """
import json, torch, chip_smoke as c
from diffusion_llm_rs_tpu_torch.ops import _build
from diffusion_llm_rs_tpu_torch.ops import attention as qa
from diffusion_llm_rs_tpu_torch.ops import int8_matmul as im
from diffusion_llm_rs_tpu_torch.ops import paged_attention as pa
c.device()
wide = "dense_attention_wide" in _build.SOURCES
batched_cluster = "paged_flash_cluster" in _build.SOURCES
_build.build(("dense_attention", "quant_flash_contig", "quant_flash_paged",
              "paged_unpack", "batched_paged_attention", "paged_attention_a8",
              "int8_gemm", "int8_mlp", "fused_qkv_attention") + tuple(
    n for n in ("dense_attention_wide", "quant_flash_contig_wide",
                "quant_flash_paged_wide", "paged_flash_wide",
                "paged_flash_cluster", "fused_qkv_attention_wide")
    if n in _build.SOURCES))
if not wide:  # a checkout without the wide instances: their rows are new
    for key in [k for k in SHAPES if k.startswith("wide_")]:
        SHAPES[key] = []
gen = torch.Generator(device="cuda").manual_seed(99)
ms = {}
# a checkout with the int8 batched kernel's wide entry point (past 2048),
# whose cluster entry point takes no scratch; and one with the bf16 batched
# kernel's, whose cluster entry point takes no replay scratch
a8_wide = "dlm_batched_paged_attention_a8_wide" in _build.SIGNATURES
bf16_wide = "dlm_batched_paged_attention_wide" in _build.SIGNATURES
for BH, S, D, bits in SHAPES["quant_attention"] + SHAPES["wide_quant"]:
    q = torch.randn((BH, S, D), generator=gen, device="cuda").bfloat16()
    k, v = (qa.quantize_kv(torch.randn((BH, S, D), generator=gen,
                                       device="cuda"), bits) for _ in "kv")
    ms[f"quant_attention BH={BH} S={S} D={D} {bits}-bit"] = c.time_ms(
        lambda: qa.attention(q, k, v))
for BH, S, D in SHAPES["dense_attention"] + SHAPES["wide_dense"]:
    q, k, v = (torch.randn((BH, S, D), generator=gen, device="cuda")
               .bfloat16() for _ in "qkv")
    ms[f"dense_attention BH={BH} S={S} D={D}"] = c.time_ms(
        lambda: qa.dense_attention(q, k, v))
for BH, Sq, D in SHAPES["paged_attention"] + SHAPES["wide_paged"]:
    pools = c._quantized_pools(gen, 16, BH, 128, D, 1, 4)
    q = torch.randn((BH, Sq, D), generator=gen, device="cuda").bfloat16()
    pt = torch.randperm(16, generator=gen, device="cuda")[:8].int()
    ms[f"paged_attention BH={BH} Sq={Sq} D={D} 8 pages of 128 4-bit"] = \\
        c.time_ms(lambda: pa.paged_attention(q, pt, *pools, bits=4))
for B, H, G, D in SHAPES["batched"] + SHAPES["wide_batched"]:
    n, Sq = 32, 4096
    pools = c._quantized_pools(gen, B * n, H, 128, D, G, 4)
    q = torch.randn((B, H, Sq, D), generator=gen, device="cuda").bfloat16()
    pt = torch.randperm(B * n, generator=gen, device="cuda").reshape(
        B, n).int()
    nt = torch.full((B, n), 128, dtype=torch.int32, device="cuda")
    npg = torch.full((B,), n, dtype=torch.int32, device="cuda")
    out = torch.empty((B, H, Sq, D), dtype=torch.float32, device="cuda")
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device="cuda")
    tag = f"B={B} H={H} G={G} D={D} Sq={Sq} {n} pages of 128 4-bit"
    for a8 in (False, True):
        ms[f"paged_unpack {tag} {'int8' if a8 else 'bf16'} layout"] = \\
            c.time_ms(lambda: pa.paged_unpack(pt, npg, *pools, bits=4,
                                              head_group=G, a8=a8))
        k, v, side = pa.paged_unpack(pt, npg, *pools, bits=4, head_group=G,
                                     a8=a8)
        name = "batched_paged_attention" + ("_a8" if a8 else "")
        extra = (k.shape[4], 128) if D > 256 else ()  # the wide instance's
        # past 256 the cluster kernel where the checkout has it (to 2048)
        suffix = "" if not extra else "_cluster" if batched_cluster and \
            D <= 2048 else "_wide"
        fn = _build.function("dlm_" + name + suffix)
        # the cluster kernels' scratch (the int8 path's q levels and the
        # replay words, read only past 2048) where the checkout's entry
        # point takes it
        nulls = () if suffix != "_cluster" else (None, None) if a8 and \
            not a8_wide else (None,) if not a8 and not bf16_wide else ()
        ms[f"{name} (alone) {tag}"] = c.time_ms(lambda: _build.check(fn(
            q.data_ptr(), nt.data_ptr(), npg.data_ptr(), k.data_ptr(),
            v.data_ptr(), side.data_ptr(), out.data_ptr(), lse.data_ptr(), B,
            H, Sq, D, n, k.shape[3], *extra,
            torch.cuda.current_stream().cuda_stream, *nulls), name))
for M, K, N, resid in SHAPES["int8w_matmul"]:
    x = torch.randn((M, K), generator=gen, device="cuda").bfloat16()
    w = torch.randint(-127, 128, (K, N), generator=gen, device="cuda",
                      dtype=torch.int8)
    cs = torch.rand((1, N), generator=gen, device="cuda") * 1e-3
    r = (torch.randn((M, N), generator=gen, device="cuda").bfloat16()
         if resid else None)
    ms[f"int8w_matmul M={M} K={K} N={N}" + (" +residual" if resid else "")] \
        = c.time_ms(lambda: im.int8w_matmul(x, w, cs, None, None, r,
                                            torch.bfloat16))
for M, K, F in SHAPES["int8w_mlp"]:
    x = torch.randn((M, K), generator=gen, device="cuda").bfloat16()
    w1, w2 = (torch.randint(-127, 128, s, generator=gen, device="cuda",
                            dtype=torch.int8) for s in ((K, F), (F, K)))
    cs1, cs2 = (torch.rand((1, n), generator=gen, device="cuda") * 1e-3
                for n in (F, K))
    b1, b2 = (torch.randn((n,), generator=gen, device="cuda") for n in (F, K))
    r = torch.randn((M, K), generator=gen, device="cuda").bfloat16()
    ms[f"int8w_mlp M={M} {K}->{F}->{K} +residual"] = c.time_ms(
        lambda: im.int8w_mlp(x, w1, cs1, b1, w2, cs2, b2, r, torch.bfloat16))
for BH, Sq, D, n in SHAPES.get("past_paged", []):
    pools = c._quantized_pools(gen, 2 * n, BH, 128, D, 1, 4)
    q = torch.randn((BH, Sq, D), generator=gen, device="cuda").bfloat16()
    pt = torch.randperm(2 * n, generator=gen, device="cuda")[:n].int()
    ms[f"paged_attention BH={BH} Sq={Sq} D={D} {n} pages of 128 4-bit"] = \\
        c.time_ms(lambda: pa.paged_attention(q, pt, *pools, bits=4))
for B, S, D, H in SHAPES.get("fused_qkv", []):
    qkv = torch.randn((B, S, 3 * D), generator=gen, device="cuda").bfloat16()
    ms[f"fused_qkv_attention B={B} S={S} D={D} H={H}"] = c.time_ms(
        lambda: qa.fused_qkv_attention(qkv, H))
for BH, S, D in SHAPES.get("past_dense", []):
    q, k, v = (torch.randn((BH, S, D), generator=gen, device="cuda")
               .bfloat16() for _ in "qkv")
    ms[f"dense_attention BH={BH} S={S} D={D}"] = c.time_ms(
        lambda: qa.dense_attention(q, k, v))
# the int8 kernel alone past 2048: the wide entry point where the checkout
# has it, else the cluster one with its scratch
for B, H, D, n in SHAPES.get("past_a8", []):
    Sq = 2048
    pools = c._quantized_pools(gen, B * n, H, 128, D, 1, 4)
    q = torch.randn((B, H, Sq, D), generator=gen, device="cuda").bfloat16()
    pt = torch.randperm(B * n, generator=gen, device="cuda").reshape(
        B, n).int()
    nt = torch.full((B, n), 128, dtype=torch.int32, device="cuda")
    npg = torch.full((B,), n, dtype=torch.int32, device="cuda")
    out = torch.empty((B, H, Sq, D), dtype=torch.float32, device="cuda")
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device="cuda")
    k, v, side = pa.paged_unpack(pt, npg, *pools, bits=4, a8=True)
    fn = _build.function("dlm_batched_paged_attention_a8"
                         + ("_wide" if a8_wide else "_cluster"))
    scratch = () if a8_wide else pa._a8_slices_scratch(
        q.device, B * H, Sq, D, k.shape[4], n, k.shape[3])
    ms[f"batched_paged_attention_a8 (alone) B={B} H={H} D={D} Sq={Sq} {n} "
       f"pages of 128 4-bit"] = c.time_ms(lambda: _build.check(fn(
        q.data_ptr(), nt.data_ptr(), npg.data_ptr(), k.data_ptr(),
        v.data_ptr(), side.data_ptr(), out.data_ptr(), lse.data_ptr(), B, H,
        Sq, D, n, k.shape[3], k.shape[4], 128,
        torch.cuda.current_stream().cuda_stream,
        *(t.data_ptr() for t in scratch)), "batched_paged_attention_a8"))
# past 2048 quant_attention, and the bf16 batched kernel alone: the wide
# entry point where the checkout has it, else the cluster one with its
# replay scratch
for BH, S, D, bits in SHAPES.get("past_quant", []):
    q = torch.randn((BH, S, D), generator=gen, device="cuda").bfloat16()
    k, v = (qa.quantize_kv(torch.randn((BH, S, D), generator=gen,
                                       device="cuda"), bits) for _ in "kv")
    ms[f"quant_attention BH={BH} S={S} D={D} {bits}-bit"] = c.time_ms(
        lambda: qa.attention(q, k, v))
for B, H, D, n in SHAPES.get("past_bf16", []):
    Sq = 2048
    pools = c._quantized_pools(gen, B * n, H, 128, D, 1, 4)
    q = torch.randn((B, H, Sq, D), generator=gen, device="cuda").bfloat16()
    pt = torch.randperm(B * n, generator=gen, device="cuda").reshape(
        B, n).int()
    nt = torch.full((B, n), 128, dtype=torch.int32, device="cuda")
    npg = torch.full((B,), n, dtype=torch.int32, device="cuda")
    out = torch.empty((B, H, Sq, D), dtype=torch.float32, device="cuda")
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device="cuda")
    k, v, side = pa.paged_unpack(pt, npg, *pools, bits=4)
    fn = _build.function("dlm_batched_paged_attention"
                         + ("_wide" if bf16_wide else "_cluster"))
    scratch = () if bf16_wide else (qa.replay_scratch(
        q.device, D, B * H, Sq, n * 4),)
    ms[f"batched_paged_attention (alone) B={B} H={H} D={D} Sq={Sq} {n} "
       f"pages of 128 4-bit"] = c.time_ms(lambda: _build.check(fn(
        q.data_ptr(), nt.data_ptr(), npg.data_ptr(), k.data_ptr(),
        v.data_ptr(), side.data_ptr(), out.data_ptr(), lse.data_ptr(), B, H,
        Sq, D, n, k.shape[3], k.shape[4], 128,
        torch.cuda.current_stream().cuda_stream,
        *(t.data_ptr() for t in scratch)), "batched_paged_attention"))
print(json.dumps(ms))
"""


def _parent_run(checkout):
    """Start PARENT_CODE in `checkout`, a process of its own;
    `_parent_read` reads its result."""
    code = f"SHAPES = {PARENT_SHAPES!r}\n" + PARENT_CODE
    return subprocess.Popen([sys.executable, "-c", code], cwd=checkout,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _parent_read(proc, label):
    out, _ = proc.communicate(timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"attention times ({label}) failed:\n"
                           f"{out[-4000:]}")
    rec = json.loads(out.strip().splitlines()[-1])
    log(f"  {label}: " + "; ".join(f"{k} {v:.4f}" for k, v in rec.items()))
    return rec


def main() -> int:
    """`--parent DIR`: also time the attention kernels of the checkout in
    DIR (the parent commit) and of this one at the head widths the parent
    served, each built and timed by its own chip_smoke.py in a process of
    its own: parent (beside this checkout's build), this checkout, this
    checkout, parent."""
    import os
    parent = sys.argv[sys.argv.index("--parent") + 1] \
        if "--parent" in sys.argv else None
    root = os.path.dirname(os.path.abspath(__file__))
    phase(device)
    if failures:
        return 1
    before = _parent_run(parent) if parent else None
    phase(build)
    if failures:
        return 1
    parent_runs = {}
    if before is not None:
        log("== attention kernels, ms: parent, this checkout, this checkout, "
            "parent")
        parent_runs["parent_before"] = _parent_read(before, "parent")
        for label in ("this_1", "this_2"):
            parent_runs[label] = _parent_read(_parent_run(root), label)
        parent_runs["parent_after"] = _parent_read(_parent_run(parent),
                                                   "parent")
        for key in parent_runs["this_1"]:
            now = [parent_runs[f"this_{i}"][key] for i in (1, 2)]
            if key not in parent_runs["parent_before"]:  # new in this one
                log(f"  {key}: this {min(now):.4f} (new)")
                continue
            was = [parent_runs[f"parent_{w}"][key] for w in ("before", "after")]
            log(f"  {key}: this / parent {min(now) / min(was):.3f}")
    measured = phase(kernels)
    runs = {"sampler": phase(sampler)}
    if runs["sampler"] is not None:
        for fn in (long_seq, scan_sampler, scan_check, profile, fused_qkv,
                   cache_attend, serve_paged, serve_paged_a8, serve_phase,
                   serve_dense, serve_check):
            runs[fn.__name__] = phase(fn)
    MODEL.clear()  # the engine phases build their own models
    torch.cuda.empty_cache()
    for fn in (engine_packed, engine_packed_a8, engine_anchor, train_grad,
               heads16, heads_wide, engine_gptq, engine_gptq_shipped,
               engine_ingest, cli):
        runs[fn.__name__] = phase(fn)
    if "engine16" in MODEL and "engine8" in MODEL:
        runs["engine_check"] = phase(engine_check)
    runs["graphs"] = phase(graphs)
    MODEL.clear()
    torch.cuda.empty_cache()
    for fn in (serve_sharded, tp_forward, moe_forward, pp_sp_forward,
               examples):
        runs[fn.__name__] = phase(fn)
    if failures:
        log(f"FAILED phases: {failures}")
        return 1
    entries = []
    paths = {p: r["counts"] for p, r in runs.items()
             if r is not None and "counts" in r}
    for name, (source, replaces, path) in KERNELS.items():
        # times at the first shape that was timed; the errors are the worst
        # of all. Each path's counts were reset just before that path ran.
        rows = measured[name]
        first = next(r for r in rows if "ms" in r)
        entries.append(dict(
            name=name, route="cuda", source=source,
            sources=[source] + list(ALSO_BUILT_FROM.get(name, ())),
            replaces=replaces,
            launches=paths[path].get(name, 0), launches_path=path,
            launches_by_path={p: c.get(name, 0) for p, c in paths.items()},
            max_abs_err=max(r["max_abs_err"] for r in rows), ms=first["ms"],
            plain_ms=first["plain_ms"], bound_ms=first["bound_ms"],
            bound_by=first["bound_by"], library_ms=first["library_ms"],
            **{k: first[k] for k in ("library_colmajor_ms",
                                     "library_colmajor_mm_ms") if k in first},
            shapes=rows))
        if entries[-1]["launches"] == 0:
            log(f"{name} was not launched on its path {path}")
            return 1
        # the wide instance (heads past 256): its first timed row, and its
        # launches on heads_wide's models of heads of 384 and 768
        wide = next((r for r in rows if r.get("wide") and "ms" in r), None)
        if name in WIDE_SOURCES or (name == "paged_unpack" and wide):
            n_wide = (runs.get("heads_wide") or {}).get("counts_wide", {}).get(
                name, 0)
            design = WIDE_DESIGNS.get(
                name, "diffusion_llm_rs_tpu_torch/csrc/wide_cluster_flash.cuh")
            entries[-1]["wide_instance"] = dict(
                source=WIDE_SOURCES.get(name, source), design=design,
                entry_point=WIDE_ENTRY_POINTS[name],
                design_note=WIDE_DESIGN_NOTES[design], launches=n_wide,
                launches_path="heads_wide", shape=wide["shape"],
                ms=wide["ms"], plain_ms=wide["plain_ms"],
                bound_ms=wide["bound_ms"], bound_by=wide["bound_by"],
                library_ms=wide["library_ms"])
            if name == "dense_attention":
                entries[-1]["wide_instance"]["clusters_at_once"] = {
                    str(c): n for c, n in sorted(CLUSTERS.items())}
            elif "clusters_at_once" in wide:
                entries[-1]["wide_instance"]["clusters_at_once"] = wide[
                    "clusters_at_once"]
            if n_wide == 0:
                log(f"{name}'s wide instance was not launched on heads_wide")
                return 1
    log(json.dumps({"kernels": entries}))
    if parent_runs:
        runs["parent_kernels"] = parent_runs
    log(json.dumps(runs))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
