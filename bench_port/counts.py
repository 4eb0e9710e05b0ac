"""Operations, bytes and least times: the yardstick of the rooflines and
the step's share of the chip's peak.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, 700 W): 1,979 TOP/s
int8, 989 TFLOP/s bf16, 67 TFLOP/s f32 outside the tensor cores, 3.35
TB/s of HBM. A launch's least time is the larger of its bytes over the
bandwidth and its operations over the peak of its precision
(`chip_smoke.py: bound`), each input byte read once and each output byte
written once. The kernels' counts are of the shapes as launched (padded
slots and positions included: that is the kernels' work); the step's
useful operations (`useful_s`) count each active request at its own
length, and so bound the step's share of the peak by 100%.
"""

from __future__ import annotations

from bench_port.model import Dims
from bench_port.reference import phase_bits

PEAK_INT8 = 1979e12
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12


def bound(nbytes: float, ops: float, peak: float) -> float:
    """Least seconds of a launch."""
    return max(nbytes / PEAK_BYTES, ops / peak)


# -- the W4A8 linears (csrc/int8_gemm.cu, csrc/int8_mlp.cu) ---------------

def quant_rows_s(M: int, K: int, in_bytes: int) -> float:
    return bound(M * K * in_bytes + M * K + 4 * M, 0, PEAK_INT8)


def gemm_s(M: int, K: int, N: int, out_bytes: int = 2, bias: bool = False,
           residual: bool = False) -> float:
    nbytes = (M * K + K * N + 4 * M + 4 * N + (4 * N if bias else 0)
              + M * N * out_bytes + (2 * M * N if residual else 0))
    return bound(nbytes, 2 * M * K * N, PEAK_INT8)


def linear_s(M: int, K: int, N: int, **kw) -> float:
    """A bf16 input through `int8w_matmul`: row quantization, product."""
    return quant_rows_s(M, K, 2) + gemm_s(M, K, N, **kw)


def mlp_s(M: int, D: int, F: int, fused: bool) -> float:
    """The MLP block with its residual: one fused launch, or the chain of
    row quantization, product into f32, row quantization, product."""
    if fused:
        nbytes = (M * D * 2 + D * F + F * D + 4 * (2 * F + 3 * D)
                  + M * D * 2 + M * D * 2)
        return bound(nbytes, 2 * M * (D * F + F * D), PEAK_INT8)
    return (quant_rows_s(M, D, 2)
            + gemm_s(M, D, F, out_bytes=4, bias=True)
            + quant_rows_s(M, F, 4)
            + gemm_s(M, F, D, bias=True, residual=True))


def linears_step_s(d: Dims, B: int, S: int, fused_mlp: bool) -> float:
    """Least seconds of one denoise step's W4A8 launches at B rows of S."""
    M, D = B * S, d.hidden
    t = (linear_s(B, D, 4 * D, bias=True) +
         linear_s(B, 4 * D, D, bias=True))
    layer = (linear_s(M, D, 3 * D) + linear_s(M, D, D, residual=True)
             + mlp_s(M, D, d.inner, fused_mlp))
    return t + d.layers * layer + linear_s(M, D, D)


# -- attention (csrc/paged_unpack.cu + the batched paged kernel;
#    csrc/dense_attention.cu) ----------------------------------------------

def paged_s(d: Dims, S: int, page: int, bits: int, members, B: int) -> float:
    """Least seconds of one layer's paged attention over one bucket
    (`chip_smoke.py: _paged_bound`): unpack and attention together read
    the member slots' packed pages and their f32 sidecars and q (bf16),
    and write out and lse (f32) for all B slots; 4 operations per (query,
    key, channel) over each member's valid keys. `members` lists the
    member slots' lengths."""
    H, Hd = d.heads, d.head_dim
    vpb = 8 // bits
    pages = sum(-(-L // page) for L in members)
    nbytes = (pages * (2 * H * (page // vpb) * Hd + 4 * H * page * 4)
              + len(members) * H * S * Hd * 2 + B * H * S * (Hd * 4 + 4))
    ops = 4 * H * S * Hd * sum(members)
    return bound(nbytes, ops, PEAK_BF16)


def paged_empty_s(d: Dims, S: int, B: int) -> float:
    """A launch over a bucket no slot reads: zeros and lse written."""
    return bound(B * d.heads * S * (d.head_dim * 4 + 4), 0, PEAK_BF16)


def dense_attention_s(d: Dims, B: int, S: int) -> float:
    """One layer's `dense_attention` launch over B x heads: q, k, v read
    and the output written in bf16; 4 operations per (query, key,
    channel)."""
    BH, Hd = B * d.heads, d.head_dim
    return bound(4 * BH * S * Hd * 2, 4 * BH * S * S * Hd, PEAK_BF16)


# -- the step's useful operations -----------------------------------------

def useful_s(d: Dims, L: int) -> float:
    """Least seconds of one denoise step of a request of L tokens: its
    linears (int8), its attention over its L keys (bf16)."""
    D, F = d.hidden, d.inner
    lin = 2 * L * d.layers * (3 * D * D + D * D + 2 * D * F) + 2 * L * D * D
    lin += 2 * (D * 4 * D + 4 * D * D)
    attn = 4 * L * L * D * d.layers
    return lin / PEAK_INT8 + attn / PEAK_BF16


def readout_s(d: Dims, L: int) -> float:
    """Least seconds of the f32 readout of L tokens onto the vocabulary."""
    return 2 * L * d.hidden * d.vocab / PEAK_F32


# -- a serving window's occupancy -----------------------------------------

def occupancy(rec):
    """For every step draw k of the window, (seq_len, t, num_steps) of
    each request active at it (t its timestep there)."""
    lo, hi = rec.step_draws
    per = {k: [] for k in range(lo, hi)}
    for q in rec.reqs.values():
        if q.first_step < 0:
            continue
        a, b = max(lo, q.first_step), min(hi, q.first_step + q.num_steps)
        for k in range(a, b):
            t = q.num_steps - 1 - (k - q.first_step)
            per[k].append((q.seq_len, t, q.num_steps))
    return per


def paged_window_s(d: Dims, rec, page: int, launches: int) -> float:
    """Least seconds of the window's paged attention: at each step, one
    launch a layer for each bucket some active request reads (its members
    at their lengths), and the rest of the `launches` counted over buckets
    no slot read at that step."""
    total, member_launches = 0.0, 0
    for active in occupancy(rec).values():
        buckets = {}
        for L, t, n in active:
            buckets.setdefault(phase_bits(d, t, n), []).append(L)
        for bits, members in buckets.items():
            total += d.layers * paged_s(d, rec.seq_len, page, bits, members,
                                        rec.slots)
            member_launches += d.layers
    empty = max(0, launches - member_launches)
    return total + empty * paged_empty_s(d, rec.seq_len, rec.slots)
