"""The s8 wgmma GEMM core's plan, and the act_bits=8 unpack, on the CPU.

`gemm_plan` says how `csrc/int8_gemm.cu` runs xi [M, K] @ wt [N, K]^T: the
orientation (tokens on the wgmma M side, or on its N side at up to 32
tokens), the rows of the B operand a block and the blocks along K. The
kernel needs a card; here a model of its schedule in torch, driven by the
plan, must cover every output once and, since it only reorders exact int32
sums, equal the plain version bit for bit. `unpack_i8`, the K-major int8
operand of `matmul_a8`, equals JAX's `decode_to_int8(w).data.T` bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from diffusion_llm_rs_tpu.ops import matmul as jmm
from diffusion_llm_rs_tpu.ops import pallas_matmul as jpm
from diffusion_llm_rs_tpu.quant import core as jq
from diffusion_llm_rs_tpu_torch.ops import int8_matmul as im
from diffusion_llm_rs_tpu_torch.ops import packed_matmul as tpm
from diffusion_llm_rs_tpu_torch.quant import core as tq

SMEM_LIMIT = 232448      # dynamic shared memory of one sm_90 block
SM_SHARED = 233472       # shared memory of an SM (228 KB)

# every shape chip_smoke.py times, both int8 GEMMs, and ragged edges
TIMED = sorted({(M, N, K) for _, M, K, N, *_ in chip_smoke.I8W_CASES}
               | {(M, N, K) for _, M, K, N, *_ in chip_smoke.PACKED_CASES})
EDGES = [(1, 4, 16), (8, 8, 48), (17, 24, 16), (64, 2304, 768),
         (65, 2304, 768), (200, 768, 3072), (2048, 8, 3072)]


def _schedule(xi, wt, plan):
    """xi @ wt^T as the kernel's blocks compute it: block (x, y, z) takes A
    rows 128 x.., B rows tile y.. and K steps [z S / s, (z + 1) S / s) of
    128 bytes; each split's int32 sums are written once, then added in
    order."""
    M, K = xi.shape
    N = wt.shape[0]
    ksteps = -(-K // 128)
    gx, gy, splits = plan["grid"]
    tile = plan["tile"]
    a, b = (wt, xi) if plan["swap"] else (xi, wt)
    ws = torch.zeros((splits, a.shape[0], b.shape[0]), dtype=torch.int32)
    seen = torch.zeros((splits, a.shape[0], b.shape[0]), dtype=torch.int32)
    for z in range(splits):
        k0 = z * ksteps // splits * 128
        k1 = min(K, (z + 1) * ksteps // splits * 128)
        for x in range(gx):
            for y in range(gy):
                ra = slice(128 * x, 128 * (x + 1))
                rb = slice(tile * y, tile * (y + 1))
                ws[z, ra, rb] = im._int_dot(a[ra, k0:k1], b[rb, k0:k1].t())
                seen[z, ra, rb] += 1
    assert torch.equal(seen, torch.ones_like(seen))
    acc = ws[0]
    for z in range(1, splits):
        acc = acc + ws[z]
    return acc.t() if plan["swap"] else acc


def _inputs(M, K, N, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32))
    w = torch.from_numpy(rng.integers(-127, 128, size=(K, N)).astype(np.int8))
    cs = torch.from_numpy((rng.random((1, N)) * 1e-3 + 1e-5).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(N,)).astype(np.float32))
    r = torch.from_numpy(rng.normal(size=(M, N)).astype(np.float32)).to(
        torch.bfloat16)
    return x, w, cs, b, r


PLANS = [dict(swap=False, tile=128, splits=1), dict(swap=False, tile=96,
                                                     splits=2),
         dict(swap=False, tile=64, splits=3), dict(swap=True, tile=8,
                                                   splits=4),
         dict(swap=True, tile=16, splits=1), dict(swap=True, tile=32,
                                                  splits=2)]


@pytest.mark.parametrize("M,K,N", [(5, 512, 200), (130, 384, 24),
                                   (17, 48, 136)])
@pytest.mark.parametrize("plan", PLANS + [None],
                         ids=[f"{'swap' if p['swap'] else 'rows'}{p['tile']}"
                              f"x{p['splits']}" for p in PLANS] + ["planned"])
def test_kernel_schedule_equals_plain(M, K, N, plan):
    """Every block of the plan's grid, every split's K range, the splits
    summed in order, then the epilogue: bit for bit `int8w_matmul_plain`
    (bias and residual, bf16 out; no gelu, whose tanh is the only step that
    may differ by a last bit between card and CPU)."""
    x, w, cs, b, r = _inputs(M, K, N, seed=M + K + N)
    ksteps = -(-K // 128)
    if plan is None:
        plan = im.gemm_plan(M, N, K)
    else:
        plan = dict(plan, splits=min(plan["splits"], ksteps))
        rows_a, rows_b = (N, M) if plan["swap"] else (M, N)
        plan["grid"] = (-(-rows_a // 128), -(-rows_b // plan["tile"]),
                        plan["splits"])
    xi, sx = im.quant_rows_plain(x.to(torch.bfloat16).float())
    acc = _schedule(xi, im._k_major(w), plan)
    y = (acc.float() * sx * cs + b) + r.float()
    ref = im.int8w_matmul_plain(x, w, cs, b, None, r, torch.bfloat16)
    assert torch.equal(y.to(torch.bfloat16), ref)


@pytest.mark.parametrize("M,N,K", TIMED + EDGES)
@pytest.mark.parametrize("sms", [132, 114])
def test_plan_covers_the_shape_and_fits(M, N, K, sms):
    """A valid plan: up to 16 splits, none empty; the grid covers the
    output; tokens on the wgmma N side only at up to 32 tokens, in one tile
    of the next size up; two blocks fit an SM's shared memory."""
    plan = im.gemm_plan(M, N, K, sms)
    ksteps = -(-K // 128)
    assert 1 <= plan["splits"] <= min(16, ksteps)
    gx, gy, gz = plan["grid"]
    rows_a, rows_b = (N, M) if plan["swap"] else (M, N)
    assert gz == plan["splits"]
    assert (gx - 1) * 128 < rows_a <= gx * 128
    assert (gy - 1) * plan["tile"] < rows_b <= gy * plan["tile"]
    if plan["swap"]:
        assert M <= 32 and gy == 1
        assert plan["tile"] == min(t for t in im.GEMM_SWAP_TILES if t >= M)
    else:
        assert plan["tile"] in [t for t, _ in im.GEMM_NORMAL_TILES]
    assert plan["smem"] <= SMEM_LIMIT
    assert 2 * (plan["smem"] + 1024) <= SM_SHARED


@pytest.mark.parametrize("swap,tile", [(False, t) for t, _ in
                                       im.GEMM_NORMAL_TILES]
                         + [(True, t) for t in im.GEMM_SWAP_TILES])
def test_every_instance_stages_its_tile_in_the_ring(swap, tile):
    """The epilogue stages the int32 tile, the row scales, the column
    scales and biases where the ring was: the ring holds them, has 3-6
    stages, and two blocks fit an SM."""
    stages, smem = im.gemm_smem(swap, tile)
    stage = (128 + tile) * 128
    tm, tn = (tile, 128) if swap else (128, tile)
    assert 3 <= stages <= 6 and stages * stage <= im.GEMM_RING
    assert tm * (tn + 8) * 4 + (tm + 2 * tn) * 4 <= stages * stage
    assert smem == 1024 + stages * stage + 16 * stages
    assert 2 * (smem + 1024) <= SM_SHARED


def test_plan_at_the_main_path_shapes():
    """The time-MLP (M = 8) puts its tokens on the wgmma N side, one tile of
    8, and its K = 3072 linear splits K; the sampler's wo and head at M =
    2048 run in one wave of two blocks an SM; above 32 tokens the tokens
    sit on the wgmma M side."""
    t1 = im.gemm_plan(8, 3072, 768)
    assert (t1["swap"], t1["tile"], t1["splits"]) == (True, 8, 1)
    t2 = im.gemm_plan(8, 768, 3072)
    assert t2["swap"] and t2["splits"] > 1
    wo = im.gemm_plan(2048, 768, 768)
    gx, gy, gz = wo["grid"]
    assert not wo["swap"] and gx * gy * gz <= 2 * 132
    for M in (33, 64, 2048, 8192):
        assert not im.gemm_plan(M, 2304, 768)["swap"]


def _pair(K, N, bits, gran, seed):
    w = (np.random.default_rng(seed).normal(size=(K, N)) * 0.02).astype(
        np.float32)
    kw = (dict(symmetric=True, granularity="group", group_size=128, axis=0)
          if gran == "group" else dict(granularity="channel", axis=1))
    jw = jpm.prepare(jq.quantize(jnp.asarray(w), bits, **kw), act_bits=8)
    tw = tpm.prepare(tq.quantize(torch.from_numpy(w), bits, **kw),
                     act_bits=8)
    return jw, tw


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("gran", ["group", "channel"])
def test_k_major_unpack_equals_jax_decode(bits, gran):
    """The plain version of the act_bits=8 unpack (the kernel is held to it
    on the card) is JAX's decoded int8 weight, transposed, bit for bit."""
    jw, tw = _pair(256, 72, bits, gran, seed=bits)
    wt = tpm.unpack_i8(tw)
    assert wt.dtype == torch.int8 and wt.shape == (72, 256)
    assert wt.is_contiguous()
    ref = np.asarray(jmm.decode_to_int8(jw).data).T
    assert np.array_equal(wt.numpy(), ref)
