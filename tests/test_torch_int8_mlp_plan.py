"""The fused int8 MLP kernel's plan, on the CPU.

`mlp_plan` says how `csrc/int8_mlp.cu` runs a shape: clusters of 3 or 4
blocks (whichever needs fewer waves on the card, from the clusters of each
size the card runs at once) over 64-row tiles, rounds of 128 inner columns
a block (block j of a cluster of cl takes chunk cl r + j in round r), each
block's 64-column output tiles. The kernel needs a card; here a model of
its schedule in torch, driven by the plan, must cover every inner and
output column exactly once and, since it only reorders exact int32 sums and
exact maxima, equal the plain version bit for bit. `mlp_fits` routes wider
shapes to the chained kernels.
"""

import gc

import numpy as np
import pytest
import torch

from diffusion_llm_rs_tpu_torch.ops import int8_matmul as im


def _schedule_mlp(x, w1, cs1, b1, w2, cs2, b2, residual, out_dtype, active):
    """int8w_mlp computed in the kernel's order, per the plan: each block's
    partial row amax over its chunks, the cluster's maximum, each round's
    chunks requantized, and the second product summed per block and per
    128 inner columns (a warpgroup's share of a stage) over the rounds."""
    M, K = x.shape
    F, N = w1.shape[1], w2.shape[1]
    plan = im.mlp_plan(M, K, F, N, active)
    cluster, rounds, tiles = plan["cluster"], plan["rounds"], plan["out_tiles"]
    assert plan["grid"] == (cluster, -(-M // 64))
    xi, sx = im.quant_rows_plain(x.to(torch.bfloat16).float())

    def chunk(j, r):  # block j's inner columns in round r
        f0 = (r * cluster + j) * 128
        return range(f0, min(f0 + 128, F))

    def inner(cols):
        cols = list(cols)
        y = (im._int_dot(xi, w1[:, cols]).float() * sx * cs1.reshape(1, F)[:, cols]
             + b1[cols].reshape(1, -1))
        return im.gelu_tanh(y)

    amax = torch.zeros((M, 1))
    seen = torch.zeros(F, dtype=torch.int32)
    for j in range(cluster):
        for r in range(rounds):
            cols = chunk(j, r)
            if len(cols):
                amax = torch.maximum(amax, inner(cols).abs().amax(1, keepdim=True))
                seen[list(cols)] += 1
    assert torch.equal(seen, torch.ones(F, dtype=torch.int32))
    sy = torch.where(amax > 0, im.true_div(amax, 127.0), 1.0)

    acc = torch.zeros((M, N), dtype=torch.int64)
    written = torch.zeros(N, dtype=torch.int32)
    for r in range(rounds):
        yi = torch.zeros((M, 128 * cluster), dtype=torch.int8)  # the buffer
        for j in range(cluster):
            cols = chunk(j, r)
            if len(cols):
                yi[:, j * 128:j * 128 + len(cols)] = torch.round(
                    inner(cols) / sy).to(torch.int8)
        for j in range(cluster):
            for u in range(tiles):
                n0 = (j * tiles + u) * 64
                if n0 >= N:
                    continue
                ns = list(range(n0, min(n0 + 64, N)))
                if r == 0:
                    written[ns] += 1
                for slot in range(cluster):  # 128 inner columns each
                    g0 = (r * cluster + slot) * 128
                    fs = list(range(g0, min(g0 + 128, F)))
                    if fs:
                        part = yi[:, slot * 128:slot * 128 + len(fs)]
                        acc[:, ns] += im._int_dot(part, w2[fs][:, ns]).long()
    assert torch.equal(written, torch.ones(N, dtype=torch.int32))
    y = (acc.to(torch.int32).float() * sy * cs2.reshape(1, N)
         + b2.reshape(1, N))
    if residual is not None:
        y = y + residual.float()
    return y.to(out_dtype)


def _args(M, K, F, N, seed):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    x = t(rng.standard_normal((M, K))).to(torch.bfloat16)
    w1 = torch.from_numpy(rng.integers(-127, 128, (K, F), dtype=np.int8))
    w2 = torch.from_numpy(rng.integers(-127, 128, (F, N), dtype=np.int8))
    cs1 = t(rng.random((1, F)) * 1e-3)
    cs2 = t(rng.random((1, N)) * 1e-3)
    b1, b2 = t(rng.standard_normal(F)), t(rng.standard_normal(N))
    r = t(rng.standard_normal((M, N))).to(torch.bfloat16)
    return x, w1, cs1, b1, w2, cs2, b2, r


# the card tests' edges: one and six rounds, a ragged inner row (208) and
# output row (80, where two blocks of a cluster own no output tile), four
# output tiles a block
SHAPES = [(5, 128, 512, 128), (37, 80, 208, 80), (20, 128, 1024, 80),
          (9, 768, 3072, 768), (3, 128, 3072, 1024)]


# clusters of 4 only, of 3 only (where the shape allows it), either
ACTIVE = [{4: 30}, {3: 39}, {3: 39, 4: 30}]


@pytest.mark.parametrize("M,K,F,N", SHAPES)
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("active", ACTIVE)
def test_kernel_schedule_equals_plain(M, K, F, N, out_dtype, active):
    if im.mlp_plan(M, K, F, N, active) is None:
        # clusters of 3 only, at an output row that would need more than 4
        # tiles a block: refused (the wrapper then plans clusters of 4)
        assert active == {3: 39} and -(-(-(-N // 64)) // 3) > 4
        assert im.mlp_plan(M, K, F, N, {4: 30}) is not None
        return
    args = _args(M, K, F, N, seed=M + K + F + N)
    got = _schedule_mlp(*args, out_dtype, active)
    want = im.int8w_mlp_plain(*args, out_dtype=out_dtype)
    assert torch.equal(got, want)


@pytest.mark.parametrize("M,K,F,N", SHAPES + [(8192, 768, 3072, 768)])
@pytest.mark.parametrize("cluster", [3, 4])
def test_plan_covers_the_shape(M, K, F, N, cluster):
    plan = im.mlp_plan(M, K, F, N, {cluster: 1})
    if plan is None:  # more than 4 output tiles a block
        assert cluster == 3 and -(-(-(-N // 64)) // 3) > im.MLP_MAX_OUT_TILES
        return
    cl, tiles = plan["grid"]
    assert cl == plan["cluster"] == cluster
    assert tiles * im.MLP_ROWS >= M > (tiles - 1) * im.MLP_ROWS
    width = im.MLP_CHUNK * cl  # inner columns a round
    assert plan["rounds"] * width >= F > (plan["rounds"] - 1) * width
    assert plan["out_tiles"] * 64 * cl >= N
    assert plan["out_tiles"] <= im.MLP_MAX_OUT_TILES
    assert plan["smem"] <= im.SMEM_LIMIT


# the H100's occupancy at 768 -> 3072 -> 768: 30 clusters of 4, 39 of 3
H100 = {3: 39, 4: 30}


@pytest.mark.parametrize("M,cluster,waves", [
    (2048, 3, 1),   # 32 row tiles: one wave of 3s, two of 4s
    (1920, 4, 1),   # 30 row tiles: one wave of 4s
    (8192, 4, 5),   # 128: five waves of 4s (cost 5) against four of 3s (5.33)
    (100, 4, 1)])
def test_plan_picks_the_cluster_with_fewer_waves(M, cluster, waves):
    plan = im.mlp_plan(M, 768, 3072, 768, H100)
    assert plan["cluster"] == cluster
    assert -(-plan["grid"][1] // H100[cluster]) == waves
    assert plan["out_tiles"] == {3: 4, 4: 3}[cluster]
    assert plan["rounds"] == {3: 8, 4: 6}[cluster]


def test_plan_at_the_sampler_shape():
    assert im.mlp_plan(2048, 768, 3072, 768) == dict(
        cluster=4, grid=(4, 32), rounds=6, out_tiles=3, smem=183680)
    assert im.mlp_plan(2048, 768, 3072, 768, {3: 0, 4: 0}) is None


@pytest.mark.parametrize("K,F,N,fits", [
    (768, 3072, 768, True), (768, 3088, 768, False),    # inner rows <= 3072
    (256, 4096, 256, False),                            # the chained route
    (1408, 3072, 768, True), (1536, 3072, 768, False),  # the x tile's memory
    (128, 512, 1024, True), (128, 512, 1088, False),    # 4 output tiles
    (16, 16, 4, True)])
def test_mlp_fits_boundaries(K, F, N, fits):
    assert im.mlp_fits(K, F, N) is fits
    assert (im.mlp_plan(64, K, F, N) is not None) is fits


def test_mlp_fits_defaults_the_output_row_to_the_input_row():
    assert im.mlp_fits(768, 3072) and not im.mlp_fits(1088, 3072)
    assert im.mlp_fits(1088, 3072, 768)


def test_k_major_copy_is_made_once_and_follows_the_weight():
    w = torch.arange(24, dtype=torch.int8).reshape(4, 6)
    a = im._k_major(w)
    assert torch.equal(a, w.t()) and a.is_contiguous()
    assert im._k_major(w) is a
    w.add_(1)  # an in-place change makes a new copy
    b = im._k_major(w)
    assert b is not a and torch.equal(b, w.t())
    key = id(w)
    del w, a, b
    gc.collect()
    assert key not in im._k_major_copies


# ROADMAP C43: widths off the kernels' alignment (K % 16, N % 4) run padded
# with zeros; the padding is checked here on the plain versions, which the
# card's kernels equal bit for bit (tests/test_torch_kernels_cuda.py)

@pytest.mark.parametrize("K,N", [(24, 8), (48, 6), (100, 30), (8, 1)])
@pytest.mark.parametrize("act", [None, "gelu"])
@pytest.mark.parametrize("res_dtype", [torch.bfloat16, torch.float32])
def test_padded_weight_gives_the_plain_bits(K, N, act, res_dtype):
    """`_padded(w, Kp, Np)` is w^T with zeros past it, made once; x, the
    scales, bias and residual padded with zeros and the output sliced back
    give `int8w_matmul_plain`'s bits: zero columns add exact zeros to the
    int32 sums and leave each row's amax alone."""
    rng = np.random.default_rng(K + N)
    w = torch.from_numpy(rng.integers(-127, 128, (K, N)).astype(np.int8))
    x = torch.from_numpy(rng.normal(size=(5, K)).astype(np.float32))
    cs = torch.from_numpy(rng.random((1, N)).astype(np.float32)) * 1e-3
    b = torch.from_numpy(rng.normal(size=(N,)).astype(np.float32))
    r = torch.from_numpy(rng.normal(size=(5, N)).astype(np.float32)).to(
        res_dtype)
    Kp, Np = im._round_up(K, im.K_ALIGN), im._round_up(N, im.N_ALIGN)
    wt = im._padded(w, Kp, Np)
    assert wt.shape == (Np, Kp) and im._padded(w, Kp, Np) is wt
    assert torch.equal(wt[:N, :K], w.t())
    assert not wt[N:].any() and not wt[:, K:].any()
    got = im.int8w_matmul_plain(im._pad_cols(x, Kp), wt.t(),
                                im._pad_cols(cs, Np), im._pad_cols(b, Np),
                                act, im._pad_cols(r, Np), torch.bfloat16)
    want = im.int8w_matmul_plain(x, w, cs, b, act, r, torch.bfloat16)
    assert torch.equal(got[:, :N], want)
    key = (id(w), Kp, Np)
    del w, wt
    gc.collect()
    assert key not in im._padded_copies


@pytest.mark.parametrize("K,F,N", [(24, 40, 6), (100, 200, 30), (16, 8, 4)])
@pytest.mark.parametrize("res_dtype", [torch.bfloat16, torch.float32])
def test_padded_mlp_gives_the_plain_bits(K, F, N, res_dtype):
    """The MLP padded at K, F and N: the inner columns past F come out
    gelu(0 * s + 0) = 0 and requantize to 0 without moving the row's
    amax, so `int8w_mlp_plain` over the padded operands, sliced, gives its
    bits over the unpadded ones (f32 and bf16 residual)."""
    rng = np.random.default_rng(K + F + N)
    w1 = torch.from_numpy(rng.integers(-127, 128, (K, F)).astype(np.int8))
    w2 = torch.from_numpy(rng.integers(-127, 128, (F, N)).astype(np.int8))
    x = torch.from_numpy(rng.normal(size=(7, K)).astype(np.float32))
    cs1, cs2 = (torch.from_numpy(rng.random((1, n)).astype(np.float32)) * 1e-2
                for n in (F, N))
    b1, b2 = (torch.from_numpy(rng.normal(size=(n,)).astype(np.float32))
              for n in (F, N))
    r = torch.from_numpy(rng.normal(size=(7, N)).astype(np.float32)).to(
        res_dtype)
    Kp, Fp = im._round_up(K, im.K_ALIGN), im._round_up(F, im.K_ALIGN)
    Np = im._round_up(N, im.N_ALIGN)
    pc = im._pad_cols
    got = im.int8w_mlp_plain(pc(x, Kp), im._padded(w1, Kp, Fp).t(),
                             pc(cs1, Fp), pc(b1, Fp),
                             im._padded(w2, Fp, Np).t(), pc(cs2, Np),
                             pc(b2, Np), pc(r, Np), torch.float32)
    want = im.int8w_mlp_plain(x, w1, cs1, b1, w2, cs2, b2, r, torch.float32)
    assert torch.equal(got[:, :N], want)
