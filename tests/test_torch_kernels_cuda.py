"""The port's CUDA kernels against their plain twins, on the card.

These need an NVIDIA GPU (Hopper, sm_90a) and nvcc; they carry the `cuda`
marker and skip elsewhere. The file imports no JAX, so it also runs on a
machine without it:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda
"""

import pytest
import torch

from diffusion_llm_rs_tpu_torch.ops import _build
from diffusion_llm_rs_tpu_torch.ops import int8_matmul as im
from diffusion_llm_rs_tpu_torch.ops import paged_attention as pa
from diffusion_llm_rs_tpu_torch.ops import attention as qa
from diffusion_llm_rs_tpu_torch.ops.attention import (
    dense_attention,
    dense_attention_plain,
)

pytestmark = pytest.mark.cuda

# the head widths the attention kernels take besides 16, 32, 64 and 128
# (multiples of 8 up to 256, each in the smallest instance of 16, 32, 64,
# 128, 192 and 256 that holds it, zero past D): every new instance, at its
# own width and padded
WIDE = [8, 24, 48, 80, 96, 136, 192, 200, 256]
# past 256, the cluster kernels of each design (csrc/wide_cluster_flash.cuh):
# a ragged last column block (264), the heads
# of width 768 at 2 and 1 heads (384, 768), and whole column blocks up to 16
# of them (512, 1024, 2048: clusters of 2, 4 and 8)
WIDER = [264, 384, 512, 768, 1024, 2048]
HEAD_DIMS = [16, 32, 64, 128] + [pytest.param(d, id=f"D{d}") for d in WIDE] \
    + [pytest.param(d, id=f"W{d}") for d in WIDER]


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _w(K, N, gen):
    return torch.randint(-127, 128, (K, N), generator=gen, device="cuda",
                         dtype=torch.int8)


@pytest.mark.parametrize("M,K,N", [(1, 16, 4), (37, 48, 20), (130, 768, 2304),
                                   (8, 768, 3072)])
@pytest.mark.parametrize("gelu", [False, True])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_int8w_matmul_kernel_matches_twin(gen, M, K, N, gelu, out_dtype):
    """Ragged M, K and N edges included; the int32 products are exact on both
    sides and the epilogue runs the same f32 operations, each rounded on its
    own: without gelu the kernel equals its twin bit for bit. With gelu,
    tanh's last bit may differ (f32 out: 1e-5 relative; bf16 out: one bf16
    ulp)."""
    x = torch.randn((M, K), generator=gen, device="cuda")
    w = _w(K, N, gen)
    cs = torch.rand((1, N), generator=gen, device="cuda") * 1e-3
    b = torch.randn((N,), generator=gen, device="cuda")
    r = torch.randn((M, N), generator=gen, device="cuda").to(torch.bfloat16)
    act = "gelu" if gelu else None
    _build.reset_launch_counts()
    out = im.int8w_matmul(x, w, cs, b, act, r, out_dtype)
    torch.cuda.synchronize()
    assert _build.launch_counts["int8w_matmul"] == 1
    ref = im.int8w_matmul_plain(x, w, cs, b, act, r, out_dtype)
    if not gelu:
        assert torch.equal(out, ref)
        return
    rtol = 1e-5 if out_dtype == torch.float32 else 2.0 ** -7
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol, atol=1e-6)


# the s8 wgmma core's edges: one token, one token tile of 8, ragged 17 and
# 200 rows, the sampler's 2048; 8 and 24 weight columns (one ragged tile),
# 768 and 2304; K of one 16-byte row, a ragged 48, 768 and 3072 (24 steps)
EDGE_M = [1, 8, 17, 200, 2048]
EDGE_N = [8, 24, 768, 2304]


@pytest.mark.parametrize("M", EDGE_M)
@pytest.mark.parametrize("N", EDGE_N)
@pytest.mark.parametrize("K", [16, 48, 768, 3072])
@pytest.mark.parametrize("gelu,extras", [(False, False), (False, True),
                                         (True, True)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_int8w_matmul_edges_match_twin(gen, M, N, K, gelu, extras,
                                       out_dtype):
    """The tolerance of `test_int8w_matmul_kernel_matches_twin`, with and
    without bias and residual, under whatever plan `gemm_plan` picks."""
    x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
    w = _w(K, N, gen)
    cs = torch.rand((1, N), generator=gen, device="cuda") * 1e-3
    b = torch.randn((N,), generator=gen, device="cuda") if extras else None
    r = (torch.randn((M, N), generator=gen, device="cuda").to(torch.bfloat16)
         if extras else None)
    act = "gelu" if gelu else None
    _build.reset_launch_counts()
    out = im.int8w_matmul(x, w, cs, b, act, r, out_dtype)
    torch.cuda.synchronize()
    assert _build.launch_counts["int8w_matmul"] == 1
    assert out.dtype == out_dtype and out.shape == (M, N)
    ref = im.int8w_matmul_plain(x, w, cs, b, act, r, out_dtype)
    if not gelu:
        assert torch.equal(out, ref)
        return
    rtol = 1e-5 if out_dtype == torch.float32 else 2.0 ** -7
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol, atol=1e-6)


GEMM_INSTANCES = [(False, t) for t, _ in im.GEMM_NORMAL_TILES] + \
    [(True, t) for t in im.GEMM_SWAP_TILES]


@pytest.mark.parametrize("M,K,N", [(8, 3072, 768), (200, 768, 2304),
                                   (17, 48, 24), (70, 1024, 136)])
@pytest.mark.parametrize("swap,tile", GEMM_INSTANCES)
def test_int8_gemm_every_plan_gives_the_same_bits(gen, M, K, N, swap, tile):
    """Every instance of the core, in either orientation, with K split over
    1, 2, up to 16 blocks: the int32 sums are exact, so the result is the
    plain version bit for bit, and the same again on a second call."""
    x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
    w = _w(K, N, gen)
    cs = torch.rand((1, N), generator=gen, device="cuda") * 1e-3
    b = torch.randn((N,), generator=gen, device="cuda")
    r = torch.randn((M, N), generator=gen, device="cuda").to(torch.bfloat16)
    xi, sx = im._quant_rows(x)
    wt = im._k_major(w)
    ref = im.int8w_matmul_plain(x, w, cs, b, None, r, torch.bfloat16)
    ksteps = -(-K // 128)
    for splits in sorted({1, 2, 3, 16, ksteps}):
        if splits > min(16, ksteps):
            continue
        plan = dict(swap=swap, tile=tile, splits=splits)
        out = im._gemm(xi, sx, wt, cs, b, r, False, torch.bfloat16, plan)
        again = im._gemm(xi, sx, wt, cs, b, r, False, torch.bfloat16, plan)
        torch.cuda.synchronize()
        assert torch.equal(out, ref), plan
        assert torch.equal(again, out), plan


def test_gemm_plan_is_the_same_in_cpp_and_python(gen):
    """csrc/int8_gemm.cu: gemm_plan and ops/int8_matmul.py: gemm_plan agree
    (the wrapper passes Python's plan to the kernel)."""
    fn = _build.function("dlm_int8_gemm_plan")
    for sms in (132, 114, 78):
        for M in (1, 5, 8, 17, 33, 64, 65, 130, 256, 2048, 8192):
            for N in (8, 24, 768, 2304, 3072):
                for K in (16, 48, 768, 3072):
                    p = im.gemm_plan(M, N, K, sms)
                    want = int(p["swap"]) * 10000 + p["tile"] * 100 + \
                        p["splits"]
                    assert fn(M, N, K, sms) == want, (M, N, K, sms)


def _mlp_args(gen, M, D, F, out_dtype=torch.float32):
    x = torch.randn((M, D), generator=gen, device="cuda").to(torch.bfloat16)
    w1, w2 = _w(D, F, gen), _w(F, D, gen)
    cs1 = torch.rand((1, F), generator=gen, device="cuda") * 1e-3
    cs2 = torch.rand((1, D), generator=gen, device="cuda") * 1e-3
    b1 = torch.randn((F,), generator=gen, device="cuda")
    b2 = torch.randn((D,), generator=gen, device="cuda")
    r = torch.randn((M, D), generator=gen, device="cuda").to(torch.bfloat16)
    return (x, w1, cs1, b1, w2, cs2, b2, r, out_dtype)


def test_int8w_mlp_kernel_matches_twin(gen):
    args = _mlp_args(gen, 100, 128, 512)
    out = im.int8w_mlp(*args)
    ref = im.int8w_mlp_plain(*args)
    rel = float((out - ref).norm() / ref.norm())
    assert rel <= 1e-3, rel  # one requant level of the f32 inner may move


# the sampler's widths (M = 2048, 768 -> 3072 -> 768), the anchor's
# (256 -> 1024 -> 256) and a ragged one: M % 16, K and F not multiples of 64
MLP_SHAPES = [(2048, 768, 3072), (37, 256, 1024), (130, 80, 208)]


@pytest.mark.parametrize("M,D,F", MLP_SHAPES)
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_int8w_mlp_fused_equals_chained(gen, M, D, F, out_dtype):
    """The fused kernel keeps the inner tile on chip but rounds every step as
    the chained kernels do: bit for bit equal; within 1e-3 of the plain
    version (tanh's last bit may move one requant level)."""
    args = _mlp_args(gen, M, D, F, out_dtype)
    assert im.mlp_fits(D, F)
    _build.reset_launch_counts()
    out = im.int8w_mlp(*args)
    chained = im.int8w_mlp_chained(*args)
    torch.cuda.synchronize()
    assert _build.launch_counts["int8w_mlp"] == 1
    assert _build.launch_counts["int8w_mlp_chained"] == 1
    assert torch.equal(out, chained)
    ref = im.int8w_mlp_plain(*args)
    rel = float((out.float() - ref.float()).norm() / ref.float().norm())
    assert rel <= 1e-3, rel


# the fused kernel's edges: a row tile of 1 and of 100 rows, 2048 + 37 rows
# (the last tile ragged); K of 128 and 768; F of 512, 1024 and 3072 (one,
# two and six rounds); N = 80, where two of a cluster's four blocks own no
# output tile; N = 1024, four tiles a block
MLP_EDGES = [(128, 512, 128), (128, 1024, 80), (768, 512, 768),
             (768, 1024, 768), (768, 3072, 768), (128, 3072, 1024)]


@pytest.mark.parametrize("M", [1, 100, 2048 + 37])
@pytest.mark.parametrize("K,F,N", MLP_EDGES)
@pytest.mark.parametrize("extras", [True, False])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_int8w_mlp_fused_edges_equal_chained(gen, M, K, F, N, extras,
                                             out_dtype):
    """With and without both biases and the residual: bit for bit the
    chained kernels, within 1e-3 of the plain version."""
    x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
    w1, w2 = _w(K, F, gen), _w(F, N, gen)
    cs1 = torch.rand((1, F), generator=gen, device="cuda") * 1e-3
    cs2 = torch.rand((1, N), generator=gen, device="cuda") * 1e-3
    b1 = torch.randn((F,), generator=gen, device="cuda") if extras else None
    b2 = torch.randn((N,), generator=gen, device="cuda") if extras else None
    r = (torch.randn((M, N), generator=gen, device="cuda").to(torch.bfloat16)
         if extras else None)
    args = (x, w1, cs1, b1, w2, cs2, b2, r, out_dtype)
    assert im.mlp_fits(K, F, N)
    _build.reset_launch_counts()
    out = im.int8w_mlp(*args)
    chained = im.int8w_mlp_chained(*args)
    torch.cuda.synchronize()
    assert _build.launch_counts["int8w_mlp"] == 1
    assert out.dtype == out_dtype and out.shape == (M, N)
    assert torch.equal(out, chained)
    ref = im.int8w_mlp_plain(
        x, w1, cs1, torch.zeros((F,), device="cuda") if b1 is None else b1,
        w2, cs2, torch.zeros((N,), device="cuda") if b2 is None else b2, r,
        out_dtype)
    rel = float((out.float() - ref.float()).norm() / ref.float().norm())
    assert rel <= 1e-3, rel


def test_int8w_mlp_too_wide_runs_chained(gen):
    """The fused kernel takes inner rows up to 3072: at 4096 the chained
    kernels run, counted under their own name."""
    args = _mlp_args(gen, 40, 256, 4096)
    assert not im.mlp_fits(256, 4096)
    _build.reset_launch_counts()
    out = im.int8w_mlp(*args)
    torch.cuda.synchronize()
    assert dict(_build.launch_counts) == {"int8w_mlp_chained": 1}
    ref = im.int8w_mlp_plain(*args)
    assert float((out - ref).norm() / ref.norm()) <= 1e-3


# the sampler's shape, JAX's largest S at that width (864), a ragged S with
# heads of 32, and heads of 8 (a partial 64-wide head-dimension chunk)
QKV_SHAPES = [(8, 256, 768, 12), (1, 864, 768, 12), (2, 200, 128, 4),
              (2, 72, 64, 8),
              # ragged S at heads of 32 and 128; heads of 128 at S = 864;
              # heads of 24 (padded to 32) and of 256
              (2, 328, 256, 8), (2, 136, 512, 4), (1, 864, 768, 6),
              (2, 72, 120, 5), (1, 64, 768, 3),
              # the wgmma design's instances of 192 and 256: heads of 136
              # (padded to 192), of 192 at S = 864, of 200 (padded to 256),
              # of 256 at the sampler's shape; and of 384, past them (the
              # cluster kernel)
              (2, 136, 544, 4), (1, 864, 768, 4), (2, 200, 800, 4),
              (8, 256, 768, 3), (1, 64, 768, 2),
              # the cluster kernel (heads of 264 to 2048): heads of 264 (a
              # last block of 8 columns) at S = 136; 2 of 384 and one of 768
              # at B = 8, S = 256 and 864; 2048 (a cluster of 8) at S = 200;
              # one cluster (B = 1, S = 104); long rows of keys (S = 1024
              # and 1200 at heads of 264) and clusters of 2, 4 and 6
              (2, 136, 528, 2), (8, 256, 768, 2), (1, 864, 768, 2),
              (8, 864, 768, 2), (8, 256, 768, 1), (8, 864, 768, 1),
              (2, 200, 2048, 1), (1, 104, 768, 1), (1, 1024, 264, 1),
              (1, 1200, 264, 1), (2, 512, 512, 1), (1, 384, 1024, 1),
              (1, 512, 1536, 1),
              # past 2048, blocks of k slices of 256 columns: one head of
              # 2056 (k = 2, a last block of 8 columns), of 2560 (k = 2), of
              # 4104 (k = 3) and of 10240 (k = 5, clusters of 8), each at
              # the longest S JAX's predicate admits near its row, ragged
              (2, 72, 2056, 1), (8, 256, 2056, 1), (1, 136, 2560, 1),
              (1, 104, 4104, 1), (2, 240, 4104, 1), (1, 96, 10240, 1)]


@pytest.mark.parametrize("B,S,D,H", QKV_SHAPES)
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_fused_qkv_attention_kernel_matches_plain(gen, B, S, D, H, out_dtype):
    """The kernel's QK^T sums in another order and uses CUDA's expf, which
    can move a bf16 rounding of P: relative Frobenius error <= 1e-3 with f32
    out, 5e-3 with bf16 out (the output's own rounding may move too)."""
    qkv = torch.randn((B, S, 3 * D), generator=gen,
                      device="cuda").to(torch.bfloat16)
    _build.reset_launch_counts()
    out = qa.fused_qkv_attention(qkv, H, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert _build.launch_counts["fused_qkv_attention"] == 1
    assert out.shape == (B, S, D) and out.dtype == out_dtype
    ref = qa.fused_qkv_attention_plain(qkv, H, out_dtype=out_dtype)
    rel = float((out.float() - ref.float()).norm() / ref.float().norm())
    assert rel <= (1e-3 if out_dtype == torch.float32 else 5e-3), rel


@pytest.mark.parametrize("B,S,D,H", [(8, 256, 768, 2), (1, 104, 768, 1),
                                     (1, 1024, 264, 1), (2, 72, 2056, 1),
                                     (1, 104, 4104, 1)])
def test_fused_qkv_cluster_replays_bit_for_bit(gen, B, S, D, H):
    """The cluster kernel (heads past 256) in a captured CUDA graph,
    replayed, equals the eager call bit for bit (the logits' scratch is
    allocated in the graph's pool and lives with it)."""
    qkv = torch.randn((B, S, 3 * D), generator=gen,
                      device="cuda").to(torch.bfloat16)
    assert qa.fused_qkv_instance(D // H) == "_cluster"
    out = qa.fused_qkv_attention(qkv, H)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        g_out = qa.fused_qkv_attention(qkv, H)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(g_out, out)


def test_fused_qkv_past_2048_runs_the_first_design(gen):
    """(Named when the kernel's first design served these heads; it is
    gone.) Past 2048 (one head of 2056) fused-QKV attention launches the
    cluster kernel (`dlm_fused_qkv_attention_cluster`, two 256-column
    slices a block), within the plain version's tolerance; the `wgmma`
    entry point `dlm_fused_qkv_attention` refuses every head past 256."""
    B, S, D = 2, 72, 2056
    qkv = torch.randn((B, S, 3 * D), generator=gen,
                      device="cuda").to(torch.bfloat16)
    assert qa.fused_qkv_instance(D) == "_cluster"
    assert qa.cluster_plan(D) == (5, 2)
    _build.reset_launch_counts()
    out = qa.fused_qkv_attention(qkv, 1, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert _build.launch_counts["fused_qkv_attention"] == 1
    ref = qa.fused_qkv_attention_plain(qkv, 1, out_dtype=torch.float32)
    assert float((out - ref).norm() / ref.norm()) <= 1e-3
    first = _build.function("dlm_fused_qkv_attention")
    small = torch.zeros((1, 64, 3 * 768), device="cuda", dtype=torch.bfloat16)
    dst = torch.empty((1, 64, 768), device="cuda")
    for Hd in (264, 768, 2048, 2056, 4104):  # refused before anything is read
        assert first(small.data_ptr(), dst.data_ptr(), 0, 1, 64, 1, Hd, 0.1,
                     torch.cuda.current_stream().cuda_stream) != 0


def test_fused_qkv_attention_returns_none_where_jax_does(gen):
    for shape, H in (((1, 872, 3 * 768), 12), ((1, 20, 3 * 64), 2),
                     ((1, 64, 3 * 96), 8)):
        qkv = torch.zeros(shape, device="cuda", dtype=torch.bfloat16)
        assert qa.fused_qkv_attention(qkv, H) is None


@pytest.mark.parametrize("BH,Sq,Skv", [(3, 64, 64), (2, 100, 1000),
                                       (4, 128, 256), (2, 70, 130)])
@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_dense_attention_kernel_matches_twin(gen, BH, Sq, Skv, D, out_dtype):
    """bf16 P rounds at other tile boundaries than the twin's (128-wide KV
    tiles against up to 512): |d| <= 1e-2 and relative Frobenius <= 1e-2,
    the second bounding the error against the output's typical size."""
    q = torch.randn((BH, Sq, D), generator=gen, device="cuda")
    k, v = (torch.randn((BH, Skv, D), generator=gen, device="cuda")
            for _ in range(2))
    _build.reset_launch_counts()
    out = dense_attention(q, k, v, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert _build.launch_counts["dense_attention"] == 1
    assert out.dtype == out_dtype and out.shape == (BH, Sq, D)
    ref = dense_attention_plain(q, k, v, out_dtype=out_dtype)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=1e-2)
    rel = float((out.float() - ref.float()).norm() / ref.float().norm())
    assert rel <= 1e-2, rel


# the cluster kernels of dense and single-sequence paged attention
# (csrc/wide_cluster_flash.cuh, heads of 264 to 2048; WIDER holds 264, 384,
# 512, 768, 1024 and 2048): a last block of 16 columns (272), a cluster of 3
# with 8-byte reads of the pools (520), and the first width past them, in
# blocks of 2 slices (2056)
CLUSTER_EDGES = [272, 520, 2056]


@pytest.mark.parametrize("Skv", [64, 999])
@pytest.mark.parametrize("D", CLUSTER_EDGES)
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_dense_attention_cluster_edges_match_twin(gen, Skv, D, out_dtype):
    """The tolerance of `test_dense_attention_kernel_matches_twin`, ragged Sq
    and Skv."""
    q = torch.randn((2, 100, D), generator=gen, device="cuda")
    k, v = (torch.randn((2, Skv, D), generator=gen, device="cuda")
            for _ in range(2))
    assert qa.dense_instance(D) == "_cluster"
    _build.reset_launch_counts()
    out = dense_attention(q, k, v, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert _build.launch_counts["dense_attention"] == 1
    assert out.dtype == out_dtype and out.shape == (2, 100, D)
    ref = dense_attention_plain(q, k, v, out_dtype=out_dtype)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=1e-2)
    rel = float((out.float() - ref.float()).norm() / ref.float().norm())
    assert rel <= 1e-2, rel


def test_cluster_kernels_place_every_cluster_size(gen):
    """The card runs clusters of every size the cluster kernels launch (2
    to 8 blocks, one an SM; past 2048 the k-slice kernel's clusters of 5 to
    8), and the dense kernel refuses heads of 256 and below, and past 2048
    a call without the scratch its two passes share, rather than serve
    them."""
    fn = _build.function("dlm_dense_attention_cluster_active")
    for D in (264, 520, 776, 1032, 1288, 1544, 1800, 2048, 2056, 2824, 3592,
              4104, 10240):
        assert fn(D) > 0, D
    q = torch.randn((1, 8, 2056), device="cuda").bfloat16()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream
    for D in (256, 2056):
        assert _build.function("dlm_dense_attention_cluster")(
            q.data_ptr(), q.data_ptr(), q.data_ptr(), out.data_ptr(), 1, 1, 8,
            8, D, 1.0, stream, 0) != 0


def test_kernels_refuse_what_they_do_not_take(gen):
    """Heads of 48, which this test refused until the kernels took every
    multiple of 8, match the twin; so do heads wider than 256 (refused
    until the wide instance, ROADMAP C41) and `int8w_matmul` at K = 24
    (refused until the wrapper padded K to 16, C43), bit for bit. Heads of
    no multiple of 8 (JAX returns None, and `flash_fold` takes the einsum),
    float16 out and a float16 residual are refused."""
    x = torch.randn((4, 24), device="cuda")
    w, cs = _w(24, 8, gen), torch.rand(1, 8, device="cuda") * 1e-3
    _build.reset_launch_counts()
    out = im.int8w_matmul(x, w, cs)
    torch.cuda.synchronize()
    assert _build.launch_counts["int8w_matmul"] == 1
    assert torch.equal(out, im.int8w_matmul_plain(x, w, cs))
    for D in (48, 264):
        q = torch.randn((1, 8, D), device="cuda")
        _build.reset_launch_counts()
        out = dense_attention(q, q, q)
        torch.cuda.synchronize()
        assert _build.launch_counts["dense_attention"] == 1
        ref = dense_attention_plain(q, q, q)
        assert float((out.float() - ref.float()).norm()
                     / ref.float().norm()) <= 1e-2
    q = torch.randn((1, 8, 12), device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        dense_attention(q, q, q)
    for D in (64, 264):
        q = torch.randn((1, 8, D), device="cuda")
        with pytest.raises(ValueError, match="writes bf16 or f32"):
            dense_attention(q, q, q, out_dtype=torch.float16)
    r = torch.randn((4, 8), device="cuda").half()
    with pytest.raises(ValueError, match="residual must be bf16 or f32"):
        im.int8w_matmul(x[:, :16], _w(16, 8, gen),
                        torch.ones(1, 8, device="cuda"), residual=r)


@pytest.mark.parametrize("M,K,N", [(4, 24, 8), (37, 48, 6), (8, 100, 30),
                                   (130, 776, 2302), (1, 8, 1)])
@pytest.mark.parametrize("res_dtype", [None, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("gelu", [False, True])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_int8w_matmul_off_alignment_and_f32_residual(gen, M, K, N, res_dtype,
                                                     gelu, out_dtype):
    """K off 16 and N off 4 run padded with zeros (ROADMAP C43), and the
    residual may be f32 (C42, added in f32 before the output's rounding, as
    JAX's `_kernel_i8w` adds r.astype(f32)): the tolerance of
    `test_int8w_matmul_kernel_matches_twin`, bit for bit without gelu. The
    padded weight is held once."""
    x = torch.randn((M, K), generator=gen, device="cuda")
    w = _w(K, N, gen)
    cs = torch.rand((1, N), generator=gen, device="cuda") * 1e-3
    b = torch.randn((N,), generator=gen, device="cuda")
    r = (None if res_dtype is None else
         torch.randn((M, N), generator=gen, device="cuda").to(res_dtype))
    act = "gelu" if gelu else None
    _build.reset_launch_counts()
    out = im.int8w_matmul(x, w, cs, b, act, r, out_dtype)
    again = im.int8w_matmul(x, w, cs, b, act, r, out_dtype)
    torch.cuda.synchronize()
    assert _build.launch_counts["int8w_matmul"] == 2
    assert out.dtype == out_dtype and out.shape == (M, N)
    assert torch.equal(out, again)
    padded = K % 16 or N % 4
    assert bool(padded) == any(k[0] == id(w) for k in im._padded_copies)
    ref = im.int8w_matmul_plain(x, w, cs, b, act, r, out_dtype)
    if not gelu:
        assert torch.equal(out, ref)
        return
    rtol = 1e-5 if out_dtype == torch.float32 else 2.0 ** -7
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol, atol=1e-6)


@pytest.mark.parametrize("M,K,F,N", [(100, 128, 512, 128), (37, 100, 200, 30),
                                     (2048 + 37, 768, 3072, 768),
                                     (40, 256, 4096, 256), (9, 24, 40, 6)])
@pytest.mark.parametrize("res_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_int8w_mlp_off_alignment_and_f32_residual(gen, M, K, F, N, res_dtype,
                                                  out_dtype):
    """`int8w_mlp` (the fused kernel, or the chained kernels where the fused
    one does not take the widths) and `int8w_mlp_chained` with an f32 or
    bf16 residual (ROADMAP C42) and widths off 16 and 4 (C43, padded with
    zeros: the inner columns past F come out gelu(0) = 0): the two equal
    bit for bit, within 1e-3 of the plain version, as at aligned widths."""
    x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
    w1, w2 = _w(K, F, gen), _w(F, N, gen)
    cs1 = torch.rand((1, F), generator=gen, device="cuda") * 1e-3
    cs2 = torch.rand((1, N), generator=gen, device="cuda") * 1e-3
    b1 = torch.randn((F,), generator=gen, device="cuda")
    b2 = torch.randn((N,), generator=gen, device="cuda")
    r = torch.randn((M, N), generator=gen, device="cuda").to(res_dtype)
    args = (x, w1, cs1, b1, w2, cs2, b2, r, out_dtype)
    fused = im.mlp_fits(-(-K // 16) * 16, -(-F // 16) * 16, -(-N // 4) * 4)
    _build.reset_launch_counts()
    out = im.int8w_mlp(*args)
    chained = im.int8w_mlp_chained(*args)
    torch.cuda.synchronize()
    assert dict(_build.launch_counts) == (
        {"int8w_mlp": 1, "int8w_mlp_chained": 1} if fused
        else {"int8w_mlp_chained": 2})
    assert out.dtype == out_dtype and out.shape == (M, N)
    assert torch.equal(out, chained)
    ref = im.int8w_mlp_plain(*args)
    rel = float((out.float() - ref.float()).norm() / ref.float().norm())
    assert rel <= 1e-3, rel


def _pools(gen, n_slots, HG, P, GD, bits, G=None):
    """Random pools in the JAX layout: any byte is a valid packed page;
    zero-points near the middle of the level range and scales that span
    about +-3, as quantized N(0, 1) keys and values have. G defaults to
    GD / 64 (heads of 64)."""
    Pp = P // (8 // bits)
    qmax = (1 << bits) - 1
    G = GD // 64 if G is None else G
    data = [torch.randint(0, 256, (n_slots, HG, Pp, GD), generator=gen,
                          device="cuda", dtype=torch.uint8) for _ in range(2)]
    side = [torch.rand((n_slots, HG, G * P), generator=gen,
                       device="cuda") * s + o
            for s, o in ((3.0 / qmax, 1.5 / qmax), (0.2 * qmax, 0.4 * qmax),
                         (3.0 / qmax, 1.5 / qmax), (0.2 * qmax, 0.4 * qmax))]
    return data[0], side[0], side[1], data[1], side[2], side[3]


def _close(out, lse, ref, ref_lse):
    """Relative Frobenius error <= 1e-2 on the output, lse within 1e-3:
    the kernel's sums run in another order and with CUDA's expf, which can
    move a bf16 rounding of P."""
    rel = float((out - ref).norm() / ref.norm())
    assert rel <= 1e-2, rel
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-3)


# (head dim, head group): the pool rows of 128 that `_choose_head_group`
# builds for heads of 32, 64 and 128, heads of 64 ungrouped, and the 4 heads
# of 16 of `DiffusionConfig.tiny()` (G = 1: 8 heads of 16 do not divide 4)
DG = [(16, 1), (32, 4), (64, 1), (64, 2), (128, 1)] + [
    pytest.param(d, g, id=f"D{d}G{g}") for d, g in (
        # every new width ungrouped, as `_choose_head_group` leaves 96 and
        # 256; heads of 48 in groups of 8 (rows of 384), where JAX's kernel
        # runs, and of 24 in groups of 2 (8-byte reads of the pool)
        (8, 1), (24, 2), (48, 1), (48, 8), (80, 1), (96, 1), (136, 1),
        (192, 1), (200, 1), (256, 1))] + [
    # the cluster kernels (csrc/wide_cluster_flash.cuh): every WIDER width
    # alone, and heads of 384 in pairs (rows of 768)
    pytest.param(d, g, id=f"W{d}G{g}") for d, g in (
        (264, 1), (384, 1), (384, 2), (512, 1), (768, 1), (1024, 1),
        (2048, 1))]
PAGES = [8, 16, 24, 32, 64, 72, 128]


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("P", PAGES)
@pytest.mark.parametrize("D,G", DG)
def test_batched_paged_attention_kernel_matches_twin(gen, bits, P, D, G):
    """Three slots: three scattered pages with a partial last one, an empty
    slot, and one page; 100 query rows (a ragged q tile); 4 heads, or one
    group of G."""
    B, H, Sq = 3, max(4, G), 100
    pools = _pools(gen, 7, H // G, P, G * D, bits, G)
    q = torch.randn((B, H, Sq, D), generator=gen, device="cuda")
    pt = torch.tensor([[5, 0, 3], [0, 0, 0], [6, 0, 0]], device="cuda",
                      dtype=torch.int32)
    nt = torch.tensor([[P, P, P // 2 + 3], [0, 0, 0], [P, 0, 0]],
                      device="cuda", dtype=torch.int32)
    npg = torch.tensor([3, 0, 1], device="cuda", dtype=torch.int32)
    _build.reset_launch_counts()
    out, lse = pa.batched_paged_attention(q, pt, nt, npg, *pools, bits=bits,
                                          return_lse=True, head_group=G)
    torch.cuda.synchronize()
    assert _build.launch_counts["batched_paged_attention"] == 1
    assert _build.launch_counts["paged_unpack"] == 1
    ref, ref_lse = pa.batched_paged_attention_plain(
        q, pt, nt, npg, *pools, bits=bits, return_lse=True, head_group=G)
    assert torch.all(out[1] == 0) and torch.all(lse[1] == pa.NEG_INF)
    _close(out, lse, ref, ref_lse)


@pytest.mark.parametrize("a8,bits", [(False, 1), (False, 2), (False, 4),
                                     (False, 8), (True, 2), (True, 4),
                                     (True, 8)])
@pytest.mark.parametrize("P", PAGES)
@pytest.mark.parametrize("D,G", DG)
def test_paged_unpack_kernel_equals_twin(gen, a8, bits, P, D, G):
    """The unpack pass bit for bit against its plain twin on every live page
    (pages past a slot's count are left unwritten): scattered slots, a table
    that reads another slot's pages, an empty slot, a compacted table. (1-bit
    pages take the bf16 path at either act_bits.)"""
    B, H = 3, max(4, G)
    pools = _pools(gen, 7, H // G, P, G * D, bits, G)
    pt = torch.tensor([[5, 0, 3, 6], [0, 0, 0, 0], [6, 5, 0, 0]],
                      device="cuda", dtype=torch.int32)
    npg = torch.tensor([4, 0, 2], device="cuda", dtype=torch.int32)
    _build.reset_launch_counts()
    got = pa.paged_unpack(pt, npg, *pools, bits=bits, head_group=G, a8=a8)
    torch.cuda.synchronize()
    assert _build.launch_counts["paged_unpack"] == 1
    want = pa.paged_unpack_plain(pt, npg, *pools, bits=bits, head_group=G,
                                 a8=a8)
    for b, n in enumerate(npg.tolist()):
        for x, y in zip(got, want):
            assert torch.equal(x[b, :, :n], y[b, :, :n])


@pytest.mark.parametrize("act_bits", [16, 8])
@pytest.mark.parametrize("P", [64, 72, 128])
@pytest.mark.parametrize("D,G", DG)
def test_batched_paged_attention_long_tables(gen, act_bits, P, D, G):
    """Nine pages, more than the kernels' ring of three stages holds, with a
    partial last page, next to a slot that reads the first five entries of
    its table; 300 query rows (three tiles of 128, the last ragged)."""
    B, H, Sq, n = 2, max(4, G), 300, 9
    pools = _pools(gen, 12, H // G, P, G * D, 4, G)
    q = torch.randn((B, H, Sq, D), generator=gen, device="cuda")
    pt = torch.stack([torch.randperm(12, generator=gen, device="cuda")[:n]
                      for _ in range(B)]).to(torch.int32)
    nt = torch.full((B, n), P, device="cuda", dtype=torch.int32)
    nt[0, n - 1] = P // 2 + 1
    nt[1, 4] = 9
    npg = torch.tensor([n, 5], device="cuda", dtype=torch.int32)
    name = "batched_paged_attention" + ("_a8" if act_bits == 8 else "")
    _build.reset_launch_counts()
    out, lse = pa.batched_paged_attention(q, pt, nt, npg, *pools, bits=4,
                                          return_lse=True, head_group=G,
                                          act_bits=act_bits)
    torch.cuda.synchronize()
    assert dict(_build.launch_counts) == {name: 1, "paged_unpack": 1}
    plain = (pa.batched_paged_attention_a8_plain if act_bits == 8
             else pa.batched_paged_attention_plain)
    ref, ref_lse = plain(q, pt, nt, npg, *pools, bits=4, return_lse=True,
                         head_group=G)
    if act_bits == 8:  # the tolerance of the int8 path against its twin
        assert float((out - ref).norm() / ref.norm()) <= 5e-3
        torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-3)
    else:
        _close(out, lse, ref, ref_lse)


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("P", PAGES)
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_paged_attention_kernel_matches_twin(gen, bits, P, D):
    BH, Sq = 4, 70
    pools = _pools(gen, 5, BH, P, D, bits, 1)
    q = torch.randn((BH, Sq, D), generator=gen, device="cuda")
    pt = torch.tensor([4, 1, 2], device="cuda", dtype=torch.int32)
    nt = torch.tensor([P, P, min(17, P - 1)], device="cuda", dtype=torch.int32)
    _build.reset_launch_counts()
    out, lse = pa.paged_attention(q, pt, *pools, bits=bits, page_tokens=nt,
                                  return_lse=True)
    torch.cuda.synchronize()
    assert _build.launch_counts["paged_attention"] == 1
    ref, ref_lse = pa.paged_attention_plain(q, pt, *pools, bits=bits,
                                            page_tokens=nt, return_lse=True)
    _close(out, lse, ref, ref_lse)


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("P", [32, 64, 128])
@pytest.mark.parametrize("D", CLUSTER_EDGES)
def test_paged_attention_cluster_edges_match_twin(gen, bits, P, D):
    """The tolerance of `test_paged_attention_kernel_matches_twin`, with an
    empty page, a partial one and the lse, at the cluster design's edges."""
    BH, Sq = 2, 70
    pools = _pools(gen, 5, BH, P, D, bits, 1)
    q = torch.randn((BH, Sq, D), generator=gen, device="cuda")
    pt = torch.tensor([4, 1, 2, 0], device="cuda", dtype=torch.int32)
    nt = torch.tensor([P, 0, min(17, P - 1), P], device="cuda",
                      dtype=torch.int32)
    _build.reset_launch_counts()
    out, lse = pa.paged_attention(q, pt, *pools, bits=bits, page_tokens=nt,
                                  return_lse=True)
    torch.cuda.synchronize()
    assert _build.launch_counts["paged_attention"] == 1
    ref, ref_lse = pa.paged_attention_plain(q, pt, *pools, bits=bits,
                                            page_tokens=nt, return_lse=True)
    _close(out, lse, ref, ref_lse)


@pytest.mark.parametrize("D", [384, 768])
def test_paged_attention_cluster_splits_merge_in_launch(gen, D):
    """One sequence at wide heads splits its page chain over clusters
    (`csrc/wide_cluster_flash.cuh: paged_splits`) and merges the splits in
    the same launch: one launch, the plain version's tolerance, a graph
    replay equal to the eager call bit for bit (whichever block merges, the
    splits add in order), and the merge counters left at zero."""
    BH, Sq, P, bits = 1, 256, 128, 4
    pools = _pools(gen, 10, BH, P, D, bits, 1)
    q = torch.randn((BH, Sq, D), generator=gen, device="cuda")
    pt = torch.tensor([3, 7, 1, 9, 0, 5, 2, 8], device="cuda",
                      dtype=torch.int32)
    nt = torch.tensor([P] * 7 + [70], device="cuda", dtype=torch.int32)
    splits = _build.function("dlm_paged_attention_cluster_splits")(
        BH, Sq, D, 8, P)
    assert splits > 1, splits
    _build.reset_launch_counts()
    out, lse = pa.paged_attention(q, pt, *pools, bits=bits, page_tokens=nt,
                                  return_lse=True)
    torch.cuda.synchronize()
    assert _build.launch_counts["paged_attention"] == 1
    _close(out, lse, *pa.paged_attention_plain(
        q, pt, *pools, bits=bits, page_tokens=nt, return_lse=True))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        g_out, g_lse = pa.paged_attention(q, pt, *pools, bits=bits,
                                          page_tokens=nt, return_lse=True)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(g_out, out) and torch.equal(g_lse, lse)
    assert not any(bool(t.any()) for t in qa._split_counters[q.device])


# past 2048 every attention kernel gives a block k slices of 256 columns
# (`cluster_plan`): 2056 (k =
# 2, a last block of 8 columns), 2560 (k = 2), 4104 (k = 3) and 10240 (k =
# 5, clusters of 8)
PAST = [2056, 2560, 4104, 10240]


@pytest.mark.parametrize("BH,Sq,Skv", [(2, 100, 999), (1, 128, 64),
                                       (3, 300, 130)])
@pytest.mark.parametrize("D", PAST)
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_dense_attention_past_2048_matches_twin(gen, BH, Sq, Skv, D,
                                                out_dtype):
    """The tolerance of `test_dense_attention_kernel_matches_twin`, ragged
    Sq and Skv (a last tile of 7 and of 2 keys), one head, launched through
    `dlm_dense_attention_cluster` in blocks of k slices."""
    q = torch.randn((BH, Sq, D), generator=gen, device="cuda")
    k, v = (torch.randn((BH, Skv, D), generator=gen, device="cuda")
            for _ in range(2))
    assert qa.dense_instance(D) == "_cluster" and qa.cluster_plan(D)[1] > 1
    _build.reset_launch_counts()
    out = dense_attention(q, k, v, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert _build.launch_counts["dense_attention"] == 1
    assert out.dtype == out_dtype and out.shape == (BH, Sq, D)
    ref = dense_attention_plain(q, k, v, out_dtype=out_dtype)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=1e-2)
    rel = float((out.float() - ref.float()).norm() / ref.float().norm())
    assert rel <= 1e-2, rel


def test_dense_attention_past_2048_with_a_large_scratch(gen):
    """BH = 16, S = 4096 at heads of 2056: pass 1's S for pass 2 would take
    1 GiB, so the wrapper runs 4 launches of 4 heads, each keeping 256 MiB
    (`DENSE_SCRATCH`), and the call takes no more than its output and that;
    the kernel matches its twin at its tolerance, and a graph replay gives
    the eager call's bits."""
    BH, S, D = 16, 4096, 2056
    q, k, v = (torch.randn((BH, S, D), generator=gen, device="cuda")
               .bfloat16() for _ in range(3))
    assert BH * S * S * 4 == 4 * qa.DENSE_SCRATCH
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    _build.reset_launch_counts()
    out = dense_attention(q, k, v)
    torch.cuda.synchronize()
    assert _build.launch_counts["dense_attention"] == 4
    peak = torch.cuda.max_memory_allocated() - before
    assert peak <= out.numel() * 2 + qa.DENSE_SCRATCH + 4 * 2**20, peak
    ref = dense_attention_plain(q, k, v)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=1e-2)
    rel = float((out.float() - ref.float()).norm() / ref.float().norm())
    assert rel <= 1e-2, rel
    del ref
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        g_out = dense_attention(q, k, v)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(g_out, out)


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("P", [8, 32, 72, 128])
@pytest.mark.parametrize("D", PAST)
def test_paged_attention_past_2048_matches_twin(gen, bits, P, D):
    """The tolerance of `test_paged_attention_kernel_matches_twin` (rel
    Frobenius 1e-2, lse 1e-3), with an empty page, a partial one and slots
    in mixed order, launched through `dlm_paged_attention_cluster`."""
    BH, Sq = 2, 70
    pools = _pools(gen, 5, BH, P, D, bits, 1)
    q = torch.randn((BH, Sq, D), generator=gen, device="cuda")
    pt = torch.tensor([4, 1, 2, 0], device="cuda", dtype=torch.int32)
    nt = torch.tensor([P, 0, min(17, P - 1), P], device="cuda",
                      dtype=torch.int32)
    assert pa.paged_instance(D) == "_cluster" and qa.cluster_plan(D)[1] > 1
    _build.reset_launch_counts()
    out, lse = pa.paged_attention(q, pt, *pools, bits=bits, page_tokens=nt,
                                  return_lse=True)
    torch.cuda.synchronize()
    assert _build.launch_counts["paged_attention"] == 1
    ref, ref_lse = pa.paged_attention_plain(q, pt, *pools, bits=bits,
                                            page_tokens=nt, return_lse=True)
    _close(out, lse, ref, ref_lse)


@pytest.mark.parametrize("D", [2056, 4104])
def test_paged_attention_past_2048_splits_merge_in_launch(gen, D):
    """Past 2048 one sequence's page chain splits over clusters as it does
    at 264-2048 (`paged_splits`): one launch, the plain version's
    tolerance, a graph replay equal to the eager call bit for bit (the
    scratch pass 2 replays lives in the graph's pool), the counters left at
    zero; every page masked weighs each key 1, as in the plain version."""
    BH, Sq, P, bits = 1, 256, 128, 4
    pools = _pools(gen, 10, BH, P, D, bits, 1)
    q = torch.randn((BH, Sq, D), generator=gen, device="cuda")
    pt = torch.tensor([3, 7, 1, 9, 0, 5, 2, 8], device="cuda",
                      dtype=torch.int32)
    nt = torch.tensor([P] * 7 + [70], device="cuda", dtype=torch.int32)
    splits = _build.function("dlm_paged_attention_cluster_splits")(
        BH, Sq, D, 8, P)
    assert splits > 1, splits
    for tokens in (nt, torch.zeros_like(nt)):
        _build.reset_launch_counts()
        out, lse = pa.paged_attention(q, pt, *pools, bits=bits,
                                      page_tokens=tokens, return_lse=True)
        torch.cuda.synchronize()
        assert _build.launch_counts["paged_attention"] == 1
        _close(out, lse, *pa.paged_attention_plain(
            q, pt, *pools, bits=bits, page_tokens=tokens, return_lse=True))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        g_out, g_lse = pa.paged_attention(q, pt, *pools, bits=bits,
                                          page_tokens=nt, return_lse=True)
    graph.replay()
    torch.cuda.synchronize()
    out, lse = pa.paged_attention(q, pt, *pools, bits=bits, page_tokens=nt,
                                  return_lse=True)
    assert torch.equal(g_out, out) and torch.equal(g_lse, lse)
    assert not any(bool(t.any()) for t in qa._split_counters[q.device])


def _cluster_mode_call(gen, mode, D):
    """One call of a cluster-design mode at heads of D, as a function of no
    arguments over inputs made once."""
    if mode == "dense":
        q, k, v = (torch.randn((2, 300, D), generator=gen, device="cuda")
                   for _ in range(3))
        return lambda: dense_attention(q, k, v, out_dtype=torch.float32)
    if mode == "fused_qkv":
        qkv = torch.randn((2, 136, 3 * D), generator=gen,
                          device="cuda").to(torch.bfloat16)
        return lambda: qa.fused_qkv_attention(qkv, 1, out_dtype=torch.float32)
    if mode == "contig":
        q = torch.randn((2, 200, D), generator=gen, device="cuda")
        k, v = (qa.quantize_kv(torch.randn((2, 300, D), generator=gen,
                                           device="cuda"), 4) for _ in "kv")
        return lambda: qa.attention(q, k, v)
    if mode == "paged":
        pools = _pools(gen, 5, 1, 128, D, 4, 1)
        q = torch.randn((1, 256, D), generator=gen, device="cuda")
        pt = torch.tensor([4, 1, 2, 0], device="cuda", dtype=torch.int32)
        nt = torch.tensor([128, 128, 90, 128], device="cuda",
                          dtype=torch.int32)

        def call():
            out, lse = pa.paged_attention(q, pt, *pools, bits=4,
                                          page_tokens=nt, return_lse=True)
            return torch.cat((out, lse[..., None]), -1)
        return call
    B, H, P, n = 2, 1, 64, 3  # the batched kernels, bf16 and int8
    pools = _pools(gen, B * n, H, P, D, 4, 1)
    q = torch.randn((B, H, 200, D), generator=gen, device="cuda")
    pt = torch.arange(B * n, device="cuda", dtype=torch.int32).reshape(B, n)
    nt = torch.full((B, n), P, device="cuda", dtype=torch.int32)
    npg = torch.tensor([n, 2], device="cuda", dtype=torch.int32)
    act = 8 if mode == "batched_a8" else 16
    return lambda: pa.batched_paged_attention(q, pt, nt, npg, *pools, bits=4,
                                              act_bits=act)


@pytest.mark.parametrize("mode,D", [
    ("dense", 768), ("fused_qkv", 768), ("contig", 768), ("paged", 768),
    ("batched", 768), ("batched_a8", 768), ("dense", 2048),
    ("fused_qkv", 2056), ("paged", 2056), ("fused_qkv", 4104),
    ("paged", 4104), ("dense", 2056), ("batched_a8", 2056), ("dense", 4104),
    ("batched_a8", 4104), ("contig", 2056), ("batched", 2056),
    ("contig", 4104), ("batched", 4104)])
def test_cluster_modes_repeat_bit_for_bit(gen, mode, D):
    """Each mode of the cluster design, and fused-QKV attention's, run 20
    times on one input gives the same bits every time: P is formed only
    after the wait that retires the P.V reading the registers it lands in
    (PTX leaves a write before that wait undefined)."""
    call = _cluster_mode_call(gen, mode, D)
    first = call()
    for _ in range(19):
        assert torch.equal(call(), first)
    assert bool(torch.isfinite(first).all())


@pytest.mark.parametrize("P", PAGES)
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_paged_attention_kernel_masked_pages(gen, P, D):
    """Pages with no valid token (the first, and one in the middle), a
    partial page and slots in mixed order; and a chain whose every page is
    empty, where every key weighs exp(0) = 1 as in the plain version."""
    BH, Sq, bits = 3, 130, 4
    pools = _pools(gen, 6, BH, P, D, bits, 1)
    q = torch.randn((BH, Sq, D), generator=gen, device="cuda")
    pt = torch.tensor([5, 0, 3, 2, 4], device="cuda", dtype=torch.int32)
    for tokens in ([0, P, 0, max(1, P // 3), P], [0] * 5):
        nt = torch.tensor(tokens, device="cuda", dtype=torch.int32)
        _build.reset_launch_counts()
        out, lse = pa.paged_attention(q, pt, *pools, bits=bits, page_tokens=nt,
                                      return_lse=True)
        torch.cuda.synchronize()
        assert _build.launch_counts["paged_attention"] == 1
        ref, ref_lse = pa.paged_attention_plain(q, pt, *pools, bits=bits,
                                                page_tokens=nt, return_lse=True)
        _close(out, lse, ref, ref_lse)


def test_paged_kernels_refuse_what_they_do_not_take(gen):
    q = torch.randn((1, 2, 8, 64), device="cuda")
    pt = torch.zeros((1, 1), dtype=torch.int32, device="cuda")
    npg = torch.ones((1,), dtype=torch.int32, device="cuda")
    pools = _pools(gen, 2, 2, 136, 64, 4)      # pages of 136 tokens
    with pytest.raises(ValueError, match="page size"):
        pa.batched_paged_attention(q, pt, pt, npg, *pools, bits=4)
    with pytest.raises(ValueError, match="page size"):
        pa.batched_paged_attention(q, pt, pt, npg, *pools, bits=4, act_bits=8)
    pools = _pools(gen, 2, 2, 64, 64, 4)
    with pytest.raises(ValueError, match="act_bits"):
        pa.batched_paged_attention(q, pt, pt, npg, *pools, bits=4, act_bits=4)
    with pytest.raises(ValueError, match="head group"):
        pa.batched_paged_attention(q, pt, pt, npg, *pools, bits=4,
                                   head_group=3)
    with pytest.raises(ValueError, match="empty page table"):
        pa.paged_attention(q[0], pt[0, :0], *pools, bits=4)
    # heads of 48, refused here until the kernels took every multiple of 8,
    # and heads of 264, refused until the wide instance (ROADMAP C41), match
    # the twins, at act_bits 16 and 8
    q48 = torch.randn((1, 2, 8, 48), device="cuda")
    pools48 = _pools(gen, 2, 2, 64, 48, 4, 1)
    nt = torch.full((1, 1), 64, dtype=torch.int32, device="cuda")
    _build.reset_launch_counts()
    out, lse = pa.batched_paged_attention(q48, pt, nt, npg, *pools48, bits=4,
                                          return_lse=True)
    out1, lse1 = pa.paged_attention(q48[0], pt[0], *pools48, bits=4,
                                    return_lse=True)
    torch.cuda.synchronize()
    assert dict(_build.launch_counts) == {
        "batched_paged_attention": 1, "paged_unpack": 1, "paged_attention": 1}
    _close(out, lse, *pa.batched_paged_attention_plain(
        q48, pt, nt, npg, *pools48, bits=4, return_lse=True))
    _close(out1, lse1, *pa.paged_attention_plain(
        q48[0], pt[0], *pools48, bits=4, return_lse=True))
    q264 = torch.randn((1, 2, 8, 264), device="cuda")
    pools264 = _pools(gen, 2, 2, 64, 264, 4, 1)
    for act_bits, name, plain, tol in (
            (16, "batched_paged_attention", pa.batched_paged_attention_plain,
             1e-2),
            (8, "batched_paged_attention_a8",
             pa.batched_paged_attention_a8_plain, 5e-3)):
        _build.reset_launch_counts()
        out, lse = pa.batched_paged_attention(
            q264, pt, nt, npg, *pools264, bits=4, return_lse=True,
            act_bits=act_bits)
        torch.cuda.synchronize()
        assert dict(_build.launch_counts) == {name: 1, "paged_unpack": 1}
        ref, ref_lse = plain(q264, pt, nt, npg, *pools264, bits=4,
                             return_lse=True)
        assert float((out - ref).norm() / ref.norm()) <= tol
        torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-3)
    _build.reset_launch_counts()
    out1, lse1 = pa.paged_attention(q264[0], pt[0], *pools264, bits=4,
                                    return_lse=True)
    torch.cuda.synchronize()
    assert _build.launch_counts["paged_attention"] == 1
    _close(out1, lse1, *pa.paged_attention_plain(
        q264[0], pt[0], *pools264, bits=4, return_lse=True))
    q12 = torch.randn((1, 2, 8, 12), device="cuda")
    pools12 = _pools(gen, 2, 2, 64, 12, 4, 1)
    for act_bits in (16, 8):  # JAX's XLA path: no kernel serves the pools
        _build.reset_launch_counts()
        pa.batched_paged_attention(q12, pt, nt, npg, *pools12, bits=4,
                                   act_bits=act_bits)
        assert not _build.launch_counts


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("P", PAGES)
@pytest.mark.parametrize("D,G", DG)
def test_batched_paged_attention_a8_kernel_matches_twin(gen, bits, P, D, G):
    """The int8 path at the bf16 test's tables (scattered pages, a partial
    one, an empty slot, a ragged q tile). Both integer dots are exact, so
    the kernel differs from its twin only where expf's last bit moves an
    int8 level of the folded weights: 5e-3 relative, lse 1e-3; and it stays
    within the JAX package's a8-vs-bf16 bounds of the bf16 kernel."""
    B, H, Sq = 3, max(4, G), 100
    pools = _pools(gen, 7, H // G, P, G * D, bits, G)
    q = torch.randn((B, H, Sq, D), generator=gen, device="cuda")
    pt = torch.tensor([[5, 0, 3], [0, 0, 0], [6, 0, 0]], device="cuda",
                      dtype=torch.int32)
    nt = torch.tensor([[P, P, P // 2 + 3], [0, 0, 0], [P, 0, 0]],
                      device="cuda", dtype=torch.int32)
    npg = torch.tensor([3, 0, 1], device="cuda", dtype=torch.int32)
    _build.reset_launch_counts()
    out, lse = pa.batched_paged_attention(q, pt, nt, npg, *pools, bits=bits,
                                          return_lse=True, head_group=G,
                                          act_bits=8)
    torch.cuda.synchronize()
    assert _build.launch_counts["batched_paged_attention_a8"] == 1
    assert _build.launch_counts["batched_paged_attention"] == 0
    assert _build.launch_counts["paged_unpack"] == 1
    ref, ref_lse = pa.batched_paged_attention_a8_plain(
        q, pt, nt, npg, *pools, bits=bits, return_lse=True, head_group=G)
    assert torch.all(out[1] == 0) and torch.all(lse[1] == pa.NEG_INF)
    rel = float((out - ref).norm() / ref.norm())
    assert rel <= 5e-3, rel
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-3)
    o16, l16 = pa.batched_paged_attention(q, pt, nt, npg, *pools, bits=bits,
                                          return_lse=True, head_group=G)
    assert float((out - o16).norm() / o16.norm()) <= 3.5e-2
    torch.testing.assert_close(lse, l16, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("act_bits", [16, 8])
@pytest.mark.parametrize("bits", [8, 4, 2])
def test_batched_paged_attention_heads_of_16(gen, act_bits, bits):
    """The shapes of the serving example (`DiffusionConfig.tiny()`, 4 heads
    of 16, G = 1): 2 slots, S = 16, pages of 8, two pages a slot, the
    second slot's last page partial. Against the plain versions at the
    bounds of the other head widths; the int8 path also within the JAX
    package's a8-vs-bf16 bounds of the bf16 kernel."""
    B, H, Sq, D, P = 2, 4, 16, 16, 8
    pools = _pools(gen, 4, H, P, D, bits, 1)
    q = torch.randn((B, H, Sq, D), generator=gen, device="cuda")
    pt = torch.tensor([[2, 0], [1, 3]], device="cuda", dtype=torch.int32)
    nt = torch.tensor([[P, P], [P, 5]], device="cuda", dtype=torch.int32)
    npg = torch.tensor([2, 2], device="cuda", dtype=torch.int32)
    name = "batched_paged_attention" + ("_a8" if act_bits == 8 else "")
    _build.reset_launch_counts()
    out, lse = pa.batched_paged_attention(q, pt, nt, npg, *pools, bits=bits,
                                          return_lse=True, act_bits=act_bits)
    torch.cuda.synchronize()
    assert dict(_build.launch_counts) == {name: 1, "paged_unpack": 1}
    plain = (pa.batched_paged_attention_a8_plain if act_bits == 8
             else pa.batched_paged_attention_plain)
    ref, ref_lse = plain(q, pt, nt, npg, *pools, bits=bits, return_lse=True)
    print(f"heads of 16, {bits}-bit, act {act_bits}: max abs "
          f"{float((out - ref).abs().max()):.3g}")
    if act_bits == 16:
        _close(out, lse, ref, ref_lse)
        return
    assert float((out - ref).norm() / ref.norm()) <= 5e-3
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-3)
    o16, l16 = pa.batched_paged_attention(q, pt, nt, npg, *pools, bits=bits,
                                          return_lse=True)
    assert float((out - o16).norm() / o16.norm()) <= 3.5e-2
    torch.testing.assert_close(lse, l16, rtol=2e-2, atol=2e-2)


def test_batched_paged_attention_a8_one_bit_runs_the_bf16_kernel(gen):
    B, H, Sq, D, P, G = 1, 2, 16, 64, 64, 2
    pools = _pools(gen, 2, H // G, P, G * D, 1)
    q = torch.randn((B, H, Sq, D), generator=gen, device="cuda")
    pt = torch.tensor([[1, 0]], device="cuda", dtype=torch.int32)
    nt = torch.full((1, 2), P, device="cuda", dtype=torch.int32)
    npg = torch.tensor([2], device="cuda", dtype=torch.int32)
    _build.reset_launch_counts()
    out = pa.batched_paged_attention(q, pt, nt, npg, *pools, bits=1,
                                     head_group=G, act_bits=8)
    assert _build.launch_counts["batched_paged_attention"] == 1
    assert _build.launch_counts["batched_paged_attention_a8"] == 0
    assert _build.launch_counts["paged_unpack"] == 1
    assert torch.equal(out, pa.batched_paged_attention(
        q, pt, nt, npg, *pools, bits=1, head_group=G))


# the batched paged kernels' cluster instances (csrc/wide_cluster_flash.cuh
# modes kScratch16 and kScratch8, heads of 264 to 2048): a last block of 8
# and 16 columns (264, 272), clusters of 2, 3, 4 and 8 (384, 520 and 768,
# 1024, 2048); pages of 24, 56, 72 and 128 tokens run in tiles of 32, 64 and
# 128 (the int8 path's instances of 1, 2, 3 and 4 sub-tiles a page)
BATCHED_CLUSTER = [264, 272, 384, 520, 768, 1024, 2048]


def _batched_cluster_case(gen, D, P, bits, G, act_bits, H=2):
    """Three slots of a pool of eight: three scattered pages with a partial
    last one, no page, one page; 100 query rows (a ragged q tile). The
    kernel against its plain version at `_close`'s bounds (int8: rel
    Frobenius 5e-3, lse 1e-3), the empty slot 0 with an lse of -1e30."""
    B, Sq = 3, 100
    assert pa.batched_instance(D, act_bits == 8 and bits > 1) == "_cluster"
    pools = _pools(gen, 8, H // G, P, G * D, bits, G)
    q = torch.randn((B, H, Sq, D), generator=gen, device="cuda")
    pt = torch.tensor([[5, 0, 3], [0, 0, 0], [7, 0, 0]], device="cuda",
                      dtype=torch.int32)
    nt = torch.tensor([[P, P, P // 2 + 3], [0, 0, 0], [P, 0, 0]],
                      device="cuda", dtype=torch.int32)
    npg = torch.tensor([3, 0, 1], device="cuda", dtype=torch.int32)
    name = "batched_paged_attention" + (
        "_a8" if act_bits == 8 and bits > 1 else "")
    _build.reset_launch_counts()
    out, lse = pa.batched_paged_attention(q, pt, nt, npg, *pools, bits=bits,
                                          return_lse=True, head_group=G,
                                          act_bits=act_bits)
    torch.cuda.synchronize()
    assert dict(_build.launch_counts) == {name: 1, "paged_unpack": 1}
    assert torch.all(out[1] == 0) and torch.all(lse[1] == pa.NEG_INF)
    if name.endswith("_a8"):
        ref, ref_lse = pa.batched_paged_attention_a8_plain(
            q, pt, nt, npg, *pools, bits=bits, return_lse=True, head_group=G)
        rel = float((out - ref).norm() / ref.norm())
        assert rel <= 5e-3, rel
        torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-3)
    else:
        _close(out, lse, *pa.batched_paged_attention_plain(
            q, pt, nt, npg, *pools, bits=bits, return_lse=True,
            head_group=G))


@pytest.mark.parametrize("act_bits,bits", [(16, 1), (16, 2), (16, 4),
                                           (16, 8), (8, 2), (8, 4), (8, 8)])
@pytest.mark.parametrize("P", [24, 56, 72, 128])
@pytest.mark.parametrize("D", BATCHED_CLUSTER)
def test_batched_paged_attention_cluster_edges_match_twin(gen, act_bits, bits,
                                                          P, D):
    _batched_cluster_case(gen, D, P, bits, 1, act_bits)


@pytest.mark.parametrize("act_bits", [16, 8])
@pytest.mark.parametrize("P", [72, 128])
@pytest.mark.parametrize("D,G", [(264, 4), (384, 2), (520, 2)])
def test_batched_paged_attention_cluster_head_groups(gen, act_bits, P, D, G):
    """Heads in groups of G (pool rows of G * D lanes), four heads."""
    _batched_cluster_case(gen, D, P, 4, G, act_bits, H=4)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("P", [32, 64, 72, 128])
@pytest.mark.parametrize("D", PAST)
def test_batched_paged_attention_a8_past_2048_matches_twin(gen, bits, P, D):
    """The int8 path past 2048, in blocks of k slices (q's levels streamed
    from their scratch, the pages replayed slice by slice): pages in tiles
    of 32, 64 and 128 tokens (one or two sub-tiles; 72 leaves tokens past
    the page's data), `_batched_cluster_case`'s slots and bounds."""
    _batched_cluster_case(gen, D, P, bits, 1, 8)


@pytest.mark.parametrize("P", [72, 128])
@pytest.mark.parametrize("D,G", [(2056, 2), (2560, 4), (4104, 2)])
def test_batched_paged_attention_a8_past_2048_head_groups(gen, P, D, G):
    """The int8 path past 2048 with heads in groups of G, four heads."""
    _batched_cluster_case(gen, D, P, 4, G, 8, H=4)


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("P", [24, 32, 72, 128])
@pytest.mark.parametrize("D", PAST)
def test_batched_paged_attention_past_2048_matches_twin(gen, bits, P, D):
    """The bf16 path past 2048, in blocks of k slices (the tiles' bf16(p),
    alpha and csum kept in scratch, P.V replayed slice by slice): pages of
    24 (shorter than its tile of 32), 32, 72 (a last tile of 8 tokens) and
    128, `_batched_cluster_case`'s slots (an empty one) and bounds."""
    _batched_cluster_case(gen, D, P, bits, 1, 16)


@pytest.mark.parametrize("P", [72, 128])
@pytest.mark.parametrize("D,G", [(2056, 2), (2560, 4), (4104, 2)])
def test_batched_paged_attention_past_2048_head_groups(gen, P, D, G):
    """The bf16 path past 2048 with heads in groups of G, four heads."""
    _batched_cluster_case(gen, D, P, 4, G, 16, H=4)


def test_batched_paged_attention_past_the_clusters_runs_slices(gen):
    """Heads of 2056 run the cluster kernels in blocks of 2 slices with
    bf16 and with int8 activations, each replayed from a CUDA graph bit for
    bit (its pass-2 scratch lives in the graph's pool); the cluster entry
    points refuse 256, and 2056 without their scratch, rather than serve
    them; the card places both paths' clusters past 2048."""
    assert pa.batched_instance(2056, a8=False) == "_cluster"
    assert pa.batched_instance(2056, a8=True) == "_cluster"
    for act_bits in (16, 8):
        B, H, Sq, D, P = 2, 1, 40, 2056, 64
        pools = _pools(gen, 3, H, P, D, 4, 1)
        q = torch.randn((B, H, Sq, D), generator=gen, device="cuda")
        pt = torch.tensor([[2, 0], [1, 0]], device="cuda", dtype=torch.int32)
        nt = torch.tensor([[P, 9], [P, 0]], device="cuda", dtype=torch.int32)
        npg = torch.tensor([2, 1], device="cuda", dtype=torch.int32)
        out, lse = pa.batched_paged_attention(
            q, pt, nt, npg, *pools, bits=4, return_lse=True,
            act_bits=act_bits)
        plain = (pa.batched_paged_attention_a8_plain if act_bits == 8
                 else pa.batched_paged_attention_plain)
        ref, ref_lse = plain(q, pt, nt, npg, *pools, bits=4, return_lse=True)
        assert float((out - ref).norm() / ref.norm()) <= (
            5e-3 if act_bits == 8 else 1e-2)
        torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-3)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            g_out, g_lse = pa.batched_paged_attention(
                q, pt, nt, npg, *pools, bits=4, return_lse=True,
                act_bits=act_bits)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(g_out, out) and torch.equal(g_lse, lse)
    q = torch.zeros((1, 1, 8, 2056), device="cuda").bfloat16()
    buf = torch.zeros((1 << 16,), device="cuda")
    one = torch.ones((1,), dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for name, D, scratch in (("_cluster", 256, (buf.data_ptr(),)),
                             ("_cluster", 2056, (0,)),
                             ("_a8_cluster", 256, (0, 0)),
                             ("_a8_cluster", 2056, (0, 0))):
        assert _build.function(f"dlm_batched_paged_attention{name}")(
            q.data_ptr(), one.data_ptr(), one.data_ptr(), buf.data_ptr(),
            buf.data_ptr(), buf.data_ptr(), buf.data_ptr(), buf.data_ptr(),
            1, 1, 8, D, 1, 64, 2112, 64, stream, *scratch) != 0, (name, D)
    active = _build.function("dlm_batched_paged_attention_cluster_active")
    for D in (264, 520, 776, 1032, 1288, 1544, 1800, 2048, 2056, 2824, 3592,
              4104, 10240):
        for P in (24, 56, 72, 128):
            for a8 in (0, 1):
                assert active(D, P, a8) > 0, (D, P, a8)


# ------------------------------------------------ quantized-KV attention ---

def _quant_plain(q, k, v):
    """`attention_plain` at the KV tile of the kernel that serves these
    heads (64 tokens; the cluster instance's 32 past 256) and the cluster
    instance's split of the chain over clusters."""
    BH, Sq, D = q.shape
    if qa.instance(D) != "_cluster":
        return qa.attention_plain(q, k, v, tile=qa.KERNEL_KV_TILE)
    n = qa.quant_cluster_splits(BH, Sq, k.shape[1], D, k.bits)
    return qa.attention_plain(q, k, v, tile=qa.CLUSTER_KV_TILE, splits=n)


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("Sq,Skv", [(64, 64), (256, 256), (100, 100), (10, 10),
                                    (1, 1), (70, 1000)])
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_quant_attention_kernel_matches_plain(gen, bits, Sq, Skv, D):
    """Every Sq and Skv runs the kernel (ragged q and KV tiles masked).
    Against the plain version at the kernel's KV tile: sums in another order
    and CUDA's expf, which can move a bf16 rounding of p * vs: 2e-3
    relative."""
    BH = 6
    q = torch.randn((BH, Sq, D), generator=gen, device="cuda")
    k = qa.quantize_kv(torch.randn((BH, Skv, D), generator=gen, device="cuda"),
                       bits)
    v = qa.quantize_kv(torch.randn((BH, Skv, D), generator=gen, device="cuda")
                       * 3 + 1, bits)
    _build.reset_launch_counts()
    out = qa.attention(q, k, v)
    torch.cuda.synchronize()
    assert _build.launch_counts["quant_attention"] == 1
    assert out.dtype == torch.float32 and out.shape == (BH, Sq, D)
    ref = _quant_plain(q, k, v)
    rel = float((out - ref).norm() / ref.norm())
    assert rel <= 2e-3 and bool(torch.isfinite(out).all()), rel


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("BH,S", [(96, 256), (24, 1024)])
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_quant_attention_kernel_at_sampler_shapes(gen, bits, BH, S, D):
    """The scan sampler's shapes (B=8 x 12 heads at S=256, B=2 x 12 at
    S=1024) at every head width and bit width, against the plain version at
    the kernel's KV tile: 2e-3 relative, as above."""
    q = torch.randn((BH, S, D), generator=gen, device="cuda").to(torch.bfloat16)
    k, v = (qa.quantize_kv(torch.randn((BH, S, D), generator=gen,
                                       device="cuda"), bits) for _ in range(2))
    _build.reset_launch_counts()
    out = qa.attention(q, k, v)
    torch.cuda.synchronize()
    assert _build.launch_counts["quant_attention"] == 1
    ref = _quant_plain(q, k, v)
    rel = float((out - ref).norm() / ref.norm())
    assert rel <= 2e-3 and bool(torch.isfinite(out).all()), rel


# quantized-KV attention's cluster instance (csrc/wide_cluster_flash.cuh mode
# kContig): a last block of 8 and of 16 columns (264, 272; packed rows of 33
# bytes at D = 264 and 1 bit), clusters of 3, 4 and 8, and past 2048 (`PAST`)
# blocks of k slices
QUANT_CLUSTER = [264, 272, 520, 1024, 2048]


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("Sq", [1, 100, 256])
@pytest.mark.parametrize("Skv", [1, 33, 999])
@pytest.mark.parametrize("D", QUANT_CLUSTER)
def test_quant_attention_cluster_matches_plain(gen, bits, Sq, Skv, D):
    """One launch of the cluster entry point, within 2e-3 relative of the
    plain version at the kernel's tile of 32 tokens, with the chain in one
    run and split over clusters as the kernel splits it where the card has
    room (`quant_cluster_splits`). V is N(1, 3), where splitting the chain
    moves the output little; at N(0, 1) values it moves it by up to about
    4e-3 from the chain in one run, which
    `test_quant_attention_cluster_split_at_unit_values` bounds."""
    BH = 3
    assert qa.instance(D) == "_cluster"
    q = torch.randn((BH, Sq, D), generator=gen, device="cuda")
    k = qa.quantize_kv(torch.randn((BH, Skv, D), generator=gen, device="cuda"),
                       bits)
    v = qa.quantize_kv(torch.randn((BH, Skv, D), generator=gen, device="cuda")
                       * 3 + 1, bits)
    _build.reset_launch_counts()
    out = qa.attention(q, k, v)
    torch.cuda.synchronize()
    assert _build.launch_counts["quant_attention"] == 1
    assert out.dtype == torch.float32 and out.shape == (BH, Sq, D)
    n = qa.quant_cluster_splits(BH, Sq, Skv, D, bits)
    for splits in {1, n}:
        ref = qa.attention_plain(q, k, v, tile=qa.CLUSTER_KV_TILE,
                                 splits=splits)
        rel = float((out - ref).norm() / ref.norm())
        assert rel <= 2e-3 and bool(torch.isfinite(out).all()), (splits, rel)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("BH,D", [(16, 384), (8, 768)])
def test_quant_attention_cluster_split_at_unit_values(gen, bits, BH, D):
    """The scan sampler's wide shapes (Sq = Skv = 256) with N(0, 1) q, K and
    V, where the chain splits: within 2e-3 relative of the plain version
    split as the kernel splits it, and within 5e-3 of the chain in one run
    (a split rounds bf16(p * vs) against its own running max: 3.5e-3 to
    3.9e-3 between the two plain schedules here, ROADMAP C44;
    `chip_smoke.py` holds the timed rows to the same bounds)."""
    S = 256
    n = qa.quant_cluster_splits(BH, S, S, D, bits)
    assert n > 1, n
    q = torch.randn((BH, S, D), generator=gen, device="cuda")
    k, v = (qa.quantize_kv(torch.randn((BH, S, D), generator=gen,
                                       device="cuda"), bits)
            for _ in range(2))
    out = qa.attention(q, k, v)
    for splits, bound in ((n, 2e-3), (1, 5e-3)):
        ref = qa.attention_plain(q, k, v, tile=qa.CLUSTER_KV_TILE,
                                 splits=splits)
        rel = float((out - ref).norm() / ref.norm())
        print(f"D={D} {bits}-bit, {n} splits, against {splits}: rel {rel:.3g}")
        assert rel <= bound and bool(torch.isfinite(out).all()), (splits, rel)


def test_quant_attention_cluster_splits_merge_in_launch(gen):
    """At few query tiles the chain splits over clusters
    (`quant_cluster_splits`) and merges in the same launch: a graph replay
    equal to the eager call bit for bit, the merge counters left at zero,
    and packed rows of 33 bytes whose pointer is off by one row (a view one
    token into the data, contiguous at BH = 1, so byte loads run)."""
    BH, Sq, Skv, D, bits = 1, 256, 999, 264, 1
    n = qa.quant_cluster_splits(BH, Sq, Skv, D, bits)
    assert n > 1, n
    q = torch.randn((BH, Sq, D), generator=gen, device="cuda")
    k, v = (qa.quantize_kv(torch.randn((BH, Skv + 1, D), generator=gen,
                                       device="cuda"), bits)
            for _ in range(2))
    k, v = (qa.QuantKV(t.data[:, 1:], t.scale[:, 1:], t.zero_point[:, 1:],
                       bits, D) for t in (k, v))
    assert k.data.is_contiguous() and k.data.data_ptr() % 2 == 1
    out = qa.attention(q, k, v)
    ref = qa.attention_plain(q, k, v, tile=qa.CLUSTER_KV_TILE, splits=n)
    assert float((out - ref).norm() / ref.norm()) <= 2e-3
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        g_out = qa.attention(q, k, v)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(g_out, out)
    assert not any(bool(t.any()) for t in qa._split_counters[q.device])


def _offset_kv(t, offset):
    """`t` with its packed bytes moved `offset` bytes past an aligned
    address, still contiguous (so the wrapper launches on that pointer)."""
    buf = torch.empty(t.data.numel() + 16, dtype=torch.uint8,
                      device=t.data.device)
    data = buf[offset:offset + t.data.numel()].view(t.data.shape)
    data.copy_(t.data)
    assert data.is_contiguous() and data.data_ptr() % 16 == offset % 16
    return qa.QuantKV(data, t.scale, t.zero_point, t.bits, t.D)


@pytest.mark.parametrize("offset", [1, 2, 4, 8, 16])
def test_quant_attention_cluster_loads_at_every_alignment(gen, offset):
    """Packed rows of 256 bytes (D = 512, 4 bits) whose pointers are `offset`
    bytes past a 16-byte boundary: the loader copies 16, 8 or 4 bytes by
    cp.async, or 2 or 1 by plain loads, as the pointers allow. One launch,
    the plain version's tolerance, the chain split."""
    BH, Sq, Skv, D, bits = 1, 200, 700, 512, 4
    n = qa.quant_cluster_splits(BH, Sq, Skv, D, bits)
    q = torch.randn((BH, Sq, D), generator=gen, device="cuda")
    k, v = (_offset_kv(qa.quantize_kv(torch.randn(
        (BH, Skv, D), generator=gen, device="cuda"), bits), offset)
        for _ in range(2))
    _build.reset_launch_counts()
    out = qa.attention(q, k, v)
    torch.cuda.synchronize()
    assert _build.launch_counts["quant_attention"] == 1
    ref = qa.attention_plain(q, k, v, tile=qa.CLUSTER_KV_TILE, splits=n)
    rel = float((out - ref).norm() / ref.norm())
    assert rel <= 2e-3 and bool(torch.isfinite(out).all()), (n, rel)


def test_split_counters_outlive_the_graphs_that_use_them(gen, monkeypatch):
    """A graph captured at a shape whose chain splits replays right after a
    larger call that splits has needed more merge counters: the counters the
    graph was captured with are kept beside the larger ones, so the replay
    equals the eager call bit for bit and every counter is left at zero
    (were they freed, memory taken since would hold the graph's counts)."""
    D, bits, Skv = 512, 4, 1024
    dev = torch.device("cuda", torch.cuda.current_device())
    monkeypatch.setitem(qa._split_counters, dev, [])

    def inputs(BH, Sq):
        q = torch.randn((BH, Sq, D), generator=gen, device=dev)
        kv = [qa.quantize_kv(torch.randn((BH, Skv, D), generator=gen,
                                         device=dev), bits) for _ in range(2)]
        assert qa.quant_cluster_splits(BH, Sq, Skv, D, bits) > 1
        return (q, *kv)

    small, large = inputs(1, 128), inputs(4, 256)
    out = qa.attention(*small)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        g_out = qa.attention(*small)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(g_out, out)
    big = qa.attention(*large)  # 16 counters where the graph's hold 2
    junk = [torch.full((2,), 7, dtype=torch.int32, device=dev)
            for _ in range(64)]  # small blocks, as the first counters were
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(g_out, out)
    assert all(bool((t == 7).all()) for t in junk)
    assert not any(bool(t.any()) for t in qa._split_counters[dev])
    ref = qa.attention_plain(*large, tile=qa.CLUSTER_KV_TILE,
                             splits=qa.quant_cluster_splits(4, 256, Skv, D,
                                                            bits))
    assert float((big - ref).norm() / ref.norm()) <= 2e-3


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("Sq,Skv", [(1, 33), (100, 130), (256, 999)])
@pytest.mark.parametrize("D", PAST)
def test_quant_attention_past_2048_matches_plain(gen, bits, Sq, Skv, D):
    """Past 2048, blocks of k slices (the tiles' bf16(p * vs), alpha and
    csum kept in scratch, P.V replayed slice by slice): one launch, within
    2e-3 relative of the plain version at the kernel's tile of 32 tokens,
    in one run and split as the kernel splits it (the chain of 2 tiles in
    one piece, of 32 split where the card has room); packed rows of 257
    bytes at D = 2056 and 1 bit. V is N(1, 3), as in
    `test_quant_attention_cluster_matches_plain`."""
    BH = 3
    assert qa.instance(D) == "_cluster" and qa.cluster_plan(D)[1] > 1
    q = torch.randn((BH, Sq, D), generator=gen, device="cuda")
    k = qa.quantize_kv(torch.randn((BH, Skv, D), generator=gen, device="cuda"),
                       bits)
    v = qa.quantize_kv(torch.randn((BH, Skv, D), generator=gen, device="cuda")
                       * 3 + 1, bits)
    _build.reset_launch_counts()
    out = qa.attention(q, k, v)
    torch.cuda.synchronize()
    assert _build.launch_counts["quant_attention"] == 1
    assert out.dtype == torch.float32 and out.shape == (BH, Sq, D)
    n = qa.quant_cluster_splits(BH, Sq, Skv, D, bits)
    if Skv == 33:
        assert n == 1
    for splits in {1, n}:
        ref = qa.attention_plain(q, k, v, tile=qa.CLUSTER_KV_TILE,
                                 splits=splits)
        rel = float((out - ref).norm() / ref.norm())
        assert rel <= 2e-3 and bool(torch.isfinite(out).all()), (splits, rel)


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_quant_attention_past_2048_split_at_unit_values(gen, bits):
    """The scan sampler's shape on `heads_wide`'s model of one head of 2560
    (B = 8, Sq = Skv = 256), N(0, 1) q, K and V, the chain split: the
    bounds of `test_quant_attention_cluster_split_at_unit_values` (2e-3 of
    the split plain version, 5e-3 of the chain in one run, C44)."""
    BH, S, D = 8, 256, 2560
    n = qa.quant_cluster_splits(BH, S, S, D, bits)
    q = torch.randn((BH, S, D), generator=gen, device="cuda")
    k, v = (qa.quantize_kv(torch.randn((BH, S, D), generator=gen,
                                       device="cuda"), bits)
            for _ in range(2))
    out = qa.attention(q, k, v)
    for splits, bound in ((n, 2e-3), (1, 5e-3)):
        ref = qa.attention_plain(q, k, v, tile=qa.CLUSTER_KV_TILE,
                                 splits=splits)
        rel = float((out - ref).norm() / ref.norm())
        print(f"D={D} {bits}-bit, {n} splits, against {splits}: rel {rel:.3g}")
        assert rel <= bound and bool(torch.isfinite(out).all()), (splits, rel)


def test_quant_attention_past_the_clusters_runs_slices(gen):
    """Heads of 2056 launch the cluster instance in blocks of 2 slices, its
    chain split over clusters and merged in the launch: a graph replay
    equal to the eager call bit for bit (its pass-2 scratch lives in the
    graph's pool), the counters left at zero; the entry point refuses 256,
    and 2056 without that scratch, and the card places its clusters."""
    D, BH, Sq, Skv = 2056, 1, 128, 999
    assert qa.instance(D) == "_cluster"
    assert qa.quant_cluster_splits(BH, Sq, Skv, D, 4) > 1
    q = torch.randn((BH, Sq, D), generator=gen, device="cuda")
    k, v = (qa.quantize_kv(torch.randn((BH, Skv, D), generator=gen,
                                       device="cuda"), 4) for _ in range(2))
    _build.reset_launch_counts()
    out = qa.attention(q, k, v)
    torch.cuda.synchronize()
    assert _build.launch_counts["quant_attention"] == 1
    assert float((out - _quant_plain(q, k, v)).norm()
                 / _quant_plain(q, k, v).norm()) <= 2e-3
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        g_out = qa.attention(q, k, v)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(g_out, out)
    assert not any(bool(t.any()) for t in qa._split_counters[q.device])
    p = (q.data_ptr(), k.data.data_ptr(), k.scale.data_ptr(),
         k.zero_point.data_ptr(), v.data.data_ptr(), v.scale.data_ptr(),
         v.zero_point.data_ptr(), out.data_ptr())
    stream = torch.cuda.current_stream().cuda_stream
    fn = _build.function("dlm_quant_attention_cluster")
    assert fn(*p, BH, Sq, Skv, 256, 4, 1.0, stream, 1, None, None, None,
              out.data_ptr()) != 0
    assert fn(*p, BH, Sq, Skv, D, 4, 1.0, stream, 1, None, None, None,
              None) != 0
    for bits in (1, 2, 4, 8):
        for width in (2056, 2560, 4104, 10240):
            assert _build.function("dlm_quant_attention_cluster_active")(
                width, bits) > 0, (width, bits)


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_quantize_kv_card_equals_cpu(gen, bits):
    x = torch.randn((24, 100, 64), generator=gen, device="cuda") * \
        torch.rand((24, 100, 1), generator=gen, device="cuda") * 10
    for reciprocal in (False, True):
        dev = qa.quantize_kv(x, bits, reciprocal)
        cpu = qa.quantize_kv(x.cpu(), bits, reciprocal)
        assert torch.equal(dev.data.cpu(), cpu.data)
        assert torch.equal(dev.scale.cpu(), cpu.scale)
        assert torch.equal(dev.zero_point.cpu(), cpu.zero_point)


def test_quant_attention_refuses_what_the_kernel_does_not_take(gen):
    """Heads of 48, refused here until the kernel took every multiple of 8,
    and heads of 264, refused until the wide instance (ROADMAP C41), match
    the plain version at every bit width; inputs on different devices are
    refused."""
    q = torch.randn((2, 8, 48), generator=gen, device="cuda")
    k = qa.quantize_kv(torch.randn((2, 16, 48), generator=gen, device="cuda"), 4)
    _build.reset_launch_counts()
    out = qa.attention(q, k, k)
    torch.cuda.synchronize()
    assert _build.launch_counts["quant_attention"] == 1
    ref = _quant_plain(q, k, k)
    assert float((out - ref).norm() / ref.norm()) <= 2e-3
    q = torch.randn((2, 8, 264), generator=gen, device="cuda")
    for bits in (1, 2, 4, 8):
        k = qa.quantize_kv(torch.randn((2, 16, 264), generator=gen,
                                       device="cuda"), bits)
        _build.reset_launch_counts()
        out = qa.attention(q, k, k)
        torch.cuda.synchronize()
        assert _build.launch_counts["quant_attention"] == 1
        ref = _quant_plain(q, k, k)
        assert float((out - ref).norm() / ref.norm()) <= 2e-3
    q = torch.randn((2, 8, 64), generator=gen, device="cuda")
    k = qa.quantize_kv(torch.randn((2, 16, 64), generator=gen, device="cuda"), 4)
    with pytest.raises(ValueError, match="different devices"):
        qa.attention(q, qa.QuantKV(k.data.cpu(), k.scale.cpu(),
                                   k.zero_point.cpu(), 4, 64), k)


# ------------------------------------------------ packed-weight matmul ---

def _packed_weight(K, N, bits, gran, act_bits, gen, group=128):
    from diffusion_llm_rs_tpu_torch.ops import packed_matmul as pm
    from diffusion_llm_rs_tpu_torch.quant.core import quantize
    w = torch.randn((K, N), generator=gen, device="cuda") * 0.02
    if gran == "group":
        qt = quantize(w, bits, symmetric=True, granularity="group",
                      group_size=group, axis=0)
    elif gran == "channel":
        qt = quantize(w, bits, granularity="channel", axis=1)
    else:
        qt = quantize(w, bits, granularity="tensor")
    return pm.prepare(qt, act_bits=act_bits)


PACKED_SHAPES = [
    # (M, K, N, bits, granularity, group, bias, gelu)
    (2048, 768, 2304, 4, "group", 128, False, False),
    (2048, 768, 768, 4, "group", 128, False, False),
    (2048, 768, 3072, 4, "group", 128, True, True),
    (2048, 3072, 768, 4, "group", 128, True, False),
    (8, 768, 3072, 4, "group", 128, True, True),
    (256, 768, 2304, 4, "group", 128, False, False),
    (5, 768, 768, 4, "group", 128, True, False),
    (130, 768, 768, 1, "group", 128, True, False),
    (130, 768, 768, 2, "group", 128, False, True),
    (130, 768, 768, 8, "group", 128, True, False),
    (130, 768, 2304, 4, "channel", 0, True, False),
    (37, 256, 1024, 4, "tensor", 0, False, False),
    (37, 512, 132, 2, "group", 32, True, False),   # ragged N, groups inside a step
    (1, 128, 4, 4, "group", 64, False, False),
    (9, 192, 8, 2, "group", 6, True, False),    # groups end inside a B-tile word
    (9, 96, 8, 4, "group", 6, False, True),
]


@pytest.mark.parametrize("M,K,N,bits,gran,group,bias,gelu", PACKED_SHAPES)
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_packed_matmul_kernel_matches_plain(gen, M, K, N, bits, gran, group,
                                            bias, gelu, out_dtype):
    """act_bits=16: the same bf16 operands on both sides, products summed in
    f32 in another order (K <= 3072 terms): |d| <= 2e-5 + 2e-5 |ref| in f32,
    one bf16 ulp more in bf16."""
    from diffusion_llm_rs_tpu_torch.ops import packed_matmul as pm
    w = _packed_weight(K, N, bits, gran, 16, gen, group)
    x = torch.randn((M, K), generator=gen, device="cuda")
    b = torch.randn((N,), generator=gen, device="cuda") * 0.02 if bias else None
    act = "gelu" if gelu else None
    _build.reset_launch_counts()
    out = pm.matmul(x, w, out_dtype, b, act)
    torch.cuda.synchronize()
    assert _build.launch_counts["matmul"] == 1
    ref = pm.matmul_plain(x, w, b, act, out_dtype)
    rtol = 2e-5 if out_dtype == torch.float32 else 2.0 ** -7
    assert out.dtype == out_dtype and out.shape == (M, N)
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol, atol=2e-5)


# the engine's linears at 12 layers and width 768 (qkv, wo and the head, mlp
# w1 with gelu, mlp w2), at the token counts the act_bits=16 kernel treats
# apart: one tile of 8 (M = 1, 5), 32 (17), 128 with and without split K
# (2048, 8192)
ENGINE_NK = [(2304, 768, False), (768, 768, False), (3072, 768, True),
             (768, 3072, False)]


@pytest.mark.parametrize("M", [1, 5, 17, 2048, 8192])
@pytest.mark.parametrize("N,K,mlp", ENGINE_NK)
@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_packed_matmul_kernel_at_engine_shapes(gen, M, N, K, mlp, bits):
    """The tolerance of `test_packed_matmul_kernel_matches_plain` with bf16
    out: one bf16 ulp (the f32 sums run in another order, split-K
    partials included)."""
    from diffusion_llm_rs_tpu_torch.ops import packed_matmul as pm
    w = _packed_weight(K, N, bits, "group", 16, gen)
    x = torch.randn((M, K), generator=gen, device="cuda")
    b = torch.randn((N,), generator=gen, device="cuda") * 0.02 if mlp else None
    act = "gelu" if mlp else None
    _build.reset_launch_counts()
    out = pm.matmul(x, w, torch.bfloat16, b, act)
    torch.cuda.synchronize()
    assert _build.launch_counts["matmul"] == 1
    ref = pm.matmul_plain(x, w, b, act, torch.bfloat16)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2.0 ** -7,
                               atol=2e-5)
    again = pm.matmul(x, w, torch.bfloat16, b, act)
    assert torch.equal(out, again)  # no atomics: the same bits every call


@pytest.mark.parametrize("D", [16, 32, 64] + [
    pytest.param(d, id=f"D{d}") for d in (48, 96, 256)])
def test_flash_fold_gradient_matches_the_einsum_path(gen, D):
    """`flash_fold` (the kernel forward, JAX's f32 VJP) against autograd
    through the einsum path at S = 1024, both in f32: the forward differs by
    the kernel's bf16 operands (relative 1e-2); the backward recomputes the
    softmax from the f32 inputs, so the gradients differ only in the order
    of f32 sums (relative 1e-4); every input gets one."""
    from diffusion_llm_rs_tpu_torch.models import denoiser as dn
    B, S, H = 1, 1024, 4
    q, k, v = (torch.randn((B, S, H, D), generator=gen, device="cuda",
                           requires_grad=True) for _ in range(3))
    w = torch.randn((B, S, H, D), generator=gen, device="cuda")
    _build.reset_launch_counts()
    flash = dn.attention(q, k, v)
    assert _build.launch_counts["dense_attention"] == 1
    gf = torch.autograd.grad((flash * w).sum(), (q, k, v))
    ref = dn.attention(q, k, v, flash=False)
    ge = torch.autograd.grad((ref * w).sum(), (q, k, v))
    assert float((flash - ref).norm() / ref.norm()) <= 1e-2
    for a, b in zip(gf, ge):
        assert float(a.norm()) > 0
        assert float((a - b).norm() / b.norm()) <= 1e-4


@pytest.mark.parametrize("M,K,N,bits,gran,group,bias,gelu", PACKED_SHAPES)
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_packed_matmul_a8_kernel_matches_plain(gen, M, K, N, bits, gran,
                                               group, bias, gelu, x_dtype):
    """act_bits=8: integer products are exact and the epilogue runs the same
    f32 operations: bit for bit without gelu, one bf16 ulp with it. Without
    gelu and bias the kernel also equals `int8w_matmul` on the decoded
    weight, from bf16 activations."""
    from diffusion_llm_rs_tpu_torch.ops import packed_matmul as pm
    from diffusion_llm_rs_tpu_torch.ops.matmul import decode_to_int8
    if (K * bits // 8) % 16:
        pytest.skip("act_bits=8 takes K * bits / 8 in multiples of 16")
    w = _packed_weight(K, N, bits, gran, 8, gen, group)
    x = torch.randn((M, K), generator=gen, device="cuda").to(x_dtype)
    b = torch.randn((N,), generator=gen, device="cuda") * 0.02 if bias else None
    act = "gelu" if gelu else None
    _build.reset_launch_counts()
    out = pm.matmul(x, w, torch.bfloat16, b, act)
    torch.cuda.synchronize()
    assert _build.launch_counts["matmul_a8"] == 1
    ref = pm.a8_matmul_reference(x, w, b, act, torch.bfloat16)
    if gelu:
        torch.testing.assert_close(out.float(), ref.float(), rtol=2.0 ** -7,
                                   atol=1e-6)
        return
    assert torch.equal(out, ref)
    if x_dtype == torch.bfloat16:
        d = decode_to_int8(w)
        assert torch.equal(pm.regrid_int8(w), d.data)
        assert torch.equal(out, im.int8w_matmul(x, d.data, d.col_scale, b,
                                                None, None, torch.bfloat16))


@pytest.mark.parametrize("M", EDGE_M)
@pytest.mark.parametrize("N", EDGE_N)
@pytest.mark.parametrize("K", [768, 3072])
@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("gran", ["group", "channel"])
def test_matmul_a8_edges_match_plain(gen, M, N, K, bits, gran):
    """matmul_a8 under every plan the core takes at the edges of
    `test_int8w_matmul_edges_match_twin`, per-column and grouped scales,
    bias with grouped scales, gelu at 2 and 8 bits: bit for bit without
    gelu, one bf16 ulp with it."""
    from diffusion_llm_rs_tpu_torch.ops import packed_matmul as pm
    w = _packed_weight(K, N, bits, gran, 8, gen)
    x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
    b = (torch.randn((N,), generator=gen, device="cuda") * 0.02
         if gran == "group" else None)
    act = "gelu" if bits in (2, 8) else None
    _build.reset_launch_counts()
    out = pm.matmul(x, w, torch.bfloat16, b, act)
    torch.cuda.synchronize()
    assert _build.launch_counts["matmul_a8"] == 1
    ref = pm.a8_matmul_reference(x, w, b, act, torch.bfloat16)
    if act:
        torch.testing.assert_close(out.float(), ref.float(), rtol=2.0 ** -7,
                                   atol=1e-6)
    else:
        assert torch.equal(out, ref)


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("gran,group", [("group", 128), ("group", 32),
                                        ("group", 6), ("channel", 0),
                                        ("tensor", 0)])
@pytest.mark.parametrize("K,N", [(768, 2304), (3072, 768), (384, 132)])
def test_unpack_i8_kernel_equals_plain(gen, bits, gran, group, K, N):
    """The act_bits=8 unpack on the card against its plain version on the
    CPU: the int8 [N, K] grid bit for bit."""
    from diffusion_llm_rs_tpu_torch.ops import packed_matmul as pm
    w = _packed_weight(K, N, bits, gran, 8, gen, group)
    wt = pm.unpack_i8(w)
    torch.cuda.synchronize()
    assert wt.shape == (N, K) and wt.dtype == torch.int8
    assert torch.equal(wt.cpu(), pm.unpack_i8(w.to("cpu")))


def test_packed_matmul_refuses_what_the_kernel_does_not_take(gen):
    """A packed row of 12 bytes (K = 24 at 4 bits), refused until the
    wrapper padded the weight (ROADMAP C43), matches the plain version at
    its tolerance; a contraction mismatch is refused."""
    from diffusion_llm_rs_tpu_torch.ops import packed_matmul as pm
    w = _packed_weight(24, 8, 4, "tensor", 16, gen)   # Kp = 12
    x = torch.randn((2, 24), generator=gen, device="cuda")
    _build.reset_launch_counts()
    out = pm.matmul(x, w)
    torch.cuda.synchronize()
    assert _build.launch_counts["matmul"] == 1
    torch.testing.assert_close(out, pm.matmul_plain(x, w), rtol=2e-5,
                               atol=2e-5)
    w = _packed_weight(128, 8, 4, "tensor", 16, gen)
    with pytest.raises(ValueError, match="contraction mismatch"):
        pm.matmul(torch.zeros((2, 64), device="cuda"), w)


@pytest.mark.parametrize("K,N,bits,gran,group", [
    (24, 8, 4, "tensor", 0), (24, 6, 4, "group", 8), (40, 10, 2, "group", 8),
    (24, 8, 1, "channel", 0), (200, 30, 8, "group", 40),
    (768, 2302, 4, "group", 128), (96, 8, 2, "group", 6)])
@pytest.mark.parametrize("act_bits", [16, 8])
@pytest.mark.parametrize("M", [3, 130])
def test_packed_matmul_off_alignment_matches_plain(gen, K, N, bits, gran,
                                                   group, act_bits, M):
    """Packed rows off 8 bytes (16 at act_bits 8) and N off 4 (ROADMAP C43):
    the weight is padded once (zero levels, and new groups of scale 1 where
    K's groups need one), x's K per call; with bias and gelu. act_bits 16
    within the tolerance of `test_packed_matmul_kernel_matches_plain` (bf16
    out: one bf16 ulp); act_bits 8 bit for bit (one bf16 ulp with gelu)."""
    from diffusion_llm_rs_tpu_torch.ops import packed_matmul as pm
    w = _packed_weight(K, N, bits, gran, act_bits, gen, group or 128)
    x = torch.randn((M, K), generator=gen, device="cuda")
    b = torch.randn((N,), generator=gen, device="cuda") * 0.02
    name = "matmul_a8" if act_bits == 8 else "matmul"
    for act in (None, "gelu"):
        _build.reset_launch_counts()
        out = pm.matmul(x, w, torch.bfloat16, b, act)
        torch.cuda.synchronize()
        assert _build.launch_counts[name] == 1
        assert out.shape == (M, N) and out.dtype == torch.bfloat16
        if act_bits == 8:
            ref = pm.a8_matmul_reference(x, w, b, act, torch.bfloat16)
            if act is None:
                assert torch.equal(out, ref)
                continue
        else:
            ref = pm.matmul_plain(x, w, b, act, torch.bfloat16)
        torch.testing.assert_close(out.float(), ref.float(), rtol=2.0 ** -7,
                                   atol=2e-5)


def test_quantize_fp8_card_equals_cpu(gen):
    from diffusion_llm_rs_tpu_torch.quant.core import quantize_fp8
    x = torch.randn((300, 257), generator=gen, device="cuda") * 3
    a, b = quantize_fp8(x), quantize_fp8(x.cpu())
    assert torch.equal(a.data.view(torch.uint8).cpu(), b.data.view(torch.uint8))
    assert torch.equal(a.scale.cpu(), b.scale)


def test_int8_weights_are_held_once_and_forward_is_unchanged(gen):
    """ROADMAP C32: a card `Int8Weight` holds its one copy K-major, so
    after a W4A8 forward `_k_major` returns storage the weight owns and the
    copy cache holds none of the model's weights; the forward is bit for bit
    the one over [K, N] weights read through cached K-major copies (the
    layout before the weights were held K-major)."""
    import dataclasses

    from diffusion_llm_rs_tpu_torch.config import DiffusionConfig
    from diffusion_llm_rs_tpu_torch.models import denoiser as dn
    from diffusion_llm_rs_tpu_torch.ops.matmul import (Int8Weight,
                                                       decode_to_int8)
    from diffusion_llm_rs_tpu_torch.quant.core import (QuantizedTensor,
                                                       map_leaves,
                                                       quantize_tree,
                                                       tree_leaves)
    cfg = DiffusionConfig(num_timesteps=100, hidden_size=256, num_layers=2,
                          num_attention_heads=4, vocab_size=500,
                          max_sequence_length=64, dtype="bfloat16")
    params = quantize_tree(dn.init_denoiser_params(gen, cfg), 4,
                           symmetric=True, group_size=128, axis=0)

    def decode(_, leaf):
        if isinstance(leaf, QuantizedTensor) and leaf.ndim == 2:
            try:
                return decode_to_int8(im.prepare(leaf, act_bits=8))
            except ValueError:
                return leaf
        if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.float32:
            return leaf.to(torch.bfloat16)
        return leaf
    params = map_leaves(decode, params)
    weights = [l for l in tree_leaves(params) if isinstance(l, Int8Weight)]
    linears = 2 + 4 * cfg.num_layers + 1   # the kernels' weights
    assert len(weights) == linears + 1     # and the embedding table
    x = torch.randn((2, 64, 256), generator=gen, device="cuda").to(
        torch.bfloat16)
    t = torch.full((2,), 50, device="cuda")
    im._k_major_copies.clear()
    out = dn.denoiser_forward(params, cfg, x, t)
    torch.cuda.synchronize()
    for w in weights:
        assert w.data.t().is_contiguous()
        assert im._k_major(w.data).data_ptr() == w.data.data_ptr()
    assert not im._k_major_copies

    def row_major(_, leaf):
        if isinstance(leaf, Int8Weight):
            w = dataclasses.replace(leaf)
            object.__setattr__(w, "data", leaf.data.contiguous())
            return w
        return leaf
    before = map_leaves(row_major, params)
    ref = dn.denoiser_forward(before, cfg, x, t)
    torch.cuda.synchronize()
    assert len(im._k_major_copies) == linears
    assert torch.equal(out, ref)


# ------------------------------- per-rank shapes of tensor parallelism ---
# The full-width model (12 layers, width 768, 12 heads of 64) split over
# 'model' at tp = 2 and 4 (`parallel/tp.py`): each rank's packed GEMMs and
# paged attention run the same kernels at these shapes.

TP_LAYERS = {"qkv": (768, 2304, "wqkv"), "mlp.w1": (768, 3072, 1),
             "wo": (768, 768, 0), "mlp.w2": (3072, 768, 0)}


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("layer", list(TP_LAYERS))
@pytest.mark.parametrize("act_bits", [16, 8])
def test_packed_matmul_at_tp_shard_shapes(gen, tp, layer, act_bits):
    """Every rank's shard of an int4 g128 weight at M = 2048 (B=8, S=256):
    qkv's column shards ([768, 1152] / [768, 576], each third split),
    mlp.w1's ([768, 1536] / [768, 768], with bias and gelu), wo's row
    shards ([384, 768]; [192, 768] requantized at group 64) and mlp.w2's
    ([1536, 768] / [768, 768]). Against the plain versions at the
    tolerances of the unsplit tests: act 16 one bf16 ulp; act 8 bit for bit
    (one bf16 ulp with gelu)."""
    from diffusion_llm_rs_tpu_torch.ops import packed_matmul as pm
    from diffusion_llm_rs_tpu_torch.parallel import tp as ttp
    K, N, axis = TP_LAYERS[layer]
    w = _packed_weight(K, N, 4, "group", act_bits, gen)
    name = "matmul_a8" if act_bits == 8 else "matmul"
    gelu = layer == "mlp.w1"
    for idx in range(tp):
        s = (ttp._split_wqkv(w, tp, idx) if axis == "wqkv"
             else ttp._split_weight(w, axis, tp, idx))
        want_kn = ((K, N // tp) if axis in ("wqkv", 1) else (K // tp, N))
        assert (s.K, s.N) == want_kn and s.act_bits == act_bits
        if layer == "wo" and tp == 4:
            assert s.group_size == 64
        x = torch.randn((2048, s.K), generator=gen, device="cuda")
        b = (torch.randn((s.N,), generator=gen, device="cuda") * 0.02
             if gelu else None)
        act = "gelu" if gelu else None
        _build.reset_launch_counts()
        out = pm.matmul(x, s, torch.bfloat16, b, act)
        torch.cuda.synchronize()
        assert _build.launch_counts[name] == 1
        if act_bits == 8:
            ref = pm.a8_matmul_reference(x, s, b, act, torch.bfloat16)
            if not gelu:
                assert torch.equal(out, ref)
                continue
        else:
            ref = pm.matmul_plain(x, s, b, act, torch.bfloat16)
        torch.testing.assert_close(out.float(), ref.float(), rtol=2.0 ** -7,
                                   atol=2e-5 if act_bits == 16 else 1e-6)


def _tp_head_group(tp):
    """The head group `ShardedPagedBatcher._choose_head_group` gives the
    full-width model at `tp` (no process group needed)."""
    from diffusion_llm_rs_tpu_torch.config import DiffusionConfig
    from diffusion_llm_rs_tpu_torch.parallel.serving import ShardedPagedBatcher
    b = object.__new__(ShardedPagedBatcher)
    b.cfg = DiffusionConfig(hidden_size=768, num_layers=12,
                            num_attention_heads=12, vocab_size=50257)
    b.tp, b.dp = tp, 1
    return b._local_heads, b._choose_head_group()


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("act_bits", [16, 8])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_paged_attention_at_tp_local_heads(gen, tp, act_bits, bits):
    """A rank's paged attention at tp = 2 (6 local heads of 64, groups of 2)
    and tp = 4 (3 local heads, groups of 1): 2 slots of S=2048 in pages of
    64 (32 pages, the second slot 21 and a half), the whole pool's pages of
    12 layers; `paged_unpack` bit for bit against its twin on every live
    page, the attention at the tolerances of the unsplit tests."""
    H, G = _tp_head_group(tp)
    assert (H, G) == ((6, 2) if tp == 2 else (3, 1))
    B, Sq, D, P, n = 2, 2048, 64, 64, 32
    pools = _pools(gen, 12 * B * n, H // G, P, G * D, bits, G)
    q = torch.randn((B, H, Sq, D), generator=gen, device="cuda")
    pt = (torch.arange(B, device="cuda")[:, None] * 12 * n + 5 * n
          + torch.arange(n, device="cuda")[None, :]).to(torch.int32)
    nt = torch.full((B, n), P, device="cuda", dtype=torch.int32)
    nt[1, 21], nt[1, 22:] = P // 2, 0
    npg = torch.tensor([n, 22], device="cuda", dtype=torch.int32)
    name = "batched_paged_attention" + ("_a8" if act_bits == 8 else "")
    _build.reset_launch_counts()
    got = pa.paged_unpack(pt, npg, *pools, bits=bits, head_group=G,
                          a8=act_bits == 8)
    out, lse = pa.batched_paged_attention(q, pt, nt, npg, *pools, bits=bits,
                                          return_lse=True, head_group=G,
                                          act_bits=act_bits)
    torch.cuda.synchronize()
    assert dict(_build.launch_counts) == {name: 1, "paged_unpack": 2}
    want = pa.paged_unpack_plain(pt, npg, *pools, bits=bits, head_group=G,
                                 a8=act_bits == 8)
    for b, k in enumerate(npg.tolist()):
        for x, y in zip(got, want):
            assert torch.equal(x[b, :, :k], y[b, :, :k])
    plain = (pa.batched_paged_attention_a8_plain if act_bits == 8
             else pa.batched_paged_attention_plain)
    ref, ref_lse = plain(q, pt, nt, npg, *pools, bits=bits, return_lse=True,
                         head_group=G)
    if act_bits == 8:
        assert float((out - ref).norm() / ref.norm()) <= 5e-3
        torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-3)
    else:
        _close(out, lse, ref, ref_lse)
