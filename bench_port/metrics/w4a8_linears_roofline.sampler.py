"""The W4A8 linears' share of their roofline: the least time of every
launch of csrc/int8_gemm.cu's and csrc/int8_mlp.cu's kernels in the
window, over their device time in the trace."""

from bench_port.readers import w4a8_roofline as read  # noqa: F401
