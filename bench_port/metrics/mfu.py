"""The step's share of the chip's peak: per cent of the window that the
useful work done in it would take at the published peaks (int8 linears,
bf16 attention over each request's own keys, the f32 readout)."""

from bench_port.readers import mfu as read  # noqa: F401
