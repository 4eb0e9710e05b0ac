"""Milliseconds of the window a denoise step: the window's length over
the steps run in it (every slot steps at once)."""

from bench_port.readers import step_ms as read  # noqa: F401
