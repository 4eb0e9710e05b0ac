"""Tracing and profiling helpers.

Counterpart of `diffusion_llm_rs_tpu/utils/profiling.py`: `setup_logging`
installs a structured handler on the package's logger; `stage` logs a
stage's entry and wall time and names it in profiles
(`torch.profiler.record_function`, plus an NVTX range when CUDA is
available); `profile_trace` records the enclosed block with
`torch.profiler` (the card's kernels too, when CUDA is available) and
writes a Chrome trace into `log_dir`. `utils/platform.py`, which pins JAX's
platform, has no counterpart: entry points take a torch device.
"""

from __future__ import annotations

import contextlib
import logging
import os
import tempfile
import time
from typing import Iterator, Optional

import torch

logger = logging.getLogger("diffusion_llm_rs_tpu_torch")


def setup_logging(level: int = logging.INFO) -> None:
    """Install a basic structured handler."""
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s"))
        logger.addHandler(h)
    logger.setLevel(level)


@contextlib.contextmanager
def stage(name: str, **fields) -> Iterator[None]:
    """Span-style stage scope: logs entry and exit with the wall time, and
    names the enclosed operations `name` in profiles."""
    t0 = time.perf_counter()
    logger.debug("enter %s %s", name, fields or "")
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
    logger.info("%s done in %.3fs %s", name, time.perf_counter() - t0,
                fields or "")


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str] = None) -> Iterator[object]:
    """Profile the enclosed block and write its Chrome trace to
    `log_dir/trace-<pid>-<ns>.json` (default: `dlm_torch_profile` in the
    temporary directory). Yields the `torch.profiler.profile` object."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(),
                                      "dlm_torch_profile")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))
