"""Build and load the package's CUDA kernels.

Each `csrc/<name>.cu` compiles with `nvcc` for `sm_90a` into a shared library
with a plain C interface, `build/kernels/<name>-<hash>.so` at the root of the
checkout, on first use; the hash of the source and of the shared headers
(`csrc/*.cuh`) names the file, so an edited source builds anew. The
libraries are loaded with `ctypes`: every pointer and the stream pass as
`c_void_p`, every int as `c_int`, every C function returns an int (a
`cudaError_t`, or a size), and `check` raises when an error is not 0.

The launch counts live here too: each kernel wrapper adds one to its entry of
`launch_counts` where it launches its kernel, and nowhere else. A CUDA
graph's capture adds nothing; each of its replays adds the counts recorded
at its capture (`recording_launches`), so the counts are those of the
kernels that ran, replayed or not.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("int8_gemm", "int8_mlp", "dense_attention", "quant_flash_paged",
           "quant_flash_paged_padded", "packed_gemm", "quant_flash_contig",
           "quant_flash_contig_padded", "paged_unpack",
           "batched_paged_attention", "paged_attention_a8",
           "fused_qkv_attention", "dense_attention_wide",
           "quant_flash_contig_wide", "quant_flash_paged_wide",
           "paged_flash_wide", "paged_flash_cluster",
           "fused_qkv_attention_wide")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures: name -> (library, argtypes)
SIGNATURES = {
    "dlm_quant_rows": ("int8_gemm", (_P, _I, _P, _P, _I, _I, _P)),
    "dlm_int8_gemm": ("int8_gemm", (_P,) * 6 + (_I, _P) + (_I,) * 7
                      + (_P, _P, _I)),
    "dlm_int8_gemm_plan": ("int8_gemm", (_I,) * 4),
    "dlm_int8_mlp": ("int8_mlp", (_P,) * 9 + (_I,) * 6 + (_P, _I)),
    "dlm_int8_mlp_active_clusters": ("int8_mlp", (_I, _I, _I)),
    "dlm_dense_attention": ("dense_attention", (_P, _P, _P, _P, _I, _I, _I, _I,
                                                _I, _F, _P)),
    "dlm_dense_attention_cluster": ("dense_attention_wide",
                                    (_P, _P, _P, _P) + (_I,) * 5
                                    + (_F, _P, _P)),
    "dlm_dense_attention_cluster_active": ("dense_attention_wide", (_I,)),
    "dlm_paged_unpack": ("paged_unpack", (_P,) * 11 + (_I,) * 10 + (_F, _P)),
    "dlm_batched_paged_attention": ("batched_paged_attention",
                                    (_P,) * 8 + (_I,) * 6 + (_P,)),
    "dlm_paged_attention": ("quant_flash_paged",
                            (_P,) * 11 + (_I,) * 7 + (_F, _P)),
    "dlm_paged_attention_padded": ("quant_flash_paged_padded",
                                   (_P,) * 11 + (_I,) * 7 + (_F, _P)),
    "dlm_batched_paged_attention_a8": ("paged_attention_a8",
                                       (_P,) * 8 + (_I,) * 6 + (_P,)),
    "dlm_paged_attention_cluster": ("quant_flash_paged_wide",
                                    (_P,) * 11 + (_I,) * 7 + (_F, _P, _I)
                                    + (_P,) * 4),
    "dlm_paged_attention_cluster_splits": ("quant_flash_paged_wide",
                                           (_I,) * 5),
    "dlm_batched_paged_attention_wide": ("paged_flash_wide",
                                         (_P,) * 8 + (_I,) * 8 + (_P,)),
    "dlm_batched_paged_attention_cluster": ("paged_flash_cluster",
                                            (_P,) * 8 + (_I,) * 8 + (_P,)),
    "dlm_batched_paged_attention_a8_cluster": ("paged_flash_cluster",
                                               (_P,) * 8 + (_I,) * 8
                                               + (_P,) * 3),
    "dlm_batched_paged_attention_cluster_active": ("paged_flash_cluster",
                                                   (_I,) * 3),
    "dlm_quant_attention_wide": ("quant_flash_contig_wide",
                                 (_P,) * 8 + (_I,) * 5 + (_F, _P)),
    "dlm_quant_attention_cluster": ("quant_flash_contig_wide",
                                    (_P,) * 8 + (_I,) * 5 + (_F, _P, _I)
                                    + (_P,) * 3),
    "dlm_quant_attention_cluster_active": ("quant_flash_contig_wide",
                                           (_I, _I)),
    "dlm_quant_attention_cluster_splits": ("quant_flash_contig_wide",
                                           (_I,) * 5),
    "dlm_quant_attention": ("quant_flash_contig",
                            (_P,) * 8 + (_I,) * 5 + (_F, _P)),
    "dlm_quant_attention_padded": ("quant_flash_contig_padded",
                                   (_P,) * 8 + (_I,) * 5 + (_F, _P)),
    "dlm_packed_gemm_splits": ("packed_gemm", (_I,) * 4),
    "dlm_packed_gemm": ("packed_gemm", (_P,) * 5 + (_I, _P) + (_I,) * 6
                        + (_P, _I, _P)),
    "dlm_packed_unpack_i8": ("packed_gemm", (_P,) * 5 + (_I,) * 4 + (_P,)),
    "dlm_fused_qkv_attention": ("fused_qkv_attention",
                                (_P, _P) + (_I,) * 5 + (_F, _P)),
    "dlm_fused_qkv_attention_cluster": ("fused_qkv_attention_wide",
                                        (_P, _P) + (_I,) * 5 + (_F, _P, _P)),
    "dlm_fused_qkv_attention_cluster_active": ("fused_qkv_attention_wide",
                                               (_I,)),
}

launch_counts: collections.Counter = collections.Counter()

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# ptxas report (registers, shared memory, spills) and wall seconds of each
# build in this process
build_logs: Dict[str, str] = {}
build_seconds: Dict[str, float] = {}


def reset_launch_counts() -> None:
    launch_counts.clear()


@contextlib.contextmanager
def recording_launches():
    """Take the launches counted inside out of `launch_counts` again and
    yield them as a Counter: a CUDA graph's capture runs the wrappers'
    Python but launches nothing, and each replay adds the recorded counts,
    so the counts stay those of the kernels that ran."""
    before = launch_counts.copy()
    recorded: collections.Counter = collections.Counter()
    try:
        yield recorded
    finally:
        recorded.update(launch_counts - before)
        launch_counts.clear()
        launch_counts.update(before)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    # the shared headers are part of every source's hash
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile the named sources that are not built yet, all at once.

    Raises RuntimeError with the compiler's output if any build fails."""
    names = tuple(names)
    targets = {n: _target(n) for n in names}
    todo = [n for n in names if not targets[n].exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        t0 = time.perf_counter()
        for n in todo:
            tmp = targets[n].with_suffix(f".{os.getpid()}.tmp")
            log = tmp.with_suffix(".log")
            with open(log, "w") as f:
                procs[n] = (tmp, log, subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
                    stdout=f, stderr=subprocess.STDOUT))
        failed = []
        while procs:
            for n in [n for n, (_, _, p) in procs.items() if p.poll() is not None]:
                tmp, log, proc = procs.pop(n)
                build_seconds[n] = time.perf_counter() - t0
                build_logs[n] = out = log.read_text()
                log.unlink()
                if proc.returncode != 0:
                    failed.append(f"{n}.cu (nvcc exit {proc.returncode}):\n{out}")
                else:
                    os.replace(tmp, targets[n])
            time.sleep(0.1)
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return targets


def _library(name: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build((name,))[name]))
            for fn, (owner, argtypes) in SIGNATURES.items():
                if owner == name:
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return lib


def function(fn: str):
    """The C entry point `fn`, from its library (built on first use)."""
    return getattr(_library(SIGNATURES[fn][0]), fn)


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
