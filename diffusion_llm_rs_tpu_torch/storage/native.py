"""ctypes binding for the framework-neutral C++ host runtime
(`csrc/dlm_runtime.cpp` at the root of the checkout), with a pure-Python
fallback for every entry point.

Counterpart of `diffusion_llm_rs_tpu/storage/native.py`: FNV-1a hashing,
the store file's append / pread / fsync, the greedy BPE merge loop and an
aligned block pool. This is a host path, not a device one. The library
builds with `g++` on first use into this package's own
`build/native/libdlm_runtime-<hash>.so` at the root of the checkout (the
hash of the source and the flags names it, so an edited source builds
anew); it compiles to a temporary name and is renamed into place, so a
process never loads a half-written file. `NATIVE_AVAILABLE` says which path
is live.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

_ROOT = Path(__file__).resolve().parents[2]
_SRC_PATH = _ROOT / "csrc" / "dlm_runtime.cpp"
BUILD_DIR = _ROOT / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
_tried = False
NATIVE_AVAILABLE = False


def _target() -> Path:
    digest = hashlib.sha256(_SRC_PATH.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libdlm_runtime-{digest}.so"


def _build() -> Optional[Path]:
    """The built library, compiling it if needed; None without a source or
    a compiler."""
    if not _SRC_PATH.exists():
        return None
    target = _target()
    if target.exists():
        return target
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(_SRC_PATH)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, target)
        return target
    except (OSError, subprocess.SubprocessError):  # no compiler, or it failed
        return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried, NATIVE_AVAILABLE
    with _lib_lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        lib.dlm_fnv1a64.restype = ctypes.c_uint64
        lib.dlm_fnv1a64.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.dlm_open.restype = ctypes.c_int
        lib.dlm_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.dlm_append.restype = ctypes.c_int64
        lib.dlm_append.argtypes = [ctypes.c_int, ctypes.c_char_p,
                                   ctypes.c_uint64]
        lib.dlm_pread.restype = ctypes.c_int64
        lib.dlm_pread.argtypes = [ctypes.c_int, ctypes.c_char_p,
                                  ctypes.c_uint64, ctypes.c_uint64]
        lib.dlm_fsync.argtypes = [ctypes.c_int]
        lib.dlm_close.argtypes = [ctypes.c_int]
        lib.dlm_file_size.restype = ctypes.c_int64
        lib.dlm_file_size.argtypes = [ctypes.c_int]
        lib.dlm_pool_create.restype = ctypes.c_int
        lib.dlm_pool_create.argtypes = [ctypes.c_uint64, ctypes.c_uint64]
        lib.dlm_pool_alloc.restype = ctypes.c_int64
        lib.dlm_pool_alloc.argtypes = [ctypes.c_int]
        lib.dlm_pool_free.restype = ctypes.c_int
        lib.dlm_pool_free.argtypes = [ctypes.c_int, ctypes.c_uint64]
        lib.dlm_pool_num_free.restype = ctypes.c_int64
        lib.dlm_pool_num_free.argtypes = [ctypes.c_int]
        lib.dlm_pool_destroy.restype = ctypes.c_int
        lib.dlm_pool_destroy.argtypes = [ctypes.c_int]
        lib.dlm_bpe_new.restype = ctypes.c_int
        lib.dlm_bpe_new.argtypes = [ctypes.POINTER(ctypes.c_uint32),
                                    ctypes.POINTER(ctypes.c_uint32),
                                    ctypes.c_uint64]
        lib.dlm_bpe_encode_word.restype = ctypes.c_int64
        lib.dlm_bpe_encode_word.argtypes = [
            ctypes.c_int, ctypes.c_char_p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint32)]
        lib.dlm_bpe_free.restype = ctypes.c_int
        lib.dlm_bpe_free.argtypes = [ctypes.c_int]
        _lib = lib
        NATIVE_AVAILABLE = True
        return _lib


# ---------------------------------------------------------------------------
# Hashing
# ---------------------------------------------------------------------------


def fnv1a64(data: bytes) -> int:
    lib = _load()
    if lib is not None:
        return int(lib.dlm_fnv1a64(data, len(data)))
    return fnv1a64_py(data)


def fnv1a64_py(data: bytes) -> int:
    """The Python fallback of `fnv1a64`."""
    h = 0xCBF29CE484222325
    for b in data:
        h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


# ---------------------------------------------------------------------------
# Store file handles (native fd when available, else Python file object)
# ---------------------------------------------------------------------------


class _PyStore:
    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.f = open(path, "a+b")


def open_store(path: str, direct_io: bool = False):
    lib = _load()
    if lib is not None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        fd = lib.dlm_open(path.encode(), 1 if direct_io else 0)
        if fd >= 0:
            return ("native", fd)
    return ("py", _PyStore(path))


def append(handle, data: bytes) -> int:
    kind, h = handle
    if kind == "native":
        off = _load().dlm_append(h, data, len(data))
        if off < 0:
            raise OSError("native append failed")
        return off
    h.f.seek(0, os.SEEK_END)
    off = h.f.tell()
    h.f.write(data)
    return off


def pread(handle, offset: int, length: int) -> bytes:
    kind, h = handle
    if kind == "native":
        buf = ctypes.create_string_buffer(length)
        got = _load().dlm_pread(h, buf, length, offset)
        if got < 0:
            raise OSError("native pread failed")
        return buf.raw[:got]
    h.f.flush()
    h.f.seek(offset)
    return h.f.read(length)


def fsync(handle) -> None:
    kind, h = handle
    if kind == "native":
        _load().dlm_fsync(h)
    else:
        h.f.flush()
        os.fsync(h.f.fileno())


def file_size(handle) -> int:
    kind, h = handle
    if kind == "native":
        return int(_load().dlm_file_size(h))
    h.f.flush()
    return os.fstat(h.f.fileno()).st_size


def close_store(handle) -> None:
    kind, h = handle
    if kind == "native":
        _load().dlm_close(h)
    else:
        h.f.close()


# ---------------------------------------------------------------------------
# Native BPE encoder (tokenizer hot loop)
# ---------------------------------------------------------------------------


class BpeEncoder:
    """Greedy BPE merge loop in C++; returns None handle when unavailable."""

    def __init__(self, merges):
        lib = _load()
        self._handle = -1
        if lib is None or not merges:
            return
        n = len(merges)
        a = (ctypes.c_uint32 * n)(*[m[0] for m in merges])
        b = (ctypes.c_uint32 * n)(*[m[1] for m in merges])
        self._handle = lib.dlm_bpe_new(a, b, n)

    @property
    def available(self) -> bool:
        return self._handle >= 0

    def encode_word(self, word: bytes):
        out = (ctypes.c_uint32 * max(len(word), 1))()
        n = _load().dlm_bpe_encode_word(self._handle, word, len(word), out)
        if n < 0:
            raise RuntimeError("bpe encode failed")
        return list(out[:n])

    def close(self) -> None:
        if self._handle >= 0:
            _load().dlm_bpe_free(self._handle)
            self._handle = -1

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


# ---------------------------------------------------------------------------
# Aligned block pool (fusion-anns GPUMemoryManager equivalent)
# ---------------------------------------------------------------------------


class BlockPool:
    """64-byte-aligned fixed-size block pool backed by the C++ allocator
    (`fusion-anns/src/lib.rs:120-168` equivalent, without the leak)."""

    def __init__(self, num_blocks: int, block_size: int):
        self.num_blocks = num_blocks
        self.block_size = block_size
        lib = _load()
        self._native = lib is not None
        if self._native:
            self._handle = lib.dlm_pool_create(num_blocks, block_size)
            if self._handle < 0:
                raise MemoryError("pool creation failed")
        else:
            self._free = list(range(num_blocks - 1, -1, -1))
            self._in_use = [False] * num_blocks
            self._mem = [None] * num_blocks

    def allocate_block(self) -> int:
        if self._native:
            idx = _load().dlm_pool_alloc(self._handle)
            if idx < 0:
                raise MemoryError("no free memory blocks available")
            return int(idx)
        if not self._free:
            raise MemoryError("no free memory blocks available")
        idx = self._free.pop()
        self._in_use[idx] = True
        if self._mem[idx] is None:
            self._mem[idx] = bytearray(self.block_size)
        return idx

    def free_block(self, idx: int) -> None:
        if self._native:
            if _load().dlm_pool_free(self._handle, idx) != 0:
                raise ValueError(f"invalid block {idx}")
            return
        if not self._in_use[idx]:
            raise ValueError(f"invalid block {idx}")
        self._in_use[idx] = False
        self._free.append(idx)

    def num_free(self) -> int:
        if self._native:
            return int(_load().dlm_pool_num_free(self._handle))
        return len(self._free)

    def destroy(self) -> None:
        if self._native:
            _load().dlm_pool_destroy(self._handle)
        else:
            self._mem = []
