"""Captured CUDA graphs of the sampling and serving steps.

The port's counterpart of the JAX package's compiled programs: where JAX
compiles a sampler's `lax.scan` or a batcher's jitted step once and runs it
as one XLA program, the port captures one step of the loop as a CUDA graph
on the card and replays it for every later step. A step reads its inputs
from static buffers and writes its results into them in place (the scan's
carry); the caller copies each step's inputs (t, the noise) in before a
replay and reads the results out after.

- `GraphCache`: the graphs of one owner (a batcher, or a sampler's
  (model_fn, shape): `cache_for`), keyed by the caller. A key's first step
  runs eagerly and is a real step: it loads the kernels' libraries and
  fills their plan caches. Its second step is captured, then replayed, and
  every later one replayed. Each entry records the `data_ptr()` of the
  tensors the caller says the graph reads or writes in place (pools,
  weights, schedule tables); a step whose tensors lie elsewhere captures
  the key again (a recapture) and never replays the stale graph. All the
  graphs of one owner share one memory pool: they never replay at once,
  and a step keeps nothing it allocates.
- `disabled()`: inside it every step runs eagerly, on the card too, the
  counterpart of `jax.disable_jit()`. On a CPU device nothing is captured.
- A capture that fails raises, naming the key; nothing falls back to eager
  on its own.
- Capturing runs the kernel wrappers' Python once, so the launch counts of
  `ops/_build.py` are taken out again and recorded with the graph; each
  replay adds them (`_build.recording_launches`).

Counters in `utils.metrics`: `graphs.captures` (recaptures included),
`graphs.recaptures`, `graphs.replays`, `graphs.capture_s` (seconds spent
capturing).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time
import weakref
from typing import Callable, Dict, Hashable, Optional

import torch

from diffusion_llm_rs_tpu_torch.ops import _build
from diffusion_llm_rs_tpu_torch.utils.metrics import metrics

_state = threading.local()


@contextlib.contextmanager
def disabled():
    """Run every step eagerly inside (nests; this thread only)."""
    _state.depth = getattr(_state, "depth", 0) + 1
    try:
        yield
    finally:
        _state.depth -= 1


def is_disabled() -> bool:
    return getattr(_state, "depth", 0) > 0


# ------------------------------------------------------------ tensor trees --

def tensors(tree) -> list:
    """The tensors of a nested dict/list/tuple whose leaves may be
    dataclasses (quantized weights, QuantKV, a schedule), in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensors(v)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [t for f in dataclasses.fields(tree)
                for t in tensors(getattr(tree, f.name))]
    return []


_PLAIN = (int, float, bool, str, type(None))


def _layout(tree, out: list) -> None:
    if isinstance(tree, torch.Tensor):
        out.append((tree.data_ptr(), tuple(tree.shape), tree.stride(),
                    tree.dtype))
    elif isinstance(tree, dict):
        for v in tree.values():
            _layout(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _layout(v, out)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            v = getattr(tree, f.name)
            if isinstance(v, _PLAIN):
                out.append((f.name, v))
            else:
                _layout(v, out)


def pointers(*trees) -> tuple:
    """What a graph recorded of the tensors of `trees`, which it reads or
    writes in place: each one's `data_ptr()` with its shape, strides and
    dtype, and the plain fields of the dataclasses holding them (a packed
    weight's bits), so other tensors that come to lie at the same address
    are not taken for the recorded ones."""
    out: list = []
    for tree in trees:
        _layout(tree, out)
    return tuple(out)


def clone(tree):
    """A copy of a tree of tensors and dataclasses, new storage throughout."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(clone(v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: clone(getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    return tree


def copy_into(dst, src) -> None:
    """Copy every tensor of `src` into the same place of `dst` (in place)."""
    ds, ss = tensors(dst), tensors(src)
    if len(ds) != len(ss):
        raise ValueError(f"copy_into: {len(ss)} tensors into {len(ds)}")
    for d, s in zip(ds, ss):
        d.copy_(s)


# ------------------------------------------------------------------ graphs --

_capture_streams: Dict[int, torch.cuda.Stream] = {}


class CudaGraph:
    """A `torch.cuda.CUDAGraph` captured on one side stream per device (a
    new stream would get a cuBLAS workspace of its own at each capture)."""

    @staticmethod
    def pool():
        return torch.cuda.graph_pool_handle()

    def __init__(self):
        self.graph = torch.cuda.CUDAGraph()

    def capture(self, fn: Callable[[], None], pool) -> None:
        """Capture `fn()`, in CUDA's thread-local capture mode: only an
        unsafe call from this thread voids it (ProcessGroupNCCL's watchdog
        thread queries events while a step with NCCL collectives is
        captured)."""
        device = torch.cuda.current_device()
        stream = _capture_streams.get(device)
        if stream is None:
            stream = _capture_streams[device] = torch.cuda.Stream()
        torch.cuda.synchronize()
        with torch.cuda.stream(stream):
            self.graph.capture_begin(pool=pool,
                                     capture_error_mode="thread_local")
            try:
                fn()
            except BaseException:
                try:  # leave capture mode; the capture is void
                    self.graph.capture_end()
                except RuntimeError:
                    pass
                raise
            self.graph.capture_end()
        torch.cuda.current_stream().wait_stream(stream)

    def replay(self) -> None:
        self.graph.replay()


@dataclasses.dataclass
class _Entry:
    graph: object
    held: tuple
    launches: collections.Counter


class GraphCache:
    """The captured steps of one owner, by key; see the module docstring.

    `static` holds the owner's static buffers (`buffer`); `run(key, fn,
    held)` runs one step. `capture=False` keeps every step eager (a step
    that a CUDA graph cannot hold, e.g. one with a gloo collective).
    `graph_type` makes the graph objects (`CudaGraph` on the card)."""

    graph_type = CudaGraph

    def __init__(self, name: str, device, capture: bool = True):
        self.name = name
        self.device = torch.device(device)
        self.capture = capture
        self.static: Dict[Hashable, object] = {}
        self._entries: Dict[Hashable, _Entry] = {}
        self._warm: set = set()
        self._pool = None

    def capturing(self) -> bool:
        """Whether steps are captured and replayed here and now."""
        return self.capture and self.device.type == "cuda" and \
            not is_disabled()

    def buffer(self, name: Hashable, make: Callable[[], object]):
        """The static buffer `name`, made by `make()` on first use."""
        if name not in self.static:
            self.static[name] = make()
        return self.static[name]

    def run(self, key: Hashable, fn: Callable[[], None],
            held: tuple = ()) -> None:
        """One step: `fn()` eagerly, or the graph of `key` replayed (captured
        first where there is none, or where `held`, the `pointers` of what
        the step reads or writes in place, differ from the recorded ones)."""
        if not self.capturing():
            fn()
            return
        entry = self._entries.get(key)
        if entry is not None and entry.held != held:
            del self._entries[key]
            entry = None
            metrics.inc("graphs.recaptures")
        elif entry is None and key not in self._warm:
            self._warm.add(key)   # the warm-up: a real step, eagerly
            fn()
            return
        if entry is None:
            entry = self._capture(key, fn, held)
        entry.graph.replay()
        _build.launch_counts.update(entry.launches)
        metrics.inc("graphs.replays")

    def _capture(self, key, fn, held) -> _Entry:
        if self._pool is None:
            self._pool = self.graph_type.pool()
        graph = self.graph_type()
        t0 = time.perf_counter()
        with _build.recording_launches() as launches:
            try:
                graph.capture(fn, self._pool)
            except Exception as e:
                raise RuntimeError(
                    f"capturing the {self.name} step {key!r} as a CUDA graph "
                    f"failed: {e}. Under diffusion_llm_rs_tpu_torch.utils."
                    f"graphs.disabled() the step runs eagerly.") from e
        metrics.inc("graphs.captures")
        metrics.inc("graphs.capture_s", time.perf_counter() - t0)
        entry = self._entries[key] = _Entry(graph, held, launches)
        return entry


# the samplers' caches: one per (owner, key), held as long as the owner
# (a model_fn or forward_fn) lives, at most `_PER_OWNER` keys each
_owned: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_PER_OWNER = 4


def cache_for(owner, key: Hashable, name: str, device) -> GraphCache:
    """The `GraphCache` of (`owner`, `key`). A function is held weakly; an
    owner that cannot be (or a bound method, a new object at each access)
    gets a cache for this call only. The least recently used key of an
    owner with more than four goes, its graphs and pool with it."""
    try:
        caches: Optional[collections.OrderedDict] = _owned.get(owner)
        if caches is None:
            caches = _owned[owner] = collections.OrderedDict()
    except TypeError:
        caches = collections.OrderedDict()
    cache = caches.get(key)
    if cache is None:
        cache = caches[key] = GraphCache(name, device)
        while len(caches) > _PER_OWNER:
            caches.popitem(last=False)
    caches.move_to_end(key)
    return cache
