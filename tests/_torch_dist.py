"""Run a function on several CPU processes joined by gloo, for the port's
parallel tests.

`spawn(fn, world, payload, tmp)` starts `world` processes, each joining one
process group through a file under `tmp` (no port to collide with other
test workers) with one torch thread, runs `fn(rank, world, payload)` and
returns every rank's result (anything `torch.save` takes). The children
import this module and the module of `fn`: neither may import JAX, so the
test files import it only inside their tests. `export` turns a JAX
parameter tree into numpy leaves in `weights.from_jax_params`' form, telling
the JAX layouts apart by their class names.

A rank ends in order: its result saved, a barrier (no rank closes its
connections while another still talks to it), the group destroyed, and the
process ended with `os._exit`, so that nothing of the group is torn down
again by the interpreter's exit. A rank that dies by a signal dumps its
threads' Python stacks (`faulthandler`), and `spawn` names it and says
whether it had saved its result. Only a run in which every rank saved its
result and one then died tearing down (a failure to join, not a result)
is run again, once; any other failure raises.
"""

import datetime
import faulthandler
import os
import shutil
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ATTEMPTS = 2  # runs of a spawn whose ranks all saved, one dying after


def _entry(rank, fn, world, tmp):
    faulthandler.enable(all_threads=True)
    os.environ["OMP_NUM_THREADS"] = "1"
    torch.set_num_threads(1)
    payload = torch.load(os.path.join(tmp, "..", "payload.pt"),
                         weights_only=False)
    from diffusion_llm_rs_tpu_torch.parallel.mesh import initialize_distributed
    initialize_distributed("gloo", f"file://{tmp}/rendezvous", world, rank,
                           timeout=datetime.timedelta(seconds=120))
    try:
        out = fn(rank, world, payload)
        out["jax_loaded"] = any(
            m.split(".")[0] in ("jax", "diffusion_llm_rs_tpu")
            for m in sys.modules)
        path = os.path.join(tmp, f"rank{rank}.pt")
        torch.save(out, path + ".part")
        os.replace(path + ".part", path)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def spawn(fn, world, payload, tmp):
    """[fn's result on rank r for r in range(world)]; raises if a rank
    raised or died (the others are stopped), naming it."""
    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    # through a file: a large argument would block each start until that
    # child has imported everything and read it, one child after another
    torch.save(payload, os.path.join(tmp, "payload.pt"))
    for attempt in range(ATTEMPTS):
        run = os.path.join(tmp, f"run{attempt}")  # a fresh rendezvous
        shutil.rmtree(run, ignore_errors=True)
        os.makedirs(run)
        paths = [os.path.join(run, f"rank{r}.pt") for r in range(world)]
        try:
            mp.spawn(_entry, args=(fn, world, run), nprocs=world, join=True)
        except mp.ProcessExitedException as e:
            saved = [os.path.exists(p) for p in paths]
            why = (f"rank {e.error_index} of {world} (pid {e.error_pid}) "
                   f"died by {e.signal_name or f'exit code {e.exit_code}'} "
                   f"{'after' if saved[e.error_index] else 'before'} saving "
                   f"its result; ranks with a result: "
                   f"{[r for r in range(world) if saved[r]]}")
            if all(saved) and attempt + 1 < ATTEMPTS:
                print(f"spawn: {why}; every rank saved its result, so the "
                      f"ranks failed to join: running them again",
                      file=sys.stderr, flush=True)
                continue
            raise RuntimeError(f"spawn: {why}") from e
        return [torch.load(p, weights_only=False) for p in paths]


def export(tree):
    """A JAX parameter tree -> nested dicts/lists of numpy leaves."""
    if isinstance(tree, dict):
        return {k: export(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [export(v) for v in tree]
    kind = type(tree).__name__
    if kind == "QuantizedTensor":
        return dict(data=np.array(tree.data), scale=np.array(tree.scale),
                    zero_point=np.array(tree.zero_point), bits=tree.bits,
                    shape=tree.shape, granularity=tree.granularity,
                    group_size=tree.group_size, axis=tree.axis,
                    symmetric=tree.symmetric)
    if kind == "MatmulWeight":
        return dict(data=np.array(tree.data), scale=np.array(tree.scale),
                    zero_point=np.array(tree.zero_point),
                    col_scale=(None if tree.col_scale is None
                               else np.array(tree.col_scale)),
                    bits=tree.bits, K=tree.K, N=tree.N,
                    group_size=tree.group_size, act_bits=tree.act_bits)
    if kind == "Int8Weight":
        return dict(data=np.array(tree.data),
                    col_scale=np.array(tree.col_scale))
    return np.array(tree)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


class Recorded:
    """A noise source that keeps a numpy copy of every draw of another, with
    its kind, for `Replay` in other processes."""

    def __init__(self, inner):
        self.inner, self.draws = inner, []

    def admission(self, shape):
        x = self.inner.admission(shape)
        self.draws.append(("admission", np.array(x)))
        return x

    def step(self, shape):
        x = self.inner.step(shape)
        self.draws.append(("step", np.array(x)))
        return x


class Replay:
    """Replays `Recorded.draws` in order; a draw of another kind or shape
    than recorded fails (the run took another path than the recorded one)."""

    def __init__(self, draws):
        self.draws = list(draws)

    def _next(self, kind, shape):
        got, x = self.draws.pop(0)
        assert got == kind and x.shape == tuple(shape), (got, kind, x.shape)
        return torch.from_numpy(x)

    def admission(self, shape):
        return self._next("admission", shape)

    def step(self, shape):
        return self._next("step", shape)
