"""The three loops that drive a cell: a backlog through the server, an
open loop of arrivals through the server, and back-to-back sampler calls.

Each warms up on its own stream of the seed until every step graph its
traffic reaches has been captured, then measures `seconds` of the
measured stream and returns a `Record`: the window's bounds, every
request it saw (its shape, slot, noise draws, due, admission and
completion times, served tokens), and the program's counters around the
window. Times are `time.perf_counter()` seconds unless named `_wall`
(`time.time()`, the clock of `Request.submitted_at`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from bench_port import system, traffic as tr
from bench_port.seeds import ServingNoise, mix
from bench_port.trace import Recorder

# warm-up: step() calls of the cell's traffic after every step graph is
# captured, so that the window starts with the slots full
WARM_CALLS = 4
# open loop: seconds of arrivals at the cell's rate before the window
WARM_OPEN_S = 4.0
# seconds a request due in the window may take to finish after it
DRAIN_LIMIT_S = 60.0


@dataclasses.dataclass
class Req:
    rid: str
    seq_len: int
    num_steps: int
    due_wall: float = 0.0
    slot: int = -1
    wave: int = -1
    first_step: int = -1
    admitted_wall: float = 0.0
    latency_s: Optional[float] = None
    tokens: Optional[np.ndarray] = None
    in_window: bool = False


@dataclasses.dataclass
class Record:
    loop: str
    seconds: float
    t0: float = 0.0                 # window start, perf_counter
    t1: float = 0.0                 # window end, perf_counter
    t0_ns: int = 0                  # window start, time.time_ns()
    t1_ns: int = 0
    step_draws: tuple = (0, 0)      # [first, end) step draws of the window
    reqs: Dict[str, Req] = dataclasses.field(default_factory=dict)
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    warm_calls: int = 0
    calls: int = 0                  # sampler calls in the window
    lateness_s: List[float] = dataclasses.field(default_factory=list)
    spans: List[tuple] = dataclasses.field(default_factory=list)
    slots: int = 0
    seq_len: int = 0
    # sampler: (call index, generator seed, tokens) of every call, and the
    # (call index, sampled x) of the call the check reads
    outputs: List[tuple] = dataclasses.field(default_factory=list)
    kept: Optional[tuple] = None
    peak_bytes: int = 0
    recorder: Recorder = dataclasses.field(
        default_factory=lambda: Recorder(False))

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    @property
    def steps(self) -> int:
        return self.step_draws[1] - self.step_draws[0]


def _diff(after: dict, before: dict) -> dict:
    return {k: after.get(k, 0) - before.get(k, 0)
            for k in set(after) | set(before)}


class Server:
    """A batcher with the bookkeeping around it: which request went where
    and when, read through the noise source's admission hook."""

    def __init__(self, cfg, params, traffic: dict, seed: int, device):
        self.noise = ServingNoise(mix(seed, "noise"), device,
                                  on_admission=self._admitted)
        self.b = system.batcher(cfg, params, traffic, self.noise, device)
        self.reqs: Dict[str, Req] = {}
        self.spans: List[tuple] = []

    def _admitted(self, wave: int, first_step: int) -> None:
        now = time.time()
        for slot, r in enumerate(self.b.slot_request):
            if r is None or int(self.b.t[slot]) != r.num_steps - 1:
                continue
            q = self.reqs[r.request_id]
            if q.wave < 0:
                q.slot, q.wave, q.first_step = slot, wave, first_step
                q.admitted_wall = now

    def submit(self, q: Req) -> None:
        self.reqs[q.rid] = q
        self.b.submit(system.Request(q.rid, q.seq_len, q.num_steps,
                                     submitted_at=q.due_wall or time.time()))

    def _collect(self) -> None:
        while self.b.completions:
            c = self.b.completions.popleft()
            q = self.reqs[c.request_id]
            q.tokens, q.latency_s = c.tokens, c.latency_s

    def step(self) -> None:
        a = time.time_ns()
        self.b.step()
        self.spans.append(("batcher.step", a, time.time_ns()))
        self._collect()

    def flush(self) -> None:
        self.b.stats()          # copies the launched readouts to the host
        self._collect()

    def busy(self) -> bool:
        return bool(self.b.queue) or self.b.active_slots() > 0


def _open_window(rec: Record, srv: Optional[Server]) -> None:
    rec.recorder.start()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    rec.counters = system.counters()
    rec.launches = system.launches()
    if srv is not None:
        rec.step_draws = (srv.noise.steps, 0)
    rec.t0_ns = time.time_ns()
    rec.t0 = time.perf_counter()


def _close_window(rec: Record, srv: Optional[Server]) -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    rec.t1 = time.perf_counter()
    rec.t1_ns = time.time_ns()
    rec.peak_bytes = (torch.cuda.max_memory_allocated()
                      if torch.cuda.is_available() else 0)
    rec.recorder.stop()
    rec.counters = _diff(system.counters(), rec.counters)
    rec.launches = _diff(system.launches(), rec.launches)
    if srv is not None:
        rec.step_draws = (rec.step_draws[0], srv.noise.steps)


def _capture_every_key(srv: Server) -> None:
    """Capture the step graph of every set of KV buckets a chunk can write
    (the batcher keys its graphs by that set): with no slot active, two
    steps of each, the first run eagerly and the second captured. A
    chunk's set depends on the phases of the requests in it, so the
    traffic alone reaches the rarer sets late or never before the
    window."""
    b = srv.b
    idle = np.ones(b.num_slots, np.int64)
    empty = np.zeros(b.num_slots, np.int32)
    for mask in range(1, 1 << len(b.buckets)):
        used = tuple(x for i, x in enumerate(b.buckets) if mask >> i & 1)
        b._run_chunk(2, idle, empty, used)


def _warm(srv: Server, feed, rec: Record) -> None:
    """Every step graph, then WARM_CALLS step() calls of `feed()`'s
    traffic."""
    _capture_every_key(srv)
    for _ in range(WARM_CALLS):
        feed()
        srv.step()
        rec.warm_calls += 1


def backlog(cfg, params, traffic: dict, seed: int, seconds: float,
            device, recorder: Recorder) -> Record:
    """Offline generation: the queue is kept at `queue_depth` times the
    slots, so every slot is refilled at each chunk boundary."""
    rec = Record("backlog", seconds, slots=traffic["slots"],
                 seq_len=traffic["seq_len"], recorder=recorder)
    srv = Server(cfg, params, traffic, seed, device)
    depth = traffic["queue_depth"] * traffic["slots"]
    n = [0]

    def feed(shapes, prefix, in_window):
        def top_up():
            while len(srv.b.queue) < depth:
                s = next(shapes)
                srv.submit(Req(f"{prefix}{n[0]}", s.seq_len, s.num_steps,
                               in_window=in_window))
                n[0] += 1
        return top_up

    _warm(srv, feed(tr.requests(traffic, "warm"), "w", False), rec)
    top_up = feed(tr.requests(traffic, "measured"), "m", True)
    _open_window(rec, srv)
    deadline = rec.t0 + seconds
    while time.perf_counter() < deadline:
        top_up()
        srv.step()
    _close_window(rec, srv)
    srv.flush()
    rec.reqs, rec.spans = srv.reqs, srv.spans
    return rec


def open_loop(cfg, params, traffic: dict, seed: int, seconds: float,
              device, recorder: Recorder) -> Record:
    """Interactive users: Poisson arrivals at the mix's fixed rate, each
    request timed from when it was due."""
    rec = Record("open", seconds, slots=traffic["slots"],
                 seq_len=traffic["seq_len"], recorder=recorder)
    srv = Server(cfg, params, traffic, seed, device)

    def run(arrivals, prefix, in_window, until, t_base):
        """Submit each arrival at its due time and step while there is
        work, up to `until` (perf_counter)."""
        i = 0
        while True:
            now = time.perf_counter()
            while i < len(arrivals) and arrivals[i][0] <= now:
                due, s = arrivals[i]
                q = Req(f"{prefix}{i}", s.seq_len, s.num_steps,
                        due_wall=t_base + due, in_window=in_window)
                srv.submit(q)
                if in_window:
                    rec.lateness_s.append(now - due)
                i += 1
            if now >= until:
                return
            if srv.busy():
                srv.step()
            else:
                srv.flush()
                nxt = arrivals[i][0] if i < len(arrivals) else until
                time.sleep(max(0.0, min(nxt, until) - now))

    # the warm-up: every step graph, then the cell's rate from the warm
    # stream, so that the window opens on a loaded server
    wall_base = time.time() - time.perf_counter()
    _capture_every_key(srv)
    now = time.perf_counter()
    arr = tr.arrivals(traffic, "warm", now, now + WARM_OPEN_S)
    run(arr, "w", False, now + WARM_OPEN_S, wall_base)
    rec.warm_calls = len(srv.spans)
    _open_window(rec, srv)
    arr = tr.arrivals(traffic, "measured", rec.t0, rec.t0 + seconds)
    run(arr, "m", True, rec.t0 + seconds, wall_base)
    _close_window(rec, srv)
    # requests due in the window finish after it, and keep their latency
    end = time.perf_counter() + DRAIN_LIMIT_S
    while any(q.in_window and q.tokens is None for q in srv.reqs.values()) \
            and time.perf_counter() < end:
        if srv.busy():
            srv.step()
        else:
            srv.flush()
    srv.flush()
    rec.reqs, rec.spans = srv.reqs, srv.spans
    return rec


def sampler_calls(cfg, params, traffic: dict, seed: int, seconds: float,
                  device, recorder: Recorder) -> Record:
    """One caller generating batches back to back through the one-shot
    sampler; each call's tokens are copied to the host before the next."""
    rec = Record("sampler", seconds, slots=traffic["batch"],
                 seq_len=traffic["seq_len"], recorder=recorder)
    run = system.sampler(cfg, params, device)
    shape = (traffic["batch"], traffic["seq_len"], cfg.hidden_size)
    gen = torch.Generator(device=torch.device(device))
    steps = traffic["num_steps"]

    # the call whose x the check reads, drawn before the window
    kept = int(np.random.default_rng(mix(seed, "kept")).integers(
        0, traffic["check_among"]))

    def call(stream, i, keep=False):
        s = mix(seed, stream, i)
        gen.manual_seed(s)
        a = time.time_ns()
        x = run(shape, gen, steps)
        tokens = system.decode_tokens(params, x).cpu()
        if keep:
            rec.kept = (i, x.cpu())
        rec.spans.append(("sampler.call", a, time.time_ns()))
        return s, tokens

    for i in range(traffic["warm_calls"]):
        call("warm", i)
        rec.warm_calls += 1
    _open_window(rec, None)
    deadline = rec.t0 + seconds
    while time.perf_counter() < deadline:
        s, tokens = call("measured", rec.calls, keep=rec.calls == kept)
        rec.outputs.append((rec.calls, s, tokens))
        rec.calls += 1
    _close_window(rec, None)
    return rec


LOOPS = {"backlog": backlog, "open": open_loop, "sampler": sampler_calls}
