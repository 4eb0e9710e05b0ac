"""What decides `correct`: the served tokens of a sample of the window's
requests against the plain reference.

Once the window has closed and the program's state is freed, a sample
drawn from the seed of the requests the program finished (the longest
always in it) runs again through the reference from the same f32 weights
and the same noise (`seeds`): the request's admission draw and its step
draws, its own timesteps and KV widths. Two numbers are compared:

- `served_logit_gap`: the widest gap by which a served token's logit lies
  below the reference's best, read at the reference's final embeddings
  (logits). It reads only where a served token differs from the
  reference's, so it is 0 on most requests of a sound run.
- `drift_err` (the sampler, whose call returns its final embeddings; the
  server returns tokens alone): the largest, over the sample, of the
  distance between the program's final embeddings and the reference's,
  over the distance the reference moved from the first draw. A state left
  unchanged by every step reads 1.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from bench_port.model import Dims, make_weights
from bench_port.reference import Reference, phase_bits, respaced
from bench_port.seeds import Draws, mix

LIMITS = Path(__file__).resolve().parent / "limits"


def limits(cell: str) -> dict:
    """The cell's limits (`limits/<cell>.json`), {} where there is none."""
    path = LIMITS / f"{cell}.json"
    if not path.exists():
        return {}
    return {k: v["limit"] for k, v in json.loads(path.read_text()).items()}


def sample_requests(rec, traffic: dict, seed: int) -> list:
    """The finished requests the check reads: the longest (by length,
    then steps) and `check_requests` - 1 more drawn from the seed."""
    done = sorted((q for q in rec.reqs.values()
                   if q.tokens is not None and q.wave >= 0),
                  key=lambda q: q.rid)
    if not done:
        return []
    longest = max(done, key=lambda q: (q.seq_len, q.num_steps))
    rest = [q for q in done if q is not longest]
    rng = np.random.default_rng(mix(seed, "check"))
    k = min(len(rest), traffic["check_requests"] - 1)
    pick = [rest[i] for i in sorted(rng.choice(len(rest), k, replace=False))]
    return [longest] + pick


def serving_chain(ref: Reference, d: Dims, traffic: dict, seed: int, q,
                  device):
    """The reference's (first draw, final embeddings), each [L, D], of
    request q."""
    draws = Draws(mix(seed, "noise"), device)
    shape = (traffic["slots"], traffic["seq_len"], d.hidden)
    L = q.seq_len

    def rows(z):
        return z[q.slot, :L][None]

    x0 = rows(draws.draw(("admission", q.wave), shape))
    n = q.num_steps
    x = ref.chain(x0, list(range(n - 1, -1, -1)),
                  lambda i: rows(draws.draw(("step", q.first_step + i),
                                            shape)),
                  kv_bits=lambda t: phase_bits(d, t, n))
    return x0[0], x[0]


def sampler_chain(ref: Reference, d: Dims, traffic: dict, call_seed: int,
                  device):
    """The reference's (first draw, final embeddings), each [B, S, D], of
    the call whose generator was seeded `call_seed`: x, then one draw a
    step, in order."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(call_seed)
    shape = (traffic["batch"], traffic["seq_len"], d.hidden)

    def draw():
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=device)
    x0 = draw()
    ts = respaced(d.num_timesteps, traffic["num_steps"])
    return x0, ref.chain(x0, ts, lambda i: draw())


def _drift_err(x, x0, ref_x) -> float:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x))
    x = x.to(ref_x.device)
    return float((x - ref_x).norm() / (ref_x - x0).norm())


def readings(rec, d: Dims, traffic: dict, seed: int, device,
             control: Optional[str] = None) -> dict:
    """The compared numbers of a run. With `control` a precision, also
    `control`: the same numbers for what the reference serves at that
    precision (the control, put in the program's place) over the same
    requests and noise."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    w = make_weights(d, seed, device)
    ref = Reference(d, w, device)
    ctl = Reference(d, w, device, control) if control else None
    del w
    gaps: List[float] = []
    drift: List[float] = []
    ctl_gaps: List[float] = []
    ctl_drift: List[float] = []

    def compare(x0, x, tokens, emb=None):
        """The program's numbers for one request or call (rows of x)."""
        for b in range(x.shape[0]):
            gaps.append(ref.token_gap(x[b], torch.as_tensor(
                np.asarray(tokens[b]))))
            if emb is not None:
                drift.append(_drift_err(emb[b], x0[b], x[b]))
        if ctl is not None:
            xc = chain(ctl)[1]
            for b in range(x.shape[0]):
                ctl_gaps.append(ref.token_gap(
                    x[b], ctl.logits(xc[b]).argmax(-1)))
                if emb is not None:
                    ctl_drift.append(_drift_err(xc[b], x0[b], x[b]))

    with torch.no_grad():
        if traffic["loop"] == "sampler":
            if rec.kept is not None:
                i, emb = rec.kept
                _, call_seed, tokens = rec.outputs[i]

                def chain(r):
                    return sampler_chain(r, d, traffic, call_seed, device)
                compare(*chain(ref), tokens, emb)
        else:
            for q in sample_requests(rec, traffic, seed):
                def chain(r):
                    x0, x = serving_chain(r, d, traffic, seed, q, device)
                    return x0[None], x[None]
                compare(*chain(ref), [q.tokens])
    out = {"served_logit_gap": max(gaps) if gaps else None}
    if drift:
        out["drift_err"] = max(drift)
    out["compared_tokens"] = _compared(rec, traffic, seed)
    if ctl is not None:
        out["control"] = {"served_logit_gap":
                          max(ctl_gaps) if ctl_gaps else None}
        if "drift_err" in out:
            out["control"]["drift_err"] = max(ctl_drift) if ctl_drift \
                else None
    return out


def _compared(rec, traffic, seed) -> int:
    if traffic["loop"] == "sampler":
        return traffic["batch"] * traffic["seq_len"] * (rec.kept is not None)
    return sum(q.seq_len for q in sample_requests(rec, traffic, seed))
