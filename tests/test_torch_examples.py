"""The PyTorch examples (`examples/torch_*.py`) against their JAX twins, on
the CPU.

Each torch example's `main(device="cpu")` runs and prints its JAX twin's
lines. Where both are deterministic they must print the same: the
quantization walkthrough's ratios, errors, calibration, salience, bit
allocation and ANN hits (the similarities within 1e-6, ROADMAP C34), the
hello pipeline's counts and stats, and the serving example's tokens when the
port serves JAX's weights (`from_jax_params`) from JAX's key chain
(`JaxNoise`). The diffusion example draws from `torch.Generator`s (by
design, ROADMAP C16, C27), so its numbers differ from JAX's; one of its Adam
steps from JAX's parameters, data, timesteps and noise is held against one
optax step instead. The sharded tier of the serving example runs its own 4
gloo processes. `pytest -rP` prints each measured difference.
"""

import ast
import importlib
import pathlib
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist import export

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _example(name):
    """The example module `name`, imported by name (the serving example's
    spawned ranks import it again)."""
    if str(ROOT / "examples") not in sys.path:
        sys.path.insert(0, str(ROOT / "examples"))
    return importlib.import_module(name)


def _lines(capsys, fn, *args, **kw):
    out = fn(*args, **kw)
    return out, capsys.readouterr().out.splitlines()


@pytest.fixture(autouse=True)
def one_thread():
    """Six test processes share the machine: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_quantization_basic_prints_jax_lines(capsys):
    _, want = _lines(capsys, _example("quantization_basic").main)
    _, got = _lines(capsys, _example("torch_quantization_basic").main,
                    device="cpu")
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        if not w.startswith("ANN top-3"):
            assert g == w
            continue
        gh, wh = (ast.literal_eval(s.split(": ", 1)[1]) for s in (g, w))
        assert [i for i, _ in gh] == [i for i, _ in wh]
        err = max(abs(a - b) for (_, a), (_, b) in zip(gh, wh))
        print(f"ANN hits {[i for i, _ in gh]}, similarities within {err:.3g}")
        assert err <= 1e-6
    print("\n".join(got))


def test_hello_workspace_prints_jax_lines(capsys):
    """The counts and stats are the JAX example's; the continuation and the
    sample come from other random weights (a `torch.Generator`'s), so only
    their form is the same."""
    _, want = _lines(capsys, _example("hello_workspace").main)
    out, got = _lines(capsys, _example("torch_hello_workspace").main,
                      device="cpu")
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        head = w.split(":", 1)[0]
        assert g.split(":", 1)[0] == head
        if head in ("process_model", "engine stats") or \
                w.startswith("prefilled"):
            assert g == w
    assert out["prefilled"] > 0 and out["stats"]["weight_bits"] == 16
    print("\n".join(got))


def test_diffusion_example_runs_and_prints_its_lines(capsys):
    samples, got = _lines(capsys, _example("torch_diffusion_example").main,
                          device="cpu")
    assert len(got) == 6
    losses = []
    for epoch, line in enumerate(got[:5]):
        m = re.fullmatch(rf"epoch {epoch}: loss (\d+\.\d{{4}})", line)
        assert m, line
        losses.append(float(m.group(1)))
    assert re.fullmatch(r"samples: \(8, 16\) mean -?\d+\.\d+(e-?\d+)?",
                        got[5]), got[5]
    assert samples.shape == (8, 16) and torch.isfinite(samples).all()
    assert all(0.5 < l < 1.5 for l in losses)
    print("\n".join(got))


def test_diffusion_example_adam_step_equals_optax():
    """One `train_step` of the torch example (torch.optim.Adam, lr 1e-2)
    from the same parameters, data, timesteps and noise as one optax.adam
    step of the JAX example: the loss and the updated parameters within
    1e-6."""
    import optax
    from diffusion_llm_rs_tpu.models import denoiser as jdn
    from diffusion_llm_rs_tpu.models import diffusion as jd
    from diffusion_llm_rs_tpu_torch.models import diffusion as td
    step = _example("torch_diffusion_example").train_step

    T, F, N = 100, 16, 512
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((F, F)) * 0.02).astype(np.float32)
    b = np.zeros((F,), np.float32)
    x0 = np.where(rng.random((N, 1)) < 0.5, 2.0, -2.0).astype(np.float32) + \
        0.1 * rng.standard_normal((N, F)).astype(np.float32)
    t = rng.integers(0, T, (N,))
    noise = rng.standard_normal((N, F)).astype(np.float32)

    js = jd.DiffusionSchedule.create(T, beta_start=1e-4, beta_end=0.02,
                                     schedule=jd.BetaSchedule.LINEAR)
    jp = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    opt = optax.adam(1e-2)

    def loss_fn(p):
        return jnp.mean(jd.p_losses(
            lambda x, tt: jdn.simple_denoiser_forward(p, x, tt), js,
            jnp.asarray(x0), jnp.asarray(t, jnp.int32),
            noise=jnp.asarray(noise)))
    jl, grads = jax.value_and_grad(loss_fn)(jp)
    updates, _ = opt.update(grads, opt.init(jp))
    jp = optax.apply_updates(jp, updates)

    ts = td.DiffusionSchedule.create(T, beta_start=1e-4, beta_end=0.02,
                                     schedule=td.BetaSchedule.LINEAR,
                                     device="cpu")
    tp = {"w": torch.from_numpy(w.copy()).requires_grad_(True),
          "b": torch.from_numpy(b.copy()).requires_grad_(True)}
    tl = step(tp, torch.optim.Adam(tp.values(), lr=1e-2), ts,
              torch.from_numpy(x0), torch.from_numpy(t),
              torch.from_numpy(noise))
    errs = {k: float(np.abs(tp[k].detach().numpy() - np.asarray(jp[k])).max())
            for k in ("w", "b")}
    print(f"loss jax {float(jl):.8g} port {tl:.8g}; params max |d| {errs}")
    assert abs(tl - float(jl)) <= 1e-6
    assert max(errs.values()) <= 1e-6


class JaxNoise:
    """Replays the JAX batcher's key chain: same draws, same order."""

    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed)

    def admission(self, shape):
        self.key, sub = jax.random.split(self.key)
        return torch.from_numpy(np.array(
            jax.random.normal(sub, shape, jnp.float32)))

    def step(self, shape):
        self.key, sub = jax.random.split(self.key)
        keys = jax.random.split(sub, shape[0])
        return torch.from_numpy(np.array(jax.vmap(
            lambda k: jax.random.normal(k, shape[1:], jnp.float32))(keys)))


def _masked(line):
    """A printed line with its latency and its EMA values taken out."""
    line = re.sub(r"\d+ ms$", "<ms>", line)
    return re.sub(r"\[[-0-9. e]+\]$", "<scores>", line)


def test_serving_example_prints_jax_lines_and_tokens(capsys):
    """Both examples on the CPU, the port on JAX's weights and key chain:
    tiers 1 and 2 give JAX's tokens exactly and its slot-0 EMA within
    2e-3 (printed at 3 decimals); tier 3 (JAX on 4 virtual devices, the
    port on 4 gloo processes, each drawing its own noise) the same
    requests, steps and token counts."""
    from diffusion_llm_rs_tpu import DiffusionConfig as JConfig
    from diffusion_llm_rs_tpu.models import denoiser as jdn
    from diffusion_llm_rs_tpu_torch.weights import from_jax_params
    jex = _example("serving_example")
    recorded = {}
    drive = jex.drive

    def recording(b, tag):
        recorded[tag] = drive(b, tag)
        return recorded[tag]
    jex.drive = recording
    _, want = _lines(capsys, jex.main)
    params = from_jax_params(export(jdn.init_denoiser_params(
        jax.random.PRNGKey(0), JConfig.tiny(vocab_size=256))), device="cpu")
    out, got = _lines(capsys, _example("torch_serving_example").main,
                      device="cpu", params=params, noise=JaxNoise)
    assert [_masked(l) for l in got] == [_masked(l) for l in want]
    assert len(got) == 17
    for tier, tag in (("phase", "phase-"), ("salient", "salient-")):
        jdone = {c.request_id: c for c in recorded[tag]}
        tdone = {c.request_id: c for c in out[tier]}
        assert sorted(jdone) == sorted(tdone) and len(tdone) == 4
        for rid, c in tdone.items():
            assert c.steps == jdone[rid].steps
            np.testing.assert_array_equal(c.tokens,
                                          np.asarray(jdone[rid].tokens))
    ema = np.array(re.search(r"\[(.*)\]$", want[11]).group(1).split(),
                   float)
    err = float(np.abs(out["page_scores"][0] - ema).max())
    print(f"tiers 1-2: tokens equal; slot-0 EMA {out['page_scores'][0]} vs "
          f"JAX's printed {ema} (max |d| {err:.3g})")
    assert err <= 2e-3
    assert sorted(c.request_id for c in out["sharded"]) == \
        sorted(c.request_id for c in recorded["sharded-"])
    print("\n".join(got))
