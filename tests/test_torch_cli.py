"""The port's command line, ``python -m diffusion_llm_rs_tpu_torch <cmd>``,
on the CPU (`--device cpu`), beside the JAX package's (`tests/test_cli.py`).

Every command runs on the shipped pretrained anchor (6 layers, width 256).
Greedy `generate` must print JAX's text; a checkpoint written by the port's
`quantize` must load in JAX with the arrays JAX's own `quantize` writes.
"""

import json

import jax
import numpy as np
import pytest
import torch

from diffusion_llm_rs_tpu import config as jcfg_mod
from diffusion_llm_rs_tpu.__main__ import main as jmain
from diffusion_llm_rs_tpu.models import denoiser as jdn
from diffusion_llm_rs_tpu.utils import serialization as jser
from diffusion_llm_rs_tpu_torch.__main__ import main

CPU = ("--device", "cpu")


@pytest.fixture(autouse=True)
def one_thread():
    """Small tensors on the CPU: with the suite's six test processes on one
    machine, torch's thread pool costs each of them more than it gives."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run(capsys, *argv, cli=main):
    cli(list(argv))
    return capsys.readouterr().out


def test_generate_prints_jax_text(capsys):
    out = run(capsys, "generate", "--prompt", "the quick cat",
              "--max-length", "4", *CPU)
    want = run(capsys, "generate", "--prompt", "the quick cat",
               "--max-length", "4", cli=jmain)
    assert out.strip() and out == want


def test_ppl_json(capsys):
    rec = json.loads(run(capsys, "ppl", "--text", "cat runs near the river",
                         "--t", "10", *CPU))
    assert rec["perplexity"] > 0 and rec["t"] == 10 and rec["bits"] == 16


def test_ppl_quantized_is_finite(capsys):
    rec = json.loads(run(capsys, "ppl", "--text", "dog jumps over stone",
                         "--t", "10", "--bits", "8", *CPU))
    assert rec["perplexity"] > 0 and rec["bits"] == 8


def test_ingest_exits_naming_its_roadmap_item(tmp_path, capsys, monkeypatch):
    """`ingest` is ported since: it prints JAX's line, keys and counts.
    Each package's default store goes to the test's directory."""
    import functools
    import tempfile

    import diffusion_llm_rs_tpu.engine as jengine
    f = tmp_path / "corpus.txt"
    f.write_text("bird hunts near the forest then sleeps near the forest")
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setattr(jengine, "SystemConfig", functools.partial(
        jcfg_mod.SystemConfig, ssd_path=str(tmp_path / "jax_store.bin")))
    out = run(capsys, "ingest", "--file", str(f), *CPU)
    want = run(capsys, "ingest", "--file", str(f), cli=jmain)
    rec = json.loads(out)
    assert out == want and list(rec) == sorted(rec)
    assert rec["tokens"] > 0 and rec["stored"] > 0
    assert rec["indexed_vectors"] == rec["router_nodes"] == rec["tokens"]
    assert (tmp_path / "diffusion_llm_rs_tpu_torch_store.bin").read_bytes() \
        == (tmp_path / "jax_store.bin").read_bytes()


def test_serve(capsys):
    rec = json.loads(run(capsys, "serve", "--requests", "2", "--slots", "2",
                         "--seq-len", "16", "--steps", "3", "--page-size",
                         "16", *CPU))
    assert rec["requests"] == 2 and rec["tokens_per_sec"] > 0
    assert rec["gen_tokens"] == 2 * 16


def test_sample(capsys):
    out = run(capsys, "sample", "--bits", "4", "--batch", "2", "--seq-len",
              "32", "--steps", "4", *CPU)
    lines = out.splitlines()
    assert len(lines) == 2 and all(lines)


def _jax_leaves(stem):
    """A checkpoint's arrays as JAX's `load_checkpoint` reads them."""
    cfg = jcfg_mod.DiffusionConfig(**jser.get_metadata(stem)["config"])
    like = jdn.init_denoiser_params(jax.random.PRNGKey(0), cfg)
    return jax.tree_util.tree_leaves(jser.load_checkpoint(stem, like=like))


def test_quantize_save_loads_in_jax_with_jax_arrays(tmp_path, capsys):
    """int4 round to nearest, packed for the kernel: the port's file loads
    in JAX with every array equal to JAX's own file, the same param_bytes,
    and loads back through the port's --checkpoint. (`--quant-method gptq`
    runs in `chip_smoke.py`'s cli phase, on the card.)"""
    ours, theirs = str(tmp_path / "t4"), str(tmp_path / "j4")
    rec = json.loads(run(capsys, "quantize", "--bits", "4", "--out", ours,
                         *CPU))
    want = json.loads(run(capsys, "quantize", "--bits", "4", "--out", theirs,
                          cli=jmain))
    assert rec == {**want, "saved": ours} and rec["param_bytes"] > 0
    a, b = _jax_leaves(ours), _jax_leaves(theirs)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    rec = json.loads(run(capsys, "ppl", "--checkpoint", ours, "--text",
                         "cat runs near the river", "--t", "10", *CPU))
    assert rec["perplexity"] > 0 and rec["bits"] == 4


def test_unknown_command_exits():
    with pytest.raises(SystemExit):
        main(["not-a-command"])
    with pytest.raises(SystemExit):
        main(["quantize", *CPU])  # --bits is required
