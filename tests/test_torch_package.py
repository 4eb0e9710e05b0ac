"""The PyTorch port stands apart from JAX: import rules, config JSON, build."""

import ast
import dataclasses
import importlib
import inspect
import json
import pathlib
import pkgutil

import jax  # noqa: F401  (both packages load in one process)
import numpy as np
import pytest
import torch

from diffusion_llm_rs_tpu import config as jcfg
from diffusion_llm_rs_tpu_torch import config as tcfg
from diffusion_llm_rs_tpu_torch.ops import _build
from diffusion_llm_rs_tpu_torch.ops import int8_matmul as tim
from diffusion_llm_rs_tpu_torch.ops.attention import (dense_attention,
                                                  fused_qkv_attention)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_SOURCES = sorted((ROOT / "diffusion_llm_rs_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "examples").glob("torch_*.py"))


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_SOURCES, ids=lambda p: p.name)
def test_port_imports_no_jax(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "diffusion_llm_rs_tpu"), \
            f"{path.relative_to(ROOT)} imports {mod}"


def test_port_sources_are_walked():
    names = {p.name for p in PORT_SOURCES}
    assert {"int8_matmul.py", "attention.py", "denoiser.py", "diffusion.py",
            "core.py", "config.py", "weights.py", "chip_smoke.py",
            "packed_matmul.py", "matmul.py", "engine.py", "serialization.py",
            "bpe.py", "kv_cache.py", "serving.py", "gptq.py",
            "calibrate.py", "__main__.py", "anns.py", "router.py",
            "dedup.py", "native.py", "types.py", "suffix_tree.py",
            "salience.py", "profiling.py", "sanitize.py", "graphs.py",
            "torch_serving_example.py", "torch_diffusion_example.py",
            "torch_quantization_basic.py", "torch_hello_workspace.py"} <= names


def test_new_modules_import_without_jax_loaded():
    """The engine and everything under it import in a process where
    neither JAX nor the JAX package can be imported at all."""
    import subprocess
    import sys
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', "
        "'diffusion_llm_rs_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import diffusion_llm_rs_tpu_torch.engine as e\n"
        "import diffusion_llm_rs_tpu_torch.ops.packed_matmul\n"
        "import diffusion_llm_rs_tpu_torch.utils.serialization\n"
        "import diffusion_llm_rs_tpu_torch.tokenizer.bpe\n"
        "import diffusion_llm_rs_tpu_torch.cache.kv_cache\n"
        "import diffusion_llm_rs_tpu_torch.quant.calibrate\n"
        "import diffusion_llm_rs_tpu_torch.__main__\n"
        "import diffusion_llm_rs_tpu_torch.models.types\n"
        "import diffusion_llm_rs_tpu_torch.utils.profiling\n"
        "import diffusion_llm_rs_tpu_torch.utils.sanitize\n"
        "import diffusion_llm_rs_tpu_torch.utils.graphs\n"
        "import diffusion_llm_rs_tpu_torch as pkg\n"
        "assert pkg.Engine is e.Engine and pkg.index and pkg.storage\n"
        "eng = e.Engine.from_pretrained(device='cpu')\n"
        "print(repr(eng.generate('the quick', max_length=2)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().startswith("'")


@pytest.mark.parametrize("cfg_kw", [
    {}, {"hidden_size": 128, "beta_schedule": "cosine", "dtype": "float32"}])
def test_config_json_loads_into_both_packages(cfg_kw):
    kw = dict(cfg_kw)
    if "beta_schedule" in kw:
        kw["beta_schedule"] = jcfg.BetaSchedule(kw["beta_schedule"])
    j = jcfg.DiffusionConfig(**kw)
    s = jcfg.to_json(j)
    t = tcfg.diffusion_config_from_json(s)
    assert json.loads(tcfg.to_json(t)) == json.loads(s)
    assert t.head_dim == j.head_dim
    back = jcfg.diffusion_config_from_json(tcfg.to_json(t))
    assert back == j
    tiny_j, tiny_t = jcfg.DiffusionConfig.tiny(), tcfg.DiffusionConfig.tiny()
    assert json.loads(jcfg.to_json(tiny_j)) == json.loads(tcfg.to_json(tiny_t))


def test_build_targets_follow_the_sources():
    for name in _build.SOURCES:
        src = _build.CSRC / f"{name}.cu"
        assert src.exists()
        target = _build._target(name)
        assert target.parent == _build.BUILD_DIR
        assert target.name.startswith(name + "-") and target.suffix == ".so"
    # every C entry point belongs to a built library
    assert {lib for lib, _ in _build.SIGNATURES.values()} == set(_build.SOURCES)


def test_wrappers_refuse_other_devices_and_bad_args():
    x = torch.zeros(4, 32, device="meta")
    w = torch.zeros(32, 16, dtype=torch.int8, device="meta")
    cs = torch.ones(1, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tim.int8w_matmul(x, w, cs)
    with pytest.raises(ValueError, match="unsupported device"):
        tim.int8w_mlp(x, w, cs, cs, w, cs, cs)
    with pytest.raises(ValueError, match="unsupported device"):
        tim.int8w_mlp_chained(x, w, cs, cs, w, cs, cs)
    with pytest.raises(ValueError, match="unsupported device"):
        dense_attention(x[None], x[None], x[None])
    with pytest.raises(ValueError, match="unsupported device"):
        fused_qkv_attention(torch.zeros(1, 8, 48, device="meta"), 2)
    with pytest.raises(ValueError, match="unknown activation"):
        tim.int8w_matmul(torch.zeros(4, 32), torch.zeros(32, 16, dtype=torch.int8),
                         torch.ones(1, 16), activation="relu")


def test_package_surface_matches_jax():
    """The top-level names, the lazy subpackages and `quant`'s re-exports
    of the JAX package, in the port."""
    import diffusion_llm_rs_tpu as jpkg
    import diffusion_llm_rs_tpu_torch as tpkg
    from diffusion_llm_rs_tpu import quant as jq
    assert tpkg.__all__ == jpkg.__all__
    for name in jpkg.__all__:
        assert getattr(tpkg, name).__name__.split(".")[-1] == \
            getattr(jpkg, name).__name__.split(".")[-1]
    for sub in ("models", "cache", "index", "router", "storage",
                "tokenizer", "ops", "utils"):
        assert getattr(tpkg, sub).__name__ == f"diffusion_llm_rs_tpu_torch.{sub}"
    with pytest.raises(AttributeError):
        tpkg.no_such_name
    assert tpkg.quant.__all__ == jq.__all__
    for name in jq.__all__:
        assert getattr(tpkg.quant, name) is not None
    # every public class of every JAX module has its public members (and
    # dataclass fields) in the port's counterpart, but for JAX's pytree hooks
    # (`tree_flatten`, `tree_unflatten`), which have none by design (as the
    # module-level `use_pallas` has none)
    missing = {}
    for info in pkgutil.walk_packages(jpkg.__path__, "diffusion_llm_rs_tpu."):
        rel = info.name.split(".", 1)[1]
        if rel in NO_PORT_MODULE:
            continue
        jmod = importlib.import_module(info.name)
        tmod = importlib.import_module(
            "diffusion_llm_rs_tpu_torch." + PORT_MODULE.get(rel, rel))
        for cname, cls in vars(jmod).items():
            if cname.startswith("_") or not inspect.isclass(cls) or \
                    cls.__module__ != info.name:
                continue
            tcls = getattr(tmod, cname, None)
            if tcls is None:
                missing[f"{rel}.{cname}"] = "class"
                continue
            gap = _members(cls) - _members(tcls) - PYTREE_HOOKS
            if gap:
                missing[f"{rel}.{cname}"] = sorted(gap)
    assert not missing, missing


# JAX modules whose counterpart has another name, and the one with none
PORT_MODULE = {"ops.pallas_attention": "ops.attention",
               "ops.pallas_matmul": "ops.int8_matmul",
               "ops.pallas_paged_attention": "ops.paged_attention"}
NO_PORT_MODULE = {"utils.platform"}  # every port entry point takes device=
PYTREE_HOOKS = {"tree_flatten", "tree_unflatten"}


def _members(cls):
    names = {n for n in dir(cls) if not n.startswith("_")}
    if dataclasses.is_dataclass(cls):
        names |= {f.name for f in dataclasses.fields(cls)}
    return names


def test_examples_imports_resolve_in_the_port():
    """What `examples/quantization_basic.py:19-21` and
    `hello_workspace.py:20-21` import from the JAX package."""
    from diffusion_llm_rs_tpu_torch import (DiffusionConfig, SystemConfig,
                                            quant)
    from diffusion_llm_rs_tpu_torch.cache.salience import SalienceEngine
    from diffusion_llm_rs_tpu_torch.engine import Engine
    from diffusion_llm_rs_tpu_torch.index.anns import FusionANNS
    x = torch.from_numpy(
        np.random.default_rng(0).normal(size=(64, 128)).astype(np.float32))
    qt = quant.quantize(x, 4, granularity="group", group_size=32)
    assert qt.compression_ratio() == 8.0
    assert SalienceEngine().calculate("a b a")["a"] == 2.0
    ann = FusionANNS(embedding_dim=128, device="cpu")
    ann.index_vectors([f"r{i}" for i in range(64)], x.numpy())
    assert ann.search(x[3].numpy(), 1)[0][0] == "r3"
    assert DiffusionConfig.tiny().hidden_size == 64
    assert SystemConfig().quantization_bits == (1, 2, 4, 8)
    assert Engine.__module__ == "diffusion_llm_rs_tpu_torch.engine"


@pytest.mark.parametrize("name", ["PrefillConfig", "SystemConfig"])
def test_prefill_and_system_config_json_match_jax(name):
    j, t = getattr(jcfg, name)(), getattr(tcfg, name)()
    jd, td = json.loads(jcfg.to_json(j)), json.loads(tcfg.to_json(t))
    if name == "SystemConfig":   # each package's own store file
        assert td.pop("ssd_path").endswith(
            "diffusion_llm_rs_tpu_torch_store.bin")
        jd.pop("ssd_path")
    assert td == jd
    back = getattr(tcfg, name)(**json.loads(jcfg.to_json(j)))
    assert json.loads(tcfg.to_json(back)) == json.loads(jcfg.to_json(j))
