"""The port stands alone: ``repro_torch`` imports neither JAX nor ``repro``.

A fresh interpreter imports the package and every submodule (and the
port's examples, ``examples/*_torch.py``) and then finds no ``jax`` and no
``repro`` module loaded; an AST scan of the sources (and of
``chip_smoke.py`` and the examples) finds no ``import jax``, ``import
repro`` or ``from repro`` (relative imports stay inside the package).  The
entry points run on the card unless the caller asks for the CPU.
"""

import ast
import importlib
import inspect
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
EXAMPLES = sorted((ROOT / "examples").glob("*_torch.py"))


def _modules() -> list[str]:
    mods = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_import_loads_no_jax_and_no_reference():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "import importlib.util\n"
        f"for p in {[str(p) for p in EXAMPLES]!r}:\n"
        "    spec = importlib.util.spec_from_file_location('ex', p)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'jaxlib' or m.startswith('jaxlib.') "
        "or m == 'repro' or m.startswith('repro.'))\n"
        "print(len(bad), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(ROOT / "src"),
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def _absolute_imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def test_sources_never_import_jax_or_reference():
    offenders = [
        f"{path.relative_to(ROOT)}:{line} imports {name}"
        for path in [*sorted(PKG.rglob("*.py")), ROOT / "chip_smoke.py",
                     *EXAMPLES]
        for line, name in _absolute_imports(path)
        if name.split(".")[0] in ("jax", "jaxlib", "repro")
    ]
    assert offenders == []
    assert len(_modules()) >= 20


def test_examples_are_covered_and_default_to_the_card():
    assert [p.name for p in EXAMPLES] == [
        "expand_cluster_torch.py", "quickstart_torch.py",
        "serve_lm_torch.py", "train_lm_torch.py"]
    for path in EXAMPLES:
        defaults = [
            kw.value.value
            for node in ast.walk(ast.parse(path.read_text()))
            if isinstance(node, ast.Call) and node.args
            and isinstance(node.args[0], ast.Constant)
            and node.args[0].value == "--device"
            for kw in node.keywords if kw.arg == "default"
        ]
        assert defaults == ["cuda"], path.name


def test_analysis_modules_are_covered():
    mods = set(_modules())
    for m in ("repro_torch.analysis.registry", "repro_torch.analysis.irlint",
              "repro_torch.analysis.retrace"):
        assert m in mods


def test_event_and_family_modules_are_covered():
    mods = set(_modules())
    for m in ("repro_torch.sim.events", "repro_torch.core.swdc",
              "repro_torch.core.degree_diameter", "repro_torch.core.placement"):
        assert m in mods


def test_fabric_bench_and_lint_modules_are_covered():
    mods = set(_modules())
    for m in ("repro_torch.fabric", "repro_torch.fabric.collectives",
              "repro_torch.fabric.embedding", "repro_torch.fabric.model",
              "repro_torch.obs.bench", "repro_torch.obs.__main__",
              "repro_torch.analysis.linter", "repro_torch.analysis.__main__"):
        assert m in mods


def test_model_stack_and_serve_modules_are_covered():
    mods = set(_modules())
    for m in ("repro_torch.configs", "repro_torch.configs.base",
              "repro_torch.configs.rwkv6_1_6b", "repro_torch.models",
              "repro_torch.models.layers", "repro_torch.models.attention",
              "repro_torch.models.moe", "repro_torch.models.rwkv6",
              "repro_torch.models.rglru", "repro_torch.models.frontends",
              "repro_torch.models.transformer", "repro_torch.launch",
              "repro_torch.launch.serve", "repro_torch.convert"):
        assert m in mods


def test_training_modules_are_covered():
    mods = set(_modules())
    for m in ("repro_torch.optim", "repro_torch.optim.adamw",
              "repro_torch.optim.compression", "repro_torch.optim.schedules",
              "repro_torch.data", "repro_torch.data.pipeline",
              "repro_torch.checkpoint", "repro_torch.checkpoint.manager",
              "repro_torch.checkpoint.codec", "repro_torch.runtime",
              "repro_torch.runtime.fault", "repro_torch.runtime.elastic",
              "repro_torch.launch.steps", "repro_torch.launch.train"):
        assert m in mods


def test_mesh_and_dryrun_modules_are_covered():
    mods = set(_modules())
    for m in ("repro_torch.launch.mesh", "repro_torch.launch.dryrun",
              "repro_torch.runtime.sharding", "repro_torch.roofline",
              "repro_torch.roofline.analysis", "repro_torch.roofline.op_stats",
              "repro_torch.roofline.report"):
        assert m in mods


@pytest.mark.parametrize("entry", [
    "repro_torch.launch.train:main",
    "repro_torch.launch.mesh:make_production_mesh",
    "repro_torch.launch.mesh:make_local_mesh",
    "repro_torch.launch.mesh:make_fabric_aware_mesh",
    "repro_torch.launch.mesh:world_size",
    "repro_torch.models.transformer:init_params",
    "repro_torch.models.transformer:init_cache",
    "repro_torch.models.transformer:LM",
    "repro_torch.convert:lm_params_from_numpy",
    "repro_torch.models.frontends:vit_stub_embeddings",
    "repro_torch.models.frontends:encodec_stub_embeddings",
    "repro_torch.fabric.embedding:embed_ring",
    "repro_torch.fabric.embedding:all_to_all_congestion",
    "repro_torch.fabric.model:make_fabric",
    "repro_torch.sim.events:simulate_events",
    "repro_torch.sim.workloads:run_tenant_churn",
    "repro_torch.sim.workloads:tenant_churn_segments",
    "repro_torch.sim.engine:simulate",
])
def test_entry_points_default_to_the_card(entry):
    mod, name = entry.split(":")
    module = importlib.import_module(mod)
    params = inspect.signature(getattr(module, name)).parameters
    if "device" in params:
        assert params["device"].default == "cuda"
    else:  # a command line: its --device flag
        assert module.parser().get_default("device") == "cuda"
