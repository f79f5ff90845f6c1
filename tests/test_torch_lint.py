"""The port's invariant linter (``python -m repro_torch.analysis``).

Every rule fires on a minimal bad fixture at a ``repro_torch/`` path, stays
silent on the corrected twin and is silenced by its pragma; the rules are
scoped (out-of-scope twins and reference paths stay silent); pragma ids are
validated (JF000) against the reference's own set, so a pragma in the port
never trips the reference linter; ``src/repro_torch`` lints clean under
both linters; the CLI's exit codes hold in a subprocess.
"""

import io
import os
import pathlib
import subprocess
import sys
import tokenize

import pytest

from repro.analysis import linter as ref_linter
from repro_torch.analysis import linter
from repro_torch.analysis.linter import RULES, lint_paths, lint_source

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

# (rule, path-the-snippet-pretends-to-live-at, bad source, good source)
_RULE_FIXTURES = [
    ("JF001", "src/repro_torch/core/routing.py",
     "order = hash((u, v))\n",
     "from .metrics import mix\norder = mix(u, v)\n"),
    ("JF001", "src/repro_torch/sim/events.py",
     "seen = {1, 2}\nfor e in seen:\n    go(e)\n",
     "seen = {1, 2}\nfor e in sorted(seen):\n    go(e)\n"),
    ("JF001", "src/repro_torch/core/flow.py",
     "edges = set()\nrows = torch.tensor(edges)\n",
     "edges = set()\nrows = torch.tensor(sorted(edges))\n"),
    ("JF002", "src/repro_torch/core/routing.py",
     "import numpy as np\norder = np.argsort(keys)\n",
     'import numpy as np\norder = np.argsort(keys, kind="stable")\n'),
    ("JF002", "src/repro_torch/sim/engine.py",
     "skey, perm = torch.sort(key, dim=1)\n",
     "skey, perm = torch.sort(key, dim=1, stable=True)\n"),
    ("JF002", "src/repro_torch/core/mptcp.py",
     "order = torch.argsort(x, stable=False)\n",
     "order = torch.argsort(x, stable=True)\n"),
    ("JF002", "src/repro_torch/models/moe.py",
     "order = torch.argsort(flat_expert, dim=1)\n",
     "order = torch.argsort(flat_expert, dim=1, stable=True)\n"),
    ("JF003", "src/repro_torch/core/anywhere.py",
     'import os\nv = int(os.environ.get("REPRO_FOO", "1"))\n',
     'from repro_torch import env\nv = env.read("REPRO_FOO")\n'),
    ("JF003", "src/repro_torch/kernels/ops.py",
     'import os\nv = os.environ["REPRO_TORCH_ADMISSION_BACKEND"]\n',
     'from .. import env\nv = env.read("REPRO_TORCH_ADMISSION_BACKEND")\n'),
    ("JF004", "src/repro_torch/kernels/newkernel.py",
     ("def run(a, b):\n"
      "    a = torch.nn.functional.pad(a, (0, 4))\n"
      "    return lib.new_launch(a.data_ptr(), b.data_ptr())\n"),
     ("def run(a, b):\n"
      "    a, b = check_new_dtype(a, b)\n"
      "    a = torch.nn.functional.pad(a, (0, 4))\n"
      "    return lib.new_launch(a.data_ptr(), b.data_ptr())\n")),
    ("JF004", "src/repro_torch/kernels/other.py",
     ("def run(a):\n"
      "    a = a.contiguous()\n"
      "    fn = lib.f64_launch if f64 else lib.f32_launch\n"
      "    _build.check_launch(fn(a.data_ptr()), 'k')\n"),
     ("def run(a):\n"
      "    a = check_run_dtype(a)\n"
      "    a = a.contiguous()\n"
      "    fn = lib.f64_launch if f64 else lib.f32_launch\n"
      "    _build.check_launch(fn(a.data_ptr()), 'k')\n")),
    ("JF005", "src/repro_torch/sim/engine.py",
     "total = torch.sum(loads, dim=1)\n",
     "total = _fold_sum(loads)\n"),
    ("JF005", "src/repro_torch/core/flow.py",
     "total = loads.sum(dim=-1)\n",
     "total = _fold_sum(loads)\n"),
    ("JF005", "src/repro_torch/core/mptcp.py",
     'y = torch.einsum("ps,p->s", inc, rates)\n',
     "y = _ordered_fan_in_sum(fr, table)\n"),
    ("JF005", "src/repro_torch/kernels/ops.py",
     "acc.index_add_(0, idx, vals)\n",
     "acc = acc + _fold_sum(torch.gather(vals, 0, table))\n"),
    ("JF005", "src/repro_torch/sim/events.py",
     "acc = acc.scatter_add(1, idx, vals)\n",
     "acc = _ordered_scatter_add(acc, idx, vals)\n"),
    ("JF005", "src/repro_torch/models/moe.py",
     "y.index_add_(1, token, contrib)\n",
     "y = contrib.reshape(b, s, k, d).sum(2)\n"),
    ("JF006", "src/repro_torch/core/flow.py",
     ("def make_step(n_steps):\n"
      "    @torch.compile\n"
      "    def step(x):\n"
      "        return x * n_steps\n"
      "    return step\n"),
     ("@torch.compile\n"
      "def step(x, n_steps):\n"
      "    return x * n_steps\n")),
    ("JF006", "src/repro_torch/models/transformer.py",
     "def prefill(model, batch):\n    return torch.compile(model.trunk)(batch)\n",
     "def prefill(model, batch):\n    return model.trunk(batch)\n"),
    ("JF006", "src/repro_torch/sim/engine.py",
     "def warm(cfg):\n    return torch.jit.script(lambda x: x * cfg.dt)\n",
     "@torch.jit.script\ndef warm_step(x, dt: float):\n    return x * dt\n"),
    ("JF000", "src/repro_torch/core/flow.py",
     "x = 1  # repro-lint: disable=JF999\n",
     "x = 1  # repro-lint: disable=JF005\n"),
    ("JF000", "src/repro_torch/sim/engine.py",
     "y = 2  # repro-lint: disable=JF005,JF01\n",
     "y = 2  # repro-lint: disable=JF005,JF104\n"),
]

_IDS = [f"{r}-{i}" for i, (r, *_) in enumerate(_RULE_FIXTURES)]


@pytest.mark.parametrize("rule,path,bad,good", _RULE_FIXTURES, ids=_IDS)
def test_rule_fires_and_silences(rule, path, bad, good):
    fired = lint_source(bad, path)
    assert [v.rule for v in fired] == [rule]
    assert fired[0].line >= 1 and len(fired[0].message) > 20
    assert lint_source(good, path) == []


@pytest.mark.parametrize("rule,path,bad,good", _RULE_FIXTURES, ids=_IDS)
def test_pragma_silences_each_rule(rule, path, bad, good):
    fired = lint_source(bad, path)
    if rule == "JF000":
        # JF000 validates the pragma itself: nothing suppresses it
        src = bad.replace("\n", ",JF000  reason\n", 1)
        assert [v.rule for v in lint_source(src, path)] == ["JF000"]
        return
    lines = bad.splitlines()
    n = fired[0].line - 1
    lines[n] += f"  # repro-lint: disable={rule} the reason goes here"
    assert lint_source("\n".join(lines) + "\n", path) == []
    # the reference linter accepts the same pragma id
    assert rule in ref_linter.KNOWN_RULE_IDS


def test_every_rule_has_a_fixture():
    assert {r for r, *_ in _RULE_FIXTURES} == set(RULES)
    # the rule ids are the reference's: no new id is minted
    assert set(RULES) == set(ref_linter.RULES)
    assert linter.KNOWN_RULE_IDS == ref_linter.KNOWN_RULE_IDS


def test_rules_are_scoped():
    # JF001/JF002 bind only in routing/flow/mptcp and sim/; JF005's sums
    # only in the fold-sum files; JF004 only in kernels/; JF006 and the
    # atomics only in the solver directories
    assert lint_source("x = hash(y)\n", "src/repro_torch/core/topology.py") == []
    assert lint_source("import numpy as np\no = np.argsort(k)\n",
                       "src/repro_torch/core/metrics.py") == []
    assert lint_source("s, p = torch.sort(k)\n",
                       "src/repro_torch/kernels/ops.py") == []
    assert lint_source("y = torch.sum(x)\n",
                       "src/repro_torch/core/routing.py") == []
    assert lint_source("acc.index_add_(0, i, v)\n",
                       "src/repro_torch/obs/metrics.py") == []
    assert lint_source(
        "def f(a):\n    a = a.contiguous()\n    lib.x_launch(a)\n",
        "src/repro_torch/core/flow.py") == []
    assert lint_source("def main():\n    f = torch.compile(g)\n",
                       "src/repro_torch/capacity.py") == []
    # the registry itself reads the environment
    assert lint_source('import os\nv = os.environ.get("REPRO_TRACE")\n',
                       "src/repro_torch/env.py") == []
    # reference paths belong to the reference's linter, not this one
    for rule, path, bad, _ in _RULE_FIXTURES:
        if rule != "JF000":
            ref_path = path.replace("repro_torch/", "repro/")
            assert lint_source(bad, ref_path) == [], (rule, ref_path)


def test_pragma_with_unknown_id_does_not_suppress():
    src = ('import numpy as np\n'
           'o = np.argsort(k)  # repro-lint: disable=JF02\n')
    rules = sorted(v.rule for v in lint_source(
        src, "src/repro_torch/core/routing.py"))
    assert rules == ["JF000", "JF002"]
    src = "x = 1  # repro-lint: disable=JF999,JF000\n"
    assert [v.rule for v in lint_source(
        src, "src/repro_torch/core/flow.py")] == ["JF000"]
    # docstrings that describe the pragma are prose, not suppressions
    assert lint_source('"""write # repro-lint: disable=JF9 here"""\n',
                       "src/repro_torch/core/flow.py") == []


def _pragmas(path: pathlib.Path):
    src = path.read_text()
    for tok in tokenize.generate_tokens(io.StringIO(src).readline):
        if tok.type == tokenize.COMMENT and "repro-lint" in tok.string:
            yield tok.start[0], tok.string


def test_port_lints_clean_under_both_linters():
    assert lint_paths([str(PORT)]) == []
    assert ref_linter.lint_paths([str(PORT)]) == []
    # every pragma in the port names a rule and gives its reason
    found = 0
    for path in sorted(PORT.rglob("*.py")):
        for line, text in _pragmas(path):
            found += 1
            ids = linter._pragma_ids(text)
            assert ids and set(ids) <= ref_linter.KNOWN_RULE_IDS, (path, line)
            reason = text.split("disable=", 1)[1].split(None, 1)
            assert len(reason) == 2 and reason[1].strip(), (path, line)
    assert found >= 1


def test_cli_exit_codes(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}

    def run(*args, cwd=tmp_path):
        return subprocess.run(
            [sys.executable, "-m", "repro_torch.analysis", *args],
            capture_output=True, text=True, env=env, cwd=str(cwd),
            timeout=120)

    bad = tmp_path / "src" / "repro_torch" / "core" / "routing.py"
    bad.parent.mkdir(parents=True)
    bad.write_text("import numpy as np\norder = np.argsort(keys)\n")
    out = run(str(tmp_path))
    assert out.returncode == 1
    assert "JF002" in out.stdout and "1 violation(s)" in out.stderr
    # the default path is src/repro_torch below the working directory
    assert run().returncode == 1
    assert run(str(PORT)).returncode == 0
    assert run(cwd=ROOT).returncode == 0
