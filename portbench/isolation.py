"""The benchmark's isolation from the JAX package.

Module names are compared whole by their top level (the part before the
first dot): the port's package name begins with the JAX package's, so a
prefix test would be wrong both ways.
"""

from __future__ import annotations

import ast
import pathlib
import sys

__all__ = ["FORBIDDEN", "PROGRAM", "loaded_forbidden", "scan_imports"]

#: Never imported by anything the benchmark runs.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")
#: The program under test: the plain references never import it.
PROGRAM = "repro_torch"


def _top(name: str) -> str:
    return name.split(".", 1)[0]


def loaded_forbidden(modules=None) -> list[str]:
    """Forbidden top-level names present in ``sys.modules``."""
    names = sys.modules if modules is None else modules
    return sorted({_top(n) for n in names} & set(FORBIDDEN))


def _imports(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(_top(a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(_top(node.module))
    return out


def scan_imports(root: pathlib.Path) -> list[str]:
    """Violations under ``root`` (the benchmark's folder): a file importing a
    forbidden package, or a file of ``reference/`` importing the program."""
    bad = []
    for path in sorted(root.rglob("*.py")):
        names = _imports(path)
        rel = path.relative_to(root).as_posix()
        for n in sorted(names & set(FORBIDDEN)):
            bad.append(f"{rel} imports {n}")
        if rel.startswith("reference/") and PROGRAM in names:
            bad.append(f"{rel} imports {PROGRAM}")
    return bad
