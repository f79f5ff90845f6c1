"""AST-based invariant linter of the port: the determinism rules in torch.

The port of ``repro/analysis/linter.py``, with the reference's rule ids,
each read for torch and scoped to ``repro_torch/`` paths (INVARIANTS.md is
the catalog):

JF001  No Python ``hash()`` / set-iteration in the port's routing, flow and
       MPTCP files and in ``sim/``.  ``hash()`` of str/bytes is randomized
       per process (PYTHONHASHSEED) and set iteration order is an
       implementation detail.  Membership tests and order-insensitive folds
       (len/min/max/sum/any/all) are fine; iterating, ``list()``-ing or
       ``.pop()``-ing a set is not unless it goes through ``sorted(...)``.
JF002  In the same modules, ``np.argsort`` must pass ``kind="stable"`` and
       ``torch.sort`` / ``torch.argsort`` must pass ``stable=True``: the
       default sorts are unstable, so equal keys come back in an arbitrary
       order (on CUDA, a launch-configuration-dependent one), which breaks
       the canonical tie order that delta == rebuild rests on.
JF003  ``os.environ`` reads of ``REPRO_*`` must go through the validated
       registry ``repro_torch/env.py``.
JF004  A kernel wrapper in ``kernels/`` that pads or copies operands
       (``F.pad``, ``.contiguous()``, ``.clone()``, ``.copy_()``,
       ``np.ascontiguousarray``) and calls a ``ctypes`` launch
       (``lib.<name>_launch``) must validate dtypes first, with a
       ``check_*dtype*`` helper: padding or copying a wrong-dtype operand
       fails far from the caller, or silently truncates.
JF005  A raw ``torch.sum`` / ``.sum(`` / ``torch.einsum`` in ``core/flow.py``,
       ``core/mptcp.py`` and ``sim/engine.py`` must use the positional
       ``_fold_sum`` halving tree (a padded axis must not change the sum).
       Any ``index_add(_)`` / ``scatter_add(_)`` in ``core/``, ``sim/`` and
       ``kernels/`` is flagged too: on CUDA they are atomics, whose order of
       addition is not fixed.
JF006  No ``torch.compile`` / ``torch.jit.script`` / ``torch.jit.trace``
       created inside a function body in the solver modules (``core/``,
       ``sim/``, ``kernels/``): a per-call wrapper recompiles every call.

A finding can be suppressed per line with ``# repro-lint: disable=JF00X``
(comma-separate to suppress several rules), with the reason after it.
Pragma ids are validated: an unknown id is itself a violation (JF000).  The
known ids are the reference's: the rules above and its IR rules
JF100-JF105, so a pragma here never trips the reference's own JF000.  Pure
stdlib (``ast``): ``python -m repro_torch.analysis`` needs no torch.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import os
import re
import tokenize

__all__ = ["KNOWN_RULE_IDS", "RULES", "Violation", "lint_file", "lint_paths",
           "lint_source"]

RULES = {
    "JF000": "repro-lint pragmas must name known rule ids",
    "JF001": "no hash()/set-iteration in routing/sim code paths",
    "JF002": "sorts must be stable in ordering modules",
    "JF003": "REPRO_* env reads must go through repro_torch.env",
    "JF004": "kernel wrappers must validate dtypes before padding or copying",
    "JF005": "solver reductions must use _fold_sum; no atomic scatter-adds",
    "JF006": "no torch.compile created inside a function body in solver modules",
}

#: The reference's IR-audit rule ids (``repro/analysis/registry.py``
#: ``IR_RULES``): valid pragma targets there, so valid here.
IR_RULE_IDS = ("JF100", "JF101", "JF102", "JF103", "JF104", "JF105")

KNOWN_RULE_IDS = frozenset(RULES) | frozenset(IR_RULE_IDS)

_PRAGMA_RE = re.compile(r"repro-lint:\s*disable=(\S+)")


@dataclasses.dataclass(frozen=True)
class Violation:
    rule: str
    path: str
    line: int
    col: int
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"


# --------------------------------------------------------------------------- #
# rule scoping (path matching on normalized separators)
# --------------------------------------------------------------------------- #

_PKG = "repro_torch/"
_ROUTING_SIM_FILES = (
    "repro_torch/core/routing.py",
    "repro_torch/core/flow.py",
    "repro_torch/core/mptcp.py",
)
_FOLD_SUM_FILES = (
    "repro_torch/core/flow.py",
    "repro_torch/core/mptcp.py",
    "repro_torch/sim/engine.py",
)
_SOLVER_DIRS = ("repro_torch/core/", "repro_torch/sim/",
                "repro_torch/kernels/")


def _norm(path: str) -> str:
    return path.replace(os.sep, "/")


def _in_port(path: str) -> bool:
    return _PKG in _norm(path)


def _in_routing_sim(path: str) -> bool:
    p = _norm(path)
    return p.endswith(_ROUTING_SIM_FILES) or "repro_torch/sim/" in p


def _in_fold_sum_scope(path: str) -> bool:
    return _norm(path).endswith(_FOLD_SUM_FILES)


def _in_kernels(path: str) -> bool:
    return "repro_torch/kernels/" in _norm(path)


def _in_solver(path: str) -> bool:
    p = _norm(path)
    return any(d in p for d in _SOLVER_DIRS)


def _is_env_registry(path: str) -> bool:
    return _norm(path).endswith("repro_torch/env.py")


# --------------------------------------------------------------------------- #
# AST helpers
# --------------------------------------------------------------------------- #


def _dotted(node: ast.AST) -> str:
    """Best-effort dotted name of a call target ('torch.sum', 'hash', ...)."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return f"{base}.{node.attr}" if base else node.attr
    return ""


def _method(node: ast.Call) -> str:
    """The attribute a call goes through (``x.sum(...)`` -> 'sum'), or ''."""
    return node.func.attr if isinstance(node.func, ast.Attribute) else ""


def _kwarg(node: ast.Call, name: str):
    return next((kw.value for kw in node.keywords if kw.arg == name), None)


def _is_set_expr(node: ast.AST, set_names: set[str]) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call) and _dotted(node.func) in ("set", "frozenset"):
        return True
    if isinstance(node, ast.Name) and node.id in set_names:
        return True
    return False


def _collect_set_names(tree: ast.AST) -> set[str]:
    """Names bound to set-producing expressions anywhere in the module
    (flow-insensitive, as in the reference)."""
    names: set[str] = set()
    for node in ast.walk(tree):
        value = None
        targets: list[ast.expr] = []
        if isinstance(node, ast.Assign):
            value, targets = node.value, node.targets
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            value, targets = node.value, [node.target]
        if value is None or not _is_set_expr(value, names):
            continue
        for t in targets:
            if isinstance(t, ast.Name):
                names.add(t.id)
    return names


_ORDER_SENSITIVE_CONSUMERS = ("list", "tuple", "enumerate", "iter")
_ORDER_SENSITIVE_ATTRS = ("array", "asarray", "fromiter", "join", "tensor",
                          "as_tensor")


# --------------------------------------------------------------------------- #
# per-rule checks
# --------------------------------------------------------------------------- #


def _check_jf001(tree: ast.AST, path: str, out: list[Violation]) -> None:
    set_names = _collect_set_names(tree)

    def iter_targets(node: ast.AST):
        if isinstance(node, ast.For):
            yield node.iter
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                               ast.GeneratorExp)):
            for gen in node.generators:
                yield gen.iter

    for node in ast.walk(tree):
        for it in iter_targets(node):
            if _is_set_expr(it, set_names):
                out.append(Violation(
                    "JF001", path, it.lineno, it.col_offset,
                    "iteration over a Python set: the order is hash/"
                    "insertion dependent; materialize with sorted(...)",
                ))
        if not isinstance(node, ast.Call):
            continue
        name = _dotted(node.func)
        if name == "hash":
            out.append(Violation(
                "JF001", path, node.lineno, node.col_offset,
                "Python hash() is process-seeded (PYTHONHASHSEED); use a "
                "deterministic mix like sim.ecmp.flow_hash",
            ))
        elif (name in _ORDER_SENSITIVE_CONSUMERS
              or name.rsplit(".", 1)[-1] in _ORDER_SENSITIVE_ATTRS):
            if node.args and _is_set_expr(node.args[0], set_names):
                out.append(Violation(
                    "JF001", path, node.lineno, node.col_offset,
                    f"{name}() over a Python set materializes hash/"
                    "insertion order; wrap the set in sorted(...) first",
                ))
        elif (_method(node) == "pop" and not node.args
              and _is_set_expr(node.func.value, set_names)):
            out.append(Violation(
                "JF001", path, node.lineno, node.col_offset,
                "set.pop() removes an arbitrary element; sets in routing/"
                "sim code must be consumed through sorted(...)",
            ))


def _check_jf002(tree: ast.AST, path: str, out: list[Violation]) -> None:
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = _dotted(node.func)
        if name in ("np.argsort", "numpy.argsort"):
            kind = _kwarg(node, "kind")
            if not (isinstance(kind, ast.Constant)
                    and kind.value in ("stable", "mergesort")):
                out.append(Violation(
                    "JF002", path, node.lineno, node.col_offset,
                    'np.argsort without kind="stable": equal keys come back '
                    "in an arbitrary introsort order, breaking canonical tie "
                    "ordering (delta == rebuild bit-exactness)",
                ))
        elif name in ("torch.sort", "torch.argsort"):
            stable = _kwarg(node, "stable")
            if not (isinstance(stable, ast.Constant) and stable.value is True):
                out.append(Violation(
                    "JF002", path, node.lineno, node.col_offset,
                    f"{name} without stable=True: equal keys come back in an "
                    "order that depends on the device and the launch, "
                    "breaking canonical tie ordering",
                ))


def _check_jf003(tree: ast.AST, path: str, out: list[Violation]) -> None:
    def is_os_environ(node: ast.AST) -> bool:
        return (isinstance(node, ast.Attribute) and node.attr == "environ"
                and isinstance(node.value, ast.Name)
                and node.value.id == "os")

    def repro_key(node: ast.AST) -> bool:
        return (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and node.value.startswith("REPRO_"))

    msg = ("read REPRO_* variables through repro_torch.env (env.read(...)), "
           "not {how}: the registry validates at import with an error "
           "naming the variable")
    for node in ast.walk(tree):
        if isinstance(node, ast.Subscript) and is_os_environ(node.value) \
                and repro_key(node.slice) \
                and isinstance(node.ctx, ast.Load):
            out.append(Violation("JF003", path, node.lineno, node.col_offset,
                                 msg.format(how="os.environ[...]")))
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        env_get = (isinstance(func, ast.Attribute) and func.attr == "get"
                   and is_os_environ(func.value))
        getenv = _dotted(func) == "os.getenv"
        if (env_get or getenv) and node.args and repro_key(node.args[0]):
            out.append(Violation("JF003", path, node.lineno, node.col_offset,
                                 msg.format(how="os.environ.get/os.getenv")))


_PAD_CALLS = ("F.pad", "torch.nn.functional.pad", "nn.functional.pad",
              "torch.constant_pad_nd", "np.pad", "np.ascontiguousarray",
              "numpy.ascontiguousarray")
_COPY_METHODS = ("contiguous", "clone", "copy_")


def _is_ctypes_launch(node: ast.AST) -> bool:
    """``lib.<name>_launch``: an exported C launch function of a kernel
    library (``_build.check_launch`` is the error check, not a launch)."""
    return (isinstance(node, ast.Attribute) and node.attr.endswith("_launch")
            and not node.attr.startswith("check"))


def _check_jf004(tree: ast.AST, path: str, out: list[Violation]) -> None:
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        copies: list[ast.Call] = []
        launches = False
        first_check_line = None
        for node in ast.walk(fn):
            if _is_ctypes_launch(node):
                launches = True
            if not isinstance(node, ast.Call):
                continue
            name = _dotted(node.func)
            leaf = name.rsplit(".", 1)[-1].lower()
            if name in _PAD_CALLS or _method(node) in _COPY_METHODS:
                copies.append(node)
            elif "check" in leaf and "dtype" in leaf:
                if first_check_line is None or node.lineno < first_check_line:
                    first_check_line = node.lineno
        if not (copies and launches):
            continue
        first = min(copies, key=lambda n: (n.lineno, n.col_offset))
        if first_check_line is None or first_check_line > first.lineno:
            out.append(Violation(
                "JF004", path, first.lineno, first.col_offset,
                f"kernel wrapper {fn.name}() pads or copies operands before "
                "any check_*dtype* validation; validate dtypes first "
                "(the check_minplus_dtype rule)",
            ))


_ATOMIC_ADDS = ("index_add", "index_add_", "scatter_add", "scatter_add_")


def _check_jf005_sums(tree: ast.AST, path: str, out: list[Violation]) -> None:
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        m = _method(node)
        if m == "sum":
            out.append(Violation(
                "JF005", path, node.lineno, node.col_offset,
                f"raw {_dotted(node.func) or '.sum'}() in a solver file: the "
                "association of a library sum depends on the (padded) axis "
                "size and the device; use the positional _fold_sum halving "
                "tree (padding-invariant)",
            ))
        elif m == "einsum":
            out.append(Violation(
                "JF005", path, node.lineno, node.col_offset,
                f"raw {_dotted(node.func)}() in a solver file: contraction "
                "order/association is size-dependent; use _fold_sum-based "
                "primitives for padded-axis reductions",
            ))


def _check_jf005_atomics(tree: ast.AST, path: str,
                         out: list[Violation]) -> None:
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and _method(node) in _ATOMIC_ADDS:
            out.append(Violation(
                "JF005", path, node.lineno, node.col_offset,
                f".{_method(node)}() is an atomic add on CUDA: the order of "
                "addition is not fixed, so float sums vary run to run; add "
                "in a fixed order (an ordered gather, _fold_sum, or one "
                "addend per target a round)",
            ))


def _check_jf006(tree: ast.AST, path: str, out: list[Violation]) -> None:
    compilers = ("torch.compile", "torch.jit.script", "torch.jit.trace")

    def is_compile(node: ast.AST) -> bool:
        if _dotted(node) in compilers:
            return True
        # functools.partial(torch.compile, ...)
        return (isinstance(node, ast.Call)
                and _dotted(node.func) in ("functools.partial", "partial")
                and bool(node.args)
                and _dotted(node.args[0]) in compilers)

    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.Lambda)):
            continue
        # everything below this point is INSIDE a function body
        for node in ast.walk(fn):
            if node is fn:
                continue
            hit = None
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for dec in node.decorator_list:
                    if is_compile(dec) or (isinstance(dec, ast.Call)
                                           and is_compile(dec.func)):
                        hit = dec
                        break
            elif isinstance(node, ast.Call) and is_compile(node.func):
                hit = node
            if hit is not None:
                out.append(Violation(
                    "JF006", path, hit.lineno, hit.col_offset,
                    "torch.compile created inside a function body compiles "
                    "afresh per call; hoist it to module level and pass "
                    "per-call values as arguments",
                ))


# --------------------------------------------------------------------------- #
# pragma parsing (JF000)
# --------------------------------------------------------------------------- #


def _pragma_ids(line: str) -> list[str]:
    """Rule ids a ``repro-lint: disable=...`` pragma on ``line`` names (the
    comma-separated token after ``disable=``; prose after whitespace is the
    reason and is ignored).  Empty when the line carries no pragma."""
    m = _PRAGMA_RE.search(line)
    if m is None:
        return []
    return [s for s in m.group(1).split(",") if s]


def _check_jf000(source: str, path: str, out: list[Violation]) -> None:
    """A pragma naming an unknown rule id is inert by construction; flag it.
    Only COMMENT tokens are pragmas (docstrings describing the syntax are
    prose)."""
    for tok in tokenize.generate_tokens(io.StringIO(source).readline):
        if tok.type != tokenize.COMMENT:
            continue
        for rid in _pragma_ids(tok.string):
            if rid not in KNOWN_RULE_IDS:
                out.append(Violation(
                    "JF000", path, tok.start[0], tok.start[1],
                    f"pragma names unknown rule id {rid!r}: the suppression "
                    "is silently inert; known ids are "
                    f"{', '.join(sorted(KNOWN_RULE_IDS))}",
                ))


# --------------------------------------------------------------------------- #
# entry points
# --------------------------------------------------------------------------- #


def lint_source(source: str, path: str) -> list[Violation]:
    """Lint one file's source text under the rules scoped to ``path``."""
    tree = ast.parse(source, filename=path)
    lines = source.splitlines()
    out: list[Violation] = []
    _check_jf000(source, path, out)
    if _in_routing_sim(path):
        _check_jf001(tree, path, out)
        _check_jf002(tree, path, out)
    if _in_port(path) and not _is_env_registry(path):
        _check_jf003(tree, path, out)
    if _in_kernels(path):
        _check_jf004(tree, path, out)
    if _in_fold_sum_scope(path):
        _check_jf005_sums(tree, path, out)
    if _in_solver(path):
        _check_jf005_atomics(tree, path, out)
        _check_jf006(tree, path, out)

    def suppressed(v: Violation) -> bool:
        if v.rule == "JF000":  # validation of the pragma itself
            return False
        if not (1 <= v.line <= len(lines)):
            return False
        return v.rule in _pragma_ids(lines[v.line - 1])

    return sorted(
        (v for v in out if not suppressed(v)),
        key=lambda v: (v.line, v.col, v.rule),
    )


def lint_file(path: str) -> list[Violation]:
    with open(path, "r", encoding="utf-8") as fh:
        return lint_source(fh.read(), path)


def lint_paths(paths: list[str]) -> list[Violation]:
    """Lint every ``.py`` file under the given files/directories."""
    files: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, names in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d not in ("__pycache__", ".git"))
                files.extend(os.path.join(root, n) for n in sorted(names)
                             if n.endswith(".py"))
        elif p.endswith(".py"):
            files.append(p)
    out: list[Violation] = []
    for f in files:
        out.extend(lint_file(f))
    return out
