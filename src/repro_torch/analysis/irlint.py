"""Dispatch-level auditor: the op-level rules the AST linter cannot see.

The port of ``repro/analysis/irlint.py``.  The bit-exactness contracts
(INVARIANTS.md) are properties of the ops that run, not of the Python
source: an AST-clean refactor can still reach a size-dependent float
``aten.sum`` (a ``.sum()`` method call), an atomic scatter-add under the
gather backend, a silent float64 upcast, or a host read inside a solver
loop.  The reference reads jaxprs; the port has none, so this pass RUNS
every registered entry (``repro_torch.analysis.registry``) once on each of
its tiny seeded cases under a ``TorchDispatchMode`` (``roofline.op_stats
.OpCounter``, extended to keep one record per aten op) and checks:

JF100  Registration (stdlib AST): every module-level function in the
       solver directories that calls a kernel wrapper (``ops.congestion``,
       ``ops.congestion_loads``, ``ops.minplus``, ``ops.matmul``,
       ``admission``, ``minplus_hops``) or takes a ``fused`` / ``loads_of``
       congestion callable is registered with ``@solver_entry`` (in a
       module of ``registry.SOLVER_MODULES``) or carries a ``JF100`` pragma
       on its ``def`` line with the reason; and every reference entry in
       ``registry.REFERENCE_ENTRIES`` maps to a registered port entry (or
       records why the port folded it).
JF101  No float contraction in a case that is not exempt: float
       ``aten.sum`` / ``mean`` / ``mm`` / ``bmm`` / ``mv`` / ``addmm`` /
       ``dot`` / ``_softmax`` / ``logsumexp`` / ``cumsum`` /
       ``linalg_vector_norm`` and their kin.  Padded-axis sums go through
       the ``_fold_sum`` positional halving tree (checked structurally by
       :func:`audit_fold_tree`) or the ordered fan-in tables.  ``amax`` /
       ``amin`` / ``max`` / ``min`` and integer or bool sums are exact in
       any order and pass.  Dense-backend cases exempt themselves, with
       the reason recorded.
JF102  No accumulating scatter in a ``gather`` case: ``scatter_add``,
       ``scatter_reduce`` with sum or mean, ``scatter`` with ``reduce=
       "add"``, ``index_add``, ``index_put`` with ``accumulate=True``.  On
       CUDA these are atomics, whose order of addition is not fixed.
JF103  No float64 or complex tensor anywhere in a case.  int64 is torch's
       index type and passes: a stated divergence from the reference,
       which bans 64-bit integers too.
JF104  No host-sync op anywhere in a ``solver`` entry's case (the
       registered function is the loop body): ``_local_scalar_dense``
       (``.item()``, ``int()``, ``float()``, ``bool()`` of a tensor),
       ``nonzero``, ``masked_select``, boolean-mask indexing, ``unique``,
       ``equal``, ``repeat_interleave`` with tensor repeats and no
       ``output_size``, and a copy from the device to the CPU.
JF105  Footprint budgets: each budgeted case's aten op count, FLOPs and
       bytes (``OpCounter``), run on the CPU, against the checked-in
       ``artifacts/ir_budget_torch.json``; growth beyond tolerance fails
       with a diff.  Regenerate deliberately with ``--write-budget``.  On a
       card the kernels replace the plain versions and the counts differ,
       so JF105 runs on the CPU only.

The hand-written kernels launch through ``ctypes``, which the dispatcher
never sees; each case therefore also records the deltas of the kernels'
launch counters (``kernels.launch_counts()``), the auditor's only evidence
that a case on a card reached its kernel.  On CUDA an entry's aten op count
is close to its number of launches.

CLI: ``python -m repro_torch.analysis ir [paths...] [--device cuda|cpu]
[--budget FILE] [--write-budget] [--no-budget] [--diff-out FILE]``.  The
device defaults to ``cuda``, as every entry point of the port does.
"""

from __future__ import annotations

import ast
import dataclasses
import importlib.util
import json
import os
import sys

import torch

from ..roofline.op_stats import OpCounter, OpStats
from .linter import _dotted, _pragma_ids
from .registry import (
    FOLDED_REASONS,
    IR_RULES,
    REFERENCE_ENTRIES,
    SOLVER_MODULES,
    AuditCase,
    SolverEntry,
    registered_entries,
)

__all__ = [
    "IR_RULES",
    "CaseTrace",
    "IRFinding",
    "OpRecord",
    "audit_case",
    "audit_entries",
    "audit_fold_tree",
    "check_reference_map",
    "check_registration",
    "compare_budget",
    "main_ir",
    "measure_case",
    "run_audit",
    "select_entries",
    "trace_case",
    "trace_fn",
]


@dataclasses.dataclass(frozen=True)
class IRFinding:
    rule: str
    entry: str  # dotted entry name (or file path for JF100)
    case: str  # AuditCase label; "-" for findings outside a case
    message: str

    def __str__(self) -> str:
        return f"{self.entry}[{self.case}]: {self.rule} {self.message}"


# --------------------------------------------------------------------------- #
# the dispatch-level trace
# --------------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class OpRecord:
    """One aten op as it ran: its name (``"sum.dim_IntList"``), packet
    (``"sum"``, a trailing in-place ``_`` dropped), the dtypes, shapes and
    device types of its tensor inputs and outputs, and the keyword-like
    detail the rules read (``reduce``, ``accumulate``, ``output_size``,
    ``bool_index``)."""

    name: str
    packet: str
    in_dtypes: tuple
    in_shapes: tuple
    in_devices: tuple
    out_dtypes: tuple
    out_shapes: tuple
    out_devices: tuple
    detail: tuple = ()

    def get(self, key: str, default=None):
        return dict(self.detail).get(key, default)


def _flat_tensors(xs):
    for x in xs:
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, (list, tuple)):
            yield from _flat_tensors(x)


def _packet(name: str) -> str:
    """``"scatter_add_.default"`` -> ``"scatter_add"``."""
    return name.split(".")[0].rstrip("_")


def _detail(func, args, kwargs) -> tuple:
    packet = _packet(func.__name__)
    out = []
    if packet in ("scatter_reduce", "scatter"):
        red = kwargs.get("reduce")
        if red is None:
            red = next((a for a in args[3:] if isinstance(a, str)), None)
        if red is not None:
            out.append(("reduce", red))
    elif packet in ("index_put", "_index_put_impl"):
        acc = kwargs.get("accumulate")
        if acc is None:
            acc = next((a for a in args[3:] if isinstance(a, bool)), False)
        out.append(("accumulate", bool(acc)))
    if packet in ("index", "index_put", "_index_put_impl"):
        idx = args[1] if len(args) > 1 else kwargs.get("indices", ())
        out.append(("bool_index", any(
            t is not None and t.dtype in (torch.bool, torch.uint8)
            for t in _flat_tensors(idx or ()))))
    if packet == "repeat_interleave":
        out.append(("output_size", kwargs.get("output_size")))
    return tuple(out)


class _AuditMode(OpCounter):
    """``OpCounter`` (FLOPs, bytes, tensor-making ops) that also keeps one
    :class:`OpRecord` per aten op, including ops that make no tensor (the
    host reads)."""

    def __init__(self):
        super().__init__()
        self.records: list[OpRecord] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is NotImplemented:
            return out
        ins = list(_flat_tensors(list(args) + list(kwargs.values())))
        outs = list(_flat_tensors([out]))
        name = func.__name__
        self.records.append(OpRecord(
            name=name,
            packet=_packet(name),
            in_dtypes=tuple(t.dtype for t in ins),
            in_shapes=tuple(tuple(t.shape) for t in ins),
            in_devices=tuple(t.device.type for t in ins),
            out_dtypes=tuple(t.dtype for t in outs),
            out_shapes=tuple(tuple(t.shape) for t in outs),
            out_devices=tuple(t.device.type for t in outs),
            detail=_detail(func, args, kwargs),
        ))
        return out


@dataclasses.dataclass
class CaseTrace:
    """What one run of a case dispatched: the op records, the kernels'
    launch-counter deltas and the ``OpCounter`` statistics."""

    records: list
    launches: dict
    stats: OpStats

    @property
    def aten_ops(self) -> int:
        return len(self.records)


def trace_fn(fn, *args, **kwargs) -> CaseTrace:
    """Run ``fn(*args, **kwargs)`` once under the audit mode."""
    from ..kernels import launch_counts

    before = launch_counts()
    mode = _AuditMode()
    with mode:
        out = fn(*args, **kwargs)
    for t in _flat_tensors([out]):
        if t.device.type == "cuda":  # surface an asynchronous launch error
            torch.cuda.synchronize(t.device)
            break
    after = launch_counts()
    return CaseTrace(mode.records,
                     {k: after[k] - before[k] for k in after}, mode.stats)


def trace_case(entry: SolverEntry, case: AuditCase,
               device="cpu") -> CaseTrace:
    """Run the entry once on the case's arguments, built on ``device``."""
    args, kwargs = case.make(torch.device(device))
    return trace_fn(entry.resolve(), *args, **kwargs)


# --------------------------------------------------------------------------- #
# per-case rules: JF101-JF104
# --------------------------------------------------------------------------- #

#: float reductions whose association the library picks by size
_CONTRACTIONS = frozenset((
    "sum", "nansum", "mean", "mm", "bmm", "mv", "addmm", "addmv", "addbmm",
    "baddbmm", "dot", "vdot", "_softmax", "_log_softmax", "logsumexp",
    "cumsum", "linalg_vector_norm", "norm",
))
_SCATTER_ADDS = frozenset(("scatter_add", "index_add"))
_WIDE = (torch.float64, torch.complex32, torch.complex64, torch.complex128)
_SYNC_OPS = frozenset((
    "_local_scalar_dense", "nonzero", "nonzero_static", "masked_select",
    "_unique", "_unique2", "unique_dim", "unique_consecutive",
    "unique_dim_consecutive", "equal", "is_nonzero",
))


def _is_float(dtype) -> bool:
    return dtype.is_floating_point or dtype.is_complex


def _host_sync(rec: OpRecord) -> str | None:
    """Why ``rec`` waits for the device on a card, or None."""
    if rec.packet in _SYNC_OPS:
        return rec.packet
    if rec.packet == "repeat_interleave" and rec.name.endswith(".Tensor") \
            and rec.get("output_size") is None:
        return "repeat_interleave with tensor repeats and no output_size"
    if rec.packet in ("index", "index_put", "_index_put_impl") \
            and rec.get("bool_index"):
        return f"{rec.packet} with a boolean mask"
    if rec.packet == "_to_copy" and rec.out_devices:  # x.to(device)
        src, dst = rec.in_devices[0], rec.out_devices[0]
    elif rec.packet == "copy" and len(rec.in_devices) >= 2:  # dst.copy_(src)
        dst, src = rec.in_devices[0], rec.in_devices[1]
    else:
        return None
    if dst == "cpu" and src != "cpu":
        return f"copy from {src} to the CPU"
    return None


def audit_case(entry: SolverEntry, case: AuditCase,
               trace: CaseTrace | None = None,
               device="cpu") -> list[IRFinding]:
    """Run JF101-JF104 on one entry/case trace (rules the case exempts,
    with their recorded reason, are skipped)."""
    if trace is None:
        trace = trace_case(entry, case, device)
    out: list[IRFinding] = []

    def finding(rule: str, msg: str) -> None:
        out.append(IRFinding(rule, entry.name, case.label, msg))

    run101 = "JF101" not in case.exempt
    run102 = case.backend == "gather" and "JF102" not in case.exempt
    run103 = "JF103" not in case.exempt
    run104 = entry.kind == "solver" and "JF104" not in case.exempt
    for rec in trace.records:
        p = rec.packet
        if run101 and p in _CONTRACTIONS and rec.out_dtypes \
                and _is_float(rec.out_dtypes[0]):
            shape = rec.in_shapes[0] if rec.in_shapes else ()
            finding(
                "JF101",
                f"float aten.{rec.name} over {shape}: the library picks the "
                "association by size, so the result depends on the padding "
                "envelope; route the reduction through _fold_sum / "
                "_ordered_fan_in_sum (only the dense backend may contract, "
                "and its cases record the exemption)",
            )
        elif run102 and (p in _SCATTER_ADDS
                         or (p == "scatter_reduce"
                             and rec.get("reduce") in ("sum", "mean"))
                         or (p == "scatter" and rec.get("reduce") == "add")
                         or (p in ("index_put", "_index_put_impl")
                             and rec.get("accumulate"))):
            finding(
                "JF102",
                f"aten.{rec.name} under the gather backend: on CUDA it is an "
                "atomic whose order of addition is not fixed; accumulate "
                "through _ordered_fan_in_sum instead",
            )
        if run103:
            wide = [d for d in rec.in_dtypes + rec.out_dtypes if d in _WIDE]
            if wide:
                finding(
                    "JF103",
                    f"aten.{rec.name} touches {wide[0]}: solver arithmetic is "
                    "float32 with int32/int64 indices; look for a float64 "
                    "numpy array or dtype reaching the device",
                )
        if run104:
            why = _host_sync(rec)
            if why is not None:
                finding(
                    "JF104",
                    f"aten.{rec.name} ({why}) in a solver loop body: on a "
                    "card the host waits for every queued launch, each "
                    "time it runs",
                )
    return out


# --------------------------------------------------------------------------- #
# fold-tree structure (the JF101 companion: the sanctioned reduction is
# itself checked to be a balanced positional halving)
# --------------------------------------------------------------------------- #

#: the fold tree's own ops: the zero pad to a power of two, the halves, their
#: sums and the final element
_FOLD_OPS = frozenset(("constant_pad_nd", "slice", "add", "select"))


def audit_fold_tree(sizes: tuple[int, ...] = (5, 8, 13)) -> list[IRFinding]:
    """Check that ``core.flow._fold_sum`` runs as a balanced halving tree.

    For input width ``n`` (padded to ``pow2``): only zero padding, slices,
    adds and the final element select, and exactly ``log2(pow2)`` float
    adds whose widths halve ``pow2/2, pow2/4, ..., 1`` with equal-shape
    operands: the positional grouping that makes the sum
    padding-invariant.  Swapping the body for a ``torch.sum`` (or any
    unbalanced chain) is caught here.
    """
    from ..core import flow

    out: list[IRFinding] = []
    name = "repro_torch.core.flow._fold_sum"
    for n in sizes:
        x = torch.linspace(0.5, 1.5, n, dtype=torch.float32)
        trace = trace_fn(flow._fold_sum, x)
        pow2 = 1 << (n - 1).bit_length() if n > 1 else 1
        want = [pow2 >> k for k in range(1, pow2.bit_length())]
        got, balanced = [], True
        for rec in trace.records:
            if rec.packet not in _FOLD_OPS:
                out.append(IRFinding(
                    "JF101", name, f"n={n}",
                    f"aten.{rec.name} inside the fold tree: the halving must "
                    "be positional slice + add, not a library reduction",
                ))
            elif rec.packet == "add" and rec.out_dtypes \
                    and _is_float(rec.out_dtypes[0]):
                shape = rec.out_shapes[0]
                got.append(shape[-1] if shape else 1)
                balanced &= len(rec.in_shapes) == 2 and \
                    rec.in_shapes[0] == rec.in_shapes[1]
        if got != want or not balanced:
            out.append(IRFinding(
                "JF101", name, f"n={n}",
                f"fold tree is not a balanced positional halving: add widths "
                f"{got} != expected {want} (padding-invariance holds only "
                "for the equal-halves grouping)",
            ))
    return out


# --------------------------------------------------------------------------- #
# JF100: registration (stdlib AST, no run)
# --------------------------------------------------------------------------- #

_SOLVER_DIR_PARTS = ("repro_torch/core/", "repro_torch/sim/",
                     "repro_torch/kernels/")
#: calls of the kernel wrappers, as the solver modules and ``ops.py`` spell
#: them (``ops.py`` binds the kernel modules' wrappers to private names)
_KERNEL_CALLS = frozenset((
    "ops.congestion", "ops.congestion_loads", "ops.minplus", "ops.matmul",
    "ops.minplus_hops", "admission", "minplus_hops", "_congestion",
    "_minplus", "_minplus_hops", "_matmul", "fan_in_loads",
))
#: parameters through which a function receives a congestion callable
_CALLABLE_PARAMS = frozenset(("fused", "loads_of"))


def _is_entry_decorator(node: ast.AST) -> bool:
    target = node.func if isinstance(node, ast.Call) else node
    return _dotted(target).split(".")[-1] == "solver_entry"


def kernel_callers(source: str, path: str) -> list[tuple[str, int, str]]:
    """``(name, lineno, why)`` of every module-level function of a file that
    reaches a kernel wrapper (a call anywhere in its body, nested closures
    included) or takes a congestion callable, or is decorated with
    ``@solver_entry``."""
    tree = ast.parse(source, filename=path)
    out: list[tuple[str, int, str]] = []
    for node in tree.body:
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        params = {a.arg for a in node.args.args + node.args.kwonlyargs
                  + node.args.posonlyargs}
        calls = sorted({_dotted(c.func) for c in ast.walk(node)
                        if isinstance(c, ast.Call)} & _KERNEL_CALLS)
        if calls:
            why = f"calls {', '.join(calls)}"
        elif params & _CALLABLE_PARAMS:
            why = f"takes {', '.join(sorted(params & _CALLABLE_PARAMS))}"
        elif any(_is_entry_decorator(d) for d in node.decorator_list):
            why = "is decorated with @solver_entry"
        else:
            continue
        out.append((node.name, node.lineno, why))
    return out


def _module_name(path: str) -> str | None:
    parts = os.path.normpath(path).replace(os.sep, "/").split("/")
    if "repro_torch" not in parts or not parts[-1].endswith(".py"):
        return None
    rel = parts[len(parts) - 1 - parts[::-1].index("repro_torch"):]
    return ".".join(rel)[: -len(".py")]


def _py_files(paths: list[str]) -> list[str]:
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
    return files


def check_registration(
    paths: list[str], entries: dict[str, SolverEntry] | None = None
) -> list[IRFinding]:
    """JF100 over every solver-directory file under ``paths``, and over the
    registered entries' modules."""
    if entries is None:
        entries = registered_entries()
    out: list[IRFinding] = []
    for name, e in entries.items():
        if e.module not in SOLVER_MODULES:
            out.append(IRFinding(
                "JF100", name, "-",
                f"registered in {e.module}, a module missing from "
                "registry.SOLVER_MODULES",
            ))
    for f in _py_files(paths):
        norm = os.path.normpath(f).replace(os.sep, "/")
        if not any(d in norm for d in _SOLVER_DIR_PARTS):
            continue
        with open(f, "r", encoding="utf-8") as fh:
            source = fh.read()
        lines = source.splitlines()
        mod = _module_name(f)
        for fn_name, lineno, why in kernel_callers(source, f):
            if 1 <= lineno <= len(lines) and \
                    "JF100" in _pragma_ids(lines[lineno - 1]):
                continue
            if mod is None or mod not in SOLVER_MODULES:
                out.append(IRFinding(
                    "JF100", f, fn_name,
                    f"{fn_name!r} {why}, in a module missing from "
                    "registry.SOLVER_MODULES: the IR audit cannot see it; "
                    "add the module to the list and register the function "
                    "with @solver_entry",
                ))
            elif f"{mod}.{fn_name}" not in entries:
                out.append(IRFinding(
                    "JF100", f, fn_name,
                    f"{fn_name!r} {why} but is not registered: decorate it "
                    "with @solver_entry(spec=...), or give its def line a "
                    f"JF100 pragma with the reason (line {lineno})",
                ))
    return out


def check_reference_map(
    entries: dict[str, SolverEntry] | None = None
) -> list[IRFinding]:
    """JF100 over ``registry.REFERENCE_ENTRIES``: every target is a
    registered entry that resolves; every ``None`` has its reason."""
    if entries is None:
        entries = registered_entries()
    out: list[IRFinding] = []
    for ref, port in REFERENCE_ENTRIES.items():
        if port is None:
            if not FOLDED_REASONS.get(ref):
                out.append(IRFinding(
                    "JF100", ref, "-",
                    "reference entry mapped to None without a reason in "
                    "registry.FOLDED_REASONS",
                ))
            continue
        e = entries.get(port)
        if e is None:
            out.append(IRFinding(
                "JF100", ref, "-",
                f"maps to {port}, which is not a registered entry",
            ))
            continue
        try:
            e.resolve()
        except (ImportError, AttributeError) as err:
            out.append(IRFinding("JF100", ref, "-",
                                 f"{port} does not resolve: {err}"))
    return out


# --------------------------------------------------------------------------- #
# JF105: footprint budgets
# --------------------------------------------------------------------------- #

DEFAULT_BUDGET_PATH = os.path.join("artifacts", "ir_budget_torch.json")
#: Growth tolerance: relative headroom plus a per-metric absolute slack so
#: tiny entries aren't pinned to the op (the reference's).  Shrinkage never
#: fails (it shows in the diff; refresh with --write-budget when
#: intentional).
DEFAULT_TOLERANCE = {
    "rel": 0.25,
    "abs": {"aten_ops": 16, "flops": 4096.0, "hbm_bytes": 8192.0},
}


def measure_case(entry: SolverEntry, case: AuditCase,
                 trace: CaseTrace | None = None) -> dict:
    """Footprint of one budgeted case, run on the CPU: aten ops dispatched,
    matrix-unit FLOPs and bytes moved (``roofline.op_stats.OpCounter``)."""
    if trace is None:
        trace = trace_case(entry, case, "cpu")
    return {
        "aten_ops": trace.aten_ops,
        "flops": round(float(trace.stats.flops), 1),
        "hbm_bytes": round(float(trace.stats.hbm_bytes), 1),
    }


def compare_budget(measured: dict, budget: dict,
                   complete: bool = True) -> tuple[list[IRFinding], dict]:
    """Diff measured footprints against the checked-in budget.

    Returns ``(findings, diff)``: JF105 findings for growth beyond
    tolerance, for measured cases with no recorded budget, and, when
    ``complete`` (no path filter narrowed the audit), for stale recorded
    cases that no longer exist.  ``diff`` is the full machine-readable
    comparison, including in-tolerance drift.
    """
    tol = budget.get("tolerance", DEFAULT_TOLERANCE)
    rel = float(tol.get("rel", 0.25))
    abs_ = tol.get("abs", {})
    recorded = budget.get("entries", {})
    findings: list[IRFinding] = []
    diff: dict = {"entries": {}, "ok": True}

    def split(name: str) -> tuple[str, str]:
        ent, _, lab = name.partition("[")
        return ent, lab.rstrip("]") or "-"

    for name in sorted(measured):
        m = measured[name]
        b = recorded.get(name)
        row: dict = {}
        if b is None:
            findings.append(IRFinding(
                "JF105", *split(name),
                "no recorded footprint budget for this case; approve it "
                "into artifacts/ir_budget_torch.json with "
                "`python -m repro_torch.analysis ir --device cpu "
                "--write-budget`",
            ))
            row = {k: {"measured": v, "budget": None, "ok": False}
                   for k, v in m.items()}
        else:
            for k, v in m.items():
                base = b.get(k)
                limit = None if base is None else \
                    base * (1.0 + rel) + float(abs_.get(k, 0))
                ok = limit is None or v <= limit
                row[k] = {"measured": v, "budget": base, "limit": limit,
                          "ok": ok}
                if not ok:
                    findings.append(IRFinding(
                        "JF105", *split(name),
                        f"{k} grew {base} -> {v} (limit {limit:.1f}, "
                        f"rel tol {rel:+.0%}): footprint regression; if "
                        "intentional, refresh the budget with "
                        "--write-budget and review the diff",
                    ))
        diff["entries"][name] = row
    if complete:
        for name in sorted(set(recorded) - set(measured)):
            findings.append(IRFinding(
                "JF105", *split(name),
                "stale budget entry: the case no longer exists; refresh "
                "artifacts/ir_budget_torch.json with --write-budget",
            ))
            diff["entries"][name] = {"stale": True}
    diff["ok"] = not findings
    return findings, diff


# --------------------------------------------------------------------------- #
# the audit run and the CLI
# --------------------------------------------------------------------------- #


def _entry_file(entry: SolverEntry) -> str | None:
    spec = importlib.util.find_spec(entry.module)
    return None if spec is None else spec.origin


def _under(path: str, roots: list[str]) -> bool:
    ap = os.path.abspath(path)
    for r in roots:
        ar = os.path.abspath(r)
        if ap == ar or ap.startswith(ar.rstrip(os.sep) + os.sep):
            return True
    return False


def select_entries(paths: list[str], entries: dict[str, SolverEntry]
                   ) -> dict[str, SolverEntry]:
    """The entries whose modules live under ``paths``."""
    return {name: e for name, e in entries.items()
            if (f := _entry_file(e)) is not None and _under(f, paths)}


def audit_entries(entries: dict[str, SolverEntry], device="cpu"
                  ) -> tuple[list[IRFinding], list[dict]]:
    """Run every case of ``entries`` on ``device``: ``(findings, rows)``,
    one row per case with its entry, label, aten op count, launch deltas,
    the kernels it must launch on a card, its ``OpCounter`` footprint and
    whether it is budgeted."""
    findings: list[IRFinding] = []
    rows: list[dict] = []
    for name, entry in entries.items():
        for case in entry.cases():
            trace = trace_case(entry, case, device)
            findings.extend(audit_case(entry, case, trace))
            rows.append({
                "entry": name, "case": case.label, "kind": entry.kind,
                "aten_ops": trace.aten_ops,
                "launches": {k: v for k, v in trace.launches.items() if v},
                "kernels": list(case.kernels),
                "exempt": sorted(case.exempt),
                "budget": case.budget,
                "footprint": measure_case(entry, case, trace),
            })
    return findings, rows


def run_audit(paths: list[str], budget_path: str | None,
              write_budget: bool = False, diff_out: str | None = None,
              device="cpu") -> tuple[list[IRFinding], dict]:
    """Full audit over the entries whose modules live under ``paths``.
    JF105 runs only when ``device`` is the CPU."""
    entries = registered_entries()
    selected = select_entries(paths, entries)
    findings = check_registration(paths, entries)
    findings.extend(check_reference_map(entries))
    case_findings, rows = audit_entries(selected, device)
    findings.extend(case_findings)
    if any(e.module == "repro_torch.core.flow" for e in selected.values()):
        findings.extend(audit_fold_tree())

    diff: dict = {}
    if torch.device(device).type != "cpu":
        budget_path = None
    if budget_path is not None:
        measured = {f"{r['entry']}[{r['case']}]": r["footprint"]
                    for r in rows if r["budget"]}
        all_budgeted = {
            f"{n}[{c.label}]" for n, e in entries.items()
            for c in e.cases() if c.budget
        }
        complete = set(measured) >= all_budgeted
        if write_budget:
            payload = {
                "comment": (
                    "JF105 footprint budgets of the port (python -m "
                    "repro_torch.analysis ir --device cpu): aten ops, "
                    "FLOPs and bytes of each budgeted case run on the CPU. "
                    "Regenerate deliberately with --write-budget; the diff "
                    "is reviewed like code."
                ),
                "torch": torch.__version__,
                "tolerance": DEFAULT_TOLERANCE,
                "entries": measured,
            }
            os.makedirs(os.path.dirname(budget_path) or ".", exist_ok=True)
            with open(budget_path, "w", encoding="utf-8") as fh:
                json.dump(payload, fh, indent=1, sort_keys=True)
                fh.write("\n")
        elif os.path.exists(budget_path):
            with open(budget_path, "r", encoding="utf-8") as fh:
                budget = json.load(fh)
            if budget.get("torch") != torch.__version__:
                print(
                    f"ir-audit: budget recorded on torch {budget.get('torch')}"
                    f", running {torch.__version__}: tolerance absorbs "
                    "minor drift, refresh on upgrade",
                    file=sys.stderr,
                )
            bud_findings, diff = compare_budget(
                measured, budget, complete=complete
            )
            findings.extend(bud_findings)
        elif measured:
            findings.append(IRFinding(
                "JF105", budget_path, "-",
                "budget file missing; create it with --write-budget",
            ))
    if diff_out is not None:
        os.makedirs(os.path.dirname(diff_out) or ".", exist_ok=True)
        with open(diff_out, "w", encoding="utf-8") as fh:
            json.dump(diff or {"entries": {}, "ok": not findings}, fh,
                      indent=1, sort_keys=True)
            fh.write("\n")
    return findings, diff


def main_ir(argv: list[str]) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis ir",
        description="dispatch-level solver invariant audit (JF100-JF105)",
    )
    p.add_argument("paths", nargs="*", default=None,
                   help="files/dirs to audit (default: src/repro_torch)")
    p.add_argument("--device", default="cuda",
                   help="where the cases run (JF105 runs on cpu only)")
    p.add_argument("--budget", default=DEFAULT_BUDGET_PATH,
                   help="footprint budget file (JF105)")
    p.add_argument("--write-budget", action="store_true",
                   help="record current footprints as the new budget")
    p.add_argument("--no-budget", action="store_true",
                   help="skip the JF105 footprint comparison")
    p.add_argument("--diff-out", default=None,
                   help="write the budget comparison JSON here")
    ns = p.parse_args(argv)
    paths = ns.paths or ["src/repro_torch"]
    findings, _ = run_audit(
        paths,
        budget_path=None if ns.no_budget else ns.budget,
        write_budget=ns.write_budget,
        diff_out=ns.diff_out,
        device=ns.device,
    )
    for f in findings:
        print(f)
    if findings:
        counts: dict[str, int] = {}
        for f in findings:
            counts[f.rule] = counts.get(f.rule, 0) + 1
        summary = ", ".join(
            f"{r} x{n} ({IR_RULES[r]})" for r, n in sorted(counts.items())
        )
        print(f"\nir-audit: {len(findings)} finding(s): {summary}",
              file=sys.stderr)
        return 1
    n = len(registered_entries())
    print(f"ir-audit: clean ({n} registered entries, device {ns.device})")
    return 0
