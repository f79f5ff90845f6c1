"""CLI: ``python -m repro_torch.analysis [paths...]`` — run the port's
invariant linter (default path ``src/repro_torch``).

Exit status 0 when clean, 1 when any rule fires.  Pure stdlib (no torch),
like the reference's ``python -m repro.analysis``.
"""

from __future__ import annotations

import sys

from .linter import RULES, lint_paths


def main(argv: list[str]) -> int:
    paths = argv or ["src/repro_torch"]
    violations = lint_paths(paths)
    for v in violations:
        print(v)
    if violations:
        counts: dict[str, int] = {}
        for v in violations:
            counts[v.rule] = counts.get(v.rule, 0) + 1
        summary = ", ".join(
            f"{rule} x{n} ({RULES[rule]})" for rule, n in sorted(counts.items())
        )
        print(f"\n{len(violations)} violation(s): {summary}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
