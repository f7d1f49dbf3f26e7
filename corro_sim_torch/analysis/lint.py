"""corro-lint engine: file walking, suppressions, reports, metrics.

``corro_sim/analysis/lint.py`` kept as it is, over the port's rule
catalog (:mod:`corro_sim_torch.analysis.rules`): collecting ``.py``
files, parsing, applying ``# corro-lint: ignore[...]`` suppressions,
rendering text/JSON reports and exporting the ``corro_lint_*`` info
metrics (:mod:`corro_sim_torch.utils.metrics`). Pure AST: it imports
no torch.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import json
import os
import re
import tokenize

from corro_sim_torch.analysis.rules import RULES, Finding, analyze

# the port's package directory: the default lint target
_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ``# corro-lint: ignore`` (all rules) or ``ignore[CL101,CL104]``.
# Anchored: the directive must BE the comment (prose that merely
# mentions the syntax, like this comment, must not register as a
# suppress-all marker for its own line and the line below).
_SUPPRESS_RE = re.compile(
    r"#+\s*corro-lint:\s*ignore(?:\[(?P<rules>[A-Z0-9,\s]+)\])?\s*$"
)


@dataclasses.dataclass
class LintResult:
    findings: list[Finding]
    files_scanned: int
    suppressed: dict[str, int]  # rule -> suppressed-finding count
    parse_errors: list[tuple[str, str]]  # (path, message)

    @property
    def errors(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    @property
    def warnings(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == "warning"]

    def exit_code(self, strict: bool = False) -> int:
        if self.parse_errors or self.errors:
            return 1
        if self.files_scanned == 0:
            return 1  # nothing linted: a typo'd path must not pass green
        if strict and self.warnings:
            return 1
        return 0

    def as_dict(self) -> dict:
        by_rule: dict[str, int] = {}
        for f in self.findings:
            by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
        return {
            "files_scanned": self.files_scanned,
            "findings": [f.as_dict() for f in self.findings],
            "by_rule": by_rule,
            "suppressed": dict(self.suppressed),
            "parse_errors": [
                {"path": p, "message": m} for p, m in self.parse_errors
            ],
            "rules": {
                r.id: {"name": r.name, "severity": r.severity,
                       "summary": r.summary}
                for r in RULES.values()
            },
        }


def collect_files(paths: list[str]) -> list[str]:
    """Expand files/directories into a sorted list of ``.py`` files.

    Directory walks skip ``tests/fixtures``: the lint fixtures are
    deliberately bad, so a tree-wide ``lint .`` must not trip over them.
    Explicitly named files are always linted, which is how the fixture
    tests exercise each rule."""
    out: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, names in os.walk(p):
                if os.path.basename(root) == "tests" and "fixtures" in dirs:
                    dirs.remove("fixtures")
                dirs[:] = sorted(
                    d for d in dirs
                    if d not in ("__pycache__", ".git", ".jax_cache",
                                 "_build")
                )
                out.extend(
                    os.path.join(root, n)
                    for n in sorted(names) if n.endswith(".py")
                )
        elif p.endswith(".py") and os.path.isfile(p):
            # missing paths are reported once by lint_paths' pre-check;
            # appending them here would double-count as an open() error
            out.append(p)
    return sorted(dict.fromkeys(out))


def _suppressions(source: str) -> dict[int, set[str] | None]:
    """line -> suppressed rule ids (None = all rules). Read from real
    tokens, not substring search, so a suppression inside a string
    literal does not count."""
    out: dict[int, set[str] | None] = {}
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = _SUPPRESS_RE.match(tok.string)
            if not m:
                continue
            rules = m.group("rules")
            out[tok.start[0]] = (
                None if rules is None
                else {r.strip() for r in rules.split(",") if r.strip()}
            )
    except tokenize.TokenError:
        pass
    return out


def _is_suppressed(f: Finding, supp: dict[int, set[str] | None]) -> bool:
    for line in (f.line, f.line - 1):
        if line in supp:
            rules = supp[line]
            if rules is None or f.rule in rules:
                return True
    return False


def lint_paths(paths: list[str]) -> LintResult:
    files = collect_files(paths)
    trees: dict[str, ast.Module] = {}
    sources: dict[str, str] = {}
    parse_errors: list[tuple[str, str]] = []
    for p in paths:
        if not os.path.exists(p):
            parse_errors.append((p, "path does not exist"))
        elif not os.path.isdir(p) and not p.endswith(".py"):
            parse_errors.append((p, "not a directory or .py file"))
    for path in files:
        try:
            with open(path, encoding="utf-8") as fh:
                src = fh.read()
            trees[path] = ast.parse(src, filename=path)
            sources[path] = src
        except (OSError, SyntaxError) as e:
            parse_errors.append((path, str(e)))
    raw = analyze(trees)
    findings: list[Finding] = []
    suppressed: dict[str, int] = {}
    supp_by_path = {p: _suppressions(s) for p, s in sources.items()}
    for f in raw:
        if _is_suppressed(f, supp_by_path.get(f.path, {})):
            suppressed[f.rule] = suppressed.get(f.rule, 0) + 1
        else:
            findings.append(f)
    return LintResult(
        findings=findings,
        files_scanned=len(trees),
        suppressed=suppressed,
        parse_errors=parse_errors,
    )


def render_text(res: LintResult) -> str:
    lines: list[str] = []
    for path, msg in res.parse_errors:
        lines.append(f"{path}: error: {msg}")
    for f in res.findings:
        lines.append(
            f"{f.path}:{f.line}:{f.col + 1}: {f.rule} "
            f"[{RULES[f.rule].name}/{f.severity}] {f.message}"
        )
    n_err, n_warn = len(res.errors), len(res.warnings)
    n_supp = sum(res.suppressed.values())
    lines.append(
        f"corro-lint: {res.files_scanned} files, {n_err} errors, "
        f"{n_warn} warnings"
        + (f", {n_supp} suppressed" if n_supp else "")
    )
    return "\n".join(lines)


def render_json(res: LintResult) -> str:
    return json.dumps(res.as_dict(), indent=2)


def run_lint(paths: list[str], fmt: str = "text", strict: bool = False,
             out: str | None = None) -> int:
    """The `lint` entry point: lint the paths (default: the port's
    package), print the report, optionally write the JSON findings
    report, return the exit code."""
    res = lint_paths(paths or [_PACKAGE])
    export_metrics(res)
    print(render_json(res) if fmt == "json" else render_text(res))
    if out:
        with open(out, "w", encoding="utf-8") as fh:
            fh.write(render_json(res))
            fh.write("\n")
    return res.exit_code(strict=strict)


def export_metrics(res: LintResult) -> None:
    """Export the run as ``corro_lint_*`` info metrics so a scrape of a
    process that ran the analyzer carries the findings profile
    (constants doc: utils/metrics.py)."""
    from corro_sim_torch.utils.metrics import (
        LINT_FILES_SCANNED_TOTAL,
        LINT_FINDINGS_TOTAL,
        LINT_RUNS_TOTAL,
        LINT_SUPPRESSIONS_TOTAL,
        counters,
    )

    counters.inc(
        LINT_RUNS_TOTAL,
        help_="corro-lint analyzer invocations",
    )
    counters.inc(
        LINT_FILES_SCANNED_TOTAL, n=res.files_scanned,
        help_="files parsed by the corro-lint analyzer",
    )
    for f in res.findings:
        counters.inc(
            LINT_FINDINGS_TOTAL,
            labels=f'{{rule="{f.rule}",severity="{f.severity}"}}',
            help_="corro-lint findings by rule and severity",
        )
    for rule, n in res.suppressed.items():
        counters.inc(
            LINT_SUPPRESSIONS_TOTAL, n=n,
            labels=f'{{rule="{rule}"}}',
            help_="corro-lint findings silenced by "
                  "`# corro-lint: ignore[...]` comments",
        )
