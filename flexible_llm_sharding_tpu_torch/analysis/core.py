"""flscheck rule framework: registry, pragmas, baseline, runner, reporters.

Design (mirrors how the perf gate made speed claims un-rottable — here the
claims are *invariants*):

- **Rules** register into one table via :func:`file_rule` (runs once per
  parsed module) or :func:`project_rule` (runs once over the whole file
  set, for cross-file invariants like knob threading). Each returns
  :class:`Finding`s.
- **Pragmas** suppress a finding in place::

      except Exception:  # flscheck: disable=EXC-TAXONOMY: reject-with-reason contract

  A pragma names one or more rules (comma-separated) and MUST carry a
  reason after the colon — a reasonless pragma is itself a finding, so
  suppressions stay auditable. A pragma covers its own line and the line
  directly below it (so it can sit on the statement or on a comment line
  above). ``# flscheck: holds=_lock`` is the GUARDED-BY method-contract
  pragma (see rules.py).
- **Baseline** (``flscheck-torch-baseline.json`` at the repo root, the
  port's own: the JAX package's ``flscheck-baseline.json`` beside it is
  never read or written here) grandfathers
  findings by stable fingerprint — (rule, path, enclosing symbol,
  message), line-number independent. Every entry needs a real reason
  (``TODO``-prefixed reasons are rejected), and an entry that no longer
  matches any finding is an error: fixing a finding forces shrinking the
  baseline, so it only ever ratchets down (CI additionally diffs the
  entry set against the merge base).

Exit codes: 0 clean, 1 findings, 2 usage/internal error.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import hashlib
import io
import json
import os
import re
import sys
import tokenize
from pathlib import Path
from typing import Callable, Iterable

BASELINE_NAME = "flscheck-torch-baseline.json"

# Rules the runner itself emits (pragma/baseline hygiene, parse errors).
META_RULES = ("PRAGMA", "BASELINE", "PARSE")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one source location.

    ``symbol`` is the enclosing ``Class.method`` (or module) — it anchors
    the fingerprint so baselined findings survive unrelated line drift.
    ``message`` must therefore be stable too: no line numbers in it.
    """

    rule: str
    path: str  # repo-relative posix path (display + fingerprint)
    line: int
    message: str
    symbol: str = ""

    @property
    def fingerprint(self) -> str:
        key = f"{self.rule}|{self.path}|{self.symbol}|{self.message}"
        return hashlib.sha1(key.encode()).hexdigest()[:16]

    def format(self) -> str:
        sym = f" [{self.symbol}]" if self.symbol else ""
        return f"{self.path}:{self.line}: {self.rule}{sym} {self.message}"


@dataclasses.dataclass
class FileInfo:
    """One parsed module handed to rules."""

    relkey: str  # path relative to the package dir ("runtime/executor.py")
    path: str  # display path (repo-relative when under the repo root)
    tree: ast.Module
    lines: list[str]  # raw source lines (1-indexed via lines[line - 1])
    pragmas: list["Pragma"] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ProjectContext:
    """What project rules see: every parsed file plus the repo layout."""

    package_dir: Path
    repo_root: Path
    files: dict[str, FileInfo]  # relkey -> FileInfo

    def get(self, relkey: str) -> FileInfo | None:
        return self.files.get(relkey)


@dataclasses.dataclass(frozen=True)
class Rule:
    name: str
    doc: str
    kind: str  # 'file' | 'project'
    fn: Callable


RULES: dict[str, Rule] = {}


def file_rule(name: str, doc: str):
    def deco(fn):
        RULES[name] = Rule(name, doc, "file", fn)
        return fn

    return deco


def project_rule(name: str, doc: str):
    def deco(fn):
        RULES[name] = Rule(name, doc, "project", fn)
        return fn

    return deco


# ---------------------------------------------------------------------------
# Pragmas
# ---------------------------------------------------------------------------

PRAGMA_RE = re.compile(
    r"#\s*flscheck:\s*(?P<kind>disable|holds)="
    r"(?P<args>[A-Za-z0-9_\-]+(?:\s*,\s*[A-Za-z0-9_\-]+)*)"
    r"(?::\s*(?P<reason>.*\S))?\s*$"
)


@dataclasses.dataclass(frozen=True)
class Pragma:
    line: int
    kind: str  # 'disable' | 'holds'
    names: tuple[str, ...]  # rule names / lock names
    reason: str


def parse_pragmas(lines: list[str]) -> list[Pragma]:
    """Pragmas live in real comments only: the source is tokenized and
    PRAGMA_RE runs over COMMENT tokens, so pragma-shaped text inside a
    string or docstring (this framework's own docs, a test fixture)
    neither suppresses anything nor trips the reason hygiene."""
    reader = io.StringIO("\n".join(lines) + "\n").readline
    try:
        comments = [
            (tok.start[0], tok.string)
            for tok in tokenize.generate_tokens(reader)
            if tok.type == tokenize.COMMENT
        ]
    except (tokenize.TokenError, IndentationError, SyntaxError):
        # Every analyzed file already ast-parsed, so this is near
        # unreachable — but a tokenizer edge case must fail toward the
        # raw scan (a phantom pragma is a visible PRAGMA finding; a
        # dropped one would silently unsuppress and fail CI loudly).
        comments = list(enumerate(lines, 1))
    out = []
    for i, text in comments:
        m = PRAGMA_RE.search(text)
        if m:
            names = tuple(s.strip() for s in m.group("args").split(","))
            out.append(Pragma(i, m.group("kind"), names, m.group("reason") or ""))
    return out


def _pragma_findings(info: FileInfo, pragmas: list[Pragma]) -> list[Finding]:
    """Hygiene of the pragmas themselves: known rule names, real reasons."""
    out = []
    for p in pragmas:
        if p.kind == "disable":
            for name in p.names:
                if name not in RULES and name not in META_RULES:
                    out.append(
                        Finding(
                            "PRAGMA",
                            info.path,
                            p.line,
                            f"pragma disables unknown rule {name!r}",
                            symbol="pragma",
                        )
                    )
        # Every suppression carries a reason — holds= exempts GUARDED-BY
        # just as disable= exempts its rules, so it gets the same hygiene.
        if not p.reason or p.reason.upper().startswith("TODO"):
            out.append(
                Finding(
                    "PRAGMA",
                    info.path,
                    p.line,
                    f"{p.kind} pragma needs a reason "
                    f"(flscheck: {p.kind}=<name>: <why this is fine>)",
                    symbol="pragma",
                )
            )
    return out


def _suppressed(finding: Finding, pragmas: list[Pragma]) -> bool:
    for p in pragmas:
        if p.kind != "disable":
            continue
        if p.line in (finding.line, finding.line - 1) and finding.rule in p.names:
            return True
    return False


# ---------------------------------------------------------------------------
# Baseline
# ---------------------------------------------------------------------------


def load_baseline(path: Path) -> tuple[dict[str, dict], list[Finding]]:
    """fingerprint -> entry, plus findings about the baseline file itself."""
    findings: list[Finding] = []
    if not path.exists():
        return {}, findings
    try:
        data = json.loads(path.read_text())
        entries = list(data.get("entries", []))
    except (OSError, ValueError) as e:
        return {}, [
            Finding("BASELINE", path.name, 1, f"unreadable baseline: {e}")
        ]
    by_fp: dict[str, dict] = {}
    for e in entries:
        fp = e.get("fingerprint", "")
        reason = (e.get("reason") or "").strip()
        if not fp:
            findings.append(
                Finding("BASELINE", path.name, 1, f"entry without fingerprint: {e}")
            )
            continue
        if not reason or reason.upper().startswith("TODO"):
            findings.append(
                Finding(
                    "BASELINE",
                    path.name,
                    1,
                    f"entry {fp} ({e.get('rule')}) needs a real reason string",
                )
            )
        by_fp[fp] = e
    return by_fp, findings


def write_baseline(
    path: Path,
    findings: Iterable[Finding],
    old: dict[str, dict],
    extra_entries: Iterable[dict] = (),
) -> None:
    entries = [dict(e) for e in extra_entries]
    written = {e.get("fingerprint") for e in entries}
    for f in findings:
        if f.fingerprint in written:
            # Fingerprints are line-independent, so two identical
            # violations in one symbol share one — and one entry
            # grandfathers both.
            continue
        written.add(f.fingerprint)
        prev = old.get(f.fingerprint, {})
        entries.append(
            {
                "fingerprint": f.fingerprint,
                "rule": f.rule,
                "path": f.path,
                "symbol": f.symbol,
                "message": f.message,
                "reason": prev.get("reason", "TODO: justify or fix"),
            }
        )
    entries.sort(key=lambda e: (e["rule"], e["path"], e["fingerprint"]))
    path.write_text(json.dumps({"version": 1, "entries": entries}, indent=2) + "\n")


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------


def _ensure_rules_loaded() -> None:
    # rules.py imports this module for the registry; import it lazily here
    # so `import core` alone never cycles.
    from flexible_llm_sharding_tpu_torch.analysis import rules  # noqa: F401


def _collect_files(package_dir: Path, repo_root: Path) -> tuple[dict[str, FileInfo], list[Finding]]:
    files: dict[str, FileInfo] = {}
    findings: list[Finding] = []
    for p in sorted(package_dir.rglob("*.py")):
        if "__pycache__" in p.parts:
            continue
        relkey = p.relative_to(package_dir).as_posix()
        try:
            display = p.relative_to(repo_root).as_posix()
        except ValueError:
            display = relkey
        try:
            source = p.read_text()
            tree = ast.parse(source, filename=str(p))
        except (OSError, SyntaxError) as e:
            findings.append(Finding("PARSE", display, getattr(e, "lineno", 1) or 1, str(e)))
            continue
        lines = source.splitlines()
        files[relkey] = FileInfo(relkey, display, tree, lines, parse_pragmas(lines))
    return files, findings


@dataclasses.dataclass
class Result:
    findings: list[Finding]  # active (unsuppressed, unbaselined)
    baselined: list[Finding]
    suppressed: int  # pragma-suppressed count

    @property
    def ok(self) -> bool:
        return not self.findings

    def to_json(self) -> dict:
        def enc(f: Finding) -> dict:
            return {
                "rule": f.rule,
                "path": f.path,
                "line": f.line,
                "symbol": f.symbol,
                "message": f.message,
                "fingerprint": f.fingerprint,
            }

        counts: dict[str, int] = {}
        for f in self.findings:
            counts[f.rule] = counts.get(f.rule, 0) + 1
        return {
            "version": 1,
            "ok": self.ok,
            "findings": [enc(f) for f in self.findings],
            "baselined": [enc(f) for f in self.baselined],
            "suppressed_by_pragma": self.suppressed,
            "counts": counts,
        }

    def format_text(self) -> str:
        out = [f.format() for f in sorted(self.findings, key=lambda f: (f.path, f.line, f.rule))]
        summary = (
            f"flscheck: {len(self.findings)} finding(s), "
            f"{len(self.baselined)} baselined, "
            f"{self.suppressed} pragma-suppressed"
        )
        return "\n".join(out + [summary])


def run(
    package_dir: str | os.PathLike,
    repo_root: str | os.PathLike | None = None,
    baseline_path: str | os.PathLike | None = None,
    select: Iterable[str] | None = None,
) -> Result:
    """Analyze ``package_dir``; ``select`` limits to the named rules
    (meta rules always run). ``baseline_path`` None resolves to
    ``<repo_root>/flscheck-torch-baseline.json``; pass ``""`` to disable."""
    _ensure_rules_loaded()
    package_dir = Path(package_dir)
    repo_root = Path(repo_root) if repo_root is not None else package_dir.parent
    selected = set(select) if select else None

    files, findings = _collect_files(package_dir, repo_root)
    ctx = ProjectContext(package_dir=package_dir, repo_root=repo_root, files=files)

    for info in files.values():
        findings.extend(_pragma_findings(info, info.pragmas))

    raw: list[Finding] = []
    for rule in RULES.values():
        if selected is not None and rule.name not in selected:
            continue
        if rule.kind == "file":
            for relkey, info in files.items():
                raw.extend(rule.fn(info, ctx))
        else:
            raw.extend(rule.fn(ctx))

    # Pragma suppression (keyed by display path -> pragmas).
    pragmas_by_path = {info.path: info.pragmas for info in files.values()}
    suppressed = 0
    kept: list[Finding] = []
    for f in raw:
        if _suppressed(f, pragmas_by_path.get(f.path, [])):
            suppressed += 1
        else:
            kept.append(f)

    # Baseline: matched findings drop out; stale entries are errors.
    baselined: list[Finding] = []
    if baseline_path is None:
        baseline_path = repo_root / BASELINE_NAME
    if baseline_path:
        baseline, bl_findings = load_baseline(Path(baseline_path))
        findings.extend(bl_findings)
        matched: set[str] = set()
        active = []
        for f in kept:
            if f.fingerprint in baseline:
                matched.add(f.fingerprint)
                baselined.append(f)
            else:
                active.append(f)
        kept = active
        for fp, e in sorted(baseline.items()):
            if fp in matched:
                continue
            if selected is not None and e.get("rule") not in selected:
                # The entry's rule did not run under --select, so its
                # finding could not have been produced — staleness is only
                # judgeable on a full run.
                continue
            findings.append(
                Finding(
                    "BASELINE",
                    Path(baseline_path).name,
                    1,
                    f"stale entry {fp} ({e.get('rule')} at {e.get('path')}) "
                    "matches no finding — remove it (the baseline only shrinks)",
                )
            )

    # De-duplicate identical findings (two rules or passes reporting the
    # same thing at the same spot) while keeping order stable.
    seen: set[tuple] = set()
    unique: list[Finding] = []
    for f in findings + kept:
        key = (f.rule, f.path, f.line, f.message)
        if key not in seen:
            seen.add(key)
            unique.append(f)
    return Result(findings=unique, baselined=baselined, suppressed=suppressed)


def analyze_source(
    source: str, relkey: str = "mod.py", select: Iterable[str] | None = None
) -> list[Finding]:
    """Run the FILE rules (plus pragma handling) over one source string —
    the unit-test harness for per-file rules."""
    _ensure_rules_loaded()
    tree = ast.parse(source)
    lines = source.splitlines()
    info = FileInfo(relkey, relkey, tree, lines, parse_pragmas(lines))
    ctx = ProjectContext(Path("."), Path("."), {relkey: info})
    pragmas = info.pragmas
    findings = _pragma_findings(info, pragmas)
    selected = set(select) if select else None
    for rule in RULES.values():
        if rule.kind != "file":
            continue
        if selected is not None and rule.name not in selected:
            continue
        findings.extend(f for f in rule.fn(info, ctx) if not _suppressed(f, pragmas))
    return findings


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def build_check_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="flscheck",
        description="Project-invariant static analyzer (lock discipline, "
        "knob threading, fault-site registry, exception taxonomy, counter "
        "export, determinism, repo hygiene). Exit 0 = clean.",
    )
    p.add_argument("--json", action="store_true", help="machine-readable report")
    p.add_argument(
        "--select",
        type=str,
        default="",
        help="comma list of rule names to run (default: all)",
    )
    p.add_argument(
        "--baseline",
        type=str,
        default=None,
        help=f"baseline file (default <repo>/{BASELINE_NAME}); 'none' disables",
    )
    p.add_argument(
        "--write-baseline",
        action="store_true",
        help="rewrite the baseline from the current findings (existing "
        "reasons are preserved by fingerprint; new entries get a TODO "
        "reason you must replace before CI passes)",
    )
    p.add_argument("--list-rules", action="store_true", help="print the rule catalog")
    p.add_argument(
        "--root",
        type=str,
        default=None,
        help="package dir to analyze (default: this installed package)",
    )
    return p


def main(argv: list[str] | None = None) -> int:
    _ensure_rules_loaded()
    args = build_check_parser().parse_args(argv)
    if args.list_rules:
        for r in sorted(RULES.values(), key=lambda r: r.name):
            print(f"{r.name:16s} [{r.kind}] {r.doc}")
        return 0
    package_dir = Path(args.root) if args.root else Path(__file__).resolve().parent.parent
    repo_root = package_dir.parent
    baseline_path: str | Path | None
    if args.baseline == "none":
        baseline_path = ""
    elif args.baseline:
        baseline_path = Path(args.baseline)
    else:
        baseline_path = repo_root / BASELINE_NAME
    select = [s for s in args.select.split(",") if s] or None
    if select:
        unknown = [s for s in select if s not in RULES and s not in META_RULES]
        if unknown:
            # A typo'd --select would otherwise run zero rules and report
            # a clean pass — fail loudly like a bad chaos site name does.
            print(
                "flscheck: unknown rule(s) in --select: "
                f"{', '.join(unknown)} (see --list-rules)",
                file=sys.stderr,
            )
            return 2

    if args.write_baseline:
        if not baseline_path:
            print(
                "flscheck: --write-baseline needs a baseline file "
                "(drop --baseline none)",
                file=sys.stderr,
            )
            return 2
        # Findings computed WITHOUT the baseline become the new baseline.
        res = run(package_dir, repo_root, baseline_path="", select=select)
        old, _ = load_baseline(Path(baseline_path))
        writable = [f for f in res.findings if f.rule not in META_RULES]
        kept_old = []
        if select:
            # Only the selected rules re-ran: entries for every OTHER rule
            # were neither confirmed nor refuted, so carry them over
            # verbatim instead of silently mass-deleting them.
            kept_old = [
                e for e in old.values() if e.get("rule") not in set(select)
            ]
        write_baseline(Path(baseline_path), writable, old, extra_entries=kept_old)
        print(
            f"wrote {len(writable) + len(kept_old)} entries to {baseline_path}"
            + (f" ({len(kept_old)} carried over from unselected rules)" if kept_old else ""),
            file=sys.stderr,
        )
        return 0

    res = run(package_dir, repo_root, baseline_path=baseline_path, select=select)
    if args.json:
        print(json.dumps(res.to_json(), indent=2))
    else:
        print(res.format_text())
    return 0 if res.ok else 1
