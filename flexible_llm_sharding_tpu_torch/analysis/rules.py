"""The project-specific rule set (see docs/analysis.md for the catalog).

Every rule here encodes an invariant a past PR review caught by hand:

- LOCK-IO        blocking calls inside ``with <lock>:`` bodies
- GUARDED-BY     ``# guarded by: _lock`` attributes touched off-lock
- KNOB-SYNC      config fields vs the two CLI parsers vs construction
- SITE-REG       ``injector.fire("<site>")`` vs FAULT_SITES vs docs table
- EVENT-REG      ``emit("<kind>")`` vs obs/events.EVENT_KINDS vs docs table
- EXC-TAXONOMY   swallowing broad excepts / unchained re-raises in hot paths
- COUNTER-EXPORT counters incremented but absent from stats()/snapshot()
- DETERMINISM    unseeded randomness / wall-clock in faults+integrity
- QUANT-MANIFEST layer-file writers must record a manifest dtype entry
- HYGIENE        stray package dirs, missing __init__.py

Rules are AST-walks plus a little comment scanning — no imports of the
analyzed code, so a module with a broken import still gets checked.
"""

from __future__ import annotations

import ast
import os
import re

from flexible_llm_sharding_tpu_torch.analysis.core import (
    FileInfo,
    Finding,
    ProjectContext,
    file_rule,
    project_rule,
)

# ---------------------------------------------------------------------------
# Shared AST helpers
# ---------------------------------------------------------------------------


def _dotted(node: ast.AST) -> tuple[str, ...]:
    """('os', 'path', 'getsize') for an Attribute/Name chain, () otherwise."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return ()


class _SymbolWalker(ast.NodeVisitor):
    """Base visitor that tracks the enclosing Class.method qualname."""

    def __init__(self) -> None:
        self.stack: list[str] = []

    @property
    def symbol(self) -> str:
        return ".".join(self.stack) or "module"

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef


# ---------------------------------------------------------------------------
# LOCK-IO
# ---------------------------------------------------------------------------

_LOCK_NAME_RE = re.compile(r"lock", re.IGNORECASE)

# Blocking calls by dotted suffix. The list is deliberately the *known*
# blocking families on this codebase's hot paths (stat/read/parse/upload/
# sleep), not a general-purpose I/O taxonomy — precision over recall.
_BLOCKING_SUFFIXES: tuple[tuple[str, ...], ...] = (
    ("os", "stat"),
    ("os", "fstat"),
    ("os", "lstat"),
    ("os", "listdir"),
    ("os", "scandir"),
    ("os", "path", "getsize"),
    ("os", "path", "exists"),
    ("os", "path", "getmtime"),
    ("np", "load"),
    ("numpy", "load"),
    ("np", "save"),
    ("numpy", "save"),
    ("time", "sleep"),
    ("jax", "device_put"),
    ("pickle", "load"),
    ("json", "load"),
)
_BLOCKING_NAME_CALLS = frozenset({"open", "safe_open", "load_file"})
# Known project wrappers that do blocking work inside (reads, checksums,
# retry ladders with backoff sleeps, device placement).
_BLOCKING_PROJECT_CALLS = frozenset(
    {
        "plan_residency",
        "layer_stream_bytes",
        "stat_guard",
        "_stat_key",
        "build_host_shard",
        "load_layer",
        "_load_one",
        "_place",
        "retry_call",
    }
)
_BLOCKING_METHODS = frozenset({"result"})  # future.result()


def _lock_name(item: ast.withitem) -> str | None:
    chain = _dotted(item.context_expr)
    if chain and _LOCK_NAME_RE.search(chain[-1]):
        return ".".join(chain)
    return None


def _blocking_call_label(call: ast.Call) -> str | None:
    chain = _dotted(call.func)
    if chain:
        if len(chain) == 1 and chain[0] in _BLOCKING_NAME_CALLS:
            return chain[0]
        if "safetensors" in chain:
            return ".".join(chain)
        for suffix in _BLOCKING_SUFFIXES:
            if chain[-len(suffix):] == suffix:
                return ".".join(chain)
        if chain[-1] in _BLOCKING_PROJECT_CALLS:
            return ".".join(chain)
        if len(chain) >= 2 and chain[-1] in _BLOCKING_METHODS:
            return ".".join(chain) + "()"
    return None


@file_rule(
    "LOCK-IO",
    "no blocking I/O (open/stat/load/device_put/.result()/sleep) inside "
    "`with <lock>:` bodies",
)
def lock_io(info: FileInfo, ctx: ProjectContext) -> list[Finding]:
    findings: list[Finding] = []
    # A disable pragma on the `with <lock>:` line (or the line above it)
    # exempts that whole critical section — one audited reason instead of
    # one pragma per call inside.
    block_pragma_lines = {
        p.line
        for p in info.pragmas
        if p.kind == "disable" and "LOCK-IO" in p.names
    }

    class V(_SymbolWalker):
        def __init__(self) -> None:
            super().__init__()
            self.locks: list[str] = []

        def visit_With(self, node: ast.With) -> None:
            names = [n for n in (_lock_name(i) for i in node.items) if n]
            if names and (
                node.lineno in block_pragma_lines
                or node.lineno - 1 in block_pragma_lines
            ):
                names = []
            self.locks.extend(names)
            self.generic_visit(node)
            for _ in names:
                self.locks.pop()

        def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
            # A def under a lock runs LATER — fresh lock scope inside.
            saved, self.locks = self.locks, []
            _SymbolWalker.visit_FunctionDef(self, node)
            self.locks = saved

        visit_AsyncFunctionDef = visit_FunctionDef

        def visit_Lambda(self, node: ast.Lambda) -> None:
            saved, self.locks = self.locks, []
            self.generic_visit(node)
            self.locks = saved

        def visit_Call(self, node: ast.Call) -> None:
            if self.locks:
                label = _blocking_call_label(node)
                if label:
                    findings.append(
                        Finding(
                            "LOCK-IO",
                            info.path,
                            node.lineno,
                            f"blocking call `{label}` inside "
                            f"`with {self.locks[-1]}:` — do the I/O outside "
                            "the critical section",
                            symbol=self.symbol,
                        )
                    )
            self.generic_visit(node)

    V().visit(info.tree)
    return findings


# ---------------------------------------------------------------------------
# GUARDED-BY
# ---------------------------------------------------------------------------

_GUARDED_RE = re.compile(r"#\s*guarded by:\s*([A-Za-z_][A-Za-z0-9_]*)")


@file_rule(
    "GUARDED-BY",
    "attributes annotated `# guarded by: _lock` in __init__ may only be "
    "touched inside `with self._lock:` (or a method pragma'd "
    "`# flscheck: holds=_lock` / named *_locked)",
)
def guarded_by(info: FileInfo, ctx: ProjectContext) -> list[Finding]:
    findings: list[Finding] = []
    holds = [
        (p.line, set(p.names))
        for p in info.pragmas
        if p.kind == "holds"
    ]

    for cls in [n for n in ast.walk(info.tree) if isinstance(n, ast.ClassDef)]:
        init = next(
            (
                n
                for n in cls.body
                if isinstance(n, ast.FunctionDef) and n.name == "__init__"
            ),
            None,
        )
        if init is None:
            continue
        guarded: dict[str, str] = {}  # attr -> lock attr name
        for node in ast.walk(init):
            targets = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, ast.AnnAssign):
                targets = [node.target]
            for t in targets:
                if (
                    isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"
                ):
                    m = _GUARDED_RE.search(info.lines[node.lineno - 1])
                    if m:
                        guarded[t.attr] = m.group(1)
        if not guarded:
            continue

        for meth in [
            n
            for n in cls.body
            if isinstance(n, ast.FunctionDef) and n.name != "__init__"
        ]:
            end = getattr(meth, "end_lineno", meth.lineno)
            held_by_pragma = {
                name
                for line, names in holds
                if meth.lineno <= line <= end
                for name in names
            }
            if meth.name.endswith("_locked"):
                # Documented caller-holds-the-lock convention.
                held_by_pragma |= set(guarded.values())

            class M(ast.NodeVisitor):
                def __init__(self) -> None:
                    self.held: list[str] = list(held_by_pragma)

                def visit_With(self, node: ast.With) -> None:
                    names = []
                    for item in node.items:
                        chain = _dotted(item.context_expr)
                        if len(chain) == 2 and chain[0] == "self":
                            names.append(chain[1])
                    self.held.extend(names)
                    self.generic_visit(node)
                    for _ in names:
                        self.held.pop()

                def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
                    return  # nested defs run later, out of this lock scope

                visit_AsyncFunctionDef = visit_FunctionDef

                def visit_Attribute(self, node: ast.Attribute) -> None:
                    if (
                        isinstance(node.value, ast.Name)
                        and node.value.id == "self"
                        and node.attr in guarded
                        and guarded[node.attr] not in self.held
                    ):
                        findings.append(
                            Finding(
                                "GUARDED-BY",
                                info.path,
                                node.lineno,
                                f"`self.{node.attr}` is guarded by "
                                f"`{guarded[node.attr]}` but touched outside "
                                f"`with self.{guarded[node.attr]}:`",
                                symbol=f"{cls.name}.{meth.name}",
                            )
                        )
                    self.generic_visit(node)

            walker = M()
            for stmt in meth.body:  # not meth itself: its own visit_
                walker.visit(stmt)  # FunctionDef guard would skip the body
    return findings


# ---------------------------------------------------------------------------
# KNOB-SYNC
# ---------------------------------------------------------------------------

# Flag -> (config class, field) renames the parsers use on purpose.
_FLAG_ALIASES = {
    "max_new_tokens": ("ServeConfig", "default_max_new_tokens"),
    "deadline_s": ("ServeConfig", "default_deadline_s"),
    # store_true negation: the flag DISABLES the stagger field.
    "autoscale_no_stagger": ("AutoscaleConfig", "stagger"),
}
_CHAOS_PREFIX = "chaos_"
_PRESSURE_PREFIX = "pressure_"
_SCHED_PREFIX = "sched_"
_SLO_PREFIX = "slo_"
_ADAPTER_PREFIX = "adapter_"
_AUTOSCALE_PREFIX = "autoscale_"

# cli.py functions that thread parsed args into config constructions.
_BATCH_READERS = (
    "config_from_args",
    "_fault_config_from_args",
    "_pressure_config_from_args",
    "_adapter_config_from_args",
    "main",
)
_SERVE_READERS = (
    "serve_main",
    "_fault_config_from_args",
    "_pressure_config_from_args",
    "_adapter_config_from_args",
    "_sched_config_from_args",
    "_slo_config_from_args",
    "_autoscale_config_from_args",
)


def _class_fields(tree: ast.Module, class_name: str) -> set[str]:
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == class_name:
            return {
                n.target.id
                for n in node.body
                if isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name)
            }
    return set()


def _module_str_set(tree: ast.Module, name: str) -> set[str]:
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == name for t in node.targets
        ):
            value = node.value
            if (
                isinstance(value, ast.Call)
                and isinstance(value.func, ast.Name)
                and value.func.id in ("frozenset", "set", "tuple", "list")
            ):
                if not value.args:
                    return set()
                value = value.args[0]
            try:
                return set(ast.literal_eval(value))
            except ValueError:
                return set()
    return set()


def _parser_flags(tree: ast.Module) -> dict[str, dict[str, int]]:
    """function name -> {flag: line} of add_argument("--flag") calls,
    with one level of helper-function resolution (a builder that calls
    ``_add_robustness_flags(p)`` owns those flags too)."""
    own: dict[str, dict[str, int]] = {}
    calls: dict[str, set[str]] = {}
    for fn in [n for n in tree.body if isinstance(n, ast.FunctionDef)]:
        flags: dict[str, int] = {}
        called: set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                if (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr == "add_argument"
                    and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)
                    and node.args[0].value.startswith("--")
                ):
                    flags[node.args[0].value[2:]] = node.lineno
                elif isinstance(node.func, ast.Name):
                    called.add(node.func.id)
        own[fn.name] = flags
        calls[fn.name] = called
    resolved: dict[str, dict[str, int]] = {}
    for name, flags in own.items():
        merged = dict(flags)
        for helper in calls[name]:
            merged.update(own.get(helper, {}))
        resolved[name] = merged
    return resolved


def _args_reads(tree: ast.Module) -> dict[str, dict[str, int]]:
    """function name -> {attr: line} of ``args.<attr>`` reads."""
    out: dict[str, dict[str, int]] = {}
    for fn in [n for n in tree.body if isinstance(n, ast.FunctionDef)]:
        reads: dict[str, int] = {}
        for node in ast.walk(fn):
            if (
                isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "args"
            ):
                reads.setdefault(node.attr, node.lineno)
        out[fn.name] = reads
    return out


@project_rule(
    "KNOB-SYNC",
    "every FrameworkConfig/ServeConfig/SchedConfig/SLOConfig/AutoscaleConfig/"
    "FaultConfig/PressureConfig/AdapterConfig flag exists in both CLI parsers "
    "(or is declared single-parser; serving-only classes are exempt), maps to "
    "a real field, and is threaded into the construction",
)
def knob_sync(ctx: ProjectContext) -> list[Finding]:
    cli = ctx.get("cli.py")
    config = ctx.get("config.py")
    findings: list[Finding] = []
    if cli is None or config is None:
        missing = "cli.py" if cli is None else "config.py"
        return [
            Finding(
                "KNOB-SYNC", missing, 1, f"{missing} not found at the package root"
            )
        ]

    fw = _class_fields(config.tree, "FrameworkConfig")
    sv = _class_fields(config.tree, "ServeConfig")
    fc = _class_fields(config.tree, "FaultConfig")
    pc = _class_fields(config.tree, "PressureConfig")
    sc = _class_fields(config.tree, "SchedConfig")
    oc = _class_fields(config.tree, "SLOConfig")
    ac = _class_fields(config.tree, "AdapterConfig")
    uc = _class_fields(config.tree, "AutoscaleConfig")
    flags = _parser_flags(cli.tree)
    batch = flags.get("build_parser", {})
    serve = flags.get("build_serve_parser", {})
    reads = _args_reads(cli.tree)
    batch_only = _module_str_set(cli.tree, "BATCH_ONLY_FLAGS")
    serve_only = _module_str_set(cli.tree, "SERVE_ONLY_FLAGS")
    driver = _module_str_set(cli.tree, "DRIVER_FLAGS")

    def map_flag(flag: str, parser_name: str = "batch") -> tuple[str, str] | None:
        """(config class, field) a flag sets, or None for driver flags.

        Parser-aware: one flag NAME may set different config classes per
        parser (``--speculative_k`` is FrameworkConfig's offline-scorer
        knob on the batch parser and ServeConfig's serving-speculation
        knob on the serve parser), so the serve parser resolves
        ServeConfig fields FIRST — a serve flag shadowed by a same-named
        FrameworkConfig field would otherwise validate against the wrong
        class and dodge the serve-side threading checks."""
        if flag in driver:
            return None
        if flag == "chaos":
            return ("FaultConfig", "enabled") if "enabled" in fc else ("?", flag)
        if flag.startswith(_CHAOS_PREFIX) and flag[len(_CHAOS_PREFIX):] in fc:
            return ("FaultConfig", flag[len(_CHAOS_PREFIX):])
        if flag == "pressure":
            return ("PressureConfig", "enabled") if "enabled" in pc else ("?", flag)
        if flag.startswith(_PRESSURE_PREFIX) and flag[len(_PRESSURE_PREFIX):] in pc:
            return ("PressureConfig", flag[len(_PRESSURE_PREFIX):])
        if flag == "sched":
            return ("SchedConfig", "enabled") if "enabled" in sc else ("?", flag)
        if flag.startswith(_SCHED_PREFIX) and flag[len(_SCHED_PREFIX):] in sc:
            return ("SchedConfig", flag[len(_SCHED_PREFIX):])
        if flag == "slo":
            return ("SLOConfig", "enabled") if "enabled" in oc else ("?", flag)
        if flag.startswith(_SLO_PREFIX) and flag[len(_SLO_PREFIX):] in oc:
            return ("SLOConfig", flag[len(_SLO_PREFIX):])
        if flag == "autoscale":
            return (
                ("AutoscaleConfig", "enabled") if "enabled" in uc else ("?", flag)
            )
        if (
            flag.startswith(_AUTOSCALE_PREFIX)
            and flag[len(_AUTOSCALE_PREFIX):] in uc
        ):
            return ("AutoscaleConfig", flag[len(_AUTOSCALE_PREFIX):])
        # AdapterConfig (multi-tenant LoRA, adapters/): a SHARED runtime
        # subsystem like FaultConfig/PressureConfig, so adapter_ flags
        # fall through to the both-parsers requirement below.
        if flag.startswith(_ADAPTER_PREFIX) and flag[len(_ADAPTER_PREFIX):] in ac:
            return ("AdapterConfig", flag[len(_ADAPTER_PREFIX):])
        if flag in _FLAG_ALIASES:
            cls, field = _FLAG_ALIASES[flag]
            fields = {"ServeConfig": sv, "AutoscaleConfig": uc}.get(cls, fw)
            return (cls, field) if field in fields else ("?", flag)
        if parser_name == "serve" and flag in sv:
            return ("ServeConfig", flag)
        if flag in fw:
            return ("FrameworkConfig", flag)
        if flag in sv:
            return ("ServeConfig", flag)
        return ("?", flag)

    # 1. Every flag maps to a real config field (or is a declared driver
    #    flag), and shared-runtime flags live in BOTH parsers.
    for parser_name, parser, other, other_name, single_ok in (
        ("batch", batch, serve, "serve", batch_only),
        ("serve", serve, batch, "batch", serve_only),
    ):
        for flag, line in sorted(parser.items()):
            mapped = map_flag(flag, parser_name)
            if mapped is None:
                continue
            cls, field = mapped
            if cls == "?":
                findings.append(
                    Finding(
                        "KNOB-SYNC",
                        cli.path,
                        line,
                        f"--{flag} ({parser_name} parser) maps to no "
                        "FrameworkConfig/ServeConfig/FaultConfig/"
                        "PressureConfig field and is not in DRIVER_FLAGS",
                        symbol=f"parser.{parser_name}",
                    )
                )
                continue
            if cls in (
                "ServeConfig", "SchedConfig", "SLOConfig", "AutoscaleConfig"
            ):
                continue  # serving knobs are inherently serve-parser-only
            # "Shared" means the OTHER parser's same-named flag sets the
            # SAME field: a flag name reused for a different config class
            # (serve --speculative_k -> ServeConfig) does not satisfy the
            # both-parsers requirement for this parser's knob.
            shared = flag in other and map_flag(flag, other_name) == mapped
            if not shared and flag not in single_ok:
                findings.append(
                    Finding(
                        "KNOB-SYNC",
                        cli.path,
                        line,
                        f"--{flag} sets {cls}.{field} but exists only in the "
                        f"{parser_name} parser — add it to the other parser or "
                        f"declare it in "
                        f"{'BATCH' if parser_name == 'batch' else 'SERVE'}"
                        "_ONLY_FLAGS with the reason in the comment",
                        symbol=f"parser.{parser_name}",
                    )
                )

    # 2. Declared single-parser sets stay honest. A same-named flag in
    #    the other parser only voids the declaration when it sets the
    #    SAME config field — a reused name over a different class (the
    #    batch/serve --speculative_k pair) keeps both declarations valid.
    for declared, name, parser, parser_name, other, other_name in (
        (batch_only, "BATCH_ONLY_FLAGS", batch, "batch", serve, "serve"),
        (serve_only, "SERVE_ONLY_FLAGS", serve, "serve", batch, "batch"),
    ):
        for flag in sorted(declared):
            if flag not in parser:
                findings.append(
                    Finding(
                        "KNOB-SYNC",
                        cli.path,
                        1,
                        f"{name} declares --{flag} but the flag is not in "
                        "that parser (stale declaration)",
                        symbol=name,
                    )
                )
            elif flag in other and map_flag(flag, other_name) == map_flag(
                flag, parser_name
            ):
                findings.append(
                    Finding(
                        "KNOB-SYNC",
                        cli.path,
                        1,
                        f"{name} declares --{flag} single-parser but it now "
                        "exists in both parsers — drop the declaration",
                        symbol=name,
                    )
                )

    # 3. Parsed flags must be threaded: read as args.<flag> by the
    #    functions that build the configs (a flag that parses but is never
    #    read is a silent no-op — the exact recurring defect).
    for parser_name, parser, readers in (
        ("batch", batch, _BATCH_READERS),
        ("serve", serve, _SERVE_READERS),
    ):
        read_here = {a for r in readers for a in reads.get(r, {})}
        for flag, line in sorted(parser.items()):
            mapped = map_flag(flag, parser_name)
            if mapped is None or mapped[0] == "?":
                continue
            if flag not in read_here:
                findings.append(
                    Finding(
                        "KNOB-SYNC",
                        cli.path,
                        line,
                        f"--{flag} parses in the {parser_name} parser but is "
                        f"never read (args.{flag}) by "
                        f"{'/'.join(readers)} — the flag is a silent no-op",
                        symbol=f"thread.{parser_name}",
                    )
                )

    # 4. args.<attr> reads must exist in the parser feeding that function.
    #    _fault_config_from_args is called from BOTH CLI paths, so its
    #    reads are checked against EACH parser — a union would hide a flag
    #    defined in only one parser (AttributeError on the other path).
    for fn_name, parser_name, parser in (
        ("config_from_args", "batch", batch),
        ("main", "batch", batch),
        ("serve_main", "serve", serve),
        ("_fault_config_from_args", "batch", batch),
        ("_fault_config_from_args", "serve", serve),
        ("_pressure_config_from_args", "batch", batch),
        ("_pressure_config_from_args", "serve", serve),
        ("_adapter_config_from_args", "batch", batch),
        ("_adapter_config_from_args", "serve", serve),
        # Serve-path-only readers: SchedConfig/SLOConfig are serving
        # subsystems, so their reads validate against the serve parser.
        ("_sched_config_from_args", "serve", serve),
        ("_slo_config_from_args", "serve", serve),
        ("_autoscale_config_from_args", "serve", serve),
    ):
        for attr, line in sorted(reads.get(fn_name, {}).items()):
            if attr not in parser:
                findings.append(
                    Finding(
                        "KNOB-SYNC",
                        cli.path,
                        line,
                        f"{fn_name} reads args.{attr} but the {parser_name} "
                        f"parser defines no --{attr} (AttributeError at "
                        "runtime)",
                        symbol=f"read.{fn_name}",
                    )
                )
    return findings


# ---------------------------------------------------------------------------
# SITE-REG
# ---------------------------------------------------------------------------

_SITE_CALL_ATTRS = frozenset({"fire", "corrupt_flat", "corrupt_array"})
_DOC_SITE_RE = re.compile(r"^\|\s*`([a-z_]+)`")


@project_rule(
    "SITE-REG",
    "every injector.fire/corrupt_* site literal is in config.FAULT_SITES "
    "and documented in docs/faults.md; every registered site is used",
)
def site_reg(ctx: ProjectContext) -> list[Finding]:
    findings: list[Finding] = []
    config = ctx.get("config.py")
    declared: set[str] = set()
    declared_line = 1
    if config is not None:
        for node in config.tree.body:
            if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "FAULT_SITES"
                for t in node.targets
            ):
                try:
                    declared = set(ast.literal_eval(node.value))
                except ValueError:
                    pass
                declared_line = node.lineno
    if not declared:
        return [
            Finding(
                "SITE-REG",
                config.path if config else "config.py",
                declared_line,
                "config.FAULT_SITES not found (fault sites cannot be "
                "validated)",
            )
        ]

    used: dict[str, tuple[str, int]] = {}
    for info in ctx.files.values():
        if info.relkey == "faults/inject.py":
            continue  # the injector fires whatever site string it is handed
        for node in ast.walk(info.tree):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _SITE_CALL_ATTRS
                and node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)
            ):
                site = node.args[0].value
                used.setdefault(site, (info.path, node.lineno))
                if site not in declared:
                    findings.append(
                        Finding(
                            "SITE-REG",
                            info.path,
                            node.lineno,
                            f"fault site {site!r} fired but not registered in "
                            "config.FAULT_SITES",
                        )
                    )

    docs_path = ctx.repo_root / "docs" / "faults.md"
    if not docs_path.exists():
        findings.append(
            Finding(
                "SITE-REG",
                "docs/faults.md",
                1,
                "docs/faults.md missing — the fault-site table documents "
                "every registered site",
            )
        )
        documented = None
    else:
        documented = set()
        for line in docs_path.read_text().splitlines():
            m = _DOC_SITE_RE.match(line.strip())
            if m:
                documented.add(m.group(1))

    for site in sorted(declared):
        if site not in used:
            findings.append(
                Finding(
                    "SITE-REG",
                    config.path,
                    declared_line,
                    f"FAULT_SITES registers {site!r} but no call site fires "
                    "it (dead registration)",
                )
            )
        if documented is not None and site not in documented:
            findings.append(
                Finding(
                    "SITE-REG",
                    config.path,
                    declared_line,
                    f"fault site {site!r} is missing from the docs/faults.md "
                    "site table",
                )
            )
    return findings


# ---------------------------------------------------------------------------
# EVENT-REG
# ---------------------------------------------------------------------------

# Journal-emit call shapes: the module-level ``obs_events.emit("<kind>",
# ...)`` (any receiver alias) and a bare ``emit("<kind>", ...)`` import.
# Only calls whose FIRST argument is a string literal are vocabulary
# uses; dynamic kinds are the journal's own plumbing (events.py is
# excluded like inject.py is for SITE-REG).
_EVENT_EMIT_NAMES = frozenset({"emit"})
_EVENTS_MODULE = "obs/events.py"


@project_rule(
    "EVENT-REG",
    "every journal event kind literal (`emit(\"<kind>\")`) is declared "
    "in obs/events.EVENT_KINDS and documented in docs/incidents.md's "
    "kinds table; every declared kind is emitted somewhere",
)
def event_reg(ctx: ProjectContext) -> list[Finding]:
    findings: list[Finding] = []
    events = ctx.get(_EVENTS_MODULE)
    declared: set[str] = set()
    declared_line = 1
    if events is not None:
        for node in events.tree.body:
            if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "EVENT_KINDS"
                for t in node.targets
            ):
                try:
                    # A dict literal literal_evals to a dict; its key
                    # set is the declared vocabulary.
                    declared = set(ast.literal_eval(node.value))
                except ValueError:
                    pass
                declared_line = node.lineno
    if not declared:
        return [
            Finding(
                "EVENT-REG",
                events.path if events else _EVENTS_MODULE,
                declared_line,
                "obs/events.EVENT_KINDS not found (journal event kinds "
                "cannot be validated)",
            )
        ]

    used: dict[str, tuple[str, int]] = {}
    for info in ctx.files.values():
        if info.relkey == _EVENTS_MODULE:
            continue  # the journal records whatever kind it is handed
        for node in ast.walk(info.tree):
            if not (isinstance(node, ast.Call) and node.args):
                continue
            fn = node.func
            name = (
                fn.attr
                if isinstance(fn, ast.Attribute)
                else fn.id if isinstance(fn, ast.Name) else None
            )
            if name not in _EVENT_EMIT_NAMES:
                continue
            arg = node.args[0]
            if not (isinstance(arg, ast.Constant) and isinstance(arg.value, str)):
                continue
            kind = arg.value
            used.setdefault(kind, (info.path, node.lineno))
            if kind not in declared:
                findings.append(
                    Finding(
                        "EVENT-REG",
                        info.path,
                        node.lineno,
                        f"journal event kind {kind!r} emitted but not "
                        "declared in obs/events.EVENT_KINDS",
                    )
                )

    docs_path = ctx.repo_root / "docs" / "incidents.md"
    if not docs_path.exists():
        findings.append(
            Finding(
                "EVENT-REG",
                "docs/incidents.md",
                1,
                "docs/incidents.md missing — the kinds table documents "
                "every declared journal event kind",
            )
        )
        documented = None
    else:
        documented = set()
        for line in docs_path.read_text().splitlines():
            m = _DOC_SITE_RE.match(line.strip())
            if m:
                documented.add(m.group(1))

    for kind in sorted(declared):
        if kind not in used:
            findings.append(
                Finding(
                    "EVENT-REG",
                    events.path,
                    declared_line,
                    f"EVENT_KINDS declares {kind!r} but no call site "
                    "emits it (dead registration)",
                )
            )
        if documented is not None and kind not in documented:
            findings.append(
                Finding(
                    "EVENT-REG",
                    events.path,
                    declared_line,
                    f"journal event kind {kind!r} is missing from the "
                    "docs/incidents.md kinds table",
                )
            )
    return findings


# ---------------------------------------------------------------------------
# EXC-TAXONOMY
# ---------------------------------------------------------------------------

_EXC_SCOPES = ("runtime/", "serve/", "faults/")
_BROAD_NAMES = frozenset({"Exception", "BaseException"})


def _is_broad(handler: ast.ExceptHandler) -> str | None:
    t = handler.type
    if t is None:
        return "bare except"
    names = [t] if not isinstance(t, ast.Tuple) else list(t.elts)
    for n in names:
        chain = _dotted(n)
        if chain and chain[-1] in _BROAD_NAMES:
            return f"except {chain[-1]}"
    return None


def _walk_pruned(root: ast.AST):
    """``ast.walk`` that never descends into nested def/lambda bodies: a
    ``raise`` scheduled inside a nested function is not the handler itself
    raising (it runs later, if ever), so it neither excuses a swallow nor
    needs `from` chaining."""
    if isinstance(root, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
        return
    stack = [root]
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
            ):
                continue
            stack.append(child)


def _contains_raise(body: list[ast.stmt]) -> bool:
    for stmt in body:
        for node in _walk_pruned(stmt):
            if isinstance(node, ast.Raise):
                return True
    return False


@file_rule(
    "EXC-TAXONOMY",
    "hot paths (runtime/, serve/, faults/) must not swallow broad excepts "
    "without a pragma; re-raises of new exceptions must chain `from`",
)
def exc_taxonomy(info: FileInfo, ctx: ProjectContext) -> list[Finding]:
    if not info.relkey.startswith(_EXC_SCOPES):
        return []
    findings: list[Finding] = []

    class V(_SymbolWalker):
        def visit_ExceptHandler(self, node: ast.ExceptHandler) -> None:
            broad = _is_broad(node)
            if broad and not _contains_raise(node.body):
                findings.append(
                    Finding(
                        "EXC-TAXONOMY",
                        info.path,
                        node.lineno,
                        f"`{broad}` swallows and continues — narrow it to the "
                        "typed errors the handler really expects "
                        "(ShardLoadError/ShardCorruptError/OSError/queue."
                        "Empty/...), or pragma with the degrade rationale",
                        symbol=self.symbol,
                    )
                )
            for stmt in node.body:
                for sub in _walk_pruned(stmt):
                    if (
                        isinstance(sub, ast.Raise)
                        and isinstance(sub.exc, ast.Call)
                        and sub.cause is None
                    ):
                        findings.append(
                            Finding(
                                "EXC-TAXONOMY",
                                info.path,
                                sub.lineno,
                                "raising a new exception inside an except "
                                "block must chain the original "
                                "(`raise X(...) from err`) so both "
                                "tracebacks survive",
                                symbol=self.symbol,
                            )
                        )
            self.generic_visit(node)

    V().visit(info.tree)
    return findings


# ---------------------------------------------------------------------------
# COUNTER-EXPORT
# ---------------------------------------------------------------------------

_EXPORT_METHODS = frozenset({"stats", "snapshot"})
_INTEGRITY_RECEIVERS = frozenset({"integrity", "_integrity"})


def _class_registered_methods(cls: ast.ClassDef) -> frozenset:
    """Method names THIS class registers as metrics-registry sources:
    a ``<reg>.register("name", self.method)`` call anywhere in the class
    body marks ``method`` as one of the class's export surfaces
    (obs/registry.py collects registered sources into the Prometheus
    exposition / --metrics_out dump), so a counter that reaches such a
    method IS exported — the registry path satisfies COUNTER-EXPORT
    exactly like stats()/snapshot() do. Scoped to ``self.<method>``
    registrations inside the SAME class on purpose: a project-wide bag of
    bare method names would let any class whose method merely shares a
    name with someone else's registered source pass unexported."""
    names: set[str] = set()
    for node in ast.walk(cls):
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "register"
            and len(node.args) >= 2
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
            and isinstance(node.args[1], ast.Attribute)
            and isinstance(node.args[1].value, ast.Name)
            and node.args[1].value.id == "self"
        ):
            names.add(node.args[1].attr)
    return frozenset(names)


def _export_names(fns: list[ast.FunctionDef]) -> tuple[set[str], set[str]]:
    """(self.<attr> names, string constants) the export methods mention —
    exact AST nodes, so `self.hits_total` does not pass for `self.hits`
    and a counter named only in a comment/docstring line doesn't count."""
    attrs: set[str] = set()
    strs: set[str] = set()
    for fn in fns:
        for node in ast.walk(fn):
            if (
                isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"
            ):
                attrs.add(node.attr)
            elif isinstance(node, ast.Constant) and isinstance(node.value, str):
                strs.add(node.value)
    return attrs, strs


@project_rule(
    "COUNTER-EXPORT",
    "counters a class increments (self.x += n) must appear in its "
    "stats()/snapshot() export or in a method the class itself registers "
    "as a metrics-registry source (register(\"name\", self.method)); "
    "IntegrityRecorder.count() names must be registered in its KEYS",
)
def counter_export(ctx: ProjectContext) -> list[Finding]:
    findings: list[Finding] = []

    # 1. Class-attribute counters vs the class's export methods: the
    #    canonical stats()/snapshot() names, plus any method THE CLASS
    #    ITSELF registers into a metrics registry
    #    (``reg.register("src", self.method)``) — registered sources land
    #    in the Prometheus exposition and the --metrics_out dump, which
    #    is precisely "exported".
    for info in ctx.files.values():
        for cls in [n for n in ast.walk(info.tree) if isinstance(n, ast.ClassDef)]:
            registered = _class_registered_methods(cls)
            exporters = [
                n
                for n in cls.body
                if isinstance(n, ast.FunctionDef)
                and (n.name in _EXPORT_METHODS or n.name in registered)
            ]
            if not exporters:
                continue
            export_attrs, export_strs = _export_names(exporters)
            seen: set[str] = set()
            for meth in [n for n in cls.body if isinstance(n, ast.FunctionDef)]:
                for node in ast.walk(meth):
                    if (
                        isinstance(node, ast.AugAssign)
                        and isinstance(node.op, (ast.Add, ast.Sub))
                        and isinstance(node.target, ast.Attribute)
                        and isinstance(node.target.value, ast.Name)
                        and node.target.value.id == "self"
                        and not node.target.attr.startswith("_")
                        and node.target.attr not in seen
                    ):
                        attr = node.target.attr
                        seen.add(attr)
                        if attr not in export_attrs and attr not in export_strs:
                            findings.append(
                                Finding(
                                    "COUNTER-EXPORT",
                                    info.path,
                                    node.lineno,
                                    f"counter `self.{attr}` is incremented but "
                                    f"never exported by {cls.name}."
                                    f"{'/'.join(m.name for m in exporters)}()",
                                    symbol=f"{cls.name}.{meth.name}",
                                )
                            )

    # 2. IntegrityRecorder counter names must be in its KEYS registry.
    metrics = ctx.get("utils/metrics.py")
    keys: set[str] = set()
    if metrics is not None:
        for cls in [
            n for n in ast.walk(metrics.tree) if isinstance(n, ast.ClassDef)
        ]:
            if cls.name != "IntegrityRecorder":
                continue
            for node in cls.body:
                if isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == "KEYS" for t in node.targets
                ):
                    try:
                        keys = set(ast.literal_eval(node.value))
                    except ValueError:
                        pass
    if keys:
        for info in ctx.files.values():
            for node in ast.walk(info.tree):
                if (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "count"
                    and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)
                ):
                    recv = _dotted(node.func)
                    if len(recv) >= 2 and recv[-2] in _INTEGRITY_RECEIVERS:
                        name = node.args[0].value
                        if name not in keys:
                            findings.append(
                                Finding(
                                    "COUNTER-EXPORT",
                                    info.path,
                                    node.lineno,
                                    f"integrity counter {name!r} is not in "
                                    "IntegrityRecorder.KEYS — it would count "
                                    "but never export",
                                )
                            )
    return findings


# ---------------------------------------------------------------------------
# DETERMINISM
# ---------------------------------------------------------------------------

_DET_SCOPES = ("faults/", "integrity/")


@file_rule(
    "DETERMINISM",
    "faults/ and integrity/ promise seeded reproducibility: no random.* / "
    "np.random.* / time.time() — derive draws via hash_unit and seeds",
)
def determinism(info: FileInfo, ctx: ProjectContext) -> list[Finding]:
    if not info.relkey.startswith(_DET_SCOPES):
        return []
    findings: list[Finding] = []

    class V(_SymbolWalker):
        def visit_Call(self, node: ast.Call) -> None:
            chain = _dotted(node.func)
            bad = None
            if chain[:1] == ("random",) and len(chain) > 1:
                bad = "random." + ".".join(chain[1:])
            elif chain[:2] in (("np", "random"), ("numpy", "random")):
                bad = ".".join(chain)
            elif chain == ("time", "time"):
                bad = "time.time()"
            if bad:
                findings.append(
                    Finding(
                        "DETERMINISM",
                        info.path,
                        node.lineno,
                        f"`{bad}` in a seeded-reproducibility module — use "
                        "hash_unit(seed-derived key) / time.monotonic so a "
                        "chaos schedule replays bit-for-bit",
                        symbol=self.symbol,
                    )
                )
            self.generic_visit(node)

    V().visit(info.tree)
    return findings


# ---------------------------------------------------------------------------
# QUANT-MANIFEST
# ---------------------------------------------------------------------------


@file_rule(
    "QUANT-MANIFEST",
    "every function that writes a layer safetensors file (st_save_file/"
    "save_file) must record an integrity-manifest entry for it "
    "(integrity_manifest.layer_entry) in the same function — layer_entry "
    "is what stamps the per-layer dtype kind, so a writer that skips it "
    "emits quantized leaf-groups the executor's precision check "
    "(PrecisionMismatch) can never audit",
)
def quant_manifest(info: FileInfo, ctx: ProjectContext) -> list[Finding]:
    findings: list[Finding] = []

    def _is_save(chain: tuple[str, ...]) -> bool:
        return bool(chain) and chain[-1] in ("st_save_file", "save_file")

    def _is_entry(chain: tuple[str, ...]) -> bool:
        return bool(chain) and chain[-1] == "layer_entry"

    class V(_SymbolWalker):
        def _scan(self, fn: ast.AST) -> None:
            # Direct statements only: a nested def is its own scope and
            # is scanned on its own visit (save_params pairs the calls
            # inside its nested _save, which is the pairing that counts).
            saves: list[ast.Call] = []
            paired = False
            for stmt in fn.body:
                for node in _walk_pruned(stmt):
                    if not isinstance(node, ast.Call):
                        continue
                    chain = _dotted(node.func)
                    if _is_save(chain):
                        saves.append(node)
                    elif _is_entry(chain):
                        paired = True
            if saves and not paired:
                findings.append(
                    Finding(
                        "QUANT-MANIFEST",
                        info.path,
                        saves[0].lineno,
                        "writes a layer safetensors file without recording "
                        "an integrity_manifest.layer_entry in the same "
                        "function — the manifest's per-layer dtype kind is "
                        "what lets the load path type a precision mismatch",
                        symbol=self.symbol,
                    )
                )

        def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
            self.stack.append(node.name)
            self._scan(node)
            self.generic_visit(node)
            self.stack.pop()

        visit_AsyncFunctionDef = visit_FunctionDef

    V().visit(info.tree)
    return findings


# ---------------------------------------------------------------------------
# HYGIENE
# ---------------------------------------------------------------------------


@project_rule(
    "HYGIENE",
    "no package dirs without __init__.py, no stray dirs holding only "
    "__pycache__ (they shadow real packages in greps and imports)",
)
def hygiene(ctx: ProjectContext) -> list[Finding]:
    findings: list[Finding] = []
    for dirpath, dirnames, filenames in os.walk(ctx.package_dir):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        rel = os.path.relpath(dirpath, ctx.package_dir)
        try:
            display = os.path.relpath(dirpath, ctx.repo_root)
        except ValueError:
            display = rel
        real_files = [f for f in filenames if not f.endswith(".pyc")]
        if not real_files and not dirnames:
            findings.append(
                Finding(
                    "HYGIENE",
                    display,
                    1,
                    "stray directory (empty or __pycache__-only) — delete it; "
                    "it shadows real modules in greps",
                )
            )
            continue
        if rel != "." and any(f.endswith(".py") for f in real_files):
            if "__init__.py" not in real_files:
                findings.append(
                    Finding(
                        "HYGIENE",
                        display,
                        1,
                        "package directory without __init__.py — modules here "
                        "import inconsistently across tools",
                    )
                )
    return findings
