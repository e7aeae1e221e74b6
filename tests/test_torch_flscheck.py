"""The port's copy of the flscheck static analyzer
(``flexible_llm_sharding_tpu_torch/analysis``), held to the JAX package's:
each rule proven on a positive fixture (the violation is detected) AND a
negative one (clean / pragma'd / baselined code passes), the pragma +
baseline machinery, a KNOB-SYNC run against a deliberately desynced copy
of the port's REAL cli.py, the equality oracle (both analyzers give the
same findings on both packages with every pragma stripped), the port
clean under its own empty baseline, and regression pins for the port's
narrowed handlers (queue-drain narrowing, wave-init taxonomy, off-lock
re-planning, off-lock prefetch waits)."""

import io
import json
import re
import shutil
import threading
import tokenize
import types
from pathlib import Path
from queue import Queue

import pytest

import flexible_llm_sharding_tpu
import flexible_llm_sharding_tpu_torch
from flexible_llm_sharding_tpu_torch.analysis import analyze_source, run
from flexible_llm_sharding_tpu_torch.analysis.core import (
    Finding,
    load_baseline,
    write_baseline,
)

PKG_DIR = Path(flexible_llm_sharding_tpu_torch.__file__).parent
REPO_ROOT = PKG_DIR.parent
JAX_PKG_DIR = Path(flexible_llm_sharding_tpu.__file__).parent


@pytest.fixture(scope="module")
def port_result():
    """The port's analyzer over the port, under its committed baseline (one
    run shared by the clean checks)."""
    return run(PKG_DIR, repo_root=REPO_ROOT)


def rules_of(findings):
    return [f.rule for f in findings]


def msgs(findings, rule=None):
    return [f.message for f in findings if rule is None or f.rule == rule]


# ---------------------------------------------------------------------------
# Fixture-package helper for project rules
# ---------------------------------------------------------------------------


def make_pkg(tmp_path, files, docs=None, name="pkg"):
    pkg = tmp_path / name
    pkg.mkdir(exist_ok=True)
    (pkg / "__init__.py").write_text("")
    for rel, src in files.items():
        p = pkg / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(src)
    if docs is not None:
        (tmp_path / "docs").mkdir(exist_ok=True)
        (tmp_path / "docs" / "faults.md").write_text(docs)
    return pkg


def run_pkg(pkg, select=None):
    return run(pkg, repo_root=pkg.parent, baseline_path="", select=select)


# ---------------------------------------------------------------------------
# LOCK-IO
# ---------------------------------------------------------------------------

LOCK_IO_BAD = """
import os, threading
_lock = threading.Lock()
def f(p):
    with _lock:
        return os.stat(p)
"""


def test_lock_io_positive():
    found = analyze_source(LOCK_IO_BAD, "runtime/x.py", select=["LOCK-IO"])
    assert rules_of(found) == ["LOCK-IO"]
    assert "os.stat" in found[0].message


def test_lock_io_result_and_sleep_positive():
    src = """
import time, threading
class C:
    def f(self, fut):
        with self._close_lock:
            fut.result()
            time.sleep(1)
"""
    found = analyze_source(src, "utils/x.py", select=["LOCK-IO"])
    assert len(found) == 2
    assert any("result" in m for m in msgs(found))


def test_lock_io_negative_outside_lock_and_nested_def():
    src = """
import os, threading
_lock = threading.Lock()
def f(p):
    os.stat(p)
    with _lock:
        def later():
            return os.stat(p)  # runs outside the critical section
        return later
"""
    assert analyze_source(src, "x.py", select=["LOCK-IO"]) == []


def test_lock_io_block_pragma_negative():
    src = """
import os, threading
_lock = threading.Lock()
def f(p):
    # flscheck: disable=LOCK-IO: one-time lazy init, waiters want the wait
    with _lock:
        return os.stat(p)
"""
    assert analyze_source(src, "x.py", select=["LOCK-IO"]) == []


# ---------------------------------------------------------------------------
# GUARDED-BY
# ---------------------------------------------------------------------------

GUARDED_SRC = """
import threading
class C:
    def __init__(self):
        self._lock = threading.Lock()
        self._items = []  # guarded by: _lock
    def good(self):
        with self._lock:
            self._items.append(1)
    def bad(self):
        return len(self._items)
    def _pop_locked(self):
        return self._items.pop()
    def helper(self):
        # flscheck: holds=_lock: internal, caller owns the lock
        return self._items[0]
"""


def test_guarded_by_positive_and_negatives():
    found = analyze_source(GUARDED_SRC, "x.py", select=["GUARDED-BY"])
    assert rules_of(found) == ["GUARDED-BY"]
    assert found[0].symbol == "C.bad"
    assert "_items" in found[0].message


def test_guarded_by_init_writes_allowed():
    src = """
import threading
class C:
    def __init__(self):
        self._lock = threading.Lock()
        self._items = []  # guarded by: _lock
        self._items.append(0)
"""
    assert analyze_source(src, "x.py", select=["GUARDED-BY"]) == []


# ---------------------------------------------------------------------------
# EXC-TAXONOMY
# ---------------------------------------------------------------------------


def test_exc_swallow_positive():
    src = """
def f():
    try:
        g()
    except Exception:
        pass
"""
    found = analyze_source(src, "runtime/x.py", select=["EXC-TAXONOMY"])
    assert rules_of(found) == ["EXC-TAXONOMY"]
    assert "swallows" in found[0].message


def test_exc_unchained_reraise_positive():
    src = """
def f():
    try:
        g()
    except Exception as e:
        raise RuntimeError("boom")
"""
    found = analyze_source(src, "serve/x.py", select=["EXC-TAXONOMY"])
    assert any("chain" in m for m in msgs(found))


def test_exc_negatives():
    typed = """
def f():
    try:
        g()
    except ValueError:
        pass
def h():
    try:
        g()
    except Exception as e:
        raise RuntimeError("boom") from e
"""
    assert analyze_source(typed, "faults/x.py", select=["EXC-TAXONOMY"]) == []
    # Same swallow outside the hot-path scope: not this rule's business.
    swallow = "def f():\n    try:\n        g()\n    except Exception:\n        pass\n"
    assert analyze_source(swallow, "utils/x.py", select=["EXC-TAXONOMY"]) == []
    pragma = (
        "def f():\n    try:\n        g()\n"
        "    except Exception:  # flscheck: disable=EXC-TAXONOMY: degrade by design\n"
        "        pass\n"
    )
    assert analyze_source(pragma, "runtime/x.py", select=["EXC-TAXONOMY"]) == []


def test_exc_swallow_nested_def_raise_does_not_excuse():
    # A raise inside a nested def runs later (if ever) — the handler still
    # swallows-and-continues, so the finding must fire.
    src = """
def f(schedule):
    try:
        g()
    except Exception:
        def _later():
            raise ValueError("later")
        schedule(_later)
"""
    found = analyze_source(src, "runtime/x.py", select=["EXC-TAXONOMY"])
    assert rules_of(found) == ["EXC-TAXONOMY"]
    assert "swallows" in found[0].message


def test_exc_unchained_raise_after_nested_def_still_flagged():
    # A nested def earlier in the handler must not mask an unchained
    # re-raise later in the same statement walk.
    src = """
def f(a):
    try:
        g()
    except Exception as e:
        if a:
            def h():
                pass
        else:
            raise RuntimeError("boom")
"""
    found = analyze_source(src, "runtime/x.py", select=["EXC-TAXONOMY"])
    assert any("chain" in m for m in msgs(found))
    # Conversely an unchained raise INSIDE the nested def is not the
    # handler re-raising — only the swallow finding fires.
    src2 = """
def f(schedule):
    try:
        g()
    except Exception:
        def h():
            raise RuntimeError("later")
        schedule(h)
"""
    found2 = analyze_source(src2, "runtime/x.py", select=["EXC-TAXONOMY"])
    assert not any("chain" in m for m in msgs(found2))
    assert any("swallows" in m for m in msgs(found2))


# ---------------------------------------------------------------------------
# DETERMINISM
# ---------------------------------------------------------------------------


def test_determinism_positive_and_negative():
    src = """
import random, time
def f():
    if random.random() < 0.5:
        return time.time()
    return time.monotonic()
"""
    found = analyze_source(src, "faults/x.py", select=["DETERMINISM"])
    assert len(found) == 2  # random.random and time.time; monotonic is fine
    assert analyze_source(src, "runtime/x.py", select=["DETERMINISM"]) == []


# ---------------------------------------------------------------------------
# Pragma hygiene
# ---------------------------------------------------------------------------


def test_pragma_without_reason_and_unknown_rule_flagged():
    src = """
def f():
    try:
        g()
    except Exception:  # flscheck: disable=EXC-TAXONOMY
        pass
"""
    found = analyze_source(src, "runtime/x.py")
    assert "PRAGMA" in rules_of(found)  # reasonless pragma
    # ... and the reasonless pragma still suppresses nothing? It does
    # suppress (the syntax matched) — but the PRAGMA finding keeps CI red.
    src2 = "x = 1  # flscheck: disable=NO-SUCH-RULE: whatever\n"
    found2 = analyze_source(src2, "x.py")
    assert any("unknown rule" in m for m in msgs(found2, "PRAGMA"))


def test_holds_pragma_without_reason_flagged():
    # holds= exempts GUARDED-BY exactly like disable= exempts its rules —
    # a reasonless holds pragma must keep CI red, not silently pass.
    src = """
import threading

class C:
    def __init__(self):
        self._lock = threading.Lock()
        self.n = 0  # guarded by: _lock

    def bump(self):  # flscheck: holds=_lock
        self.n += 1
"""
    found = analyze_source(src, "runtime/x.py")
    assert "GUARDED-BY" not in rules_of(found)  # the pragma does suppress
    assert any("needs a reason" in m for m in msgs(found, "PRAGMA"))
    reasoned = src.replace(
        "# flscheck: holds=_lock",
        "# flscheck: holds=_lock: caller owns the lock",
    )
    assert analyze_source(reasoned, "runtime/x.py") == []


def test_pragma_in_string_or_docstring_is_inert():
    # Pragma-shaped TEXT is not a pragma: a docstring documenting the
    # syntax must not trip reason hygiene, and a string constant sitting
    # above a violation must not suppress it.
    src = '''
def f():
    """Suppress with `# flscheck: disable=EXC-TAXONOMY` on the line."""
    try:
        g()
    except Exception:
        pass
'''
    found = analyze_source(src, "runtime/x.py")
    assert "PRAGMA" not in rules_of(found)  # the docstring example is inert
    assert "EXC-TAXONOMY" in rules_of(found)
    src2 = """
def f():
    try:
        g()
    except Exception:
        x = "# flscheck: disable=EXC-TAXONOMY: not a real pragma"
        pass
"""
    found2 = analyze_source(src2, "runtime/x.py")
    assert "EXC-TAXONOMY" in rules_of(found2)  # the string suppresses nothing


def test_select_unknown_rule_fails_loudly(capsys):
    from flexible_llm_sharding_tpu_torch.analysis.core import main as check_main

    assert check_main(["--select", "LOCKIO", "--baseline", "none"]) == 2
    err = capsys.readouterr().err
    assert "unknown rule" in err and "LOCKIO" in err
    assert check_main(["--select", "HYGIENE", "--baseline", "none"]) == 0


# ---------------------------------------------------------------------------
# KNOB-SYNC (fixture package)
# ---------------------------------------------------------------------------

KNOB_CONFIG = """
import dataclasses

@dataclasses.dataclass
class FaultConfig:
    enabled: bool = False
    seed: int = 0

@dataclasses.dataclass
class FrameworkConfig:
    alpha: int = 1
    beta: int = 2

@dataclasses.dataclass
class ServeConfig:
    default_max_new_tokens: int = 16
"""

KNOB_CLI = """
BATCH_ONLY_FLAGS = frozenset({"beta"})
SERVE_ONLY_FLAGS = frozenset()
DRIVER_FLAGS = frozenset({"prompt_pickle"})

def _add_robustness_flags(p):
    p.add_argument("--alpha", type=int, default=1)

def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--prompt_pickle", type=str)
    p.add_argument("--beta", type=int, default=2)
    _add_robustness_flags(p)
    return p

def build_serve_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--max_new_tokens", type=int, default=16)
    _add_robustness_flags(p)
    return p

def config_from_args(args):
    return FrameworkConfig(alpha=args.alpha, beta=args.beta)

def serve_main(args):
    cfg = FrameworkConfig(alpha=args.alpha)
    sc = ServeConfig(default_max_new_tokens=args.max_new_tokens)
"""


def test_knob_sync_clean_fixture(tmp_path):
    pkg = make_pkg(tmp_path, {"config.py": KNOB_CONFIG, "cli.py": KNOB_CLI})
    res = run_pkg(pkg, select=["KNOB-SYNC"])
    assert res.findings == []


def test_knob_sync_detects_unknown_flag_and_silent_noop(tmp_path):
    cli = KNOB_CLI.replace(
        'p.add_argument("--prompt_pickle", type=str)',
        'p.add_argument("--prompt_pickle", type=str)\n'
        '    p.add_argument("--gamma", type=int)',
    )
    pkg = make_pkg(tmp_path, {"config.py": KNOB_CONFIG, "cli.py": cli})
    res = run_pkg(pkg, select=["KNOB-SYNC"])
    assert any("--gamma" in m for m in msgs(res.findings, "KNOB-SYNC"))


def test_knob_sync_detects_single_parser_drift(tmp_path):
    # A FrameworkConfig knob added to the batch parser only, with no
    # declaration — the exact recurring review defect.
    cli = KNOB_CLI.replace('BATCH_ONLY_FLAGS = frozenset({"beta"})',
                           "BATCH_ONLY_FLAGS = frozenset()")
    pkg = make_pkg(tmp_path, {"config.py": KNOB_CONFIG, "cli.py": cli})
    res = run_pkg(pkg, select=["KNOB-SYNC"])
    assert any(
        "--beta" in m and "only in the batch parser" in m
        for m in msgs(res.findings, "KNOB-SYNC")
    )


def test_knob_sync_detects_unthreaded_flag(tmp_path):
    # Flag parses but the construction never reads it: silent no-op.
    cli = KNOB_CLI.replace("alpha=args.alpha, beta=args.beta", "alpha=args.alpha")
    pkg = make_pkg(tmp_path, {"config.py": KNOB_CONFIG, "cli.py": cli})
    res = run_pkg(pkg, select=["KNOB-SYNC"])
    assert any(
        "--beta" in m and "silent no-op" in m
        for m in msgs(res.findings, "KNOB-SYNC")
    )


def test_knob_sync_spec_knob_one_name_two_classes(tmp_path):
    """The speculative_k shape: ONE flag name on both parsers setting
    DIFFERENT config classes (batch -> FrameworkConfig's offline knob,
    serve -> ServeConfig's serving knob). Parser-aware mapping keeps the
    clean layout clean: the batch side stays validly declared
    BATCH_ONLY (the serve parser's same-named flag is a different knob,
    so it neither voids the declaration nor counts as 'shared')."""
    config = KNOB_CONFIG.replace(
        "class FrameworkConfig:\n    alpha: int = 1",
        "class FrameworkConfig:\n    alpha: int = 1\n    speculative_k: int = 0",
    ).replace(
        "class ServeConfig:\n    default_max_new_tokens: int = 16",
        "class ServeConfig:\n    default_max_new_tokens: int = 16\n"
        "    speculative_k: int = 0",
    )
    cli = KNOB_CLI.replace(
        'BATCH_ONLY_FLAGS = frozenset({"beta"})',
        'BATCH_ONLY_FLAGS = frozenset({"beta", "speculative_k"})',
    ).replace(
        'p.add_argument("--beta", type=int, default=2)',
        'p.add_argument("--beta", type=int, default=2)\n'
        '    p.add_argument("--speculative_k", type=int, default=0)',
    ).replace(
        'p.add_argument("--max_new_tokens", type=int, default=16)',
        'p.add_argument("--max_new_tokens", type=int, default=16)\n'
        '    p.add_argument("--speculative_k", type=int, default=0)',
    ).replace(
        "return FrameworkConfig(alpha=args.alpha, beta=args.beta)",
        "return FrameworkConfig(alpha=args.alpha, beta=args.beta, "
        "speculative_k=args.speculative_k)",
    ).replace(
        "sc = ServeConfig(default_max_new_tokens=args.max_new_tokens)",
        "sc = ServeConfig(default_max_new_tokens=args.max_new_tokens, "
        "speculative_k=args.speculative_k)",
    )
    pkg = make_pkg(tmp_path, {"config.py": config, "cli.py": cli})
    res = run_pkg(pkg, select=["KNOB-SYNC"])
    assert res.findings == []


def test_knob_sync_spec_knob_serve_reader_validation(tmp_path):
    """Negative half of the spec-knob extension: the serve parser's
    --speculative_k resolves to ServeConfig, so serve_main must actually
    READ args.speculative_k — dropping the read is a silent no-op
    finding AGAINST THE SERVE PARSER (the batch parser's own read of the
    same-named FrameworkConfig knob must not mask it)."""
    config = KNOB_CONFIG.replace(
        "class FrameworkConfig:\n    alpha: int = 1",
        "class FrameworkConfig:\n    alpha: int = 1\n    speculative_k: int = 0",
    ).replace(
        "class ServeConfig:\n    default_max_new_tokens: int = 16",
        "class ServeConfig:\n    default_max_new_tokens: int = 16\n"
        "    speculative_k: int = 0",
    )
    cli = KNOB_CLI.replace(
        'BATCH_ONLY_FLAGS = frozenset({"beta"})',
        'BATCH_ONLY_FLAGS = frozenset({"beta", "speculative_k"})',
    ).replace(
        'p.add_argument("--beta", type=int, default=2)',
        'p.add_argument("--beta", type=int, default=2)\n'
        '    p.add_argument("--speculative_k", type=int, default=0)',
    ).replace(
        'p.add_argument("--max_new_tokens", type=int, default=16)',
        'p.add_argument("--max_new_tokens", type=int, default=16)\n'
        '    p.add_argument("--speculative_k", type=int, default=0)',
    ).replace(
        "return FrameworkConfig(alpha=args.alpha, beta=args.beta)",
        "return FrameworkConfig(alpha=args.alpha, beta=args.beta, "
        "speculative_k=args.speculative_k)",
    )
    # serve_main never reads args.speculative_k.
    pkg = make_pkg(tmp_path, {"config.py": config, "cli.py": cli})
    res = run_pkg(pkg, select=["KNOB-SYNC"])
    assert any(
        "--speculative_k" in m and "serve" in m and "silent no-op" in m
        for m in msgs(res.findings, "KNOB-SYNC")
    )


def test_knob_sync_shared_reader_requires_flag_in_both_parsers(tmp_path):
    # _fault_config_from_args runs on BOTH CLI paths: a chaos flag parsed
    # only by the serve parser — even declared SERVE_ONLY, which silences
    # the both-parsers check — that the shared reader reads would
    # AttributeError on every batch run. The read check must validate
    # against EACH parser, not their union.
    cli = KNOB_CLI.replace(
        "SERVE_ONLY_FLAGS = frozenset()",
        'SERVE_ONLY_FLAGS = frozenset({"chaos_seed"})',
    ).replace(
        'p.add_argument("--max_new_tokens", type=int, default=16)',
        'p.add_argument("--max_new_tokens", type=int, default=16)\n'
        '    p.add_argument("--chaos_seed", type=int, default=0)',
    ) + """
def _fault_config_from_args(args):
    return FaultConfig(seed=args.chaos_seed)
"""
    pkg = make_pkg(tmp_path, {"config.py": KNOB_CONFIG, "cli.py": cli})
    res = run_pkg(pkg, select=["KNOB-SYNC"])
    assert any(
        "args.chaos_seed" in m and "batch parser defines no" in m
        for m in msgs(res.findings, "KNOB-SYNC")
    )


def test_knob_sync_real_cli_clean_and_desynced_copy_fires(tmp_path):
    """The acceptance fixture: the REAL cli.py/config.py pair is in sync,
    and a deliberately desynced copy (one flag renamed in both parsers
    while the construction still reads the old name) trips the rule."""
    files = {
        "cli.py": (PKG_DIR / "cli.py").read_text(),
        "config.py": (PKG_DIR / "config.py").read_text(),
    }
    pkg = make_pkg(tmp_path, files, name="realpkg")
    res = run_pkg(pkg, select=["KNOB-SYNC"])
    assert res.findings == [], [f.format() for f in res.findings]

    files["cli.py"] = files["cli.py"].replace('"--host_cache_gb"', '"--host_cache_gbx"')
    pkg2 = make_pkg(tmp_path, files, name="desynced")
    res2 = run_pkg(pkg2, select=["KNOB-SYNC"])
    assert any("host_cache_gb" in m for m in msgs(res2.findings, "KNOB-SYNC"))


# ---------------------------------------------------------------------------
# SITE-REG (fixture package)
# ---------------------------------------------------------------------------

SITE_CONFIG = 'FAULT_SITES = ("good_site", "unused_site")\n'
SITE_MOD = """
def f(inj, arr):
    inj.fire("good_site")
    inj.fire("rogue_site")
    return inj.corrupt_array("good_site", arr)
"""
SITE_DOCS = "| `good_site` | somewhere |\n| `unused_site` | elsewhere |\n"


def test_site_reg_positive_and_negative(tmp_path):
    pkg = make_pkg(
        tmp_path, {"config.py": SITE_CONFIG, "mod.py": SITE_MOD}, docs=SITE_DOCS
    )
    res = run_pkg(pkg, select=["SITE-REG"])
    m = msgs(res.findings, "SITE-REG")
    assert any("'rogue_site' fired but not registered" in x for x in m)
    assert any("'unused_site'" in x and "dead registration" in x for x in m)
    assert not any("'good_site'" in x for x in m)  # registered+documented+used


FLEET_SITE_CONFIG = (
    'FAULT_SITES = ("replica_kill", "replica_stall")\n'
)
FLEET_SITE_MOD = """
class _Fleet:
    def _chaos_step(self, rep, shard_pos):
        inj = self._injector
        if inj is None:
            return
        inj.fire("replica_kill", detail=f"replica{rep.idx}")
        inj.fire("replica_stall", detail=f"replica{rep.idx}")
"""
FLEET_SITE_DOCS = (
    "| `replica_kill` | each shard step of each fleet replica's sweep |\n"
    "| `replica_stall` | same step: the engine thread wedges |\n"
)


def test_site_reg_fleet_level_sites_positive(tmp_path):
    """SITE-REG covers fleet-LEVEL site literals: replica_kill /
    replica_stall fired from a fleet chaos hook (a method on a class,
    not a module function) are recognized as used when registered in
    FAULT_SITES and documented — 0 findings; dropping the doc rows or
    the registration is a finding again."""
    pkg = make_pkg(
        tmp_path,
        {"config.py": FLEET_SITE_CONFIG, "serve/fleet.py": FLEET_SITE_MOD},
        docs=FLEET_SITE_DOCS,
    )
    res = run_pkg(pkg, select=["SITE-REG"])
    assert msgs(res.findings, "SITE-REG") == []

    # Negative arm 1: an undocumented fleet site is flagged.
    pkg2 = make_pkg(
        tmp_path,
        {"config.py": FLEET_SITE_CONFIG, "serve/fleet.py": FLEET_SITE_MOD},
        docs="| `replica_kill` | documented |\n",
        name="fleetdoc",
    )
    res2 = run_pkg(pkg2, select=["SITE-REG"])
    assert any(
        "'replica_stall'" in m and "missing from the docs" in m
        for m in msgs(res2.findings, "SITE-REG")
    )

    # Negative arm 2: an unregistered fleet site is flagged at the hook.
    pkg3 = make_pkg(
        tmp_path,
        {"config.py": 'FAULT_SITES = ("replica_kill",)\n',
         "serve/fleet.py": FLEET_SITE_MOD},
        docs=FLEET_SITE_DOCS,
        name="fleetreg",
    )
    res3 = run_pkg(pkg3, select=["SITE-REG"])
    assert any(
        "'replica_stall' fired but not registered" in m
        for m in msgs(res3.findings, "SITE-REG")
    )


def test_site_reg_missing_doc_entry(tmp_path):
    pkg = make_pkg(
        tmp_path,
        {"config.py": 'FAULT_SITES = ("good_site",)\n',
         "mod.py": 'def f(inj):\n    inj.fire("good_site")\n'},
        docs="| `other` | x |\n",
    )
    res = run_pkg(pkg, select=["SITE-REG"])
    assert any(
        "missing from the docs" in x for x in msgs(res.findings, "SITE-REG")
    )


# ---------------------------------------------------------------------------
# EVENT-REG (fixture package)
# ---------------------------------------------------------------------------

EVENT_KINDS_MOD = (
    'EVENT_KINDS = {\n'
    '    "good_event": "error",\n'
    '    "unused_event": "warning",\n'
    '}\n'
)
EVENT_EMIT_MOD = """
from pkg.obs import events as obs_events

def f():
    obs_events.emit("good_event", replica=1)
    obs_events.emit("rogue_event", replica=1)
"""
EVENT_DOCS = (
    "| `good_event` | error | somewhere | meaning |\n"
    "| `unused_event` | warning | elsewhere | meaning |\n"
)


def _make_event_pkg(tmp_path, kinds, mod, docs, name="pkg"):
    pkg = make_pkg(
        tmp_path,
        {"obs/events.py": kinds, "serve/mod.py": mod},
        name=name,
    )
    (tmp_path / "docs").mkdir(exist_ok=True)
    (tmp_path / "docs" / "incidents.md").write_text(docs)
    return pkg


def test_event_reg_positive_and_negative(tmp_path):
    """EVENT-REG mirrors SITE-REG for journal event kinds: an emitted
    literal missing from EVENT_KINDS is a finding, a declared kind
    nobody emits is a dead registration, and a registered+documented+
    emitted kind is clean."""
    pkg = _make_event_pkg(tmp_path, EVENT_KINDS_MOD, EVENT_EMIT_MOD, EVENT_DOCS)
    res = run_pkg(pkg, select=["EVENT-REG"])
    m = msgs(res.findings, "EVENT-REG")
    assert any(
        "'rogue_event' emitted but not declared" in x for x in m
    )
    assert any("'unused_event'" in x and "dead registration" in x for x in m)
    assert not any("'good_event'" in x for x in m)


def test_event_reg_missing_doc_entry(tmp_path):
    """A kind declared and emitted but absent from the docs/incidents.md
    kinds table is flagged — the table is the operator-facing contract."""
    pkg = _make_event_pkg(
        tmp_path,
        'EVENT_KINDS = {"good_event": "error"}\n',
        'from pkg.obs import events as obs_events\n'
        'def f():\n    obs_events.emit("good_event")\n',
        "| `other_event` | error | x | y |\n",
        name="eventdoc",
    )
    res = run_pkg(pkg, select=["EVENT-REG"])
    assert any(
        "'good_event' is missing from the docs" in x
        for x in msgs(res.findings, "EVENT-REG")
    )


def test_event_reg_repo_is_clean(port_result):
    """The port package: every emitted kind declared + documented, every
    declared kind emitted — 0 findings (the autoscaler writes its two kinds
    as literals, so the rule sees them)."""
    assert port_result.baselined == []
    assert msgs(port_result.findings, "EVENT-REG") == [], [
        f.format() for f in port_result.findings
    ]


# ---------------------------------------------------------------------------
# COUNTER-EXPORT (fixture package)
# ---------------------------------------------------------------------------

COUNTER_MOD = """
class C:
    def __init__(self):
        self.hits = 0
        self.misses = 0
    def bump(self):
        self.hits += 1
        self.misses += 1
    def stats(self):
        return {"hits": self.hits}
"""

METRICS_MOD = """
class IntegrityRecorder:
    KEYS = ("reread_heals",)
"""
INTEGRITY_USE = """
class L:
    def f(self):
        self._integrity.count("reread_heals")
        self._integrity.count("not_a_key")
"""


def test_counter_export_positive_and_negative(tmp_path):
    pkg = make_pkg(tmp_path, {"mod.py": COUNTER_MOD})
    res = run_pkg(pkg, select=["COUNTER-EXPORT"])
    m = msgs(res.findings, "COUNTER-EXPORT")
    assert any("self.misses" in x for x in m)
    assert not any("self.hits" in x for x in m)


def test_counter_export_prefix_name_is_not_an_export(tmp_path):
    # Exact-node matching: exporting self.hits_total must NOT pass for an
    # incremented self.hits, and a counter named only inside a docstring
    # sentence doesn't count as exported either.
    src = '''
class C:
    def __init__(self):
        self.hits = 0
        self.hits_total = 0

    def bump(self):
        self.hits += 1

    def stats(self):
        """Reports totals (not the raw self.hits window)."""
        return {"hits_total": self.hits_total}
'''
    pkg = make_pkg(tmp_path, {"mod.py": src})
    res = run_pkg(pkg, select=["COUNTER-EXPORT"])
    assert any("self.hits" in x for x in msgs(res.findings, "COUNTER-EXPORT"))


# The speculative-serving counter family (utils/metrics.py spec_snapshot,
# serve/engine.py spec path): accepted/drafted/rejected must all reach the
# registered export. Positive/negative pair over the registry-source path.
SPEC_COUNTER_OK = """
class SpecMetrics:
    def __init__(self, registry):
        self.spec_drafted_tokens = 0
        self.spec_accepted_tokens = 0
        self.spec_rejected_tokens = 0
        registry.register("spec", self.spec_snapshot)
    def bump(self, drafted, accepted):
        self.spec_drafted_tokens += drafted
        self.spec_accepted_tokens += accepted
        self.spec_rejected_tokens += drafted - accepted
    def spec_snapshot(self):
        return {
            "drafted_tokens": self.spec_drafted_tokens,
            "accepted_tokens": self.spec_accepted_tokens,
            "rejected_tokens": self.spec_rejected_tokens,
        }
"""


def test_counter_export_spec_family_positive_and_negative(tmp_path):
    """The fls_spec_* family shape: counters incremented by the verify
    pass and exported through a registered ``spec`` source pass; dropping
    one counter from the export (here rejected_tokens) is the
    counts-but-never-exports defect the rule exists for."""
    pkg = make_pkg(tmp_path, {"mod.py": SPEC_COUNTER_OK})
    res = run_pkg(pkg, select=["COUNTER-EXPORT"])
    assert msgs(res.findings, "COUNTER-EXPORT") == []

    broken = SPEC_COUNTER_OK.replace(
        '            "rejected_tokens": self.spec_rejected_tokens,\n', ""
    )
    pkg = make_pkg(tmp_path, {"mod2.py": broken}, name="pkg2")
    res = run_pkg(pkg, select=["COUNTER-EXPORT"])
    m = msgs(res.findings, "COUNTER-EXPORT")
    assert any("self.spec_rejected_tokens" in x for x in m)
    assert not any("self.spec_accepted_tokens" in x for x in m)


# The autoscaler decision-counter family (serve/autoscale.py stats): every
# grow/shrink/blocked decision must reach the registered ``autoscale``
# export — a scale decision that happened but never exported is invisible
# to the operator judging the controller. Positive/negative pair.
AUTOSCALE_COUNTER_OK = """
class FleetAutoscaler:
    def __init__(self, registry):
        self.polls = 0
        self.grows = 0
        self.shrinks = 0
        self.blocked = 0
        registry.register("autoscale", self.stats)
    def poll_once(self, direction):
        self.polls += 1
        if direction == "grow":
            self.grows += 1
        elif direction == "shrink":
            self.shrinks += 1
        else:
            self.blocked += 1
    def stats(self):
        return {
            "polls": self.polls,
            "grows": self.grows,
            "shrinks": self.shrinks,
            "blocked": self.blocked,
        }
"""


def test_counter_export_autoscale_family_positive_and_negative(tmp_path):
    """The fls_autoscale_* family shape: decision counters incremented in
    poll_once and exported through the registered ``autoscale`` source
    pass; dropping one (here blocked) is the silent-decision defect."""
    pkg = make_pkg(tmp_path, {"mod.py": AUTOSCALE_COUNTER_OK})
    res = run_pkg(pkg, select=["COUNTER-EXPORT"])
    assert msgs(res.findings, "COUNTER-EXPORT") == []

    broken = AUTOSCALE_COUNTER_OK.replace(
        '            "blocked": self.blocked,\n', ""
    )
    pkg = make_pkg(tmp_path, {"mod2.py": broken}, name="pkg2")
    res = run_pkg(pkg, select=["COUNTER-EXPORT"])
    m = msgs(res.findings, "COUNTER-EXPORT")
    assert any("self.blocked" in x for x in m)
    assert not any("self.grows" in x for x in m)


def test_counter_export_integrity_keys(tmp_path):
    pkg = make_pkg(
        tmp_path, {"utils/metrics.py": METRICS_MOD, "utils/__init__.py": "",
                   "mod.py": INTEGRITY_USE}
    )
    res = run_pkg(pkg, select=["COUNTER-EXPORT"])
    m = msgs(res.findings, "COUNTER-EXPORT")
    assert any("'not_a_key'" in x for x in m)
    assert not any("'reread_heals'" in x for x in m)


# A counter exported only through a method the class registers as a
# metrics-registry source (obs/registry.py) is exported; the same method
# UNregistered is not, and the counter must be flagged.
COUNTER_REGISTRY_MOD = """
class C:
    def __init__(self, registry):
        self.hits = 0
        self.drops = 0
        registry.register("c", self.metrics)
    def bump(self):
        self.hits += 1
        self.drops += 1
    def metrics(self):
        return {"hits": self.hits, "drops": self.drops}
    def stats(self):
        return {"hits": self.hits}
"""
COUNTER_UNREGISTERED_MOD = """
class C:
    def __init__(self):
        self.hits = 0
        self.drops = 0
    def bump(self):
        self.hits += 1
        self.drops += 1
    def metrics(self):
        # Never registered anywhere: this is NOT an export surface.
        return {"hits": self.hits, "drops": self.drops}
    def stats(self):
        return {"hits": self.hits}
"""


def test_counter_export_registry_registration_satisfies(tmp_path):
    pkg = make_pkg(tmp_path, {"mod.py": COUNTER_REGISTRY_MOD})
    res = run_pkg(pkg, select=["COUNTER-EXPORT"])
    # self.drops reaches metrics(), which the class registers as a
    # registry source — exported, no finding.
    assert not msgs(res.findings, "COUNTER-EXPORT")


def test_counter_export_unregistered_method_is_not_an_export(tmp_path):
    pkg = make_pkg(tmp_path, {"mod.py": COUNTER_UNREGISTERED_MOD})
    res = run_pkg(pkg, select=["COUNTER-EXPORT"])
    m = msgs(res.findings, "COUNTER-EXPORT")
    # self.drops reaches neither stats() nor any registered source: the
    # counter counts but never exports — flagged.
    assert any("self.drops" in x for x in m)
    assert not any("self.hits" in x for x in m)


def test_counter_export_registration_is_class_scoped(tmp_path):
    # ANOTHER class registering a method that happens to share the name
    # `metrics` must not grant this class an export surface: the
    # registration scope is same-class `self.method` only.
    other = """
class D:
    def __init__(self, registry):
        registry.register("d", self.metrics)
    def metrics(self):
        return {}
"""
    pkg = make_pkg(
        tmp_path,
        {"mod.py": COUNTER_UNREGISTERED_MOD, "other.py": other},
    )
    res = run_pkg(pkg, select=["COUNTER-EXPORT"])
    assert any(
        "self.drops" in x for x in msgs(res.findings, "COUNTER-EXPORT")
    )


# ---------------------------------------------------------------------------
# HYGIENE (fixture package)
# ---------------------------------------------------------------------------


def test_hygiene_missing_init_and_stray_dir(tmp_path):
    pkg = make_pkg(tmp_path, {"sub/mod.py": "x = 1\n"})
    (pkg / "stray" / "__pycache__").mkdir(parents=True)
    res = run_pkg(pkg, select=["HYGIENE"])
    m = msgs(res.findings, "HYGIENE")
    assert any("without __init__.py" in x for x in m)
    assert any("stray directory" in x for x in m)


def test_hygiene_clean(tmp_path):
    pkg = make_pkg(tmp_path, {"sub/__init__.py": "", "sub/mod.py": "x = 1\n"})
    res = run_pkg(pkg, select=["HYGIENE"])
    assert res.findings == []


# ---------------------------------------------------------------------------
# Baseline machinery
# ---------------------------------------------------------------------------

BASE_SRC = "def f():\n    try:\n        g()\n    except Exception:\n        pass\n"


def _one_finding_pkg(tmp_path):
    return make_pkg(tmp_path, {"runtime/__init__.py": "", "runtime/x.py": BASE_SRC})


def test_baseline_suppresses_with_reason(tmp_path):
    pkg = _one_finding_pkg(tmp_path)
    res = run_pkg(pkg, select=["EXC-TAXONOMY"])
    assert len(res.findings) == 1
    fp = res.findings[0].fingerprint
    bl = tmp_path / "bl.json"
    bl.write_text(json.dumps({"entries": [
        {"fingerprint": fp, "rule": "EXC-TAXONOMY", "path": res.findings[0].path,
         "reason": "grandfathered: legacy swallow, tracked for a later fix"}
    ]}))
    res2 = run(pkg, repo_root=pkg.parent, baseline_path=bl, select=["EXC-TAXONOMY"])
    assert res2.ok and len(res2.baselined) == 1


def test_baseline_todo_reason_and_stale_entry_fail(tmp_path):
    pkg = _one_finding_pkg(tmp_path)
    res = run_pkg(pkg, select=["EXC-TAXONOMY"])
    fp = res.findings[0].fingerprint
    bl = tmp_path / "bl.json"
    bl.write_text(json.dumps({"entries": [
        {"fingerprint": fp, "rule": "EXC-TAXONOMY", "reason": "TODO: later"},
        # Stale entry for a rule that RAN (staleness of unselected rules
        # is not judgeable — see test_select_skips_staleness_of_unselected_rules).
        {"fingerprint": "deadbeefdeadbeef", "rule": "EXC-TAXONOMY", "reason": "fixed"},
    ]}))
    res2 = run(pkg, repo_root=pkg.parent, baseline_path=bl, select=["EXC-TAXONOMY"])
    m = msgs(res2.findings, "BASELINE")
    assert any("needs a real reason" in x for x in m)
    assert any("stale entry" in x for x in m)


def test_write_baseline_roundtrip(tmp_path):
    pkg = _one_finding_pkg(tmp_path)
    res = run_pkg(pkg, select=["EXC-TAXONOMY"])
    bl = tmp_path / "bl.json"
    write_baseline(bl, res.findings, {})
    entries, _ = load_baseline(bl)
    assert len(entries) == 1
    (e,) = entries.values()
    assert e["rule"] == "EXC-TAXONOMY" and e["reason"].startswith("TODO")


def test_select_skips_staleness_of_unselected_rules(tmp_path):
    # A legitimately-baselined entry for a rule that did NOT run under
    # --select cannot be judged stale — the selective debugging workflow
    # must not fail on a clean repo with a non-empty baseline.
    pkg = _one_finding_pkg(tmp_path)
    res = run_pkg(pkg, select=["EXC-TAXONOMY"])
    fp = res.findings[0].fingerprint
    bl = tmp_path / "bl.json"
    bl.write_text(json.dumps({"entries": [
        {"fingerprint": fp, "rule": "EXC-TAXONOMY", "path": res.findings[0].path,
         "reason": "grandfathered: legacy swallow, tracked for a later fix"}
    ]}))
    sel = run(pkg, repo_root=pkg.parent, baseline_path=bl, select=["LOCK-IO"])
    assert sel.ok, [f.format() for f in sel.findings]
    # The full run still judges (and here matches) the entry.
    full = run(pkg, repo_root=pkg.parent, baseline_path=bl)
    assert not any("stale" in m for m in msgs(full.findings, "BASELINE"))


def test_write_baseline_dedups_same_fingerprint(tmp_path):
    # Fingerprints are line-independent, so two identical violations in
    # one symbol share one — the baseline gets a single entry, and the
    # one entry grandfathers both findings.
    f = Finding("LOCK-IO", "runtime/x.py", 5, "same msg", symbol="C.f")
    g = Finding("LOCK-IO", "runtime/x.py", 9, "same msg", symbol="C.f")
    assert f.fingerprint == g.fingerprint
    path = tmp_path / "b.json"
    write_baseline(path, [f, g], {})
    data = json.loads(path.read_text())
    assert len(data["entries"]) == 1


def test_write_baseline_rejects_baseline_none(tmp_path):
    from flexible_llm_sharding_tpu_torch.analysis.core import main as check_main

    pkg = _one_finding_pkg(tmp_path)
    rc = check_main(
        ["--write-baseline", "--baseline", "none", "--root", str(pkg)]
    )
    assert rc == 2


def test_write_baseline_with_select_preserves_other_rules(tmp_path):
    # --write-baseline --select RULE re-ran only RULE: entries for every
    # other rule must carry over verbatim, not be mass-deleted.
    from flexible_llm_sharding_tpu_torch.analysis.core import main as check_main

    pkg = _one_finding_pkg(tmp_path)
    bl = tmp_path / "bl.json"
    lock_entry = {
        "fingerprint": "cafecafecafecafe", "rule": "LOCK-IO",
        "path": "runtime/old.py", "symbol": "f", "message": "old finding",
        "reason": "grandfathered: audited, tracked for a later fix",
    }
    bl.write_text(json.dumps({"entries": [lock_entry]}))
    rc = check_main([
        "--write-baseline", "--select", "EXC-TAXONOMY",
        "--baseline", str(bl), "--root", str(pkg),
    ])
    assert rc == 0
    data = json.loads(bl.read_text())
    by_rule = {e["rule"]: e for e in data["entries"]}
    assert by_rule["LOCK-IO"]["reason"] == lock_entry["reason"]
    assert by_rule["EXC-TAXONOMY"]["reason"].startswith("TODO")


# ---------------------------------------------------------------------------
# Self-test: the port is clean under its own (empty) baseline
# ---------------------------------------------------------------------------


def test_port_is_flscheck_clean(port_result):
    """0 findings and 0 pragma errors: every finding of the port was fixed
    or carries the pragma its JAX twin line carries."""
    assert port_result.ok, "\n" + "\n".join(f.format() for f in port_result.findings)
    assert [f for f in port_result.findings if f.rule == "PRAGMA"] == []
    assert port_result.suppressed > 0


def test_port_baseline_is_empty():
    # The port's own baseline, beside the JAX package's: empty, and it
    # stays so (every finding is fixed or pragma'd in place).
    entries, problems = load_baseline(REPO_ROOT / "flscheck-torch-baseline.json")
    assert problems == []
    assert entries == {}
    assert json.loads((REPO_ROOT / "flscheck-torch-baseline.json").read_text()) == {
        "version": 1, "entries": []}


def test_port_baseline_is_its_own():
    """The port reads and writes ``flscheck-torch-baseline.json``, never the
    JAX package's ``flscheck-baseline.json``, and defaults to the port
    package as its root."""
    from flexible_llm_sharding_tpu.analysis import core as jax_core
    from flexible_llm_sharding_tpu_torch.analysis import core as port_core

    assert port_core.BASELINE_NAME == "flscheck-torch-baseline.json"
    assert jax_core.BASELINE_NAME == "flscheck-baseline.json"
    assert Path(port_core.__file__).resolve().parent.parent == PKG_DIR.resolve()


def test_check_subcommand_and_script_exit_0_on_the_tree(capsys):
    """``cli check`` and ``scripts/torch_flscheck.py`` run the port's
    analyzer over the port: clean, exit 0."""
    import runpy
    import sys

    from flexible_llm_sharding_tpu_torch import cli

    assert cli.main(["check", "--select", "KNOB-SYNC"]) is None
    assert "0 finding(s), 0 baselined" in capsys.readouterr().out
    argv = sys.argv
    sys.argv = [str(REPO_ROOT / "scripts" / "torch_flscheck.py"), "--select", "HYGIENE"]
    try:
        with pytest.raises(SystemExit) as done:
            runpy.run_path(sys.argv[0], run_name="__main__")
    finally:
        sys.argv = argv
    assert done.value.code == 0
    assert "0 finding(s), 0 baselined" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# The equality oracle: the port's analyzer is the JAX package's
# ---------------------------------------------------------------------------

_PRAGMA = re.compile(r"#\s*flscheck:")


def _strip_pragmas(src: str) -> str:
    """``src`` with every ``flscheck:`` comment removed (comment tokens only:
    pragma-shaped text inside a string stays); line numbers unchanged."""
    lines = src.split("\n")
    for tok in tokenize.generate_tokens(io.StringIO(src).readline):
        if tok.type == tokenize.COMMENT and _PRAGMA.search(tok.string):
            row, col = tok.start
            lines[row - 1] = lines[row - 1][:col].rstrip()
    return "\n".join(lines)


@pytest.fixture(scope="module")
def stripped_trees(tmp_path_factory):
    """Each package copied with every pragma stripped, beside the docs
    tables SITE-REG and EVENT-REG read: {name: (package dir, repo root, the
    JAX analyzer's run over it)}. The JAX analyzer runs through its own
    entry point (``scripts/flscheck --json``) in a child process per
    package, while the tests run the port's in this one."""
    import subprocess
    import sys

    out = {}
    for pkg in (JAX_PKG_DIR, PKG_DIR):
        root = tmp_path_factory.mktemp(pkg.name)
        (root / "docs").mkdir()
        for doc in ("faults.md", "incidents.md"):
            shutil.copy(REPO_ROOT / "docs" / doc, root / "docs" / doc)
        for p in sorted(pkg.rglob("*.py")):
            if "__pycache__" in p.parts:
                continue
            dst = root / pkg.name / p.relative_to(pkg)
            dst.parent.mkdir(parents=True, exist_ok=True)
            dst.write_text(_strip_pragmas(p.read_text()))
        child = subprocess.Popen(
            [sys.executable, str(REPO_ROOT / "scripts" / "flscheck"), "--root",
             str(root / pkg.name), "--baseline", "none", "--json"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        out[pkg.name] = (root / pkg.name, root, child)
    yield out
    for _, _, child in out.values():
        child.kill()
        child.communicate()


@pytest.mark.parametrize("pkg_name", ["flexible_llm_sharding_tpu",
                                      "flexible_llm_sharding_tpu_torch"])
def test_both_analyzers_find_the_same_on_stripped_packages(stripped_trees, pkg_name):
    """With every pragma stripped and no baseline, the port's analyzer and
    the JAX package's report identical (rule, path, line, message) lists on
    either package: the port's copy loosens no rule. The stripped port
    shows the findings its pragmas answer (none of them PRAGMA or PARSE)."""
    pkg, root, child = stripped_trees[pkg_name]
    ours = run(pkg, repo_root=root, baseline_path="")
    stdout, stderr = child.communicate(timeout=120)
    assert child.returncode == 1, stderr  # findings, as the stripped tree must have
    theirs = json.loads(stdout)
    assert [(f.rule, f.path, f.line, f.message, f.fingerprint) for f in ours.findings] == [
        (f["rule"], f["path"], f["line"], f["message"], f["fingerprint"])
        for f in theirs["findings"]]
    assert ours.suppressed == theirs["suppressed_by_pragma"] == 0
    assert ours.findings and not {f.rule for f in ours.findings} & {"PRAGMA", "PARSE"}


# ---------------------------------------------------------------------------
# Regression pins for the narrowed handlers the analyzer holds the port to
# ---------------------------------------------------------------------------


def _bare_source():
    from flexible_llm_sharding_tpu_torch.runtime.executor import ShardWeightSource

    src = ShardWeightSource.__new__(ShardWeightSource)
    src._stop = threading.Event()
    src._q = Queue()
    src._thread = None
    src._prefetcher = None
    return src


def test_source_abort_and_close_drain_behavior_preserved():
    src = _bare_source()
    src._q.put(1)
    src._q.put(2)
    src.abort()
    assert src._stop.is_set() and src._q.empty()
    src._q.put(3)
    src.close()
    assert src._q.empty()


class _BoomQueue:
    """A queue whose get_nowait raises a NON-Empty error: a drain loop that
    caught more than ``queue.Empty`` would swallow it (masking real bugs)."""

    def get_nowait(self):
        raise RuntimeError("not queue.Empty")

    def empty(self):
        return False


@pytest.mark.parametrize("drain", ["abort", "close"])
def test_source_drains_swallow_only_queue_empty(drain):
    src = _bare_source()
    src._q = _BoomQueue()
    with pytest.raises(RuntimeError):
        getattr(src, drain)()


def _bare_broadcast(q):
    from flexible_llm_sharding_tpu_torch.runtime.executor import BroadcastShardSource

    b = BroadcastShardSource.__new__(BroadcastShardSource)
    b._stop = threading.Event()
    b._queues = [q]
    b._thread = types.SimpleNamespace(join=lambda *a, **k: None, is_alive=lambda: False)
    b._loader = types.SimpleNamespace(close=lambda: None)
    return b


def test_broadcast_close_drains_swallow_only_queue_empty():
    q = Queue()
    q.put(1)
    _bare_broadcast(q).close()
    assert q.empty()
    with pytest.raises(RuntimeError):
        _bare_broadcast(_BoomQueue()).close()


class _StubInitEngine:
    """Just enough ServeEngine surface to drive _init_wave's handler."""

    def __init__(self, exc):
        from flexible_llm_sharding_tpu_torch.utils.metrics import ServingMetrics

        self._exc = exc
        self.metrics = ServingMetrics()
        self.batcher = types.SimpleNamespace(waves=[])
        self._sched = None  # scheduler off: the FIFO path
        self._spec_k = 0  # speculation off: the plain decode path
        self._kv_pool = None  # pool off
        self._adapter_store = None  # adapters off: base-only resolution

    # The real resolution methods: _init_wave's adapter gate runs the way a
    # live engine runs it (all-base here, a pass-through to the
    # tokenization failure under test).
    def _entry_adapter(self, entry):
        from flexible_llm_sharding_tpu_torch.serve.engine import ServeEngine

        return ServeEngine._entry_adapter(entry)

    def _resolve_adapters(self, wave):
        from flexible_llm_sharding_tpu_torch.serve.engine import ServeEngine

        return ServeEngine._resolve_adapters(self, wave)

    def _tokenize_entry(self, entry):
        # The real method's failure surface: tokenization raising inside
        # the _init_wave try block.
        raise self._exc


def _wave():
    from flexible_llm_sharding_tpu_torch.serve.batcher import Wave
    from flexible_llm_sharding_tpu_torch.serve.request import Request

    req = Request(prefix="p", suffixes=("s",), max_new_tokens=1)
    return Wave(requests=[req])


@pytest.mark.parametrize("exc", [
    # A bad workload fails its wave.
    ValueError("bad workload"),
    # An empty suffix tuple makes the tokenizer index an empty array: a
    # malformed REQUEST, not an engine bug.
    IndexError("too many indices for array"),
    # A huge request that first fails at allocation rejects its wave
    # instead of shutting the engine down through the fatal path.
    MemoryError("oversized prompt"),
], ids=["workload-valueerror", "malformed-indexerror", "oversized-memoryerror"])
def test_init_wave_request_error_fails_only_the_wave(exc):
    from flexible_llm_sharding_tpu_torch.serve.engine import ServeEngine
    from flexible_llm_sharding_tpu_torch.serve.request import RequestStatus

    eng = _StubInitEngine(exc)
    wave = _wave()
    eng.batcher.waves.append(wave)
    assert ServeEngine._init_wave(eng, wave) is False
    assert wave.requests[0].status is RequestStatus.FAILED
    assert eng.batcher.waves == []
    assert eng.metrics.counter("failed") == 1


def test_init_wave_engine_bug_escapes_to_fatal_path():
    # Non-workload errors (here ZeroDivisionError) are engine bugs: they
    # propagate to the loop's fatal handler instead of masquerading as
    # per-wave rejections forever.
    from flexible_llm_sharding_tpu_torch.serve.engine import ServeEngine

    eng = _StubInitEngine(ZeroDivisionError("engine bug"))
    wave = _wave()
    eng.batcher.waves.append(wave)
    with pytest.raises(ZeroDivisionError):
        ServeEngine._init_wave(eng, wave)


def test_prefetcher_wait_all_results_outside_lock(tmp_path, monkeypatch):
    # Python-pool path: wait_all completes the pending warms, clears the
    # list and leaves the prefetcher usable, with the .result() waits OFF
    # the close fence (a close during a slow warm can take the lock).
    from flexible_llm_sharding_tpu_torch.utils import native

    monkeypatch.setattr(native, "load_lib", lambda: None)
    p = native.FilePrefetcher(threads=1)
    assert not p.native
    f = tmp_path / "x.bin"
    f.write_bytes(b"abc")
    p.prefetch(str(f), str(tmp_path / "missing.bin"))
    p.wait_all()
    assert p._futures == []
    blocker = threading.Event()
    p._futures = [p._pool.submit(blocker.wait, 5.0)]
    t = threading.Thread(target=p.wait_all)
    t.start()
    # While wait_all blocks on the future, the fence lock must be free.
    acquired = p._close_lock.acquire(timeout=1.0)
    assert acquired
    p._close_lock.release()
    blocker.set()
    t.join(timeout=5.0)
    assert not t.is_alive()
    p.close()


def test_residency_budget_replans_off_the_tier_lock(tmp_path):
    # Functional pin: a budget change swaps in a fresh plan (planned off
    # the tier's lock; a concurrent stats() must not deadlock with it).
    from flexible_llm_sharding_tpu_torch.runtime import residency

    names = ["model.embed_tokens", "model.layers.0", "lm_head"]
    for n in names:
        (tmp_path / f"{n}.safetensors").write_bytes(b"\0" * 64)
    plan = residency.plan_residency(str(tmp_path), names, 1000)
    tier = residency.DeviceResidencyTier(str(tmp_path), names, plan)
    assert tier.plan.pinned
    done = []
    t = threading.Thread(target=lambda: done.append(tier.stats())
                         or residency._apply_process_budget(tier, 0, True, False))
    try:
        t.start()
        t.join(timeout=5.0)
    finally:
        residency.reset_process_tier()
    assert not t.is_alive() and done
    assert tier.plan.pinned == () and tier.stats()["budget_bytes"] == 0

# ---------------------------------------------------------------------------
# Pressure: counter family + resource-pressure sites
# ---------------------------------------------------------------------------

PRESSURE_COUNTER_MOD = """
class BrownoutController:
    def __init__(self):
        self.sheds = 0
        self.cache_shrinks = 0
        self.pin_evictions = 0
    def note_shed(self):
        self.sheds += 1
    def engage(self):
        self.cache_shrinks += 1
        self.pin_evictions += 1
    def stats(self):
        return {
            "sheds": self.sheds,
            "cache_shrinks": self.cache_shrinks,
            "pin_evictions": self.pin_evictions,
        }
"""


def test_counter_export_pressure_family(tmp_path):
    """The fls_pressure_* counter family satisfies COUNTER-EXPORT: every
    ladder counter the controller increments reaches its stats() export
    (positive), and dropping one from the export is a finding again
    (negative) — the shape regression this fixture pins is a new ladder
    counter added without wiring it to the scrapeable surface."""
    pkg = make_pkg(tmp_path, {"pressure.py": PRESSURE_COUNTER_MOD})
    res = run_pkg(pkg, select=["COUNTER-EXPORT"])
    assert msgs(res.findings, "COUNTER-EXPORT") == []

    broken = PRESSURE_COUNTER_MOD.replace('"sheds": self.sheds,\n', "")
    pkg2 = make_pkg(
        tmp_path, {"pressure.py": broken}, name="pressure_broken"
    )
    res2 = run_pkg(pkg2, select=["COUNTER-EXPORT"])
    assert any(
        "self.sheds" in x for x in msgs(res2.findings, "COUNTER-EXPORT")
    )


PRESSURE_SITE_CONFIG = (
    'FAULT_SITES = ("host_oom", "disk_full", "link_throttle")\n'
)
PRESSURE_SITE_MOD = """
class _Loader:
    def attempt(self, name):
        self._injector.fire("host_oom", detail=name)

class _Store:
    def _write_spill(self, path):
        self._injector.fire("disk_full", detail=path)

def put(inj, idxs):
    inj.fire("link_throttle", detail=str(idxs))
"""
PRESSURE_SITE_DOCS = (
    "| `host_oom` | each layer read |\n"
    "| `disk_full` | each spill write |\n"
    "| `link_throttle` | each host->HBM put |\n"
)


def test_site_reg_pressure_sites_positive_and_negative(tmp_path):
    """The resource-pressure sites satisfy SITE-REG: registered, fired,
    and documented is clean; dropping a doc row or the registration is a
    finding again."""
    pkg = make_pkg(
        tmp_path,
        {"config.py": PRESSURE_SITE_CONFIG, "runtime/mod.py": PRESSURE_SITE_MOD},
        docs=PRESSURE_SITE_DOCS,
    )
    res = run_pkg(pkg, select=["SITE-REG"])
    assert msgs(res.findings, "SITE-REG") == []

    pkg2 = make_pkg(
        tmp_path,
        {"config.py": PRESSURE_SITE_CONFIG, "runtime/mod.py": PRESSURE_SITE_MOD},
        docs="| `host_oom` | documented |\n| `disk_full` | documented |\n",
        name="pressuredoc",
    )
    res2 = run_pkg(pkg2, select=["SITE-REG"])
    assert any(
        "'link_throttle'" in m and "missing from the docs" in m
        for m in msgs(res2.findings, "SITE-REG")
    )

    pkg3 = make_pkg(
        tmp_path,
        {"config.py": 'FAULT_SITES = ("host_oom", "disk_full")\n',
         "runtime/mod.py": PRESSURE_SITE_MOD},
        docs=PRESSURE_SITE_DOCS,
        name="pressurereg",
    )
    res3 = run_pkg(pkg3, select=["SITE-REG"])
    assert any(
        "'link_throttle' fired but not registered" in m
        for m in msgs(res3.findings, "SITE-REG")
    )


SCHED_COUNTER_MOD = """
class SweepScheduler:
    def __init__(self):
        self.preemptions = 0
        self.preempted_requests = 0
        self.rate_limited = 0
        self.coalesced_requests = 0
        self.prefill_kv_bytes_saved = 0
    def note_preempted(self, n):
        self.preemptions += 1
        self.preempted_requests += n
    def admit_check(self):
        self.rate_limited += 1
    def note_coalesced(self, n, saved):
        self.coalesced_requests += n
        self.prefill_kv_bytes_saved += saved
    def stats(self):
        return {
            "preemptions": self.preemptions,
            "preempted_requests": self.preempted_requests,
            "rate_limited": self.rate_limited,
            "coalesced_requests": self.coalesced_requests,
            "prefill_kv_bytes_saved": self.prefill_kv_bytes_saved,
        }
"""


def test_counter_export_sched_family(tmp_path):
    """The fls_sched_* counter family satisfies COUNTER-EXPORT: every
    scheduler counter reaches its stats() export (positive), and
    dropping one from the export is a finding again (negative) — the
    regression this pins is a new scheduling counter added without
    wiring it to the scrapeable surface."""
    pkg = make_pkg(tmp_path, {"serve/sched/scheduler.py": SCHED_COUNTER_MOD})
    res = run_pkg(pkg, select=["COUNTER-EXPORT"])
    assert msgs(res.findings, "COUNTER-EXPORT") == []

    broken = SCHED_COUNTER_MOD.replace(
        '"preemptions": self.preemptions,\n', ""
    )
    pkg2 = make_pkg(
        tmp_path, {"serve/sched/scheduler.py": broken}, name="sched_broken"
    )
    res2 = run_pkg(pkg2, select=["COUNTER-EXPORT"])
    assert any(
        "self.preemptions" in x for x in msgs(res2.findings, "COUNTER-EXPORT")
    )


def test_knob_sync_sched_flags_map_and_desync_fires(tmp_path):
    """SchedConfig flags resolve through the sched_ prefix exactly like
    pressure_ flags (serve-parser-only: SchedConfig is a serving
    subsystem, so the both-parsers check exempts it): the real CLI is
    clean, and renaming a sched flag in both the parser and nowhere else
    while _sched_config_from_args still reads the old name trips the
    rule (AttributeError-at-runtime class)."""
    files = {
        "cli.py": (PKG_DIR / "cli.py").read_text(),
        "config.py": (PKG_DIR / "config.py").read_text(),
    }
    pkg = make_pkg(tmp_path, files, name="sched_clean")
    res = run_pkg(pkg, select=["KNOB-SYNC"])
    assert res.findings == [], [f.format() for f in res.findings]

    desynced = dict(files)
    desynced["cli.py"] = desynced["cli.py"].replace(
        '"--sched_tenant_limits"', '"--sched_tenant_limitsx"'
    )
    pkg2 = make_pkg(tmp_path, desynced, name="sched_desynced")
    res2 = run_pkg(pkg2, select=["KNOB-SYNC"])
    assert any(
        "sched_tenant_limits" in m for m in msgs(res2.findings, "KNOB-SYNC")
    )


def test_knob_sync_pressure_flags_map_and_desync_fires(tmp_path):
    """PressureConfig flags resolve through the pressure_ prefix exactly
    like chaos_ flags do: the real CLI is clean, and renaming a pressure
    flag in both parsers while _pressure_config_from_args still reads
    the old name trips the rule (AttributeError-at-runtime class)."""
    files = {
        "cli.py": (PKG_DIR / "cli.py").read_text(),
        "config.py": (PKG_DIR / "config.py").read_text(),
    }
    desynced = dict(files)
    desynced["cli.py"] = desynced["cli.py"].replace(
        '"--pressure_poll_s"', '"--pressure_poll_sx"'
    )
    pkg = make_pkg(tmp_path, desynced, name="pressure_desynced")
    res = run_pkg(pkg, select=["KNOB-SYNC"])
    assert any(
        "pressure_poll_s" in m for m in msgs(res.findings, "KNOB-SYNC")
    )


# ---------------------------------------------------------------------------
# QUANT-MANIFEST
# ---------------------------------------------------------------------------

QUANT_MANIFEST_BAD = """
from safetensors.numpy import save_file as st_save_file
def write_layer(flat, path):
    st_save_file(flat, path)
"""

QUANT_MANIFEST_GOOD = """
from safetensors.numpy import save_file as st_save_file
from flexible_llm_sharding_tpu_torch.integrity import manifest as integrity_manifest
def write_layer(flat, path, manifest_layers):
    st_save_file(flat, path)
    manifest_layers["x"] = integrity_manifest.layer_entry(flat, "x.safetensors")
"""

# The save_params shape: the pairing lives inside a NESTED helper, which
# is its own scope — the outer function must not be flagged for calls it
# never makes, and the inner one pairs correctly.
QUANT_MANIFEST_NESTED = """
from safetensors.numpy import save_file as st_save_file
from flexible_llm_sharding_tpu_torch.integrity import manifest as integrity_manifest
def save_all(layers, out):
    manifest_layers = {}
    def _save(name, flat):
        st_save_file(flat, name)
        manifest_layers[name] = integrity_manifest.layer_entry(flat, name)
    for name, flat in layers.items():
        _save(name, flat)
"""


def test_quant_manifest_positive():
    """A layer-file writer with no layer_entry in the same function is a
    finding: the manifest's per-layer dtype kind is what the load path's
    PrecisionMismatch check audits, and a writer that skips it emits
    files the check can never type."""
    found = analyze_source(
        QUANT_MANIFEST_BAD, "utils/x.py", select=["QUANT-MANIFEST"]
    )
    assert rules_of(found) == ["QUANT-MANIFEST"]
    assert "layer_entry" in found[0].message


def test_quant_manifest_negative_paired_and_nested():
    assert (
        analyze_source(
            QUANT_MANIFEST_GOOD, "utils/x.py", select=["QUANT-MANIFEST"]
        )
        == []
    )
    assert (
        analyze_source(
            QUANT_MANIFEST_NESTED, "utils/x.py", select=["QUANT-MANIFEST"]
        )
        == []
    )


def test_quant_manifest_nested_unpaired_fires():
    """The nested helper is its own scope: a save inside it with the
    layer_entry only in the OUTER function does not count as paired."""
    src = """
from safetensors.numpy import save_file as st_save_file
from flexible_llm_sharding_tpu_torch.integrity import manifest as integrity_manifest
def save_all(layers, out):
    integrity_manifest.layer_entry({}, "decoy")
    def _save(name, flat):
        st_save_file(flat, name)
    for name, flat in layers.items():
        _save(name, flat)
"""
    found = analyze_source(src, "utils/x.py", select=["QUANT-MANIFEST"])
    assert rules_of(found) == ["QUANT-MANIFEST"]
    assert found[0].symbol.endswith("_save")
