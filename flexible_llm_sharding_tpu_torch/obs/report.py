"""The trace analyzer (the JAX package's ``obs/report.py``): turn a
recorded sweep timeline into numbers.

Input is a trace written by ``obs.trace`` (Chrome trace-event JSON or
JSONL, both detected). Output:

- **link utilization**: the fraction of the trace wall the weight stream
  was busy (the merged union of ``shard_load`` and ``device_put`` spans).
  On a card these spans are host time: the read and the upload's enqueue,
  not the copy itself.
- **overlap efficiency**: ``1 - source_wait / shard_produce``, the share
  of weight-produce time hidden under compute.
- **per-phase sweep breakdown**: total seconds per span name, and the
  per-sweep phase profile grouped by ``sweep_id``.
- **serve latencies**: p50/p95/p99 TTFT and per-token latency from the
  engine's ``ttft`` / ``token_latency`` instants.

``main()`` backs the ``trace-report`` subcommand; ``load_bundle``,
``analyze_bundle`` and ``format_incident`` back ``incidents``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

# Span names whose intervals constitute "the stream is busy" for link
# utilization. shard_produce is their parent (it additionally covers
# residency waits), so it is excluded from the union to avoid double
# counting; overlap efficiency uses it as the produce denominator.
STREAM_SPAN_NAMES = ("shard_load", "device_put")
PRODUCE_SPAN = "shard_produce"
WAIT_SPAN = "source_wait"


def _bundle_manifest(path: str) -> tuple[str, dict] | None:
    """(bundle_dir, manifest) when ``path`` is an incident bundle — the
    bundle dir itself, its manifest.json, or a path whose parsed JSON
    carries the bundle format marker. None otherwise."""
    manifest_path = None
    if os.path.isdir(path):
        manifest_path = os.path.join(path, "manifest.json")
    elif os.path.basename(path) == "manifest.json":
        manifest_path = path
    if manifest_path is None or not os.path.isfile(manifest_path):
        return None
    try:
        with open(manifest_path) as f:
            manifest = json.load(f)
    except (OSError, ValueError):
        return None
    if manifest.get("format") != "fls-incident-bundle":
        return None
    return os.path.dirname(manifest_path) or ".", manifest


def load_manifest(path: str) -> dict:
    """Just the manifest of an incident bundle — the cheap form for
    ``incidents list``/``show``, which must not parse every bundle's
    multi-MB trace to print a one-line summary."""
    found = _bundle_manifest(path)
    if found is None:
        raise ValueError(f"{path} is not an incident bundle")
    return found[1]


def journal_tail_len(path: str) -> int:
    """Event count of a bundle's journal tail (line count — no JSON
    parse; the ``incidents list`` summary column)."""
    found = _bundle_manifest(path)
    if found is None:
        return 0
    try:
        with open(os.path.join(found[0], "journal_tail.jsonl")) as f:
            return sum(1 for line in f if line.strip())
    except OSError:
        return 0


def load_bundle(path: str) -> dict:
    """An incident bundle's parts: ``{"path", "manifest", "journal",
    "metrics", "config", "trace_events"}`` — missing files load as
    empty (a partially-captured bundle still renders)."""
    found = _bundle_manifest(path)
    if found is None:
        raise ValueError(f"{path} is not an incident bundle")
    bundle_dir, manifest = found

    def load_json(name: str, default):
        p = os.path.join(bundle_dir, name)
        try:
            with open(p) as f:
                if name.endswith(".jsonl"):
                    return [
                        json.loads(line)
                        for line in f.read().splitlines()
                        if line.strip()
                    ]
                return json.load(f)
        except (OSError, ValueError):
            return default

    trace_path = os.path.join(bundle_dir, "trace.json")
    try:
        trace_events = load_trace(trace_path)
    except (OSError, ValueError):
        trace_events = []
    return {
        "path": bundle_dir,
        "manifest": manifest,
        "journal": load_json("journal_tail.jsonl", []),
        "metrics": load_json("metrics.json", {}),
        "config": load_json("config.json", {}),
        "trace_events": trace_events,
    }


def load_trace(path: str) -> list[dict]:
    """Normalized event list from a Chrome trace JSON or a JSONL export:
    ``{"name", "cat", "ts_s", "dur_s"?, ...attrs}`` per event. Format is
    detected by parsing, not extension: a whole-file JSON document is the
    Chrome form; anything else is read line-by-line as JSONL. An
    incident-bundle directory (or its manifest.json) resolves to the
    bundle's embedded ``trace.json``."""
    found = _bundle_manifest(path)
    if found is not None:
        path = os.path.join(found[0], "trace.json")
    with open(path) as f:
        text = f.read()
    doc = None
    try:
        doc = json.loads(text)
    except ValueError:
        pass
    if (
        doc is None
        or not isinstance(doc, (dict, list))
        or (isinstance(doc, dict) and "traceEvents" not in doc)
    ):
        # JSONL (including the one-line edge case, which parses as a
        # plain dict with no traceEvents key).
        return [
            json.loads(line) for line in text.splitlines() if line.strip()
        ]
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    out = []
    for ev in events:
        if ev.get("ph") not in ("X", "i"):
            continue
        d = {
            "name": ev.get("name", ""),
            "cat": ev.get("cat", ""),
            "ts_s": float(ev.get("ts", 0.0)) / 1e6,
        }
        if ev.get("ph") == "X":
            d["dur_s"] = float(ev.get("dur", 0.0)) / 1e6
        d.update(ev.get("args") or {})
        out.append(d)
    return out


def _union_seconds(intervals: list[tuple[float, float]]) -> float:
    """Total covered seconds of possibly-overlapping [start, end) spans."""
    if not intervals:
        return 0.0
    intervals.sort()
    total = 0.0
    cur_s, cur_e = intervals[0]
    for s, e in intervals[1:]:
        if s > cur_e:
            total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s)


def _quantiles(samples: list[float]) -> dict[str, float]:
    if not samples:
        return {"count": 0}
    xs = sorted(samples)

    def pct(p: float) -> float:
        # Nearest-rank on the sorted samples (no numpy dependency here:
        # the analyzer must run anywhere a trace file can land).
        i = min(len(xs) - 1, max(0, round(p / 100 * (len(xs) - 1))))
        return round(xs[i], 6)

    return {
        "count": len(xs),
        "mean": round(sum(xs) / len(xs), 6),
        "p50": pct(50),
        "p95": pct(95),
        "p99": pct(99),
        "max": round(xs[-1], 6),
    }


def analyze(events: list[dict]) -> dict:
    """The report dict (see module docstring) for a normalized event list."""
    spans = [e for e in events if "dur_s" in e]
    if not events:
        return {"events": 0}
    # Wall excludes the synthetic metadata records: the Chrome export's
    # trace_meta rides at ts=0 (tracer construction), which would anchor
    # the wall at process start and dilute link utilization — and make
    # the same ring report different numbers per export format.
    timed = [
        e for e in events if e["name"] not in ("trace_meta", "process_name")
    ] or events
    t0 = min(e["ts_s"] for e in timed)
    t1 = max(e["ts_s"] + e.get("dur_s", 0.0) for e in timed)
    wall = max(t1 - t0, 1e-9)

    by_name: dict[str, dict[str, float]] = {}
    for s in spans:
        d = by_name.setdefault(s["name"], {"count": 0, "total_s": 0.0})
        d["count"] += 1
        d["total_s"] += s["dur_s"]
    for d in by_name.values():
        d["total_s"] = round(d["total_s"], 6)
        d["mean_s"] = round(d["total_s"] / d["count"], 6)

    stream_busy = _union_seconds(
        [
            (s["ts_s"], s["ts_s"] + s["dur_s"])
            for s in spans
            if s["name"] in STREAM_SPAN_NAMES
        ]
    )
    produce_s = by_name.get(PRODUCE_SPAN, {}).get("total_s", 0.0)
    wait_s = by_name.get(WAIT_SPAN, {}).get("total_s", 0.0)

    # Per-sweep phase profile: spans correlated by sweep_id. The parent
    # "sweep" span is the per-sweep wall, not a phase — reported apart.
    sweeps: dict[int, dict[str, float]] = {}
    sweep_wall = 0.0
    for s in spans:
        sid = s.get("sweep_id")
        if sid is None:
            continue
        if s["name"] == "sweep":
            sweeps.setdefault(int(sid), {})
            sweep_wall += s["dur_s"]
            continue
        ph = sweeps.setdefault(int(sid), {})
        ph[s["name"]] = round(ph.get(s["name"], 0.0) + s["dur_s"], 6)
    phase_totals: dict[str, float] = {}
    for ph in sweeps.values():
        for name, sec in ph.items():
            phase_totals[name] = round(phase_totals.get(name, 0.0) + sec, 6)

    report = {
        "events": len(events),
        "spans": len(spans),
        "wall_s": round(wall, 6),
        "spans_by_name": {k: by_name[k] for k in sorted(by_name)},
        "stream_busy_s": round(stream_busy, 6),
        "link_utilization": round(stream_busy / wall, 4),
        "sweeps": len(sweeps),
        "sweep_wall_s": round(sweep_wall, 6),
        "sweep_phase_s": {k: phase_totals[k] for k in sorted(phase_totals)},
        "ttft_s": _quantiles(
            [
                float(e["seconds"])
                for e in events
                if e["name"] == "ttft" and "seconds" in e
            ]
        ),
        "token_latency_s": _quantiles(
            [
                float(e["seconds"])
                for e in events
                if e["name"] == "token_latency" and "seconds" in e
            ]
        ),
    }
    if produce_s > 0:
        report["overlap_efficiency"] = round(
            max(0.0, min(1.0, (produce_s - wait_s) / produce_s)), 4
        )
        report["source_wait_s"] = round(wait_s, 6)
        report["produce_s"] = round(produce_s, 6)
    drops = [e.get("trace_drops") for e in events if e["name"] == "trace_meta"]
    if drops and drops[-1] is not None:
        report["trace_drops"] = int(drops[-1])
    counts = {}
    for name in (
        "reread_heal", "quarantine", "spill_recompute", "io_retry",
        "engine_recovery", "wave_abort", "watchdog_stall", "wave_admit",
        "request_finish", "hostcache_hit", "hostcache_miss",
    ):
        n = sum(1 for e in events if e["name"] == name)
        if n:
            counts[name] = n
    if counts:
        report["event_counts"] = counts
    return report


def format_report(report: dict) -> str:
    lines = [
        f"trace: {report.get('events', 0)} events, "
        f"{report.get('spans', 0)} spans over "
        f"{report.get('wall_s', 0.0):.3f}s wall",
        f"link utilization: {report.get('link_utilization', 0.0):.1%} "
        f"(stream busy {report.get('stream_busy_s', 0.0):.3f}s)",
    ]
    if "overlap_efficiency" in report:
        lines.append(
            f"compute/stream overlap efficiency: "
            f"{report['overlap_efficiency']:.1%} "
            f"(source_wait {report['source_wait_s']:.3f}s of "
            f"{report['produce_s']:.3f}s produce)"
        )
    if report.get("sweeps"):
        lines.append(
            f"sweeps: {report['sweeps']} "
            f"({report.get('sweep_wall_s', 0.0):.3f}s sweep wall); "
            "per-phase totals:"
        )
        for name, sec in sorted(
            report.get("sweep_phase_s", {}).items(),
            key=lambda kv: -kv[1],
        ):
            lines.append(f"  {name:<16} {sec:.3f}s")
    for key, label in (
        ("ttft_s", "TTFT"),
        ("token_latency_s", "per-token latency"),
    ):
        q = report.get(key) or {}
        if q.get("count"):
            lines.append(
                f"{label}: n={q['count']} p50={q['p50']}s "
                f"p95={q['p95']}s p99={q['p99']}s"
            )
    if report.get("event_counts"):
        lines.append(
            "events: "
            + " ".join(
                f"{k}={v}" for k, v in sorted(report["event_counts"].items())
            )
        )
    if report.get("trace_drops"):
        lines.append(
            f"WARNING: ring overflow dropped {report['trace_drops']} oldest "
            "spans — raise the trace capacity for full-run timelines"
        )
    return "\n".join(lines)


def analyze_bundle(path: str) -> dict:
    """Structured incident report for one bundle: the manifest, journal
    event counts by kind/severity, the correlation-id surface (replicas,
    waves, requests the journal names), and the embedded trace's own
    analyzer report."""
    b = load_bundle(path)
    journal = b["journal"]
    by_kind: dict[str, int] = {}
    by_severity: dict[str, int] = {}
    replicas: set = set()
    waves: set = set()
    requests: set = set()
    for ev in journal:
        by_kind[ev.get("kind", "?")] = by_kind.get(ev.get("kind", "?"), 0) + 1
        sev = ev.get("severity", "?")
        by_severity[sev] = by_severity.get(sev, 0) + 1
        if ev.get("replica") is not None:
            replicas.add(ev["replica"])
        if ev.get("wave_id") is not None:
            waves.add(ev["wave_id"])
        for rid in ev.get("request_ids") or (
            [ev["request_id"]] if ev.get("request_id") is not None else []
        ):
            requests.add(rid)
    report = {
        "path": b["path"],
        "captured_at": b["manifest"].get("captured_at"),
        "trigger": b["manifest"].get("trigger", {}),
        "journal_events": len(journal),
        "events_by_kind": {k: by_kind[k] for k in sorted(by_kind)},
        "events_by_severity": {
            k: by_severity[k] for k in sorted(by_severity)
        },
        "replicas": sorted(replicas),
        "waves": sorted(waves),
        "requests": sorted(requests),
        "journal_health": b["manifest"].get("journal", {}),
        "timeline": journal,
    }
    if b["trace_events"]:
        report["trace_report"] = analyze(b["trace_events"])
    return report


def format_incident(report: dict) -> str:
    """Human timeline for one bundle (``cli incidents analyze``)."""
    trig = report.get("trigger", {})
    lines = [
        f"incident bundle: {report.get('path')}",
        f"captured: {report.get('captured_at')}  trigger: "
        f"{trig.get('kind')} (severity {trig.get('severity')}, "
        f"seq {trig.get('seq')})",
        "events: "
        + (
            " ".join(
                f"{k}={v}"
                for k, v in sorted(report.get("events_by_kind", {}).items())
            )
            or "(empty journal tail)"
        ),
    ]
    corr = []
    if report.get("replicas"):
        corr.append(f"replicas={report['replicas']}")
    if report.get("waves"):
        corr.append(f"waves={report['waves']}")
    if report.get("requests"):
        corr.append(f"requests={len(report['requests'])}")
    if corr:
        lines.append("correlation: " + " ".join(corr))
    health = report.get("journal_health", {})
    if health:
        lines.append(
            f"journal: written={health.get('events_written', 0)} "
            f"dropped={health.get('events_dropped', 0)} "
            f"rotations={health.get('rotations', 0)} "
            f"bundles={health.get('bundles', 0)} "
            f"debounces={health.get('debounces', 0)}"
        )
    lines.append("timeline:")
    t0 = None
    for ev in report.get("timeline", []):
        ts = ev.get("ts")
        if t0 is None and ts is not None:
            t0 = ts
        rel = f"+{ts - t0:8.3f}s" if ts is not None and t0 is not None else " " * 10
        extras = " ".join(
            f"{k}={v}"
            for k, v in ev.items()
            if k not in ("seq", "ts", "kind", "severity")
        )
        lines.append(
            f"  {rel}  #{ev.get('seq', '?'):>5} "
            f"[{ev.get('severity', '?'):>8}] {ev.get('kind', '?')}"
            + (f"  {extras}" if extras else "")
        )
    tr = report.get("trace_report")
    if tr:
        lines.append(
            f"trace: {tr.get('events', 0)} events over "
            f"{tr.get('wall_s', 0.0):.3f}s wall (load "
            f"{report.get('path')}/trace.json in Perfetto)"
        )
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m flexible_llm_sharding_tpu_torch trace-report",
        description="Analyze a --trace recording: link utilization, "
        "compute/stream overlap efficiency, per-phase sweep breakdown, "
        "TTFT and per-token latency quantiles.",
    )
    p.add_argument("--trace", type=str, required=True,
                   help="trace file written by --trace_out (Chrome JSON "
                        "or JSONL), or an incident-bundle directory — "
                        "its embedded trace.json is analyzed")
    p.add_argument("--json", action="store_true",
                   help="emit the full report as one JSON object on stdout")
    args = p.parse_args(argv)
    try:
        events = load_trace(args.trace)
    except (OSError, ValueError, KeyError) as e:
        print(f"trace-report: cannot read {args.trace}: {e!r}",
              file=sys.stderr)
        return 2
    report = analyze(events)
    if args.json:
        print(json.dumps(report))
    else:
        print(format_report(report))
    return 0


__all__ = [
    "analyze",
    "analyze_bundle",
    "format_incident",
    "format_report",
    "journal_tail_len",
    "load_bundle",
    "load_manifest",
    "load_trace",
    "main",
]
