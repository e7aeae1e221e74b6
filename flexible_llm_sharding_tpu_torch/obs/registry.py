"""The metrics registry (the JAX package's ``obs/registry.py``): one
place every subsystem's counters register into, one machine-readable way
out.

- ``MetricsRegistry``: named sources (a callable returning a flat dict, or
  any object with ``stats()`` / ``snapshot()``) registered once, collected
  on demand. Collection calls the sources outside the registry lock, and a
  source that raises reports ``{"collect_error": 1}`` instead of taking the
  endpoint down. A source runs on whatever thread collects (the endpoint's
  handler, an incident capture, the fleet's monitor): it returns host
  numbers already gathered and makes no CUDA call.
- ``prometheus_text()``: the text exposition format, one
  ``fls_<source>_<key>`` gauge per numeric leaf (nested levels flattened
  into the name).
- ``MetricsServer``: a threaded HTTP endpoint serving ``/metrics``
  (Prometheus text) and ``/metrics.json`` (the raw collection), the serve
  engine's ``--metrics_port``. Port 0 binds an ephemeral port; the bound
  port is ``server.port``.

``REGISTRY`` is the process-wide instance the executor, the host cache,
the residency tier, the tracer, the journal and the serving metrics
register into; the batch CLI's ``--metrics_out`` dumps it. The serve engine
keeps a registry of its own too (``ServingMetrics.registry``), so its
endpoint and stats line reflect that engine.
"""

from __future__ import annotations

import json
import re
import threading
import weakref

_PROM_BAD = re.compile(r"[^a-zA-Z0-9_]")


def source_snapshot(source) -> dict:
    """Normalize a registered source to a dict: call it if callable, else
    prefer ``stats()`` over ``snapshot()``."""
    if callable(source):
        return source() or {}
    for meth in ("stats", "snapshot"):
        fn = getattr(source, meth, None)
        if callable(fn):
            return fn() or {}
    raise TypeError(
        f"metrics source {source!r} is neither callable nor has "
        "stats()/snapshot()"
    )


class MetricsRegistry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._sources: dict[str, object] = {}  # guarded by: _lock

    def register(self, name: str, source) -> None:
        """Register (or replace — last wins, mirroring the process-wide
        cache/tier precedent) a named source."""
        with self._lock:
            self._sources[name] = source

    def unregister(self, name: str) -> None:
        with self._lock:
            self._sources.pop(name, None)

    def unregister_if(self, name: str, source) -> None:
        """Remove ``name`` only while it still maps to ``source`` — the
        teardown form for last-wins mirrors: a dead engine must drop ITS
        registration without yanking a newer engine's."""
        with self._lock:
            if self._sources.get(name) is source:
                del self._sources[name]

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._sources)

    def collect(self) -> dict[str, dict]:
        """Snapshot every source: ``{source_name: {key: value}}``. Sources
        run outside the registry lock; a raising source yields a loud
        ``collect_error`` marker instead of propagating."""
        with self._lock:
            sources = dict(self._sources)
        out: dict[str, dict] = {}
        for name in sorted(sources):
            try:
                snap = source_snapshot(sources[name])
            except Exception:
                snap = {"collect_error": 1}
            if snap:
                out[name] = snap
        return out

    # -- exposition --------------------------------------------------------

    def prometheus_text(self, prefix: str = "fls") -> str:
        """Prometheus text exposition: every numeric leaf of ``collect()``
        becomes one gauge named ``<prefix>_<source>_<path>``; one nested
        dict level (per-label retry counts, latency summaries) flattens
        into the name. Non-numeric leaves are skipped."""
        lines: list[str] = []

        def emit(name: str, value) -> None:
            if isinstance(value, bool):
                value = int(value)
            if not isinstance(value, (int, float)):
                return
            metric = _PROM_BAD.sub("_", name)
            lines.append(f"# TYPE {metric} gauge")
            lines.append(f"{metric} {value}")

        for source, snap in self.collect().items():
            for key, value in snap.items():
                if isinstance(value, dict):
                    for sub, sv in value.items():
                        if isinstance(sv, dict):  # per-label tables
                            for leaf, lv in sv.items():
                                emit(
                                    f"{prefix}_{source}_{key}_{sub}_{leaf}",
                                    lv,
                                )
                        else:
                            emit(f"{prefix}_{source}_{key}_{sub}", sv)
                else:
                    emit(f"{prefix}_{source}_{key}", value)
        return "\n".join(lines) + "\n"


REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return REGISTRY


def weak_source(obj, attr: str = "stats"):
    """A registry source reading ``obj.<attr>`` through a weakref: the
    registration must not pin a dead runner (executor, decode generator,
    pipeline) in memory for the process lifetime — a collected instance
    simply disappears from the collection (empty snapshot)."""
    ref = weakref.ref(obj)

    def source() -> dict:
        o = ref()
        if o is None:
            return {}
        val = getattr(o, attr, {})
        return val() if callable(val) else val

    return source


class MetricsServer:
    """Threaded HTTP endpoint over a registry: ``/metrics`` (Prometheus
    text) and ``/metrics.json``. Daemon-threaded; ``close()`` is
    idempotent. Binds ``host:port`` eagerly so a taken port fails at
    construction, not at first scrape."""

    def __init__(
        self, registry: MetricsRegistry, port: int = 0,
        host: str = "127.0.0.1",
    ):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        reg = registry

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 (http.server API)
                path = self.path.split("?", 1)[0]
                if path in ("/metrics", "/"):
                    body = reg.prometheus_text().encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif path == "/metrics.json":
                    body = json.dumps(reg.collect()).encode()
                    ctype = "application/json"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args) -> None:
                pass  # scrapes must not spam the serve log

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="metrics-endpoint",
            daemon=True,
        )
        self._thread.start()
        self._closed = False

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=2.0)


__all__ = [
    "REGISTRY",
    "MetricsRegistry",
    "MetricsServer",
    "get_registry",
    "source_snapshot",
]
