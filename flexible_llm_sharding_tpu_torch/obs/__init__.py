"""Observability of the port (the JAX package's ``obs/``): the span tracer
(``trace``), the metrics registry and its endpoint (``registry``), the event
journal (``events``), incident bundles (``incident``), the trace and bundle
analyzer behind ``trace-report`` and ``incidents`` (``report``) and the SLO
error-budget tracker (``slo``). Submodules are imported directly: this
package root stays empty so hot-path modules can depend on them."""
