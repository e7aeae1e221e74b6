"""Observability of the port: the SLO error-budget tracker (``slo``)."""
