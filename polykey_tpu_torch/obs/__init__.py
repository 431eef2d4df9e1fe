"""Observability helpers used by the engine metrics (histograms)."""
