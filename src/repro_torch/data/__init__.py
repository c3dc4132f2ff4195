"""Data pipeline (port of ``data/``)."""
