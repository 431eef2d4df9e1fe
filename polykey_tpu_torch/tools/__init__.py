"""Measurement tools for the port, run on a GPU (see each module's docstring)."""
