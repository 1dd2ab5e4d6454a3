"""Probe scripts of the port; each runs only under ``python -m``."""
