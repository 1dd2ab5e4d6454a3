"""Checkpoints (training itself is not ported yet)."""
