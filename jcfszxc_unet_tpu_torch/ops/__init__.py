"""Operators: layers, blocks and the hand-written kernels."""
