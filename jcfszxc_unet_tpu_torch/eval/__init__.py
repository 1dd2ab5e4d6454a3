"""Tiled inference, metrics and the Predictor."""
