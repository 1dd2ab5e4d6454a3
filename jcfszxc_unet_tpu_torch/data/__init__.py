"""Dataset loading and patch sampling."""
