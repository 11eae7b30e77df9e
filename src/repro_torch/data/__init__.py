"""Synthetic keyword audio (pure NumPy)."""
