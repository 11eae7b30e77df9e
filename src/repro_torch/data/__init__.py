"""Synthetic data (pure NumPy): keyword audio (``audio.py``) and the LM
token pipeline (``tokens.py``)."""
