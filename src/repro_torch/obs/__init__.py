"""Serving observability: the metrics registry behind ``stats()``."""
