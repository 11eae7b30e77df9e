"""Architecture configs of the LM stack (``base.py``: ``ArchConfig``, the
registry ``get_config`` and the assigned ``SHAPES``), one file per
architecture, and the paper's KWS net (``kws_paper.py``)."""

from repro_torch.configs.base import ARCH_IDS, SHAPES, ArchConfig, get_config

__all__ = ["ARCH_IDS", "SHAPES", "ArchConfig", "get_config"]
