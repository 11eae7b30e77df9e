"""The fused SGA optimizer update: Hopper kernel ``csrc/sga_update.cu``,
its wrapper ``ops.py`` and its plain PyTorch version ``ref.py``."""
