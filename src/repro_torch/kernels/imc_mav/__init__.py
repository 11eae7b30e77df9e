"""The fused IMC layer: Hopper kernel ``csrc/imc_fused.cu``, its wrapper
``ops.py`` and its plain PyTorch version ``ref.py``."""
