"""The chip's 8-bit fixed-point FC datapath: Hopper kernel
``csrc/int8_matmul.cu``, its wrapper ``ops.py`` and its plain PyTorch
version ``ref.py``."""
