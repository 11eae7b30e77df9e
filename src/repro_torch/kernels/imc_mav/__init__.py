"""The IMC kernels: the fused layer (``csrc/imc_fused.cu``) and the
per-group product tile (``csrc/imc_mav.cu``), their wrappers ``ops.py``
and their plain PyTorch versions ``ref.py``."""
