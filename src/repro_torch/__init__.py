"""PyTorch / CUDA port of the IMC keyword-spotting accelerator model.

``repro_torch`` mirrors the module layout of the JAX package ``repro`` so
each port module sits where its reference does (``core/imc.py`` beside
``repro/core/imc.py`` and so on).  It imports neither JAX nor anything of
``repro``; the tests hold each module against its JAX counterpart on the
CPU, bit for bit wherever the reference is exact.

Device rule: every entry point (``models.kws.init_params``,
``models.kws.hw_forward``, ``serving.stream.StreamEngine``,
``serving.scheduler.StreamServer``) takes ``device=None``, and ``None``
means ``"cuda"``.  Without a card the caller must pass ``device="cpu"``
explicitly; nothing falls back to the CPU on its own
(``kernels.resolve_device``).  On a CUDA tensor a kernel wrapper launches
its hand-written kernel or raises; its plain PyTorch version runs only for
CPU tensors.
"""
