"""Launch drivers of the LM stack: the step builders (``steps.py``) and the
batched greedy server (``serve.py``, ``python -m repro_torch.launch.serve``).
The trainer, the meshes, the dry run and the pipeline are not ported yet
(``ROADMAP.md`` queue 1, items 7b and 7g)."""
