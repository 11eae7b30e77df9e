"""Launch drivers of the LM stack: the step builders and shape specs
(``steps.py``), the trainer with checkpoint / restart (``train.py``,
``python -m repro_torch.launch.train``), the batched greedy server
(``serve.py``, ``python -m repro_torch.launch.serve``) and the card-against-
CPU checks (``crosscheck.py``).  The meshes, the dry run and the pipeline
are not ported yet (``ROADMAP.md`` queue 1, item 7g)."""
