"""Launch drivers of the LM stack: the step builders and shape specs
(``steps.py``), the trainer with checkpoint / restart (``train.py``,
``python -m repro_torch.launch.train``), the batched greedy server of the
decoder LMs (``serve.py``, ``python -m repro_torch.launch.serve``; the
encoder-decoder is served through the step builders,
``crosscheck.encdec_generate``) and the card-against-CPU checks
(``crosscheck.py``).  The meshes, the dry run and the pipeline are not
ported yet (``ROADMAP.md`` queue 1, item 7g)."""
