"""Launch drivers of the LM stack: the step builders and shape specs
(``steps.py``), the trainer with checkpoint / restart (``train.py``,
``python -m repro_torch.launch.train``), the batched greedy server of the
decoder LMs (``serve.py``, ``python -m repro_torch.launch.serve``; the
encoder-decoder is served through the step builders,
``crosscheck.encdec_generate``) and the card-against-CPU checks
(``crosscheck.py``), and the multi-rank code on ``torch.distributed``:
process groups and meshes (``mesh.py``), ``MeshPolicy``'s partition specs
(``mesh_policy.py``), the sharded steps (``sharded.py``, reached through
``steps.make_*_step(policy=)``), re-meshing and resharding
(``elastic.py``), GPipe (``pipeline.py``), the roofline and the
collective counter (``analysis.py``) and the dry run (``dryrun.py``,
``python -m repro_torch.launch.dryrun --arch all --shape all
--both-meshes``).

Multi-rank code runs under ``torchrun --nproc-per-node N`` on N cards
(``mesh.init_distributed()`` reads torchrun's environment) or, on the
CPU, in gloo ranks (``tests/test_torch_distributed.py`` spawns 8); one
card runs a world-1 NCCL group (``python3 chip_smoke.py --launch``)."""
