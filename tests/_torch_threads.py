"""Caps torch's CPU intra-op threads in the port's test processes.

The port's CPU tests are thousands of small eager ops.  With torch's
default of one OpenMP thread per core, every pytest-xdist worker spins a
full team on every op, and six workers on an eight-core host spend most
of their time waiting for one another.  Each ``tests/test_torch_*.py``
that runs on the CPU imports this module first, and every xdist worker
collects every test module, so the cap holds in each worker before any
test runs.  JAX's threads are not torch's and keep their count.
"""

import torch

torch.set_num_threads(1)
