"""The port's runnable examples, one module each, run as

    PYTHONPATH=src python -m repro_torch.examples.<name> [--device cpu]

``quickstart`` (the paper's pipeline end to end), ``stream_kws`` (always-on
multi-stream serving), ``customize_onchip`` (the Table IV ablation and an
enrollment session, asserted bit-identical to the offline loop),
``serve_lm`` (the LM server on a reduced config) and ``train_lm`` (LM
training with checkpoint / restart on a reduced config, by default the
qwen3-moe-30b-a3b mixture of experts).  They mirror the JAX
package's ``examples/`` files and print the same landmark lines; the
device defaults to CUDA.  ``REPRO_EXAMPLES_SMOKE=1`` runs the KWS
examples at their smoke sizes.
"""

import argparse
import os
from typing import List, Optional


def smoke() -> bool:
    """Whether ``REPRO_EXAMPLES_SMOKE=1`` asks for the smoke sizes."""
    return os.environ.get("REPRO_EXAMPLES_SMOKE") == "1"


def device_arg(description: str, argv: Optional[List[str]] = None):
    """The examples' command line: ``--device`` (default: cuda)."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: cuda)")
    return ap.parse_args(argv).device
