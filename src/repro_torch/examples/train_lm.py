"""End-to-end LM training on a reduced architecture, with checkpoint /
restart (stop it mid-run and run it again: it resumes): the port of
``examples/train_lm.py``.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm [arch] \\
          [--device cpu]

The default arch is qwen3-moe-30b-a3b; 40 steps at batch 8, seq 64, a
checkpoint every 10 under ``<tmp>/repro_ckpt_<arch>``.  ``--steps``,
``--ckpt-dir``, ``--ckpt-every`` and ``--fail-at`` (a simulated failure
at that step) change the run.
"""

import argparse
import os
import tempfile
from typing import List, Optional

from repro_torch.launch.train import train_loop


def main(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("arch", nargs="?", default="qwen3-moe-30b-a3b")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: <tmp>/repro_ckpt_<arch>")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: cuda)")
    args = ap.parse_args(argv)
    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                             "repro_ckpt_" + args.arch)
    params, metrics = train_loop(args.arch, steps=args.steps, reduced=True,
                                 batch=8, seq=64, ckpt_dir=ckpt_dir,
                                 ckpt_every=args.ckpt_every, log_every=5,
                                 fail_at=args.fail_at, device=args.device)
    print(f"[train_lm] {args.arch} final: {metrics}")
    return params, metrics


if __name__ == "__main__":
    main()
