"""Batched LM serving demo (teacher-forced prefill + greedy decode) on a
reduced config: the port of ``examples/serve_lm.py``.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_lm [arch] \\
          [--device cpu]
"""

import sys

from repro_torch.launch.serve import main as serve_main


def main(argv=None) -> None:
    args = list(sys.argv[1:] if argv is None else argv)
    if args and not args[0].startswith("-"):
        args = ["--arch", args[0]] + args[1:]
    serve_main(args)


if __name__ == "__main__":
    main()
