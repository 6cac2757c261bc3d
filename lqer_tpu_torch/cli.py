"""Console entry point (port of ``lqer_tpu/cli.py``):

    python -m lqer_tpu_torch.cli pipeline <config.toml> [tags...] [--device cuda|cpu] [--a:b:c=v ...]
    python -m lqer_tpu_torch.cli serve <config.toml> --prompt "1 2 3" [--pallas --scan-layers] [--device cuda|cpu]

``pipeline`` runs profile → approximate → evaluate perplexity
(``runners.run_pipeline``), ``serve`` the serving CLI
(``serving/cli.py``). Both run on the card unless ``--device cpu``. The
JAX package's other subcommands (sweep, collect-results,
chunked-approximate, merge-chunks) are not ported yet and exit with 2.
"""

from __future__ import annotations

import sys

_USAGE = __doc__.split("\n\n")[1]
_NOT_PORTED = ("sweep", "collect-results", "chunked-approximate",
               "merge-chunks")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage:\n" + _USAGE)
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd == "pipeline":
        from .runners import run_pipeline

        run_pipeline(rest)
    elif cmd == "serve":
        from .serving.cli import main as serve_main

        serve_main(rest)
    elif cmd in _NOT_PORTED:
        print(f"lqer_tpu_torch.cli {cmd}: not ported yet", file=sys.stderr)
        return 2
    else:
        print(f"unknown subcommand {cmd!r}\nusage:\n" + _USAGE,
              file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
