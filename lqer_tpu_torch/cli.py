"""Console entry point (port of ``lqer_tpu/cli.py``):

    python -m lqer_tpu_torch.cli pipeline <config.toml> [tags...] [--device cuda|cpu] [--a:b:c=v ...]
    python -m lqer_tpu_torch.cli serve <config.toml> --prompt "1 2 3" [--pallas --scan-layers] [--device cuda|cpu]
    python -m lqer_tpu_torch.cli sweep <template.toml> --method lqer-act --ranks 8 32 ... [--device cuda|cpu] [--dry-run]
    python -m lqer_tpu_torch.cli collect-results <checkpoints-dir> [--out-prefix collected]
    python -m lqer_tpu_torch.cli chunked-approximate <config.toml> [tags...] --approximate:chunk_idx=:ast:0 --approximate:chunk_size=:ast:4 [--device cuda|cpu]
    python -m lqer_tpu_torch.cli merge-chunks <project-dir>

``pipeline`` runs profile → approximate → evaluate perplexity → the
harness tasks (``runners.run_pipeline``), ``serve`` the serving CLI
(``serving/cli.py``), ``sweep`` the pipeline over a grid of ranks and
widths (``sweep.py``), ``collect-results`` gathers result JSONs into CSVs
(``collect.py``), ``chunked-approximate`` one chunk of the approximation
and ``merge-chunks`` a directory of chunks (``chunked_runners.py``). All
but ``collect-results`` and ``merge-chunks``, which only read and write
files, run on the card unless ``--device cpu``.
"""

from __future__ import annotations

import sys

_USAGE = __doc__.split("\n\n")[1]


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
    elif cmd == "sweep":
        from .sweep import main as sweep_main

        sweep_main(rest)
    elif cmd == "collect-results":
        from .collect import main as collect_main

        collect_main(rest)
    elif cmd == "chunked-approximate":
        from .chunked_runners import run_chunked_approximator

        run_chunked_approximator(rest)
    elif cmd == "merge-chunks":
        from .chunked_runners import merge_chunks

        if len(rest) != 1:
            print("usage: python -m lqer_tpu_torch.cli merge-chunks "
                  "<project-dir>", file=sys.stderr)
            return 2
        merge_chunks(rest[0])
    else:
        print(f"unknown subcommand {cmd!r}\nusage:\n" + _USAGE,
              file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
