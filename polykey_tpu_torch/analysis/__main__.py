"""Entry point for ``python -m polykey_tpu_torch.analysis graph ...``."""

import sys


def main(argv: list) -> int:
    if not argv or argv[0] != "graph":
        print("usage: python -m polykey_tpu_torch.analysis graph [options] "
              "(graph is the port's one tier; --help after it for its options)",
              file=sys.stderr)
        return 2
    from .graph import main as graph_main

    return graph_main(argv[1:])


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
