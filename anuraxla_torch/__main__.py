"""``python -m anuraxla_torch <command> [args...]`` — the dispatcher of
``anuraxla/__main__.py`` over the port's commands (``cli.COMMANDS``, aliases
``cli.ALIASES``)."""

import importlib
import sys

from anuraxla_torch.cli import ALIASES, COMMANDS


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m anuraxla_torch <command> [args...]\n\ncommands:")
        for name in COMMANDS:
            print(f"  {name}")
        print("\naliases (reference script numbers):", ", ".join(ALIASES))
        raise SystemExit(0 if argv else 1)

    cmd = ALIASES.get(argv[0], argv[0])
    if cmd not in COMMANDS:
        raise SystemExit(f"unknown command: {cmd!r} (try --help)")
    sys.argv = [f"anuraxla_torch {cmd}"] + argv[1:]
    importlib.import_module(COMMANDS[cmd]).main(argv[1:])


if __name__ == "__main__":
    main()
