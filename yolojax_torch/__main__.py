"""``python -m yolojax_torch <command> [args...]``: one dispatcher over the
port's CLI entry points (port of ``yolojax/__main__.py``), with yolojax's
command table. Each command takes the flags of its
``yolojax_torch.cli.<module>``; ``--help`` exits 0, no command or an
unknown one exits 2.
"""

from __future__ import annotations

import importlib
import sys

COMMANDS = {
    "cache": "cache",
    "train": "train",
    "detect": "detect",
    "detect-camera": "detect_camera",
    "eval": "eval",
    "export": "export",
    "parse-darknet": "parse_darknet",
    "qat": "qat",
    "serve": "serve",
    "kmeans-anchors": "kmeans_anchors",
    "demo-augmentation": "demo_data_augmentation",
}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        names = " | ".join(sorted(COMMANDS))
        print(f"usage: python -m yolojax_torch <command> [args...]\n"
              f"commands: {names}\n"
              f"each command takes the flags of its yolojax_torch.cli module "
              f"(try: python -m yolojax_torch train --help)")
        return 0 if argv else 2
    cmd, rest = argv[0], argv[1:]
    if cmd not in COMMANDS:
        print(f"unknown command {cmd!r}; run `python -m yolojax_torch "
              f"--help`", file=sys.stderr)
        return 2
    mod = importlib.import_module(f"yolojax_torch.cli.{COMMANDS[cmd]}")
    sys.argv = [f"yolojax_torch-{cmd}"] + rest
    mod.main()
    return 0


if __name__ == "__main__":
    sys.exit(main())
