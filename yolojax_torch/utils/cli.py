"""Shared CLI plumbing (port of ``yolojax/utils/cli.py``): ``-c`` takes
several layered INI files, positional ``section.key=value`` overrides,
logging setup."""

from __future__ import annotations

import argparse
import logging
import os
import sys


def make_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument(
        "-c", "--config", action="append", default=[],
        help="INI config file (repeatable; later files override earlier)",
    )
    p.add_argument(
        "overrides", nargs="*", default=[],
        help="section.key=value config overrides",
    )
    p.add_argument("--logging", default="info",
                   help="log level (debug/info/warning/error)")
    return p


def setup(args):
    logging.basicConfig(
        level=getattr(logging, args.logging.upper(), logging.INFO),
        format="%(asctime)s %(levelname).1s %(name)s] %(message)s",
        stream=sys.stderr,
    )
    from yolojax_torch.config import load_config

    configs = args.config or (["config.ini"] if os.path.exists("config.ini")
                              else [])
    if not configs:
        raise SystemExit("no config file found; pass -c config.ini")
    return load_config(configs, args.overrides)
