"""CLI: `python -m nextpolish_tpu_torch run.cfg [-l log] [--device
cuda|cpu]` (source/nextPolish:532-553).

Runs the run.cfg pipeline (pipeline.py) in one process on one device:
`cuda` (the default) or, when the caller asks for it, `cpu`.  Asking for
`cuda` on a machine without a usable card raises (device.resolve_device).
"""
from __future__ import annotations

import argparse
import logging
import sys

from . import __version__
from .config import load_config
from .device import resolve_device
from .kit import plog


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="nextpolish_tpu_torch",
        description="Genome polishing (NextPolish capabilities) on one "
                    "NVIDIA card with PyTorch and CUDA.",
    )
    parser.add_argument("config", help="run.cfg configuration file")
    parser.add_argument("-l", "--log", default=None, help="log file")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="device of every device stage (default cuda)")
    parser.add_argument("-v", "--version", action="version",
                        version=f"%(prog)s {__version__}")
    args = parser.parse_args(argv)

    log = plog()
    if args.log:
        handler = logging.FileHandler(args.log)
        handler.setFormatter(log.handlers[0].formatter)
        log.addHandler(handler)

    from .parallel.hosts import process_count
    from .pipeline import Pipeline

    process_count()
    device = resolve_device(args.device)
    cfg = load_config(args.config)
    log.info("scheduled tasks: %s on %s", cfg.task, device)
    asm = Pipeline(cfg, device=device).run()
    log.info("done: %s", asm)
    return 0


if __name__ == "__main__":
    sys.exit(main())
