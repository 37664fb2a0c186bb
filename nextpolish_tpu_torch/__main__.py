"""CLI: `python -m nextpolish_tpu_torch run.cfg [-l log] [--device
cuda|cpu]` (source/nextPolish:532-553).

Runs the run.cfg pipeline (pipeline.py) on `cuda` (the default: every
visible card, CUDA_VISIBLE_DEVICES restricts them; task 1 spreads over
them and the other stages run on the first) or, when the caller asks for
it, `cpu`.  Asking for `cuda` on a machine without a usable card raises
(device.resolve_devices).  With the NPT_* or SLURM environment of
parallel/hosts.py (launch.py sets it), the process is one rank of
several: it polishes its block of contigs on its own cards and rank 0
gathers.  At the end each rank logs its cards and its hand-kernel launch
counts.
"""
from __future__ import annotations

import argparse
import json
import logging
import re
import sys

import torch

from . import __version__
from .config import load_config
from .device import resolve_devices
from .kit import plog

# each rank's last line, as main logs it: its devices joined by commas,
# then the cards' names joined by ", " in brackets
RANK_LINE = re.compile(r"rank (\d+) of (\d+) on (\S+?)(?: \((.*)\))?: kernel "
                       r"launches (\{.*\}), engine-2 windows (\d+)")


def rank_lines(text: str) -> dict:
    """The end-of-run lines in `text` (the log of one or more ranks):
    {rank: (processes, devices, cards or None, kernel launches, engine-2
    windows)}."""
    return {int(m[1]): (int(m[2]), m[3], m[4], json.loads(m[5]), int(m[6]))
            for m in RANK_LINE.finditer(text)}


def kernel_launches() -> dict:
    """This process's launches of each hand-written kernel so far."""
    from .align import extend
    from .models.cns import level_scan
    from .ops import chain

    return {"level_chain": level_scan.level_chain.launches,
            "level_winners": level_scan.level_winners.launches,
            "chain_forward": chain.forward_states.launches,
            "chain_traceback": chain.traceback_batch.launches,
            "band_align": extend.band_align_core.launches,
            "band_traceback": extend.band_traceback.launches}


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="nextpolish_tpu_torch",
        description="Genome polishing (NextPolish capabilities) on NVIDIA "
                    "cards with PyTorch and CUDA.",
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

    # before the pipeline is imported, as the JAX package's CLI does
    from .parallel.hosts import init_distributed, process_index

    nproc = init_distributed()
    try:
        rank = process_index()
        if nproc > 1:
            log.info("multi-host run: rank %d of %d", rank, nproc)
        from .pipeline import Pipeline
        from .runtime import trace

        devices = resolve_devices(args.device)
        where = ",".join(str(d) for d in devices)
        card = (" (" + ", ".join(torch.cuda.get_device_name(d)
                                 for d in devices) + ")"
                if devices[0].type == "cuda" else "")
        cfg = load_config(args.config)
        log.info("scheduled tasks: %s on %s%s", cfg.task, where, card)
        asm = Pipeline(cfg, device=devices).run()
        log.info("done: %s", asm)
        windows = trace.snapshot("cns.windows").get("cns.windows", {})
        log.info("rank %d of %d on %s%s: kernel launches %s, engine-2 "
                 "windows %d", rank, nproc, where, card,
                 json.dumps(kernel_launches()), windows.get("s", 0))
    finally:
        if nproc > 1:
            torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
