"""The control of a cell's check: the plain reference put in the
program's place, computed in the precision just below the one the
configuration states (the job kind's CONTROL_DTYPE), and judged by the
same comparison as the program's output.  It has to come out as not
correct for the check to mean anything; the runs of the benchmark do not
run it.

    python3 npbench/control.py --workload <cell> --seeds 1,2,3 \
        [--device cuda] [--contigs all|sample]

For each seed it makes the cell's pool from the seed as a run does, and
for the contigs a run's check would draw (or every contig of the pool)
prints the mismatched bases of the control against the reference (and
of the draft left unchanged), with the seconds each took, and last one
JSON line with every reading.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from npbench import harness  # noqa: E402


def readings(workload: str, seed: int, device: str, every: bool = False,
             traffic: dict | None = None, root: str = harness.ROOT) -> list:
    """[(block, contig, bases, mismatched bases of the control, of the
    draft (the fault "a step that returns its state unchanged"),
    seconds)]."""
    spec = harness.cell_spec(workload, root)
    cfg, traffic = spec["config"], traffic or spec["traffic"]
    kind = harness.job_kind(cfg)
    work = tempfile.mkdtemp(prefix="npbench.control.",
                            dir=tempfile.gettempdir())
    try:
        sd = harness.seeds_of(seed, 4)
        blocks = [harness.make_block(cfg, lens, s, work, f"block{b}",
                                     root)
                  for b, (lens, s) in enumerate(
                      zip(traffic["pool"],
                          harness.seeds_of(sd[0], len(traffic["pool"]))))]
        pairs = [(b.name, i) for b in blocks for i in range(len(b.names))]
        pairs = (sorted(pairs) if every else harness.sampled_contigs(
            seed, pairs, traffic.get("check_contigs", 1)))
        out = []
        for bname, i in pairs:
            b = next(x for x in blocks if x.name == bname)
            t = time.perf_counter()
            ref = harness.serialize(kind.reference(b, i, device, cfg))
            ctl = harness.serialize(kind.reference(b, i, device, cfg,
                                                   kind.CONTROL_DTYPE))
            draft = harness.serialize([(b.names[i], b.drafts[i])])
            out.append((bname, b.names[i], len(b.drafts[i]),
                        harness.mismatches(ctl, ref),
                        harness.mismatches(draft, ref),
                        time.perf_counter() - t))
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="npbench/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--contigs", choices=["sample", "all"], default="sample")
    a = p.parse_args(argv)
    allr = {}
    for seed in [int(s) for s in a.seeds.split(",")]:
        rs = readings(a.workload, seed, a.device, a.contigs == "all")
        for bname, cname, n, mm, unchanged, sec in rs:
            print(f"control seed {seed} {bname}/{cname} {n} bases: "
                  f"mismatched_bases {mm}, the draft unchanged "
                  f"{unchanged} ({sec:.2f} s)", flush=True)
        allr[seed] = [list(r[:5]) for r in rs]
    print(json.dumps({"workload": a.workload, "readings": allr}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
