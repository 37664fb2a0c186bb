"""A stand-in job kind and a scratch copy of the benchmark's files, for
tests that drive the harness without the program."""
import json
import os
import shutil
import sys
import time
import types

from npbench import harness

SHORT = {"kind": "paired_end", "depth": 5, "read_len": 150,
         "insert_mean": 350, "insert_sd": 35, "sub": 0.01, "ins": 0.002,
         "del": 0.002}


def stub_kind(name: str, job_s: float = 0.0, alter=None):
    """A job kind registered as npbench.jobs.<name>: a job sleeps job_s
    and writes the drafts as the polish (`alter` may change the list of
    (name, seq) it writes); its reference is the draft."""
    mod = types.ModuleType("npbench.jobs." + name)
    mod.CONTROL_DTYPE = None

    def run(block, out, device, config):
        time.sleep(job_s)
        recs = list(zip(block.names, block.drafts))
        if alter is not None:
            recs = alter(recs)
        with open(out, "wb") as fh:
            for n, s in recs:
                fh.write(b">%s %d\n%s\n" % (n.encode(), len(s), s))

    def reference(block, i, device, config, dtype=None):
        return [(block.names[i], block.drafts[i])]

    mod.run, mod.reference = run, reference
    sys.modules[mod.__name__] = mod
    return mod


def scratch_root(tmp, job: str, pool, metrics=("polished_bases_per_s",
                                               "setup_s"),
                 per_layer=(), cell="stub.chrom", config="stub_cfg",
                 check_contigs=1):
    """A directory with a BENCHMARK.json of one cell and the benchmark's
    readers and read generators, the cell's config and traffic in files
    of their own."""
    root = str(tmp)
    os.makedirs(os.path.join(root, "npbench", "configs"), exist_ok=True)
    os.makedirs(os.path.join(root, "npbench", "cells"), exist_ok=True)
    for d in ("metrics", "gens"):
        shutil.copytree(os.path.join(harness.ROOT, "npbench", d),
                        os.path.join(root, "npbench", d),
                        dirs_exist_ok=True)
    with open(os.path.join(root, "npbench", "configs", config + ".json"),
              "w") as fh:
        json.dump({"name": config, "job": job, "reads": SHORT,
                   "draft_sub": 0.005}, fh)
    with open(os.path.join(root, "npbench", "cells", cell + ".json"),
              "w") as fh:
        json.dump({"config": config, "traffic": "chrom", "pool": pool,
                   "check_contigs": check_contigs}, fh)
    man = {"command": ["python3", "npbench/run.py"], "paths": ["npbench"],
           "run_seconds": 1,
           "configs": [{"name": config, "source": "x",
                        "file": f"npbench/configs/{config}.json",
                        "reduced": [], "why": "x"}],
           "workloads": [{"name": cell, "config": config,
                          "traffic": "chrom", "chips": 1, "why": "x"}],
           "end_to_end": [{"name": m, "unit": "u", "better": "lower",
                           "bound": 0.1, "source": "host_clock"}
                          for m in metrics],
           "per_layer": [{"name": m, "unit": "u", "better": "lower",
                          "source": "device_trace", "layer": "x",
                          "moves": metrics[0], "workloads": [cell]}
                         for m in per_layer]}
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(man, fh)
    return root
