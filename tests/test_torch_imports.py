"""The port stands alone: every module of nextpolish_tpu_torch imports
(kmer_count, parallel/shard, the aligner, the pipeline and calib among
them), and the CPU slices (worker2 and its level scan over two device
entries, worker1 -t 1 and task 1's router and round-robin over two
device entries, then -t 2 on its output, worker1 -t 3, -t 4 on its
output and -t 5, td_score_chain_contig, and the run.cfg pipeline through
`python -m nextpolish_tpu_torch`) run end to end, and the launcher parses
its arguments and splits the cards (launch.main, launch.rank_cards,
parallel.hosts), with `jax` and `nextpolish_tpu` made unimportable in the
process."""
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "nextpolish_tpu_torch"

SCRIPT = r'''
import importlib, os, pathlib, sys, tempfile
sys.modules["jax"] = None
sys.modules["nextpolish_tpu"] = None
root = pathlib.Path(sys.argv[1])
sys.path.insert(0, str(root))
mods = sorted(
    ".".join(p.relative_to(root).with_suffix("").parts)
    for p in (root / "nextpolish_tpu_torch").rglob("*.py"))
for m in mods:
    importlib.import_module(m.removesuffix(".__init__"))
from nextpolish_tpu_torch import sim, worker1, worker2
from nextpolish_tpu_torch.__main__ import main as run_cfg
from nextpolish_tpu_torch.align.extend import band_align_core, band_traceback
from nextpolish_tpu_torch.models.cns.level_scan import level_chain, level_winners
from nextpolish_tpu_torch.ops.chain import forward_states, traceback_batch
from nextpolish_tpu_torch.io import bam as bamio
from nextpolish_tpu_torch.models.score_chain import (AlgoConfig,
                                                     td_score_chain_contig)
os.environ["NPT_CNS_ENGINE"] = "device"
with tempfile.TemporaryDirectory() as d:
    case = sim.simulate_case(4, 1, 3000, 10, read_len=(1000, 2500))
    fa, bam = sim.write_case(case, d)
    out = os.path.join(d, "out.fa")
    assert worker2.main(["-g", fa, "-l", bam, "-r", "ont", "-o", out,
                         "--device", "cpu"]) == 0
    lines = open(out, "rb").read().split(b"\n")
    assert lines[0].startswith(b">ctg0 ") and len(lines[1]) > 2900
    # engine 2's groups over two device entries, as over one
    import numpy as np
    from nextpolish_tpu_torch.device import resolve_devices
    from nextpolish_tpu_torch.models.cns import device_dp
    from nextpolish_tpu_torch.models.cns.window import window_prep
    w = window_prep(bamio.read_bam(bam), 0,
                    np.frombuffer(case.drafts[0], dtype=np.uint8), 0,
                    len(case.drafts[0]), "ont", None, case.names[0])
    dws = [device_dp.prepare_window(w.merged, w.coverage, w.L)[1]] * 9
    one = device_dp._run_batch(dws, "ont", devices=["cpu"])
    two = device_dp._run_batch(dws, "ont",
                               devices=resolve_devices(["cpu", "cpu"]))
    assert all((a[0] == b[0]).all() and (a[1] == b[1]).all()
               for a, b in zip(one, two))
    case = sim.simulate_short_case(5, [3000, 1200], 20)
    fa, bam = sim.write_case(case, os.path.join(d, "short"))
    out = os.path.join(d, "short.fa")
    assert worker1.main(["-g", fa, "-s", bam, "-t", "1", "-o", out,
                         "--device", "cpu"]) == 0
    lines = open(out, "rb").read().split(b"\n")
    assert lines[0].startswith(b">ctg0 ") and len(lines[1]) > 2900
    assert lines[2].startswith(b">ctg1 ") and len(lines[3]) > 1100
    # several devices in one process: the router's sharded route and the
    # contig round-robin over two device entries
    from nextpolish_tpu_torch.models.score_chain import (
        estimate_read_tlen, score_chain_pipeline,
        score_chain_pipeline_multichip)
    two = resolve_devices(["cpu", "cpu"])
    tb = bamio.read_bam(bam)
    cfg = AlgoConfig()
    cfg.read_tlen = estimate_read_tlen(tb, cfg)
    pairs = list(zip(case.names, case.drafts))
    want = list(score_chain_pipeline(pairs, tb, cfg, devices="cpu"))
    for shard_min in (2000, 10 ** 9):
        assert list(score_chain_pipeline_multichip(
            pairs, tb, cfg, devices=two, shard_min=shard_min)) == want
    out2 = os.path.join(d, "short2.fa")
    assert worker1.main(["-g", out, "-s", bam, "-t", "2", "-o", out2,
                         "--device", "cpu"]) == 0
    lines2 = open(out2, "rb").read().split(b"\n")
    assert [len(x) for x in lines2[1::2]] == [len(x) for x in lines[1::2]]
    # tasks 3, 4 and legacy 5 on a diploid contig with long reads, and
    # the long-read chain variant
    dip = sim.simulate_diploid_case(6, [4000], 30, 0.002, 1, 400,
                                    long_depth=20)
    fa, bam = sim.write_case(dip, os.path.join(d, "dip"))
    lbam = os.path.join(d, "dip", "long.bam")
    hdr = bamio.BamHeader("", dip.names, [len(x) for x in dip.drafts])
    bamio.write_bam(lbam, hdr, dip.long_records, index=True)
    for task, genome, reads in (
            ("3", fa, ["-s", bam, "-l", lbam]),
            ("4", os.path.join(d, "t3.fa"), ["-s", bam, "-l", lbam]),
            ("5", fa, ["-l", lbam])):
        out_t = os.path.join(d, f"t{task}.fa")
        assert worker1.main(["-g", genome, *reads, "-t", task, "-o",
                             out_t, "--device", "cpu"]) == 0
        rec = open(out_t, "rb").read().split(b"\n")
        assert rec[0].startswith(b">ctg0 ") and len(rec[1]) > 3900
    td = td_score_chain_contig("ctg0", dip.drafts[0], bamio.read_bam(lbam),
                               AlgoConfig(), device="cpu")
    assert len(td) > 3900
    # the run.cfg pipeline, task 12, on the built-in mapper
    proj = os.path.join(d, "proj")
    sim.write_project(proj, case.names, case.drafts, "12", sgs=case.records)
    assert run_cfg([os.path.join(proj, "run.cfg"), "--device", "cpu"]) == 0
    asm = open(os.path.join(proj, "work", "genome.nextpolish.fasta"),
               "rb").read().split(b"\n")
    assert [len(x) for x in asm[1::2]] == [len(x) for x in lines[1::2]]
# the launcher's arguments and the process protocol, one process here
from nextpolish_tpu_torch import launch
from nextpolish_tpu_torch.parallel import hosts
seen = []
launch.launch_local = lambda *a: seen.append(a) or 0
assert launch.main(["--nprocs", "2", "run.cfg", "--device", "cpu"]) == 0
assert [(a[0], a[1], a[3]) for a in seen] == [("run.cfg", 2, "cpu")]
assert launch.rank_cards(["0", "1", "2", "3"], 2) == ["0,2", "1,3"]
assert launch._worker_cmd("run.cfg", "cpu")[1:] == [
    "-m", "nextpolish_tpu_torch", "run.cfg", "--device", "cpu"]
assert hosts.init_distributed() == 1 and hosts.process_index() == 0
assert band_align_core.launches == 0 and band_traceback.launches == 0
assert level_chain.launches == 0 and level_winners.launches == 0
assert forward_states.launches == 0 and traceback_batch.launches == 0
assert not any(k == "jax" or k.startswith("jax.") for k, v in sys.modules.items() if v is not None)
print("OK", len(mods))
'''


def test_port_runs_with_jax_blocked():
    r = subprocess.run([sys.executable, "-c", SCRIPT, str(ROOT)],
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.strip().startswith("OK")


def test_no_source_names_jax_or_the_jax_package():
    """No import of jax or of nextpolish_tpu in the port's sources or in
    chip_smoke.py (the blocked-import run above covers what executes;
    this covers every line)."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|nextpolish_tpu)(\s|\.|$)")
    files = list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = [f"{f}:{i + 1}" for f in files
           for i, line in enumerate(f.read_text().splitlines())
           if pat.match(line)]
    assert not bad, bad
