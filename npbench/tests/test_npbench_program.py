"""The harness on the program, on the CPU at a size a test can hold: the
references agree with `worker1 -t 1` and `worker2 -r ont` (device engine)
run with `--device cpu`; a run with the timed path broken underneath
comes out as not correct; the controls' readings; and no run loads JAX or
the JAX package.  The card-only test (marked gpu) runs the command itself
on a card."""
import json
import subprocess
import sys

import pytest

from npbench import control, harness

SGS, ONT = "sgs_pe150_50x_het.chrom", "lgs_ont_30x.chrom"
SMALL = {SGS: {"pool": [[20000, 15000]]},
         ONT: {"pool": [[40000, 25000, 12000]], "check_contigs": 2}}


@pytest.mark.parametrize("cell", [SGS, ONT])
def test_reference_agrees_with_the_program(cell):
    res = harness.run(cell, 2**31 + 99, 1.0, False, device="cpu",
                      traffic=SMALL[cell])
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] >= 1


def _broken(how, produce):
    """A polish of a block's contigs broken as `how` says: `produce` maps
    the (name, draft) items to (name, polished) results."""
    def polish(items):
        items = list(items)
        if how == "state unchanged":  # the draft comes back
            return items
        out = list(produce(items))
        if how == "half the batch left out":
            return out[:max(1, len(out) // 2)]
        n, s = out[0]  # an answer altered where it is produced
        k = len(s) // 2
        return [(n, s[:k] + (b"C" if s[k:k + 1] in (b"A", b"a") else b"A")
                 + s[k + 1:])] + out[1:]
    return polish


FAULTS = ["state unchanged", "half the batch left out", "an answer altered"]


@pytest.mark.parametrize("fault", FAULTS)
def test_broken_task1_is_not_correct(monkeypatch, fault):
    from nextpolish_tpu_torch import worker1

    real = worker1.score_chain_pipeline

    def broken(names_seqs, *a, **k):
        yield from _broken(fault, lambda items: real(iter(items), *a, **k))(
            names_seqs)

    monkeypatch.setattr(worker1, "score_chain_pipeline", broken)
    res = harness.run(SGS, 4242, 0.5, False, device="cpu",
                      traffic={"pool": [[8000, 6000]]})
    assert res["correct"] is False and res["failed"] >= 1, fault


@pytest.mark.parametrize("fault", FAULTS)
def test_broken_engine2_is_not_correct(monkeypatch, fault):
    from nextpolish_tpu_torch import worker2

    real = worker2.ctg_cns_contig

    def broken(name, draft, *a, **k):
        if fault == "state unchanged":
            return [(name, draft)]
        parts = real(name, draft, *a, **k)
        if fault == "half the batch left out":  # the second of two contigs
            return [] if name == "ctg1" else parts
        if name == "ctg0":
            (n, s), rest = parts[0], parts[1:]
            k_ = len(s) // 2
            s = s[:k_] + (b"C" if s[k_:k_ + 1] in (b"A", b"a") else b"A") \
                + s[k_ + 1:]
            return [(n, s)] + rest
        return parts

    monkeypatch.setattr(worker2, "ctg_cns_contig", broken)
    res = harness.run(ONT, 4243, 0.5, False, device="cpu",
                      traffic={"pool": [[20000, 15000]]})
    assert res["correct"] is False and res["failed"] >= 1, fault


def test_task1_control_readings():
    """The bfloat16 control of task 1's chain DP against the float32
    reference on every contig of a small pool: at the heterozygous sites
    about half the reads carry each allele, the chain's scores nearly
    tie, and bfloat16's rounding flips decisions, so its bytes differ
    (PERF.md); the draft left unchanged reads far off."""
    rs = control.readings(SGS, 7, "cpu", every=True,
                          traffic={"pool": [[60000, 40000]]})
    assert len(rs) == 2
    for _, _, n, ctl, unchanged, _ in rs:
        assert ctl > 0
        assert unchanged > n * 0.002


def test_engine2_control_readings():
    """The int16 control of engine 2's link DP against the exact
    reference: its scores pass 2^15 within a few hundred levels and wrap,
    and its bytes differ; the draft left unchanged reads every
    edit."""
    rs = control.readings(ONT, 7, "cpu", every=True,
                          traffic={"pool": [[30000, 20000]]})
    assert len(rs) == 2
    for _, _, n, ctl, unchanged, _ in rs:
        assert ctl > 0
        assert unchanged > n * 0.002


def test_no_jax_in_a_run_and_no_program_in_the_reference():
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {harness.ROOT!r})\n"
        "from npbench import harness, simgen\n"
        "from npbench.ref import cns, task1\n"
        "c = simgen.simulate_short_case(3, [4000], 20)\n"
        "task1.polish_contig(c.drafts[0], c.records)\n"
        "c = simgen.simulate_case(3, 1, [20000], 10)\n"
        "cns.polish_contig('ctg0', c.drafts[0], c.records, 'ont')\n"
        "ref_mods = sorted({m.split('.')[0] for m in sys.modules})\n"
        f"harness.run({SGS!r}, 3, 0.2, True, device='cpu', "
        "traffic={'pool': [[6000]]})\n"
        f"harness.run({ONT!r}, 3, 0.2, True, device='cpu', "
        "traffic={'pool': [[15000]]})\n"
        "print(json.dumps({'ref': ref_mods, "
        "'run': harness.forbidden_modules()}))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=harness.ROOT, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    for name in ("jax", "jaxlib", "flax", "nextpolish_tpu",
                 "nextpolish_tpu_torch"):
        assert name not in got["ref"]
    assert got["run"] == []
    assert harness.forbidden_modules(["nextpolish_tpu_torch.worker1",
                                      "jaxlib.xla", "nextpolish_tpu"]) == [
        "jaxlib.xla", "nextpolish_tpu"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [SGS, ONT])
def test_run_on_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    r = subprocess.run([sys.executable, "npbench/run.py", "--workload", cell,
                        "--seed", "5", "--seconds", "1", "--trace", "1"],
                       capture_output=True, text=True, cwd=harness.ROOT,
                       timeout=360)
    assert r.returncode == 0, r.stderr[-2000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["device"]["busy_s"] > 0
