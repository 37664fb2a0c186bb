"""The harness without the program: discovery by name, the rate over
whole jobs, the result line, the check, and the refusal without a card."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from npbench import harness
from npbench.tests import stub


def test_new_cell_config_and_metric_found_by_name(tmp_path):
    """A cell, a configuration and a metric added as files and manifest
    entries are picked up with no edit to the harness."""
    root = stub.scratch_root(tmp_path, "stub_found", [[3000, 2000]],
                             per_layer=("jobs_done",), cell="new.cell",
                             config="new_cfg")
    with open(os.path.join(root, "npbench", "metrics", "jobs_done.py"),
              "w") as fh:
        fh.write("def read(ctx):\n    return ctx['jobs']\n")
    stub.stub_kind("stub_found")
    spec = harness.cell_spec("new.cell", root)
    assert spec["config"]["name"] == "new_cfg"
    assert spec["traffic"]["pool"] == [[3000, 2000]]
    assert [m["name"] for m in spec["per_layer"]] == ["jobs_done"]
    res = harness.run("new.cell", 5, 0.1, True, device="cpu", root=root)
    assert res["metrics"]["jobs_done"]["value"] == res["attempted"] >= 1


def test_metric_of_another_cell_left_out(tmp_path):
    root = stub.scratch_root(tmp_path, "stub_other", [[2000]],
                             per_layer=("device_idle_share",))
    man = json.load(open(os.path.join(root, "BENCHMARK.json")))
    man["per_layer"][0]["workloads"] = ["some.other"]
    json.dump(man, open(os.path.join(root, "BENCHMARK.json"), "w"))
    assert harness.cell_spec("stub.chrom", root)["per_layer"] == []


def test_rate_is_taken_over_whole_jobs(tmp_path):
    """Jobs run back to back until the seconds pass; one started before
    then runs to its end, and the rate divides all their bases by the time
    to the end of the last."""
    root = stub.scratch_root(tmp_path, "stub_rate", [[3000, 1000], [2000]])
    stub.stub_kind("stub_rate", job_s=0.2)
    res = harness.run("stub.chrom", 11, 0.5, False, device="cpu", root=root)
    n = res["attempted"]
    assert n == 3  # started at about 0, 0.2 and 0.4 s
    rate = res["metrics"]["polished_bases_per_s"]["value"]
    # 3 jobs of 2,000 or 4,000 bases over a little more than 0.6 s
    assert 3 * 2000 / 0.75 < rate < 3 * 4000 / 0.6
    assert res["metrics"]["setup_s"]["value"] > 0


def test_result_keys_and_checks_last(tmp_path):
    root = stub.scratch_root(tmp_path, "stub_keys", [[2000]])
    stub.stub_kind("stub_keys")
    res = harness.run("stub.chrom", 3, 0.05, False, device="cpu",
                      root=root)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert res["correct"] is True and res["failed"] == 0
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert res["checks"] == {"bad_records": {"value": 0, "limit": 0},
                             "mismatched_bases": {"value": 0, "limit": 0}}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    res = harness.run("stub.chrom", 3, 0.05, True, device="cpu", root=root)
    assert list(res)[-1] == "checks"
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def _flip(recs):
    n, s = recs[0]
    return [(n, s[:5] + (b"A" if s[5:6] != b"A" else b"C") + s[6:])] \
        + recs[1:]


@pytest.mark.parametrize("fault, alter", [
    ("half the block left out", lambda recs: recs[:len(recs) // 2]),
    ("a base altered where it is produced", _flip),
    ("a contig written twice", lambda recs: recs + recs[:1]),
    ("a base added", lambda recs: [(recs[0][0], recs[0][1] + b"A")]
     + recs[1:]),
])
def test_check_fails_each_fault(tmp_path, fault, alter):
    """The check itself: a stand-in program whose reference is the draft
    passes until the output is broken."""
    root = stub.scratch_root(tmp_path, "stub_fault", [[2000, 1500]],
                             check_contigs=2)
    stub.stub_kind("stub_fault", alter=alter)
    res = harness.run("stub.chrom", 4, 0.05, False, device="cpu",
                      root=root)
    assert res["correct"] is False, fault
    assert res["failed"] >= 1


def test_refuses_without_a_card():
    """No result, and a non-zero exit, where torch sees no CUDA card."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, os.path.join(harness.ROOT,
                                                     "npbench", "run.py"),
                        "--workload", "lgs_ont_30x.chrom", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, env=env,
                       cwd=harness.ROOT, timeout=300)
    assert r.returncode != 0 and r.stdout == ""


def test_refuses_without_the_program(tmp_path):
    """No result, and a non-zero exit, in a directory that holds only
    BENCHMARK.json and the benchmark's files."""
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(harness.ROOT, "npbench"),
                    tmp_path / "npbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    r = subprocess.run([sys.executable, "npbench/run.py", "--workload",
                        "lgs_ont_30x.chrom", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], capture_output=True,
                       text=True, cwd=tmp_path, timeout=300)
    assert r.returncode != 0 and r.stdout == ""


def test_manifest_contract():
    """BENCHMARK.json names only files under its paths, and every metric,
    cell and configuration's read kind has its file."""
    man = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
    assert man["paths"] == ["npbench"]
    for c in man["configs"]:
        assert c["file"].startswith("npbench/")
        assert os.path.exists(os.path.join(harness.ROOT, c["file"]))
        kind = harness.load_json(os.path.join(harness.ROOT, c["file"]))[
            "reads"]["kind"]
        assert os.path.exists(os.path.join(harness.ROOT, "npbench", "gens",
                                           kind + ".py"))
    for w in man["workloads"]:
        spec = harness.cell_spec(w["name"])
        assert spec["traffic"]["config"] == w["config"]
    for m in man["end_to_end"] + man["per_layer"]:
        assert os.path.exists(os.path.join(
            harness.ROOT, "npbench", "metrics", m["name"] + ".py"))
    assert {m["name"] for m in man["end_to_end"]} == {
        "polished_bases_per_s", "setup_s"}


def test_warm_on_the_pool_and_every_contig_checked(tmp_path):
    """The warm job polishes the pool's first block (no block of its own
    is made), and `check_contigs` as large as the block compares every
    contig: a base altered in the last contig fails."""
    root = stub.scratch_root(tmp_path, "stub_pool", [[1500, 1200, 1000]],
                             check_contigs=3)
    seen = []
    kind = stub.stub_kind("stub_pool", alter=lambda recs: recs[:2] + [
        (recs[2][0], recs[2][1][:-1] + (b"A" if recs[2][1][-1:] != b"A"
                                        else b"C"))])
    run = kind.run
    kind.run = lambda block, *a: (seen.append(block.name), run(block, *a))
    res = harness.run("stub.chrom", 6, 0.05, False, device="cpu",
                      root=root)
    assert set(seen) == {"block0"}
    assert res["correct"] is False
    assert res["checks"]["mismatched_bases"]["value"] == len(seen) - 1
    pairs = [("b", i) for i in range(10)]
    got = harness.sampled_contigs(9, pairs, 4)
    assert len(set(got)) == 4 and got == harness.sampled_contigs(9, pairs, 4)
    assert sorted(harness.sampled_contigs(9, pairs, 20)) == pairs
