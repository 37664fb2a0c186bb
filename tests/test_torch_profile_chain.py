"""The port's stage profiler of task 1's chain DP
(nextpolish_tpu_torch/profile_chain.py) on the CPU, at a small length:
every chain.* stage appears in the split (by CPU self-time here), the
profiled result equals an unprofiled run and the JAX package's planes DP
on the same buffer byte for byte, the attribution of device events by
correlation (on stand-in events, since this machine has no card), and the
CLI's JSON."""
import json
import types

import numpy as np
import pytest
import torch

from nextpolish_tpu.ops import tropical as tr
from nextpolish_tpu_torch import profile_chain as pc
from nextpolish_tpu_torch.ops import chain as ch

LENGTH = 3000


@pytest.fixture(autouse=True)
def one_thread():
    """The DP's plain scans are many small torch ops: on a host whose
    cores are all busy, one intra-op thread a process runs them faster
    than one a core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def case():
    return pc.build_case(LENGTH, "cpu")


def test_every_stage_appears(case):
    bufs, key = case
    report, _ = pc.profile_stages(bufs, key, "cpu")
    assert report["L"] == key[0] and report["B"] == 1
    stages = report["stages"]
    assert list(stages) == list(pc.STAGES) + [pc.OTHER]
    for s in pc.STAGES:
        assert stages[s]["ms"] > 0 and stages[s]["top"], s
    # every op of the DP sits inside a stage: the rest is the buffer view
    assert stages[pc.OTHER]["share"] < 0.05
    lines = pc.format_report(report)
    assert len(lines) == len(stages) + 2
    assert all(any(line.startswith(s) for line in lines) for s in stages)


def test_profiled_result_matches_unprofiled_and_jax(case):
    bufs, key = case
    _, got = pc.profile_stages(bufs, key, "cpu")
    plain = ch.chain_correct_planes_batch(
        torch.from_numpy(bufs.view(np.int16)), *key).numpy()
    want = np.asarray(tr.chain_correct_planes_batch(bufs, *key))
    assert got.dtype == np.int8 and got.shape == (1, key[0])
    assert np.array_equal(got, plain)
    assert np.array_equal(got, want)


def _evt(name, eid, device, parent=None, linked=0, t=(0.0, 0.0),
         annot=False):
    return types.SimpleNamespace(
        name=name, id=eid, cpu_parent=parent, linked_correlation_id=linked,
        is_async=False, is_user_annotation=annot,
        device_type=(torch.autograd.DeviceType.CUDA if device
                     else torch.autograd.DeviceType.CPU),
        time_range=types.SimpleNamespace(
            start=t[0], end=t[1], elapsed_us=lambda: t[1] - t[0]))


def test_device_attribution_by_correlation():
    """Kernels linked to an op go to the innermost chain.* range among
    the op and its parents; a kernel linked to nothing (a ctypes launch)
    to the innermost GPU-side range that holds it, else to `other`; the
    GPU-side ranges are not kernels; a CUDA runtime call whose CUPTI id
    equals an op's id does not take the op's kernels."""
    lattice = _evt("chain.lattice", 1, False)
    scatter = _evt("aten::scatter_reduce_", 2, False, parent=lattice)
    stray_op = _evt("aten::copy_", 4, False)
    runtime = _evt("cudaLaunchKernel", 2, False, linked=2)
    events = [
        lattice, scatter, stray_op, runtime,
        _evt("scatter_kernel", 10, True, linked=2, t=(0, 400)),
        _evt("copy_kernel", 11, True, linked=4, t=(410, 420)),
        _evt("Memset (Device)", 12, True, t=(500, 505)),
        _evt("fwd_scan", 13, True, t=(505, 2005)),
        _evt("tb_maps", 14, True, t=(3000, 3100)),
        _evt("chain.lattice", 20, True, t=(0, 400), annot=True),
        _evt("chain.forward", 21, True, t=(500, 2005), annot=True),
    ]
    prof = types.SimpleNamespace(events=lambda: events)
    assert [e.name for e in pc.device_events(prof)] == [
        "scatter_kernel", "copy_kernel", "Memset (Device)", "fwd_scan",
        "tb_maps"]
    split = pc._split_device(prof)
    assert split["chain.lattice"] == {"scatter_kernel": 0.4}
    assert split["chain.forward"] == {"Memset (Device)": 0.005,
                                      "fwd_scan": 1.5}
    assert split[pc.OTHER] == {"copy_kernel": 0.01, "tb_maps": 0.1}
    assert not any(split[s] for s in pc.STAGES
                   if s not in ("chain.lattice", "chain.forward"))


def test_cli_writes_json(tmp_path, capsys):
    out = tmp_path / "stages.json"
    assert pc.main(["--device", "cpu", "--length", str(LENGTH), "--json",
                    str(out)]) == 0
    report = json.loads(out.read_text())
    assert set(report["stages"]) == set(pc.STAGES) | {pc.OTHER}
    assert report["range_us"] > 0 and report["stage_us"] > 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == report
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            pc.main(["--length", "500"])
