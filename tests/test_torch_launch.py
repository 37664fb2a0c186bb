"""The port's launcher and process protocol (nextpolish_tpu_torch.launch,
nextpolish_tpu_torch.parallel.hosts) on the CPU: the cases of
tests/test_launch.py held against the port's launch (local spawn wiring
with --device forwarded, the srun command, _slurm_first_node, a mode is
required), blc_genome / _slurm_first_node / the my_contigs split equal
to the JAX package's parallel/hosts.py on seeded inputs for 1-4
processes, init_distributed's SLURM fallbacks and its one-process case,
and the rendezvous timeout.  The JAX package's hosts.py is loaded from
its file, so this module imports no JAX."""
import importlib.util
import pathlib
import subprocess
import sys
import time
import types
from datetime import timedelta

import numpy as np
import pytest
import torch.distributed as dist

import nextpolish_tpu_torch.launch as launch
from nextpolish_tpu_torch.parallel import hosts
from nextpolish_tpu_torch.parallel.hosts import _slurm_first_node

ROOT = pathlib.Path(__file__).resolve().parents[1]
PROTOCOL = ("NPT_COORDINATOR", "NPT_NUM_PROCS", "NPT_PROC_ID",
            "SLURM_NTASKS", "SLURM_PROCID", "SLURM_JOB_NODELIST")


def _jax_hosts():
    """nextpolish_tpu/parallel/hosts.py as a module of its own (it imports
    jax only inside init_distributed, barrier and my_contigs)."""
    spec = importlib.util.spec_from_file_location(
        "_jax_hosts", ROOT / "nextpolish_tpu" / "parallel" / "hosts.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_local_spawn_sets_protocol_env(monkeypatch, device):
    """Each local rank gets NPT_COORDINATOR/NUM_PROCS/PROC_ID and the
    worker command with --device; ranks are distinct."""
    seen = []

    class FakeProc:
        def wait(self):
            return 0

    def fake_popen(cmd, env=None, **kw):
        seen.append((cmd, env))
        return FakeProc()

    monkeypatch.setattr(subprocess, "Popen", fake_popen)
    rc = launch.launch_local("run.cfg", 3, {"PATH": "/bin"}, device)
    assert rc == 0
    assert len(seen) == 3
    coords = {env["NPT_COORDINATOR"] for _, env in seen}
    assert len(coords) == 1 and next(iter(coords)).startswith("127.0.0.1:")
    assert sorted(env["NPT_PROC_ID"] for _, env in seen) == ["0", "1", "2"]
    assert all(env["NPT_NUM_PROCS"] == "3" for _, env in seen)
    assert all(cmd == [sys.executable, "-m", "nextpolish_tpu_torch",
                       "run.cfg", "--device", device] for cmd, _ in seen)


def test_local_spawn_returns_first_nonzero_code(monkeypatch):
    """Every rank is waited on, and the first nonzero code wins."""
    codes = iter([0, 5, 3])
    waited = []

    class FakeProc:
        def __init__(self):
            self.code = next(codes)

        def wait(self):
            waited.append(self.code)
            return self.code

    monkeypatch.setattr(subprocess, "Popen", lambda cmd, env=None: FakeProc())
    assert launch.launch_local("run.cfg", 3, {}) == 5
    assert waited == [0, 5, 3]


def test_slurm_command(monkeypatch):
    calls = []
    monkeypatch.setattr(subprocess, "call",
                        lambda cmd, env=None: calls.append((cmd, env)) or 0)
    launch.launch_slurm("run.cfg", 2, {}, "cpu")
    (cmd, env), = calls
    assert cmd[:5] == ["srun", "--ntasks", "2", "--ntasks-per-node", "1"]
    assert cmd[5:] == [sys.executable, "-m", "nextpolish_tpu_torch",
                       "run.cfg", "--device", "cpu"]
    assert env["NPT_NUM_PROCS"] == "2"


def test_ssh_command(monkeypatch, tmp_path):
    """Each host gets the protocol env, the first host as coordinator, and
    the worker command with --device, run from the launch directory."""
    seen = []

    class FakeProc:
        def wait(self):
            return 0

    monkeypatch.setattr(subprocess, "Popen",
                        lambda cmd, **kw: seen.append(cmd) or FakeProc())
    monkeypatch.chdir(tmp_path)
    assert launch.launch_ssh("run.cfg", ["ga", "gb"], 7000, {}, "cpu") == 0
    assert [c[:2] for c in seen] == [["ssh", "ga"], ["ssh", "gb"]]
    for rank, (_, _, line) in enumerate(seen):
        assert line.startswith(f"cd {tmp_path} && ")
        assert (f"NPT_COORDINATOR=ga:7000 NPT_NUM_PROCS=2 "
                f"NPT_PROC_ID={rank} ") in line
        assert line.endswith("-m nextpolish_tpu_torch run.cfg --device cpu")


def test_slurm_first_node():
    assert _slurm_first_node("tpu-a,tpu-b") == "tpu-a"
    assert _slurm_first_node("node[003-010]") == "node003"
    assert _slurm_first_node("n[7,9]") == "n7"


def test_cli_requires_a_mode(capsys):
    with pytest.raises(SystemExit):
        launch.main(["run.cfg"])


def test_cli_forwards_device(monkeypatch):
    calls = []
    monkeypatch.setattr(launch, "launch_local",
                        lambda *a: calls.append(a) or 0)
    assert launch.main(["--nprocs", "2", "run.cfg", "--device", "cpu"]) == 0
    assert launch.main(["--nprocs", "3", "run.cfg"]) == 0
    assert [(a[0], a[1], a[3]) for a in calls] == [
        ("run.cfg", 2, "cpu"), ("run.cfg", 3, "cuda")]
    with pytest.raises(SystemExit):
        launch.main(["--nprocs", "2", "run.cfg", "--device", "tpu"])


def _nodelist(rng) -> str:
    """A SLURM nodelist: plain names, ranges and lists, comma-joined."""
    parts = []
    for _ in range(int(rng.integers(1, 4))):
        base = "".join(rng.choice(list("abcgnpu-"), int(rng.integers(1, 6))))
        kind = int(rng.integers(0, 3))
        if kind == 0:
            parts.append(f"{base}{int(rng.integers(0, 100))}")
        elif kind == 1:
            a = int(rng.integers(0, 500))
            parts.append(f"{base}[{a:03d}-{a + int(rng.integers(1, 9)):03d}]")
        else:
            ids = sorted(int(x) for x in rng.integers(0, 60, 3))
            parts.append(f"{base}[{','.join(map(str, ids))}]")
    return ",".join(parts)


@pytest.mark.parametrize("nprocs", [1, 2, 3, 4])
@pytest.mark.parametrize("seed", range(10))
def test_partition_matches_jax(monkeypatch, seed, nprocs):
    """blc_genome, the my_contigs split of every rank and
    _slurm_first_node equal the JAX package's on seeded contig lengths
    (some sets with fewer contigs than processes) and nodelists."""
    jh = _jax_hosts()
    rng = np.random.default_rng(seed)
    n_ctg = int(rng.integers(1, 14))
    lengths = {f"ctg{i}": int(x)
               for i, x in enumerate(rng.integers(1, 60_000, n_ctg))}
    assert hosts.blc_genome(lengths, nprocs) == jh.blc_genome(lengths,
                                                                nprocs)
    split = []
    for rank in range(nprocs):
        monkeypatch.setitem(sys.modules, "jax", types.SimpleNamespace(
            process_count=lambda: nprocs, process_index=lambda: rank))
        monkeypatch.setattr(hosts, "process_count", lambda: nprocs)
        monkeypatch.setattr(hosts, "process_index", lambda: rank)
        mine = hosts.my_contigs(lengths)
        assert mine == jh.my_contigs(lengths)
        split += mine
    assert sorted(split) == sorted(lengths)
    for _ in range(3):
        nodes = _nodelist(rng)
        assert _slurm_first_node(nodes) == jh._slurm_first_node(nodes)


def test_init_distributed_slurm_fallbacks(monkeypatch):
    """Under SLURM alone: rank and count from SLURM_PROCID/SLURM_NTASKS,
    the store at the first node's port 9876 (rank 1 is not its server),
    a gloo group with the fixed timeouts."""
    for k in PROTOCOL:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("SLURM_NTASKS", "4")
    monkeypatch.setenv("SLURM_PROCID", "1")
    monkeypatch.setenv("SLURM_JOB_NODELIST", "gpu[007-010]")
    calls = {}

    def fake_store(host, port, n, is_master, timeout):
        calls["store"] = (host, port, n, is_master, timeout)
        return "store"

    def fake_init(backend, **kw):
        calls["init"] = (backend, kw)
        monkeypatch.setattr(dist, "is_initialized", lambda: True)
        monkeypatch.setattr(dist, "get_world_size", lambda: 4)

    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "TCPStore", fake_store)
    monkeypatch.setattr(dist, "init_process_group", fake_init)
    assert hosts.init_distributed() == 4
    assert calls["store"] == ("gpu007", 9876, 4, False,
                              hosts.RENDEZVOUS_TIMEOUT)
    assert calls["init"] == ("gloo", dict(store="store", world_size=4,
                                          rank=1,
                                          timeout=hosts.BARRIER_TIMEOUT))
    # joined once: a second call does not initialise again
    del calls["init"]
    assert hosts.init_distributed() == 4 and "init" not in calls


def test_init_distributed_one_process_without_coordinator(monkeypatch):
    """NPT_NUM_PROCS above 1 without a coordinator (and outside SLURM) is
    one process, as in the JAX package: no group, no raise."""
    for k in PROTOCOL:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("NPT_NUM_PROCS", "2")
    monkeypatch.setenv("NPT_PROC_ID", "1")

    def fail(*a, **k):
        raise AssertionError("no process group without a coordinator")

    monkeypatch.setattr(dist, "TCPStore", fail)
    monkeypatch.setattr(dist, "init_process_group", fail)
    assert hosts.init_distributed() == 1
    assert hosts.process_index() == 0
    assert hosts.my_contigs({"a": 5, "b": 7}) == ["a", "b"]
    hosts.barrier("one process")


def test_rendezvous_times_out_without_the_other_ranks(monkeypatch):
    """Rank 0 of 2 whose rank 1 never starts gives up after the
    rendezvous timeout instead of the barrier timeout."""
    for k in PROTOCOL:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("NPT_COORDINATOR", f"127.0.0.1:{launch._free_port()}")
    monkeypatch.setenv("NPT_NUM_PROCS", "2")
    monkeypatch.setenv("NPT_PROC_ID", "0")
    monkeypatch.setattr(hosts, "RENDEZVOUS_TIMEOUT", timedelta(seconds=2))
    t0 = time.monotonic()
    with pytest.raises(RuntimeError):
        hosts.init_distributed()
    assert time.monotonic() - t0 < 30
    assert not dist.is_initialized()
