"""Start the processes of a run over several processes or hosts (port of
nextpolish_tpu/launch.py).

The reference submits its jobs through Paralleltask to a local shell or
an SGE/PBS/SLURM cluster (source/nextPolish:396-521, doc/OPTION.rst:75-113).
Here a run is one `python -m nextpolish_tpu_torch run.cfg` process per
rank, meeting in a torch.distributed process group (parallel/hosts.py);
this launcher is the piece that *starts* those processes:

    # local N-process run (testing / single machine):
    python -m nextpolish_tpu_torch.launch --nprocs 2 run.cfg

    # ssh to a host list (first host is the coordinator):
    python -m nextpolish_tpu_torch.launch --hosts gpu-a,gpu-b run.cfg

    # inside a SLURM allocation (uses srun; ranks come from SLURM_PROCID):
    python -m nextpolish_tpu_torch.launch --slurm --nprocs 2 run.cfg

Every spawned process receives NPT_COORDINATOR / NPT_NUM_PROCS /
NPT_PROC_ID (the protocol parallel/hosts.init_distributed consumes);
under --slurm the rank env is filled from SLURM_PROCID at task startup.
`--device cuda|cpu` (default cuda) is forwarded to every rank; each rank
resolves it as a single process does (`cuda` is every card it sees).
Local ranks of `--device cuda` see disjoint cards: rank r of n gets
CUDA_VISIBLE_DEVICES = the launcher's visible cards r, r+n, ...; with
fewer cards than ranks, rank r shares card r mod k.  Under ssh (one rank
a host) and srun (which binds cards) each rank sees its host's cards.
"""
from __future__ import annotations

import argparse
import os
import shlex
import socket
import subprocess
import sys


def _free_port() -> int:
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _worker_cmd(cfg: str, device: str) -> list[str]:
    return [sys.executable, "-m", "nextpolish_tpu_torch", cfg,
            "--device", device]


def visible_cards(env: dict) -> list[str]:
    """The cards a process started with `env` would see: the entries of
    its CUDA_VISIBLE_DEVICES, or every card torch counts here."""
    vis = env.get("CUDA_VISIBLE_DEVICES")
    if vis is not None:
        return [c.strip() for c in vis.split(",") if c.strip()]
    import torch

    return [str(i) for i in range(torch.cuda.device_count())]


def rank_cards(cards: list[str], nprocs: int) -> list[str]:
    """CUDA_VISIBLE_DEVICES of each of `nprocs` local ranks over `cards`:
    rank r takes cards r, r+n, ...; with fewer cards than ranks, rank r
    shares card r mod k."""
    k = len(cards)
    if k >= nprocs:
        return [",".join(cards[r::nprocs]) for r in range(nprocs)]
    return [cards[r % k] for r in range(nprocs)]


def launch_local(cfg: str, nprocs: int, base_env: dict,
                 device: str = "cuda") -> int:
    coord = f"127.0.0.1:{_free_port()}"
    cards = visible_cards(base_env) if device == "cuda" else []
    split = rank_cards(cards, nprocs) if cards else None
    procs = []
    for rank in range(nprocs):
        env = dict(base_env, NPT_COORDINATOR=coord,
                   NPT_NUM_PROCS=str(nprocs), NPT_PROC_ID=str(rank))
        if split:
            env["CUDA_VISIBLE_DEVICES"] = split[rank]
        procs.append(subprocess.Popen(_worker_cmd(cfg, device), env=env))
    # wait on EVERY process (no short-circuit): all ranks must be reaped
    # even after an early failure, and the first nonzero code wins
    codes = [p.wait() for p in procs]
    return next((c for c in codes if c), 0)


def launch_ssh(cfg: str, hosts: list[str], port: int, base_env: dict,
               device: str = "cuda") -> int:
    coord = f"{hosts[0]}:{port}"
    procs = []
    for rank, host in enumerate(hosts):
        envs = " ".join(
            f"{k}={shlex.quote(v)}"
            for k, v in (("NPT_COORDINATOR", coord),
                         ("NPT_NUM_PROCS", str(len(hosts))),
                         ("NPT_PROC_ID", str(rank))))
        cmd = f"cd {shlex.quote(os.getcwd())} && {envs} " + " ".join(
            shlex.quote(c) for c in _worker_cmd(cfg, device))
        procs.append(subprocess.Popen(["ssh", host, cmd]))
    codes = [p.wait() for p in procs]
    return next((c for c in codes if c), 0)


def launch_slurm(cfg: str, nprocs: int, base_env: dict,
                 device: str = "cuda") -> int:
    """srun inside an existing allocation: rank/count/coordinator resolve
    from SLURM_* at task startup (hosts.init_distributed fallbacks)."""
    env = dict(base_env)
    env.setdefault("NPT_NUM_PROCS", str(nprocs))
    cmd = ["srun", "--ntasks", str(nprocs), "--ntasks-per-node", "1",
           *_worker_cmd(cfg, device)]
    return subprocess.call(cmd, env=env)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="nextpolish_tpu_torch.launch",
        description="Launch a nextpolish_tpu_torch run over several "
                    "processes or hosts (Paralleltask submit role, "
                    "doc/OPTION.rst:75-113).")
    ap.add_argument("config", help="run.cfg")
    ap.add_argument("--nprocs", type=int, default=0,
                    help="process count (local/slurm modes)")
    ap.add_argument("--hosts", default="",
                    help="comma-separated ssh host list (rank order; "
                         "first host runs the coordinator)")
    ap.add_argument("--slurm", action="store_true",
                    help="submit via srun inside a SLURM allocation")
    ap.add_argument("--port", type=int, default=9876,
                    help="coordinator port (ssh mode)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="every rank's --device (default cuda)")
    args = ap.parse_args(argv)
    base_env = dict(os.environ)
    if args.slurm:
        n = args.nprocs or int(os.environ.get("SLURM_NTASKS", "0"))
        if not n:
            ap.error("--slurm needs --nprocs or SLURM_NTASKS")
        return launch_slurm(args.config, n, base_env, args.device)
    if args.hosts:
        hosts = [h for h in args.hosts.split(",") if h]
        return launch_ssh(args.config, hosts, args.port, base_env,
                          args.device)
    if args.nprocs > 1:
        return launch_local(args.config, args.nprocs, base_env, args.device)
    ap.error("pick one of --nprocs N, --hosts a,b or --slurm")


if __name__ == "__main__":
    raise SystemExit(main())
