"""Where task 1's chain DP spends its time, stage by stage, on one device.

    python -m nextpolish_tpu_torch.profile_chain [--device cuda|cpu] \
        [--length L] [--json OUT]

Builds the case of the repo's tools/profile_chain.py: `make_task1_case`
with rng default_rng(0) and one contig of --length bases (100,000 by
default, the case's own; its Python loop over reads with indels makes a
multi-megabase case slow to build), then score_chain_contig_prep's packed
buffer and shape key.  The planes DP (ops/chain.py::
chain_correct_planes_batch, the path task 1 runs) is called once to warm
up, then once under torch.profiler with CPU and CUDA activity.

The DP runs its steps inside torch.profiler.record_function ranges, in
order STAGES: chain.decode, chain.emission, chain.lattice, chain.forward
(the chain_forward kernel), chain.pointers, chain.traceback (the
chain_traceback kernel) and chain.flags.  On a card every device event
(kernel, memset, copy) is attributed by correlation: the profiler links
an event (`linked_correlation_id`) to the ATen op that launched it, and
the innermost chain.* range among that op and its `cpu_parent`s is its
stage.  The hand kernels and their memsets are launched through ctypes
inside no op, so they link to nothing; such an event goes to the
innermost of the ranges' GPU-side copies (the profiler's user-annotation
spans on the device timeline) that holds it, and to `other` if none does.
Those copies are not kernels and are left out of every sum.  On the CPU
the split is by CPU self-time: each op's time outside its children goes
to its innermost chain.* range, the ranges' own time to themselves.

The JAX tool differences cumulative prefixes of the DP, timed one after
another, because XLA fuses across stages.  Eager PyTorch launches each
stage's kernels on their own, so the ranges give the split in one run.

The stages and `other` split the profiled run's events, so they add up
to the whole by construction; a kernel the attribution misses shows as
`other`.

Prints each stage's time in ms, its share of the whole and its three
largest kernels (ops on the CPU), the whole, the host cost outside a
profile of one range and of one stage (which opens no range there:
ops/chain.py opens its ranges only while a profiler runs), the card's
name and power limit, and a JSON object last (also written to --json).  The default device is `cuda`, which
raises without a card.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from .device import resolve_device

STAGES = ("chain.decode", "chain.emission", "chain.lattice",
          "chain.forward", "chain.pointers", "chain.traceback",
          "chain.flags")
OTHER = "other"
DEFAULT_LENGTH = 100_000


def build_case(length: int = DEFAULT_LENGTH, device="cuda"):
    """The packed buffer [1, buflen] (numpy uint16) and the shape key of
    one contig of `length` bases from make_task1_case(default_rng(0)),
    prepared for `device` (its free memory decides the route)."""
    from . import sim
    from .models.score_chain import AlgoConfig, score_chain_contig_prep

    rng = np.random.default_rng(0)
    names, trues, batch, _ = sim.make_task1_case(rng, L=length,
                                                 n_contigs=1)
    h = score_chain_contig_prep(names[0], trues[0], batch, AlgoConfig(),
                                device=resolve_device(device))
    if h.buf is None:
        raise ValueError(f"a {length} bp contig takes the window route on "
                         f"{device}: no single launch to profile")
    return h.buf[None], h.key


def _stage(evt) -> str:
    """The innermost chain.* range among a CPU event and its parents."""
    while evt is not None:
        if evt.name in STAGES:
            return evt.name
        evt = evt.cpu_parent
    return OTHER


def _is_device(evt) -> bool:
    """A kernel, memset or copy on the card (not a user annotation)."""
    return (evt.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(evt, "is_user_annotation", False)
            and evt.name not in STAGES)


def device_events(prof) -> list:
    """The device events of a profile: kernels, memsets and copies."""
    return [e for e in prof.events() if _is_device(e)]


def _split_device(prof) -> dict:
    """{stage: {kernel name: ms}} over every device event."""
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    # the events a kernel links to: ops and ranges (a CUDA runtime call
    # is a CPU event too, but it links to its op and its id is CUPTI's)
    cpu = {e.id: e for e in events
           if e.device_type != cuda and not e.is_async
           and not getattr(e, "linked_correlation_id", 0)}
    spans = [e for e in events if e.device_type == cuda
             and e.name in STAGES]

    def span_of(k) -> str:
        t = k.time_range
        inside = [a for a in spans if a.time_range.start <= t.start
                  and t.end <= a.time_range.end]
        return (min(inside, key=lambda a: a.time_range.elapsed_us()).name
                if inside else OTHER)

    out = {s: {} for s in STAGES + (OTHER,)}
    for e in device_events(prof):
        op = cpu.get(getattr(e, "linked_correlation_id", 0))
        per = out[span_of(e) if op is None else _stage(op)]
        per[e.name] = per.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    return out


def _split_cpu(prof) -> dict:
    """{stage: {op name: ms}} by CPU self-time."""
    out = {s: {} for s in STAGES + (OTHER,)}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CPU or e.is_async:
            continue
        per = out[_stage(e)]
        per[e.name] = per.get(e.name, 0.0) + e.self_cpu_time_total / 1e3
    return out


def host_cost_us(n: int = 10_000) -> dict:
    """Host time (us) outside a profile of one record_function range
    (`range_us`) and of one of the DP's stages (`stage_us`: ops/chain.py
    opens a range only while a profiler runs)."""
    from .ops.chain import _stage

    out = {}
    for key, make in (("range_us", record_function), ("stage_us", _stage)):
        t0 = time.perf_counter()
        for _ in range(n):
            with make("chain.cost"):
                pass
        out[key] = (time.perf_counter() - t0) / n * 1e6
    return out


def profile_stages(bufs: np.ndarray, key, device="cuda"):
    """chain_correct_planes_batch on `bufs` ([B, buflen] u16 words) with
    shape `key`, once to warm up and once under torch.profiler.  Returns
    (report, result): the report's `stages` give each stage's `ms`, its
    `share` of `whole_ms`, its `top` three kernels (ops on the CPU) as
    [name, ms] and all of them as `kernels` {name: ms}; `result` is the
    profiled call's [B, L] int8 bytes."""
    from .ops.chain import chain_correct_planes_batch

    dev = resolve_device(device)
    dbuf = torch.from_numpy(np.ascontiguousarray(bufs).view(np.int16)).to(dev)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    chain_correct_planes_batch(dbuf, *key)
    sync()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        result = chain_correct_planes_batch(dbuf, *key)
        sync()
    split = _split_device(prof) if cuda else _split_cpu(prof)
    whole = (sum(e.time_range.elapsed_us() for e in device_events(prof))
             / 1e3 if cuda else sum(sum(v.values()) for v in split.values()))
    stages = {}
    for s, per in split.items():
        ms = sum(per.values())
        top = sorted(per.items(), key=lambda kv: -kv[1])[:3]
        stages[s] = {"ms": ms, "share": ms / whole if whole else 0.0,
                     "top": [[n, t] for n, t in top], "kernels": per}
    report = {"device": str(dev),
              "timer": ("device time (torch.profiler)" if cuda
                        else "CPU self-time (torch.profiler)"),
              "B": int(dbuf.shape[0]), "L": int(key[0]), "whole_ms": whole,
              "stages": stages}
    return report, result.cpu().numpy()


def format_report(report: dict) -> list:
    """The report as printed lines: a stage a line, then the whole."""
    lines = [f"profile_chain: B={report['B']} L={report['L']} on "
             f"{report['device']}, {report['timer']}"]
    for s, v in report["stages"].items():
        top = ", ".join(f"{n[:60]} {t:.3f}" for n, t in v["top"])
        lines.append(f"{s:16s} {v['ms']:9.3f} ms {v['share'] * 100:6.2f}%"
                     f"  {top}")
    lines.append(f"{'whole':16s} {report['whole_ms']:9.3f} ms")
    return lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--length", type=int, default=DEFAULT_LENGTH)
    p.add_argument("--json", default=None, help="also write the JSON here")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    bufs, key = build_case(args.length, dev)
    print(f"profile_chain: case of {args.length} bp, shape key {key} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    report, _ = profile_stages(bufs, key, dev)
    for line in format_report(report):
        print(line)
    report.update(host_cost_us())
    print(f"outside a profile: a range {report['range_us']:.2f} us of host "
          f"time, a stage {report['stage_us']:.2f} us")
    if dev.type == "cuda":
        from .bench_band import card

        report["card"] = card()
        print(report["card"])
    text = json.dumps(report)
    if args.json:
        with open(args.json, "w") as fh:
            fh.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
