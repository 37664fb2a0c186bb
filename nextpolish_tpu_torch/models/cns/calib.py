"""Measurement-driven consensus-engine selection: port of
nextpolish_tpu/models/cns/calib.py.

The device engine's end-to-end rate depends on the host<->device link and
the host prep it needs; the host C++ engine's rate on the local cores —
neither is knowable a priori, and defaulting to a slower path costs users
real time (the reference likewise sizes its process count to the machine
it finds, lib/nextpolish2.py:67-90).

`choose_engine` times BOTH engines on one synthetic probe window (device:
a full B_MAX-wide batched launch incl. pack/transfer/fetch; native:
per-core serial rate scaled by the thread-pipeline width) and picks the
faster, logging the measured rates.  The decision caches in-process and in
a small JSON file (NPT_CNS_CALIB, default npt_cns_calib.json in the
temporary directory) keyed by the card's name (torch) and the read type,
so repeated worker processes skip the probe.  NPT_CNS_ENGINE always wins
(handled by window.default_engine).

One difference from the JAX package: an error of the device probe raises
(JAX scores the device 0 and carries on), so a card path never gives way
without saying so.
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
import time

import numpy as np
import torch

from ...device import resolve_device

PROBE_LEN = 12_000
PROBE_COV = 30

# bump when either engine's performance characteristics change, so a
# cached decision from an older build re-probes instead of going stale
CALIB_VERSION = 2

_CHOSEN: dict = {}  # cache key -> engine, this process
_LOCK = threading.Lock()


def _probe_window(read_type: str):
    """Synthetic window: noisy reads over a random draft, expanded to tag
    columns exactly as the production path would (expand_columns)."""
    from ...io.fasta import ASCII_TO_NIB
    from .tags import WindowAccum, expand_columns, trim_read_columns

    rng = np.random.default_rng(12345)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    L = PROBE_LEN
    draft = rng.choice(bases, L)
    accum = WindowAccum(draft, 0, L, 3)
    n_reads = PROBE_COV * L // 3000
    for _ in range(n_reads):
        s = int(rng.integers(0, L - 2500))
        e = min(s + 3000, L)
        seg = draft[s:e]
        # single-base errors with an exact CIGAR
        ins = rng.random(len(seg)) < 0.02
        dele = (rng.random(len(seg)) < 0.02) & ~ins
        sub = (rng.random(len(seg)) < 0.02) & ~dele
        out = seg.copy()
        out[sub] = bases[rng.integers(0, 4, int(sub.sum()))]
        ops = []
        seq = []
        for i in range(len(seg)):
            if ins[i]:
                ops.append(1)
                seq.append(int(bases[rng.integers(0, 4)]))
            if dele[i]:
                ops.append(2)
            else:
                ops.append(0)
                seq.append(int(out[i]))
        ops = np.array(ops, dtype=np.uint8)
        brk = np.flatnonzero(np.diff(ops.astype(np.int8)) != 0)
        st = np.concatenate([[0], brk + 1])
        en = np.concatenate([brk + 1, [len(ops)]])
        cig = ((en - st).astype(np.uint32) << 4) | ops[st]
        nib = ASCII_TO_NIB[np.array(seq, dtype=np.uint8)]
        tr = trim_read_columns(*expand_columns(s, cig, nib),
                               accum.ref_cns, 0, L)
        if tr is not None:
            accum.add_row(tr[0], tr[1], tr[2], -3)
    merged = accum.finish()
    coverage = accum.coverage[:L] + 1
    return merged, coverage, L


def _cache_path() -> str:
    return os.environ.get("NPT_CNS_CALIB", os.path.join(
        tempfile.gettempdir(), "npt_cns_calib.json"))


def _cache_key(read_type: str, device=None) -> str:
    """v<version>/<backend>/<device name>/<read type>, from torch."""
    dev = resolve_device(device)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    return f"v{CALIB_VERSION}/{dev.type}/{name}/{read_type}"


def _read_cache() -> dict:
    try:
        with open(_cache_path()) as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return {}


def choose_engine(read_type: str, device=None) -> str:
    """'device' or 'native', measured on `device` (cached in this process
    and across processes)."""
    key = _cache_key(read_type, device)
    with _LOCK:
        if key in _CHOSEN:
            return _CHOSEN[key]
        cached = _read_cache()
        if key in cached:
            _CHOSEN[key] = cached[key]["engine"]
            return _CHOSEN[key]
        rates = measure_engines(read_type, device)
        eng = "device" if rates["device"] >= rates["native"] else "native"
        from ...kit import plog

        plog().info(
            f"cns engine auto-selected '{eng}': device "
            f"{rates['device'] / 1e3:.0f}k bases/s vs native "
            f"{rates['native'] / 1e3:.0f}k bases/s on this host/link "
            f"({key})")
        cached = _read_cache()
        cached[key] = {"engine": eng,
                       "device_bases_per_s": round(rates["device"], 1),
                       "native_bases_per_s": round(rates["native"], 1)}
        try:
            with open(_cache_path(), "w") as fh:
                json.dump(cached, fh, indent=1)
        except OSError:
            pass
        _CHOSEN[key] = eng
        return eng


def measure_engines(read_type: str, device=None) -> dict:
    """Probe rates in draft bases/s for the device path (one B_MAX-wide
    batched launch, pack+transfer+scan+fetch) and the native host engine
    (per-core serial x pipeline width)."""
    from ... import native
    from . import device_dp as dd

    dev = resolve_device(device)
    merged, coverage, L = _probe_window(read_type)

    # ---- native ----
    lq_min_qv = 80 if read_type == "hifi" else 20
    t_n = float("inf")
    if native.available():
        for _ in range(3):
            t0 = time.time()
            native.cns_dp(merged.t_pos, merged.delta, merged.q_base,
                          merged.row_off, coverage, L, read_type, 4,
                          lq_min_qv)
            t_n = min(t_n, time.time() - t0)
    width = min(2, os.cpu_count() or 1)
    rate_native = L / t_n * width if t_n < float("inf") else 0.0

    # ---- device (one batched launch incl. transfers) ----
    rate_device = 0.0
    edges, dw = dd.prepare_window(merged, coverage, L)
    if dw is not None:
        B = dd.B_MAX
        dws = [dw] * B
        dd._run_batch(dws, read_type, devices=[dev], sc_tail=True)  # warm
        t_d = float("inf")
        for _ in range(2):
            t0 = time.time()
            dd._run_batch(dws, read_type, devices=[dev], sc_tail=True)
            t_d = min(t_d, time.time() - t0)
        # prep runs on the host alongside (pipelined); charge the device
        # path the larger of transfer+scan and its host prep
        t0 = time.time()
        dd.prepare_window(merged, coverage, L)
        t_prep = (time.time() - t0) * B / width
        rate_device = B * L / max(t_d, t_prep)
    return {"native": rate_native, "device": rate_device}
