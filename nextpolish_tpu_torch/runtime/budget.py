"""Device/host memory budgeting.

Replaces the reference's RAM heuristics (set_window_process,
lib/nextpolish2.py:67-90, and smalloc's sleep-until-free back-pressure,
lib/ctg_cns.c:69-110) with static sizing: window length and device batch
width are derived from the card's free memory / host RAM instead of letting
a run OOM and retry.
"""
from __future__ import annotations

import torch

from ..device import resolve_device


def host_available_bytes() -> int:
    """MemAvailable from /proc (the reference reads the same figure via
    psutil.virtual_memory().available)."""
    try:
        for line in open("/proc/meminfo"):
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 8 << 30


def device_free_bytes(device=None) -> int:
    """Free memory on `device`: the card's free bytes from
    torch.cuda.mem_get_info, or host-available bytes for the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        free, _total = torch.cuda.mem_get_info(dev)
        return int(free)
    return host_available_bytes()


def cns_device_batch(level_bytes_per_window: int, n_windows: int,
                     free_bytes: int | None = None,
                     fraction: float = 0.5, device=None) -> int:
    """How many engine-2 windows fit one device launch.

    level_bytes_per_window ~= Lt * 6E * 8 (dense A+M slabs), which covers
    the compact launch: the entry stream (10 B an entry), the chain's
    per-entry results (12 B an entry, freed after the winners) and the
    winners (~Lt*6*5); hence also the conservative fraction."""
    free = device_free_bytes(device) if free_bytes is None else free_bytes
    per = max(level_bytes_per_window, 1)
    b = int(free * fraction) // per
    return max(1, min(b, n_windows))


# per-draft-base host bytes for tag/MSA columns by read type: noisier
# reads carry more insertion columns per position (ONT/CLR delta tracks
# are deeper than HiFi's, lib/ctg_cns.c:1213-1256 tag packing)
_CNS_BYTES_PER_BASE = {"ont": 14, "clr": 14, "rs": 14, "hifi": 8}


def cns_window_len(read_type: str, coverage_hint: int = 60,
                   avail_bytes: int | None = None,
                   requested: int = 5_000_000) -> tuple[int, bool]:
    """Clamp the consensus window (-w) to host memory, mirroring the
    shape of set_window_process: tag columns cost roughly
    coverage * bytes-per-base(read_type) on the host side.

    Returns (window, ram_clamped): ram_clamped is True only when host
    memory actually reduced the request — the 4*overlap+1 floor
    (lib/ctg_cns.c:3368) can *raise* a small request and must not be
    reported as a memory clamp."""
    avail = host_available_bytes() if avail_bytes is None else avail_bytes
    per_base = max(coverage_hint, 1) * _CNS_BYTES_PER_BASE.get(read_type, 12)
    cap = int(avail * 0.5) // per_base
    w = min(requested, max(cap, 1_000_000))
    ram_clamped = w < requested
    # ctg_cns_init requires w >= 4 * overlap + 1 (lib/ctg_cns.c:3368)
    w = max(w, 4_000_001)
    return w, ram_clamped and w < requested
