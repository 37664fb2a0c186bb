"""Read-set statistics (util/seq_count.c parity): length histogram,
N10..N90, raw/filtered depth, suggested seed cutoff."""
from __future__ import annotations

import numpy as np

from .fasta import read_fastx


def seq_stats(paths, genome_size: int = 0, min_len: int = 1000,
              top_depth: int = 45):
    """Stats over one or more FASTA/FASTQ files (gzip ok)."""
    lengths = []
    for p in paths:
        for rec in read_fastx(p):
            lengths.append(len(rec.seq))
    lens = np.sort(np.array(lengths, dtype=np.int64))[::-1]
    total = int(lens.sum())
    out = {
        "count": int(lens.size),
        "total_bases": total,
        "mean": int(lens.mean()) if lens.size else 0,
        "max": int(lens[0]) if lens.size else 0,
        "min": int(lens[-1]) if lens.size else 0,
    }
    acc = np.cumsum(lens)
    for i in range(1, 10):
        t = total * i // 10
        j = int(np.searchsorted(acc, t))
        out[f"N{i*10}"] = int(lens[min(j, lens.size - 1)]) if lens.size else 0
    if genome_size:
        out["raw_depth"] = round(total / genome_size, 2)
        filt = lens[lens >= min_len]
        out["filtered_depth"] = round(int(filt.sum()) / genome_size, 2)
        # suggested seed cutoff: longest reads summing to ~top_depth x
        want = top_depth * genome_size
        j = int(np.searchsorted(acc, want))
        out["suggested_seed_cutoff"] = int(lens[min(j, lens.size - 1)]) \
            if lens.size else 0
    return out


def format_stats(stats: dict) -> str:
    lines = ["[Read length stat]"]
    lines.append(f"{'Types':<22}{'Count (#)':<15}{'Length (bp)'}")
    for i in range(1, 10):
        k = f"N{i*10}"
        if k in stats:
            lines.append(f"{k:<22}{'-':<15}{stats[k]}")
    lines.append("")
    lines.append(f"{'Count':<22}{stats['count']}")
    lines.append(f"{'Total bases':<22}{stats['total_bases']}")
    lines.append(f"{'Mean':<22}{stats['mean']}")
    lines.append(f"{'Max':<22}{stats['max']}")
    lines.append(f"{'Min':<22}{stats['min']}")
    for k in ("raw_depth", "filtered_depth", "suggested_seed_cutoff"):
        if k in stats:
            lines.append(f"{k:<22}{stats[k]}")
    return "\n".join(lines) + "\n"
