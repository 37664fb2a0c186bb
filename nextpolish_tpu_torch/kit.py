"""Small shared utilities: logging and unit parsing.

Functional parity targets (reference, for behavior only — new code):
  * plog / colored exit-on-critical logging   -> lib/kit.py:18-92
  * parse_num_unit ("2.3 kb" -> 2300)         -> lib/kit.py:153-177
  * parse_options_value, cal_n50_info, calgs  -> lib/kit.py (the run.cfg
    parser and the final assembly stats)
"""
from __future__ import annotations

import gzip
import logging
import re
import sys


class _ExitOnCritical(logging.Logger):
    def critical(self, msg, *args, **kwargs):  # noqa: D102
        super().critical(msg, *args, **kwargs)
        raise SystemExit(1)


_COLORS = {"WARNING": 33, "ERROR": 31, "CRITICAL": 31}


class _ColorFormatter(logging.Formatter):
    def format(self, record):
        text = super().format(record)
        color = _COLORS.get(record.levelname)
        if color and sys.stderr.isatty():
            return f"\033[{color}m{text}\033[0m"
        return text


def plog(name: str = "nextpolish_tpu", level: int = logging.INFO) -> logging.Logger:
    """A process-id-tagged, color-coded logger; CRITICAL raises SystemExit."""
    logging.setLoggerClass(_ExitOnCritical)
    log = logging.getLogger(name)
    logging.setLoggerClass(logging.Logger)
    if not log.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            _ColorFormatter(
                "[%(asctime)s %(process)d %(levelname)s] %(message)s",
                "%Y-%m-%d %H:%M:%S",
            )
        )
        log.addHandler(handler)
        log.setLevel(level)
        log.propagate = False
    return log


_UNIT_FACTORS = {
    "": 1,
    "b": 1,
    "k": 1_000,
    "kb": 1_000,
    "m": 1_000_000,
    "mb": 1_000_000,
    "g": 1_000_000_000,
    "gb": 1_000_000_000,
    "t": 1_000_000_000_000,
    "tb": 1_000_000_000_000,
}


def parse_num_unit(value) -> int:
    """Parse a human size like '2.3 kb', '500M', '1g' into an int."""
    if isinstance(value, (int, float)):
        return int(value)
    m = re.fullmatch(r"\s*([\d.]+)\s*([a-zA-Z]*)\s*", str(value))
    if not m:
        raise ValueError(f"cannot parse size: {value!r}")
    num, unit = m.groups()
    unit = unit.lower()
    if unit not in _UNIT_FACTORS:
        raise ValueError(f"unknown unit in {value!r}")
    return int(float(num) * _UNIT_FACTORS[unit])


def parse_options_value(options: str, option: str, last: bool = False) -> str:
    """Return the token following `option` in an option string.

    ``parse_options_value('-x map-ont -t 5', '-t') == '5'``
    """
    tokens = str(options).split()
    hits = [i for i, t in enumerate(tokens) if t == option]
    if not hits:
        raise ValueError(f"option {option} not found in {options!r}")
    i = hits[-1] if last else hits[0]
    if i + 1 >= len(tokens):
        raise ValueError(f"option {option} has no value in {options!r}")
    return tokens[i + 1]


def cal_n50_info(lengths, out=None):
    """Return (and optionally write) assembly stats: N10..N90, min/max/ave/total.

    Matches the stat table the reference emits next to the final FASTA
    (lib/kit.py:218-237).
    """
    lens = sorted((int(x) for x in lengths), reverse=True)
    total = sum(lens)
    count = len(lens)
    rows = []
    if count:
        acc = 0
        targets = [total * i // 10 for i in range(1, 10)]
        ti = 0
        for i, ln in enumerate(lens):
            acc += ln
            while ti < 9 and acc >= targets[ti]:
                rows.append((f"N{(ti + 1) * 10}", ln, i + 1))
                ti += 1
            if ti >= 9:
                break
    lines = ["Type           Length (bp)            Count (#)"]
    for name, ln, cnt in rows:
        lines.append(f"{name:<15}{ln:<23}{cnt}")
    lines.append("")
    lines.append(f"{'Min.':<15}{lens[-1] if lens else 0:<23}-")
    lines.append(f"{'Max.':<15}{lens[0] if lens else 0:<23}-")
    lines.append(f"{'Ave.':<15}{total // count if count else 0:<23}-")
    lines.append(f"{'Total':<15}{total:<23}{count}")
    text = "\n".join(lines) + "\n"
    if out:
        with open(out, "w") as fh:
            fh.write(text)
    return text


def _open_maybe_gzip(path, mode="rt"):
    with open(path, "rb") as probe:
        magic = probe.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, mode)
    return open(path, mode)


def calgs(path: str) -> int:
    """Genome size = sum of sequence lengths of a (gzipped) FASTA/FASTQ."""
    total = 0
    with _open_maybe_gzip(path) as fh:
        first = fh.read(1)
        fh.seek(0)
        if first == ">":
            for line in fh:
                if not line.startswith(">"):
                    total += len(line.strip())
        elif first == "@":
            for i, line in enumerate(fh):
                if i % 4 == 1:
                    total += len(line.strip())
        else:
            raise ValueError(f"{path}: not FASTA/FASTQ")
    return total
