"""Small shared utilities: logging and unit parsing.

Functional parity targets (reference, for behavior only — new code):
  * plog / colored exit-on-critical logging   -> lib/kit.py:18-92
  * parse_num_unit ("2.3 kb" -> 2300)         -> lib/kit.py:153-177
"""
from __future__ import annotations

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
