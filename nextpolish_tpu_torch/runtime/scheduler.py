"""Stage scheduler with filesystem checkpointing and bounded retries: a
copy of nextpolish_tpu/runtime/scheduler.py.

Replaces Paralleltask (SURVEY.md §1 L5): instead of shell scripts
submitted to a cluster, stages are Python callables executed in-process
(device work inside is already parallel); the filesystem still holds the
checkpoint state so re-invocation skips finished stages, matching the
reference's semantics (`task.is_finished()` + done markers, and "simply
run the same command again" resume, doc/FAQ.rst:19-22).  The port runs
one process (parallel/hosts.py); several are ROADMAP A6.2.
"""
from __future__ import annotations

import json
import os
import time
import traceback
from dataclasses import dataclass, field

from ..kit import plog

log = plog()


class StageFailed(RuntimeError):
    pass


@dataclass
class Stage:
    name: str
    workdir: str
    fn: object  # callable () -> result (must be side-effect based / idempotent)
    rerun: int = 3

    @property
    def marker(self) -> str:
        return os.path.join(self.workdir, f".{self.name}.done")

    def is_finished(self) -> bool:
        return os.path.exists(self.marker)

    def set_finished(self, meta: dict | None = None) -> None:
        with open(self.marker, "w") as fh:
            json.dump({"time": time.time(), **(meta or {})}, fh)

    def clear(self) -> None:
        if os.path.exists(self.marker):
            os.remove(self.marker)

    def run(self):
        os.makedirs(self.workdir, exist_ok=True)
        if self.is_finished():
            log.info("Skip finished stage: %s", self.name)
            return None
        attempts = max(self.rerun, 1)
        for attempt in range(1, attempts + 1):
            try:
                log.info("Run stage: %s (attempt %d/%d)", self.name, attempt,
                         attempts)
                t0 = time.time()
                result = self.fn()
                self.set_finished({"seconds": round(time.time() - t0, 2)})
                return result
            except Exception:
                log.error("Stage %s failed (attempt %d):\n%s", self.name,
                          attempt, traceback.format_exc())
        raise StageFailed(f"stage {self.name} failed after {attempts} attempts")


@dataclass
class StageRunner:
    workdir: str
    rerun: int = 3
    history: list = field(default_factory=list)

    def stage(self, name: str, fn, subdir: str | None = None):
        import time as _time

        from .trace import add as trace_add, fmt as trace_fmt

        s = Stage(name, subdir or self.workdir, fn, self.rerun)
        t0 = _time.perf_counter()
        result = s.run()
        wall = _time.perf_counter() - t0
        trace_add(f"stage.{name}", wall)
        # the reference's TIME trace channel (lib/config.c:117-130)
        engines = trace_fmt("task1") + " " + trace_fmt("cns")
        log.info("TIME %s wall=%.2fs %s", name, wall, engines.strip())
        self.history.append(name)
        return result


def backup_dir(path: str) -> str | None:
    """Rotate an existing workdir to workdir.backupN
    (source/nextPolish:380-386 rewrite semantics)."""
    if not os.path.exists(path):
        return None
    n = 1
    while os.path.exists(f"{path}.backup{n}"):
        n += 1
    dst = f"{path}.backup{n}"
    os.rename(path, dst)
    return dst
