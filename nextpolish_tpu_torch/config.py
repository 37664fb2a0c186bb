"""Run-config parsing: same grammar and task algebra as the reference.

Behavior parity with lib/config_parser.py:12-272 (new code):
  * INI-ish `key = value` / `key : value` lines, `#` comments, `[section]`
    headers ignored;
  * task strings: digits 1-6, aliases all=561234, default=5612, best=55661212;
  * task pruning when a read fofn is missing, ordering constraints
    (2 after 1, 3 after 2, 4 after 3);
  * derived values: genome size, block sizes, read types, thread counts.
"""
from __future__ import annotations

import os
import re
from dataclasses import dataclass, field

from .kit import calgs, parse_num_unit, parse_options_value, plog

log = plog()

TASK_ALIASES = {"all": "561234", "default": "5612", "best": "55661212"}

# task id -> stage name (workdir naming parity: lib/config_parser.py:127-132)
TASK_NAMES = {
    1: "score_chain",
    2: "kmer_count",
    3: "snp_phase",
    4: "snp_valid",
    5: "lgs_polish",
    6: "hifi_polish",
}

_SGS_TASKS = (1, 2, 3, 4)
_LGS_TASKS = (3, 5)
_HIFI_TASKS = (6,)


def _bool(v) -> bool:
    return str(v).lower() not in ("no", "0", "false", "none", "") and bool(v)


@dataclass
class RunConfig:
    genome: str = ""
    genome_size: int = 0
    workdir: str = ""
    task: list = field(default_factory=list)
    job_type: str = "local"
    job_prefix: str = "nextpolish_tpu"
    rewrite: bool = False
    cleantmp: bool = False
    deltmp: bool = False
    rerun: int = 3
    parallel_jobs: int = 6
    multithread_jobs: int = 5
    polish_options: str = ""
    sgs_fofn: str | None = None
    sgs_unpaired: bool = False
    sgs_use_duplicate_reads: bool = False
    sgs_rm_nread: bool = True
    sgs_max_depth: int = 100
    sgs_block_size: int = 500_000_000
    sgs_aligner: str = "npt-sr"  # built-in short-read mapper
    lgs_fofn: str | None = None
    lgs_min_read_len: int = 1_000
    lgs_max_read_len: int = 0
    lgs_max_depth: int = 100
    lgs_block_size: int = 500_000_000
    lgs_read_type: str = ""  # ont | clr
    lgs_aligner_options: str = "-x map-ont"
    hifi_fofn: str | None = None
    hifi_min_read_len: int = 1_000
    hifi_max_read_len: int = 0
    hifi_max_depth: int = 100
    hifi_block_size: int = 500_000_000
    hifi_aligner_options: str = "-x map-pb"
    align_threads: int = 5
    raw: dict = field(default_factory=dict)

    def stage_dir(self, step: int, task_id: int) -> str:
        return os.path.join(self.workdir, "%02d.%s" % (step, TASK_NAMES[task_id]))


def parse_config_text(text: str) -> dict:
    """Parse the INI-ish `key = value` grammar (lib/config_parser.py:71-79)."""
    cfg = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#") or line.startswith("["):
            continue
        m = re.search(r"([^;\s]+)\s*[=:]\s*([^;#\n]+)(\s*|#.*)$", line)
        if m and m.group(2).strip():
            cfg[m.group(1)] = m.group(2).strip()
    return cfg


def expand_tasks(task_str: str, have_sgs: bool, have_lgs: bool, have_hifi: bool):
    """Expand/validate a task string (lib/config_parser.py:81-122)."""
    task_str = re.sub(r"[\s,;]+", "", str(task_str))
    task_str = TASK_ALIASES.get(task_str, task_str)
    if not re.fullmatch(r"[1-6]+", task_str):
        raise ValueError(f"invalid task string: {task_str!r}")
    tasks = [int(c) for c in task_str]
    if not have_sgs:
        for t in _SGS_TASKS:
            while t in tasks:
                tasks.remove(t)
                log.warning("Delete task: %d due to missing sgs_fofn.", t)
    if not have_lgs:
        for t in _LGS_TASKS:
            while t in tasks:
                tasks.remove(t)
                log.warning("Delete task: %d due to missing lgs_fofn.", t)
    if not have_hifi:
        for t in _HIFI_TASKS:
            while t in tasks:
                tasks.remove(t)
                log.warning("Delete task: %d due to missing hifi_fofn.", t)
    for i, t in enumerate(tasks):
        if t == 2 and (i == 0 or tasks[i - 1] != 1):
            raise ValueError("task 2 must follow task 1")
        if t == 3 and (i == 0 or tasks[i - 1] != 2):
            raise ValueError("task 3 must follow task 2")
        if t == 4 and (i == 0 or tasks[i - 1] != 3):
            raise ValueError("task 4 must follow task 3")
    return tasks


def load_config(cfgfile: str) -> RunConfig:
    cfgdir = os.path.dirname(os.path.abspath(cfgfile))
    with open(cfgfile) as fh:
        raw = parse_config_text(fh.read())

    def _abspath(p: str) -> str:
        return os.path.normpath(p if p.startswith("/") else os.path.join(cfgdir, p))

    cfg = RunConfig(raw=raw)
    cfg.job_type = raw.get("job_type", "local")
    cfg.job_prefix = raw.get("job_prefix", "nextpolish_tpu")
    cfg.rewrite = _bool(raw.get("rewrite", "0"))
    cfg.cleantmp = _bool(raw.get("cleantmp", "0"))
    cfg.deltmp = _bool(raw.get("deltmp", "0"))
    rerun = raw.get("rerun", "3")
    cfg.rerun = min(int(rerun), 10) if _bool(rerun) else 0
    cfg.parallel_jobs = int(raw.get("parallel_jobs", 6))
    cfg.multithread_jobs = int(raw.get("multithread_jobs", 5))
    cfg.polish_options = raw.get("polish_options", "")
    cfg.workdir = _abspath(raw.get("workdir", os.getcwd()))

    if "genome" not in raw:
        raise ValueError("config missing required `genome` option")
    cfg.genome = _abspath(raw["genome"])
    if not os.path.exists(cfg.genome):
        raise FileNotFoundError(cfg.genome)
    gsize = raw.get("genome_size", "auto")
    cfg.genome_size = calgs(cfg.genome) if gsize == "auto" else parse_num_unit(gsize)

    sgs_options = raw.get("sgs_options", "")
    lgs_options = raw.get("lgs_options", "")
    hifi_options = raw.get("hifi_options", "")

    if "sgs_fofn" in raw:
        cfg.sgs_fofn = _abspath(raw["sgs_fofn"])
        if not os.path.exists(cfg.sgs_fofn):
            raise FileNotFoundError(cfg.sgs_fofn)
        cfg.sgs_unpaired = "unpaired" in sgs_options
        cfg.sgs_use_duplicate_reads = "use_duplicate_reads" in sgs_options
        cfg.sgs_rm_nread = "-N" not in sgs_options
        if "-max_depth" in sgs_options:
            cfg.sgs_max_depth = int(parse_options_value(sgs_options, "-max_depth"))
        if "-block_size" in sgs_options:
            cfg.sgs_block_size = parse_num_unit(
                parse_options_value(sgs_options, "-block_size")
            )
        else:
            cfg.sgs_block_size = int(
                min(
                    parse_num_unit(raw.get("sgs_block_size", "500M")),
                    cfg.genome_size * cfg.sgs_max_depth / cfg.parallel_jobs,
                )
            )

    def _lgs_like(prefix: str, options: str, default_x: str):
        fofn = _abspath(raw[f"{prefix}_fofn"])
        if not os.path.exists(fofn):
            raise FileNotFoundError(fofn)
        vals = {}
        vals["min_read_len"] = (
            parse_num_unit(parse_options_value(options, "-min_read_len"))
            if "min_read_len" in options
            else 1_000
        )
        vals["max_read_len"] = (
            parse_num_unit(parse_options_value(options, "-max_read_len"))
            if "max_read_len" in options
            else 0
        )
        vals["max_depth"] = (
            int(parse_options_value(options, "-max_depth"))
            if "max_depth" in options
            else 100
        )
        if "-block_size" in options:
            vals["block_size"] = parse_num_unit(
                parse_options_value(options, "-block_size")
            )
        else:
            vals["block_size"] = int(
                min(
                    parse_num_unit(raw.get(f"{prefix}_block_size", "500M")),
                    cfg.genome_size * vals["max_depth"] / cfg.parallel_jobs,
                )
            )
        aligner_opts = raw.get(f"{prefix}_minimap2_options", default_x)
        return fofn, vals, aligner_opts

    if "lgs_fofn" in raw:
        cfg.lgs_fofn, vals, cfg.lgs_aligner_options = _lgs_like(
            "lgs", lgs_options, "-x map-ont"
        )
        cfg.lgs_min_read_len = vals["min_read_len"]
        cfg.lgs_max_read_len = vals["max_read_len"]
        cfg.lgs_max_depth = vals["max_depth"]
        cfg.lgs_block_size = vals["block_size"]
        if "map-ont" in cfg.lgs_aligner_options:
            cfg.lgs_read_type = "ont"
        elif "map-pb" in cfg.lgs_aligner_options:
            cfg.lgs_read_type = "clr"
        else:
            raise ValueError("cannot detect lgs read type from aligner options")

    if "hifi_fofn" in raw:
        cfg.hifi_fofn, vals, cfg.hifi_aligner_options = _lgs_like(
            "hifi", hifi_options, "-x map-pb"
        )
        cfg.hifi_min_read_len = vals["min_read_len"]
        cfg.hifi_max_read_len = vals["max_read_len"]
        cfg.hifi_max_depth = vals["max_depth"]
        cfg.hifi_block_size = vals["block_size"]

    if cfg.sgs_fofn is None and cfg.lgs_fofn is None and cfg.hifi_fofn is None:
        raise ValueError("config needs at least one of sgs_fofn/lgs_fofn/hifi_fofn")

    cfg.align_threads = cfg.multithread_jobs
    cfg.task = expand_tasks(
        raw.get("task", "best"),
        cfg.sgs_fofn is not None,
        cfg.lgs_fofn is not None,
        cfg.hifi_fofn is not None,
    )
    return cfg
