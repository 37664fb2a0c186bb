"""The polishing pipeline driver (role of source/nextPolish:25-530): port
of nextpolish_tpu/pipeline.py.

Per task round: snapshot input genome -> (re)index -> map reads with the
built-in mapper -> polish every contig with the task's engine -> emit a
FASTA part with resume support -> next round reads the previous output.
The final round gathers genome.nextpolish.fasta + N50 stats
(gather_ctg_cns_output parity, source/nextPolish:309-338).

Deviations from the reference, by design:
  * no external bwa/minimap2/samtools: the built-in seed-chain-extend
    mapper produces alignment batches directly (BAM import still available
    for bring-your-own-BAM workflows via the worker APIs);
  * Paralleltask shell jobs -> in-process stages with filesystem
    checkpointing (runtime/scheduler.py);
  * contig names stay unchanged across rounds (the bundled expected outputs
    use plain names as well).

Where the port differs from the JAX package's driver:
  * every device stage runs on the one `device` the caller names (the
    mapper's banded DP and traceback, task 1's chain DP, task 2's no-depth
    rescue, task 3's low-depth rescue, the task 5/6 engine chosen by
    models/cns/window.default_engine);
  * task 1 runs score_chain_pipeline, which on one device is what the JAX
    router does; a contig past the single-launch cap takes the window
    route inside it;
  * in a run of several processes (parallel/hosts.py) each rank polishes
    its block of contigs on its own device, contigs of SHARD_MIN_LEN
    (30 Mb) and more too: the JAX router would build a reads mesh over
    every process's devices for those, but the window route is
    byte-equal to the sharded one (tests/test_shard_merge.py), so the
    bytes are the same;
  * with several processes, rank 0 alone rotates the workdir (rewrite)
    and every rank spills its BAM parts into a directory of its own
    (ROADMAP C8);
  * a truncated or corrupt .gz read file no longer escapes the spill
    estimate (EOFError, zlib.error): its expansion falls back to 3.0.
"""
from __future__ import annotations

import os
import zlib

import numpy as np

from .align.index import GenomeIndex
from .align.longread import map_long_batch
from .align.mapper import map_short_batch, records_to_batch
from .config import RunConfig, TASK_NAMES
from .device import resolve_device
from .io import bam as bamio
from .io.fasta import FastaIndex, SeqRecord, read_fastx, write_fasta
from .kit import cal_n50_info, plog
from .models.score_chain import AlgoConfig, estimate_read_tlen
from .runtime.scheduler import StageRunner, backup_dir

log = plog()


class Pipeline:
    def __init__(self, cfg: RunConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.algo = AlgoConfig()
        self._sgs_paired = False

    # ------------------------------------------------------------------
    # read ingest (seq_split role, util/seq_split.c)
    # ------------------------------------------------------------------
    def iter_sgs_chunks(self, chunk_reads: int):
        """Short reads from the fofn as bounded chunks: interleaved pairs,
        N-read removal, total-depth cap (seq_split semantics,
        util/seq_split.c:256-360).  Yields (seqs, quals, names) lists of
        <= chunk_reads reads so ingest RAM stays O(chunk)."""
        cfg = self.cfg
        files = [l.strip() for l in open(cfg.sgs_fofn) if l.strip()]
        files = [
            f if f.startswith("/") else
            os.path.join(os.path.dirname(cfg.sgs_fofn), f)
            for f in files
        ]
        cap = cfg.sgs_max_depth * cfg.genome_size
        paired = not cfg.sgs_unpaired and len(files) >= 2
        self._sgs_paired = paired
        seqs, quals, names = [], [], []
        total = 0
        n_reads = 0

        def flush():
            nonlocal seqs, quals, names
            out = (seqs, quals, names)
            seqs, quals, names = [], [], []
            return out

        if paired:
            iters = [read_fastx(f) for f in files[:2]]
            for r1 in iters[0]:
                r2 = next(iters[1], None)
                if r2 is None:
                    break
                if cfg.sgs_rm_nread and (b"N" in r1.seq.upper()
                                         or b"N" in r2.seq.upper()):
                    continue
                for r in (r1, r2):
                    seqs.append(r.seq)
                    quals.append(r.qual)
                    names.append(r.name)
                n_reads += 2
                total += len(r1.seq) + len(r2.seq)
                if len(seqs) >= chunk_reads:
                    yield flush()
                if cap and total >= cap:
                    break
        else:
            for f in files:
                for r in read_fastx(f):
                    if cfg.sgs_rm_nread and b"N" in r.seq.upper():
                        continue
                    seqs.append(r.seq)
                    quals.append(r.qual)
                    names.append(r.name)
                    n_reads += 1
                    total += len(r.seq)
                    if len(seqs) >= chunk_reads:
                        yield flush()
                    if cap and total >= cap:
                        break
                if cap and total >= cap:
                    break
        if seqs:
            yield flush()
        log.info("sgs reads: %d (%d bases)", n_reads, total)

    def iter_long_chunks(self, kind: str, chunk_reads: int):
        """Long reads (lgs/hifi) as bounded chunks with min/max length
        filters and the depth cap."""
        cfg = self.cfg
        fofn = cfg.lgs_fofn if kind == "lgs" else cfg.hifi_fofn
        min_len = (cfg.lgs_min_read_len if kind == "lgs"
                   else cfg.hifi_min_read_len)
        max_len = (cfg.lgs_max_read_len if kind == "lgs"
                   else cfg.hifi_max_read_len)
        cap = (cfg.lgs_max_depth if kind == "lgs" else cfg.hifi_max_depth
               ) * cfg.genome_size
        files = [l.strip() for l in open(fofn) if l.strip()]
        files = [
            f if f.startswith("/") else os.path.join(os.path.dirname(fofn), f)
            for f in files
        ]
        seqs, names = [], []
        total = 0
        n_reads = 0
        for f in files:
            for r in read_fastx(f):
                if len(r.seq) < min_len:
                    continue
                if max_len and len(r.seq) > max_len:
                    continue
                seqs.append(r.seq)
                names.append(r.name)
                n_reads += 1
                total += len(r.seq)
                if len(seqs) >= chunk_reads:
                    yield seqs, names
                    seqs, names = [], []
                if cap and total >= cap:
                    break
            if cap and total >= cap:
                break
        if seqs:
            yield seqs, names
        log.info("%s reads: %d (%d bases)", kind, n_reads, total)

    # ------------------------------------------------------------------
    # per-task machinery
    # ------------------------------------------------------------------
    CHUNK_READS = 200_000  # chunked ingest: raw FASTQ buffers stay
    # O(chunk) while mapping (seq_split's read-chunk role)

    def _spill_enabled(self, fofn: str) -> bool:
        """Spill mapped chunks to sorted BAMs (the reference's per-part
        sort + merge data plane, lib/bsort.c:1202-1463) when the mapped
        records would not comfortably fit in RAM.  NPT_SPILL_BAM=1/0
        forces; 'auto' estimates from the input file sizes."""
        env = os.environ.get("NPT_SPILL_BAM", "auto")
        if env in ("1", "always", "on"):
            return True
        if env in ("0", "never", "off"):
            return False
        from .runtime.budget import host_available_bytes

        try:
            d = os.path.dirname(os.path.abspath(fofn))
            total = 0
            for line in open(fofn):
                line = line.strip()
                if line:
                    p = line if line.startswith("/") else os.path.join(d,
                                                                       line)
                    sz = os.path.getsize(p)
                    # MEASURE the expansion of compressed inputs instead
                    # of assuming a ratio: decompress the first ~4 MB
                    # and extrapolate (gz ratios for FASTQ range ~2.5-5x
                    # with quality-line entropy; a guess either spills
                    # needlessly or OOMs at scale)
                    if p.endswith((".gz", ".bgz")):
                        sz = int(sz * _gz_expansion(p))
                    total += sz
            # mapped records cost ~2x their raw FASTQ bytes in RAM
            return total * 2 > host_available_bytes() // 4
        except (OSError, EOFError, zlib.error):
            return False

    def _spill_chunk(self, recs: list, idx: GenomeIndex, part: str) -> str:
        """Write one chunk's mapped records as a sorted, indexed BAM."""
        header = bamio.BamHeader("", list(idx.names),
                                 [int(x) for x in idx.lengths])
        mapped = sorted((r for r in recs if r["tid"] >= 0),
                        key=lambda r: (r["tid"], r["pos"]))
        bamio.write_bam(part, header, mapped, index=True)
        return part

    def _spill_dir(self, genome_path: str, tag: str) -> str:
        """The spilled BAM parts' directory: one a rank, since every rank
        maps every read (the JAX package shares one: C8)."""
        from .parallel.hosts import process_count, process_index

        d = os.path.join(self.cfg.workdir, f"spill.{tag}")
        if process_count() > 1:
            d += f".rank{process_index()}"
        os.makedirs(d, exist_ok=True)
        return d

    def map_sgs(self, genome: FastaIndex, genome_path: str = ""):
        """Map short reads; returns an AlnBatch (in-memory) or a
        RegionFetcher over spilled per-chunk sorted BAMs (O(window) data
        plane — the reference's per-part `samtools sort` + merge,
        source/nextPolish:199-226 + lib/bsort.c)."""
        idx = GenomeIndex.build(
            [(n, genome.fetch(n).seq) for n in genome.names], k=17, w=7
        )
        spill = self._spill_enabled(self.cfg.sgs_fofn)
        c = self.CHUNK_READS - (self.CHUNK_READS % 2)  # keep mates together
        recs = []
        parts = []
        dup_state: dict = {}
        spdir = self._spill_dir(genome_path, "sgs") if spill else None
        for ci, (seqs, quals, names) in enumerate(self.iter_sgs_chunks(c)):
            chunk = map_short_batch(idx, seqs, names, quals,
                                    paired=self._sgs_paired,
                                    device=self.device)
            if not self.cfg.sgs_use_duplicate_reads and self._sgs_paired:
                chunk = mark_duplicates(chunk, state=dup_state)
            if spill:
                parts.append(self._spill_chunk(
                    chunk, idx, os.path.join(spdir, f"part{ci:04d}.bam")))
            else:
                recs.extend(chunk)
        if spill:
            from .io.bamregion import RegionFetcher

            log.info("sgs data plane: %d spilled BAM parts", len(parts))
            # samtools-merge tie order (no strand key) == the in-memory
            # stable (tid, pos) sort -> byte-identical polish either way
            return RegionFetcher(parts, heap_rev=False)
        return records_to_batch(recs, idx)

    def map_long(self, genome: FastaIndex, kind: str,
                 genome_path: str = ""):
        idx = GenomeIndex.build(
            [(n, genome.fetch(n).seq) for n in genome.names], k=15, w=10
        )
        fofn = self.cfg.lgs_fofn if kind == "lgs" else self.cfg.hifi_fofn
        spill = self._spill_enabled(fofn)
        recs = []
        parts = []
        spdir = self._spill_dir(genome_path, kind) if spill else None
        for ci, (seqs, names) in enumerate(
                self.iter_long_chunks(kind, self.CHUNK_READS)):
            chunk = map_long_batch(idx, seqs, names, device=self.device)
            if spill:
                parts.append(self._spill_chunk(
                    chunk, idx, os.path.join(spdir, f"part{ci:04d}.bam")))
            else:
                recs.extend(chunk)
        if spill:
            from .io.bamregion import RegionFetcher

            log.info("%s data plane: %d spilled BAM parts", kind,
                     len(parts))
            return RegionFetcher(parts, heap_rev=False)
        return records_to_batch(recs, idx)

    def polish_task(self, task: int, genome_path: str, outfile: str) -> None:
        """Polish all contigs for one task, resuming from partial output
        (lib/nextpolish1.py:163-216 semantics)."""
        genome = FastaIndex(genome_path)
        done = read_polished_names(outfile)
        from .parallel.hosts import my_contigs

        mine = my_contigs(genome.lengths())
        todo = [n for n in mine if n not in done]
        if not todo:
            return
        def per_contig(src, name, seqlen):
            """Per-contig AlnBatch from a spilled RegionFetcher (htslib
            bam_itr_queryi role); in-memory batches pass through."""
            if src is not None and hasattr(src, "fetch"):
                return src.fetch(src.header.name2id(name),
                                 0, max(seqlen - 1, 0))
            return src

        def head_of(src):
            return (src.fetch_head(10_000)
                    if hasattr(src, "fetch_head") else src)

        engine = None
        if task in (1, 2):
            batch = self.map_sgs(genome, genome_path)
            if task == 2:
                self.algo.read_tlen = estimate_read_tlen(head_of(batch),
                                                         self.algo)
            from .models.kmer_count import kmer_count_contig
            from .models.score_chain import score_chain_pipeline

            if task == 1:
                # one device: the pipelined single-launch path, with the
                # window route for contigs past the launch cap (what the
                # JAX router does on a one-device mesh)
                results = score_chain_pipeline(
                    ((n, genome.fetch(n).seq) for n in todo), batch,
                    self.algo, device=self.device)
            else:
                engine = lambda name, seq: kmer_count_contig(
                    name, seq, per_contig(batch, name, len(seq)), self.algo,
                    self.device)
        elif task in (3, 4):
            sgs = self.map_sgs(genome, genome_path)
            self.algo.read_tlen = estimate_read_tlen(head_of(sgs),
                                                     self.algo)
            lgs = (self.map_long(genome, "lgs", genome_path)
                   if self.cfg.lgs_fofn else None)
            from .models.snp_phase import snp_phase_contig
            from .models.snp_valid import snp_valid_contig

            if task == 3:
                engine = lambda name, seq: snp_phase_contig(
                    name, seq, per_contig(sgs, name, len(seq)),
                    per_contig(lgs, name, len(seq)), self.algo, self.device)
            else:
                engine = lambda name, seq: snp_valid_contig(
                    name, seq, per_contig(sgs, name, len(seq)),
                    per_contig(lgs, name, len(seq)), self.algo)
        elif task in (5, 6):
            kind = "lgs" if task == 5 else "hifi"
            batch = self.map_long(genome, kind, genome_path)
            read_type = (self.cfg.lgs_read_type or "ont") if task == 5 else "hifi"
            from .models.ctg_cns import ctg_cns_contig
            from .runtime.budget import cns_window_len

            # clamp the consensus window to host memory the way worker2
            # does (set_window_process role, lib/nextpolish2.py:67-90) —
            # an oversized contig/coverage run clamps instead of OOMing
            window, ram_clamped = cns_window_len(read_type)
            if ram_clamped:
                log.warning("cns window clamped to %d by available memory",
                            window)
            # the pipeline driver passes -sp to disable contig splitting
            # between rounds (source/nextPolish:76-83)
            from .models.cns.window import default_engine

            batcher = None
            if default_engine(self.device) == "device":
                from .models.cns.batcher import CnsBatcher

                batcher = CnsBatcher(read_type, device=self.device)
            engine = lambda name, seq: ctg_cns_contig(
                name, seq, batch, read_type, split=0, window=window,
                batcher=batcher, device=self.device
            )
        else:
            raise ValueError(f"unknown task {task}")

        if engine is not None:
            from .runtime.overlap import pipelined_map

            # contig-level pipelining: one contig's host prep overlaps
            # another's device scans (Pool.imap_unordered role,
            # lib/nextpolish1.py:223-224 / nextpolish2.py:192-194)
            depth = 1
            if task in (5, 6):
                depth = 8 if batcher is not None else 2
            results = pipelined_map(
                lambda n: (n, engine(n, genome.fetch(n).seq)), todo,
                depth=depth)
        mode = "ab" if done else "wb"
        with open(outfile, mode) as out:
            for name, seq in results:
                if isinstance(seq, bytes):
                    parts = [(name, seq)]
                else:
                    parts = seq  # ctg_cns may split contigs
                for pname, pseq in parts:
                    out.write(
                        b">" + pname.encode() + b" " + str(len(pseq)).encode()
                        + b"\n" + pseq + b"\n"
                    )
                out.flush()

    # ------------------------------------------------------------------
    def run(self) -> str:
        from .parallel.hosts import barrier, process_count, process_index

        cfg = self.cfg
        nproc = process_count()
        rank = process_index()
        # one rank rotates the shared workdir, and the others wait for it
        # (the JAX package lets every rank rotate it: C8)
        if cfg.rewrite and rank == 0:
            moved = backup_dir(cfg.workdir)
            if moved:
                log.warning("workdir moved to %s", moved)
        barrier("rewrite")
        os.makedirs(cfg.workdir, exist_ok=True)
        runner = StageRunner(cfg.workdir, cfg.rerun)

        genome_path = cfg.genome
        for step, task in enumerate(cfg.task, 1):
            stage_dir = cfg.stage_dir(step, task)
            os.makedirs(stage_dir, exist_ok=True)
            outfile = os.path.join(stage_dir, "genome.nextpolish.part.fasta")
            part = outfile if nproc == 1 else f"{outfile}.rank{rank}"
            gp = genome_path
            runner.stage(
                f"{step:02d}.{TASK_NAMES[task]}"
                + (f".rank{rank}" if nproc > 1 else ""),
                lambda t=task, g=gp, o=part: self.polish_task(t, g, o),
                subdir=stage_dir,
            )
            if nproc > 1:
                # all ranks' part files complete -> rank 0 gathers (the
                # samtools-merge/`cat` role over the shared filesystem),
                # then everyone proceeds with the stitched genome
                barrier(f"polish.{step}")
                if rank == 0 and not os.path.exists(outfile):
                    tmp = outfile + ".tmp"
                    with open(tmp, "wb") as out:
                        for r in range(nproc):
                            rp = f"{outfile}.rank{r}"
                            if os.path.exists(rp):
                                with open(rp, "rb") as fh:
                                    out.write(fh.read())
                    os.replace(tmp, outfile)
                barrier(f"gather.{step}")
            genome_path = outfile

        # gather (versioned name resolved before rank 0 writes, so every
        # rank agrees on it)
        barrier("pre-final")
        asm = os.path.join(cfg.workdir, "genome.nextpolish.fasta")
        i = 0
        while os.path.exists(asm):
            i += 1
            asm = os.path.join(cfg.workdir, f"genome.nextpolish.v{i}.fasta")
        if nproc > 1 and rank != 0:
            barrier("final")
            return asm
        lengths = []
        with open(asm, "wb") as out:
            for rec in read_fastx(genome_path):
                lengths.append(len(rec.seq))
                out.write(b">" + rec.name.encode() + b" "
                          + str(len(rec.seq)).encode() + b"\n" + rec.seq
                          + b"\n")
        stats = cal_n50_info(lengths, asm + ".stat")
        log.info("final assembly: %s\n%s", asm, stats)
        if nproc > 1:
            barrier("final")
        return asm


def _gz_expansion(path: str, probe: int = 1 << 22) -> float:
    """Measured decompression ratio of a gzip/bgzf file from its first
    ~4 MB of compressed stream (extrapolated; clamped to sane bounds)."""
    import gzip

    try:
        comp = os.path.getsize(path)
        raw = used = 0
        with gzip.open(path, "rb") as fh:
            budget = min(probe, comp)
            # read decompressed data until the underlying file position
            # passes the probe budget
            while fh.fileobj.tell() < budget:
                block = fh.read(1 << 20)
                if not block:
                    break
                raw += len(block)
            used = min(fh.fileobj.tell(), comp)
        if used <= 0 or raw <= 0:
            return 3.0
        return float(min(max(raw / used, 1.0), 12.0))
    except (OSError, EOFError, zlib.error):
        return 3.0


def read_polished_names(outfile: str) -> set:
    """Scan a partial output FASTA; the last (possibly truncated) record is
    dropped and re-polished (lib/nextpolish1.py:163-179)."""
    if not os.path.exists(outfile):
        return set()
    names = []
    offsets = []
    off = 0
    with open(outfile, "rb") as fh:
        for line in fh:
            if line.startswith(b">"):
                names.append(line.split()[0][1:].decode())
                offsets.append(off)
            off += len(line)
    if not names:
        return set()
    # truncate the file at the last record start and drop it
    with open(outfile, "rb+") as fh:
        fh.truncate(offsets[-1])
    return set(names[:-1])


def _unclipped5(rec) -> int:
    """Unclipped 5' fragment end (samtools markdup's coordinate): leading
    clips extend a forward read's start leftward; trailing clips extend a
    reverse read's end rightward."""
    cig = rec["cigar"]
    if not len(cig):
        return int(rec["pos"])
    ops = cig & 0xF
    lens = (cig >> 4).astype(np.int64)
    if rec["flag"] & bamio.FREVERSE:
        ref_len = int((lens * bamio.CONSUMES_R[ops]).sum())
        tail = 0
        j = len(cig) - 1
        while j >= 0 and ops[j] in (4, 5):
            tail += int(lens[j])
            j -= 1
        return int(rec["pos"]) + ref_len - 1 + tail
    head = 0
    j = 0
    while j < len(cig) and ops[j] in (4, 5):
        head += int(lens[j])
        j += 1
    return int(rec["pos"]) - head


def mark_duplicates(recs: list, state: dict | None = None) -> list:
    """Remove PCR duplicates (samtools markdup -r role,
    source/nextPolish:119-156): fragments sharing unclipped-5' coordinates
    keep only the first.  Both-mapped pairs key on (tid, 5'1, mtid, 5'2,
    orientation) regardless of properness — at contig edges and collapsed
    repeats the clipped raw positions differ while the true fragments
    collide, which is exactly where markdup matters; mate-unmapped reads
    dedup on their single-end (tid, 5', strand).

    `state` carries the seen-key sets across chunks so chunked (spilled)
    processing drops exactly the records a whole-input pass would — mates
    always share a chunk (chunk sizes are even and pairs adjacent).

    Memory: keys are folded to 64-bit mixes (~10x smaller than tuple
    sets; the whole-genome seen set is the one structure that must span
    all chunks).  A 64-bit collision falsely drops one fragment with
    probability ~n^2/2^64 — about 0.1 fragments across a 50x human
    genome run, far below the sequencing noise floor."""
    primary_by_name: dict = {}
    for i, r in enumerate(recs):
        if not (r["flag"] & (bamio.FSECONDARY | bamio.FSUPPLEMENTARY)):
            primary_by_name.setdefault(r.get("name"), []).append(i)
    if state is None:
        state = {}
    seen = state.setdefault("seen", set())
    seen_se = state.setdefault("seen_se", set())
    drop = set()
    u5 = {}

    def u5_of(i):
        if i not in u5:
            u5[i] = _unclipped5(recs[i])
        return u5[i]

    def mix(*parts):
        h = 0xCBF29CE484222325
        for v in parts:
            h ^= (v + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
            h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
        return h

    for i, r in enumerate(recs):
        if r["tid"] < 0 or (r["flag"]
                            & (bamio.FSECONDARY | bamio.FSUPPLEMENTARY)):
            continue
        mates = primary_by_name.get(r.get("name"), [])
        mate = next((j for j in mates if j != i), None)
        both = (mate is not None and recs[mate]["tid"] >= 0
                and (r["flag"] & bamio.FPAIRED))
        if both:
            if r["flag"] & bamio.FREAD2:
                continue  # key on read1 only; drop both mates together
            key = mix(r["tid"], u5_of(i), recs[mate]["tid"], u5_of(mate),
                      r["flag"] & (bamio.FREVERSE | bamio.FMREVERSE))
            if key in seen:
                for j in mates:
                    drop.add(j)
            else:
                seen.add(key)
        else:
            key_se = mix(r["tid"], u5_of(i),
                         r["flag"] & bamio.FREVERSE)
            if key_se in seen_se:
                drop.add(i)
            else:
                seen_se.add(key_se)
    if drop:
        log.info("markdup: removed %d duplicate records", len(drop))
    return [r for i, r in enumerate(recs) if i not in drop]
