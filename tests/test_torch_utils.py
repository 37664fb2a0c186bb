"""The port's copies of the read-set utilities (seq_count, seq_split,
io/seqstat, io/twobit) against the JAX package's modules: each source
equal to its JAX file once the package name is replaced, and every output
byte-equal on the JAX package's own test cases (tests/test_io.py,
tests/test_workers.py::test_seq_stats) and on a seeded random read set
with Ns, pairs and a length filter.  Byte equality is the tolerance."""
import contextlib
import gzip
import io
import pathlib

import numpy as np
import pytest

import nextpolish_tpu.io.seqstat as jax_seqstat
import nextpolish_tpu.io.twobit as jax_twobit
import nextpolish_tpu.seq_count as jax_seq_count
import nextpolish_tpu.seq_split as jax_seq_split
import nextpolish_tpu_torch.io.seqstat as seqstat
import nextpolish_tpu_torch.io.twobit as twobit
import nextpolish_tpu_torch.seq_count as seq_count
import nextpolish_tpu_torch.seq_split as seq_split

ROOT = pathlib.Path(__file__).resolve().parents[1]
COPIES = ("seq_count.py", "seq_split.py", "io/seqstat.py", "io/twobit.py")


@pytest.mark.parametrize("rel", COPIES)
def test_copy_equals_jax_source(rel):
    jax_src = (ROOT / "nextpolish_tpu" / rel).read_text()
    port_src = (ROOT / "nextpolish_tpu_torch" / rel).read_text()
    assert port_src.replace("nextpolish_tpu_torch", "nextpolish_tpu") \
        == jax_src


def _run(main, argv):
    """main(argv)'s return code, stdout and stderr."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(argv)
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue(), err.getvalue()


def _random_reads(d: pathlib.Path, seed: int = 7):
    """Two gzipped FASTQ mates of 200 pairs (lengths 20-400, about one
    read in 70 with an N, a few in lower case) and a FASTA of 60 single
    reads, with a fofn listing the mates (relative) and the FASTA
    (absolute)."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)

    def read():
        s = rng.choice(bases, int(rng.integers(20, 400)))
        if rng.random() < 0.015:
            s[rng.integers(0, len(s))] = ord("N")
        b = s.tobytes()
        return b.lower() if rng.random() < 0.05 else b

    for mate in (1, 2):
        with gzip.open(d / f"r{mate}.fq.gz", "wt") as fh:
            for i in range(200):
                s = read().decode()
                fh.write(f"@p{i}/{mate}\n{s}\n+\n{'I' * len(s)}\n")
    with open(d / "single.fa", "w") as fh:
        for i in range(60):
            fh.write(f">s{i} extra\n{read().decode()}\n")
    (d / "in.fofn").write_text(f"r1.fq.gz\nr2.fq.gz\n{d / 'single.fa'}\n")
    return d / "in.fofn"


def _test_io_count_case(d: pathlib.Path):
    with gzip.open(d / "r.fq.gz", "wt") as fh:
        for i, ln in enumerate((500, 1500, 2500, 3500)):
            fh.write(f"@r{i}\n{'A' * ln}\n+\n{'I' * ln}\n")
    (d / "in.fofn").write_text("r.fq.gz\n")
    return ["-g", "1k", "-f", "1k", str(d / "in.fofn")]


def _test_io_split_case(d: pathlib.Path):
    for name, tag in (("r1.fq.gz", "a"), ("r2.fq.gz", "b")):
        with gzip.open(d / name, "wt") as fh:
            for i in range(30):
                seq = "ACGT" * 40 if i % 10 else "ACGTN" * 32
                fh.write(f"@{tag}{i}\n{seq}\n+\n{'I' * len(seq)}\n")
    (d / "in.fofn").write_text("r1.fq.gz\nr2.fq.gz\n")
    return ["-n", "3", "-p", "chunk", str(d / "in.fofn")]


@pytest.mark.parametrize("case", ["test_io", "random", "random_reads"])
def test_seq_count_matches_jax(tmp_path, case):
    if case == "test_io":
        argv = _test_io_count_case(tmp_path)
    else:
        fofn = _random_reads(tmp_path)
        argv = (["-g", "50k", "-f", "200", "-d", "3", str(fofn)]
                if case == "random" else
                [str(tmp_path / "r1.fq.gz"), str(tmp_path / "single.fa")])
    want = _run(jax_seq_count.main, argv)
    got = _run(seq_count.main, argv)
    assert want[0] == 0 and "N50" in want[1]
    assert got == want


def test_seq_count_missing_file_matches_jax(tmp_path):
    argv = [str(tmp_path / "absent.fq")]
    assert _run(seq_count.main, argv) == _run(jax_seq_count.main, argv)


def _parts(d: pathlib.Path) -> dict:
    return {p.name: gzip.decompress(p.read_bytes())
            for p in sorted(d.glob("*.fasta.gz"))}


@pytest.mark.parametrize("case,flags", [
    ("test_io", []),
    ("random", ["-n", "4", "-f", "25", "-l", "395", "-s", "40k"]),
    ("random", ["-n", "3", "-i", "0", "-N", "-f", "0.05k"]),
])
def test_seq_split_matches_jax(tmp_path, case, flags):
    if case == "test_io":
        argv = _test_io_split_case(tmp_path)
    else:
        argv = flags + [str(_random_reads(tmp_path))]
    runs = {}
    for label, main in (("jax", jax_seq_split.main),
                        ("port", seq_split.main)):
        out = tmp_path / label
        rc, stdout, stderr = _run(main, ["-d", str(out)] + argv)
        runs[label] = (rc, stdout.replace(str(out), "OUT"), stderr,
                       _parts(out))
    assert runs["jax"][0] == 0 and runs["jax"][3]
    assert runs["port"] == runs["jax"]


def test_seq_split_too_many_n_matches_jax(tmp_path):
    """More than 10% of the reads hold an N: both exit 1 and say why."""
    with open(tmp_path / "r.fa", "w") as fh:
        for i in range(20):
            fh.write(f">r{i}\n{'ACGN' if i % 4 == 0 else 'ACGT'}{'A' * 60}\n")
    (tmp_path / "in.fofn").write_text("r.fa\n")
    outs = []
    for label, main in (("jax", jax_seq_split.main),
                        ("port", seq_split.main)):
        rc, _, err = _run(main, ["-n", "2", "-d", str(tmp_path / label),
                                 str(tmp_path / "in.fofn")])
        outs.append((rc, err, _parts(tmp_path / label)))
    assert outs[0][0] == 1 and outs[1] == outs[0]


@pytest.mark.parametrize("case", ["test_workers", "random"])
def test_seq_stats_matches_jax(tmp_path, case):
    if case == "test_workers":
        fq = tmp_path / "r.fa"
        with open(fq, "w") as fh:
            for i, ln in enumerate([1000, 2000, 3000, 4000]):
                fh.write(f">r{i}\n{'A' * ln}\n")
        paths, kw = [str(fq)], dict(genome_size=1000)
    else:
        _random_reads(tmp_path)
        paths = [str(tmp_path / n) for n in ("r1.fq.gz", "r2.fq.gz",
                                             "single.fa")]
        kw = dict(genome_size=30_000, min_len=150, top_depth=2)
    want = jax_seqstat.seq_stats(paths, **kw)
    got = seqstat.seq_stats(paths, **kw)
    assert got == want
    assert seqstat.format_stats(got) == jax_seqstat.format_stats(want)
    assert seqstat.seq_stats(paths) == jax_seqstat.seq_stats(paths)


def _seqs():
    rng = np.random.default_rng(11)
    return [b"ACGTACGTTGCA" * 7 + b"ACG",
            rng.choice(np.frombuffer(b"ACGTNacgtRY", np.uint8),
                       1001).tobytes(),
            b"", b"T"]


@pytest.mark.parametrize("i", range(4))
def test_twobit_codec_matches_jax(i):
    seq = _seqs()[i]
    pj, nj = jax_twobit.pack(seq)
    pt, nt = twobit.pack(seq)
    assert nt == nj and pt.dtype == pj.dtype and np.array_equal(pt, pj)
    arr = np.frombuffer(seq, dtype=np.uint8)
    assert np.array_equal(twobit.pack(arr)[0], jax_twobit.pack(arr)[0])
    n = nj
    for start, end in ((0, None), (3, 9), (0, 4), (n // 3, n - 1),
                       (n, n + 5), (2, 2 + n)):
        for rc in (False, True):
            assert twobit.unpack(pt, n, start, end, rc) == \
                jax_twobit.unpack(pj, n, start, end, rc)
        if start < n:
            assert np.array_equal(
                twobit.unpack_codes(pt, n, start, end),
                jax_twobit.unpack_codes(pj, n, start, end))


def test_twobit_genome_matches_jax(tmp_path):
    p = tmp_path / "g.fa"
    p.write_text(">c1\nACGTACGT\n>c2\nTTTTGGGG\n>c3\n"
                 + _seqs()[1].decode() + "\n")
    for names in (None, ["c3", "c1"]):
        gj = jax_twobit.TwoBitGenome.from_fasta(str(p), names)
        gt = twobit.TwoBitGenome.from_fasta(str(p), names)
        assert gt.names == gj.names and gt.nbytes() == gj.nbytes()
        for name in gj.names:
            n = gj.length(name)
            assert gt.length(name) == n
            for start, end in ((0, None), (2, 6), (n // 2, n)):
                assert gt.fetch(name, start, end) == \
                    gj.fetch(name, start, end)
                assert gt.fetch(name, start, end, rc=True) == \
                    gj.fetch(name, start, end, rc=True)
                assert np.array_equal(gt.fetch_codes(name, start, end),
                                      gj.fetch_codes(name, start, end))
