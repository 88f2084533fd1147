"""chip_smoke.py's data generators and compare functions at tiny sizes."""

import gzip
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import chip_smoke as cs
from ngsbits_tpu.io.bam import BamReader
from ngsbits_tpu.io.fastq import FastqReader


def test_read_arrays_model():
    rng = np.random.default_rng(0)
    genome = rng.integers(0, 4, 200_000, dtype=np.uint8)
    b1, q1, b2, q2 = cs.read_arrays(rng, genome, 4000, 151, 120, 10)
    assert b1.shape == q1.shape == (4000, 151) and b1.dtype == np.uint8
    assert set(np.unique(q1)) <= {35, 45, 56, 70}           # Q2/12/23/37
    assert 0.0005 < (b1 == ord("N")).mean() < 0.002
    assert (q1[b1 == ord("N")] == 35).all()
    # short inserts: both mates read into their adapters
    hits = sum(cs.ADAPTER1[:12] in bytes(r) for r in b1)
    assert hits > 3000
    # the mates of a pair cover the same fragment on opposite strands
    i = 0
    ins = bytes(b1[i]).find(cs.ADAPTER1[:12])
    rc = cs.COMPLEMENT[b2[i, :ins][::-1]]
    assert (rc == b1[i, :ins]).mean() > 0.95


def test_synth_pairs_reads_back(tmp_path):
    p1, p2 = tmp_path / "a.fastq.gz", tmp_path / "b.fastq.gz"
    with ThreadPoolExecutor(2) as pool:
        cs.synth_pairs(p1, p2, 2500, 3, 300, 50, pool=pool)
    n = 0
    for b1, b2 in zip(FastqReader(str(p1)), FastqReader(str(p2))):
        assert (b1.lengths == 151).all() and (b2.lengths == 151).all()
        n += len(b1)
    assert n == 2500
    first = gzip.open(p1, "rt").readline()
    assert first == "@smoke:000000000 1:N:0:1\n"
    assert gzip.open(p2, "rt").readline() == "@smoke:000000000 2:N:0:1\n"


def test_synth_panel_is_sorted_and_on_target(tmp_path):
    bam, bed, fai = tmp_path / "p.bam", tmp_path / "p.bed", tmp_path / "g.fai"
    cs.synth_panel(bam, bed, fai, 3000, 4, n_regions=200)
    regions = [l.split("\t") for l in bed.read_text().splitlines()]
    assert 190 <= len(regions) <= 200
    assert len(fai.read_text().splitlines()) == len(cs.HG38)
    reader = BamReader(str(bam))
    assert reader.ref_names == list(cs.HG38)
    keys = []
    for batch in reader:
        keys.append(batch.ref_id.astype(np.int64) << 32 | batch.pos)
        assert (batch.l_seq == 150).all()
    reader.close()
    keys = np.concatenate(keys)
    assert len(keys) == 6000 and (np.diff(keys) >= 0).all()


def test_reg2bin_matches_sam_spec():
    def reg2bin(beg, end):  # SAM spec §5.3, scalar
        end -= 1
        for shift, base in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
            if beg >> shift == end >> shift:
                return base + (beg >> shift)
        return 0
    beg = np.array([0, 16383, 16384 - 100, 1 << 20, 5_000_000, 1 << 26])
    end = beg + 150
    assert cs._reg2bin(beg, end).tolist() == [reg2bin(int(b), int(e))
                                              for b, e in zip(beg, end)]


def test_qcml_compare_strips_only_creation_and_binary(tmp_path):
    a, b = tmp_path / "a.qcML", tmp_path / "b.qcML"
    a.write_text('<x name="creation date" v="1"/>\n<binary>AAA</binary>\n<q v="1"/>\n')
    b.write_text('<x name="creation date" v="2"/>\n<binary>BBB</binary>\n<q v="1"/>\n')
    assert cs.same_qcml(a, b) is None
    b.write_text('<x name="creation date" v="2"/>\n<q v="2"/>\n')
    assert "line 1" in cs.same_qcml(a, b)


def test_same_bytes_reports_first_difference(tmp_path):
    a, b = tmp_path / "a", tmp_path / "b"
    a.write_text("x\ty\n1\n")
    b.write_text("x\ty\n1\n")
    assert cs.same_bytes(a, b) is None
    b.write_text("x\ty\n2\n")
    assert cs.same_bytes(a, b).startswith("line 2")
    b.write_text("x\ty\n1\n3\n")
    assert "line counts" in cs.same_bytes(a, b)


@pytest.mark.parametrize("other,same", [(b"ACGT\n" * 1000, True),
                                        (b"ACGA\n" * 1000, False)])
def test_same_gz_text_compares_content_not_container(tmp_path, other, same):
    a, b = tmp_path / "a.gz", tmp_path / "b.gz"
    a.write_bytes(gzip.compress(b"ACGT\n" * 1000, 1))
    b.write_bytes(gzip.compress(other, 9))
    assert (cs.same_gz_text(a, b) is None) is same


def test_smoke_fails_without_the_package(tmp_path):
    import shutil
    import subprocess
    import sys
    shutil.copy(cs.__file__, tmp_path / "chip_smoke.py")
    r = subprocess.run([sys.executable, str(tmp_path / "chip_smoke.py")],
                       capture_output=True, text=True, timeout=60)
    assert r.returncode != 0 and r.stdout == ""
