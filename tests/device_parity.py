"""Device-route vs host-route parity checks on seeded inputs.

Shared by the CPU suite (tests/test_device_routes.py, which forces the
device formulations onto the CPU backend with NGSBITS_DEVICE_ENGINES=1)
and the GPU lane (tests/test_gpu_lane.py, where the device routes engage
on their own). Every check runs a tool or engine once on the device route
and once with NGSBITS_DEVICE_ENGINES=0, compares the outputs exactly, and
asserts that the device route's trace counter moved.
"""

from __future__ import annotations

import gzip
from concurrent.futures import ThreadPoolExecutor

import numpy as np

import chip_smoke
from helpers import execute
from ngsbits_tpu.utils import trace


def make_inputs(root):
    """Small seeded samples from chip_smoke's generators."""
    with ThreadPoolExecutor(4) as pool:
        chip_smoke.synth_pairs(root / "rq1.fastq.gz", root / "rq2.fastq.gz",
                               3000, 1, 350, 80, pool=pool)
        chip_smoke.synth_pairs(root / "sp1.fastq.gz", root / "sp2.fastq.gz",
                               2000, 2, 150, 50, pool=pool)
        chip_smoke.synth_panel(root / "panel.bam", root / "panel.bed",
                               root / "genome.fa.fai", 4000, 3,
                               n_regions=300, pool=pool)
    (root / "genome.fa").write_bytes(b"")
    return root


def _both_routes(monkeypatch, device_env: dict, run) -> tuple:
    """run(side) on the device route, then on the host route; returns
    (device result, host result, device-route counters)."""
    for k, v in device_env.items():
        monkeypatch.setenv(k, v)
    trace.reset_counters()
    dev = run("dev")
    counters = trace.counters()
    monkeypatch.setenv("NGSBITS_DEVICE_ENGINES", "0")
    trace.reset_counters()
    host = run("host")
    assert not any(k.startswith("device.") for k in trace.counters())
    return dev, host, counters


def check_readqc(inputs, tmp_path, monkeypatch, device_env):
    def run(side):
        out = tmp_path / f"{side}.qcML"
        assert execute("ReadQC", ["-in1", inputs / "rq1.fastq.gz",
                                  "-in2", inputs / "rq2.fastq.gz",
                                  "-out", out]) == 0
        return chip_smoke.qcml_lines(out)
    dev, host, c = _both_routes(monkeypatch, device_env, run)
    assert c.get("device.readqc_batches", 0) >= 2
    assert dev == host


def check_seqpurge(inputs, tmp_path, monkeypatch, device_env):
    """The device scans (numpy decisions) against the native C++ route."""
    def run(side):
        if side == "dev":
            monkeypatch.setenv("NGSBITS_SEQPURGE_NO_NATIVE", "1")
        else:
            monkeypatch.delenv("NGSBITS_SEQPURGE_NO_NATIVE", raising=False)
        outs = [tmp_path / f"{side}{i}.fastq.gz" for i in (1, 2)]
        qc = tmp_path / f"{side}.qcML"
        assert execute("SeqPurge", [
            "-in1", inputs / "sp1.fastq.gz", "-in2", inputs / "sp2.fastq.gz",
            "-out1", outs[0], "-out2", outs[1], "-qc", qc,
            "-summary", tmp_path / f"{side}.txt"]) == 0
        return ([gzip.decompress(p.read_bytes()) for p in outs],
                chip_smoke.qcml_lines(qc))
    dev, host, c = _both_routes(monkeypatch, device_env, run)
    assert c.get("device.insert_scan", 0) >= 1
    assert c.get("device.adapter_evidence", 0) >= 1
    assert dev == host


def check_coverage_tool(inputs, tmp_path, monkeypatch, device_env, tool, extra):
    def run(side):
        out = tmp_path / f"{side}.bed"
        assert execute(tool, ["-in", inputs / "panel.bed",
                              "-bam", inputs / "panel.bam", "-out", out]
                       + extra) == 0
        return out.read_bytes()
    dev, host, c = _both_routes(monkeypatch, device_env, run)
    assert c.get("device.coverage", 0) >= 1
    assert dev == host


def check_mappingqc(inputs, tmp_path, monkeypatch, device_env):
    def run(side):
        out = tmp_path / f"{side}.qcML"
        assert execute("MappingQC", ["-in", inputs / "panel.bam",
                                     "-roi", inputs / "panel.bed", "-no_cont",
                                     "-ref", inputs / "genome.fa",
                                     "-out", out]) == 0
        return chip_smoke.qcml_lines(out)
    dev, host, c = _both_routes(monkeypatch, device_env, run)
    assert c.get("device.coverage", 0) >= 1
    assert dev == host


def check_pileup(inputs, monkeypatch, device_env):
    from ngsbits_tpu.core.chromosome import Chromosome
    from ngsbits_tpu.qc.pileup import pileup_at_positions
    bed = [l.split("\t") for l in (inputs / "panel.bed").read_text().splitlines()]
    # every 7th base of every panel region
    chr_nums = np.concatenate([np.full(len(range(int(s), int(e), 7)),
                                       Chromosome(c).num) for c, s, e in bed])
    pos = np.concatenate([np.arange(int(s) + 1, int(e) + 1, 7) for _, s, e in bed])

    def run(side):
        r = pileup_at_positions(str(inputs / "panel.bam"), chr_nums, pos)
        return r.counts, r.dels
    dev, host, c = _both_routes(monkeypatch, device_env, run)
    assert c.get("device.bincount", 0) == 1
    assert dev[0].sum() > 0
    np.testing.assert_array_equal(dev[0], host[0])
    np.testing.assert_array_equal(dev[1], host[1])


def check_read_stream_spill(monkeypatch):
    """DeviceReadStream with a spill mid-run against the host accumulator
    (NGSBITS_DEVICE_ENGINES=0), on every metric of the report."""
    from ngsbits_tpu.io.fastq import FastqBatch
    from ngsbits_tpu.qc.read_stats import (FORWARD, REVERSE, DeviceReadStream,
                                           ReadStatistics)
    rng = np.random.default_rng(11)
    genome = rng.integers(0, 4, 100_000, dtype=np.uint8)
    host = ReadStatistics()
    dev = ReadStatistics()
    stream = DeviceReadStream()
    stream.SPILL_READS = 3000
    dev._stream = stream
    monkeypatch.setenv("NGSBITS_DEVICE_ENGINES", "0")
    trace.reset_counters()
    for i in range(4):
        b, q, _, _ = chip_smoke.read_arrays(rng, genome, 2000, 151, 300, 80)
        lengths = rng.integers(1, 152, 2000).astype(np.int32)
        mask = np.arange(151)[None, :] < lengths[:, None]
        batch = FastqBatch(bases=np.where(mask, b, 0).astype(np.uint8),
                           quals=np.where(mask, q, 0).astype(np.uint8),
                           lengths=lengths)
        direction = FORWARD if i % 2 == 0 else REVERSE
        host.update_batch(batch, direction)
        stream.update(batch, direction)
    assert trace.counters()["device.readqc_spills"] == 2  # after 4k, 8k reads
    got = [str(v) for v in dev.get_result().to_string_list()]
    want = [str(v) for v in host.get_result().to_string_list()]
    assert got == want


def insert_scan_inputs(L: int, kind: str, B: int = 256):
    """(seq1, seq2rc, min_len) pairs of read length L: 'overlap' pairs are
    two mates of short inserts, 'n_rich' carry 20% N."""
    rng = np.random.default_rng(L + len(kind))
    genome = rng.integers(0, 4, 50_000, dtype=np.uint8)
    b1, _, b2, _ = chip_smoke.read_arrays(rng, genome, B, L, 120, 40)
    if kind == "n_rich":
        b1[rng.random(b1.shape) < 0.2] = ord("N")
        b2[rng.random(b2.shape) < 0.2] = ord("N")
    len1 = rng.integers(L // 2, L + 1, B).astype(np.int32)
    len2 = rng.integers(L // 2, L + 1, B).astype(np.int32)
    seq1 = np.where(np.arange(L)[None, :] < len1[:, None], b1, 0).astype(np.uint8)
    pos = np.arange(L)[None, :]
    idx2 = len2[:, None] - 1 - pos
    seq2rc = np.where(idx2 >= 0, chip_smoke.COMPLEMENT[
        b2[np.arange(B)[:, None], np.maximum(idx2, 0)]], 0).astype(np.uint8)
    return seq1, seq2rc, np.minimum(len1, len2)


def check_insert_scan(L: int, kind: str):
    import jax

    from ngsbits_tpu.ops.seqpurge import insert_scan, insert_scan_host
    seq1, seq2rc, min_len = insert_scan_inputs(L, kind)
    want = insert_scan_host(seq1, seq2rc, min_len)
    got = jax.device_get(insert_scan(seq1, seq2rc, min_len))
    assert want[0].sum() > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
