"""ops/device_reduce correctness on the CPU backend (the -m gpu lane pins
the same engines on the card; these cover the edge cases cheaply)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from ngsbits_tpu.ops.device_reduce import (DeviceBincount, DeviceCoverage,
                                           pearson_from_genotypes)


def test_device_coverage_matches_diff_array():
    rng = np.random.default_rng(0)
    span = 5000
    starts = rng.integers(0, span - 100, size=777).astype(np.int32)
    ends = (starts + rng.integers(1, 100, size=777)).astype(np.int32)
    diff = np.zeros(span + 2, np.int64)
    np.add.at(diff, starts, 1)
    np.add.at(diff, ends, -1)
    expected = np.cumsum(diff[:span])
    dc = DeviceCoverage(span)
    for i in range(0, 777, 100):  # multiple odd-sized batches (padding path)
        dc.add(starts[i:i + 100], ends[i:i + 100])
    got = dc.finalize()
    np.testing.assert_array_equal(expected, got)


def test_device_coverage_empty_and_eval_positions():
    dc = DeviceCoverage(100)
    np.testing.assert_array_equal(dc.finalize(), np.zeros(100, np.int64))
    dc = DeviceCoverage(1000)
    dc.add(np.array([10], np.int32), np.array([20], np.int32))
    # a span may end at the span's end (end_excl == span)
    dc.add(np.array([990], np.int32), np.array([1000], np.int32))
    cov = dc.finalize()
    pos = np.array([9, 10, 19, 20, 500, 989, 990, 999])
    np.testing.assert_array_equal(cov[pos], [0, 1, 1, 0, 0, 0, 1, 1])
    assert cov.dtype == np.int64 and len(cov) == 1000


def test_device_bincount_matches_numpy():
    rng = np.random.default_rng(1)
    size = 4096
    idx = rng.integers(0, size, size=10_000).astype(np.int32)
    db = DeviceBincount(size)
    for i in range(0, len(idx), 999):
        db.add(idx[i:i + 999])
    np.testing.assert_array_equal(
        db.finalize(), np.bincount(idx, minlength=size).astype(np.int64))
    assert DeviceBincount(16).finalize().sum() == 0


def test_pearson_matches_host_correlation_small_and_large():
    from ngsbits_tpu.core.basicstats import correlation
    rng = np.random.default_rng(2)
    g1 = rng.choice([0.0, 0.5, 1.0], size=5000)
    g2 = np.where(rng.random(5000) < 0.7, g1,
                  rng.choice([0.0, 0.5, 1.0], size=5000))
    assert abs(pearson_from_genotypes(g1, g2) - correlation(list(g1), list(g2))) < 1e-9
    # constant vector -> nan (host correlation divides by zero the same way)
    c = np.full(100, 0.5)
    assert np.isnan(pearson_from_genotypes(c, c))


def test_pearson_overflow_guard_uses_host_moments(monkeypatch):
    """4n >= 2^31 must route through the exact int64 host moments."""
    import ngsbits_tpu.ops.device_reduce as dr

    def boom(*a, **k):
        raise AssertionError("device moments must not run for huge n")

    monkeypatch.setattr(dr, "_corr_fn", boom)
    monkeypatch.setattr(dr, "INT32_MOMENT_LIMIT", 4 * 1000)
    x = np.zeros(1000)
    x[::2] = 1.0
    y = x.copy()
    assert abs(dr.pearson_from_genotypes(x, y) - 1.0) < 1e-12


# ---- device-resident streaming ReadQC engine --------------------------------

def _random_fastq_batches(rng, n_batches, long_read=False):
    from ngsbits_tpu.io.fastq import FastqBatch
    batches = []
    for _ in range(n_batches):
        B = int(rng.integers(50, 300))
        L = int(rng.integers(20, 180))
        bases = rng.choice(np.frombuffer(b"ACGTN", dtype=np.uint8),
                           p=[0.24, 0.24, 0.24, 0.24, 0.04], size=(B, L))
        qmax = 126 if long_read else 74
        quals = rng.integers(33, qmax + 1, size=(B, L)).astype(np.uint8)
        lengths = rng.integers(0, L + 1, size=B).astype(np.int32)
        pos = np.arange(L)[None, :]
        mask = pos < lengths[:, None]
        bases = np.where(mask, bases, 0).astype(np.uint8)
        quals = np.where(mask, quals, 0).astype(np.uint8)
        batches.append(FastqBatch(bases=bases, quals=quals, lengths=lengths))
    return batches


@pytest.mark.parametrize("long_read", [False, True])
def test_device_stream_readqc_parity(long_read):
    """DeviceReadStream (packed upload + on-device accumulators, single
    fetch) reproduces the host ReadStatistics path metric-for-metric,
    including a mid-run spill and both directions."""
    from ngsbits_tpu.qc.read_stats import (FORWARD, REVERSE, DeviceReadStream,
                                           ReadStatistics)

    rng = np.random.default_rng(7)
    batches = _random_fastq_batches(rng, 6, long_read=long_read)

    host = ReadStatistics(single_end=long_read)
    for i, b in enumerate(batches):
        host.update_batch(b, FORWARD if i % 2 == 0 else REVERSE)

    dev = ReadStatistics(single_end=long_read)
    stream = DeviceReadStream(qual_bits=8 if long_read else 6)
    stream.SPILL_READS = 500  # force several spills
    dev._stream = stream
    for i, b in enumerate(batches):
        stream.update(b, FORWARD if i % 2 == 0 else REVERSE)

    got = [str(v) for v in dev.get_result().to_string_list()]
    want = [str(v) for v in host.get_result().to_string_list()]
    assert got == want


def test_device_stream_spills_by_bases():
    """The base count bounds the int32 carries too: long reads spill on
    SPILL_BASES long before SPILL_READS reads."""
    from ngsbits_tpu.qc.read_stats import (FORWARD, DeviceReadStream,
                                           ReadStatistics)
    from ngsbits_tpu.utils import trace

    rng = np.random.default_rng(8)
    batches = _random_fastq_batches(rng, 4, long_read=True)
    host = ReadStatistics(single_end=True)
    dev = ReadStatistics(single_end=True)
    stream = DeviceReadStream(qual_bits=8)
    stream.SPILL_BASES = int(batches[0].lengths.sum()) + 1
    dev._stream = stream
    trace.reset_counters()
    for b in batches:
        host.update_batch(b, FORWARD)
        stream.update(b, FORWARD)
    assert trace.counters()["device.readqc_spills"] == 2
    got = [str(v) for v in dev.get_result().to_string_list()]
    want = [str(v) for v in host.get_result().to_string_list()]
    assert got == want
