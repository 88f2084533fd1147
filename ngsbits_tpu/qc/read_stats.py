"""Raw-read QC accumulator (ReadQC engine).

Behavioral reference: ngs-bits ``StatisticsReads`` (cppNGS/StatisticsReads.cpp)
— exact metric semantics including qcML accessions QC:2000005..QC:2000149 and
the single-end/long-read extras (N50 QC:2000131, read-length histogram
QC:2000132, median/mode Q scores QC:2000144-147).

Device/host split: [B, L] batch reductions run on the device
(ops.readqc, DeviceReadStream); on the host path the tiny per-batch tails
(per-read mean rounding, sparse read-length map) and the final report
assembly run on host in float64 for bit-exact parity.
"""

from __future__ import annotations

import math
from collections import Counter

import numpy as np

from ..core.histogram import Histogram
from ..core.plots import BarPlot, LinePlot
from ..core.qcml import QCCollection, QCValue
from ..io.fastq import FastqBatch
from ..ops import readqc as readqc_ops
from ..ops.device_reduce import use_device
from ..utils import trace

FORWARD = 0
REVERSE = 1


class ReadStatistics:
    def __init__(self, single_end: bool = False):
        self.single_end = single_end
        self.c_forward = 0
        self.c_reverse = 0
        self.read_lengths: Counter = Counter()
        self.bases_sequenced = 0
        self.c_read_q20 = 0
        # grown on demand, indexed by cycle
        self.pileups = np.zeros((5, 0), dtype=np.int64)      # A,C,G,T,N x cycle
        self.qualsum1 = np.zeros(0, dtype=np.int64)           # forward, per cycle
        self.qualsum2 = np.zeros(0, dtype=np.int64)           # reverse, per cycle
        self.base_qualities = np.zeros(readqc_ops.QHIST_SIZE, dtype=np.int64)
        self.read_qualities = np.zeros(100, dtype=np.int64)
        self.qscore_dist_r1 = Histogram(0, 60, 1)
        self.qscore_dist_r2 = Histogram(0, 60, 1)

    def _grow(self, cycles: int):
        if cycles > self.pileups.shape[1]:
            extra = cycles - self.pileups.shape[1]
            self.pileups = np.pad(self.pileups, ((0, 0), (0, extra)))
            self.qualsum1 = np.pad(self.qualsum1, (0, extra))
            self.qualsum2 = np.pad(self.qualsum2, (0, extra))

    @staticmethod
    def _bucket(batch: FastqBatch):
        """Pad [B, L] to shape buckets so jit traces a handful of shapes
        instead of one per batch. Padding rows have length 0 and contribute
        nothing to any statistic."""
        B, L = batch.bases.shape
        if L <= 512:
            Lb = max(64, -(-L // 64) * 64)
        else:  # long reads: power-of-two buckets to bound recompiles
            Lb = 1 << int(L - 1).bit_length()
        Bb = max(1024, 1 << (int(B - 1).bit_length())) if B else 1024
        bases = np.zeros((Bb, Lb), dtype=np.uint8)
        quals = np.zeros((Bb, Lb), dtype=np.uint8)
        bases[:B, :L] = batch.bases
        quals[:B, :L] = batch.quals
        lengths = np.zeros(Bb, dtype=np.int32)
        lengths[:B] = batch.lengths
        return bases, quals, lengths

    def _device_stream(self) -> "DeviceReadStream":
        if getattr(self, "_stream", None) is None:
            # single_end is how ReadQC routes -long_read (quality range up
            # to Q93 — beyond 6-bit packing)
            self._stream = DeviceReadStream(qual_bits=8 if self.single_end else 6)
        return self._stream

    def merge(self, other: "ReadStatistics"):
        """Fold another accumulator into this one (every statistic is
        additive — the parallel-consumer pattern: per-worker accumulators,
        merge after join; no shared mutable state during the run)."""
        if getattr(other, "_stream", None) is not None:
            # the other accumulator streamed on device: land its carries in
            # its host fields first, then merge those
            other._stream.fold_into(other)
            other._stream = None
        self.c_forward += other.c_forward
        self.c_reverse += other.c_reverse
        self.read_lengths.update(other.read_lengths)
        self.bases_sequenced += other.bases_sequenced
        self.c_read_q20 += other.c_read_q20
        self._grow(other.pileups.shape[1])
        L = other.pileups.shape[1]
        self.pileups[:, :L] += other.pileups
        self.qualsum1[:L] += other.qualsum1
        self.qualsum2[:L] += other.qualsum2
        self.base_qualities += other.base_qualities
        self.read_qualities += other.read_qualities
        for mine, theirs in ((self.qscore_dist_r1, other.qscore_dist_r1),
                             (self.qscore_dist_r2, other.qscore_dist_r2)):
            mine._bins += theirs._bins
            mine._count += theirs._count

    def update_batch(self, batch: FastqBatch, direction: int):
        if len(batch) == 0:
            return
        B = len(batch)
        import os as _os
        use_mesh = _os.environ.get("NGSBITS_MESH", "") not in ("", "0")
        if use_mesh:
            import jax
        if use_mesh and jax.device_count() > 1:
            # data-parallel reduction over all devices (psum merges); the
            # padded bucket is divisible by the device count by construction
            # (both are powers of two)
            from ..parallel.mesh import make_mesh, sharded_readqc_step
            pb, pq, pl = self._bucket(batch)
            counts5, qsum_cycle, qhist, read_qsum = jax.device_get(
                sharded_readqc_step(make_mesh(), pb, pq, pl))
            read_qsum = read_qsum[:B]
        elif use_device():
            # device-resident streaming engine: packed upload (~9 bits/base),
            # accumulators stay on device, results fetched once at EOF
            self._device_stream().update(batch, direction)
            return
        else:
            # host fast path: no padding/bucketing, bincount histogram
            counts5, qsum_cycle, qhist, read_qsum = readqc_ops.readqc_batch_host(
                np.ascontiguousarray(batch.bases),
                np.ascontiguousarray(batch.quals),
                np.asarray(batch.lengths, dtype=np.int32))
        true_l = int(batch.lengths.max()) if B else 0
        counts5 = counts5[:, :true_l]
        qsum_cycle = qsum_cycle[:true_l]
        lengths = np.asarray(batch.lengths, dtype=np.int64)

        if direction == FORWARD:
            self.c_forward += len(batch)
        else:
            self.c_reverse += len(batch)

        self.bases_sequenced += int(lengths.sum())
        self.read_lengths.update(lengths.tolist())

        L = counts5.shape[1]
        self._grow(L)
        self.pileups[:, :L] += counts5.astype(np.int64)
        if direction == FORWARD:
            self.qualsum1[:L] += qsum_cycle.astype(np.int64)
        else:
            self.qualsum2[:L] += qsum_cycle.astype(np.int64)
        self.base_qualities += qhist.astype(np.int64)

        # per-read mean quality (float64 host tail, exact like the reference)
        with np.errstate(divide="ignore", invalid="ignore"):
            mean_q = read_qsum.astype(np.float64) / lengths
        valid = np.isfinite(mean_q)
        mq = mean_q[valid]
        self.c_read_q20 += int((mq >= 20.0).sum())
        rounded = np.where(mq >= 0, np.floor(mq + 0.5), np.ceil(mq - 0.5)).astype(np.int64)
        np.add.at(self.read_qualities, rounded, 1)
        hist = self.qscore_dist_r1 if direction == FORWARD else self.qscore_dist_r2
        hist.inc_array(mq, ignore_bounds=True)

    def get_result(self) -> QCCollection:
        if getattr(self, "_stream", None) is not None:
            self._stream.fold_into(self)
            self._stream = None
        out = QCCollection()
        total_reads = self.c_forward + self.c_reverse
        c_base_n = int(self.pileups[4].sum())
        c_base_gc = int(self.pileups[1].sum() + self.pileups[2].sum())
        bases_total = int(self.pileups.sum())

        out.insert(QCValue.from_int(
            "read count", total_reads,
            "Total number of reads (forward and reverse reads of paired-end sequencing count as two reads).",
            "QC:2000005"))
        keys = sorted(self.read_lengths.keys())
        longest_read = keys[-1] if keys else 0
        is_longread = self.single_end and longest_read >= 10000
        if len(keys) < 4:
            lengths_str = ", ".join(str(k) for k in keys)
        else:
            lengths_str = f"{keys[0]}-{longest_read}"
        out.insert(QCValue.from_string(
            "read length", lengths_str,
            "Raw read length of a single read before trimming. Comma-separated list of lenghs or length range, if reads have different lengths.",
            "QC:2000006"))
        out.insert(QCValue.from_double(
            "bases sequenced (MB)", self.bases_sequenced / 1000000.0,
            "Bases sequenced in total (in megabases).", "QC:2000049"))
        out.insert(QCValue.from_double(
            "Q20 read percentage", 100.0 * self.c_read_q20 / total_reads,
            "The percentage of reads with a mean base quality score greater than Q20.",
            "QC:2000007"))
        c_base_q20 = int(self.base_qualities[20:].sum())
        c_base_q30 = int(self.base_qualities[30:].sum())
        out.insert(QCValue.from_double(
            "Q20 base percentage", 100.0 * c_base_q20 / bases_total,
            "The percentage of bases with a minimum quality score of Q20.", "QC:2000148"))
        out.insert(QCValue.from_double(
            "Q30 base percentage", 100.0 * c_base_q30 / bases_total,
            "The percentage of bases with a minimum quality score of Q30.", "QC:2000008"))
        out.insert(QCValue.from_double(
            "no base call percentage", 100.0 * c_base_n / bases_total,
            "The percentage of bases without base call (N).", "QC:2000009"))
        out.insert(QCValue.from_double(
            "gc content percentage", 100.0 * c_base_gc / (bases_total - c_base_n),
            "The percentage of bases that are called to be G or C.", "QC:2000010"))

        if self.single_end:
            bases = 0
            n50 = 0
            for k in sorted(self.read_lengths.keys(), reverse=True):
                bases += k * self.read_lengths[k]
                if bases > self.bases_sequenced // 2:
                    n50 = k
                    break
            out.insert(QCValue.from_int(
                "N50 read length (bp)", n50,
                "Minimum read length to reach 50% of sequenced bases.", "QC:2000131"))

        n95 = -1
        if is_longread:
            bases = 0
            for k in sorted(self.read_lengths.keys()):
                bases += k * self.read_lengths[k]
                if bases > 0.95 * self.bases_sequenced:
                    n95 = k
                    break
            if longest_read <= 100000:
                n95 = int(math.ceil(n95 / 1000.0) * 1000)
            else:
                n95 = int(math.ceil(n95 / 10000.0) * 10000)

        cycles = longest_read
        if is_longread:
            cycles = min(n95, cycles)

        # base distribution plot
        with np.errstate(divide="ignore", invalid="ignore"):
            p = self.pileups[:, :cycles].astype(np.float64)
            depth_no_n = p[:4].sum(axis=0)
            line = {c: 100.0 * p[i] / depth_no_n for i, c in enumerate("ACGT")}
            line["N"] = 100.0 * p[4] / (depth_no_n + p[4])
            line["GC"] = line["G"] + line["C"]
        line_x = np.arange(1, cycles + 1, dtype=np.float64)
        plot = LinePlot()
        plot.set_xlabel("cycle")
        plot.set_ylabel("base [%]")
        plot.set_yrange(0.0, 100.0)
        plot.set_xvalues(line_x)
        for c in ["A", "C", "G", "T", "N", "GC"]:
            plot.add_line(line[c], c)
        out.insert(QCValue.image_from_base64(
            "base distribution plot", plot.to_base64(),
            "Base distribution plot per cycle.", "QC:2000011"))

        # mean Q score per cycle plot
        depth_cycle = self.pileups.sum(axis=0)[:cycles].astype(np.float64)
        if self.c_reverse > 0:
            depth_cycle = np.floor_divide(depth_cycle.astype(np.int64), 2).astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            q1 = self.qualsum1[:cycles] / depth_cycle
            q2 = self.qualsum2[:cycles] / depth_cycle
        plot2 = LinePlot()
        plot2.set_xlabel("cycle")
        plot2.set_ylabel("mean Q score")
        plot2.set_yrange(0.0, 41.5)
        plot2.set_xvalues(line_x)
        plot2.add_line(q1, "forward reads")
        if self.c_reverse > 0:
            plot2.add_line(q2, "reverse reads")
        out.insert(QCValue.image_from_base64(
            "Q score plot", plot2.to_base64(),
            "Mean Q score per cycle for forward/reverse reads.", "QC:2000012"))

        # read Q score distribution plot
        plot2b = LinePlot()
        plot2b.set_xlabel("read Q score")
        plot2b.set_ylabel("reads [%]")
        plot2b.set_yrange(0, 100)
        plot2b.set_xvalues(self.qscore_dist_r1.x_coords())
        plot2b.add_line(self.qscore_dist_r1.y_coords(True), "forward reads")
        if self.c_reverse > 0:
            plot2b.add_line(self.qscore_dist_r2.y_coords(True), "reverse reads")
        out.insert(QCValue.image_from_base64(
            "read Q score distribution", plot2b.to_base64(),
            "Distrubition of the mean forward/reverse Q score for each read.", "QC:2000138"))

        if self.single_end:
            first_key = keys[0] if keys else 0
            hist_min = max(0, first_key - 20)
            hist_max = (n95 if is_longread else longest_read) + 20
            read_length_hist = Histogram(hist_min, hist_max, (hist_max - hist_min) / 60)
            for k in sorted(self.read_lengths.keys()):
                read_length_hist.inc_array(
                    np.full(self.read_lengths[k], k, dtype=np.float64), ignore_bounds=True)

            plot3 = BarPlot()
            plot3.set_xlabel("read length (bp)")
            plot3.set_ylabel("reads [%]")
            plot3.set_yrange(0, read_length_hist.max_value(True) + 1)
            plot3.set_xrange(-2, read_length_hist.bin_count() + 2)
            bins = []
            for x in read_length_hist.x_coords():
                bins.append(str(int(x)) if int(x) % 10 == 0 else "")
            plot3.set_values(read_length_hist.y_coords(True), bins)
            out.insert(QCValue.image_from_base64(
                "Read length histogram", plot3.to_base64(),
                "Histogram of read lengths", "QC:2000132"))

            # median/mode base Q score (mode ignores the peak at 50)
            values = []
            labels = []
            max_count = 0
            mode_base_q = 0
            median_base_q = -1
            bases_checked = 0
            for i in range(61):
                labels.append(str(i))
                base_count = int(self.base_qualities[i])
                values.append(100.0 * base_count / self.bases_sequenced)
                if base_count >= max_count:
                    max_count = base_count
                    if i < 50:
                        mode_base_q = i
                bases_checked += base_count
                if median_base_q == -1 and bases_checked * 2 >= self.bases_sequenced:
                    median_base_q = i
            plot4 = BarPlot()
            plot4.set_xlabel("Q score")
            plot4.set_ylabel("bases [%]")
            plot4.set_yrange(0, 100)
            plot4.set_xrange(0, 60)
            plot4.set_values(values, labels)
            out.insert(QCValue.image_from_base64(
                "base Q score histogram", plot4.to_base64(),
                "Histogram of base Q scores.", "QC:2000143"))
            out.insert(QCValue.from_int(
                "median base Q score", median_base_q,
                "Median Q score of all bases of the sample.", "QC:2000144"))
            out.insert(QCValue.from_int(
                "mode base Q score", mode_base_q,
                "Most frequent Q score of all bases of the sample.", "QC:2000145"))

            # median/mode read Q score
            max_count = 0
            mode_read_q = 0
            median_read_q = -1
            reads_checked = 0
            for i in range(len(self.read_qualities)):
                read_count = int(self.read_qualities[i])
                if read_count >= max_count:
                    max_count = read_count
                    mode_read_q = i
                reads_checked += read_count
                if median_read_q == -1 and reads_checked * 2 >= self.c_forward:
                    median_read_q = i
            out.insert(QCValue.from_int(
                "median read Q score", median_read_q,
                "Median Q score of all reads of the sample.", "QC:2000146"))
            out.insert(QCValue.from_int(
                "mode read Q score", mode_read_q,
                "Most frequent Q score of all reads of the sample.", "QC:2000147"))

        return out


def bam_batch_to_fastq_batch(batch, sel: np.ndarray):
    """Convert selected BAM records to a FastqBatch-shaped container for the
    raw-read QC engine (StatisticsReads::update(BamAlignment) semantics:
    bases as stored, raw qualities)."""
    from ..io.bam import SEQ_NIBBLE_ASCII
    from ..io.fastq import FastqBatch, _pad_2d
    idx = np.flatnonzero(sel)
    lengths = batch.l_seq[idx].astype(np.int32)
    n = len(idx)
    lmax = int(lengths.max()) if n else 0
    bases = np.zeros((n, lmax), dtype=np.uint8)
    quals = np.zeros((n, lmax), dtype=np.uint8)
    for k, i in enumerate(idx):
        s = batch.seq_off[i]
        e = batch.seq_off[i + 1]
        li = e - s
        bases[k, :li] = SEQ_NIBBLE_ASCII[batch.seq[s:e]]
        quals[k, :li] = batch.qual[s:e] + 33
    return FastqBatch(bases=bases, quals=quals, lengths=lengths)


def update_from_bam(stats: "ReadStatistics", bam_file: str, single_end: bool):
    """Stream a BAM through the raw-read QC engine
    (StatisticsReads::update(BamAlignment), StatisticsReads.cpp:83-158)."""
    from ..io.bam import BamReader, FLAG_READ1, FLAG_SECONDARY, FLAG_SUPPLEMENTARY
    reader = BamReader(bam_file)
    for batch in reader:
        primary = (batch.flag & (FLAG_SECONDARY | FLAG_SUPPLEMENTARY)) == 0
        if single_end:
            stats.update_batch(bam_batch_to_fastq_batch(batch, primary), FORWARD)
        else:
            fwd = primary & ((batch.flag & FLAG_READ1) != 0)
            rev = primary & ~((batch.flag & FLAG_READ1) != 0)
            if fwd.any():
                stats.update_batch(bam_batch_to_fastq_batch(batch, fwd), FORWARD)
            if rev.any():
                stats.update_batch(bam_batch_to_fastq_batch(batch, rev), REVERSE)
    reader.close()


class DeviceReadStream:
    """Device-resident ReadQC accumulation (StatisticsReads.cpp:26-81).

    Per batch, only the PACKED read tensor travels to the device (2-bit base
    codes + 1-bit N mask + 6-bit quals = ~9 bits/base, ngs_pack_batch) and
    NOTHING travels back: every statistic — including the per-read tail
    (mean-quality histograms, Q20 count) — accumulates in on-device int32
    carries (ops/readqc.py stream_step). Results are fetched once at EOF
    (fold_into); a spill every SPILL_READS reads or SPILL_BASES bases folds
    the carries into 64-bit host accumulators before any int32 bin can
    overflow (per-cycle bins grow with reads, the base count and the
    base-quality histogram with bases)."""

    SPILL_READS = 8_000_000
    SPILL_BASES = 1 << 30

    def __init__(self, qual_bits: int = 6):
        self.carry = None
        self.reads_since_spill = 0
        self.bases_since_spill = 0
        self.spill: dict | None = None
        self.qual_bits = qual_bits  # 8 for long-read quality range

    def update(self, batch: FastqBatch, direction: int):
        from ..ops.readqc import (pack_batch, stream_carry_grow,
                                  stream_carry_init, stream_step)
        pb_full, pq_full, pl = ReadStatistics._bucket(batch)
        Lb = pb_full.shape[1]
        packed_b, nmask, packed_q = pack_batch(pb_full, pq_full, self.qual_bits)
        if self.carry is None:
            self.carry = stream_carry_init(Lb)
        else:
            self.carry = stream_carry_grow(self.carry, Lb)
        carry_l = self.carry["counts5"].shape[1]
        if carry_l != Lb:
            # batch bucket shorter than the carry: pad the packed arrays up
            # (both are multiples of 64, so the packed widths divide evenly)
            pad = carry_l - Lb
            packed_b = np.pad(packed_b, ((0, 0), (0, pad // 4)))
            nmask = np.pad(nmask, ((0, 0), (0, pad // 8)))
            packed_q = np.pad(packed_q, ((0, 0), (0, pad if self.qual_bits == 8
                                                  else pad // 4 * 3)))
        self.carry = stream_step()(self.carry, packed_b, nmask, packed_q,
                                   pl, np.int32(len(batch)),
                                   0 if direction == FORWARD else 1,
                                   self.qual_bits)
        trace.count("device.readqc_batches")
        self.reads_since_spill += len(batch)
        self.bases_since_spill += int(pl.sum())
        if (self.reads_since_spill >= self.SPILL_READS
                or self.bases_since_spill >= self.SPILL_BASES):
            trace.count("device.readqc_spills")
            self._spill()

    def _spill(self):
        import jax
        if self.carry is None:
            return
        host = jax.device_get(self.carry)
        L = host["counts5"].shape[1]
        if self.spill is None:
            self.spill = {k: np.asarray(v, dtype=np.int64) for k, v in host.items()}
        else:
            oldL = self.spill["counts5"].shape[1]
            if L > oldL:
                self.spill["counts5"] = np.pad(self.spill["counts5"],
                                               ((0, 0), (0, L - oldL)))
                for k in ("qsum1", "qsum2", "len_hist"):
                    self.spill[k] = np.pad(self.spill[k], (0, L - oldL))
            for k, v in host.items():
                self.spill[k] = self.spill[k] + np.asarray(v, dtype=np.int64)
        from ..ops.readqc import stream_carry_init
        self.carry = stream_carry_init(L)
        self.reads_since_spill = 0
        self.bases_since_spill = 0

    def fold_into(self, stats: "ReadStatistics"):
        self._spill()
        s = self.spill
        if s is None:
            return
        L = s["counts5"].shape[1]
        # trim trailing cycles no read reached (bucket padding)
        lens_present = np.flatnonzero(s["len_hist"])
        true_l = int(lens_present[-1]) + 1 if len(lens_present) else 0
        stats._grow(true_l)
        stats.pileups[:, :true_l] += s["counts5"][:, :true_l]
        stats.qualsum1[:true_l] += s["qsum1"][:true_l]
        stats.qualsum2[:true_l] += s["qsum2"][:true_l]
        stats.base_qualities += s["qhist"]
        stats.read_qualities += s["read_q_hist"]
        stats.c_read_q20 += int(s["q20"])
        stats.qscore_dist_r1.add_counts(s["qdist1"])
        stats.qscore_dist_r2.add_counts(s["qdist2"])
        for i in range(len(s["len_hist"])):  # bin i = reads of length i
            if s["len_hist"][i]:
                stats.read_lengths[i] += int(s["len_hist"][i])
        stats.c_forward += int(s["n_fwd"])
        stats.c_reverse += int(s["n_rev"])
        stats.bases_sequenced += int(s["bases"])
        self.spill = None
