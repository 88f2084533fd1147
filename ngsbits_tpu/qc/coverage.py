"""Coverage engines: BedCoverage / BedLowCoverage / BedHighCoverage /
BedReadCount.

Behavioral reference: ngs-bits Statistics::lowOrHighCoverage/avgCoverage
(cppNGS/Statistics.cpp:2534-2804) + WorkerLowOrHighCoverage.cpp /
WorkerAverageCoverage.cpp:
  * read filters: duplicate/secondary/supplementary/unmapped skipped,
    mapq >= min_mapq; avgCoverage optionally skips not-proper-paired mapq<20
  * coverage span = alignment start..end on the reference (CIGAR
    ref-consuming span) — deletions/ref-skips count as covered
  * min_baseq > 0: M-op bases with qual < min_baseq are excluded; D/N
    positions always count (BamReader.cpp:210-258 ``qualities`` mapping)
  * low/high output: threshold runs per ROI region, annotations preserved,
    final merge(true, true, true)

Batched design: the per-alignment loops become one sequential batched pass
over the BAM; per-chromosome coverage is a diff-array scatter-add + prefix
sum on the host, or the device coverage engine (ops/device_reduce) or the
sharded mesh step (parallel/mesh); region stats are prefix-sum differences
— no per-base Python anywhere.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from ..core.chromosome import Chromosome
from ..core.intervals import BedFile, BedLine
from ..io.bam import (BamBatch, BamReader, CIGAR_CONSUMES_REF, FLAG_DUPLICATE,
                      FLAG_PROPER_PAIR, FLAG_SECONDARY, FLAG_SUPPLEMENTARY,
                      FLAG_UNMAPPED)


def _alignment_filter(batch: BamBatch, min_mapq: int, skip_mismapped: bool = False) -> np.ndarray:
    flag = batch.flag
    sel = (flag & (FLAG_DUPLICATE | FLAG_SECONDARY | FLAG_SUPPLEMENTARY | FLAG_UNMAPPED)) == 0
    sel &= batch.mapq >= min_mapq
    if skip_mismapped:
        sel &= ~(((flag & FLAG_PROPER_PAIR) == 0) & (batch.mapq < 20))
    return sel


class _ChrCoverage:
    """Diff-array coverage accumulator over one chromosome's ROI bounding box."""

    def __init__(self, lo: int, hi: int):
        # lo/hi are 1-based inclusive bounds of the ROI on this chromosome
        self.lo = lo
        self.hi = hi
        self.diff = None    # host diff array, allocated on first host use
        self.counts = None  # per-base path (min_baseq) fills this lazily
        self._cov = None
        self._ps = None
        self._dev = None    # device coverage engine (device route)
        # mesh mode: spans wait for the sharded scatter-add + psum step in
        # finalize (parallel/mesh.py sharded_coverage_step)
        self._mesh_spans = None
        import os as _os
        if _os.environ.get("NGSBITS_MESH", "") not in ("", "0"):
            self._mesh_spans = []
        else:
            from ..ops import device_reduce as dr
            if dr.use_device():
                self._dev = dr.DeviceCoverage(hi - lo + 1)

    def add_spans(self, starts: np.ndarray, ends: np.ndarray):
        """Add alignment spans (1-based inclusive), clipped to [lo, hi]."""
        s = np.maximum(starts, self.lo)
        e = np.minimum(ends, self.hi)
        ok = s <= e
        s = s[ok] - self.lo
        e = e[ok] - self.lo
        if self._dev is not None:
            self._dev.add(s.astype(np.int32), (e + 1).astype(np.int32))
            return
        if self._mesh_spans is not None:
            self._mesh_spans.append((s.astype(np.int32), (e + 1).astype(np.int32)))
            return
        if self.diff is None:
            self.diff = np.zeros(self.hi - self.lo + 3, dtype=np.int64)
        np.add.at(self.diff, s, 1)
        np.add.at(self.diff, e + 1, -1)

    def add_positions(self, pos: np.ndarray):
        p = pos[(pos >= self.lo) & (pos <= self.hi)] - self.lo
        if len(p):
            if self.counts is None:
                self.counts = np.zeros(self.hi - self.lo + 1, dtype=np.int64)
            self.counts += np.bincount(p, minlength=len(self.counts))

    def finalize(self):
        span = self.hi - self.lo + 1
        if self._dev is not None:
            cov = self._dev.finalize()
            if self.counts is not None:
                cov = cov + self.counts
            self._cov = cov
            self._dev = None
            return
        if self._mesh_spans is not None:
            from ..parallel.mesh import mesh_coverage
            cov = mesh_coverage(self._mesh_spans, span)
        elif self.diff is None:   # no spans ever added on the host path
            cov = np.zeros(span, dtype=np.int64)
        else:
            cov = np.cumsum(self.diff[:span + 1])[:span]
        if self.counts is not None:
            cov = cov + self.counts
        self._cov = cov

    def region_coverage(self, start: int, end: int) -> np.ndarray:
        """Per-base coverage for a ROI region (1-based inclusive)."""
        return self._cov[start - self.lo: end - self.lo + 1]

    def region_sum(self, start: int, end: int) -> int:
        if self._ps is None:
            self._ps = np.concatenate(([0], np.cumsum(self._cov)))
        return int(self._ps[end - self.lo + 1] - self._ps[start - self.lo])


class _ChrCoverageSparse:
    """Coverage accumulator in flattened-ROI coordinates: memory/latency scale
    with ROI bases, not with the genomic bounding box. Used when the ROI is
    sparse (e.g. a genome-wide SNP panel with single-base regions)."""

    def __init__(self, starts: np.ndarray, ends: np.ndarray):
        # merge the (sorted) ROI intervals into disjoint blocks
        ms, me = [], []
        for s, e in zip(starts, ends):
            if ms and s <= me[-1] + 1:
                me[-1] = max(me[-1], e)
            else:
                ms.append(s)
                me.append(e)
        self.ms = np.asarray(ms, dtype=np.int64)
        self.me = np.asarray(me, dtype=np.int64)
        self.off = np.concatenate(([0], np.cumsum(self.me - self.ms + 1)))
        self.total = int(self.off[-1])
        self.diff = None   # host diff array, allocated on first host use
        self.counts = None
        self._cov = None
        self._ps = None
        # spans are flattened on the host, then go to one of three sinks:
        # the device coverage engine, the mesh buffer (sharded scatter-add
        # + psum step at finalize), or the host diff array
        self._dev = None
        self._mesh_spans = None
        import os as _os
        if _os.environ.get("NGSBITS_MESH", "") not in ("", "0"):
            self._mesh_spans = []
        else:
            from ..ops import device_reduce as dr
            if dr.use_device():
                self._dev = dr.DeviceCoverage(self.total)

    def add_spans(self, starts: np.ndarray, ends: np.ndarray):
        n = len(self.ms)
        if n == 0 or len(starts) == 0:
            return
        starts = starts.astype(np.int64)
        ends = ends.astype(np.int64)
        # first block whose end >= span start; advance per round until the
        # block start passes the span end (rounds = max blocks per span)
        i = np.searchsorted(self.me, starts, side="left")
        while True:
            ii = np.minimum(i, n - 1)
            act = (i < n) & (self.ms[ii] <= ends) & (starts <= self.me[ii])
            more = (i < n) & (self.ms[ii] <= ends)
            if not more.any():
                break
            j = ii[act]
            s = np.maximum(starts[act], self.ms[j]) - self.ms[j] + self.off[j]
            e = np.minimum(ends[act], self.me[j]) - self.ms[j] + self.off[j]
            if self._dev is not None:
                self._dev.add(s.astype(np.int32), (e + 1).astype(np.int32))
            elif self._mesh_spans is not None:
                self._mesh_spans.append((s.astype(np.int32),
                                         (e + 1).astype(np.int32)))
            else:
                if self.diff is None:
                    self.diff = np.zeros(self.total + 1, dtype=np.int64)
                np.add.at(self.diff, s, 1)
                np.add.at(self.diff, e + 1, -1)
            i = i + more
        return

    def add_positions(self, pos: np.ndarray):
        if len(pos) == 0 or len(self.ms) == 0:
            return
        pos = pos.astype(np.int64)
        j = np.searchsorted(self.ms, pos, side="right") - 1
        ok = (j >= 0) & (pos <= self.me[np.maximum(j, 0)])
        jj = j[ok]
        flat = self.off[jj] + pos[ok] - self.ms[jj]
        if self.counts is None:
            self.counts = np.zeros(self.total, dtype=np.int64)
        self.counts += np.bincount(flat, minlength=self.total)

    def finalize(self):
        if self._dev is not None:
            cov = self._dev.finalize()
            self._dev = None
        elif self._mesh_spans is not None:
            from ..parallel.mesh import mesh_coverage
            cov = mesh_coverage(self._mesh_spans, self.total)
        elif self.diff is None:    # no spans ever added on the host path
            cov = np.zeros(self.total, dtype=np.int64)
        else:
            cov = np.cumsum(self.diff[: self.total + 1])[: self.total]
        if self.counts is not None:
            cov = cov + self.counts
        self._cov = cov

    def _flat(self, start: int, end: int):
        # every ROI region is contained in exactly one merged block
        j = int(np.searchsorted(self.ms, start, side="right")) - 1
        fs = int(self.off[j]) + start - int(self.ms[j])
        return fs, fs + (end - start)

    def region_coverage(self, start: int, end: int) -> np.ndarray:
        fs, fe = self._flat(start, end)
        return self._cov[fs: fe + 1]

    def region_sum(self, start: int, end: int) -> int:
        if self._ps is None:
            self._ps = np.concatenate(([0], np.cumsum(self._cov)))
        fs, fe = self._flat(start, end)
        return int(self._ps[fe + 1] - self._ps[fs])


def _expand_baseq_positions(batch: BamBatch, idx: np.ndarray, min_baseq: int):
    """For selected records, return (m_positions, m_quals, dn_starts, dn_ends):
    the 1-based reference position of every M-op base with its quality, plus
    the D/N op spans (always covered)."""
    if len(idx) == 0:
        z = np.empty(0, np.int64)
        return z, np.empty(0, np.uint8), z, z
    lens = (batch.cigar >> 4).astype(np.int64)
    ops = (batch.cigar & 0xF).astype(np.int64)
    # per-op ref/query offsets within each read via global cumsum minus the
    # read's base value (vectorized segment-cumsum)
    ref_consume = lens * CIGAR_CONSUMES_REF[ops]
    query_consume = lens * np.array([1, 1, 0, 0, 1, 0, 0, 1, 1], dtype=np.int64)[ops]
    co = batch.cigar_off
    n_ops_per_read = co[1:] - co[:-1]
    read_of_op = np.repeat(np.arange(len(batch)), n_ops_per_read)
    ref_before = np.concatenate(([0], np.cumsum(ref_consume)[:-1]))
    q_before = np.concatenate(([0], np.cumsum(query_consume)[:-1]))
    first_op = np.minimum(co[:-1], max(len(ops) - 1, 0))
    ref_off_in_read = ref_before - np.repeat(ref_before[first_op], n_ops_per_read)
    q_off_in_read = q_before - np.repeat(q_before[first_op], n_ops_per_read)

    sel_mask = np.zeros(len(batch), dtype=bool)
    sel_mask[idx] = True
    op_sel = sel_mask[read_of_op]

    pos_of_read = batch.pos.astype(np.int64) + 1  # 1-based
    seq_off_of_read = batch.seq_off[:-1]

    # M/=/X ops with quality filter
    is_m = ((ops == 0) | (ops == 7) | (ops == 8)) & op_sel
    if is_m.any():
        m_lens = lens[is_m]
        m_read = read_of_op[is_m]
        m_ref_start = pos_of_read[m_read] + ref_off_in_read[is_m]
        m_q_start = seq_off_of_read[m_read] + q_off_in_read[is_m]
        tot = int(m_lens.sum())
        rep_ref = np.repeat(m_ref_start, m_lens)
        rep_q = np.repeat(m_q_start, m_lens)
        within = np.arange(tot, dtype=np.int64) - np.repeat(
            np.concatenate(([0], np.cumsum(m_lens[:-1]))), m_lens)
        m_positions = rep_ref + within
        m_quals = batch.qual[rep_q + within]
    else:
        m_positions = np.empty(0, np.int64)
        m_quals = np.empty(0, np.uint8)

    # D/N ops: always covered
    is_dn = ((ops == 2) | (ops == 3)) & op_sel
    if is_dn.any():
        dn_read = read_of_op[is_dn]
        dn_starts = pos_of_read[dn_read] + ref_off_in_read[is_dn]
        dn_ends = dn_starts + lens[is_dn] - 1
    else:
        dn_starts = np.empty(0, np.int64)
        dn_ends = np.empty(0, np.int64)

    keep = m_quals >= min_baseq
    return m_positions[keep], m_quals[keep], dn_starts, dn_ends


def _roi_by_chr(bed: BedFile):
    """chromosome num -> (Chromosome, list of line indices, lo, hi)"""
    out = {}
    for i, l in enumerate(bed.lines):
        key = l.chr.num
        if key not in out:
            out[key] = [l.chr, [], l.start, l.end]
        ent = out[key]
        ent[1].append(i)
        ent[2] = min(ent[2], l.start)
        ent[3] = max(ent[3], l.end)
    return out


def _make_acc(bed: BedFile, idxs, lo: int, hi: int):
    """Dense accumulator over the bounding box, or sparse (flattened-ROI
    coordinates) when the ROI covers a small fraction of a large span."""
    span = hi - lo + 1
    s = np.array([bed.lines[i].start for i in idxs], dtype=np.int64)
    e = np.array([bed.lines[i].end for i in idxs], dtype=np.int64)
    order = np.argsort(s, kind="stable")
    s, e = s[order], e[order]
    run_end = np.maximum.accumulate(e)
    bases = int(np.sum(np.maximum(e - np.maximum(s, np.concatenate(([s[0]], run_end[:-1] + 1))) + 1, 0))) if len(s) else 0
    if span > 4_000_000 and span > 8 * max(bases, 1):
        return _ChrCoverageSparse(s, e)
    return _ChrCoverage(lo, hi)


def _compute_chr_coverage(bed: BedFile, bam_file: str, min_mapq: int, min_baseq: int,
                          skip_mismapped: bool = False, threads: int = 4,
                          random_access: bool = False):
    """One pass over the BAM; returns {chr_num: accumulator}.
    `threads` sizes the BGZF inflate pool (the reference spreads chunk
    workers over a QThreadPool; here decode is the parallel stage).
    `random_access` + a BAI next to the file restricts the scan to the
    per-chromosome ROI bounding boxes (WorkerLowOrHighCoverage's
    random-access mode; useful when the ROI covers a small part of a
    large file)."""
    by_chr = _roi_by_chr(bed)
    accs: dict[int, object] = {}
    for num, (chr_, idxs, lo, hi) in by_chr.items():
        accs[num] = _make_acc(bed, idxs, lo, hi)

    # at least the reader's default inflate pool; -threads only raises it
    reader = BamReader(bam_file, n_threads=max(4, threads))
    ref_num = np.array([Chromosome(n).num for n in reader.ref_names], dtype=np.int64)
    want = np.zeros(len(ref_num) + 1, dtype=bool)
    for i, rn in enumerate(ref_num):
        want[i] = rn in accs
    if random_access:
        from ..io.bai import find_index
        random_access = (find_index(bam_file) is not None
                         and hasattr(reader, "region_batches"))

    def _batches():
        if not random_access:
            yield from reader
            return
        for num in sorted(accs):
            chr_, idxs, lo, hi = by_chr[num]
            rids = np.flatnonzero(ref_num == num)
            if not len(rids):
                continue
            name = reader.ref_names[int(rids[0])]
            for bt, mask in reader.region_batches(name, lo, hi):
                yield bt if mask.all() else bt.subset(mask)

    for batch in _batches():
        sel = _alignment_filter(batch, min_mapq, skip_mismapped)
        rid = batch.ref_id
        sel &= (rid >= 0) & want[np.clip(rid, 0, len(ref_num) - 1)]
        if not sel.any():
            continue
        ends = batch.end_positions()  # 0-based exclusive
        idx_all = np.flatnonzero(sel)
        rids = rid[idx_all]
        for r in np.unique(rids):
            idx = idx_all[rids == r]
            acc = accs[int(ref_num[r])]
            if min_baseq > 0:
                m_pos, _mq, dn_s, dn_e = _expand_baseq_positions(batch, idx, min_baseq)
                acc.add_positions(m_pos)
                if len(dn_s):
                    acc.add_spans(dn_s, dn_e)
            else:
                starts = batch.pos[idx].astype(np.int64) + 1       # 1-based
                ends1 = ends[idx]                                   # 0-based excl == 1-based incl
                acc.add_spans(starts, ends1)
    reader.close()
    return accs, by_chr


def low_or_high_coverage(bed: BedFile, bam_file: str, cutoff: int, min_mapq: int,
                         min_baseq: int, threads: int, is_high: bool,
                         random_access: bool = False) -> BedFile:
    accs, by_chr = _compute_chr_coverage(bed, bam_file, min_mapq, min_baseq,
                                         threads=threads,
                                         random_access=random_access)
    output = BedFile()
    for num, (chr_, idxs, lo, hi) in by_chr.items():
        acc = accs[num]
        acc.finalize()
        for i in idxs:
            line = bed.lines[i]
            region = acc.region_coverage(line.start, line.end)
            mask = region >= cutoff if is_high else region < cutoff
            if not mask.any():
                continue
            m = np.concatenate(([False], mask, [False]))
            d = np.diff(m.astype(np.int8))
            starts = np.flatnonzero(d == 1)
            ends = np.flatnonzero(d == -1) - 1
            for s, e in zip(starts, ends):
                output.append(BedLine(line.chr, line.start + int(s), line.start + int(e),
                                      list(line.annotations)))
    output.merge(True, True, True)
    return output


def avg_coverage(bed: BedFile, bam_file: str, min_mapq: int, threads: int,
                 decimals: int, skip_mismapped: bool = False,
                 random_access: bool = False):
    """Appends mean-depth annotation to each region (reference semantics:
    sum of clipped alignment-overlap / region length)."""
    accs, by_chr = _compute_chr_coverage(bed, bam_file, min_mapq, 0,
                                         skip_mismapped=skip_mismapped,
                                         threads=threads,
                                         random_access=random_access)
    for num, (chr_, idxs, lo, hi) in by_chr.items():
        acc = accs[num]
        acc.finalize()
        for i in idxs:
            line = bed.lines[i]
            total = acc.region_sum(line.start, line.end)
            line.annotations.append(
                _fmt_fixed(total / line.length(), decimals).encode())


def read_count(bed: BedFile, bam_file: str, min_mapq: int):
    """BedReadCount engine: counts alignments overlapping each region
    (read counted once per overlapped region)."""
    from ..core.intervals import ChromosomalIndex
    if not bed.is_merged_and_sorted():
        raise ValueError("Merged and sorted BED file required for coverage calculation!")
    idx = ChromosomalIndex(bed)
    counts = np.zeros(len(bed.lines), dtype=np.int64)
    reader = BamReader(bam_file)
    chr_cache = [Chromosome(n) for n in reader.ref_names]
    for batch in reader:
        flag = batch.flag
        sel = (flag & (FLAG_SECONDARY | FLAG_SUPPLEMENTARY | FLAG_UNMAPPED)) == 0
        sel &= batch.mapq >= min_mapq
        if not sel.any():
            continue
        ends = batch.end_positions()
        for i in np.flatnonzero(sel):
            rid = batch.ref_id[i]
            if rid < 0:
                continue
            for j in idx.matching_indices(chr_cache[rid], int(batch.pos[i]) + 1, int(ends[i])):
                counts[j] += 1
    reader.close()
    for i, line in enumerate(bed.lines):
        line.annotations.append(str(int(counts[i])).encode())


def _fmt_fixed(v: float, decimals: int) -> str:
    from decimal import ROUND_HALF_UP, Decimal
    if v != v:
        return "nan"
    d = Decimal(v).quantize(Decimal(1).scaleb(-decimals), rounding=ROUND_HALF_UP)
    return f"{d:.{decimals}f}"
