"""Batched pileup engine: base counts at SNP positions.

Behavioral reference: ngs-bits BamReader::getPileup (cppNGS/BamReader.cpp:
809-878): skip secondary/supplementary/duplicate/unmapped; optionally require
properly-paired; mapq>=min_mapq; base at position extracted by CIGAR walk
(M/=/X only — deletions/skips don't contribute A/C/G/T counts);
optional fragment dedup by read name (disagreeing pair bases: higher quality
wins, base-vs-deletion removes both).

Batched design: instead of one random access per SNP, ONE sequential pass
over the BAM; per batch the M-op segments are expanded vectorized and joined
against the sorted SNP position list per chromosome via searchsorted —
the per-(read,SNP) base/qual extraction is pure numpy indexing.
"""

from __future__ import annotations

import numpy as np

from ..core.chromosome import Chromosome
from ..io.bam import (BamReader, FLAG_DUPLICATE, FLAG_PROPER_PAIR,
                      FLAG_SECONDARY, FLAG_SUPPLEMENTARY, FLAG_UNMAPPED)

# 4-bit code -> A,C,G,T index (others -> -1)
_CODE2IDX = np.full(16, -1, dtype=np.int8)
_CODE2IDX[1] = 0  # A
_CODE2IDX[2] = 1  # C
_CODE2IDX[4] = 2  # G
_CODE2IDX[8] = 3  # T


class PileupResult:
    """counts[N, 4] = A/C/G/T counts per locus (same order as input loci);
    dels[N] = deletion ('-') counts (Pileup::incDel)."""

    def __init__(self, n: int):
        self.counts = np.zeros((n, 4), dtype=np.int64)
        self.dels = np.zeros(n, dtype=np.int64)
        # filled when track_mapq0=True: flag-passing reads overlapping each
        # locus, and how many of them have mapq 0 (BamReader::getPileup
        # reads_mapped/reads_mapq0)
        self.mapped = np.zeros(n, dtype=np.int64)
        self.mapq0 = np.zeros(n, dtype=np.int64)

    def mapq0_frac(self) -> np.ndarray:
        with np.errstate(divide="ignore", invalid="ignore"):
            return self.mapq0 / self.mapped

    def depth(self, count_del: bool = False) -> np.ndarray:
        d = self.counts.sum(axis=1)
        return d + self.dels if count_del else d

    def frequency(self, ref_idx: np.ndarray, alt_idx: np.ndarray) -> np.ndarray:
        """mut/(wt+mut) per locus; NaN where wt+mut == 0 (Pileup.h:83-91)."""
        n = len(self.counts)
        wt = self.counts[np.arange(n), ref_idx]
        mut = self.counts[np.arange(n), alt_idx]
        with np.errstate(divide="ignore", invalid="ignore"):
            return mut / (wt + mut)


BASE2IDX = {b"A": 0, b"C": 1, b"G": 2, b"T": 3}


def base_index(seq: bytes) -> int:
    return BASE2IDX.get(seq, -1)


def pileup_at_positions(bam_file: str, chr_nums: np.ndarray, positions: np.ndarray,
                        min_mapq: int = 1, include_not_properly_paired: bool = False,
                        min_baseq: int = 0, count_fragments: bool = False,
                        reader: BamReader | None = None,
                        track_mapq0: bool = False) -> PileupResult:
    """Pileup base counts at the given loci.

    chr_nums: [N] chromosome numbers, positions: [N] 1-based positions.
    Loci need not be sorted; an index mapping is built internally.
    """
    n = len(positions)
    result = PileupResult(n)
    if n == 0:
        return result

    # device route: buffer the base-count indices for one device bincount
    # at the end (contamination/ancestry/WGS gender scans)
    from ..ops import device_reduce as dr
    dev_counts = (dr.DeviceBincount(n * 4)
                  if not count_fragments and dr.use_device() else None)

    # group loci by chromosome, sorted positions with original index mapping
    order = np.lexsort((positions, chr_nums))
    s_chr = chr_nums[order]
    s_pos = positions[order]
    chr_bounds = {}
    change = np.flatnonzero(np.diff(s_chr)) + 1
    bounds = np.concatenate(([0], change, [n]))
    for k in range(len(bounds) - 1):
        chr_bounds[int(s_chr[bounds[k]])] = (int(bounds[k]), int(bounds[k + 1]))

    own_reader = reader is None
    if own_reader:
        reader = BamReader(bam_file)
    ref_num = np.array([Chromosome(nm).num for nm in reader.ref_names], dtype=np.int64)

    frag_best: dict = {} if count_fragments else None

    # with a BAI next to the file, restrict the scan to the per-chromosome
    # locus spans (BamReader::setRegion-style random access instead of a
    # whole-file sweep — the win grows with file size vs locus sparsity)
    from ..io.bai import find_index
    use_index = (own_reader and hasattr(reader, "region_batches")
                 and find_index(bam_file) is not None)

    def _span_batches():
        spans = []
        for cn, (lo, hi) in chr_bounds.items():
            rids = np.flatnonzero(ref_num == cn)
            if len(rids):
                spans.append((int(rids[0]), int(s_pos[lo]), int(s_pos[hi - 1])))
        for rid, a, b in sorted(spans):
            for bt, mask in reader.region_batches(reader.ref_names[rid], a, b):
                yield bt if mask.all() else bt.subset(mask)

    for batch in (_span_batches() if use_index else reader):
        flag = batch.flag
        sel = (flag & (FLAG_SECONDARY | FLAG_SUPPLEMENTARY | FLAG_DUPLICATE | FLAG_UNMAPPED)) == 0
        if not include_not_properly_paired:
            sel &= (flag & FLAG_PROPER_PAIR) != 0
        if track_mapq0 and sel.any():
            # count overlapping flag-passing reads (before the mapq cut) and
            # the mapq0 subset, per locus (getPileup reads_mapped/reads_mapq0)
            r_start = batch.pos.astype(np.int64) + 1
            r_end = batch.end_positions().astype(np.int64)
            r_chr = ref_num[np.maximum(batch.ref_id, 0)]
            for which, mask in (("mapped", sel), ("mapq0", sel & (batch.mapq == 0))):
                rr = np.flatnonzero(mask)
                if len(rr) == 0:
                    continue
                arr = result.mapped if which == "mapped" else result.mapq0
                for cn in np.unique(r_chr[rr]):
                    sl = chr_bounds.get(int(cn))
                    if sl is None:
                        continue
                    lo, hi = sl
                    pos_arr = s_pos[lo:hi]
                    seg = rr[r_chr[rr] == cn]
                    a = np.searchsorted(pos_arr, r_start[seg], side="left")
                    b = np.searchsorted(pos_arr, r_end[seg], side="right")
                    events = np.zeros(hi - lo + 1, dtype=np.int64)
                    np.add.at(events, a, 1)
                    np.add.at(events, b, -1)
                    cum = np.cumsum(events[:-1])
                    arr[order[lo:hi]] += cum
        sel &= batch.mapq >= min_mapq
        idx = np.flatnonzero(sel)
        if len(idx) == 0:
            continue

        # expand M ops of selected reads
        lens = (batch.cigar >> 4).astype(np.int64)
        ops = (batch.cigar & 0xF).astype(np.int64)
        co = batch.cigar_off
        n_ops = co[1:] - co[:-1]
        read_of_op = np.repeat(np.arange(len(batch)), n_ops)
        ref_consume = lens * np.array([1, 0, 1, 1, 0, 0, 0, 1, 1], dtype=np.int64)[ops]
        q_consume = lens * np.array([1, 1, 0, 0, 1, 0, 0, 1, 1], dtype=np.int64)[ops]
        ref_before = np.concatenate(([0], np.cumsum(ref_consume)[:-1]))
        q_before = np.concatenate(([0], np.cumsum(q_consume)[:-1]))
        first_op = np.minimum(co[:-1], max(len(ops) - 1, 0))
        ref_off = ref_before - np.repeat(ref_before[first_op], n_ops)
        q_off = q_before - np.repeat(q_before[first_op], n_ops)

        sel_mask = np.zeros(len(batch), dtype=bool)
        sel_mask[idx] = True
        op_sel = sel_mask[read_of_op]
        is_m = ((ops == 0) | (ops == 7) | (ops == 8)) & op_sel

        # deletion spans: loci inside D ops count as '-' (extractBaseByCIGAR)
        is_d = (ops == 2) & op_sel
        if is_d.any() and not count_fragments:
            d_read = read_of_op[is_d]
            d_chr = ref_num[batch.ref_id[d_read]]
            d_start = batch.pos[d_read].astype(np.int64) + 1 + ref_off[is_d]
            d_end = d_start + lens[is_d] - 1
            for cn in np.unique(d_chr):
                sl = chr_bounds.get(int(cn))
                if sl is None:
                    continue
                lo, hi = sl
                pos_arr = s_pos[lo:hi]
                seg = np.flatnonzero(d_chr == cn)
                a = np.searchsorted(pos_arr, d_start[seg], side="left")
                b = np.searchsorted(pos_arr, d_end[seg], side="right")
                cnt = b - a
                nz = cnt > 0
                if not nz.any():
                    continue
                total = int(cnt[nz].sum())
                within = np.arange(total, dtype=np.int64) - np.repeat(
                    np.concatenate(([0], np.cumsum(cnt[nz][:-1]))), cnt[nz])
                snp_local = np.repeat(a[nz], cnt[nz]) + within
                np.add.at(result.dels, order[lo + snp_local], 1)

        if not is_m.any():
            continue
        m_read = read_of_op[is_m]
        m_rid = batch.ref_id[m_read]
        m_chr = ref_num[m_rid]
        m_ref_start = batch.pos[m_read].astype(np.int64) + 1 + ref_off[is_m]
        m_ref_end = m_ref_start + lens[is_m] - 1
        m_q_start = batch.seq_off[:-1][m_read] + q_off[is_m]

        # join against loci per chromosome
        for cn in np.unique(m_chr):
            sl = chr_bounds.get(int(cn))
            if sl is None:
                continue
            lo, hi = sl
            pos_arr = s_pos[lo:hi]
            seg = np.flatnonzero(m_chr == cn)
            a = np.searchsorted(pos_arr, m_ref_start[seg], side="left")
            b = np.searchsorted(pos_arr, m_ref_end[seg], side="right")
            cnt = b - a
            nz = cnt > 0
            if not nz.any():
                continue
            seg = seg[nz]
            a = a[nz]
            cnt = cnt[nz]
            total = int(cnt.sum())
            rep_seg = np.repeat(seg, cnt)
            within = np.arange(total, dtype=np.int64) - np.repeat(
                np.concatenate(([0], np.cumsum(cnt[:-1]))), cnt)
            snp_local = np.repeat(a, cnt) + within
            snp_global = order[lo + snp_local]
            snp_pos = pos_arr[snp_local]
            q_index = m_q_start[rep_seg] + (snp_pos - m_ref_start[rep_seg])
            codes = _CODE2IDX[batch.seq[q_index]]
            quals = batch.qual[q_index]
            keep = codes >= 0
            if min_baseq > 0:
                keep &= quals >= min_baseq
            if count_fragments:
                reads_glob = m_read[rep_seg]
                for k in np.flatnonzero(keep):
                    name = batch.name(int(reads_glob[k]))
                    key = (name, int(snp_global[k]))
                    code = int(codes[k])
                    q = int(quals[k])
                    if key in frag_best:
                        # reference: first read already counted; second read of
                        # the pair replaces it only when higher quality
                        prev_code, prev_q = frag_best.pop(key)
                        if prev_code != code and prev_q < q:
                            result.counts[int(snp_global[k]), code] += 1
                        else:
                            result.counts[int(snp_global[k]), prev_code] += 1
                    else:
                        frag_best[key] = (code, q)
                continue
            flat_idx = snp_global[keep] * 4 + codes[keep]
            if dev_counts is not None:
                dev_counts.add(flat_idx.astype(np.int32))
            else:
                np.add.at(result.counts.reshape(-1), flat_idx, 1)

    if count_fragments and frag_best:
        for (name, snp_idx), (code, _q) in frag_best.items():
            result.counts[snp_idx, code] += 1
    if dev_counts is not None:
        result.counts += dev_counts.finalize().reshape(n, 4)
    if own_reader:
        reader.close()
    return result


def indel_pileup_at_positions(bam_file: str, chr_nums: np.ndarray,
                              positions: np.ndarray, window: int = 1,
                              min_mapq: int = 1,
                              include_not_properly_paired: bool = False):
    """Indel sequences at the given loci, per locus as a dict
    '+SEQ'/'-LEN' -> count.

    Behavioral reference: BamAlignment::extractIndelsByCIGAR
    (cppNGS/BamReader.cpp:375-438): an I op at genome offset g (1-based start
    + consumed M/D/N) is reported when |g - pos| <= window as '+<inserted
    bases>'; a D op as '-<len>'. Window 0 means exact position only.
    """
    n = len(positions)
    out = [dict() for _ in range(n)]
    if n == 0:
        return out

    order = np.lexsort((positions, chr_nums))
    s_chr = chr_nums[order]
    s_pos = positions[order]
    chr_bounds = {}
    change = np.flatnonzero(np.diff(s_chr)) + 1
    bounds = np.concatenate(([0], change, [n]))
    for k in range(len(bounds) - 1):
        chr_bounds[int(s_chr[bounds[k]])] = (int(bounds[k]), int(bounds[k + 1]))

    reader = BamReader(bam_file)
    ref_num = np.array([Chromosome(nm).num for nm in reader.ref_names], dtype=np.int64)
    for batch in reader:
        flag = batch.flag
        sel = (flag & (FLAG_SECONDARY | FLAG_SUPPLEMENTARY | FLAG_DUPLICATE | FLAG_UNMAPPED)) == 0
        if not include_not_properly_paired:
            sel &= (flag & FLAG_PROPER_PAIR) != 0
        sel &= batch.mapq >= min_mapq
        idx = np.flatnonzero(sel)
        if len(idx) == 0:
            continue
        lens = (batch.cigar >> 4).astype(np.int64)
        ops = (batch.cigar & 0xF).astype(np.int64)
        co = batch.cigar_off
        n_ops = co[1:] - co[:-1]
        read_of_op = np.repeat(np.arange(len(batch)), n_ops)
        ref_consume = lens * np.array([1, 0, 1, 1, 0, 0, 0, 1, 1], dtype=np.int64)[ops]
        q_consume = lens * np.array([1, 1, 0, 0, 1, 0, 0, 1, 1], dtype=np.int64)[ops]
        ref_before = np.concatenate(([0], np.cumsum(ref_consume)[:-1]))
        q_before = np.concatenate(([0], np.cumsum(q_consume)[:-1]))
        first_op = np.minimum(co[:-1], max(len(ops) - 1, 0))
        ref_off = ref_before - np.repeat(ref_before[first_op], n_ops)
        q_off = q_before - np.repeat(q_before[first_op], n_ops)

        sel_mask = np.zeros(len(batch), dtype=bool)
        sel_mask[idx] = True
        op_sel = sel_mask[read_of_op]
        is_indel = ((ops == 1) | (ops == 2)) & op_sel
        if not is_indel.any():
            continue
        ii = np.flatnonzero(is_indel)
        i_read = read_of_op[ii]
        i_chr = ref_num[batch.ref_id[i_read]]
        # extractIndelsByCIGAR: genome_pos starts at 1-based start and for an
        # I/D op the reported position is the consumed-reference offset
        g_pos = batch.pos[i_read].astype(np.int64) + 1 + ref_off[ii]
        for t in range(len(ii)):
            cn = int(i_chr[t])
            sl = chr_bounds.get(cn)
            if sl is None:
                continue
            lo, hi = sl
            pos_arr = s_pos[lo:hi]
            g = int(g_pos[t])
            a = np.searchsorted(pos_arr, g - window, side="left")
            b = np.searchsorted(pos_arr, g + window, side="right")
            if a >= b:
                continue
            op_i = int(ii[t])
            if ops[op_i] == 1:  # insertion
                from ..io.bam import SEQ_NIBBLE_ASCII
                qs = int(batch.seq_off[:-1][int(i_read[t])] + q_off[op_i])
                codes = batch.seq[qs:qs + int(lens[op_i])]
                key = b"+" + SEQ_NIBBLE_ASCII[codes].tobytes()
            else:
                key = b"-" + str(int(lens[op_i])).encode()
            for snp_local in range(a, b):
                gi = int(order[lo + snp_local])
                out[gi][key] = out[gi].get(key, 0) + 1
    reader.close()
    return out
