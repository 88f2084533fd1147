"""SeqPurge trimming engine (host decision logic + stats).

Behavioral reference: ngs-bits SeqPurge (AnalysisWorker.cpp:79-457,
OutputWorker.cpp:19-106, Auxilary.h:100-280, FastqFileStream.cpp:52-115 for
trimQuality/trimN). Count kernels run on device (ops/seqpurge.py); all
p-value comparisons use float64 lookups into the exact binomial-tail table
(core/basicstats.py), mirroring the reference's double math bit-for-bit.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core.basicstats import match_probability_table
from ..io.fastq import FastqBatch
from ..ops import seqpurge as ops
from .read_stats import FORWARD, REVERSE, ReadStatistics

MAXLEN = 1000
_COMPLEMENT = np.zeros(256, dtype=np.uint8)
for _a, _b in zip(b"ACGTN", b"TGCAN"):
    _COMPLEMENT[_a] = _b
for _c in range(256):
    if _COMPLEMENT[_c] == 0:
        _COMPLEMENT[_c] = _c


@dataclass
class SeqPurgeParams:
    a1: bytes = b"AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"
    a2: bytes = b"AGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGT"
    match_perc: float = 80.0
    mep: float = 0.000001
    qcut: int = 15
    qwin: int = 5
    qoff: int = 33
    ncut: int = 7
    min_len: int = 30
    ec: bool = False
    adapter_overlap: int = 10

    @property
    def a_size(self) -> int:
        return min(20, len(self.a1), len(self.a2))


@dataclass
class SeqPurgeStats:
    read_num: int = 0
    bases_remaining: np.ndarray = field(default_factory=lambda: np.zeros(MAXLEN, dtype=np.int64))
    acons1: np.ndarray = field(default_factory=lambda: np.zeros((40, 5), dtype=np.int64))
    acons2: np.ndarray = field(default_factory=lambda: np.zeros((40, 5), dtype=np.int64))
    reads_trimmed_insert: float = 0.0
    reads_trimmed_adapter: float = 0.0
    reads_trimmed_q: float = 0.0
    reads_trimmed_n: float = 0.0
    reads_removed: float = 0.0
    bases_perc_trim_sum: float = 0.0
    # error correction stats
    mismatch_r1: np.ndarray = field(default_factory=lambda: np.zeros(MAXLEN, dtype=np.int64))
    mismatch_r2: np.ndarray = field(default_factory=lambda: np.zeros(MAXLEN, dtype=np.int64))
    errors_per_read: np.ndarray = field(default_factory=lambda: np.zeros(MAXLEN, dtype=np.int64))

    def merge(self, other: "SeqPurgeStats"):
        """Fold a worker's stats into this one — every field is a
        commutative sum, so multi-threaded trimming merges exactly
        (the analogue of the reference's shared-accumulator mutex,
        SeqPurge/Auxilary.h:164)."""
        self.read_num += other.read_num
        self.bases_remaining += other.bases_remaining
        self.acons1 += other.acons1
        self.acons2 += other.acons2
        self.reads_trimmed_insert += other.reads_trimmed_insert
        self.reads_trimmed_adapter += other.reads_trimmed_adapter
        self.reads_trimmed_q += other.reads_trimmed_q
        self.reads_trimmed_n += other.reads_trimmed_n
        self.reads_removed += other.reads_removed
        self.bases_perc_trim_sum += other.bases_perc_trim_sum
        self.mismatch_r1 += other.mismatch_r1
        self.mismatch_r2 += other.mismatch_r2
        self.errors_per_read += other.errors_per_read


_ACGTN = np.frombuffer(b"ACGTN", dtype=np.uint8)


def _pileup_add(acons: np.ndarray, windows: np.ndarray, mask: np.ndarray):
    """acons[col, base] += counts of base codes in windows[B, 40] where mask."""
    for bi, code in enumerate(_ACGTN):
        hit = (windows == code) & mask
        acons[:, bi] += hit.sum(axis=0)


class SeqPurgeEngine:
    def __init__(self, params: SeqPurgeParams, qc: ReadStatistics | None = None,
                 threads: int = 1):
        self.p = params
        self.stats = SeqPurgeStats()
        self.qc = qc
        self.threads = max(1, threads)
        self.table = match_probability_table(0.25, MAXLEN)
        self.a1_arr = np.frombuffer(params.a1, dtype=np.uint8)
        self.a2_arr = np.frombuffer(params.a2, dtype=np.uint8)

    @staticmethod
    def native_available() -> bool:
        """True when the C++ batch-analysis kernel (native/seqpurge.cpp)
        is usable; it is the production path and pre-empts the device
        scans (the decision stage is host-bound)."""
        import os
        if os.environ.get("NGSBITS_SEQPURGE_NO_NATIVE"):
            return False
        if os.environ.get("NGSBITS_MESH", "") not in ("", "0"):
            return False    # mesh mode routes the scans over the device mesh
        from ..io.native import get_lib
        return get_lib() is not None

    # ------------- trimming primitives -------------
    def trim_quality(self, quals: np.ndarray, lengths: np.ndarray) -> np.ndarray:
        """FastqEntry::trimQuality semantics; returns new lengths."""
        cutoff = self.p.qcut
        window = self.p.qwin
        B, L = quals.shape
        q = quals.astype(np.int32) - self.p.qoff
        pos = np.arange(L)[None, :]
        inside = pos < lengths[:, None]
        qm = np.where(inside, q, 0)
        cums = np.concatenate([np.zeros((B, 1), np.int64), np.cumsum(qm, axis=1)], axis=1)
        # window sums starting at i (valid for i <= count-window)
        win = cums[:, window:] - cums[:, :-window] if L >= window else np.zeros((B, 0), np.int64)
        Wn = win.shape[1]
        i_grid = np.arange(Wn)[None, :]
        valid = i_grid <= (lengths[:, None] - window)
        ok = valid & (win >= cutoff * window)
        if Wn == 0:  # every read shorter than the window -> unchanged below
            any_ok = np.zeros(B, bool)
            i_max = np.zeros(B, np.int64)
        else:
            any_ok = ok.any(axis=1)
            # largest i with ok
            i_max = Wn - 1 - np.argmax(ok[:, ::-1], axis=1)
        count_new = np.where(any_ok, i_max + window, 0)
        # strip trailing bases below cutoff
        ge = (q >= cutoff) & (pos < count_new[:, None])
        has_ge = ge.any(axis=1)
        last_ge = L - 1 - np.argmax(ge[:, ::-1], axis=1)
        count_final = np.where(any_ok, np.where(has_ge, last_ge + 1, 0), 0)
        # too-small reads unchanged
        out = np.where(lengths < window, lengths, count_final).astype(np.int32)
        return out

    def trim_n(self, bases: np.ndarray, lengths: np.ndarray) -> np.ndarray:
        """FastqEntry::trimN semantics; returns new lengths."""
        num_n = self.p.ncut
        B, L = bases.shape
        pos = np.arange(L)[None, :]
        inside = pos < lengths[:, None]
        isn = (bases == ord("N")) & inside
        cums = np.concatenate([np.zeros((B, 1), np.int64), np.cumsum(isn, axis=1)], axis=1)
        if L >= num_n:
            run = cums[:, num_n:] - cums[:, :-num_n]  # run ending at i = idx+num_n-1
            Rn = run.shape[1]
            end_i = np.arange(Rn)[None, :] + num_n - 1
            hit = (run == num_n) & (end_i < lengths[:, None])
            any_hit = hit.any(axis=1)
            first = np.argmax(hit, axis=1)  # index into run -> end_i = first+num_n-1
            count_new = first  # = (first+num_n-1) - num_n + 1
            out = np.where((lengths >= num_n) & any_hit, count_new, lengths)
        else:
            out = lengths
        return out.astype(np.int32)

    # ------------- main pair processing -------------
    def process_batch(self, b1: FastqBatch, b2: FastqBatch):
        """Trim one batch of read pairs in place. Returns (len1, len2) new
        lengths; b1/b2 bases/quals may be modified (error correction)."""
        p = self.p
        B = len(b1)
        assert len(b2) == B

        # raw-read QC (before trimming)
        if self.qc is not None:
            self.qc.update_batch(b1, FORWARD)
            self.qc.update_batch(b2, REVERSE)

        # header check
        h1 = b1.headers
        h2 = b2.headers
        if b1.has_flat_headers() and b2.has_flat_headers():
            from ..io.native import get_lib
            lib = get_lib()
            bad = lib.ngs_headers_match(
                np.ascontiguousarray(b1.h1_flat), b1.h1_starts,
                np.ascontiguousarray(b1.h1_lens, dtype=np.int32),
                np.ascontiguousarray(b2.h1_flat), b2.h1_starts,
                np.ascontiguousarray(b2.h1_lens, dtype=np.int32), B)
            if bad >= 0:
                t1 = b1.header_bytes(int(bad)).split(b" ")[0]
                t2 = b2.header_bytes(int(bad)).split(b" ")[0]
                if t1.endswith(b"/1") and t2.endswith(b"/2"):
                    t1 = t1[:-2]
                    t2 = t2[:-2]
                raise ValueError(
                    f"Headers of reads do not match:\n{t1.decode()}\n{t2.decode()}")
        elif h1 is not None and h2 is not None:
            for a, b in zip(h1, h2):
                t1 = a.split(b" ")[0]
                t2 = b.split(b" ")[0]
                if t1.endswith(b"/1") and t2.endswith(b"/2"):
                    t1 = t1[:-2]
                    t2 = t2[:-2]
                if t1 != t2:
                    raise ValueError(
                        f"Headers of reads do not match:\n{t1.decode()}\n{t2.decode()}")

        len1 = b1.lengths.astype(np.int32).copy()
        len2 = b2.lengths.astype(np.int32).copy()
        if int(len1.max(initial=0)) >= MAXLEN or int(len2.max(initial=0)) >= MAXLEN:
            raise ValueError(f"Read length unsupported! A maximum read length of {MAXLEN} is supported!")
        if self.native_available():
            return self._process_batch_native(b1, b2, len1, len2)
        L = max(b1.bases.shape[1], b2.bases.shape[1])
        seq1 = np.zeros((B, L), dtype=np.uint8)
        seq1[:, :b1.bases.shape[1]] = b1.bases
        read2 = np.zeros((B, L), dtype=np.uint8)
        read2[:, :b2.bases.shape[1]] = b2.bases
        # revcomp(read2) padded
        pos = np.arange(L)[None, :]
        idx2 = len2[:, None] - 1 - pos
        seq2rc = np.where(idx2 >= 0, _COMPLEMENT[read2[np.arange(B)[:, None], np.maximum(idx2, 0)]], 0)

        min_len = np.minimum(len1, len2)

        # ---- step 1: insert match (device counts + host decisions) ----
        import os as _os
        if _os.environ.get("NGSBITS_MESH", "") not in ("", "0"):
            # mesh mode: shard the scan over read pairs (SURVEY §2.5 P3) —
            # pad B to a device-count multiple with empty pairs, outputs
            # re-gather on host; decisions below are unchanged so trim
            # results are byte-identical to the single-device run
            import jax
            from ..parallel.mesh import make_mesh, sharded_insert_scan
            nd = jax.device_count()
            pad = (-B) % nd
            if pad:
                z = np.zeros((pad, L), dtype=np.uint8)
                ps1 = np.concatenate([seq1, z])
                ps2 = np.concatenate([seq2rc, z])
                pml = np.concatenate([min_len, np.zeros(pad, np.int32)])
            else:
                ps1, ps2, pml = seq1, seq2rc, min_len
            m, mm = jax.device_get(
                sharded_insert_scan(make_mesh(), ps1, ps2, pml))
            m, mm = m[:B], mm[:B]
        else:
            m, mm = ops.insert_scan_auto(seq1, seq2rc, min_len)
        m1, mm1, m2, mm2 = ops.adapter_evidence_auto(
            seq1, read2, len1, len2, self.a1_arr[:p.adapter_overlap],
            self.a2_arr[:p.adapter_overlap], p.adapter_overlap)
        tot = m + mm
        offsets = np.arange(L)[None, :]
        with np.errstate(divide="ignore", invalid="ignore"):
            ratio_ok = (tot > 0) & ~(100.0 * m / np.maximum(tot, 1) < p.match_perc)
        # evaluate the binomial-tail table only where the cheap ratio test
        # passes — the dense [B, L] float64 gathers dominated this stage
        cand0 = ratio_ok & (offsets >= 1) & (offsets < min_len[:, None])
        pv = np.full((B, L), np.inf)
        rows, cols = np.nonzero(cand0)
        pv[rows, cols] = self.table[tot[rows, cols], m[rows, cols]]
        cand = cand0 & (pv <= p.mep)

        maxmm = np.where(offsets < 3, 0, np.where(offsets < 6, 1, 2))
        pass_short = (mm1 <= maxmm) | (mm2 <= maxmm)
        ok = cand & (offsets < 10) & pass_short
        long_rows, long_cols = np.nonzero(cand & (offsets >= 10))
        if len(long_rows):
            p1 = self.table[m1[long_rows, long_cols] + mm1[long_rows, long_cols],
                            m1[long_rows, long_cols]]
            p2 = self.table[m2[long_rows, long_cols] + mm2[long_rows, long_cols],
                            m2[long_rows, long_cols]]
            ok[long_rows, long_cols] = (p1 * p2) <= p.mep

        p_masked = np.where(ok, pv, np.inf)
        best_offset = np.where(ok.any(axis=1), np.argmin(p_masked, axis=1), -1)
        has_insert = best_offset != -1

        new_len1 = len1.copy()
        new_len2 = len2.copy()
        ins_idx = np.flatnonzero(has_insert)
        if len(ins_idx):
            nl = len2[ins_idx] - best_offset[ins_idx]
            new_len1[ins_idx] = np.minimum(len1[ins_idx], nl)
            new_len2[ins_idx] = np.minimum(len2[ins_idx], nl)
            self.stats.reads_trimmed_insert += 2.0 * len(ins_idx)

            # consensus adapters
            w = np.arange(40)[None, :]
            a1_pos = nl[:, None] + w
            a1_valid = a1_pos < len1[ins_idx][:, None]
            win1 = seq1[ins_idx[:, None], np.minimum(a1_pos, L - 1)]
            _pileup_add(self.stats.acons1, win1, a1_valid)
            a2_pos = (len2[ins_idx] - best_offset[ins_idx])[:, None] + w
            a2_valid = a2_pos < len2[ins_idx][:, None]
            win2 = read2[ins_idx[:, None], np.minimum(a2_pos, L - 1)]
            _pileup_add(self.stats.acons2, win2, a2_valid)

            # error correction on truncated pair
            if p.ec:
                self._correct_errors(b1, b2, seq1, read2, new_len1, new_len2, ins_idx, L)

        # ---- steps 2+3: adapter match on non-insert pairs ----
        noins = np.flatnonzero(~has_insert)
        if len(noins):
            am1, amm1 = ops.adapter_scan_auto(
                seq1, len1, self.a1_arr[:p.a_size], p.a_size)
            am2, amm2 = ops.adapter_scan_auto(
                read2, len2, self.a2_arr[:p.a_size], p.a_size)

            def first_hit(msub, mmsub, lens):
                t = msub + mmsub
                with np.errstate(divide="ignore", invalid="ignore"):
                    ratio = 100.0 * msub / t
                # (ratio==nan for t==0 passes the ~< test, like the dense
                # formulation); table gathered sparsely where it can matter
                okm = ~(ratio < p.match_perc) & (offsets < lens[:, None])
                rr, cc = np.nonzero(okm)
                if len(rr):
                    pp = self.table[t[rr, cc], msub[rr, cc]]
                    okm[rr, cc] = pp <= p.mep
                any_ = okm.any(axis=1)
                off = np.where(any_, np.argmax(okm, axis=1), -1)
                return off

            off_f = first_hit(am1[noins], amm1[noins], len1[noins])
            off_r = first_hit(am2[noins], amm2[noins], len2[noins])
            hit = (off_f != -1) | (off_r != -1)
            eff_f = np.where(off_f != -1, off_f, off_r)
            eff_r = np.where(off_r != -1, off_r, off_f)
            sel = np.flatnonzero(hit)
            if len(sel):
                g = noins[sel]
                new_len1[g] = np.minimum(new_len1[g], eff_f[sel])
                new_len2[g] = np.minimum(new_len2[g], eff_r[sel])
                self.stats.reads_trimmed_adapter += 2 * len(sel)

        # ---- quality trimming ----
        if p.qcut > 0:
            q1 = self.trim_quality(b1.quals, new_len1)
            self.stats.reads_trimmed_q += int((q1 < new_len1).sum())
            new_len1 = q1
            q2 = self.trim_quality(b2.quals, new_len2)
            self.stats.reads_trimmed_q += int((q2 < new_len2).sum())
            new_len2 = q2

        # ---- N trimming ----
        if p.ncut > 0:
            n1 = self.trim_n(b1.bases, new_len1)
            self.stats.reads_trimmed_n += int((n1 < new_len1).sum())
            new_len1 = n1
            n2 = self.trim_n(b2.bases, new_len2)
            self.stats.reads_trimmed_n += int((n2 < new_len2).sum())
            new_len2 = n2

        # ---- output statistics (OutputWorker.cpp:34-77) ----
        self.stats.read_num += 2 * B
        np.add.at(self.stats.bases_remaining, new_len1, 1)
        np.add.at(self.stats.bases_remaining, new_len2, 1)
        nz1 = len1 > 0
        self.stats.bases_perc_trim_sum += float(
            ((len1[nz1] - new_len1[nz1]) / len1[nz1]).sum())
        nz2 = len2 > 0
        self.stats.bases_perc_trim_sum += float(
            ((len2[nz2] - new_len2[nz2]) / len2[nz2]).sum())

        return new_len1, new_len2

    def _process_batch_native(self, b1: FastqBatch, b2: FastqBatch,
                              len1: np.ndarray, len2: np.ndarray):
        """C++ batch analysis (native/seqpurge.cpp): identical decisions to
        the numpy path (cross-checked by tests/test_seqpurge.py), ~40x
        faster and internally threaded."""
        from ..io.native import get_lib
        lib = get_lib()
        p = self.p
        s = self.stats
        B = len(b1)
        L = max(b1.bases.shape[1], b2.bases.shape[1], b1.quals.shape[1],
                b2.quals.shape[1], 1)

        def padded(a: np.ndarray) -> np.ndarray:
            out = np.zeros((B, L), dtype=np.uint8)
            out[:, :a.shape[1]] = a
            return out

        seq1 = padded(b1.bases)
        qual1 = padded(b1.quals)
        seq2 = padded(b2.bases)
        qual2 = padded(b2.quals)

        best_offset = np.empty(B, dtype=np.int32)
        new_len1 = np.empty(B, dtype=np.int32)
        new_len2 = np.empty(B, dtype=np.int32)
        counters = np.zeros(4, dtype=np.int64)
        perc = np.zeros(1, dtype=np.float64)

        rc = lib.ngs_seqpurge_analyze(
            seq1, qual1, seq2, qual2,
            np.ascontiguousarray(len1), np.ascontiguousarray(len2),
            B, L, self.table, self.table.shape[1],
            self.a1_arr, self.a2_arr,
            p.adapter_overlap, p.a_size, float(p.match_perc), float(p.mep),
            p.qcut, p.qwin, p.qoff, p.ncut,
            1 if p.ec else 0, self.threads,
            best_offset, new_len1, new_len2,
            counters, perc,
            s.bases_remaining, s.acons1, s.acons2,
            s.mismatch_r1, s.mismatch_r2, s.errors_per_read)
        if rc != 0:
            raise RuntimeError("ngs_seqpurge_analyze failed")

        s.read_num += 2 * B
        s.reads_trimmed_insert += float(counters[0])
        s.reads_trimmed_adapter += float(counters[1])
        s.reads_trimmed_q += float(counters[2])
        s.reads_trimmed_n += float(counters[3])
        s.bases_perc_trim_sum += float(perc[0])
        if p.ec:
            # corrections were applied to the padded copies — fold back
            b1.bases[:] = seq1[:, :b1.bases.shape[1]]
            b1.quals[:] = qual1[:, :b1.quals.shape[1]]
            b2.bases[:] = seq2[:, :b2.bases.shape[1]]
            b2.quals[:] = qual2[:, :b2.quals.shape[1]]
        return new_len1, new_len2

    def _correct_errors(self, b1, b2, seq1, read2, new_len1, new_len2, ins_idx, L):
        """Error correction (AnalysisWorker.cpp:19-77) on insert-matched pairs."""
        p = self.p
        sub = ins_idx
        count = np.minimum(new_len1[sub], new_len2[sub])  # == both after trunc
        pos = np.arange(L)[None, :]
        i_valid = pos < count[:, None]
        i2 = count[:, None] - 1 - pos  # mirrored index into read2
        i2c = np.maximum(i2, 0)
        bsub = np.arange(len(sub))[:, None]
        b1b = seq1[sub][:, :L]
        b2b = read2[sub[:, None], i2c]          # read2 bases at i2
        mismatch = i_valid & (b1b != _COMPLEMENT[b2b])
        q1 = b1.quals[sub][:, :L].astype(np.int32) - p.qoff
        q2r = b2.quals[sub[:, None], i2c].astype(np.int32) - p.qoff
        r2_wins = mismatch & (q1 > q2r)   # correct R2
        r1_wins = mismatch & (q1 < q2r)   # correct R1
        # apply corrections in place
        rows1, cols1 = np.nonzero(r1_wins)
        if len(rows1):
            gi = sub[rows1]
            b1.bases[gi, cols1] = _COMPLEMENT[b2.bases[gi, i2c[rows1, cols1]]]
            b1.quals[gi, cols1] = b2.quals[gi, i2c[rows1, cols1]]
            np.add.at(self.stats.mismatch_r1, cols1, 1)
        rows2, cols2 = np.nonzero(r2_wins)
        if len(rows2):
            gi = sub[rows2]
            tgt = i2c[rows2, cols2]
            b2.bases[gi, tgt] = _COMPLEMENT[b1.bases[gi, cols2] if False else seq1[gi, cols2]]
            b2.quals[gi, tgt] = b1.quals[gi, cols2]
            np.add.at(self.stats.mismatch_r2, tgt, 1)
        mm_count = mismatch.sum(axis=1)
        nzm = mm_count > 0
        np.add.at(self.stats.errors_per_read, mm_count[nzm], 1)

    # ------------- summary -------------
    def write_summary(self, out, params_a1: bytes, params_a2: bytes):
        """TrimmingStatistics::writeStatistics (Auxilary.h:166-221)."""
        s = self.stats
        w = out.write
        from decimal import ROUND_HALF_UP, Decimal

        def fmt2(v):
            if v != v:
                return "nan"
            return f"{Decimal(v).quantize(Decimal('0.01'), rounding=ROUND_HALF_UP):.2f}"

        w(f"Reads (forward + reverse): {s.read_num}\n\n")
        w(f"Reads trimmed by insert match: {int(s.reads_trimmed_insert)}\n")
        w(f"Reads trimmed by adapter match: {int(s.reads_trimmed_adapter)}\n")
        w(f"Reads trimmed by quality: {int(s.reads_trimmed_q)}\n")
        w(f"Reads trimmed by N stretches: {int(s.reads_trimmed_n)}\n")
        trimmed = s.reads_trimmed_insert + s.reads_trimmed_adapter
        w(f"Trimmed reads: {int(trimmed)} of {s.read_num} ({fmt2(100.0 * trimmed / s.read_num)}%)\n")
        w(f"Removed reads: {int(s.reads_removed)} of {s.read_num} ({fmt2(100.0 * s.reads_removed / s.read_num)}%)\n")
        w(f"Removed bases: {fmt2(100.0 * s.bases_perc_trim_sum / s.read_num)}%\n\n")

        for name, acons, given in (("Forward", s.acons1, params_a1),
                                   ("Reverse", s.acons2, params_a2)):
            seq = []
            for i in range(40):
                depth = int(acons[i, :4].sum())
                if depth < 20:
                    break
                mx = int(acons[i, :4].max())
                if mx / depth <= 0.5:
                    seq.append("N")
                else:
                    seq.append("ACGT"[int(np.argmax(acons[i, :4]))])
            w(f"{name} adapter sequence (given)    : {given.decode()}\n")
            w(f"{name} adapter sequence (consensus): {''.join(seq)}\n")
        w("\n")

        w("Read length distribution after trimming:\n")
        mx = MAXLEN - 1
        while mx > 0 and s.bases_remaining[mx] == 0:
            mx -= 1
        for i in range(mx + 1):
            w(f"{str(i).rjust(4)}: {int(s.bases_remaining[i])}\n")

    def write_ec_summary(self, out):
        s = self.stats
        w = out.write
        for title, arr in (("Read error per cycle (read 1):", s.mismatch_r1),
                           ("Read error per cycle (read 2):", s.mismatch_r2),
                           ("Read error count distribution:", s.errors_per_read)):
            w("\n")
            w(title + "\n")
            mx = MAXLEN - 1
            while mx > 0 and arr[mx] == 0:
                mx -= 1
            for i in range(1, mx + 1):
                w(f"{str(i).rjust(4)}: {int(arr[i])}\n")
