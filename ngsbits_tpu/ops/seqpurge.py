"""Device kernels for SeqPurge's trimming scans.

Behavioral reference: ngs-bits SeqPurge AnalysisWorker.cpp:79-457. The
per-pair O(L²) offset loop becomes a batched band-limited correlation:
for every (pair, offset) the match/mismatch/N counts are computed as masked
[B, O, L] reductions on device; the p-value lookups and accept/reject
decisions run on host in float64 (bit-exact with the reference's doubles).

The reference's early-abort optimization (AnalysisWorker.cpp:143-167) is
provably outcome-neutral (a partial scan that aborts always fails the
match-percentage test), so full counts give identical results.
"""

from __future__ import annotations

import numpy as np

from ..utils import trace
from .device_reduce import use_device

N_CODE = ord("N")


def adapter_evidence_auto(read1, read2, len1, len2, a1, a2, overlap=10):
    """Dispatch (device_reduce.use_device): the XLA formulation on the
    device, shifted-slice numpy on the host (same counts). Both return host
    arrays."""
    if use_device():
        import jax
        trace.count("device.adapter_evidence")
        return jax.device_get(adapter_evidence(read1, read2, len1, len2,
                                               a1, a2, overlap))
    return adapter_evidence_host(np.asarray(read1), np.asarray(read2),
                                 np.asarray(len1), np.asarray(len2),
                                 np.asarray(a1), np.asarray(a2), overlap)


def adapter_scan_auto(read, length, adapter, a_size):
    """Dispatch for the adapter-prefix scan (host arrays either way)."""
    if use_device():
        import jax
        trace.count("device.adapter_scan")
        return jax.device_get(adapter_scan(read, length, adapter, a_size))
    return adapter_scan_host(np.asarray(read), np.asarray(length),
                             np.asarray(adapter), a_size)


def insert_scan_auto(seq1, seq2rc, min_len):
    """Dispatch for the insert-match scan (host arrays either way): the
    XLA formulation `insert_scan` on the device; on the host the
    shifted-slice numpy formulation, O(L) SIMD passes over [B, L-o] slices
    instead of the [B, O, L] gather (bit-identical counts)."""
    if use_device():
        import jax
        trace.count("device.insert_scan")
        return jax.device_get(insert_scan(seq1, seq2rc, min_len))
    return insert_scan_host(np.asarray(seq1), np.asarray(seq2rc),
                            np.asarray(min_len))


def insert_scan_host(seq1: np.ndarray, seq2rc: np.ndarray, min_len: np.ndarray):
    """Host insert-match scan: for offset o compare seq1[j-o] vs seq2rc[j]
    for o <= j < min_len, skipping N bases — identical counts to
    insert_scan, computed with per-offset shifted slices
    (each a contiguous SIMD pass) instead of a [B, O, L] gather."""
    B, L = seq1.shape
    matches = np.zeros((B, L), np.int32)
    mismatches = np.zeros((B, L), np.int32)
    ok1 = seq1 != N_CODE
    ok2 = seq2rc != N_CODE
    jmask = np.arange(L, dtype=np.int32)[None, :] < min_len[:, None]
    ok2m = ok2 & jmask
    max_o = int(min_len.max()) if B else 0
    for o in range(min(max_o, L)):
        w = L - o
        eff = ok1[:, :w] & ok2m[:, o:]
        eq = seq1[:, :w] == seq2rc[:, o:]
        m = (eff & eq).sum(axis=1, dtype=np.int32)
        matches[:, o] = m
        mismatches[:, o] = eff.sum(axis=1, dtype=np.int32) - m
    return matches, mismatches


_DEVICE_FNS = {}


def _device_fns():
    """Lazily build the jitted device formulations (jax import deferred so
    CPU-host tool runs never pay it)."""
    if _DEVICE_FNS:
        return _DEVICE_FNS
    from functools import partial

    import jax
    import jax.numpy as jnp

    @partial(jax.jit, static_argnums=())
    def insert_scan(seq1, seq2rc, min_len):
        B, L = seq1.shape
        o = jnp.arange(L, dtype=jnp.int32)[None, :, None]        # [1, O, 1]
        j = jnp.arange(L, dtype=jnp.int32)[None, None, :]        # [1, 1, L]
        idx = jnp.clip(j - o, 0, L - 1)                          # [1, O, L]
        b_idx = jnp.arange(B, dtype=jnp.int32)[:, None, None]
        s1 = seq1[b_idx, idx]                                    # [B, O, L]
        s2 = seq2rc[:, None, :]
        valid = (j >= o) & (j < min_len[:, None, None])
        is_n = (s1 == N_CODE) | (s2 == N_CODE)
        eff = valid & ~is_n
        matches = jnp.sum(eff & (s1 == s2), axis=2, dtype=jnp.int32)
        mismatches = jnp.sum(eff & (s1 != s2), axis=2, dtype=jnp.int32)
        return matches, mismatches

    @partial(jax.jit, static_argnums=(6,))
    def adapter_evidence(read1, read2, len1, len2, a1, a2, overlap=10):
        B, L = read1.shape
        o = jnp.arange(L, dtype=jnp.int32)[None, :, None]
        i = jnp.arange(overlap, dtype=jnp.int32)[None, None, :]
        start = len2[:, None, None] - o
        pos = start + i

        def window_counts(read, rlen, adapter, extra_valid):
            valid = (pos >= 0) & (pos < rlen[:, None, None]) & extra_valid
            b_idx = jnp.arange(B, dtype=jnp.int32)[:, None, None]
            b = read[b_idx, jnp.clip(pos, 0, L - 1)]
            c = adapter[None, None, :]
            is_n = (b == N_CODE) | (c == N_CODE)
            eff = valid & ~is_n
            m = jnp.sum(eff & (b == c), axis=2, dtype=jnp.int32)
            mm = jnp.sum(eff & (b != c), axis=2, dtype=jnp.int32)
            return m, mm

        m1, mm1 = window_counts(read1, len1, a1, jnp.bool_(True))
        # window2 length is additionally capped at o (i < o)
        m2, mm2 = window_counts(read2, len2, a2, i < o)
        return m1, mm1, m2, mm2

    @partial(jax.jit, static_argnums=(3,))
    def adapter_scan(read, length, adapter, a_size):
        B, L = read.shape
        o = jnp.arange(L, dtype=jnp.int32)[None, :, None]
        i = jnp.arange(a_size, dtype=jnp.int32)[None, None, :]
        pos = o + i
        valid = pos < length[:, None, None]
        b_idx = jnp.arange(B, dtype=jnp.int32)[:, None, None]
        b = read[b_idx, jnp.clip(pos, 0, L - 1)]
        c = adapter[None, None, :a_size]
        is_n = (b == N_CODE) | (c == N_CODE)
        eff = valid & ~is_n
        matches = jnp.sum(eff & (b == c), axis=2, dtype=jnp.int32)
        mismatches = jnp.sum(eff & (b != c), axis=2, dtype=jnp.int32)
        return matches, mismatches

    _DEVICE_FNS.update(insert_scan=insert_scan,
                       insert_scan_raw=insert_scan.__wrapped__,
                       adapter_evidence=adapter_evidence,
                       adapter_scan=adapter_scan)
    return _DEVICE_FNS


def insert_scan_raw():
    """The traceable (unjitted) insert-scan — for composition inside
    shard_map (parallel/mesh.py)."""
    return _device_fns()["insert_scan_raw"]


def insert_scan(seq1, seq2rc, min_len):
    """Counts for the insert-match offset scan (device formulation).

    seq1:   [B, L] uint8 ASCII read1 (zero-padded)
    seq2rc: [B, L] uint8 ASCII revcomp(read2) (zero-padded)
    min_len: [B] int32

    Returns (matches, mismatches): [B, L] int32 per offset (index=offset).
    Position j contributes for offset o when o <= j < min_len:
    compares seq1[j-o] with seq2rc[j] (AnalysisWorker.cpp:150-167).
    """
    return _device_fns()["insert_scan"](seq1, seq2rc, min_len)


def adapter_evidence(read1, read2, len1, len2, a1, a2, overlap=10):
    """Adapter-presence counts for the insert match (AnalysisWorker.cpp:182-259).

    For each offset o: window1 = read1[len2-o : len2-o+overlap] vs a1,
    window2 = read2[len2-o : len2-o+min(overlap,o)] vs a2.
    Returns (m1, mm1, m2, mm2): [B, L] int32.
    """
    return _device_fns()["adapter_evidence"](read1, read2, len1, len2,
                                             a1, a2, overlap)


def adapter_scan(read, length, adapter, a_size: int):
    """Adapter-prefix scan (steps 2/3, AnalysisWorker.cpp:304-427):
    for each offset o compare read[o:o+a_size] vs adapter[:a_size]
    (window truncated at read end). Returns (matches, mismatches): [B, L]."""
    return _device_fns()["adapter_scan"](read, length, adapter, a_size)


def adapter_scan_host(read: np.ndarray, length: np.ndarray,
                      adapter: np.ndarray, a_size: int):
    """Host adapter-prefix scan — same counts as ``adapter_scan`` computed
    with a_size shifted-slice passes (adapter base i contributes to offset o
    at read position o+i)."""
    B, L = read.shape
    matches = np.zeros((B, L), np.int32)
    mismatches = np.zeros((B, L), np.int32)
    inside = np.arange(L, dtype=np.int32)[None, :] < length[:, None]
    ok = inside & (read != N_CODE)
    for i in range(a_size):
        c = adapter[i]
        if c == N_CODE:
            continue
        w = L - i
        eff = ok[:, i:]
        eq = read[:, i:] == c
        matches[:, :w] += (eff & eq)
        mismatches[:, :w] += (eff & ~eq)
    return matches, mismatches


def adapter_evidence_host(read1: np.ndarray, read2: np.ndarray,
                          len1: np.ndarray, len2: np.ndarray,
                          a1: np.ndarray, a2: np.ndarray, overlap: int = 10):
    """Host adapter-evidence counts — same contract as ``adapter_evidence``.

    Rows are realigned once so the window start (len2 - o) becomes a uniform
    shift: aligned[b, P + j] = read[b, len2[b] - j] for j in [-P, L)
    (P = overlap - 1; 0 where out of range), then window index i at offset o
    reads aligned column o - i + P."""
    B, L = read1.shape
    P = overlap - 1
    j = np.arange(-P, L, dtype=np.int32)[None, :]  # aligned col = j + P
    src = len2[:, None] - j                        # read position len2 - j
    rows = np.arange(B, dtype=np.int32)[:, None]

    def aligned_and_valid(read, rlen):
        inb = (src >= 0) & (src < rlen[:, None])
        a = np.where(inb, read[rows, np.clip(src, 0, L - 1)], 0)
        return a, inb

    al1, inb1 = aligned_and_valid(read1, len1)
    al2, inb2 = aligned_and_valid(read2, len2)

    def scan(al, inb, adapter, cap_by_o):
        m = np.zeros((B, L), np.int32)
        mm = np.zeros((B, L), np.int32)
        ok = inb & (al != N_CODE)
        for i in range(overlap):
            c = adapter[i]
            if c == N_CODE:
                continue
            lo = i + 1 if cap_by_o else 0          # window2 needs i < o
            w = L - lo
            if w <= 0:
                continue
            # offset o in [lo, L) reads aligned column o - i + P
            s = lo - i + P
            eff = ok[:, s: s + w]
            eq = al[:, s: s + w] == c
            m[:, lo:] += (eff & eq)
            mm[:, lo:] += (eff & ~eq)
        return m, mm

    m1, mm1 = scan(al1, inb1, a1, cap_by_o=False)
    m2, mm2 = scan(al2, inb2, a2, cap_by_o=True)
    return m1, mm1, m2, mm2
