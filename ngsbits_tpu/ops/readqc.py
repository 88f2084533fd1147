"""Device compute for raw-read QC (ReadQC engine inner loops).

Behavioral reference: ngs-bits ``StatisticsReads::update``
(cppNGS/StatisticsReads.cpp:26-81): per-cycle base pileups, per-cycle quality
sums, base-quality histogram, per-read quality sums.

Batched design: a whole batch of reads is one [B, L] uint8 tensor; the
per-read C++ loop becomes masked vector reductions (fused by XLA):
  counts5[c, L]   = sum_B onehot(base)        (per-cycle pileups)
  qsum_cycle[L]   = sum_B qual                (per-cycle quality sums)
  qhist[Q]        = histogram of all quals    (one-hot matmul)
  read_qsum[B]    = sum_L qual                (per-read quality sums)
All masked by position < length. Padding never contributes.
"""

from __future__ import annotations

import numpy as np

# base codes in pileup order A, C, G, T, N (ASCII)
BASE_CODES = np.frombuffer(b"ACGTN", dtype=np.uint8)
QHIST_SIZE = 100  # reference base_qualities_ array size (StatisticsReads.h:48)

_READQC_JIT = None
_READQC_RAW = None


def _build_readqc_raw():
    # jax is imported lazily so CPU-host tool invocations (which take the
    # native readqc_batch_host path) never pay the ~1.5s jax import
    import jax
    import jax.numpy as jnp

    def readqc_batch_impl(bases, quals, lengths):
        B, L = bases.shape
        pos = jax.lax.broadcasted_iota(jnp.int32, (B, L), 1)
        mask = pos < lengths[:, None]
        q = jnp.where(mask, quals.astype(jnp.int32) - 33, 0)

        counts5 = jnp.stack([
            jnp.sum(((bases == code) & mask).astype(jnp.int32), axis=0)
            for code in BASE_CODES
        ])  # [5, L]

        qsum_cycle = jnp.sum(q, axis=0, dtype=jnp.int32)  # [L]
        read_qsum = jnp.sum(q, axis=1, dtype=jnp.int32)   # [B]

        # base-quality histogram via one-hot reduction: padding is masked by
        # routing it to a sentinel bin that is dropped.
        q_or_sentinel = jnp.where(mask, q, QHIST_SIZE)
        onehot = q_or_sentinel[:, :, None] == jnp.arange(QHIST_SIZE + 1)[None, None, :]
        qhist = jnp.sum(onehot, axis=(0, 1), dtype=jnp.int32)[:QHIST_SIZE]

        return counts5, qsum_cycle, qhist, read_qsum

    return readqc_batch_impl


def readqc_batch_raw():
    """The traceable (unjitted) batch function — for composition inside
    shard_map (parallel/mesh.py)."""
    global _READQC_RAW
    if _READQC_RAW is None:
        _READQC_RAW = _build_readqc_raw()
    return _READQC_RAW


def readqc_batch(bases, quals, lengths):
    """Compute ReadQC partial statistics for one batch (device path).

    Args:
      bases:   [B, L] uint8 ASCII base codes (zero-padded)
      quals:   [B, L] uint8 ASCII quality codes (zero-padded)
      lengths: [B] int32 read lengths

    Returns:
      counts5:    [5, L] int32 per-cycle base counts (A,C,G,T,N)
      qsum_cycle: [L] int32 per-cycle quality sums (offset-33 units)
      qhist:      [QHIST_SIZE] int32 base-quality histogram
      read_qsum:  [B] int32 per-read quality sums
    """
    global _READQC_JIT
    if _READQC_JIT is None:
        import jax
        _READQC_JIT = jax.jit(readqc_batch_raw())
    return _READQC_JIT(bases, quals, lengths)


def readqc_batch_host(bases: np.ndarray, quals: np.ndarray,
                      lengths: np.ndarray):
    """Same contract as readqc_batch, computed on the host.

    The host path: the native C++ single pass (ngs_readqc_batch) when the
    library builds, else numpy bincount.
    """
    B, L = bases.shape
    from ..io.native import get_lib
    lib = get_lib()
    if (lib is not None and B and bases.flags.c_contiguous
            and quals.flags.c_contiguous and bases.shape == quals.shape):
        counts5 = np.zeros((5, L), dtype=np.int32)
        qsum_cycle = np.zeros(L, dtype=np.int64)
        qhist = np.zeros(QHIST_SIZE, dtype=np.int64)
        read_qsum = np.zeros(B, dtype=np.int32)
        lib.ngs_readqc_batch(bases, quals,
                             np.ascontiguousarray(lengths, dtype=np.int32),
                             B, L, counts5, qsum_cycle, qhist, read_qsum)
        return counts5, qsum_cycle, qhist, read_qsum
    mask = np.arange(L, dtype=np.int32)[None, :] < lengths[:, None]
    q = np.where(mask, quals.astype(np.int32) - 33, 0)
    counts5 = np.stack([
        np.sum((bases == code) & mask, axis=0, dtype=np.int32)
        for code in BASE_CODES
    ])
    qsum_cycle = q.sum(axis=0, dtype=np.int32)
    read_qsum = q.sum(axis=1, dtype=np.int32)
    qflat = q[mask].ravel()
    qflat = qflat[qflat >= 0]  # device one-hot drops out-of-range too
    qhist = np.bincount(qflat, minlength=QHIST_SIZE)
    qhist = qhist[:QHIST_SIZE].astype(np.int32)
    return counts5, qsum_cycle, qhist, read_qsum


# --------------------------------------------------------------------------
# Device-resident streaming engine (packed uploads, single fetch at EOF)
#
# The forced device route used to ship padded uint8 [B, L] bases+quals per
# batch and fetch four reductions back per batch — through a thin host link
# that transfer dominates. This engine (a) packs the upload to ~9 bits/base
# (2-bit base codes + 1-bit N mask + 6-bit quals, ngs_pack_batch) and (b)
# keeps ALL accumulators on device across batches — including the per-read
# tail stats (mean-quality histograms, Q20 count) the host used to derive
# from per-batch fetches — so results transfer ONCE at EOF.
# --------------------------------------------------------------------------

_STREAM_JIT = None


def _build_stream_step():
    import jax
    import jax.numpy as jnp

    def unpack(pb, nm, pq, B, L, qual_bits):
        # bases: 4 per byte, 2-bit codes
        shifts = jnp.arange(4, dtype=jnp.uint8) * 2
        codes = (pb[:, :, None] >> shifts[None, None, :]) & 3      # [B, L/4, 4]
        codes = codes.reshape(B, L).astype(jnp.int32)              # 0..3
        nbits = (nm[:, :, None] >> jnp.arange(8, dtype=jnp.uint8)[None, None, :]) & 1
        is_n = nbits.reshape(B, L).astype(bool)
        code5 = jnp.where(is_n, 4, codes)                          # A C G T N
        if qual_bits == 8:  # long-read range (q-33 up to 93 exceeds 6 bits)
            q = pq.astype(jnp.int32)
        else:  # quals: 4 per 3 bytes
            pq3 = pq.reshape(B, L // 4, 3).astype(jnp.uint32)
            v = pq3[:, :, 0] | (pq3[:, :, 1] << 8) | (pq3[:, :, 2] << 16)
            q = jnp.stack([(v >> (6 * k)) & 63 for k in range(4)], axis=-1)
            q = q.reshape(B, L).astype(jnp.int32)
        return code5, q

    def step(carry, pb, nm, pq, lengths, n_valid, direction, qual_bits):
        B = pb.shape[0]
        L = pb.shape[1] * 4
        code5, q = unpack(pb, nm, pq, B, L, qual_bits)
        pos = jax.lax.broadcasted_iota(jnp.int32, (B, L), 1)
        mask = pos < lengths[:, None]
        q = jnp.where(mask, q, 0)
        # rows < n_valid are real reads (a real read may have length 0 and
        # still counts); rows beyond are bucket padding
        row_real = jnp.arange(B) < n_valid

        counts5 = jnp.stack([
            jnp.sum((code5 == c) & mask, axis=0, dtype=jnp.int32)
            for c in range(5)])                                    # [5, L]
        qsum_cycle = jnp.sum(q, axis=0, dtype=jnp.int32)           # [L]
        read_qsum = jnp.sum(q, axis=1, dtype=jnp.int32)            # [B]

        q_or_sentinel = jnp.where(mask, q, QHIST_SIZE)
        qhist = jnp.sum(
            q_or_sentinel[:, :, None] == jnp.arange(QHIST_SIZE + 1)[None, None, :],
            axis=(0, 1), dtype=jnp.int32)[:QHIST_SIZE]

        # per-read tail stats, fully on device (StatisticsReads.cpp:66-80).
        # All derived in EXACT integer arithmetic — no x64 on device needed:
        #   floor(qsum/len + 0.5)  ==  (2*qsum + len) // (2*len)
        #   qsum/len >= 20         ==  qsum >= 20*len
        #   floor(qsum/len)        ==  qsum // len
        valid = row_real & (lengths > 0)
        safe_len = jnp.where(valid, lengths, 1)
        q20 = jnp.sum(valid & (read_qsum >= 20 * lengths), dtype=jnp.int32)
        rounded = (2 * read_qsum + lengths) // (2 * safe_len)
        rq_idx = jnp.where(valid, jnp.clip(rounded, 0, 99), 100)
        read_q_hist = jnp.sum(
            rq_idx[:, None] == jnp.arange(101)[None, :],
            axis=0, dtype=jnp.int32)[:100]
        # Histogram(0, 60, 1).inc(mean_q, ignore_bounds=True)
        hidx = read_qsum // safe_len
        hidx = jnp.where(read_qsum == 60 * lengths, 59, hidx)
        hidx = jnp.where(valid & (read_qsum <= 60 * lengths), hidx, 61)
        qdist = jnp.sum(hidx[:, None] == jnp.arange(62)[None, :],
                        axis=0, dtype=jnp.int32)[:60]
        # read-length histogram over real rows (bin 0 = real empty reads)
        len_idx = jnp.clip(lengths, 0, L)
        len_hist = jnp.sum(
            jnp.where(row_real, len_idx, -1)[:, None] == jnp.arange(0, L + 1)[None, :],
            axis=0, dtype=jnp.int32)                                # lengths 0..L

        fwd = direction == 0
        n_batch = jnp.sum(row_real, dtype=jnp.int32)
        carry = dict(
            counts5=carry["counts5"] + counts5,
            qsum1=carry["qsum1"] + (qsum_cycle if fwd else 0),
            qsum2=carry["qsum2"] + (0 if fwd else qsum_cycle),
            qhist=carry["qhist"] + qhist,
            read_q_hist=carry["read_q_hist"] + read_q_hist,
            q20=carry["q20"] + q20,
            qdist1=carry["qdist1"] + (qdist if fwd else 0),
            qdist2=carry["qdist2"] + (0 if fwd else qdist),
            len_hist=carry["len_hist"] + len_hist,
            n_fwd=carry["n_fwd"] + (n_batch if fwd else 0),
            n_rev=carry["n_rev"] + (0 if fwd else n_batch),
            bases=carry["bases"] + jnp.sum(lengths, dtype=jnp.int32),
        )
        return carry

    return step


def stream_step():
    global _STREAM_JIT
    if _STREAM_JIT is None:
        import jax
        _STREAM_JIT = jax.jit(_build_stream_step(),
                              donate_argnums=(0,), static_argnums=(6, 7))
    return _STREAM_JIT


def stream_carry_init(L: int):
    """Fresh on-device accumulator set for max cycle count L."""
    import jax.numpy as jnp
    # int32 carries: the wrapper spills to 64-bit host accumulators every
    # few million reads or 2^30 bases (DeviceReadStream), before any
    # int32 bin can overflow — device x64 is never needed
    return dict(
        counts5=jnp.zeros((5, L), jnp.int32),
        qsum1=jnp.zeros(L, jnp.int32),
        qsum2=jnp.zeros(L, jnp.int32),
        qhist=jnp.zeros(QHIST_SIZE, jnp.int32),
        read_q_hist=jnp.zeros(100, jnp.int32),
        q20=jnp.zeros((), jnp.int32),
        qdist1=jnp.zeros(60, jnp.int32),
        qdist2=jnp.zeros(60, jnp.int32),
        len_hist=jnp.zeros(L + 1, jnp.int32),
        n_fwd=jnp.zeros((), jnp.int32),
        n_rev=jnp.zeros((), jnp.int32),
        bases=jnp.zeros((), jnp.int32),
    )


def stream_carry_grow(carry, L: int):
    """Pad the cycle-indexed accumulators to a larger max length."""
    import jax.numpy as jnp
    old = carry["counts5"].shape[1]
    if L <= old:
        return carry
    pad = L - old
    carry = dict(carry)
    carry["counts5"] = jnp.pad(carry["counts5"], ((0, 0), (0, pad)))
    carry["qsum1"] = jnp.pad(carry["qsum1"], (0, pad))
    carry["qsum2"] = jnp.pad(carry["qsum2"], (0, pad))
    carry["len_hist"] = jnp.pad(carry["len_hist"], (0, pad))
    return carry


def pack_batch(bases: np.ndarray, quals: np.ndarray, qual_bits: int = 6):
    """2-bit+Nmask base packing via the native kernel (numpy fallback);
    quals pack to 6 bits (standard Illumina range) or stay at 8 bits minus
    offset when qual_bits=8 (long-read range, q-33 up to 93)."""
    B, L = bases.shape
    assert L % 8 == 0, "pack_batch needs L % 8 == 0 (bucketed shapes)"
    pb = np.empty((B, L // 4), np.uint8)
    nm = np.empty((B, L // 8), np.uint8)
    pq = np.empty((B, L // 4 * 3), np.uint8)
    from ..io.native import get_lib
    lib = get_lib()
    if lib is not None and bases.flags.c_contiguous and quals.flags.c_contiguous:
        lib.ngs_pack_batch(bases, quals, B, L, pb, nm, pq)
        if qual_bits == 8:
            pq = np.where(quals >= 33, quals - 33, 0).astype(np.uint8)
        return pb, nm, pq
    code_map = np.zeros(256, np.uint8)
    for i, c in enumerate(b"ACGT"):
        code_map[c] = i
    is_acgtn = np.zeros(256, bool)
    for c in b"ACGT":
        is_acgtn[c] = True
    codes = code_map[bases]
    shifts = (np.arange(L) % 4 * 2).astype(np.uint8)
    pb[:] = np.bitwise_or.reduce(
        (codes << shifts).reshape(B, L // 4, 4), axis=2)
    nbit = (~is_acgtn[bases]).astype(np.uint8)
    nm[:] = np.packbits(nbit.reshape(B, L // 8, 8)[:, :, ::-1], axis=2).reshape(B, L // 8)
    if qual_bits == 8:
        q8 = np.where(quals >= 33, quals - 33, 0).astype(np.uint8)
        # fall through for pb/nm below, then swap in the 8-bit quals
    q = np.clip(quals.astype(np.int32) - 33, 0, 63).astype(np.uint32)
    v = (q.reshape(B, L // 4, 4) << (np.arange(4, dtype=np.uint32) * 6)).sum(
        axis=2, dtype=np.uint32)
    pq3 = pq.reshape(B, L // 4, 3)
    pq3[:, :, 0] = v & 0xFF
    pq3[:, :, 1] = (v >> 8) & 0xFF
    pq3[:, :, 2] = (v >> 16) & 0xFF
    if qual_bits == 8:
        return pb, nm, q8
    return pb, nm, pq
