"""Streaming gzip FASTQ reader/writer producing fixed-width uint8 tensors.

Behavioral reference: ngs-bits ``FastqFileStream``/``FastqEntry``
(cppNGS/FastqFileStream.{h,cpp}): 4-line records, base alphabet ACGTN,
quality chars 33..74 (33..126 with long_read), gzip output.

Batched design: instead of per-read objects, reads stream in *batches* —
``FastqBatch`` holds ``bases``/``quals`` as [B, Lmax] uint8 arrays (ASCII
codes, zero-padded) plus a length vector, ready for ``jax.device_put``.
Headers are kept as raw bytes only when a consumer (e.g. the trimmer's
writer) needs them.
"""

from __future__ import annotations

import gzip
import io
import zlib
from dataclasses import dataclass

import numpy as np

_VALID_BASES = np.zeros(256, dtype=bool)
for _b in b"ACGTN":
    _VALID_BASES[_b] = True


class FastqBatch:
    """Batch of FASTQ records as padded [B, Lmax] arrays.

    ``bases``/``quals`` may be constructed LAZILY from flat concatenated
    buffers (``bases_flat``/``quals_flat``): the native reader defers the
    pad-copy so it runs on the CONSUMER's thread, overlapping the reader
    thread's decode+parse (the pad of a 1.5 GB FASTQ costs ~1 s on this
    host — pipelined instead of serialized)."""

    def __init__(self, bases=None, quals=None, lengths=None, headers=None,
                 headers2=None, qual_lengths=None,
                 h1_flat=None, h1_starts=None, h1_lens=None,
                 h2_flat=None, h2_starts=None, h2_lens=None,
                 bases_flat=None, quals_flat=None,
                 scan_src=None, bases_offsets=None, quals_offsets=None,
                 validate_gather=False, qual_max=74):
        self._bases = bases          # [B, Lmax] uint8 ASCII, zero-padded
        self._quals = quals          # [B, Lmax] uint8 ASCII, zero-padded
        self._bases_flat = bases_flat
        self._quals_flat = quals_flat
        # zero-copy scan representation: records live in the reader's decode
        # buffer; the pad-copy is gathered straight from it on first access
        # (scan_src keeps the native handle alive, see _NativeFastqHandle)
        self._scan_src = scan_src
        self._bases_offsets = bases_offsets
        self._quals_offsets = quals_offsets
        self._validate_gather = validate_gather
        self._qual_max = qual_max
        self.lengths = lengths       # [B] int32
        self.headers = headers       # list[bytes] (without trailing newline)
        self.headers2 = headers2     # list[bytes] ('+' lines)
        # qual_lengths differs from lengths only for malformed records read
        # with validation off (ref passthrough)
        self.qual_lengths = qual_lengths
        # flat-header representation (native hot path, avoids per-read bytes
        # objects): concatenated buffers + starts/lens per record
        self.h1_flat = h1_flat
        self.h1_starts = h1_starts
        self.h1_lens = h1_lens
        self.h2_flat = h2_flat
        self.h2_starts = h2_starts
        self.h2_lens = h2_lens

    def _gather(self, offsets, lens, validate_mode, out=None):
        n = len(lens)
        lmax = int(lens.max()) if n else 0
        dst = np.empty((n, lmax), dtype=np.uint8) if out is None else out
        if n:
            bad = np.zeros(3, dtype=np.int64)
            rc = self._scan_src.lib.ngs_pad_gather(
                self._scan_src.buf_ptr, offsets, lens, n, lmax, dst,
                validate_mode if self._validate_gather else 0,
                self._qual_max, bad)
            if rc == 1:
                raise ValueError("Invalid Fastq file entry: Invalid base "
                                 f"'{chr(int(bad[2]))}' encountered")
            if rc == 2:
                raise ValueError("Invalid Fastq file entry: Invalid quality "
                                 f"character with value '{int(bad[2])}' encountered")
        return dst

    def gather_into(self, bufs: dict) -> "FastqBatch":
        """Scan batches only: materialize the padded arrays into caller-owned
        REUSABLE buffers (a dict the caller passes to every call) instead of
        fresh allocations — a worker that consumes one batch at a time avoids
        page-faulting ~60 MB of new arrays per batch. The returned batch's
        arrays are views into ``bufs`` and are only valid until the next
        ``gather_into`` with the same dict."""
        if self._scan_src is None or self._bases is not None:
            return self
        n = len(self.lengths)
        for key, lens in (("b", self.lengths), ("q", self.qlen())):
            lmax = int(lens.max()) if n else 0
            need = n * lmax
            if bufs.get(key) is None or bufs[key].size < need:
                bufs[key] = np.empty(max(need, 1), np.uint8)
            arr = self._gather(
                self._bases_offsets if key == "b" else self._quals_offsets,
                lens, 1 if key == "b" else 2,
                out=bufs[key][:need].reshape(n, lmax))
            if key == "b":
                self._bases = arr
            else:
                self._quals = arr
        return self

    @property
    def bases(self) -> np.ndarray:
        if self._bases is None:
            if self._scan_src is not None:
                self._bases = self._gather(self._bases_offsets, self.lengths, 1)
            else:
                self._bases = _pad_flat(self._bases_flat, self.lengths)
                self._bases_flat = None
        return self._bases

    @bases.setter
    def bases(self, v):
        self._bases = v

    @property
    def quals(self) -> np.ndarray:
        if self._quals is None:
            if self._scan_src is not None:
                self._quals = self._gather(self._quals_offsets, self.qlen(), 2)
            else:
                self._quals = _pad_flat(self._quals_flat, self.qlen())
                self._quals_flat = None
        return self._quals

    @quals.setter
    def quals(self, v):
        self._quals = v


    def __len__(self) -> int:
        return len(self.lengths)

    def qlen(self) -> np.ndarray:
        return self.lengths if self.qual_lengths is None else self.qual_lengths

    def has_flat_headers(self) -> bool:
        return self.h1_flat is not None

    def header_bytes(self, i: int) -> bytes:
        if self.headers is not None:
            return self.headers[i]
        s = int(self.h1_starts[i])
        return self.h1_flat[s:s + int(self.h1_lens[i])].tobytes()

    def materialize_headers(self):
        """Fill the list representation from the flat buffers (fallback for
        consumers that index headers per read)."""
        if self.headers is not None or self.h1_flat is None:
            return
        self.headers = _flat_to_list(self.h1_flat, self.h1_starts, self.h1_lens)
        self.headers2 = _flat_to_list(self.h2_flat, self.h2_starts, self.h2_lens)


def _flat_to_list(flat: np.ndarray, starts: np.ndarray, lens: np.ndarray) -> list:
    buf = flat.tobytes()
    return [buf[s:s + n] for s, n in zip(starts.tolist(), lens.tolist())]


def _starts_of(lens: np.ndarray) -> np.ndarray:
    starts = np.empty(len(lens), dtype=np.int64)
    if len(lens):
        starts[0] = 0
        np.cumsum(lens[:-1], dtype=np.int64, out=starts[1:])
    return starts


def _pad_2d(parts: list, lengths: np.ndarray, pad_to: int | None = None) -> np.ndarray:
    """Pack a list of byte strings into a zero-padded [B, Lmax] uint8 array."""
    n = len(parts)
    lmax = int(lengths.max()) if n else 0
    if pad_to is not None:
        lmax = max(lmax, pad_to)
    if n == 0:
        return np.zeros((0, lmax), dtype=np.uint8)
    if lengths.min() == lengths.max() and (pad_to is None or pad_to == lengths.max()):
        flat = np.frombuffer(b"".join(parts), dtype=np.uint8)
        return flat.reshape(n, lmax).copy()
    arr = np.zeros((n, lmax), dtype=np.uint8)
    flat = np.frombuffer(b"".join(parts), dtype=np.uint8)
    total = int(lengths.sum())
    rows = np.repeat(np.arange(n), lengths)
    starts = np.concatenate(([0], np.cumsum(lengths[:-1]))) if n > 1 else np.zeros(1, np.int64)
    cols = np.arange(total, dtype=np.int64) - np.repeat(starts, lengths)
    arr[rows, cols] = flat
    return arr


def _pad_flat(flat: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Pack a flat concatenated byte buffer into a zero-padded [B, Lmax]
    uint8 array (native decode path — C memcpy rows, numpy fallback)."""
    n = len(lengths)
    lmax = int(lengths.max()) if n else 0
    if n == 0:
        return np.zeros((0, lmax), dtype=np.uint8)
    from . import native
    lib = native.get_lib()
    if lib is not None:
        arr = np.empty((n, lmax), dtype=np.uint8)
        lib.ngs_pad_flat(np.ascontiguousarray(flat),
                         np.ascontiguousarray(lengths, dtype=np.int32),
                         n, lmax, arr)
        return arr
    lengths = lengths.astype(np.int64)
    if lengths.min() == lengths.max():
        return flat[:n * lmax].reshape(n, lmax).copy()
    arr = np.zeros((n, lmax), dtype=np.uint8)
    total = int(lengths.sum())
    rows = np.repeat(np.arange(n), lengths)
    starts = np.concatenate(([0], np.cumsum(lengths[:-1]))) if n > 1 else np.zeros(1, np.int64)
    cols = np.arange(total, dtype=np.int64) - np.repeat(starts, lengths)
    arr[rows, cols] = flat[:total]
    return arr


def validate_flat(bases_flat: np.ndarray, quals_flat: np.ndarray,
                  long_read: bool = False, filename: str = ""):
    """validate_batch on flat concatenated buffers — same checks, no padded
    array needed (used by the native reader so padding can stay lazy)."""
    qmax = 126 if long_read else 74
    from . import native
    lib = native.get_lib()
    nb, nq = int(bases_flat.size), int(quals_flat.size)
    if lib is not None and bases_flat.flags.c_contiguous \
            and quals_flat.flags.c_contiguous and nb == nq:
        bad = np.zeros(3, dtype=np.int64)
        rc = lib.ngs_validate_batch(
            bases_flat, quals_flat,
            np.array([nb], dtype=np.int32), np.array([nq], dtype=np.int32),
            1, nb, qmax, bad)
        if rc == 1:
            raise ValueError(
                f"Invalid Fastq file entry: Invalid base '{chr(int(bad[2]))}' encountered"
                + (f" in '{filename}'" if filename else ""))
        if rc == 2:
            raise ValueError(
                f"Invalid Fastq file entry: Invalid quality character with value "
                f"'{int(bad[2])}' encountered" + (f" in '{filename}'" if filename else ""))
        return
    if not _VALID_BASES[bases_flat].all():
        bad_b = bases_flat[~_VALID_BASES[bases_flat]][0]
        raise ValueError(
            f"Invalid Fastq file entry: Invalid base '{chr(int(bad_b))}' encountered"
            + (f" in '{filename}'" if filename else ""))
    bad_q = (quals_flat < 33) | (quals_flat > qmax)
    if bad_q.any():
        raise ValueError(
            f"Invalid Fastq file entry: Invalid quality character with value "
            f"'{int(quals_flat[bad_q][0])}' encountered"
            + (f" in '{filename}'" if filename else ""))


def validate_batch(batch: FastqBatch, long_read: bool = False, filename: str = ""):
    """Vectorized analogue of FastqEntry::validate (FastqFileStream.cpp:3-42)."""
    qmax = 126 if long_read else 74
    from . import native
    lib = native.get_lib()
    if (lib is not None and batch.bases.flags.c_contiguous
            and batch.quals.flags.c_contiguous
            and batch.bases.shape == batch.quals.shape):
        bad = np.zeros(3, dtype=np.int64)
        rc = lib.ngs_validate_batch(
            batch.bases, batch.quals,
            np.ascontiguousarray(batch.lengths, dtype=np.int32),
            np.ascontiguousarray(batch.qlen(), dtype=np.int32),
            batch.bases.shape[0], batch.bases.shape[1], qmax, bad)
        if rc == 1:
            raise ValueError(
                f"Invalid Fastq file entry: Invalid base '{chr(int(bad[2]))}' encountered"
                + (f" in '{filename}'" if filename else ""))
        if rc == 2:
            raise ValueError(
                f"Invalid Fastq file entry: Invalid quality character with value "
                f"'{int(bad[2])}' encountered" + (f" in '{filename}'" if filename else ""))
    else:
        pos = np.arange(batch.bases.shape[1])[None, :]
        mask = pos < batch.lengths[:, None]
        bad_base = (~_VALID_BASES[batch.bases]) & mask
        if bad_base.any():
            i, j = np.argwhere(bad_base)[0]
            raise ValueError(
                f"Invalid Fastq file entry: Invalid base '{chr(batch.bases[i, j])}' encountered"
                + (f" in '{filename}'" if filename else ""))
        q = batch.quals.astype(np.int16)
        qpos = np.arange(batch.quals.shape[1])[None, :]
        qmask = qpos < batch.qlen()[:, None]
        bad_q = ((q < 33) | (q > qmax)) & qmask
        if bad_q.any():
            i, j = np.argwhere(bad_q)[0]
            raise ValueError(
                f"Invalid Fastq file entry: Invalid quality character with value "
                f"'{int(q[i, j])}' encountered" + (f" in '{filename}'" if filename else ""))
    validate_headers(batch)


def validate_headers(batch: FastqBatch):
    """Header-line checks of FastqEntry::validate ('@'/'+' prefixes)."""
    if batch.headers is not None:
        for h in batch.headers:
            if not h.startswith(b"@"):
                raise ValueError("Invalid Fastq file entry: First header line does not start with '@'")
    elif batch.h1_flat is not None:
        # empty header lines fail too — and must be excluded before the
        # gather (their start offset can equal len(flat))
        nonempty = batch.h1_lens > 0
        if (not nonempty.all()
                or not (batch.h1_flat[batch.h1_starts[nonempty]] == ord("@")).all()):
            raise ValueError("Invalid Fastq file entry: First header line does not start with '@'")
    if batch.headers2 is not None:
        for h in batch.headers2:
            if not h.startswith(b"+"):
                raise ValueError("Invalid Fastq file entry: Second header line does not start with '+'")
    elif batch.h2_flat is not None:
        nonempty = batch.h2_lens > 0
        if (not nonempty.all()
                or not (batch.h2_flat[batch.h2_starts[nonempty]] == ord("+")).all()):
            raise ValueError("Invalid Fastq file entry: Second header line does not start with '+'")


class _NativeFastqHandle:
    """Owns a native FASTQ reader handle for the zero-copy scan path.

    Scan batches gather their padded arrays straight from the handle's
    decode buffer, so the handle must outlive every batch that references
    it — it is closed by refcount (CPython GC) once the reader generator
    AND all outstanding batches have dropped it."""

    def __init__(self, lib, h):
        self.lib = lib
        self._h = h
        self.buf_ptr = lib.ngs_fastq_buf_ptr(h)

    # copies share the one native handle — the LAST reference closes it
    # (deep-copying would duplicate the raw pointer and double-close)
    def __copy__(self):
        return self

    def __deepcopy__(self, memo):
        return self

    def __del__(self):
        h = getattr(self, "_h", None)
        self._h = None
        if h is not None:
            self.lib.ngs_fastq_close(h)


class FastqReader:
    """Streams a (gzip or plain) FASTQ file as FastqBatch objects.

    The gzip stream is decoded in large chunks and records are split with
    vectorized byte operations — no per-read Python loop.
    """

    def __init__(self, filename: str, batch_reads: int = 1 << 16,
                 keep_headers: bool = False, validate: bool = True,
                 long_read: bool = False, chunk_bytes: int = 8 << 20,
                 flat_headers: bool = False):
        from .versatile import is_remote, local_path
        if is_remote(str(filename)):
            # VersatileFile parity: remote FASTQ fetches once, then the
            # native decoder handles it like any local file
            filename = local_path(filename)
        self.filename = filename
        self.batch_reads = batch_reads
        self.keep_headers = keep_headers
        self.validate = validate
        self.long_read = long_read
        self.chunk_bytes = chunk_bytes
        # flat_headers: keep headers as flat buffers + starts/lens instead of
        # per-read bytes objects (native hot path; falls back to lists when
        # the native decoder is unavailable)
        self.flat_headers = flat_headers
        self.reads_seen = 0

    def _open(self):
        raw = open(self.filename, "rb")
        head = raw.peek(2) if hasattr(raw, "peek") else b""
        raw.seek(0)
        magic = raw.read(2)
        raw.seek(0)
        if magic == b"\x1f\x8b":
            return gzip.open(raw, "rb")
        return raw

    def __iter__(self):
        from . import native
        if native.available() and not str(self.filename).startswith(("http://", "https://")):
            yield from self._iter_native(native.get_lib())
            return
        yield from self._iter_python()

    def _iter_native(self, lib):
        """Batched decode through the C++ splitter (native/ngshost.cpp
        ngs_fastq_read_batch): flat columnar buffers -> one vectorized pad.

        Plain-gz files that decode into one stable in-memory buffer take the
        ZERO-COPY scan path instead: the C side emits record offsets only and
        the padded arrays are gathered directly from the decode buffer on the
        consumer's thread (ngs_fastq_scan_batch + ngs_pad_gather)."""
        h = lib.ngs_fastq_open(str(self.filename).encode(), 1024)
        if not lib.ngs_fastq_ok(h):
            lib.ngs_fastq_close(h)
            raise IOError(f"Could not open FASTQ file '{self.filename}'")
        if not self.keep_headers:
            ready = lib.ngs_fastq_whole_ready(h)
            if ready == -1:
                err = lib.ngs_fastq_error(h).decode()
                lib.ngs_fastq_close(h)
                raise ValueError(err or f"gzip decode failed for '{self.filename}'")
            if ready == 1:
                yield from self._iter_native_scan(lib, h)
                return
        want = self.batch_reads
        seq_cap = max(want * 256, 1 << 20)
        hdr_cap = max(want * 128, 1 << 20)
        try:
            pending = []          # accumulated (bases, quals, h1, h2, lens, qlens, h1l, h2l)
            pending_n = 0
            eof = False
            while not eof:
                bases = np.empty(seq_cap, np.uint8)
                quals = np.empty(seq_cap, np.uint8)
                h1 = np.empty(hdr_cap, np.uint8)
                h2 = np.empty(hdr_cap, np.uint8)
                lens = np.empty(want, np.int32)
                qlens = np.empty(want, np.int32)
                h1l = np.empty(want, np.int32)
                h2l = np.empty(want, np.int32)
                n = lib.ngs_fastq_read_batch(
                    h, want - pending_n, bases, quals, seq_cap,
                    h1, h2, hdr_cap, lens, qlens, h1l, h2l)
                if n == -2:       # one record larger than the buffers
                    seq_cap *= 4
                    hdr_cap *= 4
                    continue
                if n < 0:
                    raise ValueError(
                        f"FASTQ file '{self.filename}' has a line count that "
                        "is not a multiple of 4"
                        if b"multiple of 4" in lib.ngs_fastq_error(h)
                        else lib.ngs_fastq_error(h).decode())
                if n == 0:
                    eof = True
                else:
                    pending.append((bases, quals, h1, h2,
                                    lens[:n].copy(), qlens[:n].copy(),
                                    h1l[:n].copy(), h2l[:n].copy()))
                    pending_n += int(n)
                if pending_n and (pending_n >= want or eof):
                    yield self._native_batch(pending)
                    pending = []
                    pending_n = 0
        finally:
            lib.ngs_fastq_close(h)

    def _iter_native_scan(self, lib, h):
        """Zero-copy scan over the stable whole-file decode buffer."""
        src = _NativeFastqHandle(lib, h)
        want = self.batch_reads
        qmax = 126 if self.long_read else 74
        while True:
            b_off = np.empty(want, np.int64)
            b_len = np.empty(want, np.int32)
            q_off = np.empty(want, np.int64)
            q_len = np.empty(want, np.int32)
            n = lib.ngs_fastq_scan_batch(h, want, b_off, b_len, q_off, q_len,
                                         None, None, None, None)
            if n < 0:
                err = lib.ngs_fastq_error(h).decode()
                raise ValueError(
                    f"FASTQ file '{self.filename}' has a line count that "
                    "is not a multiple of 4"
                    if "multiple of 4" in err else err)
            if n == 0:
                return
            n = int(n)
            lens = b_len[:n]
            qlens = q_len[:n]
            same = np.array_equal(lens, qlens)
            if not same and self.validate:
                raise ValueError(
                    "Invalid Fastq file entry: Differing length of bases and "
                    "qualities string")
            self.reads_seen += n
            yield FastqBatch(
                lengths=lens,
                qual_lengths=None if same else qlens,
                scan_src=src,
                bases_offsets=b_off[:n], quals_offsets=q_off[:n],
                validate_gather=self.validate, qual_max=qmax)

    def _native_batch(self, segments) -> FastqBatch:
        if len(segments) == 1:
            # common case: zero-copy views into the freshly allocated buffers
            s = segments[0]
            lens, qlens = s[4], s[5]
            bases_flat = s[0][:int(lens.sum(dtype=np.int64))]
            quals_flat = s[1][:int(qlens.sum(dtype=np.int64))]
        else:
            lens = np.concatenate([s[4] for s in segments])
            qlens = np.concatenate([s[5] for s in segments])
            bases_flat = np.concatenate(
                [s[0][:int(s[4].sum(dtype=np.int64))] for s in segments])
            quals_flat = np.concatenate(
                [s[1][:int(s[5].sum(dtype=np.int64))] for s in segments])
        n = len(lens)
        same = np.array_equal(lens, qlens)
        if not same and self.validate:
            i = int(np.argwhere(lens != qlens)[0])
            hdr = self._native_header(segments, i, 2)
            raise ValueError(
                "Invalid Fastq file entry: Differing length of bases and "
                f"qualities string in sequence '{hdr.decode(errors='replace')}'.")
        headers = headers2 = None
        flat_kw = {}
        if self.keep_headers and self.flat_headers:
            h1_flat, h1_lens = self._native_headers_flat(segments, 2, 6)
            h2_flat, h2_lens = self._native_headers_flat(segments, 3, 7)
            flat_kw = dict(
                h1_flat=h1_flat, h1_lens=h1_lens,
                h1_starts=_starts_of(h1_lens),
                h2_flat=h2_flat, h2_lens=h2_lens,
                h2_starts=_starts_of(h2_lens),
            )
        elif self.keep_headers:
            headers = self._native_headers(segments, 2, 6)
            headers2 = self._native_headers(segments, 3, 7)
        batch = FastqBatch(
            bases_flat=bases_flat,
            quals_flat=quals_flat,
            lengths=lens,
            headers=headers,
            headers2=headers2,
            qual_lengths=None if same else qlens,
            **flat_kw,
        )
        self.reads_seen += n
        if self.validate:
            # validate on the FLAT buffers — the padded [B, L] arrays stay
            # lazy so their pad-copy runs on the consumer's thread
            validate_flat(bases_flat, quals_flat, self.long_read, self.filename)
            validate_headers(batch)
        return batch

    @staticmethod
    def _native_headers_flat(segments, buf_idx, len_idx):
        """Concatenated header buffer + per-record lens (no bytes objects)."""
        if len(segments) == 1:
            s = segments[0]
            lens = s[len_idx]
            return s[buf_idx][:int(lens.sum(dtype=np.int64))], lens
        lens = np.concatenate([s[len_idx] for s in segments])
        flat = np.concatenate(
            [s[buf_idx][:int(s[len_idx].sum(dtype=np.int64))] for s in segments])
        return flat, lens

    @staticmethod
    def _native_headers(segments, buf_idx, len_idx) -> list:
        out = []
        for s in segments:
            buf = s[buf_idx]
            pos = 0
            for ln in s[len_idx]:
                out.append(buf[pos:pos + ln].tobytes())
                pos += int(ln)
        return out

    @staticmethod
    def _native_header(segments, target, buf_idx=2) -> bytes:
        i = 0
        for s in segments:
            buf, hlens = s[buf_idx], s[6]
            pos = 0
            for ln in hlens:
                if i == target:
                    return buf[pos:pos + ln].tobytes()
                pos += int(ln)
                i += 1
        return b""

    def _iter_python(self):
        leftover = b""
        pending_lines: list[bytes] = []
        with self._open() as fh:
            while True:
                chunk = fh.read(self.chunk_bytes)
                if not chunk:
                    break
                data = leftover + chunk
                # NOTE: '\r' is intentionally preserved — the reference's
                # FastqFileStream keeps it (pinned by the CRLF FastqConcat
                # golden); validation rejects it, like the reference.
                nl = data.rfind(b"\n")
                if nl < 0:
                    leftover = data
                    continue
                leftover = data[nl + 1:]
                pending_lines.extend(data[:nl].split(b"\n"))
                while len(pending_lines) >= 4 * self.batch_reads:
                    take = 4 * self.batch_reads
                    yield self._make_batch(pending_lines[:take])
                    del pending_lines[:take]
            if leftover:
                pending_lines.append(leftover)
            # NOTE: empty lines are legitimate (zero-length reads), so no
            # trailing-blank cleanup — the split logic never produces a
            # terminator artifact (the final newline ends up in `leftover`).
            if pending_lines:
                if len(pending_lines) % 4 == 3:
                    # final empty quality line with no trailing newline —
                    # the reference's line reader yields it as empty at EOF
                    pending_lines.append(b"")
                if len(pending_lines) % 4 != 0:
                    raise ValueError(
                        f"FASTQ file '{self.filename}' has a line count that is not a multiple of 4")
                for start in range(0, len(pending_lines), 4 * self.batch_reads):
                    yield self._make_batch(pending_lines[start:start + 4 * self.batch_reads])

    def _make_batch(self, lines: list) -> FastqBatch:
        bases = lines[1::4]
        quals = lines[3::4]
        n = len(bases)
        lengths = np.fromiter((len(b) for b in bases), dtype=np.int32, count=n)
        qlengths = np.fromiter((len(q) for q in quals), dtype=np.int32, count=n)
        if not np.array_equal(lengths, qlengths):
            if self.validate:
                i = int(np.argwhere(lengths != qlengths)[0])
                raise ValueError(
                    "Invalid Fastq file entry: Differing length of bases and qualities string "
                    f"in sequence '{lines[4 * i].decode(errors='replace')}'.")
        batch = FastqBatch(
            bases=_pad_2d(bases, lengths),
            quals=_pad_2d(quals, qlengths),
            lengths=lengths,
            headers=lines[0::4] if self.keep_headers else None,
            headers2=lines[2::4] if self.keep_headers else None,
            qual_lengths=None if np.array_equal(lengths, qlengths) else qlengths,
        )
        self.reads_seen += n
        if self.validate:
            validate_batch(batch, self.long_read, self.filename)
        return batch


_GZIP_MEMBER_LIB = ()   # unset sentinel


def _gzip_member_lib():
    """The native lib when whole-buffer gzip members are available
    (libdeflate-backed ngs_gzip_member), else None."""
    global _GZIP_MEMBER_LIB
    if _GZIP_MEMBER_LIB == ():
        from . import native
        lib = native.get_lib()
        if lib is not None:
            out = np.empty(64, dtype=np.uint8)
            n = lib.ngs_gzip_member(np.empty(0, dtype=np.uint8), 0, 1, out, 64)
            _GZIP_MEMBER_LIB = lib if n > 0 else None
        else:
            _GZIP_MEMBER_LIB = None
    return _GZIP_MEMBER_LIB


def _format_batch(batch: FastqBatch, keep, lengths) -> bytes:
    lens = batch.lengths if lengths is None else lengths
    qlens = batch.qlen() if lengths is None else lengths
    if batch.headers is None and batch.has_flat_headers():
        from . import native
        lib = native.get_lib()
        if (lib is not None and batch.bases.flags.c_contiguous
                and batch.quals.flags.c_contiguous
                and batch.bases.shape == batch.quals.shape):
            return _format_batch_native(lib, batch, keep, lens, qlens)
        batch.materialize_headers()
    idx = range(len(batch)) if keep is None else np.flatnonzero(keep)
    parts = []
    bases = batch.bases
    quals = batch.quals
    for i in idx:
        li = int(lens[i])
        parts.append(batch.headers[i])
        parts.append(b"\n")
        parts.append(bases[i, :li].tobytes())
        parts.append(b"\n")
        parts.append(batch.headers2[i])
        parts.append(b"\n")
        parts.append(quals[i, :int(qlens[i])].tobytes())
        parts.append(b"\n")
    return b"".join(parts)


def _format_batch_native(lib, batch: FastqBatch, keep, lens, qlens) -> bytes:
    import ctypes as ct
    B = len(batch)
    lens32 = np.ascontiguousarray(lens, dtype=np.int32)
    qlens32 = np.ascontiguousarray(qlens, dtype=np.int32)
    if keep is None:
        total = int(lens32.sum(dtype=np.int64) + qlens32.sum(dtype=np.int64)
                    + batch.h1_lens.sum(dtype=np.int64)
                    + batch.h2_lens.sum(dtype=np.int64) + 4 * B)
        keep_ptr = None
    else:
        keep_u8 = np.ascontiguousarray(keep, dtype=np.uint8)
        k = keep_u8.astype(bool)
        total = int(lens32[k].sum(dtype=np.int64) + qlens32[k].sum(dtype=np.int64)
                    + batch.h1_lens[k].sum(dtype=np.int64)
                    + batch.h2_lens[k].sum(dtype=np.int64) + 4 * int(k.sum()))
        keep_ptr = keep_u8.ctypes.data_as(ct.c_void_p)
    out = np.empty(total, dtype=np.uint8)
    w = lib.ngs_fastq_format(
        batch.bases, batch.quals, B, batch.bases.shape[1],
        lens32, qlens32,
        np.ascontiguousarray(batch.h1_flat), batch.h1_starts,
        np.ascontiguousarray(batch.h1_lens, dtype=np.int32),
        np.ascontiguousarray(batch.h2_flat), batch.h2_starts,
        np.ascontiguousarray(batch.h2_lens, dtype=np.int32),
        keep_ptr, out, total)
    if w != total:
        raise RuntimeError("ngs_fastq_format size mismatch")
    return out.tobytes()


class FastqWriter:
    """Gzip FASTQ writer with a background compression worker per stream.

    Matches the reference default compression (Z_BEST_SPEED=1,
    FastqFileStream.cpp:160-193); mtime pinned to 0 for reproducible output
    bytes.  Formatting + gzip deflate run on a dedicated thread fed by a
    bounded queue — the analogue of the reference's per-output OutputWorker
    threads (SeqPurge/OutputWorker.cpp:23-32, Auxilary.h:89-97): with two
    output streams the two deflates overlap (zlib releases the GIL) and the
    analysis thread never blocks on compression.  Batch order is preserved
    per stream.  Pass ``async_io=False`` for a synchronous writer."""

    def __init__(self, filename: str, compression_level: int = 1,
                 async_io: bool = True, queue_depth: int = 16):
        import queue as _queue
        import threading as _threading

        self.filename = filename
        self._level = compression_level
        self._raw = open(filename, "wb")
        # member mode: each batch becomes its own complete gzip member
        # (libdeflate whole-buffer compress, ~3x streaming zlib; multi-member
        # concatenation is valid gzip, same layout bgzip uses). Falls back
        # to a streaming GzipFile when the native library is unavailable.
        self._member_lib = _gzip_member_lib()
        self._members = 0
        self._fh = None
        if self._member_lib is None:
            self._fh = gzip.GzipFile(fileobj=self._raw, mode="wb",
                                     compresslevel=compression_level, mtime=0)
        self._queue = None
        self._worker = None
        self._error = None
        if async_io:
            self._queue = _queue.Queue(maxsize=queue_depth)
            self._worker = _threading.Thread(target=self._drain, daemon=True)
            self._worker.start()

    def _write_formatted(self, data: bytes):
        if self._member_lib is not None:
            if not data:
                return
            arr = np.frombuffer(data, dtype=np.uint8)
            cap = len(data) + len(data) // 8 + 256
            out = np.empty(cap, dtype=np.uint8)
            n = self._member_lib.ngs_gzip_member(arr, len(data), self._level,
                                                 out, cap)
            if n <= 0:
                raise RuntimeError("gzip member compression failed")
            self._raw.write(memoryview(out.data)[:int(n)])
            self._members += 1
        else:
            self._fh.write(data)

    def _drain(self):
        while True:
            item = self._queue.get()
            if item is None:
                return
            try:
                if self._error is None:
                    self._write_formatted(_format_batch(*item))
            except Exception as e:  # surfaced on the caller's next call/close
                self._error = e
            finally:
                self._queue.task_done()

    def _check_error(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def write_batch(self, batch: FastqBatch, keep: np.ndarray | None = None,
                    lengths: np.ndarray | None = None):
        """Write (a filtered subset of) a batch. `lengths` overrides the batch
        lengths (e.g. after trimming)."""
        if (batch.headers is None or batch.headers2 is None) and not batch.has_flat_headers():
            raise ValueError("FastqWriter requires batches read with keep_headers=True")
        if self._queue is not None:
            self._check_error()
            self._queue.put((batch, keep, lengths))
        else:
            self._write_formatted(_format_batch(batch, keep, lengths))

    def close(self):
        if self._worker is not None:
            self._queue.put(None)
            self._worker.join()
            self._worker = None
        if self._member_lib is not None:
            if self._members == 0 and self._error is None:
                # a zero-byte file is not valid gzip — emit an empty member
                out = np.empty(64, dtype=np.uint8)
                n = self._member_lib.ngs_gzip_member(
                    np.empty(0, dtype=np.uint8), 0, self._level, out, 64)
                if n > 0:
                    self._raw.write(memoryview(out.data)[:int(n)])
        else:
            self._fh.close()
        self._raw.close()
        self._check_error()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class FastqEntry:
    """Per-read view for streaming tools (header/bases/header2/quals bytes)."""

    __slots__ = ("header", "bases", "header2", "quals")

    def __init__(self, header: bytes, bases: bytes, header2: bytes, quals: bytes):
        self.header = header
        self.bases = bases
        self.header2 = header2
        self.quals = quals

    def read_id(self) -> bytes:
        """Header without '@' and without the comment after the first space."""
        rid = self.header.strip()[1:]
        sp = rid.find(b" ")
        return rid if sp == -1 else rid[:sp]


def iter_entries(filename: str, validate: bool = False, long_read: bool = False):
    """Stream FastqEntry objects (batched decode under the hood)."""
    reader = FastqReader(filename, keep_headers=True, validate=validate,
                         long_read=long_read)
    for batch in reader:
        bases = batch.bases
        quals = batch.quals
        qlens = batch.qlen()
        for i in range(len(batch)):
            li = int(batch.lengths[i])
            qi = int(qlens[i])
            yield FastqEntry(batch.headers[i], bases[i, :li].tobytes(),
                             batch.headers2[i], quals[i, :qi].tobytes())


class FastqEntryWriter:
    """Per-entry gzip writer (buffers to batch the compressor; each flushed
    buffer becomes its own gzip member via libdeflate when available).
    ``flush_entries`` caps the number of buffered entries (BamToFastq's
    -write_buffer_size); otherwise flushing is byte-bounded."""

    def __init__(self, filename: str, compression_level: int = 1,
                 flush_entries: int | None = None):
        self._flush_entries = flush_entries
        self._n_entries = 0
        self._level = compression_level
        self._raw = open(filename, "wb")
        self._member_lib = _gzip_member_lib()
        self._members = 0
        self._fh = None
        if self._member_lib is None:
            self._fh = gzip.GzipFile(fileobj=self._raw, mode="wb",
                                     compresslevel=compression_level, mtime=0)
        self._parts = []
        self._size = 0
        self._pending = bytearray()

    def _flush(self, force_compress: bool = False):
        # move buffered entries into the pending byte buffer (the
        # -write_buffer_size batching boundary); compression happens on the
        # byte bound so member framing stays independent of entry batching
        if self._parts:
            self._pending += b"".join(self._parts)
            self._parts = []
            self._size = 0
            self._n_entries = 0
        if not force_compress and len(self._pending) <= (4 << 20):
            return
        data = bytes(self._pending)
        self._pending = bytearray()
        if not data:
            return
        if self._member_lib is not None:
            arr = np.frombuffer(data, dtype=np.uint8)
            cap = len(data) + len(data) // 8 + 256
            out = np.empty(cap, dtype=np.uint8)
            n = self._member_lib.ngs_gzip_member(arr, len(data), self._level,
                                                 out, cap)
            if n <= 0:
                raise RuntimeError("gzip member compression failed")
            self._raw.write(memoryview(out.data)[:int(n)])
            self._members += 1
        else:
            self._fh.write(data)

    def write(self, e: FastqEntry):
        self._parts += [e.header, b"\n", e.bases, b"\n", e.header2, b"\n", e.quals, b"\n"]
        self._size += len(e.bases) * 2
        self._n_entries += 1
        if (self._size > (4 << 20)
                or (self._flush_entries is not None
                    and self._n_entries >= self._flush_entries)):
            self._flush()

    def close(self):
        self._flush(force_compress=True)
        if self._member_lib is not None:
            if self._members == 0:
                out = np.empty(64, dtype=np.uint8)
                n = self._member_lib.ngs_gzip_member(
                    np.empty(0, dtype=np.uint8), 0, self._level, out, 64)
                if n > 0:
                    self._raw.write(memoryview(out.data)[:int(n)])
        else:
            self._fh.close()
        self._raw.close()
