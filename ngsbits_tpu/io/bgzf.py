"""BGZF block compression (for .vcf.gz output and BAM writing).

BGZF = gzip members of <=64KB with a BC extra field carrying the compressed
block size (SAM spec §4.1); readers live in native/ngshost.cpp and io/bam.py.
"""

from __future__ import annotations

import struct
import zlib

_EOF_BLOCK = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")


def _one_block(data: bytes, level: int = 6) -> bytes:
    from . import native
    lib = native.get_lib()
    if lib is not None:
        import numpy as np
        arr = np.frombuffer(data, dtype=np.uint8)
        cap = len(data) + len(data) // 8 + 256
        out = np.empty(cap, dtype=np.uint8)
        n = lib.ngs_bgzf_block(arr, len(data), level, out, cap)
        if n > 0:
            return out[:int(n)].tobytes()
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    cdata = co.compress(data) + co.flush()
    bsize = len(cdata) + 25 + 1  # header(12)+extra(6)+payload+crc(4)+isize(4) -1 stored
    header = struct.pack("<4BI2BH2B2H",
                         0x1F, 0x8B, 8, 4,  # magic, CM=deflate, FLG=FEXTRA
                         0,                 # MTIME
                         0, 0xFF,           # XFL, OS
                         6,                 # XLEN
                         0x42, 0x43,        # 'B' 'C'
                         2,                 # SLEN
                         bsize - 1)         # BSIZE-1
    tail = struct.pack("<II", zlib.crc32(data) & 0xFFFFFFFF, len(data))
    return header + cdata + tail


def bgzf_compress(data: bytes, level: int = 6, block_size: int = 0xFF00,
                  eof: bool = True, pool=None) -> bytes:
    """BGZF-compress data; ``eof=False`` omits the trailing EOF block so
    callers can stream several parts and terminate once. With a thread
    `pool` (concurrent.futures) the independent blocks compress in
    parallel (the native compressor releases the GIL)."""
    chunks = [data[off:off + block_size]
              for off in range(0, len(data), block_size)]
    parts = list((pool.map if pool else map)(
        lambda c: _one_block(c, level), chunks))
    if eof:
        parts.append(_EOF_BLOCK)
    return b"".join(parts)
