"""Smoke run of the device routes on a GPU, against the host path.

Run from the repository root:

    python chip_smoke.py                # one card: every default phase
    python chip_smoke.py --four-cards   # the mesh path on four cards

Default phases, each printing its parity result:

1. probe: platform, device kind and count as JAX reports them;
2. kernels: every device kernel of the ReadQC, SeqPurge, coverage, pileup
   and similarity routes, compiled for the card at real widths, compared
   with the host reference and timed (achieved bytes/s, memory analysis);
3. ReadQC: a 4M-pair 2x151 BGZF FASTQ sample through the CLI, GPU route
   against the host route (qcML identical but for creation/binary lines);
4. MappingQC -roi, BedCoverage, BedLowCoverage: a coordinate-sorted BAM of
   4M 2x150 reads on a ~5 Mb, 20k-region panel, GPU against host;
5. SeqPurge: 1M short-insert pairs, the device route
   (NGSBITS_SEQPURGE_NO_NATIVE=1 NGSBITS_DEVICE_ENGINES=1) against the
   native host route (trimmed FASTQ and qcML identical);
6. the GPU test lane, ``pytest -m gpu tests/``.

``--four-cards`` runs only ``__graft_entry__.dryrun_multichip(4)`` and
ReadQC, BedCoverage, MappingQC and SeqPurge with NGSBITS_MESH=1 on four
cards, each against its host-reference output, and checks that the input
shards landed on all four devices.

This process never initialises a JAX backend: every phase that uses a card
runs in one child process at a time (a JAX process reserves most of the
card's memory), GPU children with JAX_PLATFORMS=cuda so that a broken CUDA
plugin fails instead of falling back to the CPU, host-reference children
with JAX_PLATFORMS=cpu NGSBITS_DEVICE_ENGINES=0. Inputs are generated from
--seed into .smoke_data/ (gitignored) and reused by later runs. Any failed
phase exits non-zero. The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
DATA = REPO / ".smoke_data"
RESULT_TAG = "SMOKE_RESULT "

# Peak device-memory bandwidth by jax device_kind (NVIDIA H100 SXM5 data
# sheet: 80 GB HBM3 at 3.35 TB/s). A kind missing here gets no share.
PEAK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}

# GRCh38 primary chromosome lengths (the stub genome's .fai and BAM header)
HG38 = {
    "chr1": 248956422, "chr2": 242193529, "chr3": 198295559,
    "chr4": 190214555, "chr5": 181538259, "chr6": 170805979,
    "chr7": 159345973, "chr8": 145138636, "chr9": 138394717,
    "chr10": 133797422, "chr11": 135086622, "chr12": 133275309,
    "chr13": 114364328, "chr14": 107043718, "chr15": 101991189,
    "chr16": 90338345, "chr17": 83257441, "chr18": 80373285,
    "chr19": 58617616, "chr20": 64444167, "chr21": 46709983,
    "chr22": 50818468, "chrX": 156040895, "chrY": 57227415,
}

# SeqPurge's default adapters (TruSeq read 1 / read 2)
ADAPTER1 = b"AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"
ADAPTER2 = b"AGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGT"
ACGT = np.frombuffer(b"ACGT", np.uint8)
COMPLEMENT = np.zeros(256, np.uint8)
for _a, _b in zip(b"ACGTN", b"TGCAN"):
    COMPLEMENT[_a] = _b

# sample sizes of the default phases (--scale multiplies the read counts)
READQC_PAIRS = 4_000_000
BAM_PAIRS = 2_000_000
PANEL_REGIONS = 20_000
SEQPURGE_PAIRS = 1_000_000


# ------------------------------------------------------------ data synthesis

def read_arrays(rng, genome: np.ndarray, n: int, read_len: int,
                insert_mean: float, insert_sd: float):
    """n read pairs from random fragments of `genome` (2-bit codes).

    Inserts are drawn from a normal distribution (at least 20 bp); a read
    longer than its insert runs into its adapter. Qualities are
    NovaSeq-binned (Q2/12/23/37, worse towards the read end), about 0.2% of
    bases carry a substitution error and about 0.1% are N (quality Q2).
    Returns ASCII (bases1, quals1, bases2, quals2), each [n, read_len]."""
    L = read_len
    j = np.arange(L, dtype=np.int32)[None, :]
    ins = np.clip(rng.normal(insert_mean, insert_sd, n), 20, 1000).astype(np.int32)
    start = rng.integers(1000, len(genome) - 1000, n)
    fwd = np.lib.stride_tricks.sliding_window_view(ACGT[genome], L)
    rev = np.lib.stride_tricks.sliding_window_view(COMPLEMENT[ACGT[genome]][::-1], L)
    inside = j < ins[:, None]
    adapter_pos = np.maximum(j - ins[:, None], 0)
    tail1 = np.frombuffer(ADAPTER1 + b"A" * L, np.uint8)[adapter_pos]
    tail2 = np.frombuffer(ADAPTER2 + b"A" * L, np.uint8)[adapter_pos]
    b1 = np.where(inside, fwd[start], tail1)
    # read 2 starts at the fragment's last base, on the other strand
    b2 = np.where(inside, rev[len(genome) - start - ins], tail2)
    # per-cycle thresholds on a uint16 draw u: Q2 below t2 (and N below
    # 0.1%), Q12 below t12, Q23 below t23, Q37 above; worse with cycle
    f = np.arange(L) / L
    t2, t12, t23 = ((np.array(p) * 65536).astype(np.uint16)[None, :] for p in (
        0.005 + 0.005 * f, 0.025 + 0.025 * f, 0.07 + 0.08 * f))
    out = []
    for b in (b1, b2):
        e = rng.integers(0, 65536, (n, L), dtype=np.uint16)
        b = np.where(e < 131, ACGT[e & 3], b)
        u = rng.integers(0, 65536, (n, L), dtype=np.uint16)
        q = np.full((n, L), 35, np.uint8)
        q += np.uint8(10) * (u >= t2).view(np.uint8)
        q += np.uint8(11) * (u >= t12).view(np.uint8)
        q += np.uint8(14) * (u >= t23).view(np.uint8)
        b[u < 66] = ord("N")
        out += [b, q]
    return tuple(out)


def fastq_records(first_id: int, bases: np.ndarray, quals: np.ndarray,
                  mate: int) -> bytes:
    """Fixed-width FASTQ records '@smoke:<9-digit id> <mate>:N:0:1'."""
    n, L = bases.shape
    head = np.frombuffer(b"@smoke:", np.uint8)
    tail = np.frombuffer(f" {mate}:N:0:1\n".encode(), np.uint8)
    ids = np.arange(first_id, first_id + n, dtype=np.int64)
    digits = (ids[:, None] // 10 ** np.arange(8, -1, -1)) % 10 + 48
    W = len(head) + 9 + len(tail) + L + 3 + L + 1
    rec = np.empty((n, W), np.uint8)
    c = 0
    for part in (head, digits.astype(np.uint8), tail, bases,
                 np.frombuffer(b"\n+\n", np.uint8), quals,
                 np.frombuffer(b"\n", np.uint8)):
        w = part.shape[-1]
        rec[:, c:c + w] = part
        c += w
    return rec.tobytes()


def synth_pairs(path1: Path, path2: Path, n_pairs: int, seed: int,
                insert_mean: float, insert_sd: float, read_len: int = 151,
                pool=None):
    """Paired BGZF FASTQ files of n_pairs pairs (read_arrays)."""
    from ngsbits_tpu.io.bgzf import _EOF_BLOCK, bgzf_compress
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, 4_000_000, dtype=np.uint8)
    chunk = 200_000
    with open(f"{path1}.tmp", "wb") as f1, open(f"{path2}.tmp", "wb") as f2:
        for first in range(0, n_pairs, chunk):
            n = min(chunk, n_pairs - first)
            b1, q1, b2, q2 = read_arrays(rng, genome, n, read_len,
                                         insert_mean, insert_sd)
            for fh, b, q, mate in ((f1, b1, q1, 1), (f2, b2, q2, 2)):
                fh.write(bgzf_compress(fastq_records(first, b, q, mate),
                                       level=1, eof=False, pool=pool))
        f1.write(_EOF_BLOCK)
        f2.write(_EOF_BLOCK)
    os.replace(f"{path1}.tmp", path1)
    os.replace(f"{path2}.tmp", path2)


def _reg2bin(beg: np.ndarray, end: np.ndarray) -> np.ndarray:
    """SAM spec §5.3 reg2bin, vectorized."""
    end = end - 1
    out = np.zeros(len(beg), np.int64)
    done = np.zeros(len(beg), bool)
    for shift, base in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        hit = ~done & ((beg >> shift) == (end >> shift))
        out[hit] = base + (beg[hit] >> shift)
        done |= hit
    return out


def synth_panel(bam_path: Path, bed_path: Path, fai_path: Path, n_pairs: int,
                seed: int, n_regions: int = PANEL_REGIONS, read_len: int = 150,
                pool=None):
    """Coordinate-sorted paired-end BAM on a hybrid-capture panel.

    The panel has n_regions regions of 150-350 bp (~5 Mb for 20k regions)
    spread over GRCh38 in proportion to chromosome length. 80% of the pairs
    come from fragments (insert ~N(250, 50)) centred near a target, 20% from
    anywhere; 5% are flagged duplicates and 5% have MAPQ below 20. Base and
    quality strings repeat from a pool of 65,536 NovaSeq-binned reads.
    Also writes the panel BED and a .fai for the (empty) stub genome."""
    from ngsbits_tpu.io.bgzf import _EOF_BLOCK, bgzf_compress
    rng = np.random.default_rng(seed)
    names = list(HG38)
    lens = np.array([HG38[c] for c in names], np.int64)
    chrom = np.sort(rng.choice(len(names), n_regions, p=lens / lens.sum()))
    rstart = rng.integers(1_000_000, lens[chrom] - 1_000_000)
    order = np.lexsort((rstart, chrom))
    chrom, rstart = chrom[order], rstart[order]
    keep = np.ones(n_regions, bool)  # drop the rare overlapping neighbour
    keep[1:] = (chrom[1:] != chrom[:-1]) | (rstart[1:] - rstart[:-1] > 400)
    chrom, rstart = chrom[keep], rstart[keep]
    rlen = rng.integers(150, 351, len(chrom))
    with open(bed_path, "w") as fh:
        fh.writelines(f"{names[c]}\t{s}\t{s + l}\n"
                      for c, s, l in zip(chrom, rstart, rlen))
    with open(fai_path, "w") as fh:
        fh.writelines(f"{c}\t{HG38[c]}\t6\t60\t61\n" for c in names)

    on = rng.random(n_pairs) < 0.8
    tgt = rng.integers(0, len(chrom), n_pairs)
    ins = np.clip(rng.normal(250, 50, n_pairs), 160, 600).astype(np.int64)
    centre = rstart[tgt] + rng.integers(0, rlen[tgt]) + rng.normal(0, 25, n_pairs).astype(np.int64)
    anywhere = rng.choice(len(names), n_pairs, p=lens / lens.sum())
    pchr = np.where(on, chrom[tgt], anywhere)
    pos1 = np.where(on, centre - ins // 2,
                    rng.integers(0, lens[anywhere] - 1000))
    pos1 = np.clip(pos1, 0, lens[pchr] - 1000)
    pos2 = pos1 + ins - read_len
    dup = rng.random(n_pairs) < 0.05
    mapq = np.where(rng.random(n_pairs) < 0.05,
                    rng.integers(0, 20, n_pairs), 60)

    # one record per read: read 1 forward, read 2 reverse (FR pairs)
    n = 2 * n_pairs
    ref = np.repeat(pchr, 2)
    pos = np.stack([pos1, pos2], 1).ravel()
    mpos = np.stack([pos2, pos1], 1).ravel()
    tlen = np.stack([ins, -ins], 1).ravel()
    flag = np.tile(np.array([1 | 2 | 32 | 64, 1 | 2 | 16 | 128]), n_pairs)
    flag = flag | np.repeat(np.where(dup, 1024, 0), 2)
    pair_id = np.repeat(np.arange(n_pairs), 2)
    srt = np.lexsort((pos, ref))
    ref, pos, mpos, tlen, flag, pair_id = (a[srt] for a in (ref, pos, mpos, tlen, flag, pair_id))

    pool_n = 1 << 16
    b1, q1, _, _ = read_arrays(rng, rng.integers(0, 4, 100_000, dtype=np.uint8),
                               pool_n, read_len, 1000, 1)
    nib = np.zeros(256, np.uint8)
    for i, c in enumerate(b"=ACMGRSVTWYHKDBN"):
        nib[c] = i
    codes = nib[b1]
    packed = (codes[:, 0::2] << 4) | codes[:, 1::2]
    name_len = 11  # 'p' + 9 digits + NUL
    dt = np.dtype([("block_size", "<i4"), ("ref", "<i4"), ("pos", "<i4"),
                   ("l_name", "u1"), ("mapq", "u1"), ("bin", "<u2"),
                   ("n_cigar", "<u2"), ("flag", "<u2"), ("l_seq", "<i4"),
                   ("mref", "<i4"), ("mpos", "<i4"), ("tlen", "<i4"),
                   ("name", "S%d" % name_len), ("cigar", "<u4"),
                   ("seq", "u1", (read_len // 2,)),
                   ("qual", "u1", (read_len,))])
    rec = np.zeros(n, dt)
    rec["block_size"] = dt.itemsize - 4
    rec["ref"] = ref
    rec["pos"] = pos
    rec["l_name"] = name_len
    rec["mapq"] = np.repeat(mapq, 2)[srt]
    rec["bin"] = _reg2bin(pos, pos + read_len)
    rec["n_cigar"] = 1
    rec["flag"] = flag
    rec["l_seq"] = read_len
    rec["mref"] = ref
    rec["mpos"] = mpos
    rec["tlen"] = tlen
    digits = (pair_id[:, None] // 10 ** np.arange(8, -1, -1)) % 10 + 48
    name = np.zeros((n, name_len), np.uint8)
    name[:, 0] = ord("p")
    name[:, 1:10] = digits
    rec["name"] = name.view(f"S{name_len}").ravel()
    rec["cigar"] = read_len << 4  # <read_len>M
    pick = pair_id % pool_n
    rec["seq"] = packed[pick]
    rec["qual"] = q1[pick] - 33

    text = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
        f"@SQ\tSN:{c}\tLN:{HG38[c]}\n" for c in names)
    head = bytearray(b"BAM\x01")
    head += np.int32(len(text)).tobytes() + text.encode()
    head += np.int32(len(names)).tobytes()
    for c in names:
        head += np.int32(len(c) + 1).tobytes() + c.encode() + b"\x00"
        head += np.int32(HG38[c]).tobytes()
    with open(f"{bam_path}.tmp", "wb") as fh:
        fh.write(bgzf_compress(bytes(head), level=1, eof=False))
        step = 200_000
        for i in range(0, n, step):
            fh.write(bgzf_compress(rec[i:i + step].tobytes(), level=1,
                                   eof=False, pool=pool))
        fh.write(_EOF_BLOCK)
    os.replace(f"{bam_path}.tmp", bam_path)


# ------------------------------------------------------------ comparisons

def qcml_lines(path) -> list[str]:
    """qcML lines without the 'creation ' and '<binary>' lines (run date,
    parameters and plot images)."""
    text = Path(path).read_text()
    return [l for l in text.splitlines()
            if "creation " not in l and "<binary>" not in l]


def first_difference(a: list, b: list) -> str | None:
    """Description of the first differing line, or None when equal."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return f"line {i + 1}: {x[:120]!r} != {y[:120]!r}"
    if len(a) != len(b):
        return f"line counts differ: {len(a)} != {len(b)}"
    return None


def same_qcml(a, b) -> str | None:
    return first_difference(qcml_lines(a), qcml_lines(b))


def same_bytes(a, b) -> str | None:
    if Path(a).read_bytes() == Path(b).read_bytes():
        return None
    return first_difference(Path(a).read_text().splitlines(),
                            Path(b).read_text().splitlines()) or "bytes differ"


def same_gz_text(a, b) -> str | None:
    """Compare decompressed gzip streams (container bytes may differ)."""
    with gzip.open(a, "rb") as fa, gzip.open(b, "rb") as fb:
        off = 0
        while True:
            x, y = fa.read(1 << 24), fb.read(1 << 24)
            if x != y:
                return f"decompressed content differs after byte {off}"
            if not x:
                return None
            off += len(x)


# ------------------------------------------------------------ children

def emit(result: dict):
    print(RESULT_TAG + json.dumps(result), flush=True)


def child_probe():
    import jax
    d = jax.devices()
    emit({"platform": d[0].platform, "kind": d[0].device_kind,
          "count": len(d)})


def child_cli(argv: list[str]):
    """One CLI run through the package entry point, then its counters."""
    from ngsbits_tpu.__main__ import main
    from ngsbits_tpu.utils import trace
    from ngsbits_tpu.utils.backend import enable_compilation_cache
    enable_compilation_cache()
    t0 = time.perf_counter()
    rc = main(argv)
    seconds = time.perf_counter() - t0
    backend = None
    if "jax" in sys.modules:
        import jax
        backend = jax.default_backend()
    emit({"rc": rc, "seconds": seconds, "backend": backend,
          "counters": trace.counters()})


def _memory(compiled) -> dict:
    m = compiled.memory_analysis()
    return {k: int(getattr(m, k)) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "alias_size_in_bytes")}


def _bench(run, iters: int) -> float:
    """Seconds per call of run() (the last result is waited for)."""
    import jax
    jax.block_until_ready(run())
    t0 = time.perf_counter()
    for _ in range(iters - 1):
        run()
    jax.block_until_ready(run())
    return (time.perf_counter() - t0) / iters


def child_kernels(seed: int):
    """Each device kernel at a real width: compile, compare, time."""
    import jax
    import jax.numpy as jnp

    from ngsbits_tpu.core.basicstats import correlation
    from ngsbits_tpu.ops import device_reduce as dr
    from ngsbits_tpu.ops import readqc as rq
    from ngsbits_tpu.ops import seqpurge as sp
    from ngsbits_tpu.utils.backend import enable_compilation_cache
    enable_compilation_cache()
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, 1_000_000, dtype=np.uint8)
    res = {}

    # ReadQC streaming step, one bucket of 65536 reads x 192 cycles
    B, L = 65536, 192
    b1, q1, _, _ = read_arrays(rng, genome, B, 151, 350, 80)
    bases = np.zeros((B, L), np.uint8)
    quals = np.zeros((B, L), np.uint8)
    bases[:, :151], quals[:, :151] = b1, q1
    lengths = np.full(B, 151, np.int32)
    pb, nm, pq = rq.pack_batch(bases, quals)
    args = [jax.device_put(x) for x in (pb, nm, pq, lengths, np.int32(B))]
    t0 = time.perf_counter()
    step = rq.stream_step().lower(rq.stream_carry_init(L), *args, 0, 6).compile()
    compile_s = time.perf_counter() - t0
    carry = jax.device_get(step(rq.stream_carry_init(L), *args))
    c5, qs, qh, _ = rq.readqc_batch_host(bases, quals, lengths)
    ok = (np.array_equal(carry["counts5"], c5)
          and np.array_equal(carry["qsum1"], qs)
          and np.array_equal(carry["qhist"], qh)
          and int(carry["bases"]) == int(lengths.sum()))
    holder = {"c": rq.stream_carry_init(L)}

    def run_step():
        holder["c"] = step(holder["c"], *args)
        return holder["c"]
    sec = _bench(run_step, 50)
    res["readqc_stream_step"] = {
        "shape": [B, L], "exact": ok, "compile_s": compile_s, "seconds": sec,
        "bytes": int(pb.nbytes + nm.nbytes + pq.nbytes + lengths.nbytes),
        "memory": _memory(step),
        "onehot_bytes": B * L * (rq.QHIST_SIZE + 1)}

    # SeqPurge scans, 16384 pairs x 152 cycles
    B, L = 16384, 152
    b1, _, b2, _ = read_arrays(rng, genome, B, 151, 180, 60)
    seq1 = np.zeros((B, L), np.uint8)
    seq1[:, :151] = b1
    read2 = np.zeros((B, L), np.uint8)
    read2[:, :151] = b2
    seq2rc = np.zeros((B, L), np.uint8)
    seq2rc[:, :151] = COMPLEMENT[b2[:, ::-1]]
    len1 = len2 = np.full(B, 151, np.int32)
    min_len = np.minimum(len1, len2)
    fns = sp._device_fns()
    a1 = np.frombuffer(ADAPTER1, np.uint8)
    a2 = np.frombuffer(ADAPTER2, np.uint8)
    cases = {
        "insert_scan": (fns["insert_scan"], (seq1, seq2rc, min_len), (),
                        sp.insert_scan_host(seq1, seq2rc, min_len)),
        "adapter_evidence": (fns["adapter_evidence"],
                             (seq1, read2, len1, len2, a1[:10], a2[:10]), (10,),
                             sp.adapter_evidence_host(seq1, read2, len1, len2,
                                                      a1[:10], a2[:10], 10)),
        "adapter_scan": (fns["adapter_scan"], (seq1, len1, a1), (len(a1),),
                         sp.adapter_scan_host(seq1, len1, a1, len(a1))),
    }
    for name, (fn, dyn, static, want) in cases.items():
        dev = [jax.device_put(x) for x in dyn]
        t0 = time.perf_counter()
        comp = fn.lower(*dev, *static).compile()
        compile_s = time.perf_counter() - t0
        got = jax.device_get(comp(*dev))
        sec = _bench(lambda: comp(*dev), 20)
        res[name] = {
            "shape": [B, L], "compile_s": compile_s, "seconds": sec,
            "exact": all(np.array_equal(g, w) for g, w in zip(got, want)),
            "bytes": int(sum(np.asarray(x).nbytes for x in dyn)
                         + sum(np.asarray(g).nbytes for g in got)),
            "memory": _memory(comp),
            "gather_bytes": B * L * L}

    # coverage evaluation at panel size: 4M read spans in a 5 Mb flattened
    # ROI, as MappingQC -roi and the sparse BedCoverage accumulator pass it
    n_spans, size = 4 << 20, 5_000_000
    s = rng.integers(0, size - 150, n_spans).astype(np.int32)
    e = (s + 150).astype(np.int32)
    diff = np.zeros(size + 1, np.int64)
    np.add.at(diff, s, 1)
    np.add.at(diff, e, -1)
    want = np.cumsum(diff)[:size]
    sd, ed = (jax.device_put(dr._pad_pow2(x, dr._SENTINEL)) for x in (s, e))
    pd = jax.device_put(np.arange(size, dtype=np.int32))

    # the program's form, and the sort-based form it replaced
    @jax.jit
    def sort_searchsorted(s, e, p):
        a = jnp.searchsorted(jnp.sort(s), p, side="right", method="sort")
        b = jnp.searchsorted(jnp.sort(e), p, side="right", method="sort")
        return a - b
    forms = {"scatter_cumsum": (dr._jit_fns()["coverage"],
                                (sd, ed), (dr._pow2(size + 1),)),
             "sort_searchsorted": (sort_searchsorted, (sd, ed, pd), ())}
    for name, (fn, dyn, static) in forms.items():
        t0 = time.perf_counter()
        comp = fn.lower(*dyn, *static).compile()
        compile_s = time.perf_counter() - t0
        got = np.asarray(comp(*dyn))[:size]
        res["coverage_" + name] = {
            "spans": n_spans, "positions": size, "compile_s": compile_s,
            "exact": bool(np.array_equal(got, want)),
            "seconds": _bench(lambda: comp(*dyn), 20),
            "bytes": int(sum(x.nbytes for x in dyn) + 4 * size)}

    # pileup bincount (4 bases x 20k SNPs) and genotype Pearson (70k SNPs)
    idx = rng.integers(0, 80_000, 2_000_000).astype(np.int32)
    db = dr.DeviceBincount(80_000)
    db.add(idx)
    res["bincount"] = {"exact": bool(np.array_equal(
        db.finalize(), np.bincount(idx, minlength=80_000)))}
    g1 = rng.choice([0.0, 0.5, 1.0], 70_000)
    g2 = np.where(rng.random(70_000) < 0.8, g1, rng.choice([0.0, 0.5, 1.0], 70_000))
    err = abs(dr.pearson_from_genotypes(g1, g2) - correlation(list(g1), list(g2)))
    res["pearson"] = {"abs_err": err, "exact": err < 1e-9}
    emit(res)


def child_compile_again():
    """Compile the ReadQC step of child_kernels again in a new process: a
    persistent-cache hit shows as a lower compile time."""
    import jax

    from ngsbits_tpu.ops import readqc as rq
    from ngsbits_tpu.utils.backend import enable_compilation_cache
    cache_dir = enable_compilation_cache()
    B, L = 65536, 192
    args = [jax.device_put(np.zeros(s, t)) for s, t in (
        ((B, L // 4), np.uint8), ((B, L // 8), np.uint8),
        ((B, L // 4 * 3), np.uint8), ((B,), np.int32), ((), np.int32))]
    t0 = time.perf_counter()
    rq.stream_step().lower(rq.stream_carry_init(L), *args, 0, 6).compile()
    emit({"compile_s": time.perf_counter() - t0, "cache_dir": cache_dir})


def child_dryrun(n: int):
    import jax

    import __graft_entry__
    from ngsbits_tpu.utils import trace
    assert len(jax.devices()) >= n, jax.devices()
    __graft_entry__.dryrun_multichip(n)
    emit({"counters": trace.counters()})


# ------------------------------------------------------------ parent

class PhaseError(RuntimeError):
    pass


class Smoke:
    def __init__(self, args):
        self.args = args
        self.card = ""
        self.device: dict = {}
        self.failed: list[str] = []
        self.mesh_env = {"NGSBITS_MESH": "1"} if args.four_cards else {}
        self.scan_s_per_pair: float | None = None  # set by the kernel phase

    def say(self, msg: str):
        print(msg, flush=True)

    def timed(self, msg: str):
        """Print a line that carries a time or a rate, with the card."""
        self.say(f"{msg} [{self.card}]")

    def child(self, mode: list[str], gpu: bool, cwd: Path = REPO,
              env_extra: dict | None = None, timeout: int = 900) -> dict:
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cuda" if gpu else "cpu"
        if not gpu:
            env["NGSBITS_DEVICE_ENGINES"] = "0"
        env.update(env_extra or {})
        cmd = [sys.executable, str(REPO / "chip_smoke.py"), "--seed",
               str(self.args.seed), "--child"] + mode
        t0 = time.perf_counter()
        r = subprocess.run(cmd, cwd=cwd, env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True, timeout=timeout)
        wall = time.perf_counter() - t0
        lines = [l for l in r.stdout.splitlines() if l.startswith(RESULT_TAG)]
        if r.returncode != 0 or not lines:
            raise PhaseError(f"child {mode[:2]} exited {r.returncode}:\n"
                             + r.stderr[-3000:])
        out = json.loads(lines[-1][len(RESULT_TAG):])
        out["wall_s"] = wall
        return out

    def phase(self, name: str, fn):
        try:
            fn()
        except (PhaseError, subprocess.TimeoutExpired, AssertionError) as exc:
            self.failed.append(name)
            self.say(f"{name}: FAILED: {exc}")

    def data(self, name: str, make) -> Path:
        """Directory .smoke_data/<name>, filled by make(dir) once."""
        d = DATA / f"{name}-seed{self.args.seed}-scale{self.args.scale:g}"
        if not (d / "done").exists():
            shutil.rmtree(d, ignore_errors=True)
            d.mkdir(parents=True)
            t0 = time.perf_counter()
            with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
                make(d, pool)
            (d / "done").write_text("")
            self.say(f"data {name}: generated in {time.perf_counter() - t0:.1f} s")
        return d

    def n(self, count: int) -> int:
        return max(1000, int(count * self.args.scale))

    def readqc_data(self) -> Path:
        return self.data("readqc", lambda d, pool: synth_pairs(
            d / "R1.fastq.gz", d / "R2.fastq.gz", self.n(READQC_PAIRS),
            self.args.seed, 350, 80, pool=pool))

    def panel_data(self) -> Path:
        return self.data("panel", lambda d, pool: synth_panel(
            d / "panel.bam", d / "panel.bed", d / "genome.fa.fai",
            self.n(BAM_PAIRS), self.args.seed, pool=pool))

    def seqpurge_data(self) -> Path:
        return self.data("seqpurge", lambda d, pool: synth_pairs(
            d / "R1.fastq.gz", d / "R2.fastq.gz", self.n(SEQPURGE_PAIRS),
            self.args.seed + 1, 180, 60, pool=pool))

    def run_pair(self, name: str, argv: list[str], outputs: dict,
                 gpu_env: dict, n_items: int, unit: str = "reads") -> dict:
        """Run one CLI tool on the card and on the host, compare outputs.
        outputs: file name -> compare function."""
        runs = {}
        for side, gpu, extra in (("gpu", True, gpu_env), ("host", False, {})):
            d = DATA / "runs" / name / side
            shutil.rmtree(d, ignore_errors=True)
            d.mkdir(parents=True)
            r = self.child(["cli"] + argv, gpu, cwd=d, env_extra=extra)
            if r["rc"] != 0:
                raise PhaseError(f"{name} {side} run exited {r['rc']}")
            runs[side] = (d, r)
        g, h = runs["gpu"][1], runs["host"][1]
        if g["backend"] != "gpu":
            raise PhaseError(f"{name}: GPU run reports backend {g['backend']}")
        if any(k.startswith(("device.", "mesh.")) for k in h["counters"]):
            raise PhaseError(f"{name}: host run used a device route: {h['counters']}")
        for fname, cmp in outputs.items():
            diff = cmp(runs["gpu"][0] / fname, runs["host"][0] / fname)
            if diff:
                raise PhaseError(f"{name}: {fname} differs: {diff}")
        self.timed(f"{name}: gpu {g['seconds']:.2f} s "
                   f"{n_items / g['seconds']:.0f} {unit}/s (process "
                   f"{g['wall_s']:.2f} s), host {h['seconds']:.2f} s "
                   f"{n_items / h['seconds']:.0f} {unit}/s; "
                   f"outputs identical ({', '.join(outputs)}); "
                   f"counters {g['counters']}")
        return g["counters"]

    # ---- default phases

    def probe(self, want: int) -> dict:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        if smi.returncode != 0 or not smi.stdout.strip():
            raise PhaseError(f"nvidia-smi failed: {smi.stderr[-500:]}")
        cards = smi.stdout.strip().splitlines()
        for line in cards:
            self.say(f"card: {line}")
        self.card = cards[0]
        p = self.child(["probe"], gpu=True, timeout=300)
        self.say(f"probe: platform={p['platform']} kind={p['kind']} "
                 f"count={p['count']}")
        if p["platform"] != "gpu" or p["count"] < want:
            raise PhaseError(f"need {want} GPU device(s), JAX reports {p}")
        return p

    def kernels(self):
        r = self.child(["kernels"], gpu=True)
        peak = PEAK_BYTES_PER_S.get(self.device["kind"])
        self.say("kernels: integer and genotype-moment reductions only, no "
                 "matrix products, so TF32 does not arise")
        for name, k in r.items():
            if name == "wall_s":
                continue
            line = f"kernel {name}: exact={k['exact']}"
            if "seconds" in k:
                line += (f" compile {k['compile_s']:.2f} s, "
                         f"{k['seconds'] * 1e3:.3f} ms/call")
            if "bytes" in k:
                rate = k["bytes"] / k["seconds"]
                line += f", {rate / 1e9:.1f} GB/s"
                if peak:
                    line += f" ({100 * rate / peak:.2f}% of {peak / 1e12:.2f} TB/s)"
            if "abs_err" in k:
                line += f" |r - r_host| = {k['abs_err']:.3g} (limit 1e-9)"
            if "memory" in k:
                line += f", memory_analysis {k['memory']}"
                big = k.get("onehot_bytes") or k.get("gather_bytes")
                line += (f"; {'materialises' if k['memory']['temp_size_in_bytes'] >= big else 'does not materialise'}"
                         f" the {big} B intermediate")
            self.timed(line)
            assert k["exact"], f"kernel {name} does not match the host reference"
        cov = {n: r[f"coverage_{n}"]["seconds"]
               for n in ("sort_searchsorted", "scatter_cumsum")}
        self.timed(f"coverage evaluator: faster form {min(cov, key=cov.get)} "
                   f"({', '.join(f'{n} {s * 1e3:.3f} ms' for n, s in cov.items())})")
        scan = r["insert_scan"]
        self.scan_s_per_pair = scan["seconds"] / scan["shape"][0]
        again = self.child(["compile-again"], gpu=True)
        self.timed(f"compile cache: ReadQC step compiled in "
                   f"{r['readqc_stream_step']['compile_s']:.2f} s in the first "
                   f"process, {again['compile_s']:.2f} s in a second "
                   f"(cache {again['cache_dir']})")

    def readqc(self):
        d = self.readqc_data()
        n_reads = 2 * self.n(READQC_PAIRS)
        c = self.run_pair(
            "ReadQC", ["ReadQC", "-in1", str(d / "R1.fastq.gz"),
                       "-in2", str(d / "R2.fastq.gz"), "-out", "out.qcML"],
            {"out.qcML": same_qcml}, self.mesh_env, n_items=n_reads)
        self.check_route("ReadQC", c, "device.readqc_batches")
        from ngsbits_tpu.qc.read_stats import DeviceReadStream
        if not self.args.four_cards and n_reads >= DeviceReadStream.SPILL_READS:
            assert c.get("device.readqc_spills", 0) > 0, "no spill in the run"

    def panel(self):
        d = self.panel_data()
        stub = d / "genome.fa"
        stub.write_bytes(b"")
        bam, bed = str(d / "panel.bam"), str(d / "panel.bed")
        n_reads = 2 * self.n(BAM_PAIRS)
        runs = (
            ("MappingQC", ["-in", bam, "-roi", bed, "-out", "out.qcML",
                           "-no_cont", "-ref", str(stub)], "out.qcML", same_qcml),
            ("BedCoverage", ["-in", bed, "-bam", bam, "-out", "out.bed"],
             "out.bed", same_bytes),
            ("BedLowCoverage", ["-in", bed, "-bam", bam, "-cutoff", "20",
                                "-out", "out.bed"], "out.bed", same_bytes))
        for tool, argv, out, cmp in runs:
            c = self.run_pair(tool, [tool] + argv, {out: cmp}, self.mesh_env,
                              n_items=n_reads)
            self.check_route(tool, c, "device.coverage")

    def seqpurge(self):
        d = self.seqpurge_data()
        n_pairs = self.n(SEQPURGE_PAIRS)
        argv = ["SeqPurge", "-in1", str(d / "R1.fastq.gz"),
                "-in2", str(d / "R2.fastq.gz"), "-out1", "o1.fastq.gz",
                "-out2", "o2.fastq.gz", "-qc", "qc.qcML"]
        env = {"NGSBITS_SEQPURGE_NO_NATIVE": "1", "NGSBITS_DEVICE_ENGINES": "1"}
        env.update(self.mesh_env)
        c = self.run_pair("SeqPurge", argv,
                          {"o1.fastq.gz": same_gz_text,
                           "o2.fastq.gz": same_gz_text, "qc.qcML": same_qcml},
                          env, n_items=n_pairs, unit="pairs")
        self.check_route("SeqPurge", c, "device.insert_scan")
        if self.scan_s_per_pair is not None:
            self.timed(f"SeqPurge: the insert scan at the kernel phase's rate "
                       f"would take {self.scan_s_per_pair * n_pairs:.3f} s "
                       f"of the device route's run (estimate)")

    def check_route(self, name: str, counters: dict, device_counter: str):
        if self.args.four_cards:
            ids = sorted(int(k.rsplit(".", 1)[1]) for k in counters
                         if k.startswith("mesh.shards."))
            assert ids == [0, 1, 2, 3], f"{name}: shards on devices {ids}"
        else:
            assert counters.get(device_counter, 0) > 0, \
                f"{name}: device route not engaged ({counters})"

    def gpu_lane(self):
        env = dict(os.environ, JAX_PLATFORMS="cuda")
        env.pop("NGSBITS_DEVICE_ENGINES", None)
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "pytest", "-m", "gpu",
                            "tests/", "-q", "-p", "no:cacheprovider"],
                           cwd=REPO, env=env, capture_output=True, text=True,
                           timeout=900)
        summary = (r.stdout.strip().splitlines() or [""])[-1]
        self.timed(f"gpu lane: {summary} in {time.perf_counter() - t0:.1f} s")
        if r.returncode != 0 or re.search(r"failed|error|skipped", summary):
            raise PhaseError(r.stdout[-3000:] + r.stderr[-2000:])

    def dryrun(self):
        r = self.child(["dryrun", "4"], gpu=True)
        self.check_route("dryrun_multichip(4)", r["counters"], "")
        self.timed(f"dryrun_multichip(4): ok in {r['wall_s']:.1f} s; "
                   f"counters {r['counters']}")

    def run(self) -> int:
        if not (REPO / "ngsbits_tpu" / "__init__.py").exists():
            print("chip_smoke.py: the ngsbits_tpu package is not next to "
                  "this script", file=sys.stderr)
            return 2
        sys.path.insert(0, str(REPO))
        want = 4 if self.args.four_cards else 1
        try:
            self.device = self.probe(want)
        except (PhaseError, OSError, subprocess.TimeoutExpired) as exc:
            print(f"probe: FAILED: {exc}", file=sys.stderr)
            return 1
        if self.args.four_cards:
            phases = [("dryrun", self.dryrun), ("ReadQC", self.readqc),
                      ("panel", self.panel), ("SeqPurge", self.seqpurge)]
        else:
            phases = [("kernels", self.kernels), ("ReadQC", self.readqc),
                      ("panel", self.panel), ("SeqPurge", self.seqpurge),
                      ("gpu lane", self.gpu_lane)]
        for name, fn in phases:
            self.phase(name, fn)
        if self.failed:
            self.say(f"failed phases: {', '.join(self.failed)}")
            return 1
        print(json.dumps({"ok": True, "device": {
            "platform": self.device["platform"], "kind": self.device["kind"],
            "count": self.device["count"]}}))
        return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--scale", type=float, default=1.0,
                    help="multiply every sample's read count (rehearsals)")
    ap.add_argument("--four-cards", action="store_true",
                    help="run the mesh path on four cards instead")
    ap.add_argument("--child", nargs=argparse.REMAINDER,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        sys.path.insert(0, str(REPO))
        mode, rest = args.child[0], args.child[1:]
        if mode == "probe":
            child_probe()
        elif mode == "cli":
            child_cli(rest)
        elif mode == "kernels":
            child_kernels(args.seed)
        elif mode == "compile-again":
            child_compile_again()
        elif mode == "dryrun":
            child_dryrun(int(rest[0]))
        else:
            ap.error(f"unknown child mode {mode}")
        return 0
    return Smoke(args).run()


if __name__ == "__main__":
    sys.exit(main())
