"""Device-mesh construction + sharded QC reduction steps.

The reference is single-node multi-threaded (QThreadPool fan-out over genomic
chunks / read blocks, SURVEY §2.5). The device equivalent implemented
here: read batches are sharded over a 1-D `data` mesh axis with
``shard_map``; each device reduces its shard to tiny accumulator partials;
partials are merged with ``psum`` so the host receives one merged state per
step. The cards of one host are joined all to all, so the mesh follows the
algorithm alone: one flat axis. Every step records which devices its input
shards landed on (trace counters ``mesh.shards.<device id>``).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import readqc as readqc_ops
from ..utils import trace


def make_mesh(devices=None, axis: str = "data") -> Mesh:
    if devices is None:
        devices = jax.devices()
    return Mesh(np.array(devices), (axis,))


def _shard(mesh: Mesh, x, spec: P):
    """Place x on the mesh with `spec`, counting the devices it lands on."""
    arr = jax.device_put(x, NamedSharding(mesh, spec))
    for s in arr.addressable_shards:
        trace.count(f"mesh.shards.{s.device.id}")
    return arr


def distributed_init(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None):
    """Multi-host runtime bring-up (jax.distributed.initialize wrapper).

    With several hosts each calls this once before building the global
    mesh, naming the coordinator, the process count and its own id (no
    cluster environment announces them). Safe to call when already
    initialized.
    """
    try:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)
    except RuntimeError as exc:
        if "already" not in str(exc).lower():
            raise


def sharded_coverage_step(mesh: Mesh, starts, ends, genome_bins: int):
    """Data-parallel coverage accumulation over read spans.

    starts/ends: [N] int32 bin indices of read alignment spans (half-open),
    sharded over the mesh batch axis. Each device scatter-adds its shard
    into a local diff array; diffs are psum-merged and prefix-summed on
    device — the device analogue of WorkerLowOrHighCoverageChr's per-base
    uint8 arrays (WorkerLowOrHighCoverage.cpp:173-204) without the
    cap-at-254 artifact.

    Returns [genome_bins] int32 coverage.
    """
    axis = mesh.axis_names[0]

    def step(s, e):
        diff = jnp.zeros((genome_bins + 1,), jnp.int32)
        diff = diff.at[s].add(1)
        diff = diff.at[e].add(-1)
        diff = jax.lax.psum(diff, axis)
        return jnp.cumsum(diff)[:genome_bins]

    fn = jax.jit(jax.shard_map(step, mesh=mesh,
                               in_specs=(P(axis), P(axis)),
                               out_specs=P()))
    spec = P(axis)
    return fn(_shard(mesh, np.asarray(starts, np.int32), spec),
              _shard(mesh, np.asarray(ends, np.int32), spec))


def mesh_coverage(spans: list, size: int) -> np.ndarray:
    """Coverage over positions 0..size-1 from buffered (starts, ends_excl)
    int32 span pairs, accumulated by sharded_coverage_step over all
    devices; spans pad to a device-count multiple with empty spans."""
    s = (np.concatenate([x[0] for x in spans]) if spans
         else np.zeros(0, np.int32))
    e = (np.concatenate([x[1] for x in spans]) if spans
         else np.zeros(0, np.int32))
    nd = jax.device_count()
    pad = nd if len(s) == 0 else (-len(s)) % nd
    if pad:  # zero-length spans contribute nothing to the diff array
        s = np.concatenate([s, np.zeros(pad, np.int32)])
        e = np.concatenate([e, np.zeros(pad, np.int32)])
    return np.asarray(sharded_coverage_step(make_mesh(), s, e, size),
                      dtype=np.int64)


def sharded_insert_scan(mesh: Mesh, seq1, seq2rc, min_len):
    """SeqPurge insert-match scan sharded over read pairs.

    Embarrassingly parallel over the batch axis (SURVEY §2.5 P3): outputs
    stay sharded per pair, no collective needed. The same XLA formulation
    as the single-device route, inside shard_map.
    """
    from ..ops import seqpurge as sp_ops
    axis = mesh.axis_names[0]
    fn = jax.jit(jax.shard_map(
        lambda a, b, c: sp_ops.insert_scan_raw()(a, b, c),
        mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), P(axis)),
        out_specs=(P(axis, None), P(axis, None)),
    ))
    return fn(_shard(mesh, np.asarray(seq1), P(axis, None)),
              _shard(mesh, np.asarray(seq2rc), P(axis, None)),
              _shard(mesh, np.asarray(min_len, np.int32), P(axis)))


def sharded_readqc_step(mesh: Mesh, bases, quals, lengths):
    """One data-parallel ReadQC reduction step over the mesh.

    bases/quals: [B, L] uint8, lengths: [B] int32 — B divisible by mesh size.
    Returns merged (counts5, qsum_cycle, qhist, read_qsum) with read_qsum
    remaining sharded over the batch axis.
    """
    axis = mesh.axis_names[0]

    def step(b, q, l):
        counts5, qsum_cycle, qhist, read_qsum = readqc_ops.readqc_batch_raw()(b, q, l)
        counts5 = jax.lax.psum(counts5, axis)
        qsum_cycle = jax.lax.psum(qsum_cycle, axis)
        qhist = jax.lax.psum(qhist, axis)
        return counts5, qsum_cycle, qhist, read_qsum

    shard = jax.shard_map(
        step, mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), P(axis)),
        out_specs=(P(), P(), P(), P(axis)),
    )
    fn = jax.jit(shard)
    return fn(_shard(mesh, np.asarray(bases), P(axis, None)),
              _shard(mesh, np.asarray(quals), P(axis, None)),
              _shard(mesh, np.asarray(lengths), P(axis)))


def sharded_mapping_counters_step(mesh: Mesh, flags, mapqs, on_target):
    """Data-parallel MappingQC counter reduction.

    flags: [N] uint16 SAM flags, mapqs: [N] int32, on_target: [N] bool —
    sharded over the batch axis; per-shard counter partials are psum-merged
    (the mesh analogue of the reference's per-thread counter
    accumulation in Statistics::mapping).

    Returns int32 [5]: reads, mapped, duplicates, on-target, mapq0.
    """
    axis = mesh.axis_names[0]

    def step(f, q, t):
        mapped = (f & 0x4) == 0
        counters = jnp.stack([
            jnp.asarray(f.shape[0], jnp.int32),
            mapped.sum().astype(jnp.int32),
            ((f & 0x400) != 0).sum().astype(jnp.int32),
            (mapped & t).sum().astype(jnp.int32),
            (mapped & (q == 0)).sum().astype(jnp.int32),
        ])
        return jax.lax.psum(counters, axis)

    fn = jax.jit(jax.shard_map(step, mesh=mesh,
                               in_specs=(P(axis), P(axis), P(axis)),
                               out_specs=P()))
    return fn(jnp.asarray(flags, jnp.uint16), jnp.asarray(mapqs, jnp.int32),
              jnp.asarray(on_target, bool))


def sharded_correlation_step(mesh: Mesh, x, y):
    """SampleSimilarity correlation with sharded partial-moment merges.

    x/y: [N] float32 genotype/AF vectors sharded over the batch axis; each
    device computes partial (n, sx, sy, sxx, syy, sxy), merged with one psum,
    correlation evaluated on device — the mesh analogue of
    SampleSimilarity::calculateSimilarity's single-pass moment sums.
    """
    axis = mesh.axis_names[0]

    def step(a, b):
        parts = jnp.stack([
            jnp.asarray(a.shape[0], jnp.float32),
            a.sum(), b.sum(), (a * a).sum(), (b * b).sum(), (a * b).sum(),
        ])
        n, sx, sy, sxx, syy, sxy = jax.lax.psum(parts, axis)
        cov = sxy / n - sx / n * sy / n
        var_x = sxx / n - (sx / n) ** 2
        var_y = syy / n - (sy / n) ** 2
        return cov / jnp.sqrt(var_x * var_y)

    fn = jax.jit(jax.shard_map(step, mesh=mesh,
                               in_specs=(P(axis), P(axis)), out_specs=P()))
    return fn(jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32))
