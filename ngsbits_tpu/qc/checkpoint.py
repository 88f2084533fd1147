"""Checkpoint/resume for streaming QC accumulators.

The reference has no checkpointing (SURVEY.md §5: tools are re-runnable batch
jobs) — this is an addition so multi-hour WGS-scale scans on
preemptible hardware can snapshot their partial accumulator state between
input shards and resume after a failure. State is saved as a single .npz
(portable, backend-independent: accumulators live on host as int64 numpy).

Usage:
    stats = ReadStatistics()
    for i, shard in enumerate(shards):
        update_from_...(stats, shard)
        save_readstats(stats, ckpt_path, shards_done=i + 1)
    # after a crash:
    stats, meta = load_readstats(ckpt_path)   # continue from meta['shards_done']
"""

from __future__ import annotations

import json
from collections import Counter

import numpy as np

from ..core.histogram import Histogram
from .read_stats import ReadStatistics

_FORMAT_VERSION = 1


def _hist_state(h: Histogram) -> dict:
    return {"min": h.min, "max": h.max, "bin_size": h.bin_size,
            "bins": h._bins.copy(), "count": h._count}


def _hist_restore(state) -> Histogram:
    h = Histogram(float(state["min"]), float(state["max"]),
                  float(state["bin_size"]))
    h._bins = np.asarray(state["bins"], dtype=np.float64)
    h._count = float(state["count"])
    return h


def save_readstats(stats: ReadStatistics, path: str, **metadata):
    """Snapshot a ReadStatistics accumulator (atomic: write + rename)."""
    import os
    meta = {"format_version": _FORMAT_VERSION, **metadata}
    lengths = np.array(sorted(stats.read_lengths.items()), dtype=np.int64)
    if lengths.size == 0:
        lengths = np.zeros((0, 2), dtype=np.int64)
    arrays = {
        "meta": np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
        "scalars": np.array([stats.c_forward, stats.c_reverse,
                             stats.bases_sequenced, stats.c_read_q20,
                             int(stats.single_end)], dtype=np.int64),
        "read_lengths": lengths,
        "pileups": stats.pileups,
        "qualsum1": stats.qualsum1,
        "qualsum2": stats.qualsum2,
        "base_qualities": stats.base_qualities,
        "read_qualities": stats.read_qualities,
    }
    for name, hist in (("q1", stats.qscore_dist_r1), ("q2", stats.qscore_dist_r2)):
        state = _hist_state(hist)
        arrays[f"{name}_params"] = np.array(
            [state["min"], state["max"], state["bin_size"], state["count"]])
        arrays[f"{name}_bins"] = state["bins"]
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez_compressed(fh, **arrays)
    os.replace(tmp, path)


def load_readstats(path: str) -> tuple[ReadStatistics, dict]:
    """Restore a ReadStatistics accumulator and the saved metadata."""
    data = np.load(path)
    meta = json.loads(bytes(data["meta"]).decode())
    if meta.get("format_version") != _FORMAT_VERSION:
        raise ValueError(f"Unsupported checkpoint version: {meta.get('format_version')}")
    scalars = data["scalars"]
    stats = ReadStatistics(single_end=bool(scalars[4]))
    stats.c_forward = int(scalars[0])
    stats.c_reverse = int(scalars[1])
    stats.bases_sequenced = int(scalars[2])
    stats.c_read_q20 = int(scalars[3])
    stats.read_lengths = Counter({int(k): int(v) for k, v in data["read_lengths"]})
    stats.pileups = data["pileups"].copy()
    stats.qualsum1 = data["qualsum1"].copy()
    stats.qualsum2 = data["qualsum2"].copy()
    stats.base_qualities = data["base_qualities"].copy()
    stats.read_qualities = data["read_qualities"].copy()
    for name, attr in (("q1", "qscore_dist_r1"), ("q2", "qscore_dist_r2")):
        params = data[f"{name}_params"]
        setattr(stats, attr, _hist_restore({
            "min": params[0], "max": params[1], "bin_size": params[2],
            "count": params[3], "bins": data[f"{name}_bins"]}))
    return stats, meta
