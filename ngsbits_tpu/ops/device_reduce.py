"""Single-device reduction engines for the coverage/mapping/pileup/
similarity paths.

Behavioral reference: the per-alignment accumulation loops of
Statistics::avgCoverage / lowOrHighCoverage (cppNGS/Statistics.cpp:
2534-2804, WorkerLowOrHighCoverage.cpp:173-204 per-base increments) and
SampleSimilarity::calculateSimilarity (SampleSimilarity.cpp:201-255).

Device formulation: spans/loci are buffered host-side; one finalize
dispatch uploads them, scatter-adds them into a diff (or counter) array on
the device and prefix-sums it — integer ops only, bit-identical to the
numpy host path (integer atomics are exact in any order). Pearson moments come from integer-doubled genotypes
(0/0.5/1 → 0/1/2), so the device reduction is exact; the final correlation
forms in float64 on host.

Dispatch (`use_device`): NGSBITS_DEVICE_ENGINES=1 runs the device
formulations on whatever backend jax has, =0 keeps the host path; unset,
the device engines run whenever an accelerator is present.
"""

from __future__ import annotations

import os
from functools import partial

import numpy as np

from ..utils import trace
from ..utils.backend import has_accelerator

# int32 device moments stay exact while 4n < 2^31 (values are 0/1/2)
INT32_MOMENT_LIMIT = 2**31


def _force() -> bool | None:
    v = os.environ.get("NGSBITS_DEVICE_ENGINES", "").strip().lower()
    if v == "":
        return None
    return v not in ("0", "false", "no", "off")


def use_device() -> bool:
    """The one dispatch rule for every device engine (module docstring)."""
    f = _force()
    return has_accelerator() if f is None else f


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def _pad_pow2(arr: np.ndarray, fill: int) -> np.ndarray:
    """Pad to the next power-of-two length so jit compiles O(log N) shapes."""
    n = len(arr)
    cap = _pow2(n)
    if cap == n:
        return arr
    out = np.full(cap, fill, dtype=arr.dtype)
    out[:n] = arr
    return out


# pad index of the event vectors: out of range, so the scatter drops it
_SENTINEL = np.int32(2**31 - 1)
_FNS: dict = {}


def _jit_fns() -> dict:
    if not _FNS:
        import jax
        import jax.numpy as jnp

        @partial(jax.jit, static_argnums=2)
        def coverage(s, e, size):
            d = jnp.zeros(size, jnp.int32)
            d = d.at[s].add(1, mode="drop").at[e].add(-1, mode="drop")
            return jnp.cumsum(d)

        @partial(jax.jit, static_argnums=1)
        def bincount(idx, size):
            return jnp.zeros(size, jnp.int32).at[idx].add(1, mode="drop")

        _FNS.update(coverage=coverage, bincount=bincount)
    return _FNS


class DeviceCoverage:
    """Coverage engine over positions 0..span-1.

    Spans are buffered host-side (two int32 vectors per batch — no host
    scatter work at all); one finalize dispatch scatter-adds the diff array
    on the device and prefix-sums it. Event vectors and the diff array pad
    to power-of-two lengths (pad events use the dropped _SENTINEL index)."""

    def __init__(self, span: int):
        self.span = span
        self._s: list[np.ndarray] = []
        self._e: list[np.ndarray] = []

    def add(self, starts: np.ndarray, ends_excl: np.ndarray):
        """Spans [start, end_excl) with 0 <= start <= end_excl <= span."""
        if len(starts):
            self._s.append(np.asarray(starts, dtype=np.int32))
            self._e.append(np.asarray(ends_excl, dtype=np.int32))

    def finalize(self) -> np.ndarray:
        """Dense int64 coverage over the full span."""
        if not self._s:
            return np.zeros(self.span, dtype=np.int64)
        s = _pad_pow2(np.concatenate(self._s), _SENTINEL)
        e = _pad_pow2(np.concatenate(self._e), _SENTINEL)
        self._s = self._e = None
        trace.count("device.coverage")
        cov = _jit_fns()["coverage"](s, e, _pow2(self.span + 1))
        return np.asarray(cov)[:self.span].astype(np.int64)


class DeviceBincount:
    """Counter array engine (pileup base counts): indices are buffered and
    counted in one finalize dispatch (scatter-add on the device)."""

    def __init__(self, size: int):
        self.size = size
        self._idx: list[np.ndarray] = []

    def add(self, idx: np.ndarray):
        if len(idx):
            self._idx.append(np.asarray(idx, dtype=np.int32))

    def finalize(self) -> np.ndarray:
        if not self._idx:
            return np.zeros(self.size, dtype=np.int64)
        idx = _pad_pow2(np.concatenate(self._idx), _SENTINEL)
        self._idx = None
        trace.count("device.bincount")
        counts = _jit_fns()["bincount"](idx, _pow2(self.size))
        return np.asarray(counts)[:self.size].astype(np.int64)


_CORR_JIT = None


def _corr_fn():
    global _CORR_JIT
    if _CORR_JIT is None:
        import jax
        import jax.numpy as jnp

        @jax.jit
        def moments(x2, y2):
            # x2/y2: integer-doubled genotypes (0/1/2) — exact int32 sums
            # (all terms non-negative, caller guards 4n < 2^31)
            return (jnp.sum(x2), jnp.sum(y2), jnp.sum(x2 * x2),
                    jnp.sum(y2 * y2), jnp.sum(x2 * y2))

        _CORR_JIT = moments
    return _CORR_JIT


def pearson_from_genotypes(x: np.ndarray, y: np.ndarray) -> float:
    """Pearson correlation of genotype vectors (values in {0, 0.5, 1}).

    The device reduces exact integer moments of the doubled genotypes; the
    host forms r in float64. Mathematically identical to
    BasicStatistics::correlation; rounding differs only below 1e-12.
    """
    n = len(x)
    x2 = np.rint(np.asarray(x, dtype=np.float64) * 2).astype(np.int32)
    y2 = np.rint(np.asarray(y, dtype=np.float64) * 2).astype(np.int32)
    if 4 * n >= INT32_MOMENT_LIMIT:
        # int32 device accumulators would overflow: exact int64 on host
        sx, sy = int(x2.sum()), int(y2.sum())
        sxx = int((x2.astype(np.int64) ** 2).sum())
        syy = int((y2.astype(np.int64) ** 2).sum())
        sxy = int((x2.astype(np.int64) * y2).sum())
    else:
        # zero pads leave every sum unchanged; n comes from the true length
        trace.count("device.pearson")
        sx, sy, sxx, syy, sxy = (int(v) for v in _corr_fn()(
            _pad_pow2(x2, 0), _pad_pow2(y2, 0)))
    num = n * sxy - sx * sy
    den = np.sqrt(float(n * sxx - sx * sx)) * np.sqrt(float(n * syy - sy * sy))
    if den == 0.0:
        return float("nan")
    return float(num / den)
