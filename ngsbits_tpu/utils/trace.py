"""Stage tracing and device profiling.

Behavioral reference: ngs-bits' ad-hoc QElapsedTimer + ``-debug`` stage
duration prints (MappingQC/main.cpp:81-97,141-164, Statistics.cpp:2540-2610)
and SeqPurge's ``-progress`` queue status lines (ThreadCoordinator.cpp:56-81).

Additions: `device_profile` wraps ``jax.profiler`` trace capture so a tool
run can emit an XPlane trace viewable in TensorBoard/XProf, StageTimer
records host-side stage durations in one place instead of scattered timers,
and `count` keeps process-wide event counters: every device engine counts
its dispatches (``device.*``) and every mesh step the devices its input
shards landed on (``mesh.shards.<device id>``), so a run can show which
route it took.
"""

from __future__ import annotations

import contextlib
import datetime
import sys
import time
from collections import Counter

_COUNTERS: Counter = Counter()


def count(name: str, n: int = 1) -> None:
    """Add n to the process-wide counter `name`."""
    _COUNTERS[name] += n


def counters() -> dict[str, int]:
    """Snapshot of every counter incremented so far in this process."""
    return dict(_COUNTERS)


def reset_counters() -> None:
    _COUNTERS.clear()


def elapsed_time(start: float) -> str:
    """Helper::elapsedTime analogue: '0h 0m 1s 234ms' formatting."""
    ms = int((time.perf_counter() - start) * 1000)
    h, ms = divmod(ms, 3600_000)
    m, ms = divmod(ms, 60_000)
    s, ms = divmod(ms, 1000)
    return f"{h}h {m}m {s}s {ms}ms"


class StageTimer:
    """Named stage duration collector with optional live printing.

    with StageTimer(enabled=debug) as t:
        with t.stage("raw read QC"):
            ...
    t.report() -> list of (name, seconds)
    """

    def __init__(self, enabled: bool = False, stream=None):
        self.enabled = enabled
        self.stream = stream or sys.stderr
        self.stages: list[tuple[str, float]] = []

    @contextlib.contextmanager
    def stage(self, name: str):
        start = time.perf_counter()
        yield
        dt = time.perf_counter() - start
        self.stages.append((name, dt))
        if self.enabled:
            print(f"{name} took: {elapsed_time(start)}", file=self.stream)

    def report(self) -> list[tuple[str, float]]:
        return list(self.stages)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class ProgressReporter:
    """Periodic progress lines (SeqPurge ThreadCoordinator::printStatus).

    Call update(**counters) from the processing loop; a status line is
    printed at most every `interval_ms` milliseconds.
    """

    def __init__(self, interval_ms: int, stream=None):
        self.interval = interval_ms / 1000.0
        self.stream = stream or sys.stdout
        self._last = 0.0
        self.enabled = interval_ms > 0

    def update(self, **counters):
        if not self.enabled:
            return
        now = time.monotonic()
        if now - self._last < self.interval:
            return
        self._last = now
        stamp = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S")
        fields = " ".join(f"{k}:{v}" for k, v in counters.items())
        print(f"{stamp} progress - {fields}", file=self.stream)
        if hasattr(self.stream, "flush"):
            self.stream.flush()


@contextlib.contextmanager
def device_profile(out_dir: str | None):
    """Capture a jax.profiler trace into out_dir (no-op when None)."""
    if not out_dir:
        yield
        return
    import jax
    jax.profiler.start_trace(out_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
