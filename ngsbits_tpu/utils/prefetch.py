"""Background prefetch of an iterator (host pipeline parallelism).

Behavioral reference: SeqPurge's read→analyze→write thread pipeline over a
ring of prefetched blocks (ThreadCoordinator.cpp:39-54, block_prefetch).
Shape: one decode thread fills a bounded queue of ready batches while the
main thread runs device compute — input decode and device execution overlap instead of alternating.
"""

from __future__ import annotations

import queue
import threading

_SENTINEL = object()


def prefetch(iterable, depth: int = 2):
    """Yield items of `iterable`, decoded ahead in a background thread.

    Exceptions raised by the producer are re-raised at the consumption
    point. If the consumer abandons the generator (break / exception), the
    producer is signalled via a stop event so it releases its input handle
    instead of blocking forever on the bounded queue.
    """
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    error: list = []
    stop = threading.Event()

    def producer():
        try:
            for item in iterable:
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as exc:  # noqa: BLE001 — forwarded to consumer
            error.append(exc)
        finally:
            # keep trying while the consumer is alive — it may be blocked in
            # q.get() waiting for exactly this sentinel
            while not stop.is_set():
                try:
                    q.put(_SENTINEL, timeout=0.2)
                    break
                except queue.Full:
                    continue

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                if error:
                    raise error[0]
                return
            yield item
    finally:
        stop.set()


def prefetch_paired(it1, it2, depth: int = 2):
    """Prefetch two iterators in lockstep pairs (R1/R2 FASTQ streams).

    Each stream decodes on its own thread (the analogue of the reference
    running one InputWorker per input stream) — the two gzip inflates
    overlap each other and the consumer's analysis."""
    s1 = prefetch(it1, depth)
    s2 = prefetch(it2, depth)

    def pairs():
        try:
            while True:
                a = next(s1, _SENTINEL)
                b = next(s2, _SENTINEL)
                if a is _SENTINEL and b is _SENTINEL:
                    return
                yield (None if a is _SENTINEL else a,
                       None if b is _SENTINEL else b)
        finally:
            # closing the inner prefetch generators signals their producer
            # threads to stop (consumer may abandon mid-stream)
            s1.close()
            s2.close()

    return pairs()
