"""ReadQC — QC metrics on unprocessed NGS reads.

Behavioral reference: ngs-bits src/ReadQC/main.cpp:34-116 (streams FASTQ
file(s) through the raw-read QC engine, writes qcML or TXT).
"""

from __future__ import annotations

import sys

from ..io.fastq import FastqReader, FastqWriter
from ..qc.read_stats import FORWARD, REVERSE, ReadStatistics
from .toolbase import ToolBase, ToolError


def _consume_parallel(stats: ReadStatistics, reader: FastqReader, direction: int):
    """Analysis-parallel consumption (the P4-style worker-pool pattern):
    the reader streams in its own thread while N workers each fold batches
    into a PRIVATE ReadStatistics; accumulators merge after join (the race-
    free merge-after-join design, ReadStatistics.merge). The padded [B, L]
    arrays are lazy (io/fastq.py FastqBatch), so the pad-copy also lands on
    the worker threads — decode, parse, pad and stats all overlap.

    Worker count: NGSBITS_READQC_THREADS (default min(2, cores)); 1 worker
    collapses to the plain prefetch pipeline."""
    import os
    import queue
    import threading

    from ..utils.prefetch import prefetch

    from ..ops.device_reduce import use_device

    n_workers = int(os.environ.get("NGSBITS_READQC_THREADS", "0") or 0) \
        or min(2, os.cpu_count() or 1)
    if use_device():
        # device-resident streaming: the device is the accumulator — extra
        # host workers only duplicate compilation and contend for it
        n_workers = 1
    if n_workers <= 1:
        for batch in prefetch(reader, depth=2):
            stats.update_batch(batch, direction)
        return

    q: queue.Queue = queue.Queue(maxsize=n_workers * 2)
    parts = [ReadStatistics(stats.single_end) for _ in range(n_workers)]
    errors: list = []

    def worker(part):
        bufs: dict = {}  # reusable padded-gather destination buffers
        try:
            while True:
                b = q.get()
                if b is None:
                    return
                part.update_batch(b.gather_into(bufs), direction)
        except BaseException as exc:  # noqa: BLE001 — re-raised after join
            errors.append(exc)
            while True:  # drain so the producer never blocks forever
                if q.get() is None:
                    return

    threads = [threading.Thread(target=worker, args=(p,), daemon=True)
               for p in parts]
    for t in threads:
        t.start()
    try:
        for batch in reader:
            q.put(batch)
    finally:
        for _ in threads:
            q.put(None)
        for t in threads:
            t.join()
    if errors:
        raise errors[0]
    for p in parts:
        stats.merge(p)


class ReadQCTool(ToolBase):
    name = "ReadQC"
    description = "Calculates QC metrics on unprocessed NGS reads."
    changelog = [
        (2023, 4, 18, "Added support for LongRead"),
        (2021, 2, 3, "Added option to write out merged input FASTQs (out1/out2)."),
        (2016, 8, 19, "Added support for multiple input files."),
    ]

    def setup(self):
        self.add_infile_list("in1", "Forward input gzipped FASTQ file(s).")
        self.add_infile_list("in2", "Reverse input gzipped FASTQ file(s) for paired-end mode (same number of cycles/reads as 'in1').", optional=True)
        self.add_outfile("out", "Output qcML file. If unset, writes to STDOUT.", optional=True)
        self.add_flag("txt", "Writes TXT format instead of qcML.")
        self.add_outfile("out1", "If set, writes merged forward FASTQs to this file (gzipped).", optional=True)
        self.add_outfile("out2", "If set, writes merged reverse FASTQs to this file (gzipped)", optional=True)
        self.add_int("compression_level", "Output FASTQ compression level from 1 (fastest) to 9 (best compression).", optional=True, default=1)
        self.add_flag("long_read", "Support long reads (> 1kb).")

    def main(self):
        in1 = self.get_infile_list("in1")
        in2 = self.get_infile_list("in2")
        if in2 and len(in1) != len(in2):
            raise ToolError("Input file lists 'in1' and 'in2' differ in counts!")

        long_read = self.get_flag("long_read")
        compression_level = self.get_int("compression_level")
        out1 = self.get_outfile("out1")
        out2 = self.get_outfile("out2")
        w1 = FastqWriter(out1, compression_level) if out1 else None
        w2 = FastqWriter(out2, compression_level) if out2 else None

        # NOTE reference quirk: StatisticsReads' single_end ctor arg receives
        # the *long_read* flag (ReadQC/main.cpp: `StatisticsReads stats(long_read)`),
        # so N50/median/mode extras appear exactly when -long_read is set.
        stats = ReadStatistics(single_end=long_read)

        from ..utils.prefetch import prefetch

        infiles = []
        for i, f1 in enumerate(in1):
            n1 = 0
            reader = FastqReader(f1, keep_headers=w1 is not None, long_read=long_read)
            # decode thread overlaps device compute (P1 pipeline analogue)
            if w1 is None and w2 is None:
                _consume_parallel(stats, reader, FORWARD)
            else:
                for batch in prefetch(reader, depth=2):
                    stats.update_batch(batch, FORWARD)
                    if w1:
                        w1.write_batch(batch)
            n1 = reader.reads_seen
            infiles.append(f1)
            if i < len(in2):
                reader2 = FastqReader(in2[i], keep_headers=w2 is not None, long_read=long_read)
                if w1 is None and w2 is None:
                    _consume_parallel(stats, reader2, REVERSE)
                else:
                    for batch in prefetch(reader2, depth=2):
                        stats.update_batch(batch, REVERSE)
                        if w2:
                            w2.write_batch(batch)
                if n1 != reader2.reads_seen:
                    raise ToolError(f"Differing number of reads in file '{f1}' and '{in2[i]}'!")
                infiles.append(in2[i])

        metrics = stats.get_result()
        out = self.get_outfile("out")
        if self.get_flag("txt"):
            lines = metrics.to_string_list()
            text = "".join(line + "\n" for line in lines)
            if out:
                with open(out, "w") as fh:
                    fh.write(text)
            else:
                sys.stdout.write(text)
        else:
            metrics.store_to_qcml(out if out else None, infiles, self._parameters)

        if w1:
            w1.close()
        if w2:
            w2.close()

    _parameters = ""

    def execute(self, argv):
        self._parameters = " ".join(argv)
        return super().execute(argv)


TOOLS = {"ReadQC": ReadQCTool}
