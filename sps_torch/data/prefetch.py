"""Scan prefetcher for replay: a worker thread loads scan i+1 from disk
while scan i is on the device (the port's counterpart of
sps_tpu/native::Replayer, which wraps the C++ replayer of csrc/sps_io.cpp;
this one is numpy and a thread, and the port builds no native code).

    for padded, rows in Replayer(paths, cap_rows=131072, cols=4):
        ...

Each item is (padded, rows): a zero-padded (cap_rows, cols) float32 array
holding the scan's first min(N, cap_rows) rows and first min(C, cols)
columns, and that row count. A scan that fails to load raises IOError in
the consumer, at its place in the sequence.
"""

from __future__ import annotations

import queue
import threading

import numpy as np


DEPTH = 4  # scans loaded ahead


class Replayer:
    """Iterator over padded scans, loaded ahead by a worker thread into a
    queue of at most DEPTH scans. close() (or the end of a `with` block)
    stops the worker."""

    def __init__(self, paths: list[str], cap_rows: int, cols: int):
        self.paths = list(paths)
        self.cap_rows = cap_rows
        self.cols = cols
        self._next = 0
        self._queue: queue.Queue = queue.Queue(maxsize=DEPTH)
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def _load(self, path: str):
        a = np.load(path)
        if a.dtype.kind != "f" or a.ndim not in (1, 2):
            raise ValueError(f"{path}: expected a 1-D or 2-D float array, got {a.dtype} "
                             f"{a.shape}")
        a = a.reshape(len(a), -1)
        out = np.zeros((self.cap_rows, self.cols), np.float32)
        rows, cols = min(len(a), self.cap_rows), min(a.shape[1], self.cols)
        out[:rows, :cols] = a[:rows, :cols]
        return out, rows

    def _run(self):
        for path in self.paths:
            try:
                item = self._load(path)
            except Exception as e:  # reported to the consumer as IOError
                item = (path, e)
            while not self._stop.is_set():
                try:
                    self._queue.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            if self._stop.is_set():
                return

    def __iter__(self):
        return self

    def __next__(self):
        if self._next >= len(self.paths):
            raise StopIteration
        item = self._queue.get()
        self._next += 1
        if isinstance(item[1], Exception):
            raise IOError(f"replayer failed to load scan {item[0]}") from item[1]
        return item

    def close(self):
        self._stop.set()
        while True:
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break
        self._worker.join(timeout=10)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
