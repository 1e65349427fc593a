"""Host-side prefetching batch loader (counterpart of ``tpumcia.io.loader``;
threads and queues only, no torch inside).

Feeds device computations from a (possibly lazy) host data source with
background threads: while the device processes batch i, batch i+1 is being
decoded/assembled on host — replacing the reference's fully sequential
read-one-extract-one loop (ipynb:358-364).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import numpy as np


def batched_indices(n: int, batch_size: int, *, drop_remainder: bool = False):
    """Yield [start, stop) index ranges."""
    stop = (n // batch_size) * batch_size if drop_remainder else n
    for i in range(0, stop, batch_size):
        yield np.arange(i, min(i + batch_size, stop))


class PrefetchLoader:
    """Iterate ``fetch(idx) -> batch`` over index chunks with ``depth``
    batches prepared ahead by a background thread.

    With ``stage`` given, decode and staging run as SEPARATE pipeline
    threads: the fetch thread decodes chunk i+2 while the stage thread
    (any callable; typically the H2D upload) stages chunk i+1 and
    the consumer computes on chunk i. Steady-state cost per chunk is then
    ``max(decode, upload, compute)`` instead of ``decode + upload``
    serialised in one worker.
    """

    def __init__(
        self,
        fetch: Callable[[np.ndarray], object],
        n: int | None = None,
        batch_size: int | None = None,
        *,
        depth: int = 2,
        drop_remainder: bool = False,
        chunks: list[np.ndarray] | None = None,
        stage: Callable[[object], object] | None = None,
    ):
        if chunks is None:
            if n is None or batch_size is None:
                raise ValueError("give either chunks or (n, batch_size)")
            chunks = list(
                batched_indices(n, batch_size, drop_remainder=drop_remainder)
            )
        self._fetch = fetch
        self._chunks = list(chunks)
        self._depth = depth
        self._stage = stage

    @property
    def chunks(self) -> list[np.ndarray]:
        return self._chunks

    def __len__(self):
        return len(self._chunks)

    def __iter__(self) -> Iterator:
        q: queue.Queue = queue.Queue(maxsize=self._depth)
        stop = object()
        # set when the consumer stops early (break / downstream error /
        # generator GC): without it, workers would block forever on a full
        # queue holding decoded multi-MB batches, and the fetch thread
        # would keep decoding the rest of the collection
        cancelled = threading.Event()

        def safe_put(sink, item) -> bool:
            while not cancelled.is_set():
                try:
                    sink.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def pump(source, sink, work):
            try:
                for kind, item in source():
                    if cancelled.is_set():
                        return
                    if kind != "ok":
                        safe_put(sink, (kind, item))
                        return
                    out = work(item)
                    if not safe_put(sink, ("ok", out)):
                        return
            except BaseException as e:  # surface worker errors downstream
                safe_put(sink, ("err", e))
            finally:
                safe_put(sink, ("end", stop))

        def chunk_source():
            for idx in self._chunks:
                yield ("ok", idx)

        threads = []
        if self._stage is None:
            threads.append(
                threading.Thread(
                    target=pump, args=(chunk_source, q, self._fetch),
                    daemon=True,
                )
            )
        else:
            mid: queue.Queue = queue.Queue(maxsize=self._depth)

            def mid_source():
                while True:
                    try:
                        kind, item = mid.get(timeout=0.2)
                    except queue.Empty:
                        if cancelled.is_set():
                            return
                        continue
                    if kind == "end":
                        return
                    yield (kind, item)

            threads.append(
                threading.Thread(
                    target=pump, args=(chunk_source, mid, self._fetch),
                    daemon=True,
                )
            )
            threads.append(
                threading.Thread(
                    target=pump, args=(mid_source, q, self._stage),
                    daemon=True,
                )
            )
        for t in threads:
            t.start()
        try:
            while True:
                kind, item = q.get()
                if kind == "err":
                    raise item
                if kind == "end":
                    break
                yield item
        finally:
            cancelled.set()  # normal completion: no-op; early exit: unblock
