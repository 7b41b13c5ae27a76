"""Host-side batch prefetching: batch assembly on a background thread while
the card runs the step before it (counterpart of the JAX package's
``data/prefetch.py``).

Batch assembly (load, quantize, pyramid and kernel maps, collate) is host
work of seconds per training batch; without a prefetcher it runs between
device steps. The reference trains with a 2-worker DataLoader (reference
main.py:118-123); ``--num_workers`` sets the depth here.

Threads, not processes: the hot parts are numpy sorts and stacks, which
release the GIL, and a thread passes its pyramid without pickling it. A
worker runs host work only: it never touches CUDA, and the caller moves
each batch to the card in its own thread.

Determinism: the prepare function gets all it needs with its item (the
training loop's pre-drawn per-batch seed among it), one worker keeps the
dataset's own draws in their order, and results come in submission order,
so the trajectory is the same at every depth, depth 0 (a plain map, no
thread) included.

Spans (``utils/profiling.py``): ``agile3d.data.prepare`` around each
``fn(item)``, on the worker thread or inline, and ``agile3d.data.wait``
around the consumer's wait for each result (inline: around the prepare),
closed before the result is yielded.
"""

from __future__ import annotations

import threading
from typing import Callable, Iterator, Sequence, TypeVar

from agile3d_torch.utils.profiling import annotate

T = TypeVar("T")
R = TypeVar("R")


class _WorkerError:
    def __init__(self, exc: BaseException):
        self.exc = exc


class BatchPrefetcher:
    """``fn(item)`` over ``items`` on background threads, yielded in order,
    with at most ``depth`` results prepared and not yet taken. Depth 0 is
    a synchronous map. A worker's exception is raised in the caller at its
    item. ``workers`` > 1 is allowed, but one keeps the draw order of a
    dataset's shared generator."""

    def __init__(self, fn: Callable[[T], R], items: Sequence[T],
                 depth: int = 2, workers: int = 1):
        self._fn = fn
        self._items = list(items)
        self._depth = max(0, depth)
        self._workers = max(1, min(workers, self._depth or 1))
        self._stop = False
        if self._depth > 0:
            self._sem = threading.Semaphore(self._depth)
            self._cv = threading.Condition()
            self._results: dict[int, object] = {}
            self._next_claim = 0
            self._threads = [
                threading.Thread(target=self._work, daemon=True,
                                 name=f"prefetch-{i}")
                for i in range(self._workers)]
            for t in self._threads:
                t.start()

    def _work(self):
        while True:
            self._sem.acquire()
            with self._cv:
                if self._stop or self._next_claim >= len(self._items):
                    return
                i = self._next_claim
                self._next_claim += 1
            try:
                with annotate("agile3d.data.prepare"):
                    r: object = self._fn(self._items[i])
            except BaseException as e:  # handed to the consumer
                r = _WorkerError(e)
            with self._cv:
                self._results[i] = r
                self._cv.notify_all()

    def __iter__(self) -> Iterator[R]:
        if self._depth == 0:
            for it in self._items:
                with annotate("agile3d.data.wait"), \
                        annotate("agile3d.data.prepare"):
                    r = self._fn(it)
                yield r
            return
        try:
            for i in range(len(self._items)):
                with annotate("agile3d.data.wait"), self._cv:
                    while i not in self._results and not self._stop:
                        self._cv.wait(timeout=1.0)
                    if self._stop:
                        return
                    r = self._results.pop(i)
                self._sem.release()
                if isinstance(r, _WorkerError):
                    raise r.exc
                yield r
        finally:
            self.close()

    def __len__(self) -> int:
        return len(self._items)

    def close(self):
        """Stop the workers (idempotent)."""
        if self._depth == 0 or self._stop:
            return
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        for _ in range(self._workers):
            self._sem.release()
