"""Background-thread batch prefetching.

Copy of `musicnlp_tpu/utils/prefetch.py` (standard library only; the port
imports nothing from the JAX package).  The counterpart of the reference's
`dataloader_num_workers=4`: host-side augmentation (numpy gathers) overlaps
device steps via a small bounded queue.  One thread suffices -- the id-space
augmentation chain is ~100x cheaper than the reference's string pipeline.

If the consumer abandons the generator early (an exception mid-epoch, a
`break`), closing it signals the worker to exit instead of leaving it
parked on a full queue for the life of the process.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

__all__ = ['prefetch']

_SENTINEL = object()


def prefetch(it: Iterator, size: int = 2) -> Iterator:
    q: queue.Queue = queue.Queue(maxsize=size)
    stop = threading.Event()
    err = []

    def _put(x) -> bool:
        # bounded put that stays responsive to consumer abandonment
        while not stop.is_set():
            try:
                q.put(x, timeout=0.05)
                return True
            except queue.Full:
                pass
        return False

    def worker():
        try:
            for x in it:
                if not _put(x):
                    return
        except BaseException as e:           # surface in consumer thread
            err.append(e)
        finally:
            _put(_SENTINEL)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            x = q.get()
            if x is _SENTINEL:
                break
            yield x
        if err:
            raise err[0]
    finally:
        stop.set()
