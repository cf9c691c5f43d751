"""Prefetching loader and host-to-device staging of reader items.

``PrefetchLoader`` is the JAX package's (``pgdvs_tpu.data.loader``): a
bounded-lookahead thread pool that assembles dataset items ahead of the
consumer, in order. Threads suffice: item assembly is file reads, zlib,
the C un-filter and numpy, which release the interpreter lock in their
native cores.

``contract_to_device`` moves one item's arrays to a device as tensors;
``to_device_prefetch`` stages the next item on the card while the current
one is consumed: pinned host copies, ``non_blocking`` copies on a side CUDA
stream, each host buffer held until its copy's event has completed, and
the consumer's stream made to wait on that event before it sees the item.
"""

from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, Optional, Sequence

import numpy as np
import torch


class PrefetchLoader:
    """Ordered prefetching iterator over an indexable dataset.

    Args:
      dataset: indexable (``__getitem__`` / ``__len__``) or iterable.
      n_workers: assembly threads (0 = synchronous passthrough).
      lookahead: max items materialized ahead of the consumer.
      indices: optional explicit index order (striding, shuffling).
    """

    def __init__(self, dataset, n_workers: int = 2, lookahead: int = 4,
                 indices: Optional[Sequence[int]] = None):
        self.dataset = dataset
        self.n_workers = max(0, int(n_workers))
        self.lookahead = max(1, int(lookahead))
        if indices is None and hasattr(dataset, "__len__"):
            indices = range(len(dataset))
        self.indices = indices

    def __len__(self):
        if self.indices is not None:
            return len(self.indices)
        return len(self.dataset)

    def __iter__(self) -> Iterator:
        if self.indices is None:
            return self._iter_iterable(iter(self.dataset))
        if self.n_workers == 0:
            return (self.dataset[i] for i in self.indices)
        return self._iter_indexed()

    def _iter_indexed(self):
        with ThreadPoolExecutor(max_workers=self.n_workers) as pool:
            pending = []
            it = iter(self.indices)
            try:
                for _ in range(self.lookahead):
                    pending.append(pool.submit(self.dataset.__getitem__, next(it)))
            except StopIteration:
                it = None
            while pending:
                fut = pending.pop(0)
                if it is not None:
                    try:
                        pending.append(pool.submit(self.dataset.__getitem__, next(it)))
                    except StopIteration:
                        it = None
                yield fut.result()

    def _iter_iterable(self, it):
        q: "queue.Queue" = queue.Queue(maxsize=self.lookahead)
        end = object()

        def producer():
            try:
                for item in it:
                    q.put(item)
                q.put(end)
            except Exception as e:  # noqa: BLE001 — raised again in the consumer
                q.put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, Exception):
                raise item
            yield item


def _resolve(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} asked for, but torch.cuda.is_available() is false")
    return device


def contract_to_device(item: dict, device="cuda") -> dict:
    """The item with every numpy array as a tensor on ``device`` (same
    dtype); ``misc``, strings and other values pass through as they are."""
    device = _resolve(device)
    return {k: torch.as_tensor(v).to(device) if isinstance(v, np.ndarray) else v
            for k, v in item.items()}


def to_device_prefetch(loader: Iterable, device="cuda") -> Iterator[dict]:
    """Yield each item of ``loader`` with its arrays on ``device``, the next
    item's copies issued before the current one is yielded.

    On a card: each array is copied into pinned host memory, then to the
    card with ``non_blocking=True`` on a side stream, and an event recorded
    after the item's copies. The pinned buffers stay referenced until that
    event has completed, so none is freed or reused under a running copy.
    Before an item is yielded the consumer's current stream waits on its
    event, and each of its device tensors is marked as used on that stream
    (``record_stream``), so the caching allocator does not hand its memory
    to the copy stream while the consumer's work on it is queued. On the
    CPU it is ``contract_to_device`` per item.
    """
    device = _resolve(device)
    if device.type != "cuda":
        for item in loader:
            yield contract_to_device(item, device)
        return

    copy_stream = torch.cuda.Stream(device)
    in_flight = collections.deque()  # (event, pinned host tensors)

    def stage(item):
        pinned, out = [], {}
        with torch.cuda.stream(copy_stream):
            for k, v in item.items():
                if isinstance(v, np.ndarray):
                    host = torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                    pinned.append(host)
                    out[k] = host.to(device, non_blocking=True)
                else:
                    out[k] = v
            event = torch.cuda.Event()
            event.record(copy_stream)
        in_flight.append((event, pinned))
        return out, event

    def release_done():
        while in_flight and in_flight[0][0].query():
            in_flight.popleft()

    def hand_over(staged):
        out, event = staged
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(event)
        for v in out.values():
            if torch.is_tensor(v):
                v.record_stream(consumer)
        release_done()
        return out

    it = iter(loader)
    try:
        ahead = stage(next(it))
    except StopIteration:
        return
    try:
        for item in it:
            nxt = stage(item)
            yield hand_over(ahead)
            ahead = nxt
        yield hand_over(ahead)
    finally:
        for event, _ in in_flight:
            event.synchronize()
        in_flight.clear()
