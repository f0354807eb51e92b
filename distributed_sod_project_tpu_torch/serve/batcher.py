"""Dynamic micro-batching into the engine's static batch buckets.

Same grouping semantics as the JAX ``serve/batcher.py``: requests queue
per ``(resolution bucket, precision arm)``, FIFO within a key; a full
group (the largest batch bucket) dispatches at once, oldest head first,
and otherwise the group of the globally oldest request dispatches once
that request has waited ``max_wait_s``, even if nothing else arrives.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .admission import QueueFull


@dataclass
class Request:
    """One in-flight prediction: ``tensor`` is the preprocessed
    ``(res, res, 3)`` float32 input; the future resolves to ``(pred,
    meta)`` with ``pred`` float32 at the ORIGINAL ``orig_hw``."""

    tensor: np.ndarray
    orig_hw: Tuple[int, int]
    res_bucket: int
    arrival: float
    precision: str = "f32"
    future: Future = field(default_factory=Future)

    @property
    def bucket_key(self) -> Tuple[int, str]:
        """Coalescing key: one warmed forward per (resolution, arm)."""
        return (self.res_bucket, self.precision)


class DynamicBatcher:
    """Thread-safe coalescing queue over per-bucket-key deques."""

    def __init__(self, batch_buckets, max_wait_s: float,
                 max_queue: Optional[int] = None, clock=time.monotonic):
        buckets = sorted(int(b) for b in batch_buckets)
        if not buckets or buckets[0] < 1:
            raise ValueError(f"bad batch_buckets {batch_buckets!r}")
        self.batch_buckets = tuple(buckets)
        self.max_batch = buckets[-1]
        self.max_wait_s = float(max_wait_s)
        self.max_queue = max_queue
        self._clock = clock
        self._queues: Dict[Tuple[int, str], deque] = {}
        self._cv = threading.Condition()
        self._closed = False

    def put(self, req: Request) -> None:
        """Enqueue, or raise :class:`QueueFull`; the depth check and the
        append share the lock so concurrent producers cannot overshoot."""
        with self._cv:
            if self._closed:
                raise RuntimeError("batcher is closed")
            if self.max_queue is not None:
                depth = sum(len(q) for q in self._queues.values())
                if depth >= self.max_queue:
                    raise QueueFull(
                        f"queue at capacity ({depth}/{self.max_queue})")
            self._queues.setdefault(req.bucket_key, deque()).append(req)
            self._cv.notify_all()

    def pending(self) -> int:
        with self._cv:
            return sum(len(q) for q in self._queues.values())

    def _oldest_head(self) -> Optional[Request]:
        head = None
        for q in self._queues.values():
            if q and (head is None or q[0].arrival < head.arrival):
                head = q[0]
        return head

    def _next_group_locked(self, now: float) -> Optional[Tuple[int, str]]:
        """The key that should dispatch right now, or None: the full
        group with the oldest head, else the oldest head's group once it
        is past ``max_wait_s``."""
        head = self._oldest_head()
        if head is None:
            return None
        full = None
        for q in self._queues.values():
            if len(q) >= self.max_batch and (
                    full is None or q[0].arrival < full[0].arrival):
                full = q
        if full is not None:
            return full[0].bucket_key
        if head.arrival + self.max_wait_s <= now:
            return head.bucket_key
        return None

    def get_batch(self, idle_timeout_s: float
                  ) -> Optional[Tuple[Tuple[int, str], List[Request]]]:
        """Next group as ``((res_bucket, precision), requests)``, or
        None after ``idle_timeout_s`` with an empty queue."""
        idle_deadline = self._clock() + idle_timeout_s
        with self._cv:
            while True:
                if self._closed:
                    return None
                now = self._clock()
                key = self._next_group_locked(now)
                if key is not None:
                    q = self._queues[key]
                    n = min(len(q), self.max_batch)
                    return key, [q.popleft() for _ in range(n)]
                head = self._oldest_head()
                if head is None:
                    if now >= idle_deadline:
                        return None
                    self._cv.wait(min(idle_deadline - now, 0.05))
                    continue
                self._cv.wait(min(head.arrival + self.max_wait_s - now, 0.05))

    def pick_batch_bucket(self, n: int) -> int:
        """Smallest batch bucket that fits ``n`` (the largest otherwise)."""
        for b in self.batch_buckets:
            if n <= b:
                return b
        return self.max_batch

    def close(self) -> List[Request]:
        """Stop accepting work; returns the still-queued requests so the
        engine can fail their futures."""
        with self._cv:
            self._closed = True
            drained = [r for q in self._queues.values() for r in q]
            self._queues.clear()
            self._cv.notify_all()
        return drained
