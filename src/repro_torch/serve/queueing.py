"""Bounded request queue with deadlines for the SpGEMM service.

The queue is the service's backpressure valve (DESIGN.md §10): admission
never blocks — a request either takes a bounded slot (ADMITTED), or is shed
with a typed :class:`~repro_torch.core.errors.AdmissionRejectedError` the moment
the queue is full.  Deadlines are absolute service-clock times checked at
every scheduling point; :meth:`BoundedQueue.expire` removes and returns
every request whose deadline passed while queued, so an overloaded service
degrades into *fast typed rejections*, never a silently growing backlog.

No threads: the service is a synchronous event loop (submit / step /
drain), which is what makes the chaos soak deterministic — every scheduling
decision happens at a visible program point.
"""
from __future__ import annotations

import collections

from repro_torch.core.errors import AdmissionRejectedError


class BoundedQueue:
    """FIFO of requests with a hard capacity and deadline expiry.

    ``push`` raises :class:`AdmissionRejectedError` when full (the caller
    sheds the request); ``push_front`` re-admits a request the scheduler
    already holds (escalated retry, budget backpressure) ahead of the line
    and is allowed one transient slot over capacity — a requeue must never
    turn an admitted request into a shed one.
    """

    def __init__(self, capacity: int) -> None:
        self.capacity = int(capacity)
        if self.capacity <= 0:
            raise ValueError(f"queue capacity must be positive, "
                             f"got {capacity}")
        self._q: collections.deque = collections.deque()
        self.shed = 0        # counters for service stats
        self.expired = 0

    def __len__(self) -> int:
        return len(self._q)

    @property
    def full(self) -> bool:
        return len(self._q) >= self.capacity

    def push(self, req) -> None:
        if self.full:
            self.shed += 1
            raise AdmissionRejectedError(
                f"queue full ({len(self._q)}/{self.capacity}); request "
                f"{req.id} shed", reason="queue_full", request=req.id,
                observed=len(self._q), planned=self.capacity)
        self._q.append(req)

    def push_front(self, req) -> None:
        self._q.appendleft(req)

    def restore(self, reqs) -> None:
        """Return popped-but-not-dispatched requests to the tail in their
        original relative order (batch gathering passed over them); bypasses
        the capacity check for the same reason as :meth:`push_front`."""
        self._q.extend(reqs)

    def restore_front(self, reqs) -> None:
        """Return popped-but-not-dispatched requests to the FRONT in their
        original relative order — used when batch gathering stops early
        (batch full): the passed-over requests must stay ahead of requests
        that were never popped, or queue order silently rotates."""
        self._q.extendleft(reversed(reqs))

    def pop(self):
        return self._q.popleft() if self._q else None

    def promote_earliest(self) -> None:
        """Rotate the queued request with the EARLIEST deadline to the
        front (shortest-deadline-first dispatch).  Requests without a
        deadline never outrank one that has one; ties and an all-FIFO
        queue keep their submit order bit-for-bit — the promotion moves
        exactly one element, so the relative order of everything else is
        untouched."""
        if len(self._q) < 2:
            return
        best, best_i = None, None
        for i, req in enumerate(self._q):
            d = req.deadline
            if d is not None and (best is None or d < best):
                best, best_i = d, i
        if best_i is None or best_i == 0:
            return
        req = self._q[best_i]
        del self._q[best_i]
        self._q.appendleft(req)

    def expire(self, now: float) -> list:
        """Remove and return every queued request whose deadline passed."""
        if not self._q:
            return []
        live, dead = [], []
        for req in self._q:
            (dead if (req.deadline is not None and req.deadline <= now)
             else live).append(req)
        if dead:
            self._q = collections.deque(live)
            self.expired += len(dead)
        return dead

    def stats(self) -> dict:
        return dict(depth=len(self._q), capacity=self.capacity,
                    shed=self.shed, expired=self.expired)
