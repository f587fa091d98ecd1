"""In-process topic bus of the port: a copy of ``tpufcn/serve/bus.py``.

The reference's inter-process fabric is ROS pub-sub with two sync
policies: exact-time ``TimeSynchronizer`` (queue 10) and 4-way
``ApproximateTime`` sync (queue 100).  This module keeps the semantics of
the JAX package's bus: topic names, bounded per-subscriber queues that
drop the oldest message (the reference publishes with ``queue_size=1``, so
stale frames are dropped, not queued), spin hooks, and both synchronizer
policies, as a thread-safe in-process bus.  It is a copy, not an import:
``tpufcn.serve`` imports JAX, which the port never does.  The C++
point-map node (``torchfcn.pointmap``) binds to the same bus.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Message:
    stamp: float                # seconds (header.stamp equivalent)
    data: Any
    seq: int = 0


class _Subscription:
    def __init__(self, callback: Callable[[Message], None], queue_size: int):
        self.callback = callback
        self.queue: deque = deque(maxlen=queue_size)  # drop-oldest
        self.lock = threading.Lock()

    def push(self, msg: Message):
        with self.lock:
            self.queue.append(msg)

    def drain(self) -> List[Message]:
        with self.lock:
            out = list(self.queue)
            self.queue.clear()
        return out


class TopicBus:
    """Publish/subscribe with per-subscriber bounded queues.

    ``spin_once`` delivers queued messages on the caller's thread (like
    rospy's single-threaded spinner); ``publish`` never blocks.
    """

    def __init__(self):
        self._subs: Dict[str, List[_Subscription]] = {}
        self._seq = itertools.count()
        self._lock = threading.Lock()
        self._spin_hooks: List[Callable[[], None]] = []

    def add_spin_hook(self, fn: Callable[[], None]) -> None:
        """Register idle work run at the END of every ``spin_once`` (the
        rospy.Timer analog, but on the spinner thread so hooks never
        race message callbacks).  Used by nodes that need progress
        without fresh messages — e.g. the detector's micro-batch
        deadline flush."""
        with self._lock:
            self._spin_hooks.append(fn)

    def subscribe(self, topic: str, callback: Callable[[Message], None],
                  queue_size: int = 1) -> _Subscription:
        sub = _Subscription(callback, queue_size)
        with self._lock:
            self._subs.setdefault(topic, []).append(sub)
        return sub

    def publish(self, topic: str, data: Any,
                stamp: Optional[float] = None) -> Message:
        import time as _time
        msg = Message(stamp if stamp is not None else _time.time(),
                      data, next(self._seq))
        with self._lock:
            subs = list(self._subs.get(topic, ()))
        for s in subs:
            s.push(msg)
        return msg

    def spin_once(self):
        with self._lock:
            subs = [s for lst in self._subs.values() for s in lst]
            hooks = list(self._spin_hooks)
        for s in subs:
            for msg in s.drain():
                s.callback(msg)
        for h in hooks:
            h()

    def topics(self) -> List[str]:
        with self._lock:
            return sorted(self._subs)


class TimeSynchronizer:
    """Exact-stamp N-way synchronizer (message_filters.TimeSynchronizer).

    Fires the callback once every topic has a message with an identical
    stamp; per-topic queues are bounded (default 10, as the reference
    capture node uses)."""

    def __init__(self, bus: TopicBus, topics: Sequence[str],
                 callback: Callable[..., None], queue_size: int = 10):
        self.topics = list(topics)
        self.callback = callback
        self.queue_size = queue_size
        self._store: Dict[str, Dict[float, Message]] = {t: {} for t in topics}
        self._order: Dict[str, deque] = {t: deque() for t in topics}
        self._lock = threading.Lock()
        for t in topics:
            bus.subscribe(t, self._make_cb(t), queue_size=queue_size)

    def _make_cb(self, topic: str):
        def cb(msg: Message):
            with self._lock:
                store = self._store[topic]
                order = self._order[topic]
                if msg.stamp not in store:
                    order.append(msg.stamp)
                store[msg.stamp] = msg
                while len(order) > self.queue_size:
                    old = order.popleft()
                    store.pop(old, None)
                common = msg.stamp
                if all(common in self._store[t] for t in self.topics):
                    msgs = [self._store[t].pop(common) for t in self.topics]
                    # ROS exact-time policy: a fired match also discards
                    # every OLDER queued message, so a late-arriving old
                    # message can never complete a stale tuple and fire
                    # it after a newer one (time would run backwards for
                    # the consumer)
                    for t in self.topics:
                        st, od = self._store[t], self._order[t]
                        stale = [s for s in od if s <= common]
                        for s in stale:
                            try:
                                od.remove(s)
                            except ValueError:
                                pass
                            st.pop(s, None)
                else:
                    msgs = None
            if msgs is not None:
                self.callback(*msgs)
        return cb


class ApproximateTimeSynchronizer:
    """N-way approximate-time policy (message_filters ApproximateTime).

    Greedy pivot formulation: whenever every queue is non-empty, take the
    latest head as pivot, pick the closest message per topic; fire if the
    spread is within ``slop``, else drop the oldest overall head."""

    def __init__(self, bus: TopicBus, topics: Sequence[str],
                 callback: Callable[..., None], queue_size: int = 100,
                 slop: float = 0.1):
        self.topics = list(topics)
        self.callback = callback
        self.queue_size = queue_size
        self.slop = slop
        self._queues: Dict[str, deque] = {t: deque() for t in topics}
        self._lock = threading.Lock()
        for t in topics:
            bus.subscribe(t, self._make_cb(t), queue_size=queue_size)

    def _make_cb(self, topic: str):
        def cb(msg: Message):
            fire: Optional[List[Message]] = None
            with self._lock:
                q = self._queues[topic]
                q.append(msg)
                while len(q) > self.queue_size:
                    q.popleft()
                fire = self._try_match()
            if fire is not None:
                self.callback(*fire)
        return cb

    def _try_match(self) -> Optional[List[Message]]:
        while all(self._queues[t] for t in self.topics):
            pivot = max(self._queues[t][0].stamp for t in self.topics)
            chosen: List[Tuple[str, Message]] = []
            for t in self.topics:
                best = min(self._queues[t],
                           key=lambda m: abs(m.stamp - pivot))
                chosen.append((t, best))
            stamps = [m.stamp for _, m in chosen]
            if max(stamps) - min(stamps) <= self.slop:
                for t, m in chosen:
                    # drop everything up to and including the chosen msg
                    q = self._queues[t]
                    while q and q[0].stamp <= m.stamp:
                        q.popleft()
                return [m for _, m in chosen]
            # no match: drop the single oldest head and retry
            oldest = min(self.topics,
                         key=lambda t: self._queues[t][0].stamp)
            self._queues[oldest].popleft()
        return None
