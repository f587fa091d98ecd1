"""The port's topic bus and synchronizers (``torchfcn/serve/bus.py``)
against tpufcn's on the same publish sequences: the delivered messages
(data, stamps, order) must be identical.  Cases of
``tests/test_bus_stream.py``: drop-oldest queues, exact-time sync,
four-way approximate sync, the stale drop after an exact match, spin
hooks; and a seeded random sequence through both synchronizers."""

import numpy as np
import pytest

from tpufcn.serve import bus as jbus
from torchfcn.serve import bus as tbus


def _both(case):
    """Run ``case(bus_module)`` on both packages; return both results."""
    return case(jbus), case(tbus)


def _same(case):
    want, got = _both(case)
    assert got == want
    return got


def test_bus_queue_drops_oldest():
    def case(m):
        bus = m.TopicBus()
        got = []
        bus.subscribe("t", lambda msg: got.append((msg.data, msg.seq)),
                      queue_size=1)
        big = []
        bus.subscribe("t", lambda msg: big.append(msg.data), queue_size=2)
        for i in (1, 2, 3):
            bus.publish("t", i, stamp=float(i))
        bus.spin_once()
        return got, big, bus.topics()
    assert _same(case) == ([(3, 2)], [2, 3], ["t"])


def test_spin_hooks_run_after_delivery():
    def case(m):
        bus = m.TopicBus()
        log = []
        bus.subscribe("t", lambda msg: log.append(("msg", msg.data)),
                      queue_size=4)
        bus.add_spin_hook(lambda: log.append(("hook",)))
        bus.publish("t", "a", stamp=0.0)
        bus.publish("t", "b", stamp=1.0)
        bus.spin_once()
        bus.spin_once()
        return log
    assert _same(case) == [("msg", "a"), ("msg", "b"), ("hook",), ("hook",)]


def test_exact_time_sync():
    def case(m):
        bus = m.TopicBus()
        fired = []
        m.TimeSynchronizer(bus, ["a", "b"], lambda ma, mb: fired.append(
            (ma.data, mb.data)), queue_size=10)
        bus.publish("a", "a1", stamp=1.0)
        bus.publish("b", "b2", stamp=2.0)     # no match
        bus.publish("b", "b1", stamp=1.0)     # matches a1
        bus.spin_once()
        return fired
    assert _same(case) == [("a1", "b1")]


def test_approx_time_sync_four_way():
    def case(m):
        bus = m.TopicBus()
        fired = []
        m.ApproximateTimeSynchronizer(
            bus, ["c", "m", "p", "coef"],
            lambda *ms: fired.append(tuple((x.data, x.stamp) for x in ms)),
            queue_size=100, slop=0.05)
        for topic, data, stamp in (("c", "cloud", 1.00), ("m", "mask", 1.01),
                                   ("p", "pmap", 1.02),
                                   ("coef", "coef", 1.03)):
            bus.publish(topic, data, stamp=stamp)
        bus.spin_once()
        for topic, stamp in (("c", 2.0), ("m", 3.0), ("p", 4.0),
                             ("coef", 5.0)):
            bus.publish(topic, topic + "2", stamp=stamp)   # never fire
        bus.spin_once()
        return fired
    assert len(_same(case)) == 1


def test_time_synchronizer_drops_stale_after_match():
    def case(m):
        bus = m.TopicBus()
        fired = []
        m.TimeSynchronizer(bus, ["a", "b"],
                           lambda ma, mb: fired.append(ma.stamp),
                           queue_size=10)
        bus.publish("a", "a1", stamp=1.0)
        bus.publish("a", "a2", stamp=2.0)
        bus.publish("b", "b2", stamp=2.0)
        bus.spin_once()
        bus.publish("b", "b1", stamp=1.0)   # late: its partner was purged
        bus.spin_once()
        bus.publish("a", "a3", stamp=3.0)
        bus.publish("b", "b3", stamp=3.0)
        bus.spin_once()
        return fired
    assert _same(case) == [2.0, 3.0]


@pytest.mark.parametrize("sync", ["exact", "approx"])
def test_random_sequences_deliver_identically(sync):
    """200 seeded publishes on 3 topics, stamps rising by about one every 5
    publishes, some late, with jitter for the approximate policy; queues
    small enough to drop: both packages fire the same tuples in the same
    order."""
    rng = np.random.default_rng(3)
    topics = ["x", "y", "z"]
    seq = [(topics[rng.integers(3)],
            float(max(0, i // 5 - rng.integers(0, 3)))
            + (0.0 if sync == "exact" else float(rng.uniform(0, 0.2))))
           for i in range(200)]
    spins = set(rng.choice(200, 60, replace=False).tolist())

    def case(m):
        bus = m.TopicBus()
        fired = []
        cb = (lambda *ms: fired.append(tuple((x.data, x.stamp)
                                              for x in ms)))
        if sync == "exact":
            m.TimeSynchronizer(bus, topics, cb, queue_size=5)
        else:
            m.ApproximateTimeSynchronizer(bus, topics, cb, queue_size=6,
                                          slop=0.15)
        for i, (topic, stamp) in enumerate(seq):
            bus.publish(topic, i, stamp=stamp)
            if i in spins:
                bus.spin_once()
        bus.spin_once()
        return fired
    assert len(_same(case)) > 5
