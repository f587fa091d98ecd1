"""The port's TCP bus (``torchfcn/serve/netbus.py`` and the native broker
``torchfcn/netbus/broker.cpp``) against tpufcn's.

The wire protocol is the same byte for byte: the payload encoder writes
the same bytes as tpufcn's for raw ndarrays and pickles, and clients and
brokers of the two packages interoperate in both directions (the port's
``RemoteTopicBus`` through tpufcn's ``PyBroker`` and native broker,
tpufcn's client through the port's native broker and ``PyBroker``).  Then
the port's versions of ``tests/test_netbus.py``'s cases on its own
brokers: round trip, self-delivery, drop-oldest, the outbox bound,
reconnect after a broker restart, mixed encodings on one topic.
"""

import os
import time

import numpy as np
import pytest

from tpufcn.serve import netbus as jnet
from torchfcn.serve import netbus as tnet


def _wait_for(pred, timeout=5.0, spin=None):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if spin is not None:
            spin()
        if pred():
            return True
        time.sleep(0.01)
    return pred()


@pytest.fixture(params=["native", "python"])
def broker(request):
    handle = tnet.start_broker(native="yes" if request.param == "native"
                               else "no")
    yield handle
    handle.stop()


PAYLOADS = (np.arange(12, dtype=np.uint8).reshape(3, 4),
            np.ones((2, 2), np.float32), np.array(5, np.int64),
            np.arange(6, dtype=np.complex64), np.zeros((0, 3), np.uint16),
            np.arange(24, dtype=np.int32).reshape(4, 6)[::2, ::3],
            {"a": 1}, [np.ones(2), "x"], None)


def test_payload_bytes_equal_tpufcn():
    for obj in PAYLOADS:
        got = b"".join(bytes(p) for p in tnet._encode_payload(obj))
        want = b"".join(bytes(p) for p in jnet._encode_payload(obj))
        assert got == want
        out = tnet._decode_payload(memoryview(want))
        if isinstance(obj, np.ndarray):
            assert out.dtype == obj.dtype and out.shape == obj.shape
            np.testing.assert_array_equal(out, obj)
            assert not out.flags.writeable     # a view over the frame
        else:
            assert type(out) is type(obj)
    assert tnet._frame(tnet._SUB, b"/t") == jnet._frame(jnet._SUB, b"/t")
    assert tnet._pub_body("/t", 1.5, 7, b"x") == \
        jnet._pub_body("/t", 1.5, 7, b"x")
    assert tnet.parse_address("tcp://127.0.0.1:45") == ("127.0.0.1", 45)
    for bad in ("nocolon", "tcp://host:notaport"):
        with pytest.raises(ValueError):
            tnet.parse_address(bad)


def _exchange(broker_address, pub_mod, sub_mod):
    """Publish frames and a dict from a ``pub_mod`` client to a
    ``sub_mod`` client; returns what arrived."""
    a = pub_mod.RemoteTopicBus(broker_address)
    b = sub_mod.RemoteTopicBus(broker_address)
    try:
        got = []
        b.subscribe("/camera", lambda m: got.append(m), queue_size=16)
        time.sleep(0.2)       # SUB must reach the broker before PUB
        img = np.arange(2 * 3 * 3, dtype=np.uint8).reshape(2, 3, 3)
        a.publish("/camera", img, stamp=7.25)
        a.publish("/camera", {"kind": "meta"}, stamp=8.0)
        assert _wait_for(lambda: len(got) >= 2, spin=b.spin_once)
        assert [m.stamp for m in got] == [7.25, 8.0]
        np.testing.assert_array_equal(got[0].data, img)
        assert got[1].data == {"kind": "meta"}
        return got
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("native", ["yes", "no"])
def test_interop_both_directions(native):
    """The port's clients through tpufcn's broker, tpufcn's clients
    through the port's, and a port client talking to a tpufcn client."""
    for broker_mod in (jnet, tnet):
        handle = broker_mod.start_broker(native=native)
        try:
            assert (handle._proc is not None) == (native == "yes")
            _exchange(handle.address, tnet, tnet)
            _exchange(handle.address, jnet, jnet)
            _exchange(handle.address, tnet, jnet)
            _exchange(handle.address, jnet, tnet)
        finally:
            handle.stop()


def test_native_broker_builds_into_the_build_dir():
    path = tnet.build_broker()
    assert os.path.exists(path) and os.access(path, os.X_OK)
    from torchfcn.utils.native import BUILD_DIR
    assert os.path.dirname(path) == str(BUILD_DIR)


def test_self_delivery_is_local_not_doubled(broker):
    a = tnet.RemoteTopicBus(broker.address)
    try:
        got = []
        a.subscribe("/t", lambda m: got.append(m), queue_size=8)
        time.sleep(0.2)
        a.publish("/t", {"k": 1}, stamp=1.0)
        time.sleep(0.3)       # a broker echo would arrive in this window
        a.spin_once()
        assert len(got) == 1
    finally:
        a.close()


def test_drop_oldest_subscriber_queue(broker):
    a = tnet.RemoteTopicBus(broker.address)
    b = tnet.RemoteTopicBus(broker.address)
    try:
        got = []
        b.subscribe("/t", lambda m: got.append(m), queue_size=2)
        probe = b.subscribe("/probe", lambda m: None, queue_size=1)
        time.sleep(0.2)
        for i in range(5):
            a.publish("/t", i, stamp=float(i))
        # the probe follows the burst on the same connection: once it has
        # landed, every /t message has been pushed
        a.publish("/probe", "done", stamp=9.0)
        assert _wait_for(lambda: len(probe.queue) > 0)
        b.spin_once()
        assert [m.data for m in got] == [3, 4]
    finally:
        a.close()
        b.close()


def test_pybroker_outbox_bound_drops_oldest():
    py = tnet.PyBroker(max_outbox=4)
    try:
        client = tnet.PyBroker._Client(sock=None, broker=py)
        for i in range(10):
            client.enqueue(b"frame%d" % i)
        assert client.outbox == [b"frame6", b"frame7", b"frame8",
                                 b"frame9"]
    finally:
        py.stop()


def test_reconnect_after_broker_restart():
    py = tnet.PyBroker()
    port = py.port
    a = tnet.RemoteTopicBus(f"tcp://127.0.0.1:{port}", retry_interval=0.05)
    b = tnet.RemoteTopicBus(f"tcp://127.0.0.1:{port}", retry_interval=0.05)
    try:
        got, local = [], []
        b.subscribe("/t", lambda m: got.append(m.data), queue_size=16)
        a.subscribe("/t", lambda m: local.append(m.data), queue_size=16)
        time.sleep(0.2)
        a.publish("/t", "before", stamp=1.0)
        assert _wait_for(lambda: got, spin=b.spin_once)

        py.stop()
        time.sleep(0.2)
        a.publish("/t", "during", stamp=2.0)    # the broker is down
        a.spin_once()
        assert "during" in local                 # local delivery unaffected
        assert _wait_for(lambda: a.dropped_publishes >= 1,
                         spin=lambda: a.publish("/t", "during2", stamp=2.5))

        py2 = tnet.PyBroker(port=port)
        try:
            def attempt():
                a.publish("/t", "after", stamp=3.0)
                b.spin_once()
            assert _wait_for(lambda: "after" in got, spin=attempt,
                             timeout=10)
        finally:
            py2.stop()
    finally:
        a.close()
        b.close()
        py.stop()


def test_mixed_encodings_one_topic(broker):
    a = tnet.RemoteTopicBus(broker.address)
    b = tnet.RemoteTopicBus(broker.address)
    try:
        got = []
        b.subscribe("/t", lambda m: got.append(m.data), queue_size=8)
        time.sleep(0.2)
        img = np.arange(18, dtype=np.uint8).reshape(2, 3, 3)
        a.publish("/t", {"kind": "meta", "n": 3}, stamp=1.0)
        a.publish("/t", img, stamp=2.0)
        assert _wait_for(lambda: len(got) >= 2, spin=b.spin_once)
        assert got[0] == {"kind": "meta", "n": 3}
        np.testing.assert_array_equal(got[1], img)
        # a zero-copy view over the receive buffer (a bytearray: writable)
        assert got[1].base is not None and got[1].flags.writeable
    finally:
        a.close()
        b.close()
