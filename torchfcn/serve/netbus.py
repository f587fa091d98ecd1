"""Cross-process topic bus of the port: the TCPROS-analog transport
(``tpufcn/serve/netbus.py``, ported with the same wire protocol, byte for
byte, so that the port's clients and brokers talk to the JAX package's).

The in-process :class:`torchfcn.serve.bus.TopicBus` replaces ROS pub-sub
semantics within one process; the reference system, however, runs its
nodes as SEPARATE OS processes wired over TCP (reference
launch/fcn_point_map.launch:3-19 launches the C++ point-map node next
to the Python detector node; scripts/fcn_object_detector.py:330-331
subscribes with ``tcp_nodelay=True``).  This module supplies that
missing half: a broker-forwarded TCP fabric with the same drop-oldest
queue semantics, so a launch graph can be split across processes
(``cli bus`` + ``cli launch --bus tcp://host:port --nodes ...``).

Components
----------
* ``RemoteTopicBus`` — a drop-in :class:`TopicBus` that mirrors every
  publish to a broker and injects remotely published messages into its
  local subscription queues.  Node code is unchanged: synchronizers,
  DetectorNode, the point-map node all run over it as they are.
* ``PyBroker`` — a pure-Python broker thread speaking the same wire
  protocol, for hosts without a C++ toolchain and for unit tests.
* ``start_broker`` — runs the native C++ broker
  (``torchfcn/netbus/broker.cpp``, built with ``g++`` into
  ``torchfcn/_build`` at first use, like the point-map library) or, with
  ``native="auto"``, falls back to ``PyBroker`` where it does not build.

Wire protocol (see broker.cpp header for the byte layout): length-
prefixed frames; SUB/UNSUB carry a topic, PUB carries topic + stamp +
seq + an opaque payload.  The payload's first byte is an ENCODING tag:
0x00 = pickle (protocol 5, anything), 0x01 = raw ndarray (dtype +
shape header + the array bytes — TCPROS-style binary message framing).
Numeric ndarrays (camera frames, point clouds, masks) take the raw
path on BOTH ends: the sender scatter-gathers the array buffer
straight into ``sendmsg`` (no pickle copy), the receiver reads the
frame into ONE preallocated buffer (recv_into) and returns a zero-copy
``np.frombuffer`` view over it (writable, privately owned — but shared
by every in-process subscriber, the usual bus aliasing rules).  The
broker forwards payloads opaquely either way.  Same trust model as TCPROS: an unauthenticated
fabric for a trusted robot LAN; never expose the broker port publicly.
"""

from __future__ import annotations

import os
import pickle
import socket
import struct
import subprocess
import threading

from torchfcn.serve.bus import TopicBus

_SUB = 0x01
_UNSUB = 0x02
_PUB = 0x03

# payload encodings (first payload byte)
_ENC_PICKLE = 0x00
_ENC_NDARRAY = 0x01

_NETBUS_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "netbus")


def _frame(kind: int, body: bytes) -> bytes:
    return struct.pack(">IB", 1 + len(body), kind) + body


def _pub_body(topic: str, stamp: float, seq: int, payload: bytes) -> bytes:
    t = topic.encode("utf-8")
    return struct.pack(">H", len(t)) + t + struct.pack(">dQ", stamp, seq) \
        + payload


def _parse_pub(body):
    (tlen,) = struct.unpack_from(">H", body, 0)
    topic = bytes(body[2:2 + tlen]).decode("utf-8")
    stamp, seq = struct.unpack_from(">dQ", body, 2 + tlen)
    payload = body[2 + tlen + 16:]
    return topic, stamp, seq, payload


def _encode_payload(data):
    """-> list of bytes-like parts (scatter-gather into sendmsg).

    Plain numeric ndarrays ride the raw framing — tag + dtype-str +
    ndim + dims, then the array buffer itself WITHOUT a pickle copy;
    everything else (tuples, dataclasses, object arrays, non-contiguous
    exotic strides are normalized first) falls back to pickle."""
    import numpy as np
    if (type(data) is np.ndarray and data.dtype.kind in "biufc"
            and not data.dtype.hasobject and data.ndim <= 255):
        arr = np.ascontiguousarray(data)
        dt = arr.dtype.str.encode("ascii")      # e.g. b"<u1", b"<f4"
        # shape from the ORIGINAL: ascontiguousarray promotes 0-d to 1-d
        head = (bytes([_ENC_NDARRAY, len(dt)]) + dt
                + bytes([data.ndim])
                + struct.pack(f">{data.ndim}Q", *data.shape))
        # zero-size views cannot be cast; their buffer is empty anyway
        return [head, memoryview(arr).cast("B") if arr.size else b""]
    return [bytes([_ENC_PICKLE]), pickle.dumps(data, protocol=5)]


def _decode_payload(payload):
    """Inverse of ``_encode_payload`` over a memoryview/bytes payload.

    Raw ndarrays come back as a ZERO-COPY view over the received frame
    buffer (np.frombuffer) — writable iff the buffer is (bytearray from
    the socket reader: yes; immutable bytes: no)."""
    import numpy as np
    enc = payload[0]
    if enc == _ENC_NDARRAY:
        dlen = payload[1]
        dt = np.dtype(bytes(payload[2:2 + dlen]).decode("ascii"))
        off = 2 + dlen
        ndim = payload[off]
        off += 1
        shape = struct.unpack_from(f">{ndim}Q", payload, off)
        off += 8 * ndim
        return np.frombuffer(payload, dtype=dt, offset=off).reshape(shape)
    if enc == _ENC_PICKLE:
        return pickle.loads(payload[1:])
    raise ValueError(f"unknown netbus payload encoding {enc:#x}")


def _sendmsg_all(sock: socket.socket, parts) -> None:
    """sendall over a LIST of buffers via scatter-gather sendmsg —
    the array buffer goes to the kernel directly, no join copy.
    Handles partial sends (sendmsg may stop mid-list)."""
    mv = [memoryview(p).cast("B") if not isinstance(p, memoryview) else p
          for p in parts]
    while mv:
        n = sock.sendmsg(mv)
        while mv and n >= len(mv[0]):
            n -= len(mv[0])
            mv.pop(0)
        if mv and n:
            mv[0] = mv[0][n:]


def _read_exact(sock: socket.socket, n: int):
    """Read exactly n bytes into ONE preallocated buffer (recv_into).

    The naive ``buf += chunk`` loop re-copies the partial frame on
    every ~64 KB recv — ~7 copies of a VGA frame, and it was the
    measured receive-side bottleneck of the fabric.  Returns a
    bytearray (so ndarray payloads decoded over it are writable
    views), or None on EOF."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:])
        if r == 0:
            return None
        got += r
    return buf


class RemoteTopicBus(TopicBus):
    """TopicBus attached to a broker: local semantics + TCP forwarding.

    ``publish`` delivers to this process's subscribers directly (exactly
    like the in-process bus) and sends one PUB frame to the broker,
    which forwards it to every OTHER connected process subscribed to the
    topic.  A background reader thread turns inbound PUB frames into
    local queue pushes; ``spin_once`` then delivers them on the caller's
    thread, preserving the single-threaded-spinner model.
    """

    def __init__(self, address: str, reconnect: bool = True,
                 retry_interval: float = 0.5):
        super().__init__()
        self._host, self._port = parse_address(address)
        self.reconnect = reconnect
        self.retry_interval = retry_interval
        self.dropped_publishes = 0   # PUB frames lost while disconnected
        self._topics = set()         # for re-SUB after a reconnect
        self._wlock = threading.Lock()
        self._closed = False
        self._sock = self._connect()
        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self._reader.start()

    def _connect(self) -> socket.socket:
        sock = socket.create_connection((self._host, self._port))
        # Linux TCP self-connect quirk: connecting to a DOWN port in the
        # ephemeral range can simultaneously-open onto ITSELF (source
        # port == dest port), so sends would "succeed" into our own
        # reader.  Treat it as a failed attempt.
        if sock.getsockname() == sock.getpeername():
            sock.close()
            raise ConnectionRefusedError("self-connect (broker down)")
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock

    # -- TopicBus surface -------------------------------------------------
    def subscribe(self, topic, callback, queue_size: int = 1):
        sub = super().subscribe(topic, callback, queue_size)
        with self._wlock:
            self._topics.add(topic)
        self._send(_frame(_SUB, topic.encode("utf-8")), best_effort=True)
        return sub

    def publish(self, topic, data, stamp=None):
        # local subscribers are served regardless of broker health (the
        # in-process half of the bus never depends on the network)
        msg = super().publish(topic, data, stamp)
        payload_parts = _encode_payload(data)
        payload_len = sum(p.nbytes if isinstance(p, memoryview) else len(p)
                          for p in payload_parts)
        t = topic.encode("utf-8")
        body_head = (struct.pack(">H", len(t)) + t
                     + struct.pack(">dQ", msg.stamp, msg.seq))
        total = 1 + len(body_head) + payload_len
        ok = self._send_parts(
            [struct.pack(">IB", total, _PUB) + body_head, *payload_parts],
            best_effort=self.reconnect)
        if not ok:
            self.dropped_publishes += 1
        return msg

    # -- transport --------------------------------------------------------
    def _send(self, frame: bytes, best_effort: bool = False) -> bool:
        return self._send_parts([frame], best_effort=best_effort)

    def _send_parts(self, parts, best_effort: bool = False) -> bool:
        with self._wlock:
            if self._closed:
                if best_effort:
                    return False
                raise ConnectionError("netbus connection closed")
            try:
                _sendmsg_all(self._sock, parts)
                return True
            except OSError:
                if best_effort:
                    return False
                raise

    def _read_loop(self):
        from torchfcn.serve.bus import Message
        while True:
            sock = self._sock
            try:
                while True:
                    head = _read_exact(sock, 4)
                    if head is None:
                        break
                    (length,) = struct.unpack(">I", head)
                    body = _read_exact(sock, length)
                    if body is None or body[0] != _PUB:
                        break
                    # memoryview end to end: the payload (and a raw
                    # ndarray decoded from it) stays a view over `body`
                    topic, stamp, seq, payload = _parse_pub(
                        memoryview(body)[1:])
                    data = _decode_payload(payload)
                    msg = Message(stamp, data, seq)
                    with self._lock:
                        subs = list(self._subs.get(topic, ()))
                    for s in subs:
                        s.push(msg)
            except OSError:
                pass
            if self._closed or not self.reconnect:
                return
            # broker went away: retry until it is back (ROS nodes
            # outlive a roscore restart the same way), then re-SUB
            while not self._closed:
                try:
                    new_sock = self._connect()
                except OSError:
                    import time as _time
                    _time.sleep(self.retry_interval)
                    continue
                with self._wlock:
                    if self._closed:
                        new_sock.close()
                        return
                    try:
                        self._sock.close()
                    except OSError:
                        pass
                    self._sock = new_sock
                    topics = sorted(self._topics)
                try:
                    for t in topics:
                        self._send(_frame(_SUB, t.encode("utf-8")),
                                   best_effort=True)
                except OSError:
                    continue
                break
            if self._closed:
                return

    def close(self):
        with self._wlock:
            self._closed = True
            try:
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            self._sock.close()


class PyBroker:
    """Pure-Python broker: one reader thread per connection, the same
    wire protocol and drop-oldest outbox stance as the C++ broker (the
    Python outbox is the socket send buffer plus a bounded frame deque).
    """

    def __init__(self, port: int = 0, max_outbox: int = 64):
        self.max_outbox = max_outbox
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(("127.0.0.1", port))
        self._listener.listen(64)
        self.port = self._listener.getsockname()[1]
        self._lock = threading.Lock()
        self._subs = {}       # topic -> set of _Client
        self._clients = set()
        self._stop = threading.Event()
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()

    class _Client:
        def __init__(self, sock, broker):
            self.sock = sock
            self.broker = broker
            self.topics = set()
            self.outbox = []          # bounded frame list
            self.cond = threading.Condition()
            self.dead = False

        def enqueue(self, frame: bytes):
            with self.cond:
                self.outbox.append(frame)
                while len(self.outbox) > self.broker.max_outbox:
                    self.outbox.pop(0)   # drop-oldest
                self.cond.notify()

        def write_loop(self):
            while True:
                with self.cond:
                    while not self.outbox and not self.dead:
                        self.cond.wait(0.5)
                    if self.dead:
                        return
                    frames = self.outbox
                    self.outbox = []
                try:
                    self.sock.sendall(b"".join(frames))
                except OSError:
                    return

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return
            if self._stop.is_set():
                # stop() raced us while blocked in accept()
                sock.close()
                return
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            client = PyBroker._Client(sock, self)
            with self._lock:
                self._clients.add(client)
            threading.Thread(target=self._client_loop, args=(client,),
                             daemon=True).start()
            threading.Thread(target=client.write_loop, daemon=True).start()

    def _client_loop(self, client):
        sock = client.sock
        try:
            while True:
                head = _read_exact(sock, 4)
                if head is None:
                    break
                (length,) = struct.unpack(">I", head)
                body = _read_exact(sock, length)
                if body is None:
                    break
                kind = body[0]
                if kind == _SUB:
                    topic = body[1:].decode("utf-8")
                    with self._lock:
                        client.topics.add(topic)
                        self._subs.setdefault(topic, set()).add(client)
                elif kind == _UNSUB:
                    topic = body[1:].decode("utf-8")
                    with self._lock:
                        client.topics.discard(topic)
                        self._subs.get(topic, set()).discard(client)
                elif kind == _PUB:
                    (tlen,) = struct.unpack_from(">H", body, 1)
                    topic = body[3:3 + tlen].decode("utf-8")
                    frame = struct.pack(">I", length) + body
                    with self._lock:
                        receivers = list(self._subs.get(topic, ()))
                    for r in receivers:
                        if r is not client:
                            r.enqueue(frame)
                else:
                    break
        except OSError:
            pass
        with self._lock:
            self._clients.discard(client)
            for t in client.topics:
                self._subs.get(t, set()).discard(client)
        with client.cond:
            client.dead = True
            client.cond.notify()
        try:
            sock.close()
        except OSError:
            pass

    def stop(self):
        self._stop.set()
        try:
            # shutdown BEFORE close: a thread blocked in accept() holds
            # the open file description, so close() alone leaves the
            # socket listening (and the next connect would be accepted
            # by a "stopped" broker); shutdown aborts the accept
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            clients = list(self._clients)
        for c in clients:
            with c.cond:
                c.dead = True
                c.cond.notify()
            try:
                c.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.sock.close()
            except OSError:
                pass


class BrokerHandle:
    """Uniform handle over the native subprocess / PyBroker thread."""

    def __init__(self, port: int, proc=None, pybroker=None):
        self.port = port
        self.address = f"tcp://127.0.0.1:{port}"
        self._proc = proc
        self._py = pybroker

    def stop(self):
        if self._proc is not None:
            self._proc.terminate()
            try:
                self._proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self._proc.kill()
                self._proc.wait()
            self._proc = None
        if self._py is not None:
            self._py.stop()
            self._py = None


def build_broker() -> str:
    """The native broker's path, compiled with ``g++`` into
    ``torchfcn/_build`` first if needed."""
    from pathlib import Path

    from torchfcn.utils import native
    return str(native.build("torchfcn_bus_broker",
                            [Path(_NETBUS_DIR) / "broker.cpp"],
                            shared=False))


def start_broker(port: int = 0, native: str = "auto",
                 max_outbox: int = 64) -> BrokerHandle:
    """Start a broker and return its handle.

    ``native`` — "yes" requires the C++ broker, "no" forces PyBroker,
    "auto" tries the native build and falls back.
    """
    if native in ("auto", "yes"):
        try:
            binary = build_broker()
            proc = subprocess.Popen(
                [binary, "--port", str(port), "--max-outbox",
                 str(max_outbox)],
                stdout=subprocess.PIPE, text=True)
            line = proc.stdout.readline().strip()
            if line.startswith("PORT "):
                return BrokerHandle(int(line.split()[1]), proc=proc)
            proc.terminate()
            raise RuntimeError(f"native broker failed to start: {line!r}")
        except (OSError, subprocess.CalledProcessError, RuntimeError):
            if native == "yes":
                raise
    py = PyBroker(port=port, max_outbox=max_outbox)
    return BrokerHandle(py.port, pybroker=py)


def parse_address(address: str):
    """``tcp://host:port`` or ``host:port`` -> (host, port)."""
    addr = address
    if addr.startswith("tcp://"):
        addr = addr[len("tcp://"):]
    host, _, port = addr.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"bus address must be tcp://host:port, got "
                         f"{address!r}")
    return host, int(port)
