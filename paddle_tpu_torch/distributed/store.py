"""TCPStore — rendezvous/control-plane key-value store (reference:
phi/core/distributed/store/tcp_store.h:121 MasterDaemon + tcp_utils; python
surface paddle.distributed.TCPStore).

Like the reference, the daemon is NATIVE C++ (core/native/store.cc, compiled
on first use): the master rank hosts it in-process and every rank (master
included) connects as a client speaking a tiny length-prefixed binary
protocol. A pure-Python server with the identical protocol is the fallback
when no toolchain is available. Values are opaque bytes (objects pickle
transparently in the client); `get` blocks until the key exists (the
reference's Wait semantics). This is the control plane only — bulk tensor
traffic rides XLA collectives, not this store.

Wire protocol (see store.cc):
  request : u8 cmd | u32 klen | key | u32 vlen | val | f64 timeout   (BE)
  response: u8 status (0 ok, 1 timeout, 2 bad, 3 deleted-miss) | u32 vlen | val
  cmds: 1 SET  2 GET  3 ADD (val = i64 BE)  4 DELETE  5 WAIT ('\n'-joined)
        6 CAS (val = u32 elen | expected | desired; elen 0 = expect-absent;
               reply val = u8 swapped | current bytes)

Lease-grade primitives (membership.py is the consumer):

- ``compare_and_set`` is an atomic read-modify-write on one key — the
  index-set updates of the membership plane ride it instead of a racy
  get+set.  The ``expected`` side compares RAW stored bytes (what
  ``get_raw`` returned), never a re-pickle: pickling a ``set`` is not
  byte-stable across processes, so value-level comparison would livelock.
- A blocking GET that observes the key being DELETEd mid-wait returns a
  typed miss (status 3 -> :class:`StoreKeyDeleted`) immediately instead of
  hanging until its timeout: a watcher reading a member key that the member
  just released sees a clean "gone", not a stall.
"""
from __future__ import annotations

import os
import pickle
import socket
import struct
import threading
import time

from ..core.retry import RetryError, RetryPolicy, retry_call
from ..testing.faults import FAULTS as _faults
from ..testing.faults import InjectedFault as _InjectedFault

_SET, _GET, _ADD, _DELETE, _WAIT, _CAS = 1, 2, 3, 4, 5, 6


class StoreKeyDeleted(KeyError):
    """A blocking read observed its key being deleted mid-wait (server
    status 3) — typed so callers can distinguish "released cleanly" from
    "never appeared" (:class:`TimeoutError`)."""

    def __init__(self, key):
        super().__init__(key)
        self.key = key


def _pack_req(cmd, key, val, timeout):
    k = key.encode() if isinstance(key, str) else key
    return (struct.pack("!B", cmd) + struct.pack("!I", len(k)) + k +
            struct.pack("!I", len(val)) + val + struct.pack("!d", timeout))


def _read_exact(sock, n):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("store connection closed")
        buf += chunk
    return buf


def _read_reply(sock):
    status = _read_exact(sock, 1)[0]
    (n,) = struct.unpack("!I", _read_exact(sock, 4))
    val = _read_exact(sock, n) if n else b""
    return status, val


class _PyStoreServer(threading.Thread):
    """Python fallback daemon speaking the same binary protocol."""

    def __init__(self, host, port):
        super().__init__(daemon=True)
        self._kv = {}
        self._dels = {}        # key -> deletion generation (see GET/DELETE)
        self._cv = threading.Condition()
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._srv.bind((host, port))
            self._srv.listen(128)
            self.port = self._srv.getsockname()[1]
        except OSError:
            # bind failure (EADDRINUSE on master restart) must not leak
            # the listener fd: the caller never gets a server to stop
            self._srv.close()
            raise

    def run(self):
        while True:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _reply(self, conn, status, val=b""):
        conn.sendall(struct.pack("!B", status) + struct.pack("!I", len(val))
                     + val)

    def _serve(self, conn):
        try:
            while True:
                cmd = _read_exact(conn, 1)[0]
                (kn,) = struct.unpack("!I", _read_exact(conn, 4))
                key = _read_exact(conn, kn).decode()
                (vn,) = struct.unpack("!I", _read_exact(conn, 4))
                val = _read_exact(conn, vn) if vn else b""
                (timeout,) = struct.unpack("!d", _read_exact(conn, 8))
                if cmd == _SET:
                    with self._cv:
                        self._kv[key] = val
                        self._cv.notify_all()
                    self._reply(conn, 0)
                elif cmd == _GET:
                    deadline = time.monotonic() + timeout
                    with self._cv:
                        # a DELETE processed while we wait bumps the key's
                        # deletion generation: reply a typed miss (status 3)
                        # immediately instead of stalling to the timeout
                        gen0 = self._dels.get(key, 0)
                        deleted = False
                        while key not in self._kv:
                            if self._dels.get(key, 0) != gen0:
                                deleted = True
                                break
                            left = deadline - time.monotonic()
                            if left <= 0:
                                break
                            self._cv.wait(left)
                        out = self._kv.get(key)
                    # reply OUTSIDE the lock like every other command path:
                    # sendall to one slow client must not stall the whole
                    # store (every GET/SET/WAIT contends on this condition)
                    if out is not None:
                        self._reply(conn, 0, out)
                    else:
                        self._reply(conn, 3 if deleted else 1)
                elif cmd == _ADD:
                    (delta,) = struct.unpack("!q", val)
                    with self._cv:
                        cur = int(self._kv.get(key, b"0")) + delta
                        self._kv[key] = str(cur).encode()
                        self._cv.notify_all()
                    self._reply(conn, 0, struct.pack("!q", cur))
                elif cmd == _DELETE:
                    with self._cv:
                        existed = self._kv.pop(key, None) is not None
                        self._dels[key] = self._dels.get(key, 0) + 1
                        self._cv.notify_all()
                    self._reply(conn, 0, b"1" if existed else b"0")
                elif cmd == _CAS:
                    (en,) = struct.unpack("!I", val[:4])
                    expected, desired = val[4:4 + en], val[4 + en:]
                    with self._cv:
                        cur = self._kv.get(key)
                        swapped = (cur is None) if en == 0 else (cur == expected)
                        if swapped:
                            self._kv[key] = desired
                            cur = desired
                            self._cv.notify_all()
                    self._reply(conn, 0, (b"\x01" if swapped else b"\x00")
                                + (cur or b""))
                elif cmd == _WAIT:
                    deadline = time.monotonic() + timeout
                    ok = True
                    with self._cv:
                        for k in key.split("\n") if key else []:
                            while k not in self._kv:
                                left = deadline - time.monotonic()
                                if left <= 0:
                                    ok = False
                                    break
                                self._cv.wait(left)
                            if not ok:
                                break
                    self._reply(conn, 0 if ok else 1)
                else:
                    self._reply(conn, 2)
        except (ConnectionError, EOFError, OSError, struct.error):
            pass
        finally:
            conn.close()


def _start_server(host, port):
    """Prefer the native C++ daemon; fall back to the Python thread.
    Returns (bound_port, server_kind)."""
    if os.environ.get("PADDLE_TPU_PURE_PY_STORE") != "1":
        from ..core.native.build import load
        lib = load("pt_store", "store.cc")
        if lib is not None:
            import ctypes
            lib.pt_store_start.restype = ctypes.c_int
            lib.pt_store_start.argtypes = [ctypes.c_char_p, ctypes.c_int]
            bound = lib.pt_store_start(host.encode(), port)
            if bound > 0:
                return bound, "native"
    srv = _PyStoreServer(host, port)
    srv.start()
    return srv.port, "python"


class TCPStore:
    """Client handle; rank `is_master` also hosts the daemon in-process."""

    def __init__(self, host="127.0.0.1", port=0, is_master=False,
                 world_size=1, timeout=300.0):
        self.timeout = timeout
        self.server_kind = None
        if is_master:
            bind = "0.0.0.0" if host == "127.0.0.1" else host
            port, self.server_kind = _start_server(bind, port)
        self.host, self.port = host, port
        # shared backoff-with-jitter policy (core/retry.py) instead of the
        # old flat 0.1s spin: a whole cohort connecting to a master that is
        # still binding decorrelates instead of stampeding.  The deadline
        # keeps the former `timeout` contract.
        policy = RetryPolicy(max_attempts=64, base_delay=0.05, max_delay=1.0,
                             deadline=timeout)
        try:
            self._sock = retry_call(self._connect, policy=policy,
                                    retry_on=(OSError, _InjectedFault),
                                    op="store.connect")
        except RetryError as e:
            raise TimeoutError(
                f"could not reach TCPStore at {host}:{port}") from e.__cause__
        self._lock = threading.Lock()

    def _connect(self):
        _faults.maybe_fire("store.connect", host=self.host, port=self.port)
        sock = socket.create_connection((self.host, self.port), timeout=5)
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            # blocking get/wait time out SERVER-side (protocol timeout
            # field); the connect timeout must not cap recv
            sock.settimeout(None)
        except OSError:
            sock.close()
            raise
        return sock

    def _rpc(self, cmd, key, val=b"", timeout=None):
        t = self.timeout if timeout is None else timeout
        with self._lock:
            # the server enforces t; the socket deadline is a dead-server
            # backstop with generous grace.  Socket I/O under _lock is the
            # lock's whole purpose: one shared socket, one in-flight RPC —
            # request/reply framing would interleave without it.
            self._sock.settimeout(t + 30)
            self._sock.sendall(  # graftlint: disable=concurrency
                _pack_req(cmd, key, val, t))
            status, out = _read_reply(self._sock)
        if status == 1:
            raise TimeoutError(f"TCPStore cmd {cmd} ({key!r}) timed out")
        if status == 3:
            raise StoreKeyDeleted(key)
        if status != 0:
            raise RuntimeError(f"TCPStore error status {status}")
        return out

    def set(self, key, value):
        self._rpc(_SET, key, pickle.dumps(value))

    def get(self, key, timeout=None):
        raw = self._rpc(_GET, key, timeout=timeout)
        try:
            return pickle.loads(raw)
        except Exception:
            # keys written by add() hold ASCII decimal (the C++ daemon does
            # arithmetic on them); surface those as ints like the reference
            try:
                return int(raw)
            except ValueError:
                return raw

    def get_raw(self, key, timeout=None):
        """Blocking read returning the EXACT stored bytes — the token
        :meth:`compare_and_set` compares against.  Same wait semantics and
        typed errors as :meth:`get`."""
        return self._rpc(_GET, key, timeout=timeout)

    def compare_and_set(self, key, expected, desired):
        """Atomic swap: install ``desired`` iff the key's current raw bytes
        equal ``expected``.  ``expected`` is the raw bytes a prior
        :meth:`get_raw` returned, or None to mean "key must be absent" (raw
        bytes, not a re-pickle: pickling is not byte-stable across
        processes).  ``desired`` is pickled unless already bytes.  Returns
        ``(swapped, current_raw)`` where ``current_raw`` is the stored bytes
        after the operation (None when the key is absent)."""
        if expected is not None and not isinstance(expected, bytes):
            raise TypeError("expected must be raw bytes from get_raw(), "
                            "or None for expect-absent")
        want = b"" if expected is None else expected
        if expected == b"":
            raise ValueError("empty expected bytes are reserved for "
                             "expect-absent (pass None)")
        if not isinstance(desired, bytes):
            desired = pickle.dumps(desired)
        out = self._rpc(_CAS, key,
                        struct.pack("!I", len(want)) + want + desired)
        return out[:1] == b"\x01", (out[1:] or None)

    def add(self, key, amount=1):
        out = self._rpc(_ADD, key, struct.pack("!q", int(amount)))
        return struct.unpack("!q", out)[0]

    def delete_key(self, key):
        return self._rpc(_DELETE, key) == b"1"

    def wait(self, keys, timeout=None):
        self._rpc(_WAIT, "\n".join(keys), timeout=timeout)
