"""Stdlib socket RPC for replica workers — length-prefixed pickle frames.

The fleet's control plane (``submit`` / ``poll`` / ``cancel`` / ``health``)
crosses process boundaries over this: one :class:`RpcServer` per worker
process, one :class:`RpcClient` per remote replica handle in the gateway.
Deliberately tiny — blocking sockets, a thread per server connection,
length-prefixed pickle frames — because the payloads are token lists and
status enums, not tensors (bulk KV traffic rides XLA collectives or the
disaggregation handoff, never arbitrary objects).

Frame format: ``u32 pickle_len | u32 n_buffers | pickle`` followed by
``n_buffers`` × ``u64 len | raw bytes``.  The pickle is protocol 5 with a
``buffer_callback``, so large contiguous buffers (the numpy page blocks of
a cross-host KV handoff, ``pull_pages``/``push_pages`` payloads) travel
OUT-OF-BAND: the in-band pickle stays a few hundred bytes of structure
while each buffer is sent straight from its memoryview with zero in-band
copy, and received into exactly-sized bytearrays that ``pickle.loads``
rehydrates in place.  Ordinary ops (ints, strings, small lists) produce
zero out-of-band buffers and behave exactly as before.

Both ends are the same codebase, so exceptions travel by pickle: a worker
raising :class:`~.admission.ShedError` re-raises as ``ShedError`` in the
gateway with ``reason`` / ``retry_after`` intact.  An exception that won't
pickle degrades to ``RuntimeError(repr)`` rather than poisoning the
connection.

Connection failures surface as :class:`RpcError` — the remote-replica layer
maps those to replica death.  Fault points ``rpc.send`` / ``rpc.recv``
(:mod:`paddle_tpu_torch.testing.faults`, ctx has ``op``) fire client-side around
the request/response halves so chaos tests can sever a live worker's
channel without touching the process.

Request tracing rides the frame as a third element: a request is
``(op, kwargs, trace_ctx)`` where ``trace_ctx`` is
:func:`~paddle_tpu_torch.observability.flight.wire_context`'s tiny
``(trace_id, lamport)`` tuple or None; a reply is
``(status, value, lamport)``.  The server adopts the sender's Lamport
stamp and installs the context ambiently around the handler, so worker-side
span events join the caller's trace with monotone causal ordering; the
client folds the reply stamp back in.  Both ends still accept bare
two-element frames from peers predating the ctx field.
"""
from __future__ import annotations

import pickle
import socket
import struct
import threading

from ...observability import flight as _flight
from ...testing import faults as _faults

__all__ = ["RpcError", "RpcServer", "RpcClient"]

_OK, _ERR = 0, 1


class RpcError(ConnectionError):
    """The RPC channel itself failed (connect, send, or recv) — distinct
    from an exception the remote handler raised, which re-raises as
    itself."""


def _encode_frame(obj):
    """Split ``obj`` into (in-band pickle, out-of-band buffer list) — the
    protocol-5 fast path.  Factored from the socket write so tests can
    assert bytes-on-the-wire without a socket."""
    bufs: list = []
    try:
        payload = pickle.dumps(obj, protocol=5, buffer_callback=bufs.append)
        return payload, [b.raw() for b in bufs]
    except BufferError:
        # a non-contiguous buffer cannot ship raw: fall back to in-band
        return pickle.dumps(obj, protocol=5), []


def _send_frame(sock, obj):
    payload, bufs = _encode_frame(obj)
    sock.sendall(struct.pack("!II", len(payload), len(bufs)) + payload)
    for raw in bufs:
        sock.sendall(struct.pack("!Q", raw.nbytes))
        sock.sendall(raw)             # memoryview: no in-band copy


def _recv_frame(sock):
    hdr = _recv_exact(sock, 8)
    n, nbufs = struct.unpack("!II", hdr)
    payload = _recv_exact(sock, n)
    bufs = []
    for _ in range(nbufs):
        (blen,) = struct.unpack("!Q", _recv_exact(sock, 8))
        bufs.append(_recv_exact(sock, blen))
    return pickle.loads(payload, buffers=bufs)


def _recv_exact(sock, n):
    buf = bytearray(n)
    view, got = memoryview(buf), 0
    while got < n:
        k = sock.recv_into(view[got:])
        if not k:
            raise RpcError("rpc connection closed")
        got += k
    return buf


class RpcServer:
    """Serve ``handler(op, kwargs)`` over TCP until :meth:`close`.

    Each accepted connection gets a daemon thread running request frames in
    a loop; :meth:`close` shuts the listener down and joins the accept
    thread (per-connection threads exit when their peer disconnects or the
    listener's close unblocks them).
    """

    def __init__(self, handler, host="127.0.0.1", port=0):
        self.handler = handler
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._srv.bind((host, port))
            self._srv.listen(128)
            self.host, self.port = host, self._srv.getsockname()[1]
        except OSError:
            # bind/listen failure (EADDRINUSE on a worker respawn) must not
            # leak the listener fd: the caller never gets a server to close
            self._srv.close()
            raise
        self._accept_thread = None
        self._closing = False
        self._conns = set()
        self._conns_lock = threading.Lock()

    def start(self):
        if self._accept_thread is None:
            self._accept_thread = threading.Thread(
                target=self._accept_loop, name=f"rpc-accept-{self.port}",
                daemon=True)
            self._accept_thread.start()
        return self

    def _accept_loop(self):
        while True:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return  # listener closed: shut down
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._conns_lock:
                if self._closing:
                    conn.close()
                    return
                self._conns.add(conn)
            threading.Thread(target=self._serve, args=(conn,),
                             name=f"rpc-conn-{self.port}",
                             daemon=True).start()

    def _serve(self, conn):
        try:
            while True:
                try:
                    frame = _recv_frame(conn)
                except (RpcError, OSError, EOFError, pickle.UnpicklingError):
                    return
                # (op, kw, trace_ctx) since the tracing plane; accept the
                # bare (op, kw) frame from peers predating the ctx field
                op, kw = frame[0], frame[1]
                ctx = _flight.adopt_wire(frame[2] if len(frame) > 2 else None)
                try:
                    with _flight.use_context(ctx):
                        reply = (_OK, self.handler(op, kw),
                                 _flight.wire_context())
                except BaseException as e:  # noqa: BLE001 — RPC boundary
                    try:
                        pickle.dumps(e)
                    except Exception:
                        e = RuntimeError(f"unpicklable remote error: {e!r}")
                    reply = (_ERR, e, None)
                try:
                    _send_frame(conn, reply)
                except OSError:
                    return
        finally:
            conn.close()
            with self._conns_lock:
                self._conns.discard(conn)

    def close(self):
        with self._conns_lock:
            self._closing = True
            conns = list(self._conns)
        try:
            self._srv.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._srv.close()
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            c.close()
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=10.0)
            self._accept_thread = None


class RpcClient:
    """Call a worker's ops over a small pool of pooled connections.

    One socket per *concurrent* call (checked out of a free list, returned
    on success) so long-polling one stream never serializes another; a
    socket that errors is discarded, not reused.  All channel failures
    raise :class:`RpcError`; remote handler exceptions re-raise as
    themselves.
    """

    def __init__(self, host, port, connect_timeout=5.0, call_timeout=60.0):
        self.host, self.port = host, int(port)
        self.connect_timeout = float(connect_timeout)
        self.call_timeout = float(call_timeout)
        self._free = []
        self._lock = threading.Lock()
        self.closed = False

    def _checkout(self):
        with self._lock:
            if self.closed:
                raise RpcError("rpc client closed")
            if self._free:
                return self._free.pop()
        try:
            sock = socket.create_connection((self.host, self.port),
                                            timeout=self.connect_timeout)
        except OSError as e:
            raise RpcError(
                f"cannot reach worker at {self.host}:{self.port}: {e}") from e
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            sock.close()                # a leaked fd per failed checkout
            raise                       # starves the pool under retry loops
        return sock

    def _checkin(self, sock):
        with self._lock:
            if not self.closed and len(self._free) < 8:
                self._free.append(sock)
                return
        sock.close()

    def call(self, op, deadline=None, ctx=None, **kw):
        """One round trip: returns the handler's value or re-raises its
        exception.  ``deadline`` bounds the whole call socket-side (the
        server adds no deadline of its own); it is a separate parameter so
        ops are free to take a ``timeout`` kwarg of their own.  ``ctx`` is
        the trace context to thread through the frame — pass
        :func:`~paddle_tpu_torch.observability.flight.wire_context`'s tuple for a
        request-scoped call, or an explicit None for control-plane traffic
        (graftlint AT103 flags call sites that silently drop it)."""
        sock = self._checkout()
        try:
            sock.settimeout(self.call_timeout if deadline is None
                            else float(deadline))
            _faults.FAULTS.maybe_fire("rpc.send", op=op)
            try:
                _send_frame(sock, (op, kw, ctx))
            except OSError as e:
                raise RpcError(f"rpc send failed ({op}): {e}") from e
            _faults.FAULTS.maybe_fire("rpc.recv", op=op)
            try:
                reply = _recv_frame(sock)
            except (OSError, EOFError, pickle.UnpicklingError) as e:
                raise RpcError(f"rpc recv failed ({op}): {e}") from e
        except BaseException:
            sock.close()
            raise
        self._checkin(sock)
        status, value = reply[0], reply[1]
        if len(reply) > 2 and reply[2] is not None:
            _flight.adopt_wire(reply[2])   # fold the server's clock back in
        if status == _ERR:
            raise value
        return value

    def close(self):
        with self._lock:
            self.closed = True
            free, self._free = self._free, []
        for s in free:
            s.close()
