"""Streaming HTTP/SSE gateway over a :class:`~.replica.ReplicaSet`.

Pure stdlib (same ``ThreadingHTTPServer`` discipline as
``observability/exporter.py`` — daemon threads, handle object with
``url``/``close()``): each request runs on its own handler thread and blocks
on the replica's condition variable, so N concurrent clients cost N parked
threads, not N polling loops.

Endpoints::

    POST /v1/completions   JSON body {"prompt": [token ids],
                           "max_tokens": n, "stream": bool, ...sampling}
    GET  /healthz          per-replica health snapshots (JSON) + a
                           ``fleet`` rollup (alive/draining counts, epochs,
                           pooled page/host-tier totals)
    GET  /metrics          Prometheus text exposition — the gateway's own
                           registry FEDERATED with every live remote
                           member's snapshot, remote series labeled
                           ``replica=``; a dead member is skipped within a
                           bounded scrape deadline and counted in
                           ``frontend_federation_errors_total``
    GET  /v1/requests/{rid}/trace
                           merged chrome-trace JSON for one request:
                           span events pulled from every fleet process plus
                           the gateway's own flight recorder, causally
                           ordered by Lamport stamps — load it straight
                           into chrome://tracing / Perfetto

Every ``POST /v1/completions`` is assigned a request id — taken from the
client's ``X-Request-ID`` header when present, minted otherwise — which is
ALSO the flight-recorder trace id.  It is echoed in the ``X-Request-ID``
response header and the JSON body (``request_id``), and is what
``/v1/requests/{rid}/trace`` looks up.

Terminal-status → HTTP mapping:

    SHED      429 Too Many Requests + Retry-After (admission or engine shed;
              decided before any tokens move, stream and non-stream alike)
    TIMEOUT   408 Request Timeout + Retry-After on the non-stream path; a
              stream that times out mid-flight has already sent 200 +
              tokens, so the deadline surfaces in the final SSE event's
              ``status``
    FAILED    500 on non-stream (error string in the body) / final-event
              status on streams
    CANCELLED client disconnect mid-stream — the handler detects the broken
              pipe on write and calls ``cancel(rid)`` so the engine frees
              the request's pages instead of decoding for nobody

Stream framing is SSE: one ``data: {"token": t, "index": i}`` event per
token, then ``data: {"status": ..., "usage": ...}``, then ``data: [DONE]``.

Passing ``journal_dir`` to :func:`start_gateway` turns on the **durable
request plane** (:mod:`.journal`):

- every accepted request is journaled (fsynced) before the response
  starts, keyed by the client's ``Idempotency-Key`` header (one is
  generated when absent and echoed back) — re-POSTing a known key replays
  the journaled stream/result without re-running anything on the fleet;
- durable SSE events carry ``id: <seq>``; a reconnecting client sends
  ``Last-Event-ID: <seq>`` and the gateway replays the journaled tokens
  after it, then splices onto the live stream;
- a mid-stream disconnect *detaches* (grace TTL) instead of cancelling,
  so the client can come back;
- a restarted gateway pointed at the same ``journal_dir`` replays the
  journal and re-drives unfinished requests via the engines'
  ``resume_tokens`` machinery; while that replay runs, ``/healthz``
  reports ``recovering: true`` and new submits shed 503 + Retry-After.
"""
from __future__ import annotations

import json
import threading
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ... import observability as _obs
from ...observability import flight as _flight
from ..serving import RequestStatus
from .admission import ShedError
from .journal import DurableRequestPlane
from .replica import ReplicaDeadError

__all__ = ["Gateway", "start_gateway"]

_SAMPLING_KEYS = ("eos_token_id", "do_sample", "temperature", "top_p",
                  "top_k", "seed", "deadline")


class Gateway:
    """Handle on a running gateway: ``addr``/``port``/``url`` + ``close()``.
    Owns the HTTP server only — the ReplicaSet's lifecycle stays with its
    creator (``close()`` does not stop the replicas)."""

    def __init__(self, httpd, thread, replica_set, plane=None):
        self._httpd = httpd
        self._thread = thread
        self.replica_set = replica_set
        self.plane = plane          # DurableRequestPlane in durable mode
        self.addr, self.port = httpd.server_address[:2]
        self.url = f"http://{self.addr}:{self.port}"

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=10.0)
        if self.plane is not None:
            # pumps stop, journal closes; inflight requests keep their
            # unjournaled-terminal state so a restart recovers them
            self.plane.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    replica_set = None       # bound per-server by start_gateway
    plane = None             # DurableRequestPlane, durable mode only
    ping_interval = 5.0      # idle seconds between SSE keep-alive comments
    request_id = None        # per-POST trace id (X-Request-ID)

    # ---- GET -----------------------------------------------------------------
    def do_GET(self):  # noqa: N802 (stdlib handler API)
        # instance state persists across requests on a keep-alive socket:
        # clear the id so a GET never echoes the previous POST's header
        self.request_id = None
        path = self.path.split("?")[0]
        if path == "/healthz":
            health = dict(self.replica_set.health())
            if self.plane is not None:
                # "journal" is a reserved key in durable mode (don't name a
                # replica that): journal depth + recovery state ride along
                health["journal"] = self.plane.health()
            # "fleet" is reserved too: the rollup external monitors page on
            # without walking every per-replica snapshot
            health["fleet"] = self._fleet_rollup(health)
            self._send_json(200, health)
        elif path == "/metrics":
            # federated exposition when the replica set can scrape its
            # members; a bare duck-typed set falls back to local-only
            fed = getattr(self.replica_set, "metrics_exposition", None)
            text = fed() if fed is not None else _obs.render_prometheus()
            body = text.encode("utf-8")
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif path.startswith("/v1/requests/") and path.endswith("/trace"):
            rid = path[len("/v1/requests/"):-len("/trace")]
            if not rid or "/" in rid:
                self._send_json(404, {"error": f"no route for {path}"})
                return
            fn = getattr(self.replica_set, "trace_events_fleet", None)
            events = (fn(rid) if fn is not None
                      else _flight.snapshot_events(rid))
            if not events:
                self._send_json(404,
                                {"error": f"no trace for request {rid!r}"})
                return
            self._send_json(200, _flight.chrome_trace(events))
        else:
            self._send_json(404, {"error": f"no route for {path}"})

    @staticmethod
    def _fleet_rollup(health):
        """Aggregate the per-replica snapshots into one fleet summary:
        liveness/draining counts, per-replica epochs, and pooled page
        totals (device free/reclaimable + host tier)."""
        rollup = {"replicas": 0, "alive": 0, "draining": 0, "epochs": {},
                  "active_slots": 0, "waiting": 0, "free_pages": 0,
                  "reclaimable_pages": 0, "host_cached_pages": 0,
                  "host_bytes": 0}
        for name, snap in health.items():
            if name in ("journal", "fleet") or not isinstance(snap, dict):
                continue
            rollup["replicas"] += 1
            if snap.get("alive"):
                rollup["alive"] += 1
            if snap.get("draining"):
                rollup["draining"] += 1
            if snap.get("epoch") is not None:
                rollup["epochs"][name] = snap["epoch"]
            for k in ("active_slots", "waiting", "free_pages",
                      "reclaimable_pages", "host_cached_pages",
                      "host_bytes"):
                v = snap.get(k)
                if isinstance(v, (int, float)):
                    rollup[k] += v
        return rollup

    # ---- POST /v1/completions ------------------------------------------------
    def do_POST(self):  # noqa: N802 (stdlib handler API)
        # cleared before parsing: a 400/404 on this request must not carry
        # the prior keep-alive request's X-Request-ID
        self.request_id = None
        if self.path.split("?")[0] != "/v1/completions":
            self._send_json(404, {"error": f"no route for {self.path}"})
            return
        try:
            req = self._read_body()
            prompt = req["prompt"]
            if not isinstance(prompt, list) or not all(
                    isinstance(t, int) for t in prompt):
                raise ValueError("'prompt' must be a list of token ids")
            kw = {k: req[k] for k in _SAMPLING_KEYS if k in req}
            kw["max_new_tokens"] = int(req.get("max_tokens", 16))
            stream = bool(req.get("stream", False))
        except (ValueError, KeyError, TypeError) as e:
            self._send_json(400, {"error": f"bad request: {e}"})
            return
        # one request id per accepted POST — the client's X-Request-ID when
        # present, minted otherwise — doubling as the flight-recorder trace
        # id; the ambient context threads it through routing, the durable
        # plane, RPC frames, and the engines without touching signatures
        _flight.set_proc_label("gateway")
        ctx = _flight.mint(self.headers.get("X-Request-ID") or None)
        self.request_id = ctx.trace_id
        with _flight.use_context(ctx):
            _flight.record("gateway_accept", trace_id=ctx.trace_id,
                           prompt_tokens=len(prompt), stream=stream)
            if self.plane is not None:
                self._durable_completion(prompt, kw, stream)
                return
            try:
                handle = self.replica_set.submit(prompt, **kw)
            except ShedError as e:
                self._send_json(429, {"error": str(e), "reason": e.reason},
                                headers={"Retry-After":
                                         str(max(1, int(e.retry_after)))})
                return
            except ReplicaDeadError as e:
                # dead fleet: carry Retry-After like the SHED 429 does, so
                # clients back off instead of hot-looping on 503s
                self._send_json(503, {"error": str(e)},
                                headers={"Retry-After": "1"})
                return
            except ValueError as e:
                self._send_json(400, {"error": str(e)})
                return
            if stream:
                self._stream_response(handle)
            else:
                self._blocking_response(handle)

    def _blocking_response(self, handle):
        rs = self.replica_set
        tokens, status = rs.result(handle)
        if status is RequestStatus.TIMEOUT and not tokens:
            # Retry-After parity with 429/503: an unserved deadline is a
            # load symptom, the client should back off before re-asking
            self._send_json(408, {"error": "deadline expired unserved",
                                  "status": status.value},
                            headers={"Retry-After": "1"})
            return
        if status is RequestStatus.FAILED:
            self._send_json(500, {"error": rs.request_error(handle),
                                  "status": status.value})
            return
        _flight.record("gateway_done", trace_id=self.request_id,
                       status=status.value, tokens=len(tokens))
        self._send_json(200, {
            "replica": handle.replica.name,
            "request_id": self.request_id,
            "status": status.value,
            "tokens": tokens,
            "usage": {"completion_tokens": len(tokens)},
        })

    def _stream_response(self, handle):
        rs = self.replica_set
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-store")
        self.send_header("Connection", "close")
        if self.request_id is not None:
            self.send_header("X-Request-ID", self.request_id)
        # SSE has no predeclared length; closing the socket ends the stream
        self.close_connection = True
        self.end_headers()
        try:
            i = 0
            for tok in rs.stream(handle, heartbeat=self.ping_interval):
                if tok is None:
                    # idle keep-alive: proxies don't sever a silent stream
                    # during a long prefill/queue wait, and a client that
                    # dropped before the first token fails THIS write — the
                    # except below then cancels on the replica instead of
                    # decoding for nobody
                    self.wfile.write(b": ping\n\n")
                    self.wfile.flush()
                    continue
                self._sse({"token": int(tok), "index": i})
                i += 1
            status = rs.status(handle)
            _flight.record("gateway_done", trace_id=self.request_id,
                           status=status.value, tokens=i)
            final = {"status": status.value,
                     "replica": handle.replica.name,
                     "request_id": self.request_id,
                     "usage": {"completion_tokens": i}}
            if status is RequestStatus.FAILED:
                final["error"] = rs.request_error(handle)
            self._sse(final)
            self.wfile.write(b"data: [DONE]\n\n")
            self.wfile.flush()
        except (BrokenPipeError, ConnectionError, OSError):
            # client went away mid-stream: stop decoding for nobody
            rs.cancel(handle)

    # ---- durable mode (journal-backed) ---------------------------------------
    def _durable_completion(self, prompt, kw, stream):
        plane = self.plane
        if plane.recovering:
            # journal replay owns the fleet right now; shed instead of
            # interleaving fresh admissions with re-driven requests
            self._send_json(503, {"error": "gateway recovering",
                                  "recovering": True},
                            headers={"Retry-After": "1"})
            return
        key = self.headers.get("Idempotency-Key") or uuid.uuid4().hex
        last_id = self.headers.get("Last-Event-ID")
        try:
            after = 0 if last_id is None else int(last_id) + 1
        except ValueError:
            self._send_json(400, {"error":
                                  f"bad Last-Event-ID {last_id!r}"})
            return
        req = plane.get(key)
        if req is not None:
            # replayed key: serve from the journaled request, never re-run
            if last_id is not None:
                _obs.STREAM_REATTACH.inc()
        else:
            try:
                req, _created = plane.submit(key, prompt, kw)
            except ShedError as e:
                self._send_json(429, {"error": str(e), "reason": e.reason},
                                headers={"Retry-After":
                                         str(max(1, int(e.retry_after)))})
                return
            except ReplicaDeadError as e:
                self._send_json(503, {"error": str(e)},
                                headers={"Retry-After": "1"})
                return
            except ValueError as e:
                self._send_json(400, {"error": str(e)})
                return
            except Exception as e:  # noqa: BLE001 — journal append failed
                # acceptance could not be made durable, so it did not happen
                self._send_json(500, {"error": f"journal append failed: "
                                               f"{e}"})
                return
        if stream:
            self._durable_stream(req, after)
        else:
            self._durable_blocking(req, key)

    def _durable_blocking(self, req, key):
        tokens, status = req.wait_terminal()
        if status is RequestStatus.TIMEOUT and not tokens:
            self._send_json(408, {"error": "deadline expired unserved",
                                  "status": status.value,
                                  "idempotency_key": key},
                            headers={"Retry-After": "1"})
            return
        if status is RequestStatus.FAILED:
            self._send_json(500, {"error": req.error,
                                  "status": status.value,
                                  "idempotency_key": key})
            return
        self._send_json(200, {
            "status": status.value,
            "tokens": tokens,
            "idempotency_key": key,
            "usage": {"completion_tokens": len(tokens)},
        })

    def _durable_stream(self, req, after):
        plane = self.plane
        plane.attach(req)
        try:
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-store")
            self.send_header("Connection", "close")
            if self.request_id is not None:
                self.send_header("X-Request-ID", self.request_id)
            self.send_header("Idempotency-Key", req.key)
            self.close_connection = True
            self.end_headers()
            for ev in req.events(after=after,
                                 heartbeat=self.ping_interval):
                if ev is None:
                    self.wfile.write(b": ping\n\n")
                    self.wfile.flush()
                    continue
                seq, tok = ev
                # id: <seq> is what a reconnecting client echoes back as
                # Last-Event-ID — replay resumes AFTER this event
                self.wfile.write(b"id: %d\n" % seq)
                self._sse({"token": tok, "index": seq})
            final = {"status": req.status.value,
                     "usage": {"completion_tokens": len(req.tokens)}}
            if req.status is RequestStatus.FAILED:
                final["error"] = req.error
            self._sse(final)
            self.wfile.write(b"data: [DONE]\n\n")
            self.wfile.flush()
        except (BrokenPipeError, ConnectionError, OSError):
            # client went away pre-terminal: DETACH, don't cancel — the
            # grace TTL gives it a reconnect window (plane pump cancels
            # only once the window lapses with nobody attached)
            pass
        finally:
            plane.detach(req)

    # ---- plumbing ------------------------------------------------------------
    def _read_body(self):
        n = int(self.headers.get("Content-Length", 0))
        raw = self.rfile.read(n) if n else b"{}"
        return json.loads(raw.decode("utf-8"))

    def _sse(self, obj):
        self.wfile.write(b"data: " + json.dumps(obj).encode("utf-8")
                         + b"\n\n")
        self.wfile.flush()

    def _send_json(self, code, obj, headers=None):
        body = json.dumps(obj).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if self.request_id is not None:
            self.send_header("X-Request-ID", self.request_id)
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):    # requests are metered, not log events
        pass


def start_gateway(replica_set, port=0, addr="127.0.0.1", ping_interval=5.0,
                  journal_dir=None, detach_ttl=30.0,
                  journal_fsync="critical", recover=True):
    """Serve ``replica_set`` at ``http://addr:port`` from a daemon thread;
    ``port=0`` lets the OS pick (read it back from the returned handle).
    The caller owns the handle: ``close()`` stops the HTTP server (the
    replicas keep running until their owner closes them).  ``ping_interval``
    is the idle-stream keep-alive cadence (seconds between ``: ping`` SSE
    comments while no token is ready).

    ``journal_dir`` turns on the durable request plane (see module
    docstring): requests journal to that directory, submits become
    idempotent, streams resumable, and — with ``recover=True`` — any
    journal left by a previous gateway replays in a background thread
    (``/healthz`` shows ``recovering`` until it lands; submits shed 503
    meanwhile).  ``detach_ttl`` is the seconds a fully-disconnected
    pre-terminal stream survives before cancellation; ``journal_fsync``
    is the :class:`~.journal.RequestJournal` fsync policy."""
    plane = None
    if journal_dir is not None:
        plane = DurableRequestPlane(replica_set, journal_dir,
                                    fsync=journal_fsync,
                                    detach_ttl=detach_ttl)
        if recover:
            # flagged before the serving thread exists so no request can
            # slip in ahead of the replay
            plane.recovering = True
            threading.Thread(target=plane.recover,
                             name="paddle-tpu-gateway-recover",
                             daemon=True).start()
    handler = type("_BoundHandler", (_Handler,),
                   {"replica_set": replica_set,
                    "plane": plane,
                    "ping_interval": float(ping_interval)})
    httpd = ThreadingHTTPServer((addr, port), handler)
    httpd.daemon_threads = True
    thread = threading.Thread(target=httpd.serve_forever,
                              name="paddle-tpu-gateway", daemon=True)
    thread.start()
    return Gateway(httpd, thread, replica_set, plane=plane)
