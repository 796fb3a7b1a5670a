"""Durable request plane: a write-ahead request journal + the table that
re-drives it onto a :class:`~.replica.ReplicaSet`.

The gateway's durability gap (PR 14 closed the *replica* half) is the
gateway process itself: an accepted request lived only in handler-thread
state, so a gateway crash lost it and a client disconnect cancelled it.
This module makes acceptance durable:

- :class:`RequestJournal` — append-only JSONL segments on local disk.
  Every record is one JSON object carrying a CRC32 of its own payload, so
  a torn tail (crash mid-write) is detected and skipped on replay rather
  than poisoning it.  Appends go to the newest segment only; a reopened
  journal NEVER appends to a pre-existing segment (its tail may be torn) —
  it starts a fresh one.  Critical records (ACCEPTED, TERMINAL, and the
  rotation/compaction boundaries) are fsynced before the append returns;
  token batches ride the cheaper flush-only path by default
  (``fsync="always"`` upgrades them).  Segments rotate at a byte bound and
  terminal requests are periodically *compacted*: their
  ``ACCEPTED → TOKENS×N → TERMINAL`` record chains fold into single
  ``RESULT`` records (idempotency replay stays answerable) written via the
  atomic tmp + ``os.replace`` (+ dir fsync) idiom, and old segments are
  deleted.

- :class:`DurableRequest` — the in-memory face of one journaled request:
  its token list, terminal status, and a condition that SSE writers wait
  on.  ``events(after=seq)`` yields ``(seq, token)`` pairs from any
  offset, which is what ``Last-Event-ID`` reattach rides on.

- :class:`DurableRequestPlane` — the keyed table tying journal to fleet.
  ``submit`` journals ACCEPTED (fsynced) *before* returning — "accepted"
  means "on disk" — then a per-request pump thread drains the replica
  stream, journaling each token batch BEFORE publishing it to clients.
  That order is the reattach invariant: the journal is always ≥ any
  client's view, so a reconnect replayed from the journal can never have
  a gap against what the client already saw.  ``recover()`` replays the
  journal on a restarted gateway: terminal requests become replay-only
  entries (idempotent re-submits are served from them without touching
  the fleet), non-terminal ones are re-driven through the engine's
  ``resume_tokens`` re-prefill machinery — greedy/fixed-seed streams
  continue byte-identical.  Detached streams (client vanished pre-
  terminal) are cancelled only after a grace TTL, giving the client a
  reconnect window instead of the old insta-cancel.

Fault points: ``journal.append`` (record append fails; ctx ``kind``),
``journal.fsync`` (the critical-path fsync raises), ``gateway.recover``
(re-driving one journaled request fails during recovery; ctx ``key``).
"""
from __future__ import annotations

import json
import os
import threading
import time
import zlib

from ... import observability as _obs
from ...testing import faults as _faults
from ..serving import RequestStatus as _RequestStatus
from .admission import ShedError
from .replica import ReplicaDeadError

__all__ = ["JournalCorruption", "RequestJournal", "DurableRequest",
           "DurableRequestPlane"]

_SEG_PREFIX = "seg-"
_SEG_SUFFIX = ".jsonl"

# record kinds (the "k" field): one letter keeps token-batch records small
_ACCEPTED = "A"
_TOKENS = "T"
_TERMINAL = "F"
_RESULT = "R"        # compacted terminal request (ACCEPTED+TOKENS+TERMINAL)
_KIND_NAMES = {_ACCEPTED: "accepted", _TOKENS: "tokens",
               _TERMINAL: "terminal", _RESULT: "result"}


class JournalCorruption(RuntimeError):
    """A record failed its CRC or parse — surfaced only by strict replays;
    the normal recovery path counts and skips instead."""


def _encode(payload):
    """One journal line: the payload JSON plus a CRC32 of that exact
    serialization under ``"c"``.  Key order is pinned so the CRC is a pure
    function of the payload."""
    body = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    crc = zlib.crc32(body.encode("utf-8")) & 0xFFFFFFFF
    return ("{\"c\":%d,%s" % (crc, body[1:])).encode("utf-8") + b"\n"


def _decode(line):
    """Parse + CRC-check one line; returns the payload dict or raises
    :class:`JournalCorruption` (torn tail, bitrot, partial write)."""
    try:
        rec = json.loads(line.decode("utf-8"))
        crc = rec.pop("c")
    except (ValueError, KeyError, UnicodeDecodeError) as e:
        raise JournalCorruption(f"unparseable record: {e}") from e
    body = json.dumps(rec, sort_keys=True, separators=(",", ":"))
    if zlib.crc32(body.encode("utf-8")) & 0xFFFFFFFF != crc:
        raise JournalCorruption("record CRC mismatch")
    return rec


class _Replayed:
    """Accumulated replay state of one request key."""

    __slots__ = ("prompt", "kw", "tokens", "status", "error")

    def __init__(self):
        self.prompt = None
        self.kw = {}
        self.tokens = []
        self.status = None       # RequestStatus once a TERMINAL/RESULT lands
        self.error = None


class RequestJournal:
    """Append-only CRC'd JSONL write-ahead journal over segment files in
    one directory.  All methods are thread-safe (one internal lock — the
    plane's pump threads and submit path share it).

    ``fsync`` policy: ``"critical"`` (default) fsyncs ACCEPTED/TERMINAL
    appends and rotation/compaction boundaries; ``"always"`` additionally
    fsyncs every token batch; ``"never"`` trusts the page cache (tests).
    """

    def __init__(self, path, segment_bytes=1 << 20, fsync="critical",
                 keep_terminal=512):
        if fsync not in ("always", "critical", "never"):
            raise ValueError(f"unknown fsync policy {fsync!r}")
        self.path = str(path)
        self.segment_bytes = int(segment_bytes)
        self.fsync = fsync
        self.keep_terminal = int(keep_terminal)
        self._mu = threading.RLock()
        self._fh = None
        self._seg_index = 0
        self.appended = 0           # records appended by this instance
        os.makedirs(self.path, exist_ok=True)
        existing = self._segment_indices()
        # never append to a pre-existing segment: its tail may be torn from
        # the crash that brought us here — replay tolerates the tear, an
        # append after it would not
        self._seg_index = (existing[-1] + 1) if existing else 0
        self._open_segment()

    # ---- segment plumbing ----------------------------------------------------
    def _seg_path(self, index):
        return os.path.join(self.path, f"{_SEG_PREFIX}{index:08d}{_SEG_SUFFIX}")

    def _segment_indices(self):
        out = []
        for name in os.listdir(self.path):
            if name.startswith(_SEG_PREFIX) and name.endswith(_SEG_SUFFIX):
                try:
                    out.append(int(name[len(_SEG_PREFIX):-len(_SEG_SUFFIX)]))
                except ValueError:
                    continue
        return sorted(out)

    def _open_segment(self):
        # "ab" (not "w"): the segment index is fresh so the file is new, and
        # append mode can never truncate a journal on a racing reopen
        self._fh = open(self._seg_path(self._seg_index), "ab")

    def _fsync_fh(self):
        _faults.FAULTS.maybe_fire("journal.fsync")
        self._fh.flush()
        os.fsync(self._fh.fileno())

    def _fsync_dir(self):
        fd = os.open(self.path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    def _rotate(self):
        """Seal the active segment (fsynced) and start the next one."""
        self._fsync_fh()
        self._fh.close()
        self._seg_index += 1
        self._open_segment()
        self._fsync_dir()

    # ---- append --------------------------------------------------------------
    def _append(self, payload, critical):
        t0 = time.perf_counter()
        kind = payload["k"]
        _faults.FAULTS.maybe_fire("journal.append", kind=_KIND_NAMES[kind])
        with self._mu:
            if self._fh is None:
                raise RuntimeError("journal is closed")
            self._fh.write(_encode(payload))
            if critical and self.fsync != "never" or self.fsync == "always":
                # fsync under _mu BY DESIGN: the durability contract is
                # fsync-before-ack, so the record must be on disk before
                # any later append (or ack) can be ordered after it
                self._fsync_fh()  # graftlint: disable=concurrency
            else:
                self._fh.flush()
            self.appended += 1
            if self._fh.tell() >= self.segment_bytes:
                self._rotate()
        _obs.JOURNAL_APPEND_SECONDS.observe(time.perf_counter() - t0)

    def append_accepted(self, key, prompt, kw):
        """ACCEPTED is the durability point: fsynced before the caller may
        acknowledge the request to a client."""
        self._append({"k": _ACCEPTED, "key": key,
                      "p": [int(t) for t in prompt], "kw": dict(kw)},
                     critical=True)

    def append_tokens(self, key, seq, tokens):
        """One delivered token batch; ``seq`` is the stream offset of the
        first token, making replay idempotent under record duplication."""
        self._append({"k": _TOKENS, "key": key, "s": int(seq),
                      "t": [int(t) for t in tokens]}, critical=False)

    def append_terminal(self, key, status, error=None):
        payload = {"k": _TERMINAL, "key": key, "st": status.value}
        if error is not None:
            payload["e"] = str(error)
        self._append(payload, critical=True)

    # ---- replay --------------------------------------------------------------
    @staticmethod
    def _apply(state, rec):
        key = rec["key"]
        req = state.get(key)
        if req is None:
            req = state[key] = _Replayed()
        kind = rec["k"]
        if kind == _ACCEPTED:
            req.prompt = [int(t) for t in rec["p"]]
            req.kw = dict(rec["kw"])
        elif kind == _TOKENS:
            seq, toks = int(rec["s"]), rec["t"]
            if seq <= len(req.tokens):
                # duplicate-tolerant: a record replayed twice (compaction
                # raced a crash) extends only past what is already known
                req.tokens.extend(int(t) for t in toks[len(req.tokens) - seq:])
        elif kind == _TERMINAL:
            req.status = _RequestStatus(rec["st"])
            req.error = rec.get("e")
        elif kind == _RESULT:
            req.tokens = [int(t) for t in rec["t"]]
            req.status = _RequestStatus(rec["st"])
            req.error = rec.get("e")

    def replay(self):
        """Read every segment oldest-first; returns ``(state, counts)`` —
        ``state`` maps request key → :class:`_Replayed` in first-seen order,
        ``counts`` tallies records by kind name plus ``"torn"`` for the
        records a CRC/parse failure cost.  A corrupt record ends that
        SEGMENT's replay (everything after a tear is untrusted) but later
        segments still replay — only the active segment can legitimately
        tear, and it is always the last."""
        counts = {name: 0 for name in _KIND_NAMES.values()}
        counts["torn"] = 0
        state = {}
        with self._mu:
            if self._fh is not None:
                self._fh.flush()
            for index in self._segment_indices():
                with open(self._seg_path(index), "rb") as fh:
                    for line in fh:
                        try:
                            rec = _decode(line)
                        except JournalCorruption:
                            counts["torn"] += 1
                            break
                        self._apply(state, rec)
                        counts[_KIND_NAMES[rec["k"]]] += 1
        return state, counts

    # ---- compaction ----------------------------------------------------------
    def compact(self):
        """Fold terminal requests into single RESULT records and drop all
        but the newest ``keep_terminal`` of them; non-terminal requests are
        rewritten as one ACCEPTED + one TOKENS record.  The compacted
        segment is built in a ``.tmp`` file and published with
        ``os.replace`` + directory fsync — a crash at any point leaves
        either the old segments or old + compacted (replay is duplicate-
        tolerant), never a half-written journal.  Returns the number of
        terminal requests dropped."""
        with self._mu:
            # compaction holds _mu across its fsyncs BY DESIGN: appends
            # must not interleave with the segment swap, and the swap is
            # not durable (hence not announceable) until synced
            state, _ = self.replay()
            self._fsync_fh()  # graftlint: disable=concurrency
            self._fh.close()
            old = self._segment_indices()
            compact_index = self._seg_index + 1
            terminal = [(k, r) for k, r in state.items()
                        if r.status is not None]
            dropped = max(0, len(terminal) - self.keep_terminal)
            tmp = self._seg_path(compact_index) + ".tmp"
            with open(tmp, "wb") as fh:
                for key, req in state.items():
                    if req.status is not None:
                        continue
                    fh.write(_encode({"k": _ACCEPTED, "key": key,
                                      "p": req.prompt, "kw": req.kw}))
                    if req.tokens:
                        fh.write(_encode({"k": _TOKENS, "key": key, "s": 0,
                                          "t": req.tokens}))
                for key, req in terminal[dropped:]:
                    payload = {"k": _RESULT, "key": key, "t": req.tokens,
                               "st": req.status.value}
                    if req.error is not None:
                        payload["e"] = req.error
                    fh.write(_encode(payload))
                fh.flush()
                os.fsync(fh.fileno())  # graftlint: disable=concurrency
            os.replace(tmp, self._seg_path(compact_index))
            self._fsync_dir()  # graftlint: disable=concurrency
            for index in old:
                os.unlink(self._seg_path(index))
            self._seg_index = compact_index + 1
            self._open_segment()
            self._fsync_dir()  # graftlint: disable=concurrency
            return dropped

    def stats(self):
        with self._mu:
            indices = self._segment_indices()
            size = sum(os.path.getsize(self._seg_path(i)) for i in indices)
            return {"segments": len(indices), "bytes": size,
                    "appended": self.appended}

    def close(self):
        with self._mu:
            if self._fh is not None:
                if self.fsync != "never":
                    try:
                        # final fsync under _mu: no append may slip in
                        # between it and the close
                        self._fsync_fh()  # graftlint: disable=concurrency
                    except (OSError, _faults.InjectedFault):
                        pass  # closing anyway; replay tolerates the tear
                self._fh.close()
                self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class DurableRequest:
    """In-memory face of one journaled request: the tokens delivered so
    far, the terminal status once known, and the condition SSE writers park
    on.  ``attached`` counts live client connections; when it drops to zero
    before the request is terminal, ``detach_deadline`` starts the grace
    window after which the plane's pump cancels the orphaned request."""

    __slots__ = ("key", "prompt", "kw", "tokens", "status", "error",
                 "handle", "attached", "detach_deadline", "replayed", "_cv")

    def __init__(self, key, prompt=None, kw=None):
        self.key = key
        self.prompt = prompt
        self.kw = dict(kw or {})
        self.tokens = []
        self.status = None           # RequestStatus, set exactly once
        self.error = None
        self.handle = None           # fleet RequestHandle while being driven
        self.attached = 0
        self.detach_deadline = None
        self.replayed = False        # served from the journal, never re-run
        self._cv = threading.Condition()

    @property
    def terminal(self):
        # under the cv (it wraps an RLock, so holders may re-enter): status
        # flips exactly once, but the lock orders this read after the
        # finish() that also published tokens/error
        with self._cv:
            return self.status is not None

    def publish(self, tokens):
        with self._cv:
            self.tokens.extend(int(t) for t in tokens)
            self._cv.notify_all()

    def finish(self, status, error=None):
        with self._cv:
            if self.status is None:
                self.status = status
                self.error = error
            self._cv.notify_all()

    def wait_terminal(self, timeout=None):
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while self.status is None:
                left = None if deadline is None \
                    else deadline - time.monotonic()
                if left is not None and left <= 0:
                    raise TimeoutError(
                        f"request {self.key!r} not terminal after {timeout}s")
                self._cv.wait(0.25 if left is None else min(left, 0.25))
            return list(self.tokens), self.status

    def events(self, after=0, heartbeat=None):
        """Yield ``(seq, token)`` for every token with ``seq >= after`` —
        journal-backed history first, then live tokens as the pump lands
        them — until the request is terminal and fully delivered.  With
        ``heartbeat`` set, yields ``None`` whenever that many idle seconds
        pass, mirroring :meth:`ReplicaSet.stream`'s keep-alive contract."""
        seq = max(0, int(after))
        last = time.monotonic()
        while True:
            with self._cv:
                while seq >= len(self.tokens) and self.status is None:
                    slice_ = 0.25 if heartbeat is None \
                        else min(0.25, float(heartbeat))
                    self._cv.wait(slice_)
                    if (heartbeat is not None
                            and time.monotonic() - last >= float(heartbeat)
                            and seq >= len(self.tokens)
                            and self.status is None):
                        break
                batch = self.tokens[seq:]
                done = self.status is not None and not batch
            if done:
                return
            if not batch:
                yield None               # heartbeat (socket-liveness probe)
                last = time.monotonic()
                continue
            for tok in batch:            # yield outside the lock: a slow
                yield seq, int(tok)      # client must not stall the pump
                seq += 1
            last = time.monotonic()


class DurableRequestPlane:
    """Keyed table of :class:`DurableRequest` + the journal + the pumps.

    One pump thread per inflight request drains
    :meth:`ReplicaSet.stream_batches`, journaling each batch before
    publishing it (journal ≥ client, always), then journals the terminal.
    ``detach_ttl`` is the grace window a fully-detached pre-terminal
    request survives before the pump cancels it.  ``compact_every``
    triggers journal compaction after that many terminal requests.
    """

    def __init__(self, replica_set, path, fsync="critical", detach_ttl=30.0,
                 segment_bytes=1 << 20, keep_terminal=512, compact_every=64):
        self.replica_set = replica_set
        self.journal = RequestJournal(path, segment_bytes=segment_bytes,
                                      fsync=fsync,
                                      keep_terminal=keep_terminal)
        self.detach_ttl = float(detach_ttl)
        self.compact_every = int(compact_every)
        self.recovering = False
        self.recovered = 0          # non-terminal requests re-driven
        self._mu = threading.Lock()
        self._table = {}            # key -> DurableRequest
        self._pumps = []
        self._terminal_since_compact = 0
        self._closed = False

    # ---- submission ----------------------------------------------------------
    def get(self, key):
        with self._mu:
            return self._table.get(key)

    def submit(self, key, prompt, kw):
        """Idempotent keyed submit: a known key returns its existing
        :class:`DurableRequest` with ``replayed=True`` semantics (the fleet
        is not touched); a new key is routed, journaled ACCEPTED (fsynced),
        and pumped.  Shed/route failures raise BEFORE journaling — an
        unjournaled request was never accepted."""
        with self._mu:
            existing = self._table.get(key)
            if existing is not None:
                return existing, False
        handle = self.replica_set.submit(prompt, **kw)
        try:
            self.journal.append_accepted(key, prompt, kw)
        except Exception:
            # could not make acceptance durable: the request must not run
            self.replica_set.cancel(handle)
            raise
        req = DurableRequest(key, prompt=list(prompt), kw=kw)
        req.handle = handle
        req.detach_deadline = time.monotonic() + self.detach_ttl
        with self._mu:
            # a racing submit of the same key lost to us only after paying
            # a duplicate engine admission; first journaled wins the table
            won = self._table.setdefault(key, req)
        if won is not req:
            self.replica_set.cancel(handle)
            return won, False
        self._start_pump(req)
        return req, True

    def attach(self, req):
        with req._cv:
            req.attached += 1
            req.detach_deadline = None

    def detach(self, req):
        with req._cv:
            req.attached = max(0, req.attached - 1)
            if req.attached == 0 and req.status is None:
                req.detach_deadline = time.monotonic() + self.detach_ttl

    # ---- pump ----------------------------------------------------------------
    def _start_pump(self, req):
        t = threading.Thread(target=self._pump, args=(req,),
                             name=f"journal-pump-{req.key[:8]}", daemon=True)
        t.start()
        self._pumps.append(t)

    def _pump(self, req):
        rs = self.replica_set
        try:
            # the heartbeat tick doubles as the detach-TTL poll cadence
            tick = max(0.05, min(1.0, self.detach_ttl / 4.0))
            for toks, _status in rs.stream_batches(req.handle,
                                                   heartbeat=tick):
                if self._closed:
                    return
                if toks:
                    seq = len(req.tokens)
                    self.journal.append_tokens(req.key, seq, toks)
                    req.publish(toks)
                with req._cv:
                    deadline = (req.detach_deadline
                                if req.attached == 0 else None)
                if deadline is not None and time.monotonic() > deadline:
                    # every client left and the grace window lapsed: stop
                    # decoding for nobody (the terminal lands as CANCELLED)
                    rs.cancel(req.handle)
            status = rs.status(req.handle)
            error = (rs.request_error(req.handle)
                     if status is _RequestStatus.FAILED else None)
        except Exception as e:  # noqa: BLE001 — journal faults land here
            status, error = _RequestStatus.FAILED, repr(e)
        if self._closed:
            return
        try:
            self.journal.append_terminal(req.key, status, error=error)
        except Exception as e:  # noqa: BLE001
            # the terminal could not be made durable; the in-memory request
            # still terminates (recovery would re-drive it, which is safe)
            error = error or repr(e)
        req.finish(status, error)
        self._maybe_compact()

    def _maybe_compact(self):
        with self._mu:
            self._terminal_since_compact += 1
            due = self._terminal_since_compact >= self.compact_every
            if due:
                self._terminal_since_compact = 0
        if due:
            try:
                self.journal.compact()
            except OSError:
                pass  # compaction is an optimization; appends still work

    # ---- crash recovery ------------------------------------------------------
    def recover(self):
        """Replay the journal into the table: terminal requests become
        replay-only entries (idempotency hits are served from them),
        non-terminal ones are re-driven onto the fleet with their journaled
        tokens as ``resume_tokens`` — byte-identical continuation for
        greedy/fixed-seed sampling.  Sets ``recovering`` for the duration
        so the gateway can shed with Retry-After instead of racing the
        replay."""
        self.recovering = True
        try:
            state, counts = self.journal.replay()
            for kind in ("accepted", "tokens", "terminal", "result"):
                if counts[kind]:
                    _obs.JOURNAL_REPLAYED.inc(counts[kind], kind=kind)
            if sum(counts[k] for k in
                   ("accepted", "tokens", "terminal", "result")):
                _obs.GATEWAY_RECOVERIES.inc()
            for key, rep in state.items():
                req = DurableRequest(key, prompt=rep.prompt, kw=rep.kw)
                req.tokens = list(rep.tokens)
                req.replayed = True
                if rep.status is not None:
                    req.status, req.error = rep.status, rep.error
                    with self._mu:
                        self._table.setdefault(key, req)
                    continue
                with self._mu:
                    if self._table.setdefault(key, req) is not req:
                        continue  # a live submit beat the replay to it
                self._redrive(req)
                self.recovered += 1
        finally:
            self.recovering = False

    def _redrive(self, req):
        """Resubmit one journaled non-terminal request.  The journaled
        token prefix re-prefills via ``resume_tokens``; a request whose
        budget is already spent (or that already hit EOS) just needs its
        terminal pinned and journaled."""
        kw = dict(req.kw)
        emitted = list(req.tokens)
        remaining = int(kw.get("max_new_tokens", 16)) - len(emitted)
        eos = kw.get("eos_token_id")
        hit_eos = eos is not None and emitted and emitted[-1] == eos
        if remaining <= 0 or hit_eos:
            status = (_RequestStatus.EOS if hit_eos
                      else _RequestStatus.FINISHED)
            try:
                self.journal.append_terminal(req.key, status)
            except (OSError, _faults.InjectedFault):
                pass  # best-effort: an unjournaled terminal just re-pins
                      # the same way on the next replay
            req.finish(status)
            return
        if emitted:
            kw["max_new_tokens"] = remaining
            kw["resume_tokens"] = emitted
        try:
            _faults.FAULTS.maybe_fire("gateway.recover", key=req.key)
            req.handle = self.replica_set.submit(req.prompt, **kw)
        except (ShedError, ReplicaDeadError, _faults.InjectedFault) as e:
            # the fleet would not take it back: fail it durably rather than
            # leave a request that is neither running nor terminal
            try:
                self.journal.append_terminal(req.key, _RequestStatus.FAILED,
                                             error=repr(e))
            except (OSError, _faults.InjectedFault):
                pass  # the FAILED pin stays in memory; replay re-derives it
            req.finish(_RequestStatus.FAILED, repr(e))
            return
        req.detach_deadline = time.monotonic() + self.detach_ttl
        self._start_pump(req)

    # ---- introspection / lifecycle ------------------------------------------
    def depth(self):
        """Non-terminal requests currently tracked (the /healthz number)."""
        with self._mu:
            return sum(1 for r in self._table.values() if r.status is None)

    def health(self):
        h = {"depth": self.depth(), "recovering": self.recovering,
             "recovered": self.recovered}
        h.update(self.journal.stats())
        return h

    def close(self):
        """Stop pumping and close the journal.  Inflight requests are NOT
        cancelled — their lack of a journaled terminal is exactly what a
        crash leaves behind, so a later ``recover()`` resumes them."""
        self._closed = True
        for t in self._pumps:
            t.join(timeout=5.0)
        self.journal.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
