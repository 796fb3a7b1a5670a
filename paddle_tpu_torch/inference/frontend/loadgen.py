"""Deterministic trace-driven load generation for the serving front door.

A trace is a plain list of request dicts built from one seed, so the test
suite and ``bench.py`` replay byte-identical workloads: ``make_trace`` draws
``groups`` shared prefixes (whole KV pages, to make prefix-cache affinity
visible) and gives every request its own suffix.  ``run_closed_loop`` drives
a :class:`~.replica.ReplicaSet` with N concurrency workers, each submitting
its next request only after the previous one is terminal (closed loop — the
offered load adapts to the service rate instead of piling an unbounded
queue), and ``summarize`` reduces the per-request records to the numbers the
bench reports: aggregate tokens/s and p50/p95 TTFT.
"""
from __future__ import annotations

import json
import random
import threading
import time
import urllib.request

__all__ = ["make_trace", "run_closed_loop", "summarize", "percentile",
           "http_completion"]


def make_trace(seed, n_requests, groups=4, prefix_pages=2, suffix_tokens=4,
               page_size=16, vocab=128, max_new_tokens=8, group_major=True):
    """Build a deterministic request trace with shared prefixes.

    ``groups`` distinct prefixes of ``prefix_pages`` full pages are drawn
    once; request i belongs to group ``i % groups`` (interleaved) or to
    block ``i // (n/groups)`` (``group_major=True`` — all of a group's
    requests are adjacent, the shape that separates affinity routing from
    round-robin).  Suffixes are unique per request so only the prefix can
    hit the cache."""
    rng = random.Random(int(seed))
    groups = max(1, int(groups))
    prefixes = [[rng.randrange(int(vocab)) for _ in
                 range(int(prefix_pages) * int(page_size))]
                for _ in range(groups)]
    trace = []
    for i in range(int(n_requests)):
        g = (i * groups // int(n_requests)) if group_major else (i % groups)
        suffix = [rng.randrange(int(vocab)) for _ in range(int(suffix_tokens))]
        trace.append({"prompt": prefixes[g] + suffix,
                      "max_tokens": int(max_new_tokens),
                      "group": g})
    return trace


def run_closed_loop(replica_set, trace, concurrency=4, submit_kw=None):
    """Drive ``replica_set`` with the trace at a fixed closed-loop
    concurrency; returns ``(records, wall_seconds)``.

    Each record: ``{"group", "replica", "status", "tokens", "ttft"}`` in
    trace order.  Sheds are recorded (status ``shed``, no tokens) and do not
    stop the worker."""
    from .admission import ShedError

    trace = list(trace)
    records = [None] * len(trace)
    cursor = {"i": 0}
    lock = threading.Lock()
    submit_kw = dict(submit_kw or {})

    def worker():
        while True:
            with lock:
                i = cursor["i"]
                if i >= len(trace):
                    return
                cursor["i"] = i + 1
            req = trace[i]
            try:
                handle = replica_set.submit(req["prompt"],
                                            max_new_tokens=req["max_tokens"],
                                            **submit_kw)
            except ShedError:
                records[i] = {"group": req["group"], "replica": None,
                              "status": "shed", "tokens": 0, "ttft": None}
                continue
            tokens, status = replica_set.result(handle)
            records[i] = {"group": req["group"],
                          "replica": handle.replica.name,
                          "status": status.value,
                          "tokens": len(tokens),
                          "ttft": handle.replica.ttft(handle.rid)}

    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker, name=f"loadgen-{k}",
                                daemon=True)
               for k in range(max(1, int(concurrency)))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return records, time.perf_counter() - t0


def percentile(values, q):
    """Nearest-rank percentile (q in [0, 100]) of a non-empty sequence."""
    vals = sorted(values)
    if not vals:
        raise ValueError("percentile of empty sequence")
    k = max(0, min(len(vals) - 1,
                   round(q / 100.0 * (len(vals) - 1))))
    return vals[int(k)]


def summarize(records, wall_seconds):
    """Reduce closed-loop records to the bench-facing aggregate numbers."""
    done = [r for r in records if r is not None]
    ttfts = [r["ttft"] for r in done if r["ttft"] is not None]
    total_tokens = sum(r["tokens"] for r in done)
    return {
        "requests": len(done),
        "shed": sum(1 for r in done if r["status"] == "shed"),
        "failed": sum(1 for r in done if r["status"] == "failed"),
        "total_tokens": total_tokens,
        "wall_s": round(wall_seconds, 4),
        "tokens_per_s": round(total_tokens / wall_seconds, 2)
        if wall_seconds > 0 else 0.0,
        "ttft_p50_s": round(percentile(ttfts, 50), 4) if ttfts else None,
        "ttft_p95_s": round(percentile(ttfts, 95), 4) if ttfts else None,
    }


def http_completion(base_url, prompt, max_tokens=16, stream=False,
                    timeout=30.0, headers=None, **sampling):
    """One ``POST /v1/completions`` against a running gateway.

    Non-stream: returns the decoded JSON body.  Stream: consumes the SSE
    response and returns ``{"tokens": [...], "status": ..., "events": n,
    "last_id": ...}`` reassembled from the events — the shape tests compare
    against the engine-direct result.  ``last_id`` is the final ``id:``
    field seen (None on a non-durable gateway), ready to echo back as
    ``Last-Event-ID`` on a reconnect.  ``headers`` adds request headers —
    the durable gateway's ``Idempotency-Key`` / ``Last-Event-ID`` ride
    here."""
    body = {"prompt": [int(t) for t in prompt],
            "max_tokens": int(max_tokens), "stream": bool(stream)}
    body.update(sampling)
    hdrs = {"Content-Type": "application/json"}
    hdrs.update(headers or {})
    req = urllib.request.Request(
        base_url.rstrip("/") + "/v1/completions",
        data=json.dumps(body).encode("utf-8"),
        headers=hdrs, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        if not stream:
            return json.loads(resp.read().decode("utf-8"))
        tokens, status, events, last_id = [], None, 0, None
        for raw in resp:
            line = raw.decode("utf-8").strip()
            if line.startswith("id: "):
                last_id = int(line[len("id: "):])
                continue
            if not line.startswith("data: "):
                continue
            events += 1
            payload = line[len("data: "):]
            if payload == "[DONE]":
                break
            evt = json.loads(payload)
            if "token" in evt:
                tokens.append(evt["token"])
            else:
                status = evt.get("status")
        return {"tokens": tokens, "status": status, "events": events,
                "last_id": last_id}
