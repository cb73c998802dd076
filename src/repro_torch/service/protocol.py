"""Wire protocol of the study service: JSON lines over a local socket.

Mirrors ``src/repro/service/protocol.py`` message for message (framework-
free there too; the port keeps its own copy), so either package's client
talks to either package's daemon.

One message per line, UTF-8 JSON, ``\\n``-terminated — the simplest
framing that composes with the study wire format (``core/study.py``'s
``plan_to_dict``: arrays ride as base64 blobs inside the JSON, so a line
IS a complete message regardless of payload size). Requests carry an
``op``; every reply and streamed event carries a ``type``.

Client -> server ops:

* ``{"op": "hello", "tenant": <str>}`` — names the connection's tenant
  (the fair-share accounting group). Reply: ``{"type": "hello",
  "pool": {...}}`` with the daemon's result-affecting pool contract
  (tol, wss, shrink settings) — what ``submit`` will hold plans to —
  plus the per-plan admission budgets ``plan_chunk_budget`` /
  ``plan_bytes_budget`` (0 = unbounded), enforced against the max-bound
  simulated schedule.
* ``{"op": "submit", "plan_id": <str>, "plan": <plan_to_dict image>}`` —
  admission + execution. Streamed replies, in order: ``admitted`` (with
  per-source dedup accounting), zero or more ``result`` events (one per
  lane, the moment it retires, bit-exact ``SMOResult`` image), then
  ``done`` (evals, per-lane stats, tenant/source accounting). A plan
  that fails admission gets a single ``rejected`` reply carrying the
  ``check_plan`` findings as structured payload AND the full
  ``PlanAnalysis.to_json()`` image under ``analysis`` (programs,
  budgets, min/max schedule-simulation summaries) — nothing
  materialized.
* ``{"op": "status"}`` — pool occupancy + per-tenant accounting.
* ``{"op": "shutdown"}`` — graceful drain: in-flight studies flush their
  checkpoint snapshots (they resume on the next daemon start), the
  daemon stops. Reply: ``{"type": "bye"}``.

Unknown ops answer ``{"type": "error", "error": ...}`` and keep the
connection; framing errors (non-JSON line) drop the connection.
"""
from __future__ import annotations

import json
import socket

#: bound on one message line (256 MiB): a runaway/hostile client cannot
#: make the daemon buffer an unbounded line
MAX_LINE = 256 * 1024 * 1024


def send_msg(wfile, obj, lock=None) -> None:
    """Write one message line. ``lock`` serializes writers when the
    service thread (events) and a handler thread (replies) share the
    socket."""
    data = (json.dumps(obj, separators=(",", ":")) + "\n").encode()
    if lock is not None:
        with lock:
            wfile.write(data)
            wfile.flush()
    else:
        wfile.write(data)
        wfile.flush()


def recv_msg(rfile):
    """Read one message line; None on EOF. Raises ``ValueError`` on a
    non-JSON or oversized line (the caller drops the connection)."""
    line = rfile.readline(MAX_LINE + 1)
    if not line:
        return None
    if len(line) > MAX_LINE:
        raise ValueError("message line exceeds MAX_LINE")
    return json.loads(line)


def connect(path: str) -> socket.socket:
    """Client-side AF_UNIX connect."""
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sock.connect(path)
    return sock
