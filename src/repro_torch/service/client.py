"""Client side of the study service: submit a ``Plan``, get a
``StudyResult``-shaped answer back, bit-identical to running it locally.

Mirrors ``src/repro/service/client.py``; results come back as host
(CPU) tensors. The client does framing only, and talks to either
package's daemon.

:class:`StudyClient` hides the wire entirely: ``submit(plan_id, plan)``
serializes with ``plan_to_dict``, streams the daemon's events, and
returns a :class:`ServedStudy` whose ``results``/``evals`` carry real
``SMOResult`` objects and real (correct, total) counts — what
``run_plan`` would have produced, byte for byte. A plan the daemon's
admission gate refuses raises :class:`PlanRejectedByServer` carrying the
structured ``check_plan`` findings; nothing ran.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.core import study as study_mod
from repro_torch.service import protocol


class PlanRejectedByServer(ValueError):
    """The daemon's admission gate refused the plan; ``findings`` is the
    structured ``check_plan`` payload (rule/severity/message dicts) —
    empty for parse/contract rejections, whose story is in ``str(e)``.
    ``analysis`` is the full ``PlanAnalysis.to_json()`` dict (programs,
    budgets, min/max schedule-simulation summaries) when the analyzer
    ran, else None."""

    def __init__(self, message: str, findings: list,
                 analysis: dict | None = None):
        super().__init__(message)
        self.findings = findings
        self.analysis = analysis


@dataclasses.dataclass
class ServedStudy:
    """One completed served study: the same shape of answer ``run_plan``
    gives, minus in-process-only accounting (per-lane wall times live on
    the daemon's side of the socket)."""
    plan_id: str
    results: dict                   # lane id -> SMOResult (bit-exact)
    evals: dict                     # lane id -> (correct, total)
    restored: frozenset             # lanes that entered pre-solved
    dedup_hits: int                 # this study's sources already resident
    sources_admitted: int           # sources this study brought into the pool
    source_stats: dict              # pool-wide kernel-source cache account
    tenant_stats: dict              # this tenant's fair-share account


class StudyClient:
    """One tenant's connection to a running study daemon."""

    def __init__(self, socket_path: str, tenant: str):
        self.tenant = tenant
        self._sock = protocol.connect(socket_path)
        self._rfile = self._sock.makefile("rb")
        self._wfile = self._sock.makefile("wb")
        protocol.send_msg(self._wfile, {"op": "hello", "tenant": tenant})
        reply = self._recv()
        if reply.get("type") != "hello":
            raise RuntimeError(f"bad handshake reply: {reply!r}")
        #: the daemon pool's result-affecting contract (tol, wss, shrink
        #: settings) — build plans against this or be rejected
        self.pool_contract = reply["pool"]

    def _recv(self) -> dict:
        msg = protocol.recv_msg(self._rfile)
        if msg is None:
            raise ConnectionError("study daemon closed the connection")
        return msg

    def submit(self, plan_id: str, plan, *,
               on_result=None) -> ServedStudy:
        """Run ``plan`` on the daemon; blocks until ``done``. Streams each
        lane's retirement to ``on_result(lane_id, SMOResult)`` the moment
        it crosses the wire (long studies consume results as they land)."""
        protocol.send_msg(self._wfile, {
            "op": "submit", "plan_id": plan_id,
            "plan": study_mod.plan_to_dict(plan)})
        results: dict[Any, Any] = {}
        admitted: dict = {}
        while True:
            msg = self._recv()
            kind = msg.get("type")
            if kind == "admitted":
                admitted = msg
            elif kind == "result":
                lane = study_mod._from_wire(msg["lane"])
                res = study_mod.result_from_dict(msg["result"])
                results[lane] = res
                if on_result is not None:
                    on_result(lane, res)
            elif kind == "done":
                return ServedStudy(
                    plan_id=plan_id, results=results,
                    evals={study_mod._from_wire(lane): (c, t)
                           for lane, (c, t) in msg["evals"]},
                    restored=frozenset(study_mod._from_wire(lid)
                                       for lid in msg["restored"]),
                    dedup_hits=msg["study_source_stats"]["dedup_hits"],
                    sources_admitted=msg["study_source_stats"]
                    ["sources_admitted"],
                    source_stats=msg["source_stats"],
                    tenant_stats=msg["tenant_stats"])
            elif kind == "rejected":
                raise PlanRejectedByServer(msg["error"],
                                           msg.get("findings", []),
                                           msg.get("analysis"))
            elif kind == "error":
                raise RuntimeError(f"study {plan_id!r} failed on the "
                                   f"daemon: {msg['error']}")
            else:
                raise RuntimeError(f"unexpected message {msg!r}")

    def status(self) -> dict:
        protocol.send_msg(self._wfile, {"op": "status"})
        return self._recv()

    def shutdown(self) -> None:
        """Ask the daemon to drain (in-flight studies flush snapshots)
        and exit."""
        protocol.send_msg(self._wfile, {"op": "shutdown"})
        msg = self._recv()
        if msg.get("type") != "bye":
            raise RuntimeError(f"unexpected shutdown reply: {msg!r}")

    def close(self) -> None:
        try:
            self._rfile.close()
            self._wfile.close()
        finally:
            self._sock.close()

    def __enter__(self) -> "StudyClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
