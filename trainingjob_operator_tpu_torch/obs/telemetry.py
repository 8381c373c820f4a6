"""Workload side of the telemetry wire: own copy of the JAX package's
``TelemetryEmitter`` (``obs/telemetry.py``).

One JSON object per line over TCP to the controller's sink, in the same
records as the JAX emitter: a step record (``emit``), a restore's record
(``emit_resume``), a resize rebootstrap's rung (``emit_rendezvous``), a
serving snapshot (``emit_serve``) and a request's
terminal record (``emit_request``).  The
aggregator and the sink are the controller's and are not ported.
"""

from __future__ import annotations

import json
import os
import socket
import time
from typing import Any, Dict, Optional

from trainingjob_operator_tpu_torch import constants


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "")
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


class TelemetryEmitter:
    """Best-effort record pusher (one thread).

    Enabled only when ``TRAININGJOB_TELEMETRY_ADDR`` and the job identity
    (namespace and name) are set.  A failed connect or send closes the
    socket and backs off ``RETRY_SECONDS``: training never waits on
    observability.
    """

    CONNECT_TIMEOUT = 0.5
    #: Back-off after a failed connect or send.
    RETRY_SECONDS = 5.0

    def __init__(self, units_per_step: float = 0.0,
                 flops_per_step: float = 0.0):
        env = os.environ
        self.addr = env.get(constants.TELEMETRY_ADDR_ENV, "")
        ns = env.get(constants.JOB_NAMESPACE_ENV, "")
        name = env.get(constants.JOB_NAME_ENV, "")
        self.job = f"{ns}/{name}" if ns and name else ""
        self.rtype = env.get(constants.REPLICA_NAME_ENV, "worker").lower()
        try:
            self.rank = int(env.get(constants.REPLICA_INDEX_ENV, "0") or "0")
        except ValueError:
            self.rank = 0
        self.units_per_step = units_per_step
        self.flops_per_step = _env_float(constants.MODEL_FLOPS_ENV,
                                         flops_per_step)
        self.peak_flops = _env_float(constants.PEAK_FLOPS_ENV, 0.0)
        self._sock: Optional[socket.socket] = None
        self._down_until = 0.0

    @property
    def enabled(self) -> bool:
        return bool(self.addr and self.job)

    def _head(self) -> Dict[str, Any]:
        return {"v": 1, "job": self.job, "rtype": self.rtype,
                "rank": self.rank}

    def _ready(self) -> bool:
        return self.enabled and time.monotonic() >= self._down_until

    def emit(self, step: int, ms: float, loss: Optional[float] = None,
             ckpt_ms: Optional[float] = None,
             hbm_bytes: Optional[float] = None) -> None:
        """One completed training step."""
        if not self._ready():
            return
        record = {**self._head(), "step": step, "ms": round(ms, 3),
                  "ts": time.time()}
        if self.units_per_step:
            record["tokens"] = self.units_per_step
        if self.flops_per_step:
            record["flops"] = self.flops_per_step
        if self.peak_flops:
            record["peak_flops"] = self.peak_flops
        if loss is not None:
            record["loss"] = loss
        if ckpt_ms is not None:
            record["ckpt_ms"] = round(ckpt_ms, 3)
        if hbm_bytes is not None:
            record["hbm_bytes"] = hbm_bytes
        self._send(record)

    def emit_resume(self, restore_ms: float, compile_ms: float,
                    overlapped: bool, fallback: str = "") -> None:
        """One restore finished: its wall time, the compile time beside it
        and whether the two overlapped, and the checkpoint fallback it took
        ("" on the happy path, then left off the record), for the
        controller's incident attribution."""
        if not self._ready():
            return
        record = {**self._head(), "resume_restore_ms": round(restore_ms, 3),
                  "resume_compile_ms": round(compile_ms, 3),
                  "resume_overlapped": overlapped, "ts": time.time()}
        if fallback:
            record["resume_fallback"] = fallback
        self._send(record)

    def emit_rendezvous(self, total_ms: float, rung: str, reason: str = "",
                        phase_ms: Optional[Dict[str, float]] = None) -> None:
        """One rebootstrap of an in-place resize finished or degraded
        (``llama_elastic.resize_cycle``): the rung taken, its wall time and
        the wall time of each phase, for the controller's incident
        attribution.  Sent on success (rung ``live``) and again with the
        rung fallen to on a degrade: the latest record wins."""
        if not self._ready():
            return
        record = {**self._head(), "rendezvous_ms": round(total_ms, 3),
                  "rendezvous_rung": rung, "ts": time.time()}
        if reason:
            record["rendezvous_reason"] = reason
        if phase_ms:
            record["rendezvous_phase_ms"] = {p: round(v, 3)
                                             for p, v in phase_ms.items()}
        self._send(record)

    def emit_serve(self, queue_depth: int, active_slots: int, slots: int,
                   p50_ms: float, p99_ms: float, tokens_per_sec: float,
                   completed: int) -> None:
        """Serving-plane snapshot (``DecodeService``, every ``EMIT_EVERY``
        scheduler ticks)."""
        if not self._ready():
            return
        self._send({**self._head(), "serve_queue_depth": queue_depth,
                    "serve_active_slots": active_slots,
                    "serve_slots": slots, "serve_p50_ms": round(p50_ms, 3),
                    "serve_p99_ms": round(p99_ms, 3),
                    "serve_tokens_per_sec": round(tokens_per_sec, 2),
                    "serve_completed": completed, "ts": time.time()})

    def emit_request(self, outcome: str, request_id: int, epoch: str,
                     submitted_hwm: int, *, ttft_ms: Optional[float] = None,
                     tpot_ms: Optional[float] = None, tokens: int = 0,
                     arrival: Optional[float] = None,
                     phase_ms: Optional[Dict[str, float]] = None) -> None:
        """One request reached a terminal state; ``submitted_hwm`` is the
        highest id submitted so far in this service's stream."""
        if not self._ready():
            return
        record = {**self._head(), "request_outcome": outcome,
                  "request_id": request_id, "request_epoch": epoch,
                  "submitted_hwm": submitted_hwm, "tokens": tokens,
                  "ts": time.time()}
        if ttft_ms is not None:
            record["ttft_ms"] = round(ttft_ms, 3)
        if tpot_ms is not None:
            record["tpot_ms"] = round(tpot_ms, 3)
        if arrival is not None:
            record["arrival"] = arrival
        if phase_ms:
            record["phase_ms"] = {p: round(v, 3)
                                  for p, v in phase_ms.items()}
        self._send(record)

    def _send(self, record: Dict[str, Any]) -> None:
        data = (json.dumps(record, sort_keys=True) + "\n").encode()
        try:
            if self._sock is None:
                host, _, port = self.addr.rpartition(":")
                self._sock = socket.create_connection(
                    (host, int(port)), timeout=self.CONNECT_TIMEOUT)
            self._sock.sendall(data)
        except (OSError, ValueError):
            self.close()
            self._down_until = time.monotonic() + self.RETRY_SECONDS

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
