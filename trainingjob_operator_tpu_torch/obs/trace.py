"""Span tracer of the workload: own copy of the JAX package's
``obs/trace.py`` (``Span``, ``Tracer``, ``tracer_from_env`` and the Chrome
``trace_event`` export; not its profiler registry or JSON-lines export).

Spans are context managers; a ``contextvars`` variable makes nested spans
auto-parent; a finished local root moves its trace into a bounded ring.
The launcher hands its context down as ``"trace_id:span_id"`` in
``TRAININGJOB_TRACE_CONTEXT``, and the workload's root span adopts it, so
one trace id spans the controller and the train loop.  A disabled tracer
returns a shared no-op span.
"""

from __future__ import annotations

import contextvars
import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Union

from trainingjob_operator_tpu_torch import constants

#: Span status values (OpenTelemetry's OK/ERROR, lowercased).
OK = "ok"
ERROR = "error"

_current_span: "contextvars.ContextVar[Optional[Span]]" = \
    contextvars.ContextVar("trainingjob_torch_current_span", default=None)


def _new_id() -> str:
    return os.urandom(8).hex()


def current_span() -> Optional["Span"]:
    """The span enclosing the caller, or None outside any span."""
    return _current_span.get()


class Span:
    """One timed operation; entering makes it the context's current span,
    exiting restores the previous one, records an exception as
    status=error and hands the finished span to its tracer."""

    __slots__ = ("_tracer", "name", "trace_id", "span_id", "parent_id",
                 "attributes", "status", "start_time", "end_time", "pid",
                 "tid", "thread_name", "_token", "_local_root")

    def __init__(self, tracer: "Tracer", name: str, trace_id: str,
                 parent_id: Optional[str], attributes: Dict[str, Any],
                 local_root: bool):
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = _new_id()
        self.parent_id = parent_id
        self.attributes = attributes
        self.status = OK
        self.start_time = 0.0
        self.end_time = 0.0
        self.pid = os.getpid()
        self.tid = threading.get_ident()
        self.thread_name = threading.current_thread().name
        self._token: Optional[contextvars.Token] = None
        self._local_root = local_root

    def __enter__(self) -> "Span":
        self.start_time = time.time()
        self._token = _current_span.set(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.end_time = time.time()
        if exc_type is not None:
            self.status = ERROR
            self.attributes.setdefault(
                "exception", f"{exc_type.__name__}: {exc}")
        if self._token is not None:
            _current_span.reset(self._token)
            self._token = None
        self._tracer._finish(self)
        return False

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "trace_id": self.trace_id,
                "span_id": self.span_id, "parent_id": self.parent_id,
                "start_time": self.start_time, "end_time": self.end_time,
                "status": self.status, "attributes": dict(self.attributes),
                "pid": self.pid, "tid": self.tid,
                "thread": self.thread_name}


class _NoopSpan:
    """Shared do-nothing span of a disabled tracer."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


NOOP_SPAN = _NoopSpan()

SpanParent = Union[None, Span, str]


class Tracer:
    """Collects finished spans into traces: the span tree under one local
    root accumulates while the root is open, then moves into a bounded
    ring of finished traces."""

    #: Cap on spans recorded per trace (a step loop opens one a step);
    #: overflow is counted on the trace.
    MAX_SPANS_PER_TRACE = 4096
    #: Cap on concurrently open traces, and on finished traces kept.
    MAX_ACTIVE_TRACES = 256
    MAX_TRACES = 256
    SERVICE = "trainingjob-workload"

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._active: Dict[str, List[Dict[str, Any]]] = {}
        self._dropped: Dict[str, int] = {}
        self._finished: "deque[Dict[str, Any]]" = deque(
            maxlen=self.MAX_TRACES)

    def span(self, name: str, parent: SpanParent = None,
             **attributes: Any) -> Union[Span, _NoopSpan]:
        """Open a span.  ``parent`` is a Span, a ``"trace_id:span_id"``
        string (the context handed down by the launcher) or None (the
        context's current span; a fresh trace when there is none)."""
        if not self.enabled:
            return NOOP_SPAN
        local_root = False
        if parent is None:
            parent = _current_span.get()
        if isinstance(parent, Span):
            trace_id, parent_id = parent.trace_id, parent.span_id
        elif isinstance(parent, str) and ":" in parent:
            trace_id, _, parent_id = parent.partition(":")
            local_root = True
        else:
            trace_id, parent_id = _new_id(), None
            local_root = True
        return Span(self, name, trace_id, parent_id, dict(attributes),
                    local_root)

    def _finish(self, span: Span) -> None:
        record = span.to_dict()
        with self._lock:
            spans = self._active.setdefault(span.trace_id, [])
            if (len(spans) >= self.MAX_SPANS_PER_TRACE
                    and not span._local_root):
                self._dropped[span.trace_id] = (
                    self._dropped.get(span.trace_id, 0) + 1)
                return
            spans.append(record)
            if span._local_root:
                self._active.pop(span.trace_id, None)
                dropped = self._dropped.pop(span.trace_id, 0)
                trace = {"trace_id": span.trace_id, "root": span.name,
                         "service": self.SERVICE, "spans": spans}
                if dropped:
                    trace["dropped_spans"] = dropped
                self._finished.append(trace)
            elif len(self._active) > self.MAX_ACTIVE_TRACES:
                oldest = next(iter(self._active))
                self._active.pop(oldest, None)
                self._dropped.pop(oldest, None)

    def traces(self) -> List[Dict[str, Any]]:
        """Finished traces, newest first."""
        with self._lock:
            out = list(self._finished)
        out.reverse()
        return out

    def export_chrome(self) -> str:
        """Chrome ``trace_event`` JSON of the finished traces: one complete
        event (``ph: "X"``) per span, times in microseconds."""
        events: List[Dict[str, Any]] = []
        for trace in self.traces():
            for span in trace["spans"]:
                args = dict(span["attributes"])
                args.update(trace_id=span["trace_id"],
                            span_id=span["span_id"],
                            parent_id=span["parent_id"],
                            status=span["status"])
                events.append({
                    "ph": "X", "name": span["name"],
                    "cat": trace["service"],
                    "ts": span["start_time"] * 1e6,
                    "dur": max(span["end_time"] - span["start_time"],
                               0.0) * 1e6,
                    "pid": span["pid"], "tid": span["tid"], "args": args})
        return json.dumps({"traceEvents": events, "displayTimeUnit": "ms"},
                          indent=2)


def tracer_from_env(environ: Optional[Dict[str, str]] = None
                    ) -> "tuple[Tracer, str]":
    """(tracer, parent context): enabled only when the launcher set
    ``TRAININGJOB_TRACE_CONTEXT``; pass the context as the root span's
    ``parent`` so the workload joins the launcher's trace."""
    env = os.environ if environ is None else environ
    parent = env.get(constants.TRACE_CONTEXT_ENV, "")
    return Tracer(enabled=bool(parent)), parent
