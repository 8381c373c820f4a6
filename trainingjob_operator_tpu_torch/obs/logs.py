"""Structured logging of the workload: own copy of the JAX package's
``obs/logs.py`` (``get_logger``, ``configure_logging``).

Each record carries the ``trace_id``/``span_id`` of the span open around
the call (``obs/trace.py``) and any bound fields; ``configure_logging``
installs one root handler, human text with a bracketed context suffix or
one JSON object per line.
"""

from __future__ import annotations

import json
import logging
from typing import Any, Dict

from trainingjob_operator_tpu_torch.obs.trace import current_span

#: Record attributes the formatters surface (beyond the stdlib ones).
CONTEXT_FIELDS = ("trace_id", "span_id", "job", "rtype")


class StructuredLogger(logging.LoggerAdapter):
    """Adapter binding static context fields and injecting the live trace
    id of the enclosing span."""

    def __init__(self, logger: logging.Logger, **fields: Any):
        super().__init__(logger, fields)

    def process(self, msg, kwargs):
        extra = dict(self.extra or {})
        extra.update(kwargs.get("extra") or {})
        span = current_span()
        if span is not None:
            extra.setdefault("trace_id", span.trace_id)
            extra.setdefault("span_id", span.span_id)
        kwargs["extra"] = extra
        return msg, kwargs


def get_logger(name: str, **fields: Any) -> StructuredLogger:
    return StructuredLogger(logging.getLogger(name), **fields)


class JsonFormatter(logging.Formatter):
    """One JSON object per record: ts/level/logger/message and the context
    fields, keys sorted."""

    def format(self, record: logging.LogRecord) -> str:
        out: Dict[str, Any] = {"ts": round(record.created, 6),
                               "level": record.levelname,
                               "logger": record.name,
                               "message": record.getMessage()}
        for field in CONTEXT_FIELDS:
            value = getattr(record, field, None)
            if value is not None:
                out[field] = value
        if record.exc_info:
            out["exception"] = self.formatException(record.exc_info)
        return json.dumps(out, sort_keys=True, default=str)


class ContextTextFormatter(logging.Formatter):
    """Human text with a bracketed context suffix when a field is bound."""

    def format(self, record: logging.LogRecord) -> str:
        base = super().format(record)
        parts = [f"{field}={getattr(record, field)}"
                 for field in CONTEXT_FIELDS
                 if getattr(record, field, None) is not None]
        return f"{base} [{' '.join(parts)}]" if parts else base


def configure_logging(json_output: bool = False, level: int = logging.INFO,
                      stream=None) -> logging.Handler:
    """Install one handler on the root logger; returns it so a caller can
    remove it again."""
    handler = logging.StreamHandler(stream)
    if json_output:
        handler.setFormatter(JsonFormatter())
    else:
        handler.setFormatter(ContextTextFormatter(
            "%(asctime)s %(levelname).1s %(name)s: %(message)s"))
    root = logging.getLogger()
    root.addHandler(handler)
    root.setLevel(level)
    return handler
