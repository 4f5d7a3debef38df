"""Structured logging with per-stream request-id propagation.

The same code as ``repro.obs.logs``.

``logging_setup()`` replaces the ad-hoc ``logging.basicConfig`` calls in
the launch scripts with one shared configuration: a text formatter that
carries ``rid=<request-id>`` in every record, or JSON-lines with
``--log-json``.  The request id rides a :class:`contextvars.ContextVar`,
so nested library code logs with the right id without threading it
through every call:

    with request_context("7"):
        log.info("stream done")     # ... rid=7 stream done

The filter/formatter pair only ever *adds* fields; third-party records
without a request context get ``rid=-``.
"""
from __future__ import annotations

import contextlib
import contextvars
import json
import logging
import time
from typing import Optional

__all__ = [
    "logging_setup",
    "request_context",
    "current_request_id",
    "JsonFormatter",
    "TEXT_FORMAT",
]

_request_id: contextvars.ContextVar = contextvars.ContextVar(
    "spidr_request_id", default="-")

TEXT_FORMAT = "%(asctime)s %(levelname)s %(name)s rid=%(request_id)s %(message)s"


def current_request_id() -> str:
    return _request_id.get()


@contextlib.contextmanager
def request_context(rid):
    """Bind a request id to every log record emitted inside the block."""
    token = _request_id.set(str(rid))
    try:
        yield
    finally:
        _request_id.reset(token)


class _RequestIdFilter(logging.Filter):
    def filter(self, record: logging.LogRecord) -> bool:
        if not hasattr(record, "request_id"):
            record.request_id = _request_id.get()
        return True


class JsonFormatter(logging.Formatter):
    """One JSON object per line; stable keys for log shippers."""

    def format(self, record: logging.LogRecord) -> str:
        payload = {
            "ts": round(record.created, 6),
            "level": record.levelname,
            "logger": record.name,
            "request_id": getattr(record, "request_id", _request_id.get()),
            "message": record.getMessage(),
        }
        if record.exc_info:
            payload["exc"] = self.formatException(record.exc_info)
        return json.dumps(payload)


def logging_setup(json_mode: bool = False, level: int = logging.INFO,
                  logger: Optional[logging.Logger] = None,
                  stream=None) -> logging.Logger:
    """Configure ``logger`` (root by default) for structured output.

    Idempotent: an existing handler installed by a previous call is
    replaced, not duplicated, so re-running ``serve.py`` entry points in
    one process (tests, notebooks) keeps a single handler.
    """
    logger = logger if logger is not None else logging.getLogger()
    handler = logging.StreamHandler(stream) if stream is not None \
        else logging.StreamHandler()
    handler.addFilter(_RequestIdFilter())
    if json_mode:
        handler.setFormatter(JsonFormatter())
    else:
        fmt = logging.Formatter(TEXT_FORMAT)
        fmt.converter = time.gmtime
        handler.setFormatter(fmt)
    handler._spidr_obs_handler = True  # marker for idempotent replacement
    for h in list(logger.handlers):
        if getattr(h, "_spidr_obs_handler", False):
            logger.removeHandler(h)
    logger.addHandler(handler)
    logger.setLevel(level)
    return logger
