"""SUTS v4.0 structured JSON logging: a copy of the JAX package's
``serving/suts_logging.py``.

One JSON object per line with schema_v, ISO-8601 UTC ts (ms), SEVERITY, a
resource block from environment variables, and
event/trace_id/span_id/tenant_id/message with "unknown" → null (the
reference service's spdlog formatter, its suts_logger.h:97-172).
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Optional

from ..text import clean_utf8

SERVICE_NAME = "stt-whisper-service"
APP_VERSION = "2.6.9-cuda"


def _nullable(v: Optional[str]):
    if not v or v == "unknown":
        return None
    return clean_utf8(v)


class SutsFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        ts = time.gmtime(record.created)
        ms = int((record.created % 1) * 1000)
        severity = record.levelname.upper()
        if severity == "WARNING":
            severity = "WARN"
        doc = {
            "schema_v": "1.0.0",
            "ts": time.strftime("%Y-%m-%dT%H:%M:%S", ts) + f".{ms:03d}Z",
            "severity": severity,
            "resource": {
                "service.name": SERVICE_NAME,
                "service.version": APP_VERSION,
                "service.env": os.environ.get("ENV", "production"),
                "host.name": os.environ.get("HOSTNAME", "unknown"),
            },
            "event": getattr(record, "event", "LOG_EVENT"),
            "trace_id": _nullable(getattr(record, "trace_id", None)),
            "span_id": _nullable(getattr(record, "span_id", None)),
            "tenant_id": _nullable(getattr(record, "tenant_id", None)),
            "message": clean_utf8(record.getMessage()),
        }
        try:
            return json.dumps(doc, ensure_ascii=False)
        except Exception:
            return (
                '{"schema_v":"1.0.0","severity":"ERROR",'
                '"event":"LOG_FATAL_ERROR","message":"serialize failed"}'
            )


_logger = logging.getLogger("suts")


def setup_logging(level: str = "info") -> logging.Logger:
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(SutsFormatter())
    root = logging.getLogger()
    root.handlers = [handler]
    root.setLevel(getattr(logging, level.upper(), logging.INFO))
    return _logger


def _log(level, event, trace_id, span_id, tenant_id, message, *args):
    _logger.log(
        level,
        message % args if args else message,
        extra={
            "event": event,
            "trace_id": trace_id,
            "span_id": span_id,
            "tenant_id": tenant_id,
        },
    )


def suts_info(event, trace_id, span_id, tenant_id, message, *args):
    _log(logging.INFO, event, trace_id, span_id, tenant_id, message, *args)


def suts_warn(event, trace_id, span_id, tenant_id, message, *args):
    _log(logging.WARNING, event, trace_id, span_id, tenant_id, message, *args)


def suts_error(event, trace_id, span_id, tenant_id, message, *args):
    _log(logging.ERROR, event, trace_id, span_id, tenant_id, message, *args)


def suts_debug(event, trace_id, span_id, tenant_id, message, *args):
    _log(logging.DEBUG, event, trace_id, span_id, tenant_id, message, *args)
