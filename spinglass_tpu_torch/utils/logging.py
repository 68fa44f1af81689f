"""Structured logging: JSON formatter, rotation, timing/progress helpers.

Copied from ``spinglass_tpu.utils.logging``: the port imports nothing of
the JAX package.

Rebuilds reference utils/logging.py:61-293 (setup_logger + JSONFormatter +
rotating files + env config) and its PerformanceLogger/TimingContext/
ProgressLogger (:91-219), plus the redaction filter idea from
utils/robust_logging.py:91-115."""

from __future__ import annotations

import json
import logging
import logging.handlers
import os
import re
import time
from contextlib import contextmanager
from typing import Optional

_REDACT = re.compile(r"(api[_-]?key|token|secret|password)\s*[=:]\s*\S+",
                     re.IGNORECASE)


class JSONFormatter(logging.Formatter):
    """One JSON object per line (reference logging.py:61-89)."""

    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": self.formatTime(record, "%Y-%m-%dT%H:%M:%S"),
            "level": record.levelname,
            "logger": record.name,
            "message": record.getMessage(),
        }
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        for key in ("metric", "value", "unit", "component", "operation"):
            if hasattr(record, key):
                out[key] = getattr(record, key)
        return json.dumps(out)


class RedactionFilter(logging.Filter):
    """Scrub credential-looking strings (reference robust_logging.py:91-115)."""

    def filter(self, record: logging.LogRecord) -> bool:
        msg = record.getMessage()
        scrubbed = _REDACT.sub(r"\1=<redacted>", msg)
        if scrubbed != msg:
            record.msg = scrubbed
            record.args = ()
        return True


def setup_logger(name: str = "spinglass_tpu",
                 level: Optional[str] = None,
                 log_file: Optional[str] = None,
                 json_format: Optional[bool] = None,
                 max_bytes: int = 10 * 1024 * 1024,
                 backup_count: int = 3) -> logging.Logger:
    """Configured logger; env overrides SGT_LOG_LEVEL / SGT_LOG_FILE /
    SGT_LOG_JSON (reference logging.py:271-293)."""
    level = level or os.environ.get("SGT_LOG_LEVEL", "INFO")
    log_file = log_file or os.environ.get("SGT_LOG_FILE")
    if json_format is None:
        json_format = os.environ.get("SGT_LOG_JSON", "0") == "1"

    logger = logging.getLogger(name)
    logger.setLevel(level.upper())
    logger.handlers.clear()
    fmt = (JSONFormatter() if json_format else logging.Formatter(
        "%(asctime)s %(levelname)s %(name)s: %(message)s"))
    handler: logging.Handler = logging.StreamHandler()
    handler.setFormatter(fmt)
    handler.addFilter(RedactionFilter())
    logger.addHandler(handler)
    if log_file:
        fh = logging.handlers.RotatingFileHandler(
            log_file, maxBytes=max_bytes, backupCount=backup_count)
        fh.setFormatter(JSONFormatter())
        fh.addFilter(RedactionFilter())
        logger.addHandler(fh)
    logger.propagate = False
    return logger


class PerformanceLogger:
    """Metric logging + timing contexts (reference logging.py:91-219)."""

    def __init__(self, logger: Optional[logging.Logger] = None):
        self.logger = logger or setup_logger()
        self.timings: dict[str, list] = {}

    def log_metric(self, metric: str, value: float, unit: str = "") -> None:
        self.logger.info(f"{metric}={value}{unit}",
                         extra={"metric": metric, "value": value,
                                "unit": unit})

    @contextmanager
    def timer(self, operation: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.timings.setdefault(operation, []).append(dt)
            self.logger.debug(f"{operation} took {dt:.4f}s",
                              extra={"operation": operation, "value": dt,
                                     "unit": "s"})

    def summary(self) -> dict:
        import numpy as np

        return {
            op: {"n": len(ts), "total": float(np.sum(ts)),
                 "mean": float(np.mean(ts)), "max": float(np.max(ts))}
            for op, ts in self.timings.items()
        }


class ProgressLogger:
    """Interval progress reports (reference logging.py:176-219)."""

    def __init__(self, total: int, name: str = "run",
                 logger: Optional[logging.Logger] = None,
                 report_every: int = 10):
        self.total = total
        self.name = name
        self.logger = logger or setup_logger()
        self.report_every = report_every
        self.start = time.perf_counter()
        self.count = 0

    def update(self, n: int = 1, **info) -> None:
        self.count += n
        if self.count % self.report_every == 0 or self.count >= self.total:
            elapsed = time.perf_counter() - self.start
            rate = self.count / elapsed if elapsed > 0 else 0
            eta = (self.total - self.count) / rate if rate > 0 else 0
            extra = " ".join(f"{k}={v}" for k, v in info.items())
            self.logger.info(
                f"{self.name}: {self.count}/{self.total} "
                f"({100 * self.count / self.total:.0f}%) rate={rate:.1f}/s "
                f"eta={eta:.0f}s {extra}")


_default_logger: Optional[logging.Logger] = None


def get_logger() -> logging.Logger:
    global _default_logger
    if _default_logger is None:
        _default_logger = setup_logger()
    return _default_logger
