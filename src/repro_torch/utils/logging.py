"""Minimal structured logger (stdout, flush-friendly for long runs): the JAX
package's `repro.utils.logging`, copied (it is plain Python).

Two output modes per logger:

* text (default) — ``HH:MM:SS L name :: message``
* JSON  (``json=True``) — one object per line
  (``{"ts", "level", "logger", "msg"}``), the mode log-scraping serving
  deployments want; switching an existing logger's mode swaps its
  formatter in place.

The handler resolves ``sys.stdout`` at *emit* time rather than capturing
the stream at logger creation. A handler bound to the import-time stdout
keeps writing to the original file descriptor after something replaces
``sys.stdout`` — under pytest's capture that meant the first test to
import a module both leaked log lines past capsys and, when a second
differently-configured handler was attached to compensate, printed every
record twice. One marker-tagged handler per logger, current stream,
formatted exactly once.
"""
from __future__ import annotations

import json
import logging
import sys

_FMT = "%(asctime)s %(levelname).1s %(name)s :: %(message)s"
_MARKER = "_repro_torch_handler"


class _CurrentStdoutHandler(logging.StreamHandler):
    """StreamHandler that follows ``sys.stdout`` reassignments."""

    def __init__(self):
        super().__init__(sys.stdout)

    @property
    def stream(self):
        return sys.stdout

    @stream.setter
    def stream(self, value):     # base __init__/setStream write this — the
        pass                     # live property wins, so ignore

    def emit(self, record):
        try:
            super().emit(record)
        except ValueError:       # emit raced a closing captured stream
            pass


class _JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": self.formatTime(record, "%Y-%m-%dT%H:%M:%S"),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out, ensure_ascii=False)


def get_logger(name: str = "repro_torch",
               json: bool = False) -> logging.Logger:
    logger = logging.getLogger(name)
    ours = [h for h in logger.handlers if getattr(h, _MARKER, False)]
    if not ours:
        handler = _CurrentStdoutHandler()
        setattr(handler, _MARKER, True)
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
        ours = [handler]
    fmt = _JsonFormatter() if json \
        else logging.Formatter(_FMT, datefmt="%H:%M:%S")
    for h in ours:
        h.setFormatter(fmt)
    return logger
