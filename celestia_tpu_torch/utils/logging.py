"""Structured logging: leveled key-value logger with plain/JSON output.

Parity role: the reference's structured loggers — comet's logger through
app.Logger(), zerolog in txsim (test/txsim/run.go:49), the --log-to-file
flag (cmd/celestia-appd/cmd/root.go:48-106), and structured
rejected-proposal logs with proposer context (app/process_proposal.go:168-188).
"""

from __future__ import annotations

import json
import sys
import threading
import time
from typing import Any, IO, Optional

LEVELS = {"debug": 10, "info": 20, "warn": 30, "error": 40}


class Logger:
    def __init__(
        self,
        level: str = "info",
        fmt: str = "plain",
        stream: Optional[IO[str]] = None,
        to_file: str = "",
        **bound: Any,
    ):
        self.level = LEVELS.get(level, 20)
        self.fmt = fmt
        self._bound = bound
        self._lock = threading.Lock()
        if to_file:
            self._stream: IO[str] = open(to_file, "a", buffering=1)
        else:
            self._stream = stream if stream is not None else sys.stderr

    def with_fields(self, **fields: Any) -> "Logger":
        child = Logger.__new__(Logger)
        child.level = self.level
        child.fmt = self.fmt
        child._bound = {**self._bound, **fields}
        child._lock = self._lock
        child._stream = self._stream
        return child

    def _log(self, level: str, msg: str, fields: dict) -> None:
        if LEVELS[level] < self.level:
            return
        record = {
            "ts": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "level": level,
            "msg": msg,
            **self._bound,
            **fields,
        }
        if self.fmt == "json":
            line = json.dumps(record, default=str)
        else:
            extras = " ".join(
                f"{k}={v}" for k, v in record.items()
                if k not in ("ts", "level", "msg")
            )
            line = f"{record['ts']} {level.upper():5s} {msg}"
            if extras:
                line += f" | {extras}"
        with self._lock:
            self._stream.write(line + "\n")

    def debug(self, msg: str, **fields: Any) -> None:
        self._log("debug", msg, fields)

    def info(self, msg: str, **fields: Any) -> None:
        self._log("info", msg, fields)

    def warn(self, msg: str, **fields: Any) -> None:
        self._log("warn", msg, fields)

    def error(self, msg: str, **fields: Any) -> None:
        self._log("error", msg, fields)


_null = Logger(level="error", stream=open("/dev/null", "w"))


def null_logger() -> Logger:
    """A silenced logger for tests / library defaults."""
    return _null
