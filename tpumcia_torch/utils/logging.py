"""Structured JSONL metrics logging (counterpart of
``tpumcia.utils.logging``)."""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path


def _json_default(o):
    item = getattr(o, "item", None)
    if item is not None and getattr(o, "ndim", 1) == 0:
        return item()  # a numpy scalar or a 0-d tensor, on any device
    tolist = getattr(o, "tolist", None)
    if tolist is not None:
        return tolist()  # a numpy array or a tensor
    raise TypeError(f"not JSON serializable: {type(o).__name__}")


class MetricsLogger:
    """Append-only JSONL metrics stream (stdout and/or file)."""

    def __init__(self, path: str | Path | None = None, echo: bool = False):
        self._fh = open(path, "a") if path else None
        self._echo = echo or path is None

    def log(self, event: str, **fields) -> dict:
        rec = {"ts": time.time(), "event": event, **fields}
        # numpy and tensor values serialize rather than raise in the middle
        # of a long run
        line = json.dumps(rec, default=_json_default)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()
        if self._echo:
            print(line, file=sys.stdout, flush=True)
        return rec

    def close(self):
        if self._fh:
            self._fh.close()
