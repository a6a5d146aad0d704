"""Host-side structured logging: JSONL metric records (counterpart of
``ipoc_tpu/utils/logging.py``, a copy: the port imports nothing of the JAX
package).

The reference logs nothing (SURVEY §5.5: commented-out debug prints and
ad-hoc CSVs).  This is a minimal dependency-free JSONL writer for per-solve
and per-benchmark records; both packages write the same records.
"""

from __future__ import annotations

import json
import os
import time
from typing import IO


class JsonlLogger:
    """Append JSON records (one per line) with timestamps."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._fh: IO | None = None

    def __enter__(self):
        self._fh = open(self.path, "a")
        return self

    def __exit__(self, *exc):
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def log(self, record: dict):
        rec = {"ts": time.time(), **record}
        if self._fh is None:
            with open(self.path, "a") as fh:
                fh.write(json.dumps(rec) + "\n")
        else:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
