"""Run logger: tee to logfile + stderr, like the reference's ``log_printf``
(``src/log.cpp:11-35``), plus structured JSONL step metrics (an observability
channel the reference lacks).

Counterpart of ``particlemethod_fsi_tpu/utils/logging.py`` (``RunLog``)."""

from __future__ import annotations

import json
import sys
import time


class RunLog:
    def __init__(self, path=None, metrics_path=None):
        self._f = open(path, "w") if path else None
        self._m = open(metrics_path, "w") if metrics_path else None

    def printf(self, fmt, *args):
        msg = (fmt % args) if args else fmt
        sys.stderr.write(msg)
        if self._f:
            self._f.write(msg)
            self._f.flush()

    def metric(self, **fields):
        if self._m:
            fields.setdefault("wall_time", time.time())
            self._m.write(json.dumps(fields) + "\n")
            self._m.flush()

    def close(self):
        for f in (self._f, self._m):
            if f:
                f.close()
