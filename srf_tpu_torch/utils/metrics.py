"""Structured metrics: JSONL stream + reference-format console lines (the
port's own copy of ``srf_tpu/utils/metrics.py``).

The reference tracks Mean/Sum keras metrics and prints
``STEP <n> <pct> <loss> <lr>`` every 50 steps plus per-epoch summary lines
(reference: tfsr/trainer_sr.py:161-164,218-221,261-274). Here the same
console lines are emitted (so humans and log scrapers see familiar output)
and every record also lands in a metrics.jsonl for tooling.
"""

import json
import os
import time


class MeanMetric:
    def __init__(self):
        self.total = 0.0
        self.count = 0.0

    def update(self, total, count=1.0):
        self.total += float(total)
        self.count += float(count)

    def result(self):
        return self.total / self.count if self.count else 0.0

    def reset(self):
        self.total = 0.0
        self.count = 0.0


class SumMetric:
    def __init__(self):
        self.total = 0.0

    def update(self, value):
        self.total += float(value)

    def result(self):
        return self.total

    def reset(self):
        self.total = 0.0


class MetricsWriter:
    def __init__(self, path=None):
        self.path = path
        self._file = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._file = open(path, "a")

    def write(self, record):
        if self._file:
            record = dict(record)
            record.setdefault("ts", time.time())
            self._file.write(json.dumps(record) + "\n")
            self._file.flush()

    def close(self):
        if self._file:
            self._file.close()
