"""The per-epoch ``training_log.csv`` writer (the CSV part of
``ugpg_tpu/utils/profiling.py``)."""

from __future__ import annotations

import csv
from pathlib import Path

__all__ = ["CSVLogger"]


class CSVLogger:
    """Append-only CSV with a fixed header."""

    def __init__(self, path: str | Path, fieldnames: list[str]):
        self.path = Path(path)
        self.fieldnames = list(fieldnames)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        if not self.path.exists():
            with open(self.path, "w", newline="") as f:
                csv.DictWriter(f, fieldnames=self.fieldnames).writeheader()

    def log(self, **row):
        with open(self.path, "a", newline="") as f:
            csv.DictWriter(f, fieldnames=self.fieldnames).writerow(
                {k: row.get(k, "") for k in self.fieldnames})
