"""Logging: the package logger, structured CSV metrics and the epoch line.

Counterpart of ``metatrain_tpu/utils/logging.py``: ``CSVMetricsWriter``
writes one row per logged epoch; ``MetricLogger`` prints one aligned
``|``-separated line per interval and forwards the row to the CSV file.
"""

from __future__ import annotations

import csv
import logging
from pathlib import Path
from typing import Dict, List, Optional

ROOT_LOGGER = "metatrain_tpu_torch"


class CSVMetricsWriter:
    """Structured per-epoch metrics."""

    def __init__(self, path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fieldnames: Optional[List[str]] = None

    def write(self, row: Dict[str, float]) -> None:
        if self._fieldnames is None:
            self._fieldnames = list(row.keys())
            with open(self.path, "w", newline="") as f:
                csv.DictWriter(f, fieldnames=self._fieldnames).writeheader()
        with open(self.path, "a", newline="") as f:
            csv.DictWriter(f, fieldnames=self._fieldnames, extrasaction="ignore").writerow(row)


class MetricLogger:
    """One aligned metrics line per log interval."""

    def __init__(self, logger: logging.Logger, csv_writer: Optional[CSVMetricsWriter] = None):
        self.logger = logger
        self.csv_writer = csv_writer

    def log(self, epoch: int, metrics: Dict[str, float],
            learning_rate: Optional[float] = None) -> None:
        parts = [f"Epoch {epoch:6d}"]
        if learning_rate is not None:
            parts.append(f"lr {learning_rate:.3e}")
        parts += [f"{key} {value: .5e}" for key, value in metrics.items()]
        self.logger.info(" | ".join(parts))
        if self.csv_writer is not None:
            row = {"epoch": epoch, **metrics}
            if learning_rate is not None:
                row["learning_rate"] = learning_rate
            self.csv_writer.write(row)
