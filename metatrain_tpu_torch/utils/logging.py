"""Logging: the package logger, structured CSV metrics and the epoch line.

Counterpart of ``metatrain_tpu/utils/logging.py``: ``setup_logging``
sends the package logger to the console and a log file for the length of
a command; ``CSVMetricsWriter`` writes one row per logged epoch;
``MetricLogger`` prints one aligned ``|``-separated line per interval and
forwards the row to the CSV file.
"""

from __future__ import annotations

import contextlib
import csv
import logging
import sys
from pathlib import Path
from typing import Dict, List, Optional

ROOT_LOGGER = "metatrain_tpu_torch"


@contextlib.contextmanager
def setup_logging(log_file: Optional[str] = None, level: int = logging.INFO):
    """The package logger at ``level`` on stdout and, if given, in
    ``log_file``; the handlers are removed and closed on exit."""
    logger = logging.getLogger(ROOT_LOGGER)
    logger.setLevel(level)
    formatter = logging.Formatter("[%(asctime)s][%(levelname)s] - %(message)s")
    handlers: List[logging.Handler] = [logging.StreamHandler(sys.stdout)]
    if log_file:
        Path(log_file).parent.mkdir(parents=True, exist_ok=True)
        handlers.append(logging.FileHandler(log_file))
    for handler in handlers:
        handler.setFormatter(formatter)
        logger.addHandler(handler)
    try:
        yield logger
    finally:
        for handler in handlers:
            logger.removeHandler(handler)
            handler.close()


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
