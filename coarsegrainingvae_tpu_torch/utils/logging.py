"""Run logging: per-epoch CSV (the column contract of the original code's
train_log.csv, run_ala.py:228-229) and structured JSONL (port of
``coarsegrainingvae_tpu.utils.logging``).

``CSVLogger`` appends to a file that already exists, so a resumed fold
continues its ``train_log.csv``."""
from __future__ import annotations

import csv
import json
import os
from datetime import date
from typing import Dict, Optional, Sequence


def annotate_job(task: str, job_name: str, n_cg: int) -> str:
    """Logdir naming convention {job}_{MM-DD}_{task}_N{n_cgs}
    (scripts/utils.py:22-24)."""
    today = date.today().strftime("%m-%d")
    return f"{job_name}_{today}_{task}_N{n_cg}"


class CSVLogger:
    def __init__(self, path: str, fieldnames: Optional[Sequence[str]] = None):
        self.path = path
        self.fieldnames = list(fieldnames) if fieldnames else None
        self._started = False

    def log(self, row: Dict) -> None:
        if self.fieldnames is None:
            self.fieldnames = list(row.keys())
        write_header = not self._started and not os.path.exists(self.path)
        mode = "a" if self._started or os.path.exists(self.path) else "w"
        with open(self.path, mode, newline="") as f:
            w = csv.DictWriter(f, fieldnames=self.fieldnames, extrasaction="ignore")
            if write_header:
                w.writeheader()
            w.writerow(row)
        self._started = True


class JSONLLogger:
    def __init__(self, path: str):
        self.path = path

    def log(self, row: Dict) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps(row) + "\n")
