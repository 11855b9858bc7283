"""What a per-layer metric's reader gets: the traced window, the cell's
files and the counts the benchmark works out from its own inputs."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

from cgbench import profiling
from cgbench.frames import pair_counts


@dataclass
class Context:
    trace: profiling.Trace
    config: dict
    traffic: dict
    chips: int
    frames: np.ndarray                  # (F, N, 3) the cell's frames
    flops_per_step: Optional[float]     # the whole step's model FLOPs, every chip's rows
    peaks = profiling
    _pairs: Dict[Tuple[str, float], float] = field(default_factory=dict)

    @property
    def rows_per_chip(self) -> int:
        return self.traffic["batch_size"] // self.chips

    def pairs_per_frame(self, level: str, cutoff: float) -> float:
        """Mean ordered pairs within ``cutoff`` per frame, of the atoms
        ("atoms") or of the beads' mean positions ("beads"): one step's
        batch draws whole epochs' frames, so every launch weighs the mean."""
        key = (level, cutoff)
        if key not in self._pairs:
            xyz = self.frames
            if level == "beads":
                mapping = np.asarray(self.config["molecule"]["mapping"])
                onehot = np.eye(mapping.max() + 1)[mapping]
                xyz = np.einsum("fnd,nk->fkd", xyz, onehot) / onehot.sum(0)[:, None]
            self._pairs[key] = float(np.mean(pair_counts(xyz, cutoff)))
        return self._pairs[key]
