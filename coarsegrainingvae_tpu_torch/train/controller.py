"""Host-side training controllers: LOWESS-smoothed plateau LR schedule and
early stopping (port of ``coarsegrainingvae_tpu.train.controller``;
run_ala.py:261-274 + scripts/utils.py:54-79 of the original code). Plain
numpy; nothing here touches the device."""
from __future__ import annotations

import numpy as np


def lowess_smooth(y: np.ndarray, frac: float = 0.2, it: int = 3) -> np.ndarray:
    """Locally-weighted regression (statsmodels-style lowess) on x=0..n-1.

    The reference smooths the validation curve with sm.nonparametric.lowess
    (run_ala.py:261-264) and feeds the last smoothed value to the plateau
    scheduler. Tricube weights + robustifying iterations, returned over all x.
    """
    y = np.asarray(y, dtype=np.float64)
    n = y.shape[0]
    if n <= 2:
        return y.copy()
    x = np.arange(n, dtype=np.float64)
    r = max(int(np.ceil(frac * n)), 2)
    out = np.zeros(n)
    delta = np.ones(n)
    for _ in range(max(it, 1)):
        for i in range(n):
            d = np.abs(x - x[i])
            idx = np.argsort(d)[:r]
            dmax = d[idx].max()
            w = (1 - (d[idx] / max(dmax, 1e-12)) ** 3) ** 3
            w = np.clip(w, 0, None) * delta[idx]
            sw = w.sum()
            if sw <= 0:
                out[i] = y[i]
                continue
            xw = x[idx]
            yw = y[idx]
            xm = (w * xw).sum() / sw
            ym = (w * yw).sum() / sw
            cov = (w * (xw - xm) * (yw - ym)).sum()
            var = (w * (xw - xm) ** 2).sum()
            b = cov / var if var > 1e-12 else 0.0
            out[i] = ym + b * (x[i] - xm)
        resid = y - out
        s = np.median(np.abs(resid))
        if s <= 0:
            break
        delta = np.clip(resid / (6.0 * s), -1, 1)
        delta = (1 - delta**2) ** 2
    return out


class EarlyStopping:
    """Patience counter on (smoothed) validation loss
    (scripts/utils.py:54-79)."""

    def __init__(self, patience: int = 5, min_delta: float = 0.0):
        self.patience = patience
        self.min_delta = min_delta
        self.counter = 0
        self.best_loss: float | None = None
        self.early_stop = False

    def __call__(self, val_loss: float) -> None:
        if self.best_loss is None:
            self.best_loss = val_loss
        elif self.best_loss - val_loss > self.min_delta:
            self.best_loss = val_loss
            self.counter = 0
        else:
            self.counter += 1
            if self.counter >= self.patience:
                self.early_stop = True

    def save_state(self) -> dict:
        return {
            "counter": self.counter,
            "best_loss": self.best_loss,
            "early_stop": self.early_stop,
        }

    def load_state(self, s: dict) -> None:
        self.counter = s.get("counter", 0)
        self.best_loss = s.get("best_loss")
        self.early_stop = s.get("early_stop", False)


class LowessPlateauController:
    """ReduceLROnPlateau driven by the LOWESS-smoothed val curve
    (torch scheduler at run_ala.py:213-215 + smoothing at :261-266).

    Tracks the full val-loss history, recomputes the smoothed last value each
    epoch, and multiplies the LR by `factor` after `patience` epochs without
    improvement. `converged` turns True once lr <= 1.5 * min_lr
    (run_ala.py:269-271).
    """

    def __init__(
        self,
        lr: float,
        factor: float = 0.6,
        patience: int = 2,
        min_lr: float = 5e-8,
        threshold: float = 1e-4,
        frac: float = 0.2,
    ):
        self.lr = lr
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.threshold = threshold
        self.frac = frac
        self.history: list[float] = []
        self.best: float | None = None
        self.num_bad = 0

    @property
    def converged(self) -> bool:
        return self.lr <= self.min_lr * 1.5

    def step(self, val_loss: float) -> float:
        """Record a raw val loss; returns the smoothed value used."""
        self.history.append(float(val_loss))
        smoothed = float(lowess_smooth(np.array(self.history), frac=self.frac)[-1])
        # torch's rel-threshold mode: improvement if < best * (1 - threshold)
        if self.best is None or smoothed < self.best * (1.0 - self.threshold):
            self.best = smoothed
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.num_bad = 0
        return smoothed

    def save_state(self) -> dict:
        return {
            "lr": self.lr,
            "history": self.history,
            "best": self.best,
            "num_bad": self.num_bad,
        }

    def load_state(self, s: dict) -> None:
        self.lr = s.get("lr", self.lr)
        self.history = list(s.get("history", []))
        self.best = s.get("best")
        self.num_bad = s.get("num_bad", 0)
