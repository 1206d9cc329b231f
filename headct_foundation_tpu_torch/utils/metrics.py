"""Meters and downstream classification metrics.

Port of the JAX package's ``utils/metrics.py:22-128`` (reference:
src/utils/misc.py:140-284, engine_downstream.py:299-311):

* ``SmoothedValue`` / ``MetricLogger``: windowed median and mean, global
  averages, and ``log_every``'s ``data_time`` / ``iter_time`` meters.
* ``binary_auroc``: the area under the ROC curve as the Mann-Whitney
  statistic, ranks averaged over ties (``scipy.stats.rankdata``), which is
  what scikit-learn's trapezoid over the ROC curve computes; NaN when only
  one class is present. The port does not need scikit-learn.
* ``multiclass_metrics``: per-class accuracy and one-vs-rest AUROC, their
  ``nanmean`` as ``mean_acc`` and ``mean_auroc``.
"""

from __future__ import annotations

import time
from collections import defaultdict, deque
from typing import Dict, Iterable, Iterator, Optional

import numpy as np
from scipy.stats import rankdata


class SmoothedValue:
    def __init__(self, window_size: int = 20, fmt: Optional[str] = None):
        self.deque: deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt or "{median:.4f} ({global_avg:.4f})"

    def update(self, value: float, n: int = 1):
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self) -> float:
        return float(np.median(list(self.deque))) if self.deque else 0.0

    @property
    def avg(self) -> float:
        return float(np.mean(list(self.deque))) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def max(self) -> float:
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    def __str__(self) -> str:
        return self.fmt.format(median=self.median, avg=self.avg, global_avg=self.global_avg,
                               max=self.max, value=self.value)


class MetricLogger:
    def __init__(self, delimiter: str = "  ", logger=None):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter
        self.logger = logger

    def update(self, **kwargs):
        for k, v in kwargs.items():
            if v is not None:
                self.meters[k].update(float(v))

    def averages(self) -> Dict[str, float]:
        return {k: m.global_avg for k, m in self.meters.items()}

    def __str__(self) -> str:
        return self.delimiter.join(f"{k}: {m}" for k, m in self.meters.items())

    def log_every(self, iterable: Iterable, print_freq: int = 0, header: str = "") -> Iterator:
        """Yield the items, timing each wait on ``iterable`` (``data_time``)
        and each iteration (``iter_time``); ``print_freq`` 0 logs nothing."""
        end = time.time()
        for i, obj in enumerate(iterable):
            self.meters["data_time"].update(time.time() - end)
            yield obj
            self.meters["iter_time"].update(time.time() - end)
            end = time.time()
            if self.logger and print_freq and (i + 1) % print_freq == 0:
                self.logger.info(f"{header} [{i + 1}]  {self}")


def binary_auroc(targets: np.ndarray, probs: np.ndarray) -> float:
    """AUROC of ``probs`` for the 0/1 ``targets``; NaN if only one class is
    present."""
    targets = np.asarray(targets).ravel()
    pos = targets == 1
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    ranks = rankdata(np.asarray(probs, dtype=np.float64).ravel())  # ties: average rank
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def multiclass_metrics(targets: np.ndarray, probs: np.ndarray,
                       num_classes: int) -> Dict[str, float]:
    """Per-class accuracy and AUROC, macro-averaged like torchmetrics'
    MulticlassAccuracy / MulticlassAUROC with average=None, then the mean."""
    targets = np.asarray(targets)
    probs = np.asarray(probs)
    preds = probs.argmax(axis=-1)
    out: Dict[str, float] = {}
    accs, aurocs = [], []
    for c in range(num_classes):
        mask = targets == c
        acc = float((preds[mask] == c).mean()) if mask.any() else float("nan")
        auroc = binary_auroc(mask.astype(np.int32), probs[:, c])
        out[f"acc_{c}"] = acc
        out[f"auroc_{c}"] = auroc
        accs.append(acc)
        aurocs.append(auroc)
    with np.errstate(all="ignore"):
        out["mean_acc"] = float(np.nanmean(accs)) if not np.isnan(accs).all() else float("nan")
        out["mean_auroc"] = (float(np.nanmean(aurocs)) if not np.isnan(aurocs).all()
                             else float("nan"))
    return out
