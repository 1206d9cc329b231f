"""Evaluation plots the downstream tester writes.

Port of the JAX package's ``utils/plots.py:43,77``: one
``roc_pr_curve_plot_<percent>.png`` with an ROC panel and a
precision-recall panel, and one ``regression_plot_<percent>.png`` scatter
with the identity line (reference surface: src/utils/misc.py:487-540).

The curves are computed here with numpy (the port does not need
scikit-learn). matplotlib is imported inside the plotting functions, as in
the JAX package: ``plotting_available`` says whether it imports, and the
tester writes no PNG where it does not. These are host artifacts; the
predictions pickle is the tester's result.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np


def plotting_available() -> bool:
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def _curve_counts(targets, preds) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(false positives, true positives, threshold) at each distinct score,
    from the highest score down."""
    targets = np.asarray(targets).ravel().astype(np.float64)
    preds = np.asarray(preds, dtype=np.float64).ravel()
    order = np.argsort(-preds, kind="mergesort")
    preds, targets = preds[order], targets[order]
    last = np.r_[np.nonzero(np.diff(preds))[0], preds.size - 1]  # last index of each score
    tps = np.cumsum(targets)[last]
    return 1 + last - tps, tps, preds[last]


def roc_curve(targets, preds) -> Tuple[np.ndarray, np.ndarray]:
    """(false positive rate, true positive rate), starting at (0, 0)."""
    fps, tps, _ = _curve_counts(targets, preds)
    fps, tps = np.r_[0.0, fps], np.r_[0.0, tps]
    return fps / max(fps[-1], 1.0), tps / max(tps[-1], 1.0)


def precision_recall_curve(targets, preds) -> Tuple[np.ndarray, np.ndarray]:
    """(precision, recall) at each threshold, recall decreasing, ending at
    (1, 0)."""
    fps, tps, _ = _curve_counts(targets, preds)
    precision = tps / np.maximum(tps + fps, 1.0)
    recall = tps / max(tps[-1], 1.0)
    return np.r_[precision[::-1], 1.0], np.r_[recall[::-1], 0.0]


def average_precision(targets, preds) -> float:
    """sum_n (R_n - R_{n-1}) P_n over the thresholds."""
    precision, recall = precision_recall_curve(targets, preds)
    return float(-np.sum(np.diff(recall) * precision[:-1]))


def _new_axes(n_panels: int, width_per_panel: float = 6.0):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, n_panels, figsize=(width_per_panel * n_panels, width_per_panel))
    return fig, np.atleast_1d(axes)


def _save(fig, out_dir: str, name: str) -> str:
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name)
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)
    return path


def plot_pr_curve(targets, preds, out_dir: str = "plots", percent: str = "None") -> str:
    """Binary ROC and precision-recall panels; returns the PNG's path."""
    targets = np.asarray(targets).ravel()
    preds = np.asarray(preds).ravel()
    fig, (ax_roc, ax_pr) = _new_axes(2)
    fpr, tpr = roc_curve(targets, preds)
    auc = float(np.sum(np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2))  # trapezoids
    ax_roc.plot(fpr, tpr, color="tab:blue", lw=2, label=f"AUROC = {auc:.4f}")
    ax_roc.plot([0, 1], [0, 1], color="gray", ls=":", lw=1, label="chance")
    ax_roc.set(xlabel="false positive rate", ylabel="true positive rate", title="ROC",
               xlim=(0, 1), ylim=(0, 1.02))
    ax_roc.legend(loc="lower right", frameon=False)
    precision, recall = precision_recall_curve(targets, preds)
    prevalence = float(targets.mean()) if targets.size else 0.0
    ax_pr.step(recall, precision, color="tab:orange", lw=2, where="post",
               label=f"AP = {average_precision(targets, preds):.4f}")
    ax_pr.axhline(prevalence, color="gray", ls=":", lw=1, label="prevalence")
    ax_pr.set(xlabel="recall", ylabel="precision", title="precision-recall", xlim=(0, 1),
              ylim=(0, 1.02))
    ax_pr.legend(loc="best", frameon=False)
    return _save(fig, out_dir, f"roc_pr_curve_plot_{percent}.png")


def plot_regression(x, y, title: str, out_dir: str = "plots", percent: str = "None") -> str:
    """Prediction-vs-target scatter with the identity line; returns the path."""
    x = np.asarray(x, dtype=np.float64).ravel()
    y = np.asarray(y, dtype=np.float64).ravel()
    fig, (ax,) = _new_axes(1, width_per_panel=7.0)
    ax.scatter(x, y, s=18, alpha=0.7, color="tab:blue", label="samples")
    lo = float(min(x.min(), y.min())) if x.size else 0.0
    hi = float(max(x.max(), y.max())) if x.size else 1.0
    ax.plot([lo, hi], [lo, hi], color="gray", ls="--", lw=1, label="y = x")
    if x.size > 1 and np.std(x) > 0 and np.std(y) > 0:
        ax.set_title(f"{title}  (r = {float(np.corrcoef(x, y)[0, 1]):.3f})")
    else:
        ax.set_title(title)
    ax.set(xlabel="target", ylabel="prediction", xlim=(lo, hi), ylim=(lo, hi))
    ax.set_aspect("equal", adjustable="box")
    ax.legend(loc="upper left", frameon=False)
    return _save(fig, out_dir, f"regression_plot_{percent}.png")
