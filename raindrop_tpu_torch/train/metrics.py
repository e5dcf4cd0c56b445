"""Host-side evaluation metrics (port of raindrop_tpu/train/metrics.py).

The reference protocol scores train/val with an element-wise sigmoid on the
raw logits and test with a row softmax; multiclass data scores one-hot
AUROC/AUPRC over the classes present plus macro precision/recall/F1;
accuracy is argmax over the raw logits. The JAX package calls scikit-learn
for the scores. The port computes the same numbers in numpy and scipy (the
tests hold each against scikit-learn's to 1e-12), so it needs no
scikit-learn where it runs:

  AUROC   the Mann-Whitney statistic with ties at their midrank, which is
          the trapezoid area under scikit-learn's ROC curve;
  AUPRC   average precision, sum over the distinct score thresholds of
          (R_n - R_{n-1}) * P_n (scikit-learn's step-wise definition, no
          interpolation);
  macro precision / recall / F1 over the labels that occur in y or in the
          predictions, a ratio with a zero denominator counted as 0
          (`zero_division=0`).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
from scipy.stats import rankdata


def one_hot(y: np.ndarray, n_classes: int) -> np.ndarray:
    """Dense one-hot."""
    return np.eye(n_classes)[np.asarray(y).reshape(-1)]


def binary_probs_sigmoid(logits: np.ndarray) -> np.ndarray:
    """Element-wise sigmoid 'probabilities', the reference's train/val
    quirk: not a softmax, both columns squashed independently."""
    return 1.0 / (1.0 + np.exp(-np.asarray(logits, np.float64)))


def softmax_probs(logits: np.ndarray) -> np.ndarray:
    """Row softmax (the reference's test path)."""
    z = np.asarray(logits, np.float64)
    z = z - z.max(axis=1, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=1, keepdims=True)


def confusion_matrix_np(y: np.ndarray, ypred: np.ndarray, labels) -> np.ndarray:
    """C[i, j] = number of samples with true label labels[i] predicted
    labels[j]; samples with a label outside `labels` are left out."""
    labels = np.asarray(labels)
    n = len(labels)
    pos = {int(v): i for i, v in enumerate(labels)}
    C = np.zeros((n, n), np.int64)
    for t, p in zip(np.asarray(y).reshape(-1), np.asarray(ypred).reshape(-1)):
        ti, pi = pos.get(int(t)), pos.get(int(p))
        if ti is not None and pi is not None:
            C[ti, pi] += 1
    return C


def binary_auroc(y_true: np.ndarray, score: np.ndarray) -> float:
    """Area under the ROC curve of one binary column; NaN when y_true
    holds one class only (undefined; scikit-learn warns and gives NaN)."""
    y_true = np.asarray(y_true).reshape(-1) > 0
    n_pos = int(y_true.sum())
    n_neg = y_true.size - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    ranks = rankdata(np.asarray(score, np.float64).reshape(-1))   # midranks
    return float((ranks[y_true].sum() - n_pos * (n_pos + 1) / 2.0)
                 / (n_pos * n_neg))


def binary_average_precision(y_true: np.ndarray, score: np.ndarray) -> float:
    """Average precision of one binary column."""
    y_true = (np.asarray(y_true).reshape(-1) > 0).astype(np.float64)
    score = np.asarray(score, np.float64).reshape(-1)
    order = np.argsort(score, kind="mergesort")[::-1]
    score, y_true = score[order], y_true[order]
    # the last index of each run of equal scores: one threshold per value
    ends = np.r_[np.where(np.diff(score))[0], y_true.size - 1]
    tps = np.cumsum(y_true)[ends]
    fps = 1 + ends - tps
    precision = tps / (tps + fps)
    recall = tps / tps[-1] if tps[-1] > 0 else np.ones_like(tps)
    return float(np.sum(np.diff(np.r_[0.0, recall]) * precision))


def _macro_over_columns(fn, Y: np.ndarray, S: np.ndarray) -> float:
    return float(np.mean([fn(Y[:, j], S[:, j]) for j in range(Y.shape[1])]))


def _per_label(y: np.ndarray, ypred: np.ndarray) -> Tuple[np.ndarray, ...]:
    """(labels, precision, recall, f1, support) per label of y or ypred,
    with a zero denominator counted as 0."""
    labels = np.unique(np.concatenate([y, ypred]))
    tp = np.array([np.sum((y == c) & (ypred == c)) for c in labels], np.float64)
    n_pred = np.array([np.sum(ypred == c) for c in labels], np.float64)
    support = np.array([np.sum(y == c) for c in labels], np.int64)

    def ratio(a, b):
        return np.divide(a, b, out=np.zeros_like(a), where=b > 0)

    precision, recall = ratio(tp, n_pred), ratio(tp, support.astype(np.float64))
    f1 = ratio(2.0 * tp, n_pred + support)
    return labels, precision, recall, f1, support


def classification_report_str(y: np.ndarray, ypred: np.ndarray) -> str:
    """Per-class precision/recall/F1/support, accuracy, macro and weighted
    averages as text, in scikit-learn's `classification_report` layout
    (two digits, `zero_division=0`): the reference's test-time
    diagnostic."""
    y, ypred = np.asarray(y).reshape(-1), np.asarray(ypred).reshape(-1)
    labels, precision, recall, f1, support = _per_label(y, ypred)
    width = max(max(len(str(c)) for c in labels), len("weighted avg"))
    row = "{:>{w}s} " + " {:>9.2f}" * 3 + " {:>9}\n"
    out = ("{:>{w}s} " + " {:>9}" * 4).format(
        "", "precision", "recall", "f1-score", "support", w=width) + "\n\n"
    for c, p, r, f, s in zip(labels, precision, recall, f1, support):
        out += row.format(str(c), p, r, f, int(s), w=width)
    total = int(support.sum())
    out += "\n" + ("{:>{w}s} " + " {:>9}" * 2 + " {:>9.2f} {:>9}\n").format(
        "accuracy", "", "", float(np.mean(y == ypred)), total, w=width)
    out += row.format("macro avg", precision.mean(), recall.mean(), f1.mean(),
                      total, w=width)
    # np.average as scikit-learn takes it: sum(x * w) / sum(w), which
    # decides how a value on a rounding boundary prints
    out += row.format("weighted avg", *(np.average(x, weights=support)
                                        for x in (precision, recall, f1)),
                      total, w=width)
    return out


def classification_metrics(
    logits: np.ndarray,
    y: np.ndarray,
    n_classes: int,
    *,
    prob_mode: str = "softmax",       # 'softmax' (test) | 'sigmoid' (train/val)
) -> Dict[str, float]:
    """AUROC/AUPRC/accuracy (+ macro P/R/F1 when multiclass)."""
    y = np.asarray(y).reshape(-1)
    logits = np.asarray(logits)
    ypred = np.argmax(logits, axis=1)
    probs = (softmax_probs(logits) if prob_mode == "softmax"
             else binary_probs_sigmoid(logits))
    out = {"accuracy": float(np.mean(y == ypred))}
    if n_classes == 2:
        out["auroc"] = binary_auroc(y, probs[:, 1])
        out["auprc"] = binary_average_precision(y, probs[:, 1])
    else:
        oh = one_hot(y, n_classes)
        # only the classes present in y are scored: on a full eval split
        # that is the reference's one-hot macro score, on a tiny split it
        # avoids an undefined column
        present = np.where(oh.sum(axis=0) > 0)[0]
        out["auroc"] = _macro_over_columns(binary_auroc, oh[:, present],
                                           probs[:, present])
        out["auprc"] = _macro_over_columns(binary_average_precision,
                                           oh[:, present], probs[:, present])
        _, precision, recall, f1, _ = _per_label(y, ypred)
        out["precision"] = float(precision.mean())
        out["recall"] = float(recall.mean())
        out["f1"] = float(f1.mean())
    return out
