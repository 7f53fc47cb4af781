"""Evaluation metrics: exact + streaming AUC, accuracy/precision/recall/F1/AP
(the port of dlrm_tpu/ops/metrics.py).

Replaces the reference's sklearn metric suite (dlrm_s_pytorch.py:830-855) and
torchmetrics AUROC (torchrec_dlrm/dlrm_main.py:337-366) with implementations
that are (a) exact on small sets and (b) streaming/reducible at scale: a
fixed-bucket score histogram whose partials combine by addition, turning the
89M-sample Criteo eval into O(num_buckets) state (SURVEY.md §7 "AUC at
scale"). The numpy functions are copies of the JAX package's;
auc_update_torch is its on-device histogram update on torch tensors.

Not ported: shards_scores_labels, which reads a jax.Array's per-device
shards, and the cross-process sum in allreduce_auc_state; both wait for the
multi-device path (ROADMAP queue A item 11).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from dlrm_tpu_torch.device import process_count


# --------------------------------------------------------------------- exact


def _auc_from_sorted_asc(s_sorted: np.ndarray, pos_sorted: np.ndarray) -> float:
    """Mann-Whitney U AUC from score-ascending-sorted inputs (midrank ties)."""
    n = s_sorted.size
    n_pos = int(pos_sorted.sum())
    n_neg = n - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    # vectorized midranks: group equal scores, rank = mean of the group's
    # 1-based positions (a python per-sample loop here stalled eval on the
    # 89M-row Criteo test set for minutes)
    is_start = np.empty(n, dtype=bool)
    is_start[0] = True
    np.not_equal(s_sorted[1:], s_sorted[:-1], out=is_start[1:])
    group = np.cumsum(is_start) - 1  # [n] group id per sorted position
    starts = np.flatnonzero(is_start)
    ends = np.concatenate([starts[1:], [n]])
    mid = 0.5 * (starts + ends - 1) + 1.0  # midrank per group
    rank_sum_pos = mid[group][pos_sorted].sum()
    u = rank_sum_pos - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def roc_auc_exact(scores: np.ndarray, labels: np.ndarray) -> float:
    """Exact ROC-AUC via the rank-sum (Mann-Whitney U) formulation with
    midrank tie handling — equal to sklearn.metrics.roc_auc_score."""
    scores = np.asarray(scores, dtype=np.float64).ravel()
    labels = np.asarray(labels, dtype=np.float64).ravel()
    order = np.argsort(scores, kind="mergesort")
    return _auc_from_sorted_asc(scores[order], labels[order] > 0.5)


def binary_metrics(
    scores: np.ndarray, labels: np.ndarray, threshold: float = 0.5
) -> Dict[str, float]:
    """recall/precision/f1/accuracy at a threshold + average precision,
    mirroring the mlperf eval block (dlrm_s_pytorch.py:830-855)."""
    scores = np.asarray(scores, dtype=np.float64).ravel()
    labels = (np.asarray(labels, dtype=np.float64).ravel() > 0.5).astype(np.int64)
    pred = (scores >= threshold).astype(np.int64)
    tp = int(((pred == 1) & (labels == 1)).sum())
    fp = int(((pred == 1) & (labels == 0)).sum())
    fn = int(((pred == 0) & (labels == 1)).sum())
    tn = int(((pred == 0) & (labels == 0)).sum())
    precision = tp / (tp + fp) if tp + fp else 0.0
    recall = tp / (tp + fn) if tp + fn else 0.0
    f1 = 2 * precision * recall / (precision + recall) if precision + recall else 0.0
    accuracy = (tp + tn) / max(1, labels.size)
    # ONE shared descending sort serves both AP (directly) and exact AUC
    # (reversed) — the sort dominates the 89M-row Criteo eval, so paying it
    # twice doubled the cost of the full metric dict
    order = np.argsort(-scores, kind="mergesort")
    s_desc = scores[order]
    l_desc = labels[order]
    return {
        "recall": recall,
        "precision": precision,
        "f1": f1,
        "accuracy": accuracy,
        "ap": _ap_from_sorted_desc(s_desc, l_desc.astype(np.float64)),
        "roc_auc": _auc_from_sorted_asc(s_desc[::-1], l_desc[::-1] == 1),
    }


def _ap_from_sorted_desc(s_desc: np.ndarray, labels_desc: np.ndarray) -> float:
    """Average precision from score-descending-sorted inputs."""
    if labels_desc.sum() == 0:
        return float("nan")
    tp_cum = np.cumsum(labels_desc)
    # group by distinct score (sklearn evaluates at threshold boundaries)
    distinct = np.where(np.diff(s_desc))[0]
    idx = np.concatenate([distinct, [labels_desc.size - 1]])
    tp = tp_cum[idx]
    total = idx + 1.0
    precision = tp / total
    recall = tp / labels_desc.sum()
    recall_prev = np.concatenate([[0.0], recall[:-1]])
    return float(np.sum((recall - recall_prev) * precision))


def average_precision(scores: np.ndarray, labels: np.ndarray) -> float:
    """sklearn-style average precision (step-wise integral of the PR curve)."""
    scores = np.asarray(scores, dtype=np.float64).ravel()
    labels = (np.asarray(labels, dtype=np.float64).ravel() > 0.5).astype(np.float64)
    order = np.argsort(-scores, kind="mergesort")
    return _ap_from_sorted_desc(scores[order], labels[order])


# ------------------------------------------------------------------ streaming


@dataclass
class AucState:
    """Additive streaming state: per-bucket positive/negative counts.

    Combine across devices/processes/batches by summing the arrays.
    """

    pos: np.ndarray  # [num_buckets] float64
    neg: np.ndarray

    @classmethod
    def create(cls, num_buckets: int = 1 << 14) -> "AucState":
        return cls(
            pos=np.zeros(num_buckets, np.float64),
            neg=np.zeros(num_buckets, np.float64),
        )

    def merge(self, other: "AucState") -> "AucState":
        return AucState(pos=self.pos + other.pos, neg=self.neg + other.neg)


def auc_update(
    state: AucState, scores: np.ndarray, labels: np.ndarray,
    weights: np.ndarray | None = None,
) -> AucState:
    nb = state.pos.shape[0]
    scores = np.clip(np.asarray(scores, np.float64).ravel(), 0.0, 1.0)
    labels = np.asarray(labels, np.float64).ravel()
    if weights is None:
        weights = np.ones_like(labels)
    else:
        weights = np.asarray(weights, np.float64).ravel()
    mask = labels >= 0  # padded eval rows carry label -1
    b = np.minimum((scores * nb).astype(np.int64), nb - 1)
    pos = np.bincount(
        b[mask], weights=(weights * (labels > 0.5))[mask], minlength=nb
    )
    neg = np.bincount(
        b[mask], weights=(weights * (labels <= 0.5))[mask], minlength=nb
    )
    return AucState(pos=state.pos + pos, neg=state.neg + neg)


def auc_compute(state: AucState) -> float:
    """Trapezoidal AUC over the bucketed ROC curve (within-bucket ties get the
    midrank treatment, so the estimate is unbiased for tied buckets)."""
    p, n = state.pos, state.neg
    tp_total, fn_total = p.sum(), n.sum()
    if tp_total == 0 or fn_total == 0:
        return float("nan")
    # descending score order
    p_desc, n_desc = p[::-1], n[::-1]
    tp_cum = np.cumsum(p_desc)
    fp_cum = np.cumsum(n_desc)
    tpr = np.concatenate([[0.0], tp_cum / tp_total])
    fpr = np.concatenate([[0.0], fp_cum / fn_total])
    return float(np.trapezoid(tpr, fpr))


def allreduce_auc_state(state: AucState) -> AucState:
    """Sum the histogram across processes (torchmetrics AUROC's sync role,
    torchrec_dlrm/dlrm_main.py:337-366). Returns the state as it is in a
    single process; the multi-process sum waits for the port of the
    multi-device path."""
    if process_count() > 1:
        raise NotImplementedError(
            "summing the AUC histogram across processes is not ported yet "
            "(ROADMAP queue A item 11)"
        )
    return state


def binary_metrics_from_hist(
    state: AucState, threshold: float = 0.5
) -> Dict[str, float]:
    """The binary_metrics dict computed from the additive score histogram
    alone — every metric is derivable from per-bucket (pos, neg) counts, so
    the full MLPerf eval block works distributed without ever concatenating
    scores on one host. Resolution is the bucket width (1/num_buckets);
    tests bound the divergence from the exact-sort metrics at 2e-3."""
    p, n = state.pos, state.neg
    nb = p.shape[0]
    n_pos, n_neg = p.sum(), n.sum()
    # bucket b covers scores [b/nb, (b+1)/nb): scores >= threshold live in
    # buckets >= ceil(threshold*nb) up to bucket-width resolution
    kth = int(np.ceil(threshold * nb))
    tp = float(p[kth:].sum())
    fp = float(n[kth:].sum())
    fn = float(p[:kth].sum())
    tn = float(n[:kth].sum())
    precision = tp / (tp + fp) if tp + fp else 0.0
    recall = tp / (tp + fn) if tp + fn else 0.0
    f1 = (
        2 * precision * recall / (precision + recall)
        if precision + recall
        else 0.0
    )
    accuracy = (tp + tn) / max(1.0, n_pos + n_neg)
    # AP over the bucketed PR curve (threshold sweep at bucket boundaries)
    if n_pos == 0:
        ap = float("nan")
    else:
        p_desc, n_desc = p[::-1], n[::-1]
        occupied = (p_desc + n_desc) > 0
        tp_cum = np.cumsum(p_desc)[occupied]
        all_cum = np.cumsum(p_desc + n_desc)[occupied]
        prec = tp_cum / all_cum
        rec = tp_cum / n_pos
        rec_prev = np.concatenate([[0.0], rec[:-1]])
        ap = float(np.sum((rec - rec_prev) * prec))
    return {
        "recall": recall,
        "precision": precision,
        "f1": f1,
        "accuracy": accuracy,
        "ap": ap,
        "roc_auc": auc_compute(state),
    }


def auc_update_torch(pos: torch.Tensor, neg: torch.Tensor,
                     scores: torch.Tensor, labels: torch.Tensor):
    """The histogram update on device tensors (the port of auc_update_jax):
    returns new (pos, neg). Rows with a label < 0 (padding) add nothing.
    Counts are exact in pos/neg's dtype (to 2^24 per bucket in float32).
    Buckets are taken in float64, as auc_update takes them; with a
    power-of-two bucket count (the default) that is also auc_update_jax's
    float32 bucket."""
    nb = pos.shape[0]
    s = torch.clamp(scores.reshape(-1).double(), 0.0, 1.0)
    lbl = labels.reshape(-1)
    mask = lbl >= 0
    b = torch.clamp((s * nb).to(torch.int64), max=nb - 1)
    is_pos = ((lbl > 0.5) & mask).to(pos.dtype)
    is_neg = ((lbl <= 0.5) & mask).to(neg.dtype)
    return pos.index_add(0, b, is_pos), neg.index_add(0, b, is_neg)
