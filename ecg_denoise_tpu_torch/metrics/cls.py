"""Beat-classifier metrics, N against V (JAX counterpart: metrics/cls.py;
reference test_cls.py:14-30).

The predictions are (N, 2) logits and the labels ints in {0, 1}; class 1
(V) is the positive class of `precision` and `f1_score`. Each returns a
float32 0-d tensor on the inputs' device. As in the JAX package, the
counts are integers and the quotient is taken in float32, so `precision`
is 0/0 = NaN when nothing is predicted positive; `accuracy` rounds as
`jnp.mean` does, so all three equal JAX's bit for bit.
"""

from __future__ import annotations

import torch


def _counts(pred_logits: torch.Tensor, label: torch.Tensor):
    """(true positives, false positives, false negatives) as integers."""
    pred = torch.argmax(pred_logits, dim=1)
    label = label.to(pred.dtype)
    return (torch.sum(pred * label), torch.sum(pred * (1 - label)),
            torch.sum((1 - pred) * label))


def accuracy(pred_logits: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    hits = (torch.argmax(pred_logits, dim=1) == label).to(torch.float32)
    # jnp.mean's rounding: the sum times the float32 reciprocal of the count.
    return torch.sum(hits) * (1.0 / hits.numel())


def precision(pred_logits: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    tp, fp, _ = _counts(pred_logits, label)
    return tp.to(torch.float32) / (tp + fp).to(torch.float32)


def f1_score(pred_logits: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    tp, fp, fn = _counts(pred_logits, label)
    tp = tp.to(torch.float32)
    return tp / (tp + 0.5 * (fp + fn).to(torch.float32))
