"""Classifier training and evaluation, whole epochs at a time (JAX
counterpart: train/cls_steps.py; reference train_cls.py:54-76: Adam at lr
1e-3, cross-entropy, 20 epochs at batch 32).

The class splits live on the model's device; an epoch permutes there,
runs its steps back to back and fetches its metric means to the host once,
at the end, as the denoiser epochs of `train/steps.py` do. A step is the
forward in train mode (BatchNorm on batch statistics), cross-entropy on the
float32 logits, backward and one Adam step; its accuracy comes from the
same forward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ecg_denoise_tpu_torch.metrics.cls import accuracy
from ecg_denoise_tpu_torch.train.state import TrainState

METRICS = ("loss", "acc")


def cls_step(state: TrainState, data: torch.Tensor, label: torch.Tensor):
    """One Adam step on a (B, C, L) batch with int labels; the batch's
    (loss, accuracy) as 0-d tensors on its device."""
    model, optimizer = state.model, state.optimizer
    model.train()
    logits = model(data)
    loss = F.cross_entropy(logits.float(), label)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.step()
    return loss.detach(), accuracy(logits.detach(), label)


def cls_epoch(state: TrainState, data: torch.Tensor, label: torch.Tensor,
              perm: torch.Tensor, batch_size: int) -> dict:
    """One epoch of `make_cls_epoch_fns`' train_epoch at a given
    permutation `perm` of the split: step i trains on the samples perm
    holds at batch i; the ragged tail (N % batch_size) is dropped. Returns
    the epoch's mean loss and accuracy, fetched to the host once (NaN with
    no full batch, as JAX's scan over no steps gives)."""
    n_batches = data.shape[0] // batch_size
    if n_batches == 0:
        return dict.fromkeys(METRICS, float("nan"))
    perm = perm[:n_batches * batch_size]
    db = data[perm].reshape(n_batches, batch_size, *data.shape[1:])
    lb = label.long()[perm].reshape(n_batches, batch_size)
    per_batch = torch.stack([torch.stack(cls_step(state, db[i], lb[i]))
                             for i in range(n_batches)])
    return dict(zip(METRICS, per_batch.mean(0).tolist()))  # the one host fetch


def make_cls_epoch_fns(model: torch.nn.Module, optimizer: torch.optim.Adam):
    """(train_epoch, eval_epoch) for a classifier `model` producing
    logits, and its `optimizer`.

    train_epoch(data, label, generator, batch_size=32) -> metrics
        data (N, C, L) and int labels (N,) on the model's device. Permutes
        the split there from `generator` (on the same device) and runs
        `cls_epoch` (which a test can call with another permutation).
    eval_epoch(data, label, batch_size=128) -> (metrics, logits)
        Every sample in eval mode (BatchNorm on its running statistics),
        the tail padded with zeros to a full batch as JAX pads it (in eval
        mode a padded row changes no other row); logits (N, num_classes)
        stay on the device, for precision and F1 over the whole split.
    metrics: {"loss", "acc"} as python floats.
    """
    state = TrainState(model, optimizer)

    def train_epoch(data, label, generator: torch.Generator, batch_size: int = 32) -> dict:
        perm = torch.randperm(data.shape[0], generator=generator, device=data.device)
        return cls_epoch(state, data, label, perm, batch_size)

    def eval_epoch(data, label, batch_size: int = 128):
        n = data.shape[0]
        n_batches = -(-n // batch_size)
        data_p = torch.cat([data, data.new_zeros(n_batches * batch_size - n,
                                                 *data.shape[1:])])
        model.eval()
        with torch.no_grad():
            logits = torch.cat([model(data_p[i * batch_size:(i + 1) * batch_size])
                                for i in range(n_batches)])[:n]
            label = label.long()
            means = torch.stack([F.cross_entropy(logits.float(), label),
                                accuracy(logits, label)])
        return dict(zip(METRICS, means.tolist())), logits  # the one host fetch

    return train_epoch, eval_epoch
