"""Train and eval steps and whole-epoch functions (JAX counterpart:
train/steps.py; reference denoise_train.py:36-89).

The splits live on the card; an epoch permutes them there, runs its steps
back to back and fetches the epoch's metric means to the host once, at the
end. A step is: forward in train mode (BatchNorm on batch statistics, its
running stats updated with the unbiased variance, as the JAX layer does),
mean MSE on the float32 prediction, backward, Adam update, and the batch's
mean SNR and RMSE from the same forward. A model gets `r_pos` only when
there is one (`models.apply`), so the families without R-wave attention train
through the same steps. With `detect_r_pos` every input
batch's R peaks are detected on its device (`data.rpeaks`) and fed to the
model's R-wave attention bias, as the JAX package's
`make_epoch_fns(detect_r_pos=True)` does.

With a `mesh` (`parallel.make_mesh`) the epochs are data parallel, as
JAX's epochs are on a batch-sharded array: `batch_size` stays the global
batch; each data index runs its share of every batch with the BatchNorm
statistics of the global batch (`ops.layers.global_batch_stats` over the
data group), averages the gradients over the data group after each
backward, and the returned metrics are the global batch's. Under tensor
parallelism (a mesh with n_model > 1, the state sharded by
`parallel.shard_state_dp_tp`) the model ranks of one data index take the
same rows and each runs its shard of the model.

`make_augmented_epoch_fn` trains on clean windows alone: each step mixes
its batch with a fresh slice of a long noise record on the card
(`data.noise.snr_noise_add_at`) and takes the same `train_step`.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from ecg_denoise_tpu_torch.data.noise import snr_noise_add_at
from ecg_denoise_tpu_torch.data.rpeaks import detect_r_peaks
from ecg_denoise_tpu_torch.metrics import RMSE, SNR
from ecg_denoise_tpu_torch.models import apply
from ecg_denoise_tpu_torch.ops.layers import global_batch_stats
from ecg_denoise_tpu_torch.parallel.mesh import all_reduce_gradients, all_reduce_sum
from ecg_denoise_tpu_torch.train.state import TrainState


def train_step(state: TrainState, noisy: torch.Tensor, clean: torch.Tensor,
               r_pos: Optional[torch.Tensor] = None, mesh=None):
    """One Adam step on a (B, C, L) batch, with the model's `r_pos` if
    given; returns the batch's (loss, mean SNR, mean RMSE) as 0-d tensors
    on the batch's device. With a `mesh` the batch is this data index's
    share of a global batch: the gradients are averaged over the data group
    before Adam steps (`all_reduce_gradients`; the BatchNorm statistics are
    global under `global_batch_stats`), and the returned values are this
    share's."""
    model, optimizer = state.model, state.optimizer
    model.train()
    pred = apply(model, noisy, r_pos).float()
    loss = torch.mean((pred - clean) ** 2)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    if mesh is not None:
        all_reduce_gradients(model, mesh)
    optimizer.step()
    pred = pred.detach()
    return loss.detach(), SNR(clean, pred).mean(), RMSE(clean, pred).mean()


def _local_rows(batch_size: int, mesh) -> int:
    """The rows of a global batch of `batch_size` that one data index takes."""
    if mesh is None:
        return batch_size
    if batch_size % mesh.n_data:
        raise ValueError(f"a batch of {batch_size} does not split over "
                         f"{mesh.n_data} ranks")
    return batch_size // mesh.n_data


def make_epoch_fns(model: torch.nn.Module, optimizer: torch.optim.Adam,
                   detect_r_pos: bool = False, mesh=None, local_data: bool = False):
    """(train_epoch, eval_epoch) for `model` and `optimizer`; with
    `detect_r_pos`, each batch's detected R peaks go to the model.

    train_epoch(noisy, clean, generator, batch_size=32) -> metrics
        noisy/clean: (N, C, L) on the model's device. Permutes the split
        there from `generator` (on the same device), drops the ragged tail
        (N % batch_size) like a drop_last loader, and steps through it.
        With N < batch_size it takes no step and returns NaN metrics.
    eval_epoch(noisy, clean, batch_size=32) -> metrics
        Every sample, the tail padded to a full batch with weight 0 (inputs
        of zeros, targets of ones, so a padded row's SNR stays finite).
    metrics: {"loss", "snr", "rmse"} as python floats — epoch means of the
    per-batch values in training, of the per-sample values in eval.

    With a `mesh`, every rank calls both with the same arguments: the
    global splits and a generator seeded alike, so every rank draws the
    same permutation, and each global batch of `batch_size` rows (which
    n_data must divide) splits into the data indices' `shard_batch` rows;
    the eval's padded batches split the same way. With `local_data` each
    rank passes only its data index's windows instead
    (`multihost.process_shard`, the same count on every rank): it permutes
    them alone and takes batch_size / n_data of them a step, so a global
    batch is the data indices' local batches together. Either way the
    metrics are reduced over the data group to the global batch's, the
    same on every rank.
    """
    state = TrainState(model, optimizer)
    world, rank = (mesh.n_data, mesh.data_rank) if mesh is not None else (1, 0)
    group = mesh.data_group if mesh is not None else None

    def r_pos_of(x):
        return detect_r_peaks(x) if detect_r_pos else None

    def train_epoch(noisy, clean, generator: torch.Generator,
                    batch_size: int = 32) -> dict:
        rows = _local_rows(batch_size, mesh)
        span = rows if local_data else batch_size  # rows of the split a step takes
        n_batches = noisy.shape[0] // span
        if n_batches == 0:
            # A split shorter than one batch: no step, the state untouched,
            # and NaN means, as JAX's scan over no steps gives.
            return dict.fromkeys(("loss", "snr", "rmse"), float("nan"))
        perm = torch.randperm(noisy.shape[0], generator=generator,
                              device=noisy.device)[:n_batches * span]
        if local_data:
            perm = perm.reshape(n_batches, rows)
        else:
            # This rank's rows of each global batch (`shard_batch`'s).
            perm = perm.reshape(n_batches, world, rows)[:, rank]
        nb, cb = noisy[perm], clean[perm]
        with (global_batch_stats(model, group) if mesh is not None
              else contextlib.nullcontext()):
            per_batch = torch.stack([
                torch.stack(train_step(state, nb[i], cb[i], r_pos_of(nb[i]), mesh))
                for i in range(n_batches)])
        means = per_batch.mean(0)
        if mesh is not None:
            means = all_reduce_sum(means, group) / world
        loss, snr, rmse = means.tolist()  # the one host fetch
        return {"loss": loss, "snr": snr, "rmse": rmse}

    def eval_epoch(noisy, clean, batch_size: int = 32) -> dict:
        rows = _local_rows(batch_size, mesh)
        span = rows if local_data else batch_size  # rows of the split a batch takes
        first = 0 if local_data else rank * rows  # this rank's first row of each
        n = noisy.shape[0]
        n_batches = -(-n // span)
        pad = n_batches * span - n
        noisy_p = torch.cat([noisy, noisy.new_zeros(pad, *noisy.shape[1:])])
        clean_p = torch.cat([clean, clean.new_ones(pad, *clean.shape[1:])])
        weights = torch.cat([noisy.new_ones(n), noisy.new_zeros(pad)])
        sums = torch.zeros(4, device=noisy.device)
        model.eval()
        with torch.no_grad():
            for i in range(n_batches):
                batch = slice(i * span + first, i * span + first + rows)
                x, target, w = noisy_p[batch], clean_p[batch], weights[batch]
                pred = apply(model, x, r_pos_of(x)).float()
                sums += torch.stack([
                    torch.sum(w[:, None, None] * (pred - target) ** 2),
                    torch.sum(SNR(target, pred) * w),
                    torch.sum(RMSE(target, pred) * w),
                    torch.sum(w)])
        if mesh is not None:
            sums = all_reduce_sum(sums, group)
        loss, snr, rmse, count = sums.tolist()  # the one host fetch
        per_elem = noisy.shape[1] * noisy.shape[2]
        return {"loss": loss / (count * per_elem), "snr": snr / count,
                "rmse": rmse / count}

    return train_epoch, eval_epoch


def augmented_epoch(state: TrainState, clean: torch.Tensor, noise_record: torch.Tensor,
                    snr_db, perm: torch.Tensor, starts: torch.Tensor) -> dict:
    """One epoch of `make_augmented_epoch_fn` at a given permutation and
    noise offsets: step i trains on the windows `clean[perm]` holds at
    batch i, each mixed at `snr_db` with the slice of `noise_record` that
    starts at its entry of `starts` (n_batches, batch_size). Returns the
    epoch's mean metrics, fetched to the host once."""
    n_batches, batch_size = starts.shape
    if n_batches == 0:
        return dict.fromkeys(("loss", "snr", "rmse"), float("nan"))
    cb = clean[perm].reshape(n_batches, batch_size, *clean.shape[1:])
    per_batch = torch.stack([
        torch.stack(train_step(state, snr_noise_add_at(cb[i], noise_record, snr_db,
                                                       starts[i]), cb[i]))
        for i in range(n_batches)])
    loss, snr, rmse = per_batch.mean(0).tolist()  # the one host fetch
    return {"loss": loss, "snr": snr, "rmse": rmse}


def make_augmented_epoch_fn(model: torch.nn.Module, optimizer: torch.optim.Adam,
                            noise_record, snr_db: float):
    """train_epoch(clean, generator, batch_size=32) -> metrics, an epoch
    that mixes its noise on the card (JAX counterpart:
    `make_augmented_epoch_fn`; no reference counterpart: the reference
    trains on a fixed pre-mixed cache).

    `noise_record` (N, C) goes to the model's device as float32 once.
    Each epoch permutes `clean` (N, C, L, on that device) from `generator`
    (on the same device), drops the ragged tail like `make_epoch_fns`'
    train_epoch, draws every step's noise offsets from the same generator
    in [0, N - L - 1), and runs `augmented_epoch`: every window gets a
    fresh noise slice each epoch.
    """
    state = TrainState(model, optimizer)
    device = next(model.parameters()).device
    noise_record = torch.as_tensor(noise_record, dtype=torch.float32, device=device)

    def train_epoch(clean, generator: torch.Generator, batch_size: int = 32) -> dict:
        n_batches = clean.shape[0] // batch_size
        perm = torch.randperm(clean.shape[0], generator=generator,
                              device=clean.device)[:n_batches * batch_size]
        starts = torch.randint(0, noise_record.shape[0] - clean.shape[-1] - 1,
                               (n_batches, batch_size), generator=generator,
                               device=clean.device)
        return augmented_epoch(state, clean, noise_record, snr_db, perm, starts)

    return train_epoch
