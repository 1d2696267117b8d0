from ecg_denoise_tpu_torch.train.checkpoint import (
    find_model,
    load_checkpoint,
    load_model_weights,
    save_checkpoint,
)
from ecg_denoise_tpu_torch.train.cls_steps import cls_epoch, cls_step, make_cls_epoch_fns
from ecg_denoise_tpu_torch.train.loop import fit
from ecg_denoise_tpu_torch.train.state import TrainState, create_train_state
from ecg_denoise_tpu_torch.train.steps import (
    augmented_epoch,
    make_augmented_epoch_fn,
    make_epoch_fns,
    train_step,
)

__all__ = ["TrainState", "create_train_state", "make_epoch_fns", "train_step",
           "make_augmented_epoch_fn", "augmented_epoch",
           "fit", "save_checkpoint", "load_checkpoint", "load_model_weights",
           "find_model", "make_cls_epoch_fns", "cls_epoch", "cls_step"]
