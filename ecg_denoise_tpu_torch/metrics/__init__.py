from ecg_denoise_tpu_torch.metrics.cls import accuracy, f1_score, precision
from ecg_denoise_tpu_torch.metrics.denoise import (
    PRD,
    RMSE,
    SNR,
    second_order_difference_loss,
    snr_improvement,
)

__all__ = ["RMSE", "SNR", "snr_improvement", "PRD",
           "second_order_difference_loss", "accuracy", "precision", "f1_score"]
