from ecg_denoise_tpu_torch.data.dataset import EcgDataset, load_split_arrays
from ecg_denoise_tpu_torch.data.noise import (
    batch_snr_noise_add,
    gnoisegen,
    single_snr_noise_add,
    snr_noise_add,
    snr_noise_add_at,
)
from ecg_denoise_tpu_torch.data.normalize import minmax_norm, znorm
from ecg_denoise_tpu_torch.data.rpeaks import detect_r_peaks
from ecg_denoise_tpu_torch.data.synth import (
    synth_beat_windows,
    synth_ecg_record,
    synth_noise_record,
)

# Reference-API aliases (reference class/function names).
Ecg_Dataset = EcgDataset  # local_utils/data_utils.py:88
Gnoisegen = gnoisegen  # local_utils/local_utils.py:86
np_norm = znorm  # local_utils/local_utils.py:261

__all__ = [
    "gnoisegen",
    "single_snr_noise_add",
    "batch_snr_noise_add",
    "snr_noise_add",
    "snr_noise_add_at",
    "EcgDataset",
    "Ecg_Dataset",
    "Gnoisegen",
    "np_norm",
    "load_split_arrays",
    "synth_ecg_record",
    "synth_noise_record",
    "synth_beat_windows",
    "znorm",
    "minmax_norm",
    "detect_r_peaks",
]
