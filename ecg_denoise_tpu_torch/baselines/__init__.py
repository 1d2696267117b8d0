from ecg_denoise_tpu_torch.baselines.dwt import (
    daubechies_filters,
    dwt_max_level,
    wavedec,
    wavelet_denoise,
    waverec,
)
from ecg_denoise_tpu_torch.baselines.fft import fft_denoise

__all__ = ["wavelet_denoise", "wavedec", "waverec", "daubechies_filters",
           "dwt_max_level", "fft_denoise"]
