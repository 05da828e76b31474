from gantron_tpu_torch.audio.filters import (hann_window, mel_filterbank,
                                             window_sumsquare)
from gantron_tpu_torch.audio.mel import (MelSpectrogram,
                                         dynamic_range_compression,
                                         dynamic_range_decompression)
from gantron_tpu_torch.audio.stft import STFT, griffin_lim

__all__ = [
    "STFT", "MelSpectrogram", "griffin_lim", "hann_window", "mel_filterbank",
    "window_sumsquare", "dynamic_range_compression",
    "dynamic_range_decompression",
]
