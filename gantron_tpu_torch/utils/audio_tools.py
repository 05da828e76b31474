"""Audio utilities (port of gantron_tpu/utils/audio_tools.py; reference
utils.py:34-44). ``mel_to_audio`` waits for a WaveGlow checkpoint loader."""

from gantron_tpu_torch.audio.mel import MelSpectrogram
from gantron_tpu_torch.config import HParams
from gantron_tpu_torch.data.wav import load_wav


def get_mel_from_audio(path, hp=None, device="cuda"):
    """Wav file -> synthesis-style log-mel (n_mel, T) numpy, featurized on
    ``device`` (the card unless ``device="cpu"`` is passed)."""
    hp = hp or HParams()
    mel_fn = MelSpectrogram(hp.filter_length, hp.hop_length, hp.win_length,
                            hp.n_mel_channels, hp.sampling_rate, hp.mel_fmin,
                            hp.mel_fmax, device=device)
    wav = load_wav(path, hp.sampling_rate)
    return mel_fn(wav[None])[0].cpu().numpy()
