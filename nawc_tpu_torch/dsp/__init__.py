from .resample import resample, resample_length
from .mel import hz_to_mel, mel_matrix, mel_spectrogram, mel_to_hz
from .stft import frame, hann, istft, num_frames, overlap_add, spectrogram, stft

__all__ = [
    "stft", "istft", "frame", "overlap_add", "hann", "num_frames", "spectrogram",
    "hz_to_mel", "mel_to_hz", "mel_matrix", "mel_spectrogram",
    "resample", "resample_length",
]
