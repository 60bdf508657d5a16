from .codec_train import (
    CodecTrainState,
    codec_loss,
    init_codec_train,
    make_codec_train_step,
    speech_batches,
)
from .wm_train import WMTrainState, init_wm_train, make_wm_train_step, wm_loss

__all__ = [
    "CodecTrainState", "codec_loss", "init_codec_train",
    "make_codec_train_step", "speech_batches",
    "WMTrainState", "init_wm_train", "make_wm_train_step", "wm_loss",
]
