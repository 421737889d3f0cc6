"""Host-side utilities of the port: audio I/O, training-state checkpoints
and the EM loop, evaluation metrics, structured metrics logging, text
constants. Profiling hooks (``torch.profiler``) are in
:mod:`lnasr_tpu_torch.utils.profiling`."""

from lnasr_tpu_torch.utils.audio import (
    Recorder, read_audio, read_pcm, read_wave, record, resample, write_pcm,
    write_wave,
)
from lnasr_tpu_torch.utils.checkpoints import (
    Checkpointer, TrainState, checkpointer_from_config, em_loop, load_train_state,
    save_train_state,
)
from lnasr_tpu_torch.utils.logging import MetricsLogger, Stopwatch
from lnasr_tpu_torch.utils.metrics import cer, edit_distance, wer, wer_details
from lnasr_tpu_torch.utils.text import PUNCTUATION_ASCII, PUNCTUATION_UNICODE

__all__ = [
    "Recorder",
    "record",
    "resample",
    "read_audio",
    "read_pcm",
    "write_pcm",
    "read_wave",
    "write_wave",
    "Checkpointer",
    "TrainState",
    "checkpointer_from_config",
    "em_loop",
    "load_train_state",
    "save_train_state",
    "MetricsLogger",
    "Stopwatch",
    "cer",
    "edit_distance",
    "wer",
    "wer_details",
    "PUNCTUATION_ASCII",
    "PUNCTUATION_UNICODE",
]
