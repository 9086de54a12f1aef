"""Host-side helpers: YAML config, text/speech featurizers, device choice.

Re-exports the names ``tensorflowasr_tpu.utils`` exports."""

from tensorflowasr_tpu_torch.utils.audio import (
    SpeechFeaturizer,
    read_wav,
    write_wav,
)
from tensorflowasr_tpu_torch.utils.config import UserConfig, load_yaml
from tensorflowasr_tpu_torch.utils.metrics import (
    ErrorRateAccumulator,
    cer,
    levenshtein,
    wer,
)
from tensorflowasr_tpu_torch.utils.text import TextFeaturizer

__all__ = [
    "UserConfig",
    "load_yaml",
    "TextFeaturizer",
    "SpeechFeaturizer",
    "read_wav",
    "write_wav",
    "levenshtein",
    "wer",
    "cer",
    "ErrorRateAccumulator",
]
