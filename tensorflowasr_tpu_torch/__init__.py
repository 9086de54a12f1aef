"""tensorflowasr_tpu_torch — the PyTorch/CUDA port of ``tensorflowasr_tpu``.

Mirrors the JAX package's layout so each counterpart is easy to find:

- ``ops``      : log-mel frontend (its power spectrogram runs a hand-written
                 Hopper kernel on CUDA tensors), greedy CTC decoding.
- ``kernels``  : nvcc build + ctypes loading of the CUDA sources in ``csrc``.
- ``models``   : offline Conformer-CTC and the flax -> torch weight bridge.
- ``serve``    : the greedy ASR engine and the offline session.
- ``cli``      : ``test_asr`` single-wav decode.
- ``utils``    : YAML config, text and speech featurizers, device choice.

Entry points run on ``cuda`` unless the caller asks for ``cpu``; a CUDA
request on a host without CUDA raises instead of falling back.
"""

__version__ = "0.1.0"
