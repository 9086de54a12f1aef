"""tensorflowasr_tpu_torch — the PyTorch/CUDA port of ``tensorflowasr_tpu``.

Mirrors the JAX package's layout so each counterpart is easy to find:

- ``ops``      : log-mel frontend (its power spectrogram runs a hand-written
                 Hopper kernel on CUDA tensors), CTC loss and greedy CTC
                 decoding, SpecAugment.
- ``kernels``  : nvcc build + ctypes loading of the CUDA sources in ``csrc``.
- ``models``   : offline Conformer-CTC and the chunk-streaming
                 ChunkConformer (inference and training mode), the VAD and
                 punctuation models, and the weight bridge to and from flax
                 variables.
- ``train``    : ``CTCTrainer``, Adam with schedule / clipping / gradient
                 accumulation, full-state checkpoints, the fit loop.
- ``data``     : the bucketing acoustic-model and chunk dataloaders, the
                 punctuation dataloader, waveform augmenters and the
                 prefetcher (numpy / scipy).
- ``eval``     : ``AMTester`` (phone and char error rates).
- ``serve``    : the ASR, VAD and punctuation engines, the offline, live
                 and chunk-streaming sessions, the slot pool and the socket
                 model server.
- ``export``   : native artifacts of the ``cpp/serving`` engines.
- ``cli``      : ``train_asr``, ``eval_am``, ``test_asr``,
                 ``test_chunk_asr``, ``serve_model``, ``test_punc``.
- ``utils``    : YAML config, text and speech featurizers, error-rate
                 metrics, throughput meter, device choice.

Entry points run on ``cuda`` unless the caller asks for ``cpu``; a CUDA
request on a host without CUDA raises instead of falling back.
"""

__version__ = "0.1.0"
