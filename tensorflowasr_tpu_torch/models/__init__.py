"""The Conformer-CTC, ChunkConformer, VAD and punctuation modules and the
flax <-> torch weight bridge."""
