"""Frontend (log-mel with the K1 power-spectrogram kernel) and greedy CTC
decoding."""
