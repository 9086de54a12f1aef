"""Serving: the greedy ASR engine and the offline session."""
