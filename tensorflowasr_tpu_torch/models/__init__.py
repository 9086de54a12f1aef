"""Offline Conformer-CTC modules and the flax -> torch weight bridge."""
