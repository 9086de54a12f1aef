"""Artifacts for the standalone C++ engines of ``cpp/serving``."""
