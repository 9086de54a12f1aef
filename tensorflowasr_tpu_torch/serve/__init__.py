"""Serving: the ASR, VAD and punctuation engines, the offline, live and
chunk-streaming sessions, the slot pool and the socket model server."""
