"""Host-side helpers: YAML config, text/speech featurizers, device choice."""
