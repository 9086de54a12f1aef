"""Command-line entry points
(``python -m tensorflowasr_tpu_torch.cli.test_asr``)."""
