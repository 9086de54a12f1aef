"""Recipes, the port's counterpart of ``examples/``: a synthetic Mandarin
corpus (``synthetic_mandarin``), AISHELL-1 preparation
(``aishell1_prepare``) and the head-to-head training run (``headtohead``),
each run with ``python -m tensorflowasr_tpu_torch.recipes.<name>``."""
