"""Command-line entry points: ``python -m sparseharness_tpu_torch.cli <app> [flags]``
(``cli/main.py``)."""
