"""Command-line entry points (``python -m himo_tpu_torch.cli.<name> key=value ...``)."""
