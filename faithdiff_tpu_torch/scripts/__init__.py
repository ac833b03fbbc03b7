"""Command-line scripts of the port, run as ``python -m
faithdiff_tpu_torch.scripts.<name>``."""
