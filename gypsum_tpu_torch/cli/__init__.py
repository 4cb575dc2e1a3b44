"""Command-line interface: ``python -m gypsum_tpu_torch replay``."""
