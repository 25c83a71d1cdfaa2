"""Command-line entry points of the port (``python -m petr_tpu_torch.cli.<name>``)."""
