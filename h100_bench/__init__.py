"""The benchmark of the PyTorch/CUDA port (``petr_tpu_torch``) on one H100."""
