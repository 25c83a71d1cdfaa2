"""petr_tpu_torch — the PyTorch/CUDA port of petr_tpu for NVIDIA Hopper.

A second package beside `petr_tpu/`, which stays the reference. It imports
no JAX and nothing of `petr_tpu`; its CUDA kernels live in `csrc/` and are
built with nvcc on first use (see `ops/build.py`), never on import.
"""
