"""CPU tests of the benchmark: few threads per process, so that parallel
test workers do not oversubscribe the host's cores."""

import torch

torch.set_num_threads(2)
