"""The benchmark's CPU tests: a few intra-op threads per process, so that
several test workers share the host's cores without stalling each other."""

import torch

torch.set_num_threads(2)
