"""One CPU thread for PyTorch in each test process: the suite runs in
several worker processes, and the tiny networks gain nothing from more."""

import torch

torch.set_num_threads(1)
