"""Hand-written CUDA kernels (``repro_torch/csrc``), their plain PyTorch
versions, and the dispatch by tensor device."""
