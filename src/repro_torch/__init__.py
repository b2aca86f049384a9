"""PyTorch/CUDA port of the DIANA system (``repro``): the same modules, run
with PyTorch, with hand-written CUDA kernels for NVIDIA Hopper (sm_90a)."""
