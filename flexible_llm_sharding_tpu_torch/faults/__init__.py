"""faults of the PyTorch/CUDA port."""
