"""integrity of the PyTorch/CUDA port."""
