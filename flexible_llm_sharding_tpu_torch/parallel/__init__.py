"""parallel of the PyTorch/CUDA port."""
