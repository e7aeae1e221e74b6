"""PyTorch/CUDA port of the layer-streamed scorer (dense Llama, one device).

The JAX package ``flexible_llm_sharding_tpu`` is the reference this package
is held against; nothing here imports it or JAX. See README.md, "PyTorch/CUDA
port".
"""
