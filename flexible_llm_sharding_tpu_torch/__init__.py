"""PyTorch/CUDA port of the layer-streamed scorer (the dense Llama, Mistral,
Phi-3, Qwen2/3 and Gemma 1/2/3 families, one device).

The JAX package ``flexible_llm_sharding_tpu`` is the reference this package
is held against; nothing here imports it or JAX. See README.md, "PyTorch/CUDA
port".
"""
