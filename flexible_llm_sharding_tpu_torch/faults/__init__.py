"""faults of the PyTorch/CUDA port: ``retry`` (the retry policy of layer
reads and its typed ``ShardLoadError``) and ``inject`` (the seeded fault
injector, which the replica fleet fires at its two sites)."""
