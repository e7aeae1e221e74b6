"""faults of the PyTorch/CUDA port: ``retry`` (the retry policy of layer
reads and its typed ``ShardLoadError``) and ``inject`` (the seeded fault
injector, whose eleven sites the loader, the upload, the activation store,
the KV pool, the adapter store, the admission queue, the serving engine and
the replica fleet fire)."""
