"""Entry point: ``python -m flexible_llm_sharding_tpu_torch`` runs the batch
CLI, or its ``serve``, ``verify`` or ``plan-precision`` subcommand."""

from flexible_llm_sharding_tpu_torch.cli import main

if __name__ == "__main__":
    main()
