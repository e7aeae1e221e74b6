"""Entry point: ``python -m flexible_llm_sharding_tpu_torch`` runs the batch
CLI, or one of its subcommands (``serve``, ``verify``, ``plan-precision``,
``prepare-adapter``, ``incidents``, ``trace-report``, ``check``)."""

from flexible_llm_sharding_tpu_torch.cli import main

if __name__ == "__main__":
    main()
