"""Entry point: ``python -m flexible_llm_sharding_tpu_torch`` runs the batch CLI."""

from flexible_llm_sharding_tpu_torch.cli import main

if __name__ == "__main__":
    main()
