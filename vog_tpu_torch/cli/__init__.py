"""Command-line entry points: ``python -m vog_tpu_torch.cli.train`` and
``python -m vog_tpu_torch.cli.eval``."""
