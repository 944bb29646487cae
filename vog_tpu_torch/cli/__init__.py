"""Command-line entry points: ``python -m vog_tpu_torch.cli.train``,
``cli.eval``, ``cli.serve`` and ``cli.export``."""
