"""Command-line entry points (``python -m mocha_sigasia2023_torch.cli.X``)."""
