"""Command lines of the port: ``train_monuseg`` and ``test_monuseg``."""
