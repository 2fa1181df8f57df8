"""Trainer utilities: divergence detection and the training CSV log."""
