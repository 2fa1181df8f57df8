"""PGUNet stages, their blocks and BatchNorm folding (PyTorch)."""
