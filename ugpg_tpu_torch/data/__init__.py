"""Data: the synthetic disk task and an in-memory batch loader."""
