"""Progressive growing: weight transfer between stages."""
