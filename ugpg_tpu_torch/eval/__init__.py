"""Serving: bucketed Predictor and the micro-batching front end."""
