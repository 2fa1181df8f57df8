"""Segmentation metrics of the train and eval steps."""
