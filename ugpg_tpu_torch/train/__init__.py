"""Training: the segmentation train and eval steps, the optimizer and the
uncertainty-guided progressive trainer."""
