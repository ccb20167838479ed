"""Training: config, LR schedule, optimizer, the ASLM trainer, its
checkpoint files, generation and evaluation metrics."""
