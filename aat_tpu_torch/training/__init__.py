"""Training: config, LR schedule, optimizer and the ASLM trainer."""
