"""Training: the train and eval steps, the epoch loop and checkpoints."""
