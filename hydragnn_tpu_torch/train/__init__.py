"""Training: the optimizer, the train/eval steps and the epoch loop."""
