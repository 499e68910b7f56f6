"""Training: the optimizer and schedule, the train state, and the train
and eval steps."""
