"""Training, evaluation and checkpoints."""
