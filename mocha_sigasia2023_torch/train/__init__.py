"""Generator training: losses, the trainer and its checkpoints."""
