"""Training: losses, optimizer, train state, trainer and checkpoints."""
