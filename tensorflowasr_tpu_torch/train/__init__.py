"""Training of the port: state, optimizer, checkpoints, trainers."""
