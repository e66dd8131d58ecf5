"""Training: losses, solver, the train step."""
