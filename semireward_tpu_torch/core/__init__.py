"""Training-step building blocks of the port: losses, optimizer, state, step, trainer."""
