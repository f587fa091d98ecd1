"""Training of the port: losses, the train step and the Trainer."""
