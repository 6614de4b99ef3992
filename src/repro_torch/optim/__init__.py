"""Local optimizers of the port."""
