"""Inner optimizers and the DIANA parameter update."""
