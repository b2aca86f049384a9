"""Dense decoder-only transformer (forward and training loss)."""
