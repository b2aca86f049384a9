"""Synthetic LM token streams."""
