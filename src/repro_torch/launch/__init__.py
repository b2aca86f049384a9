"""Entry points: the one-card DIANA trainer."""
