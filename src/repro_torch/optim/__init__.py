"""Functional optimizers over parameter lists (``repro.optim``'s)."""
