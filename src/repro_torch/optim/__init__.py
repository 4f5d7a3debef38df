"""Functional optimizers over parameter lists (``repro.optim``'s), the LM
step's in-place AdamW, and gradient compression."""
