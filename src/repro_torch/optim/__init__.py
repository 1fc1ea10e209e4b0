"""Functional optimizers."""
