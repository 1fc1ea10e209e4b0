"""The triggered train step, its aggregation, and the linreg problem."""
