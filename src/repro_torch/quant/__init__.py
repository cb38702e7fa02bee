"""Design-time plans and float -> integer conversion (dense subset)."""
