"""Bit budgets and the launch/request contracts the port dispatches on."""
