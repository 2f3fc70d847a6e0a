"""Drivers of the PyTorch port (the serving trickle demo)."""
