"""Synthetic datasets and event streams (numpy) for the PyTorch port."""
