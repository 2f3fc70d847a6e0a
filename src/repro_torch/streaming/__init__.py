"""Streaming engine and state store of the PyTorch port."""
