"""Core datatypes and update math of the PyTorch port."""
