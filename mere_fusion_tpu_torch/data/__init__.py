"""Datasets of the PyTorch port (the ER-NeRF test set)."""
