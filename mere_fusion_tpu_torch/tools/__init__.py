"""Standalone command-line tools of the PyTorch port."""
