"""Intra-frame parallelism of the port: band and tile slicing (``bands.py``)."""
