"""Parallelism of the port: band and tile slicing (``bands.py``) and
multi-session serving (``sessions.py``, ``serving.py``)."""
