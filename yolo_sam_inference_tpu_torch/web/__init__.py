"""The micro-batching HTTP inference service (``serve.py``)."""
