"""The pieces of the JAX package's ``registry/`` that the project runner
uses: MLflow tracking, import-gated (``tracking.py``)."""
