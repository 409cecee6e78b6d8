"""Measurement helpers and scripts for the port on the card (run from the root of a checkout)."""
