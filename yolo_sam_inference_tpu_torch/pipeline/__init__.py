"""The batch pipeline: detect -> embed -> segment -> metrics."""
