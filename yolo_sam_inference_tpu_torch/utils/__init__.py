"""Logging, TIFF output helpers and the summary reporter, copied from the JAX
package's ``utils/`` (which the port may not import)."""
