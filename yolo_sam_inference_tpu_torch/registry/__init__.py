"""Storage / registry layer of the port: work manifests with resume, DB
adapters, tracking.

Copies of the JAX package's ``registry/`` (which the port may not import):

* :mod:`manifest` — the work manifest on stdlib sqlite3 (same table
  templates, upsert ingestion, summary stats; its files read back through
  either package);
* :mod:`nodes` — ``process_pending``: the manifest's pending rows through a
  pipeline, one image a call, errors recorded per row;
* :mod:`postgres` — the Postgres adapter with the same interface (psycopg2,
  import-gated);
* :mod:`readout` — batch CSV concatenation without pandas (local + MinIO,
  import-gated);
* :mod:`tracking` — MLflow experiment tracking hooks (import-gated).
"""

from .manifest import TABLE_TEMPLATES, WorkManifest

__all__ = ["WorkManifest", "TABLE_TEMPLATES"]
