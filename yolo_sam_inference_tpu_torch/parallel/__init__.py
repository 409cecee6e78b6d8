"""Multi-rank paths of the port over ``torch.distributed``: meshes of ranks
and data parallelism (:mod:`.mesh`, the engine's ``mesh=``), the
sequence-parallel SAM encoder (:mod:`.sp`), file sharding over ranks with
per-rank CSV shards (:mod:`.multihost`), and a launcher that starts the
ranks on one host (:mod:`.launch`; :mod:`.workers` holds rank jobs that
read their inputs from files)."""
