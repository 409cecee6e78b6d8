"""Multi-rank paths of the port over ``torch.distributed``: meshes of ranks
and data parallelism (:mod:`.mesh`, the engine's ``mesh=``), the sequence-,
tensor- and pipeline-parallel SAM encoders (:mod:`.sp`, :mod:`.tp`,
:mod:`.pp`), the SAM fine-tune step over dp x tp (:mod:`.train`), file
sharding over ranks with per-rank CSV shards (:mod:`.multihost`), a
launcher that starts the ranks on one host (:mod:`.launch`; :mod:`.workers`
holds rank jobs that read their inputs from files) and the multi-rank dry
run (:mod:`.dryrun`)."""
