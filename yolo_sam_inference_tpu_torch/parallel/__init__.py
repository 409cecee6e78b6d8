"""Multi-rank paths of the port over ``torch.distributed``: the
sequence-parallel SAM encoder (:mod:`.sp`) and a launcher that starts the
ranks on one host (:mod:`.launch`)."""
