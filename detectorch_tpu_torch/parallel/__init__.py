"""Data- and model-parallel execution over ``torch.distributed``: one
process per card (``mesh``), the ranks' launcher (``launch``) and the
multi-rank dry run (``dryrun``)."""
