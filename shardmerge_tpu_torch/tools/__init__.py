"""Checkpoint tools (counterparts of shardmerge_tpu/tools/)."""
