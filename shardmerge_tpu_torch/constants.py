"""Sentinel layer indices (counterpart of shardmerge_tpu/constants.py)."""

INPUT_LAYER = -1
OUTPUT_LAYER = -2
