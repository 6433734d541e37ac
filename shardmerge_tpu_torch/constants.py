"""Sentinel layer indices (counterpart of shardmerge_tpu/constants.py)."""

INPUT_LAYER = -1
OUTPUT_LAYER = -2

# the per-layer projections LoRA tooling targets by default
# (tools/extract_lora.py; the JAX package's constants.LORA_TARGET_PROJECTIONS)
LORA_TARGET_PROJECTIONS = (
    "q_proj", "k_proj", "v_proj", "o_proj",
    "gate_proj", "up_proj", "down_proj",
)
