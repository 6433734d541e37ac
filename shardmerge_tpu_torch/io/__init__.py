"""Host IO: safetensors, the local multi-model index, the shard writer."""
