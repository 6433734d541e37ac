"""Llama model, int4/int8 weight quantization and the int4 GEMV kernel."""
