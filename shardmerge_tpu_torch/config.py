"""Merge configuration (counterpart of shardmerge_tpu/config.py).

Same schema as the JAX ``MergeConfig``, so one file drives both CLIs. The
file is read with PyYAML when it is importable and as JSON otherwise (JSON is
valid YAML, so a JSON config works everywhere). dtypes resolve to torch
dtypes. Fields of the JAX schema whose features this port does not carry yet
are accepted and rejected by the CLI when set (see cli.py).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

import torch


class ConfigError(ValueError):
    """Raised for invalid merge configuration files."""


_DTYPES = {
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
    "float16": torch.float16,
    "fp16": torch.float16,
    "half": torch.float16,
    "float32": torch.float32,
    "fp32": torch.float32,
    "float": torch.float32,
    "float64": torch.float64,
    "fp64": torch.float64,
}


def resolve_dtype(name: str) -> torch.dtype:
    dtype = _DTYPES.get(name)
    if dtype is None:
        raise ConfigError(f"Unsupported output_dtype: {name!r}")
    return dtype


@dataclass
class MergeModel:
    """One finetuned model participating in the merge."""

    model: str
    base: str
    alpha: float = 1.0
    is_input: bool = False
    is_output: bool = False
    is_norm: bool = False
    start_layer: int = 0
    end_layer: int = -1

    def use_layer_index(self, layer_index: int) -> bool:
        # sentinel layers (INPUT_LAYER=-1, OUTPUT_LAYER=-2) sort below
        # start_layer=0 and are therefore excluded by default
        if self.start_layer > layer_index:
            return False
        if self.end_layer != -1 and self.end_layer < layer_index:
            return False
        return True


@dataclass
class MergeConfig:
    finetune_merge: List[MergeModel]
    output_base_model: str
    output_dir: str
    output_dtype: str = "bfloat16"
    device: str = "cuda"  # "cpu" runs the merge on the host
    clean_cache: bool = False
    cache_dir: str = "cache"
    storage_dir: str = "storage"
    write_through: bool = False
    merge_method: str = "fourier"
    method_options: dict = field(default_factory=dict)
    shard_tensors: Optional[bool] = None
    shard_min_bytes: int = 1 << 30
    hbm_budget_gb: Optional[float] = None
    distributed: bool = False
    exact_imag: bool = False  # literal double-FFT imaginary recursion

    @property
    def input_model(self) -> Optional[MergeModel]:
        return next((m for m in self.finetune_merge if m.is_input), None)

    @property
    def output_path(self) -> Path:
        return Path(self.output_dir)

    @property
    def cache_path(self) -> Path:
        return Path(self.cache_dir)

    @property
    def storage_path(self) -> Path:
        return Path(self.storage_dir)

    @property
    def output_astype(self) -> torch.dtype:
        return resolve_dtype(self.output_dtype)

    @classmethod
    def from_file(cls, config_path) -> "MergeConfig":
        """Load and validate a YAML (or JSON) merge configuration."""
        text = Path(config_path).read_text()
        try:
            import yaml
        except ImportError:
            try:
                config = json.loads(text) if text.strip() else None
            except json.JSONDecodeError as e:
                raise ConfigError(
                    f"{config_path} is not JSON and PyYAML is not installed: {e}"
                ) from e
        else:
            config = yaml.safe_load(text)

        if not isinstance(config, dict):
            raise ConfigError("Configuration file must contain a YAML mapping")
        required = ["output_base_model", "finetune_merge", "output_dir"]
        missing = [key for key in required if key not in config]
        if missing:
            raise ConfigError(
                f"Missing required configuration fields: {', '.join(missing)}"
            )
        if not isinstance(config["finetune_merge"], list):
            raise ConfigError("finetune_merge must be a list of model entries")
        try:
            config["finetune_merge"] = [
                MergeModel(**model) for model in config["finetune_merge"]
            ]
        except TypeError as e:
            raise ConfigError(f"Invalid finetune_merge entry: {e}") from e
        if not isinstance(config.get("method_options", {}), dict):
            raise ConfigError("method_options must be a mapping")
        try:
            cfg = cls(**config)
        except TypeError as e:
            raise ConfigError(f"Invalid configuration field: {e}") from e
        resolve_dtype(cfg.output_dtype)  # validate eagerly
        return cfg
