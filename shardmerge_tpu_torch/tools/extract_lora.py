"""Extract a PEFT LoRA adapter from a full finetune: delta -> SVD -> (A, B)
(counterpart of shardmerge_tpu/tools/extract_lora.py).

Each targeted 2-D weight's delta ``D = W_ft - W_base`` is factored into its
best rank-r approximation by truncated SVD::

    D ~ U_r S_r V_r^T     B = U_r sqrt(S_r) (out, r)    A = sqrt(S_r) V_r^T (r, in)

and written in PEFT layout with ``lora_alpha = r`` (scale 1), so
``fuse-lora`` of the adapter gives ``base + B@A``. Targets default to the
q/k/v/o/gate/up/down projections, matched on a module-path component
boundary; tensors narrower than r get zero-padded factors. The summary
carries each tensor's captured share of the delta's Frobenius energy.

The SVD runs in f64 on the device given (the card by default in the CLI;
``--device cpu`` on the host), see :func:`factor`. SVD factors differ in
sign and rotation between libraries: what is held to the JAX tool is the
product ``B@A``.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

from ..constants import LORA_TARGET_PROJECTIONS as DEFAULT_TARGETS
from ..io.safetensors_io import SafeTensorsReader, save_file

logger = logging.getLogger(__name__)

__all__ = ["extract_lora", "DEFAULT_TARGETS", "LoraExtractError"]


class LoraExtractError(ValueError):
    pass


def _shard_files(model_dir: Path):
    index_path = model_dir / "model.safetensors.index.json"
    if index_path.is_file():
        return sorted(set(json.loads(index_path.read_text())["weight_map"].values()))
    shards = [p.name for p in sorted(model_dir.glob("*.safetensors"))]
    if not shards:
        raise FileNotFoundError(f"no safetensors in {model_dir}")
    return shards


class _TensorSource:
    """Random-access reads over a sharded checkpoint: one reader per shard,
    tensors handed out as views."""

    def __init__(self, model_dir: Path):
        self.dir = Path(model_dir)
        self._readers: Dict[str, SafeTensorsReader] = {}
        self._key_to_shard: Dict[str, str] = {}
        for shard in _shard_files(self.dir):
            reader = self._readers[shard] = SafeTensorsReader(self.dir / shard)
            for key in reader.keys():
                self._key_to_shard[key] = shard

    def keys(self):
        return self._key_to_shard.keys()

    def __contains__(self, key: str) -> bool:
        return key in self._key_to_shard

    def get(self, key: str) -> torch.Tensor:
        return self._readers[self._key_to_shard[key]].get_tensor(key)

    def close(self):
        for reader in self._readers.values():
            reader.close()


def _matches_target(module: str, suffixes) -> bool:
    """Component-anchored suffix match: 'v_proj' must not take a fused
    'qkv_proj', nor 'up_proj' a fused 'gate_up_proj'."""
    return any(module == s or module.endswith("." + s) for s in suffixes)


def _module_of(key: str) -> Optional[str]:
    return key[: -len(".weight")] if key.endswith(".weight") else None


def factor(delta: torch.Tensor, r: int):
    """Best rank-r factors (B (out, r), A (r, in)) of a 2-D f32 delta on its
    device, as f32 CPU tensors, plus the captured Frobenius share; ranks
    past min(out, in) are zero-padded (B@A unchanged).

    The SVD runs in f64: a finetune's delta often has clustered singular
    values (a random delta's neighbours differ by 1e-4 relative), and an
    f32 SVD then moves the rank-r subspace by ~1e-5 between libraries and
    devices; in f64 the card, the host and the JAX tool's product agree to
    f32 rounding."""
    u, s, vt = torch.linalg.svd(delta.to(torch.float64), full_matrices=False)
    k = min(r, s.numel())
    root = torch.sqrt(s[:k])
    b = (u[:, :k] * root[None, :]).to(torch.float32)
    a = (root[:, None] * vt[:k]).to(torch.float32)
    if k < r:
        b = torch.cat([b, b.new_zeros((b.shape[0], r - k))], dim=1)
        a = torch.cat([a, a.new_zeros((r - k, a.shape[1]))], dim=0)
    energy = s**2
    total = float(energy.sum())
    captured = float(energy[:k].sum())
    return b.cpu(), a.cpu(), (captured / total if total > 0.0 else 1.0)


def extract_lora(base_dir, finetuned_dir, output_dir, rank: int = 16,
                 target_modules: Optional[Sequence[str]] = None, device="cpu") -> dict:
    """Write ``output_dir`` as a PEFT adapter approximating ``finetuned -
    base`` at ``rank``, each SVD on ``device``. Returns {"tensors", "rank",
    "capture", "capture_min"}."""
    base_dir, finetuned_dir, output_dir = Path(base_dir), Path(finetuned_dir), Path(output_dir)
    if rank <= 0:
        raise LoraExtractError(f"rank must be positive, got {rank}")
    dev = torch.device(device)
    suffixes = tuple(target_modules or DEFAULT_TARGETS)
    base, ft = _TensorSource(base_dir), _TensorSource(finetuned_dir)
    adapter: Dict[str, torch.Tensor] = {}
    capture: Dict[str, float] = {}
    matched = set()
    try:
        for key in base.keys():
            module = _module_of(key)
            if module is None or not _matches_target(module, suffixes):
                continue
            if key not in ft:
                raise LoraExtractError(f"target {key!r} missing from the finetuned checkpoint")
            w_base, w_ft = base.get(key), ft.get(key)
            if w_ft.shape != w_base.shape or w_base.dim() != 2:
                raise LoraExtractError(
                    f"{key!r}: shapes {tuple(w_base.shape)} vs {tuple(w_ft.shape)} are not a matching 2-D pair"
                )
            delta = w_ft.to(dev, torch.float32) - w_base.to(dev, torch.float32)
            b, a, ratio = factor(delta, rank)
            adapter[f"base_model.model.{module}.lora_A.weight"] = a
            adapter[f"base_model.model.{module}.lora_B.weight"] = b
            capture[key] = ratio
            matched.add(module.rsplit(".", 1)[-1])
    finally:
        base.close()
        ft.close()
    if not adapter:
        raise LoraExtractError(f"no base tensors matched target modules {list(suffixes)}")

    output_dir.mkdir(parents=True, exist_ok=True)
    save_file(adapter, output_dir / "adapter_model.safetensors")
    config = {
        "peft_type": "LORA",
        "r": int(rank),
        "lora_alpha": int(rank),  # PEFT's scale alpha/r == 1: B @ A is the delta
        "lora_dropout": 0.0,
        "target_modules": sorted(matched),
        "base_model_name_or_path": str(base_dir),
        "bias": "none",
        "task_type": "CAUSAL_LM",
    }
    (output_dir / "adapter_config.json").write_text(json.dumps(config, indent=2))
    worst = min(capture.values())
    logger.info("extracted rank-%d adapter: %d tensor pairs, Frobenius capture min %.4f / mean %.4f",
                rank, len(capture), worst, sum(capture.values()) / len(capture))
    return {"tensors": len(capture), "rank": int(rank), "capture": capture, "capture_min": worst}
