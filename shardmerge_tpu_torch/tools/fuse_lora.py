"""Fuse a PEFT LoRA adapter into a base checkpoint: W' = W + s·(B @ A)
(counterpart of shardmerge_tpu/tools/fuse_lora.py).

A PEFT adapter directory holds ``adapter_model.safetensors`` with
``...<module>.lora_A.weight`` (r, in) / ``...<module>.lora_B.weight``
(out, r) pairs and ``adapter_config.json``; the scale is PEFT's
``lora_alpha / r`` (``lora_alpha / sqrt(r)`` with ``use_rslora``).

:func:`fuse_pair` is the one place the update is computed: ``W.f32 +
s·(B.f32 @ A.f32)`` cast back to W's dtype. The index's on-the-fly fuse
(io/index.py), the loader (models/loader.py) and :func:`fuse_lora` all call
it, so the three agree bit for bit on one device. The index and the loader
fuse on the host; :func:`fuse_lora` runs on the device it is given (the
CLI's ``fuse-lora`` on the card unless ``--device cpu``). The output keeps
the base's shard layout and index; untargeted tensors are copied through
byte for byte.
"""

from __future__ import annotations

import json
import math
import shutil
from pathlib import Path
from typing import Dict, Optional

import torch

from ..io.safetensors_io import SafeTensorsReader, save_file

__all__ = ["LoraFormatError", "fuse_lora", "fuse_pair", "load_adapter"]

_ADAPTER_WEIGHTS = ("adapter_model.safetensors",)
_ADAPTER_CONFIG = "adapter_config.json"
_AUX_FILES = [
    "config.json",
    "generation_config.json",
    "tokenizer.json",
    "tokenizer_config.json",
    "special_tokens_map.json",
    "tokenizer.model",
]


class LoraFormatError(ValueError):
    pass


def _base_key(adapter_key: str) -> Optional[tuple]:
    """An adapter tensor key -> (base tensor key, 'A'|'B'), or None.

    PEFT prefixes module paths with ``base_model.model.`` and suffixes the
    pair as ``.lora_A.weight`` / ``.lora_B.weight`` (an optional
    ``.default`` adapter name may sit in between)."""
    key = adapter_key
    for prefix in ("base_model.model.", "base_model."):
        if key.startswith(prefix):
            key = key[len(prefix):]
            break
    for side in ("A", "B"):
        for infix in (f".lora_{side}.weight", f".lora_{side}.default.weight"):
            if key.endswith(infix):
                return key[: -len(infix)] + ".weight", side
    return None


def load_adapter(adapter_dir):
    """Read a PEFT adapter directory -> (pairs, scale).

    pairs: base tensor key -> {"A": (r, in) tensor, "B": (out, r)}, owned
    CPU copies. An adapter tensor that is not a lora_A/lora_B pair is an
    error: dropping part of a finetune would corrupt the fusion."""
    adapter_dir = Path(adapter_dir)
    cfg_path = adapter_dir / _ADAPTER_CONFIG
    if not cfg_path.is_file():
        raise LoraFormatError(f"no {_ADAPTER_CONFIG} in {adapter_dir}")
    cfg = json.loads(cfg_path.read_text())
    r = int(cfg.get("r", 0))
    alpha = float(cfg.get("lora_alpha", r))
    if r <= 0:
        raise LoraFormatError(f"adapter rank r={r} is not positive")
    scale = alpha / (math.sqrt(r) if cfg.get("use_rslora") else r)

    weights = next((adapter_dir / n for n in _ADAPTER_WEIGHTS if (adapter_dir / n).is_file()), None)
    if weights is None:
        raise LoraFormatError(f"no adapter weights ({'/'.join(_ADAPTER_WEIGHTS)}) in {adapter_dir}")

    pairs: Dict[str, dict] = {}
    with SafeTensorsReader(weights) as reader:
        for key in reader.keys():
            mapped = _base_key(key)
            if mapped is None:
                raise LoraFormatError(
                    f"unrecognized adapter tensor {key!r} (only lora_A/lora_B pairs fuse; "
                    "bias/modules_to_save adapters are not supported)"
                )
            base, side = mapped
            pairs.setdefault(base, {})[side] = reader.get_tensor(key, copy=True)
    for base, ab in pairs.items():
        if set(ab) != {"A", "B"}:
            raise LoraFormatError(f"incomplete lora pair for {base!r}")
        if ab["A"].shape[0] != r or ab["B"].shape[1] != r:
            raise LoraFormatError(
                f"{base!r}: lora shapes {tuple(ab['A'].shape)}/{tuple(ab['B'].shape)} do not match rank {r}"
            )
    return pairs, float(scale)


def fuse_pair(w: torch.Tensor, a: torch.Tensor, b: torch.Tensor, scale: float) -> torch.Tensor:
    """``W + scale·(B @ A)`` in f32 on W's device, cast back to W's dtype.
    A and B move to W's device; the scale is an f32 value (the JAX
    package's ``np.float32(scale)``). A card product runs with TF32 off."""
    dev = w.device
    s = torch.tensor(scale, dtype=torch.float32)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        delta = b.to(dev, torch.float32) @ a.to(dev, torch.float32)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return (w.to(torch.float32) + delta * s).to(w.dtype)


def _shards(base_dir: Path, index_path: Path):
    if index_path.is_file():
        return sorted(set(json.loads(index_path.read_text())["weight_map"].values()))
    shards = [p.name for p in sorted(base_dir.glob("*.safetensors"))]
    if not shards:
        raise FileNotFoundError(f"no safetensors in {base_dir}")
    return shards


def fuse_lora(base_dir, adapter_dir, output_dir, scale: Optional[float] = None, device="cpu") -> dict:
    """Write ``output_dir`` = the base checkpoint with the adapter fused in
    (each targeted tensor fused on ``device``). Keeps the base's shard
    layout and index; untargeted tensors are copied through byte for byte.
    Returns {"fused_tensors", "scale", "shards"}."""
    base_dir, output_dir = Path(base_dir), Path(output_dir)
    dev = torch.device(device)
    output_dir.mkdir(parents=True, exist_ok=True)
    pairs, cfg_scale = load_adapter(adapter_dir)
    s = cfg_scale if scale is None else float(scale)
    index_path = base_dir / "model.safetensors.index.json"
    shards = _shards(base_dir, index_path)

    seen = set()
    for shard in shards:
        out_tensors = {}
        with SafeTensorsReader(base_dir / shard) as reader:
            for key in reader.keys():
                w = reader.get_tensor(key)
                if key in pairs:
                    ab = pairs[key]
                    if w.shape[0] != ab["B"].shape[0] or w.shape[-1] != ab["A"].shape[1]:
                        raise LoraFormatError(
                            f"{key!r}: base {tuple(w.shape)} does not take a "
                            f"{tuple(ab['B'].shape)} x {tuple(ab['A'].shape)} update"
                        )
                    w = fuse_pair(w.to(dev), ab["A"], ab["B"], s).cpu()
                    seen.add(key)
                out_tensors[key] = w
            save_file(out_tensors, output_dir / shard, metadata={"format": "pt"})

    missing = set(pairs) - seen
    if missing:
        raise LoraFormatError(
            f"adapter targets absent from the base checkpoint: "
            f"{sorted(missing)[:4]}{'...' if len(missing) > 4 else ''}"
        )
    if index_path.is_file():
        shutil.copyfile(index_path, output_dir / "model.safetensors.index.json")
    for aux in _AUX_FILES:
        if (base_dir / aux).is_file():
            shutil.copyfile(base_dir / aux, output_dir / aux)
    return {"fused_tensors": len(seen), "scale": s, "shards": len(shards)}
