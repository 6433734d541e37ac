"""Quantized output artifacts: a checkpoint as GPTQ-v2 on disk
(counterpart of shardmerge_tpu/tools/quantize_checkpoint.py).

Symmetric per-output-channel absmax quantization, the serving scheme of
``models/quant.quantize``, written in the AutoGPTQ/gptqmodel ``gptq_v2``
serialization: one group spanning the reduction dim (``group_size: -1``),
the true zero at 2^(bits-1), fp16 scales. The artifact loads in this
package's generate/serve/merge (``models/loader.py``, ``io/index.py``) and
in other GPTQ stacks. Eligible tensors are 2-D ``*.weight`` projections
whose dims pack evenly; embeddings, lm_head, norms, routers and biases pass
through raw. The arithmetic is the JAX tool's (torch's f32 ops on the
host), so the two write the same bytes.
"""

from __future__ import annotations

import json
import logging
import shutil
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from ..io.safetensors_io import SafeTensorsReader, save_file

logger = logging.getLogger(__name__)

__all__ = ["quantize_checkpoint", "is_quantizable"]

_SHARD_BYTES = 2 * 1024**3  # ~2 GiB safetensors shards, HF-style
_COPY_FILES = (
    "config.json",
    "generation_config.json",
    "tokenizer.json",
    "tokenizer_config.json",
    "tokenizer.model",
    "special_tokens_map.json",
    "vocab.json",
    "merges.txt",
)
# never quantized: precision-sensitive or non-linear modules
_EXCLUDE_SUBSTRINGS = ("embed_tokens", "lm_head", "norm", ".gate.", "router", "shared_expert_gate")


def is_quantizable(name: str, shape, bits: int) -> bool:
    """GPTQ-eligible: a 2-D ``*.weight`` projection, not excluded, whose
    dims pack evenly into int32 words."""
    if not name.endswith(".weight") or len(shape) != 2:
        return False
    if any(s in name for s in _EXCLUDE_SUBSTRINGS):
        return False
    per = 32 // bits
    # qweight packs the reduction dim; qzeros pack the output dim
    return shape[1] % per == 0 and shape[0] % per == 0


def _pack_cols(vals: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack unsigned ints little-end-first along axis 0 into int32 words:
    (in, out) -> (in/per, out), the AutoGPTQ qweight layout."""
    per = 32 // bits
    v = vals.to(torch.int64).reshape(vals.shape[0] // per, per, -1)
    out = torch.zeros((v.shape[0], v.shape[2]), dtype=torch.int64)
    for k in range(per):
        out |= v[:, k, :] << (bits * k)
    return out.to(torch.int32)  # the low 32 bits: the uint32 word's int32 view


def _quantize_gptq_v2(w: torch.Tensor, bits: int) -> Dict[str, torch.Tensor]:
    """(out, in) weight -> the GPTQ-v2 tensor quartet, symmetric per output
    channel: q in [-qmax, qmax] around the true zero 2^(bits-1), the JAX
    tool's numpy arithmetic in torch's f32 ops."""
    w32 = w.to(torch.float32)
    out_dim, in_dim = w32.shape
    qmax = 127.0 if bits == 8 else 7.0
    zero = 1 << (bits - 1)
    scale = (w32.abs().amax(dim=1, keepdim=True) / qmax).clamp_min_(1e-12)  # (out, 1)
    q = torch.round(w32 / scale).clamp_(-qmax, qmax).to(torch.int64) + zero
    zeros = torch.full((out_dim, 1), zero, dtype=torch.int64)
    return {
        "qweight": _pack_cols(q.T, bits),  # (in/per, out)
        "qzeros": _pack_cols(zeros, bits).T.contiguous(),  # (1, out/per)
        "scales": scale.T.to(torch.float16).contiguous(),  # (1, out)
        "g_idx": torch.zeros((in_dim,), dtype=torch.int32),
    }


def _iter_tensors(src: Path):
    """(name, owned tensor) for every tensor of a checkpoint directory,
    shard by shard, names sorted within a shard."""
    index_path = src / "model.safetensors.index.json"
    if index_path.is_file():
        shards = sorted(set(json.loads(index_path.read_text())["weight_map"].values()))
    elif (src / "model.safetensors").is_file():
        shards = ["model.safetensors"]
    else:
        raise FileNotFoundError(f"{src}: no model.safetensors.index.json or model.safetensors")
    for shard in shards:
        with SafeTensorsReader(src / shard) as reader:
            for name in sorted(reader.keys()):
                yield name, reader.get_tensor(name, copy=True)


class _ShardWriter:
    """Tensors into ~shard_bytes safetensors files with the HF naming and
    an index."""

    def __init__(self, dst: Path, shard_bytes: int):
        self.dst = dst
        self.shard_bytes = shard_bytes
        self.pending: Dict[str, torch.Tensor] = {}
        self.pending_bytes = 0
        self.weight_map: Dict[str, int] = {}
        self.total = 0
        self.tmp_names = []

    def add(self, name: str, t: torch.Tensor):
        nbytes = t.numel() * t.element_size()
        self.pending[name] = t
        self.pending_bytes += nbytes
        self.total += nbytes
        if self.pending_bytes >= self.shard_bytes:
            self.flush()

    def flush(self):
        if not self.pending:
            return
        idx = len(self.tmp_names)
        tmp = self.dst / f"shard-{idx}.tmp"
        save_file(self.pending, tmp)
        for name in self.pending:
            self.weight_map[name] = idx
        self.tmp_names.append(tmp)
        self.pending = {}
        self.pending_bytes = 0

    def finalize(self) -> int:
        self.flush()
        n = len(self.tmp_names)
        names = [f"model-{i + 1:05d}-of-{n:05d}.safetensors" for i in range(n)]
        for tmp, final in zip(self.tmp_names, names):
            tmp.rename(self.dst / final)
        index = {
            "metadata": {"total_size": self.total},
            "weight_map": {k: names[v] for k, v in sorted(self.weight_map.items())},
        }
        (self.dst / "model.safetensors.index.json").write_text(json.dumps(index, indent=2))
        return n


def quantize_checkpoint(src_dir, dst_dir, bits: int = 4, shard_bytes: int = _SHARD_BYTES,
                        check: bool = True) -> dict:
    """Write a GPTQ-v2 artifact of ``src_dir`` into ``dst_dir``; returns the
    report (tensors quantized/passthrough, bytes, and with ``check`` the
    worst round-trip relL2 of the serialization against the serving
    quantization, which only the fp16 scales may move)."""
    from ..models.quant import dequant, dequant_gptq, quantize

    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    src, dst = Path(src_dir), Path(dst_dir)
    dst.mkdir(parents=True, exist_ok=True)
    writer = _ShardWriter(dst, shard_bytes)
    n_quant = n_raw = 0
    src_bytes = 0
    worst_rel = 0.0
    for name, t in _iter_tensors(src):
        src_bytes += t.numel() * t.element_size()
        if not is_quantizable(name, t.shape, bits):
            writer.add(name, t)
            n_raw += 1
            continue
        root = name[: -len(".weight")]
        parts = _quantize_gptq_v2(t, bits)
        for part, val in parts.items():
            writer.add(f"{root}.{part}", val)
        n_quant += 1
        if check:
            back = dequant_gptq(parts["qweight"], parts["qzeros"], parts["scales"], parts["g_idx"], bits,
                                v1_zero_offset=False).numpy()
            ours = dequant(quantize(t, bits), torch.float32).numpy()  # norms in numpy, as the JAX tool
            rel = float(np.linalg.norm(back - ours) / (np.linalg.norm(ours) or 1.0))
            worst_rel = max(worst_rel, rel)
            if rel > 2e-3:
                raise AssertionError(f"{name}: GPTQ-v2 round-trip relL2 {rel:.2e} exceeds the fp16-scale bound")
    n_shards = writer.finalize()

    # config.json announces the format to every GPTQ loader
    cfg_path = src / "config.json"
    cfg = json.loads(cfg_path.read_text()) if cfg_path.is_file() else {}
    cfg["quantization_config"] = {
        "quant_method": "gptq",
        "bits": bits,
        "group_size": -1,
        "sym": True,
        "desc_act": False,
        "checkpoint_format": "gptq_v2",
        "meta": {"producer": "shardmerge_tpu", "scheme": "per-channel-absmax"},
    }
    (dst / "config.json").write_text(json.dumps(cfg, indent=2))
    for extra in _COPY_FILES[1:]:
        if (src / extra).is_file():
            shutil.copy2(src / extra, dst / extra)

    report = {
        "bits": bits,
        "tensors_quantized": n_quant,
        "tensors_passthrough": n_raw,
        "shards": n_shards,
        "src_bytes": src_bytes,
        "dst_bytes": writer.total,
        "compression": round(src_bytes / max(writer.total, 1), 2),
    }
    if check:
        report["worst_roundtrip_relL2_vs_serving_quant"] = worst_rel
    logger.info("Quantized %d tensors (+%d raw) into %d shards: %.2f GiB -> %.2f GiB (%.1fx)",
                n_quant, n_raw, n_shards, src_bytes / 2**30, writer.total / 2**30, report["compression"])
    return report
