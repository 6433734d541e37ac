"""Audit / repair the weight-map index of a sharded safetensors directory
(counterpart of shardmerge_tpu/tools/verify_safetensors.py).

Finds shard files the index names that the directory lacks (phantom),
shard files the index never names (orphan) and per-shard key drift; with
``repair`` the ``weight_map`` is rebuilt from the shard headers, the stale
index kept as ``<name>.stale-<unixtime>``.
"""

from __future__ import annotations

import json
import shutil
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, FrozenSet, Iterator, Mapping, Optional, Tuple

from ..io.safetensors_io import SafeTensorsReader

__all__ = ["ShardDrift", "AlignmentReport", "scan_shard_keys", "audit_alignment", "rebuild_index", "main"]


@dataclass(frozen=True)
class ShardDrift:
    """Key-level disagreement for one shard that exists on both sides."""

    shard: str
    absent: Tuple[str, ...]  # the index promises these keys; the file lacks them
    unlisted: Tuple[str, ...]  # the file holds these keys; the index does not

    def lines(self) -> Iterator[str]:
        yield f"shard {self.shard} disagrees with the index:"
        for key in self.absent:
            yield f"    -{key}  (promised by index, absent from file)"
        for key in self.unlisted:
            yield f"    +{key}  (present in file, unlisted in index)"


@dataclass(frozen=True)
class AlignmentReport:
    """Everything the audit found, as data; rendering is separate."""

    phantom_shards: Tuple[str, ...] = ()  # in the index, not on disk
    orphan_shards: Tuple[str, ...] = ()  # on disk, not in the index
    drift: Tuple[ShardDrift, ...] = ()
    shards_checked: int = 0
    keys_checked: int = 0

    @property
    def clean(self) -> bool:
        return not (self.phantom_shards or self.orphan_shards or self.drift)

    def lines(self) -> Iterator[str]:
        if self.clean:
            yield f"index and shards agree ({self.shards_checked} shards, {self.keys_checked} tensors)"
            return
        for name in self.phantom_shards:
            yield f"phantom shard {name}: named by the index, not on disk"
        for name in self.orphan_shards:
            yield f"orphan shard {name}: on disk, never named by the index"
        for d in self.drift:
            yield from d.lines()

    def render(self) -> str:
        return "\n".join(self.lines())


def scan_shard_keys(model_dir) -> Dict[str, FrozenSet[str]]:
    """Every ``*.safetensors`` header under ``model_dir``: name -> keys."""
    out: Dict[str, FrozenSet[str]] = {}
    for shard in sorted(Path(model_dir).glob("*.safetensors")):
        with SafeTensorsReader(shard) as reader:
            out[shard.name] = frozenset(reader.keys())
    return out


def audit_alignment(weight_map: Mapping[str, str], shard_keys: Mapping[str, FrozenSet[str]]) -> AlignmentReport:
    """Cross-check an index weight_map against the shard headers on disk."""
    promised: Dict[str, set] = {}
    for key, shard in weight_map.items():
        promised.setdefault(shard, set()).add(key)
    on_disk = set(shard_keys)
    drift = []
    for shard in sorted(promised.keys() & on_disk):
        absent = tuple(sorted(promised[shard] - shard_keys[shard]))
        unlisted = tuple(sorted(shard_keys[shard] - promised[shard]))
        if absent or unlisted:
            drift.append(ShardDrift(shard, absent, unlisted))
    return AlignmentReport(
        phantom_shards=tuple(sorted(promised.keys() - on_disk)),
        orphan_shards=tuple(sorted(on_disk - promised.keys())),
        drift=tuple(drift),
        shards_checked=len(on_disk),
        keys_checked=sum(len(k) for k in shard_keys.values()),
    )


def rebuild_index(shard_keys: Mapping[str, FrozenSet[str]], index_path, metadata: Optional[dict] = None) -> Path:
    """Write a weight_map derived from the shard headers, keeping the stale
    index as ``<name>.stale-<unixtime>``; returns the backup's path (the
    empty path if there was none)."""
    index_path = Path(index_path)
    backup = Path("")
    if index_path.exists():
        backup = index_path.with_name(f"{index_path.name}.stale-{int(time.time())}")
        shutil.copy2(index_path, backup)
    rebuilt = {
        "metadata": dict(metadata or {}),
        "weight_map": {key: shard for shard in sorted(shard_keys) for key in sorted(shard_keys[shard])},
    }
    index_path.write_text(json.dumps(rebuilt, indent=2))
    return backup


def main(model_dir, index_path=None, repair: bool = False) -> bool:
    """Audit ``model_dir``, repairing it with ``repair``; True iff the
    directory ends up clean."""
    model_dir = Path(model_dir)
    if index_path is None:
        index_path = model_dir / "model.safetensors.index.json"
    index = json.loads(Path(index_path).read_text())
    shard_keys = scan_shard_keys(model_dir)
    report = audit_alignment(index.get("weight_map", {}), shard_keys)
    print(report.render())
    if report.clean:
        if repair:
            print("nothing to repair")
        return True
    if not repair:
        return False
    backup = rebuild_index(shard_keys, index_path, index.get("metadata"))
    if backup.name:
        print(f"stale index kept at {backup}")
    print(f"rebuilt {index_path} from {len(shard_keys)} shard headers")
    return True
