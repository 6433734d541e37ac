"""Multi-model index over local checkpoint directories and HuggingFace Hub
repositories (counterpart of shardmerge_tpu/io/index.py).

Both indexes hand the merge host tensors through one interface:
``get_tensor`` (cached until ``release_tensor``), ``preload_tensor`` (an
owned copy, page-locked with ``pin_memory``, safe from worker threads),
``advise_tensor`` and ``close``. The offline index returns zero-copy views
of the shard files from ``get_tensor``; the Hub index downloads each shard
once (``io/download.py``) and hands out owned copies only, so that with
``clean_cache`` a shard is deleted as soon as the last of its tensors has
been copied out of it.

Besides plain checkpoints, a model may be

- a PEFT LoRA adapter (``adapter_config.json`` + ``adapter_model.
  safetensors``): it mirrors its base's index, and each targeted tensor is
  ``base + scale·B@A`` fused on the host when it is read
  (``tools/fuse_lora.fuse_pair``, the function the loader and the
  ``fuse-lora`` tool call too);
- a GPTQ or AWQ checkpoint (``config.json`` ``quantization_config``): a
  hidden ``<id>#raw`` registration holds the packed parts, and the public
  index presents each module's decoded ``.weight`` (f32, decoded on the
  host by ``models/quant.dequant_gptq``/``dequant_awq`` when it is read; in
  the merge that is a read-ahead worker).

Fused and decoded tensors are computed once however many threads ask.
"""

from __future__ import annotations

import json
import logging
import os
import struct
import threading
import time
import urllib.error
from pathlib import Path
from typing import Callable, Dict, List, Optional, Set, Tuple

import torch

from .download import DownloadManager, hf_auth_headers, http_get
from .safetensors_io import SafeTensorsReader

logger = logging.getLogger(__name__)

__all__ = [
    "HFMultiModelIndex",
    "OfflineMultiModelIndex",
    "PACKED_PARTS",
    "ordered_weights",
    "packed_quant_info",
]

# packed weight-only formats that register as merge inputs: the public
# index presents decoded .weight keys, parts decode lazily per module
PACKED_PARTS = {
    "gptq": ("qweight", "qzeros", "scales", "g_idx"),
    "awq": ("qweight", "qzeros", "scales"),
}


def packed_quant_info(qc: dict) -> Optional[dict]:
    """A config.json ``quantization_config`` as ``{"fmt", "bits", "v1"}``
    for the packed formats the index decodes (GPTQ, AWQ gemm); None for
    none (or MXFP4, which only the loader decodes). AWQ serializations
    other than asymmetric gemm raise."""
    method = (qc or {}).get("quant_method")
    if method == "gptq":
        return {
            "fmt": "gptq",
            "bits": int(qc.get("bits", 4)),
            # v1 stores zero-1; gptqmodel marks v2 via checkpoint_format
            "v1": qc.get("checkpoint_format", "gptq") != "gptq_v2",
        }
    if method == "awq":
        version = qc.get("version", "gemm")
        if version != "gemm":
            raise ValueError(
                f"AWQ version {version!r} is not decodable; only the "
                "Hub-dominant 'gemm' serialization is supported"
            )
        if qc.get("zero_point", True) is not True:
            raise ValueError(
                "symmetric AWQ (zero_point: false) is not decodable; only "
                "asymmetric gemm checkpoints are supported"
            )
        return {"fmt": "awq", "bits": int(qc.get("bits", 4)), "v1": False}
    return None


def _virtualize_packed_index(index: dict, fmt: str):
    """(virtual_index, modules) for a GPTQ/AWQ weight map, or None when it
    holds no packed module. The virtual map presents each module's
    ``root.weight`` (on its qweight's shard); other tensors keep their
    entries. ``modules``: virtual key -> module root."""
    required = PACKED_PARTS[fmt]
    parts_by_root: Dict[str, dict] = {}
    passthrough: Dict[str, str] = {}
    for key, shard in index["weight_map"].items():
        root, _, part = key.rpartition(".")
        if part in required:
            parts_by_root.setdefault(root, {})[part] = shard
        else:
            passthrough[key] = shard
    if not parts_by_root:
        return None
    virtual = dict(passthrough)
    modules = {}
    for root, parts in sorted(parts_by_root.items()):
        missing = set(required) - set(parts)
        if missing:
            raise ValueError(f"{fmt.upper()} module {root!r} is missing {sorted(missing)}")
        virtual[root + ".weight"] = parts["qweight"]
        modules[root + ".weight"] = root
    return {"metadata": dict(index.get("metadata", {})), "weight_map": virtual}, modules


def ordered_weights(weight_map: Dict[str, str]) -> List[str]:
    """Canonical weight order: embed_tokens, per-layer components (sorted
    within each layer), model.norm, lm_head, then everything else sorted
    (the JAX package's ``ordered_weights``)."""
    weights = list(weight_map.keys())
    embed = sorted(w for w in weights if "embed_tokens" in w)
    layer_weights = [w for w in weights if "layers." in w]
    norm = sorted(w for w in weights if "model.norm.weight" in w)
    lm_head = sorted(w for w in weights if "lm_head" in w)
    special = set(embed + layer_weights + norm + lm_head)
    other = sorted(w for w in weights if w not in special)

    per_layer: Dict[int, List[str]] = {}
    for w in layer_weights:
        per_layer.setdefault(int(w.split("layers.")[1].split(".")[0]), []).append(w)
    layers = [w for n in sorted(per_layer) for w in sorted(per_layer[n])]

    result = embed + layers + norm + lm_head + other
    if set(result) != set(weights):
        raise ValueError(
            f"Weight ordering mismatch! Missing: {set(weights) - set(result)}, "
            f"Extra: {set(result) - set(weights)}"
        )
    return result


def _header_index(header: dict, shard: str = "model.safetensors") -> dict:
    """A one-shard index from a safetensors header."""
    header = {k: v for k, v in header.items() if k != "__metadata__"}
    total = sum(e["data_offsets"][1] - e["data_offsets"][0] for e in header.values())
    return {"metadata": {"total_size": total}, "weight_map": {name: shard for name in header}}


def _single_file_index(model_path: Path) -> dict:
    """A one-shard index for a single ``model.safetensors`` checkpoint,
    built from its header alone."""
    from .safetensors_io import read_header

    return _header_index(read_header(model_path / "model.safetensors")[0])


def _write_whole(path: Path, data: bytes) -> None:
    """``data`` into ``path``, which appears whole: written under a name of
    this process's own, then renamed (the merge ranks of one host may
    write the same file at once)."""
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    tmp.write_bytes(data)
    os.replace(tmp, path)


class OfflineMultiModelIndex:
    """Index over local model directories; a model is known by its
    directory name and by the path strings used to add it."""

    # whether get_tensor may hand out views of the shard files
    _views = True

    def __init__(self):
        self.model_indexes: Dict[str, dict] = {}
        self.model_paths: Dict[str, Path] = {}
        self._ordered: Dict[str, List[str]] = {}
        self._aliases: Dict[str, str] = {}
        self._readers: Dict[Path, SafeTensorsReader] = {}
        self._tensor_cache: Dict[Tuple[str, str], torch.Tensor] = {}
        # model id -> {"pairs", "scale", "base", "evict_base"} (LoRA adapters)
        self._adapters: Dict[str, dict] = {}
        # model id -> {"fmt", "bits", "v1", "modules": {vkey: root}, "raw": id}
        self._packed: Dict[str, dict] = {}
        # (model, tensor) -> lock held while that tensor is copied, fused or decoded
        self._computing: Dict[Tuple[str, str], threading.Lock] = {}
        # host seconds and tensors of the adapter fuses and packed decodes
        self.host_work = {"fuse": [0, 0.0], "decode": [0, 0.0]}
        # guards the dicts above (worker threads preload while the merge
        # thread reads and releases)
        self._lock = threading.Lock()

    # -- registration ----------------------------------------------------------

    def _alias(self, model_id: str, model_path: Optional[Path] = None) -> None:
        self._aliases[model_id] = model_id
        if model_path is not None:
            self._aliases[str(model_path)] = model_id
            self._aliases[str(model_path.resolve())] = model_id

    def _resolve(self, model_id) -> str:
        return self._aliases.get(str(model_id), str(model_id))

    def _register_index(self, model_id: str, index: dict) -> None:
        if "weight_map" not in index:
            raise ValueError(f"Index for {model_id!r} missing 'weight_map' key")
        self.model_indexes[model_id] = index
        self._ordered[model_id] = ordered_weights(index["weight_map"])
        logger.info("Initialized %d shards for model %s",
                    len(set(index["weight_map"].values())), model_id)

    def _register_packed(self, model_id: str, index: dict, info: dict) -> Optional[dict]:
        """Register the packed index under the hidden ``<id>#raw`` and return
        the virtual index, or None when the map holds no packed module."""
        virt = _virtualize_packed_index(index, info["fmt"])
        if virt is None:
            return None
        virtual_index, modules = virt
        raw_id = model_id + "#raw"
        self._register_index(raw_id, index)
        self._packed[model_id] = {**info, "modules": modules, "raw": raw_id}
        logger.info("Registered %s model %r (%d quantized modules, bits=%d): tensors decode on the fly",
                    info["fmt"].upper(), model_id, len(modules), info["bits"])
        return virtual_index

    def _register_adapter_entry(self, model_id: str, pairs: dict, scale: float, base_id: str,
                                evict_base: bool = False) -> None:
        """Mirror the base's index and order onto an adapter's id after
        checking that its targets exist in the base."""
        missing = sorted(set(pairs) - set(self.model_indexes[base_id]["weight_map"]))
        if missing:
            raise KeyError(
                f"adapter {model_id!r} targets tensors absent from its base {base_id!r}: "
                f"{missing[:4]}{'...' if len(missing) > 4 else ''}"
            )
        self.model_indexes[model_id] = self.model_indexes[base_id]
        self._ordered[model_id] = self._ordered[base_id]
        # evict_base: the base was registered only for this adapter, so the
        # merge's per-layer eviction never drops its tensors; the fuse does
        self._adapters[model_id] = {"pairs": pairs, "scale": float(scale), "base": base_id,
                                    "evict_base": bool(evict_base)}
        logger.info("Registered LoRA adapter %r on base %r (%d tensor pairs, scale %g): tensors fuse on the fly",
                    model_id, base_id, len(pairs), scale)

    def add_model(self, model_path) -> None:
        model_path = Path(model_path)
        if not model_path.is_dir():
            raise NotADirectoryError(f"Provided model path is not a directory: {model_path}")
        model_id = model_path.name
        if model_id in self.model_indexes:
            logger.warning("Model %r already added. Skipping.", model_id)
            self._alias(model_id, model_path)
            return
        index_path = model_path / "model.safetensors.index.json"
        if index_path.exists():
            try:
                index = json.loads(index_path.read_text())
            except json.JSONDecodeError as e:
                raise ValueError(f"Failed to parse index file {index_path}: {e}") from e
        elif (model_path / "model.safetensors").exists():
            index = _single_file_index(model_path)
        elif (model_path / "adapter_config.json").exists():
            self._register_adapter(model_id, model_path)
            return
        else:
            raise FileNotFoundError(
                "Neither 'model.safetensors.index.json', 'model.safetensors' "
                f"nor a PEFT 'adapter_config.json' found in {model_path}"
            )
        cfg_file = model_path / "config.json"
        if cfg_file.is_file():
            info = packed_quant_info(json.loads(cfg_file.read_text()).get("quantization_config") or {})
            if info is not None:
                self.model_paths[model_id + "#raw"] = model_path
                virtual = self._register_packed(model_id, index, info)
                if virtual is None:
                    self.model_paths.pop(model_id + "#raw")
                else:
                    index = virtual
        self.model_paths[model_id] = model_path
        try:
            self._register_index(model_id, index)
        except Exception:
            for table in (self.model_paths, self.model_indexes, self._packed):
                table.pop(model_id, None)
            raise
        self._alias(model_id, model_path)

    def _find(self, ref: str) -> Optional[str]:
        """The registered id of a reference (id, path or resolved path)."""
        for key in (ref, str(Path(ref).resolve()) if ref else ref):
            model_id = self._aliases.get(key)
            if model_id in self.model_indexes:
                return model_id
        return None

    def _register_adapter(self, model_id: str, model_path: Path) -> None:
        """A PEFT adapter directory: its base is ``base_model_name_or_path``,
        a registered model or a local checkpoint directory to register now."""
        from ..tools.fuse_lora import load_adapter

        pairs, scale = load_adapter(model_path)
        cfg = json.loads((model_path / "adapter_config.json").read_text())
        base_ref = str(cfg.get("base_model_name_or_path") or "")
        base_id = self._find(base_ref)
        implicit = False
        if base_id is None and base_ref and Path(base_ref).is_dir():
            self.add_model(Path(base_ref))
            base_id, implicit = self._find(base_ref), True
        if base_id is None:
            raise FileNotFoundError(
                f"adapter {model_path} declares base_model_name_or_path={base_ref!r}, which is "
                "neither a registered model nor a local checkpoint directory; set it to the "
                "adapter's base checkpoint (or register that base first)"
            )
        self._register_adapter_entry(model_id, pairs, scale, base_id, evict_base=implicit)
        self.model_paths[model_id] = model_path
        self._alias(model_id, model_path)

    # -- lookups ---------------------------------------------------------------

    def _known(self, model_id) -> str:
        resolved = self._resolve(model_id)
        if resolved not in self.model_indexes:
            raise KeyError(f"Model {model_id} not found in index")
        return resolved

    def get_layer_order(self, model_id) -> List[str]:
        return list(self._ordered[self._known(model_id)])

    def get_model_keys(self, model_id) -> Set[str]:
        return set(self.model_indexes[self._known(model_id)]["weight_map"])

    def get_index(self, model_id) -> dict:
        return self.model_indexes[self._known(model_id)]

    def __contains__(self, model_id) -> bool:
        return self._resolve(model_id) in self.model_indexes

    # -- shard files (the Hub index downloads them) ----------------------------

    def _shard_path(self, model_id: str, shard: str) -> Path:
        path = self.model_paths[model_id] / shard
        if not path.exists():
            raise FileNotFoundError(f"Shard file not found: {path}")
        return path

    def _reader(self, path: Path) -> SafeTensorsReader:
        with self._lock:
            reader = self._readers.get(path)
            if reader is None:
                reader = self._readers[path] = SafeTensorsReader(path)
        return reader

    def _after_copy(self, model_id: str, shard: str, name: str, path: Path) -> None:
        """An owned copy of ``name`` was taken from ``path`` (the Hub index
        releases the shard's claim)."""

    def _read(self, model_id: str, name: str, owned: bool, pin: bool) -> torch.Tensor:
        weight_map = self.model_indexes[model_id]["weight_map"]
        if name not in weight_map:
            raise KeyError(f"Tensor {name!r} not found in model {model_id!r}")
        shard = weight_map[name]
        path = self._shard_path(model_id, shard)
        view = self._reader(path).get_tensor(name)
        if not owned:
            return view
        host = torch.empty(view.shape, dtype=view.dtype, pin_memory=pin)
        host.copy_(view)
        self._after_copy(model_id, shard, name, path)
        return host

    # -- tensors -----------------------------------------------------------------

    def _tensor(self, model_id: str, name: str, owned: bool, pin: bool) -> torch.Tensor:
        key = (model_id, name)
        with self._lock:
            cached = self._tensor_cache.get(key)
        if cached is not None:
            return cached
        if model_id in self._adapters:
            return self._computed(key, self._fuse, pin)
        packed = self._packed.get(model_id)
        if packed is not None and name in packed["modules"]:
            return self._computed(key, self._decode, pin)
        if not owned and self._views:
            tensor = self._read(model_id, name, owned, pin)
            with self._lock:
                return self._tensor_cache.setdefault(key, tensor)
        return self._computed(key, lambda m, n: self._read(m, n, True, pin), pin)

    def _computed(self, key, compute: Callable, pin: bool) -> torch.Tensor:
        """A copied, fused or decoded tensor, computed once however many
        threads ask (the others wait for it), then cached."""
        with self._lock:
            lock = self._computing.setdefault(key, threading.Lock())
        with lock:
            with self._lock:
                cached = self._tensor_cache.get(key)
            if cached is None:
                tensor = compute(*key)
                if pin and not tensor.is_pinned():
                    tensor = tensor.pin_memory()
                with self._lock:
                    cached = self._tensor_cache.setdefault(key, tensor)
        with self._lock:
            self._computing.pop(key, None)
        return cached

    def _count(self, kind: str, t0: float) -> None:
        with self._lock:
            self.host_work[kind][0] += 1
            self.host_work[kind][1] += time.perf_counter() - t0

    def _fuse(self, model_id: str, name: str) -> torch.Tensor:
        """The adapter's tensor: its base's, with the pair fused in if it
        has one (an untargeted tensor is the base tensor itself)."""
        from ..tools.fuse_lora import fuse_pair

        ad = self._adapters[model_id]
        pair = ad["pairs"].get(name)
        base = self._tensor(ad["base"], name, owned=False, pin=False)
        if ad["evict_base"]:
            with self._lock:
                self._tensor_cache.pop((ad["base"], name), None)
        if pair is None:
            return base
        t0 = time.perf_counter()
        fused = fuse_pair(base, pair["A"], pair["B"], ad["scale"])
        self._count("fuse", t0)
        return fused

    def _decode(self, model_id: str, name: str) -> torch.Tensor:
        """The (out, in) f32 weight of a packed module, decoded on the host;
        its packed parts are dropped from the cache afterwards."""
        from ..models.quant import dequant_awq, dequant_gptq

        pk = self._packed[model_id]
        root = pk["modules"][name]
        parts = {p: self._tensor(pk["raw"], f"{root}.{p}", owned=False, pin=False)
                 for p in PACKED_PARTS[pk["fmt"]]}
        t0 = time.perf_counter()
        if pk["fmt"] == "awq":
            w = dequant_awq(parts["qweight"], parts["qzeros"], parts["scales"], bits=pk["bits"])
        else:
            w = dequant_gptq(parts["qweight"], parts["qzeros"], parts["scales"], parts["g_idx"],
                             pk["bits"], v1_zero_offset=pk["v1"])
        self._count("decode", t0)
        with self._lock:
            for p in parts:
                self._tensor_cache.pop((pk["raw"], f"{root}.{p}"), None)
        return w

    def get_tensor(self, model_id, tensor_name: str) -> torch.Tensor:
        """The tensor on the host (cached until :meth:`release_tensor`): a
        read-ahead's copy, a fused or decoded tensor, else a CPU view of its
        shard file."""
        return self._tensor(self._known(model_id), tensor_name, owned=False, pin=False)

    def preload_tensor(self, model_id, tensor_name: str, *, pin_memory: bool = False) -> torch.Tensor:
        """Read the tensor into an owned host copy (page-locked with
        ``pin_memory``, for asynchronous copies to a card) and cache it; safe
        to call from worker threads. A cached tensor is returned as it is;
        of two reads of one tensor at once, the first cached wins."""
        return self._tensor(self._known(model_id), tensor_name, owned=True, pin=pin_memory)

    def _advise_target(self, model_id: str, name: str) -> Tuple[str, str]:
        """The (model, tensor) whose shard bytes ``name`` of ``model_id`` reads."""
        ad = self._adapters.get(model_id)
        if ad is not None:
            return self._advise_target(ad["base"], name)
        pk = self._packed.get(model_id)
        if pk is not None and name in pk["modules"]:
            return pk["raw"], f"{pk['modules'][name]}.qweight"
        return model_id, name

    def advise_tensor(self, model_id, tensor_name: str) -> None:
        """Start the kernel's read of the tensor's bytes without copying them
        (read-ahead for a tensor that is only passed through to the writer,
        which reads its shard-file view)."""
        model_id, name = self._advise_target(self._known(model_id), tensor_name)
        shard = self.model_indexes[model_id]["weight_map"][name]
        self._reader(self._shard_path(model_id, shard)).advise(name)

    def release_tensor(self, model_id, tensor_name: str) -> None:
        with self._lock:
            self._tensor_cache.pop((self._resolve(model_id), tensor_name), None)

    def close(self) -> None:
        with self._lock:
            self._tensor_cache.clear()
            for reader in self._readers.values():
                reader.close()
            self._readers.clear()


class HFMultiModelIndex(OfflineMultiModelIndex):
    """Index over HuggingFace Hub repositories (and local directories, which
    register as in :class:`OfflineMultiModelIndex`).

    ``add_model(repo_id, revision)`` reads the repo's
    ``model.safetensors.index.json`` (kept under ``storage/<repo>/`` and
    reused offline); a repo without one is a single ``model.safetensors``,
    whose index is built from the header at the start of the file (the
    connection is then dropped), else a PEFT adapter repo. ``HF_ENDPOINT``
    (or ``endpoint``) overrides the Hub's address. Every request carries the
    resolved token. Tensors read from a shard are owned copies; once every
    tensor of a downloaded shard has been copied out of it, its claims are
    used up, and with ``clean_cache`` it is deleted.
    """

    # a Hub shard may be deleted once read out: owned copies only
    _views = False

    def __init__(self, download_manager: DownloadManager, cache_path=None, endpoint: Optional[str] = None,
                 token: Optional[str] = None, timeout: float = 60.0):
        super().__init__()
        self.headers = hf_auth_headers(token)
        self.download_manager = download_manager
        self.cache_path = Path(cache_path) if cache_path else Path.home() / ".cache" / "shardmerge_tpu"
        self.cache_path.mkdir(parents=True, exist_ok=True)
        self.endpoint = (endpoint or os.environ.get("HF_ENDPOINT") or "https://huggingface.co").rstrip("/")
        self.timeout = timeout
        self._revisions: Dict[str, str] = {}
        # (partition, url) -> names of the shard not yet copied out of it
        self._unread: Dict[Tuple[str, str], Set[str]] = {}

    def _get(self, url: str) -> Optional[bytes]:
        """The body of a GET, or None on 404."""
        try:
            with http_get(url, self.headers, self.timeout) as resp:
                return resp.read()
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return None
            raise

    def add_model(self, model_uri, revision: str = "main") -> None:
        """Register a local directory, or fetch (or load from storage) a
        Hub repo's index."""
        ref = str(model_uri)
        if Path(ref).is_dir():
            return super().add_model(Path(ref))
        if ref in self.model_indexes:
            return
        if ref.startswith(("/", "./", "../", "~")):
            # a path that is not a directory: joined onto the storage path
            # it would be created there; fail loudly instead
            raise FileNotFoundError(
                f"Model reference {ref!r} is a filesystem path, not a HuggingFace repo id, "
                "and no such directory exists — check the paths in the config."
            )
        model_path = self.download_manager.storage_path / ref
        model_path.mkdir(parents=True, exist_ok=True)
        index_file = model_path / "model.safetensors.index.json"
        if index_file.exists():
            logger.info("Model %s already in storage; loading index", ref)
            index = json.loads(index_file.read_text())
        elif (model_path / "adapter_config.json").exists():
            self._register_hub_adapter(ref, model_path)
            return
        else:
            self._revisions[ref] = revision
            url = f"{self.endpoint}/{ref}/raw/{revision}/model.safetensors.index.json"
            text = self._get(url)
            if text is None:
                try:
                    index = self._fetch_single_file_index(ref, revision)
                except FileNotFoundError as no_weights:
                    try:
                        self._fetch_adapter_files(ref, revision, model_path)
                    except FileNotFoundError:
                        raise no_weights from None
                    self._register_hub_adapter(ref, model_path)
                    return
                text = json.dumps(index).encode()
            else:
                index = json.loads(text)
                logger.info("Fetched index for model %s", ref)
            _write_whole(index_file, text)
        self._revisions[ref] = revision
        index = self._maybe_register_hub_packed(ref, revision, model_path, index)
        self._register_index(ref, index)
        self._alias(ref)

    def _maybe_register_hub_packed(self, ref: str, revision: str, model_path: Path, index: dict) -> dict:
        """A repo whose weight map holds packed ``.qweight`` modules: read its
        config.json (from storage, else fetched and kept) and register the
        hidden raw index; returns the index the public id presents. Other
        repos make no request here."""
        if not any(k.endswith(".qweight") for k in index.get("weight_map", {})):
            return index
        cfg_file = model_path / "config.json"
        if cfg_file.is_file():
            cfg_doc = json.loads(cfg_file.read_text())
        else:
            body = self._get(f"{self.endpoint}/{ref}/raw/{revision}/config.json")
            if body is None:
                logger.warning("Model %s has packed qweight tensors but no config.json announcing "
                               "the format; registering it raw", ref)
                return index
            cfg_doc = json.loads(body)
            _write_whole(cfg_file, json.dumps(cfg_doc).encode())
        info = packed_quant_info(cfg_doc.get("quantization_config") or {})
        if info is None:
            return index
        virtual = self._register_packed(ref, index, info)
        if virtual is None:
            return index
        # the raw parts download from the public repo: same URL, same
        # storage partition (see _dl_uri)
        self._revisions[ref + "#raw"] = revision
        return virtual

    def _fetch_single_file_index(self, ref: str, revision: str) -> dict:
        """A one-shard index from the remote ``model.safetensors``'s header:
        the file is streamed only until its 8-byte length and JSON header
        have arrived, then the connection is dropped."""
        url = self._shard_url(ref, "model.safetensors")
        try:
            resp = http_get(url, self.headers, self.timeout)
        except urllib.error.HTTPError as e:
            if e.code == 404:
                raise FileNotFoundError(
                    f"{ref}: neither model.safetensors.index.json nor model.safetensors "
                    f"exists at revision {revision!r}"
                ) from None
            raise
        buf, need = b"", None
        with resp:
            while need is None or len(buf) < need:
                chunk = resp.read1(1 << 16)
                if not chunk:
                    break
                buf += chunk
                if need is None and len(buf) >= 8:
                    need = 8 + struct.unpack("<Q", buf[:8])[0]
        if need is None or len(buf) < need:
            raise ValueError(f"{ref}: model.safetensors truncated before its header")
        logger.info("Synthesized single-file index for model %s from the remote header", ref)
        return _header_index(json.loads(buf[8:need]))

    def _fetch_adapter_files(self, ref: str, revision: str, model_path: Path) -> None:
        """A Hub adapter's two small files into storage (weights first:
        a re-run keys on adapter_config.json existing)."""
        for name in ("adapter_model.safetensors", "adapter_config.json"):
            data = self._get(self._shard_url(ref, name))
            if data is None:
                raise FileNotFoundError(f"{ref}: no {name} at revision {revision!r}")
            _write_whole(model_path / name, data)
        logger.info("Fetched LoRA adapter files for %s", ref)

    def _register_hub_adapter(self, ref: str, model_path: Path) -> None:
        """Register a stored adapter on its base (a Hub repo or a local
        directory, registered now if it is not yet)."""
        from ..tools.fuse_lora import load_adapter

        pairs, scale = load_adapter(model_path)
        cfg = json.loads((model_path / "adapter_config.json").read_text())
        base_ref = str(cfg.get("base_model_name_or_path") or "")
        if not base_ref:
            raise ValueError(f"hub adapter {ref} has no base_model_name_or_path; cannot resolve its base checkpoint")
        implicit = base_ref not in self
        self.add_model(base_ref)
        self._register_adapter_entry(ref, pairs, scale, self._resolve(base_ref), evict_base=implicit)
        self._alias(ref)

    @staticmethod
    def _dl_uri(model_uri: str) -> str:
        """The download partition and URL repo of a model id: a packed
        model's hidden ``<repo>#raw`` registration downloads the public
        repo's files, so a shard that holds packed modules and passthrough
        tensors transfers once."""
        return model_uri.rsplit("#raw", 1)[0]

    def _shard_url(self, model_uri: str, shard_name: str) -> str:
        revision = self._revisions.get(model_uri, "main")
        return f"{self.endpoint}/{self._dl_uri(model_uri)}/resolve/{revision}/{shard_name}?download=true"

    def _shard_path(self, model_id: str, shard: str) -> Path:
        if model_id in self.model_paths:
            return super()._shard_path(model_id, shard)
        dl, url = self._dl_uri(model_id), self._shard_url(model_id, shard)
        manager = self.download_manager
        with self._lock:
            if (dl, url) not in manager.downloads:
                # the tensors in the file: the raw index's for a packed repo
                real = self._packed[dl]["raw"] if dl in self._packed else dl
                names = {n for n, s in self.model_indexes[real]["weight_map"].items() if s == shard}
                self._unread[(dl, url)] = names
                manager.cache_file(dl, url, no_claims=len(names))
        return manager.fetch(dl, url)

    def _read(self, model_id: str, name: str, owned: bool, pin: bool) -> torch.Tensor:
        if model_id in self.model_paths:
            return super()._read(model_id, name, owned, pin)
        try:
            return super()._read(model_id, name, True, pin)
        except FileNotFoundError:
            # the shard was read out and deleted (clean_cache) before this
            # re-read of one of its tensors: download it again
            return super()._read(model_id, name, True, pin)

    def _after_copy(self, model_id: str, shard: str, name: str, path: Path) -> None:
        if model_id in self.model_paths:
            return
        key = (self._dl_uri(model_id), self._shard_url(model_id, shard))
        with self._lock:
            unread = self._unread.get(key)
            if unread is None or name not in unread:
                return
            unread.discard(name)
            if not unread:
                # the last tensor is out: forget the reader (not closed: a
                # thread may still hold it; the mapping outlives the file)
                del self._unread[key]
                self._readers.pop(path, None)
        self.download_manager.release(*key)
