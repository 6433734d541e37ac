"""safetensors reader/writer on torch (counterpart of
shardmerge_tpu/io/safetensors_io.py).

torch represents bfloat16 natively, so tensors are read as zero-copy
``torch.frombuffer`` views over a private (copy-on-write) mmap of the file;
nothing is read until a tensor is touched. Format:

    [8 bytes u64 LE: header_size][header_size bytes JSON][data buffer]
"""

from __future__ import annotations

import json
import mmap
import os
from pathlib import Path
from typing import Dict, Iterator, Optional, Tuple

import torch

__all__ = ["SafeTensorsReader", "read_header", "load_file", "save_file"]

_ST_TO_TORCH = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "F8_E4M3": torch.float8_e4m3fn,
    "F8_E5M2": torch.float8_e5m2,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U64": torch.uint64,
    "U32": torch.uint32,
    "U16": torch.uint16,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}
_TORCH_TO_ST = {v: k for k, v in _ST_TO_TORCH.items()}

_MAX_HEADER_SIZE = 100 * 1024 * 1024  # the official library's sanity bound


class SafeTensorsFormatError(ValueError):
    """Raised when a file does not conform to the safetensors format."""


def read_header(path) -> Tuple[dict, int]:
    """Return (header_json, data_start_offset) for a safetensors file."""
    with open(path, "rb") as f:
        prefix = f.read(8)
        if len(prefix) != 8:
            raise SafeTensorsFormatError(f"File too small for safetensors: {path}")
        header_size = int.from_bytes(prefix, "little")
        if header_size > _MAX_HEADER_SIZE:
            raise SafeTensorsFormatError(
                f"Header size {header_size} exceeds sanity bound in {path}"
            )
        raw = f.read(header_size)
        if len(raw) != header_size:
            raise SafeTensorsFormatError(f"Truncated safetensors header in {path}")
    try:
        header = json.loads(raw)
    except json.JSONDecodeError as e:
        raise SafeTensorsFormatError(f"Invalid JSON header in {path}: {e}") from e
    if not isinstance(header, dict):
        raise SafeTensorsFormatError(f"Header must be a JSON object in {path}")
    return header, 8 + header_size


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


class SafeTensorsReader:
    """mmap-backed reader; ``get_tensor`` returns zero-copy CPU views.

    Views stay valid after ``close`` (the mapping is then left for the GC);
    ``copy=True`` detaches the tensor from the file.
    """

    def __init__(self, path):
        self.path = Path(path)
        header, data_start = read_header(self.path)
        self.metadata: Optional[Dict[str, str]] = header.pop("__metadata__", None)
        self._entries: Dict[str, dict] = header
        self._data_start = data_start
        data_len = self.path.stat().st_size - data_start
        for name, entry in self._entries.items():
            self._validate_entry(name, entry, data_len)
        self._file = open(self.path, "rb")
        try:
            # ACCESS_COPY: a private writable mapping, which torch.frombuffer
            # requires; nothing is ever written back to the file
            self._mmap = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_COPY)
        except ValueError:  # an empty file cannot be mapped
            self._mmap = None

    def _validate_entry(self, name: str, entry: dict, data_len: int):
        for key in ("dtype", "shape", "data_offsets"):
            if key not in entry:
                raise SafeTensorsFormatError(
                    f"Tensor {name!r} missing {key!r} in {self.path}"
                )
        if entry["dtype"] not in _ST_TO_TORCH:
            raise SafeTensorsFormatError(
                f"Tensor {name!r} has unsupported dtype {entry['dtype']!r}"
            )
        begin, end = entry["data_offsets"]
        itemsize = _ST_TO_TORCH[entry["dtype"]].itemsize
        if end - begin != _numel(entry["shape"]) * itemsize:
            raise SafeTensorsFormatError(
                f"Tensor {name!r} byte span {end - begin} != shape "
                f"{entry['shape']} x {entry['dtype']}"
            )
        if begin < 0 or end > data_len:
            raise SafeTensorsFormatError(
                f"Tensor {name!r} data_offsets {entry['data_offsets']} outside file"
            )

    def keys(self) -> Iterator[str]:
        return iter(self._entries.keys())

    def nbytes(self, name: str) -> int:
        begin, end = self._entries[name]["data_offsets"]
        return end - begin

    def advise(self, name: str) -> None:
        """Ask the kernel to read the tensor's bytes into the page cache (a
        hint: no copy). ``posix_fadvise`` lets go of the GIL while the kernel
        queues the reads, which can take most of a second for a 1 GB tensor;
        ``mmap.madvise`` would hold it, and stall every other thread."""
        begin, end = self._entries[name]["data_offsets"]
        if end > begin:
            os.posix_fadvise(self._file.fileno(), self._data_start + begin, end - begin,
                             os.POSIX_FADV_WILLNEED)

    def get_tensor(self, name: str, copy: bool = False) -> torch.Tensor:
        if name not in self._entries:
            raise KeyError(f"Tensor {name!r} not found in {self.path}")
        entry = self._entries[name]
        dtype = _ST_TO_TORCH[entry["dtype"]]
        shape = tuple(entry["shape"])
        count = _numel(shape)
        if count == 0:
            return torch.empty(shape, dtype=dtype)
        t = torch.frombuffer(
            self._mmap,
            dtype=dtype,
            count=count,
            offset=self._data_start + entry["data_offsets"][0],
        ).reshape(shape)
        return t.clone() if copy else t

    def close(self):
        # The mapping is NOT closed here: torch.frombuffer keeps a reference
        # to the mmap object but no buffer export, so mmap.close() would
        # unmap memory that live tensor views still point at. Dropping our
        # reference unmaps it once the last view is freed.
        self._mmap = None
        if self._file is not None:
            self._file.close()
            self._file = None

    def __enter__(self) -> "SafeTensorsReader":
        return self

    def __exit__(self, *exc):
        self.close()


def load_file(path) -> Dict[str, torch.Tensor]:
    """All tensors of a safetensors file as owned CPU tensors."""
    with SafeTensorsReader(path) as reader:
        return {name: reader.get_tensor(name, copy=True) for name in reader.keys()}


def save_file(
    tensors: Dict[str, torch.Tensor],
    path,
    metadata: Optional[Dict[str, str]] = None,
):
    """Write CPU tensors in safetensors format, in dict order, contiguous and
    gap-free, header padded with spaces to 8 bytes (the official layout).
    The file appears atomically (written to ``.tmp``, then renamed)."""
    header: Dict[str, dict] = {}
    if metadata is not None:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    blobs = []
    for name, tensor in tensors.items():
        t = tensor.detach().to("cpu").contiguous()
        if t.dtype not in _TORCH_TO_ST:
            raise SafeTensorsFormatError(f"Unsupported dtype for safetensors: {t.dtype}")
        nbytes = t.numel() * t.element_size()
        header[name] = {
            "dtype": _TORCH_TO_ST[t.dtype],
            "shape": list(t.shape),
            "data_offsets": [offset, offset + nbytes],
        }
        offset += nbytes
        blobs.append(t)

    header_bytes = json.dumps(header, separators=(",", ":")).encode("utf-8")
    header_bytes += b" " * ((-(8 + len(header_bytes))) % 8)
    tmp_path = Path(str(path) + ".tmp")
    with open(tmp_path, "wb") as f:
        f.write(len(header_bytes).to_bytes(8, "little"))
        f.write(header_bytes)
        for t in blobs:
            if t.numel():
                f.write(t.reshape(-1).view(torch.uint8).numpy().data)
    os.replace(tmp_path, path)
