"""The port's own safetensors reader and writer (the JAX package reads and
writes through the `safetensors` package: mixq_tpu/quantize/checkpoint.py,
mixq_tpu/models/hf.py::TensorSource.from_safetensors_dir).

The format: an 8-byte little-endian header length n, n bytes of JSON
({name: {"dtype", "shape", "data_offsets": [begin, end]}}, an optional
"__metadata__" of strings), then the tensors' raw bytes, offsets relative
to the end of the header. `save_file` lays the tensors out back to back in
the order given and pads the header with spaces to a multiple of 8, as the
`safetensors` package does; `SafeTensorsFile` maps a file and hands out
one tensor at a time, so nothing materializes the whole file.

    save_file({"w": t}, "model.safetensors", metadata={"format": "pt"})
    with SafeTensorsFile("model.safetensors") as f:
        w = f.get("w", device="cuda")
"""
from __future__ import annotations

import json
import math
import mmap
import os
import struct
import warnings
from typing import Dict, Mapping, Optional

import torch

DTYPES = {
    "BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32,
    "I8": torch.int8, "U8": torch.uint8, "I16": torch.int16,
    "U16": torch.uint16, "I32": torch.int32, "I64": torch.int64,
    "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in DTYPES.items()}
# a header past this is not a header (the safetensors package's own limit)
_MAX_HEADER = 100 * 1024 * 1024


def save_file(tensors: Mapping[str, torch.Tensor], path: str,
              metadata: Optional[Dict[str, str]] = None) -> int:
    """Write `tensors` (on any device) to `path`; each is copied to the
    host on its own while it is written. Returns the bytes written."""
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in
                                  metadata.items()}
    offset = 0
    for name, t in tensors.items():
        if t.dtype not in _NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors "
                             "name")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for t in tensors.values():
            if t.numel():
                raw = t.detach().contiguous().reshape(-1).view(torch.uint8)
                f.write(raw.cpu().numpy().data)
    return 8 + len(head) + offset


def _entries(header: Dict, data_len: int, path: str) -> Dict[str, Dict]:
    """The header's tensors, checked: known dtypes, sizes that match the
    shapes, and offsets that tile the data region with no gap or
    overlap."""
    header = dict(header)
    header.pop("__metadata__", None)
    spans = []
    for name, e in header.items():
        if not isinstance(e, dict) or e.get("dtype") not in DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has no known dtype "
                             f"({e!r})")
        begin, end = e["data_offsets"]
        size = math.prod(e["shape"]) * DTYPES[e["dtype"]].itemsize
        if end - begin != size:
            raise ValueError(f"{path}: tensor {name!r} spans {end - begin} "
                             f"bytes, its shape {e['shape']} needs {size}")
        spans.append((begin, end, name))
    at = 0
    for begin, end, name in sorted(spans):
        if begin != at:
            raise ValueError(f"{path}: tensor {name!r} starts at byte "
                             f"{begin}, not {at} (a gap or an overlap)")
        at = end
    if at != data_len:
        raise ValueError(f"{path}: the tensors end at byte {at} of a "
                         f"{data_len}-byte data region (truncated?)")
    return header


class SafeTensorsFile:
    """A safetensors file mapped read-only: `keys()`, `metadata`, and
    `get(name, device)`, which copies one tensor out of the map onto
    `device` in its stored dtype (a tensor on the host owns its memory, so
    the map can close under it)."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        try:
            size = os.fstat(self._f.fileno()).st_size
            if size < 8:
                raise ValueError(f"{path}: {size} bytes, no header")
            (n,) = struct.unpack("<Q", self._f.read(8))
            if n > min(_MAX_HEADER, size - 8):
                raise ValueError(f"{path}: a {n}-byte header in a {size}-"
                                 "byte file (truncated?)")
            header = json.loads(self._f.read(n))
            self.metadata = header.get("__metadata__") or {}
            self._start = 8 + n
            self._entries = _entries(header, size - self._start, path)
            self._map = (mmap.mmap(self._f.fileno(), 0,
                                   access=mmap.ACCESS_READ)
                         if size > self._start else None)
        except BaseException:
            self._f.close()
            raise

    def keys(self):
        return self._entries.keys()

    def get(self, name: str, device="cpu") -> torch.Tensor:
        e = self._entries[name]
        dtype, shape = DTYPES[e["dtype"]], tuple(e["shape"])
        begin, end = e["data_offsets"]
        if end == begin:
            return torch.empty(shape, dtype=dtype, device=device)
        with warnings.catch_warnings():
            # the map is read-only and nothing writes through this view
            warnings.filterwarnings("ignore", "The given buffer is not "
                                    "writable")
            raw = torch.frombuffer(self._map, dtype=torch.uint8,
                                   count=end - begin,
                                   offset=self._start + begin)
        if (self._start + begin) % dtype.itemsize:
            raw = raw.clone()         # an unaligned slice: view a copy
        t = raw.view(dtype).reshape(shape)
        # a host tensor gets its own memory; a device copy leaves the map
        return t.clone() if torch.device(device).type == "cpu" else \
            t.to(device)

    def close(self) -> None:
        if self._map is not None:
            self._map.close()
            self._map = None
        self._f.close()

    def __enter__(self) -> "SafeTensorsFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
