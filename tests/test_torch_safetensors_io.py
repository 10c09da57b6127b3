"""PyTorch port: utils/safetensors_io.py against the `safetensors`
package (here only as a cross-check; the port never imports it).

- Every dtype the port reads and writes (BF16, F16, F32, I8, U8, I16,
  U16, I32, I64, BOOL), 0-d and empty tensors: the port's file read by
  the package bit-equal, and the package's file read by the port
  bit-equal, with metadata.
- A tensor at an odd byte offset (a 1-byte tensor ahead of it) reads back
  bit-equal: the reader copies an unaligned slice before viewing it.
- The port's header is padded to a multiple of 8 and its tensors tile the
  data region, which the package's reader checks.
- A truncated file, an overlapping header, a gap and an unknown dtype
  raise; tensors read on the host outlive the file's map."""
import json
import struct

import numpy as np
import pytest
import safetensors
import safetensors.torch as st
import torch

from mixq_tpu_torch.utils import safetensors_io as sio

DTYPES = [torch.bfloat16, torch.float16, torch.float32, torch.int8,
          torch.uint8, torch.int16, torch.uint16, torch.int32, torch.int64,
          torch.bool]


def sample(dtype, shape, seed):
    g = torch.Generator().manual_seed(seed)
    if dtype == torch.bool:
        return torch.rand(shape, generator=g) > 0.5
    if dtype.is_floating_point:
        return (torch.randn(shape, generator=g) * 100).to(dtype)
    bits = torch.randint(-2 ** 15, 2 ** 15, shape, generator=g,
                         dtype=torch.int64)
    if dtype == torch.uint16:
        return bits.to(torch.int16).view(torch.uint16)
    return bits.to(dtype)


def bits(t):
    """The tensor's bytes (a 0-d tensor's too) and its dtype and shape."""
    return (t.dtype, tuple(t.shape),
            t.reshape(-1).view(torch.uint8).numpy().tobytes())


def tensors(seed):
    out = {}
    for i, dt in enumerate(DTYPES):
        name = str(dt).replace("torch.", "")
        out[name] = sample(dt, (3, 5), seed + i)
        out[name + ".scalar"] = sample(dt, (), seed + 50 + i)
    out["empty"] = torch.zeros((0, 4), dtype=torch.float32)
    return out


def load(path):
    with sio.SafeTensorsFile(path) as f:
        return {k: f.get(k) for k in f.keys()}


def test_port_file_read_by_the_package(tmp_path):
    ts = tensors(0)
    p = str(tmp_path / "port.safetensors")
    n = sio.save_file(ts, p, metadata={"format": "pt", "k": "v"})
    with open(p, "rb") as f:
        (hlen,) = struct.unpack("<Q", f.read(8))
    assert hlen % 8 == 0
    got = st.load_file(p)
    assert set(got) == set(ts)
    for k, t in ts.items():
        assert bits(got[k]) == bits(t), k
    with safetensors.safe_open(p, framework="pt") as f:
        assert f.metadata() == {"format": "pt", "k": "v"}
    assert n == len(open(p, "rb").read())


def test_package_file_read_by_the_port(tmp_path):
    ts = tensors(100)
    p = str(tmp_path / "pkg.safetensors")
    st.save_file(ts, p, metadata={"format": "pt"})
    with sio.SafeTensorsFile(p) as f:
        assert set(f.keys()) == set(ts)
        assert f.metadata == {"format": "pt"}
        for k, t in ts.items():
            assert bits(f.get(k)) == bits(t), k


def test_odd_offset_reads_back(tmp_path):
    """A 1-byte tensor ahead of the rest puts every other tensor at an odd
    offset, in the port's own file and (by hand) after an odd header."""
    ts = {"a_byte": torch.tensor([7], dtype=torch.uint8)}
    ts.update({str(dt).replace("torch.", ""): sample(dt, (4, 3), 200 + i)
               for i, dt in enumerate(DTYPES)})
    ts["int32_scalar"] = torch.tensor(-123456, dtype=torch.int32)
    p = str(tmp_path / "odd.safetensors")
    sio.save_file(ts, p)
    with open(p, "rb") as f:
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen))
    assert header["float32"]["data_offsets"][0] % 2 == 1
    back = load(p)
    for k, t in ts.items():
        assert bits(back[k]) == bits(t), k
    got = st.load_file(p)
    for k, t in ts.items():
        assert bits(got[k]) == bits(t), k
    # a header of odd length (no padding): every tensor lands unaligned
    raw = open(p, "rb").read()[8 + hlen:]
    head = json.dumps(header).encode()
    head += b" " * ((1 - len(head)) % 8 + 8)
    assert len(head) % 2 == 1
    q = str(tmp_path / "odd_header.safetensors")
    with open(q, "wb") as f:
        f.write(struct.pack("<Q", len(head)) + head + raw)
    back = load(q)
    for k, t in ts.items():
        assert bits(back[k]) == bits(t), k


def test_host_tensors_outlive_the_map(tmp_path):
    p = str(tmp_path / "x.safetensors")
    t = sample(torch.float32, (64, 64), 5)
    sio.save_file({"t": t}, p)
    f = sio.SafeTensorsFile(p)
    got = f.get("t")
    f.close()
    assert torch.equal(got, t)
    got.add_(1)          # its own memory: writable, the file unchanged
    assert torch.equal(load(p)["t"], t)


def _write(path, header, data):
    head = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)) + head + data)


@pytest.mark.parametrize("fault", ["truncated", "overlap", "gap", "dtype",
                                   "short_header", "size"])
def test_bad_files_raise(tmp_path, fault):
    p = str(tmp_path / "bad.safetensors")
    a = {"dtype": "F32", "shape": [2], "data_offsets": [0, 8]}
    b = {"dtype": "F32", "shape": [2], "data_offsets": [8, 16]}
    if fault == "truncated":
        sio.save_file({"a": torch.ones(2), "b": torch.ones(2)}, p)
        raw = open(p, "rb").read()
        open(p, "wb").write(raw[:-3])
    elif fault == "overlap":
        _write(p, {"a": a, "b": dict(b, data_offsets=[4, 12])}, bytes(12))
    elif fault == "gap":
        _write(p, {"a": a, "b": dict(b, data_offsets=[12, 20])}, bytes(20))
    elif fault == "dtype":
        _write(p, {"a": dict(a, dtype="F8_E9")}, bytes(8))
    elif fault == "short_header":
        with open(p, "wb") as f:
            f.write(struct.pack("<Q", 1000) + b"{}")
    else:
        _write(p, {"a": dict(a, shape=[3])}, bytes(8))
    with pytest.raises(ValueError):
        sio.SafeTensorsFile(p)


def test_save_refuses_an_unnamed_dtype(tmp_path):
    with pytest.raises(ValueError, match="complex64"):
        sio.save_file({"c": torch.zeros(2, dtype=torch.complex64)},
                      str(tmp_path / "c.safetensors"))

