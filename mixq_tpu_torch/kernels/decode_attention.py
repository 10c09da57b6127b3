"""T=1 decode attention over a batch-major KV cache (kernel 8).

Replaces mixq_tpu/ops/pallas/decode_attention.py::decode_attention with the
CUDA kernel in mixq_tpu_torch/csrc/decode_attention.cu. q [B, n_q, D] bf16
against one layer of the batch-major cache, k, v [B, S, n_kv, D] bf16 or
int8 with per-(token, head) scales [B, S, n_kv] f32, GQA g = n_q / n_kv in
{1, 2, 4, 8}, per-row valid lengths and first valid positions (each an int
or [B] int32). The recipe is the Pallas kernel's, which is `attend`'s over
the cache: K and V widened to f32, scores = (q . k) * scale * k_scale,
masked, a normalised softmax, p * v_scale, and the sum of p . v in f32.

Beyond `decode_attention`'s interface it takes what `attend` over a
batch-major cache at T=1 needs, so that the decoder's decode step runs here:
  ring     the cache is a ring (sliding-window models): `kv_len` counts
           absolute positions and slot s holds position
           s + S * floor((kv_len - 1 - s) / S) (negative: never written);
  kv_start the first valid absolute position; the decoder passes
           max(kv_start, kv_len - W) on a windowed layer, which is
           `attend`'s window mask for the query at kv_len - 1;
  scale    the score scale (default 1/sqrt(D), gemma2's
           query_pre_attn_scalar^-0.5), and `softcap` > 0 (gemma2:
           tanh(s / cap) * cap after the scale and k_scale, before the mask).
ALiBi is not ported and raises NotImplementedError.

A row with no valid position gets what JAX gives it: every score is masked
to -1e30, so the softmax is uniform over all S slots and the row is the mean
of p = 1/S times v_scale times v over every slot, written or not.

The scale is 1/sqrt(D) rounded as `attend` computes it (the f32 reciprocal
of the f32 sqrt, the function the decoder replaces); the Pallas kernel
rounds the Python double 1/D**0.5 to f32, at most one f32 ulp away.

`decode_attention` launches the kernel for CUDA tensors and runs
`decode_attention_plain`, which is `attend` at T=1 (PyTorch ops), for CPU
tensors. Besides its total `launches` the wrapper counts its
launches by mode in `mode_launches`: "int8" or "bf16" (the KV type), "ring"
and "softcap".
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Union

import torch

from mixq_tpu_torch.kernels import _build

SOURCE = "mixq_tpu_torch/csrc/decode_attention.cu"
REPLACES = "mixq_tpu/ops/pallas/decode_attention.py:85"
GROUPS = (1, 2, 4, 8)
# The kernel against its plain version: two bf16 ulps of |y| plus this
# much. Both sides compute in f32 from the same widened operands and round
# once to bf16, so they differ by the f32 summation order (tiles of an
# online softmax against one whole-row softmax) and by an ulp of expf or
# tanhf: ~1e-6 of max|v| on the inputs here, which may flip a bf16 rounding
# (the two ulps). A kernel that quantizes the probabilities to int8, as
# kernel 3's recipe does, misses by more than 1.5x this
# (tests/test_torch_decode_attention.py).
DECODE_ATOL = 1e-4
Rows = Union[int, torch.Tensor, None]


def decode_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_len: Rows,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None, kv_start: Rows = None,
    ring: bool = False, scale: Optional[float] = None, softcap: float = 0.0,
) -> torch.Tensor:
    """PyTorch version of the kernel: `attend` over the cache layer for the
    query at kv_len - 1 of each row."""
    # imported here: models.layers imports this package
    from mixq_tpu_torch.models.layers import attend

    B = q.shape[0]
    lens = torch.as_tensor(kv_len, dtype=torch.int64,
                           device=q.device).expand(B)
    starts = (None if kv_start is None else torch.as_tensor(
        kv_start, device=q.device).expand(B))
    return attend(q[:, None], k, v, (lens - 1)[:, None], lens, starts,
                  k_scale=k_scale, v_scale=v_scale, scale=scale,
                  softcap=softcap or None, ring=ring)[:, 0]


@functools.cache
def _lib():
    lib = _build.load("decode_attention")
    lib.decode_attention_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_void_p] + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
           ctypes.c_void_p])
    lib.decode_attention_launch.restype = ctypes.c_int
    return lib


def _device_rows(x: Rows, B: int, device, name: str):
    """(pointer or None, scalar) for a per-row int operand: a Python int is
    passed as a scalar, a tensor as a contiguous int32 [B] on the card."""
    if x is None:
        return None, 0
    if isinstance(x, int):
        return None, x
    if (x.device != device or x.dtype != torch.int32
            or tuple(x.shape) != (B,) or not x.is_contiguous()):
        raise ValueError(f"{name} must be an int or a contiguous int32 [B] "
                         f"tensor on {device}")
    return x.data_ptr(), 0


def decode_attention(
    q: torch.Tensor,                          # [B, n_q, D] bf16
    k: torch.Tensor,                          # [B, S, n_kv, D] int8 | bf16
    v: torch.Tensor,
    kv_len: Rows,                             # int or [B] int32
    k_scale: Optional[torch.Tensor] = None,   # [B, S, n_kv] f32 (int8 KV)
    v_scale: Optional[torch.Tensor] = None,
    kv_start: Rows = None,                    # None, int or [B] int32
    *,
    ring: bool = False,                       # ring cache (absolute kv_len)
    scale: Optional[float] = None,            # score scale; None: 1/sqrt(D)
    softcap: float = 0.0,                     # > 0: gemma2 logit softcap
    alibi_slopes: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Returns the attention output [B, n_q, D] in q.dtype."""
    if alibi_slopes is not None:
        raise NotImplementedError("decode_attention: ALiBi is not ported")
    if softcap < 0:
        raise ValueError(f"softcap {softcap} must be >= 0 (0: none)")
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, kv_len, k_scale, v_scale,
                                      kv_start, ring, scale, softcap)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, n_q, D = q.shape
    Bk, S, n_kv, Dk = k.shape
    quantized = k_scale is not None
    kv_dtype = torch.int8 if quantized else torch.bfloat16
    if Bk != B or Dk != D or n_q % n_kv or n_q // n_kv not in GROUPS:
        raise ValueError(f"shapes q {tuple(q.shape)} / k {tuple(k.shape)}: "
                         f"need matching B, D and n_q/n_kv in {GROUPS}")
    esize = 1 if quantized else 2
    if D * esize not in (16, 32, 64, 128, 256, 512):
        raise ValueError(f"head dim {D} not supported for {kv_dtype}")
    dev = q.device
    _build.require(q, torch.bfloat16, (B, n_q, D), "q", dev)
    for t, name in ((k, "k"), (v, "v")):
        _build.require(t, kv_dtype, (B, S, n_kv, D), name, dev)
    if quantized:                 # read one f32 at a time: any offset
        for t, name in ((k_scale, "k_scale"), (v_scale, "v_scale")):
            if (t.device != dev or t.dtype != torch.float32
                    or tuple(t.shape) != (B, S, n_kv)
                    or not t.is_contiguous()):
                raise ValueError(f"{name} must be a contiguous f32 "
                                 f"{(B, S, n_kv)} tensor on {dev}")
    if scale is None:             # attend's f32 1 / sqrt(D)
        scale = float(1.0 / torch.sqrt(torch.tensor(float(D))))
    len_p, len_all = _device_rows(kv_len, B, dev, "kv_len")
    st_p, st_all = _device_rows(kv_start, B, dev, "kv_start")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib().decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None,
        len_p, len_all, st_p, st_all, out.data_ptr(),
        B, S, n_kv, n_q // n_kv, D, scale, softcap,
        int(quantized), int(ring), stream)
    _build.check(rc, "decode_attention")
    decode_attention.launches += 1
    modes = decode_attention.mode_launches
    modes["int8" if quantized else "bf16"] += 1
    if ring:
        modes["ring"] += 1
    if softcap:
        modes["softcap"] += 1
    return out


decode_attention.launches = 0
decode_attention.mode_launches = {"int8": 0, "bf16": 0, "ring": 0,
                                  "softcap": 0}
