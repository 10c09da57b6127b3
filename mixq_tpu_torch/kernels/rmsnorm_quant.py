"""Fused RMSNorm + per-token int8 activation quantization (kernel 1).

Replaces mixq_tpu/ops/pallas/rmsnorm_quant.py::fused_rmsnorm_quant with the
CUDA kernel in mixq_tpu_torch/csrc/rmsnorm_quant.cu. One pass over x gives
the normed bf16 row y, the int8 activation of the next linear (outlier
channels zeroed by the inlier mask) with its per-row scale, and the dense
fp slice of the outlier channels.

The kernel follows the JAX main path (models/layers.py::rmsnorm_quant =
rmsnorm + prepare_act): y is rounded to bf16 before it is masked and
quantized. The Pallas kernel quantizes the f32 y instead, so its q_x can
differ from this one's by 1 LSB where the bf16 rounding moves a value across
a rounding boundary.

`fused_rmsnorm_quant` launches the kernel for a CUDA tensor and runs
`rmsnorm_quant_plain`, the same arithmetic in PyTorch ops, for a CPU tensor.
On the card `plan_rmsnorm` picks the instantiation: a block holds its row
in registers, 512 threads of one 16-byte chunk of 8 channels each, for H
up to 4096 in multiples of 8 with 16-byte aligned operands; any other row
goes to the looping kernel, one row a block through shared memory.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from mixq_tpu_torch.kernels import _build
from mixq_tpu_torch.ops.quant import quantize_act_per_token

SOURCE = "mixq_tpu_torch/csrc/rmsnorm_quant.cu"
REPLACES = "mixq_tpu/ops/pallas/rmsnorm_quant.py:41"

Result = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]

# the source's chunk width (csrc/rmsnorm_quant.cu kChunk), the (threads a
# block, chunks a thread holds) it instantiates (chunks 0: the looping
# kernel) and the widest row the register kernel holds (512 chunks)
CHUNK = 8
INSTANTIATIONS = ((512, 1), (256, 0))
REGS_MAX_H = 4096


def plan_rmsnorm(H: int, aligned: bool = True) -> Tuple[int, int]:
    """(threads a block, chunks of 8 channels a thread holds in registers)
    for rows of H channels: the register kernel (512, 1) for H <= 4096 in
    multiples of 8 with 16-byte aligned operands, else the looping kernel
    (256, 0)."""
    if aligned and H % CHUNK == 0 and H <= REGS_MAX_H:
        return 512, 1
    return 256, 0


def rmsnorm_quant_plain(
    x: torch.Tensor, gamma: torch.Tensor,
    k_mask: Optional[torch.Tensor] = None, eps: float = 1e-5,
    a_bits: int = 8, out_ind: Optional[torch.Tensor] = None,
    out_mask: Optional[torch.Tensor] = None,
) -> Result:
    """PyTorch version of the kernel, in the JAX main path's order:
    rmsnorm (f32, rounded to x.dtype), then extract/mask/quantize."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = (xf * torch.rsqrt(var + eps) * gamma.float()).to(x.dtype)
    return (y, *quantize_normed(y, k_mask, a_bits, out_ind, out_mask))


def quantize_normed(
    y: torch.Tensor, k_mask: Optional[torch.Tensor] = None, a_bits: int = 8,
    out_ind: Optional[torch.Tensor] = None,
    out_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """The plain version's second half on a normed bf16 row y: (q_x,
    x_scale, x_out). Fed the kernel's own y, it gives the kernel's q_x,
    x_scale and x_out bit for bit (the card tests hold that)."""
    y_in = y if k_mask is None else y * k_mask.to(y.dtype)
    q_x, x_scale = quantize_act_per_token(y_in, bits=a_bits)
    x_out = None
    if out_ind is not None:
        x_out = torch.index_select(y, -1, out_ind) * out_mask.to(y.dtype)
    return q_x, x_scale, x_out


@functools.cache
def _launcher():
    fn = _build.load("rmsnorm_quant").rmsnorm_quant_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def fused_rmsnorm_quant(
    x: torch.Tensor,                          # [..., H] bf16
    gamma: torch.Tensor,                      # [H] f32
    k_mask: Optional[torch.Tensor] = None,    # [H] f32, 1 = inlier
    eps: float = 1e-5,
    a_bits: int = 8,
    out_ind: Optional[torch.Tensor] = None,   # [B] int32 outlier channels
    out_mask: Optional[torch.Tensor] = None,  # [B] f32, 1 = live slot
) -> Result:
    """Returns (y bf16 [..., H], q_x int8 [..., H], x_scale f32 [..., 1],
    x_out bf16 [..., B] or None)."""
    return _rmsnorm(x, gamma, k_mask, eps, a_bits, out_ind, out_mask)


def _rmsnorm(x, gamma, k_mask, eps, a_bits, out_ind, out_mask,
             plan: Optional[Tuple[int, int]] = None) -> Result:
    """`fused_rmsnorm_quant`; `plan` forces (threads, chunks) instead of
    plan_rmsnorm's, so a card test can hold the instantiations against
    each other."""
    if x.device.type == "cpu":
        return rmsnorm_quant_plain(x, gamma, k_mask, eps, a_bits, out_ind,
                                   out_mask)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    H = x.shape[-1]
    if x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError("x must be a contiguous bf16 tensor")
    expect = [(gamma, torch.float32, (H,), "gamma")]
    if k_mask is not None:
        expect.append((k_mask, torch.float32, (H,), "k_mask"))
    if (out_ind is None) != (out_mask is None):
        raise ValueError("out_ind and out_mask go together")
    if out_ind is not None:
        Bo = out_ind.shape[0]
        expect += [(out_ind, torch.int32, (Bo,), "out_ind"),
                   (out_mask, torch.float32, (Bo,), "out_mask")]
    for t, dt, shape, name in expect:
        if (t.device != x.device or t.dtype != dt
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {dt} {shape} "
                             f"tensor on {x.device}")
    lead = x.shape[:-1]
    M = x.numel() // H
    y = torch.empty_like(x)
    q_x = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    x_scale = torch.empty((*lead, 1), dtype=torch.float32, device=x.device)
    x_out = (None if out_ind is None else torch.empty(
        (*lead, out_ind.shape[0]), dtype=torch.bfloat16, device=x.device))
    if plan is None:
        aligned = all(t is None or t.data_ptr() % 16 == 0
                      for t in (x, gamma, k_mask))
        plan = plan_rmsnorm(H, aligned)
    if plan not in INSTANTIATIONS:
        raise ValueError(f"plan {plan} is not one of {INSTANTIATIONS}")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _launcher()(
        x.data_ptr(), gamma.data_ptr(), _ptr(k_mask), _ptr(out_ind),
        _ptr(out_mask), y.data_ptr(), q_x.data_ptr(), x_scale.data_ptr(),
        _ptr(x_out), M, H, 0 if out_ind is None else out_ind.shape[0],
        eps, float(2 ** (a_bits - 1) - 1), *plan, stream)
    _build.check(rc, "rmsnorm_quant")
    fused_rmsnorm_quant.launches += 1
    return y, q_x, x_scale, x_out


fused_rmsnorm_quant.launches = 0
