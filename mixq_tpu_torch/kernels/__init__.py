"""The port's hand-written CUDA kernels, one module per CUDA source.

Each wrapper launches its kernel for CUDA tensors (or raises) and runs the
module's plain PyTorch version only for CPU tensors. Each keeps a plain
integer count of its launches in its `launches` attribute, and a wrapper
with several modes also counts them by mode in `mode_launches` (the GEMMs
by weight mode and by epilogue, flash decode its softcap and ALiBi
launches, decode attention its KV type, ring, softcap and ALiBi launches),
so a run can show that the main path went through the kernels, in the
modes it expects.

The counts are the wrappers' launches: an eager launch, and a launch
recorded into a CUDA graph while it is captured, count once each. A
graph's replays run no Python and are not counted; what the card executed
is read from a profiler's kernel events by name (`executed_counts`), in
a window that `card_trace` opens.
"""
import contextlib
import re
import time
from typing import Optional

import torch

from mixq_tpu_torch.kernels import (decode_attention, flash_decode, mix_gemm,
                                    rmsnorm_quant, w8a16)

# name -> the kernel's module (wrapper, plain version, SOURCE, REPLACES)
MODULES = {
    "rmsnorm_quant": rmsnorm_quant,
    "mix_gemm": mix_gemm,
    "w8a16": w8a16,
    "flash_decode": flash_decode,
    "decode_attention": decode_attention,
}
WRAPPERS = {
    "rmsnorm_quant": rmsnorm_quant.fused_rmsnorm_quant,
    "mix_gemm": mix_gemm.mix_gemm,
    "w8a16": w8a16.mix_gemm_a16,
    "flash_decode": flash_decode.flash_decode_attention,
    "decode_attention": decode_attention.decode_attention,
}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
        modes = getattr(fn, "mode_launches", None)
        if modes is not None:
            for mode in modes:
                modes[mode] = 0


def launch_counts() -> dict:
    """{kernel: launches} and, for a kernel with modes, {"kernel.mode":
    launches} for each mode."""
    out = {}
    for name, fn in WRAPPERS.items():
        out[name] = fn.launches
        for mode, n in getattr(fn, "mode_launches", {}).items():
            out[f"{name}.{mode}"] = n
    return out


# each wrapper's kernels as a profiler names them (demangled), with the
# template arguments that carry a mode: <W4, GROUPED> of the GEMMs, <W4> of
# the zero-point GEMM, <G, int8, softcap> of the decode attentions
_SYMBOL = re.compile(
    r"\b(?:(?P<gemm>mix_gemm|w8a16)_kernel<(?P<w4>true|false), "
    r"(?P<grouped>true|false)>"
    r"|(?P<zp>mix_gemm)_zp_kernel<(?P<zp_w4>true|false)>"
    r"|(?P<attn>flash_decode|decode_attention)_kernel<\d+, "
    r"(?P<int8>true|false), (?P<softcap>true|false)>"
    r"|(?P<norm>rmsnorm_quant)_(?:regs|loop)\b)")
_BASES = ("mix_gemm_kernel", "mix_gemm_zp_kernel", "w8a16_kernel",
          "flash_decode_kernel", "decode_attention_kernel",
          "rmsnorm_quant_regs", "rmsnorm_quant_loop")
# the launch-count keys a kernel's name does not show: the GEMMs'
# epilogues, decode attention's ring and both attentions' ALiBi slopes are
# runtime arguments
UNNAMED = frozenset([f"mix_gemm.{e}" for e in mix_gemm.EPILOGUES]
                    + [f"w8a16.{e}" for e in w8a16.EPILOGUES]
                    + ["decode_attention.ring", "decode_attention.alibi",
                       "flash_decode.alibi"])


def _keys_of(m) -> list:
    if m["zp"]:
        return ["mix_gemm", "mix_gemm." + mix_gemm._mode(
            m["zp_w4"] == "true", 1, zp=True)]
    if m["gemm"]:
        mod = mix_gemm if m["gemm"] == "mix_gemm" else w8a16
        return [m["gemm"], m["gemm"] + "." + mod._mode(
            m["w4"] == "true", 2 if m["grouped"] == "true" else 1)]
    if m["attn"] == "flash_decode":
        return ["flash_decode"] + (["flash_decode.softcap"]
                                   if m["softcap"] == "true" else [])
    if m["attn"]:
        return (["decode_attention", "decode_attention."
                 + ("int8" if m["int8"] == "true" else "bf16")]
                + (["decode_attention.softcap"] if m["softcap"] == "true"
                   else []))
    return ["rmsnorm_quant"]


# the kernel of torch.cuda._sleep, which card_trace runs around the block
SPIN = "spin_kernel"


@contextlib.contextmanager
def card_trace(pause: float = 0.05, primer=None, cpu: bool = False):
    """A torch.profiler window (device activity; with `cpu`, the host's
    too, so a device event can be read under the host range that launched
    it) over the block, yielding the profiler. Before and after the block
    the card is synchronized, a spin kernel (SPIN) runs and the host
    pauses `pause` seconds: windows on the H100 that opened and closed
    right at their work lost kernels (the last ~3 ms of a graph replay;
    four of 8 eager steps'), and some windows with 50 ms pauses still lost
    the first kernels of their block (the first kernel-1 and kernel-2
    runs: one and up to three). `primer`, when given, runs inside the
    window before the first spin kernel, so that such a loss falls on its
    launches; a reader then takes only the block's events
    (`block_events`)."""
    from torch.profiler import ProfilerActivity, profile

    def margin():
        torch.cuda.synchronize()
        torch.cuda._sleep(1 << 22)
        torch.cuda.synchronize()
        time.sleep(pause)

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU]
                                            if cpu else [])
    with profile(activities=activities) as prof:
        if primer is not None:
            primer()
        margin()
        yield prof
        margin()


def block_events(prof, host_range: Optional[str] = None) -> list:
    """The device events of a card_trace window's block: those that start
    between its two spin kernels; every device event but the spins when
    the window does not hold exactly two. With `host_range`, the host
    ranges of that name (record_function; a window traced with `cpu`)
    that start there instead: the profiler puts both on one clock, and
    the block's host work starts a pause after the first spin ends."""
    from torch.autograd import DeviceType

    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spins = sorted((e.time_range.start, e.time_range.end) for e in events
                   if SPIN in e.name)
    rest = [e for e in events if SPIN not in e.name]
    if host_range is not None:
        rest = [e for e in prof.events() if e.name == host_range
                and e.device_type == DeviceType.CPU]
    if len(spins) != 2:
        return rest
    lo, hi = spins[0][1], spins[1][0]
    return [e for e in rest if lo <= e.time_range.start <= hi]


def executed_counts(events) -> dict:
    """The port's kernels that ran on the card, from (kernel name, count)
    pairs of a profiler's device events: {key: executions} over the keys
    of launch_counts() that a kernel's name shows (all but UNNAMED). Other
    kernels are skipped; a name of one of the port's kernels that does not
    parse raises ValueError."""
    out = dict.fromkeys((k for k in launch_counts() if k not in UNNAMED), 0)
    for name, n in events:
        m = _SYMBOL.search(name)
        if m is None:
            if any(b in name for b in _BASES):
                raise ValueError(f"a kernel of the port's with an unknown "
                                 f"name: {name!r}")
            continue
        for key in _keys_of(m):
            out[key] += n
    return out
