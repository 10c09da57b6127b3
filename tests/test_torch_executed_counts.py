"""PyTorch port: `kernels.executed_counts`, on the CPU.

A CUDA graph's replays run no Python, so the wrappers' launch counts miss
them; the card's executions are read from a profiler's kernel events by
name. Here: the demangled names the profiler gives the port's kernels (as
an H100 run of chip_smoke.py printed them) map to the launch-count keys of
`kernels.launch_counts()`, template arguments to modes; other kernels are
skipped; a name of one of the port's kernels that does not parse raises;
the keys a name cannot show (the GEMMs' epilogues, decode attention's ring,
both attentions' ALiBi slopes and head dim) are left out.
`kernels.block_events` keeps a card_trace window's block: the events
between its two spin kernels (a primer's before the first are left out).
"""
import types

import pytest
from torch.autograd import DeviceType

from mixq_tpu_torch import kernels

ANON = "void (anonymous namespace)::"


@pytest.mark.parametrize("name,keys", [
    (ANON + "mix_gemm_kernel<false, false>((anonymous namespace)::Args)",
     ["mix_gemm", "mix_gemm.w8a8"]),
    (ANON + "mix_gemm_kernel<false, true>((anonymous namespace)::Args)",
     ["mix_gemm", "mix_gemm.w8a8_grouped"]),
    (ANON + "mix_gemm_kernel<true, false>((anonymous namespace)::Args)",
     ["mix_gemm", "mix_gemm.w4"]),
    (ANON + "mix_gemm_kernel<true, true>((anonymous namespace)::Args)",
     ["mix_gemm", "mix_gemm.w4_grouped"]),
    (ANON + "w8a16_kernel<false, false>((anonymous namespace)::Args)",
     ["w8a16", "w8a16.w8"]),
    (ANON + "w8a16_kernel<true, true>((anonymous namespace)::Args)",
     ["w8a16", "w8a16.w4_grouped"]),
    (ANON + "flash_decode_kernel<1, true, false>((anonymous namespace)"
     "::Args)", ["flash_decode"]),
    (ANON + "flash_decode_kernel<2, true, true>((anonymous namespace)"
     "::Args)", ["flash_decode", "flash_decode.softcap"]),
    (ANON + "decode_attention_kernel<4, true, false>((anonymous "
     "namespace)::Args)", ["decode_attention", "decode_attention.int8"]),
    (ANON + "decode_attention_kernel<2, false, true>((anonymous "
     "namespace)::Args)", ["decode_attention", "decode_attention.bf16",
                           "decode_attention.softcap"]),
    # a group that is not a power of two is a mode of its own (head dim 96
    # is a runtime argument: kernels.UNNAMED)
    (ANON + "flash_decode_kernel<7, true, false>((anonymous namespace)"
     "::Args)", ["flash_decode", "flash_decode.g7"]),
    (ANON + "flash_decode_kernel<3, false, false>(Args)",
     ["flash_decode", "flash_decode.g3"]),
    (ANON + "decode_attention_kernel<7, false, false>((anonymous "
     "namespace)::Args)", ["decode_attention", "decode_attention.bf16",
                           "decode_attention.g7"]),
    (ANON + "decode_attention_kernel<6, true, false>(Args)",
     ["decode_attention", "decode_attention.int8", "decode_attention.g6"]),
    # MoE's expert-batched mode of kernel 2: one instantiation
    (ANON + "mix_gemm_experts_kernel((anonymous namespace)::Args)",
     ["mix_gemm", "mix_gemm.w8a8_experts"]),
    (ANON + "rmsnorm_quant_regs<512, 1>(__nv_bfloat16 const*, float "
     "const*)", ["rmsnorm_quant"]),
    (ANON + "rmsnorm_quant_loop(__nv_bfloat16 const*, float const*)",
     ["rmsnorm_quant"]),
])
def test_names_map_to_their_keys(name, keys):
    got = kernels.executed_counts([(name, 7)])
    assert {k: n for k, n in got.items() if n} == dict.fromkeys(keys, 7)


def test_counts_add_up_and_other_kernels_are_skipped():
    events = [
        (ANON + "mix_gemm_kernel<false, false>(Args)", 3),
        (ANON + "mix_gemm_kernel<true, false>(Args)", 4),
        ("void at::native::vectorized_elementwise_kernel<4, at::native::"
         "FillFunctor<int>>(int, FillFunctor<int>)", 100),
        ("Memcpy DtoH (Device -> Pageable)", 2),
        (ANON + "rmsnorm_quant_regs<512, 1>(x)", 5)]
    got = {k: n for k, n in kernels.executed_counts(events).items() if n}
    assert got == {"mix_gemm": 7, "mix_gemm.w8a8": 3, "mix_gemm.w4": 4,
                   "rmsnorm_quant": 5}


def test_keys_are_launch_counts_keys_but_the_unnamed():
    keys = set(kernels.executed_counts([]))
    assert keys == set(kernels.launch_counts()) - kernels.UNNAMED
    assert {"mix_gemm.gelu_new", "w8a16.silu", "decode_attention.ring",
            "decode_attention.alibi", "flash_decode.alibi",
            "flash_decode.d96", "decode_attention.d96"} <= kernels.UNNAMED
    assert not kernels.UNNAMED - set(kernels.launch_counts())


@pytest.mark.parametrize("name", [
    "_ZN12_GLOBAL__N_115mix_gemm_kernelILb0ELb0EEEvNS_4ArgsE",
    ANON + "flash_decode_kernel<1, 1, 0>(Args)"])
def test_a_kernel_of_the_port_that_does_not_parse_raises(name):
    with pytest.raises(ValueError, match="unknown name"):
        kernels.executed_counts([(name, 1)])


def _event(name, start, end, device=DeviceType.CUDA):
    return types.SimpleNamespace(
        name=name, device_type=device,
        time_range=types.SimpleNamespace(start=start, end=end))


class _Window:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


@pytest.mark.parametrize("spins,kept", [
    ([(10, 20), (90, 100)], ["block a", "block b"]),
    ([(90, 100)], ["primer", "block a", "block b", "after"]),
    ([], ["primer", "block a", "block b", "after"])])
def test_block_events_keep_the_block(spins, kept):
    """The events that start between the window's two spin kernels; with a
    spin record missing, every device event but the spins."""
    events = ([_event("primer", 0, 5)]
              + [_event(kernels.SPIN + "(long)", a, b) for a, b in spins]
              + [_event("block a", 30, 40), _event("block b", 50, 60),
                 _event("after", 110, 120),
                 _event("a host op", 35, 36, DeviceType.CPU)])
    got = [e.name for e in kernels.block_events(_Window(events))]
    assert got == kept


@pytest.mark.parametrize("spins,kept", [
    ([(10, 20), (90, 100)], [30]),
    ([(90, 100)], [1, 30, 105])])
def test_block_events_keep_the_blocks_host_ranges(spins, kept):
    """With host_range: the host ranges of that name that start between
    the two spin kernels (the primer's and later ones left out); with a
    spin record missing, every such range."""
    events = ([_event("range", 1, 4, DeviceType.CPU),
               _event("range", 2, 3)]              # its device annotation
              + [_event(kernels.SPIN + "(long)", a, b) for a, b in spins]
              + [_event("range", 30, 45, DeviceType.CPU),
                 _event("other", 31, 32, DeviceType.CPU),
                 _event("range", 105, 107, DeviceType.CPU)])
    got = kernels.block_events(_Window(events), host_range="range")
    assert [e.time_range.start for e in got] == kept
    assert all(e.device_type == DeviceType.CPU for e in got)
