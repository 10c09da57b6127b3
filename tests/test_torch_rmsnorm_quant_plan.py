"""PyTorch port, kernel 1's launch plan on the CPU
(kernels/rmsnorm_quant.py::plan_rmsnorm): every (M, H) that the served
models, chip_smoke.py and the card tests give the kernel maps to an
instantiation that csrc/rmsnorm_quant.cu compiles, the served widths to the
register kernel (512 threads of one chunk each, at decode and prefill), and
every other width or an operand off 16-byte alignment to the looping
kernel. The plan
mirrors the source's constants, checked here against the source text."""
import re
from pathlib import Path

import pytest

from mixq_tpu_torch.kernels import rmsnorm_quant as RQ

SRC = (Path(RQ.__file__).resolve().parent.parent / "csrc"
       / "rmsnorm_quant.cu").read_text()
LLAMA, GEMMA, TINY = 4096, 3584, 256
# decode (generate's B=8, Mistral's ring step B=16, the timed B=64),
# prefill chunks (8 prompts x 16 tokens, 8 x 64), and phase 4's tiny models
# (3 prompts: chunks of 8 and 4, decode)
SERVED_M = (8, 16, 64, 128, 512)
TINY_M = (3, 12, 24)
CARD = [(1, 64), (7, 4096), (64, 4096), (5, 11008), (512, 4096), (8, 3584),
        (3, 1003), (2, 16384), (2, 28672), (9, 3584)]


def test_constants_match_the_source():
    assert f"constexpr int kChunk = {RQ.CHUNK};" in SRC
    compiled = {(int(t), int(c)) for t, c in re.findall(
        r"threads == (\d+) && chunks == (\d+)\) e = launch_", SRC)}
    assert compiled == set(RQ.INSTANTIATIONS)
    for threads, chunks in RQ.INSTANTIATIONS:
        if chunks:
            assert (f"launch_regs<{threads}, {chunks}>(MIXQ_ARGS)" in SRC)
            assert threads * chunks * RQ.CHUNK == RQ.REGS_MAX_H
        else:
            assert f"constexpr int kLoopThreads = {threads};" in SRC


@pytest.mark.parametrize("M", SERVED_M)
@pytest.mark.parametrize("H", [LLAMA, GEMMA])
def test_served_widths_take_the_register_kernel(M, H):
    threads, chunks = RQ.plan_rmsnorm(H)
    assert (threads, chunks) == (512, 1)
    assert (threads, chunks) in RQ.INSTANTIATIONS
    # every chunk of the row has a thread; at Gemma-2's width (448 chunks)
    # the last 64 threads hold none
    n = H // RQ.CHUNK
    assert (chunks - 1) * threads < n <= chunks * threads


@pytest.mark.parametrize("M,H", [(m, TINY) for m in TINY_M] + CARD)
def test_every_shape_maps_to_an_instantiation(M, H):
    plan = RQ.plan_rmsnorm(H)
    assert plan in RQ.INSTANTIATIONS
    register = H % RQ.CHUNK == 0 and H <= RQ.REGS_MAX_H
    assert (plan[1] > 0) == register
    # off 16-byte alignment, the looping kernel
    assert RQ.plan_rmsnorm(H, aligned=False) == (256, 0)


def test_block_size_on_both_sides_of_the_cut():
    """The register kernel up to its widest row, the looping kernel's
    256-thread block one chunk past it and at a width off the chunk."""
    cut = RQ.REGS_MAX_H
    assert RQ.plan_rmsnorm(cut) == (512, 1)
    assert RQ.plan_rmsnorm(cut + RQ.CHUNK) == (256, 0)
    assert RQ.plan_rmsnorm(cut - 1) == (256, 0)
    assert RQ.plan_rmsnorm(11008) == (256, 0)
