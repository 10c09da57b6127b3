"""Build and load the port's CUDA kernels.

Each source in `mixq_tpu_torch/csrc/` is compiled by `nvcc` for sm_90a into
its own shared library with a plain C interface, loaded with `ctypes`
(no PyTorch headers, so a build takes seconds); the sources share the
headers beside them (`csrc/*.cuh`). `build_all()` starts one
`nvcc` per source, all at once, and waits for them. A library's file name
carries a hash of its source, the shared headers and the flags, so an
edited source or header is rebuilt and an unchanged one is reused. The build directory, `mixq_tpu_torch/build/`,
is listed in `.gitignore`.

Nothing here runs at import time: the CPU tests import every kernel module
on a machine with no `nvcc`.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable, NamedTuple, Optional, Sequence, Tuple

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
SOURCES = {
    "rmsnorm_quant": "rmsnorm_quant.cu",
    "mix_gemm": "mix_gemm.cu",
    "flash_decode": "flash_decode.cu",
    "w8a16": "w8a16.cu",
    "decode_attention": "decode_attention.cu",
}
# No --use_fast_math: quantization is round(x / scale), which needs IEEE
# division, and the softmax needs the accurate expf.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v",
]

BUILD_DIR = PKG_DIR / "build"

_LIBS: Dict[str, ctypes.CDLL] = {}
# seconds of each source's nvcc in this process's last build_all
NVCC_SECONDS: Dict[str, float] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda)")


def library_path(name: str) -> Path:
    src = (CSRC_DIR / SOURCES[name]).read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))
    h = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{h}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile every named kernel library that is not built yet, one `nvcc`
    process per source, all started together. Returns each library's
    `ptxas -v` report (registers, shared memory, spills) and records in
    NVCC_SECONDS each compiled source's seconds from the common start to
    its nvcc's end; raises with the compiler's output if any build
    fails."""
    names = list(names or SOURCES)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    reports = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            reports[name] = "(cached)"
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = tempfile.TemporaryFile("w+")    # a pipe could fill and block
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT, text=True),
                       log, tmp, out)
    failed = []
    while len(reports) < len(names):
        for name, (proc, log, tmp, out) in procs.items():
            if name in reports or proc.poll() is None:
                continue
            NVCC_SECONDS[name] = time.perf_counter() - t0
            log.seek(0)
            reports[name] = log.read()
            log.close()
            if proc.returncode != 0:
                failed.append(f"--- nvcc {SOURCES[name]} (rc "
                              f"{proc.returncode})\n{reports[name]}")
                continue
            os.replace(tmp, out)      # atomic: concurrent builders agree
        time.sleep(0.05)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a kernel's C entry point reported a CUDA error (its launch
    was refused or an attribute could not be set)."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


# ---------------------------------------------------------------------------
# Checks shared by the GEMM wrappers
# ---------------------------------------------------------------------------

# The epilogue activations, in the order of their codes in the kernels
# (csrc/epilogue.cuh: mixq::Epilogue).
FUSES = ("none", "silu", "gelu", "gelu_new")
# f32(sqrt(2/pi)) and f32(sqrt(1/2)), the constants of jax.nn.gelu
_SQRT_2_OVER_PI = float.fromhex("0x1.988454p-1")
_SQRT_HALF = float.fromhex("0x1.6a09e6p-1")


def check_fuse(fuse: str, what: str) -> int:
    """The kernels' code of an epilogue; raises for one they do not have."""
    if fuse not in FUSES:
        raise NotImplementedError(
            f"{what} fuse={fuse!r}: only {FUSES} are ported")
    return FUSES.index(fuse)


def apply_epilogue(y: torch.Tensor, fuse: str) -> torch.Tensor:
    """The plain version of the kernels' epilogue on the f32 result `y`, in
    jax.nn.gelu's order of operations (gelu: 0.5 y erfc(-y sqrt(1/2));
    gelu_new: y * 0.5 (1 + tanh(sqrt(2/pi) (y + 0.044715 y^3))))."""
    if fuse == "silu":
        return y * torch.sigmoid(y)
    if fuse == "gelu":
        return 0.5 * y * torch.special.erfc(-y * _SQRT_HALF)
    if fuse == "gelu_new":
        inner = _SQRT_2_OVER_PI * (y + 0.044715 * (y * y * y))
        return y * (0.5 * (1.0 + torch.tanh(inner)))
    return y


def require(t: torch.Tensor, dtype, shape, name: str, device) -> None:
    """Raise unless `t` is what a kernel takes: a contiguous, 16-byte
    aligned tensor of this dtype and shape on this device."""
    if (t.device != device or t.dtype != dtype or tuple(t.shape) != shape
            or not t.is_contiguous() or t.data_ptr() % 16):
        raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                         f"{dtype} {shape} tensor on {device}; got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def scale_groups(w_scale: torch.Tensor, K: int, what: str) -> int:
    """The number of K-groups G of a [N] (G = 1) or [G, N] weight scale,
    checked against what the GEMM kernels take: group_size = K / G a
    multiple of 16."""
    if w_scale.dim() == 1:
        return 1
    G = w_scale.shape[0]
    if G == 1:
        return 1
    if K % G or (K // G) % 16:
        raise ValueError(
            f"{what}: {G} scale groups over K={K} need group_size = K/G a "
            "multiple of 16")
    return G


# ---------------------------------------------------------------------------
# The split-K rule shared by the cluster GEMMs (kernels 2 and A, kernel B)
# ---------------------------------------------------------------------------

MAX_SPLITS = 8                  # a portable cluster holds at most 8 blocks


class SplitPlan(NamedTuple):
    """A cluster GEMM's launch plan (kernels/w8a16.py::plan_a16,
    kernels/mix_gemm.py::plan_mix)."""
    bm: int
    bn: int
    splits: int                # S: blocks (one cluster) per output tile
    stages: int                # depth of the cp.async ring
    stage_rows: int            # stored weight rows per stage (W4: packed)
    bounds: Tuple[Tuple[int, int], ...]   # each split's stored rows [a, b)
    blocks: int                # the grid: N-tiles x M-tiles x S


def split_size(tiles: int, chunks: int, sm_count: int,
               clusters: Optional[Sequence[int]] = None, per_sm: int = 2,
               sizes: Optional[Sequence[int]] = None) -> int:
    """The split rule of every cluster kernel: each of `tiles` tiles is
    split S ways, S the largest of `sizes` (by default 1..MAX_SPLITS), at
    most one of the tile's `chunks` a split, whose clusters of S blocks all
    fit on the card at once: `clusters[S - 1]` is how many the card holds
    (cudaOccupancyMaxActiveClusters), by default the kernel's `per_sm`
    blocks per SM packed perfectly (per_sm * sm_count // S). A second wave
    costs a whole block's time again, more than the shorter splits save.
    When the tiles alone fill the card, S = 1."""
    if clusters is None:
        clusters = [per_sm * sm_count // s
                    for s in range(1, MAX_SPLITS + 1)]
    if sizes is None:
        sizes = range(1, MAX_SPLITS + 1)
    return max([s for s in sizes
                if s <= chunks and tiles <= clusters[s - 1]], default=1)


def split_k(tiles: int, stages: int, sm_count: int,
            clusters: Optional[Sequence[int]] = None, per_sm: int = 2
            ) -> Tuple[int, Tuple[Tuple[int, int], ...]]:
    """How a cluster GEMM splits K, and each split's stages [first, end).

    The output tiles come first; K is then split S ways by `split_size`'s
    rule, the stages being the chunks. The `stages` stages split as
    stages // S, one more for the first stages % S splits, as the kernels
    compute them."""
    S = split_size(tiles, stages, sm_count, clusters, per_sm)
    base, extra = divmod(stages, S)
    bounds = []
    for z in range(S):
        first = z * base + min(z, extra)
        bounds.append((first, first + base + (z < extra)))
    return S, tuple(bounds)


@functools.cache
def sm_count(index: int) -> int:
    """The SMs of CUDA device `index`."""
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def cluster_table(lib: str, symbol: str, index: int,
                  *mode: int) -> Tuple[int, ...]:
    """How many clusters of 1..MAX_SPLITS blocks of a cluster GEMM device
    `index` holds at once (cudaOccupancyMaxActiveClusters), from the
    library's export `int symbol(int splits, int *mode, int* n)`, which
    returns the CUDA error. A 0 would mean that plan cannot launch."""
    fn = getattr(load(lib), symbol)
    fn.argtypes = [ctypes.c_int] * (1 + len(mode)) + [
        ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = []
    with torch.cuda.device(index):
        for s in range(1, MAX_SPLITS + 1):
            n = ctypes.c_int(0)
            check(fn(s, *mode, ctypes.byref(n)), symbol)
            out.append(n.value)
    return tuple(out)
