"""FMA-throughput probe: ``inner * 64`` fused multiply-adds per lane over 8
independent accumulator chains, the measure of the card's attainable
floating-point rate in the roofline (:mod:`dcol_tpu_torch.tools.roofline`).

Port of the Pallas kernel in ``tools/roofline.py::peak``.  The operands are
x (10, L): rows 0-7 start the 8 chains, row 8 is b, row 9 is c; each pass
applies ``acc = acc * b + c`` 8 times to every chain, and the result is
out (L,) = the sum of the 8 chains.

* :func:`fma_chains` is the plain PyTorch version (the same recurrence on an
  (8, L) tensor), for any device;
* :func:`fma_chains_cuda` launches the hand-written kernel
  (``csrc/fma_peak.cu``, built with nvcc at first use, see
  :mod:`dcol_tpu_torch.ops.nvcc_build`) and takes CUDA tensors only;
* :func:`closed_form` is the exact result, a b^n + c (1 - b^n) / (1 - b)
  with n = 8 * inner per chain, in float64.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
from typing import Tuple

import torch

from dcol_tpu_torch.ops import nvcc_build
from dcol_tpu_torch.ops.nvcc_build import Build

SOURCE = os.path.join(nvcc_build.CSRC, "fma_peak.cu")
FMAS_PER_PASS = 64

# Kernel launches made by fma_chains_cuda.
launches = 0

_CTYPE = {torch.float32: "float", torch.float64: "double"}


def _check(x: torch.Tensor, inner: int) -> None:
    if x.dim() != 2 or x.shape[0] != 10:
        raise ValueError(f"x must be (10, L), got {tuple(x.shape)}")
    if x.dtype not in _CTYPE:
        raise TypeError(f"FMA probe supports float32/float64, got {x.dtype}")
    if inner < 0:
        raise ValueError(f"inner must be >= 0, got {inner}")


def fma_chains(x: torch.Tensor, inner: int = 200) -> torch.Tensor:
    """Plain version: x (10, L) -> (L,)."""
    _check(x, inner)
    acc, b, c = x[:8].clone(), x[8], x[9]
    for _ in range(8 * inner):
        acc = torch.addcmul(c, acc, b)
    return ((acc[0] + acc[1]) + (acc[2] + acc[3])) + \
        ((acc[4] + acc[5]) + (acc[6] + acc[7]))


def closed_form(x: torch.Tensor, inner: int = 200) -> torch.Tensor:
    """Exact sum of the 8 chains after 8 * inner steps, in float64 (from
    x's values as stored, so f32 inputs are their rounded values)."""
    x = x.double()
    n = 8 * inner
    b, c = x[8], x[9]
    bn = b ** n
    return x[:8].sum(0) * bn + 8.0 * c * (1.0 - bn) / (1.0 - b)


def build(dtype) -> Build:
    """Compile (or find in the cache) the probe for one dtype."""
    if dtype not in _CTYPE:
        raise TypeError(f"FMA probe supports float32/float64, got {dtype}")
    t = _CTYPE[dtype]
    return nvcc_build.build(("fma_peak", dtype), SOURCE, f"fma_peak_{t}",
                            [f"-DDCOL_T={t}"])


def _lib(dtype) -> ctypes.CDLL:
    def bind(lib: ctypes.CDLL) -> None:
        lib.dcol_fma_type_size.argtypes = []
        lib.dcol_fma_type_size.restype = ctypes.c_int
        lib.dcol_fma_chains.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_int, ctypes.c_int,
                                        ctypes.c_void_p]
        lib.dcol_fma_chains.restype = ctypes.c_int
        if lib.dcol_fma_type_size() != torch.finfo(dtype).bits // 8:
            raise RuntimeError(f"library {lib._name} was built for another "
                               f"dtype than {dtype}")

    return nvcc_build.load(build(dtype), bind)


def fma_chains_cuda(x: torch.Tensor, inner: int = 200) -> torch.Tensor:
    """The kernel: x (10, L) on the card -> (L,).  Raises on anything it
    cannot run (a CPU tensor, a dtype, a build or launch error)."""
    global launches
    _check(x, inner)
    if not x.is_cuda:
        raise ValueError("fma_chains_cuda takes CUDA tensors only; CPU "
                         "tensors go to fma_chains")
    lib = _lib(x.dtype)
    x = x.contiguous()
    L = x.shape[1]
    out = torch.empty((L,), dtype=x.dtype, device=x.device)
    if L == 0:
        return out
    rc = lib.dcol_fma_chains(x.data_ptr(), out.data_ptr(), L, int(inner),
                             torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"FMA probe launch failed: cudaError {rc} "
                           f"(L={L}, {x.dtype})")
    launches += 1
    return out


def sass_fma_count(dtype) -> Tuple[int, int]:
    """(FMAs in the pass loop's body, FMAs in the whole kernel), read from
    ``cuobjdump -sass`` of the built library: FFMA for float32, DFMA for
    float64.  The loop body is the span of the kernel's backward branch."""
    b = build(dtype)
    tool = os.path.join(os.path.dirname(nvcc_build.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", b.path], capture_output=True,
                          text=True, check=True).stdout
    op = "FFMA" if dtype == torch.float32 else "DFMA"
    insts = []  # (address, text)
    for ln in sass.splitlines():
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", ln)
        if m:
            insts.append((int(m.group(1), 16), m.group(2)))
    total = sum(1 for _, t in insts if re.search(rf"\b{op}\b", t))
    body = 0
    for addr, t in insts:
        m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", t)
        if m and int(m.group(1), 16) < addr:
            lo = int(m.group(1), 16)
            body = max(body, sum(1 for a, u in insts if lo <= a <= addr and
                                 re.search(rf"\b{op}\b", u)))
    return body, total
