"""Wrapper, build and launch counters of the hand-written ``mips_topk`` CUDA kernel.

:func:`mips_topk` takes the tensors' device as the choice: CPU tensors go to
the plain version (``ref.py``); CUDA tensors launch the two kernel passes of
``csrc/mips_topk.cu`` (or raise). The kernel is compiled by ``nvcc`` for
``sm_90a`` at first use into ``build/repro_torch_kernels/`` at the root of the
checkout, and loaded with ``ctypes``. Each pass's wrapper adds one to its
entry of :data:`LAUNCHES` where it launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from repro_torch.kernels.mips_topk.ref import mips_topk_ref

MAX_K = 64  # kMaxK in csrc/mips_topk.cu
MAX_D = 1024  # kMaxD
_BQ = 32  # query slots per CTA (kBQ)
_TILE_R = 64  # corpus rows per tile (kTileR); splits are a multiple of it
_CTAS_PER_SM = 4

_SRC = Path(__file__).resolve().parent / "csrc" / "mips_topk.cu"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "repro_torch_kernels"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Launches per pass since the last reset_launches().
LAUNCHES: dict[str, int] = {"mips_topk_select": 0, "mips_topk_merge": 0}

_lib: ctypes.CDLL | None = None


def reset_launches() -> None:
    """Set every launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the mips_topk CUDA kernel cannot be built here")


def nvcc_version() -> str:
    """The release line of ``nvcc --version``."""
    out = subprocess.run([_nvcc(), "--version"], capture_output=True, text=True, check=True)
    return next((ln.strip() for ln in out.stdout.splitlines() if "release" in ln), out.stdout)


def build() -> tuple[Path, float, str]:
    """Compile the kernel if its library is missing. Returns (library path,
    build seconds (0.0 when it was already built), nvcc's output)."""
    src = _SRC.read_bytes()
    lib = BUILD_DIR / f"libmips_topk_{hashlib.sha256(src).hexdigest()[:16]}.so"
    if lib.exists():
        return lib, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_SRC)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib, time.perf_counter() - t0, proc.stdout + proc.stderr


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        path, _, _ = build()
        lib = ctypes.CDLL(str(path))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mips_topk_select.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, p]
        lib.mips_topk_select.restype = i
        lib.mips_topk_merge.argtypes = [p, p, p, p, i, i, i, p]
        lib.mips_topk_merge.restype = i
        _lib = lib
    return _lib


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")


def _validate(queries, corpus, k, n_valid, mask) -> int:
    """Checks of ``mips_topk_pallas`` (kernel.py:155-203) plus this kernel's
    limits. Returns the number of corpus rows to scan."""
    if queries.ndim != 2 or corpus.ndim != 2:
        raise ValueError(f"queries (Q, D) and corpus (N, D) expected, got "
                         f"{tuple(queries.shape)} and {tuple(corpus.shape)}")
    (q_n, d), (n, d_c) = queries.shape, corpus.shape
    if d != d_c:
        raise ValueError(f"query width {d} != corpus width {d_c}")
    if q_n < 1 or n < 1 or d < 1:
        raise ValueError(f"empty input: Q={q_n}, N={n}, D={d}")
    if queries.dtype != corpus.dtype or queries.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"queries and corpus must both be float32 or bfloat16, got "
                        f"{queries.dtype} and {corpus.dtype}")
    if queries.device != corpus.device:
        raise ValueError(f"queries on {queries.device} but corpus on {corpus.device}")
    if not (queries.is_contiguous() and corpus.is_contiguous()):
        raise ValueError("queries and corpus must be contiguous")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} must be in [1, {MAX_K}]")
    if d > MAX_D:
        raise ValueError(f"D={d} exceeds the kernel's limit of {MAX_D}")
    if mask is not None and n_valid is not None:
        raise ValueError("pass n_valid or mask, not both")
    if mask is not None:
        if mask.shape != (n,) or mask.dtype != torch.float32:
            raise ValueError(f"mask must be ({n},) float32, got {tuple(mask.shape)} {mask.dtype}")
        if mask.device != corpus.device or not mask.is_contiguous():
            raise ValueError("mask must be contiguous and on the corpus's device")
        return n
    n_valid = n if n_valid is None else n_valid
    if not 0 < n_valid <= n:
        raise ValueError(f"n_valid={n_valid} must be in (0, {n}]")
    if k > n_valid:
        raise ValueError(f"k={k} > corpus size {n_valid}")
    return n_valid


def split_rows(n_q: int, n_rows: int, device: torch.device) -> tuple[int, int]:
    """(rows_per_split, splits): enough CTAs for a few per SM, each a
    contiguous multiple of the 64-row tile."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    target = max(1, (_CTAS_PER_SM * sms) // math.ceil(n_q / _BQ))
    rows = max(_TILE_R, math.ceil(math.ceil(n_rows / target) / _TILE_R) * _TILE_R)
    return rows, math.ceil(n_rows / rows)


def select_pass(queries, corpus, k, *, n_valid=None, mask=None):
    """Launch pass 1 on CUDA tensors → (cand_v (Q, S, k), cand_i (Q, S, k), rows_per_split)."""
    n_rows = _validate(queries, corpus, k, n_valid, mask)
    if queries.device.type != "cuda":
        raise RuntimeError("select_pass launches the CUDA kernel and needs CUDA tensors")
    lib = _load()
    q_n, d = queries.shape
    rows, splits = split_rows(q_n, n_rows, queries.device)
    cand_v = torch.empty((q_n, splits, k), dtype=torch.float32, device=queries.device)
    cand_i = torch.empty((q_n, splits, k), dtype=torch.int32, device=queries.device)
    stream = torch.cuda.current_stream(queries.device).cuda_stream
    err = lib.mips_topk_select(
        queries.data_ptr(), corpus.data_ptr(), mask.data_ptr() if mask is not None else None,
        cand_v.data_ptr(), cand_i.data_ptr(), q_n, n_rows, d, k, rows, splits,
        0 if queries.dtype == torch.float32 else 1, stream,
    )
    _check(err, "mips_topk_select")
    LAUNCHES["mips_topk_select"] += 1
    return cand_v, cand_i, rows


def merge_pass(cand_v: torch.Tensor, cand_i: torch.Tensor, k: int):
    """Launch pass 2 on CUDA tensors: (Q, S, k) candidates → (Q, k) scores and ids."""
    if cand_v.device.type != "cuda" or cand_i.device != cand_v.device:
        raise RuntimeError("merge_pass launches the CUDA kernel and needs CUDA tensors")
    if cand_v.dtype != torch.float32 or cand_i.dtype != torch.int32:
        raise TypeError("candidates must be float32 scores and int32 ids")
    if cand_v.shape != cand_i.shape or not (cand_v.is_contiguous() and cand_i.is_contiguous()):
        raise ValueError("candidate scores and ids must be contiguous and of one shape")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} must be in [1, {MAX_K}]")
    q_n = cand_v.shape[0]
    width = cand_v[0].numel()
    if width < k:
        raise ValueError(f"{width} candidates per query < k={k}")
    lib = _load()
    out_v = torch.empty((q_n, k), dtype=torch.float32, device=cand_v.device)
    out_i = torch.empty((q_n, k), dtype=torch.int32, device=cand_v.device)
    stream = torch.cuda.current_stream(cand_v.device).cuda_stream
    err = lib.mips_topk_merge(
        cand_v.data_ptr(), cand_i.data_ptr(), out_v.data_ptr(), out_i.data_ptr(),
        q_n, width, k, stream,
    )
    _check(err, "mips_topk_merge")
    LAUNCHES["mips_topk_merge"] += 1
    return out_v, out_i


def mips_topk(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    k: int,
    *,
    n_valid: int | None = None,
    mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact MIPS top-k: (Q, D) × (N, D) → ((Q, k) float32 descending, (Q, k) int32).

    ``n_valid`` scans only the first ``n_valid`` rows; ``mask`` (N,) float32
    drops rows with ``mask <= 0``. Equal scores resolve to the lower id. CUDA
    tensors launch the kernel (one launch per pass for all rows); CPU
    tensors use the plain version.
    """
    if queries.device.type == "cuda":
        cand_v, cand_i, _ = select_pass(queries, corpus, k, n_valid=n_valid, mask=mask)
        return merge_pass(cand_v, cand_i, k)
    _validate(queries, corpus, k, n_valid, mask)
    if queries.device.type != "cpu":
        raise RuntimeError(f"mips_topk runs on CUDA or CPU tensors, not {queries.device}")
    return mips_topk_ref(queries, corpus, k, n_valid=n_valid, mask=mask)
