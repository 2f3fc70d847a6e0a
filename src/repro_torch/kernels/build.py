"""Build and load the port's CUDA kernels.

The sources under ``csrc/`` are compiled with ``nvcc`` for ``sm_90a``
(one ``nvcc -c`` per source, all started together) and linked into one
shared library with a plain C interface, which ``ctypes`` loads.  The
library is built at first use into ``build/repro_torch_kernels/`` at the
root of the checkout, under a name that hashes the sources and flags, so
an edited source rebuilds and an unchanged one is reused.

Every C entry returns ``cudaGetLastError()``; :func:`check` raises on a
non-zero code.  Each kernel wrapper counts its launches in
:data:`launch_counts`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("sparse_row_gather.cu", "sparse_row_scatter.cu", "knn_topk.cu",
           "serving_topn.cu", "knn_topk_dtiled.cu", "serving_rows.cu",
           "decayed_scatter.cu", "flash_attention.cu",
           "flash_attention_wgmma.cu", "flash_attention_bwd.cu")
HEADERS = ("topk_common.cuh", "knn_ring.cuh", "mma_bf16.cuh")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C signature of every entry point (all return cudaError_t as int)
SIGNATURES: Dict[str, List] = {
    "srg_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "srs_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "knn_topk_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _L, _I,
                        _I, _I, _I, _I, _P, _P, _P, _P, _P],
    "blend_topn_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _I, _I,
                          _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                          _P, _P, _P],
    "knn_topk_dtiled_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                               _I, _I, _I, _I, _L, _L, _I, _I, _I, _I,
                               _P, _P, _I, _I, _P, _P, _P, _P, _P],
    "blend_rows_launch": [_P, _L, _P, _P, _L, _P, _I, _P, _I, _I, _I, _I,
                          _I, _F, _F, _I, _I, _I, _P, _I, _I, _P, _P, _P,
                          _P, _P],
    "decayed_scatter_launch": [_P, _P, _P, _I, _I, _I, _I, _P],
    "flash_attention_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                               _L, _L, _L, _L, _L, _L, _L, _L, _L, _F, _I,
                               _I, _I, _I, _P],
    "flash_wgmma_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _L, _L,
                           _L, _L, _L, _L, _L, _L, _F, _I, _I, _I, _I, _P],
    "flash_attention_bwd_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                   _I, _I, _I, _I, _L, _L, _L, _L, _L, _L,
                                   _L, _L, _L, _L, _L, _L, _F, _I, _I, _I,
                                   _I, _I, _I, _I, _P],
}

# launches per kernel wrapper since the last reset_launch_counts()
launch_counts: Dict[str, int] = {"sparse_row_gather": 0,
                                 "sparse_row_scatter": 0,
                                 "knn_topk": 0, "blend_topn_onehot": 0,
                                 "knn_topk_dtiled": 0,
                                 "knn_topk_dtiled_f32": 0,
                                 "blend_topn_rows_quant": 0,
                                 "blend_topn_rows": 0,
                                 "decayed_scatter": 0,
                                 "flash_attention": 0,
                                 "flash_attention_bwd": 0}

_lib: Optional[ctypes.CDLL] = None
last_build_log = ""


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    for name in launch_counts:
        launch_counts[name] = 0


def count_launch(name: str) -> None:
    """Record one launch of kernel ``name`` (called by its wrapper)."""
    launch_counts[name] += 1


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit (PATH or CUDA_HOME)")


def _digest(flags: List[str]) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile the sources (if needed) and return the library's path.

    ``verbose`` adds ``-Xptxas -v`` (registers, shared memory and spills
    per kernel) and keeps the compiler output in :data:`last_build_log`,
    and in a ``.log`` file beside the library, which a later call reads
    back when the library is already built.
    """
    global last_build_log
    flags = NVCC_FLAGS + (["-Xptxas", "-v"] if verbose else [])
    lib_path = BUILD_DIR / f"librepro_torch_kernels-{_digest(NVCC_FLAGS)}.so"
    log_path = lib_path.with_suffix(".log")
    if lib_path.exists():
        if verbose and log_path.exists():
            last_build_log = log_path.read_text()
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, Path(s).stem + ".o") for s in SOURCES]
        procs = [subprocess.Popen([nvcc, *flags, "-c", str(CSRC / s),
                                   "-o", o], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(SOURCES, objs)]
        logs = [p.communicate()[0] for p in procs]
        failed = [s for s, p in zip(SOURCES, procs) if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed on " + ", ".join(failed) + ":\n"
                               + "\n".join(logs))
        tmp_lib = os.path.join(tmp, "lib.so")
        link = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", *objs,
                               "-o", tmp_lib], capture_output=True,
                              text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout
                               + link.stderr)
        os.replace(tmp_lib, lib_path)
    last_build_log = "".join(logs)
    if verbose:
        log_path.write_text(last_build_log)
    return lib_path


def load(path: Path) -> ctypes.CDLL:
    """Load a built library and declare every entry's C signature."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def library(verbose: bool = False) -> ctypes.CDLL:
    """The loaded kernel library, built at first use (see :func:`build`
    for ``verbose``)."""
    global _lib
    if _lib is None:
        _lib = load(build(verbose))
    return _lib


def check(code: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


def stream_of(t: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on ``t``'s device (the raw
    getter where PyTorch has it: no Stream object a call)."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(t.device.index)
    return torch.cuda.current_stream(t.device).cuda_stream


def cuda_input(t: torch.Tensor, what: str, dtypes: Sequence[torch.dtype],
               device: Optional[torch.device] = None,
               ndim: Optional[int] = None,
               pitched: bool = False) -> torch.Tensor:
    """Check one kernel input: a contiguous CUDA tensor of an accepted
    dtype (and rank), on ``device`` when given.  ``pitched`` also takes
    a 2-D tensor whose rows are contiguous at a row pitch of at least
    its width (a ``[:, :n]`` view of a wider buffer).  Raises
    otherwise."""
    if not isinstance(t, torch.Tensor) or not t.is_cuda:
        raise ValueError(f"{what}: the CUDA kernel takes CUDA tensors, "
                         f"got {getattr(t, 'device', type(t))}")
    if device is not None and t.device != device:
        raise ValueError(f"{what}: on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{what}: dtype {t.dtype} not in {list(dtypes)}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{what}: expected {ndim} dims, got {t.dim()}")
    if pitched and t.dim() == 2:
        if t.shape[1] > 1 and t.stride(1) != 1 or \
                t.shape[0] > 1 and t.stride(0) < t.shape[1]:
            raise ValueError(f"{what}: rows must be contiguous")
    elif not t.is_contiguous():
        raise ValueError(f"{what}: must be contiguous")
    return t


INDEX_DTYPES = (torch.int32, torch.int64)


def index_as_given(t: torch.Tensor, what: str, device: torch.device,
                   ndim: int) -> torch.Tensor:
    """Check an index input (int32 or int64) and return it contiguous in
    its own dtype: no cast, and no copy when it is contiguous already.
    Checks dtype, rank and device only, so nothing waits on the card."""
    if isinstance(t, torch.Tensor) and not t.is_contiguous():
        t = t.contiguous()
    return cuda_input(t, what, INDEX_DTYPES, device, ndim)


def index_bits(rows: torch.Tensor, ids: torch.Tensor) -> int:
    """The sparse pair's C index flag: bit 0 for int64 ``rows``, bit 1
    for int64 ``ids`` (each else int32)."""
    return int(rows.dtype == torch.int64) | int(ids.dtype == torch.int64) << 1


def index_input(t: torch.Tensor, what: str, device: torch.device,
                ndim: int) -> torch.Tensor:
    """Check an index input (int32 or int64) and return it as a
    contiguous int32 tensor."""
    return index_as_given(t, what, device, ndim).to(torch.int32)
