"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled for Hopper (``sm_90a``) by ``nvcc`` at first
use, one process per source started together, and linked into one shared
library with a plain C interface that ``ctypes`` loads. The library's file
name carries a hash of the sources and flags, so an edited source rebuilds
and a fresh checkout builds from its own sources alone. The build goes to
``build/`` at the repository root; ``ptxas`` reports each kernel's
registers, shared memory and spills into ``build/<hash>/ptxas.txt``.

Nothing here runs at import: the CPU tests import every module, and the CPU
has no compiler and no card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
SMEM_LIMIT = 227 * 1024    # dynamic shared memory a Hopper block may use
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_ptxas_log = ""

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # q, k_pool, v_pool, k_scale, v_scale, tables, lengths, acc, m, d, out,
    # B, Hq, Hkv, D, BS, Wp, T, S, spl, q_dtype, kv_dtype, intmax, stream
    "smx_paged_decode": ([_P] * 11 + [_I] * 12 + [_P], _I),
    # q, k_pool, v_pool, k_scale, v_scale, tables, lengths, out,
    # B, Hq, Hkv, D, BS, nb, q_dtype, kv_dtype, intmax, stream
    "smx_paged_decode_single": ([_P] * 8 + [_I] * 9 + [_P], _I),
    # q, k_pool, v_pool, k_scale, v_scale, tables, q_pos0, out,
    # B, Hq, Hkv, Sq, D, BS, Wp, BQ, q_dtype, kv_dtype, intmax, stream
    "smx_paged_prefill": ([_P] * 8 + [_I] * 11 + [_P], _I),
    # q, k_pool, v_pool, tables, q_pos0, out, B, Hq, Hkv, Sq, D, BS, Wp, N,
    # intmax, stream
    "smx_paged_prefill_tc": ([_P] * 6 + [_I] * 9 + [_P], _I),
    # q, k, v, out, m, d, B, Hq, Hkv, Sq, Sk, D, BQ, dtype, causal, intmax,
    # stream
    "smx_flash_fwd": ([_P] * 6 + [_I] * 10 + [_P], _I),
    # q, k, v, dout, m, d, delta, dk, dv, B, Hq, Hkv, Sq, Sk, D, dtype,
    # causal, stream
    "smx_flash_bwd_dkv": ([_P] * 9 + [_I] * 8 + [_P], _I),
    # q, k, v, dout, m, d, delta, dq, B, Hq, Hkv, Sq, Sk, D, BQ, dtype,
    # causal, stream
    "smx_flash_bwd_dq": ([_P] * 8 + [_I] * 9 + [_P], _I),
    # q, k, v, out, m, d, B, Hq, Hkv, Sq, Sk, D, causal, intmax, stream
    "smx_flash_fwd_tc": ([_P] * 6 + [_I] * 8 + [_P], _I),
    # q, k, v, dout, m, d, delta, dk, dv, B, Hq, Hkv, Sq, Sk, D, causal,
    # stream
    "smx_flash_bwd_dkv_tc": ([_P] * 9 + [_I] * 7 + [_P], _I),
    # q, k, v, dout, m, d, delta, dq, B, Hq, Hkv, Sq, Sk, D, causal, stream
    "smx_flash_bwd_dq_tc": ([_P] * 8 + [_I] * 7 + [_P], _I),
    # q, k, v, lengths, acc, m, d, out, B, Hq, Hkv, S, D, lane_rows, n_split,
    # q_dtype, kv_dtype, intmax, stream
    "smx_decode": ([_P] * 8 + [_I] * 10 + [_P], _I),
    # q, k, v, lengths, acc, m, d, tickets, out, B, Hq, Hkv, S, D,
    # lane_rows, n_split, q_dtype, kv_dtype, intmax, stream
    "smx_decode_bulk": ([_P] * 9 + [_I] * 10 + [_P], _I),
    # x, out, rows, V, dtype, intmax, stream
    "smx_softermax_rows": ([_P] * 2 + [_I] * 4 + [_P], _I),
    "smx_softermax_rows_reg": ([_P] * 2 + [_I] * 4 + [_P], _I),
    # x, out, rows, V, dtype, stream
    "smx_softermax_quant": ([_P] * 2 + [_I] * 3 + [_P], _I),
    "smx_softermax_quant_reg": ([_P] * 2 + [_I] * 3 + [_P], _I),
    "smx_paged_decode_smem": ([_I] * 5, ctypes.c_longlong),
    "smx_paged_prefill_smem": ([_I] * 4, ctypes.c_longlong),
    "smx_paged_prefill_tc_smem": ([_I] * 2, ctypes.c_longlong),
    "smx_decode_smem": ([_I] * 2, ctypes.c_longlong),
    "smx_decode_bulk_tile": ([_I] * 2, _I),
    "smx_flash_fwd_smem": ([_I] * 3, ctypes.c_longlong),
    "smx_flash_bwd_dkv_smem": ([_I], ctypes.c_longlong),
    "smx_flash_bwd_dq_smem": ([_I] * 3, ctypes.c_longlong),
    "smx_error_string": ([_I], ctypes.c_char_p),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    cus, hdrs = _sources()
    for p in cus + hdrs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _build(out_dir: Path) -> str:
    """Compile every source in parallel, link, and return ptxas's report."""
    nvcc = _nvcc()
    cus, _ = _sources()
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=out_dir))
    procs = []
    for src in cus:
        obj = tmp / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
               "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for src, _, p in procs:
        out, _ = p.communicate()
        logs.append(f"== {src.name}\n{out}")
        if p.returncode != 0:
            failed.append(src.name)
    log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
    lib_tmp = tmp / "libsmx.so"
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(lib_tmp)] + [str(o) for _, o, _ in procs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    (tmp / "ptxas.txt").write_text(log)
    os.replace(tmp / "ptxas.txt", out_dir / "ptxas.txt")
    os.replace(lib_tmp, out_dir / "libsmx.so")     # atomic publish
    shutil.rmtree(tmp, ignore_errors=True)
    return log


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib, _ptxas_log
    with _lock:
        if _lib is not None:
            return _lib
        out_dir = BUILD_DIR / _digest()
        so = out_dir / "libsmx.so"
        if so.exists():
            log_file = out_dir / "ptxas.txt"
            _ptxas_log = log_file.read_text() if log_file.exists() else ""
        else:
            _ptxas_log = _build(out_dir)
        lib = ctypes.CDLL(str(so))
        for name, (args, res) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = res
        _lib = lib
        return lib


def ptxas_report() -> str:
    """What ptxas said about each kernel when the library was built."""
    load_library()
    return _ptxas_log


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        text = load_library().smx_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {text}")


def ptr(t) -> Optional[int]:
    """Device pointer of a tensor for ctypes (None for a missing operand)."""
    return None if t is None else t.data_ptr()


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
