"""Build the CUDA kernels from ``lqer_tpu_torch/csrc`` and bind them.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface under ``build/lqer_tpu_torch/`` (the library name
carries a hash of the sources and flags, so an edit rebuilds), and loads
through ``ctypes``; a source may export several entry points
(:data:`ENTRIES`). :func:`build_all` starts one ``nvcc`` per source, all
at once. Nothing is compiled when a module is imported: the first launch,
or an explicit :func:`build_all`, builds. The megakernel's grid barrier
(``cooperative_groups::this_grid().sync()`` under
``cudaLaunchCooperativeKernel``) needs no ``-rdc=true`` with CUDA 12, so
every source stays one whole-program ``nvcc`` call.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "lqer_tpu_torch"
SOURCES = ("dequant_gemm", "attention", "decode_attention", "cache_write",
           "unpack", "mlp_fused", "decode_attention_quantized",
           "decode_attention_fp", "decode_attention_streaming")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# entry -> (source, C function, argument types before the stream)
ENTRIES = {
    "dequant_gemm": ("dequant_gemm", "lqer_dequant_gemm",
                     [P] * 12 + [I] * 11),
    "attention": ("attention", "lqer_prefill_attention",
                  [P] * 5 + [I] * 4 + [F, I, I, I]),
    "decode_attention": ("decode_attention", "lqer_staged_decode_attention",
                         [P] * 15 + [I] * 7 + [F, I, I]),
    "cache_write": ("cache_write", "lqer_flush_stage",
                    [P] * 8 + [I] * 4 + [P] * 2 + [I] * 5),
    "row_write": ("cache_write", "lqer_write_rows",
                  [P] * 8 + [I] * 16 + [P] + [I] * 4),
    "row_write_all": ("cache_write", "lqer_write_rows_all_layers",
                      [P] * 8 + [I] * 16 + [P] + [I] * 4),
    "unpack": ("unpack", "lqer_unpack", [P] * 3 + [I] * 3),
    "mlp_fused": ("mlp_fused", "lqer_mlp_fused", [P] * 22 + [I] * 15),
    "decode_attention_quantized": (
        "decode_attention_quantized", "lqer_decode_attention_quantized",
        [P] * 10 + [I] * 6 + [F, I, I, I]),
    "decode_attention_fp": ("decode_attention_fp", "lqer_decode_attention_fp",
                            [P] * 6 + [I] * 5 + [F] + [I] * 5),
    "decode_attention_fp32": ("decode_attention_fp",
                              "lqer_decode_attention_fp32",
                              [P] * 6 + [I] * 5 + [F] + [I] * 5),
    "decode_attention_streaming": (
        "decode_attention_streaming", "lqer_decode_attention_streaming",
        [P] * 8 + [I] * 7 + [F, I, I, I]),
    "encode_write_tokens": ("cache_write", "lqer_encode_write_tokens",
                            [P] * 7 + [I] * 9),
}

_LIBS: dict[str, ctypes.CDLL] = {}
_FUNCS: dict[str, object] = {}
BUILD_LOGS: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda)")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> float:
    """Compile every missing library in parallel; returns the seconds
    taken. Raises with the compiler output when a source fails."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name} (exit {proc.returncode})\n{log}")
        else:
            tmp.replace(out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def _function(entry: str):
    fn = _FUNCS.get(entry)
    if fn is None:
        source, fn_name, argtypes = ENTRIES[entry]
        lib = _LIBS.get(source)
        if lib is None:
            build_all((source,))
            lib = _LIBS[source] = ctypes.CDLL(str(_lib_path(source)))
        fn = getattr(lib, fn_name)
        fn.argtypes = [*argtypes, P]
        fn.restype = ctypes.c_int
        _FUNCS[entry] = fn
    return fn


def launch(entry: str, *args) -> None:
    """Call the C entry point ``entry`` on the current stream; raise on a
    non-zero ``cudaGetLastError``."""
    import torch

    err = _function(entry)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {entry} failed to launch: error {err}")


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()
