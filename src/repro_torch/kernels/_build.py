"""Build and load the package's hand-written CUDA kernels.

Every ``csrc/*.cu`` source is compiled by its own ``nvcc`` process, all
started together, and the objects are linked into one shared library
with a plain C interface, which is loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -Xptxas -v -c -o <name>.o csrc/<name>.cu   (each)
    nvcc -shared -gencode arch=compute_90a,code=sm_90a
         -o build/kernels/libreprotorch_<hash>.so *.o

The build runs at first use, never at import, and is keyed on a hash of
the sources and the flags, so an edited kernel rebuilds and an unchanged
one loads the library already built.  ``build(defines, names)`` builds a
variant -- some of the sources, with ``-D`` flags -- whose hash, and so
whose library, is its own, and ``load`` binds any such library (a planted
fault's, for a check that must fail).  ``nvcc``'s output (``-Xptxas -v``:
registers, shared memory and spills per kernel) is kept beside the
library as ``<name>.log``, with each step's own seconds (``compile_s``)
and the whole build's (``build_s``).  Each entry point's ``argtypes``
are declared here: ``c_void_p`` for every pointer and for the stream,
``c_int`` for counts, ``c_float`` for scalars.
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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Sequence, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # dev, g, f, n, bias, mask, guard, B, S, lam, g_free, M, lam_f,
    # out, ticket, host_best, stream
    "score_reduce_launch": [_P] * 7 + [_I, _I] + [_F] * 4 + [_P] * 4,
    # dev, g, f, n, bias, mask, guard, offsets, params, W, R, S, out,
    # host_best, stream (score_reduce_multi and score_reduce_batch)
    "score_reduce_multi_launch": [_P] * 9 + [_I] * 3 + [_P] * 3,
    # q, k, v, o, scratch, B, Sq, Skv, H, KVH, hd, dtype, causal, window,
    # scale, softcap, stream
    "flash_attention_launch": [_P] * 5 + [_I] * 9 + [_F, _F, _P],
    # B, Skv, KVH, hd, dtype -> float32 words of scratch (c_longlong)
    "flash_attention_scratch": [_I] * 5,
    # x, dt, A, Bm, Cm, y, h, scratch, B, S, nh, hp, N, Q, dtype, stream
    "ssd_scan_launch": [_P] * 8 + [_I] * 7 + [_P],
    # B, S, nh, hp, N, Q, dtype, scratch_floats (out), smem_bytes (out)
    "ssd_scan_plan": [_I] * 7 + [ctypes.POINTER(ctypes.c_longlong),
                                 ctypes.POINTER(ctypes.c_int)],
}


_RESTYPES = {"flash_attention_scratch": ctypes.c_longlong}


def sources(names: Sequence[str] = ()) -> List[Path]:
    """The ``csrc/*.cu`` sources, or those whose stems are in ``names``."""
    return sorted(p for p in CSRC.glob("*.cu") if not names or p.stem in names)


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found: the CUDA kernels need the CUDA toolkit to build"
    )


def library_path(defines: Sequence[str] = (), names: Sequence[str] = ()) -> Path:
    h = hashlib.sha256(" ".join([*NVCC_FLAGS, *defines]).encode())
    for src in sources(names):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libreprotorch_{h.hexdigest()[:16]}.so"


def _run(cmd) -> Tuple[int, str]:
    """Run ``cmd``; its exit code and a log of it, its output and its own
    seconds (``compile_s``)."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    return proc.returncode, (f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
                             f"compile_s={time.perf_counter() - t0:.3f}\n")


def build(defines: Sequence[str] = (), names: Sequence[str] = ()) -> Path:
    """Compile the sources (those named, all by default; each with the
    ``-D`` flags in ``defines``) unless the library for their hash exists.
    Returns the library's path; raises with nvcc's output on failure."""
    out = library_path(defines, names)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # objects and the library go to private names first, so concurrent
    # builds never load a half-written library
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        t0 = time.perf_counter()
        srcs = sources(names)
        objs = [work / f"{src.stem}.o" for src in srcs]
        cmds = [[nvcc(), *NVCC_FLAGS, *defines, "-c", "-o", str(o), str(src)]
                for o, src in zip(objs, srcs)]
        with ThreadPoolExecutor(len(cmds)) as pool:
            done = list(pool.map(_run, cmds))
        failed = any(rc != 0 for rc, _ in done)
        log = "".join(text for _, text in done)
        if not failed:
            lib = work / "lib.so"
            rc, text = _run([nvcc(), "-shared", *ARCH_FLAGS, "-o", str(lib),
                             *map(str, objs)])
            log += text
            failed = rc != 0
        log += f"build_s={time.perf_counter() - t0:.3f}\n"
        if failed:
            raise RuntimeError(f"nvcc failed:\n{log}")
        out.with_suffix(".log").write_text(log)
        os.replace(lib, out)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def load(path: Path) -> ctypes.CDLL:
    """Load a built library and declare the entry points it has."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = _RESTYPES.get(name, ctypes.c_int)
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    return load(build())
