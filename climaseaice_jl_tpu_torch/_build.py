"""Build the package's CUDA sources into shared libraries at first use.

Each ``.cu`` source under ``csrc/`` (with the headers beside it) is compiled by ``nvcc`` into a library with a
plain C interface, loaded with ``ctypes``; no PyTorch headers are involved,
so a build takes seconds.  Libraries go to ``_build/`` beside this file,
named by a hash of the sources and flags, so an edited source is rebuilt and
a built one is reused.  ``build()`` starts one ``nvcc`` per source, all at
once, and waits for them together.

Generated units (the column kernels of ``thermodynamics/fixed_tile_thermo.py``
and the pointwise kernels of ``dynamics/fixed_tile_pointwise.py``, written by
``dynamics/fixed_tile_codegen.py``) are built the same way: the
text is written to ``_build/`` and compiled against the headers of
``csrc/``; source and library are named by a hash of the text, the flags and
those headers.  Every file is written under a name of its own process and
moved into place with ``os.replace``, so processes that build the same unit
at once do not collide.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

SOURCES = {"evp": "evp.cu", "evp_padded": "evp_padded.cu",
           "evp_curvilinear": "evp_curvilinear.cu", "evp_prep": "evp_prep.cu",
           "evp_tiled_padded": "evp_tiled_padded.cu",
           "advection_fixed": "advection_fixed.cu",
           "evp_tiled_curvilinear": "evp_tiled_curvilinear.cu",
           "ice_strength_fixed": "ice_strength_fixed.cu", "evp_tiled": "evp_tiled.cu"}

# No --use_fast_math: it would change the divides and square roots.  No
# source contracts a multiply-add (-fmad=false): each operation rounds on
# its own, as in the kernels' plain PyTorch versions, whatever the compiler
# would fuse at a given call site, so every kernel can equal its plain
# version bitwise.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-fmad=false")

_libraries: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}   # nvcc output per source (ptxas registers, spills)


def _nvcc() -> str:
    candidates = [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    home = os.environ.get("CUDA_HOME")
    if home:
        candidates.insert(0, os.path.join(home, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels of climaseaice_jl_tpu_torch "
                       "are built on a machine with the CUDA toolkit")


def _target(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        digest.update(path.name.encode() + path.read_bytes())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def generated_name(stem: str, text: str) -> str:
    """The name of generated unit ``text``: ``stem`` and a hash of the text,
    the flags and the headers of ``csrc/``."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode() + text.encode())
    for path in sorted(CSRC.glob("*.cuh")):
        digest.update(path.name.encode() + path.read_bytes())
    return f"{stem}_{digest.hexdigest()[:16]}"


def build(names=None, generated=None) -> dict[str, Path]:
    """Compile the listed sources (default: all) and the generated units
    ``generated`` (name from :func:`generated_name` → text) that are not
    built yet, all at once."""
    names = list(SOURCES) if names is None else list(names)
    generated = dict(generated or {})
    targets = {name: _target(name) for name in names}
    targets.update({name: BUILD_DIR / f"lib{name}.so" for name in generated})
    jobs = {}
    for name, out in targets.items():
        if out.exists():
            continue
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        if name in generated:
            src = BUILD_DIR / f"{name}.{os.getpid()}.tmp.cu"
            src.write_text(generated[name])
            cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
        else:
            src = None
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out, src)
    failed = []
    for name, (proc, tmp, out, src) in jobs.items():
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode == 0:
            os.replace(tmp, out)
            if src is not None:          # kept beside the library for reading
                os.replace(src, BUILD_DIR / f"{name}.cu")
        else:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
    if failed:
        raise RuntimeError("CUDA build failed: " + "\n".join(failed))
    return targets


def load(name: str, text: str | None = None) -> ctypes.CDLL:
    """The built library of source ``name``, or of the generated unit
    ``name`` whose text is ``text``, building it first if needed."""
    if name not in _libraries:
        generated = None if text is None else {name: text}
        path = build([] if text is not None else [name], generated)[name]
        _libraries[name] = ctypes.CDLL(str(path))
    return _libraries[name]

