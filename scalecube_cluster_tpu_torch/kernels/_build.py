"""Build the package's CUDA sources with ``nvcc`` and load them by ctypes.

Each ``csrc/<name>.cu`` exposes a plain C entry point and compiles on its
own into ``_build/lib<name>-<hash>.so`` (``.gitignore`` lists the
directory) for ``sm_90a``.  The hash covers the source and the flags, so
an edited source rebuilds and an unchanged one loads the cached library.
Nothing builds at import: :func:`load` builds at first use, and
:func:`build` compiles several sources at once, one ``nvcc`` each, all
started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, the toolkit's default
    install, or the one on ``PATH``."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: install the CUDA toolkit or set CUDA_HOME")
    return found


def source_path(name: str) -> Path:
    return CSRC_DIR / f"{name}.cu"


def library_path(name: str) -> Path:
    digest = hashlib.sha256(
        source_path(name).read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source that has no current library, all
    ``nvcc`` processes running at once.  Returns each compiled source's
    compiler output (register and spill report); raises with the
    compiler output if any build fails."""
    BUILD_DIR.mkdir(exist_ok=True)
    compiler = None
    running = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        compiler = compiler or nvcc()
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(source_path(name))]
        running[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True), tmp, out)
    logs, failures = {}, []
    for name, (proc, tmp, out) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu:\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)
        logs[name] = log
    if failures:
        raise RuntimeError("\n".join(failures))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _LOADED:
        build([name])
        _LOADED[name] = ctypes.CDLL(str(library_path(name)))
    return _LOADED[name]
