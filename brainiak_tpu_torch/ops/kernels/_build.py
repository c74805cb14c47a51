"""Build and load the hand-written CUDA kernels.

Each source ``brainiak_tpu_torch/csrc/<name>.cu`` has a plain C
interface and is compiled by ``nvcc`` into its own shared library,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o lib<name>-<hash>.so <name>.cu

under ``<repo>/build/brainiak_tpu_torch/`` (the path comes from this
file, not from the working directory), and is loaded with ``ctypes``.
No ``--use_fast_math``: the Fisher-z needs IEEE ``logf`` and division
to agree with its plain version.

The build happens on first use, or for all sources at once through
:func:`build` (one ``nvcc`` per source, all started together).  The
library name carries a hash of the source and of the shared headers
(``csrc/*.cuh``), so an edited source or header is rebuilt; it is
written to a temporary file and renamed, so concurrent processes never
load half a library.  A failed build raises
``RuntimeError`` with nvcc's output: there is no fallback.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["BUILD_DIR", "CSRC_DIR", "SOURCES", "build", "check",
           "library_path", "load"]

_PKG = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "brainiak_tpu_torch"
SOURCES = ("epoch_norm", "epoch_norm_tile", "fcma_corr", "fcma_corr_tc",
           "fcma_corr_tcl", "fcma_gram_tc",
           "fcma_gram_tcm", "fcma_gram_tcs", "fcma_sample_gram",
           "fcma_sample_gram_tc",
           "fcma_sample_gram_tcm", "fcma_sample_gram_tcs", "ring_mma",
           "ring_mma_tc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_loaded = {}  # name -> ctypes.CDLL, guarded by _lock


def _nvcc():
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = os.path.join(cand, "bin", "nvcc")
        if cand and os.path.isfile(path):
            return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH); the CUDA kernels of brainiak_tpu_torch are built "
            "from brainiak_tpu_torch/csrc on first use")
    return found


def library_path(name):
    """Path of the shared library built from ``csrc/<name>.cu``."""
    digest = hashlib.sha256()
    for path in [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]:
        digest.update(path.read_bytes())
    digest = digest.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=SOURCES, verbose=False):
    """Compile the named sources that are not built yet, one ``nvcc``
    process each, all started together.  Returns ``{name: (path,
    compiler_output)}``; ``verbose`` adds ``-Xptxas -v`` so the output
    lists registers, shared memory and spills."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    results = {}
    for name in names:
        out = library_path(name)
        if out.exists() and not verbose:
            results[name] = (out, "")
            continue
        tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        if verbose:
            cmd[1:1] = ["-Xptxas", "-v"]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        output, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed for csrc/{name}.cu "
                          f"(exit {proc.returncode}):\n{output}")
            continue
        os.replace(tmp, out)
        results[name] = (out, output)
    if failed:
        raise RuntimeError("\n".join(failed))
    return results


def load(name):
    """The loaded ``ctypes.CDLL`` of ``csrc/<name>.cu``, built first
    if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path, _ = build([name])[name]
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
        return lib


def check(err, what):
    """Raise if a C entry point returned a non-zero CUDA error code."""
    if err != 0:
        raise RuntimeError(f"CUDA error {err} launching {what}")
