"""Build the port's CUDA sources and load them with ``ctypes``.

Each ``csrc/*.cu`` file has a plain C interface (no PyTorch headers), so
``nvcc`` builds it in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
        -Xcompiler -fPIC -o <build dir>/lib<name>-<digest>.so <source>

The library goes to ``$REPRO_TORCH_BUILD_DIR`` or else ``build/kernels``
at the root of the checkout (listed in ``.gitignore``), named by a digest
of its source, and is built on first use. A failed build raises: there is
no fallback. ``build_all`` starts one ``nvcc`` per source at once.

Wrappers pass pointers and the stream as ``ctypes.c_void_p`` and sizes as
``ctypes.c_int``; every C entry point returns ``cudaGetLastError()``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_KERNELS = Path(__file__).resolve().parent
SOURCES = {
    "find_winners": _KERNELS / "find_winners" / "csrc" / "find_winners.cu",
    "update_phase": _KERNELS / "update_phase" / "csrc" / "update_phase.cu",
    "topo_states": _KERNELS / "topo_states" / "csrc" / "topo_states.cu",
}
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    return Path(env) if env else _KERNELS.parents[2] / "build" / "kernels"


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in $CUDA_HOME/bin, "
            "/usr/local/cuda/bin): the CUDA kernels cannot be built")
    return path


def _target(name: str) -> Path:
    digest = hashlib.sha256(SOURCES[name].read_bytes()).hexdigest()[:16]
    return build_dir() / f"lib{name}-{digest}.so"


def _start(name: str):
    out = _target(name)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(tmp),
           str(SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc, time.perf_counter()


def _finish(name: str, out: Path, tmp: Path, proc, t0: float):
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {SOURCES[name]} "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return time.perf_counter() - t0, log


def build_all(names=None) -> dict:
    """Build the named sources (all by default) that are not built yet,
    one ``nvcc`` each, all started together. Returns ``{name: (seconds,
    nvcc output)}`` for the builds made; raises if any failed."""
    names = list(SOURCES) if names is None else list(names)
    with _LOCK:
        started = [(n, *_start(n)) for n in names
                   if n not in _LIBS and not _target(n).exists()]
        built, errors = {}, []
        for n, out, tmp, proc, t0 in started:
            try:
                built[n] = _finish(n, out, tmp, proc, t0)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
        return built


def load(name: str) -> ctypes.CDLL:
    """The built library of source ``name``, building it on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _LOCK:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(str(_target(name)))
        return _LIBS[name]


def check(name: str, t, dtype, shape: tuple, device) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and
    ``shape`` on ``device``: what a kernel takes, and nothing else."""
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{name}: expected a tensor on {device}, got "
                         f"{t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def launch(source: str, fn: str, tensors: list, ints: list) -> None:
    """Call ``fn(ptrs..., ints..., stream)`` of library ``source`` on the
    current stream of the tensors' device, with that device current;
    raise on a nonzero return."""
    import torch

    lib = load(source)
    f = getattr(lib, fn)
    if f.argtypes is None:
        f.argtypes = ([ctypes.c_void_p] * len(tensors)
                      + [ctypes.c_int] * len(ints) + [ctypes.c_void_p])
        f.restype = ctypes.c_int
    dev = tensors[0].device
    # the launch goes to the current device: make it the tensors' own, so
    # a rank on cuda:1 never launches on cuda:0
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = f(*[t.data_ptr() for t in tensors], *ints, stream)
    if rc != 0:
        raise RuntimeError(f"{fn} failed to launch: CUDA error {rc}")
