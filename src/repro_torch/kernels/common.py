"""Shared kernel substrate: registry, device dispatch, build, gradients.

* **registry** — :class:`KernelSpec` maps a family name to its CUDA
  wrapper and its plain torch version.  Each spec also carries the
  family's launch counts: ``launches`` rises by one where the wrapper
  launches its kernel, ``plain_calls`` where a CPU tensor takes the
  plain version through :func:`dispatch`, and where a CUDA tensor's
  backward takes the exact VJP instead of the family's fused backward
  kernel (:func:`fused_vjp` under ``REPRO_FUSED_BWD=0``).
* **device dispatch** — :func:`dispatch`: a CUDA tensor launches the
  kernel, a CPU tensor takes the plain version.  There is no fallback: a
  CUDA tensor whose kernel fails to build or launch raises.
* **build** — :func:`load_library` compiles a family's ``csrc/*.cu``
  with ``nvcc`` for ``sm_90a`` into a shared library with a plain C
  interface, at first use, into ``build/`` at the repository root, and
  loads it with ``ctypes``.
* **gradients** — :func:`ste` (from :mod:`repro_torch.core.ste`):
  quantized forward, exact float backward; :func:`fused_vjp`: a
  family's fused backward kernel where it has one, switched off by
  ``REPRO_FUSED_BWD=0`` (:func:`fused_backward_enabled`).
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core.ste import ste  # noqa: F401

# ---------------------------------------------------------------------------
# Kernel registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class KernelSpec:
    """One kernel family, as the substrate sees it.

    kernel: the CUDA wrapper (raw layout; CUDA tensors only).
    plain:  the plain torch version of the same function, from the
            family's ``ref.py`` — bit-exact for the fixed-point families.
    replaces: ``file:line`` of the TPU kernel in the JAX package.
    source: the CUDA source, relative to the repository root.
    launches / plain_calls: counts since the last :func:`reset_counts`.
    """
    name: str
    kernel: Callable[..., Any]
    plain: Callable[..., Any]
    replaces: str = ""
    source: str = ""
    launches: int = 0
    plain_calls: int = 0


_REGISTRY: Dict[str, KernelSpec] = {}


def register(spec: KernelSpec) -> KernelSpec:
    """Idempotent by name (module re-imports re-register the same spec)."""
    _REGISTRY[spec.name] = spec
    return spec


def get_kernel(name: str) -> KernelSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"no kernel {name!r} registered; known: {registered_kernels()} "
            "(import repro_torch.kernels to populate the registry)") from None


def registered_kernels() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def reset_counts() -> None:
    for spec in _REGISTRY.values():
        spec.launches = 0
        spec.plain_calls = 0


def largest_divisor(n: int, cap: int) -> int:
    """Largest d with 1 <= d <= cap and n % d == 0."""
    d = max(1, min(int(cap), int(n)))
    while n % d:
        d -= 1
    return d


def check_block(n: int, block: int, what: str) -> None:
    """Raise unless ``block`` tiles ``n`` (the frontends pick it with
    :func:`largest_divisor`; the raw functions take it as given)."""
    if block < 1 or n % block:
        raise ValueError(f"{what}: block {block} does not divide {n}")


# ---------------------------------------------------------------------------
# Fused backward kernels
# ---------------------------------------------------------------------------


def fused_backward_enabled() -> bool:
    """The switch for the fused backward kernels, read at each call.

    On by default; ``REPRO_FUSED_BWD=0`` (or ``false``/``no``) puts every
    family back on the exact VJP of its float reference, as the JAX
    package's switch of the same name does.
    """
    env = os.environ.get("REPRO_FUSED_BWD")
    if env is None:
        return True
    return env.lower() not in ("0", "false", "no")


class _FusedVjp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fwd_res, bwd, *args):
        out, res = fwd_res(*args)
        ctx.bwd = bwd
        ctx.save_for_backward(*res)
        return out

    @staticmethod
    def backward(ctx, g):
        grads = ctx.bwd(tuple(ctx.saved_tensors), g)
        return (None, None, *(gr if need else None for gr, need in
                              zip(grads, ctx.needs_input_grad[2:])))


def _counted_exact(spec: KernelSpec, grad: Callable[..., torch.Tensor]
                   ) -> Callable[..., torch.Tensor]:
    """``grad``, adding one to ``spec.plain_calls`` when it runs on CUDA
    tensors: the backward went round the fused kernel on the card."""
    def run(*args):
        if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
            spec.plain_calls += 1
        return grad(*args)
    return run


def fused_vjp(fwd: Callable[..., torch.Tensor],
              grad: Callable[..., torch.Tensor],
              fwd_res: Optional[Callable[..., Any]] = None,
              bwd: Optional[Callable[..., Any]] = None,
              spec: Optional[KernelSpec] = None
              ) -> Callable[..., torch.Tensor]:
    """A differentiable call of a kernel family, generalising :func:`ste`.

    ``fwd(*args)`` runs the forward; ``fwd_res(*args) -> (out, residuals)``
    runs it emitting the residuals (a tuple of tensors) its fused backward
    reads, and ``bwd(residuals, g)`` returns one cotangent per argument.
    Without the pair, or with ``REPRO_FUSED_BWD=0``, this is :func:`ste`:
    ``fwd`` forward, the exact VJP of the float function ``grad``
    backward.  ``spec`` is the family's backward kernel: a CUDA tensor's
    exact-VJP backward counts as one of its ``plain_calls``.  Static
    configuration is bound into the callables; the result takes tensors
    only.  A call that needs no gradient runs ``fwd``.
    """
    if fwd_res is None or bwd is None or not fused_backward_enabled():
        return ste(fwd, grad if spec is None else _counted_exact(spec, grad))

    def call(*args):
        if torch.is_grad_enabled() and any(
                isinstance(a, torch.Tensor) and a.requires_grad
                for a in args):
            return _FusedVjp.apply(fwd_res, bwd, *args)
        return fwd(*args)

    return call


# ---------------------------------------------------------------------------
# Device dispatch
# ---------------------------------------------------------------------------


def dispatch(spec: KernelSpec, *tensors: torch.Tensor) -> Callable[..., Any]:
    """The callable for these inputs: ``spec.kernel`` when they lie on a
    CUDA device, ``spec.plain`` when they lie on the CPU.  Mixed or other
    devices raise."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return spec.kernel
    if kinds == {"cpu"}:
        spec.plain_calls += 1
        return spec.plain
    raise ValueError(f"{spec.name}: inputs must all lie on one CUDA device or "
                     f"all on the CPU, got {sorted(kinds)}")


# ---------------------------------------------------------------------------
# Build: nvcc -> shared library with a C interface -> ctypes
# ---------------------------------------------------------------------------

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass
class BuiltLibrary:
    lib: ctypes.CDLL
    path: Path
    seconds: float          # 0.0 when an earlier build was reused
    log: str                # nvcc's output (ptxas register/smem report)


_LIBS: Dict[str, BuiltLibrary] = {}
_LIB_LOCKS: Dict[str, threading.Lock] = {}
_LIBS_LOCK = threading.Lock()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the CUDA "
                       "kernels are built from source at first use")


def load_library(name: str, sources: Sequence[Path],
                 signatures: Dict[str, Tuple[Any, list]],
                 headers: Sequence[Path] = ()) -> BuiltLibrary:
    """Build (once per source content) and load ``lib<name>.so``.

    ``headers`` are the sources' includes: they enter the content hash but
    not the ``nvcc`` command.  ``signatures`` maps each C entry point to
    its ``(restype, argtypes)``; they are set once, when the library is
    loaded.  Libraries of different names build concurrently when called
    from several threads."""
    with _LIBS_LOCK:
        lock = _LIB_LOCKS.setdefault(name, threading.Lock())
    with lock:
        if name in _LIBS:
            return _LIBS[name]
        digest = hashlib.sha256()
        for src in (*sources, *headers):
            digest.update(Path(src).read_bytes())
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        path = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"
        seconds, log = 0.0, ""
        if not path.exists():
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
            t0 = time.monotonic()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            seconds = time.monotonic() - t0
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed building {name} "
                                   f"({' '.join(cmd)}):\n{log}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        for fn, (restype, argtypes) in signatures.items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        built = BuiltLibrary(lib, path, seconds, log)
        _LIBS[name] = built
        return built


def check_cuda(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
