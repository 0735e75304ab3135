"""The CUDA seam sweep (native/seam_sweep.cu) as a JAX operation.

One launch per seam runs the cumulative-cost DP and its backtrack for a
whole batch of images: one thread block per image, the frontier row in
shared memory. Same contract as ``core.dp.find_seam`` and bit-identical to
it; ``core.engine._find_seam`` chooses between the two by platform.

The shared library is built with ``nvcc`` at first use on a GPU (or by
``scripts/build_native.py``) into ``native/build/``. Its file name carries a
hash of the source, the flags and the JAX version, so a library built from
another source or for another JAX is never loaded. A failed build raises
``SweepBuildError``: there is no silent fallback to the scan DP.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

import numpy as np
import jax
import jax.numpy as jnp

from ..errors import LqrError

_ROOT = pathlib.Path(__file__).resolve().parent.parent.parent
_SRC = _ROOT / "native" / "seam_sweep.cu"
_BUILD = _ROOT / "native" / "build"

TARGET = "lqr_seam_sweep"
MAX_WB = 16 * 1024        # 512 threads x 32 columns (seam_sweep.cu kMaxK)
MAX_DELTA_X = 10

# Bit-exactness (SPEC.md §5): no FMA contraction, no fast math; sm_90a is
# the Hopper target.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_lib = None


class SweepBuildError(LqrError):
    """nvcc is missing or failed to build the seam-sweep library."""


def nvcc() -> str:
    """Path of the CUDA compiler: on PATH, else the toolkit's default."""
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def build_command(out: pathlib.Path, src: pathlib.Path = _SRC) -> list[str]:
    return [nvcc(), *NVCC_FLAGS, "-I", jax.ffi.include_dir(), "-o",
            str(out), str(src)]


def library_path(src: pathlib.Path = _SRC) -> pathlib.Path:
    """Where the library for this source, these flags and this JAX lives."""
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(jax.__version__.encode())
    return _BUILD / f"libseam_sweep-{h.hexdigest()[:16]}.so"


def build(src: pathlib.Path = _SRC) -> pathlib.Path:
    """Build the library unless a copy for this exact source exists."""
    so = library_path(src)
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run(build_command(tmp, src), capture_output=True,
                              text=True)
    except OSError as e:
        raise SweepBuildError(f"cannot run nvcc ({e})") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise SweepBuildError(
            f"nvcc failed building {src.name}:\n{proc.stderr}")
    os.replace(tmp, so)
    return so


def load():
    """Build (if needed), load and register the FFI target; idempotent."""
    global _lib
    if _lib is None:
        lib = ctypes.cdll.LoadLibrary(str(build()))
        jax.ffi.register_ffi_target(TARGET, jax.ffi.pycapsule(
            lib.LqrSeamSweep), platform="CUDA")
        _lib = lib
    return _lib


def _gpu_present() -> bool:
    try:
        return bool(jax.devices("gpu"))
    except RuntimeError:
        return False


def supports(Wb: int) -> bool:
    """Whether the kernel takes a buffer this wide."""
    return Wb <= MAX_WB


def rigc_constants(H: int, delta_x: int) -> np.ndarray:
    """f32(|dx|^1.5 / H) for |dx| in 0..delta_x — the static-H
    coefficients of dp.dp_forward, rounded once from double."""
    return np.asarray([np.float32((m ** 1.5) / float(H))
                       for m in range(delta_x + 1)], np.float32)


def sweep(e_tot, rig, pref_left, delta_x: int, has_rig: bool, h=None,
          rigc_vec=None):
    """Run the kernel. Returns (seam [H] i32, M_last [Wb] f32).

    e_tot [H, Wb] f32 (+inf at invalid lanes, bias folded in); rig
    [H, Wb] f32 or None; pref_left a traced bool; h / rigc_vec the
    ragged-batch height and rigidity coefficients of dp.dp_forward.
    Under ``jax.vmap`` every operand gains the batch axis and the whole
    batch runs as one launch."""
    H, Wb = e_tot.shape
    if not supports(Wb) or not 0 <= delta_x <= MAX_DELTA_X:
        raise ValueError(f"seam sweep: unsupported Wb={Wb} or "
                         f"delta_x={delta_x}")
    if _gpu_present():
        load()
    if rigc_vec is None:
        rigc_vec = jnp.asarray(rigc_constants(H, delta_x))
    h = jnp.int32(H) if h is None else jnp.asarray(h, jnp.int32)
    rig_in = (jnp.asarray(rig, jnp.float32) if has_rig
              else jnp.zeros((1,), jnp.float32))
    call = jax.ffi.ffi_call(
        TARGET,
        (jax.ShapeDtypeStruct((H,), jnp.int32),
         jax.ShapeDtypeStruct((Wb,), jnp.float32),
         jax.ShapeDtypeStruct((H, Wb), jnp.int8)),     # scratch: bp
        vmap_method="broadcast_all")
    seam, m_last, _ = call(
        jnp.asarray(e_tot, jnp.float32), rig_in,
        jnp.asarray(pref_left).astype(jnp.int32), h,
        jnp.asarray(rigc_vec, jnp.float32),
        delta_x=np.int32(delta_x), has_rig=np.int32(has_rig))
    return seam, m_last


def find_seam(e_tot, rig, pref_left, delta_x: int, has_rig: bool, h=None,
              rigc_vec=None):
    """``core.dp.find_seam`` on the GPU: seam [H] i32."""
    return sweep(e_tot, rig, pref_left, delta_x, has_rig, h=h,
                 rigc_vec=rigc_vec)[0]
