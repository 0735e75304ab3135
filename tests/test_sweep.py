"""The CUDA seam-sweep wrapper (lqr_tpu.ops.sweep) and the engine's choice
of seam search, checked on the CPU.

The kernel itself has no interpret mode; its arithmetic is held to the
scan DP on the card (tests/test_gpu.py, chip_smoke.py). What surrounds it
is plain Python and is checked here: the FFI call's shapes and dtypes,
solo and under vmap; the platform and shape choice in
``engine._find_seam``; the build command and its hash-keyed output.
"""

import pathlib
import subprocess

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from lqr_tpu.core import engine as eng
from lqr_tpu.core.state import EngineConfig
from lqr_tpu.ops import sweep


def _sds(shape, dtype=jnp.float32):
    return jax.ShapeDtypeStruct(shape, dtype)


@pytest.mark.parametrize("has_rig", [False, True])
@pytest.mark.parametrize("H,Wb", [(1, 128), (64, 128), (384, 512),
                                  (2048, 2048), (3072, 2048)])
def test_eval_shape_solo(H, Wb, has_rig):
    seam, m_last = jax.eval_shape(
        lambda e, r: sweep.sweep(e, r, jnp.bool_(True), 1, has_rig),
        _sds((H, Wb)), _sds((H, Wb)))
    assert (seam.shape, seam.dtype) == ((H,), jnp.int32)
    assert (m_last.shape, m_last.dtype) == ((Wb,), jnp.float32)


@pytest.mark.parametrize("delta_x", [0, 3, 10])
@pytest.mark.parametrize("B", [1, 64])
def test_eval_shape_vmapped_ragged(B, delta_x):
    """Under vmap every operand gains the batch axis (broadcast_all): one
    launch covers the batch, per-image heights and rigidity included."""
    def f(e, r, p, h, c):
        return sweep.sweep(e, r, p, delta_x, True, h=h, rigc_vec=c)

    seam, m_last = jax.eval_shape(
        jax.vmap(f), _sds((B, 96, 256)), _sds((B, 96, 256)),
        _sds((B,), jnp.bool_), _sds((B,), jnp.int32),
        _sds((B, delta_x + 1)))
    assert seam.shape == (B, 96) and seam.dtype == jnp.int32
    assert m_last.shape == (B, 256) and m_last.dtype == jnp.float32


def test_eval_shape_nested_vmap_and_input_dtype():
    """Nested batch axes flatten into the grid; a narrower float input is
    cast to f32 before the call."""
    f = jax.vmap(jax.vmap(lambda e: sweep.find_seam(
        e, None, jnp.bool_(False), 2, False)))
    out = jax.eval_shape(f, _sds((3, 5, 32, 128), jnp.bfloat16))
    assert out.shape == (3, 5, 32) and out.dtype == jnp.int32


@pytest.mark.parametrize("Wb,delta_x", [(sweep.MAX_WB + 128, 1), (128, 11),
                                        (128, -1)])
def test_unsupported_shapes_raise(Wb, delta_x):
    with pytest.raises(ValueError):
        jax.eval_shape(lambda e: sweep.sweep(e, None, jnp.bool_(True),
                                             delta_x, False),
                       _sds((8, Wb)))


def test_rigc_constants_match_scan_dp():
    """The kernel's static-H rigidity coefficients are the f32 values the
    scan DP computes from |dx|^1.5 / H."""
    for H in (1, 7, 768, 2048):
        got = sweep.rigc_constants(H, 10)
        for m in range(1, 11):
            assert got[m] == jnp.float32((m ** 1.5) / float(H))
        assert got[0] == 0


def _lowered_text(cfg, platform, ragged=False):
    e = _sds((cfg.H, cfg.Wb))
    rig = _sds((cfg.H, cfg.Wb)) if cfg.has_rig else None
    pl = _sds((), jnp.bool_)
    if ragged:
        def f(e, rig, pl, h, c):
            return eng._find_seam(cfg, e, rig, pl, h=h, rigc_vec=c)
        args = (e, rig, pl, _sds((), jnp.int32), _sds((cfg.delta_x + 1,)))
    else:
        def f(e, rig, pl):
            return eng._find_seam(cfg, e, rig, pl)
        args = (e, rig, pl)
    return jax.jit(f).trace(*args).lower(
        lowering_platforms=(platform,)).as_text()


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("has_rig", [False, True])
@pytest.mark.parametrize("delta_x", [1, 3])
def test_engine_picks_kernel_on_cuda_scan_on_cpu(delta_x, has_rig, ragged):
    cfg = EngineConfig(H=32, Wb=256, C=3, delta_x=delta_x, has_rig=has_rig)
    assert sweep.TARGET in _lowered_text(cfg, "cuda", ragged)
    assert sweep.TARGET not in _lowered_text(cfg, "cpu", ragged)


def test_engine_takes_scan_beyond_kernel_width():
    cfg = EngineConfig(H=8, Wb=sweep.MAX_WB + 128, C=3)
    assert sweep.TARGET not in _lowered_text(cfg, "cuda")


def test_extend_map_lowers_one_kernel_call_per_seam_step():
    """The whole resize loop for the GPU holds exactly one sweep call (in
    the while body) — vmapped batches included."""
    from lqr_tpu.core.state import init_state
    from lqr_tpu.parallel.batch import extend_map_batched, init_state_batched
    cfg = EngineConfig(H=16, Wb=128, C=3)
    img = np.zeros((16, 100, 3), np.uint8)
    st = init_state(cfg, img)
    txt = eng.extend_map.trace(cfg, st, jnp.int32(3)).lower(
        lowering_platforms=("cuda",)).as_text()
    assert txt.count(f"@{sweep.TARGET}(") == 1
    stb = init_state_batched(cfg, np.zeros((4, 16, 128, 3), np.uint8),
                             np.full((4,), 100, np.int32))
    txt = extend_map_batched.trace(cfg, stb, jnp.full((4,), 3, jnp.int32)
                                   ).lower(lowering_platforms=("cuda",)
                                           ).as_text()
    assert txt.count(f"@{sweep.TARGET}(") == 1
    assert "tensor<4x16x128xf32>" in txt


def test_build_command_targets_hopper_without_fma():
    cmd = sweep.build_command(pathlib.Path("/x/out.so"))
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "-fmad=false" in cmd
    assert not any("fast" in a for a in cmd)
    assert cmd[-1].endswith("seam_sweep.cu")
    assert jax.ffi.include_dir() in cmd


def test_library_path_is_keyed_on_source_hash(tmp_path):
    a = tmp_path / "a.cu"
    b = tmp_path / "b.cu"
    a.write_text("// one\n")
    b.write_text("// two\n")
    pa, pb = sweep.library_path(a), sweep.library_path(b)
    assert pa != pb
    assert pa.parent == pb.parent
    b.write_text("// one\n")                      # same bytes, same key
    assert sweep.library_path(b) == pa
    assert sweep.library_path().name.startswith("libseam_sweep-")


def test_build_skips_nvcc_when_library_exists(tmp_path, monkeypatch):
    src = tmp_path / "k.cu"
    src.write_text("// kernel\n")
    monkeypatch.setattr(sweep, "_BUILD", tmp_path / "build")
    so = sweep.library_path(src)
    so.parent.mkdir()
    so.write_bytes(b"")

    def no_nvcc(*a, **k):
        raise AssertionError("nvcc must not run")

    monkeypatch.setattr(subprocess, "run", no_nvcc)
    assert sweep.build(src) == so


def test_build_runs_nvcc_for_new_source(tmp_path, monkeypatch):
    src = tmp_path / "k.cu"
    src.write_text("// kernel v2\n")
    monkeypatch.setattr(sweep, "_BUILD", tmp_path / "build")
    calls = []

    def fake_nvcc(cmd, **k):
        calls.append(cmd)
        pathlib.Path(cmd[cmd.index("-o") + 1]).write_bytes(b"elf")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(subprocess, "run", fake_nvcc)
    so = sweep.build(src)
    assert so == sweep.library_path(src) and so.read_bytes() == b"elf"
    assert len(calls) == 1 and "-fmad=false" in calls[0]
    assert not list(so.parent.glob("*.tmp"))


def test_build_failure_raises(tmp_path, monkeypatch):
    src = tmp_path / "k.cu"
    src.write_text("// broken\n")
    monkeypatch.setattr(sweep, "_BUILD", tmp_path / "build")
    monkeypatch.setattr(subprocess, "run", lambda cmd, **k: (
        subprocess.CompletedProcess(cmd, 1, "", "error: boom")))
    with pytest.raises(sweep.SweepBuildError, match="boom"):
        sweep.build(src)
    assert not sweep.library_path(src).exists()


def test_missing_nvcc_raises(tmp_path, monkeypatch):
    src = tmp_path / "k.cu"
    src.write_text("// kernel\n")
    monkeypatch.setattr(sweep, "_BUILD", tmp_path / "build")
    monkeypatch.setattr(sweep, "nvcc", lambda: str(tmp_path / "no-nvcc"))
    with pytest.raises(sweep.SweepBuildError, match="cannot run nvcc"):
        sweep.build(src)
