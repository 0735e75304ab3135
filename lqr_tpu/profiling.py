"""Profiling / tracing / roofline accounting.

The reference's only instrumentation is a compiled-out wall-clock macro
(``__CLOCK_IT__``, /root/reference/src/render.c:36-38). The device
framework needs real observability (SURVEY.md §5): this module provides

- ``trace(logdir)``: context manager around ``jax.profiler`` — produces a
  Perfetto/XProf trace of the carve (kernels, DMA, host callbacks);
- ``annotate(name)``: named TraceAnnotation for host-side phases, nestable
  inside ``trace`` (shows as a labeled span);
- ``seam_roofline(...)``: analytic per-seam cost model — device-memory
  bytes of one seam step at a given size, with the device's
  speed-of-light bound, so measured seams/s can be judged against the
  hardware ceiling (the BASELINE "seams/sec/chip ... speed-of-light"
  requirement);
- ``Stopwatch``: phase timing that waits for the device
  (``block_until_ready``) before reading the clock.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a device trace of the enclosed block (view with xprof /
    tensorboard-plugin-profile, or convert to Perfetto)."""
    import jax
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named span inside a trace (host-side phase annotation)."""
    import jax
    return jax.profiler.TraceAnnotation(name)


# Peak device-memory bandwidth (GB/s) by ``device_kind``. Source: NVIDIA's
# H100 SXM5 data sheet (80 GB HBM3 at 3.35 TB/s). A device not listed here
# is an error, never a default.
PEAK_HBM_GBPS = {
    "NVIDIA H100 80GB HBM3": 3350.0,
}


@dataclasses.dataclass
class Roofline:
    hbm_bytes: int          # device-memory traffic of one seam step
    seq_rows: int           # rows on the sequential DP critical path
    sol_seams_per_s: float  # speed-of-light bound from memory traffic alone
    breakdown: dict
    device_kind: str

    def efficiency(self, measured_seams_per_s: float) -> float:
        return measured_seams_per_s / self.sol_seams_per_s


def seam_roofline(H: int, W: int, has_bias: bool = False,
                  has_rig: bool = False, device_kind: str | None = None
                  ) -> Roofline:
    """Analytic device-memory traffic of one seam step on the split hot
    path, and the seams/s that traffic allows at the device's peak.

    Traffic per seam (engine._carve_once + the amortized per-chunk commit):
      energy:    read cur_b (f32) + write e (f32)
      DP fwd:    read e + write bp (i8)
      backtrack: read bp + write one-hot (i32) + read one-hot (reduce)
      compact:   read + write cur_b (and bias/rig planes when present)

    device_kind defaults to ``jax.devices()[0].device_kind``; a kind
    missing from ``PEAK_HBM_GBPS`` raises ValueError.
    """
    if device_kind is None:
        import jax
        device_kind = jax.devices()[0].device_kind
    if device_kind not in PEAK_HBM_GBPS:
        raise ValueError(f"no peak bandwidth on record for device kind "
                         f"{device_kind!r}; add it to PEAK_HBM_GBPS")
    plane = H * W * 4
    n_extra = int(has_bias) + int(has_rig)
    b = {
        "energy": 2 * plane,
        "dp_forward": plane + H * W * 1 + (plane if has_rig else 0),
        "backtrack": H * W * 1 + 2 * plane,
        "compact": 2 * plane * (1 + n_extra),
        "commit_amortized": plane // 4,
    }
    total = sum(b.values())
    return Roofline(hbm_bytes=total, seq_rows=H,
                    sol_seams_per_s=PEAK_HBM_GBPS[device_kind] * 1e9 / total,
                    breakdown=b, device_kind=device_kind)


class Stopwatch:
    """Phase timer that waits for the device before each lap.
    Use: sw = Stopwatch(); ...; sw.lap('carve', state.depth)."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.laps: list[tuple[str, float]] = []

    def lap(self, name: str, sync_on=None) -> float:
        if sync_on is not None:
            import jax
            jax.block_until_ready(sync_on)
        now = time.perf_counter()
        dt = now - self.t0
        self.laps.append((name, dt))
        self.t0 = now
        return dt

    def report(self) -> str:
        return " | ".join(f"{n}: {dt * 1e3:.1f}ms" for n, dt in self.laps)
