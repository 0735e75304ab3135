"""Prebuild the native libraries (the `make` equivalent).

- native/imagecodec.cpp — PNG/PNM codec + buffer marshalling (the
  io_functions.c replacement on the host data path);
- native/lqr_ref.cpp    — single-core CPU reference carver (the liblqr
  stand-in used as the benchmark baseline and bit-exactness oracle);
- native/seam_sweep.cu  — the CUDA seam-sweep kernel (nvcc, sm_90a); skipped
  where no nvcc is installed, since only a GPU runs it.

All also build lazily on first use; this script builds them eagerly and
surfaces compiler failures with the full compiler output.

Usage: python scripts/build_native.py [--force]
"""

import argparse
import os
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--force", action="store_true",
                    help="rebuild even if up to date")
    args = ap.parse_args()

    from lqr_tpu.utils import codec
    from lqr_tpu import native
    from lqr_tpu.ops import sweep

    ok = True
    for name, mod, so in (("imagecodec", codec, codec._SO),
                          ("lqr_ref", native, native._SO)):
        if args.force and so.exists():
            so.unlink()
        try:
            mod._load()
            print(f"{name}: OK -> {so}")
        except Exception as e:
            ok = False
            print(f"{name}: BUILD FAILED\n{e}", file=sys.stderr)

    if not os.path.exists(sweep.nvcc()):
        print(f"seam_sweep: skipped, no nvcc at {sweep.nvcc()}")
        return 0 if ok else 1
    if args.force:
        sweep.library_path().unlink(missing_ok=True)
    try:
        print(f"seam_sweep: OK -> {sweep.build()}")
    except sweep.SweepBuildError as e:
        ok = False
        print(f"seam_sweep: BUILD FAILED\n{e}", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
