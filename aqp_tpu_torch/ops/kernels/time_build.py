"""Time the kernels' build two ways, where nvcc is installed: build.py's
parallel build (one nvcc process per source, all started together, then
one link) against one nvcc call over all sources.  Each form runs twice,
in the order parallel, single, single, parallel, each into an empty
directory under aqp_tpu_torch/_build/timing/, which is removed after.
Prints one JSON line with the seconds.

    python3 -m aqp_tpu_torch.ops.kernels.time_build
"""

from __future__ import annotations

import json
import shutil
import subprocess
import time
from pathlib import Path

from aqp_tpu_torch.ops.kernels import build


def single(out_dir: Path) -> float:
    """Seconds of one nvcc call that compiles and links every source."""
    cu = [str(p) for p in build.sources() if p.suffix == ".cu"]
    t0 = time.perf_counter()
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-I",
                    str(build.CSRC_DIR), "-shared", *cu, "-o",
                    str(out_dir / "libaqp_kernels_single.so")],
                   check=True, capture_output=True)
    return time.perf_counter() - t0


def parallel(out_dir: Path) -> float:
    return build.build(out_dir)[1]


def main() -> None:
    root = build.BUILD_DIR / "timing"
    secs: dict = {"parallel": [], "single": []}
    try:
        for i, form in enumerate(("parallel", "single", "single",
                                  "parallel")):
            out_dir = root / str(i)
            out_dir.mkdir(parents=True)
            secs[form].append((parallel if form == "parallel"
                               else single)(out_dir))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"build_seconds": secs,
                      "sources": [p.name for p in build.sources()]}),
          flush=True)


if __name__ == "__main__":
    main()
