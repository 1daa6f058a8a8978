"""Sweep runner: execute every grid point of a sweep config.

Counterpart of ``im2im_uq_tpu/scripts/sweep.py``: one
``im2im_uq_tpu_torch.scripts.router`` subprocess per grid point, so that a
crashing point does not end the sweep, and a rerun resumes (the router
skips a point whose results pickle exists). ``--jobs`` > 1 runs points on
a thread pool, which helps only when the points are CPU-bound or each has
a device of its own; one GPU serializes them. ``--data-path``,
``--output-dir`` and ``--device`` pass through to every point. Failed
points are listed and the sweep exits 1.

    python -m im2im_uq_tpu_torch.scripts.sweep \\
        --config experiments/synthetic_test/config.yml [--jobs 1] [--device cuda]
"""

from __future__ import annotations

import argparse
import concurrent.futures
import subprocess
import sys

from im2im_uq_tpu_torch.utils.config import load_config

__all__ = ["main"]


def _run_point(config_path: str, index: int, extra: list[str]) -> int:
    cmd = [
        sys.executable, "-m", "im2im_uq_tpu_torch.scripts.router",
        "--config", config_path, "--grid-index", str(index), *extra,
    ]
    print(f"[sweep] point {index}: {' '.join(cmd)}", flush=True)
    return subprocess.call(cmd)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", required=True)
    parser.add_argument("--jobs", type=int, default=1)
    parser.add_argument("--data-path", default=None)
    parser.add_argument("--output-dir", default=None)
    parser.add_argument("--device", default="cuda", help="torch device of every point")
    args = parser.parse_args(argv)

    grid = load_config(args.config)
    extra = ["--device", args.device]
    if args.data_path:
        extra += ["--data-path", args.data_path]
    if args.output_dir:
        extra += ["--output-dir", args.output_dir]

    print(f"[sweep] {len(grid)} grid point(s), jobs={args.jobs}")
    failures = []
    if args.jobs <= 1:
        for i in range(len(grid)):
            if _run_point(args.config, i, extra) != 0:
                failures.append(i)
    else:
        with concurrent.futures.ThreadPoolExecutor(args.jobs) as pool:
            futs = {pool.submit(_run_point, args.config, i, extra): i for i in range(len(grid))}
            for fut in concurrent.futures.as_completed(futs):
                if fut.result() != 0:
                    failures.append(futs[fut])
    if failures:
        print(f"[sweep] FAILED points: {sorted(failures)}")
        sys.exit(1)
    print("[sweep] all points complete")


if __name__ == "__main__":
    main()
