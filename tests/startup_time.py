"""Wall-clock startup of a port entry point: the median of N fresh runs of
``python -m repro_torch.launch.serve --help`` (or the module named), the
process's imports included.

Run:  PYTHONPATH=src python tests/startup_time.py [--runs 5] [--module M]
"""

import argparse
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def startup_seconds(module: str, runs: int):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = []
    for _ in range(runs):
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-m", module, "--help"], env=env,
                       stdout=subprocess.DEVNULL, check=True)
        out.append(time.perf_counter() - t0)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--module", default="repro_torch.launch.serve")
    args = ap.parse_args(argv)
    ts = startup_seconds(args.module, args.runs)
    print(f"{args.module} --help: median {statistics.median(ts):.3f} s "
          f"over {args.runs} runs ({', '.join(f'{t:.3f}' for t in ts)})")


if __name__ == "__main__":
    main()
