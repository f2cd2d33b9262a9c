"""Run one cell of BENCHMARK.json on the card and print its result line.

    python3 -m drm_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Exits with a code other than 0 and prints no result when no CUDA device is
visible, when fewer cards are visible than the cell asks for, or when a
module of JAX or of the JAX package is loaded once the window has closed.
The last lines of standard error give each number compared beside its
limit; the last line of standard output is the result object.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m drm_bench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from drm_bench import harness

    if not torch.cuda.is_available():
        print("drm_bench: no CUDA device is visible; the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    cell, _, _ = harness.cell_spec(harness.load_bench(), args.workload)
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"drm_bench: {args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    with contextlib.redirect_stdout(sys.stderr):
        result, info = harness.run_cell(args.workload, args.seed, args.seconds,
                                        bool(args.trace), "cuda", T_START)
    bad = harness.banned_modules()
    if bad:
        print(f"drm_bench: loaded after the window: {', '.join(bad)}", file=sys.stderr)
        return 3
    print(f"[drm_bench] {json.dumps(info)}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    io = harness.io_bytes()
    print(f"bytes_written {io.get('write_bytes', 0)} wchar {io.get('wchar', 0)}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
