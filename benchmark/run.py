"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the card(s) the cell asks
for.  The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and last ``checks``: each number compared beside its limit,
which also close standard error).  Exits non-zero and prints no result when
CUDA or the cards are missing, or when the JAX package or JAX is loaded once
the window has closed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

_ROOT = Path(__file__).resolve().parent.parent
# every build and kernel cache at a fixed path inside the checkout; the port
# builds its own kernels into oisat_tpu_torch/_build/ there
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "nv_compute")):
    os.environ[_var] = str(_ROOT / ".bench_cache" / _sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
# run as a file, Python puts benchmark/ first on the path: its modules are
# reached as the package, never as top-level names
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != _ROOT / "benchmark"]
sys.path.insert(0, str(_ROOT))

from benchmark.harness import forbidden_loaded, measure  # noqa: E402
from benchmark.spec import load_benchmark, load_cell  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(sys.argv[1:] if argv is None else argv)
    cell = load_cell(args.workload, load_benchmark(_ROOT), _ROOT)
    import torch

    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {chips} CUDA device(s); this machine has {have}",
              file=sys.stderr)
        return 2
    from benchmark.check import check

    result = measure(cell, args.seed, args.seconds, bool(args.trace), "cuda", check=check)
    loaded = forbidden_loaded()
    if loaded:
        print(f"the process loaded {', '.join(loaded)}: the benchmark runs the port only",
              file=sys.stderr)
        return 3
    print(f"correct: {result['correct']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
