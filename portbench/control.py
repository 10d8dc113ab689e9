"""Read the control of a cell: the plain reference, computed in the next
precision below the configuration's (TF32 for the float32 chain, bfloat16
for the float32 loops), put in the program's place on the blocks a short
window keeps, and judged by the same check. It has to come out not correct;
its readings are the upper ends the limits in ``configs/*.json`` were set
below. The benchmark's runs never run it.

    python3 portbench/control.py --workload <cell> --seeds <n,n,...> --seconds <s>

Prints one JSON line a seed: the numbers compared, each with its limit.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    from portbench.core import registry, runner

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=2.0)
    args = parser.parse_args()
    runner.cache_dirs(ROOT)

    import torch

    if not torch.cuda.is_available():
        sys.exit("portbench/control.py needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = registry.benchmark(ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        res = runner.run_cell(bench, args.workload, seed, args.seconds, False,
                              torch.device("cuda", 0), time.time(), control=True)
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": res.correct,
                          "checks": res.line["checks"]}), flush=True)
