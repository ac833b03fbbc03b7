"""The control of each cell's correctness check: the cell run with a path
one precision step below the configuration's, which the check has to
find not correct.

- a bf16 configuration: the program itself with its own lower-precision
  path switched on, `build_pipeline(use_fp8=True)` (UNet weights stored
  float8_e4m3fn), judged against the bf16 reference;
- an fp8 configuration: the plain reference with the UNet's weights in
  int4 (per output channel) put in the program's place, judged against
  the fp8 reference.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...] [--seconds S]

prints one JSON line a seed with the numbers compared and `correct`.
The benchmark's own runs never run it.
"""
import json
import os
import sys

BENCH = os.path.dirname(os.path.abspath(__file__))


def control_overrides(config: dict) -> dict:
    return ({"reference_in_place": "int4"} if config["use_fp8"]
            else {"use_fp8": True})


def run_control(workload: str, seed: int, seconds: float = 0.1, device: str = "cuda",
                spec=None, inputs=None) -> dict:
    import harness

    spec = spec or harness.load_spec()
    inputs = inputs or harness.cell_inputs(spec, workload)
    result, checks, error = harness.run_cell(
        workload, seed, seconds, False, device, spec,
        overrides=control_overrides(inputs[1]), inputs=inputs)
    if error:
        raise RuntimeError(error)
    return {"workload": workload, "seed": seed, "correct": result["correct"],
            "check": result["check"], "attempted": result["attempted"]}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=0.1)
    args = ap.parse_args(argv)
    for seed in args.seeds:
        print(json.dumps(run_control(args.workload, seed, args.seconds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, BENCH)
    sys.path.insert(1, os.path.dirname(BENCH))
    sys.exit(main())
