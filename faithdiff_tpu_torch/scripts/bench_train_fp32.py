"""Times the fp32 trainer (`cli.py train --dtype float32`) of one or more
checkouts of the port in turns on one card, so that a change to the fp32
flash kernel can be read end to end beside its parent in one run.

    python faithdiff_tpu_torch/scripts/bench_train_fp32.py [--tree DIR ...]
        [--label NAME ...] [--steps N]

Each `--tree` (default: this checkout; give trees in the order to run
them, say parent, change, change, parent, with one `--label` each) runs in
a process of its own with its own `faithdiff_tpu_torch`, its kernels built
first, and its own `chip_smoke.run_train_fp32` and `run_train_fp32_wide`:
stage 1 at 512 px, batch 2, `--steps` micro-steps on the default attention
path and one on the packed path, each timed with CUDA events and held to
its exact flash launches, then the 256 px trainer with its d = 512
attentions, by wall clock. One `train_fp32_turn` line a turn: the
micro-steps' ms (the first of a process holds its warm-up), the 256 px
trainer's wall and the card's name and power limit. Exits nonzero without
a card or when a turn fails.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# runs in the tree's root: `chip_smoke` and `faithdiff_tpu_torch` are the tree's
TURN = """
import shutil, sys, tempfile, torch
import chip_smoke as smoke
from faithdiff_tpu_torch.ops import _build
if not torch.cuda.is_available():
    sys.exit("no CUDA device")
smoke.FP32_TRAIN_STEPS = int(sys.argv[1])
_build.build_all()
root = tempfile.mkdtemp(dir=_build.BUILD_DIR)
try:
    smoke.run_train_fp32(torch, root)
    smoke.run_train_fp32_wide(torch, root)
finally:
    shutil.rmtree(root, ignore_errors=True)
"""


def run_turn(tree: str, steps: int) -> dict:
    out = subprocess.run([sys.executable, "-c", TURN, str(steps)], cwd=tree,
                         capture_output=True, text=True, timeout=1800)
    rows = {}
    for line in out.stdout.splitlines():
        if line.startswith('{"check": "train_fp32'):
            row = json.loads(line)
            rows[row["check"]] = row
    if out.returncode or set(rows) != {"train_fp32", "train_fp32_wide"}:
        sys.stderr.write(out.stdout[-4000:] + out.stderr[-4000:])
        raise SystemExit(f"bench_train_fp32: the turn in {tree} failed "
                         f"(exit {out.returncode})")
    fp32, wide = rows["train_fp32"], rows["train_fp32_wide"]
    return dict(ms_per_micro_step=fp32["ms_per_micro_step"],
                packed=[False] * steps + [True], loss=fp32["loss"],
                peak_gib=fp32["peak_gib"], cli_wall_s=fp32["cli_wall_s"],
                wide_cli_wall_s=wide["cli_wall_s"], wide_loss=wide["loss"])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", nargs="+", default=[REPO])
    ap.add_argument("--label", nargs="+")
    ap.add_argument("--steps", type=int, default=6,
                    help="micro-steps on the default attention path a turn")
    args = ap.parse_args()
    labels = args.label or args.tree
    if len(labels) != len(args.tree):
        ap.error("one --label a --tree")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60)
    if card.returncode:
        print("bench_train_fp32: no card", file=sys.stderr)
        return 1
    card = card.stdout.strip().splitlines()[0]
    for turn, (tree, label) in enumerate(zip(args.tree, labels)):
        row = dict(turn=turn, label=label, card=card,
                   **run_turn(os.path.abspath(tree), args.steps))
        print("train_fp32_turn", json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
