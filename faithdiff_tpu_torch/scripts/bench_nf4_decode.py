"""Times the NF4 kernel at decode sizes (M <= 8) for one checkout of the
port, so two versions of the kernel can be timed in one run on one card,
and counts the decode kernel's SASS instructions.

    python faithdiff_tpu_torch/scripts/bench_nf4_decode.py [--tree DIR]
        [--label NAME] [--m 1 2 4 8] [--sass]

The rows are `chip_smoke.check_nf4`'s (`nf4_matmul` lines: the same
weights, CUDA-graph timing over weight copies past the L2, tolerance,
`same_bits` and bound), taken with `faithdiff_tpu_torch` imported from
`--tree DIR` (default: this checkout), say an older commit unpacked with
`git archive`; `chip_smoke.py` itself always comes from this checkout. Run
the script as a file, not with `-m`. `--sass` adds, for each decode kernel
of the built library, the SASS instructions of its main loop per 16-byte
weight vector (`cuobjdump -sass`; `nf4_sass` lines). Exits nonzero without
a card or when a row is out of tolerance or differs between two calls (the
route is not held here: an older port counts none).
"""
from __future__ import annotations

import argparse
import collections
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def sass_loop_counts(lib_path: str) -> list:
    """For each decode kernel in the library: the instructions of its
    largest loop (the main loop), by opcode, and per 16-byte weight vector.
    The tensor-core kernel takes 4 mma instructions a vector (two 16-row
    mma tiles' worth of k per vector pair); the one-warp-a-row kernel of
    earlier versions 1 + 4 M 128-bit global loads (the vector and four x
    vectors for each of its M rows)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    dump = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    rows = []
    for chunk in dump.split("Function : ")[1:]:
        name = chunk.split("\n", 1)[0].strip()
        if "nf4_gemv_kernel" not in name:
            continue
        # (address, instruction without its predicate)
        ins = [(int(a, 16), re.sub(r"^@!?U?P\w+\s+", "", op.strip())) for a, op in
               re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", chunk)]
        best = []
        for addr, op in ins:
            hit = re.match(r"BRA\b.*?0x([0-9a-f]+)", op)
            if hit and int(hit.group(1), 16) < addr:          # a backward branch
                body = [o for a, o in ins if int(hit.group(1), 16) <= a <= addr]
                best = max(best, body, key=len)
        opcodes = collections.Counter(o.split()[0] for o in best)
        args = [int(a) for a in re.findall(r"L[ib](\d+)E", name)]
        hmma = sum(n for op, n in opcodes.items() if op.startswith("HMMA"))
        ldg128 = sum(n for op, n in opcodes.items() if op.startswith("LDG.") and ".128" in op)
        vectors = hmma / 4 if hmma else ldg128 / (1 + 4 * args[0])
        rows.append(dict(kernel=name, template_args=args, loop_instructions=len(best),
                         vectors_per_iteration=vectors,
                         instructions_per_vector=len(best) / vectors if vectors else None,
                         opcodes=dict(opcodes.most_common(16))))
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=REPO)
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--m", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch

    import faithdiff_tpu_torch
    from faithdiff_tpu_torch.ops import _build

    if not os.path.abspath(faithdiff_tpu_torch.__file__).startswith(tree + os.sep):
        print(f"bench_nf4_decode: imported {faithdiff_tpu_torch.__file__}, not from "
              f"{tree}: run the script as a file", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("bench_nf4_decode: no CUDA device", file=sys.stderr)
        return 1
    print(f"card: {smoke.card_line()}; tree {args.label}", flush=True)
    lib = _build.build_all()["nf4_matmul"]
    if args.sass:
        for row in sass_loop_counts(lib):
            print("nf4_sass", json.dumps(dict(row, label=args.label)), flush=True)
    rows = smoke.check_nf4(torch, args.m)
    return 1 if any(not (r["in_tol"] and r["same_bits"]) for r in rows) else 0


if __name__ == "__main__":
    sys.exit(main())
