"""Times the NF4 kernel for one checkout of the port, at decode sizes (M <=
8, the default) or at the prefill route's (say `--m 16 640 1244`), so two
versions of the kernel can be timed in one run on one card, and counts the
SASS instructions of both routes' main loops.

    python faithdiff_tpu_torch/scripts/bench_nf4_decode.py [--tree DIR]
        [--label NAME] [--m 1 2 4 8] [--sass] [--tiles] [--caption]

The rows are `chip_smoke.check_nf4`'s (`nf4_matmul` lines: the same
weights, CUDA-graph timing over weight copies past the L2, tolerance,
`same_bits` and bound), taken with `faithdiff_tpu_torch` imported from
`--tree DIR` (default: this checkout), say an older commit unpacked with
`git archive`; `chip_smoke.py` itself always comes from this checkout. Run
the script as a file, not with `-m`. `--sass` adds, for each decode kernel
of the built library, the SASS instructions of its main loop per 16-byte
weight vector, and for each prefill kernel those of its main loop per K
step and per 4-byte packed word a consumer lane decodes (`cuobjdump
-sass`; `nf4_sass` lines). `--tiles` times the prefill kernel of this
checkout at each M > 8 of `--m` and the 13B shapes with every x tile the
kernel has (`ops/nf4_matmul.gemm_plan_for_tile`), weights cycled past the
L2 as in the rows, and says whether each tile gives the planned tile's bits
(`nf4_tile` lines). `--caption` runs `chip_smoke.run_caption` instead of
the rows: the full-width two-image caption with the other tree's port,
for its `prefill_ms` (`caption` line), after the rows at the caption's
prefill M, so that its kernels are loaded as in `chip_smoke.py`. Exits
nonzero without
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
    """For each NF4 kernel in the library: the instructions of its largest
    loop (the main loop), by opcode. For a decode kernel, per 16-byte
    weight vector: the tensor-core kernel takes 4 mma instructions a vector
    (two 16-row mma tiles' worth of k per vector pair); the one-warp-a-row
    kernel of earlier versions 1 + 4 M 128-bit global loads (the vector and
    four x vectors for each of its M rows). For a prefill kernel with
    wgmma (template argument: rows of x a tile), per K step (8 chunks of
    16 k, each as many wgmmas as the tile's widths) and per 4-byte packed
    word a consumer lane decodes (8 a step: 4 chunks of 2 rows); for an
    older prefill kernel without wgmma, the loop alone."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    dump = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    rows = []
    for chunk in dump.split("Function : ")[1:]:
        name = chunk.split("\n", 1)[0].strip()
        if "nf4_gemv_kernel" not in name and "nf4_gemm_kernel" not in name:
            continue
        # (address, instruction without its predicate)
        ins = [(int(a, 16), re.sub(r"^@!?U?P\w+\s+", "", op.strip())) for a, op in
               re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", chunk)]
        # a decode kernel's main loop is its largest backward-branch body; a
        # prefill kernel's is the smallest one that holds all its wgmmas (a
        # spin-wait laid out past the epilogue branches back into the loop)
        gemm = "nf4_gemm_kernel" in name

        def rank(body):
            if not gemm:
                return len(body)
            return (sum(o.startswith("HGMMA") for o in body), -len(body))

        best = []
        for addr, op in ins:
            hit = re.match(r"BRA\b.*?0x([0-9a-f]+)", op)
            if hit and int(hit.group(1), 16) < addr:          # a backward branch
                body = [o for a, o in ins if int(hit.group(1), 16) <= a <= addr]
                best = max(best, body, key=rank) if best else body
        opcodes = collections.Counter(o.split()[0] for o in best)
        args = [int(a) for a in re.findall(r"L[ib](\d+)E", name)]
        row = dict(kernel=name, template_args=args, loop_instructions=len(best),
                   opcodes=dict(opcodes.most_common(16)))
        if gemm:
            hgmma = sum(n for op, n in opcodes.items() if op.startswith("HGMMA"))
            steps = 0
            if hgmma:            # an older prefill kernel has no wgmma (and no widths)
                from faithdiff_tpu_torch.ops.nf4_matmul import wgmma_widths

                steps = hgmma / (8 * len(wgmma_widths(args[0])))
            row.update(steps_per_iteration=steps,
                       instructions_per_step=len(best) / steps if steps else None,
                       instructions_per_word=len(best) / (8 * steps) if steps else None)
        else:
            hmma = sum(n for op, n in opcodes.items() if op.startswith("HMMA"))
            ldg128 = sum(n for op, n in opcodes.items()
                         if op.startswith("LDG.") and ".128" in op)
            vectors = hmma / 4 if hmma else ldg128 / (1 + 4 * args[0])
            row.update(vectors_per_iteration=vectors,
                       instructions_per_vector=len(best) / vectors if vectors else None)
        rows.append(row)
    return rows


def tile_sweep(smoke, torch, ms) -> bool:
    """`nf4_tile` lines: the prefill kernel's time at each x tile; False if
    a tile's output differs from the planned tile's."""
    from faithdiff_tpu_torch.ops import _build
    from faithdiff_tpu_torch.ops import nf4_matmul as N
    from faithdiff_tpu_torch.utils.quantize import quantize_nf4

    same = True
    lib = _build.load("nf4_matmul")
    gen = torch.Generator(device="cuda").manual_seed(2)
    for in_f, out_f in smoke.NF4_SHAPES:
        w = (torch.randn((in_f, out_f), generator=gen, device="cuda")
             * in_f ** -0.5).to(torch.bfloat16)
        q = quantize_nf4(w)
        del w
        weight_bytes = q.packed.numel() + q.absmax.numel() * 4
        copies = [q] + [q._replace(packed=q.packed.clone(), absmax=q.absmax.clone())
                        for _ in range(int(2 * 50e6 // weight_bytes))]
        for m in (m for m in ms if m > N.GEMV_MAX_M):
            x = torch.randn((m, in_f), generator=gen, device="cuda").to(torch.bfloat16)
            want = N.nf4_matmul_kernel(x, q)
            planned = N.plan_nf4_gemm(m, in_f, out_f).n_tile
            b_ms, _ = smoke.bound(2 * m * in_f * out_f, weight_bytes + 2 * m * (in_f + out_f),
                                  smoke.PEAK_BF16_FLOPS)
            for n_tile in (n for n in N.GEMM_N_TILES if n < m + 16):
                plan = N.gemm_plan_for_tile(m, in_f, out_f, n_tile)
                out = torch.empty_like(want)
                turn = iter(range(1 << 30))

                def call(qq=None):
                    code = N.launch_gemm(lib, x, qq or copies[next(turn) % len(copies)], out,
                                         plan, torch.cuda.current_stream().cuda_stream)
                    _build.check(lib, code, "nf4_gemm")

                call(q)
                torch.cuda.synchronize()
                bits = bool(torch.equal(out, want))
                same &= bits
                ms_ = smoke.graph_ms(torch, call)
                print("nf4_tile", json.dumps(dict(
                    m=m, in_f=in_f, out_f=out_f, n_tile=n_tile, planned=n_tile == planned,
                    grid=plan.grid, waves=plan.waves, stages=plan.stages, ms=ms_,
                    ms_over_bound=ms_ / b_ms, same_bits_as_plan=bits)), flush=True)
        del q, copies
        torch.cuda.empty_cache()
    return same


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=REPO)
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--m", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--tiles", action="store_true")
    ap.add_argument("--caption", action="store_true")
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
    if args.caption:
        smoke.check_nf4(torch, [smoke.caption_prefill_m()])
        smoke.run_caption(torch)          # exits nonzero on any failed check
        return 0
    if args.tiles:
        return 0 if tile_sweep(smoke, torch, args.m) else 1
    rows = smoke.check_nf4(torch, args.m)
    return 1 if any(not (r["in_tol"] and r["same_bits"]) for r in rows) else 0


if __name__ == "__main__":
    sys.exit(main())
