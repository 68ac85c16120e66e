#!/usr/bin/env python3
"""Device time of the DIA kernels built from several versions of their
source, in one process on one card.

    python3 scripts/torch_dia_kernel_ab.py A.cu B.cu [C.cu ...] [--rounds 2]

Each source is compiled as dafoam_tpu_torch.ops.dia_kernels builds its own
(nvcc, sm_90a) and loaded in turn, in the order A, B, ..., ..., B, A per
round. Every kernel then runs at 262,144 rows in float32 on random
operands with chip_smoke.py phase 3's band offsets (-512, -511, -1, 1,
511, 512): the scalar forms on (n,), the multi forms on (3, n) with a
per-component diagonal; and, for the wider loop, at the 58 offsets of
phase 20's 48x48 relabelled box on 2,304 rows, where the source takes
that many. Prints, per source and kernel, the median device time per call
(torch.profiler, chip_smoke.device_us) over the rounds and every single
reading, and checks each result against the plain version.
"""

import argparse
import os
import re
import statistics
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402

WIDE_BOX = 48


def operands(torch, offsets, n, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    return {"scalar": (rnd(n), rnd(len(offsets), n), rnd(n), rnd(n)),
            "multi": (rnd(3, n), rnd(len(offsets), n), rnd(3, n),
                      rnd(3, n))}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("sources", nargs="+")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    from pathlib import Path
    from dafoam_tpu_torch.mesh import box_hex_mesh
    from dafoam_tpu_torch.ops import dia_kernels as dk
    from dafoam_tpu_torch.parallel import reorder_for_partitions
    cs.phase_device(torch)
    pts, topo = box_hex_mesh(WIDE_BOX, WIDE_BOX, 1, (0.1, 0.1, 0.01),
                             kinds=cs.SHARD_WALLS)
    topo, _ = reorder_for_partitions(topo, pts, cs.SHARD_PARTS)
    narrow = (-512, -511, -1, 1, 511, 512)
    wide = tuple(int(o) for o in topo.dia()[0])
    cases = {f"{len(narrow)} offsets, n 262144":
             (narrow, operands(torch, narrow, 262144, 0)),
             f"{len(wide)} offsets, n {topo.n_cells}":
             (wide, operands(torch, wide, topo.n_cells, 1))}
    times = {}
    ids = list(range(len(args.sources)))
    order = (ids + ids[::-1]) * args.rounds
    for which in order:
        src = Path(args.sources[which]).resolve()
        dk.SOURCE, dk._lib = src, None
        dk.build()
        cap = int(re.search(r"#define DIA_MAX_OFFSETS (\d+)",
                            src.read_text()).group(1))
        for case, (offsets, ops) in cases.items():
            if len(offsets) > cap:
                continue
            for nm in dk.KERNEL_NAMES:
                kind = "multi" if nm.endswith(("multi", "multi_t")) else \
                    "scalar"
                d, c, x, ct = ops[kind]
                kern, plain = cs.kernel_calls(dk, nm, d, c, offsets, x, ct)
                cs._max_err(torch, kern(), plain(), f"{src} {case} {nm}")
                times.setdefault((which, case, nm), []).append(
                    cs.device_us(torch, kern))
    for case in cases:
        for nm in dk.KERNEL_NAMES:
            row = []
            for which in ids:
                t = times.get((which, case, nm))
                if t is None:
                    row.append(f"{args.sources[which]} takes fewer offsets")
                    continue
                row.append(f"{args.sources[which]} {statistics.median(t):.2f}"
                           f" us ({', '.join(f'{v:.2f}' for v in t)})")
            print(f"[ab] {case} {nm}: " + "; ".join(row), flush=True)


if __name__ == "__main__":
    main()
