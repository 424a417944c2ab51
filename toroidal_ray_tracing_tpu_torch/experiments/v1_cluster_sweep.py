"""V1's one-CTA limit on the card: `kOneCtaBoxes` of `csrc/visit.cu` swept.

V1 ranks a segment's box sets in the CTA, or the thread-block cluster of
kCluster CTAs, that finishes its sums last: one CTA while every set has at
most kOneCtaBoxes boxes, else a cluster, each of whose CTAs sorts a
1/kCluster share of each set (a box's rank is the keys below its own in
every share). This script builds visit.cu once per limit (a copy of the
sources under `build/v1c<N>/`, all nvcc processes started together; 0
ranks every set in a cluster), plus builds that leave early (their
outputs not checked): "reduce", every CTA right after its partial sum
(the reduction alone), and the ranking CTAs after the anchor, after
sorting their shares and after gathering their peers'.
Each build runs on the origins of the first segment that ranks a set in a
`render` of configs 6, 5 (4K, 2 spp) and 8 (3,340 superblocks), with the
segment's sets and with none: the device time of its bare launch (20
launches captured in one CUDA graph, over 20), and for each limit its
anchor and every rank against the twin, bit for bit.

    python -m toroidal_ray_tracing_tpu_torch.experiments.v1_cluster_sweep [N ...]

(default limits 0 512 4096). Needs an NVIDIA GPU and nvcc. Prints the card's
name and power limit, then one JSON line per build and segment.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys

import torch

from toroidal_ray_tracing_tpu_torch.experiments.coop_sweep import (
    build_variants, entry)
from toroidal_ray_tracing_tpu_torch.experiments.k3_turns import graph_ms
from toroidal_ray_tracing_tpu_torch.experiments.redesign_split import (
    call, ranked_segment, recorded)
from toroidal_ray_tracing_tpu_torch.ops import visit_kernel as vk

ENTRY = "trt_visit_rank"
LIMIT = re.compile(r"constexpr int kOneCtaBoxes = \d+;")
# builds that leave early, to split the time (outputs not checked): every
# CTA after its partial sum; the ranking CTAs after the anchor, after
# sorting their shares, after gathering their peers' shares
STOPS = {
    "reduce": (re.compile(r"  // 2\. a ticket a CTA"),
               "  if (n_batch > {}) return;\n  // 2. a ticket a CTA"),
    "to the anchor": (re.compile(r"  // 4\. the ranks, set by set"),
                      "  if (n_batch > {}) return;\n  // 4. the ranks"),
    "to the sorted shares": (
        re.compile(r"  sort_share\(lo, hi, m, me \* share, share, a, mine, "
                   r"P\);\n"),
        "  sort_share(lo, hi, m, me * share, share, a, mine, P);\n"
        "  if (m > {}) return;\n"),
    "to the gathered shares": (
        re.compile(r"      cluster\.sync\(\);  +// no peer reads this "
                   r"CTA's share again\n"),
        "      cluster.sync();\n      if (m > {}) return;\n"),
}


def main(argv=None) -> int:
    limits = [int(v) for v in (argv if argv is not None else sys.argv[1:])] \
        or [0, 512, 4096]
    if not torch.cuda.is_available():
        print("v1_cluster_sweep: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    libs = {f"one CTA up to {n} boxes": p for n, p in build_variants(
        "visit.cu", "visit.cu", LIMIT, "constexpr int kOneCtaBoxes = {};",
        limits, "v1c").items()}
    for k, (name, (pattern, line)) in enumerate(STOPS.items()):
        libs[name] = build_variants("visit.cu", "visit.cu", pattern, line,
                                    [0], f"v1s{k}_")[0]
    fns = {name: entry(path, ENTRY) for name, path in libs.items()}
    dev = torch.device("cuda", torch.cuda.current_device())
    for num in (6, 5, 8):
        o, n_batch, sets = ranked_segment(num, dev)
        for tag, ss in (("sets", sets), ("no sets", [])):
            _, args = recorded(vk, lambda: vk.visit_ranks(o, n_batch, ss))
            ref_anchor, ref = vk.visit_ranks_plain(o, n_batch, ss)
            anchor, ranks = args[12], [a for a in (args[7], args[11])
                                       if a is not None]
            for name, fn in fns.items():
                row = {"build": name, "segment": f"config {num}",
                       "lanes": o.shape[1],
                       "boxes": [int(lo.shape[0]) for lo, _ in ss],
                       "device_ms": graph_ms(lambda fn=fn: call(fn, args))}
                if name not in STOPS:
                    anchor.zero_()
                    for r in ranks:
                        r.fill_(-1)
                    call(fn, args)
                    torch.cuda.synchronize()
                    row["bit_equal"] = bool(
                        torch.equal(anchor, ref_anchor)
                        and all(torch.equal(a, b)
                                for a, b in zip(ranks, ref)))
                print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
