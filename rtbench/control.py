"""The control of the check: the plain reference put in the program's
place and computed in the precision below the configuration's (bfloat16
for float32), at the cell's own frame size, judged by the same numbers as
a run. Each compared number's smallest control reading is the upper end
its limit is set below (PERF.md).

    python3 -m rtbench.control --workload <name> --seeds 11 12 13 \
        [--calls 2000] [--device cuda]

For each seed it draws the answering calls a window of `--calls` calls
would offer the check, and the pixels of their frames, as a run draws
them; the "program's" answers are the reference's in bfloat16. Prints one
JSON line a seed with the numbers and whether the cell's limits pass them
(they must not).
"""

from __future__ import annotations

import argparse
import itertools
import json

import torch

from rtbench import check, frontdoor, manifest, scenedata
from rtbench.reference import scene as ref_scene
from rtbench.traffic import generator


def control(cell: str, seed: int, calls: int, device, root=manifest.ROOT,
            dtype=torch.bfloat16) -> dict:
    wl = manifest.workload(cell, root)
    cfg = manifest.config(wl["config"], root)
    tr = manifest.traffic(wl["traffic"], root)
    models = scenedata.models(cfg["scene"])
    exact = ref_scene.tables(models, device)
    low = ref_scene.tables(models, device, dtype)
    res = check.Sample(int(tr["sample"]["calls"]),
                       generator.rng(seed, generator.RESERVOIR))
    spp = int(cfg.get("spp", 1))
    for c in itertools.islice(generator.calls(tr, seed, spp), calls):
        if frontdoor.answer_keys(c):
            res.offer(c.door, lambda c=c: c)
    g = generator.rng(seed, generator.PIXELS)
    items = []
    for c in res.items:
        keys = frontdoor.answer_keys(c)
        for f in range(c.frames):
            xs, ys = check.draw_pixels(g, cfg["width"], cfg["height"],
                                       int(tr["sample"]["pixels"]))
            items.append((c, f, xs, ys, keys))
    lows = check.reference_answers(items, cfg, low, dtype)
    items = [(c, f, xs, ys, {k: lo[k] for k in keys})
             for (c, f, xs, ys, keys), lo in zip(items, lows)]
    refs = check.reference_answers(items, cfg, exact)
    nums = check.numbers(items, refs)
    passed, checks = check.verdict(nums, wl["limits"])
    return {"workload": cell, "seed": seed, "dtype": str(dtype),
            "passes_limits": passed, "checks": checks}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--calls", type=int, default=2000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for seed in args.seeds:
        print(json.dumps(control(args.workload, seed, args.calls,
                                 torch.device(args.device))), flush=True)


if __name__ == "__main__":
    main()
