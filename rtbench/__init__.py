"""The benchmark of the PyTorch and CUDA ray tracer
(`toroidal_ray_tracing_tpu_torch`) on one NVIDIA H100.

One command runs one cell once:

    python3 -m rtbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Everything a cell needs is data found by name under this folder:
`configs/<config>.json` (the scene and frame), `workloads/<cell>.json`
(its config, traffic, sample and limits), `traffic/<traffic>.json` (the
closed-loop call pattern that `traffic/generator.py` turns into front-door
calls), `metrics/<metric>.py` (one reader per per-layer metric). The plain
reference that decides `correct` lives in `reference/` and imports nothing
of the program.
"""
