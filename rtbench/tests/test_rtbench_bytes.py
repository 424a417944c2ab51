"""The hit kernels' byte counts against shapes worked by hand."""

import types

import torch

from rtbench import kernel_bytes as kb

N = 2_073_600          # one 1920x1080 frame's primary rays


def test_k1_closest_with_attributes():
    # rays in 7 words, t / index / u / v out, 21 attribute rows out; a tree
    # of 361 nodes (9 words) over 181 cluster boxes (a rank word each)
    want = N * (7 + 4 + 21) * 4 + (361 * 9 + 181) * 4
    assert kb.k1_bytes(N, 361, 181, attrs=True) == want
    assert want == 265_434_520      # PERF.md's 0.0798 ms at 3.35 TB/s: 267 MB


def test_k1_any_hit_folds():
    # occlusion: t / index / u / v, the occlusion byte read and written
    # (ORed after S1), the next kernel's tmax
    want = N * (7 + 4) * 4 + 2 * N + N * 4 + (361 * 9 + 181) * 4
    assert kb.k1_bytes(N, 361, 181, attrs=False, tmax_out=True,
                       occ_out=True, occ_or=True) == want


def test_k2_closest_with_attributes():
    # 8.3M rays of config 5; t / index, 15 attribute rows; 4 tori padded
    # to a chunk of 8 rows (transform 12, radii 2, material 12 words); a
    # one-chunk tree of 1 node
    n = 3840 * 2160
    want = n * (7 + 2 + 15) * 4 + (1 * 9 + 1 + 8 * (14 + 12)) * 4
    assert kb.k2_bytes(n, 1, 1, 8, attrs=True) == want
    shadow = n * (7 + 2) * 4 + n + (9 + 1 + 8 * 14) * 4
    assert kb.k2_bytes(n, 1, 1, 8, attrs=False, occ_out=True) == shadow


def test_a_recorded_call_counts_its_arguments():
    tables = types.SimpleNamespace(
        clo=torch.zeros(181, 3), box_test=True, tree_lo=torch.zeros(361, 3))
    args = {"origins": torch.zeros(3, 1024), "tables": tables,
            "attr_tables": (1, 2, 3), "tmax_out": None, "occ_out": None,
            "occ_or": False}
    assert kb._k1_call(args) == kb.k1_bytes(1024, 361, 181, True)
    tt = types.SimpleNamespace(tree_lo=torch.zeros(1, 3),
                               clo=torch.zeros(1, 3),
                               w2o_rows=torch.zeros(8, 12))
    args = {"origins": torch.zeros(3, 256), "tables": tt,
            "want_attrs": False, "occ_out": torch.zeros(256),
            "occ_or": True}
    assert kb._k2_call(args) == kb.k2_bytes(256, 1, 1, 8, False, True, True)


def test_the_record_restores_the_entries():
    from toroidal_ray_tracing_tpu_torch.ops import torus_kernel, trace_kernel

    k1, k2 = (trace_kernel.tri_closest_hit,
              torus_kernel.torus_closest_hit_chunked)
    out = {}
    with kb.record_calls(out):
        assert trace_kernel.tri_closest_hit is not k1
    assert trace_kernel.tri_closest_hit is k1
    assert torus_kernel.torus_closest_hit_chunked is k2
    assert out == {"tri_closest_hit": [], "torus_closest_hit": []}


def test_a_roofline_reads_only_calls_paired_with_launches():
    from rtbench import manifest

    k1 = manifest.metric("k1.roofline_pct")
    launches = []
    prof = types.SimpleNamespace(
        kernel_seconds=lambda name: (len(launches), sum(launches)))
    ctx = types.SimpleNamespace(kernel_calls={}, host_profile=prof,
                                peak_bytes_per_s=1e12)
    assert k1.read(ctx) is None                 # no K1 call in the cell
    ctx.kernel_calls = {"tri_closest_hit": [2e9, 2e9]}
    launches[:] = [0.01]
    assert k1.read(ctx) is None                 # calls and launches unpaired
    launches[:] = [0.005, 0.005]
    assert k1.read(ctx) == 40.0                 # 4 GB at 1 TB/s in 10 ms
