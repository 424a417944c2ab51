"""K5's roofline share (`metrics/k5.roofline_pct.py`) on synthetic
contexts: the program's record of its calls paired with the host trace's
launches of K5 and K6, and its byte count against shapes worked by hand."""

import types

import pytest

from rtbench import manifest

K5 = manifest.metric("k5.roofline_pct")
N = 2_073_600          # one 1920x1080 frame's primary rays


def call(kernel="tri_closest_hit_stream", lanes=N, attrs=True,
         occ_out=False, occ_or=False):
    # about config 8's tables: 3,340 superblocks of 4 clusters, a tree of
    # 6,679 nodes
    return types.SimpleNamespace(
        kernel=kernel, lanes=lanes, attrs=attrs, tmax_out=False,
        occ_out=occ_out, occ_or=occ_or, nodes=6679, ranked=3340,
        boxes=13360, tori=0)


def context(segments, launches):
    """A traced run's context: `launches` maps a kernel's device name to
    the device seconds of each of its launches in the host's window."""
    prof = types.SimpleNamespace(kernel_seconds=lambda name: (
        len(launches.get(name, [])), sum(launches.get(name, []))))
    return types.SimpleNamespace(segments=segments, host_profile=prof,
                                 peak_bytes_per_s=1e12)


def test_the_bytes_of_a_closest_and_an_any_hit_call():
    tables = (6679 * 9 + 3340 + 13360 * 6) * 4
    # rays in 7 words, t / index / u / v out, 21 attribute rows out
    assert K5.k5_bytes(N, 6679, 3340, 13360, attrs=True) == \
        N * (7 + 4 + 21) * 4 + tables
    # the any-hit query after S1: the occlusion byte read and ORed
    assert K5.k5_bytes(N, 6679, 3340, 13360, attrs=False, occ_out=True,
                       occ_or=True) == N * (7 + 4) * 4 + 2 * N + tables
    assert K5.k5_bytes(N, 6679, 3340, 13360, attrs=False,
                       tmax_out=True) == N * (7 + 4) * 4 + 4 * N + tables
    assert K5.call_bytes(call()) == K5.k5_bytes(N, 6679, 3340, 13360, True)


def test_calls_that_pair_with_launches_give_the_share():
    calls = [call(), call(attrs=False, occ_out=True, occ_or=True)]
    total = sum(map(K5.call_bytes, calls))
    segs = [[N, N // 128, calls]]
    ctx = context(segs, {"tri_closest_hit_stream": [0.002, 0.003]})
    assert K5.read(ctx) == pytest.approx(100.0 * total / 1e12 / 0.005)


def test_unpaired_counts_read_nothing():
    segs = [[N, N // 128, [call(), call(attrs=False, occ_out=True)]]]
    assert K5.read(context(segs, {"tri_closest_hit_stream": [0.002]})) \
        is None
    assert K5.read(context(segs, {"tri_closest_hit_stream":
                                  [0.002] * 3})) is None


def test_the_parents_two_item_record_reads_nothing():
    launches = {"tri_closest_hit_stream": [0.002, 0.003]}
    assert K5.read(context([[N, N // 128], [N, 7]], launches)) is None
    # one entry without calls is enough
    segs = [[N, N // 128, [call(), call(attrs=False)]], [N, 7]]
    assert K5.read(context(segs, launches)) is None


def test_no_stream_call_reads_nothing():
    # the capture's cells: K1 and K2 calls alone
    segs = [[N, N // 128, [call(kernel="tri_closest_hit"),
                           call(kernel="torus_closest_hit")]]]
    launches = {"tri_closest_hit": [0.001], "torus_closest_hit": [0.001]}
    assert K5.read(context(segs, launches)) is None
    assert K5.read(context([], launches)) is None
    ctx = context(segs, launches)
    ctx.host_profile = None
    assert K5.read(ctx) is None


def test_k6_launches_count_as_the_stream_walks():
    grouped = "tri_closest_hit_stream_grouped"
    calls = [call(kernel=grouped), call(kernel=grouped, attrs=False,
                                        occ_out=True)]
    total = sum(map(K5.call_bytes, calls))
    ctx = context([[N, N // 128, calls]], {grouped: [0.001, 0.001]})
    assert K5.read(ctx) == pytest.approx(100.0 * total / 1e12 / 0.002)
    # a run that mixes the two walks reads both
    mixed = [[N, N // 128, [call(), calls[1]]]]
    ctx = context(mixed, {"tri_closest_hit_stream": [0.001],
                          grouped: [0.001]})
    assert K5.read(ctx) == pytest.approx(
        100.0 * (K5.call_bytes(call()) + K5.call_bytes(calls[1]))
        / 1e12 / 0.002)
