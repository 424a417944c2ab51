"""K2's tree at scale (`metrics/k2tree.*.py`) on synthetic contexts: the
program's record of the counted window's K2 calls on more than 64 tori,
paired with the host trace's K2 launches for the roofline share, and
their counters' work over their lanes for the two ratios."""

import types
from typing import NamedTuple

import pytest

from rtbench import kernel_bytes, manifest

SHARE = manifest.metric("k2tree.roofline_pct")
BOXES = manifest.metric("k2tree.box_tests_per_ray")
QUARTICS = manifest.metric("k2tree.quartics_per_ray")
N = 8_294_400          # one render_frames batch of four 1080p frames
TORI, CHUNKS, NODES = 1024, 64, 2047


def call(tori=TORI, attrs=True, occ_out=False, occ_or=False, box=None,
         prim=None, kernel="torus_closest_hit", lanes=N):
    return types.SimpleNamespace(
        kernel=kernel, lanes=lanes, attrs=attrs, tmax_out=False,
        occ_out=occ_out, occ_or=occ_or, nodes=2 * tori - 1,
        ranked=tori // 16 if tori > 64 else tori // 8, boxes=0, tori=tori,
        box_tests=box, quartics=prim)


class OldHitCall(NamedTuple):
    """The parent's `HitCall`: no work counts."""

    kernel: str
    lanes: int
    attrs: bool
    tmax_out: bool
    occ_out: bool
    occ_or: bool
    nodes: int
    ranked: int
    boxes: int
    tori: int


def context(segments, launches):
    """A traced run's context: `launches` maps a kernel's device name to
    the device seconds of each of its launches in the host's window."""
    prof = types.SimpleNamespace(kernel_seconds=lambda name: (
        len(launches.get(name, [])), sum(launches.get(name, []))))
    return types.SimpleNamespace(segments=segments, host_profile=prof,
                                 peak_bytes_per_s=1e12)


def counted():
    """A batch's closest query and its any-hit query after S1."""
    return [call(box=8 * N, prim=3 * N // 10),
            call(attrs=False, occ_out=True, occ_or=True, box=5 * N,
                 prim=N // 10)]


def test_the_bytes_are_k2s_contract():
    c = call()
    assert SHARE.call_bytes(c) == kernel_bytes.k2_bytes(
        N, NODES, CHUNKS, TORI, True)
    shadow = call(attrs=False, occ_out=True, occ_or=True)
    assert SHARE.call_bytes(shadow) == N * (7 + 2) * 4 + 2 * N + \
        (NODES * 9 + CHUNKS + TORI * 14) * 4


def test_calls_that_pair_give_the_share_and_the_ratios():
    calls = counted()
    total = sum(map(SHARE.call_bytes, calls))
    ctx = context([[N, N // 128, calls]],
                  {"torus_closest_hit": [0.002, 0.001]})
    assert SHARE.read(ctx) == pytest.approx(100.0 * total / 1e12 / 0.003)
    assert BOXES.read(ctx) == pytest.approx(13 * N / (2 * N))
    assert QUARTICS.read(ctx) == pytest.approx((3 * N // 10 + N // 10)
                                               / (2 * N))
    # two segments, calls over several entries
    segs = [[N, N // 128, calls], [N, 5, counted()]]
    ctx = context(segs, {"torus_closest_hit": [0.001] * 4})
    assert SHARE.read(ctx) == pytest.approx(100.0 * 2 * total / 1e12
                                            / 0.004)
    assert BOXES.read(ctx) == pytest.approx(6.5)


def test_a_count_mismatch_reads_no_share():
    segs = [[N, N // 128, counted()]]
    for launches in ([0.002], [0.001] * 3, []):
        ctx = context(segs, {"torus_closest_hit": launches})
        assert SHARE.read(ctx) is None
        # the ratios read the program's counts alone
        assert BOXES.read(ctx) == pytest.approx(6.5)
    ctx = context(segs, {"torus_closest_hit": [0.0, 0.0]})
    assert SHARE.read(ctx) is None
    ctx.host_profile = None
    assert SHARE.read(ctx) is None


@pytest.mark.parametrize("tori", [4, 64])
def test_k2_on_few_tori_reads_nothing(tori):
    # the fly-through's four tori: K2's calls there are not its tree at
    # scale, and the capture cells' and config 8's calls are not K2's
    calls = [call(tori=tori, box=2 * N, prim=N), call(
        tori=tori, attrs=False, occ_out=True, box=N, prim=0)]
    others = [call(kernel="tri_closest_hit", tori=0),
              call(kernel="tri_closest_hit_stream", tori=0)]
    for segs in ([[N, N // 128, calls]], [[N, N // 128, others]], []):
        ctx = context(segs, {"torus_closest_hit": [0.001, 0.001],
                             "tri_closest_hit": [0.001]})
        for reader in (SHARE, BOXES, QUARTICS):
            assert reader.read(ctx) is None, reader.NAME


def test_no_counts_read_no_ratio():
    # the program counts nothing on the CPU, and a parent program's
    # record has no counts: the share still reads, the ratios do not
    calls = [call(), call(attrs=False, occ_out=True, occ_or=True)]
    ctx = context([[N, N // 128, calls]], {"torus_closest_hit":
                                           [0.001, 0.001]})
    assert SHARE.read(ctx) is not None
    assert BOXES.read(ctx) is None and QUARTICS.read(ctx) is None
    # one uncounted call is enough
    mixed = [counted()[0], call(attrs=False, occ_out=True)]
    ctx = context([[N, N // 128, mixed]], {"torus_closest_hit":
                                           [0.001, 0.001]})
    assert BOXES.read(ctx) is None and QUARTICS.read(ctx) is None


def test_the_parents_records_do_not_raise():
    old = [OldHitCall("torus_closest_hit", N, True, False, False, False,
                      NODES, CHUNKS, 0, TORI),
           OldHitCall("torus_closest_hit", N, False, False, True, True,
                      NODES, CHUNKS, 0, TORI)]
    launches = {"torus_closest_hit": [0.002, 0.002]}
    ctx = context([[N, N // 128, old]], launches)
    assert SHARE.read(ctx) == pytest.approx(
        100.0 * sum(map(SHARE.call_bytes, old)) / 1e12 / 0.004)
    assert BOXES.read(ctx) is None and QUARTICS.read(ctx) is None
    # a record of [lanes, live spans] alone
    for segs in ([[N, N // 128]], [[N, N // 128, old], [N, 7]]):
        ctx = context(segs, launches)
        for reader in (SHARE, BOXES, QUARTICS):
            assert reader.read(ctx) is None, reader.NAME
