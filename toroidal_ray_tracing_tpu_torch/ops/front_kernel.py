"""R1, G1 and F1: the front door's per-ray work around the bounce loop.

The JAX package runs raygen, the trace and the block unswizzle inside one
jit (`render/renderer.py:36-65` `_frame_jit`), and its compaction gathers
fuse into the bounce loop (`trace/wavefront.py:218-231, :250-255`): XLA
fusions, no Pallas kernel. Here they are three hand-written CUDA kernels:

* R1 `raygen` (`csrc/raygen.cu`): raygen of a frame for both cameras
  (camera kind `PINHOLE` or `TOROIDAL`, the camera's `ray_params` passed
  by value): the block-major pixel, the jitter or the centered offset, the
  ray, written as (3, N) rows, (N, 3), or (`raygen_state`) straight into the
  bounce loop's (15, lanes) state with its initial rows and dead tail
  lanes.
* G1 `span_gather` (`csrc/frame.cu`): the kernel backend's bucket shrink:
  the prefix's 128-ray spans in the stable live-first order
  (`argsort(~live, stable=True)`) moved into a spare state buffer (all
  their rows where they land in the new prefix, origin and color past
  it), each span's original index and slot updated.
* F1 `frame_finish` (`csrc/frame.cu`): a frame's end: the color read
  through the slots (the unpermute), written row-major (the block
  unswizzle) as HWC or CHW, accumulated over the spp samples, and sample
  0's dumps (first hit, and the ray recomputed by R1's device function).

Each wrapper launches its kernel on CUDA tensors (or a CUDA device) and
runs its plain PyTorch twin (`raygen_plain`, `raygen_state_plain`,
`span_gather_plain`, `frame_finish_plain`) on the CPU; there is no
fallback from one to the other. The twins are the eager code they
replace; on the card the kernels reproduce their PyTorch call order bit
for bit (`csrc/raygen.cuh`).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from toroidal_ray_tracing_tpu_torch.ops.kernel_common import (F32, I32,
                                                              SEG_TMAX,
                                                              check_args,
                                                              launch)

PINHOLE, TOROIDAL = 0, 1     # camera kinds (csrc/raygen.cuh)
CAM_FLOATS = 24              # raygen.cuh kCamFloats
SPAN = 128                   # wavefront.COMPACT_SPAN
MOVED_ROWS = 12              # the state rows G1 moves (all but first hit)
KEPT_ROWS = [0, 1, 2, 6, 7, 8]   # the rows read past the new prefix
UNIT = 1.0 / np.sqrt(3.0)    # a dead tail lane's direction components
_F = np.float32


# ---------------------------------------------------------------------------
# plain twins
# ---------------------------------------------------------------------------


def pixel_coords(width: int, height: int, block: int = 1, device="cpu"):
    """Pixel (px, py) for flat index i, float32.

    block > 1 emits pixels in block-major order (b x b tiles, row-major
    within and across tiles): consecutive ray indices then form compact
    screen patches — a warp of the trace kernels covers a small screen
    patch, so its rays take similar paths. Callers un-swizzle with
    `block_unswizzle`."""
    i = torch.arange(width * height, dtype=torch.int32, device=device)
    if block <= 1:
        return (i % width).float(), (i // width).float()
    b = block
    wb = width // b
    blk = i // (b * b)
    off = i % (b * b)
    px = (blk % wb) * b + off % b
    py = (blk // wb) * b + off // b
    return px.float(), py.float()


def block_unswizzle(a, width: int, height: int, block: int):
    """(H*W, C) block-major -> (H, W, C) row-major."""
    c = a.shape[-1]
    if block <= 1:
        return a.reshape(height, width, c)
    b = block
    a = a.reshape(height // b, width // b, b, b, c)
    return a.permute(0, 2, 1, 3, 4).reshape(height, width, c)


def raygen_plain(kind: int, params, width: int, height: int, jitter=None,
                 block: int = 1, rows: bool = False, device="cpu"):
    """Plain twin of R1: the cameras' raygen as eager tensor ops. params:
    the camera's `ray_params` (pinhole: (view_inv, proj_inv); toroidal:
    (eye, [omega, theta, rho])). Returns (origins, dirs), (3, N) with rows,
    else (N, 3)."""
    px, py = pixel_coords(width, height, block, device)
    dim = 0 if rows else -1
    if kind == PINHOLE:
        view_inv, proj_inv = params
        if jitter is not None:
            px = px + jitter[:, 0]
            py = py + jitter[:, 1]
        else:
            px = px + 0.5
            py = py + 0.5
        dx = px / float(width) * 2.0 - 1.0
        dy = py / float(height) * 2.0 - 1.0
        # elementwise (no matmul): one rounding order everywhere
        pi = torch.as_tensor(proj_inv, device=device)
        tc = [pi[j, 0] * dx + pi[j, 1] * dy + pi[j, 2] + pi[j, 3]
              for j in range(3)]
        tn = torch.sqrt(tc[0] * tc[0] + tc[1] * tc[1] + tc[2] * tc[2])
        tc = [c / tn for c in tc]
        vi = torch.as_tensor(view_inv, device=device)
        dc = [vi[j, 0] * tc[0] + vi[j, 1] * tc[1] + vi[j, 2] * tc[2]
              for j in range(3)]
        dirs = torch.stack(dc, dim=dim)
        eye = vi[:3, 3][:, None] if rows else vi[:3, 3][None, :]
        return torch.broadcast_to(eye, dirs.shape).contiguous(), dirs
    if kind != TOROIDAL:
        raise ValueError(f"camera kind {kind}: want PINHOLE or TOROIDAL")
    eye, ang = params
    eye = torch.as_tensor(eye, device=device)
    ang = torch.as_tensor(ang, device=device)
    omega, theta, rho = ang[0], ang[1], ang[2]
    d_alfa = float(_F(360.0) / _F(width))
    d_beta = float(_F(360.0) / _F(height))
    if jitter is not None:
        px = px + jitter[:, 0]
        py = py + jitter[:, 1]
    alfa = d_alfa * px
    beta = d_beta * py
    a = torch.deg2rad(alfa + omega)
    b = torch.deg2rad(beta + theta)
    ca, sa = torch.cos(a), torch.sin(a)
    cb, sb = torch.cos(b), torch.sin(b)
    origins = torch.stack(
        [eye[0] + rho * ca, torch.broadcast_to(eye[1], ca.shape),
         eye[2] + rho * sa], dim=dim)
    dirs = torch.stack([ca * cb, sb, sa * cb], dim=dim)
    return origins, dirs


def fill_state_plain(state, active, origins, dirs, off: int, tail: int):
    """The bounce loop's first fill of columns [off, off + n + tail) of the
    (15, lanes) state: the (3, n) rays, color 0, attenuation 1, active;
    then `tail` dead lanes (origin 0, direction 1/sqrt(3)). The first-hit
    rows are left as they are: segment 0 writes them on every active lane,
    hit or miss, and only the n rays' are read."""
    n = origins.shape[1]
    live, dead = slice(off, off + n), slice(off + n, off + n + tail)
    state[0:3, live] = origins
    state[3:6, live] = dirs
    state[0:3, dead] = 0.0
    state[3:6, dead] = float(UNIT)
    cols = slice(off, off + n + tail)
    state[6:9, cols] = 0.0
    state[9:12, cols] = 1.0
    active[live] = True
    active[dead] = False


def raygen_state_plain(kind: int, params, width: int, height: int, jitter,
                       block: int, state, active, off: int, tail: int = 0):
    """Plain twin of R1 into the state (`raygen_state`)."""
    o, d = raygen_plain(kind, params, width, height, jitter, block,
                        rows=True, device=state.device)
    fill_state_plain(state, active, o, d, off, tail)


def span_order(live):
    """The span permutation that packs live spans first, each span keeping
    its place among its kind (stable)."""
    return torch.argsort(~live, stable=True)


def span_lanes(order):
    """The lane gather index that lays spans out in `order`."""
    ar = torch.arange(SPAN, device=order.device)
    return (order[:, None] * SPAN + ar).reshape(-1)


def span_gather_plain(cur, spare, act_in, act_out, spans, count, orig_in,
                      orig_out, slot, nb: int, fit: int,
                      tmax_out=None) -> None:
    """Plain twin of G1: the prefix's nb // 128 spans into `spare` in the
    stable live-first order, the spans past it in their slots; lanes
    [0, fit) (the new prefix) get rows 0-11 and the active mask, the rest
    only origin and color (`KEPT_ROWS`, the rows read there again);
    orig_out[p] = orig_in[order[p]] (identity for orig_in None) and
    slot[orig_out[p]] = p; with tmax_out, the new prefix's tmax row
    (SEG_TMAX where active, else 0). count is G1's; the twin needs no
    count."""
    s_old, s_total = nb // SPAN, cur.shape[1] // SPAN
    dev = cur.device
    perm = torch.cat([span_order(spans[:s_old]),
                      torch.arange(s_old, s_total, device=dev)])
    idx = span_lanes(perm)
    spare[:MOVED_ROWS, :fit] = cur[:MOVED_ROWS].index_select(1, idx[:fit])
    spare[KEPT_ROWS, fit:] = cur[KEPT_ROWS].index_select(1, idx[fit:])
    act_out[:fit] = act_in.index_select(0, idx[:fit])
    if tmax_out is not None:
        tmax_out[:fit] = torch.where(act_out[:fit], SEG_TMAX, 0.0)
    orig = (torch.arange(s_total, dtype=I32, device=dev) if orig_in is None
            else orig_in)
    orig_out.copy_(orig[perm])
    slot[orig_out.long()] = torch.arange(s_total, dtype=I32, device=dev)


def unpermute_rows(rows, slot):
    """(C, lanes) rows read through `slot` (original span -> slot): each
    original span's lanes back in place; `rows` itself when slot is None."""
    if slot is None:
        return rows
    c, lanes = rows.shape
    return rows.reshape(c, lanes // SPAN, SPAN).index_select(
        1, slot.long()).reshape(c, lanes)


def frame_finish_plain(kind: int, params, width: int, height: int,
                       block: int, state, first, slot, off: int, image,
                       s: int, spp: int, dumps=None, chw: bool = False):
    """Plain twin of F1: the frame at lanes [off, off + W*H) of the traced
    state: its color unpermuted and unswizzled into `image`, stored
    (sample 0), added (later samples), divided by spp (the last); with
    dumps (hp, o, d) the first hit from `first` and the frame's centered
    rays, unswizzled alike. image and dumps: (H, W, 3), or (3, H, W) with
    chw."""
    n = width * height

    def frame(rows):                       # (3, n) block-major -> layout
        a = block_unswizzle(rows.T, width, height, block)
        return a.permute(2, 0, 1) if chw else a

    c = frame(unpermute_rows(state[6:9], slot)[:, off:off + n])
    acc = c if s == 0 else image + c
    if s == spp - 1:
        acc = acc / float(spp)
    image.copy_(acc)
    if dumps is not None:
        o, d = raygen_plain(kind, params, width, height, None, block,
                            rows=True, device=state.device)
        for out, rows in zip(dumps, (first[12:15, off:off + n], o, d)):
            out.copy_(frame(rows))


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def cam_floats(kind: int, params, width: int, height: int):
    """The camera's 24 kernel parameters (raygen.cuh Cam.p) as a ctypes
    array."""
    p = np.zeros(CAM_FLOATS, np.float32)
    if kind == PINHOLE:
        view_inv, proj_inv = (np.asarray(m, np.float32) for m in params)
        p[:12] = proj_inv[:3].reshape(-1)
        p[12:] = view_inv[:3].reshape(-1)
    elif kind == TOROIDAL:
        eye, ang = (np.asarray(v, np.float32) for v in params)
        p[:3], p[3:6] = eye, ang
        p[6] = _F(360.0) / _F(width)
        p[7] = _F(360.0) / _F(height)
    else:
        raise ValueError(f"camera kind {kind}: want PINHOLE or TOROIDAL")
    return (ctypes.c_float * CAM_FLOATS)(*p.tolist())


def _check_frame(width: int, height: int, block: int):
    if width <= 0 or height <= 0:
        raise ValueError(f"frame {width}x{height}")
    if block > 1 and (width % block or height % block):
        raise ValueError(f"block {block} does not divide {width}x{height}")


def _jitter(jitter, n, device):
    check_args(device, jitter=(jitter, (n, 2), F32))


def raygen(kind: int, params, width: int, height: int, jitter=None,
           block: int = 1, rows: bool = False, device="cpu"):
    """R1 wrapper: the frame's rays, (3, N) with rows, else (N, 3). On a
    CUDA device it launches the kernel (or raises); on the CPU it runs
    `raygen_plain`. jitter: optional (N, 2) float32 on the device."""
    device = torch.device(device)
    _check_frame(width, height, block)
    n = width * height
    if device.type == "cpu":
        return raygen_plain(kind, params, width, height, jitter, block, rows,
                            device)
    if device.type != "cuda":
        raise ValueError(f"raygen on {device}: the kernel runs on CUDA, its "
                         "twin on the CPU")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    _jitter(jitter, n, device)
    shape = (3, n) if rows else (n, 3)
    o = torch.empty(shape, dtype=F32, device=device)
    d = torch.empty(shape, dtype=F32, device=device)
    cam = cam_floats(kind, params, width, height)
    row_stride, elem = (n, 1) if rows else (1, 3)
    with torch.cuda.device(device):
        launch("trt_raygen", cam, kind, width, height,
               block, jitter, n, 0, o, d, row_stride, elem, None, 0, None)
    return o, d


def raygen_state(kind: int, params, width: int, height: int, jitter,
                 block: int, state, active, off: int, tail: int = 0) -> None:
    """R1 into the bounce loop's state: the frame's rays into columns
    [off, off + W*H) of the (15, lanes) float32 `state` with their initial
    rows and `active`, then `tail` dead lanes. CUDA tensors launch the
    kernel (or raise); CPU tensors run `raygen_state_plain`."""
    _check_frame(width, height, block)
    n, lanes = width * height, state.shape[1]
    check_args(state.device, state=(state, (15, lanes), F32),
               active=(active, (lanes,), torch.bool))
    if off < 0 or tail < 0 or off + n + tail > lanes:
        raise ValueError(f"columns [{off}, {off + n + tail}) of {lanes}")
    if not state.is_cuda:
        raygen_state_plain(kind, params, width, height, jitter, block, state,
                           active, off, tail)
        return
    _jitter(jitter, n, state.device)
    cam = cam_floats(kind, params, width, height)
    base = state.data_ptr() + 4 * off
    launch("trt_raygen", cam, kind, width, height, block,
           jitter, n, tail, base, base + 4 * 3 * lanes, lanes, 1,
           base + 4 * 6 * lanes, lanes, active.data_ptr() + off)


def span_gather(cur, spare, act_in, act_out, spans, count, orig_in,
                orig_out, slot, nb: int, fit: int, tmax_out=None) -> None:
    """G1 wrapper, on a bucket shrink of the nb-lane prefix to its first
    `fit` lanes (whole numbers of spans; fit >= 128 x count). cur / spare:
    (15, lanes) float32 state buffers (spare gets the moved rows: 0-11 on
    lanes [0, fit), origin and color past it), act_in / act_out their
    (lanes,) bool masks (act_out written on [0, fit)), spans:
    S3's live flags (>= nb / 128), count: S3's int32 0-d live-span count of
    the prefix, orig_in: (lanes / 128,) int32 each slot's original span or
    None (nothing moved yet), orig_out and slot: (lanes / 128,) int32,
    written. tmax_out: optional (lanes,) float32 row (a segment plan's
    tmax), written on [0, fit): `kernel_common.SEG_TMAX` where act_out
    holds, else 0. CUDA tensors launch the kernel (or raise); CPU tensors
    run `span_gather_plain`."""
    lanes = cur.shape[1]
    s_total = lanes // SPAN
    dev = cur.device
    check_args(dev, cur=(cur, (15, lanes), F32),
               spare=(spare, (15, lanes), F32),
               act_in=(act_in, (lanes,), torch.bool),
               act_out=(act_out, (lanes,), torch.bool),
               count=(count, (), I32), orig_in=(orig_in, (s_total,), I32),
               orig_out=(orig_out, (s_total,), I32),
               slot=(slot, (s_total,), I32),
               tmax_out=(tmax_out, (lanes,), F32))
    if lanes % SPAN or nb % SPAN or fit % SPAN or not 0 < nb <= lanes \
            or not 0 <= fit <= nb:
        raise ValueError(f"prefix {nb} -> {fit} of {lanes} lanes: want "
                         f"whole {SPAN}-lane spans, fit <= nb")
    if (spans.device != dev or spans.dtype != torch.bool
            or spans.shape[0] < nb // SPAN or not spans.is_contiguous()):
        raise ValueError(f"spans: want >= {nb // SPAN} contiguous bools")
    if not cur.is_cuda:
        span_gather_plain(cur, spare, act_in, act_out, spans, count, orig_in,
                          orig_out, slot, nb, fit, tmax_out)
        return
    launch("trt_span_gather", cur, spare, act_in, act_out, spans, count,
           orig_in, orig_out, slot, nb // SPAN, fit // SPAN, s_total, lanes,
           tmax_out, SEG_TMAX)


def frame_finish(kind: int, params, width: int, height: int, block: int,
                 state, first, slot, off: int, image, s: int, spp: int,
                 dumps=None, chw: bool = False) -> None:
    """F1 wrapper: the frame at lanes [off, off + W*H) of a traced state
    into `image` (H, W, 3), or (3, H, W) with chw, contiguous: sample s of
    spp (0 stores, later ones add, the last divides by spp); dumps: (hp, o,
    d) in image's layout for sample 0, or None. state: the (15, lanes)
    buffer holding the color rows now, first: the one segment 0 ran on
    (the first hit), slot: (lanes / 128,) int32 original span -> slot, or
    None. CUDA tensors launch the kernel (or raise); CPU tensors run
    `frame_finish_plain`."""
    _check_frame(width, height, block)
    lanes, n = state.shape[1], width * height
    dev = state.device
    shape = (3, height, width) if chw else (height, width, 3)
    hp, o, d = dumps if dumps is not None else (None, None, None)
    check_args(dev, state=(state, (15, lanes), F32),
               first=(first, (15, lanes), F32),
               slot=(slot, (lanes // SPAN,), I32), image=(image, shape, F32),
               hp=(hp, shape, F32), o=(o, shape, F32), d=(d, shape, F32))
    if off < 0 or off + n > lanes or not 0 <= s < spp:
        raise ValueError(f"frame [{off}, {off + n}) of {lanes} lanes, "
                         f"sample {s} of {spp}")
    if dumps is not None and s != 0:
        raise ValueError("the dumps are sample 0's")
    if not state.is_cuda:
        frame_finish_plain(kind, params, width, height, block, state, first,
                           slot, off, image, s, spp, dumps, chw)
        return
    cam = cam_floats(kind, params, width, height)
    launch("trt_frame_finish", cam, kind, width, height,
           block, state.data_ptr() + 4 * 6 * lanes, slot, lanes, off,
           first.data_ptr() + 4 * 12 * lanes, image, s, spp, hp, o, d,
           int(chw))
