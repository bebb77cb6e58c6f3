"""Multi-scalar multiplication: Pippenger and Straus (PyTorch).

The port of `secp256k1_tpu.ops.msm`, function for function under the JAX
names:

- digits: `_digits` (unsigned windows of a width that divides 16) and
  `_signed_digits` (widths 5 and 6: magnitude | sign << 6 and a carry
  window);
- the bucket path, `_window_sums_fused`: one `msm_bucket_accumulate_all` for
  every window (per-lane-slot partial buckets), `_lane_merge` over the
  slots, then `_weighted_bucket_sum`;
- the sort + scan path: a stable sort by digit, `_segmented_point_scan`
  with the complete add as its combiner, the scatter of segment tails
  (`_bucket_accumulate`, trash slot n_buckets) and `_weighted_bucket_sum`;
- `combine_windows` (the Horner fold: one `msm_fold` launch where JAX
  has a `lax.scan`), `multi_scalar_mult` and `multi_scalar_mult_straus`.

`_fused_msm_ok` takes the decision the JAX package takes on its TPU, on
both devices here, so the port's projective result equals what the JAX
package returns on its accelerator.  Where JAX batches windows with `vmap`
or `lax.map` (the weighted sums, the sort + scan accumulation), the windows
here are a batch axis of the planes: every point add is lane-wise, so each
window's sums are the ones a call of its own would give.

Layout: plane stacks [3, 16, *batch, N] (limbs before lanes) in the scans
and merges, [K, 3, 16] row stacks at the boundaries, as in the JAX module.
The device follows the tensors: on CUDA the point adds, doublings, the
bucket accumulation and the fold launch their kernels; on the CPU the
wrappers run the plain versions.  A result is a Point of batch (1,) (JAX: batch ()).
"""

from __future__ import annotations

import math

import torch

from ..utils import profiling
from . import limbs as lb
from . import point as pt
from . import table as tbl
from .cuda import kernels as K

NLIMBS = lb.NLIMBS

# Lane slots of the bucket kernel: the JAX kernel's blk (8) x 128 lanes.
# Point n goes to slot n mod MSM_SLOTS; the partial buckets, and so the
# projective result, depend on it.
MSM_SLOTS = 1024

# The sort + scan path batches at most this many (window, point) lanes.
SCAN_LANES = 1 << 22


def _rows_to_point(v) -> pt.Point:
    """[K, 3, 16] row stack -> Point batch (K,)."""
    return pt.Point(v[:, 0].t(), v[:, 1].t(), v[:, 2].t())


def _point_to_rows(p: pt.Point):
    return torch.stack([p.x.t(), p.y.t(), p.z.t()], dim=1)


def _planes_to_point(v) -> pt.Point:
    """[3, 16, K] plane stack -> Point batch (K,)."""
    return pt.Point(v[0], v[1], v[2])


def _point_to_planes(p: pt.Point):
    return torch.stack([p.x, p.y, p.z], dim=0)


def _planes_add(v1, v2):
    """Point-add two [3, 16, *batch] plane stacks lane by lane: one
    `point_add` over all their lanes."""
    lanes = math.prod(v1.shape[2:])
    out = pt.add(_planes_to_point(v1.reshape(3, NLIMBS, lanes)),
                 _planes_to_point(v2.reshape(3, NLIMBS, lanes)))
    return _point_to_planes(out).reshape(v1.shape)


def _rows_add(v1, v2):
    """Point-add two [K, 3, 16] row stacks."""
    return _point_to_rows(pt.add(_rows_to_point(v1), _rows_to_point(v2)))


def _seg_combine(left, right):
    """Segmented-sum combine on (flags [*batch, K], planes
    [3, 16, *batch, K])."""
    f_l, v_l = left
    f_r, v_r = right
    added = _planes_add(v_l, v_r)
    return f_l | f_r, torch.where(f_r, v_r, added)


def _segmented_point_scan(flags, planes):
    """Inclusive segmented prefix point-sum along the last axis (~2N adds
    in O(log N) levels by pairwise recursion), in plane layout
    [3, 16, *batch, N].  flags: bool [*batch, N] (or [N] for every batch
    row), True where a new segment starts.  Position i gets the sum of its
    segment's prefix; segment tails hold full sums.  An odd length is padded
    with a fresh singleton segment, dropped after."""
    n = planes.shape[-1]
    if n == 1:
        return planes
    if n % 2:
        flags = torch.cat([flags, torch.ones_like(flags[..., :1])], -1)
        planes = torch.cat([planes, planes[..., -1:]], -1)
        return _segmented_point_scan(flags, planes)[..., :n]
    f_e, v_e = flags[..., 0::2], planes[..., 0::2]
    f_o, v_o = flags[..., 1::2], planes[..., 1::2]
    pf, pv = _seg_combine((f_e, v_e), (f_o, v_o))      # N/2 adds
    if pv.shape[-1] == 1:
        sv_pairs = pv
    else:
        sv_pairs = _segmented_point_scan(pf, pv)
    prev = sv_pairs[..., :-1]
    prev_f = torch.zeros_like(f_e[..., 1:])
    _, out_even_tail = _seg_combine((prev_f, prev),
                                    (f_e[..., 1:], v_e[..., 1:]))  # N/2-1
    out_even = torch.cat([v_e[..., :1], out_even_tail], -1)
    return torch.stack([out_even, sv_pairs], -1).reshape(planes.shape)


def _digits(scalars, window_bits: int):
    """[16, N] scalar plane -> int32 [256 / w, N] unsigned window digits,
    least significant window first (w divides the 16-bit limb)."""
    assert lb.LIMB_BITS % window_bits == 0
    return tbl._raw_digits(scalars, window_bits,
                           256 // window_bits).to(lb.DTYPE)


def _signed_digits(scalars, window_bits: int):
    """[16, N] scalar plane -> int32 [ceil(256 / w) + 1, N] signed-window
    digits, least significant window first, each magnitude (bits 0-5, in
    [0, 2^(w-1)]) | sign << 6; digit value (-1)^sign * magnitude, the last
    window the recoding carry.  A window may straddle two limbs.  The
    recoding is `table.signed_recode`, whose threshold (a digit plus carry
    above 2^(w-1) turns negative) is the JAX scan's `t > half`; its carry
    chain spans at most 62 windows, so the width is 5 or 6, the widths
    `_window_sums_fused` uses."""
    assert 5 <= window_bits <= 6
    n_windows = -(-256 // window_bits)
    s = scalars.to(lb.WIDE)
    bit = torch.arange(n_windows, device=s.device) * window_bits
    limb, sh = bit // lb.LIMB_BITS, (bit % lb.LIMB_BITS).unsqueeze(1)
    lo = s.index_select(0, limb)
    hi = s.index_select(0, (limb + 1).clamp(max=NLIMBS - 1))
    hi = hi * (limb + 1 < NLIMBS).unsqueeze(1)
    d = ((lo >> sh) | (hi << (lb.LIMB_BITS - sh))) & ((1 << window_bits) - 1)
    return tbl.signed_recode(d, window_bits, 6)


def _bucket_accumulate(point_planes, digits, n_buckets: int):
    """Bucket sums as rows [*batch, n_buckets, 3, 16].

    point_planes: [3, 16, N]; digits: [*batch, N] (one window, or a batch of
    windows).  Stable sort by digit, segmented-scan point sums, scatter of
    the segment tails (non-tails go to the trash slot n_buckets); untouched
    buckets stay the identity."""
    order = torch.argsort(digits, dim=-1, stable=True)
    sorted_digits = digits.gather(-1, order)
    sorted_planes = point_planes[..., order]

    # Segment starts: position 0 or digit change.
    prev = torch.cat([sorted_digits[..., :1] + 1, sorted_digits[..., :-1]],
                     -1)
    seg_start = sorted_digits != prev
    summed = _segmented_point_scan(seg_start, sorted_planes)

    # Segment tails hold the full per-digit sums.
    nxt = torch.cat([sorted_digits[..., 1:], sorted_digits[..., -1:] + 1], -1)
    is_tail = sorted_digits != nxt
    idx = torch.where(is_tail, sorted_digits, n_buckets).long()
    batch = tuple(digits.shape[:-1])
    ident = _point_to_rows(pt.identity((n_buckets + 1,),
                                       point_planes.device))
    buckets = ident.expand(batch + ident.shape).clone()
    values = torch.movedim(summed, (0, 1), (-2, -1))     # [*batch, N, 3, 16]
    buckets.scatter_(len(batch), idx[..., None, None].expand(values.shape),
                     values)
    return buckets[..., :n_buckets, :, :]


def _weighted_bucket_sum(buckets):
    """sum_{b>=1} b * bucket_b by a reverse cumulative point-sum and a
    pairwise reduction.  buckets: rows [*batch, K, 3, 16] (slot 0 is the
    digit-0 bucket, dropped).  S_j = sum_{b>=j} bucket_b; result
    sum_{j>=1} S_j, rows [*batch, 3, 16]."""
    planes = torch.movedim(buckets, (-2, -1), (0, 1))    # [3, 16, *batch, K]
    rev = planes.flip(-1)
    flags = torch.zeros(rev.shape[-1], dtype=torch.bool, device=rev.device)
    suffix = _segmented_point_scan(flags, rev).flip(-1)  # S_0 ... S_{K-1}
    terms = suffix[..., 1:]                              # drop S_0
    k = terms.shape[-1]
    while k > 1:
        half = k // 2
        pair = _planes_add(terms[..., :half], terms[..., half:2 * half])
        if k % 2:
            pair = torch.cat([pair, terms[..., 2 * half:]], -1)
        terms = pair
        k = terms.shape[-1]
    return torch.movedim(terms[..., 0], (0, 1), (-2, -1))


def _lane_merge(buckets_lanes):
    """[K, 3, 16, M] per-lane-slot buckets -> [K, 3, 16] rows by a pairwise
    point-add tree over the slot axis (the left half of the slots plus the
    right half, level by level; an odd slot is carried to the next level)."""
    k = buckets_lanes.shape[0]
    v = buckets_lanes.reshape(k, 3, NLIMBS, -1)
    v = torch.movedim(v, 0, -2)                          # [3, 16, K, M]
    m = v.shape[-1]
    while m > 1:
        half = m // 2
        pair = _planes_add(v[..., :half], v[..., half:2 * half])
        if m % 2:
            pair = torch.cat([pair, v[..., 2 * half:]], -1)
        v = pair
        m = v.shape[-1]
    return torch.movedim(v[..., 0], -1, 0)               # [K, 3, 16]


def _window_sums_fused(scalars, points: pt.Point, window_bits: int):
    """The bucket path: one `msm_bucket_accumulate_all` for every window,
    one batched lane merge over the W * nb bucket rows and one batched
    weighted sum.  w <= 4 takes unsigned digits (2^w - 1 buckets); w in
    (5, 6) signed digits (2^(w-1) buckets and a carry window).  Returns
    rows [W(+1), 3, 16]."""
    signed = window_bits > 4
    if signed:
        n_buckets = 1 << (window_bits - 1)
        digits = _signed_digits(scalars, window_bits)    # [W+1, N]
    else:
        n_buckets = (1 << window_bits) - 1               # digits 1..2^w-1
        digits = _digits(scalars, window_bits)           # [W, N]
    w = digits.shape[0]
    lanes_all = K.msm_bucket_accumulate_all(
        digits.contiguous(), *(c.to(lb.DTYPE).contiguous() for c in points),
        n_buckets, signed_digits=signed, m_slots=MSM_SLOTS)
    buckets = _lane_merge(lanes_all.reshape(w * n_buckets, 3, NLIMBS,
                                            MSM_SLOTS))
    buckets = buckets.reshape(w, n_buckets, 3, NLIMBS)
    # _weighted_bucket_sum indexes buckets by digit: restore slot 0.
    ident = _point_to_rows(pt.identity((1,), buckets.device))
    ident = ident.expand(w, 1, 3, NLIMBS)
    return _weighted_bucket_sum(torch.cat([ident, buckets], 1))


def _fused_msm_ok(points: pt.Point, window_bits: int) -> bool:
    """Whether the bucket path runs: the JAX package's rule on its TPU
    (w in (4, 5, 6), a flat batch of N >= 2048 points, N % 1024 == 0),
    taken on both devices here."""
    if window_bits not in (4, 5, 6):
        return False
    n = points.x.shape[-1]
    return points.x.dim() == 2 and n >= 2048 and n % 1024 == 0


def pippenger_window_sums(scalars, points: pt.Point, window_bits: int):
    """Per-window weighted bucket sums: rows [n_windows, 3, 16].  The
    shard-local piece of a sharded MSM."""
    if _fused_msm_ok(points, window_bits):
        return _window_sums_fused(scalars, points, window_bits)

    if lb.LIMB_BITS % window_bits:
        raise ValueError("the sort + scan path needs window_bits dividing "
                         f"the 16-bit limb, got {window_bits}")
    n_buckets = 1 << window_bits
    digits = _digits(scalars, window_bits)               # [W, N]
    point_planes = _point_to_planes(points)              # [3, 16, N]
    chunk = max(1, SCAN_LANES // digits.shape[1])
    return torch.cat([
        _weighted_bucket_sum(_bucket_accumulate(point_planes, d, n_buckets))
        for d in digits.split(chunk)])                   # [W, 3, 16]


def combine_windows(window_sums, window_bits: int) -> pt.Point:
    """Horner fold: sum_w 2^(c*w) W_w, most significant window first, one
    `msm_fold` (window_bits doublings and one complete add a window, in
    one launch on CUDA).  window_sums: rows [W, 3, 16]."""
    return pt.Point(*K.msm_fold(window_sums.to(lb.DTYPE).contiguous(),
                                window_bits))


def multi_scalar_mult(scalars, points: pt.Point,
                      window_bits: int | None = None) -> pt.Point:
    """sum_i scalars[:, i] * points[i], a single-instance MSM.

    scalars: [16, N] canonical plane; points: Point of batch (N,), on the
    same device.  window_bits=None chooses as the JAX package does: 4 when
    the bucket path applies (unsigned digits, 15 buckets: the JAX comment
    "signed digits, 8 buckets" disagrees with its code, which this follows),
    else the sort + scan path at 8 from 2^14 points up and 4 below.
    Spans: the `msm.call` root, `msm.window_sums` and `msm.fold`."""
    if window_bits is None:
        if _fused_msm_ok(points, 4):
            window_bits = 4
        else:
            window_bits = 8 if points.x.shape[-1] >= (1 << 14) else 4
    on_card = scalars.is_cuda
    with profiling.entry("msm"):
        with profiling.span("msm.window_sums", on_card):
            wsums = pippenger_window_sums(scalars, points, window_bits)
        with profiling.span("msm.fold", on_card):
            return combine_windows(wsums, window_bits)


def multi_scalar_mult_straus(scalars, points: pt.Point) -> pt.Point:
    """4-bit Straus interleaving, better for small N (< ~64): per-lane
    tables of 15 multiples, a shared window schedule (4 doublings, a masked
    table lookup and a complete add, digit 0 passed through), then a
    pairwise reduction of the lanes."""
    n = points.x.shape[-1]
    lane_tables = tbl.build_lane_table(points)           # [15, 3, 16, N]
    digits = _digits(scalars, 4)                         # [64, N]
    acc = pt.identity((n,), scalars.device)
    for dig in digits.flip(0):
        for _ in range(4):
            acc = pt.double(acc)
        sel = tbl.lookup_lane_table(lane_tables, dig)
        acc = pt.select(dig == 0, acc, pt.add(acc, sel))
    rows = _point_to_rows(acc)
    k = n
    while k > 1:
        half = k // 2
        pair = _rows_add(rows[:half], rows[half:2 * half])
        if k % 2:
            pair = torch.cat([pair, rows[2 * half:]], 0)
        rows = pair
        k = rows.shape[0]
    return pt.Point(*rows[0].unsqueeze(-1))
