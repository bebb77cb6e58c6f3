"""Batched secp256k1 group: complete projective formulas on limb planes.

The port of `secp256k1_tpu.ops.point`: points are projective (X, Y, Z) with
x = X/Z, y = Y/Z and identity (0, 1, 0), under the complete formulas of
Renes-Costello-Batina 2015 (Algorithms 7, 8 and 9 with a = 0, b3 = 21),
step for step in the order of the Pallas bodies `_point_add_body`,
`_point_add_mixed_body` and `_point_double_body`.  Following the same steps
is what makes the projective X, Y, Z equal to the JAX package's, and not
only the affine point.

`add`, `add_mixed` and `double` without a ring go to the point kernel
wrappers (`point_add`, `point_add_mixed`, `point_double`), and `double_n`
of a multiple of 4 to `point_double4`, as the JAX package's
`_maybe_pallas` does: one launch each on CUDA, whatever the batch width;
the composed formula under `fe.F_PLAIN` on the CPU.  Given a ring `f`, a
formula composes its steps from that ring's ops: the plain versions of the
kernels pass `fe.F_PLAIN`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import field as fe
from . import limbs as lb
from .cuda import kernels as K
from ..utils import batching as bt

B3 = 21  # 3*b for y^2 = x^3 + 7

GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8


class Point(NamedTuple):
    """Batch of projective points; each field an int32 [16, B] plane."""
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    @property
    def batch_shape(self):
        return self.x.shape[1:]


def identity(batch_shape, device) -> Point:
    return Point(fe.zero(batch_shape, device), fe.one(batch_shape, device),
                 fe.zero(batch_shape, device))


def generator(batch_shape, device) -> Point:
    return Point(fe.const(GX, batch_shape, device).contiguous(),
                 fe.const(GY, batch_shape, device).contiguous(),
                 fe.one(batch_shape, device))


def from_affine_ints(pairs, device=None) -> Point:
    """Host helper: a list of python-int (x, y) pairs -> Point batch
    (len(pairs),) with Z = 1, on `device` (None: the GPU)."""
    dev = bt.resolve_device(device)
    xs, ys = (torch.as_tensor(lb.int_to_limbs_batch([q[c] for q in pairs]),
                              dtype=lb.DTYPE, device=dev) for c in range(2))
    return Point(xs, ys, fe.one((len(pairs),), dev))


def _planes(p: Point):
    """The planes of p as the kernel wrappers take them: contiguous int32
    [16, B]."""
    return tuple(c.to(lb.DTYPE).contiguous() for c in p)


def add(p: Point, q: Point, f=None) -> Point:
    """Complete projective addition, RCB 2015 Algorithm 7 (a = 0).

    Without a ring: one `point_add` (one launch on CUDA).  Given a ring,
    the composed formula: the 12 multiplies fall into two rounds of six
    independent ones, and the adds between them into a few more; each round
    is one batched ring op (`ModRing.many`).  Every intermediate is the
    value that the step order of `_point_add_body` computes (the step's
    name is in the comment)."""
    if f is None:
        return Point(*K.point_add(*_planes(p), *_planes(q)))
    x1, y1, z1 = p
    x2, y2, z2 = q
    s1, s2, s3, s4, s5, s6 = f.many(
        "add", (x1, y1), (x2, y2), (y1, z1), (y2, z2), (x1, z1), (x2, z2))
    t0, t1, t2, m3, m4, m5 = f.many(
        "mul", (x1, x2), (y1, y2), (z1, z2), (s1, s2), (s3, s4), (s5, s6))
    u, v, w, dd = f.many("add", (t0, t1), (t1, t2), (t0, t2), (t0, t0))
    t3, t4, y3 = f.many("sub", (m3, u), (m4, v), (m5, w))
    t0b = f.add(dd, t0)                                  # t0 = 3*t0
    t2b, y3b = f.mul_word(t2, B3), f.mul_word(y3, B3)
    z3 = f.add(t1, t2b)
    t1b = f.sub(t1, t2b)
    xa, t2c, ya, t1c, t0c, za = f.many(
        "mul", (t4, y3b), (t3, t1b), (y3b, t0b), (t1b, z3), (t0b, t3),
        (z3, t4))
    x3 = f.sub(t2c, xa)                                  # x3 = t2 - x3
    y3c, z3c = f.many("add", (t1c, ya), (za, t0c))       # y3 = t1 + y3 ...
    return Point(x3, y3c, z3c)


def add_mixed(p: Point, qx, qy, f=None) -> Point:
    """Mixed addition (Z2 = 1), RCB 2015 Algorithm 8: one
    `point_add_mixed` without a ring; given a ring, in the batched rounds
    of `add`.  The affine addend cannot be the identity; callers mask the
    digit-0 case."""
    if f is None:
        return Point(*K.point_add_mixed(
            *_planes(p), *(c.to(lb.DTYPE).contiguous() for c in (qx, qy))))
    x1, y1, z1 = p
    x2, y2 = qx, qy
    s1, s2 = f.many("add", (x2, y2), (x1, y1))
    t0, t1, m3, a4, a5 = f.many(
        "mul", (x1, x2), (y1, y2), (s1, s2), (y2, z1), (x2, z1))
    t2 = f.mul_word(z1, B3)
    u, t4, y3, dd, z3 = f.many(
        "add", (t0, t1), (a4, y1), (a5, x1), (t0, t0), (t1, t2))
    t3, t1b = f.many("sub", (m3, u), (t1, t2))
    t0b = f.add(dd, t0)
    y3b = f.mul_word(y3, B3)
    xa, t2c, ya, t1c, t0c, za = f.many(
        "mul", (t4, y3b), (t3, t1b), (y3b, t0b), (t1b, z3), (t0b, t3),
        (z3, t4))
    x3 = f.sub(t2c, xa)
    y3c, z3c = f.many("add", (t1c, ya), (za, t0c))
    return Point(x3, y3c, z3c)


def double(p: Point, f=None) -> Point:
    """Complete doubling, RCB 2015 Algorithm 9 (a = 0): one `point_double`
    without a ring; given a ring, in batched rounds (the squares are
    products of equal operands: the same residues)."""
    if f is None:
        return Point(*K.point_double(*_planes(p)))
    x, y, z = p
    t0, t1, t2, xy = f.many("mul", (y, y), (y, z), (z, z), (x, y))
    z3 = f.add(t0, t0)
    t2b = f.mul_word(t2, B3)
    z3b, t2d, y3 = f.many("add", (z3, z3), (t2b, t2b), (t0, t2b))
    z3c, t2e = f.many("add", (z3b, z3b), (t2d, t2b))    # z3 = 8*t0
    t0b = f.sub(t0, t2e)
    x3, z3d, y3b, x3b = f.many(
        "mul", (t2b, z3c), (t1, z3c), (t0b, y3), (t0b, xy))
    y3c, x3c = f.many("add", (x3, y3b), (x3b, x3b))
    return Point(x3c, y3c, z3d)


def double_n(p: Point, n: int) -> Point:
    """n consecutive doublings: n / 4 `point_double4` launches when n is a
    multiple of 4, else n `point_double` launches (the JAX rule)."""
    if n % 4 == 0:
        for _ in range(n // 4):
            p = Point(*K.point_double4(*_planes(p)))
        return p
    for _ in range(n):
        p = double(p)
    return p


def negate(p: Point) -> Point:
    return Point(p.x, fe.neg(p.y), p.z)


def cneg(mask, p: Point) -> Point:
    """Negate lanes where mask (branchless)."""
    return Point(p.x, fe.cneg(mask, p.y), p.z)


def select(mask, p: Point, q: Point) -> Point:
    """Per-lane select: mask ? p : q."""
    return Point(fe.select(mask, p.x, q.x), fe.select(mask, p.y, q.y),
                 fe.select(mask, p.z, q.z))


def sub(p: Point, q: Point) -> Point:
    return add(p, negate(q))


def equal(p: Point, q: Point):
    """Projective cross-multiplied equality: X1 Z2 == X2 Z1 and
    Y1 Z2 == Y2 Z1 (the identity equals only itself)."""
    ex = fe.eq(fe.mul(p.x, q.z), fe.mul(q.x, p.z))
    ey = fe.eq(fe.mul(p.y, q.z), fe.mul(q.y, p.z))
    return ex & ey


def is_identity(p: Point):
    return fe.is_zero(p.z)


class AffinePoint(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor


def _z_inverse(z):
    """1/Z per lane (0 for the identity): one batched inversion from 4 lanes
    up, per-lane Fermat below, as the JAX package switches."""
    return fe.invert_batch(z) if z.shape[1] >= 4 else fe.invert(z)


def to_affine(p: Point) -> AffinePoint:
    """Normalize to affine; identity lanes map to (0, 0) since
    Invert(0) = 0."""
    zinv = _z_inverse(p.z)
    return AffinePoint(fe.mul(p.x, zinv), fe.mul(p.y, zinv))


def is_y_odd(p: Point):
    """Parity of the affine y (costs a rescale)."""
    return fe.is_odd(to_affine(p).y)


def affine_y(p: Point):
    """Affine y only: one batched inversion and one multiply.  Identity
    lanes map to 0."""
    return fe.mul(p.y, _z_inverse(p.z))


def on_curve(p: Point):
    """Projective curve membership: Y^2 Z == X^3 + 7 Z^3 (identity passes)."""
    lhs = fe.mul(fe.square(p.y), p.z)
    z3 = fe.mul(fe.square(p.z), p.z)
    rhs = fe.add(fe.mul(fe.square(p.x), p.x), fe.mul_word(z3, 7))
    return fe.eq(lhs, rhs)


def debug_randomize_z(p: Point, z_vals) -> Point:
    """Test helper: multiply (X, Y, Z) by nonzero factors so that tests
    cover non-normalized projective representations, the analog of the
    reference's `DebugMustRandomizeZ`.  z_vals: [16, B] nonzero field
    elements."""
    return Point(fe.mul(p.x, z_vals), fe.mul(p.y, z_vals),
                 fe.mul(p.z, z_vals))


def scalar_mult_trivial(k, p: Point) -> Point:
    """Naive 256-step double-and-add ladder, the differential test oracle:
    k is a [16, B] scalar plane; every step adds and doubles, and a mask
    keeps the sum where the bit is 1."""
    acc, base = identity((p.x.shape[1],), p.x.device), p
    for i in range(256):
        bit = (k[i // 16] >> (i % 16)) & 1
        acc = select(bit == 1, add(acc, base), acc)
        base = double(base)
    return acc
