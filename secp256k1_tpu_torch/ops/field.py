"""secp256k1 base field GF(p), p = 2^256 - 2^32 - 977, batched on planes.

The port of `secp256k1_tpu.ops.field`: canonical big-endian bytes at the
boundary, `did_reduce` masks, Invert(0) = 0, and the RFC 9380 `sqrt_ratio`
for q = 3 (mod 4).  `F` routes multiplies to the kernel wrappers;
`F_PLAIN` is the same ring on the plain versions only.
"""

from __future__ import annotations

from .modring import ModRing

P = 2**256 - 2**32 - 977

F = ModRing(P, "secp256k1-field")
F_PLAIN = ModRing(P, "secp256k1-field-plain", plain=True)

# RFC 9380 SSWU constant Z for secp256k1 (= -11), and c2 = sqrt(-Z) mod p
# used by sqrt_ratio.
Z_SSWU = P - 11
_C2_SQRT_NEG_Z = pow(11, (P + 1) // 4, P)

add = F.add
sub = F.sub
neg = F.neg
mul = F.mul
square = F.square
mul_word = F.mul_word
pow2k = F.pow2k
pow_const = F.pow_const
invert = F.invert
invert_batch = F.invert_batch
is_zero = F.is_zero
eq = F.eq
is_odd = F.is_odd
select = F.select
cneg = F.cneg
const = F.const
zero = F.zero
one = F.one
from_bytes_any = F.from_bytes_any
from_wide_bytes = F.from_wide_bytes
to_bytes = F.to_bytes
bytes_are_canonical = F.bytes_are_canonical


def sqrt_ratio(u, v):
    """(sqrt(u/v), is_qr) per RFC 9380 F.2.1.2 (q = 3 mod 4): if u/v is a
    square returns (sqrt(u/v), True), else (sqrt(Z*u/v), False)."""
    tv1 = square(v)
    tv2 = mul(u, v)
    tv1 = mul(tv1, tv2)
    y1 = F.pow_const_chain(tv1, (P - 3) // 4)
    y1 = mul(y1, tv2)
    y2 = mul(y1, const(_C2_SQRT_NEG_Z, y1.shape[1:], y1.device).contiguous())
    tv3 = square(y1)
    tv3 = mul(tv3, v)
    is_qr = eq(tv3, u)
    return select(is_qr, y1, y2), is_qr


def sqrt(x):
    """(sqrt(x), ok); zero where x is not a square."""
    root, ok = sqrt_ratio(x, one(x.shape[1:], x.device))
    return select(ok, root, zero(x.shape[1:], x.device)), ok
