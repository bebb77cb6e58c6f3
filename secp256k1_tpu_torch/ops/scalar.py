"""secp256k1 scalar ring GF(n), batched on planes: the port of
`secp256k1_tpu.ops.scalar` (mod-n ring ops, canonical byte boundary with
`did_reduce`, Fermat inversion with Invert(0) = 0, and the low-s predicate).
"""

from __future__ import annotations

from .modring import ModRing

N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141

S = ModRing(N, "secp256k1-scalar")

add = S.add
sub = S.sub
neg = S.neg
mul = S.mul
square = S.square
pow2k = S.pow2k
pow_const = S.pow_const
invert = S.invert
invert_batch = S.invert_batch
invert_auto = S.invert_auto
is_zero = S.is_zero
eq = S.eq
is_odd = S.is_odd
select = S.select
cneg = S.cneg
const = S.const
zero = S.zero
one = S.one
from_bytes_any = S.from_bytes_any
from_wide_bytes = S.from_wide_bytes
to_bytes = S.to_bytes
bytes_are_canonical = S.bytes_are_canonical

# s > n/2: the low-s malleability check.
is_greater_than_half_n = S.gt_half
