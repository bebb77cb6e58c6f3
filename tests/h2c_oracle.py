"""RFC 9380 hash-to-curve for secp256k1 in python ints: the oracle the
port's h2c tests hold it to.

The maps follow the RFC's straightforward form (section 6.6.2, not the
straight-line one the port follows) and the 3-isogeny of Appendix E.1,
with the JAX package's suite constants; `point` expands with the JAX
package's one-message `expand_message_xmd` (hashlib) and adds the two RO
points with its host curve arithmetic.  Nothing here imports the port.
"""

from secp256k1_tpu.models import h2c as jh2c
from secp256k1_tpu.ops import swu as jswu
from secp256k1_tpu.utils import hostcurve as jhc

P = jhc.P


def inv0(x):
    return pow(x, P - 2, P)


def _sqrt(x):
    """A square root of x, or None."""
    r = pow(x, (P + 1) // 4, P)
    return r if r * r % P == x % P else None


def sswu(u):
    """(x', y') on E' for u."""
    a, b, z = jswu.A_PRIME, jswu.B_PRIME, jswu.Z
    tv1 = inv0((z * z * pow(u, 4, P) + z * u * u) % P)
    x1 = (-b) * inv0(a) * (1 + tv1) % P
    if tv1 == 0:
        x1 = b * inv0(z * a) % P
    gx1 = (x1 ** 3 + a * x1 + b) % P
    x2 = z * u * u * x1 % P
    gx2 = (x2 ** 3 + a * x2 + b) % P
    y1 = _sqrt(gx1)
    x, y = (x1, y1) if y1 is not None else (x2, _sqrt(gx2))
    if u % 2 != y % 2:
        y = -y % P
    return x, y


def iso(x, y):
    """The 3-isogeny of (x, y); None (the identity) where a denominator
    is 0."""
    s = jswu
    x_num = (s.K13 * x ** 3 + s.K12 * x * x + s.K11 * x + s.K10) % P
    x_den = (x * x + s.K21 * x + s.K20) % P
    y_num = (s.K33 * x ** 3 + s.K32 * x * x + s.K31 * x + s.K30) % P
    y_den = (x ** 3 + s.K42 * x * x + s.K41 * x + s.K40) % P
    if x_den == 0 or y_den == 0:
        return None
    return x_num * inv0(x_den) % P, y * y_num * inv0(y_den) % P


def map_uniform(uniform48: bytes):
    """One 48-byte string through the field reduction, SWU and the
    isogeny."""
    return iso(*sswu(int.from_bytes(uniform48, "big") % P))


def point(msg: bytes, dst: bytes, random_oracle: bool):
    """The suite's point of msg: RO (hash_to_curve) sums the maps of two
    48-byte strings, NU (encode_to_curve) maps one; None is the
    identity."""
    if not random_oracle:
        return map_uniform(jh2c.expand_message_xmd(msg, dst, 48))
    uniform = jh2c.expand_message_xmd(msg, dst, 96)
    return jhc.add(map_uniform(uniform[:48]), map_uniform(uniform[48:]))
