"""Host-side signature and key codecs: strict DER, compact, SPKI.

A copy of `secp256k1_tpu.models.codecs` (the port never imports the JAX
package): DER-minimal lengths, positive minimal INTEGERs, no trailing data,
scalars in [1, n).  The batched entry points parse DER with the native
library (`secp256k1_tpu_torch.native`); `parse_asn1_signature` here is the
per-signature parse of the list APIs and the tests' plain reference, with
the same status classes.
"""

from __future__ import annotations

N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141

COMPACT_SIGNATURE_SIZE = 64
COMPACT_RECOVERABLE_SIGNATURE_SIZE = 65

OID_EC_PUBLIC_KEY = (1, 2, 840, 10045, 2, 1)
OID_SECP256K1 = (1, 3, 132, 0, 10)


class CodecError(ValueError):
    """Malformed encoding."""


class ScalarError(CodecError):
    """Structurally valid encoding holding an out-of-range or zero scalar.
    Distinct so that callers can tell which stage rejected a signature."""


def _read_tlv(data: bytes, offset: int):
    """Read one strict-DER TLV; returns (tag, contents, next_offset)."""
    if offset + 2 > len(data):
        raise CodecError("truncated TLV")
    tag = data[offset]
    lb = data[offset + 1]
    offset += 2
    if lb < 0x80:
        length = lb
    elif lb == 0x80:
        raise CodecError("indefinite length")
    else:
        nlen = lb & 0x7F
        if nlen > 4 or offset + nlen > len(data):
            raise CodecError("bad long-form length")
        length = int.from_bytes(data[offset:offset + nlen], "big")
        if length < 0x80 or data[offset] == 0:
            raise CodecError("non-minimal length")
        offset += nlen
    if offset + length > len(data):
        raise CodecError("truncated contents")
    return tag, data[offset:offset + length], offset + length


def _check_der_integer(contents: bytes) -> int:
    """Strict positive DER INTEGER contents -> int."""
    if len(contents) == 0:
        raise CodecError("empty INTEGER")
    if len(contents) > 1 and contents[0] == 0 and contents[1] & 0x80 == 0:
        raise CodecError("non-minimal INTEGER")
    if contents[0] & 0x80:
        raise CodecError("negative INTEGER")
    return int.from_bytes(contents, "big")


def _encode_der_len(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    b = n.to_bytes((n.bit_length() + 7) // 8, "big")
    return bytes([0x80 | len(b)]) + b


def _encode_der_integer(v: int) -> bytes:
    b = v.to_bytes((v.bit_length() + 7) // 8 or 1, "big")
    if b[0] & 0x80:
        b = b"\x00" + b
    return b"\x02" + _encode_der_len(len(b)) + b


def _scalar_from_int(v: int) -> int:
    """[1, n) canonical check."""
    if v == 0 or v >= N:
        raise ScalarError("invalid scalar")
    return v


def _int_at_most_256bits(contents: bytes) -> int:
    v = _check_der_integer(contents)
    mag = contents[1:] if (contents[0] == 0 and len(contents) > 1) else contents
    if len(mag) > 32:
        raise ScalarError("scalar too large")
    return v


def parse_asn1_signature(sig: bytes):
    """`SEQUENCE { r INTEGER, s INTEGER }` -> (r, s) ints in [1, n).  DER
    only, no trailing bytes inside or after the sequence."""
    tag, seq, end = _read_tlv(sig, 0)
    if tag != 0x30 or end != len(sig):
        raise CodecError("bad signature SEQUENCE")
    tag, r_c, off = _read_tlv(seq, 0)
    if tag != 0x02:
        raise CodecError("r not INTEGER")
    tag, s_c, off = _read_tlv(seq, off)
    if tag != 0x02 or off != len(seq):
        raise CodecError("s not INTEGER / trailing data")
    r = _scalar_from_int(_int_at_most_256bits(r_c))
    s = _scalar_from_int(_int_at_most_256bits(s_c))
    return r, s


def build_asn1_signature(r: int, s: int) -> bytes:
    body = _encode_der_integer(r) + _encode_der_integer(s)
    return b"\x30" + _encode_der_len(len(body)) + body


# ---------------------------------------------------------------------------
# Compact signatures: r || s, and r || s || recovery id.
# ---------------------------------------------------------------------------

def parse_compact_signature(sig: bytes):
    if len(sig) != COMPACT_SIGNATURE_SIZE:
        raise CodecError("bad compact signature size")
    return (_scalar_from_int(int.from_bytes(sig[:32], "big")),
            _scalar_from_int(int.from_bytes(sig[32:64], "big")))


def build_compact_signature(r: int, s: int) -> bytes:
    return r.to_bytes(32, "big") + s.to_bytes(32, "big")


def parse_compact_recoverable_signature(sig: bytes):
    if len(sig) != COMPACT_RECOVERABLE_SIGNATURE_SIZE:
        raise CodecError("bad recoverable signature size")
    r, s = parse_compact_signature(sig[:64])
    return r, s, sig[64]


def build_compact_recoverable_signature(r: int, s: int, v: int) -> bytes:
    return build_compact_signature(r, s) + bytes([v])


# ---------------------------------------------------------------------------
# SubjectPublicKeyInfo (SEC1 C.3 subset) public keys.
# ---------------------------------------------------------------------------

def _encode_oid(oid) -> bytes:
    body = bytearray([40 * oid[0] + oid[1]])
    for arc in oid[2:]:
        chunk = bytearray([arc & 0x7F])
        arc >>= 7
        while arc:
            chunk.append(0x80 | (arc & 0x7F))
            arc >>= 7
        body.extend(reversed(chunk))
    return b"\x06" + _encode_der_len(len(body)) + bytes(body)


def _decode_oid(contents: bytes):
    if not contents:
        raise CodecError("empty OID")
    out = [contents[0] // 40, contents[0] % 40]
    arc = 0
    arc_start = True
    for b in contents[1:]:
        if arc_start and b == 0x80:
            raise CodecError("non-minimal OID arc")
        arc = (arc << 7) | (b & 0x7F)
        arc_start = False
        if not b & 0x80:
            out.append(arc)
            arc = 0
            arc_start = True
    if not arc_start:
        raise CodecError("truncated OID arc")
    return tuple(out)


def parse_asn1_public_key_bytes(data: bytes) -> bytes:
    """The SEC1-encoded point bytes of an SPKI structure."""
    tag, outer, end = _read_tlv(data, 0)
    if tag != 0x30 or end != len(data):
        raise CodecError("bad SPKI SEQUENCE")
    tag, algo, off = _read_tlv(outer, 0)
    if tag != 0x30:
        raise CodecError("bad AlgorithmIdentifier")
    tag, bitstr, off = _read_tlv(outer, off)
    if tag != 0x03 or off != len(outer):
        raise CodecError("bad subjectPublicKey")
    tag, oid1, aoff = _read_tlv(algo, 0)
    if tag != 0x06:
        raise CodecError("bad algorithm OID")
    tag, oid2, aoff = _read_tlv(algo, aoff)
    if tag != 0x06 or aoff != len(algo):
        raise CodecError("bad curve OID")
    if _decode_oid(oid1) != OID_EC_PUBLIC_KEY:
        raise CodecError("algorithm is not ecPublicKey")
    if _decode_oid(oid2) != OID_SECP256K1:
        raise CodecError("named curve is not secp256k1")
    if len(bitstr) == 0 or bitstr[0] != 0:
        raise CodecError("bad BIT STRING padding")
    return bitstr[1:]


def build_asn1_public_key(point_bytes: bytes) -> bytes:
    algo = _encode_oid(OID_EC_PUBLIC_KEY) + _encode_oid(OID_SECP256K1)
    algo_tlv = b"\x30" + _encode_der_len(len(algo)) + algo
    bitstr = b"\x03" + _encode_der_len(len(point_bytes) + 1) + b"\x00" \
        + point_bytes
    body = algo_tlv + bitstr
    return b"\x30" + _encode_der_len(len(body)) + body
