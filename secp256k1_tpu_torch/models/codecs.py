"""Host-side signature codecs: strict DER.

A copy of the signature part of `secp256k1_tpu.models.codecs` (the port
never imports the JAX package): DER-minimal lengths, positive minimal
INTEGERs, no trailing data, scalars in [1, n).  The JAX package uses this
pure-Python parse when its native library is missing, with the same status
taxonomy; the port's batched C++ parser is still to come.
"""

from __future__ import annotations

N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141


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
