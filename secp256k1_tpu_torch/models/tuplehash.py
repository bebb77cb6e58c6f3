"""NIST SP 800-185 TupleHashXOF128 over a pure-Python Keccak-f[1600].

A copy of `secp256k1_tpu.models.tuplehash`: host-side only, it hardens
caller-supplied entropy for ECDSA nonces (`models.ecdsa._nonce_reader`).
The cSHAKE128 core degenerates to SHAKE128 when N = S = "", which is how
the tests check it against hashlib.
"""

from __future__ import annotations

_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

_ROT = [[0, 36, 3, 41, 18],
        [1, 44, 10, 45, 2],
        [62, 6, 43, 15, 61],
        [28, 55, 25, 21, 56],
        [27, 20, 39, 8, 14]]

_MASK = (1 << 64) - 1


def _rol(v, n):
    n %= 64
    return ((v << n) | (v >> (64 - n))) & _MASK


def _keccak_f(st):
    for rc in _RC:
        # theta
        c = [st[x][0] ^ st[x][1] ^ st[x][2] ^ st[x][3] ^ st[x][4]
             for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rol(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                st[x][y] ^= d[x]
        # rho + pi
        b = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rol(st[x][y], _ROT[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                st[x][y] = b[x][y] ^ ((~b[(x + 1) % 5][y]) & b[(x + 2) % 5][y])
        # iota
        st[0][0] ^= rc
    return st


class _KeccakSponge:
    def __init__(self, rate_bytes: int):
        self.rate = rate_bytes
        self.st = [[0] * 5 for _ in range(5)]
        self.buf = b""
        self.squeezing = False
        self._out = b""

    def absorb(self, data: bytes):
        assert not self.squeezing
        self.buf += data
        while len(self.buf) >= self.rate:
            block, self.buf = self.buf[:self.rate], self.buf[self.rate:]
            self._xor_block(block)
            _keccak_f(self.st)

    def _xor_block(self, block: bytes):
        for i in range(len(block) // 8):
            lane = int.from_bytes(block[8 * i:8 * i + 8], "little")
            x, y = i % 5, i // 5
            self.st[x][y] ^= lane

    def finalize(self, domain_pad: int):
        assert not self.squeezing
        pad = bytearray(self.rate - len(self.buf))
        pad_block = bytearray(self.buf) + pad
        pad_block[len(self.buf)] ^= domain_pad
        pad_block[-1] ^= 0x80
        self._xor_block(bytes(pad_block))
        _keccak_f(self.st)
        self.squeezing = True

    def squeeze(self, n: int) -> bytes:
        assert self.squeezing
        while len(self._out) < n:
            block = b"".join(
                self.st[i % 5][i // 5].to_bytes(8, "little")
                for i in range(self.rate // 8))
            self._out += block
            _keccak_f(self.st)
        out, self._out = self._out[:n], self._out[n:]
        return out


def _left_encode(n: int) -> bytes:
    b = n.to_bytes((n.bit_length() + 7) // 8 or 1, "big")
    return bytes([len(b)]) + b


def _right_encode(n: int) -> bytes:
    b = n.to_bytes((n.bit_length() + 7) // 8 or 1, "big")
    return b + bytes([len(b)])


def _encode_string(s: bytes) -> bytes:
    return _left_encode(len(s) * 8) + s


def _bytepad(data: bytes, w: int) -> bytes:
    out = _left_encode(w) + data
    if len(out) % w:
        out += b"\x00" * (w - len(out) % w)
    return out


class CShake128:
    """cSHAKE128 (SP 800-185 §3); N = S = b'' degenerates to SHAKE128."""

    RATE = 168

    def __init__(self, n: bytes = b"", s: bytes = b""):
        self.sponge = _KeccakSponge(self.RATE)
        self.plain_shake = (n == b"" and s == b"")
        if not self.plain_shake:
            self.sponge.absorb(_bytepad(_encode_string(n) + _encode_string(s),
                                        self.RATE))

    def update(self, data: bytes):
        self.sponge.absorb(data)

    def read(self, n: int) -> bytes:
        if not self.sponge.squeezing:
            self.sponge.finalize(0x1F if self.plain_shake else 0x04)
        return self.sponge.squeeze(n)


class TupleHashXOF128:
    """TupleHashXOF128 (SP 800-185 §5.3.1): arbitrary-length output, L=0."""

    def __init__(self, s: bytes = b""):
        self.inner = CShake128(b"TupleHash", s)
        self.finalized = False

    def write(self, item: bytes):
        assert not self.finalized
        self.inner.update(_encode_string(item))
        return len(item)

    def read(self, n: int) -> bytes:
        if not self.finalized:
            self.inner.update(_right_encode(0))  # XOF: L = 0
            self.finalized = True
        return self.inner.read(n)
