// Native host-side batch crypto of the PyTorch port: SHA-256 (of whole rows,
// or each at its own length, between a common prefix and suffix),
// HMAC-SHA256, RFC 6979 nonce derivation (with optional per-lane additional
// data), BIP-0340 tagged hashes, the strict-DER signature parse (alone, or
// behind BIP-0066's encoding rules for consensus verify) and the strict-DER
// signature encode, as C batch APIs loaded from Python with ctypes
// (secp256k1_tpu_torch/native/__init__.py).
//
// A copy of secp256k1_tpu/native/hostcrypto.cpp, so that the port never
// loads anything of the JAX package, with more: the BIP-0066 checks in
// front of the parse (bip0066_sig_parse_batch), RFC 6979 3.6 additional
// data in rfc6979_nonce_batch, and the DER encode (der_sig_encode_batch).  The host feeds
// the GPU with byte planes; nonce derivation is ~19 sequential HMAC
// invocations per signature and a DER parse is byte-by-byte branching, both
// far slower through Python call by call than here.
//
// SHA-256 per FIPS 180-4; HMAC per RFC 2104; nonces per RFC 6979 3.2 and
// BIP-0340.

#include <cstdint>
#include <cstring>

namespace {

struct Sha256 {
  uint32_t h[8];
  uint64_t len = 0;
  uint8_t buf[64];
  size_t buflen = 0;
  uint64_t blocks = 0;  // compressions run

  Sha256() { reset(); }

  void reset() {
    static const uint32_t init[8] = {
        0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
        0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};
    std::memcpy(h, init, sizeof(h));
    len = 0;
    buflen = 0;
  }

  static uint32_t rotr(uint32_t x, int n) {
    return (x >> n) | (x << (32 - n));
  }

  void block(const uint8_t* p) {
    blocks++;
    static const uint32_t K[64] = {
        0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b,
        0x59f111f1, 0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01,
        0x243185be, 0x550c7dc3, 0x72be5d74, 0x80deb1fe, 0x9bdc06a7,
        0xc19bf174, 0xe49b69c1, 0xefbe4786, 0x0fc19dc6, 0x240ca1cc,
        0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da, 0x983e5152,
        0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
        0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc,
        0x53380d13, 0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85,
        0xa2bfe8a1, 0xa81a664b, 0xc24b8b70, 0xc76c51a3, 0xd192e819,
        0xd6990624, 0xf40e3585, 0x106aa070, 0x19a4c116, 0x1e376c08,
        0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a, 0x5b9cca4f,
        0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
        0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};
    uint32_t w[64];
    for (int i = 0; i < 16; i++) {
      w[i] = (uint32_t(p[4 * i]) << 24) | (uint32_t(p[4 * i + 1]) << 16) |
             (uint32_t(p[4 * i + 2]) << 8) | uint32_t(p[4 * i + 3]);
    }
    for (int i = 16; i < 64; i++) {
      uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
      uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
      w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    uint32_t a = h[0], b = h[1], c = h[2], d = h[3];
    uint32_t e = h[4], f = h[5], g = h[6], hh = h[7];
    for (int i = 0; i < 64; i++) {
      uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
      uint32_t ch = (e & f) ^ (~e & g);
      uint32_t t1 = hh + S1 + ch + K[i] + w[i];
      uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
      uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
      uint32_t t2 = S0 + maj;
      hh = g; g = f; f = e; e = d + t1;
      d = c; c = b; b = a; a = t1 + t2;
    }
    h[0] += a; h[1] += b; h[2] += c; h[3] += d;
    h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
  }

  void update(const uint8_t* data, size_t n) {
    len += n;
    if (buflen) {
      size_t take = 64 - buflen;
      if (take > n) take = n;
      std::memcpy(buf + buflen, data, take);
      buflen += take;
      data += take;
      n -= take;
      if (buflen == 64) {
        block(buf);
        buflen = 0;
      }
    }
    while (n >= 64) {
      block(data);
      data += 64;
      n -= 64;
    }
    if (n) {
      std::memcpy(buf, data, n);
      buflen = n;
    }
  }

  void final(uint8_t out[32]) {
    uint64_t bitlen = len * 8;
    uint8_t pad = 0x80;
    update(&pad, 1);
    uint8_t z = 0;
    while (buflen != 56) update(&z, 1);
    uint8_t lenb[8];
    for (int i = 0; i < 8; i++) lenb[i] = uint8_t(bitlen >> (56 - 8 * i));
    update(lenb, 8);
    for (int i = 0; i < 8; i++) {
      out[4 * i] = uint8_t(h[i] >> 24);
      out[4 * i + 1] = uint8_t(h[i] >> 16);
      out[4 * i + 2] = uint8_t(h[i] >> 8);
      out[4 * i + 3] = uint8_t(h[i]);
    }
  }
};

void sha256(const uint8_t* data, size_t n, uint8_t out[32]) {
  Sha256 s;
  s.update(data, n);
  s.final(out);
}

// HMAC-SHA256 with 32-byte-or-less key pre-expansion avoided: general form.
void hmac_sha256(const uint8_t* key, size_t keylen, const uint8_t* const* parts,
                 const size_t* part_lens, size_t n_parts, uint8_t out[32]) {
  uint8_t kbuf[64];
  uint8_t khash[32];
  if (keylen > 64) {
    sha256(key, keylen, khash);
    key = khash;
    keylen = 32;
  }
  std::memset(kbuf, 0, 64);
  std::memcpy(kbuf, key, keylen);
  uint8_t ipad[64], opad[64];
  for (int i = 0; i < 64; i++) {
    ipad[i] = kbuf[i] ^ 0x36;
    opad[i] = kbuf[i] ^ 0x5c;
  }
  Sha256 inner;
  inner.update(ipad, 64);
  for (size_t i = 0; i < n_parts; i++) inner.update(parts[i], part_lens[i]);
  uint8_t ih[32];
  inner.final(ih);
  Sha256 outer;
  outer.update(opad, 64);
  outer.update(ih, 32);
  outer.final(out);
}

}  // namespace

extern "C" {

// Batched SHA-256 of B rows (row-major [B, row_len]) between one prefix and
// one suffix: prefix[0, prefix_len), then row i's first lens[i] bytes, or
// the whole row where lens is NULL (the caller keeps 0 <= lens[i] <=
// row_len), then suffix[0, suffix_len).  Returns the compressions run over
// the batch.
uint64_t sha256_batch(const uint8_t* rows, const int32_t* lens,
                      size_t row_len, size_t batch, const uint8_t* prefix,
                      size_t prefix_len, const uint8_t* suffix,
                      size_t suffix_len, uint8_t* out /* [B, 32] */) {
  uint64_t blocks = 0;
  for (size_t i = 0; i < batch; i++) {
    Sha256 s;
    if (prefix_len) s.update(prefix, prefix_len);
    s.update(rows + i * row_len, lens ? size_t(lens[i]) : row_len);
    if (suffix_len) s.update(suffix, suffix_len);
    s.final(out + i * 32);
    blocks += s.blocks;
  }
  return blocks;
}

// Batched RFC 6979 nonce derivation: for each lane, HMAC-DRBG seeded with
// x || e (|| extra) per RFC 6979 3.2 steps b-g, then one generate step (h).
// Inputs [B,32] keys and [B,32] reduced digests, and either NULL or [B,32]
// additional data (RFC 6979 3.6), appended to the seed after e as
// libsecp256k1's nonce_function_rfc6979 appends its 32 bytes of data.
// Output: first candidate k [B,32] (rejection handled by the caller; a
// retry re-enters via rfc6979_continue with the saved state).
void rfc6979_nonce_batch(const uint8_t* keys32, const uint8_t* digests32,
                         const uint8_t* extra32 /* [B,32] or NULL */,
                         size_t batch, uint8_t* out32,
                         uint8_t* state_v /* [B,32] */,
                         uint8_t* state_k /* [B,32] */) {
  const size_t n_seed = extra32 ? 5 : 4;
  for (size_t i = 0; i < batch; i++) {
    const uint8_t* x = keys32 + 32 * i;
    const uint8_t* e = digests32 + 32 * i;
    const uint8_t* a = extra32 ? extra32 + 32 * i : nullptr;
    uint8_t v[32], k[32];
    std::memset(v, 0x01, 32);
    std::memset(k, 0x00, 32);
    const uint8_t zero = 0x00, one = 0x01;
    {  // step d
      const uint8_t* parts[5] = {v, &zero, x, e, a};
      const size_t lens[5] = {32, 1, 32, 32, 32};
      hmac_sha256(k, 32, parts, lens, n_seed, k);
    }
    {  // step e
      const uint8_t* parts[1] = {v};
      const size_t lens[1] = {32};
      hmac_sha256(k, 32, parts, lens, 1, v);
    }
    {  // step f
      const uint8_t* parts[5] = {v, &one, x, e, a};
      const size_t lens[5] = {32, 1, 32, 32, 32};
      hmac_sha256(k, 32, parts, lens, n_seed, k);
    }
    {  // step g
      const uint8_t* parts[1] = {v};
      const size_t lens[1] = {32};
      hmac_sha256(k, 32, parts, lens, 1, v);
    }
    {  // step h: V = HMAC_K(V); T = V
      const uint8_t* parts[1] = {v};
      const size_t lens[1] = {32};
      hmac_sha256(k, 32, parts, lens, 1, v);
    }
    std::memcpy(out32 + 32 * i, v, 32);
    std::memcpy(state_v + 32 * i, v, 32);
    std::memcpy(state_k + 32 * i, k, 32);
  }
}

// Continue a lane's DRBG after an unsuitable k (RFC 6979 h.3).
void rfc6979_continue(uint8_t* state_v, uint8_t* state_k, uint8_t* out32) {
  uint8_t* v = state_v;
  uint8_t* k = state_k;
  const uint8_t zero = 0x00;
  {  // K = HMAC_K(V || 0x00)
    const uint8_t* parts[2] = {v, &zero};
    const size_t lens[2] = {32, 1};
    hmac_sha256(k, 32, parts, lens, 2, k);
  }
  {  // V = HMAC_K(V)
    const uint8_t* parts[1] = {v};
    const size_t lens[1] = {32};
    hmac_sha256(k, 32, parts, lens, 1, v);
  }
  {  // V = HMAC_K(V); T = V
    const uint8_t* parts[1] = {v};
    const size_t lens[1] = {32};
    hmac_sha256(k, 32, parts, lens, 1, v);
  }
  std::memcpy(out32, v, 32);
}

// Batched BIP-0340 tagged hash: out = SHA256(H(tag)||H(tag)||m1||m2||m3)
// with per-lane m2 (fixed widths; widths of 0 skip the part).
void tagged_hash_batch(const uint8_t* tag_hash /* 32 */,
                       const uint8_t* p1, size_t l1,
                       const uint8_t* p2, size_t l2,
                       const uint8_t* p3, size_t l3,
                       size_t batch, uint8_t* out32) {
  for (size_t i = 0; i < batch; i++) {
    Sha256 s;
    s.update(tag_hash, 32);
    s.update(tag_hash, 32);
    if (l1) s.update(p1 + i * l1, l1);
    if (l2) s.update(p2 + i * l2, l2);
    if (l3) s.update(p3 + i * l3, l3);
    s.final(out32 + 32 * i);
  }
}

}  // extern "C"

// Batched strict-DER ECDSA signature parse: SEQUENCE { r INTEGER, s INTEGER }
// with cryptobyte-strict semantics, bit-compatible with the Python parser
// (secp256k1_tpu_torch/models/codecs.py parse_asn1_signature).
// Inputs: row-major [B, max_len] sig bytes + per-lane lengths.
// Outputs: r/s as 32-byte big-endian magnitudes, and a per-lane status:
// 0 = ok, 1 = malformed encoding, 2 = out-of-range/zero scalar.
namespace {

const uint8_t kOrderN[32] = {
    0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF,
    0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFE,
    0xBA, 0xAE, 0xDC, 0xE6, 0xAF, 0x48, 0xA0, 0x3B,
    0xBF, 0xD2, 0x5E, 0x8C, 0xD0, 0x36, 0x41, 0x41};

// Strict-DER TLV; returns 0 on success.
int read_tlv(const uint8_t* d, size_t len, size_t off, uint8_t* tag,
             size_t* c_off, size_t* c_len, size_t* next) {
  if (off + 2 > len) return 1;
  *tag = d[off];
  uint8_t lb = d[off + 1];
  off += 2;
  size_t length;
  if (lb < 0x80) {
    length = lb;
  } else if (lb == 0x80) {
    return 1;  // indefinite
  } else {
    size_t nlen = lb & 0x7F;
    if (nlen > 4 || off + nlen > len) return 1;
    length = 0;
    for (size_t i = 0; i < nlen; i++) length = (length << 8) | d[off + i];
    if (length < 0x80 || d[off] == 0) return 1;  // non-minimal
    off += nlen;
  }
  if (off + length > len) return 1;
  *c_off = off;
  *c_len = length;
  *next = off + length;
  return 0;
}

// Strict positive DER INTEGER -> 32-byte BE magnitude in [1, n).
// Returns 0 ok, 1 encoding error, 2 scalar error.
int der_scalar(const uint8_t* c, size_t clen, uint8_t out[32]) {
  if (clen == 0) return 1;                       // empty
  if (clen > 1 && c[0] == 0 && !(c[1] & 0x80)) return 1;  // non-minimal
  if (c[0] & 0x80) return 1;                     // negative
  const uint8_t* mag = c;
  size_t mlen = clen;
  if (clen > 1 && c[0] == 0) { mag = c + 1; mlen = clen - 1; }
  if (mlen > 32) return 2;                       // scalar too large
  std::memset(out, 0, 32);
  std::memcpy(out + 32 - mlen, mag, mlen);
  bool zero = true;
  for (int i = 0; i < 32; i++) if (out[i]) { zero = false; break; }
  if (zero) return 2;
  // out >= n ?
  for (int i = 0; i < 32; i++) {
    if (out[i] < kOrderN[i]) break;
    if (out[i] > kOrderN[i]) return 2;
    if (i == 31) return 2;  // equal to n
  }
  return 0;
}

// The strict-DER parse of one row of `len` bytes into r and s, which the
// caller has zeroed; returns the row's status.
uint8_t der_sig_parse(const uint8_t* sig, size_t len, uint8_t* r,
                      uint8_t* s) {
  uint8_t tag;
  size_t c_off, c_len, next;
  if (read_tlv(sig, len, 0, &tag, &c_off, &c_len, &next) != 0 ||
      tag != 0x30 || next != len) {
    return 1;
  }
  // Read BOTH integer TLVs before scalar validation — the error-class
  // precedence of the Python parser (structure first, ranges second).
  const uint8_t* seq = sig + c_off;
  size_t seq_len = c_len;
  size_t off = 0;
  size_t r_off, r_len, s_off, s_len;
  if (read_tlv(seq, seq_len, 0, &tag, &r_off, &r_len, &off) != 0 ||
      tag != 0x02) {
    return 1;
  }
  if (read_tlv(seq, seq_len, off, &tag, &s_off, &s_len, &off) != 0 ||
      tag != 0x02 || off != seq_len) {
    return 1;
  }
  int rc = der_scalar(seq + r_off, r_len, r);
  if (rc) return uint8_t(rc);
  return uint8_t(der_scalar(seq + s_off, s_len, s));
}

// BIP-0066 over one row of `len` bytes, its sighash byte included: the
// checks of models/bitcoin.py is_valid_signature_encoding_bip0066 in that
// function's order, each read inside the row.
bool bip0066_valid(const uint8_t* d, size_t len) {
  if (len < 9 || len > 73) return false;
  if (d[0] != 0x30) return false;
  if (d[1] != len - 3) return false;
  size_t len_r = d[3];
  if (5 + len_r >= len) return false;
  size_t len_s = d[5 + len_r];
  if (len_r + len_s + 7 != len) return false;
  if (d[2] != 0x02) return false;
  if (len_r == 0) return false;
  if (d[4] & 0x80) return false;
  if (len_r > 1 && d[4] == 0x00 && !(d[5] & 0x80)) return false;
  if (d[len_r + 4] != 0x02) return false;
  if (len_s == 0) return false;
  if (d[len_r + 6] & 0x80) return false;
  if (len_s > 1 && d[len_r + 6] == 0x00 && !(d[len_r + 7] & 0x80))
    return false;
  return true;
}

}  // namespace

extern "C" {

void asn1_sig_parse_batch(const uint8_t* sigs, const int32_t* lens,
                          size_t max_len, size_t batch,
                          uint8_t* r_out /* [B,32] */,
                          uint8_t* s_out /* [B,32] */,
                          uint8_t* status /* [B] */) {
  for (size_t i = 0; i < batch; i++) {
    size_t len = size_t(lens[i]);
    uint8_t* r = r_out + 32 * i;
    uint8_t* s = s_out + 32 * i;
    std::memset(r, 0, 32);
    std::memset(s, 0, 32);
    status[i] = len > max_len ? 1 : der_sig_parse(sigs + i * max_len, len,
                                                  r, s);
  }
}

// Consensus intake in one pass over each row: BIP-0066 on the row of
// lens[i] bytes (sighash byte included; a row longer than max_len fails),
// then the strict-DER parse of its first lens[i] - 1 bytes.  A BIP-0066
// failure is status 1 with r = s = 0; otherwise the status and r, s of
// asn1_sig_parse_batch on the stripped row.
void bip0066_sig_parse_batch(const uint8_t* sigs, const int32_t* lens,
                             size_t max_len, size_t batch,
                             uint8_t* r_out /* [B,32] */,
                             uint8_t* s_out /* [B,32] */,
                             uint8_t* status /* [B] */) {
  for (size_t i = 0; i < batch; i++) {
    const uint8_t* sig = sigs + i * max_len;
    size_t len = size_t(lens[i]);
    uint8_t* r = r_out + 32 * i;
    uint8_t* s = s_out + 32 * i;
    std::memset(r, 0, 32);
    std::memset(s, 0, 32);
    status[i] = len > max_len || !bip0066_valid(sig, len)
                    ? 1 : der_sig_parse(sig, len - 1, r, s);
  }
}

}  // extern "C"

// Batched strict-DER encode of ECDSA signatures, as libsecp256k1's
// secp256k1_ecdsa_signature_serialize_der, plus one trailing sighash byte:
// SEQUENCE { INTEGER r, INTEGER s } with each integer minimal (leading zero
// bytes dropped, one kept for 0) and one 0x00 byte in front of a top bit
// that is set.  Inputs [B,32] big-endian r and s rows; outputs [B,73] rows
// (the BIP-0066 maximum; bytes past a row's length are zero) and [B] lengths
// with the sighash byte.
namespace {

size_t der_int(const uint8_t* v32, uint8_t* out) {
  size_t skip = 0;
  while (skip < 31 && v32[skip] == 0) skip++;
  const bool pad = v32[skip] & 0x80;
  const size_t len = 32 - skip + (pad ? 1 : 0);
  out[0] = 0x02;
  out[1] = uint8_t(len);
  size_t o = 2;
  if (pad) out[o++] = 0x00;
  std::memcpy(out + o, v32 + skip, 32 - skip);
  return 2 + len;
}

}  // namespace

extern "C" {

void der_sig_encode_batch(const uint8_t* r32, const uint8_t* s32,
                          size_t batch, uint8_t sighash,
                          uint8_t* out /* [B,73] */,
                          int32_t* lens /* [B] */) {
  for (size_t i = 0; i < batch; i++) {
    uint8_t* row = out + 73 * i;
    std::memset(row, 0, 73);
    size_t o = 2;
    o += der_int(r32 + 32 * i, row + o);
    o += der_int(s32 + 32 * i, row + o);
    row[0] = 0x30;
    row[1] = uint8_t(o - 2);
    row[o++] = sighash;
    lens[i] = int32_t(o);
  }
}

}  // extern "C"
