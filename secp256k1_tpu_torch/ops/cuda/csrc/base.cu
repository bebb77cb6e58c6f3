// The fixed-base kernels over the G table: k_base_final (u1*G + Q, public
// digits) and k_base_scan (k*G, secret digits).  Both run one lane a thread
// through the same window step (base_step, base.cuh): window 0 a select
// ((x, +-y, 1), or the identity (0, 1, 0) where the magnitude is 0, even
// with the sign bit set), each later window a mixed add of the entry, y
// negated for a set sign bit, passed through where the magnitude is 0.  The
// windows run in order in one thread, so X, Y, Z equal the plain versions'
// exactly; splitting a lane's windows over threads would change the
// projective representative.  Digits are int32 [W, B], least significant
// window first.
//
// Both are one wave at 65,536 lanes: 128 threads a block,
// __launch_bounds__(128, 4) (at most 128 registers a thread), four blocks
// an SM within the shared memory below, 132 SMs x 4 = 528 block slots for
// 512 blocks.  At 137 and 144 registers the designs they replaced fitted
// three blocks an SM and ran 1.3 waves, the second a quarter full.
//
// ---------------------------------------------------------------------------
// base_windowed_add_final (k_base_final) replaces the Pallas kernel
// base_windowed_add_final (secp256k1_tpu/ops/pallas/kernels.py:1070, body
// _base_windowed_add_kernel(signed_digits=True, final_add=True) :959):
// signed w-bit digits (w = 8, or 6-15 under SECP256K1_TPU_BASE_WINDOW), then
// a complete add of Q.  Verify's digits are public, so each lane gathers
// table[w][|d| - 1] itself from the packed word table, int32 [W, E, 16]
// (64 B an entry: x words 0-7, y words 0-7; table.base_table_words), as
// four 16-byte asynchronous copies (cp.async) into the thread's slot of a
// two-stage ring in shared memory (2 x 128 x 64 B = 16 KB a block).  Window
// w + 1's entry is requested before window w's mixed add starts and its
// digit a window before that, so the add hides the L2 latency; the ring
// costs no registers, where a register double buffer (16 more live across
// the add) would spill at 128.  The design it replaced read the int32
// [W, E, 2, 16] limb table as 32 scalar loads at the top of every window,
// each add waiting on them.
//
// Bound: 32-bit integer multiply-adds.  Per lane 32 mixed adds and one
// complete add (~27,000 products at w = 8); bytes are the digits, the 3 Q
// planes and the 3 outputs (~330 B a lane) plus one 64-byte entry a window
// from L2.
//
// ---------------------------------------------------------------------------
// base_windowed_add (k_base_scan) replaces the Pallas kernel
// base_windowed_add (kernels.py:1041, body
// _base_windowed_add_kernel(signed_digits, final_add=False) :959) in both
// of its modes: signed digits (magnitude (bits 0-15) | sign << 16, tables
// of 2^(w-1) entries a window, widths 6-15) and unsigned digits (in
// [0, 2^w), tables of 2^w - 1 entries, width 8).  Its digits are SECRET (an
// ECDSA nonce, a private key, a BIP-0340 nonce).
//
// The select runs on the int8 tensor cores, as the TPU version ran it on its
// matrix unit (secp256k1_tpu/ops/table.py:199-225): for each window a warp
// multiplies the one-hot rows of its 32 lanes, [32, E_pad] u8, by the
// window's table as bytes, [E_pad, 64] u8 (table.base_table_bytes: uint8
// [W, 64, E_pad], byte j of entry e at [w, j, e], E padded with zero entries
// to a multiple of 32), with mma.sync m16n8k32 u8 x u8 -> s32.  Row l is
// (e + 1 == |d_l|), built in registers by compares and masks from the
// digits, which the warp's threads exchange by shuffles from fixed lanes;
// a magnitude of 0 gives a zero row and selects (0, 0).  Each output has
// one nonzero term, at most 255, so the product is exact.  The warp writes
// the product's bytes to its selection rows in shared memory (32 x 80 B)
// and each thread reads its lane's 64 B as its (x, y) words.
//
// Staging: the table is read as stages of at most 256 entries of one
// window ([64, 256] bytes, 16 KB, each byte column padded by 16 B so that
// the B-fragment reads hit 32 distinct banks), two stages in shared
// memory: stage s + 1 is copied by cp.async while stage s is multiplied and
// window w's mixed add runs, with one __syncthreads a stage.  Shared memory
// a block: 2 x 64 x 272 B + 4 x 32 x 80 B = 44 KB (four blocks an SM in
// 176 KB).  At w = 12 a block stages W x E x 64 B = 2.9 MB from L2.
//
// Constant time.  No load address, branch or trip count depends on a
// digit: the stages, chunks and k-steps are functions of W and E alone
// (public); the digits are exchanged by shuffles from fixed lanes; the
// one-hot is built by compares and masks; the MMA multiplies every entry
// of every window for every lane, and a dense MMA does the same work
// whatever its operands; the sign is applied by fe_cmov, the magnitude-0
// pass-through by pt_cmov, and the mixed add is computed on every window.
// The bucket kernel (msm.cu) stays the only variable-time kernel.
//
// Bound: operations.  Per lane 32 mixed adds at w = 8 signed (~27,400
// 32-bit products); the select is 2 x E_pad x 64 int8 MMA operations a
// lane a window (33 x 128 at w = 8: 5.4e5 a lane, 0.018 ms at 65,536 lanes
// at the dense int8 rate), where the masked scan it replaced was one LOP3
// a word an entry a window (67,584 a lane at w = 8; 753,664 at w = 12),
// the bound of that design.  mma.sync reaches part of the int8 rate; wgmma
// is the later step if the select still shows in the profile, but here
// the mixed adds take most of the time.
#include <cuda_runtime.h>

#include <cstdint>

#include "base.cuh"

constexpr int BASE_THREADS = 128;
constexpr int BASE_MIN_BLOCKS = 4;
constexpr int BASE_WARPS = BASE_THREADS / 32;
constexpr int FINAL_STAGES = 2;
constexpr int SCAN_CHUNK = 256;                // entries a stage
constexpr int STAGE_STRIDE = SCAN_CHUNK + 16;  // bytes a staged byte column
constexpr int SEL_STRIDE = 80;                 // bytes a lane's selection row

// An entry's 64 bytes as four 16-byte vectors -> x words 0-7, y words 0-7.
__device__ __forceinline__ void unpack_entry(uint4 a, uint4 b, uint4 c,
                                             uint4 d, u32 x[8], u32 y[8]) {
  const uint4 v[4] = {a, b, c, d};
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    x[4 * q] = v[q].x;
    x[4 * q + 1] = v[q].y;
    x[4 * q + 2] = v[q].z;
    x[4 * q + 3] = v[q].w;
    y[4 * q] = v[q + 2].x;
    y[4 * q + 1] = v[q + 2].y;
    y[4 * q + 2] = v[q + 2].z;
    y[4 * q + 3] = v[q + 2].w;
  }
}

// ---------------------------------------------------------------------------
// k_base_final
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(BASE_THREADS, BASE_MIN_BLOCKS)
    k_base_final(const int* digits, const int* words, const int* qx,
                 const int* qy, const int* qz, int* ox, int* oy, int* oz,
                 int lanes, int n_windows, int n_entries) {
  // ring[slot][q][thread]: 16-byte vector q of the thread's entry; the
  // threads' vectors of one q adjacent, so the 16-byte reads are
  // conflict-free.
  __shared__ uint4 ring[FINAL_STAGES][4][BASE_THREADS];
  const int tid = threadIdx.x;
  const int lane = blockIdx.x * BASE_THREADS + tid;
  if (lane >= lanes) return;
  const uint4* table = reinterpret_cast<const uint4*>(words);

  auto fetch = [&](int w, u32 d, int slot) {
    const uint4* ent =
        table + ((size_t)w * n_entries + gather_entry(digit_mag(d, 1),
                                                      n_entries)) * 4;
#pragma unroll
    for (int q = 0; q < 4; ++q) cp_async16(&ring[slot][q][tid], ent + q);
    cp_async_commit();
  };

  u32 d = (u32)digits[lane];
  u32 d_next = n_windows > 1 ? (u32)digits[(size_t)lanes + lane] : 0u;
  fetch(0, d, 0);
  Pt acc;
  pt_set_identity(acc);
#pragma unroll 1
  for (int w = 0; w < n_windows; ++w) {
    u32 d_after = 0u;
    if (w + 1 < n_windows) {
      fetch(w + 1, d_next, (w + 1) & 1);
      if (w + 2 < n_windows)
        d_after = (u32)digits[(size_t)(w + 2) * lanes + lane];
      cp_async_wait<1>();  // window w's entry has landed
    } else {
      cp_async_wait<0>();
    }
    u32 x[8], y[8];
    unpack_entry(ring[w & 1][0][tid], ring[w & 1][1][tid],
                 ring[w & 1][2][tid], ring[w & 1][3][tid], x, y);
    base_step(acc, w, digit_mag(d, 1), digit_neg(d, 1), x, y);
    d = d_next;
    d_next = d_after;
  }
  Pt q;
  pt_load(qx, qy, qz, lanes, lane, q);
  base_final_add(acc, q);
  pt_store(ox, oy, oz, lanes, lane, acc);
}

// ---------------------------------------------------------------------------
// k_base_scan
// ---------------------------------------------------------------------------

// Copy the [64, count] byte slice of entries c0 .. c0 + count - 1 of window
// w into a stage (byte column j at j * STAGE_STRIDE), all threads of the
// block sharing the 16-byte vectors.  count is a multiple of 32.
__device__ __forceinline__ void stage_issue(uint8_t* stage,
                                            const uint8_t* tbytes, int w,
                                            int c0, int count, int e_pad) {
  const uint8_t* src = tbytes + (size_t)w * 64 * e_pad + c0;
  const int per_col = count >> 4;
  for (int i = threadIdx.x; i < 64 * per_col; i += BASE_THREADS) {
    const int j = i / per_col, v = i - j * per_col;
    cp_async16(stage + j * STAGE_STRIDE + 16 * v,
               src + (size_t)j * e_pad + 16 * v);
  }
}

// The warp's select over one stage: its 32 selection rows get the product
// of their one-hot rows with the staged entries c0 .. c0 + count - 1 (store
// for the window's first stage, OR for the others: one stage holds the
// hit).  sh[i] = 8 (|d| - 1 - 4t) mod 2^32 for warp lane g + 8i (g =
// lane / 4, t = lane % 4): 8 x the one's column in the row, relative to the
// thread's first A-fragment column.  An A word is 1 << (sh - 8 e), which
// shl_clamp makes 0 wherever the shift is not 0, 8, 16 or 24 (the row's
// one lies outside the word), with no compare.  B fragments come by
// ldmatrix: matrices of 8 byte columns x 16 entries, lane 4r + c getting
// entries 4c..4c+3 of column r, the B layout of m16n8k32.  The x bytes and
// the y bytes are two passes, so that 32 accumulators are live, not 64.
__device__ __forceinline__ void select_stage(const uint8_t* stage, int c0,
                                             int count, const u32 sh[4],
                                             uint8_t* sel, bool first) {
  const int lid = threadIdx.x & 31, g = lid >> 2, t = lid & 3;
  // This thread's ldmatrix row: byte column (lid & 7) + 8 (lid >> 4),
  // entries 16 ((lid >> 3) & 1) on, of the pair of n-tiles.
  const uint8_t* rows = stage + ((lid & 7) + 8 * (lid >> 4)) * STAGE_STRIDE +
                        16 * ((lid >> 3) & 1);
#pragma unroll 1
  for (int h = 0; h < 2; ++h) {
    int acc[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;
#pragma unroll 2
    for (int k0 = 0; k0 < count; k0 += 32) {
      const u32 e8 = 8u * (u32)(c0 + k0);
      u32 a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const u32 s_g = sh[2 * mt] - e8, s_g8 = sh[2 * mt + 1] - e8;
        a[mt][0] = shl_clamp(1u, s_g);
        a[mt][1] = shl_clamp(1u, s_g8);
        a[mt][2] = shl_clamp(1u, s_g - 128u);
        a[mt][3] = shl_clamp(1u, s_g8 - 128u);
      }
#pragma unroll
      for (int p = 0; p < 2; ++p) {  // n-tiles 2p, 2p + 1 of this half
        u32 b[4];
        ldsm_x4(b, rows + (32 * h + 16 * p) * STAGE_STRIDE + k0);
        mma_u8(acc[0][2 * p], a[0], b);
        mma_u8(acc[1][2 * p], a[1], b);
        mma_u8(acc[0][2 * p + 1], a[0], b + 2);
        mma_u8(acc[1][2 * p + 1], a[1], b + 2);
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        uint16_t* lo = reinterpret_cast<uint16_t*>(
            sel + (16 * mt + g) * SEL_STRIDE + 32 * h + 8 * nt + 2 * t);
        uint16_t* hi = lo + 8 * SEL_STRIDE / 2;
        const int* c = acc[mt][nt];
        const uint16_t vlo = (uint16_t)(c[0] | (c[1] << 8));
        const uint16_t vhi = (uint16_t)(c[2] | (c[3] << 8));
        *lo = first ? vlo : (uint16_t)(*lo | vlo);
        *hi = first ? vhi : (uint16_t)(*hi | vhi);
      }
  }
}

__global__ void __launch_bounds__(BASE_THREADS, BASE_MIN_BLOCKS)
    k_base_scan(const int* digits, const uint8_t* tbytes, int* ox, int* oy,
                int* oz, int lanes, int n_windows, int e_pad,
                int signed_digits) {
  __shared__ __align__(16) uint8_t stages[2][64 * STAGE_STRIDE];
  __shared__ __align__(16) uint8_t sel_rows[BASE_WARPS][32 * SEL_STRIDE];
  const int tid = threadIdx.x, lid = tid & 31;
  uint8_t* sel = sel_rows[tid >> 5];
  const int lane = blockIdx.x * BASE_THREADS + tid;
  const bool live = lane < lanes;
  const int n_chunks = (e_pad + SCAN_CHUNK - 1) / SCAN_CHUNK;
  const int n_stages = n_windows * n_chunks;

  stage_issue(stages[0], tbytes, 0, 0, min(SCAN_CHUNK, e_pad), e_pad);
  cp_async_commit();
  u32 d_next = live ? (u32)digits[lane] : 0u;
  Pt acc;
  pt_set_identity(acc);
#pragma unroll 1
  for (int w = 0; w < n_windows; ++w) {
    const u32 d = d_next;
    d_next = live && w + 1 < n_windows
                 ? (u32)digits[(size_t)(w + 1) * lanes + lane]
                 : 0u;
    const u32 mag = digit_mag(d, signed_digits);
    u32 sh[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      sh[i] = 8u * (__shfl_sync(0xFFFFFFFFu, mag, (lid >> 2) + 8 * i) - 1u -
                    4u * (u32)(lid & 3));
#pragma unroll 1
    for (int c = 0; c < n_chunks; ++c) {
      const int s = w * n_chunks + c;
      cp_async_wait<0>();
      __syncthreads();  // stage s has landed for every thread, and every
                        // warp is done with the buffer stage s + 1 goes to
      if (s + 1 < n_stages) {
        const int c1 = c + 1 == n_chunks ? 0 : c + 1;
        stage_issue(stages[(s + 1) & 1], tbytes, c1 ? w : w + 1,
                    c1 * SCAN_CHUNK, min(SCAN_CHUNK, e_pad - c1 * SCAN_CHUNK),
                    e_pad);
      }
      cp_async_commit();
      select_stage(stages[s & 1], c * SCAN_CHUNK,
                   min(SCAN_CHUNK, e_pad - c * SCAN_CHUNK), sh, sel, c == 0);
    }
    __syncwarp();  // the warp's selection rows are written
    const uint4* row = reinterpret_cast<const uint4*>(sel + lid * SEL_STRIDE);
    u32 x[8], y[8];
    unpack_entry(row[0], row[1], row[2], row[3], x, y);
    base_step(acc, w, mag, digit_neg(d, signed_digits), x, y);
  }
  if (live) pt_store(ox, oy, oz, lanes, lane, acc);
}

// ---------------------------------------------------------------------------
// Launches.
// ---------------------------------------------------------------------------

// Four blocks an SM need the shared-memory carve-out at its largest.
static int prefer_shared(const void* fn) {
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
}

static int grid_for(int lanes) {
  return (lanes + BASE_THREADS - 1) / BASE_THREADS;
}

extern "C" int base_windowed_add(const void* digits, const void* tbytes,
                                 void* ox, void* oy, void* oz, int lanes,
                                 int n_windows, int e_pad, int signed_digits,
                                 void* stream) {
  static const int carveout = prefer_shared((const void*)k_base_scan);
  if (carveout) return carveout;
  k_base_scan<<<grid_for(lanes), BASE_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)digits, (const uint8_t*)tbytes, (int*)ox, (int*)oy,
      (int*)oz, lanes, n_windows, e_pad, signed_digits);
  return (int)cudaGetLastError();
}

extern "C" int base_windowed_add_final(const void* digits, const void* words,
                                       const void* qx, const void* qy,
                                       const void* qz, void* ox, void* oy,
                                       void* oz, int lanes, int n_windows,
                                       int n_entries, void* stream) {
  static const int carveout = prefer_shared((const void*)k_base_final);
  if (carveout) return carveout;
  k_base_final<<<grid_for(lanes), BASE_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)digits, (const int*)words, (const int*)qx, (const int*)qy,
      (const int*)qz, (int*)ox, (int*)oy, (int*)oz, lanes, n_windows,
      n_entries);
  return (int)cudaGetLastError();
}

// Resident blocks an SM of k_base_scan (which = 0) or k_base_final (1) at
// 128 threads, after the carve-out above; -1 on an error.
extern "C" int base_blocks_per_sm(int which) {
  const void* fn =
      which ? (const void*)k_base_final : (const void*)k_base_scan;
  int blocks = 0;
  if (prefer_shared(fn) ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, BASE_THREADS,
                                                    0))
    return -1;
  return blocks;
}
