// yama full-row DP on Hopper: the forward pass and the traceback.
//
// Replaces the two jitted scans of multiz_tpu/ops/yama_jax.py that the JAX
// package runs as one XLA program per bucket (vmapped in
// _yama_device_batch): _yama_core (yama_jax.py:66; lax.scan over rows at
// :212) and _traceback_core (:225; the fixed-trip lax.scan at :262). The
// plain versions are multiz_tpu_torch/ops/yama_full.py:yama_core_reference
// and traceback_reference. The outputs are theirs, bit for bit: flags
// (B, m_pad+1, n_pad+1) uint8 in absolute dp columns, c | d<<2 | i<<4 in
// band and 0 elsewhere (rows past M included); C, D and I at (M, N); per
// problem a script of m_pad+n_pad ops walking back from (M, N), 255 past
// nedit, and nedit. Both kernels write every byte of their outputs, so the
// caller allocates them uninitialised.
//
// The JAX scan keeps the whole dp row, MININT outside the band. A cell in
// band reads the previous row at its own column and at the column to its
// left, and this row's C and D one column to its left; the in-row I chain
// (P, a prefix sum, and R, a prefix max) is MININT-based up to the band's
// left end. Only the columns of a row's band [LB[r], RB[r]] hold anything
// but MININT once the row is done, so a row is its band.
//
// Forward, two paths; the wrapper picks one per launch from the bucket's
// bands on the host (ops/yama_full.py:full_plan).
//
// Warp path (every window of at most 128 lanes, bands monotone, rows of
// at least 16 bytes: every real bucket; a row's window is its band joined
// with the previous row's). One warp per problem, several problems a block, no
// __syncthreads and no scratch in device memory: a row is a chain of a
// few hundred dependent instructions, so the card is kept busy by many
// independent warps, each of which must finish its rows fast.
//  * Lanes are blocked: thread t holds band lanes t*P .. t*P+P-1 of the
//    stored row's C, D and I in registers, band-local from LB[r]
//    (P = ceil(window/32), a template parameter), MININT past the band.
//    The previous row's read at the shift s = LB[r] - LB[r-1] >= 0 is, for
//    each of the P registers, a warp-uniform register select and one
//    __shfl_sync (shift_read); every column of the previous band lies in
//    the window, and lanes past it read MININT, as the scan's row holds.
//  * The I chain's sum and max scans are each an in-thread scan plus one
//    5-step shuffle scan.
//  * Operand loads stay off the row's chain. The A side's 12 words a row
//    (histA folded with ss_cat: sum_k ha[k] * ss_cat[k][j], the same sum
//    mod 2^32 as histB[c] @ ss_cat.T @ ha; a0, a1, pa) are loaded for 32
//    rows a chunk ahead, one row a lane, and staged in shared memory, read
//    as three 16-byte words a row; the B side's 12 words of each column of
//    row r+1 (histB, b0, b1, pb, in 8- and 16-byte loads) are loaded
//    before row r's arithmetic, into the other of two buffers.
//  * Flags: each chunk of FLUSH rows is staged band by band in a per-warp
//    shared buffer, a row at its device-memory alignment (32P + 16 bytes,
//    zeros around the band), so a 16-byte unit of device memory is one
//    aligned word of the stage. Then the chunk's rows go out whole, zeros
//    outside the bands included, every lane on every 32nd 16-byte unit,
//    between a ragged head and tail (rows are n_pad+1 bytes, an odd count;
//    a unit that spans two rows ORs both rows' staged words). Rows past M
//    are zeros. Every byte of the flag matrix is written once and nothing
//    zeroes it first: its 669 MB at the bench bucket are the bytes bound,
//    written between the rows' chains.
//
// Block path (wider windows, or bands that are not monotone: the
// synthetic wide buckets). One block of THREADS threads per problem loops
// over its rows. It keeps the whole row as the scan does and computes the
// columns that can change: row r's band and the previous row's band,
// which it resets to MININT. A row's columns are taken in tiles of
// THREADS, one column a thread: the D and C nodes from the stored row,
// then a block-wide sum scan for P and a max scan for R (warp shuffles,
// then the warps' totals through shared memory), each tile carrying the
// scans, this row's C and D and the stored row at its last column on to
// the next. The row's loop invariants of each column (histB @ ss_cat.T,
// b0, b1, pb) are kept beside the row's C, D and I, NREC ints a column,
// in a global scratch buffer of NREC x (n_pad+1) ints per problem, which
// serves every pad. The problem's flag matrix is zeroed first, so a row
// writes only the bytes of its band.
//
// int32 arithmetic wraps in XLA and in torch. Signed overflow is undefined
// in C++, so every sum and product here is taken in uint32_t and compared
// as int.
//
// Bound (ops/yama_full.py:full_dp_bound): the flag matrix written once
// (669 MB for the bench bucket, 637 problems at 1024 x 1024: 0.2 ms at
// 3.35 TB/s) or the recurrence's OPS_PER_CELL int32 operations per band
// cell, whichever takes longer; and the longest problem's chain of rows
// (full_dp_chain_bound), each row the recurrence's dependent step as the
// packed DP's chain bound counts it. On the warp path a row's time is its
// warp's instruction stream (it grows with P), and the flush's stores add
// about a third (PERF.md, section 6).
//
// Traceback. One warp per walk, several walks a block. A walk is a chain
// of dependent reads, each flag deciding the next address, so what bounds
// it is the latency of one step (full_tb_chain_bound); its bytes
// (full_tb_bound) take well under a microsecond. Lane 0 walks; meanwhile
// the warp stages the walk's next window of TB_ROWS rows in shared memory,
// double-buffered with 16-byte cp.async: for each row (one a lane) its
// band's bytes, copied from the 16-byte boundary at or below LB[r] (at
// most TB_SLOT bytes: 9 chunks, 113 lanes at any alignment), and LB[r],
// RB[r]. A step then reads its flag, LB and RB from shared memory. The
// walk keeps the JAX scan's semantics on every input: a step whose
// (row, column) is not staged (a band wider than the slot, or an invalid
// walk that leaves the matrix: a negative row indexes from the end, then
// clamps, the column clamps) reads device memory as the scan reads its
// matrix; the trip is at most m_pad+n_pad steps. The script is staged in
// shared memory and written with coalesced stores, 255 past nedit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef uint32_t u32;

constexpr int MININT = -(1 << 30);
constexpr int FLAG_C = 0, FLAG_I = 1, FLAG_D = 2;
constexpr unsigned FULL = 0xffffffffu;
// block path: one block of THREADS threads per problem
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
// The block path's per-column record, component k of column c at
// [k * (n_pad+1) + c]:
constexpr int R_SR = 0;   // sub_right[0..5] = histB[c] @ ss_cat.T
constexpr int R_B0 = 6;   // b0
constexpr int R_B1 = 7;   // b1
constexpr int R_PB = 8;   // pb[0..3]
constexpr int R_C = 12;   // the stored dp row: C, D, I
constexpr int R_D = 13;
constexpr int R_I = 14;
constexpr int NREC = 15;
// warp path, and the traceback: one warp a problem, MAX_PER_BLOCK a block
constexpr int WARP_MAX_P = 4;  // the widest window: 128 lanes
constexpr int MAX_PER_BLOCK = 4;
constexpr int CHUNK = 32;  // rows of an operand chunk
constexpr int FLUSH = 32;  // rows of a flag flush
// the A side's words of a row: histA folded with ss_cat, a0, a1, pa
constexpr int AW_HS = 0, AW_A0 = 6, AW_A1 = 7, AW_PA = 8, NAW = 12;
// traceback staging, per walk
constexpr int TB_ROWS = 32;     // rows a window, one a lane
constexpr int TB_SLOT = 144;    // band bytes a row: 9 chunks of 16
constexpr int TB_SCRIPT = 1024; // script bytes between flushes

__device__ __forceinline__ bool gt(u32 a, u32 b) { return (int)a > (int)b; }
__device__ __forceinline__ bool geq(u32 a, u32 b) { return (int)a >= (int)b; }
__device__ __forceinline__ u32 smax(u32 a, u32 b) { return gt(a, b) ? a : b; }

// C >= D > I preference over (x, y, z): the value picked and its flag
__device__ __forceinline__ u32 pick3(u32 x, u32 y, u32 z, int& flag) {
  const bool pc = geq(x, y) && geq(x, z);
  const bool pd = !pc && gt(y, z);
  flag = pc ? FLAG_C : pd ? FLAG_D : FLAG_I;
  return pc ? x : pd ? y : z;
}

__device__ __forceinline__ u32 warp_sum(u32 v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const u32 n = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v += n;
  }
  return v;
}

__device__ __forceinline__ u32 warp_max(u32 v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const u32 n = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v = smax(v, n);
  }
  return v;
}

// n bytes of value v at g: 16-byte stores between a ragged head and tail
__device__ __forceinline__ void fill_bytes(uint8_t* g, size_t n, uint8_t v,
                                           int lane) {
  const size_t h = min(n, (size_t)((16 - ((uintptr_t)g & 15)) & 15));
  if ((size_t)lane < h) g[lane] = v;
  const size_t nbody = (n - h) >> 4;
  const u32 w = 0x01010101u * v;
  uint4* g4 = reinterpret_cast<uint4*>(g + h);
  for (size_t i = lane; i < nbody; i += 32) g4[i] = make_uint4(w, w, w, w);
  const size_t t0 = h + (nbody << 4);
  if ((size_t)lane < n - t0) g[t0 + lane] = v;
}

// ======================= forward, block path =======================

// What the warps of a tile exchange: each warp's inclusive sum and max,
// and at its last column this row's C and D and the stored row's C, D, I.
struct Exchange {
  u32 sum[WARPS];
  u32 max[WARPS];
  u32 cd[WARPS][2];
  u32 old[WARPS][3];
};

__global__ void __launch_bounds__(THREADS) yama_full_dp_block(
    const int* __restrict__ histA, const int* __restrict__ a0v,
    const int* __restrict__ a1v, const int* __restrict__ pav,
    const int* __restrict__ histB, const int* __restrict__ b0v,
    const int* __restrict__ b1v, const int* __restrict__ pbv,
    const int* __restrict__ LBv, const int* __restrict__ RBv,
    const int* __restrict__ Mv, const int* __restrict__ Nv,
    const int* __restrict__ Kv, const int* __restrict__ Lv,
    const int* __restrict__ ss_cat, uint8_t* __restrict__ flags,
    int* __restrict__ last, int* __restrict__ scratch, int B, int m_pad,
    int n_pad, int go_i, int ge_i) {
  __shared__ Exchange ex;
  __shared__ u32 ss[36];
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int b = blockIdx.x;
  const int mp1 = m_pad + 1, np1 = n_pad + 1;
  int* rec = scratch + (size_t)b * NREC * np1;
  const int M = Mv[b], N = Nv[b];
  const u32 K = (u32)Kv[b], L = (u32)Lv[b], go = (u32)go_i, ge = (u32)ge_i;
  const int* LB = LBv + (size_t)b * mp1;
  const int* RB = RBv + (size_t)b * mp1;

  // 1. zero the problem's flag matrix: bytes to a 16-byte boundary, then
  // 16-byte stores, then the bytes left
  uint8_t* fb = flags + (size_t)b * mp1 * np1;
  {
    const size_t nbytes = (size_t)mp1 * np1;
    size_t head = (16 - ((uintptr_t)fb & 15)) & 15;
    if (head > nbytes) head = nbytes;
    const size_t body = (nbytes - head) >> 4;
    for (size_t i = tid; i < head; i += THREADS) fb[i] = 0;
    uint4* q = reinterpret_cast<uint4*>(fb + head);
    for (size_t i = tid; i < body; i += THREADS) q[i] = make_uint4(0, 0, 0, 0);
    for (size_t i = head + 16 * body + tid; i < nbytes; i += THREADS)
      fb[i] = 0;
  }
  if (tid < 36) ss[tid] = (u32)ss_cat[tid];
  __syncthreads();

  // 2. the column record and row 0 (mz_yama.c:82-94): C, D 0 at column 0
  // and MININT elsewhere; I 0 at column 0, MININT elsewhere until the
  // chain below
  {
    const int* hB = histB + (size_t)b * np1 * 6;
    const int* pB = pbv + (size_t)b * np1 * 4;
    for (int c = tid; c < np1; c += THREADS) {
      u32 h[6];
#pragma unroll
      for (int j = 0; j < 6; ++j) h[j] = (u32)hB[6 * c + j];
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        u32 s = 0;
#pragma unroll
        for (int j = 0; j < 6; ++j) s += h[j] * ss[6 * k + j];
        rec[(R_SR + k) * np1 + c] = (int)s;
      }
      rec[R_B0 * np1 + c] = b0v[(size_t)b * np1 + c];
      rec[R_B1 * np1 + c] = b1v[(size_t)b * np1 + c];
#pragma unroll
      for (int k = 0; k < 4; ++k) rec[(R_PB + k) * np1 + c] = pB[4 * c + k];
      const int z = c == 0 ? 0 : MININT;
      rec[R_C * np1 + c] = z;
      rec[R_D * np1 + c] = z;
      rec[R_I * np1 + c] = z;
    }
  }
  __syncthreads();
  // row 0's I chain over columns 1..RB[0]: -(prefix sum of b0) * K * ge,
  // flag I<<4
  const int rb0 = min(RB[0], n_pad);
  {
    u32 carry = 0;
    for (int t0 = 1; t0 <= rb0; t0 += THREADS) {
      const int c = t0 + tid;
      const bool act = c <= rb0;
      const u32 s = warp_sum(act ? (u32)rec[R_B0 * np1 + c] : 0u, lane);
      if (lane == 31) ex.sum[w] = s;
      __syncthreads();
      u32 pre = carry;
#pragma unroll
      for (int k = 0; k < WARPS; ++k) {
        if (k < w) pre += ex.sum[k];
        carry += ex.sum[k];
      }
      if (act) {
        rec[R_I * np1 + c] = (int)((0u - (pre + s)) * K * ge);
        fb[c] = (uint8_t)(FLAG_I << 4);
      }
      __syncthreads();
    }
  }

  // 3. rows 1..M
  int plo = 0, phi = max(rb0, 0);  // the stored row's band
  const int rows = min(M, m_pad);
  for (int r = 1; r <= rows; ++r) {
    const int lb = LB[r], rb = RB[r], lbm1 = LB[r - 1];
    const int lbm2 = r >= 2 ? LB[r - 2] : 0;
    const int* hA = histA + ((size_t)b * mp1 + r) * 6;
    const int* pA = pav + ((size_t)b * mp1 + r) * 4;
    u32 ha[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) ha[k] = (u32)hA[k];
    const u32 a0r = (u32)a0v[(size_t)b * mp1 + r];
    const u32 a1r = (u32)a1v[(size_t)b * mp1 + r];
    const u32 p0 = (u32)pA[0], p1 = (u32)pA[1], p2 = (u32)pA[2],
              p3 = (u32)pA[3];
    const bool not1 = r > 1, live = r != M;
    const u32 Kge = K * ge, goK = go * K;
    const u32 yD = go * p2 * L, zD = go * a0r * L, eD = a0r * L * ge;
    const int lo = max(0, min(lb, plo)), hi = min(n_pad, max(rb, phi));
    uint8_t* frow = fb + (size_t)r * np1;
    // carried into each tile: P and R up to the column left of it, this
    // row's C and D there, and the stored row there before this row
    u32 cP = 0, cR = (u32)MININT, cCn = (u32)MININT, cDn = (u32)MININT;
    u32 cOc = 0, cOd = 0, cOi = 0;
    for (int t0 = lo; t0 <= hi; t0 += THREADS) {
      const int c = t0 + tid;
      const bool act = c <= hi;
      const bool in_band = act && c >= lb && c <= rb;
      u32 oC = (u32)MININT, oD = (u32)MININT, oI = (u32)MININT;
      u32 Cn = (u32)MININT, Dn = (u32)MININT, s = 0, e = 0, b0 = 0, pb0 = 0,
          pb2 = 0;
      int fc = 0, fd = 0;
      if (act) {
        b0 = (u32)rec[R_B0 * np1 + c];
        const u32 b1 = (u32)rec[R_B1 * np1 + c];
        pb0 = (u32)rec[(R_PB + 0) * np1 + c];
        const u32 pb1 = (u32)rec[(R_PB + 1) * np1 + c];
        pb2 = (u32)rec[(R_PB + 2) * np1 + c];
        const u32 pb3 = (u32)rec[(R_PB + 3) * np1 + c];
        oC = (u32)rec[R_C * np1 + c];
        oD = (u32)rec[R_D * np1 + c];
        oI = (u32)rec[R_I * np1 + c];
        // the stored row one column left (the diagonal read)
        u32 dC = (u32)MININT, dD = (u32)MININT, dI = (u32)MININT;
        if (c > 0) {
          if (tid == 0 && t0 != lo) {
            dC = cOc, dD = cOd, dI = cOi;
          } else {
            dC = (u32)rec[R_C * np1 + c - 1];
            dD = (u32)rec[R_D * np1 + c - 1];
            dI = (u32)rec[R_I * np1 + c - 1];
          }
        }
        // D node: the previous row, same column
        const bool inner = c > 0 && c < N;
        const u32 xD = go * (p0 * b0 + p2 * L);
        const u32 xs = oC - ((inner && c > lbm2 && not1) ? xD : 0u);
        const u32 ys = oD - ((inner && not1) ? yD : 0u);
        const u32 zs = oI - ((inner && c > lbm1) ? zD : 0u);
        const u32 dv = pick3(xs, ys, zs, fd);
        Dn = in_band ? dv - eD : (u32)MININT;
        // C node: the previous row's diagonal
        const bool gt1 = c > 1;
        const u32 xC = go * (p0 * pb1 + p1 * (pb0 + pb2) + p2 * (pb1 + pb3) +
                             p3 * pb2);
        const u32 yC = go * (p1 * b0 + p2 * b1 + p3 * b0);
        const u32 zC = go * (a0r * (pb1 + pb3) + a1r * pb2);
        const u32 xd = dC - ((gt1 && c > lbm2 + 1 && not1) ? xC : 0u);
        const u32 yd = dD - ((gt1 && not1) ? yC : 0u);
        const u32 zd = dI - ((gt1 && c > lbm1 + 1) ? zC : 0u);
        const u32 cv = pick3(xd, yd, zd, fc);
        u32 sub = 0;
#pragma unroll
        for (int k = 0; k < 6; ++k)
          sub += (u32)rec[(R_SR + k) * np1 + c] * ha[k];
        const bool reach = c > lbm1;
        Cn = (in_band && reach) ? cv + sub : (u32)MININT;
        if (!reach) fc = 0;
        // the I chain's summand
        e = b0 * Kge;
        const u32 zI = live ? goK * pb2 : 0u;
        if (c >= lb + 1 && c <= rb) s = ((c > lb + 1) ? zI : 0u) + e;
      }
      // P: this tile's inclusive sum; C and D one column left
      u32 P = warp_sum(s, lane);
      u32 Cl = __shfl_up_sync(FULL, Cn, 1), Dl = __shfl_up_sync(FULL, Dn, 1);
      if (lane == 31) {
        ex.sum[w] = P;
        ex.cd[w][0] = Cn;
        ex.cd[w][1] = Dn;
        ex.old[w][0] = oC;
        ex.old[w][1] = oD;
        ex.old[w][2] = oI;
      }
      __syncthreads();
      u32 pre = cP;
#pragma unroll
      for (int k = 0; k < WARPS; ++k) {
        if (k < w) pre += ex.sum[k];
        cP += ex.sum[k];
      }
      P += pre;
      if (lane == 0) {
        Cl = w ? ex.cd[w - 1][0] : cCn;
        Dl = w ? ex.cd[w - 1][1] : cDn;
      }
      cCn = ex.cd[WARPS - 1][0];
      cDn = ex.cd[WARPS - 1][1];
      cOc = ex.old[WARPS - 1][0];
      cOd = ex.old[WARPS - 1][1];
      cOi = ex.old[WARPS - 1][2];
      // I node: the prefix max over V = max(x, y) - e + P
      const u32 xI = live ? go * (a0r * (pb0 + pb2) + a1r * pb2) : 0u;
      const u32 yI = live ? goK * b0 : 0u;
      const u32 xv = Cl - ((c > lbm1 + 1) ? xI : 0u);
      const u32 yv = Dl - yI;
      const bool from_y = gt(yv, xv);
      const u32 V = smax(xv, yv) - e + P;
      u32 R = warp_max((act && c > lb) ? V : (u32)MININT, lane);
      if (lane == 31) ex.max[w] = R;
      __syncthreads();
      u32 preR = cR;
#pragma unroll
      for (int k = 0; k < WARPS; ++k) {
        if (k < w) preR = smax(preR, ex.max[k]);
        cR = smax(cR, ex.max[k]);
      }
      R = smax(R, preR);
      u32 Wp = __shfl_up_sync(FULL, R, 1);
      if (lane == 0) Wp = preR;
      if (act) {
        const bool zwin = gt(Wp, V) || (Wp == V && from_y);
        const int fi = c <= lb ? 0 : zwin ? FLAG_I : from_y ? FLAG_D : FLAG_C;
        rec[R_C * np1 + c] = (int)Cn;
        rec[R_D * np1 + c] = (int)Dn;
        rec[R_I * np1 + c] = (in_band && c > lb) ? (int)(R - P) : MININT;
        if (in_band) frow[c] = (uint8_t)(fc | (fd << 2) | (fi << 4));
      }
    }
    plo = lb;
    phi = rb;
    __syncthreads();  // the next row reads what this one stored
  }

  // 4. the last row's C, D, I at column N (clamped, as jnp indexes)
  if (tid == 0) {
    const int n = min(max(N < 0 ? N + np1 : N, 0), n_pad);
    last[b] = rec[R_C * np1 + n];
    last[B + b] = rec[R_D * np1 + n];
    last[2 * B + b] = rec[R_I * np1 + n];
  }
}

// ======================= forward, warp path =======================

// v[e] for a warp-uniform e, as selects (no local-memory indexing)
template <int P>
__device__ __forceinline__ u32 sel(const u32 (&v)[P], int e) {
  u32 x = v[0];
#pragma unroll
  for (int k = 1; k < P; ++k) x = (e == k) ? v[k] : x;
  return x;
}

// out[q] = the value at band lane t*P + q + d (t = this lane), MININT
// past the warp's 32P lanes. d >= 0 is warp-uniform.
template <int P>
__device__ __forceinline__ void shift_read(const u32 (&v)[P], int d, int lane,
                                           u32 (&out)[P]) {
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const int dq = q + d;
    const int off = dq / P;  // source thread = lane + off
    const u32 x = __shfl_sync(FULL, sel(v, dq - off * P), (lane + off) & 31);
    out[q] = (lane + off < 32) ? x : (u32)MININT;
  }
}

// out[q] = the value at band lane t*P + q - 1, MININT at lane 0
template <int P>
__device__ __forceinline__ void shift_down1(const u32 (&v)[P], int lane,
                                            u32 (&out)[P]) {
  const u32 up = __shfl_up_sync(FULL, v[P - 1], 1);
  out[0] = lane > 0 ? up : (u32)MININT;
#pragma unroll
  for (int q = 1; q < P; ++q) out[q] = v[q - 1];
}

// Inclusive sum scan over the warp's 32P band lanes (wrapping).
template <int P>
__device__ __forceinline__ void sum_scan(const u32 (&v)[P], int lane,
                                         u32 (&out)[P]) {
  u32 loc = 0;
#pragma unroll
  for (int q = 0; q < P; ++q) {
    loc += v[q];
    out[q] = loc;
  }
  const u32 t = warp_sum(loc, lane);
  u32 ex = __shfl_up_sync(FULL, t, 1);
  if (lane == 0) ex = 0;
#pragma unroll
  for (int q = 0; q < P; ++q) out[q] += ex;
}

// Inclusive max scan over the warp's 32P band lanes: R = the scan at the
// lane, W = the scan at the lane before (MININT at lane 0).
template <int P>
__device__ __forceinline__ void max_scan(const u32 (&v)[P], int lane,
                                         u32 (&R)[P], u32 (&W)[P]) {
  u32 loc[P];
  loc[0] = v[0];
#pragma unroll
  for (int q = 1; q < P; ++q) loc[q] = smax(loc[q - 1], v[q]);
  const u32 t = warp_max(loc[P - 1], lane);
  const u32 carry = __shfl_up_sync(FULL, t, 1);
#pragma unroll
  for (int q = 0; q < P; ++q) R[q] = lane > 0 ? smax(loc[q], carry) : loc[q];
  W[0] = lane > 0 ? carry : (u32)MININT;
#pragma unroll
  for (int q = 1; q < P; ++q) W[q] = R[q - 1];
}

// The B side's words of a thread's P columns of one row: histB, b0, b1,
// pb (columns past the band read the band's first column).
template <int P>
struct BCols {
  u32 h[6][P], b0[P], b1[P], pb[4][P];
};

template <int P>
__device__ __forceinline__ void load_bcols(BCols<P>& o,
                                           const int* __restrict__ hB,
                                           const int* __restrict__ b0p,
                                           const int* __restrict__ b1p,
                                           const int* __restrict__ pB, int lb,
                                           int rb, int lane) {
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const int col = lb + lane * P + q;
    const int cc = col <= rb ? col : lb;
    // histB rows are 24 bytes (8-byte aligned), pb rows 16
    const int2* h2 = reinterpret_cast<const int2*>(hB + 6 * cc);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int2 v = __ldg(h2 + j);
      o.h[2 * j][q] = (u32)v.x;
      o.h[2 * j + 1][q] = (u32)v.y;
    }
    const int4 p4 = __ldg(reinterpret_cast<const int4*>(pB + 4 * cc));
    o.pb[0][q] = (u32)p4.x;
    o.pb[1][q] = (u32)p4.y;
    o.pb[2][q] = (u32)p4.z;
    o.pb[3][q] = (u32)p4.w;
    o.b0[q] = (u32)__ldg(b0p + cc);
    o.b1[q] = (u32)__ldg(b1p + cc);
  }
}

// The A side's raw words of row r: histA, a0, a1, pa (zeros past M)
__device__ __forceinline__ void load_arow(u32 (&w)[NAW],
                                          const int* __restrict__ hA,
                                          const int* __restrict__ a0p,
                                          const int* __restrict__ a1p,
                                          const int* __restrict__ pA, int r,
                                          int M) {
  const bool ok = r <= M;
#pragma unroll
  for (int j = 0; j < 6; ++j) w[AW_HS + j] = ok ? (u32)__ldg(hA + 6 * r + j) : 0u;
  w[AW_A0] = ok ? (u32)__ldg(a0p + r) : 0u;
  w[AW_A1] = ok ? (u32)__ldg(a1p + r) : 0u;
#pragma unroll
  for (int k = 0; k < 4; ++k) w[AW_PA + k] = ok ? (u32)__ldg(pA + 4 * r + k) : 0u;
}

// histA's six words -> hs[j] = sum_k ha[k] * ss_cat[k][j], so that a
// column's substitution score is sum_j histB[c][j] * hs[j]
__device__ __forceinline__ void fold_scores(u32 (&w)[NAW],
                                            const int* __restrict__ ss) {
  u32 ha[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) ha[k] = w[AW_HS + k];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    u32 s = 0;
#pragma unroll
    for (int k = 0; k < 6; ++k) s += ha[k] * (u32)__ldg(ss + 6 * k + j);
    w[AW_HS + j] = s;
  }
}

// A chunk's FLUSH rows are staged before they are written. A staged row
// is RS = 32P + 16 bytes, laid out at its device-memory alignment: the
// byte of column LB + j of a row starting at g sits at (g + LB) % 16 + j,
// zeros around the band, so a 16-byte unit of device memory is one aligned
// 16-byte word of the stage. bands[i] and bands[FLUSH + i] are staged row
// i's LB and RB. Offsets are bytes from the chunk's first row, whose
// device address is bmod past a 16-byte boundary.

// The staged flag byte at offset x of staged row i (starting at offset g).
__device__ __forceinline__ u32 staged_byte(int x, int g, int i, int bmod,
                                           const uint8_t* stage, int rs,
                                           const int* bands) {
  const int gb = g + bands[i], ge = g + bands[FLUSH + i];
  return (x >= gb && x <= ge)
             ? (u32)stage[i * rs + x + bmod - ((gb + bmod) & ~15)]
             : 0u;
}

// The staged bytes of row i (starting at offset g) in the 16-byte unit at
// offset x (x + bmod a multiple of 16): zeros unless the unit meets the
// band.
__device__ __forceinline__ uint4 staged16(int x, int g, int i, int bmod,
                                          const uint8_t* stage, int rs,
                                          const int* bands) {
  const int gb = g + bands[i], ge = g + bands[FLUSH + i];
  if (x + 15 < gb || x > ge) return make_uint4(0u, 0u, 0u, 0u);
  return *reinterpret_cast<const uint4*>(stage + i * rs + x + bmod -
                                         ((gb + bmod) & ~15));
}

// The staged rows 0..nrows-1 of a chunk (np1 >= 16 bytes each, the first
// at g0) out whole: a ragged head and tail a byte a lane, 16-byte stores
// between, each lane on every 32nd unit. A unit that passes its row's end
// ORs in the next row's staged bytes.
__device__ __forceinline__ void flush_rows(uint8_t* g0, int nrows, int np1,
                                           const uint8_t* stage, int rs,
                                           const int* bands, int lane) {
  const int bmod = (int)((uintptr_t)g0 & 15);
  const int total = nrows * np1;
  const int head = min(total, (16 - bmod) & 15);
  const int nunits = (total - head) >> 4;
  const int t0 = head + (nunits << 4);
  if (lane < head) {
    const int i = lane / np1;
    g0[lane] = (uint8_t)staged_byte(lane, i * np1, i, bmod, stage, rs, bands);
  }
  if (lane < total - t0) {
    const int x = t0 + lane, i = x / np1;
    g0[x] = (uint8_t)staged_byte(x, i * np1, i, bmod, stage, rs, bands);
  }
  uint4* g4 = reinterpret_cast<uint4*>(g0 + head);
  int i = (head + 16 * lane) / np1;  // the row of this lane's next unit
  int g = i * np1;                    // its first byte
#pragma unroll 4
  for (int u = lane; u < nunits; u += 32) {
    const int x = head + 16 * u;
    while (x >= g + np1) {
      g += np1;
      ++i;
    }
    uint4 v = staged16(x, g, i, bmod, stage, rs, bands);
    if (x + 16 > g + np1) {
      const uint4 w = staged16(x, g + np1, i + 1, bmod, stage, rs, bands);
      v = make_uint4(v.x | w.x, v.y | w.y, v.z | w.z, v.w | w.w);
    }
    g4[u] = v;
  }
}

template <int P>
__global__ void __launch_bounds__(32 * MAX_PER_BLOCK) yama_full_dp_warp(
    const int* __restrict__ histA, const int* __restrict__ a0v,
    const int* __restrict__ a1v, const int* __restrict__ pav,
    const int* __restrict__ histB, const int* __restrict__ b0v,
    const int* __restrict__ b1v, const int* __restrict__ pbv,
    const int* __restrict__ LBv, const int* __restrict__ RBv,
    const int* __restrict__ Mv, const int* __restrict__ Nv,
    const int* __restrict__ Kv, const int* __restrict__ Lv,
    const int* __restrict__ ss_cat, uint8_t* __restrict__ flags,
    int* __restrict__ last, int B, int m_pad, int n_pad, int go_i,
    int ge_i) {
  constexpr int SW = 32 * P;  // a row's band lanes
  constexpr int RS = SW + 16; // a staged row: its band from up to 15 bytes in
  // per warp: FLUSH staged flag rows, their bands, the chunk's A words
  __shared__ __align__(16) uint8_t stage_all[MAX_PER_BLOCK][FLUSH * RS];
  __shared__ int bands_all[MAX_PER_BLOCK][2 * FLUSH];
  __shared__ int4 arows_all[MAX_PER_BLOCK][CHUNK][NAW / 4];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + wid;
  if (b >= B) return;  // whole warps only: nothing below syncs the block
  uint8_t* stage = stage_all[wid];
  int* bands = bands_all[wid];
  int4(*arows)[NAW / 4] = arows_all[wid];
  const int mp1 = m_pad + 1, np1 = n_pad + 1;
  const int M = __ldg(Mv + b), N = __ldg(Nv + b);
  const u32 K = (u32)__ldg(Kv + b), L = (u32)__ldg(Lv + b);
  const u32 go = (u32)go_i, ge = (u32)ge_i, Kge = K * ge, goK = go * K;
  const int* LB = LBv + (size_t)b * mp1;
  const int* RB = RBv + (size_t)b * mp1;
  const int* hA = histA + (size_t)b * mp1 * 6;
  const int* a0p = a0v + (size_t)b * mp1;
  const int* a1p = a1v + (size_t)b * mp1;
  const int* pA = pav + (size_t)b * mp1 * 4;
  const int* hB = histB + (size_t)b * np1 * 6;
  const int* b0p = b0v + (size_t)b * np1;
  const int* b1p = b1v + (size_t)b * np1;
  const int* pB = pbv + (size_t)b * np1 * 4;
  uint8_t* fb = flags + (size_t)b * mp1 * np1;

  // rows 0..31 of the operands (the A words through shared memory, one
  // row a lane), and a chunk ahead the next 32
  int lbc = lane <= M ? __ldg(LB + lane) : 0;
  int rbc = lane <= M ? __ldg(RB + lane) : 0;
  auto put_arow = [&](u32 (&w)[NAW]) {
    fold_scores(w, ss_cat);
#pragma unroll
    for (int t = 0; t < NAW / 4; ++t)
      arows[lane][t] = make_int4((int)w[4 * t], (int)w[4 * t + 1],
                                 (int)w[4 * t + 2], (int)w[4 * t + 3]);
  };
  {
    u32 aw[NAW];
    load_arow(aw, hA, a0p, a1p, pA, lane, M);
    put_arow(aw);
    __syncwarp();
  }
  int lbn, rbn;
  u32 an[NAW];
  auto prefetch = [&](int c0) {
    const int rn = c0 + CHUNK + lane;
    lbn = rn <= M ? __ldg(LB + rn) : 0;
    rbn = rn <= M ? __ldg(RB + rn) : 0;
    load_arow(an, hA, a0p, a1p, pA, rn, M);
  };
  prefetch(0);

  // ---- row 0 (mz_yama.c:82-94): C, D 0 at column 0 and MININT
  // elsewhere; I 0 at column 0, then -(prefix sum of b0) * K * ge over
  // columns 1..RB[0], flag I<<4 ----
  u32 pC[P], pD[P], pI[P];
  const int rb0 = min(__shfl_sync(FULL, rbc, 0), n_pad);
  // row r's staged bytes in slot r % FLUSH, at the alignment of column LB
  // in device memory: lane t's P band lanes, and lanes 0..15 the 16 bytes
  // of padding around them, so that every byte of the slot is written
  auto stage_row = [&](int r, int lb, int rb, const u32 (&fl)[P]) {
    const int sl = r % FLUSH;
    uint8_t* slot = stage + sl * RS;
    const int h = (int)(((uintptr_t)fb + (size_t)r * np1 + lb) & 15);
#pragma unroll
    for (int q = 0; q < P; ++q) slot[h + lane * P + q] = (uint8_t)fl[q];
    if (lane < 16) slot[lane < h ? lane : SW + lane] = 0;
    if (lane == 0) {
      bands[sl] = lb;
      bands[FLUSH + sl] = rb;
    }
  };
  {
    u32 v[P], S[P], f0[P];
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const int j = lane * P + q;
      v[q] = (j >= 1 && j <= rb0) ? (u32)__ldg(b0p + j) : 0u;
    }
    sum_scan(v, lane, S);
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const int j = lane * P + q;
      const bool ch = j >= 1 && j <= rb0;
      pC[q] = j == 0 ? 0u : (u32)MININT;
      pD[q] = pC[q];
      pI[q] = j == 0 ? 0u : ch ? (0u - S[q]) * K * ge : (u32)MININT;
      f0[q] = ch ? (u32)(FLAG_I << 4) : 0u;
    }
    stage_row(0, 0, rb0, f0);
  }
  int base = 0;  // the stored row's first column
  int lbm1 = __shfl_sync(FULL, lbc, 0), lbm2 = 0;  // LB[r-1], LB[r-2]
  uint8_t* fl0 = fb;  // the current flush's first row

  // One row r >= 1. Row r+1's B words go into `nxt` before row r's
  // arithmetic; the caller alternates two buffers.
  auto step = [&](int r, const BCols<P>& cur, BCols<P>& nxt) {
    const int rr = r & (CHUNK - 1);
    if (rr == 0) {  // a new chunk: the prefetched operands become current
      lbc = lbn;
      rbc = rbn;
      put_arow(an);  // every lane has read the last chunk's (__syncwarp)
      prefetch(r);
      __syncwarp();
    }
    const int lbr = __shfl_sync(FULL, lbc, rr);
    const int rbr = __shfl_sync(FULL, rbc, rr);
    u32 a[NAW];
#pragma unroll
    for (int t = 0; t < NAW / 4; ++t) {
      const int4 v = arows[rr][t];
      a[4 * t] = (u32)v.x;
      a[4 * t + 1] = (u32)v.y;
      a[4 * t + 2] = (u32)v.z;
      a[4 * t + 3] = (u32)v.w;
    }
    if (r < M) {
      const bool wrap = rr + 1 == CHUNK;
      const int l1 = __shfl_sync(FULL, wrap ? lbn : lbc, (rr + 1) & 31);
      const int r1 = __shfl_sync(FULL, wrap ? rbn : rbc, (rr + 1) & 31);
      load_bcols(nxt, hB, b0p, b1p, pB, l1, r1, lane);
    }
    const u32 a0r = a[AW_A0], a1r = a[AW_A1];
    const u32 p0 = a[AW_PA], p1 = a[AW_PA + 1], p2 = a[AW_PA + 2],
              p3 = a[AW_PA + 3];
    const bool not1 = r > 1, live = r != M;
    const u32 yD = go * p2 * L, zD = go * a0r * L, eD = a0r * L * ge;

    // the stored row at this row's columns and one column left
    const int s = lbr - base;
    u32 upC[P], upD[P], upI[P], dgC[P], dgD[P], dgI[P];
    shift_read(pC, s, lane, upC);
    shift_read(pD, s, lane, upD);
    shift_read(pI, s, lane, upI);
    if (s > 0) {
      shift_read(pC, s - 1, lane, dgC);
      shift_read(pD, s - 1, lane, dgD);
      shift_read(pI, s - 1, lane, dgI);
    } else {
      shift_down1(pC, lane, dgC);
      shift_down1(pD, lane, dgD);
      shift_down1(pI, lane, dgI);
    }

    u32 Cn[P], Dn[P], sv[P];
    int fcd[P];
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const int col = lbr + lane * P + q;
      const bool in_band = col <= rbr;
      const u32 b0 = cur.b0[q], b1 = cur.b1[q];
      const u32 pb0 = cur.pb[0][q], pb1 = cur.pb[1][q], pb2 = cur.pb[2][q],
                pb3 = cur.pb[3][q];
      // D node: the previous row, same column
      const bool inner = col > 0 && col < N;
      const u32 xD = go * (p0 * b0 + p2 * L);
      const u32 xs = upC[q] - ((inner && col > lbm2 && not1) ? xD : 0u);
      const u32 ys = upD[q] - ((inner && not1) ? yD : 0u);
      const u32 zs = upI[q] - ((inner && col > lbm1) ? zD : 0u);
      int fd;
      const u32 dv = pick3(xs, ys, zs, fd);
      Dn[q] = in_band ? dv - eD : (u32)MININT;
      // C node: the previous row's diagonal
      const bool gt1 = col > 1;
      const u32 xC = go * (p0 * pb1 + p1 * (pb0 + pb2) + p2 * (pb1 + pb3) +
                           p3 * pb2);
      const u32 yC = go * (p1 * b0 + p2 * b1 + p3 * b0);
      const u32 zC = go * (a0r * (pb1 + pb3) + a1r * pb2);
      const u32 xd = dgC[q] - ((gt1 && col > lbm2 + 1 && not1) ? xC : 0u);
      const u32 yd = dgD[q] - ((gt1 && not1) ? yC : 0u);
      const u32 zd = dgI[q] - ((gt1 && col > lbm1 + 1) ? zC : 0u);
      int fc;
      const u32 cv = pick3(xd, yd, zd, fc);
      u32 sub = 0;
#pragma unroll
      for (int j = 0; j < 6; ++j) sub += cur.h[j][q] * a[AW_HS + j];
      const bool reach = col > lbm1;
      Cn[q] = (in_band && reach) ? cv + sub : (u32)MININT;
      fcd[q] = (reach ? fc : 0) | (fd << 2);
      // the I chain's summand
      const u32 e = b0 * Kge;
      const u32 zI = live ? goK * pb2 : 0u;
      sv[q] = (col >= lbr + 1 && in_band) ? ((col > lbr + 1) ? zI : 0u) + e
                                           : 0u;
    }
    // I node: the prefix max over V = max(x, y) - e + P
    u32 Ps[P], Cl[P], Dl[P];
    sum_scan(sv, lane, Ps);
    shift_down1(Cn, lane, Cl);
    shift_down1(Dn, lane, Dl);
    u32 V[P], Vm[P];
    bool fy[P];
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const int col = lbr + lane * P + q;
      const u32 b0 = cur.b0[q], pb0 = cur.pb[0][q], pb2 = cur.pb[2][q];
      const u32 xI = live ? go * (a0r * (pb0 + pb2) + a1r * pb2) : 0u;
      const u32 yI = live ? goK * b0 : 0u;
      const u32 xv = Cl[q] - ((col > lbm1 + 1) ? xI : 0u);
      const u32 yv = Dl[q] - yI;
      fy[q] = gt(yv, xv);
      V[q] = smax(xv, yv) - b0 * Kge + Ps[q];
      Vm[q] = col > lbr ? V[q] : (u32)MININT;
    }
    u32 R[P], W[P];
    max_scan(Vm, lane, R, W);
    u32 fr[P];
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const int j = lane * P + q;
      const int col = lbr + j;
      const bool in_band = col <= rbr;
      const bool zwin = gt(W[q], V[q]) || (W[q] == V[q] && fy[q]);
      const int fi = col <= lbr ? 0 : zwin ? FLAG_I : fy[q] ? FLAG_D : FLAG_C;
      fr[q] = in_band ? (u32)(fcd[q] | (fi << 4)) : 0u;
      pC[q] = Cn[q];
      pD[q] = Dn[q];
      pI[q] = (in_band && col > lbr) ? R[q] - Ps[q] : (u32)MININT;
    }
    stage_row(r, lbr, rbr, fr);
    lbm2 = lbm1;
    lbm1 = lbr;
    base = lbr;
    if (r % FLUSH == FLUSH - 1 || r == M) {  // the staged rows out
      __syncwarp();
      flush_rows(fl0, r % FLUSH + 1, np1, stage, RS, bands, lane);
      __syncwarp();
      fl0 += (size_t)FLUSH * np1;
    }
  };

  BCols<P> bA, bB;
  if (M >= 1)
    load_bcols(bA, hB, b0p, b1p, pB, __shfl_sync(FULL, lbc, 1),
               __shfl_sync(FULL, rbc, 1), lane);
  for (int r = 1; r <= M; r += 2) {
    step(r, bA, bB);
    if (r == M) break;
    step(r + 1, bB, bA);
  }
  if (M <= 0) {  // row 0 alone
    __syncwarp();
    flush_rows(fb, 1, np1, stage, RS, bands, lane);
  }

  // the last row's C, D, I at column N (clamped, as jnp indexes)
  {
    const int n = min(max(N < 0 ? N + np1 : N, 0), n_pad);
    const int idx = n - base;
#pragma unroll
    for (int q = 0; q < P; ++q) {
      if (lane * P + q == idx) {
        last[b] = (int)pC[q];
        last[B + b] = (int)pD[q];
        last[2 * B + b] = (int)pI[q];
      }
    }
    if (lane == 0 && (idx < 0 || idx >= SW)) {
      last[b] = MININT;
      last[B + b] = MININT;
      last[2 * B + b] = MININT;
    }
  }
  // rows past M are zeros
  const int done = max(M, 0) + 1;
  fill_bytes(fb + (size_t)done * np1, (size_t)(mp1 - done) * np1, 0, lane);
}

// ======================= traceback =======================

__device__ __forceinline__ void cp_async16(void* s, const void* g) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(s)),
               "l"(g));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// A walk's shared memory: two windows of TB_ROWS staged rows (row hi - i
// in slot i), each row's (LB, RB, cs, ce) with columns cs..ce of the row
// held in its slot from byte 0 (ce < cs: none), and the staged script.
struct TbStage {
  uint8_t fl[2][TB_ROWS * TB_SLOT];
  int4 info[2][TB_ROWS];
  uint8_t script[TB_SCRIPT];
};

__global__ void __launch_bounds__(32 * MAX_PER_BLOCK) yama_full_tb_kernel(
    const uint8_t* __restrict__ flags, const int* __restrict__ LBv,
    const int* __restrict__ RBv, const int* __restrict__ Mv,
    const int* __restrict__ Nv, const int* __restrict__ lastC,
    const int* __restrict__ lastD, const int* __restrict__ lastI,
    uint8_t* __restrict__ script, int* __restrict__ nedit, int B, int m_pad,
    int n_pad) {
  __shared__ __align__(16) TbStage stage_all[MAX_PER_BLOCK];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + wid;
  if (b >= B) return;  // whole warps only: nothing below syncs the block
  TbStage& S = stage_all[wid];
  const int mp1 = m_pad + 1, np1 = n_pad + 1, trip = m_pad + n_pad;
  const uint8_t* fl = flags + (size_t)b * mp1 * np1;
  const uint8_t* fend = flags + (size_t)B * mp1 * np1;
  const int* LB = LBv + (size_t)b * mp1;
  const int* RB = RBv + (size_t)b * mp1;
  uint8_t* out = script + (size_t)b * trip;
  const int M = __ldg(Mv + b), N = __ldg(Nv + b);
  // window w holds rows hi_w = top - w * TB_ROWS down to max(0, hi_w - 31)
  const int top = min(max(M, 0), m_pad);
  const int nwin = top / TB_ROWS + 1;

  // the band of this lane's row in the next window to stage
  int lbx = 0, rbx = 0;
  auto load_band = [&](int w) {
    const int rw = top - w * TB_ROWS - lane;
    if (w < nwin && rw >= 0) {
      lbx = __ldg(LB + rw);
      rbx = __ldg(RB + rw);
    }
  };
  // stage window w's rows into buffer w & 1, one row a lane
  auto stage_window = [&](int w) {
    const int rw = top - w * TB_ROWS - lane;
    if (w >= nwin || rw < 0) return;
    const int lo = max(lbx, 0), hi = min(rbx, n_pad);
    int cs = 0, nch = 0;
    uint8_t* slot = S.fl[w & 1] + lane * TB_SLOT;
    if (lo <= hi) {
      const uint8_t* row = fl + (size_t)rw * np1;
      const uint8_t* a16 =
          reinterpret_cast<const uint8_t*>((uintptr_t)(row + lo) & ~(uintptr_t)15);
      cs = lo - (int)((row + lo) - a16);
      nch = min(TB_SLOT / 16, (int)((row + hi + 1 - a16 + 15) >> 4));
      for (int i = 0; i < nch; ++i) {
        const uint8_t* src = a16 + 16 * i;
        if (src + 16 <= fend) {
          cp_async16(slot + 16 * i, src);
        } else {  // the flag store ends inside this chunk
          for (int k = 0; k < 16 && src + k < fend; ++k) slot[16 * i + k] = src[k];
        }
      }
    }
    S.info[w & 1][lane] = make_int4(lbx, rbx, cs, cs + 16 * nch - 1);
  };

  load_band(0);
  stage_window(0);
  cp_commit();
  load_band(1);
  stage_window(1);
  cp_commit();
  load_band(2);

  // the walk's state, kept on lane 0
  const int lc = __ldg(lastC + b), ld = __ldg(lastD + b), li = __ldg(lastI + b);
  int node = (lc >= ld && lc >= li) ? FLAG_C : ld >= li ? FLAG_D : FLAG_I;
  int row = M, col = N, k = 0;
  int kf = 0;  // script bytes written out

  for (int w = 0;; ++w) {
    const int cur = w & 1;
    const bool staged = w < nwin;
    const int hi = top - w * TB_ROWS, lo = max(0, hi - TB_ROWS + 1);
    const bool more = w + 1 < nwin;
    cp_wait_1();  // this window has landed (the next may be in flight)
    __syncwarp();
    // 0: the walk left the window for the next one; 1: the script stage is
    // full; 2: the walk has ended
    int stop = 0;
    for (;;) {
      if (lane == 0) {
        for (;;) {
          if (k >= trip || (row <= 0 && col <= 0)) {
            stop = 2;
            break;
          }
          if (k - kf == TB_SCRIPT) {
            stop = 1;
            break;
          }
          int ri = row < 0 ? row + mp1 : row;
          ri = min(max(ri, 0), m_pad);
          const int jc = min(max(col, 0), n_pad);
          int lbv, rbv, f;
          if (staged && ri >= lo && ri <= hi) {
            const int4 in = S.info[cur][hi - ri];
            lbv = in.x;
            rbv = in.y;
            f = 0;
            if (col >= lbv && col <= rbv)
              f = (jc >= in.z && jc <= in.w)
                      ? S.fl[cur][(hi - ri) * TB_SLOT + jc - in.z]
                      : fl[(size_t)ri * np1 + jc];
          } else {
            if (staged && ri < lo && more) {
              stop = 0;
              break;
            }
            // not staged: device memory; the load does not wait for the
            // band test, (ri, jc) is in the matrix
            f = fl[(size_t)ri * np1 + jc];
            lbv = LB[ri];
            rbv = RB[ri];
          }
          const int st = (col >= lbv && col <= rbv) ? f : 0;
          S.script[k - kf] = (uint8_t)node;
          ++k;
          const bool is_i = node == FLAG_I, is_d = node == FLAG_D;
          const int nnode = is_i ? st >> 4 : is_d ? (st >> 2) & 3 : st & 3;
          if (!is_i) --row;
          if (!is_d) --col;
          node = nnode;
        }
      }
      stop = __shfl_sync(FULL, stop, 0);
      k = __shfl_sync(FULL, k, 0);
      if (stop != 0) {  // the staged script out
        __syncwarp();
        for (int i = lane; i < k - kf; i += 32) out[kf + i] = S.script[i];
        __syncwarp();
        kf = k;
      }
      if (stop != 1) break;
    }
    if (stop == 2) break;
    __syncwarp();  // lane 0 is done with this window's buffer
    stage_window(w + 2);
    cp_commit();
    load_band(w + 3);
  }
  cp_wait_all();
  if (lane == 0) nedit[b] = k;
  fill_bytes(out + k, (size_t)(trip - k), 255, lane);  // past nedit
}

}  // namespace

// flags (B, m_pad+1, n_pad+1) uint8 and last (3, B) int32, both written in
// full. per_thread 0: the block path, whose scratch holds the column
// records, B * NREC * (n_pad+1) ints; per_thread 1..WARP_MAX_P: the warp
// path, P band lanes a thread, per_block problems a block, no scratch.
// ops/yama_full.py:full_plan picks both from the bucket's bands.
extern "C" int yama_full_dp_launch(
    const void* histA, const void* a0, const void* a1, const void* pa,
    const void* histB, const void* b0, const void* b1, const void* pb,
    const void* LB, const void* RB, const void* M, const void* N,
    const void* K, const void* L, const void* ss_cat, void* flags,
    void* last, void* scratch, int B, int m_pad, int n_pad, int go, int ge,
    int per_thread, int per_block, void* stream) {
  if (B <= 0 || m_pad < 0 || n_pad < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int* o[15] = {(const int*)histA, (const int*)a0, (const int*)a1,
                      (const int*)pa,    (const int*)histB, (const int*)b0,
                      (const int*)b1,    (const int*)pb,    (const int*)LB,
                      (const int*)RB,    (const int*)M,     (const int*)N,
                      (const int*)K,     (const int*)L,     (const int*)ss_cat};
  if (per_thread == 0) {
    if (!scratch) return (int)cudaErrorInvalidValue;
    yama_full_dp_block<<<B, THREADS, 0, st>>>(
        o[0], o[1], o[2], o[3], o[4], o[5], o[6], o[7], o[8], o[9], o[10],
        o[11], o[12], o[13], o[14], (uint8_t*)flags, (int*)last,
        (int*)scratch, B, m_pad, n_pad, go, ge);
    return (int)cudaGetLastError();
  }
  if (per_thread < 1 || per_thread > WARP_MAX_P || per_block < 1 ||
      per_block > MAX_PER_BLOCK)
    return (int)cudaErrorInvalidValue;
  auto kern = per_thread == 1   ? yama_full_dp_warp<1>
              : per_thread == 2 ? yama_full_dp_warp<2>
              : per_thread == 3 ? yama_full_dp_warp<3>
                                : yama_full_dp_warp<4>;
  kern<<<(B + per_block - 1) / per_block, 32 * per_block, 0, st>>>(
      o[0], o[1], o[2], o[3], o[4], o[5], o[6], o[7], o[8], o[9], o[10],
      o[11], o[12], o[13], o[14], (uint8_t*)flags, (int*)last, B, m_pad,
      n_pad, go, ge);
  return (int)cudaGetLastError();
}

// script (B, m_pad+n_pad) uint8 and nedit (B,) int32, both written in
// full; per_block walks a block. The flag store must be 16-byte aligned.
extern "C" int yama_full_tb_launch(const void* flags, const void* LB,
                                   const void* RB, const void* M,
                                   const void* N, const void* lastC,
                                   const void* lastD, const void* lastI,
                                   void* script, void* nedit, int B,
                                   int m_pad, int n_pad, int per_block,
                                   void* stream) {
  if (B <= 0 || m_pad < 0 || n_pad < 0 || per_block < 1 ||
      per_block > MAX_PER_BLOCK || ((uintptr_t)flags & 15))
    return (int)cudaErrorInvalidValue;
  yama_full_tb_kernel<<<(B + per_block - 1) / per_block, 32 * per_block, 0,
                        (cudaStream_t)stream>>>(
      (const uint8_t*)flags, (const int*)LB, (const int*)RB, (const int*)M,
      (const int*)N, (const int*)lastC, (const int*)lastD,
      (const int*)lastI, (uint8_t*)script, (int*)nedit, B, m_pad, n_pad);
  return (int)cudaGetLastError();
}
