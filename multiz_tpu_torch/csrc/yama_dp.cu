// Banded yama DP forward on Hopper.
//
// Replaces multiz_tpu/ops/yama_pack.py:_kernel (launched by _pallas_dp):
// for every problem of a bucket, the C/D/I recurrence of mz_yama.c:97-254
// over the band of each row, a flag byte c | d<<2 | i<<4 per band cell,
// and C/D/I at (M, N). The plain version is
// multiz_tpu_torch/ops/yama_dp.py:dp_forward_reference; both read the
// operands built by ops/prep.py and must agree bit for bit.
//
// Design. One thread block per problem, one thread per lane of the band
// window; lane j of row r is dp column LB[r] + j (band-local, so no lane
// is spent outside the widest band). Rows run in a loop inside the block
// (the TPU kernel's sequential grid carry). The previous row's C/D/I live
// in shared memory, double-buffered; the D and C nodes read it at the
// lane shifted by LB[r] - LB[r-1] (and one more for the diagonal), with
// MININT outside the previous row's band, as the reference's rolling
// row reads it. The in-row I chain is the prefix-max form of
// multiz_tpu/ops/yama_jax.py: one block-wide inclusive max-scan per row
// (warp shuffles, then one pass over the warp totals in shared memory).
//
// Bound. Each row is a chain of dependent steps (loads, the scan, three
// __syncthreads) over at most a few warps; the card's throughput comes
// from running many problems (blocks) at once, not from one block. The
// kernel reads 14 column statistics per cell (L1/L2 resident) and
// writes one byte per cell, so it is latency-bound, far from both the
// memory and the ALU roofline.
//
// Arithmetic is int32 and wraps like the JAX code's: every add, sub and
// mul goes through unsigned, where C++ defines the wrap.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MININT = -(1 << 30);
constexpr int NEG_HUGE = -(1 << 30) - (1 << 29);
constexpr int FLAG_C = 0, FLAG_I = 1, FLAG_D = 2;
constexpr int MAX_LANES = 1024;

// astat slots and bstat rows, as in multiz_tpu_torch/ops/prep.py
enum { AS_A0, AS_A1, AS_PA0, AS_PA1, AS_PA2, AS_PA3, AS_H0, NASTAT = 12 };
enum {
  BS_B0, BS_B1, BS_PB0, BS_PB1, BS_PB2, BS_PB3, BS_SR0,
  BS_S1 = 12, BS_S2 = 13, NBSTAT = 14
};

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}
__device__ __forceinline__ int wmul(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}

// C >= D > I preference (mz_yama.c:138-154)
__device__ __forceinline__ int pick3(int x, int y, int z, int* flag) {
  const bool pc = (x >= y) && (x >= z);
  const bool pd = !pc && (y > z);
  *flag = pc ? FLAG_C : (pd ? FLAG_D : FLAG_I);
  return pc ? x : (pd ? y : z);
}

// Block-wide inclusive max-scan. Returns the scan at this lane; *prev gets
// the scan at the lane before (NEG_HUGE at lane 0). Synchronises the block.
__device__ __forceinline__ int block_max_scan(int v, int* prev, int* wtot) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, v, s);
    if (lane >= s) v = max(v, o);
  }
  if (lane == 31) wtot[wid] = v;
  __syncthreads();
  if (wid == 0) {
    int t = lane < nw ? wtot[lane] : INT32_MIN;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, t, s);
      if (lane >= s) t = max(t, o);
    }
    if (lane < nw) wtot[lane] = t;
  }
  __syncthreads();
  const int carry = wid > 0 ? wtot[wid - 1] : INT32_MIN;
  v = max(v, carry);
  const int up = __shfl_up_sync(0xffffffffu, v, 1);
  *prev = lane > 0 ? up : (wid > 0 ? carry : NEG_HUGE);
  return v;
}

__global__ void __launch_bounds__(MAX_LANES)
yama_dp_kernel(const int* __restrict__ lb_all, const int* __restrict__ rb_all,
               const int* __restrict__ mnkl, const int* __restrict__ astat,
               const int* __restrict__ bstat, uint8_t* __restrict__ flags,
               int* __restrict__ last, int mp1, int nb, int fw, int go,
               int ge) {
  __shared__ int sC[2][MAX_LANES];
  __shared__ int sD[2][MAX_LANES];
  __shared__ int sI[2][MAX_LANES];
  __shared__ int wtot[32];

  const int b = blockIdx.x;
  const int j = threadIdx.x;
  const int nl = blockDim.x;
  const int* LB = lb_all + (size_t)b * mp1;
  const int* RB = rb_all + (size_t)b * mp1;
  const int M = mnkl[4 * b + 0], N = mnkl[4 * b + 1];
  const int K = mnkl[4 * b + 2], L = mnkl[4 * b + 3];
  const int* bs = bstat + (size_t)b * NBSTAT * nb;
  const int* as = astat + (size_t)b * mp1 * NASTAT;
  uint8_t* fl = flags + (size_t)b * mp1 * fw;

  // ---- row 0 (mz_yama.c:82-94): LB[0] = 0, the I chain is -S2 ----
  {
    const int rb0 = RB[0];
    const bool in0 = j <= rb0;
    const int c0 = j == 0 ? 0 : MININT;
    const int i0 = j == 0 ? 0 : (in0 ? wsub(0, bs[BS_S2 * nb + j]) : MININT);
    sC[0][j] = c0;
    sD[0][j] = c0;
    sI[0][j] = i0;
    if (j < fw) fl[j] = (j >= 1 && in0) ? (uint8_t)(FLAG_I << 4) : 0;
    if (M == 0 && j == N) {
      last[3 * b + 0] = c0;
      last[3 * b + 1] = c0;
      last[3 * b + 2] = i0;
    }
  }
  __syncthreads();

  int p = 0;  // buffer holding the previous row
  for (int r = 1; r <= M; ++r) {
    const int lbr = LB[r], rbr = RB[r];
    const int lbm1 = LB[r - 1];
    const int lbm2 = r >= 2 ? LB[r - 2] : LB[0];
    const int* ar = as + (size_t)r * NASTAT;
    const int a0 = ar[AS_A0], a1 = ar[AS_A1];
    const int pa0 = ar[AS_PA0], pa1 = ar[AS_PA1];
    const int pa2 = ar[AS_PA2], pa3 = ar[AS_PA3];
    const bool not1 = r > 1;
    const bool live = r < M;

    const int col = lbr + j;
    const bool in_band = col <= rbr;
    const int cc = in_band ? col : lbr;  // a safe column for the loads
    const int b0w = bs[BS_B0 * nb + cc], b1w = bs[BS_B1 * nb + cc];
    const int pb0w = bs[BS_PB0 * nb + cc], pb1w = bs[BS_PB1 * nb + cc];
    const int pb2w = bs[BS_PB2 * nb + cc], pb3w = bs[BS_PB3 * nb + cc];
    const bool inner = col > 0 && col < N;
    const bool gt1 = col > 1;

    // previous row, band-local from LB[r-1]: MININT outside its band
    const int s = lbr - lbm1;
    const int iu = j + s, idg = j + s - 1;
    const int* pC = sC[p];
    const int* pD = sD[p];
    const int* pI = sI[p];
    const int upC = iu < nl ? pC[iu] : MININT;
    const int upD = iu < nl ? pD[iu] : MININT;
    const int upI = iu < nl ? pI[iu] : MININT;
    const bool dok = idg >= 0 && idg < nl;
    const int dgC = dok ? pC[idg] : MININT;
    const int dgD = dok ? pD[idg] : MININT;
    const int dgI = dok ? pI[idg] : MININT;

    // ---- D node ----
    const int eD = wmul(wmul(a0, L), ge);
    const int xD = wadd((inner && col > lbm2 && not1)
                            ? wmul(go, wadd(wmul(pa0, b0w), wmul(pa2, L)))
                            : 0,
                        eD);
    const int yD = wadd((inner && not1) ? wmul(wmul(go, pa2), L) : 0, eD);
    const int zD = wadd((inner && col > lbm1) ? wmul(wmul(go, a0), L) : 0, eD);
    int fd;
    const int Dn = pick3(wsub(upC, xD), wsub(upD, yD), wsub(upI, zD), &fd);
    const int D_row = in_band ? Dn : MININT;

    // ---- C node ----
    int subw = 0;
#pragma unroll
    for (int k = 0; k < 6; ++k)
      subw = wadd(subw, wmul(ar[AS_H0 + k], bs[(BS_SR0 + k) * nb + cc]));
    const int xC =
        (gt1 && col > lbm2 + 1 && not1)
            ? wmul(go, wadd(wadd(wmul(pa0, pb1w), wmul(pa1, wadd(pb0w, pb2w))),
                            wadd(wmul(pa2, wadd(pb1w, pb3w)), wmul(pa3, pb2w))))
            : 0;
    const int yC = (gt1 && not1)
                       ? wmul(go, wadd(wmul(wadd(pa1, pa3), b0w), wmul(pa2, b1w)))
                       : 0;
    const int zC = (gt1 && col > lbm1 + 1)
                       ? wmul(go, wadd(wmul(a0, wadd(pb1w, pb3w)), wmul(a1, pb2w)))
                       : 0;
    int fc;
    const int Cn = pick3(wsub(dgC, xC), wsub(dgD, yC), wsub(dgI, zC), &fc);
    const bool maskC = in_band && col > lbm1;
    const int C_row = maskC ? wadd(Cn, subw) : MININT;
    if (!maskC) fc = 0;

    const int q = p ^ 1;
    sC[q][j] = C_row;
    sD[q][j] = D_row;
    __syncthreads();

    // ---- I node: prefix-max chain rebased at lb+1 ----
    const int xI = (live && col > lbm1 + 1)
                       ? wmul(go, wadd(wmul(a0, wadd(pb0w, pb2w)), wmul(a1, pb2w)))
                       : 0;
    const int yI = live ? wmul(wmul(go, K), b0w) : 0;
    const int e = wmul(wmul(b0w, K), ge);
    const int xv = wsub(j > 0 ? sC[q][j - 1] : MININT, xI);
    const int yv = wsub(j > 0 ? sD[q][j - 1] : MININT, yI);
    int Pofs = 0;
    if (j >= 1 && in_band) {
      const int lb1 = lbr + 1;
      const int srow = live ? BS_S1 : BS_S2;
      const int e_lb1 = wmul(wmul(bs[BS_B0 * nb + lb1], K), ge);
      Pofs = wadd(wsub(bs[srow * nb + col], bs[srow * nb + lb1]), e_lb1);
    }
    const bool from_y = xv < yv;
    const int V = wadd(wsub(max(xv, yv), e), Pofs);
    const int Vp = (j == 0 || !in_band) ? MININT : V;
    int Wprev;
    const int R = block_max_scan(Vp, &Wprev, wtot);
    const bool zwin = (Wprev > V) || (Wprev == V && from_y);
    const int fi = j == 0 ? 0 : (zwin ? FLAG_I : (from_y ? FLAG_D : FLAG_C));
    const int I_row = (in_band && j >= 1) ? wsub(R, Pofs) : MININT;
    sI[q][j] = I_row;

    if (j < fw)
      fl[(size_t)r * fw + j] =
          in_band ? (uint8_t)(fc | (fd << 2) | (fi << 4)) : (uint8_t)0;
    if (r == M && col == N) {
      last[3 * b + 0] = C_row;
      last[3 * b + 1] = D_row;
      last[3 * b + 2] = I_row;
    }
    p = q;
    __syncthreads();
  }
}

}  // namespace

// flags must be zeroed by the caller (rows beyond M are not written).
extern "C" int yama_dp_launch(const void* lb, const void* rb, const void* mnkl,
                              const void* astat, const void* bstat, void* flags,
                              void* last, int B, int mp1, int nb, int fw,
                              int go, int ge, void* stream) {
  const int lanes = (fw + 31) / 32 * 32;
  if (B <= 0 || fw < 1 || lanes > MAX_LANES) return (int)cudaErrorInvalidValue;
  yama_dp_kernel<<<B, lanes, 0, (cudaStream_t)stream>>>(
      (const int*)lb, (const int*)rb, (const int*)mnkl, (const int*)astat,
      (const int*)bstat, (uint8_t*)flags, (int*)last, mp1, nb, fw, go, ge);
  return (int)cudaGetLastError();
}
