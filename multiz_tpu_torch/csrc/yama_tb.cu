// yama traceback on Hopper.
//
// Replaces multiz_tpu/ops/yama_pack.py:_tb_kernel (launched by
// _pallas_traceback): each walk starts at (M, N) on the node the last
// row's C/D/I pick (C, then D, preferred; yama_pack.py:605-608), follows
// the 2-bit pointers of the flag store written by csrc/yama_dp.cu to
// (0, 0), and writes the payload of multiz_tpu/ops/yama_pack.py:_db_core
// in place: [nedit LE32], then the ops 4 per byte, newest first. The
// plain version is multiz_tpu_torch/ops/yama_tb.py:traceback_reference.
//
// Design. One thread per walk, reading the flag store straight from
// device memory (the TPU kernel streamed row windows through VMEM; here
// the flags of a bucket sit in the 50 MB L2 or HBM and need no staging).
// Flags are band-local: the flag of (row, col) is at lane col - LB[row]
// of row `row`, and reads outside the stored lanes give 0, as the
// reference's zero-initialised matrix does.
//
// Bound. A walk is a chain of dependent loads (the flag decides the next
// address), so one walk is latency-bound; throughput comes from many
// walks in flight, spread over many small blocks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FLAG_C = 0, FLAG_I = 1, FLAG_D = 2;
constexpr int TB_THREADS = 32;

__global__ void yama_tb_kernel(const uint8_t* __restrict__ flags,
                               const int* __restrict__ lb_all,
                               const int* __restrict__ mnkl,
                               const int* __restrict__ last,
                               uint8_t* __restrict__ payload, int B, int mp1,
                               int fw, int pw) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const uint8_t* fl = flags + (size_t)b * mp1 * fw;
  const int* LB = lb_all + (size_t)b * mp1;
  uint8_t* out = payload + (size_t)b * pw;
  uint8_t* ops = out + 4;
  const int cap = 4 * (pw - 4);

  const int lc = last[3 * b + 0], ld = last[3 * b + 1], li = last[3 * b + 2];
  int node = (lc >= ld && lc >= li) ? FLAG_C : (ld >= li ? FLAG_D : FLAG_I);
  int row = mnkl[4 * b + 0], col = mnkl[4 * b + 1];
  int k = 0;
  unsigned acc = 0;
  while (row >= 0 && (row > 0 || col > 0) && k < cap) {
    const int jj = col - LB[row];
    const int st = (jj >= 0 && jj < fw) ? fl[(size_t)row * fw + jj] : 0;
    acc |= (unsigned)node << (2 * (k & 3));
    if ((k & 3) == 3) {
      ops[k >> 2] = (uint8_t)acc;
      acc = 0;
    }
    ++k;
    if (node == FLAG_I) {
      col -= 1;
      node = st >> 4;
    } else if (node == FLAG_D) {
      row -= 1;
      node = (st >> 2) & 3;
    } else {
      row -= 1;
      col -= 1;
      node = st & 3;
    }
  }
  if (k & 3) ops[k >> 2] = (uint8_t)acc;
  *reinterpret_cast<unsigned*>(out) = (unsigned)k;  // pw % 4 == 0
}

}  // namespace

// payload must be zeroed by the caller (only the written ops are stored).
extern "C" int yama_tb_launch(const void* flags, const void* lb,
                              const void* mnkl, const void* last,
                              void* payload, int B, int mp1, int fw, int pw,
                              void* stream) {
  if (B <= 0 || fw < 1 || pw < 4 || pw % 4) return (int)cudaErrorInvalidValue;
  const int grid = (B + TB_THREADS - 1) / TB_THREADS;
  yama_tb_kernel<<<grid, TB_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)flags, (const int*)lb, (const int*)mnkl,
      (const int*)last, (uint8_t*)payload, B, mp1, fw, pw);
  return (int)cudaGetLastError();
}
