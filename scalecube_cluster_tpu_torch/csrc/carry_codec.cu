// carry_decode / carry_encode: the compact carry's codec, one launch each
// over the [N, K] planes of a round.
//
// The reference computes them as XLA fusions, not Pallas kernels:
// models/swim._carry_decode (compact -> wide at the round's start) and
// models/swim._carry_encode (wide -> compact at its end).  In eager
// PyTorch each would split into some fifteen full-plane passes, so the
// port writes each as one kernel.  The conversions follow the patterns
// the TPU probes in experiments/mosaic_probe.py tested: int16 and int8
// loads sign-extended to int32 (stale deadlines are negative), and int32
// values narrowed to int16/int8 on store.
//
//   decode: inc      int16 -> int32
//           spread   int8 rounds remaining   -> round_idx + spread
//           deadline int16 rounds remaining  -> round_idx + deadline,
//                    the sentinel 32767      -> INT32_MAX (no timer)
//   encode, relative to nxt = round_idx + 1:
//           inc      min(inc, inc_sat) -> int16
//           spread   clip(spread - nxt, 0, 127) -> int8
//           deadline INT32_MAX or more than 32766 ahead -> 32767,
//                    else clip(deadline - nxt, -32766, 32766) -> int16
//
// Block form (the reference's K-tiled capacity round, models/swim.py
// _tick_shift_blocked, decodes and encodes one [N, Kb] column block of
// the carry at a time): each side's three planes are passed as pointers
// to the block's first element and one row stride in elements, shared by
// the three (ld_in for the inputs, ld_out for the outputs), so cell
// (row, col) is element row * ld + col.  decode reads a column view of
// the compact carry (ld_in = K) into a contiguous wide block (ld_out =
// Kb); encode writes a contiguous wide block into a column view of the
// output carry.  The unblocked round passes Kb = K, ld_in = ld_out = K.
//
// Bound: bytes.  decode reads 5 B and writes 12 B a cell, encode reads 12 B
// and writes 5 B: at N = 1,000,000, K = 16, 272,000,000 B each, 0.081 ms
// at the H100's 3.35 TB/s, against a handful of integer operations a
// cell.  Design: one thread per cell, consecutive threads on consecutive
// cells of a row, scalar loads (an int16 [N, 16] row is 32 B, so no wider
// vector access is assumed).  int32 arithmetic wraps as in the reference (uint32
// adds); narrowing casts go through the unsigned type, which is defined
// modulo 2^16 / 2^8.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kNoTimer = 2147483647;  // INT32_MAX
constexpr int32_t kDeadlineNone16 = 32767;

__device__ __forceinline__ int32_t add_wrap(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t sub_wrap(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t clip(int32_t v, int32_t lo, int32_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void carry_decode_kernel(const int16_t* __restrict__ inc16,
                                    const int8_t* __restrict__ spread8,
                                    const int16_t* __restrict__ deadline16,
                                    int32_t* __restrict__ inc,
                                    int32_t* __restrict__ spread,
                                    int32_t* __restrict__ deadline,
                                    long long n_cells, int cols,
                                    long long ld_in, long long ld_out,
                                    int32_t round_idx) {
  const long long cell =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (cell >= n_cells) return;
  const long long row = cell / cols;
  const long long col = cell - row * cols;
  const long long src = row * ld_in + col;
  const long long dst = row * ld_out + col;
  inc[dst] = static_cast<int32_t>(inc16[src]);
  spread[dst] = add_wrap(round_idx, static_cast<int32_t>(spread8[src]));
  const int32_t dl = static_cast<int32_t>(deadline16[src]);
  deadline[dst] = dl == kDeadlineNone16 ? kNoTimer : add_wrap(round_idx, dl);
}

__global__ void carry_encode_kernel(const int32_t* __restrict__ inc,
                                    const int32_t* __restrict__ spread,
                                    const int32_t* __restrict__ deadline,
                                    int16_t* __restrict__ inc16,
                                    int8_t* __restrict__ spread8,
                                    int16_t* __restrict__ deadline16,
                                    long long n_cells, int cols,
                                    long long ld_in, long long ld_out,
                                    int32_t round_idx, int32_t inc_sat) {
  const long long cell =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (cell >= n_cells) return;
  const long long row = cell / cols;
  const long long col = cell - row * cols;
  const long long src = row * ld_in + col;
  const long long dst = row * ld_out + col;
  const int32_t nxt = add_wrap(round_idx, 1);
  const int32_t v = inc[src] < inc_sat ? inc[src] : inc_sat;
  inc16[dst] = static_cast<int16_t>(
      static_cast<uint16_t>(static_cast<uint32_t>(v)));
  spread8[dst] =
      static_cast<int8_t>(clip(sub_wrap(spread[src], nxt), 0, 127));
  const int32_t dl = deadline[src];
  const int32_t remaining = sub_wrap(dl, nxt);
  const int32_t out =
      (dl == kNoTimer || remaining > kDeadlineNone16 - 1)
          ? kDeadlineNone16
          : clip(remaining, -(kDeadlineNone16 - 1), kDeadlineNone16 - 1);
  deadline16[dst] = static_cast<int16_t>(out);
}

constexpr int kThreads = 256;

unsigned int blocks_for(long long n_cells) {
  return static_cast<unsigned int>((n_cells + kThreads - 1) / kThreads);
}

}  // namespace

// Each launches on `stream` over n_rows x cols cells and returns the
// launch's cudaError_t (0 = success).
extern "C" int carry_decode_launch(const void* inc16, const void* spread8,
                                   const void* deadline16, void* inc,
                                   void* spread, void* deadline,
                                   long long n_rows, int cols,
                                   long long ld_in, long long ld_out,
                                   int round_idx, void* stream) {
  const long long n_cells = n_rows * cols;
  if (n_cells == 0) return static_cast<int>(cudaSuccess);
  carry_decode_kernel<<<blocks_for(n_cells), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(inc16), static_cast<const int8_t*>(spread8),
      static_cast<const int16_t*>(deadline16), static_cast<int32_t*>(inc),
      static_cast<int32_t*>(spread), static_cast<int32_t*>(deadline), n_cells,
      cols, ld_in, ld_out, round_idx);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int carry_encode_launch(const void* inc, const void* spread,
                                   const void* deadline, void* inc16,
                                   void* spread8, void* deadline16,
                                   long long n_rows, int cols,
                                   long long ld_in, long long ld_out,
                                   int round_idx, int inc_sat, void* stream) {
  const long long n_cells = n_rows * cols;
  if (n_cells == 0) return static_cast<int>(cudaSuccess);
  carry_encode_kernel<<<blocks_for(n_cells), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(inc), static_cast<const int32_t*>(spread),
      static_cast<const int32_t*>(deadline), static_cast<int16_t*>(inc16),
      static_cast<int8_t*>(spread8), static_cast<int16_t*>(deadline16),
      n_cells, cols, ld_in, ld_out, round_idx, inc_sat);
  return static_cast<int>(cudaGetLastError());
}
