// The five capability probes of experiments/mosaic_probe.py, one
// elementwise kernel each over a [rows, cols] plane (row-major, any
// shape):
//
//   probe_load16      k_load16:     int16 x          -> int32 x + 1
//   probe_store16     k_store16:    int32 x          -> int16 (x + 1), mod 2^16
//   probe_cmp16       k_cmp16:      int16 x, y       -> int32 (x > y)
//   probe_load8       k_load8:      int8 x           -> int32 2 x
//   probe_merge_core  k_merge_core: int8 status, int32 inc, int32 key,
//                                   int8 gate -> int16 status, int32 inc
//
// On the TPU they asked whether Mosaic lowers narrow-lane loads, stores
// and compares; here they are the same functions as CUDA kernels, and
// the narrow-int conversions they exercise are the ones the compact
// carry's codec and the int16-wire merge use on the main path.  Loads
// sign-extend (an int8 -1 widens to -1); the int32 add wraps (uint32);
// the int16 store keeps the low 16 bits, as astype(jnp.int16) does; the
// merge core shifts negative keys arithmetically before its key < 0
// select, as jnp's >> does.
//
// Bound: bytes.  Per element: load16 2 + 4 B, store16 4 + 2 B, cmp16
// 2 + 2 + 4 B, load8 1 + 4 B, merge core 1 + 4 + 4 + 1 in and 2 + 4 out;
// a few integer operations each.  At [512, 128] every probe is bound by
// its launch.  Design: one thread per element, consecutive threads on
// consecutive elements, scalar accesses.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ long long element() {
  return static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ int32_t add_wrap(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

__global__ void load16_kernel(const int16_t* __restrict__ x,
                              int32_t* __restrict__ out, long long n) {
  const long long i = element();
  if (i < n) out[i] = static_cast<int32_t>(x[i]) + 1;
}

__global__ void store16_kernel(const int32_t* __restrict__ x,
                               int16_t* __restrict__ out, long long n) {
  const long long i = element();
  if (i < n) {
    out[i] = static_cast<int16_t>(
        static_cast<uint16_t>(static_cast<uint32_t>(add_wrap(x[i], 1))));
  }
}

__global__ void cmp16_kernel(const int16_t* __restrict__ x,
                             const int16_t* __restrict__ y,
                             int32_t* __restrict__ out, long long n) {
  const long long i = element();
  if (i < n) out[i] = x[i] > y[i] ? 1 : 0;
}

__global__ void load8_kernel(const int8_t* __restrict__ x,
                             int32_t* __restrict__ out, long long n) {
  const long long i = element();
  if (i < n) out[i] = static_cast<int32_t>(x[i]) * 2;
}

__global__ void merge_core_kernel(const int8_t* __restrict__ status,
                                  const int32_t* __restrict__ inc,
                                  const int32_t* __restrict__ key,
                                  const int8_t* __restrict__ gate,
                                  int16_t* __restrict__ status_out,
                                  int32_t* __restrict__ inc_out, long long n) {
  const long long i = element();
  if (i >= n) return;
  const int32_t st = static_cast<int32_t>(status[i]);
  const int32_t in = inc[i];
  const int32_t k = key[i];
  // Arithmetic shifts of a negative key first, the key < 0 select after.
  const int32_t shifted_inc = (k >> 1) & ((1 << 29) - 1);
  const int32_t win_dead = (k >> 30) & 1;
  const int32_t win_inc = k < 0 ? 0 : shifted_inc;
  int32_t win_status = win_dead == 1 ? 2 : ((k & 1) == 1 ? 1 : 0);
  if (k < 0) win_status = 3;
  const bool accepts =
      ((win_inc > in) || (win_inc == in && win_status > st)) &&
      static_cast<int32_t>(gate[i]) > 0;
  status_out[i] = static_cast<int16_t>(accepts ? win_status : st);
  inc_out[i] = accepts ? win_inc : in;
}

unsigned int blocks_for(long long n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

int finish() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

// Each launches on `stream` over `n` elements and returns the launch's
// cudaError_t (0 = success).
extern "C" int probe_load16_launch(const void* x, void* out, long long n,
                                   void* stream) {
  if (n == 0) return 0;
  load16_kernel<<<blocks_for(n), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(x), static_cast<int32_t*>(out), n);
  return finish();
}

extern "C" int probe_store16_launch(const void* x, void* out, long long n,
                                    void* stream) {
  if (n == 0) return 0;
  store16_kernel<<<blocks_for(n), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<int16_t*>(out), n);
  return finish();
}

extern "C" int probe_cmp16_launch(const void* x, const void* y, void* out,
                                  long long n, void* stream) {
  if (n == 0) return 0;
  cmp16_kernel<<<blocks_for(n), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(x), static_cast<const int16_t*>(y),
      static_cast<int32_t*>(out), n);
  return finish();
}

extern "C" int probe_load8_launch(const void* x, void* out, long long n,
                                  void* stream) {
  if (n == 0) return 0;
  load8_kernel<<<blocks_for(n), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<int32_t*>(out), n);
  return finish();
}

extern "C" int probe_merge_core_launch(const void* status, const void* inc,
                                       const void* key, const void* gate,
                                       void* status_out, void* inc_out,
                                       long long n, void* stream) {
  if (n == 0) return 0;
  merge_core_kernel<<<blocks_for(n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(status), static_cast<const int32_t*>(inc),
      static_cast<const int32_t*>(key), static_cast<const int8_t*>(gate),
      static_cast<int16_t*>(status_out), static_cast<int32_t*>(inc_out), n);
  return finish();
}
