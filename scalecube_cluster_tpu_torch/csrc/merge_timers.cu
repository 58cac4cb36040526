// merge_and_timers: inbox merge, self-refutation, suspicion timers, crash
// freeze and spread reset of one SWIM round, on [N, K] planes.
//
// Replaces the TPU kernel experiments/merge_kernel_bench.py::kernel
// (launched by pallas_step through pl.pallas_call).  Written from the
// reference's models/swim._merge_and_timers + ops/delivery.merge_inbox at
// the port's settings (wide int32 wire key, no epoch lane, no
// dead-member suppression, no Lifeguard scaling), not from that
// prototype: suspicion and spread lengths are arguments, the refutation
// bump clamps at inc_sat, and the self cell's `changed` follows the
// reference's self-cell rule.
//
// Bound: bytes.  Per cell it reads status (1 B), inc, spread_until,
// suspect_deadline, inbox (4 B each) and inbox_alive (1 B) and writes
// status (1 B) plus three int32 planes; per row it reads self_inc,
// alive_here, slot_of_node (9 B) and writes self_inc, refuted (5 B).  At
// N = 1,000,000, K = 16 that is 297,000,000 B read + 213,000,000 B
// written = 510,000,000 B, i.e. 0.152 ms at the H100's 3.35 TB/s, against
// a few dozen integer operations per cell — far below the card's
// arithmetic rate.
//
// Design: one streaming pass, one thread per cell, consecutive threads
// on consecutive cells of the row-major planes (coalesced along K).  No
// intermediate touches device memory.  Subject ids are distinct, so a row
// has at most one self cell; that cell's thread owns the row's
// refutation and writes self_inc and refuted.  A row without a self cell
// (slot_of_node = -1) has them written by its column-0 thread.  All
// arithmetic is int32 with two's-complement wrap, as in the reference.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kAlive = 0;
constexpr int kSuspect = 1;
constexpr int kDead = 2;
constexpr int kAbsent = 3;
constexpr int32_t kNoTimer = 2147483647;  // INT32_MAX: no suspicion timer
constexpr int kDeadBit = 30;              // wide wire key
constexpr int32_t kIncMask = (1 << 29) - 1;

__device__ __forceinline__ int32_t add_wrap(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

// records.merge_key: (dead << 30) | (min(inc, 2^29-1) << 1) | suspect.
__device__ __forceinline__ int32_t pack_key(int status, int32_t inc) {
  if (status == kAbsent) return -1;
  const int32_t sat = inc < kIncMask ? inc : kIncMask;
  return (static_cast<int32_t>(status == kDead) << kDeadBit) | (sat << 1) |
         static_cast<int32_t>(status == kSuspect);
}

__global__ void merge_and_timers_kernel(
    const int8_t* __restrict__ status, const int32_t* __restrict__ inc,
    const int32_t* __restrict__ spread, const int32_t* __restrict__ deadline,
    const int32_t* __restrict__ inbox, const uint8_t* __restrict__ inbox_alive,
    const int32_t* __restrict__ self_inc, const uint8_t* __restrict__ alive_here,
    const int32_t* __restrict__ slot_of_node,
    int8_t* __restrict__ status_out, int32_t* __restrict__ inc_out,
    int32_t* __restrict__ spread_out, int32_t* __restrict__ deadline_out,
    int32_t* __restrict__ self_inc_out, uint8_t* __restrict__ refuted_out,
    long long n_cells, int k, int32_t round_idx, int32_t suspicion_rounds,
    int32_t periods_to_spread, int32_t inc_sat) {
  const long long cell =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (cell >= n_cells) return;
  const long long row = cell / k;
  const int col = static_cast<int>(cell - row * k);

  const int st = status[cell];
  const int32_t in = inc[cell];
  const int32_t dl_old = deadline[cell];
  const int32_t key = inbox[cell];
  const bool alive = alive_here[row] != 0;
  const int32_t my_inc = self_inc[row];
  const int slot = slot_of_node[row];
  const bool is_self = slot == col;

  // Unpack the round's folded winner key; keys < 0 are "no message".
  int win_status = kAbsent;
  int32_t win_inc = 0;
  if (key >= 0) {
    win_status = ((key >> kDeadBit) & 1) ? kDead : ((key & 1) ? kSuspect : kAlive);
    win_inc = (key >> 1) & kIncMask;
  }

  // merge_inbox: a stored DEAD gates like ABSENT; ABSENT opens only for
  // an ALIVE arrival; a live entry takes a strictly higher key.
  const int gate = st == kDead ? kAbsent : st;
  const bool accepts = gate == kAbsent
                           ? (inbox_alive[cell] != 0 && key >= 0)
                           : key > pack_key(gate, in);
  int ns = accepts ? win_status : st;
  int32_t ni = accepts ? win_inc : in;
  bool changed = accepts && (ns != st || ni != in);

  // Self-refutation: is_overrides(winner, ALIVE@self_inc) on the self cell.
  bool self_ov = false;
  int32_t new_self = my_inc;
  if (is_self) {
    if (win_status == kDead) {
      self_ov = true;
    } else if (win_status != kAbsent) {
      self_ov = win_inc == my_inc ? win_status == kSuspect : win_inc > my_inc;
    }
    const int32_t row_max = self_ov ? win_inc : 0;
    int32_t bumped = add_wrap(my_inc > row_max ? my_inc : row_max, 1);
    bumped = bumped < inc_sat ? bumped : inc_sat;
    if (self_ov && alive) new_self = bumped;
    ns = kAlive;
    ni = new_self;
    changed = self_ov && alive;
  }

  // Suspicion timers: an accepted SUSPECT arms a timer only if none is
  // pending; any accepted non-SUSPECT cancels; a due timer fires DEAD.
  int32_t dl = dl_old;
  if (changed && ns == kSuspect && dl_old == kNoTimer) {
    dl = add_wrap(round_idx, suspicion_rounds);
  } else if (changed && ns != kSuspect) {
    dl = kNoTimer;
  }
  if (ns == kSuspect && round_idx >= dl) {
    ns = kDead;
    dl = kNoTimer;
    changed = true;
  }

  // Crashed or departed rows are frozen.
  if (!alive) {
    ns = st;
    ni = in;
    dl = dl_old;
    changed = false;
  }

  status_out[cell] = static_cast<int8_t>(ns);
  inc_out[cell] = ni;
  deadline_out[cell] = dl;
  spread_out[cell] = changed ? add_wrap(add_wrap(round_idx, 1), periods_to_spread)
                             : spread[cell];
  if (is_self) {
    self_inc_out[row] = new_self;
    refuted_out[row] = self_ov ? 1 : 0;
  } else if (col == 0 && (slot < 0 || slot >= k)) {
    self_inc_out[row] = my_inc;
    refuted_out[row] = 0;
  }
}

}  // namespace

// Launches on `stream` and returns the launch's cudaError_t (0 = success).
extern "C" int merge_and_timers_launch(
    const void* status, const void* inc, const void* spread,
    const void* deadline, const void* inbox, const void* inbox_alive,
    const void* self_inc, const void* alive_here, const void* slot_of_node,
    void* status_out, void* inc_out, void* spread_out, void* deadline_out,
    void* self_inc_out, void* refuted_out, long long n, int k, int round_idx,
    int suspicion_rounds, int periods_to_spread, int inc_sat, void* stream) {
  const long long n_cells = n * static_cast<long long>(k);
  if (n_cells == 0) return static_cast<int>(cudaSuccess);
  constexpr int kThreads = 256;
  const long long blocks = (n_cells + kThreads - 1) / kThreads;
  merge_and_timers_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(status), static_cast<const int32_t*>(inc),
      static_cast<const int32_t*>(spread), static_cast<const int32_t*>(deadline),
      static_cast<const int32_t*>(inbox), static_cast<const uint8_t*>(inbox_alive),
      static_cast<const int32_t*>(self_inc), static_cast<const uint8_t*>(alive_here),
      static_cast<const int32_t*>(slot_of_node), static_cast<int8_t*>(status_out),
      static_cast<int32_t*>(inc_out), static_cast<int32_t*>(spread_out),
      static_cast<int32_t*>(deadline_out), static_cast<int32_t*>(self_inc_out),
      static_cast<uint8_t*>(refuted_out), n_cells, k, round_idx,
      suspicion_rounds, periods_to_spread, inc_sat);
  return static_cast<int>(cudaGetLastError());
}
