// merge_and_timers: inbox merge, self-refutation, suspicion timers, crash
// freeze and spread reset of one SWIM round, on [N, K] planes.
//
// Replaces the TPU kernel experiments/merge_kernel_bench.py::kernel
// (launched by pallas_step through pl.pallas_call).  Written from the
// reference's models/swim._merge_and_timers + ops/delivery.merge_inbox
// (no epoch lane), not from that prototype, which has neither plane
// branch: suspicion and spread lengths are arguments, the refutation bump
// clamps at inc_sat, and the self cell's `changed` follows the
// reference's self-cell rule.
//
// Two plane branches, both off with their default arguments:
//   armed_rounds (Lifeguard's LHA Suspicion): [N] int32, the rounds to
//     DEAD each row arms for a new SUSPECT entry; nullptr arms the scalar
//     suspicion_rounds everywhere.
//   dead_suppress_rounds (the dead-member suppression window), 0 = off: a
//     tombstone whose deadline lane holds an expiry still ahead gates by
//     its true DEAD key (no reopen for an ALIVE arrival); a DEAD cell
//     holds no suspicion timer; an accepted DEAD keeps its expiry; and
//     every cell that changed into DEAD arms the expiry round_idx +
//     dead_suppress_rounds.
//
// One template, three instances, one per rung of the wire-format ladder
// (ops/delivery.WIRE_FORMATS): the inbox key type and the dead bit; the
// incarnation field is bits 1..dead_bit-1.
//   wide    int32 key, dead bit 30  merge_and_timers_launch
//   wire16  int16 key, dead bit 14  merge_and_timers_wire16_launch
//   wire24  int32 key, dead bit 23  merge_and_timers_wire24_launch
// The int16 instance is the narrow-load pattern the TPU probes in
// experiments/mosaic_probe.py tested: an int16 load sign-extended to
// int32 (no message, -1, stays -1), all compares in int32.
//
// Bound: bytes.  Per cell it reads status (1 B), inc, spread_until,
// suspect_deadline (4 B each), the inbox key (4 B, or 2 B on the int16
// wire) and inbox_alive (1 B) and writes status (1 B) plus three int32
// planes; per row it reads self_inc, alive_here, slot_of_node (9 B, and
// armed_rounds, 4 B, with Lifeguard on) and writes self_inc, refuted
// (5 B).  At N = 1,000,000, K = 16 that is 297,000,000 B read
// (265,000,000 B on the int16 wire) + 213,000,000 B written, i.e. 0.152
// ms (0.143 ms) at the H100's 3.35 TB/s; with armed_rounds 514,000,000 B,
// 0.153 ms.  The suppression window adds no bytes.  A few dozen integer
// operations per cell are far below the card's arithmetic rate.  One
// [36,864 x 1,024] block of the capacity round moves 29 B a cell on the
// int16 wire, 0.33 ms.
//
// Design: one streaming pass, one thread per cell, on a 2-D grid: a
// block is tx columns by ty rows (tx the row length rounded up to a power
// of two, at most 256; tx * ty = 256), consecutive threads on consecutive
// cells of a row (coalesced along the columns), blockIdx.x over row
// tiles and blockIdx.y over column tiles, so no thread divides to find
// its row.  No intermediate touches device memory.  Each instance comes
// in two forms, chosen at launch: with the plane branches compiled out
// (no armed_rounds, window 0), so the plane-off round runs no code of
// them, and with them in.  Subject ids are distinct, so a row
// has at most one self cell; that cell's thread owns the row's
// refutation and writes self_inc and refuted.  A row without a self cell
// in the planes has them written by its column-0 thread (the row's
// self_inc unchanged, refuted 0).  All arithmetic is int32 with
// two's-complement wrap, as in the reference.
//
// Block form (the reference's K-tiled capacity round, models/swim.py
// _tick_shift_blocked): the planes are an [N, Kb] column block starting
// at column col0 of [N, K] planes.  Each of the ten planes is passed as a
// pointer to its block's first element and its own row stride (in
// elements), so cell (row, col) is element row * ld + col of that
// pointer: a carry plane's column view (ld = K), a block's own contiguous
// plane (ld = Kb).  A cell is a self cell where slot_of_node == col0 +
// col; a row whose self column lies outside [col0, col0 + Kb) gets its
// unchanged self_inc and refuted = 0, which the caller max- and
// or-accumulates over the blocks.  The unblocked round is the block
// col0 = 0, Kb = K, every ld = K.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kAlive = 0;
constexpr int kSuspect = 1;
constexpr int kDead = 2;
constexpr int kAbsent = 3;
constexpr int32_t kNoTimer = 2147483647;  // INT32_MAX: no suspicion timer

template <int kDeadBit>
__host__ __device__ constexpr int32_t inc_mask() {
  return (int32_t{1} << (kDeadBit - 1)) - 1;
}

__device__ __forceinline__ int32_t add_wrap(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

// ops/delivery.pack_record: (dead << kDeadBit) | (min(inc, mask) << 1) |
// suspect, e.g. records.merge_key at kDeadBit = 30.  The largest key
// fits the wire word of every instance (32767 at kDeadBit = 14).
template <int kDeadBit>
__device__ __forceinline__ int32_t pack_key(int status, int32_t inc) {
  if (status == kAbsent) return -1;
  constexpr int32_t kMask = inc_mask<kDeadBit>();
  const int32_t sat = inc < kMask ? inc : kMask;
  return (static_cast<int32_t>(status == kDead) << kDeadBit) | (sat << 1) |
         static_cast<int32_t>(status == kSuspect);
}

// Row strides, in elements, of the ten [N, Kb] planes.
struct RowStrides {
  long long status, inc, spread, deadline, inbox, inbox_alive;
  long long status_out, inc_out, spread_out, deadline_out;
};

template <typename KeyT, int kDeadBit, bool kPlanes>
__global__ void merge_and_timers_kernel(
    const int8_t* __restrict__ status, const int32_t* __restrict__ inc,
    const int32_t* __restrict__ spread, const int32_t* __restrict__ deadline,
    const KeyT* __restrict__ inbox, const uint8_t* __restrict__ inbox_alive,
    const int32_t* __restrict__ self_inc, const uint8_t* __restrict__ alive_here,
    const int32_t* __restrict__ slot_of_node,
    const int32_t* __restrict__ armed_rounds,
    int8_t* __restrict__ status_out, int32_t* __restrict__ inc_out,
    int32_t* __restrict__ spread_out, int32_t* __restrict__ deadline_out,
    int32_t* __restrict__ self_inc_out, uint8_t* __restrict__ refuted_out,
    long long n, int kb, int col0, RowStrides ld, int32_t round_idx,
    int32_t suspicion_rounds, int32_t periods_to_spread, int32_t inc_sat,
    int32_t dead_suppress_rounds) {
  const int col = static_cast<int>(blockIdx.y * blockDim.x + threadIdx.x);
  const long long row =
      static_cast<long long>(blockIdx.x) * blockDim.y + threadIdx.y;
  if (col >= kb || row >= n) return;

  const int st = status[row * ld.status + col];
  const int32_t in = inc[row * ld.inc + col];
  const int32_t dl_old = deadline[row * ld.deadline + col];
  // Sign-extending load: the int16 wire's "no message" widens to -1.
  const int32_t key = static_cast<int32_t>(inbox[row * ld.inbox + col]);
  const bool alive = alive_here[row] != 0;
  const int32_t my_inc = self_inc[row];
  const int slot = slot_of_node[row];
  const bool is_self = slot == col0 + col;

  // Unpack the round's folded winner key; keys < 0 are "no message".
  int win_status = kAbsent;
  int32_t win_inc = 0;
  if (key >= 0) {
    win_status = ((key >> kDeadBit) & 1) ? kDead : ((key & 1) ? kSuspect : kAlive);
    win_inc = (key >> 1) & inc_mask<kDeadBit>();
  }

  // merge_inbox: a stored DEAD gates like ABSENT; ABSENT opens only for
  // an ALIVE arrival; a live entry takes a strictly higher key.  Inside
  // its suppression window a tombstone gates by its true DEAD key.
  const bool suppress_on = kPlanes && dead_suppress_rounds > 0;
  const bool suppress = suppress_on && st == kDead && dl_old != kNoTimer &&
                        round_idx < dl_old;
  const int gate = st == kDead ? kAbsent : st;
  bool accepts = gate == kAbsent
                     ? (inbox_alive[row * ld.inbox_alive + col] != 0 &&
                        key >= 0)
                     : key > pack_key<kDeadBit>(gate, in);
  if (suppress) accepts = key > pack_key<kDeadBit>(kDead, in);
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
  // pending (with suppression on, a DEAD cell's lane holds an expiry, not
  // a timer); any accepted non-SUSPECT cancels (with suppression on, not
  // an accepted DEAD); a due timer fires DEAD.
  int32_t dl = dl_old;
  const bool no_timer = dl_old == kNoTimer || (suppress_on && st == kDead);
  if (changed && ns == kSuspect && no_timer) {
    dl = add_wrap(round_idx, kPlanes && armed_rounds != nullptr
                                 ? armed_rounds[row]
                                 : suspicion_rounds);
  } else if (changed && ns != kSuspect && !(suppress_on && ns == kDead)) {
    dl = kNoTimer;
  }
  if (ns == kSuspect && round_idx >= dl) {
    ns = kDead;
    dl = kNoTimer;
    changed = true;
  }
  // Every newly stored tombstone opens its suppression window.
  if (suppress_on && ns == kDead && changed) {
    dl = add_wrap(round_idx, dead_suppress_rounds);
  }

  // Crashed or departed rows are frozen.
  if (!alive) {
    ns = st;
    ni = in;
    dl = dl_old;
    changed = false;
  }

  status_out[row * ld.status_out + col] = static_cast<int8_t>(ns);
  inc_out[row * ld.inc_out + col] = ni;
  deadline_out[row * ld.deadline_out + col] = dl;
  spread_out[row * ld.spread_out + col] =
      changed ? add_wrap(add_wrap(round_idx, 1), periods_to_spread)
              : spread[row * ld.spread + col];
  if (is_self) {
    self_inc_out[row] = new_self;
    refuted_out[row] = self_ov ? 1 : 0;
  } else if (col == 0 && (slot < col0 || slot >= col0 + kb)) {
    self_inc_out[row] = my_inc;
    refuted_out[row] = 0;
  }
}

template <typename KeyT, int kDeadBit>
int launch(const void* status, const void* inc, const void* spread,
           const void* deadline, const void* inbox, const void* inbox_alive,
           const void* self_inc, const void* alive_here,
           const void* slot_of_node, const void* armed_rounds,
           void* status_out, void* inc_out, void* spread_out,
           void* deadline_out, void* self_inc_out, void* refuted_out,
           long long n, int kb, int col0, const long long* row_strides,
           int round_idx, int suspicion_rounds, int periods_to_spread,
           int inc_sat, int dead_suppress_rounds, void* stream) {
  if (n == 0 || kb == 0) return static_cast<int>(cudaSuccess);
  const long long* r = row_strides;
  const RowStrides ld{r[0], r[1], r[2], r[3], r[4], r[5],
                      r[6], r[7], r[8], r[9]};
  constexpr int kThreads = 256;
  int tx = 1;
  while (tx < kb && tx < kThreads) tx *= 2;
  const int ty = kThreads / tx;
  const dim3 block(tx, ty);
  const dim3 grid(static_cast<unsigned int>((n + ty - 1) / ty),
                  static_cast<unsigned int>((kb + tx - 1) / tx));
  const bool planes = armed_rounds != nullptr || dead_suppress_rounds > 0;
  const auto kernel = planes ? merge_and_timers_kernel<KeyT, kDeadBit, true>
                             : merge_and_timers_kernel<KeyT, kDeadBit, false>;
  kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int8_t*>(status), static_cast<const int32_t*>(inc),
          static_cast<const int32_t*>(spread),
          static_cast<const int32_t*>(deadline),
          static_cast<const KeyT*>(inbox),
          static_cast<const uint8_t*>(inbox_alive),
          static_cast<const int32_t*>(self_inc),
          static_cast<const uint8_t*>(alive_here),
          static_cast<const int32_t*>(slot_of_node),
          static_cast<const int32_t*>(armed_rounds),
          static_cast<int8_t*>(status_out), static_cast<int32_t*>(inc_out),
          static_cast<int32_t*>(spread_out),
          static_cast<int32_t*>(deadline_out),
          static_cast<int32_t*>(self_inc_out),
          static_cast<uint8_t*>(refuted_out), n, kb, col0, ld, round_idx,
          suspicion_rounds, periods_to_spread, inc_sat, dead_suppress_rounds);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each launches its instance on `stream` and returns the launch's
// cudaError_t (0 = success).  `row_strides` points to ten host int64s,
// the planes' row strides in argument order (status, inc, spread,
// deadline, inbox, inbox_alive, then the four outputs).  `armed_rounds`
// may be null (the scalar suspicion_rounds everywhere).
#define MERGE_AND_TIMERS_ENTRY(NAME, KEY_T, DEAD_BIT)                          \
  extern "C" int NAME(                                                         \
      const void* status, const void* inc, const void* spread,                 \
      const void* deadline, const void* inbox, const void* inbox_alive,        \
      const void* self_inc, const void* alive_here, const void* slot_of_node,  \
      const void* armed_rounds, void* status_out, void* inc_out,               \
      void* spread_out, void* deadline_out, void* self_inc_out,                \
      void* refuted_out, long long n, int kb, int col0,                        \
      const long long* row_strides, int round_idx, int suspicion_rounds,       \
      int periods_to_spread, int inc_sat, int dead_suppress_rounds,            \
      void* stream) {                                                          \
    return launch<KEY_T, DEAD_BIT>(                                            \
        status, inc, spread, deadline, inbox, inbox_alive, self_inc,           \
        alive_here, slot_of_node, armed_rounds, status_out, inc_out,           \
        spread_out, deadline_out, self_inc_out, refuted_out, n, kb, col0,      \
        row_strides, round_idx, suspicion_rounds, periods_to_spread, inc_sat,  \
        dead_suppress_rounds, stream);                                         \
  }

MERGE_AND_TIMERS_ENTRY(merge_and_timers_launch, int32_t, 30)
MERGE_AND_TIMERS_ENTRY(merge_and_timers_wire16_launch, int16_t, 14)
MERGE_AND_TIMERS_ENTRY(merge_and_timers_wire24_launch, int32_t, 23)
