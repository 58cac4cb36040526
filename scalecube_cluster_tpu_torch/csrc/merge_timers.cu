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
// The open-world epoch form (the reference's merge_inbox epoch branch with
// the guard on, and the identity checks of _merge_and_timers): every wire
// key carries an identity epoch in the kEpochBits under the dead bit
// (ops/delivery.pack_record), the incarnation field shrinks by as much,
// and the kernel reads the raw [N, K] epoch lane (any row stride) and
// own_epoch [N], each row's ground-truth epoch, and writes the new lane.
// It pins the self cell's entry epoch to own_epoch itself, so no pinned
// [N, K] copy exists.  Per cell: the winner unpacks with the narrowed
// incarnation mask and its epoch; the same-epoch gate compares the
// epoch-stripped keys in the wide layout (dead bit 30); a lower-epoch
// winner drops; a higher-epoch winner is admitted only if ALIVE, over a
// suppressed tombstone too; the new epoch is the winner's where the cell
// accepts; an accepted epoch change counts as a change (resets the
// spread); the self cell refutes only a winner at its own epoch and keeps
// own_epoch; a frozen row keeps the pinned lane.  A launch without the
// lane (epoch pointer null) runs the epoch-free form, which holds none of
// this code.
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
// 0.153 ms.  The suppression window adds no bytes.  The epoch form adds
// 4 B read and 4 B written a cell and 4 B read a row (own_epoch): 28 + 4
// B a cell + 18 B a row, 642,000,000 B wide, 0.1916 ms (610,000,000 B,
// 0.182 ms, on the int16 wire); with armed_rounds 4,000,000 B more.  A few dozen integer
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
// at column col0 of [N, K] planes.  Each of the twelve planes (the ten
// and the epoch lane in and out) is passed as a
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

// The incarnation field's mask: bits 1..kDeadBit-1-kEpochBits.
template <int kDeadBit, int kEpochBits = 0>
__host__ __device__ constexpr int32_t inc_mask() {
  return (int32_t{1} << (kDeadBit - 1 - kEpochBits)) - 1;
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

// Row strides, in elements, of the twelve [N, Kb] planes.
struct RowStrides {
  long long status, inc, spread, deadline, inbox, inbox_alive;
  long long status_out, inc_out, spread_out, deadline_out;
  long long epoch, epoch_out;
};

// kEpochBits: the epoch form's field width (6 wide, 4 wire24, 2 wire16),
// 0 for the epoch-free form.
template <typename KeyT, int kDeadBit, int kEpochBits, bool kPlanes>
__global__ void merge_and_timers_kernel(
    const int8_t* __restrict__ status, const int32_t* __restrict__ inc,
    const int32_t* __restrict__ spread, const int32_t* __restrict__ deadline,
    const KeyT* __restrict__ inbox, const uint8_t* __restrict__ inbox_alive,
    const int32_t* __restrict__ self_inc, const uint8_t* __restrict__ alive_here,
    const int32_t* __restrict__ slot_of_node,
    const int32_t* __restrict__ armed_rounds,
    const int32_t* __restrict__ epoch, const int32_t* __restrict__ own_epoch,
    int8_t* __restrict__ status_out, int32_t* __restrict__ inc_out,
    int32_t* __restrict__ spread_out, int32_t* __restrict__ deadline_out,
    int32_t* __restrict__ self_inc_out, uint8_t* __restrict__ refuted_out,
    int32_t* __restrict__ epoch_out,
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
  int32_t win_ep = 0;
  if (key >= 0) {
    win_status = ((key >> kDeadBit) & 1) ? kDead : ((key & 1) ? kSuspect : kAlive);
    win_inc = (key >> 1) & inc_mask<kDeadBit, kEpochBits>();
    if (kEpochBits > 0) {
      win_ep = (key >> (kDeadBit - kEpochBits)) & ((1 << kEpochBits) - 1);
    }
  }
  // The entry's epoch, pinned: the self cell holds the row's own epoch.
  int32_t entry_ep = 0;
  int32_t my_ep = 0;
  if (kEpochBits > 0) {
    my_ep = own_epoch[row];
    entry_ep = is_self ? my_ep : epoch[row * ld.epoch + col];
  }

  // merge_inbox: a stored DEAD gates like ABSENT; ABSENT opens only for
  // an ALIVE arrival; a live entry takes a strictly higher key.  Inside
  // its suppression window a tombstone gates by its true DEAD key.
  const bool suppress_on = kPlanes && dead_suppress_rounds > 0;
  const bool suppress = suppress_on && st == kDead && dl_old != kNoTimer &&
                        round_idx < dl_old;
  // The epoch form compares the epoch-stripped keys in the wide layout,
  // then drops a lower-epoch winner and admits a higher-epoch one only if
  // it is ALIVE.
  const int gate = st == kDead ? kAbsent : st;
  bool accepts;
  if (kEpochBits > 0) {
    const int32_t win_key0 = pack_key<30>(win_status, win_inc);
    accepts = gate == kAbsent
                  ? (inbox_alive[row * ld.inbox_alive + col] != 0 &&
                     key >= 0)
                  : win_key0 > pack_key<30>(gate, in);
    if (suppress) accepts = win_key0 > pack_key<30>(kDead, in);
    if (win_ep > entry_ep) {
      accepts = win_status == kAlive;
    } else if (win_ep < entry_ep) {
      accepts = false;
    }
  } else {
    accepts = gate == kAbsent
                  ? (inbox_alive[row * ld.inbox_alive + col] != 0 &&
                     key >= 0)
                  : key > pack_key<kDeadBit>(gate, in);
    if (suppress) accepts = key > pack_key<kDeadBit>(kDead, in);
  }
  int ns = accepts ? win_status : st;
  int32_t ni = accepts ? win_inc : in;
  int32_t ne = accepts ? win_ep : entry_ep;
  bool changed = accepts && (ns != st || ni != in || ne != entry_ep);

  // Self-refutation: is_overrides(winner, ALIVE@self_inc) on the self cell.
  bool self_ov = false;
  int32_t new_self = my_inc;
  if (is_self) {
    if (win_status == kDead) {
      self_ov = true;
    } else if (win_status != kAbsent) {
      self_ov = win_inc == my_inc ? win_status == kSuspect : win_inc > my_inc;
    }
    // A record about this slot at another epoch is not about this member.
    if (kEpochBits > 0 && win_ep != my_ep) self_ov = false;
    const int32_t row_max = self_ov ? win_inc : 0;
    int32_t bumped = add_wrap(my_inc > row_max ? my_inc : row_max, 1);
    bumped = bumped < inc_sat ? bumped : inc_sat;
    if (self_ov && alive) new_self = bumped;
    ns = kAlive;
    ni = new_self;
    ne = my_ep;
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
    ne = entry_ep;
    dl = dl_old;
    changed = false;
  }

  status_out[row * ld.status_out + col] = static_cast<int8_t>(ns);
  if (kEpochBits > 0) epoch_out[row * ld.epoch_out + col] = ne;
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

template <typename KeyT, int kDeadBit, int kEpochBits, bool kPlanes>
void start(dim3 grid, dim3 block, cudaStream_t stream, const void* status,
           const void* inc, const void* spread, const void* deadline,
           const void* inbox, const void* inbox_alive, const void* self_inc,
           const void* alive_here, const void* slot_of_node,
           const void* armed_rounds, const void* epoch,
           const void* own_epoch, void* status_out, void* inc_out,
           void* spread_out, void* deadline_out, void* self_inc_out,
           void* refuted_out, void* epoch_out, long long n, int kb,
           int col0, const RowStrides& ld, int round_idx,
           int suspicion_rounds, int periods_to_spread, int inc_sat,
           int dead_suppress_rounds) {
  merge_and_timers_kernel<KeyT, kDeadBit, kEpochBits, kPlanes>
      <<<grid, block, 0, stream>>>(
          static_cast<const int8_t*>(status), static_cast<const int32_t*>(inc),
          static_cast<const int32_t*>(spread),
          static_cast<const int32_t*>(deadline),
          static_cast<const KeyT*>(inbox),
          static_cast<const uint8_t*>(inbox_alive),
          static_cast<const int32_t*>(self_inc),
          static_cast<const uint8_t*>(alive_here),
          static_cast<const int32_t*>(slot_of_node),
          static_cast<const int32_t*>(armed_rounds),
          static_cast<const int32_t*>(epoch),
          static_cast<const int32_t*>(own_epoch),
          static_cast<int8_t*>(status_out), static_cast<int32_t*>(inc_out),
          static_cast<int32_t*>(spread_out),
          static_cast<int32_t*>(deadline_out),
          static_cast<int32_t*>(self_inc_out),
          static_cast<uint8_t*>(refuted_out),
          static_cast<int32_t*>(epoch_out), n, kb, col0, ld, round_idx,
          suspicion_rounds, periods_to_spread, inc_sat, dead_suppress_rounds);
}

template <typename KeyT, int kDeadBit, int kEpochBits>
int launch(const void* status, const void* inc, const void* spread,
           const void* deadline, const void* inbox, const void* inbox_alive,
           const void* self_inc, const void* alive_here,
           const void* slot_of_node, const void* armed_rounds,
           const void* epoch, const void* own_epoch,
           void* status_out, void* inc_out, void* spread_out,
           void* deadline_out, void* self_inc_out, void* refuted_out,
           void* epoch_out, long long n, int kb, int col0,
           const long long* row_strides, int round_idx,
           int suspicion_rounds, int periods_to_spread, int inc_sat,
           int dead_suppress_rounds, void* stream) {
  if (n == 0 || kb == 0) return static_cast<int>(cudaSuccess);
  const long long* r = row_strides;
  const RowStrides ld{r[0], r[1], r[2], r[3], r[4],  r[5],
                      r[6], r[7], r[8], r[9], r[10], r[11]};
  constexpr int kThreads = 256;
  int tx = 1;
  while (tx < kb && tx < kThreads) tx *= 2;
  const int ty = kThreads / tx;
  const dim3 block(tx, ty);
  const dim3 grid(static_cast<unsigned int>((n + ty - 1) / ty),
                  static_cast<unsigned int>((kb + tx - 1) / tx));
  const bool planes = armed_rounds != nullptr || dead_suppress_rounds > 0;
  const bool epochs = epoch != nullptr;
  const auto s = static_cast<cudaStream_t>(stream);
#define MERGE_START(EPOCH_BITS, PLANES)                                       \
  start<KeyT, kDeadBit, EPOCH_BITS, PLANES>(                                  \
      grid, block, s, status, inc, spread, deadline, inbox, inbox_alive,      \
      self_inc, alive_here, slot_of_node, armed_rounds, epoch, own_epoch,     \
      status_out, inc_out, spread_out, deadline_out, self_inc_out,            \
      refuted_out, epoch_out, n, kb, col0, ld, round_idx, suspicion_rounds,   \
      periods_to_spread, inc_sat, dead_suppress_rounds)
  if (epochs) {
    if (planes) MERGE_START(kEpochBits, true); else MERGE_START(kEpochBits, false);
  } else {
    if (planes) MERGE_START(0, true); else MERGE_START(0, false);
  }
#undef MERGE_START
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each launches its instance on `stream` and returns the launch's
// cudaError_t (0 = success).  `row_strides` points to twelve host int64s,
// the planes' row strides in argument order (status, inc, spread,
// deadline, inbox, inbox_alive, the four outputs, then epoch and
// epoch_out).  `armed_rounds` may be null (the scalar suspicion_rounds
// everywhere); `epoch` null selects the epoch-free form (own_epoch and
// epoch_out are then not read or written).
#define MERGE_AND_TIMERS_ENTRY(NAME, KEY_T, DEAD_BIT, EPOCH_BITS)              \
  extern "C" int NAME(                                                         \
      const void* status, const void* inc, const void* spread,                 \
      const void* deadline, const void* inbox, const void* inbox_alive,        \
      const void* self_inc, const void* alive_here, const void* slot_of_node,  \
      const void* armed_rounds, const void* epoch, const void* own_epoch,      \
      void* status_out, void* inc_out, void* spread_out, void* deadline_out,   \
      void* self_inc_out, void* refuted_out, void* epoch_out, long long n,     \
      int kb, int col0, const long long* row_strides, int round_idx,           \
      int suspicion_rounds, int periods_to_spread, int inc_sat,                \
      int dead_suppress_rounds, void* stream) {                                \
    return launch<KEY_T, DEAD_BIT, EPOCH_BITS>(                                \
        status, inc, spread, deadline, inbox, inbox_alive, self_inc,           \
        alive_here, slot_of_node, armed_rounds, epoch, own_epoch, status_out,  \
        inc_out, spread_out, deadline_out, self_inc_out, refuted_out,          \
        epoch_out, n, kb, col0, row_strides, round_idx, suspicion_rounds,      \
        periods_to_spread, inc_sat, dead_suppress_rounds, stream);             \
  }

MERGE_AND_TIMERS_ENTRY(merge_and_timers_launch, int32_t, 30, 6)
MERGE_AND_TIMERS_ENTRY(merge_and_timers_wire16_launch, int16_t, 14, 2)
MERGE_AND_TIMERS_ENTRY(merge_and_timers_wire24_launch, int32_t, 23, 4)
