// The membership event trace's record, one launch a round: three front
// ends over one single-pass, order-preserving compaction.
//
// The reference computes the trace in XLA (scalecube_cluster_tpu/
// telemetry/trace.py): derive_event_codes (:166-241) codes each cell's
// net transition, update_first_rounds (:326-341) stamps the first-suspect
// and first-removed rounds, and record_events_batch (:254-301) gives each
// event its slot from a cumsum over the flattened [N, K] code plane and
// writes the rows with one scatter.  It has no Pallas counterpart.
//
// trace_observe (the traced round's one launch) takes the round's two
// stored carries: prev_status and new_status [N, K] int8, new_inc [N, K]
// (int32, or int16 under the compact carry), optionally prev_epoch and
// new_epoch [N, K] (the open-world lane: int32, or int16 stored narrow),
// self_inc [N] int32, leave_at [N] int32 (the observer range's rows),
// subject_ids [K] int32, the round and the observer offset.  Each cell's
// code is derived as derive_event_codes does: the four disjoint status
// masks, JOINED winning where the epoch advanced to a live record, zero
// on the self cell (subject_ids[col] == row + offset) except LEAVING
// where leave_at[row] == round, with incarnation self_inc[row] + 1.  The
// self cells are found per column (column k's lies in row
// subject_ids[k] - offset), so leave_at is read at those K cells only.
// At a SUSPECTED or REMOVED cell first_suspect or first_removed [N, K]
// int32 becomes the round where it holds INT32_MAX.
//
// trace_record (the codes-in API, record_events[_batch], and the
// invariant monitor's evidence record) takes codes [N, K] int8 (0 or
// negative = no event, else event type + 1) and incs [N, K] (int32 or
// int16).  With subject_ids null the row's subject is its observer
// (row + offset): the monitor's self lanes, an [N, 1] plane.
//
// provenance_observe (the provenance plane's round, the reference's
// models/provenance.py observe_round: round_channel_records :184-223 and
// record_attributions :236-321, no Pallas counterpart) codes the cells as
// trace_observe does, without the first-round stamps, and codes the self
// cell of a row that bumped its own incarnation (new self_inc > prev)
// ALIVE_REFUTED unless it leaves.  Each event's row is (row + offset,
// subject, epoch, code - 1, channel, round) into lanes [capacity, 6]:
// the epoch the new epoch lane's at the cell (0 without the lane), the
// channel the reference's cascade (attribute_channels :135-181) over the
// round's three exposed key planes fd, gossip and sync [N, K] (the wire
// dtype, int32 or int16), read at event cells only: the winner is their
// max; FD_DIRECT, then GOSSIP where gossip >= 0 ties the winner, SYNC
// where sync does, FD where fd does (PINGREQ_PROXY where the row's
// ping_req [N] flag is set, only with ping-req members configured), FD
// for a REMOVED cell whose winner is not a DEAD key (dead_bit of the
// wire format), JOIN_REBIRTH where join_at[subject] == round; the self
// refutation's channel is SELF_REFUTATION.
//
// All three update in place their lanes, count and dropped: the
// cell holding the round's e-th event (cell order, observer-major)
// writes its row (trace_observe and trace_record: round, row + offset,
// subject_ids[col], code - 1, inc) at slot count + e while that slot is
// below the capacity; then count becomes
// min(count + total, capacity) and dropped grows by the rest.  Overflow
// is counted, never cut silently.
//
// Back end: a single-pass, order-preserving compaction, a decoupled
// look-back as in a device select.  Tiles of 8,192 cells (each of 256
// threads takes 32 consecutive cells) are taken in order from an atomic
// tile counter, so every earlier tile is held by a running block and no
// block waits on one that is not resident.  A tile counts its events
// (byte-wise tests in 32-bit words, a one-bit-a-cell event mask, a block
// scan) and publishes its aggregate twice: in its own descriptor, and by
// one atomic add (the tile count and the sum in one word) into its
// group's total, a group being 32 consecutive tiles.  Its exclusive
// prefix is the totals of the earlier groups plus the aggregates of its
// group's earlier tiles, read by one warp with every load in flight at
// once.  No tile waits for another's prefix, only for aggregates, so
// nothing is chained through the tiles (the inclusive-prefix look-back
// of a device select chains the prefix through the tiles that the
// resident blocks work on together, one round trip a hop, and was the
// slowest phase of a tile on the H100).  A descriptor is one 64-bit
// word, generation (30 bits), flag (2), value (32); a group total is
// tiles in (32), sum (32).  The generation is a device word that every
// block reads at its start and the last tile increments at its end, so
// the descriptors are never reset between launches and a replay of the
// same launch (a CUDA graph) still sees a new generation; the group
// totals sit in two banks that alternate with the generation, each
// launch zeroing the bank the next one adds into.
//
// The grid is persistent, as many blocks as are resident, and each block
// works as a three-stage pipeline over three shared-memory buffers: it
// codes a tile and publishes its aggregate, then draws its next tile and
// copies it in with cp.async while it looks back for, and writes, the
// tile it coded one step before, whose look-back so waits out a whole
// coding step instead of stalling the block.  A block never holds a tile
// it has drawn and not coded.  The codes replace the first input plane in
// shared memory and stay there from the count to the write.  A tile with
// at most 128 events stages its rows while the look-back's reads are in
// flight (each thread its own events; a row does not depend on its
// slot); a fuller one has them built by all 256 threads, row k by thread
// k mod 256 (its cell found by a binary search over the threads' first
// events, then in that thread's mask), staged 768 at a time.  Rows are
// stored as consecutive 4-byte words, so a warp writes 640 contiguous
// bytes of 20-byte rows.  A thread reads the first-round matrices at
// four of its stamped cells at once.  The per-chunk code loop is kept
// rolled: under a full memory stream each instruction fetched is a round
// trip.
//
// count is read on the device only: every block reads it (and the
// generation) before its first tile publishes, and the last tile writes
// it after its look-back, which ends only once every earlier tile has
// published.  The block that draws the last number (each block draws
// once past the last tile) resets the counter.  Launches sharing one
// scratch must run one after another (one stream).  Inputs that are not
// 16-byte aligned are copied a byte at a time; the epoch lanes are read
// from device memory directly, a chunk at a time.
//
// Bound: bytes (HBM 3.35 TB/s), each input read once, each output
// written once.  trace_observe: 2 B a cell of status, 2 x 4 B or 2 x 2 B
// a cell of epochs when the lane is on, 8 B a subject (its id, and
// leave_at at its self row); per event the incarnation (4 or 2 B), 8 B
// of first-round read and write at a SUSPECTED or REMOVED cell, 20 B a
// recorded row.  At 1M x 16 without epochs a sparse round (about 11,000
// events) is about 32.4 MB, 0.0097 ms.  trace_record: 1 B a cell of
// codes; per event the incarnation and 20 B a row: a sparse round
// (about 16,000 events) 0.0049 ms.  provenance_observe: the status and
// epoch bytes of trace_observe, 8 B a subject (its id, leave_at), 8 B a
// self row (prev and new self_inc), 4 B a subject's join_at; per event
// the three keys (3 x 4 or 3 x 2 B), the new epoch when the lane is on, a
// ping_req byte when it splits, 24 B a recorded row.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr int kWarps = kThreads / kWarp;
constexpr int kChunk = 16;                // cells in one 16-byte int8 copy
constexpr int kVec = 2;                   // a thread's chunks in a tile
constexpr int kPer = kChunk * kVec;       // a thread's cells in a tile
constexpr int kTile = kThreads * kPer;    // 8,192
constexpr int kMaskWords = kPer / 32;     // a thread's event mask words
constexpr int kLanes = 5;                 // trace rows
constexpr int kProvLanes = 6;             // provenance rows
constexpr int kStageRows = 768;           // rows staged at a time (15 KB)
constexpr int kEarlyRows = 128;           // a sparse tile's rows, staged early
constexpr int kGroup = kWarp;             // tiles whose totals add up in one word
constexpr int kSubjectSlots = 512;        // subject ids kept in shared memory
constexpr int kMaxDevices = 64;
constexpr unsigned int kSpinNs = 64;      // back-off between look-back polls
constexpr int kBatch = 4;                 // first-round stamps read at once
constexpr int32_t kNever = 0x7fffffff;

// records.MemberStatus; event codes (TraceEventType + 1).
constexpr uint32_t kAlive = 0, kSuspect = 1, kDead = 2, kAbsent = 3;
constexpr uint32_t kOnes4 = 0x01010101u;
constexpr uint32_t kSuspected = 2, kRefuted = 3, kRemoved = 4, kLeaving = 5,
                   kJoined = 6;
// models/provenance.py channel codes.
constexpr int32_t kChFd = 0, kChPingReq = 1, kChGossip = 2, kChSync = 3,
                  kChSelf = 4, kChJoin = 5;

constexpr unsigned long long kFlagAggregate = 1ull;
constexpr uint32_t kGenMask = 0x3fffffffu;

enum Front { kObserve, kRecord, kProvenance };
struct NoEpoch {};



struct Args {
  const int8_t* codes;        // trace_record: the codes; observe: prev
  const int8_t* new_status;   // observe
  const void* incs;           // trace_record: incs; observe: new_inc
  const void* prev_epoch;     // observe, epoch lane on
  const void* new_epoch;
  const int32_t* self_inc;    // observe: [N]
  const int32_t* leave_at;    // observe: [N], the observer range's rows
  const int32_t* subject_ids;
  int32_t* first_suspect;     // observe
  int32_t* first_removed;
  const void* fd;             // provenance: the three key planes
  const void* gossip;
  const void* sync;
  const int32_t* prev_self_inc;  // provenance: [N] (self_inc the new one)
  const int32_t* join_at;     // provenance: [world N]
  const uint8_t* ping_req;    // provenance: [N] bool
  int dead_bit;               // provenance: the wire format's
  bool split_ping_req;        // provenance: ping-req members configured
  int32_t* lanes;
  int32_t* count;
  int32_t* dropped;
  unsigned long long* scratch;  // tile counter, generation, descriptors,
                                // group totals
  uint32_t scratch_tiles;       // descriptors the scratch holds
  uint32_t n_cells;
  uint32_t rows;              // n_cells / cols
  uint32_t cols;
  uint32_t n_tiles;
  long long capacity;
  int32_t round_idx;
  uint32_t observer_offset;
  bool aligned;               // the int8 planes 16-byte aligned
  bool self_subject;          // trace_record: subject = row + offset
  bool epoch_aligned;         // the epoch lanes 16-byte aligned
};

// A block's shared memory: three tiles' int8 planes (plane 0 becomes the
// codes), the staged rows, the subject ids, two tiles' metadata, the scan.
template <int kFront>
struct Shared {
  static constexpr int kPlanes = kFront == kRecord ? 1 : 2;
  static constexpr int kRowLanes = kFront == kProvenance ? kProvLanes : kLanes;
  alignas(16) int8_t in[3][kPlanes][kTile];
  int32_t rows[kStageRows * kRowLanes];
  int32_t early[2][kEarlyRows * kRowLanes];  // a sparse tile's rows
  int32_t subjects[kSubjectSlots];          // subject_ids, where they fit
  // Two tiles' metadata: the one being coded and the one being written.
  uint32_t offsets[2][kThreads];            // each thread's first event
  uint32_t masks[2][kThreads][kMaskWords];  // each thread's event masks
  uint32_t tiles[2], aggregates[2], exclusive[2];
  uint32_t warp_sums[kWarps];
  uint32_t next, gen;
  int32_t count;
};

__device__ __forceinline__ unsigned long long descriptor(
    uint32_t gen, unsigned long long flag, uint32_t value) {
  return (static_cast<unsigned long long>(gen & kGenMask) << 34) |
         (flag << 32) | value;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned int s =
      static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Start copying ``tile``'s int8 planes (16-byte chunks, thread t the
// chunks t, t + 256, ..., so a warp copies 512 contiguous bytes; zero
// past n_cells) into input buffer ``buf``; one cp.async group.
template <int kFront>
__device__ __forceinline__ void prefetch(const Args& a, Shared<kFront>& sm,
                                         int buf, uint32_t tile) {
  const int8_t* planes[2] = {a.codes, a.new_status};
#pragma unroll
  for (int v = 0; v < kVec; ++v) {
    const int local = (v * kThreads + threadIdx.x) * kChunk;
    const uint32_t c = tile * kTile + local;
    const int have = c >= a.n_cells
                         ? 0
                         : (a.n_cells - c < kChunk ? a.n_cells - c : kChunk);
#pragma unroll
    for (int p = 0; p < Shared<kFront>::kPlanes; ++p) {
      int8_t* dst = &sm.in[buf][p][local];
      if (a.aligned) {
        cp_async16(dst, planes[p] + (have ? c : 0), have);
      } else {
        for (int i = 0; i < kChunk; ++i) {
          dst[i] = i < have ? planes[p][c + i] : 0;
        }
      }
    }
  }
  cp_async_commit();
}

// Bit i set where new_epoch > prev_epoch (as int32) at cell c0 + i.
template <typename EpochT>
__device__ __forceinline__ uint32_t epoch_advanced(const Args& a, uint32_t c0,
                                                   bool vec) {
  const EpochT* prev = static_cast<const EpochT*>(a.prev_epoch);
  const EpochT* next = static_cast<const EpochT*>(a.new_epoch);
  uint32_t bits = 0u;
  if (vec) {
    constexpr int kVecs = kChunk * sizeof(EpochT) / 16;
    constexpr int kPerWord = 4 / sizeof(EpochT);
    const uint4* p4 = reinterpret_cast<const uint4*>(prev + c0);
    const uint4* n4 = reinterpret_cast<const uint4*>(next + c0);
#pragma unroll
    for (int v = 0; v < kVecs; ++v) {
      const uint4 pv = __ldg(p4 + v);
      const uint4 nv = __ldg(n4 + v);
      const uint32_t pw[4] = {pv.x, pv.y, pv.z, pv.w};
      const uint32_t nw[4] = {nv.x, nv.y, nv.z, nv.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (pw[j] == nw[j]) continue;
#pragma unroll
        for (int e = 0; e < kPerWord; ++e) {
          const int shift = 8 * static_cast<int>(sizeof(EpochT)) * e;
          const int32_t pe = static_cast<EpochT>(pw[j] >> shift);
          const int32_t ne = static_cast<EpochT>(nw[j] >> shift);
          if (ne > pe) bits |= 1u << ((v * 4 + j) * kPerWord + e);
        }
      }
    }
    return bits;
  }
#pragma unroll
  for (int i = 0; i < kChunk; ++i) {
    if (c0 + i < a.n_cells && static_cast<int32_t>(next[c0 + i]) >
                                  static_cast<int32_t>(prev[c0 + i])) {
      bits |= 1u << i;
    }
  }
  return bits;
}

// Byte-wise tests on four cells a word, in plain 32-bit arithmetic: the
// top bit of each byte that is nonzero (or equal to k), its byte mask,
// and one bit a byte (byte i -> bit i, the top bits gathered by one
// multiply whose partial products do not overlap).
__device__ __forceinline__ uint32_t nonzero_top(uint32_t x) {
  return (((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x) & 0x80808080u;
}

__device__ __forceinline__ uint32_t equal_top(uint32_t x, uint32_t k) {
  return nonzero_top(x ^ (kOnes4 * k)) ^ 0x80808080u;
}

__device__ __forceinline__ uint32_t top_bytes(uint32_t top) {
  return (top >> 7) * 0xffu;
}

__device__ __forceinline__ uint32_t top_bits(uint32_t top) {
  return (top * 0x00204081u) >> 28;
}

// Four bits -> four byte masks.
__device__ __forceinline__ uint32_t expand4(uint32_t b) {
  return (b & 1u) * 0x000000ffu | ((b >> 1) & 1u) * 0x0000ff00u |
         ((b >> 2) & 1u) * 0x00ff0000u | ((b >> 3) & 1u) * 0xff000000u;
}

// The status codes of four cells (derive_event_codes' disjoint masks).
__device__ __forceinline__ uint32_t status_codes(uint32_t p, uint32_t q) {
  const uint32_t q_alive = top_bytes(equal_top(q, kAlive));
  const uint32_t q_suspect = top_bytes(equal_top(q, kSuspect));
  const uint32_t q_dead = top_bytes(equal_top(q, kDead));
  const uint32_t p_suspect = top_bytes(equal_top(p, kSuspect));
  const uint32_t p_dead = top_bytes(equal_top(p, kDead));
  const uint32_t p_absent = top_bytes(equal_top(p, kAbsent));
  return (q_alive & (p_absent | p_dead) & kOnes4) |       // ADDED
         (q_suspect & ~p_suspect & (kOnes4 * 2u)) |       // SUSPECTED
         (q_alive & p_suspect & (kOnes4 * 3u)) |          // ALIVE_REFUTED
         (q_dead & ~p_dead & (kOnes4 * 4u));              // REMOVED
}

// One 16-cell chunk's codes under the observe front end, from its
// status words p and q: the four status masks, and JOINED where the
// epoch advanced (``joined``, one bit a cell) to a live record.  The
// self cells are coded apart (code_tile).
template <bool kEpoch>
__device__ __forceinline__ void chunk_codes(const uint32_t (&p)[4],
                                            const uint32_t (&q)[4],
                                            uint32_t joined,
                                            uint32_t (&w)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[i] = status_codes(p[i], q[i]);
    if (kEpoch) {
      const uint32_t live =
          top_bytes(equal_top(q[i], kAlive) | equal_top(q[i], kSuspect));
      const uint32_t jm = expand4((joined >> (4 * i)) & 0xfu) & live;
      w[i] = (w[i] & ~jm) | (jm & (kOnes4 * kJoined));
    }
  }
}

// The group totals of the launch with generation ``gen``: two banks
// after the descriptors, used by alternate launches; a launch zeroes the
// other bank (the last launch's, done) for the next one.
__device__ __forceinline__ unsigned long long* group_totals(const Args& a,
                                                            uint32_t gen) {
  const uint32_t groups = (a.scratch_tiles + kGroup - 1) / kGroup;
  return a.scratch + 2 + a.scratch_tiles + (gen & 1u) * groups;
}

__device__ __forceinline__ void clear_next_totals(const Args& a,
                                                  uint32_t gen) {
  const uint32_t groups = (a.scratch_tiles + kGroup - 1) / kGroup;
  unsigned long long* const next = group_totals(a, gen + 1u);
  for (uint32_t g = blockIdx.x * kThreads + threadIdx.x; g < groups;
       g += gridDim.x * kThreads) {
    next[g] = 0ull;
  }
}

// Draw a tile number (split from its use, so the atomic's latency can
// pass under other work).
__device__ __forceinline__ uint32_t draw(const Args& a) {
  return static_cast<uint32_t>(atomicAdd(a.scratch, 1ull));
}

// Keep a drawn tile number as the block's next; the block drawing the
// very last number (every block draws once past the last tile) resets
// the counter.
__device__ __forceinline__ void keep_next(const Args& a, uint32_t t,
                                          uint32_t& next) {
  if (t == a.n_tiles + gridDim.x - 1) {
    *reinterpret_cast<volatile unsigned long long*>(a.scratch) = 0ull;
  }
  next = t;
}

// The position of the r-th (from 0) set bit of m, which has more than r.
__device__ __forceinline__ uint32_t nth_bit(uint32_t m, uint32_t r) {
  uint32_t pos = 0u;
#pragma unroll
  for (int width = 16; width > 0; width /= 2) {
    const uint32_t c = __popc(m & ((1u << width) - 1u));
    if (r >= c) {
      r -= c;
      m >>= width;
      pos += width;
    }
  }
  return pos;
}

// Cell i of the thread whose event masks are ``masks`` holding its r-th
// event (from 0).
__device__ __forceinline__ uint32_t nth_event(const uint32_t* masks,
                                              uint32_t r) {
  uint32_t base = 0u;
#pragma unroll
  for (int g = 0; g < kMaskWords - 1; ++g) {
    const uint32_t c = __popc(masks[g]);
    if (r < c) return base + nth_bit(masks[g], r);
    r -= c;
    base += 32u;
  }
  return base + nth_bit(masks[kMaskWords - 1], r);
}

// A key of the wire format's dtype, sign-extended.
template <typename KeyT>
__device__ __forceinline__ int32_t key_at(const void* plane, uint32_t cell) {
  return static_cast<int32_t>(static_cast<const KeyT*>(plane)[cell]);
}

// The provenance row of ``cell`` (its code ``code``) into ``out``:
// observer, subject, epoch, type, channel, round.
template <typename KeyT, typename EpochT>
__device__ __forceinline__ void build_provenance_row(const Args& a,
                                                     int32_t* out,
                                                     uint32_t code,
                                                     uint32_t cell,
                                                     const int32_t* subjects) {
  const uint32_t row = cell / a.cols;
  const uint32_t col = cell - row * a.cols;
  const int32_t observer = static_cast<int32_t>(row + a.observer_offset);
  const int32_t subject = subjects[col];
  int32_t channel;
  if (code == kRefuted && subject == observer) {
    channel = kChSelf;  // a self cell codes only LEAVING or the refutation
  } else {
    const int32_t fd = key_at<KeyT>(a.fd, cell);
    const int32_t gossip = key_at<KeyT>(a.gossip, cell);
    const int32_t sync = key_at<KeyT>(a.sync, cell);
    const int32_t winner = max(fd, max(sync, gossip));
    channel = kChFd;
    if (gossip >= 0 && gossip == winner) channel = kChGossip;
    if (sync >= 0 && sync == winner) channel = kChSync;
    if (fd >= 0 && fd == winner) {
      channel = a.split_ping_req && __ldg(a.ping_req + row) ? kChPingReq
                                                            : kChFd;
    }
    const bool dead_winner = winner >= 0 && ((winner >> a.dead_bit) & 1);
    if (code == kRemoved && !dead_winner) channel = kChFd;
    if (__ldg(a.join_at + subject) == a.round_idx) channel = kChJoin;
  }
  int32_t epoch = 0;
  if constexpr (!std::is_same<EpochT, NoEpoch>::value) {
    epoch = static_cast<int32_t>(static_cast<const EpochT*>(a.new_epoch)[cell]);
  }
  out[0] = observer;
  out[1] = subject;
  out[2] = epoch;
  out[3] = static_cast<int32_t>(code) - 1;
  out[4] = channel;
  out[5] = a.round_idx;
}

// The row of ``cell`` (its code ``code``) into ``out``: round, observer,
// subject, type, incarnation (self_inc + 1 for LEAVING); the provenance
// row under that front end.
template <int kFront, typename IncT, typename EpochT>
__device__ __forceinline__ void build_row(const Args& a, int32_t* out,
                                          uint32_t code, uint32_t cell,
                                          const int32_t* subjects) {
  if constexpr (kFront == kProvenance) {
    build_provenance_row<IncT, EpochT>(a, out, code, cell, subjects);
    return;
  }
  const uint32_t row = cell / a.cols;
  const uint32_t col = cell - row * a.cols;
  int32_t inc;
  if (kFront == kObserve && code == kLeaving) {
    inc = static_cast<int32_t>(
        static_cast<uint32_t>(__ldg(a.self_inc + row)) + 1u);
  } else {
    inc = static_cast<int32_t>(static_cast<const IncT*>(a.incs)[cell]);
  }
  out[0] = a.round_idx;
  out[1] = static_cast<int32_t>(row + a.observer_offset);
  out[2] = kFront == kRecord && a.self_subject
               ? static_cast<int32_t>(row + a.observer_offset)
               : subjects[col];
  out[3] = static_cast<int32_t>(code) - 1;
  out[4] = inc;
}

// Code one tile from input buffer ``buf`` into metadata slot ``slot``:
// the codes (over the tile's first input plane), the event masks, the
// block scan; publish its aggregate; draw the block's next tile into
// ``sm.next``; stamp the first-round matrices.  A block so holds at most
// one tile that it has drawn and not coded.
template <int kFront, typename IncT, typename EpochT>
__device__ __forceinline__ uint32_t code_tile(const Args& a,
                                              Shared<kFront>& sm, int buf,
                                              int slot, uint32_t tile) {
  constexpr bool kEpoch = !std::is_same<EpochT, NoEpoch>::value;
  const int tid = threadIdx.x;
  const int lane = tid & (kWarp - 1);
  const int warp = tid / kWarp;
  const uint32_t gen = sm.gen;
  volatile unsigned long long* const desc = a.scratch + 2;
  const uint32_t n = a.n_cells;
  const uint32_t c0 = tile * kTile + tid * kPer;
  int8_t* const mine_in = &sm.in[buf][0][tid * kPer];
  const int32_t* const subjects =
      a.cols <= kSubjectSlots ? sm.subjects : a.subject_ids;

  // The thread's codes, one byte a cell, over its first input plane, and
  // its event masks (bit i of word g: cell 32 g + i holds an event).
  uint32_t masks[kMaskWords] = {};
  uint32_t stamps[kMaskWords] = {};  // the SUSPECTED and REMOVED cells
  if constexpr (kFront == kRecord) {
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      uint4* slot = reinterpret_cast<uint4*>(mine_in + v * kChunk);
      const uint4 x = *slot;
      if ((x.x | x.y | x.z | x.w) == 0u) continue;
      uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // An event is a positive code: nonzero, top bit clear.
        const uint32_t event = nonzero_top(w[i]) & ~w[i] & 0x80808080u;
        w[i] &= top_bytes(event);
        masks[v / 2] |= top_bits(event) << ((v % 2) * kChunk + 4 * i);
      }
      *slot = make_uint4(w[0], w[1], w[2], w[3]);
    }
  } else {
    // The status (and epoch) codes, a chunk at a time.
#pragma unroll 1
    for (int v = 0; v < kVec; ++v) {
      const uint32_t c = c0 + v * kChunk;
      uint4* slot = reinterpret_cast<uint4*>(mine_in + v * kChunk);
      const uint4 pv = *slot;
      const uint4 qv = *reinterpret_cast<const uint4*>(
          &sm.in[buf][1][tid * kPer + v * kChunk]);
      const uint32_t p[4] = {pv.x, pv.y, pv.z, pv.w};
      const uint32_t q[4] = {qv.x, qv.y, qv.z, qv.w};
      uint32_t joined = 0u;
      if constexpr (kEpoch) {
        joined = epoch_advanced<EpochT>(a, c,
                                        a.epoch_aligned && c + kChunk <= n);
      }
      const uint32_t differ = (p[0] ^ q[0]) | (p[1] ^ q[1]) |
                              (p[2] ^ q[2]) | (p[3] ^ q[3]);
      if (differ != 0u || joined != 0u) {
        uint32_t w[4];
        chunk_codes<kEpoch>(p, q, joined, w);
        *slot = make_uint4(w[0], w[1], w[2], w[3]);
      } else if ((p[0] | p[1] | p[2] | p[3]) != 0u) {
        *slot = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    __syncthreads();
    // The self cells: column k's lies in row subject_ids[k] - offset.  It
    // codes nothing, or LEAVING where its row leaves this round (under the
    // provenance front end, else ALIVE_REFUTED where the row bumped its
    // own incarnation); leave_at and self_inc are read there only.
    const uint32_t base = tile * kTile;
    const uint32_t end = base + kTile < n ? base + kTile : n;
    for (uint32_t k = tid; k < a.cols; k += kThreads) {
      const uint32_t r =
          static_cast<uint32_t>(subjects[k]) - a.observer_offset;
      if (r >= a.rows) continue;
      const uint32_t cell = r * a.cols + k;
      if (cell < base || cell >= end) continue;
      uint8_t code = __ldg(a.leave_at + r) == a.round_idx ? kLeaving : 0u;
      if (kFront == kProvenance && code == 0u &&
          __ldg(a.self_inc + r) > __ldg(a.prev_self_inc + r)) {
        code = kRefuted;
      }
      reinterpret_cast<uint8_t*>(sm.in[buf][0])[cell - base] = code;
    }
    __syncthreads();
    // The event and stamp masks, from the codes.
    unsigned long long events = 0ull, stamped = 0ull;
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      const uint4 x = *reinterpret_cast<const uint4*>(mine_in + v * kChunk);
      if ((x.x | x.y | x.z | x.w) == 0u) continue;
      const uint32_t w[4] = {x.x, x.y, x.z, x.w};
      uint32_t chunk_events = 0u, chunk_stamps = 0u;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        chunk_events |= top_bits(nonzero_top(w[i])) << (4 * i);
        if (kFront == kObserve) {
          chunk_stamps |= top_bits(equal_top(w[i], kSuspected) |
                                   equal_top(w[i], kRemoved))
                          << (4 * i);
        }
      }
      events |= static_cast<unsigned long long>(chunk_events)
                << (v * kChunk);
      stamped |= static_cast<unsigned long long>(chunk_stamps)
                 << (v * kChunk);
    }
#pragma unroll
    for (int g = 0; g < kMaskWords; ++g) {
      masks[g] = static_cast<uint32_t>(events >> (32 * g));
      stamps[g] = static_cast<uint32_t>(stamped >> (32 * g));
    }
  }
  uint32_t mine = 0u;
#pragma unroll
  for (int g = 0; g < kMaskWords; ++g) {
    mine += __popc(masks[g]);
    sm.masks[slot][tid][g] = masks[g];
  }

  // Block scan of the threads' counts.
  uint32_t incl = mine;
#pragma unroll
  for (int d = 1; d < kWarp; d *= 2) {
    const uint32_t up = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += up;
  }
  if (lane == kWarp - 1) sm.warp_sums[warp] = incl;
  __syncthreads();
  uint32_t before = 0u, aggregate = 0u;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    const uint32_t s = sm.warp_sums[i];
    if (i < warp) before += s;
    aggregate += s;
  }
  sm.offsets[slot][tid] = before + incl - mine;  // its first event
  if (tid == 0) {
    sm.tiles[slot] = tile;
    sm.aggregates[slot] = aggregate;
  }

  // Publish (count and the generation were read before the block's first
  // barrier): the tile's aggregate for the later tiles of its group, and
  // into its group's total for the later groups.
  const uint32_t group = tile / kGroup;
  unsigned long long* const totals = group_totals(a, gen);
  if (tid == 2 * kWarp) keep_next(a, draw(a), sm.next);
  if (tid == kWarp) {
    desc[tile] = descriptor(gen, kFlagAggregate, aggregate);
    atomicAdd(totals + group, (1ull << 32) | aggregate);
  }
  // The first-round stamps, kBatch cells' reads in flight at once.
  const uint8_t* const my_codes = reinterpret_cast<const uint8_t*>(mine_in);
  if constexpr (kFront == kObserve) {
#pragma unroll
    for (int g = 0; g < kMaskWords; ++g) {
#pragma unroll 1
      for (uint32_t m = stamps[g]; m != 0u;) {
        int32_t* at[kBatch];
        int32_t held[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          at[b] = nullptr;
          if (m != 0u) {
            const uint32_t i = 32u * g + __ffs(m) - 1;
            m &= m - 1u;
            at[b] = (my_codes[i] == kSuspected ? a.first_suspect
                                                : a.first_removed) +
                    c0 + i;
          }
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) held[b] = at[b] ? *at[b] : 0;
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          if (at[b] && held[b] == kNever) *at[b] = a.round_idx;
        }
      }
    }
  }
  return aggregate;
}

// The look-back of the tile in metadata slot ``slot``, by warp 0: it sums
// what comes before the tile, the aggregates of its group's earlier tiles
// (lane l the group's tile l) and the totals of the earlier groups (lane
// l the groups l, l + 32, ...).  look_start starts the reads; look_finish
// spins on each until it holds this generation's value (a group's total
// once all its tiles are in), sums them, and has the last tile move count
// and dropped.
struct Look {
  uint32_t tile, group;
  unsigned long long desc, total;  // the lane's first reads, in flight
};

template <int kFront>
__device__ __forceinline__ Look look_start(const Args& a,
                                           const Shared<kFront>& sm,
                                           int slot) {
  const uint32_t lane = threadIdx.x & (kWarp - 1);
  Look lk;
  lk.tile = sm.tiles[slot];
  lk.group = lk.tile / kGroup;
  const uint32_t mate = lk.group * kGroup + lane;  // a tile of the group
  volatile unsigned long long* const desc = a.scratch + 2;
  lk.desc = mate < lk.tile ? desc[mate] : 0ull;
  lk.total = lane < lk.group
                 ? *static_cast<volatile unsigned long long*>(
                       group_totals(a, sm.gen) + lane)
                 : 0ull;
  return lk;
}

template <int kFront>
__device__ __forceinline__ void look_finish(const Args& a, Shared<kFront>& sm,
                                            int slot, Look lk) {
  const int lane = threadIdx.x & (kWarp - 1);
  const uint32_t gen = sm.gen;
  volatile unsigned long long* const desc = a.scratch + 2;
  unsigned long long* const totals = group_totals(a, gen);
  uint32_t sum = 0u;
  for (uint32_t g = lane; g < lk.group; g += kWarp) {
    volatile unsigned long long* const total = totals + g;
    unsigned long long t = g == static_cast<uint32_t>(lane) ? lk.total
                                                            : *total;
    while ((t >> 32) != kGroup) {
      __nanosleep(kSpinNs);
      t = *total;
    }
    sum += static_cast<uint32_t>(t);
  }
  const uint32_t mate = lk.group * kGroup + lane;
  if (mate < lk.tile) {
    unsigned long long d = lk.desc;
    while ((d >> 34) != gen || ((d >> 32) & 3ull) == 0ull) {
      __nanosleep(kSpinNs);
      d = desc[mate];
    }
    sum += static_cast<uint32_t>(d);
  }
#pragma unroll
  for (int step = kWarp / 2; step > 0; step /= 2) {
    sum += __shfl_xor_sync(0xffffffffu, sum, step);
  }
  if (lane != 0) return;
  sm.exclusive[slot] = sum;
  if (lk.tile == a.n_tiles - 1) {
    // Every tile has read count (and the generation): move count and
    // dropped, and open the next generation.
    __threadfence();
    const long long total =
        static_cast<long long>(sum) + sm.aggregates[slot];
    const long long old_count = sm.count;
    long long new_count = old_count + total;
    if (new_count > a.capacity) new_count = a.capacity;
    const uint32_t lost =
        static_cast<uint32_t>(total - (new_count - old_count));
    *a.dropped =
        static_cast<int32_t>(static_cast<uint32_t>(*a.dropped) + lost);
    *a.count = static_cast<int32_t>(new_count);
    *reinterpret_cast<volatile unsigned long long*>(a.scratch + 1) =
        (gen + 1u) & kGenMask;
  }
}

// Stage the rows of this thread's events of the tile in metadata slot
// ``slot`` (codes in input buffer ``buf``) into ``sm.early[slot]``, for a
// tile with at most kEarlyRows events: a row does not depend on its slot,
// so its loads overlap the look-back of the tile before.
template <int kFront, typename IncT, typename EpochT>
__device__ __forceinline__ void stage_own(const Args& a, Shared<kFront>& sm,
                                          int buf, int slot, uint32_t tile) {
  constexpr int kRow = Shared<kFront>::kRowLanes;
  const int tid = threadIdx.x;
  const int32_t* const subjects =
      a.cols <= kSubjectSlots ? sm.subjects : a.subject_ids;
  const uint8_t* const codes =
      reinterpret_cast<const uint8_t*>(&sm.in[buf][0][tid * kPer]);
  uint32_t k = sm.offsets[slot][tid];
#pragma unroll
  for (int g = 0; g < kMaskWords; ++g) {
#pragma unroll 1
    for (uint32_t m = sm.masks[slot][tid][g]; m != 0u; m &= m - 1u, ++k) {
      const uint32_t i = 32u * g + __ffs(m) - 1;
      build_row<kFront, IncT, EpochT>(a, sm.early[slot] + k * kRow, codes[i],
                                      tile * kTile + tid * kPer + i,
                                      subjects);
    }
  }
}

// Write the rows of the tile in metadata slot ``slot`` (its codes in input
// buffer ``buf``), kStageRows at a time: thread t builds rows lo + t,
// lo + t + 256, ... (the owner of event k by binary search over the
// offsets, its cell by the owner's masks), stages them in shared memory,
// then the block stores them as consecutive words (a tile with at most
// kEarlyRows events has its rows staged already).
template <int kFront, typename IncT, typename EpochT>
__device__ __forceinline__ void write_rows(const Args& a, Shared<kFront>& sm,
                                           int buf, int slot) {
  constexpr int kRow = Shared<kFront>::kRowLanes;
  const int tid = threadIdx.x;
  const int32_t* const subjects =
      a.cols <= kSubjectSlots ? sm.subjects : a.subject_ids;
  const uint32_t tile = sm.tiles[slot];
  const uint32_t aggregate = sm.aggregates[slot];
  const uint32_t* const offsets = sm.offsets[slot];
  const long long tile_slot =
      static_cast<long long>(sm.count) + sm.exclusive[slot];
  const long long room = a.capacity - tile_slot;
  const uint32_t kept =
      room <= 0 ? 0u : (room < aggregate ? static_cast<uint32_t>(room)
                                         : aggregate);
  if (aggregate <= kEarlyRows) {  // staged while coding
    int32_t* dst = a.lanes + tile_slot * kRow;
    for (int i = tid; i < static_cast<int>(kept) * kRow; i += kThreads) {
      dst[i] = sm.early[slot][i];
    }
    return;
  }
  for (uint32_t lo = 0u; lo < kept; lo += kStageRows) {
    const uint32_t hi = lo + kStageRows < kept ? lo + kStageRows : kept;
    for (uint32_t k = lo + tid; k < hi; k += kThreads) {
      int owner = 0;
#pragma unroll
      for (int step = kThreads / 2; step > 0; step /= 2) {
        if (offsets[owner + step] <= k) owner += step;
      }
      const uint32_t i =
          nth_event(sm.masks[slot][owner], k - offsets[owner]);
      const uint32_t local = owner * kPer + i;
      build_row<kFront, IncT, EpochT>(
          a, sm.rows + (k - lo) * kRow,
          reinterpret_cast<const uint8_t*>(sm.in[buf][0])[local],
          tile * kTile + local, subjects);
    }
    __syncthreads();
    const int words = static_cast<int>(hi - lo) * kRow;
    int32_t* dst = a.lanes + (tile_slot + lo) * kRow;
    for (int i = tid; i < words; i += kThreads) dst[i] = sm.rows[i];
    __syncthreads();
  }
}

// The persistent loop: draw a tile, copy it in, work on it (drawing and
// copying in the next as soon as this one has published).
template <int kFront, typename IncT, typename EpochT>
__device__ __forceinline__ void trace_blocks(const Args& a) {
  extern __shared__ __align__(16) unsigned char shared_raw[];
  Shared<kFront>& sm = *reinterpret_cast<Shared<kFront>*>(shared_raw);
  const int tid = threadIdx.x;
  if (tid == 0) {
    keep_next(a, draw(a), sm.next);
  }
  if (!a.self_subject && a.cols <= kSubjectSlots) {
    for (uint32_t i = tid; i < a.cols; i += kThreads) {
      sm.subjects[i] = __ldg(a.subject_ids + i);
    }
  }
  if (tid == kWarp) {
    sm.gen = static_cast<uint32_t>(
                 *reinterpret_cast<volatile unsigned long long*>(
                     a.scratch + 1)) &
             kGenMask;
    sm.count = *reinterpret_cast<volatile int32_t*>(a.count);
  }
  __syncthreads();
  clear_next_totals(a, sm.gen);
  // Three input buffers: the tile being coded, the one whose rows are
  // written (a step behind, so its look-back waits out the coding of the
  // next), and the next one being copied in.
  uint32_t tile = sm.next;
  if (tile < a.n_tiles) prefetch<kFront>(a, sm, 0, tile);
  int buf = 0, slot = 0;
  bool pending = false;  // a coded tile whose rows are still to write
  while (tile < a.n_tiles || pending) {
    cp_async_wait_all();
    __syncthreads();  // the tile's copies are visible; the last step done
    const bool coding = tile < a.n_tiles;
    const uint32_t aggregate =
        coding ? code_tile<kFront, IncT, EpochT>(a, sm, buf, slot, tile) : 0u;
    const bool look = pending && tid < kWarp;
    Look lk;
    if (look) lk = look_start<kFront>(a, sm, slot ^ 1);
    if (coding && aggregate <= kEarlyRows) {
      stage_own<kFront, IncT, EpochT>(a, sm, buf, slot, tile);
    }
    if (look) look_finish<kFront>(a, sm, slot ^ 1, lk);
    __syncthreads();  // the next tile drawn; the pending one's prefix
    const uint32_t next = coding ? sm.next : a.n_tiles;
    if (next < a.n_tiles) prefetch<kFront>(a, sm, (buf + 1) % 3, next);
    if (pending) {
      write_rows<kFront, IncT, EpochT>(a, sm, (buf + 2) % 3, slot ^ 1);
    }
    pending = coding;
    tile = next;
    buf = (buf + 1) % 3;
    slot ^= 1;
  }
}

template <typename IncT, typename EpochT>
__global__ void __launch_bounds__(kThreads)
    trace_observe_kernel(const Args a) {
  trace_blocks<kObserve, IncT, EpochT>(a);
}

template <typename IncT>
__global__ void __launch_bounds__(kThreads) trace_record_kernel(const Args a) {
  trace_blocks<kRecord, IncT, NoEpoch>(a);
}

template <typename KeyT, typename EpochT>
__global__ void __launch_bounds__(kThreads)
    provenance_observe_kernel(const Args a) {
  trace_blocks<kProvenance, KeyT, EpochT>(a);
}

bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Launch ``kernel`` persistent: as many blocks as are resident (at most
// one a tile), with its shared memory opted in.  The resident count is
// asked once a device and kept.
template <int kFront>
int launch_persistent(void (*kernel)(Args), int (&resident)[kMaxDevices],
                      const Args& a, cudaStream_t s) {
  constexpr size_t kBytes = sizeof(Shared<kFront>);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (resident[device] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(kBytes));
    }
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                         kThreads, kBytes);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    resident[device] = sms * (per_sm > 0 ? per_sm : 1);
  }
  const unsigned int grid = a.n_tiles < static_cast<uint32_t>(resident[device])
                                ? a.n_tiles
                                : static_cast<uint32_t>(resident[device]);
  kernel<<<grid, kThreads, kBytes, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename IncT, typename EpochT>
int launch_observe(const Args& a, cudaStream_t s) {
  static int resident[kMaxDevices] = {};
  return launch_persistent<kObserve>(trace_observe_kernel<IncT, EpochT>,
                                     resident, a, s);
}

template <typename IncT>
int launch_record(const Args& a, cudaStream_t s) {
  static int resident[kMaxDevices] = {};
  return launch_persistent<kRecord>(trace_record_kernel<IncT>, resident, a,
                                    s);
}

template <typename KeyT, typename EpochT>
int launch_provenance(const Args& a, cudaStream_t s) {
  static int resident[kMaxDevices] = {};
  return launch_persistent<kProvenance>(
      provenance_observe_kernel<KeyT, EpochT>, resident, a, s);
}

}  // namespace

// The cells a tile takes: the wrapper sizes the scratch as two words, one
// descriptor a tile and one group total a tile (at most), zeroed once,
// and passes the tiles it holds.
extern "C" int trace_tile_cells() { return kTile; }

// Each entry launches its instance on `stream` and returns the launch's
// cudaError_t (0 = success).  scratch_tiles must be at least the launch's
// tiles (n_cells / 8,192, rounded up).  trace_record's subject_ids may be
// null: each row's subject is then its observer.  inc_bytes is 4 or 2;
// epoch_bytes 0 (no epoch lane: prev_epoch and new_epoch are not read), 4
// or 2.  n_cells must be below 2^31 (the wrapper checks).
extern "C" int trace_observe_launch(
    const void* prev_status, const void* new_status, const void* new_inc,
    const void* prev_epoch, const void* new_epoch, const void* self_inc,
    const void* leave_at, const void* subject_ids, void* first_suspect,
    void* first_removed, void* lanes, void* count, void* dropped,
    void* scratch, long long scratch_tiles, long long n_cells, int cols,
    long long capacity, int round_idx, int observer_offset, int inc_bytes,
    int epoch_bytes, void* stream) {
  if (n_cells <= 0) return 0;
  Args a{};
  a.codes = static_cast<const int8_t*>(prev_status);
  a.new_status = static_cast<const int8_t*>(new_status);
  a.incs = new_inc;
  a.prev_epoch = epoch_bytes ? prev_epoch : nullptr;
  a.new_epoch = epoch_bytes ? new_epoch : nullptr;
  a.self_inc = static_cast<const int32_t*>(self_inc);
  a.leave_at = static_cast<const int32_t*>(leave_at);
  a.subject_ids = static_cast<const int32_t*>(subject_ids);
  a.first_suspect = static_cast<int32_t*>(first_suspect);
  a.first_removed = static_cast<int32_t*>(first_removed);
  a.lanes = static_cast<int32_t*>(lanes);
  a.count = static_cast<int32_t*>(count);
  a.dropped = static_cast<int32_t*>(dropped);
  a.scratch = static_cast<unsigned long long*>(scratch);
  a.scratch_tiles = static_cast<uint32_t>(scratch_tiles);
  a.n_cells = static_cast<uint32_t>(n_cells);
  a.rows = static_cast<uint32_t>(n_cells / cols);
  a.cols = static_cast<uint32_t>(cols);
  a.n_tiles = static_cast<uint32_t>((n_cells + kTile - 1) / kTile);
  a.capacity = capacity;
  a.round_idx = static_cast<int32_t>(round_idx);
  a.observer_offset = static_cast<uint32_t>(observer_offset);
  a.aligned = aligned16(prev_status) && aligned16(new_status);
  a.epoch_aligned = aligned16(a.prev_epoch) && aligned16(a.new_epoch);
  const auto s = static_cast<cudaStream_t>(stream);
  if (inc_bytes == 4) {
    if (epoch_bytes == 4) return launch_observe<int32_t, int32_t>(a, s);
    if (epoch_bytes == 2) return launch_observe<int32_t, int16_t>(a, s);
    return launch_observe<int32_t, NoEpoch>(a, s);
  }
  if (epoch_bytes == 4) return launch_observe<int16_t, int32_t>(a, s);
  if (epoch_bytes == 2) return launch_observe<int16_t, int16_t>(a, s);
  return launch_observe<int16_t, NoEpoch>(a, s);
}

extern "C" int trace_record_launch(const void* codes, const void* incs,
                                   const void* subject_ids, void* lanes,
                                   void* count, void* dropped, void* scratch,
                                   long long scratch_tiles,
                                   long long n_cells, int cols,
                                   long long capacity, int round_idx,
                                   int observer_offset, int inc_bytes,
                                   void* stream) {
  if (n_cells <= 0) return 0;
  Args a{};
  a.codes = static_cast<const int8_t*>(codes);
  a.incs = incs;
  a.subject_ids = static_cast<const int32_t*>(subject_ids);
  a.lanes = static_cast<int32_t*>(lanes);
  a.count = static_cast<int32_t*>(count);
  a.dropped = static_cast<int32_t*>(dropped);
  a.scratch = static_cast<unsigned long long*>(scratch);
  a.scratch_tiles = static_cast<uint32_t>(scratch_tiles);
  a.n_cells = static_cast<uint32_t>(n_cells);
  a.rows = static_cast<uint32_t>(n_cells / cols);
  a.cols = static_cast<uint32_t>(cols);
  a.n_tiles = static_cast<uint32_t>((n_cells + kTile - 1) / kTile);
  a.capacity = capacity;
  a.round_idx = static_cast<int32_t>(round_idx);
  a.observer_offset = static_cast<uint32_t>(observer_offset);
  a.aligned = aligned16(codes);
  a.self_subject = subject_ids == nullptr;
  const auto s = static_cast<cudaStream_t>(stream);
  return inc_bytes == 4 ? launch_record<int32_t>(a, s)
                        : launch_record<int16_t>(a, s);
}

// Keys: key_bytes 4 (int32) or 2 (int16), the three planes of one dtype;
// join_at is the world's [N] column, indexed by subject id; ping_req is
// read only with split_ping_req.  lanes is [capacity, 6].
extern "C" int provenance_observe_launch(
    const void* prev_status, const void* new_status, const void* fd,
    const void* gossip, const void* sync, const void* prev_epoch,
    const void* new_epoch, const void* prev_self_inc,
    const void* new_self_inc, const void* leave_at, const void* join_at,
    const void* ping_req, const void* subject_ids, void* lanes, void* count,
    void* dropped, void* scratch, long long scratch_tiles, long long n_cells,
    int cols, long long capacity, int round_idx, int observer_offset,
    int key_bytes, int epoch_bytes, int dead_bit, int split_ping_req,
    void* stream) {
  if (n_cells <= 0) return 0;
  Args a{};
  a.codes = static_cast<const int8_t*>(prev_status);
  a.new_status = static_cast<const int8_t*>(new_status);
  a.fd = fd;
  a.gossip = gossip;
  a.sync = sync;
  a.prev_epoch = epoch_bytes ? prev_epoch : nullptr;
  a.new_epoch = epoch_bytes ? new_epoch : nullptr;
  a.prev_self_inc = static_cast<const int32_t*>(prev_self_inc);
  a.self_inc = static_cast<const int32_t*>(new_self_inc);
  a.leave_at = static_cast<const int32_t*>(leave_at);
  a.join_at = static_cast<const int32_t*>(join_at);
  a.ping_req = static_cast<const uint8_t*>(ping_req);
  a.subject_ids = static_cast<const int32_t*>(subject_ids);
  a.lanes = static_cast<int32_t*>(lanes);
  a.count = static_cast<int32_t*>(count);
  a.dropped = static_cast<int32_t*>(dropped);
  a.scratch = static_cast<unsigned long long*>(scratch);
  a.scratch_tiles = static_cast<uint32_t>(scratch_tiles);
  a.n_cells = static_cast<uint32_t>(n_cells);
  a.rows = static_cast<uint32_t>(n_cells / cols);
  a.cols = static_cast<uint32_t>(cols);
  a.n_tiles = static_cast<uint32_t>((n_cells + kTile - 1) / kTile);
  a.capacity = capacity;
  a.round_idx = static_cast<int32_t>(round_idx);
  a.observer_offset = static_cast<uint32_t>(observer_offset);
  a.aligned = aligned16(prev_status) && aligned16(new_status);
  a.epoch_aligned = aligned16(a.prev_epoch) && aligned16(a.new_epoch);
  a.dead_bit = dead_bit;
  a.split_ping_req = split_ping_req != 0;
  const auto s = static_cast<cudaStream_t>(stream);
  if (key_bytes == 4) {
    if (epoch_bytes == 4) return launch_provenance<int32_t, int32_t>(a, s);
    if (epoch_bytes == 2) return launch_provenance<int32_t, int16_t>(a, s);
    return launch_provenance<int32_t, NoEpoch>(a, s);
  }
  if (epoch_bytes == 4) return launch_provenance<int16_t, int32_t>(a, s);
  if (epoch_bytes == 2) return launch_provenance<int16_t, int16_t>(a, s);
  return launch_provenance<int16_t, NoEpoch>(a, s);
}
