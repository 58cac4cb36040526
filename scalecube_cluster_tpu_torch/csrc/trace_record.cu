// trace_record: one round's coded cells compacted, in order, into the
// membership event trace, one launch a round.
//
// The reference computes the record in XLA (scalecube_cluster_tpu/
// telemetry/trace.py:254-301, record_events_batch): a cumsum over the
// flattened [N, K] code plane assigns each event its slot, one scatter
// writes the rows, and the count and overflow are bumped.  It has no
// Pallas counterpart.  In eager PyTorch the order-preserving compaction
// needs either a host read of the event count every round (nonzero) or a
// scatter over all N*K cells with the silent ones sent to one drop row;
// this kernel does neither.
//
// Inputs: codes [N, K] int8 (0 = no event, else event type + 1),
// incs [N, K] int32 (the event incarnations), prefix [N*K] int32 (the
// inclusive prefix sum of codes > 0, cell order), subject_ids [K] int32,
// the round, the observer offset.  In place: lanes [capacity, 5] int32,
// count and dropped (int32 scalars on the device).
//
// Work: the cell c holding an event writes the row (round, observer,
// subject, code - 1, inc) at slot count + prefix[c] - 1 when that slot is
// below the capacity, so the rows land in cell order (round-major across
// launches, observer-major within one) exactly as the reference orders
// them; a silent cell writes nothing.  count and dropped then become
// min(count + total, capacity) and dropped + total - (new count - count),
// total = prefix[N*K - 1]: overflow is counted, never cut silently.
// count is read on the device only.
//
// Every block reads count before any block may change it: thread 0 of
// each block loads count into shared memory, and after its block's
// writes takes a ticket (atomicAdd on a device word); the block drawing
// the last ticket updates count and dropped and resets the ticket word.
// The ticket orders the counter update after every read of count; it
// does not order slots, which come from the prefix.  The ticket word is
// shared by launches on one stream, one after another.
//
// Bound: bytes.  The codes are read in full (1 B a cell); the prefix and
// the incarnation only at event cells (8 B an event); 20 B written per
// recorded event.  Design: each warp takes tiles of 512 cells (a grid of
// at most 8 blocks an SM striding over them, so at most that many
// tickets a launch); its 32 lanes read the tile's codes in one 16-byte
// load each and skip a silent tile at once (a ballot).  In a tile where
// fewer than 8 lanes hold events, each such lane writes its own 16
// cells' events from its registers (a sparse round's tiles); otherwise
// lane l takes cells l, l + 32, ... of the tile, so a warp's prefix and
// incarnation reads and its rows' writes fall on consecutive cells and
// slots (a dense round's).  A partial last tile, or codes not 16-byte
// aligned, are read a byte at a time.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kLanes = 5;
constexpr int kWarp = 32;
constexpr int kChunk = 16;            // cells a lane tests in one load
constexpr int kTile = kWarp * kChunk;  // cells a warp takes at a time
constexpr int kDenseLanes = 8;  // lanes with events from which a tile is
                                // written cell-interleaved

struct Record {
  const int32_t* incs;
  const int32_t* prefix;
  const int32_t* subject_ids;
  int32_t* lanes;
  long long capacity;
  int cols;
  int32_t round_idx;
  int32_t observer_offset;
};

__device__ __forceinline__ void write_event(const Record& r, int32_t base,
                                            long long cell, int32_t code) {
  const long long slot = static_cast<long long>(base) + r.prefix[cell] - 1;
  if (slot >= r.capacity) return;
  const long long row = cell / r.cols;
  const int col = static_cast<int>(cell - row * r.cols);
  int32_t* out = r.lanes + slot * kLanes;
  out[0] = r.round_idx;
  out[1] = static_cast<int32_t>(static_cast<uint32_t>(row) +
                                static_cast<uint32_t>(r.observer_offset));
  out[2] = r.subject_ids[col];
  out[3] = code - 1;
  out[4] = r.incs[cell];
}

__global__ void trace_record_kernel(const int8_t* __restrict__ codes,
                                    Record r, int32_t* count,
                                    int32_t* dropped, unsigned int* tickets,
                                    long long n_cells, bool aligned) {
  __shared__ int32_t base;
  __shared__ bool last_block;
  if (threadIdx.x == 0) base = *reinterpret_cast<volatile int32_t*>(count);
  __syncthreads();

  const int lane = threadIdx.x & (kWarp - 1);
  const long long n_tiles = (n_cells + kTile - 1) / kTile;
  const long long n_warps =
      static_cast<long long>(gridDim.x) * (blockDim.x / kWarp);
  for (long long tile =
           (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) /
           kWarp;
       tile < n_tiles; tile += n_warps) {
    const long long start = tile * kTile;
    const long long mine = start + lane * kChunk;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    const bool whole = aligned && start + kTile <= n_cells;
    if (whole) {
      v = *reinterpret_cast<const uint4*>(codes + mine);
    } else {
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        const uint32_t bits =
            mine + i < n_cells
                ? static_cast<uint32_t>(static_cast<uint8_t>(codes[mine + i]))
                      << (8 * (i % 4))
                : 0u;
        if (i < 4) {
          v.x |= bits;
        } else if (i < 8) {
          v.y |= bits;
        } else if (i < 12) {
          v.z |= bits;
        } else {
          v.w |= bits;
        }
      }
    }
    const unsigned int active =
        __ballot_sync(0xffffffffu, (v.x | v.y | v.z | v.w) != 0u);
    if (active == 0u) continue;
    if (__popc(active) < kDenseLanes) {
      // Few events: each lane writes its own chunk's from its registers.
      const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        if (words[w] == 0u) continue;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int32_t code =
              static_cast<int8_t>((words[w] >> (8 * b)) & 0xffu);
          if (code > 0) write_event(r, base, mine + w * 4 + b, code);
        }
      }
      continue;
    }
    // Many: lane l takes cells l, l + 32, ... so the warp's reads and
    // row writes fall on consecutive cells and slots.
    for (int j = 0; j < kChunk; ++j) {
      const long long cell = start + j * kWarp + lane;
      if (cell >= n_cells) break;
      const int32_t code = codes[cell];
      if (code > 0) write_event(r, base, cell, code);
    }
  }

  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    const unsigned int ticket = atomicAdd(tickets, 1u);
    last_block = (ticket == gridDim.x - 1);
  }
  __syncthreads();
  if (last_block && threadIdx.x == 0) {
    const long long total = r.prefix[n_cells - 1];
    const long long old_count = base;
    long long new_count = old_count + total;
    if (new_count > r.capacity) new_count = r.capacity;
    const uint32_t lost =
        static_cast<uint32_t>(total - (new_count - old_count));
    *dropped = static_cast<int32_t>(static_cast<uint32_t>(*dropped) + lost);
    *count = static_cast<int32_t>(new_count);
    *tickets = 0u;
  }
}

int max_blocks() {
  static int sms = 0;
  if (sms == 0) {
    int device = 0;
    if (cudaGetDevice(&device) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                               device) != cudaSuccess || sms <= 0) {
      sms = 132;
    }
  }
  return sms * kBlocksPerSm;
}

}  // namespace

extern "C" int trace_record_launch(const void* codes, const void* incs,
                                   const void* prefix,
                                   const void* subject_ids, void* lanes,
                                   void* count, void* dropped, void* tickets,
                                   long long n_cells, int cols,
                                   long long capacity, int round_idx,
                                   int observer_offset, void* stream) {
  if (n_cells <= 0) return 0;
  const bool aligned = reinterpret_cast<uintptr_t>(codes) % 16 == 0;
  const long long n_tiles = (n_cells + kTile - 1) / kTile;
  long long blocks = (n_tiles * kWarp + kThreads - 1) / kThreads;
  if (blocks > max_blocks()) blocks = max_blocks();
  Record r{static_cast<const int32_t*>(incs),
           static_cast<const int32_t*>(prefix),
           static_cast<const int32_t*>(subject_ids),
           static_cast<int32_t*>(lanes),
           capacity,
           cols,
           static_cast<int32_t>(round_idx),
           static_cast<int32_t>(observer_offset)};
  trace_record_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(codes), r, static_cast<int32_t*>(count),
      static_cast<int32_t*>(dropped), static_cast<unsigned int*>(tickets),
      n_cells, aligned);
  return static_cast<int>(cudaGetLastError());
}
