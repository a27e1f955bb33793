// Mesh-tier kernels: collectives for ranks that own distinct devices
// (the port of coll/tpu).  Each collective is run by one controller
// thread that holds every member's tensor, each on its member's
// device; a launch reads the other members' buffers through their
// pointers (peer access on a host whose cards are joined by NVLink,
// plain loads when the logical devices share one card).
//
// K6 mesh_fold replaces the reductions of the reference package's mesh
// programs: _build_mesh_collective (coll/device.py:997: psum, pmax,
// pmin, all_gather + fold, psum_scatter), the segring and segrd
// schedules of _build_seg_kernel (coll/pipeline.py:192) and their
// batched form _compile_mesh (coll/plan.py:257), and the group
// reductions of the fused mesh batch (coll/fusion.py:257).  A launch
// on one card serves a destination table: for each job (out, lo, len)
// it folds the N members' inputs over the elements [lo, lo + len) —
// the stripe that job's device owns — into out: a reduce-scatter by
// pulls, ONE launch a card for every destination on it.  A job reads
// its own set of N inputs (job.in0: the first of its pointers), so one
// launch also folds several sets: the group buffers of every session a
// cross-session combined dispatch carries (the reference's
// _build_fused_mesh_multi, coll/fusion.py:310), each job a stripe of
// one session's buffer.  The allgather
// half that follows is K2 in peer mode (stacked.cu).  The reference
// circulates partial sums hop by hop (P - 1 ppermutes a phase); here
// one pull computes what the hops compute, in the same order, so that
// every element is the same chain of binary ops as the reference's:
//   * linear: a left fold over order[(rot + k) % N], k = 0..N-1, where
//     rot = ((g % ring_seg) / ring_m) for the segring schedule (stripe
//     c of a segment is the left fold over ranks c, c+1, ..., c-1) and
//     0 otherwise (rank order: psum and the gather folds);
//   * tree: the balanced tree of segrd over order[0..N-1] (N a power
//     of two), each node op(lower half, upper half), evaluated as a
//     binary counter over a small stack, V lanes at once.
// The op and dtype templates are reduce_ops.cuh's, so the semantics
// are K1's: NaN, wrapping, half-precision accumulation.
//
// K7 slot_pack replaces _build_pack (coll/fusion.py:231): one launch
// packs one rank's slots of one fused group into one buffer through a
// slot table, writing zeros for the slots flagged as non-root bcast
// entries.
//
// What bounds them: bytes.  K6 does N-1 operations per N elements
// read; K7 none.  Least time: (bytes read once + bytes written once) /
// the slower of the card's memory (3.35 TB/s on an H100) and, for
// reads from another card, NVLink (450 GB/s each way).
//
// K6's design for the H100 (bulk.cuh): a persistent grid, blocks per
// SM from the occupancy API at the ring's shared memory, walks one
// flat tile list over every job of the launch (a prefix table,
// job[].first_tile, maps a tile to its job).  A tile is up to
// ``tile`` elements of one job, read from all N inputs.  Each block
// holds a ring of ``stages`` stages in dynamic shared memory, a stage
// N slices of tile * sizeof(T) bytes.  One producer thread issues N
// bulk copies a tile into a stage, arming the stage's full barrier
// with N slices of bytes; four consumer warps wait on it, fold from
// shared memory 16 bytes a thread in the reference's order (segring's
// rotation once a tile when the tile lies inside one ring_m stripe,
// else once a vector; segrd's tree on V lanes), store 16 bytes a
// thread, and release the stage on its empty barrier.  So every SM
// keeps stages * N slices of bytes a block in flight with one thread,
// whatever the stripe, and a card takes one launch for all of its
// destinations instead of one each.  A job whose inputs and output are
// not congruent modulo 16 bytes (or, segring, whose vectors would
// straddle a stripe) is folded element by element from device memory
// by the consumers; so are an aligned job's head and tail that miss a
// whole 16-byte vector, as one edge tile after its bulk tiles.  The
// wrapper decides which (mesh.py _fold_job); the kernel does not retry
// anything another way.  A peer's input over NVLink is read by the
// same bulk copies (a global address like local memory; exact on four
// H100s joined by NVLink).
//
// Sizes (mesh.py FOLD_TILE, FOLD_STAGES), from the sweep of
// ompi_tpu_torch/tools/tile_sweep.py on an H100 (1, 2 and 4 KiB a
// member by 2, 3 and 4 stages): 2 KiB a member and 2 stages, 32 KiB of
// ring at N = 8 (the wrapper shrinks the slice as N grows, so that a
// ring stays within 192 KiB); more blocks an SM beat deeper rings.
// ptxas (sm_90a): 40-64 registers, no static shared memory, a stack of
// 128-304 bytes (the tree's V-lane counter and the edge path's), and
// 8-44 bytes of spills in 31 of the 110 (dtype, op) instantiations
// (64-bit, 16-bit and complex types; none for float32).
//
// K7's design for the H100: a plan a slot (mesh.py _pack_plan), not one
// width for the whole launch.  A slot row holds the head bytes ahead of
// the slot's first 16-byte-aligned output address, a body of units of
// the widest width w in {16, 8, 4, 2, 1} at which the source and the
// output are both aligned there (16 for a zero slot: stores only), and
// the tail bytes; so one odd slot narrows only itself.  A block serves
// a fixed span of one slot's body, PACK_UNITS 16-byte units of bytes.
// Its slot is b / each where every slot takes as many blocks (a fused
// batch of one size: no table read before the slot's own record; 11 %
// faster than the lookup at 32 x 64 KiB, tools/kernel_ab.py), else
// found by each warp with two ballots over the table's compact
// first_block prefix.  Each thread loads all of its units of a round
// into registers first (PACK_U 16-byte units, or 4 PACK_U units of a
// narrower width: the same registers) through __restrict__ pointers
// with the streaming hint (ld.global.cs: the sources are read once),
// and only then stores them, so that a thread keeps PACK_U * 16 bytes
// in flight instead of one unit a round trip; the packed buffer keeps
// the default store policy (K6 reads it right after).  The heads and tails, at most 15
// bytes each, go byte by byte on the slot's first block after its
// body.  The width is a switch on the slot row, uniform in a block.
// Sizes (PACK_THREADS, PACK_UNITS = mesh.py UNITS, PACK_U), timed on an
// H100 with ompi_tpu_torch/tools/tile_sweep.py, which builds copies of
// this file with -DPACK_UNITS / -DPACK_U, and tools/kernel_ab.py: 128
// threads a block (256 read 5 % slower); PACK_UNITS 256 at PACK_U 2,
// the least summed time over 256, 512, 1024 x 2, 4, 8 (PERF.md section
// 6): 512 blocks of 4 KiB for a fused flush's 32 x 64 KiB.
// ptxas (sm_90a), K7: 40 registers, no stack, no spills, no static
// shared memory.
//
// Plain C interface, loaded with ctypes: each entry returns the
// cudaError_t of its launch (0 on success).

#include "bulk.cuh"
#include "reduce_ops.cuh"

#define MESH_MAX_PTRS 128
#define FOLD_MAX_JOBS 64
#define FOLD_MAX_STAGES 8
#define FOLD_CONS 128  // consumer threads (four warps) of a K6 block
#define FOLD_THREADS (32 + FOLD_CONS)
#define PACK_MAX_SLOTS 64
#define PACK_THREADS 128
#ifndef PACK_UNITS
#define PACK_UNITS 256  // 16-byte units of body bytes one K7 block covers
#endif
#ifndef PACK_U
#define PACK_U 2  // 16-byte units a K7 thread loads before it stores
#endif

struct FoldJob {
  void* out;       // len elements: out[k] = fold at element lo + k
  long long lo;    // first element (an index into every input)
  long long len;   // elements of this job
  int first_tile;  // prefix table: the job's first tile in the launch
  int head;        // elements ahead of the first whole 16-byte vector;
                   // -1: the whole job on the edge path
  int in0;         // the job's inputs: in[in0], ..., in[in0 + nin - 1]
};

struct FoldArgs {
  const void* in[MESH_MAX_PTRS];  // one set of nin inputs, or several
  FoldJob job[FOLD_MAX_JOBS];
  long long ring_seg;  // segring: segment length; 0: no rotation
  long long ring_m;    // segring: stripe length inside a segment
  long long tile;      // elements of one member a tile (x sizeof(T): a
                       // multiple of 16 bytes)
  int nin;
  int tree;    // 1: balanced tree over order[] (nin a power of 2)
  int njobs;
  int ntiles;  // every job's tiles
  int stages;  // the ring's stages (1 to FOLD_MAX_STAGES)
  unsigned char order[MESH_MAX_PTRS];
};

struct PackSlot {
  const unsigned char* src;  // the slot's bytes; null: write zeros (a
                             // non-root bcast entry)
  long long off;    // byte offset of the slot in the packed buffer
  long long units;  // body units of ``width`` bytes, after the head
  int head;         // bytes ahead of the body (0-15)
  int tail;         // bytes after the body (0-15)
  int width;        // bytes a body unit holds: 16, 8, 4, 2 or 1
};

struct PackArgs {
  int first_block[PACK_MAX_SLOTS];  // prefix table: each slot's first
                                    // block (nondecreasing, from 0)
  PackSlot slot[PACK_MAX_SLOTS];
  unsigned char* out;
  int nslots;
  int each;  // every slot's blocks when all slots take as many (block
             // b's slot is then b / each, no lookup); else 0
};
static_assert(PACK_MAX_SLOTS == 64, "slot_pack_kernel's lookup takes two ballots");

template <typename T, int V>
struct alignas(sizeof(T) * V) MVec {
  T x[V];
};

__device__ __forceinline__ int rotation(const FoldArgs& a, long long g) {
  if (a.ring_m == 0) return 0;
  return (int)(((g % a.ring_seg) / a.ring_m) % a.nin);
}

// One element from device memory, linear fold or tree (the edge path).
template <typename T, int OP>
__device__ __forceinline__ T fold_one(const FoldArgs& a, int in0, long long g) {
  using Tr = Traits<T>;
  using A = typename Tr::A;
  const int n = a.nin;
  const void* const* in = a.in + in0;
  if (a.tree) {
    A stack[8];
    int top = 0;
    for (int r = 0; r < n; ++r) {
      A v = first<OP>(Tr::load(reinterpret_cast<const T*>(in[a.order[r]])[g]));
      for (int c = r; c & 1; c >>= 1) v = apply<OP>(stack[--top], v);
      stack[top++] = v;
    }
    return Tr::store(stack[0]);
  }
  int k = rotation(a, g);
  A acc = first<OP>(Tr::load(reinterpret_cast<const T*>(in[a.order[k]])[g]));
  for (int s = 1; s < n; ++s) {
    if (++k == n) k = 0;
    acc = apply<OP>(acc, Tr::load(reinterpret_cast<const T*>(in[a.order[k]])[g]));
  }
  return Tr::store(acc);
}

// Tile t of a launch: its job and span.  kind 1: a bulk tile, elements
// [e0, e1) of the job, whole vectors; kind 0: an edge-path tile, the
// elements [e0, e1); kind 2: an aligned job's edge tile, the elements
// [0, e0) and [e1, len).  (mesh.py _fold_span mirrors this.)
struct FoldSpan {
  int job;
  int kind;
  long long e0, e1;
};

template <int V>
__device__ __forceinline__ FoldSpan fold_span(const FoldArgs& a, int t) {
  int lo = 0, hi = a.njobs - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (a.job[mid].first_tile <= t) lo = mid; else hi = mid - 1;
  }
  const FoldJob& jb = a.job[lo];
  const long long k = t - jb.first_tile;
  FoldSpan sp;
  sp.job = lo;
  if (jb.head < 0) {
    sp.kind = 0;
    sp.e0 = k * a.tile;
    sp.e1 = sp.e0 + a.tile < jb.len ? sp.e0 + a.tile : jb.len;
    return sp;
  }
  const long long body = (jb.len - jb.head) / V * V;
  const long long nb = (body + a.tile - 1) / a.tile;
  if (k < nb) {
    sp.kind = 1;
    sp.e0 = jb.head + k * a.tile;
    sp.e1 = jb.head + ((k + 1) * a.tile < body ? (k + 1) * a.tile : body);
  } else {
    sp.kind = 2;
    sp.e0 = jb.head;
    sp.e1 = jb.head + body;
  }
  return sp;
}

// Fold one stage: member m's slice of the tile at st + m * mbytes,
// nvec vectors starting at flat element g0; vector v goes to out[v].
template <typename T, int OP, int V>
__device__ __forceinline__ void fold_stage(const FoldArgs& a,
                                           const unsigned char* st,
                                           long long mbytes, long long g0,
                                           int nvec, MVec<T, V>* out, int tid) {
  using Tr = Traits<T>;
  using A = typename Tr::A;
  using VT = MVec<T, V>;
  const int n = a.nin;
  int rc = 0;
  bool uniform = true;
  if (a.ring_m) {  // segring: one rotation when the tile is inside one stripe
    const long long g1 = g0 + (long long)nvec * V - 1;
    uniform = g0 / a.ring_seg == g1 / a.ring_seg &&
              (g0 % a.ring_seg) / a.ring_m == (g1 % a.ring_seg) / a.ring_m;
    rc = rotation(a, g0);
  }
  for (int v = tid; v < nvec; v += FOLD_CONS) {
    A acc[V];
    if (a.tree) {
      A stk[8][V];
      int top = 0;
      for (int r = 0; r < n; ++r) {
        const VT w = reinterpret_cast<const VT*>(st + a.order[r] * mbytes)[v];
#pragma unroll
        for (int e = 0; e < V; ++e) acc[e] = first<OP>(Tr::load(w.x[e]));
        for (int c = r; c & 1; c >>= 1) {
          --top;
#pragma unroll
          for (int e = 0; e < V; ++e) acc[e] = apply<OP>(stk[top][e], acc[e]);
        }
#pragma unroll
        for (int e = 0; e < V; ++e) stk[top][e] = acc[e];
        ++top;
      }
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = stk[0][e];
    } else {
      int k = uniform ? rc : rotation(a, g0 + (long long)v * V);
      const VT w = reinterpret_cast<const VT*>(st + a.order[k] * mbytes)[v];
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = first<OP>(Tr::load(w.x[e]));
#pragma unroll 4
      for (int s = 1; s < n; ++s) {
        if (++k == n) k = 0;
        const VT x = reinterpret_cast<const VT*>(st + a.order[k] * mbytes)[v];
#pragma unroll
        for (int e = 0; e < V; ++e) acc[e] = apply<OP>(acc[e], Tr::load(x.x[e]));
      }
    }
    VT o;
#pragma unroll
    for (int e = 0; e < V; ++e) o.x[e] = Tr::store(acc[e]);
    out[v] = o;
  }
}

template <typename T, int OP, int V>
__global__ void __launch_bounds__(FOLD_THREADS)
    mesh_fold_tiles(const __grid_constant__ FoldArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + FOLD_MAX_STAGES;
  unsigned char* ring = smem + BAR_BYTES;
  const int S = a.stages;
  const long long mbytes = a.tile * (long long)sizeof(T);  // a member's slice
  const long long sbytes = mbytes * a.nin;                 // a stage
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], FOLD_CONS / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x < 32) {  // the producer: one thread
    if (threadIdx.x != 0) return;
    long long i = 0;  // this block's bulk tiles so far
    for (int t = blockIdx.x; t < a.ntiles; t += gridDim.x) {
      const FoldSpan sp = fold_span<V>(a, t);
      if (sp.kind != 1) continue;
      const int s = (int)(i % S);
      if (i >= S) mbar_wait(smem_u32(&empty[s]), (unsigned)((i / S - 1) & 1));
      const unsigned nb = (unsigned)((sp.e1 - sp.e0) * sizeof(T));
      const uint32_t bar = smem_u32(&full[s]);
      mbar_expect_tx(bar, nb * (unsigned)a.nin);
      const unsigned char* st = ring + s * sbytes;
      const FoldJob& jb = a.job[sp.job];
      const long long off = (jb.lo + sp.e0) * (long long)sizeof(T);
      for (int m = 0; m < a.nin; ++m)
        bulk_g2s(smem_u32(st + m * mbytes),
                 reinterpret_cast<const unsigned char*>(a.in[jb.in0 + m]) + off,
                 nb, bar);
      ++i;
    }
    return;
  }
  const int tid = threadIdx.x - 32;  // the consumers
  long long i = 0;
  for (int t = blockIdx.x; t < a.ntiles; t += gridDim.x) {
    const FoldSpan sp = fold_span<V>(a, t);
    const FoldJob& jb = a.job[sp.job];
    T* out = reinterpret_cast<T*>(jb.out);
    if (sp.kind == 0) {
      for (long long e = sp.e0 + tid; e < sp.e1; e += FOLD_CONS)
        out[e] = fold_one<T, OP>(a, jb.in0, jb.lo + e);
      continue;
    }
    if (sp.kind == 2) {
      const long long nhead = sp.e0, ntail = jb.len - sp.e1;
      for (long long e = tid; e < nhead + ntail; e += FOLD_CONS) {
        const long long x = e < nhead ? e : sp.e1 + (e - nhead);
        out[x] = fold_one<T, OP>(a, jb.in0, jb.lo + x);
      }
      continue;
    }
    const int s = (int)(i % S);
    mbar_wait(smem_u32(&full[s]), (unsigned)((i / S) & 1));
    fold_stage<T, OP, V>(a, ring + s * sbytes, mbytes, jb.lo + sp.e0,
                         (int)((sp.e1 - sp.e0) / V),
                         reinterpret_cast<MVec<T, V>*>(out + sp.e0), tid);
    __syncwarp();
    if ((tid & 31) == 0) mbar_arrive(smem_u32(&empty[s]));
    ++i;
  }
}

template <typename T, int OP>
struct LaunchFold {
  static int run(const FoldArgs* a, cudaStream_t s) {
    constexpr int V = 16 / sizeof(T);
    if ((a->tile * (long long)sizeof(T)) % 16 || a->tile % V)
      return (int)cudaErrorInvalidValue;
    const void* fn = reinterpret_cast<const void*>(&mesh_fold_tiles<T, OP, V>);
    const size_t smem =
        BAR_BYTES + (size_t)a->stages * a->nin * a->tile * sizeof(T);
    const int bps = blocks_per_sm(fn, FOLD_THREADS, smem);
    if (bps <= 0) {
      const int e = (int)cudaGetLastError();
      return e ? e : (int)cudaErrorInvalidConfiguration;
    }
    long long grid = (long long)bps * sm_count();
    if (grid > a->ntiles) grid = a->ntiles;
    mesh_fold_tiles<T, OP, V><<<(unsigned)grid, FOLD_THREADS, smem, s>>>(*a);
    return (int)cudaGetLastError();
  }
};

// Units [begin, end) of one slot's body, L units a thread a round: every
// load of the round issued before its first store.  src null: zeros.
template <typename W, int L>
__device__ __forceinline__ void pack_body(const unsigned char* __restrict__ src,
                                          unsigned char* __restrict__ dst,
                                          long long begin, long long end) {
  const W* __restrict__ s = reinterpret_cast<const W*>(src);
  W* __restrict__ d = reinterpret_cast<W*>(dst);
  for (long long i0 = begin + threadIdx.x; i0 < end;
       i0 += (long long)PACK_THREADS * L) {
    W v[L];
    if (s) {
#pragma unroll
      for (int j = 0; j < L; ++j) {
        const long long i = i0 + (long long)j * PACK_THREADS;
        if (i < end) v[j] = __ldcs(s + i);
      }
    } else {
#pragma unroll
      for (int j = 0; j < L; ++j) v[j] = W();
    }
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const long long i = i0 + (long long)j * PACK_THREADS;
      if (i < end) d[i] = v[j];
    }
  }
}

__global__ void __launch_bounds__(PACK_THREADS)
    slot_pack_kernel(const __grid_constant__ PackArgs a) {
  // the block's slot: b / each where every slot takes as many blocks;
  // else the last whose first block is at most b, found by each warp at
  // once from the compact prefix table
  const int b = (int)blockIdx.x;
  int lo, k;
  if (a.each) {
    lo = b / a.each;
    k = b - lo * a.each;
  } else {
    const int lane = (int)threadIdx.x & 31;
    const unsigned m0 =
        __ballot_sync(~0u, lane < a.nslots && a.first_block[lane] <= b);
    const unsigned m1 =
        __ballot_sync(~0u, lane + 32 < a.nslots && a.first_block[lane + 32] <= b);
    lo = __popc(m0) + __popc(m1) - 1;
    k = b - a.first_block[lo];
  }
  const PackSlot& sl = a.slot[lo];
  const long long per = PACK_UNITS * 16 / sl.width;  // units a block covers
  const long long begin = k * per;
  const long long end = begin + per < sl.units ? begin + per : sl.units;
  const unsigned char* src = sl.src ? sl.src + sl.head : nullptr;
  unsigned char* dst = a.out + sl.off;
  switch (sl.width) {
    case 16: pack_body<uint4, PACK_U>(src, dst + sl.head, begin, end); break;
    case 8: pack_body<uint2, 2 * PACK_U>(src, dst + sl.head, begin, end); break;
    case 4: pack_body<uint32_t, 4 * PACK_U>(src, dst + sl.head, begin, end); break;
    case 2: pack_body<uint16_t, 4 * PACK_U>(src, dst + sl.head, begin, end); break;
    default: pack_body<uint8_t, 4 * PACK_U>(src, dst + sl.head, begin, end); break;
  }
  if (k == 0 && (int)threadIdx.x < sl.head + sl.tail) {  // the edges
    const int t = (int)threadIdx.x;
    const long long x =
        t < sl.head ? t : sl.head + sl.units * sl.width + (t - sl.head);
    dst[x] = sl.src ? sl.src[x] : (unsigned char)0;
  }
}

extern "C" {

int ompi_fold_args_size() { return (int)sizeof(FoldArgs); }
int ompi_pack_args_size() { return (int)sizeof(PackArgs); }
int ompi_mesh_max_ptrs() { return MESH_MAX_PTRS; }
int ompi_fold_max_jobs() { return FOLD_MAX_JOBS; }
int ompi_fold_max_stages() { return FOLD_MAX_STAGES; }
int ompi_pack_max_slots() { return PACK_MAX_SLOTS; }
int ompi_pack_units() { return PACK_UNITS; }

// One launch over a destination table (the wrapper builds it: jobs,
// their prefix table and heads, the tile and the ring's stages).
int ompi_mesh_fold(const FoldArgs* a, int dtype, int op, void* stream) {
  if (a->nin < 1 || a->nin > MESH_MAX_PTRS || a->njobs < 1 ||
      a->njobs > FOLD_MAX_JOBS || a->ntiles < 1 || a->tile < 1 ||
      a->stages < 1 || a->stages > FOLD_MAX_STAGES ||
      (a->tree && (a->nin & (a->nin - 1))) ||
      (a->ring_m != 0 && (a->ring_seg < 1 || a->ring_m < 1)))
    return (int)cudaErrorInvalidValue;
  for (int j = 0; j < a->njobs; ++j)
    if (a->job[j].in0 < 0 || a->job[j].in0 + a->nin > MESH_MAX_PTRS)
      return (int)cudaErrorInvalidValue;
  return dispatch_reduce<LaunchFold>(dtype, op, a, (cudaStream_t)stream);
}

// nblocks: the blocks of the slot table's prefix (every slot's
// ceil(body bytes / (PACK_UNITS * 16)) blocks, one at least for a slot
// of any bytes).  Each slot's body must be aligned to its width on both
// sides.
int ompi_slot_pack(const PackArgs* a, int nblocks, void* stream) {
  if (a->nslots < 1 || a->nslots > PACK_MAX_SLOTS || nblocks < 1 ||
      a->each < 0 || (a->each && nblocks != a->nslots * a->each))
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < a->nslots; ++i) {
    const PackSlot& sl = a->slot[i];
    const int w = sl.width;
    if ((w != 16 && w != 8 && w != 4 && w != 2 && w != 1) || sl.head < 0 ||
        sl.head > 15 || sl.tail < 0 || sl.tail > 15 || sl.units < 0 ||
        a->first_block[i] < (i ? a->first_block[i - 1] : 0) ||
        a->first_block[i] > nblocks || (i == 0 && a->first_block[0]) ||
        (a->each && a->first_block[i] != i * a->each))
      return (int)cudaErrorInvalidValue;
    if (sl.units && (((uintptr_t)(a->out + sl.off + sl.head)) % w ||
                     (sl.src && ((uintptr_t)(sl.src + sl.head)) % w)))
      return (int)cudaErrorInvalidValue;
  }
  slot_pack_kernel<<<nblocks, PACK_THREADS, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

}  // extern "C"
