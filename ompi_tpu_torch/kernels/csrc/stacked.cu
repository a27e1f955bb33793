// Stacked collectives for ranks that share one card (coll/hbm).
//
// K1 stacked_reduce replaces the reference package's stacked
// reduction programs: HbmCollModule._build_stacked("allreduce", op)
// and ("reduce_scatter", op) (ompi_tpu/coll/device.py:1389-1417, with
// the fold table _fold_fn at :136 and op/op.py:153 jax_binary).  It
// reads N same-length shards and writes M outputs in ONE launch:
// replicate mode (allreduce) writes the whole result to every output,
// scatter mode (reduce_scatter) writes stripe i to output i.  The
// reduction is a left fold in rank order, acc = in[0]; acc = op(acc,
// in[r]) for r = 1..N-1, computed once per element.
//
// K2 stacked_copy replaces the data-movement halves of the same
// programs: _build_stacked("alltoall") (:1421-1431), a block transpose
// out[i][j] = in[j][i], and ("allgather") (:1418), out[i] = cat(in).
// Its peer mode serves the mesh tier (ranks on distinct devices): ONE
// launch a card writes every destination on that card and reads the N
// sources through their pointers, which may lie on other cards (peer
// access) — the all_gather / all_to_all halves of the reference's
// _build_mesh_collective (coll/device.py:997) and the segbcast /
// sega2a schedules of coll/pipeline.py:192.  Strides and a write limit
// let one launch move a column segment of every block (sega2a) or
// gather ragged stripes (the allgather half of a mesh allreduce)
// without staging copies.  A null source pointer writes zeros into its
// block in the same launch: the PROC_NULL neighbours of the cartesian
// halo gather, topo/neighbor.py:160-186, whose member outputs are one
// peer launch each (each member has its own source list).
//
// What bounds them: bytes.  A reduction does N-1 operations per N
// elements read, far below the card's operations-per-byte balance, so
// the least time is (bytes read once + bytes written once) / 3.35 TB/s.
// K1 answers that with every byte read once and written once (no
// stacked copy in device memory, unlike jnp.stack), 16 bytes a thread
// where the pointers allow it, neighbour threads on neighbour
// addresses.  The N input and M output pointers travel by value in the
// kernel's parameter block (a fixed cap of MAX_PTRS each side, 2 KiB,
// under the 4 KiB parameter limit), so a launch needs no host-to-device
// copy.
//
// K2's design for the H100 (bulk.cuh): a row is one (destination,
// source) block; a persistent grid, blocks per SM from the occupancy
// API at the ring's shared memory, walks one flat list of tiles of
// ``tile`` bytes over every row of the launch (a prefix table over the
// sources, first_tile[], maps a tile to its row: every destination has
// the same rows; the list runs source by source, so the destinations
// that read one source tile run together and read it once from device
// memory).  One thread a block moves a row's 16-byte-aligned body: a
// bulk copy device -> shared memory into a stage of a ring of S
// stages, completing the stage's barrier, then a bulk store shared ->
// device memory in a bulk group; a stage is refilled only after
// cp.async.bulk.wait_group.read says its store has read it, half the
// ring loading while the other half stores.  The block's four other
// warps do what bulk copies cannot: a row's head and tail that miss a
// whole 16-byte vector (its last tile), a row whose source and
// destination are not congruent modulo 16 bytes (plain loads of the
// widest unit both allow), and the zeros of a null source.
// (stacked.py _row_split mirrors the split.)  A peer's source over
// NVLink is read by the same bulk copies (exact on four H100s joined
// by NVLink).
//
// Sizes (stacked.py COPY_TILE, COPY_STAGES), from the sweep of
// ompi_tpu_torch/tools/tile_sweep.py on an H100 (8, 16 and 32 KiB by
// 2, 4 and 8 stages, within 192 KiB): 32 KiB tiles and 4 stages, a
// 128 KiB ring, one block an SM; the spread over the grid was a few
// per cent, so bytes in flight do not bound it.  ptxas (sm_90a): 54
// registers, no static shared memory, a stack of 32-96 bytes (the
// ring's pending stores), no spills.
//
// The op and dtype templates, and the semantics they fix (NaN,
// wrapping, half-precision accumulation, complex rounding), live in
// reduce_ops.cuh, which K3 fused_batch (fused.cu) shares.
//
// Plain C interface, loaded with ctypes: each entry returns the
// cudaError_t of its launch (0 on success).

#include "bulk.cuh"
#include "reduce_ops.cuh"

#define MAX_PTRS 128
#define COPY_CONS 128  // edge threads (four warps) of a K2 block
#define COPY_THREADS (32 + COPY_CONS)

struct ReduceArgs {
  const void* in[MAX_PTRS];
  void* out[MAX_PTRS];
  long long n;       // elements in each input
  long long stripe;  // scatter: elements per output
  int nin;
  int nout;
  int scatter;
};

// Row (il, j): out[il] + j * out_stride <- in[j] + dst[il] *
// in_stride, min(chunk, limit - j * out_stride) bytes; zeros where
// in[j] is null.  Stacked alltoall: in_stride = out_stride = chunk;
// allgather: in_stride = 0.
struct CopyArgs {
  const void* in[MAX_PTRS];
  void* out[MAX_PTRS];
  long long chunk;       // bytes in one block
  long long in_stride;   // bytes from source block i to block i + 1
  long long out_stride;  // bytes from destination block j to j + 1
  long long limit;       // bytes of each destination that may be written
  long long tile;        // bytes a tile (a multiple of 16)
  long long ntiles;      // nout * first_tile[n]: tile t is tile
                         // t / nout - first_tile[j] of row (t % nout, j)
  int first_tile[MAX_PTRS + 1];  // prefix over the sources: row tiles
                                 // of one destination
  int dst[MAX_PTRS];     // the source block destination il takes
  int n;                 // sources
  int nout;              // destinations of this launch
};

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T x[V];
};

template <typename T, int OP, int V>
__global__ void __launch_bounds__(256) stacked_reduce_kernel(const ReduceArgs a) {
  using Tr = Traits<T>;
  using A = typename Tr::A;
  using VT = Vec<T, V>;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nvec = a.n / V;
  for (long long j = t0; j < nvec; j += stride) {
    A acc[V];
    VT v = reinterpret_cast<const VT*>(a.in[0])[j];
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = first<OP>(Tr::load(v.x[k]));
#pragma unroll 4
    for (int r = 1; r < a.nin; ++r) {
      VT w = reinterpret_cast<const VT*>(a.in[r])[j];
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] = apply<OP>(acc[k], Tr::load(w.x[k]));
    }
    VT o;
#pragma unroll
    for (int k = 0; k < V; ++k) o.x[k] = Tr::store(acc[k]);
    if (a.scatter) {
      const long long i = j * V;
      const long long d = i / a.stripe;
      reinterpret_cast<VT*>(a.out[d])[(i - d * a.stripe) / V] = o;
    } else {
      for (int d = 0; d < a.nout; ++d) reinterpret_cast<VT*>(a.out[d])[j] = o;
    }
  }
  // ragged tail (n % V elements), one element a thread
  for (long long i = nvec * V + t0; i < a.n; i += stride) {
    A acc = first<OP>(Tr::load(reinterpret_cast<const T*>(a.in[0])[i]));
    for (int r = 1; r < a.nin; ++r)
      acc = apply<OP>(acc, Tr::load(reinterpret_cast<const T*>(a.in[r])[i]));
    const T o = Tr::store(acc);
    if (a.scatter) {
      const long long d = i / a.stripe;
      reinterpret_cast<T*>(a.out[d])[i - d * a.stripe] = o;
    } else {
      for (int d = 0; d < a.nout; ++d) reinterpret_cast<T*>(a.out[d])[i] = o;
    }
  }
}

struct CopyRow {
  const unsigned char* src;  // null: zeros
  unsigned char* dst;
  long long cnt;    // bytes of the row
  long long k;      // the tile's index in its row
  long long ntile;  // the row's tiles
};

__device__ __forceinline__ CopyRow copy_row(const CopyArgs& a, long long t) {
  // the flat list runs source by source, then tile by tile, then
  // destination: t = (first_tile[j] + k) * nout + il, so the nout
  // blocks that read one source tile run together (device memory once,
  // L2 for the rest)
  const long long r = t / a.nout;
  const int il = (int)(t - r * a.nout);
  int lo = 0, hi = a.n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (a.first_tile[mid] <= r) lo = mid; else hi = mid - 1;
  }
  CopyRow w;
  w.src = a.in[lo] == nullptr ? nullptr
          : reinterpret_cast<const unsigned char*>(a.in[lo]) +
                (long long)a.dst[il] * a.in_stride;
  w.dst = reinterpret_cast<unsigned char*>(a.out[il]) + lo * a.out_stride;
  const long long room = a.limit - lo * a.out_stride;
  w.cnt = room < a.chunk ? room : a.chunk;
  w.k = r - a.first_tile[lo];
  w.ntile = a.first_tile[lo + 1] - a.first_tile[lo];
  return w;
}

// A congruent row (source and destination equal modulo 16 bytes) has
// head h bytes up to its first 16-byte boundary, a body of whole
// 16-byte vectors, and a tail; its tile k moves body bytes [b0, b1)
// by bulk copies, and its last tile also the head and the tail.
__device__ __forceinline__ bool congruent(const CopyRow& w) {
  return w.src != nullptr &&
         (((uintptr_t)w.src ^ (uintptr_t)w.dst) & 15) == 0;
}

__device__ __forceinline__ long long row_head(const CopyRow& w) {
  const long long h = (long long)((16 - ((uintptr_t)w.src & 15)) & 15);
  return h < w.cnt ? h : w.cnt;
}

__device__ __forceinline__ bool bulk_span(const CopyRow& w, long long tile,
                                          long long& b0, long long& b1) {
  if (!congruent(w)) return false;
  const long long h = row_head(w);
  const long long end = h + ((w.cnt - h) & ~15LL);
  b0 = h + w.k * tile;
  if (b0 >= end) return false;
  b1 = b0 + tile < end ? b0 + tile : end;
  return true;
}

// n bytes src -> dst (zeros where src is null) by threads tid, tid +
// nthr, ...: whole units of the widest width W <= 16 at which source
// and destination are congruent, bytes at either end.
template <typename W>
__device__ __forceinline__ void copy_units(unsigned char* d,
                                           const unsigned char* s, long long n,
                                           int tid, int nthr) {
  const long long h0 = (long long)((sizeof(W) - ((uintptr_t)d & (sizeof(W) - 1))) &
                                   (sizeof(W) - 1));
  const long long h = h0 < n ? h0 : n;
  const long long units = (n - h) / (long long)sizeof(W);
  const long long t0 = h + units * (long long)sizeof(W);
  for (long long b = tid; b < h; b += nthr) d[b] = s ? s[b] : 0;
  W* dw = reinterpret_cast<W*>(d + h);
  const W* sw = s ? reinterpret_cast<const W*>(s + h) : nullptr;
  for (long long u = tid; u < units; u += nthr) dw[u] = sw ? sw[u] : W{};
  for (long long b = t0 + tid; b < n; b += nthr) d[b] = s ? s[b] : 0;
}

__device__ __forceinline__ void copy_span(unsigned char* d,
                                          const unsigned char* s, long long n,
                                          int tid, int nthr) {
  const uintptr_t x = s ? ((uintptr_t)s ^ (uintptr_t)d) : 0;
  if ((x & 15) == 0) copy_units<uint4>(d, s, n, tid, nthr);
  else if ((x & 7) == 0) copy_units<uint2>(d, s, n, tid, nthr);
  else if ((x & 3) == 0) copy_units<uint32_t>(d, s, n, tid, nthr);
  else if ((x & 1) == 0) copy_units<uint16_t>(d, s, n, tid, nthr);
  else copy_units<uint8_t>(d, s, n, tid, nthr);
}

// S stages; the bulk thread keeps S / 2 tiles loading while the other
// S / 2 store.
template <int S>
__global__ void __launch_bounds__(COPY_THREADS)
    copy_tiles(const __grid_constant__ CopyArgs a) {
  constexpr int D = S / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  unsigned char* ring = smem + BAR_BYTES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x >= 32) {  // the edge threads
    const int tid = threadIdx.x - 32;
    for (long long t = blockIdx.x; t < a.ntiles; t += gridDim.x) {
      const CopyRow w = copy_row(a, t);
      if (congruent(w)) {
        if (w.k != w.ntile - 1) continue;
        const long long h = row_head(w);
        const long long end = h + ((w.cnt - h) & ~15LL);
        for (long long b = tid; b < h; b += COPY_CONS) w.dst[b] = w.src[b];
        for (long long b = end + tid; b < w.cnt; b += COPY_CONS)
          w.dst[b] = w.src[b];
        continue;
      }
      const long long b0 = w.k * a.tile;
      const long long b1 = b0 + a.tile < w.cnt ? b0 + a.tile : w.cnt;
      copy_span(w.dst + b0, w.src ? w.src + b0 : nullptr, b1 - b0, tid,
                COPY_CONS);
    }
    return;
  }
  if (threadIdx.x != 0) return;
  unsigned char* pend_dst[S];  // the store each stage holds
  unsigned pend_n[S];
  long long i = 0;  // this block's bulk tiles so far
  auto store = [&](long long q) {
    const int s = (int)(q % S);
    mbar_wait(smem_u32(&full[s]), (unsigned)((q / S) & 1));
    fence_proxy_async();
    bulk_s2g(pend_dst[s], smem_u32(ring + s * a.tile), pend_n[s]);
    bulk_commit();
  };
  for (long long t = blockIdx.x; t < a.ntiles; t += gridDim.x) {
    const CopyRow w = copy_row(a, t);
    long long b0, b1;
    if (!bulk_span(w, a.tile, b0, b1)) continue;
    if (i >= D) store(i - D);
    if (i >= S) bulk_wait_read<S - D>();  // tile i - S's store has read
    const int s = (int)(i % S);
    const unsigned nb = (unsigned)(b1 - b0);
    const uint32_t bar = smem_u32(&full[s]);
    mbar_expect_tx(bar, nb);
    bulk_g2s(smem_u32(ring + s * a.tile), w.src + b0, nb, bar);
    pend_dst[s] = w.dst + b0;
    pend_n[s] = nb;
    ++i;
  }
  for (long long q = i > D ? i - D : 0; q < i; ++q) store(q);
  bulk_wait_read<0>();  // the ring outlives every store's read of it
}

template <int S>
static int launch_copy(const CopyArgs* a, cudaStream_t st) {
  const void* fn = reinterpret_cast<const void*>(&copy_tiles<S>);
  const size_t smem = BAR_BYTES + (size_t)S * a->tile;
  const int bps = blocks_per_sm(fn, COPY_THREADS, smem);
  if (bps <= 0) {
    const int e = (int)cudaGetLastError();
    return e ? e : (int)cudaErrorInvalidConfiguration;
  }
  long long grid = (long long)bps * sm_count();
  if (grid > a->ntiles) grid = a->ntiles;
  copy_tiles<S><<<(unsigned)grid, COPY_THREADS, smem, st>>>(*a);
  return (int)cudaGetLastError();
}

template <typename T, int OP>
struct LaunchReduce {
  static int run(const ReduceArgs* a, int vec, cudaStream_t s) {
    constexpr int V = 16 / sizeof(T);
    const long long cap = (long long)sm_count() * 8;
    if (vec) {
      stacked_reduce_kernel<T, OP, V>
          <<<grid_for(a->n / V, cap), 256, 0, s>>>(*a);
    } else {
      stacked_reduce_kernel<T, OP, 1><<<grid_for(a->n, cap), 256, 0, s>>>(*a);
    }
    return (int)cudaGetLastError();
  }
};

extern "C" {

int ompi_reduce_args_size() { return (int)sizeof(ReduceArgs); }
int ompi_copy_args_size() { return (int)sizeof(CopyArgs); }
int ompi_max_ptrs() { return MAX_PTRS; }

// vec != 0: every pointer is 16-byte aligned and (scatter) the stripe
// is a whole number of 16-byte vectors; the wrapper decides.
int ompi_stacked_reduce(const ReduceArgs* a, int dtype, int op, int vec,
                        void* stream) {
  if (a->nin < 1 || a->nin > MAX_PTRS || a->nout < 1 || a->nout > MAX_PTRS)
    return (int)cudaErrorInvalidValue;
  return dispatch_reduce<LaunchReduce>(dtype, op, a, vec,
                                       (cudaStream_t)stream);
}

// One launch over a destination table (the wrapper builds it: byte
// strides, the tile, the prefix table); stages: 2, 4 or 8.
int ompi_stacked_copy(const CopyArgs* a, int stages, void* stream) {
  if (a->n < 1 || a->n > MAX_PTRS || a->nout < 1 || a->nout > MAX_PTRS ||
      a->tile < 16 || a->tile % 16 || a->first_tile[a->n] < 1 ||
      a->ntiles != (long long)a->nout * a->first_tile[a->n])
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (stages) {
    case 2: return launch_copy<2>(a, s);
    case 4: return launch_copy<4>(a, s);
    case 8: return launch_copy<8>(a, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Let kernels running on card ``dev`` read card ``peer``'s memory (the
// mesh tier's pulls).  Enabling twice is not an error.
int ompi_enable_peer(int dev, int peer) {
  int prev = 0;
  cudaGetDevice(&prev);
  cudaError_t e = cudaSetDevice(dev);
  if (e == cudaSuccess) {
    e = cudaDeviceEnablePeerAccess(peer, 0);
    if (e == cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();  // clear the error it left behind
      e = cudaSuccess;
    }
  }
  cudaSetDevice(prev);
  return (int)e;
}

}  // extern "C"
