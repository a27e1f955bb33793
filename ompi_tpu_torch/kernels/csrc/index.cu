// On-device datatype packing: a gather by an element index vector, and
// its mirror, a scatter by a run table or by the index vector.
//
// K4 index_gather replaces the reference package's device_pack
// (ompi_tpu/datatype/device.py:67): a committed datatype's runs are
// compiled once into an int64 element-index vector, and packing is
// out[i] = src[idx[i]].  K5 index_scatter replaces its mirror,
// device_unpack (:86): out[idx[i]] = packed[i], written in place.
// Both move elements by their width only (1, 2, 4, 8 or 16 bytes), so
// one instantiation per width serves every dtype of that size.  The
// wrapper bounds-checks the index vector against the buffers before
// it launches.  Repeated indices in K5 leave which value lands
// unspecified, as in the reference.
//
// What bounds them: bytes.  A gather reads the index vector (8 bytes
// an element), writes the packed stream and reads the source where
// the indices point; for a strided type (config 5's vector with
// stride 2) the source reads touch the whole span of 32-byte sectors
// the stride covers.  K4 is a grid-stride loop, one element a thread
// per step: consecutive threads read consecutive indices and write
// consecutive outputs.
//
// K5's design for the H100.  A scatter writes only the datatype's
// elements: the gaps of out belong to the caller (MPI unpack), so no
// store may touch a gap byte, not even with the value it holds, and a
// strided layout cannot be widened past its blocks.  What K5 can
// remove is the index traffic and the wait behind it: the old kernel
// read idx[i] (8 bytes) and packed[i], and each store waited for a
// DRAM round trip of its index load, one element a thread.  Two modes:
//   * run mode.  IndexVector (index.py) splits the vector once on the
//     host into at most SCATTER_RUNS affine runs (first destination,
//     block length, stride, block count, packed offset), checked by
//     expanding them against the vector; it takes this mode when the
//     indices are distinct and the table is shorter than the vector.
//     The table rides in the kernel's arguments (__grid_constant__),
//     so K5 reads no index at all and moves the packed stream and the
//     destination's span only (config 5's 1 MiB unpack: 3 MiB): each thread owns one or more 16-byte
//     words of packed elements (the packed start's unaligned elements
//     are a head, the rest past the last word a tail, one element a
//     thread on the grid's first threads), a block's round one
//     contiguous chunk with consecutive threads on consecutive words,
//     and every load of a thread is issued before its first store.  A
//     word's destination comes from the table (a binary search over the
//     packed offsets, uniform across a warp; a division by the block
//     length unless it is 1).  Where every word of a
//     warp's round lies in one block at a 16-byte-aligned destination,
//     each is one 16-byte store.  Elsewhere the warp puts its 32 words
//     through shared memory and stores one element a lane at the
//     element's width, consecutive lanes on consecutive elements: for
//     config 5's vector(m, 1, 2, DOUBLE), one run, a store of the warp
//     then fills 16 whole 32-byte sectors' elements (half of each
//     sector, the rest gaps) in one request each, where a word a lane
//     wrote each sector in two requests and took as long as the index
//     load it saved (tools/kernel_ab.py, 8 MiB).
//   * index mode, for what a table cannot take (permutations, indexed
//     types of many short blocks, repeated indices): a thread owns one
//     or more units of max(2, 16 / width) elements, loads their
//     indices as 16-byte pairs and the packed elements as 16-byte words
//     when the packed start is 16-byte aligned (else element by
//     element), every load before its first store.
// Both run one round a thread: the grid is as many blocks as the work
// has chunks, with no cap and no grid-stride loop (the shape measured
// faster than a persistent grid for K9, PERF.md §6).  A thread owns a
// fixed count of packed elements, SCATTER_ELEMS = 2 (at least one
// 16-byte word in run mode, one unit in index mode): on an H100, 2
// elements a thread read fastest at config 5's 1 MiB unpack (4 and 8
// elements 30-56 % slower) and on the permutation (4-13 % slower), and
// within 4 % of the least at its 8 MiB result (tools/tile_sweep.py).  The C entry of run
// mode re-checks the table before it launches: the packed offsets
// follow each other from 0 to n, and every corner of every run lies in
// [lo, hi] inside the buffer; a table that says otherwise is refused
// with cudaErrorInvalidValue, so a bad table raises in Python and never
// faults the context.  SCATTER_THREADS and SCATTER_ELEMS are constants
// of this source (tools/tile_sweep.py builds -D copies to sweep them):
// 256 threads (128 and 512 within the spread) and 2 elements.
// SCATTER_RUNS is mirrored by index.py's MAX_RUNS; a table of 4 runs in
// place of 64 (a smaller argument block) timed within the spread.
//
// Plain C interface, loaded with ctypes: each entry returns the
// cudaError_t of its launch (0 on success).

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#ifndef SCATTER_THREADS
#define SCATTER_THREADS 256
#endif
#ifndef SCATTER_ELEMS
#define SCATTER_ELEMS 2  // packed elements a K5 thread owns
#endif
#ifndef SCATTER_RUNS
#define SCATTER_RUNS 64  // runs a table holds at most: index.py MAX_RUNS
#endif

struct alignas(16) u128 {
  uint64_t lo, hi;
};

template <int W> struct Elem;  // the unsigned word of one element
template <> struct Elem<1> { using t = uint8_t; };
template <> struct Elem<2> { using t = uint16_t; };
template <> struct Elem<4> { using t = uint32_t; };
template <> struct Elem<8> { using t = uint64_t; };
template <> struct Elem<16> { using t = u128; };

static inline int index_sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (cached[dev] == 0) {
    int sms = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cached[dev] = sms > 0 ? sms : 1;
  }
  return cached[dev];
}

// --- K4: index_gather ----------------------------------------------------

template <typename W>
__global__ void __launch_bounds__(256)
index_gather_kernel(const W* __restrict__ src, const int64_t* __restrict__ idx,
                    W* __restrict__ out, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    out[i] = src[idx[i]];
}

template <typename W>
static int launch_gather(const void* src, const int64_t* idx, void* out,
                         long long n, cudaStream_t s) {
  long long blocks = (n + 255) / 256;
  const long long cap = (long long)index_sm_count() * 16;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  index_gather_kernel<W><<<(unsigned)blocks, 256, 0, s>>>(
      reinterpret_cast<const W*>(src), idx, reinterpret_cast<W*>(out), n);
  return (int)cudaGetLastError();
}

// --- K5 run mode -----------------------------------------------------------

struct ScatterRun {
  long long dst;     // destination element of the run's first element
  long long blen;    // elements a block (>= 1)
  long long stride;  // elements from one block's start to the next's
  long long nblk;    // blocks (>= 1)
  long long poff;    // packed offset of the run's first element
};

struct RunArgs {
  const uint8_t* packed;
  uint8_t* out;
  long long head;   // packed elements before the first 16-byte boundary
  long long words;  // whole 16-byte packed words of the body
  long long tail;   // elements after the body
  int nruns;
  ScatterRun run[SCATTER_RUNS];
};

// Where packed element p lands: its run, block and element in the
// block.
struct Pos {
  int r;
  long long b, e;
};

__device__ __forceinline__ Pos locate(const RunArgs& a, long long p) {
  int lo = 0, hi = a.nruns - 1;
  while (lo < hi) {  // the last run whose packed offset is <= p
    const int mid = (lo + hi + 1) >> 1;
    if (p >= a.run[mid].poff) lo = mid;
    else hi = mid - 1;
  }
  const ScatterRun& r = a.run[lo];
  const long long q = p - r.poff;
  Pos s{lo, q, 0};
  if (r.blen != 1) {
    s.b = ((q | r.blen) >> 31) ? q / r.blen
                               : (long long)((unsigned)q / (unsigned)r.blen);
    s.e = q - s.b * r.blen;
  }
  return s;
}

__device__ __forceinline__ long long dest(const RunArgs& a, const Pos& s) {
  const ScatterRun& r = a.run[s.r];
  return r.dst + s.b * r.stride + s.e;
}

template <int W>
__global__ void __launch_bounds__(SCATTER_THREADS)
scatter_runs_kernel(const __grid_constant__ RunArgs a) {
  using T = typename Elem<W>::t;
  constexpr int V = 16 / W;  // elements a 16-byte word
  constexpr int U = SCATTER_ELEMS / V > 1 ? SCATTER_ELEMS / V : 1;
  // each warp's 32 words of a round, for the element layout (a
  // 16-byte element always takes the word layout)
  __shared__ uint4 stage[V > 1 ? SCATTER_THREADS * U : 1];
  const int lane = threadIdx.x & 31;
  const long long t = (long long)blockIdx.x * SCATTER_THREADS + threadIdx.x;
  const long long w0 =
      (long long)blockIdx.x * SCATTER_THREADS * U + threadIdx.x;
  const uint4* __restrict__ pw =
      reinterpret_cast<const uint4*>(a.packed + a.head * W);
  T* __restrict__ out = reinterpret_cast<T*>(a.out);
  uint4 v[U];
#pragma unroll
  for (int k = 0; k < U; ++k) {
    const long long w = w0 + (long long)k * SCATTER_THREADS;
    if (w < a.words) v[k] = pw[w];
  }
  long long pe = -1;  // the head or tail element this thread moves
  if (t < a.head) pe = t;
  else if (t < a.head + a.tail) pe = a.head + a.words * V + (t - a.head);
  T ve{};
  if (pe >= 0) ve = reinterpret_cast<const T*>(a.packed)[pe];
#pragma unroll
  for (int k = 0; k < U; ++k) {
    const long long w = w0 + (long long)k * SCATTER_THREADS;
    bool whole = true;  // the word lands as one aligned 16-byte store
    long long d = 0;
    if (w < a.words) {
      const Pos s = locate(a, a.head + w * V);
      d = dest(a, s);
      whole = a.run[s.r].blen - s.e >= V &&
              (reinterpret_cast<uintptr_t>(out + d) & 15) == 0;
    }
    if (__all_sync(0xffffffffu, whole)) {
      if (w < a.words) *reinterpret_cast<uint4*>(out + d) = v[k];
      continue;
    }
    if constexpr (V > 1) {
      // element layout: store j of the warp puts its elements 32 j ..
      // 32 j + 31 in lane order, so a store's lanes fill whole sectors
      // of a strided destination (stride 2: a 32-byte sector in one
      // request, where a word a lane would write it in two)
      uint4* ws = stage + k * SCATTER_THREADS + (threadIdx.x & ~31);
      ws[lane] = v[k];
      __syncwarp();
      const T* es = reinterpret_cast<const T*>(ws);
      const long long wb = w - lane;  // the warp's first word this round
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int e = 32 * j + lane;
        if (wb + e / V < a.words)
          out[dest(a, locate(a, a.head + wb * V + e))] = es[e];
      }
    }
  }
  if (pe >= 0) out[dest(a, locate(a, pe))] = ve;
}

// The table against the vector's bounds [lo, hi] inside a buffer of
// span elements: packed offsets from 0 to n in order, every corner of
// every run inside [lo, hi].
static bool table_holds(const long long* tab, int nruns, long long n,
                        long long lo, long long hi, long long span) {
  if (nruns < 1 || nruns > SCATTER_RUNS || n < 1) return false;
  if (lo < 0 || lo > hi || hi >= span) return false;
  __int128 at = 0;
  for (int r = 0; r < nruns; ++r) {
    const long long* x = tab + 5 * r;
    const long long dst = x[0], blen = x[1], stride = x[2], nblk = x[3];
    if (x[4] != at || blen < 1 || nblk < 1 || blen > n || nblk > n)
      return false;
    at += (__int128)blen * nblk;
    if (at > n) return false;
    const __int128 last = (__int128)(nblk - 1) * stride;
    const __int128 corners[4] = {dst, dst + blen - 1, dst + last,
                                 dst + last + blen - 1};
    for (const __int128 c : corners)
      if (c < lo || c > hi) return false;
  }
  return at == n;
}

// Both buffers aligned to the element width (the wrapper checks it too):
// run mode's head then ends on a 16-byte boundary.
static bool width_aligned(const void* a, const void* b, int width) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b))
          & (uintptr_t)(width - 1)) == 0;
}

template <int W>
static int launch_runs(const void* packed, void* out, long long n,
                       const long long* tab, int nruns, cudaStream_t s) {
  constexpr int V = 16 / W;
  constexpr int U = SCATTER_ELEMS / V > 1 ? SCATTER_ELEMS / V : 1;
  RunArgs a;
  a.packed = static_cast<const uint8_t*>(packed);
  a.out = static_cast<uint8_t*>(out);
  long long head = (long long)((16 - (reinterpret_cast<uintptr_t>(packed) & 15))
                               & 15) / W;
  if (head > n) head = n;
  a.head = head;
  a.words = (n - head) / V;
  a.tail = n - head - a.words * V;
  a.nruns = nruns;
  memcpy(a.run, tab, sizeof(ScatterRun) * nruns);
  const long long per = (long long)SCATTER_THREADS * U;
  long long grid = (a.words + per - 1) / per;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (grid < 1) grid = 1;  // the head and tail ride the first threads
  scatter_runs_kernel<W><<<(unsigned)grid, SCATTER_THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// --- K5 index mode -----------------------------------------------------------

struct IndexArgs {
  const uint8_t* packed;
  const int64_t* idx;  // 16-byte aligned
  uint8_t* out;
  long long units;     // whole units of E elements
  long long tail;      // elements after them
};

// P16: the packed start is 16-byte aligned, so a unit's elements load
// as 16-byte words.
template <int W, bool P16>
__global__ void __launch_bounds__(SCATTER_THREADS)
scatter_index_kernel(const IndexArgs a) {
  using T = typename Elem<W>::t;
  constexpr int E = 16 / W > 2 ? 16 / W : 2;  // elements a unit
  constexpr int U = SCATTER_ELEMS / E > 1 ? SCATTER_ELEMS / E : 1;
  constexpr int NW = E * W / 16;  // 16-byte packed words a unit
  const long long t = (long long)blockIdx.x * SCATTER_THREADS + threadIdx.x;
  const long long u0 =
      (long long)blockIdx.x * SCATTER_THREADS * U + threadIdx.x;
  const longlong2* __restrict__ ip = reinterpret_cast<const longlong2*>(a.idx);
  const T* __restrict__ pk = reinterpret_cast<const T*>(a.packed);
  T* __restrict__ out = reinterpret_cast<T*>(a.out);
  longlong2 ix[U][E / 2];
  T val[U][E];
#pragma unroll
  for (int k = 0; k < U; ++k) {
    const long long u = u0 + (long long)k * SCATTER_THREADS;
    if (u >= a.units) continue;
#pragma unroll
    for (int h = 0; h < E / 2; ++h) ix[k][h] = ip[u * (E / 2) + h];
    if constexpr (P16) {
      uint4 wd[NW];
#pragma unroll
      for (int q = 0; q < NW; ++q)
        wd[q] = reinterpret_cast<const uint4*>(a.packed)[u * NW + q];
      memcpy(val[k], wd, sizeof(wd));
    } else {
#pragma unroll
      for (int j = 0; j < E; ++j) val[k][j] = pk[u * E + j];
    }
  }
  long long pe = -1, de = 0;  // the tail element this thread moves
  T ve{};
  if (t < a.tail) {
    pe = a.units * E + t;
    de = a.idx[pe];
    ve = pk[pe];
  }
#pragma unroll
  for (int k = 0; k < U; ++k) {
    const long long u = u0 + (long long)k * SCATTER_THREADS;
    if (u >= a.units) continue;
#pragma unroll
    for (int h = 0; h < E / 2; ++h) {
      out[ix[k][h].x] = val[k][2 * h];
      out[ix[k][h].y] = val[k][2 * h + 1];
    }
  }
  if (pe >= 0) out[de] = ve;
}

template <int W>
static int launch_index(const void* packed, const int64_t* idx, void* out,
                        long long n, cudaStream_t s) {
  constexpr int E = 16 / W > 2 ? 16 / W : 2;
  constexpr int U = SCATTER_ELEMS / E > 1 ? SCATTER_ELEMS / E : 1;
  if ((reinterpret_cast<uintptr_t>(idx) & 15) || !width_aligned(packed, out, W))
    return (int)cudaErrorInvalidValue;
  const IndexArgs a{static_cast<const uint8_t*>(packed), idx,
                    static_cast<uint8_t*>(out), n / E, n % E};
  const bool p16 = (reinterpret_cast<uintptr_t>(packed) & 15) == 0;
  const long long per = (long long)SCATTER_THREADS * U;
  long long grid = (a.units + per - 1) / per;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (grid < 1) grid = 1;  // the tail rides the first threads
  if (p16)
    scatter_index_kernel<W, true><<<(unsigned)grid, SCATTER_THREADS, 0, s>>>(a);
  else
    scatter_index_kernel<W, false><<<(unsigned)grid, SCATTER_THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}

extern "C" {

// out[i] = src[idx[i]] for i < n; width = bytes of one element.
int ompi_index_gather(const void* src, const int64_t* idx, void* out,
                      long long n, int width, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (width) {
    case 1: return launch_gather<uint8_t>(src, idx, out, n, s);
    case 2: return launch_gather<uint16_t>(src, idx, out, n, s);
    case 4: return launch_gather<uint32_t>(src, idx, out, n, s);
    case 8: return launch_gather<uint64_t>(src, idx, out, n, s);
    case 16: return launch_gather<u128>(src, idx, out, n, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Index mode: out[idx[i]] = packed[i] for i < n, in place on out.
int ompi_index_scatter(const void* packed, const int64_t* idx, void* out,
                       long long n, int width, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (width) {
    case 1: return launch_index<1>(packed, idx, out, n, s);
    case 2: return launch_index<2>(packed, idx, out, n, s);
    case 4: return launch_index<4>(packed, idx, out, n, s);
    case 8: return launch_index<8>(packed, idx, out, n, s);
    case 16: return launch_index<16>(packed, idx, out, n, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Run mode: the same scatter by a table of nruns runs, five int64 a run
// (dst, blen, stride, nblk, poff), whose destinations lie in [lo, hi]
// inside out's span elements; refused before any launch when the table
// does not hold.
int ompi_index_scatter_runs(const void* packed, void* out, long long n,
                            int width, const long long* table, int nruns,
                            long long lo, long long hi, long long span,
                            void* stream) {
  if (!table_holds(table, nruns, n, lo, hi, span) ||
      !width_aligned(packed, out, width))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (width) {
    case 1: return launch_runs<1>(packed, out, n, table, nruns, s);
    case 2: return launch_runs<2>(packed, out, n, table, nruns, s);
    case 4: return launch_runs<4>(packed, out, n, table, nruns, s);
    case 8: return launch_runs<8>(packed, out, n, table, nruns, s);
    case 16: return launch_runs<16>(packed, out, n, table, nruns, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
