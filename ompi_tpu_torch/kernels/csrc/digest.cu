// Integrity digest of a table of operands (the SDC plane's checksum).
//
// K11 digest replaces the reference package's host reduction
// obs/integrity.py:221-247 (fold, digest), which runs in numpy and so
// would copy every checked operand from the card to the host.  Here
// the operands stay on the card and only one 8-byte result each
// crosses.  One launch digests a table of up to DIGEST_MAX_OPS
// operands on one device (pointer, element count, dtype, fold code,
// load mode): a rank's gate claim (one operand, or one a fused batch's
// entry), the outputs a verify checks, or every deposit a bisection
// re-digests.
//
// The folds, each the value integrity.digest gives:
//   * INTSUM: the elements viewed as unsigned of their width, summed
//     mod 2^64 (numpy's np.add.reduce(a, dtype=np.uint64));
//   * FSUM: float16 / float32 / float64 summed in float64;
//   * MAX / MIN: the typed extremum, exact, NaN propagating (numpy's
//     a.max()), kept as float64 for the floats (exact), int64 for the
//     signed and uint64 for the unsigned integers;
//   * an empty operand gives 0 (0.0 for FSUM).
// Each result is the 8 bytes of that value; the wrapper decodes them.
//
// Determinism is a requirement, not a nicety: the bisection round
// compares a re-digest of a deposit with the claim the gate made at
// ZERO tolerance, and the two are taken over different buffers (the
// gate digests fresh clones; verify and bisection digest outputs and
// deposits that may be views at any element offset).  So the digest's
// bits depend only on the operand's values and length, never on its
// address: the work is assigned by element index alone.  Elements go
// in groups of V = 16 / sizeof(T) at positions g V; an operand's
// groups split into digest_blocks(n, size) contiguous runs, one a
// block (a function of the length and the width alone); a thread takes
// DIGEST_U groups a round, g0 + u DIGEST_THREADS + thread (consecutive
// threads on consecutive 16-byte groups), and folds them in index
// order, each group's elements in order; the block folds its threads
// with warp shuffles in a fixed order, then its warps in order; the
// last block of an operand (elected by an integer counter, never a
// float atomic) folds the block partials in a fixed order the same
// way.  Which block finishes last changes nothing.  The load mode is
// the only thing the address chooses: an operand whose base is 16-byte
// aligned loads each whole group as one 16-byte word, any other loads
// it element by element; both fold the same elements in the same
// order, so they give the same bits.
//
// No memset: the counters that elect the last block live in a static
// device array (g_digest_done), zero when the module loads, one row a
// slot; the wrapper gives each (device, stream) a slot of its own, so
// that the gates of rank threads running on their own streams never
// share a counter, and the finishing block resets its operand's
// counter to 0.  A one-block operand needs no counter.  A launch
// captured in a CUDA graph keeps the capture stream's slot: a replay
// must not run beside other digests on that stream.
//
// What bounds it: bytes, each operand read once (3.35 TB/s on an H100
// SXM); the fold is one add or compare an element.  A block reads a
// span of DIGEST_THREADS * DIGEST_U 16-byte groups a round, every load
// of a thread's round issued before its first fold; an operand takes
// at most DIGEST_MAX_BLOCKS blocks (more rounds a block beyond).
// DIGEST_U is a constant of this source (tools/tile_sweep.py builds -D
// copies to sweep it; digest.py mirrors it as ``U``): 4, the least
// summed over K11's rows on an H100 (1 and 2 were 15 % and 8 % slower,
// 8 within 1 %).  A fixed cost of about 5 us a launch at 8 MiB remains:
// one-edit copies with 128 threads a block (16 % slower), 512, an
// acquire-release counter in place of the fences, the warp totals
// folded by shuffles, a 32-bit block-span division and one accumulator
// a group all read within 0.0002 ms (tools/kernel_ab.py).  ptxas
// (sm_90a): 58 registers, 68 bytes of shared memory, no stack and no
// spills.
//
// Plain C interface, loaded with ctypes: the entry returns the
// cudaError_t of its launch (0 on success).

#include "reduce_ops.cuh"

#include <cstring>

#define DIGEST_MAX_OPS 96
#define DIGEST_THREADS 256
#ifndef DIGEST_U
#define DIGEST_U 4  // 16-byte groups a thread loads and folds a round
#endif
#define DIGEST_MAX_BLOCKS 1024
#define DIGEST_SLOTS 256  // streams a device

enum Fold { F_INTSUM = 1, F_FSUM = 2, F_MAX = 3, F_MIN = 4 };

struct DigestOp {
  const void* ptr;
  long long n;      // elements
  int first_block;  // prefix table: first block of this operand
  int nblocks;      // digest_blocks(n, size): the length and width alone
  int dtype;        // reduce_ops.cuh Dtype
  int code;         // Fold
  int vec;          // 1: ptr 16-byte aligned, a group loads as one word
};

struct DigestArgs {
  DigestOp op[DIGEST_MAX_OPS];
  unsigned long long* partial;  // one slot a block
  unsigned long long* out;      // one result an operand
  int nops;
  int slot;                     // the stream's row of g_digest_done
};

typedef unsigned long long u64;

// One counter an operand a slot: zero at load, reset by the finishing
// block after its operand's final fold.
__device__ unsigned int g_digest_done[DIGEST_SLOTS][DIGEST_MAX_OPS];

__device__ __forceinline__ double widen(__half x) { return (double)__half2float(x); }
__device__ __forceinline__ double widen(float x) { return (double)x; }
__device__ __forceinline__ double widen(double x) { return x; }
template <typename T>
__device__ __forceinline__ T widen(T x) { return x; }

struct USum {  // INTSUM: unsigned, wrapping mod 2^64
  using A = u64;
  static __device__ __forceinline__ A id() { return 0ull; }
  static __device__ __forceinline__ A op(A a, A b) { return a + b; }
  static __device__ __forceinline__ u64 bits(A a) { return a; }
  static __device__ __forceinline__ A from(u64 b) { return b; }
};

struct FSum {
  using A = double;
  static __device__ __forceinline__ A id() { return 0.0; }
  static __device__ __forceinline__ A op(A a, A b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ u64 bits(A a) { return (u64)__double_as_longlong(a); }
  static __device__ __forceinline__ A from(u64 b) { return __longlong_as_double((long long)b); }
};

template <bool MX>
struct FExt {  // float extremum: a NaN on either side wins
  using A = double;
  static __device__ __forceinline__ A id() {
    return MX ? -__longlong_as_double(0x7ff0000000000000ll)
              : __longlong_as_double(0x7ff0000000000000ll);
  }
  static __device__ __forceinline__ A op(A a, A b) {
    return (a != a || (MX ? a > b : a < b)) ? a : b;
  }
  static __device__ __forceinline__ u64 bits(A a) { return (u64)__double_as_longlong(a); }
  static __device__ __forceinline__ A from(u64 b) { return __longlong_as_double((long long)b); }
};

template <bool MX>
struct IExt {  // signed integer extremum
  using A = long long;
  static __device__ __forceinline__ A id() {
    return MX ? -0x7fffffffffffffffll - 1 : 0x7fffffffffffffffll;
  }
  static __device__ __forceinline__ A op(A a, A b) { return (MX ? a > b : a < b) ? a : b; }
  static __device__ __forceinline__ u64 bits(A a) { return (u64)a; }
  static __device__ __forceinline__ A from(u64 b) { return (A)b; }
};

template <bool MX>
struct UExt {  // unsigned integer extremum
  using A = u64;
  static __device__ __forceinline__ A id() { return MX ? 0ull : ~0ull; }
  static __device__ __forceinline__ A op(A a, A b) { return (MX ? a > b : a < b) ? a : b; }
  static __device__ __forceinline__ u64 bits(A a) { return a; }
  static __device__ __forceinline__ A from(u64 b) { return b; }
};

// Fold every thread's value in a fixed order: each warp by shuffles
// (lane i takes lane i + 16, then + 8, + 4, + 2, + 1), then thread 0
// the warps' values in warp order.  The result is thread 0's.
template <typename R>
__device__ __forceinline__ typename R::A block_fold(typename R::A v, u64* sh) {
  using A = typename R::A;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = R::op(v, __shfl_down_sync(0xffffffffu, v, o));
  A* s = reinterpret_cast<A*>(sh);
  if ((threadIdx.x & 31) == 0) s[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 1; w < DIGEST_THREADS / 32; ++w) v = R::op(v, s[w]);
  }
  return v;
}

// Group g's V elements of p (those below n) into v: one 16-byte word
// where the operand is 16-byte aligned and the group whole, else
// element by element.
template <typename T>
__device__ __forceinline__ void load_group(const T* __restrict__ p, long long g,
                                           long long n, bool vec, T* v) {
  constexpr int V = 16 / (int)sizeof(T);
  const long long e0 = g * V;
  if (vec && e0 + V <= n) {
    const uint4 w = *reinterpret_cast<const uint4*>(p + e0);
    memcpy(v, &w, 16);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e)
      if (e0 + e < n) v[e] = p[e0 + e];
  }
}

// Fold the elements of the group at element e0 (those below n) into
// acc, in index order.  An integer sum of 1- or 2-byte elements adds a
// whole group in 32 bits first (16 x 255 and 8 x 65535 fit): a modular
// sum, so no bit changes.
template <typename T, typename R>
__device__ __forceinline__ typename R::A fold_group(typename R::A acc, const T* v,
                                                    long long e0, long long n) {
  using A = typename R::A;
  constexpr int V = 16 / (int)sizeof(T);
  if (e0 + V <= n) {
    if constexpr (std::is_same<R, USum>::value && sizeof(T) <= 2) {
      unsigned s = 0;
#pragma unroll
      for (int e = 0; e < V; ++e) s += v[e];
      return acc + s;
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) acc = R::op(acc, (A)widen(v[e]));
      return acc;
    }
  }
#pragma unroll
  for (int e = 0; e < V; ++e)
    if (e0 + e < n) acc = R::op(acc, (A)widen(v[e]));
  return acc;
}

template <typename T, typename R>
__device__ void digest_block(const DigestArgs& a, int k, int b, u64* sh, int* last) {
  using A = typename R::A;
  constexpr int V = 16 / (int)sizeof(T);
  constexpr long long ROUND = (long long)DIGEST_THREADS * DIGEST_U;
  const DigestOp& o = a.op[k];
  const T* __restrict__ p = reinterpret_cast<const T*>(o.ptr);
  const long long groups = (o.n + V - 1) / V;
  const long long per = (groups + o.nblocks - 1) / o.nblocks;
  const long long lo = (long long)b * per;
  const long long hi = lo + per < groups ? lo + per : groups;
  const bool vec = o.vec != 0;
  A acc = R::id();
  for (long long g0 = lo + threadIdx.x; g0 < hi; g0 += ROUND) {
    T v[DIGEST_U][V];
#pragma unroll
    for (int u = 0; u < DIGEST_U; ++u) {
      const long long g = g0 + (long long)u * DIGEST_THREADS;
      if (g < hi) load_group<T>(p, g, o.n, vec, v[u]);
    }
#pragma unroll
    for (int u = 0; u < DIGEST_U; ++u) {
      const long long g = g0 + (long long)u * DIGEST_THREADS;
      if (g < hi) acc = fold_group<T, R>(acc, v[u], g * V, o.n);
    }
  }
  const A r = block_fold<R>(acc, sh);
  if (o.nblocks == 1) {  // the block's total is the operand's
    if (threadIdx.x == 0) a.out[k] = o.n == 0 ? 0ull : R::bits(r);
    return;
  }
  unsigned int* done = &g_digest_done[a.slot][k];
  if (threadIdx.x == 0) {
    a.partial[o.first_block + b] = R::bits(r);
    __threadfence();
    *last = atomicAdd(done, 1u) == (unsigned)(o.nblocks - 1);
  }
  __syncthreads();
  if (!*last) return;
  __threadfence();
  A fin = R::id();
  for (int i = threadIdx.x; i < o.nblocks; i += DIGEST_THREADS)
    fin = R::op(fin, R::from(__ldcg(&a.partial[o.first_block + i])));
  const A f = block_fold<R>(fin, sh);
  if (threadIdx.x == 0) {
    a.out[k] = R::bits(f);
    *done = 0u;  // ready for the slot's next launch
  }
}

template <bool MX>
__device__ void digest_ext(const DigestArgs& a, int k, int b, u64* sh, int* last) {
  switch (a.op[k].dtype) {
    case F16: digest_block<__half, FExt<MX>>(a, k, b, sh, last); break;
    case F32: digest_block<float, FExt<MX>>(a, k, b, sh, last); break;
    case F64: digest_block<double, FExt<MX>>(a, k, b, sh, last); break;
    case I8: digest_block<int8_t, IExt<MX>>(a, k, b, sh, last); break;
    case I16: digest_block<int16_t, IExt<MX>>(a, k, b, sh, last); break;
    case I32: digest_block<int32_t, IExt<MX>>(a, k, b, sh, last); break;
    case I64: digest_block<int64_t, IExt<MX>>(a, k, b, sh, last); break;
    case U8: digest_block<uint8_t, UExt<MX>>(a, k, b, sh, last); break;
    case U16: digest_block<uint16_t, UExt<MX>>(a, k, b, sh, last); break;
    case U32: digest_block<uint32_t, UExt<MX>>(a, k, b, sh, last); break;
    case U64: digest_block<uint64_t, UExt<MX>>(a, k, b, sh, last); break;
    default: break;  // refused on the host
  }
}

__global__ void __launch_bounds__(DIGEST_THREADS)
digest_kernel(const __grid_constant__ DigestArgs a) {
  __shared__ u64 sh[DIGEST_THREADS / 32];
  __shared__ int last;
  const int b = (int)blockIdx.x;
  int lo = 0, hi = a.nops - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (a.op[mid].first_block <= b) lo = mid; else hi = mid - 1;
  }
  const int k = lo;
  const int local = b - a.op[k].first_block;
  switch (a.op[k].code) {
    case F_INTSUM:
      switch (a.op[k].dtype) {  // the bytes as unsigned of their width
        case I8: case U8: digest_block<uint8_t, USum>(a, k, local, sh, &last); break;
        case I16: case U16: digest_block<uint16_t, USum>(a, k, local, sh, &last); break;
        case I32: case U32: digest_block<uint32_t, USum>(a, k, local, sh, &last); break;
        case I64: case U64: digest_block<uint64_t, USum>(a, k, local, sh, &last); break;
        default: break;
      }
      break;
    case F_FSUM:
      switch (a.op[k].dtype) {
        case F16: digest_block<__half, FSum>(a, k, local, sh, &last); break;
        case F32: digest_block<float, FSum>(a, k, local, sh, &last); break;
        case F64: digest_block<double, FSum>(a, k, local, sh, &last); break;
        default: break;
      }
      break;
    case F_MAX: digest_ext<true>(a, k, local, sh, &last); break;
    case F_MIN: digest_ext<false>(a, k, local, sh, &last); break;
    default: break;
  }
}

static bool is_float(int dt) { return dt == F16 || dt == F32 || dt == F64; }
static bool is_int(int dt) {
  return dt == I8 || dt == U8 || dt == I16 || dt == U16 || dt == I32 || dt == U32 ||
         dt == I64 || dt == U64;
}
static int size_of(int dt) {
  switch (dt) {
    case I8: case U8: return 1;
    case I16: case U16: case F16: return 2;
    case I32: case U32: case F32: return 4;
    default: return 8;
  }
}

// Blocks an operand of n elements of ``size`` bytes takes: one a span
// of DIGEST_THREADS * DIGEST_U 16-byte groups, at most
// DIGEST_MAX_BLOCKS, at least one.  The length and the width alone.
static long long digest_blocks(long long n, int size) {
  const long long groups = (n * size + 15) / 16;
  const long long span = (long long)DIGEST_THREADS * DIGEST_U;
  long long b = (groups + span - 1) / span;
  if (b > DIGEST_MAX_BLOCKS) b = DIGEST_MAX_BLOCKS;
  return b < 1 ? 1 : b;
}

extern "C" {

int ompi_digest_args_size() { return (int)sizeof(DigestArgs); }
int ompi_digest_max_ops() { return DIGEST_MAX_OPS; }
int ompi_digest_threads() { return DIGEST_THREADS; }
int ompi_digest_u() { return DIGEST_U; }
int ompi_digest_max_blocks() { return DIGEST_MAX_BLOCKS; }
int ompi_digest_slots() { return DIGEST_SLOTS; }

// nblocks: the sum of the operands' nblocks, which the wrapper also
// wrote into the prefix table.  Each operand's block count must be
// digest_blocks(n, size) and its load mode must hold for its pointer.
// One launch on ``stream``, nothing else.
int ompi_digest(const DigestArgs* a, int nblocks, void* stream) {
  if (a->nops < 1 || a->nops > DIGEST_MAX_OPS || nblocks < 1 || a->slot < 0 ||
      a->slot >= DIGEST_SLOTS)
    return (int)cudaErrorInvalidValue;
  int next = 0;
  for (int k = 0; k < a->nops; ++k) {
    const DigestOp& o = a->op[k];
    const bool ok = o.code == F_INTSUM   ? is_int(o.dtype)
                    : o.code == F_FSUM   ? is_float(o.dtype)
                    : (o.code == F_MAX || o.code == F_MIN) &&
                          (is_int(o.dtype) || is_float(o.dtype));
    if (!ok || o.n < 0 || o.nblocks != digest_blocks(o.n, size_of(o.dtype)) ||
        o.first_block != next || (o.n > 0 && o.ptr == nullptr) ||
        (uintptr_t)o.ptr % size_of(o.dtype) != 0 || (o.vec != 0 && o.vec != 1) ||
        (o.vec == 1 && (uintptr_t)o.ptr % 16 != 0))
      return (int)cudaErrorInvalidValue;
    next += o.nblocks;
  }
  if (next != nblocks) return (int)cudaErrorInvalidValue;
  digest_kernel<<<nblocks, DIGEST_THREADS, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

}  // extern "C"
