// Integrity digest of a table of operands (the SDC plane's checksum).
//
// K11 digest replaces the reference package's host reduction
// obs/integrity.py:221-247 (fold, digest), which runs in numpy and so
// would copy every checked operand from the card to the host.  Here
// the operands stay on the card and only one 8-byte result each
// crosses.  One launch digests a table of up to DIGEST_MAX_OPS
// operands on one device (pointer, element count, dtype, fold code):
// a rank's gate claim (one operand, or one a fused batch's entry), the
// outputs a verify checks, or every deposit a bisection re-digests.
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
// ZERO tolerance, so the same bytes must give the same float64 bits on
// every launch.  The work split depends only on the operand's length
// (nblocks and each block's chunk), every thread folds its elements in
// a fixed order, the block tree folds in a fixed order, and the last
// block of an operand (found by an integer counter, never a float
// atomic) folds the block partials in a fixed order.  Which block
// finishes last changes nothing.
//
// What bounds it: bytes, each operand read once (3.35 TB/s on an H100
// SXM); the fold is one add or compare an element.  The simple design
// reads one element a thread per step (operand pointers carry no
// alignment promise beyond the element), coalesced across the block,
// and gives an operand up to DIGEST_MAX_BLOCKS blocks of
// DIGEST_THREADS threads, at least DIGEST_PER_THREAD elements a thread.
//
// Plain C interface, loaded with ctypes: the entry returns the
// cudaError_t of its memset and launch (0 on success).

#include "reduce_ops.cuh"

#define DIGEST_MAX_OPS 96
#define DIGEST_THREADS 256
#define DIGEST_PER_THREAD 16
#define DIGEST_MAX_BLOCKS 1024

enum Fold { F_INTSUM = 1, F_FSUM = 2, F_MAX = 3, F_MIN = 4 };

struct DigestOp {
  const void* ptr;
  long long n;      // elements
  int first_block;  // prefix table: first block of this operand
  int nblocks;      // a function of n alone
  int dtype;        // reduce_ops.cuh Dtype
  int code;         // Fold
};

struct DigestArgs {
  DigestOp op[DIGEST_MAX_OPS];
  unsigned long long* partial;  // one slot a block
  unsigned int* done;           // one counter an operand, zeroed first
  unsigned long long* out;      // one result an operand
  int nops;
};

typedef unsigned long long u64;

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

// Fold every thread's value into thread 0's, in a fixed tree order.
template <typename R>
__device__ __forceinline__ typename R::A block_fold(typename R::A v, u64* sh) {
  using A = typename R::A;
  A* s = reinterpret_cast<A*>(sh);
  s[threadIdx.x] = v;
  __syncthreads();
  for (int w = DIGEST_THREADS / 2; w > 0; w >>= 1) {
    if ((int)threadIdx.x < w) s[threadIdx.x] = R::op(s[threadIdx.x], s[threadIdx.x + w]);
    __syncthreads();
  }
  A r = s[0];
  __syncthreads();  // s is written again by the finish
  return r;
}

template <typename T, typename R>
__device__ void digest_block(const DigestArgs& a, int k, int b, u64* sh, int* last) {
  using A = typename R::A;
  const DigestOp& o = a.op[k];
  const T* p = reinterpret_cast<const T*>(o.ptr);
  const long long chunk = (o.n + o.nblocks - 1) / o.nblocks;
  const long long lo = (long long)b * chunk;
  const long long hi = lo + chunk < o.n ? lo + chunk : o.n;
  A acc = R::id();
#pragma unroll 4
  for (long long i = lo + threadIdx.x; i < hi; i += DIGEST_THREADS)
    acc = R::op(acc, (A)widen(p[i]));
  const A r = block_fold<R>(acc, sh);
  if (threadIdx.x == 0) {
    a.partial[o.first_block + b] = R::bits(r);
    __threadfence();
    *last = atomicAdd(&a.done[k], 1u) == (unsigned)(o.nblocks - 1);
  }
  __syncthreads();
  if (!*last) return;
  __threadfence();
  A fin = R::id();
  for (int i = threadIdx.x; i < o.nblocks; i += DIGEST_THREADS)
    fin = R::op(fin, R::from(__ldcg(&a.partial[o.first_block + i])));
  const A f = block_fold<R>(fin, sh);
  if (threadIdx.x == 0) a.out[k] = o.n == 0 ? 0ull : R::bits(f);
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
  __shared__ u64 sh[DIGEST_THREADS];
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

extern "C" {

int ompi_digest_args_size() { return (int)sizeof(DigestArgs); }
int ompi_digest_max_ops() { return DIGEST_MAX_OPS; }
int ompi_digest_threads() { return DIGEST_THREADS; }
int ompi_digest_per_thread() { return DIGEST_PER_THREAD; }
int ompi_digest_max_blocks() { return DIGEST_MAX_BLOCKS; }

// nblocks: the sum of the operands' nblocks, which the wrapper also
// wrote into the prefix table.  Zeroes the done counters, then
// launches; both on ``stream``.
int ompi_digest(const DigestArgs* a, int nblocks, void* stream) {
  if (a->nops < 1 || a->nops > DIGEST_MAX_OPS || nblocks < 1)
    return (int)cudaErrorInvalidValue;
  int next = 0;
  for (int k = 0; k < a->nops; ++k) {
    const DigestOp& o = a->op[k];
    const bool ok = o.code == F_INTSUM   ? is_int(o.dtype)
                    : o.code == F_FSUM   ? is_float(o.dtype)
                    : (o.code == F_MAX || o.code == F_MIN) &&
                          (is_int(o.dtype) || is_float(o.dtype));
    if (!ok || o.n < 0 || o.nblocks < 1 || o.nblocks > DIGEST_MAX_BLOCKS ||
        o.first_block != next || (o.n > 0 && o.ptr == nullptr))
      return (int)cudaErrorInvalidValue;
    next += o.nblocks;
  }
  if (next != nblocks) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(a->done, 0, sizeof(unsigned int) * a->nops, s);
  if (e != cudaSuccess) return (int)e;
  digest_kernel<<<nblocks, DIGEST_THREADS, 0, s>>>(*a);
  return (int)cudaGetLastError();
}

}  // extern "C"
