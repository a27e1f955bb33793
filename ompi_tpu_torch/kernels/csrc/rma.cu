// One-sided RMA kernels for the device window (osc/device).
//
// They replace the reference package's RMA programs
// (ompi_tpu/osc/device.py:181-298):
//   * K8 rma_copy — _build_put (:181), _build_get (:203) and
//     _build_lslice (:286): a span of raw bytes copied from one buffer
//     into another at byte offsets.  The reference merges the span into
//     a padded bucket of the target shard with a masked select and
//     ppermutes it between devices; here one launch reads the source
//     through its pointer (peer access when it lies on another card)
//     and writes the destination in place.
//   * K9 rma_acc — _build_acc (:220), plain and fetch: for count
//     elements of the wire dtype, w[i] = op(s[i], w[i]) at a byte
//     offset of the target shard (the MPI accumulate convention,
//     op(origin, target)), and with an ``old`` buffer the pre-op value
//     of w[i] written there first (get_accumulate, fetch_and_op).  The
//     op table is reduce_ops.cuh's, shared with K1, K3 and K6; REPLACE
//     and NO_OP move bytes as they are.
//   * K10 rma_cas — _build_cas (:259): one element swapped for ``new``
//     when it equals ``compare`` by value in its dtype (-0.0 equals
//     0.0, NaN equals nothing, complex compares both parts, bool its
//     0/1 value), the old value written to ``old``.
//
// Atomicity needs no device atomics: the window serialises every
// data-plane op on a target under one lock and enqueues it on one
// stream per target device, so the launches on a target run in lock
// order, one after the other.
//
// What bounds them: bytes.  K8 reads n bytes and writes n; K9 reads s
// and w and writes w (and old), with one operation an element; K10 is
// one thread and is bound by the launch.  K8 moves 16 bytes a thread
// where source and destination share their alignment modulo 16 (the
// head and tail bytes one a thread), else the widest width they share.
//
// K9's design for the H100.  The wrapper splits the op on the target's
// alignment (rma.py _acc_split): the head elements before w reaches a
// 16-byte boundary, a body of vectors of V = 16 / sizeof(T) elements,
// the tail; and for each operand (w, s, old) its mode at the body's
// start: 16-byte aligned, element-aligned, or neither (assembled byte
// by byte: a window with disp_unit 1 takes any byte offset; a w that
// is not element-aligned takes the whole body that way, head 0).  When
// every operand is 16-byte aligned there, the body moves as 16-byte
// words; otherwise element by element, each operand in its own mode
// (one word an element where it is element-aligned; on aligned
// operands this layout read 25 % slower for uint8 and 5 % for int16 on
// an H100, tools/kernel_ab.py).  Either way a block's round is one
// contiguous chunk, consecutive threads on consecutive units, so that
// a warp's loads are whole lines whatever the offsets (a thread's V
// element loads from one vector each touch four lines for a quarter of
// each).  A thread takes ACC_U vectors'
// worth a round (at most 4 ACC_U elements in the element layout): it
// loads all of its w and s, every load issued before its first store
// (__restrict__ pointers), then writes old, folds in registers (Traits:
// half types in float32, rounded once) and writes w.  ACC_U is 1: 1, 2
// and 4 timed within 1.2 % of each other (tools/tile_sweep.py builds
// copies of this file with -DACC_U).  No cache hint: the streaming
// hints (ld/st.global.cs) on every access read within 0.4 % of none on
// an H100, the spread between two identical builds (kernel_ab.py).
// The grid takes as many blocks as the body's chunks, one round a
// thread, which beat a persistent grid of the occupancy API's blocks an
// SM walking the chunks grid-stride (PERF.md §6).  The head's and the
// tail's elements go one a thread on the grid's first threads, so an
// op of a few elements is one block.  ptxas (sm_90a), K9's 140 (dtype,
// op) kernels at ACC_U 1: 24-32 registers (32 for float32 and int32);
// no stack and no spills.
//
// Plain C interface, loaded with ctypes: each entry returns the
// cudaError_t of its launch (0 on success).

#include <cstring>

#include "reduce_ops.cuh"

// --- K8: rma_copy ------------------------------------------------------

struct CopySpan {
  uint8_t* dst;
  const uint8_t* src;
  long long head;   // bytes before the first whole unit
  long long units;  // whole units of the launch's width
  long long tail;   // bytes after the last whole unit
};

template <typename W>
__global__ void __launch_bounds__(256) rma_copy_kernel(const CopySpan a) {
  const long long t0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const W* s = reinterpret_cast<const W*>(a.src + a.head);
  W* d = reinterpret_cast<W*>(a.dst + a.head);
  for (long long k = t0; k < a.units; k += stride) d[k] = s[k];
  if (t0 < a.head) {
    a.dst[t0] = a.src[t0];
  } else if (t0 < a.head + a.tail) {
    const long long k = a.head + a.units * (long long)sizeof(W) + (t0 - a.head);
    a.dst[k] = a.src[k];
  }
}

template <typename W>
static int launch_copy(uint8_t* dst, const uint8_t* src, long long n,
                       cudaStream_t s) {
  CopySpan a;
  a.dst = dst;
  a.src = src;
  a.head = (long long)((sizeof(W) - (uintptr_t)dst % sizeof(W)) % sizeof(W));
  if (a.head > n) a.head = n;
  a.units = (n - a.head) / (long long)sizeof(W);
  a.tail = n - a.head - a.units * (long long)sizeof(W);
  long long work = a.units > a.head + a.tail ? a.units : a.head + a.tail;
  rma_copy_kernel<W><<<grid_for(work, (long long)sm_count() * 8), 256, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// --- K9: rma_acc -------------------------------------------------------

#define ACC_THREADS 256
#ifndef ACC_U
#define ACC_U 1  // 16-byte vectors of w and of s a K9 thread loads a round
#endif

struct AccArgs {
  uint8_t* w;          // the first target element (shard + byte offset)
  const uint8_t* s;    // count origin elements
  uint8_t* old;        // count elements of pre-op values, or null
  long long head;      // elements ahead of the body
  long long nvec;      // body vectors of 16 / sizeof(T) elements
  long long tail;      // elements after the body
  int wm, sm, om;      // each operand's mode at the body's start: 2 its
                       // address 16-byte aligned, 1 element-aligned, 0
                       // neither (byte by byte)
};

template <int N> struct Word;  // the unsigned word of N bytes
template <> struct Word<1> { using t = unsigned char; };
template <> struct Word<2> { using t = unsigned short; };
template <> struct Word<4> { using t = unsigned int; };
template <> struct Word<8> { using t = unsigned long long; };
template <> struct Word<16> { using t = uint4; };

// One word of N bytes at p (aligned to N).
template <int N>
__device__ __forceinline__ typename Word<N>::t ld_word(const uint8_t* p) {
  return *reinterpret_cast<const typename Word<N>::t*>(p);
}

template <int N>
__device__ __forceinline__ void st_word(uint8_t* p, typename Word<N>::t v) {
  *reinterpret_cast<typename Word<N>::t*>(p) = v;
}

// One element at p: one word where p is element-aligned, else byte by
// byte.
template <typename T>
__device__ __forceinline__ T ld_elem(const uint8_t* p, bool aligned) {
  T v;
  if (aligned) {
    const auto x = ld_word<sizeof(T)>(p);
    memcpy(&v, &x, sizeof(T));
  } else {
    uint8_t b[sizeof(T)];
#pragma unroll
    for (int i = 0; i < (int)sizeof(T); ++i) b[i] = p[i];
    memcpy(&v, b, sizeof(T));
  }
  return v;
}

template <typename T>
__device__ __forceinline__ void st_elem(uint8_t* p, const T& v, bool aligned) {
  if (aligned) {
    typename Word<sizeof(T)>::t x;
    memcpy(&x, &v, sizeof(T));
    st_word<sizeof(T)>(p, x);
  } else {
    uint8_t b[sizeof(T)];
    memcpy(b, &v, sizeof(T));
#pragma unroll
    for (int i = 0; i < (int)sizeof(T); ++i) p[i] = b[i];
  }
}

// Units i0 + k * step (k < K, each below n) of one operand's body at p:
// 16-byte words (ELEM false) or elements (ELEM true, each one word where
// ``al``, else byte by byte); every load issued before any use.
template <typename T, int K, bool ELEM>
__device__ __forceinline__ void ld_units(bool al, const uint8_t* p, long long i0,
                                         long long step, long long n, T* v) {
  constexpr int Z = (int)sizeof(T);
  if constexpr (!ELEM) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const long long i = i0 + k * step;
      if (i < n) {
        const uint4 x = ld_word<16>(p + i * 16);
        memcpy(v + k * (16 / Z), &x, 16);
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const long long i = i0 + k * step;
      if (i < n) v[k] = ld_elem<T>(p + i * Z, al);
    }
  }
}

template <typename T, int K, bool ELEM>
__device__ __forceinline__ void st_units(bool al, uint8_t* p, long long i0,
                                         long long step, long long n, const T* v) {
  constexpr int Z = (int)sizeof(T);
  if constexpr (!ELEM) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const long long i = i0 + k * step;
      if (i < n) {
        uint4 x;
        memcpy(&x, v + k * (16 / Z), 16);
        st_word<16>(p + i * 16, x);
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const long long i = i0 + k * step;
      if (i < n) st_elem<T>(p + i * Z, v[k], al);
    }
  }
}

template <typename T, int OP>
__device__ __forceinline__ T acc_one(const T& sv, const T& wv) {
  using Tr = Traits<T>;
  if constexpr (OP == REPLACE) return sv;
  else return Tr::store(apply<OP>(Tr::load(sv), Tr::load(wv)));
}

// One layout of the body: K units a thread a round, a unit a 16-byte
// vector (ELEM false: every operand 16-byte aligned there) or an
// element (ELEM true, each operand in its own mode).  A block's round
// is one contiguous chunk of ACC_THREADS * K units, consecutive threads
// on consecutive units (a warp's loads stay whole lines whatever each
// operand's offset); the blocks walk the chunks grid-stride.
template <typename T, int OP, int K, bool ELEM>
__device__ __forceinline__ void acc_body(const AccArgs& a, uint8_t* __restrict__ w,
                                         const uint8_t* __restrict__ s,
                                         uint8_t* __restrict__ old) {
  constexpr int Z = (int)sizeof(T), E = ELEM ? 1 : 16 / Z;
  constexpr long long CHUNK = (long long)ACC_THREADS * K;
  const long long n = ELEM ? a.nvec * (16 / Z) : a.nvec;  // units
  const long long b0 = a.head * Z;                       // the body's first byte
  for (long long c = blockIdx.x; c * CHUNK < n; c += gridDim.x) {
    const long long i0 = c * CHUNK + threadIdx.x;
    T wv[K * E], sv[K * E];
    ld_units<T, K, ELEM>(a.wm != 0, w + b0, i0, ACC_THREADS, n, wv);
    if constexpr (OP != NO_OP) ld_units<T, K, ELEM>(a.sm != 0, s + b0, i0, ACC_THREADS, n, sv);
    if (old) st_units<T, K, ELEM>(a.om != 0, old + b0, i0, ACC_THREADS, n, wv);
    if constexpr (OP != NO_OP) {
#pragma unroll
      for (int e = 0; e < K * E; ++e) wv[e] = acc_one<T, OP>(sv[e], wv[e]);
      st_units<T, K, ELEM>(a.wm != 0, w + b0, i0, ACC_THREADS, n, wv);
    }
  }
}

// K units a thread a round in the element layout: ACC_U vectors' worth,
// at most 4 ACC_U elements (narrow types keep 4 ACC_U registers an
// operand).
template <typename T>
__host__ __device__ constexpr int acc_elems() {
  return ACC_U * (16 / (int)sizeof(T) < 4 ? 16 / (int)sizeof(T) : 4);
}

template <typename T, int OP>
__global__ void __launch_bounds__(ACC_THREADS) rma_acc_kernel(const AccArgs a) {
  constexpr int Z = (int)sizeof(T);
  uint8_t* __restrict__ w = a.w;
  const uint8_t* __restrict__ s = a.s;
  uint8_t* __restrict__ old = a.old;
  const long long t0 = (long long)blockIdx.x * ACC_THREADS + threadIdx.x;
  if (a.wm == 2 && a.sm == 2 && (!old || a.om == 2))
    acc_body<T, OP, ACC_U, false>(a, w, s, old);
  else
    acc_body<T, OP, acc_elems<T>(), true>(a, w, s, old);
  if (t0 < a.head + a.tail) {  // the edges: one element a thread
    const long long e = t0 < a.head ? t0 : a.head + a.nvec * (16 / Z) + (t0 - a.head);
    const long long b = e * Z;
    const T wv = ld_elem<T>(w + b, a.wm != 0);
    T sv;
    if constexpr (OP != NO_OP) sv = ld_elem<T>(s + b, a.sm != 0);
    if (old) st_elem<T>(old + b, wv, a.om != 0);
    if constexpr (OP != NO_OP) st_elem<T>(w + b, acc_one<T, OP>(sv, wv), a.wm != 0);
  }
}

// As many blocks as the body's chunks (one round a thread; the kernel
// walks grid-stride past the grid's limit), one at least for the edges.
template <typename T, int OP>
static int launch_acc(const AccArgs* a, cudaStream_t s) {
  constexpr int V = 16 / (int)sizeof(T);
  const bool vec = a->wm == 2 && a->sm == 2 && (!a->old || a->om == 2);
  const long long per = (long long)ACC_THREADS * (vec ? ACC_U : acc_elems<T>());
  long long grid = ((vec ? a->nvec : a->nvec * V) + per - 1) / per;
  if (grid > 0x7fffffffLL) grid = 0x7fffffffLL;
  if (grid < 1) grid = 1;
  rma_acc_kernel<T, OP><<<(unsigned)grid, ACC_THREADS, 0, s>>>(*a);
  return (int)cudaGetLastError();
}

template <typename T, int OP>
struct LaunchAcc {
  // a->nvec holds the body's elements: a whole number of vectors
  static int run(const AccArgs* a, cudaStream_t s) {
    constexpr int Z = (int)sizeof(T), V = 16 / Z;
    AccArgs b = *a;
    b.nvec = a->nvec / V;
    // each mode must hold for its operand (a wrong one would fault)
    auto ok = [&](const uint8_t* p, int m) {
      if (m == 0) return true;
      return (uintptr_t)p % Z == 0 &&
             (m == 1 || (m == 2 && (b.nvec == 0 ||
                                    ((uintptr_t)p + b.head * Z) % 16 == 0)));
    };
    if (a->nvec % V || b.head >= V || b.tail >= V || b.wm == 1 ||
        (b.wm == 0 && b.head) || !ok(b.w, b.wm) || !ok(b.s, b.sm) ||
        (b.old && !ok(b.old, b.om)))
      return (int)cudaErrorInvalidValue;
    return launch_acc<T, OP>(&b, s);
  }
};

// --- K10: rma_cas ------------------------------------------------------

template <typename T>
__device__ __forceinline__ bool same_value(T a, T b) { return a == b; }
template <>
__device__ __forceinline__ bool same_value(bool8 a, bool8 b) {
  return (a.v != 0) == (b.v != 0);
}
template <>
__device__ __forceinline__ bool same_value(cplx<float> a, cplx<float> b) {
  return a.re == b.re && a.im == b.im;
}
template <>
__device__ __forceinline__ bool same_value(cplx<double> a, cplx<double> b) {
  return a.re == b.re && a.im == b.im;
}

struct CasArgs {
  uint8_t* w;           // the target element
  const uint8_t* cmp;   // compare value
  const uint8_t* nv;    // new value
  uint8_t* old;         // the old value goes here
};

template <typename T>
__global__ void rma_cas_kernel(const CasArgs a) {
  const T o = ld_elem<T>(a.w, false);
  if (same_value(o, ld_elem<T>(a.cmp, false)))
    st_elem<T>(a.w, ld_elem<T>(a.nv, false), false);
  st_elem<T>(a.old, o, false);
}

template <typename T>
static int launch_cas(const CasArgs& a, cudaStream_t s) {
  rma_cas_kernel<T><<<1, 1, 0, s>>>(a);
  return (int)cudaGetLastError();
}

extern "C" {

// dst and src do not overlap; n > 0.  The launch runs on the current
// device's ``stream``; either pointer may lie on a peer card.
int ompi_rma_copy(void* dst, const void* src, long long n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  uint8_t* d = (uint8_t*)dst;
  const uint8_t* r = (const uint8_t*)src;
  const uintptr_t skew = (uintptr_t)d - (uintptr_t)r;
  if (skew % 16 == 0) return launch_copy<uint4>(d, r, n, s);
  if (skew % 8 == 0) return launch_copy<uint2>(d, r, n, s);
  if (skew % 4 == 0) return launch_copy<uint32_t>(d, r, n, s);
  if (skew % 2 == 0) return launch_copy<uint16_t>(d, r, n, s);
  return launch_copy<uint8_t>(d, r, n, s);
}

// old may be null (accumulate); count > 0 elements, split by the wrapper
// into head + nvec * (16 / size) + tail elements with each operand's
// mode (AccArgs).
int ompi_rma_acc(void* w, const void* src, void* old, long long count,
                 long long head, long long tail, int wm, int sm, int om,
                 int dtype, int op, void* stream) {
  if (count <= 0 || head < 0 || tail < 0 || head + tail > count)
    return (int)cudaErrorInvalidValue;
  AccArgs a;
  a.w = (uint8_t*)w;
  a.s = (const uint8_t*)src;
  a.old = (uint8_t*)old;
  a.head = head;
  a.nvec = count - head - tail;  // elements here; vectors below
  a.tail = tail;
  a.wm = wm;
  a.sm = sm;
  a.om = om;
  return dispatch_reduce<LaunchAcc, true>(dtype, op, &a, (cudaStream_t)stream);
}

int ompi_rma_cas(void* w, const void* cmp, const void* nv, void* old,
                 int dtype, void* stream) {
  CasArgs a;
  a.w = (uint8_t*)w;
  a.cmp = (const uint8_t*)cmp;
  a.nv = (const uint8_t*)nv;
  a.old = (uint8_t*)old;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case F32: return launch_cas<float>(a, s);
    case F64: return launch_cas<double>(a, s);
    case I8: return launch_cas<int8_t>(a, s);
    case U8: return launch_cas<uint8_t>(a, s);
    case I16: return launch_cas<int16_t>(a, s);
    case U16: return launch_cas<uint16_t>(a, s);
    case I32: return launch_cas<int32_t>(a, s);
    case U32: return launch_cas<uint32_t>(a, s);
    case I64: return launch_cas<int64_t>(a, s);
    case U64: return launch_cas<uint64_t>(a, s);
    case BOOL: return launch_cas<bool8>(a, s);
    case C64: return launch_cas<cplx<float>>(a, s);
    case C128: return launch_cas<cplx<double>>(a, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
