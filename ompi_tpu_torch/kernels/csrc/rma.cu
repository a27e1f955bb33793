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
// one thread and is bound by the launch.
//
// K8's design for the H100: one design for every skew.  The wrapper
// plans the copy from the two integer addresses (rma.py _copy_plan):
// the head bytes up to dst's first 16-byte boundary, a body of whole
// 16-byte destination words, the tail bytes, and the source's shift
// (src + head) mod 16.  Every store of the body is an aligned 16-byte
// word, whatever the skew between the pointers.  A thread owns COPY_U
// consecutive destination words and issues all of its loads before
// its first store (__restrict__ pointers): at shift 0, COPY_U aligned
// source words; at any other shift, the COPY_U + 1 aligned 16-byte
// source words that cover its span, each output word built from two
// neighbouring source words with funnel shifts of their 32-bit lanes
// (the lane offset shift / 4 is a template constant, so the words
// stay in registers; the bit offset 8 (shift mod 4) is uniform).
// Neighbouring threads share one source word at their edges, in the
// same lines, so DRAM traffic does not grow.  Reads outside the span:
// the first and the last aligned source word may hold up to 15 bytes
// outside [src, src + n); they are read and never used, and they lie
// in the same 16-byte granule as a byte of the span, so they never
// cross a page (a granule never does).  The grid takes as many blocks
// as the body has chunks of COPY_THREADS * COPY_U words, one round a
// thread (the shape measured faster than a persistent grid for K9,
// PERF.md §6); the head and tail bytes go one a thread to the grid's first
// threads, so a copy of a few bytes is one block.  A source on a peer
// card (NVLink, --cards runs) takes the same code.  The C entry
// re-checks the plan against its pointers: a store or load that is not
// 16-byte aligned would fault the context.  COPY_U is a constant of
// this source (tools/tile_sweep.py builds -D copies to sweep it): 1,
// since 2 and 4 read 4 % and 56 % slower aligned and 19 % and 102-104 %
// slower at skews 1 and 4 on an H100 (a lane's words 32 and 64 bytes
// apart: more lines an instruction).  A ring of bulk copies through
// shared memory (bulk.cuh) on the shift-0 body read 8 % slower than
// this design (tools/kernel_ab.py), so K8 keeps one design for every
// skew.  ptxas (sm_90a): its five kernels 16-22 registers; no stack and
// no spills.
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

#define COPY_THREADS 256
#ifndef COPY_U
#define COPY_U 1  // consecutive 16-byte destination words a K8 thread owns
#endif

struct CopyArgs {
  uint8_t* dst;        // the span's first destination byte
  const uint8_t* src;  // the span's first source byte
  long long head;      // bytes before dst's first 16-byte boundary
  long long words;     // whole 16-byte destination words of the body
  long long tail;      // bytes after the body
  int shift;           // (src + head) mod 16
};

// Bytes [4 Q + r, 4 Q + r + 16) of the 32 bytes lo:hi (lo first), r8 =
// 8 r bits, r < 4: four funnel shifts of neighbouring 32-bit lanes.
template <int Q>
__device__ __forceinline__ uint4 shifted(const uint4& lo, const uint4& hi,
                                         unsigned r8) {
  const unsigned c[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  uint4 o;
  o.x = __funnelshift_r(c[Q], c[Q + 1], r8);
  o.y = __funnelshift_r(c[Q + 1], c[Q + 2], r8);
  o.z = __funnelshift_r(c[Q + 2], c[Q + 3], r8);
  o.w = __funnelshift_r(c[Q + 3], c[Q + 4], r8);
  return o;
}

// Q < 0: shift 0 (source words aligned as the destination's); else the
// shift's lane offset shift / 4.
template <int Q>
__global__ void __launch_bounds__(COPY_THREADS) rma_copy_kernel(const CopyArgs a) {
  uint8_t* __restrict__ d = a.dst;
  const uint8_t* __restrict__ s = a.src;
  const long long t = (long long)blockIdx.x * COPY_THREADS + threadIdx.x;
  const long long j0 = t * COPY_U;  // the thread's first destination word
  if (j0 < a.words) {
    uint4* __restrict__ dw = reinterpret_cast<uint4*>(d + a.head);
    const uint4* __restrict__ sw =
        reinterpret_cast<const uint4*>(s + a.head - a.shift);
    const int m = a.words - j0 < COPY_U ? (int)(a.words - j0) : COPY_U;
    constexpr int L = Q < 0 ? COPY_U : COPY_U + 1;  // source words loaded
    uint4 v[L];
#pragma unroll
    for (int k = 0; k < L; ++k)
      if (k < m + (Q < 0 ? 0 : 1)) v[k] = sw[j0 + k];
    const unsigned r8 = 8u * (unsigned)(a.shift & 3);
#pragma unroll
    for (int k = 0; k < COPY_U; ++k) {
      if (k < m) {
        if constexpr (Q < 0) dw[j0 + k] = v[k];
        else dw[j0 + k] = shifted<Q>(v[k], v[k + 1], r8);
      }
    }
  }
  if (t < a.head) {  // the edges: one byte a thread
    d[t] = s[t];
  } else if (t < a.head + a.tail) {
    const long long k = a.head + a.words * 16 + (t - a.head);
    d[k] = s[k];
  }
}

template <int Q>
static int launch_copy(const CopyArgs& a, cudaStream_t s) {
  const long long per = (long long)COPY_THREADS * COPY_U;
  long long grid = (a.words + per - 1) / per;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;  // over 8 TiB
  if (grid < 1) grid = 1;
  rma_copy_kernel<Q><<<(unsigned)grid, COPY_THREADS, 0, s>>>(a);
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

// dst and src do not overlap; n > 0 bytes, planned by the wrapper
// (rma.py _copy_plan) as head + 16 words + tail with the source's
// shift, which must hold for the pointers.  The launch runs on the
// current device's ``stream``; either pointer may lie on a peer card.
int ompi_rma_copy(void* dst, const void* src, long long n, long long head,
                  long long words, long long tail, int shift, void* stream) {
  const long long to16 = (long long)((16 - (uintptr_t)dst % 16) % 16);
  if (n <= 0 || head != (to16 < n ? to16 : n) || tail < 0 || tail >= 16 ||
      words < 0 || head + 16 * words + tail != n ||
      shift != (int)(((uintptr_t)src + head) % 16))
    return (int)cudaErrorInvalidValue;
  CopyArgs a;
  a.dst = (uint8_t*)dst;
  a.src = (const uint8_t*)src;
  a.head = head;
  a.words = words;
  a.tail = tail;
  a.shift = shift;
  cudaStream_t s = (cudaStream_t)stream;
  switch (shift == 0 ? -1 : shift / 4) {
    case -1: return launch_copy<-1>(a, s);
    case 0: return launch_copy<0>(a, s);
    case 1: return launch_copy<1>(a, s);
    case 2: return launch_copy<2>(a, s);
    default: return launch_copy<3>(a, s);
  }
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
