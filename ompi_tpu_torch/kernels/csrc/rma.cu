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
// K9 loads and stores whole elements where every pointer is aligned to
// the element and assembles them byte by byte where it is not (a
// window with disp_unit 1 takes any byte offset).
//
// Plain C interface, loaded with ctypes: each entry returns the
// cudaError_t of its launch (0 on success).

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

struct AccArgs {
  uint8_t* w;          // the first target element (shard + byte offset)
  const uint8_t* s;    // count origin elements
  uint8_t* old;        // count elements of pre-op values, or null
  long long count;
};

template <typename T, bool ALIGNED>
__device__ __forceinline__ T load_elem(const uint8_t* p) {
  if constexpr (ALIGNED) {
    return *reinterpret_cast<const T*>(p);
  } else {
    T v;
    uint8_t* q = reinterpret_cast<uint8_t*>(&v);
#pragma unroll
    for (int i = 0; i < (int)sizeof(T); ++i) q[i] = p[i];
    return v;
  }
}

template <typename T, bool ALIGNED>
__device__ __forceinline__ void store_elem(uint8_t* p, T v) {
  if constexpr (ALIGNED) {
    *reinterpret_cast<T*>(p) = v;
  } else {
    const uint8_t* q = reinterpret_cast<const uint8_t*>(&v);
#pragma unroll
    for (int i = 0; i < (int)sizeof(T); ++i) p[i] = q[i];
  }
}

template <typename T, int OP, bool ALIGNED>
__global__ void __launch_bounds__(256) rma_acc_kernel(const AccArgs a) {
  using Tr = Traits<T>;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < a.count; i += stride) {
    const long long b = i * (long long)sizeof(T);
    const T wv = load_elem<T, ALIGNED>(a.w + b);
    if (a.old) store_elem<T, ALIGNED>(a.old + b, wv);
    if constexpr (OP != NO_OP) {
      const T sv = load_elem<T, ALIGNED>(a.s + b);
      if constexpr (OP == REPLACE) {
        store_elem<T, ALIGNED>(a.w + b, sv);
      } else {
        store_elem<T, ALIGNED>(
            a.w + b, Tr::store(apply<OP>(Tr::load(sv), Tr::load(wv))));
      }
    }
  }
}

template <typename T, int OP>
struct LaunchAcc {
  static int run(const AccArgs* a, cudaStream_t s) {
    const uintptr_t bits = (uintptr_t)a->w | (uintptr_t)a->s | (uintptr_t)a->old;
    const unsigned grid = grid_for(a->count, (long long)sm_count() * 8);
    if (bits % sizeof(T) == 0) {
      rma_acc_kernel<T, OP, true><<<grid, 256, 0, s>>>(*a);
    } else {
      rma_acc_kernel<T, OP, false><<<grid, 256, 0, s>>>(*a);
    }
    return (int)cudaGetLastError();
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
  const T o = load_elem<T, false>(a.w);
  if (same_value(o, load_elem<T, false>(a.cmp)))
    store_elem<T, false>(a.w, load_elem<T, false>(a.nv));
  store_elem<T, false>(a.old, o);
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

// old may be null (accumulate); count > 0.
int ompi_rma_acc(void* w, const void* src, void* old, long long count,
                 int dtype, int op, void* stream) {
  if (count <= 0) return (int)cudaErrorInvalidValue;
  AccArgs a;
  a.w = (uint8_t*)w;
  a.s = (const uint8_t*)src;
  a.old = (uint8_t*)old;
  a.count = count;
  return dispatch_reduce<LaunchAcc, true>(dtype, op, &a,
                                          (cudaStream_t)stream);
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
