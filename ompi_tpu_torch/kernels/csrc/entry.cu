// K12 driver_step: the driver's single-card collective step in one
// launch.
//
// It replaces the reference package's collective_step
// (__graft_entry__.py:17-45), the jitted program that models R ranks
// co-located on one card: on x of shape (R, N), N % R == 0, n = N / R,
//   red       = x.sum(0)                       (allreduce)
//   rs        = red.reshape(R, n)              (reduce_scatter)
//   a2a[i, c] = x[c / n, i * n + c % n]        (alltoall)
//   out[i, c] = red[c] + a2a[i, c]
// and returns (out, rs).  The fold over the R rows is K1's: a left fold
// in rank order with reduce_ops.cuh's SUM, float16 and bfloat16 in
// float32; red is rounded to the input type once, then each output is
// one SUM of the rounded red and the a2a element, rounded once.
// driver_step_plain (kernels/entry.py) computes the same in torch ops.
//
// What bounds it: bytes.  It reads x and writes out and rs, (2 R N + N)
// elements, at one add a byte or less.  The simple design: one thread
// owns V consecutive columns (16 bytes where n, the pointers and the
// type allow, else one column), folds them down the R rows, writes rs,
// then reads the V columns of each a2a row (contiguous: a row's V
// columns lie in one source row) and writes the V outputs of every
// row.  The a2a half reads x a second time; at the driver's sizes that
// read misses L2, which is this design's cost against the bound.
//
// Plain C interface, loaded with ctypes: the entry returns the
// cudaError_t of its launch (0 on success).

#include "reduce_ops.cuh"

#define MAX_ROWS 128  // K1's cap on the ranks it folds

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T x[V];
};

template <typename T, int OP, int V>
__global__ void __launch_bounds__(256)
    driver_step_kernel(const T* __restrict__ x, T* __restrict__ out,
                       T* __restrict__ rs, int rows, long long N,
                       long long n) {
  using Tr = Traits<T>;
  using A = typename Tr::A;
  using VT = Vec<T, V>;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long nvec = N / V;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       v < nvec; v += stride) {
    const long long c = v * V;  // first column of this thread
    A acc[V];
    VT w = reinterpret_cast<const VT*>(x)[v];
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = first<OP>(Tr::load(w.x[k]));
    for (int r = 1; r < rows; ++r) {
      w = reinterpret_cast<const VT*>(x + (long long)r * N)[v];
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] = apply<OP>(acc[k], Tr::load(w.x[k]));
    }
    // the outputs add the red rounded to T, as the plain version does
    VT red;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      red.x[k] = Tr::store(acc[k]);
      acc[k] = Tr::load(red.x[k]);
    }
    reinterpret_cast<VT*>(rs)[v] = red;
    // a2a row i's columns c..c+V-1 are x[c / n, i * n + c % n ...]
    const T* blk = x + (c / n) * N + c % n;
    for (int i = 0; i < rows; ++i) {
      const VT a = *reinterpret_cast<const VT*>(blk + (long long)i * n);
      VT o;
#pragma unroll
      for (int k = 0; k < V; ++k)
        o.x[k] = Tr::store(apply<OP>(acc[k], Tr::load(a.x[k])));
      reinterpret_cast<VT*>(out + (long long)i * N)[v] = o;
    }
  }
}

template <typename T, int OP>
struct LaunchStep {
  static int run(const void* x, void* out, void* rs, int rows, long long N,
                 int vec, cudaStream_t s) {
    constexpr int V = 16 / sizeof(T);
    const long long cap = (long long)sm_count() * 8;
    const long long n = N / rows;
    const T* xp = static_cast<const T*>(x);
    T* op = static_cast<T*>(out);
    T* rp = static_cast<T*>(rs);
    if (vec) {
      driver_step_kernel<T, OP, V>
          <<<grid_for(N / V, cap), 256, 0, s>>>(xp, op, rp, rows, N, n);
    } else {
      driver_step_kernel<T, OP, 1>
          <<<grid_for(N, cap), 256, 0, s>>>(xp, op, rp, rows, N, n);
    }
    return (int)cudaGetLastError();
  }
};

// Every dtype of reduce_ops.cuh's table, SUM only (every dtype takes
// SUM); cudaErrorInvalidValue for a code outside the table.
template <template <typename, int> class L, typename... Args>
static int dispatch_sum(int dtype, Args... args) {
  switch (dtype) {
    case F16: return L<__half, SUM>::run(args...);
    case BF16: return L<__nv_bfloat16, SUM>::run(args...);
    case F32: return L<float, SUM>::run(args...);
    case F64: return L<double, SUM>::run(args...);
    case I8: return L<int8_t, SUM>::run(args...);
    case U8: return L<uint8_t, SUM>::run(args...);
    case I32: return L<int32_t, SUM>::run(args...);
    case I64: return L<int64_t, SUM>::run(args...);
    case BOOL: return L<bool8, SUM>::run(args...);
    case I16: return L<int16_t, SUM>::run(args...);
    case U16: return L<uint16_t, SUM>::run(args...);
    case U32: return L<uint32_t, SUM>::run(args...);
    case U64: return L<uint64_t, SUM>::run(args...);
    case C64: return L<cplx<float>, SUM>::run(args...);
    case C128: return L<cplx<double>, SUM>::run(args...);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" {

int ompi_driver_step_max_rows() { return MAX_ROWS; }

// x: (rows, N) contiguous; out: (rows, N); rs: N elements.  vec != 0:
// n = N / rows is a whole number of 16-byte vectors and every pointer
// is 16-byte aligned; the wrapper decides.
int ompi_driver_step(const void* x, void* out, void* rs, int dtype, int rows,
                     long long N, int vec, void* stream) {
  if (rows < 1 || rows > MAX_ROWS || N < 1 || N % rows)
    return (int)cudaErrorInvalidValue;
  return dispatch_sum<LaunchStep>(dtype, x, out, rs, rows, N, vec,
                                  (cudaStream_t)stream);
}

}  // extern "C"
