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
// Its peer mode serves the mesh tier (ranks on distinct devices): one
// launch per destination device writes that device's output and reads
// the N sources through their pointers, which may lie on other cards
// (peer access) — the all_gather / all_to_all halves of the
// reference's _build_mesh_collective (coll/device.py:997) and the
// segbcast / sega2a schedules of coll/pipeline.py:192.  Strides and a
// write limit let one launch move a column segment of every block
// (sega2a) or gather ragged stripes (the allgather half of a mesh
// allreduce) without staging copies.  A null source pointer writes
// zeros into its block in the same launch: the PROC_NULL neighbours
// of the cartesian halo gather, topo/neighbor.py:160-186, whose
// member outputs are one peer launch each.
//
// What bounds them: bytes.  A reduction does N-1 operations per N
// elements read, far below the card's operations-per-byte balance, so
// the least time is (bytes read once + bytes written once) / 3.35 TB/s.
// The simple design answers that with the two things that matter for
// a streaming kernel: every byte is read once and written once (no
// stacked copy in device memory, unlike jnp.stack), and loads and
// stores are 16 bytes a thread where the pointers allow it, neighbour
// threads on neighbour addresses.  The N input and M output pointers
// travel by value in the kernel's parameter block (a fixed cap of
// MAX_PTRS each side, 2 KiB, under the 4 KiB parameter limit), so a
// launch needs no host-to-device copy.
//
// The op and dtype templates, and the semantics they fix (NaN,
// wrapping, half-precision accumulation, complex rounding), live in
// reduce_ops.cuh, which K3 fused_batch (fused.cu) shares.
//
// Plain C interface, loaded with ctypes: each entry returns the
// cudaError_t of its launch (0 on success).

#include "reduce_ops.cuh"

#define MAX_PTRS 128

struct ReduceArgs {
  const void* in[MAX_PTRS];
  void* out[MAX_PTRS];
  long long n;       // elements in each input
  long long stripe;  // scatter: elements per output
  int nin;
  int nout;
  int scatter;
};

// out[il] + j * out_stride <- in[j] + (first_out + il) * in_stride,
// chunk units a block, clipped so that no unit at or past ``limit``
// (counted from out[il]) is written; zeros where in[j] is null.
// Stacked alltoall: in_stride = out_stride = chunk; allgather:
// in_stride = 0.
struct CopyArgs {
  const void* in[MAX_PTRS];
  void* out[MAX_PTRS];
  long long chunk;       // units (of the launch's width) in one block
  long long in_stride;   // units from source block i to block i + 1
  long long out_stride;  // units from destination block j to j + 1
  long long limit;       // units of each destination that may be written
  int n;                 // sources
  int nout;              // destinations of this launch
  int first_out;         // rank of out[0]
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

template <typename W>
__global__ void __launch_bounds__(256) stacked_copy_kernel(const CopyArgs a) {
  const int il = blockIdx.y / a.n;  // output of this launch (receiver)
  const int j = blockIdx.y % a.n;   // block of that output (sender)
  const long long i = (long long)a.first_out + il;
  W* dst = reinterpret_cast<W*>(a.out[il]) + (long long)j * a.out_stride;
  long long cnt = a.limit - (long long)j * a.out_stride;
  if (cnt > a.chunk) cnt = a.chunk;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long k0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (a.in[j] == nullptr) {  // null source: uniform across the block
    const W zero{};
    for (long long k = k0; k < cnt; k += stride) dst[k] = zero;
    return;
  }
  const W* src = reinterpret_cast<const W*>(a.in[j]) + i * a.in_stride;
  for (long long k = k0; k < cnt; k += stride) dst[k] = src[k];
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

// width: bytes a thread moves at once (16, 8, 4, 2 or 1); the wrapper
// picks the largest that divides the block size, the strides, the
// limit and every pointer.
int ompi_stacked_copy(const CopyArgs* a, int width, void* stream) {
  if (a->n < 1 || a->n > MAX_PTRS || a->nout < 1 || a->nout > MAX_PTRS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long rows = (long long)a->n * a->nout;
  long long cap = ((long long)sm_count() * 16 + rows - 1) / rows;
  dim3 grid(grid_for(a->chunk, cap), (unsigned)rows);
  switch (width) {
    case 16: stacked_copy_kernel<uint4><<<grid, 256, 0, s>>>(*a); break;
    case 8: stacked_copy_kernel<uint2><<<grid, 256, 0, s>>>(*a); break;
    case 4: stacked_copy_kernel<uint32_t><<<grid, 256, 0, s>>>(*a); break;
    case 2: stacked_copy_kernel<uint16_t><<<grid, 256, 0, s>>>(*a); break;
    case 1: stacked_copy_kernel<uint8_t><<<grid, 256, 0, s>>>(*a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
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
