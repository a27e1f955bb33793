// Mesh-tier kernels: collectives for ranks that own distinct devices
// (the port of coll/tpu).  Each collective is run by one controller
// thread that holds every member's tensor, each on its member's
// device, and launches once per destination device; a launch reads
// the other members' buffers through their pointers (peer access on a
// host whose cards are joined by NVLink, plain loads when the logical
// devices share one card).
//
// K6 mesh_fold replaces the reductions of the reference package's mesh
// programs: _build_mesh_collective (coll/device.py:997: psum, pmax,
// pmin, all_gather + fold, psum_scatter), the segring and segrd
// schedules of _build_seg_kernel (coll/pipeline.py:192) and their
// batched form _compile_mesh (coll/plan.py:257), and the group
// reductions of the fused mesh batch (coll/fusion.py:257).  A launch
// on device d folds the N members' inputs over the elements
// [lo, lo + len) — the stripe d owns — and writes them to d's stripe
// buffer: a reduce-scatter by pulls.  The allgather half that follows
// is K2 in peer mode (stacked.cu).  The reference circulates partial
// sums hop by hop (P - 1 ppermutes a phase); here one pull a device
// computes what the hops compute, in the same order, so that every
// element is the same chain of binary ops as the reference's:
//   * linear: a left fold over order[(rot + k) % N], k = 0..N-1, where
//     rot = ((g % ring_seg) / ring_m) for the segring schedule (stripe
//     c of a segment is the left fold over ranks c, c+1, ..., c-1) and
//     0 otherwise (rank order: psum and the gather folds);
//   * tree: the balanced tree of segrd over order[0..N-1] (N a power
//     of two), each node op(lower half, upper half), evaluated as a
//     binary counter over a small stack.
// The op and dtype templates are reduce_ops.cuh's, so the semantics
// are K1's: NaN, wrapping, half-precision accumulation.
//
// K7 slot_pack replaces _build_pack (coll/fusion.py:231): one launch
// packs one rank's slots of one fused group into one buffer through a
// slot table (source pointer, length, offset), writing zeros for the
// slots flagged as non-root bcast entries.
//
// What bounds them: bytes.  K6 does N-1 operations per N elements
// read; K7 none.  Least time: (bytes read once + bytes written once) /
// the slower of the card's memory (3.35 TB/s on an H100) and, for
// reads from another card, NVLink (450 GB/s each way).  The simple
// design reads every input element once and writes every output
// element once, 16 bytes a thread where the pointers allow (K6's
// linear mode), one element a thread otherwise.  Pointers and tables
// travel by value in the parameter block (under the 4 KiB limit).
//
// Plain C interface, loaded with ctypes: each entry returns the
// cudaError_t of its launch (0 on success).

#include "reduce_ops.cuh"

#define MESH_MAX_PTRS 128
#define PACK_MAX_SLOTS 64
#define PACK_UNITS 1024  // units one block of K7 covers

struct FoldArgs {
  const void* in[MESH_MAX_PTRS];
  void* out;           // len elements: out[k] = fold at element lo + k
  long long lo;        // first element (an index into every input)
  long long len;       // elements folded by this launch
  long long ring_seg;  // segring: segment length; 0: no rotation
  long long ring_m;    // segring: stripe length inside a segment
  int nin;
  int tree;            // 1: balanced tree over order[] (nin a power of 2)
  unsigned char order[MESH_MAX_PTRS];
};

struct PackSlot {
  const void* src;
  long long n;          // units of this slot
  long long off;        // unit offset of the slot in the packed buffer
  int first_block;      // prefix table: first block of this slot
  int zero;             // 1: write zeros (a non-root bcast entry)
};

struct PackArgs {
  PackSlot slot[PACK_MAX_SLOTS];
  void* out;
  int nslots;
};

template <typename T, int V>
struct alignas(sizeof(T) * V) MVec {
  T x[V];
};

__device__ __forceinline__ int rotation(const FoldArgs& a, long long g) {
  if (a.ring_m == 0) return 0;
  return (int)(((g % a.ring_seg) / a.ring_m) % a.nin);
}

// One element, linear fold or tree.
template <typename T, int OP>
__device__ __forceinline__ T fold_one(const FoldArgs& a, long long g) {
  using Tr = Traits<T>;
  using A = typename Tr::A;
  const int n = a.nin;
  if (a.tree) {
    A stack[8];
    int top = 0;
    for (int r = 0; r < n; ++r) {
      A v = first<OP>(Tr::load(reinterpret_cast<const T*>(a.in[a.order[r]])[g]));
      for (int c = r; c & 1; c >>= 1) v = apply<OP>(stack[--top], v);
      stack[top++] = v;
    }
    return Tr::store(stack[0]);
  }
  int k = rotation(a, g);
  A acc = first<OP>(Tr::load(reinterpret_cast<const T*>(a.in[a.order[k]])[g]));
  for (int s = 1; s < n; ++s) {
    if (++k == n) k = 0;
    acc = apply<OP>(acc, Tr::load(reinterpret_cast<const T*>(a.in[a.order[k]])[g]));
  }
  return Tr::store(acc);
}

// Linear mode, V elements a thread: every input pointer, lo and out are
// aligned to V elements, and (segring) V divides ring_m, so the V
// elements of a vector share one rotation.
template <typename T, int OP, int V>
__global__ void __launch_bounds__(256) mesh_fold_vec(const __grid_constant__ FoldArgs a) {
  using Tr = Traits<T>;
  using A = typename Tr::A;
  using VT = MVec<T, V>;
  const int n = a.nin;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nvec = a.len / V;
  const long long base = a.lo / V;
  for (long long j = t0; j < nvec; j += stride) {
    int k = rotation(a, a.lo + j * V);
    A acc[V];
    VT v = reinterpret_cast<const VT*>(a.in[a.order[k]])[base + j];
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = first<OP>(Tr::load(v.x[e]));
    for (int s = 1; s < n; ++s) {
      if (++k == n) k = 0;
      VT w = reinterpret_cast<const VT*>(a.in[a.order[k]])[base + j];
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = apply<OP>(acc[e], Tr::load(w.x[e]));
    }
    VT o;
#pragma unroll
    for (int e = 0; e < V; ++e) o.x[e] = Tr::store(acc[e]);
    reinterpret_cast<VT*>(a.out)[j] = o;
  }
  for (long long i = nvec * V + t0; i < a.len; i += stride)
    reinterpret_cast<T*>(a.out)[i] = fold_one<T, OP>(a, a.lo + i);
}

// Any mode, one element a thread.
template <typename T, int OP>
__global__ void __launch_bounds__(256) mesh_fold_scalar(const __grid_constant__ FoldArgs a) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < a.len; i += stride)
    reinterpret_cast<T*>(a.out)[i] = fold_one<T, OP>(a, a.lo + i);
}

template <typename T, int OP>
struct LaunchFold {
  static int run(const FoldArgs* a, int vec, cudaStream_t s) {
    constexpr int V = 16 / sizeof(T);
    const long long cap = (long long)sm_count() * 8;
    if (vec && V > 1) {
      mesh_fold_vec<T, OP, V><<<grid_for(a->len / V, cap), 256, 0, s>>>(*a);
    } else {
      mesh_fold_scalar<T, OP><<<grid_for(a->len, cap), 256, 0, s>>>(*a);
    }
    return (int)cudaGetLastError();
  }
};

template <typename W>
__global__ void __launch_bounds__(256) slot_pack_kernel(const __grid_constant__ PackArgs a) {
  const int b = (int)blockIdx.x;
  int lo = 0, hi = a.nslots - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (a.slot[mid].first_block <= b) lo = mid; else hi = mid - 1;
  }
  const PackSlot& sl = a.slot[lo];
  const long long begin = (long long)(b - sl.first_block) * PACK_UNITS;
  const long long end = begin + PACK_UNITS < sl.n ? begin + PACK_UNITS : sl.n;
  const W* src = reinterpret_cast<const W*>(sl.src);
  W* dst = reinterpret_cast<W*>(a.out) + sl.off;
  for (long long i = begin + threadIdx.x; i < end; i += 256)
    dst[i] = sl.zero ? W() : src[i];
}

extern "C" {

int ompi_fold_args_size() { return (int)sizeof(FoldArgs); }
int ompi_pack_args_size() { return (int)sizeof(PackArgs); }
int ompi_mesh_max_ptrs() { return MESH_MAX_PTRS; }
int ompi_pack_max_slots() { return PACK_MAX_SLOTS; }
int ompi_pack_units() { return PACK_UNITS; }

// vec != 0: linear mode, every pointer and lo aligned to 16 bytes and
// (segring) ring_m a whole number of 16-byte vectors; the wrapper
// decides.
int ompi_mesh_fold(const FoldArgs* a, int dtype, int op, int vec,
                   void* stream) {
  if (a->nin < 1 || a->nin > MESH_MAX_PTRS || a->len < 1 ||
      (a->tree && (a->nin & (a->nin - 1))) ||
      (a->ring_m != 0 && (a->ring_seg < 1 || a->ring_m < 1)))
    return (int)cudaErrorInvalidValue;
  return dispatch_reduce<LaunchFold>(dtype, op, a, a->tree ? 0 : vec,
                                     (cudaStream_t)stream);
}

// width: bytes a unit holds (16, 8, 4, 2 or 1), dividing every slot's
// pointer, length and offset and the output pointer; nblocks: the sum
// over slots of ceil(n / PACK_UNITS), also in the prefix table.
int ompi_slot_pack(const PackArgs* a, int width, int nblocks, void* stream) {
  if (a->nslots < 1 || a->nslots > PACK_MAX_SLOTS || nblocks < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (width) {
    case 16: slot_pack_kernel<uint4><<<nblocks, 256, 0, s>>>(*a); break;
    case 8: slot_pack_kernel<uint2><<<nblocks, 256, 0, s>>>(*a); break;
    case 4: slot_pack_kernel<uint32_t><<<nblocks, 256, 0, s>>>(*a); break;
    case 2: slot_pack_kernel<uint16_t><<<nblocks, 256, 0, s>>>(*a); break;
    case 1: slot_pack_kernel<uint8_t><<<nblocks, 256, 0, s>>>(*a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
