// Fused small-collective batch for ranks that share one card (the
// coll/hbm half of coll/fusion).
//
// K3 fused_batch replaces the reference package's fused hbm programs:
// coll/fusion.py _hbm_slot_outs (:335) and _build_fused_hbm (:359),
// and the cross-session combined dispatch _build_fused_hbm_multi
// (:371).  A flush of the nonblocking batch
// (iallreduce_arr / ibcast_arr) holds S small slots; the reference
// runs them all in one jitted dispatch.  Here the slots are grouped by
// (op, dtype), bcast slots joining the SUM group of their dtype as
// copy-from-root entries (coll/fusion.py:174 _group_plan), and ONE
// launch covers every slot of a group: a flush costs one launch per
// group, never one per slot.  A combined dispatch (coll/fusion.py
// _XBatcher: the batches of several resident sessions met within the
// cross-session window) puts every session's slots of one group into
// the same launch.  Each slot is a left fold in rank order
// over its N inputs (the templates of reduce_ops.cuh, the same as K1
// stacked_reduce), or for a bcast entry a copy of the root's input,
// written to every rank's output; a slot's bytes are the same whatever
// else rides its launch.
//
// Layout of a launch:
//   * the N input pointers of every slot travel in the parameter
//     block (slot s, rank r at in[s * nranks + r]);
//   * every rank's outputs are carved from ONE allocation: rank r's
//     output of slot s starts at out + r * out_stride + slot[s].out_off
//     (elements), so no output pointer travels;
//   * blocks map onto (slot, chunk) through the per-launch prefix
//     table slot[s].first_block: block b serves the slot with the
//     largest first_block <= b, chunk b - first_block, ELEMS elements.
//
// The table's size: a combined dispatch of 4 sessions x 32 slots x 8
// ranks needs 1024 input pointers and 128 slot records in one launch.
// They travel as a __grid_constant__ parameter block of 11 KiB, under
// Hopper's 32 KiB kernel-parameter limit (CUDA 12.1 and later; older
// toolkits hold 4 KiB, and this file refuses to build with them),
// rather than as a slot table in device memory written from a pinned
// stage by a copy ahead of each launch: the parameter block needs no
// stage, no copy and no event to keep the stage alive until the kernel
// has read it, and a launch is still one call.  The wrapper splits a
// solo batch that holds more into several launches; a combined
// dispatch past the limit raises (fused.py).
//
// What bounds it: bytes, as for K1 (N-1 operations per N elements
// read).  But a batch is small by construction (at most
// coll_device_fusion_max_ops slots of at most
// coll_device_fusion_threshold bytes), so at the main path's shape the
// launch itself and the wrapper's host work are a large share of the
// time.  The simple design reads every input once, writes every
// output once, one element a thread per step (slot pointers carry no
// alignment promise).
//
// Plain C interface, loaded with ctypes: the entry returns the
// cudaError_t of its launch (0 on success).

#include "reduce_ops.cuh"

#if !defined(CUDART_VERSION) || CUDART_VERSION < 12010
#error "fused.cu passes an 11 KiB parameter block: CUDA 12.1 or later"
#endif

#define FUSED_MAX_PTRS 1024
#define FUSED_MAX_SLOTS 128
#define FUSED_THREADS 256
#define FUSED_ELEMS 1024  // elements one block covers

struct FusedSlot {
  long long n;        // elements of this slot
  long long out_off;  // element offset of its output in each rank's row
  int first_block;    // prefix table: first block of this slot
  int root;           // >= 0: bcast entry (copy from that rank), else fold
};

struct FusedArgs {
  const void* in[FUSED_MAX_PTRS];
  FusedSlot slot[FUSED_MAX_SLOTS];
  void* out;
  long long out_stride;  // elements from rank r's row to rank r + 1's
  int nslots;
  int nranks;
};
static_assert(sizeof(FusedArgs) <= 32764, "over the kernel-parameter limit");

template <typename T, int OP>
__global__ void __launch_bounds__(FUSED_THREADS)
fused_batch_kernel(const __grid_constant__ FusedArgs a) {
  using Tr = Traits<T>;
  using A = typename Tr::A;
  const int b = (int)blockIdx.x;
  int lo = 0, hi = a.nslots - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (a.slot[mid].first_block <= b) lo = mid; else hi = mid - 1;
  }
  const long long n = a.slot[lo].n;
  const long long off = a.slot[lo].out_off;
  const int root = a.slot[lo].root;
  const long long begin = (long long)(b - a.slot[lo].first_block) * FUSED_ELEMS;
  const long long end = begin + FUSED_ELEMS < n ? begin + FUSED_ELEMS : n;
  const void* const* in = a.in + (long long)lo * a.nranks;
  T* out = reinterpret_cast<T*>(a.out) + off;
  for (long long i = begin + threadIdx.x; i < end; i += FUSED_THREADS) {
    T o;
    if (root >= 0) {
      o = reinterpret_cast<const T*>(in[root])[i];
    } else {
      A acc = first<OP>(Tr::load(reinterpret_cast<const T*>(in[0])[i]));
      for (int r = 1; r < a.nranks; ++r)
        acc = apply<OP>(acc, Tr::load(reinterpret_cast<const T*>(in[r])[i]));
      o = Tr::store(acc);
    }
    for (int r = 0; r < a.nranks; ++r) out[(long long)r * a.out_stride + i] = o;
  }
}

template <typename T, int OP>
struct LaunchFused {
  static int run(const FusedArgs* a, int nblocks, cudaStream_t s) {
    fused_batch_kernel<T, OP><<<nblocks, FUSED_THREADS, 0, s>>>(*a);
    return (int)cudaGetLastError();
  }
};

extern "C" {

int ompi_fused_args_size() { return (int)sizeof(FusedArgs); }
int ompi_fused_max_ptrs() { return FUSED_MAX_PTRS; }
int ompi_fused_max_slots() { return FUSED_MAX_SLOTS; }
int ompi_fused_elems() { return FUSED_ELEMS; }

// nblocks: the sum over slots of ceil(n / FUSED_ELEMS), which the
// wrapper also wrote into the prefix table.
int ompi_fused_batch(const FusedArgs* a, int dtype, int op, int nblocks,
                     void* stream) {
  if (a->nslots < 1 || a->nslots > FUSED_MAX_SLOTS || a->nranks < 1 ||
      (long long)a->nslots * a->nranks > FUSED_MAX_PTRS || nblocks < 1)
    return (int)cudaErrorInvalidValue;
  return dispatch_reduce<LaunchFused>(dtype, op, a, nblocks,
                                      (cudaStream_t)stream);
}

}  // extern "C"
