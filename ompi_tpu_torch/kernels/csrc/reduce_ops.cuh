// Op and dtype templates shared by the reduction kernels: K1
// stacked_reduce (stacked.cu), K3 fused_batch (fused.cu), K6 mesh_fold
// (mesh.cu) and K9 rma_acc (rma.cu).  They all include this one
// header, so they cannot drift apart.
//
// They replace the reference package's op tables: op/op.py:153
// jax_binary, coll/device.py:136 _fold_fn and coll/pipeline.py:147
// _binop.  Semantics the wrappers and their plain versions share:
//   * float16 and bfloat16 accumulate in float32 and round once;
//   * MAX and MIN propagate NaN (fmaxf/fminf would drop it);
//   * logical ops normalise to 0/1, LXOR is the parity of the nonzero
//     inputs; integer SUM and PROD wrap in the input type;
//   * bool is one byte holding 0 or 1 (torch.bool);
//   * complex SUM is a componentwise add and complex PROD is
//     (ac - bd, ad + bc), each product and sum rounded on its own (no
//     fused multiply-add), as the plain version computes it;
//   * REPLACE (the result is the first operand) and NO_OP (the second)
//     are the data-movement ops of MPI_Accumulate; only K9 takes them,
//     and it moves their bytes as they are, without Traits.
//
// dispatch_reduce<L>(dtype, op, args...) calls L<T, OP>::run(args...)
// for every (dtype, op) pair the kernels take and returns
// cudaErrorInvalidValue for any other pair; dispatch_reduce<L, true>
// takes REPLACE and NO_OP on every dtype as well.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

enum Dtype { F16 = 0, BF16 = 1, F32 = 2, F64 = 3, I8 = 4, U8 = 5,
             I32 = 6, I64 = 7, BOOL = 8, I16 = 9, U16 = 10, U32 = 11,
             U64 = 12, C64 = 13, C128 = 14 };
enum OpCode { SUM = 0, PROD = 1, MAX = 2, MIN = 3, LAND = 4, BAND = 5,
              LOR = 6, BOR = 7, LXOR = 8, BXOR = 9, REPLACE = 10,
              NO_OP = 11 };

struct bool8 {
  uint8_t v;
};

template <typename R>
struct alignas(2 * sizeof(R)) cplx {
  R re, im;
};

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

template <typename A>
struct is_cplx : std::false_type {};
template <typename R>
struct is_cplx<cplx<R>> : std::true_type {};

template <typename T>
struct Traits {  // integers: accumulate in the input type
  using A = T;
  static __device__ __forceinline__ A load(T x) { return x; }
  static __device__ __forceinline__ T store(A a) { return a; }
};
template <>
struct Traits<__half> {
  using A = float;
  static __device__ __forceinline__ A load(__half x) { return __half2float(x); }
  static __device__ __forceinline__ __half store(A a) { return __float2half_rn(a); }
};
template <>
struct Traits<__nv_bfloat16> {
  using A = float;
  static __device__ __forceinline__ A load(__nv_bfloat16 x) { return __bfloat162float(x); }
  static __device__ __forceinline__ __nv_bfloat16 store(A a) { return __float2bfloat16_rn(a); }
};
template <>
struct Traits<bool8> {
  using A = bool;
  static __device__ __forceinline__ A load(bool8 x) { return x.v != 0; }
  static __device__ __forceinline__ bool8 store(A a) { return bool8{(uint8_t)a}; }
};

// First operand of the fold: logical ops start from the 0/1 form so
// that every output is normalised whatever N is.
template <int OP, typename A>
__device__ __forceinline__ A first(A a) {
  if constexpr (OP == LAND || OP == LOR || OP == LXOR) {
    return (A)(a != (A)0);
  } else {
    return a;
  }
}

template <int OP, typename A>
__device__ __forceinline__ A apply(A a, A b) {
  if constexpr (is_cplx<A>::value) {
    if constexpr (OP == SUM) return A{add_rn(a.re, b.re), add_rn(a.im, b.im)};
    if constexpr (OP == PROD)
      return A{sub_rn(mul_rn(a.re, b.re), mul_rn(a.im, b.im)),
               add_rn(mul_rn(a.re, b.im), mul_rn(a.im, b.re))};
  } else if constexpr (std::is_same<A, bool>::value) {
    if constexpr (OP == SUM || OP == MAX || OP == LOR || OP == BOR) return a || b;
    if constexpr (OP == PROD || OP == MIN || OP == LAND || OP == BAND) return a && b;
    if constexpr (OP == LXOR || OP == BXOR) return a != b;
  } else if constexpr (std::is_integral<A>::value) {
    // wrap in unsigned arithmetic at least as wide as int, so that no
    // promoted operand overflows a signed int
    using U = typename std::make_unsigned<A>::type;
    using W = typename std::conditional<(sizeof(A) < sizeof(int)), unsigned, U>::type;
    if constexpr (OP == SUM) return (A)(U)((W)(U)a + (W)(U)b);
    if constexpr (OP == PROD) return (A)(U)((W)(U)a * (W)(U)b);
    if constexpr (OP == MAX) return a > b ? a : b;
    if constexpr (OP == MIN) return a < b ? a : b;
    if constexpr (OP == LAND) return (A)((a != 0) && (b != 0));
    if constexpr (OP == LOR) return (A)((a != 0) || (b != 0));
    if constexpr (OP == LXOR) return (A)((a != 0) != (b != 0));
    if constexpr (OP == BAND) return a & b;
    if constexpr (OP == BOR) return a | b;
    if constexpr (OP == BXOR) return a ^ b;
  } else {  // float, double
    if constexpr (OP == SUM) return a + b;
    if constexpr (OP == PROD) return a * b;
    if constexpr (OP == MAX) return (a > b || a != a) ? a : b;
    if constexpr (OP == MIN) return (a < b || a != a) ? a : b;
  }
  return a;  // unreachable: the host table admits valid pairs only
}

// --- host-side dispatch over the (dtype, op) table ----------------------

template <bool MOVE, template <typename, int> class L, typename T,
          typename... Args>
static int ops_move(int op, Args... args) {
  if constexpr (MOVE) {
    if (op == REPLACE) return L<T, REPLACE>::run(args...);
    if (op == NO_OP) return L<T, NO_OP>::run(args...);
  }
  return (int)cudaErrorInvalidValue;
}

template <bool MOVE, template <typename, int> class L, typename T,
          typename... Args>
static int ops_float(int op, Args... args) {
  switch (op) {
    case SUM: return L<T, SUM>::run(args...);
    case PROD: return L<T, PROD>::run(args...);
    case MAX: return L<T, MAX>::run(args...);
    case MIN: return L<T, MIN>::run(args...);
  }
  return ops_move<MOVE, L, T>(op, args...);
}

template <bool MOVE, template <typename, int> class L, typename T,
          typename... Args>
static int ops_complex(int op, Args... args) {
  switch (op) {
    case SUM: return L<T, SUM>::run(args...);
    case PROD: return L<T, PROD>::run(args...);
  }
  return ops_move<MOVE, L, T>(op, args...);
}

template <bool MOVE, template <typename, int> class L, typename T,
          typename... Args>
static int ops_all(int op, Args... args) {
  switch (op) {
    case SUM: return L<T, SUM>::run(args...);
    case PROD: return L<T, PROD>::run(args...);
    case MAX: return L<T, MAX>::run(args...);
    case MIN: return L<T, MIN>::run(args...);
    case LAND: return L<T, LAND>::run(args...);
    case BAND: return L<T, BAND>::run(args...);
    case LOR: return L<T, LOR>::run(args...);
    case BOR: return L<T, BOR>::run(args...);
    case LXOR: return L<T, LXOR>::run(args...);
    case BXOR: return L<T, BXOR>::run(args...);
  }
  return ops_move<MOVE, L, T>(op, args...);
}

template <template <typename, int> class L, bool MOVE = false,
          typename... Args>
static int dispatch_reduce(int dtype, int op, Args... args) {
  switch (dtype) {
    case F16: return ops_float<MOVE, L, __half>(op, args...);
    case BF16: return ops_float<MOVE, L, __nv_bfloat16>(op, args...);
    case F32: return ops_float<MOVE, L, float>(op, args...);
    case F64: return ops_float<MOVE, L, double>(op, args...);
    case I8: return ops_all<MOVE, L, int8_t>(op, args...);
    case U8: return ops_all<MOVE, L, uint8_t>(op, args...);
    case I32: return ops_all<MOVE, L, int32_t>(op, args...);
    case I64: return ops_all<MOVE, L, int64_t>(op, args...);
    case BOOL: return ops_all<MOVE, L, bool8>(op, args...);
    case I16: return ops_all<MOVE, L, int16_t>(op, args...);
    case U16: return ops_all<MOVE, L, uint16_t>(op, args...);
    case U32: return ops_all<MOVE, L, uint32_t>(op, args...);
    case U64: return ops_all<MOVE, L, uint64_t>(op, args...);
    case C64: return ops_complex<MOVE, L, cplx<float>>(op, args...);
    case C128: return ops_complex<MOVE, L, cplx<double>>(op, args...);
  }
  return (int)cudaErrorInvalidValue;
}

static inline int sm_count() {
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

static inline unsigned grid_for(long long work, long long cap) {
  long long blocks = (work + 255) / 256;
  if (blocks < 1) blocks = 1;
  if (blocks > cap) blocks = cap;
  return (unsigned)blocks;
}
