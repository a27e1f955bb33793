// On-device datatype packing: a gather and a scatter by an element
// index vector.
//
// K4 index_gather replaces the reference package's device_pack
// (ompi_tpu/datatype/device.py:67): a committed datatype's runs are
// compiled once into an int64 element-index vector, and packing is
// out[i] = src[idx[i]].  K5 index_scatter replaces its mirror,
// device_unpack (:86): out[idx[i]] = packed[i], written in place.
// Both move elements by their width only (1, 2, 4, 8 or 16 bytes), so
// one instantiation per width serves every dtype of that size.  The
// wrapper bounds-checks the index vector against the buffers before
// it launches; the kernels trust it.  Repeated indices in K5 leave
// which value lands unspecified, as in the reference.
//
// What bounds them: bytes.  A gather reads the index vector (8 bytes
// an element), writes the packed stream and reads the source where
// the indices point; for a strided type (config 5's vector with
// stride 2) the source reads touch the whole span of 32-byte sectors
// the stride covers.  The simple design is a grid-stride loop, one
// element a thread per step: consecutive threads read consecutive
// indices and write consecutive outputs, so the index and packed
// streams coalesce and the strided side is what the layout makes it.
//
// Plain C interface, loaded with ctypes: each entry returns the
// cudaError_t of its launch (0 on success).

#include <cuda_runtime.h>

#include <cstdint>

struct alignas(16) u128 {
  uint64_t lo, hi;
};

static inline int index_sm_count() {
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

template <typename W>
__global__ void __launch_bounds__(256)
index_gather_kernel(const W* __restrict__ src, const int64_t* __restrict__ idx,
                    W* __restrict__ out, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    out[i] = src[idx[i]];
}

template <typename W>
__global__ void __launch_bounds__(256)
index_scatter_kernel(const W* __restrict__ packed, const int64_t* __restrict__ idx,
                     W* __restrict__ out, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    out[idx[i]] = packed[i];
}

template <typename W>
static int launch(int scatter, const void* a, const int64_t* idx, void* out,
                  long long n, cudaStream_t s) {
  long long blocks = (n + 255) / 256;
  const long long cap = (long long)index_sm_count() * 16;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  if (scatter)
    index_scatter_kernel<W><<<(unsigned)blocks, 256, 0, s>>>(
        reinterpret_cast<const W*>(a), idx, reinterpret_cast<W*>(out), n);
  else
    index_gather_kernel<W><<<(unsigned)blocks, 256, 0, s>>>(
        reinterpret_cast<const W*>(a), idx, reinterpret_cast<W*>(out), n);
  return (int)cudaGetLastError();
}

static int by_width(int scatter, int width, const void* a, const int64_t* idx,
                    void* out, long long n, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (width) {
    case 1: return launch<uint8_t>(scatter, a, idx, out, n, s);
    case 2: return launch<uint16_t>(scatter, a, idx, out, n, s);
    case 4: return launch<uint32_t>(scatter, a, idx, out, n, s);
    case 8: return launch<uint64_t>(scatter, a, idx, out, n, s);
    case 16: return launch<u128>(scatter, a, idx, out, n, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" {

// out[i] = src[idx[i]] for i < n; width = bytes of one element.
int ompi_index_gather(const void* src, const int64_t* idx, void* out,
                      long long n, int width, void* stream) {
  return by_width(0, width, src, idx, out, n, stream);
}

// out[idx[i]] = packed[i] for i < n, in place on out.
int ompi_index_scatter(const void* packed, const int64_t* idx, void* out,
                       long long n, int width, void* stream) {
  return by_width(1, width, packed, idx, out, n, stream);
}

}  // extern "C"
