// ILANS2 shared-stream rANS encode and decode for NVIDIA Hopper (sm_90a),
// called from JAX through XLA's foreign function interface.
//
// Format: ops/interleaved2.py.  All L lanes of a container block share one
// word stream in decode-consumption order, so every step couples the lanes
// through one exclusive prefix sum over the refill (decode) or emission
// (encode) mask.  The kernels keep that coupling on chip:
//
// - one container block is coded by one thread-block CLUSTER of `nclust`
//   CTAs (1..8); each thread owns LPT consecutive lanes and keeps their
//   states in registers for all T steps;
// - the per-step prefix sum is a warp shuffle scan, a scan of the warp
//   totals, and (for nclust > 1) an exchange of CTA totals through
//   distributed shared memory behind one cluster barrier;
// - because ranks are monotone in the lane index, the refill words of a
//   thread are one contiguous run of the stream at `base + rank`;
// - decode inverts quantiles through a bucket table in shared memory
//   (exact at P <= 12; a short binary search over the CDF above that);
// - several container blocks (the sharded container) are several clusters.
//
// Bit-exact with the host oracle (interleaved2.encode_shared /
// decode_shared_cdf); the arithmetic is integer throughout.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <string>

#include "xla/ffi/api/ffi.h"

namespace cg = cooperative_groups;
namespace ffi = xla::ffi;

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kLanesPerCta = 4096;   // cluster size grows beyond this
constexpr int kMaxCluster = 8;       // portable cluster size
constexpr int kCdfSmemMax = 16384;   // CDF entries kept in shared memory
constexpr int kHeaderWords = 72;     // warp sums [2][32], CTA totals [2]

struct Geometry {
  int nclust, threads, lpt;
};

// Lanes -> (cluster rank, thread, slot): lane = rank*threads*lpt + tid*lpt + j.
Geometry pick_geometry(int64_t L) {
  Geometry g{1, 32, 1};
  while (g.nclust < kMaxCluster && (int64_t)g.nclust * kLanesPerCta < L)
    g.nclust *= 2;
  int64_t per_cta = (L + g.nclust - 1) / g.nclust;
  int64_t thr = ((per_cta + 31) / 32) * 32;
  g.threads = (int)(thr < kMaxThreads ? thr : kMaxThreads);
  int64_t lpt = (per_cta + g.threads - 1) / g.threads;
  while (g.lpt < lpt) g.lpt *= 2;
  return g;
}

struct Scan {
  uint32_t excl;   // lanes before this thread's first lane, block-wide
  uint32_t total;  // whole container block
};

// Exclusive prefix of `c` over the threads of the cluster in lane order.
// Double-buffered by step parity so one barrier per step suffices.
__device__ __forceinline__ Scan cluster_scan(uint32_t c, uint32_t* hdr,
                                             int par, int nclust) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  uint32_t incl = c;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    uint32_t v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  uint32_t* ws = hdr + par * 32;
  if (lane == 31) ws[warp] = incl;
  __syncthreads();
  uint32_t wv = lane < nwarps ? ws[lane] : 0u;
  uint32_t wincl = wv;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    uint32_t v = __shfl_up_sync(0xffffffffu, wincl, d);
    if (lane >= d) wincl += v;
  }
  const uint32_t warp_excl = __shfl_sync(0xffffffffu, wincl - wv, warp);
  const uint32_t cta_total = __shfl_sync(0xffffffffu, wincl, 31);
  Scan r{warp_excl + incl - c, cta_total};
  if (nclust > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    uint32_t* tot = hdr + 64 + par;
    if (threadIdx.x == 0) *tot = cta_total;
    cluster.sync();
    const unsigned rank = cluster.block_rank();
    uint32_t v = lane < nclust ? *cluster.map_shared_rank(tot, lane) : 0u;
    uint32_t before = lane < (int)rank ? v : 0u;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      v += __shfl_xor_sync(0xffffffffu, v, d);
      before += __shfl_xor_sync(0xffffffffu, before, d);
    }
    r.excl += before;
    r.total = v;
  }
  return r;
}

__device__ __forceinline__ uint32_t invert(uint32_t q, const uint32_t* tbl,
                                           const uint32_t* cdf, int shift,
                                           uint32_t kmax) {
  const uint32_t b = q >> shift;
  uint32_t lo = tbl[b];
  if (shift == 0) return lo;
  uint32_t hi = min(tbl[b + 1], kmax);
  while (lo < hi) {
    const uint32_t mid = (lo + hi + 1) >> 1;
    if (cdf[mid] <= q) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// Shared setup: header words, bucket table (decode), CDF copy.
__device__ __forceinline__ const uint32_t* load_cdf(uint32_t* dst,
                                                    const uint32_t* cdf_g,
                                                    int K) {
  if (K + 1 > kCdfSmemMax) return cdf_g;
  for (int i = threadIdx.x; i <= K; i += blockDim.x) dst[i] = cdf_g[i];
  return dst;
}

// q = s / p and s - q * p.  For u64 states with quotients below 2^48 (the
// encoder's state after renormalization is below p * 2^(S - P), so this
// holds for P >= 16 at S = 64) a double-precision estimate is within one of
// the quotient and one integer correction makes it exact; the u64 divide
// is a long software routine.
__device__ __forceinline__ uint32_t divmod(uint32_t s, uint32_t p,
                                           uint32_t& r, bool) {
  const uint32_t q = s / p;
  r = s - q * p;
  return q;
}

__device__ __forceinline__ uint64_t divmod(uint64_t s, uint32_t p,
                                           uint64_t& r, bool small_quotient) {
  if (!small_quotient) {
    const uint64_t q = s / p;
    r = s - q * p;
    return q;
  }
  uint64_t q = (uint64_t)__dmul_rz((double)s, __drcp_rn((double)p));
  int64_t rem = (int64_t)(s - q * p);
  if (rem < 0) {
    --q;
    rem += p;
  } else if (rem >= (int64_t)p) {
    ++q;
    rem -= p;
  }
  r = (uint64_t)rem;
  return q;
}

__device__ __forceinline__ void start_barrier(int nclust) {
  if (nclust > 1) cg::this_cluster().sync(); else __syncthreads();
}

template <typename St, int LPT>
__global__ void __launch_bounds__(kMaxThreads, 1)
decode_kernel(const St* __restrict__ states_in,
              const uint32_t* __restrict__ streams,
              const int32_t* __restrict__ lens,
              const uint32_t* __restrict__ cdf_g,
              const uint32_t* __restrict__ tbl_g,
              const int32_t* __restrict__ nsym,
              int32_t* __restrict__ syms_out, St* __restrict__ states_out,
              int L, int T, int cap, int K, int W, int S, int P, int lb,
              int nclust) {
  extern __shared__ uint32_t smem[];
  uint32_t* hdr = smem;
  uint32_t* tbl = smem + kHeaderWords;
  const int ntbl = (1 << lb) + 1;
  for (int i = threadIdx.x; i < ntbl; i += blockDim.x) tbl[i] = tbl_g[i];
  const uint32_t* cdf = load_cdf(tbl + ntbl, cdf_g, K);
  const int rank = blockIdx.x % nclust, b = blockIdx.x / nclust;
  const int lane0 = (rank * blockDim.x + threadIdx.x) * LPT;
  const St lower = St(1) << (S - W);
  const St qmask = (St(1) << P) - 1;
  const int shift = P - lb;
  const uint32_t kmax = (uint32_t)(K - 1);
  const int tail = nsym[0] - (T - 1) * L;
  const uint32_t* stream = streams + (size_t)b * cap;
  const uint32_t slen = (uint32_t)min(lens[b], cap);
  int32_t* out = syms_out + (size_t)b * T * L;
  St st[LPT];
#pragma unroll
  for (int j = 0; j < LPT; ++j)
    st[j] = lane0 + j < L ? states_in[(size_t)b * L + lane0 + j] : lower;
  start_barrier(nclust);

  uint32_t base = 0;
  for (int t = 0; t < T; ++t) {
    const int active = t == T - 1 ? tail : L;
    uint32_t mbits = 0, c = 0;
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      const int lane = lane0 + j;
      const St s = st[j];
      const uint32_t q = (uint32_t)(s & qmask);
      const uint32_t sym = invert(q, tbl, cdf, shift, kmax);
      if (lane < active) {
        const uint32_t cum = cdf[sym], prob = cdf[sym + 1] - cum;
        st[j] = (s >> P) * prob + (q - cum);
        out[(size_t)t * L + lane] = (int32_t)sym;
      }
      const bool m = st[j] < lower;
      mbits |= (uint32_t)m << j;
      c += m;
    }
    const Scan r = cluster_scan(c, hdr, t & 1, nclust);
    uint32_t off = base + r.excl;
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      if ((mbits >> j) & 1u) {
        const uint32_t w = off < slen ? stream[off] : 0u;
        st[j] = (st[j] << W) | (St)w;
        ++off;
      }
    }
    base += r.total;
  }
#pragma unroll
  for (int j = 0; j < LPT; ++j)
    if (lane0 + j < L) states_out[(size_t)b * L + lane0 + j] = st[j];
  if (nclust > 1) cg::this_cluster().sync();
}

template <typename St, int LPT>
__global__ void __launch_bounds__(kMaxThreads, 1)
encode_kernel(const int32_t* __restrict__ syms_in,
              const St* __restrict__ seeds,
              const uint32_t* __restrict__ cdf_g,
              const int32_t* __restrict__ nsym,
              uint32_t* __restrict__ buf_out, St* __restrict__ states_out,
              int32_t* __restrict__ lens_out, int L, int T, int cap, int K,
              int W, int S, int P, int nclust) {
  extern __shared__ uint32_t smem[];
  uint32_t* hdr = smem;
  const uint32_t* cdf = load_cdf(smem + kHeaderWords, cdf_g, K);
  const int rank = blockIdx.x % nclust, b = blockIdx.x / nclust;
  const int lane0 = (rank * blockDim.x + threadIdx.x) * LPT;
  const St lower = St(1) << (S - W);
  const St wmask = (St(1) << W) - 1;
  const int tail = nsym[0] - (T - 1) * L;
  const bool small_quotient = S - P <= 48;
  const int32_t* in = syms_in + (size_t)b * T * L;
  uint32_t* buf = buf_out + (size_t)b * cap;
  St st[LPT];
#pragma unroll
  for (int j = 0; j < LPT; ++j)
    st[j] = lane0 + j < L ? seeds[(size_t)b * L + lane0 + j] : lower;
  start_barrier(nclust);

  uint32_t end = (uint32_t)cap;
  for (int t = T - 1; t >= 0; --t) {
    const int active = t == T - 1 ? tail : L;
    uint32_t cum[LPT], prob[LPT];
    uint32_t mbits = 0, c = 0;
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      const int lane = lane0 + j;
      cum[j] = 0;
      prob[j] = 0;
      if (lane < active) {
        const int s = in[(size_t)t * L + lane];
        cum[j] = cdf[s];
        prob[j] = cdf[s + 1] - cum[j];
        const bool m = (st[j] >> (S - P)) >= (St)prob[j];
        mbits |= (uint32_t)m << j;
        c += m;
      }
    }
    const Scan r = cluster_scan(c, hdr, t & 1, nclust);
    uint32_t off = end - r.total + r.excl;
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      St s = st[j];
      if ((mbits >> j) & 1u) {
        buf[off++] = (uint32_t)(s & wmask);
        s >>= W;
      }
      if (prob[j]) {
        St rem;
        const St q = divmod(s, prob[j], rem, small_quotient);
        s = (q << P) | ((St)cum[j] + rem);
      }
      st[j] = s;
    }
    end -= r.total;
  }
#pragma unroll
  for (int j = 0; j < LPT; ++j)
    if (lane0 + j < L) states_out[(size_t)b * L + lane0 + j] = st[j];
  if (rank == 0 && threadIdx.x == 0) lens_out[b] = cap - (int)end;
  if (nclust > 1) cg::this_cluster().sync();
}

template <typename Kernel, typename... Args>
ffi::Error launch(Kernel kernel, int blocks, const Geometry& g,
                  size_t smem_bytes, cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (err != cudaSuccess)
    return ffi::Error::Internal(std::string("smem attribute: ") +
                                cudaGetErrorString(err));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks * g.nclust);
  cfg.blockDim = dim3(g.threads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = g.nclust;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = g.nclust > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess)
    return ffi::Error::Internal(std::string("launch: ") +
                                cudaGetErrorString(err));
  return ffi::Error::Success();
}

int smem_cdf_words(int64_t K) { return K + 1 <= kCdfSmemMax ? (int)K + 1 : 0; }

template <typename St, ffi::DataType DT>
ffi::Error decode_impl(cudaStream_t stream, ffi::Buffer<DT> states,
                       ffi::Buffer<ffi::U32> streams,
                       ffi::Buffer<ffi::S32> lens, ffi::Buffer<ffi::U32> cdf,
                       ffi::Buffer<ffi::U32> tbl, ffi::Buffer<ffi::S32> nsym,
                       ffi::ResultBuffer<ffi::S32> syms,
                       ffi::ResultBuffer<DT> fin, int64_t word_bits,
                       int64_t precision, int64_t table_bits) {
  const int64_t B = states.dimensions()[0], L = states.dimensions()[1];
  const int64_t cap = streams.dimensions()[1];
  const int64_t T = syms->dimensions()[1] / L;
  const int64_t K = cdf.element_count() - 1;
  if (T == 0 || B == 0) return ffi::Error::Success();
  const Geometry g = pick_geometry(L);
  const size_t smem = sizeof(uint32_t) *
      (kHeaderWords + (1 << table_bits) + 1 + smem_cdf_words(K));
  const int S = (int)(8 * sizeof(St));
#define CTPU_DECODE(LPT)                                                     \
  case LPT:                                                                  \
    return launch(decode_kernel<St, LPT>, (int)B, g, smem, stream,          \
                  states.typed_data(), streams.typed_data(),                 \
                  lens.typed_data(), cdf.typed_data(), tbl.typed_data(),     \
                  nsym.typed_data(), syms->typed_data(), fin->typed_data(),  \
                  (int)L, (int)T, (int)cap, (int)K, (int)word_bits, S,       \
                  (int)precision, (int)table_bits, g.nclust);
  switch (g.lpt) {
    CTPU_DECODE(1) CTPU_DECODE(2) CTPU_DECODE(4) CTPU_DECODE(8)
    CTPU_DECODE(16)
  }
#undef CTPU_DECODE
  return ffi::Error::InvalidArgument("too many lanes for the decode kernel");
}

template <typename St, ffi::DataType DT>
ffi::Error encode_impl(cudaStream_t stream, ffi::Buffer<ffi::S32> syms,
                       ffi::Buffer<DT> seeds, ffi::Buffer<ffi::U32> cdf,
                       ffi::Buffer<ffi::S32> nsym,
                       ffi::ResultBuffer<ffi::U32> buf,
                       ffi::ResultBuffer<DT> states,
                       ffi::ResultBuffer<ffi::S32> lens, int64_t word_bits,
                       int64_t precision) {
  const int64_t B = seeds.dimensions()[0], L = seeds.dimensions()[1];
  const int64_t T = syms.dimensions()[1] / L;
  const int64_t cap = buf->dimensions()[1];
  const int64_t K = cdf.element_count() - 1;
  if (T == 0 || B == 0) return ffi::Error::Success();
  const Geometry g = pick_geometry(L);
  const size_t smem = sizeof(uint32_t) * (kHeaderWords + smem_cdf_words(K));
  const int S = (int)(8 * sizeof(St));
#define CTPU_ENCODE(LPT)                                                     \
  case LPT:                                                                  \
    return launch(encode_kernel<St, LPT>, (int)B, g, smem, stream,          \
                  syms.typed_data(), seeds.typed_data(), cdf.typed_data(),   \
                  nsym.typed_data(), buf->typed_data(),                      \
                  states->typed_data(), lens->typed_data(), (int)L, (int)T,  \
                  (int)cap, (int)K, (int)word_bits, S, (int)precision,       \
                  g.nclust);
  switch (g.lpt) {
    CTPU_ENCODE(1) CTPU_ENCODE(2) CTPU_ENCODE(4) CTPU_ENCODE(8)
    CTPU_ENCODE(16)
  }
#undef CTPU_ENCODE
  return ffi::Error::InvalidArgument("too many lanes for the encode kernel");
}

}  // namespace

#define CTPU_DECODE_BINDING(DT)                                              \
  ffi::Ffi::Bind()                                                           \
      .Ctx<ffi::PlatformStream<cudaStream_t>>()                              \
      .Arg<ffi::Buffer<DT>>()                                                \
      .Arg<ffi::Buffer<ffi::U32>>()                                          \
      .Arg<ffi::Buffer<ffi::S32>>()                                          \
      .Arg<ffi::Buffer<ffi::U32>>()                                          \
      .Arg<ffi::Buffer<ffi::U32>>()                                          \
      .Arg<ffi::Buffer<ffi::S32>>()                                          \
      .Ret<ffi::Buffer<ffi::S32>>()                                          \
      .Ret<ffi::Buffer<DT>>()                                                \
      .Attr<int64_t>("word_bits")                                            \
      .Attr<int64_t>("precision")                                            \
      .Attr<int64_t>("table_bits")

#define CTPU_ENCODE_BINDING(DT)                                              \
  ffi::Ffi::Bind()                                                           \
      .Ctx<ffi::PlatformStream<cudaStream_t>>()                              \
      .Arg<ffi::Buffer<ffi::S32>>()                                          \
      .Arg<ffi::Buffer<DT>>()                                                \
      .Arg<ffi::Buffer<ffi::U32>>()                                          \
      .Arg<ffi::Buffer<ffi::S32>>()                                          \
      .Ret<ffi::Buffer<ffi::U32>>()                                          \
      .Ret<ffi::Buffer<DT>>()                                                \
      .Ret<ffi::Buffer<ffi::S32>>()                                          \
      .Attr<int64_t>("word_bits")                                            \
      .Attr<int64_t>("precision")

XLA_FFI_DEFINE_HANDLER_SYMBOL(CtpuIlans2Decode32,
                              (decode_impl<uint32_t, ffi::U32>),
                              CTPU_DECODE_BINDING(ffi::U32));
XLA_FFI_DEFINE_HANDLER_SYMBOL(CtpuIlans2Decode64,
                              (decode_impl<uint64_t, ffi::U64>),
                              CTPU_DECODE_BINDING(ffi::U64));
XLA_FFI_DEFINE_HANDLER_SYMBOL(CtpuIlans2Encode32,
                              (encode_impl<uint32_t, ffi::U32>),
                              CTPU_ENCODE_BINDING(ffi::U32));
XLA_FFI_DEFINE_HANDLER_SYMBOL(CtpuIlans2Encode64,
                              (encode_impl<uint64_t, ffi::U64>),
                              CTPU_ENCODE_BINDING(ffi::U64));
