// Seam sweep for NVIDIA Hopper: the cumulative-cost DP and its backtrack
// (SPEC.md §5) in one launch, called from JAX through the XLA FFI.
//
// Contract: lqr_tpu/core/dp.py find_seam — seam [.., H] i32 and the final
// frontier M_last [.., Wb] f32, bit-identical to the lax.scan DP for
// finite or +inf inputs:
//
//   M[y, x] = e[y, x] + min_{|dx| <= delta_x} (M[y-1, x+dx] + rig[y, x] * rigc[|dx|])
//
// candidates ranked by side preference (dp.rank_tables), ties to the lower
// rank; no rig term for dx == 0; rows y >= h pass the frontier through.
// Arithmetic is __fadd_rn / __fmul_rn in the order of dp.py (c + rig*rigc,
// then e + best); the build also passes -fmad=false.
//
// Layout: one thread block per image, the grid over the batch (all leading
// dimensions of e). The frontier row lives in shared memory, double
// buffered between +inf guard cells (so candidates need no bounds test),
// with one __syncthreads() per row; each thread owns K strided columns and
// keeps the energy (and rigidity) of the next D rows in registers so the
// global loads overlap the row chain. The side preference and delta_x = 1
// are template parameters, so the candidate loop unrolls with constant
// offsets. Backpointers go to device memory as int8 (a scratch result).
// The backtrack runs in the same launch: the block loads a window of the
// next R rows around the current column (the seam moves at most delta_x
// per row) into shared memory, then one thread chases it.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <string>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kMaxDx = 10;
constexpr int kThreads = 512;   // at most, per block
constexpr int kMaxK = 32;       // columns per thread: Wb <= 16384
constexpr int kGuard = kMaxDx;  // +inf cells on each side of a frontier

// Candidate search for column x: dx = 0 first (rank 0, no rig term), then
// the pairs in rank order of the side preference; a later candidate wins
// only when strictly smaller, so ties keep the lower rank.
template <int DXT, bool PL, bool RIG>
__device__ __forceinline__ void relax(const float* __restrict__ prev, int x,
                                      float rg, const float* __restrict__ rc,
                                      int dx, float& best, int& bdx) {
  best = prev[x];
  bdx = 0;
#pragma unroll
  for (int m = 1; m <= (DXT >= 0 ? DXT : kMaxDx); ++m) {
    if (DXT < 0 && m > dx) break;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int s = (PL != (t == 1)) ? -m : m;
      float c = prev[x + s];
      if (RIG) c = __fadd_rn(c, __fmul_rn(rg, rc[m]));
      if (c < best) {
        best = c;
        bdx = s;
      }
    }
  }
}

template <bool PL>
__device__ __forceinline__ bool better(float v, int x, float bv, int bx) {
  return v < bv || (v == bv && (PL ? x < bx : x > bx));
}

template <bool PL>
__device__ __forceinline__ void argmin_merge(float& bv, int& bx) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, bv, off);
    const int ox = __shfl_down_sync(0xffffffffu, bx, off);
    if (ox >= 0 && (bx < 0 || better<PL>(ov, ox, bv, bx))) {
      bv = ov;
      bx = ox;
    }
  }
}

__host__ __device__ inline int chase_rows(int dx) {
  return dx <= 1 ? 64 : (dx <= 3 ? 32 : 16);
}

template <int K, int D, bool RIG, int DXT, bool PL>
__device__ __forceinline__ void sweep_image(
    const float* __restrict__ e, const float* __restrict__ rig,
    const float* __restrict__ rc, int H, int Wb, int dx, int hh,
    int8_t* __restrict__ bp, int32_t* __restrict__ seam,
    float* __restrict__ mlast, float* smem, float* s_rv, int* s_ri,
    int* s_x) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const float kInf = INFINITY;
  float* buf0 = smem + kGuard;
  float* buf1 = buf0 + Wb + 2 * kGuard;
  int8_t* win = reinterpret_cast<int8_t*>(smem + 2 * (Wb + 2 * kGuard));
  if (tid < kGuard) {
    buf0[-1 - tid] = kInf;
    buf0[Wb + tid] = kInf;
    buf1[-1 - tid] = kInf;
    buf1[Wb + tid] = kInf;
  }

  // ---- forward sweep -----------------------------------------------------
  float ereg[D][K];
  float rreg[D][K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int x = tid + j * nt;
    if (x < Wb) buf0[x] = e[x];
  }
  const float* epf = e + Wb;   // next row to prefetch
  const float* rpf = RIG ? rig + Wb : nullptr;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const bool ok = 1 + d < hh;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int x = tid + j * nt;
      ereg[d][j] = ok && x < Wb ? __ldg(epf + x) : 0.f;
      if (RIG) rreg[d][j] = ok && x < Wb ? __ldg(rpf + x) : 0.f;
    }
    epf += Wb;
    if (RIG) rpf += Wb;
  }
  __syncthreads();

  int8_t* bprow = bp + Wb;
  for (int y0 = 1; y0 < hh; y0 += D) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int y = y0 + d;
      if (y >= hh) break;  // uniform across the block
      // y0 = 1 + n*D, so with D even the buffer parity is static
      const bool odd = (D % 2 == 0) ? (d & 1) : ((y - 1) & 1);
      const float* prev = odd ? buf1 : buf0;
      float* cur = odd ? buf0 : buf1;
      const bool pf = y + D < hh;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int x = tid + j * nt;
        if (x < Wb) {
          float best;
          int bdx;
          relax<DXT, PL, RIG>(prev, x, RIG ? rreg[d][j] : 0.f, rc, dx, best,
                              bdx);
          cur[x] = __fadd_rn(ereg[d][j], best);
          bprow[x] = static_cast<int8_t>(bdx);
          ereg[d][j] = pf ? __ldg(epf + x) : 0.f;
          if (RIG) rreg[d][j] = pf ? __ldg(rpf + x) : 0.f;
        }
      }
      bprow += Wb;
      epf += Wb;
      if (RIG) rpf += Wb;
      __syncthreads();
    }
  }

  // ---- seam start: argmin of the last frontier, ties by side -----------
  const float* last = ((hh - 1) & 1) ? buf1 : buf0;
  float bv = kInf;
  int bx = -1;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int x = tid + j * nt;
    if (x < Wb) {
      const float v = last[x];
      mlast[x] = v;
      if (bx < 0 || better<PL>(v, x, bv, bx)) {
        bv = v;
        bx = x;
      }
    }
  }
  argmin_merge<PL>(bv, bx);
  const int warp = tid >> 5, lane = tid & 31, nwarps = (nt + 31) >> 5;
  if (lane == 0) {
    s_rv[warp] = bv;
    s_ri[warp] = bx;
  }
  __syncthreads();
  if (warp == 0) {
    bv = lane < nwarps ? s_rv[lane] : kInf;
    bx = lane < nwarps ? s_ri[lane] : -1;
    argmin_merge<PL>(bv, bx);
    if (lane == 0) *s_x = bx < 0 ? 0 : bx;
  }
  __syncthreads();

  // rows >= hh - 1 all sit at the start column (pass-through rows)
  const int x0 = *s_x;
  for (int y = hh - 1 + tid; y < H; y += nt) seam[y] = x0;

  // ---- backtrack: windowed chase -----------------------------------------
  const int R = chase_rows(dx);
  const int half = (R - 1) * dx;
  const int wwin = 2 * half + 1;
  for (int ytop = hh - 1; ytop >= 1; ytop -= R) {
    const int xt = *s_x;
    const int nrows = min(R, ytop);  // rows ytop .. ytop - nrows + 1
    const int wlo = xt - half;
    for (int i = tid; i < nrows * wwin; i += nt) {
      const int r = i / wwin;
      const int xx = wlo + (i - r * wwin);
      win[i] = (xx >= 0 && xx < Wb)
                   ? bp[static_cast<size_t>(ytop - r) * Wb + xx]
                   : static_cast<int8_t>(0);
    }
    __syncthreads();
    if (tid == 0) {
      int xc = xt;
      for (int r = 0; r < nrows; ++r) {
        const int off = min(max(xc - wlo, 0), wwin - 1);
        xc = min(max(xc + win[r * wwin + off], 0), Wb - 1);
        seam[ytop - r - 1] = xc;
      }
      *s_x = xc;
    }
    __syncthreads();
  }
}

template <int K, int D, bool RIG, int DXT>
__global__ void __launch_bounds__(kThreads)
    seam_sweep_kernel(const float* __restrict__ e,
                      const float* __restrict__ rig,
                      const int32_t* __restrict__ pref,
                      const int32_t* __restrict__ hvec,
                      const float* __restrict__ rigc, int H, int Wb, int dx,
                      int8_t* __restrict__ bp, int32_t* __restrict__ seam,
                      float* __restrict__ mlast) {
  extern __shared__ float smem[];
  __shared__ float s_rc[kMaxDx + 1];
  __shared__ float s_rv[32];
  __shared__ int s_ri[32];
  __shared__ int s_x;

  const int b = blockIdx.x;
  const size_t plane = static_cast<size_t>(H) * Wb;
  e += b * plane;
  if (RIG) rig += b * plane;
  bp += b * plane;
  seam += static_cast<size_t>(b) * H;
  mlast += static_cast<size_t>(b) * Wb;
  const int hh = min(max(hvec[b], 1), H);
  if (RIG && threadIdx.x <= dx) s_rc[threadIdx.x] = rigc[b * (dx + 1) + threadIdx.x];
  // (the first __syncthreads in sweep_image publishes s_rc)
  if (pref[b] != 0)
    sweep_image<K, D, RIG, DXT, true>(e, rig, s_rc, H, Wb, dx, hh, bp, seam,
                                      mlast, smem, s_rv, s_ri, &s_x);
  else
    sweep_image<K, D, RIG, DXT, false>(e, rig, s_rc, H, Wb, dx, hh, bp, seam,
                                       mlast, smem, s_rv, s_ri, &s_x);
}

size_t window_bytes(int dx) {
  const int R = chase_rows(dx);
  return static_cast<size_t>(R) * (2 * (R - 1) * dx + 1);
}

template <int K, bool RIG, int DXT>
cudaError_t launch(cudaStream_t stream, int B, int H, int Wb, int dx,
                   const float* e, const float* rig, const int32_t* pref,
                   const int32_t* h, const float* rigc, int8_t* bp,
                   int32_t* seam, float* mlast) {
  // about 16 prefetched values per thread: deeper where a row holds less
  // work to hide the loads behind
  constexpr int D = K >= 16 ? 1 : (16 / K > 8 ? 8 : 16 / K);
  auto kernel = seam_sweep_kernel<K, D, RIG, DXT>;
  const int nt = ((Wb + K - 1) / K + 31) / 32 * 32;
  const size_t smem =
      2 * sizeof(float) * (Wb + 2 * kGuard) + window_bytes(dx);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<B, nt, smem, stream>>>(e, rig, pref, h, rigc, H, Wb, dx, bp, seam,
                                  mlast);
  return cudaGetLastError();
}

template <bool RIG, int DXT>
cudaError_t dispatch_k(cudaStream_t stream, int B, int H, int Wb, int dx,
                       const float* e, const float* rig, const int32_t* pref,
                       const int32_t* h, const float* rigc, int8_t* bp,
                       int32_t* seam, float* mlast) {
#define LQR_SWEEP_CASE(KK)                                                   \
  if (Wb <= KK * kThreads)                                                   \
    return launch<KK, RIG, DXT>(stream, B, H, Wb, dx, e, rig, pref, h, rigc, \
                                bp, seam, mlast);
  LQR_SWEEP_CASE(1)
  LQR_SWEEP_CASE(2)
  LQR_SWEEP_CASE(4)
  LQR_SWEEP_CASE(8)
  LQR_SWEEP_CASE(16)
  LQR_SWEEP_CASE(32)
#undef LQR_SWEEP_CASE
  return cudaErrorInvalidValue;
}

template <bool RIG>
cudaError_t dispatch(cudaStream_t stream, int B, int H, int Wb, int dx,
                     const float* e, const float* rig, const int32_t* pref,
                     const int32_t* h, const float* rigc, int8_t* bp,
                     int32_t* seam, float* mlast) {
  // delta_x = 1 (the default) gets constant candidate offsets
  return dx == 1 ? dispatch_k<RIG, 1>(stream, B, H, Wb, dx, e, rig, pref, h,
                                      rigc, bp, seam, mlast)
                 : dispatch_k<RIG, -1>(stream, B, H, Wb, dx, e, rig, pref, h,
                                       rigc, bp, seam, mlast);
}

ffi::Error SeamSweepImpl(cudaStream_t stream, ffi::Buffer<ffi::F32> e,
                         ffi::Buffer<ffi::F32> rig,
                         ffi::Buffer<ffi::S32> pref, ffi::Buffer<ffi::S32> h,
                         ffi::Buffer<ffi::F32> rigc,
                         ffi::ResultBuffer<ffi::S32> seam,
                         ffi::ResultBuffer<ffi::F32> mlast,
                         ffi::ResultBuffer<ffi::S8> bp, int32_t delta_x,
                         int32_t has_rig) {
  const auto dims = e.dimensions();
  if (dims.size() < 2)
    return ffi::Error::InvalidArgument("seam sweep: e must be [..., H, Wb]");
  const int64_t H = dims[dims.size() - 2];
  const int64_t Wb = dims[dims.size() - 1];
  if (H < 1 || Wb < 1 || Wb > kMaxK * kThreads)
    return ffi::Error::InvalidArgument("seam sweep: unsupported H or Wb");
  if (delta_x < 0 || delta_x > kMaxDx)
    return ffi::Error::InvalidArgument("seam sweep: delta_x out of 0..10");
  const int64_t B = static_cast<int64_t>(e.element_count()) / (H * Wb);
  auto count = [](const auto& buf) {
    return static_cast<int64_t>(buf.element_count());
  };
  if (count(pref) != B || count(h) != B || count(rigc) != B * (delta_x + 1) ||
      (has_rig && count(rig) != B * H * Wb))
    return ffi::Error::InvalidArgument("seam sweep: operand sizes disagree");
  if (B == 0) return ffi::Error::Success();
  const int dx = static_cast<int>(delta_x);
  cudaError_t err =
      has_rig
          ? dispatch<true>(stream, B, H, Wb, dx, e.typed_data(),
                           rig.typed_data(), pref.typed_data(),
                           h.typed_data(), rigc.typed_data(),
                           bp->typed_data(), seam->typed_data(),
                           mlast->typed_data())
          : dispatch<false>(stream, B, H, Wb, dx, e.typed_data(), nullptr,
                            pref.typed_data(), h.typed_data(),
                            rigc.typed_data(), bp->typed_data(),
                            seam->typed_data(), mlast->typed_data());
  if (err != cudaSuccess)
    return ffi::Error::Internal(std::string("seam sweep launch: ") +
                                cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(LqrSeamSweep, SeamSweepImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()  // e
                                  .Arg<ffi::Buffer<ffi::F32>>()  // rig
                                  .Arg<ffi::Buffer<ffi::S32>>()  // pref
                                  .Arg<ffi::Buffer<ffi::S32>>()  // h
                                  .Arg<ffi::Buffer<ffi::F32>>()  // rigc
                                  .Ret<ffi::Buffer<ffi::S32>>()  // seam
                                  .Ret<ffi::Buffer<ffi::F32>>()  // M_last
                                  .Ret<ffi::Buffer<ffi::S8>>()   // bp
                                  .Attr<int32_t>("delta_x")
                                  .Attr<int32_t>("has_rig"));
