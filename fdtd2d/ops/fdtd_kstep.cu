// K-step temporally blocked 2D TE FDTD sweep for Hopper, called from JAX
// through the XLA FFI (fdtd2d/ops/kstep.py builds and registers it).
//
// Layout (the "padded" convention of fdtd2d/fdtd/step.py): ez, hx, hy, ce,
// ch are all (R, C) float32, row-major. ch is zero outside the staggered
// (N-1, M-1) domain, ce is zero on the domain's outer ring, so one formula
// updates every cell and the zeros encode validity.
//
// Each block owns a TY x TX tile of rows [row0, row1) and loads it with a
// halo of `halo` cells on every side (cells outside the array load as zero)
// into shared memory: kHext x kWext with TY = kHext - 2*halo, TX = kWext - 2*halo.
// It then runs `nsteps <= halo` leapfrog steps there. One step has a
// dependency radius of one cell, so after s steps every cell at least s
// cells inside the loaded region is exact; after nsteps <= halo steps the
// whole tile is, and only the tile is written back. Device memory sees one
// read of five fields and one write of three per `nsteps` steps instead of
// per step.
//
// Within a step the update order is the reference's (fdtd/step.py): H
// update, interior Ez update, Mur bands left/right (every row), then
// top/bottom (where the block holds the true domain edge, flags in
// iparams), corner averaging, point source. Band cells whose inputs fall
// outside the loaded region are skipped: they sit on its edge and are
// invalid anyway.
//
// fparams (device, f32[3]): coef (Mur), dt, fc.
// iparams (device, s32[5]): first global step, source row, source column
// (array coordinates, may lie outside), is_top, is_bot. They are device
// buffers so that one SPMD program can pass per-device values.

#include <cstdint>
#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kBand = 5;        // Mur band width
constexpr int kWext = 128;      // loaded tile width (threads along x)
constexpr int kHext = 96;       // loaded tile height
constexpr int kThreadsY = 4;    // thread rows; each owns kHext/4 consecutive rows

__device__ __forceinline__ float source_amp(int kind, float t, float fc) {
  if (kind == 0) {  // Ricker, as core/sources.ricker_amplitude
    float tau = (3.14159265358979f * fc) * (t - 1.0f / fc);
    return (1.0f - 2.0f * (tau * tau)) * expf(-(tau * tau));
  }
  float a = t - 3000.0f / fc;
  float w = 2.0f / fc;
  float env = 1.0f - expf(-(a * a) / (2.0f * (w * w)));
  return env * sinf((2.0f * 3.14159265358979f) * fc * t);
}

__global__ void __launch_bounds__(kWext * kThreadsY, 1)
kstep_kernel(const float* __restrict__ ez_in, const float* __restrict__ hx_in,
             const float* __restrict__ hy_in, const float* __restrict__ ce_g,
             const float* __restrict__ ch_g, const float* __restrict__ fparams,
             const int32_t* __restrict__ iparams, float* __restrict__ ez_out,
             float* __restrict__ hx_out, float* __restrict__ hy_out, int R,
             int C, int halo, int nsteps, int row0, int row1, int kind) {
  constexpr int W = kWext;
  constexpr int RPT = kHext / kThreadsY;
  extern __shared__ float smem[];
  float* ez = smem;                 // P: field before the step
  float* en = smem + kHext * W;      // E, E2, E3, E4 of the step
  float* hx = smem + 2 * kHext * W;
  float* hy = smem + 3 * kHext * W;

  const int TX = W - 2 * halo;
  const int TY = kHext - 2 * halo;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * W + tx;
  const int r_ext0 = row0 + blockIdx.y * TY - halo;  // array row of local row 0
  const int c_ext0 = blockIdx.x * TX - halo;         // array col of local col 0
  const int lr0 = ty * RPT;

  float ce_r[RPT], ch_r[RPT];
  {
    const int gc = c_ext0 + tx;
    const bool col_in = gc >= 0 && gc < C;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int lr = lr0 + i;
      const int gr = r_ext0 + lr;
      const bool in = col_in && gr >= 0 && gr < R;
      const size_t g = static_cast<size_t>(in ? gr : 0) * C + (in ? gc : 0);
      ez[lr * W + tx] = in ? ez_in[g] : 0.0f;
      hx[lr * W + tx] = in ? hx_in[g] : 0.0f;
      hy[lr * W + tx] = in ? hy_in[g] : 0.0f;
      ce_r[i] = in ? ce_g[g] : 0.0f;
      ch_r[i] = in ? ch_g[g] : 0.0f;
    }
  }

  const float coef = fparams[0];
  const float dt = fparams[1];
  const float fc = fparams[2];
  const int t0 = iparams[0];
  const int lsr = iparams[1] - r_ext0;
  const int lsc = iparams[2] - c_ext0;
  const bool is_top = iparams[3] != 0;
  const bool is_bot = iparams[4] != 0;
  const bool has_src = lsr >= 0 && lsr < kHext && lsc >= 0 && lsc < W;

  // Domain edges in local coordinates. Block-uniform, so the __syncthreads
  // inside the band branches below are reached by every thread or none.
  const int ltop = row0 - r_ext0;        // domain row 0
  const int lbot = row1 - 1 - r_ext0;    // domain row N-1
  const int lleft = -c_ext0;             // column 0
  const int lright = C - 1 - c_ext0;     // column M-1
  const bool lr_band = (lleft + kBand >= 0 && lleft < W) ||
                       (lright >= 0 && lright - kBand < W);
  const bool top_band = is_top && ltop + kBand >= 0 && ltop < kHext;
  const bool bot_band = is_bot && lbot >= 0 && lbot - kBand < kHext;
  // local column range of the top/bottom bands: domain columns 1..M-2
  const int tb_c_lo = max(lleft + 1, 0);
  const int tb_c_hi = min(lright - 1, W - 1);

  __syncthreads();

  for (int s = 0; s < nsteps; ++s) {
    // -- H update ------------------------------------------------------
    {
      float e_next = ez[lr0 * W + tx];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int lr = lr0 + i;
        const float e = e_next;
        if (lr + 1 < kHext) {
          e_next = ez[(lr + 1) * W + tx];
          hx[lr * W + tx] -= ch_r[i] * (e_next - e);
        }
        if (tx + 1 < W) hy[lr * W + tx] += ch_r[i] * (ez[lr * W + tx + 1] - e);
      }
    }
    __syncthreads();

    // -- interior Ez update (ce is zero on the domain ring) --------------
    {
      float hx_up = lr0 >= 1 ? hx[(lr0 - 1) * W + tx] : 0.0f;
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int lr = lr0 + i;
        const int k = lr * W + tx;
        const float p = ez[k];
        const float hxc = hx[k];
        float v = p;
        if (lr >= 1 && tx >= 1)
          v = p + ce_r[i] * ((hy[k] - hy[k - 1]) - (hxc - hx_up));
        en[k] = v;
        hx_up = hxc;
      }
    }
    __syncthreads();

    // -- Mur bands left/right: one thread per loaded row and side ---------
    if (lr_band) {
      if (tid < 2 * kHext) {
        const int lr = tid % kHext;
        const float* P = ez + lr * W;
        float* E = en + lr * W;
        float v[kBand];
        if (tid < kHext) {  // left: E2[r, j] = P[r, j+1] + coef (E[r, j+1] - P[r, j])
#pragma unroll
          for (int j = 0; j < kBand; ++j) {
            const int c = lleft + j;
            v[j] = (c >= 0 && c + 1 < W) ? P[c + 1] + coef * (E[c + 1] - P[c]) : 0.0f;
          }
#pragma unroll
          for (int j = 0; j < kBand; ++j) {
            const int c = lleft + j;
            if (c >= 0 && c + 1 < W) E[c] = v[j];
          }
        } else {  // right: E2[r, c] = P[r, c-1] + coef (E[r, c-1] - P[r, c])
#pragma unroll
          for (int j = 0; j < kBand; ++j) {
            const int c = lright - kBand + 1 + j;
            v[j] = (c >= 1 && c < W) ? P[c - 1] + coef * (E[c - 1] - P[c]) : 0.0f;
          }
#pragma unroll
          for (int j = 0; j < kBand; ++j) {
            const int c = lright - kBand + 1 + j;
            if (c >= 1 && c < W) E[c] = v[j];
          }
        }
      }
      __syncthreads();
    }

    // -- Mur bands top/bottom: one thread per loaded column and side -------
    if (top_band || bot_band) {
      if (tid < 2 * W) {
        const int c = tid % W;
        const bool top = tid < W;
        if (c >= tb_c_lo && c <= tb_c_hi && (top ? top_band : bot_band)) {
          float v[kBand];
#pragma unroll
          for (int i = 0; i < kBand; ++i) {
            if (top) {  // E3[i, c] = P[i+1, c] + coef (E2[i+1, c] - P[i, c])
              const int r = ltop + i;
              v[i] = (r >= 0 && r + 1 < kHext)
                  ? ez[(r + 1) * W + c] + coef * (en[(r + 1) * W + c] - ez[r * W + c])
                  : 0.0f;
            } else {    // E3[r, c] = P[r-1, c] + coef (E2[r-1, c] - P[r, c])
              const int r = lbot - kBand + 1 + i;
              v[i] = (r >= 1 && r < kHext)
                  ? ez[(r - 1) * W + c] + coef * (en[(r - 1) * W + c] - ez[r * W + c])
                  : 0.0f;
            }
          }
#pragma unroll
          for (int i = 0; i < kBand; ++i) {
            const int r = top ? ltop + i : lbot - kBand + 1 + i;
            const bool ok = top ? (r >= 0 && r + 1 < kHext) : (r >= 1 && r < kHext);
            if (ok) en[r * W + c] = v[i];
          }
        }
      }
      __syncthreads();

      // -- corner averaging: one thread per corner ------------------------
      if (tid < 4) {
        const bool top = tid < 2;
        const bool left = (tid & 1) == 0;
        if (top ? top_band : bot_band) {
          // band origin (row of domain row 0 or N-5, col of 0 or M-5) and
          // the inward directions of the two averaged neighbours
          const int r0 = top ? ltop : lbot - kBand + 1;
          const int c0 = left ? lleft : lright - kBand + 1;
          float v[kBand][kBand];
          bool ok[kBand][kBand];
#pragma unroll
          for (int i = 0; i < kBand; ++i) {
#pragma unroll
            for (int j = 0; j < kBand; ++j) {
              const int r = r0 + i, c = c0 + j;
              // TL: (r, c+1) + (r+1, c)    TR: (r, c-1) + (r+1, c)
              // BL: (r-1, c) + (r, c+1)    BR: (r-1, c) + (r, c-1)
              const int ra = top ? r : r - 1, ca = top ? (left ? c + 1 : c - 1) : c;
              const int rb = top ? r + 1 : r, cb = top ? c : (left ? c + 1 : c - 1);
              ok[i][j] = r >= 0 && r < kHext && c >= 0 && c < W && ra >= 0 &&
                         ra < kHext && ca >= 0 && ca < W && rb >= 0 && rb < kHext &&
                         cb >= 0 && cb < W;
              v[i][j] = ok[i][j] ? (en[ra * W + ca] + en[rb * W + cb]) * 0.5f : 0.0f;
            }
          }
#pragma unroll
          for (int i = 0; i < kBand; ++i)
#pragma unroll
            for (int j = 0; j < kBand; ++j)
              if (ok[i][j]) en[(r0 + i) * W + c0 + j] = v[i][j];
        }
      }
      __syncthreads();  // corners land before the source may add to one
    }

    // -- point source ----------------------------------------------------
    if (has_src && tid == 0) {
      const float t = static_cast<float>(t0 + s) * dt;
      en[lsr * W + lsc] += source_amp(kind, t, fc);
    }
    __syncthreads();

    float* tmp = ez;
    ez = en;
    en = tmp;
  }

  // -- write the tile (the loaded region minus its halo) back --------------
  {
    const int gc = c_ext0 + tx;
    const bool col_ok = tx >= halo && tx < halo + TX && gc < C;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int lr = lr0 + i;
      const int gr = r_ext0 + lr;
      if (col_ok && lr >= halo && lr < halo + TY && gr < row1) {
        const size_t g = static_cast<size_t>(gr) * C + gc;
        ez_out[g] = ez[lr * W + tx];
        hx_out[g] = hx[lr * W + tx];
        hy_out[g] = hy[lr * W + tx];
      }
    }
  }
}

ffi::Error KstepImpl(cudaStream_t stream, ffi::Buffer<ffi::F32> ez,
                     ffi::Buffer<ffi::F32> hx, ffi::Buffer<ffi::F32> hy,
                     ffi::Buffer<ffi::F32> ce, ffi::Buffer<ffi::F32> ch,
                     ffi::Buffer<ffi::F32> fparams,
                     ffi::Buffer<ffi::S32> iparams,
                     ffi::ResultBuffer<ffi::F32> ezo,
                     ffi::ResultBuffer<ffi::F32> hxo,
                     ffi::ResultBuffer<ffi::F32> hyo, int32_t halo,
                     int32_t nsteps, int32_t row0, int32_t row1,
                     int32_t kind) {
  auto dims = ez.dimensions();
  if (dims.size() != 2) return ffi::Error::InvalidArgument("fields must be 2-D");
  const int R = static_cast<int>(dims[0]);
  const int C = static_cast<int>(dims[1]);
  if (halo < 1 || nsteps < 0 || nsteps > halo || 2 * halo >= kHext ||
      row0 < 0 || row1 > R || row0 >= row1 || C < 2 * (kBand + 1))
    return ffi::Error::InvalidArgument("kstep: inadmissible tile plan");
  if (nsteps == 0) {
    cudaMemcpyAsync(ezo->typed_data(), ez.typed_data(), ez.size_bytes(),
                    cudaMemcpyDeviceToDevice, stream);
    cudaMemcpyAsync(hxo->typed_data(), hx.typed_data(), hx.size_bytes(),
                    cudaMemcpyDeviceToDevice, stream);
    cudaMemcpyAsync(hyo->typed_data(), hy.typed_data(), hy.size_bytes(),
                    cudaMemcpyDeviceToDevice, stream);
    return ffi::Error::Success();
  }
  const int TX = kWext - 2 * halo;
  const int TY = kHext - 2 * halo;
  const size_t smem = 4 * static_cast<size_t>(kHext) * kWext * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kstep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess) {
    dim3 block(kWext, kThreadsY);
    dim3 grid((C + TX - 1) / TX, (row1 - row0 + TY - 1) / TY);
    kstep_kernel<<<grid, block, smem, stream>>>(
        ez.typed_data(), hx.typed_data(), hy.typed_data(), ce.typed_data(),
        ch.typed_data(), fparams.typed_data(), iparams.typed_data(),
        ezo->typed_data(), hxo->typed_data(), hyo->typed_data(), R, C, halo,
        nsteps, row0, row1, kind);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(FdtdKstep, KstepImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()  // ez
                                  .Arg<ffi::Buffer<ffi::F32>>()  // hx
                                  .Arg<ffi::Buffer<ffi::F32>>()  // hy
                                  .Arg<ffi::Buffer<ffi::F32>>()  // ce
                                  .Arg<ffi::Buffer<ffi::F32>>()  // ch
                                  .Arg<ffi::Buffer<ffi::F32>>()  // fparams
                                  .Arg<ffi::Buffer<ffi::S32>>()  // iparams
                                  .Ret<ffi::Buffer<ffi::F32>>()  // ez out
                                  .Ret<ffi::Buffer<ffi::F32>>()  // hx out
                                  .Ret<ffi::Buffer<ffi::F32>>()  // hy out
                                  .Attr<int32_t>("halo")
                                  .Attr<int32_t>("nsteps")
                                  .Attr<int32_t>("row0")
                                  .Attr<int32_t>("row1")
                                  .Attr<int32_t>("kind"));
