// 3DGS tile compositing, forward (kernel K2) and backward (kernel K3), Hopper.
//
// K2 replaces instantsfm_tpu/gs/pallas_raster.py::_composite_fwd_raw (the
// Pallas TPU kernel _fwd_kernel, pallas_raster.py:96-134); K3 replaces
// _composite_vjp_bwd (_bwd_kernel, pallas_raster.py:137-200).  Plain torch
// versions of both sit beside the wrappers in
// instantsfm_tpu_torch/gs/composite.py.
//
// Input layout (gs/composite.py pack_attrs): attrs [n_tiles, K, 16] f32,
// the depth-sorted gaussians of each 16x16 tile, K % 128 == 0, columns
// 0 mx, 1 my, 2..4 conic (a, b, c), 5..7 rgb, 8 opacity, 9 depth, 10..15
// zero; empty slots are all-zero rows (opacity 0).  Tile t covers pixels
// x in [(t % ntx)*16, +16), y in [(t / ntx)*16, +16).
//
// Per (gaussian k, pixel): d = mean - pixel centre,
//   sigma = a dx^2 + 2 b dx dy + c dy^2,  e = exp(-sigma/2),
//   alpha = min(opacity e, 0.999), zeroed unless sigma > 0 and
//   alpha > 1/255;  weight w_k = T_k alpha_k with T_k = prod_{j<k}(1-alpha_j),
//   kept in log space.
//
// K2 (forward): out [n_tiles, 8, 256] = (rgb, 1 - T, depth, 0, 0, 0) and
// logt [n_tiles, K/128, 256], the entry log T of every 128-row chunk the
// walk entered, -1e30 for the others.  The walk stops at chunk granularity,
// as the TPU kernel's while-loop does: before each chunk the block votes
// (__syncthreads_or) whether any pixel still has log T > log 1e-4, and it
// also stops at nchunks[t].  A per-pixel early stop (as in gsplat) would give
// other numbers, and K3 relies on the logt contract.
//
// K3 (backward): gout [n_tiles, 8, 256] (d rgb, d alpha, d depth in rows
// 0..4) -> g_attrs [n_tiles, K, 16] (columns 0..9 live, 10..15 zero; rows of
// chunks K2 never entered are zero).  It walks the entered chunks back to
// front, carrying S = sum_{j>k} w_j g_j per pixel, with the formulas of
// pallas_raster.py:174-193 (g_alpha = T g_w - S / max(1 - alpha, 1e-3),
// masked where opacity e >= 0.999 or alpha is zeroed).
//
// What differs from the TPU kernels, and why:
//   * no strictly-lower-triangular matmul: the TPU used it because it has no
//     cheap sequential per-pixel loop.  Here one block serves one tile and
//     one thread one pixel (256 threads); each thread composites its pixel
//     front to back in registers over a 128-row chunk staged in shared
//     memory (8 KB, float4 loads).
//   * K3 needs T at every row of a chunk, walking back to front.  It first
//     walks the chunk forward once to record the exclusive log-T prefix at
//     each 16-row boundary, then for each 16-row sub-chunk (last first)
//     recomputes the 16 prefixes into shared memory and walks them back.
//     Shared memory stays at 37 KB a block (8 KB attrs, 16 KB prefixes,
//     8 KB boundaries, 5 KB partial sums), so several blocks share an SM.
//   * the 10 per-gaussian gradients are sums over the tile's 256 pixels:
//     each warp reduces them with __shfl_xor_sync (skipped when no lane of
//     the warp sees the gaussian), the 8 warp sums meet in shared memory,
//     and one thread per (row, column) writes the g_attrs row.
//   * routing g_attrs to the gaussians stays outside (autograd's transpose
//     of the tile gather in gs/rasterize.py).
//
// Bound.  Counting only the chunks entered: K2 reads their attrs once
// (8 KB a chunk) and writes out and logt; K3 reads attrs, gout and logt and
// writes all of g_attrs.  At the 100k-gaussian 800x608 shape (1,900 tiles,
// K = 512) that is at most 62.3 + 15.6 + 7.8 MB, about 26 us at 3.35 TB/s,
// for K2.  The arithmetic is 249 M (gaussian, pixel) pairs at full tiles:
// per pair one exp (SFU) and ~16 FP32 operations, plus a log1p, a second exp
// and ~12 operations per pair whose alpha is live; K3 repeats the alpha
// terms three times and adds ~60 operations and a reciprocal per live pair.
// The special-function unit (16 results per SM per clock) binds before
// FP32, so both kernels are bound by operations, not bytes.
// chip_smoke.py (k2_bound, k3_bound) computes each bound from the run's data.
//
// Interface: plain C, loaded with ctypes (instantsfm_tpu_torch/utils/build.py).
// Each *_launch returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

#define TILE 16
#define NPIX 256                 // pixels of a tile = threads of a block
#define CHUNK 128                // gs/composite.py CHUNK
#define ATTR 16                  // gs/composite.py ATTR
#define SUB 16                   // K3 sub-chunk rows
#define NSUB (CHUNK / SUB)
#define NWARP (NPIX / 32)
#define NGRAD 10
#define FULL_MASK 0xffffffffu

#define MX 0
#define MY 1
#define CA 2
#define CB 3
#define CC 4
#define CR 5
#define CG 6
#define CBL 7
#define OP 8
#define DE 9

static_assert(SUB * ATTR == NPIX, "one thread per (row, column) of a sub-chunk");

__constant__ float kMinAlpha = 1.0f / 255.0f;
__constant__ float kMaxAlpha = 0.999f;
__constant__ float kLogEpsT = -9.210340371976182f;  // log(1e-4)
#define NOT_RUN (-1e30f)

// The alpha terms round every operation (no FMA contraction), in the
// order of the plain version (gs/composite.py alpha_terms), so that the
// kernel and the plain version take the same side of the thresholds
// (sigma > 0, alpha > 1/255, opacity e < 0.999) on the same inputs.
__device__ __forceinline__ void alpha_terms(const float* a, float px, float py,
                                            float& alpha, float& e, float& dx,
                                            float& dy, bool& grad_live) {
  dx = __fsub_rn(a[MX], px);
  dy = __fsub_rn(a[MY], py);
  const float sigma = __fadd_rn(
      __fadd_rn(__fmul_rn(__fmul_rn(a[CA], dx), dx),
                __fmul_rn(__fmul_rn(__fmul_rn(2.0f, a[CB]), dx), dy)),
      __fmul_rn(__fmul_rn(a[CC], dy), dy));
  e = expf(__fmul_rn(-0.5f, sigma));
  const float raw = __fmul_rn(a[OP], e);
  const float clipped = fminf(raw, kMaxAlpha);
  const bool live = (sigma > 0.0f) && (clipped > kMinAlpha);
  alpha = live ? clipped : 0.0f;
  grad_live = live && (raw < kMaxAlpha);
}

__device__ __forceinline__ void load_chunk(float* sa, const float* tile_attrs,
                                           int ci) {
  const float4* src =
      reinterpret_cast<const float4*>(tile_attrs + (size_t)ci * CHUNK * ATTR);
  float4* dst = reinterpret_cast<float4*>(sa);
  for (int i = threadIdx.x; i < CHUNK * ATTR / 4; i += NPIX) dst[i] = src[i];
}

__global__ void __launch_bounds__(NPIX)
composite_fwd_kernel(const float* __restrict__ attrs,
                     const int* __restrict__ nchunks, int K, int ntx,
                     float* __restrict__ out, float* __restrict__ logt) {
  __shared__ __align__(16) float sa[CHUNK * ATTR];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int maxc = K / CHUNK;
  const int nc = min(nchunks[t], maxc);
  const float px = (float)((t % ntx) * TILE + p % TILE) + 0.5f;
  const float py = (float)((t / ntx) * TILE + p / TILE) + 0.5f;
  const float* tile_attrs = attrs + (size_t)t * K * ATTR;
  float* lt = logt + (size_t)t * maxc * NPIX;

  float logT = 0.0f, r = 0.0f, g = 0.0f, b = 0.0f, dep = 0.0f;
  int ci = 0;
  for (; ci < nc; ++ci) {
    // block-wide vote; also the barrier before sa is overwritten
    if (!__syncthreads_or(logT > kLogEpsT)) break;
    lt[ci * NPIX + p] = logT;
    load_chunk(sa, tile_attrs, ci);
    __syncthreads();
    float exc = 0.0f;  // exclusive in-chunk prefix of log(1 - alpha)
    for (int k = 0; k < CHUNK; ++k) {
      const float* a = sa + k * ATTR;
      float alpha, e, dx, dy;
      bool grad_live;
      alpha_terms(a, px, py, alpha, e, dx, dy, grad_live);
      if (alpha > 0.0f) {
        const float w = expf(logT + exc) * alpha;
        r += w * a[CR];
        g += w * a[CG];
        b += w * a[CBL];
        dep += w * a[DE];
        exc += log1pf(-alpha);
      }
    }
    logT += exc;
  }
  for (int c = ci; c < maxc; ++c) lt[c * NPIX + p] = NOT_RUN;

  float* o = out + (size_t)t * 8 * NPIX;
  o[0 * NPIX + p] = r;
  o[1 * NPIX + p] = g;
  o[2 * NPIX + p] = b;
  o[3 * NPIX + p] = 1.0f - expf(logT);
  o[4 * NPIX + p] = dep;
  o[5 * NPIX + p] = 0.0f;
  o[6 * NPIX + p] = 0.0f;
  o[7 * NPIX + p] = 0.0f;
}

__global__ void __launch_bounds__(NPIX)
composite_bwd_kernel(const float* __restrict__ attrs,
                     const float* __restrict__ gout,
                     const float* __restrict__ logt, int K, int ntx,
                     float* __restrict__ g_attrs) {
  __shared__ __align__(16) float sa[CHUNK * ATTR];
  __shared__ float ex[SUB][NPIX];     // exclusive log-T prefix of a sub-chunk
  __shared__ float pre[NSUB][NPIX];   // the prefix at each sub-chunk start
  __shared__ float part[SUB][NWARP][NGRAD];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31, warp = p >> 5;
  const int maxc = K / CHUNK;
  const float px = (float)((t % ntx) * TILE + p % TILE) + 0.5f;
  const float py = (float)((t / ntx) * TILE + p / TILE) + 0.5f;
  const float* tile_attrs = attrs + (size_t)t * K * ATTR;
  const float* lt = logt + (size_t)t * maxc * NPIX;
  float* gt = g_attrs + (size_t)t * K * ATTR;

  // K2 entered a prefix of the chunks and wrote every pixel of each, so
  // every thread finds the same count
  int nce = 0;
  while (nce < maxc && lt[nce * NPIX + p] > 0.5f * NOT_RUN) ++nce;
  {
    float4* z = reinterpret_cast<float4*>(gt + (size_t)nce * CHUNK * ATTR);
    const int n4 = (maxc - nce) * CHUNK * ATTR / 4;
    for (int i = p; i < n4; i += NPIX) z[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  const float* go = gout + (size_t)t * 8 * NPIX;
  const float g_r = go[0 * NPIX + p], g_g = go[1 * NPIX + p],
              g_b = go[2 * NPIX + p], g_al = go[3 * NPIX + p],
              g_d = go[4 * NPIX + p];
  float suf = 0.0f;  // sum over later rows (all later chunks) of w g_w

  for (int ci = nce - 1; ci >= 0; --ci) {
    __syncthreads();
    load_chunk(sa, tile_attrs, ci);
    __syncthreads();
    const float le = lt[ci * NPIX + p];

    float exc = 0.0f;
    for (int s = 0; s < NSUB; ++s) {
      pre[s][p] = exc;
      for (int kk = 0; kk < SUB; ++kk) {
        float alpha, e, dx, dy;
        bool grad_live;
        alpha_terms(sa + (s * SUB + kk) * ATTR, px, py, alpha, e, dx, dy,
                    grad_live);
        if (alpha > 0.0f) exc += log1pf(-alpha);
      }
    }

    for (int s = NSUB - 1; s >= 0; --s) {
      float e2 = pre[s][p];
      for (int kk = 0; kk < SUB; ++kk) {
        ex[kk][p] = e2;
        float alpha, e, dx, dy;
        bool grad_live;
        alpha_terms(sa + (s * SUB + kk) * ATTR, px, py, alpha, e, dx, dy,
                    grad_live);
        if (alpha > 0.0f) e2 += log1pf(-alpha);
      }
      for (int kk = SUB - 1; kk >= 0; --kk) {
        const float* a = sa + (s * SUB + kk) * ATTR;
        float alpha, e, dx, dy;
        bool grad_live;
        alpha_terms(a, px, py, alpha, e, dx, dy, grad_live);
        float gv[NGRAD];
#pragma unroll
        for (int v = 0; v < NGRAD; ++v) gv[v] = 0.0f;
        if (alpha > 0.0f) {
          const float T = expf(le + ex[kk][p]);
          const float w = T * alpha;
          const float g_w = a[CR] * g_r + a[CG] * g_g + a[CBL] * g_b + g_al +
                            a[DE] * g_d;
          if (grad_live) {
            const float g_a = T * g_w - suf / fmaxf(1.0f - alpha, 1e-3f);
            const float g_s = g_a * (-0.5f * a[OP] * e);
            gv[0] = 2.0f * g_s * (a[CA] * dx + a[CB] * dy);
            gv[1] = 2.0f * g_s * (a[CB] * dx + a[CC] * dy);
            gv[2] = g_s * dx * dx;
            gv[3] = 2.0f * g_s * dx * dy;
            gv[4] = g_s * dy * dy;
            gv[8] = g_a * e;
          }
          gv[5] = w * g_r;
          gv[6] = w * g_g;
          gv[7] = w * g_b;
          gv[9] = w * g_d;
          suf += w * g_w;
        }
        if (__any_sync(FULL_MASK, alpha > 0.0f)) {
#pragma unroll
          for (int v = 0; v < NGRAD; ++v) {
#pragma unroll
            for (int m = 16; m >= 1; m >>= 1)
              gv[v] += __shfl_xor_sync(FULL_MASK, gv[v], m);
          }
        }
        if (lane == 0) {
#pragma unroll
          for (int v = 0; v < NGRAD; ++v) part[kk][warp][v] = gv[v];
        }
      }
      __syncthreads();
      {
        const int row = p / ATTR, col = p % ATTR;
        float sum = 0.0f;
        if (col < NGRAD) {
#pragma unroll
          for (int w = 0; w < NWARP; ++w) sum += part[row][w][col];
        }
        gt[((size_t)ci * CHUNK + s * SUB + row) * ATTR + col] = sum;
      }
      __syncthreads();
    }
  }
}

extern "C" int composite_fwd_launch(const float* attrs, const int* nchunks,
                                    int n_tiles, int K, int ntx, float* out,
                                    float* logt, cudaStream_t stream) {
  if (n_tiles > 0)
    composite_fwd_kernel<<<n_tiles, NPIX, 0, stream>>>(attrs, nchunks, K, ntx,
                                                       out, logt);
  return (int)cudaGetLastError();
}

extern "C" int composite_bwd_launch(const float* attrs, const float* gout,
                                    const float* logt, int n_tiles, int K,
                                    int ntx, float* g_attrs,
                                    cudaStream_t stream) {
  if (n_tiles > 0)
    composite_bwd_kernel<<<n_tiles, NPIX, 0, stream>>>(attrs, gout, logt, K,
                                                       ntx, g_attrs);
  return (int)cudaGetLastError();
}

extern "C" const char* composite_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
