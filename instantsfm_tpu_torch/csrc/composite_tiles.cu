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
// Design.  One block per tile, one thread per pixel (256 threads); warp w
// holds the pixel rows 2w and 2w+1 of the tile, a 16x2 rectangle.
//   * Staging: each 8 KB chunk is copied into one of two shared buffers
//     with cp.async, the next one (K2) or the previous one (K3) while the
//     current one is composited.  The exit vote alone decides which chunks
//     are entered; a prefetch of a chunk that is not entered only reads.
//   * Exact cull of dead pairs (cull_box): when a chunk is staged, threads
//     0..127 write one record per row, the box of pixel centres where alpha
//     can exceed 1/255.  alpha > 1/255 needs opacity e > 1/255, i.e.
//     sigma < s = 2 ln(255 opacity); the region {d : d^T C d < s} has the
//     half-extents sqrt(s c / det) in x and sqrt(s a / det) in y, det = ac-b^2.
//     Margins: s is widened to 1.02 s + 0.02, the half-extents to
//     1.001 h + 1e-3 + 1e-6 |mean|; a row is evaluated always unless
//     a > 0 and det > 1e-4 (a + c)^2 and its box is finite, and never when
//     opacity <= 1/255.  gs/composite.py cull_boxes computes the same record
//     with the same formula and margins, and tests/test_torch_composite_cull.py
//     probes that mirror against alpha_terms: every pair with alpha > 0
//     lies inside its row's box; the kernels are held by output parity on
//     tiles built on the cull's edges (chip_smoke.py composite_cull_cases).  Each warp ballots which of the 128 boxes meet its
//     rectangle and walks only those rows (a warp-uniform loop over set
//     bits); every pair it does walk goes through the exact alpha terms.
//     A skipped pair has alpha = 0, so the outputs are the same function.
//   * Row parameters are read from shared memory as two float4 and a float2
//     (broadcast to the warp).
//   * K3 evaluates each surviving pair at most twice, not three times over
//     every pair: pass F walks the surviving rows front to back, records the
//     log-T prefix at each 16-row boundary and a ballot of the rows where
//     some lane of the warp has alpha > 0; pass B walks only those rows back
//     to front, rebuilding the in-chunk prefix by subtracting log(1 - alpha)
//     from the next 16-row boundary (at most 16 rows of rounding).
//   * K3 sums the 10 per-row gradients over a warp's 32 pixels with a
//     transpose-reduce (16 shuffles a row, the sums spread over lanes), keeps
//     the 8 warp sums of every row of the chunk in shared memory (40 KB), and
//     sums them in a fixed order once per chunk: 4 barriers a chunk.  Its
//     66 KB of shared memory is dynamic; 3 blocks share an SM.
//   * One pixel per thread was kept over several: two pixels a thread, a
//     warp over 16x4 pixels, halves the shared-memory loads per pair but
//     evaluates the rows of every box that meets the taller rectangle, and
//     was slower on an H100 (PERF.md, compare_composite_builds.py).
//   * routing g_attrs to the gaussians stays outside (autograd's transpose
//     of the tile gather in gs/rasterize.py).
//
// Bound.  Counting only the chunks entered: K2 reads their attrs once
// (8 KB a chunk) and writes out and logt; K3 reads attrs, gout and logt and
// writes all of g_attrs.  The arithmetic of the redesigned kernels: one
// cull record per row of an entered chunk, one box test per (row, warp),
// the alpha terms (~16 FP32 operations and an exp) per pair that survives
// the cull, and per pair whose alpha is live a log1p, an exp and ~12 FP32
// operations (K2) or a log1p, an exp, a reciprocal and ~54 (K3).
// chip_smoke.py (k2_bound, k3_bound) computes each bound from the run's data.
//
// Interface: plain C, loaded with ctypes (instantsfm_tpu_torch/utils/build.py).
// Each *_launch returns the first CUDA error of its set-up and launch.

#include <cuda_runtime.h>

#define TILE 16
#define NPIX 256                 // pixels of a tile = threads of a block
#define CHUNK 128                // gs/composite.py CHUNK
#define ATTR 16                  // gs/composite.py ATTR
#define NWARP (NPIX / 32)
#define NWORD (CHUNK / 32)       // 32-row words of a warp's row masks
#define SUB 16                   // K3: rows between recorded prefixes
#define NSUB (CHUNK / SUB)
#define NGRAD 10
#define FULL_MASK 0xffffffffu
#define CHUNK_FLOATS (CHUNK * ATTR)

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

// cull margins (gs/composite.py CULL_*)
#define CULL_TAU 1e-4f
#define CULL_S_REL 1.02f
#define CULL_S_ABS 0.02f
#define CULL_H_REL 1.001f
#define CULL_H_ABS 1e-3f
#define CULL_M_REL 1e-6f

// K3's dynamic shared memory: two chunk buffers, the boxes, the 16-row
// prefixes, the per-warp row sums and the per-warp live-row masks
#define K3_SMEM                                                       \
  (2 * CHUNK_FLOATS * 4 + CHUNK * 16 + NSUB * NPIX * 4 +              \
   NWARP * CHUNK * NGRAD * 4 + NWARP * NWORD * 4)

__constant__ float kMinAlpha = 1.0f / 255.0f;
__constant__ float kMaxAlpha = 0.999f;
__constant__ float kLogEpsT = -9.210340371976182f;  // log(1e-4)
#define NOT_RUN (-1e30f)

// One row's parameters, read from shared memory as two float4 and a float2.
struct Row {
  float4 q0;  // mx, my, a, b
  float4 q1;  // c, r, g, b
  float2 q2;  // opacity, depth
};

__device__ __forceinline__ Row load_row(const float* sa, int k) {
  const float* a = sa + k * ATTR;
  return Row{*reinterpret_cast<const float4*>(a),
             *reinterpret_cast<const float4*>(a + 4),
             *reinterpret_cast<const float2*>(a + 8)};
}

// The alpha terms round every operation (no FMA contraction), in the
// order of the plain version (gs/composite.py alpha_terms), so that the
// kernel and the plain version take the same side of the thresholds
// (sigma > 0, alpha > 1/255, opacity e < 0.999) on the same inputs.
__device__ __forceinline__ void alpha_terms(const Row& r, float px, float py,
                                            float& alpha, float& e, float& dx,
                                            float& dy, bool& grad_live) {
  dx = __fsub_rn(r.q0.x, px);
  dy = __fsub_rn(r.q0.y, py);
  const float sigma = __fadd_rn(
      __fadd_rn(__fmul_rn(__fmul_rn(r.q0.z, dx), dx),
                __fmul_rn(__fmul_rn(__fmul_rn(2.0f, r.q0.w), dx), dy)),
      __fmul_rn(__fmul_rn(r.q1.x, dy), dy));
  e = expf(__fmul_rn(-0.5f, sigma));
  const float raw = __fmul_rn(r.q2.x, e);
  const float clipped = fminf(raw, kMaxAlpha);
  const bool live = (sigma > 0.0f) && (clipped > kMinAlpha);
  alpha = live ? clipped : 0.0f;
  grad_live = live && (raw < kMaxAlpha);
}

// The cull record of one row: (x lo, x hi, y lo, y hi) of the pixel centres
// where alpha can exceed 1/255 (see the note at the top; the formula and
// margins are gs/composite.py cull_boxes').  An empty box (lo > hi) skips
// the row everywhere, an infinite one evaluates it everywhere.
__device__ __forceinline__ float4 cull_box(const float* a) {
  const float inf = __int_as_float(0x7f800000);
  const float op = a[OP];
  if (op <= kMinAlpha) return make_float4(inf, -inf, inf, -inf);
  const float ca = a[CA], cb = a[CB], cc = a[CC], mx = a[MX], my = a[MY];
  const float det = __fsub_rn(__fmul_rn(ca, cc), __fmul_rn(cb, cb));
  const float tr = __fadd_rn(ca, cc);
  const float s = __fmul_rn(2.0f, logf(__fmul_rn(255.0f, op)));
  const float sw = __fadd_rn(__fmul_rn(s, CULL_S_REL), CULL_S_ABS);
  const float hx = __fadd_rn(
      __fadd_rn(__fmul_rn(sqrtf(__fdiv_rn(__fmul_rn(sw, cc), det)),
                          CULL_H_REL),
                CULL_H_ABS),
      __fmul_rn(fabsf(mx), CULL_M_REL));
  const float hy = __fadd_rn(
      __fadd_rn(__fmul_rn(sqrtf(__fdiv_rn(__fmul_rn(sw, ca), det)),
                          CULL_H_REL),
                CULL_H_ABS),
      __fmul_rn(fabsf(my), CULL_M_REL));
  const float4 box = make_float4(__fsub_rn(mx, hx), __fadd_rn(mx, hx),
                                 __fsub_rn(my, hy), __fadd_rn(my, hy));
  const bool bounded = ca > 0.0f &&
                       det > __fmul_rn(CULL_TAU, __fmul_rn(tr, tr)) &&
                       isfinite(box.x) && isfinite(box.y) &&
                       isfinite(box.z) && isfinite(box.w);
  return bounded ? box : make_float4(-inf, inf, -inf, inf);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start the copy of chunk ci of the tile into dst (two 16-byte cp.async a
// thread) as one commit group.
__device__ __forceinline__ void stage_chunk(float* dst, const float* tile_attrs,
                                            int ci) {
  const float4* src =
      reinterpret_cast<const float4*>(tile_attrs + (size_t)ci * CHUNK_FLOATS);
  for (int i = threadIdx.x; i < CHUNK_FLOATS / 4; i += NPIX)
    cp_async16(reinterpret_cast<float4*>(dst) + i, src + i);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The cull of a staged chunk: threads 0..127 write the rows' boxes, then
// every warp ballots which boxes meet its rectangle of pixel centres
// [x0, x0 + 15] x [y0, y0 + 1].  Bit b of mask[j] = row 32 j + b.
__device__ __forceinline__ void cull_masks(const float* sa, float4* box,
                                           float x0, float y0,
                                           unsigned (&mask)[NWORD]) {
  if (threadIdx.x < CHUNK) box[threadIdx.x] = cull_box(sa + threadIdx.x * ATTR);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const float x1 = x0 + 15.0f, y1 = y0 + 1.0f;
#pragma unroll
  for (int j = 0; j < NWORD; ++j) {
    const float4 b = box[j * 32 + lane];
    mask[j] = __ballot_sync(FULL_MASK,
                            !(b.y < x0 || b.x > x1 || b.w < y0 || b.z > y1));
  }
}

// The sum over the warp of 10 values per lane, with 16 shuffles: four
// halving rounds (lane bits 4..1 choose which half of the values a lane
// keeps; values 10..15 are zero padding) and a last exchange with the
// neighbour lane.  Lanes 2v and 2v+1 return the sum of value v.
__device__ __forceinline__ float warp_sum10(const float (&v)[NGRAD],
                                            int lane) {
  float a8[8], a4[4], a2[2];
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4, b1 = lane & 2;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float lo = v[i], hi = (i + 8 < NGRAD) ? v[i + 8] : 0.0f;
    a8[i] = (b4 ? hi : lo) + __shfl_xor_sync(FULL_MASK, b4 ? lo : hi, 16);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    a4[i] = (b3 ? a8[i + 4] : a8[i]) +
            __shfl_xor_sync(FULL_MASK, b3 ? a8[i] : a8[i + 4], 8);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    a2[i] = (b2 ? a4[i + 2] : a4[i]) +
            __shfl_xor_sync(FULL_MASK, b2 ? a4[i] : a4[i + 2], 4);
  float s = (b1 ? a2[1] : a2[0]) +
            __shfl_xor_sync(FULL_MASK, b1 ? a2[0] : a2[1], 2);
  return s + __shfl_xor_sync(FULL_MASK, s, 1);
}

__global__ void __launch_bounds__(NPIX)
composite_fwd_kernel(const float* __restrict__ attrs,
                     const int* __restrict__ nchunks, int K, int ntx,
                     float* __restrict__ out, float* __restrict__ logt) {
  __shared__ __align__(16) float sa[2][CHUNK_FLOATS];
  __shared__ float4 box[CHUNK];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int maxc = K / CHUNK;
  const int nc = min(nchunks[t], maxc);
  const float px = (float)((t % ntx) * TILE + p % TILE) + 0.5f;
  const float py = (float)((t / ntx) * TILE + p / TILE) + 0.5f;
  const float x0 = (float)((t % ntx) * TILE) + 0.5f;
  const float y0 = (float)((t / ntx) * TILE + 2 * (p >> 5)) + 0.5f;
  const float* tile_attrs = attrs + (size_t)t * K * ATTR;
  float* lt = logt + (size_t)t * maxc * NPIX;

  float logT = 0.0f, r = 0.0f, g = 0.0f, b = 0.0f, dep = 0.0f;
  if (nc > 0) stage_chunk(sa[0], tile_attrs, 0);
  int ci = 0;
  for (; ci < nc; ++ci) {
    // block-wide vote; also the barrier before sa[(ci + 1) & 1] and box
    // are overwritten
    if (!__syncthreads_or(logT > kLogEpsT)) break;
    lt[ci * NPIX + p] = logT;
    if (ci + 1 < nc) {
      stage_chunk(sa[(ci + 1) & 1], tile_attrs, ci + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* cur = sa[ci & 1];
    unsigned mask[NWORD];
    cull_masks(cur, box, x0, y0, mask);
    float exc = 0.0f;  // exclusive in-chunk prefix of log(1 - alpha)
#pragma unroll
    for (int j = 0; j < NWORD; ++j) {
      for (unsigned m = mask[j]; m; m &= m - 1) {
        const Row row = load_row(cur, j * 32 + __ffs(m) - 1);
        float alpha, e, dx, dy;
        bool grad_live;
        alpha_terms(row, px, py, alpha, e, dx, dy, grad_live);
        if (alpha > 0.0f) {
          const float w = expf(logT + exc) * alpha;
          r += w * row.q1.y;
          g += w * row.q1.z;
          b += w * row.q1.w;
          dep += w * row.q2.y;
          exc += log1pf(-alpha);
        }
      }
    }
    logT += exc;
  }
  cp_async_wait<0>();  // a prefetched chunk the walk did not enter
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

__global__ void __launch_bounds__(NPIX, 3)
composite_bwd_kernel(const float* __restrict__ attrs,
                     const float* __restrict__ gout,
                     const float* __restrict__ logt, int K, int ntx,
                     float* __restrict__ g_attrs) {
  extern __shared__ __align__(16) float smem[];
  float* sa = smem;                                            // [2][CHUNK_FLOATS]
  float4* box = reinterpret_cast<float4*>(sa + 2 * CHUNK_FLOATS);  // [CHUNK]
  float* pre = reinterpret_cast<float*>(box + CHUNK);          // [NSUB][NPIX]
  float* part = pre + NSUB * NPIX;                  // [NWARP][CHUNK][NGRAD]
  unsigned* lmask =
      reinterpret_cast<unsigned*>(part + NWARP * CHUNK * NGRAD);  // [NWARP][NWORD]

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31, warp = p >> 5;
  const int maxc = K / CHUNK;
  const float px = (float)((t % ntx) * TILE + p % TILE) + 0.5f;
  const float py = (float)((t / ntx) * TILE + p / TILE) + 0.5f;
  const float x0 = (float)((t % ntx) * TILE) + 0.5f;
  const float y0 = (float)((t / ntx) * TILE + 2 * warp) + 0.5f;
  const float* tile_attrs = attrs + (size_t)t * K * ATTR;
  const float* lt = logt + (size_t)t * maxc * NPIX;
  float* gt = g_attrs + (size_t)t * K * ATTR;
  float* wpart = part + warp * CHUNK * NGRAD;
  unsigned* wmask = lmask + warp * NWORD;

  // K2 entered a prefix of the chunks and wrote every pixel of each, so
  // every thread finds the same count
  int nce = 0;
  while (nce < maxc && lt[nce * NPIX + p] > 0.5f * NOT_RUN) ++nce;
  {
    float4* z = reinterpret_cast<float4*>(gt + (size_t)nce * CHUNK_FLOATS);
    const int n4 = (maxc - nce) * CHUNK_FLOATS / 4;
    for (int i = p; i < n4; i += NPIX) z[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  const float* go = gout + (size_t)t * 8 * NPIX;
  const float g_r = go[0 * NPIX + p], g_g = go[1 * NPIX + p],
              g_b = go[2 * NPIX + p], g_al = go[3 * NPIX + p],
              g_d = go[4 * NPIX + p];
  float suf = 0.0f;  // sum over later rows (all later chunks) of w g_w

  if (nce > 0) stage_chunk(sa + ((nce - 1) & 1) * CHUNK_FLOATS, tile_attrs,
                           nce - 1);
  for (int ci = nce - 1; ci >= 0; --ci) {
    // the previous chunk's sums are read: part, box and the other buffer
    // may be overwritten
    __syncthreads();
    if (ci > 0) {
      stage_chunk(sa + ((ci - 1) & 1) * CHUNK_FLOATS, tile_attrs, ci - 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    for (int i = lane; i < CHUNK * NGRAD / 4; i += 32)
      reinterpret_cast<float4*>(wpart)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
    const float* cur = sa + (ci & 1) * CHUNK_FLOATS;
    unsigned mask[NWORD];
    cull_masks(cur, box, x0, y0, mask);
    const float le = lt[ci * NPIX + p];

    // pass F: the prefix at each 16-row boundary, and the rows where some
    // lane of the warp has alpha > 0
    float exc = 0.0f;
#pragma unroll
    for (int j = 0; j < NWORD; ++j) {
      unsigned live = 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        pre[(2 * j + h) * NPIX + p] = exc;
        for (unsigned m = (mask[j] >> (16 * h)) & 0xffffu; m; m &= m - 1) {
          const int bit = 16 * h + __ffs(m) - 1;
          const Row row = load_row(cur, j * 32 + bit);
          float alpha, e, dx, dy;
          bool grad_live;
          alpha_terms(row, px, py, alpha, e, dx, dy, grad_live);
          if (__any_sync(FULL_MASK, alpha > 0.0f)) live |= 1u << bit;
          if (alpha > 0.0f) exc += log1pf(-alpha);
        }
      }
      if (lane == 0) wmask[j] = live;
    }
    __syncwarp();

    // pass B: the live rows back to front
    for (int s = NSUB - 1; s >= 0; --s) {
      float ex = (s == NSUB - 1) ? exc : pre[(s + 1) * NPIX + p];
      unsigned m = (wmask[s >> 1] >> (16 * (s & 1))) & 0xffffu;
      while (m) {
        const int bit = 31 - __clz(m);
        m ^= 1u << bit;
        const int k = s * SUB + bit;
        const Row row = load_row(cur, k);
        float alpha, e, dx, dy;
        bool grad_live;
        alpha_terms(row, px, py, alpha, e, dx, dy, grad_live);
        float gv[NGRAD];
#pragma unroll
        for (int v = 0; v < NGRAD; ++v) gv[v] = 0.0f;
        if (alpha > 0.0f) {
          ex -= log1pf(-alpha);  // the exclusive prefix at row k
          const float T = expf(le + ex);
          const float w = T * alpha;
          const float g_w = row.q1.y * g_r + row.q1.z * g_g + row.q1.w * g_b +
                            g_al + row.q2.y * g_d;
          if (grad_live) {
            const float g_a = T * g_w - suf / fmaxf(1.0f - alpha, 1e-3f);
            const float g_s = g_a * (-0.5f * row.q2.x * e);
            gv[0] = 2.0f * g_s * (row.q0.z * dx + row.q0.w * dy);
            gv[1] = 2.0f * g_s * (row.q0.w * dx + row.q1.x * dy);
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
        const float sum = warp_sum10(gv, lane);
        if (!(lane & 1) && (lane >> 1) < NGRAD)
          wpart[k * NGRAD + (lane >> 1)] = sum;
      }
    }
    __syncthreads();
    // the 8 warp sums of each row, in warp order, and the chunk's g_attrs
    float* gc = gt + (size_t)ci * CHUNK_FLOATS;
    for (int i = p; i < CHUNK_FLOATS; i += NPIX) {
      const int row = i / ATTR, col = i % ATTR;
      float sum = 0.0f;
      if (col < NGRAD) {
#pragma unroll
        for (int w = 0; w < NWARP; ++w)
          sum += part[(w * CHUNK + row) * NGRAD + col];
      }
      gc[i] = sum;
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
  // above 48 KB of shared memory a block needs the opt-in (per device)
  const cudaError_t err = cudaFuncSetAttribute(
      composite_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      K3_SMEM);
  if (err != cudaSuccess) return (int)err;
  if (n_tiles > 0)
    composite_bwd_kernel<<<n_tiles, NPIX, K3_SMEM, stream>>>(
        attrs, gout, logt, K, ntx, g_attrs);
  return (int)cudaGetLastError();
}

extern "C" const char* composite_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
