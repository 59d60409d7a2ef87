// Observation half of the reduced-camera Schur matvec (kernel K1), Hopper.
//
// Replaces instantsfm_tpu/solve/pallas_schur.py::schur_wchain (the Pallas
// TPU kernel _kernel, pallas_schur.py:83-117).  For every row o of the
// bucketed track layout (instantsfm_tpu_torch/solve/blocked.py):
//
//     t_o = W_oᵀ x[cam_idx[o]]                 W_o: [PC, 3], x: [C, PC]
//     s   = SUM of t over o's group of L rows   (one track, L = 2**k)
//     z_o = V_inv[pt_idx[o]] s                 V_inv: [T, 3, 3]
//     u_o = W_o z_o                            u: [O', PC], obs-major
//
// The caller forms y = U_d x - SUM_cam u with index_add_.
//
// What differs from the TPU kernel, and why:
//   * x[cam_idx[o]] is gathered here from the [C, PC] table (a few KB, held
//     in L1/L2), so the [O', 8] gathered stream of pack_xg is gone;
//   * V_inv is read per point ([T, 3, 3] by pt_idx), not broadcast per
//     observation as in pack_wvt: 9 values per observation fewer;
//   * W is read in the engine's own obs-major [O', PC, 3] layout;
//   * track sums: groups with L <= 32 reduce by a warp XOR butterfly
//     (__shfl_xor_sync, the TPU's lane roll/select butterfly); groups with
//     32 < L <= 256 add their warps' sums through shared memory; a group
//     with L > 256 owns a block, which loops over its rows twice.  No tile
//     alignment of bucket spans is needed: rows are numbered from each
//     bucket's start.
//   * Padded rows have W = 0 and give exact zeros.
//
// Bound: memory.  Per launch it reads W, cam_idx, pt_idx, V_inv and x once
// and writes u once; it does 11 PC + 15 + 3 log2(L) flops per row (112 at
// PC = 8, L = 8).
// At the ETH3D-indoor shape (C=200, T'=50,176 padded points, O'=401,408
// rows, PC=8, f32): W 38.5 MB + cam_idx/pt_idx 3.2 MB + V_inv 1.8 MB +
// x 6.4 KB + u 12.8 MB = 56.4 MB, i.e. 16.8 us at 3.35 TB/s, against
// 0.7 us of f32 arithmetic at 67 TFLOP/s.  In f64 the bytes double for the
// float arrays: 109.6 MB, 32.7 us.  At the T&T shape (C=500, 1M points,
// O'=8,001,536, f32): 1,124 MB, 336 us.  (chip_smoke.py computes each
// bound from the shapes it runs.)  The design therefore reads each W row
// once into registers and reuses it for u.
//
// Interface: plain C, loaded with ctypes (instantsfm_tpu_torch/utils/build.py).
// schur_wchain_launch returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#define BLOCK 256       // threads per block (solve/schur_wchain.py BLOCK)
#define MAX_BUCKETS 32  // solve/schur_wchain.py MAX_BUCKETS
#define FULL_MASK 0xffffffffu

struct BucketTable {
  int n;
  long long row_start[MAX_BUCKETS];
  long long rows[MAX_BUCKETS];
  int log_l[MAX_BUCKETS];
  long long blk_off[MAX_BUCKETS + 1];
};

template <typename T>
__device__ __forceinline__ void butterfly(T& a, T& b, T& c, int max_off) {
  // all 32 lanes take part; lane i adds lane i^m only while m < group size
#pragma unroll
  for (int m = 1; m < 32; m <<= 1) {
    T pa = __shfl_xor_sync(FULL_MASK, a, m);
    T pb = __shfl_xor_sync(FULL_MASK, b, m);
    T pc = __shfl_xor_sync(FULL_MASK, c, m);
    if (m < max_off) {
      a += pa;
      b += pb;
      c += pc;
    }
  }
}

template <typename T, int PC>
__device__ __forceinline__ void row_t(const T* __restrict__ W,
                                      const T* __restrict__ x,
                                      const int* __restrict__ cam_idx,
                                      long long o, T (&w)[PC][3], T& t0,
                                      T& t1, T& t2) {
  const T* wo = W + o * (PC * 3);
  const T* xo = x + (long long)__ldg(cam_idx + o) * PC;
#pragma unroll
  for (int c = 0; c < PC; ++c) {
    const T xc = __ldg(xo + c);
    w[c][0] = __ldg(wo + 3 * c + 0);
    w[c][1] = __ldg(wo + 3 * c + 1);
    w[c][2] = __ldg(wo + 3 * c + 2);
    t0 += w[c][0] * xc;
    t1 += w[c][1] * xc;
    t2 += w[c][2] * xc;
  }
}

template <typename T, int PC>
__device__ __forceinline__ void row_u(const T (&w)[PC][3], T z0, T z1, T z2,
                                      T* __restrict__ u, long long o) {
  T* uo = u + o * PC;
#pragma unroll
  for (int c = 0; c < PC; ++c)
    uo[c] = w[c][0] * z0 + w[c][1] * z1 + w[c][2] * z2;
}

template <typename T>
__device__ __forceinline__ void apply_vinv(const T* __restrict__ V_inv, int p,
                                           T s0, T s1, T s2, T& z0, T& z1,
                                           T& z2) {
  const T* V = V_inv + (long long)p * 9;
  z0 = __ldg(V + 0) * s0 + __ldg(V + 1) * s1 + __ldg(V + 2) * s2;
  z1 = __ldg(V + 3) * s0 + __ldg(V + 4) * s1 + __ldg(V + 5) * s2;
  z2 = __ldg(V + 6) * s0 + __ldg(V + 7) * s1 + __ldg(V + 8) * s2;
}

template <typename T, int PC>
__global__ void __launch_bounds__(BLOCK)
schur_wchain_kernel(const T* __restrict__ W, const T* __restrict__ V_inv,
                    const T* __restrict__ x, const int* __restrict__ cam_idx,
                    const int* __restrict__ pt_idx, T* __restrict__ u,
                    const BucketTable tab) {
  __shared__ T red[BLOCK / 32][3];
  const long long blk = blockIdx.x;
  int b = 0;
  while (b + 1 < tab.n && blk >= tab.blk_off[b + 1]) ++b;
  const long long L = 1LL << tab.log_l[b];
  const long long local_blk = blk - tab.blk_off[b];
  const long long start = tab.row_start[b];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  if (L <= BLOCK) {
    // one row per thread; the block's BLOCK rows hold whole groups
    const long long r = local_blk * BLOCK + tid;
    const bool active = r < tab.rows[b];
    const long long o = start + r;
    T w[PC][3];
    T t0 = 0, t1 = 0, t2 = 0;
    if (active) {
      row_t<T, PC>(W, x, cam_idx, o, w, t0, t1, t2);
    } else {
#pragma unroll
      for (int c = 0; c < PC; ++c) w[c][0] = w[c][1] = w[c][2] = 0;
    }
    butterfly(t0, t1, t2, (int)(L < 32 ? L : 32));
    if (L > 32) {
      // lane 0 of each warp holds its warp's sum; a group spans L/32 warps
      if (lane == 0) {
        red[warp][0] = t0;
        red[warp][1] = t1;
        red[warp][2] = t2;
      }
      __syncthreads();
      const int wpg = (int)(L >> 5);
      const int g0 = (warp / wpg) * wpg;
      t0 = t1 = t2 = 0;
      for (int i = 0; i < wpg; ++i) {
        t0 += red[g0 + i][0];
        t1 += red[g0 + i][1];
        t2 += red[g0 + i][2];
      }
    }
    if (!active) return;
    T z0, z1, z2;
    apply_vinv(V_inv, __ldg(pt_idx + o), t0, t1, t2, z0, z1, z2);
    row_u<T, PC>(w, z0, z1, z2, u, o);
    return;
  }

  // L > BLOCK: this block owns one group of L rows
  const long long g = start + local_blk * L;
  T t0 = 0, t1 = 0, t2 = 0;
  for (long long r = tid; r < L; r += BLOCK) {
    T w[PC][3];
    row_t<T, PC>(W, x, cam_idx, g + r, w, t0, t1, t2);
  }
  butterfly(t0, t1, t2, 32);
  if (lane == 0) {
    red[warp][0] = t0;
    red[warp][1] = t1;
    red[warp][2] = t2;
  }
  __syncthreads();
  t0 = t1 = t2 = 0;
#pragma unroll
  for (int i = 0; i < BLOCK / 32; ++i) {
    t0 += red[i][0];
    t1 += red[i][1];
    t2 += red[i][2];
  }
  T z0, z1, z2;
  apply_vinv(V_inv, __ldg(pt_idx + g), t0, t1, t2, z0, z1, z2);
  for (long long r = tid; r < L; r += BLOCK) {
    const long long o = g + r;
    const T* wo = W + o * (PC * 3);
    T* uo = u + o * PC;
#pragma unroll
    for (int c = 0; c < PC; ++c)
      uo[c] = __ldg(wo + 3 * c) * z0 + __ldg(wo + 3 * c + 1) * z1 +
              __ldg(wo + 3 * c + 2) * z2;
  }
}

template <typename T>
static void launch_typed(int pc, const void* W, const void* V_inv,
                         const void* x, const void* cam_idx,
                         const void* pt_idx, void* u, const BucketTable& tab,
                         long long nblocks, cudaStream_t stream) {
  const T* w = static_cast<const T*>(W);
  const T* v = static_cast<const T*>(V_inv);
  const T* xx = static_cast<const T*>(x);
  const int* ci = static_cast<const int*>(cam_idx);
  const int* pi = static_cast<const int*>(pt_idx);
  T* uu = static_cast<T*>(u);
  dim3 grid((unsigned)nblocks), block(BLOCK);
  switch (pc) {
#define CASE(N)                                                          \
  case N:                                                                \
    schur_wchain_kernel<T, N><<<grid, block, 0, stream>>>(w, v, xx, ci, \
                                                          pi, uu, tab); \
    break;
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
  }
}

extern "C" {

// dtype: 0 = float32, 1 = float64.  PC in 1..8.  The bucket arrays are host
// arrays of nb entries (blk_off: nb + 1), built by
// solve/schur_wchain.py::launch_table.  Returns a cudaError_t code.
int schur_wchain_launch(int dtype, int pc, const void* W, const void* V_inv,
                        const void* x, const void* cam_idx, const void* pt_idx,
                        void* u, int nb, const long long* row_start,
                        const long long* rows, const long long* log_l,
                        const long long* blk_off, void* stream) {
  if (nb < 1 || nb > MAX_BUCKETS || pc < 1 || pc > 8 || dtype < 0 ||
      dtype > 1)
    return (int)cudaErrorInvalidValue;
  BucketTable tab;
  tab.n = nb;
  for (int i = 0; i < nb; ++i) {
    tab.row_start[i] = row_start[i];
    tab.rows[i] = rows[i];
    tab.log_l[i] = (int)log_l[i];
    tab.blk_off[i] = blk_off[i];
  }
  tab.blk_off[nb] = blk_off[nb];
  const long long nblocks = blk_off[nb];
  if (nblocks == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch_typed<float>(pc, W, V_inv, x, cam_idx, pt_idx, u, tab, nblocks, s);
  else
    launch_typed<double>(pc, W, V_inv, x, cam_idx, pt_idx, u, tab, nblocks, s);
  return (int)cudaGetLastError();
}

const char* schur_wchain_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
