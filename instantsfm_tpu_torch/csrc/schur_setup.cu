// The damped solve's per-row passes on the PCG path, Hopper.
//
// A port kernel pair with no TPU counterpart: the JAX package runs these
// passes as XLA ops in its damped solve (instantsfm_tpu/solve/block_lm.py).
// For the bucketed track layout (instantsfm_tpu_torch/solve/blocked.py: a
// track's rows are one aligned group of L = 2**k rows; row o of point slot
// p sits on camera c_o with W_o [PC, 3]), the damping lam (read from device
// memory: the host never reads it) and eps:
//
// Set-up (schur_setup_kernel), once a damped try, before the PCG:
//
//     V_d    = V[p] + diag(lam diag(V[p]) + eps)
//     Vi     = adj(V_d) / det(V_d), 0 where |det| < 1e-30    -> V_inv[p]
//     z      = Vi g_pt[p]
//     dc[c] += (W_o Vi W_oᵀ row-major, then W_o z)   over camera c's rows
//
// into dc [C, PC*PC + PC]; the caller forms the block-Jacobi
// preconditioner's blocks U_d - D and the right-hand side g_cam - rhs.
//
// Back-substitution (schur_backsub_kernel), once a damped try, after it:
//
//     d_pt[p] = V_inv[p] (g_pt[p] - SUM over p's rows of W_oᵀ d_cam[c_o])
//
// The plain torch version of both is solve/schur_setup.py
// (setup_reference, backsub_reference), the same formulas.  NaN stays NaN:
// a NaN in V or g_pt gives that point a NaN V_inv and d_pt and its cameras
// NaN sums; a NaN in d_cam reaches every point with a row on that camera.
//
// Bound: bytes.  Each pass reads W (3 PC entries) and cam_idx a row, once,
// and a point's V, g_pt or V_inv; the set-up writes V_inv and dc, the
// back-substitution d_pt.  At the benchmark's BA cell (1,199,616 rows, 200
// cameras, 19.5k point slots, PC = 8, float32) that is about 122 MB a pass,
// 36 us at 3.35 TB/s.  A set-up row is some 250 flops (W Vi, the upper
// triangle of W Vi Wᵀ, W z), far below the tensor cores' use.
//
//   * Work items are K1's (solve/schur_wchain.py::launch_table): BLOCK rows
//     of whole groups where L <= BLOCK, one group where L > BLOCK (walked in
//     passes of BLOCK rows), taken by persistent blocks by stride.  A row's
//     point slot is pt_start_b + (o - os_b) / L; pt_idx is not read.
//   * Each thread reads its row's W with 16-byte loads where a row is a
//     multiple of 16 bytes (PC = 8 in float32), else entry by entry.
//   * Set-up, a point: each thread damps and inverts its own point's V (the
//     threads of a group read the same 48 bytes); the group's first thread
//     writes V_inv.  Every slot of the layout is written.
//   * Set-up, camera sums: where the table fits (schur_setup.py::
//     shared_table counts everything the block keeps in shared memory, the
//     table alone) each block keeps the upper triangle of W Vi Wᵀ and W z,
//     PC (PC + 1) / 2 + PC entries a camera in 16-byte words, camera minor,
//     and adds a row to it with one 128-bit shared compare-and-swap a word,
//     as K1 and the BA build kernel do; at the end it adds its table to dc,
//     mirrored, one global atomic per nonzero entry (four float32 entries at
//     a time).  Past it each row adds to dc with global atomics.  A row
//     whose W is exactly zero (the layout's padding, all on camera 0, and
//     invalid rows) adds nothing: its terms are 0, or NaN only where its
//     point's V or g_pt is, which the point's own V_inv and d_pt carry.  dc
//     is zeroed by a memset before the kernel; its sums change order from
//     run to run, as index_add_'s do on the card.
//   * Back-substitution, track sums: a warp XOR butterfly for L <= 32, warp
//     sums through shared memory above, as K1's; d_cam is copied once a
//     block into shared memory ([PC, C], camera minor) where it fits, else
//     read through L1.  Every row is read, zero or not.
//
// Interface: plain C, loaded with ctypes (instantsfm_tpu_torch/utils/build.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#define BLOCK 256           // threads a block, rows a work item (solve/schur_wchain.py BLOCK)
#define NWARP (BLOCK / 32)
#define MAX_BUCKETS 32      // solve/schur_wchain.py MAX_BUCKETS
#define SETUP_PER_SM 2      // resident set-up blocks an SM, at most
#define BACKSUB_PER_SM 4    // resident back-substitution blocks an SM, at most
#define MAX_DEVICES 64
#define FULL_MASK 0xffffffffu

struct BucketTable {
  int n;
  int item_off[MAX_BUCKETS + 1];
  int log_l[MAX_BUCKETS];
  long long row_start[MAX_BUCKETS];
  long long rows[MAX_BUCKETS];
  long long pt_start[MAX_BUCKETS];
};

// A work item: rows [row0, row0 + n) of point slots from p0, groups of 2**log_l
struct Item {
  long long row0, p0;
  int n, log_l;
};

__device__ __forceinline__ Item item_at(const BucketTable& tab, int item) {
  int b = 0;
  while (b + 1 < tab.n && item >= tab.item_off[b + 1]) ++b;
  const long long li = item - tab.item_off[b];
  Item it;
  it.log_l = tab.log_l[b];
  const long long L = 1LL << it.log_l;
  if (L <= BLOCK) {
    const long long left = tab.rows[b] - li * BLOCK;
    it.row0 = tab.row_start[b] + li * BLOCK;
    it.n = (int)(left < BLOCK ? left : BLOCK);
    it.p0 = tab.pt_start[b] + ((li * BLOCK) >> it.log_l);
  } else {
    it.row0 = tab.row_start[b] + li * L;
    it.n = (int)L;
    it.p0 = tab.pt_start[b] + li;
  }
  return it;
}

template <typename T, int PC>
struct Dims {
  static constexpr int NU = PC * (PC + 1) / 2;  // D's upper triangle
  static constexpr int NCAM = NU + PC;          // with the rhs correction
  static constexpr int PER = 16 / (int)sizeof(T);
  static constexpr int SLOTS = (NCAM + PER - 1) / PER;  // 16-byte words a camera
  static constexpr int OUT = PC * PC + PC;      // dc's entries a camera
};

// Row o of W into w; returns whether any entry is nonzero (a NaN counts)
template <typename T, int PC>
__device__ __forceinline__ bool load_w(const T* __restrict__ W, long long o,
                                       T (&w)[PC][3]) {
  constexpr int N = PC * 3;
  const T* row = W + o * N;
  T v[N];
  if constexpr ((N * sizeof(T)) % 16 == 0) {
    if constexpr (std::is_same<T, float>::value) {
#pragma unroll
      for (int i = 0; i < N / 4; ++i) {
        const float4 q = __ldg(reinterpret_cast<const float4*>(row) + i);
        v[4 * i] = q.x;
        v[4 * i + 1] = q.y;
        v[4 * i + 2] = q.z;
        v[4 * i + 3] = q.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const double2 q = __ldg(reinterpret_cast<const double2*>(row) + i);
        v[2 * i] = q.x;
        v[2 * i + 1] = q.y;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = __ldg(row + i);
  }
  bool nz = false;
#pragma unroll
  for (int c = 0; c < PC; ++c)
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      w[c][k] = v[3 * c + k];
      nz |= v[3 * c + k] != T(0);
    }
  return nz;
}

// V_inv and z = V_inv g of point p, as solve/schur_setup.py's _damped and
// _inv3x3: the damping is added to the diagonal through the identity's
// entries (an infinite or NaN damping reaches the whole row, as there)
template <typename T>
__device__ __forceinline__ void point_inverse(const T* __restrict__ V,
                                              const T* __restrict__ g_pt,
                                              long long p, T lam, T eps,
                                              T (&vi)[9], T (&z)[3]) {
  T M[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) M[i] = __ldg(V + 9 * p + i);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const T s = lam * M[4 * i] + eps;
#pragma unroll
    for (int j = 0; j < 3; ++j) M[3 * i + j] += (i == j ? T(1) : T(0)) * s;
  }
  const T a = M[0], b = M[1], c = M[2];
  const T d = M[3], e = M[4], f = M[5];
  const T g = M[6], h = M[7], i = M[8];
  const T A = e * i - f * h;
  const T B = -(d * i - f * g);
  const T Cf = d * h - e * g;
  const T det = a * A + b * B + c * Cf;
  const T inv_det = fabs(det) < T(1e-30) ? T(0) : T(1) / det;
  vi[0] = A * inv_det;
  vi[1] = -(b * i - c * h) * inv_det;
  vi[2] = (b * f - c * e) * inv_det;
  vi[3] = B * inv_det;
  vi[4] = (a * i - c * g) * inv_det;
  vi[5] = -(a * f - c * d) * inv_det;
  vi[6] = Cf * inv_det;
  vi[7] = -(a * h - b * g) * inv_det;
  vi[8] = (a * e - b * d) * inv_det;
  const T g0 = __ldg(g_pt + 3 * p), g1 = __ldg(g_pt + 3 * p + 1),
          g2 = __ldg(g_pt + 3 * p + 2);
#pragma unroll
  for (int r = 0; r < 3; ++r)
    z[r] = vi[3 * r] * g0 + vi[3 * r + 1] * g1 + vi[3 * r + 2] * g2;
}

// 128-bit compare-and-swap on shared memory (sm_90), as in schur_wchain.cu
__device__ __forceinline__ bool cas128(unsigned long long* p,
                                      unsigned long long& lo,
                                      unsigned long long& hi,
                                      unsigned long long nlo,
                                      unsigned long long nhi) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  unsigned long long olo, ohi;
  asm volatile(
      "{\n\t.reg .b128 d, c, n;\n\t"
      "mov.b128 c, {%2, %3};\n\t"
      "mov.b128 n, {%4, %5};\n\t"
      "atom.shared.cas.b128 d, [%6], c, n;\n\t"
      "mov.b128 {%0, %1}, d;\n\t}"
      : "=l"(olo), "=l"(ohi)
      : "l"(lo), "l"(hi), "l"(nlo), "l"(nhi), "r"(a)
      : "memory");
  const bool ok = olo == lo && ohi == hi;
  lo = olo;
  hi = ohi;
  return ok;
}

__device__ __forceinline__ unsigned long long add2(unsigned long long old,
                                                   float a, float b) {
  const float lo = __uint_as_float((unsigned)old) + a;
  const float hi = __uint_as_float((unsigned)(old >> 32)) + b;
  return (unsigned long long)__float_as_uint(lo) |
         ((unsigned long long)__float_as_uint(hi) << 32);
}

__device__ __forceinline__ unsigned long long add1(unsigned long long old,
                                                   double a) {
  return (unsigned long long)__double_as_longlong(
      __longlong_as_double((long long)old) + a);
}

// Add e (SLOTS * PER entries) to camera cam's words of the table [SLOTS, C]
template <typename T, int SLOTS>
__device__ __forceinline__ void shared_add(unsigned long long* acc, int C,
                                           int cam, const T* e) {
  unsigned long long lo[SLOTS], hi[SLOTS];
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    const ulonglong2 w =
        *reinterpret_cast<const ulonglong2*>(acc + 2 * ((long long)j * C + cam));
    lo[j] = w.x;
    hi[j] = w.y;
  }
  unsigned long long pending = SLOTS >= 64 ? ~0ull : (1ull << SLOTS) - 1;
  do {
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      if (pending & (1ull << j)) {
        unsigned long long nlo, nhi;
        if constexpr (std::is_same<T, float>::value) {
          nlo = add2(lo[j], e[4 * j], e[4 * j + 1]);
          nhi = add2(hi[j], e[4 * j + 2], e[4 * j + 3]);
        } else {
          nlo = add1(lo[j], e[2 * j]);
          nhi = add1(hi[j], e[2 * j + 1]);
        }
        if (cas128(acc + 2 * ((long long)j * C + cam), lo[j], hi[j], nlo, nhi))
          pending &= ~(1ull << j);
      }
    }
  } while (pending);
}

// index of D's entry (a, b), a <= b, in the packed upper triangle
__host__ __device__ constexpr int tri(int a, int b, int PC) {
  return a * PC - a * (a - 1) / 2 + (b - a);
}

// camera entry i of dc's row (D row-major, then rhs) in the packed order
template <int PC>
__device__ __forceinline__ int packed(int i) {
  if (i >= PC * PC) return PC * (PC + 1) / 2 + (i - PC * PC);
  const int a = i / PC, b = i - a * PC;
  return a <= b ? tri(a, b, PC) : tri(b, a, PC);
}

template <typename T, int PC>
struct SetupSmem {
  __host__ __device__ static size_t bytes(int C, bool shared) {
    return shared ? (size_t)C * Dims<T, PC>::SLOTS * 16 : 0;
  }
};

template <typename T, int PC, bool SHARED>
__global__ void __launch_bounds__(BLOCK)
schur_setup_kernel(const T* __restrict__ V, const T* __restrict__ g_pt,
                   const T* __restrict__ W, const int* __restrict__ cam_idx,
                   const T* __restrict__ lam_p, const T eps,
                   T* __restrict__ V_inv, T* __restrict__ dc, int C,
                   const BucketTable tab) {
  using D = Dims<T, PC>;
  extern __shared__ __align__(16) unsigned char smem[];
  auto* acc = reinterpret_cast<unsigned long long*>(smem);  // [SLOTS, C, 2]
  const int tid = threadIdx.x;
  const int nitems = tab.item_off[tab.n];
  const T lam = __ldg(lam_p);

  if constexpr (SHARED) {
    for (int i = tid; i < 2 * D::SLOTS * C; i += BLOCK) acc[i] = 0ull;
    __syncthreads();
  }

  for (int item = blockIdx.x; item < nitems; item += gridDim.x) {
    const Item it = item_at(tab, item);
    const long long L = 1LL << it.log_l;
    // passes of BLOCK rows: one where L <= BLOCK, L / BLOCK of one group
    for (int base = 0; base < it.n; base += BLOCK) {
      if (tid >= it.n - base) break;
      const long long o = it.row0 + base + tid;
      const long long p = L <= BLOCK ? it.p0 + (tid >> it.log_l) : it.p0;
      T vi[9], z[3];
      point_inverse(V, g_pt, p, lam, eps, vi, z);
      if (base == 0 && (tid & (L - 1)) == 0) {
#pragma unroll
        for (int i = 0; i < 9; ++i) V_inv[9 * p + i] = vi[i];
      }
      T w[PC][3];
      if (!load_w<T, PC>(W, o, w)) continue;
      const int cam = __ldg(cam_idx + o);

      // the camera's entries: W Vi Wᵀ's upper triangle, then W z
      T e[D::SLOTS * D::PER];
#pragma unroll
      for (int a = 0; a < PC; ++a) {
        T wv[3];
#pragma unroll
        for (int j = 0; j < 3; ++j)
          wv[j] = w[a][0] * vi[j] + w[a][1] * vi[3 + j] + w[a][2] * vi[6 + j];
#pragma unroll
        for (int b = a; b < PC; ++b)
          e[tri(a, b, PC)] = wv[0] * w[b][0] + wv[1] * w[b][1] + wv[2] * w[b][2];
        e[D::NU + a] = w[a][0] * z[0] + w[a][1] * z[1] + w[a][2] * z[2];
      }
#pragma unroll
      for (int i = D::NCAM; i < D::SLOTS * D::PER; ++i) e[i] = T(0);
      if constexpr (SHARED) {
        shared_add<T, D::SLOTS>(acc, C, cam, e);
      } else {
        T* y = dc + (long long)cam * D::OUT;
        if constexpr (std::is_same<T, float>::value && PC % 4 == 0) {
#pragma unroll
          for (int i = 0; i < D::OUT; i += 4)
            atomicAdd(reinterpret_cast<float4*>(y + i),
                      make_float4(e[packed<PC>(i)], e[packed<PC>(i + 1)],
                                  e[packed<PC>(i + 2)], e[packed<PC>(i + 3)]));
        } else {
#pragma unroll
          for (int i = 0; i < D::OUT; ++i) atomicAdd(y + i, e[packed<PC>(i)]);
        }
      }
    }
  }

  if constexpr (SHARED) {
    // every thread's shared atomics are done; the table goes to dc, D
    // mirrored, one atomic per nonzero entry, four float32 entries at a time
    __syncthreads();
    const T* sums = reinterpret_cast<const T*>(acc);
    auto entry = [&](int i) {  // dc's flat entry i = cam * OUT + j
      const int cam = i / D::OUT;
      const int k = packed<PC>(i - cam * D::OUT);
      return sums[((k / D::PER) * C + cam) * D::PER + k % D::PER];
    };
    const int n = C * D::OUT;
    if constexpr (std::is_same<T, float>::value) {
      for (int i = 4 * tid; i < n; i += 4 * BLOCK) {
        if (i + 4 <= n) {
          const float4 v = make_float4(entry(i), entry(i + 1), entry(i + 2),
                                       entry(i + 3));
          if (v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f)
            atomicAdd(reinterpret_cast<float4*>(dc + i), v);
        } else {
          for (int k = i; k < n; ++k) {
            const float v = entry(k);
            if (v != 0.f) atomicAdd(dc + k, v);
          }
        }
      }
    } else {
      for (int i = tid; i < n; i += BLOCK) {
        const T v = entry(i);
        if (v != T(0)) atomicAdd(dc + i, v);
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ void butterfly(T& a, T& b, T& c, int max_off) {
  // all 32 lanes take part: lane i adds lane i^m for m < the group's size
  for (int m = 1; m < max_off; m <<= 1) {
    a += __shfl_xor_sync(FULL_MASK, a, m);
    b += __shfl_xor_sync(FULL_MASK, b, m);
    c += __shfl_xor_sync(FULL_MASK, c, m);
  }
}

// d_pt[p] = V_inv[p] (g_pt[p] - t)
template <typename T>
__device__ __forceinline__ void write_point(const T* __restrict__ V_inv,
                                            const T* __restrict__ g_pt,
                                            T* __restrict__ d_pt, long long p,
                                            T t0, T t1, T t2) {
  const T r0 = __ldg(g_pt + 3 * p) - t0, r1 = __ldg(g_pt + 3 * p + 1) - t1,
          r2 = __ldg(g_pt + 3 * p + 2) - t2;
  const T* M = V_inv + 9 * p;
#pragma unroll
  for (int i = 0; i < 3; ++i)
    d_pt[3 * p + i] =
        __ldg(M + 3 * i) * r0 + __ldg(M + 3 * i + 1) * r1 + __ldg(M + 3 * i + 2) * r2;
}

template <typename T, int PC>
struct BacksubSmem {
  static constexpr int RED = NWARP * 3 * (int)sizeof(T);
  __host__ __device__ static int cams(int C, bool shared) {
    return shared ? (int)(((long long)C * PC * sizeof(T) + 15) & ~15LL) : 0;
  }
  __host__ __device__ static size_t bytes(int C, bool shared) {
    return (size_t)cams(C, shared) + RED;
  }
};

template <typename T, int PC, bool SHARED>
__global__ void __launch_bounds__(BLOCK)
schur_backsub_kernel(const T* __restrict__ W, const int* __restrict__ cam_idx,
                     const T* __restrict__ V_inv, const T* __restrict__ g_pt,
                     const T* __restrict__ d_cam, T* __restrict__ d_pt, int C,
                     const BucketTable tab) {
  using SM = BacksubSmem<T, PC>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* xt = reinterpret_cast<T*>(smem);                         // [PC, C]
  T* red = reinterpret_cast<T*>(smem + SM::cams(C, SHARED));  // [NWARP, 3]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nitems = tab.item_off[tab.n];

  if constexpr (SHARED) {
    for (int i = tid; i < PC * C; i += BLOCK) {
      const int cam = i / PC;
      xt[(i - cam * PC) * C + cam] = d_cam[i];
    }
    __syncthreads();
  }

  for (int item = blockIdx.x; item < nitems; item += gridDim.x) {
    const Item it = item_at(tab, item);
    const long long L = 1LL << it.log_l;
    T t0 = 0, t1 = 0, t2 = 0;  // this thread's rows' W_oᵀ d_cam[c_o]
    for (int base = 0; base < it.n; base += BLOCK) {
      if (tid < it.n - base) {
        const long long o = it.row0 + base + tid;
        T w[PC][3];
        load_w<T, PC>(W, o, w);
        const int cam = __ldg(cam_idx + o);
#pragma unroll
        for (int c = 0; c < PC; ++c) {
          const T x = SHARED ? xt[c * C + cam] : __ldg(d_cam + (long long)cam * PC + c);
          t0 += w[c][0] * x;
          t1 += w[c][1] * x;
          t2 += w[c][2] * x;
        }
      }
    }
    // the track sums of each group; every lane takes part in the shuffles
    if (L <= 32) {
      butterfly(t0, t1, t2, (int)L);
      if ((tid & (L - 1)) == 0 && tid < it.n)
        write_point(V_inv, g_pt, d_pt, it.p0 + (tid >> it.log_l), t0, t1, t2);
    } else {
      butterfly(t0, t1, t2, 32);
      if (lane == 0) {
        red[3 * warp] = t0;
        red[3 * warp + 1] = t1;
        red[3 * warp + 2] = t2;
      }
      __syncthreads();
      const int wpg = L <= BLOCK ? (int)(L >> 5) : NWARP;  // warps a group
      if (L <= BLOCK ? (tid & (L - 1)) == 0 && tid < it.n : tid == 0) {
        T s0 = 0, s1 = 0, s2 = 0;
        for (int k = 0; k < wpg; ++k) {
          s0 += red[3 * (warp + k)];
          s1 += red[3 * (warp + k) + 1];
          s2 += red[3 * (warp + k) + 2];
        }
        write_point(V_inv, g_pt, d_pt, L <= BLOCK ? it.p0 + (tid >> it.log_l) : it.p0,
                    s0, s1, s2);
      }
      __syncthreads();  // red is free for the next item
    }
  }
}

struct Args {
  const void *V, *g_pt, *W, *cam_idx, *lam, *V_inv, *d_cam;
  void *V_inv_out, *dc, *d_pt;
  double eps;
  int C, sms;
  BucketTable tab;
};

// Grid of persistent blocks for `kernel` at `smem` bytes a block: the blocks
// an SM that fit, at most per_sm, times the SMs, at most one a work item.
// `granted` and `occ_smem`/`occ` are the instantiation's own state.
template <typename K>
static cudaError_t grid_for(K kernel, size_t smem, int per_sm_max,
                            const Args& a, size_t& granted, size_t& occ_smem,
                            int& occ, unsigned& grid) {
  cudaError_t err;
  if (smem > granted) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    granted = smem;
  }
  if (smem != occ_smem) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, BLOCK, smem);
    if (err != cudaSuccess) return err;
    occ_smem = smem;
  }
  if (occ < 1) return cudaErrorInvalidConfiguration;
  const int per_sm = per_sm_max < occ ? per_sm_max : occ;
  const long long nitems = a.tab.item_off[a.tab.n];
  const long long cap = (long long)per_sm * a.sms;
  grid = (unsigned)(nitems < cap ? nitems : cap);
  return cudaSuccess;
}

template <typename T, int PC, bool SHARED>
static cudaError_t launch_setup(const Args& a, cudaStream_t stream) {
  auto kernel = schur_setup_kernel<T, PC, SHARED>;
  static size_t granted = 48 * 1024, occ_smem = ~(size_t)0;
  static int occ = 0;
  const size_t smem = SetupSmem<T, PC>::bytes(a.C, SHARED);
  unsigned grid;
  cudaError_t err = grid_for(kernel, smem, SETUP_PER_SM, a, granted, occ_smem,
                             occ, grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, BLOCK, smem, stream>>>(
      static_cast<const T*>(a.V), static_cast<const T*>(a.g_pt),
      static_cast<const T*>(a.W), static_cast<const int*>(a.cam_idx),
      static_cast<const T*>(a.lam), (T)a.eps, static_cast<T*>(a.V_inv_out),
      static_cast<T*>(a.dc), a.C, a.tab);
  return cudaGetLastError();
}

template <typename T, int PC, bool SHARED>
static cudaError_t launch_backsub(const Args& a, cudaStream_t stream) {
  auto kernel = schur_backsub_kernel<T, PC, SHARED>;
  static size_t granted = 48 * 1024, occ_smem = ~(size_t)0;
  static int occ = 0;
  const size_t smem = BacksubSmem<T, PC>::bytes(a.C, SHARED);
  unsigned grid;
  cudaError_t err = grid_for(kernel, smem, BACKSUB_PER_SM, a, granted,
                             occ_smem, occ, grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, BLOCK, smem, stream>>>(
      static_cast<const T*>(a.W), static_cast<const int*>(a.cam_idx),
      static_cast<const T*>(a.V_inv), static_cast<const T*>(a.g_pt),
      static_cast<const T*>(a.d_cam), static_cast<T*>(a.d_pt), a.C, a.tab);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_typed(bool backsub, int pc, bool shared,
                                const Args& a, cudaStream_t s) {
  switch (pc) {
#define CASE(N)                                                          \
  case N:                                                                \
    if (backsub)                                                         \
      return shared ? launch_backsub<T, N, true>(a, s)                   \
                    : launch_backsub<T, N, false>(a, s);                 \
    return shared ? launch_setup<T, N, true>(a, s)                       \
                  : launch_setup<T, N, false>(a, s);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
  }
  return cudaErrorInvalidValue;
}

// The bucket table and the device's SM count into `a`; cudaSuccess, or an
// error code for arguments out of range.
static cudaError_t fill_table(Args& a, int nb, const long long* row_start,
                              const long long* rows, const long long* pt_start,
                              const long long* log_l,
                              const long long* item_off) {
  if (nb < 1 || nb > MAX_BUCKETS || item_off[nb] > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  a.tab.n = nb;
  for (int i = 0; i < nb; ++i) {
    if (log_l[i] < 1 || log_l[i] > 30) return cudaErrorInvalidValue;
    a.tab.row_start[i] = row_start[i];
    a.tab.rows[i] = rows[i];
    a.tab.pt_start[i] = pt_start[i];
    a.tab.log_l[i] = (int)log_l[i];
    a.tab.item_off[i] = (int)item_off[i];
  }
  a.tab.item_off[nb] = (int)item_off[nb];
  static int sms[MAX_DEVICES] = {};
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  a.sms = sms[dev];
  return cudaSuccess;
}

extern "C" {

// Set-up.  dtype: 0 = float32, 1 = float64.  PC in 1..8.  shared: sum
// cameras in a shared-memory table (schur_setup.py::shared_table).
// V [T, 3, 3], g_pt [T, 3], W [O', PC, 3] (16-byte aligned), cam_idx [O']
// int32, lam a device scalar, all in dtype but cam_idx; eps on the host.
// Writes V_inv [T, 3, 3] (every slot the buckets cover) and dc
// [C, PC*PC + PC] (zeroed here first).  The bucket arrays are host arrays
// of nb entries (item_off: nb + 1) from solve/schur_wchain.py::launch_table.
// Returns a cudaError_t code.
int schur_setup_launch(int dtype, int pc, int shared, const void* V,
                       const void* g_pt, const void* W, const void* cam_idx,
                       const void* lam, double eps, void* V_inv, void* dc,
                       int num_cams, int nb, const long long* row_start,
                       const long long* rows, const long long* pt_start,
                       const long long* log_l, const long long* item_off,
                       void* stream) {
  if (dtype < 0 || dtype > 1 || pc < 1 || pc > 8 || num_cams < 1)
    return (int)cudaErrorInvalidValue;
  const size_t esize = dtype == 0 ? 4 : 8;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      dc, 0, (size_t)num_cams * (size_t)(pc * pc + pc) * esize, s);
  if (err != cudaSuccess) return (int)err;
  Args a = {};
  a.V = V;
  a.g_pt = g_pt;
  a.W = W;
  a.cam_idx = cam_idx;
  a.lam = lam;
  a.eps = eps;
  a.V_inv_out = V_inv;
  a.dc = dc;
  a.C = num_cams;
  err = fill_table(a, nb, row_start, rows, pt_start, log_l, item_off);
  if (err != cudaSuccess) return (int)err;
  if (a.tab.item_off[nb] == 0) return (int)cudaSuccess;
  err = dtype == 0 ? launch_typed<float>(false, pc, shared != 0, a, s)
                   : launch_typed<double>(false, pc, shared != 0, a, s);
  return (int)err;
}

// Back-substitution.  shared: d_cam copied into shared memory
// (schur_setup.py::backsub_shared).  W and cam_idx as the set-up's; V_inv
// [T, 3, 3], g_pt [T, 3], d_cam [C, PC].  Writes d_pt [T, 3] (every slot
// the buckets cover).  Returns a cudaError_t code.
int schur_backsub_launch(int dtype, int pc, int shared, const void* W,
                         const void* cam_idx, const void* V_inv,
                         const void* g_pt, const void* d_cam, void* d_pt,
                         int num_cams, int nb, const long long* row_start,
                         const long long* rows, const long long* pt_start,
                         const long long* log_l, const long long* item_off,
                         void* stream) {
  if (dtype < 0 || dtype > 1 || pc < 1 || pc > 8 || num_cams < 1)
    return (int)cudaErrorInvalidValue;
  Args a = {};
  a.W = W;
  a.cam_idx = cam_idx;
  a.V_inv = V_inv;
  a.g_pt = g_pt;
  a.d_cam = d_cam;
  a.d_pt = d_pt;
  a.C = num_cams;
  cudaError_t err = fill_table(a, nb, row_start, rows, pt_start, log_l, item_off);
  if (err != cudaSuccess) return (int)err;
  if (a.tab.item_off[nb] == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = dtype == 0 ? launch_typed<float>(true, pc, shared != 0, a, s)
                   : launch_typed<double>(true, pc, shared != 0, a, s);
  return (int)err;
}

const char* schur_setup_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
