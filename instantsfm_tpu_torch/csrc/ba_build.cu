// Bundle adjustment's system build in one pass over the rows, Hopper.
//
// A port kernel with no TPU counterpart: the JAX package builds this
// system with jax.jacfwd in XLA.  For the bucketed track layout
// (instantsfm_tpu_torch/solve/blocked.py: a track's rows are one aligned
// group of L = 2**k rows) and a reprojection residual in closed form
// (instantsfm_tpu_torch/solve/ba_closed.py, whose plain torch version holds
// the same formulas), each row o of camera c and point slot p computes
//
//     xyz = M(q_c) X_p + t_c,   (u, v) = xyz[:2] / (z + EPS)
//     r   = K_c(distort(u, v)) - (x_o, y_o),   s = |r|^2
//     w   = rho'(s), loss_o = rho(s)   (Huber's; both 0 on an invalid row)
//     Jc  = sqrt(w) d r / d(w, dt, intrinsics)  [2, PC]
//     Jp  = sqrt(w) d r / d X                   [2, 3],  r <- sqrt(w) r
//
// and writes W_o = Jcᵀ Jp [PC, 3] and loss_o, while it sums
//
//     V[p] = SUM_track Jpᵀ Jp,  g_pt[p] = -SUM_track Jpᵀ r   (over the group)
//     U[c] = SUM_cam Jcᵀ Jc,    g_cam[c] = -SUM_cam Jcᵀ r    (over the camera)
//
// into Ug [C, PC*PC + PC] (U row-major, then g_cam), V [T, 3, 3] and
// g_pt [T, 3].  Jc and Jp never leave registers.
//
// Bound: bytes.  A launch reads a row's cam_idx, x, y and valid (13 B in
// float32), each point slot once and the cameras from cache, and writes
// W (3 PC entries) and the loss a row, V and g_pt a slot and Ug once: at
// the benchmark's BA cell (1,199,616 rows, 200 cameras, PC = 8, float32)
// about 137 MB, 41 us at 3.35 TB/s (chip_smoke.py::build_bound counts each
// shape).  A row is some 300 flops, far below the tensor cores' use.
//
//   * Work items are K1's (solve/schur_wchain.py::launch_table): BLOCK rows
//     of whole groups where L <= BLOCK, one group where L > BLOCK, walked by
//     persistent blocks (at most MAX_PER_SM an SM) by stride.  A row's point
//     slot is pt_start_b + (o - os_b) / L; pt_idx is not read.
//   * A pass of BLOCK rows stages its W rows in shared memory (an odd row
//     stride: a thread's row falls on its own banks), then the block writes
//     them out, contiguous in W, with neighbouring threads on neighbouring
//     addresses: each thread writing its own 12 PC-byte row straight to
//     device memory makes a sector of every 4-byte store.
//   * Cameras: where the shared tables fit (below), each block first
//     expands every camera into M(q), t and its parameters in a shared
//     table, camera minor; past it, each row reads its camera through L1
//     and forms M(q) itself.
//   * Point sums (6 entries of V and 3 of g_pt): a warp XOR butterfly for
//     L <= 32, warp sums through shared memory above; one write a slot, no
//     atomics.  Every slot the buckets cover is written (the wrapper checks
//     that they cover [0, T)).
//   * Camera sums: where this table and the cameras' fit together in K1's
//     96 KB (ba_closed.py::shared_table) each block keeps the upper
//     triangle of U and g_cam,
//     PC (PC + 1) / 2 + PC entries a camera packed into 16-byte words,
//     camera minor, and adds a row to it with one 128-bit shared
//     compare-and-swap a word, as K1 does; at the end it adds its table to
//     Ug, U mirrored, with one global atomic per nonzero entry (four float32
//     entries at a time).  Where it does not, each row adds U and g_cam to
//     Ug with global atomics.  Rows of zero weight add nothing.  Ug is
//     zeroed by a memset before the kernel; its sums change order from run
//     to run, as index_add_'s do on the card.
//
// Loss mode (ba_loss_kernel): one thread a row, the same residual and rho,
// loss_o alone; it reads pt_idx and needs no layout.
//
// Interface: plain C, loaded with ctypes (instantsfm_tpu_torch/utils/build.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#define BLOCK 256       // threads a block (solve/ba_closed.py BLOCK)
#define NWARP (BLOCK / 32)
#define MAX_BUCKETS 32  // solve/schur_wchain.py MAX_BUCKETS
#define MAX_PER_SM 2    // resident blocks an SM, at most
#define MAX_DEVICES 64
#define FULL_MASK 0xffffffffu
#define NPT 9           // point sums a row: V's upper triangle, then g_pt

// camera models (scene/cameras.py): the two the port's databases hold
#define SIMPLE_PINHOLE 0
#define SIMPLE_RADIAL 2

struct BucketTable {
  int n;
  int item_off[MAX_BUCKETS + 1];
  int log_l[MAX_BUCKETS];
  long long row_start[MAX_BUCKETS];
  long long rows[MAX_BUCKETS];
  long long pt_start[MAX_BUCKETS];
};

template <int MODEL>
struct Model {
  // optimised intrinsics (scene/cameras.py CAMERA_MODEL_INFO "optimize"):
  // f, and SIMPLE_RADIAL's k
  static constexpr int NI = MODEL == SIMPLE_PINHOLE ? 1 : 2;
};

template <typename T, int MODEL, bool POSES>
struct Dims {
  static constexpr int NI = Model<MODEL>::NI;
  static constexpr int PC = (POSES ? 6 : 0) + NI;
  static constexpr int NU = PC * (PC + 1) / 2;  // U's upper triangle
  static constexpr int NCAM = NU + PC;          // with g_cam
  static constexpr int PER = 16 / (int)sizeof(T);
  static constexpr int SLOTS = (NCAM + PER - 1) / PER;  // 16-byte words a camera
  static constexpr int OUT = PC * PC + PC;      // Ug's entries a camera
};

// Huber's rho(s) and rho'(s) as solve/robust.py::huber computes them, a
// NaN included: a NaN residual gives a NaN loss, which the LM's accept test
// rejects (torch's clamp_min keeps a NaN; a max that dropped it would turn
// it into a finite loss, and a step with NaN parameters could then be
// accepted)
template <typename T>
__device__ __forceinline__ void huber(double delta, T s, T& w, T& loss) {
  const T d2 = (T)(delta * delta);
  if (s <= d2) {
    w = T(1);
    loss = s;
  } else {
    const T sq = sqrt(s < T(1e-30) ? T(1e-30) : s);
    w = (T)delta / sq;
    loss = (T)(2.0 * delta) * sq - d2;
  }
}

template <typename T>
struct Cams {
  const T* __restrict__ q;
  const T* __restrict__ t;
  const T* __restrict__ intr;
  int stride;  // intr's row length
};

// A camera as a row reads it: M(q), t and the model's parameters
template <typename T, int MODEL>
struct Cam {
  static constexpr int NPAR = MODEL == SIMPLE_PINHOLE ? 3 : 4;
  static constexpr int N = 12 + NPAR;  // entries a camera in the shared table
  T M[3][3], t[3], in[NPAR];
};

// Camera cam from device memory: M(q) is the linear map of
// lie.quat_rotate, v + 2 w (u x v) + 2 u x (u x v)
template <typename T, int MODEL>
__device__ __forceinline__ void load_cam(const Cams<T>& cams, int cam,
                                         Cam<T, MODEL>& c) {
  const T* q = cams.q + 4LL * cam;
  const T qx = __ldg(q), qy = __ldg(q + 1), qz = __ldg(q + 2), qw = __ldg(q + 3);
  const T xx = qx * qx, yy = qy * qy, zz = qz * qz;
  const T xy = qx * qy, xz = qx * qz, yz = qy * qz;
  const T wx = qw * qx, wy = qw * qy, wz = qw * qz;
  c.M[0][0] = T(1) - T(2) * (yy + zz);
  c.M[0][1] = T(2) * (xy - wz);
  c.M[0][2] = T(2) * (xz + wy);
  c.M[1][0] = T(2) * (xy + wz);
  c.M[1][1] = T(1) - T(2) * (xx + zz);
  c.M[1][2] = T(2) * (yz - wx);
  c.M[2][0] = T(2) * (xz - wy);
  c.M[2][1] = T(2) * (yz + wx);
  c.M[2][2] = T(1) - T(2) * (xx + yy);
#pragma unroll
  for (int i = 0; i < 3; ++i) c.t[i] = __ldg(cams.t + 3LL * cam + i);
#pragma unroll
  for (int i = 0; i < Cam<T, MODEL>::NPAR; ++i)
    c.in[i] = __ldg(cams.intr + (long long)cams.stride * cam + i);
}

// The shared camera table, [N, C] (camera minor, so a warp's cameras
// spread over the banks): entry i of camera cam at tab[i * C + cam]
template <typename T, int MODEL>
__device__ __forceinline__ void store_cam(T* tab, int C, int cam,
                                          const Cam<T, MODEL>& c) {
#pragma unroll
  for (int i = 0; i < 9; ++i) tab[i * C + cam] = c.M[i / 3][i % 3];
#pragma unroll
  for (int i = 0; i < 3; ++i) tab[(9 + i) * C + cam] = c.t[i];
#pragma unroll
  for (int i = 0; i < Cam<T, MODEL>::NPAR; ++i) tab[(12 + i) * C + cam] = c.in[i];
}

template <typename T, int MODEL>
__device__ __forceinline__ void shared_cam(const T* tab, int C, int cam,
                                           Cam<T, MODEL>& c) {
#pragma unroll
  for (int i = 0; i < 9; ++i) c.M[i / 3][i % 3] = tab[i * C + cam];
#pragma unroll
  for (int i = 0; i < 3; ++i) c.t[i] = tab[(9 + i) * C + cam];
#pragma unroll
  for (int i = 0; i < Cam<T, MODEL>::NPAR; ++i) c.in[i] = tab[(12 + i) * C + cam];
}

// The residual of one row and, with JAC, its Jacobians (unwhitened):
// Jc [2][PC] in the order (rotation tangent, translation, intrinsics),
// Jp [2][3].
template <typename T, int MODEL, bool POSES, bool JAC>
__device__ __forceinline__ void residual(const Cam<T, MODEL>& c, T X0, T X1,
                                         T X2, T ox, T oy, T (&r)[2],
                                         T (&Jc)[2][Dims<T, MODEL, POSES>::PC],
                                         T (&Jp)[2][3]) {
  constexpr int NI = Model<MODEL>::NI;
  const auto& M = c.M;
  T P[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    P[i] = M[i][0] * X0 + M[i][1] * X1 + M[i][2] * X2 + c.t[i];
  const T zi = T(1) / (P[2] + T(1e-10));  // scene/cameras.py _EPS
  const T u = P[0] * zi, v = P[1] * zi;

  const T* in = c.in;
  T Jd[2][2], Ji[2][NI];
  if constexpr (MODEL == SIMPLE_RADIAL) {
    const T f = in[0], cx = in[1], cy = in[2], k = in[3];
    const T r2 = u * u + v * v;
    const T radial = k * r2;
    const T ud = u + u * radial, vd = v + v * radial;
    r[0] = ud * f + cx - ox;
    r[1] = vd * f + cy - oy;
    if constexpr (JAC) {
      const T a = T(1) + radial, b = T(2) * k;  // b: 2 d radial / d r2
      Jd[0][0] = (a + b * u * u) * f;
      Jd[0][1] = (b * u * v) * f;
      Jd[1][0] = (b * u * v) * f;
      Jd[1][1] = (a + b * v * v) * f;
      Ji[0][0] = ud;
      Ji[1][0] = vd;
      Ji[0][1] = f * u * r2;
      Ji[1][1] = f * v * r2;
    }
  } else {  // SIMPLE_PINHOLE
    const T f = in[0];
    r[0] = u * f + in[1] - ox;
    r[1] = v * f + in[2] - oy;
    if constexpr (JAC) {
      Jd[0][0] = f;
      Jd[0][1] = T(0);
      Jd[1][0] = T(0);
      Jd[1][1] = f;
      Ji[0][0] = u;
      Ji[1][0] = v;
    }
  }
  if constexpr (JAC) {
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      // d proj_a / d xyz = Jd[a] d(u, v) / d xyz
      const T j0 = Jd[a][0] * zi, j1 = Jd[a][1] * zi;
      const T j2 = -(Jd[a][0] * u + Jd[a][1] * v) * zi;
#pragma unroll
      for (int k = 0; k < 3; ++k) Jp[a][k] = j0 * M[0][k] + j1 * M[1][k] + j2 * M[2][k];
      int c = 0;
      if constexpr (POSES) {
        // d/dw of w x xyz is -[xyz]x: row a of it is xyz x Jx[a]
        Jc[a][0] = P[1] * j2 - P[2] * j1;
        Jc[a][1] = P[2] * j0 - P[0] * j2;
        Jc[a][2] = P[0] * j1 - P[1] * j0;
        Jc[a][3] = j0;
        Jc[a][4] = j1;
        Jc[a][5] = j2;
        c = 6;
      }
#pragma unroll
      for (int i = 0; i < NI; ++i) Jc[a][c + i] = Ji[a][i];
    }
  }
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

// index of U's entry (a, b), a <= b, in the packed upper triangle
__host__ __device__ constexpr int tri(int a, int b, int PC) {
  return a * PC - a * (a - 1) / 2 + (b - a);
}

// camera entry i of Ug's row (U row-major, then g_cam) in the packed order
template <int PC>
__device__ __forceinline__ int packed(int i) {
  if (i >= PC * PC) return PC * (PC + 1) / 2 + (i - PC * PC);
  const int a = i / PC, b = i - a * PC;
  return a <= b ? tri(a, b, PC) : tri(b, a, PC);
}

template <typename T>
__device__ __forceinline__ void butterfly(T (&v)[NPT], int max_off) {
  for (int m = 1; m < max_off; m <<= 1)
#pragma unroll
    for (int i = 0; i < NPT; ++i) v[i] += __shfl_xor_sync(FULL_MASK, v[i], m);
}

template <typename T>
__device__ __forceinline__ void write_point(T* __restrict__ V,
                                            T* __restrict__ g_pt, long long p,
                                            const T (&s)[NPT]) {
  // s: V00 V01 V02 V11 V12 V22, then g_pt
  T* v = V + 9 * p;
  v[0] = s[0];
  v[1] = s[1];
  v[2] = s[2];
  v[3] = s[1];
  v[4] = s[3];
  v[5] = s[4];
  v[6] = s[2];
  v[7] = s[4];
  v[8] = s[5];
  g_pt[3 * p] = s[6];
  g_pt[3 * p + 1] = s[7];
  g_pt[3 * p + 2] = s[8];
}

// Shared memory of a block, in bytes: with the shared tables only, the
// camera-sum table ([SLOTS, C] 16-byte words) and the camera table
// ([N, C]); the staging of a pass's W rows (BLOCK rows of an odd stride,
// so a thread's row lands on its own banks); the warp sums.
template <typename T, int MODEL, bool POSES>
struct Smem {
  using D = Dims<T, MODEL, POSES>;
  static constexpr int WROW = 3 * D::PC;
  static constexpr int STRIDE = WROW | 1;
  static constexpr int STAGE = (BLOCK * STRIDE * (int)sizeof(T) + 15) & ~15;
  static constexpr int RED = NWARP * NPT * (int)sizeof(T);
  __host__ __device__ static int acc(int C, bool shared) {
    return shared ? C * D::SLOTS * 16 : 0;
  }
  __host__ __device__ static int cams(int C, bool shared) {
    return shared ? ((C * Cam<T, MODEL>::N * (int)sizeof(T) + 15) & ~15) : 0;
  }
  __host__ __device__ static size_t bytes(int C, bool shared) {
    return (size_t)acc(C, shared) + cams(C, shared) + STAGE + RED;
  }
};

template <typename T, int MODEL, bool POSES, bool SHARED>
__global__ void __launch_bounds__(BLOCK)
ba_build_kernel(const Cams<T> cams, const T* __restrict__ pts,
                const T* __restrict__ ox, const T* __restrict__ oy,
                const unsigned char* __restrict__ valid,
                const int* __restrict__ cam_idx, T* __restrict__ W,
                T* __restrict__ loss, T* __restrict__ Ug, T* __restrict__ V,
                T* __restrict__ g_pt, int C, const double delta,
                const BucketTable tab) {
  using D = Dims<T, MODEL, POSES>;
  using SM = Smem<T, MODEL, POSES>;
  constexpr int PC = D::PC;
  extern __shared__ __align__(16) unsigned char smem[];
  auto* acc = reinterpret_cast<unsigned long long*>(smem);  // [SLOTS, C, 2]
  T* ctab = reinterpret_cast<T*>(smem + SM::acc(C, SHARED));  // [N, C]
  T* stage = reinterpret_cast<T*>(smem + SM::acc(C, SHARED) +
                                  SM::cams(C, SHARED));  // [BLOCK, STRIDE]
  T* red = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(stage) +
                                SM::STAGE);  // [NWARP, NPT]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nitems = tab.item_off[tab.n];

  if constexpr (SHARED) {
    for (int i = tid; i < 2 * D::SLOTS * C; i += BLOCK) acc[i] = 0ull;
    for (int cam = tid; cam < C; cam += BLOCK) {
      Cam<T, MODEL> c;
      load_cam(cams, cam, c);
      store_cam(ctab, C, cam, c);
    }
    __syncthreads();
  }

  for (int item = blockIdx.x; item < nitems; item += gridDim.x) {
    int b = 0;
    while (b + 1 < tab.n && item >= tab.item_off[b + 1]) ++b;
    const long long li = item - tab.item_off[b];
    const int log_l = tab.log_l[b];
    const long long L = 1LL << log_l;
    long long row0, p0;
    int n;
    if (L <= BLOCK) {
      const long long left = tab.rows[b] - li * BLOCK;
      row0 = tab.row_start[b] + li * BLOCK;
      n = (int)(left < BLOCK ? left : BLOCK);
      p0 = tab.pt_start[b] + ((li * BLOCK) >> log_l);
    } else {
      row0 = tab.row_start[b] + li * L;
      n = (int)L;
      p0 = tab.pt_start[b] + li;
    }

    T ps[NPT] = {};  // this thread's rows' point sums
    // passes of BLOCK rows: one where L <= BLOCK, L / BLOCK of one group
    for (int base = 0; base < n; base += BLOCK) {
      const int m = n - base < BLOCK ? n - base : BLOCK;
      T* wo = stage + tid * SM::STRIDE;  // this thread's row of W
      if (tid < m) {
        const long long o = row0 + base + tid;
        const long long p = L <= BLOCK ? p0 + (tid >> log_l) : p0;
        T r[2], Jc[2][PC], Jp[2][3];
        T w = T(0), lo = T(0);
        int cam = 0;
        if (__ldg(valid + o)) {
          cam = __ldg(cam_idx + o);
          Cam<T, MODEL> c;
          if constexpr (SHARED)
            shared_cam(ctab, C, cam, c);
          else
            load_cam(cams, cam, c);
          residual<T, MODEL, POSES, true>(
              c, __ldg(pts + 3 * p), __ldg(pts + 3 * p + 1),
              __ldg(pts + 3 * p + 2), __ldg(ox + o), __ldg(oy + o), r, Jc, Jp);
          huber(delta, r[0] * r[0] + r[1] * r[1], w, lo);
        }
        loss[o] = lo;
        if (w == T(0)) {
#pragma unroll
          for (int i = 0; i < SM::WROW; ++i) wo[i] = T(0);
        } else {
          const T sw = sqrt(w);
#pragma unroll
          for (int a = 0; a < 2; ++a) {
            r[a] *= sw;
#pragma unroll
            for (int c = 0; c < PC; ++c) Jc[a][c] *= sw;
#pragma unroll
            for (int j = 0; j < 3; ++j) Jp[a][j] *= sw;
          }
#pragma unroll
          for (int c = 0; c < PC; ++c)
#pragma unroll
            for (int j = 0; j < 3; ++j)
              wo[3 * c + j] = Jc[0][c] * Jp[0][j] + Jc[1][c] * Jp[1][j];
          ps[0] += Jp[0][0] * Jp[0][0] + Jp[1][0] * Jp[1][0];
          ps[1] += Jp[0][0] * Jp[0][1] + Jp[1][0] * Jp[1][1];
          ps[2] += Jp[0][0] * Jp[0][2] + Jp[1][0] * Jp[1][2];
          ps[3] += Jp[0][1] * Jp[0][1] + Jp[1][1] * Jp[1][1];
          ps[4] += Jp[0][1] * Jp[0][2] + Jp[1][1] * Jp[1][2];
          ps[5] += Jp[0][2] * Jp[0][2] + Jp[1][2] * Jp[1][2];
#pragma unroll
          for (int j = 0; j < 3; ++j)
            ps[6 + j] -= Jp[0][j] * r[0] + Jp[1][j] * r[1];

          // the camera's entries: U's upper triangle, then g_cam
          T e[D::SLOTS * D::PER];
#pragma unroll
          for (int a = 0; a < PC; ++a)
#pragma unroll
            for (int c = a; c < PC; ++c)
              e[tri(a, c, PC)] = Jc[0][a] * Jc[0][c] + Jc[1][a] * Jc[1][c];
#pragma unroll
          for (int c = 0; c < PC; ++c)
            e[D::NU + c] = -(Jc[0][c] * r[0] + Jc[1][c] * r[1]);
#pragma unroll
          for (int i = D::NCAM; i < D::SLOTS * D::PER; ++i) e[i] = T(0);
          if constexpr (SHARED) {
            shared_add<T, D::SLOTS>(acc, C, cam, e);
          } else {
            T* y = Ug + (long long)cam * D::OUT;
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
      __syncthreads();
      // the pass's W rows are contiguous in W: written out coalesced
      T* wd = W + (row0 + base) * SM::WROW;
      for (int i = tid; i < m * SM::WROW; i += BLOCK) {
        const int row = i / SM::WROW;
        wd[i] = stage[row * SM::STRIDE + i - row * SM::WROW];
      }
      __syncthreads();  // the stage is free for the next pass
    }

    // the point sums of each group; every lane takes part in the shuffles
    if (L <= 32) {
      butterfly(ps, (int)L);
      if ((tid & (L - 1)) == 0 && tid < n)
        write_point(V, g_pt, p0 + (tid >> log_l), ps);
    } else {
      butterfly(ps, 32);
      if (lane == 0)
#pragma unroll
        for (int i = 0; i < NPT; ++i) red[NPT * warp + i] = ps[i];
      __syncthreads();
      const int wpg = L <= BLOCK ? (int)(L >> 5) : NWARP;  // warps a group
      if (L <= BLOCK ? (tid & (L - 1)) == 0 && tid < n : tid == 0) {
        T sum[NPT] = {};
        for (int k = 0; k < wpg; ++k)
#pragma unroll
          for (int i = 0; i < NPT; ++i) sum[i] += red[NPT * (warp + k) + i];
        write_point(V, g_pt, L <= BLOCK ? p0 + (tid >> log_l) : p0, sum);
      }
      __syncthreads();  // red is free for the next item
    }
  }

  if constexpr (SHARED) {
    // the loop's last barrier ordered every shared atomic before this; the
    // table goes to Ug, U mirrored, one atomic per nonzero entry, four
    // float32 entries (16 bytes) at a time
    const T* sums = reinterpret_cast<const T*>(acc);
    auto entry = [&](int i) {  // Ug's flat entry i = cam * OUT + j
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
            atomicAdd(reinterpret_cast<float4*>(Ug + i), v);
        } else {
          for (int k = i; k < n; ++k) {
            const float v = entry(k);
            if (v != 0.f) atomicAdd(Ug + k, v);
          }
        }
      }
    } else {
      for (int i = tid; i < n; i += BLOCK) {
        const T v = entry(i);
        if (v != T(0)) atomicAdd(Ug + i, v);
      }
    }
  }
}

template <typename T, int MODEL>
__global__ void __launch_bounds__(BLOCK)
ba_loss_kernel(const Cams<T> cams, const T* __restrict__ pts,
               const T* __restrict__ ox, const T* __restrict__ oy,
               const unsigned char* __restrict__ valid,
               const int* __restrict__ cam_idx, const int* __restrict__ pt_idx,
               T* __restrict__ loss, long long num_rows, const double delta) {
  const long long o = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (o >= num_rows) return;
  T lo = T(0);
  if (__ldg(valid + o)) {
    T r[2], Jc[2][Dims<T, MODEL, false>::PC], Jp[2][3];
    Cam<T, MODEL> c;
    load_cam(cams, __ldg(cam_idx + o), c);
    const long long p = __ldg(pt_idx + o);
    residual<T, MODEL, false, false>(c, __ldg(pts + 3 * p),
                                     __ldg(pts + 3 * p + 1),
                                     __ldg(pts + 3 * p + 2), __ldg(ox + o),
                                     __ldg(oy + o), r, Jc, Jp);
    T w;
    huber(delta, r[0] * r[0] + r[1] * r[1], w, lo);
  }
  loss[o] = lo;
}

struct BuildArgs {
  const void *q, *t, *intr, *pts, *x, *y, *valid, *cam_idx;
  void *W, *loss, *Ug, *V, *g_pt;
  int stride, C, sms;
  double delta;
  BucketTable tab;
};

template <typename T, int MODEL, bool POSES, bool SHARED>
static cudaError_t launch_build(const BuildArgs& a, cudaStream_t stream) {
  auto kernel = ba_build_kernel<T, MODEL, POSES, SHARED>;
  const size_t smem = Smem<T, MODEL, POSES>::bytes(a.C, SHARED);
  // per instantiation, for the process's device: the shared memory opted
  // in so far, and the blocks an SM at the last size asked
  static size_t smem_granted = 48 * 1024, occ_smem = 0;
  static int occ = 0;
  cudaError_t err;
  if (smem > smem_granted) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    smem_granted = smem;
  }
  if (smem != occ_smem) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, BLOCK, smem);
    if (err != cudaSuccess) return err;
    occ_smem = smem;
  }
  if (occ < 1) return cudaErrorInvalidConfiguration;
  const int per_sm = MAX_PER_SM < occ ? MAX_PER_SM : occ;
  const long long nitems = a.tab.item_off[a.tab.n];
  const long long cap = (long long)per_sm * a.sms;
  const unsigned grid = (unsigned)(nitems < cap ? nitems : cap);
  Cams<T> cams{static_cast<const T*>(a.q), static_cast<const T*>(a.t),
               static_cast<const T*>(a.intr), a.stride};
  kernel<<<grid, BLOCK, smem, stream>>>(
      cams, static_cast<const T*>(a.pts), static_cast<const T*>(a.x),
      static_cast<const T*>(a.y), static_cast<const unsigned char*>(a.valid),
      static_cast<const int*>(a.cam_idx), static_cast<T*>(a.W),
      static_cast<T*>(a.loss), static_cast<T*>(a.Ug), static_cast<T*>(a.V),
      static_cast<T*>(a.g_pt), a.C, a.delta, a.tab);
  return cudaGetLastError();
}

template <typename T, int MODEL>
static cudaError_t build_model(bool poses, bool shared, const BuildArgs& a,
                               cudaStream_t s) {
  if (poses)
    return shared ? launch_build<T, MODEL, true, true>(a, s)
                  : launch_build<T, MODEL, true, false>(a, s);
  return shared ? launch_build<T, MODEL, false, true>(a, s)
                : launch_build<T, MODEL, false, false>(a, s);
}

template <typename T>
static cudaError_t build_typed(int model, bool poses, bool shared,
                               const BuildArgs& a, cudaStream_t s) {
  switch (model) {
    case SIMPLE_PINHOLE: return build_model<T, SIMPLE_PINHOLE>(poses, shared, a, s);
    case SIMPLE_RADIAL: return build_model<T, SIMPLE_RADIAL>(poses, shared, a, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
static cudaError_t loss_typed(int model, const Cams<T>& cams, const void* pts,
                              const void* x, const void* y, const void* valid,
                              const void* cam_idx, const void* pt_idx,
                              void* loss, long long O, double delta,
                              cudaStream_t s) {
  const unsigned grid = (unsigned)((O + BLOCK - 1) / BLOCK);
  const T* P = static_cast<const T*>(pts);
  const T* X = static_cast<const T*>(x);
  const T* Y = static_cast<const T*>(y);
  const unsigned char* vv = static_cast<const unsigned char*>(valid);
  const int* ci = static_cast<const int*>(cam_idx);
  const int* pi = static_cast<const int*>(pt_idx);
  T* l = static_cast<T*>(loss);
  switch (model) {
#define CASE(M)                                                               \
  case M:                                                                     \
    ba_loss_kernel<T, M><<<grid, BLOCK, 0, s>>>(cams, P, X, Y, vv, ci, pi, l, \
                                                O, delta);                    \
    break;
    CASE(SIMPLE_PINHOLE) CASE(SIMPLE_RADIAL)
#undef CASE
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

static bool bad_codes(int dtype, int model) {
  return dtype < 0 || dtype > 1 ||
         (model != SIMPLE_PINHOLE && model != SIMPLE_RADIAL);
}

extern "C" {

// dtype: 0 = float32, 1 = float64.  model: SIMPLE_PINHOLE or
// SIMPLE_RADIAL; poses: the 6 pose entries lead the camera block.  shared:
// sum cameras in a shared-memory table (ba_closed.py::shared_table).
// delta: Huber's.  q [C, 4], t [C, 3], intr [C, stride], pts [T, 3],
// x, y [O'] in dtype; valid [O'] bytes; cam_idx [O'] int32.  Writes
// W [O', PC, 3], loss [O'], Ug [C, PC*PC + PC] (zeroed here first),
// V [T, 3, 3], g_pt [T, 3].  The bucket arrays are host arrays of nb
// entries (item_off: nb + 1) from solve/schur_wchain.py::launch_table.
// Returns a cudaError_t code.
int ba_build_launch(int dtype, int model, int poses, int shared, double delta,
                    const void* q, const void* t, const void* intr, int stride,
                    const void* pts, const void* x, const void* y,
                    const void* valid, const void* cam_idx, void* W,
                    void* loss, void* Ug, void* V, void* g_pt, int num_cams,
                    int nb,
                    const long long* row_start, const long long* rows,
                    const long long* pt_start, const long long* log_l,
                    const long long* item_off, void* stream) {
  if (bad_codes(dtype, model) || nb < 1 || nb > MAX_BUCKETS ||
      num_cams < 1 || item_off[nb] > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int pc = (poses ? 6 : 0) + (model == SIMPLE_PINHOLE ? 1 : 2);
  const size_t esize = dtype == 0 ? 4 : 8;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      Ug, 0, (size_t)num_cams * (size_t)(pc * pc + pc) * esize, s);
  if (err != cudaSuccess) return (int)err;

  BuildArgs a;
  a.q = q;
  a.t = t;
  a.intr = intr;
  a.pts = pts;
  a.x = x;
  a.y = y;
  a.valid = valid;
  a.cam_idx = cam_idx;
  a.W = W;
  a.loss = loss;
  a.Ug = Ug;
  a.V = V;
  a.g_pt = g_pt;
  a.stride = stride;
  a.C = num_cams;
  a.delta = delta;
  a.tab.n = nb;
  for (int i = 0; i < nb; ++i) {
    if (log_l[i] < 1 || log_l[i] > 30) return (int)cudaErrorInvalidValue;
    a.tab.row_start[i] = row_start[i];
    a.tab.rows[i] = rows[i];
    a.tab.pt_start[i] = pt_start[i];
    a.tab.log_l[i] = (int)log_l[i];
    a.tab.item_off[i] = (int)item_off[i];
  }
  a.tab.item_off[nb] = (int)item_off[nb];
  if (a.tab.item_off[nb] == 0) return (int)cudaSuccess;
  static int sms[MAX_DEVICES] = {};
  int dev;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  a.sms = sms[dev];
  err = dtype == 0 ? build_typed<float>(model, poses != 0, shared != 0, a, s)
                   : build_typed<double>(model, poses != 0, shared != 0, a, s);
  return (int)err;
}

// The loss mode: loss [O'] of the rows (pt_idx [O'] int32 names each row's
// point slot); the other arguments as ba_build_launch's.
int ba_loss_launch(int dtype, int model, double delta, const void* q,
                   const void* t, const void* intr, int stride,
                   const void* pts, const void* x, const void* y,
                   const void* valid, const void* cam_idx, const void* pt_idx,
                   void* loss, long long num_rows, void* stream) {
  if (bad_codes(dtype, model) || num_rows < 0)
    return (int)cudaErrorInvalidValue;
  if (num_rows == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const Cams<float> cams{static_cast<const float*>(q),
                           static_cast<const float*>(t),
                           static_cast<const float*>(intr), stride};
    return (int)loss_typed<float>(model, cams, pts, x, y, valid, cam_idx,
                                  pt_idx, loss, num_rows, delta, s);
  }
  const Cams<double> cams{static_cast<const double*>(q),
                          static_cast<const double*>(t),
                          static_cast<const double*>(intr), stride};
  return (int)loss_typed<double>(model, cams, pts, x, y, valid, cam_idx,
                                 pt_idx, loss, num_rows, delta, s);
}

const char* ba_build_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
