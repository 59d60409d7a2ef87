// Reduced-camera Schur operator, observation side (kernel K1), Hopper.
//
// Replaces instantsfm_tpu/solve/pallas_schur.py::schur_wchain (the Pallas
// TPU kernel _kernel, pallas_schur.py:83-117) together with the camera-side
// sum that the JAX matvec applies to its output (seg_cam,
// instantsfm_tpu/solve/block_lm.py:898-904).  For the bucketed track layout
// (instantsfm_tpu_torch/solve/blocked.py) it computes
//
//     t_o  = W_oᵀ x[cam_idx[o]]              W_o: [PC, 3], x: [C, PC]
//     s_p  = SUM of t over point p's group of L rows   (L = 2**k)
//     z_p  = V_inv[p] s_p                    V_inv: [T, 3, 3]
//     y[c] = SUM over rows o with cam_idx[o] = c of W_o z_p(o)    y: [C, PC]
//
// and the caller forms U_d x - y.  The per-row u_o = W_o z never reaches
// device memory.
//
// Bound: bytes.  A launch must read W, cam_idx, V_inv and x once and write
// y once: at the ETH3D-indoor shape (C = 200, 50,176 point slots, O' =
// 401,408 rows, PC = 8, f32) 38.5 + 1.6 + 1.8 MB + 12.8 KB = 41.96 MB, 12.5
// us at 3.35 TB/s, against about 0.7 us of FP32 arithmetic at 67 TFLOP/s
// (chip_smoke.py::k1_bound counts each shape).  Each row is a 3 x PC and a
// 3 x 3 product: some 5 flops a byte, far below the ~300 a byte at which
// the tensor cores (wgmma, 64-row tiles) would pay, so none are used.  The
// design spends its effort on moving each byte once, in wide copies:
//
//   * Persistent blocks.  (blocks an SM that fit, at most MAX_PER_SM) x
//     (SMs) blocks walk the flat work items of the launch table
//     (solve/schur_wchain.py::launch_table) by stride: BLOCK rows of whole
//     groups where L <= BLOCK, one group where L > BLOCK.  More blocks
//     were slower where they fit (the GP shape): each adds its whole table
//     to the same C * PC entries of y at the end.
//   * Staging.  An item's W rows, cam_idx and V_inv slots are copied into
//     shared memory with 16-byte cp.async, neighbouring threads on
//     neighbouring addresses, into one of NSTAGE = 2 buffers: the next item
//     loads while this one computes.  A span that does not start on 16
//     bytes (cam_idx and V_inv in general, W at PC = 3) is copied from the
//     16-byte boundary below it, with bytes at or past the array's end
//     zero-filled and never read.  Rows of a multiple of 16 bytes (PC = 8)
//     are spread to an odd stride of 16-byte vectors, so each thread reads
//     its row with 16-byte loads free of bank conflicts.
//   * pt_idx is not read: a row's point slot is pt_start_b + (o - os_b) / L.
//   * Track sums keep the first port's three paths: a warp XOR butterfly
//     for L <= 32, warp sums through shared memory for L <= 256, and for
//     L > 256 one item a group, walked twice (t sums, then u).
//   * Camera sums.  Where the table fits (solve/schur_wchain.py::shared_table
//     decides and passes `shared`: the accumulator and x take at most 96 KB,
//     which leaves room for the staging buffers at every PC) the block
//     keeps x ([PC, C]) and an accumulator ([words, C]: four float32 entries
//     or two float64 a 16-byte word) in shared memory, camera minor, so a
//     warp's unrelated cameras spread over the banks.  It adds each row's u
//     to the accumulator with one 128-bit compare-and-swap a word
//     (atom.shared.cas.b128, new in sm_90), the row's words in flight
//     together (atomicAdd on a shared float is itself a compare-and-swap
//     loop, one entry at a time), and at the end its table to y with one
//     global atomic per nonzero entry, 16 bytes at a time in float32.
//     Where it does not (C > 1,536 at PC = 8 in float32) each row adds its
//     u straight to y with global atomics, and x is read through L1.  Rows
//     whose W is exactly zero (the layout's padding, all on camera 0) are
//     skipped: their u is exactly 0.  y is summed with atomics, so the
//     order of its additions changes from run to run.
//   * The launch is programmatic (PDL): the kernel may start while the
//     memset of y before it finishes, and waits for it (griddepcontrol.wait)
//     before its first write to y.
//
// Tried on the card and dropped (PERF.md): three or four staging buffers
// (fewer blocks an SM), x read through L1, staging
// the next item before the atomics rather than before the wait, atomicAdd
// on shared floats, and a 64-bit compare-and-swap a word (3-11% slower
// than 128-bit).  Summing a warp's peers of a camera first
// (__match_any_sync) was not built: with no shared atomics at all the
// kernel was at most 4 us (10%) faster at the ETH3D shape.
//
// Interface: plain C, loaded with ctypes (instantsfm_tpu_torch/utils/build.py).
// schur_wchain_launch zeroes y on the stream (cudaMemsetAsync), launches the
// kernel and returns its error code.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#define BLOCK 256                        // threads per block (solve/schur_wchain.py BLOCK)
#define NWARP (BLOCK / 32)
#define MAX_BUCKETS 32                   // solve/schur_wchain.py MAX_BUCKETS
#define NSTAGE 2                         // staging buffers: NSTAGE - 1 items ahead
#define MAX_PER_SM 3                     // resident blocks an SM, at most
#define MAX_DEVICES 64                   // devices whose SM count is kept
#define FULL_MASK 0xffffffffu

struct BucketTable {
  int n;
  int item_off[MAX_BUCKETS + 1];  // items of bucket b: [item_off[b], item_off[b+1])
  int log_l[MAX_BUCKETS];
  long long row_start[MAX_BUCKETS];
  long long rows[MAX_BUCKETS];
  long long pt_start[MAX_BUCKETS];
};

__host__ __device__ constexpr long long align16(long long b) {
  return (b + 15) & ~15LL;
}

// Shared memory of a block, in bytes: with the shared table only, the
// accumulator (SLOTS 16-byte words a camera, [SLOTS, C]) and x ([PC, C]);
// the warp sums; NSTAGE staging buffers of W rows, cam_idx and V_inv slots
// (vcap points at most).
template <typename T, int PC>
struct Layout {
  static constexpr int PER = 16 / (int)sizeof(T);      // entries a 16-byte word
  static constexpr int SLOTS = (PC + PER - 1) / PER;   // words a camera
  static constexpr int ROWB = PC * 3 * (int)sizeof(T);
  static constexpr bool VEC_ROWS = ROWB % 16 == 0;
  static constexpr int ROWV = ROWB / 16;     // 16-byte vectors a row
  static constexpr int STRIDE = ROWV | 1;    // odd: conflict-free 16 B reads
  static constexpr int WBUF =
      VEC_ROWS ? BLOCK * STRIDE * 16 : (int)align16(BLOCK * ROWB + 15);
  static constexpr int CBUF = (int)align16(BLOCK * 4 + 15);
  static constexpr int RED = (int)align16(NWARP * 3 * sizeof(T));
  __host__ __device__ static int vbuf(int vcap) {
    return (int)align16((long long)vcap * 9 * sizeof(T) + 15);
  }
  __host__ __device__ static int acc_bytes(int C, bool shared) {
    return shared ? (int)align16((long long)C * SLOTS * 16) : 0;
  }
  __host__ __device__ static int x_bytes(int C, bool shared) {
    return shared ? (int)align16((long long)C * PC * sizeof(T)) : 0;
  }
  __host__ __device__ static int buffer(int vcap) {
    return WBUF + CBUF + vbuf(vcap);
  }
  __host__ __device__ static size_t bytes(int C, int vcap, bool shared) {
    return (size_t)acc_bytes(C, shared) + x_bytes(C, shared) + RED +
           NSTAGE * (size_t)buffer(vcap);
  }
};

// One step of a block's walk: work item `item` (-1: none), and for an item
// of one long group (L > BLOCK) its BLOCK-row part `sub` in pass 0 (t sums)
// or pass 1 (u).
struct Step {
  int item, sub, pass;
};

struct Geo {
  long long row0;  // first row
  long long p0;    // first point slot
  int n;           // rows (a multiple of L where L <= BLOCK)
  int np;          // point slots
  int log_l;
  int nsub;        // parts a pass: 1 where L <= BLOCK
};

__device__ __forceinline__ Geo geometry(const BucketTable& tab, Step s) {
  int b = 0;
  while (b + 1 < tab.n && s.item >= tab.item_off[b + 1]) ++b;
  const long long li = s.item - tab.item_off[b];
  Geo g;
  g.log_l = tab.log_l[b];
  const long long L = 1LL << g.log_l;
  if (L <= BLOCK) {
    const long long left = tab.rows[b] - li * BLOCK;
    g.row0 = tab.row_start[b] + li * BLOCK;
    g.n = (int)(left < BLOCK ? left : BLOCK);
    g.p0 = tab.pt_start[b] + ((li * BLOCK) >> g.log_l);
    g.np = g.n >> g.log_l;
    g.nsub = 1;
  } else {
    g.row0 = tab.row_start[b] + li * L + (long long)s.sub * BLOCK;
    g.n = BLOCK;
    g.p0 = tab.pt_start[b] + li;
    g.np = 1;
    g.nsub = (int)(L / BLOCK);
  }
  return g;
}

__device__ __forceinline__ Step advance(Step s, const Geo& g, int nitems) {
  if (s.sub + 1 < g.nsub) {
    ++s.sub;
  } else if (g.nsub > 1 && s.pass == 0) {
    s.pass = 1;
    s.sub = 0;
  } else {
    s.item += gridDim.x;
    s.sub = s.pass = 0;
    if (s.item >= nitems) s.item = -1;
  }
  return s;
}

__device__ __forceinline__ int misalign(const void* p) {
  return (int)(reinterpret_cast<uintptr_t>(p) & 15);
}

// 16-byte asynchronous copy global -> shared; bytes past src_bytes are zero
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until the work before this kernel in the stream (the memset of y)
// has finished and is visible; without a programmatic launch, a no-op.
__device__ __forceinline__ void wait_for_y_zeroed() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy the bytes [src, src + nbytes) of an array that ends at `end` into
// dst, from the 16-byte boundary at or below src: the data lands at
// dst + misalign(src).  Bytes at or past `end` are zero-filled.
__device__ __forceinline__ void stage_span(unsigned char* dst, const void* src,
                                           long long nbytes, const void* end) {
  const uintptr_t s = reinterpret_cast<uintptr_t>(src);
  const uintptr_t a0 = s & ~uintptr_t(15);
  const uintptr_t e = reinterpret_cast<uintptr_t>(end);
  const int nvec = (int)((s - a0 + nbytes + 15) >> 4);
  for (int v = threadIdx.x; v < nvec; v += BLOCK) {
    const uintptr_t g = a0 + 16 * (uintptr_t)v;  // g < e
    const uintptr_t left = e - g;
    cp_async16(dst + 16 * v, reinterpret_cast<const void*>(g),
               left < 16 ? (int)left : 16);
  }
}

// n rows of ROWV 16-byte vectors each, from a 16-byte aligned src, to rows
// of STRIDE vectors in dst.
template <int ROWV, int STRIDE>
__device__ __forceinline__ void stage_rows(unsigned char* dst, const void* src,
                                           int n) {
  const unsigned char* s = static_cast<const unsigned char*>(src);
  for (int v = threadIdx.x; v < n * ROWV; v += BLOCK) {
    const int r = v / ROWV;
    cp_async16(dst + 16 * (r * STRIDE + v - r * ROWV), s + 16LL * v, 16);
  }
}

// Start the copies of a step's W rows, cam_idx and V_inv slots into buf.
template <typename T, int PC>
__device__ __forceinline__ void stage_step(unsigned char* buf, const Geo& g,
                                           const T* W, long long num_rows,
                                           const int* cam_idx, const T* V_inv,
                                           long long num_slots) {
  using LY = Layout<T, PC>;
  const T* w0 = W + g.row0 * (PC * 3);
  if constexpr (LY::VEC_ROWS)
    stage_rows<LY::ROWV, LY::STRIDE>(buf, w0, g.n);
  else
    stage_span(buf, w0, (long long)g.n * LY::ROWB, W + num_rows * (PC * 3));
  stage_span(buf + LY::WBUF, cam_idx + g.row0, 4LL * g.n, cam_idx + num_rows);
  stage_span(buf + LY::WBUF + LY::CBUF, V_inv + g.p0 * 9,
             (long long)g.np * 9 * sizeof(T), V_inv + num_slots * 9);
}

__device__ __forceinline__ void load16(const unsigned char* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

__device__ __forceinline__ void load16(const unsigned char* p, double* v) {
  const double2 q = *reinterpret_cast<const double2*>(p);
  v[0] = q.x;
  v[1] = q.y;
}

// Row r of a staged W buffer into w; returns whether any entry is nonzero.
template <typename T, int PC>
__device__ __forceinline__ bool load_row(const unsigned char* Wb, int delta,
                                         int r, T (&w)[PC][3]) {
  using LY = Layout<T, PC>;
  T v[PC * 3];
  if constexpr (LY::VEC_ROWS) {
    const unsigned char* row = Wb + 16 * r * LY::STRIDE;
#pragma unroll
    for (int i = 0; i < LY::ROWV; ++i)
      load16(row + 16 * i, v + i * (16 / (int)sizeof(T)));
  } else {
    const T* row = reinterpret_cast<const T*>(Wb + delta) + r * (PC * 3);
#pragma unroll
    for (int i = 0; i < PC * 3; ++i) v[i] = row[i];
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

template <typename T>
__device__ __forceinline__ void butterfly(T& a, T& b, T& c, int max_off) {
  // all 32 lanes take part (max_off is the same for the whole block): lane
  // i adds lane i^m for m < group size, log2(group size) rounds
  for (int m = 1; m < max_off; m <<= 1) {
    a += __shfl_xor_sync(FULL_MASK, a, m);
    b += __shfl_xor_sync(FULL_MASK, b, m);
    c += __shfl_xor_sync(FULL_MASK, c, m);
  }
}

// t += Wᵀ x[cam], x from the shared [PC, C] copy or from device memory
template <typename T, int PC, bool SHARED>
__device__ __forceinline__ void row_t(const T (&w)[PC][3], const T* xt,
                                      const T* __restrict__ x, int C, int cam,
                                      T& t0, T& t1, T& t2) {
#pragma unroll
  for (int c = 0; c < PC; ++c) {
    const T xc = SHARED ? xt[c * C + cam] : __ldg(x + (long long)cam * PC + c);
    t0 += w[c][0] * xc;
    t1 += w[c][1] * xc;
    t2 += w[c][2] * xc;
  }
}

template <typename T>
__device__ __forceinline__ void apply_vinv(const T* V, T s0, T s1, T s2,
                                           T& z0, T& z1, T& z2) {
  z0 = V[0] * s0 + V[1] * s1 + V[2] * s2;
  z1 = V[3] * s0 + V[4] * s1 + V[5] * s2;
  z2 = V[6] * s0 + V[7] * s1 + V[8] * s2;
}

// 128-bit compare-and-swap on shared memory (sm_90): {lo, hi} holds the
// expected word and receives the word found; returns whether it swapped
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

template <typename T, int PC>
__device__ __forceinline__ void shared_add(unsigned long long* acc, int C,
                                           int cam, const T (&u)[PC]) {
  using LY = Layout<T, PC>;
  T v[LY::SLOTS * LY::PER];
#pragma unroll
  for (int i = 0; i < LY::SLOTS * LY::PER; ++i) v[i] = i < PC ? u[i] : T(0);
  unsigned long long lo[LY::SLOTS], hi[LY::SLOTS];
#pragma unroll
  for (int j = 0; j < LY::SLOTS; ++j) {
    const ulonglong2 w =
        *reinterpret_cast<const ulonglong2*>(acc + 2 * (j * C + cam));
    lo[j] = w.x;
    hi[j] = w.y;
  }
  unsigned pending = (1u << LY::SLOTS) - 1;
  do {
#pragma unroll
    for (int j = 0; j < LY::SLOTS; ++j) {
      if (pending & (1u << j)) {
        unsigned long long nlo, nhi;
        if constexpr (std::is_same<T, float>::value) {
          nlo = add2(lo[j], v[4 * j], v[4 * j + 1]);
          nhi = add2(hi[j], v[4 * j + 2], v[4 * j + 3]);
        } else {
          nlo = add1(lo[j], v[2 * j]);
          nhi = add1(hi[j], v[2 * j + 1]);
        }
        if (cas128(acc + 2 * (j * C + cam), lo[j], hi[j], nlo, nhi))
          pending &= ~(1u << j);
      }
    }
  } while (pending);
}

// u = W z, added to camera cam's entries: of the shared table, or of y
template <typename T, int PC, bool SHARED>
__device__ __forceinline__ void add_u(const T (&w)[PC][3], T z0, T z1, T z2,
                                      unsigned long long* acc,
                                      T* __restrict__ y, int C, int cam) {
  T u[PC];
#pragma unroll
  for (int c = 0; c < PC; ++c)
    u[c] = w[c][0] * z0 + w[c][1] * z1 + w[c][2] * z2;
  if constexpr (SHARED) {
    shared_add<T, PC>(acc, C, cam, u);
  } else if constexpr (std::is_same<T, float>::value && PC % 4 == 0) {
#pragma unroll
    for (int k = 0; k < PC; k += 4)
      atomicAdd(reinterpret_cast<float4*>(y + (long long)cam * PC + k),
                make_float4(u[k], u[k + 1], u[k + 2], u[k + 3]));
  } else {
#pragma unroll
    for (int c = 0; c < PC; ++c) atomicAdd(y + (long long)cam * PC + c, u[c]);
  }
}

template <typename T, int PC, bool SHARED>
__global__ void __launch_bounds__(BLOCK)
schur_wchain_kernel(const T* __restrict__ W, const T* __restrict__ V_inv,
                    const T* __restrict__ x, const int* __restrict__ cam_idx,
                    T* __restrict__ y, long long num_rows, long long num_slots,
                    int C, int vcap, const BucketTable tab) {
  using LY = Layout<T, PC>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tbytes = LY::acc_bytes(C, SHARED) + LY::x_bytes(C, SHARED);
  auto* acc = reinterpret_cast<unsigned long long*>(smem);  // [SLOTS, C, 2]
  T* xt = reinterpret_cast<T*>(smem + LY::acc_bytes(C, SHARED));  // [PC, C]
  T* red = reinterpret_cast<T*>(smem + tbytes);  // [NWARP, 3]
  unsigned char* bufs = smem + tbytes + LY::RED;
  const int buf_bytes = LY::buffer(vcap);
  const int nitems = tab.item_off[tab.n];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // the steps staged ahead: `ahead` is the next one to stage, into buffer
  // `b_ahead`; NSTAGE - 1 are in flight while one computes
  Step cur{(int)blockIdx.x, 0, 0}, ahead = cur;
  int b = 0, b_ahead = 0;
  auto stage_ahead = [&]() {
    if (ahead.item >= 0) {
      const Geo ga = geometry(tab, ahead);
      stage_step<T, PC>(bufs + b_ahead * buf_bytes, ga, W, num_rows, cam_idx,
                        V_inv, num_slots);
      ahead = advance(ahead, ga, nitems);
      b_ahead = b_ahead + 1 == NSTAGE ? 0 : b_ahead + 1;
    }
    cp_async_commit();  // an empty group past the last step
  };
#pragma unroll
  for (int i = 0; i < NSTAGE - 1; ++i) stage_ahead();
  if constexpr (SHARED) {
    for (int i = tid; i < 2 * LY::SLOTS * C; i += BLOCK) acc[i] = 0ull;
    for (int i = tid; i < PC * C; i += BLOCK) {
      const int cam = i / PC;
      xt[(i - cam * PC) * C + cam] = x[i];
    }
  }

  if constexpr (!SHARED) wait_for_y_zeroed();  // rows add to y directly

  T tl0 = 0, tl1 = 0, tl2 = 0;  // a long group (L > BLOCK): this thread's t
  T zl0 = 0, zl1 = 0, zl2 = 0;  // and the group's z
  while (cur.item >= 0) {
    const Geo g = geometry(tab, cur);
    stage_ahead();
    cp_async_wait<NSTAGE - 1>();  // this thread's copies of cur have landed
    __syncthreads();              // and every thread's

    const unsigned char* buf = bufs + b * buf_bytes;
    T w[PC][3] = {};
    bool nz = false;
    int cam = 0;
    if (tid < g.n) {
      nz = load_row<T, PC>(buf, misalign(W + g.row0 * (PC * 3)), tid, w);
      cam = reinterpret_cast<const int*>(
          buf + LY::WBUF + misalign(cam_idx + g.row0))[tid];
    }
    const T* Vs = reinterpret_cast<const T*>(
        buf + LY::WBUF + LY::CBUF + misalign(V_inv + g.p0 * 9));

    if (g.nsub == 1) {
      // whole groups of L <= BLOCK rows; rows past g.n add zeros
      const int L = 1 << g.log_l;
      T t0 = 0, t1 = 0, t2 = 0;
      if (nz) row_t<T, PC, SHARED>(w, xt, x, C, cam, t0, t1, t2);
      butterfly(t0, t1, t2, L < 32 ? L : 32);
      if (L > 32) {
        // lane 0 of each warp holds its warp's sum; a group spans L/32 warps
        if (lane == 0) {
          red[3 * warp + 0] = t0;
          red[3 * warp + 1] = t1;
          red[3 * warp + 2] = t2;
        }
        __syncthreads();
        const int wpg = L >> 5;
        const int g0 = (warp / wpg) * wpg;
        t0 = t1 = t2 = 0;
        for (int i = 0; i < wpg; ++i) {
          t0 += red[3 * (g0 + i) + 0];
          t1 += red[3 * (g0 + i) + 1];
          t2 += red[3 * (g0 + i) + 2];
        }
      }
      if (nz) {
        T z0, z1, z2;
        apply_vinv(Vs + (tid >> g.log_l) * 9, t0, t1, t2, z0, z1, z2);
        add_u<T, PC, SHARED>(w, z0, z1, z2, acc, y, C, cam);
      }
    } else if (cur.pass == 0) {
      // one group of L > BLOCK rows, part cur.sub: sum t
      if (nz) row_t<T, PC, SHARED>(w, xt, x, C, cam, tl0, tl1, tl2);
      if (cur.sub == g.nsub - 1) {
        butterfly(tl0, tl1, tl2, 32);
        if (lane == 0) {
          red[3 * warp + 0] = tl0;
          red[3 * warp + 1] = tl1;
          red[3 * warp + 2] = tl2;
        }
        __syncthreads();
        T s0 = 0, s1 = 0, s2 = 0;
#pragma unroll
        for (int i = 0; i < NWARP; ++i) {
          s0 += red[3 * i + 0];
          s1 += red[3 * i + 1];
          s2 += red[3 * i + 2];
        }
        apply_vinv(Vs, s0, s1, s2, zl0, zl1, zl2);
        tl0 = tl1 = tl2 = 0;
      }
    } else if (nz) {
      // the same group again, part cur.sub: u = W z
      add_u<T, PC, SHARED>(w, zl0, zl1, zl2, acc, y, C, cam);
    }
    __syncthreads();  // buf and red are free for the next steps
    cur = advance(cur, g, nitems);
    b = b + 1 == NSTAGE ? 0 : b + 1;
  }

  if constexpr (SHARED) {
    // the loop's last barrier ordered every shared atomic before this; the
    // table goes to y, flat, with one atomic per nonzero entry, four entries
    // (16 bytes) at a time in float32, once the memset of y is done
    wait_for_y_zeroed();
    const T* sums = reinterpret_cast<const T*>(acc);
    auto entry = [&](int i) {  // y's flat entry i = cam * PC + c
      const int cam = i / PC, c = i - cam * PC;
      return sums[((c / LY::PER) * C + cam) * LY::PER + c % LY::PER];
    };
    const int n = C * PC;
    if constexpr (std::is_same<T, float>::value) {
      for (int i = 4 * tid; i < n; i += 4 * BLOCK) {
        if (i + 4 <= n) {
          const float4 v =
              make_float4(entry(i), entry(i + 1), entry(i + 2), entry(i + 3));
          if (v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f)
            atomicAdd(reinterpret_cast<float4*>(y + i), v);
        } else {
          for (int k = i; k < n; ++k) {
            const float v = entry(k);
            if (v != 0.f) atomicAdd(y + k, v);
          }
        }
      }
    } else {
      for (int i = tid; i < n; i += BLOCK) {
        const T v = entry(i);
        if (v != T(0)) atomicAdd(y + i, v);
      }
    }
  }
}

struct LaunchArgs {
  const void *W, *V_inv, *x, *cam_idx;
  void* y;
  long long num_rows, num_slots;
  int C, vcap, sms;
  BucketTable tab;
};

template <typename T, int PC, bool SHARED>
static cudaError_t launch_kernel(const LaunchArgs& a, cudaStream_t stream) {
  auto kernel = schur_wchain_kernel<T, PC, SHARED>;
  const size_t smem = Layout<T, PC>::bytes(a.C, a.vcap, SHARED);
  // per instantiation, for the process's device: the shared memory opted
  // in so far, and the blocks an SM at the last size asked
  static size_t smem_granted = 0, occ_smem = 0;
  static int occ = 0;
  cudaError_t err;
  if (smem > smem_granted) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_granted = smem;
  }
  if (smem != occ_smem) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, BLOCK,
                                                        smem);
    if (err != cudaSuccess) return err;
    occ_smem = smem;
  }
  if (occ < 1) return cudaErrorInvalidConfiguration;
  const int per_sm = MAX_PER_SM < occ ? MAX_PER_SM : occ;
  const long long nitems = a.tab.item_off[a.tab.n];
  const long long cap = (long long)per_sm * a.sms;
  const unsigned grid = (unsigned)(nitems < cap ? nitems : cap);
  // programmatic dependent launch: the kernel may start while the memset
  // of y before it finishes, and waits for it before touching y
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(BLOCK);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(a.W),
      static_cast<const T*>(a.V_inv), static_cast<const T*>(a.x),
      static_cast<const int*>(a.cam_idx), static_cast<T*>(a.y), a.num_rows,
      a.num_slots, a.C, a.vcap, a.tab);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
static cudaError_t launch_typed(int pc, bool shared, const LaunchArgs& a,
                                cudaStream_t stream) {
  switch (pc) {
#define CASE(N)                                              \
  case N:                                                    \
    return shared ? launch_kernel<T, N, true>(a, stream)     \
                  : launch_kernel<T, N, false>(a, stream);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
  }
  return cudaErrorInvalidValue;
}

extern "C" {

// dtype: 0 = float32, 1 = float64.  PC in 1..8.  shared: sum cameras in a
// shared-memory table (solve/schur_wchain.py::shared_table), else with
// global atomics.  W [num_rows, PC, 3], V_inv [num_slots, 3, 3] and
// cam_idx [num_rows] start on 16 bytes; x and y are [num_cams, PC].  The
// bucket arrays are host arrays of nb entries (item_off: nb + 1), built by
// solve/schur_wchain.py::launch_table.  Returns a cudaError_t code.
int schur_wchain_launch(int dtype, int pc, int shared, const void* W,
                        const void* V_inv, const void* x, const void* cam_idx,
                        void* y, long long num_rows, long long num_slots,
                        int num_cams, int nb, const long long* row_start,
                        const long long* rows, const long long* pt_start,
                        const long long* log_l, const long long* item_off,
                        void* stream) {
  if (nb < 1 || nb > MAX_BUCKETS || pc < 1 || pc > 8 || dtype < 0 ||
      dtype > 1 || num_cams < 1 || item_off[nb] > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const long long esize = dtype == 0 ? 4 : 8;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(y, 0, (size_t)(num_cams * pc * esize), s);
  if (err != cudaSuccess) return (int)err;

  LaunchArgs a;
  a.W = W;
  a.V_inv = V_inv;
  a.x = x;
  a.cam_idx = cam_idx;
  a.y = y;
  a.num_rows = num_rows;
  a.num_slots = num_slots;
  a.C = num_cams;
  a.vcap = 1;  // point slots a step stages, at most
  a.tab.n = nb;
  for (int i = 0; i < nb; ++i) {
    if (log_l[i] < 1 || log_l[i] > 30) return (int)cudaErrorInvalidValue;
    a.tab.row_start[i] = row_start[i];
    a.tab.rows[i] = rows[i];
    a.tab.pt_start[i] = pt_start[i];
    a.tab.log_l[i] = (int)log_l[i];
    a.tab.item_off[i] = (int)item_off[i];
    const int per_step = log_l[i] <= 8 ? BLOCK >> log_l[i] : 1;
    if (per_step > a.vcap) a.vcap = per_step;
  }
  a.tab.item_off[nb] = (int)item_off[nb];
  if (a.tab.item_off[nb] == 0) return (int)cudaSuccess;
  // each device's SM count, queried on its first launch
  static int sms[MAX_DEVICES] = {};
  int dev;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return (int)err;
  }
  a.sms = sms[dev];
  err = dtype == 0 ? launch_typed<float>(pc, shared != 0, a, s)
                   : launch_typed<double>(pc, shared != 0, a, s);
  return (int)err;
}

const char* schur_wchain_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
