// Fixed-tile flux-form tracer advection ∇·(U c) for NVIDIA Hopper (sm_90a).
//
// Replaces `climaseaice_jl_tpu/dynamics/pallas_advection.py::_adv_kernel`:
// at every padded point, the upwind-selected face reconstructions of c at
// its west and east x faces and south and north y faces (WENO 5/7/9,
// UpwindBiased 1/3/5/7, Centered 2/4; the x and y schemes may differ), the
// fluxes u·ĉ and v·ĉ zeroed through peripheral faces, and their divergence:
// δx(fx)·(1/Δx) + δy(fy)·(1/Δy) on uniform grids, [δx(Δy_fc·u·ĉ) +
// δy(Δx_cf·v·ĉ)]/Az_cc with array metrics, and the same with 0-d Δy_fc,
// Δx_cf and Az_cc (`metrics_0d`: the whole-grid route's uniform grids, in
// the order of `advection.py:horizontal_div_Uc`).  The TPU kernel gathers
// halo-extended tiles (wrap into the interior along a periodic direction
// that is not split across ranks, clamp at the padded edge otherwise:
// `pallas_advection.py:217-218`) and shifts inside them: a point's
// neighbour at offset k is the image of its padded index + k.  On one
// rank's shard of the distributed step a split direction does not wrap: its
// halos hold the neighbouring ranks' values.
//
// What bounds it on an H100: per point the WENO-7 function needs 1023
// float32 operations, two one-sided reconstructions of 253 at each of its
// x and y faces (counted as the plain version computes each face once:
// chip_smoke.py's ADV_FLOPS_PER_POINT), against 3 float32 arrays and 2 byte
// masks read and one array written, 18 bytes: at 522² 0.0042 ms of
// operations at 67 TFLOP/s and 0.0015 ms of bytes.  The call is bound by
// operations.
//
// Design (the tile kernel, one launch per tracer): the schemes' kind and
// order are template arguments, so the stencils' loops unroll and the
// stencils stay in registers; the WENO tables (ε, C, G, B rounded to
// float32 by the caller) travel in the launch arguments, read through the
// constant cache.  A block owns TX × TY points, y contiguous.  It forms the
// images of its rows and columns once, loads c over the tile widened by the
// schemes' radii into shared memory once, computes each of the tile's
// (TX+1)×TY x faces and TX×(TY+1) y faces once (its upwind select, its
// peripheral mask and, with array metrics, its Δy_fc or Δx_cf product)
// into shared memory, and forms each point's divergence from its two pairs
// of faces.  The nine same-scheme pairs are instantiated (TILE_SCHEMES);
// a FluxFormAdvection whose x and y schemes differ runs the runtime-scheme
// kernel, one thread per point reading its stencils' images directly and
// computing its west and east faces itself (a point's east face is its
// neighbour's west face there).
//
// Arithmetic: the plain PyTorch version's operation order (the reductions
// of `advection.py` left to right from 0, G/(ε + β)² as (1/(ε + β)²)·G as
// PyTorch's reflected division computes it, a division by an integer
// constant as the product with its float reciprocal, as PyTorch's CUDA
// division by a Python number computes it).  The tile kernel adds every
// smoothness term: the caller checks that no coefficient of its tables is
// 0, where the plain version skips the term.  Built with -fmad=false
// (`_build.py`): no multiply-add is contracted, so a point's bits do not
// depend on the launch, the array shape or the halo width, and both kernels
// give each face the same bits.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int BX = 32;  // threads along y (the contiguous axis)
constexpr int BY = 8;   // threads along x
constexpr int R = 5;    // widest stencil radius

enum Kind { CENTERED = 0, UPWIND = 1, WENO = 2 };

struct Scheme {
  int kind, order;
  const float* tab;   // WENO: ε, C[r][r], G[r], B[r][r][r]
};

// the padded index that stands at padded index k: its interior image where
// the direction wraps, k clamped at the padded edge where it does not
__device__ __forceinline__ int image(int k, int ext, int H, int N, int wrap) {
  if (wrap) {
    const int r = (k - H) % N;
    return H + (r < 0 ? r + N : r);
  }
  return k < 0 ? 0 : (k >= ext ? ext - 1 : k);
}

// x / d for an integer constant d, as PyTorch's CUDA division by a Python
// number computes it: x times the float reciprocal
__device__ __forceinline__ float div_const(float x, float d) { return x * (1.0f / d); }

// One-sided WENO-(2r−1) from the stencil st[0 … 2r−2], upwind to downwind
// (`advection.py:_weno_side`).
__device__ float weno_side(const float* __restrict__ tab, int r, const float* st) {
  const float eps = tab[0];
  const float* C = tab + 1;
  const float* G = C + r * r;
  const float* B = G + r;
  float num = 0.0f, den = 0.0f;
  for (int k = 0; k < r; ++k) {
    const float* cells = st + k;
    float q = 0.0f;
    for (int j = 0; j < r; ++j) q = q + C[k * r + j] * cells[j];
    float beta = 0.0f;
    for (int j1 = 0; j1 < r; ++j1)
      for (int j2 = 0; j2 < r; ++j2) {
        const float b = B[(k * r + j1) * r + j2];
        if (b != 0.0f) beta = beta + b * cells[j1] * cells[j2];
      }
    const float t = beta + eps;
    const float w = (1.0f / (t * t)) * G[k];
    num = num + w * q;
    den = den + w;
  }
  return num / den;
}

// (left-biased, right-biased) reconstructions at face I from s[k] = c(I + k),
// k = −R … R − 1 (`advection.py:reconstruct_face`).
__device__ void reconstruct(const Scheme& sc, const float* s, float& left, float& right) {
  const float c = s[0];
#define M(k) s[-(k)]
#define P(k) s[(k)]
  if (sc.kind == CENTERED) {
    if (sc.order == 2) {
      left = 0.5f * (M(1) + c);
    } else {
      left = div_const(-M(2) + 7.0f * M(1) + 7.0f * c - P(1), 12.0f);
    }
    right = left;
  } else if (sc.kind == UPWIND) {
    if (sc.order == 1) {
      left = M(1);
      right = c;
    } else if (sc.order == 3) {
      left = div_const(-M(2) + 5.0f * M(1) + 2.0f * c, 6.0f);
      right = div_const(2.0f * M(1) + 5.0f * c - P(1), 6.0f);
    } else if (sc.order == 5) {
      left = div_const(2.0f * M(3) - 13.0f * M(2) + 47.0f * M(1) + 27.0f * c - 3.0f * P(1),
                       60.0f);
      right = div_const(2.0f * P(2) - 13.0f * P(1) + 47.0f * c + 27.0f * M(1) - 3.0f * M(2),
                        60.0f);
    } else {
      left = div_const(-3.0f * M(4) + 25.0f * M(3) - 101.0f * M(2) + 319.0f * M(1)
                       + 214.0f * c - 38.0f * P(1) + 4.0f * P(2), 420.0f);
      right = div_const(-3.0f * P(3) + 25.0f * P(2) - 101.0f * P(1) + 319.0f * c
                        + 214.0f * M(1) - 38.0f * M(2) + 4.0f * M(3), 420.0f);
    }
  } else {
    const int r = (sc.order + 1) / 2;
    float st[2 * R - 1];
    // left-biased: c(I − r) … c(I + r − 2); right-biased: c(I + r − 1) … c(I − r + 1)
    for (int j = 0; j < 2 * r - 1; ++j) st[j] = s[j - r];
    left = weno_side(sc.tab, r, st);
    for (int j = 0; j < 2 * r - 1; ++j) st[j] = s[r - 1 - j];
    right = weno_side(sc.tab, r, st);
  }
#undef M
#undef P
}

__device__ __forceinline__ float upwind_select(float vel, float left, float right) {
  return vel > 0.0f ? left : (vel < 0.0f ? right : 0.5f * (left + right));
}

__global__ void __launch_bounds__(BX * BY) fixed_tile_div(
    const float* __restrict__ u, const float* __restrict__ v, const float* __restrict__ c,
    const uint8_t* __restrict__ per_fc, const uint8_t* __restrict__ per_cf,
    const float* __restrict__ dy_fc, const float* __restrict__ dx_cf,
    const float* __restrict__ az_cc, const float* __restrict__ inv_dx,
    const float* __restrict__ inv_dy, Scheme sx, Scheme sy,
    float* __restrict__ out, int nxp, int nyp, int Hx, int Nx, int Hy, int Ny, int wrap_x,
    int wrap_y, int metrics_0d) {
  const int j = blockIdx.x * BX + threadIdx.x;
  const int i = blockIdx.y * BY + threadIdx.y;
  if (i >= nxp || j >= nyp) return;
  // images of i + k and j + k, k = −R … R
  int ix[2 * R + 1], iy[2 * R + 1];
  for (int k = -R; k <= R; ++k) {
    ix[k + R] = image(i + k, nxp, Hx, Nx, wrap_x);
    iy[k + R] = image(j + k, nyp, Hy, Ny, wrap_y);
  }
  const int row0 = ix[R] * nyp, col0 = iy[R];
  float cs[2 * R + 1];
  for (int k = 0; k <= 2 * R; ++k) cs[k] = c[ix[k] * nyp + col0];
  const bool arr = az_cc != nullptr;
  float f[2];
  for (int e = 0; e < 2; ++e) {   // faces i (west) and i + 1 (east)
    float l, r;
    reconstruct(sx, cs + R + e, l, r);
    const int k = ix[R + e] * nyp + col0;
    const float uk = u[k];
    const float cx = upwind_select(uk, l, r);
    const float fx = arr ? dy_fc[metrics_0d ? 0 : k] * uk * cx : uk * cx;
    f[e] = per_fc[k] ? 0.0f : fx;
  }
  const float dfx = f[1] - f[0];
  for (int k = 0; k <= 2 * R; ++k) cs[k] = c[row0 + iy[k]];
  for (int e = 0; e < 2; ++e) {   // faces j (south) and j + 1 (north)
    float l, r;
    reconstruct(sy, cs + R + e, l, r);
    const int k = row0 + iy[R + e];
    const float vk = v[k];
    const float cy = upwind_select(vk, l, r);
    const float fy = arr ? dx_cf[metrics_0d ? 0 : k] * vk * cy : vk * cy;
    f[e] = per_cf[k] ? 0.0f : fy;
  }
  const float dfy = f[1] - f[0];
  out[static_cast<size_t>(i) * nyp + j] =
      arr ? (dfx + dfy) / az_cc[metrics_0d ? 0 : row0 + col0]
          : dfx * inv_dx[0] + dfy * inv_dy[0];
}

// --- the tile kernel ------------------------------------------------------------

constexpr int TX = 16;    // a tile's rows (x)
constexpr int TY = 32;    // a tile's columns (y, contiguous): one warp a row
constexpr int THREADS = 256;
constexpr int MAX_TAB = 1 + 25 + 5 + 125;   // the WENO-9 table

// The instantiated (kind, order) schemes, each as the x and the y scheme
#define CSI_TILE_SCHEMES(X) \
  X(WENO, 5) X(WENO, 7) X(WENO, 9) X(UPWIND, 1) X(UPWIND, 3) X(UPWIND, 5) X(UPWIND, 7) \
  X(CENTERED, 2) X(CENTERED, 4)

// the stencil radius R of a scheme: a face reconstruction reads c(I + k),
// k = −R … R − 1 (advection.required_halo)
template <int KIND, int ORDER>
__host__ __device__ constexpr int radius() {
  return KIND == WENO ? (ORDER + 1) / 2 : (ORDER + (KIND == UPWIND ? 1 : 0)) / 2;
}

struct Table {
  float v[MAX_TAB];   // WENO: ε, C[r][r], G[r], B[r][r][r]
};

struct TileArgs {
  const float* u;
  const float* v;
  const float* c;
  const uint8_t* per_fc;
  const uint8_t* per_cf;
  const float* dy_fc;
  const float* dx_cf;
  const float* az_cc;
  const float* inv_dx;
  const float* inv_dy;
  float* out;
  int nxp, nyp, Hx, Nx, Hy, Ny, wrap_x, wrap_y, metrics_0d;
  Table tx, ty;
};

// One-sided WENO-(2r−1) from the stencil st[0 … 2r−2], upwind to downwind
// (`advection.py:_weno_side`), every smoothness term added.
template <int r>
__device__ __forceinline__ float weno_side_t(const float* tab, const float (&st)[2 * r - 1]) {
  const float eps = tab[0];
  const float* C = tab + 1;
  const float* G = C + r * r;
  const float* B = G + r;
  float num = 0.0f, den = 0.0f;
#pragma unroll
  for (int k = 0; k < r; ++k) {
    float q = 0.0f;
#pragma unroll
    for (int j = 0; j < r; ++j) q = q + C[k * r + j] * st[k + j];
    float beta = 0.0f;
#pragma unroll
    for (int j1 = 0; j1 < r; ++j1)
#pragma unroll
      for (int j2 = 0; j2 < r; ++j2)
        beta = beta + B[(k * r + j1) * r + j2] * st[k + j1] * st[k + j2];
    const float t = beta + eps;
    const float w = (1.0f / (t * t)) * G[k];
    num = num + w * q;
    den = den + w;
  }
  return num / den;
}

// (left-biased, right-biased) reconstructions at face I from
// s[R + k] = c(I + k), k = −R … R − 1 (`advection.py:reconstruct_face`).
template <int KIND, int ORDER, int R>
__device__ __forceinline__ void reconstruct_t(const float* tab, const float (&s)[2 * R],
                                              float& left, float& right) {
  const float c = s[R];
#define M(k) s[R - (k)]
#define P(k) s[R + (k)]
  if constexpr (KIND == CENTERED) {
    if constexpr (ORDER == 2) {
      left = 0.5f * (M(1) + c);
    } else {
      left = div_const(-M(2) + 7.0f * M(1) + 7.0f * c - P(1), 12.0f);
    }
    right = left;
  } else if constexpr (KIND == UPWIND) {
    if constexpr (ORDER == 1) {
      left = M(1);
      right = c;
    } else if constexpr (ORDER == 3) {
      left = div_const(-M(2) + 5.0f * M(1) + 2.0f * c, 6.0f);
      right = div_const(2.0f * M(1) + 5.0f * c - P(1), 6.0f);
    } else if constexpr (ORDER == 5) {
      left = div_const(2.0f * M(3) - 13.0f * M(2) + 47.0f * M(1) + 27.0f * c - 3.0f * P(1),
                       60.0f);
      right = div_const(2.0f * P(2) - 13.0f * P(1) + 47.0f * c + 27.0f * M(1) - 3.0f * M(2),
                        60.0f);
    } else {
      left = div_const(-3.0f * M(4) + 25.0f * M(3) - 101.0f * M(2) + 319.0f * M(1)
                       + 214.0f * c - 38.0f * P(1) + 4.0f * P(2), 420.0f);
      right = div_const(-3.0f * P(3) + 25.0f * P(2) - 101.0f * P(1) + 319.0f * c
                        + 214.0f * M(1) - 38.0f * M(2) + 4.0f * M(3), 420.0f);
    }
  } else {
    constexpr int r = (ORDER + 1) / 2;
    float st[2 * r - 1];
    // left-biased: c(I − r) … c(I + r − 2); right-biased: c(I + r − 1) … c(I − r + 1)
#pragma unroll
    for (int j = 0; j < 2 * r - 1; ++j) st[j] = s[R + j - r];
    left = weno_side_t<r>(tab, st);
#pragma unroll
    for (int j = 0; j < 2 * r - 1; ++j) st[j] = s[R + r - 1 - j];
    right = weno_side_t<r>(tab, st);
  }
#undef M
#undef P
}

template <int KX, int OX, int KY, int OY>
__global__ void __launch_bounds__(THREADS) tile_div(const __grid_constant__ TileArgs A) {
  constexpr int RX = radius<KX, OX>(), RY = radius<KY, OY>();
  constexpr int CH = TX + 2 * RX, CW = TY + 2 * RY;   // the widened tile of c
  __shared__ int img_x[CH], img_y[CW];                 // images of its rows and columns
  __shared__ float cs[CH * CW];
  __shared__ float fx[(TX + 1) * TY];                  // x faces i0 … i0 + TX
  __shared__ float fy[TX * (TY + 1)];                  // y faces j0 … j0 + TY
  const int tid = threadIdx.x;
  const int i0 = blockIdx.y * TX, j0 = blockIdx.x * TY;
  const int nyp = A.nyp;
  if (tid < CH) img_x[tid] = image(i0 - RX + tid, A.nxp, A.Hx, A.Nx, A.wrap_x);
  if (tid < CW) img_y[tid] = image(j0 - RY + tid, nyp, A.Hy, A.Ny, A.wrap_y);
  __syncthreads();
  for (int q = tid; q < CH * CW; q += THREADS)
    cs[q] = A.c[img_x[q / CW] * nyp + img_y[q % CW]];
  __syncthreads();
  const bool arr = A.az_cc != nullptr;
  const bool m0 = A.metrics_0d != 0;
  for (int q = tid; q < (TX + 1) * TY; q += THREADS) {   // face (i0 + a, j0 + b)
    const int a = q / TY, b = q % TY;
    float s[2 * RX];
#pragma unroll
    for (int k = 0; k < 2 * RX; ++k) s[k] = cs[(a + k) * CW + b + RY];
    float l, r;
    reconstruct_t<KX, OX, RX>(A.tx.v, s, l, r);
    const int g = img_x[a + RX] * nyp + img_y[b + RY];
    const float ug = A.u[g];
    const float cx = upwind_select(ug, l, r);
    const float f = arr ? A.dy_fc[m0 ? 0 : g] * ug * cx : ug * cx;
    fx[q] = A.per_fc[g] ? 0.0f : f;
  }
  for (int q = tid; q < TX * (TY + 1); q += THREADS) {   // face (i0 + a, j0 + b)
    const int a = q / (TY + 1), b = q % (TY + 1);
    float s[2 * RY];
#pragma unroll
    for (int k = 0; k < 2 * RY; ++k) s[k] = cs[(a + RX) * CW + b + k];
    float l, r;
    reconstruct_t<KY, OY, RY>(A.ty.v, s, l, r);
    const int g = img_x[a + RX] * nyp + img_y[b + RY];
    const float vg = A.v[g];
    const float cy = upwind_select(vg, l, r);
    const float f = arr ? A.dx_cf[m0 ? 0 : g] * vg * cy : vg * cy;
    fy[q] = A.per_cf[g] ? 0.0f : f;
  }
  __syncthreads();
  for (int q = tid; q < TX * TY; q += THREADS) {
    const int a = q / TY, b = q % TY;
    const int i = i0 + a, j = j0 + b;
    if (i >= A.nxp || j >= nyp) continue;
    const float dfx = fx[(a + 1) * TY + b] - fx[a * TY + b];
    const float dfy = fy[a * (TY + 1) + b + 1] - fy[a * (TY + 1) + b];
    A.out[static_cast<size_t>(i) * nyp + j] =
        arr ? (dfx + dfy) / A.az_cc[m0 ? 0 : img_x[a + RX] * nyp + img_y[b + RY]]
            : dfx * A.inv_dx[0] + dfy * A.inv_dy[0];
  }
}

}  // namespace

// ∇·(U c) on the padded (nxp, nyp) arrays into `out` on `stream`.  dy_fc,
// dx_cf and az_cc are null on uniform grids, where inv_dx and inv_dy point
// to 1/Δx and 1/Δy (null with array metrics); with `metrics_0d` 1, dy_fc,
// dx_cf and az_cc point to one value each.
// Scheme kinds: 0 Centered, 1 UpwindBiased, 2 WENO.  `wrap_*`: 1 where the
// direction is periodic and not split across ranks.  Returns 0, or the
// cudaGetLastError() after the launch.
extern "C" int csi_fixed_tile_div(
    const float* u, const float* v, const float* c, const uint8_t* per_fc,
    const uint8_t* per_cf, const float* dy_fc, const float* dx_cf, const float* az_cc,
    const float* inv_dx, const float* inv_dy, const float* tab_x, const float* tab_y,
    int kind_x, int order_x, int kind_y, int order_y, float* out, int nxp, int nyp, int Hx,
    int Nx, int Hy, int Ny, int wrap_x, int wrap_y, int metrics_0d, void* stream) {
  const Scheme sx{kind_x, order_x, tab_x}, sy{kind_y, order_y, tab_y};
  const dim3 block(BX, BY);
  const dim3 grid((nyp + BX - 1) / BX, (nxp + BY - 1) / BY);
  fixed_tile_div<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      u, v, c, per_fc, per_cf, dy_fc, dx_cf, az_cc, inv_dx, inv_dy, sx, sy, out, nxp, nyp, Hx,
      Nx, Hy, Ny, wrap_x, wrap_y, metrics_0d);
  return static_cast<int>(cudaGetLastError());
}

// The tile kernel's entry: arguments as csi_fixed_tile_div's, but the WENO
// tables are host arrays (n_tab_* floats, copied into the launch
// arguments).  Takes the pairs of CSI_TILE_SCHEMES (the same kind and
// order in x and y); returns −1 for any other pair or a table too long, 0,
// or the cudaGetLastError() after the launch.
extern "C" int csi_fixed_tile_div_tiles(
    const float* u, const float* v, const float* c, const uint8_t* per_fc,
    const uint8_t* per_cf, const float* dy_fc, const float* dx_cf, const float* az_cc,
    const float* inv_dx, const float* inv_dy, const float* tab_x, int n_tab_x,
    const float* tab_y, int n_tab_y, int kind_x, int order_x, int kind_y, int order_y,
    float* out, int nxp, int nyp, int Hx, int Nx, int Hy, int Ny, int wrap_x, int wrap_y,
    int metrics_0d, void* stream) {
  if (n_tab_x > MAX_TAB || n_tab_y > MAX_TAB) return -1;
  TileArgs A{u, v, c, per_fc, per_cf, dy_fc, dx_cf, az_cc, inv_dx, inv_dy, out,
             nxp, nyp, Hx, Nx, Hy, Ny, wrap_x, wrap_y, metrics_0d, {}, {}};
  for (int q = 0; q < n_tab_x; ++q) A.tx.v[q] = tab_x[q];
  for (int q = 0; q < n_tab_y; ++q) A.ty.v[q] = tab_y[q];
  const dim3 grid((nyp + TY - 1) / TY, (nxp + TX - 1) / TX);
  const auto s = static_cast<cudaStream_t>(stream);
#define CSI_TILE_CASE(K, O)                                                               \
  if (kind_x == K && order_x == O && kind_y == K && order_y == O) {                       \
    tile_div<K, O, K, O><<<grid, THREADS, 0, s>>>(A);                                     \
    return static_cast<int>(cudaGetLastError());                                          \
  }
  CSI_TILE_SCHEMES(CSI_TILE_CASE)
#undef CSI_TILE_CASE
  return -1;
}

extern "C" const char* csi_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
