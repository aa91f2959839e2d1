// Banded 5-state n-polymer DP + traceback for NVIDIA Hopper (sm_90a).
//
// One warp per window. The band's LW = 64 lanes (2r+1 <= 64, walls at
// b_col 0 and 2r) are held two per thread: thread `lane` owns band columns
// j = 2*lane and 2*lane+1. Rows (anti-diagonals) advance in a loop inside
// the warp; every cell dependency of row t is a row t-1, t-2 or t-n cell at
// a band shift that is uniform across the warp (ops/band_dp.py derives
// them), so each shifted operand is two __shfl_sync. The 5-state history of
// the last 6 rows lives in registers.
//
// Semantics and float32 operation order follow ops/band_dp.py (the plain
// twin, golden-parity tested against golden/align.py = src/aln.pyx:379-787)
// cell for cell: the same adds in the same order and the same strict-<
// tie-breaking. There is no multiply feeding an add (the only products are
// integer-valued penalties, exact in float32), and the file is built with
// -fmad=false; __fadd_rn/__fmul_rn keep every operation separately rounded.
// The LEN/SHR anchor-coordinate planes of band_dp reduce to run > 0 (LEN)
// and run > 0 && a_col != n (SHR): every stored anchor already satisfies
// band_dp's coordinate checks, except a first-column SHR cell, whose source
// lane is exactly a_col == n.
//
// Inputs per window (engine/prepass.py builds them on device):
//   rw    (P, 4) int32  position-linear ref words, read at a_col
//   sw    (P, 2) int32  position-linear seq words, read at a_row - 1
//   inss  (R,)   int32  prefix-I counts per row
//   scal  (8,)   int32  b_rows n_ins n_del ...
// shared: cont (2, max_n, 101, 128) f32 continuation table, sub (25,) f32.
// Outputs per window: slots (R,) uint8 traceback slots (ops/band_dp.tb_slots
// format), bail int32, and the MAT plane (R, LW) int32 (typ | run << 3) as
// scratch for the traceback.

#include <cstdint>
#ifndef NPORE_EMULATE
#include <cmath>
#include <cuda_runtime.h>
#include "xla/ffi/api/ffi.h"
#endif

namespace npore {

constexpr int LW = 64;      // band lanes
constexpr int OFF = 64;     // position offset of rw / sw
constexpr int MAXN = 6;     // periods held in the packed words
constexpr int LDIM = 101;   // n-polymer length rows of the cont table
constexpr int KDIM = 128;   // continuation-depth columns of the cont table
constexpr int SLOT_MAX = 63;
constexpr unsigned FULL = 0xffffffffu;
enum { MAT = 0, INS = 1, LEN = 2, DEL = 3, SHR = 4 };
enum { OP_EQ = 0, OP_X = 1, OP_I = 2, OP_D = 3 };

struct Args {
  const int4* rw;
  const int2* sw;
  const int* inss;
  const int* scal;
  const float* cont;
  const float* sub;
  uint8_t* slots;
  int* bail;
  int* plane;
  int B, R;
  int r, max_n;
  float istart, iext, inf;
};

// o[e] = v at band column (2*lane + e + s), 0 outside [0, LW). s is uniform
// across the warp, so the element choice is too.
template <typename T>
__device__ __forceinline__ void shift2(const T (&v)[2], int s, int lane,
                                       T (&o)[2]) {
  const int h = s >> 1;       // floor(s / 2)
  const int odd = s & 1;
  const T a = odd ? v[1] : v[0];
  const T b = odd ? v[0] : v[1];
  const int l0 = lane + h;
  const int l1 = lane + h + odd;
  const T x0 = __shfl_sync(FULL, a, l0 & 31);
  const T x1 = __shfl_sync(FULL, b, l1 & 31);
  o[0] = (l0 >= 0 && l0 < 32) ? x0 : T(0);
  o[1] = (l1 >= 0 && l1 < 32) ? x1 : T(0);
}

__device__ __forceinline__ float ipen(int x, float inf) {
  return __fmul_rn(__int2float_rn(x), inf);
}

// byte (L | (L_IDX == 0) << 7) of period n at p = a_col (LEN) ...
__device__ __forceinline__ int ll_here(const int4& w, int n) {
  const unsigned u = n <= 4 ? static_cast<unsigned>(w.y) >> (8 * (n - 1))
                            : static_cast<unsigned>(w.z) >> (8 * (n - 5));
  return static_cast<int>(u & 255u);
}

// ... and at p - n (SHR source column)
__device__ __forceinline__ int ll_back(const int4& w, int n) {
  const unsigned u = n <= 2 ? static_cast<unsigned>(w.z) >> (8 * (n + 1))
                            : static_cast<unsigned>(w.w) >> (8 * (n - 3));
  return static_cast<int>(u & 255u);
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ void dp_tb_window(const int w, const int lane, const Args& a) {
  const int R = a.R;
  const int P = R + 2 * OFF;
  const int r = a.r;
  const int4* rw = a.rw + static_cast<size_t>(w) * P;
  const int2* sw = a.sw + static_cast<size_t>(w) * P;
  const int* iv = a.inss + static_cast<size_t>(w) * R;
  int* pl = a.plane + static_cast<size_t>(w) * R * LW;
  uint8_t* so = a.slots + static_cast<size_t>(w) * R;
  const int b_rows = a.scal[w * 8 + 0];
  const int n_ins = a.scal[w * 8 + 1];
  const int n_del = a.scal[w * 8 + 2];
  const float INF = a.inf;
  const float inf_f = INFINITY;

  for (int i = lane * 16; i < R; i += 32 * 16)
    *reinterpret_cast<int4*>(so + i) = make_int4(0, 0, 0, 0);

  // history: [k] = row t-1-k; mtr = MAT typ | run << 3
  float mv[MAXN][2], lav[MAXN][2], sav[MAXN][2];
  int lr[MAXN][2], sr[MAXN][2], mtr[2][2];
  float insv[2] = {0.f, 0.f}, delv[2] = {0.f, 0.f};
  int insr[2] = {0, 0}, delr[2] = {0, 0};
#pragma unroll
  for (int k = 0; k < MAXN; ++k)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      mv[k][e] = 0.f; lav[k][e] = 0.f; sav[k][e] = 0.f;
      lr[k][e] = 0; sr[k][e] = 0;
    }
  mtr[0][0] = mtr[0][1] = mtr[1][0] = mtr[1][1] = 0;
  int ih[MAXN + 1];     // ih[k] = inss[t - k], 0 before row 0
#pragma unroll
  for (int k = 0; k <= MAXN; ++k) ih[k] = 0;
  int ich = 0;

  for (int t = 0; t < b_rows; ++t) {
    if ((t & 31) == 0) {
      const int tt = t + lane;
      ich = tt < R ? iv[tt] : 0;
    }
    const int ii = __shfl_sync(FULL, ich, t & 31);
#pragma unroll
    for (int k = MAXN; k >= 1; --k) ih[k] = ih[k - 1];
    ih[0] = ii;
    const int step1 = ii - ih[1];
    const int dI2 = ii - ih[2];

    int arow[2], acol[2], jj[2];
    bool inr[2], wall[2], live[2];
    int4 RW[2];
    int2 SW[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = 2 * lane + e;
      jj[e] = j;
      arow[e] = ii + r - j;
      acol[e] = (t - ii) - r + j;
      inr[e] = arow[e] >= 0 && acol[e] >= 0 && arow[e] <= n_ins &&
               acol[e] <= n_del;
      wall[e] = j == 0 || j == 2 * r;
      live[e] = inr[e] && !wall[e] && j < 2 * r + 1;
      RW[e] = __ldg(rw + clampi(acol[e] + OFF, 0, P - 1));
      SW[e] = __ldg(sw + clampi(arow[e] - 1 + OFF, 0, P - 1));
    }

    // --- INS (src/aln.pyx:524-543) ---
    float ins_v[2], del_v[2];
    int ins_r[2], del_r[2];
    {
      float mt[2], it[2];
      int irt[2];
      shift2(mv[0], 1 - step1, lane, mt);
      shift2(insv, 1 - step1, lane, it);
      shift2(insr, 1 - step1, lane, irt);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float v1 = __fadd_rn(mt[e], a.istart);
        const float v2 = __fadd_rn(it[e], a.iext);
        const bool use2 = v2 < v1;
        const int run2 = arow[e] == 1 ? 1 : irt[e] + 1;
        ins_v[e] = use2 ? v2 : v1;
        ins_r[e] = use2 ? run2 : 1;
        if (arow[e] == 0) {
          ins_v[e] = ipen(acol[e] + 1, INF);
          ins_r[e] = acol[e];
        }
      }
    }
    // --- DEL (src/aln.pyx:546-565) ---
    {
      float ml[2], dl[2];
      int drl[2];
      shift2(mv[0], -step1, lane, ml);
      shift2(delv, -step1, lane, dl);
      shift2(delr, -step1, lane, drl);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float v1 = __fadd_rn(ml[e], a.istart);
        const float v2 = __fadd_rn(dl[e], a.iext);
        const bool use2 = v2 < v1;
        const int run2 = acol[e] == 1 ? 1 : drl[e] + 1;
        del_v[e] = use2 ? v2 : v1;
        del_r[e] = use2 ? run2 : 1;
        if (acol[e] == 0) {
          del_v[e] = ipen(arow[e] + 1, INF);
          del_r[e] = arow[e];
        }
      }
    }

    // --- LEN / SHR, gather form of src/aln.pyx:601-667 ---
    float len_v[2], len_av[2], shr_v[2], shr_av[2];
    int len_r[2], shr_r[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      len_v[e] = ipen(arow[e] + acol[e], INF);
      shr_v[e] = len_v[e];
      len_av[e] = shr_av[e] = 0.f;
      len_r[e] = shr_r[e] = 0;
    }
#pragma unroll
    for (int n = MAXN; n >= 1; --n) {
      if (n > a.max_n) continue;
      const int ni = n - 1;
      const int dI = ii - ih[n];
      const float* ct0 = a.cont + static_cast<size_t>(ni) * LDIM * KDIM;
      const float* ct1 =
          a.cont + static_cast<size_t>(a.max_n + ni) * LDIM * KDIM;
      {  // LEN source (a_row - n, a_col): row t-n, lane + (n - dI)
        const int s = n - dI;
        float ms[2], avs[2];
        int rs[2];
        shift2(mv[ni], s, lane, ms);
        shift2(lr[ni], s, lane, rs);
        shift2(lav[ni], s, lane, avs);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int src_lane = jj[e] + s;
          const bool src_ok = arow[e] - n >= 0 && src_lane >= 1 &&
                              src_lane <= 2 * r - 1 && t >= n;
          const int b = ll_here(RW[e], n);
          const int l_n = b & 127;
          const unsigned sf = static_cast<unsigned>(SW[e].y) >> (2 * ni);
          const int lenA = clampi(n_ins + 1 - (arow[e] - n), 0, n);
          const int lenB = clampi(n_del + 1 - acol[e], 0, n);
          bool mok = lenA == lenB;
          if (mok && lenA > 0) {
            const unsigned x = (static_cast<unsigned>(SW[e].x) >> (4 * (6 - n))) ^
                               (static_cast<unsigned>(RW[e].x) >> 4);
            mok = (x & ((1u << (4 * lenA)) - 1u)) == 0u;
          }
          const bool valid = src_ok && l_n > 0 && (sf & 1u) && (b >> 7) &&
                             mok && jj[e] > 0;
          if (valid) {
            const bool start = (sf >> 1) & 1u;
            const float* ct = ct0 + l_n * KDIM;
            float cand;
            if (start) {
              cand = __fadd_rn(ms[e], __ldg(ct + 1));
            } else if (rs[e] > 0) {
              const int kc = rs[e] / n + 1;
              cand = __fadd_rn(avs[e], __ldg(ct + (kc < KDIM ? kc : KDIM - 1)));
            } else {
              cand = inf_f;
            }
            if (cand < len_v[e]) {
              len_v[e] = cand;
              len_r[e] = start ? n : rs[e] + n;
              len_av[e] = start ? ms[e] : avs[e];
            }
          }
        }
      }
      {  // SHR source (a_row, a_col - n): row t-n, lane - dI
        const int s = -dI;
        float ms[2], avs[2];
        int rs[2];
        shift2(mv[ni], s, lane, ms);
        shift2(sr[ni], s, lane, rs);
        shift2(sav[ni], s, lane, avs);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int src_lane = jj[e] + s;
          const bool src_ok = acol[e] - n >= 0 && src_lane >= 1 &&
                              src_lane <= 2 * r - 1 && t >= n;
          const int b = ll_back(RW[e], n);
          const int l_n = b & 127;
          const bool valid = src_ok && l_n > 0 && jj[e] < 2 * r;
          if (valid) {
            const bool start = b >> 7;
            const float* ct = ct1 + l_n * KDIM;
            float cand;
            if (start) {
              cand = __fadd_rn(ms[e], __ldg(ct + 1));
            } else if (rs[e] > 0 && acol[e] != n) {
              const int kc = rs[e] / n + 1;
              cand = __fadd_rn(avs[e], __ldg(ct + (kc < KDIM ? kc : KDIM - 1)));
            } else {
              cand = inf_f;
            }
            if (cand < shr_v[e]) {
              shr_v[e] = cand;
              shr_r[e] = start ? n : rs[e] + n;
              shr_av[e] = start ? ms[e] : avs[e];
            }
          }
        }
      }
    }

    // --- MAT (src/aln.pyx:568-592), post overwrites, walls ---
    float md[2];
    int mtd[2];
    shift2(mv[1], 1 - dI2, lane, md);
    shift2(mtr[1], 1 - dI2, lane, mtd);
    const float wall_v = ipen(t + 1, INF);
    float mat_v[2];
    int mat_c[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int sb = (static_cast<unsigned>(SW[e].x) >> 20) & 15u;
      const int rb = static_cast<unsigned>(RW[e].x) & 15u;
      const float sub = __ldg(a.sub + clampi(sb * 5 + rb, 0, 24));
      const bool can = arow[e] > 0 && acol[e] > 0;
      const int run_diag = (mtd[e] & 7) == MAT ? (mtd[e] >> 3) + 1 : 1;
      const float dsum = __fadd_rn(md[e], sub);
      float v1 = can ? dsum : __fadd_rn(del_v[e], INF);
      float mvv = can ? dsum : 0.f;
      int mt = MAT;
      int mr = can ? run_diag : 0;
      if (ins_v[e] < v1) { v1 = ins_v[e]; mvv = ins_v[e]; mt = INS; mr = ins_r[e]; }
      if (len_v[e] < v1) { v1 = len_v[e]; mvv = len_v[e]; mt = LEN; mr = len_r[e]; }
      if (del_v[e] < v1) { v1 = del_v[e]; mvv = del_v[e]; mt = DEL; mr = del_r[e]; }
      if (shr_v[e] < v1) { v1 = shr_v[e]; mvv = shr_v[e]; mt = SHR; mr = shr_r[e]; }

      if (arow[e] == 0) {          // first-row LEN (src/aln.pyx:596-599)
        len_v[e] = ipen(acol[e], INF);
        len_r[e] = acol[e];
      }
      if (acol[e] == 0) {          // first-col SHR (src/aln.pyx:637-640)
        shr_v[e] = ipen(arow[e], INF);
        shr_r[e] = arow[e];
      }
      // walls and out-of-range cells (src/aln.pyx:497-507)
      if (!inr[e]) {
        mvv = 0.f; mt = MAT; mr = 0;
        ins_v[e] = del_v[e] = len_v[e] = shr_v[e] = 0.f;
        ins_r[e] = del_r[e] = len_r[e] = shr_r[e] = 0;
      } else if (wall[e]) {
        mvv = ins_v[e] = del_v[e] = len_v[e] = shr_v[e] = wall_v;
        mt = MAT;
        mr = ins_r[e] = del_r[e] = len_r[e] = shr_r[e] = 0;
      }
      if (!live[e]) len_av[e] = shr_av[e] = 0.f;
      mat_v[e] = mvv;
      mat_c[e] = mt | (mr << 3);
    }
    *reinterpret_cast<int2*>(pl + static_cast<size_t>(t) * LW + 2 * lane) =
        make_int2(mat_c[0], mat_c[1]);

#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int k = MAXN - 1; k >= 1; --k) {
        mv[k][e] = mv[k - 1][e];
        lr[k][e] = lr[k - 1][e];
        lav[k][e] = lav[k - 1][e];
        sr[k][e] = sr[k - 1][e];
        sav[k][e] = sav[k - 1][e];
      }
      mv[0][e] = mat_v[e];
      lr[0][e] = len_r[e];
      lav[0][e] = len_av[e];
      sr[0][e] = shr_r[e];
      sav[0][e] = shr_av[e];
      mtr[1][e] = mtr[0][e];
      mtr[0][e] = mat_c[e];
      insv[e] = ins_v[e];
      insr[e] = ins_r[e];
      delv[e] = del_v[e];
      delr[e] = del_r[e];
    }
  }
  __syncwarp();

  // --- traceback (src/aln.pyx:670-742), emitting ops/band_dp.tb_slots bytes
  if (lane != 0) return;
  int arow = n_ins, acol = n_del, t = n_ins + n_del;
  bool bail = false;
  bool done = arow <= 0 && acol <= 0;
  while (!done) {
    const int ln = iv[t] - arow + r;
    if (ln < 0 || ln >= LW) { bail = true; break; }
    const int cv = pl[static_cast<size_t>(t) * LW + ln];
    const int typ = cv & 7;
    const int run = cv >> 3;
    if (run < 1) { bail = true; break; }
    if (typ == MAT) {
      for (int k = 0; k < run; ++k) {
        const int q = clampi(arow - 1 + OFF, 0, P - 1);
        const int p = clampi(acol + OFF, 0, P - 1);
        const int sb = (static_cast<unsigned>(sw[q].x) >> 20) & 15u;
        const int rb = static_cast<unsigned>(rw[p].x) & 15u;
        so[t] = static_cast<uint8_t>((sb == rb ? OP_EQ : OP_X) | (1 << 2));
        --arow;
        --acol;
        t -= 2;
        if (arow < 0 || acol < 0) { bail = true; break; }
        if (arow <= 0 && acol <= 0) { done = true; break; }
      }
      if (bail) break;
    } else {
      const bool is_i = typ == INS || typ == LEN;
      const int op = is_i ? OP_I : OP_D;
      int rem = run;
      for (int row = t; rem > 0 && row >= 0; --row) {
        const int c = rem < SLOT_MAX ? rem : SLOT_MAX;
        so[row] = static_cast<uint8_t>(op | (c << 2));
        rem -= c;
      }
      if (is_i) arow -= run; else acol -= run;
      t -= run;
      if (arow < 0 || acol < 0) { bail = true; break; }
      done = arow <= 0 && acol <= 0;
    }
  }
  a.bail[w] = (bail || !done) ? 1 : 0;
}

__global__ void __launch_bounds__(128) dp_tb_kernel(Args a) {
  const int w = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (w < a.B) dp_tb_window(w, threadIdx.x & 31, a);
}

}  // namespace npore

#ifndef NPORE_EMULATE
namespace ffi = xla::ffi;

static ffi::Error DpTbImpl(cudaStream_t stream, ffi::Buffer<ffi::S32> rw,
                           ffi::Buffer<ffi::S32> sw, ffi::Buffer<ffi::S32> inss,
                           ffi::Buffer<ffi::S32> scal,
                           ffi::Buffer<ffi::F32> cont,
                           ffi::Buffer<ffi::F32> sub,
                           ffi::ResultBuffer<ffi::U8> slots,
                           ffi::ResultBuffer<ffi::S32> bail,
                           ffi::ResultBuffer<ffi::S32> plane, int32_t r,
                           int32_t max_n, float istart, float iext,
                           float inf) {
  const auto dims = inss.dimensions();
  if (dims.size() != 2) {
    return ffi::Error(ffi::ErrorCode::kInvalidArgument, "inss must be (B, R)");
  }
  npore::Args a;
  a.B = static_cast<int>(dims[0]);
  a.R = static_cast<int>(dims[1]);
  if (a.R % 16 != 0 || 2 * r + 1 > npore::LW || max_n > npore::MAXN ||
      rw.element_count() != static_cast<size_t>(a.B) * (a.R + 2 * npore::OFF) * 4) {
    return ffi::Error(ffi::ErrorCode::kInvalidArgument,
                      "npore dp_tb: operand shapes do not match");
  }
  a.rw = reinterpret_cast<const int4*>(rw.typed_data());
  a.sw = reinterpret_cast<const int2*>(sw.typed_data());
  a.inss = inss.typed_data();
  a.scal = scal.typed_data();
  a.cont = cont.typed_data();
  a.sub = sub.typed_data();
  a.slots = slots->typed_data();
  a.bail = bail->typed_data();
  a.plane = plane->typed_data();
  a.r = r;
  a.max_n = max_n;
  a.istart = istart;
  a.iext = iext;
  a.inf = inf;
  if (a.B == 0) return ffi::Error::Success();
  constexpr int kWarps = 4;
  const int blocks = (a.B + kWarps - 1) / kWarps;
  npore::dp_tb_kernel<<<blocks, 32 * kWarps, 0, stream>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return ffi::Error(ffi::ErrorCode::kInternal, cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

XLA_FFI_DEFINE_HANDLER_SYMBOL(NporeDpTb, DpTbImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()  // rw
                                  .Arg<ffi::Buffer<ffi::S32>>()  // sw
                                  .Arg<ffi::Buffer<ffi::S32>>()  // inss
                                  .Arg<ffi::Buffer<ffi::S32>>()  // scal
                                  .Arg<ffi::Buffer<ffi::F32>>()  // cont
                                  .Arg<ffi::Buffer<ffi::F32>>()  // sub
                                  .Ret<ffi::Buffer<ffi::U8>>()   // slots
                                  .Ret<ffi::Buffer<ffi::S32>>()  // bail
                                  .Ret<ffi::Buffer<ffi::S32>>()  // plane
                                  .Attr<int32_t>("r")
                                  .Attr<int32_t>("max_n")
                                  .Attr<float>("istart")
                                  .Attr<float>("iext")
                                  .Attr<float>("inf"));
#endif
