// Runs the CUDA kernel source npore_tpu/ops/cuda/dp_tb.cu on the CPU: the
// 32 lanes of a warp are cooperative contexts on one thread, switched at
// every __shfl_sync / __syncwarp, which are barriers over the live lanes.
// Built with g++ by tests/test_cuda_emulated.py; it checks the kernel's
// logic against the plain-JAX twin where there is no GPU.
#define NPORE_EMULATE 1
#include <ucontext.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

struct int2 { int x, y; };
struct int4 { int x, y, z, w; };
static inline int2 make_int2(int x, int y) { return {x, y}; }
static inline int4 make_int4(int x, int y, int z, int w) { return {x, y, z, w}; }
struct Dim3 { unsigned x; };

namespace emu {
constexpr int kLanes = 32;
static ucontext_t main_ctx, lane_ctx[kLanes];
static std::vector<char> stacks[kLanes];
static bool alive[kLanes];
static int cur, n_alive, arrived;
static unsigned gen;
static uint32_t slot[kLanes];

static void yield() {
  const int me = cur;
  for (int k = 1; k <= kLanes; ++k) {
    const int nx = (me + k) % kLanes;
    if (alive[nx]) {
      if (nx == me) return;
      cur = nx;
      swapcontext(&lane_ctx[me], &lane_ctx[nx]);
      return;
    }
  }
}

static void barrier() {
  const unsigned g = gen;
  if (++arrived == n_alive) {
    arrived = 0;
    ++gen;
    return;
  }
  while (gen == g) yield();
}

template <typename T>
static T shfl(unsigned, T v, int src) {
  static_assert(sizeof(T) == 4, "32-bit shuffles only");
  uint32_t b;
  std::memcpy(&b, &v, 4);
  slot[cur] = b;
  barrier();
  const uint32_t got = slot[src & 31];
  barrier();
  T out;
  std::memcpy(&out, &got, 4);
  return out;
}
}  // namespace emu

#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shfl_sync(m, v, s) emu::shfl((m), (v), (s))
#define __syncwarp() emu::barrier()
#define __ldg(p) (*(p))
#define __fadd_rn(a, b) ((a) + (b))
#define __fmul_rn(a, b) ((a) * (b))
#define __int2float_rn(x) static_cast<float>(x)
static Dim3 blockIdx, blockDim, threadIdx;

#include "../../npore_tpu/ops/cuda/dp_tb.cu"

namespace emu {
static const npore::Args* g_args;
static int g_w;

static void lane_main(int lane) {
  npore::dp_tb_window(g_w, lane, *g_args);
  alive[lane] = false;
  --n_alive;
  if (n_alive > 0 && arrived == n_alive) {  // release a pending barrier
    arrived = 0;
    ++gen;
  }
  for (int k = 1; k <= kLanes; ++k) {
    const int nx = (lane + k) % kLanes;
    if (alive[nx]) {
      cur = nx;
      setcontext(&lane_ctx[nx]);
    }
  }
  setcontext(&main_ctx);
}

static void run_warp(int w, const npore::Args& a) {
  g_args = &a;
  g_w = w;
  n_alive = kLanes;
  arrived = 0;
  for (int l = 0; l < kLanes; ++l) {
    alive[l] = true;
    stacks[l].resize(1 << 18);
    getcontext(&lane_ctx[l]);
    lane_ctx[l].uc_stack.ss_sp = stacks[l].data();
    lane_ctx[l].uc_stack.ss_size = stacks[l].size();
    lane_ctx[l].uc_link = &main_ctx;
    makecontext(&lane_ctx[l], reinterpret_cast<void (*)()>(lane_main), 1, l);
  }
  cur = 0;
  swapcontext(&main_ctx, &lane_ctx[0]);
}
}  // namespace emu

extern "C" void emulate_dp_tb(const int32_t* rw, const int32_t* sw,
                              const int32_t* inss, const int32_t* scal,
                              const float* cont, const float* sub,
                              uint8_t* slots, int32_t* bail, int32_t* plane,
                              int B, int R, int r, int max_n, float istart,
                              float iext, float inf) {
  npore::Args a;
  a.rw = reinterpret_cast<const int4*>(rw);
  a.sw = reinterpret_cast<const int2*>(sw);
  a.inss = inss;
  a.scal = scal;
  a.cont = cont;
  a.sub = sub;
  a.slots = slots;
  a.bail = bail;
  a.plane = plane;
  a.B = B;
  a.R = R;
  a.r = r;
  a.max_n = max_n;
  a.istart = istart;
  a.iext = iext;
  a.inf = inf;
  for (int w = 0; w < B; ++w) emu::run_warp(w, a);
}
