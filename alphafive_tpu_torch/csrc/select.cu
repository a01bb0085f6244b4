// Batched PUCT descent over a packed MCTS tree for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel alphafive_tpu/ops/pallas_select.py::
// select_batch (body _select_kernel). The tree of env e is
// packed[e, NN, 8, A_pad] (f32): sections N, W, signed P (illegal and pad
// cells store -1), child id as a float (-1 = unexpanded) and a terminal
// flag in slot 0 of section 4. From node 0 each env follows
//
//     score(a) = Q(a) + c_puct * P(a) * sqrt(1 + sum N) / (1 + N(a))
//
// over legal actions (P >= 0 and a < num_actions), a root child owed
// forced playouts (N^2 < k * P * sum N) scoring +inf, ties to the lowest
// action, until an unexpanded edge, a terminal node or the depth cap. It
// writes the leaf's parent node, the action to expand (-1 = revisit), the
// path length and the path's nodes and actions [E, D], zero beyond the
// path, exactly as the plain version ops/select.py::select_batch_reference
// does: the score and the gate use round-to-nearest intrinsics in the plain
// version's op order, so no multiply-add is contracted and the argmax is
// bit-equal (one flipped argmax changes the search's visit counts).
//
// What bounds it on this card: latency. A descent is a dependent chain:
// each step's row address is the previous step's argmax, and a search
// launches the kernel once per simulation, so a launch costs the launch
// floor plus, for the longest descent in the batch, one device-memory
// round trip per step and the arithmetic between two round trips.
// Bandwidth is not the limit (16 envs read 80 KB a step). Both inputs are
// measured on the card by benchmarks/select_profile.py: the device time of
// an empty launch (~1.3 us on an H100 80GB HBM3 at 700 W) and one dependent
// 16-byte-per-lane load of a row in L2 (~180 ns, ~345 SM cycles);
// chip_smoke.py's latency_bound_ms = floor + max steps x round trip. A
// step here takes ~2,300 cycles: one warp issues all of a row's arithmetic.
//
// What the design does about it:
//   * One warp per env, one warp per block: an env's step never waits on
//     a barrier or on shared memory, and the blocks spread over the SMs
//     (132 SMs x 32 blocks hold 4,224 envs at once; paths launch <= 256).
//   * One round trip per step. Each lane issues all its loads of the row
//     before it uses any: 16-byte loads of sections N, W, P and child, lane
//     l holding actions 4l + 128j .. 4l + 128j + 3 for j < A_pad / 128,
//     and the terminal flag in the same round.
//   * sum N is an xor-shuffle sum (exact in any order: integer-valued
//     floats below 2^24), the argmax an xor-shuffle (score, index)
//     reduction under better(), a total order, so every lane ends with the
//     same winner and the lowest index among equal scores.
//   * A lane holds 8 actions (12 at 19x19), and a correctly rounded
//     division costs a branch and a possible slow subroutine that the whole
//     warp waits on. An action with N = 0, most of a row, needs none (its
//     score is c_puct * P * sqrt(1 + sum N) bit for bit); a visited one gets
//     an approximate score with a safe margin first, and only those that
//     could still be the lane's best take the two exact divisions, on
//     operands that keep them on the fast path.
//   * The chosen child id comes from the lane that holds it by one
//     shuffle, not from a second load. Every lane then knows the next row;
//     lane 0 writes the path entry, a store nothing waits on.
//
// Rows wider than 8 chunks (A_pad > 1024, boards above 32x32) do not fit
// in a lane's registers. select_stream_kernel takes them: the same warp
// per env, but each step streams the row in groups of 8 chunks, twice.
// The first pass sums N (exact in any order); the second scores each slot
// exactly (the plain formula's two divisions, no approximate filter) and
// carries the lane's running (score, index) best under better(), with the
// child id of that best, so the argmax, the first-maximum tie rule and the
// child's shuffle are those of the register-resident kernel.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kChunk = 4 * kWarp;  // actions one float4 per lane covers
constexpr int kMaxChunks = 8;      // register-resident rows: A_pad <= 1024
constexpr int kNumSec = 8;
constexpr int kSecN = 0, kSecW = 1, kSecP = 2, kSecChild = 3, kSecMeta = 4;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool better(float s, int i, float best, int bi) {
  return s > best || (s == best && i < bi);
}

__device__ __forceinline__ float elem(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// 1 / x within 1 ulp (rcp.approx; subnormal input and output flushed)
__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// the action in slot k of `lane`: float4 k / 4 of the lane's, element k % 4
__device__ __forceinline__ int action(int k, int lane) {
  return k / 4 * kChunk + 4 * lane + k % 4;
}

// J = A_pad / 128 float4 chunks per lane and section
template <int J>
__global__ void __launch_bounds__(kWarp)
    select_kernel(const float* __restrict__ packed, int nn, int num_actions,
                  int depth_limit, float c_puct, float forced_k,
                  int* __restrict__ leaf_out, int* __restrict__ act_out,
                  int* __restrict__ depth_out, int* __restrict__ pn,
                  int* __restrict__ pa) {
  constexpr int K = 4 * J;   // actions per lane
  constexpr int a_pad = J * kChunk;
  constexpr size_t row_len = static_cast<size_t>(kNumSec) * a_pad;
  const int env = blockIdx.x;
  const int lane = threadIdx.x;
  const float* tree = packed + static_cast<size_t>(env) * nn * row_len;
  int* pn_row = pn + static_cast<size_t>(env) * depth_limit;
  int* pa_row = pa + static_cast<size_t>(env) * depth_limit;

  int cur = 0, depth = 0, act = -1;
  bool stopped = false;
  for (int it = 0; it < depth_limit; ++it) {
    // stamp: 0 cur
    const float* row = tree + static_cast<size_t>(cur) * row_len;
    const float4* row4 = reinterpret_cast<const float4*>(row);
    float4 n4[J], w4[J], p4[J], c4[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int q = j * kWarp + lane;   // float4 index within a section
      n4[j] = __ldg(row4 + kSecN * a_pad / 4 + q);
      w4[j] = __ldg(row4 + kSecW * a_pad / 4 + q);
      p4[j] = __ldg(row4 + kSecP * a_pad / 4 + q);
      c4[j] = __ldg(row4 + kSecChild * a_pad / 4 + q);
    }
    const float terminal = __ldg(row + kSecMeta * a_pad);
    // slot k = 4j + i of this lane is action 128j + 4 lane + i
    float nv[K], wv[K], pv[K], cv[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      nv[k] = elem(n4[k / 4], k % 4);
      wv[k] = elem(w4[k / 4], k % 4);
      pv[k] = elem(p4[k / 4], k % 4);
      cv[k] = elem(c4[k / 4], k % 4);
    }

    float total = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) total = __fadd_rn(total, nv[k]);
    // stamp: 1 total
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      total = __fadd_rn(total, __shfl_xor_sync(kFull, total, off));
    const float ns = __fadd_rn(1.0f, total);
    const float sqrt_ns = __fsqrt_rn(ns);
    const float ns_m1 = __fsub_rn(ns, 1.0f);
    // stamp: 2 sqrt_ns

    // Every slot's score: exact where it needs no division (illegal:
    // -inf; a root child owed forced playouts: +inf, the gate being exact
    // products; N = 0: Q = 0 and 1 + N = 1, so the plain score is
    // c_puct * P * sqrt(ns) bit for bit), and for a visited slot an
    // approximate one, W rcp(N) + x rcp(1 + N) with rcp.approx (1 ulp),
    // which lies within m = 2^-16 (|q~| + |u~|) + 2^-120 of the exact
    // score: over 30 times the 4 ulp that the quotients and the two sums
    // can differ by. A visited slot whose interval reaches the lane's best
    // lower bound is scored exactly below; the others cannot be the lane's
    // maximum. A slot with N outside [1, 2^24) (never in a search's tree)
    // is always scored exactly. All of it branch-free: one warp issues
    // every instruction of its 8 (12) slots, so per-slot work is the cost.
    float sv[K], mv[K];
    int ix[K];
    float lower = -INFINITY;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      ix[k] = action(k, lane);
      const bool legal = pv[k] >= 0.0f && ix[k] < num_actions;
      const float pp = fmaxf(pv[k], 0.0f);
      const float x = __fmul_rn(__fmul_rn(c_puct, pp), sqrt_ns);
      const bool forced =
          legal && depth == 0 && nv[k] > 0.0f &&
          __fmul_rn(nv[k], nv[k]) < __fmul_rn(__fmul_rn(forced_k, pp), ns_m1);
      const bool approx = legal && !forced && nv[k] != 0.0f;
      const float qa = __fmul_rn(wv[k], rcp_approx(nv[k]));
      const float ua = __fmul_rn(x, rcp_approx(__fadd_rn(1.0f, nv[k])));
      const float sa = __fadd_rn(qa, ua);
      const float ma =
          __fmaf_rn(0x1p-16f, __fadd_rn(fabsf(qa), fabsf(ua)), 0x1p-120f);
      const bool sane = nv[k] >= 1.0f && nv[k] < 0x1p24f && ma < INFINITY;
      sv[k] = !legal ? -INFINITY : forced ? INFINITY : approx ? sa : x;
      mv[k] = !approx ? 0.0f : sane ? ma : INFINITY;
      lower = fmaxf(lower, !approx ? sv[k]
                           : sane  ? __fsub_rd(sa, ma)
                                   : -INFINITY);
    }
    unsigned verify = 0;   // bit k: slot k takes the exact score
    float s[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const bool exact = mv[k] == 0.0f;
      verify |= static_cast<unsigned>(
                    !exact && !(__fadd_ru(sv[k], mv[k]) < lower)) << k;
      s[k] = exact ? sv[k] : -INFINITY;
    }
#pragma unroll
    for (int w = 1; w < K; w *= 2) {
#pragma unroll
      for (int k = 0; k + w < K; k += 2 * w) {
        const bool take = better(s[k + w], ix[k + w], s[k], ix[k]);
        s[k] = take ? s[k + w] : s[k];
        ix[k] = take ? ix[k + w] : ix[k];
      }
    }
    float best = s[0];
    int bidx = ix[0];
    // stamp: 3 best
    // The exact scores, two divisions each, in as many rounds as the
    // busiest lane has slots to verify (one, mostly), each lane taking its
    // next; a lane with none left scores its slot 0 as -inf.
    const int rounds = __reduce_max_sync(kFull, __popc(verify));
    for (int r = 0; r < rounds; ++r) {
      const bool live = verify != 0;
      const int ks = live ? __ffs(verify) - 1 : 0;
      verify &= verify - 1;
      float nk = nv[0], wk = wv[0], pk = pv[0];
#pragma unroll
      for (int k = 1; k < K; ++k) {
        nk = k == ks ? nv[k] : nk;
        wk = k == ks ? wv[k] : wk;
        pk = k == ks ? pv[k] : pk;
      }
      const int a = action(ks, lane);
      // The plain formula's two divisions (the slot is legal, no forced
      // playout). A division whose dividend is zero (or whose lane has no
      // slot left) leaves the fast path of __fdiv_rn for a slow
      // subroutine that the whole warp then waits on; a zero over a
      // positive divisor is that zero, sign and all, so those lanes divide
      // 1 by 1 instead and keep the zero.
      const float wq = live && wk != 0.0f ? wk : 1.0f;
      const float qd = __fdiv_rn(wq, fmaxf(nk, 1.0f));
      const float q = nk > 0.0f ? (wk == 0.0f ? wk : qd) : 0.0f;
      const float xu = __fmul_rn(__fmul_rn(c_puct, fmaxf(pk, 0.0f)), sqrt_ns);
      const float du = __fadd_rn(1.0f, nk);
      const bool keep = xu == 0.0f && du > 0.0f;   // u = xu exactly
      const bool divide = live && !keep;
      const float ud = __fdiv_rn(divide ? xu : 1.0f, divide ? du : 1.0f);
      const float u = keep ? xu : ud;
      const float score = live ? __fadd_rn(q, u) : -INFINITY;
      const bool take = better(score, a, best, bidx);
      best = take ? score : best;
      bidx = take ? a : bidx;
    }
    // stamp: 4 best
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(kFull, best, off);
      const int oi = __shfl_xor_sync(kFull, bidx, off);
      if (better(ob, oi, best, bidx)) {
        best = ob;
        bidx = oi;
      }
    }
    // stamp: 5 bidx

    // child[bidx] from the lane that loaded it
    const int cs = bidx / kChunk * 4 + bidx % 4;
    float mine = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (k == cs) mine = cv[k];
    const int ch = static_cast<int>(
        __shfl_sync(kFull, mine, (bidx % kChunk) / 4));
    const bool revisit = terminal > 0.5f || depth >= depth_limit;
    if (!revisit) {  // depth == it while the descent is live
      if (lane == 0) {
        pn_row[depth] = cur;
        pa_row[depth] = bidx;
      }
      ++depth;
    }
    act = revisit ? -1 : bidx;
    // stamp: 6 ch
    if (revisit || ch < 0) {
      stopped = true;
      break;
    }
    cur = ch;
  }

  if (lane == 0) {
    leaf_out[env] = cur;
    // a descent that never stopped hit the depth cap: revisit its node
    act_out[env] = stopped ? act : -1;
    depth_out[env] = depth;
  }
  for (int i = depth + lane; i < depth_limit; i += kWarp) {
    pn_row[i] = 0;
    pa_row[i] = 0;
  }
}

// The exact score of one slot, the plain version's formula and op order.
__device__ __forceinline__ float exact_score(float n, float w, float p, int a,
                                             int num_actions, int depth,
                                             float c_puct, float forced_k,
                                             float sqrt_ns, float ns_m1) {
  const bool legal = p >= 0.0f && a < num_actions;
  const float pp = fmaxf(p, 0.0f);
  const float x = __fmul_rn(__fmul_rn(c_puct, pp), sqrt_ns);
  const bool forced =
      legal && depth == 0 && n > 0.0f &&
      __fmul_rn(n, n) < __fmul_rn(__fmul_rn(forced_k, pp), ns_m1);
  const float q = n > 0.0f ? __fdiv_rn(w, fmaxf(n, 1.0f)) : 0.0f;
  const float u = __fdiv_rn(x, __fadd_rn(1.0f, n));
  return !legal ? -INFINITY : forced ? INFINITY : __fadd_rn(q, u);
}

// A_pad = J * 128 for any J: the row streamed in groups of kMaxChunks
// chunks (lane l holds actions 128 j + 4 l + i, as above), twice a step.
__global__ void __launch_bounds__(kWarp)
    select_stream_kernel(const float* __restrict__ packed, int nn, int a_pad,
                         int num_actions, int depth_limit, float c_puct,
                         float forced_k, int* __restrict__ leaf_out,
                         int* __restrict__ act_out,
                         int* __restrict__ depth_out, int* __restrict__ pn,
                         int* __restrict__ pa) {
  constexpr int G = kMaxChunks;
  const int J = a_pad / kChunk;
  const size_t row_len = static_cast<size_t>(kNumSec) * a_pad;
  const int env = blockIdx.x;
  const int lane = threadIdx.x;
  const float* tree = packed + static_cast<size_t>(env) * nn * row_len;
  int* pn_row = pn + static_cast<size_t>(env) * depth_limit;
  int* pa_row = pa + static_cast<size_t>(env) * depth_limit;

  int cur = 0, depth = 0, act = -1;
  bool stopped = false;
  for (int it = 0; it < depth_limit; ++it) {
    const float* row = tree + static_cast<size_t>(cur) * row_len;
    const float4* row4 = reinterpret_cast<const float4*>(row);
    const float terminal = __ldg(row + kSecMeta * a_pad);
    float total = 0.0f;
    for (int j0 = 0; j0 < J; j0 += G) {
      float4 n4[G];
#pragma unroll
      for (int g = 0; g < G; ++g)
        if (j0 + g < J)
          n4[g] = __ldg(row4 + kSecN * a_pad / 4 + (j0 + g) * kWarp + lane);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (j0 + g >= J) continue;
#pragma unroll
        for (int i = 0; i < 4; ++i) total = __fadd_rn(total, elem(n4[g], i));
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      total = __fadd_rn(total, __shfl_xor_sync(kFull, total, off));
    const float ns = __fadd_rn(1.0f, total);
    const float sqrt_ns = __fsqrt_rn(ns);
    const float ns_m1 = __fsub_rn(ns, 1.0f);

    float best = -INFINITY, child = -1.0f;
    int bidx = a_pad;
    for (int j0 = 0; j0 < J; j0 += G) {
      float4 n4[G], w4[G], p4[G], c4[G];
#pragma unroll
      for (int g = 0; g < G; ++g)
        if (j0 + g < J) {
          const int q = (j0 + g) * kWarp + lane;
          n4[g] = __ldg(row4 + kSecN * a_pad / 4 + q);
          w4[g] = __ldg(row4 + kSecW * a_pad / 4 + q);
          p4[g] = __ldg(row4 + kSecP * a_pad / 4 + q);
          c4[g] = __ldg(row4 + kSecChild * a_pad / 4 + q);
        }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (j0 + g >= J) continue;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int a = (j0 + g) * kChunk + 4 * lane + i;
          const float s = exact_score(elem(n4[g], i), elem(w4[g], i),
                                      elem(p4[g], i), a, num_actions, depth,
                                      c_puct, forced_k, sqrt_ns, ns_m1);
          if (better(s, a, best, bidx)) {
            best = s;
            bidx = a;
            child = elem(c4[g], i);
          }
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(kFull, best, off);
      const int oi = __shfl_xor_sync(kFull, bidx, off);
      if (better(ob, oi, best, bidx)) {
        best = ob;
        bidx = oi;
      }
    }
    // the winner is the best of the lane that holds it: its child id
    const int ch = static_cast<int>(
        __shfl_sync(kFull, child, (bidx % kChunk) / 4));
    const bool revisit = terminal > 0.5f || depth >= depth_limit;
    if (!revisit) {
      if (lane == 0) {
        pn_row[depth] = cur;
        pa_row[depth] = bidx;
      }
      ++depth;
    }
    act = revisit ? -1 : bidx;
    if (revisit || ch < 0) {
      stopped = true;
      break;
    }
    cur = ch;
  }

  if (lane == 0) {
    leaf_out[env] = cur;
    act_out[env] = stopped ? act : -1;
    depth_out[env] = depth;
  }
  for (int i = depth + lane; i < depth_limit; i += kWarp) {
    pn_row[i] = 0;
    pa_row[i] = 0;
  }
}

template <int J>
cudaError_t launch(const float* packed, int e, int nn, int num_actions,
                   int depth_limit, float c_puct, float forced_k, int* leaf,
                   int* act, int* depth, int* pn, int* pa,
                   cudaStream_t stream) {
  select_kernel<J><<<e, kWarp, 0, stream>>>(packed, nn, num_actions,
                                            depth_limit, c_puct, forced_k,
                                            leaf, act, depth, pn, pa);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t (0 on success); the caller has checked shapes,
// type and contiguity. Launches on `stream` and does not synchronise.
extern "C" int alphafive_select(const void* packed, int e, int nn, int a_pad,
                                int num_actions, int depth_limit,
                                float c_puct, float forced_k, void* leaf,
                                void* act, void* depth, void* pn, void* pa,
                                void* stream) {
  if (e == 0) return cudaSuccess;
  if (a_pad % kChunk != 0 || a_pad < kChunk || depth_limit < 1 ||
      depth_limit > nn)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(packed) % 16 != 0)
    return cudaErrorMisalignedAddress;
  const auto* p = static_cast<const float*>(packed);
  auto* l = static_cast<int*>(leaf);
  auto* a = static_cast<int*>(act);
  auto* d = static_cast<int*>(depth);
  auto* n = static_cast<int*>(pn);
  auto* x = static_cast<int*>(pa);
  auto* s = static_cast<cudaStream_t>(stream);
  switch (a_pad / kChunk) {
    case 1: return launch<1>(p, e, nn, num_actions, depth_limit, c_puct,
                             forced_k, l, a, d, n, x, s);
    case 2: return launch<2>(p, e, nn, num_actions, depth_limit, c_puct,
                             forced_k, l, a, d, n, x, s);
    case 3: return launch<3>(p, e, nn, num_actions, depth_limit, c_puct,
                             forced_k, l, a, d, n, x, s);
    case 4: return launch<4>(p, e, nn, num_actions, depth_limit, c_puct,
                             forced_k, l, a, d, n, x, s);
    case 5: return launch<5>(p, e, nn, num_actions, depth_limit, c_puct,
                             forced_k, l, a, d, n, x, s);
    case 6: return launch<6>(p, e, nn, num_actions, depth_limit, c_puct,
                             forced_k, l, a, d, n, x, s);
    case 7: return launch<7>(p, e, nn, num_actions, depth_limit, c_puct,
                             forced_k, l, a, d, n, x, s);
    case 8: return launch<8>(p, e, nn, num_actions, depth_limit, c_puct,
                             forced_k, l, a, d, n, x, s);
  }
  select_stream_kernel<<<e, kWarp, 0, s>>>(p, nn, a_pad, num_actions,
                                           depth_limit, c_puct, forced_k, l,
                                           a, d, n, x);
  return cudaGetLastError();
}
