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
// What bounds it on this card: a dependent chain. Each step reads one row
// of five sections (5 KB at A_pad = 256) whose address is the previous
// step's argmax, so a step costs a device-memory round trip plus two block
// reductions, and a descent is up to depth_limit steps long. Bandwidth is
// not the limit: 16 envs read 80 KB per step.
//
// What the design does about it (a simple first version, not a tuned one):
//   * One block of 128 threads per env, so envs descend in parallel on
//     separate SMs and a block never waits on another env's chain.
//   * Each step the block reads sections 0-2 of the current row with
//     coalesced loads, lane a in thread a % 128; the child id and terminal
//     flag are one load each by thread 0.
//   * sum N is a block reduction (exact: integer-valued floats below 2^24),
//     the argmax a block-wide (score, index) reduction that keeps the lower
//     index on ties; thread 0 records the path entry and broadcasts the
//     next node through shared memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLanes = 8;  // lanes per thread: A_pad <= 1024
constexpr int kNumSec = 8;
constexpr int kSecN = 0, kSecW = 1, kSecP = 2, kSecChild = 3, kSecMeta = 4;

__device__ __forceinline__ bool better(float s, int i, float best, int bi) {
  return s > best || (s == best && i < bi);
}

__global__ void __launch_bounds__(kThreads)
    select_kernel(const float* __restrict__ packed, int nn, int a_pad,
                  int num_actions, int depth_limit, float c_puct,
                  float forced_k, int* __restrict__ leaf_out,
                  int* __restrict__ act_out, int* __restrict__ depth_out,
                  int* __restrict__ pn, int* __restrict__ pa) {
  const int env = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane_id = tid & 31;
  const int per = a_pad / kThreads;

  __shared__ float s_sum[kWarps];
  __shared__ float s_best[kWarps];
  __shared__ int s_bidx[kWarps];
  __shared__ int s_cur, s_depth, s_act, s_stop;

  if (tid == 0) {
    s_cur = 0;
    s_depth = 0;
    s_act = -1;
    s_stop = 0;
  }
  __syncthreads();

  const size_t row_len = static_cast<size_t>(kNumSec) * a_pad;
  const float* tree = packed + static_cast<size_t>(env) * nn * row_len;
  int* pn_row = pn + static_cast<size_t>(env) * depth_limit;
  int* pa_row = pa + static_cast<size_t>(env) * depth_limit;

  for (int it = 0; it < depth_limit && !s_stop; ++it) {
    const int cur = s_cur;
    const int depth = s_depth;
    const float* row = tree + static_cast<size_t>(cur) * row_len;

    float n[kMaxLanes], w[kMaxLanes], p[kMaxLanes];
    float part = 0.0f;
#pragma unroll
    for (int k = 0; k < kMaxLanes; ++k) {
      if (k < per) {
        const int a = tid + k * kThreads;
        n[k] = row[kSecN * a_pad + a];
        w[k] = row[kSecW * a_pad + a];
        p[k] = row[kSecP * a_pad + a];
        part = __fadd_rn(part, n[k]);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, off));
    if (lane_id == 0) s_sum[warp] = part;
    __syncthreads();
    float total = 0.0f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) total = __fadd_rn(total, s_sum[i]);
    const float ns = __fadd_rn(1.0f, total);
    const float sqrt_ns = __fsqrt_rn(ns);
    const float ns_m1 = __fsub_rn(ns, 1.0f);

    float best = -INFINITY;
    int bidx = a_pad;
#pragma unroll
    for (int k = 0; k < kMaxLanes; ++k) {
      if (k < per) {
        const int a = tid + k * kThreads;
        const bool legal = p[k] >= 0.0f && a < num_actions;
        const float pp = fmaxf(p[k], 0.0f);
        const float q =
            n[k] > 0.0f ? __fdiv_rn(w[k], fmaxf(n[k], 1.0f)) : 0.0f;
        const float u = __fdiv_rn(__fmul_rn(__fmul_rn(c_puct, pp), sqrt_ns),
                                  __fadd_rn(1.0f, n[k]));
        float score = legal ? __fadd_rn(q, u) : -INFINITY;
        const bool forced =
            legal && depth == 0 && n[k] > 0.0f &&
            __fmul_rn(n[k], n[k]) < __fmul_rn(__fmul_rn(forced_k, pp), ns_m1);
        if (forced) score = INFINITY;
        if (better(score, a, best, bidx)) {
          best = score;
          bidx = a;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bidx, off);
      if (better(ob, oi, best, bidx)) {
        best = ob;
        bidx = oi;
      }
    }
    if (lane_id == 0) {
      s_best[warp] = best;
      s_bidx[warp] = bidx;
    }
    __syncthreads();

    if (tid == 0) {
      float b = s_best[0];
      int bi = s_bidx[0];
      for (int i = 1; i < kWarps; ++i) {
        if (better(s_best[i], s_bidx[i], b, bi)) {
          b = s_best[i];
          bi = s_bidx[i];
        }
      }
      const bool revisit = row[kSecMeta * a_pad] > 0.5f || depth >= depth_limit;
      const int ch = static_cast<int>(row[kSecChild * a_pad + bi]);
      if (!revisit) {  // depth == it while the descent is live
        pn_row[depth] = cur;
        pa_row[depth] = bi;
        s_depth = depth + 1;
      }
      s_act = revisit ? -1 : bi;
      if (revisit || ch < 0) {
        s_stop = 1;
      } else {
        s_cur = ch;
      }
    }
    __syncthreads();
  }

  const int final_depth = s_depth;
  if (tid == 0) {
    leaf_out[env] = s_cur;
    // a descent that never stopped hit the depth cap: revisit its node
    act_out[env] = s_stop ? s_act : -1;
    depth_out[env] = final_depth;
  }
  for (int i = final_depth + tid; i < depth_limit; i += kThreads) {
    pn_row[i] = 0;
    pa_row[i] = 0;
  }
}

}  // namespace

extern "C" int alphafive_select(const void* packed, int e, int nn, int a_pad,
                                int num_actions, int depth_limit,
                                float c_puct, float forced_k, void* leaf,
                                void* act, void* depth, void* pn, void* pa,
                                void* stream) {
  if (e == 0) return cudaSuccess;
  if (a_pad % kThreads != 0 || a_pad > kThreads * kMaxLanes ||
      depth_limit < 1 || depth_limit > nn)
    return cudaErrorInvalidValue;
  select_kernel<<<e, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(packed), nn, a_pad, num_actions, depth_limit,
      c_puct, forced_k, static_cast<int*>(leaf), static_cast<int*>(act),
      static_cast<int*>(depth), static_cast<int*>(pn),
      static_cast<int*>(pa));
  return cudaGetLastError();
}
