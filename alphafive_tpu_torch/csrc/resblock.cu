// Fused inference residual block for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel alphafive_tpu/ops/pallas_resblock.py::
// fused_resblock (body _resblock_kernel, conv _conv3x3_flat). With batch
// norm folded into the weights it computes, per NHWC sample,
//
//     y   = round_to_T(relu(conv3x3(x; W1) + b1))
//     out = round_to_T(relu(conv3x3(y; W2) + b2 + x))
//
// accumulating in f32, with T the compute type (bf16 on the self-play path,
// f32 for parity checks). Weights are packed [9, Cin, Cout] with tap
// t = (dy + 1) * 3 + (dx + 1), as pack_conv_kernel writes them; b1/b2 are
// f32 [C].
//
// What bounds it on this card: at the self-play shape (2048 samples of
// 15x15x64 per forward) the two convs are 67.9 GFLOP against 59 MB of
// activations in and out, about 1,150 FLOP per byte, so it is bound by the
// tensor cores (69 us at 989 TFLOP/s) if they are fed; the bytes need 18 us.
// A 3x3 'same' conv is nine shifted [HW, C] x [C, C] products, and what
// feeds them is shared memory.
//
// Five kernels; the host picks one per shape and batch with
// resblock_variant() (ops/resblock.py::variant mirrors it):
//
//   resident (bf16, C = 64, boards up to 15x15): the self-play path.
//     * Persistent: one 256-thread CTA per SM walks samples b, b + grid, ...
//     * Both convs' 18 weight taps (147,456 B) are loaded into shared memory
//       once per CTA, transposed to [Cout][Cin] rows of 128 B in the
//       128-byte-swizzled K-major layout a wgmma descriptor reads. This is
//       the TPU kernel's constant-index weight BlockSpec: weights resident
//       across the grid.
//     * Each conv is out^T = sum over taps of W_t^T x_t^T: M = the 64
//       output channels (the taps, operand A), N = the pixels (operand B),
//       K = the 64 input channels. x and y live in buffers of channel-chunk
//       planes (chunk c of row r at c * plane + r * 16 B) over a grid of
//       h x (w + 1) positions whose extra column is the zero border left of
//       one row and right of the row above; a tap (dy, dx) of output
//       position o is then row o + (1 + dy)(w + 1) + 1 + dx, so every
//       tap's B operand is one contiguous run of rows, which a no-swizzle
//       K-major descriptor reads from any row: no bounds checks, no copies.
//     * Warpgroup g owns positions [120 g, 120 g + 120) (240 = 15 x 16: 15
//       junk) and issues one conv as 36 back-to-back wgmma.mma_async
//       m64n120k16 (9 taps x 4 k16 steps), both operands from shared
//       memory: 5.75 KB of shared reads per 123k MACs, against 16 KB for
//       pixels as M (N = 64: the channels), which bounds that layout by
//       shared-memory bandwidth.
//     * Epilogues go through stmatrix/ldmatrix .trans: the [channel]
//       [position] accumulator fragments move as 16 B channel chunks of
//       buffer rows. Conv 1's epilogue writes y to the second buffer and
//       restarts the accumulators at b2 + x (x read from its buffer), so
//       conv 2 accumulates the residual for free; conv 2's epilogue stages
//       relu(acc) in y's buffer, copied to device memory in coalesced 16 B
//       pieces between the taps of the next sample's conv 1.
//     * x's buffer is free once conv 1's epilogue has read it: the next
//       sample's x lands there by cp.async between the taps of conv 2.
//     * Every shared-memory address a thread uses is computed once per
//       launch (no division in the sample loop). Four block barriers per
//       sample, none per tap. benchmarks/resblock_profile.py times each
//       phase on the card from the `// stamp` lines below.
//   streaming (bf16, every other shape up to 19x19: C = 64, 96, 128): the
//     taps of one conv (166 KB at C = 96, 295 KB at 128) do not fit beside
//     a sample, so they stream from L2, one tap ahead of the tensor cores.
//     * What bounds it at renju_19x19's leaf forward, 4,096 x 19x19 x 128:
//       0.872 TFLOP (0.882 ms at 989 TFLOP/s) against 2.42 GB of tap reads
//       from L2 a launch (18 taps of 32 KB a sample). The tensor cores need
//       3,072 cycles a tap for the three warpgroups' 48 wgmmas; a tap takes
//       ~3,480 here. Of ~79,000 cycles a sample (131,097 in the first form,
//       which fed the taps by cp.async under a block barrier a tap), ~15,000
//       go to the output's copy-out and the next x's loads, which every
//       CTA makes at about the same time; an L2 prefetch of the next x did
//       not shorten them (benchmarks/resblock_profile.py, --ablate store /
//       xload).
//     * Persistent CTAs of three warpgroups, 128 positions each (384 >=
//       19 x 20), the same position grid and channel-chunk planes as the
//       resident kernel, but ONE activation buffer: y is written over x in
//       place (conv 1 is done with x), the output over y.
//     * M = output channels in two 64-row tiles (at C = 96 the second
//       covers 32..95 and stores 64..95), wgmma m64n128k16 with the tap as
//       an MN-major (transposed) A operand.
//     * The taps are packed once a launch (pack_taps, on the same stream)
//       so that each is one contiguous run in device memory (32 KB at C =
//       128). Each tap then moves into a 3-stage ring by one bulk copy that
//       thread 0 issues and that completes on the stage's `full` mbarrier;
//       every warp releases a stage on its `empty` mbarrier once its
//       wgmmas have read it. No block barrier and no cp.async wait per
//       tap: five barriers a sample, at the convs' boundaries. The
//       producer is a consumer's thread, not a 13th warp: 416 threads
//       would cap a thread at 152 registers, and ptxas already takes all
//       168 that 384 allow.
//     * The residual rides in conv 2's accumulators: conv 1's epilogue
//       reads x at the rows it overwrites with y and starts conv 2 at b2 +
//       x, so x is never reloaded.
//     * 128 accumulators a thread of at most 168 registers: the epilogues
//       form their rows from a mask of live fragments and their biases
//       where they use them, and a wait holds no clock, so that little
//       spills (128 bytes at C = 128).
//     * The output's copy-out and the next sample's x share their 16 B
//       pieces: each thread stores its output piece and issues the x
//       piece into the same address, so the next x lands under the
//       copy-out.
//   tiled (f32, C = 64, boards up to 15x15): register-blocked SIMT. TF32
//     would round the inputs, so no tensor cores. Persistent CTAs; x and y
//     in halo buffers; each thread owns 8 pixels x 8 output channels (64
//     accumulators, 16 shared loads of 16 B per 256 FMAs); the weight taps
//     stream through a cp.async double buffer, tap t+1 landing while tap t
//     multiplies.
//   general (bf16 or f32, every shape the three above refuse: any C >= 1,
//     any board): the Pallas kernel tiles only the batch, so it takes any
//     C and board; this variant does too, with C a runtime argument.
//     * Persistent CTAs of 8 warps (4 along the pixels x 2 along C), one
//       sample at a time. Each conv is an implicit GEMM: M = the sample's
//       h*w pixels, N = the C output channels, K = C input channels x 9
//       taps, in output tiles of BM x 64 and K steps of BK channels of one
//       tap, one block barrier a step. y stays on chip where it fits
//       (15x15 x 256 bf16: 120 KB), else in this CTA's slice of a device
//       workspace (grid x h*w*C elements) that the caller allocates.
//     * bf16: mma.sync m16n8k16 on the tensor cores (wgmma needs
//       descriptors and warpgroup fences this shape-agnostic variant does
//       without), f32 accumulators; BM = 256, BK = 64 (4 k16 MMAs a
//       barrier); each warp owns 64 pixels x 32 channels (4 x 4
//       fragments). A by ldmatrix.x4, B (a [Cin][Cout] tap tile) by
//       ldmatrix.x4.trans, the next k16's fragments loaded under this
//       one's MMAs. f32: TF32 would round the inputs, so register-blocked
//       SIMT, BM = 128, BK = 32, 4 pixels x 8 channels a lane.
//     * Operands stay T in shared memory, every row 1 mod 8 16 B chunks
//       long, so 8 consecutive rows of one ldmatrix hit 8 bank groups.
//       Weights stream through a 3-stage cp.async ring (f32: 2). A does
//       not go through the ring tap by tap: conv 1's x (or y in the
//       workspace) is copied once per channel block into a slab of every
//       pixel row the tile's 9 taps reach (BM + 2w + 2), which the taps
//       read in place at shifted rows; the next slab lands in parts during
//       the first steps of this one. Conv 2 reads y in shared memory in
//       place, and its residual tile lands in the free slab space. A lane
//       whose tap is off the board reads 16 B of zero rows, in the bank
//       group of the row it replaces. 16 B copies are cp.async,
//       zero-filled (src-size 0) past C; C not a multiple of 16 B stages
//       element by element. No division in the K loop.
//     * Epilogue from the accumulator fragments: bias, conv 2's residual,
//       relu, rounding to T; y to shared memory or the workspace, the
//       output to device memory. Warps whose tile lies wholly past the
//       sample or past C only copy.
//     * What bounds it: at 2,048 x 15x15 x 256 bf16 the block is 1.087
//       TFLOP (1.099 ms at 989 TFLOP/s) against 0.47 GB of x and out (0.14
//       ms): the tensor cores, if fed. Fed from L2, a 128 x 128-tile
//       design that stages shifted x tap by tap reads 6.8 MB a sample (14
//       GB a launch, ~5 TB/s at 3 ms); with whole-sample tiles (weights
//       once a conv, 2 x 1.18 MB) and slabs (x once per 64-channel tile,
//       4 x 115 KB) it is 2.8 MB. What is left bounds it on chip: one
//       barrier, 24 ldmatrix.x4 (12 KB of shared memory a warp) and 64
//       mma.sync per warp per K step (benchmarks/resblock_profile.py
//       --ablate barrier / mma / copies / epilogue).
//   split (bf16, C a multiple of 8, batches below kSplitBelow* of the
//     variant the shape takes otherwise): the small batches of cli play,
//     cli eval and the ladder eval (1 to 16 samples).
//     * What bounds a batch-1 block: not the card's rates (1 x 19x19 x 128
//       is 0.21 GFLOP and 0.78 MB: 0.23 us) but latency, on one SM. The
//       persistent kernels give a CTA whole samples, so at batch 1 one SM
//       of 132 stages every tap and runs every product: 17,930 of the
//       resident kernel's 30,047 cycles stage its 147 KB of taps; general
//       runs 1 x 15x15 x 256 (531 MFLOP) in 517,276 cycles
//       (benchmarks/resblock_profile.py, batch-1 stamps).
//     * One sample a cluster of K = 2..16 CTAs (cluster_size: enough for
//       the sample's tiles, halved while the batch's clusters would hold
//       more than half the SMs: a cluster's CTAs share a GPC, and the H100
//       runs 7 clusters of 16 at once, 15 of 8). general's implicit GEMM
//       (mma.sync from ldmatrix, the cp.async weight ring, slabs) in tiles
//       of 64 pixels x 64 channels, tile t to rank t mod K, so each SM
//       streams only its tiles' taps from L2 and runs a K-th of the
//       products.
//     * Conv 1's y tiles stay in their CTA's shared memory, rounded to
//       bf16 where the Pallas kernel rounds, in a whole-sample y laid out
//       alike in every rank. After a release/acquire cluster barrier each
//       rank gathers the rows its conv 2 tiles read (its bands and the w
//       + 1 rows either side, all C channels) from the ranks that wrote
//       them, 16 B at a time over distributed shared memory (mapa,
//       ld.shared::cluster), then runs conv 2 in place with the residual
//       from x. A second barrier's arrive follows the gather and its wait
//       ends the kernel, so no CTA exits while a peer reads its y. Where y
//       of a sample does not fit (240x240 x 72: 8.3 MB) it goes through
//       the workspace, the cluster barrier ordering its stores.
//     * What is left is the K loop's latency: ~1,100 cycles a step of 16
//       mma.sync a warp (a 64 x 64 x 64 tile step), of which the products
//       and their ldmatrix ~470, the block barrier ~200, the copies ~150.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <map>
#include <mutex>
#include <set>
#include <tuple>
#include <type_traits>
#include <utility>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemLimit = 232448;  // bytes of shared memory a block may use

enum Variant {
  kRefused = -1,
  kStreaming = 0,
  kResident = 1,
  kTiled = 2,
  kGeneral = 4,
  kSplit = 5
};

// ---------------------------------------------------------------------------
// PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// 16 B, or 16 zero bytes (nothing is read) when !full.
__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src,
                                                 bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

// Waits until at most N of this thread's committed cp.async groups are
// pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Waits for every cp.async of this thread, committed or not.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma window.
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// Shared-memory matrix descriptor of a K-major operand in the 128-byte
// swizzle: rows of 128 B, 8-row groups 1024 B apart (SBO), LBO unused.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// No-swizzle K-major operand: 8-row core matrices of 16 B rows (rows 16 B
// apart), the next 8 rows SBO = 128 B on, the next 8-element K chunk LBO
// bytes on.
__device__ __forceinline__ uint64_t plain_desc(uint32_t saddr, int lbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(128 >> 4) << 32);
}

// D[64 x N] += A[64 x 16] * B[16 x N], both from shared-memory
// descriptors, f32 accumulators (N / 2 per thread). B is K-major; A is
// K-major, or MN-major when trans_a (a compile-time constant at each call).
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int trans_a);

#define WGMMA_OUT8(i)                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),               \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da,
                                              uint64_t db, int trans_a) {
#define WGMMA_128(TA)                                                       \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"             \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "   \
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "   \
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, " \
      "1, " #TA ", 0;\n}\n"                                                  \
      : WGMMA_OUT8(0), WGMMA_OUT8(8), WGMMA_OUT8(16), WGMMA_OUT8(24),       \
        WGMMA_OUT8(32), WGMMA_OUT8(40), WGMMA_OUT8(48), WGMMA_OUT8(56)      \
      : "l"(da), "l"(db), "r"(1))
  if (trans_a)
    WGMMA_128(1);
  else
    WGMMA_128(0);
#undef WGMMA_128
}

template <>
__device__ __forceinline__ void wgmma_ss<120>(float (&d)[60], uint64_t da,
                                              uint64_t db, int) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %62, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n120k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59}, %60, %61, p, 1, 1, 0, 0;\n}\n"
      : WGMMA_OUT8(0), WGMMA_OUT8(8), WGMMA_OUT8(16), WGMMA_OUT8(24),
        WGMMA_OUT8(32), WGMMA_OUT8(40), WGMMA_OUT8(48), "+f"(d[56]),
        "+f"(d[57]), "+f"(d[58]), "+f"(d[59])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<48>(float (&d)[24], uint64_t da,
                                             uint64_t db, int) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23}, %24, %25, p, 1, 1, 0, "
      "0;\n}\n"
      : WGMMA_OUT8(0), WGMMA_OUT8(8), WGMMA_OUT8(16)
      : "l"(da), "l"(db), "r"(1));
}
#undef WGMMA_OUT8

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d[0..3] += A[16 x 16] B[16 x 8]: mma.sync m16n8k16, bf16 operands in the
// fragments ldmatrix gives (A row-major, B column-major), f32 accumulators
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void stmatrix_x4_trans(uint32_t addr,
                                                  const uint32_t (&r)[4]) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, "
      "%4};\n" ::"r"(addr),
      "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
      : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Orders generic-proxy shared stores before later wgmma (async-proxy) reads.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// mbarriers: phases complete when `count` arrivals (and every byte a bulk
// copy announced with expect_tx) have come in.
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the bulk-copy unit.
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// One arrival that also announces `bytes` of bulk copy still to land.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// `bytes` (a multiple of 16) from device memory into shared memory by the
// bulk-copy unit, counted against `bar`'s expected bytes as they land.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Halo-buffer row of pixel p of an h x w board: (p / w + 1, p % w + 1).
__device__ __forceinline__ int halo_row(int p, int w) {
  return (p / w + 1) * (w + 2) + p % w + 1;
}

// ---------------------------------------------------------------------------
// resident: bf16, C = 64, persistent CTAs, weights resident, wgmma

namespace resident {

constexpr int C = 64;
constexpr int kTapBytes = C * C * 2;          // 8,192: one [Cout][Cin] tap
constexpr int kWeightBytes = 18 * kTapBytes;  // 147,456: both convs

// Output positions o = r * pitch + c, pitch = w + 1, over h rows: column
// c = w is junk (dropped). Warpgroup g owns positions [g N, g N + N).
// Pixel (r, c) sits in buffer row (r + 1) * pitch + c + 1, so column 0 of
// each row is the zero border left of it and right of the row above, and
// tap (dy, dx) of position o reads row o + (1 + dy) * pitch + 1 + dx.
__host__ __device__ constexpr int positions_per_wg(int h, int w) {
  return h * (w + 1) <= 96 ? 48 : 120;
}

// Rows of one buffer: every row a tap reads plus one junk row (the last)
// that no tap reads, rounded to 1 mod 8 so the 8 channel planes start in
// different banks.
__host__ __device__ constexpr int buffer_rows(int h, int w) {
  return (2 * positions_per_wg(h, w) + 2 * (w + 1) + 2 + 7) / 8 * 8 + 1;
}

__host__ __device__ constexpr int smem_bytes(int h, int w) {
  return kWeightBytes + 2 * buffer_rows(h, w) * C * 2;
}

__host__ __device__ constexpr bool fits(int h, int w) {
  return h * (w + 1) <= 240 && smem_bytes(h, w) <= kSmemLimit;
}

// w1/w2 [9][Cin][Cout] → ws[18][Cout][Cin], each 128 B row's 16 B chunk j
// stored at chunk j ^ (row & 7): the K-major 128-byte-swizzled A operand.
// One thread moves an 8 x 8 block: eight 16 B rows in, transposed in
// registers, eight 16 B rows out.
__device__ void load_weights(const __nv_bfloat16* __restrict__ w1,
                             const __nv_bfloat16* __restrict__ w2,
                             unsigned char* ws) {
  for (int idx = threadIdx.x; idx < 18 * 64; idx += kThreads) {
    const int kb = idx & 7, nb = (idx >> 3) & 7, ct = idx >> 6;
    const __nv_bfloat16* src =
        (ct < 9 ? w1 + ct * C * C : w2 + (ct - 9) * C * C) + kb * 8 * C +
        nb * 8;
    uint4 r[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      r[i] = __ldg(reinterpret_cast<const uint4*>(src + i * C));
    const uint32_t* u = reinterpret_cast<const uint32_t*>(r);
    unsigned char* tile = ws + ct * kTapBytes;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      // word q of output row n0 + j: (w[k0 + 2q][n0 + j], w[k0 + 2q + 1][n0 + j])
      uint32_t o[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        o[q] = __byte_perm(u[(2 * q) * 4 + j / 2], u[(2 * q + 1) * 4 + j / 2],
                           (j & 1) ? 0x7632 : 0x5410);
      const int n = nb * 8 + j;
      *reinterpret_cast<uint4*>(tile + n * 128 + ((kb ^ j) << 4)) =
          make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
}

// Activation buffers are channel-chunk planes: chunk c of row r at byte
// c * plane + r * 16, plane = buffer_rows * 16.
//
// Every address a thread uses is fixed for the whole launch, so it is
// computed once (no division in the sample loop):
//   frag[k]  — the ldmatrix/stmatrix row of fragment pair k (below);
//   piece[k] — piece threadIdx.x + 256 k of a sample, pixel i / 8 and
//              chunk i % 8, or kNone past the sample.
constexpr uint32_t kNone = 0xFFFFFFFFu;

template <int N>
struct Offsets {
  static constexpr int kPairs = (N / 8 + 1) / 2;
  static constexpr int kPieces = (2 * N * 8 + kThreads - 1) / kThreads;
  uint32_t frag[kPairs];
  uint32_t piece[kPieces];

  // Accumulator 4j + 2h + e of warp q of warpgroup g is output channel
  // 16 q + 8 h + gid at position g N + 8 j + 2 tig + e: (j, h) is one 8 x 8
  // fragment, which stmatrix/ldmatrix .trans move to/from 8 buffer rows
  // (positions) of 8 channels (chunk 2 q + h). For pair k this lane
  // addresses row lane % 8 of fragment (2k + lane / 16, lane / 8 % 2);
  // junk positions (column w, past the board, past N / 8 fragments) go to
  // the junk row.
  __device__ void init(int h, int w, int plane) {
    const int lane = threadIdx.x & 31, pitch = w + 1;
    const uint32_t junk = (plane / 16 - 1) * 16;
    const uint32_t chunk =
        (2 * ((threadIdx.x >> 5) & 3) + ((lane >> 3) & 1)) * plane;
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      const int j = 2 * k + (lane >> 4);
      const int o = (threadIdx.x >> 7) * N + 8 * j + (lane & 7);
      const bool live = j < N / 8 && o < h * pitch && o % pitch != w;
      frag[k] = live ? chunk + (o + pitch + 1) * 16 : junk;
    }
#pragma unroll
    for (int k = 0; k < kPieces; ++k) {
      const int i = threadIdx.x + k * kThreads, p = i >> 3;
      piece[k] = i < h * w * 8 ? (i & 7) * plane +
                                     ((p / w + 1) * pitch + p % w + 1) * 16
                               : kNone;
    }
  }
};

// Issue one conv's 36 wgmmas (9 taps x 4 k16 steps) for this warpgroup
// onto `acc`: A = the taps at descriptor `da`, B = the shifted positions at
// `db` (the warpgroup's first position, tap (-1, -1)). `side(t)` runs after
// tap t's four wgmmas are issued: work that overlaps the tensor cores (a
// warp that issued all 36 at once would first stall on the full queue).
template <int N, typename Side>
__device__ __forceinline__ void conv_issue(float (&acc)[N / 2], uint64_t da,
                                           uint64_t db, int pitch, int plane,
                                           Side side) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) fence_operand(acc[i]);
  const uint32_t kstep = (2 * plane) >> 4;  // B: two channel chunks
  wgmma_fence();
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    // opaque to the compiler, so each tap's descriptors are formed here and
    // not all 72 of a conv up front (they took 144 registers and spilled)
    uint64_t a = da + (uint64_t)(t * (kTapBytes >> 4));
    uint64_t b = db + (uint64_t)((((t / 3) * pitch + t % 3) * 16) >> 4);
    asm volatile("" : "+l"(a), "+l"(b));
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
      wgmma_ss<N>(acc, a + (uint64_t)(kc * 2), b + (uint64_t)(kc * kstep),
                  0);
    side(t);
  }
  wgmma_commit();
}

template <int N>
__device__ __forceinline__ void conv_wait(float (&acc)[N / 2]) {
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < N / 2; ++i) fence_operand(acc[i]);
}

// Conv 1's epilogue: y = bf16(relu(acc + b1)) into buffer `ya`, and acc
// restarted as b2 + x (x read from buffer `xa`), which conv 2 accumulates
// onto: the residual costs no registers across conv 2 and x's buffer is
// free for the next sample while conv 2 runs.
template <int N>
__device__ __forceinline__ void epilogue_y(float (&acc)[N / 2],
                                           const float (&b1)[2],
                                           const float (&b2)[2], uint32_t ya,
                                           uint32_t xa, const Offsets<N>& off) {
#pragma unroll
  for (int k = 0; k < Offsets<N>::kPairs; ++k) {
    uint32_t v[4], xr[4];
    ldmatrix_x4_trans(xr, xa + off.frag[k]);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int j = 2 * k + (m >> 1), hh = m & 1;
      if (j >= N / 8) {
        v[m] = 0;
        continue;
      }
      float& lo = acc[4 * j + 2 * hh];
      float& hi = acc[4 * j + 2 * hh + 1];
      v[m] = pack_bf16(fmaxf(lo + b1[hh], 0.f), fmaxf(hi + b1[hh], 0.f));
      const float2 xf = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&xr[m]));
      lo = b2[hh] + xf.x;
      hi = b2[hh] + xf.y;
    }
    stmatrix_x4_trans(ya + off.frag[k], v);
  }
}

// Conv 2's epilogue: out = bf16(relu(acc)) staged in buffer `ya`.
template <int N>
__device__ __forceinline__ void epilogue_out(const float (&acc)[N / 2],
                                             uint32_t ya,
                                             const Offsets<N>& off) {
#pragma unroll
  for (int k = 0; k < Offsets<N>::kPairs; ++k) {
    uint32_t v[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int j = 2 * k + (m >> 1), hh = m & 1;
      v[m] = j < N / 8 ? pack_bf16(fmaxf(acc[4 * j + 2 * hh], 0.f),
                                   fmaxf(acc[4 * j + 2 * hh + 1], 0.f))
                       : 0;
    }
    stmatrix_x4_trans(ya + off.frag[k], v);
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads, 1)
    kernel(const __nv_bfloat16* __restrict__ x,
           const __nv_bfloat16* __restrict__ w1, const float* __restrict__ b1,
           const __nv_bfloat16* __restrict__ w2, const float* __restrict__ b2,
           __nv_bfloat16* __restrict__ out, int nb, int h, int w) {
  constexpr int kPieces = Offsets<N>::kPieces;  // at most 8 < 9 taps
  extern __shared__ __align__(1024) unsigned char smem_resident[];
  unsigned char* ws = smem_resident;
  unsigned char* xs = smem_resident + kWeightBytes;
  const int hw = h * w, pitch = w + 1, plane = buffer_rows(h, w) * 16;
  unsigned char* ys = xs + 8 * plane;
  const uint32_t xa = smem_u32(xs), ya = smem_u32(ys);
  if (xa & 1023) __trap();  // the weights' swizzle needs 1024 B alignment

  // launch stamp: 30
  Offsets<N> off;
  off.init(h, w, plane);
  // piece t of sample s's x, cp.async'd into x's buffer
  auto stage_x = [&](int s, int t) {
    if (t < kPieces && off.piece[t] != kNone)
      cp_async16(xa + off.piece[t],
                 reinterpret_cast<const uint4*>(x + (size_t)s * hw * C) +
                     threadIdx.x + t * kThreads);
  };
  for (int i = threadIdx.x; i < plane; i += kThreads)  // both buffers
    reinterpret_cast<uint4*>(xs)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();  // borders zeroed before the interior is written
#pragma unroll
  for (int t = 0; t < kPieces; ++t) stage_x(blockIdx.x, t);
  load_weights(w1, w2, ws);
  cp_async_wait_all();
  fence_async_shared();
  __syncthreads();

  // output channels 16 q + gid (+ 8) of this lane
  const int ch = 16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2);
  const float bias1[2] = {__ldg(b1 + ch), __ldg(b1 + ch + 8)};
  const float bias2[2] = {__ldg(b2 + ch), __ldg(b2 + ch + 8)};
  const uint64_t da1 = sw128_desc(smem_u32(ws));
  const uint64_t da2 = sw128_desc(smem_u32(ws + 9 * kTapBytes));
  const uint32_t pos0 = (threadIdx.x >> 7) * N * 16;  // this warpgroup's
  const uint64_t db1 = plain_desc(xa + pos0, plane);
  const uint64_t db2 = plain_desc(ya + pos0, plane);
  // piece t of the output staged in y's buffer, to sample s
  auto copy_out = [&](int s, int t) {
    if (t < kPieces && off.piece[t] != kNone)
      reinterpret_cast<uint4*>(out + (size_t)s * hw * C)[threadIdx.x +
                                                         t * kThreads] =
          *reinterpret_cast<const uint4*>(ys + off.piece[t]);
  };

  for (int b = blockIdx.x; b < nb; b += gridDim.x) {
    // stamp: 0
    float acc[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
    // under conv 1: the previous sample's staged output, piece t after tap t
    conv_issue<N>(acc, da1, db1, pitch, plane, [&](int t) {
      if (b != (int)blockIdx.x) copy_out(b - gridDim.x, t);
    });
    conv_wait<N>(acc);
    __syncthreads();  // the staged output is copied: y may be overwritten
    // stamp: 1
    epilogue_y<N>(acc, bias1, bias2, ya, xa, off);
    fence_async_shared();
    __syncthreads();  // y complete; x read
    // stamp: 2
    // under conv 2: the next sample's x into x's buffer
    const int bn = b + gridDim.x;
    conv_issue<N>(acc, da2, db2, pitch, plane, [&](int t) {
      if (bn < nb) stage_x(bn, t);
    });
    cp_async_commit();
    conv_wait<N>(acc);
    __syncthreads();  // every warpgroup is done reading y: it takes the output
    // stamp: 3
    epilogue_out<N>(acc, ya, off);
    cp_async_wait_all();
    fence_async_shared();
    __syncthreads();  // output staged; next x in place
    // stamp: 4
  }
  const int last = blockIdx.x + (nb - 1 - blockIdx.x) / gridDim.x * gridDim.x;
#pragma unroll
  for (int t = 0; t < kPieces; ++t) copy_out(last, t);
  // launch stamp: 31
}

}  // namespace resident

// ---------------------------------------------------------------------------
// tiled: f32, C = 64, persistent CTAs, register-blocked SIMT

namespace tiled {

constexpr int C = 64;
constexpr int kRow = C + 4;          // floats per halo row (272 B)
constexpr int kTap = C * C;          // floats per [Cin][Cout] tap
constexpr int kPix = 8;              // pixels per thread, strided by 32

__host__ __device__ constexpr int smem_bytes(int h, int w) {
  return (2 * kTap + 2 * (h + 2) * (w + 2) * kRow) * 4;
}

// cp.async tap s (0..8 conv 1, 9..17 conv 2) into wbuf.
__device__ __forceinline__ void stage_tap(const float* __restrict__ w1,
                                          const float* __restrict__ w2, int s,
                                          uint32_t wbuf) {
  const float* src = s < 9 ? w1 + s * kTap : w2 + (s - 9) * kTap;
  for (int i = threadIdx.x; i < kTap / 4; i += kThreads)
    cp_async16(wbuf + i * 16, src + i * 4);
}

// acc[i][n] += sum over k of src[row_i + off][k] * wt[k][chan(n)], with
// chan(n) = 4 cg + n for n < 4 and 32 + 4 cg + n - 4 above.
__device__ __forceinline__ void tap(float (&acc)[kPix][8], const float* src,
                                    const int (&row)[kPix], int off,
                                    const float* wt, int cg) {
#pragma unroll
  for (int k = 0; k < C; k += 4) {
    float4 a[kPix];
#pragma unroll
    for (int i = 0; i < kPix; ++i)
      a[i] = *reinterpret_cast<const float4*>(src + (row[i] + off) * kRow + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 lo =
          *reinterpret_cast<const float4*>(wt + (k + kk) * C + 4 * cg);
      const float4 hi =
          *reinterpret_cast<const float4*>(wt + (k + kk) * C + 32 + 4 * cg);
      const float wv[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int i = 0; i < kPix; ++i) {
        const float av = kk == 0 ? a[i].x : kk == 1 ? a[i].y
                       : kk == 2 ? a[i].z : a[i].w;
#pragma unroll
        for (int n = 0; n < 8; ++n) acc[i][n] = fmaf(av, wv[n], acc[i][n]);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    kernel(const float* __restrict__ x, const float* __restrict__ w1,
           const float* __restrict__ b1, const float* __restrict__ w2,
           const float* __restrict__ b2, float* __restrict__ out, int nb,
           int h, int w) {
  extern __shared__ __align__(16) unsigned char smem_tiled[];
  const int hw = h * w, wp = w + 2, halo = (h + 2) * wp;
  float* wbuf = reinterpret_cast<float*>(smem_tiled);  // [2][Cin][Cout]
  float* xs = wbuf + 2 * kTap;                   // [halo][kRow]
  float* ys = xs + halo * kRow;
  for (int i = threadIdx.x; i < 2 * halo * kRow / 4; i += kThreads)
    reinterpret_cast<float4*>(xs)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  const int cg = threadIdx.x & 7, pg = threadIdx.x >> 3;
  int row[kPix];
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    const int p = pg + 32 * i;
    row[i] = p < hw ? halo_row(p, w) : wp + 1;
  }
  const float4 bias1[2] = {*reinterpret_cast<const float4*>(b1 + 4 * cg),
                           *reinterpret_cast<const float4*>(b1 + 32 + 4 * cg)};
  const float4 bias2[2] = {*reinterpret_cast<const float4*>(b2 + 4 * cg),
                           *reinterpret_cast<const float4*>(b2 + 32 + 4 * cg)};

  stage_tap(w1, w2, 0, smem_u32(wbuf));
  for (int b = blockIdx.x; b < nb; b += gridDim.x) {
    const float* xb = x + (size_t)b * hw * C;
    for (int i = threadIdx.x; i < hw * (C / 4); i += kThreads) {
      const int p = i >> 4, c = i & 15;
      cp_async16(smem_u32(xs + halo_row(p, w) * kRow + c * 4), xb + p * C + c * 4);
    }
    cp_async_commit();
    float acc[kPix][8];
    for (int s = 0; s < 18; ++s) {
      cp_async_wait_all();
      __syncthreads();  // tap s (and x) landed; every thread is past tap s-1
      if (s < 17 || b + (int)gridDim.x < nb)
        stage_tap(w1, w2, (s + 1) % 18, smem_u32(wbuf + ((s + 1) & 1) * kTap));
      cp_async_commit();
      if (s == 0 || s == 9) {
#pragma unroll
        for (int i = 0; i < kPix; ++i)
#pragma unroll
          for (int n = 0; n < 8; ++n) acc[i][n] = 0.f;
      }
      const int t = s % 9;
      tap(acc, s < 9 ? xs : ys, row, (t / 3 - 1) * wp + (t % 3 - 1),
          wbuf + (s & 1) * kTap, cg);
      if (s == 8) {  // y = relu(acc + b1); the barrier of tap 9 publishes it
#pragma unroll
        for (int i = 0; i < kPix; ++i) {
          if (pg + 32 * i >= hw) continue;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float4 bv = bias1[half];
            *reinterpret_cast<float4*>(ys + row[i] * kRow + half * 32 + 4 * cg) =
                make_float4(fmaxf(acc[i][4 * half] + bv.x, 0.f),
                            fmaxf(acc[i][4 * half + 1] + bv.y, 0.f),
                            fmaxf(acc[i][4 * half + 2] + bv.z, 0.f),
                            fmaxf(acc[i][4 * half + 3] + bv.w, 0.f));
          }
        }
      }
    }
    float* ob = out + (size_t)b * hw * C;
#pragma unroll
    for (int i = 0; i < kPix; ++i) {
      const int p = pg + 32 * i;
      if (p >= hw) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int col = half * 32 + 4 * cg;
        const float4 bv = bias2[half];
        const float4 xr = *reinterpret_cast<const float4*>(xs + row[i] * kRow + col);
        *reinterpret_cast<float4*>(ob + p * C + col) =
            make_float4(fmaxf(acc[i][4 * half] + bv.x + xr.x, 0.f),
                        fmaxf(acc[i][4 * half + 1] + bv.y + xr.y, 0.f),
                        fmaxf(acc[i][4 * half + 2] + bv.z + xr.z, 0.f),
                        fmaxf(acc[i][4 * half + 3] + bv.w + xr.w, 0.f));
      }
    }
    __syncthreads();  // residual reads of xs done before the next x lands
  }
  cp_async_wait_all();
}

}  // namespace tiled

// ---------------------------------------------------------------------------
// streaming: bf16 at every other shape (19x19 with C = 64, 96 or 128): the
// taps, packed once a launch, stream through an mbarrier ring of bulk
// copies; one activation buffer per CTA

namespace streaming {

constexpr int kWarpgroups = 3;
constexpr int kThreadsS = 128 * kWarpgroups;
constexpr int kWarps = kThreadsS / 32;  // each releases every ring stage
constexpr int N = 128;     // positions per warpgroup: 384 >= 19 x 20
constexpr int kStages = 3;  // weight taps in flight
constexpr int kTaps = 18;   // both convs' taps, packed by pack_taps

// One buffer: the board grid of the resident kernel (h x (w + 1)
// positions, column w junk) in C / 8 channel-chunk planes, every row a tap
// reads plus a junk row, rounded to 1 mod 8.
__host__ __device__ constexpr int buffer_rows(int w) {
  return (kWarpgroups * N + 2 * (w + 1) + 2 + 7) / 8 * 8 + 1;
}

// The ring of taps, the buffer, then a full and an empty mbarrier a stage.
__host__ __device__ constexpr int smem_bytes(int w, int c) {
  return kStages * c * c * 2 + c / 8 * buffer_rows(w) * 16 + 2 * kStages * 8;
}

__host__ __device__ constexpr bool fits(int h, int w, int c) {
  return h * (w + 1) <= kWarpgroups * N && smem_bytes(w, c) <= kSmemLimit;
}

// The weights are the A operand in the MN-major layout (transposed A): tap
// t goes to taps[t][Cout / 8][Cin][8], so element (t, cin, cout) sits at
// byte 2 C^2 t + 16 C (cout / 8) + 16 cin + 2 (cout % 8) and each tap is
// one contiguous run of 2 C^2 bytes (32 KB at C = 128) that one bulk copy
// moves into a ring stage. One thread a 16 B piece: 8 consecutive Cout of
// row cin of w1/w2 [9][Cin][Cout].
__global__ void pack_taps(const uint4* __restrict__ w1,
                          const uint4* __restrict__ w2,
                          uint4* __restrict__ taps, int c) {
  const int per_tap = c * c / 8;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= kTaps * per_tap) return;
  const int t = i / per_tap, r = i - t * per_tap;
  const int j = r / c, cin = r - j * c;
  const uint4* w = t < 9 ? w1 + t * per_tap : w2 + (t - 9) * per_tap;
  taps[i] = w[cin * (c / 8) + j];
}

// MN-major no-swizzle A: 8 rows (K) of 16 B (8 M elements) per core
// matrix, K groups LBO = 128 B apart, M chunks SBO = `plane` apart.
__device__ __forceinline__ uint64_t mn_desc(uint32_t saddr, int plane) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(plane >> 4) << 32);
}

template <int C>
struct Shape {
  // M-tiles over the output channels: 64..127 at C = 128; at C = 96 the
  // second tile is channels 32..95 and keeps only 64..95 (its warps 0-1
  // duplicate the first tile's rows and store nothing)
  static constexpr int kTiles = C > 64 ? 2 : 1;
  static constexpr int kTile1 = C - 64;   // first channel of tile 1
  static constexpr int kPieces = C / 8;   // 16 B pieces per pixel
};

// Pixel p's buffer row and the byte offset of piece i (pixel i / (C / 8),
// chunk i % (C / 8)); r = p / w by a multiply-high with magic = 2^32 / w + 1.
template <int C>
__device__ __forceinline__ uint32_t piece_offset(int i, int pitch,
                                                 uint32_t magic, int plane) {
  const int p = i / Shape<C>::kPieces, c = i % Shape<C>::kPieces;
  const int r = __umulhi((uint32_t)p, magic);
  return c * plane + (p + r + pitch + 1) * 16;
}

// acc (tile m, 4j + 2h + e) of warp q of warpgroup g: channel tile0(m) +
// 16 q + 8 h + gid, position g N + 8 j + 2 tig + e. Fragment pair k (j =
// 2k, 2k + 1) moves by ldmatrix/stmatrix .trans through the rows of chunk
// plane tile0(m) / 8 + 2 q + (lane / 8) % 2 that this lane addresses: row
// lane % 8 of fragment 2k + lane / 16, position o0 + 16 k with o0 =
// fragment_position(), at buffer row o0 + 16 k + pitch + 1, or at the junk
// row (the last) where bit k of `live` is clear. Each warp reads and
// writes only its own fragments, so both epilogues work in place. Conv
// 1's (!kOut) first reads x at those rows, writes y = relu(acc + b1) over
// it and restarts acc at b2 + x, which conv 2 accumulates onto: the
// residual costs no reload and no registers across conv 2. Conv 2's
// (kOut) writes out = relu(acc) over y. Biases and rows are formed here:
// beside the 128 accumulators, registers are short.
__device__ __forceinline__ int fragment_position() {
  const int lane = threadIdx.x & 31;
  return (threadIdx.x >> 7) * N + 8 * (lane >> 4) + (lane & 7);
}

// The `live` mask of the epilogue: bit k set where pair k's position is
// on the board (not column w, not past the last row).
__device__ __forceinline__ uint32_t live_fragments(int h, int w) {
  const int o0 = fragment_position(), pitch = w + 1;
  uint32_t live = 0;
  for (int k = 0; k < N / 16; ++k) {
    const int o = o0 + 16 * k;
    live |= (uint32_t)(o < h * pitch && o % pitch != w) << k;
  }
  return live;
}

template <int C, bool kOut>
__device__ __forceinline__ void epilogue(
    float (&acc)[Shape<C>::kTiles][N / 2], const float* __restrict__ b1,
    const float* __restrict__ b2, uint32_t buf, int w, int plane,
    uint32_t live) {
  const int lane = threadIdx.x & 31, q = (threadIdx.x >> 5) & 3;
  const int hsel = (lane >> 3) & 1;
  const uint32_t row0 = (fragment_position() + w + 2) * 16;
  const uint32_t junk = plane - 16;
#pragma unroll
  for (int m = 0; m < Shape<C>::kTiles; ++m) {
    if (m == 1 && Shape<C>::kTile1 < 64 && 16 * q < 64 - Shape<C>::kTile1)
      continue;  // C = 96: channels 32..63 belong to tile 0
    const int c0 = (m ? Shape<C>::kTile1 : 0) + 16 * q + (lane >> 2);
    float bv[2] = {0.f, 0.f}, rv[2] = {0.f, 0.f};
    if (!kOut) {
      bv[0] = __ldg(b1 + c0), bv[1] = __ldg(b1 + c0 + 8);
      rv[0] = __ldg(b2 + c0), rv[1] = __ldg(b2 + c0 + 8);
    }
    const uint32_t chunk =
        buf + ((m ? Shape<C>::kTile1 : 0) / 8 + 2 * q + hsel) * plane;
#pragma unroll
    for (int k = 0; k < N / 16; ++k) {
      uint32_t v[4], xr[4];
      const uint32_t at = chunk + ((live >> k) & 1 ? row0 + 256 * k : junk);
      if (!kOut) ldmatrix_x4_trans(xr, at);
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int j = 2 * k + (f >> 1), hh = f & 1;
        float& lo = acc[m][4 * j + 2 * hh];
        float& hi = acc[m][4 * j + 2 * hh + 1];
        if (kOut) {
          v[f] = pack_bf16(fmaxf(lo, 0.f), fmaxf(hi, 0.f));
        } else {
          v[f] = pack_bf16(fmaxf(lo + bv[hh], 0.f), fmaxf(hi + bv[hh], 0.f));
          const float2 xf = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&xr[f]));
          lo = rv[hh] + xf.x;
          hi = rv[hh] + xf.y;
        }
      }
      stmatrix_x4_trans(at, v);
    }
  }
}

template <int C>
__global__ void __launch_bounds__(kThreadsS, 1)
    bf16_kernel(const __nv_bfloat16* __restrict__ x,
                const __nv_bfloat16* __restrict__ taps,
                const float* __restrict__ b1, const float* __restrict__ b2,
                __nv_bfloat16* __restrict__ out, int nb, int h, int w) {
  using S = Shape<C>;
  constexpr int kTap = C * C * 2;
  extern __shared__ __align__(128) unsigned char smem_streaming[];
  // launch stamp: 30
  unsigned char* bufp = smem_streaming + kStages * kTap;
  const uint32_t stages = smem_u32(smem_streaming), buf = smem_u32(bufp);
  const int hw = h * w, pitch = w + 1, plane = buffer_rows(w) * 16;
  const uint32_t full = buf + S::kPieces * plane;  // kStages mbarriers
  const uint32_t empty = full + kStages * 8;       // kStages mbarriers
  const uint32_t magic = 0xFFFFFFFFu / w + 1;
  for (int i = threadIdx.x; i < S::kPieces * plane / 16; i += kThreadsS)
    reinterpret_cast<uint4*>(bufp)[i] = make_uint4(0, 0, 0, 0);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kWarps);
    }
    fence_mbar_init();
  }
  const uint32_t live = live_fragments(h, w);
  const uint64_t db = plain_desc(buf + (threadIdx.x >> 7) * N * 16, plane);
  const uint32_t kstep_b = (2 * plane) >> 4;
  __syncthreads();  // buffer zeroed before x lands; barriers initialised

  // The tap stream: use u, counted across this CTA's samples, reads stage
  // u % 3, which holds tap u % 18 (conv 1 for 0..8, conv 2 for 9..17).
  // Thread 0 issues use v's bulk copy once every warp has released use
  // v - 3 from that stage (the empty barrier's previous phase; a fresh
  // barrier passes parity 1), and none past this CTA's last sample, so
  // no thread waits on a stage that nobody fills.
  const int uses =
      kTaps * ((nb - 1 - (int)blockIdx.x) / (int)gridDim.x + 1);
  auto load_tap = [&](int v) {
    if (threadIdx.x != 0 || v >= uses) return;
    const int s = v % kStages;
    // ablate: empty
    mbar_wait(empty + 8 * s, ((v / kStages) & 1) ^ 1);
    uint32_t tx = 0;
    // ablate: bulk
    tx = kTap;
    mbar_expect_tx(full + 8 * s, tx);
    if (tx)
      bulk_copy(stages + s * kTap, taps + (size_t)(v % kTaps) * C * C, tx,
                full + 8 * s);
  };
  {
    const uint4* src = reinterpret_cast<const uint4*>(
        x + (size_t)blockIdx.x * hw * C);
    for (int i = threadIdx.x; i < hw * S::kPieces; i += kThreadsS)
      cp_async16(buf + piece_offset<C>(i, pitch, magic, plane), src + i);
  }
  load_tap(0);
  load_tap(1);
  int u = 0;
  for (int b = blockIdx.x; b < nb; b += gridDim.x) {
    float acc[S::kTiles][N / 2];
    // tap use u: wait for its stage, issue its wgmmas; once this
    // warpgroup's use u - 1 is done, each warp releases that stage and
    // thread 0 refills it with use u + 2. Nothing in it touches acc, so
    // the wgmmas of consecutive taps overlap; no block barrier.
    auto tap = [&](int s) {
      mbar_wait(full + 8 * (u % kStages), (u / kStages) & 1);
      // stamp: s + (s >= 9) * 2
      const int t = s % 9;
      uint64_t a = mn_desc(stages + (u % kStages) * kTap, C * 16);
      uint64_t bd = db + (uint64_t)((((t / 3) * pitch + t % 3) * 16) >> 4);
      asm volatile("" : "+l"(a), "+l"(bd));
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < C / 16; ++kc)
#pragma unroll
        for (int m = 0; m < S::kTiles; ++m)
          wgmma_ss<N>(acc[m],
                      a + (uint64_t)(((m ? S::kTile1 / 8 : 0) * C * 16 +
                                      kc * 256) >> 4),
                      bd + (uint64_t)(kc * kstep_b), 1);
      wgmma_commit();
      wgmma_wait<1>();  // this warpgroup's use u - 1 is done
      if ((threadIdx.x & 31) == 0 && u > 0)
        mbar_arrive(empty + 8 * ((u - 1) % kStages));
      load_tap(u + 2);
      __syncwarp();
    };
    auto drain = [&]() {  // every warpgroup's wgmmas done, acc readable
      wgmma_wait<0>();
#pragma unroll
      for (int m = 0; m < S::kTiles; ++m)
#pragma unroll
        for (int i = 0; i < N / 2; ++i) fence_operand(acc[m][i]);
      __syncthreads();
    };
    cp_async_wait_all();  // this thread's pieces of x landed
    fence_async_shared();
    __syncthreads();      // all of x, for every warpgroup's taps
#pragma unroll
    for (int m = 0; m < S::kTiles; ++m)
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        acc[m][i] = 0.f;
        fence_operand(acc[m][i]);
      }
    for (int s = 0; s < 9; ++s, ++u) tap(s);
    drain();  // every warpgroup is done reading x
    // stamp: 9
    epilogue<C, false>(acc, b1, b2, buf, w, plane, live);  // y over x
#pragma unroll
    for (int m = 0; m < S::kTiles; ++m)
#pragma unroll
      for (int i = 0; i < N / 2; ++i) fence_operand(acc[m][i]);
    fence_async_shared();
    __syncthreads();  // y complete before conv 2 reads it
    // stamp: 10
    for (int s = 9; s < 18; ++s, ++u) tap(s);
    drain();  // every warpgroup is done reading y
    // stamp: 20
    epilogue<C, true>(acc, b1, b2, buf, w, plane, live);  // out over y
    __syncthreads();
    // stamp: 21
    // Each piece of the output to device memory, and the next sample's x
    // piece into the same address: each thread rewrites only what it has
    // read itself, so no barrier between the two; tap 0 of the next
    // sample waits only for what has not landed yet.
    const bool more = b + (int)gridDim.x < nb;
    const uint4* xn = reinterpret_cast<const uint4*>(
        x + (size_t)(more ? b + gridDim.x : b) * hw * C);
    uint4* ob = reinterpret_cast<uint4*>(out + (size_t)b * hw * C);
    for (int i = threadIdx.x; i < hw * S::kPieces; i += kThreadsS) {
      const uint32_t off = piece_offset<C>(i, pitch, magic, plane);
      // ablate: store
      ob[i] = *reinterpret_cast<const uint4*>(bufp + off);
      // ablate: xload
      if (more) cp_async16(buf + off, xn + i);
    }
    // stamp: 22
  }
  // launch stamp: 31
}

}  // namespace streaming

// ---------------------------------------------------------------------------
// general: bf16 or f32, any C >= 1 and any board, implicit GEMM per sample

namespace general {

constexpr int kWarpN = 32;  // output channels of one warp's output tile
constexpr int kWarpsN = 2;  // 8 warps: 4 along the pixels, 2 along C
constexpr int kWarpsM = kThreads / 32 / kWarpsN;
constexpr int BN = kWarpN * kWarpsN;  // 64 channels

__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }
// Pixels of one warp's output tile: 64 (bf16: 4 m16 fragments) or 32
// (f32: 4 pixels x 8 channels a lane, so a small sample still spreads
// over several warps); of a tile, 256 or 128.
__host__ __device__ constexpr int warp_m(int elem) {
  return elem == 2 ? 64 : 32;
}
__host__ __device__ constexpr int bm(int elem) {
  return warp_m(elem) * kWarpsM;
}
// Elements in 16 B: the unit of every copy and of the rows' padding.
__host__ __device__ constexpr int chunk(int elem) { return 16 / elem; }
// Input channels of one K step (of one tap): four k16 MMAs (bf16), or 32
// channels of SIMT FMAs (f32).
__host__ __device__ constexpr int bk(int elem) { return elem == 2 ? 64 : 32; }
// K steps of weights in flight: a 3-stage ring for bf16, 2 for f32.
__host__ __device__ constexpr int stages(int elem) {
  return elem == 2 ? 3 : 2;
}
// The weight ring: a stage is one B tile of BK x BN, rows padded by 16 B.
__host__ __device__ constexpr int ring_bytes(int elem) {
  return stages(elem) * bk(elem) * (BN + chunk(elem)) * elem;
}
// A lane whose tap lies off the board reads zeros from kZeroRows rows
// after the data: 16 B at the bank group its own row would have used, so
// the 8 rows of one ldmatrix stay in 8 bank groups (see conv).
constexpr int kZeroRows = 3;
// An A slab: BK channels (rows padded by 16 B) of the pixel rows one M
// tile of m pixels (bm(elem); the split variant's 64) reaches with its
// taps, then the zero rows. span 3: the rows of all three tap rows (m +
// 2w + 2, at most h*w), one slab for the 9 taps of a channel block; span
// 1, for boards too wide for that: one tap row's m + 2 rows, a slab for
// each 3 taps.
__host__ __device__ constexpr int slab_rows(int h, int w, int span, int elem,
                                            int m) {
  return imin(m + (span == 3 ? 2 * w + 2 : 2), h * w) + kZeroRows;
}
__host__ __device__ constexpr int slab_bytes(int h, int w, int span, int elem,
                                             int m) {
  return slab_rows(h, w, span, elem, m) * (bk(elem) + chunk(elem)) * elem;
}
// Slabs: two (one read, the next landing), or one where a tile reads a
// single slab (span 3 and C <= BK) and conv 2's residual tile fits in it.
__host__ __device__ constexpr int slab_slots(int c, int span, int elem) {
  return span == 3 && c <= bk(elem) && BN <= bk(elem) ? 1 : 2;
}
// The ring and the slabs.
__host__ __device__ constexpr int base_bytes(int h, int w, int c, int span,
                                             int elem, int m) {
  return ring_bytes(elem) +
         slab_slots(c, span, elem) * slab_bytes(h, w, span, elem, m);
}
__host__ __device__ constexpr int span(int h, int w, int c, int elem, int m) {
  return base_bytes(h, w, c, 3, elem, m) <= kSmemLimit ? 3 : 1;
}
// y's row: C rounded up to 8 chunks, plus one chunk. A row of 1 mod 8
// 16 B chunks puts 8 consecutive rows of one ldmatrix (or of one float4
// load across a warp) in 8 different bank groups, row r in group r mod 8
// (plus the column's); so do the slabs' rows (BK + one chunk) and the
// ring's (BN + one chunk).
__host__ __device__ constexpr int y_stride(int c, int elem) {
  return (c + 8 * chunk(elem) - 1) / (8 * chunk(elem)) * (8 * chunk(elem)) +
         chunk(elem);
}
// y of one sample, and the zero rows after it.
__host__ __device__ constexpr long long y_bytes(int h, int w, int c,
                                                int elem) {
  return ((long long)h * w + kZeroRows) * y_stride(c, elem) * elem;
}

// y of one sample in shared memory beside the ring and slabs, or not
__host__ __device__ constexpr bool y_in_smem(int h, int w, int c, int elem,
                                             int m) {
  return base_bytes(h, w, c, span(h, w, c, elem, m), elem, m) +
             y_bytes(h, w, c, elem) <=
         kSmemLimit;
}

__host__ __device__ constexpr int smem_bytes(int h, int w, int c, int elem,
                                             int m) {
  return base_bytes(h, w, c, span(h, w, c, elem, m), elem, m) +
         (y_in_smem(h, w, c, elem, m) ? (int)y_bytes(h, w, c, elem) : 0);
}

// The same for the general variant's tiles of bm(elem) pixels.
__host__ __device__ constexpr bool y_in_smem(int h, int w, int c, int elem) {
  return y_in_smem(h, w, c, elem, bm(elem));
}
__host__ __device__ constexpr int smem_bytes(int h, int w, int c, int elem) {
  return smem_bytes(h, w, c, elem, bm(elem));
}

// The tiles of element type T, kTileM pixels by BN channels (bf16: any
// multiple of 64; f32: bm(4) only).
template <typename T, int kTileM = bm(sizeof(T))>
struct Tile {
  static constexpr int kElem = sizeof(T), kChunk = 16 / kElem;
  static constexpr int kBK = bk(kElem), kStages = stages(kElem);
  static constexpr int kBM = kTileM, kWarpM = kBM / kWarpsM;
  static constexpr int kAStride = kBK + kChunk, kBStride = BN + kChunk;
  static constexpr int kRStride = BN + kChunk;  // conv 2's residual tile
  static constexpr int kBElems = kBK * kBStride;  // one ring stage
  static constexpr int kACols = kBK / kChunk;  // 16 B chunks of a slab row
  static constexpr int kBCols = BN / kChunk;
  static constexpr int kBChunks = kBK * kBCols / kThreads;  // per thread
  // A rows one lane reads: the warp's m16 fragments (bf16: 4 at BM =
  // 256, 1 at 64) or 4 pixels (f32)
  static constexpr int kRows = kElem == 2 ? kWarpM / 16 : 4;
  static constexpr int kAcc = kElem == 2 ? 16 * kRows : 32;  // accumulators
  static_assert(kStages * kBElems * kElem == ring_bytes(kElem), "ring");
  static_assert(kElem == 2 ? kWarpM % 16 == 0 : kBM == bm(kElem), "tile");
};

template <typename T>
using Bits = typename std::conditional<sizeof(T) == 2, uint16_t,
                                       uint32_t>::type;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The 16 B chunk at dst from src: its first n_ok elements (those before
// C) where `in`, zeros elsewhere (off the board, past C). vec: C is a
// multiple of 16 B, so the chunk is whole or empty and goes by cp.async
// (zero-filled: `base`, a valid address, is read instead, 0 bytes of it);
// else element by element.
template <typename T>
__device__ __forceinline__ void stage_chunk(T* dst, const T* src,
                                            const T* base, bool in, int n_ok,
                                            bool vec) {
  constexpr int kChunk = 16 / sizeof(T);
  if (vec) {
    const bool full = in && n_ok > 0;
    // ablate: copies
    cp_async16_zfill(smem_u32(dst), full ? src : base, full);
    return;
  }
  union {
    uint4 v;
    Bits<T> e[kChunk];
  } u;
#pragma unroll
  for (int e = 0; e < kChunk; ++e)
    u.e[e] = in && e < n_ok ? reinterpret_cast<const Bits<T>*>(src)[e] : 0;
  *reinterpret_cast<uint4*>(dst) = u.v;
}

// Where conv 2 finds the residual: element (p, ch) of a [pixel][channel]
// array at at[(p - p0) * ld + ch - c0] (x: p0 = c0 = 0; its tile in shared
// memory: the tile's origin).
template <typename T>
struct View {
  T* at;
  int ld, p0, c0;
  __device__ T* operator()(int p, int ch) const {
    return at + (size_t)(p - p0) * ld + ch - c0;
  }
};

// The epilogue of one warp's output tile (pixels p0 + [0, kWarpM),
// channels ch0 + [0, 32)) from its accumulators:
//   dst[p][ch] = T(relu(acc + bias[ch] (+ res[p][ch])))
// in runs of 2 (bf16: an accumulator fragment's pair) or 4 (f32) channels.
// The residual (conv 2) is x in device memory, or its tile in shared
// memory. The bias is read once, and every residual load is issued
// before the first is used.
template <typename T, int kTileM, bool kSecond>
__device__ __forceinline__ void epilogue(
    const float (&acc)[Tile<T, kTileM>::kAcc], T* dst, int ld,
    const float* __restrict__ bias, View<const T> res, int p0, int ch0,
    int hw, int c) {
  constexpr bool kMma = sizeof(T) == 2;
  constexpr int kRun = kMma ? 2 : 4;   // channels of a run
  constexpr int kRuns = kMma ? 4 : 2;  // runs of the lane at a pixel
  // pixels of the lane: two a fragment (bf16)
  constexpr int kPix = kMma ? 2 * Tile<T, kTileM>::kRows : 4;
  const int lane = threadIdx.x & 31;
  // bf16 fragment (i, j): pixels 16 i + g (+ 8), channels 8 j + 2 t (+ 1);
  // f32: pixels tr + 8 i, channels 4 tc + 16 hf + [0, 4)
  auto pix = [&](int k) {
    return p0 + (kMma ? 16 * (k >> 1) + (lane >> 2) + 8 * (k & 1)
                      : (lane >> 2) + 8 * k);
  };
  auto chan = [&](int r) {
    return ch0 + (kMma ? 8 * r + 2 * (lane & 3) : 16 * r + 4 * (lane & 3));
  };
  auto acc_at = [&](int k, int r, int e) {
    return kMma ? acc[((k >> 1) * 4 + r) * 4 + 2 * (k & 1) + e]
                : acc[k * 8 + 4 * r + e];
  };
  float bv[kRuns][kRun];
#pragma unroll
  for (int r = 0; r < kRuns; ++r)
#pragma unroll
    for (int e = 0; e < kRun; ++e)
      bv[r][e] = chan(r) + e < c ? __ldg(bias + chan(r) + e) : 0.f;
  const bool vec_res = res.ld % kRun == 0 && res.c0 % kRun == 0;
  const bool vec_dst = ld % kRun == 0;
  float rv[kPix][kRuns][kRun];
  if constexpr (kSecond) {
#pragma unroll
    for (int k = 0; k < kPix; ++k)
#pragma unroll
      for (int r = 0; r < kRuns; ++r) {
        const int p = pix(k), ch = chan(r);
        const T* src = res(p, ch);
        const bool in = p < hw && ch < c;
        if (in && vec_res && ch + kRun <= c) {
          if constexpr (kMma) {
            const float2 v = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(src));
            rv[k][r][0] = v.x;
            rv[k][r][1] = v.y;
          } else {
            const float4 v = *reinterpret_cast<const float4*>(src);
            rv[k][r][0] = v.x;
            rv[k][r][1] = v.y;
            rv[k][r][2] = v.z;
            rv[k][r][3] = v.w;
          }
        } else {
#pragma unroll
          for (int e = 0; e < kRun; ++e)
            rv[k][r][e] = in && ch + e < c ? widen(src[e]) : 0.f;
        }
      }
  }
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int p = pix(k);
    if (p >= hw) continue;
#pragma unroll
    for (int r = 0; r < kRuns; ++r) {
      const int ch = chan(r);
      if (ch >= c) continue;
      float v[kRun];
#pragma unroll
      for (int e = 0; e < kRun; ++e)
        v[e] = fmaxf(acc_at(k, r, e) + bv[r][e] + (kSecond ? rv[k][r][e] : 0.f),
                     0.f);
      T* o = dst + (size_t)p * ld + ch;
      if (vec_dst && ch + kRun <= c) {
        if constexpr (kMma)
          *reinterpret_cast<__nv_bfloat162*>(o) =
              __floats2bfloat162_rn(v[0], v[1]);
        else
          *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int e = 0; e < kRun; ++e)
          if (ch + e < c) o[e] = narrow<T>(v[e]);
      }
    }
  }
}

// One 3x3 'same' conv of one sample into dst (row stride ld):
//   dst = T(relu(conv(A; wt) + bias (+ the residual x)))
// with A the sample's activations [h*w][c], read in place by the products:
// from y in shared memory (kDirect: conv 2 where y fits; stride y_stride,
// zero rows after it), or from slabs copied out of device memory (src: x,
// or y in the workspace). Output tiles of kTileM pixels x BN channels,
// numbered pixels outer; this CTA runs tiles first, first + step, ... (the
// general variant all, from 0 by 1; a rank of the split variant's cluster
// every ranks-th). Each runs ceil(C / BK) channel blocks x 9 taps, one K
// step each, one block barrier a step. The weights of step s + stages - 1
// are copied at step s; the next slab in parts over the first steps of a
// slab's turn (cp.async groups complete in order, so each part has stages
// - 1 steps to land). kDirect leaves the slabs free: conv 2's residual
// tile lands there during the K loop. b: the sample (read by
// benchmarks/resblock_profile.py's stamps).
template <typename T, int kTileM, bool kSecond, bool kDirect>
__device__ void conv(const T* src, const T* ys, const T* __restrict__ wt,
                     const float* __restrict__ bias, const T* x, T* dst,
                     int ld, int h, int w, int c, int span, T* ring, T* slabs,
                     int b, int first, int step) {
  using G = Tile<T, kTileM>;
  constexpr bool kMma = sizeof(T) == 2;
  constexpr int BK = G::kBK;
  static_assert(2 * G::kAStride >= G::kRStride, "the residual tile fits");
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  // warp (wm, wn) = (wid / 2, wid % 2): a tile's lower pixel rows, the
  // last to go idle past the sample, spread over the 4 SM sub-partitions
  const int wm0 = wid / kWarpsN * G::kWarpM, wn0 = wid % kWarpsN * kWarpN;
  const int hw = h * w, kcb = (c + BK - 1) / BK, steps = 9 * kcb;
  const bool vec = c % G::kChunk == 0;  // 16 B copies (cp.async)
  const int a_ld = kDirect ? y_stride(c, G::kElem) : G::kAStride;
  const int srows = slab_rows(h, w, span, G::kElem, G::kBM);
  const int zrow = kDirect ? hw : srows - kZeroRows;  // the first zero row
  // steps over which the next slab is copied: each part lands within
  // stages - 1 steps, before the slab's turn
  const int parts = 3 * span - (G::kStages - 1);
  const size_t cc = (size_t)c * c;
  // loader roles: slab chunk column acol of rows arow0 + j * kARowStep;
  // weight (and residual) chunk column bcol of rows brow0 + j * kBRowStep
  constexpr int kARowStep = kThreads / G::kACols;
  constexpr int kBRowStep = kThreads / G::kBCols;
  const int acol = tid % G::kACols * G::kChunk, arow0 = tid / G::kACols;
  const int bcol = tid % G::kBCols * G::kChunk, brow0 = tid / G::kBCols;

  const int ntn = (c + BN - 1) / BN;  // channel tiles of a pixel band
  const int tiles = (hw + G::kBM - 1) / G::kBM * ntn;
  // j: this CTA's first tile of a band it has tiles in; the next such j
  // is its first tile past the band (bands without one are not visited)
  for (int j = first; j < tiles;
       j += (j / ntn * ntn + ntn - j + step - 1) / step * step) {
    const int m0 = j / ntn * G::kBM;
    // the lane's A rows: pixel p's offset in A's buffer, which of the 9
    // taps lie on the board (bit t; none past the sample), and where in
    // the zero rows it reads off the board: chunk (p - zrow) mod 8, plus
    // the tap's row shift mod 8 (ztap), so its 16 B fall in the bank
    // group of the row it replaces
    int abase[G::kRows], on[G::kRows], zbase[G::kRows];
#pragma unroll
    for (int i = 0; i < G::kRows; ++i) {
      const int p = m0 + wm0 +
                    (kMma ? 16 * i + (lane & 15) : 8 * i + (lane >> 2));
      const int r = p / w, q = p - r * w;
      abase[i] = p * a_ld;
      zbase[i] = zrow * a_ld + ((p - zrow) & 7) * G::kChunk;
      on[i] = 0;
#pragma unroll
      for (int t = 0; t < 9; ++t)
        on[i] |= (p < hw && (unsigned)(r + t / 3 - 1) < (unsigned)h &&
                  (unsigned)(q + t % 3 - 1) < (unsigned)w)
                 << t;
    }
    // first pixel row of the slab whose lowest tap row is dy0
    auto slab_lo = [&](int dy0) { return max(0, m0 + dy0 * w - 1); };
    // rows of channel block cb from tap row dy0, part `part` of `nparts`
    auto load_slab = [&](int slot, int cb, int dy0, int part, int nparts) {
      const int lo = slab_lo(dy0);
      const int n = min(hw, m0 + G::kBM + (dy0 + span - 1) * w + 1) - lo;
      const int ch = cb * BK + acol;
      T* sl = slabs + slot * srows * G::kAStride + acol;
      const T* from = src + lo * c + ch;
      for (int row = arow0 + part * kARowStep; row < n;
           row += nparts * kARowStep)
        stage_chunk(sl + row * G::kAStride, from + row * c, src, true,
                    c - ch, vec);
    };
    for (int n0 = j % ntn * BN; n0 < c; n0 += step * BN) {
      // warps whose whole tile lies past the sample or past C only copy
      const bool active = m0 + wm0 < hw && n0 + wn0 < c;
      float acc[G::kAcc];
#pragma unroll
      for (int i = 0; i < G::kAcc; ++i) acc[i] = 0.f;
      // the next weights: channel block lcb, tap lt, this thread's first
      // chunk at wt + woff
      int lcb = 0, lt = 0;
      size_t woff = (size_t)brow0 * c + n0 + bcol;
      auto load_weights = [&](int slot) {
        T* bs = ring + slot * G::kBElems + brow0 * G::kBStride + bcol;
#pragma unroll
        for (int j = 0; j < G::kBChunks; ++j)
          stage_chunk(bs + j * kBRowStep * G::kBStride,
                      wt + woff + (size_t)j * kBRowStep * c, wt,
                      lcb * BK + brow0 + j * kBRowStep < c, c - n0 - bcol,
                      vec);
        woff += cc;
        if (++lt == 9) {
          lt = 0;
          ++lcb;
          woff += (size_t)BK * c - 9 * cc;
        }
      };
      // conv 2's residual tile x[m0 + row][n0 + ...], rows kRStride apart
      auto load_residual = [&]() {
        const int n = min(G::kBM, hw - m0);
        for (int row = brow0; row < n; row += kBRowStep)
          stage_chunk(slabs + row * G::kRStride + bcol,
                      x + (size_t)(m0 + row) * c + n0 + bcol, x, true,
                      c - n0 - bcol, vec);
      };

      __syncthreads();  // every warp is done with the last tile's smem
      if (!kDirect && m0 / G::kBM * ntn + n0 / BN == first) {
        // at this CTA's first tile, the slabs' zero rows (conv 2's
        // residual tile may have covered them); the barrier of step 0
        // publishes them
        constexpr int kZero = kZeroRows * G::kAStride;
        for (int i = tid; i < slab_slots(c, span, G::kElem) * kZero;
             i += kThreads)
          slabs[(i / kZero + 1) * srows * G::kAStride - kZero + i % kZero] =
              narrow<T>(0.f);
      }
#pragma unroll
      for (int s = 0; s < G::kStages - 1; ++s) {
        if (!kDirect && s == 0) load_slab(0, 0, -1, 0, 1);
        load_weights(s);
        cp_async_commit();
      }
      int cb = 0, t = 0, wi = 0;  // channel block, tap, slab of step s
      int rd = 0, wr = G::kStages - 1;
      for (int s = 0; s < steps; ++s) {
        const int dy = t < 3 ? -1 : t < 6 ? 0 : 1, dx = t - 3 * dy - 4;
        cp_async_wait<G::kStages - 2>();
        // ablate: barrier
        __syncthreads();  // step s landed; every warp is past step s - 1
        if (s + G::kStages - 1 < steps) load_weights(wr);
        if (!kDirect) {
          // the next slab: channel block cb + 1 (span 3), or tap row
          // dy + 1 of this block (span 1)
          const int k = span == 3 ? t : t - 3 * (dy + 1);
          const bool next_block = span == 3 || dy == 1;
          if (k < parts && (!next_block || cb + 1 < kcb))
            load_slab((wi + 1) & 1, next_block ? cb + 1 : cb,
                      next_block ? -1 : dy + 1, k, parts);
        } else if (s == 0) {
          load_residual();
        }
        cp_async_commit();
        if (active) {
          // the lane's A rows at tap (dy, dx), or zeros
          const T* ab = kDirect ? ys : slabs + (wi & 1) * srows * G::kAStride;
          // the tap's row shift in A's buffer
          const int shift =
              dy * w + dx - (kDirect ? 0 : slab_lo(span == 3 ? -1 : dy));
          const int tap = shift * a_ld + (kDirect ? cb * BK : 0);
          const int ztap = (shift & 7) * G::kChunk;
          int aoff[G::kRows];
#pragma unroll
          for (int i = 0; i < G::kRows; ++i)
            aoff[i] = on[i] >> t & 1 ? abase[i] + tap : zbase[i] + ztap;
          const T* bs = ring + rd * G::kBElems;
          if constexpr (kMma) {
            // k16 MMAs of m16n8k16 over the step's channels (C padded to
            // 16 only): 4 x 4 fragments of the 64 x 32 warp tile, A by
            // ldmatrix, B by ldmatrix .trans, the next k16's fragments
            // loaded under this one's MMAs
            const int nk = imin(BK, c - cb * BK + 15) / 16;
            uint32_t a[2][G::kRows][4], bf[2][4][2];
            auto fragments = [&](int kk, int buf) {
              const int ka = 16 * kk + (lane >> 4) * 8;
#pragma unroll
              for (int i = 0; i < G::kRows; ++i)
                ldmatrix_x4(a[buf][i], smem_u32(ab + aoff[i] + ka));
#pragma unroll
              for (int jn = 0; jn < 2; ++jn) {
                uint32_t r[4];
                ldmatrix_x4_trans(
                    r, smem_u32(bs + (16 * kk + (lane & 15)) * G::kBStride +
                                wn0 + 16 * jn + (lane >> 4) * 8));
                bf[buf][2 * jn][0] = r[0];
                bf[buf][2 * jn][1] = r[1];
                bf[buf][2 * jn + 1][0] = r[2];
                bf[buf][2 * jn + 1][1] = r[3];
              }
            };
            fragments(0, 0);
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk) {
              if (kk >= nk) break;
              if (kk + 1 < BK / 16 && kk + 1 < nk)
                fragments(kk + 1, (kk + 1) & 1);
#pragma unroll
              for (int i = 0; i < G::kRows; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                  // ablate: mma
                  mma_bf16(&acc[(i * 4 + j) * 4], a[kk & 1][i], bf[kk & 1][j]);
                }
            }
          } else {
            // f32 SIMT: 4 pixels x 8 channels a lane (channels
            // wn0 + 4 tc + [0, 4) and 16 above), 4 input channels at a
            // time: 12 shared loads of 16 B per 128 FMAs
            const int tc = lane & 3;
#pragma unroll
            for (int kq = 0; kq < BK / 4; ++kq) {
              if (cb * BK + 4 * kq >= c) break;
              float4 a[G::kRows];
#pragma unroll
              for (int i = 0; i < G::kRows; ++i)
                a[i] = *reinterpret_cast<const float4*>(ab + aoff[i] + 4 * kq);
#pragma unroll
              for (int kk = 0; kk < 4; ++kk) {
                const T* brow = bs + (4 * kq + kk) * G::kBStride + wn0 + 4 * tc;
                const float4 lo4 = *reinterpret_cast<const float4*>(brow);
                const float4 hi4 = *reinterpret_cast<const float4*>(brow + 16);
                const float wv[8] = {lo4.x, lo4.y, lo4.z, lo4.w,
                                     hi4.x, hi4.y, hi4.z, hi4.w};
#pragma unroll
                for (int i = 0; i < G::kRows; ++i) {
                  const float av = kk == 0   ? a[i].x
                                   : kk == 1 ? a[i].y
                                   : kk == 2 ? a[i].z
                                             : a[i].w;
#pragma unroll
                  for (int n = 0; n < 8; ++n)
                    acc[i * 8 + n] = fmaf(av, wv[n], acc[i * 8 + n]);
                }
              }
            }
          }
        }
        if (++rd == G::kStages) rd = 0;
        if (++wr == G::kStages) wr = 0;
        if (t == 8 || (span == 1 && (t == 2 || t == 5))) ++wi;
        if (++t == 9) {
          t = 0;
          ++cb;
        }
      }
      // stamp: kSecond ? 3 : 1
      if (!active) continue;
      const View<const T> res =
          kDirect ? View<const T>{slabs, G::kRStride, m0, n0}
                  : View<const T>{x, c, 0, 0};
      // ablate: epilogue
      epilogue<T, kTileM, kSecond>(acc, dst, ld, bias, res, m0 + wm0,
                                   n0 + wn0, hw, c);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    kernel(const T* __restrict__ x, const T* __restrict__ w1,
           const float* __restrict__ b1, const T* __restrict__ w2,
           const float* __restrict__ b2, T* __restrict__ out, T* workspace,
           int nb, int h, int w, int c) {
  extern __shared__ __align__(16) unsigned char smem_general[];
  // launch stamp: 30
  using G = Tile<T>;
  constexpr int kElem = sizeof(T), BM = G::kBM;
  const int sp = span(h, w, c, kElem, BM);
  const int srows = slab_rows(h, w, sp, kElem, BM);
  T* ring = reinterpret_cast<T*>(smem_general);
  T* slabs = ring + G::kStages * G::kBElems;
  const size_t sample = (size_t)h * w * c;
  if (y_in_smem(h, w, c, kElem, BM)) {
    T* ys = slabs + slab_slots(c, sp, kElem) * srows * G::kAStride;
    // the padding channels and the zero rows are read, never written; the
    // first tile's barrier publishes the zeros
    for (int i = threadIdx.x; i < y_bytes(h, w, c, kElem) / 16; i += kThreads)
      reinterpret_cast<uint4*>(ys)[i] = make_uint4(0, 0, 0, 0);
    const int ld = y_stride(c, kElem);
    for (int b = blockIdx.x; b < nb; b += gridDim.x) {
      const T* xb = x + b * sample;
      // stamp: 0
      conv<T, BM, false, false>(xb, nullptr, w1, b1, xb, ys, ld, h, w, c,
                                sp, ring, slabs, b, 0, 1);
      // stamp: 2
      conv<T, BM, true, true>(nullptr, ys, w2, b2, xb, out + b * sample, c,
                              h, w, c, sp, ring, slabs, b, 0, 1);
      // stamp: 4
    }
    // launch stamp: 31
    return;
  }
  T* ys = workspace + blockIdx.x * sample;  // this CTA's y, stride C
  for (int b = blockIdx.x; b < nb; b += gridDim.x) {
    const T* xb = x + b * sample;
    conv<T, BM, false, false>(xb, nullptr, w1, b1, xb, ys, c, h, w, c, sp,
                              ring, slabs, b, 0, 1);
    conv<T, BM, true, false>(ys, nullptr, w2, b2, xb, out + b * sample, c, h,
                             w, c, sp, ring, slabs, b, 0, 1);
  }
  // launch stamp: 31
}

}  // namespace general

// ---------------------------------------------------------------------------
// split: bf16, one sample spread over the CTAs of a thread-block cluster

namespace split {

using T = __nv_bfloat16;
constexpr int BM = 64;           // pixels of an output tile
constexpr int kClusterMax = 16;  // CTAs of a cluster (above 8: non-portable)

// Output tiles of one sample: bands of BM pixels x 64-channel groups,
// dealt to the cluster's ranks in turn (tile t to rank t mod K).
__host__ __device__ constexpr int tiles(int h, int w, int c) {
  return (h * w + BM - 1) / BM * ((c + general::BN - 1) / general::BN);
}
__host__ __device__ constexpr bool y_in_smem(int h, int w, int c) {
  return general::y_in_smem(h, w, c, 2, BM);
}
__host__ __device__ constexpr int smem_bytes(int h, int w, int c) {
  return general::smem_bytes(h, w, c, 2, BM);
}
// The shapes it takes: whole 16 B chunks of channels, so that y moves
// between ranks 16 B at a time.
__host__ __device__ constexpr bool fits(int h, int w, int c) {
  return c % 8 == 0 && smem_bytes(h, w, c) <= kSmemLimit;
}

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}
__device__ __forceinline__ int cluster_ranks() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return (int)r;
}
__device__ __forceinline__ int cluster_index() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return (int)r;
}
// Every thread of the cluster arrives, releasing its writes, then waits
// for all, acquiring theirs.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// 16 B of rank `rank`'s shared memory at this CTA's shared address `addr`
// (distributed shared memory).
__device__ __forceinline__ uint4 ld_peer16(uint32_t addr, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(addr), "r"(rank));
  uint4 v;
  asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

// y's rows [lo, hi), all C channels, into this CTA's copy of y: every 16
// B chunk that another rank's conv 1 tile wrote comes from that rank's
// copy, at the same offset (every rank lays out its shared memory alike).
// kBatch loads in flight a thread.
template <int kTileM>
__device__ void gather(T* ys, int ld, int lo, int hi, int c, int rank,
                       int ranks) {
  constexpr int kBatch = 4;
  const int cpr = c / 8, ntn = (c + general::BN - 1) / general::BN;
  const int n = (hi - lo) * cpr;
  const uint32_t base = smem_u32(ys);
  for (int i0 = threadIdx.x; i0 < n; i0 += kThreads * kBatch) {
    uint4 v[kBatch];
    uint32_t off[kBatch];
    bool take[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = i0 + k * kThreads;
      const int p = lo + i / cpr, j = i % cpr;  // pixel, channel chunk
      const int owner = (p / kTileM * ntn + j / 8) % ranks;
      take[k] = i < n && owner != rank;
      off[k] = (uint32_t)(p * ld + j * 8) * 2;
      if (take[k]) v[k] = ld_peer16(base + off[k], owner);
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      if (take[k])
        *reinterpret_cast<uint4*>(reinterpret_cast<unsigned char*>(ys) +
                                  off[k]) = v[k];
  }
}

// One sample a cluster: cluster b runs sample b, its rank r the tiles r,
// r + K, ... of each conv (general::conv, tiles of kTileM pixels).
template <int kTileM>
__global__ void __launch_bounds__(kThreads, 1)
    kernel(const T* __restrict__ x, const T* __restrict__ w1,
           const float* __restrict__ b1, const T* __restrict__ w2,
           const float* __restrict__ b2, T* __restrict__ out, T* workspace,
           int h, int w, int c) {
  extern __shared__ __align__(16) unsigned char smem_split[];
  // launch stamp: 30
  using G = general::Tile<T, kTileM>;
  const int rank = cluster_rank(), ranks = cluster_ranks();
  const int b = cluster_index();  // the sample
  const int sp = general::span(h, w, c, 2, kTileM);
  const int srows = general::slab_rows(h, w, sp, 2, kTileM);
  T* ring = reinterpret_cast<T*>(smem_split);
  T* slabs = ring + G::kStages * G::kBElems;
  const size_t sample = (size_t)h * w * c;
  const T* xb = x + b * sample;
  T* ob = out + b * sample;
  if (general::y_in_smem(h, w, c, 2, kTileM)) {
    T* ys = slabs + general::slab_slots(c, sp, 2) * srows * G::kAStride;
    // the padding channels and the zero rows are read, never written; so
    // are the rows this rank neither writes nor gathers
    for (int i = threadIdx.x; i < general::y_bytes(h, w, c, 2) / 16;
         i += kThreads)
      reinterpret_cast<uint4*>(ys)[i] = make_uint4(0, 0, 0, 0);
    const int ld = general::y_stride(c, 2);
    // stamp: 0
    general::conv<T, kTileM, false, false>(xb, nullptr, w1, b1, xb, ys, ld,
                                           h, w, c, sp, ring, slabs, b, rank,
                                           ranks);
    // stamp: 2
    cluster_arrive();
    cluster_wait();  // every rank's y tiles written
    // stamp: 5
    // each band this rank's conv 2 tiles cover, with the w + 1 rows above
    // and below that its taps reach
    const int hw = h * w, ntn = (c + general::BN - 1) / general::BN;
    const int count = (hw + kTileM - 1) / kTileM * ntn;
    for (int t = rank, last = -1; t < count; t += ranks) {
      const int band = t / ntn;
      if (band == last) continue;
      last = band;
      gather<kTileM>(ys, ld, max(0, band * kTileM - w - 1),
                     min(hw, (band + 1) * kTileM + w + 1), c, rank, ranks);
    }
    // done reading the peers' y; conv 2's first block barrier publishes
    // the gathered rows to every warp
    cluster_arrive();
    // stamp: 6
    general::conv<T, kTileM, true, true>(nullptr, ys, w2, b2, xb, ob, c, h,
                                         w, c, sp, ring, slabs, b, rank,
                                         ranks);
    // stamp: 4
    cluster_wait();  // no peer reads this CTA's y any more
  } else {
    // y of the sample in the workspace: the cluster barrier orders every
    // rank's y stores before any rank's slab copies (cp.async.cg reads L2)
    T* ys = workspace + b * sample;
    general::conv<T, kTileM, false, false>(xb, nullptr, w1, b1, xb, ys, c, h,
                                           w, c, sp, ring, slabs, b, rank,
                                           ranks);
    __threadfence();
    cluster_arrive();
    cluster_wait();
    general::conv<T, kTileM, true, false>(ys, nullptr, w2, b2, xb, ob, c, h,
                                          w, c, sp, ring, slabs, b, rank,
                                          ranks);
  }
  // launch stamp: 31
}

}  // namespace split

// ---------------------------------------------------------------------------
// host side

// The batch below which a bf16 block runs split rather than the variant
// that takes its shape otherwise (chip_smoke.py's kernel_vs_plain rows:
// split faster than that variant at every batch below; mirrored by
// ops/resblock.py's SPLIT_BELOW).
constexpr int kSplitBelowResident = 17;
constexpr int kSplitBelowStreaming = 5;
constexpr int kSplitBelowGeneral = 2;

// Multiprocessors of the current device, read once a device.
int sm_count() {
  static int cached[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && cached[dev]) return cached[dev];
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (dev < 64) cached[dev] = sms;
  return sms;
}

int persistent_grid(int b) {
  const int sms = sm_count();
  return b < sms ? b : sms;
}

// CTAs of the split variant's cluster: enough for one sample's tiles (a
// power of two from 2 to kClusterMax), halved while a batch's clusters
// would hold more than half the SMs (down to 2). A cluster's CTAs share
// one GPC, at one a SM where shared memory passes half an SM's, so at
// most half the SMs' worth of clusters of 16 run at once (H100: under 8
// clusters of 16; alphafive_resblock_active_clusters).
int cluster_size(int b, int h, int w, int c) {
  const int t = split::tiles(h, w, c);
  int k = 2;
  while (k < split::kClusterMax && k < t) k *= 2;
  while (k > 2 && (long long)b * k > sm_count() / 2) k /= 2;
  return k;
}

// Whether `variant` takes this shape (alphafive_resblock_as launches a
// variant by name only where it does).
bool takes(int variant, int dtype, int h, int w, int c) {
  if ((dtype != 0 && dtype != 1) || h < 1 || w < 1 || c < 1) return false;
  const bool fast = c == 64 || c == 96 || c == 128;  // instantiated widths
  switch (variant) {
    case kResident:
      return dtype == 1 && c == 64 && resident::fits(h, w);
    case kStreaming:
      return dtype == 1 && fast && streaming::fits(h, w, c);
    case kTiled:
      return dtype == 0 && c == 64 && h * w <= 256 &&
             tiled::smem_bytes(h, w) <= kSmemLimit;
    case kGeneral:
      return true;
    case kSplit:
      return dtype == 1 && split::fits(h, w, c);
  }
  return false;
}

int resblock_variant(int dtype, int b, int h, int w, int c) {
  if ((dtype != 0 && dtype != 1) || h < 1 || w < 1 || c < 1) return kRefused;
  int v = kGeneral;
  if (dtype == 1) {
    if (takes(kResident, dtype, h, w, c))
      v = kResident;
    else if (takes(kStreaming, dtype, h, w, c))
      v = kStreaming;
    const int below = v == kResident    ? kSplitBelowResident
                      : v == kStreaming ? kSplitBelowStreaming
                                        : kSplitBelowGeneral;
    // a sample of one tile leaves a cluster nothing to split
    if (b >= 1 && b < below && split::tiles(h, w, c) >= 2 &&
        takes(kSplit, dtype, h, w, c))
      return kSplit;
    return v;
  }
  if (takes(kTiled, dtype, h, w, c)) return kTiled;
  return kGeneral;
}

// Bytes of device workspace `variant` needs for a batch of b: the
// streaming variant's packed taps; y of each sample (split) or of one
// sample per CTA (general) where it does not fit in shared memory; else 0.
long long workspace_bytes(int variant, int dtype, int b, int h, int w,
                          int c) {
  if (b < 1) return 0;
  if (variant == kStreaming) return (long long)streaming::kTaps * c * c * 2;
  if (variant == kSplit)
    return split::y_in_smem(h, w, c) ? 0 : (long long)b * h * w * c * 2;
  if (variant != kGeneral) return 0;
  const int elem = dtype == 1 ? 2 : 4;
  if (general::y_in_smem(h, w, c, elem)) return 0;
  return (long long)persistent_grid(b) * h * w * c * elem;
}

// Each kernel's attributes, set once a device: room for the largest
// dynamic shared memory any shape asks, and (cluster kernels) clusters
// above 8 CTAs.
template <typename K>
cudaError_t prepare(K kernel, bool cluster) {
  static std::mutex mu;
  static std::set<std::pair<const void*, int>> ready;
  int dev = 0;
  cudaGetDevice(&dev);
  const auto key = std::make_pair(reinterpret_cast<const void*>(kernel), dev);
  std::lock_guard<std::mutex> lock(mu);
  if (ready.count(key)) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (err == cudaSuccess && cluster)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) ready.insert(key);
  return err;
}

template <typename K, typename... Args>
cudaError_t launch(K kernel, int grid, int threads, int smem,
                   cudaStream_t stream, Args... args) {
  const cudaError_t err = prepare(kernel, false);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// Both convs' taps into the streaming kernel's layout at `taps`
// (kTaps * c * c * 2 bytes), on stream s.
cudaError_t pack_streaming_taps(const void* w1, const void* w2, void* taps,
                                int c, cudaStream_t s) {
  const int pieces = streaming::kTaps * c * c / 8;
  streaming::pack_taps<<<(pieces + kThreads - 1) / kThreads, kThreads, 0,
                         s>>>(static_cast<const uint4*>(w1),
                              static_cast<const uint4*>(w2),
                              static_cast<uint4*>(taps), c);
  return cudaGetLastError();
}

// The pack, then the block, on the same stream: a graph that captures the
// call holds both.
template <int C>
cudaError_t launch_streaming(const void* x, const void* w1, const void* b1,
                             const void* w2, const void* b2, void* out,
                             void* taps, int b, int h, int w,
                             cudaStream_t s) {
  const cudaError_t err = pack_streaming_taps(w1, w2, taps, C, s);
  if (err != cudaSuccess) return err;
  return launch(streaming::bf16_kernel<C>, persistent_grid(b),
                streaming::kThreadsS, streaming::smem_bytes(w, C), s,
                static_cast<const __nv_bfloat16*>(x),
                static_cast<const __nv_bfloat16*>(taps),
                static_cast<const float*>(b1),
                static_cast<const float*>(b2),
                static_cast<__nv_bfloat16*>(out), b, h, w);
}

template <typename T>
cudaError_t launch_general(const void* x, const void* w1, const void* b1,
                           const void* w2, const void* b2, void* out,
                           void* workspace, int b, int h, int w, int c,
                           cudaStream_t s) {
  return launch(general::kernel<T>, persistent_grid(b), kThreads,
                general::smem_bytes(h, w, c, sizeof(T)), s,
                static_cast<const T*>(x), static_cast<const T*>(w1),
                static_cast<const float*>(b1), static_cast<const T*>(w2),
                static_cast<const float*>(b2), static_cast<T*>(out),
                static_cast<T*>(workspace), b, h, w, c);
}

// Split launches whose cluster of 16 could not be co-scheduled at their
// shared memory and ran as clusters of 8 (a launch choice, reported by
// alphafive_resblock_narrowed).
std::atomic<long long> narrowed{0};

// Clusters of k CTAs of `kernel` at `smem` bytes the device can hold at
// once, asked once per (k, smem, device).
template <typename K>
int active_clusters(K kernel, int k, int smem) {
  static std::mutex mu;
  static std::map<std::tuple<int, int, int>, int> known;
  int dev = 0;
  cudaGetDevice(&dev);
  const auto key = std::make_tuple(k, smem, dev);
  std::lock_guard<std::mutex> lock(mu);
  const auto it = known.find(key);
  if (it != known.end()) return it->second;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(k);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();  // a refused query leaves no error behind
    n = 0;
  }
  known[key] = n;
  return n;
}

// One cluster of cluster_size(b, h, w, c) CTAs a sample.
cudaError_t launch_split(const void* x, const void* w1, const void* b1,
                         const void* w2, const void* b2, void* out,
                         void* workspace, int b, int h, int w, int c,
                         cudaStream_t s) {
  using T = __nv_bfloat16;
  const auto kernel = split::kernel<split::BM>;
  cudaError_t err = prepare(kernel, true);
  if (err != cudaSuccess) return err;
  const int smem = split::smem_bytes(h, w, c);
  int k = cluster_size(b, h, w, c);
  if (k > 8 && active_clusters(kernel, k, smem) < 1) {
    k = 8;
    ++narrowed;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(b * k);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const float*>(b1), static_cast<const T*>(w2),
      static_cast<const float*>(b2), static_cast<T*>(out),
      static_cast<T*>(workspace), h, w, c);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// `variant` on this batch and shape; cudaErrorInvalidValue where it does
// not take the shape or a workspace it needs is missing.
cudaError_t launch_variant(int variant, int dtype, const void* x,
                           const void* w1, const void* b1, const void* w2,
                           const void* b2, void* out, void* workspace, int b,
                           int h, int w, int c, cudaStream_t s) {
  if (b == 0) return cudaSuccess;
  if (b < 0 || !takes(variant, dtype, h, w, c)) return cudaErrorInvalidValue;
  if (workspace_bytes(variant, dtype, b, h, w, c) > 0 && workspace == nullptr)
    return cudaErrorInvalidValue;
  switch (variant) {
    case kResident: {
      const auto* xb = static_cast<const __nv_bfloat16*>(x);
      const auto* w1b = static_cast<const __nv_bfloat16*>(w1);
      const auto* w2b = static_cast<const __nv_bfloat16*>(w2);
      const auto* b1f = static_cast<const float*>(b1);
      const auto* b2f = static_cast<const float*>(b2);
      auto* ob = static_cast<__nv_bfloat16*>(out);
      const int grid = persistent_grid(b);
      const int smem = resident::smem_bytes(h, w);
      if (resident::positions_per_wg(h, w) == 48)
        return launch(resident::kernel<48>, grid, kThreads, smem, s, xb, w1b,
                      b1f, w2b, b2f, ob, b, h, w);
      return launch(resident::kernel<120>, grid, kThreads, smem, s, xb, w1b,
                    b1f, w2b, b2f, ob, b, h, w);
    }
    case kTiled:
      return launch(tiled::kernel, persistent_grid(b), kThreads,
                    tiled::smem_bytes(h, w), s, static_cast<const float*>(x),
                    static_cast<const float*>(w1),
                    static_cast<const float*>(b1),
                    static_cast<const float*>(w2),
                    static_cast<const float*>(b2), static_cast<float*>(out),
                    b, h, w);
    case kGeneral:
      if (dtype == 1)
        return launch_general<__nv_bfloat16>(x, w1, b1, w2, b2, out,
                                             workspace, b, h, w, c, s);
      return launch_general<float>(x, w1, b1, w2, b2, out, workspace, b, h,
                                   w, c, s);
    case kSplit:
      return launch_split(x, w1, b1, w2, b2, out, workspace, b, h, w, c, s);
    case kStreaming:
      switch (c) {
        case 64:
          return launch_streaming<64>(x, w1, b1, w2, b2, out, workspace, b,
                                      h, w, s);
        case 96:
          return launch_streaming<96>(x, w1, b1, w2, b2, out, workspace, b,
                                      h, w, s);
        case 128:
          return launch_streaming<128>(x, w1, b1, w2, b2, out, workspace, b,
                                       h, w, s);
      }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Which kernel alphafive_resblock runs for a batch of b at this shape: 0
// streaming (bf16), 1 resident (bf16), 2 tiled (f32), 4 general (either
// type, any C >= 1 and board), 5 split (bf16, below the batches
// kSplitBelow*), -1 refused (a dtype other than 0 or 1, or a dimension
// below 1).
extern "C" int alphafive_resblock_variant(int dtype, int b, int h, int w,
                                          int c) {
  return resblock_variant(dtype, b, h, w, c);
}

// Bytes of device workspace alphafive_resblock needs for this batch and
// shape (the streaming variant's packed taps; y where it does not fit in
// shared memory: each sample's for split, each CTA's for general; else
// 0); the caller allocates it and passes it as `workspace`.
extern "C" long long alphafive_resblock_workspace(int dtype, int b, int h,
                                                  int w, int c) {
  return workspace_bytes(resblock_variant(dtype, b, h, w, c), dtype, b, h, w,
                         c);
}

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on success);
// the caller has checked shapes, types, contiguity and alignment, and
// passes alphafive_resblock_workspace bytes at `workspace` (may be null
// when that is 0). Launches on `stream` and does not synchronise.
extern "C" int alphafive_resblock(int dtype, const void* x, const void* w1,
                                  const void* b1, const void* w2,
                                  const void* b2, void* out, void* workspace,
                                  int b, int h, int w, int c, void* stream) {
  return launch_variant(resblock_variant(dtype, b, h, w, c), dtype, x, w1,
                        b1, w2, b2, out, workspace, b, h, w, c,
                        static_cast<cudaStream_t>(stream));
}

// The same block by the variant named (a code of enum Variant) where that
// variant takes the shape, else cudaErrorInvalidValue: for timing one
// variant against another at one shape. The main path calls
// alphafive_resblock.
extern "C" int alphafive_resblock_as(int variant, int dtype, const void* x,
                                     const void* w1, const void* b1,
                                     const void* w2, const void* b2,
                                     void* out, void* workspace, int b, int h,
                                     int w, int c, void* stream) {
  return launch_variant(variant, dtype, x, w1, b1, w2, b2, out, workspace, b,
                        h, w, c, static_cast<cudaStream_t>(stream));
}

// alphafive_resblock_as's workspace bytes for `variant`.
extern "C" long long alphafive_resblock_workspace_as(int variant, int dtype,
                                                     int b, int h, int w,
                                                     int c) {
  return workspace_bytes(variant, dtype, b, h, w, c);
}

// Split launches so far that ran clusters of 8 where 16 could not be
// co-scheduled.
extern "C" long long alphafive_resblock_narrowed() { return narrowed; }

// Clusters of k split CTAs at the shared memory of an h x w x c block
// that the device can run at once (cudaOccupancyMaxActiveClusters; 0
// where it refuses the size).
extern "C" int alphafive_resblock_active_clusters(int k, int h, int w,
                                                  int c) {
  const auto kernel = split::kernel<split::BM>;
  if (prepare(kernel, true) != cudaSuccess) return 0;
  return active_clusters(kernel, k, split::smem_bytes(h, w, c));
}

// The streaming kernel's tap pack alone (alphafive_resblock runs it before
// each streaming launch): w1/w2 bf16 [9][c][c], c a multiple of 8, into
// `taps`, 18 * c * c * 2 bytes, on `stream`. Returns a cudaError_t.
extern "C" int alphafive_resblock_pack_taps(const void* w1, const void* w2,
                                            void* taps, int c, void* stream) {
  if (c < 8 || c % 8) return cudaErrorInvalidValue;
  return pack_streaming_taps(w1, w2, taps, c,
                             static_cast<cudaStream_t>(stream));
}
