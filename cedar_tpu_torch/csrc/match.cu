// Hand-written Hopper kernels for the fused rule match (sm_90a): int8
// tensor cores (wgmma) fed by the Tensor Memory Accelerator (TMA).
//
// Entry points (one mainloop, two epilogues):
//
// match_groups_kernel
//   Replaces: cedar_tpu/ops/pallas_match.py pallas_first_match (_kernel,
//   pallas_call at l.276; contraction + group reduction in _accum_blocks,
//   l.76). Used by the want_full path.
//   Computes: score = lit @ W (int8 x int8 -> int32, exact), sat = score >=
//   thresh, then per request row and group g < G the minimum ("first") and
//   maximum ("last") rule_policy over the satisfied rules of group g.
//
// match_words_kernel
//   Replaces: pallas_match_words (_words_kernel, pallas_call at l.361).
//   Used by the serving path. The same mainloop and group reduction, then
//   the tier walk fused into the epilogue: one packed verdict word per row
//   (code bits 30-31, err 29, multi 28, gate 27, policy 0-23). One launch
//   per batch, as the Pallas kernel is one pallas_call.
//
// Operands: lit [B, L] int8 row-major and the rule plane Wt [R, L] int8,
// both K-major (literals contiguous), L a multiple of 64 (zero columns pad
// it; they add 0 to every score). Hopper's int8 wgmma takes both operands
// K-major from shared memory and has no transpose for 8-bit types, so the
// engine stores the plane K-major once at load and never transposes per
// call.
//
// Bound on the H100: 2*B*L*R int8 operations against B*L + L*R bytes.
// Serving batches of a few thousand rows are operation-bound (int8 tensor
// peak); batches of up to a few hundred rows are bound by reading the plane
// once from HBM (the 10k-policy plane, 63 MB, does not fit the 50 MB L2).
//
// Design:
//   * Tiles: each CTA owns 128 request rows x BN rules. BN = 256 for large
//     grids: every 128-literal stage then brings 48 KB through L2 for 8.4 M
//     int8 ops, and L2 bandwidth, not the tensor cores, is what a narrower
//     tile runs out of at the serving plane's batch-4096 shape. BN = 128
//     for mid-size grids and 64 for small batches, so that enough CTAs
//     stream the plane at once. The grid runs
//     row tiles fastest, so the CTAs in flight share a few plane tiles and
//     the plane is read from HBM about once.
//   * Copies: one producer thread issues TMA loads of the lit tile [128 rows
//     x 128 B] and the Wt tile [BN rules x 128 B] with the 128-byte swizzle
//     into a ring of STAGES stages guarded by full / empty mbarriers. TMA
//     zero-fills rows past B, rules past R and literals past L, so loads need
//     no masks. A batch under 128 rows loads a lit box of B rows rounded up
//     to 8 instead: TMA's zero fill of a mostly out-of-bounds box is slow
//     (a 1-row batch took longer than a 128-row one), and the rows of the
//     tile it leaves unwritten are masked like any row >= B.
//   * Math: two consumer warpgroups (64 rows each) run
//     wgmma.mma_async m64nBNk32.s32.s8.s8, four per 128-byte stage, with the
//     int32 accumulators in registers; shared-memory descriptors use the
//     same 128-byte swizzle as the TMA maps.
//   * Epilogue: each accumulator is compared with its column's thresh and
//     folded into per-(row, group) min/max in shared memory that reuses the
//     drained ring (thresh, group and policy of the tile's columns staged
//     once per CTA), then one
//     atomicMin / atomicMax per touched (row, group) merges the tile into
//     first/last, which the wrapper fills with INT32_MAX / -1. Blocks run in
//     no order; min and max are order-free, so the result is exact and
//     deterministic. Rows >= B and columns >= R are masked.
//   * Fused words: after its atomics a CTA counts its row tile's arrival
//     down with release order; the CTA that arrives last takes acquire
//     order, reads the tile's first/last back through L2 and walks the
//     tiers. Its scratch is one int32 buffer that the wrapper fills with
//     INT32_MAX in one pass: the arrival counters (counted down from
//     INT32_MAX), first, and last stored as its bitwise complement (so a
//     min of ~policy keeps the max policy, and INT32_MAX means none).
//
// Both entry points launch on the caller's stream, allocate nothing and
// return cudaGetLastError() (or a negative code, see cedar_error_string)
// so the Python wrapper can raise on a refused launch. The TMA descriptors
// are encoded on the host through libcuda's cuTensorMapEncodeTiled: the
// plane's once per compiled set (cedar_tensor_map), the lit matrix's in
// the launch call (its address changes every batch). Both go by value as
// __grid_constant__ kernel parameters.

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int BM = 128;          // request rows per CTA
constexpr int BK = 128;          // literals (bytes) per stage: one swizzle row
constexpr int WG_K = 32;         // literals per wgmma (k32 for 8-bit types)
constexpr int THREADS = 384;     // producer warpgroup + two consumer warpgroups
constexpr int CONSUMER_WARPS = 8;
constexpr int MAX_GROUPS = 32;   // G limit (shared-memory epilogue)
constexpr int32_t I32_MAX = 0x7fffffff;
constexpr uint32_t POLICY_NONE = 0xFFFFFFu;

template <int BN>
struct Tile {
  static constexpr int STAGES = 4;
  static constexpr int MIN_BLOCKS = BN == 64 ? 2 : 1;
  static constexpr int A_BYTES = BM * BK;
  static constexpr int B_BYTES = BN * BK;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  // the ring; after the mainloop the per-(row, group) min and max fold
  // into its first 2 * BM * G * 4 bytes (at most 32 KB)
  static constexpr int RING = STAGES * STAGE_BYTES;
  static constexpr int BARS = RING;                      // 2 * STAGES mbarriers
  static constexpr int FLAG = BARS + 2 * STAGES * 8;     // last-arrival flag
  static constexpr int COLS = FLAG + 16;                 // thresh, group, policy
  // dynamic shared memory, with 1024 bytes of slack to align the ring
  static constexpr int SMEM_BYTES = 1024 + COLS + 3 * BN * 4;
  static_assert(RING >= 2 * BM * MAX_GROUPS * 4, "the fold must fit the ring");
};

// rows of the lit TMA box (the map must be encoded with them): a full tile,
// or a batch under one tile rounded up to 8
constexpr int lit_box_rows(int B) { return B >= BM ? BM : (B + 7) / 8 * 8; }

struct Params {
  const int32_t* thresh;
  const int32_t* group;
  const int32_t* policy;
  int32_t* first;
  int32_t* last;      // match_words_kernel: ~last, merged by min
  int32_t* words;     // match_words_kernel only
  int32_t* arrivals;  // match_words_kernel only: one counter per row tile
  int B, L, R, G, n_tiers, has_gate;
  int lit_box_bytes;  // bytes of one lit box: its rows (<= BM) x BK
};

// ---------------------------------------------------------------- PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c_inner, int c_outer) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c_inner), "r"(c_outer)
      : "memory");
}

// wgmma shared-memory descriptor: K-major tile with the 128-byte swizzle,
// 8-row groups 1024 bytes apart (SBO); LBO is unused for swizzled K-major
// layouts. The tile must start 1024-byte aligned (base offset 0); stepping
// by k32 inside the 128-byte row adds 32 bytes to the start address.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// D[64 x N] += A[64 x 32] * B[N x 32]^T, int8 in, int32 accumulate; both
// operands K-major in shared memory
__device__ __forceinline__ void wgmma_m64n128k32(int32_t (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n64k32(int32_t (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n256k32(int32_t (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103,"
      " %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119,"
      " %120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}


template <int BN>
__device__ __forceinline__ void wgmma_tile(int32_t (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 256) {
    wgmma_m64n256k32(d, da, db);
  } else if constexpr (BN == 128) {
    wgmma_m64n128k32(d, da, db);
  } else {
    wgmma_m64n64k32(d, da, db);
  }
}

// keeps the compiler from reading an accumulator before the wgmma that
// writes it has been waited for
__device__ __forceinline__ void fence_operand(int32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// ---------------------------------------------------------------- tier walk

// One row's verdict word from its first groups and the complements ~last
// of its last groups, read through L2 (the other CTAs' atomics landed
// there). Only the deciding group's last is read, and it matched.
__device__ __forceinline__ uint32_t tier_walk_word(const int32_t* f, const int32_t* nl, int n_tiers,
                                                   int has_gate) {
  uint32_t code = 0, err = 0, multi = 0, pol = POLICY_NONE;
  bool done = false;
  for (int t = 0; t < n_tiers; ++t) {
    const int32_t p_f = __ldcg(f + 3 * t), f_f = __ldcg(f + 3 * t + 1), e_f = __ldcg(f + 3 * t + 2);
    const bool has_p = p_f != I32_MAX;
    const bool has_f = f_f != I32_MAX;
    const bool has_e = e_f != I32_MAX;
    const uint32_t c_t = has_f ? 2u : has_p ? 1u : has_e ? 3u : 0u;
    const int32_t win_first = has_f ? f_f : has_p ? p_f : e_f;
    const int32_t win_last =
        ~(has_f ? __ldcg(nl + 3 * t + 1) : has_p ? __ldcg(nl + 3 * t) : __ldcg(nl + 3 * t + 2));
    const bool sig = c_t != 0u;
    if (!done && sig) {
      code = c_t;
      pol = static_cast<uint32_t>(win_first);
      if (has_e && (has_p || has_f)) err = 1u;
      if (win_first != win_last) multi = 1u;
    }
    done = done || sig;
  }
  uint32_t word = (code << 30) | (err << 29) | (multi << 28) | (pol & POLICY_NONE);
  if (has_gate && __ldcg(f + 3 * n_tiers) != I32_MAX) word |= 1u << 27;
  return word;
}

// ---------------------------------------------------------------- the kernel

template <int BN, bool WORDS>
__device__ __forceinline__ void match_body(const CUtensorMap* tm_lit, const CUtensorMap* tm_w,
                                           const Params& p) {
  using T = Tile<BN>;
  extern __shared__ uint8_t smem_raw[];
  // the swizzled stages must start 1024-byte aligned
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t ring = smem_u32(smem);
  const uint32_t full_bar = ring + T::BARS;            // STAGES x 8 bytes
  const uint32_t empty_bar = full_bar + T::STAGES * 8;  // STAGES x 8 bytes
  int* s_flag = reinterpret_cast<int*>(smem + T::FLAG);
  int32_t* s_th = reinterpret_cast<int32_t*>(smem + T::COLS);
  int32_t* s_g = s_th + BN;
  int32_t* s_p = s_g + BN;
  int32_t* s_min = reinterpret_cast<int32_t*>(smem);  // in the ring, after the mainloop
  const int G = p.G;
  int32_t* s_max = s_min + BM * G;

  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * BM;
  const int r0 = blockIdx.y * BN;
  const int n_k = (p.L + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);                 // the producer's arrive + tx bytes
      mbar_init(empty_bar + 8 * s, CONSUMER_WARPS);   // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // the tile's rule columns; groups outside [0, G) and columns past R never
  // contribute (group -1)
  for (int c = tid; c < BN; c += THREADS) {
    const int col = r0 + c;
    int32_t th = 0, g = -1, pol = 0;
    if (col < p.R) {
      th = p.thresh[col];
      g = p.group[col];
      pol = p.policy[col];
      if (g < 0 || g >= G) g = -1;
    }
    s_th[c] = th;
    s_g[c] = g;
    s_p[c] = pol;
  }
  __syncthreads();

  const int wg = tid / 128;
  // consumer warpgroup c = wg - 1 owns rows 64c .. 64c + 63 of the tile
  const int c = wg - 1;
  int32_t acc[BN / 2];
  if (wg == 0) {
    // producer: one thread keeps the ring full
    if (tid == 0) {
      for (int k = 0; k < n_k; ++k) {
        const int s = k % T::STAGES;
        if (k >= T::STAGES) mbar_wait(empty_bar + 8 * s, ((k / T::STAGES) & 1) ^ 1);
        const uint32_t a = ring + s * T::STAGE_BYTES;
        mbar_expect_tx(full_bar + 8 * s, p.lit_box_bytes + T::B_BYTES);
        tma_load_2d(a, tm_lit, full_bar + 8 * s, k * BK, b0);
        tma_load_2d(a + T::A_BYTES, tm_w, full_bar + 8 * s, k * BK, r0);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    for (int k = 0; k < n_k; ++k) {
      const int s = k % T::STAGES;
      mbar_wait(full_bar + 8 * s, (k / T::STAGES) & 1);
      const uint32_t a = ring + s * T::STAGE_BYTES + c * 64 * BK;
      const uint32_t b = ring + s * T::STAGE_BYTES + T::A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / WG_K; ++kk)
        wgmma_tile<BN>(acc, smem_desc(a + kk * WG_K), smem_desc(b + kk * WG_K));
      wgmma_commit();
      wgmma_wait_all();
      if ((tid & 31) == 0) mbar_arrive(empty_bar + 8 * s);
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) fence_operand(acc[i]);
  }
  // every stage has been loaded and read: the ring is free for the fold
  __syncthreads();
  for (int i = tid; i < BM * G; i += THREADS) {
    s_min[i] = I32_MAX;
    s_max[i] = -1;
  }
  __syncthreads();
  if (wg != 0) {
    // fold: accumulator acc[4i + 2j + q] of thread (warp w, lane l) holds
    // row 16w + l/4 + 8j, column 8i + 2(l%4) + q of the warpgroup's tile
    const int t = tid - 128 * wg;
    const int lane = t & 31;
    const int row0 = 64 * c + 16 * (t >> 5) + (lane >> 2);
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int col = 8 * i + 2 * (lane & 3) + q;
        const int32_t g = s_g[col];
        if (g < 0) continue;
        const int32_t th = s_th[col];
        const int32_t pol = s_p[col];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (acc[4 * i + 2 * j + q] >= th) {
            const int idx = (row0 + 8 * j) * G + g;
            atomicMin(&s_min[idx], pol);
            atomicMax(&s_max[idx], pol);
          }
        }
      }
    }
  }
  __syncthreads();

  // one global atomic per (row, group) the tile touched; i = row * G + g
  for (int i = tid; i < BM * G; i += THREADS) {
    if (b0 + i / G >= p.B) break;
    const int32_t mn = s_min[i];
    const int32_t mx = s_max[i];
    if (mn != I32_MAX) atomicMin(&p.first[static_cast<size_t>(b0) * G + i], mn);
    if (mx != -1) {
      if constexpr (WORDS) {
        atomicMin(&p.last[static_cast<size_t>(b0) * G + i], ~mx);
      } else {
        atomicMax(&p.last[static_cast<size_t>(b0) * G + i], mx);
      }
    }
  }

  if constexpr (WORDS) {
    // the last CTA to finish its row tile walks the tiers for it: every
    // thread's atomics are ordered before the barrier, the fence releases
    // them with the arrival, and the last arrival fences again to acquire
    // the other CTAs' atomics. Arrivals count down from INT32_MAX.
    __syncthreads();
    if (tid == 0) {
      __threadfence();
      const int prev = atomicSub(&p.arrivals[blockIdx.x], 1);
      const bool last = prev == I32_MAX - (static_cast<int>(gridDim.y) - 1);
      if (last) __threadfence();
      *s_flag = last;
    }
    __syncthreads();
    if (*s_flag && tid < BM) {
      const int b = b0 + tid;
      if (b < p.B) {
        const size_t o = static_cast<size_t>(b) * G;
        p.words[b] = static_cast<int32_t>(
            tier_walk_word(p.first + o, p.last + o, p.n_tiers, p.has_gate));
      }
    }
  }
}

template <int BN>
__global__ void __launch_bounds__(THREADS, Tile<BN>::MIN_BLOCKS)
    match_groups_kernel(const __grid_constant__ CUtensorMap tm_lit,
                        const __grid_constant__ CUtensorMap tm_w, const Params p) {
  match_body<BN, false>(&tm_lit, &tm_w, p);
}

template <int BN>
__global__ void __launch_bounds__(THREADS, Tile<BN>::MIN_BLOCKS)
    match_words_kernel(const __grid_constant__ CUtensorMap tm_lit,
                       const __grid_constant__ CUtensorMap tm_w, const Params p) {
  match_body<BN, true>(&tm_lit, &tm_w, p);
}

template <int BN, bool WORDS>
int launch(const CUtensorMap& a, const void* tm_w, const Params& p, void* stream) {
  CUtensorMap b;
  memcpy(&b, tm_w, sizeof(b));
  // the ring is above the 48 KB default: raise the kernel's limit once per
  // device (to the size at MAX_GROUPS, which covers every G)
  static bool configured[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!configured[dev]) {
    const int limit = Tile<BN>::SMEM_BYTES;
    e = WORDS ? cudaFuncSetAttribute(match_words_kernel<BN>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, limit)
              : cudaFuncSetAttribute(match_groups_kernel<BN>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured[dev] = true;
  }
  const dim3 grid((p.B + BM - 1) / BM, (p.R + BN - 1) / BN);
  const size_t smem = Tile<BN>::SMEM_BYTES;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (WORDS) {
    match_words_kernel<BN><<<grid, THREADS, smem, st>>>(a, b, p);
  } else {
    match_groups_kernel<BN><<<grid, THREADS, smem, st>>>(a, b, p);
  }
  return static_cast<int>(cudaGetLastError());
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's encoder, from the libcuda.so.1 the CUDA runtime already loaded
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (h == nullptr) h = dlopen("libcuda.so.1", RTLD_NOW);
    if (h != nullptr) fn = reinterpret_cast<EncodeTiled>(dlsym(h, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// error codes of the C interface below cudaError_t's: no encoder in
// libcuda.so.1, or the encoder refused the lit matrix's map
constexpr int ERR_NO_ENCODER = -1;
constexpr int ERR_LIT_MAP = -2;

// TMA map of a row-major uint8 matrix [rows, cols] (cols = literals, the
// contiguous axis, a multiple of 16), box [box_rows, 128 literals], 128-byte
// swizzle, out-of-bounds elements read as zero. Returns 0, the CUresult of
// the encoder, or ERR_NO_ENCODER.
int encode_map(CUtensorMap* m, const void* base, long long rows, long long cols, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return ERR_NO_ENCODER;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(BK), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return static_cast<int>(fn(m, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims,
                             strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

template <bool WORDS>
int dispatch(int bn, const void* lit, const void* tm_w, const Params& p, void* stream) {
  if (p.B <= 0 || p.L <= 0 || p.L % 64 != 0 || p.R <= 0 || p.G <= 0 || p.G > MAX_GROUPS)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap a;
  const int r = encode_map(&a, lit, p.B, p.L, lit_box_rows(p.B));
  if (r != 0) return r == ERR_NO_ENCODER ? r : ERR_LIT_MAP;
  if (bn == 256) return launch<256, WORDS>(a, tm_w, p, stream);
  if (bn == 128) return launch<128, WORDS>(a, tm_w, p, stream);
  if (bn == 64) return launch<64, WORDS>(a, tm_w, p, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

int cedar_max_groups() { return MAX_GROUPS; }
int cedar_tile_rows() { return BM; }

const char* cedar_error_string(int code) {
  if (code == ERR_NO_ENCODER) return "libcuda.so.1 has no cuTensorMapEncodeTiled";
  if (code == ERR_LIT_MAP) return "cuTensorMapEncodeTiled refused the lit matrix's map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The plane's TMA map (Wt [rows = R, cols = L], box of box_rows rules),
// written as the 128-byte CUtensorMap to `out`. Returns 0, the CUresult of
// the encoder, or -1 when libcuda.so.1 has no cuTensorMapEncodeTiled.
int cedar_tensor_map(void* out, const void* base, long long rows, long long cols, int box_rows) {
  CUtensorMap m;
  const int r = encode_map(&m, base, rows, cols, box_rows);
  if (r == 0) memcpy(out, &m, sizeof(m));
  return r;
}

// lit: the [B, L] int8 matrix (its map is encoded here); first / last:
// [B, G] int32, filled with INT32_MAX / -1 by the caller.
int cedar_match_groups(const void* lit, const void* tm_w, const void* thresh, const void* group,
                       const void* policy, void* first, void* last, int B, int L, int R, int G,
                       int bn, void* stream) {
  Params p{static_cast<const int32_t*>(thresh), static_cast<const int32_t*>(group),
           static_cast<const int32_t*>(policy), static_cast<int32_t*>(first),
           static_cast<int32_t*>(last), nullptr, nullptr, B, L, R, G, 0, 0,
           lit_box_rows(B) * BK};
  return dispatch<false>(bn, lit, tm_w, p, stream);
}

// scratch: int32 [ceil(B / 128) + 2 * B * G + B] filled with INT32_MAX by
// the caller: the row tiles' arrival counters, first [B, G], ~last [B, G],
// then the words [B] the kernel writes.
int cedar_match_words(const void* lit, const void* tm_w, const void* thresh, const void* group,
                      const void* policy, void* scratch, int B, int L, int R, int n_tiers,
                      int has_gate, int bn, void* stream) {
  if (n_tiers < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int G = 3 * n_tiers + (has_gate ? 1 : 0);
  int32_t* arrivals = static_cast<int32_t*>(scratch);
  int32_t* first = arrivals + (B + BM - 1) / BM;
  int32_t* last = first + static_cast<size_t>(B) * G;
  int32_t* words = last + static_cast<size_t>(B) * G;
  Params p{static_cast<const int32_t*>(thresh), static_cast<const int32_t*>(group),
           static_cast<const int32_t*>(policy), first, last, words, arrivals, B, L, R, G,
           n_tiers, has_gate ? 1 : 0, lit_box_rows(B) * BK};
  return dispatch<true>(bn, lit, tm_w, p, stream);
}

}  // extern "C"
