// One-token GQA decode attention over a dense or paged KV cache, for Hopper
// (sm_90a), as split-context flash-decoding. Plain C entry point, loaded
// with ctypes.
//
// Replaces the TPU kernels decode_attention_pallas (dense cache) and
// decode_attention_pallas_paged (page-table pool) of
// src/repro/kernels/decode_attention.py.
//
// Semantics follow the plain PyTorch version (decode_attention_plain in
// src/repro_torch/kernels/decode_attention.py, itself the port of the XLA
// path decode_attention_xla): an entry t of the T attended entries is masked
// when pos_cache[t] < 0, when it lies after the query position, or outside
// the sliding window; masked scores take the finite value -1e30 (never
// -inf), so a row whose T entries are all masked returns the mean of its T
// value rows, exactly as the XLA path does. Entries past T are not attended.
// Softmax runs online in f32; output = acc / max(l, 1e-30). The
// probabilities reach the PV sum in f32 (as in the Pallas body) in every
// instance but the lean bf16 ones (below), which round the unnormalised
// P to bf16 for the tensor cores, as the bf16 flash kernel does; the plain
// version and the XLA path round the normalised P to the cache's dtype.
// decode_attention_split_plain(p_dtype=bfloat16) mirrors the lean rounding.
//
// What bounds it: decode reads each K and V row of the attended context
// once, 2 * B * T * K * hd * sizeof(dtype) bytes, and does about 4 flops per
// element read, far below the ~295 flop/byte ridge of an H100, so the bytes
// bound it, and at the serving contexts (T of a few hundred) the latency of
// getting them. The design keeps many 16-byte copies in flight on every SM
// and few instructions between them:
//
// * Split pass, grid (splits, K, B), 4 warps. A block covers the rows
//   [s*R, min((s+1)*R, T)) of one (slot, KV head) for all G <= 16 query
//   heads of the group, so each K/V row crosses device memory once. The
//   wrapper picks R (a power of two >= 32) so that the grid fills the SMs.
// * Shapes: head dims 32, 64, 96, 128, 192 and 256 (every attention config
//   of the model zoo), taken natively, never padded. A kernel is
//   instantiated for groups of at most 8 (kMaxG = 8) and of at most 16
//   (kMaxG = 16); a group of G <= 8 always runs the kMaxG = 8 instance.
// * Loads. The rows stream through a 3-stage cp.async ring in shared
//   memory: 16-byte copies, two stages in flight while the third is used.
//   The copies are asynchronous and cost no registers. Data stay in their own
//   type in shared memory (bf16 is never staged as f32) and become f32 in
//   registers. The vector copies are taken only when every row start is
//   16-byte aligned (the wrapper checks); otherwise the same slots are
//   filled element by element. Positions come through the same ring.
// * bf16 (the serving path). Each warp owns 8 rows of a stage and stages
//   them itself, so the ring needs warp barriers, not block barriers.
//   q.K^T runs on the tensor cores: mma.sync m16n8k16 with the G heads as
//   the rows of the A operand (zero past G), q held as fragments in
//   registers, K rows read as B fragments from a padded (conflict-free)
//   tile. The products of bf16 values are exact in f32 and accumulate in
//   f32, as in the plain version. A quad of lanes holds one head's scores
//   (heads n and n + 8 with kMaxG = 16: the m16 rows of the A operand), so
//   the online softmax (f32) needs two shuffles for the max. Two designs
//   of the PV sum, by the registers its sums take:
//   - kMaxG * HD/32 <= 32 (hd <= 128 at kMaxG 8: the serving shapes; hd 32
//     and 64 at kMaxG 16): the probabilities stay f32 and reach the PV sum
//     through shared memory; each lane owns HD/32 dims of every head and
//     sums with f32 FMAs.
//   - the "lean" instances, kMaxG * HD/32 > 32 (hd 96 and 128 at kMaxG 16,
//     the latter qwen3-moe's; hd 192: nemotron-4; hd 256: recurrentgemma):
//     q reaches shared memory by 16-byte cp.async ahead of the ring's
//     first stages (one round trip, where element loads took one a word)
//     and is read per tile, and PV runs on the tensor cores as m16n8k8
//     with the unnormalised P, rounded to bf16, as the A operand straight
//     from the score fragments (rows: heads n and n + 8; depth: the warp's
//     8 value rows) and V's B fragments by ldmatrix.trans from the padded
//     stage. The sums are the C fragments, HD/2 registers a lane (128 at
//     hd 256); a lane rescales its own heads' rows by its own correction
//     factor, so no probability or factor passes through shared memory.
//     What bounds these shapes on an H100 is each block's serial chain
//     (q and the first stages' round trip, the score product, the
//     softmax's shuffles and exponentials, HD/8 PV products a warp, the
//     merge), not the bytes: at recurrentgemma's ring (T=2048, 16 heads on
//     one KV head) the kernel reaches 14% of the byte bound; with f32 PV
//     FMAs (16 heads x 8 dims a value row, per lane) it reached 12%
//     (PERF.md). kMaxG 8 at hd 192/256 leaves rows 8-15 of the A operand
//     zero.
//   A design with CUDA-core dot products for bf16 as well (the f32 scheme
//   below) issues about 100 warp instructions per context row and holds
//   168 registers; on an H100 it reached about a quarter of the byte bound
//   at T=4096, B=4 (PERF.md).
// * f32 (tests and reduced f32 engines; no TF32, which would not hold
//   2e-5). At hd 32, 64, 128 and G <= 8: a row's hd floats are read by
//   hd/4 lanes, 16 bytes each, one
//   online-softmax stream per lane group. The lanes' partial dot products
//   are reduce-scattered over the row (each halving level keeps half the
//   heads and sends the other half), so each lane ends with the full
//   score of one head and runs its softmax; probabilities return to
//   every lane by shuffles for the PV sum. Each thread stages exactly the
//   chunks it reads, so this ring needs no barrier at all. Any other f32
//   shape (hd 96, 192, 256, or G > 8) runs decode_f32_any_kernel, a plain
//   block-wide loop over tiles of 16 rows in shared memory (scores, softmax
//   and the PV sum each a pass of the block); it serves tests and reduced
//   engines, not the bf16 serving path.
// * Scores are scaled into the base-2 domain (hd^-0.5 * log2 e), so every
//   exponential is one exp2.
// * Dense and paged rows are a template parameter. Rows are found by the
//   strides the wrapper passes (dense: base + b*sb + t*st + h*sh; paged:
//   pages[b, t / page] * sb + (t % page) * st + h*sh), which takes a
//   context-bucket view k[:, :T], a layer slice of the stacked cache, or the
//   (P, page, K, hd) pool without a copy. A paged block copies the
//   page-table entries of its split into shared memory once.
// * Merge. Streams (f32) merge by warp shuffles, warps through shared
//   memory. With one split the block writes the output; otherwise it writes
//   its partial (m, l, acc[G][hd]) in f32 to a workspace the wrapper
//   allocates, and a combine kernel, one block per (slot, query head),
//   merges the splits: M = max m_s, out = sum 2^(m_s-M) acc_s /
//   max(sum 2^(m_s-M) l_s, 1e-30). It is a programmatic dependent launch:
//   set up while the split grid runs, it waits for it in griddepcontrol.wait.
// * Extents (decode_attention_extent_launch; the engine's fused decode
//   step). lens[b] is the number of leading rows slot b attends: rows t >=
//   min(lens[b], T) are excluded exactly as rows past T are (weight 0, not
//   in the max, never read), and a slot with lens[b] <= 0 reads nothing and
//   returns zeros. The grid is then fixed when the launch is issued (a CUDA
//   graph captures it while the extents change from replay to replay): N
//   blocks, at least as many as the SMs hold at once and as B * K splits
//   of the largest length would make. Block i takes item i of a work list
//   of (slot, KV head, split) items, and blocks past the last item exit at
//   once. Slot b's extent e_b is cut into ceil(e_b / R) splits of R rows,
//   and the list is slot-major, so item w belongs to the slot whose prefix
//   sum of K * ceil(e_b / R) passes w. R is chosen on the device from the
//   extents: the least multiple of 32 rows from rmin (64) up to the split
//   cap whose items fit the N blocks, so the live rows fill the SMs
//   whether 3 or 32 slots are live, and no block loops (a loop over items
//   held a third more registers in every instance). Each warp of a block,
//   and of the
//   combine, computes the plan itself from lens (B loads, a few shuffles;
//   every block gets the same integers), so no plan crosses the device.
//   Every item goes through the workspace (row: item * G + head), and the
//   combine merges the first ceil(e_b / R) splits of its slot: none for a
//   dead slot, whose output is 0.
//
// Masked and all-masked rows stay exact. A masked score is -1e30 and m
// starts at -1e30, so a masked entry weighs 2^0 = 1 as long as nothing is
// attended and 2^(-1e30 - m) = 0 once something is; an entry outside the
// split's rows (or past T) is excluded outright (weight 0, not in the max)
// and its slot holds zeros. Every split holds at least one row below T, so
// on a slot whose entries are all masked every split has m = -1e30 and
// weight 1 in the merge, and the output is the mean of the T value rows, as
// in the XLA path (without extents; with them, the mean of the slot's
// extent, and zeros for an extent of 0). A stream or warp that received no
// row has l = 0 and acc = 0 and adds nothing.
//
// The C code allocates nothing and never synchronises, so a launch can be
// captured in a CUDA graph.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 16; // query heads per KV head the kernels take
constexpr int kStages = 3;   // pipeline stages in flight (cp.async ring)
constexpr int kRows = 4;     // f32 kernel: rows of a stream in one stage
constexpr int kWarpRows = 8; // bf16 kernel: rows of a warp in one stage
constexpr int kMaxSplitPages = 256;
constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const void* q;        // (B, 1, H, hd) contiguous
  const void* k;        // dense (B, >=T, K, hd) or paged (P, page, K, hd)
  const void* v;
  const int* pos_q;     // (B,)
  const int* pos_c;     // (B, >=T), row stride pc_sb
  const int* pages;     // (B, >=ceil(T/page)), row stride pg_sb (paged only)
  void* out;            // (B, 1, H, hd) contiguous
  float* ws_acc;        // (B, H, splits, hd) partial sums (splits > 1);
                        // with extents (items, G, hd)
  float* ws_ml;         // (B, H, splits, 2): m (base 2), l; extents (items, G, 2)
  const int* lens;      // (B,) rows each slot attends, or nullptr (all T)
  int H, K, hd, T, page, page_shift, window, rows, splits, vec;
  int B, rmin, target;  // extents: slots, least split, the split grid's blocks
  int64_t k_sb, k_st, k_sh, v_sb, v_st, v_sh;  // element strides
  int64_t pc_sb, pg_sb;
  float scale2;         // hd^-0.5 * log2(e)
};

// One block's work: the rows [t_begin, t_end) of slot b, KV head kh;
// `unit` is its split (without extents) or its item of the plan (with them).
struct Work {
  int b, kh, unit, t_begin, t_end;
};

// The plan's item of this block (slot, KV head, item), kept in shared
// memory from the plan to the merge, so that no register holds it through
// the main loop (without extents blockIdx plays that part).
__device__ __forceinline__ int* work_slot() {
  __shared__ int id[3];
  return id;
}

// This block's (slot, KV head, unit), read where the result is written.
template <bool EXT>
__device__ __forceinline__ void work_id(int& b, int& kh, int& unit) {
  if constexpr (!EXT) {
    unit = blockIdx.x;
    kh = blockIdx.y;
    b = blockIdx.z;
  } else {
    const int* id = work_slot();
    b = id[0];
    kh = id[1];
    unit = id[2];
  }
}

// The first workspace row of a piece of work's heads (rows row0 + g * step)
// and, without extents and with one split, that it writes the output.
struct Dest {
  int64_t head0, row0;
  int step;
  bool direct;
};

template <bool EXT>
__device__ __forceinline__ Dest dest(const Args& a, int G) {
  int b, kh, unit;
  work_id<EXT>(b, kh, unit);
  Dest d;
  d.head0 = (int64_t)b * a.H + (int64_t)kh * G;
  if constexpr (EXT) {
    d.row0 = (int64_t)unit * G;
    d.step = 1;
    d.direct = false;
  } else {
    d.row0 = d.head0 * a.splits + unit;
    d.step = a.splits;
    d.direct = a.splits == 1;
  }
  return d;
}

// ---------------------------------------------------------------------------
// the extent plan (see the note at the top); warp-wide, every lane of a full
// warp gets the result
// ---------------------------------------------------------------------------

__device__ __forceinline__ int extent(const Args& a, int b) {
  return min(max(a.lens[b], 0), a.T);
}

__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// the items of splits of r rows
__device__ __forceinline__ int plan_items(const Args& a, int r, int lane) {
  int n = 0;
  for (int b = lane; b < a.B; b += 32) n += (extent(a, b) + r - 1) / r;
  return warp_sum(n) * a.K;
}

// the split length R: rmin if its items fit the split grid (`target`
// blocks), else the least multiple of 32 rows (a bf16 tile) up to rows
// whose items fit, so that the items fill the grid (powers of two left it a
// third empty at full occupancy, 18% slower). It is every block's latency
// before its first load, so one pass over lens gives rmin's items and two
// bounds: nothing below K E / target fits (E the live rows), and 32 ceil(K
// E / (target - K n) / 32) does (n live slots, each at most one split more
// than its rows over R); between them a bisection of at most a few steps.
__device__ __forceinline__ int plan_rows(const Args& a, int lane) {
  if (a.rmin >= a.rows) return a.rows;
  int items = 0, rows = 0, live = 0;
  for (int b = lane; b < a.B; b += 32) {
    const int e = extent(a, b);
    items += (e + a.rmin - 1) / a.rmin;
    rows += e;
    live += e > 0;
  }
  items = warp_sum(items) * a.K;
  rows = warp_sum(rows);
  live = warp_sum(live);
  if (items <= a.target) return a.rmin;
  const int64_t need = (int64_t)a.K * rows, room = a.target - (int64_t)a.K * live;
  int lo = max(a.rmin / 32 + 1, (int)((need + 32LL * a.target - 1) / (32LL * a.target)));
  int hi = a.rows / 32;  // fits, as does the bound below
  if (room > 0) hi = min(hi, (int)((need + 32 * room - 1) / (32 * room)));
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (plan_items(a, mid * 32, lane) <= a.target) hi = mid;
    else lo = mid + 1;
  }
  return hi * 32;
}

// the first item of slot b
__device__ __forceinline__ int plan_first(const Args& a, int r, int b, int lane) {
  int n = 0;
  for (int i = lane; i < b; i += 32) n += (extent(a, i) + r - 1) / r;
  return warp_sum(n) * a.K;
}

// item w of the plan (slot-major; a slot's KV heads in turn, each one's
// splits consecutive); false when w is past the last item
__device__ __forceinline__ bool plan_item(const Args& a, int r, int w, int lane, Work& wk) {
  int base = 0;
  for (int b0 = 0; b0 < a.B; b0 += 32) {
    const int b = b0 + lane;
    const int e = b < a.B ? extent(a, b) : 0;
    const int n = (e + r - 1) / r;
    int incl = n * a.K;  // inclusive prefix sum of the lanes' items
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += t;
    }
    const int first = base + incl - n * a.K;
    const unsigned hit = __ballot_sync(0xffffffffu, first <= w && w < base + incl);
    if (hit) {
      const int src = __ffs(hit) - 1;
      const int off = w - __shfl_sync(0xffffffffu, first, src);
      const int ns = __shfl_sync(0xffffffffu, n, src);
      wk.b = b0 + src;
      wk.kh = off / ns;
      const int split = off - wk.kh * ns;
      wk.unit = w;
      wk.t_begin = split * r;
      wk.t_end = min(wk.t_begin + r, __shfl_sync(0xffffffffu, e, src));
      return true;
    }
    base += __shfl_sync(0xffffffffu, incl, 31);
  }
  return false;
}

// This block's work: without extents the piece the grid (splits, K, B)
// gives it; with them item blockIdx.x of the plan, whose split length makes
// every item fit the grid (false past the last item: nothing to do).
template <bool EXT>
__device__ __forceinline__ bool block_work(const Args& a, Work& wk) {
  if constexpr (!EXT) {
    wk.unit = blockIdx.x;
    wk.kh = blockIdx.y;
    wk.b = blockIdx.z;
    wk.t_begin = wk.unit * a.rows;
    wk.t_end = min(wk.t_begin + a.rows, a.T);
    return true;
  } else {
    const int lane = threadIdx.x & 31;
    if (!plan_item(a, plan_rows(a, lane), blockIdx.x, lane, wk)) return false;
    // read back by the merge, after the item's barriers
    if (threadIdx.x == 0) {
      int* id = work_slot();
      id[0] = wk.b;
      id[1] = wk.kh;
      id[2] = wk.unit;
    }
    return true;
  }
}

__device__ __forceinline__ uint32_t word(const uint4& r, int i) {
  return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
}

// element i of 4 floats in a 16-byte vector
__device__ __forceinline__ float elem(const uint4& r, int i) {
  return __uint_as_float(word(r, i));
}

// 16 bytes from p: one vector load when aligned, else element by element
__device__ __forceinline__ uint4 load16(const float* p, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const uint4*>(p));
  return make_uint4(__float_as_uint(p[0]), __float_as_uint(p[1]),
                    __float_as_uint(p[2]), __float_as_uint(p[3]));
}
__device__ __forceinline__ uint4 load16(const __nv_bfloat16* p, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned short* u = reinterpret_cast<const unsigned short*>(p);
  return make_uint4(u[0] | ((uint32_t)u[1] << 16), u[2] | ((uint32_t)u[3] << 16),
                    u[4] | ((uint32_t)u[5] << 16), u[6] | ((uint32_t)u[7] << 16));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// global -> shared, asynchronous (16 or 4 bytes); the "memory" clobbers keep
// the compiler from moving shared-memory reads across the wait
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)),
               "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c (16x8 f32) += a (16x8 bf16, row) * b (8x8 bf16, col)
__device__ __forceinline__ void mma_bf16_k8(float* c, const uint32_t* a, uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

// four 8x8 bf16 matrices from shared memory, transposed: lanes 8j..8j+7 give
// the row addresses of matrix j, and r[j] is its m16n8k8 B fragment
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// N bf16 from shared memory as f32: 8-byte words when N % 4 == 0, 4-byte
// words when N is even, else single elements (p aligned to that size)
template <int N>
__device__ __forceinline__ void load_bf16(const unsigned short* p, float* out) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const uint2 w = reinterpret_cast<const uint2*>(p)[i];
      out[4 * i] = __uint_as_float(w.x << 16);
      out[4 * i + 1] = __uint_as_float(w.x & 0xffff0000u);
      out[4 * i + 2] = __uint_as_float(w.y << 16);
      out[4 * i + 3] = __uint_as_float(w.y & 0xffff0000u);
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const uint32_t w = reinterpret_cast<const uint32_t*>(p)[i];
      out[2 * i] = __uint_as_float(w << 16);
      out[2 * i + 1] = __uint_as_float(w & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = __uint_as_float((uint32_t)p[i] << 16);
  }
}

// The split's rows and, paged, its page-table entries staged in shared memory.
struct Split {
  int t_begin, n_rows, p0;
};

template <bool PAGED>
__device__ __forceinline__ Split begin_split(const Args& a, const Work& wk, int* pg_s) {
  Split sp;
  sp.t_begin = wk.t_begin;
  const int t_end = wk.t_end;
  sp.n_rows = t_end - sp.t_begin;
  sp.p0 = 0;
  if (PAGED) {
    sp.p0 = sp.t_begin / a.page;
    const int np = (t_end - 1) / a.page - sp.p0 + 1;
    const int* pt = a.pages + (int64_t)wk.b * a.pg_sb + sp.p0;
    for (int i = threadIdx.x; i < np; i += kThreads) pg_s[i] = pt[i];
    __syncthreads();
  }
  return sp;
}

// element offsets of K and V row t of KV head kh (dense or through the pages)
template <bool PAGED>
__device__ __forceinline__ void row_offsets(const Args& a, const Split& sp, const int* pg_s,
                                            int b, int kh, int t, int64_t& kb, int64_t& vb) {
  if (PAGED) {
    const int lp = a.page_shift >= 0 ? t >> a.page_shift : t / a.page;
    const int64_t pg = pg_s[lp - sp.p0];
    const int64_t off = t - lp * a.page;
    kb = pg * a.k_sb + off * a.k_st + (int64_t)kh * a.k_sh;
    vb = pg * a.v_sb + off * a.v_st + (int64_t)kh * a.v_sh;
  } else {
    kb = (int64_t)b * a.k_sb + (int64_t)t * a.k_st + (int64_t)kh * a.k_sh;
    vb = (int64_t)b * a.v_sb + (int64_t)t * a.v_st + (int64_t)kh * a.v_sh;
  }
}

// 0: excluded (past the split or T), 1: masked (score -1e30), 2: attended
__device__ __forceinline__ int row_state(const Args& a, bool in, int p, int pq) {
  if (!in) return 0;
  const int d = pq - p;
  return (p >= 0 && d >= 0 && (a.window <= 0 || d < a.window)) ? 2 : 1;
}

// The warps' partials (acc[w][g][d], m[w][g], l[w][g], in shared memory)
// merge into the split's result: the output with one split, else the
// workspace row (m, l, acc) of this split.
template <typename T, int HD, int MAXG, bool EXT>
__device__ __forceinline__ void finish_split(const Args& a, const float* acc_s,
                                             const float* m_s, const float* l_s,
                                             int G) {
  const Dest to = dest<EXT>(a, G);
  for (int e = threadIdx.x; e < G * HD; e += kThreads) {
    const int g = e / HD, d = e - g * HD;
    float mm = m_s[g];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mm = fmaxf(mm, m_s[w * MAXG + g]);
    float lsum = 0.f, asum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = exp2f(m_s[w * MAXG + g] - mm);
      lsum += wt * l_s[w * MAXG + g];
      asum += wt * acc_s[(w * MAXG + g) * HD + d];
    }
    if (to.direct) {
      store(static_cast<T*>(a.out) + (to.head0 + g) * HD + d, asum / fmaxf(lsum, 1e-30f));
    } else {
      const int64_t row = to.row0 + (int64_t)g * to.step;
      a.ws_acc[row * HD + d] = asum;
      if (d == 0) {
        a.ws_ml[row * 2] = mm;
        a.ws_ml[row * 2 + 1] = lsum;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: q.K^T on the tensor cores, softmax in f32; PV in f32 FMAs, or on
// the tensor cores in the lean instances
// ---------------------------------------------------------------------------

// The lean instances (see the note at the top) keep q in shared memory and
// run PV on the tensor cores.
template <int HD, int MAXG>
struct LeanBf16 {
  static constexpr bool value = MAXG * (HD / 32) > 32;
};

// Shared memory of the bf16 kernel. Warp w stages and reads only its own
// rows of each stage, so the ring needs warp barriers, not block barriers.
// A lean instance keeps q (MAXG rows, zero past G) after this struct.
template <int HD, int MAXG>
struct SmemBf16 {
  static constexpr int LD = HD + 8;  // padded row: conflict-free B fragments
  union {
    unsigned short ring[kStages][kWarps][2][kWarpRows][LD];  // bf16 [..][k|v][row][dim]
    struct {  // after the last stage: the warps' partials
      float acc[kWarps][MAXG][HD];
      float m[kWarps][MAXG], l[kWarps][MAXG];
    } merge;
  };
  int pos[kStages][kWarps][kWarpRows];
  float p[kWarps][MAXG][kWarpRows];  // probabilities of the warp's rows
  float corr[kWarps][MAXG];
  int pages[kMaxSplitPages];
};

template <int HD, int MAXG>
constexpr size_t smem_bf16() {
  return sizeof(SmemBf16<HD, MAXG>) +
         (LeanBf16<HD, MAXG>::value ? sizeof(unsigned short) * MAXG * (HD + 8) : 0);
}

// The blocks an SM holds by the shared memory of the bf16 kernel (228 KB, 1
// KB reserved a block), at most 5 (4 with extents, whose plan takes
// registers: at 5, hd 96 spilled): ptxas's register budget
// (__launch_bounds__), so that it neither spills for an occupancy the
// shared memory never allows nor takes registers that would lower the one
// it allows.
template <int HD, int MAXG, bool EXT>
constexpr int blocks_bf16() {
  const int n = (int)((228 * 1024) / (smem_bf16<HD, MAXG>() + 1024));
  const int most = EXT ? 4 : 5;
  return n < 1 ? 1 : n > most ? most : n;
}

// Grid (splits, K, B), 4 warps. A stage is 8 rows a warp; lane (n, q) with
// n = lane / 4, q = lane % 4 holds the scores of head n (and, with MAXG =
// 16, head n + 8) for rows 2q, 2q + 1 (the m16n8 accumulator; rows of the
// A operand past G are zero). For the f32 PV sum lane l owns dims
// [l * HD/32, (l+1) * HD/32) of every head; the lean PV sum is in m16n8k8's
// C layout.
template <int HD, int MAXG, bool PAGED, bool EXT>
__device__ __forceinline__ void bf16_item(const Args& a, const Work& wk) {
  using S = SmemBf16<HD, MAXG>;
  constexpr int LD = S::LD;
  constexpr int KS = HD / 16;          // k-steps of the QK product
  constexpr int DPL = HD / 32;         // dims a lane owns in the PV sum
  constexpr int CPR = HD / 8;          // 16-byte chunks a row
  constexpr int TILE = kWarps * kWarpRows;
  constexpr int HPL = MAXG / 8;        // heads whose scores a lane holds
  constexpr bool kLean = LeanBf16<HD, MAXG>::value;
  static_assert(MAXG == 8 || MAXG == 16, "groups of at most 8 or 16");
  static_assert(HD % 32 == 0 && HD <= 256, "head dim a multiple of 32, <= 256");
  static_assert(sizeof(S) % 16 == 0, "a lean q row starts 16-byte aligned");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S& sm = *reinterpret_cast<S*>(smem_raw);
  unsigned short* q_s = reinterpret_cast<unsigned short*>(smem_raw + sizeof(S));

  const int kh = wk.kh, b = wk.b;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = lane >> 2, kq = (lane & 3) * 2;
  const int G = a.H / a.K;
  const bool vec = a.vec != 0;
  if constexpr (kLean) {
    // q (MAXG rows, zero past G) to shared memory by 16-byte copies, a
    // group of its own ahead of the ring's first stages
    const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(a.q) +
                              ((int64_t)b * a.H + (int64_t)kh * G) * HD;
    for (int e = threadIdx.x; e < MAXG * (HD / 8); e += kThreads) {
      const int r = e / (HD / 8), d = (e % (HD / 8)) * 8;
      unsigned short* dst = q_s + r * LD + d;
      if (r >= G)
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      else if (vec)
        cp_async16(dst, qg + r * HD + d);
      else
        *reinterpret_cast<uint4*>(dst) = load16(qg + r * HD + d, false);
    }
    cp_async_commit();
  }
  const Split sp = begin_split<PAGED>(a, wk, sm.pages);
  const int n_tiles = (sp.n_rows + TILE - 1) / TILE;
  const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(a.k);
  const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(a.v);
  const int* pc = a.pos_c + (int64_t)b * a.pc_sb;

  // stage this warp's rows of tile j: chunk e = lane + 32 i of the warp's
  // 8 rows (row e / CPR, chunk e % CPR), K and V; lanes 0-7 copy the
  // positions
  auto fetch = [&](int j) {
    const int stage = j % kStages;
#pragma unroll
    for (int i = 0; i < CPR / 4; ++i) {
      const int e = lane + i * 32;
      const int rr = e / CPR, c = e % CPR;
      const int r = j * TILE + warp * kWarpRows + rr;
      unsigned short* ks = &sm.ring[stage][warp][0][rr][c * 8];
      unsigned short* vs = &sm.ring[stage][warp][1][rr][c * 8];
      if (r < sp.n_rows) {
        int64_t kb, vb;
        row_offsets<PAGED>(a, sp, sm.pages, b, kh, sp.t_begin + r, kb, vb);
        if (vec) {
          cp_async16(ks, kp + kb + c * 8);
          cp_async16(vs, vp + vb + c * 8);
        } else {
          *reinterpret_cast<uint4*>(ks) = load16(kp + kb + c * 8, false);
          *reinterpret_cast<uint4*>(vs) = load16(vp + vb + c * 8, false);
        }
      } else {  // past the split: zeros, so no stale bits reach the sums
        *reinterpret_cast<uint4*>(ks) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(vs) = make_uint4(0, 0, 0, 0);
      }
    }
    const int r = j * TILE + warp * kWarpRows + lane;
    if (lane < kWarpRows && r < sp.n_rows) cp_async4(&sm.pos[stage][warp][lane], pc + sp.t_begin + r);
  };
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < n_tiles) fetch(j);
    cp_async_commit();
  }
  asm volatile("griddepcontrol.launch_dependents;\n");  // the combine may launch

  // A operand: row r = head r of the group (zero past G), bf16 as in q;
  // (qh[d], qh[d + 1]) of head r as one 32-bit word
  const int pq = a.pos_q[b];
  const unsigned short* qh = reinterpret_cast<const unsigned short*>(a.q) +
                             ((int64_t)b * a.H + (int64_t)kh * G) * HD;
  auto q_pair = [&](int r, int d) -> uint32_t {
    return r < G ? (qh[r * HD + d] | ((uint32_t)qh[r * HD + d + 1] << 16)) : 0u;
  };
  uint32_t qa[kLean ? 1 : KS][4];
  if constexpr (kLean) {
    cp_async_wait<kStages - 1>();  // q's group landed; the stages may not
    __syncthreads();               // ... for every thread
  } else {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int d = ks * 16 + kq;
      qa[ks][0] = q_pair(n, d);
      qa[ks][2] = q_pair(n, d + 8);
      qa[ks][1] = HPL > 1 ? q_pair(n + 8, d) : 0u;
      qa[ks][3] = HPL > 1 ? q_pair(n + 8, d + 8) : 0u;
    }
  }
  float m[HPL], l[HPL];  // heads n (+ 8): running max and (partial) sum
#pragma unroll
  for (int j = 0; j < HPL; ++j) {
    m[j] = kMasked;
    l[j] = 0.f;
  }
  // PV sums: lean, the m16n8k8 C fragments of HD/8 n-tiles (heads n and
  // n + 8, dims nt * 8 + kq, + 1); otherwise the lane's DPL dims of every head
  constexpr int AR = kLean ? HD / 8 : MAXG, AC = kLean ? 4 : DPL;
  float acc[AR][AC];
#pragma unroll
  for (int g = 0; g < AR; ++g)
#pragma unroll
    for (int i = 0; i < AC; ++i) acc[g][i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    if (it + kStages - 1 < n_tiles) fetch(it + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncwarp();  // the warp's copies of tile `it` are visible to all its lanes
    const int stage = it % kStages;
    const unsigned short* ks = &sm.ring[stage][warp][0][0][0];
    const unsigned short* vs = &sm.ring[stage][warp][1][0][0];
    float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      const unsigned short* kr = ks + n * LD + s * 16 + kq;
      if constexpr (kLean) {
        const unsigned short* qr = q_s + n * LD + s * 16 + kq;
        uint32_t af[4];
        af[0] = *reinterpret_cast<const uint32_t*>(qr);
        af[2] = *reinterpret_cast<const uint32_t*>(qr + 8);
        af[1] = HPL > 1 ? *reinterpret_cast<const uint32_t*>(qr + 8 * LD) : 0u;
        af[3] = HPL > 1 ? *reinterpret_cast<const uint32_t*>(qr + 8 * LD + 8) : 0u;
        mma_bf16(c, af, *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      } else {
        mma_bf16(c, qa[s], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }
    // online softmax of head n (+ 8) over rows kq, kq + 1 (a quad shares a
    // head)
    const int r0 = it * TILE + warp * kWarpRows + kq;
    const int st0 = row_state(a, r0 < sp.n_rows, sm.pos[stage][warp][kq], pq);
    const int st1 = row_state(a, r0 + 1 < sp.n_rows, sm.pos[stage][warp][kq + 1], pq);
    uint32_t pfrag[2] = {0u, 0u};  // lean: P of heads n, n + 8 (bf16), m16n8k8's A
#pragma unroll
    for (int j = 0; j < HPL; ++j) {
      const float s0 = st0 == 1 ? kMasked : c[2 * j] * a.scale2;
      const float s1 = st1 == 1 ? kMasked : c[2 * j + 1] * a.scale2;
      float mx = m[j];
      if (st0) mx = fmaxf(mx, s0);
      if (st1) mx = fmaxf(mx, s1);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float corr = exp2f(m[j] - mx);
      const float p0 = st0 ? exp2f(s0 - mx) : 0.f;
      const float p1 = st1 ? exp2f(s1 - mx) : 0.f;
      l[j] = l[j] * corr + p0 + p1;
      m[j] = mx;
      if constexpr (kLean) {
        // this lane's acc rows are heads n (j = 0) and n + 8 (j = 1): it
        // rescales them by its own correction
        pfrag[j] = pack_f32(p0, p1);
#pragma unroll
        for (int nt = 0; nt < HD / 8; ++nt) {
          acc[nt][2 * j] *= corr;
          acc[nt][2 * j + 1] *= corr;
        }
      } else {
        *reinterpret_cast<float2*>(&sm.p[warp][n + 8 * j][kq]) = make_float2(p0, p1);
        if (kq == 0) sm.corr[warp][n + 8 * j] = corr;
      }
    }
    if constexpr (kLean) {
      // PV on the tensor cores: the unnormalised P, rounded to bf16, is the
      // m16n8k8 A fragment straight from the score fragment (rows: heads n,
      // n + 8; depth: the warp's 8 value rows, 2 a lane); V's B fragments by
      // ldmatrix.trans, 4 n-tiles of 8 dims a load
      const uint32_t v_lane = smem_addr(vs + (lane & 7) * LD + (lane >> 3) * 8);
#pragma unroll
      for (int dq = 0; dq < HD / 32; ++dq) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, v_lane + dq * 64);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16_k8(acc[4 * dq + j], pfrag, vb[j]);
      }
    } else {
      __syncwarp();
      // PV in f32: lane's dims of the warp's 8 value rows
      float vf[kWarpRows][DPL];
#pragma unroll
      for (int rr = 0; rr < kWarpRows; ++rr) load_bf16<DPL>(vs + rr * LD + lane * DPL, vf[rr]);
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g < G) {
          const float cg = sm.corr[warp][g];
          const float4 pa = *reinterpret_cast<const float4*>(&sm.p[warp][g][0]);
          const float4 pb = *reinterpret_cast<const float4*>(&sm.p[warp][g][4]);
          const float pr[kWarpRows] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
#pragma unroll
          for (int i = 0; i < DPL; ++i) {
            float x = acc[g][i] * cg;
#pragma unroll
            for (int rr = 0; rr < kWarpRows; ++rr) x = fmaf(pr[rr], vf[rr][i], x);
            acc[g][i] = x;
          }
        }
      }
    }
    __syncwarp();  // p, corr and this stage are free for the next tile
  }
  cp_async_wait<0>();
#pragma unroll
  for (int j = 0; j < HPL; ++j) {
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 1);
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 2);
  }
  __syncthreads();  // the merge buffers overlay every warp's ring
  if constexpr (kLean) {
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) {
      if (n < G)
        *reinterpret_cast<float2*>(&sm.merge.acc[warp][n][nt * 8 + kq]) =
            make_float2(acc[nt][0], acc[nt][1]);
      if constexpr (HPL > 1)
        if (n + 8 < G)
          *reinterpret_cast<float2*>(&sm.merge.acc[warp][n + 8][nt * 8 + kq]) =
              make_float2(acc[nt][2], acc[nt][3]);
    }
  } else {
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
      if (g < G)
#pragma unroll
        for (int i = 0; i < DPL; ++i) sm.merge.acc[warp][g][lane * DPL + i] = acc[g][i];
  }
  if (kq == 0) {
#pragma unroll
    for (int j = 0; j < HPL; ++j) {
      sm.merge.m[warp][n + 8 * j] = m[j];
      sm.merge.l[warp][n + 8 * j] = l[j];
    }
  }
  __syncthreads();
  finish_split<__nv_bfloat16, HD, MAXG, EXT>(a, &sm.merge.acc[0][0][0], &sm.merge.m[0][0],
                                        &sm.merge.l[0][0], G);
}

template <int HD, int MAXG, bool PAGED, bool EXT>
__global__ void __launch_bounds__(kThreads, (blocks_bf16<HD, MAXG, EXT>())) decode_bf16_kernel(Args a) {
  Work wk;
  if (block_work<EXT>(a, wk)) bf16_item<HD, MAXG, PAGED, EXT>(a, wk);
}

// ---------------------------------------------------------------------------
// f32: CUDA-core FMAs (no TF32), lanes split a row's dims
// ---------------------------------------------------------------------------

constexpr int kF32G = 8;  // query heads per KV head of decode_f32_kernel

// Shared memory of the f32 kernel. The ring is private to each thread: a
// thread stages exactly the 16-byte chunks it reads itself, so the main loop
// needs no barrier, only cp.async.wait_group.
template <int HD>
struct SmemF32 {
  uint4 kv[kStages][kRows][2][kThreads];  // [stage][row][k|v][thread]
  int pos[kStages][kRows][kThreads];
  float acc[kWarps][kF32G][HD];            // warp partials for the merge
  float m[kWarps][kF32G], l[kWarps][kF32G];
  int pages[kMaxSplitPages];
};

// Grid (splits, K, B), 4 warps. A row's HD floats are read by LPR = HD/4
// lanes, 16 bytes each; a warp holds 32/LPR rows at once, one online-softmax
// stream per lane group. A score is the lanes' partial dot products of the
// 8 (padded) heads, reduce-scattered over the row's lanes: three halving
// levels (offsets LPR/2, LPR/4, LPR/8) each keep half the heads and send the
// other half, so each lane ends with the full score of one head and runs
// its softmax; the probabilities are broadcast back by shuffles for the PV
// sum.
template <int HD, bool PAGED, bool EXT>
__device__ __forceinline__ void f32_item(const Args& a, const Work& wk) {
  constexpr int VEC = 4;
  constexpr int LPR = HD / VEC;          // lanes per row: 8, 16 or 32
  constexpr int RPW = 32 / LPR;          // rows (streams) per warp
  constexpr int NS = kWarps * RPW;       // streams per block
  constexpr int TILE = NS * kRows;       // rows per pipeline stage
  static_assert(LPR >= kF32G, "three halving levels need 8 lanes a row");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SmemF32<HD>& sm = *reinterpret_cast<SmemF32<HD>*>(smem_raw);

  const int kh = wk.kh, b = wk.b;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int sid = warp * RPW + lane / LPR;   // this lane's stream
  const int lir = lane % LPR;                // lane in its row
  const int row_lane0 = lane - lir;
  const int dim0 = lir * VEC;                // first of this lane's dims
  const int G = a.H / a.K;
  const bool vec = a.vec != 0;
  const Split sp = begin_split<PAGED>(a, wk, sm.pages);
  const int n_tiles = (sp.n_rows + TILE - 1) / TILE;
  const float* kp = static_cast<const float*>(a.k);
  const float* vp = static_cast<const float*>(a.v);
  const int* pc = a.pos_c + (int64_t)b * a.pc_sb;

  auto fetch = [&](int j) {
    const int stage = j % kStages;
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int r = j * TILE + u * NS + sid;
      uint4* ks = &sm.kv[stage][u][0][tid];
      uint4* vs = &sm.kv[stage][u][1][tid];
      if (r < sp.n_rows) {
        int64_t kb, vb;
        row_offsets<PAGED>(a, sp, sm.pages, b, kh, sp.t_begin + r, kb, vb);
        if (vec) {
          cp_async16(ks, kp + kb + dim0);
          cp_async16(vs, vp + vb + dim0);
        } else {
          *ks = load16(kp + kb + dim0, false);
          *vs = load16(vp + vb + dim0, false);
        }
        cp_async4(&sm.pos[stage][u][tid], pc + sp.t_begin + r);
      } else {  // past the split: zeros, so no stale bits reach the sums
        *ks = make_uint4(0, 0, 0, 0);
        *vs = make_uint4(0, 0, 0, 0);
      }
    }
  };
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < n_tiles) fetch(j);
    cp_async_commit();
  }
  asm volatile("griddepcontrol.launch_dependents;\n");  // the combine may launch

  const int pq = a.pos_q[b];
  const float* qp = static_cast<const float*>(a.q) + ((int64_t)b * a.H + (int64_t)kh * G) * HD;
  float q[kF32G][VEC];
#pragma unroll
  for (int g = 0; g < kF32G; ++g) {
    const uint4 r = g < G ? load16(qp + g * HD + dim0, vec) : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int i = 0; i < VEC; ++i) q[g][i] = elem(r, i);
  }
  // the lane of this row that holds head g after the reduce-scatter
  auto src = [&](int g) {
    return row_lane0 + (g >> 2 & 1) * (LPR / 2) + (g >> 1 & 1) * (LPR / 4) + (g & 1) * (LPR / 8);
  };

  float m = kMasked, l = 0.f;  // this lane's head
  float acc[kF32G][VEC];
#pragma unroll
  for (int g = 0; g < kF32G; ++g)
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[g][i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    if (it + kStages - 1 < n_tiles) fetch(it + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // this thread's copies of tile `it` landed
    const int stage = it % kStages;
    float s[kRows];
    int st[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int r = it * TILE + u * NS + sid;
      st[u] = row_state(a, r < sp.n_rows, sm.pos[stage][u][tid], pq);
      const uint4 kr = sm.kv[stage][u][0][tid];
      float v[kF32G];
#pragma unroll
      for (int g = 0; g < kF32G; ++g) {
        float dot = 0.f;
        if (g < G) {
#pragma unroll
          for (int i = 0; i < VEC; ++i) dot = fmaf(q[g][i], elem(kr, i), dot);
        }
        v[g] = dot;
      }
#pragma unroll
      for (int lv = 0; lv < 3; ++lv) {
        const int o = LPR >> (lv + 1);
        const int half = kF32G >> (lv + 1);
        const bool hi = (lir & o) != 0;
#pragma unroll
        for (int j = 0; j < half; ++j) {
          const float send = hi ? v[j] : v[j + half];
          const float keep = hi ? v[j + half] : v[j];
          v[j] = keep + __shfl_xor_sync(0xffffffffu, send, o);
        }
      }
#pragma unroll
      for (int o = LPR / 16; o > 0; o >>= 1) v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
      s[u] = st[u] == 1 ? kMasked : v[0] * a.scale2;
    }
    // online softmax of this lane's head, f32; s becomes p
    float mx = m;
#pragma unroll
    for (int u = 0; u < kRows; ++u) if (st[u]) mx = fmaxf(mx, s[u]);
    const float corr = exp2f(m - mx);
    float sum = 0.f;
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      s[u] = st[u] ? exp2f(s[u] - mx) : 0.f;
      sum += s[u];
    }
    m = mx;
    l = l * corr + sum;
#pragma unroll
    for (int g = 0; g < kF32G; ++g) {
      const float cg = __shfl_sync(0xffffffffu, corr, src(g));
      if (g < G) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[g][i] *= cg;
      }
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const uint4 vr = sm.kv[stage][u][1][tid];
#pragma unroll
      for (int g = 0; g < kF32G; ++g) {
        const float pg = __shfl_sync(0xffffffffu, s[u], src(g));
        if (g < G) {
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[g][i] = fmaf(pg, elem(vr, i), acc[g][i]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // every lane of a row takes (m, l) of all heads, then the streams of a
  // warp merge (lane groups LPR apart hold the same dims)
  float mg[kF32G], lg[kF32G];
#pragma unroll
  for (int g = 0; g < kF32G; ++g) {
    mg[g] = __shfl_sync(0xffffffffu, m, src(g));
    lg[g] = __shfl_sync(0xffffffffu, l, src(g));
  }
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < kF32G; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, mg[g], o);
      const float lo = __shfl_xor_sync(0xffffffffu, lg[g], o);
      const float mm = fmaxf(mg[g], mo);
      const float wa = exp2f(mg[g] - mm), wb = exp2f(mo - mm);
      lg[g] = lg[g] * wa + lo * wb;
      mg[g] = mm;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][i], o);
        acc[g][i] = acc[g][i] * wa + ao * wb;
      }
    }
  }
  if (lane < LPR) {
#pragma unroll
    for (int g = 0; g < kF32G; ++g) {
      if (g < G) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) sm.acc[warp][g][dim0 + i] = acc[g][i];
        if (lane == 0) {
          sm.m[warp][g] = mg[g];
          sm.l[warp][g] = lg[g];
        }
      }
    }
  }
  __syncthreads();
  finish_split<float, HD, kF32G, EXT>(a, &sm.acc[0][0][0], &sm.m[0][0], &sm.l[0][0], G);
}

template <int HD, bool PAGED, bool EXT>
__global__ void __launch_bounds__(kThreads) decode_f32_kernel(Args a) {
  Work wk;
  if (block_work<EXT>(a, wk)) f32_item<HD, PAGED, EXT>(a, wk);
}

// ---------------------------------------------------------------------------
// f32, any other shape (hd 96 / 192 / 256, or a group of 9-16): plain and
// block-wide
// ---------------------------------------------------------------------------

constexpr int kAnyRows = 16;  // context rows of a tile

template <int HD>
struct SmemAny {
  float k[kAnyRows][HD + 1];  // padded: a thread per row reads down a column
  float v[kAnyRows][HD];
  float q[kMaxGroup][HD + 1];
  float p[kMaxGroup][kAnyRows];  // scores, then probabilities
  float acc[kMaxGroup][HD];
  float m[kMaxGroup], l[kMaxGroup], corr[kMaxGroup];
  int st[kAnyRows];
  int pages[kMaxSplitPages];
};

// Grid (splits, K, B), 128 threads. Per tile of 16 rows: stage K, V and the
// row states; one thread per (head, row) score; one thread per head for the
// online softmax (base 2); one thread per (head, dim) for the PV sum, the
// sums kept in shared memory. Barriers between the passes.
template <int HD, bool PAGED, bool EXT>
__device__ __forceinline__ void f32_any_item(const Args& a, const Work& wk) {
  constexpr int CH = HD / 4;  // 16-byte chunks a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SmemAny<HD>& sm = *reinterpret_cast<SmemAny<HD>*>(smem_raw);

  const int kh = wk.kh, b = wk.b;
  const int tid = threadIdx.x;
  const int G = a.H / a.K;
  const bool vec = a.vec != 0;
  const Split sp = begin_split<PAGED>(a, wk, sm.pages);
  const float* kp = static_cast<const float*>(a.k);
  const float* vp = static_cast<const float*>(a.v);
  const float* qp = static_cast<const float*>(a.q) + ((int64_t)b * a.H + (int64_t)kh * G) * HD;
  const int* pc = a.pos_c + (int64_t)b * a.pc_sb;
  const int pq = a.pos_q[b];
  asm volatile("griddepcontrol.launch_dependents;\n");  // the combine may launch

  for (int e = tid; e < G * HD; e += kThreads) {
    const int g = e / HD, d = e % HD;
    sm.q[g][d] = qp[g * HD + d];
    sm.acc[g][d] = 0.f;
  }
  if (tid < G) {
    sm.m[tid] = kMasked;
    sm.l[tid] = 0.f;
  }
  for (int t0 = 0; t0 < sp.n_rows; t0 += kAnyRows) {
    __syncthreads();  // the previous tile's K, V and p are consumed
    for (int e = tid; e < kAnyRows * CH; e += kThreads) {
      const int r = e / CH, c = (e % CH) * 4;
      uint4 kr = make_uint4(0, 0, 0, 0), vr = make_uint4(0, 0, 0, 0);
      if (t0 + r < sp.n_rows) {  // past the split: zeros
        int64_t kb, vb;
        row_offsets<PAGED>(a, sp, sm.pages, b, kh, sp.t_begin + t0 + r, kb, vb);
        kr = load16(kp + kb + c, vec);
        vr = load16(vp + vb + c, vec);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        sm.k[r][c + i] = elem(kr, i);
        sm.v[r][c + i] = elem(vr, i);
      }
    }
    if (tid < kAnyRows) {
      const bool in = t0 + tid < sp.n_rows;
      sm.st[tid] = row_state(a, in, in ? pc[sp.t_begin + t0 + tid] : 0, pq);
    }
    __syncthreads();
    for (int e = tid; e < G * kAnyRows; e += kThreads) {
      const int g = e / kAnyRows, r = e % kAnyRows;
      float dot = 0.f;
      for (int d = 0; d < HD; ++d) dot = fmaf(sm.q[g][d], sm.k[r][d], dot);
      sm.p[g][r] = sm.st[r] == 1 ? kMasked : dot * a.scale2;
    }
    __syncthreads();
    if (tid < G) {
      float mx = sm.m[tid];
      for (int r = 0; r < kAnyRows; ++r)
        if (sm.st[r]) mx = fmaxf(mx, sm.p[tid][r]);
      const float corr = exp2f(sm.m[tid] - mx);
      float sum = 0.f;
      for (int r = 0; r < kAnyRows; ++r) {
        const float pr = sm.st[r] ? exp2f(sm.p[tid][r] - mx) : 0.f;
        sm.p[tid][r] = pr;
        sum += pr;
      }
      sm.m[tid] = mx;
      sm.l[tid] = sm.l[tid] * corr + sum;
      sm.corr[tid] = corr;
    }
    __syncthreads();
    for (int e = tid; e < G * HD; e += kThreads) {
      const int g = e / HD, d = e % HD;
      float x = sm.acc[g][d] * sm.corr[g];
      for (int r = 0; r < kAnyRows; ++r) x = fmaf(sm.p[g][r], sm.v[r][d], x);
      sm.acc[g][d] = x;
    }
  }
  __syncthreads();
  const Dest to = dest<EXT>(a, G);
  for (int e = tid; e < G * HD; e += kThreads) {
    const int g = e / HD, d = e % HD;
    if (to.direct) {
      static_cast<float*>(a.out)[(to.head0 + g) * HD + d] = sm.acc[g][d] / fmaxf(sm.l[g], 1e-30f);
    } else {
      const int64_t row = to.row0 + (int64_t)g * to.step;
      a.ws_acc[row * HD + d] = sm.acc[g][d];
      if (d == 0) {
        a.ws_ml[row * 2] = sm.m[g];
        a.ws_ml[row * 2 + 1] = sm.l[g];
      }
    }
  }
}

template <int HD, bool PAGED, bool EXT>
__global__ void __launch_bounds__(kThreads) decode_f32_any_kernel(Args a) {
  Work wk;
  if (block_work<EXT>(a, wk)) f32_any_item<HD, PAGED, EXT>(a, wk);
}

// one block per (query head, slot), one thread per dim: merge the splits
// online, 8 splits' loads in flight at a time
template <typename T, bool EXT>
__global__ void combine_kernel(Args a) {
  constexpr int C = 8;
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int64_t row = (int64_t)b * a.H + h;
  // the splits of (slot b, head h): workspace rows r0, r0 + rs, ...
  int64_t r0 = row * a.splits, rs = 1;
  int n = a.splits;
  if constexpr (EXT) {  // the extent plan, made before the wait
    const int lane = d & 31, G = a.H / a.K, kh = h / G;
    const int r = plan_rows(a, lane);
    n = (extent(a, b) + r - 1) / r;
    r0 = (int64_t)(plan_first(a, r, b, lane) + kh * n) * G + (h - kh * G);
    rs = G;
  }
  const float* ml = a.ws_ml + r0 * 2;
  const float* acc = a.ws_acc + r0 * a.hd + d;
  // launched as a programmatic dependent of the split kernel: wait until
  // its grid has finished and its writes are visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  float mm = kMasked, lsum = 0.f, asum = 0.f;
  for (int s0 = 0; s0 < n; s0 += C) {
    float ms[C], ls[C], as[C];
#pragma unroll
    for (int i = 0; i < C; ++i) {  // a split past the last adds l = acc = 0
      const bool in = s0 + i < n;
      const int64_t at = (int64_t)(s0 + i) * rs;
      ms[i] = in ? ml[2 * at] : kMasked;
      ls[i] = in ? ml[2 * at + 1] : 0.f;
      as[i] = in ? acc[at * a.hd] : 0.f;
    }
    float cm = mm;
#pragma unroll
    for (int i = 0; i < C; ++i) cm = fmaxf(cm, ms[i]);
    const float corr = exp2f(mm - cm);
    lsum *= corr;
    asum *= corr;
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const float wt = exp2f(ms[i] - cm);
      lsum += wt * ls[i];
      asum += wt * as[i];
    }
    mm = cm;
  }
  store(static_cast<T*>(a.out) + row * a.hd + d, asum / fmaxf(lsum, 1e-30f));
}

// Above 48 KB of shared memory a kernel must opt in: once per kernel and
// device (no stream work, so a capture is not disturbed). On failure the
// launch fails and reports it.
template <void (*Kernel)(Args), size_t kSmem>
void opt_in() {
  static unsigned done = 0;  // a bit per device
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 32 || !(done >> dev & 1u)) {
    if (cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSmem) == cudaSuccess && dev < 32)
      done |= 1u << dev;
  }
}

// what to do with the split kernel a call runs: launch it, or ask how many
// of its blocks an SM holds at once
struct LaunchOp {
  const Args& a;
  dim3 grid;
  cudaStream_t s;
  template <void (*Kernel)(Args), size_t kSmem>
  int run() const {
    opt_in<Kernel, kSmem>();
    Kernel<<<grid, kThreads, kSmem, s>>>(a);
    return 0;
  }
};

struct ResidentOp {
  template <void (*Kernel)(Args), size_t kSmem>
  int run() const {
    opt_in<Kernel, kSmem>();
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, Kernel, kThreads, kSmem) !=
        cudaSuccess)
      return -1;
    return n;
  }
};

template <int HD, bool PAGED, bool EXT, typename Op>
int with_split(int dtype, int G, const Op& op) {
  if (dtype == 1) {
    if (G <= 8)
      return op.template run<decode_bf16_kernel<HD, 8, PAGED, EXT>, smem_bf16<HD, 8>()>();
    return op.template run<decode_bf16_kernel<HD, 16, PAGED, EXT>, smem_bf16<HD, 16>()>();
  }
  if constexpr (HD == 32 || HD == 64 || HD == 128) {
    if (G <= kF32G)
      return op.template run<decode_f32_kernel<HD, PAGED, EXT>, sizeof(SmemF32<HD>)>();
  }
  return op.template run<decode_f32_any_kernel<HD, PAGED, EXT>, sizeof(SmemAny<HD>)>();
}

// extents are taken on the paged pool only
template <int HD, typename Op>
int with_split(int dtype, int G, bool paged, bool ext, const Op& op, int bad) {
  if (!paged) return ext ? bad : with_split<HD, false, false>(dtype, G, op);
  return ext ? with_split<HD, true, true>(dtype, G, op)
             : with_split<HD, true, false>(dtype, G, op);
}

// op on the split kernel of (dtype, hd, group, paged, extents); `bad` for
// a shape the kernels do not take
template <typename Op>
int with_split(int dtype, int hd, int G, bool paged, bool ext, const Op& op, int bad) {
  switch (hd) {
    case 32: return with_split<32>(dtype, G, paged, ext, op, bad);
    case 64: return with_split<64>(dtype, G, paged, ext, op, bad);
    case 96: return with_split<96>(dtype, G, paged, ext, op, bad);
    case 128: return with_split<128>(dtype, G, paged, ext, op, bad);
    case 192: return with_split<192>(dtype, G, paged, ext, op, bad);
    case 256: return with_split<256>(dtype, G, paged, ext, op, bad);
    default: return bad;
  }
}

int launch(int dtype, const Args& a, int B, cudaStream_t s, bool paged) {
  const bool extents = a.lens != nullptr;
  const dim3 grid = extents ? dim3(a.target) : dim3(a.splits, a.K, B);
  const int err = with_split(dtype, a.hd, a.H / a.K, paged, extents, LaunchOp{a, grid, s},
                             (int)cudaErrorInvalidValue);
  if (err) return err;
  if (extents || a.splits > 1) {
    // programmatic dependent launch: the combine grid is set up while the
    // split grid runs, and waits for it in griddepcontrol.wait
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(a.H, B);
    cfg.blockDim = dim3(a.hd);
    cfg.stream = s;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr.val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    cudaError_t e;
    if (extents)
      e = dtype == 1 ? cudaLaunchKernelEx(&cfg, combine_kernel<__nv_bfloat16, true>, a)
                     : cudaLaunchKernelEx(&cfg, combine_kernel<float, true>, a);
    else
      e = dtype == 1 ? cudaLaunchKernelEx(&cfg, combine_kernel<__nv_bfloat16, false>, a)
                     : cudaLaunchKernelEx(&cfg, combine_kernel<float, false>, a);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. pages == nullptr selects the dense cache.
// rows: context rows per split (with lens: the most a split may take);
// splits = ceil(T / rows). ws: with splits > 1, B * H * splits * (hd + 2)
// floats of workspace (unused with one split). vec: 1 if q, k, v rows all
// start 16-byte aligned. lens: nullptr, or (B,) int32 extents on the device
// (the note at the top): then the split grid is `blocks` blocks, one item
// each (at least B * K * ceil(T / rows)), splits take rmin..rows rows, and
// ws holds blocks * (H / K) * (hd + 2) floats. Launches the split kernel
// and, with splits > 1 or lens, the combine kernel on `stream`, and
// returns cudaGetLastError() after them (0 = success).
extern "C" int decode_attention_extent_launch(
    int dtype, const void* q, const void* k, const void* v, const int* pos_q,
    const int* pos_c, const int* pages, void* out, float* ws, int B, int H,
    int K, int hd, int T, int page, int window, int rows, int vec,
    int64_t k_sb, int64_t k_st, int64_t k_sh, int64_t v_sb, int64_t v_st,
    int64_t v_sh, int64_t pc_sb, int64_t pg_sb, float scale, void* stream,
    const int* lens, int rmin, int blocks) {
  if (B <= 0 || T <= 0 || rows <= 0 || K <= 0 || H % K || H / K > kMaxGroup)
    return (int)cudaErrorInvalidValue;
  if (lens && (rmin <= 0 || rmin > rows || ws == nullptr ||
               blocks < (int64_t)B * K * ((T + rows - 1) / rows)))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q; a.k = k; a.v = v; a.pos_q = pos_q; a.pos_c = pos_c;
  a.pages = pages; a.out = out; a.lens = lens;
  a.H = H; a.K = K; a.hd = hd; a.T = T; a.page = page; a.window = window;
  a.rows = rows; a.splits = lens ? 0 : (T + rows - 1) / rows; a.vec = vec;
  a.B = B; a.rmin = rmin; a.target = blocks;
  a.page_shift = -1;
  if (pages) {
    if (page <= 0 || (rows + page - 1) / page + 1 > kMaxSplitPages)
      return (int)cudaErrorInvalidValue;
    if ((page & (page - 1)) == 0) {
      a.page_shift = 0;
      while ((1 << a.page_shift) < page) ++a.page_shift;
    }
  }
  if (a.splits > 1 && ws == nullptr) return (int)cudaErrorInvalidValue;
  const int64_t ws_rows = lens ? (int64_t)blocks * (H / K) : (int64_t)B * H * a.splits;
  a.ws_acc = ws;
  a.ws_ml = ws ? ws + ws_rows * hd : nullptr;
  a.k_sb = k_sb; a.k_st = k_st; a.k_sh = k_sh;
  a.v_sb = v_sb; a.v_st = v_st; a.v_sh = v_sh;
  a.pc_sb = pc_sb; a.pg_sb = pg_sb; a.scale2 = scale * kLog2e;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const int err = launch(dtype, a, B, static_cast<cudaStream_t>(stream), pages != nullptr);
  if (err) return err;
  return (int)cudaGetLastError();
}

// The same launch without extents: every slot attends its T rows.
extern "C" int decode_attention_launch(
    int dtype, const void* q, const void* k, const void* v, const int* pos_q,
    const int* pos_c, const int* pages, void* out, float* ws, int B, int H,
    int K, int hd, int T, int page, int window, int rows, int vec,
    int64_t k_sb, int64_t k_st, int64_t k_sh, int64_t v_sb, int64_t v_st,
    int64_t v_sh, int64_t pc_sb, int64_t pg_sb, float scale, void* stream) {
  return decode_attention_extent_launch(dtype, q, k, v, pos_q, pos_c, pages, out, ws, B, H,
                                        K, hd, T, page, window, rows, vec, k_sb, k_st, k_sh,
                                        v_sb, v_st, v_sh, pc_sb, pg_sb, scale, stream,
                                        nullptr, 0, 0);
}

// Blocks of the paged split kernel with extents of (dtype, hd, group) one
// SM holds at once, or a negative number for a shape the kernels do not take.
extern "C" int decode_attention_blocks_per_sm(int dtype, int hd, int group) {
  if (group < 1 || group > kMaxGroup || (dtype != 0 && dtype != 1)) return -1;
  return with_split(dtype, hd, group, true, true, ResidentOp{}, -1);
}
