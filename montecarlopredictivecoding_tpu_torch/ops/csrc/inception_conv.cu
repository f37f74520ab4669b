// InceptionV3's BasicConv2d (bias-free convolution -> eval BatchNorm -> relu)
// as one implicit-GEMM kernel on Hopper's (sm_90a) tensor cores.
//
// Replaces: no TPU kernel.  The JAX package's eval/inception.py calls
// lax.conv_general_dilated at Precision.HIGHEST and leaves the BatchNorm and
// relu to XLA; the port ran cuDNN's f32 convolutions (TF32 off, on the FMA
// pipe) and three elementwise passes.  The Python side (weight layout,
// BatchNorm vectors, tile choice, the plain version) is ops/inception_conv.py.
//
// GEMM.  M = N*P*Q output pixels, N = C_out, K = kh*kw*C_in, in tiles of
// BM x BN x BK (BK = 32).  A block is one or two warpgroups, each owning 64
// rows of M; two run apart, each waiting only for its own rows' copies and
// freeing a stage of B through an mbarrier (10-15% faster on the 128-row
// layers than one barrier for the block).  Activations are channels-last
// ([N][H][W][C], C a multiple of 4), so the K run of an A row inside one
// tap (r, s) is contiguous and each copy is a 16-byte cp.async; stride,
// zero padding and the kernel's shape are resolved in the A copy's address
// (a copy outside the image, past M or past K zero-fills).  The weights come re-laid out once, at load, as the
// B stages themselves: for each BN-column block and K tile, the TF32 hi
// parts and then the lo parts, each as wgmma's K-major core matrices (8
// rows x 16 bytes) without swizzle; one bulk copy (cp.async.bulk, completion
// on an mbarrier) brings a stage's B.
//
// Products: wgmma m64nBNk8 TF32 with f32 accumulators, A from registers,
// B from shared memory, three a product (split-TF32): a_lo*b_hi +
// a_hi*b_lo + a_hi*b_hi; a_lo*b_lo (about 2^-22 of the product) is
// dropped.  A is split in registers after its ldmatrix: hi = x rounded to
// nearest (ties away) at 10 mantissa bits, lo = the same rounding of
// x - hi.  The tensor cores add into their accumulator with truncation
// toward zero, which a long K turns into a bias of one sign (outputs shrink;
// measured on the card: -1.8e-7 a layer, -5.1e-6 on the features, when a
// K tile's three products went into one accumulator).  So each K tile's
// a_hi*b_hi products (4 a lane's element) sum into a fresh accumulator
// (scale-d 0 on the first) that is then added to the running one with an
// ordinary rounded f32 add, and the low products, 2^-11 of those, go to
// an accumulator of their own for the whole K (-8.7e-8 a layer, -2.4e-6
// on the features).  No Winograd, no FFT: the direct convolution's FLOPs.
//
// Epilogue: out = max(acc * scale[c] + shift[c], 0), the BatchNorm's
// per-channel vectors computed once at load, stored once into the channel
// slice [c0, c0 + C_out) of a channels-last output whose channel stride is
// ctot (the block's concatenation; the wrapper passes out + c0).
//
// Bound.  The work is the direct convolution's 2*M*N*K FLOPs, at the
// f32-accurate peak of 165 TFLOP/s (three TF32 products at 495); the bytes
// are the input read once and the output written once.  Almost every layer
// lies far above the 49 FLOP/B line and is bound by the products;
// Conv2d_1a (K = 27) and Conv2d_3b_1x1 (K = 64) lie below it and are bound
// by bytes (0.8% of the FLOPs): for them the design keeps one read of the
// input, one write of the output and no elementwise passes.  For the
// products it keeps three stages of copies in flight under the tensor
// cores, issues the weights' stage as one bulk copy (per-thread copies of
// B made the loads the limit), reads A with conflict-free ldmatrix from
// padded rows, advances each copy's tap instead of dividing for it (the
// divisions cost 15%), and takes the tile from the shape
// (ops/inception_conv.py: tile_for): C_out in 32, 64, 96 or 128 columns,
// M in 128 rows, or 64 (two blocks an SM) where 128-row blocks would make
// between one and four waves.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 32;               // K depth of a tile
constexpr int A_LD = BK + 4;         // floats a row of the A tile (conflict-free ldmatrix)
constexpr int STAGES = 3;
constexpr int ERR_TILE = 1000;       // no kernel for the asked tile

struct Conv {
  const float* x;       // [n][H][W][C]
  const float* w;       // the B stages: [C_out / BN][k_tiles][hi, lo][BK / 4][BN][4]
  const float* scale;   // [cout]
  const float* shift;   // [cout]
  float* out;           // [M][ctot], this layer's channels from column 0
  int H, W, C, Q, PQ, kw, stride, pad_h, pad_w, K, k_tiles, cout, ctot, M;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero, its low 13 bits zero: ops/inception_conv.py's tf32_round
__device__ __forceinline__ uint32_t tf32_round(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// a wait this many SM clocks long (about 2 s) is a copy that never lands:
// trap, so the launch fails instead of hanging the card
constexpr long long WAIT_TRAP_CLOCKS = 1ll << 32;

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - start > WAIT_TRAP_CLOCKS) __trap();
  }
}

__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accesses of the accumulator across the
// asynchronous products
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// a K-major operand without swizzle: 8-row core matrices of 16 bytes a row,
// the next 4 K values lbo bytes on, the next 8 rows sbo bytes on
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// d (+)= a * b for one warpgroup: a 64 x 8 TF32 from registers (a lane's
// m16n8k8 A fragment of its warp's 16 rows), b 8 x N from shared memory;
// scale_d 0 starts d from zero
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d);

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<96>(float (&d)[48], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <int BN, int WGS>
__global__ void __launch_bounds__(128 * WGS, 1) inception_conv_kernel(const Conv c) {
  constexpr int BM = 64 * WGS;
  constexpr int R = BN / 2;                      // accumulator floats a thread
  constexpr int A_ROWS = 128 / (BK / 4);         // a warpgroup copies its own 64 rows
  constexpr int A_COPIES = 64 / A_ROWS;
  constexpr int A_STAGE = BM * A_LD;
  constexpr int B_HALF = (BK / 4) * BN * 4;      // floats of the hi (or lo) parts a stage
  constexpr int B_STAGE = 2 * B_HALF;
  constexpr uint32_t B_BYTES = B_STAGE * 4;
  // two warpgroups run apart: each waits only for its own rows' copies and
  // frees a stage through an mbarrier; one warpgroup is the whole block
  constexpr bool DECOUPLED = WGS > 1;

  extern __shared__ __align__(128) float smem[];
  float* const Bs = smem;                        // the bulk copies' 128-byte aligned stages first
  float* const As = smem + STAGES * B_STAGE;
  __shared__ __align__(8) uint64_t full[STAGES];   // a stage's B landed
  __shared__ __align__(8) uint64_t empty[STAGES];  // every warpgroup done with a stage

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_addr(&full[s]), 1);
      mbar_init(smem_addr(&empty[s]), WGS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // this thread's A copies: one K offset, A_COPIES rows; a row past M gets
  // an origin no tap reaches, so its copies zero-fill
  const int a_k = (tid % (BK / 4)) * 4;
  const int a_row = (tid / 128) * 64 + (tid % 128) / (BK / 4);
  int a_ih[A_COPIES], a_iw[A_COPIES], a_base[A_COPIES];
#pragma unroll
  for (int i = 0; i < A_COPIES; ++i) {
    const int m = m0 + a_row + i * A_ROWS;
    a_ih[i] = -(1 << 28);
    a_iw[i] = 0;
    a_base[i] = 0;
    if (m < c.M) {
      const int img = m / c.PQ, pq = m - img * c.PQ, p = pq / c.Q, q = pq - p * c.Q;
      a_ih[i] = p * c.stride - c.pad_h;
      a_iw[i] = q * c.stride - c.pad_w;
      a_base[i] = ((img * c.H + a_ih[i]) * c.W + a_iw[i]) * c.C;
    }
  }
  const float* const w_block = c.w + (size_t)blockIdx.x * c.k_tiles * B_STAGE;

  // this thread's K position of the next tile it copies, as the tap (r, s)
  // and the channel ch: tiles are copied in order, so it only advances
  int r = 0, s = 0, ch = a_k;
  auto advance = [&](int by) {
    ch += by;
    while (ch >= c.C) {
      ch -= c.C;
      if (++s == c.kw) {
        s = 0;
        ++r;
      }
    }
  };
  advance(0);

  auto load_tile = [&](int stage, int kt) {
    if (tid == 0) {
      const uint32_t bar = smem_addr(&full[stage]);
      // with two warpgroups, the stage is free once both are done with it
      if (DECOUPLED && kt >= STAGES) mbar_wait(smem_addr(&empty[stage]), (kt / STAGES - 1) & 1);
      mbar_expect_tx(bar, B_BYTES);
      bulk_copy(smem_addr(Bs + stage * B_STAGE), w_block + (size_t)kt * B_STAGE, B_BYTES, bar);
    }
    const bool k_ok = kt * BK + a_k < c.K;
    const int tap = (r * c.W + s) * c.C + ch;    // the same for every row
    float* const a_dst = As + stage * A_STAGE + a_k;
#pragma unroll
    for (int i = 0; i < A_COPIES; ++i) {
      const int ih = a_ih[i] + r, iw = a_iw[i] + s;
      const bool ok = k_ok && (unsigned)ih < (unsigned)c.H && (unsigned)iw < (unsigned)c.W;
      const float* src = ok ? c.x + a_base[i] + tap : c.x;
      cp_async16(smem_addr(a_dst + (a_row + i * A_ROWS) * A_LD), src, ok);
    }
    advance(BK);
  };

  // acc: the running sum; part: this K tile's a_hi*b_hi products, from
  // zero; small: every a_lo*b_hi + a_hi*b_lo product of the call
  float acc[R], part[R], small[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = small[i] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < c.k_tiles) load_tile(s, s);
    cp_async_commit();
  }

  const int wg = warp / 4, wq = warp % 4;
  // ldmatrix: lanes 0-15 give rows 0-15 at column 0, lanes 16-31 the same
  // rows at column 4, so the four matrices are a lane's a0..a3
  const int a_frag = (wg * 64 + wq * 16 + (lane & 15)) * A_LD + (lane >> 4) * 4;

  for (int kt = 0; kt < c.k_tiles; ++kt) {
    const int stage = kt % STAGES;
    cp_async_wait<STAGES - 2>();
    mbar_wait(smem_addr(&full[stage]), (kt / STAGES) & 1);
    fence_proxy_async();
    // the warpgroup's copies of tile kt are in, and it is done with tile
    // kt - 1, whose stage (its own rows of A) the next copies refill
    if (DECOUPLED)
      bar_sync(1 + wg, 128);
    else
      __syncthreads();
    const int next = kt + STAGES - 1;
    if (next < c.k_tiles) load_tile(next % STAGES, next);
    cp_async_commit();

    const float* const A = As + stage * A_STAGE;
    const uint32_t b_hi = smem_addr(Bs + stage * B_STAGE);
    const uint32_t b_lo = b_hi + B_HALF * 4;
    uint32_t a_hi[BK / 8][4], a_lo[BK / 8][4];
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      uint32_t raw[4];
      ldmatrix_x4(raw, smem_addr(A + a_frag + kk * 8));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v = __uint_as_float(raw[e]);
        a_hi[kk][e] = tf32_round(v);
        a_lo[kk][e] = tf32_round(v - __uint_as_float(a_hi[kk][e]));
      }
    }
    fence_regs(part);
    fence_regs(small);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      // k-step kk: K chunks 2kk and 2kk + 1 (16 bytes each) of every row
      const uint32_t off = 2 * kk * BN * 16;
      const uint64_t dh = smem_desc(b_hi + off, BN * 16, 128);
      const uint64_t dl = smem_desc(b_lo + off, BN * 16, 128);
      wgmma_tf32<BN>(small, a_lo[kk], dh, 1);
      wgmma_tf32<BN>(small, a_hi[kk], dl, 1);
      wgmma_tf32<BN>(part, a_hi[kk], dh, kk > 0);
    }
    wgmma_commit();
    wgmma_wait0();
    if (DECOUPLED) {
      bar_sync(1 + wg, 128);
      if (tid % 128 == 0) mbar_arrive(smem_addr(&empty[stage]));
    }
    fence_regs(part);
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] += part[i];
  }
  cp_async_wait<0>();
  fence_regs(small);
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] += small[i];

  // epilogue: a lane holds rows g and g + 8 of its warp's 16, columns
  // 8j + 2t and 8j + 2t + 1; C_out, ctot and the slice's offset are even
  // (the wrapper checks), so each pair is one aligned 8-byte store
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = n0 + j * 8 + 2 * t;
    if (n >= c.cout) continue;
    const float s0 = c.scale[n], s1 = c.scale[n + 1];
    const float h0 = c.shift[n], h1 = c.shift[n + 1];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wg * 64 + wq * 16 + g + 8 * half;
      if (m >= c.M) continue;
      float2 v;
      v.x = fmaxf(fmaf(acc[4 * j + 2 * half], s0, h0), 0.f);
      v.y = fmaxf(fmaf(acc[4 * j + 2 * half + 1], s1, h1), 0.f);
      *reinterpret_cast<float2*>(c.out + (size_t)m * c.ctot + n) = v;
    }
  }
}

template <int BN, int WGS>
int launch(const Conv& c, cudaStream_t stream) {
  constexpr size_t smem = STAGES * (64 * WGS * A_LD + 2 * (BK / 4) * BN * 4) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(inception_conv_kernel<BN, WGS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((c.cout + BN - 1) / BN, (c.M + 64 * WGS - 1) / (64 * WGS));
  inception_conv_kernel<BN, WGS><<<grid, 128 * WGS, smem, stream>>>(c);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One BasicConv2d on n images: x [n][H][W][C] channels-last, w from
// ops/inception_conv.py's pack_weights for this bn (K = kh*kw*C in whole
// tiles of 32), out the first of the layer's channels in a channels-last
// output of ctot channels.  bm in {64, 128}, bn in {32, 64, 96, 128}.
// Returns cudaGetLastError() after the launch, or ERR_TILE for another tile.
int inception_conv_launch(const float* x, const float* w, const float* scale,
                          const float* shift, float* out, int n, int H, int W, int C,
                          int P, int Q, int kh, int kw, int stride, int pad_h, int pad_w,
                          int cout, int ctot, int bm, int bn, void* stream) {
  Conv c;
  c.x = x; c.w = w; c.scale = scale; c.shift = shift; c.out = out;
  c.H = H; c.W = W; c.C = C; c.Q = Q; c.PQ = P * Q; c.kw = kw; c.stride = stride;
  c.pad_h = pad_h; c.pad_w = pad_w; c.K = kh * kw * C; c.k_tiles = (c.K + BK - 1) / BK;
  c.cout = cout; c.ctot = ctot; c.M = n * P * Q;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bm * 1000 + bn) {
    case 128032: return launch<32, 2>(c, s);
    case 128064: return launch<64, 2>(c, s);
    case 128096: return launch<96, 2>(c, s);
    case 128128: return launch<128, 2>(c, s);
    case 64032: return launch<32, 1>(c, s);
    case 64064: return launch<64, 1>(c, s);
    case 64096: return launch<96, 1>(c, s);
    case 64128: return launch<128, 1>(c, s);
    default: return ERR_TILE;
  }
}

int inception_conv_k_tile() { return BK; }

const char* inception_conv_error_string(int err) {
  if (err == ERR_TILE) return "no kernel for that tile";
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
