// TTA-fused detection-map kernel for Hopper (sm_90a), bound to PyTorch
// through ctypes.
//
// Replaces the TPU kernel
//   mpp_cnn_rs_object_detection_tpu/ops/pallas_kernels.py:detection_map_fused
//   (body _detection_kernel): unit-normalise an (H, W, 2) pointing field,
//   take its np.gradient divergence (central inside, one-sided at the edges,
//   times inv_spacing = (h-1)/h on both axes) and return
//   clip(-div/2, 0, 1) * mask, with mask = sigmoid(mask) when it is a logit.
// A second epilogue serves the PosNet's DivClassifier head
//   (models/unet.py:DivClassifier): raw vectors, spacing 1,
//   sigmoid(w * div * mask + b).
// The kernel also does what the JAX package's dihedral test-time
// augmentation does around that function (PosNetModel.detection_map_on_image
// with inference.tta): it takes the U-Net head output of each of V views
// (V = 8 dihedral views, or 1), computes each view's map in its own frame
// and writes the mean of the maps pulled back to the original frame.
//
// Inputs, per view k: the head output as one fp32 tensor (B, 3, Hp, P) of
// planes [vx, vy, mask] with a row pitch P that is a multiple of 4
// elements; the view's crop (h_k, w_k) within it; and the integer affine map
// a = a0 + ai*i + aj*j, b = b0 + bi*i + bj*j from output pixel (i, j) to
// view pixel (a, b) (ops/dihedral.py:view_index_map). B > 1 only with V = 1.
//
// Bound: bytes. Each view's crop is read once (12 B per pixel per view) and
// the output written once (4 B per pixel): at the flagship launch, 8 views
// of 958 x 926, 88.7 MB, 26.5 us at 3.35 TB/s; the ~30 flops per pixel and
// view are far below the fp32 rate.
//
// Design, and what each part does about the bound:
// - One block per 32 x 32 output tile; a loop over the V views inside the
//   block takes the place of the TPU's sequential grid, so the V maps, their
//   pull-back and their mean never reach device memory: one launch, one
//   write of the output, no per-view crop, sigmoid, rotate or add passes.
// - Square tiles: every dihedral element maps a square output tile onto a
//   square view tile, transposed or not. The view tile with a 1-pixel halo,
//   all three planes, is one TMA box (40 x 34 x 3). The tensor map's extent
//   is the view's crop, so TMA zero-fills everything beyond it and the
//   padded region of the plane is never read; one thread issues the whole
//   load, spending no registers on addresses.
// - On the H100 a TMA box whose first column is not 16-byte aligned, or is
//   negative, raises an illegal instruction. So the box starts at the halo
//   column rounded down to a multiple of 4 floats (hence 40 columns for the
//   34 needed), and its first row and column are clamped at 0: a pixel on
//   the crop's first row or column takes a one-sided difference and needs
//   no halo before it.
// - A 2-stage shared-memory ring with one mbarrier per stage: view k+1
//   loads while view k computes. A stage is refilled only after the block's
//   barrier at the end of the view that used it. Ring and accumulator take
//   37,136 B, so four 512-thread blocks fill an SM's 2,048 threads: the
//   per-pixel work (two sigmoids, the edge cases) needs that many warps to
//   hide its latency (scripts/torch_detection_kernel_sweep.py: a third
//   stage gained nothing, 256 threads lost 7 %).
// - Each view's contribution is computed in the view frame (row-wise,
//   conflict-free shared reads) and added into a 32 x 33 output-frame
//   accumulator in shared memory; the padding column makes the transposed
//   adds conflict-free. The views are added in the caller's order and the
//   sum divided by V, as the plain version does. After the last view each
//   warp stores whole 128-byte output rows.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;                  // output tile side
constexpr int BOX_H = TILE + 2;           // staged view rows, halo included
constexpr int BOX_W = 40;  // TILE + 2, up to 3 more for the alignment, 16 B
constexpr int PLANE = BOX_H * BOX_W;      // floats per staged plane
constexpr int BOX_BYTES = 3 * PLANE * 4;  // one TMA box, zero fill included
constexpr int STAGE_FLOATS = (BOX_BYTES + 127) / 128 * 32;  // 128-B stages
constexpr int STAGES = 2;
constexpr int ACC_PITCH = TILE + 1;
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_VIEWS = 8;
constexpr int SMEM_BYTES =
    128 + STAGES * STAGE_FLOATS * 4 + TILE * ACC_PITCH * 4 + STAGES * 8;
// int64 fields per view as the wrapper packs them (ops/detection_kernel.py)
constexpr int VIEW_FIELDS = 12;

struct Params {
  CUtensorMap maps[MAX_VIEWS];
  int h[MAX_VIEWS], w[MAX_VIEWS];
  int a0[MAX_VIEWS], ai[MAX_VIEWS], aj[MAX_VIEWS];
  int b0[MAX_VIEWS], bi[MAX_VIEWS], bj[MAX_VIEWS];
  float inv_spacing[MAX_VIEWS];
  float* out;
  int n_views, H, W, epilogue, mask_is_logit;
  float clf_w, clf_b;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// First view row ``ra`` and column ``cb`` of the view tile that the output
// tile at (i0, j0) maps onto in view v.
__device__ __forceinline__ void view_origin(const Params& p, int v, int i0,
                                            int j0, int& ra, int& cb) {
  ra = p.a0[v] + p.ai[v] * i0 + p.aj[v] * j0 + min(0, (TILE - 1) * p.ai[v]) +
       min(0, (TILE - 1) * p.aj[v]);
  cb = p.b0[v] + p.bi[v] * i0 + p.bj[v] * j0 + min(0, (TILE - 1) * p.bi[v]) +
       min(0, (TILE - 1) * p.bj[v]);
}

// One thread: expect the box's bytes on the stage's barrier and start the
// TMA load of view v's tile (halo included) into the stage.
// First row and column of the staged box: the halo's, clamped at 0, the
// column rounded down to 16 bytes.
__device__ __forceinline__ int box_row(int ra) { return max(ra - 1, 0); }
__device__ __forceinline__ int box_col(int cb) { return max(cb - 1, 0) & ~3; }

__device__ __forceinline__ void issue_view(const Params& p, int v,
                                           float* stage, uint64_t* bar,
                                           int i0, int j0, int z) {
  int ra, cb;
  view_origin(p, v, i0, j0, ra, cb);
  const uint32_t b = smem_u32(bar);
  mbar_expect_tx(b, BOX_BYTES);
  tma_load_4d(smem_u32(stage), &p.maps[v], b, box_col(cb), box_row(ra), 0,
              z);
}

__global__ void __launch_bounds__(THREADS)
    detection_map_tta_kernel(const __grid_constant__ Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((128u - (smem_u32(smem_raw) & 127u)) & 127u);
  float* ring = reinterpret_cast<float*>(base);
  float* acc = ring + STAGES * STAGE_FLOATS;
  uint64_t* full = reinterpret_cast<uint64_t*>(acc + TILE * ACC_PITCH);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int i0 = blockIdx.y * TILE;
  const int j0 = blockIdx.x * TILE;
  const int z = blockIdx.z;
  const int n_views = p.n_views;

  for (int e = tid; e < TILE * ACC_PITCH; e += THREADS) acc[e] = 0.0f;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(smem_u32(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int v = 0; v < n_views && v < STAGES; ++v)
      issue_view(p, v, ring + v * STAGE_FLOATS, &full[v], i0, j0, z);
  }

  for (int v = 0; v < n_views; ++v) {
    const int s = v % STAGES;
    float* sx = ring + s * STAGE_FLOATS;
    float* sy = sx + PLANE;
    const float* sm = sx + 2 * PLANE;
    int ra, cb;
    view_origin(p, v, i0, j0, ra, cb);
    const int h = p.h[v];
    const int w = p.w[v];
    mbar_wait(smem_u32(&full[s]), (v / STAGES) & 1);

    if (p.epilogue == 0) {  // unit-normalise the staged vectors in place
      for (int e = tid; e < PLANE; e += THREADS) {
        const float a = sx[e];
        const float b = sy[e];
        const float n = sqrtf(a * a + b * b);
        sx[e] = n > 0.0f ? a / n : 0.0f;
        sy[e] = n > 0.0f ? b / n : 0.0f;
      }
      __syncthreads();
    }

    // view rows follow output rows, or output columns when transposed
    const bool transposed = p.ai[v] == 0;
    const bool rev_r = (transposed ? p.aj[v] : p.ai[v]) < 0;
    const bool rev_c = (transposed ? p.bi[v] : p.bj[v]) < 0;
    const float inv_spacing = p.inv_spacing[v];
    // staged position of view pixel (ra, cb)
    const int base_o = (ra - box_row(ra)) * BOX_W + (cb - box_col(cb));
#pragma unroll
    for (int q = 0; q < TILE / WARPS; ++q) {
      const int r = warp + q * WARPS;
      const int c = lane;
      const int a = ra + r;
      const int b = cb + c;
      // outside the view <=> the output pixel lies outside the frame
      if (a < 0 || a >= h || b < 0 || b >= w) continue;
      const int o = base_o + r * BOX_W + c;
      // d(vx)/d(row) and d(vy)/d(col), np.gradient edge semantics
      float gyx;
      if (a == 0) {
        gyx = sx[o + BOX_W] - sx[o];
      } else if (a == h - 1) {
        gyx = sx[o] - sx[o - BOX_W];
      } else {
        gyx = (sx[o + BOX_W] - sx[o - BOX_W]) * 0.5f;
      }
      float gxy;
      if (b == 0) {
        gxy = sy[o + 1] - sy[o];
      } else if (b == w - 1) {
        gxy = sy[o] - sy[o - 1];
      } else {
        gxy = (sy[o + 1] - sy[o - 1]) * 0.5f;
      }
      const float div = (gyx + gxy) * inv_spacing;
      float m = sm[o];
      if (p.mask_is_logit) m = 1.0f / (1.0f + expf(-m));
      float val;
      if (p.epilogue == 0) {
        val = fminf(fmaxf(-div * 0.5f, 0.0f), 1.0f) * m;
      } else {
        val = 1.0f / (1.0f + expf(-(p.clf_w * (div * m) + p.clf_b)));
      }
      const int u = rev_r ? TILE - 1 - r : r;
      const int x = rev_c ? TILE - 1 - c : c;
      if (transposed) {
        acc[x * ACC_PITCH + u] += val;
      } else {
        acc[u * ACC_PITCH + x] += val;
      }
    }
    // the stage's generic-proxy reads and writes come before the next TMA
    // write into it, and this view's adds before the next view's
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (tid == 0 && v + STAGES < n_views)
      issue_view(p, v + STAGES, sx, &full[s], i0, j0, z);
  }

  const float scale = static_cast<float>(n_views);
  float* out = p.out + (long long)z * p.H * p.W;
#pragma unroll
  for (int q = 0; q < TILE / WARPS; ++q) {
    const int li = warp + q * WARPS;
    const int i = i0 + li;
    const int j = j0 + lane;
    if (i < p.H && j < p.W)
      out[(long long)i * p.W + j] = acc[li * ACC_PITCH + lane] / scale;
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, reached through the runtime so the
// library needs no link against libcuda.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &status);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &status);
#endif
    if (err == cudaSuccess && status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

}  // namespace

// Plain C entry point for ctypes. ``views`` holds VIEW_FIELDS int64 per
// view: device address of the planes, plane stride, batch stride and row
// pitch (elements), crop h and w, and the affine map a0, ai, aj, b0, bi,
// bj. Writes ``batch`` (H, W) maps to ``out``. Launches on ``stream`` and
// returns cudaGetLastError() (0 on success), -1 when the driver has no
// tensor-map encoder and -2 when a view's tensor map is refused; it never
// synchronises or allocates.
extern "C" int detection_map_tta_launch(const long long* views, int n_views,
                                        float* out, int batch, int H, int W,
                                        int epilogue, int mask_is_logit,
                                        float clf_w, float clf_b,
                                        void* stream) {
  if (n_views < 1 || n_views > MAX_VIEWS || batch < 1 || batch > 65535 ||
      H < 1 || W < 1 || (batch > 1 && n_views > 1))
    return (int)cudaErrorInvalidValue;
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return -1;
  Params p;
  for (int v = 0; v < n_views; ++v) {
    const long long* d = views + v * VIEW_FIELDS;
    const cuuint64_t dims[4] = {(cuuint64_t)d[5], (cuuint64_t)d[4], 3,
                                (cuuint64_t)batch};
    const cuuint64_t strides[3] = {(cuuint64_t)d[3] * 4, (cuuint64_t)d[1] * 4,
                                   (cuuint64_t)d[2] * 4};
    const cuuint32_t box[4] = {BOX_W, BOX_H, 3, 1};
    const cuuint32_t elem[4] = {1, 1, 1, 1};
    if (encode(&p.maps[v], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
               reinterpret_cast<void*>(d[0]), dims, strides, box, elem,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return -2;
    p.h[v] = (int)d[4];
    p.w[v] = (int)d[5];
    p.a0[v] = (int)d[6];
    p.ai[v] = (int)d[7];
    p.aj[v] = (int)d[8];
    p.b0[v] = (int)d[9];
    p.bi[v] = (int)d[10];
    p.bj[v] = (int)d[11];
    p.inv_spacing[v] = epilogue == 0 ? (float)((d[4] - 1.0) / d[4]) : 1.0f;
  }
  p.out = out;
  p.n_views = n_views;
  p.H = H;
  p.W = W;
  p.epilogue = epilogue;
  p.mask_is_logit = mask_is_logit;
  p.clf_w = clf_w;
  p.clf_b = clf_b;
  // the shipped ring fits the 48 KB default; a deeper one (the sweep in
  // scripts/torch_detection_kernel_sweep.py) must opt in
  if constexpr (SMEM_BYTES > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        detection_map_tta_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, batch);
  detection_map_tta_kernel<<<grid, THREADS, SMEM_BYTES,
                             (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
