// Detection-map stencil for Hopper (sm_90a), bound to PyTorch through ctypes.
//
// Replaces the TPU kernel
//   mpp_cnn_rs_object_detection_tpu/ops/pallas_kernels.py:detection_map_fused
//   (body _detection_kernel): unit-normalise an (H, W, 2) pointing field,
//   take its np.gradient divergence (central inside, one-sided at the edges,
//   times inv_spacing = (H-1)/H on both axes) and return
//   clip(-div/2, 0, 1) * mask, with mask = sigmoid(mask) when it is a logit.
// A second epilogue serves the PosNet's DivClassifier head
//   (models/unet.py:DivClassifier, models/posnet_model.py:vec2detection_map):
//   raw vectors, spacing 1, sigmoid(w * div * mask + b).
//
// Bound: the function moves 16 bytes per pixel (two vector components and
// the mask read once, the output written once) and does ~20 flops per pixel,
// so it is bound by bytes: 1024 x 1024 is 16.8 MB, about 5 us at 3.35 TB/s.
//
// Design (simple and correct first): one block per 32 x 8 output tile and
// batch element; the block stages the (8+2) x (32+2) tile of (normalised)
// vector components, halo included, in shared memory straight from global
// memory, then each thread writes one output pixel. Edges use the one-sided
// differences, so any H, W >= 2 works; accumulation is fp32. The vector
// field is read through an element stride, which covers both the
// channels-last (B, H, W, 2) layout (stride 2) and two separate (B, H, W)
// planes (stride 1).

#include <cuda_runtime.h>

namespace {

constexpr int TX = 32;
constexpr int TY = 8;

__global__ void detection_map_kernel(const float* __restrict__ vx,
                                     const float* __restrict__ vy,
                                     long long vstride,
                                     const float* __restrict__ mask,
                                     float* __restrict__ out,
                                     int H, int W, int epilogue,
                                     int mask_is_logit, float inv_spacing,
                                     float clf_w, float clf_b) {
  __shared__ float sx[TY + 2][TX + 2];
  __shared__ float sy[TY + 2][TX + 2];

  const long long plane = (long long)H * W;
  const long long base = (long long)blockIdx.z * plane;
  const int y0 = blockIdx.y * TY;
  const int x0 = blockIdx.x * TX;
  const int tid = threadIdx.y * TX + threadIdx.x;

  for (int i = tid; i < (TY + 2) * (TX + 2); i += TX * TY) {
    const int ly = i / (TX + 2);
    const int lx = i % (TX + 2);
    const int gy = y0 + ly - 1;
    const int gx = x0 + lx - 1;
    float a = 0.0f, b = 0.0f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const long long p = (base + (long long)gy * W + gx) * vstride;
      a = vx[p];
      b = vy[p];
      if (epilogue == 0) {
        const float n = sqrtf(a * a + b * b);
        if (n > 0.0f) {
          a = a / n;
          b = b / n;
        } else {
          a = 0.0f;
          b = 0.0f;
        }
      }
    }
    sx[ly][lx] = a;
    sy[ly][lx] = b;
  }
  __syncthreads();

  const int y = y0 + threadIdx.y;
  const int x = x0 + threadIdx.x;
  if (y >= H || x >= W) return;
  const int ly = threadIdx.y + 1;
  const int lx = threadIdx.x + 1;

  // d(vx)/d(row) and d(vy)/d(col), np.gradient edge semantics
  float gyx;
  if (y == 0) {
    gyx = sx[ly + 1][lx] - sx[ly][lx];
  } else if (y == H - 1) {
    gyx = sx[ly][lx] - sx[ly - 1][lx];
  } else {
    gyx = (sx[ly + 1][lx] - sx[ly - 1][lx]) * 0.5f;
  }
  float gxy;
  if (x == 0) {
    gxy = sy[ly][lx + 1] - sy[ly][lx];
  } else if (x == W - 1) {
    gxy = sy[ly][lx] - sy[ly][lx - 1];
  } else {
    gxy = (sy[ly][lx + 1] - sy[ly][lx - 1]) * 0.5f;
  }
  const float div = (gyx + gxy) * inv_spacing;

  const long long o = base + (long long)y * W + x;
  float m = mask[o];
  if (mask_is_logit) m = 1.0f / (1.0f + expf(-m));
  float r;
  if (epilogue == 0) {
    r = fminf(fmaxf(-div * 0.5f, 0.0f), 1.0f) * m;
  } else {
    r = 1.0f / (1.0f + expf(-(clf_w * (div * m) + clf_b)));
  }
  out[o] = r;
}

}  // namespace

// Plain C entry point for ctypes. Launches on ``stream`` and returns
// cudaGetLastError() (0 on success); it never synchronises or allocates.
extern "C" int detection_map_launch(const float* vx, const float* vy,
                                    long long vstride, const float* mask,
                                    float* out, int B, int H, int W,
                                    int epilogue, int mask_is_logit,
                                    float inv_spacing, float clf_w,
                                    float clf_b, void* stream) {
  if (B <= 0 || H < 2 || W < 2 || B > 65535) return (int)cudaErrorInvalidValue;
  dim3 block(TX, TY);
  dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, B);
  detection_map_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      vx, vy, vstride, mask, out, H, W, epilogue, mask_is_logit, inv_spacing,
      clf_w, clf_b);
  return (int)cudaGetLastError();
}
