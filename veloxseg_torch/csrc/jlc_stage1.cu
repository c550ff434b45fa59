// K4f and K4b: JLC stage 1 forward and backward, fp32, channels-first
// (B, C, D, H, W).
//
//   out1 = x + sum_k GELU(InstanceNorm(gconv_k(x)))     k in kernel_sizes
//
// Replaces: veloxseg_tpu/ops/fused_jlc.py:_k1_kernel (111-133), called
// through _k1_fwd (260-274). The TPU kernel holds one whole packed sample
// in VMEM, so it finishes the InstanceNorm statistics in one program. On
// this card a block cannot see a whole (b, c) plane, and blocks run in no
// order, so the stage is three launches:
//   1. jlc_branch_conv: a direct grouped 3-D convolution of all branches at
//      once. One thread owns one output voxel and 4 output channels of one
//      group; it walks the largest branch's taps once and feeds each input
//      value to every branch whose cube contains the tap, so the branches
//      share their input loads. The block's weights (its 4 output
//      channels, every branch) sit in shared memory as [ci][tap][4] and are
//      read as one float4 broadcast per tap. Branch outputs go to an fp32
//      scratch (nb, B, C, S) in HBM. The branch conv bias is not read: a
//      per-channel constant only shifts the mean, so it cancels inside the
//      InstanceNorm (fused_jlc.py:29-32).
//   2. plane_stats_kernel (common.cuh): a deterministic per-(branch, b, c)
//      reduction of the scratch into mean and rstd (no float atomics).
//   3. jlc_stage1_apply: out1 = x + sum_k GELU((y_k - mean) * rstd), exact
//      erff GELU, eps 1e-5 with max(var, 0).
//
// What bounds it on this card: at the AutoPET shapes (L0: 24^3 x 16 with
// 4 channels per group, B = 4) the convolution is ~1 GFLOP of fp32 FMA and
// the function's own bytes (x in, out1 out) are ~7 MB, so a fused kernel
// would be bound by FMA issue (~16 us at 67 TFLOP/s). This design adds the
// scratch round trip that the TPU kernel avoided: nb·B·C·S floats written
// by (1), read by (2) and again by (3), three times the bytes of x. A later
// version can keep a whole (b, c) plane of each branch in shared memory
// (24^3 fp32 is 55 KB) and drop the scratch.
//
// K4b replaces veloxseg_tpu/ops/fused_jlc.py:_k1_bwd_kernel (135-170),
// called through _k1_bwd (277-294). Given g, the cotangent of out1, it
// recomputes the branch convs (jlc_branch_conv, into the same scratch)
// and their statistics (plane_stats_kernel, the same fixed-order sums, so
// the forward's values), then one block per (branch, b, c) plane:
//   dn = g · GELU'(ŷ),   dy = rstd · (dn − mean(dn) − ŷ · mean(dn · ŷ)),
// the two means reduced in double in a fixed order (block_sum2), dy
// written over the branch output in place. dy is the cotangent at each
// branch's conv output; the conv's own input and weight gradients run on
// cuDNN in the wrapper, as the TPU version runs them on XLA. Bound: the
// recomputed convolution (as K4f), then ~2 reads of the scratch and g.
#include "common.cuh"

constexpr int kConvThreads = 256;
constexpr int kOch = 4;          // output channels per thread
constexpr int kMaxBranches = 3;

struct BranchSet {
  const float* w[kMaxBranches];  // (C, cg, k, k, k) each
  int rad[kMaxBranches];         // k // 2
  int off[kMaxBranches];         // float4 offset of each branch in smem
  int nb;
};

__global__ void __launch_bounds__(kConvThreads)
jlc_branch_conv(const float* __restrict__ x, BranchSet br,
                float* __restrict__ y, int B, int C, int D, int H, int W,
                int cg, int chunks) {
  extern __shared__ float4 ws[];
  const int S = D * H * W;
  const int b = blockIdx.z;
  const int gi = blockIdx.y / chunks;
  const int o0 = gi * cg + (blockIdx.y % chunks) * kOch;

  // stage this block's weights: branch j at ws[off_j + ci * k^3 + tap]
  for (int j = 0; j < br.nb; ++j) {
    const int kk = 2 * br.rad[j] + 1;
    const int taps = kk * kk * kk;
    const float* wj = br.w[j];
    for (int i = threadIdx.x; i < cg * taps; i += blockDim.x) {
      const int ci = i / taps, t = i - ci * taps;
      float4 v4;
      v4.x = wj[((int64_t)(o0 + 0) * cg + ci) * taps + t];
      v4.y = wj[((int64_t)(o0 + 1) * cg + ci) * taps + t];
      v4.z = wj[((int64_t)(o0 + 2) * cg + ci) * taps + t];
      v4.w = wj[((int64_t)(o0 + 3) * cg + ci) * taps + t];
      ws[br.off[j] + i] = v4;
    }
  }
  __syncthreads();

  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= S) return;
  const int xx = v % W, yy = (v / W) % H, zz = v / (W * H);
  int R = 0;
  for (int j = 0; j < br.nb; ++j) R = max(R, br.rad[j]);

  float acc[kMaxBranches][kOch];
#pragma unroll
  for (int j = 0; j < kMaxBranches; ++j)
#pragma unroll
    for (int o = 0; o < kOch; ++o) acc[j][o] = 0.f;

  const float* xg = x + ((int64_t)b * C + (int64_t)gi * cg) * S;
  for (int ci = 0; ci < cg; ++ci) {
    const float* xc = xg + (int64_t)ci * S;
    for (int dz = -R; dz <= R; ++dz) {
      const int z = zz + dz;
      if (z < 0 || z >= D) continue;
      for (int dy = -R; dy <= R; ++dy) {
        const int yv = yy + dy;
        if (yv < 0 || yv >= H) continue;
        for (int dx = -R; dx <= R; ++dx) {
          const int xv = xx + dx;
          if (xv < 0 || xv >= W) continue;
          const float xval = __ldg(xc + ((int64_t)z * H + yv) * W + xv);
          const int r = max(max(abs(dz), abs(dy)), abs(dx));
#pragma unroll
          for (int j = 0; j < kMaxBranches; ++j) {
            if (j < br.nb && r <= br.rad[j]) {
              const int rj = br.rad[j], kk = 2 * rj + 1;
              const int t = ((dz + rj) * kk + (dy + rj)) * kk + (dx + rj);
              const float4 w4 = ws[br.off[j] + ci * kk * kk * kk + t];
              acc[j][0] = fmaf(xval, w4.x, acc[j][0]);
              acc[j][1] = fmaf(xval, w4.y, acc[j][1]);
              acc[j][2] = fmaf(xval, w4.z, acc[j][2]);
              acc[j][3] = fmaf(xval, w4.w, acc[j][3]);
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kMaxBranches; ++j) {
    if (j < br.nb) {
#pragma unroll
      for (int o = 0; o < kOch; ++o)
        y[(((int64_t)j * B + b) * C + o0 + o) * S + v] = acc[j][o];
    }
  }
}

__global__ void jlc_stage1_apply(const float* __restrict__ x,
                                 const float* __restrict__ y,
                                 const float* __restrict__ mean,
                                 const float* __restrict__ rstd,
                                 float* __restrict__ out, int nb,
                                 int64_t planes, int64_t S) {
  const int64_t n = planes * S;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t p = i / S;
    float acc = 0.f;
    for (int j = 0; j < nb; ++j) {
      const int64_t pj = j * planes + p;
      acc += gelu_exact((y[j * n + i] - mean[pj]) * rstd[pj]);
    }
    out[i] = x[i] + acc;
  }
}

// K4b's last launch: one block per (branch, b, c) plane of the scratch.
__global__ void __launch_bounds__(kStatsThreads)
jlc_stage1_bwd_planes(float* __restrict__ y, const float* __restrict__ g,
                      const float* __restrict__ mean,
                      const float* __restrict__ rstd, int64_t planes,
                      int64_t S) {
  const int64_t pj = blockIdx.x;              // branch-major plane index
  float* yp = y + pj * S;
  const float* gp = g + (pj % planes) * S;
  const float m = mean[pj], r = rstd[pj];
  double s1 = 0.0, s2 = 0.0;
  for (int64_t i = threadIdx.x; i < S; i += blockDim.x) {
    const float yh = (yp[i] - m) * r;
    const float dn = gp[i] * gelu_grad(yh);
    s1 += dn;
    s2 += static_cast<double>(dn) * yh;
  }
  block_sum2(s1, s2);
  const float mdn = static_cast<float>(s1 / static_cast<double>(S));
  const float mdny = static_cast<float>(s2 / static_cast<double>(S));
  for (int64_t i = threadIdx.x; i < S; i += blockDim.x) {
    const float yh = (yp[i] - m) * r;
    const float dn = gp[i] * gelu_grad(yh);
    yp[i] = r * (dn - mdn - yh * mdny);
  }
}

// The branch convolution of all nb branches into scratch (nb, B, C, S),
// then their per-plane statistics: the part K4f and K4b share.
static cudaError_t conv_and_stats(const float* x, const float* w0,
                                  const float* w1, const float* w2,
                                  float* scratch, float* mean, float* rstd,
                                  int B, int C, int D, int H, int W,
                                  int groups, int nb, int k0, int k1, int k2,
                                  cudaStream_t stream) {
  const int ks[kMaxBranches] = {k0, k1, k2};
  const float* wp[kMaxBranches] = {w0, w1, w2};
  if (nb < 1 || nb > kMaxBranches || groups < 1 || C % groups) {
    return cudaErrorInvalidValue;
  }
  const int cg = C / groups;
  if (cg % kOch) return cudaErrorInvalidValue;
  BranchSet br;
  br.nb = nb;
  int total = 0;
  for (int j = 0; j < kMaxBranches; ++j) {
    br.w[j] = j < nb ? wp[j] : nullptr;
    br.rad[j] = j < nb ? ks[j] / 2 : 0;
    br.off[j] = total;
    if (j < nb) {
      if (ks[j] % 2 == 0 || wp[j] == nullptr) return cudaErrorInvalidValue;
      total += cg * ks[j] * ks[j] * ks[j];
    }
  }
  const int64_t S = (int64_t)D * H * W;
  const size_t smem = (size_t)total * sizeof(float4);
  cudaError_t err = allow_smem(jlc_branch_conv, smem);
  if (err != cudaSuccess) return err;
  const int chunks = cg / kOch;
  const dim3 grid((unsigned)((S + kConvThreads - 1) / kConvThreads),
                  groups * chunks, B);
  jlc_branch_conv<<<grid, kConvThreads, smem, stream>>>(
      x, br, scratch, B, C, D, H, W, cg, chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  plane_stats_kernel<<<nb * B * C, kStatsThreads, 0, stream>>>(
      scratch, S, 1e-5f, mean, rstd);
  return cudaGetLastError();
}

// x: (B, C, D, H, W); w0..w2: (C, C/groups, k, k, k) for the nb branches
// (unused pointers may be null); scratch: nb·B·C·S floats; mean, rstd:
// nb·B·C floats each; out: like x.
extern "C" int vs_jlc_stage1(const float* x, const float* w0, const float* w1,
                             const float* w2, float* scratch, float* mean,
                             float* rstd, float* out, int B, int C, int D,
                             int H, int W, int groups, int nb, int k0, int k1,
                             int k2, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int64_t S = (int64_t)D * H * W;
  if (S == 0 || B == 0) return cudaSuccess;
  cudaError_t err = conv_and_stats(x, w0, w1, w2, scratch, mean, rstd, B, C,
                                   D, H, W, groups, nb, k0, k1, k2, stream);
  if (err != cudaSuccess) return err;

  const int64_t planes = (int64_t)B * C;
  const int64_t n = planes * S;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads < 65536 * 8
                                         ? (n + threads - 1) / threads
                                         : 65536 * 8);
  jlc_stage1_apply<<<blocks, threads, 0, stream>>>(x, scratch, mean, rstd, out,
                                                   nb, planes, S);
  return cudaGetLastError();
}

// K4b. x, g: (B, C, D, H, W); w0..w2 as for vs_jlc_stage1; dy: nb·B·C·S
// floats, the cotangent at each branch's conv output (branch-major, used
// as the recompute scratch first); mean, rstd: nb·B·C floats each.
extern "C" int vs_jlc_stage1_bwd(const float* x, const float* w0,
                                 const float* w1, const float* w2,
                                 const float* g, float* dy, float* mean,
                                 float* rstd, int B, int C, int D, int H,
                                 int W, int groups, int nb, int k0, int k1,
                                 int k2, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int64_t S = (int64_t)D * H * W;
  if (S == 0 || B == 0) return cudaSuccess;
  cudaError_t err = conv_and_stats(x, w0, w1, w2, dy, mean, rstd, B, C, D, H,
                                   W, groups, nb, k0, k1, k2, stream);
  if (err != cudaSuccess) return err;
  jlc_stage1_bwd_planes<<<nb * B * C, kStatsThreads, 0, stream>>>(
      dy, g, mean, rstd, (int64_t)B * C, S);
  return cudaGetLastError();
}
