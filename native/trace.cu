// Per-ray BVH traversal for NVIDIA GPUs, called from JAX through the FFI.
//
// One thread walks one ray over the binned-SAH tree of bvh_builder.cpp
// (DFS preorder: the left child of inner node i is i + 1, the right child is
// stored in the node). Children are visited near-first by the sign of the
// ray direction along the node's split axis (the builder puts the lower side
// of that axis on the left); the far child goes on a short per-thread stack
// with its entry distance, and is skipped on pop once a closer hit exists.
//
// Layout (vision_tpu/accel/sah.py builds it):
//   boxes [N, 8] f32   lo.xyz, 0, hi.xyz, 0
//   links [N, 2] i32   inner: (right child, -(axis + 1)); leaf: (first, count)
//   tris  [T, 12] f32  p0.xyz 0, e1.xyz 0, e2.xyz 0 in leaf order
//   prim  [T] i32      original triangle id of each row
//   rays  [R, 8] f32   o.xyz, t_max, d.xyz, 0
// Results: t [R] f32 (t_max on a miss), prim_id [R] i32 (-1 on a miss) and
// truncated [1] i32, the number of rays whose stack overflowed (their result
// may miss a subtree; the caller reports it).
//
// The triangle test is the Moller-Trumbore of accel/intersect.py `_mt_batch`
// with the same epsilons, so results agree with the dense sweep.
//
// Build: make -C native cuda

#include <cstdint>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kBlock = 128;
constexpr int kStack = 96;  // builder depth <= 48 + log2(n / leaf)
constexpr float kDetEps = 1e-9f;
constexpr float kEdgeEps = 1e-6f;

__device__ __forceinline__ float safe_rcp(float d) {
  return fabsf(d) > 1e-12f ? 1.0f / d : copysignf(1e12f, d);
}

__device__ __forceinline__ bool box_hit(const float4* boxes, int node,
                                        float3 o, float3 inv, float t_best,
                                        float* t_entry) {
  const float4 lo = __ldg(&boxes[2 * node]);
  const float4 hi = __ldg(&boxes[2 * node + 1]);
  const float x0 = (lo.x - o.x) * inv.x, x1 = (hi.x - o.x) * inv.x;
  const float y0 = (lo.y - o.y) * inv.y, y1 = (hi.y - o.y) * inv.y;
  const float z0 = (lo.z - o.z) * inv.z, z1 = (hi.z - o.z) * inv.z;
  const float tn = fmaxf(fmaxf(fminf(x0, x1), fminf(y0, y1)), fminf(z0, z1));
  const float tf = fminf(fminf(fmaxf(x0, x1), fmaxf(y0, y1)), fmaxf(z0, z1));
  *t_entry = tn;
  return tf >= fmaxf(tn, 0.0f) && tn < t_best;
}

// Moller-Trumbore; returns t of a hit in (0, t_best), or -1.
__device__ __forceinline__ float tri_hit(const float4* tris, int k, float3 o,
                                         float3 d, float t_best) {
  const float4 p0 = __ldg(&tris[3 * k]);
  const float4 e1 = __ldg(&tris[3 * k + 1]);
  const float4 e2 = __ldg(&tris[3 * k + 2]);
  const float pvx = d.y * e2.z - d.z * e2.y;
  const float pvy = d.z * e2.x - d.x * e2.z;
  const float pvz = d.x * e2.y - d.y * e2.x;
  const float det = e1.x * pvx + e1.y * pvy + e1.z * pvz;
  if (!(fabsf(det) > kDetEps)) return -1.0f;
  const float inv_det = 1.0f / det;
  const float tvx = o.x - p0.x, tvy = o.y - p0.y, tvz = o.z - p0.z;
  const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
  const float qvx = tvy * e1.z - tvz * e1.y;
  const float qvy = tvz * e1.x - tvx * e1.z;
  const float qvz = tvx * e1.y - tvy * e1.x;
  const float v = (d.x * qvx + d.y * qvy + d.z * qvz) * inv_det;
  const float t = (e2.x * qvx + e2.y * qvy + e2.z * qvz) * inv_det;
  const bool ok = u >= -kEdgeEps && v >= -kEdgeEps &&
                  u + v <= 1.0f + kEdgeEps && t > 0.0f && t < t_best;
  return ok ? t : -1.0f;
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kBlock)
    trace_kernel(const float4* __restrict__ boxes,
                 const int2* __restrict__ links,
                 const float4* __restrict__ tris,
                 const int32_t* __restrict__ prim,
                 const float4* __restrict__ rays, int64_t n_rays,
                 float* __restrict__ t_out, int32_t* __restrict__ id_out,
                 int32_t* __restrict__ truncated) {
  const int64_t i = (int64_t)blockIdx.x * kBlock + threadIdx.x;
  if (i >= n_rays) return;
  const float4 r0 = rays[2 * i];
  const float4 r1 = rays[2 * i + 1];
  const float3 o = make_float3(r0.x, r0.y, r0.z);
  const float3 d = make_float3(r1.x, r1.y, r1.z);
  const float3 inv = make_float3(safe_rcp(d.x), safe_rcp(d.y), safe_rcp(d.z));
  float t_best = r0.w;
  int best = -1;
  bool overflow = false;

  int stack_node[kStack];
  float stack_t[kStack];
  int sp = 0;
  float t_entry;
  int node = 0;
  bool live = t_best > 0.0f && box_hit(boxes, 0, o, inv, t_best, &t_entry);
  while (live) {
    const int2 ln = links[node];
    if (ln.y > 0) {
      for (int k = ln.x; k < ln.x + ln.y; ++k) {
        const float t = tri_hit(tris, k, o, d, t_best);
        if (t > 0.0f) {
          t_best = t;
          best = k;
        }
      }
      if (kAnyHit && best >= 0) break;
    } else {
      const int axis = -ln.y - 1;
      const float da = axis == 0 ? d.x : (axis == 1 ? d.y : d.z);
      const int near_node = da >= 0.0f ? node + 1 : ln.x;
      const int far_node = da >= 0.0f ? ln.x : node + 1;
      float t_near, t_far;
      const bool h_near = box_hit(boxes, near_node, o, inv, t_best, &t_near);
      const bool h_far = box_hit(boxes, far_node, o, inv, t_best, &t_far);
      if (h_near && h_far) {
        if (sp < kStack) {
          stack_node[sp] = far_node;
          stack_t[sp] = t_far;
          ++sp;
        } else {
          overflow = true;
        }
      }
      if (h_near || h_far) {
        node = h_near ? near_node : far_node;
        continue;
      }
    }
    // pop the nearest pending subtree that can still hold a closer hit
    live = false;
    while (sp > 0) {
      --sp;
      if (stack_t[sp] < t_best) {
        node = stack_node[sp];
        live = true;
        break;
      }
    }
  }
  t_out[i] = t_best;
  id_out[i] = best >= 0 ? prim[best] : -1;
  if (overflow) atomicAdd(truncated, 1);
}

template <bool kAnyHit>
ffi::Error Trace(cudaStream_t stream, ffi::Buffer<ffi::F32> boxes,
                 ffi::Buffer<ffi::S32> links, ffi::Buffer<ffi::F32> tris,
                 ffi::Buffer<ffi::S32> prim, ffi::Buffer<ffi::F32> rays,
                 ffi::ResultBuffer<ffi::F32> t_out,
                 ffi::ResultBuffer<ffi::S32> id_out,
                 ffi::ResultBuffer<ffi::S32> truncated) {
  const int64_t n_rays = t_out->element_count();
  if (rays.element_count() != 8 * n_rays || links.element_count() * 4 !=
      boxes.element_count() || tris.element_count() != 12 * prim.element_count())
    return ffi::Error::InvalidArgument("vt_trace: inconsistent shapes");
  cudaMemsetAsync(truncated->typed_data(), 0, sizeof(int32_t), stream);
  if (n_rays > 0) {
    const int64_t grid = (n_rays + kBlock - 1) / kBlock;
    trace_kernel<kAnyHit><<<grid, kBlock, 0, stream>>>(
        reinterpret_cast<const float4*>(boxes.typed_data()),
        reinterpret_cast<const int2*>(links.typed_data()),
        reinterpret_cast<const float4*>(tris.typed_data()),
        prim.typed_data(), reinterpret_cast<const float4*>(rays.typed_data()),
        n_rays, t_out->typed_data(), id_out->typed_data(),
        truncated->typed_data());
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

auto Bind() {
  return ffi::Ffi::Bind()
      .Ctx<ffi::PlatformStream<cudaStream_t>>()
      .Arg<ffi::Buffer<ffi::F32>>()   // boxes
      .Arg<ffi::Buffer<ffi::S32>>()   // links
      .Arg<ffi::Buffer<ffi::F32>>()   // tris
      .Arg<ffi::Buffer<ffi::S32>>()   // prim
      .Arg<ffi::Buffer<ffi::F32>>()   // rays
      .Ret<ffi::Buffer<ffi::F32>>()   // t
      .Ret<ffi::Buffer<ffi::S32>>()   // prim_id
      .Ret<ffi::Buffer<ffi::S32>>();  // truncated
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(VtTraceClosest, Trace<false>, Bind());
XLA_FFI_DEFINE_HANDLER_SYMBOL(VtTraceAny, Trace<true>, Bind());
