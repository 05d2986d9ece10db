// The batched cost tensor: the planner's per-stage cost assembly for a batch
// of candidate plans, one thread per candidate.
//
// Built by metis_tpu_torch/ops/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// into a library with a plain C interface (metis_cost_tensor at the end),
// loaded through ctypes by metis_tpu_torch/ops/cost_tensor.py, whose
// cost_tensor_plain is the same function in PyTorch.
//
// It replaces the reference's jit-compiled cost kernel
// (metis_tpu/cost/jax_backend.py _kernel), which XLA fuses into one
// computation; here the stage count S is a runtime argument, so one build
// serves every placement and batch size.
//
// Layout: x is f64 [W, B], feature-major (column b is candidate b, so the
// threads of a warp read consecutive doubles), W = 7 S + 4 rows:
//   [0, S)            stage_ms   per-stage execution time of one microbatch
//   [S, 2S-1)         act        boundary activation bytes, stage s -> s+1
//   [2S-1, 3S-1)      q          dp ring factor
//   [3S-1, 4S-1)      params     stage parameter bytes
//   [4S-1, 5S-1)      lat        dp all-reduce latency floor
//   [5S-1, 6S-1)      o          optimizer ms per layer
//   [6S-1, 7S-1)      span       layers in the stage
//   7S-1 .. 7S+3      fb_sync, batch_gen, migration, extra_once, extra_pb
// pp_den is f64 [S-1] (the pp link's bytes per ms, shared by the batch);
// out is f64 [6, B]: total, execution, max_opt, dp_charge, pp_charge,
// recovery.
//
// Exactness: the result must be bit-identical to the host's numpy loop
// (metis_tpu_torch/cost/batch.py BatchCostEstimator._fast). Every product,
// sum and quotient is an explicitly rounded intrinsic (__dmul_rn, __dadd_rn,
// __dsub_rn, __ddiv_rn), which nvcc never contracts into a fused
// multiply-add; the divisors batches, layers and share arrive as runtime
// values, so no quotient becomes a multiply by a reciprocal. Sums chain in
// stage order, maxima chain from the first stage's value as Python's max
// does (a later value wins only when strictly larger), and max(0.0, x) is
// x > 0.0 ? x : 0.0.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ double later_max(double m, double v) { return v > m ? v : m; }

__device__ __forceinline__ double clamp0(double x) { return x > 0.0 ? x : 0.0; }

__global__ void cost_tensor_kernel(const double* __restrict__ x,
                                   const double* __restrict__ pp_den,
                                   double* __restrict__ out, int B, int S,
                                   double batches, double spot_scale, double layers,
                                   double share, int ov, int has_lat, int has_spot,
                                   int has_mig) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t n = static_cast<size_t>(B);
  const double* stage = x;
  const double* act = stage + S * n;
  const double* q = act + (S - 1) * n;
  const double* params = q + S * n;
  const double* lat = params + S * n;
  const double* o = lat + S * n;
  const double* span = o + S * n;
  const double* tail = span + S * n;

  double sum_l = 0.0, max_l = 0.0, pp_cost = 0.0, pp_exposed = 0.0;
  double max_dp = 0.0, max_opt = 0.0, max_dpe = 0.0;
  for (int s = 0; s < S; ++s) {
    const size_t i = s * n + b;
    const double t = stage[i];
    sum_l = s == 0 ? t : __dadd_rn(sum_l, t);
    max_l = s == 0 ? t : later_max(max_l, t);
    if (s < S - 1) {
      const double t_pp = __ddiv_rn(act[i], pp_den[s]);
      pp_cost = s == 0 ? t_pp : __dadd_rn(pp_cost, t_pp);
      if (ov) {
        const double e = clamp0(__dsub_rn(t_pp, t));
        pp_exposed = s == 0 ? e : __dadd_rn(pp_exposed, e);
      }
    }
    double dpv = __dmul_rn(__dmul_rn(q[i], params[i]), share);
    if (has_lat) dpv = __dadd_rn(dpv, lat[i]);
    max_dp = s == 0 ? dpv : later_max(max_dp, dpv);
    const double opt = __ddiv_rn(__dmul_rn(o[i], span[i]), layers);
    max_opt = s == 0 ? opt : later_max(max_opt, opt);
    if (ov) {
      const double dpe = clamp0(__dsub_rn(dpv, opt));
      max_dpe = s == 0 ? dpe : later_max(max_dpe, dpe);
    }
  }
  const double fb_sync = tail[b];
  const double batch_gen = tail[n + b];
  const double extra_once = tail[3 * n + b];
  const double extra_pb = tail[4 * n + b];

  double execution = __dadd_rn(__dmul_rn(__dsub_rn(batches, 1.0), max_l), sum_l);
  // the step overhead: the host fills exactly one of the two terms, so
  // adding both keeps the op unconditional and exact (x + 0.0 == x, x >= 0)
  execution = __dadd_rn(__dadd_rn(execution, extra_once), __dmul_rn(extra_pb, batches));
  const double dp_charge = ov ? max_dpe : max_dp;
  const double pp_charge = ov ? pp_exposed : pp_cost;  // 0.0 for one stage
  double total = __dadd_rn(execution, fb_sync);
  total = __dadd_rn(total, max_opt);
  total = __dadd_rn(total, dp_charge);
  total = __dadd_rn(total, pp_charge);
  total = __dadd_rn(total, batch_gen);
  double recovery = 0.0;
  if (has_spot) {
    recovery = __dmul_rn(total, spot_scale);
    total = __dadd_rn(total, recovery);
  }
  if (has_mig) total = __dadd_rn(total, tail[2 * n + b]);  // migration
  out[b] = total;
  out[n + b] = execution;
  out[2 * n + b] = max_opt;
  out[3 * n + b] = dp_charge;
  out[4 * n + b] = pp_charge;
  out[5 * n + b] = recovery;
}

}  // namespace

extern "C" {

int metis_cost_tensor(const void* x, const void* pp_den, void* out, int B, int S,
                      double batches, double spot_scale, double layers, double share,
                      int ov, int has_lat, int has_spot, int has_mig, void* stream) {
  if (B < 1 || S < 1) return cudaErrorInvalidValue;
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  cost_tensor_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(x), static_cast<const double*>(pp_den),
      static_cast<double*>(out), B, S, batches, spot_scale, layers, share, ov, has_lat,
      has_spot, has_mig);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
