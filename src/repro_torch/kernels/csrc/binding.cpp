// PyTorch binding of the attention kernels and the SSD scan, and of their
// gradients — the only source that includes PyTorch's headers.  The Python
// wrappers (kernels/paged_attention.py, kernels/flash_attention.py,
// kernels/decode_attention.py, kernels/ssd_scan.py) have already checked
// device, dtype, shape and contiguity; this file launches on PyTorch's
// current stream and checks the launch.
#include <torch/extension.h>

#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>

#include "kernels.h"

namespace {

float* scratch(const torch::Tensor& part) {
  return part.numel() ? part.data_ptr<float>() : nullptr;
}

void paged_decode(const torch::Tensor& q, const torch::Tensor& k_arena,
                  const torch::Tensor& v_arena, const torch::Tensor& tables,
                  const torch::Tensor& lengths, torch::Tensor out,
                  torch::Tensor part, torch::Tensor counters,
                  int64_t min_pages, int64_t n_split, int64_t ctas,
                  double sm_scale, int64_t window) {
  const c10::cuda::CUDAGuard guard(q.device());
  C10_CUDA_CHECK(repro_torch::launch_paged_decode(
      q.scalar_type() == at::kBFloat16, q.data_ptr(), k_arena.data_ptr(),
      v_arena.data_ptr(), tables.data_ptr<int>(), lengths.data_ptr<int>(),
      out.data_ptr(), scratch(part), counters.data_ptr<int>(), q.size(0),
      q.size(1), k_arena.size(2), q.size(2), k_arena.size(1), tables.size(1),
      min_pages, n_split, ctas, static_cast<float>(sm_scale), window,
      at::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void paged_prefill(const torch::Tensor& q, const torch::Tensor& k_arena,
                   const torch::Tensor& v_arena, const torch::Tensor& table,
                   const torch::Tensor& positions, torch::Tensor out,
                   torch::Tensor part, int64_t tq, int64_t min_pages,
                   int64_t n_split, double sm_scale, int64_t window) {
  const c10::cuda::CUDAGuard guard(q.device());
  C10_CUDA_CHECK(repro_torch::launch_paged_prefill(
      q.scalar_type() == at::kBFloat16, q.data_ptr(), k_arena.data_ptr(),
      v_arena.data_ptr(), table.data_ptr<int>(), positions.data_ptr<int>(),
      out.data_ptr(), scratch(part), q.size(0), q.size(1), k_arena.size(2),
      q.size(2), k_arena.size(1), table.size(0), tq, min_pages, n_split,
      static_cast<float>(sm_scale), window,
      at::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// window_end and lse: empty tensors when the caller gives or needs none
void decode(const torch::Tensor& q, const torch::Tensor& k_cache,
            const torch::Tensor& v_cache, const torch::Tensor& lengths,
            const torch::Tensor& window_end, torch::Tensor out,
            torch::Tensor lse, torch::Tensor part, torch::Tensor counters,
            int64_t min_pages, int64_t n_split, int64_t ctas,
            double sm_scale, int64_t window) {
  const c10::cuda::CUDAGuard guard(q.device());
  C10_CUDA_CHECK(repro_torch::launch_decode(
      q.scalar_type() == at::kBFloat16, q.data_ptr(), k_cache.data_ptr(),
      v_cache.data_ptr(), lengths.data_ptr<int>(), lengths.dim() == 0 ? 0 : 1,
      window_end.numel() ? window_end.data_ptr<int>() : nullptr,
      window_end.dim() == 0 ? 0 : 1, out.data_ptr(), scratch(lse),
      scratch(part), counters.data_ptr<int>(), q.size(0),
      q.size(1), k_cache.size(2), q.size(2), k_cache.size(1), min_pages,
      n_split, ctas, static_cast<float>(sm_scale), window,
      at::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// lse: an empty tensor when the caller needs none
void flash(const torch::Tensor& q, const torch::Tensor& k,
           const torch::Tensor& v, torch::Tensor out, torch::Tensor lse,
           int64_t tq, bool causal, int64_t window, double sm_scale) {
  const c10::cuda::CUDAGuard guard(q.device());
  C10_CUDA_CHECK(repro_torch::launch_flash(
      q.scalar_type() == at::kBFloat16, q.data_ptr(), k.data_ptr(),
      v.data_ptr(), out.data_ptr(), scratch(lse), q.size(0), q.size(1),
      k.size(1), q.size(2), k.size(2), q.size(3), tq, causal, window,
      static_cast<float>(sm_scale), at::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// part: the backward's f32 scratch, an empty tensor when it needs none
void flash_bwd(const torch::Tensor& q, const torch::Tensor& k,
               const torch::Tensor& v, const torch::Tensor& out,
               const torch::Tensor& dout, const torch::Tensor& lse,
               torch::Tensor delta, torch::Tensor dq, torch::Tensor dk,
               torch::Tensor dv, torch::Tensor part, int64_t tq,
               int64_t n_split, bool causal, int64_t window,
               double sm_scale) {
  const c10::cuda::CUDAGuard guard(q.device());
  C10_CUDA_CHECK(repro_torch::launch_flash_bwd(
      q.scalar_type() == at::kBFloat16, q.data_ptr(), k.data_ptr(),
      v.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr<float>(),
      delta.data_ptr<float>(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
      scratch(part), q.size(0), q.size(1), k.size(1), q.size(2), k.size(2),
      q.size(3), tq, n_split, causal, window, static_cast<float>(sm_scale),
      at::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

int64_t flash_bwd_ctas_per_sm(bool bf16, int64_t dh) {
  int n = 0;
  C10_CUDA_CHECK(repro_torch::flash_bwd_ctas_per_sm(bf16, dh, &n));
  return n;
}

// states: an empty tensor when the caller needs none
void ssd(const torch::Tensor& x, const torch::Tensor& dt,
         const torch::Tensor& A, const torch::Tensor& B, const torch::Tensor& C,
         torch::Tensor y, torch::Tensor state, torch::Tensor states,
         int64_t chunk, int64_t ps) {
  const c10::cuda::CUDAGuard guard(x.device());
  C10_CUDA_CHECK(repro_torch::launch_ssd(
      x.scalar_type() == at::kBFloat16, x.data_ptr(), dt.data_ptr<float>(),
      A.data_ptr<float>(), B.data_ptr(), C.data_ptr(), y.data_ptr<float>(),
      state.data_ptr<float>(), scratch(states), x.size(0), x.size(1),
      x.size(2), x.size(3), B.size(2), B.size(3), chunk, ps,
      at::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// dstate: an empty tensor for a zero gradient of the final state
void ssd_bwd(const torch::Tensor& x, const torch::Tensor& dt,
             const torch::Tensor& A, const torch::Tensor& B,
             const torch::Tensor& C, const torch::Tensor& states,
             const torch::Tensor& dy, const torch::Tensor& dstate,
             torch::Tensor dh1, torch::Tensor dx, torch::Tensor ddt,
             torch::Tensor dA_part, torch::Tensor dB_part,
             torch::Tensor dC_part, torch::Tensor dA, torch::Tensor dB,
             torch::Tensor dC, int64_t chunk, int64_t ps) {
  const c10::cuda::CUDAGuard guard(x.device());
  C10_CUDA_CHECK(repro_torch::launch_ssd_bwd(
      x.scalar_type() == at::kBFloat16, x.data_ptr(), dt.data_ptr<float>(),
      A.data_ptr<float>(), B.data_ptr(), C.data_ptr(),
      states.data_ptr<float>(), dy.data_ptr<float>(),
      dstate.numel() ? dstate.data_ptr<float>() : nullptr,
      dh1.data_ptr<float>(), dx.data_ptr(), ddt.data_ptr<float>(),
      dA_part.data_ptr<float>(), dB_part.data_ptr<float>(),
      dC_part.data_ptr<float>(), dA.data_ptr<float>(), dB.data_ptr(),
      dC.data_ptr(), x.size(0), x.size(1), x.size(2), x.size(3), B.size(2),
      B.size(3), chunk, ps, at::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("paged_decode", &paged_decode, "split-KV paged flash-decode (CUDA)");
  m.def("paged_prefill", &paged_prefill,
        "split-KV paged chunked-prefill attention (CUDA)");
  m.def("decode", &decode, "split-KV contiguous flash-decode (CUDA)");
  m.def("flash", &flash, "contiguous flash attention (CUDA)");
  m.def("flash_bwd", &flash_bwd,
        "gradient of the contiguous flash attention (CUDA)");
  m.def("flash_bwd_ctas_per_sm", &flash_bwd_ctas_per_sm,
        "dK/dV CTAs of the flash backward an SM holds (CUDA)");
  m.def("ssd", &ssd, "Mamba2 SSD chunked scan (CUDA)");
  m.def("ssd_bwd", &ssd_bwd, "gradient of the Mamba2 SSD chunked scan (CUDA)");
}
