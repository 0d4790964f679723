"""Device milliseconds a traced generate+fit call spends in the strict-f32
cuBLAS products: the GEMM and GEMV kernels of the fit's decode, VPoser's
and the sampler's, with the split-K reductions, epilogues and scalings that
cuBLAS launches for them. Read from the device's kernels by name, so a call
reads the same whether its fit replays a CUDA graph or runs eagerly.

The patterns are parts of the names these kernels had in traced runs of
``s2_fit_exact`` and ``s1_fit_prod`` on an NVIDIA H100 80GB HBM3 (torch
2.11, CUDA 12.8):

- ``sm80_xmma_gemm_f32f32_f32f32_f32_{tn,nn,nt}_n_tilesize..._execute[_split_k]_kernel__5x_cublas``
- ``void cutlass::Kernel2<cutlass_80_simt_sgemm_{64x64_8x5_nn,...}_align1>``
- ``void sgemm_largek_lds64<...>``
- ``void gemv2N_kernel<int, int, float, float, float, float, 128, 2, ...>``
- ``internal::gemvx::kernel<int, int, float, float, float, float, ...>``
- ``void cublasLt::splitKreduce_kernel<32, 16, int, float, float, float, float, ...>``
- ``void cublasLt::epilogue::impl::globalKernel<8, 32, float, float, float, ...>``
- ``void scal_kernel<float, float, 1, true, ...>``

They match none of the port's own kernels (``split_*``: K4/K5; ``skin_*``,
``splitk_gemm_kernel``, ``reduce_tiles_kernel``: K1/K2; ``nn_argmin_kernel``:
K3) and none of cuDNN's convolutions (``..._implicit_gemm_f32f32...``,
``convolve_common_engine_float_NHWC``)."""

from benchmark.readers import per_unit

PATTERNS = ("xmma_gemm_f32f32_f32f32_f32_", "_simt_sgemm_", "sgemm_largek_",
            "gemv2N_kernel<int, int, float, float, float, float,", "gemvx::kernel<int, int, float, float, float, float,",
            "splitKreduce_kernel<32, 16, int, float, float, float, float,",
            "epilogue::impl::globalKernel<8, 32, float, float, float,", "scal_kernel<float, float,")


def read(ctx):
    t = ctx.trace
    if t is None or not t.device:
        return None
    return per_unit(ctx, 1e3 * t.device_s(PATTERNS))
