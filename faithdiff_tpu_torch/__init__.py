"""faithdiff_tpu_torch: the PyTorch / CUDA port of `faithdiff_tpu` for an
NVIDIA H100.

- ``faithdiff_tpu_torch.ops``        attention (BHSD and packed), GroupNorm,
                                     NF4 dequant-matmul, attention variants;
                                     the CUDA kernels (``csrc/``) and their
                                     plain versions
- ``faithdiff_tpu_torch.models``     SDXL UNet + FaithDiff fusion, VAE,
                                     denoise encoder (nn.Modules, NCHW);
                                     SDXL's two CLIP text towers and its
                                     CLIP BPE tokenizer
- ``faithdiff_tpu_torch.schedulers`` Euler and DDPM with explicit state
- ``faithdiff_tpu_torch.pipelines``  the tiled restore pipeline and factory
- ``faithdiff_tpu_torch.captioner``  the LLaVA-1.5 captioner: CLIP vision
                                     tower, projector, LLaMA / MPT decoders,
                                     caption agent
- ``faithdiff_tpu_torch.utils``      color fix, image helpers, int8 / NF4
                                     quantisation, weight carry
- ``faithdiff_tpu_torch.training``   prompt embeddings precomputed for
                                     training (``cli embed``)
- ``faithdiff_tpu_torch.scripts``    the attention-variant benchmark

It imports torch, numpy and the standard library only. Entry points run on
the CUDA card unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
