#!/usr/bin/env python3
"""Smoke test of the PyTorch port (`faithdiff_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Requires a CUDA card; prints its name and power limit.
2. Builds the port's CUDA kernels from `faithdiff_tpu_torch/csrc/` (one
   `nvcc` per source, all started together).
3. Holds the flash-attention kernels (BHSD at d=64 and d=128, packed; the
   wide head dims in `attention_wide_d`, step 9d), the
   attention-variant kernel and the GroupNorm kernels against their plain
   PyTorch versions on the card, in bf16 at their paths' shapes, and times
   kernel, plain version, a PyTorch library call that computes the same
   function (a yardstick only) and the card's bound for the same work.
   The flash rows' kernel and library times come from CUDA graphs, with
   the achieved TFLOP/s, the time over the bound and the wrapper's host
   cost beside them. Also holds the flash kernels at ragged and short
   lengths and on column-slice operands (correctness only).
3b. GroupNorm, both routes of `ops/groupnorm.plan_group_norm` at the UNet's
   ResNet / Transformer2D shapes at batch 4, the full-resolution VAE shape
   and the 15-tile restore's [30, 2560, 32, 32] (B*C = 76,800 rows): the
   single-pass cluster kernel where the plan has one (output against the
   plain version and against `group_norm_tiled`, statistics read from an
   fp32 run, same bits on a repeat) and the two-pass pair through the
   launch's own methods. Every GroupNorm time comes from CUDA graphs, each
   row with its bound, `F.group_norm` where that one call computes the same
   function, and the wrapper's host cost (`host_us`).
4. Runs a full-width restore (default SDXL UNet / VAE / denoise-encoder
   configs, bf16, seeded random weights) of a 1024x1536 uint8 image: two
   128^2 latent tiles, 20 Euler steps, guidance 5, start_point "lr",
   wavelet color fix. Checks the output and that every kernel of the path
   was launched the expected number of times: the flash kernel once per
   self-attention, and each GroupNorm's kernels as the launch plan predicts
   from the shape each GroupNorm module saw (forward hooks).
5. Runs the restore's last UNet call once more under torch.profiler and
   prints device time by layer and by kernel, and the busy share.
5b. Runs the same restore again on the packed-attention path
   (`transformer2d._BSND_ATTN`, as FAITHDIFF_BSND_ATTN=1 sets it), checks
   it and its launches, profiles its last UNet call, and holds that call
   on the packed path against the default path.
5b+. `restore_fp8`: the same restore with `build_pipeline(use_fp8=True)`
   on the same weights (the UNet's stored in fp8, each upcast where its
   layer runs): the fp8 cast on the card at the values around e4m3fn's top
   (NaN past 464, as JAX), the flash and GroupNorm launches the bf16
   restore's, the upcasts a UNet call counted, the weight bytes in fp8
   against bf16, and one UNet call equal in every bit to the same call of
   a bf16 UNet holding the fp8 values upcast. `restore_karras`: the
   restore with Karras sigmas, the sigmas and timesteps the CPU's.
   `schedulers`: ancestral Euler (plain and Karras), DDIM (eta 0, 0.5)
   and DDPM steps and the v target on a 4-tile latent batch on the card
   against the CPU with the same noise.
5b'. `cli_restore`: the restore pipeline's weights written in the
   reference's file layout (the SDXL UNet's safetensors file in bf16,
   FaithDiff.bin, the VAE's safetensors file) under
   `faithdiff_tpu_torch/_build/`, converted by the port's `convert_cli`,
   then `faithdiff_tpu_torch.cli.main(["restore", ...])` with the default
   flags on a seeded 512x768 PNG: the weights it loads (strictly) must be
   the pipeline's, its 1024x1536 PNG identical in every byte to the
   in-memory pipeline's uint8 output on `resize_lanczos` of the same image,
   its launches as planned. `cli_restore_tiled`: the same CLI with
   `--upscale 2 --use_tile_vae --hdr 0.5 --color_fix adain` on a seeded
   1000x1000 PNG: a (2000, 2000, 3) output, finite latents, 9 latent tiles
   (18 UNet rows a step, in the CLI's chunks), the encode, denoise-encoder and decode tiles of the
   tiling formula, launches as planned. Both print write / convert / load
   seconds and the CLI's read, encode, HDR, resize, pipeline and write
   seconds. `cli_restore_prompt`: seeded full-width text towers written
   as SDXL ships them (fp16 `text_encoder*/model.safetensors`) and
   tokenizer dirs of a synthetic 49408-symbol vocabulary (BOS / EOS at
   49406 / 49407, `tokenizer_2` padding with `!`), converted, then the CLI
   with `--tokenizer_dir`, a caption JSON and `--negative_prompt` on
   `cli_restore`'s PNG: identical in every byte to the in-memory pipeline
   given the port's own encodes of the same texts, and unlike the
   zero-embed output. `cli_restore_fp8`: `restore --use_fp8` on the same
   converted weights and photo, identical in every byte to the in-memory
   fp8 pipeline. `png_formats`: the photo as a 16-bit RGB and as an
   Adam7-interlaced PNG (written by this script), each restored by the
   CLI to a PNG identical in every byte to `cli_restore`'s output. The
   in-memory pipelines of the CLI phases run the
   CLI's `TILE_CHUNK`. `metrics`: seeded weights of the seven learned IQA
   networks at their published widths (LPIPS AlexNet and VGG16, DISTS,
   the pt_inception FID net as flax msgpack and as a torchvision `.pth`,
   CLIP ViT-L/14 with its prompts, MUSIQ, MANIQA, PaQ-2-PiQ) written in
   the JAX harness's layouts by the port's writers, NIQE fitted with
   `--fit_niqe_dir`, then `cli.main(["metrics", ..., "--device", "cuda"])`
   over 4 SR / GT PNG pairs at 1024x1536 (the first SR `cli_restore`'s
   output, one GT at another size): all ten metrics finite, none
   UNAVAILABLE, no counted kernel launched; PSNR / SSIM against float64
   numpy; each network on the card against the port's CPU run; ms per
   image by metric, NIQE's host seconds, wall seconds, peak memory. The
   weight files are deleted afterwards, also when a phase fails.
5b''. `restore_large`: the same pipeline on a 2048x3072 uint8 image (a
   1024x1536 photo at the CLI's default --upscale 2): 15 latent tiles, UNet
   batch 30, 20 steps, the default attention path; checks the output
   shape, finite latents, 20 UNet calls and the planned GroupNorm launches,
   and prints wall, denoise and decode seconds, the UNet call medians,
   peak memory and the launches. `chunk_parity`: its first UNet call
   unchunked against chunks of the CLI's `TILE_CHUNK`, on both attention
   paths, beside the same call with its tiles reversed.
   `tile_chunk_sweep`: one full-width UNet call at chunks of 1-24 tiles
   (UNet batch 2-48), the median of 3 by CUDA events, the peak memory,
   the pick (lowest ms per tile leaving 40 GiB free) and profiles at the
   pick and the next chunk up. `restore_4k`: a 4096x4096 restore (49
   tiles) with `use_tiled_vae` and the CLI's chunk, keeping canvases, then
   a resume after deleting the last two: 2 * ceil(49 / c) UNet calls and
   the same bytes; its checks as `restore_large`'s. Then frees the
   pipeline. `text_towers`: the full-width SDXL text towers, bf16 on the
   card, against fp32 on the CPU over 4 prompts of the port's BPE.
5b'''. `vae_chunk_trap`: one `chunked_attention` call as the untiled VAE
   decode of a 2000x2000 image runs it ([1, 1, 62500, 512] bf16, chunk 4,
   15,625 loop steps) against the same call at kv 65,536 (chunk 1024).
5c. Runs the attention-variant benchmark's entry point
   (`faithdiff_tpu_torch.scripts.bench_attention_variants.main`) and
   checks its launches.
6. Holds the NF4 dequant-matmul kernel against its
   plain version at the 13B captioner's shapes (M = 1, 2, 4, 8 on the
   decode route; 16, a decode step of 16 images, 640 and the caption's own
   prefill M, 2 x the prompt length, on the prefill route), with its
   bound, the time over the bound,
   the route that served it, the same bits on two calls and, as context
   only, a bf16 matmul against the decoded weight.
7. Holds a tiny nf4 captioner LLaMA on the card (kernel) against the same
   weights on the CPU (plain version, fp32), and runs the causal prefill
   of the full-width 13B LLaMA's first two layers over 1024 tokens, which
   goes through the flash kernel at head dim 128.
8. Captions two images with the full-width LLaVA-1.5-13B captioner
   (`quant="nf4"`, ViT-L/14-336, mlp2x projector; bf16, seeded random
   weights; the agent's defaults: temperature 0.2, top-p 0.7, 512 new
   tokens) and checks the prompt, the tokens, finite logits and that the
   NF4 kernel ran 280 times (7 projections x 40 layers) per forward pass,
   on the prefill route for the prefill and the decode route for each
   decode forward;
   then profiles the prefill and the last decode step as step 5 profiles
   the UNet. `vqa`: the same nf4 agent answers 4 questions over 2 PNGs
   through `eval.vqa.run_vqa` and `eval.generators.run_vqa_loader` (the
   same answers) and a 2-row MMBench TSV of base64 PNGs through
   `run_mmbench` (6 circular rounds), 12 new tokens an answer; the POPE
   and TextVQA evaluators and the circular scorer read the answers; every
   forward launches the NF4 kernel 280 times on its route and nothing
   else counted; answers / s and decode ms a step.
8b. `caption_int8`: the same caption with `quant="int8"` (the caption
   CLI's default, plain torch): the same checks, no counted launch, and a
   profile of its last decode step. `cli_caption`: seeded LLaVA-1.5-13B
   weights at full width and 8 of its 40 layers (a cut for disk space:
   ~6.6 GB fp16) written as the reference ships them (two `.bin` shards
   and their index, `model.mm_projector.*`, a 32000-piece
   `tokenizer.model` and its JSON files, a whole CLIPModel ViT-L/14-336
   `.bin`), converted by `convert_cli --llava --clip_vision`, then
   `cli.main(["caption", ...])` on two seeded PNGs: buffers equal to the
   int8 quantisation of the written weights, each JSON caption equal to
   the in-memory agent's, a second call skipping both images,
   `--use_bsrnet` the same JSON; then `from_checkpoint(load_4bit=True)`:
   the nf4 buffers, one caption, 56 NF4 launches a forward on the right
   routes. The files are deleted afterwards, also when the phase fails.
   `bsrnet`: the full-width RRDBNet (x4) in bf16, `deg_remove` of a
   1024x1536 image (6 tiles -> 4096x6144), a 64x64 crop against fp32 on
   the CPU.
9. Training (`cli.py train`). `train_autograd`: the three kernel entry
   points under autograd in bf16 (flash [16,10,1024,64], [2,10,4096,64]
   and causal [2,40,1024,128], caption training's), packed [16,1024,640] with 10 heads, GroupNorm
   [16,320,64,64] + SiLU + add on the single-pass route and
   [2,128,512,512] + SiLU on the two-pass route): the forward equal in
   every bit to the bare kernel and within 1e-2 + 8e-3*|ref| of the plain
   version (the restore checks' tolerance), one launch a forward and none
   in the backward, every gradient equal in every bit to autograd over the
   plain version (the backward is that autograd, on the same inputs);
   kernel-forward and backward ms. `train_stage1`: the
   full-width UNet, denoise encoder and VAE built on the card from a
   seeded init (the fusion adapters without their zero init), 512 px,
   batch 16 (or the largest that fits), accum 4, no remat: an optimizer
   step and a micro-step; frozen tensors keep every bit, every adapter
   tensor (spatial_ch_projs too) changes at the 4th micro-step only,
   flash launches one per self-attention at >= 1024 tokens, GroupNorm
   launches as planned; ms per micro-step (CUDA events), peak GiB.
   `train_stage2`: batch 2, accum 16, remat, EMA every update: two
   optimizer steps; every tensor changes at each boundary only, the EMA
   moves at each boundary, the launches include remat's recomputed
   forwards; the second boundary under torch.profiler, its device time
   split into forward, backward (and its plain attention / GroupNorm
   recompute) and optimizer. `cli_train`: `cli.main(["train",
   "--synthetic_data", ...])` at full width with checkpoints and a
   resume (kept steps, metrics rows, the restored state equal in every
   checksum to the saved one, the steps continuing), then a run over
   seeded PNG pairs with captions and a validation strip; the files are
   deleted afterwards.
9b. `degradation`: 10 seeded plans of `RealESRGANDegradation()` at its
   defaults on batches of 16 GT crops at 512^2 (LQ [16, 128, 128, 3]):
   ms a batch (median), peak GiB; then one plan on the card with TF32 off
   against the CPU with the same draws: max and mean error and the share
   of LQ values on another 8-bit level. `caption_train`: LLaVA-1.5-13B's widths and
   40 layers (bf16 dense base), ViT-L/14-336 frozen, 2 sequences of 1024
   tokens (576 image tokens): three "projector" steps and three LoRA
   steps (rank 128, alpha 256 on the seven projections): finite losses,
   frozen tensors bitwise still, every trainable tensor changed, the
   projector step's grad_norm equal to the norm over every gradient (the
   frozen LLaMA's too), 40 flash launches (causal, d = 128) a step; ms a
   step and the peak.
9c. fp32 and multi-GPU. `kernel_checks` also holds the fp32 flash kernel
   (`csrc/flash_attention_f32.cu`) against its plain version in full fp32
   (TF32 off) within 2e-5 * max|ref| at [2,10,4096,64], [2,20,1024,64],
   causal [1,40,1024,128] and packed [2,4096,640] (10 heads), the same bits
   on two calls, with its bound at the rate of fp32-accurate tensor-core
   products (3xTF32: 495 / 3 TFLOP/s) and SDPA in fp32 as the yardstick
   (its own largest error against the plain version beside the kernel's).
   `serving_demo` (after `png_formats`): `serving/web_demo.py` through its
   `main` in a subprocess on `cli_restore`'s checkpoint; its `/restore`
   of `cli_restore`'s photo identical in every byte to the CLI's PNG, and
   of the 128 x 128 JPEG fixture to `cli_restore_jpeg`'s PNG.
   `distributed` (after `restore_4k`): a one-rank NCCL group; the 1024x1536 restore with the pipeline's `tile_group`
   and a stage-1 micro-step plus optimizer step under data parallelism and
   ZeRO, each equal in every bit to the plain one. `serving_caption`
   (after `cli_caption`): the controller and a worker through their
   `main`s in subprocesses on `cli_caption`'s checkpoint (int8); two
   captions through the controller identical to `cli.py caption`'s.
   `train_fp32` (after `cli_train`): `cli.py train --dtype float32` at
   full width, stage 1, 512 px, batch 2, two micro-steps on the default
   attention path and one on the packed path, each with 10 fp32 flash
   launches of its layout, the checkpoint writes stubbed; the kernel at the
   micro-step's attention shape against its plain version. Every phase
   times itself with `faithdiff_tpu_torch/utils/profiling.py` (`phase`,
   `time_ms`, `trace`, `device_split`).
9d. Wide head dims and JPEG. `attention_wide_d` (after `kernel_checks`):
   the wide flash kernels (d = 192 ... 512: `csrc/flash_attention_wide.cu`
   in bf16, the fp32 kernel's wide instances) at the VAE's [1,1,1024,512],
   [1,1,1024,256], [2,4,2048,256] and packed [1,1024,512], each dtype,
   timed from CUDA graphs beside the plain version, SDPA (and the backend
   it picked) and the bound; the bf16 kernel at [1,1,16384,512] beside
   `chunked_attention` (where the gate keeps that shape); every wide head
   dim at ragged, causal and packed column-slice shapes (bf16 within 1e-2
   + 8e-3*|ref|, fp32 within 2e-5 * max|ref|, TF32 off), each kernel
   there at one split, two and its plan's count (`wide_plan`, `f32_plan`);
   each row with its plan (`splits`, `blocks`) and whether two calls give
   the same bits (`same_bits`, part of `ok`); `attention_wide_merge`: the
   split merge kernel alone at the VAE's shape against its plain version
   on the same partials, timed, with bf16 output and with fp32 (the fp32
   kernel's splits). `jpeg_decode`:
   every fixture of `tests/data/jpeg/` through the port's decoder (the
   host library built here by the host compiler), each RGB SHA-256 the
   manifest's Pillow hash; ms a megapixel of the 1024x1536 baseline and
   progressive fixtures. `native`: `native.decode_batch` over the
   fixtures equal to `decode_resize` one by one; `tile_merge_host` within
   1e-5 of `merge_tiles` on the card. `cli_restore_jpeg` (after
   `cli_restore`): the 128 x 128 JPEG fixture through `cli.py restore`: a
   256 x 256 PNG, exactly 3 launches of the d = 512 bf16 kernel (denoise
   encoder, VAE encode, VAE decode) and of its split merge, and no other
   attention kernel, the same bytes as the CLI's restore of the same
   pixels as a PNG.
   `train_fp32_wide` (after `train_fp32`): `train --dtype float32` at 256
   px, one micro-step: 2 launches of the fp32 kernel at d = 512 (VAE
   encode, denoise encoder) and of its split merge (`f32_plan` splits
   [2,1,1024,512]), a finite loss.
10. Prints the card line, a JSON line listing every ported kernel (with
   its launches per training micro-step of both stages, and on the fp8
   and Karras restores, the VQA phase, a caption training step and the
   fp32 micro-steps; the wide kernels with their launches on
   `cli_restore_jpeg` and `train_fp32_wide` and their packed row, each
   one's split merge with its launches there), then a
   last JSON line `{"ok": true, "device": {...}}`, only when every phase
   passed. Each phase prints its wall seconds (`phase <name>: <s> s`).

Imports nothing of JAX. Exits nonzero on any failure.
"""
from __future__ import annotations

import bisect
import contextlib
import functools
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
import types

ROOT = os.path.dirname(os.path.abspath(__file__))

PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core rate
PEAK_FP32_FLOPS = 67e12      # H100 SXM fp32 outside the tensor cores
# fp32-accurate products on the tensor cores: the dense TF32 rate over the
# three TF32 products (3xTF32) one fp32 product takes; the fp32 flash
# kernel's bound (GroupNorm's fp32 sums keep the CUDA-core rate)
PEAK_TF32X3_FLOPS = 495e12 / 3
PEAK_BYTES = 3.35e12         # H100 SXM HBM3 bandwidth

# (shape [B, H, S, D], causal): the UNet self-attentions at a 1024^2 tile
# (2 tiles x CFG pair = batch 4), the causal square case, the 13B LLaMA's
# causal prefill over 1024 tokens (a batch of two) and a non-causal d=128
# case at the largest K/V the JAX gate sends to its kernel (4096 x 128)
ATTN_SHAPES = [((4, 10, 4096, 64), False), ((4, 20, 1024, 64), False),
               ((1, 20, 1024, 64), True), ((2, 40, 1024, 128), True),
               ((1, 40, 4096, 128), False)]
# ([b, s, n*d], heads): the UNet self-attentions on the packed path
PACKED_SHAPES = [((4, 4096, 640), 10), ((4, 1024, 1280), 20)]
# the fp32 kernel: the UNet self-attentions at a 1024^2 tile for one tile's
# CFG pair (batch 2), the LLaMA's causal prefill shape at d = 128, and the
# packed [b, s, n*d] layout; within 2e-5 * max|ref| of the plain version in
# full fp32 (the sums' order and exp2 against exp differ)
F32_ATTN_SHAPES = [((2, 10, 4096, 64), False), ((2, 20, 1024, 64), False),
                   ((1, 40, 1024, 128), True)]
F32_PACKED = ((2, 4096, 640), 10)
F32_FLASH_TOL = 2e-5
# the wide head dims (csrc/flash_attention_wide.cu in bf16, the fp32
# kernel's wide instances): the VAE mid-attention at a 32 x 32 latent
# ([1, 1, 1024, 512], what a 256 x 256 restore runs three times), d = 256
# single- and multi-head, and the packed layout at d = 512; each timed in
# bf16 and fp32. WIDE_LONG: the 16,384-token d = 512 VAE attention of a
# 1024 px tile, which the gate keeps on chunked_attention (as JAX's),
# timed beside it for a later decision. Every wide head dim is also held
# at ragged lengths, causal and on packed column slices.
WIDE_SHAPES = [((1, 1, 1024, 512), False), ((1, 1, 1024, 256), False),
               ((2, 4, 2048, 256), False)]
WIDE_PACKED = [((1, 1024, 512), 1)]
WIDE_LONG = (1, 1, 16384, 512)
WIDE_DIMS = (192, 256, 320, 384, 448, 512)
# the committed JPEG fixtures (tests/make_jpeg_fixtures.py wrote them with
# Pillow, whose RGB SHA-256 the manifest keeps): JPEG_RESTORE is the 128 x
# 128 photo that `cli.py restore` at --upscale 2 pads to 256 x 256, one
# 32 x 32 latent tile, whose denoise encoder, VAE encode and VAE decode
# each run the d = 512 bf16 kernel once (WIDE_PER_RESTORE); JPEG_TIMED are
# timed (ms a megapixel, host clock, median of 5)
JPEG_DIR = os.path.join(ROOT, "tests", "data", "jpeg")
JPEG_RESTORE = "restore_128.jpg"
JPEG_TIMED = ("photo_1024x1536.jpg", "photo_1024x1536_progressive.jpg")
WIDE_PER_RESTORE = 3
# `train --dtype float32` at 256 px: the VAE encode and the denoise
# encoder each run the fp32 kernel at d = 512 once a micro-step
FP32_WIDE_RES, FP32_WIDE_PER_STEP = 256, 2
# native.decode_batch's output size, and tile_merge_host's canvas and tile
NATIVE_WH = (256, 192)
NATIVE_CANVAS, NATIVE_TILE = (160, 224), (128, 128)
# (shape, base2, block_k) of the variant kernel's kernels entry
VARIANT_REPORT = ((20, 4096, 64), True, 64)
# (shape NCHW, eps, act, with add): UNet ResNet / Transformer2D norms, the
# full-resolution VAE decoder norm (two-pass: its group outgrows a cluster)
# and the 15-tile restore's largest ResNet norm (B*C = 76,800 rows)
GN_SHAPES = [((4, 320, 128, 128), 1e-5, "silu", True),
             ((4, 640, 64, 64), 1e-6, None, False),
             ((4, 1280, 32, 32), 1e-5, "silu", True),
             ((1, 128, 1024, 1536), 1e-6, "silu", False),
             ((30, 2560, 32, 32), 1e-5, "silu", True)]
# the shape each kernel's JSON entry reports: the first attention shape,
# and the GroupNorm shape for which one library call (F.group_norm)
# computes the same function
ATTN_REPORT, GN_REPORT, PACKED_REPORT = 0, 1, 0

TILE_PIXELS = (1024, 1536)
# the CLI phases' photos: 512x768 at the default --upscale 2 is the
# restore's 1024x1536; 1000x1000 at --upscale 2 --use_tile_vae gives 9
# latent tiles and VAE tiles of 1024 px with a ragged edge
CLI_PIXELS, TILED_PIXELS, TILED_LATENT_TILES = (512, 768), (1000, 1000), 9
# a 1024x1536 photo at the CLI's default --upscale 2: 15 latent tiles of
# 128^2, UNet batch 30 (B*C up to 76,800 rows in its ResNet norms)
LARGE_PIXELS, LARGE_TILES = (2048, 3072), 15
STEPS = 20
# tiles per UNet call the sweep times, and the memory a chunk must leave
# free beside it: the 13B captioner's peak is 10.69 GiB (PERF.md)
SWEEP_CHUNKS = (1, 2, 4, 8, 12, 16, 24)
FREE_GIB_FOR_CAPTIONER = 40
# a 2048^2 photo at the CLI's default --upscale 2: 49 latent tiles of 128^2
FOUR_K_PIXELS, FOUR_K_TILES = (4096, 4096), 49
# the towers add each layer's output to a bf16 residual stream that
# reaches |x| ~ 27 in bigG's 31 layers with seeded weights (a bf16 step of
# 0.125 there): on an H100 an element of the prompt embeds differed from
# fp32 by 0.66, past 5e-2 * (1 + |ref|) at that element, with mean errors
# of 1.1% (prompt embeds) and 1.3% (pooled) of the mean |ref|; a wrong
# mask, activation or weight moves the mean error by tens of percent
TOWER_MEAN_TOL = 2e-2
TOWER_PROMPTS = [
    "a photo of a red house with a wooden door",
    "",
    "the cat's toys, a ball and a mouse, lie on the blue rug by the window",
    " ".join(["a tall green tree beside the old stone wall"] * 12),
]
PROMPT_CAPTION = ("The image shows a small red house with a white door. "
                  "A cat sits on the steps in the sun. The sky is blue.")

# the 13B LLaMA projections (in, out): q/k/v/o, gate/up, down; M = B at
# decode (the decode route takes up to 8, the prefill route a batch of 16)
# and B * prompt length at prefill. check_nf4 adds the caption's own
# prefill M (caption_prefill_m), whose last x tile is partial.
NF4_SHAPES = [(5120, 5120), (5120, 13824), (13824, 5120)]
NF4_M = [1, 2, 4, 8, 16, 640]
NF4_GEMV_MAX_M = 8                       # M of the decode route: nf4_gemv, above nf4_gemm
NF4_REPORT = (1, 5120, 13824)            # (M, in, out) of the kernels entry
CAPTION_IMAGES = [(768, 1024), (1024, 768)]
CAPTION_NEW_TOKENS = 512
# cli_caption's LLaMA depth: 8 of the 13B's 40 layers at full width keep
# the reference-layout files at ~6.6 GB fp16 (and as much converted)
CLI_CAPTION_LAYERS = 8
# bsrnet: a 1024x1536 image in 512 px tiles (2 x 3) -> 4096x6144; a
# 64x64 crop through the 23 RRDB blocks (345 convolutions) in bf16 on the
# card against fp32 on the CPU
BSRNET_PIXELS, BSRNET_TILES = (1024, 1536), 6
BSRNET_TOL, BSRNET_MEAN_TOL = 5e-2, 2e-2        # x max|ref|, x mean|ref|
NF4_PER_FORWARD = 7 * 40                 # projections x layers of the 13B LLaMA
PREFILL_LAYERS, PREFILL_TOKENS = 2, 1024
# the packed and the default path run the self-attentions through the same
# tile arithmetic, and on an H100 they gave the same bits (max error 0);
# one bf16 step of the largest output leaves room only for a library call
# that sums the cross-attention's products in another order
PARITY_TOL = 2 ** -8                     # x max|default path's output|
# a chunk runs the UNet's GEMMs and convolutions at another batch, for
# which cuBLAS and cuDNN pick other kernels, and cuBLAS's stream-K GEMMs
# split K by an output tile's place: other orders of bf16 sums through
# ~100 layers. On an H100 the 15-tile call against chunks of 8 differed by
# 0.047 at max|ref| 3.22 (3 bf16 steps, 0.0146 max|ref|), and so did the
# same call with its tiles in reverse order
CHUNK_TOL = 2 ** -5                      # x max|unchunked output|


@contextlib.contextmanager
def phase(name: str):
    """Times the block with `utils.profiling.phase` and prints its wall
    seconds as `phase <name>: <s> s`."""
    from faithdiff_tpu_torch.utils import profiling

    with profiling.phase(name):
        yield
    print(f"phase {name}: {profiling.phase_report()[name]['last_s']:.1f} s",
          flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def graph_ms(torch, fn, launches: int = 20, replays: int = 10) -> float:
    """Mean device time of one call of `fn`, from CUDA events around
    replays of a CUDA graph holding `launches` calls: the host's launch
    rate, which a loop of Python wrapper calls measures at a few tens of
    microseconds a call, drops out."""
    from faithdiff_tpu_torch.utils.profiling import time_ms

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    return time_ms(graph.replay, replays, warmup=1) / launches


def host_us(torch, fn, calls: int = 200) -> float:
    """Host time of one call of `fn`, in microseconds: the wall time of a
    loop of calls short enough not to fill the launch queue, over its
    length."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def flash_timing(torch, flops, nbytes, kernel, plain, library,
                 peak=PEAK_BF16_FLOPS) -> dict:
    """The timing keys of a flash row: kernel and library call from CUDA
    graphs (device time; at under ~0.2 ms a loop of wrapper calls measures
    the host), the plain version from a loop of calls, the bound at the
    `peak` rate, and the wrapper's host cost."""
    from faithdiff_tpu_torch.utils.profiling import time_ms

    b_ms, b_by = bound(flops, nbytes, peak)
    ms = graph_ms(torch, kernel)
    return dict(ms=ms, plain_ms=time_ms(plain, 3, 1),
                library_ms=graph_ms(torch, library), bound_ms=b_ms,
                bound_by=b_by, tflops=flops / ms / 1e9, ms_over_bound=ms / b_ms,
                wrapper_host_us=host_us(torch, kernel))


def entry_host_us(torch, q, k, v, scale: float, causal: bool) -> float:
    """Host time of the flash kernel's C entry point alone (four tensor-map
    encodes and the launch), without the Python wrapper around it. The
    wrapper has been called before, so the function's argtypes are set."""
    from faithdiff_tpu_torch.ops import _build
    from faithdiff_tpu_torch.ops import attention as A

    out = torch.empty_like(q)
    fn = _build.load("flash_attention").fd_flash_attention_fwd
    geometry = A._geometry_argument((
        A.bhsd_geometry(q.shape, A.GROUP_ROWS), A.bhsd_geometry(k.shape, A.BLOCK_K),
        A.bhsd_geometry(v.shape, A.BLOCK_K), A.bhsd_geometry(out.shape, A.GROUP_ROWS)))
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), geometry,
            q.shape[-1], scale * A.LOG2E, int(causal),
            torch.cuda.current_stream().cuda_stream)

    def call():
        if fn(*args):
            fail("fd_flash_attention_fwd returned an error")

    return host_us(torch, call)


def print_ptxas(source: str, log: str) -> None:
    """One line per compiled kernel from `nvcc -Xptxas -v`: its mangled
    name, registers and spills."""
    kernel, spill = "?", ""
    for line in log.splitlines():
        line = line.strip()
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif "spill" in line:
            spill = line
        elif "registers" in line:
            print(f"  ptxas {source}: {kernel}: {line.split(':', 1)[-1].strip()}; "
                  f"{spill}", flush=True)


def bound(flops: float, nbytes: float, peak_flops: float):
    """(ms, "operations" | "bytes"): the least time the card needs."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def check_attention(torch):
    import torch.nn.functional as F

    from faithdiff_tpu_torch.ops.attention import (attention_reference,
                                                   flash_attention)

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape, causal in ATTN_SHAPES:
        b, h, s, d = shape
        q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        scale = d ** -0.5
        out = flash_attention(q, k, v, scale, causal)
        torch.cuda.synchronize()
        ref = attention_reference(q, k, v, scale, causal)
        err = (out.float() - ref.float()).abs()
        # q is rounded to bf16 after the scale fold and p before p.v, at
        # other points than in the plain version: allow a few bf16 steps
        tol = 1e-2 + 8e-3 * ref.float().abs()
        ok = bool((err <= tol).all()) and bool(torch.isfinite(out).all())
        pairs = s * (s + 1) / 2 if causal else s * s
        row = dict(
            shape=list(shape), causal=causal, max_abs_err=float(err.max()),
            tol="1e-2 + 8e-3*|ref|", ok=ok,
            **flash_timing(
                torch, 4 * b * h * d * pairs, 4 * b * h * s * d * 2,
                lambda: flash_attention(q, k, v, scale, causal),
                lambda: attention_reference(q, k, v, scale, causal),
                lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal, scale=scale)),
            entry_host_us=entry_host_us(torch, q, k, v, scale, causal))
        print("attention", json.dumps(row), flush=True)
        rows.append(row)
        del q, k, v, out, ref, err, tol
        torch.cuda.empty_cache()
    return rows


def check_attention_packed(torch):
    """The packed-layout kernel against `einsum_bsnd` at the UNet's packed
    shapes; SDPA on the same data seen as [b, n, s, d] views is the
    yardstick."""
    import torch.nn.functional as F

    from faithdiff_tpu_torch.ops.attention import (einsum_bsnd,
                                                   flash_attention_packed)

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(4)
    for shape, heads in PACKED_SHAPES:
        b, s, f = shape
        d = f // heads
        q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        scale = d ** -0.5
        out = flash_attention_packed(q, k, v, heads, scale)
        torch.cuda.synchronize()
        ref = einsum_bsnd(q, k, v, heads, scale)
        err = (out.float() - ref.float()).abs()
        # as for the BHSD kernel: q and p are rounded to bf16 at other points
        tol = 1e-2 + 8e-3 * ref.float().abs()
        ok = bool((err <= tol).all()) and bool(torch.isfinite(out).all())
        qh, kh, vh = (t.view(b, s, heads, d).transpose(1, 2) for t in (q, k, v))
        row = dict(
            shape=list(shape), heads=heads, max_abs_err=float(err.max()),
            tol="1e-2 + 8e-3*|ref|", ok=ok,
            **flash_timing(
                torch, 4 * b * heads * d * s * s, 4 * b * s * f * 2,
                lambda: flash_attention_packed(q, k, v, heads, scale),
                lambda: einsum_bsnd(q, k, v, heads, scale),
                lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale)))
        print("attention_packed", json.dumps(row), flush=True)
        rows.append(row)
        del q, k, v, qh, kh, vh, out, ref, err, tol
        torch.cuda.empty_cache()
    return rows


@contextlib.contextmanager
def tf32_off(torch):
    """fp32 products and convolutions in full fp32 within the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def f32_flash_row(torch, label, q, k, v, scale, causal=False, heads=None,
                  timed=True) -> dict:
    """The fp32 kernel (`flash_attention`, or `flash_attention_packed` with
    `heads`) against its plain version on q, k, v, TF32 off: within
    F32_FLASH_TOL * max|ref|, finite, the same bits on a second call; with
    `timed`, ms, plain ms, SDPA's ms in fp32 (the yardstick) and its own
    largest error against the plain version, and the bound at the 3xTF32
    rate."""
    import torch.nn.functional as F

    from faithdiff_tpu_torch.ops.attention import (attention_reference, einsum_bsnd,
                                                   flash_attention,
                                                   flash_attention_packed)

    if heads is None:
        b, h, s, d = q.shape
        kernel = lambda: flash_attention(q, k, v, scale, causal)  # noqa: E731
        plain = lambda: attention_reference(q, k, v, scale, causal)  # noqa: E731
        views = (q, k, v)
    else:
        (b, s, f), h = q.shape, heads
        d = f // h
        kernel = lambda: flash_attention_packed(q, k, v, h, scale)  # noqa: E731
        plain = lambda: einsum_bsnd(q, k, v, h, scale)  # noqa: E731
        views = tuple(t.view(b, -1, h, d).transpose(1, 2) for t in (q, k, v))
    library = lambda: F.scaled_dot_product_attention(  # noqa: E731
        *views, is_causal=causal, scale=scale)
    with tf32_off(torch):
        out = kernel()
        same = bool(torch.equal(out, kernel()))
        torch.cuda.synchronize()
        ref = plain()
        err = float((out - ref).abs().max())
        tol = F32_FLASH_TOL * float(ref.abs().max())
        row = dict(shape=list(q.shape), heads=h, causal=causal, max_abs_err=err,
                   tol=f"{F32_FLASH_TOL} * max|ref| = {tol:.3g}", same_bits=same,
                   ok=err <= tol and same and bool(torch.isfinite(out).all()))
        if timed:
            lib_out = library()
            if heads is not None:
                lib_out = lib_out.transpose(1, 2).reshape(ref.shape)
            pairs = s * (s + 1) / 2 if causal else s * s
            row.update(flash_timing(
                torch, 4 * b * h * d * pairs, 4 * b * h * s * d * 4, kernel, plain,
                library, peak=PEAK_TF32X3_FLOPS),
                library_max_abs_err=float((lib_out - ref).abs().max()))
    print(label, json.dumps(row), flush=True)
    return row


def check_attention_f32(torch):
    """The fp32 flash kernel (`csrc/flash_attention_f32.cu`) at the UNet's
    self-attention shapes (batch 2), the LLaMA's causal d = 128 one and the
    packed layout, TF32 off (see `f32_flash_row`)."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    rows = []
    for shape, causal in F32_ATTN_SHAPES:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda") for _ in range(3))
        rows.append(f32_flash_row(torch, "attention_f32", q, k, v,
                                  shape[-1] ** -0.5, causal))
        del q, k, v
    shape, heads = F32_PACKED
    q, k, v = (torch.randn(shape, generator=gen, device="cuda") for _ in range(3))
    rows.append(f32_flash_row(torch, "attention_f32_packed", q, k, v,
                              (shape[-1] // heads) ** -0.5, heads=heads))
    del q, k, v
    torch.cuda.empty_cache()
    return rows


def sdpa_backend(torch, fn) -> str:
    """The backend SDPA picked for `fn` (one call): the ATen op it ran."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages()}
    for op, backend in (("_scaled_dot_product_flash_attention", "flash"),
                        ("_scaled_dot_product_cudnn_attention", "cudnn"),
                        ("_scaled_dot_product_efficient_attention", "efficient"),
                        ("_scaled_dot_product_attention_math", "math")):
        if any(op in n for n in names):
            return backend
    return "unknown"


def check_attention_wide(torch):
    """The wide head-dim kernels (d = 192 ... 512): the bf16 one
    (`csrc/flash_attention_wide.cu`, within 1e-2 + 8e-3 * |ref| of the
    plain version, as the d = 64 / 128 kernels) and the fp32 one's wide
    instances (TF32 off, within F32_FLASH_TOL * max|ref|), timed at
    WIDE_SHAPES / WIDE_PACKED with SDPA's time and backend beside them; the
    bf16 kernel at WIDE_LONG beside chunked_attention; then every wide
    head dim at ragged lengths, causal, and on packed column slices."""
    import torch.nn.functional as F

    from faithdiff_tpu_torch.ops import attention as A
    from faithdiff_tpu_torch.ops.attention import (attention_reference,
                                                   chunked_attention, einsum_bsnd,
                                                   flash_attention,
                                                   flash_attention_packed)

    gen = torch.Generator(device="cuda").manual_seed(17)
    rows = []

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def hold(out, ref, dtype, **keys):
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs()
        if dtype == torch.float32:
            tol = F32_FLASH_TOL * float(ref.abs().max())
            ok, tol_s = float(err.max()) <= tol, f"{F32_FLASH_TOL} * max|ref| = {tol:.3g}"
        else:
            ok = bool((err <= 1e-2 + 8e-3 * ref.float().abs()).all())
            tol_s = "1e-2 + 8e-3*|ref|"
        row = dict(keys, dtype=str(dtype).split(".")[-1], max_abs_err=float(err.max()),
                   tol=tol_s, ok=ok and bool(torch.isfinite(out).all()))
        rows.append(row)
        return row

    def repeat(row, kernel, shape, dtype):
        """The kernel's split plan at `shape` (b, h, q_len, kv_len, d,
        causal) on the row, and whether two calls give the same bits (part
        of `ok`)."""
        plan = (A.wide_plan if dtype == torch.bfloat16 else A.f32_plan)(
            *shape, sms=A._sm_count(torch.device("cuda")))
        same = bool(torch.equal(kernel(), kernel()))
        row.update(splits=plan.splits, blocks=plan.blocks, same_bits=same,
                   ok=row["ok"] and same)

    with tf32_off(torch):
        for dtype, peak, esize in ((torch.bfloat16, PEAK_BF16_FLOPS, 2),
                                   (torch.float32, PEAK_TF32X3_FLOPS, 4)):
            for shape, causal in WIDE_SHAPES:
                b, h, s, d = shape
                q, k, v = (randn(shape, dtype) for _ in range(3))
                scale = d ** -0.5
                kernel = lambda: flash_attention(q, k, v, scale, causal)  # noqa: E731
                library = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    q, k, v, is_causal=causal, scale=scale)
                row = hold(kernel(),
                           attention_reference(q, k, v, scale, causal), dtype,
                           shape=list(shape), causal=causal)
                row.update(flash_timing(
                    torch, 4 * b * h * d * s * s, 4 * b * h * s * d * esize, kernel,
                    lambda: attention_reference(q, k, v, scale, causal), library,
                    peak=peak), sdpa_backend=sdpa_backend(torch, library))
                if dtype == torch.float32:
                    row["library_max_abs_err"] = float(
                        (library() - attention_reference(q, k, v, scale, causal))
                        .abs().max())
                repeat(row, kernel, (b, h, s, s, d, causal), dtype)
                print("attention_wide", json.dumps(row), flush=True)
                del q, k, v
            for shape, heads in WIDE_PACKED:
                b, s, f = shape
                d = f // heads
                q, k, v = (randn(shape, dtype) for _ in range(3))
                scale = d ** -0.5
                views = tuple(t.view(b, s, heads, d).transpose(1, 2) for t in (q, k, v))
                kernel = lambda: flash_attention_packed(q, k, v, heads, scale)  # noqa: E731
                library = lambda: F.scaled_dot_product_attention(*views, scale=scale)  # noqa: E731
                row = hold(kernel(),
                           einsum_bsnd(q, k, v, heads, scale), dtype,
                           shape=list(shape), heads=heads)
                row.update(flash_timing(
                    torch, 4 * b * heads * d * s * s, 4 * b * s * f * esize, kernel,
                    lambda: einsum_bsnd(q, k, v, heads, scale), library, peak=peak),
                    sdpa_backend=sdpa_backend(torch, library))
                if dtype == torch.float32:
                    row["library_max_abs_err"] = float(
                        (library().transpose(1, 2).reshape(b, s, f)
                         - einsum_bsnd(q, k, v, heads, scale)).abs().max())
                repeat(row, kernel, (b, heads, s, s, d, False), dtype)
                print("attention_wide_packed", json.dumps(row), flush=True)
                del q, k, v, views
        # the 1024 px tile's VAE attention: the kernel beside the path's
        # chunked_attention (its plain version here)
        b, h, s, d = WIDE_LONG
        q, k, v = (randn(WIDE_LONG, torch.bfloat16) for _ in range(3))
        scale = d ** -0.5
        kernel = lambda: flash_attention(q, k, v, scale)  # noqa: E731
        library = lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)  # noqa: E731
        row = hold(kernel(), chunked_attention(q, k, v, scale),
                   torch.bfloat16, shape=list(WIDE_LONG), causal=False,
                   plain="chunked_attention")
        row.update(flash_timing(torch, 4 * b * h * d * s * s, 4 * b * h * s * d * 2,
                                kernel, lambda: chunked_attention(q, k, v, scale),
                                library), sdpa_backend=sdpa_backend(torch, library))
        repeat(row, kernel, (b, h, s, s, d, False), torch.bfloat16)
        print("attention_wide_long", json.dumps(row), flush=True)
        del q, k, v
        torch.cuda.empty_cache()
        # every instance, both dtypes: ragged non-causal, causal with a
        # partial last tile, and packed column slices of fused projections
        # (each kernel at one split, at two and at its plan's count, each
        # twice: the same bits)
        for dtype in (torch.bfloat16, torch.float32):
            plan_name = "wide_plan" if dtype == torch.bfloat16 else "f32_plan"
            planned = getattr(A, plan_name)
            # the fp32 kernel also at d = 64 and 128, where it splits the same way
            for d in WIDE_DIMS if dtype == torch.bfloat16 else (64, 128) + WIDE_DIMS:
                scale = d ** -0.5
                splits = (1, 2, None)
                for (b, h, sq, skv), causal in (((2, 2, 1000, 1100), False),
                                                ((1, 2, 1030, 1030), True)):
                    q = randn((b, h, sq, d), dtype)
                    k, v = randn((b, h, skv, d), dtype), randn((b, h, skv, d), dtype)
                    ref = attention_reference(q, k, v, scale, causal)
                    for n in splits:
                        setattr(A, plan_name, functools.partial(planned, splits=n))
                        try:
                            out = flash_attention(q, k, v, scale, causal)
                            same = bool(torch.equal(out, flash_attention(q, k, v, scale,
                                                                         causal)))
                            plan = getattr(A, plan_name)(b, h, sq, skv, d, causal)
                        finally:
                            setattr(A, plan_name, planned)
                        row = hold(out, ref, dtype,
                                   case=f"bhsd {[b, h, sq, skv, d]} causal={causal}")
                        row.update(splits=plan.splits, same_bits=same,
                                   ok=row["ok"] and same)
                        print("attention_wide_ragged", json.dumps(row), flush=True)
                heads, f = 2, 2 * d
                q = randn((2, 1030, 3 * f), dtype)[..., f:2 * f]
                k, v = randn((2, 1100, 2 * f), dtype).split(f, dim=-1)
                ref = einsum_bsnd(q.contiguous(), k.contiguous(), v.contiguous(), heads,
                                  scale)
                for n in splits:
                    setattr(A, plan_name, functools.partial(planned, splits=n))
                    try:
                        out = flash_attention_packed(q, k, v, heads, scale)
                        same = bool(torch.equal(out, flash_attention_packed(
                            q, k, v, heads, scale)))
                        plan = getattr(A, plan_name)(2, heads, 1030, 1100, d)
                    finally:
                        setattr(A, plan_name, planned)
                    row = hold(out, ref, dtype, case=f"packed column slices "
                               f"{[2, 1030, 1100, f]} heads={heads}")
                    row.update(splits=plan.splits, same_bits=same, ok=row["ok"] and same)
                    print("attention_wide_ragged", json.dumps(row), flush=True)
        del q, k, v
        torch.cuda.empty_cache()
    return rows


def check_wide_merge(torch, dtype=None) -> dict:
    """A split kernel's merge (`flash_wide_merge_kernel`) alone at the VAE's
    shape (WIDE_SHAPES[0]) under its plan: bf16 (the wide bf16 kernel's
    partials and merge, within one bf16 rounding, 4e-3 * |ref| + 1e-5) or
    fp32 (`dtype`: the fp32 kernel's partials and its fp32-output merge,
    within 1e-6 * max|ref|: the splits summed in another order); the
    partials from the kernel's own split launch, merged by the merge
    kernel and by its plain version (`merge_wide_partials`) on the same
    partials; the merge timed from CUDA graphs. Its bound counts only what
    must cross HBM, o written once: the split kernel writes the fp32
    partials (16.8 MB here) just before, and they are read back from the
    50 MB L2, and no L2 rate enters the bound; its operations are one fp32
    FMA a partial element, at the CUDA-core rate."""
    from faithdiff_tpu_torch.ops import attention as A
    from faithdiff_tpu_torch.utils.profiling import time_ms

    dtype = dtype or torch.bfloat16
    f32 = dtype == torch.float32
    source = "flash_attention_f32" if f32 else "flash_attention_wide"
    b, h, s, d = WIDE_SHAPES[0][0]
    gen = torch.Generator(device="cuda").manual_seed(19)
    q, k, v = (torch.randn((b, h, s, d), generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    out = torch.empty_like(q)
    strides = [x for t in (q, k, v, out) for x in t.stride()[:3]]
    plan = (A.f32_plan if f32 else A.wide_plan)(b, h, s, s, d, sms=A._sm_count(q.device))
    part_o, part_ml = A._wide_fwd_launch(q, k, v, out, strides, (b, h, s, s, d),
                                         d ** -0.5, False, plan, source=source)
    merge = lambda: A._wide_merge_launch(part_o, part_ml, out, strides[9:12], h, s,  # noqa: E731
                                         source=source)
    plain = lambda: A.merge_wide_partials(part_o, part_ml)[:, :s]  # noqa: E731
    merge()
    torch.cuda.synchronize()
    ref = plain().reshape(out.shape)
    err = (out.float() - ref).abs()
    if f32:
        tol = "1e-6 * max|ref|"
        ok = float(err.max()) <= 1e-6 * float(ref.abs().max())
    else:
        tol = "4e-3*|ref| + 1e-5"
        ok = bool((err <= 4e-3 * ref.abs() + 1e-5).all())
    b_ms, b_by = bound(2 * part_o[:, :, :s].numel(), out.numel() * out.element_size(),
                       PEAK_FP32_FLOPS)
    ms = graph_ms(torch, merge)
    row = dict(check="wide_merge", dtype=str(dtype).split(".")[-1], shape=[b, h, s, d],
               splits=plan.splits, max_abs_err=float(err.max()), tol=tol,
               ok=ok and bool(torch.isfinite(out).all()), ms=ms,
               plain_ms=time_ms(plain, 3, 1), library_ms=None, bound_ms=b_ms,
               bound_by=b_by, ms_over_bound=ms / b_ms,
               partial_bytes=part_o.numel() * 4 + part_ml.numel() * 4)
    print("attention_wide_merge", json.dumps(row), flush=True)
    del q, k, v, out, part_o, part_ml
    torch.cuda.empty_cache()
    return row


def check_attention_ragged(torch):
    """Correctness only: the flash kernels where tiles are partial. q and
    kv lengths that are no multiple of the 128-row block or the 128-row
    K/V tile, non-causal and causal, at both head dims; 70,000 planes of a
    few rows; packed operands that are column slices of fused projections,
    with a 77-row K/V; q shorter than one 64-row group; and the BHSD kernel
    against the plain walk of its own tile schedule
    (`flash_attention_tiled`)."""
    from faithdiff_tpu_torch.ops.attention import (attention_reference,
                                                   einsum_bsnd,
                                                   flash_attention,
                                                   flash_attention_packed,
                                                   flash_attention_tiled)

    gen = torch.Generator(device="cuda").manual_seed(7)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    rows = []

    def hold(what, out, ref):
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs()
        # as for the full tiles: q and p are rounded to bf16 at other points
        ok = (bool((err <= 1e-2 + 8e-3 * ref.float().abs()).all())
              and bool(torch.isfinite(out).all()))
        row = dict(case=what, max_abs_err=float(err.max()),
                   tol="1e-2 + 8e-3*|ref|", ok=ok)
        print("attention_ragged", json.dumps(row), flush=True)
        rows.append(row)

    # more planes than a grid's y extent holds: work items are dealt from
    # one linear index
    q, k, v = randn(1, 70000, 8, 64), randn(1, 70000, 16, 64), randn(1, 70000, 16, 64)
    hold("bhsd [1, 70000, 8, 16, 64] causal=False",
         flash_attention(q, k, v, 0.125), attention_reference(q, k, v, 0.125))
    for d in (64, 128):
        scale = d ** -0.5
        for (b, h, sq, skv), causal in (((2, 3, 1000, 1100), False),
                                        ((1, 3, 1030, 1030), True)):
            q, k, v = randn(b, h, sq, d), randn(b, h, skv, d), randn(b, h, skv, d)
            out = flash_attention(q, k, v, scale, causal)
            hold(f"bhsd {[b, h, sq, skv, d]} causal={causal}", out,
                 attention_reference(q, k, v, scale, causal))
            if causal:
                hold(f"bhsd {[b, h, sq, skv, d]} causal against its tile walk",
                     out, flash_attention_tiled(q, k, v, scale, True))
        # q a column slice of a fused [b, s, 3f] projection, k and v of a
        # [b, 77, 2f] one; then q shorter than one group of rows
        heads = 2
        f = heads * d
        for sq, skv in ((1030, 77), (50, 1100)):
            q = randn(2, sq, 3 * f)[..., f:2 * f]
            k, v = randn(2, skv, 2 * f).split(f, dim=-1)
            out = flash_attention_packed(q, k, v, heads, scale)
            if not out.is_contiguous():
                fail("packed output is not contiguous")
            hold(f"packed column slices {[2, sq, skv, f]} heads={heads}", out,
                 einsum_bsnd(q.contiguous(), k.contiguous(), v.contiguous(),
                             heads, scale))
    return rows


def check_attention_variants(torch):
    """Every instantiated variant against `attention_variant_reference` at
    every shape of the benchmark; SDPA on the same data is the yardstick."""
    import torch.nn.functional as F

    from faithdiff_tpu_torch.ops.attention_variants import (
        VARIANTS, attention_variant, attention_variant_reference)
    from faithdiff_tpu_torch.scripts.bench_attention_variants import SHAPES

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(5)
    for bh, s, d in SHAPES:
        q, k, v = (torch.randn((bh, s, d), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        scale = d ** -0.5
        for base2, bk in VARIANTS:
            out = attention_variant(q, k, v, scale, base2, bk)
            torch.cuda.synchronize()
            ref = attention_variant_reference(q, k, v, scale, base2)
            err = (out.float() - ref.float()).abs()
            # online against one-pass softmax: p is rounded to bf16 against
            # another running max
            tol = 1e-2 + 8e-3 * ref.float().abs()
            ok = bool((err <= tol).all()) and bool(torch.isfinite(out).all())
            row = dict(
                shape=[bh, s, d], base2=base2, block_k=bk,
                max_abs_err=float(err.max()), tol="1e-2 + 8e-3*|ref|", ok=ok,
                **flash_timing(
                    torch, 4 * bh * d * s * s, 4 * bh * s * d * 2,
                    lambda: attention_variant(q, k, v, scale, base2, bk),
                    lambda: attention_variant_reference(q, k, v, scale, base2),
                    lambda: F.scaled_dot_product_attention(
                        q[None], k[None], v[None], scale=scale)))
            print("attention_variant", json.dumps(row), flush=True)
            rows.append(row)
            del out, ref, err, tol
        del q, k, v
        torch.cuda.empty_cache()
    return rows


def implied_stats(torch, x, y, groups, add=None):
    """Per-group mean and E[v^2] (float64) that an output y = (v - mean) *
    rstd (scale 1, bias 0, no act) implies, v = x + add: rstd by least
    squares of y on v. The single-pass kernel keeps its sums on chip; this
    is how its statistics are read."""
    b, c = x.shape[:2]
    v = x.double().reshape(b, c, -1)
    if add is not None:
        v = v + add.double().reshape(b, c, 1)
    v, y = v.reshape(b, groups, -1), y.double().reshape(b, groups, -1)
    vc, yc = v - v.mean(-1, keepdim=True), y - y.mean(-1, keepdim=True)
    rstd = (vc * yc).sum(-1) / vc.square().sum(-1)
    return v.mean(-1) - y.mean(-1) / rstd, v.square().mean(-1)


def check_group_norm(torch):
    """Both routes at every GN_SHAPES shape, bf16: the single-pass kernel
    where the plan has one (output against the plain version and the tile
    walk, statistics from an fp32 run), and the two-pass pair (partials
    against the plain statistics, output against the plain version). Every
    time from CUDA graphs; the wrapper's host cost from a loop of calls."""
    from faithdiff_tpu_torch.utils.profiling import time_ms

    import torch.nn.functional as F

    from faithdiff_tpu_torch.ops.groupnorm import (GroupNormLaunch,
                                                   group_apply_reference,
                                                   group_norm,
                                                   group_norm_reference,
                                                   group_norm_tiled,
                                                   group_stats_reference)

    fused_rows, stats_rows, apply_rows = [], [], []
    gen = torch.Generator(device="cuda").manual_seed(1)
    groups = 32
    for shape, eps, act, with_add in GN_SHAPES:
        b, c = shape[:2]
        x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        scale = 1 + 0.1 * torch.randn(c, generator=gen, device="cuda")
        bias = 0.1 * torch.randn(c, generator=gen, device="cuda")
        add = (torch.randn((b, c), generator=gen, device="cuda")
               if with_add else None)
        n = x[0, 0].numel() * (c // groups)
        gs1, gs2 = group_stats_reference(x, groups, add)
        ref = group_norm_reference(x, scale, bias, groups, eps, act, add)
        numel, esize = x.numel(), x.element_size()
        add_bytes = 0 if add is None else add.numel() * 4
        flops = numel * (5 + (4 if act == "silu" else 0))
        # the function's floor: x read once, y written once
        fn_ms, fn_by = bound(flops, 2 * numel * esize + add_bytes,
                             PEAK_FP32_FLOPS)
        lib_ms = None
        if add is None and act is None:
            lib_ms = graph_ms(torch, lambda: F.group_norm(
                x, groups, scale.to(x.dtype), bias.to(x.dtype), eps))
        common = dict(shape=list(shape), eps=eps, act=act, add=with_add)

        def hold(y):
            err = (y.float() - ref.float()).abs()
            # one bf16 rounding step of the output, plus fp32 noise
            ok = (bool((err <= 1e-2 + 8e-3 * ref.float().abs()).all())
                  and bool(torch.isfinite(y).all()))
            return float(err.max()), ok

        launch = GroupNormLaunch(x, scale, bias, groups, eps, act, add)
        plan = launch.plan
        if plan.cluster:
            y = launch.fused()
            torch.cuda.synchronize()
            err, ok = hold(y)
            again = launch.fused().clone()
            same = bool(torch.equal(again, launch.fused()))
            tiled = group_norm_tiled(x, scale, bias, groups, eps, act, add,
                                     route="fused")
            t_err = (y.float() - tiled.float()).abs()
            tiled_err = float(t_err.max())
            # the walk sums in another order: a bf16 step of the output
            tiled_ok = bool((t_err <= 1e-2 + 8e-3 * tiled.float().abs()).all())
            x32 = x.float()
            y32 = GroupNormLaunch(x32, torch.ones_like(scale),
                                  torch.zeros_like(bias), groups, eps, None,
                                  add).fused()
            mean, m2 = implied_stats(torch, x32, y32, groups, add)
            s_err = float(torch.maximum((mean - gs1.double() / n).abs(),
                                        (m2 - gs2.double() / n).abs()).max())
            ms = graph_ms(torch, launch.fused)
            row = dict(common, route="fused", cluster=plan.cluster,
                       slice_kib=plan.slice_len * esize / 1024,
                       blocks=plan.fused_grid, max_abs_err=err,
                       tol="1e-2 + 8e-3*|ref|", stats_err=s_err,
                       stats_tol="1e-4", tiled_err=tiled_err, same_bits=same,
                       ok=ok and same and s_err <= 1e-4 and tiled_ok,
                       ms=ms, plain_ms=time_ms(lambda: group_norm_reference(
                           x, scale, bias, groups, eps, act, add), 3, 1),
                       library_ms=lib_ms, bound_ms=fn_ms, bound_by=fn_by,
                       ms_over_bound=ms / fn_ms,
                       host_us=host_us(torch, lambda: group_norm(
                           x, scale, bias, groups, eps, act, add)))
            print("group_norm_fused", json.dumps(row), flush=True)
            fused_rows.append(row)
            del y, y32, x32, tiled, t_err, again
        # the two-pass pair, through the launch's own methods
        partial = launch.stats()
        y = launch.apply()
        torch.cuda.synchronize()
        folded = partial.double().sum(dim=1).reshape(b, groups, 2)
        # pass 1: mean and E[x^2] per group, fp32 sums in another order
        s_err = torch.maximum((folded[..., 0] / n - gs1.double() / n).abs(),
                              (folded[..., 1] / n - gs2.double() / n).abs())
        err, a_ok = hold(y)
        same = bool(torch.equal(y.clone(), launch.two_pass()))
        pair_ms = graph_ms(torch, launch.two_pass)
        st_ms, st_by = bound(numel * 4, numel * esize + add_bytes,
                             PEAK_FP32_FLOPS)
        ap_ms, ap_by = bound(numel * (3 + (4 if act == "silu" else 0)),
                             2 * numel * esize + add_bytes, PEAK_FP32_FLOPS)
        two = dict(route="two_pass", pair_ms=pair_ms,
                   pair_over_bound=pair_ms / fn_ms, function_bound_ms=fn_ms,
                   host_us=(None if plan.route == "fused" else host_us(
                       torch, lambda: group_norm(x, scale, bias, groups, eps,
                                                 act, add))))
        srow = dict(common, **two, max_abs_err=float(s_err.max()), tol="1e-4",
                    ok=bool((s_err <= 1e-4).all()),
                    ms=graph_ms(torch, launch.stats),
                    plain_ms=time_ms(lambda: group_stats_reference(
                        x, groups, add), 3, 1),
                    library_ms=None, bound_ms=st_ms, bound_by=st_by)
        arow = dict(common, **two, max_abs_err=err, tol="1e-2 + 8e-3*|ref|",
                    same_bits=same, ok=a_ok and same,
                    ms=graph_ms(torch, launch.apply),
                    plain_ms=time_ms(lambda: group_apply_reference(
                        x, gs1, gs2, scale, bias, groups, eps, act, add), 3, 1),
                    library_ms=lib_ms, bound_ms=ap_ms, bound_by=ap_by)
        print("group_norm_stats", json.dumps(srow), flush=True)
        print("group_norm_apply", json.dumps(arow), flush=True)
        stats_rows.append(srow)
        apply_rows.append(arow)
        del x, y, ref, launch, partial
        torch.cuda.empty_cache()
    return fused_rows, stats_rows, apply_rows


def count_modules(module, cls) -> int:
    return sum(isinstance(m, cls) for m in module.modules())


@contextlib.contextmanager
def attention_path(packed: bool):
    """Within the block, the UNet's Attention modules take the packed path
    (`transformer2d._BSND_ATTN`, which FAITHDIFF_BSND_ATTN=1 sets at
    import) when `packed`, the default path otherwise."""
    from faithdiff_tpu_torch.models import transformer2d

    before = transformer2d._BSND_ATTN
    transformer2d._BSND_ATTN = packed
    try:
        yield
    finally:
        transformer2d._BSND_ATTN = before


def unet_counts(pipe):
    """(GroupNorms, self-attentions) of the full-width UNet, checked: every
    self-attention (attn1) runs at >= 1024 tokens at a 128^2 latent tile
    and so goes to a flash kernel."""
    from faithdiff_tpu_torch.models.layers import GroupNorm
    from faithdiff_tpu_torch.models.transformer2d import BasicTransformerBlock

    gn_unet = count_modules(pipe.unet, GroupNorm)
    attn_unet = count_modules(pipe.unet, BasicTransformerBlock)
    if (gn_unet, attn_unet) != (47, 70):
        fail(f"UNet has {gn_unet} GroupNorms and {attn_unet} self-attentions, "
             "expected 47 and 70")
    return gn_unet, attn_unet


class PathWatch:
    """Forward hooks on a pipeline's models for one run of its path: CUDA
    events around each UNet call, each call's batch, the first and the
    last call's (args, kwargs), the (model, shape, itemsize, groups,
    aligned) of every GroupNorm call, from which the launch plan predicts
    the GroupNorm kernels' launches, and the (batch, tokens, channels) of every
    VAE mid-attention call (VAE and denoise encoder), from which the flash
    gate predicts the d = 512 kernel's."""

    def __init__(self, torch, pipe):
        from faithdiff_tpu_torch.models.layers import GroupNorm
        from faithdiff_tpu_torch.models.unet_blocks import VaeAttention

        self.events, self.last_call, self.gn_seen = [], [], []
        self.first_call, self.batches, self.vae_attention = [], [], []

        def record(*_):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append(ev)

        def pre_hook(module, args, kwargs):
            self.last_call[:] = [args, kwargs]
            if not self.first_call:
                self.first_call[:] = [args, kwargs]
            self.batches.append(args[0].shape[0])
            record()

        def gn_hook(model):
            def hook(module, args):
                x = args[0]
                self.gn_seen.append((model, tuple(x.shape), x.element_size(),
                                     module.num_groups, x.data_ptr() % 16 == 0))
            return hook

        self.hooks = [pipe.unet.register_forward_pre_hook(pre_hook, with_kwargs=True),
                      pipe.unet.register_forward_hook(record)]
        self.hooks += [m.register_forward_pre_hook(gn_hook(name))
                       for name in ("unet", "vae", "denoise_encoder")
                       for m in getattr(pipe, name).modules()
                       if isinstance(m, GroupNorm)]

        def attention_hook(module, args):
            b, c, h, w = args[0].shape
            self.vae_attention.append((b, h * w, c))

        self.hooks += [m.register_forward_pre_hook(attention_hook)
                       for name in ("vae", "denoise_encoder")
                       for m in getattr(pipe, name).modules()
                       if isinstance(m, VaeAttention)]

    def remove(self):
        for h in self.hooks:
            h.remove()

    def wide_launches(self) -> int:
        """Launches of the d = 512 kernel the VAE mid-attention calls seen
        should make: those the flash gate admits (1024 tokens, a 32 x 32
        latent or tile; the gate is JAX's there, tests/test_torch_flash_wide)."""
        from faithdiff_tpu_torch.ops.attention import _flash_gate

        return sum(_flash_gate(n, n, c) for _, n, c in self.vae_attention)

    def wide_merges(self) -> int:
        """Launches of the bf16 wide kernel's merge: those d = 512 launches
        whose shape `wide_plan` splits."""
        import torch

        from faithdiff_tpu_torch.ops.attention import _flash_gate, _sm_count, wide_plan

        sms = _sm_count(torch.device("cuda"))
        return sum(_flash_gate(n, n, c) and wide_plan(b, 1, n, n, c, sms=sms).splits > 1
                   for b, n, c in self.vae_attention)

    def unet_ms(self):
        return [a.elapsed_time(b) for a, b in zip(self.events[::2], self.events[1::2])]

    def expected_launches(self, label, flash, gn_unet, attn_unet):
        """{kernel counter: launches} the run should show: `flash` once per
        self-attention of each UNet call, each GroupNorm's kernels as
        `plan_group_norm` plans them; fails unless every UNet GroupNorm was
        one single-pass launch."""
        from faithdiff_tpu_torch.ops.groupnorm import plan_group_norm

        calls = len(self.events) // 2
        expected = {flash: calls * attn_unet}
        if self.wide_launches():
            expected["flash_attention_wide_fwd"] = self.wide_launches()
        if self.wide_merges():
            expected["flash_attention_wide_merge"] = self.wide_merges()
        unet_routes = []
        for model, shape, itemsize, groups, aligned in self.gn_seen:
            plan = plan_group_norm(shape, itemsize, groups, aligned)
            for name in plan.counters:
                expected[name] = expected.get(name, 0) + 1
            if model == "unet":
                unet_routes.append(plan.route)
        if unet_routes != ["fused"] * (calls * gn_unet):
            fail(f"{label}: not every UNet GroupNorm is one single-pass launch: "
                 f"{len(unet_routes)} calls, {unet_routes.count('fused')} fused")
        return expected


def build_restore(torch):
    """build_pipeline() at full width."""
    from faithdiff_tpu_torch.pipelines import build_pipeline

    t0 = time.perf_counter()
    pipe = build_pipeline(device="cuda", dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for m in (pipe.unet, pipe.vae, pipe.denoise_encoder)
                   for p in m.parameters())
    print(f"restore: built pipeline in {build_s:.1f} s, {n_params / 1e9:.3f} B params",
          flush=True)
    return pipe


def run_restore(torch, pipe, packed: bool, pixels=TILE_PIXELS,
                label: str = ""):
    """The main path: one restore of a `pixels` uint8 image, on the default
    attention path or on the packed one. Checks the output, the UNet calls
    and that every kernel ran as often as expected: the flash kernel once
    per self-attention a UNet call, and each GroupNorm's kernels as the
    launch plan predicts from the shape the module saw. Returns the launch
    counts, the last and the first UNet call's (args, kwargs)."""
    import numpy as np

    from faithdiff_tpu_torch.ops import _build

    label = label or ("restore_packed" if packed else "restore")
    gn_unet, attn_unet = unet_counts(pipe)
    watch = PathWatch(torch, pipe)
    img = np.random.default_rng(0).integers(
        0, 256, tuple(pixels) + (3,), dtype=np.uint8)
    prompt = torch.zeros((1, 77, 2048))
    pooled = torch.zeros((1, 1280))

    with attention_path(packed):
        _build.launches.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        latents = pipe(img, prompt, pooled, seed=0, output_type="latent")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = pipe.decode(latents, img, output_type="uint8")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        counts = dict(_build.launches)
    watch.remove()
    unet_ms = watch.unet_ms()

    lh, lw = pixels[0] // 8, pixels[1] // 8
    if tuple(latents.shape) != (1, lh, lw, 4):
        fail(f"{label}: latents shape {tuple(latents.shape)}")
    if not bool(torch.isfinite(latents).all()):
        fail(f"{label}: latents are not finite")
    if not (isinstance(out, np.ndarray) and out.dtype == np.uint8
            and out.shape == tuple(pixels) + (3,)):
        fail(f"{label}: output {type(out)} {getattr(out, 'shape', None)}")
    if len(unet_ms) != STEPS:
        fail(f"{label}: {len(unet_ms)} UNet calls, expected {STEPS}")
    unet_batch = watch.last_call[0][0].shape[0]
    flash = "flash_attention_bsnd_fwd" if packed else "flash_attention_fwd"
    expected = watch.expected_launches(label, flash, gn_unet, attn_unet)
    if counts != expected:
        fail(f"{label}: launch counts {counts}, expected {expected}")
    med = sorted(unet_ms)[STEPS // 2]
    result = dict(
        wall_s=t2 - t0, denoise_call_s=t1 - t0, decode_s=t2 - t1,
        unet_ms_per_step=sum(unet_ms) / len(unet_ms),
        unet_ms_first=unet_ms[0], unet_ms_min=min(unet_ms),
        unet_ms_median=med, peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        steps=STEPS, tiles=unet_batch // 2, unet_batch=unet_batch,
        pixels=list(pixels), launches=counts, launches_as_planned=True,
        out_mean=float(out.mean()))
    print(label, json.dumps(result), flush=True)
    return counts, watch.last_call, watch.first_call


def check_path_parity(torch, unet, args, kwargs):
    """One UNet call on the packed path against the same call on the
    default path, same inputs."""
    with torch.no_grad():
        with attention_path(False):
            ref = unet(*args, **kwargs).float()
        with attention_path(True):
            got = unet(*args, **kwargs).float()
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    result = dict(max_abs_err=err, max_abs_ref=scale,
                  mean_abs_err=float((got - ref).abs().mean()),
                  tol=f"{PARITY_TOL} * max|ref|",
                  ok=bool(torch.isfinite(got).all()) and err <= PARITY_TOL * scale)
    print("path_parity", json.dumps(result), flush=True)
    if not result["ok"]:
        fail(f"packed and default UNet calls disagree: {result}")


def write_reference_weights(torch, pipe, root: str) -> dict:
    """The pipeline's weights in the reference's file layout under `root`:
    `sdxl/unet/diffusion_pytorch_model.safetensors` (core UNet keys, bf16),
    `FaithDiff.bin` (fusion modules and `denoise_encoder.*`) and
    `vae/diffusion_pytorch_model.safetensors`. Returns {file: bytes}."""
    from faithdiff_tpu_torch.utils.convert import (export_faithdiff_bin,
                                                   split_faithdiff_bin)
    from faithdiff_tpu_torch.utils.safetensors import save_file

    core, extras = split_faithdiff_bin(export_faithdiff_bin(
        pipe.unet.state_dict(), pipe.denoise_encoder.state_dict()))
    files = {"sdxl/unet/diffusion_pytorch_model.safetensors": core,
             "vae/diffusion_pytorch_model.safetensors": pipe.vae.state_dict()}
    for rel, sd in files.items():
        os.makedirs(os.path.dirname(os.path.join(root, rel)), exist_ok=True)
        save_file(sd, os.path.join(root, rel))
    torch.save({f"{ns}.{k}": v.cpu() for ns, sd in extras.items()
                for k, v in sd.items()}, os.path.join(root, "FaithDiff.bin"))
    return {rel: os.path.getsize(os.path.join(root, rel))
            for rel in list(files) + ["FaithDiff.bin"]}


def run_cli(argv):
    """`faithdiff_tpu_torch.cli.main(argv)` with its output echoed; returns
    {name: seconds} of the `restored` line's read / encode / hdr / resize /
    pipeline / write split and the call's wall seconds."""
    import io

    from faithdiff_tpu_torch import cli

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    wall = time.perf_counter() - t0
    print(out.getvalue(), end="", flush=True)
    if rc != 0:
        fail(f"cli {argv[0]} returned {rc}")
    split = dict((k, float(v)) for k, v in
                 re.findall(r"(\w+_s)=([0-9.]+)", out.getvalue()))
    if set(split) != {"read_s", "encode_s", "hdr_s", "resize_s", "pipeline_s",
                      "write_s"}:
        fail(f"cli printed no restore line: {out.getvalue()!r}")
    return dict(split, cli_wall_s=wall)


@contextlib.contextmanager
def cli_pipeline_watch(torch, hooks=()):
    """Within the block, the pipeline the CLI builds is recorded with its
    load seconds and a `PathWatch` on it (`seen["watch"]`), and every VAE
    decode call's latents' finiteness and seconds. `hooks` are (module
    name, forward hook) pairs to register on the pipeline's models."""
    from faithdiff_tpu_torch import cli

    seen = {"decode_s": 0.0, "latents_finite": True, "handles": []}
    build = cli.load_checkpointed_pipeline

    def watched(args):
        t0 = time.perf_counter()
        pipe = build(args)
        torch.cuda.synchronize()
        seen.update(pipe=pipe, load_s=time.perf_counter() - t0,
                    watch=PathWatch(torch, pipe))
        for path, hook in hooks:
            module = pipe
            for name in path.split("."):
                module = getattr(module, name)
            seen["handles"].append(module.register_forward_hook(hook))
        decode = pipe.vae_decode

        def timed_decode(latents):
            seen["latents_finite"] &= bool(torch.isfinite(latents).all())
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = decode(latents)
            torch.cuda.synchronize()
            seen["decode_s"] += time.perf_counter() - t
            return out

        pipe.vae_decode = timed_decode
        return pipe

    cli.load_checkpointed_pipeline = watched
    try:
        yield seen
    finally:
        cli.load_checkpointed_pipeline = build
        if "watch" in seen:
            seen["watch"].remove()
        for h in seen["handles"]:
            h.remove()


def run_cli_restore(torch, pipe, root: str) -> str:
    """`cli_restore`: the pipeline's weights written in the reference's
    layout, converted by the port's `convert_cli`, then `cli.main(["restore",
    ...])` with default flags on a seeded 512x768 PNG (upscale 2: 1024x1536,
    2 latent tiles). The PNG it writes must equal, byte for byte, the
    in-memory pipeline's uint8 output on `resize_lanczos` of the same image.
    Returns the converted checkpoint dir and the result row."""
    import numpy as np

    from faithdiff_tpu_torch import cli
    from faithdiff_tpu_torch.ops import _build
    from faithdiff_tpu_torch.utils import convert_cli
    from faithdiff_tpu_torch.utils.image import check_image_size
    from faithdiff_tpu_torch.utils.png import read_png, write_png
    from faithdiff_tpu_torch.utils.resample import resize_lanczos
    from faithdiff_tpu_torch.utils.safetensors import load_file

    free_gb = shutil.disk_usage(os.path.dirname(root)).free / 1e9
    print(f"cli_restore: {free_gb:.1f} GB free beside {root}; the reference "
          "files take ~5.5 GB and the converted copy as much again", flush=True)
    t0 = time.perf_counter()
    sizes = write_reference_weights(torch, pipe, root)
    t1 = time.perf_counter()
    ckpt = os.path.join(root, "ckpt")
    convert_cli.main(["--sdxl_dir", os.path.join(root, "sdxl"),
                      "--faithdiff_bin", os.path.join(root, "FaithDiff.bin"),
                      "--vae_dir", os.path.join(root, "vae"), "--out_dir", ckpt])
    t2 = time.perf_counter()
    keys = {name: len(load_file(os.path.join(ckpt, name, convert_cli.MODEL_FILE)))
            for name in ("unet", "vae", "denoise_encoder")}

    img = np.random.default_rng(11).integers(0, 256, CLI_PIXELS + (3,),
                                             dtype=np.uint8)
    os.makedirs(os.path.join(root, "in"))
    write_png(os.path.join(root, "in", "photo.png"), img)
    gn_unet, attn_unet = unet_counts(pipe)
    with cli_pipeline_watch(torch) as seen:
        _build.launches.clear()
        split = run_cli(["restore", "--img_dir", os.path.join(root, "in"),
                         "--save_dir", os.path.join(root, "out"),
                         "--checkpoint_dir", ckpt])
        counts = dict(_build.launches)
    cli_pipe = seen.pop("pipe")
    expected = seen["watch"].expected_launches("cli_restore", "flash_attention_fwd",
                                               gn_unet, attn_unet)
    if counts != expected:
        fail(f"cli_restore: launch counts {counts}, expected {expected}")
    # the weights the CLI loaded strictly are the in-memory pipeline's
    for name in ("unet", "vae", "denoise_encoder"):
        mine = getattr(pipe, name).state_dict()
        theirs = getattr(cli_pipe, name).state_dict()
        if sorted(mine) != sorted(theirs) or len(mine) != keys[name] or not all(
                torch.equal(mine[k], theirs[k]) for k in mine):
            fail(f"cli_restore: {name} weights differ after the round trip")
    del cli_pipe
    torch.cuda.empty_cache()

    got = read_png(os.path.join(root, "out", "photo.png"))
    h, w = CLI_PIXELS
    padded, w0, h0, _, _ = check_image_size(resize_lanczos(img, (2 * w, 2 * h)))
    before = pipe.tile_chunk
    pipe.tile_chunk = cli.TILE_CHUNK
    try:
        want = pipe(padded, torch.zeros((1, 77, 2048)), torch.zeros((1, 1280)),
                    seed=42, output_type="uint8")[:h0, :w0]
    finally:
        pipe.tile_chunk = before
    if got.shape != want.shape:
        fail(f"cli_restore: output {got.shape}, in-memory {want.shape}")
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    if diff.any():
        fail(f"cli_restore: {int((diff.max(axis=2) > 0).sum())} pixels differ "
             f"from the in-memory pipeline, by up to {int(diff.max())}")
    result = dict(
        free_disk_gb=free_gb, file_bytes=sizes, keys_loaded_strict=keys,
        write_weights_s=t1 - t0, convert_s=t2 - t1, load_s=seen["load_s"],
        host_pre_s=split["read_s"] + split["resize_s"], **split,
        identical_to_in_memory=True, pixels=list(got.shape[:2]),
        launches=counts, launches_as_planned=True)
    print("cli_restore", json.dumps(result), flush=True)
    return ckpt, result


def run_cli_restore_tiled(torch, root: str, ckpt: str) -> None:
    """`cli_restore_tiled`: the CLI with `--upscale 2 --use_tile_vae --hdr
    0.5 --color_fix adain` on a seeded 1000x1000 PNG: a 2000x2000 restore,
    9 latent tiles (18 UNet rows a step, in the CLI's chunks), the VAE
    encode, the denoise encoder and the VAE decode over the tile grids of
    the JAX tiling formula, the color fix streamed; launches as planned."""
    import numpy as np

    from faithdiff_tpu_torch import cli
    from faithdiff_tpu_torch.config import DenoiseEncoderConfig, VAEConfig
    from faithdiff_tpu_torch.ops import _build
    from faithdiff_tpu_torch.utils.png import read_png, write_png

    img = np.random.default_rng(12).integers(0, 256, TILED_PIXELS + (3,),
                                             dtype=np.uint8)
    os.makedirs(os.path.join(root, "in_tiled"))
    write_png(os.path.join(root, "in_tiled", "photo.png"), img)
    side = 2 * TILED_PIXELS[0]

    def grid(extent, tile, overlap):        # `tiled_apply`'s tiles on a square
        return len(range(0, extent, int(tile * (1 - overlap)))) ** 2

    vae_cfg, de_cfg = VAEConfig(), DenoiseEncoderConfig()
    want_tiles = dict(
        encode=grid(side, vae_cfg.tile_sample_min_size, vae_cfg.tile_overlap_factor),
        denoise_encoder=grid(side, de_cfg.tile_sample_min_size,
                             de_cfg.tile_overlap_factor),
        decode=grid(side // 8, vae_cfg.tile_latent_min_size,
                    vae_cfg.tile_overlap_factor))
    tiles = dict.fromkeys(want_tiles, 0)

    def counter(name):
        def hook(module, args, out):
            tiles[name] += args[0].shape[0]
        return hook

    hooks = [("vae.encoder", counter("encode")), ("vae.decoder", counter("decode")),
             ("denoise_encoder", counter("denoise_encoder"))]
    with cli_pipeline_watch(torch, hooks) as seen:
        _build.launches.clear()
        torch.cuda.reset_peak_memory_stats()
        split = run_cli(["restore", "--img_dir", os.path.join(root, "in_tiled"),
                         "--save_dir", os.path.join(root, "out_tiled"),
                         "--checkpoint_dir", ckpt, "--upscale", "2",
                         "--use_tile_vae", "--hdr", "0.5", "--color_fix", "adain"])
        counts = dict(_build.launches)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    pipe = seen.pop("pipe")
    gn_unet, attn_unet = unet_counts(pipe)
    unet_batches = seen["watch"].batches
    unet_ms = seen["watch"].unet_ms()
    expected = seen["watch"].expected_launches(
        "cli_restore_tiled", "flash_attention_fwd", gn_unet, attn_unet)
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    out = read_png(os.path.join(root, "out_tiled", "photo.png"))
    if out.shape != (side, side, 3):
        fail(f"cli_restore_tiled: output {out.shape}")
    if not seen["latents_finite"]:
        fail("cli_restore_tiled: latents are not finite")
    if tiles != want_tiles:
        fail(f"cli_restore_tiled: tiles {tiles}, the tiling formula gives "
             f"{want_tiles}")
    # the CLI's chunks: ceil(9 / TILE_CHUNK) UNet calls a step, 18 rows in all
    calls_per_step = -(-TILED_LATENT_TILES // cli.TILE_CHUNK)
    if (sum(unet_batches) != 2 * TILED_LATENT_TILES * STEPS
            or max(unet_batches) > 2 * cli.TILE_CHUNK
            or len(unet_ms) != calls_per_step * STEPS):
        fail(f"cli_restore_tiled: UNet batches {sorted(set(unet_batches))} over "
             f"{len(unet_ms)} calls, expected {2 * TILED_LATENT_TILES} rows a "
             f"step in {calls_per_step} calls")
    if counts != expected:
        fail(f"cli_restore_tiled: launch counts {counts}, expected {expected}")
    result = dict(
        pixels=[side, side], tiles=tiles, unet_batches=sorted(set(unet_batches)),
        unet_calls=len(unet_ms),
        host_pre_s=split["read_s"] + split["resize_s"], **split,
        vae_decode_s=seen["decode_s"], load_s=seen["load_s"],
        unet_ms_median=median(unet_ms), peak_mem_gib=peak,
        out_mean=float(out.mean()), launches=counts, launches_as_planned=True)
    print("cli_restore_tiled", json.dumps(result), flush=True)


def check_vae_chunk_trap(torch) -> None:
    """One `chunked_attention` call as the untiled VAE decode of a 2000^2
    image runs it ([1, 1, 62500, 512] bf16: the chunk halves to 4, 15,625
    loop steps) against the same call at kv 65,536 (chunk 1024, 64 steps).
    Measured only: the port keeps the JAX package's arithmetic."""
    from faithdiff_tpu_torch.ops.attention import chunked_attention

    gen = torch.Generator(device="cuda").manual_seed(13)
    row = {}
    for n in (62500, 65536):
        q, k, v = (torch.randn((1, 1, n, 512), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        chunk = 1024
        while n % chunk:
            chunk //= 2
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = chunked_attention(q, k, v, 512 ** -0.5)
        torch.cuda.synchronize()
        row[str(n)] = dict(chunk=chunk, loop_steps=n // chunk,
                           ms=(time.perf_counter() - t0) * 1e3,
                           finite=bool(torch.isfinite(out).all()))
        del q, k, v, out
        torch.cuda.empty_cache()
    print("vae_chunk_trap", json.dumps(row), flush=True)


def median(xs):
    return sorted(xs)[len(xs) // 2]


def chunk_rows(args, rows: int, lo: int, hi: int):
    """The UNet call's positional arguments cut to model rows [lo, hi):
    every tensor with `rows` rows; the timestep stays whole."""
    return tuple(a[lo:hi] if getattr(a, "ndim", 0) and a.shape[0] == rows else a
                 for a in args)


def check_chunk_parity(torch, unet, args, kwargs, chunk: int) -> None:
    """`chunk_parity`: one UNet call over the 15 tiles of `restore_large`'s
    first step, unchunked, against the same inputs run as chunks of
    `chunk` tiles (2 * chunk model rows, each tile's CFG pair together),
    on both attention paths, within CHUNK_TOL * max|ref|. Beside it, the
    same call with its tiles in reverse order: the floor that other
    orders of summation alone give at the same batch (cuBLAS's stream-K
    GEMMs split K by an output tile's place)."""
    rows = args[0].shape[0]
    perm = torch.tensor([r for t in reversed(range(rows // 2))
                         for r in (2 * t, 2 * t + 1)])
    inverse = torch.argsort(perm)
    result = {}
    with torch.no_grad():
        for packed in (False, True):
            with attention_path(packed):
                ref = unet(*args, **kwargs).float()
                flipped = unet(*(a[perm.to(a.device)] if getattr(a, "ndim", 0)
                                 and a.shape[0] == rows else a for a in args),
                               **kwargs).float()[inverse.to(ref.device)]
                got = torch.cat([unet(*chunk_rows(args, rows, lo, lo + 2 * chunk),
                                      **kwargs).float()
                                 for lo in range(0, rows, 2 * chunk)])
            err = float((got - ref).abs().max())
            floor = float((flipped - ref).abs().max())
            scale = float(ref.abs().max())
            result["packed" if packed else "default"] = dict(
                max_abs_err=err, max_abs_ref=scale,
                mean_abs_err=float((got - ref).abs().mean()),
                reversed_max_abs_err=floor,
                ok=bool(torch.isfinite(got).all()) and err <= CHUNK_TOL * scale)
            del ref, got, flipped
    result.update(tiles=rows // 2, chunk=chunk,
                  calls=-(-rows // (2 * chunk)), tol=f"{CHUNK_TOL} * max|ref|")
    print("chunk_parity", json.dumps(result), flush=True)
    if not (result["default"]["ok"] and result["packed"]["ok"]):
        fail(f"chunked and unchunked UNet calls disagree: {result}")


def run_tile_chunk_sweep(torch, unet, args, kwargs) -> int:
    """`tile_chunk_sweep`: one full-width UNet call at 128^2 latent tiles,
    bf16, default attention path, for chunks of c in SWEEP_CHUNKS tiles
    (UNet batch 2c, the restore's first tile pair repeated): the median of
    3 calls after a warm-up (CUDA events) and the peak memory. Returns the
    chunk of the lowest ms per tile whose peak leaves FREE_GIB_FOR_CAPTIONER
    of the card free."""
    from faithdiff_tpu_torch import cli

    rows = args[0].shape[0]
    pair = chunk_rows(args, rows, 0, 2)
    total_gib = torch.cuda.get_device_properties(0).total_memory / 2 ** 30
    table = []
    with torch.no_grad(), attention_path(False):
        for c in SWEEP_CHUNKS:
            inputs = tuple(a.repeat(c, *([1] * (a.ndim - 1)))
                           if getattr(a, "ndim", 0) else a for a in pair)
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            unet(*inputs, **kwargs)
            ms = []
            for _ in range(3):
                a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                a.record()
                out = unet(*inputs, **kwargs)
                b.record()
                torch.cuda.synchronize()
                ms.append(a.elapsed_time(b))
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            if not bool(torch.isfinite(out).all()):
                fail(f"tile_chunk_sweep: non-finite UNet output at chunk {c}")
            table.append(dict(chunk=c, unet_batch=2 * c, ms=median(ms),
                              ms_per_tile=median(ms) / c, ms_all=ms,
                              peak_gib=peak, free_gib=total_gib - peak))
            del inputs, out
    fits = [r for r in table if r["free_gib"] >= FREE_GIB_FOR_CAPTIONER]
    if not fits:
        fail(f"tile_chunk_sweep: no chunk leaves {FREE_GIB_FOR_CAPTIONER} GiB free")
    pick = min(fits, key=lambda r: r["ms_per_tile"])["chunk"]
    # where the time per tile jumps: the pick against the next chunk up
    for c in SWEEP_CHUNKS[SWEEP_CHUNKS.index(pick):][:2]:
        inputs = tuple(a.repeat(c, *([1] * (a.ndim - 1)))
                       if getattr(a, "ndim", 0) else a for a in pair)
        with attention_path(False):
            profile_call(torch, f"profile_chunk_{c}", unet, inputs, kwargs)
        del inputs
    print("tile_chunk_sweep", json.dumps(dict(
        rows=table, total_gib=total_gib, pick=pick,
        cli_tile_chunk=cli.TILE_CHUNK,
        rule=f"lowest ms_per_tile with free_gib >= {FREE_GIB_FOR_CAPTIONER}")),
        flush=True)
    torch.cuda.empty_cache()
    return pick


def run_restore_4k(torch, pipe, ckpt_dir: str) -> dict:
    """`restore_4k`: the pipeline with `use_tiled_vae` and the CLI's
    `TILE_CHUNK` on a seeded 4096x4096 uint8 image (a 2048^2 photo at the
    CLI's default --upscale 2): 49 latent tiles, 20 steps, canvas
    checkpoints under `ckpt_dir`. Checks the output, finite latents,
    ceil(49 / c) UNet calls a step at batch <= 2c and the planned
    launches; then deletes the last two canvases, runs again and demands
    2 * ceil(49 / c) UNet calls and the same bytes."""
    import dataclasses

    import numpy as np

    from faithdiff_tpu_torch import cli
    from faithdiff_tpu_torch.ops import _build
    from faithdiff_tpu_torch.pipelines.factory import _tiled_stages

    chunk = cli.TILE_CHUNK
    tiled = dataclasses.replace(
        pipe, config=dataclasses.replace(pipe.config, use_tiled_vae=True),
        tile_chunk=chunk, **_tiled_stages(pipe.vae, pipe.denoise_encoder, True))
    gn_unet, attn_unet = unet_counts(tiled)
    img = np.random.default_rng(14).integers(0, 256, FOUR_K_PIXELS + (3,),
                                             dtype=np.uint8)
    prompt, pooled = torch.zeros((1, 77, 2048)), torch.zeros((1, 1280))
    calls_per_step = -(-FOUR_K_TILES // chunk)

    def run(label):
        watch = PathWatch(torch, tiled)
        _build.launches.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        latents = tiled(img, prompt, pooled, seed=0, output_type="latent",
                        checkpoint_dir=ckpt_dir)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = tiled.decode(latents, img, output_type="uint8")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        counts = dict(_build.launches)
        watch.remove()
        if not bool(torch.isfinite(latents).all()):
            fail(f"{label}: latents are not finite")
        if out.shape != FOUR_K_PIXELS + (3,) or out.dtype != np.uint8:
            fail(f"{label}: output {out.dtype} {out.shape}")
        if max(watch.batches) > 2 * chunk:
            fail(f"{label}: a UNet call at batch {max(watch.batches)} > {2 * chunk}")
        expected = watch.expected_launches(label, "flash_attention_fwd",
                                           gn_unet, attn_unet)
        if counts != expected:
            fail(f"{label}: launch counts {counts}, expected {expected}")
        unet_ms = watch.unet_ms()
        return out, counts, dict(
            wall_s=t2 - t0, denoise_call_s=t1 - t0, decode_s=t2 - t1,
            unet_calls=len(unet_ms), unet_batches=sorted(set(watch.batches)),
            unet_ms_median=median(unet_ms) if unet_ms else None,
            unet_ms_per_step=sum(unet_ms) / max(len(unet_ms) // calls_per_step, 1),
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
            launches=counts, launches_as_planned=True)

    out, counts, first = run("restore_4k")
    if first["unet_calls"] != calls_per_step * STEPS:
        fail(f"restore_4k: {first['unet_calls']} UNet calls, expected "
             f"{calls_per_step * STEPS}")
    canvases = sorted(n for n in os.listdir(ckpt_dir) if n.startswith("canvas_step"))
    if len(canvases) != STEPS:
        fail(f"restore_4k: canvases {canvases}")
    for step in (STEPS - 2, STEPS - 1):
        os.remove(os.path.join(ckpt_dir, f"canvas_step{step:04d}.npy"))
    resumed, _, second = run("restore_4k_resume")
    if second["unet_calls"] != 2 * calls_per_step:
        fail(f"restore_4k_resume: {second['unet_calls']} UNet calls, expected "
             f"{2 * calls_per_step}")
    if not np.array_equal(out, resumed):
        diff = np.abs(out.astype(np.int16) - resumed.astype(np.int16))
        fail(f"restore_4k_resume: {int((diff.max(axis=2) > 0).sum())} pixels "
             f"differ from the uninterrupted run, by up to {int(diff.max())}")
    print("restore_4k", json.dumps(dict(
        first, pixels=list(FOUR_K_PIXELS), tiles=FOUR_K_TILES, tile_chunk=chunk,
        steps=STEPS, canvases=len(canvases), out_mean=float(out.mean()),
        resume=dict(second, identical_bytes=True))), flush=True)
    return counts


def write_tokenizer_dirs(root: str) -> str:
    """SDXL-layout `tokenizer/` and `tokenizer_2/` under `root` over a
    synthetic vocabulary of CLIP's size, 49408: the 256 byte symbols, the
    same with `</w>`, 48894 merges that build lower-case words of up to
    four letters, then `<|startoftext|>` (49406) and `<|endoftext|>`
    (49407). `tokenizer_2` pads with `!` (id 0), as SDXL's does."""
    from faithdiff_tpu_torch.models.tokenizer import bytes_to_unicode

    symbols = list(bytes_to_unicode().values())
    vocab = symbols + [s + "</w>" for s in symbols]
    n_merges = 49152 - 256 - 2
    letters = "etaoinshrdlcumwfgypbvkjxqz"
    merges, words, seen = [], list(letters), set(vocab)
    for word in words:
        for b in letters:
            for second in (b, b + "</w>"):
                token = word + second
                if token not in seen and len(merges) < n_merges:
                    seen.add(token)
                    merges.append(f"{word} {second}")
                    vocab.append(token)
                    if not second.endswith("</w>"):
                        words.append(token)
    vocab += ["<|startoftext|>", "<|endoftext|>"]
    if len(vocab) != 49408 or len(merges) != n_merges:
        fail(f"synthetic vocabulary: {len(vocab)} symbols, {len(merges)} merges")
    special = {k: {"content": v, "lstrip": False, "normalized": True,
                   "rstrip": False, "single_word": False}
               for k, v in (("bos_token", "<|startoftext|>"),
                            ("eos_token", "<|endoftext|>"),
                            ("unk_token", "<|endoftext|>"))}
    for name, pad in (("tokenizer", "<|endoftext|>"), ("tokenizer_2", "!")):
        d = os.path.join(root, name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "vocab.json"), "w") as f:
            json.dump({t: i for i, t in enumerate(vocab)}, f)
        with open(os.path.join(d, "merges.txt"), "w") as f:
            f.write("#version: 0.2\n" + "\n".join(merges) + "\n")
        with open(os.path.join(d, "special_tokens_map.json"), "w") as f:
            json.dump(dict(special, pad_token=pad), f)
        with open(os.path.join(d, "tokenizer_config.json"), "w") as f:
            json.dump({"model_max_length": 77, "pad_token": pad,
                       "tokenizer_class": "CLIPTokenizer"}, f)
    return root


def check_text_towers(torch, tok_root: str) -> None:
    """`text_towers`: the full-width SDXLTextEncoder, bf16, seeded weights,
    on the card against the same weights in fp32 on the CPU over 4
    prompts tokenised by the port's BPE (one past 77 tokens): the largest
    error within 5e-2 * (1 + max|ref|), the mean error within
    TOWER_MEAN_TOL * mean|ref|; ms per encode of one prompt and of four."""
    from faithdiff_tpu_torch.utils.profiling import time_ms
    from faithdiff_tpu_torch import cli
    from faithdiff_tpu_torch.models.clip_text import SDXLTextEncoder
    from faithdiff_tpu_torch.models.tokenizer import SDXLTokenizer

    tok = SDXLTokenizer(os.path.join(tok_root, "tokenizer"),
                        os.path.join(tok_root, "tokenizer_2"))
    ids_1, ids_2 = tok(TOWER_PROMPTS)
    truncated = sum(len(tok.tok_1.encode(p)) > 75 for p in TOWER_PROMPTS)
    if ids_1.shape != (4, 77) or truncated != 1 or int(ids_1[0, -1]) != 49407:
        fail(f"text_towers: ids {ids_1.shape}, {truncated} truncated prompts")
    enc = cli.build_text_encoder(False, "cuda", seed=5)
    ref_enc = SDXLTextEncoder().eval().requires_grad_(False)
    ref_enc.load_state_dict({k: v.float().cpu() for k, v in enc.state_dict().items()})
    t1, t2 = torch.from_numpy(ids_1), torch.from_numpy(ids_2)
    with torch.no_grad():
        t0 = time.perf_counter()
        ref = ref_enc(t1, t2)
        cpu_s = time.perf_counter() - t0
        got = enc(t1, t2)

        def timed(n):
            a, b = t1[:n].cuda(), t2[:n].cuda()
            return median([time_ms(lambda: enc(a, b), 3, 1) for _ in range(3)])

        ms_1, ms_4 = timed(1), timed(4)
    rows = {}
    for name, g, r in (("prompt_embeds", got[0], ref[0]), ("pooled", got[1], ref[1])):
        g = g.float().cpu()
        err = (g - r).abs()
        rows[name] = dict(shape=list(g.shape), max_abs_err=float(err.max()),
                          max_abs_ref=float(r.abs().max()),
                          mean_abs_err=float(err.mean()),
                          mean_abs_ref=float(r.abs().mean()),
                          elementwise_ok=bool((err <= 5e-2 * (1 + r.abs())).all()),
                          ok=bool(torch.isfinite(g).all()
                                  and err.max() <= 5e-2 * (1 + r.abs().max())
                                  and err.mean() <= TOWER_MEAN_TOL * r.abs().mean()))
    print("text_towers", json.dumps(dict(
        rows, ms_per_encode_1=ms_1, ms_per_encode_4=ms_4, cpu_fp32_s=cpu_s,
        params_b=sum(p.numel() for p in enc.parameters()) / 1e9,
        tol=f"max 5e-2 * (1 + max|ref|), mean {TOWER_MEAN_TOL} * mean|ref|")),
        flush=True)
    if not all(r["ok"] for r in rows.values()):
        fail(f"text_towers: card and CPU disagree: {rows}")
    del enc, ref_enc
    gc.collect()
    torch.cuda.empty_cache()


def run_cli_restore_prompt(torch, pipe, root: str, ckpt: str) -> None:
    """`cli_restore_prompt`: seeded full-width towers written as SDXL ships
    them (`text_encoder*/model.safetensors`, fp16), tokenizer dirs of the
    synthetic 49408-symbol vocabulary, `convert_cli`, then the CLI with
    `--tokenizer_dir`, a caption JSON and `--negative_prompt blurry` on
    `cli_restore`'s PNG. Its PNG must equal, byte for byte, the in-memory
    pipeline (the CLI's tile chunk) given the port's own encodes of the
    same texts, and differ from `cli_restore`'s zero-embed output."""
    import numpy as np

    from faithdiff_tpu_torch import cli
    from faithdiff_tpu_torch.models.tokenizer import SDXLTokenizer
    from faithdiff_tpu_torch.ops import _build
    from faithdiff_tpu_torch.utils import convert_cli
    from faithdiff_tpu_torch.utils.convert import TEXT_TOWERS
    from faithdiff_tpu_torch.utils.image import check_image_size
    from faithdiff_tpu_torch.utils.png import read_png
    from faithdiff_tpu_torch.utils.resample import resize_lanczos
    from faithdiff_tpu_torch.utils.safetensors import save_file

    t0 = time.perf_counter()
    enc = cli.build_text_encoder(False, "cuda", seed=7)
    for tower in TEXT_TOWERS:
        d = os.path.join(root, "sdxl", tower)
        os.makedirs(d, exist_ok=True)
        save_file({k: v.half() for k, v in getattr(enc, tower).state_dict().items()},
                  os.path.join(d, "model.safetensors"))
    tower_bytes = sum(os.path.getsize(os.path.join(root, "sdxl", t, "model.safetensors"))
                      for t in TEXT_TOWERS)
    del enc
    tok_root = write_tokenizer_dirs(os.path.join(root, "tok"))
    os.makedirs(os.path.join(root, "json"))
    with open(os.path.join(root, "json", "photo.json"), "w") as f:
        json.dump({"caption": PROMPT_CAPTION}, f)
    t1 = time.perf_counter()
    convert_cli.main(["--sdxl_dir", os.path.join(root, "sdxl"),
                      "--faithdiff_bin", os.path.join(root, "FaithDiff.bin"),
                      "--vae_dir", os.path.join(root, "vae"), "--out_dir", ckpt])
    t2 = time.perf_counter()

    seen_towers = []
    build = cli.build_text_encoder

    def watched(*a, **k):
        seen_towers.append(build(*a, **k))
        return seen_towers[-1]

    gn_unet, attn_unet = unet_counts(pipe)
    cli.build_text_encoder = watched
    try:
        with cli_pipeline_watch(torch) as seen:
            _build.launches.clear()
            split = run_cli(["restore", "--img_dir", os.path.join(root, "in"),
                             "--save_dir", os.path.join(root, "out_prompt"),
                             "--checkpoint_dir", ckpt, "--tokenizer_dir", tok_root,
                             "--json_dir", os.path.join(root, "json"),
                             "--negative_prompt", "blurry"])
            counts = dict(_build.launches)
    finally:
        cli.build_text_encoder = build
    seen.pop("pipe")
    expected = seen["watch"].expected_launches(
        "cli_restore_prompt", "flash_attention_fwd", gn_unet, attn_unet)
    if counts != expected:
        fail(f"cli_restore_prompt: launch counts {counts}, expected {expected}")
    gc.collect()
    torch.cuda.empty_cache()

    # the in-memory side: the converted towers, the port's tokenizer, the
    # caption as the CLI trims it
    (cli_enc,) = seen_towers
    enc = build(False, "cuda", cli.load_dir(os.path.join(ckpt, "text_encoders")))
    mine, theirs = enc.state_dict(), cli_enc.state_dict()
    if sorted(mine) != sorted(theirs) or not all(torch.equal(mine[k], theirs[k])
                                                for k in mine):
        fail("cli_restore_prompt: the CLI's towers differ from the written ones")
    tok = SDXLTokenizer(os.path.join(tok_root, "tokenizer"),
                        os.path.join(tok_root, "tokenizer_2"))
    caption = cli.trim_caption(PROMPT_CAPTION)
    with torch.no_grad():
        pe, pooled = (x.float() for x in enc(*map(torch.from_numpy, tok(caption))))
        npe, npooled = (x.float() for x in enc(*map(torch.from_numpy, tok("blurry"))))
    del enc, cli_enc, seen_towers[:]
    img = read_png(os.path.join(root, "in", "photo.png"))
    h, w = img.shape[:2]
    padded, w0, h0, _, _ = check_image_size(resize_lanczos(img, (2 * w, 2 * h)))
    before = pipe.tile_chunk
    pipe.tile_chunk = cli.TILE_CHUNK
    try:
        want = pipe(padded, pe, pooled, negative_prompt_embeds=npe,
                    negative_pooled_prompt_embeds=npooled, seed=42,
                    output_type="uint8")[:h0, :w0]
    finally:
        pipe.tile_chunk = before
    got = read_png(os.path.join(root, "out_prompt", "photo.png"))
    zero = read_png(os.path.join(root, "out", "photo.png"))
    if got.shape != want.shape or not np.array_equal(got, want):
        diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
        fail(f"cli_restore_prompt: {int((diff.max(axis=2) > 0).sum())} pixels "
             f"differ from the in-memory pipeline, by up to {int(diff.max())}")
    if np.array_equal(got, zero):
        fail("cli_restore_prompt: the prompt left the zero-embed output unchanged")
    result = dict(
        tower_file_bytes=tower_bytes, write_towers_s=t1 - t0, convert_s=t2 - t1,
        load_s=seen["load_s"], **split, caption=caption,
        pixels_differing_from_zero_embeds=int(
            (np.abs(got.astype(np.int16) - zero).max(axis=2) > 0).sum()),
        identical_to_in_memory=True, launches=counts, launches_as_planned=True)
    print("cli_restore_prompt", json.dumps(result), flush=True)


# lower-cased kernel-name fragments -> the layer they belong to, first
# match wins (cuDNN's convolution kernels carry "gemm" in their names too)
KERNEL_CLASSES = (("flash_bsnd_fwd_kernel", "packed flash attention (ours)"),
                  ("flash_fwd_kernel", "flash attention (ours)"),
                  ("nf4_ge", "NF4 dequant-matmul (ours)"),
                  ("::gn_", "GroupNorm (ours)"),
                  ("fprop", "convolution"), ("conv", "convolution"),
                  ("nchwtonhwc", "cuDNN layout transpose"),
                  ("nhwctonchw", "cuDNN layout transpose"),
                  ("gemm", "matmul"), ("nvjet", "matmul"), ("xmma", "matmul"),
                  ("softmax", "softmax"), ("reduce", "reduction"),
                  ("copy", "copy / dtype cast"), ("elementwise", "elementwise"))


def profile_call(torch, label, module, args, kwargs):
    """One more call of `module` under `utils.profiling.trace`: device time
    by layer and by kernel, and the device's busy share between its first
    and last kernel (`profiling.device_split`). The chrome trace is kept
    beside the built kernels, as faithdiff_tpu_torch/_build/<label>/trace.json."""
    from faithdiff_tpu_torch.ops import _build
    from faithdiff_tpu_torch.utils import profiling

    log_dir = os.path.join(_build.BUILD_DIR, label)
    with torch.no_grad():
        with profiling.trace(log_dir):
            t0 = time.perf_counter()
            module(*args, **kwargs)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    kernels, _ = profiling.kernel_events(os.path.join(log_dir, "trace.json"))
    if not kernels:
        print(f"{label}: the trace holds no device kernels: not measured",
              flush=True)
        return None
    split = profiling.device_split(kernels, KERNEL_CLASSES)
    by_name = split.pop("by_name")
    result = dict(split, host_wall_ms=wall_ms)
    print(label, json.dumps(result), flush=True)
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {ms:9.3f} ms  {ms / split['kernel_ms']:6.1%}  {name[:110]}",
              flush=True)
    return result


def check_nf4(torch, ms_checked=None):
    """The NF4 kernel against its plain version at the captioner's shapes,
    for each M of `ms_checked` (default NF4_M and the caption's prefill M).
    The kernel streams each weight once per call, as the decode path does
    (280 different weights per token): its timed launches cycle through
    copies of the weight that together exceed the 50 MB L2. The kernel and
    the bf16 yardstick are timed from CUDA graphs (device time), the plain
    version from a loop of calls. A row is `ok` when it is `in_tol` (within
    tolerance, finite), has the same bits on two calls and was counted on
    its route (`route` is None for a port that counts no routes, as
    `faithdiff_tpu_torch/scripts/bench_nf4_decode.py` may time)."""
    from faithdiff_tpu_torch.utils.profiling import time_ms
    from faithdiff_tpu_torch.ops import _build
    from faithdiff_tpu_torch.ops.nf4_matmul import nf4_matmul_kernel, nf4_matmul_reference
    from faithdiff_tpu_torch.utils.quantize import dequantize_nf4, quantize_nf4

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(2)
    if ms_checked is None:
        ms_checked = NF4_M + [caption_prefill_m()]
    for in_f, out_f in NF4_SHAPES:
        w = (torch.randn((in_f, out_f), generator=gen, device="cuda")
             * in_f ** -0.5).to(torch.bfloat16)
        q = quantize_nf4(w)
        del w
        w_dec = dequantize_nf4(q, torch.bfloat16).T.contiguous()   # [out, in]
        weight_bytes = q.packed.numel() + q.absmax.numel() * 4
        copies = [q] + [q._replace(packed=q.packed.clone(), absmax=q.absmax.clone())
                        for _ in range(int(2 * 50e6 // weight_bytes))]
        for m in ms_checked:
            x = torch.randn((m, in_f), generator=gen, device="cuda").to(torch.bfloat16)
            _build.launches.clear()
            out = nf4_matmul_kernel(x, q)
            route = next((r for r in ("nf4_gemv", "nf4_gemm") if _build.launches[r]), None)
            same_bits = bool(torch.equal(out, nf4_matmul_kernel(x, q)))
            torch.cuda.synchronize()
            ref = nf4_matmul_reference(x, q)
            err = (out.float() - ref.float()).abs()
            # both round each decoded weight to bf16 once and multiply it
            # exactly; the fp32 sums run in another order, which can move
            # the one bf16 rounding of the output by a step (2^-8 relative)
            tol = 1e-2 * (1 + ref.float().abs())
            in_tol = bool((err <= tol).all()) and bool(torch.isfinite(out).all())
            ok = (in_tol and same_bits
                  and route == ("nf4_gemv" if m <= NF4_GEMV_MAX_M else "nf4_gemm"))
            turn = iter(range(1 << 30))

            def cold():
                return nf4_matmul_kernel(x, copies[next(turn) % len(copies)])

            b_ms, b_by = bound(2 * m * in_f * out_f,
                               weight_bytes + m * in_f * 2 + m * out_f * 2,
                               PEAK_BF16_FLOPS)
            ms = graph_ms(torch, cold)
            row = dict(m=m, in_f=in_f, out_f=out_f, route=route,
                       max_abs_err=float(err.max()), tol="1e-2*(1+|ref|)", in_tol=in_tol,
                       ok=ok,
                       same_bits=same_bits, ms=ms, ms_over_bound=ms / b_ms,
                       plain_ms=time_ms(lambda: nf4_matmul_reference(x, q), 3, 1),
                       library_ms=None, bound_ms=b_ms, bound_by=b_by,
                       decoded_bf16_matmul_ms=graph_ms(
                           torch, lambda: torch.matmul(x, w_dec.T)))
            print("nf4_matmul", json.dumps(row), flush=True)
            rows.append(row)
        del q, w_dec, copies, x, out, ref, err, tol
        torch.cuda.empty_cache()
    print("  (decoded_bf16_matmul_ms: torch.matmul of x with the weight already "
          "decoded to bf16, context only: no single PyTorch call computes the NF4 "
          "dequant-matmul)", flush=True)
    return rows


class WordTokenizer:
    """Deterministic stand-in for LLaMA's SentencePiece tokenizer, whose
    files are not in the repository: one id per word or punctuation mark,
    given in order of first use from 3 on; BOS 1, EOS 2. It keeps every id
    sequence it decodes."""

    eos_token_id = 2

    def __init__(self):
        self.vocab, self.decoded = {}, []

    def __call__(self, text, add_special_tokens=True, return_tensors=None):
        import numpy as np

        ids = [self.vocab.setdefault(w, 3 + len(self.vocab))
               for w in re.findall(r"\w+|[^\w\s]", text)]
        ids = ([1] if add_special_tokens else []) + ids
        return types.SimpleNamespace(input_ids=np.asarray([ids], np.int64))

    def decode(self, ids, skip_special_tokens=True):
        self.decoded.append([int(i) for i in ids])
        words = {v: k for k, v in self.vocab.items()}
        return " ".join(words.get(int(i), f"<{int(i)}>") for i in ids
                        if not (skip_special_tokens and int(i) < 3))


def caption_prompt_len(tok) -> int:
    """Tokens of the caption's prompt: the Vicuna text around the 576
    image tokens of one ViT-L/14-336 image (the pad path)."""
    from faithdiff_tpu_torch.captioner.agent import build_vicuna_prompt

    pre, post = build_vicuna_prompt("Describe this image and its style in a very "
                                    "detailed manner.")
    return (tok(pre).input_ids.shape[1] + 576
            + tok(post, add_special_tokens=False).input_ids.shape[1])


def caption_prefill_m() -> int:
    """Rows of every NF4 launch of the caption's prefill: batch x prompt."""
    return len(CAPTION_IMAGES) * caption_prompt_len(WordTokenizer())


def check_caption_small(torch):
    """A tiny nf4 LLaMA on the card (the NF4 kernel, bf16) against the same
    weights on the CPU (the plain version, fp32): prefill logits (the
    prefill route, M = 24) and one-row logits (the decode route)."""
    import dataclasses

    from faithdiff_tpu_torch.captioner.llama import (LlamaConfig,
                                                     LlamaForCausalLM,
                                                     random_init_quantized_)
    from faithdiff_tpu_torch.ops import _build
    from faithdiff_tpu_torch.pipelines.factory import random_init_

    cfg = dataclasses.replace(LlamaConfig.tiny(), quant="nf4")
    cpu = LlamaForCausalLM(cfg).eval().requires_grad_(False)
    gen = torch.Generator().manual_seed(3)
    random_init_(cpu, gen)
    random_init_quantized_(cpu, gen)
    with torch.device("cuda"):
        card = LlamaForCausalLM(cfg, dtype=torch.bfloat16).eval().requires_grad_(False)
    card.load_state_dict(cpu.state_dict())
    emb = torch.randn((2, 12, cfg.hidden_size), generator=gen)
    pos = torch.arange(12)[None].expand(2, 12)
    worst = 0.0
    with torch.no_grad():
        for e, p, route in ((emb, pos, "nf4_gemm"), (emb[:1, :1], pos[:1, :1], "nf4_gemv")):
            _build.launches.clear()
            ref, _ = cpu(e, p)
            got, _ = card(e.cuda().bfloat16(), p.cuda())
            torch.cuda.synchronize()
            n = 7 * cfg.num_hidden_layers
            if dict(_build.launches) != {"nf4_matmul": n, route: n}:
                fail(f"tiny captioner: {dict(_build.launches)} launches, expected "
                     f"{n} on {route}")
            err = (got.float().cpu() - ref).abs()
            # bf16 activations and weights against fp32 through two layers
            if not bool((err <= 5e-2 * (1 + ref.abs())).all()):
                fail(f"tiny captioner logits off the CPU reference: max {float(err.max())}")
            worst = max(worst, float(err.max()))
    print(f"caption_small: tiny nf4 LLaMA on the card vs the CPU plain version, "
          f"max |logit err| {worst:.4g} (tol 5e-2*(1+|ref|))", flush=True)


def check_llama_prefill(torch):
    """The causal prefill of the full-width 13B LLaMA's first two layers
    (nf4, bf16, seeded random weights) over a 1024-token prompt: the
    flash kernel at head dim 128, once a layer."""
    import dataclasses

    from faithdiff_tpu_torch.captioner.llama import (LlamaConfig,
                                                     LlamaForCausalLM,
                                                     random_init_quantized_)
    from faithdiff_tpu_torch.ops import _build
    from faithdiff_tpu_torch.pipelines.factory import random_init_

    cfg = dataclasses.replace(LlamaConfig(quant="nf4"),
                              num_hidden_layers=PREFILL_LAYERS)
    with torch.device("cuda"):
        model = LlamaForCausalLM(cfg, dtype=torch.bfloat16).eval().requires_grad_(False)
    gen = torch.Generator(device="cuda").manual_seed(6)
    random_init_(model, gen)
    random_init_quantized_(model, gen)
    emb = torch.randn((1, PREFILL_TOKENS, cfg.hidden_size), generator=gen,
                      device="cuda").to(torch.bfloat16)
    pos = torch.arange(PREFILL_TOKENS, device="cuda")[None]
    with torch.no_grad():
        model(emb, pos)                                     # warm-up
        _build.launches.clear()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        logits, _ = model(emb, pos)
        end.record()
        torch.cuda.synchronize()
    counts = dict(_build.launches)
    expected = {"flash_attention_fwd": PREFILL_LAYERS,
                "nf4_matmul": 7 * PREFILL_LAYERS, "nf4_gemm": 7 * PREFILL_LAYERS}
    if counts != expected:
        fail(f"13B prefill launch counts {counts}, expected {expected}")
    if tuple(logits.shape) != (1, PREFILL_TOKENS, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        fail(f"13B prefill logits {tuple(logits.shape)} not finite or misshapen")
    print("llama_prefill", json.dumps(dict(
        layers=PREFILL_LAYERS, tokens=PREFILL_TOKENS, head_dim=128,
        ms=start.elapsed_time(end), launches=counts)), flush=True)
    del model, emb, logits
    torch.cuda.empty_cache()


def run_bench(torch):
    """The attention-variant benchmark's entry point, as a user runs it."""
    from faithdiff_tpu_torch.ops import _build
    from faithdiff_tpu_torch.ops.attention_variants import VARIANTS
    from faithdiff_tpu_torch.scripts import bench_attention_variants as bench

    _build.launches.clear()
    rows = bench.main()
    torch.cuda.synchronize()
    counts = dict(_build.launches)
    if len(rows) != len(bench.SHAPES) * len(VARIANTS):
        fail(f"bench: {len(rows)} rows")
    # the variants differ from the first one by the bf16 roundings of q
    # and p; outputs are averages of N(0, 1) values, |o| << 1
    bad = [r for r in rows if not r["max_err_vs_first"] <= 2e-2]
    if bad:
        fail(f"bench: variants disagree: {bad}")
    if not counts.get("attention_variant_fwd") or set(counts) != {"attention_variant_fwd"}:
        fail(f"bench launch counts {counts}")
    print("bench_attention_variants", json.dumps(dict(launches=counts)), flush=True)
    return counts


def run_caption(torch, quant: str = "nf4"):
    """The captioner's main path: build_caption_agent() at full width (13B
    LLaMA, `quant` "nf4" or "int8", ViT-L/14-336), one caption_batch of two
    images. nf4: 280 NF4 launches a forward, on the prefill route for the
    prefill and the decode route after it; int8 (plain torch, as XLA ran
    the JAX package's int8 matmul): no counted launch at all. Returns the
    launch counts and the agent (the `vqa` phase reuses the nf4 one)."""
    import numpy as np

    from faithdiff_tpu_torch.captioner import (CLIPVisionConfig, LlamaConfig,
                                               build_caption_agent)
    from faithdiff_tpu_torch.ops import _build

    tok = WordTokenizer()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    agent = build_caption_agent(tok, LlamaConfig(quant=quant), CLIPVisionConfig(),
                                dtype=torch.bfloat16, device="cuda", seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    weights_gib = torch.cuda.memory_allocated() / 2 ** 30
    label = "caption" if quant == "nf4" else f"caption_{quant}"
    print(f"{label}: built LLaVA-1.5-13B {quant} + ViT-L/14-336 in {build_s:.1f} s "
          f"(init + quantise on the card), {weights_gib:.2f} GiB", flush=True)
    if (agent.temperature, agent.top_p, agent.max_new_tokens) != (0.2, 0.7, 512):
        fail("caption agent defaults changed")
    agent.max_new_tokens = CAPTION_NEW_TOKENS

    calls, finite = [], []

    def record():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    first, last = [], []

    def lm_pre(module, args, kwargs):
        calls.append([record(), None, args[0].shape[1], args[0].shape[0],
                      dict(_build.launches)])
        last[:] = [args, kwargs]
        if not first:
            first[:] = [args, kwargs]

    def lm_post(module, args, out):
        calls[-1][1] = record()
        before = calls[-1][4]
        # the launches of this forward, by counter
        calls[-1][4] = {k: v - before.get(k, 0) for k, v in _build.launches.items()
                        if v != before.get(k, 0)}
        finite.append(torch.isfinite(out[0]).all())

    vis = []
    hooks = [agent.llama.register_forward_pre_hook(lm_pre, with_kwargs=True),
             agent.llama.register_forward_hook(lm_post),
             agent.vision.register_forward_pre_hook(lambda m, a: vis.append(record())),
             agent.projector.register_forward_hook(lambda m, a, o: vis.append(record()))]

    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, hw + (3,), dtype=np.uint8) for hw in CAPTION_IMAGES]
    _build.launches.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    captions = agent.caption_batch(images, seed=0)
    end = record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = dict(_build.launches)
    for h in hooks:
        h.remove()

    n_prompt = caption_prompt_len(tok)
    n_fwd = len(calls)
    if calls[0][2] != n_prompt or any(c[2] != 1 for c in calls[1:]):
        fail(f"prompt length {calls[0][2]}, expected {n_prompt}")
    if calls[0][2] * calls[0][3] != caption_prefill_m():
        fail(f"prefill rows {calls[0][2]} x {calls[0][3]} are not the M check_nf4 held")
    if not bool(torch.stack(finite).all()):
        fail("caption logits are not finite")
    if len(captions) != 2 or len(tok.decoded) != 2:
        fail(f"{len(captions)} captions")
    for ids in tok.decoded:
        if not ids or not all(0 <= i < 32000 for i in ids):
            fail(f"caption tokens out of range or empty: {ids[:10]}")
    if n_fwd < 2 or n_fwd > CAPTION_NEW_TOKENS:
        fail(f"{n_fwd} forward passes")
    if quant == "nf4":
        if counts != {"nf4_matmul": NF4_PER_FORWARD * n_fwd, "nf4_gemm": NF4_PER_FORWARD,
                      "nf4_gemv": NF4_PER_FORWARD * (n_fwd - 1)}:
            fail(f"launch counts {counts}, expected nf4_matmul = {NF4_PER_FORWARD} x "
                 f"{n_fwd}, nf4_gemm {NF4_PER_FORWARD} (prefill), the rest nf4_gemv")
        check_forward_routes(calls, NF4_PER_FORWARD, label)
    elif counts:
        fail(f"{label}: launch counts {counts}, expected none (no NF4 projection; "
             f"the prompt is under the flash gate)")
    prefill_ms = calls[0][0].elapsed_time(calls[0][1])
    decode_ms = calls[0][1].elapsed_time(end)
    n_decode = n_fwd - 1
    result = dict(
        build_s=build_s, wall_s=wall_s,
        vision_projector_ms=vis[0].elapsed_time(vis[1]),
        prefill_ms=prefill_ms, prompt_len=n_prompt, batch=len(images),
        decode_steps=n_decode, decode_ms_per_step=decode_ms / n_decode,
        decode_forward_ms_per_step=sum(c[0].elapsed_time(c[1]) for c in calls[1:]) / n_decode,
        tokens_per_s=len(images) * n_decode / (decode_ms / 1e3),
        lengths=[len(ids) for ids in tok.decoded],
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        launches=counts)
    print(label, json.dumps(result), flush=True)
    for c in captions:
        print(f"  caption ({len(c)} chars): {c[:100]!r}", flush=True)
    # the prefill and the last decode step once more (their cache slots are
    # rewritten in place with the same values)
    if quant == "nf4":
        profile_call(torch, "profile_prefill", agent.llama, *first)
        profile_call(torch, "profile_decode", agent.llama, *last)
    else:
        profile_call(torch, f"profile_decode_{quant}", agent.llama, *last)
    del first, last
    return counts, agent


def check_forward_routes(calls, per_forward: int, label: str) -> None:
    """Each forward's NF4 launches (the last item of each `calls` row, a
    dict by counter): `per_forward` on the prefill route for the first
    forward and on the decode route for every later one."""
    prefill_routes = {"nf4_matmul": per_forward, "nf4_gemm": per_forward}
    decode_routes = {"nf4_matmul": per_forward, "nf4_gemv": per_forward}
    if calls[0][-1] != prefill_routes or any(c[-1] != decode_routes for c in calls[1:]):
        fail(f"{label}: per-forward launches: prefill {calls[0][-1]}, decode "
             f"{[c[-1] for c in calls[1:] if c[-1] != decode_routes][:3]}")


def llama_vocab_pieces(size: int = 32000):
    """A synthetic LLaMA-sized SentencePiece vocabulary, (piece, score,
    type) in id order: `<unk>` / `<s>` / `</s>` at 0 / 1 / 2, the 256 byte
    pieces, then normal pieces by falling score: the words of the caption
    prompt with `▁` and every prefix of them (so BPE reaches each), single
    characters, then two- and three-letter pieces with and without `▁`."""
    import itertools

    from faithdiff_tpu_torch.captioner.agent import (DEFAULT_QUESTION,
                                                     build_vicuna_prompt)
    from faithdiff_tpu_torch.captioner.llama_tokenizer import (BYTE, CONTROL,
                                                               NORMAL, UNKNOWN)

    pieces = [("<unk>", 0.0, UNKNOWN), ("<s>", 0.0, CONTROL), ("</s>", 0.0, CONTROL)]
    pieces += [(f"<0x{b:02X}>", 0.0, BYTE) for b in range(256)]
    normal = {}
    for word in re.findall(r"\w+|[^\w\s]", " ".join(build_vicuna_prompt(DEFAULT_QUESTION))):
        for w in ("▁" + word, word):
            for k in range(2, len(w) + 1):
                normal.setdefault(w[:k], None)
    letters = "abcdefghijklmnopqrstuvwxyz"
    for c in "▁" + letters + letters.upper() + "0123456789.,:;!?'\"-()/&":
        normal.setdefault(c, None)
    for n in (2, 3):
        for combo in itertools.product(letters, repeat=n):
            for w in ("".join(combo), "▁" + "".join(combo)):
                normal.setdefault(w, None)
    names = list(normal)[:size - len(pieces)]
    return pieces + [(w, -float(i), NORMAL) for i, w in enumerate(names)]


def write_llava_reference(torch, root: str, layers: int) -> dict:
    """Seeded weights of LLaVA-1.5-13B at full width and `layers` LLaMA
    layers, in the reference's released layout under `root`:
    `llava-v1.5-13b/pytorch_model-0000{1,2}-of-00002.bin` (fp16; the
    embedding and the layers, with transformers' rotary tables, in the
    first, the final norm, `lm_head` and `model.mm_projector.*` in the
    second) with `pytorch_model.bin.index.json`, a 32000-piece
    `tokenizer.model` with `tokenizer_config.json` and
    `special_tokens_map.json`, and `clip-vit-large-patch14-336/
    pytorch_model.bin` (a whole CLIPModel, fp16: the ViT-L/14-336 vision
    tower, a seeded text tower, the projections, `logit_scale`).
    Returns {"llama", "projector", "vision": the written state dicts on the
    card, "sizes": {file: bytes}}."""
    import dataclasses

    from faithdiff_tpu_torch.captioner.clip_vision import (CLIPVisionConfig,
                                                           CLIPVisionTower,
                                                           VisionProjector)
    from faithdiff_tpu_torch.captioner.llama import LlamaConfig, LlamaForCausalLM
    from faithdiff_tpu_torch.captioner.llama_tokenizer import save_sentencepiece_model
    from faithdiff_tpu_torch.config import CLIPTextConfig
    from faithdiff_tpu_torch.models.clip_text import CLIPTextTower
    from faithdiff_tpu_torch.pipelines.factory import random_init_

    cfg = dataclasses.replace(LlamaConfig.llava_13b(), num_hidden_layers=layers)
    vcfg = CLIPVisionConfig()
    gen = torch.Generator(device="cuda").manual_seed(12)
    with torch.device("cuda"):
        llama = LlamaForCausalLM(cfg, dtype=torch.float16)
        projector = VisionProjector(cfg.hidden_size, vcfg.hidden_size, dtype=torch.float16)
        vision = CLIPVisionTower(vcfg, dtype=torch.float16)
        text = CLIPTextTower(dataclasses.replace(CLIPTextConfig(), projection_dim=768),
                             dtype=torch.float16)
    written = {}
    for name, model in (("llama", llama), ("projector", projector), ("vision", vision),
                        ("text", text)):
        random_init_(model, gen)
        written[name] = {k: v.half() for k, v in model.state_dict().items()}
        del model
    del llama, projector, vision, text
    llava = os.path.join(root, "llava-v1.5-13b")
    os.makedirs(llava)
    head = cfg.hidden_size // cfg.num_attention_heads
    inv_freq = 1.0 / 10000 ** (torch.arange(0, head, 2, dtype=torch.float32) / head)
    first = {k: v for k, v in written["llama"].items() if k.startswith("model.layers.")
             or k == "model.embed_tokens.weight"}
    first.update({f"model.layers.{i}.self_attn.rotary_emb.inv_freq": inv_freq
                  for i in range(layers)})
    second = {k: v for k, v in written["llama"].items() if k not in first}
    second.update({f"model.mm_projector.{k}": v for k, v in written["projector"].items()})
    shards = {"pytorch_model-00001-of-00002.bin": first,
              "pytorch_model-00002-of-00002.bin": second}
    for name, sd in shards.items():
        torch.save({k: v.cpu() for k, v in sd.items()}, os.path.join(llava, name))
    with open(os.path.join(llava, "pytorch_model.bin.index.json"), "w") as f:
        json.dump({"metadata": {}, "weight_map": {k: name for name, sd in shards.items()
                                                  for k in sd}}, f)
    save_sentencepiece_model(os.path.join(llava, "tokenizer.model"), llama_vocab_pieces())
    with open(os.path.join(llava, "tokenizer_config.json"), "w") as f:
        json.dump({"add_bos_token": True, "add_eos_token": False, "legacy": False,
                   "clean_up_tokenization_spaces": False, "model_max_length": 2048,
                   "tokenizer_class": "LlamaTokenizer"}, f)
    with open(os.path.join(llava, "special_tokens_map.json"), "w") as f:
        json.dump({"bos_token": "<s>", "eos_token": "</s>", "unk_token": "<unk>",
                   "pad_token": "<unk>"}, f)
    clip_dir = os.path.join(root, "clip-vit-large-patch14-336")
    os.makedirs(clip_dir)
    clip = dict(written["vision"])
    clip.update(written.pop("text"))
    d = vcfg.hidden_size
    clip.update({
        "vision_model.post_layernorm.weight": torch.ones(d, dtype=torch.float16),
        "vision_model.post_layernorm.bias": torch.zeros(d, dtype=torch.float16),
        "vision_model.embeddings.position_ids": torch.arange(vcfg.num_patches + 1)[None],
        "text_model.embeddings.position_ids": torch.arange(77)[None],
        "visual_projection.weight": torch.randn((768, d), generator=gen, device="cuda",
                                                dtype=torch.float16) * d ** -0.5,
        "logit_scale": torch.tensor(4.6052)})
    torch.save({k: v.cpu() for k, v in clip.items()},
               os.path.join(clip_dir, "pytorch_model.bin"))
    sizes = {os.path.relpath(os.path.join(dp, f), root):
             os.path.getsize(os.path.join(dp, f))
             for dp, _, files in os.walk(root) for f in files}
    return dict(written, sizes=sizes)


class ForwardWatch:
    """Forward hooks on a captioner's LLaMA: each forward's rows (sequence
    length, batch) and the counted launches it made."""

    def __init__(self, llama):
        from faithdiff_tpu_torch.ops import _build

        self.calls, self._build = [], _build
        self.handles = [llama.register_forward_pre_hook(self._pre),
                        llama.register_forward_hook(self._post)]

    def _pre(self, module, args):
        self.calls.append([args[0].shape[1], args[0].shape[0],
                           dict(self._build.launches)])

    def _post(self, module, args, out):
        before = self.calls[-1][-1]
        self.calls[-1][-1] = {k: v - before.get(k, 0)
                              for k, v in self._build.launches.items()
                              if v != before.get(k, 0)}

    def remove(self):
        for h in self.handles:
            h.remove()


def run_cli_caption(torch, root: str) -> dict:
    """`cli_caption`: seeded LLaVA-1.5-13B weights at full width and
    CLI_CAPTION_LAYERS layers (a cut for disk space) written in the
    reference's layout, converted by `convert_cli --llava --clip_vision`,
    then `cli.main(["caption", ...])` on two seeded PNGs (int8, the CLI's
    default): the buffers it loads equal `quantize_llama_params(..., "int8")`
    of the written weights, each JSON caption equals the in-memory agent's
    on the same weights and tokenizer (one image a call, seed 0), a second
    call skips both images and `--use_bsrnet` gives the same JSON. Then
    `from_checkpoint(load_4bit=True)` on the same directory: its buffers
    equal the "nf4" quantisation, and its caption of one image launches the
    NF4 kernel 7 x CLI_CAPTION_LAYERS times a forward, on the prefill route
    for the prefill and the decode route after it."""
    import dataclasses
    import io

    import numpy as np

    from faithdiff_tpu_torch import cli
    from faithdiff_tpu_torch.captioner import agent as agent_mod
    from faithdiff_tpu_torch.captioner.clip_vision import (CLIPVisionConfig,
                                                           CLIPVisionTower,
                                                           VisionProjector)
    from faithdiff_tpu_torch.captioner.llama import (LlamaConfig, LlamaForCausalLM,
                                                     quantize_llama_params)
    from faithdiff_tpu_torch.captioner.llama_tokenizer import LlamaTokenizer
    from faithdiff_tpu_torch.ops import _build
    from faithdiff_tpu_torch.utils import convert_cli
    from faithdiff_tpu_torch.utils.png import read_png, write_png

    free_gb = shutil.disk_usage(os.path.dirname(root)).free / 1e9
    print(f"cli_caption: {free_gb:.1f} GB free beside {root}; the reference files "
          "take ~6.6 GB and the converted copy as much again", flush=True)
    cfg = dataclasses.replace(LlamaConfig.llava_13b(), num_hidden_layers=CLI_CAPTION_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ref = write_llava_reference(torch, root, CLI_CAPTION_LAYERS)
    t1 = time.perf_counter()
    out_dir = os.path.join(root, "converted")
    convert_cli.main(["--llava", os.path.join(root, "llava-v1.5-13b"),
                      "--clip_vision", os.path.join(root, "clip-vit-large-patch14-336",
                                                    "pytorch_model.bin"),
                      "--out_dir", out_dir])
    t2 = time.perf_counter()
    cap_dir = os.path.join(out_dir, "captioner")

    rng = np.random.default_rng(13)
    img_dir = os.path.join(root, "in")
    os.makedirs(img_dir)
    names = [f"photo_{i}" for i in range(len(CAPTION_IMAGES))]
    for name, hw in zip(names, CAPTION_IMAGES):
        write_png(os.path.join(img_dir, f"{name}.png"),
                  rng.integers(0, 256, hw + (3,), dtype=np.uint8))

    load = agent_mod.CaptionAgent.from_checkpoint
    loaded = []

    def watched(ckpt_dir, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        agent = load(ckpt_dir, llama_config=cfg, **kw)
        torch.cuda.synchronize()
        loaded.append((agent, time.perf_counter() - t))
        return agent

    def caption_cli(save_dir, *extra):
        out = io.StringIO()
        agent_mod.CaptionAgent.from_checkpoint = staticmethod(watched)
        try:
            with contextlib.redirect_stdout(out):
                rc = cli.main(["caption", "--img_dir", img_dir, "--save_dir", save_dir,
                               "--captioner_dir", cap_dir, *extra])
        finally:
            agent_mod.CaptionAgent.from_checkpoint = staticmethod(load)
        print(out.getvalue(), end="", flush=True)
        if rc != 0:
            fail(f"cli caption returned {rc}")
        agent, load_s = loaded.pop()
        captions = {}
        for name in names:
            path = os.path.join(save_dir, f"{name}.json")
            with open(path) as f:
                captions[name] = json.load(f)
        return agent, load_s, out.getvalue(), captions

    _build.launches.clear()
    cli_agent, load_s, log, captions = caption_cli(os.path.join(root, "caps"))
    caption_s = [float(x) for x in re.findall(r"caption_s=([0-9.]+)", log)]
    if len(caption_s) != len(names) or _build.launches:
        fail(f"cli_caption: {len(caption_s)} captions, launches {dict(_build.launches)}")

    # the buffers the CLI loaded are the int8 quantisation of the written weights
    def check_buffers(agent, mode):
        want = quantize_llama_params(ref["llama"], mode)
        got = agent.llama.state_dict()
        if sorted(got) != sorted(want):
            fail(f"cli_caption: {mode} keys differ: {sorted(set(got) ^ set(want))[:4]}")
        bad = [k for k in want if not torch.equal(got[k], want[k].to(got[k].dtype))]
        for name, module in (("projector", agent.projector), ("vision", agent.vision)):
            sd = module.state_dict()
            bad += [f"{name}.{k}" for k, v in ref[name].items()
                    if not torch.equal(sd[k], v.to(sd[k].dtype))]
        if bad:
            fail(f"cli_caption: {len(bad)} {mode} buffers differ, e.g. {bad[:3]}")
        return len(want)

    n_int8 = check_buffers(cli_agent, "int8")
    del cli_agent
    # the in-memory agent on the same weights and tokenizer
    with torch.device("cuda"):
        llama = LlamaForCausalLM(dataclasses.replace(cfg, quant="int8"), dtype=torch.bfloat16)
        vision = CLIPVisionTower(CLIPVisionConfig(), dtype=torch.bfloat16)
        projector = VisionProjector(cfg.hidden_size, CLIPVisionConfig().hidden_size,
                                    dtype=torch.bfloat16)
    llama.load_state_dict(quantize_llama_params(ref["llama"], "int8"))
    vision.load_state_dict(ref["vision"])
    projector.load_state_dict(ref["projector"])
    for m in (llama, vision, projector):
        m.eval().requires_grad_(False)
    agent = agent_mod.CaptionAgent(llama=llama, vision=vision, projector=projector,
                                   tokenizer=LlamaTokenizer.from_pretrained(
                                       os.path.join(root, "llava-v1.5-13b")))
    in_memory_s = []
    for name in names:
        t = time.perf_counter()
        want = agent.caption(read_png(os.path.join(img_dir, f"{name}.png")), seed=0)
        in_memory_s.append(time.perf_counter() - t)
        if captions[name] != {"caption": want}:
            fail(f"cli_caption: {name}: the CLI wrote {captions[name]!r}, the in-memory "
                 f"agent gave {want!r}")
    del agent, llama, vision, projector
    torch.cuda.empty_cache()

    _, _, log, again = caption_cli(os.path.join(root, "caps"))
    if log.count("skip ") != len(names) or again != captions:
        fail(f"cli_caption: a second call did not skip both images: {log!r}")
    _, _, log, bsr = caption_cli(os.path.join(root, "caps_bsrnet"), "--use_bsrnet")
    if "--use_bsrnet is not applied" not in log or bsr != captions:
        fail("cli_caption: --use_bsrnet changed the captions or gave no warning")
    torch.cuda.empty_cache()

    # the same directory at load_4bit: the NF4 kernel on both routes
    t = time.perf_counter()
    nf4 = agent_mod.CaptionAgent.from_checkpoint(cap_dir, load_4bit=True, llama_config=cfg)
    torch.cuda.synchronize()
    nf4_load_s = time.perf_counter() - t
    n_nf4 = check_buffers(nf4, "nf4")
    watch = ForwardWatch(nf4.llama)
    _build.launches.clear()
    t = time.perf_counter()
    nf4_caption = nf4.caption(read_png(os.path.join(img_dir, f"{names[0]}.png")), seed=0)
    torch.cuda.synchronize()
    nf4_caption_s = time.perf_counter() - t
    watch.remove()
    per_forward = 7 * CLI_CAPTION_LAYERS
    n_fwd = len(watch.calls)
    nf4_launches = dict(_build.launches)
    if nf4_launches != {"nf4_matmul": per_forward * n_fwd, "nf4_gemm": per_forward,
                        "nf4_gemv": per_forward * (n_fwd - 1)}:
        fail(f"cli_caption: nf4 launches {nf4_launches} over {n_fwd} forwards")
    check_forward_routes(watch.calls, per_forward, "cli_caption nf4")
    del nf4, watch
    result = dict(
        free_disk_gb=free_gb, layers=CLI_CAPTION_LAYERS, file_bytes=ref["sizes"],
        write_weights_s=t1 - t0, convert_s=t2 - t1, load_s=load_s,
        caption_s=caption_s, in_memory_caption_s=in_memory_s,
        buffers_checked_int8=n_int8, identical_to_in_memory=True, second_call_skipped=True,
        use_bsrnet_same=True, nf4_load_s=nf4_load_s, buffers_checked_nf4=n_nf4,
        nf4_caption_s=nf4_caption_s, nf4_forwards=n_fwd,
        nf4_launches_per_forward=per_forward, nf4_launches=nf4_launches,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        caption_chars=[len(c["caption"]) for c in captions.values()])
    print("cli_caption", json.dumps(result), flush=True)
    for name in names:
        print(f"  {name}: {captions[name]['caption'][:100]!r}", flush=True)
    print(f"  nf4 {names[0]}: {nf4_caption[:100]!r}", flush=True)
    files = dict(cap_dir=cap_dir, img_dir=img_dir, names=names,
                 captions={n: c["caption"] for n, c in captions.items()})
    return result, files


def check_bsrnet(torch) -> dict:
    """`bsrnet`: the full-width RRDBNet (nf 64, nb 23, gc 32, x4) in bf16 on
    the card, seeded; `deg_remove` of a BSRNET_PIXELS image in [0, 1]
    (512 px tiles, 16 px halo): the output shape, finite values, the tile
    count, and one 64x64 crop in bf16 on the card against fp32 on the CPU."""
    import numpy as np

    from faithdiff_tpu_torch.models.bsrnet import RRDBNet, deg_remove
    from faithdiff_tpu_torch.pipelines.factory import random_init_

    with torch.device("cuda"):
        model = RRDBNet(dtype=torch.bfloat16).eval().requires_grad_(False)
    random_init_(model, torch.Generator(device="cuda").manual_seed(14))
    h, w = BSRNET_PIXELS
    rng = np.random.default_rng(15)
    img = torch.from_numpy(rng.integers(0, 256, (1, 3, h, w), dtype=np.uint8)).cuda() / 255.0
    tiles = []
    hook = model.register_forward_hook(lambda m, a, o: tiles.append(tuple(a[0].shape)))
    deg_remove(model, img[:, :, :600, :600])                     # warm-up: 2 x 2 tiles
    tiles.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    out = deg_remove(model, img)
    end.record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    hook.remove()
    if tuple(out.shape) != (1, 3, 4 * h, 4 * w) or not bool(torch.isfinite(out).all()):
        fail(f"bsrnet: output {tuple(out.shape)}, finite {bool(torch.isfinite(out).all())}")
    if len(tiles) != BSRNET_TILES:
        fail(f"bsrnet: {len(tiles)} tiles, expected {BSRNET_TILES}")
    crop = img[:, :, :64, :64]
    cpu = RRDBNet().eval().requires_grad_(False)
    cpu.load_state_dict({k: v.float().cpu() for k, v in model.state_dict().items()})
    with torch.no_grad():
        got = model(crop.bfloat16()).float().cpu()
        want = cpu(crop.cpu())
    err = (got - want).abs()
    max_ref, mean_ref = float(want.abs().max()), float(want.abs().mean())
    ok = (float(err.max()) <= BSRNET_TOL * max_ref
          and float(err.mean()) <= BSRNET_MEAN_TOL * mean_ref)
    result = dict(pixels=[h, w], out=list(out.shape), tiles=len(tiles),
                  tile_shapes=sorted(set(tiles)), wall_s=wall_s,
                  ms_per_tile=start.elapsed_time(end) / len(tiles),
                  peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                  crop_max_abs_err=float(err.max()), crop_mean_abs_err=float(err.mean()),
                  crop_max_ref=max_ref, crop_mean_ref=mean_ref,
                  tol=f"max {BSRNET_TOL} x max|ref|, mean {BSRNET_MEAN_TOL} x mean|ref|",
                  ok=ok)
    print("bsrnet", json.dumps(result), flush=True)
    if not ok:
        fail(f"bsrnet: bf16 crop off fp32 by {float(err.max())} (max), "
             f"{float(err.mean())} (mean)")
    del model, out, img
    torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------------------
# training: the kernels under autograd, stages 1 and 2 at full width, and
# `cli.py train`
# ---------------------------------------------------------------------------

TRAIN_RES = 512
# flash BHSD: the stage-1 UNet self-attention at 32^2 latents (batch 16)
# and a 4096-token case at the stage-2 batch, and the causal d = 128 case
# of caption training (2 sequences of 1024 tokens); packed: the same 1024-token
# attention on the packed path; GroupNorm: a UNet ResNet norm at 64^2
# latents (single pass) and the denoise encoder's first norm at 512 px
# (two passes: its group outgrows a cluster)
TRAIN_ATTN_SHAPES = [((16, 10, 1024, 64), False), ((2, 10, 4096, 64), False),
                     ((2, 40, 1024, 128), True)]
TRAIN_PACKED = ((16, 1024, 640), 10)
TRAIN_GN = [((16, 320, 64, 64), 1e-5, "silu", True, "fused"),
            ((2, 128, 512, 512), 1e-6, "silu", False, "two_pass")]
# the JAX stage defaults (batch, accum, remat); stage 1 falls back to the
# largest batch that fits in TRAIN_FALLBACK_BATCHES
STAGE1, STAGE2 = (16, 4, False), (2, 16, True)
TRAIN_FALLBACK_BATCHES = (12, 8, 6, 4, 2)
TRAIN_COUNTERS = ("flash_attention_fwd", "flash_attention_bsnd_fwd",
                  "flash_attention_f32_fwd", "flash_attention_f32_bsnd_fwd",
                  "attention_variant_fwd", "group_norm_fused",
                  "group_norm_stats", "group_norm_apply", "nf4_matmul")


def check_train_autograd(torch):
    """The three entry points under autograd in bf16 at the training path's
    shapes: the forward equal in every bit to the bare kernel call and
    within 1e-2 + 8e-3*|ref| of the plain version (as in the restore
    checks: bf16 roundings at other points), one launch a forward and none
    in the backward. A Function's backward is autograd over the plain
    version on the saved inputs with autocast off, so every gradient must
    equal, bit for bit, autograd over the plain version on the same
    inputs; max|err| is printed beside it. Kernel forward and backward ms."""
    from faithdiff_tpu_torch.utils.profiling import time_ms
    from faithdiff_tpu_torch.ops import _build
    from faithdiff_tpu_torch.ops import attention as A
    from faithdiff_tpu_torch.ops import groupnorm as G

    gen = torch.Generator(device="cuda").manual_seed(5)

    def leaf(shape, dtype=torch.bfloat16, offset=0.0, scale=1.0):
        t = torch.randn(shape, generator=gen, device="cuda") * scale + offset
        return t.to(dtype).requires_grad_(True)

    def run(label, entry, bare, plain, inputs, counters):
        _build.launches.clear()
        out = entry(*inputs)
        torch.cuda.synchronize()
        fwd_launches = {c: _build.launches[c] for c in counters}
        with torch.no_grad():
            same = torch.equal(out, bare(*inputs))
        g = torch.randn(out.shape, generator=gen, device="cuda").to(out.dtype)
        wrt = [t for t in inputs if t is not None]
        _build.launches.clear()
        grads = torch.autograd.grad(out, wrt, g, retain_graph=True)
        bwd_launches = sum(_build.launches.values())
        leaves = [t.detach().requires_grad_(True) for t in wrt]
        it = iter(leaves)
        plain_inputs = [None if t is None else next(it) for t in inputs]
        plain_out = plain(*plain_inputs)
        ref = plain_out.detach().float()
        fwd_err = (out.detach().float() - ref).abs()
        fwd_ok = (bool((fwd_err <= 1e-2 + 8e-3 * ref.abs()).all())
                  and bool(torch.isfinite(out).all()))
        fwd_err = float(fwd_err.max())
        del ref
        refs = torch.autograd.grad(plain_out, leaves, g)
        del plain_out
        grads_equal = [torch.equal(a, b) for a, b in zip(grads, refs)]
        errs = [((a.float() - b.float()).abs().max().item(),
                 b.float().abs().max().item()) for a, b in zip(grads, refs)]
        ok = (same and fwd_ok and all(n == 1 for n in fwd_launches.values())
              and bwd_launches == 0 and all(grads_equal))
        with torch.no_grad():
            fwd_ms = time_ms(lambda: bare(*inputs), 5)
        bwd_ms = time_ms(lambda: torch.autograd.grad(
            out, wrt, g, retain_graph=True), 3, 1)
        row = dict(check="train_autograd", kernel=label,
                   shapes=[list(t.shape) for t in wrt], same_forward=same,
                   forward_max_abs_err=fwd_err, forward_tol="1e-2 + 8e-3*|ref|",
                   forward_launches=fwd_launches, backward_launches=bwd_launches,
                   grads_equal=grads_equal, grad_max_err=[e for e, _ in errs],
                   grad_max_ref=[m for _, m in errs], kernel_forward_ms=fwd_ms,
                   backward_ms=bwd_ms, ok=ok)
        print(json.dumps(row), flush=True)
        del out, grads, refs
        return row

    rows = []
    for shape, causal in TRAIN_ATTN_SHAPES:
        q, k, v = (leaf(shape) for _ in range(3))
        scale = shape[-1] ** -0.5
        rows.append(run(
            "flash_attention_causal" if causal else "flash_attention",
            lambda q, k, v: A.flash_attention(q, k, v, scale, causal),
            lambda q, k, v: A._flash_attention_launch(q, k, v, scale, causal),
            lambda q, k, v: A.attention_reference(q, k, v, scale, causal),
            [q, k, v], ("flash_attention_fwd",)))
    shape, heads = TRAIN_PACKED
    q, k, v = (leaf(shape) for _ in range(3))
    rows.append(run(
        "flash_attention_packed",
        lambda q, k, v: A.flash_attention_packed(q, k, v, heads, 0.125),
        lambda q, k, v: A._flash_packed_launch(q, k, v, heads, 0.125),
        lambda q, k, v: A.einsum_bsnd(q, k, v, heads, 0.125),
        [q, k, v], ("flash_attention_bsnd_fwd",)))
    for shape, eps, act, with_add, route in TRAIN_GN:
        plan = G.plan_group_norm(shape, 2, 32)
        if plan.route != route:
            fail(f"train_autograd: {shape} plans {plan.route}, expected {route}")
        x = leaf(shape, scale=2.0, offset=0.5)
        s = leaf(shape[1], torch.float32, offset=1.0, scale=0.1)
        b = leaf(shape[1], torch.float32, scale=0.1)
        a = leaf(shape[:2]) if with_add else None
        rows.append(run(
            f"group_norm_{route}",
            lambda x, s, b, a: G.group_norm(x, s, b, 32, eps, act, a),
            lambda x, s, b, a: G.GroupNormLaunch(x, s, b, 32, eps, act, a).run(),
            lambda x, s, b, a: G.group_norm_reference(x, s, b, 32, eps, act, a),
            [x, s, b, a], plan.counters))
        del x, s, b, a
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def nonzero_adapters_(torch, unet, seed: int) -> None:
    """The fusion adapters without their zero init (weights N(0, 1/fan_in),
    biases 0.1 N(0, 1), norm weights 1 + 0.1 N(0, 1)), so that every
    trainable tensor, and in stage 2 the denoise encoder behind them, gets
    a nonzero gradient."""
    from faithdiff_tpu_torch.training.train import _ADAPTER_KEYS, flax_module_of

    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for name, p in unet.named_parameters():
            if flax_module_of(name) not in _ADAPTER_KEYS:
                continue
            noise = torch.randn(p.shape, generator=gen, device=p.device)
            if p.ndim > 1:
                p.copy_(noise * p[0].numel() ** -0.5)
            elif name.endswith("bias"):
                p.copy_(0.1 * noise)
            else:
                p.copy_(1 + 0.1 * noise)


def checksums(torch, tensors):
    """One int64 per tensor: the sum of its bit patterns (as integers of
    its element's width), which any change of a bit moves (barring an
    exact cancellation)."""
    view = {1: torch.uint8, 2: torch.int16, 4: torch.int32}
    return torch.stack([t.detach().view(view[t.element_size()])
                        .sum(dtype=torch.int64) for t in tensors]).cpu()


class TrainWatch:
    """Forward pre-hooks for a training run: each self-attention (attn1)
    call at >= 1024 tokens, which must be one flash launch, and each
    GroupNorm call's plan, whose counters it must add to; recomputed
    forwards under checkpointing run the hooks again."""

    def __init__(self, torch, models):
        from faithdiff_tpu_torch.models.layers import GroupNorm
        from faithdiff_tpu_torch.models.transformer2d import BasicTransformerBlock
        from faithdiff_tpu_torch.ops.groupnorm import plan_group_norm

        self.expected = {}

        def add(name):
            self.expected[name] = self.expected.get(name, 0) + 1

        def attn_hook(module, args):
            if args[0].shape[1] >= 1024:
                add("flash_attention_fwd")

        def gn_hook(module, args):
            x = args[0]
            for name in plan_group_norm(tuple(x.shape), x.element_size(),
                                        module.num_groups,
                                        x.data_ptr() % 16 == 0).counters:
                add(name)

        self.hooks = []
        for model in models:
            for m in model.modules():
                if isinstance(m, BasicTransformerBlock):
                    self.hooks.append(m.attn1.register_forward_pre_hook(attn_hook))
                elif isinstance(m, GroupNorm):
                    self.hooks.append(m.register_forward_pre_hook(gn_hook))

    def remove(self):
        for h in self.hooks:
            h.remove()


def build_train(torch, stage: int, batch: int, accum: int, remat: bool,
                ema_interval: int = 100, data_parallel: bool = False):
    """Full-width UNet, denoise encoder and VAE built on the card from a
    seeded init (fp32 master weights), the adapters without their zero
    init, the stage's TrainState (ZeRO over the process group with
    `data_parallel`) and its bf16 step."""
    from faithdiff_tpu_torch.config import (DenoiseEncoderConfig, TrainConfig,
                                            UNetConfig, VAEConfig)
    from faithdiff_tpu_torch.training import runner
    from faithdiff_tpu_torch.training.train import (init_train_state,
                                                    make_train_step)

    args = runner.parse_args(["--output_dir", "unused", "--seed", "0"])
    t0 = time.perf_counter()
    unet, de, vae = runner.build_models(
        args, UNetConfig(remat=remat), VAEConfig(),
        DenoiseEncoderConfig(remat=remat), torch.device("cuda"))
    nonzero_adapters_(torch, unet, 1)
    cfg = TrainConfig(stage=stage, batch_size_per_device=batch,
                      grad_accum=accum, lr_warmup_steps=0,
                      ema_update_interval=ema_interval)
    state = init_train_state(cfg, unet, de, data_parallel)
    step = make_train_step(unet, de, vae, cfg)
    torch.cuda.synchronize()
    print(f"train_stage{stage}: built in {time.perf_counter() - t0:.1f} s, "
          f"{sum(p.numel() for p in state.trainable().values()) / 1e9:.4f} B "
          "trainable", flush=True)
    return state, step, vae


def train_batches(batch: int):
    from faithdiff_tpu_torch.training.runner import _synthetic_batches

    return _synthetic_batches(batch, TRAIN_RES, 2048, 1280, seed=0)


def fit_stage1_batch(torch, state, step) -> tuple:
    """The largest batch of (STAGE1 batch,) + TRAIN_FALLBACK_BATCHES whose
    micro-step fits the card, and the OOMs met on the way. A failed try
    leaves the state as it was: its gradients are dropped before the
    optimizer could see them."""
    ooms = []
    for batch in (STAGE1[0],) + TRAIN_FALLBACK_BATCHES:
        try:
            gen = torch.Generator().manual_seed(9)
            step(state, next(train_batches(batch)), gen)
            torch.cuda.synchronize()
        except torch.cuda.OutOfMemoryError as e:
            ooms.append(dict(batch=batch, error=str(e).splitlines()[0][:200]))
            for p in state.trainable().values():
                p.grad = None
            gc.collect()
            torch.cuda.empty_cache()
            continue
        # undo the probe's micro-step: drop its gradient, rewind the counts
        for p in state.trainable().values():
            p.grad = None
        state.opt.mini_step, state.step = 0, 0
        return batch, ooms
    fail(f"train_stage1: no batch fits: {ooms}")


def run_train_micro_steps(torch, label, state, step, batch, n, models,
                          profile_at=None):
    """`n` micro-steps on synthetic batches with the launch counters
    cleared first; checks the launches against the hooks' plan and
    returns (per-micro-step trainable and EMA checksums, ms list,
    launches, metrics, profile). Micro-step `profile_at` (0-based) runs
    under torch.profiler (its trace split by `trace_split`; its ms are
    kept out of the list)."""
    from faithdiff_tpu_torch.ops import _build
    from faithdiff_tpu_torch.utils import profiling

    batches = train_batches(batch)
    gen = torch.Generator().manual_seed(1)
    params = list(state.trainable().values())
    sums = [checksums(torch, params)]
    ema_sums = [checksums(torch, list(state.ema.params.values()))]
    watch = TrainWatch(torch, models)
    ms, metrics, split = [], [], None
    _build.launches.clear()
    torch.cuda.reset_peak_memory_stats()
    try:
        for i in range(n):
            b = next(batches)
            torch.cuda.synchronize()
            if i == profile_at:
                log_dir = os.path.join(_build.BUILD_DIR, label)
                with profiling.trace(log_dir):
                    t0 = time.perf_counter()
                    m = step(state, b, gen)
                    torch.cuda.synchronize()
                    wall_ms = (time.perf_counter() - t0) * 1e3
                split = dict(trace_split(torch, os.path.join(log_dir, "trace.json")),
                             micro_step=i + 1,
                             profiled_wall_ms=wall_ms)
            else:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                m = step(state, b, gen)
                end.record()
                torch.cuda.synchronize()
                ms.append(start.elapsed_time(end))
            metrics.append({k: float(v) for k, v in m.items()})
            sums.append(checksums(torch, params))
            ema_sums.append(checksums(torch, list(state.ema.params.values())))
    finally:
        watch.remove()
    launches = {k: _build.launches[k] for k in TRAIN_COUNTERS}
    expected = {k: watch.expected.get(k, 0) for k in TRAIN_COUNTERS}
    if launches != expected:
        fail(f"{label}: launches {launches}, expected {expected}")
    if not expected["flash_attention_fwd"]:
        fail(f"{label}: no self-attention reached the flash kernel")
    for i, m in enumerate(metrics):
        if not (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
                and m["grad_norm"] > 0):
            fail(f"{label}: micro-step {i + 1} metrics {m}")
    return sums, ema_sums, ms, launches, metrics, split


def changed_at(sums) -> list:
    """For each micro-step, how many tensors changed."""
    return [int((b != a).sum()) for a, b in zip(sums, sums[1:])]


def run_train_stage1(torch) -> dict:
    """Stage 1 at the JAX defaults (batch 16, accum 4, remat off), or the
    largest batch that fits: one optimizer step plus one micro-step.
    Frozen tensors keep every bit; every adapter tensor, spatial_ch_projs
    included, changes at the 4th micro-step and at no other."""
    batch, accum, remat = STAGE1
    state, step, vae = build_train(torch, 1, batch, accum, remat)
    frozen = [p for m in (state.unet, state.denoise_encoder)
              for p in m.parameters() if not p.requires_grad]
    frozen_before = checksums(torch, frozen)
    names = list(state.trainable())
    if not any(n.startswith("unet.spatial_ch_projs.") for n in names):
        fail("train_stage1: spatial_ch_projs is not trainable")
    fit, ooms = fit_stage1_batch(torch, state, step)
    sums, _, ms, launches, metrics, _ = run_train_micro_steps(
        torch, "train_stage1", state, step, fit, accum + 1,
        (state.unet, state.denoise_encoder, vae))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    changed = changed_at(sums)
    if changed != [0] * (accum - 1) + [len(names), 0]:
        fail(f"train_stage1: tensors changed per micro-step {changed}, "
             f"expected {len(names)} at micro-step {accum} only")
    if not torch.equal(frozen_before, checksums(torch, frozen)):
        fail("train_stage1: a frozen tensor changed")
    per_step = {k: v // (accum + 1) for k, v in launches.items()}
    row = dict(check="train_stage1", batch=fit, default_batch=batch,
               ooms=ooms, grad_accum=accum, remat=remat, res=TRAIN_RES,
               trainable_tensors=len(names), frozen_tensors=len(frozen),
               changed_per_micro_step=changed,
               ms_per_micro_step=ms, ms_median=median(ms[1:]),
               peak_gib=peak, launches_per_micro_step=per_step,
               loss=[m["loss"] for m in metrics],
               grad_norm=[m["grad_norm"] for m in metrics])
    print(json.dumps(row), flush=True)
    return row


def trace_split(torch, path: str) -> dict:
    """Device ms of a training micro-step's trace by phase (the step's
    train_step.forward / .backward / .optimizer ranges, attributing each
    kernel by the host time of its launch), the backward's share spent in
    the plain attention recompute (the `plain_backward:attention_reference`
    and `:einsum_bsnd` ranges, on the launching thread), the GroupNorm
    recompute's, and the device's busy share."""
    from faithdiff_tpu_torch.utils import profiling

    kernels, events = profiling.kernel_events(path)
    launch = {e["args"]["correlation"]: e for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    ranges = [e for e in events if e.get("cat") == "user_annotation"
              and "dur" in e]
    phases = [r for r in ranges if r["name"].startswith("train_step.")]
    plain = {}                      # tid -> sorted (start, end, name)
    for r in ranges:
        if r["name"].startswith("plain_backward:"):
            plain.setdefault(r["tid"], []).append(
                (r["ts"], r["ts"] + r["dur"], r["name"]))
    starts = {tid: [x[0] for x in sorted(v)] for tid, v in plain.items()}
    plain = {tid: sorted(v) for tid, v in plain.items()}

    def phase_of(ev):
        for r in phases:
            if r["ts"] <= ev["ts"] <= r["ts"] + r["dur"]:
                return r["name"].split(".", 1)[1]
        return "other"

    def plain_of(ev):
        spans = plain.get(ev["tid"])
        if not spans:
            return None
        i = bisect.bisect_right(starts[ev["tid"]], ev["ts"]) - 1
        if i >= 0 and spans[i][0] <= ev["ts"] <= spans[i][1]:
            return spans[i][2]
        return None

    split = {"forward": 0.0, "backward": 0.0, "optimizer": 0.0, "other": 0.0}
    recompute = {"attention": 0.0, "group_norm": 0.0}
    for k in kernels:
        ev = launch.get(k["args"].get("correlation"))
        ms = k["dur"] / 1e3
        split[phase_of(ev) if ev else "other"] += ms
        sub = plain_of(ev) if ev else None
        if sub in ("plain_backward:attention_reference",
                   "plain_backward:einsum_bsnd"):
            recompute["attention"] += ms
        elif sub == "plain_backward:group_norm_plain":
            recompute["group_norm"] += ms
    busy_ms, span_ms = profiling.busy(kernels)
    return dict(device_ms_by_phase=split, kernel_ms=sum(split.values()),
                span_ms=span_ms, busy_share=busy_ms / span_ms,
                backward_plain_attention_ms=recompute["attention"],
                backward_plain_group_norm_ms=recompute["group_norm"],
                plain_attention_share_of_backward=(
                    recompute["attention"] / split["backward"]
                    if split["backward"] else None))


def run_train_stage2(torch) -> dict:
    """Stage 2 at the JAX defaults (batch 2, accum 16, remat on),
    ema_update_interval 1: two optimizer steps, the second boundary under
    torch.profiler (its device time by phase). Every trainable tensor
    changes at each boundary and at no other micro-step; the EMA shadow
    moves at each boundary only."""
    batch, accum, remat = STAGE2
    state, step, vae = build_train(torch, 2, batch, accum, remat,
                                   ema_interval=1)
    n = len(state.trainable())
    sums, ema_sums, ms, launches, metrics, split = run_train_micro_steps(
        torch, "train_stage2", state, step, batch, 2 * accum,
        (state.unet, state.denoise_encoder, vae), profile_at=2 * accum - 1)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    changed = changed_at(sums)
    want = ([0] * (accum - 1) + [n]) * 2
    if changed != want:
        fail(f"train_stage2: tensors changed per micro-step {changed}, "
             f"expected all {n} at each boundary only")
    ema_changed = changed_at(ema_sums)
    if ema_changed[accum - 1] == 0 or ema_changed[2 * accum - 1] == 0 or \
            any(c for i, c in enumerate(ema_changed)
                if i not in (accum - 1, 2 * accum - 1)):
        fail(f"train_stage2: EMA tensors changed per micro-step {ema_changed}")
    if state.ema.step != 2 or state.opt.gradient_step != 2:
        fail(f"train_stage2: EMA step {state.ema.step}, optimizer step "
             f"{state.opt.gradient_step}")
    per_step = {k: v // (2 * accum) for k, v in launches.items()}
    row = dict(check="train_stage2", batch=batch, grad_accum=accum,
               remat=remat, res=TRAIN_RES, trainable_tensors=n,
               changed_per_micro_step=changed, ema_changed=ema_changed,
               ms_per_micro_step=ms, ms_median=median(ms[1:]),
               first_boundary_ms=ms[accum - 1], peak_gib=peak,
               launches_per_micro_step=per_step, profile=split,
               loss=[m["loss"] for m in metrics][:4])
    print(json.dumps(row), flush=True)
    return row


def state_checksums(torch, state) -> dict:
    """Checksums of everything a checkpoint holds."""
    params = [t for m in (state.unet, state.denoise_encoder)
              for t in m.state_dict().values()]
    acc = [p.grad for p in state.trainable().values() if p.grad is not None]
    return dict(params=checksums(torch, params),
                mu=checksums(torch, list(state.opt.mu.values())),
                nu=checksums(torch, list(state.opt.nu.values())),
                acc=checksums(torch, acc) if acc else None,
                ema=checksums(torch, list(state.ema.params.values())),
                counts=(state.step, state.opt.mini_step,
                        state.opt.gradient_step, state.ema.step))


def same_checksums(torch, a: dict, b: dict) -> bool:
    return all((a[k] is None and b[k] is None) or
               (a[k] is not None and b[k] is not None and
                (a[k] == b[k] if k == "counts" else torch.equal(a[k], b[k])))
               for k in a)


def write_train_pngs(root: str, n: int) -> dict:
    """`n` seeded HR / LR PNG pairs (640x768 and 160x192, a 4x pair),
    captions, and two validation PNGs, under `root`."""
    import numpy as np

    from faithdiff_tpu_torch.utils.png import write_png

    rng = np.random.default_rng(3)
    dirs = {k: os.path.join(root, k) for k in ("hr", "lr", "cap", "val")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    for i in range(n):
        lr = rng.integers(0, 256, (160, 192, 3), dtype=np.uint8)
        write_png(os.path.join(dirs["lr"], f"p{i}.png"), lr)
        write_png(os.path.join(dirs["hr"], f"p{i}.png"),
                  np.repeat(np.repeat(lr, 4, 0), 4, 1))
        with open(os.path.join(dirs["cap"], f"p{i}.txt"), "w") as f:
            f.write(f"The image shows a red house number {i}. A cat sits. "
                    "The sky is blue.")
    for i in range(2):
        write_png(os.path.join(dirs["val"], f"v{i}.png"),
                  rng.integers(0, 256, (300, 400, 3), dtype=np.uint8))
    return dirs


def run_cli_train(torch, root: str) -> dict:
    """`cli.main(["train", "--synthetic_data", ...])` at full width (stage
    1): 4 micro-steps with checkpoints every 2 (keeping 2) and a log row
    each, then `--resume_from_checkpoint` to 6: the kept directories, the
    metrics rows, the restored state equal in every checksum to the saved
    one, the steps continuing. Then a run over seeded PNG pairs with
    captions and one validation strip."""
    import numpy as np

    from faithdiff_tpu_torch import cli
    from faithdiff_tpu_torch.training import checkpoint as C
    from faithdiff_tpu_torch.training import runner
    from faithdiff_tpu_torch.training.logging import read_metrics
    from faithdiff_tpu_torch.utils.png import read_png

    out_dir = os.path.join(root, "run")
    common = ["--output_dir", out_dir, "--resolution", str(TRAIN_RES),
              "--train_batch_size", "2", "--grad_accum", "2",
              "--checkpointing_steps", "2", "--checkpoints_total_limit", "2",
              "--log_every", "1", "--lr_warmup_steps", "0"]
    kept, restored = [], []
    main, restore = runner.main, C.CheckpointManager.restore

    def keep_main(argv):
        kept.append(main(argv))
        return kept[-1]

    def watch_restore(self, state, *a, **k):
        out = restore(self, state, *a, **k)
        restored.append(state_checksums(torch, state))
        return out

    runner.main, C.CheckpointManager.restore = keep_main, watch_restore
    times = {}
    try:
        t0 = time.perf_counter()
        if cli.main(["train", "--synthetic_data", "--max_train_steps", "4"]
                    + common) != 0:
            fail("cli_train: train returned nonzero")
        times["train_4_s"] = time.perf_counter() - t0
        saved = state_checksums(torch, kept.pop())
        dirs = sorted(d for d in os.listdir(out_dir) if d.isdigit())
        if dirs != ["2", "4"]:
            fail(f"cli_train: checkpoints {dirs}, expected ['2', '4']")
        t0 = time.perf_counter()
        if cli.main(["train", "--synthetic_data", "--max_train_steps", "6",
                     "--resume_from_checkpoint", "1"] + common) != 0:
            fail("cli_train: resumed train returned nonzero")
        times["resume_to_6_s"] = time.perf_counter() - t0
        final = kept.pop()
        if len(restored) != 1 or not same_checksums(torch, saved, restored[0]):
            fail("cli_train: the restored state differs from the saved one")
        if final.step != 6:
            fail(f"cli_train: resumed run ended at step {final.step}")
        del final
        rows = read_metrics(os.path.join(out_dir, "logs"))
        if [r["step"] for r in rows] != [1, 2, 3, 4, 5, 6] or not all(
                math.isfinite(r["train_loss"]) for r in rows):
            fail(f"cli_train: metrics rows {rows}")
        dirs = sorted(d for d in os.listdir(out_dir) if d.isdigit())
        if dirs != ["4", "6"]:
            fail(f"cli_train: checkpoints after resume {dirs}")
        shutil.rmtree(out_dir)
        gc.collect()
        torch.cuda.empty_cache()

        data = write_train_pngs(os.path.join(root, "data"), 4)
        data_dir = os.path.join(root, "data_run")
        t0 = time.perf_counter()
        if cli.main(["train", "--output_dir", data_dir, "--hr_dir", data["hr"],
                     "--lr_dir", data["lr"], "--caption_dir", data["cap"],
                     "--val_dir", data["val"], "--validation_steps", "1",
                     "--max_train_steps", "1", "--train_batch_size", "2",
                     "--grad_accum", "1", "--log_every", "1",
                     "--lr_warmup_steps", "0", "--resolution",
                     str(TRAIN_RES)]) != 0:
            fail("cli_train: dataset run returned nonzero")
        times["dataset_run_s"] = time.perf_counter() - t0
        kept.clear()
        strip = read_png(os.path.join(data_dir, "validation", "step_1.png"))
        if strip.shape != (TRAIN_RES, 2 * TRAIN_RES, 3):
            fail(f"cli_train: validation strip {strip.shape}")
        rows = read_metrics(os.path.join(data_dir, "logs"))
        if [r["step"] for r in rows] != [1]:
            fail(f"cli_train: dataset run rows {rows}")
    finally:
        runner.main, C.CheckpointManager.restore = main, restore
        kept.clear()
        gc.collect()
        torch.cuda.empty_cache()
    row = dict(check="cli_train", strip_shape=list(strip.shape),
               strip_mean=float(np.asarray(strip, np.float32).mean()), **times)
    print(json.dumps(row), flush=True)
    return row

# ---------------------------------------------------------------------------
# restore options: fp8 weights, Karras sigmas, 16-bit and interlaced PNG
# input, the other schedulers' steps; the degradation engine; captioner
# training; the JPEG probe
# ---------------------------------------------------------------------------

# bf16 values around e4m3fn's top: up to 464 the cast saturates at 448, past
# it (and inf) JAX's cast gives NaN, which the port follows (torch's own
# cast saturates); -0.0 and a subnormal keep their bits
FP8_PROBE = [(0.5, 0.5), (-0.0, -0.0), (2.0 ** -9, 2.0 ** -9), (448.0, 448.0),
             (460.0, 448.0), (464.0, 448.0), (466.0, math.nan),
             (480.0, math.nan), (1e4, math.nan), (math.inf, math.nan),
             (-466.0, math.nan)]
# the steps of the other schedulers: a 4-tile latent batch, on the card
# against the CPU with the same noise
SCHED_SHAPE = (4, 4, 128, 128)
SCHED_TOL = 1e-6                         # x (1 + max|cpu|)
# the stage-1 trainer's batch of GT crops, the engine's defaults
DEG_BATCH, DEG_RES, DEG_PLANS = 16, 512, 10
# the card against the CPU on one plan, TF32 off: most LQ levels agree; a
# level flips where fp32 sums in another order land an 8-bit rounding (or
# a JPEG coefficient's) on the other side of its half
DEG_DIFF_SHARE, DEG_MEAN_TOL = 1e-2, 1e-3
# caption training: LLaVA-1.5-13B's widths and depth, bf16 dense base,
# ViT-L/14-336 frozen, 2 sequences of 1024 tokens (576 of them the image),
# the last 256 tokens the answer; LoRA as LLaVA-1.5's public LoRA finetune
# script sets it (rank 128, alpha 256) on the seven projections
CAPTION_TRAIN_LAYERS, CAPTION_TRAIN_SEQ, CAPTION_TRAIN_BATCH = 40, 1024, 2
CAPTION_TRAIN_ANSWER = 256
CAPTION_TRAIN_STEPS = 3
LORA_RANK, LORA_ALPHA = 128, 256.0
LORA_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                "up_proj", "down_proj")
GRAD_NORM_RTOL = 1e-5


def check_fp8_cast(torch) -> dict:
    """`utils.quantize.to_fp8` on the card at the values around e4m3fn's
    top: saturated up to 464, NaN past it, as the JAX package's cast."""
    from faithdiff_tpu_torch.utils.quantize import to_fp8

    x = torch.tensor([v for v, _ in FP8_PROBE], device="cuda")
    got = to_fp8(x, torch.bfloat16).float().cpu().tolist()
    ok = all((math.isnan(g) and math.isnan(w)) or
             (g == w and math.copysign(1, g) == math.copysign(1, w))
             for g, (_, w) in zip(got, FP8_PROBE))
    # torch's own cast of 480 (448 on the CPU), for the record
    torch_480 = float(x[7:8].to(torch.bfloat16).to(torch.float8_e4m3fn).float())
    return dict(values=[v for v, _ in FP8_PROBE], got=got, ok=ok,
                torch_cast_of_480=torch_480)


def build_fp8_pipeline(torch, pipe):
    """build_pipeline(use_fp8=True) on `pipe`'s weights."""
    from faithdiff_tpu_torch.pipelines import build_pipeline

    return build_pipeline(
        unet_config=pipe.unet.config, vae_config=pipe.vae.config,
        denoise_encoder_config=pipe.denoise_encoder.config,
        pipeline_config=pipe.config, unet_state_dict=pipe.unet.state_dict(),
        vae_state_dict=pipe.vae.state_dict(),
        denoise_encoder_state_dict=pipe.denoise_encoder.state_dict(),
        device="cuda", dtype=torch.bfloat16, use_fp8=True)


def run_restore_fp8(torch, pipe, restore_counts):
    """`restore_fp8`: the 1024x1536 restore with the UNet's weights stored
    in fp8. Its flash and GroupNorm launches must be the bf16 restore's;
    the upcasts a UNet call are counted (one kernel each); one UNet call
    must equal, bit for bit, the call of a bf16 UNet whose weights are the
    fp8 values upcast. Returns the fp8 pipeline."""
    from faithdiff_tpu_torch.models.layers import _Upcast
    from faithdiff_tpu_torch.models.unet import UNet2DConditionModel
    from faithdiff_tpu_torch.utils.quantize import (dequantize_params,
                                                    param_bytes,
                                                    quantize_params_fp8)

    cast = check_fp8_cast(torch)
    print("fp8_cast", json.dumps(cast), flush=True)
    if not cast["ok"]:
        fail(f"restore_fp8: the fp8 cast on the card is not JAX's: {cast}")
    t0 = time.perf_counter()
    pipe8 = build_fp8_pipeline(torch, pipe)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    sd8 = pipe8.unet.state_dict()
    n8 = sum(v.dtype == torch.float8_e4m3fn for v in sd8.values())
    upcasts = [0]

    def count(*_):
        upcasts[0] += 1

    hooks = [m.register_forward_hook(count) for m in pipe8.unet.modules()
             if isinstance(m, _Upcast)]
    counts, (args, kwargs), _ = run_restore(torch, pipe8, packed=False,
                                            label="restore_fp8")
    for h in hooks:
        h.remove()
    if counts != restore_counts:
        fail(f"restore_fp8: launches {counts}, the bf16 restore's {restore_counts}")

    with torch.device("cuda"):
        ref = UNet2DConditionModel(pipe.unet.config)
    ref.load_state_dict(dequantize_params(
        quantize_params_fp8(pipe.unet.state_dict(), torch.bfloat16),
        torch.bfloat16))
    ref.to(torch.bfloat16).eval().requires_grad_(False)
    with torch.no_grad():
        got = pipe8.unet(*args, **kwargs)
        want = ref(*args, **kwargs)
        bitwise = torch.equal(got, want)
        err = float((got.float() - want.float()).abs().max())
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        pipe8.unet(*args, **kwargs)
        end.record()
        torch.cuda.synchronize()
    del ref, got, want
    torch.cuda.empty_cache()
    result = dict(build_s=build_s, unet_fp8_tensors=n8,
                  unet_weight_bytes_fp8=param_bytes(sd8),
                  unet_weight_bytes_bf16=param_bytes(pipe.unet.state_dict()),
                  upcast_launches_per_unet_call=upcasts[0] / STEPS,
                  unet_call_ms=start.elapsed_time(end),
                  bitwise_equal_to_upcast_bf16=bitwise, max_abs_err=err,
                  launches_equal_bf16_restore=True)
    print("restore_fp8_checks", json.dumps(result), flush=True)
    if not bitwise:
        fail(f"restore_fp8: the fp8-stored UNet call is not the upcast call: {err}")
    return pipe8, counts


def run_restore_karras(torch, pipe):
    """`restore_karras`: the 1024x1536 restore with Karras sigmas; the
    sigmas and timesteps it steps through must be the CPU scheduler's."""
    from faithdiff_tpu_torch.config import SchedulerConfig
    from faithdiff_tpu_torch.schedulers import EulerDiscreteScheduler

    cfg = SchedulerConfig(use_karras_sigmas=True)
    karras = EulerDiscreteScheduler(cfg)
    states = []
    set_timesteps = karras.set_timesteps
    karras.set_timesteps = lambda n: states.append(set_timesteps(n)) or states[-1]
    before = pipe.scheduler
    pipe.scheduler = karras
    try:
        counts, _, _ = run_restore(torch, pipe, packed=False, label="restore_karras")
    finally:
        pipe.scheduler = before
    cpu = EulerDiscreteScheduler(cfg).set_timesteps(STEPS)
    plain = EulerDiscreteScheduler(SchedulerConfig()).set_timesteps(STEPS)
    same = (len(states) == 1 and torch.equal(states[0].sigmas, cpu.sigmas)
            and torch.equal(states[0].timesteps, cpu.timesteps))
    print("restore_karras_sigmas", json.dumps(dict(
        sigmas=states[0].sigmas.tolist(), timesteps=states[0].timesteps.tolist(),
        equal_cpu=same, differ_from_default=not torch.equal(cpu.sigmas, plain.sigmas))),
        flush=True)
    if not same or torch.equal(cpu.sigmas, plain.sigmas):
        fail("restore_karras: sigmas not the CPU scheduler's Karras sigmas")
    return counts


def check_schedulers(torch) -> list:
    """Ancestral Euler (plain and Karras sigmas), DDIM (eta 0 and 0.5) and
    DDPM steps on the card against the CPU, the same inputs and noise."""
    from faithdiff_tpu_torch.config import SchedulerConfig
    from faithdiff_tpu_torch.schedulers import (DDIMScheduler, DDPMScheduler,
                                                EulerAncestralDiscreteScheduler)

    gen = torch.Generator().manual_seed(14)
    x, eps, noise = (torch.randn(SCHED_SHAPE, generator=gen) for _ in range(3))
    cases = [("euler_ancestral", EulerAncestralDiscreteScheduler(SchedulerConfig()), {}),
             ("euler_ancestral_karras", EulerAncestralDiscreteScheduler(
                 SchedulerConfig(use_karras_sigmas=True)), {}),
             ("ddim_eta0", DDIMScheduler(SchedulerConfig()), {"eta": 0.0}),
             ("ddim_eta0.5", DDIMScheduler(SchedulerConfig()), {"eta": 0.5}),
             ("ddpm", DDPMScheduler(SchedulerConfig()), {})]
    rows = []
    for name, sched, kw in cases:
        state = sched.set_timesteps(STEPS)
        errs, bitwise = [], True
        for i in (0, STEPS // 2, STEPS - 1):
            want = sched.step(state, eps, i, x, noise=noise, **kw)
            got = sched.step(state, eps.cuda(), i, x.cuda(),
                             noise=noise.cuda(), **kw).cpu()
            errs.append(float((got - want).abs().max() / (1 + want.abs().max())))
            bitwise &= torch.equal(got, want)
        t = torch.linspace(10, 999, SCHED_SHAPE[0]).long()
        v = DDPMScheduler().get_velocity(x.cuda(), noise.cuda(), t).cpu()
        v_ref = DDPMScheduler().get_velocity(x, noise, t)
        errs.append(float((v - v_ref).abs().max() / (1 + v_ref.abs().max())))
        rows.append(dict(check="schedulers", scheduler=name, shape=list(SCHED_SHAPE),
                         max_rel_err=max(errs), bitwise=bitwise,
                         tol=f"{SCHED_TOL} * (1 + max|cpu|)",
                         ok=max(errs) <= SCHED_TOL))
        print(json.dumps(rows[-1]), flush=True)
    return rows


def encode_png(img, depth16: bool = False, interlace: bool = False) -> bytes:
    """An RGB PNG of [H, W, 3] uint8 `img`, every scanline unfiltered: at
    16 bits each sample is v * 257 (its high byte v), interlaced as Adam7."""
    import struct
    import zlib

    import numpy as np

    samples = img.astype(np.uint16) * 257 if depth16 else img
    passes = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
              (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1)) if interlace else ((0, 0, 1, 1),)
    raw = bytearray()
    for r0, c0, dr, dc in passes:
        sub = samples[r0::dr, c0::dc]
        if not sub.size:
            continue
        rows = sub.astype(">u2").reshape(sub.shape[0], -1).view(np.uint8) \
            if depth16 else sub.reshape(sub.shape[0], -1)
        for row in rows:
            raw += b"\0" + row.tobytes()

    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    ihdr = struct.pack(">IIBBBBB", img.shape[1], img.shape[0],
                       16 if depth16 else 8, 2, 0, 0, int(interlace))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(bytes(raw), 6)) + chunk(b"IEND", b""))


def run_png_formats(torch, root: str, ckpt: str) -> None:
    """`png_formats`: `cli_restore`'s photo as a 16-bit RGB PNG and as an
    Adam7-interlaced 8-bit one, restored by the CLI: each output PNG equal
    in every byte to `cli_restore`'s output of the 8-bit original."""
    from faithdiff_tpu_torch.utils.png import read_png

    img = read_png(os.path.join(root, "in", "photo.png"))
    fmt_dir = os.path.join(root, "in_formats")
    os.makedirs(fmt_dir)
    files = {"photo_16bit.png": encode_png(img, depth16=True),
             "photo_adam7.png": encode_png(img, interlace=True)}
    decoded = {}
    for name, data in files.items():
        with open(os.path.join(fmt_dir, name), "wb") as f:
            f.write(data)
        decoded[name] = bool((read_png(os.path.join(fmt_dir, name)) == img).all())
    out_dir = os.path.join(root, "out_formats")
    split = run_cli(["restore", "--img_dir", fmt_dir, "--save_dir", out_dir,
                     "--checkpoint_dir", ckpt])
    with open(os.path.join(root, "out", "photo.png"), "rb") as f:
        want = f.read()
    same = {}
    for name in files:
        with open(os.path.join(out_dir, name), "rb") as f:
            same[name] = f.read() == want
    result = dict(decoded_equal_8bit=decoded, output_png_identical=same,
                  input_bytes={k: len(v) for k, v in files.items()}, **split)
    print("png_formats", json.dumps(result), flush=True)
    if not (all(decoded.values()) and all(same.values())):
        fail(f"png_formats: {result}")


def run_cli_restore_fp8(torch, pipe8, root: str, ckpt: str) -> dict:
    """`cli_restore_fp8`: `cli.py restore --use_fp8` on `cli_restore`'s
    converted weights and photo: its PNG identical in every byte to the
    in-memory fp8 pipeline's on the same input, its launches as planned."""
    from faithdiff_tpu_torch import cli
    from faithdiff_tpu_torch.ops import _build
    from faithdiff_tpu_torch.utils.image import check_image_size
    from faithdiff_tpu_torch.utils.png import read_png
    from faithdiff_tpu_torch.utils.resample import resize_lanczos

    img = read_png(os.path.join(root, "in", "photo.png"))
    gn_unet, attn_unet = unet_counts(pipe8)
    with cli_pipeline_watch(torch) as seen:
        _build.launches.clear()
        split = run_cli(["restore", "--use_fp8", "--img_dir",
                         os.path.join(root, "in"), "--save_dir",
                         os.path.join(root, "out_fp8"), "--checkpoint_dir", ckpt])
        counts = dict(_build.launches)
    cli_pipe = seen.pop("pipe")
    n8 = sum(v.dtype == torch.float8_e4m3fn for v in cli_pipe.unet.state_dict().values())
    del cli_pipe
    torch.cuda.empty_cache()
    expected = seen["watch"].expected_launches("cli_restore_fp8", "flash_attention_fwd",
                                               gn_unet, attn_unet)
    if counts != expected:
        fail(f"cli_restore_fp8: launch counts {counts}, expected {expected}")
    got = read_png(os.path.join(root, "out_fp8", "photo.png"))
    h, w = img.shape[:2]
    padded, w0, h0, _, _ = check_image_size(resize_lanczos(img, (2 * w, 2 * h)))
    pipe8.tile_chunk = cli.TILE_CHUNK
    want = pipe8(padded, torch.zeros((1, 77, 2048)), torch.zeros((1, 1280)),
                 seed=42, output_type="uint8")[:h0, :w0]
    identical = got.shape == want.shape and bool((got == want).all())
    result = dict(unet_fp8_tensors=n8, load_s=seen["load_s"], **split,
                  identical_to_in_memory=identical, launches=counts,
                  launches_as_planned=True)
    print("cli_restore_fp8", json.dumps(result), flush=True)
    if not identical or not n8:
        fail(f"cli_restore_fp8: {result}")
    return result


class RecordedDraws:
    """A `TorchDraws` whose draws are kept, and replayed on another
    device by `replay()`."""

    def __init__(self, torch, generator):
        from faithdiff_tpu_torch.data.degradation import TorchDraws

        self.torch, self.inner, self.log = torch, TorchDraws(generator), []

    def _keep(self, out):
        self.log.append(out)
        return out

    def gaussian(self, *a):
        return self._keep(self.inner.gaussian(*a))

    def poisson(self, *a):
        return self._keep(self.inner.poisson(*a))

    def jpeg_quality(self, *a):
        return self._keep(self.inner.jpeg_quality(*a))

    def replay(self, device):
        log = iter(self.log)

        def nxt(*_):
            out = next(log)
            return (tuple(t.to(device) for t in out) if isinstance(out, tuple)
                    else out.to(device))

        return types.SimpleNamespace(gaussian=nxt, poisson=nxt, jpeg_quality=nxt)


def run_degradation(torch) -> dict:
    """`degradation`: batches of DEG_BATCH GT crops at DEG_RES^2 through
    `RealESRGANDegradation()` at its defaults, DEG_PLANS seeded plans (each
    call's host plan and kernels, and its draws on the card, inside the
    time); then one plan on the card with TF32 off against the CPU with
    the same draws."""
    from faithdiff_tpu_torch.data.degradation import RealESRGANDegradation

    gen = torch.Generator(device="cuda").manual_seed(21)
    gt = torch.rand((DEG_BATCH, DEG_RES, DEG_RES, 3), generator=gen, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    ms, bad = [], []
    for p in range(DEG_PLANS):
        deg = RealESRGANDegradation(seed=p)
        g = torch.Generator(device="cuda").manual_seed(100 + p)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, lq = deg(gt, generator=g)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        levels = lq * 255.0
        if (tuple(lq.shape) != (DEG_BATCH, DEG_RES // 4, DEG_RES // 4, 3)
                or not bool(torch.isfinite(lq).all())
                or float((levels - torch.round(levels)).abs().max()) > 1e-3
                or float(lq.min()) < 0 or float(lq.max()) > 1):
            bad.append(p)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        draws = RecordedDraws(torch, torch.Generator(device="cuda").manual_seed(7))
        _, lq_dev = RealESRGANDegradation(seed=0)(gt, draws=draws)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    _, lq_cpu = RealESRGANDegradation(seed=0)(gt.cpu(), draws=draws.replay("cpu"))
    diff = (lq_dev.cpu() - lq_cpu).abs()
    # the LQ is on 8-bit levels; x / 255 itself may round in another ulp
    # on the two devices, so a flip is a different level
    flips = torch.round(lq_dev.cpu() * 255) != torch.round(lq_cpu * 255)
    share = float(flips.float().mean())
    result = dict(batch=DEG_BATCH, res=DEG_RES, plans=DEG_PLANS, ms_per_batch=median(ms),
                  ms_min=min(ms), ms_max=max(ms), peak_mem_gib=peak,
                  lq_shape=list(lq.shape), bad_plans=bad,
                  cpu_max_abs_err=float(diff.max()),
                  cpu_mean_abs_err=float(diff.mean()),
                  cpu_level_flip_share=share,
                  cpu_level_flips_max=round(float(diff.max()) * 255),
                  tol=f"share <= {DEG_DIFF_SHARE}, mean <= {DEG_MEAN_TOL}",
                  tf32_for_timing=list(tf32))
    print("degradation", json.dumps(result), flush=True)
    if bad or share > DEG_DIFF_SHARE or result["cpu_mean_abs_err"] > DEG_MEAN_TOL:
        fail(f"degradation: {result}")
    return result


def build_caption_train(torch):
    """The captioner's three modules for training on the card: the LLaMA
    (CAPTION_TRAIN_LAYERS layers, dense, bf16 weights, fp32 norms) and the
    ViT in bf16, the projector fp32 (the trainable master), seeded random
    weights."""
    from faithdiff_tpu_torch.captioner import (CLIPVisionConfig, LlamaConfig,
                                               LlamaForCausalLM)
    from faithdiff_tpu_torch.captioner.clip_vision import (CLIPVisionTower,
                                                           VisionProjector)
    from faithdiff_tpu_torch.pipelines.factory import random_init_

    import dataclasses

    lcfg = dataclasses.replace(LlamaConfig(), num_hidden_layers=CAPTION_TRAIN_LAYERS)
    vcfg = CLIPVisionConfig()
    with torch.device("cuda"):
        llama = LlamaForCausalLM(lcfg, dtype=torch.bfloat16)
        vision = CLIPVisionTower(vcfg, dtype=torch.bfloat16)
        projector = VisionProjector(lcfg.hidden_size, vcfg.hidden_size)
    gen = torch.Generator(device="cuda").manual_seed(8)
    for m in (llama, vision, projector):
        random_init_(m, gen)
        m.requires_grad_(False)
    return {"llama": llama, "vision": vision, "projector": projector}


def caption_train_batch(torch, lcfg, vcfg):
    """CAPTION_TRAIN_BATCH sequences of CAPTION_TRAIN_SEQ tokens: BOS, the
    image placeholder span (one token a patch), prompt text and an answer
    of CAPTION_TRAIN_ANSWER tokens, labelled; NHWC CLIP pixels."""
    from faithdiff_tpu_torch.training.caption_train import IGNORE_INDEX

    gen = torch.Generator(device="cuda").manual_seed(9)
    ids = torch.randint(3, lcfg.vocab_size, (CAPTION_TRAIN_BATCH, CAPTION_TRAIN_SEQ),
                        generator=gen, device="cuda")
    ids[:, 0] = 1
    labels = torch.full_like(ids, IGNORE_INDEX)
    labels[:, -CAPTION_TRAIN_ANSWER:] = ids[:, -CAPTION_TRAIN_ANSWER:]
    pixels = torch.randn((CAPTION_TRAIN_BATCH, vcfg.image_size, vcfg.image_size, 3),
                         generator=gen, device="cuda")
    return {"input_ids": ids, "labels": labels, "pixels": pixels}


def run_caption_train(torch) -> dict:
    """`caption_train`: three "projector" steps and three LoRA steps of the
    captioner at full width. Checks: finite losses, frozen tensors bitwise
    still, every trainable tensor changed, each step's launches the flash
    kernel's once a layer and nothing else, and in "projector" mode a
    `grad_norm` equal to the norm over ALL the gradients (the frozen
    LLaMA's included: tensor hooks sum each gradient's squares as autograd
    makes it). Prints ms a step, the peak, the launches of each step."""
    from faithdiff_tpu_torch.ops import _build
    from faithdiff_tpu_torch.training import caption_train as ct
    from faithdiff_tpu_torch.training import lora as tlora

    t0 = time.perf_counter()
    m = build_caption_train(torch)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    lcfg, vcfg = m["llama"].config, m["vision"].config
    batch = caption_train_batch(torch, lcfg, vcfg)
    torch.cuda.reset_peak_memory_stats()
    frozen = list(m["llama"].parameters()) + list(m["vision"].parameters())
    frozen_before = checksums(torch, frozen)

    # "projector": the update over the whole gradient
    opt = ct.make_caption_optimizer(m, "projector", learning_rate=2e-5,
                                    projector_lr=2e-5)
    state = ct.CaptionTrainState(0, m, opt)
    step = ct.make_caption_train_step(image_token_pos=1,
                                      compute_dtype=torch.bfloat16)
    proj = list(m["projector"].parameters())
    proj_before = checksums(torch, proj)
    seen_sq, seen_n = [], [0]

    def square_hook(g):
        seen_sq.append(g.float().square().sum())
        seen_n[0] += 1

    def timed(mode, fn, *args):
        _build.launches.clear()
        torch.cuda.synchronize()
        t = time.perf_counter()
        metrics = fn(*args)
        torch.cuda.synchronize()
        rows.append(dict(mode=mode, ms=1e3 * (time.perf_counter() - t),
                         loss=float(metrics["loss"]),
                         grad_norm=float(metrics["grad_norm"])))
        launches.append(dict(_build.launches))

    rows, launches = [], []
    for i in range(CAPTION_TRAIN_STEPS):
        params = ct.named_caption_params(m)
        hooks = []
        if i == 0:
            # tensor hooks see every gradient autograd makes, before the
            # step's own reduction; they are registered on the step's leaves
            for k, p in params.items():
                p.requires_grad_(not k.startswith("vision."))
            hooks = [p.register_hook(square_hook) for k, p in params.items()
                     if not k.startswith("vision.")]
        timed("projector", step, state, batch)
        for h in hooks:
            h.remove()
    all_norm = float(torch.sqrt(torch.stack(seen_sq).sum()))
    n_params = sum(1 for k, p in ct.named_caption_params(m).items()
                   if not k.startswith("vision."))
    norm_ok = (seen_n[0] == n_params and
               abs(all_norm - rows[0]["grad_norm"]) <= GRAD_NORM_RTOL * all_norm)
    proj_changed = bool((checksums(torch, proj) != proj_before).all())

    # LoRA on the frozen LLaMA
    lora = tlora.init_lora(m["llama"], LORA_RANK,
                           torch.Generator(device="cuda").manual_seed(10),
                           targets=LORA_TARGETS, alpha=LORA_ALPHA)
    n_lora = tlora.count_lora_modules(lora)
    lora_before = checksums(torch, list(lora.values()))
    lopt = ct.CaptionOptimizer(lora, {k: "train" for k in lora}, learning_rate=2e-4)
    proj_after = checksums(torch, proj)

    def loss_from_model(model, b):
        with torch.autocast("cuda", dtype=torch.bfloat16):
            return ct.caption_loss(model, m["vision"], m["projector"], b, 1)

    lstep = tlora.make_lora_train_step(loss_from_model, m["llama"], lopt.update_)
    for i in range(CAPTION_TRAIN_STEPS):
        timed("lora", lstep, lora, batch)
    lora_changed = bool((checksums(torch, list(lora.values())) != lora_before).all())
    frozen_still = bool(torch.equal(checksums(torch, frozen), frozen_before)
                        and torch.equal(checksums(torch, proj), proj_after))
    finite = all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
                 for r in rows)
    # one causal flash launch a layer (the sequence is >= 1024 tokens; the
    # ViT's 577 stay on the plain path), and no other kernel
    expected = {"flash_attention_fwd": lcfg.num_hidden_layers}
    steps = CAPTION_TRAIN_STEPS
    result = dict(
        layers=lcfg.num_hidden_layers, hidden=lcfg.hidden_size,
        batch=CAPTION_TRAIN_BATCH, seq=int(batch["input_ids"].shape[1]),
        image_tokens=vcfg.num_patches, build_s=build_s, steps=rows,
        ms_per_step_projector=median([r["ms"] for r in rows[1:steps]]),
        ms_per_step_lora=median([r["ms"] for r in rows[steps + 1:]]),
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        launches_per_step=launches, expected_launches_per_step=expected,
        lora_modules=n_lora, lora_rank=LORA_RANK,
        lora_alpha=LORA_ALPHA, grad_norm_all_gradients=all_norm,
        gradients_in_norm=seen_n[0], params_with_gradient=n_params,
        grad_norm_is_whole_tree=norm_ok, frozen_bitwise_still=frozen_still,
        projector_changed=proj_changed, lora_changed=lora_changed,
        finite=finite)
    print("caption_train", json.dumps(result), flush=True)
    ok = (finite and norm_ok and frozen_still and proj_changed and lora_changed
          and launches == [expected] * len(launches))
    if not ok:
        fail(f"caption_train: {result}")
    return result


# `metrics`: an SR and a GT dir of METRICS_PAIRS PNG pairs at the restore's
# 1024x1536 (the last GT at another size, for the harness's BICUBIC
# resize), NIQE fitted on NIQE_PRISTINE[0] seeded textures of
# NIQE_PRISTINE[1]^2
METRICS_PIXELS, METRICS_PAIRS, METRICS_GT_OTHER = (1024, 1536), 4, (960, 1440)
NIQE_PRISTINE = (3, 384)
# a learned network on the card (fp32, TF32 off, cuDNN's and cuBLAS's own
# algorithms) against the port's CPU run of the same weights and input:
# scores within METRICS_TOL * (1 + |cpu|), FID features within
# METRICS_TOL * (1 + max|cpu|). The CPU runs the convnets on a
# METRICS_CROP^2 crop, MANIQA on one of its five crops and CLIPIQA's
# ViT-L/14 at CLIPIQA_CPU_PIXELS (20x20 patches, the position grid
# interpolated as at 512)
METRICS_TOL = 1e-3
METRICS_CROP = 256
CLIPIQA_CPU_PIXELS = 280
PSNR_SSIM_TOL = 1e-5                     # against float64 numpy
# `vqa`: new tokens an answer (the caption phase's agent, its other
# defaults kept)
VQA_NEW_TOKENS = 12
CLIP_BOS, CLIP_EOS = 49406, 49407


def seeded_png(rng, hw, cell: int = 16):
    """A uint8 image with structure at two scales: blocks of `cell` pixels
    plus noise."""
    import numpy as np

    h, w = hw
    coarse = rng.integers(0, 256, (-(-h // cell), -(-w // cell), 3))
    img = np.kron(coarse, np.ones((cell, cell, 1)))[:h, :w]
    return np.clip(img + rng.normal(0, 12, img.shape), 0, 255).astype(np.uint8)


def write_metric_weights(torch, root: str) -> dict:
    """Seeded weights of the seven learned metric networks at their
    published widths, written in the JAX harness's layouts by the port's
    writers (the card's machine has no JAX to write them with): flat npz
    for LPIPS (AlexNet, and VGG16 beside it), DISTS, PaQ-2-PiQ (ResNet-18),
    MUSIQ (14 x 384), MANIQA (ViT-B/8, TAB, Swin) and CLIPIQA (ViT-L/14 and
    its text tower, with `_config` and `_prompt_ids`); the FID InceptionV3
    as flax msgpack, and once more as a torchvision-named `.pth`.
    Returns {name: path}."""
    import numpy as np

    from faithdiff_tpu_torch.eval import (clipiqa, dists, fid, lpips, maniqa,
                                          musiq, paq2piq)

    seeded, tree = lpips.seeded_init_, lpips.tree_from_module
    os.makedirs(root, exist_ok=True)
    paths = {k: os.path.join(root, k + ".npz") for k in
             ("lpips", "lpips_vgg", "dists", "paq2piq", "musiq", "maniqa", "clipiqa", "fid")}
    lpips.save_lpips_params(tree(seeded(lpips.LPIPS("alex"), 1, ("lin",))), paths["lpips"])
    lpips.save_lpips_params(tree(seeded(lpips.LPIPS("vgg"), 2, ("lin",))),
                            paths["lpips_vgg"])
    lpips.save_lpips_params(tree(seeded(dists.DISTS(), 3, ("alpha", "beta"))),
                            paths["dists"])
    lpips.save_lpips_params(tree(seeded(paq2piq.PaQ2PiQ(), 4)), paths["paq2piq"])
    musiq.save_musiq_weights(tree(seeded(musiq.MUSIQ(musiq.MUSIQConfig()), 5)),
                             paths["musiq"], musiq.MUSIQConfig())
    maniqa.save_maniqa_weights(tree(seeded(maniqa.MANIQA(maniqa.MANIQAConfig()), 6)),
                               paths["maniqa"], maniqa.MANIQAConfig())
    vcfg, tcfg = clipiqa.clip_vit_l14_configs()
    model = seeded(clipiqa.CLIPIQA(vcfg, tcfg), 7)
    with torch.no_grad():
        model.logit_scale.fill_(math.log(100.0))
    ids = np.full((2, 77), CLIP_EOS, np.int32)          # "good / bad photo ."
    ids[:, 0], ids[0, 1:4], ids[1, 1:4] = CLIP_BOS, (1125, 1929, 269), (2103, 1929, 269)
    clipiqa.save_clipiqa_weights(clipiqa.clipiqa_tree(model), paths["clipiqa"],
                                 vcfg, tcfg, prompt_ids=ids)
    del model
    inception = tree(seeded(fid.InceptionV3Features(), 8))
    with open(paths["fid"], "wb") as f:
        f.write(fid.write_flax_msgpack(inception))
    paths["fid_pth_route"] = os.path.join(root, "tv", "inception_v3_fid.npz")
    os.makedirs(os.path.dirname(paths["fid_pth_route"]))
    torch.save(fid.torchvision_state_dict(inception),
               paths["fid_pth_route"].replace(".npz", ".pth"))
    return paths


def numpy_psnr_ssim(a, b):
    """float64 PSNR and the harness's SSIM (per RGB channel, 11x11 Gaussian
    of sigma 1.5, VALID) of [H, W, 3] images in [0, 1]."""
    import numpy as np
    from scipy.signal import fftconvolve

    a, b = a.astype(np.float64), b.astype(np.float64)
    psnr = 10 * np.log10(1.0 / max(np.mean((a - b) ** 2), 1e-12))
    x = np.arange(11) - 5
    g = np.exp(-x ** 2 / (2 * 1.5 ** 2))
    win = np.outer(g / g.sum(), g / g.sum())
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    vals = []
    for ch in range(3):
        f = lambda z: fftconvolve(z, win, mode="valid")  # noqa: E731
        p, q = a[..., ch], b[..., ch]
        mu_a, mu_b = f(p), f(q)
        sa, sb, sab = f(p * p) - mu_a ** 2, f(q * q) - mu_b ** 2, f(p * q) - mu_a * mu_b
        vals.append(((2 * mu_a * mu_b + c1) * (2 * sab + c2))
                    / ((mu_a ** 2 + mu_b ** 2 + c1) * (sa + sb + c2)))
    return psnr, float(np.mean(vals))


def run_metrics(torch, root: str) -> dict:
    """`cli.main(["metrics", ...])` on the card with every weights flag:
    the ten metrics of the reference protocol over METRICS_PAIRS SR / GT
    PNG pairs at 1024x1536 (the first SR the `cli_restore` phase's output
    when it is at hand), each with a finite mean and none UNAVAILABLE, no
    hand-written kernel launched; PSNR / SSIM against float64 numpy; each
    learned network on the card against the port's CPU run; ms per image
    by metric (CUDA events around the network, host preprocessing apart),
    NIQE's host seconds, the command's wall seconds and peak memory."""
    import io

    import numpy as np

    from faithdiff_tpu_torch import cli
    from faithdiff_tpu_torch.eval import (REFERENCE_METRICS, clipiqa, dists, fid,
                                          lpips, maniqa, metrics, musiq, niqe,
                                          paq2piq)
    from faithdiff_tpu_torch.ops import _build
    from faithdiff_tpu_torch.utils.png import read_png, write_png

    base = os.path.join(root, "metrics")
    t0 = time.perf_counter()
    paths = write_metric_weights(torch, base)
    write_s = time.perf_counter() - t0
    rng = np.random.default_rng(21)
    dirs = {k: os.path.join(base, k) for k in ("sr", "gt", "pristine")}
    for d in dirs.values():
        os.makedirs(d)
    restored = os.path.join(root, "out", "photo.png")
    srs, gts = [], []
    for i in range(METRICS_PAIRS):
        sr = (read_png(restored) if i == 0 and os.path.exists(restored)
              else seeded_png(rng, METRICS_PIXELS))
        if sr.shape[:2] != METRICS_PIXELS:
            fail(f"metrics: SR {i} is {sr.shape}")
        other = i == METRICS_PAIRS - 1
        gt = (seeded_png(rng, METRICS_GT_OTHER) if other else
              np.clip(sr + rng.normal(0, 8, sr.shape), 0, 255).astype(np.uint8))
        write_png(os.path.join(dirs["sr"], f"img{i}.png"), sr)
        write_png(os.path.join(dirs["gt"], f"img{i}.png"), gt)
        srs.append(sr)
        gts.append(gt)
    for i in range(NIQE_PRISTINE[0]):
        write_png(os.path.join(dirs["pristine"], f"p{i}.png"),
                  seeded_png(rng, (NIQE_PRISTINE[1],) * 2, cell=4))
    niqe_path = os.path.join(base, "niqe.npz")
    t0 = time.perf_counter()
    if cli.main(["metrics", "--fit_niqe_dir", dirs["pristine"],
                 "--niqe_params", niqe_path]) != 0:
        fail("metrics --fit_niqe_dir failed")
    fit_s = time.perf_counter() - t0

    argv = ["metrics", "--sr_dir", dirs["sr"], "--gt_dir", dirs["gt"],
            "--niqe_params", niqe_path, "--fid_weights", paths["fid"],
            "--lpips_weights", paths["lpips"], "--dists_weights", paths["dists"],
            "--clipiqa_weights", paths["clipiqa"], "--musiq_weights", paths["musiq"],
            "--paq2piq_weights", paths["paq2piq"], "--maniqa_weights", paths["maniqa"],
            "--device", "cuda", "--log", os.path.join(base, "metrics.log")]
    out = io.StringIO()
    _build.launches.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = dict(_build.launches)
    print(out.getvalue(), end="", flush=True)
    means = json.loads(out.getvalue().strip().splitlines()[-1])
    if rc != 0 or means.pop("_unavailable") != {}:
        fail(f"metrics: rc {rc}, unavailable metrics in {out.getvalue()[-800:]!r}")
    missing = [m for m in REFERENCE_METRICS
               if not (m in means and math.isfinite(means[m]))]
    if missing:
        fail(f"metrics: no finite mean for {missing}")
    if launches:
        fail(f"metrics: the IQA networks launched counted kernels {launches}")

    # PSNR / SSIM on the card against float64 numpy (the GT as the harness
    # resizes it)
    from faithdiff_tpu_torch.utils.resample import resize_bicubic

    ps = []
    for sr, gt in zip(srs, gts):
        a = sr.astype(np.float32) / 255.0
        b = gt.astype(np.float32) / 255.0
        if b.shape != a.shape:
            b = resize_bicubic(np.uint8(b * 255), (a.shape[1], a.shape[0])
                               ).astype(np.float32) / 255.0
        ta, tb = torch.as_tensor(a, device="cuda"), torch.as_tensor(b, device="cuda")
        got = (float(metrics.psnr(ta, tb)), float(metrics.ssim(ta, tb)))
        want = numpy_psnr_ssim(a, b)
        if max(abs(g - w) for g, w in zip(got, want)) > PSNR_SSIM_TOL:
            fail(f"metrics: card PSNR / SSIM {got}, float64 numpy {want}")
        ps.append(got)
    for k, j in (("psnr", 0), ("ssim", 1)):
        if abs(means[k] - float(np.mean([p[j] for p in ps]))) > PSNR_SSIM_TOL:
            fail(f"metrics: the command's mean {k} {means[k]} is not the pairs'")

    # each learned network: ms per image on the card, and the card against
    # the CPU on the same input
    c = METRICS_CROP
    sr01 = [s.astype(np.float32) / 255.0 for s in srs]
    gt01 = [g.astype(np.float32) / 255.0 for g in gts[:-1]]
    nets = {
        "lpips": (lpips.make_lpips, (paths["lpips"],), True),
        "lpips_vgg": (functools.partial(lpips.make_lpips, net="vgg"),
                      (paths["lpips_vgg"],), True),
        "dists": (dists.make_dists, (paths["dists"],), True),
        "paq2piq": (paq2piq.make_paq2piq, (paths["paq2piq"],), False),
        "musiq": (musiq.make_musiq, (paths["musiq"],), False),
        "maniqa-pipal": (maniqa.make_maniqa, (paths["maniqa"],), False),
        "clipiqa+_vitL14_512": (clipiqa.make_clipiqa, (paths["clipiqa"],), False),
    }
    timing, errors = {}, {}
    for name, (make, args, pair) in nets.items():
        card_fn, cpu_fn = make(*args, device="cuda"), make(*args, device="cpu")
        host, dev = [], []
        for i in range(len(gt01) if pair else len(sr01)):
            call = (sr01[i], gt01[i]) if pair else (sr01[i],)
            torch.cuda.synchronize()
            h0 = time.perf_counter()
            inputs = card_fn.prepare(*call)
            torch.cuda.synchronize()
            host.append(time.perf_counter() - h0)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            card_fn.net(*inputs)
            end.record()
            torch.cuda.synchronize()
            dev.append(start.elapsed_time(end))
        if pair:
            sample = (sr01[0][:c, :c], gt01[0][:c, :c])
            got, want = card_fn(*sample), cpu_fn(*sample)
        elif name == "paq2piq":
            got, want = card_fn(sr01[0][:c, :c + c // 2]), cpu_fn(sr01[0][:c, :c + c // 2])
        elif name == "musiq":
            got, want = card_fn(sr01[0]), cpu_fn(sr01[0])
        elif name == "maniqa-pipal":
            (x,) = card_fn.prepare(sr01[0])
            got, want = float(card_fn.net(x[:1])[0]), float(cpu_fn.net(x[:1].cpu())[0])
        else:
            x = clipiqa_input(torch, srs[0], CLIPIQA_CPU_PIXELS)
            got = float(card_fn.net(x.cuda())[0])
            want = float(cpu_fn.net(x)[0])
        err = abs(got - want)
        if not (math.isfinite(got) and err <= METRICS_TOL * (1 + abs(want))):
            fail(f"metrics: {name} card {got} against CPU {want}")
        errors[name] = dict(card=got, cpu=want, abs_err=err)
        timing[name] = dict(ms_per_image=median(dev), host_ms_per_image=1e3 * median(host))
        del card_fn, cpu_fn
        gc.collect()
        torch.cuda.empty_cache()

    card_fid, cpu_fid = (fid.make_fid_features(paths["fid"], device=d) for d in ("cuda", "cpu"))
    pth_fid = fid.make_fid_features(paths["fid_pth_route"], device="cuda")
    host, dev = [], []
    for im in sr01:
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        x = card_fid.prepare([im])
        torch.cuda.synchronize()
        host.append(time.perf_counter() - h0)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        card_fid.net(x)
        end.record()
        torch.cuda.synchronize()
        dev.append(start.elapsed_time(end))
    timing["fid"] = dict(ms_per_image=median(dev), host_ms_per_image=1e3 * median(host))
    got, want = card_fid(sr01[:1]), cpu_fid(sr01[:1])
    err = float(np.abs(got - want).max())
    if err > METRICS_TOL * (1 + float(np.abs(want).max())):
        fail(f"metrics: FID features card against CPU, max error {err}")
    if not np.array_equal(pth_fid(sr01[:1]), got):
        fail("metrics: the .pth route's FID features are not the msgpack route's")
    errors["fid_features"] = dict(abs_err=err, max_abs_cpu=float(np.abs(want).max()))
    niqe_fn = niqe.make_niqe_metric(niqe_path)
    niqe_s = []
    for im in sr01:
        h0 = time.perf_counter()
        niqe_fn(im)
        niqe_s.append(time.perf_counter() - h0)
    result = dict(
        pixels=list(METRICS_PIXELS), pairs=METRICS_PAIRS, means=means,
        wall_s=wall_s, write_weights_s=write_s, niqe_fit_s=fit_s,
        niqe_host_s_per_image=median(niqe_s), peak_mem_gib=peak,
        metric_ms=timing, card_vs_cpu=errors, tol=METRICS_TOL,
        sr0_from_restore=os.path.exists(restored))
    print("metrics", json.dumps(result), flush=True)
    return result


def clipiqa_input(torch, img, size: int):
    """CLIPIQA's preprocessing (Pillow BICUBIC to `size`, CLIP's
    normalisation) of a uint8 image, as a [1, size, size, 3] CPU tensor."""
    from faithdiff_tpu_torch.captioner.clip_vision import CLIP_MEAN, CLIP_STD
    from faithdiff_tpu_torch.utils.resample import resize_bicubic

    x = resize_bicubic(img, (size, size)).astype("float32") / 255.0
    return torch.from_numpy((x - CLIP_MEAN) / CLIP_STD)[None]


def run_vqa(torch, agent, root: str) -> dict:
    """The VQA harnesses on the caption phase's LLaVA-1.5-13B nf4 agent:
    4 questions over 2 PNGs through `eval.vqa.run_vqa` and
    `eval.generators.run_vqa_loader` (the same records), a 2-row MMBench
    TSV of base64 PNGs through `run_mmbench` (4 + 2 circular rounds), the
    POPE and TextVQA evaluators and the circular scorer over the answers; each
    forward launches the NF4 kernel 280 times on its route (the prefill
    route for a question's prompt, the decode route after it) and no other
    counted kernel. Prints answers / s and decode ms a step."""
    import base64
    import csv
    import io

    import numpy as np

    from faithdiff_tpu_torch.eval import drivers, generators, vqa
    from faithdiff_tpu_torch.ops import _build
    from faithdiff_tpu_torch.utils.png import write_png

    base = os.path.join(root, "vqa")
    imgs = os.path.join(base, "images")
    os.makedirs(imgs)
    rng = np.random.default_rng(31)
    for i, hw in enumerate([(336, 448), (448, 336)]):
        write_png(os.path.join(imgs, f"im{i}.png"), seeded_png(rng, hw))
    texts = ["Is there a cat in the image?", "What colour is the door?",
             "Is there a tree in the image?", "What is written on the sign?"]
    suffix = "\nAnswer the question using a single word or phrase."
    qs = [{"question_id": k, "image": f"im{k % 2}.png", "text": t + suffix,
           "category": ("popular", "random")[k % 2]} for k, t in enumerate(texts)]
    qfile = os.path.join(base, "questions.jsonl")
    with open(qfile, "w") as f:
        f.writelines(json.dumps(q) + "\n" for q in qs)
    tsv = os.path.join(base, "mmbench.tsv")
    with open(tsv, "w", newline="") as f:
        w = csv.DictWriter(f, delimiter="\t", fieldnames=[
            "index", "question", "hint", "A", "B", "C", "D", "image", "answer"])
        w.writeheader()
        for idx, (opts, ans) in enumerate([(("cat", "dog", "bird", "fish"), "B"),
                                           (("day", "night", "", ""), "A")]):
            png_path = os.path.join(base, f"mm{idx}.png")
            write_png(png_path, seeded_png(rng, (96, 96)))
            with open(png_path, "rb") as png:
                data = base64.b64encode(png.read()).decode()
            w.writerow(dict(index=f"q{idx}", question="Which one is shown?",
                            hint="nan" if idx else "Look closely.", A=opts[0], B=opts[1],
                            C=opts[2], D=opts[3], answer=ans, image=data))

    before = agent.max_new_tokens
    agent.max_new_tokens = VQA_NEW_TOKENS
    calls = []

    def pre(module, args):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        calls.append([args[0].shape[1], ev, None, dict(_build.launches)])

    def post(module, args, out):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        b = calls[-1][3]
        calls[-1][2:] = [ev, {k: v - b.get(k, 0) for k, v in _build.launches.items()
                              if v != b.get(k, 0)}]

    hooks = [agent.llama.register_forward_pre_hook(pre),
             agent.llama.register_forward_hook(post)]
    answers = {k: os.path.join(base, f"{k}.jsonl") for k in ("vqa", "loader", "mmbench")}
    _build.launches.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        n = [vqa.run_vqa(agent, qfile, imgs, answers["vqa"]),
             generators.run_vqa_loader(agent, qfile, imgs, answers["loader"]),
             generators.run_mmbench(agent, tsv, answers["mmbench"])]
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
        agent.max_new_tokens = before
    wall_s = time.perf_counter() - t0
    counts = dict(_build.launches)

    if n != [4, 4, 6]:
        fail(f"vqa: answers written {n}, expected [4, 4, 6]")
    rows = {k: [json.loads(line) for line in open(p)] for k, p in answers.items()}
    for k, recs in rows.items():
        for r in recs:
            if (r.get("model_id") != "faithdiff-tpu-captioner"
                    or not isinstance(r.get("text"), str) or "prompt" not in r):
                fail(f"vqa: malformed {k} record {r}")
    if [r["text"] for r in rows["vqa"]] != [r["text"] for r in rows["loader"]]:
        fail("vqa: the prefetching loader's answers are not run_vqa's")
    prefill = {"nf4_matmul": NF4_PER_FORWARD, "nf4_gemm": NF4_PER_FORWARD}
    decode = {"nf4_matmul": NF4_PER_FORWARD, "nf4_gemv": NF4_PER_FORWARD}
    bad = [c[3] for c in calls if c[3] != (prefill if c[0] > 1 else decode)]
    if bad or not calls:
        fail(f"vqa: per-forward launches off their routes: {bad[:3]}")
    n_pre = sum(c[0] > 1 for c in calls)
    if n_pre != 14 or set(counts) != {"nf4_matmul", "nf4_gemm", "nf4_gemv"}:
        fail(f"vqa: {n_pre} prefills, launches {counts}")

    # the POPE and TextVQA evaluators score the answers
    pope = os.path.join(base, "pope")
    os.makedirs(pope)
    for cat in ("popular", "random"):
        with open(os.path.join(pope, f"coco_pope_{cat}.json"), "w") as f:
            f.writelines(json.dumps({"label": lab}) + "\n" for lab in ("yes", "no"))
    ann = os.path.join(base, "textvqa.json")
    with open(ann, "w") as f:
        json.dump({"data": [{"image_id": q["question_id"], "question": t,
                             "answers": ["yes"] * 10} for q, t in zip(qs, texts)]}, f)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = (drivers.main(["pope", "--annotation-dir", pope, "--question-file", qfile,
                            "--result-file", answers["vqa"]])
              + drivers.main(["textvqa", "--annotation-file", ann,
                              "--result-file", answers["vqa"]]))
    report = out.getvalue()
    if rc or report.count("Accuracy:") != 3 or "Samples: 4" not in report:
        fail(f"vqa: POPE / TextVQA did not score the answers: {report!r}")
    circular = generators.mmbench_circular_accuracy(rows["mmbench"], {"q0": "B", "q1": "A"})
    if circular["count"] != 2:
        fail(f"vqa: circular scorer counted {circular}")
    dec = [c for c in calls if c[0] == 1]
    result = dict(answers=sum(n), wall_s=wall_s, answers_per_s=sum(n) / wall_s,
                  forwards=len(calls), prefills=n_pre,
                  decode_ms_per_step=(sum(c[1].elapsed_time(c[2]) for c in dec)
                                      / max(len(dec), 1)),
                  prefill_ms=median([c[1].elapsed_time(c[2]) for c in calls if c[0] > 1]),
                  launches=counts, nf4_per_forward=NF4_PER_FORWARD,
                  mmbench=circular, answers_sample=[r["text"] for r in rows["vqa"][:2]])
    print("vqa", json.dumps(result), flush=True)
    return counts



# ---------------------------------------------------------------------------
# fp32 training, the serving stack, one-rank NCCL
# ---------------------------------------------------------------------------

# train --dtype float32: stage 1 at 512 px, batch 2, accum 1, two micro-steps
# on the default attention path and one on the packed path; the UNet's
# self-attentions at >= 1024 tokens (32^2 latents: 4 in down block 1, 6 in
# up block 1) are 10 fp32 flash launches a micro-step
FP32_TRAIN_STEPS, FP32_FLASH_PER_STEP = 2, 10
FP32_TRAIN_SHAPE = (2, 10, 1024, 64)
# train_fp32_wide's d = 512 attention (batch 2, a 32 x 32 latent)
FP32_WIDE_SHAPE = (2, 1, 1024, 512)


def f32_attention_launches(name: str, count: int, shape) -> dict:
    """The attention counters `count` fp32 flash launches of counter `name`
    at `shape` ([B, H, S, d], non-causal) give: the kernel's, and its
    merge's where `f32_plan` splits the shape on this card."""
    import torch

    from faithdiff_tpu_torch.ops.attention import _sm_count, f32_plan

    b, h, n, d = shape
    plan = f32_plan(b, h, n, n, d, sms=_sm_count(torch.device("cuda")))
    return {name: count, **({"flash_attention_f32_merge": count} if plan.splits > 1 else {})}
SERVER_START_S = 300                     # a server's start-up, its model load included


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def post_json(url: str, payload: dict, timeout: float = 600) -> bytes:
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read()


def start_server(args, label: str):
    """`python <args>` from the checkout, its output to a log beside the
    built kernels."""
    log = open(os.path.join(_build_dir(), f"{label}_{os.getpid()}.log"), "w")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen([sys.executable, *args], cwd=ROOT, env=env, stdout=log,
                            stderr=subprocess.STDOUT)
    proc.log = log
    return proc


def _build_dir() -> str:
    from faithdiff_tpu_torch.ops import _build

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    return _build.BUILD_DIR


def wait_until(proc, ready, label: str, timeout: float = SERVER_START_S) -> float:
    """Poll `ready()` until it is true; fails if `proc` exits or `timeout`
    passes. Returns the seconds waited."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        if proc.poll() is not None:
            fail(f"{label} exited with {proc.returncode}: {tail_log(proc)}")
        try:
            if ready():
                return time.perf_counter() - t0
        except OSError:
            pass
        time.sleep(0.5)
    fail(f"{label} not ready after {timeout} s: {tail_log(proc)}")


def tail_log(proc, n: int = 3000) -> str:
    proc.log.flush()
    with open(proc.log.name) as f:
        return f.read()[-n:]


def stop_servers(procs) -> None:
    """SIGINT (the mains' KeyboardInterrupt exit), then kill what is left."""
    import signal

    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGINT)
    for p in procs:
        try:
            p.wait(20)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(10)
        p.log.close()


def run_train_fp32(torch, root: str) -> dict:
    """`cli.main(["train", "--dtype", "float32", "--synthetic_data", ...])`
    at full width, stage 1, 512 px, batch 2, accum 1: FP32_TRAIN_STEPS
    micro-steps on the default attention path, then one more on the packed
    path (FAITHDIFF_BSND_ATTN). Each micro-step is timed (CUDA events) and
    must launch exactly FP32_FLASH_PER_STEP fp32 flash kernels of its layout
    and no bf16 one, with a finite loss; peak memory. The checkpoint writes
    are stubbed (a stage-1 state is ~10.5 GB; `cli_train` writes and
    resumes them at bf16). Then the fp32 kernel at the micro-step's
    attention shape against its plain version."""
    from faithdiff_tpu_torch import cli
    from faithdiff_tpu_torch.models import transformer2d
    from faithdiff_tpu_torch.ops import _build
    from faithdiff_tpu_torch.training import checkpoint as C
    from faithdiff_tpu_torch.training import runner

    make_step, save = runner.make_train_step, C.CheckpointManager.save
    steps = []

    def timed_make_step(*a, **k):
        step = make_step(*a, **k)

        def timed(*sa, **sk):
            before = dict(_build.launches)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            m = step(*sa, **sk)
            end.record()
            torch.cuda.synchronize()
            steps.append(dict(ms=start.elapsed_time(end), loss=float(m["loss"]),
                              packed=transformer2d._BSND_ATTN,
                              launches={n: c - before.get(n, 0) for n, c in
                                        _build.launches.items() if c - before.get(n, 0)}))
            # the last micro-step on the packed path
            transformer2d._BSND_ATTN = len(steps) >= FP32_TRAIN_STEPS
            return m
        return timed

    saves = []
    runner.make_train_step = timed_make_step
    C.CheckpointManager.save = lambda self, step, *a, **k: saves.append(step) or True
    packed_before = transformer2d._BSND_ATTN
    _build.launches.clear()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        if cli.main(["train", "--synthetic_data", "--dtype", "float32",
                     "--output_dir", os.path.join(root, "fp32_run"),
                     "--resolution", str(TRAIN_RES), "--train_batch_size", "2",
                     "--grad_accum", "1", "--max_train_steps", str(FP32_TRAIN_STEPS + 1),
                     "--log_every", "1", "--lr_warmup_steps", "0"]) != 0:
            fail("train_fp32: train returned nonzero")
    finally:
        runner.make_train_step, C.CheckpointManager.save = make_step, save
        transformer2d._BSND_ATTN = packed_before
    wall = time.perf_counter() - t0
    launches = dict(_build.launches)        # the path's, before the check's
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for i, st in enumerate(steps):
        name = "flash_attention_f32_bsnd_fwd" if st["packed"] else "flash_attention_f32_fwd"
        flash = {n: c for n, c in st["launches"].items() if "attention" in n}
        want = f32_attention_launches(name, FP32_FLASH_PER_STEP, FP32_TRAIN_SHAPE)
        if flash != want or not math.isfinite(st["loss"]):
            fail(f"train_fp32: micro-step {i + 1}: loss {st['loss']}, attention "
                 f"launches {flash}, expected {want}")
    if len(steps) != FP32_TRAIN_STEPS + 1 or not steps[-1]["packed"]:
        fail(f"train_fp32: {len(steps)} micro-steps {[s['packed'] for s in steps]}")
    gen = torch.Generator(device="cuda").manual_seed(14)
    q, k, v = (torch.randn(FP32_TRAIN_SHAPE, generator=gen, device="cuda")
               for _ in range(3))
    check = f32_flash_row(torch, "train_fp32_attention", q, k, v, 64 ** -0.5,
                          timed=False)
    if not check["ok"]:
        fail(f"train_fp32: the fp32 kernel at the training shape: {check}")
    row = dict(check="train_fp32", stage=1, batch=2, grad_accum=1, res=TRAIN_RES,
               ms_per_micro_step=[s["ms"] for s in steps],
               loss=[s["loss"] for s in steps],
               launches_per_micro_step=[s["launches"] for s in steps],
               peak_gib=peak, cli_wall_s=wall, saves_stubbed=saves,
               kernel_max_abs_err=check["max_abs_err"])
    print(json.dumps(row), flush=True)
    return dict(row, launches=launches)


def jpeg_manifest() -> dict:
    with open(os.path.join(JPEG_DIR, "manifest.json")) as f:
        return json.load(f)


def run_jpeg_decode() -> dict:
    """`jpeg_decode`: every committed fixture decoded by the port's decoder
    (`utils/jpeg`, the host library built on this machine), the SHA-256 of
    its RGB array equal to the manifest's Pillow hash; then the decode of
    each JPEG_TIMED file, ms a megapixel (host clock, median of 5)."""
    import hashlib

    from faithdiff_tpu_torch.utils.jpeg import decode_jpeg

    manifest = jpeg_manifest()
    bad = []
    for name, entry in sorted(manifest["files"].items()):
        with open(os.path.join(JPEG_DIR, name), "rb") as f:
            rgb = decode_jpeg(f.read(), name)
        if (list(rgb.shape) != entry["shape"]
                or hashlib.sha256(rgb.tobytes()).hexdigest() != entry["rgb_sha256"]):
            bad.append(name)
    if bad:
        fail(f"jpeg_decode: the port's decode of {bad} is not Pillow's")
    timing = {}
    for name in JPEG_TIMED:
        with open(os.path.join(JPEG_DIR, name), "rb") as f:
            data = f.read()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            rgb = decode_jpeg(data, name)
            times.append(time.perf_counter() - t0)
        ms, mp = median(times) * 1e3, rgb.shape[0] * rgb.shape[1] / 1e6
        timing[name] = dict(ms=ms, ms_per_mp=ms / mp, mp_per_s=mp / ms * 1e3,
                            progressive=manifest["files"][name]["progressive"],
                            bytes=len(data))
    row = dict(check="jpeg_decode", files=len(manifest["files"]), sha256_equal=True,
               made_by={k: manifest[k] for k in ("pillow", "libjpeg_turbo")},
               timing=timing)
    print(json.dumps(row), flush=True)
    return row


def run_native(torch) -> dict:
    """`native`: `native.decode_batch` over the fixtures (8 C++ threads)
    equal in every bit to `decode_resize` one by one, both timed; and
    `tile_merge_host` of a latent's tiles within 1e-5 of the port's
    `pipelines/tiling.merge_tiles` of the same tiles on the card."""
    import numpy as np

    from faithdiff_tpu_torch import native
    from faithdiff_tpu_torch.pipelines.tiling import (compute_tile_layout,
                                                      merge_tiles, split_tiles)

    paths = [os.path.join(JPEG_DIR, n) for n in sorted(jpeg_manifest()["files"])]
    w, h = NATIVE_WH
    t0 = time.perf_counter()
    batch = native.decode_batch(paths, w, h, num_threads=8)
    t1 = time.perf_counter()
    single = np.stack([native.decode_resize(p, w, h) for p in paths])
    t2 = time.perf_counter()
    if not np.array_equal(batch, single) or not np.isfinite(batch).all():
        fail("native: decode_batch differs from decode_resize")
    gen = torch.Generator(device="cuda").manual_seed(16)
    x = torch.randn((1, 4) + NATIVE_CANVAS, generator=gen, device="cuda")
    layout = compute_tile_layout(*NATIVE_CANVAS, NATIVE_TILE, overlap=0.5)
    tiles = split_tiles(x, layout)
    want = merge_tiles(tiles, layout)[0].permute(1, 2, 0).cpu().numpy()
    t3 = time.perf_counter()
    got = native.tile_merge_host(tiles.permute(0, 2, 3, 1).cpu().numpy(),
                                 np.asarray(layout.offsets, np.int32), NATIVE_CANVAS)
    t4 = time.perf_counter()
    err = float(np.abs(got - want).max())
    if err > 1e-5:
        fail(f"native: tile_merge_host is {err} from merge_tiles")
    row = dict(check="native", files=len(paths), out_wh=list(NATIVE_WH),
               batch_equal_single=True, batch_s=t1 - t0, single_s=t2 - t1,
               merge_tiles=len(layout.offsets), merge_max_abs_err=err,
               merge_tol=1e-5, merge_s=t4 - t3)
    print(json.dumps(row), flush=True)
    return row


def run_cli_restore_jpeg(torch, root: str, ckpt: str) -> dict:
    """`cli_restore_jpeg`: JPEG_RESTORE through `cli.py restore` (default
    flags, `cli_restore`'s converted weights): a 256 x 256 PNG, the
    d = 512 bf16 kernel launched WIDE_PER_RESTORE times, its merge as
    often as `wide_plan` splits the shape, and no other attention kernel
    (the UNet's attentions are under 1024 tokens there),
    the GroupNorm kernels as planned; then the same pixels written as a
    PNG through the CLI again, whose PNG must be the JPEG's, byte for
    byte."""
    import collections

    import numpy as np

    from faithdiff_tpu_torch.ops import _build
    from faithdiff_tpu_torch.ops.groupnorm import plan_group_norm
    from faithdiff_tpu_torch.utils.jpeg import read_jpeg
    from faithdiff_tpu_torch.utils.png import read_png, write_png

    src = os.path.join(JPEG_DIR, JPEG_RESTORE)
    stem = os.path.splitext(JPEG_RESTORE)[0]
    dirs = {k: os.path.join(root, k) for k in ("in_jpeg", "in_jpeg_png",
                                               "out_jpeg", "out_jpeg_png")}
    os.makedirs(dirs["in_jpeg"])
    os.makedirs(dirs["in_jpeg_png"])
    shutil.copy(src, os.path.join(dirs["in_jpeg"], JPEG_RESTORE))
    write_png(os.path.join(dirs["in_jpeg_png"], stem + ".png"), read_jpeg(src))
    with cli_pipeline_watch(torch) as seen:
        _build.launches.clear()
        split = run_cli(["restore", "--img_dir", dirs["in_jpeg"], "--save_dir",
                         dirs["out_jpeg"], "--checkpoint_dir", ckpt])
        counts = dict(_build.launches)
    seen.pop("pipe", None)
    if seen["watch"].wide_launches() != WIDE_PER_RESTORE:
        fail(f"cli_restore_jpeg: {seen['watch'].vae_attention} VAE attention calls "
             f"(batch, tokens, channels), {WIDE_PER_RESTORE} at 1024 tokens expected")
    expected = collections.Counter({"flash_attention_wide_fwd": WIDE_PER_RESTORE})
    if seen["watch"].wide_merges():
        expected["flash_attention_wide_merge"] = seen["watch"].wide_merges()
    for _, shape, itemsize, groups, aligned in seen["watch"].gn_seen:
        expected.update(plan_group_norm(shape, itemsize, groups, aligned).counters)
    if counts != dict(expected):
        fail(f"cli_restore_jpeg: launches {counts}, expected {dict(expected)}")
    split_png = run_cli(["restore", "--img_dir", dirs["in_jpeg_png"], "--save_dir",
                         dirs["out_jpeg_png"], "--checkpoint_dir", ckpt])
    out = os.path.join(dirs["out_jpeg"], stem + ".png")
    with open(out, "rb") as f:
        got = f.read()
    with open(os.path.join(dirs["out_jpeg_png"], stem + ".png"), "rb") as f:
        same = f.read() == got
    img = read_png(out)
    if img.shape != (256, 256, 3) or not same or not seen["latents_finite"]:
        fail(f"cli_restore_jpeg: output {img.shape}, same bytes as the PNG's "
             f"restore: {same}, latents finite: {seen['latents_finite']}")
    row = dict(check="cli_restore_jpeg", input=JPEG_RESTORE, pixels=list(img.shape[:2]),
               launches=counts, wide_launches=counts["flash_attention_wide_fwd"],
               identical_to_png_input=True, load_s=seen["load_s"], **split,
               png_input_wall_s=split_png["cli_wall_s"],
               png_input_pipeline_s=split_png["pipeline_s"],
               out_std=float(np.asarray(img, np.float32).std()))
    print(json.dumps(row), flush=True)
    return dict(row, out_png=out)


def run_train_fp32_wide(torch, root: str) -> dict:
    """`train_fp32_wide`: `cli.main(["train", "--dtype", "float32", ...])`
    at FP32_WIDE_RES px, stage 1, batch 2, one micro-step: its VAE encode
    and denoise encoder run the fp32 kernel at d = 512 (a 32 x 32 latent),
    FP32_WIDE_PER_STEP launches and no other attention kernel (the UNet's
    attentions are under 1024 tokens), and their merges where `f32_plan`
    splits, with a finite loss. Checkpoint writes are stubbed, as in
    `train_fp32`. Then the fp32 kernel at FP32_WIDE_SHAPE, under the plan
    the path ran, against its plain version."""
    from faithdiff_tpu_torch import cli
    from faithdiff_tpu_torch.ops import _build
    from faithdiff_tpu_torch.ops.attention import _sm_count, f32_plan
    from faithdiff_tpu_torch.training import checkpoint as C
    from faithdiff_tpu_torch.training import logging as L

    save = C.CheckpointManager.save
    C.CheckpointManager.save = lambda self, step, *a, **k: True
    _build.launches.clear()
    t0 = time.perf_counter()
    try:
        if cli.main(["train", "--synthetic_data", "--dtype", "float32",
                     "--output_dir", os.path.join(root, "fp32_wide_run"),
                     "--resolution", str(FP32_WIDE_RES), "--train_batch_size", "2",
                     "--grad_accum", "1", "--max_train_steps", "1",
                     "--log_every", "1", "--lr_warmup_steps", "0"]) != 0:
            fail("train_fp32_wide: train returned nonzero")
    finally:
        C.CheckpointManager.save = save
    wall = time.perf_counter() - t0
    launches = dict(_build.launches)
    attention = {n: c for n, c in launches.items() if "attention" in n}
    loss = L.read_metrics(os.path.join(root, "fp32_wide_run", "logs"))[-1]["train_loss"]
    if not math.isfinite(loss):
        fail(f"train_fp32_wide: loss {loss}")
    want = f32_attention_launches("flash_attention_f32_wide_fwd", FP32_WIDE_PER_STEP,
                                  FP32_WIDE_SHAPE)
    if attention != want:
        fail(f"train_fp32_wide: attention launches {attention}, expected {want}")
    b, h, n, d = FP32_WIDE_SHAPE
    plan = f32_plan(b, h, n, n, d, sms=_sm_count(torch.device("cuda")))
    gen = torch.Generator(device="cuda").manual_seed(15)
    q, k, v = (torch.randn(FP32_WIDE_SHAPE, generator=gen, device="cuda")
               for _ in range(3))
    check = f32_flash_row(torch, "train_fp32_wide_attention", q, k, v, d ** -0.5,
                          timed=False)
    del q, k, v
    if not check["ok"]:
        fail(f"train_fp32_wide: the fp32 kernel at the training shape: {check}")
    row = dict(check="train_fp32_wide", res=FP32_WIDE_RES, batch=2, micro_steps=1,
               launches=launches, cli_wall_s=wall, loss=loss,
               kernel_shape=list(FP32_WIDE_SHAPE), kernel_splits=plan.splits,
               kernel_blocks=plan.blocks, kernel_max_abs_err=check["max_abs_err"],
               kernel_tol=check["tol"], kernel_same_bits=check["same_bits"])
    print(json.dumps(row), flush=True)
    return dict(row, launches=launches)


def run_serving_demo(torch, root: str, ckpt: str, cli_row: dict,
                     jpeg_row: dict) -> dict:
    """`python -m faithdiff_tpu_torch.serving.web_demo` on `cli_restore`'s
    converted checkpoint, on a free port: `GET /` serves the page, and two
    `/restore`s of `cli_restore`'s photo (base64 PNG) at the CLI's defaults
    each return a PNG identical in every byte to the one `cli.py restore`
    wrote; their latencies (the server process's first call, then a warm
    one) beside the CLI's wall time. Then JPEG_RESTORE uploaded as it is
    (base64 JPEG) returns the PNG `cli_restore_jpeg` wrote for it, byte for
    byte."""
    import base64
    import urllib.request

    port = free_port()
    url = f"http://127.0.0.1:{port}"
    proc = start_server(["-m", "faithdiff_tpu_torch.serving.web_demo", "--host",
                         "127.0.0.1", "--port", str(port), "--checkpoint_dir", ckpt],
                        "web_demo")
    try:
        def page():
            with urllib.request.urlopen(url + "/", timeout=5) as r:
                return r.status == 200 and b"Restoration Run" in r.read()

        ready_s = wait_until(proc, page, "web_demo")
        with open(os.path.join(root, "in", "photo.png"), "rb") as f:
            upload = base64.b64encode(f.read()).decode()
        with open(os.path.join(root, "out", "photo.png"), "rb") as f:
            want = f.read()
        latency = []
        for _ in range(2):          # the server process's first call, then a warm one
            t0 = time.perf_counter()
            reply = json.loads(post_json(url + "/restore", {"image": upload}))
            latency.append(time.perf_counter() - t0)
            if "image" not in reply:
                fail(f"web_demo: /restore answered {reply}")
            got = base64.b64decode(reply["image"])
            if got != want:
                fail(f"web_demo: /restore PNG ({len(got)} bytes) is not the CLI's "
                     f"({len(want)} bytes)")
        with open(os.path.join(JPEG_DIR, JPEG_RESTORE), "rb") as f:
            jpeg = base64.b64encode(f.read()).decode()
        with open(jpeg_row["out_png"], "rb") as f:
            want_jpeg = f.read()
        t0 = time.perf_counter()
        reply = json.loads(post_json(url + "/restore", {"image": jpeg}))
        jpeg_latency = time.perf_counter() - t0
        if base64.b64decode(reply.get("image", "")) != want_jpeg:
            fail(f"web_demo: the JPEG upload's /restore is not cli_restore_jpeg's "
                 f"PNG: {str(reply)[:200]}")
    finally:
        stop_servers([proc])
    row = dict(check="serving_demo", start_s=ready_s, restore_latency_s=latency,
               cli_wall_s=cli_row["cli_wall_s"], cli_pipeline_s=cli_row["pipeline_s"],
               png_bytes=len(got), identical_to_cli=True,
               jpeg_upload_identical_to_cli=True, jpeg_restore_latency_s=jpeg_latency)
    print(json.dumps(row), flush=True)
    return row


def run_serving_caption(torch, files: dict, cli_row: dict) -> dict:
    """The controller and one worker through their `main`s as subprocesses
    on free ports: `worker.main` serves `cli_caption`'s converted
    checkpoint (int8, the worker's default, as `cli.py caption`'s; the
    checkpoint's 8 LLaMA layers through a launcher that gives
    `from_checkpoint` that depth, as `cli_caption` does). Two caption
    requests through the controller's `/worker_generate_stream`, one after
    the other, each text identical to `cli.py caption`'s JSON for the same
    PNG; latencies beside the CLI's `caption_s`."""
    import base64

    cport, wport = free_port(), free_port()
    curl = f"http://127.0.0.1:{cport}"
    launcher = (
        "import dataclasses, sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from faithdiff_tpu_torch.captioner import LlamaConfig, agent\n"
        "load = agent.CaptionAgent.from_checkpoint\n"
        f"cfg = dataclasses.replace(LlamaConfig.llava_13b(), num_hidden_layers={CLI_CAPTION_LAYERS})\n"
        "agent.CaptionAgent.from_checkpoint = staticmethod(\n"
        "    lambda d, **kw: load(d, llama_config=cfg, **kw))\n"
        "from faithdiff_tpu_torch.serving import worker\n"
        "worker.main(sys.argv[1:])\n")
    procs = [start_server(["-m", "faithdiff_tpu_torch.serving.controller", "--host",
                           "127.0.0.1", "--port", str(cport)], "controller")]
    try:
        wait_until(procs[0], lambda: "models" in json.loads(
            post_json(curl + "/list_models", {}, 5)), "controller")
        procs.append(start_server(
            ["-c", launcher, "--controller", curl, "--port", str(wport),
             "--captioner_dir", files["cap_dir"], "--model_name", "llava"], "worker"))
        ready_s = wait_until(procs[1], lambda: json.loads(
            post_json(curl + "/list_models", {}, 5))["models"] == ["llava"], "worker")
        texts, latency = [], []
        for name in files["names"]:
            with open(os.path.join(files["img_dir"], f"{name}.png"), "rb") as f:
                body = {"model": "llava", "image": base64.b64encode(f.read()).decode()}
            t0 = time.perf_counter()
            raw = post_json(curl + "/worker_generate_stream", body)
            latency.append(time.perf_counter() - t0)
            chunks = [json.loads(c) for c in raw.split(b"\0") if c.strip()]
            if not chunks or any(c["error_code"] for c in chunks):
                fail(f"serving_caption: {name}: {chunks}")
            texts.append(chunks[-1]["text"])
            if texts[-1] != files["captions"][name]:
                fail(f"serving_caption: {name}: {texts[-1]!r} is not cli.py "
                     f"caption's {files['captions'][name]!r}")
    finally:
        stop_servers(procs[::-1])
    row = dict(check="serving_caption", worker_start_s=ready_s,
               caption_latency_s=latency, cli_caption_s=cli_row["caption_s"],
               quant="int8", identical_to_cli=True,
               caption_chars=[len(t) for t in texts])
    print(json.dumps(row), flush=True)
    return row


def run_distributed(torch, pipe) -> dict:
    """A one-rank NCCL group (`parallel.distributed.init_distributed`).
    The 1024x1536 restore of `run_restore` on the resident pipeline with
    `tile_group` set (padding, the rank's share, the all_gather) between
    two runs of the same restore without it: latents and uint8 output equal
    in every bit, wall seconds of all three. Then one stage-1 micro-step plus optimizer
    step (batch 2, accum 1, 512 px) under data parallelism and ZeRO
    (`init_train_state(data_parallel=True)`: the batch rows, the fusion's
    global batch, averaged gradients, the all-reduced norm, sharded
    moments, gathered params) against the plain step from the same seeded
    state and the same draws (after a plain step that warms the card up):
    loss, every trainable tensor, both moments and the EMA equal in every
    bit; ms of each, and of a second, warm data-parallel step."""
    import numpy as np
    import torch.distributed as dist

    from faithdiff_tpu_torch.parallel import distributed

    distributed.init_distributed(f"127.0.0.1:{free_port()}", 1, 0, device="cuda")
    try:
        if dist.get_backend() != "nccl":
            fail(f"distributed: backend {dist.get_backend()}")
        # NCCL sets its communicator up at the first collective: before timing
        dist.all_reduce(torch.zeros(1, device="cuda"))
        torch.cuda.synchronize()
        img = np.random.default_rng(0).integers(0, 256, TILE_PIXELS + (3,), dtype=np.uint8)
        outs, wall = [], []
        for group in (None, dist.group.WORLD, None):
            pipe.tile_group = group
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lat = pipe(img, torch.zeros((1, 77, 2048)), torch.zeros((1, 1280)), seed=0,
                       output_type="latent")
            out = pipe.decode(lat, img, output_type="uint8")
            torch.cuda.synchronize()
            wall.append(time.perf_counter() - t0)
            outs.append((lat, out))
        pipe.tile_group = None
        if not all(torch.equal(outs[0][0], lat) and np.array_equal(outs[0][1], out)
                   for lat, out in outs[1:]):
            fail("distributed: the tile-group restore differs from the plain one")
        del outs

        # a first plain micro-step warms the card up and is not kept
        results, ms = [], []
        for data_parallel in (False, False, True):
            state, step, _ = build_train(torch, 1, 2, 1, False, ema_interval=1,
                                         data_parallel=data_parallel)
            batch = next(train_batches(2))
            gen = torch.Generator().manual_seed(21)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            m = step(state, batch, gen,
                     rows=distributed.local_batch_slice(2) if data_parallel else None)
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
            opt = state.opt.state_dict()
            results.append(dict(
                loss=m["loss"].clone(),
                params={k: p.detach().clone() for k, p in state.trainable().items()},
                mu={k: v.clone() for k, v in opt["mu"].items()},
                nu={k: v.clone() for k, v in opt["nu"].items()},
                ema={k: v.clone() for k, v in state.ema_state_dict().items()}))
            if data_parallel:       # a second, warm step: timed, not compared
                start.record()
                step(state, next(train_batches(2)), gen,
                     rows=distributed.local_batch_slice(2))
                end.record()
                torch.cuda.synchronize()
                warm_ms = start.elapsed_time(end)
            del state, step
            gc.collect()
            torch.cuda.empty_cache()
        _, plain, dp = results
        same = torch.equal(plain["loss"], dp["loss"]) and all(
            torch.equal(plain[part][k], dp[part][k])
            for part in ("params", "mu", "nu", "ema") for k in plain[part])
        if not same:
            fail("distributed: the data-parallel step differs from the plain one")
    finally:
        pipe.tile_group = None
        dist.destroy_process_group()
    row = dict(check="distributed", backend="nccl", world=1,
               restore_wall_s={"plain": [wall[0], wall[2]], "tile_group": wall[1]},
               restore_identical=True,
               micro_step_ms={"plain_warm_up": ms[0], "plain": ms[1], "zero": ms[2],
                              "zero_second": warm_ms},
               step_identical=True, trainable_tensors=len(plain["params"]))
    print(json.dumps(row), flush=True)
    return row


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "faithdiff_tpu_torch")):
        print("chip_smoke: faithdiff_tpu_torch/ is not beside this script",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from faithdiff_tpu_torch import cli
    from faithdiff_tpu_torch.ops import _build

    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)

    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s (parallel nvcc: "
          f"{_build.build_log.get('seconds', 0.0):.1f} s)", flush=True)
    for name in _build.SOURCES:
        print_ptxas(name, _build.build_log.get(name, ""))

    with phase("kernel_checks"):
        attn = check_attention(torch)
        packed = check_attention_packed(torch)
        ragged = check_attention_ragged(torch)
        variants = check_attention_variants(torch)
        fused, stats, apply_ = check_group_norm(torch)
        f32 = check_attention_f32(torch)
    with phase("attention_wide_d"):
        wide = check_attention_wide(torch)
        wide.append(check_wide_merge(torch))
        wide.append(check_wide_merge(torch, torch.float32))
    bad = [r for r in attn + packed + ragged + variants + fused + stats + apply_ + f32
           + wide if not r["ok"]]
    if bad:
        fail(f"{len(bad)} kernel checks out of tolerance: {bad}")
    with phase("jpeg_decode"):
        run_jpeg_decode()
    with phase("native"):
        run_native(torch)

    with phase("restore"):
        pipe = build_restore(torch)
        counts, (args, kwargs), _ = run_restore(torch, pipe, packed=False)
        with attention_path(False):
            profile_call(torch, "profile", pipe.unet, args, kwargs)
    with phase("restore_packed"):
        packed_counts, (args, kwargs), _ = run_restore(torch, pipe, packed=True)
        with attention_path(True):
            profile_call(torch, "profile_packed", pipe.unet, args, kwargs)
        check_path_parity(torch, pipe.unet, args, kwargs)
    del args, kwargs
    if not all(counts.get(k) for k in ("group_norm_fused", "group_norm_stats",
                                       "group_norm_apply")):
        fail(f"restore did not launch every GroupNorm kernel: {counts}")
    with phase("restore_fp8"):
        pipe8, fp8_counts = run_restore_fp8(torch, pipe, counts)
    with phase("restore_karras"):
        karras_counts = run_restore_karras(torch, pipe)
    with phase("schedulers"):
        bad = [r for r in check_schedulers(torch) if not r["ok"]]
    if bad:
        fail(f"{len(bad)} scheduler steps on the card are not the CPU's: {bad}")
    # the reference-layout weight files and the converted copy live beside
    # the built kernels, and go whether the CLI phases pass or fail
    root = os.path.join(_build.BUILD_DIR, f"cli_weights_{os.getpid()}")
    os.makedirs(root, exist_ok=True)
    try:
        with phase("cli_restore"):
            ckpt, cli_restore_row = run_cli_restore(torch, pipe, root)
        with phase("cli_restore_jpeg"):
            jpeg_row = run_cli_restore_jpeg(torch, root, ckpt)
        with phase("cli_restore_tiled"):
            run_cli_restore_tiled(torch, root, ckpt)
        with phase("cli_restore_prompt"):
            run_cli_restore_prompt(torch, pipe, root, ckpt)
        with phase("cli_restore_fp8"):
            run_cli_restore_fp8(torch, pipe8, root, ckpt)
        with phase("png_formats"):
            run_png_formats(torch, root, ckpt)
        with phase("serving_demo"):
            run_serving_demo(torch, root, ckpt, cli_restore_row, jpeg_row)
        with phase("metrics"):
            run_metrics(torch, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del pipe8
    gc.collect()
    torch.cuda.empty_cache()
    with phase("restore_large"):
        _, (args, kwargs), first = run_restore(torch, pipe, packed=False,
                                               pixels=LARGE_PIXELS,
                                               label="restore_large")
    if args[0].shape[0] != 2 * LARGE_TILES:
        fail(f"restore_large: UNet batch {args[0].shape[0]}, expected "
             f"{2 * LARGE_TILES} ({LARGE_TILES} tiles)")
    with phase("chunk_parity"):
        check_chunk_parity(torch, pipe.unet, *first, cli.TILE_CHUNK)
    del first
    with phase("tile_chunk_sweep"):
        run_tile_chunk_sweep(torch, pipe.unet, args, kwargs)
    del args, kwargs
    # the canvases of restore_4k go whether the phase passes or fails
    ckpt_dir = os.path.join(_build.BUILD_DIR, f"restore_4k_{os.getpid()}")
    try:
        with phase("restore_4k"):
            run_restore_4k(torch, pipe, ckpt_dir)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    with phase("distributed"):
        run_distributed(torch, pipe)
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    tok_root = os.path.join(_build.BUILD_DIR, f"tokenizer_{os.getpid()}")
    try:
        with phase("text_towers"):
            check_text_towers(torch, write_tokenizer_dirs(tok_root))
    finally:
        shutil.rmtree(tok_root, ignore_errors=True)
    with phase("vae_chunk_trap"):
        check_vae_chunk_trap(torch)
    with phase("bench"):
        bench_counts = run_bench(torch)

    with phase("nf4"):
        nf4 = check_nf4(torch)
    bad = [r for r in nf4 if not r["ok"]]
    if bad:
        fail(f"{len(bad)} NF4 kernel checks out of tolerance: {bad}")
    with phase("caption"):
        check_caption_small(torch)
        check_llama_prefill(torch)
        caption_counts, agent = run_caption(torch)
    # the VQA files go whether the phase passes or fails
    vqa_root = os.path.join(_build.BUILD_DIR, f"vqa_{os.getpid()}")
    try:
        with phase("vqa"):
            vqa_counts = run_vqa(torch, agent, vqa_root)
    finally:
        shutil.rmtree(vqa_root, ignore_errors=True)
    del agent
    gc.collect()
    torch.cuda.empty_cache()
    with phase("caption_int8"):
        run_caption(torch, "int8")
    gc.collect()
    torch.cuda.empty_cache()
    # the reference-layout captioner files and their converted copy go
    # whether the phase passes or fails
    cap_root = os.path.join(_build.BUILD_DIR, f"caption_weights_{os.getpid()}")
    try:
        with phase("cli_caption"):
            cli_caption_row, caption_files = run_cli_caption(torch, cap_root)
        gc.collect()
        torch.cuda.empty_cache()
        with phase("serving_caption"):
            run_serving_caption(torch, caption_files, cli_caption_row)
    finally:
        shutil.rmtree(cap_root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    with phase("bsrnet"):
        check_bsrnet(torch)
    gc.collect()
    torch.cuda.empty_cache()

    with phase("train_autograd"):
        grads = check_train_autograd(torch)
    bad = [r for r in grads if not r["ok"]]
    if bad:
        fail(f"{len(bad)} autograd checks out of tolerance: {bad}")
    with phase("train_stage1"):
        stage1 = run_train_stage1(torch)
    gc.collect()
    torch.cuda.empty_cache()
    with phase("train_stage2"):
        stage2 = run_train_stage2(torch)
    gc.collect()
    torch.cuda.empty_cache()
    # the CLI's checkpoints and PNGs go whether the phase passes or fails
    train_root = os.path.join(_build.BUILD_DIR, f"train_cli_{os.getpid()}")
    os.makedirs(train_root, exist_ok=True)
    try:
        with phase("cli_train"):
            run_cli_train(torch, train_root)
    finally:
        shutil.rmtree(train_root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    fp32_root = os.path.join(_build.BUILD_DIR, f"train_fp32_{os.getpid()}")
    try:
        with phase("train_fp32"):
            fp32 = run_train_fp32(torch, fp32_root)
        gc.collect()
        torch.cuda.empty_cache()
        with phase("train_fp32_wide"):
            fp32_wide = run_train_fp32_wide(torch, fp32_root)
    finally:
        shutil.rmtree(fp32_root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    with phase("degradation"):
        run_degradation(torch)
    gc.collect()
    torch.cuda.empty_cache()
    with phase("caption_train"):
        caption_train = run_caption_train(torch)
    gc.collect()
    torch.cuda.empty_cache()
    caption_step = caption_train["launches_per_step"][0]

    def entry(name, row, source, replaces, launches=counts):
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=launches[name], max_abs_err=row["max_abs_err"],
                    ms=row["ms"], plain_ms=row["plain_ms"],
                    bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                    library_ms=row["library_ms"],
                    train_launches_per_micro_step={
                        "stage1": stage1["launches_per_micro_step"][name],
                        "stage2": stage2["launches_per_micro_step"][name]},
                    path_launches={
                        "restore_fp8": fp8_counts.get(name, 0),
                        "restore_karras": karras_counts.get(name, 0),
                        "vqa": vqa_counts.get(name, 0),
                        "caption_train_step": caption_step.get(name, 0),
                        "train_fp32_micro_steps": [
                            st.get(name, 0) for st in fp32["launches_per_micro_step"]]})

    merge_rows = {r["dtype"]: r for r in wide if r.get("check") == "wide_merge"}

    def merge_entry(name, dtype, dims, source, launches):
        """A split kernel's merge: its row at the VAE's shape, its launches
        on the path that runs it; `dims` the head dims its kernel splits."""
        return dict(name=name, route="cuda", source=source,
                    replaces=(f"faithdiff_tpu/ops/attention.py:45 at d = {dims} (the "
                              f"K/V loop's carried softmax state, across split blocks; "
                              f"{dtype})"),
                    launches=launches.get(name, 0),
                    **{k: merge_rows[dtype][k] for k in (
                        "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                        "ms_over_bound", "library_ms", "shape", "splits")})

    def wide_entry(name, packed_name, dtype, source, launches):
        """A wide head-dim kernel: its row at the VAE's [1, 1, 1024, 512],
        its launches on the path that runs it (`cli_restore_jpeg` in bf16,
        `train_fp32_wide` in fp32), and the same kernel's packed-layout row
        under "packed" (no model path runs it packed)."""
        rows = [r for r in wide if r.get("dtype") == dtype and "ms" in r]
        row = next(r for r in rows if r["shape"] == list(WIDE_SHAPES[0][0]))
        packed_row = next(r for r in rows if "heads" in r)
        keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
        return dict(name=name, route="cuda", source=source,
                    replaces=("faithdiff_tpu/ops/attention.py:45 at d = 192 ... 512"
                              f" ({dtype} instance)"),
                    launches=launches.get(name, 0), **{k: row[k] for k in keys},
                    shape=row["shape"], sdpa_backend=row["sdpa_backend"],
                    packed=dict(name=packed_name,
                                replaces="faithdiff_tpu/ops/attention.py:101 at d = 192 ... 512",
                                launches=launches.get(packed_name, 0),
                                shape=packed_row["shape"], heads=packed_row["heads"],
                                **{k: packed_row[k] for k in keys}))

    kernels = [
        entry("flash_attention_fwd", attn[ATTN_REPORT],
              "faithdiff_tpu_torch/csrc/flash_attention.cu",
              "faithdiff_tpu/ops/attention.py:45"),
        entry("group_norm_fused",
              next(r for r in fused if r["shape"] == list(GN_SHAPES[GN_REPORT][0])),
              "faithdiff_tpu_torch/csrc/group_norm.cu",
              "faithdiff_tpu/ops/groupnorm.py:33 and :92 (_stats_kernel, _apply_kernel)"),
        entry("group_norm_stats", stats[GN_REPORT],
              "faithdiff_tpu_torch/csrc/group_norm.cu",
              "faithdiff_tpu/ops/groupnorm.py:33"),
        entry("group_norm_apply", apply_[GN_REPORT],
              "faithdiff_tpu_torch/csrc/group_norm.cu",
              "faithdiff_tpu/ops/groupnorm.py:92"),
        entry("nf4_matmul",
              next(r for r in nf4 if (r["m"], r["in_f"], r["out_f"]) == NF4_REPORT),
              "faithdiff_tpu_torch/csrc/nf4_matmul.cu",
              "faithdiff_tpu/ops/nf4_matmul.py:73", caption_counts),
        entry("flash_attention_bsnd_fwd", packed[PACKED_REPORT],
              "faithdiff_tpu_torch/csrc/flash_attention.cu",
              "faithdiff_tpu/ops/attention.py:101", packed_counts),
        entry("flash_attention_f32_fwd", f32[0],
              "faithdiff_tpu_torch/csrc/flash_attention_f32.cu",
              "faithdiff_tpu/ops/attention.py:45 (fp32 instance)", fp32["launches"]),
        entry("flash_attention_f32_bsnd_fwd", f32[-1],
              "faithdiff_tpu_torch/csrc/flash_attention_f32.cu",
              "faithdiff_tpu/ops/attention.py:101 (fp32 instance)", fp32["launches"]),
        wide_entry("flash_attention_wide_fwd", "flash_attention_wide_bsnd_fwd",
                   "bfloat16", "faithdiff_tpu_torch/csrc/flash_attention_wide.cu",
                   jpeg_row["launches"]),
        merge_entry("flash_attention_wide_merge", "bfloat16", "192 ... 512",
                    "faithdiff_tpu_torch/csrc/flash_attention_wide.cu",
                    jpeg_row["launches"]),
        wide_entry("flash_attention_f32_wide_fwd", "flash_attention_f32_wide_bsnd_fwd",
                   "float32", "faithdiff_tpu_torch/csrc/flash_attention_f32.cu",
                   fp32_wide["launches"]),
        merge_entry("flash_attention_f32_merge", "float32", "64 ... 512",
                    "faithdiff_tpu_torch/csrc/flash_attention_f32.cu (flash_tile.cuh's "
                    "flash_wide_merge_kernel, fp32 output)", fp32_wide["launches"]),
        entry("attention_variant_fwd",
              next(r for r in variants
                   if (tuple(r["shape"]), r["base2"], r["block_k"]) == VARIANT_REPORT),
              "faithdiff_tpu_torch/csrc/flash_attention.cu",
              "scripts/bench_attention_variants.py:36", bench_counts),
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
