#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (diffusion_pipe_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one card

Phases, each printing one JSON line (or more):

1. build          -- compiles the CUDA kernels under
                     diffusion_pipe_tpu_torch/csrc with nvcc, all sources in
                     parallel, and reports ptxas's register and spill counts
                     for each kernel instance, and whether ptxas serialized
                     its wgmmas (warning C7512).
2. kernels        -- K1 (forward), K2 (dQ) and K3 (dK/dV) against their plain
                     PyTorch versions at Flux-dev shapes (B=2, H=24, S=1536,
                     D=128, bf16): unmasked, with a [B, Skv] text-padding
                     mask, and at a ragged S=1000; then at Wan's
                     cross-attention shape (Sq 21504 video tokens, Skv 512
                     text tokens, H=12) and on two heads of Wan's
                     self-attention (S 21504). Each kernel's error against the f32
                     plain result must be at most twice the bf16 plain
                     version's error plus 1e-3 of the reference's largest
                     magnitude. It times each kernel beside its bound, its
                     plain version and, as a yardstick only, torch's
                     scaled_dot_product_attention, at the Flux shape, at the
                     Wan cross shape and at the Wan self-attention shape
                     (its check takes heads 5 and 6 as strided views of
                     the full inputs; its timing all 12 heads, without the
                     plain version, which would need 22 GB of f32 logits).
                     Two K2 launches on the same inputs must give the same
                     bits, and two K3 launches too, at the Wan cross shape
                     (K3's query-split path) and at the Flux shape (no
                     split). A batch element whose keys are all masked must
                     give O = 0, the mask value as its LSE and zero dQ, dK
                     and dV, on both K3 paths (Wan cross at B=2, and Flux).
                     Every time (kernel, plain version, SDPA) is taken
                     with the calls queued behind a spin of the card
                     (queued_ms), so a call shorter than its wrapper's host
                     time reads its device time. Each timing carries its
                     share of the bound, K1 its factor against SDPA's
                     forward, K3 that of K2 + K3 against SDPA's backward.
   sr-kernel      -- K4 (stochastic rounding of a bf16 update) at the largest
                     Wan2.1-1.3B leaf (ffn_in, 8960 x 1536) with bf16 and f32
                     updates: bit for bit equal to its plain version, every
                     output one of the two bf16 neighbours of f32(p) + f32(u),
                     and the mean over 64 seeds within 4 sigma of the f32
                     sum; then its time beside its bound.
   int8-kernels   -- H1 (per-row int8 quantization, with and without the
                     column pre-scale) and H2 (int32 rescale to bf16) bit for
                     bit against their plain versions at the Flux path's
                     shapes, timed beside their bytes bound (device time
                     from torch.profiler, since a launch takes the wrapper
                     longer on the host than the kernel on the device; the
                     launch rate beside as launch_ms); then one int8
                     linear (H1, torch._int_mm, H2) forward and its int8
                     dgrad against torch.matmul in bf16 at three Flux block
                     shapes (ff_in, the single blocks' proj_out, and the
                     two-row norm1_linear, which int_mm pads to 32 rows).
3. reference      -- a two-block Flux at head dim 128 (bf16 on the card,
                     through the kernels) against the same weights in f32 on
                     the CPU (plain attention): output, loss and LoRA grads.
4. slice          -- the Flux path: the full-width, full-depth Flux-dev
                     LoRA-r32 trainer (adamw8bit, clip 1.0, per-block
                     activation checkpointing) at 512 px, batch 2, random
                     weights and latents from a seed. One warm-up step, then
                     five timed steps with the launch counters set to 0 just
                     before: every loss finite, LoRA factors moved, frozen
                     weights unchanged, and 114 / 57 / 57 launches per step.
   slice-fp8-int8 -- the main path as bench.py runs it, cell
                     flux-dev-lora-512-fp8-int8: the same trainer with the
                     block weights stored in fp8 and pre-quantized to int8 by
                     init_train_state, int8_matmul "fwd_bwd" and
                     activation_checkpointing "attn". One warm-up step, five
                     timed: finite losses, LoRA moved, the int8 weights
                     unchanged, every block linear int8 with real scales,
                     57 / 57 / 57 flash launches and 1406 H1 and H2 launches
                     a step (494 linears x forward and recompute, and the
                     dgrads of the 418 whose input needs a gradient: not
                     the 76 adaLN linears, fed by the frozen embedders),
                     and a peak below the bf16 phase's. Then, on the same
                     model, eight pairs of adjacent steps under "attn" and
                     under activation_checkpointing = true (57 against 114
                     K1 launches a step), the order alternating: the "attn"
                     step must take no longer (the mean difference within
                     twice its standard error; phase
                     slice-fp8-int8-attn-vs-true).
   vae            -- the Flux VAE at full width, random weights from the
                     seed written in the diffusers layout and loaded by the
                     Flux pipeline's caching function, bf16 on the card: the
                     encode of a 2 x 3 x 512 x 512 batch within 3e-2
                     (relative L2) of the same weights in f32 on the CPU,
                     and its device time.
   driver         -- the same cell through the training driver,
                     `python -m diffusion_pipe_tpu_torch.train` (called as
                     train.main): 8 seeded 512 px PNGs and 2 for eval under
                     build/smoke/, the caching phase with the vae phase's
                     VAE and seeded T5/CLIP stand-ins, 3 steps with the
                     9-quantile eval, a resume to step 5: finite losses,
                     the step counter, the loader position of an
                     uninterrupted run, metrics.jsonl, LoRA moved and int8
                     unchanged, the 988-key adapter, the launches (57 / 57 /
                     57 and 1,406 H1 and H2 a step, 57 and 494 an eval
                     forward), and the step time beside the fp8-int8
                     phase's (the difference is the driver's host cost).
5. reference-wan  -- a two-block Wan at head dim 128 (dim 256, 2 heads, a
                     3x10x10 latent grid = 75 tokens, 40 text tokens), full
                     fine-tuning, bf16 on the card against f32 on the CPU:
                     output, loss and all gradients.
6. slice-wan      -- the main path of wan-1.3b-t2v-fullft-sr: Wan2.1-1.3B t2v
                     at full width and depth, every parameter trainable in
                     bf16, adamw lr 2e-5 with stochastic rounding, clip 1.0,
                     per-block checkpointing, one 81-frame 512 px clip
                     (latents 16x21x64x64 = 21,504 tokens) and 512 text
                     tokens. One warm-up step, then three timed steps with
                     the counters set to 0 just before: finite losses, every
                     trainable tensor changed, and 120 / 60 / 60 flash
                     launches and one K4 launch per bf16 trainable tensor
                     per step.
   slice-wan-lora -- bench.py's Wan row, cell wan-1.3b-t2v-lora-attn
                     (bench.py:52-72): the same model and batch with LoRA
                     r32, adamw8bit, clip 1.0 and "attn"; one warm-up, five
                     timed steps: finite losses, all 600 LoRA tensors moved,
                     the base weights unchanged, 60 / 60 / 60 flash launches
                     a step and no K4.
7. kernels (i2v)  -- (run right after phase 2) K1-K3 against their plain
                     versions, K2 / K3 deterministic, and timed beside
                     bound, plain and SDPA at Wan i2v's image cross-attention (Sq 32,760 video
                     tokens against Skv 257 CLIP tokens, flf2v 514, H 40).
8. umt5           -- UMT5-XXL at full width and depth, seeded, bf16: the
                     encode of 2 x 512 ids with padding, timed; two layers
                     at full width against f32 on the CPU (rel. L2 3e-2).
   clip-vision    -- the ViT-H/14 tower at full width on a 480 x 832 frame
                     (257 x 1280 tokens), timed; two blocks against f32 on
                     the CPU (3e-2).
9. wan-vae        -- the Wan 2.1 VAE (dim 96, z 16) on 1x3x81x512x512 and
                     the Wan 2.2 VAE (dim 160, z 48) on ti2v's
                     1x3x121x704x1280, seeded, bf16, timed with their peaks;
                     a 9-frame clip (128 px; 2.2: 64 px) encoded and decoded
                     against f32 on the CPU (5e-2). The 2.1 weights are
                     written in the reference layout under build/smoke/.
10. driver-wan    -- bench.py's Wan row through train.main: 8 + 2 seeded
                     512 px PNGs, --cache_only with those VAE weights
                     (load_wan_vae) and seeded UMT5-shaped text, 3 steps
                     with eval, a resume to 5; the same checks as driver,
                     the adapter's 600 keys as export_wan_lora_comfyui
                     gives them, 60 / 60 / 60 launches a step and 60 K1 an
                     eval forward.
11. slice-wan-i2v / slice-wan-ti2v -- four full-width blocks of i2v-14B
                     (32,760 tokens, y and a 257-token CLIP context: K1
                     three times a block) and of ti2v-5B (48-channel
                     latents, 27,280 tokens), LoRA r32, adamw8bit, "attn":
                     finite losses, moved factors, the launches.

12. slice-flux-lokr -- (run after slice-fp8-int8) bench.py's Flux row with
                     a LoKr adapter (rank 16, decompose_factor -1,
                     rank_dropout 0.1) in place of LoRA: one warm-up, five
                     timed steps, every LoKr tensor moved (the zero-
                     initialised w1 too), the int8 base unchanged, 57 / 57
                     / 57 flash and 1406 H1 and H2 launches a step.
    sample        -- (run next) the Euler flow sampler through the training
                     forward: Flux-dev at full depth, 512 px, 20 steps
                     (20 x 57 K1, no K2 or K3); a full-width two-block Flux
                     sample, bf16 on the card against f32 on the CPU; and
                     Wan2.1-1.3B at 81 frames and 512 px, 4 steps.
    driver / driver-wan also sample with --test_sample in the resumed call
                     (example.png at 512 px; its forwards counted in the
                     launches) and decode the cache with --dump_dataset
                     (one 512 px PNG a training image).
13. slice-wan-policies -- (run last) bench.py's Wan row at 10 of its 30
                     blocks with LoRA dropout
                     0.1 under true, "attn", "dots", "offload_attn" and
                     "unsloth": the same batch, noise, t and masks give
                     true's loss and LoRA gradients (relative L2 1e-3; bit
                     equality reported); per policy two timed steps, peak
                     device memory, pinned host bytes, K1 launches a step
                     (40 / 20) and the products run a step ("dots" and
                     "unsloth": the forward's alone).
    optimizers    -- Wan2.1-1.3B t2v at full width, 4 of 30 blocks, full
                     fine-tuning in bf16 with stochastic rounding: three
                     steps each of stableadamw, sgd, automagic, muon,
                     adafactor and genericoptim (subset norm, rank 128,
                     SVD projector refreshed inside the timed steps), then
                     adamw8bit LoRA with gradient_release at GAS 2: losses,
                     step and optimizer times, K4 launches a step.

14. kernels-sdxl -- (run after the optimizers) K1-K3 at head dim 64 at SDXL's
                     attention shapes, bf16, batch 4: 512 px self-attention
                     over 1,024 tokens (H 10) and 256 (H 20), cross-attention
                     from both to the 77 CLIP tokens (one key tile, 51 keys
                     padded: K3's query split), 1024 px self-attention over
                     4,096 (H 10) and 1,024 (H 20); each against its plain
                     version, the 256-token cross also with a padded batch
                     element and with an all-masked one, K2 / K3
                     deterministic there; each timed as in kernels beside
                     its bound, its plain version and SDPA's forward and
                     backward.
    reference-sdxl -- a narrow SDXL UNet (64 / 128 / 128, six transformer
                     blocks at head dim 64) bf16 on the card against f32 on
                     the CPU: output, loss, LoRA gradients.
    slice-sdxl-lora -- cell sdxl-lora-512, tools/bench_sdxl.py's
                     configuration: SDXL at full size (UNet 2.57 B, CLIP-L,
                     bigG) from a seed, LoRA r16, adamw8bit, clip 1.0, no
                     checkpointing, batch 4 of 4 x 64 x 64 latents with
                     77-token ids: one warm-up, five timed steps; finite
                     losses, every LoRA tensor moved, the UNet and towers
                     unchanged, 140 / 140 / 140 flash launches a step.
    slice-sdxl-fullft -- cell sdxl-fullft: the same model fully fine-tuned
                     (UNet and both towers) with adamw and unet_lr /
                     text_encoder_1_lr / text_encoder_2_lr at three values,
                     batch 1, two steps: every tensor moved (but CLIP-L's
                     last layer, which SDXL's context and pooled embedding
                     do not read), each group's step following its LR.
    driver-sdxl   -- examples/sdxl.toml's settings through train.main: 8 + 4
                     seeded 512 px PNGs with captions, a model folder with
                     a seeded SDXL VAE and a synthetic CLIP tokenizer,
                     --cache_only, 3 steps with the eval, a resume to 5 with
                     --test_sample (DDIM); the loader position of an
                     uninterrupted run, the kohya adapter's 2,100 keys, the
                     launches.

15. kernels-sd3-chroma -- (run last) K1-K3 at SD3's joint sequence at 1024
                     px (B 2, 4,429 keys = 34 x 128 + 77, D 64) with
                     SD3-Medium's 24 heads and SD3.5-Large's 38 (checked on
                     six heads), and Chroma's at 512 px (B 2, 1,536 keys,
                     D 128, 77 and 300 of the 512 T5 keys valid): against
                     the plain versions, K2 / K3 deterministic on the masked
                     shape, timed beside the bound (the valid keys' work),
                     the plain versions and SDPA (given the same mask).
    reference-sd3 / reference-chroma -- two blocks of each at its real head
                     dim (SD3 with qk_norm; Chroma with a T5 key mask), bf16
                     on the card against f32 on the CPU: output, loss, LoRA
                     gradients.
    slice-sd3-lora -- cell sd3-medium-lora-1024: SD3-Medium at full width and
                     depth (24 joint blocks, hidden 1,536, 2.0 B), LoRA r32
                     on every block linear, adamw8bit, clip 1.0, per-block
                     checkpointing, batch 2 of 16 x 128 x 128 latents with
                     333 text rows (77 CLIP, 256 T5): one warm-up, five
                     timed steps; 48 / 24 / 24 flash launches a step.
    slice-chroma-lora -- cell chroma-lora-512: Chroma at full width and
                     depth (19 + 38 blocks, 8.9 B, Approximator 5 x 5,120),
                     LoRA r32, adamw8bit, "attn", batch 2 at 512 px with 512
                     T5 tokens of which 60 and 200 are valid; 57 / 57 / 57.
    driver-sd3 / driver-chroma -- each family through train.main at full
                     width and depth: 8 + 2 seeded 512 px PNGs, a seeded VAE
                     (SD3's 16-channel one; Flux's for Chroma) and seeded
                     text stand-ins (Chroma's with a T5 mask), --cache_only,
                     3 steps with the eval, a resume to 5 with --test_sample;
                     the adapter's keys (999 / 684 with the alphas), and a
                     third call whose adapter.init_from_existing loads the
                     epoch export: exported again, the same tensors bit for
                     bit (Chroma's fused pairs included).

16. kernels-qwen  -- (run last) K1-K3 at Qwen-Image's joint sequence with
                     its text padding as the key mask (B 2 x 4,608 keys =
                     512 text, 77 / 300 valid, + 4,096 image at 1024 px;
                     B 1 x 8,704 with the edit's control image), D 128, H
                     24, checked on six heads against the plain versions,
                     K2 / K3 deterministic, timed beside the valid keys'
                     bound, the plain versions and SDPA under the same
                     mask; H1 / H2 bit for bit and timed at ff_in [8,192 x
                     3,072 / 12,288].
    reference-qwen -- two Qwen-Image blocks at head dim 128 with a text key
                     mask, bf16 on the card against f32 on the CPU.
    slice-qwen-image-lora -- cell qwen-image-lora-1024: Qwen-Image at its
                     published size (60 blocks, 20.4 B) from a seed as
                     examples/qwen_image.toml trains it (fp8 storage
                     pre-quantized to int8, int8_matmul "fwd_bwd", LoRA r32
                     on the 840 block linears, adamw8bit lr 2e-5, clip 1.0,
                     `true`), batch 2 at 1024 px with 512 text rows (77 and
                     300 valid): one warm-up, three timed steps; finite
                     losses, LoRA moved (the last block's text tail gets no
                     gradient; a bf16 lora_a may round back at lr 2e-5),
                     int8 unchanged, 120 / 60 / 60 flash and 2,397 H1 and
                     H2 launches a step.
    slice-qwen-image-edit-lora -- cell qwen-image-edit-lora-1024-4-blocks:
                     the same at 4 blocks with control latents (8,704
                     keys), the output cut to the target's 4,096 rows.
    qwen25vl       -- Qwen2.5-VL-7B's text tower (28 layers, 3,584 wide) and
                     vision tower (32 layers, 1,280 wide) from a seed, bf16:
                     the t2i text function on 2 templated prompts of 546
                     ids, the vision tower on a 336 px image, the whole edit
                     text function once; the first layer against f32 on the
                     CPU.
    driver-qwen    -- examples/qwen_image.toml's settings through train.main
                     at full width and 10 of the 60 blocks (QWEN_DRIVER_DEPTH,
                     the smoke's time limit) and 512 px (micro batch 1, GAS 4): 8 + 2
                     seeded PNGs, a seeded Wan 2.1 VAE in diffusers'
                     AutoencoderKLQwenImage layout, seeded text with its
                     mask, --cache_only, 3 steps with the evals, a resume to
                     5 with --test_sample, a re-import of the epoch export
                     through init_from_existing, bit for bit; the 420
                     adapter keys and the launches.

17. kernels-flux2-auraflow -- (after the Qwen-Image phases) the ptxas registers, spills and
                     wgmma serialization of the head-dim-256 kernels (K1 in
                     csrc/flash_fwd.cu at FwdTile<256>, K2 in flash_bwd_dq.cu
                     at DqTile<256>, K3 in flash_bwd_dkv_d256.cu, all wgmma
                     kernels: no spill and no C7512 in their bf16 and fp16
                     instances); K1-K3 at FLUX.2 [dev]'s joint sequence (B 1 x
                     4,608 keys, 48 heads of 128; the edit's 8,704), checked
                     on six heads, and at AuraFlow's (B 2 x 4,360 keys, 12
                     heads of 256, unmasked and with 200 / 60 of the 256 T5
                     rows valid) against the plain versions, K2 / K3
                     deterministic, a batch element with every key masked
                     at D 256 on both K3 paths, timed beside the bound, the
                     plain versions and SDPA; H1 / H2 bit for bit and timed
                     at the single block's linear1 [4,608 x 6,144 / 55,296].
    reference-flux2-published / -jax, reference-auraflow -- 1 + 1 blocks at
                     the real head dims (128, 256), bf16 on the card
                     against f32 on the CPU; FLUX.2 in its published layout
                     and in the JAX module's.
    slice-flux2-lora -- cell flux2-dev-lora-1024-fp8-int8: FLUX.2 [dev] at
                     its published size (8 + 48 blocks, 6,144 wide, SwiGLU
                     ratio 3, 31.4 B) from a seed, the block weights built
                     in fp8 and pre-quantized to int8 one at a time,
                     int8_matmul "fwd_bwd", LoRA r32 (bf16) on the 160
                     block linears, adamw8bit, clip 1.0, `true`, batch 1 at
                     1024 px (4,096 image + 512 text tokens, unmasked,
                     guidance 1.0): one warm-up, two timed steps; 112 / 56 /
                     56 flash and 478 H1 and H2 launches a step.
    slice-flux2-edit-lora -- cell flux2-dev-edit-lora-1024-4-blocks: the same
                     at 2 + 2 blocks with control latents (8,704 keys), the
                     output cut to the target's 4,096 rows.
    slice-auraflow-lora -- cell auraflow-v0.3-lora-1024: AuraFlow v0.3 at its
                     published size (4 + 32 blocks, 12 heads of 256, 6.8 B)
                     as examples/auraflow.toml trains it (fp8 storage, LoRA
                     r32, adamw8bit, `true`), batch 2 at 1024 px with 256
                     T5 rows: 4,360 keys at D 256; 72 / 36 / 36 a step.
    mistral3       -- Mistral-Small-3.1's language model (24 B, bf16) from a
                     seed: FLUX.2's text function (layers 10, 20, 30 stacked
                     per token) on 1 x 512 ids, timed; a narrow 32-layer
                     copy against f32 on the CPU.
    pile-t5        -- AuraFlow's text function on a T5 encoder at
                     Pile-T5-XL's size, 2 x 256 ids, bf16 against f32.
    driver-flux2 / driver-auraflow -- each family through train.main at full
                     width and cut depth (2 + 2 / 1 + 2 blocks, fp8
                     storage) at 512 px, with a seeded VAE (FLUX.2's with
                     its batch-norm statistics; SDXL's) and seeded text in
                     the published layouts, as driver-sd3: 3 steps with the
                     eval, a resume to 5 with --test_sample, the adapter
                     re-imported bit for bit.

18. kernels-lumina -- (run last) the ptxas records of the D 128 instances that run D 96
                     and 120 (TMA's zero fill past D): no spill, no C7512;
                     K1-K3 at Lumina 2's joint sequence (B 2 x 4,352, 24
                     heads of 96, 60 / 200 of 256 caption keys valid), its
                     noise refiner (B 2 x 4,096, unmasked) and OmniGen2's
                     (B 1 x 4,352, 21 heads of 120, 60 valid) against the
                     plain versions, K2 / K3 deterministic there; bf16 and
                     fp16 at a ragged S 1,000, masked and not; inputs that
                     are column slices of NaN-filled buffers; an all-masked
                     batch element on both K3 paths; each shape timed
                     beside its bound (on the true D), the plain versions
                     and SDPA's forward and backward.
    reference-lumina2 / -zimage / -omnigen2 -- 1 main block and 1 + 1
                     refiners at each family's full width and head dim (96,
                     128 with pad tokens, 120), bf16 on the card against
                     f32 on the CPU.
    slice-lumina2-lokr -- cell lumina2-lokr-1024: Lumina-Image-2.0 at its
                     published size (26 + 2 + 2 blocks, 2,304 wide, 24 heads
                     of 96 over 8, 1.97 B) as examples/lumina_2.toml trains
                     it (LoKr factor -1, genericoptim, `true`, bf16,
                     lumina_shift), batch 2 at 1024 px with 256 caption rows,
                     60 and 200 valid: 56 / 30 / 30 launches a step (the
                     refiners are not checkpointed).
    slice-omnigen2-lora -- cell omnigen2-lora-1024: OmniGen2 at full width
                     (2,520, 21 heads of 120 over 7), 4 + 2 + 2 blocks, LoRA
                     r32, adamw8bit, `true`, batch 1 at 1024 px, 256
                     Qwen2.5-VL rows (200 valid).
    driver-lumina2 / driver-zimage -- each family through train.main at full
                     width with 2 main blocks (and 2 + 2 refiners) at 512
                     px, the vae phase's Flux VAE and seeded caption rows
                     with their masks, as driver-sd3; Lumina 2 with
                     examples/lumina_2.toml's LoKr (per-part fused qkv
                     factors), Z-Image at its published layout (head dim
                     128, pad tokens, RoPE (32, 48, 48)) with LoRA r32.

19. kernels-hidream -- (run last) K1-K3 at HiDream-I1's joint sequence at 1024 px
                     (B 1 x 4,480 = 4,096 image rows + 128 T5 + 2 x 128
                     Llama rows, 20 heads of 128, unmasked) against the
                     plain versions, K2 / K3 deterministic, timed beside the
                     bound, the plain versions and SDPA.
    reference-hidream -- 1 + 1 blocks at 256 wide (2 heads of 128, 2 experts
                     top 2 and a shared one, LoRA on the experts too), bf16
                     on the card against f32 on the CPU.
    llama31        -- HiDream's Llama text function on Llama-3.1-8B at its
                     published size (llama3 RoPE scaling) from a seed: the
                     stacked states of all 32 layers for 2 x 128 ids, timed
                     with the peak, in bf16 and in fp8 storage
                     (llama3_4bit), fp8 held against bf16; a narrow copy
                     against f32 on the CPU.
    slice-hidream-lora -- cell hidream-i1-lora-1024: HiDream-I1 at its
                     published size (16 + 32 blocks, 2,560 wide, 17.1 B)
                     in bf16, LoRA r32 on every block linear (the routed
                     experts' too), adamw8bit, `true`, batch 1 at 1024 px
                     with 128 T5 rows and 32 cached Llama layers of 128
                     rows: 96 / 48 / 48 launches a step.
    driver-hidream -- HiDream through train.main at full width and 1 + 2
                     blocks in fp8 storage at 512 px, the vae phase's Flux
                     VAE and seeded text at the cached shapes, as
                     driver-sd3.

20. kernels-cosmos -- (run last) K1-K3 at the MiniTrainDIT's shapes, heads of
                     128, unmasked: Cosmos-Predict2 / Anima at 1024 px (B 2
                     x 4,096 x 16 heads, and its cross-attention to 512 T5
                     rows) and Cosmos-1 at 960 x 704 (B 1 x 2,640, a ragged
                     last tile, x 32 heads, and its cross-attention to
                     512), against the plain versions (K2 / K3
                     deterministic at 2,640), timed beside the bound, the
                     plain versions and SDPA.
    reference-cosmos / reference-cosmos-edm -- 2 blocks at 256 wide (2
                     heads of 128, adaLN-LoRA, LoRA on the modulations too),
                     bf16 on the card against f32 on the CPU: as Predict2
                     with Anima's LLMAdapter in front, and under EDM.
    qwen3-0.6b     -- Anima's text tower at its published size from a seed:
                     the final normed states of 2 x 512 ids, timed with the
                     peak; a narrow copy against f32 on the CPU.
    cosmos-tokenizer -- the Cosmos tokenizer at its published widths from a
                     seed, written as a checkpoint and read back by its
                     converter; bf16 against f32 on the CPU on a crop; the
                     121-frame 960 x 704 clip encoded to [1, 16, 16, 88,
                     120] and decoded, timed with the peak.
    slice-anima-lora -- cell anima-lora-1024: Cosmos-Predict2 at its full 2 B
                     size with Anima's LLMAdapter (f32, trained at its own
                     llm_adapter_lr) in bf16, LoRA r32, adamw8bit, `true`,
                     batch 2 at 1024 px with 512 T5 ids (60 valid) and 512
                     Qwen rows (77 valid): 112 / 56 / 56 launches a step.
    slice-cosmos1-lora -- cell cosmos1-7b-lora-704x960: Cosmos-1 at its full
                     7 B size in bf16, EDM, LoRA r32, adamw8bit, `true`,
                     batch 1 at 960 x 704 with 512 T5 rows: 112 / 56 / 56.
    driver-anima / driver-predict2 / driver-cosmos -- each family through
                     train.main at full width and 2 blocks at 512 px, as
                     driver-sd3: Anima and Cosmos-Predict2 from a seeded
                     2-block checkpoint (the layout from its keys; Anima's
                     LLMAdapter under llm_adapter.*) with the wan-vae phase's
                     Wan 2.1 VAE, Anima's trained LLMAdapter exported
                     beside the LoRA and re-imported bit for bit; Cosmos-1
                     on the cosmos-tokenizer phase's checkpoint, which
                     also encodes a 9-frame clip through the caching
                     function.

21. kernels-hunyuan -- (run last) K1-K3 at HunyuanVideo's joint sequence (B 1
                     x 9,472 = 9,216 image rows of a 33-frame 512 px clip +
                     256 LLaVA rows, 60 valid; 24 heads of 128) and its
                     refiner's (256, 60 valid), HunyuanImage-2.1's at 2048
                     px (B 1 x 5,190 = 4,096 + 128 byT5 rows, 12 valid, +
                     966 Qwen rows, 80 valid; 28 heads) and its refiner's
                     (966, 80 valid), against the plain versions (K2 / K3
                     deterministic at the video joint shape), timed beside
                     the bound on the valid keys, the plain versions and
                     SDPA with the same mask.
    reference-hunyuan-video / reference-hunyuan-image -- 1 + 1 blocks and a
                     1-block refiner at 256 wide (2 heads of 128), bf16 on
                     the card against f32 on the CPU: 3 / 2 / 2 launches.
    hunyuan-vae    -- the published causal 3D VAE at its full widths from a
                     seed, written in diffusers' layout and read back: a
                     33-frame 512 px clip encoded to [1, 16, 9, 64, 64] and
                     decoded, bf16 timed with the peak; a 9-frame 256 px
                     crop against f32 on the card.
    llava-llama3   -- HunyuanVideo's LLaVA text function (video template,
                     crop 95, hidden_states[-3]) on Llama-3-8B's shapes from
                     a seed: 2 x (95 + 256) ids, the crop checked, timed;
                     a narrow copy against f32 on the CPU.
    byt5           -- HunyuanImage-2.1's glyph function on byT5-small's
                     encoder from a seed: 2 x 128 byte ids, a caption
                     without a quoted span zeroed, bf16 against f32.
    slice-hunyuan-video-lora -- cell hunyuan-video-lora-512x33: HunyuanVideo at
                     its published size (20 + 40 blocks, 12.8 B) in fp8
                     storage, LoRA r32 in bf16, adamw8bit, `true`, one
                     33-frame 512 px clip and 256 LLaVA rows (60 valid):
                     122 / 60 / 60 launches a step.
    slice-hunyuan-image-2.1-lora -- cell hunyuan-image-2.1-lora-2048:
                     HunyuanImage-2.1 at its published size (17.4 B) in
                     bf16, LoRA r32, adamw8bit, `true`, batch 1 at 2048 px
                     with 966 Qwen rows (80 valid) and 128 byT5 rows (12
                     valid): 122 / 60 / 60.
    driver-hunyuan-video / driver-hunyuan-image -- each family through
                     train.main at full width and 1 + 1 blocks at 512 px,
                     as driver-sd3: HunyuanVideo in fp8 storage with the
                     hunyuan-vae phase's VAE, HunyuanImage-2.1 with a
                     seeded 32x KL VAE of 64 latent channels; seeded text
                     at the cached shapes.

22. kernels-ltx-hv15 -- (run last) K1-K3 at HunyuanVideo-1.5's joint sequence
                     (B 1 x 10,310 = 9,216 image rows of a 33-frame 512 px
                     clip + 128 byT5 rows, 12 valid, + 966 Qwen rows, 80
                     valid; 16 heads of 128) and its refiner's (966, K1
                     alone on the path), LTX-Video's self-attention over the
                     6,144 tokens of a 121-frame 768 x 512 clip (32 heads
                     of 64) and its cross-attention to 128 T5 rows (40
                     valid), LTX-2's self-attention (32 heads of 128), its
                     cross-attention to the connector's 1,024 rows and the
                     connector's own (64 heads of 64, K1 alone), against the
                     plain versions, timed beside the bound on the valid
                     keys, the plain versions and SDPA with the same mask.
    reference-hunyuan-video-15 / reference-ltx-video / reference-ltx2 --
                     narrow models bf16 on the card against f32 on the CPU
                     (LTX-Video with a per-token t, 0 on its first frame).
    ltx-vae        -- the published LTX encoder at the 0.9.0 widths from a
                     seed, written in Lightricks' layout and read back: the
                     121-frame 768 x 512 clip encoded to [1, 128, 16, 16,
                     24] and decoded once, timed with the peak; a 9-frame
                     256 px crop against f32 on the card.
    gemma3-12b     -- LTX-2's text function on Gemma-3-12B's published
                     shapes from a seed: 2 x 512 ids, the last hidden
                     state, timed with the peak; a narrow copy against f32.
    slice-hunyuan-video-15-lora / slice-ltx-video-lora / slice-ltx2-lora --
                     cells hunyuan-video-15-lora-512x33 (8.3 B in bf16, a
                     33-frame 512 px clip: 110 / 54 / 54 launches a step),
                     ltx-video-2b-lora-768x512x121 (1.9 B in bf16,
                     first_frame_conditioning_p 0.5: 112 / 56 / 56) and
                     ltx2-lora-768x512x121-fp8 (12.9 B of blocks in fp8
                     storage, 512 Gemma rows: 194 / 96 / 96), LoRA r32,
                     adamw8bit, `true`.
    driver-hunyuan-video-15 / driver-ltx-video / driver-ltx2 -- each family
                     through train.main at full width and 2 blocks, each
                     512 px picture cached as a 9-frame clip: HunyuanVideo-
                     1.5 with a seeded 16x causal VAE of 32 latent channels,
                     LTX-Video (first_frame_conditioning_p 1) and LTX-2 (fp8
                     storage) with the ltx-vae phase's VAE.

Then it prints the kernels' JSON line (K1-K4 at the Wan path's shape, with
their numbers at the other shapes beside; H1 and H2, which replace no
Pallas kernel, at the Flux fp8-int8 path's; each with its launches in the
driver phases and the other Wan cells), the card's name and power
limit from nvidia-smi, and last {"ok": true, "device": {...}}. Any failed
check raises and exits non-zero. Float32 references run with TF32 off
(matmul and cuDNN).
"""

import dataclasses
import functools
import gc
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16, NVIDIA data sheet
PEAK_F32_FLOPS = 67e12     # H100 SXM f32 outside the tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
SEED = 0
TIMED_STEPS = 5
WAN_TIMED_STEPS = 3
KERNEL_SOURCES = {  # wrapper name -> (source, the TPU kernel it replaces)
    "flash_fwd": ("diffusion_pipe_tpu_torch/csrc/flash_fwd.cu",
                  "diffusion_pipe_tpu/ops/flash_attention.py:59"),
    "flash_bwd_dq": ("diffusion_pipe_tpu_torch/csrc/flash_bwd_dq.cu",
                     "diffusion_pipe_tpu/ops/flash_attention.py:217"),
    "flash_bwd_dkv": ("diffusion_pipe_tpu_torch/csrc/flash_bwd_dkv.cu",
                      "diffusion_pipe_tpu/ops/flash_attention.py:264"),
    "sr_add": ("diffusion_pipe_tpu_torch/csrc/stochastic_round.cu",
               "diffusion_pipe_tpu/ops/quant.py:22"),
    # not Pallas kernels: the XLA-fused quantization and rescale around the
    # JAX package's int8 dot_general
    "quant_rows": ("diffusion_pipe_tpu_torch/csrc/int8_quant.cu",
                   "diffusion_pipe_tpu/models/layers.py:126 (not Pallas)"),
    "rescale_i32": ("diffusion_pipe_tpu_torch/csrc/int8_quant.cu",
                    "diffusion_pipe_tpu/models/layers.py:157 (not Pallas)"),
}
FLASH = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
INT8 = ("quant_rows", "rescale_i32")
NO_INT8 = {name: 0 for name in INT8}


class CheckFailed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


_T0 = time.perf_counter()


def emit(**record):
    """One JSON line, with the seconds since the smoke started (at_s)."""
    print(json.dumps({**record, "at_s": round(time.perf_counter() - _T0, 1)}), flush=True)


def cuda_ms(fn, iters=20):
    """Mean device time of fn() over `iters` launches, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_device_ms(fn, kernel, iters=20):
    """Mean device time a call of fn spends in the CUDA kernels whose name
    holds `kernel`, from torch.profiler, after one warm-up: for a kernel
    shorter than its wrapper's host time, where cuda_ms measures the launch
    rate instead. Returns (ms, kernels the trace held of its lead + iters
    calls)."""
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    # a trace can miss its first kernels (19 of 20 seen on the H100, in three
    # traces running): each trace starts with `lead` calls that are not
    # timed, and the last `iters` kernels it holds are. It may miss at most
    # those `lead`, and hold no more kernels than calls; it is taken again,
    # up to three times, until it holds at least `iters`.
    lead = 2
    for attempt in range(1, 4):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(lead + iters):
                fn()
            torch.cuda.synchronize()
        seen = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                      if e.device_type == DeviceType.CUDA and kernel in e.name)
        check(len(seen) <= lead + iters, f"the profiler saw {len(seen)} {kernel} kernels "
              f"in {lead + iters} calls, more than one a call")
        if len(seen) >= iters:
            break
    check(len(seen) >= iters, f"the profiler saw {len(seen)} {kernel} kernels in "
          f"{lead + iters} calls ({attempt} traces), more than the {lead} lead calls missing")
    return sum(end - start for start, end in seen[-iters:]) / 1e3 / iters, len(seen)


def queued_ms(fn, iters=20, sleep_cycles=200_000_000):
    """Mean device time of a call of fn, every kernel it launches included,
    after one warm-up: the card first spins for `sleep_cycles` (~0.1 s)
    while the host queues all `iters` calls, and CUDA events time them run
    back to back. For calls shorter than their host time, where events
    around calls launched one by one read the launch rate."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    torch.cuda._sleep(sleep_cycles)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    queue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    spin_s = time.perf_counter() - t0
    # the spin must outlast the queueing, or the events time launch gaps
    check(queue_s < 0.5 * spin_s, f"queueing {iters} calls took {queue_s:.4f} s of the "
          f"{spin_s:.4f} s the card was busy: raise sleep_cycles")
    return start.elapsed_time(end) / iters


def bound(flops, nbytes, peak_flops=PEAK_BF16_FLOPS):
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _kernel_modules():
    from diffusion_pipe_tpu_torch.ops import flash_attention, int8_quant, quant

    return flash_attention, quant, int8_quant


def reset_launch_counts():
    for mod in _kernel_modules():
        mod.reset_launch_counts()


def launch_counts():
    """{kernel name: launches since the last reset} for K1-K4, H1 and H2,
    each kernel named by its wrapper without the "_cuda" suffix."""
    return {name.removesuffix("_cuda"): n for mod in _kernel_modules()
            for name, n in mod.launch_counts().items()}


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _free(device="cuda"):
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


# --- phase 1 ------------------------------------------------------------------


_PTXAS_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")
_PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_PTXAS_NAME = re.compile(r"'(_Z\w+)'")


def ptxas_entries(text):
    """{mangled kernel name: {"registers", "spill_stores", "spill_loads",
    "wgmma_serialized"}} from nvcc -Xptxas -v output (the registers are
    those at entry, before any setmaxnreg; wgmma_serialized: ptxas warned
    C7512, every wgmma of the kernel waits for the one before)."""
    out, cur = {}, None
    serialized = {name for ln in text.splitlines() if "C7512" in ln
                  for name in _PTXAS_NAME.findall(ln)}
    for ln in text.splitlines():
        m = _PTXAS_ENTRY.search(ln)
        if m:
            cur = out.setdefault(m.group(1), {"wgmma_serialized": m.group(1) in serialized})
            continue
        if cur is None:
            continue
        m = _PTXAS_SPILL.search(ln)
        if m:
            cur.update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = _PTXAS_REGS.search(ln)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def main_ptxas(entries, tag="Li128ELb0E"):
    """The bf16, D = 128 instance of a flash kernel (the main path's); with
    tag "Li128ELb1E", the instance that runs D 96 and 120 on its tiles."""
    for name, rec in entries.items():
        if "nv_bfloat16" in name and tag in name:
            return rec
    return None


def phase_build():
    """Builds the kernels; returns {source name: ptxas entries}."""
    from diffusion_pipe_tpu_torch.ops import kernel_build

    t0 = time.perf_counter()
    report = kernel_build.build_all()
    ptxas = {name: ptxas_entries(r["ptxas"]) for name, r in report.items()}
    emit(phase="build", seconds=time.perf_counter() - t0,
         per_source_seconds={n: r["seconds"] for n, r in report.items()},
         cached={n: r["cached"] for n, r in report.items()}, ptxas=ptxas)
    return ptxas


# --- phase 2 ------------------------------------------------------------------


def _attn_inputs(b, sq, skv, h, d, masked, gen, dtype=torch.bfloat16, guard=False):
    """q, k, v, dO (in dtype) and the key mask; guard: each tensor the
    column slice [..., :d] of a [..., 128]-wide buffer whose spare columns
    hold NaN (a kernel that read past D would spread them)."""
    dev = "cuda"

    def draw(s):
        x = torch.randn((b, s, h, d), generator=gen, device=dev).to(dtype)
        if not guard:
            return x
        buf = torch.full((b, s, h, 128), float("nan"), dtype=dtype, device=dev)
        buf[..., :d] = x
        return buf[..., :d]

    q, do = (draw(sq) for _ in range(2))
    k, v = (draw(skv) for _ in range(2))
    mask = None
    if masked:
        # text padding: element 0 keeps 300 of its 512 text tokens, element 1
        # all of them; image tokens (after the text) are always valid. A
        # slice names element 0's masked keys instead, a tuple of slices
        # each element's.
        mask = torch.ones((b, skv), dtype=torch.int32, device=dev)
        for i, keys in enumerate(_masked_keys(masked)):
            mask[i, keys] = 0
    return q, k, v, do, mask


def _masked_keys(masked):
    """The masked keys of each batch element, from the first on."""
    if isinstance(masked, tuple):
        return masked
    return (slice(300, 512) if masked is True else masked,)


def _plain_all(fa, q, k, v, do, mask, scale):
    o, lse = fa.flash_forward_plain(q, k, v, mask, scale)
    di = fa.row_dot(do, o)
    return (o, lse, fa.flash_bwd_dq_plain(q, k, v, mask, lse, di, do, scale),
            *fa.flash_bwd_dkv_plain(q, k, v, mask, lse, di, do, scale))


def _kernel_all(fa, q, k, v, do, mask, scale):
    o, lse = fa.flash_fwd_cuda(q, k, v, mask, scale)
    di = fa.row_dot(do, o)
    dq = fa.flash_bwd_dq_cuda(q, k, v, mask, lse, di, do, scale)
    dk, dv = fa.flash_bwd_dkv_cuda(q, k, v, mask, lse, di, do, scale)
    return o, lse, dq, dk, dv


ERR_KEYS = {"flash_fwd": ("o", "lse"), "flash_bwd_dq": ("dq",),
            "flash_bwd_dkv": ("dk", "dv")}


def _check_attention(fa, case, b, sq, skv, h, d, masked, gen, heads=None,
                     dtype=torch.bfloat16, guard=False):
    """K1-K3 against their plain versions on one case; returns the errors.
    heads: a slice of the heads to check, taken as strided views of the
    [B, S, h, D] inputs (the plain versions' f32 logits grow with each);
    dtype and guard as _attn_inputs takes them."""
    scale = d ** -0.5
    q, k, v, do, mask = _attn_inputs(b, sq, skv, h, d, masked, gen, dtype, guard)
    if heads is not None:
        q, k, v, do = (x[:, :, heads] for x in (q, k, v, do))
    ref = _plain_all(fa, q.float(), k.float(), v.float(), do.float(), mask, scale)
    plain = _plain_all(fa, q, k, v, do, mask, scale)
    got = _kernel_all(fa, q, k, v, do, mask, scale)
    torch.cuda.synchronize()
    rec = {}
    for name, g, p, r in zip(("o", "lse", "dq", "dk", "dv"), got, plain, ref):
        check(g.shape == r.shape and bool(torch.isfinite(g).all()),
              f"{case}/{name}: shape {tuple(g.shape)} or non-finite values")
        err = (g.float() - r).abs().max().item()
        plain_err = (p.float() - r).abs().max().item()
        floor = 1e-3 * r.abs().max().item()
        rec[name] = dict(err=err, plain_err=plain_err, floor=floor)
        check(err <= 2 * plain_err + floor,
              f"{case}/{name}: kernel error {err} > 2 * {plain_err} + {floor}")
    if masked:
        # the padded keys get no gradient
        for i, keys in enumerate(_masked_keys(masked)):
            check(bool((got[3][i, keys] == 0).all() and (got[4][i, keys] == 0).all()),
                  "masked keys received dK/dV")
    emit(phase="kernels", case=case, q_shape=[b, sq, h, d], kv_len=skv, masked=bool(masked),
         checked_heads=q.shape[2], dtype=str(dtype).removeprefix("torch."),
         nan_guarded_columns=guard, errors=rec)
    return rec


def _time_attention(fa, b, sq, skv, h, d, gen, with_plain=True, masked=False):
    """Each kernel's time, its bound, its plain version's (when with_plain)
    and SDPA's forward as the yardstick of K1, on unmasked inputs (masked:
    with that key mask, SDPA given the same one as a boolean mask); SDPA's
    backward (dQ, dK, dV in one call) is the yardstick of K2 + K3. Every
    time is queued_ms's: calls run back to back behind a spin of the card,
    so a call shorter than its host time reads its device time too. The
    bound counts the valid keys only: what this run's data needs."""
    scale = d ** -0.5
    q, k, v, do, mask = _attn_inputs(b, sq, skv, h, d, masked, gen)
    o, lse = fa.flash_fwd_cuda(q, k, v, mask, scale)
    di = fa.row_dot(do, o)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True) for x in (q, k, v))
    sdpa_mask = None if mask is None else mask.bool()[:, None, None, :]
    sdpa_out = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=sdpa_mask)
    dot_ = do.transpose(1, 2).contiguous()

    def plain_ms(fn):
        return queued_ms(fn, 5) if with_plain else None

    timing = {
        "flash_fwd": dict(
            ms=queued_ms(lambda: fa.flash_fwd_cuda(q, k, v, mask, scale)),
            plain_ms=plain_ms(lambda: fa.flash_forward_plain(q, k, v, mask, scale)),
            library_ms=queued_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qt.detach(), kt.detach(), vt.detach(), attn_mask=sdpa_mask))),
        "flash_bwd_dq": dict(
            ms=queued_ms(lambda: fa.flash_bwd_dq_cuda(q, k, v, mask, lse, di, do, scale)),
            plain_ms=plain_ms(lambda: fa.flash_bwd_dq_plain(q, k, v, mask, lse, di, do, scale)),
            library_ms=None),
        "flash_bwd_dkv": dict(
            ms=queued_ms(lambda: fa.flash_bwd_dkv_cuda(q, k, v, mask, lse, di, do, scale)),
            plain_ms=plain_ms(lambda: fa.flash_bwd_dkv_plain(q, k, v, mask, lse, di, do, scale)),
            library_ms=None),
    }
    sdpa_bwd_ms = queued_ms(
        lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), dot_, retain_graph=True))

    nq, nk = b * sq * h * d, b * skv * h * d  # elements of a query-/key-side tensor
    rows = b * h * sq
    valid = b * skv if mask is None else int(mask.sum().item())  # valid (element, key) pairs
    pair = h * sq * valid * d
    nkv = valid * h * d  # elements of K or V that the valid keys need read
    work = {  # flops, bytes (each input read once, each output written once; K and V
        # read on the valid keys, K3's dK and dV written whole: masked keys get zeros)
        "flash_fwd": (4 * pair, 2 * (2 * nq + 2 * nkv) + 4 * rows),
        "flash_bwd_dq": (6 * pair, 2 * (3 * nq + 2 * nkv) + 2 * 4 * rows),
        "flash_bwd_dkv": (8 * pair, 2 * (2 * nq + 2 * nkv + 2 * nk) + 2 * 4 * rows),
    }
    for name, (flops, nbytes) in work.items():
        t, by = bound(flops, nbytes)
        timing[name].update(bound_ms=t, bound_by=by, flops=flops, bytes=nbytes,
                            bound_share=t / timing[name]["ms"])
    timing["flash_fwd"]["library_factor"] = (timing["flash_fwd"]["ms"]
                                             / timing["flash_fwd"]["library_ms"])
    # K2 and K3 together against SDPA's backward, which computes dQ, dK, dV
    timing["flash_bwd_dkv"]["k2_k3_factor_vs_sdpa_bwd"] = (
        (timing["flash_bwd_dq"]["ms"] + timing["flash_bwd_dkv"]["ms"]) / sdpa_bwd_ms)
    return timing, sdpa_bwd_ms


def _check_bwd_deterministic(fa, case, b, sq, skv, h, d, gen, masked=False):
    """Two K2 launches on the same inputs (masked: with that key mask) give
    the same bits, and so do two K3 launches; returns K3's split count."""
    scale = d ** -0.5
    q, k, v, do, mask = _attn_inputs(b, sq, skv, h, d, masked, gen)
    o, lse = fa.flash_fwd_cuda(q, k, v, mask, scale)
    di = fa.row_dot(do, o)
    dq = [fa.flash_bwd_dq_cuda(q, k, v, mask, lse, di, do, scale) for _ in range(2)]
    first = fa.flash_bwd_dkv_cuda(q, k, v, mask, lse, di, do, scale)
    splits = fa.flash_bwd_dkv_cuda.last_splits
    second = fa.flash_bwd_dkv_cuda(q, k, v, mask, lse, di, do, scale)
    torch.cuda.synchronize()
    check(fa.flash_bwd_dkv_cuda.last_splits == splits,
          f"K3 at the {case} shape launched with two split counts")
    dq_same = torch.equal(dq[0], dq[1])
    dkv_same = all(torch.equal(x, y) for x, y in zip(first, second))
    emit(phase="kernels", case=f"bwd_determinism_{case}", q_shape=[b, sq, h, d],
         kv_len=skv, query_splits=splits, dq_bit_identical=dq_same,
         dkv_bit_identical=dkv_same)
    check(dq_same, f"K2 at the {case} shape differs between two launches")
    check(dkv_same, f"K3 at the {case} shape differs between two launches")
    return splits


def _check_all_masked(fa, case, b, sq, skv, h, d, gen):
    """Batch element 0 has no valid key: K1 gives O = 0 and the mask value
    as its LSE, K2 and K3 give zero gradients; element 1 is unmasked and
    finite. Returns K3's split count."""
    scale = d ** -0.5
    q, k, v, do, _ = _attn_inputs(b, sq, skv, h, d, False, gen)
    mask = torch.ones((b, skv), dtype=torch.int32, device="cuda")
    mask[0] = 0
    got = _kernel_all(fa, q, k, v, do, mask, scale)
    splits = fa.flash_bwd_dkv_cuda.last_splits
    torch.cuda.synchronize()
    o, lse, dq, dk, dv = got
    finite = all(bool(torch.isfinite(x).all()) for x in got)
    zero = all(bool((x[0] == 0).all()) for x in (o, dq, dk, dv))
    lse_ok = bool((lse[0] == fa.DEFAULT_MASK_VALUE).all())
    emit(phase="kernels", case=f"all_masked_{case}", q_shape=[b, sq, h, d], kv_len=skv,
         query_splits=splits, finite=finite, zero_outputs=zero, lse_is_mask_value=lse_ok)
    check(finite and zero and lse_ok,
          f"{case}: a batch element with no valid key gave non-zero or non-finite "
          f"outputs (finite {finite}, zero {zero}, LSE {lse_ok})")
    return splits


def phase_kernels():
    """K1-K3 checked and timed; returns {shape name: {kernel: timing}}."""
    from diffusion_pipe_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    b, h, d = 2, 24, 128
    errors = {}
    for case, s, masked in (("main", 1536, False), ("masked", 1536, True),
                            ("ragged", 1000, False)):
        errors[case] = _check_attention(fa, case, b, s, s, h, d, masked, gen)
    errors["wan_cross"] = _check_attention(fa, "wan_cross", 1, 21504, 512, 12, d, False, gen)
    _free()
    # Wan self-attention (336 key tiles a query tile): heads 5 and 6 of the
    # 12, about 3.7 GB of f32 logits for each plain version
    errors["wan_self"] = _check_attention(fa, "wan_self", 1, 21504, 21504, 12, d, False, gen,
                                          heads=slice(5, 7))
    _free()
    # K2, and K3's query split (Wan cross: 48 key tiles on 132 SMs) and its
    # plain path (Flux: 576 key tiles), each give the same bits twice
    check(_check_bwd_deterministic(fa, "wan_cross", 1, 21504, 512, 12, d, gen) > 1,
          "the Wan cross shape did not take K3's query split")
    check(_check_bwd_deterministic(fa, "flux", b, 1536, 1536, h, d, gen) == 1,
          "the Flux shape took K3's query split")
    # a batch element with every key masked, on both of K3's paths: the Wan
    # cross shape at B = 2 (96 key tiles) and the Flux shape
    check(_check_all_masked(fa, "wan_cross", 2, 21504, 512, 12, d, gen) > 1,
          "the B = 2 Wan cross shape did not take K3's query split")
    check(_check_all_masked(fa, "flux", b, 1536, 1536, h, d, gen) == 1,
          "the Flux shape took K3's query split")
    _free()

    timings = {}
    for shape, (tb, sq, skv, th), err_case, with_plain in (
            ("flux", (b, 1536, 1536, h), "main", True),
            ("wan_cross", (1, 21504, 512, 12), "wan_cross", True),
            ("wan_self", (1, 21504, 21504, 12), "wan_self", False)):
        timing, sdpa_bwd_ms = _time_attention(fa, tb, sq, skv, th, d, gen, with_plain)
        for name, tm in timing.items():
            tm["max_abs_err"] = max(errors[err_case][k]["err"] for k in ERR_KEYS[name])
        emit(phase="kernels", case=f"timing_{shape}", q_shape=[tb, sq, th, d], kv_len=skv,
             timing=timing, sdpa_bwd_ms=sdpa_bwd_ms)
        timings[shape] = timing
        _free()
    return timings


SR_SHAPE = (8960, 1536)  # Wan2.1-1.3B ffn_in weight, the largest leaf
SR_SEEDS = 64


def phase_sr_kernel():
    """K4 against its plain version at the largest Wan leaf; returns its
    timing, with bf16 updates (the main path's: adamw's bf16 moments give a
    bf16 update) and f32 updates beside."""
    from diffusion_pipe_tpu_torch.ops import quant

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    n = math.prod(SR_SHAPE)
    p = (torch.randn(SR_SHAPE, generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
    out = {}
    for udtype in (torch.bfloat16, torch.float32):
        # an update of the main path's size: lr 2e-5 times an Adam direction ~1
        u = (torch.randn(SR_SHAPE, generator=gen, device="cuda") * 2e-5).to(udtype)
        x = p.float() + u.float()
        want = quant.sr_add_plain(p, u, 7)
        got = quant.sr_add_cuda(p.clone(), u, 7)
        torch.cuda.synchronize()
        check(torch.equal(got.view(torch.int16), want.view(torch.int16)),
              f"K4 ({udtype}) differs from its plain version")
        trunc = x.view(torch.int32) & -65536  # the bf16 neighbour toward zero
        lo, hi = trunc.view(torch.float32), (trunc + 65536).view(torch.float32)
        g = got.float()
        check(bool(((g == lo) | (g == hi)).all()), f"K4 ({udtype}): an output is no neighbour")
        # unbiased: the mean over seeds, over all elements, within 4 sigma
        acc = torch.zeros(SR_SHAPE, dtype=torch.float64, device="cuda")
        for s in range(SR_SEEDS):
            acc += quant.sr_add_cuda(p.clone(), u, s).double()
        gap = (hi.double() - lo.double()).abs()
        frac = torch.where(gap > 0, (x.double() - lo.double()).abs() / gap, 0.0)
        bias = (acc / SR_SEEDS - x.double()).sum().item() / n
        sigma = math.sqrt((gap * gap * frac * (1 - frac)).sum().item() / SR_SEEDS) / n
        up_share = (g == hi).float().mean().item()
        check(abs(bias) <= 4 * sigma, f"K4 ({udtype}): mean bias {bias} beyond 4 sigma {sigma}")

        q = p.clone()
        ms = cuda_ms(lambda: quant.sr_add_cuda(q, u, 1))
        plain_ms = cuda_ms(lambda: quant.sr_add_plain(p, u, 1), 5)
        nbytes = n * (2 + u.element_size() + 2)
        t, by = bound(n, nbytes, PEAK_F32_FLOPS)  # one f32 add an element
        name = "bf16_u" if udtype == torch.bfloat16 else "f32_u"
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=t, bound_by=by,
                         bytes=nbytes, flops=n, max_abs_err=(g - want.float()).abs().max().item(),
                         mean_bias=bias, sigma=sigma, rounded_up_share=up_share)
        emit(phase="sr-kernel", shape=list(SR_SHAPE), update_dtype=str(udtype),
             bit_equal=True, **out[name])
        del acc, gap, frac, x, lo, hi, g, got, want, q, u
        _free()
    return out


INT8_H1_CASES = {  # the Flux path's H1 inputs at ff_in: (rows, columns, column pre-scale)
    "forward_ff_in": (2048, 3072, False),     # x, bf16
    "dgrad_ff_in": (2048, 12288, True),       # the cotangent times the weight's scales
}
INT8_H2_SHAPE = (2048, 12288)  # ff_in's int32 product, rescaled to bf16
# (rows, in, out) of Flux block linears: ff_in, the single blocks' proj_out
# and norm1_linear (the batch's two rows, padded to 32 for torch._int_mm)
INT8_LINEAR_SHAPES = {"ff_in": (2048, 3072, 12288), "single_proj_out": (3072, 15360, 3072),
                      "norm1_linear": (2, 3072, 18432)}


def _device_ms(fn, kernel, queued):
    """(ms, kernels traced): torch.profiler's device time of `kernel`
    (kernel_device_ms) or, with queued, queued_ms's time of the calls (late
    in the smoke the profiler has dropped most of a trace's kernels)."""
    return (queued_ms(fn), None) if queued else kernel_device_ms(fn, kernel)


def _h1_timing(iq, case, m, k, prescale, gen, queued=False):
    x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
    col = torch.rand(k, generator=gen, device="cuda") * 1e-2 if prescale else None
    got8, got_s = iq.quant_rows_cuda(x, col)
    want8, want_s = iq.quant_rows_plain(x, col)
    torch.cuda.synchronize()
    equal = torch.equal(got8, want8) and torch.equal(got_s, want_s)
    err = (got8.int() - want8.int()).abs().max().item()
    # bf16 in, the pre-scale's f32 vector, int8 out and an f32 scale a row;
    # |v| max, divide, round, clamp (and the multiply) an element
    nbytes = 2 * m * k + (4 * k if prescale else 0) + m * k + 4 * m
    flops = (6 if prescale else 5) * m * k
    t, by = bound(flops, nbytes, PEAK_F32_FLOPS)
    ms, seen = _device_ms(lambda: iq.quant_rows_cuda(x, col), "quant_rows_kernel", queued)
    rec = dict(ms=ms, kernels_traced=seen,
               launch_ms=cuda_ms(lambda: iq.quant_rows_cuda(x, col)),
               plain_ms=cuda_ms(lambda: iq.quant_rows_plain(x, col), 5), library_ms=None,
               bound_ms=t, bound_by=by, bytes=nbytes, flops=flops, max_abs_err=err)
    rec["bound_share"] = t / rec["ms"]
    emit(phase="int8-kernels", kernel="quant_rows", case=case, shape=[m, k],
         column_prescale=prescale, bit_equal=equal, **rec)
    check(equal, f"H1 ({case}) differs from its plain version")
    return rec


def _h2_timing(iq, gen, shape=INT8_H2_SHAPE, case="ff_in", queued=False):
    m, n = shape
    y = torch.randint(-2 ** 20, 2 ** 20, (m, n), generator=gen, device="cuda",
                      dtype=torch.int32)
    rs = torch.rand((m, 1), generator=gen, device="cuda") * 1e-3
    cs = torch.rand(n, generator=gen, device="cuda") * 1e-3
    got = iq.rescale_i32_cuda(y, rs, cs, torch.bfloat16)
    want = iq.rescale_i32_plain(y, rs, cs, torch.bfloat16)
    torch.cuda.synchronize()
    equal = torch.equal(got, want)
    nbytes = 4 * m * n + 2 * m * n + 4 * m + 4 * n  # int32 in, bf16 out, the scales
    flops = 3 * m * n  # convert and two multiplies an element
    t, by = bound(flops, nbytes, PEAK_F32_FLOPS)
    ms, seen = _device_ms(lambda: iq.rescale_i32_cuda(y, rs, cs, torch.bfloat16),
                          "rescale_kernel", queued)
    rec = dict(ms=ms, kernels_traced=seen,
               launch_ms=cuda_ms(lambda: iq.rescale_i32_cuda(y, rs, cs, torch.bfloat16)),
               plain_ms=cuda_ms(lambda: iq.rescale_i32_plain(y, rs, cs, torch.bfloat16), 5),
               library_ms=None, bound_ms=t, bound_by=by, bytes=nbytes, flops=flops,
               max_abs_err=(got.float() - want.float()).abs().max().item())
    rec["bound_share"] = t / rec["ms"]
    emit(phase="int8-kernels", kernel="rescale_i32", case=case, shape=[m, n],
         bit_equal=equal, **rec)
    check(equal, "H2 differs from its plain version")
    return rec


def _int8_linear_timing(layers, iq, m, k, n, gen):
    """One int8 linear's forward (H1, torch._int_mm, H2) and its int8 dgrad
    (H1 with the pre-scale, a transposed copy of w8, torch._int_mm, H2)
    against torch.matmul in bf16 on the same shapes, with torch._int_mm
    alone beside; and the int8 forward's error against the bf16 product."""
    x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
    g = torch.randn((m, n), generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn((n, k), generator=gen, device="cuda") / math.sqrt(k)).to(
        torch.float8_e4m3fn)
    w8, scale = layers.quantize_kernel_int8(w)
    wb = w.to(torch.bfloat16)
    x8, _ = iq.quant_rows_cuda(x)
    y = layers._int8_forward(x, w8, scale)
    ref = torch.matmul(x, wb.t()).float()
    rec = dict(
        int8_forward_ms=cuda_ms(lambda: layers._int8_forward(x, w8, scale)),
        int_mm_ms=cuda_ms(lambda: iq.int_mm(x8, w8.t())),
        bf16_forward_ms=cuda_ms(lambda: torch.matmul(x, wb.t())),
        int8_dgrad_ms=cuda_ms(lambda: layers._int8_pq_dgrad8(g, w8, scale)),
        bf16_dgrad_ms=cuda_ms(lambda: torch.matmul(g, wb)),
        int8_forward_rel_l2=((y.float() - ref).norm() / ref.norm()).item())
    check(math.isfinite(rec["int8_forward_rel_l2"]) and rec["int8_forward_rel_l2"] < 5e-2,
          f"int8 linear [{m}, {k}] x [{k}, {n}] off the bf16 product: {rec}")
    return rec


def phase_int8_kernels():
    """H1 and H2 checked and timed at the Flux path's shapes, and one int8
    linear against bf16 at three block shapes; returns {kernel: timing}."""
    from diffusion_pipe_tpu_torch.models import layers
    from diffusion_pipe_tpu_torch.ops import int8_quant as iq

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    h1 = {case: _h1_timing(iq, case, *shape, gen) for case, shape in INT8_H1_CASES.items()}
    h2 = _h2_timing(iq, gen)
    _free()
    linears = {name: _int8_linear_timing(layers, iq, *shape, gen)
               for name, shape in INT8_LINEAR_SHAPES.items()}
    emit(phase="int8-linear", shapes={k: list(v) for k, v in INT8_LINEAR_SHAPES.items()},
         timing=linears)
    _free()
    return {"quant_rows": h1, "rescale_i32": h2}


# --- phase 3 ------------------------------------------------------------------


def _small_flux_run(model, latents_packed, t5, clip, t, img_ids, txt_ids, target):
    out = model(latents_packed, t5, clip, t, img_ids, txt_ids, guidance=torch.ones_like(t))
    loss = torch.mean((out.float() - target) ** 2)
    loss.backward()
    grads = {n: p.grad.float().cpu() for n, p in model.named_parameters() if p.requires_grad}
    return out.float().cpu(), loss.item(), grads


def _rel(a, b):
    return ((a - b).norm() / b.norm()).item()


def _compare_grads(grads, ref_grads):
    names = sorted(ref_grads)
    total = _rel(torch.cat([grads[n].flatten() for n in names]),
                 torch.cat([ref_grads[n].flatten() for n in names]))
    return total, max(_rel(grads[n], ref_grads[n]) for n in names)


def phase_reference(device="cuda"):
    from diffusion_pipe_tpu_torch.models.flux import latent_image_ids, pack_latents
    from diffusion_pipe_tpu_torch.models.flux_model import FluxConfig, FluxTransformer
    from diffusion_pipe_tpu_torch.models.layers import init_module_weights
    from diffusion_pipe_tpu_torch.training.train_state import lora_predicate

    def build(dtype, device):
        cfg = FluxConfig(num_layers=1, num_single_layers=1, num_attention_heads=2,
                         joint_attention_dim=64, pooled_projection_dim=32,
                         dtype=dtype, param_dtype=dtype, lora_rank=4, lora_alpha=4.0,
                         lora_dtype=dtype, remat="full")
        with torch.device(device):
            m = FluxTransformer(cfg)
        for n, p in m.named_parameters():
            p.requires_grad_(lora_predicate(n))
        return m

    cpu = build(torch.float32, "cpu")
    gen = torch.Generator().manual_seed(SEED)
    init_module_weights(cpu, gen)
    with torch.no_grad():
        for n, p in cpu.named_parameters():
            if n.endswith("lora_b"):
                p.normal_(0.0, 0.05, generator=gen)
    gpu = build(torch.bfloat16, device)
    gpu.load_state_dict(cpu.state_dict())

    # 16x16 latents -> 64 image tokens + 40 text tokens: 104, a ragged tile
    lat = torch.randn((1, 16, 16, 16), generator=gen)
    x = pack_latents(lat)
    t5 = torch.randn((1, 40, 64), generator=gen)
    clip = torch.randn((1, 32), generator=gen)
    t = torch.tensor([0.4])
    target = torch.randn(x.shape, generator=gen)
    img_ids = latent_image_ids(8, 8)
    txt_ids = torch.zeros((40, 3))
    ref_out, ref_loss, ref_grads = _small_flux_run(cpu, x, t5, clip, t, img_ids, txt_ids, target)

    reset_launch_counts()
    to = lambda z, dt=torch.bfloat16: z.to(device, dt)
    out, loss, grads = _small_flux_run(
        gpu, to(x), to(t5), to(clip), to(t, torch.float32), to(img_ids, torch.float32),
        to(txt_ids, torch.float32), to(target, torch.float32))
    counts = {k: launch_counts()[k] for k in FLASH}

    out_err = _rel(out, ref_out)
    grad_err, worst_grad_err = _compare_grads(grads, ref_grads)
    loss_err = abs(loss - ref_loss) / abs(ref_loss)
    emit(phase="reference", out_rel_l2=out_err, loss_rel=loss_err,
         lora_grads_rel_l2=grad_err, worst_lora_tensor_rel_l2=worst_grad_err,
         launches=counts)
    check(all(c > 0 for c in counts.values()), f"reference run skipped a kernel: {counts}")
    # bf16 against f32 through two blocks: about 1% expected on the output,
    # the loss and the LoRA gradients taken together
    check(out_err < 3e-2 and loss_err < 3e-2 and grad_err < 5e-2,
          f"reference mismatch: out {out_err}, loss {loss_err}, grads {grad_err}")


# --- phase 4 ------------------------------------------------------------------

SLICE_CONFIG = {
    "save_every_n_epochs": 1,
    "model": {"type": "flux", "dtype": "bfloat16", "guidance": 1.0},
    "adapter": {"type": "lora", "rank": 32, "alpha": 32, "dropout": 0.0},
    "optimizer": {"type": "adamw8bit", "lr": 1e-4},
    "gradient_clipping": 1.0,
    "activation_checkpointing": True,
}


def _fingerprint(params):
    return torch.stack([p.detach().float().sum() for p in params]).double()


def build_slice(cfg=SLICE_CONFIG, device="cuda", latent_hw=64, txt_len=512,
                batch_size=2):
    """The Flux path's trainer, its state, step and batch: Flux at the
    config's width and depth, random weights and inputs from SEED."""
    from diffusion_pipe_tpu_torch.models import get_model_class
    from diffusion_pipe_tpu_torch.training.optimizers import get_optimizer
    from diffusion_pipe_tpu_torch.training.train_state import lora_predicate
    from diffusion_pipe_tpu_torch.training.trainer import init_train_state, make_train_step

    pipeline = get_model_class("flux")(cfg, device=device)
    fc = pipeline.flux_config
    gen = torch.Generator(device=device).manual_seed(SEED)
    state = init_train_state(pipeline, get_optimizer(cfg), gen, lora_predicate)
    step = make_train_step(pipeline, gradient_clipping=cfg["gradient_clipping"])
    batch = {
        "latents": torch.randn((batch_size, 16, latent_hw, latent_hw), generator=gen,
                               device=device),
        "t5_embed": torch.randn((batch_size, txt_len, fc.joint_attention_dim),
                                generator=gen, device=device).to(fc.dtype),
        "clip_embed": torch.randn((batch_size, fc.pooled_projection_dim), generator=gen,
                                  device=device).to(fc.dtype),
    }
    return pipeline, state, step, batch, gen


# the adaLN modulation linears: their input, silu(temb), comes from the
# embedders alone, which LoRA leaves frozen, so it needs no gradient
MODULATION = ("norm1_linear", "norm1_context_linear", "norm_linear")


def _expected_launches(pipeline):
    """Launches a step of the Flux path's kernels for the pipeline's config:
    K1 once a block under "attn" and twice under "full" checkpointing, K2 and
    K3 once; H1 and H2 once an int8 linear for its forward, again for the
    checkpointed recompute, and under "fwd_bwd" once more for its dgrad,
    which autograd skips where the input needs no gradient (the 76
    modulation linears, with LoRA)."""
    from diffusion_pipe_tpu_torch.models.layers import LoraDense

    fc = pipeline.flux_config
    blocks = fc.num_layers + fc.num_single_layers
    int8 = [n for n, m in pipeline.model.named_modules()
            if isinstance(m, LoraDense) and m.kernel_scale is not None]
    no_dgrad = sum(int(n.endswith(MODULATION)) for n in int8) if fc.lora_rank else 0
    dgrads = len(int8) - no_dgrad if fc.int8_matmul == "fwd_bwd" else 0
    launches = len(int8) * (2 if fc.remat else 1) + dgrads
    return {"flash_fwd": blocks * (2 if fc.remat == "full" else 1),
            "flash_bwd_dq": blocks, "flash_bwd_dkv": blocks, "sr_add": 0,
            "quant_rows": launches, "rescale_i32": launches}


def _int8_weights(model):
    """(block linears, those whose weight is int8 with real scales: finite,
    positive and not the ones they start as, weight bytes of the block
    linears)."""
    from diffusion_pipe_tpu_torch.models.layers import LoraDense

    linears = [m for m in model.modules() if isinstance(m, LoraDense) and m.lora_rank > 0]
    real = [m for m in linears if m.weight.dtype == torch.int8 and m.kernel_scale is not None
            and bool(torch.isfinite(m.kernel_scale).all() and (m.kernel_scale > 0).all())
            and not bool((m.kernel_scale == 1).all())]
    nbytes = sum(m.weight.numel() * m.weight.element_size() for m in linears)
    return len(linears), len(real), nbytes


def phase_slice(phase="slice", cell="flux-dev-lora-512", cfg=SLICE_CONFIG, bf16_peak=None,
                attn_vs_true=False, every_moved=False, **slice_kw):
    """The Flux path at cfg; with bf16_peak (the bf16 phase's peak) also
    the fp8-int8 checks: every block linear int8 with real scales, and a
    lower peak. attn_vs_true: then the same model in alternating "attn" and
    `true` steps (_attn_vs_true). every_moved: every adapter tensor must
    move (LoKr: its zero-initialised w1 too), else one at least. Returns
    (launches, peak, step seconds)."""
    t0 = time.perf_counter()
    pipeline, state, step, batch, gen = build_slice(cfg=cfg, **slice_kw)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    model = pipeline.model
    n_params = sum(p.numel() for p in model.parameters())
    lora = list(state.trainable.values())
    frozen = [p for p in model.parameters() if not p.requires_grad]
    n_lora = sum(p.numel() for p in lora)
    lora0 = [p.detach().clone() for p in lora]
    frozen0 = _fingerprint(frozen)
    linears, int8_real, block_weight_bytes = _int8_weights(model)
    batch_size = batch["latents"].shape[0]

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    warm = step(state, batch, gen)
    warm_loss = warm["loss"].item()
    warm_s = time.perf_counter() - t0

    reset_launch_counts()
    t0 = time.perf_counter()
    metrics = [step(state, batch, gen) for _ in range(TIMED_STEPS)]
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / TIMED_STEPS
    counts = launch_counts()
    losses = [m["loss"].item() for m in metrics]
    norms = [m["grad_norm"].item() for m in metrics]
    peak = torch.cuda.max_memory_allocated()

    per_step = {k: v / TIMED_STEPS for k, v in counts.items()}
    expected = _expected_launches(pipeline)
    moved = sum(int(not torch.equal(p, p0)) for p, p0 in zip(lora, lora0))
    frozen_same = torch.equal(_fingerprint(frozen), frozen0)
    emit(phase=phase, cell=cell,
         params=n_params, lora_params=n_lora, block_linears=linears,
         int8_block_linears=int8_real, block_weight_bytes=block_weight_bytes,
         init_s=init_s, warmup_s=warm_s, warmup_loss=warm_loss, step_s=step_s,
         samples_per_s=batch_size / step_s, losses=losses, grad_norms=norms,
         peak_memory_bytes=peak, bf16_phase_peak_bytes=bf16_peak, launches=counts,
         launches_per_step=per_step, lora_tensors_moved=moved, lora_tensors=len(lora),
         frozen_unchanged=frozen_same)
    check(all(math.isfinite(x) for x in [warm_loss, *losses]), f"non-finite loss: {losses}")
    check(moved == len(lora) if every_moved else moved > 0,
          f"{moved} of {len(lora)} adapter tensors changed")
    check(frozen_same, "frozen weights changed")
    check(per_step == expected, f"launches per step {per_step}, expected {expected}")
    if cfg["model"].get("int8_matmul"):
        check(int8_real == linears, f"{linears - int8_real} of {linears} block linears "
              "lack an int8 weight with real scales")
    if bf16_peak is not None:
        check(peak < bf16_peak, f"peak {peak} not below the bf16 phase's {bf16_peak}")
    if attn_vs_true:
        _attn_vs_true(phase, pipeline, state, step, batch, gen)
    return counts, peak, step_s


ATTN_VS_TRUE_PAIRS = 8


def _attn_vs_true(phase, pipeline, state, step, batch, gen):
    """The cell under "attn" and under activation_checkpointing = true on
    the same model (the checkpointing spec is read at each forward; both
    compute the same losses and gradients, and true only launches K1 again
    in the recompute), in pairs of adjacent steps whose order alternates,
    each step ended by a synchronize. The host sets this step's time, and
    its steps scatter by about 0.15 s: pairing keeps the host's drift out of
    each difference. The "attn" step must take no longer than the true one:
    the mean of the pairs' differences (attn - true) may not exceed twice
    its standard error. Beside the wall clock, each step's process CPU time
    (every thread of this process): the host's work, which other tenants of
    the host's cores do not stretch, and which C1 was about."""
    import dataclasses
    import statistics

    model = pipeline.model
    specs = {"attn": model.cfg, "true": dataclasses.replace(model.cfg, remat="full")}
    times = {name: [] for name in specs}
    cpu = {name: [] for name in specs}
    counts = {name: {} for name in specs}
    try:
        for i in range(ATTN_VS_TRUE_PAIRS):
            for name in (("attn", "true") if i % 2 == 0 else ("true", "attn")):
                model.cfg = specs[name]
                reset_launch_counts()
                c0, t0 = time.process_time(), time.perf_counter()
                m = step(state, batch, gen)
                check(math.isfinite(m["loss"].item()), f"non-finite loss under {name}")
                torch.cuda.synchronize()
                times[name].append(time.perf_counter() - t0)
                cpu[name].append(time.process_time() - c0)
                for k, v in launch_counts().items():
                    counts[name][k] = counts[name].get(k, 0) + v
    finally:
        model.cfg = specs["attn"]

    def paired(x):
        diffs = [a - t for a, t in zip(x["attn"], x["true"])]
        return (statistics.fmean(diffs), statistics.stdev(diffs) / math.sqrt(len(diffs)),
                sum(int(d < 0) for d in diffs))

    mean_diff, stderr, attn_faster = paired(times)
    cpu_diff, cpu_stderr, attn_cheaper = paired(cpu)
    step_s = {name: statistics.fmean(t) for name, t in times.items()}
    per_step = {name: {k: v / ATTN_VS_TRUE_PAIRS for k, v in c.items()}
                for name, c in counts.items()}
    emit(phase=f"{phase}-attn-vs-true", pairs=ATTN_VS_TRUE_PAIRS,
         attn_step_s=step_s["attn"], true_step_s=step_s["true"],
         attn_median_s=statistics.median(times["attn"]),
         true_median_s=statistics.median(times["true"]),
         mean_diff_s=mean_diff, diff_stderr_s=stderr, pairs_attn_faster=attn_faster,
         attn_cpu_s=statistics.fmean(cpu["attn"]), true_cpu_s=statistics.fmean(cpu["true"]),
         cpu_mean_diff_s=cpu_diff, cpu_diff_stderr_s=cpu_stderr, pairs_attn_less_cpu=attn_cheaper,
         attn_steps_s=times["attn"], true_steps_s=times["true"], attn_cpu_steps_s=cpu["attn"],
         true_cpu_steps_s=cpu["true"], launches_per_step=per_step)
    blocks = pipeline.flux_config.num_layers + pipeline.flux_config.num_single_layers
    check(per_step["attn"]["flash_fwd"] == blocks and per_step["true"]["flash_fwd"] == 2 * blocks,
          f"K1 launches a step: {per_step}")
    check(mean_diff <= 2 * stderr,
          f'"attn" steps slower than true\'s by {mean_diff:.4f} s (standard error {stderr:.4f} s)')


FP8_INT8_CONFIG = {  # flux-dev-lora-512-fp8-int8: bench.py's Flux row
    **SLICE_CONFIG,
    "model": {**SLICE_CONFIG["model"], "transformer_dtype": "float8",
              "int8_matmul": "fwd_bwd"},
    "activation_checkpointing": "attn",
}


# --- the caching VAE and the training driver -----------------------------------

SMOKE_DIR = ROOT / "build" / "smoke"  # listed in .gitignore, inside the checkout
VAE_BATCH = (2, 3, 512, 512)
VAE_REL_L2 = 3e-2  # bf16 on the card against f32 on the CPU, relative L2
VAE_TIMED = 5


class _GcPauses:
    """The seconds the cyclic garbage collector stops the process, by
    generation, while the block runs: what a host-bound step pays for the
    objects that earlier phases left alive."""

    def __enter__(self):
        self.seconds, self._t0 = [0.0, 0.0, 0.0], None
        gc.callbacks.append(self._note)
        return self

    def _note(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.seconds[info["generation"]] += time.perf_counter() - self._t0

    def __exit__(self, *exc):
        gc.callbacks.remove(self._note)


def _fresh_dir(path):
    import shutil

    shutil.rmtree(path, ignore_errors=True)
    path.mkdir(parents=True)
    return path


def phase_vae():
    """The Flux VAE at full width (VAEConfig.flux: 83.8 M parameters), random
    weights from SEED written in the diffusers layout through the port's
    safetensors writer and loaded back by the Flux pipeline's VAE function
    (convert_diffusers_vae) in bf16 on the card, as the driver's caching
    phase loads it: the encode of a 2 x 3 x 512 x 512 batch against the same
    file's weights in f32 on the CPU, and its device time. Returns the
    weights' folder (the driver's model.vae_path)."""
    import numpy as np

    from diffusion_pipe_tpu_torch import safetensors_io
    from diffusion_pipe_tpu_torch.models import get_model_class
    from diffusion_pipe_tpu_torch.models.autoencoder_kl import (
        AutoencoderKL, VAEConfig, convert_diffusers_vae, diffusers_vae_state_dict)

    vae_dir = _fresh_dir(SMOKE_DIR / "vae")
    seeded = AutoencoderKL(VAEConfig.flux())
    seeded.init_weights(torch.Generator().manual_seed(SEED))
    path = vae_dir / "diffusion_pytorch_model.safetensors"
    safetensors_io.save_file(diffusers_vae_state_dict(seeded), path)
    ref = AutoencoderKL(VAEConfig.flux())
    ref.load_state_dict(convert_diffusers_vae(safetensors_io.load_file(path), ref.config))
    del seeded

    pipeline = get_model_class("flux")(_driver_config(vae_dir), device="cuda")
    encode = pipeline.get_call_vae_fn()
    pixels = np.random.default_rng(SEED).uniform(-1, 1, VAE_BATCH).astype(np.float32)
    t0 = time.perf_counter()
    z = encode(pixels)["latents"]
    first_call_s = time.perf_counter() - t0
    vae = pipeline._load_vae()
    x = torch.from_numpy(pixels).cuda()
    with torch.no_grad():
        ms = cuda_ms(lambda: vae.encode(x), iters=VAE_TIMED)
    t0 = time.perf_counter()
    with torch.no_grad():
        z_ref = ref.encode(torch.from_numpy(pixels))
    cpu_s = time.perf_counter() - t0
    rel = (torch.linalg.vector_norm(z - z_ref) / torch.linalg.vector_norm(z_ref)).item()
    emit(phase="vae", config="VAEConfig.flux", params=sum(p.numel() for p in vae.parameters()),
         weights_bytes=path.stat().st_size, input_shape=list(VAE_BATCH),
         latent_shape=list(z.shape), dtype=str(next(vae.parameters()).dtype),
         encode_ms=ms, first_call_s=first_call_s, cpu_f32_encode_s=cpu_s, rel_l2=rel,
         tolerance=VAE_REL_L2)
    check(tuple(z.shape) == (2, 16, 64, 64), f"latents {tuple(z.shape)}")
    check(bool(torch.isfinite(z).all()), "non-finite latents")
    check(rel <= VAE_REL_L2, f"VAE encode off the f32 CPU result: rel L2 {rel}")
    return vae_dir


DRIVER_IMAGES, DRIVER_EVAL_IMAGES = 8, 2
DRIVER_STEPS, DRIVER_RESUMED_STEPS = 3, 5
DRIVER_SAMPLE_STEPS = 4  # the --test_sample of the resumed call
SAMPLE_PROMPT = "a seeded picture, number 0"


def _driver_extras(train, argv, root, out_dir, size):
    """The resumed call's --test_sample output and a --dump_dataset call:
    {example_png: its size, dump_pngs: count, dump_sizes}; checks the
    sample's size and one PNG per cached training image, at its size."""
    from PIL import Image

    example = Image.open(out_dir / "example.png")
    dump = root / "dump"
    check(train.main(argv + ["--dump_dataset", str(dump)]) == 0, "--dump_dataset failed")
    pngs = sorted(dump.glob("img_*.png"))
    sizes = sorted({Image.open(p).size for p in pngs})
    out = dict(example_png=list(example.size), dump_pngs=len(pngs), dump_sizes=sizes)
    check(example.size == (size, size), f"example.png is {example.size}")
    check(len(pngs) == DRIVER_IMAGES and sizes == [(size, size)],
          f"--dump_dataset wrote {len(pngs)} PNGs of {sizes}")
    return out
DRIVER_TOML = """# flux-dev-lora-512-fp8-int8 (bench.py's Flux row) through the driver
output_dir = "{root}/out"
dataset = "{root}/dataset.toml"
eval_datasets = ["{root}/eval.toml"]
epochs = 100
micro_batch_size_per_gpu = 2
gradient_accumulation_steps = 1
gradient_clipping = 1.0
save_every_n_epochs = 1
eval_before_first_step = true
activation_checkpointing = "attn"
sample_steps = {sample_steps}

[model]
type = "flux"
dtype = "bfloat16"
transformer_dtype = "float8"
int8_matmul = "fwd_bwd"
guidance = 1.0
vae_path = "{vae}"

[adapter]
type = "lora"
rank = 32

[optimizer]
type = "adamw8bit"
lr = 1e-4
"""


def _driver_config(vae_dir):
    """The driver's config as a dict (what set_config_defaults gives)."""
    import tomllib

    from diffusion_pipe_tpu_torch.config import set_config_defaults

    return set_config_defaults(tomllib.loads(DRIVER_TOML.format(
        root=SMOKE_DIR, vae=vae_dir, sample_steps=DRIVER_SAMPLE_STEPS)))


def _write_images(folder, n, seed):
    import numpy as np
    from PIL import Image

    folder.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        Image.fromarray((rng.random((512, 512, 3)) * 255).astype(np.uint8)).save(
            folder / f"image{i}.png")
        (folder / f"image{i}.txt").write_text(f"a seeded picture, number {i}")


def _driver_step_times(metrics_file):
    """Host seconds between consecutive train/loss records of one call: a
    whole step of the driver (loader, host-to-device copies, the step, the
    loss read back), the first step of each call left out."""
    recs = [json.loads(line) for line in metrics_file.read_text().splitlines()]
    train = [r for r in recs if "train/loss" in r]
    return [b["time"] - a["time"] for a, b in zip(train, train[1:]) if b["step"] == a["step"] + 1
            and a["step"] != DRIVER_STEPS]


def phase_driver(vae_dir, fp8_step_s):
    """bench.py's Flux row (flux-dev-lora-512-fp8-int8) through the driver,
    python -m diffusion_pipe_tpu_torch.train, called as main(argv): 8
    seeded 512 px PNGs with captions and 2 for eval, the caching phase
    (--cache_only) with the vae phase's weights, then 3 steps with the
    9-quantile eval before the first, then a resume to step 5. The
    transformer starts from random init (no checkpoint here), and the text
    encoders are seeded stand-ins at T5's [512, 4096] and CLIP's [768] (no
    T5/CLIP weights here either). Checks: finite losses, the step counter at
    5, the loader position of an uninterrupted run, train/loss for every
    step and the nine eval quantiles in metrics.jsonl, every LoRA factor
    moved in each call and the int8 weights unchanged, the adapter's 988
    keys (2 per LoRA linear: the JAX export's count), and the launches:
    57 / 57 / 57 flash and 1,406 H1 and H2 a training step, plus 57 K1 and
    494 H1 and H2 an eval forward and 494 H1 a call for the pre-quantization
    of the frozen weights. Returns the driver's launches."""
    from diffusion_pipe_tpu_torch import safetensors_io, train
    from diffusion_pipe_tpu_torch.models import flux
    from diffusion_pipe_tpu_torch.models.layers import LoraDense
    from diffusion_pipe_tpu_torch.training import trainer

    root = _fresh_dir(SMOKE_DIR / "driver")
    _write_images(root / "train", DRIVER_IMAGES, SEED)
    _write_images(root / "eval", DRIVER_EVAL_IMAGES, SEED + 1)
    (root / "dataset.toml").write_text(f'resolutions = [512]\n[[directory]]\npath = "{root}/train"\n')
    (root / "eval.toml").write_text(f'resolutions = [512]\n[[directory]]\npath = "{root}/eval"\n')
    cfg_path = root / "flux_fp8_int8.toml"
    cfg_path.write_text(DRIVER_TOML.format(root=root, vae=vae_dir,
                                           sample_steps=DRIVER_SAMPLE_STEPS))
    argv = ["--config", str(cfg_path)]

    captured = []
    real_init = trainer.init_train_state
    real_te = flux.FluxPipeline.get_call_text_encoder_fns

    def init_and_keep(pipeline, *a, **kw):
        state = real_init(pipeline, *a, **kw)
        int8 = [p for p in pipeline.model.parameters() if p.dtype == torch.int8]
        captured.append((pipeline, state, _fingerprint(int8)))
        return state

    def run(extra, steps, lora_before):
        """One train.main call: its launches and peak, and what its state
        shows after it (lora_before: {name: tensor} or None for the init)."""
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        check(train.main(argv + extra) == 0, f"train.main {extra} failed")
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = launch_counts()
        pipeline, state, int8_print = captured.pop()
        int8 = [p for p in pipeline.model.parameters() if p.dtype == torch.int8]
        out = dict(steps=steps, wall_s=wall_s, launches=counts,
                   peak_memory_bytes=torch.cuda.max_memory_allocated(),
                   int8_weights=len(int8),
                   int8_unchanged=bool(torch.equal(_fingerprint(int8), int8_print)),
                   lora_tensors=len(state.trainable),
                   lora_tensors_moved=sum(int(not torch.equal(p.cpu(), lora_before[n]))
                                          for n, p in state.trainable.items()))
        fc = pipeline.flux_config
        shape = dict(step=_expected_launches(pipeline), blocks=fc.num_layers + fc.num_single_layers,
                     linears=sum(int(isinstance(m, LoraDense) and m.kernel_scale is not None)
                                 for m in pipeline.model.modules()))
        del pipeline, state, int8
        _free()
        return out, shape

    trainer.init_train_state = init_and_keep
    flux.FluxPipeline.get_call_text_encoder_fns = (
        lambda self: flux.seeded_text_encoder_fns(512, 4096, 768))
    try:
        t0 = time.perf_counter()
        check(train.main(argv + ["--cache_only"]) == 0, "--cache_only failed")
        cache_s = time.perf_counter() - t0
        _free()
        # the LoRA factors as initialised: init_train_state's, from the seed
        init = {}

        def init_and_copy(pipeline, *a, **kw):
            state = init_and_keep(pipeline, *a, **kw)
            init.update({n: p.detach().cpu().clone() for n, p in state.trainable.items()})
            return state

        trainer.init_train_state = init_and_copy
        first, shape = run(["--max_steps", str(DRIVER_STEPS)], DRIVER_STEPS, init)
        trainer.init_train_state = init_and_keep
        run_dir = next((root / "out").iterdir())
        at_first = torch.load(run_dir / f"global_step{DRIVER_STEPS}" / "state.pt",
                              map_location="cpu", weights_only=True)["trainable"]
        second, _ = run(["--resume_from_checkpoint", "--max_steps", str(DRIVER_RESUMED_STEPS),
                         "--test_sample", SAMPLE_PROMPT],
                        DRIVER_RESUMED_STEPS - DRIVER_STEPS, at_first)
        del init, at_first
        extras = _driver_extras(train, argv, root, root / "out", 512)
    finally:
        trainer.init_train_state = real_init
        flux.FluxPipeline.get_call_text_encoder_fns = real_te
    calls = [first, second]

    # each call: H1 once a frozen block weight when init_train_state
    # pre-quantizes it, then a training step's launches a step; the first
    # call also an eval forward's (no backward, no recompute) for each of
    # the 9 quantiles x the eval batches before step 1
    eval_forwards = 9 * -(-DRIVER_EVAL_IMAGES // 2)
    per_forward = {"flash_fwd": shape["blocks"], "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                   "sr_add": 0, "quant_rows": shape["linears"], "rescale_i32": shape["linears"]}
    init = {k: shape["linears"] if k == "quant_rows" else 0 for k in per_forward}
    # the second call also samples (--test_sample): a forward a step
    expected = [{k: init[k] + v * first["steps"] + per_forward[k] * eval_forwards
                 for k, v in shape["step"].items()},
                {k: init[k] + v * second["steps"] + per_forward[k] * DRIVER_SAMPLE_STEPS
                 for k, v in shape["step"].items()}]

    recs = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    losses = {r["step"]: r["train/loss"] for r in recs if "train/loss" in r}
    evals = [r for r in recs if any(k.startswith("eval/") for k in r)]
    quantiles = sorted(k for r in evals for k in r if "loss_quantile_" in k)
    final = run_dir / f"global_step{DRIVER_RESUMED_STEPS}"
    meta = json.loads((final / "client_state.json").read_text())
    saved_step = torch.load(final / "state.pt", map_location="cpu", weights_only=True)["step"]
    adapter = safetensors_io.load_file(run_dir / "epoch1" / "adapter_model.safetensors")
    uninterrupted, loader_cost = _uninterrupted_loader_state(root, DRIVER_RESUMED_STEPS)
    step_times = _driver_step_times(run_dir / "metrics.jsonl")
    step_s = sum(step_times) / len(step_times)
    emit(phase="driver", cell="flux-dev-lora-512-fp8-int8", cache_only_s=cache_s,
         calls=calls, expected_launches=expected, losses=losses, eval=evals,
         step_s=step_s, step_times_s=step_times, samples_per_s=2 / step_s,
         slice_fp8_int8_step_s=fp8_step_s, host_cost_s=step_s - fp8_step_s,
         final_step=saved_step, loader_state=meta.get("custom_loader"),
         uninterrupted_loader_state=uninterrupted, loader_cost=loader_cost,
         adapter_keys=len(adapter), **extras)
    check(all(math.isfinite(v) for v in losses.values()), f"non-finite loss: {losses}")
    check(sorted(losses) == list(range(1, DRIVER_RESUMED_STEPS + 1)), f"train/loss steps {losses}")
    check(len(quantiles) == 9, f"eval quantiles {quantiles}")
    check(saved_step == DRIVER_RESUMED_STEPS and meta["step"] == DRIVER_RESUMED_STEPS,
          f"step counter {saved_step}")
    check(meta.get("custom_loader") == uninterrupted,
          f"loader {meta.get('custom_loader')} against an uninterrupted run's {uninterrupted}")
    check(all(c["int8_unchanged"] and c["int8_weights"] == 494 for c in calls),
          "int8 weights changed")
    check(all(c["lora_tensors_moved"] == c["lora_tensors"] == 988 for c in calls),
          "LoRA factors did not all move")
    check(len(adapter) == 2 * 494, f"adapter keys {len(adapter)}, expected 988")
    for c, want in zip(calls, expected):
        check(c["launches"] == want, f"driver launches {c['launches']}, expected {want}")
    total = {k: sum(c["launches"][k] for c in calls) for k in first["launches"]}
    check(all(total[k] > 0 for k in FLASH + INT8), f"a kernel of the driver's path idle: {total}")
    return total


def _uninterrupted_loader_state(root, steps, config=None, batch_size=2, gas=1):
    """The loader position after `steps` pulls of a fresh loader over the
    cached dataset (no training): an uninterrupted run's. Also the host
    time of a pull (cache reads and collation) and of the batch's copy to
    the card, over the pulls after the first, and which cache reader
    served them ("native": native/cache_reader.cpp, else "python").
    config: the driver's config (default the Flux driver's)."""
    from diffusion_pipe_tpu_torch.config import load_toml, normalize_batch_size_map
    from diffusion_pipe_tpu_torch.data.dataset import Dataset
    from diffusion_pipe_tpu_torch.data.loader import DatasetManager, PipelineDataLoader
    from diffusion_pipe_tpu_torch.models import get_model_class

    config = config or _driver_config(SMOKE_DIR / "vae")
    pipeline = get_model_class(config["model"]["type"])(config, device="cuda")
    ds = Dataset(load_toml(root / "dataset.toml"), pipeline,
                 support_video=pipeline.framerate is not None)
    manager = DatasetManager(pipeline)
    manager.register(ds)
    manager.cache()  # complete: reads the metadata and cache indexes only
    ds.post_init(0, 1, normalize_batch_size_map(batch_size), gas, full_global=True)
    loader = PipelineDataLoader(ds, gas)
    pull_s, copy_s = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        _, batch = next(loader)
        t1 = time.perf_counter()
        on_card = {k: v.to("cuda") for k, v in batch.items() if torch.is_tensor(v)}
        torch.cuda.synchronize()
        if i:
            pull_s.append(t1 - t0)
            copy_s.append(time.perf_counter() - t1)
    readers = sorted({b.latent_cache.last_reader for b in ds.all_size_bucket_datasets()})
    return loader.state_dict(), {
        "pull_ms": 1e3 * sum(pull_s) / len(pull_s), "copy_to_card_ms": 1e3 * sum(copy_s) / len(copy_s),
        "batch_bytes": sum(v.numel() * v.element_size() for v in on_card.values()),
        "cache_readers": readers}


# --- phase 5 ------------------------------------------------------------------


def _small_wan_run(model, x, t, ctx, target):
    out = model(x, t, ctx)
    loss = torch.mean((out.float() - target) ** 2)
    loss.backward()
    grads = {n: p.grad.float().cpu() for n, p in model.named_parameters()}
    return out.float().cpu(), loss.item(), grads


def phase_reference_wan(device="cuda"):
    from diffusion_pipe_tpu_torch.models.layers import init_module_weights
    from diffusion_pipe_tpu_torch.models.wan_model import WanConfig, WanTransformer

    def build(dtype, device):
        cfg = WanConfig(dim=256, ffn_dim=512, num_heads=2, num_layers=2, text_dim=64,
                        text_len=40, dtype=dtype, param_dtype=dtype, remat="full")
        with torch.device(device):
            return WanTransformer(cfg)

    cpu = build(torch.float32, "cpu")
    gen = torch.Generator().manual_seed(SEED)
    init_module_weights(cpu, gen)
    gpu = build(torch.bfloat16, device)
    gpu.load_state_dict(cpu.state_dict())

    # 3x10x10 latents -> a 3x5x5 grid of 75 tokens (a ragged tile), 40 text tokens
    x = torch.randn((1, 16, 3, 10, 10), generator=gen)
    ctx = torch.randn((1, 40, 64), generator=gen)
    t = torch.tensor([400.0])
    target = torch.randn(x.shape, generator=gen)
    ref_out, ref_loss, ref_grads = _small_wan_run(cpu, x, t, ctx, target)

    reset_launch_counts()
    out, loss, grads = _small_wan_run(gpu, x.to(device, torch.bfloat16), t.to(device),
                                      ctx.to(device), target.to(device))
    counts = {k: launch_counts()[k] for k in FLASH}

    out_err = _rel(out, ref_out)
    grad_err, worst_grad_err = _compare_grads(grads, ref_grads)
    loss_err = abs(loss - ref_loss) / abs(ref_loss)
    emit(phase="reference-wan", out_rel_l2=out_err, loss_rel=loss_err, grads_rel_l2=grad_err,
         worst_tensor_rel_l2=worst_grad_err, tensors=len(grads), launches=counts)
    check(torch.device(device).type != "cuda" or all(c > 0 for c in counts.values()),
          f"reference-wan skipped a kernel: {counts}")
    # bf16 against f32 through two blocks, every parameter trained: about 1%
    # expected on the output, the loss and all gradients taken together
    check(out_err < 3e-2 and loss_err < 3e-2 and grad_err < 5e-2,
          f"reference-wan mismatch: out {out_err}, loss {loss_err}, grads {grad_err}")


# --- phase 6 ------------------------------------------------------------------

WAN_SLICE_CONFIG = {  # wan-1.3b-t2v-fullft-sr
    "save_every_n_epochs": 1,
    "model": {"type": "wan", "variant": "t2v-1.3b", "dtype": "bfloat16"},
    "optimizer": {"type": "adamw", "lr": 2e-5, "weight_decay": 0.01,
                  "stochastic_rounding": True},
    "gradient_clipping": 1.0,
    "activation_checkpointing": True,
}
WAN_LORA_CONFIG = {  # wan-1.3b-t2v-lora-attn: bench.py's Wan row (bench.py:52-72)
    "save_every_n_epochs": 1,
    "model": {"type": "wan", "dtype": "bfloat16", "variant": "t2v-1.3b"},
    "adapter": {"type": "lora", "rank": 32, "alpha": 32, "dropout": 0.0},
    "optimizer": {"type": "adamw8bit", "lr": 1e-4},
    "gradient_clipping": 1.0,
    "activation_checkpointing": "attn",
}
VARIANT_DEPTH = 4  # blocks of the full-width i2v-14B and ti2v-5B cells


def _variant_config(variant):
    return {**WAN_LORA_CONFIG, "model": {**WAN_LORA_CONFIG["model"], "variant": variant,
                                         "num_layers": VARIANT_DEPTH}}


def build_wan_slice(cfg=WAN_SLICE_CONFIG, device="cuda", latent_fhw=(21, 64, 64),
                    txt_len=512, batch_size=1):
    """The Wan path's trainer, its state, step and batch, through the
    entry points a user calls: get_model_class("wan") -> init_train_state
    with the pipeline's trainable_predicate (full fine-tuning without
    [adapter], else LoRA) -> make_train_step with the optimizer's stochastic_rounding. The
    batch: latents of the variant's channels, UMT5-shaped text; i2v also y
    and, with the CLIP branch, a [257, 1280] clip_context."""
    from diffusion_pipe_tpu_torch.models import get_model_class
    from diffusion_pipe_tpu_torch.training.optimizers import get_optimizer
    from diffusion_pipe_tpu_torch.training.trainer import init_train_state, make_train_step

    pipeline = get_model_class("wan")(cfg, device=device)
    wc = pipeline.wan_config
    gen = torch.Generator(device=device).manual_seed(SEED)
    state = init_train_state(pipeline, get_optimizer(cfg), gen, pipeline.trainable_predicate())
    step = make_train_step(
        pipeline, gradient_clipping=cfg["gradient_clipping"],
        stochastic_rounding=bool(cfg["optimizer"].get("stochastic_rounding", False)))
    channels = wc.out_dim
    batch = {
        "latents": torch.randn((batch_size, channels, *latent_fhw), generator=gen,
                               device=device),
        "text_embeddings": torch.randn((batch_size, txt_len, wc.text_dim), generator=gen,
                                       device=device).to(wc.dtype),
        "seq_lens": torch.full((batch_size,), txt_len, dtype=torch.int32, device=device),
    }
    if pipeline.is_i2v:
        batch["y"] = torch.randn((batch_size, 16, *latent_fhw), generator=gen, device=device)
    if pipeline.uses_clip:
        batch["clip_context"] = torch.randn((batch_size, wc.clip_tokens, 1280), generator=gen,
                                            device=device).to(wc.dtype)
    return pipeline, state, step, batch, gen


def _expected_wan_launches(pipeline, n_bf16_sr):
    """Launches a Wan step: two attentions a block (three with the CLIP
    branch), each K1 once under "attn" and twice under "full" (the
    recompute), K2 and K3 once; K4 once a bf16 trainable tensor under
    stochastic rounding."""
    wc = pipeline.wan_config
    n_attn = (3 if wc.uses_clip else 2) * wc.num_layers
    return {"flash_fwd": n_attn * (2 if wc.remat == "full" else 1), "flash_bwd_dq": n_attn,
            "flash_bwd_dkv": n_attn, "sr_add": n_bf16_sr, **NO_INT8}


def phase_slice_wan(phase="slice-wan", cell="wan-1.3b-t2v-fullft-sr", timed_steps=WAN_TIMED_STEPS,
                    **slice_kw):
    """A Wan cell: one warm-up step, then `timed_steps` timed with the
    counters set to 0 just before: finite losses, every trainable tensor
    changed, frozen weights (LoRA) unchanged, the launches a step. Returns
    (launches, samples/s, tokens/s, peak)."""
    device = slice_kw.get("device", "cuda")
    on_cuda = torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    pipeline, state, step, batch, gen = build_wan_slice(**slice_kw)
    _sync(device)
    init_s = time.perf_counter() - t0

    wc = pipeline.wan_config
    trainable = list(state.trainable.values())
    frozen = [p for p in pipeline.model.parameters() if not p.requires_grad]
    n_params = sum(p.numel() for p in pipeline.model.parameters())
    n_trainable = sum(p.numel() for p in trainable)
    sr = bool(slice_kw.get("cfg", WAN_SLICE_CONFIG)["optimizer"].get("stochastic_rounding"))
    n_bf16 = sum(int(p.dtype == torch.bfloat16) for p in trainable) if sr else 0
    start = [p.detach().clone() for p in trainable]
    frozen0 = _fingerprint(frozen) if frozen else None
    b, _, f, h, w = batch["latents"].shape
    tokens = b * (f // wc.patch_size[0]) * (h // wc.patch_size[1]) * (w // wc.patch_size[2])

    if on_cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    warm = step(state, batch, gen)
    warm_loss = warm["loss"].item()
    warm_s = time.perf_counter() - t0

    reset_launch_counts()
    t0 = time.perf_counter()
    metrics = [step(state, batch, gen) for _ in range(timed_steps)]
    _sync(device)
    step_s = (time.perf_counter() - t0) / timed_steps
    counts = launch_counts()
    losses = [m["loss"].item() for m in metrics]
    norms = [m["grad_norm"].item() for m in metrics]
    peak = torch.cuda.max_memory_allocated() if on_cuda else None

    per_step = {k: v / timed_steps for k, v in counts.items()}
    expected = _expected_wan_launches(pipeline, n_bf16)
    changed = [int(not torch.equal(p, p0)) for p, p0 in zip(trainable, start)]
    moved_elements = sum(int((p != p0).sum()) for p, p0 in zip(trainable, start))
    del start
    frozen_same = frozen0 is None or torch.equal(_fingerprint(frozen), frozen0)
    emit(phase=phase, cell=cell, model_type=wc.model_type, blocks=wc.num_layers, dim=wc.dim,
         heads=wc.num_heads, params=n_params, trainable_params=n_trainable,
         trainable_tensors=len(trainable), bf16_sr_tensors=n_bf16,
         latent_shape=list(batch["latents"].shape), tokens_per_sample=tokens // b,
         init_s=init_s, warmup_s=warm_s, warmup_loss=warm_loss, step_s=step_s,
         samples_per_s=b / step_s, tokens_per_s=tokens / step_s, losses=losses,
         grad_norms=norms, peak_memory_bytes=peak, launches=counts,
         launches_per_step=per_step, tensors_changed=sum(changed),
         moved_element_share=moved_elements / n_trainable, frozen_unchanged=frozen_same)
    check(all(math.isfinite(x) for x in [warm_loss, *losses]), f"non-finite loss: {losses}")
    check(all(changed), f"{len(changed) - sum(changed)} trainable tensors did not change")
    check(frozen_same, "frozen weights changed")
    check(not on_cuda or per_step == expected,
          f"launches per step {per_step}, expected {expected}")
    return counts, b / step_s, tokens / step_s, peak


# --- phase 7: the i2v image cross-attention shapes -----------------------------

# Wan2.1-14B i2v at 480 x 832, 81 frames: 21 x 30 x 52 latent tokens, 40 heads,
# against the 257 CLIP tokens (flf2v: 514) -- a ragged last key tile
I2V_CROSS = dict(sq=21 * 30 * 52, h=40)
I2V_CASES = (("wan_i2v_cross", 257), ("wan_flf2v_cross", 514))


def phase_kernels_i2v():
    """K1-K3 against their plain versions at the i2v / flf2v image
    cross-attention shapes, K2 and K3 deterministic there, and each timed
    beside its bound, its plain version and SDPA. Returns {shape: timing}."""
    from diffusion_pipe_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    d, sq, h = 128, I2V_CROSS["sq"], I2V_CROSS["h"]
    timings = {}
    for case, skv in I2V_CASES:
        errors = _check_attention(fa, case, 1, sq, skv, h, d, False, gen)
        _check_bwd_deterministic(fa, case, 1, sq, skv, h, d, gen)
        _free()
        timing, sdpa_bwd_ms = _time_attention(fa, 1, sq, skv, h, d, gen, True)
        for name, tm in timing.items():
            tm["max_abs_err"] = max(errors[k]["err"] for k in ERR_KEYS[name])
        emit(phase="kernels", case=f"timing_{case}", q_shape=[1, sq, h, d], kv_len=skv,
             timing=timing, sdpa_bwd_ms=sdpa_bwd_ms)
        timings[case] = timing
        _free()
    return timings


# --- phase 8: UMT5-XXL ------------------------------------------------------------

UMT5_BATCH, UMT5_LEN, UMT5_VALID = 2, 512, (512, 300)
UMT5_REL_L2 = 3e-2  # bf16 on the card against f32 on the CPU, relative L2


def _rel_l2(a, b):
    a, b = a.float().cpu(), b.float().cpu()
    return (torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)).item()


def phase_umt5():
    """UMT5-XXL at full width and depth (24 layers, dim 4096, 64 heads, FFN
    10240, vocabulary 256,384), seeded weights in bf16 on the card: the
    encode of 2 x 512 seeded ids (the second padded after 300) and its
    device time; then the first two layers at full width (with the
    embedding and the final norm) on the card against the same weights in
    f32 on the CPU, relative L2 within UMT5_REL_L2."""
    from diffusion_pipe_tpu_torch.models.umt5 import UMT5Config, UMT5Encoder

    cfg = UMT5Config.xxl()
    with torch.device("meta"):
        enc = UMT5Encoder(cfg)
    enc = enc.to_empty(device="cuda")
    t0 = time.perf_counter()
    enc.init_weights(torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    enc.eval().requires_grad_(False)
    gen = torch.Generator().manual_seed(SEED)
    ids = torch.randint(0, cfg.vocab, (UMT5_BATCH, UMT5_LEN), generator=gen)
    mask = torch.zeros((UMT5_BATCH, UMT5_LEN), dtype=torch.int32)
    for i, n in enumerate(UMT5_VALID):
        mask[i, :n] = 1
    ids = ids * mask
    ids_c, mask_c = ids.cuda(), mask.cuda()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        out = enc(ids_c, mask_c)
        ms = cuda_ms(lambda: enc(ids_c, mask_c), iters=5)
    peak = torch.cuda.max_memory_allocated()
    finite = bool(torch.isfinite(out).all())
    n_params = sum(p.numel() for p in enc.parameters())

    small_cfg = UMT5Config.xxl(num_layers=2)
    keep = {k: v for k, v in enc.state_dict().items()
            if not k.startswith("blocks.") or int(k.split(".")[1]) < 2}
    del enc, out
    _free()
    # built on the meta device: every weight is loaded (an initialisation
    # of the 1.05 B-entry embedding on the CPU took most of the phase)
    with torch.device("meta"):
        small = UMT5Encoder(small_cfg)
        ref = UMT5Encoder(UMT5Config.xxl(num_layers=2, dtype=torch.float32,
                                         param_dtype=torch.float32))
    small = small.to_empty(device="cuda")
    small.load_state_dict(keep)
    ref = ref.to_empty(device="cpu")
    ref.load_state_dict({k: v.float().cpu() for k, v in keep.items()})
    del keep
    with torch.no_grad():
        got = small(ids_c, mask_c)
        t0 = time.perf_counter()
        want = ref(ids, mask)
        cpu_s = time.perf_counter() - t0
    rel = _rel_l2(got, want)
    emit(phase="umt5", config="UMT5Config.xxl", params=n_params, init_s=init_s,
         batch=[UMT5_BATCH, UMT5_LEN], valid_tokens=list(UMT5_VALID), encode_ms=ms,
         peak_memory_bytes=peak, finite=finite, two_layer_rel_l2=rel, tolerance=UMT5_REL_L2,
         cpu_f32_two_layer_s=cpu_s)
    del small, ref, got, want
    _free()
    check(finite, "UMT5-XXL gave non-finite hidden states")
    check(rel <= UMT5_REL_L2, f"UMT5 two layers off the f32 CPU result: rel L2 {rel}")
    return ms


# --- phase 9: the Wan 2.1 and 2.2 VAEs ----------------------------------------------

WAN_VAE_CLIP = (1, 3, 81, 512, 512)        # -> 1 x 16 x 21 x 64 x 64
WAN22_VAE_CLIP = (1, 3, 121, 704, 1280)    # ti2v's clip -> 1 x 48 x 31 x 44 x 80
WAN_VAE_SMALL = {"wan21": (1, 3, 9, 128, 128), "wan22": (1, 3, 9, 64, 64)}
WAN_VAE_REL_L2 = 5e-2  # bf16 on the card against f32 on the CPU, relative L2


def _seeded_vae(cls, cfg, device):
    with torch.device("meta"):
        vae = cls(cfg)
    vae = vae.to_empty(device=device)
    vae.init_weights(torch.Generator(device=device).manual_seed(SEED))
    return vae.eval().requires_grad_(False)


def _vae_case(name, cls, cfg, clip_shape, latent_shape):
    """One VAE: the full clip's encode on the card (time, peak), then the
    small clip's encode and decode on the card against f32 on the CPU.
    Returns the card model (bf16) and its record."""
    import dataclasses

    vae = _seeded_vae(cls, dataclasses.replace(cfg, dtype=torch.bfloat16), "cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    clip = torch.rand(clip_shape, generator=gen, device="cuda").mul_(2).sub_(1)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        t0 = time.perf_counter()
        z = vae.encode(clip)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        ms = cuda_ms(lambda: vae.encode(clip), iters=1)
    peak = torch.cuda.max_memory_allocated()
    finite = bool(torch.isfinite(z).all())
    got_shape = list(z.shape)
    del clip, z
    _free()

    with torch.device("meta"):
        ref = cls(cfg)
    ref = ref.to_empty(device="cpu")
    ref.load_state_dict({k: v.float().cpu() for k, v in vae.state_dict().items()})
    small = torch.rand(WAN_VAE_SMALL[name], generator=torch.Generator().manual_seed(SEED)) * 2 - 1
    with torch.no_grad():
        z = vae.encode(small.cuda())
        x = vae.decode(z)
        t0 = time.perf_counter()
        z_ref = ref.encode(small)
        x_ref = ref.decode(z_ref)
        cpu_s = time.perf_counter() - t0
    rec = dict(params=sum(p.numel() for p in vae.parameters()), clip_shape=list(clip_shape),
               latent_shape=got_shape, encode_ms=ms, first_encode_s=first_s,
               peak_memory_bytes=peak, finite=finite, small_clip=list(small.shape),
               small_latent_shape=list(z.shape), encode_rel_l2=_rel_l2(z, z_ref),
               decode_rel_l2=_rel_l2(x, x_ref), cpu_f32_small_s=cpu_s)
    check(got_shape == list(latent_shape), f"{name}: latents {got_shape}, expected {latent_shape}")
    check(finite, f"{name}: non-finite latents")
    check(rec["encode_rel_l2"] <= WAN_VAE_REL_L2 and rec["decode_rel_l2"] <= WAN_VAE_REL_L2,
          f"{name}: off the f32 CPU result: {rec['encode_rel_l2']}, {rec['decode_rel_l2']}")
    return vae, rec


def phase_wan_vae():
    """The Wan 2.1 VAE at its published widths (dim 96, mults 1/2/4/4, z
    16) and the Wan 2.2 VAE (dim 160, decoder 256, z 48), seeded, bf16 on
    the card: the encode of an 81-frame 512 px clip (2.1) and of ti2v's
    121-frame 1280 x 704 clip (2.2), each timed with its peak; the 2.1 VAE
    on a 9-frame 128 px clip and the 2.2 VAE on a 9-frame 64 px clip,
    encode and decode, against f32 on the CPU. The 2.1 weights are written
    in the reference layout for the driver-wan phase. Returns their path."""
    from diffusion_pipe_tpu_torch import safetensors_io
    from diffusion_pipe_tpu_torch.models.wan_vae import WanVAEConfig, WanVideoVAE
    from diffusion_pipe_tpu_torch.models.wan_vae22 import Wan22VAEConfig, WanVideoVAE22
    from diffusion_pipe_tpu_torch.models.wan_vae_convert import wan_vae_state_dict

    records = {}
    vae, records["wan21"] = _vae_case("wan21", WanVideoVAE, WanVAEConfig.wan21(), WAN_VAE_CLIP,
                                      (1, 16, 21, 64, 64))
    path = _fresh_dir(SMOKE_DIR / "wan_vae") / "wan2.1_vae.safetensors"
    safetensors_io.save_file({k: v.cpu() for k, v in wan_vae_state_dict(vae).items()}, path)
    del vae
    _free()
    vae22, records["wan22"] = _vae_case("wan22", WanVideoVAE22, Wan22VAEConfig.ti2v_5b(),
                                        WAN22_VAE_CLIP, (1, 48, 31, 44, 80))
    del vae22
    _free()
    emit(phase="wan-vae", dtype="bfloat16", tolerance=WAN_VAE_REL_L2, **records)
    return path


# --- phase 10: the CLIP vision tower ------------------------------------------------

CLIP_FRAME = (1, 3, 480, 832)
CLIP_REL_L2 = 3e-2


def phase_clip_vision():
    """The ViT-H/14 tower at full width (31 of 32 blocks, dim 1280), seeded
    weights in bf16 on the card, on a 480 x 832 first frame: 257 x 1280
    tokens and their device time; a copy of its first two blocks on the
    card against f32 on the CPU, relative L2 within CLIP_REL_L2."""
    from diffusion_pipe_tpu_torch.models.wan_clip import WanClipVision, WanClipVisionConfig

    with torch.device("meta"):
        clip = WanClipVision(WanClipVisionConfig(dtype=torch.bfloat16))
    clip = clip.to_empty(device="cuda")
    clip.init_weights(torch.Generator(device="cuda").manual_seed(SEED))
    clip.eval().requires_grad_(False)
    frame = torch.rand(CLIP_FRAME, generator=torch.Generator().manual_seed(SEED)) * 2 - 1
    with torch.no_grad():
        tokens = clip(frame.cuda())
        ms = cuda_ms(lambda: clip(frame.cuda()), iters=5)
    keep = {k: v for k, v in clip.state_dict().items()
            if not k.startswith("blocks.") or int(k.split(".")[1]) < 2}
    small = WanClipVision(WanClipVisionConfig(num_layers=3, dtype=torch.bfloat16)).cuda()
    small.load_state_dict(keep)
    ref = WanClipVision(WanClipVisionConfig(num_layers=3))
    ref.load_state_dict({k: v.float().cpu() for k, v in keep.items()})
    with torch.no_grad():
        rel = _rel_l2(small(frame.cuda()), ref(frame))
    emit(phase="clip-vision", params=sum(p.numel() for p in clip.parameters()),
         frame=list(CLIP_FRAME), tokens_shape=list(tokens.shape), encode_ms=ms,
         two_block_rel_l2=rel, tolerance=CLIP_REL_L2)
    check(list(tokens.shape) == [1, 257, 1280], f"CLIP tokens {list(tokens.shape)}")
    check(bool(torch.isfinite(tokens).all()), "non-finite CLIP tokens")
    check(rel <= CLIP_REL_L2, f"CLIP two blocks off the f32 CPU result: rel L2 {rel}")
    del clip, small, ref, tokens
    _free()


# --- phase 11: bench.py's Wan row through the driver --------------------------------

WAN_DRIVER_TOML = """# wan-1.3b-t2v-lora-attn (bench.py's Wan row) through the driver
output_dir = "{root}/out"
dataset = "{root}/dataset.toml"
eval_datasets = ["{root}/eval.toml"]
epochs = 100
micro_batch_size_per_gpu = 1
gradient_accumulation_steps = 1
gradient_clipping = 1.0
save_every_n_epochs = 1
save_every_n_steps = 4
eval_before_first_step = true
activation_checkpointing = "attn"
sample_steps = {sample_steps}

[model]
type = "wan"
variant = "t2v-1.3b"
dtype = "bfloat16"
vae_path = "{vae}"

[adapter]
type = "lora"
rank = 32

[optimizer]
type = "adamw8bit"
lr = 1e-4
"""


def phase_driver_wan(vae_path, extras=True):
    """bench.py's Wan row (wan-1.3b-t2v-lora-attn) through the driver,
    train.main: 8 seeded 512 px PNGs with captions and 2 for eval (one-frame
    videos), --cache_only with the wan-vae phase's weights loaded from the
    reference layout by load_wan_vae and seeded UMT5-shaped text stand-ins
    ([512, 4096] with seq_lens; no UMT5 weights or tokenizer here), then 3
    steps with the 9-quantile eval before the first, then a resume to step
    5 (the adapter exported at step 4). The transformer starts from random
    init. Checks: finite losses, the
    step counter, the loader position of an uninterrupted run, the nine
    eval quantiles, every LoRA factor moved in each call and the base
    weights unchanged, the ComfyUI adapter's key count against
    export_wan_lora_comfyui for the same config, and the launches (60 / 60
    / 60 a step, 60 K1 an eval forward). extras: the resumed call also
    samples (--test_sample, before it trains) and a --dump_dataset call
    follows; tools/compare_smoke_phases.py turns them off to time the same
    calls as an older tree's phase. Also reports the objects the garbage
    collector tracks at the start and its pauses in the first call, by
    generation. Returns the driver's launches."""
    import tomllib

    from diffusion_pipe_tpu_torch import safetensors_io, train
    from diffusion_pipe_tpu_torch.config import set_config_defaults
    from diffusion_pipe_tpu_torch.models import wan
    from diffusion_pipe_tpu_torch.training import trainer

    root = _fresh_dir(SMOKE_DIR / "driver_wan")
    _write_images(root / "train", DRIVER_IMAGES, SEED)
    _write_images(root / "eval", DRIVER_EVAL_IMAGES, SEED + 1)
    (root / "dataset.toml").write_text(f'resolutions = [512]\n[[directory]]\npath = "{root}/train"\n')
    (root / "eval.toml").write_text(f'resolutions = [512]\n[[directory]]\npath = "{root}/eval"\n')
    text = WAN_DRIVER_TOML.format(root=root, vae=vae_path, sample_steps=DRIVER_SAMPLE_STEPS)
    cfg_path = root / "wan_lora.toml"
    cfg_path.write_text(text)
    argv = ["--config", str(cfg_path)]

    captured = []
    real_init = trainer.init_train_state
    real_te = wan.WanPipeline.get_call_text_encoder_fns

    def init_and_keep(pipeline, *a, **kw):
        state = real_init(pipeline, *a, **kw)
        frozen = [p for p in pipeline.model.parameters() if not p.requires_grad]
        captured.append((pipeline, state, _fingerprint(frozen),
                         {n: p.detach().cpu().clone() for n, p in state.trainable.items()}))
        return state

    def run(extra, steps, lora_before=None):
        """One train.main call: its launches and peak, and what its state
        shows after it (lora_before: {name: tensor}, default the init)."""
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        check(train.main(argv + extra) == 0, f"train.main {extra} failed")
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = launch_counts()
        pipeline, state, frozen_print, lora0 = captured.pop()
        lora0 = lora_before or lora0
        frozen = [p for p in pipeline.model.parameters() if not p.requires_grad]
        adapter_keys = len(wan.export_wan_lora_comfyui(state.trainable, pipeline.wan_config))
        out = dict(steps=steps, wall_s=wall_s, launches=counts,
                   peak_memory_bytes=torch.cuda.max_memory_allocated(),
                   frozen_unchanged=bool(torch.equal(_fingerprint(frozen), frozen_print)),
                   lora_tensors=len(state.trainable),
                   lora_tensors_moved=sum(int(not torch.equal(p.cpu(), lora0[n]))
                                          for n, p in state.trainable.items()),
                   expected_adapter_keys=adapter_keys)
        shape = dict(step=_expected_wan_launches(pipeline, 0),
                     attn=2 * pipeline.wan_config.num_layers)
        del pipeline, state, frozen
        _free()
        return out, shape

    trainer.init_train_state = init_and_keep
    wan.WanPipeline.get_call_text_encoder_fns = lambda self: [wan.seeded_umt5_fn(512, 4096)]
    gc_objects = len(gc.get_objects())
    try:
        t0 = time.perf_counter()
        check(train.main(argv + ["--cache_only"]) == 0, "--cache_only failed")
        cache_s = time.perf_counter() - t0
        _free()
        with _GcPauses() as gc_first:
            first, shape = run(["--max_steps", str(DRIVER_STEPS)], DRIVER_STEPS)
        run_dir = next((root / "out").iterdir())
        at_first = torch.load(run_dir / f"global_step{DRIVER_STEPS}" / "state.pt",
                              map_location="cpu", weights_only=True)["trainable"]
        sample = ["--test_sample", SAMPLE_PROMPT] if extras else []
        second, _ = run(["--resume_from_checkpoint", "--max_steps", str(DRIVER_RESUMED_STEPS),
                         *sample], DRIVER_RESUMED_STEPS - DRIVER_STEPS, at_first)
        del at_first
        extra_out = _driver_extras(train, argv, root, root / "out", 512) if extras else {}
    finally:
        trainer.init_train_state = real_init
        wan.WanPipeline.get_call_text_encoder_fns = real_te
    calls = [first, second]

    eval_forwards = 9 * DRIVER_EVAL_IMAGES  # 9 quantiles x the eval batches of 1
    per_forward = {k: (shape["attn"] if k == "flash_fwd" else 0) for k in shape["step"]}
    # the second call also samples (--test_sample): a forward a step
    sample_forwards = DRIVER_SAMPLE_STEPS if extras else 0
    expected = [{k: v * first["steps"] + per_forward[k] * eval_forwards
                 for k, v in shape["step"].items()},
                {k: v * second["steps"] + per_forward[k] * sample_forwards
                 for k, v in shape["step"].items()}]
    recs = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    losses = {r["step"]: r["train/loss"] for r in recs if "train/loss" in r}
    evals = [r for r in recs if any(k.startswith("eval/") for k in r)]
    quantiles = sorted(k for r in evals for k in r if "loss_quantile_" in k)
    final = run_dir / f"global_step{DRIVER_RESUMED_STEPS}"
    meta = json.loads((final / "client_state.json").read_text())
    saved_step = torch.load(final / "state.pt", map_location="cpu", weights_only=True)["step"]
    # batch 1 over 8 images: an epoch is 8 steps, so the export is step 4's
    adapter = safetensors_io.load_file(run_dir / "step4" / "adapter_model.safetensors")
    config = set_config_defaults(tomllib.loads(text))
    uninterrupted, loader_cost = _uninterrupted_loader_state(root, DRIVER_RESUMED_STEPS, config,
                                                             batch_size=1)
    step_times = _driver_step_times(run_dir / "metrics.jsonl")
    step_s = sum(step_times) / len(step_times)
    cache = sorted(p.name for p in (root / "train" / "cache" / "wan").iterdir())
    emit(phase="driver-wan", cell="wan-1.3b-t2v-lora-attn", cache_only_s=cache_s, calls=calls,
         expected_launches=expected, losses=losses, eval=evals, step_s=step_s,
         step_times_s=step_times, samples_per_s=1 / step_s, final_step=saved_step,
         loader_state=meta.get("custom_loader"), uninterrupted_loader_state=uninterrupted,
         loader_cost=loader_cost, adapter_keys=len(adapter), cache_dirs=cache,
         gc_objects_at_start=gc_objects, gc_pause_s_first_call=gc_first.seconds, **extra_out)
    check(all(math.isfinite(v) for v in losses.values()), f"non-finite loss: {losses}")
    check(sorted(losses) == list(range(1, DRIVER_RESUMED_STEPS + 1)), f"train/loss steps {losses}")
    check(len(quantiles) == 9, f"eval quantiles {quantiles}")
    check(saved_step == DRIVER_RESUMED_STEPS and meta["step"] == DRIVER_RESUMED_STEPS,
          f"step counter {saved_step}")
    check(meta.get("custom_loader") == uninterrupted,
          f"loader {meta.get('custom_loader')} against an uninterrupted run's {uninterrupted}")
    check(all(c["frozen_unchanged"] for c in calls), "base weights changed")
    check(all(c["lora_tensors_moved"] == c["lora_tensors"] == 600 for c in calls),
          "LoRA factors did not all move")
    check(len(adapter) == first["expected_adapter_keys"] == 600,
          f"adapter keys {len(adapter)}, export_wan_lora_comfyui gives "
          f"{first['expected_adapter_keys']}")
    for c, want in zip(calls, expected):
        check(c["launches"] == want, f"driver-wan launches {c['launches']}, expected {want}")
    return {k: sum(c["launches"][k] for c in calls) for k in first["launches"]}


# --- slice 8: LoKr, the checkpointing policies, the optimizers, the sampler ------

LOKR_CONFIG = {  # flux-dev-lokr-512-fp8-int8: bench.py's Flux row with a LoKr adapter
    **FP8_INT8_CONFIG,
    "adapter": {"type": "lokr", "rank": 16, "alpha": 16, "decompose_factor": -1,
                "rank_dropout": 0.1},
}
# bench.py's Wan row with LoRA dropout 0.1, at 10 of its 30 blocks (the
# smoke's time: each policy's bits against true's hold block by block)
POLICY_DEPTH = 10
WAN_POLICY_CONFIG = {
    **WAN_LORA_CONFIG, "model": {**WAN_LORA_CONFIG["model"], "num_layers": POLICY_DEPTH},
    "adapter": {**WAN_LORA_CONFIG["adapter"], "dropout": 0.1}}
POLICIES = ("full", "attn", "dots", "offload_attn", "unsloth")
POLICY_TIMED_STEPS = 2


def _meminfo_bytes(key):
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith(key + ":"):
            return int(line.split()[1]) * 1024
    return None


def phase_slice_wan_policies(cfg=WAN_POLICY_CONFIG, device="cuda", **slice_kw):
    """bench.py's Wan row (Wan2.1-1.3B t2v at POLICY_DEPTH blocks, 21,504
    tokens, LoRA r32, adamw8bit) with LoRA dropout 0.1, on one model under
    each checkpointing policy in turn (the spec is read at each forward).
    Per policy, on the same batch, noise, t and dropout masks (KeepMasks of
    one seed): the loss and the LoRA gradients (20 a block) of one forward
    and backward against
    true's (bit equality reported, relative L2 within 1e-3 required), then
    POLICY_TIMED_STEPS timed steps: step time, peak device memory, the
    most bytes held in pinned host memory at once (and, for the phase, the
    pinned slabs' bytes), K1 launches a step
    (4 a block under true, "dots" and "unsloth"; 2 under "attn" and
    "offload_attn") and the products run a step: under "dots" and
    "unsloth" those of the forward alone (no GEMM again in the recompute),
    counted against a forward without gradients."""
    import dataclasses

    from diffusion_pipe_tpu_torch.models import layers
    from diffusion_pipe_tpu_torch.ops import offload
    from diffusion_pipe_tpu_torch.training.trainer import make_loss_fn

    on_cuda = torch.device(device).type == "cuda"
    pipeline, state, step, batch, gen = build_wan_slice(cfg=cfg, device=device, **slice_kw)
    model = pipeline.model
    base = model.cfg
    lora = state.trainable
    with torch.no_grad():  # B away from 0, so the A factors get gradients too
        for n, p in lora.items():
            if n.endswith("lora_b"):
                p.copy_(torch.randn(p.shape, generator=gen, device=device) * 0.01)
    b = batch["latents"].shape[0]
    noise = torch.randn(batch["latents"].shape, generator=gen, device=device)
    t = torch.rand((b,), generator=gen, device=device)
    peak = torch.cuda.max_memory_allocated if on_cuda else (lambda: None)
    reset_peak = torch.cuda.reset_peak_memory_stats if on_cuda else (lambda: None)
    loss_fn = make_loss_fn(pipeline)

    inputs, _, _ = pipeline.prepare_inputs(batch, noise=noise, t=t)
    layers.reset_product_count()
    with torch.no_grad():
        pipeline.forward(inputs)
    forward_products = layers.product_count
    del inputs

    def rel(a, b):
        d, n = (a.float() - b.float()).norm().item(), b.float().norm().item()
        return d / n if n > 0 else d

    n_attn = 2 * base.num_layers
    expected_k1 = {"full": 2 * n_attn, "attn": n_attn, "dots": 2 * n_attn,
                   "offload_attn": n_attn, "unsloth": 2 * n_attn}
    ref_grads, rows = None, {}
    try:
        # the gradients first, on the same weights for every policy
        for spec in POLICIES:
            model.cfg = dataclasses.replace(base, remat=spec)
            _free(device)
            reset_peak()
            for p in lora.values():
                p.grad = None
            with layers.adapter_dropout(layers.KeepMasks(SEED)):
                loss = loss_fn(batch, noise=noise, t=t)
            loss.backward()
            grads = {n: p.grad.detach().clone() for n, p in lora.items()}
            for p in lora.values():
                p.grad = None
            loss = loss.item()
            if ref_grads is None:
                ref_grads, ref_loss = grads, loss
            errs = {n: rel(g, ref_grads[n]) for n, g in grads.items()}
            worst = max(errs, key=errs.get)
            rows[spec] = dict(loss=loss, loss_true=ref_loss, grads_rel_l2_worst=errs[worst],
                              worst_tensor=worst,
                              bit_equal_to_true=loss == ref_loss and all(
                                  torch.equal(g, ref_grads[n]) for n, g in grads.items()),
                              grad_peak_memory_bytes=peak())
            del grads
            check(math.isfinite(loss) and errs[worst] < 1e-3
                  and abs(loss - ref_loss) <= 1e-3 * abs(ref_loss),
                  f"{spec}: loss {loss} against true's {ref_loss}, {worst} off by "
                  f"{errs[worst]}")
        del ref_grads
        # then the timed steps, each policy on the model the last one left
        for spec in POLICIES:
            model.cfg = dataclasses.replace(base, remat=spec)
            _free(device)
            reset_peak()
            offload.reset_stats()
            reset_launch_counts()
            layers.reset_product_count()
            _sync(device)
            t0 = time.perf_counter()
            losses = [step(state, batch, gen)["loss"].item() for _ in range(POLICY_TIMED_STEPS)]
            _sync(device)
            step_s = (time.perf_counter() - t0) / POLICY_TIMED_STEPS
            k1 = launch_counts()["flash_fwd"] / POLICY_TIMED_STEPS
            products = layers.product_count / POLICY_TIMED_STEPS
            rows[spec].update(step_s=step_s, losses=losses,
                              peak_memory_bytes=peak(),
                              pinned_held_peak_bytes=offload.stats["peak"],
                              k1_per_step=k1, products_per_step=products)
            check(all(math.isfinite(x) for x in losses), f"{spec}: non-finite loss {losses}")
            check(not on_cuda or k1 == expected_k1[spec], f"{spec}: {k1} K1 launches a step")
            if spec in ("dots", "unsloth"):
                check(products == forward_products,
                      f"{spec}: {products} products a step, the forward has {forward_products}")
            else:
                check(products > forward_products, f"{spec}: {products} products a step")
            check((offload.stats["peak"] > 0) == (spec in ("offload_attn", "unsloth")),
                  f"{spec}: {offload.stats['peak']} bytes held on the host")
    finally:
        model.cfg = base
    f, h, w = batch["latents"].shape[2:]
    emit(phase="slice-wan-policies", cell="wan-1.3b-t2v-lora-dropout", blocks=base.num_layers,
         tokens_per_sample=f * h * w // 4, timed_steps=POLICY_TIMED_STEPS,
         forward_products=forward_products, mem_total_bytes=_meminfo_bytes("MemTotal"),
         mem_available_bytes=_meminfo_bytes("MemAvailable"),
         pinned_slab_bytes=offload.stats["pinned"], policies=rows)
    del pipeline, state, step, batch
    _free(device)


OPT_DEPTH = 4     # blocks of the full-width Wan2.1-1.3B optimizer cell
OPT_STEPS = 3
OPTIMIZER_CASES = (
    ("stableadamw", {"lr": 1e-4}),
    ("sgd", {"lr": 1e-1, "momentum": 0.9}),
    ("automagic", {"lr": 1e-4}),
    ("muon", {"lr": 1e-3}),
    ("adafactor", {"lr": 1e-4}),
    ("genericoptim", {"lr": 1e-4, "second_moment_type": "sn", "rank": 128,
                      "proj_type": "svd", "update_proj_gap": 2}),
)


def _timed_optimizer(state, device="cuda"):
    """Wraps state.optimizer.step so each call's device time (synchronized
    on both sides) is appended to the returned list."""
    times = []
    inner = state.optimizer.step

    def step(*a, **kw):
        _sync(device)
        t0 = time.perf_counter()
        out = inner(*a, **kw)
        _sync(device)
        times.append(time.perf_counter() - t0)
        return out

    state.optimizer.step = step
    return times


def _optimizer_case(name, cfg, gas=1, gradient_release=False, batch_size=1, device="cuda",
                    **slice_kw):
    from diffusion_pipe_tpu_torch.training.trainer import make_train_step

    pipeline, state, _, batch, gen = build_wan_slice(cfg=cfg, batch_size=batch_size,
                                                     device=device, **slice_kw)
    step = make_train_step(pipeline, gradient_clipping=cfg["gradient_clipping"],
                           gradient_accumulation_steps=gas, gradient_release=gradient_release,
                           stochastic_rounding=True)
    trainable = list(state.trainable.values())
    start = [p.detach().clone() for p in trainable]
    n_bf16 = sum(int(p.dtype == torch.bfloat16) for p in trainable)
    opt_times = _timed_optimizer(state, device)
    reset_launch_counts()
    step_times, losses = [], []
    for _ in range(OPT_STEPS):
        _sync(device)
        t0 = time.perf_counter()
        losses.append(step(state, batch, gen)["loss"].item())
        _sync(device)
        step_times.append(time.perf_counter() - t0)
    counts = launch_counts()
    changed = [not torch.equal(p, p0) for p, p0 in zip(trainable, start)]
    matrices = [c for c, p in zip(changed, trainable) if p.dim() >= 2]
    k4 = counts["sr_add"] / OPT_STEPS
    row = dict(optimizer=name, lr=cfg["optimizer"]["lr"], losses=losses, step_s=step_times,
               optimizer_s=opt_times, tensors=len(trainable), tensors_moved=sum(changed),
               matrices=len(matrices), matrices_moved=sum(matrices), k4_per_step=k4,
               bf16_tensors=n_bf16)
    check(all(math.isfinite(x) for x in losses), f"{name}: non-finite loss {losses}")
    # every matrix; a vector may not (adafactor and genericoptim's factored
    # or subset-norm moments step a vector by lr * g, as the JAX package)
    check(all(matrices), f"{name}: {len(matrices) - sum(matrices)} matrices did not move")
    on_cuda = torch.device(device).type == "cuda"
    check(not on_cuda or k4 == n_bf16 * (gas if gradient_release else 1),
          f"{name}: {k4} K4 launches a step")
    del pipeline, state, step, batch, start
    _free(device)
    return row, counts


def phase_optimizers(model=None, lora_model=None, **slice_kw):
    """Wan2.1-1.3B t2v at full width, cut to OPT_DEPTH of its 30 blocks,
    full fine-tuning in bf16 with stochastic rounding (clip 1.0, "full"
    checkpointing, 21,504 tokens): OPT_STEPS steps of each optimizer in
    OPTIMIZER_CASES (genericoptim: subset-norm, rank 128, SVD projector
    refreshed at steps 1 and 2, inside the timed steps), then adamw8bit
    LoRA r32 with gradient_release at GAS 2 (bf16 factors, stochastic
    rounding: K4 once a factor a micro-batch). Each: finite losses, every
    matrix moved (and the count of all tensors that did), step and
    optimizer times, K4 launches a step."""
    rows, total = [], {}
    model = model or {**WAN_SLICE_CONFIG["model"], "num_layers": OPT_DEPTH}
    lora_model = lora_model or {**WAN_LORA_CONFIG["model"], "num_layers": OPT_DEPTH}
    for name, extra in OPTIMIZER_CASES:
        cfg = {**WAN_SLICE_CONFIG, "model": model,
               "optimizer": {"type": name, "weight_decay": 0.01, "stochastic_rounding": True,
                             **extra}}
        row, counts = _optimizer_case(name, cfg, **slice_kw)
        rows.append(row)
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
    cfg = {**WAN_LORA_CONFIG, "model": lora_model, "gradient_accumulation_steps": 2,
           "optimizer": {"type": "adamw8bit", "lr": 1e-4, "gradient_release": True,
                         "stochastic_rounding": True}}
    row, counts = _optimizer_case("adamw8bit-gradient-release", cfg, gas=2,
                                  gradient_release=True, batch_size=2, **slice_kw)
    rows.append(row)
    total = {k: total.get(k, 0) + v for k, v in counts.items()}
    emit(phase="optimizers", cell="wan-1.3b-t2v-fullft-sr-4-blocks", blocks=OPT_DEPTH,
         cut="4 of 30 blocks, to keep the smoke's time", tokens_per_sample=21504, rows=rows)
    return total


SAMPLE_STEPS = 20


def _two_block_flux_pipeline(dtype, device, txt_len=64):
    """The Flux pipeline with a full-width FluxTransformer of one double and
    one single block in `dtype` on `device` (random weights: load them)."""
    import dataclasses

    from diffusion_pipe_tpu_torch.models import get_model_class
    from diffusion_pipe_tpu_torch.models.flux_model import FluxTransformer

    name = "float32" if dtype == torch.float32 else "bfloat16"
    cfg = {**SLICE_CONFIG, "model": {**SLICE_CONFIG["model"], "dtype": name},
           "activation_checkpointing": False}
    pipeline = get_model_class("flux")(cfg, device=device)
    pipeline.flux_config = dataclasses.replace(pipeline.flux_config, num_layers=1,
                                               num_single_layers=1)
    with torch.device(device):
        pipeline.model = FluxTransformer(pipeline.flux_config)
    return pipeline


def phase_sample():
    """The Euler flow sampler through the training forward (no graph, no
    checkpoint): Flux-dev LoRA at full width and depth, bf16, 512 px, 20
    steps, batch 1 (seconds; 20 x 57 K1 launches, no K2 or K3); a
    full-width two-block Flux, 128 px, 4 steps, on the card in bf16
    against the same weights and noise in f32 on the CPU (relative L2
    within 3e-2, as the reference phase holds a forward); Wan2.1-1.3B at
    81 frames and 512 px (21 x 64 x 64 latents), 4 steps (seconds, 4 x 60
    K1)."""
    from diffusion_pipe_tpu_torch.models import get_model_class
    from diffusion_pipe_tpu_torch.models.layers import init_module_weights

    out = {}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    pipe = get_model_class("flux")(SLICE_CONFIG, device="cuda")
    pipe.init_params(gen)
    fc = pipe.flux_config
    t5 = torch.randn((1, 512, fc.joint_attention_dim), generator=gen, device="cuda").to(fc.dtype)
    clip = torch.randn((1, fc.pooled_projection_dim), generator=gen, device="cuda").to(fc.dtype)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lat = pipe.sample(t5, clip, 512, 512, generator=gen, num_steps=SAMPLE_STEPS)
    torch.cuda.synchronize()
    out["flux_512_s"] = time.perf_counter() - t0
    flux_counts = launch_counts()
    out["flux_launches"] = flux_counts
    blocks = fc.num_layers + fc.num_single_layers
    check(tuple(lat.shape) == (1, 16, 64, 64) and bool(torch.isfinite(lat).all()),
          f"Flux sample {tuple(lat.shape)}, finite {bool(torch.isfinite(lat).all())}")
    check(flux_counts["flash_fwd"] == SAMPLE_STEPS * blocks and flux_counts["flash_bwd_dq"] == 0
          and flux_counts["flash_bwd_dkv"] == 0, f"Flux sample launches {flux_counts}")
    del pipe, t5, clip, lat
    _free()

    # the weights drawn on the card (a CPU draw of 550M takes 40 s), in f32
    f32 = _two_block_flux_pipeline(torch.float32, "cuda")
    init_module_weights(f32.model, torch.Generator(device="cuda").manual_seed(SEED))
    cpu = _two_block_flux_pipeline(torch.float32, "cpu")
    cpu.model.load_state_dict(f32.model.state_dict())
    card = _two_block_flux_pipeline(torch.bfloat16, "cuda")
    card.model.load_state_dict(f32.model.state_dict())
    del f32
    g = torch.Generator().manual_seed(SEED + 1)
    t5 = torch.randn((1, 64, 4096), generator=g)
    clip = torch.randn((1, 768), generator=g)
    noise = torch.randn((1, 16, 16, 16), generator=g)
    ref = cpu.sample(t5, clip, 128, 128, num_steps=4, noise=noise)
    got = card.sample(t5.cuda(), clip.cuda(), 128, 128, num_steps=4, noise=noise.cuda())
    out["two_block_rel_l2"] = _rel(got.float().cpu(), ref)
    check(out["two_block_rel_l2"] < 3e-2, f"two-block sample rel L2 {out['two_block_rel_l2']}")
    del cpu, card
    _free()

    pipe = get_model_class("wan")(WAN_LORA_CONFIG, device="cuda")
    pipe.init_params(gen)
    wc = pipe.wan_config
    text = torch.randn((1, 512, wc.text_dim), generator=gen, device="cuda")
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lat = pipe.sample(width=512, height=512, generator=gen, num_steps=4, num_frames=81,
                      text_embeddings=text)
    torch.cuda.synchronize()
    out["wan_81x512_4_steps_s"] = time.perf_counter() - t0
    wan_counts = launch_counts()
    out["wan_launches"] = wan_counts
    check(tuple(lat.shape) == (1, 16, 21, 64, 64) and bool(torch.isfinite(lat).all()),
          f"Wan sample {tuple(lat.shape)}")
    check(wan_counts["flash_fwd"] == 4 * 2 * wc.num_layers and wan_counts["flash_bwd_dq"] == 0,
          f"Wan sample launches {wan_counts}")
    del pipe, text, lat
    _free()
    emit(phase="sample", flux_steps=SAMPLE_STEPS, **out)
    return {k: flux_counts[k] + wan_counts[k] for k in flux_counts}


# --- slice 9: SDXL ------------------------------------------------------------

# K1-K3 at SDXL's attention shapes (head dim 64, batch 4): 512 px has
# self-attention over 1,024 tokens (H 10, 10 blocks) and 256 (H 20, 60
# blocks), and 77-token cross-attention in every block; 1024 px four times
# the tokens. (case, (B, Sq, Skv, H))
SDXL_KERNEL_CASES = (
    ("sdxl512_self_1024", (4, 1024, 1024, 10)),
    ("sdxl512_self_256", (4, 256, 256, 20)),
    ("sdxl512_cross_256", (4, 256, 77, 20)),
    ("sdxl512_cross_1024", (4, 1024, 77, 10)),
    ("sdxl1024_self_4096", (4, 4096, 4096, 10)),
    ("sdxl1024_self_1024", (4, 1024, 1024, 20)),
)
SDXL_HEAD_DIM = 64
SDXL_BLOCKS = 70  # transformer blocks of the SDXL UNet (2 x 2 + 2 x 10 + 10 + 3 x 2 + 3 x 10)


def phase_kernels_sdxl():
    """K1-K3 at SDXL's shapes (bf16, D 64) against their plain versions,
    the cross shape also with a padded batch element (40 of 77 keys valid)
    and with every key of an element masked, K2 / K3 deterministic there;
    each timed beside its bound, its plain version and SDPA's forward and
    backward. Returns {case: timing}."""
    from diffusion_pipe_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    d = SDXL_HEAD_DIM
    errors = {}
    for case, (b, sq, skv, h) in SDXL_KERNEL_CASES:
        errors[case] = _check_attention(fa, case, b, sq, skv, h, d, False, gen)
        _free()
    errors["sdxl512_cross_256_masked"] = _check_attention(
        fa, "sdxl512_cross_256_masked", 4, 256, 77, 20, d, slice(40, 77), gen)
    splits = _check_bwd_deterministic(fa, "sdxl512_cross_256", 4, 256, 77, 20, d, gen)
    _check_all_masked(fa, "sdxl512_cross_256", 4, 256, 77, 20, d, gen)
    _free()
    timings = {}
    for case, (b, sq, skv, h) in SDXL_KERNEL_CASES:
        timing, sdpa_bwd_ms = _time_attention(fa, b, sq, skv, h, d, gen)
        for name, tm in timing.items():
            tm["max_abs_err"] = max(errors[case][k]["err"] for k in ERR_KEYS[name])
            tm["sdpa_bwd_ms"] = sdpa_bwd_ms
        emit(phase="kernels-sdxl", case=f"timing_{case}", q_shape=[b, sq, h, d], kv_len=skv,
             timing=timing, sdpa_bwd_ms=sdpa_bwd_ms)
        timings[case] = timing
        _free()
    emit(phase="kernels-sdxl", k3_query_splits_cross_256=splits)
    return timings


SDXL_LORA_CONFIG = {  # sdxl-lora-512: tools/bench_sdxl.py's configuration
    "save_every_n_epochs": 1,
    "model": {"type": "sdxl", "dtype": "bfloat16", "_random_te": True},
    "adapter": {"type": "lora", "rank": 16, "alpha": 16, "dropout": 0.0},
    "optimizer": {"type": "adamw8bit", "lr": 1e-4},
    "gradient_clipping": 1.0,
}
SDXL_FULLFT_LRS = {"unet.": 4e-5, "text_encoder.": 2e-5, "text_encoder_2.": 1e-5}
SDXL_FULLFT_CONFIG = {  # sdxl-fullft: examples/sdxl.toml's adamw, every weight trained
    "save_every_n_epochs": 1,
    "model": {"type": "sdxl", "dtype": "bfloat16", "_random_te": True,
              "unet_lr": SDXL_FULLFT_LRS["unet."],
              "text_encoder_1_lr": SDXL_FULLFT_LRS["text_encoder."],
              "text_encoder_2_lr": SDXL_FULLFT_LRS["text_encoder_2."]},
    "optimizer": {"type": "adamw", "lr": 1e-4},
    "gradient_clipping": 1.0,
}
SDXL_FULLFT_STEPS = 2


def _sdxl_ids(b, gen, device):
    """[B, 1, 77] token ids laid out as the tokenizer's chunks: BOS, a
    caption of 8-60 tokens, EOS, EOS padding."""
    ids = torch.full((b, 1, 77), 49407, dtype=torch.int32)
    g = torch.Generator().manual_seed(int(torch.randint(0, 2**31, (), generator=gen,
                                                        device=gen.device)))
    for i in range(b):
        n = int(torch.randint(8, 61, (), generator=g))
        ids[i, 0, 0] = 49406
        ids[i, 0, 1:1 + n] = torch.randint(0, 49406, (n,), generator=g, dtype=torch.int32)
    return ids.to(device)


def build_sdxl_slice(cfg=SDXL_LORA_CONFIG, device="cuda", latent_hw=64, batch_size=4):
    """The SDXL trainer through the entry points a user calls:
    get_model_class("sdxl") -> init_train_state (trainable_predicate,
    the optimizer with lr_scale_map's groups) -> make_train_step; a batch
    of latents and token ids."""
    from diffusion_pipe_tpu_torch.models import get_model_class
    from diffusion_pipe_tpu_torch.training.optimizers import get_optimizer
    from diffusion_pipe_tpu_torch.training.trainer import init_train_state, make_train_step

    pipeline = get_model_class("sdxl")(cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    scales = pipeline.lr_scale_map(float(cfg["optimizer"]["lr"]))
    state = init_train_state(pipeline, get_optimizer(cfg, lr_scales=scales), gen,
                             pipeline.trainable_predicate())
    step = make_train_step(pipeline, gradient_clipping=cfg["gradient_clipping"])
    ids = _sdxl_ids(batch_size, gen, device)
    batch = {"latents": torch.randn((batch_size, 4, latent_hw, latent_hw), generator=gen,
                                    device=device),
             "input_ids": ids, "input_ids_2": ids}
    return pipeline, state, step, batch, gen


def phase_slice_sdxl(phase="slice-sdxl-lora", cell="sdxl-lora-512", cfg=SDXL_LORA_CONFIG,
                     timed_steps=TIMED_STEPS, batch_size=4, device="cuda", latent_hw=64):
    """An SDXL cell: one warm-up step, then `timed_steps` timed with the
    counters set to 0 just before. LoRA: finite losses, every LoRA tensor
    moved, the UNet's and towers' weights unchanged, 140 / 140 / 140 flash
    launches a step (two attentions in each of 70 blocks, no
    checkpointing). Full fine-tuning: every tensor of the UNet and both
    towers moved, each group's largest step near its LR. Returns (launches,
    samples/s, peak)."""
    on_cuda = torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    pipeline, state, step, batch, gen = build_sdxl_slice(cfg, device, latent_hw, batch_size)
    _sync(device)
    init_s = time.perf_counter() - t0
    trainable = dict(state.trainable)
    frozen = [p for p in pipeline.model.parameters() if not p.requires_grad]
    n_params = sum(p.numel() for p in pipeline.model.parameters())
    start = {n: p.detach().clone() for n, p in trainable.items()}
    frozen0 = _fingerprint(frozen) if frozen else None

    if on_cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    warm_loss = step(state, batch, gen)["loss"].item()
    warm_s = time.perf_counter() - t0
    reset_launch_counts()
    t0 = time.perf_counter()
    metrics = [step(state, batch, gen) for _ in range(timed_steps)]
    _sync(device)
    step_s = (time.perf_counter() - t0) / timed_steps
    counts = launch_counts()
    losses = [m["loss"].item() for m in metrics]
    peak = torch.cuda.max_memory_allocated() if on_cuda else None
    per_step = {k: v / timed_steps for k, v in counts.items()}
    moved = {n: (p.detach() - start[n]).abs().max().item() for n, p in trainable.items()}
    del start
    frozen_same = frozen0 is None or torch.equal(_fingerprint(frozen), frozen0)
    lora = "adapter" in cfg
    # CLIP-L's last layer and final norm feed only its pooled output, which
    # SDXL does not use: they get no gradient and stay where they are
    te1_last = (f"text_encoder.text_model.encoder.layers."
                f"{pipeline.model.text_encoder.config.num_hidden_layers - 1}.",
                "text_encoder.text_model.final_layer_norm.")
    groups = {}
    if not lora:  # each group's largest element step over its LR, median over tensors
        for prefix, lr in SDXL_FULLFT_LRS.items():
            ratios = sorted(v / lr for n, v in moved.items()
                            if n.startswith(prefix) and not n.startswith(te1_last))
            groups[prefix] = dict(tensors=len(ratios), lr=lr,
                                  median_step_over_lr=ratios[len(ratios) // 2],
                                  min_step_over_lr=ratios[0], max_step_over_lr=ratios[-1])
    expected = {"flash_fwd": 2 * SDXL_BLOCKS, "flash_bwd_dq": 2 * SDXL_BLOCKS,
                "flash_bwd_dkv": 2 * SDXL_BLOCKS, "sr_add": 0, **NO_INT8}
    emit(phase=phase, cell=cell, params=n_params, trainable_tensors=len(trainable),
         trainable_params=sum(p.numel() for p in trainable.values()),
         latent_shape=list(batch["latents"].shape), init_s=init_s, warmup_s=warm_s,
         warmup_loss=warm_loss, timed_steps=timed_steps, step_s=step_s,
         samples_per_s=batch_size / step_s, losses=losses, peak_memory_bytes=peak,
         launches=counts, launches_per_step=per_step,
         tensors_moved=sum(int(v > 0) for v in moved.values()), frozen_unchanged=frozen_same,
         lr_groups=groups)
    still = [n for n, v in moved.items() if v == 0]
    check(all(math.isfinite(x) for x in [warm_loss, *losses]), f"non-finite loss: {losses}")
    check(all(n.startswith(te1_last) for n in still),
          f"{len(still)} trainable tensors did not move: {still[:5]}")
    check(frozen_same, "frozen weights changed")
    if lora:
        check(len(trainable) == SDXL_BLOCKS * 10 * 2, f"{len(trainable)} LoRA tensors")
    else:
        check(len(trainable) == len(list(pipeline.model.parameters())), "not every weight trains")
        # two adamw steps on one batch move an element by about twice its
        # LR (bf16 UNet weights by whole ulps): each group's median largest
        # step within 0.5x-6x its LR, the groups within 3x of each other
        medians = [g["median_step_over_lr"] for g in groups.values()]
        check(all(0.5 <= m <= 6.0 for m in medians) and max(medians) <= 3 * min(medians),
              f"update scales do not follow the LR groups: {groups}")
    check(not on_cuda or per_step == expected, f"launches per step {per_step}, expected {expected}")
    return counts, batch_size / step_s, peak


def phase_reference_sdxl(device="cuda"):
    """A narrow SDXL UNet (widths 64 / 128 / 128, six transformer blocks at
    head dim 64, a 24 x 24 latent: 36-token attention at the deepest stage,
    77 context tokens) in bf16 on the card against the same weights in f32
    on the CPU: output, loss and LoRA gradients (LoRA B nonzero)."""
    from diffusion_pipe_tpu_torch.models.layers import init_module_weights
    from diffusion_pipe_tpu_torch.models.sdxl_unet import SDXLConfig, SDXLUNet

    def build(dtype, dev):
        cfg = SDXLConfig(block_out_channels=(64, 128, 128), transformer_layers=(0, 0, 1),
                         cross_attention_dim=256,
                         projection_class_embeddings_input_dim=64 + 6 * 256,
                         dtype=dtype, param_dtype=dtype, lora_rank=4, lora_alpha=4.0)
        with torch.device(dev):
            return SDXLUNet(cfg)

    cpu = build(torch.float32, "cpu")
    gen = torch.Generator().manual_seed(SEED)
    init_module_weights(cpu, gen)
    with torch.no_grad():
        for n, p in cpu.named_parameters():
            if n.endswith("lora_b"):
                p.normal_(0.0, 0.05, generator=gen)
    gpu = build(torch.bfloat16, device)
    gpu.load_state_dict(cpu.state_dict())
    x = torch.randn((2, 4, 24, 24), generator=gen)
    t = torch.tensor([100, 700], dtype=torch.int32)
    ctx = torch.randn((2, 77, 256), generator=gen)
    pooled = torch.randn((2, 64), generator=gen)
    ids = torch.tensor([[512.0, 512, 0, 0, 512, 512]] * 2)
    target = torch.randn(x.shape, generator=gen)

    def run(model, dev):
        for n, p in model.named_parameters():
            p.requires_grad_(n.endswith(("lora_a", "lora_b")))
        out = model(x.to(dev), t.to(dev), ctx.to(dev), pooled.to(dev), ids.to(dev))
        loss = torch.mean((out.float() - target.to(dev)) ** 2)
        loss.backward()
        return (out.float().cpu(), loss.item(),
                {n: p.grad.float().cpu() for n, p in model.named_parameters() if p.requires_grad})

    ref_out, ref_loss, ref_grads = run(cpu, "cpu")
    reset_launch_counts()
    out, loss, grads = run(gpu, device)
    counts = {k: launch_counts()[k] for k in FLASH}
    out_err = _rel(out, ref_out)
    grad_err, worst = _compare_grads(grads, ref_grads)
    loss_err = abs(loss - ref_loss) / abs(ref_loss)
    emit(phase="reference-sdxl", out_rel_l2=out_err, loss_rel=loss_err, grads_rel_l2=grad_err,
         worst_tensor_rel_l2=worst, tensors=len(grads), launches=counts)
    check(torch.device(device).type != "cuda" or all(c == 12 for c in counts.values()),
          f"reference-sdxl launches {counts}, expected 12 each (6 blocks x 2)")
    # bf16 against f32 through 17 resnets and 6 transformer blocks
    check(out_err < 3e-2 and loss_err < 3e-2 and grad_err < 5e-2,
          f"reference-sdxl mismatch: out {out_err}, loss {loss_err}, grads {grad_err}")


def _bytes_to_unicode():
    """GPT-2 / CLIP's byte -> printable character table."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) \
        + list(range(ord("®"), ord("ÿ") + 1))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _write_clip_tokenizer(folder):
    """A synthetic CLIP BPE tokenizer (no merges: a word is its characters)
    with CLIP's 49,408 ids, <|startoftext|> 49406 and <|endoftext|> 49407:
    vocab.json, merges.txt and tokenizer_config.json. No tokenizer files
    exist on the card's machine; this stands in for SDXL's."""
    folder.mkdir(parents=True, exist_ok=True)
    chars = list(_bytes_to_unicode().values())
    tokens = chars + [c + "</w>" for c in chars]
    tokens += [f"<|unused{i}|>" for i in range(49406 - len(tokens))]
    tokens += ["<|startoftext|>", "<|endoftext|>"]
    (folder / "vocab.json").write_text(json.dumps({t: i for i, t in enumerate(tokens)}))
    (folder / "merges.txt").write_text("#version: 0.2\n")
    (folder / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "CLIPTokenizer", "bos_token": "<|startoftext|>",
        "eos_token": "<|endoftext|>", "pad_token": "<|endoftext|>",
        "unk_token": "<|endoftext|>", "model_max_length": 77}))


SDXL_DRIVER_TOML = """# examples/sdxl.toml's settings through the driver (driver-sdxl)
output_dir = "{root}/out"
dataset = "{root}/dataset.toml"
eval_datasets = ["{root}/eval.toml"]
epochs = 100
micro_batch_size_per_gpu = 4
gradient_accumulation_steps = 1
gradient_clipping = 1.0
save_every_n_epochs = 5
save_every_n_steps = 4
eval_before_first_step = true
sample_steps = {sample_steps}

[model]
type = "sdxl"
diffusers_path = "{model}"
dtype = "bfloat16"
_random_te = true
_random_init = true

[adapter]
type = "lora"
rank = 16
dtype = "bfloat16"

[optimizer]
type = "adamw"
lr = 1e-4
"""
SDXL_DRIVER_IMAGES, SDXL_DRIVER_EVAL_IMAGES = 8, 4  # the eval: one batch of 4


def phase_driver_sdxl():
    """examples/sdxl.toml's settings (LoRA r16, adamw, micro batch 4)
    through train.main: 8 seeded 512 px PNGs with captions and 4 for eval,
    a model folder holding a seeded full-size SDXL VAE (diffusers layout)
    and a synthetic CLIP tokenizer; the UNet and towers from random init.
    --cache_only, 3 steps with the eval, a resume to 5 with --test_sample
    (DDIM, decoded by the SDXL VAE). Checks: finite losses, the step
    counter, the loader position of an uninterrupted run, LoRA moved and
    the rest unchanged, the kohya adapter's keys (the JAX export's count
    for this config, SDXL_KOHYA_KEYS), 140 K2 and K3 launches a step and
    140 K1 a forward (steps, eval and sample). Returns the launches."""
    import tomllib

    from diffusion_pipe_tpu_torch import safetensors_io, train
    from diffusion_pipe_tpu_torch.config import set_config_defaults
    from diffusion_pipe_tpu_torch.models.autoencoder_kl import (AutoencoderKL, VAEConfig,
                                                                diffusers_vae_state_dict)
    from diffusion_pipe_tpu_torch.training import trainer
    from PIL import Image

    root = _fresh_dir(SMOKE_DIR / "driver_sdxl")
    model_dir = root / "model"
    _write_clip_tokenizer(model_dir / "tokenizer")
    vae = AutoencoderKL(VAEConfig.sdxl())
    vae.init_weights(torch.Generator().manual_seed(SEED))
    (model_dir / "vae").mkdir()
    safetensors_io.save_file(diffusers_vae_state_dict(vae),
                             model_dir / "vae" / "diffusion_pytorch_model.safetensors")
    del vae
    _write_images(root / "train", SDXL_DRIVER_IMAGES, SEED)
    _write_images(root / "eval", SDXL_DRIVER_EVAL_IMAGES, SEED + 1)
    (root / "dataset.toml").write_text(f'resolutions = [512]\n[[directory]]\npath = "{root}/train"\n')
    (root / "eval.toml").write_text(f'resolutions = [512]\n[[directory]]\npath = "{root}/eval"\n')
    text = SDXL_DRIVER_TOML.format(root=root, model=model_dir, sample_steps=DRIVER_SAMPLE_STEPS)
    cfg_path = root / "sdxl_lora.toml"
    cfg_path.write_text(text)
    argv = ["--config", str(cfg_path)]

    captured = []
    real_init = trainer.init_train_state

    def init_and_keep(pipeline, *a, **kw):
        state = real_init(pipeline, *a, **kw)
        frozen = [p for p in pipeline.model.parameters() if not p.requires_grad]
        captured.append((pipeline, state, _fingerprint(frozen),
                         {n: p.detach().cpu().clone() for n, p in state.trainable.items()}))
        return state

    def run(extra, steps, lora_before=None):
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        check(train.main(argv + extra) == 0, f"train.main {extra} failed")
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = launch_counts()
        pipeline, state, frozen_print, lora0 = captured.pop()
        lora0 = lora_before or lora0
        frozen = [p for p in pipeline.model.parameters() if not p.requires_grad]
        out = dict(steps=steps, wall_s=wall_s, launches=counts,
                   peak_memory_bytes=torch.cuda.max_memory_allocated(),
                   frozen_unchanged=bool(torch.equal(_fingerprint(frozen), frozen_print)),
                   lora_tensors=len(state.trainable),
                   lora_tensors_moved=sum(int(not torch.equal(p.cpu(), lora0[n]))
                                          for n, p in state.trainable.items()))
        del pipeline, state, frozen
        _free()
        return out

    trainer.init_train_state = init_and_keep
    try:
        t0 = time.perf_counter()
        check(train.main(argv + ["--cache_only"]) == 0, "--cache_only failed")
        cache_s = time.perf_counter() - t0
        _free()
        first = run(["--max_steps", str(DRIVER_STEPS)], DRIVER_STEPS)
        run_dir = next((root / "out").iterdir())
        at_first = torch.load(run_dir / f"global_step{DRIVER_STEPS}" / "state.pt",
                              map_location="cpu", weights_only=True)["trainable"]
        second = run(["--resume_from_checkpoint", "--max_steps", str(DRIVER_RESUMED_STEPS),
                      "--test_sample", SAMPLE_PROMPT], DRIVER_RESUMED_STEPS - DRIVER_STEPS,
                     at_first)
        del at_first
    finally:
        trainer.init_train_state = real_init
    calls = [first, second]
    # a step: 140 K1 / K2 / K3; an eval or sample forward 140 K1
    per_step = 2 * SDXL_BLOCKS
    forwards = [(c["launches"]["flash_fwd"] - per_step * c["steps"]) / per_step for c in calls]
    recs = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    losses = {r["step"]: r["train/loss"] for r in recs if "train/loss" in r}
    evals = [r for r in recs if any(k.startswith("eval/") for k in r)]
    quantiles = sorted(k for r in evals for k in r if "loss_quantile_" in k)
    final = run_dir / f"global_step{DRIVER_RESUMED_STEPS}"
    meta = json.loads((final / "client_state.json").read_text())
    saved_step = torch.load(final / "state.pt", map_location="cpu", weights_only=True)["step"]
    adapter = safetensors_io.load_file(run_dir / "step4" / "adapter_model.safetensors")
    config = set_config_defaults(tomllib.loads(text))
    uninterrupted, loader_cost = _uninterrupted_loader_state(root, DRIVER_RESUMED_STEPS, config,
                                                             batch_size=4)
    step_times = _driver_step_times(run_dir / "metrics.jsonl")
    step_s = sum(step_times) / len(step_times)
    example = Image.open(Path(config["output_dir"]) / "example.png")
    cache = sorted(p.name for p in (root / "train" / "cache" / "sdxl").iterdir())
    emit(phase="driver-sdxl", cell="driver-sdxl", cache_only_s=cache_s, calls=calls,
         forwards_beside_steps=forwards, losses=losses, eval=evals, step_s=step_s,
         step_times_s=step_times, samples_per_s=4 / step_s, final_step=saved_step,
         loader_state=meta.get("custom_loader"), uninterrupted_loader_state=uninterrupted,
         loader_cost=loader_cost, adapter_keys=len(adapter), cache_dirs=cache,
         example_png=list(example.size))
    check(all(math.isfinite(v) for v in losses.values()), f"non-finite loss: {losses}")
    check(sorted(losses) == list(range(1, DRIVER_RESUMED_STEPS + 1)), f"train/loss steps {losses}")
    check(len(quantiles) == 9, f"eval quantiles {quantiles}")
    check(saved_step == DRIVER_RESUMED_STEPS and meta["step"] == DRIVER_RESUMED_STEPS,
          f"step counter {saved_step}")
    check(meta.get("custom_loader") == uninterrupted,
          f"loader {meta.get('custom_loader')} against an uninterrupted run's {uninterrupted}")
    check(all(c["frozen_unchanged"] for c in calls), "base weights changed")
    check(all(c["lora_tensors_moved"] == c["lora_tensors"] == SDXL_BLOCKS * 20 for c in calls),
          "LoRA factors did not all move")
    check(len(adapter) == SDXL_KOHYA_KEYS and all(k.startswith("lora_unet_") for k in adapter),
          f"adapter keys {len(adapter)}, the JAX export gives {SDXL_KOHYA_KEYS}")
    check(example.size == (512, 512), f"example.png is {example.size}")
    for c, f in zip(calls, forwards):
        check(c["launches"]["flash_bwd_dq"] == c["launches"]["flash_bwd_dkv"] == per_step * c["steps"]
              and f == int(f) and f > 0, f"driver-sdxl launches {c['launches']}")
    return {k: sum(c["launches"][k] for c in calls) for k in first["launches"]}


# the kohya adapter of SDXL's UNet at LoRA rank 16: 70 blocks x 10 linears x
# (lora_down, lora_up, alpha), the key count of the JAX
# export_sdxl_lora_kohya for that config (held on the CPU by
# tests/test_torch_sdxl.py::test_full_size_kohya_key_set_matches_jax)
SDXL_KOHYA_KEYS = 2100


# --- slice 10: SD3 and Chroma --------------------------------------------------

# K1-K3 at the joint-attention shapes of the two families (bf16, batch 2):
# SD3 at 1024 px, 77 CLIP + 256 T5 + 4,096 image tokens = 4,429 keys (34 x
# 128 + 77: a ragged last tile), head dim 64, at SD3-Medium's 24 heads and
# SD3.5-Large's 38; Chroma at 512 px, 512 T5 + 1,024 image tokens, head dim
# 128, with 77 and 300 of the T5 keys valid. (case, (B, S, H), D, masked
# keys of each batch element or False, checked heads)
SD3_CHROMA_KERNEL_CASES = (
    ("sd3_1024", (2, 4429, 24), 64, False, slice(0, 6)),
    ("sd35l_1024", (2, 4429, 38), 64, False, slice(32, 38)),
    ("chroma_512_masked", (2, 1536, 24), 128, (slice(77, 512), slice(300, 512)), None),
)


def phase_kernels_sd3_chroma():
    """K1-K3 at SD3's and Chroma's shapes against their plain versions (the
    SD3 shapes on six heads, strided views of the full inputs: about 2 GB of
    f32 logits each), K2 / K3 deterministic on the masked Chroma shape;
    each timed as in kernels beside its bound (the valid keys' work),
    its plain version and SDPA's forward and backward (given the same
    boolean key mask). Returns {case: timing}."""
    from diffusion_pipe_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    errors, timings = {}, {}
    for case, (b, s, h), d, masked, heads in SD3_CHROMA_KERNEL_CASES:
        errors[case] = _check_attention(fa, case, b, s, s, h, d, masked, gen, heads=heads)
        _free()
    case, (b, s, h), d, masked, _ = SD3_CHROMA_KERNEL_CASES[2]
    splits = _check_bwd_deterministic(fa, case, b, s, s, h, d, gen, masked=masked)
    _free()
    for case, (b, s, h), d, masked, _ in SD3_CHROMA_KERNEL_CASES:
        timing, sdpa_bwd_ms = _time_attention(fa, b, s, s, h, d, gen,
                                              with_plain=case != "sd35l_1024", masked=masked)
        for name, tm in timing.items():
            tm["max_abs_err"] = max(errors[case][k]["err"] for k in ERR_KEYS[name])
            tm["sdpa_bwd_ms"] = sdpa_bwd_ms
        emit(phase="kernels-sd3-chroma", case=f"timing_{case}", q_shape=[b, s, h, d], kv_len=s,
             masked=bool(masked), timing=timing, sdpa_bwd_ms=sdpa_bwd_ms)
        timings[case] = timing
        _free()
    emit(phase="kernels-sd3-chroma", k3_query_splits_chroma_masked=splits)
    return timings


def _small_run(model, inputs, target, dev):
    """Output, loss and LoRA gradients of one forward and backward."""
    for n, p in model.named_parameters():
        p.requires_grad_(n.endswith(("lora_a", "lora_b")))
    out = model(**{k: v.to(dev) if torch.is_tensor(v) else v for k, v in inputs.items()})
    loss = torch.mean((out.float() - target.to(dev)) ** 2)
    loss.backward()
    # (a factor whose output the loss does not read has no gradient: the
    # text tail of Qwen-Image's last block)
    return (out.float().cpu(), loss.item(),
            {n: p.grad.float().cpu() for n, p in model.named_parameters()
             if p.requires_grad and p.grad is not None})


def _reference_family(phase, build, inputs, target, device, blocks=None, expected=None):
    """A narrow model in bf16 on the card against the same weights in f32
    on the CPU (LoRA B nonzero): output, loss and LoRA gradients; K1-K3
    once a block (`blocks`, else SD3's and Chroma's count), or the
    `expected` launches."""
    from diffusion_pipe_tpu_torch.models.layers import init_module_weights

    cpu = build(torch.float32, "cpu")
    gen = torch.Generator().manual_seed(SEED)
    init_module_weights(cpu, gen)
    with torch.no_grad():
        for n, p in cpu.named_parameters():
            if n.endswith("lora_b"):
                p.normal_(0.0, 0.05, generator=gen)
    gpu = build(torch.bfloat16, device)
    gpu.load_state_dict(cpu.state_dict())
    ref_out, ref_loss, ref_grads = _small_run(cpu, inputs(torch.float32), target, "cpu")
    reset_launch_counts()
    out, loss, grads = _small_run(gpu, inputs(torch.bfloat16), target, device)
    counts = {k: launch_counts()[k] for k in FLASH}
    out_err = _rel(out, ref_out)
    grad_err, worst = _compare_grads(grads, ref_grads)
    loss_err = abs(loss - ref_loss) / abs(ref_loss)
    if blocks is None:
        blocks = len(gpu.blocks) + 1 if hasattr(gpu, "blocks") else (len(gpu.double_blocks)
                                                                     + len(gpu.single_blocks))
    emit(phase=phase, out_rel_l2=out_err, loss_rel=loss_err, lora_grads_rel_l2=grad_err,
         worst_lora_tensor_rel_l2=worst, tensors=len(grads), launches=counts)
    want = expected or {k: blocks for k in FLASH}
    check(torch.device(device).type != "cuda" or counts == want,
          f"{phase} launches {counts}, expected {want}")
    check(out_err < 3e-2 and loss_err < 3e-2 and grad_err < 5e-2,
          f"{phase} mismatch: out {out_err}, loss {loss_err}, grads {grad_err}")


def phase_reference_sd3(device="cuda"):
    """SD3 with 2 joint blocks (one scanned, the context_pre_only final) at
    head dim 64, qk_norm on, 2 heads: a 16 x 16 latent (64 image tokens) and
    40 text rows, 104 keys (a ragged tile)."""
    from diffusion_pipe_tpu_torch.models.sd3_model import SD3Config, SD3Transformer

    def build(dtype, dev):
        cfg = SD3Config(num_layers=2, num_attention_heads=2, joint_attention_dim=64,
                        pooled_projection_dim=32, pos_embed_max_size=32, sample_size=16,
                        qk_norm=True, dtype=dtype, param_dtype=dtype, lora_rank=4,
                        lora_alpha=4.0, lora_dtype=dtype)
        with torch.device(dev):
            return SD3Transformer(cfg)

    gen = torch.Generator().manual_seed(SEED + 1)
    x = torch.randn((1, 16, 16, 16), generator=gen)
    ctx = torch.randn((1, 40, 64), generator=gen)
    pooled = torch.randn((1, 32), generator=gen)
    target = torch.randn(x.shape, generator=gen)

    def inputs(dtype):
        return dict(hidden_states=x.to(dtype), timestep=torch.tensor([400.0]),
                    encoder_hidden_states=ctx.to(dtype), pooled_projections=pooled.to(dtype))

    _reference_family("reference-sd3", build, inputs, target, device)


def phase_reference_chroma(device="cuda"):
    """Chroma with one double and one single block at head dim 128, 2
    heads, an Approximator of 2 layers at width 64: 64 image tokens and 40
    T5 tokens of which 25 are valid (the key mask), 104 keys."""
    from diffusion_pipe_tpu_torch.models.chroma_model import ChromaConfig, ChromaTransformer
    from diffusion_pipe_tpu_torch.models.flux import latent_image_ids

    def build(dtype, dev):
        cfg = ChromaConfig(num_layers=1, num_single_layers=1, num_attention_heads=2,
                           joint_attention_dim=64, approximator_hidden=64, approximator_layers=2,
                           dtype=dtype, param_dtype=dtype, lora_rank=4, lora_alpha=4.0,
                           lora_dtype=dtype)
        with torch.device(dev):
            return ChromaTransformer(cfg)

    gen = torch.Generator().manual_seed(SEED + 2)
    x = torch.randn((1, 64, 64), generator=gen)
    t5 = torch.randn((1, 40, 64), generator=gen)
    mask = torch.zeros((1, 40), dtype=torch.int32)
    mask[:, :25] = 1
    target = torch.randn((1, 64, 64), generator=gen)

    def inputs(dtype):
        return dict(hidden_states=x.to(dtype), encoder_hidden_states=t5.to(dtype),
                    timestep=torch.tensor([0.4]), img_ids=latent_image_ids(8, 8),
                    txt_ids=torch.zeros((40, 3)), guidance=torch.zeros(1), txt_mask=mask)

    _reference_family("reference-chroma", build, inputs, target, device)


SD3_LORA_CONFIG = {  # sd3-medium-lora-1024
    "save_every_n_epochs": 1,
    "model": {"type": "sd3", "dtype": "bfloat16"},
    "adapter": {"type": "lora", "rank": 32, "alpha": 32, "dropout": 0.0},
    "optimizer": {"type": "adamw8bit", "lr": 1e-4},
    "gradient_clipping": 1.0,
    "activation_checkpointing": True,
}
CHROMA_LORA_CONFIG = {  # chroma-lora-512
    "save_every_n_epochs": 1,
    "model": {"type": "chroma", "dtype": "bfloat16"},
    "adapter": {"type": "lora", "rank": 32, "alpha": 32, "dropout": 0.0},
    "optimizer": {"type": "adamw8bit", "lr": 1e-4},
    "gradient_clipping": 1.0,
    "activation_checkpointing": "attn",
}
CHROMA_VALID_T5 = (60, 200)  # valid T5 tokens of each example's 512 in slice-chroma-lora


def _build_family_slice(family, cfg, device, make_batch):
    """A family's trainer through the entry points a user calls, as
    train.py builds it: get_model_class -> init_train_state (the
    pipeline's trainable_predicate, the optimizer with its lr_scale_map
    groups) -> make_train_step; make_batch(pipeline, gen) gives the batch."""
    from diffusion_pipe_tpu_torch.models import get_model_class
    from diffusion_pipe_tpu_torch.training.optimizers import get_optimizer
    from diffusion_pipe_tpu_torch.training.trainer import init_train_state, make_train_step

    pipeline = get_model_class(family)(cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    scales = pipeline.lr_scale_map(float(cfg["optimizer"]["lr"]))
    state = init_train_state(pipeline, get_optimizer(cfg, lr_scales=scales), gen,
                             pipeline.trainable_predicate())
    step = make_train_step(pipeline, gradient_clipping=cfg["gradient_clipping"])
    return pipeline, state, step, make_batch(pipeline, gen), gen


def build_sd3_slice(cfg=SD3_LORA_CONFIG, device="cuda", latent_hw=128, batch_size=2,
                    t5_len=256, clip_widths=(768, 1280)):
    """SD3 at the config's size; a batch of latents and the cached text:
    CLIP-L and CLIP-G rows [77, 768 / 1280] and their pooled vectors of the
    same widths, T5 rows [t5_len, 4096]."""
    def make_batch(pipeline, gen):
        dt = pipeline.sd3_config.dtype
        w1, w2 = clip_widths

        def r(*shape):
            return torch.randn((batch_size, *shape), generator=gen, device=device).to(dt)

        return {"latents": r(16, latent_hw, latent_hw).float(), "prompt_embed": r(77, w1),
                "prompt_2_embed": r(77, w2), "pooled_prompt_embed": r(w1),
                "pooled_prompt_2_embed": r(w2),
                "t5_prompt_embed": r(t5_len, pipeline.sd3_config.joint_attention_dim)}

    return _build_family_slice("sd3", cfg, device, make_batch)


def build_chroma_slice(cfg=CHROMA_LORA_CONFIG, device="cuda", latent_hw=64, t5_len=512,
                       valid=CHROMA_VALID_T5):
    """Chroma at the config's size; a batch of latents and T5 rows [t5_len,
    4096] with `valid` tokens of each example unmasked (zero rows after)."""
    def make_batch(pipeline, gen):
        cc = pipeline.chroma_config
        b = len(valid)
        mask = torch.zeros((b, t5_len), dtype=torch.int32, device=device)
        for i, n in enumerate(valid):
            mask[i, :n] = 1
        t5 = torch.randn((b, t5_len, cc.joint_attention_dim), generator=gen, device=device)
        return {"latents": torch.randn((b, 16, latent_hw, latent_hw), generator=gen,
                                       device=device),
                "t5_embed": (t5 * mask[..., None]).to(cc.dtype), "t5_mask": mask}

    return _build_family_slice("chroma", cfg, device, make_batch)


# SD3's final block is context_pre_only: its text-stream attention output
# is dropped, so its text queries get no gradient and their LoRA B stays at
# its zero init
NO_GRADIENT = ("final_block.attn_add_q.",)


def _flash_per_step(blocks, remat):
    """K1 once a block (twice under "full" checkpointing), K2 and K3 once."""
    return {"flash_fwd": blocks * (2 if remat == "full" else 1), "flash_bwd_dq": blocks,
            "flash_bwd_dkv": blocks, "sr_add": 0, **NO_INT8}


def _flash_step(pipeline):
    """K1-K3 launches of a training step: _flash_per_step over the model's
    attention blocks, but for the Lumina 2 families, whose refiners are not
    checkpointed (as the JAX module checkpoints its main stack only): their
    main blocks recompute K1 under "full", the 2 x num_refiner_layers
    refiner blocks do not."""
    blocks, mc = _model_blocks(pipeline)
    if hasattr(pipeline, "ltx2_config"):
        # LTX-2's connector trains nothing and takes no gradient: K1 alone
        step = _flash_per_step(blocks - mc.connector_blocks, mc.remat)
        step["flash_fwd"] += mc.connector_blocks
        return step
    if any(hasattr(pipeline, a) for a in ("hv_config", "hi_config", "hv15_config")):
        # the Hunyuan refiners train nothing and take no gradient: K1 alone
        step = _flash_per_step(blocks - mc.refiner_layers, mc.remat)
        step["flash_fwd"] += mc.refiner_layers
        return step
    if not hasattr(pipeline, "lumina_config"):
        return _flash_per_step(blocks, mc.remat)
    step = _flash_per_step(blocks, "")
    step["flash_fwd"] += mc.num_layers if mc.remat == "full" else 0
    return step


def _model_blocks(pipeline):
    """(attention blocks, model config) of an SD3, Chroma, Qwen-Image,
    FLUX.2, AuraFlow, Lumina 2 family, HiDream, Cosmos, Hunyuan or LTX
    pipeline (a MiniTrainDIT or LTX block attends twice: to itself and to
    the text; the Hunyuan refiner's and the LTX-2 connector's blocks
    count)."""
    for attr in ("hv_config", "hi_config", "hv15_config"):
        if hasattr(pipeline, attr):
            cfg = getattr(pipeline, attr)
            return cfg.num_layers + cfg.num_single_layers + cfg.refiner_layers, cfg
    if hasattr(pipeline, "ltx_config"):
        return 2 * pipeline.ltx_config.num_layers, pipeline.ltx_config
    if hasattr(pipeline, "ltx2_config"):
        cfg = pipeline.ltx2_config
        return 2 * cfg.num_layers + cfg.connector_blocks, cfg
    if hasattr(pipeline, "cp_config"):
        return 2 * pipeline.cp_config.num_blocks, pipeline.cp_config
    if hasattr(pipeline, "hd_config"):
        cfg = pipeline.hd_config
        return cfg.num_double_layers + cfg.num_single_layers, cfg
    if hasattr(pipeline, "lumina_config"):
        cfg = pipeline.lumina_config
        return cfg.num_layers + 2 * cfg.num_refiner_layers, cfg
    if hasattr(pipeline, "sd3_config"):
        return pipeline.sd3_config.num_layers, pipeline.sd3_config
    if hasattr(pipeline, "qi_config"):
        return pipeline.qi_config.num_layers, pipeline.qi_config
    for attr in ("f2_config", "af_config"):
        if hasattr(pipeline, attr):
            cfg = getattr(pipeline, attr)
            return cfg.num_layers + cfg.num_single_layers, cfg
    cfg = pipeline.chroma_config
    return cfg.num_layers + cfg.num_single_layers, cfg


def phase_slice_family(phase, cell, build, timed_steps=TIMED_STEPS, device="cuda",
                       expected_fn=None, no_gradient=NO_GRADIENT, after=None, may_stay=()):
    """An SD3, Chroma or Qwen-Image LoRA cell: one warm-up step, then
    `timed_steps` timed with the counters set to 0 just before: finite
    losses, every LoRA tensor moved (but those named in no_gradient, and
    those whose names end in one of may_stay), the
    base weights unchanged (with int8_matmul: every block linear int8 with
    real scales), the launches a step (expected_fn(pipeline), else K1-K3
    as the depth and checkpointing give them). after(pipeline, batch, gen)
    adds its checks and fields. Returns (launches, samples/s, peak)."""
    on_cuda = torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    pipeline, state, step, batch, gen = build()
    _sync(device)
    init_s = time.perf_counter() - t0
    trainable = dict(state.trainable)
    frozen = [p for p in pipeline.model.parameters() if not p.requires_grad]
    start = {n: p.detach().clone() for n, p in trainable.items()}
    frozen0 = _fingerprint(frozen)
    batch_size = batch["latents"].shape[0]
    if on_cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    warm_loss = step(state, batch, gen)["loss"].item()
    warm_s = time.perf_counter() - t0
    reset_launch_counts()
    t0 = time.perf_counter()
    metrics = [step(state, batch, gen) for _ in range(timed_steps)]
    _sync(device)
    step_s = (time.perf_counter() - t0) / timed_steps
    counts = launch_counts()
    losses = [m["loss"].item() for m in metrics]
    peak = torch.cuda.max_memory_allocated() if on_cuda else None
    per_step = {k: v / timed_steps for k, v in counts.items()}
    still = [n for n, p in trainable.items() if torch.equal(p, start[n])]
    moved = len(trainable) - len(still)
    del start
    frozen_same = torch.equal(_fingerprint(frozen), frozen0)
    blocks, mc = _model_blocks(pipeline)
    expected = expected_fn(pipeline) if expected_fn else _flash_per_step(blocks, mc.remat)
    linears, int8_real, _ = _int8_weights(pipeline.model)
    extra = after(pipeline, batch, gen) if after else {}
    emit(phase=phase, cell=cell, params=sum(p.numel() for p in pipeline.model.parameters()),
         blocks=blocks, remat=mc.remat,
         hidden=getattr(mc, "hidden_size", None) or getattr(mc, "dim", None) or mc.model_channels,
         lora_params=sum(p.numel() for p in trainable.values()), lora_tensors=len(trainable),
         latent_shape=list(batch["latents"].shape), init_s=init_s, warmup_s=warm_s,
         warmup_loss=warm_loss, timed_steps=timed_steps, step_s=step_s,
         samples_per_s=batch_size / step_s, losses=losses,
         grad_norms=[m["grad_norm"].item() for m in metrics], peak_memory_bytes=peak,
         launches=counts, launches_per_step=per_step, expected_per_step=expected,
         lora_tensors_moved=moved, lora_tensors_still=still, frozen_unchanged=frozen_same,
         block_linears=linears,
         int8_block_linears=int8_real, **extra)
    check(all(math.isfinite(x) for x in [warm_loss, *losses]), f"non-finite loss: {losses}")
    check(all(n.startswith(no_gradient) or n.endswith(may_stay) for n in still),
          f"{len(still)} LoRA tensors did not move: {still[:5]}")
    check(frozen_same, "frozen weights changed")
    check(not mc.int8_matmul or int8_real == linears,
          f"{linears - int8_real} of {linears} block linears lack an int8 weight with real scales")
    check(not on_cuda or per_step == expected,
          f"launches per step {per_step}, expected {expected}")
    return counts, batch_size / step_s, peak


SD3_DRIVER_TOML = """# sd3-medium-lora-1024's trainer settings through the driver, at 512 px
output_dir = "{root}/{out}"
dataset = "{root}/dataset.toml"
eval_datasets = ["{root}/eval.toml"]
epochs = 100
micro_batch_size_per_gpu = 2
gradient_accumulation_steps = 1
gradient_clipping = 1.0
save_every_n_epochs = 1
eval_before_first_step = {eval_first}
activation_checkpointing = true
sample_steps = {sample_steps}

[model]
type = "sd3"
dtype = "bfloat16"
vae_path = "{vae}"

[adapter]
type = "lora"
rank = 32
{init}
[optimizer]
type = "adamw8bit"
lr = 1e-4
"""
CHROMA_DRIVER_TOML = SD3_DRIVER_TOML.replace(
    "sd3-medium-lora-1024", "chroma-lora-512").replace(
    'activation_checkpointing = true', 'activation_checkpointing = "attn"').replace(
    'type = "sd3"', 'type = "chroma"')


def _sd3_text_stand_ins():
    """Seeded draws at SD3's cached shapes: CLIP-L [77, 768] + pooled 768,
    CLIP-G [77, 1280] + pooled 1280, T5 [256, 4096]."""
    from diffusion_pipe_tpu_torch.models.text_encoders import seeded_draws

    return [lambda caps: {"prompt_embed": seeded_draws(caps, "1", (77, 768)),
                          "pooled_prompt_embed": seeded_draws(caps, "p1", (768,))},
            lambda caps: {"prompt_2_embed": seeded_draws(caps, "2", (77, 1280)),
                          "pooled_prompt_2_embed": seeded_draws(caps, "p2", (1280,))},
            lambda caps: {"t5_prompt_embed": seeded_draws(caps, "t5", (256, 4096))}]


def _chroma_text_stand_in():
    """Seeded T5 rows [512, 4096] with the first min(len(caption) + 1, 512)
    valid and the mask: the `_tiny` hook's rule at full size."""
    from diffusion_pipe_tpu_torch.models.text_encoders import seeded_draws

    def t5(caps):
        emb = seeded_draws(caps, "t5", (512, 4096))
        mask = torch.zeros((len(caps), 512), dtype=torch.int32)
        for i, c in enumerate(caps):
            mask[i, :min(len(c) + 1, 512)] = 1
        return {"t5_embed": emb * mask[..., None], "t5_mask": mask}

    return [t5]


def _write_sd3_vae(folder):
    """A seeded full-width SD3 VAE (VAEConfig.sd3) in the diffusers layout."""
    from diffusion_pipe_tpu_torch import safetensors_io
    from diffusion_pipe_tpu_torch.models.autoencoder_kl import (AutoencoderKL, VAEConfig,
                                                                diffusers_vae_state_dict)

    folder.mkdir(parents=True)
    vae = AutoencoderKL(VAEConfig.sd3())
    vae.init_weights(torch.Generator().manual_seed(SEED))
    safetensors_io.save_file(diffusers_vae_state_dict(vae),
                             folder / "diffusion_pytorch_model.safetensors")
    return folder


def phase_driver_family(family, vae_dir=None):
    """SD3 (sd3-medium-lora-1024's settings at 512 px: LoRA r32, adamw8bit,
    full checkpointing) or Chroma (chroma-lora-512's: "attn") at full width
    and depth, or FLUX.2 (2 + 2 blocks, fp8 storage) or AuraFlow (1 + 2
    blocks, fp8 storage) at full width and cut depth, through train.main:
    8 seeded 512 px PNGs and 2 for eval, a
    seeded VAE (SD3's 16-channel one, FLUX.2's 32-channel one with its
    batch-norm statistics, AuraFlow's SDXL one, written here; Chroma: the
    vae phase's Flux VAE) and seeded text stand-ins in the published
    layouts (Chroma's with its T5 mask; FLUX.2's three stacked Mistral-3
    layers, 15,360 wide; Pile-T5's 2,048),
    --cache_only, 3 steps with the eval, a resume to 5 with --test_sample.
    Then a third call with adapter.init_from_existing naming the epoch
    export: the factors it loads, exported again, give the file's tensors
    bit for bit (Chroma's fused qkv / linear1 pairs included). Checks as
    driver-sdxl, the adapter's key count (pairs and alphas) and the
    launches (steps, eval and sample forwards). Returns the launches of the
    two training calls."""
    import tomllib

    from PIL import Image

    from diffusion_pipe_tpu_torch import safetensors_io, train
    from diffusion_pipe_tpu_torch.config import set_config_defaults
    from diffusion_pipe_tpu_torch.models import get_model_class
    from diffusion_pipe_tpu_torch.models.keymaps import export_lora_keymap
    from diffusion_pipe_tpu_torch.training import trainer

    root = _fresh_dir(SMOKE_DIR / f"driver_{family}")
    if family == "sd3":
        vae_dir = _write_sd3_vae(root / "vae")
        toml, stand_ins = SD3_DRIVER_TOML, _sd3_text_stand_ins
    elif family == "flux2":
        vae_dir = _write_flux2_vae(root / "vae")
        toml, stand_ins = FLUX2_DRIVER_TOML, _flux2_text_stand_in
    elif family == "auraflow":
        vae_dir = _write_sdxl_vae(root / "vae")
        toml, stand_ins = AURAFLOW_DRIVER_TOML, _auraflow_text_stand_in
    elif family == "hidream":
        toml, stand_ins = HIDREAM_DRIVER_TOML, _hidream_text_stand_in
    elif family in ("anima", "cosmos_predict2"):
        anima = family == "anima"
        toml = ANIMA_DRIVER_TOML if anima else PREDICT2_DRIVER_TOML
        stand_ins = (_anima_text_stand_in if anima
                     else functools.partial(_t5_text_stand_in, "t5_embed"))
        _write_predict2_checkpoint(root / "predict2_2_blocks.safetensors", anima)
    elif family == "cosmos":
        toml, stand_ins = COSMOS_DRIVER_TOML, functools.partial(_t5_text_stand_in,
                                                                "prompt_embeds")
    elif family in ("hunyuan-video", "hunyuan_image"):
        toml = (HUNYUAN_VIDEO_DRIVER_TOML if family == "hunyuan-video"
                else HUNYUAN_IMAGE_DRIVER_TOML)
        stand_ins = functools.partial(_hunyuan_text_stand_in, family)
        if family == "hunyuan_image":
            vae_dir = _write_hunyuan_image_vae(root / "vae")
    elif family in LTX_HV15_DRIVER_TOMLS:
        toml = LTX_HV15_DRIVER_TOMLS[family]
        stand_ins = functools.partial(_ltx_hv15_text_stand_in, family)
        if family == "hunyuan_video_15":
            vae_dir = _write_hv15_vae(root / "vae")
    elif family in LUMINA_DRIVER_TOMLS:
        toml = LUMINA_DRIVER_TOMLS[family]
        stand_ins = functools.partial(_lumina_text_stand_in, family)
    else:
        toml, stand_ins = CHROMA_DRIVER_TOML, _chroma_text_stand_in
    _write_images(root / "train", DRIVER_IMAGES, SEED)
    _write_images(root / "eval", DRIVER_EVAL_IMAGES, SEED + 1)
    for name in ("dataset", "eval"):
        folder = "train" if name == "dataset" else "eval"
        (root / f"{name}.toml").write_text(
            f'resolutions = [512]\n[[directory]]\npath = "{root}/{folder}"\n')
    text = toml.format(root=root, out="out", vae=vae_dir, sample_steps=DRIVER_SAMPLE_STEPS,
                       eval_first="true", init="")
    cfg_path = root / f"{family}_lora.toml"
    cfg_path.write_text(text)
    argv = ["--config", str(cfg_path)]
    cls = get_model_class(family)

    captured = []
    real_init = trainer.init_train_state
    real_te = cls.get_call_text_encoder_fns

    def init_and_keep(pipeline, *a, **kw):
        state = real_init(pipeline, *a, **kw)
        frozen = [p for p in pipeline.model.parameters() if not p.requires_grad]
        captured.append((pipeline, state, _fingerprint(frozen),
                         {n: p.detach().cpu().clone() for n, p in state.trainable.items()}))
        return state

    def run(argv_, extra, steps, lora_before=None):
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        check(train.main(argv_ + extra) == 0, f"train.main {extra} failed")
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = launch_counts()
        pipeline, state, frozen_print, lora0 = captured.pop()
        lora0 = lora_before or lora0
        frozen = [p for p in pipeline.model.parameters() if not p.requires_grad]
        blocks, _ = _model_blocks(pipeline)
        out = dict(steps=steps, wall_s=wall_s, launches=counts,
                   peak_memory_bytes=torch.cuda.max_memory_allocated(),
                   frozen_unchanged=bool(torch.equal(_fingerprint(frozen), frozen_print)),
                   lora_tensors=len(state.trainable),
                   lora_tensors_still=[n for n, p in state.trainable.items()
                                       if torch.equal(p.cpu(), lora0[n])])
        shape = dict(blocks=blocks, step=_flash_step(pipeline))
        del pipeline, state, frozen
        _free()
        return out, shape

    trainer.init_train_state = init_and_keep
    cls.get_call_text_encoder_fns = lambda self: stand_ins()
    real_vae = cls.get_call_vae_fn
    if family in LTX_HV15_DRIVER_TOMLS:
        cls.get_call_vae_fn = lambda self: _clip_vae_fn(real_vae(self))
    try:
        t0 = time.perf_counter()
        check(train.main(argv + ["--cache_only"]) == 0, "--cache_only failed")
        cache_s = time.perf_counter() - t0
        _free()
        first, shape = run(argv, ["--max_steps", str(DRIVER_STEPS)], DRIVER_STEPS)
        run_dir = next((root / "out").iterdir())
        at_first = torch.load(run_dir / f"global_step{DRIVER_STEPS}" / "state.pt",
                              map_location="cpu", weights_only=True)["trainable"]
        second, _ = run(argv, ["--resume_from_checkpoint", "--max_steps",
                               str(DRIVER_RESUMED_STEPS), "--test_sample", SAMPLE_PROMPT],
                        DRIVER_RESUMED_STEPS - DRIVER_STEPS, at_first)
        del at_first
        # the epoch export, imported by a fresh run through init_from_existing
        export = run_dir / "epoch1"
        reimport_path = root / f"{family}_reimport.toml"
        reimport_path.write_text(toml.format(
            root=root, out="reimport", vae=vae_dir, sample_steps=DRIVER_SAMPLE_STEPS,
            eval_first="false", init=f'init_from_existing = "{export}"\n'))
        loaded, keymap = {}, []

        def init_and_copy(pipeline, *a, **kw):
            state = init_and_keep(pipeline, *a, **kw)
            loaded.update({n: p.detach().cpu().clone() for n, p in state.trainable.items()})
            keymap.extend((pipeline.keymap(), pipeline._keymap_config()))
            return state

        trainer.init_train_state = init_and_copy
        run(["--config", str(reimport_path)], ["--max_steps", "1"], 1)
        config = set_config_defaults(tomllib.loads(text))
        uninterrupted, loader_cost = _uninterrupted_loader_state(root, DRIVER_RESUMED_STEPS,
                                                                 config)
    finally:
        trainer.init_train_state = real_init
        cls.get_call_text_encoder_fns = real_te
        cls.get_call_vae_fn = real_vae
    calls = [first, second]
    adapter = safetensors_io.load_file(export / "adapter_model.safetensors")
    factors = {k: v for k, v in adapter.items() if not k.endswith(".alpha")}
    again = export_lora_keymap(loaded, *keymap)
    same = set(again) == set(factors) and all(torch.equal(again[k], factors[k])
                                              for k in factors)
    fused = sum(int(".qkv." in k or ".linear1." in k) for k in factors)
    extra = {}
    if family == "anima":
        from diffusion_pipe_tpu_torch.models.llm_adapter import export_llm_adapter

        llm = safetensors_io.load_file(export / "llm_adapter.safetensors")
        back = export_llm_adapter(loaded)
        extra.update(llm_adapter_tensors=len(llm), llm_adapter_reimported_bit_identical=(
            set(back) == set(llm) and all(torch.equal(back[k], llm[k]) for k in llm)))
    elif family == "cosmos":
        extra.update(cosmos_driver_clip(vae_dir))

    per_forward = {k: shape["blocks"] if k == "flash_fwd" else 0 for k in shape["step"]}
    eval_forwards = 9 * -(-DRIVER_EVAL_IMAGES // 2)
    expected = [{k: v * first["steps"] + per_forward[k] * eval_forwards
                 for k, v in shape["step"].items()},
                {k: v * second["steps"] + per_forward[k] * DRIVER_SAMPLE_STEPS
                 for k, v in shape["step"].items()}]
    recs = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    losses = {r["step"]: r["train/loss"] for r in recs if "train/loss" in r}
    evals = [r for r in recs if any(k.startswith("eval/") for k in r)]
    quantiles = sorted(k for r in evals for k in r if "loss_quantile_" in k)
    final = run_dir / f"global_step{DRIVER_RESUMED_STEPS}"
    meta = json.loads((final / "client_state.json").read_text())
    saved_step = torch.load(final / "state.pt", map_location="cpu", weights_only=True)["step"]
    step_times = _driver_step_times(run_dir / "metrics.jsonl")
    step_s = sum(step_times) / len(step_times)
    example = Image.open(Path(config["output_dir"]) / "example.png")
    n_lora = first["lora_tensors"]
    name = DRIVER_PHASE_NAMES.get(family, f"driver-{family}")
    emit(phase=name, cell=name, cache_only_s=cache_s, calls=calls,
         expected_launches=expected, losses=losses, eval=evals, step_s=step_s,
         step_times_s=step_times, samples_per_s=2 / step_s, final_step=saved_step,
         loader_state=meta.get("custom_loader"), uninterrupted_loader_state=uninterrupted,
         loader_cost=loader_cost, adapter_keys=len(adapter), adapter_factors=len(factors),
         fused_factors=fused, reimported_bit_identical=same, example_png=list(example.size),
         **extra)
    check(all(math.isfinite(v) for v in losses.values()), f"non-finite loss: {losses}")
    check(sorted(losses) == list(range(1, DRIVER_RESUMED_STEPS + 1)), f"train/loss steps {losses}")
    check(len(quantiles) == 9, f"eval quantiles {quantiles}")
    check(saved_step == DRIVER_RESUMED_STEPS and meta["step"] == DRIVER_RESUMED_STEPS,
          f"step counter {saved_step}")
    check(meta.get("custom_loader") == uninterrupted,
          f"loader {meta.get('custom_loader')} against an uninterrupted run's {uninterrupted}")
    check(all(c["frozen_unchanged"] for c in calls), "base weights changed")
    may_stay = (NEW_MAY_STAY if family in ("flux2", "auraflow", "z_image", "hidream", "anima",
                                           "cosmos_predict2", "cosmos", "hunyuan-video",
                                           "hunyuan_image", *LTX_HV15_DRIVER_TOMLS)
                else ("none",))
    no_gradient = NO_GRADIENT + (_hv15_no_gradient(2) if family == "hunyuan_video_15" else ())
    check(all(c["lora_tensors"] == n_lora and all(n.startswith(no_gradient) or n.endswith(may_stay)
                                                  for n in c["lora_tensors_still"])
              for c in calls), "LoRA factors did not all move")
    keys = ADAPTER_KEYS[family]
    check(len(adapter) == keys and len(factors) == ADAPTER_FACTORS.get(family, 2 * keys // 3),
          f"adapter keys {len(adapter)} ({len(factors)} factors), expected {keys}")
    check(family != "chroma" or fused > 0, "no fused pair in the Chroma adapter")
    check(family != "anima" or (extra["llm_adapter_tensors"] == ANIMA_ADAPTER_TENSORS
                                and extra["llm_adapter_reimported_bit_identical"]),
          f"the LLMAdapter export: {extra}")
    check(same, "the adapter loaded through init_from_existing does not export to the file")
    check(example.size == (512, 512), f"example.png is {example.size}")
    for c, want in zip(calls, expected):
        check(c["launches"] == want, f"{name} launches {c['launches']}, expected {want}")
    return {k: sum(c["launches"][k] for c in calls) for k in first["launches"]}


DRIVER_PHASE_NAMES = {"lumina_2": "driver-lumina2", "z_image": "driver-zimage",
                      "cosmos_predict2": "driver-predict2",
                      "hunyuan-video": "driver-hunyuan-video",
                      "hunyuan_image": "driver-hunyuan-image",
                      "hunyuan_video_15": "driver-hunyuan-video-15",
                      "ltx-video": "driver-ltx-video", "ltx2": "driver-ltx2"}
# the generic keymap export at full depth: lora_A, lora_B and alpha of each
# pair. SD3-Medium: 23 blocks x 14 linears + the final block's 11 = 333
# pairs. Chroma: a double block's 6 linears and fused img / txt qkv (8
# pairs) x 19, a single block's linear2 and fused linear1 (2) x 38 = 228
# pairs for its 418 LoRA linears (tests/test_torch_keymaps.py holds the
# layout against the JAX export at tiny depth)
ADAPTER_KEYS = {"sd3": 3 * (23 * 14 + 11), "chroma": 3 * (19 * 8 + 38 * 2),
                # the driver cells' cut depths: FLUX.2 2 double blocks of 8
                # linears and 2 single of 2; AuraFlow 1 joint of 16 and 2
                # single of 8; Z-Image 2 main blocks and 2 + 2 refiners, the
                # fused qkv and 4 more pairs each
                "flux2": 3 * (2 * 8 + 2 * 2), "auraflow": 3 * (1 * 16 + 2 * 8),
                "z_image": 3 * 6 * 5,
                # Lumina 2 with LoKr (no alphas): w1, w2_a and w2_b of each
                # of a block's 7 linears (the fused qkv's 3 parts apart)
                "lumina_2": 3 * 6 * 7,
                # HiDream's 1 + 2 blocks: a double block's 27 adapted
                # linears (adaLN, 8 attention, 3 shared-expert, 4 x 3 routed
                # experts, 3 ff_t), a single block's 20
                "hidream": 3 * (1 * 27 + 2 * 20),
                # the Cosmos families' 2 blocks of 16 adapted linears (10
                # attention and MLP, 6 modulation)
                "anima": 3 * 2 * 16, "cosmos_predict2": 3 * 2 * 16, "cosmos": 3 * 2 * 16,
                # the Hunyuan families' 1 + 1 blocks: a double block's 10
                # adapted linears (fused qkv, proj, MLP, modulation of each
                # stream) and a single block's 3
                "hunyuan-video": 3 * (10 + 3), "hunyuan_image": 3 * (10 + 3),
                # HunyuanVideo-1.5's 2 double blocks of 10; LTX-Video's and
                # LTX-2's 2 blocks of 10 (q, k, v, out of both attentions, the MLP)
                "hunyuan_video_15": 3 * 2 * 10, "ltx-video": 3 * 2 * 10, "ltx2": 3 * 2 * 10}
# Anima's LLMAdapter (6 layers with self-attention) as exported: the
# embedding, 19 tensors a layer, out_proj's two and the norm
ANIMA_ADAPTER_TENSORS = 1 + 6 * 19 + 3
# adapter tensors other than the alphas, where not 2 / 3 of them
ADAPTER_FACTORS = {"lumina_2": 3 * 6 * 7}


# --- slice 11: Qwen-Image and Qwen-Image-Edit ----------------------------------

# K1-K3 at Qwen-Image's joint sequence (bf16, D 128, 24 heads): 512 text rows,
# of which 77 and 300 are valid (the key mask), then the 4,096 image tokens
# of 1024 px (B 2), or 8,192 with the control image of an edit (B 1).
# (case, (B, S, H), D, masked keys of each batch element, checked heads)
QWEN_KERNEL_CASES = (
    ("qwen_1024_masked", (2, 4608, 24), 128, (slice(77, 512), slice(300, 512)), slice(0, 6)),
    ("qwen_edit_8704_masked", (1, 8704, 24), 128, (slice(77, 512),), slice(0, 6)),
)
QWEN_TXT = 512
QWEN_VALID = (77, 300)  # valid text rows of each example's 512 in the Qwen cells
# H1 / H2 at Qwen-Image's ff_in (3,072 -> 12,288): the image MLP's rows, the
# 4,096 image tokens of each of the batch's 2 examples at 1024 px
QWEN_FF_IN_ROWS = 2 * 4096
QWEN_INT8_H1_CASES = {"forward_ff_in": (QWEN_FF_IN_ROWS, 3072, False),
                      "dgrad_ff_in": (QWEN_FF_IN_ROWS, 12288, True)}


def phase_kernels_qwen():
    """K1-K3 at Qwen-Image's masked joint shapes against their plain
    versions (six heads as strided views), K2 / K3 deterministic on both,
    each timed beside its bound over the valid keys, its plain version and
    SDPA's forward and backward under the same boolean mask; H1 and H2 bit
    for bit and timed at ff_in's shape. Returns ({case: K1-K3 timing},
    {kernel: H1 / H2 timing})."""
    from diffusion_pipe_tpu_torch.ops import flash_attention as fa
    from diffusion_pipe_tpu_torch.ops import int8_quant as iq

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    errors, timings, splits = {}, {}, {}
    for case, (b, s, h), d, masked, heads in QWEN_KERNEL_CASES:
        errors[case] = _check_attention(fa, case, b, s, s, h, d, masked, gen, heads=heads)
        _free()
        splits[case] = _check_bwd_deterministic(fa, case, b, s, s, h, d, gen, masked=masked)
        _free()
    for case, (b, s, h), d, masked, _ in QWEN_KERNEL_CASES:
        timing, sdpa_bwd_ms = _time_attention(fa, b, s, s, h, d, gen, masked=masked)
        for name, tm in timing.items():
            tm["max_abs_err"] = max(errors[case][k]["err"] for k in ERR_KEYS[name])
        emit(phase="kernels-qwen", case=f"timing_{case}", q_shape=[b, s, h, d], kv_len=s,
             masked=True, valid_keys=[s - (m.stop - m.start) for m in masked],
             timing=timing, sdpa_bwd_ms=sdpa_bwd_ms)
        timings[case] = timing
        _free()
    h1 = {case: _h1_timing(iq, f"qwen_{case}", *shape, gen)
          for case, shape in QWEN_INT8_H1_CASES.items()}
    h2 = _h2_timing(iq, gen, shape=(QWEN_FF_IN_ROWS, 12288), case="qwen_ff_in")
    _free()
    emit(phase="kernels-qwen", k3_query_splits=splits)
    return timings, {"quant_rows": h1, "rescale_i32": h2}


def phase_reference_qwen(device="cuda"):
    """Qwen-Image with 2 blocks at the published head dim 128, 2 heads, a
    64-wide text input: 64 image tokens (an 8 x 8 packed grid, diffusers'
    centred RoPE ids) and 40 text rows of which 25 are valid (the key
    mask), 104 keys; bf16 on the card against f32 on the CPU."""
    from diffusion_pipe_tpu_torch.models.qwen_image import (QwenImageConfig,
                                                            QwenImageTransformer, qwen_rope_ids)

    def build(dtype, dev):
        cfg = QwenImageConfig(num_layers=2, num_attention_heads=2, joint_attention_dim=64,
                              dtype=dtype, param_dtype=dtype, lora_rank=4, lora_alpha=4.0,
                              lora_dtype=dtype)
        with torch.device(dev):
            return QwenImageTransformer(cfg)

    gen = torch.Generator().manual_seed(SEED + 3)
    x = torch.randn((1, 64, 64), generator=gen)
    txt = torch.randn((1, 40, 64), generator=gen)
    mask = torch.zeros((1, 40), dtype=torch.int32)
    mask[:, :25] = 1
    target = torch.randn((1, 64, 64), generator=gen)
    img_ids, txt_ids = qwen_rope_ids([(8, 8)], 40)

    def inputs(dtype):
        return dict(hidden_states=x.to(dtype), encoder_hidden_states=txt.to(dtype),
                    timestep=torch.tensor([0.4]), img_ids=img_ids, txt_ids=txt_ids,
                    txt_mask=mask)

    _reference_family("reference-qwen", build, inputs, target, device, blocks=2)


QWEN_LORA_CONFIG = {  # qwen-image-lora-1024: examples/qwen_image.toml's trainer
    "save_every_n_epochs": 1,
    "model": {"type": "qwen_image", "dtype": "bfloat16", "transformer_dtype": "float8",
              "int8_matmul": "fwd_bwd", "timestep_sample_method": "logit_normal"},
    "adapter": {"type": "lora", "rank": 32, "alpha": 32, "dropout": 0.0, "dtype": "bfloat16"},
    "optimizer": {"type": "adamw8bit", "lr": 2e-5, "betas": [0.9, 0.99], "weight_decay": 0.01},
    "gradient_clipping": 1.0,
    "activation_checkpointing": True,
}
QWEN_EDIT_DEPTH = 4  # blocks of the full-width qwen-image-edit cell
QWEN_EDIT_CONFIG = {**QWEN_LORA_CONFIG, "model": {
    **QWEN_LORA_CONFIG["model"], "type": "qwen_image_edit", "num_layers": QWEN_EDIT_DEPTH}}
QWEN_TIMED_STEPS = 3
# the last block's text stream ends nowhere: its text MLP and output
# projection get no gradient, its text queries a zero one, so their LoRA B
# stays at its zero init (and A with it)
QWEN_TEXT_TAIL = ("attn_add_q", "attn_to_add_out", "ff_context_in", "ff_context_out")
# the example's bf16 factors at lr 2e-5: adamw's first steps move a lora_a
# entry (about 0.04) by about the lr, under half its bf16 spacing (2.4e-4),
# so a lora_a may round back to itself; every lora_b (from zero) moves
QWEN_MAY_STAY = (".lora_a",)


def _qwen_no_gradient(pipeline):
    last = pipeline.qi_config.num_layers - 1
    return tuple(f"blocks.{last}.{m}." for m in QWEN_TEXT_TAIL)


def build_qwen_slice(cfg=QWEN_LORA_CONFIG, device="cuda", latent_hw=128, txt_len=QWEN_TXT,
                     valid=QWEN_VALID):
    """Qwen-Image (or -Edit) at the config's size; a batch of latents (and
    control latents for an edit) with text rows [txt_len, 3584] of which
    `valid` of each example are unmasked (zero rows after)."""
    def make_batch(pipeline, gen):
        qc = pipeline.qi_config
        b = len(valid)
        mask = torch.zeros((b, txt_len), dtype=torch.int32, device=device)
        for i, n in enumerate(valid):
            mask[i, :n] = 1
        emb = torch.randn((b, txt_len, qc.joint_attention_dim), generator=gen, device=device)
        batch = {"latents": torch.randn((b, 16, latent_hw, latent_hw), generator=gen,
                                        device=device),
                 "prompt_embeds": (emb * mask[..., None]).to(qc.dtype),
                 "prompt_embeds_mask": mask}
        if pipeline.edit:
            batch["control_latents"] = torch.randn(batch["latents"].shape, generator=gen,
                                                   device=device)
        return batch

    return _build_family_slice(cfg["model"]["type"], cfg, device, make_batch)


def _qwen_expected(pipeline):
    """Launches a training step of a Qwen-Image LoRA cell: K1 once a block
    (twice under `true`: the forward and its recompute), K2 and K3 once; H1
    and H2 once an int8 block linear for the forward, again for the
    recompute, and once more for its dgrad, which autograd skips where the
    input needs no gradient (the modulation linears, fed by the frozen
    timestep embedder) and where no gradient arrives (the last block's
    text tail but its queries)."""
    from diffusion_pipe_tpu_torch.models.layers import LoraDense

    qc = pipeline.qi_config
    int8 = [n for n, m in pipeline.model.named_modules()
            if isinstance(m, LoraDense) and m.kernel_scale is not None]
    no_dgrad = sum(int(n.endswith(MODULATION)) for n in int8) + len(QWEN_TEXT_TAIL) - 1
    dgrads = len(int8) - no_dgrad if qc.int8_matmul == "fwd_bwd" else 0
    launches = len(int8) * (2 if qc.remat else 1) + dgrads
    return {"flash_fwd": qc.num_layers * (2 if qc.remat == "full" else 1),
            "flash_bwd_dq": qc.num_layers, "flash_bwd_dkv": qc.num_layers, "sr_add": 0,
            "quant_rows": launches, "rescale_i32": launches}


def phase_slice_qwen(edit=False):
    """qwen-image-lora-1024 (60 blocks, 20.4 B) or, with edit, the 4-block
    qwen-image-edit-lora-1024-4-blocks cell (8,704 keys; the output cut to
    the target's 4,096 rows): phase_slice_family with the Qwen launches
    and the last block's text tail allowed to stay still."""
    cfg = QWEN_EDIT_CONFIG if edit else QWEN_LORA_CONFIG

    def after(pipeline, batch, gen):
        with torch.no_grad():
            inputs, target, _ = pipeline.prepare_inputs(batch, gen)
            out = pipeline.forward(inputs)
        shape = list(out.shape)
        check(shape == list(target.shape) == [len(QWEN_VALID), 4096, 64],
              f"output {shape}, target {list(target.shape)}")
        return dict(sequence=inputs["hidden_states"].shape[1] + QWEN_TXT, output_shape=shape)

    name = "qwen-image-edit-lora-1024-4-blocks" if edit else "qwen-image-lora-1024"
    counts, rate, peak = phase_slice_family(
        "slice-qwen-image-edit-lora" if edit else "slice-qwen-image-lora", name,
        lambda: build_qwen_slice(cfg), timed_steps=QWEN_TIMED_STEPS,
        expected_fn=_qwen_expected,
        no_gradient=tuple(f"blocks.{(QWEN_EDIT_DEPTH if edit else 60) - 1}.{m}."
                          for m in QWEN_TEXT_TAIL),
        after=after, may_stay=QWEN_MAY_STAY)
    return counts


QWEN_TOKENIZER_WORDS = ("a", "seeded", "picture", "number", "0", "1")


def _qwen_tokenizer():
    """A synthetic Qwen2-style tokenizer in memory: word-level over the
    chat templates' words and a few caption words, the special tokens
    after them, <|endoftext|> the padding. No tokenizer file exists on the
    card's machine; this stands in for Qwen2.5-VL's."""
    from diffusion_pipe_tpu_torch.models.qwen_image import EDIT_TEMPLATE, T2I_TEMPLATE

    return _word_tokenizer(
        set((T2I_TEMPLATE + EDIT_TEMPLATE).split()) | set(QWEN_TOKENIZER_WORDS),
        pad="<|endoftext|>", specials=["<|im_start|>", "<|im_end|>", "<|vision_start|>",
                                       "<|vision_end|>", "<|image_pad|>"])


def _word_tokenizer(words, pad="<pad>", eos=None, specials=()):
    """A word-level tokenizer in memory over `words` ("<unk>" first), `pad`,
    `eos` and `specials` added after them as special tokens (no tokenizer
    file exists on the card's machine)."""
    from tokenizers import Tokenizer, models, pre_tokenizers

    try:
        from transformers import PreTrainedTokenizerFast
    except ImportError:  # transformers 5 names it TokenizersBackend
        from transformers import TokenizersBackend as PreTrainedTokenizerFast
    vocab = ["<unk>"] + sorted(set(words))
    tok = Tokenizer(models.WordLevel({w: i for i, w in enumerate(vocab)}, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    kw = {} if eos is None else {"eos_token": eos}
    return PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="<unk>", pad_token=pad,
                                   additional_special_tokens=list(specials), **kw)


def phase_qwen25vl():
    """Qwen2.5-VL-7B's text tower at its published width and depth (28
    layers, 3,584 wide, 28 / 4 heads, ffn 18,944) and its vision tower (32
    layers, 1,280 wide, windowed) from a seed, bf16: the t2i text function
    (LLMTextEncoder: the chat template, 546 ids, the first 34 rows
    dropped) on 2 captions, timed; the vision tower on a 336 px control
    image (576 patches, 144 merged tokens), timed; the whole edit text
    function once (the image's tokens spliced at <|image_pad|>, multimodal
    RoPE ids, 64 rows dropped). The weights are the seeded modules, handed
    to the encoders in place of a checkpoint; a synthetic tokenizer stands
    in for Qwen's. Checks: finite outputs of the expected shapes, the
    masks' valid counts, and the first layer at full width bf16 on the
    card against f32 on the CPU (relative L2 3e-2)."""
    import dataclasses

    import numpy as np
    from PIL import Image

    from diffusion_pipe_tpu_torch.models.llm_encoders import (CausalLM, CausalLMConfig,
                                                              LLMTextEncoder)
    from diffusion_pipe_tpu_torch.models.qwen_image import (T2I_DROP, T2I_TEMPLATE,
                                                            QwenEditTextEncoder)
    from diffusion_pipe_tpu_torch.models.vision_encoders import (QwenVLVisionConfig,
                                                                 QwenVLVisionTower,
                                                                 image_to_qwen_patches)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    cfg = CausalLMConfig.qwen25_vl_7b()
    t0 = time.perf_counter()
    with torch.device("cuda"):
        lm = CausalLM(cfg)
    lm.init_weights(gen)
    lm = lm.eval().requires_grad_(False)
    vcfg = QwenVLVisionConfig(dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    with torch.device("cuda"):
        tower = QwenVLVisionTower(vcfg)
    tower.init_weights(gen)
    tower = tower.eval().requires_grad_(False)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tokenizer = _qwen_tokenizer()
    caps = ["a seeded picture, number 0", "a seeded picture " + "number 1 " * 40]

    t2i = LLMTextEncoder("", max_length=QWEN_TXT, template=T2I_TEMPLATE, crop_start=T2I_DROP,
                         dtype=torch.bfloat16, device="cuda")
    t2i.model, t2i.tokenizer = lm, tokenizer
    h, mask = t2i.encode(caps)
    encode_ms = cuda_ms(lambda: t2i.encode(caps), iters=3)
    n_ids = len(tokenizer(T2I_TEMPLATE.format(caps[1]))["input_ids"])

    img = (np.random.default_rng(SEED).uniform(-1, 1, (3, 336, 336))).astype(np.float32)
    patches, grid = image_to_qwen_patches(img)
    pixels = torch.from_numpy(patches).cuda()
    with torch.no_grad():
        vis = tower(pixels, (grid,))
        vision_ms = cuda_ms(lambda: tower(pixels, (grid,)), iters=3)

    root = _fresh_dir(SMOKE_DIR / "qwen25vl")
    png = root / "control.png"
    Image.fromarray(((img.transpose(1, 2, 0) + 1) * 127.5).astype(np.uint8)).save(png)
    edit = QwenEditTextEncoder("", "", QWEN_TXT, 336, torch.bfloat16, "cuda")
    edit.lm, edit.tower, edit.tokenizer = lm, tower, tokenizer
    edit.image_token_id = tokenizer.convert_tokens_to_ids("<|image_pad|>")
    edit.grid, edit.n_img = grid, grid[1] * grid[2] // 4
    t0 = time.perf_counter()
    out = edit(caps, [png, png])
    torch.cuda.synchronize()
    edit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()

    # the first layer at full width: bf16 on the card, f32 on the CPU
    one = dataclasses.replace(cfg, num_layers=1, vocab=1)
    sd = {k: v for k, v in lm.state_dict().items()
          if k.startswith("layers.0.") or k == "final_norm"}
    emb = lm.token_embedding(torch.randint(0, cfg.vocab, (1, 128), generator=gen,
                                           device="cuda"))
    with torch.device("cuda"):
        gpu1 = CausalLM(one)
    gpu1.load_state_dict(sd, strict=False)
    cpu1 = CausalLM(dataclasses.replace(one, dtype=torch.float32, param_dtype=torch.float32))
    cpu1.load_state_dict({k: v.float().cpu() for k, v in sd.items()}, strict=False)
    with torch.no_grad():
        got = gpu1(input_embeds=emb)[0].float().cpu()
        want = cpu1(input_embeds=emb.float().cpu())[0]
    layer_err = _rel_l2(got, want)
    emit(phase="qwen25vl", params=sum(p.numel() for p in lm.parameters()),
         vision_params=sum(p.numel() for p in tower.parameters()), init_s=init_s,
         prompt_ids=h.shape[1] + T2I_DROP, template_ids=n_ids, t2i_shape=list(h.shape),
         t2i_valid=mask.sum(1).tolist(), encode_ms=encode_ms, vision_tokens=list(vis.shape),
         vision_ms=vision_ms, edit_shape=list(out["prompt_embeds"].shape),
         edit_valid=out["prompt_embeds_mask"].sum(1).tolist(), edit_s=edit_s,
         peak_memory_bytes=peak, first_layer_rel_l2=layer_err)
    check(list(h.shape) == [2, QWEN_TXT, 3584] and bool(torch.isfinite(h).all()),
          f"t2i embeddings {list(h.shape)}")
    check(list(vis.shape) == [144, 3584] and bool(torch.isfinite(vis).all()),
          f"vision tokens {list(vis.shape)}")
    emb_out = out["prompt_embeds"]
    check(list(emb_out.shape) == [2, QWEN_TXT + 144, 3584] and bool(torch.isfinite(emb_out).all()),
          f"edit embeddings {list(emb_out.shape)}")
    check(0 < int(mask[0].sum()) < int(mask[1].sum()), f"t2i masks {mask.sum(1).tolist()}")
    check(layer_err < 3e-2, f"the first layer off the f32 CPU one: {layer_err}")
    del lm, tower, gpu1, t2i, edit


QWEN_DRIVER_TOML = """# examples/qwen_image.toml's settings through the driver, at 512 px
output_dir = "{root}/{out}"
dataset = "{root}/dataset.toml"
eval_datasets = ["{root}/eval.toml"]
epochs = 1000
micro_batch_size_per_gpu = 1
pipeline_stages = 1
gradient_accumulation_steps = 4
gradient_clipping = 1.0
eval_every_n_epochs = 1
eval_before_first_step = {eval_first}
eval_micro_batch_size_per_gpu = 1
eval_gradient_accumulation_steps = 1
save_every_n_epochs = 1
checkpoint_every_n_minutes = 120
activation_checkpointing = true
save_dtype = "bfloat16"
caching_batch_size = 8
steps_per_print = 1
sample_steps = {sample_steps}

[model]
type = "qwen_image"
diffusers_path = "{model}"
dtype = "bfloat16"
transformer_dtype = "float8"
int8_matmul = "fwd_bwd"
timestep_sample_method = "logit_normal"
num_layers = {depth}
_random_init = true

[adapter]
type = "lora"
rank = 32
dtype = "bfloat16"
{init}
[optimizer]
type = "adamw8bit"
lr = 2e-5
betas = [0.9, 0.99]
weight_decay = 0.01
"""
QWEN_GAS = 4
# driver-qwen's depth: 10 of the 60 blocks (the smoke's time limit; the
# slice-qwen-image-lora cell keeps all 60)
QWEN_DRIVER_DEPTH = 10
# lora_A, lora_B and alpha of the 140 block linears
QWEN_ADAPTER_KEYS = 3 * QWEN_DRIVER_DEPTH * 14


def _qwen_text_stand_in():
    """Seeded text rows [512, 3584] with the first min(len(caption) + 1,
    512) valid and the mask: the `_tiny` hook's rule at full size."""
    from diffusion_pipe_tpu_torch.models.text_encoders import seeded_draws

    def fn(caps):
        emb = seeded_draws(caps, "qwen", (QWEN_TXT, 3584))
        mask = torch.zeros((len(caps), QWEN_TXT), dtype=torch.int32)
        for i, c in enumerate(caps):
            mask[i, :min(len(c) + 1, QWEN_TXT)] = 1
        return {"prompt_embeds": emb * mask[..., None], "prompt_embeds_mask": mask}

    return [fn]


def _write_qwen_vae(folder):
    """A seeded full-width Wan 2.1 VAE in diffusers' AutoencoderKLQwenImage
    layout: what <diffusers_path>/vae of a Qwen-Image folder holds."""
    from diffusion_pipe_tpu_torch import safetensors_io
    from diffusion_pipe_tpu_torch.models.wan_vae import WanVAEConfig, WanVideoVAE
    from diffusion_pipe_tpu_torch.models.wan_vae_convert import (diffusers_key_map,
                                                                 wan_vae_state_dict)

    folder.mkdir(parents=True)
    cfg = WanVAEConfig.wan21()
    vae = WanVideoVAE(cfg)
    vae.init_weights(torch.Generator().manual_seed(SEED))
    names = diffusers_key_map(cfg)
    safetensors_io.save_file({names[k]: v.to(torch.bfloat16).contiguous()
                              for k, v in wan_vae_state_dict(vae).items()},
                             folder / "diffusion_pytorch_model.safetensors")
    return folder


def phase_driver_qwen():
    """examples/qwen_image.toml's settings (fp8 storage pre-quantized to
    int8, int8_matmul "fwd_bwd", LoRA r32, adamw8bit, `true`
    checkpointing, micro batch 1 and GAS 4, eval every epoch) at full width
    and QWEN_DRIVER_DEPTH of the 60 blocks through train.main at 512 px: 8
    seeded PNGs and 2 for eval, a
    diffusers folder holding a seeded Wan 2.1 VAE in the
    AutoencoderKLQwenImage layout (the transformer from random init: the
    `_random_init` hook) and the seeded text stand-in with its mask;
    --cache_only, 3 steps with the evals, a resume to 5 with --test_sample,
    then a third call whose adapter.init_from_existing loads the epoch
    export: exported again, the same tensors bit for bit. Checks as
    driver-sd3, the 420 adapter keys, the launches (each call's
    pre-quantization, GAS 4 micro-steps a step, 9 x 2 eval forwards an
    eval, the sample's forwards). Returns the launches of the two training
    calls."""
    import tomllib

    from PIL import Image

    from diffusion_pipe_tpu_torch import safetensors_io, train
    from diffusion_pipe_tpu_torch.config import set_config_defaults
    from diffusion_pipe_tpu_torch.models.keymaps import export_lora_keymap
    from diffusion_pipe_tpu_torch.models.layers import LoraDense
    from diffusion_pipe_tpu_torch.models.qwen_image import QwenImagePipeline
    from diffusion_pipe_tpu_torch.training import trainer

    root = _fresh_dir(SMOKE_DIR / "driver_qwen")
    model_dir = root / "model"
    _write_qwen_vae(model_dir / "vae")
    _write_images(root / "train", DRIVER_IMAGES, SEED)
    _write_images(root / "eval", DRIVER_EVAL_IMAGES, SEED + 1)
    for name, folder in (("dataset", "train"), ("eval", "eval")):
        (root / f"{name}.toml").write_text(
            f'resolutions = [512]\n[[directory]]\npath = "{root}/{folder}"\n')
    text = QWEN_DRIVER_TOML.format(root=root, out="out", model=model_dir, eval_first="true",
                                   sample_steps=DRIVER_SAMPLE_STEPS, init="",
                                   depth=QWEN_DRIVER_DEPTH)
    cfg_path = root / "qwen_image_lora.toml"
    cfg_path.write_text(text)
    argv = ["--config", str(cfg_path)]

    captured = []
    real_init = trainer.init_train_state
    real_te = QwenImagePipeline.get_call_text_encoder_fns

    def init_and_keep(pipeline, *a, **kw):
        state = real_init(pipeline, *a, **kw)
        int8 = [p for p in pipeline.model.parameters() if p.dtype == torch.int8]
        captured.append((pipeline, state, _fingerprint(int8),
                         {n: p.detach().cpu().clone() for n, p in state.trainable.items()}))
        return state

    def run(argv_, extra, steps, lora_before=None):
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        check(train.main(argv_ + extra) == 0, f"train.main {extra} failed")
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = launch_counts()
        pipeline, state, int8_print, lora0 = captured.pop()
        lora0 = lora_before or lora0
        int8 = [p for p in pipeline.model.parameters() if p.dtype == torch.int8]
        out = dict(steps=steps, wall_s=wall_s, launches=counts,
                   peak_memory_bytes=torch.cuda.max_memory_allocated(),
                   int8_weights=len(int8),
                   int8_unchanged=bool(torch.equal(_fingerprint(int8), int8_print)),
                   lora_tensors=len(state.trainable),
                   lora_tensors_still=[n for n, p in state.trainable.items()
                                       if torch.equal(p.cpu(), lora0[n])])
        shape = dict(step=_qwen_expected(pipeline), blocks=pipeline.qi_config.num_layers,
                     linears=sum(int(isinstance(m, LoraDense) and m.kernel_scale is not None)
                                 for m in pipeline.model.modules()),
                     no_gradient=_qwen_no_gradient(pipeline))
        del pipeline, state, int8
        _free()
        return out, shape

    trainer.init_train_state = init_and_keep
    QwenImagePipeline.get_call_text_encoder_fns = lambda self: _qwen_text_stand_in()
    try:
        t0 = time.perf_counter()
        check(train.main(argv + ["--cache_only"]) == 0, "--cache_only failed")
        cache_s = time.perf_counter() - t0
        _free()
        first, shape = run(argv, ["--max_steps", str(DRIVER_STEPS)], DRIVER_STEPS)
        run_dir = next((root / "out").iterdir())
        at_first = torch.load(run_dir / f"global_step{DRIVER_STEPS}" / "state.pt",
                              map_location="cpu", weights_only=True)["trainable"]
        second, _ = run(argv, ["--resume_from_checkpoint", "--max_steps",
                               str(DRIVER_RESUMED_STEPS), "--test_sample", SAMPLE_PROMPT],
                        DRIVER_RESUMED_STEPS - DRIVER_STEPS, at_first)
        del at_first
        export = run_dir / "epoch1"
        reimport_path = root / "qwen_image_reimport.toml"
        reimport_path.write_text(QWEN_DRIVER_TOML.format(
            root=root, out="reimport", model=model_dir, eval_first="false",
            sample_steps=DRIVER_SAMPLE_STEPS, init=f'init_from_existing = "{export}"\n',
            depth=QWEN_DRIVER_DEPTH))
        loaded, keymap = {}, []

        def init_and_copy(pipeline, *a, **kw):
            state = init_and_keep(pipeline, *a, **kw)
            loaded.update({n: p.detach().cpu().clone() for n, p in state.trainable.items()})
            keymap.extend((pipeline.keymap(), pipeline._keymap_config()))
            return state

        trainer.init_train_state = init_and_copy
        run(["--config", str(reimport_path)], ["--max_steps", "1"], 1)
        config = set_config_defaults(tomllib.loads(text))
        uninterrupted, loader_cost = _uninterrupted_loader_state(
            root, DRIVER_RESUMED_STEPS, config, batch_size=1, gas=QWEN_GAS)
    finally:
        trainer.init_train_state = real_init
        QwenImagePipeline.get_call_text_encoder_fns = real_te
    calls = [first, second]
    adapter = safetensors_io.load_file(export / "adapter_model.safetensors")
    factors = {k: v for k, v in adapter.items() if not k.endswith(".alpha")}
    again = export_lora_keymap(loaded, *keymap)
    same = set(again) == set(factors) and all(torch.equal(again[k], factors[k])
                                              for k in factors)

    recs = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    losses = {r["step"]: r["train/loss"] for r in recs if "train/loss" in r}
    evals = [r for r in recs if "eval/eval/loss" in r]
    quantiles = sorted(k for r in evals[:1] for k in r if "loss_quantile_" in k)
    # each call: H1 once a frozen block weight at pre-quantization; GAS
    # micro-steps a step; 9 quantiles x the eval batches (micro batch 1) a
    # forward each per eval (before step 1, at each epoch's end); the
    # second call the sample's forwards
    per_forward = {"flash_fwd": shape["blocks"], "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                   "sr_add": 0, "quant_rows": shape["linears"], "rescale_i32": shape["linears"]}
    prequant = {k: shape["linears"] if k == "quant_rows" else 0 for k in per_forward}
    evals_per_call = [sum(int(r["step"] <= DRIVER_STEPS) for r in evals),
                      sum(int(r["step"] > DRIVER_STEPS) for r in evals)]
    forwards = [9 * DRIVER_EVAL_IMAGES * evals_per_call[0],
                9 * DRIVER_EVAL_IMAGES * evals_per_call[1] + DRIVER_SAMPLE_STEPS]
    expected = [{k: prequant[k] + QWEN_GAS * v * c["steps"] + per_forward[k] * n
                 for k, v in shape["step"].items()} for c, n in zip(calls, forwards)]
    final = run_dir / f"global_step{DRIVER_RESUMED_STEPS}"
    meta = json.loads((final / "client_state.json").read_text())
    saved_step = torch.load(final / "state.pt", map_location="cpu", weights_only=True)["step"]
    step_times = _driver_step_times(run_dir / "metrics.jsonl")
    step_s = sum(step_times) / len(step_times)
    example = Image.open(Path(config["output_dir"]) / "example.png")
    n_lora = first["lora_tensors"]
    emit(phase="driver-qwen", cell="driver-qwen-image", cache_only_s=cache_s, calls=calls,
         expected_launches=expected, evals_per_call=evals_per_call, losses=losses, eval=evals,
         step_s=step_s, step_times_s=step_times, samples_per_s=QWEN_GAS / step_s,
         final_step=saved_step, loader_state=meta.get("custom_loader"),
         uninterrupted_loader_state=uninterrupted, loader_cost=loader_cost,
         adapter_keys=len(adapter), adapter_factors=len(factors),
         reimported_bit_identical=same, example_png=list(example.size))
    check(all(math.isfinite(v) for v in losses.values()), f"non-finite loss: {losses}")
    check(sorted(losses) == list(range(1, DRIVER_RESUMED_STEPS + 1)), f"train/loss steps {losses}")
    check(len(quantiles) == 9 and evals_per_call[0] >= 1, f"evals {evals_per_call}")
    check(saved_step == DRIVER_RESUMED_STEPS and meta["step"] == DRIVER_RESUMED_STEPS,
          f"step counter {saved_step}")
    check(meta.get("custom_loader") == uninterrupted,
          f"loader {meta.get('custom_loader')} against an uninterrupted run's {uninterrupted}")
    check(all(c["int8_unchanged"] and c["int8_weights"] == 14 * QWEN_DRIVER_DEPTH
              for c in calls),
          "int8 weights changed")
    check(all(c["lora_tensors"] == n_lora and all(n.startswith(shape["no_gradient"])
                                                  or n.endswith(QWEN_MAY_STAY)
                                                  for n in c["lora_tensors_still"])
              for c in calls), "LoRA factors did not all move")
    check(len(adapter) == QWEN_ADAPTER_KEYS and len(factors) == 2 * QWEN_ADAPTER_KEYS // 3,
          f"adapter keys {len(adapter)} ({len(factors)} factors), expected {QWEN_ADAPTER_KEYS}")
    check(same, "the adapter loaded through init_from_existing does not export to the file")
    check(example.size == (512, 512), f"example.png is {example.size}")
    for c, want in zip(calls, expected):
        check(c["launches"] == want, f"driver-qwen launches {c['launches']}, expected {want}")
    return {k: sum(c["launches"][k] for c in calls) for k in first["launches"]}


# --- slice 12: FLUX.2 [dev] and AuraFlow v0.3 -----------------------------------

# K1-K3 at FLUX.2 [dev]'s joint sequence (B 1, 512 text + 4,096 image tokens
# at 1024 px, unmasked, 48 heads of 128; the edit's 8,704 with the reference
# image) and AuraFlow's (B 2, 8 registers + 256 T5 rows + 4,096 image tokens,
# 12 heads of 256; also with 200 and 60 of the 256 T5 rows valid, the key
# mask the kernels take though the port's AuraFlow passes none).
# (case, (B, S, H), D, masked keys of each batch element, checked heads,
#  plain version timed)
FLUX2_AURAFLOW_KERNEL_CASES = (
    ("flux2_4608", (1, 4608, 48), 128, False, slice(0, 6), True),
    ("flux2_edit_8704", (1, 8704, 48), 128, False, slice(0, 6), False),
    ("auraflow_4360_d256", (2, 4360, 12), 256, False, None, True),
    ("auraflow_4360_d256_masked", (2, 4360, 12), 256, (slice(208, 264), slice(68, 264)), None,
     True),
)
# H1 / H2 at FLUX.2's widest linear, the single block's linear1 (6,144 ->
# 3 x 6,144 + 2 x 18,432 = 55,296) over the 4,608 joint rows of 1024 px
FLUX2_ROWS = 4608
FLUX2_INT8_H1_CASES = {"forward_linear1": (FLUX2_ROWS, 6144, False),
                       "dgrad_linear1": (FLUX2_ROWS, 55296, True)}
FLUX2_H2_SHAPE = (FLUX2_ROWS, 55296)


# the head-dim-256 kernels by wrapper: (library, a part of the mangled name
# of its D 256 instances, source), all three wgmma kernels
D256_KERNELS = {
    "flash_fwd": ("flash_fwd", "Li256E", "diffusion_pipe_tpu_torch/csrc/flash_fwd.cu"),
    "flash_bwd_dq": ("flash_bwd_dq", "Li256E", "diffusion_pipe_tpu_torch/csrc/flash_bwd_dq.cu"),
    "flash_bwd_dkv": ("flash_bwd_dkv_d256", "flash_bwd_dkv_d256",
                      "diffusion_pipe_tpu_torch/csrc/flash_bwd_dkv_d256.cu"),
}
D256_WGMMA = tuple(D256_KERNELS)


def d256_ptxas(ptxas, dtype="nv_bfloat16"):
    """The ptxas records of the D 256 kernels' instances for `dtype` (a part
    of the mangled name: "nv_bfloat16" or "6__half"), by the wrapper whose
    head-dim-256 calls they serve."""
    out = {}
    for name, (lib, tag, _) in D256_KERNELS.items():
        for mangled, rec in ptxas.get(lib, {}).items():
            if dtype in mangled and tag in mangled:
                out[name] = rec
    return out


def phase_kernels_flux2_auraflow(ptxas):
    """K1-K3 at FLUX.2's and AuraFlow's joint shapes against their plain
    versions (FLUX.2: six of the 48 heads as strided views), K2 / K3
    deterministic on each, a batch element with every key masked at D 256
    (on K3's split path and without it), each timed beside its bound, its
    plain version (but at the edit's 8,704 keys, whose f32 logits take 14.5
    GB a tensor) and SDPA's forward and backward; the ptxas registers,
    spills and wgmma serialization of the D 256 builds (K1 at FwdTile<256>,
    K2 at DqTile<256>, K3's own kernel: no spill and no C7512 in their bf16
    and fp16 instances); H1 / H2 bit for bit and
    timed at linear1's shape by queued_ms (this late in the smoke
    torch.profiler drops kernels from its traces). Returns ({case: K1-K3
    timing}, {kernel: H1 / H2 timing}, D 256 ptxas)."""
    from diffusion_pipe_tpu_torch.ops import flash_attention as fa
    from diffusion_pipe_tpu_torch.ops import int8_quant as iq

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    d256, d256_fp16 = d256_ptxas(ptxas), d256_ptxas(ptxas, "6__half")
    emit(phase="kernels-flux2-auraflow", ptxas_bf16_d256=d256, ptxas_fp16_d256=d256_fp16)
    records = (d256, d256_fp16)
    check(all(set(r) == set(FLASH) for r in records)
          and all(rec.get("spill_stores") == 0 and rec.get("spill_loads") == 0
                  for r in records for rec in r.values())
          and not any(r[name]["wgmma_serialized"] for r in records for name in D256_WGMMA),
          f"the D 256 kernels' ptxas records {records}")
    errors, timings, splits = {}, {}, {}
    for case, (b, s, h), d, masked, heads, _ in FLUX2_AURAFLOW_KERNEL_CASES:
        errors[case] = _check_attention(fa, case, b, s, s, h, d, masked, gen, heads=heads)
        _free()
        splits[case] = _check_bwd_deterministic(fa, case, b, s, s, h, d, gen, masked=masked)
        _free()
    check(_check_all_masked(fa, "auraflow_d256", 2, 4360, 4360, 12, 256, gen) == 1,
          "AuraFlow's shape took K3's query split")
    check(_check_all_masked(fa, "short_kv_d256", 2, 4096, 128, 2, 256, gen) > 1,
          "a short key sequence at D 256 did not take K3's query split")
    _free()
    for case, (b, s, h), d, masked, _, with_plain in FLUX2_AURAFLOW_KERNEL_CASES:
        timing, sdpa_bwd_ms = _time_attention(fa, b, s, s, h, d, gen, with_plain=with_plain,
                                              masked=masked)
        for name, tm in timing.items():
            tm["max_abs_err"] = max(errors[case][k]["err"] for k in ERR_KEYS[name])
        emit(phase="kernels-flux2-auraflow", case=f"timing_{case}", q_shape=[b, s, h, d],
             kv_len=s, masked=bool(masked), timing=timing, sdpa_bwd_ms=sdpa_bwd_ms)
        timings[case] = timing
        _free()
    h1 = {case: _h1_timing(iq, f"flux2_{case}", *shape, gen, queued=True)
          for case, shape in FLUX2_INT8_H1_CASES.items()}
    h2 = _h2_timing(iq, gen, shape=FLUX2_H2_SHAPE, case="flux2_linear1", queued=True)
    _free()
    emit(phase="kernels-flux2-auraflow", k3_query_splits=splits)
    return timings, {"quant_rows": h1, "rescale_i32": h2}, d256


def phase_reference_flux2(device="cuda"):
    """FLUX.2 with 1 + 1 blocks at the published head dim 128, 2 heads, a
    64-wide text input, in the published layout (SwiGLU, no biases, 4 RoPE
    axes at theta 2,000) and in the JAX layout (GELU, biases, txt_norm, 3
    axes): 64 image tokens (an 8 x 8 packed grid) and 40 text rows, 104
    keys, bf16 on the card against f32 on the CPU."""
    from diffusion_pipe_tpu_torch.models.flux2 import (JAX_LAYOUT, Flux2Config,
                                                       Flux2Transformer, flux2_latent_ids)

    for layout in ("published", "jax"):
        over = dict(JAX_LAYOUT, text_dim=64) if layout == "jax" else {}

        def build(dtype, dev, over=over):
            cfg = Flux2Config(**{**dict(hidden_size=256, num_layers=1, num_single_layers=1,
                                        text_dim=64, dtype=dtype, param_dtype=dtype,
                                        lora_rank=4, lora_alpha=4.0, lora_dtype=dtype), **over})
            with torch.device(dev):
                return Flux2Transformer(cfg)

        n_axes = len(over.get("axes_dims_rope", (0,) * 4))
        gen = torch.Generator().manual_seed(SEED + 5)
        x = torch.randn((1, 64, 128), generator=gen)
        txt = torch.randn((1, 40, 64), generator=gen)
        target = torch.randn((1, 64, 128), generator=gen)
        ids = flux2_latent_ids(8, 8, 0, n_axes)

        def inputs(dtype):
            return dict(hidden_states=x.to(dtype), encoder_hidden_states=txt.to(dtype),
                        timestep=torch.tensor([0.4]), img_ids=ids,
                        guidance=torch.tensor([1.0]))

        _reference_family(f"reference-flux2-{layout}", build, inputs, target, device, blocks=2)


def phase_reference_auraflow(device="cuda"):
    """AuraFlow with 1 + 1 blocks at the published head dim 256, 2 heads
    (512 wide), a 64-wide text input: 64 patches of a 16 x 16 latent, 8
    registers and 24 text rows, 96 keys; bf16 on the card against f32 on
    the CPU."""
    from diffusion_pipe_tpu_torch.models.auraflow import AuraFlowConfig, AuraFlowTransformer

    def build(dtype, dev):
        cfg = AuraFlowConfig(hidden_size=512, num_attention_heads=2, joint_attention_dim=64,
                             num_layers=1, num_single_layers=1, pos_embed_max_size=256,
                             dtype=dtype, param_dtype=dtype, lora_rank=4, lora_alpha=4.0,
                             lora_dtype=dtype)
        with torch.device(dev):
            return AuraFlowTransformer(cfg)

    gen = torch.Generator().manual_seed(SEED + 6)
    lat = torch.randn((1, 4, 16, 16), generator=gen)
    txt = torch.randn((1, 24, 64), generator=gen)
    target = torch.randn((1, 4, 16, 16), generator=gen)

    def inputs(dtype):
        return dict(latents=lat.to(dtype), encoder_hidden_states=txt.to(dtype),
                    timestep=torch.tensor([0.4]))

    _reference_family("reference-auraflow", build, inputs, target, device, blocks=2)


FLUX2_LORA_CONFIG = {  # flux2-dev-lora-1024-fp8-int8
    "save_every_n_epochs": 1,
    "model": {"type": "flux2", "dtype": "bfloat16", "transformer_dtype": "float8",
              "int8_matmul": "fwd_bwd", "timestep_sample_method": "logit_normal"},
    "adapter": {"type": "lora", "rank": 32, "alpha": 32, "dropout": 0.0, "dtype": "bfloat16"},
    "optimizer": {"type": "adamw8bit", "lr": 1e-4, "betas": [0.9, 0.99], "weight_decay": 0.01},
    "gradient_clipping": 1.0,
    "activation_checkpointing": True,
}
FLUX2_EDIT_CONFIG = {**FLUX2_LORA_CONFIG, "model": {  # flux2-dev-edit-lora-1024-4-blocks
    **FLUX2_LORA_CONFIG["model"], "num_layers": 2, "num_single_layers": 2}}
AURAFLOW_LORA_CONFIG = {  # auraflow-v0.3-lora-1024: examples/auraflow.toml's trainer
    "save_every_n_epochs": 2,
    "model": {"type": "auraflow", "dtype": "bfloat16", "transformer_dtype": "float8",
              "max_sequence_length": 256, "timestep_sample_method": "logit_normal"},
    "adapter": {"type": "lora", "rank": 32, "alpha": 32, "dropout": 0.0, "dtype": "bfloat16"},
    "optimizer": {"type": "adamw8bit", "lr": 1e-4},
    "gradient_clipping": 1.0,
    "activation_checkpointing": True,
}
FLUX2_TXT, AURAFLOW_TXT = 512, 256
NEW_TIMED_STEPS = 2
# bf16 factors: a lora_a entry may round back to itself in a few steps
NEW_MAY_STAY = (".lora_a",)


def build_flux2_slice(cfg=FLUX2_LORA_CONFIG, device="cuda", latent_hw=128, txt_len=FLUX2_TXT,
                      edit=False):
    """FLUX.2 at the config's size (the published layout, the block weights
    built in fp8 and pre-quantized to int8 one at a time by init_train_state:
    the model never exists in bf16); a batch of one 1024 px latent (and its
    control latents for an edit) with txt_len unmasked text rows."""
    def make_batch(pipeline, gen):
        c = pipeline.f2_config
        batch = {"latents": torch.randn((1, c.latent_channels, latent_hw, latent_hw),
                                        generator=gen, device=device),
                 "text_embeds_0": torch.randn((1, txt_len, c.text_dim), generator=gen,
                                              device=device).to(c.dtype)}
        if edit:
            batch["control_latents"] = torch.randn(batch["latents"].shape, generator=gen,
                                                   device=device)
        return batch

    return _build_family_slice("flux2", cfg, device, make_batch)


def build_auraflow_slice(cfg=AURAFLOW_LORA_CONFIG, device="cuda", latent_hw=128,
                         txt_len=AURAFLOW_TXT, batch_size=2):
    """AuraFlow v0.3 at the config's size; a batch of 1024 px latents with
    txt_len Pile-T5 rows (8 registers go before them: 4,360 keys)."""
    def make_batch(pipeline, gen):
        c = pipeline.af_config
        return {"latents": torch.randn((batch_size, c.in_channels, latent_hw, latent_hw),
                                       generator=gen, device=device),
                "prompt_embeds": torch.randn((batch_size, txt_len, c.joint_attention_dim),
                                             generator=gen, device=device).to(c.dtype)}

    return _build_family_slice("auraflow", cfg, device, make_batch)


def _new_family_expected(pipeline):
    """Launches a training step of a FLUX.2 or AuraFlow LoRA cell: K1 once
    a block (twice under `true`), K2 and K3 once; with int8_matmul H1 and
    H2 once an int8 block linear for the forward, again for the recompute,
    and once more for its dgrad, which autograd skips where the input needs
    no gradient: the first double block's two qkv linears, fed by the
    frozen embedders."""
    from diffusion_pipe_tpu_torch.models.layers import LoraDense

    blocks, c = _model_blocks(pipeline)
    int8 = [n for n, m in pipeline.model.named_modules()
            if isinstance(m, LoraDense) and m.kernel_scale is not None]
    dgrads = (len(int8) - sum(int(n.startswith("double_blocks.0.") and n.endswith("_attn_qkv"))
                              for n in int8)) if c.int8_matmul == "fwd_bwd" else 0
    launches = len(int8) * (2 if c.remat else 1) + dgrads
    return {"flash_fwd": blocks * (2 if c.remat == "full" else 1), "flash_bwd_dq": blocks,
            "flash_bwd_dkv": blocks, "sr_add": 0, "quant_rows": launches,
            "rescale_i32": launches}


def phase_slice_flux2(edit=False):
    """flux2-dev-lora-1024-fp8-int8 (8 + 48 blocks, 31.4 B) or, with edit,
    flux2-dev-edit-lora-1024-4-blocks (2 + 2 blocks, control latents: 8,704
    keys, the output cut to the target's 4,096 rows)."""
    cfg = FLUX2_EDIT_CONFIG if edit else FLUX2_LORA_CONFIG

    def after(pipeline, batch, gen):
        with torch.no_grad():
            inputs, target, _ = pipeline.prepare_inputs(batch, gen)
            out = pipeline.forward(inputs)
        shape = list(out.shape)
        check(shape == list(target.shape) == [1, 4096, 128],
              f"output {shape}, target {list(target.shape)}")
        return dict(sequence=inputs["hidden_states"].shape[1] + FLUX2_TXT, output_shape=shape,
                    gated_mlp=pipeline.f2_config.mlp_gated)

    name = "flux2-dev-edit-lora-1024-4-blocks" if edit else "flux2-dev-lora-1024-fp8-int8"
    counts, _, _ = phase_slice_family(
        "slice-flux2-edit-lora" if edit else "slice-flux2-lora", name,
        lambda: build_flux2_slice(cfg, edit=edit), timed_steps=NEW_TIMED_STEPS,
        expected_fn=_new_family_expected, no_gradient=("none",), after=after,
        may_stay=NEW_MAY_STAY)
    return counts


def phase_slice_auraflow():
    """auraflow-v0.3-lora-1024 (4 + 32 blocks, 6.8 B, 12 heads of 256):
    examples/auraflow.toml's trainer, batch 2 at 1024 px, 4,360 keys a
    sequence, every attention on the D 256 kernels."""
    def after(pipeline, batch, gen):
        with torch.no_grad():
            inputs, target, _ = pipeline.prepare_inputs(batch, gen)
            out = pipeline.forward(inputs)
        c = pipeline.af_config
        check(list(out.shape) == list(target.shape) == [2, 4, 128, 128]
              and c.attention_head_dim == 256, f"output {list(out.shape)}")
        return dict(sequence=64 * 64 + c.num_register_tokens + AURAFLOW_TXT,
                    head_dim=c.attention_head_dim, output_shape=list(out.shape))

    counts, _, _ = phase_slice_family(
        "slice-auraflow-lora", "auraflow-v0.3-lora-1024", build_auraflow_slice,
        timed_steps=NEW_TIMED_STEPS, expected_fn=_new_family_expected, no_gradient=("none",),
        after=after, may_stay=NEW_MAY_STAY)
    return counts


MISTRAL3_LAYERS = (10, 20, 30)  # FLUX.2 [dev]'s stacked hidden states


def _mistral_small_31(dtype, **over):
    """Mistral-Small-3.1-24B's language model (its text_config)."""
    from diffusion_pipe_tpu_torch.models.llm_encoders import CausalLMConfig

    d = dict(vocab=131072, dim=5120, num_layers=40, num_heads=32, num_kv_heads=8, head_dim=128,
             ffn_dim=32768, rope_theta=1e9, rope_local_theta=1e9, rms_eps=1e-5, dtype=dtype,
             param_dtype=dtype)
    d.update(over)
    return CausalLMConfig(**d)


def phase_mistral3():
    """FLUX.2 [dev]'s text function on Mistral-Small-3.1's language model at
    its published size (40 layers, 5,120 wide, 32 / 8 heads, ffn 32,768;
    24 B, 47 GB in bf16) from a seed: LLMTextEncoder's stacked hidden states
    of layers 10, 20 and 30 for 1 x 512 ids, [1, 512, 15,360], timed. The
    same function of a narrow 32-layer Mistral (128 wide) bf16 on the card
    against f32 on the CPU (rel L2 < 3e-2)."""
    from diffusion_pipe_tpu_torch.models.llm_encoders import CausalLM, LLMTextEncoder

    def encoder(cfg, dev, seed):
        with torch.device("meta"):
            lm = CausalLM(cfg)
        lm = lm.to_empty(device=dev)
        lm.init_weights(torch.Generator(device=dev).manual_seed(seed))
        enc = LLMTextEncoder(".", max_length=512, hidden_layers=MISTRAL3_LAYERS,
                             dtype=cfg.dtype, device=dev)
        enc.model = lm.eval().requires_grad_(False)
        return enc

    gen = torch.Generator().manual_seed(SEED + 7)
    narrow = dict(vocab=1024, dim=128, num_layers=32, num_heads=4, num_kv_heads=2, head_dim=32,
                  ffn_dim=256)
    ids = torch.randint(0, 1024, (1, 64), generator=gen)
    mask = torch.ones_like(ids)
    ref_enc = encoder(_mistral_small_31(torch.float32, **narrow), "cpu", SEED)
    card_enc = encoder(_mistral_small_31(torch.bfloat16, **narrow), "cpu", SEED)
    card_enc.model.to("cuda")
    card_enc.device = torch.device("cuda")
    with torch.no_grad():
        ref = ref_enc.hidden_states(ids, mask)
        got = card_enc.hidden_states(ids.cuda(), mask.cuda()).float().cpu()
    narrow_err = _rel(got, ref)
    del ref_enc, card_enc
    _free()

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    enc = encoder(_mistral_small_31(torch.bfloat16), "cuda", SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ids = torch.randint(0, 131072, (1, 512), generator=gen).cuda()
    mask = torch.ones_like(ids)
    with torch.no_grad():
        h = enc.hidden_states(ids, mask)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            h = enc.hidden_states(ids, mask)
        torch.cuda.synchronize()
    encode_ms = (time.perf_counter() - t0) / 3 * 1e3
    params = sum(p.numel() for p in enc.model.parameters())
    finite = bool(torch.isfinite(h).all())
    emit(phase="mistral3", params=params, init_s=init_s, encode_ms=encode_ms,
         shape=list(h.shape), layers=list(MISTRAL3_LAYERS), finite=finite,
         peak_memory_bytes=torch.cuda.max_memory_allocated(), narrow_rel_l2=narrow_err)
    check(list(h.shape) == [1, 512, 15360] and finite, f"Mistral-3 states {list(h.shape)}")
    check(narrow_err < 3e-2, f"narrow Mistral-3 bf16 vs f32: rel L2 {narrow_err}")
    del enc, h
    _free()


def phase_pile_t5():
    """AuraFlow's text function (HFTextEncoder "t5") on a T5 encoder at
    Pile-T5-XL's size (24 layers, 2,048 wide, 32 heads of 64, gated FFN
    5,120, vocab 32,128; 1.3 B) from a seed, bf16, with a word-level
    tokenizer: 2 captions padded to 256 ids, timed; against the same
    weights in f32 on the card (rel L2 < 5e-2 on the valid rows)."""
    from transformers import T5Config, T5EncoderModel

    from diffusion_pipe_tpu_torch.models.text_encoders import HFTextEncoder

    cfg = T5Config(vocab_size=32128, d_model=2048, d_kv=64, d_ff=5120, num_layers=24,
                   num_heads=32, feed_forward_proj="gated-gelu", is_encoder_decoder=False)
    torch.manual_seed(SEED)
    with torch.device("cuda"):
        model = T5EncoderModel(cfg).eval().requires_grad_(False)
    caps = ["a seeded picture, number 0", "a seeded picture, number 1 of the pile"]
    enc = HFTextEncoder("t5", "(seeded)", max_length=AURAFLOW_TXT, device="cuda",
                        dtype=torch.bfloat16)
    enc._tokenizer = _word_tokenizer(" ".join(caps).replace(",", " ").split(), eos="</s>")
    enc._model = model
    with torch.no_grad():
        ref, mask = enc.encode(caps, return_mask=True)
    enc._model = model.to(torch.bfloat16)
    got = enc.encode(caps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        got = enc.encode(caps)
    torch.cuda.synchronize()
    encode_ms = (time.perf_counter() - t0) / 3 * 1e3
    valid = mask.bool()
    err = _rel(got[valid], ref[valid])
    emit(phase="pile-t5", params=sum(p.numel() for p in model.parameters()),
         encode_ms=encode_ms, shape=list(got.shape), valid_ids=mask.sum(1).tolist(),
         rel_l2_vs_f32=err)
    check(list(got.shape) == [2, AURAFLOW_TXT, 2048] and bool(torch.isfinite(got).all()),
          f"Pile-T5 output {list(got.shape)}")
    check(err < 5e-2, f"Pile-T5 bf16 vs f32: rel L2 {err}")
    del model, enc
    _free()


FLUX2_DRIVER_TOML = """# flux2-dev-lora-1024-fp8-int8's trainer through the driver, at 512 px, 2 + 2 blocks
output_dir = "{root}/{out}"
dataset = "{root}/dataset.toml"
eval_datasets = ["{root}/eval.toml"]
epochs = 100
micro_batch_size_per_gpu = 2
gradient_accumulation_steps = 1
gradient_clipping = 1.0
save_every_n_epochs = 1
eval_before_first_step = {eval_first}
activation_checkpointing = true
sample_steps = {sample_steps}

[model]
type = "flux2"
dtype = "bfloat16"
transformer_dtype = "float8"
num_layers = 2
num_single_layers = 2
vae_path = "{vae}"

[adapter]
type = "lora"
rank = 32
{init}
[optimizer]
type = "adamw8bit"
lr = 1e-4
"""
AURAFLOW_DRIVER_TOML = FLUX2_DRIVER_TOML.replace(
    "flux2-dev-lora-1024-fp8-int8's trainer", "examples/auraflow.toml's trainer").replace(
    "2 + 2 blocks", "1 + 2 blocks").replace('type = "flux2"', 'type = "auraflow"').replace(
    "num_layers = 2\n", "num_layers = 1\nmax_sequence_length = 256\n")


def _flux2_text_stand_in():
    """Seeded text rows [512, 15,360]: three stacked Mistral-3 layers."""
    from diffusion_pipe_tpu_torch.models.text_encoders import seeded_draws

    return [lambda caps: {"text_embeds_0": seeded_draws(caps, "mistral3", (FLUX2_TXT, 15360))}]


def _auraflow_text_stand_in():
    """Seeded Pile-T5 rows [256, 2,048]."""
    from diffusion_pipe_tpu_torch.models.text_encoders import seeded_draws

    return [lambda caps: {"prompt_embeds": seeded_draws(caps, "pile-t5", (AURAFLOW_TXT, 2048))}]


def _write_flux2_vae(folder):
    """A seeded full-width FLUX.2-shaped VAE (32 latent channels, no scale
    or shift) in the diffusers layout, with batch-norm statistics over the
    128 packed channels and config.json's batch_norm_eps."""
    from diffusion_pipe_tpu_torch import safetensors_io
    from diffusion_pipe_tpu_torch.models.autoencoder_kl import (AutoencoderKL, VAEConfig,
                                                                diffusers_vae_state_dict)

    folder.mkdir(parents=True)
    vae = AutoencoderKL(VAEConfig(latent_channels=32, scaling_factor=1.0, shift_factor=0.0))
    gen = torch.Generator().manual_seed(SEED)
    vae.init_weights(gen)
    sd = diffusers_vae_state_dict(vae)
    sd["bn.running_mean"] = torch.randn(128, generator=gen) * 0.1
    sd["bn.running_var"] = torch.rand(128, generator=gen) + 0.5
    safetensors_io.save_file(sd, folder / "diffusion_pytorch_model.safetensors")
    (folder / "config.json").write_text(json.dumps({"batch_norm_eps": 1e-4}))
    return folder


def _write_sdxl_vae(folder):
    """A seeded full-width SDXL VAE (AuraFlow's) in the diffusers layout."""
    from diffusion_pipe_tpu_torch import safetensors_io
    from diffusion_pipe_tpu_torch.models.autoencoder_kl import (AutoencoderKL, VAEConfig,
                                                                diffusers_vae_state_dict)

    folder.mkdir(parents=True)
    vae = AutoencoderKL(VAEConfig.sdxl())
    vae.init_weights(torch.Generator().manual_seed(SEED))
    safetensors_io.save_file(diffusers_vae_state_dict(vae),
                             folder / "diffusion_pytorch_model.safetensors")
    return folder


# --- slice 15: Lumina-Image-2.0, Z-Image and OmniGen2 --------------------------

# K1-K3 at the Lumina 2 family's joint sequences at 1024 px: 256 caption rows
# (60 and 200 of them valid, the key mask) then 4,096 image tokens; Lumina 2
# at 24 heads of 96 (B 2), its noise refiner over the 4,096 image tokens
# unmasked, OmniGen2 at 21 heads of 120 (B 1). D 96 and 120 run the D 128
# tiles with the columns past D zero-filled by TMA.
# (case, (B, S, H), D, masked keys of each batch element, checked heads)
LUMINA_KERNEL_CASES = (
    ("lumina2_4352_d96_masked", (2, 4352, 24), 96, (slice(60, 256), slice(200, 256)),
     slice(0, 6)),
    ("lumina2_refiner_4096_d96", (2, 4096, 24), 96, False, slice(0, 6)),
    ("omnigen2_4352_d120_masked", (1, 4352, 21), 120, (slice(60, 256),), slice(0, 6)),
)
# the head dims the D 128 tiles run with TMA's zero fill past D
PADDED_HEAD_DIMS = (96, 120)
LUMINA_TXT = 256
LUMINA_VALID = (60, 200)  # valid caption rows of each example's 256 in the Lumina cells


def padded_ptxas(ptxas, dtype="nv_bfloat16"):
    """The ptxas records of the D 128 instances that run D 96 and 120
    (kPad), by the wrapper whose calls they serve."""
    return {name: rec for name in FLASH for mangled, rec in ptxas.get(name, {}).items()
            if dtype in mangled and "Li128ELb1E" in mangled}


def phase_kernels_lumina(ptxas):
    """K1-K3 at D 96 and 120: the ptxas records of their instances (no spill,
    no C7512, bf16 and fp16); at each Lumina shape against the plain
    versions (six heads as strided views), K2 / K3 deterministic; bf16 and
    fp16 at a ragged S of 1,000 (no multiple of 64 or 128), masked and not;
    inputs that are column slices of NaN-filled 128-wide buffers, at the
    ragged shape and at a short key sequence (K3's query split); a batch
    element with every key masked on both of K3's paths; then each Lumina
    shape timed beside its bound (the true D), its plain version and SDPA's
    forward and backward. Returns ({case: K1-K3 timing}, the ptxas records)."""
    from diffusion_pipe_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    records = (padded_ptxas(ptxas), padded_ptxas(ptxas, "6__half"))
    emit(phase="kernels-lumina", ptxas_bf16_d96_d120=records[0],
         ptxas_fp16_d96_d120=records[1])
    check(all(set(r) == set(FLASH) for r in records)
          and all(rec.get("spill_stores") == 0 and rec.get("spill_loads") == 0
                  and not rec["wgmma_serialized"] for r in records for rec in r.values()),
          f"the D 96 / 120 kernels' ptxas records {records}")
    errors, splits = {}, {}
    for case, (b, s, h), d, masked, heads in LUMINA_KERNEL_CASES:
        errors[case] = _check_attention(fa, case, b, s, s, h, d, masked, gen, heads=heads)
        _free()
        splits[case] = _check_bwd_deterministic(fa, case, b, s, s, h, d, gen, masked=masked)
        _free()
    for d in PADDED_HEAD_DIMS:
        for dtype in (torch.bfloat16, torch.float16):
            name = str(dtype).removeprefix("torch.")
            for masked in (False, (slice(900, 1000), slice(333, 1000))):
                _check_attention(fa, f"ragged_1000_d{d}_{name}{'_masked' if masked else ''}",
                                 2, 1000, 1000, 24, d, masked, gen, dtype=dtype)
            _check_attention(fa, f"nan_guard_ragged_d{d}_{name}", 2, 1000, 1000, 24, d,
                             (slice(900, 1000), slice(333, 1000)), gen, dtype=dtype, guard=True)
            _check_attention(fa, f"nan_guard_short_kv_d{d}_{name}", 2, 4096, 200, 2, d, False,
                             gen, dtype=dtype, guard=True)
            check(fa.flash_bwd_dkv_cuda.last_splits > 1,
                  "the short key sequence did not take K3's query split")
        check(_check_all_masked(fa, f"d{d}", 2, 1000, 1000, 24, d, gen) == 1,
              f"the all-masked D {d} case took K3's query split")
        check(_check_all_masked(fa, f"short_kv_d{d}", 2, 4096, 128, 2, d, gen) > 1,
              f"a short key sequence at D {d} did not take K3's query split")
        _free()
    timings = {}
    for case, (b, s, h), d, masked, _ in LUMINA_KERNEL_CASES:
        timing, sdpa_bwd_ms = _time_attention(fa, b, s, s, h, d, gen, masked=masked)
        for name, tm in timing.items():
            tm["max_abs_err"] = max(errors[case][k]["err"] for k in ERR_KEYS[name])
        emit(phase="kernels-lumina", case=f"timing_{case}", q_shape=[b, s, h, d], kv_len=s,
             masked=bool(masked), timing=timing, sdpa_bwd_ms=sdpa_bwd_ms)
        timings[case] = timing
        _free()
    emit(phase="kernels-lumina", k3_query_splits=splits)
    return timings, records[0]


def _lumina_reference_config(family, dtype):
    """1 main block and 1 + 1 refiners at the family's full width and head
    dim (Lumina 2: 2,304, 24 heads of 96; Z-Image: 3,840, 30 of 128, pad
    tokens; OmniGen2: 2,520, 21 of 120), LoRA rank 4."""
    from diffusion_pipe_tpu_torch.models import omnigen2, z_image
    from diffusion_pipe_tpu_torch.models.lumina_2 import Lumina2Config

    fam = {"lumina_2": dict(time_scale=1.0),
           "z_image": dict(z_image.PUBLISHED, time_scale=1000.0, rope_cap_offset=1,
                           pad_tokens_multiple=32),
           "omnigen2": dict(omnigen2.PUBLISHED, time_scale=1000.0)}[family]
    return Lumina2Config(**{**fam, "num_layers": 1, "num_refiner_layers": 1, "dtype": dtype,
                            "param_dtype": dtype, "lora_rank": 4, "lora_alpha": 4.0,
                            "lora_dtype": dtype})


def phase_reference_lumina(family, device="cuda"):
    """A family's transformer at 1 + 1 + 1 blocks (_lumina_reference_config):
    a 16 x 20 latent (80 image tokens; Z-Image pads them to 96) and 24
    caption rows, 18 and 24 of them valid, B 2; bf16 on the card against
    f32 on the CPU."""
    from diffusion_pipe_tpu_torch.models.lumina_2 import Lumina2Transformer

    def build(dtype, dev):
        with torch.device(dev):
            return Lumina2Transformer(_lumina_reference_config(family, dtype))

    cfg = _lumina_reference_config(family, torch.float32)
    gen = torch.Generator().manual_seed(SEED + 7)
    lat = torch.randn((2, 16, 16, 20), generator=gen)
    cap = torch.randn((2, 24, cfg.cap_dim), generator=gen)
    mask = torch.ones((2, 24), dtype=torch.int32)
    mask[0, 18:] = 0
    target = torch.randn((2, 16, 16, 20), generator=gen)

    def inputs(dtype):
        return dict(x=lat.to(dtype), t=torch.tensor([0.3, 0.8]), cap_feats=cap.to(dtype),
                    cap_mask=mask)

    name = {"lumina_2": "lumina2", "z_image": "zimage", "omnigen2": "omnigen2"}[family]
    _reference_family(f"reference-{name}", build, inputs, target, device, blocks=3)


LUMINA2_LOKR_CONFIG = {  # lumina2-lokr-1024: examples/lumina_2.toml's trainer
    "save_every_n_epochs": 2,
    "model": {"type": "lumina_2", "dtype": "bfloat16", "lumina_shift": True},
    # alpha = rank, as the config loader sets it
    "adapter": {"type": "lokr", "rank": 16, "alpha": 16, "decompose_factor": -1},
    "optimizer": {"type": "genericoptim", "lr": 1e-4, "second_moment_type": "sn", "rank": 128,
                  "proj_type": "svd", "update_proj_gap": 200},
    "gradient_clipping": 1.0,
    "activation_checkpointing": True,
}
OMNIGEN2_DEPTH = 4  # main blocks of the full-width omnigen2-lora-1024 cell
OMNIGEN2_LORA_CONFIG = {  # omnigen2-lora-1024
    "save_every_n_epochs": 1,
    "model": {"type": "omnigen2", "dtype": "bfloat16", "num_layers": OMNIGEN2_DEPTH},
    "adapter": {"type": "lora", "rank": 32, "alpha": 32, "dropout": 0.0},
    "optimizer": {"type": "adamw8bit", "lr": 1e-4},
    "gradient_clipping": 1.0,
    "activation_checkpointing": True,
}


def build_lumina_slice(cfg=LUMINA2_LOKR_CONFIG, device="cuda", latent_hw=128,
                       txt_len=LUMINA_TXT, valid=LUMINA_VALID):
    """A Lumina 2 family model at the config's size; a batch of len(valid)
    1024 px latents with txt_len caption rows, `valid` of each example
    unmasked (zero rows after), under the family's names."""
    def make_batch(pipeline, gen):
        c = pipeline.lumina_config
        b = len(valid)
        mask = torch.zeros((b, txt_len), dtype=torch.int32, device=device)
        for i, n in enumerate(valid):
            mask[i, :n] = 1
        feats = torch.randn((b, txt_len, c.cap_dim), generator=gen, device=device)
        feats_key, mask_key = pipeline.text_keys
        return {"latents": torch.randn((b, c.in_channels, latent_hw, latent_hw), generator=gen,
                                       device=device),
                feats_key: (feats * mask[..., None]).to(c.dtype), mask_key: mask}

    return _build_family_slice(cfg["model"]["type"], cfg, device, make_batch)


def phase_slice_lumina(family="lumina_2"):
    """lumina2-lokr-1024 (Lumina-Image-2.0 at its published size, 26 + 2 +
    2 blocks, 24 heads of 96, 1.97 B; examples/lumina_2.toml's LoKr and
    genericoptim, `true`; batch 2 at 1024 px with 60 and 200 of 256 caption
    rows valid) or omnigen2-lora-1024 (OmniGen2 at full width, 4 + 2 + 2
    blocks, 21 heads of 120; LoRA r32, adamw8bit, batch 1 with 200 valid)."""
    lumina = family == "lumina_2"
    cfg = LUMINA2_LOKR_CONFIG if lumina else OMNIGEN2_LORA_CONFIG

    def after(pipeline, batch, gen):
        with torch.no_grad():
            inputs, target, _ = pipeline.prepare_inputs(batch, gen)
            out = pipeline.forward(inputs)
        c = pipeline.lumina_config
        check(list(out.shape) == list(target.shape) == [len(batch["latents"]), 16, 128, 128]
              and c.head_dim == (96 if lumina else 120), f"output {list(out.shape)}")
        return dict(sequence=64 * 64 + LUMINA_TXT, head_dim=c.head_dim,
                    output_shape=list(out.shape), adapter=cfg["adapter"]["type"])

    counts, _, _ = phase_slice_family(
        "slice-lumina2-lokr" if lumina else "slice-omnigen2-lora",
        "lumina2-lokr-1024" if lumina else "omnigen2-lora-1024",
        lambda: build_lumina_slice(cfg, valid=LUMINA_VALID if lumina else (200,)),
        timed_steps=NEW_TIMED_STEPS, expected_fn=_flash_step, no_gradient=("none",),
        after=after, may_stay=() if lumina else NEW_MAY_STAY)
    return counts


LUMINA2_DRIVER_TOML = """# examples/lumina_2.toml's trainer through the driver, at 512 px, 2 main blocks
output_dir = "{root}/{out}"
dataset = "{root}/dataset.toml"
eval_datasets = ["{root}/eval.toml"]
epochs = 100
micro_batch_size_per_gpu = 2
gradient_accumulation_steps = 1
gradient_clipping = 1.0
save_every_n_epochs = 1
eval_before_first_step = {eval_first}
activation_checkpointing = true
sample_steps = {sample_steps}

[model]
type = "lumina_2"
dtype = "bfloat16"
lumina_shift = true
num_layers = 2
vae_path = "{vae}"

[adapter]
type = "lokr"
rank = 16
decompose_factor = -1
{init}
[optimizer]
type = "genericoptim"
lr = 1e-4
second_moment_type = "sn"
rank = 128
proj_type = "svd"
update_proj_gap = 200
"""
LUMINA_DRIVER_TOMLS = {
    "lumina_2": LUMINA2_DRIVER_TOML,
    # Z-Image at its published width (head dim 128, pad tokens, RoPE (32,
    # 48, 48)), 2 main blocks, with FLUX.2's driver settings (LoRA r32,
    # adamw8bit, `true`)
    "z_image": FLUX2_DRIVER_TOML.replace(
        "flux2-dev-lora-1024-fp8-int8's trainer", "Z-Image LoRA").replace(
        "2 + 2 blocks", "2 main blocks").replace('type = "flux2"', 'type = "z_image"').replace(
        'transformer_dtype = "float8"\n', "").replace("num_single_layers = 2\n", ""),
}


def _lumina_text_stand_in(family):
    """Seeded caption rows at the family's cached shape (Lumina 2: Gemma-2's
    [256, 2,304]; Z-Image: Qwen3-4B's [512, 2,560]) with the first
    min(len(caption) + 1, rows) valid and the mask: the `_tiny` hook's rule
    at full size."""
    from diffusion_pipe_tpu_torch.models import get_model_class
    from diffusion_pipe_tpu_torch.models.text_encoders import seeded_draws

    rows, width = {"lumina_2": (256, 2304), "z_image": (512, 2560)}[family]
    feats_key, mask_key = get_model_class(family).text_keys

    def fn(caps):
        emb = seeded_draws(caps, family, (rows, width))
        mask = torch.zeros((len(caps), rows), dtype=torch.int32)
        for i, c in enumerate(caps):
            mask[i, :min(len(c) + 1, rows)] = 1
        return {feats_key: emb * mask[..., None], mask_key: mask}

    return [fn]


# --- slice 16: HiDream-I1 ------------------------------------------------------

# K1-K3 at HiDream-I1's joint sequence at 1024 px: 4,096 image rows, the
# text carry of 128 T5 rows and 128 Llama rows, and the block's own 128
# Llama rows (4,480), 20 heads of 128, B 1, unmasked
# (case, (B, S, H), D, masked keys, checked heads)
HIDREAM_KERNEL_CASES = (("hidream_4480", (1, 4480, 20), 128, False, None),)
HIDREAM_T5, HIDREAM_LLAMA_LAYERS, HIDREAM_LLAMA_ROWS = 128, 32, 128


def phase_kernels_hidream():
    """K1-K3 at HiDream's joint shape against their plain versions (every
    head: the plain K1's f32 logits are 1.6 GB), K2 / K3 deterministic,
    timed beside the bound, the plain versions and SDPA's forward and
    backward. Returns {case: K1-K3 timing}."""
    from diffusion_pipe_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    timings = {}
    for case, (b, s, h), d, masked, heads in HIDREAM_KERNEL_CASES:
        errors = _check_attention(fa, case, b, s, s, h, d, masked, gen, heads=heads)
        _free()
        splits = _check_bwd_deterministic(fa, case, b, s, s, h, d, gen, masked=masked)
        _free()
        timing, sdpa_bwd_ms = _time_attention(fa, b, s, s, h, d, gen, masked=masked)
        for name, tm in timing.items():
            tm["max_abs_err"] = max(errors[k]["err"] for k in ERR_KEYS[name])
        emit(phase="kernels-hidream", case=f"timing_{case}", q_shape=[b, s, h, d], kv_len=s,
             masked=bool(masked), timing=timing, sdpa_bwd_ms=sdpa_bwd_ms,
             k3_query_splits=splits)
        timings[case] = timing
        _free()
    return timings


def _hidream_reference_config(dtype):
    """1 + 1 blocks at 256 wide: 2 heads of 128 (RoPE (64, 32, 32)), 2
    routed experts of 512 with top 2 and a shared one of 256, T5 64 wide,
    Llama 48, pooled 32; LoRA rank 4 on every block linear, the experts'
    included."""
    from diffusion_pipe_tpu_torch.models.hidream import HiDreamConfig

    return HiDreamConfig(hidden_size=256, num_heads=2, num_double_layers=1, num_single_layers=1,
                         num_routed_experts=2, num_activated_experts=2, expert_hidden=512,
                         shared_hidden=256, t5_dim=64, llama_dim=48, pooled_dim=32,
                         dtype=dtype, param_dtype=dtype, lora_rank=4, lora_alpha=4.0,
                         lora_dtype=dtype)


def phase_reference_hidream(device="cuda"):
    """The narrow HiDream (_hidream_reference_config) on a 16 x 16 latent (64
    image tokens), 24 T5 rows and 3 cached Llama layers of 16 rows (the
    published carry: 64 + 24 + 16 + 16 = 120 keys), bf16 on the card
    against f32 on the CPU."""
    from diffusion_pipe_tpu_torch.models.flux import latent_image_ids
    from diffusion_pipe_tpu_torch.models.hidream import HiDreamTransformer

    def build(dtype, dev):
        with torch.device(dev):
            return HiDreamTransformer(_hidream_reference_config(dtype))

    gen = torch.Generator().manual_seed(SEED + 16)
    x = torch.randn((1, 64, 64), generator=gen)
    t5 = torch.randn((1, 24, 64), generator=gen)
    llama = torch.randn((1, 3, 16, 48), generator=gen)
    pooled = torch.randn((1, 32), generator=gen)
    target = torch.randn((1, 64, 64), generator=gen)

    def inputs(dtype):
        return dict(x_tokens=x.to(dtype), img_ids=latent_image_ids(8, 8),
                    timesteps=torch.tensor([400.0]), pooled=pooled.to(dtype),
                    t5_embeds=t5.to(dtype), llama_embeds=llama.to(dtype))

    _reference_family("reference-hidream", build, inputs, target, device, blocks=2)


# Llama-3.1-8B's config.json, as CausalLMConfig.from_hf_config reads it
LLAMA31_8B = {"model_type": "llama", "vocab_size": 128256, "hidden_size": 4096,
              "num_hidden_layers": 32, "num_attention_heads": 32, "num_key_value_heads": 8,
              "intermediate_size": 14336, "rope_theta": 500000.0, "rms_norm_eps": 1e-5,
              "rope_scaling": {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                               "high_freq_factor": 4.0,
                               "original_max_position_embeddings": 8192}}
# fp8 e4m3 storage rounds each weight to 3 mantissa bits, and random weights
# carry the rounding through all 32 layers: the stacked states' relative L2
# against bf16 must stay below this
LLAMA31_FP8_REL_L2 = 0.3


def _to_fp8_storage(lm):
    """llama3_4bit: the 2-D weights but the embedding stored in float8, as
    load_causal_lm stores a text_encoder_fp8 checkpoint."""
    from torch import nn

    from diffusion_pipe_tpu_torch.models.text_encoders import cast_te_params_fp8

    with torch.no_grad():
        for name, w in cast_te_params_fp8(dict(lm.named_parameters())).items():
            if w.dtype == torch.float8_e4m3fn:
                owner, leaf = name.rsplit(".", 1)
                setattr(lm.get_submodule(owner), leaf, nn.Parameter(w, requires_grad=False))
    return lm


def phase_llama31():
    """HiDream's Llama text function on Llama-3.1-8B at its published size
    (LLAMA31_8B through from_hf_config: 32 layers, 4,096 wide, 32 heads over
    8, FFN 14,336, vocab 128,256, theta 500,000, llama3 scaling (8, 1, 4,
    8,192)) from a seed, bf16: LLMTextEncoder's stacked states of every
    layer for 2 x 128 ids (the second padded after 77), [2, 32, 128, 4,096],
    timed with the peak; then the same weights in fp8 storage
    (llama3_4bit), timed and held against bf16 (relative L2 on the valid
    rows below LLAMA31_FP8_REL_L2). A narrow 32-layer copy (256 wide) bf16
    on the card against f32 on the CPU (rel L2 < 3e-2)."""
    from diffusion_pipe_tpu_torch.models.llm_encoders import (CausalLM, CausalLMConfig,
                                                              LLMTextEncoder)

    def encoder(cfg, dev, seed):
        with torch.device("meta"):
            lm = CausalLM(cfg)
        lm = lm.to_empty(device=dev)
        lm.init_weights(torch.Generator(device=dev).manual_seed(seed))
        enc = LLMTextEncoder(".", max_length=HIDREAM_LLAMA_ROWS, stack_layers=True,
                             dtype=cfg.dtype, device=dev)
        enc.model = lm.eval().requires_grad_(False)
        return enc

    def timed(enc, ids, mask):
        with torch.no_grad():
            h = enc.hidden_states(ids, mask)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                h = enc.hidden_states(ids, mask)
            torch.cuda.synchronize()
        return h, (time.perf_counter() - t0) / 3 * 1e3

    full = CausalLMConfig.from_hf_config(LLAMA31_8B, dtype=torch.bfloat16)
    check(full.rope_llama3 == (8.0, 1.0, 4.0, 8192.0), f"llama3 scaling {full.rope_llama3}")
    gen = torch.Generator().manual_seed(SEED + 31)
    narrow = dict(vocab=1024, dim=256, num_heads=4, num_kv_heads=1, ffn_dim=512)
    ids = torch.randint(0, 1024, (1, 64), generator=gen)
    mask = torch.ones_like(ids)
    ref_enc = encoder(dataclasses.replace(full, dtype=torch.float32, param_dtype=torch.float32,
                                          **narrow), "cpu", SEED)
    card_enc = encoder(dataclasses.replace(full, **narrow), "cpu", SEED)
    card_enc.model.to("cuda")
    with torch.no_grad():
        ref = ref_enc.hidden_states(ids, mask)
        got = card_enc.hidden_states(ids.cuda(), mask.cuda()).float().cpu()
    narrow_err = _rel(got, ref)
    del ref_enc, card_enc
    _free()

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    enc = encoder(full, "cuda", SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ids = torch.randint(0, full.vocab, (2, HIDREAM_LLAMA_ROWS), generator=gen).cuda()
    mask = torch.ones_like(ids)
    mask[1, 77:] = 0
    h, encode_ms = timed(enc, ids, mask)
    peak = torch.cuda.max_memory_allocated()
    params = sum(p.numel() for p in enc.model.parameters())
    torch.cuda.reset_peak_memory_stats()
    _to_fp8_storage(enc.model)
    _free()
    h8, fp8_encode_ms = timed(enc, ids, mask)
    valid = mask.bool()[:, None].expand(-1, full.num_layers, -1)
    fp8_err = _rel(h8[valid].float(), h[valid].float())
    fp8_bytes = sum(p.numel() * p.element_size() for p in enc.model.parameters())
    finite = bool(torch.isfinite(h).all() and torch.isfinite(h8).all())
    emit(phase="llama31", params=params, init_s=init_s, encode_ms=encode_ms,
         fp8_encode_ms=fp8_encode_ms, shape=list(h.shape), finite=finite,
         peak_memory_bytes=peak, fp8_peak_memory_bytes=torch.cuda.max_memory_allocated(),
         fp8_weight_bytes=fp8_bytes, fp8_rel_l2=fp8_err, fp8_rel_l2_bound=LLAMA31_FP8_REL_L2,
         narrow_rel_l2=narrow_err)
    check(list(h.shape) == [2, 32, HIDREAM_LLAMA_ROWS, 4096] and finite,
          f"Llama-3.1 states {list(h.shape)}")
    check(narrow_err < 3e-2, f"narrow Llama-3.1 bf16 vs f32: rel L2 {narrow_err}")
    check(fp8_err < LLAMA31_FP8_REL_L2, f"Llama-3.1 fp8 vs bf16: rel L2 {fp8_err}")
    del enc, h, h8
    _free()


HIDREAM_LORA_CONFIG = {  # hidream-i1-lora-1024
    "save_every_n_epochs": 1,
    "model": {"type": "hidream", "dtype": "bfloat16"},
    "adapter": {"type": "lora", "rank": 32, "alpha": 32, "dropout": 0.0},
    "optimizer": {"type": "adamw8bit", "lr": 1e-4},
    "gradient_clipping": 1.0,
    "activation_checkpointing": True,
}


def build_hidream_slice(cfg=HIDREAM_LORA_CONFIG, device="cuda", latent_hw=128,
                        t5_len=HIDREAM_T5, llama_layers=HIDREAM_LLAMA_LAYERS,
                        llama_len=HIDREAM_LLAMA_ROWS, batch_size=1):
    """HiDream at the config's size; a batch of latents and the cached text:
    T5 rows [t5_len, 4,096], the pooled CLIP pair [2,048] and every Llama
    layer's rows [llama_layers, llama_len, 4,096]."""
    def make_batch(pipeline, gen):
        c = pipeline.hd_config

        def r(*shape):
            return torch.randn((batch_size, *shape), generator=gen, device=device)

        return {"latents": r(c.in_channels // 4, latent_hw, latent_hw),
                "t5_embeds": r(t5_len, c.t5_dim).to(c.dtype), "pooled": r(c.pooled_dim).to(c.dtype),
                "llama_embeds": r(llama_layers, llama_len, c.llama_dim).to(c.dtype)}

    return _build_family_slice("hidream", cfg, device, make_batch)


def _hidream_rows(c, image_rows, t5_len=HIDREAM_T5, llama_len=HIDREAM_LLAMA_ROWS):
    """The joint sequence of every block: the image rows, the text carry
    (T5 and, published, the last block's Llama rows) and the block's Llama
    rows."""
    return image_rows + t5_len + llama_len * (2 if c.published_carry else 1)


def phase_slice_hidream():
    """hidream-i1-lora-1024: HiDream-I1 at its published size (16 + 32
    blocks, 2,560 wide, 4 experts top 2 and a shared one; 17.1 B) in bf16,
    LoRA r32 on every block linear (the experts' included), adamw8bit,
    `true`, batch 1 at 1024 px: 4,096 image rows, 128 T5 rows, 32 cached
    Llama layers of 128 rows, a joint sequence of 4,480. 96 / 48 / 48
    launches a step; the output and target [1, 4,096, 64]."""
    def after(pipeline, batch, gen):
        with torch.no_grad():
            inputs, target, _ = pipeline.prepare_inputs(batch, gen)
            out = pipeline.forward(inputs)
        c = pipeline.hd_config
        rows = _hidream_rows(c, 64 * 64)
        check(list(out.shape) == list(target.shape) == [1, 64 * 64, 64] and rows == 4480
              and c.head_dim == 128, f"output {list(out.shape)}, {rows} rows")
        return dict(sequence=rows, head_dim=c.head_dim, output_shape=list(out.shape),
                    experts=c.num_routed_experts, expert_hidden=c.ff_hidden,
                    shared_hidden=c.shared_ff_hidden)

    counts, _, _ = phase_slice_family(
        "slice-hidream-lora", "hidream-i1-lora-1024", build_hidream_slice,
        timed_steps=NEW_TIMED_STEPS, expected_fn=_flash_step, no_gradient=("none",),
        after=after, may_stay=NEW_MAY_STAY)
    return counts


HIDREAM_DRIVER_TOML = FLUX2_DRIVER_TOML.replace(
    "flux2-dev-lora-1024-fp8-int8's trainer", "hidream-i1-lora-1024's trainer").replace(
    "2 + 2 blocks", "1 + 2 blocks, fp8 storage").replace(
    'type = "flux2"', 'type = "hidream"').replace(
    "num_layers = 2\nnum_single_layers = 2\n", "num_double_layers = 1\nnum_single_layers = 2\n")


def _hidream_text_stand_in():
    """Seeded text at HiDream's cached shapes: T5 rows [128, 4,096], the
    pooled CLIP pair [2,048] and Llama-3.1's 32 layers [32, 128, 4,096]."""
    from diffusion_pipe_tpu_torch.models.text_encoders import seeded_draws

    return [lambda caps: {"pooled": seeded_draws(caps, "pooled", (2048,))},
            lambda caps: {"t5_embeds": seeded_draws(caps, "t5", (HIDREAM_T5, 4096))},
            lambda caps: {"llama_embeds": seeded_draws(
                caps, "llama", (HIDREAM_LLAMA_LAYERS, HIDREAM_LLAMA_ROWS, 4096))}]


# --- slice 17: Cosmos-Predict2, Anima and Cosmos-1 -------------------------------

# K1-K3 at the MiniTrainDIT's attention in its two cells, heads of 128,
# unmasked: Predict2 / Anima at 1024 px (B 2, 4,096 image rows, 16 heads) and
# its cross-attention to 512 T5 rows; Cosmos-1 at 960 x 704 (B 1, 2,640 rows,
# a ragged last tile, 32 heads) and its cross-attention to 512 rows
# (case, (B, Sq, Skv, H), D)
COSMOS_KERNEL_CASES = (
    ("predict2_self_4096", (2, 4096, 4096, 16), 128),
    ("predict2_cross_4096x512", (2, 4096, 512, 16), 128),
    ("cosmos1_self_2640", (1, 2640, 2640, 32), 128),
    ("cosmos1_cross_2640x512", (1, 2640, 512, 32), 128),
)
COSMOS_TXT = 512
ANIMA_T5_VALID, ANIMA_LLM_VALID = 60, 77  # valid T5 ids and Qwen rows of each 512
COSMOS_T5_VALID = 60  # Cosmos-1's valid T5 rows (the rest zeroed, as cached)


def phase_kernels_cosmos():
    """K1-K3 at the four Cosmos shapes against their plain versions (every
    head), K2 / K3 deterministic at Cosmos-1's ragged 2,640 rows, each
    timed beside its bound, its plain version and SDPA's forward and
    backward. Returns {case: K1-K3 timing}."""
    from diffusion_pipe_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    timings = {}
    for case, (b, sq, skv, h), d in COSMOS_KERNEL_CASES:
        errors = _check_attention(fa, case, b, sq, skv, h, d, False, gen)
        _free()
        splits = None
        if case == "cosmos1_self_2640":
            splits = _check_bwd_deterministic(fa, case, b, sq, skv, h, d, gen)
            _free()
        timing, sdpa_bwd_ms = _time_attention(fa, b, sq, skv, h, d, gen)
        for name, tm in timing.items():
            tm["max_abs_err"] = max(errors[k]["err"] for k in ERR_KEYS[name])
        emit(phase="kernels-cosmos", case=f"timing_{case}", q_shape=[b, sq, h, d], kv_len=skv,
             masked=False, timing=timing, sdpa_bwd_ms=sdpa_bwd_ms, k3_query_splits=splits)
        timings[case] = timing
        _free()
    return timings


def _cosmos_reference_config(dtype):
    """2 blocks at 256 wide: 2 heads of 128, adaLN-LoRA 32, context 64, LoRA
    rank 4 on every block linear, the modulations' included."""
    from diffusion_pipe_tpu_torch.models.cosmos_predict2_model import CosmosPredict2Config

    return CosmosPredict2Config(model_channels=256, num_blocks=2, num_heads=2,
                                crossattn_emb_channels=64, adaln_lora_dim=32, dtype=dtype,
                                param_dtype=dtype, lora_rank=4, lora_alpha=4.0, lora_dtype=dtype)


class _AnimaNet(torch.nn.Module):
    """Anima's forward: the LLMAdapter (f32), its padded rows zeroed, the DiT."""

    def __init__(self, dtype):
        super().__init__()
        from diffusion_pipe_tpu_torch.models.cosmos_predict2_model import CosmosPredict2Transformer
        from diffusion_pipe_tpu_torch.models.llm_adapter import LLMAdapter, LLMAdapterConfig

        adapter = LLMAdapter(LLMAdapterConfig(source_dim=64, target_dim=64, model_dim=64,
                                              num_layers=2, num_heads=4, vocab=1000,
                                              self_attn=True))
        self.dit = CosmosPredict2Transformer(_cosmos_reference_config(dtype), adapter)

    def forward(self, x, t, llm_hidden_states, t5_input_ids, t5_mask, llm_mask):
        ctx = self.dit.llm_adapter(llm_hidden_states, t5_input_ids, target_mask=t5_mask,
                                   source_mask=llm_mask)
        return self.dit(x, t, ctx * t5_mask[..., None].to(ctx.dtype))


class _EDMNet(torch.nn.Module):
    """Cosmos-1's forward: c_skip x_t + c_out F(c_in x_t, c_noise) in f32."""

    def __init__(self, dtype):
        super().__init__()
        from diffusion_pipe_tpu_torch.models.cosmos_predict2_model import CosmosPredict2Transformer

        self.dit = CosmosPredict2Transformer(_cosmos_reference_config(dtype))

    def forward(self, x_t, sigma, context):
        from diffusion_pipe_tpu_torch.training.edm import edm_scalings

        c_skip, c_out, c_in, c_noise = (c.reshape(-1, 1, 1, 1, 1) for c in edm_scalings(sigma))
        net = self.dit((x_t * c_in).to(self.dit.cfg.dtype), c_noise.flatten(), context)
        return c_skip * x_t + c_out * net.float()


def phase_reference_cosmos(device="cuda"):
    """The narrow MiniTrainDIT (_cosmos_reference_config) bf16 on the card
    against f32 on the CPU, as Predict2 with the Anima adapter in front (40
    Qwen rows of which 30 valid, 24 T5 ids of which 20) and under EDM (sigma
    1.7, 24 context rows): a 16 x 16 latent (64 image tokens), 4 attention
    calls (K1-K3 once each)."""
    gen = torch.Generator().manual_seed(SEED + 17)
    x = torch.randn((1, 16, 1, 16, 16), generator=gen)
    target = torch.randn(x.shape, generator=gen)
    hs = torch.randn((1, 40, 64), generator=gen)
    ids = torch.randint(0, 1000, (1, 24), generator=gen)
    llm_mask = (torch.arange(40) < 30).to(torch.int32)[None]
    t5_mask = (torch.arange(24) < 20).to(torch.int32)[None]
    ctx = torch.randn((1, 24, 64), generator=gen)

    def build_anima(dtype, dev):
        with torch.device(dev):
            return _AnimaNet(dtype)

    def anima_inputs(dtype):
        return dict(x=x.to(dtype), t=torch.tensor([0.4]), llm_hidden_states=hs,
                    t5_input_ids=ids, t5_mask=t5_mask, llm_mask=llm_mask)

    _reference_family("reference-cosmos", build_anima, anima_inputs, target, device, blocks=4)

    def build_edm(dtype, dev):
        with torch.device(dev):
            return _EDMNet(dtype)

    def edm_inputs(dtype):
        return dict(x_t=x * 2.0, sigma=torch.tensor([1.7]), context=ctx.to(dtype))

    _reference_family("reference-cosmos-edm", build_edm, edm_inputs, target, device, blocks=4)


# Qwen3-0.6B's config.json (Anima's text tower), as from_hf_config reads it
QWEN3_06B = {"model_type": "qwen3", "vocab_size": 151936, "hidden_size": 1024,
             "num_hidden_layers": 28, "num_attention_heads": 16, "num_key_value_heads": 8,
             "head_dim": 128, "intermediate_size": 3072, "rope_theta": 1000000.0,
             "rms_norm_eps": 1e-6, "tie_word_embeddings": True}


def phase_qwen3():
    """Anima's text function on Qwen3-0.6B at its published size (QWEN3_06B:
    28 layers, 1,024 wide, 16 heads over 8 of 128, q / k norms, FFN 3,072,
    vocab 151,936, tied embeddings) from a seed in bf16: LLMTextEncoder's
    final normed states (hidden_layer -1) of 2 x 512 ids (the second padded
    after 77), [2, 512, 1,024], timed with the peak; a narrow copy (256
    wide) bf16 on the card against f32 on the CPU (rel L2 < 3e-2)."""
    from diffusion_pipe_tpu_torch.models.llm_encoders import (CausalLM, CausalLMConfig,
                                                              LLMTextEncoder)

    def encoder(cfg, dev, seed):
        with torch.device("meta"):
            lm = CausalLM(cfg)
        lm = lm.to_empty(device=dev)
        lm.init_weights(torch.Generator(device=dev).manual_seed(seed))
        enc = LLMTextEncoder(".", max_length=COSMOS_TXT, hidden_layer=-1, dtype=cfg.dtype,
                             device=dev)
        enc.model = lm.eval().requires_grad_(False)
        return enc

    full = CausalLMConfig.from_hf_config(QWEN3_06B, dtype=torch.bfloat16)
    check(full.qk_norm and full.head_dim == 128 and full.num_kv_heads == 8,
          f"Qwen3 config {full}")
    gen = torch.Generator().manual_seed(SEED + 3)
    narrow = dict(vocab=1024, dim=256, num_heads=4, num_kv_heads=2, ffn_dim=512)
    ids = torch.randint(0, 1024, (1, 64), generator=gen)
    mask = torch.ones_like(ids)
    ref_enc = encoder(dataclasses.replace(full, dtype=torch.float32, param_dtype=torch.float32,
                                          **narrow), "cpu", SEED)
    card_enc = encoder(dataclasses.replace(full, **narrow), "cpu", SEED)
    card_enc.model.to("cuda")
    with torch.no_grad():
        ref = ref_enc.hidden_states(ids, mask)
        got = card_enc.hidden_states(ids.cuda(), mask.cuda()).float().cpu()
    narrow_err = _rel(got, ref)
    del ref_enc, card_enc
    _free()

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    enc = encoder(full, "cuda", SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ids = torch.randint(0, full.vocab, (2, COSMOS_TXT), generator=gen).cuda()
    mask = torch.ones_like(ids)
    mask[1, ANIMA_LLM_VALID:] = 0
    with torch.no_grad():
        h = enc.hidden_states(ids, mask)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            h = enc.hidden_states(ids, mask)
        torch.cuda.synchronize()
    encode_ms = (time.perf_counter() - t0) / 3 * 1e3
    finite = bool(torch.isfinite(h).all())
    emit(phase="qwen3-0.6b", params=sum(p.numel() for p in enc.model.parameters()),
         init_s=init_s, encode_ms=encode_ms, shape=list(h.shape), finite=finite,
         peak_memory_bytes=torch.cuda.max_memory_allocated(), narrow_rel_l2=narrow_err)
    check(list(h.shape) == [2, COSMOS_TXT, 1024] and finite, f"Qwen3 states {list(h.shape)}")
    check(narrow_err < 3e-2, f"narrow Qwen3 bf16 vs f32: rel L2 {narrow_err}")
    del enc, h
    _free()


# the first video bucket of examples/cosmos_dataset.toml (960 x 704, 121
# frames) and its latents; the crop held against f32 on the CPU
COSMOS_CLIP = (1, 3, 121, 704, 960)
COSMOS_CLIP_LATENTS = [1, 16, 16, 88, 120]
COSMOS_TOKENIZER_CROP = (1, 3, 17, 64, 96)
COSMOS_TOKENIZER_REL_L2 = 5e-2


def phase_cosmos_tokenizer():
    """The Cosmos tokenizer at its published widths (128 channels, x (2, 4,
    4), 2 resnets a level, z 16) from a seed (statistics away from 0 and
    1), written as a checkpoint under build/smoke/cosmos_tokenizer and read
    back by convert_cosmos_tokenizer (the same bits). bf16 on the card
    against f32 on the CPU on a 17-frame 96 x 64 crop (encode, and decode
    of the f32 latents: rel L2 < COSMOS_TOKENIZER_REL_L2); then the 121-frame
    960 x 704 clip encoded to [1, 16, 16, 88, 120] and decoded back, timed
    with the peak. Returns the checkpoint's path."""
    from diffusion_pipe_tpu_torch import safetensors_io
    from diffusion_pipe_tpu_torch.models.cosmos_tokenizer import (CosmosTokenizerConfig,
                                                                  CosmosVideoTokenizer,
                                                                  convert_cosmos_tokenizer,
                                                                  tokenizer_checkpoint)

    folder = _fresh_dir(SMOKE_DIR / "cosmos_tokenizer")
    cfg = CosmosTokenizerConfig()
    with torch.device("meta"):
        seeded = CosmosVideoTokenizer(cfg)
    seeded = seeded.to_empty(device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    seeded.init_weights(gen)
    with torch.no_grad():
        seeded.latent_mean.normal_(0.0, 0.1, generator=gen)
        seeded.latent_std.uniform_(0.5, 1.5, generator=gen)
    path = folder / "tokenizer.safetensors"
    written = tokenizer_checkpoint(seeded)
    safetensors_io.save_file(written, str(path))
    del seeded
    t0 = time.perf_counter()
    read_cfg, sd = convert_cosmos_tokenizer(safetensors_io.load_file(str(path)))
    convert_s = time.perf_counter() - t0
    check(read_cfg == cfg, f"tokenizer layout {read_cfg}")
    ref = CosmosVideoTokenizer(cfg)
    ref.load_state_dict(sd)
    same = all(torch.equal(ref.state_dict()[k], sd[k]) for k in sd)
    with torch.device("meta"):
        tok = CosmosVideoTokenizer(dataclasses.replace(cfg, dtype=torch.bfloat16))
    tok = tok.to_empty(device="cuda")
    tok.load_state_dict(sd)
    tok.eval().requires_grad_(False)
    cgen = torch.Generator().manual_seed(SEED + 5)
    crop = torch.rand(COSMOS_TOKENIZER_CROP, generator=cgen) * 2 - 1
    with torch.no_grad():
        z_ref = ref.encode(crop)
        y_ref = ref.decode(z_ref)
        z = tok.encode(crop.cuda()).float().cpu()
        y = tok.decode(z_ref.cuda()).float().cpu()
    enc_err, dec_err = _rel(z, z_ref), _rel(y, y_ref)
    del ref
    _free()

    clip = (torch.rand(COSMOS_CLIP, generator=gen, device="cuda") * 2 - 1).to(torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        tok.encode(clip[:, :, :9, :128, :128])  # warm-up: cuDNN picks its algorithms
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lat = tok.encode(clip)
        torch.cuda.synchronize()
        encode_s = time.perf_counter() - t0
        encode_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        video = tok.decode(lat)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
    finite = bool(torch.isfinite(lat).all() and torch.isfinite(video).all())
    emit(phase="cosmos-tokenizer", params=sum(p.numel() for p in tok.parameters()),
         checkpoint_tensors=len(written), convert_s=convert_s, read_back_bit_identical=same,
         crop=list(COSMOS_TOKENIZER_CROP), encode_rel_l2=enc_err, decode_rel_l2=dec_err,
         rel_l2_bound=COSMOS_TOKENIZER_REL_L2, clip=list(COSMOS_CLIP),
         latents=list(lat.shape), decoded=list(video.shape), encode_s=encode_s,
         decode_s=decode_s, encode_peak_memory_bytes=encode_peak,
         decode_peak_memory_bytes=torch.cuda.max_memory_allocated(), finite=finite)
    check(same, "the tokenizer read back from its checkpoint differs")
    check(list(lat.shape) == COSMOS_CLIP_LATENTS and list(video.shape) == list(COSMOS_CLIP)
          and finite, f"tokenizer shapes {list(lat.shape)} / {list(video.shape)}")
    check(enc_err < COSMOS_TOKENIZER_REL_L2 and dec_err < COSMOS_TOKENIZER_REL_L2,
          f"tokenizer bf16 vs f32: encode {enc_err}, decode {dec_err}")
    del tok, clip, lat, video
    _free()
    return path


ANIMA_LORA_CONFIG = {  # anima-lora-1024
    "save_every_n_epochs": 1,
    "model": {"type": "anima", "dtype": "bfloat16", "llm_adapter_lr": 5e-5},
    "adapter": {"type": "lora", "rank": 32, "alpha": 32, "dropout": 0.0},
    "optimizer": {"type": "adamw8bit", "lr": 1e-4},
    "gradient_clipping": 1.0,
    "activation_checkpointing": True,
}
COSMOS1_LORA_CONFIG = {  # cosmos1-7b-lora-704x960
    "save_every_n_epochs": 1,
    "model": {"type": "cosmos", "dtype": "bfloat16"},
    "adapter": {"type": "lora", "rank": 32, "alpha": 32, "dropout": 0.0},
    "optimizer": {"type": "adamw8bit", "lr": 1e-4},
    "gradient_clipping": 1.0,
    "activation_checkpointing": True,
}


def build_cosmos_slice(family, cfg, device="cuda", latent_thw=(1, 128, 128), batch_size=2,
                       txt_len=COSMOS_TXT):
    """A Cosmos family at the config's size; a batch of latents and the
    cached text at the model's widths: Anima's Qwen rows [txt_len, 1,024]
    with ANIMA_LLM_VALID valid and T5 ids with ANIMA_T5_VALID; Cosmos-1's
    T5 rows [txt_len, 1,024] with COSMOS_T5_VALID (zeros after)."""
    def make_batch(pipeline, gen):
        b = batch_size

        def valid(n):
            return (torch.arange(txt_len, device=device) < n).to(torch.int32).expand(b, -1)

        batch = {"latents": torch.randn((b, 16, *latent_thw), generator=gen, device=device)}
        if family == "anima":
            ac = pipeline.adapter_config
            ids = torch.randint(1, ac.vocab, (b, txt_len), generator=gen, device=device)
            batch.update(llm_hidden_states=torch.randn((b, txt_len, ac.source_dim),
                                                       generator=gen, device=device),
                         llm_mask=valid(ANIMA_LLM_VALID),
                         t5_input_ids=ids * valid(ANIMA_T5_VALID),
                         t5_mask=valid(ANIMA_T5_VALID))
        else:
            width = pipeline.cp_config.crossattn_emb_channels
            t5 = torch.randn((b, txt_len, width), generator=gen, device=device)
            batch["prompt_embeds"] = t5 * valid(COSMOS_T5_VALID)[..., None]
        return batch

    return _build_family_slice(family, cfg, device, make_batch)


def phase_slice_cosmos(family="anima"):
    """anima-lora-1024: Cosmos-Predict2 at its full 2 B size (28 blocks,
    2,048 wide) with Anima's LLMAdapter (f32, at llm_adapter_lr) in bf16,
    LoRA r32 on the 16 linears of each block, adamw8bit, `true`, batch 2 at
    1024 px (4,096 image rows, 512 T5 ids of which 60 valid, 512 Qwen rows
    of which 77). cosmos1-7b-lora-704x960: Cosmos-1 at its full 7 B size
    (28 blocks, 4,096 wide), EDM, batch 1 at 960 x 704 (2,640 image rows,
    512 T5 rows). 112 / 56 / 56 launches a step in each; the output and
    target shapes; every LoRA and adapter tensor moved (the bf16 lora_a may
    stay, NEW_MAY_STAY), the frozen weights unchanged."""
    anima = family == "anima"
    cfg = ANIMA_LORA_CONFIG if anima else COSMOS1_LORA_CONFIG
    thw, b = ((1, 128, 128), 2) if anima else ((1, 88, 120), 1)

    def after(pipeline, batch, gen):
        with torch.no_grad():
            inputs, target, _ = pipeline.prepare_inputs(batch, gen)
            out = pipeline.forward(inputs)
        out = out if anima else out[0]
        c = pipeline.cp_config
        rows = thw[0] * thw[1] * thw[2] // 4
        check(list(out.shape) == list(target.shape) == [b, 16, *thw] and c.head_dim == 128,
              f"output {list(out.shape)}, target {list(target.shape)}")
        adapter = [n for n, p in pipeline.model.named_parameters()
                   if p.requires_grad and n.startswith("llm_adapter.")]
        check(anima == bool(adapter), f"{len(adapter)} trainable LLMAdapter tensors")
        return dict(image_rows=rows, head_dim=c.head_dim, width=c.model_channels,
                    output_shape=list(out.shape), adapter_tensors=len(adapter),
                    adapter_params=sum(p.numel() for n, p in pipeline.model.named_parameters()
                                       if n.startswith("llm_adapter.")),
                    lr_scales=pipeline.lr_scale_map(float(cfg["optimizer"]["lr"])))

    counts, _, _ = phase_slice_family(
        "slice-anima-lora" if anima else "slice-cosmos1-lora",
        "anima-lora-1024" if anima else "cosmos1-7b-lora-704x960",
        lambda: build_cosmos_slice(family, cfg, latent_thw=thw, batch_size=b),
        timed_steps=NEW_TIMED_STEPS, expected_fn=_flash_step, no_gradient=("none",),
        after=after, may_stay=NEW_MAY_STAY)
    return counts


ANIMA_DRIVER_TOML = FLUX2_DRIVER_TOML.replace(
    "flux2-dev-lora-1024-fp8-int8's trainer", "anima-lora-1024's trainer").replace(
    "2 + 2 blocks", "2 blocks from a checkpoint").replace(
    'type = "flux2"', 'type = "anima"\nllm_adapter_lr = 5e-5').replace(
    'transformer_dtype = "float8"\nnum_layers = 2\nnum_single_layers = 2\n',
    'transformer_path = "{root}/predict2_2_blocks.safetensors"\n')
PREDICT2_DRIVER_TOML = ANIMA_DRIVER_TOML.replace(
    "anima-lora-1024's trainer", "anima-lora-1024's trainer on Cosmos-Predict2").replace(
    'type = "anima"\nllm_adapter_lr = 5e-5', 'type = "cosmos_predict2"')
COSMOS_DRIVER_TOML = FLUX2_DRIVER_TOML.replace(
    "flux2-dev-lora-1024-fp8-int8's trainer", "cosmos1-7b-lora-704x960's trainer").replace(
    "2 + 2 blocks", "2 blocks").replace('type = "flux2"', 'type = "cosmos"').replace(
    'transformer_dtype = "float8"\nnum_layers = 2\nnum_single_layers = 2\n', "num_blocks = 2\n")
COSMOS_DRIVER_CLIP = (1, 3, 9, 512, 512)


def _write_predict2_checkpoint(path, anima):
    """Cosmos-Predict2 at full width and 2 blocks from a seed, as a
    `net.`-prefixed checkpoint in the reference's names (bf16), for Anima
    with its LLMAdapter under llm_adapter.* (f32): the driver's layout
    comes from its keys."""
    from diffusion_pipe_tpu_torch import safetensors_io
    from diffusion_pipe_tpu_torch.models.cosmos_predict2 import cosmos_predict2_keymap
    from diffusion_pipe_tpu_torch.models.cosmos_predict2_model import (CosmosPredict2Config,
                                                                       CosmosPredict2Transformer)
    from diffusion_pipe_tpu_torch.models.keymaps import keymap_from_state_dict
    from diffusion_pipe_tpu_torch.models.layers import init_module_weights
    from diffusion_pipe_tpu_torch.models.llm_adapter import (LLMAdapter, LLMAdapterConfig,
                                                             export_llm_adapter)

    cfg = CosmosPredict2Config.p2b_2b(num_blocks=2)
    with torch.device("meta"):
        adapter = LLMAdapter(LLMAdapterConfig(self_attn=True)) if anima else None
        model = CosmosPredict2Transformer(cfg, adapter)
    model = model.to_empty(device="cuda")
    init_module_weights(model, torch.Generator(device="cuda").manual_seed(SEED))
    state = model.state_dict()
    sd = keymap_from_state_dict(state, cosmos_predict2_keymap(cfg), cfg)
    sd = {"net." + k: v.detach().contiguous().cpu() for k, v in sd.items()}
    sd.update({"net." + k: v for k, v in export_llm_adapter(state).items()})
    safetensors_io.save_file(sd, str(path))
    return len(sd)


def _anima_text_stand_in():
    """Seeded text at Anima's cached shapes: Qwen3's rows [512, 1,024] with
    ANIMA_LLM_VALID valid, T5 ids [512] with ANIMA_T5_VALID valid."""
    from diffusion_pipe_tpu_torch.models.text_encoders import seeded_draws

    def fn(caps):
        b = len(caps)
        ids = (seeded_draws(caps, "t5_ids", (COSMOS_TXT,)).abs() * 1000).to(torch.int32) + 1
        llm = (torch.arange(COSMOS_TXT) < ANIMA_LLM_VALID).to(torch.int32).expand(b, -1)
        t5 = (torch.arange(COSMOS_TXT) < ANIMA_T5_VALID).to(torch.int32).expand(b, -1)
        return {"llm_hidden_states": seeded_draws(caps, "qwen3", (COSMOS_TXT, 1024)),
                "llm_mask": llm.clone(), "t5_input_ids": ids * t5, "t5_mask": t5.clone()}

    return [fn]


def _t5_text_stand_in(key):
    """Seeded old-T5 rows [512, 1,024] under key (Predict2's t5_embed,
    Cosmos-1's prompt_embeds), COSMOS_T5_VALID valid, zeros after."""
    from diffusion_pipe_tpu_torch.models.text_encoders import seeded_draws

    def fn(caps):
        valid = (torch.arange(COSMOS_TXT) < COSMOS_T5_VALID).float()[None, :, None]
        return {key: seeded_draws(caps, "t5", (COSMOS_TXT, 1024)) * valid}

    return [fn]


def cosmos_driver_clip(vae_path):
    """A seeded 9-frame 512 px clip through Cosmos-1's caching function
    (get_call_vae_fn, the tokenizer of vae_path in bf16): [1, 16, 2, 64, 64]
    latents. (A video file would go through imageio, which the card's
    machine lacks.)"""
    import numpy as np

    from diffusion_pipe_tpu_torch.models import get_model_class

    config = {"model": {"type": "cosmos", "dtype": "bfloat16", "vae_path": str(vae_path)}}
    fn = get_model_class("cosmos")(config, device="cuda").get_call_vae_fn()
    clip = np.random.default_rng(SEED).uniform(-1, 1, COSMOS_DRIVER_CLIP).astype(np.float32)
    t0 = time.perf_counter()
    lat = fn(clip)["latents"]
    torch.cuda.synchronize()
    shape = list(lat.shape)
    check(shape == [1, 16, 2, 64, 64] and bool(torch.isfinite(lat).all()),
          f"the clip's latents {shape}")
    return dict(clip=list(COSMOS_DRIVER_CLIP), clip_latents=shape,
                clip_encode_s=time.perf_counter() - t0)


# --- slice 18: HunyuanVideo and HunyuanImage-2.1 --------------------------------

# K1-K3 at the two families' attention, heads of 128, the padded text keys
# masked: HunyuanVideo's joint sequence for a 33-frame 512 px clip (9 x 32 x
# 32 = 9,216 image rows + 256 LLaVA rows, 60 valid; 24 heads) and its token
# refiner over the 256 rows (K1 alone on the path: the refiner trains no
# weight and its input needs no gradient); HunyuanImage-2.1's at 2048 px
# (4,096 image rows + 128 byT5 rows, 12 valid, + 966 Qwen rows, 80 valid;
# 28 heads) and its refiner over the 966.
# (case, (B, S, H), masked keys of the batch element, checked heads)
HV_TXT, HV_VALID = 256, 60
HI_BYT5, HI_BYT5_VALID, HI_TXT, HI_VALID = 128, 12, 966, 80
HV_IMAGE_ROWS, HI_IMAGE_ROWS = 9 * 32 * 32, 64 * 64
HUNYUAN_KERNEL_CASES = (
    ("hunyuan_video_joint_9472", (1, HV_IMAGE_ROWS + HV_TXT, 24),
     (slice(HV_IMAGE_ROWS + HV_VALID, HV_IMAGE_ROWS + HV_TXT),), slice(0, 4)),
    ("hunyuan_video_refiner_256", (1, HV_TXT, 24), (slice(HV_VALID, HV_TXT),), None),
    ("hunyuan_image_joint_5190", (1, HI_IMAGE_ROWS + HI_BYT5 + HI_TXT, 28),
     (list(range(HI_IMAGE_ROWS + HI_BYT5_VALID, HI_IMAGE_ROWS + HI_BYT5))
      + list(range(HI_IMAGE_ROWS + HI_BYT5 + HI_VALID, HI_IMAGE_ROWS + HI_BYT5 + HI_TXT)),),
     slice(0, 4)),
    ("hunyuan_image_refiner_966", (1, HI_TXT, 28), (slice(HI_VALID, HI_TXT),), None),
)


def phase_kernels_hunyuan():
    """K1-K3 at the four HunyuanVideo / HunyuanImage-2.1 shapes against their
    plain versions (4 heads of the joint sequences: the plain versions' f32
    logits grow with each), K2 / K3 deterministic at the video joint
    shape, each timed beside its bound on the valid keys, its plain version
    and SDPA with the same mask. Returns {case: K1-K3 timing}."""
    from diffusion_pipe_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    timings = {}
    for case, (b, s, h), masked, heads in HUNYUAN_KERNEL_CASES:
        errors = _check_attention(fa, case, b, s, s, h, 128, masked, gen, heads=heads)
        _free()
        splits = None
        if case == "hunyuan_video_joint_9472":
            splits = _check_bwd_deterministic(fa, case, b, s, s, h, 128, gen, masked=masked)
            _free()
        timing, sdpa_bwd_ms = _time_attention(fa, b, s, s, h, 128, gen, masked=masked)
        for name, tm in timing.items():
            tm["max_abs_err"] = max(errors[k]["err"] for k in ERR_KEYS[name])
        masked_keys = masked[0]
        n_masked = (len(range(s)[masked_keys]) if isinstance(masked_keys, slice)
                    else len(masked_keys))
        emit(phase="kernels-hunyuan", case=f"timing_{case}", q_shape=[b, s, h, 128], kv_len=s,
             valid_keys=s - n_masked, masked=True, timing=timing, sdpa_bwd_ms=sdpa_bwd_ms,
             k3_query_splits=splits, on_path="K1" if "refiner" in case else "K1-K3")
        timings[case] = timing
        _free()
    return timings


def _hunyuan_reference(family, dtype, dev):
    """1 + 1 blocks and a 1-block refiner at 256 wide (2 heads of 128), LoRA
    rank 4 on every block linear: HunyuanVideo with text 64 and CLIP 32
    wide, HunyuanImage-2.1 with 64 latent channels, Qwen 64 and byT5 32
    through a mapper of 48."""
    from diffusion_pipe_tpu_torch.models.hunyuan_image import (HunyuanImageConfig,
                                                               HunyuanImageTransformer)
    from diffusion_pipe_tpu_torch.models.hunyuan_video_model import (HunyuanVideoConfig,
                                                                     HunyuanVideoTransformer)

    kw = dict(num_attention_heads=2, num_layers=1, num_single_layers=1, refiner_layers=1,
              text_dim=64, dtype=dtype, param_dtype=dtype, lora_rank=4, lora_alpha=4.0,
              lora_dtype=dtype)
    with torch.device(dev):
        if family == "hunyuan-video":
            return HunyuanVideoTransformer(HunyuanVideoConfig(pooled_projection_dim=32, **kw))
        return HunyuanImageTransformer(HunyuanImageConfig(byt5_dim=32, byt5_mapper_dim=48, **kw))


def phase_reference_hunyuan(family, device="cuda"):
    """The narrow model (_hunyuan_reference) bf16 on the card against f32 on
    the CPU: HunyuanVideo on 3 x 8 x 8 latents (48 image tokens) with 12
    LLaVA rows (8 valid), HunyuanImage-2.1 on 8 x 8 latents with 12 Qwen
    rows (8 valid) and 6 byT5 rows (3 valid). K1 three times (2 blocks
    and the refiner), K2 and K3 twice."""
    video = family == "hunyuan-video"
    gen = torch.Generator().manual_seed(SEED + 18)
    x = torch.randn((1, 16, 3, 8, 8) if video else (1, 64, 8, 8), generator=gen)
    txt = torch.randn((1, 12, 64), generator=gen)
    mask = (torch.arange(12) < 8).to(torch.int32)[None]
    extra = torch.randn((1, 32) if video else (1, 6, 32), generator=gen)
    target = torch.randn(x.shape, generator=gen)

    def inputs(dtype):
        common = dict(x=x.to(dtype), t=torch.tensor([400.0]), text_states=txt.to(dtype),
                      text_mask=mask)
        if video:
            return dict(common, pooled=extra.to(dtype), guidance=torch.tensor([1000.0]))
        return dict(common, byt5_states=extra.to(dtype),
                    byt5_mask=(torch.arange(6) < 3).to(torch.int32)[None])

    _reference_family(f"reference-{'hunyuan-video' if video else 'hunyuan-image'}",
                      functools.partial(_hunyuan_reference, family), inputs, target, device,
                      expected={"flash_fwd": 3, "flash_bwd_dq": 2, "flash_bwd_dkv": 2})


HV_VAE_CLIP = (1, 3, 33, 512, 512)      # -> [1, 16, 9, 64, 64]
HV_VAE_LATENTS = [1, 16, 9, 64, 64]
HV_VAE_CROP = (1, 3, 9, 256, 256)       # bf16 against f32 on the card


def phase_hunyuan_vae():
    """The published causal 3D VAE at its full widths (128 / 256 / 512 / 512,
    2 resnets a block, 16 latent channels, the quant convolutions) from a
    seed, its weights written in diffusers' layout to build/smoke/hunyuan_vae/
    and read back by load_hunyuan_vae (driver-hunyuan-video caches with it).
    In bf16 on the card: a 33-frame 512 px clip encoded to [1, 16, 9, 64,
    64] and decoded back to the clip's shape, each timed with the peak;
    then a 9-frame 256 px crop encoded and decoded in bf16 and by the same
    weights in f32 on the card (TF32 off): the latents' and the decode's
    relative L2 (WAN_VAE_REL_L2). Returns the folder."""
    from diffusion_pipe_tpu_torch import safetensors_io
    from diffusion_pipe_tpu_torch.models.hunyuan_vae import (HunyuanVAE, HunyuanVAEConfig,
                                                             load_hunyuan_vae)

    folder = _fresh_dir(SMOKE_DIR / "hunyuan_vae")
    t0 = time.perf_counter()
    with torch.device("cuda"):
        src = HunyuanVAE(HunyuanVAEConfig())
    src.init_weights(torch.Generator(device="cuda").manual_seed(SEED))
    safetensors_io.save_file({k: v.cpu() for k, v in src.state_dict().items()},
                             folder / "diffusion_pytorch_model.safetensors")
    del src
    vae = load_hunyuan_vae(folder, dtype=torch.bfloat16, device="cuda")
    write_read_s = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    clip = torch.rand(HV_VAE_CLIP, generator=gen, device="cuda").mul_(2).sub_(1)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        z = vae.encode(clip)
        torch.cuda.synchronize()
        encode_ms = cuda_ms(lambda: vae.encode(clip), iters=1)
        encode_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        x = vae.decode(z)
        torch.cuda.synchronize()
        decode_ms = cuda_ms(lambda: vae.decode(z), iters=1)
        decode_peak = torch.cuda.max_memory_allocated()
    shapes = (list(z.shape), list(x.shape))
    finite = bool(torch.isfinite(z).all() and torch.isfinite(x).all())
    del clip, z, x
    _free()
    crop = torch.rand(HV_VAE_CROP, generator=gen, device="cuda").mul_(2).sub_(1)
    with torch.no_grad():
        z = vae.encode(crop)
        x = vae.decode(z)
        vae.float()
        vae.config = dataclasses.replace(vae.config, dtype=torch.float32)
        z_ref = vae.encode(crop)
        x_ref = vae.decode(z_ref)
    rec = dict(clip_shape=list(HV_VAE_CLIP), latent_shape=shapes[0], decoded_shape=shapes[1],
               encode_ms=encode_ms, decode_ms=decode_ms, encode_peak_memory_bytes=encode_peak,
               decode_peak_memory_bytes=decode_peak, write_read_s=write_read_s, finite=finite,
               crop_shape=list(HV_VAE_CROP), encode_rel_l2=_rel_l2(z, z_ref),
               decode_rel_l2=_rel_l2(x, x_ref))
    del vae, crop, z, x, z_ref, x_ref
    _free()
    emit(phase="hunyuan-vae", **rec)
    check(rec["latent_shape"] == HV_VAE_LATENTS and rec["decoded_shape"] == list(HV_VAE_CLIP)
          and finite, f"hunyuan-vae shapes {rec['latent_shape']} / {rec['decoded_shape']}")
    check(rec["encode_rel_l2"] <= WAN_VAE_REL_L2 and rec["decode_rel_l2"] <= WAN_VAE_REL_L2,
          f"hunyuan-vae bf16 off f32: {rec['encode_rel_l2']}, {rec['decode_rel_l2']}")
    return folder


# LLaVA-Llama-3-8B's text tower (Llama-3-8B's shapes, no RoPE scaling)
LLAVA_LLAMA3_8B = {k: v for k, v in LLAMA31_8B.items() if k != "rope_scaling"}


def phase_llava_llama3():
    """HunyuanVideo's LLaVA text function (LLMTextEncoder with hyvideo's video
    template, crop 95, hidden_states[-3], 256 rows) on Llama-3-8B's shapes
    (32 layers, 4,096 wide) from a seed, bf16, with a word-level tokenizer
    (the template's header tokens special): two captions through encode,
    [2, 256, 4,096] with the mask, equal to the uncropped states of the
    same ids from row 95 on; 2 x (95 + 256) ids timed with the peak. A
    narrow 32-layer copy on the card against f32 on the CPU."""
    from diffusion_pipe_tpu_torch.models.hunyuan_video import VIDEO_CROP_START, VIDEO_TEMPLATE
    from diffusion_pipe_tpu_torch.models.llm_encoders import (CausalLM, CausalLMConfig,
                                                              LLMTextEncoder)

    def encoder(cfg, dev, seed):
        with torch.device("meta"):
            lm = CausalLM(cfg)
        lm = lm.to_empty(device=dev)
        lm.init_weights(torch.Generator(device=dev).manual_seed(seed))
        enc = LLMTextEncoder(".", max_length=HV_TXT, template=VIDEO_TEMPLATE,
                             crop_start=VIDEO_CROP_START, hidden_layer=-3, dtype=cfg.dtype,
                             device=dev)
        enc.model = lm.eval().requires_grad_(False)
        return enc

    full = CausalLMConfig.from_hf_config(LLAVA_LLAMA3_8B, dtype=torch.bfloat16)
    check(not full.rope_llama3 and full.num_layers == 32, f"LLaVA config {full}")
    gen = torch.Generator().manual_seed(SEED + 95)
    narrow = dict(vocab=1024, dim=256, num_heads=4, num_kv_heads=1, ffn_dim=512)
    ids = torch.randint(0, 1024, (1, 128), generator=gen)
    mask = torch.ones_like(ids)
    ref_enc = encoder(dataclasses.replace(full, dtype=torch.float32, param_dtype=torch.float32,
                                          **narrow), "cpu", SEED)
    card_enc = encoder(dataclasses.replace(full, **narrow), "cpu", SEED)
    card_enc.model.to("cuda")
    with torch.no_grad():
        ref = ref_enc.hidden_states(ids, mask)
        got = card_enc.hidden_states(ids.cuda(), mask.cuda()).float().cpu()
    narrow_err = _rel(got, ref)
    del ref_enc, card_enc
    _free()

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    enc = encoder(full, "cuda", SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    caps = ["a seeded video, number 0", "a seeded video, number 1 of a longer caption"]
    enc.tokenizer = _word_tokenizer(
        " ".join(caps).replace(",", " ").split(), pad="<|eot_id|>",
        specials=["<|start_header_id|>", "<|end_header_id|>", "<|eot_id|>"])
    h, m = enc.encode(caps)
    tok = enc.tokenizer([VIDEO_TEMPLATE.format(c) for c in caps], padding="max_length",
                        truncation=True, max_length=HV_TXT + VIDEO_CROP_START,
                        return_tensors="pt")
    with torch.no_grad():
        whole = enc.hidden_states(tok["input_ids"].cuda(), tok["attention_mask"].cuda())
    cropped = torch.equal(h, whole[:, VIDEO_CROP_START:].float().cpu())
    ids = torch.randint(0, full.vocab, (2, HV_TXT + VIDEO_CROP_START), generator=gen).cuda()
    mask = torch.ones_like(ids)
    mask[1, VIDEO_CROP_START + HV_VALID:] = 0
    with torch.no_grad():
        enc.hidden_states(ids, mask)
        torch.cuda.synchronize()
        encode_ms = cuda_ms(lambda: enc.hidden_states(ids, mask), iters=3)
    emit(phase="llava-llama3", params=sum(p.numel() for p in enc.model.parameters()),
         init_s=init_s, encode_ms=encode_ms, ids=list(ids.shape), shape=list(h.shape),
         valid_rows=m.sum(1).tolist(), crop_start=VIDEO_CROP_START, cropped_equal=cropped,
         finite=bool(torch.isfinite(h).all()), peak_memory_bytes=torch.cuda.max_memory_allocated(),
         narrow_rel_l2=narrow_err)
    check(list(h.shape) == [2, HV_TXT, 4096] and list(m.shape) == [2, HV_TXT]
          and bool(torch.isfinite(h).all()), f"LLaVA states {list(h.shape)}")
    check(cropped, "the LLaVA states are not the uncropped ones from row crop_start on")
    check(narrow_err < 3e-2, f"narrow LLaVA-Llama-3 bf16 vs f32: rel L2 {narrow_err}")
    del enc, h, whole
    _free()


# byT5-small (google/byt5-small's encoder: 12 layers, 1,472 wide, 6 heads of
# 64, gated-GELU FFN 3,584, 384 byte ids)
BYT5_SMALL = dict(vocab_size=384, d_model=1472, d_kv=64, d_ff=3584, num_layers=12,
                  num_heads=6, feed_forward_proj="gated-gelu", is_encoder_decoder=False)


def phase_byt5():
    """HunyuanImage-2.1's glyph function (hunyuan_image.byt5_text_fn on an
    HFTextEncoder "t5") on byT5-small's encoder from a seed with the byte
    tokenizer: 2 captions, one with quoted spans and one without (its row
    zeroed), 128 ids each, bf16 timed against f32 on the card (rel L2 <
    5e-2 on the valid rows)."""
    from transformers import T5Config, T5EncoderModel

    from diffusion_pipe_tpu_torch.models.hunyuan_image import byt5_prompts, byt5_text_fn
    from diffusion_pipe_tpu_torch.models.text_encoders import HFTextEncoder

    try:
        from transformers import ByT5Tokenizer

        tokenizer = ByT5Tokenizer()
    except ImportError:  # a word-level stand-in
        tokenizer = _word_tokenizer(list("abcdefghijklmnopqrstuvwxyz"), eos="</s>")
    torch.manual_seed(SEED)
    with torch.device("cuda"):
        model = T5EncoderModel(T5Config(**BYT5_SMALL)).eval().requires_grad_(False)
    caps = ['a shop sign that says "OPEN 24/7" and “Hunyuan”', "a seeded picture, number 1"]
    enc = HFTextEncoder("t5", "(seeded)", max_length=HI_BYT5, device="cuda", dtype=torch.bfloat16)
    enc._tokenizer, enc._model = tokenizer, model
    fn = byt5_text_fn(enc)
    with torch.no_grad():
        ref = fn(caps)
    enc._model = model.to(torch.bfloat16)
    got = fn(caps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        got = fn(caps)
    torch.cuda.synchronize()
    encode_ms = (time.perf_counter() - t0) / 3 * 1e3
    valid = got["byt5_mask"].bool()
    valid[1] = False
    err = _rel(got["byt5_states"][valid], ref["byt5_states"][valid])
    states = got["byt5_states"]
    emit(phase="byt5", params=sum(p.numel() for p in model.parameters()), encode_ms=encode_ms,
         shape=list(states.shape), prompts=byt5_prompts(caps)[0],
         valid_ids=got["byt5_mask"].sum(1).tolist(), rel_l2_vs_f32=err)
    check(list(states.shape) == [2, HI_BYT5, 1472] and bool(torch.isfinite(states).all()),
          f"byT5 states {list(states.shape)}")
    check(bool(states[0].any()) and not bool(states[1].any()),
          "the caption without a quoted span must give zeros, the other not")
    check(err < 5e-2, f"byT5 bf16 vs f32: rel L2 {err}")
    del model, enc
    _free()


HUNYUAN_VIDEO_LORA_CONFIG = {  # hunyuan-video-lora-512x33: examples/hunyuan_video.toml's trainer
    "save_every_n_epochs": 1,
    "model": {"type": "hunyuan-video", "dtype": "bfloat16", "transformer_dtype": "float8",
              "timestep_sample_method": "logit_normal"},
    "adapter": {"type": "lora", "rank": 32, "alpha": 32, "dropout": 0.0, "dtype": "bfloat16"},
    "optimizer": {"type": "adamw8bit", "lr": 2e-5},
    "gradient_clipping": 1.0,
    "activation_checkpointing": True,
}
HUNYUAN_IMAGE_LORA_CONFIG = {  # hunyuan-image-2.1-lora-2048
    "save_every_n_epochs": 1,
    "model": {"type": "hunyuan_image", "dtype": "bfloat16"},
    "adapter": {"type": "lora", "rank": 32, "alpha": 32, "dropout": 0.0, "dtype": "bfloat16"},
    "optimizer": {"type": "adamw8bit", "lr": 1e-4},
    "gradient_clipping": 1.0,
    "activation_checkpointing": True,
}


def build_hunyuan_slice(family, cfg, device="cuda", latent=(9, 64, 64), txt=(HV_TXT, HV_VALID),
                        byt5=(HI_BYT5, HI_BYT5_VALID), batch_size=1):
    """HunyuanVideo ([B, 16, *latent] latents, txt = (rows, valid) LLaVA rows
    of 4,096 and CLIP-L's pooled 768) or HunyuanImage-2.1 ([B, 64, *latent]
    latents, Qwen rows of 3,584 and byt5 = (rows, valid) byT5 rows of
    1,472) at the config's size, the padded rows zero."""
    def make_batch(pipeline, gen):
        c = pipeline.hv_config if family == "hunyuan-video" else pipeline.hi_config

        def r(*shape):
            return torch.randn((batch_size, *shape), generator=gen, device=device)

        def rows(n, valid, width):
            m = (torch.arange(n, device=device) < valid).to(torch.int32)
            m = m.expand(batch_size, -1).clone()
            return (r(n, width) * m[..., None]).to(c.dtype), m

        states, mask = rows(*txt, c.text_dim)
        batch = {"latents": r(c.in_channels, *latent), "text_states": states, "text_mask": mask}
        if family == "hunyuan-video":
            batch["clip_pooled"] = r(c.pooled_projection_dim).to(c.dtype)
        else:
            batch["byt5_states"], batch["byt5_mask"] = rows(*byt5, c.byt5_dim)
        return batch

    return _build_family_slice(family, cfg, device, make_batch)


def phase_slice_hunyuan(family):
    """hunyuan-video-lora-512x33: HunyuanVideo at its published size (20 + 40
    blocks, 3,072 wide, 12.8 B) with the block weights in fp8, LoRA r32 in
    bf16, adamw8bit, logit_normal, `true`, one 33-frame 512 px clip
    ([1, 16, 9, 64, 64]: 9,216 image rows) with 256 LLaVA rows (60 valid);
    or hunyuan-image-2.1-lora-2048: HunyuanImage-2.1 at its published size
    (20 + 40 blocks, 3,584 wide, 17.4 B) in bf16, LoRA r32, adamw8bit,
    `true`, batch 1 at 2048 px ([1, 64, 64, 64]) with 966 Qwen rows (80
    valid) and 128 byT5 rows (12 valid). 122 / 60 / 60 launches a step:
    60 blocks twice under `true` and the refiner's 2 forwards."""
    video = family == "hunyuan-video"
    cell = "hunyuan-video-lora-512x33" if video else "hunyuan-image-2.1-lora-2048"

    def after(pipeline, batch, gen):
        with torch.no_grad():
            inputs, target, _ = pipeline.prepare_inputs(batch, gen)
            out = pipeline.forward(inputs)
        shape = [1, 16, 9, 64, 64] if video else [1, 64, 64, 64]
        rows = HV_IMAGE_ROWS + HV_TXT if video else HI_IMAGE_ROWS + HI_BYT5 + HI_TXT
        check(list(out.shape) == list(target.shape) == shape and bool(torch.isfinite(out).all()),
              f"output {list(out.shape)}")
        return dict(sequence=rows, output_shape=list(out.shape))

    if video:
        build = functools.partial(build_hunyuan_slice, family, HUNYUAN_VIDEO_LORA_CONFIG)
    else:
        build = functools.partial(build_hunyuan_slice, family, HUNYUAN_IMAGE_LORA_CONFIG,
                                  latent=(64, 64), txt=(HI_TXT, HI_VALID))
    counts, _, _ = phase_slice_family(
        f"slice-{cell.rsplit('-', 1)[0]}", cell, build, timed_steps=NEW_TIMED_STEPS,
        expected_fn=_flash_step, no_gradient=("none",), after=after, may_stay=NEW_MAY_STAY)
    return counts


HUNYUAN_VIDEO_DRIVER_TOML = FLUX2_DRIVER_TOML.replace(
    "flux2-dev-lora-1024-fp8-int8's trainer", "hunyuan-video-lora-512x33's trainer").replace(
    "2 + 2 blocks", "1 + 1 blocks, fp8 storage").replace(
    'type = "flux2"', 'type = "hunyuan-video"').replace(
    "num_layers = 2\nnum_single_layers = 2\n", "num_layers = 1\nnum_single_layers = 1\n")
HUNYUAN_IMAGE_DRIVER_TOML = HUNYUAN_VIDEO_DRIVER_TOML.replace(
    "hunyuan-video-lora-512x33's trainer", "hunyuan-image-2.1-lora-2048's trainer").replace(
    ", fp8 storage", "").replace('transformer_dtype = "float8"\n', "").replace(
    'type = "hunyuan-video"', 'type = "hunyuan_image"')


def _hunyuan_text_stand_in(family):
    """Seeded text at the cached shapes: HunyuanVideo's LLaVA rows [256,
    4,096] (60 valid) and CLIP-L's pooled [768]; HunyuanImage-2.1's Qwen
    rows [966, 3,584] (80 valid) and byT5 rows [128, 1,472] (12 valid)."""
    from diffusion_pipe_tpu_torch.models.text_encoders import seeded_draws

    def rows(caps, key, n, valid, width):
        m = (torch.arange(n) < valid).to(torch.int32).expand(len(caps), -1).clone()
        return seeded_draws(caps, key, (n, width)) * m[..., None], m

    def llm(caps):
        n, valid, width = (HV_TXT, HV_VALID, 4096) if family == "hunyuan-video" else (
            HI_TXT, HI_VALID, 3584)
        states, mask = rows(caps, "llm", n, valid, width)
        return {"text_states": states, "text_mask": mask}

    if family == "hunyuan-video":
        return [llm, lambda caps: {"clip_pooled": seeded_draws(caps, "clip", (768,))}]

    def byt5(caps):
        states, mask = rows(caps, "byt5", HI_BYT5, HI_BYT5_VALID, 1472)
        return {"byt5_states": states, "byt5_mask": mask}

    return [llm, byt5]


def _write_hunyuan_image_vae(folder):
    """A seeded 32x KL VAE with 64 latent channels (six blocks of 64 / 128 /
    256 / 256 / 512 / 512, narrower than the published 32x VAE) in the
    diffusers layout: what the AutoencoderKL loader infers HunyuanImage-2.1's
    VAE from."""
    from diffusion_pipe_tpu_torch import safetensors_io
    from diffusion_pipe_tpu_torch.models.autoencoder_kl import (AutoencoderKL, VAEConfig,
                                                                diffusers_vae_state_dict)

    folder.mkdir(parents=True)
    vae = AutoencoderKL(VAEConfig(latent_channels=64, block_out_channels=(64, 128, 256, 256,
                                                                          512, 512),
                                  scaling_factor=1.0, shift_factor=0.0))
    vae.init_weights(torch.Generator().manual_seed(SEED))
    safetensors_io.save_file(diffusers_vae_state_dict(vae),
                             folder / "diffusion_pytorch_model.safetensors")
    return folder


# --- HunyuanVideo-1.5, LTX-Video and LTX-2 ------------------------------------

# HunyuanVideo-1.5's joint sequence at a 33-frame 512 px clip: 9 x 32 x 32
# image rows (16x VAE, patch 1), then 128 byT5 rows (12 valid) and 966 Qwen
# rows (80 valid), 16 heads of 128; LTX's 121-frame 768 x 512 clip: 16 x 16
# x 24 = 6,144 latent tokens, T5's 128 rows (40 valid), Gemma's 512 (60
# valid) through the connector's 1,024 rows
HV15_IMAGE_ROWS, HV15_BYT5, HV15_BYT5_VALID, HV15_TXT, HV15_VALID = 9 * 32 * 32, 128, 12, 966, 80
LTX_LATENTS = (16, 16, 24)
LTX_ROWS = 16 * 16 * 24
LTX_T5, LTX_T5_VALID, LTX2_GEMMA, LTX2_GEMMA_VALID = 128, 40, 512, 60
# (case, (B, Sq, Skv, H), D, masked keys of element 0 or False, checked heads, on the path)
LTX_HV15_KERNEL_CASES = (
    ("hv15_joint_10310", (1, HV15_IMAGE_ROWS + HV15_BYT5 + HV15_TXT,
                          HV15_IMAGE_ROWS + HV15_BYT5 + HV15_TXT, 16), 128,
     list(range(HV15_IMAGE_ROWS + HV15_BYT5_VALID, HV15_IMAGE_ROWS + HV15_BYT5))
     + list(range(HV15_IMAGE_ROWS + HV15_BYT5 + HV15_VALID,
                  HV15_IMAGE_ROWS + HV15_BYT5 + HV15_TXT)), slice(0, 4), "K1-K3"),
    ("hv15_refiner_966", (1, HV15_TXT, HV15_TXT, 16), 128, slice(HV15_VALID, HV15_TXT), None,
     "K1"),
    ("ltx_self_6144", (1, LTX_ROWS, LTX_ROWS, 32), 64, False, slice(0, 8), "K1-K3"),
    ("ltx_cross_6144x128", (1, LTX_ROWS, LTX_T5, 32), 64, slice(LTX_T5_VALID, LTX_T5), None,
     "K1-K3"),
    ("ltx2_self_6144", (1, LTX_ROWS, LTX_ROWS, 32), 128, False, slice(0, 8), "K1-K3"),
    ("ltx2_cross_6144x1024", (1, LTX_ROWS, 1024, 32), 128, False, None, "K1-K3"),
    ("ltx2_connector_1024", (1, 1024, 1024, 64), 64, False, None, "K1"),
)


def phase_kernels_ltx_hv15():
    """K1-K3 at the seven HunyuanVideo-1.5 / LTX-Video / LTX-2 shapes against
    their plain versions (some heads of the long self-attentions), K2 / K3
    deterministic at the LTX-Video cross shape (a masked Skv of 128), each
    timed beside its bound on the valid keys, its plain version, and SDPA
    with the same mask. Returns {case: K1-K3 timing}."""
    from diffusion_pipe_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    timings = {}
    for case, (b, sq, skv, h), d, masked, heads, on_path in LTX_HV15_KERNEL_CASES:
        errors = _check_attention(fa, case, b, sq, skv, h, d, masked, gen, heads=heads)
        _free()
        splits = None
        if case == "ltx_cross_6144x128":
            splits = _check_bwd_deterministic(fa, case, b, sq, skv, h, d, gen, masked=masked)
            _free()
        timing, sdpa_bwd_ms = _time_attention(fa, b, sq, skv, h, d, gen, masked=masked)
        for name, tm in timing.items():
            tm["max_abs_err"] = max(errors[k]["err"] for k in ERR_KEYS[name])
        n_masked = 0
        if masked is not False:
            n_masked = (len(range(skv)[masked]) if isinstance(masked, slice) else len(masked))
        emit(phase="kernels-ltx-hv15", case=f"timing_{case}", q_shape=[b, sq, h, d],
             kv_len=skv, valid_keys=skv - n_masked, masked=masked is not False, timing=timing,
             sdpa_bwd_ms=sdpa_bwd_ms, k3_query_splits=splits, on_path=on_path)
        timings[case] = timing
        _free()
    return timings


def _ltx_hv15_reference(family, dtype, dev):
    """Narrow models, LoRA rank 4 on every block linear: HunyuanVideo-1.5
    with 1 double block and a 1-block refiner at 256 wide (2 heads of 128),
    32 latent channels, patch 1, Qwen 64, byT5 32 through 48; LTX-Video with
    2 blocks at 128 wide (2 heads of 64), 128 latent channels, caption 64;
    LTX-2 with 1 block at 256 wide (2 heads of 128), caption 96, a 1-block
    connector (4 heads of 64) of 16 registers padding to 64 rows."""
    from diffusion_pipe_tpu_torch.models.hunyuan_video_15 import (HunyuanVideo15Config,
                                                                  HunyuanVideo15Transformer)
    from diffusion_pipe_tpu_torch.models.ltx2 import LTX2Config, LTX2Transformer
    from diffusion_pipe_tpu_torch.models.ltx_video import LTXConfig, LTXTransformer

    lora = dict(dtype=dtype, param_dtype=dtype, lora_rank=4, lora_alpha=4.0, lora_dtype=dtype)
    with torch.device(dev):
        if family == "hunyuan_video_15":
            return HunyuanVideo15Transformer(HunyuanVideo15Config(
                num_attention_heads=2, num_layers=1, refiner_layers=1, text_dim=64, byt5_dim=32,
                byt5_mapper_dim=48, **lora))
        if family == "ltx-video":
            return LTXTransformer(LTXConfig(hidden_size=128, num_heads=2, num_layers=2,
                                            caption_dim=64, **lora))
        return LTX2Transformer(LTX2Config(hidden_size=256, num_heads=2, num_layers=1,
                                          cross_attention_dim=96, connector_registers=16,
                                          connector_min_len=64, connector_blocks=1, **lora))


def phase_reference_ltx_hv15(family, device="cuda"):
    """The narrow model (_ltx_hv15_reference) bf16 on the card against f32 on
    the CPU: HunyuanVideo-1.5 on [1, 65, 3, 8, 8] with 12 Qwen rows (8
    valid) and 6 byT5 rows (3 valid) (K1 2, K2 / K3 1: the refiner K1
    only); LTX-Video on 2 x 4 x 4 tokens with a per-token t, 0 on the first
    frame (D3), and 12 T5 rows (8 valid) (4 / 4 / 4); LTX-2 on the same
    tokens with 20 caption rows (9 valid) (K1 3, K2 / K3 2: the connector K1
    only)."""
    gen = torch.Generator().manual_seed(SEED + 19)
    if family == "hunyuan_video_15":
        x = torch.randn((1, 65, 3, 8, 8), generator=gen)
        txt, byt5 = torch.randn((1, 12, 64), generator=gen), torch.randn((1, 6, 32), generator=gen)
        target = torch.randn((1, 32, 3, 8, 8), generator=gen)

        def inputs(dtype):
            return dict(x=x.to(dtype), t=torch.tensor([400.0]), text_states=txt.to(dtype),
                        text_mask=(torch.arange(12) < 8).to(torch.int32)[None],
                        byt5_states=byt5.to(dtype),
                        byt5_mask=(torch.arange(6) < 3).to(torch.int32)[None])

        expected = {"flash_fwd": 2, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    else:
        ltx = family == "ltx-video"
        x = torch.randn((1, 32, 128), generator=gen)
        rows, valid, width = (12, 8, 64) if ltx else (20, 9, 96)
        txt = torch.randn((1, rows, width), generator=gen)
        target = torch.randn((1, 32, 128), generator=gen)
        grid = torch.stack(torch.meshgrid(torch.arange(2.0) * (8 / 25 if ltx else 1 / 24),
                                          torch.arange(4.0) * (32 if ltx else 1),
                                          torch.arange(4.0) * (32 if ltx else 1),
                                          indexing="ij")).reshape(1, 3, -1)
        t = (torch.where(torch.arange(32) < 16, 0.0, 0.4)[None] if ltx
             else torch.tensor([0.4]))

        def inputs(dtype):
            return dict(x=x.to(dtype), prompt_embeds=txt.to(dtype),
                        prompt_mask=(torch.arange(rows) < valid).to(torch.int32)[None], t=t,
                        fractional_coords=grid)

        expected = ({"flash_fwd": 4, "flash_bwd_dq": 4, "flash_bwd_dkv": 4} if ltx
                    else {"flash_fwd": 3, "flash_bwd_dq": 2, "flash_bwd_dkv": 2})
    _reference_family(f"reference-{family.replace('_', '-')}",
                      functools.partial(_ltx_hv15_reference, family), inputs, target, device,
                      expected=expected)


LTX_VAE_CLIP = (1, 3, 121, 512, 768)   # -> [1, 128, 16, 16, 24]
LTX_VAE_LATENTS = [1, 128, *LTX_LATENTS]
LTX_VAE_CROP = (1, 3, 9, 256, 256)     # bf16 against f32 on the card


def phase_ltx_vae():
    """The published LTX encoder at the 0.9.0 widths (128 / 256 / 512 / 512,
    resnets (4, 3, 3, 3, 4), patch 4, 128 latent channels) from a seed, its
    encoder and statistics written in Lightricks' layout (`vae.` keys) to
    build/smoke/ltx_vae/ and read back by load_ltx_vae (the LTX drivers
    cache with it). In bf16 on the card: the 121-frame 768 x 512 clip
    encoded to [1, 128, 16, 16, 24], timed with the peak, and those latents
    decoded once by the JAX-form decoder (finite, the clip's shape); a
    9-frame 256 px crop encoded in bf16 and by the same weights in f32
    (TF32 off): relative L2 (WAN_VAE_REL_L2). Returns the folder."""
    from diffusion_pipe_tpu_torch import safetensors_io
    from diffusion_pipe_tpu_torch.models.ltx_vae import (LTXVAEConfig, LTXVideoVAE,
                                                         load_ltx_vae,
                                                         ltx_vae_state_dict_for_checkpoint)

    folder = _fresh_dir(SMOKE_DIR / "ltx_vae")
    t0 = time.perf_counter()
    with torch.device("cuda"):
        src = LTXVideoVAE(LTXVAEConfig())
    src.init_weights(torch.Generator(device="cuda").manual_seed(SEED))
    with torch.no_grad():  # statistics away from 0 and 1
        src.latents_mean.normal_(0.0, 0.1, generator=torch.Generator(device="cuda").manual_seed(1))
        src.latents_std.uniform_(0.5, 1.5, generator=torch.Generator(device="cuda").manual_seed(2))
    safetensors_io.save_file({f"vae.{k}": v.cpu() for k, v in
                              ltx_vae_state_dict_for_checkpoint(src).items()},
                             folder / "ltx_vae.safetensors")
    del src
    vae = load_ltx_vae(folder / "ltx_vae.safetensors", dtype=torch.bfloat16, device="cuda")
    write_read_s = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    clip = torch.rand(LTX_VAE_CLIP, generator=gen, device="cuda").mul_(2).sub_(1)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        z = vae.encode(clip)
        torch.cuda.synchronize()
        encode_ms = cuda_ms(lambda: vae.encode(clip), iters=1)
        encode_peak = torch.cuda.max_memory_allocated()
        del clip
        _free()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        x = vae.decode(z)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        decode_peak = torch.cuda.max_memory_allocated()
    shapes = (list(z.shape), list(x.shape))
    finite = bool(torch.isfinite(z).all() and torch.isfinite(x).all())
    del z, x
    _free()
    crop = torch.rand(LTX_VAE_CROP, generator=gen, device="cuda").mul_(2).sub_(1)
    with torch.no_grad():
        z = vae.encode(crop)
        vae.float()
        vae.config = dataclasses.replace(vae.config, dtype=torch.float32)
        z_ref = vae.encode(crop)
    rec = dict(clip_shape=list(LTX_VAE_CLIP), latent_shape=shapes[0], decoded_shape=shapes[1],
               encode_ms=encode_ms, decode_s=decode_s, encode_peak_memory_bytes=encode_peak,
               decode_peak_memory_bytes=decode_peak, write_read_s=write_read_s, finite=finite,
               params=sum(p.numel() for p in vae.encoder.parameters()),
               crop_shape=list(LTX_VAE_CROP), encode_rel_l2=_rel_l2(z, z_ref))
    del vae, crop, z, z_ref
    _free()
    emit(phase="ltx-vae", **rec)
    check(rec["latent_shape"] == LTX_VAE_LATENTS and rec["decoded_shape"] == list(LTX_VAE_CLIP)
          and finite, f"ltx-vae shapes {rec['latent_shape']} / {rec['decoded_shape']}")
    check(rec["encode_rel_l2"] <= WAN_VAE_REL_L2,
          f"ltx-vae bf16 off f32: {rec['encode_rel_l2']}")
    return folder


# google/gemma-3-12b-pt's text_config: 48 layers, 3,840 wide, 16 query heads
# and 8 KV heads of 256, MLP 15,360, five sliding layers in six (a 1,024-
# token window, local base 10,000), global base 10^6 with linear factor 8
GEMMA3_12B = {"model_type": "gemma3_text", "vocab_size": 262208, "hidden_size": 3840,
              "intermediate_size": 15360, "num_hidden_layers": 48, "num_attention_heads": 16,
              "num_key_value_heads": 8, "head_dim": 256, "query_pre_attn_scalar": 256,
              "sliding_window": 1024, "sliding_window_pattern": 6,
              "rope_local_base_freq": 10000.0, "rope_theta": 1000000.0,
              "rope_scaling": {"rope_type": "linear", "factor": 8.0}, "rms_norm_eps": 1e-6}


def phase_gemma3():
    """LTX-2's text function (LLMTextEncoder, the last hidden state, 512
    rows) on Gemma-3-12B at its published size (GEMMA3_12B through
    from_hf_config) from a seed, bf16: 2 x 512 ids (the second padded after
    60), [2, 512, 3,840], timed with the peak. A narrow 48-layer copy (256
    wide) bf16 on the card against f32 on the CPU (rel L2 < 3e-2)."""
    from diffusion_pipe_tpu_torch.models.llm_encoders import (CausalLM, CausalLMConfig,
                                                              LLMTextEncoder)

    def encoder(cfg, dev, seed):
        with torch.device("meta"):
            lm = CausalLM(cfg)
        lm = lm.to_empty(device=dev)
        lm.init_weights(torch.Generator(device=dev).manual_seed(seed))
        enc = LLMTextEncoder(".", max_length=LTX2_GEMMA, hidden_layer=-1, dtype=cfg.dtype,
                             device=dev)
        enc.model = lm.eval().requires_grad_(False)
        return enc

    full = CausalLMConfig.from_hf_config(GEMMA3_12B, dtype=torch.bfloat16)
    check(full.num_layers == 48 and full.layer_types.count("full") == 8
          and full.rope_scaling_factor == 8.0, f"Gemma 3 config {full}")
    gen = torch.Generator().manual_seed(SEED + 3)
    narrow = dict(vocab=1024, dim=256, num_heads=4, num_kv_heads=2, head_dim=64, ffn_dim=512)
    ids = torch.randint(0, 1024, (1, 96), generator=gen)
    mask = torch.ones_like(ids)
    ref_enc = encoder(dataclasses.replace(full, dtype=torch.float32, param_dtype=torch.float32,
                                          **narrow), "cpu", SEED)
    card_enc = encoder(dataclasses.replace(full, **narrow), "cpu", SEED)
    card_enc.model.to("cuda")
    with torch.no_grad():
        ref = ref_enc.hidden_states(ids, mask)
        got = card_enc.hidden_states(ids.cuda(), mask.cuda()).float().cpu()
    narrow_err = _rel(got, ref)
    del ref_enc, card_enc
    _free()

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    enc = encoder(full, "cuda", SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ids = torch.randint(0, full.vocab, (2, LTX2_GEMMA), generator=gen).cuda()
    mask = torch.ones_like(ids)
    mask[1, LTX2_GEMMA_VALID:] = 0
    with torch.no_grad():
        h = enc.hidden_states(ids, mask)
        torch.cuda.synchronize()
        encode_ms = cuda_ms(lambda: enc.hidden_states(ids, mask), iters=3)
    finite = bool(torch.isfinite(h[mask.bool()]).all())
    emit(phase="gemma3-12b", source="google/gemma-3-12b-pt config.json text_config",
         params=sum(p.numel() for p in enc.model.parameters()), init_s=init_s,
         encode_ms=encode_ms, shape=list(h.shape), finite=finite,
         peak_memory_bytes=torch.cuda.max_memory_allocated(), narrow_rel_l2=narrow_err)
    check(list(h.shape) == [2, LTX2_GEMMA, 3840] and finite, f"Gemma 3 states {list(h.shape)}")
    check(narrow_err < 3e-2, f"narrow Gemma 3 bf16 vs f32: rel L2 {narrow_err}")
    del enc, h
    _free()


HV15_LORA_CONFIG = {  # hunyuan-video-15-lora-512x33
    "save_every_n_epochs": 1,
    "model": {"type": "hunyuan_video_15", "dtype": "bfloat16",
              "timestep_sample_method": "logit_normal"},
    "adapter": {"type": "lora", "rank": 32, "alpha": 32, "dropout": 0.0, "dtype": "bfloat16"},
    "optimizer": {"type": "adamw8bit", "lr": 2e-5},
    "gradient_clipping": 1.0,
    "activation_checkpointing": True,
}
LTX_LORA_CONFIG = {  # ltx-video-2b-lora-768x512x121
    "save_every_n_epochs": 1,
    "model": {"type": "ltx-video", "dtype": "bfloat16", "first_frame_conditioning_p": 0.5},
    "adapter": {"type": "lora", "rank": 32, "alpha": 32, "dropout": 0.0, "dtype": "bfloat16"},
    "optimizer": {"type": "adamw8bit", "lr": 2e-5},
    "gradient_clipping": 1.0,
    "activation_checkpointing": True,
}
LTX2_LORA_CONFIG = {  # ltx2-lora-768x512x121-fp8
    "save_every_n_epochs": 1,
    "model": {"type": "ltx2", "dtype": "bfloat16", "transformer_dtype": "float8",
              "cross_attention_dim": 3840},
    "adapter": {"type": "lora", "rank": 32, "alpha": 32, "dropout": 0.0, "dtype": "bfloat16"},
    "optimizer": {"type": "adamw8bit", "lr": 2e-5},
    "gradient_clipping": 1.0,
    "activation_checkpointing": True,
}


def build_ltx_hv15_slice(family, cfg, device="cuda", latent=None, txt=None, byt5=None,
                         batch_size=1):
    """HunyuanVideo-1.5 ([B, 32, *latent] latents, txt = (rows, valid) Qwen
    rows of the text width, byt5 = (rows, valid) byT5 rows of 1,472),
    LTX-Video ([B, 128, *latent], T5 rows of 4,096 and their mask) or LTX-2
    (Gemma rows of cross_attention_dim and their mask) at the config's size,
    the padded rows zero."""
    hv15 = family == "hunyuan_video_15"
    latent = latent or ((9, 32, 32) if hv15 else LTX_LATENTS)

    def make_batch(pipeline, gen):
        c = getattr(pipeline, "hv15_config", None) or getattr(pipeline, "ltx_config", None) \
            or pipeline.ltx2_config

        def r(*shape):
            return torch.randn((batch_size, *shape), generator=gen, device=device)

        def rows(n, valid, width):
            m = (torch.arange(n, device=device) < valid).to(torch.int32)
            m = m.expand(batch_size, -1).clone()
            return (r(n, width) * m[..., None]).to(c.dtype), m

        if hv15:
            states, mask = rows(*(txt or (HV15_TXT, HV15_VALID)), c.text_dim)
            glyph, glyph_mask = rows(*(byt5 or (HV15_BYT5, HV15_BYT5_VALID)), c.byt5_dim)
            return {"latents": r(c.out_channels, *latent), "text_states": states,
                    "text_mask": mask, "byt5_states": glyph, "byt5_mask": glyph_mask}
        if family == "ltx-video":
            states, mask = rows(*(txt or (LTX_T5, LTX_T5_VALID)), c.caption_dim)
            return {"latents": r(c.in_channels, *latent), "prompt_embeds": states,
                    "prompt_attention_mask": mask}
        states, mask = rows(*(txt or (LTX2_GEMMA, LTX2_GEMMA_VALID)), c.cross_attention_dim)
        return {"latents": r(c.in_channels, *latent), "text_embeds_0": states,
                "attention_mask_0": mask}

    return _build_family_slice(family, cfg, device, make_batch)


def _hv15_no_gradient(num_layers):
    """HunyuanVideo-1.5 has no single block: the last double block's text
    stream after its attention never reaches the loss, so those LoRA B
    factors keep their zero init (the JAX module computes the same)."""
    last = f"double_blocks.{num_layers - 1}."
    return tuple(last + n for n in ("txt_attn_proj.", "txt_mlp_fc1.", "txt_mlp_fc2."))


LTX_HV15_CELLS = {  # family: (phase, cell, config)
    "hunyuan_video_15": ("slice-hunyuan-video-15-lora", "hunyuan-video-15-lora-512x33",
                         HV15_LORA_CONFIG),
    "ltx-video": ("slice-ltx-video-lora", "ltx-video-2b-lora-768x512x121", LTX_LORA_CONFIG),
    "ltx2": ("slice-ltx2-lora", "ltx2-lora-768x512x121-fp8", LTX2_LORA_CONFIG)}


def phase_slice_ltx_hv15(family, build=None, device="cuda", no_gradient=None):
    """hunyuan-video-15-lora-512x33: HunyuanVideo-1.5 at the 8.3 B reading (54
    double blocks of 2,048) in bf16, LoRA r32 bf16, adamw8bit, logit_normal,
    `true`, one 33-frame 512 px clip ([1, 32, 9, 32, 32]: 9,216 image rows)
    with 966 Qwen rows (80 valid) and 128 byT5 rows (12 valid): 110 / 54 /
    54 launches a step (the refiner K1 alone); ltx-video-2b-lora-768x512x121:
    LTX-Video 2 B (28 blocks of 2,048) in bf16, LoRA r32, adamw8bit, `true`,
    first_frame_conditioning_p 0.5, one 121-frame 768 x 512 clip ([1, 128,
    16, 16, 24]: 6,144 tokens) with 128 T5 rows (40 valid): 112 / 56 / 56;
    ltx2-lora-768x512x121-fp8: LTX-2's video path (48 blocks of 4,096, 12.9
    B) with fp8 block weights, the same clip, 512 Gemma rows of 3,840 (60
    valid): 194 / 96 / 96 (the connector K1 alone). build / device /
    no_gradient: another size (a CPU rehearsal)."""
    phase, cell, cfg = LTX_HV15_CELLS[family]
    hv15 = family == "hunyuan_video_15"

    def after(pipeline, batch, gen):
        with torch.no_grad():
            inputs, target, _ = pipeline.prepare_inputs(batch, gen)
            out = pipeline.forward(inputs)
        lat = batch["latents"]
        shape = list(lat.shape) if hv15 else [lat.shape[0], math.prod(lat.shape[2:]),
                                              lat.shape[1]]
        check(list(out.shape) == list(target.shape) == shape and bool(torch.isfinite(out).all()),
              f"output {list(out.shape)}")
        rows = math.prod(lat.shape[2:]) + (
            batch["text_states"].shape[1] + batch["byt5_states"].shape[1] if hv15 else 0)
        return dict(sequence=rows, output_shape=list(out.shape),
                    per_token_t=list(inputs["t"].shape) if family == "ltx-video" else None)

    if no_gradient is None:
        no_gradient = _hv15_no_gradient(54) if hv15 else ("none",)
    counts, _, _ = phase_slice_family(
        phase, cell, build or functools.partial(build_ltx_hv15_slice, family, cfg),
        timed_steps=NEW_TIMED_STEPS, device=device, expected_fn=_flash_step,
        no_gradient=no_gradient, after=after, may_stay=NEW_MAY_STAY)
    return counts


def _edited(text: str, *pairs: tuple) -> str:
    """text with each (old, new) replaced in turn; an `old` that is not there
    raises, so a change to the template cannot leave a driver's TOML
    quietly unedited."""
    for old, new in pairs:
        if old not in text:
            raise ValueError(f"{old!r} is not in the driver TOML")
        text = text.replace(old, new)
    return text


HV15_DRIVER_TOML = _edited(
    FLUX2_DRIVER_TOML,
    ("flux2-dev-lora-1024-fp8-int8's trainer", "hunyuan-video-15-lora-512x33's trainer"),
    ("2 + 2 blocks", "2 double blocks, 9-frame clips"),
    ('type = "flux2"', 'type = "hunyuan_video_15"'),
    ('transformer_dtype = "float8"\n', ""), ("num_single_layers = 2\n", ""))
LTX_DRIVER_TOML = _edited(
    HV15_DRIVER_TOML,
    ("hunyuan-video-15-lora-512x33's trainer", "ltx-video-2b-lora-768x512x121's trainer"),
    ("2 double blocks", "2 blocks, first_frame_conditioning_p 1"),
    ('type = "hunyuan_video_15"', 'type = "ltx-video"\nfirst_frame_conditioning_p = 1.0'))
LTX2_DRIVER_TOML = _edited(
    HV15_DRIVER_TOML,
    ("hunyuan-video-15-lora-512x33's trainer", "ltx2-lora-768x512x121-fp8's trainer"),
    ("2 double blocks", "2 blocks, fp8 storage"),
    ('type = "hunyuan_video_15"',
     'type = "ltx2"\ntransformer_dtype = "float8"\ncross_attention_dim = 3840'))
LTX_HV15_DRIVER_TOMLS = {"hunyuan_video_15": HV15_DRIVER_TOML, "ltx-video": LTX_DRIVER_TOML,
                         "ltx2": LTX2_DRIVER_TOML}
CLIP_FRAMES = 9  # the LTX and HunyuanVideo-1.5 drivers cache each picture as a 9-frame clip


def _clip_vae_fn(fn):
    """The pipeline's VAE fn over each picture as a 9-frame clip, the picture
    rolled 8 px to the right a frame (the card's machine decodes no video
    file: no imageio)."""
    import numpy as np

    def clip_fn(pixels):
        px = np.asarray(pixels, np.float32)
        if px.ndim == 5 and px.shape[2] == 1:
            px = px[:, :, 0]
        if px.ndim == 4:
            px = np.stack([np.roll(px, 8 * i, axis=-1) for i in range(CLIP_FRAMES)], axis=2)
        return fn(px)

    return clip_fn


def _ltx_hv15_text_stand_in(family):
    """Seeded text at the cached shapes: HunyuanVideo-1.5's Qwen rows [966,
    3,584] (80 valid) and byT5 rows [128, 1,472] (12 valid); LTX-Video's T5
    rows [128, 4,096] (40 valid); LTX-2's Gemma rows [512, 3,840] (60
    valid)."""
    from diffusion_pipe_tpu_torch.models.text_encoders import seeded_draws

    def rows(caps, key, n, valid, width):
        m = (torch.arange(n) < valid).to(torch.int32).expand(len(caps), -1).clone()
        return seeded_draws(caps, key, (n, width)) * m[..., None], m

    def fn(caps):
        if family == "hunyuan_video_15":
            states, mask = rows(caps, "qwen", HV15_TXT, HV15_VALID, 3584)
            glyph, glyph_mask = rows(caps, "byt5", HV15_BYT5, HV15_BYT5_VALID, 1472)
            return {"text_states": states, "text_mask": mask, "byt5_states": glyph,
                    "byt5_mask": glyph_mask}
        if family == "ltx-video":
            states, mask = rows(caps, "t5", LTX_T5, LTX_T5_VALID, 4096)
            return {"prompt_embeds": states, "prompt_attention_mask": mask}
        states, mask = rows(caps, "gemma", LTX2_GEMMA, LTX2_GEMMA_VALID, 3840)
        return {"text_embeds_0": states, "attention_mask_0": mask}

    return [fn]


def _write_hv15_vae(folder):
    """A seeded HunyuanVideo-1.5-shaped causal VAE (32 latent channels, five
    blocks of 64 / 128 / 256 / 256 / 256, one resnet each: 16x in space, 4x
    in time; narrower than the published one) in diffusers' layout."""
    from diffusion_pipe_tpu_torch import safetensors_io
    from diffusion_pipe_tpu_torch.models.hunyuan_vae import HunyuanVAE, HunyuanVAEConfig

    folder.mkdir(parents=True)
    vae = HunyuanVAE(HunyuanVAEConfig(latent_channels=32, layers_per_block=1,
                                      block_out_channels=(64, 128, 256, 256, 256)))
    vae.init_weights(torch.Generator().manual_seed(SEED))
    safetensors_io.save_file({k: v.contiguous() for k, v in vae.state_dict().items()},
                             folder / "diffusion_pytorch_model.safetensors")
    return folder


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def kernels_line(timings, sr_timing, int8_timing, flux_counts, fp8_counts, wan_counts,
                 driver_counts, ptxas, more_counts, qwen_int8_timing, flux2_int8_timing,
                 d256, padded):
    """One entry per kernel. K1-K4 at the Wan path's shape (K1-K3: the
    cross-attention shape, where the plain version fits; K4: ffn_in with a
    bf16 update), launches from the Wan path's timed steps, and the same
    kernel's numbers at the other shapes beside, with the Flux paths'
    launches (bf16 and fp8-int8). H1 and H2 (which replace no Pallas kernel)
    at the fp8-int8 Flux path's ff_in shape, launches from its timed steps
    (H1's dgrad case beside). launches_driver: each kernel's launches in
    the driver phase's two train.main calls (bench.py's Flux row through
    the training driver, eval included). Each carries its share of the bound (bound_ms /
    ms); K1 its factor against SDPA's forward (library_factor), K3 the
    factor of K2 + K3 against SDPA's backward; K1, K2 and K3 the ptxas
    registers, spills and wgmma serialization of their bf16, D = 128
    build. more_counts: {key: launches of another Wan path} (the LoRA,
    driver-wan, i2v and ti2v cells), added to each entry under its key;
    K1-K3 also carry their numbers at the i2v / flf2v image cross shapes,
    and those of SDXL, SD3, Chroma, Qwen-Image, FLUX.2, AuraFlow (D 256),
    Lumina 2 (D 96), OmniGen2 (D 120), HiDream, the Cosmos and the Hunyuan
    families, and the source and ptxas record of their bf16 D 256 build
    (d256) and of the bf16 D 128 instance that runs D 96 and 120 (padded);
    H1 and H2 theirs at Qwen-Image's ff_in (qwen_int8_timing) and FLUX.2's
    linear1 (flux2_int8_timing)."""
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err")
    extra = ("bound_share", "library_factor", "k2_k3_factor_vs_sdpa_bwd", "sdpa_bwd_ms")

    def pick(timing):
        return {k: timing[k] for k in keys + ("bound_share",)}

    kernels = []
    for name, (src, replaces) in KERNEL_SOURCES.items():
        launches = wan_counts[name]
        if name == "sr_add":
            main = dict(sr_timing["bf16_u"])
            main["bound_share"] = main["bound_ms"] / main["ms"]
            beside = {"f32_u": {k: sr_timing["f32_u"][k] for k in keys}}
        elif name == "quant_rows":
            main = int8_timing[name]["forward_ff_in"]
            beside = {"dgrad_ff_in": pick(int8_timing[name]["dgrad_ff_in"]),
                      "qwen_forward_ff_in": pick(qwen_int8_timing[name]["forward_ff_in"]),
                      "qwen_dgrad_ff_in": pick(qwen_int8_timing[name]["dgrad_ff_in"]),
                      "flux2_forward_linear1": pick(flux2_int8_timing[name]["forward_linear1"]),
                      "flux2_dgrad_linear1": pick(flux2_int8_timing[name]["dgrad_linear1"])}
            launches = fp8_counts[name]
        elif name == "rescale_i32":
            main, launches = int8_timing[name], fp8_counts[name]
            beside = {"qwen_ff_in": pick(qwen_int8_timing[name]),
                      "flux2_linear1": pick(flux2_int8_timing[name])}
        else:
            main = timings["wan_cross"][name]
            beside = {shape: {k: timings[shape][name][k] for k in keys + extra
                              if k in timings[shape][name]}
                      for shape in ("wan_self", "flux") + tuple(c for c, _ in I2V_CASES)
                      + tuple(c for c, _ in SDXL_KERNEL_CASES)
                      + tuple(c[0] for c in SD3_CHROMA_KERNEL_CASES)
                      + tuple(c[0] for c in QWEN_KERNEL_CASES)
                      + tuple(c[0] for c in FLUX2_AURAFLOW_KERNEL_CASES)
                      + tuple(c[0] for c in LUMINA_KERNEL_CASES)
                      + tuple(c[0] for c in HIDREAM_KERNEL_CASES)
                      + tuple(c[0] for c in COSMOS_KERNEL_CASES)
                      + tuple(c[0] for c in HUNYUAN_KERNEL_CASES)
                      + tuple(c[0] for c in LTX_HV15_KERNEL_CASES)}
            beside["flux"]["launches"] = flux_counts[name]
            beside["flux"]["launches_fp8_int8_attn"] = fp8_counts[name]
        entry = dict(name=name, route="cuda", source=src, replaces=replaces,
                     launches=launches, launches_driver=driver_counts[name],
                     **{key: counts[name] for key, counts in more_counts.items()},
                     **{k: main[k] for k in keys},
                     **{k: main[k] for k in extra if k in main})
        if name in FLASH:
            entry["ptxas_bf16_d128"] = main_ptxas(ptxas.get(name, {}))
            entry["source_d256"] = D256_KERNELS[name][2]
            entry["ptxas_bf16_d256"] = d256.get(name)
            entry["ptxas_bf16_d96_d120"] = padded.get(name)
        entry["at_other_shapes"] = beside
        kernels.append(entry)
    return json.dumps({"kernels": kernels})


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (ROOT / "diffusion_pipe_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi_line()
    emit(phase="device", name=torch.cuda.get_device_name(0), nvidia_smi=card,
         torch=torch.__version__, cuda=torch.version.cuda)

    ptxas = phase_build()
    timings = phase_kernels()
    timings.update(phase_kernels_i2v())
    sr_timing = phase_sr_kernel()
    int8_timing = phase_int8_kernels()
    phase_reference()
    flux_counts, bf16_peak, _ = phase_slice()
    _free()
    fp8_counts, _, fp8_step_s = phase_slice(
        phase="slice-fp8-int8", cell="flux-dev-lora-512-fp8-int8", cfg=FP8_INT8_CONFIG,
        bf16_peak=bf16_peak, attn_vs_true=True)
    _free()
    lokr_counts, *_ = phase_slice(phase="slice-flux-lokr", cell="flux-dev-lokr-512-fp8-int8",
                                  cfg=LOKR_CONFIG, every_moved=True)
    _free()
    sample_counts = phase_sample()
    vae_dir = phase_vae()
    _free()
    driver_counts = phase_driver(vae_dir, fp8_step_s)
    _free()
    phase_reference_wan()
    wan_counts, *_ = phase_slice_wan()
    _free()
    wan_lora_counts, *_ = phase_slice_wan(phase="slice-wan-lora", cell="wan-1.3b-t2v-lora-attn",
                                         cfg=WAN_LORA_CONFIG, timed_steps=TIMED_STEPS)
    _free()
    phase_umt5()
    phase_clip_vision()
    wan_vae_path = phase_wan_vae()
    driver_wan_counts = phase_driver_wan(wan_vae_path)
    _free()
    i2v_counts, *_ = phase_slice_wan(phase="slice-wan-i2v", cell="wan-i2v-14b-lora-attn",
                                     cfg=_variant_config("i2v-14b"), latent_fhw=(21, 60, 104))
    _free()
    ti2v_counts, *_ = phase_slice_wan(phase="slice-wan-ti2v", cell="wan-ti2v-5b-lora-attn",
                                      cfg=_variant_config("ti2v-5b"), latent_fhw=(31, 44, 80))
    _free()
    phase_slice_wan_policies()
    optimizer_counts = phase_optimizers()
    _free()
    sdxl_t0 = time.perf_counter()
    timings.update(phase_kernels_sdxl())
    phase_reference_sdxl()
    sdxl_lora_counts, *_ = phase_slice_sdxl()
    _free()
    sdxl_full_counts, *_ = phase_slice_sdxl(
        phase="slice-sdxl-fullft", cell="sdxl-fullft", cfg=SDXL_FULLFT_CONFIG,
        timed_steps=SDXL_FULLFT_STEPS - 1, batch_size=1)
    _free()
    driver_sdxl_counts = phase_driver_sdxl()
    _free()
    emit(phase="sdxl-phases", seconds=time.perf_counter() - sdxl_t0)
    sd3_t0 = time.perf_counter()
    timings.update(phase_kernels_sd3_chroma())
    phase_reference_sd3()
    phase_reference_chroma()
    sd3_counts, *_ = phase_slice_family("slice-sd3-lora", "sd3-medium-lora-1024",
                                        build_sd3_slice)
    _free()
    chroma_counts, *_ = phase_slice_family("slice-chroma-lora", "chroma-lora-512",
                                           build_chroma_slice)
    _free()
    driver_sd3_counts = phase_driver_family("sd3")
    _free()
    driver_chroma_counts = phase_driver_family("chroma", vae_dir)
    _free()
    emit(phase="sd3-chroma-phases", seconds=time.perf_counter() - sd3_t0)
    qwen_t0 = time.perf_counter()
    qwen_timings, qwen_int8 = phase_kernels_qwen()
    timings.update(qwen_timings)
    phase_reference_qwen()
    qwen_counts = phase_slice_qwen()
    _free()
    qwen_edit_counts = phase_slice_qwen(edit=True)
    _free()
    phase_qwen25vl()
    _free()
    driver_qwen_counts = phase_driver_qwen()
    _free()
    emit(phase="qwen-phases", seconds=time.perf_counter() - qwen_t0)
    new_t0 = time.perf_counter()
    new_timings, flux2_int8, d256 = phase_kernels_flux2_auraflow(ptxas)
    timings.update(new_timings)
    phase_reference_flux2()
    phase_reference_auraflow()
    flux2_counts = phase_slice_flux2()
    _free()
    flux2_edit_counts = phase_slice_flux2(edit=True)
    _free()
    auraflow_counts = phase_slice_auraflow()
    _free()
    phase_mistral3()
    phase_pile_t5()
    driver_flux2_counts = phase_driver_family("flux2")
    _free()
    driver_auraflow_counts = phase_driver_family("auraflow")
    _free()
    emit(phase="flux2-auraflow-phases", seconds=time.perf_counter() - new_t0)
    lumina_t0 = time.perf_counter()
    lumina_timings, padded = phase_kernels_lumina(ptxas)
    timings.update(lumina_timings)
    for family in ("lumina_2", "z_image", "omnigen2"):
        phase_reference_lumina(family)
        _free()
    lumina2_counts = phase_slice_lumina("lumina_2")
    _free()
    omnigen2_counts = phase_slice_lumina("omnigen2")
    _free()
    driver_lumina2_counts = phase_driver_family("lumina_2", vae_dir)
    _free()
    driver_zimage_counts = phase_driver_family("z_image", vae_dir)
    _free()
    emit(phase="lumina-phases", seconds=time.perf_counter() - lumina_t0)
    hidream_t0 = time.perf_counter()
    timings.update(phase_kernels_hidream())
    phase_reference_hidream()
    phase_llama31()
    hidream_counts = phase_slice_hidream()
    _free()
    driver_hidream_counts = phase_driver_family("hidream", vae_dir)
    _free()
    emit(phase="hidream-phases", seconds=time.perf_counter() - hidream_t0)
    cosmos_t0 = time.perf_counter()
    timings.update(phase_kernels_cosmos())
    phase_reference_cosmos()
    phase_qwen3()
    tokenizer_path = phase_cosmos_tokenizer()
    anima_counts = phase_slice_cosmos("anima")
    _free()
    cosmos1_counts = phase_slice_cosmos("cosmos")
    _free()
    driver_anima_counts = phase_driver_family("anima", wan_vae_path)
    _free()
    driver_predict2_counts = phase_driver_family("cosmos_predict2", wan_vae_path)
    _free()
    driver_cosmos_counts = phase_driver_family("cosmos", tokenizer_path)
    _free()
    emit(phase="cosmos-phases", seconds=time.perf_counter() - cosmos_t0)
    hunyuan_t0 = time.perf_counter()
    timings.update(phase_kernels_hunyuan())
    phase_reference_hunyuan("hunyuan-video")
    phase_reference_hunyuan("hunyuan_image")
    hunyuan_vae_path = phase_hunyuan_vae()
    phase_llava_llama3()
    phase_byt5()
    hunyuan_video_counts = phase_slice_hunyuan("hunyuan-video")
    _free()
    hunyuan_image_counts = phase_slice_hunyuan("hunyuan_image")
    _free()
    driver_hunyuan_video_counts = phase_driver_family("hunyuan-video", hunyuan_vae_path)
    _free()
    driver_hunyuan_image_counts = phase_driver_family("hunyuan_image")
    _free()
    emit(phase="hunyuan-phases", seconds=time.perf_counter() - hunyuan_t0)
    ltx_t0 = time.perf_counter()
    timings.update(phase_kernels_ltx_hv15())
    for family in LTX_HV15_CELLS:
        phase_reference_ltx_hv15(family)
        _free()
    ltx_vae_path = phase_ltx_vae()
    phase_gemma3()
    ltx_hv15_counts = {}
    for family in LTX_HV15_CELLS:
        ltx_hv15_counts[family] = phase_slice_ltx_hv15(family)
        _free()
    driver_hv15_counts = phase_driver_family("hunyuan_video_15")
    _free()
    driver_ltx_counts = phase_driver_family("ltx-video", ltx_vae_path)
    _free()
    driver_ltx2_counts = phase_driver_family("ltx2", ltx_vae_path)
    _free()
    emit(phase="ltx-hv15-phases", seconds=time.perf_counter() - ltx_t0)

    more = {"launches_wan_lora": wan_lora_counts, "launches_driver_wan": driver_wan_counts,
            "launches_wan_i2v": i2v_counts, "launches_wan_ti2v": ti2v_counts,
            "launches_flux_lokr": lokr_counts, "launches_sample": sample_counts,
            "launches_optimizers": optimizer_counts, "launches_sdxl_lora": sdxl_lora_counts,
            "launches_sdxl_fullft": sdxl_full_counts, "launches_driver_sdxl": driver_sdxl_counts,
            "launches_sd3_lora": sd3_counts, "launches_chroma_lora": chroma_counts,
            "launches_driver_sd3": driver_sd3_counts,
            "launches_driver_chroma": driver_chroma_counts,
            "launches_qwen_image_lora": qwen_counts, "launches_qwen_image_edit": qwen_edit_counts,
            "launches_driver_qwen": driver_qwen_counts,
            "launches_flux2_dev_lora": flux2_counts, "launches_flux2_dev_edit": flux2_edit_counts,
            "launches_auraflow_lora": auraflow_counts,
            "launches_driver_flux2": driver_flux2_counts,
            "launches_driver_auraflow": driver_auraflow_counts,
            "launches_lumina2_lokr": lumina2_counts, "launches_omnigen2_lora": omnigen2_counts,
            "launches_driver_lumina2": driver_lumina2_counts,
            "launches_driver_zimage": driver_zimage_counts,
            "launches_hidream_lora": hidream_counts,
            "launches_driver_hidream": driver_hidream_counts,
            "launches_anima_lora": anima_counts, "launches_cosmos1_lora": cosmos1_counts,
            "launches_driver_anima": driver_anima_counts,
            "launches_driver_predict2": driver_predict2_counts,
            "launches_driver_cosmos": driver_cosmos_counts,
            "launches_hunyuan_video_lora": hunyuan_video_counts,
            "launches_hunyuan_image_lora": hunyuan_image_counts,
            "launches_driver_hunyuan_video": driver_hunyuan_video_counts,
            "launches_driver_hunyuan_image": driver_hunyuan_image_counts,
            "launches_hunyuan_video_15_lora": ltx_hv15_counts["hunyuan_video_15"],
            "launches_ltx_video_lora": ltx_hv15_counts["ltx-video"],
            "launches_ltx2_lora": ltx_hv15_counts["ltx2"],
            "launches_driver_hunyuan_video_15": driver_hv15_counts,
            "launches_driver_ltx_video": driver_ltx_counts,
            "launches_driver_ltx2": driver_ltx2_counts}
    print(kernels_line(timings, sr_timing, int8_timing, flux_counts, fp8_counts, wan_counts,
                       driver_counts, ptxas, more, qwen_int8, flux2_int8, d256, padded))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
