#!/usr/bin/env python3
"""Drive the PyTorch port (mld_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (non-zero exit, no result line):
  1. device: require CUDA; print the nvidia-smi name/power-limit line and the
     TF32 settings of the run;
  2. build: compile the CUDA kernels from mld_tpu_torch/csrc/ with nvcc for
     sm_90a (one nvcc a source, in parallel) and print the build time, the
     ptxas register / shared-memory lines and each kernel's tensor-core
     instructions in its SASS (HMMA from mma.sync, HGMMA from wgmma);
  3. kernel vs plain, each kernel against its plain PyTorch version on the
     card at the main path's shapes, with times (CUDA events over many
     launches after a warm-up), the device time alone (torch.profiler: the
     host's time between launches bounds calls of microseconds) and each
     kernel's bound (its bytes over the memory rate or its operations over
     the peak of the units it runs them on, whichever is larger); where one
     PyTorch call computes the same function (K3, K4:
     scaled_dot_product_attention, which the port never calls), that call's
     times and, at the main shape, the device kernels it ran (its backend);
     each wrapper call compared must launch its kernel once (K5: the C
     entry's count of kernels too):
       K1 skip_encoder  the denoiser stack (S=3, D=256, H=4, F=1024, L=9),
                        f32 and bf16 weights, up to the evaluation's 64 and
                        1,920 sequences; and mld_humanact12's L=15 stack at
                        64 and 256 sequences;
       K2 encoder_layer one fused layer (S=3, the same widths), 2 and 256
                        sequences, f32 and bf16 weights;
       K5 skip_decoder  the VAE decoder stack (T=196, D=256, H=4, F=1024,
                        L=9) at B=1, 6, 128 with the demo prompts' lengths,
                        f32 and bf16 weights, and once with 2 latent tokens;
                        the device kernels of one B=128 call in each arm
                        counted by torch.profiler against the C entry's
                        count, with their device ms split into GEMMs,
                        attention and the rest;
       K4 flash_causal  CLIP causal attention [128, 12, S, 64] for
                        S = 8, 16, 32, 64, 77, and the MultiModality batch's
                        960 prompts at S = 16, f32 and bf16;
       K3 flash_attention  bidirectional attention at the shapes of the
                        raw-motion denoiser (self-attention [2B, 4, T, 128]
                        for T = 512, 196; cross-attention to 2 keys) and of
                        the plain VAE decode ([128, 4, 196, 64] and the
                        evaluation's [960, 4, 196, 64] under the frame mask;
                        1 key) and of the ACTOR VAE ([128, 4, 60, 64] under
                        a ragged frame mask, to 1 key, and the encoder's
                        [128, 4, 62, 64]) and of the text-family options
                        (phase 10: the hidden-mode denoiser [256, 4, 79,
                        64], the plain-encoder denoiser [256, 4, 3, 64],
                        the latent trans_dec's [256, 4, 1, 64] to 1 and 2
                        keys, the all_encoder decode [128, 4, 197, 64]
                        under [1; mask], raw motion's trans_enc [256, 4,
                        198, 128]), on views into packed projections
                        as the model hands them over, plus ragged cases
                        with a fully masked example (Sq and Sk off every
                        tile, Dh = 4 and 68), f32 and bf16;
     and the bf16 rounding check: K2 and K5 cut to one layer, whose RMS
     error must stay below a bar that the plain version of a kernel without
     the activation rounding, and of f32 weights, both exceed on the card;
  4. main path: MLD for the mld_humanml3d preset at full width from seeded
     random weights, first in the default configuration (K1, K4, and K3 in
     the plain VAE decode), then with fused_decode=True (K1, K4, K5): the
     prompts of demo/example.txt through MLD.generate, then one
     generate_joints at B=128 and 3 timed calls; checks shapes, finiteness,
     masking and the launch counts per call (K1 50; K4 24 = 12 layers x 2
     tower calls; K3 18 = 9 decoder layers x 2, or 0; K5 1 entry call, and
     the kernels the C entry counted in it); times the text tower and the
     VAE decode alone at B=128; then holds the card's joints for one prompt
     against the same model on the CPU (plain versions, f32 text tower), in
     each configuration;
  5. raw-motion path: MLD for novae_humanml3d and novae_stress_s512 (no VAE,
     trans_dec denoiser 9x512, DDPM-1000, CFG 7.5) at full width: the demo
     prompts through MLD.generate (lengths scaled by 512/196 for s512), then
     one timed generate_joints on them; launch counts per call (K3 18,000 =
     1000 steps x 9 layers x 2, K4 24, K1 and K5 0); a torch.profiler trace
     of 20 sampling steps of each for device busy time; then the card's
     joints for one prompt of s512 against the CPU's (plain versions, f32
     text tower), same weights, initial latents and step noise, with the
     schedule cut to 10 train timesteps;
  6. training (mld_tpu_torch.train.loop.train, the port's entry point, at
     full width with dropout 0.1, B=64): builds the synthetic corpus with
     the port's build_synthetic_dataset into build/ (128 clips: 64, the JAX
     package's debug count, leave 44 training clips, less than one batch),
     trains the vae stage and resumes it once from its checkpoint, hands
     the VAE to the diffusion stage (pretrained_vae), then runs
     vae_diffusion (each of its steps a DDIM-50 generation pass); per
     stage: finite losses, frozen params bit-identical, trainable params
     moved, the launches of every step equal to the counts derived from the
     config (vae 0; diffusion K4 24, K3 9; vae_diffusion K4 48, K3 27, K1
     50), the median ms a step (each ending in torch.cuda.synchronize()),
     the device busy share of torch.profiler-traced steps and the host ops
     with the most self time in them; then one diffusion step with dropout 0,
     where the denoiser's attention runs K3 through its autograd.Function,
     held against the same step on the plain attention on the card, and one
     full-width diffusion step at B=8 on the card against the CPU;
  7. evaluation (mld_tpu_torch.eval.pipeline.Evaluator.run, the protocol of
     test.py, at the protocol's constants): builds a 2,048-clip synthetic
     corpus into build/ (its test split of 308 clips is above
     diversity_times = 300; only the corpus and replication_times, 20 -> 1,
     are cut), trains the t2m evaluator bundle on the card for 300 steps
     (ms a step, batch top-1), runs full-width mld_humanml3d from seeded
     random weights through the main pass (batches of 32), the
     MultiModality pass (32 texts x 30 repeats a batch) and the
     ground-truth pass, with the launches of every batch (K1 50, K4 24, K3
     18), per-pass ms a batch, the host's metric seconds, finite metrics, a
     projection to HumanML3D's test split, the trained bundle's GT R@1
     above a random bundle's, and one main-pass batch's three embeddings
     on the card against the CPU;
  8. action-to-motion (mld_humanact12: denoiser 15x256, mld_uestc: 9x256,
     each over [z; t; action], ACTOR VAE 9x256, 60 frames, from seeded
     random weights): writes the synthetic archives into build/, each
     preset in a root of its own (12 x 256 and 40 x 80 clips: test splits
     of 308 and 320, above diversity_times = 300; only the archives and
     replication_times, 20 -> 1, are cut), trains the HumanAct12 GRU
     classifier on the card for 300 steps (ms a step, batch top-1, its GT
     accuracy above a random classifier's), runs generate_action at B = 6
     and 128 (launches of every call: K1 50, K3 18, K4 0, K5 0; median of 3
     warm calls, the device busy share of a traced call), Evaluator.run one
     replication per preset at the protocol's constants (launches of every
     batch; the vae stage once for HumanAct12: K3 27, K1 0; ms a batch,
     host metric seconds, finite metrics), and the joints of 8 actions on
     the card against the CPU;
  9. training presets and modes (train(), full width, B=64, dropout 0.1,
     5 steps an arm, the median of steps 2-4, step 5 traced): synthetic
     archives into build/ (12 x 8 and 40 x 2 clips, one root a preset);
     mld_humanact12's vae stage (one resumed step), diffusion with the vae
     stage's ACTOR VAE handed over (pretrained_vae), vae_diffusion, and
     mld_uestc's diffusion; the launches of every step (vae 0; diffusion
     K3 9; vae_diffusion K3 27, K1 50), frozen params bit-identical,
     trainable modules moved, finite logs, ms a step, device busy, peak
     allocated memory a step; one step of each action diffusion stage at
     B=8, dropout 0, card vs CPU; then mld_humanml3d's vae stage with
     remat and in bf16 mixed precision, and its diffusion stage in bf16,
     each against phase 6's f32 run of the same configuration (peak memory
     and ms a step: bf16 against f32, remat against none), and one bf16
     diffusion step against the f32 step on the same batch and draws;
 10. the text family's model options (seeded random weights at the
     presets' full widths and depths; only the option changes), each arm
     through MLD.generate on the demo prompts, then generate_joints at
     B=128 (the launches of every call against the counts derived from the
     model, the median of 3 warm calls, the device busy share of one traced
     call) and the card's joints for one prompt against the CPU's (plain
     versions, f32 text tower, the same ids and initial latents): hidden
     mode (clip_last_hidden: K3 468, K4 24 at S = 77, K1 0), text_uncond
     (K1 50, K3 18, K4 12), the ablation (all_encoder + mlp_dist VAE, sine
     PE, pre-norm, a plain encoder denoiser: K3 459), VPosert (K1 50, K3 0),
     latent_size 7 with fused_decode (K3 450, K5 1), mld_kit (251
     features, 21 joints), the latent trans_dec denoiser (K3 918) and raw
     motion's trans_enc with DDIM-50 (K3 450); then training at B=64,
     dropout 0.1, 3 steps an arm: hidden-mode diffusion (K4 24 at S = 77,
     K3 9) and the ablation's vae stage (K3 0), each with its launches,
     finite logs, frozen params unchanged, ms a step and peak memory, and
     one B=8 dropout-0 step against the CPU;
 11. the synthetic end-to-end protocol: K4, K1 and K3 against their plain
     versions at its shapes (K4 [64, 12, S, 64] of the full-width
     pretraining and [16, 2, S, 32] of the small tower; K1 at the small
     denoiser's D = 64, 3 layers, F = 128 over 64 sequences; K3 at the
     small VAE's 4 heads of 16: decode self- and cross-attention at 32
     clips of up to 96 frames, the frozen encode at 16), then CLIP
     pretraining (train/pretrain.py) of mld_humanml3d's 12x768 bf16 tower
     at B = 64 on phase 6's corpus for 60 steps (K4 12 launches every step
     under autograd, ms a step, peak memory, a falling style-MSE, the
     device busy share of one traced step), two f32 steps at B = 8 card vs
     CPU (losses and the first step's gradients), and a drill of
     python -m mld_tpu_torch.scripts.train_synthetic_e2e at the small
     scale with its budgets cut (150 steps a stage, 60 CLIP steps, 150
     evaluator steps, train() at 2 epochs): every stage's loss falls,
     every metric is finite, each section launches what its config
     derives, and trained_params.npz loads back through load_pretrained
     with its tower;
 12. the output path (the demo CLI, SMPL fitting, meshes and FBX): writes a
     seeded full-size SMPL-schema pickle (6,890 vertices, 13,776 faces)
     and a gmm_08.pkl into build/output_smoke/; python -m
     mld_tpu_torch.demo at mld_humanml3d's full width from seeded random
     weights on demo/example.txt at --replication 2 --allinone (K1 50, K4
     24, K3 18 a replication; 6 npys [len, 22, 3] each), --task action
     (mld_humanact12, two ids: K1 50, K3 18), random_sampling (K3 18) and
     reconstruction of a seeded feature npy (K3 27); python -m
     mld_tpu_torch.fit --mesh on the six motions of the first replication
     (300 Adam steps, the 25-step polish, the GMM prior; MPJPE, Adam and
     polish seconds, ms a frame), --ply on the shortest; the 196-frame
     motion's Adam phase and polish traced (device busy against the
     untraced phase, device events a step) and fitted again on the CPU,
     and once more on the CPU with the target moved by 1e-7 of its scale
     (a random-weight motion is ill-conditioned: Adam's first loss 1e-6
     relative, MPJPE 10%, and the loss curve, the Adam iterate and the
     polished joints within 10x the CPU's own divergence from that
     nudge), and a 196-frame pose walk the body can reach fitted the same
     three ways (Adam's first loss 1e-6 relative, every loss 2e-4, the
     last 1e-4, the Adam iterate 1e-3, the polished joints 2e-3 m, MPJPE
     10%, the mesh 1e-5 of its scale; the nudge printed); python -m
     mld_tpu_torch.scripts.fbx_export on a
     npy, its npz and its pkl tree, each file read back (bones, a key a
     frame). Nothing is rendered (matplotlib host work, which the CPU tests
     hold, and which this script does not require);
 13. the training path's input pipeline and data parallelism: the C++
     batch loader (built with g++ into build/) against the numpy collator
     on phase 6's corpus (lengths, masks, texts equal, motion within 1e-5;
     the data module took the native collator); python -m
     mld_tpu_torch.train's main() at phase 6's width, B=64, dropout 0.1,
     --device 0 (one rank, in this process, in an NCCL group of one: the
     data-parallel step), its --cfg_assets handing over phase 6's VAE:
     diffusion 6 steps (K4 24, K3 9 a step) with the numpy collator, then
     with the native one, and vae_diffusion 3 steps from the native run
     (K4 48, K3 27, K1 50); launches of every step, frozen params
     bit-identical, trainable moved, finite logs, ms a step and the host
     gap between steps (median of steps 2-6), native against numpy
     (recorded, not claimed); then one B=64 diffusion step, dropout 0,
     through the one-rank NCCL path against no process group (within 1e-6
     of scale) and over two gloo ranks on the one card (NCCL refuses two
     ranks on one device) against one process (loss 2e-4 relative,
     params 2e-4);
 14. the released-checkpoint path and the user scripts
     (mld_tpu_torch.scripts.*), at mld_humanml3d's full width from seeded
     weights: the parity drill on assets fabricated into build/ (a
     reference-format .ckpt, an HF-named 12x768 tower as
     pytorch_model.bin, phase 7's trained evaluators as finest.tar, its
     corpus as the dataset) with --replications 1 --no-mm (cuts of 20 and
     the MultiModality pass): every step ok, the verdict fail: (random
     weights), exit code 1, the converted weights bit-equal to the file's,
     the hydrated tower's f32 features on the card against the CPU, the
     launches of its evaluated batches and AITS calls (K1 50, K4 24, K3 18
     a call), AITS in ms and against 0.217 s (recorded, not claimed); the
     checkpoint converter, whose npz reloads bit for bit; the flops script
     at B = 1 and 128, each stage's count (kernel counters + aten) against
     the CPU's plain-path count within 1e-6 and generate_feats against its
     parts; the latent trajectories of 4 prompts (DDIM-50, PCA), the last
     latent against the CPU; the DDIM ablation on phase 11's workdir at
     steps {10, 50} (cut from {5, 10, 20, 50, 100}), B=128, 3 timed calls
     (K1 a call = the steps; motions/s recorded); one B=64 diffusion step
     with the denoiser split over a model axis of two gloo ranks on the
     one card (parallel/partition.py) against one process (loss 2e-4
     relative, params 2e-4, grad_norm 2e-4, reassembled gradients 1e-4 of
     each leaf's largest |g|), the residual stream bit-identical on both
     model ranks under dropout 0.1, and K3 at a rank's [64, 2, 3, 64];
 15. prints each phase's seconds, the kernels JSON line, the nvidia-smi
     line, and last {"ok": true, "device": {...}}.
Needs one card, imports nothing of JAX, and builds into build/.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time
from collections import Counter

REPO = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"

SEED = 0
# flagship denoiser stack (mld_humanml3d): S tokens [z; t; text]
S, D, H, FF, N_LAYERS = 3, 256, 4, 1024, 9
N_BLOCK = (N_LAYERS - 1) // 2
B_LARGE = 128
# the evaluation protocol's batches (phase 7): the main pass's 32 prompts,
# the MultiModality pass's 32 prompts x 30 repeats
EVAL_B, EVAL_MM_ROWS = 32, 32 * 30
# sequences per call: B=1 and B=128 under CFG, counts that leave a ragged
# last tile (the wrapper packs 10 sequences, 30 rows, a tile), and the
# evaluation's batches under CFG
KERNEL_SEQS = (2, 2 * B_LARGE, 201, 1001, 2 * EVAL_B, 2 * EVAL_MM_ROWS)
LAYER_SEQS = (2, 2 * B_LARGE)
# action-to-motion (phase 8): mld_humanact12's denoiser stack is 15 layers
# (n_block = 7) over [z; t; action]; its sequences: the a2m evaluation's
# batch of 32 and B = 128 under CFG
A2M_LAYERS = 15
A2M_N_BLOCK = (A2M_LAYERS - 1) // 2
A2M_KERNEL_SEQS = (2 * EVAL_B, 2 * B_LARGE)
# the a2m clip length (dataset.num_frames) and the ragged lengths of the
# ACTOR attention checks (cycled over the batch)
A2M_FRAMES = 60
A2M_LENGTHS = (60, 52, 41, 33, 24, 17)
# VAE decode: 196 frames; B=6 leaves a ragged last 64-row GEMM tile and every
# B a ragged last 64-query attention tile
T_FRAMES = 196
DECODE_BATCHES = (1, 6, B_LARGE)
# CLIP: EOT buckets, the uncond row (8) and the uncropped context (77)
CLIP_SEQS = (8, 16, 32, 64, 77)
CLIP_HEADS, CLIP_DH = 12, 64
# the demo prompts' EOT bucket: the shape whose library backend is printed
CLIP_KEY_S = 16
F32_ATOL = 1e-4
# bf16 weights: kernel and plain version both round weights and the
# activation operand to bf16 and accumulate exact products in f32, so they
# differ only where f32 summation order flips the bf16 rounding of an
# activation (one flip moves a product by 2^-8 of that operand) and nine
# layers carry the flips on. The bf16 stack is that sensitive by itself: a
# 1e-7 relative perturbation of its input moves the plain version's output
# by up to 1.9e-2 at these weights (B=128, on the CPU), against 4e-6 for
# f32 weights. 5e-2 leaves room for that and still fails a wrong weight,
# layout or rounding, which moves outputs of scale ~4 by O(1)
BF16_ATOL = 5e-2
# The decoder stack's bf16 arm takes the same bar for the same reason: a
# 1e-7 relative perturbation of its queries moves the plain bf16 stack by up
# to 1.3e-2 at these weights (B=128 with the demo lengths, T=196, on the
# CPU), against 2.4e-6 for f32 weights, at outputs of scale ~4.6.
# At nine layers that bar cannot tell a wrong rounding from a right one:
# the plain stack with the activation operand left in f32 differs from the
# bf16 stack by at most 1.8e-2 (K5, B=128) and 2.1e-2 (K1, 256 seqs), with
# f32 weights by 2.7e-2 and 2.9e-2, about what the 1e-7 perturbation does.
# One layer is not yet chaotic, so the rounding is held there, by RMS over
# the compared elements (on the CPU, these weights): a 1e-7 perturbation
# moves K5's first layer by 1.4-1.6e-4 and K2's by 1.1-1.8e-4; activations
# left in f32 move them by 2.2e-3 and 1.65e-3, f32 weights by 3.3e-3 and
# 2.35e-3. 6e-4 sits between; the card run asserts that both gaps, there,
# are above it
BF16_RMS_ATOL = 6e-4
# CLIP attention, the bars of tests/test_attention.py. v is drawn at half the
# scale of q and k so that outputs stay below 2, where one bf16 ulp of the
# output (2^-7) plus a flipped probability (2^-9 of |v|) stays under 2e-2
ATTN_F32_ATOL = 1e-5
ATTN_BF16_ATOL = 2e-2
# K3 at the main paths' shapes, (label, B, H, Sq, Sk, Dh, mask): the
# raw-motion denoiser (4 heads of 128) at 2B = 2 and 12 (one prompt and the
# six demo prompts under CFG), self-attention over 512 and 196 frames and
# cross-attention to [time; text]; the plain VAE decode (4 heads of 64) at
# B = 128 under the demo lengths' frame mask ("demo") and against its latent
# token; and a ragged case: Sk = 70 leaves a part-filled last key tile, and
# the mask "ragged" keeps keys [Sk, 33, 0] of the three examples, so one
# masks every key (the average of v over its 70 keys, as sdpa_xla)
S512 = 512
FLASH_CASES = (
    ("s512 self", 2, 4, S512, S512, 128, None),
    ("s512 self", 12, 4, S512, S512, 128, None),
    ("s512 cross", 12, 4, S512, 2, 128, None),
    ("s196 self", 12, 4, T_FRAMES, T_FRAMES, 128, None),
    ("decode self", B_LARGE, 4, T_FRAMES, T_FRAMES, 64, "demo"),
    ("decode cross", B_LARGE, 4, T_FRAMES, 1, 64, None),
    ("ragged", 3, 4, 100, 70, 128, "ragged"),
)
# cases the key tiles, the 16-row MMA tiles and the copies of the tensor-core
# design could get wrong: Sq and Sk off every tile (Sq = 131, the s512
# path's shortest demo length; Sk = 70), and Dh = 4 and 68, whose bf16 rows
# are not 16-byte aligned (8-byte copies); masked with lengths [Sk, 33, 0]
# like the ragged case above, so with a fully masked example
FLASH_CASES += (
    ("odd", 3, 4, 131, 70, 128, "ragged"),
    ("odd self", 3, 4, 131, 131, 128, "ragged"),
    ("dh4", 3, 4, 131, 70, 4, "ragged"),
    ("dh68 self", 3, 4, 131, 131, 68, "ragged"),
)
# the plain VAE decode of the evaluation's MultiModality batch
FLASH_CASES += (
    ("eval decode self", EVAL_MM_ROWS, 4, T_FRAMES, T_FRAMES, 64, "demo"),
)
# the ACTOR VAE (phase 8) at B = 128: the decoder's self-attention over 60
# frames under a ragged frame mask and its cross-attention to the latent,
# and the encoder's self-attention over [mu; logvar; 60 frames] (the two
# tokens always valid)
FLASH_CASES += (
    ("actor decode self", B_LARGE, 4, A2M_FRAMES, A2M_FRAMES, 64, "actor"),
    ("actor decode cross", B_LARGE, 4, A2M_FRAMES, 1, 64, None),
    ("actor encode self", B_LARGE, 4, A2M_FRAMES + 2, A2M_FRAMES + 2, 64,
     "actor tokens"),
)
# the text-family options (phase 10) at B = 128 under CFG: the hidden-mode
# denoiser's self-attention over [z; t; 77 hidden states] (79 tokens, off
# every tile, no mask); the plain-encoder denoiser over [z; t; text] (3);
# the latent trans_dec denoiser's self-attention over its one latent token
# and its cross-attention to [t; text] (2 keys); the all_encoder VAE's
# decode over [z; 196 frames] under [1; mask] at B = 128; and raw motion's
# trans_enc denoiser over [t; text; 196 frames] (4 heads of 128)
FLASH_CASES += (
    ("hidden denoiser self", 2 * B_LARGE, 4, 79, 79, 64, None),
    ("plain denoiser self", 2 * B_LARGE, 4, 3, 3, 64, None),
    ("latent dec self", 2 * B_LARGE, 4, 1, 1, 64, None),
    ("latent dec cross", 2 * B_LARGE, 4, 1, 2, 64, None),
    ("all_encoder decode self", B_LARGE, 4, T_FRAMES + 1, T_FRAMES + 1, 64,
     "decode tokens"),
    ("raw enc self", 2 * B_LARGE, 4, T_FRAMES + 2, T_FRAMES + 2, 128, None),
)
# the case whose times the kernels line carries: one self-attention of
# novae_stress_s512 at the demo batch
FLASH_KEY = ("s512 self", 12)
# published peaks of one H100 SXM (NVIDIA's data sheet, dense), by the unit a
# kernel runs its products on: f32 products as three TF32 tensor-core
# products (big.big + big.small + small.big), 495 / 3; bf16 tensor-core
# products. Every kernel of the port runs its products on one of the two
HBM_BYTES_S = 3.35e12
PEAKS = {"3xTF32 165 TFLOP/s": 495e12 / 3, "bf16 MMA 989 TFLOP/s": 989e12}
TF32X3, BF16_MMA = PEAKS
# the unit K3 and K4 run their products on, by operand dtype
FLASH_PEAK = {"f32": TF32X3, "bf16": BF16_MMA}
RAW_PRESETS = ("novae_humanml3d", "novae_stress_s512")
# steps of the profiled sampling loop, and of the card-vs-CPU raw-motion
# check (a full-width 1000-step run on the CPU would take minutes)
PROFILE_STEPS = 20
RAW_REF_STEPS = 10
# card (kernels, f32 weights) vs CPU (plain versions) joints after 50 CFG
# steps: f32 summation order on two devices, the end-to-end bar of
# tests/test_full_sampler_parity.py
E2E_RTOL = 1e-3
# the two configurations of the main path: the default (K1, K4) and the
# JAX package's fused decode (K1, K4, K5)
CONFIGS = (("default", {}), ("kernels", {"fused_decode": True}))
# training phase: the corpus, the batch, the steps of each stage (the first
# a warm-up), and the steps traced by torch.profiler (after step a through
# step b), both taken out of the medians, which keep steps 2-6 (n = 5). The
# corpus's train split holds one batch, so every step of the loop is also an
# epoch: its end, the next epoch's loader thread and first batch. The step
# itself (train_step, from a synchronize to a synchronize) is timed apart
# from the loop's interval between steps.
TRAIN_ROOT = os.path.join(REPO, "build", "train_smoke")
TRAIN_CLIPS = 128
TRAIN_B = 64
TRAIN_STEPS = {"vae": 8, "diffusion": 8, "vae_diffusion": 8}
TRAIN_TRACED = {"vae": (6, 8), "diffusion": (6, 8), "vae_diffusion": (6, 8)}
REF_TRAIN_B = 8
# K3 under autograd against the plain attention, on the card: K3 holds
# 1e-5 against its plain version a call (phase 3); the denoiser's nine
# layers and the backward through them carry that to the loss and to each
# gradient at about the same relative size; 1e-4 of the loss and of each
# leaf's largest |g| leaves a factor of ten
K3_GRAD_RTOL = 1e-4
# K4 under autograd: the f32 text tower's forward and backward at the
# diffusion stage's prompts, kernel forward vs plain attention on the card.
# K4 holds 1.2e-6 against its plain version a call in f32 (phase 3); twelve
# layers and their backward carry that to the output and into the gradients
# at about the same size relative to the gradients flowing through the
# tower, so each leaf's error is held against the tower's largest |g|, not
# the leaf's own: a leaf's net gradient can cancel to nothing (the key
# projection's bias gets none in exact arithmetic, since softmax ignores a
# shift shared by a row of scores, and keeps only rounding noise). The K3
# bar and its factor of ten hold here too
K4_GRAD_RTOL = 1e-4
# one full-width diffusion step, card (kernels) vs CPU (plain versions), f32
# text tower on both: f32 summation order on two devices through the 12 CLIP
# layers, the 9 VAE encoder layers and the 9 denoiser layers and their
# backward; the CPU tests hold 3-layer stacks to the JAX package at 1e-4 of
# each leaf's scale, and three times the depth takes 1e-3
TRAIN_REF_RTOL = 1e-3


def log(*args):
    print(*args, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def phase_device(torch):
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; none is visible")
    smi = nvidia_smi_line()
    log(f"[device] {smi}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    log(f"[device] tf32: matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32} float32_matmul_precision="
        f"{torch.get_float32_matmul_precision()}")
    return smi


def phase_build():
    from mld_tpu_torch.ops import _build

    info = _build.build()
    log(f"[build] {'built' if info['built'] else 'found'} {info['path']} "
        f"in {info['seconds']:.1f} s (nvcc sm_90a, one process a source)")
    for line in info["log"].splitlines():
        if ("registers" in line or "spill" in line or "Compiling" in line
                or "smem" in line):
            log(f"[build] {line.strip()}")
    _build.library()
    log_tensor_core_sass(info["path"])


def log_tensor_core_sass(path):
    """Tensor-core instructions in each kernel's SASS, by cuobjdump: HMMA
    (mma.sync) and HGMMA (wgmma), which kernels of the compiled library run
    on the tensor cores."""
    from mld_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", path], capture_output=True,
                         text=True, timeout=300)
    if out.returncode != 0:
        raise RuntimeError(f"cuobjdump failed: {out.stderr.strip()}")
    counts, fn = {}, None
    for line in out.stdout.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = Counter(HMMA=0, HGMMA=0)
        elif fn:
            for op in ("HGMMA", "HMMA"):
                if op in line:
                    counts[fn][op] += 1
                    break
    for fn, n in sorted(counts.items()):
        log(f"[build] SASS {n['HMMA']:5d} HMMA {n['HGMMA']:5d} HGMMA  "
            f"{fn[:100]}")


def _time_ms(torch, fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(torch, fn, iters=10, tries=4):
    """Device time of one fn() call: the durations of the device kernels
    (and memsets) torch.profiler sees over `iters` calls, over iters. Unlike
    _time_ms it leaves out the host's time between launches, which bounds
    calls of microseconds. The profiler can drop events, most often all of
    a short window's: a trace is kept once a second trace of `iters` calls
    holds the same nonzero number of device kernels, a multiple of iters.
    After `tries` traces without two that agree, the device time is not
    measured: None, and a line says so (the event time `ms` stands)."""
    from torch.profiler import ProfilerActivity, profile

    def trace():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        return [e.time_range.elapsed_us() for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]

    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(tries):
        us = trace()
        if us and len(us) % iters == 0 and len(us) in seen:
            return sum(us) / 1e3 / iters
        seen.append(len(us))
    log(f"[kernel] device time not measured: torch.profiler saw {seen} "
        f"device kernels in {tries} traces of {iters} calls")
    return None


def _ms_text(ms):
    return "not measured" if ms is None else f"{ms:.4f}"


def bound(flops, nbytes, peak, more=()):
    """The least time the card could take for a kernel's work: the larger
    of its bytes (each input read once, each output written once) over the
    memory rate and its operations over the peak of the unit it runs them
    on (PEAKS); `more` holds (flops, peak) of products it runs on another
    unit, whose times add."""
    ops_ms = (flops / PEAKS[peak] + sum(f / PEAKS[p] for f, p in more)) * 1e3
    bytes_ms = nbytes / HBM_BYTES_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "bound_peak": (peak + "".join(f" + {p}" for _, p in more)
                           if ops_ms >= bytes_ms else "HBM 3.35 TB/s"),
            "flops": flops + sum(f for f, _ in more), "bytes": nbytes}


def _hold(torch, name, kernel, plain, atol, what, count, mask=None,
          iters=20, library=None, work=None):
    """Run kernel() and plain() once, compare, then time both, and the one
    PyTorch call `library` computing the same function where there is one.
    Raises on a non-finite output, an error above atol, or a first kernel()
    call that does not add one to the wrapper's launch count (count() reads
    it). `work` is bound()'s arguments for one call.
    Returns {"err", "ms", "device_ms", "plain_ms", "launches" of the
    compared call, "library_ms", "library_device_ms", "library_err",
    "bound"}."""
    before = count()
    out = kernel()
    launches = count() - before
    if launches != 1:
        raise RuntimeError(f"{name} ({what}): {launches} launches counted "
                           f"for one call")
    torch.cuda.synchronize()
    ref = plain()
    torch.cuda.synchronize()
    lib_out = library() if library is not None else None
    if mask is not None:
        out, ref = out[mask], ref[mask]
    if not torch.isfinite(out).all():
        raise RuntimeError(f"{name} gave non-finite output ({what})")
    err = (out.float() - ref.float()).abs().max().item()
    ms = _time_ms(torch, kernel, iters)
    plain_ms = _time_ms(torch, plain, iters)
    res = {"err": err, "ms": ms, "device_ms": _device_ms(torch, kernel),
           "plain_ms": plain_ms, "launches": launches, "library_ms": None,
           "library_device_ms": None, "library_err": None,
           "bound": bound(*work) if work is not None else None}
    extra = ""
    if library is not None:
        res["library_err"] = (lib_out.float() - ref.float()).abs().max().item()
        res["library_ms"] = _time_ms(torch, library, iters)
        res["library_device_ms"] = _device_ms(torch, library)
        extra += (f" library {res['library_ms']:.4f} ms (device "
                  f"{_ms_text(res['library_device_ms'])}; max_abs_err "
                  f"{res['library_err']:.3e})")
    if res["bound"] is not None:
        b = res["bound"]
        extra += (f" bound {b['bound_ms']:.4f} ms ({b['bound_by']}, "
                  f"{b['bound_peak']}; {b['bound_ms'] / ms:.1%} of it)")
    log(f"[kernel] {name} {what} max_abs_err={err:.3e} (atol {atol:g}) "
        f"kernel {ms:.4f} ms (device {_ms_text(res['device_ms'])}) plain "
        f"{plain_ms:.4f} ms{extra}")
    if not err <= atol:
        raise RuntimeError(f"{name} disagrees with its plain version: "
                           f"{err:.3e} > {atol:g} ({what})")
    return res


def _library_kernels(torch, fn):
    """The device kernels one call of fn launches, by torch.profiler: which
    backend the library call took."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.name[:90] for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA})


def _encoder_work(n_seq, n_block, st, s=S, d=D, ff=FF):
    """bound()'s arguments for K1 (K2 at n_block = 0) on n_seq sequences of
    s tokens (width d, FFN ff; the flagship's by default):
    ``ops/work.py:encoder_work`` at the unit the weights run on (3xTF32 for
    f32 weights, bf16 mma)."""
    from mld_tpu_torch.ops import work
    flops, nbytes = work.encoder_work(n_seq, n_block, st, s, d, ff)
    return flops, nbytes, BF16_MMA if st.wqkv.element_size() == 2 else TF32X3


def _decoder_work(tgt, mem, valid, st):
    """bound()'s arguments for one K5 call (``ops/work.py:decoder_work``):
    the weights' products at their unit's rate (3xTF32 for f32, bf16 mma),
    the attention products at 3xTF32 in both arms."""
    from mld_tpu_torch.ops import work
    weights, attn, nbytes = work.decoder_work(tgt, mem, valid, st)
    peak = BF16_MMA if st.wqkv_s.element_size() == 2 else TF32X3
    return weights, nbytes, peak, ((attn, TF32X3),)


def _flash_work(q, k, valid, peak):
    """bound()'s arguments for K3 (``ops/work.py:flash_work``)."""
    from mld_tpu_torch.ops import work
    return (*work.flash_work(q, k, valid), peak)


def _rms(a, b):
    return (a.float() - b.float()).pow(2).mean().sqrt().item()


def _upcast(torch, st):
    """The stack with its bf16 matrices held in f32: the plain version then
    multiplies f32 activations by the bf16-rounded weights."""
    return st._replace(**{f: t.float() for f, t in st._asdict().items()
                          if t.dtype == torch.bfloat16})


def _hold_rounding(torch, name, kernel, plain, mutants, what, mask=None):
    """bf16 weights at one layer: the RMS of kernel - plain must stay below
    BF16_RMS_ATOL, and the plain version of each wrong rounding in
    `mutants` must differ from the plain version by more than that.
    Returns (rms_err, {mutant: rms_gap})."""
    out, ref = kernel(), plain()
    alts = {k: fn() for k, fn in mutants.items()}
    torch.cuda.synchronize()
    if mask is not None:
        out, ref = out[mask], ref[mask]
        alts = {k: v[mask] for k, v in alts.items()}
    err = _rms(out, ref)
    gaps = {k: _rms(v, ref) for k, v in alts.items()}
    log(f"[kernel] {name} bf16 rounding {what}: rms_err={err:.3e} (bar "
        f"{BF16_RMS_ATOL:g}), plain with "
        + ", ".join(f"{k} rms {v:.3e}" for k, v in gaps.items()))
    if not err <= BF16_RMS_ATOL:
        raise RuntimeError(f"{name} bf16 rounding disagrees with its plain "
                           f"version: rms {err:.3e} > {BF16_RMS_ATOL:g}")
    for k, v in gaps.items():
        if not v > BF16_RMS_ATOL:
            raise RuntimeError(f"the rounding bar {BF16_RMS_ATOL:g} would "
                               f"pass {k} (rms {v:.3e}) for {name}")
    return err, gaps


WEIGHT_ARMS = (("f32", "float32", F32_ATOL), ("bf16", "bfloat16", BF16_ATOL))


def check_skip_encoder(torch, encoder, g):
    """K1 vs its plain version on the main path's weights."""
    from mld_tpu_torch.ops import fused_layer
    from mld_tpu_torch.ops.fused_layer import (skip_encoder_stack,
                                               skip_encoder_stack_plain,
                                               stack_skip_encoder)
    res = {}
    for wname, wdt, atol in WEIGHT_ARMS:
        st = stack_skip_encoder(encoder, getattr(torch, wdt))
        for n in KERNEL_SEQS:
            x = torch.randn(n, S, D, device=DEVICE, generator=g)
            res[(wname, n)] = _hold(
                torch, "skip_encoder",
                lambda: skip_encoder_stack(x, st, N_BLOCK, H),
                lambda: skip_encoder_stack_plain(x, st, N_BLOCK, H),
                atol, f"{wname} seqs={n} rows={n * S}",
                lambda: fused_layer.LAUNCHES,
                work=_encoder_work(n, N_BLOCK, st))
    return res


def check_skip_encoder_a2m(torch, g):
    """K1 at mld_humanact12's depth (15 layers, n_block = 7) vs its plain
    version, on seeded random weights of that stack."""
    from mld_tpu_torch.models.mld import init_params
    from mld_tpu_torch.ops import fused_layer
    from mld_tpu_torch.ops.fused_layer import (skip_encoder_stack,
                                               skip_encoder_stack_plain,
                                               stack_skip_encoder)
    from mld_tpu_torch.ops.transformer import SkipTransformerEncoder

    encoder = SkipTransformerEncoder(D, H, A2M_LAYERS, FF)
    init_params(encoder, torch.Generator().manual_seed(SEED + 9))
    encoder.to(DEVICE)
    res = {}
    for wname, wdt, atol in WEIGHT_ARMS:
        st = stack_skip_encoder(encoder, getattr(torch, wdt))
        for n in A2M_KERNEL_SEQS:
            x = torch.randn(n, S, D, device=DEVICE, generator=g)
            res[(wname, n)] = _hold(
                torch, "skip_encoder",
                lambda: skip_encoder_stack(x, st, A2M_N_BLOCK, H),
                lambda: skip_encoder_stack_plain(x, st, A2M_N_BLOCK, H),
                atol, f"{wname} L={A2M_LAYERS} seqs={n} rows={n * S}",
                lambda: fused_layer.LAUNCHES,
                work=_encoder_work(n, A2M_N_BLOCK, st))
    return res


def check_encoder_layer(torch, layer, g):
    """K2 (K1's entry at n_block = 0) vs the plain stack at n_block = 0,
    and the bf16 rounding of that one layer."""
    from mld_tpu_torch.ops import fused_layer
    from mld_tpu_torch.ops.fused_layer import (fused_encoder_layer,
                                               skip_encoder_stack_plain,
                                               stack_encoder_layer)
    res = {}
    for wname, wdt, atol in WEIGHT_ARMS:
        st = stack_encoder_layer(layer, getattr(torch, wdt))
        for n in LAYER_SEQS:
            x = torch.randn(n, S, D, device=DEVICE, generator=g)
            res[(wname, n)] = _hold(
                torch, "encoder_layer",
                lambda: fused_encoder_layer(x, layer, st),
                lambda: skip_encoder_stack_plain(x, st, 0, H),
                atol, f"{wname} seqs={n}",
                lambda: fused_layer.LAYER_LAUNCHES,
                work=_encoder_work(n, 0, st))
    st16 = stack_encoder_layer(layer, torch.bfloat16)
    st32 = stack_encoder_layer(layer)
    x = torch.randn(2 * B_LARGE, S, D, device=DEVICE, generator=g)
    rounding = _hold_rounding(
        torch, "encoder_layer",
        lambda: fused_encoder_layer(x, layer, st16),
        lambda: skip_encoder_stack_plain(x, st16, 0, H),
        {"f32 activations": lambda: skip_encoder_stack_plain(
            x, _upcast(torch, st16), 0, H),
         "f32 weights": lambda: skip_encoder_stack_plain(x, st32, 0, H)},
        f"seqs={2 * B_LARGE}")
    return res, rounding


def _decode_inputs(torch, vae, lengths, B, M, g):
    from mld_tpu_torch.models.mld import lengths_to_mask

    lens = (lengths * -(-B // len(lengths)))[:B]
    valid = lengths_to_mask(lens, T_FRAMES, DEVICE)
    tgt = vae.query_pos_decoder.pe[:T_FRAMES, 0][None].expand(
        B, T_FRAMES, D).contiguous().detach()
    mem = torch.randn(B, M, D, device=DEVICE, generator=g)
    return tgt, mem, valid


def _first_layer(st):
    """A stacked decoder cut to its first layer (n_block = 0)."""
    return st._replace(**{f: t[:1].contiguous()
                          if f not in ("wsx", "wss", "bs", "pws")
                          else t[:0].contiguous()
                          for f, t in st._asdict().items()})


def check_skip_decoder(torch, vae, lengths, g):
    """K5 vs its plain version on the main path's weights, at the queries the
    main path gives it (learned PE) and random latents; padded query rows
    are not compared (the TPU kernel's rows there are discarded too). Each
    compared call must launch the kernels the design fixes, as the C entry
    counts them, and torch.profiler must see that many on the device."""
    from mld_tpu_torch.ops import fused_seq_decoder as fsd
    from mld_tpu_torch.ops.fused_seq_decoder import (launch_count,
                                                     skip_decoder_stack,
                                                     skip_decoder_stack_plain,
                                                     stack_skip_decoder)

    def kernel(tgt, mem, valid, st, n_block=N_BLOCK):
        before = fsd.KERNELS
        out = skip_decoder_stack(tgt, mem, valid, st, n_block, H)
        counted = fsd.KERNELS - before
        want = launch_count(n_block, mem.shape[1])
        if counted != want:
            raise RuntimeError(f"skip_decoder entry launched {counted} "
                               f"kernels, the design fixes {want}")
        return out

    res = {}
    for wname, wdt, atol in WEIGHT_ARMS:
        st = stack_skip_decoder(vae.decoder, getattr(torch, wdt))
        for B in DECODE_BATCHES:
            tgt, mem, valid = _decode_inputs(torch, vae, lengths, B, 1, g)
            res[(wname, B)] = _hold(
                torch, "skip_decoder",
                lambda: kernel(tgt, mem, valid, st),
                lambda: skip_decoder_stack_plain(tgt, mem, valid, st,
                                                 N_BLOCK, H),
                atol, f"{wname} B={B} T={T_FRAMES} M=1",
                lambda: fsd.LAUNCHES, mask=valid, iters=10,
                work=_decoder_work(tgt, mem, valid, st))
    # the general cross-attention path (can_fuse_decode admits M <= 8): 2
    # latent tokens, and MLD-7's 7 at B=128 in both weight arms (phase 10)
    st = stack_skip_decoder(vae.decoder)
    tgt, mem, valid = _decode_inputs(torch, vae, lengths, 6, 2, g)
    _hold(torch, "skip_decoder",
          lambda: kernel(tgt, mem, valid, st),
          lambda: skip_decoder_stack_plain(tgt, mem, valid, st, N_BLOCK, H),
          F32_ATOL, f"f32 B=6 T={T_FRAMES} M=2", lambda: fsd.LAUNCHES,
          mask=valid, iters=5)
    tgt, mem, valid = _decode_inputs(torch, vae, lengths, B_LARGE, 7, g)
    for wname, wdt, atol in WEIGHT_ARMS:
        st = stack_skip_decoder(vae.decoder, getattr(torch, wdt))
        res[(wname, ("M=7", B_LARGE))] = _hold(
            torch, "skip_decoder", lambda: kernel(tgt, mem, valid, st),
            lambda: skip_decoder_stack_plain(tgt, mem, valid, st, N_BLOCK,
                                             H),
            atol, f"{wname} B={B_LARGE} T={T_FRAMES} M=7",
            lambda: fsd.LAUNCHES, mask=valid, iters=5,
            work=_decoder_work(tgt, mem, valid, st))
    # the bf16 rounding, at the first layer
    st16 = _first_layer(stack_skip_decoder(vae.decoder, torch.bfloat16))
    st32 = _first_layer(stack_skip_decoder(vae.decoder))
    tgt, mem, valid = _decode_inputs(torch, vae, lengths, B_LARGE, 1, g)
    rounding = _hold_rounding(
        torch, "skip_decoder",
        lambda: kernel(tgt, mem, valid, st16, 0),
        lambda: skip_decoder_stack_plain(tgt, mem, valid, st16, 0, H),
        {"f32 activations": lambda: skip_decoder_stack_plain(
            tgt, mem, valid, _upcast(torch, st16), 0, H),
         "f32 weights": lambda: skip_decoder_stack_plain(
            tgt, mem, valid, st32, 0, H)},
        f"first layer B={B_LARGE} T={T_FRAMES}", mask=valid)
    return res, rounding, profile_decoder(torch, vae, lengths, g)


def profile_decoder(torch, vae, lengths, g):
    """The device kernels of one K5 call at B=128 in each weight arm, as
    torch.profiler traces them, held to the count of the C entry and of the
    design, and their device ms by kernel and split into the GEMMs, the
    attention kernels (K3's and the general cross-attention's) and the
    rest."""
    from torch.profiler import ProfilerActivity, profile

    from mld_tpu_torch.ops import fused_seq_decoder as fsd

    tgt, mem, valid = _decode_inputs(torch, vae, lengths, B_LARGE, 1, g)
    valid = valid.to(torch.int32).contiguous()   # no cast inside the trace
    res = {}
    for wname, wdt, _ in WEIGHT_ARMS:
        st = fsd.stack_skip_decoder(vae.decoder, getattr(torch, wdt))
        fsd.skip_decoder_stack(tgt, mem, valid, st, N_BLOCK, H)   # warm
        torch.cuda.synchronize()
        want = fsd.launch_count(N_BLOCK, 1)
        # the profiler can drop a trace's events: up to three traces, the
        # first that holds as many kernels as the C entry counted is kept
        for _ in range(3):
            before = fsd.KERNELS
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fsd.skip_decoder_stack(tgt, mem, valid, st, N_BLOCK, H)
                torch.cuda.synchronize()
            counted = fsd.KERNELS - before
            traced = [e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and not e.name.startswith(("Memcpy", "Memset"))]
            if len(traced) == counted:
                break
        names, name_ms, kinds = Counter(), Counter(), Counter()
        for e in traced:
            # the kernel with its template arguments: the GEMM's by weight
            # type and epilogue (0 bias, 1 GELU, 2 LayerNorm)
            name = (e.name.replace("(anonymous namespace)::", "")
                    .removeprefix("void ").split("(")[0])
            ms = e.time_range.elapsed_us() / 1e3
            names[name] += 1
            name_ms[name] += ms
            kind = ("GEMM" if "gemm" in name
                    else "attention" if "attention" in name or "flash" in name
                    else "other")
            kinds[kind] += ms
        busy = sum(kinds.values())
        log(f"[kernel] skip_decoder {wname} B={B_LARGE}: {len(traced)} device "
            f"kernels traced, {counted} counted by the C entry, {want} by "
            f"design; device {busy:.4f} ms: "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in kinds.most_common())
            + "; by kernel: " + ", ".join(
                f"{k} x{names[k]} {v:.4f} ms" for k, v in name_ms.most_common()))
        if not len(traced) == counted == want:
            raise RuntimeError(f"skip_decoder kernels: traced {len(traced)}, "
                               f"counted {counted}, designed {want}")
        res[wname] = {"traced": len(traced), "device_ms": busy,
                      "device_ms_by_kind": dict(kinds)}
    return res


def check_flash_causal(torch, g, cases=None):
    """K4 vs its plain version at `cases` (B, heads, S, Dh, key); by
    default [128, 12, S, 64] at every bucket and the MultiModality
    batch's prompts."""
    import torch.nn.functional as F

    from mld_tpu_torch.ops import attention
    from mld_tpu_torch.ops.attention import (flash_causal_plain,
                                             sdpa_flash_causal)
    res = {}
    # B=128 at each bucket, keyed by S; the MultiModality batch's prompts at
    # the demo bucket, keyed by (B, S)
    if cases is None:
        cases = [(B_LARGE, CLIP_HEADS, s, CLIP_DH, s) for s in CLIP_SEQS] + [
            (EVAL_MM_ROWS, CLIP_HEADS, CLIP_KEY_S, CLIP_DH,
             (EVAL_MM_ROWS, CLIP_KEY_S))]
    for dname, dt, atol in (("f32", torch.float32, ATTN_F32_ATOL),
                            ("bf16", torch.bfloat16, ATTN_BF16_ATOL)):
        for B, heads, s, dh, key in cases:
            scale = dh ** -0.5
            shape = (B, heads, s, dh)
            q, k = (torch.randn(shape, device=DEVICE, generator=g).to(dt)
                    for _ in range(2))
            v = (0.5 * torch.randn(shape, device=DEVICE, generator=g)).to(dt)
            res[(dname, key)] = _hold(
                torch, "flash_causal",
                lambda: sdpa_flash_causal(q, k, v, scale),
                lambda: flash_causal_plain(q, k, v, scale),
                atol, f"{dname} [{B}, {heads}, {s}, {dh}]",
                lambda: attention.LAUNCHES,
                library=lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, scale=scale),
                work=(2 * B * heads * dh * s * (s + 1),
                      4 * q.numel() * q.element_size(), FLASH_PEAK[dname]))
            if key == CLIP_KEY_S:
                names = _library_kernels(
                    torch, lambda: F.scaled_dot_product_attention(
                        q, k, v, is_causal=True, scale=scale))
                res[(dname, key)]["library_kernels"] = names
                log(f"[kernel] flash_causal library {dname} at S={s}: "
                    f"{names}")
    return res


def _flash_inputs(torch, B, H, Sq, Sk, Dh, g):
    """q, k, v as MultiheadAttention hands them to sdpa: head views
    [B, H, S, Dh] into a packed [B, S, 3d] projection when Sq == Sk
    (self-attention, row stride 3d), else into [B, Sq, d] and two [B, Sk, d]
    projections. v at half the scale of q and k (outputs below 2)."""
    d = H * Dh

    def heads(t):
        return t.reshape(t.shape[0], t.shape[1], H, Dh).transpose(1, 2)

    def draw(S, n):
        return torch.randn(B, S, n * d, device=DEVICE, generator=g)

    if Sq == Sk:
        qkv = draw(Sq, 3)
        qkv[..., 2 * d:] *= 0.5
        return qkv, lambda t: [heads(x) for x in t.split(d, dim=-1)]
    q, k, v = draw(Sq, 1), draw(Sk, 1), 0.5 * draw(Sk, 1)
    return (q, k, v), lambda t: [heads(x) for x in t]


def check_flash(torch, lengths, g, cases=FLASH_CASES):
    """K3 vs flash_plain at the shapes of `cases`, f32 and bf16, on the
    same strided views. Every row is compared, fully masked ones too. The
    library call is SDPA with the key mask as an additive 0 / -1e9 bias,
    K3's function on every row with a valid key, so it is timed where no
    example is fully masked."""
    import torch.nn.functional as F

    from mld_tpu_torch.models.mld import lengths_to_mask
    from mld_tpu_torch.ops import attention
    from mld_tpu_torch.ops.attention import NEG_INF, flash_plain, sdpa

    res = {}
    for label, B, H, Sq, Sk, Dh, mask in cases:
        raw, split = _flash_inputs(torch, B, H, Sq, Sk, Dh, g)
        valid = None
        if mask == "ragged":
            valid = lengths_to_mask([Sk, 33, 0], Sk, DEVICE)
        elif mask == "demo":
            valid = lengths_to_mask((lengths * -(-B // len(lengths)))[:B],
                                    Sk, DEVICE)
        elif mask in ("actor", "actor tokens"):
            n_tok = Sk - A2M_FRAMES
            frames = list(A2M_LENGTHS) * -(-B // len(A2M_LENGTHS))
            valid = lengths_to_mask([n_tok + n for n in frames[:B]], Sk,
                                    DEVICE)
        elif mask == "decode tokens":
            # [ones(latent tokens); the demo lengths' frame mask]
            n_tok = Sk - T_FRAMES
            frames = (lengths * -(-B // len(lengths)))[:B]
            valid = lengths_to_mask([n_tok + n for n in frames], Sk, DEVICE)
        elif mask in ("e2e frames", "e2e tokens"):
            # the end-to-end protocol's clips (16-96 frames), behind the
            # VAE encoder's distribution tokens
            n_tok = Sk - E2E_FRAMES
            frames = list(E2E_LENGTHS) * -(-B // len(E2E_LENGTHS))
            valid = lengths_to_mask([n_tok + n for n in frames[:B]], Sk,
                                    DEVICE)
        for dname, dt, atol in (("f32", torch.float32, ATTN_F32_ATOL),
                                ("bf16", torch.bfloat16, ATTN_BF16_ATOL)):
            q, k, v = split(raw.to(dt) if torch.is_tensor(raw)
                            else [t.to(dt) for t in raw])
            bias = None
            if valid is not None:
                bias = torch.zeros(B, 1, 1, Sk, dtype=dt, device=DEVICE)
                bias.masked_fill_(~valid[:, None, None, :], NEG_INF)
            library = None
            if mask != "ragged":
                def library(q=q, k=k, v=v, bias=bias):
                    return F.scaled_dot_product_attention(q, k, v,
                                                          attn_mask=bias)
            key = (dname, (label, B))
            res[key] = _hold(
                torch, "flash_attention",
                lambda: sdpa(q, k, v, valid),
                lambda: flash_plain(q, k, v, valid),
                atol, f"{dname} {label} q [{B}, {H}, {Sq}, {Dh}] Sk={Sk}"
                + (f" mask {mask}" if mask else ""),
                lambda: attention.FLASH_LAUNCHES, library=library,
                work=_flash_work(q, k, valid, FLASH_PEAK[dname]))
            if (label, B) == FLASH_KEY or label == "decode self":
                res[key]["library_kernels"] = _library_kernels(torch, library)
                log(f"[kernel] flash_attention library {dname} {label}: "
                    f"{res[key]['library_kernels']}")
    return res


def phase_kernels(torch, mld, lengths):
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    with torch.no_grad():
        return {
            "skip_encoder": check_skip_encoder(torch, mld.denoiser.encoder, g),
            "skip_encoder_a2m": check_skip_encoder_a2m(torch, g),
            "encoder_layer": check_encoder_layer(
                torch, mld.denoiser.encoder.middle_block, g),
            "skip_decoder": check_skip_decoder(torch, mld.vae, lengths, g),
            "flash_causal": check_flash_causal(torch, g),
            "flash_attention": check_flash(torch, lengths, g),
        }


def _demo_prompts():
    texts, lengths = [], []
    with open(os.path.join(REPO, "demo", "example.txt")) as f:
        for line in f:
            s = line.strip()
            if s:
                head = s.split(" ")[0]
                lengths.append(int(head))
                texts.append(s[len(head) + 1:])
    return texts, lengths


def _check_joints(torch, joints, mask, shape):
    if tuple(joints.shape) != shape:
        raise RuntimeError(f"joints shape {tuple(joints.shape)} != {shape}")
    if not torch.isfinite(joints).all():
        raise RuntimeError("non-finite joints")
    outside = joints[~mask]
    if outside.numel() and outside.abs().max().item() != 0.0:
        raise RuntimeError("joints are not zero outside the mask")


def _counters():
    from mld_tpu_torch.ops import attention, fused_layer, fused_seq_decoder
    return ((fused_layer, "LAUNCHES", "skip_encoder"),
            (fused_seq_decoder, "LAUNCHES", "skip_decoder"),
            (fused_seq_decoder, "KERNELS", "skip_decoder_kernels"),
            (attention, "LAUNCHES", "flash_causal"),
            (attention, "FLASH_LAUNCHES", "flash_attention"))


def _reset_counts():
    for mod, attr, _ in _counters():
        setattr(mod, attr, 0)


def _read_counts():
    return {name: getattr(mod, attr) for mod, attr, name in _counters()}


def _check_counts(counts, want, what):
    if counts != want:
        raise RuntimeError(f"{what}: kernel launches {counts}, expected "
                           f"{want}")


def drive(torch, mld, label, texts, lengths):
    """The main path in one configuration: demo prompts, then B=128."""
    import numpy as np

    from mld_tpu_torch.models.mld import lengths_to_mask
    from mld_tpu_torch.ops.fused_seq_decoder import launch_count

    n_steps = len(mld.scheduler.timesteps())
    n_clip = mld.cfg.model.clip_layers
    # the plain VAE decode: self- and cross-attention in each layer
    n_decode_attn = 2 * mld.cfg.model.num_layers
    want = {"skip_encoder": n_steps,
            "skip_decoder": int(mld.fused_decode),
            "skip_decoder_kernels": int(mld.fused_decode) * launch_count(
                N_BLOCK, mld.latent_size),
            "flash_causal": 2 * n_clip,
            "flash_attention": 0 if mld.fused_decode else n_decode_attn}
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 2)

    _reset_counts()
    t0 = time.perf_counter()
    motions = mld.generate(texts, lengths, generator=gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counts()
    _check_counts(counts, want, f"{label} generate")
    for motion, n in zip(motions, lengths):
        if motion.shape != (n, mld.njoints, 3):
            raise RuntimeError(f"bad motion {motion.shape} for length {n}")
        if not np.isfinite(motion).all():
            raise RuntimeError(f"non-finite motion for length {n}")
    log(f"[main:{label}] generate: {len(texts)} prompts in {wall:.3f} s "
        f"(first call), launches {counts}, shapes "
        f"{[tuple(x.shape) for x in motions]}")

    reps = -(-B_LARGE // len(texts))
    btexts = (texts * reps)[:B_LARGE]
    blengths = (lengths * reps)[:B_LARGE]
    ids = mld.tokenize(btexts)
    mask = lengths_to_mask(blengths, mld.max_frames, mld.device)
    _reset_counts()
    t0 = time.perf_counter()
    joints = mld.generate_joints(ids, mask, generator=gen)
    torch.cuda.synchronize()
    wall_b = time.perf_counter() - t0
    counts_b = _read_counts()
    _check_counts(counts_b, want, f"{label} generate_joints B={B_LARGE}")
    _check_joints(torch, joints, mask,
                  (B_LARGE, mld.max_frames, mld.njoints, 3))
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        mld.generate_joints(ids, mask, generator=gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = sorted(times)[1]
    log(f"[main:{label}] generate_joints B={B_LARGE}: first {wall_b:.4f} s, "
        f"then {', '.join(f'{t:.4f}' for t in times)} s (median {med:.4f} s, "
        f"{B_LARGE / med:.1f} motions/s), launches a call {counts_b}")

    # the two stages the kernel configuration changes, alone at B=128
    z = torch.randn(B_LARGE, mld.latent_size, mld.latent_dim, device=DEVICE,
                    generator=gen)
    text_ms = _time_ms(torch, lambda: mld.encode_text_tokens(ids), 10, 2)
    dec_ms = _time_ms(torch, lambda: mld.decode_latent(z, mask), 10, 2)
    log(f"[main:{label}] stages at B={B_LARGE}: text tower {text_ms:.4f} ms "
        f"(ids {tuple(ids.shape)}), VAE decode {dec_ms:.4f} ms")
    return {"counts": counts_b, "median_s": med, "text_ms": text_ms,
            "decode_ms": dec_ms, "prompt_len": ids.shape[1]}


def phase_main_path(torch):
    from mld_tpu_torch.config import load_config
    from mld_tpu_torch.models.mld import MLD

    cfg = load_config(preset="mld_humanml3d")
    m = cfg.model
    log(f"[main] mld_humanml3d: CLIP {m.clip_layers}x{m.text_encoded_dim} "
        f"{m.clip_compute_dtype}, denoiser {m.denoiser_num_layers}x"
        f"{m.latent_dim}, VAE {m.num_layers}x{m.latent_dim}, "
        f"{cfg.dataset.max_motion_len} frames, DDIM-"
        f"{m.scheduler.num_inference_timesteps}, CFG {m.guidance_scale}")
    texts, lengths = _demo_prompts()
    runs = {}
    kernel_results = None
    for label, kw in CONFIGS:
        t0 = time.perf_counter()
        mld = MLD(cfg, device=DEVICE,
                  generator=torch.Generator().manual_seed(SEED), **kw)
        torch.cuda.synchronize()
        log(f"[main:{label}] built MLD on {DEVICE} in "
            f"{time.perf_counter() - t0:.1f} s (fused_decode="
            f"{mld.fused_decode})")
        if kernel_results is None:
            t1 = time.perf_counter()
            kernel_results = phase_kernels(torch, mld, lengths)
            log(f"[time] kernels vs plain: {time.perf_counter() - t1:.1f} s")
        runs[label] = drive(torch, mld, label, texts, lengths)
        log(f"[time] main path {label}: {time.perf_counter() - t0:.1f} s")
        del mld
        torch.cuda.empty_cache()
    counts = runs["kernels"]["counts"]
    log(f"[main] K5 entry: {counts['skip_decoder_kernels']} kernels counted "
        f"in {counts['skip_decoder']} call(s); text tower "
        f"{runs['default']['text_ms']:.4f} -> "
        f"{runs['kernels']['text_ms']:.4f} ms, VAE decode "
        f"{runs['default']['decode_ms']:.4f} -> "
        f"{runs['kernels']['decode_ms']:.4f} ms, generate_joints "
        f"{runs['default']['median_s']:.4f} -> "
        f"{runs['kernels']['median_s']:.4f} s")

    t0 = time.perf_counter()
    for label, kw in CONFIGS:
        phase_reference(torch, cfg, texts[0], lengths[0], label, kw)
    log(f"[time] main path reference: {time.perf_counter() - t0:.1f} s")
    return kernel_results, runs, texts, lengths


def phase_reference(torch, cfg, text, length, label, kw):
    """One prompt on the card (kernels) and on the CPU (plain versions),
    same weights and initial noise, f32 text tower on both."""
    from mld_tpu_torch.config.core import config_from_dict, merge_dicts
    from mld_tpu_torch.config.core import config_to_dict
    from mld_tpu_torch.models.mld import MLD, lengths_to_mask

    cfg32 = config_from_dict(merge_dicts(
        config_to_dict(cfg), {"model": {"clip_compute_dtype": "float32"}}))
    out = {}
    init = torch.randn(1, cfg.model.latent_size, cfg.model.latent_dim,
                       generator=torch.Generator().manual_seed(SEED + 3))
    for dev in (DEVICE, "cpu"):
        # K1 on the card and its plain version on the CPU: the CPU's default
        # is the module path (LayerNorm eps 1e-6, not K1's 1e-5)
        mld = MLD(cfg32, device=dev, fused_denoiser=True,
                  generator=torch.Generator().manual_seed(SEED), **kw)
        mask = lengths_to_mask([length], mld.max_frames, mld.device)
        _reset_counts()
        out[dev] = mld.generate_joints(mld.tokenize([text]), mask,
                                       init_latents=init).cpu()
        counts = _read_counts()
        del mld
        if dev == "cpu" and any(counts.values()):
            raise RuntimeError(f"the CPU run launched kernels: {counts}")
    scale = out["cpu"].abs().max().item()
    err = (out[DEVICE] - out["cpu"]).abs().max().item()
    log(f"[reference:{label}] card vs CPU joints, one prompt: max_abs_err "
        f"{err:.3e} (scale {scale:.3e}, bar {E2E_RTOL:g} x max(scale, 1))")
    if not err <= E2E_RTOL * max(scale, 1.0):
        raise RuntimeError(f"card joints disagree with the CPU reference "
                           f"({label})")


def _raw_want(mld, n_steps):
    m = mld.cfg.model
    return {"skip_encoder": 0, "skip_decoder": 0, "skip_decoder_kernels": 0,
            "flash_causal": 2 * m.clip_layers,
            "flash_attention": 2 * m.denoiser_num_layers * n_steps}


def drive_raw(torch, mld, preset, texts, lengths):
    """The raw-motion main path: the prompts through MLD.generate (warm),
    then one timed generate_joints on the same prompts."""
    import numpy as np

    from mld_tpu_torch.models.mld import lengths_to_mask

    n_steps = len(mld.scheduler.timesteps())
    want = _raw_want(mld, n_steps)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
    _reset_counts()
    t0 = time.perf_counter()
    motions = mld.generate(texts, lengths, generator=gen)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    _check_counts(_read_counts(), want, f"{preset} generate")
    for motion, n in zip(motions, lengths):
        if motion.shape != (n, mld.njoints, 3):
            raise RuntimeError(f"bad motion {motion.shape} for length {n}")
        if not np.isfinite(motion).all():
            raise RuntimeError(f"non-finite motion for length {n}")

    ids = mld.tokenize(texts)
    mask = lengths_to_mask(lengths, mld.max_frames, mld.device)
    _reset_counts()
    t0 = time.perf_counter()
    joints = mld.generate_joints(ids, mask, generator=gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counts()
    _check_counts(counts, want, f"{preset} generate_joints")
    _check_joints(torch, joints, mask,
                  (len(texts), mld.max_frames, mld.njoints, 3))
    scale = joints.abs().max().item()
    log(f"[raw:{preset}] B={len(texts)} lengths {lengths}: generate "
        f"{warm:.3f} s (first call), generate_joints {wall:.3f} s "
        f"({wall / n_steps * 1e3:.3f} ms a step), "
        f"launches a call {counts}, joints scale {scale:.3e}")
    return {"counts": counts, "warm_s": warm, "s": wall}


def _cut_config(cfg, n_steps, **model):
    """cfg with its DDPM schedule cut to n_steps train timesteps (the same
    betas' range: the same work a step, n_steps steps) and the `model`
    fields overridden."""
    from mld_tpu_torch.config.core import (config_from_dict, config_to_dict,
                                           merge_dicts)
    return config_from_dict(merge_dicts(config_to_dict(cfg), {"model": {
        **model, "scheduler": {"num_train_timesteps": n_steps}}}))


def profile_raw_loop(torch, cfg, texts, lengths):
    """Device busy time of PROFILE_STEPS sampling steps at the demo batch,
    by torch.profiler, against the same loop's unprofiled wall time; the
    model is the preset's with its schedule cut to PROFILE_STEPS."""
    from torch.profiler import ProfilerActivity, profile

    from mld_tpu_torch.models.mld import MLD, lengths_to_mask

    mld = MLD(_cut_config(cfg, PROFILE_STEPS), device=DEVICE,
              generator=torch.Generator().manual_seed(SEED))
    ids = mld.tokenize(texts)
    mask = lengths_to_mask(lengths, mld.max_frames, mld.device)
    cond = mld.encode_text_tokens(ids)
    uncond = mld.encode_text_tokens(
        torch.as_tensor(mld.uncond_ids, device=mld.device))
    cond = torch.cat([uncond.expand_as(cond), cond])
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 6)
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mld.diffusion_reverse(cond, gen, mask=mask)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        mld.diffusion_reverse(cond, gen, mask=mask)
        torch.cuda.synchronize()
    by_name = Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] += e.time_range.elapsed_us()
    busy_ms = sum(by_name.values()) / 1e3
    groups = Counter()
    for name, us in by_name.items():
        kind = ("K3 flash_kernel" if "flash_kernel" in name
                else "GEMM" if "gemm" in name.lower() else "other")
        groups[kind] += us / 1e3
    wall_ms = min(walls) * 1e3
    per = 1.0 / PROFILE_STEPS
    log(f"[raw:profile] {PROFILE_STEPS} steps at B={len(texts)}, T="
        f"{mld.max_frames}: wall {wall_ms * per:.3f} ms a step (unprofiled, "
        f"best of 2), device busy {busy_ms * per:.3f} ms a step "
        f"({100 * (1 - busy_ms / wall_ms):.1f}% idle); busy by kind: "
        + ", ".join(f"{k} {v * per:.3f} ms" for k, v in groups.most_common()))
    for name, us in by_name.most_common(6):
        log(f"[raw:profile]   {us / 1e3 * per:.4f} ms a step  {name[:110]}")
    return {"wall_ms_step": wall_ms * per, "busy_ms_step": busy_ms * per,
            "by_kind_ms_step": {k: v * per for k, v in groups.items()}}


def phase_raw_reference(torch, cfg, text, length):
    """One prompt of the raw-motion path on the card (K3, K4) and on the CPU
    (plain versions), f32 text tower on both, same weights, initial latents
    and per-step noise, the schedule cut to RAW_REF_STEPS train timesteps."""
    from mld_tpu_torch.models.mld import MLD, lengths_to_mask

    cfg_ref = _cut_config(cfg, RAW_REF_STEPS, clip_compute_dtype="float32")
    g = torch.Generator().manual_seed(SEED + 5)
    shape = (1, cfg.dataset.max_motion_len, cfg.dataset.nfeats)
    init = torch.randn(shape, generator=g)
    noise = torch.randn((RAW_REF_STEPS,) + shape, generator=g)
    out = {}
    for dev in (DEVICE, "cpu"):
        mld = MLD(cfg_ref, device=dev,
                  generator=torch.Generator().manual_seed(SEED))
        mask = lengths_to_mask([length], mld.max_frames, mld.device)
        _reset_counts()
        out[dev] = mld.generate_joints(mld.tokenize([text]), mask,
                                       init_latents=init,
                                       step_noise=noise).cpu()
        counts = _read_counts()
        want = (_raw_want(mld, RAW_REF_STEPS) if dev == DEVICE
                else {k: 0 for k in counts})
        del mld
        _check_counts(counts, want, f"raw-motion reference on {dev}")
    scale = out["cpu"].abs().max().item()
    err = (out[DEVICE] - out["cpu"]).abs().max().item()
    log(f"[reference:{cfg.name}] card vs CPU joints, one prompt, length "
        f"{length}, {RAW_REF_STEPS} DDPM steps: max_abs_err {err:.3e} (scale "
        f"{scale:.3e}, bar {E2E_RTOL:g} x max(scale, 1))")
    if not err <= E2E_RTOL * max(scale, 1.0):
        raise RuntimeError(f"card joints disagree with the CPU reference "
                           f"({cfg.name})")
    return err


def _scaled_lengths(lengths, max_frames):
    """The demo lengths (up to 196 frames) scaled to max_frames."""
    return [min(max_frames, round(n * max_frames / T_FRAMES))
            for n in lengths]


def phase_raw_motion(torch, texts, lengths):
    from mld_tpu_torch.config import load_config
    from mld_tpu_torch.models.mld import MLD

    runs = {}
    for preset in RAW_PRESETS:
        t0 = time.perf_counter()
        cfg = load_config(preset=preset)
        m = cfg.model
        mld = MLD(cfg, device=DEVICE,
                  generator=torch.Generator().manual_seed(SEED))
        torch.cuda.synchronize()
        log(f"[raw:{preset}] CLIP {m.clip_layers}x{m.text_encoded_dim} "
            f"{m.clip_compute_dtype}, trans_dec denoiser "
            f"{m.denoiser_num_layers}x{m.latent_dim} ({m.num_heads} heads, ff "
            f"{m.ff_size}), {mld.max_frames} frames, DDPM-"
            f"{m.scheduler.num_train_timesteps}, CFG {m.guidance_scale}; "
            f"built on {DEVICE} in {time.perf_counter() - t0:.1f} s")
        plens = _scaled_lengths(lengths, mld.max_frames)
        runs[preset] = drive_raw(torch, mld, preset, texts, plens)
        del mld
        runs[preset]["profile"] = profile_raw_loop(torch, cfg, texts, plens)
        if preset == "novae_stress_s512":
            ref_cfg, ref_len = cfg, plens[0]
        log(f"[time] raw-motion {preset}: {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    runs["reference_err"] = phase_raw_reference(torch, ref_cfg, texts[0],
                                                ref_len)
    log(f"[time] raw-motion reference: {time.perf_counter() - t0:.1f} s")
    return runs

# ------------------------------------------------------------------ training
# model overrides of the training phase (none: the preset's full width)
TRAIN_MODEL = {}


def _sync(torch):
    torch.cuda.synchronize()


def _train_cfg(stage, dropout=None, **train):
    from mld_tpu_torch.config import load_config

    model = dict(TRAIN_MODEL)
    if dropout is not None:
        model["dropout"] = dropout
    return load_config(preset="mld_humanml3d", overrides={
        "name": f"smoke_{stage}", "debug": True, "model": model,
        "dataset": {"root": os.path.join(TRAIN_ROOT, "humanml3d")},
        "train": {"stage": stage, "batch_size": TRAIN_B, **train},
        "logger": {"folder": os.path.join(TRAIN_ROOT, "experiments"),
                   "save_checkpoint_epoch": 10 ** 6,
                   "val_every_epochs": 10 ** 6}})


def _train_want(cfg, stage):
    """Kernel launches of one training step, from the config. Dropout > 0
    sends the trainable modules' attention to the plain version (the
    reference's dispatch), so with it K3 runs only under no grad: in the
    frozen VAE encode of the diffusion loss and in the generation pass's
    plain decode (self- and cross-attention a layer); with dropout 0 the
    trainable attention takes K3 too (the vae loss's encoder layers and
    decoder layers, self- and cross-attention, and the denoiser's layers).
    K4 runs for the prompts and the uncond row (an action has no text
    tower); K1 once a DDIM step of the generation pass. The MLD VAE and the
    ACTOR VAE count alike: num_layers encoder and decoder layers, each
    decoder layer self- and cross-attention, but the all_encoder arch's
    (self-attention only)."""
    m = cfg.model
    want = {"skip_encoder": 0, "skip_decoder": 0, "skip_decoder_kernels": 0,
            "flash_causal": 0, "flash_attention": 0}
    text = 2 * m.clip_layers if m.condition != "action" else 0
    dec = 1 if m.vae_arch == "all_encoder" and m.vae_type == "mld" else 2
    if m.dropout == 0.0 and stage in ("vae", "vae_diffusion"):
        want["flash_attention"] = (1 + dec) * m.num_layers
    if stage == "vae":
        return want
    want["flash_causal"] = text
    want["flash_attention"] += m.num_layers
    if m.dropout == 0.0:
        want["flash_attention"] += m.denoiser_num_layers
    if stage == "vae_diffusion":
        want["flash_causal"] += text
        want["flash_attention"] += 2 * m.num_layers
        want["skip_encoder"] = m.scheduler.num_inference_timesteps
    return want


def _peak_mib(torch):
    """The card's peak allocated memory since the last reset, MiB."""
    return torch.cuda.max_memory_allocated() / 2 ** 20


def _reset_peak(torch):
    torch.cuda.reset_peak_memory_stats()


class _StepWatch:
    """The on_step callback of train(): the params before the first step,
    then each step's launches (checked, the last kept), the loop's wall ms
    from one step's end to the next's (ending in a synchronize), finite
    logs, each step's peak allocated memory, and a torch.profiler trace of
    the steps after `traced[0]` through `traced[1]`. `step_ms` is filled by
    `timed_steps`."""

    def __init__(self, torch, want, traced=(None, None)):
        self.torch, self.want, self.traced = torch, want, traced
        self.ms, self.logs, self.before, self.prof = {}, [], None, None
        self.step_ms, self.counts, self.busy = {}, None, None
        self.peak = {}

    def __call__(self, state, step, logs):
        torch = self.torch
        _sync(torch)
        now = time.perf_counter()
        if step == 0:
            self.before = {k: p.detach().clone()
                           for k, p in state.mld.named_parameters()}
            self.trainable = set(state.params)
        else:
            self.ms[step] = (now - self.t) * 1e3
            self.peak[step] = _peak_mib(torch)
            self.counts = _read_counts()
            _check_counts(self.counts, self.want, f"training step {step}")
            vals = {k: float(v) for k, v in logs.items()}
            if not all(map(math.isfinite, vals.values())):
                raise RuntimeError(f"non-finite training logs {vals}")
            self.logs.append(vals)
        first, last = self.traced
        if step == last:
            wall = time.perf_counter() - self.t_prof
            self.prof.__exit__(None, None, None)
            device = [e.time_range.elapsed_us() for e in self.prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA]
            busy = sum(device)
            n = last - first
            # where the host's time goes: the ops with the most self CPU
            # time, per step
            host = sorted(self.prof.key_averages(),
                          key=lambda a: a.self_cpu_time_total,
                          reverse=True)[:6]
            self.busy = {"steps": n, "wall_ms": wall * 1e3,
                         "busy_ms": busy / 1e3,
                         "busy_share": busy / 1e6 / wall,
                         "device_kernels_a_step": len(device) / n,
                         "host_top_ms_a_step": [
                             (a.key[:60], a.self_cpu_time_total / 1e3 / n,
                              a.count / n) for a in host]}
        if step == first:
            from torch.profiler import ProfilerActivity, profile
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.t_prof = time.perf_counter()
        _reset_counts()
        _reset_peak(torch)
        self.t = time.perf_counter()

    def median_ms(self, times):
        first, last = self.traced
        kept = [ms for step, ms in times.items()
                if step > 1 and not (first is not None
                                     and first < step <= last)]
        return statistics.median(kept), len(kept)


@contextlib.contextmanager
def timed_steps(torch, watch):
    """Time each train_step the loop calls, from a synchronize before it to
    one after it, into watch.step_ms: the step without the loader and the
    epoch's bookkeeping."""
    from mld_tpu_torch.train import loop

    inner = loop.train_step

    def timed(*args, **kwargs):
        _sync(torch)
        t = time.perf_counter()
        logs = inner(*args, **kwargs)
        _sync(torch)
        watch.step_ms[len(watch.step_ms) + 1] = (time.perf_counter() - t) * 1e3
        return logs

    loop.train_step = timed
    try:
        yield
    finally:
        loop.train_step = inner


def _check_params(torch, label, watch, mld):
    """Frozen params bit-identical, every trainable module moved."""
    after = dict(mld.named_parameters())
    frozen = [k for k in watch.before if k not in watch.trainable]
    changed = [k for k in frozen if not torch.equal(after[k],
                                                    watch.before[k])]
    if changed:
        raise RuntimeError(f"{label}: frozen params changed: {changed[:5]}")
    moved = [k for k in watch.trainable
             if not torch.equal(after[k], watch.before[k])]
    tops = {k.split(".", 1)[0] for k in watch.trainable}
    if {k.split(".", 1)[0] for k in moved} != tops:
        raise RuntimeError(f"{label}: trainable modules {tops} did not all "
                           f"move")
    return len(moved), len(watch.trainable), len(frozen)


def run_stage(torch, cfg, stage, smi, steps=None, traced=None, label=None,
              **kw):
    """One stage through the loop's train(), checked and timed: by default
    phase 6's steps and traced steps of the stage."""
    from mld_tpu_torch.train.loop import train

    want = _train_want(cfg, stage)
    watch = _StepWatch(torch, want, traced or TRAIN_TRACED[stage])
    label = label or stage
    t0 = time.perf_counter()
    with timed_steps(torch, watch):
        mld = train(cfg, max_steps=steps or TRAIN_STEPS[stage],
                    device=DEVICE, on_step=watch, **kw)
    wall = time.perf_counter() - t0
    moved, n_train, n_frozen = _check_params(torch, stage, watch, mld)
    with open(os.path.join(cfg.logger.folder, "mld", cfg.name,
                           "metrics.jsonl")) as f:
        epochs = sum(json.loads(line)["split"] == "train" for line in f)
    step_med, n_step = watch.median_ms(watch.step_ms)
    loop_med, n_loop = watch.median_ms(watch.ms)
    # the peak of the untraced steps after the first
    peak = max(mib for step, mib in watch.peak.items() if step > 1 and not (
        watch.traced[0] < step <= watch.traced[1]))
    b = watch.busy
    first, last = watch.logs[0], watch.logs[-1]
    log(f"[train:{label}] B={cfg.train.batch_size} dropout "
        f"{cfg.model.dropout}: {len(watch.ms)} steps in {epochs} epochs; "
        f"train_step median "
        f"{step_med:.2f} ms (n={n_step} untraced steps after the first; "
        f"all: {', '.join(f'{v:.1f}' for v in watch.step_ms.values())}); "
        f"loop median {loop_med:.2f} ms between steps (n={n_loop}; the "
        f"loader and the epochs' ends add {loop_med - step_med:.2f} ms; all: "
        f"{', '.join(f'{v:.1f}' for v in watch.ms.values())}); device "
        f"busy {100 * b['busy_share']:.1f}% of {b['wall_ms']:.1f} ms of the "
        f"loop over {b['steps']} traced step(s); launches a step "
        f"{watch.counts}; trainable {moved}/{n_train} tensors moved, "
        f"{n_frozen} frozen unchanged; total {first['total']:.4f} -> "
        f"{last['total']:.4f}; peak allocated {peak:.1f} MiB a step; "
        f"{wall:.1f} s with set-up; {smi}")
    log(f"[train:{label}] traced: {b['device_kernels_a_step']:.0f} device "
        f"kernels a step; host self time a step by op: " + ", ".join(
            f"{name} {ms:.2f} ms x{count:.0f}"
            for name, ms, count in b["host_top_ms_a_step"]))
    return mld, watch, {"step_median_ms": step_med, "step_n": n_step,
                        "loop_median_ms": loop_med, "loop_n": n_loop,
                        "epochs": epochs, "peak_mib": peak,
                        "busy": b, "launches": watch.counts,
                        "logs_first": first, "logs_last": last}


def _batch(torch, cfg, B, device):
    from mld_tpu_torch.data.datamodule import get_datamodule
    from mld_tpu_torch.models.clip_text import ClipTokenizer
    from mld_tpu_torch.train.steps import batch_to_device

    dm = get_datamodule(cfg, tokenizer=ClipTokenizer(cfg.model.clip_path))
    batch = next(iter(dm.loader("train", batch_size=B, prefetch=0,
                                drop_last=True)))
    return batch_to_device(batch, device), dm


def _diffusion_draws(torch, cfg, B, seed):
    """A diffusion step's draws from a CPU generator (steps.diffusion_loss's
    draws= keys: the CFG drop for text, EmbedAction's keep for an action),
    so that two runs take the same."""
    m = cfg.model
    g = torch.Generator().manual_seed(seed)
    lat = (B, m.latent_size, m.latent_dim)
    eps = torch.randn(lat, generator=g)
    u = torch.rand(B, generator=g)
    cond = ({"keep": u < 1.0 - m.guidance_uncondp}
            if m.condition == "action"
            else {"cfg_drop": u < m.guidance_uncondp})
    return {"eps": eps, **cond, "noise": torch.randn(lat, generator=g),
            "t": torch.randint(0, m.scheduler.num_train_timesteps, (B,),
                               generator=g)}


def _grad_err(a_logs, a_grads, b_logs, b_grads):
    """Largest relative error of the loss and of any gradient leaf against
    its largest |g| (b is the reference)."""
    loss = abs(float(a_logs["total"]) - float(b_logs["total"])) / max(
        abs(float(b_logs["total"])), 1e-12)
    worst = max(float((a_grads[k].cpu() - g.cpu()).abs().max())
                / max(float(g.abs().max()), 1e-12)
                for k, g in b_grads.items())
    return loss, worst


def check_k3_autograd(torch, cfg, batch, dm):
    """One diffusion step, dropout 0: the denoiser's attention runs K3
    through its autograd.Function; held against the same step with every
    bidirectional attention on the plain version, on the card."""
    from mld_tpu_torch.models.mld import MLD
    from mld_tpu_torch.ops import attention, transformer
    from mld_tpu_torch.train import steps

    mld = MLD(cfg, mean=dm.mean, std=dm.std, device=DEVICE,
              generator=torch.Generator().manual_seed(SEED))
    state = steps.create_train_state(mld, "diffusion")
    draws = _diffusion_draws(torch, cfg, batch["motion"].shape[0], SEED + 7)
    _reset_counts()
    logs, grads = steps.compute_grads(state, batch, None, draws)
    _sync(torch)
    counts = _read_counts()
    _check_counts(counts, _train_want(cfg, "diffusion"),
                  "diffusion step with K3 under autograd")
    grads = {k: g.clone() for k, g in grads.items()}
    kernel_sdpa = transformer.sdpa
    transformer.sdpa = (lambda q, k, v, key_valid=None, dropout_rate=0.0,
                        generator=None: attention.flash_plain(
                            q, k, v, key_valid, dropout_rate, generator))
    try:
        _reset_counts()
        plain_logs, plain_grads = steps.compute_grads(state, batch, None,
                                                      draws)
        _sync(torch)
    finally:
        transformer.sdpa = kernel_sdpa
    if _read_counts()["flash_attention"] != 0:
        raise RuntimeError("the plain-attention step launched K3")
    loss_err, grad_err = _grad_err(logs, grads, plain_logs, plain_grads)
    log(f"[train:k3-autograd] diffusion step B={batch['motion'].shape[0]} "
        f"dropout 0, K3 forward + plain VJP vs plain attention on the card: "
        f"launches {counts}; loss rel err {loss_err:.2e}, worst gradient "
        f"leaf {grad_err:.2e} of its scale (bar {K3_GRAD_RTOL:g})")
    if not (loss_err <= K3_GRAD_RTOL and grad_err <= K3_GRAD_RTOL):
        raise RuntimeError("K3 under autograd disagrees with the plain "
                           "attention")
    return {"loss_rel_err": loss_err, "grad_rel_err": grad_err}


def check_k4_autograd(torch, cfg, batch, dm):
    """The f32 text tower's forward and backward at the batch's full-context
    prompts with its params tracked: K4 runs through its autograd.Function
    (one launch a layer); its gradients held against the same pass with the
    causal attention on the plain version, on the card."""
    from mld_tpu_torch.models import clip_text
    from mld_tpu_torch.models.mld import MLD
    from mld_tpu_torch.ops import attention

    mld = MLD(cfg, mean=dm.mean, std=dm.std, device=DEVICE,
              generator=torch.Generator().manual_seed(SEED))
    params = [p.requires_grad_() for p in mld.clip.parameters()]
    ids = batch["text_ids"]

    def run():
        out = mld.clip(ids, mode=mld.clip_mode)
        g = torch.Generator(device=DEVICE).manual_seed(SEED + 9)
        cot = torch.randn(out.shape, generator=g, device=DEVICE)
        return out.detach(), torch.autograd.grad((out * cot).sum(), params)

    _reset_counts()
    out, grads = run()
    _sync(torch)
    counts = _read_counts()
    want = dict.fromkeys(counts, 0)
    want["flash_causal"] = cfg.model.clip_layers
    _check_counts(counts, want, "text tower under autograd")
    kernel = clip_text.sdpa_flash_causal
    clip_text.sdpa_flash_causal = attention.flash_causal_plain
    try:
        _reset_counts()
        plain_out, plain_grads = run()
        _sync(torch)
    finally:
        clip_text.sdpa_flash_causal = kernel
    if _read_counts()["flash_causal"] != 0:
        raise RuntimeError("the plain-attention pass launched K4")
    out_err = float((out - plain_out).abs().max()) / max(
        float(plain_out.abs().max()), 1e-12)
    names = [k for k, _ in mld.clip.named_parameters()]
    scale = max(float(b.abs().max()) for b in plain_grads)
    errs = sorted(((float((a - b).abs().max()), float(b.abs().max()), k)
                   for k, a, b in zip(names, grads, plain_grads)),
                  reverse=True)
    grad_err = errs[0][0] / scale
    log(f"[train:k4-autograd] f32 text tower [{ids.shape[0]}, "
        f"{ids.shape[1]}] forward + backward, K4 forward + plain VJP vs "
        f"plain attention on the card: {counts['flash_causal']} K4 "
        f"launches; output rel err {out_err:.2e}, worst gradient leaf "
        f"{grad_err:.2e} of the tower's largest |g| {scale:.3e} over "
        f"{len(params)} leaves (bar {K4_GRAD_RTOL:g}); largest errors: "
        + ", ".join(f"{k} {e:.2e} (its |g| {m:.2e})" for e, m, k in errs[:3]))
    if not (out_err <= K4_GRAD_RTOL and grad_err <= K4_GRAD_RTOL):
        raise RuntimeError("K4 under autograd disagrees with the plain "
                           "attention")
    return {"out_rel_err": out_err, "grad_rel_err": grad_err}


def check_train_reference(torch, cfg, dm):
    """One full-width diffusion step at B=REF_TRAIN_B, dropout 0, f32 text
    tower: the card (kernels) against the CPU (plain versions), the same
    params, batch and draws."""
    from mld_tpu_torch.models.mld import MLD
    from mld_tpu_torch.train import steps

    batch, _ = _batch(torch, cfg, REF_TRAIN_B, "cpu")
    draws = _diffusion_draws(torch, cfg, REF_TRAIN_B, SEED + 8)
    out = {}
    for dev in (DEVICE, "cpu"):
        mld = MLD(cfg, mean=dm.mean, std=dm.std, device=dev,
                  generator=torch.Generator().manual_seed(SEED))
        state = steps.create_train_state(mld, "diffusion")
        dbatch = {k: v.to(dev) for k, v in batch.items()}
        _reset_counts()
        logs, grads = steps.compute_grads(state, dbatch, None, draws)
        counts = _read_counts()
        if dev == "cpu" and any(counts.values()):
            raise RuntimeError(f"the CPU step launched kernels: {counts}")
        out[dev] = ({k: v.cpu() for k, v in logs.items()},
                    {k: g.cpu() for k, g in grads.items()})
        del mld, state
    loss_err, grad_err = _grad_err(*out[DEVICE], *out["cpu"])
    log(f"[train:reference] full-width diffusion step B={REF_TRAIN_B}, "
        f"card vs CPU: loss {float(out[DEVICE][0]['total']):.6f} vs "
        f"{float(out['cpu'][0]['total']):.6f} (rel err {loss_err:.2e}), "
        f"worst gradient leaf {grad_err:.2e} of its scale (bar "
        f"{TRAIN_REF_RTOL:g})")
    if not (loss_err <= TRAIN_REF_RTOL and grad_err <= TRAIN_REF_RTOL):
        raise RuntimeError("the card's training step disagrees with the CPU")
    return {"loss_rel_err": loss_err, "grad_rel_err": grad_err}


def phase_training(torch, smi):
    """The port's training entry point on the card: the corpus, the three
    stages (vae with one resume, the handoff to diffusion, vae_diffusion),
    then K3 under autograd and a card-vs-CPU step."""
    import shutil

    from mld_tpu_torch.data.synthetic import build_synthetic_dataset
    from mld_tpu_torch.train.loop import train
    from mld_tpu_torch.utils.checkpoint import CheckpointManager

    shutil.rmtree(TRAIN_ROOT, ignore_errors=True)
    t0 = time.perf_counter()
    build_synthetic_dataset(os.path.join(TRAIN_ROOT, "humanml3d"),
                            n_samples=TRAIN_CLIPS, seed=SEED)
    log(f"[train] synthetic corpus: {TRAIN_CLIPS} clips in "
        f"{time.perf_counter() - t0:.1f} s (build_synthetic_dataset, host)")
    runs = {}

    cfg = _train_cfg("vae")
    mld, _, runs["vae"] = run_stage(torch, cfg, "vae", smi)
    del mld
    vae_dir = os.path.join(cfg.logger.folder, "mld", cfg.name, "checkpoints")
    mgr = CheckpointManager(vae_dir)
    saved = mgr.restore(map_location=DEVICE)
    watch = _StepWatch(torch, _train_want(cfg, "vae"))
    mld = train(cfg, max_steps=1, resume=True, device=DEVICE, on_step=watch)
    restored = [k for k, v in saved["state_dict"].items()
                if not torch.equal(watch.before[k], v)]
    if restored or mgr.latest_step() != saved["step"] + 1:
        raise RuntimeError(f"resume did not restore the checkpoint of epoch "
                           f"{saved['step']}: {restored[:5]}, latest "
                           f"{mgr.latest_step()}")
    log(f"[train:vae] resumed from the checkpoint of epoch {saved['step']} "
        f"(every saved tensor restored), one more step, saved epoch "
        f"{mgr.latest_step()}")
    del mld, saved
    torch.cuda.empty_cache()

    cfg = _train_cfg("diffusion", pretrained_vae=vae_dir)
    mld, watch, runs["diffusion"] = run_stage(torch, cfg, "diffusion", smi)
    handed = mgr.restore(map_location=DEVICE)["state_dict"]
    for k, p in mld.vae.named_parameters():
        if not torch.equal(p, handed["vae." + k]):
            raise RuntimeError(f"the diffusion stage's VAE is not the "
                               f"handed-over one: vae.{k}")
    log(f"[train:diffusion] its frozen VAE is the vae stage's checkpoint "
        f"(epoch {mgr.latest_step()}), bit for bit")
    diff_dir = os.path.join(cfg.logger.folder, "mld", cfg.name,
                            "checkpoints")
    del mld, watch, handed
    torch.cuda.empty_cache()

    cfg = _train_cfg("vae_diffusion", pretrained=diff_dir)
    mld, watch, runs["vae_diffusion"] = run_stage(torch, cfg,
                                                  "vae_diffusion", smi)
    del mld, watch
    torch.cuda.empty_cache()

    cfg = _train_cfg("diffusion", dropout=0.0)
    batch, dm = _batch(torch, cfg, TRAIN_B, DEVICE)
    runs["k3_autograd"] = check_k3_autograd(torch, cfg, batch, dm)
    torch.cuda.empty_cache()
    from mld_tpu_torch.config.core import (config_from_dict, config_to_dict,
                                           merge_dicts)
    cfg32 = config_from_dict(merge_dicts(config_to_dict(cfg), {
        "model": {"clip_compute_dtype": "float32"}}))
    runs["k4_autograd"] = check_k4_autograd(torch, cfg32, batch, dm)
    torch.cuda.empty_cache()
    runs["reference"] = check_train_reference(torch, cfg32, dm)
    return runs


# evaluation phase: the protocol of test.py on the synthetic corpus. 2,048
# clips give a test split of 308, above diversity_times (300), so the
# protocol's constants stand (batch 32, R groups of 32, 100 MultiModality
# texts x 30 repeats); only the replications (20 -> 1) and the corpus (the
# test split of HumanML3D holds 4,384 clips) are cut
EVAL_ROOT = os.path.join(REPO, "build", "eval_smoke")
EVAL_CLIPS = 2048
EVAL_REPLICATIONS = 1
# evaluator bundle training steps on the card (batch: cfg.train.batch_size)
EVAL_TRAIN_STEPS = 300
# HumanML3D's test split: 4,384 clips, 137 batches of 32; MultiModality: 100
# texts, 4 batches of 32 texts x 30 repeats. The projection of one
# replication multiplies the measured per-batch times by these counts
HML_TEST_BATCHES, HML_MM_BATCHES = 137, 4
# model and eval overrides of the phase (none: the preset's full width and
# the protocol's constants); a CPU rehearsal sets small ones
EVAL_MODEL = {}
EVAL_EVAL = {}
# card (kernels, f32 text tower) vs CPU (plain versions) embeddings of one
# main-pass batch: the joints bar of phase 4; the evaluators take joints'
# features through renorm4t2m and three f32 networks at no more than the
# generator's own error
EVAL_RTOL = 1e-3


def _eval_cfg(**eval_over):
    from mld_tpu_torch.config import load_config

    return load_config(preset="mld_humanml3d", overrides={
        "name": "smoke_eval", "debug": False, "model": dict(EVAL_MODEL),
        "dataset": {"root": os.path.join(EVAL_ROOT, "humanml3d")},
        "eval": {**EVAL_EVAL, **eval_over},
        "test": {"replication_times": EVAL_REPLICATIONS},
        "logger": {"folder": os.path.join(EVAL_ROOT, "experiments")}})


def _eval_want(cfg):
    """Kernel launches of one evaluated batch (main or MultiModality): the
    generation of the default configuration, as phase 4's."""
    m = cfg.model
    return {"skip_encoder": m.scheduler.num_inference_timesteps,
            "skip_decoder": 0, "skip_decoder_kernels": 0,
            "flash_causal": 2 * m.clip_layers,
            "flash_attention": 2 * m.num_layers}


def _ms(secs):
    return 1e3 * statistics.median(secs) if secs else float("nan")


def _eval_kind(name):
    """The layer a device kernel of an evaluated batch belongs to."""
    for kind, keys in (("K1 denoiser", ("skip_encoder", "skip_kernel")),
                       ("K4 CLIP attention", ("causal_kernel",)),
                       ("K3 attention", ("flash_kernel",)),
                       ("GRU (cuDNN)", ("rnn", "RNN", "gru", "GRU", "elemWise",
                                        "LSTM")),
                       ("conv (cuDNN)", ("conv", "Conv", "implicit_gemm",
                                         "xmma_fprop", "fprop")),
                       ("GEMM (cuBLAS)", ("gemm", "Gemm", "sm80_xmma",
                                          "sm90_xmma", "cutlass"))):
        if any(k in name for k in keys):
            return kind
    return "other"


def profile_eval_batch(torch, ev, batch, draws, mm, label):
    """One evaluated batch under torch.profiler: wall ms (the call ends in a
    host copy, a synchronize), device busy ms and share, and device ms by
    layer and by kernel."""
    from torch.profiler import ProfilerActivity, profile

    ev.eval_batch(batch, "diffusion", draws, mm=mm)   # warm
    _sync(torch)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ev.eval_batch(batch, "diffusion", draws, mm=mm)
        _sync(torch)
    wall = (time.perf_counter() - t0) * 1e3
    kinds, names, counts = Counter(), Counter(), Counter()
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = e.time_range.elapsed_us() / 1e3
        kinds[_eval_kind(e.name)] += ms
        names[e.name[:60]] += ms
        counts[e.name[:60]] += 1
    busy = sum(kinds.values())
    log(f"[eval:profile] {label}: wall {wall:.2f} ms traced, device busy "
        f"{busy:.2f} ms ({100 * busy / wall:.1f}%), "
        f"{sum(counts.values())} device kernels; by layer: "
        + ", ".join(f"{k} {v:.2f}" for k, v in kinds.most_common())
        + "; top kernels: " + ", ".join(
            f"{k} x{counts[k]} {v:.2f}" for k, v in names.most_common(6)))
    return {"wall_ms": wall, "busy_ms": busy, "busy_share": busy / wall,
            "by_layer_ms": dict(kinds)}


def check_eval_reference(torch, cfg, dm, tree):
    """One main-pass batch's three embeddings on the card (kernels) against
    the same model on the CPU (plain versions), same weights and initial
    latents, f32 text tower on both."""
    from mld_tpu_torch.config.core import (config_from_dict, config_to_dict,
                                           merge_dicts)
    from mld_tpu_torch.eval.pipeline import Evaluator
    from mld_tpu_torch.models.mld import MLD

    cfg32 = config_from_dict(merge_dicts(config_to_dict(cfg), {
        "model": {"clip_compute_dtype": "float32"}}))
    batch = next(iter(dm.loader("test", shuffle=False,
                                batch_size=cfg.eval.batch_size)))
    n, T = batch["mask"].shape
    init = torch.randn(n, cfg.model.latent_size, cfg.model.latent_dim,
                       generator=torch.Generator().manual_seed(SEED + 7))
    out = {}
    for dev in (DEVICE, "cpu"):
        # K1 on the card and its plain version on the CPU (the CPU's
        # default is the module path, LayerNorm eps 1e-6)
        mld = MLD(cfg32, mean=dm.mean, std=dm.std, mean_eval=dm.mean_eval,
                  std_eval=dm.std_eval, device=dev, fused_denoiser=True,
                  generator=torch.Generator().manual_seed(SEED))
        ev = Evaluator(cfg32, mld, dm, t2m_params=tree)
        _reset_counts()
        out[dev] = ev.eval_batch(batch, "diffusion", {"init_latents": init})
        counts = _read_counts()
        if dev == "cpu" and any(counts.values()):
            raise RuntimeError(f"the CPU run launched kernels: {counts}")
        del mld, ev
    errs = {}
    for key in ("lat_t", "lat_m", "lat_rm"):
        ref = out["cpu"][key]
        scale = float(abs(ref).max())
        err = float(abs(out[DEVICE][key] - ref).max())
        errs[key] = (err, scale)
        if not err <= EVAL_RTOL * max(scale, 1.0):
            raise RuntimeError(f"card {key} disagrees with the CPU: {err:.3e} "
                               f"(scale {scale:.3e})")
    log(f"[eval:reference] card vs CPU, one main-pass batch of {n}: "
        + ", ".join(f"{k} max_abs_err {e:.3e} (scale {s:.3e})"
                    for k, (e, s) in errs.items())
        + f"; bar {EVAL_RTOL:g} x max(scale, 1)")
    return {k: e for k, (e, _) in errs.items()}


def phase_evaluation(torch, smi):
    """The port's evaluation protocol on the card: the corpus, the evaluator
    bundle trained on it, then Evaluator.run (main and MultiModality
    passes) and the ground-truth pass on full-width mld_humanml3d, with the
    launches a batch, per-pass ms a batch, the host's metric seconds, the
    trained bundle against a random one, and a card-vs-CPU batch."""
    import shutil

    import numpy as np

    from mld_tpu_torch.data.datamodule import get_datamodule
    from mld_tpu_torch.data.synthetic import build_synthetic_dataset
    from mld_tpu_torch.eval.pipeline import Evaluator
    from mld_tpu_torch.eval.t2m_train import (save_t2m_params,
                                              train_t2m_evaluator)
    from mld_tpu_torch.models.clip_text import ClipTokenizer
    from mld_tpu_torch.models.mld import MLD

    shutil.rmtree(EVAL_ROOT, ignore_errors=True)
    t0 = time.perf_counter()
    build_synthetic_dataset(os.path.join(EVAL_ROOT, "humanml3d"),
                            n_samples=EVAL_CLIPS, seed=SEED)
    cfg = _eval_cfg()
    dm = get_datamodule(cfg, tokenizer=ClipTokenizer(cfg.model.clip_path))
    sizes = {s: len(dm.dataset(s)) for s in ("train", "val", "test")}
    log(f"[eval] synthetic corpus: {EVAL_CLIPS} clips {sizes} in "
        f"{time.perf_counter() - t0:.1f} s (host). Cuts: the corpus (the "
        f"HumanML3D test split holds 4,384 clips) and replication_times "
        f"{cfg.test.replication_times} (the protocol's 20); batch "
        f"{cfg.eval.batch_size}, R groups {cfg.eval.r_size}, diversity_times "
        f"{cfg.eval.diversity_times}, MultiModality {cfg.eval.mm_num_samples} "
        f"texts x {cfg.eval.mm_num_repeats} repeats, mm_num_times "
        f"{cfg.eval.mm_num_times}: the protocol's values")
    if not sizes["test"] > cfg.eval.diversity_times:
        raise RuntimeError("the test split is not above diversity_times")

    # the evaluator bundle, trained on the card
    npz = os.path.join(EVAL_ROOT, "t2m_trained.npz")
    t0 = time.perf_counter()
    bundle, report = train_t2m_evaluator(cfg, dm, steps=EVAL_TRAIN_STEPS,
                                         device=DEVICE, log_every=0)
    _sync(torch)
    train_s = time.perf_counter() - t0
    save_t2m_params(npz, bundle)
    tree = bundle.params_tree()
    del bundle
    log(f"[eval:t2m-train] {report['steps']} steps at B="
        f"{cfg.train.batch_size}: {1e3 * train_s / report['steps']:.2f} ms a "
        f"step (with set-up, {train_s:.1f} s); nce {report['loss_first']:.4f}"
        f" -> {report['loss_last']:.4f}, style mse "
        f"{report['style_mse_last']:.4f}, batch top-1 "
        f"{report['batch_top1_last']:.3f}")

    cfg = _eval_cfg(t2m_params_path=npz)
    mld = MLD(cfg, mean=dm.mean, std=dm.std, mean_eval=dm.mean_eval,
              std_eval=dm.std_eval, device=DEVICE,
              generator=torch.Generator().manual_seed(SEED))
    ev = Evaluator(cfg, mld, dm)
    want = _eval_want(cfg)
    eval_batch = ev.eval_batch

    def checked_batch(*args, **kwargs):
        # the launches of every batch, main and MultiModality alike
        before = _read_counts()
        out = eval_batch(*args, **kwargs)
        after = _read_counts()
        _check_counts({k: after[k] - before[k] for k in after}, want,
                      "an evaluated batch")
        return out

    ev.eval_batch = checked_batch
    _reset_counts()
    t0 = time.perf_counter()
    res = ev.run(torch.Generator(device=DEVICE).manual_seed(SEED),
                 replication_times=EVAL_REPLICATIONS)
    _sync(torch)
    run_s = time.perf_counter() - t0
    counts = _read_counts()
    ev.eval_batch = eval_batch
    times = {k: list(v) for k, v in ev.times.items()}
    n_batches = len(times["main"]) + len(times["mm"])
    _check_counts(counts, {k: v * n_batches for k, v in want.items()},
                  f"Evaluator.run over {n_batches} batches")
    for key in ("FID", "R_precision_top_1", "R_precision_top_2",
                "R_precision_top_3", "Matching_score", "Diversity",
                "MultiModality", "APE_root", "AVE_root"):
        if not math.isfinite(res.get(key, float("nan"))):
            raise RuntimeError(f"Evaluator.run gave no finite {key}: {res}")

    _reset_counts()
    gt = ev.run_gt(dm.loader("test", shuffle=False))
    if any(_read_counts().values()):
        raise RuntimeError("the ground-truth pass launched a kernel")
    gt_ms = _ms(ev.times["gt"])
    rand = Evaluator(_eval_cfg(), mld, dm).run_gt(
        dm.loader("test", shuffle=False))
    if not gt["R_precision_top_1"] > rand["R_precision_top_1"]:
        raise RuntimeError(f"the trained bundle's GT R@1 "
                           f"{gt['R_precision_top_1']:.4f} is not above the "
                           f"random one's {rand['R_precision_top_1']:.4f}")
    main_ms, mm_ms = _ms(times["main"]), _ms(times["mm"])
    metric_s = sum(times["metrics"])
    last = sizes["test"] % cfg.eval.batch_size or cfg.eval.batch_size
    projection_s = (HML_TEST_BATCHES * main_ms + HML_MM_BATCHES * mm_ms) / 1e3
    log(f"[eval:run] Evaluator.run, {EVAL_REPLICATIONS} replication in "
        f"{run_s:.2f} s: main pass {len(times['main'])} batches of "
        f"{cfg.eval.batch_size} (the last {last}), "
        f"median {main_ms:.2f} ms a batch (all: "
        f"{', '.join(f'{1e3 * t:.1f}' for t in times['main'])}); "
        f"MultiModality {len(times['mm'])} batches of up to "
        f"{cfg.eval.batch_size * cfg.eval.mm_num_repeats} rows, median "
        f"{mm_ms:.2f} ms (all: "
        f"{', '.join(f'{1e3 * t:.1f}' for t in times['mm'])}); host metrics "
        f"{metric_s:.3f} s (APE/AVE updates, FID sqrtm, diversity, "
        f"MultiModality); launches a batch {want}; GT pass "
        f"{len(ev.times['gt'])} batches, median {gt_ms:.2f} ms, no kernel; "
        f"{smi}")
    log(f"[eval:run] projection, not a measurement: one replication over "
        f"HumanML3D's test split ({HML_TEST_BATCHES} batches + "
        f"{HML_MM_BATCHES} MultiModality batches) at these per-batch times "
        f"= {projection_s:.1f} s of passes, plus the host's metrics")
    log("[eval:metrics] " + ", ".join(
        f"{k} {v:.4f}" for k, v in sorted(res.items())
        if not k.endswith("/conf95")))
    log(f"[eval:gt] trained bundle: GT R@1 {gt['R_precision_top_1']:.4f}, "
        f"R@3 {gt['R_precision_top_3']:.4f}, Matching "
        f"{gt['Matching_score']:.4f}; random-init bundle: GT R@1 "
        f"{rand['R_precision_top_1']:.4f} (chance 1/{cfg.eval.r_size} = "
        f"{1 / cfg.eval.r_size:.4f})")
    # where a batch's time goes: one main batch and one MultiModality batch
    batch = next(iter(dm.loader("test", shuffle=False,
                                batch_size=cfg.eval.batch_size)))
    n, T = batch["mask"].shape
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 8)
    prof = {"main": profile_eval_batch(
        torch, ev, batch, ev.draw(n, T, "diffusion", gen), False,
        f"main batch of {n}")}
    reps = cfg.eval.mm_num_repeats
    mm_batch = {k: np.repeat(np.asarray(batch[k]), reps, axis=0)
                for k in ("text_ids", "mask", "length")}
    prof["mm"] = profile_eval_batch(
        torch, ev, mm_batch, ev.draw(n * reps, T, "diffusion", gen), True,
        f"MultiModality batch of {n} x {reps}")
    ref = check_eval_reference(torch, cfg, dm, tree)
    del mld, ev
    torch.cuda.empty_cache()
    return {"metrics": res, "launches_a_batch": want, "counts": counts,
            "main_ms": main_ms, "mm_ms": mm_ms, "gt_ms": gt_ms,
            "metric_s": metric_s, "run_s": run_s,
            "projection_s": projection_s,
            "t2m_train_ms": 1e3 * train_s / report["steps"],
            "t2m_top1": report["batch_top1_last"],
            "gt_r1": gt["R_precision_top_1"],
            "random_gt_r1": rand["R_precision_top_1"], "reference": ref,
            "profile": prof}


# ---------------------------------------------------------- action-to-motion
A2M_ROOT = os.path.join(REPO, "build", "a2m_smoke")
# the synthetic archives, clips per class: 12 x 256 = 3,072 HumanAct12 clips
# (308 in the test split) and 40 x 80 = 3,200 UESTC clips (320), so each
# test split is above the protocol's diversity_times of 300
A2M_CLIPS = {"mld_humanact12": 256, "mld_uestc": 80}
A2M_PRESETS = ("mld_humanact12", "mld_uestc")
A2M_REPLICATIONS = 1
# the HumanAct12 classifier's training steps on the card
A2M_TRAIN_STEPS = 300
A2M_GEN_BATCHES = (6, B_LARGE)
A2M_REF_B = 8
# model and eval overrides of the phase (none: the presets' full width and
# the protocol's constants); a CPU rehearsal sets small ones
A2M_MODEL = {}
A2M_EVAL = {}


def _a2m_cfg(preset, **model):
    from mld_tpu_torch.config import load_config

    # each preset in a root of its own: the UESTC dataset copies its pkl to
    # humanact12poses.pkl beside it
    return load_config(preset=preset, overrides={
        "name": f"smoke_{preset}", "debug": False,
        "model": {**A2M_MODEL, "humanact12_rec_path":
                  os.path.join(A2M_ROOT, "actionrecognition"),
                  "uestc_rec_path": os.path.join(A2M_ROOT,
                                                 "actionrecognition"),
                  **model},
        "dataset": {"root": os.path.join(A2M_ROOT, preset)},
        "eval": dict(A2M_EVAL),
        "test": {"replication_times": A2M_REPLICATIONS},
        "logger": {"folder": os.path.join(A2M_ROOT, "experiments")}})


def _a2m_want(cfg, stage="diffusion"):
    """Kernel launches of one generate_action call or evaluated batch: K1 a
    DDIM step and K3 in each ACTOR decoder layer's self- and
    cross-attention; the vae stage encodes (K3 a layer) and decodes, no
    K1."""
    m = cfg.model
    diffusion = stage == "diffusion"
    return {"skip_encoder": (m.scheduler.num_inference_timesteps
                             if diffusion else 0),
            "skip_decoder": 0, "skip_decoder_kernels": 0, "flash_causal": 0,
            "flash_attention": (2 if diffusion else 3) * m.num_layers}


def _traced(torch, fn):
    """One fn() under torch.profiler: (its result, wall ms of the traced
    call, the device events as (name, ms))."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        _sync(torch)
    wall = (time.perf_counter() - t0) * 1e3
    return out, wall, [(e.name, e.time_range.elapsed_us() / 1e3)
                       for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA]


def _traced_busy(torch, fn):
    """One fn() call under torch.profiler: (wall ms of the traced call,
    device busy ms in it, device ms by layer)."""
    _, wall, events = _traced(torch, fn)
    kinds = Counter()
    for name, ms in events:
        kinds[_eval_kind(name)] += ms
    return wall, sum(kinds.values()), dict(kinds)


def drive_a2m(torch, mld, preset):
    """generate_action at B = 6 and 128: the launches of every call, the
    median of 3 warm calls and the device busy share of one traced call."""
    import numpy as np

    want = _a2m_want(mld.cfg)
    T = mld.cfg.dataset.num_frames
    n_cls = mld.cfg.model.nclasses
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 10)
    out = {}
    for B in A2M_GEN_BATCHES:
        actions = [i % n_cls for i in range(B)]
        lengths = [A2M_LENGTHS[i % len(A2M_LENGTHS)] if B < B_LARGE else T
                   for i in range(B)]

        def call():
            return mld.generate_action(actions, lengths, generator=gen)

        _reset_counts()
        t0 = time.perf_counter()
        motions = call()
        first = time.perf_counter() - t0
        _check_counts(_read_counts(), want, f"{preset} generate_action B={B}")
        for m, n in zip(motions, lengths):
            if m.shape != (n, 24, 3) or not np.isfinite(m).all():
                raise RuntimeError(f"{preset}: bad motion {m.shape} for "
                                   f"length {n}")
        times = []
        for _ in range(3):
            _reset_counts()
            t0 = time.perf_counter()
            call()
            times.append(time.perf_counter() - t0)
            _check_counts(_read_counts(), want,
                          f"{preset} generate_action B={B}")
        med = sorted(times)[1]
        # the profiler slows the host's launches, so the busy share is the
        # traced call's device time over the untraced median call
        wall, busy, kinds = _traced_busy(torch, call)
        log(f"[a2m:{preset}] generate_action B={B}: first {first:.4f} s, "
            f"then {', '.join(f'{t:.4f}' for t in times)} s (median "
            f"{med:.4f} s, {B / med:.1f} motions/s); one traced call: "
            f"device busy {busy:.2f} ms, {100 * busy / (1e3 * med):.1f}% of "
            f"the median call ({wall:.2f} ms under the profiler); by layer: "
            + ", ".join(f"{k} {v:.2f}" for k, v in Counter(kinds)
                        .most_common())
            + f"; launches a call {want}")
        out[B] = {"median_s": med, "busy_share": busy / (1e3 * med),
                  "traced_ms": wall, "busy_ms": busy, "by_layer_ms": kinds}
    return {"want": want, "batches": out}


def _gt_accuracy(torch, mld, dm, metrics):
    """A classifier's top-1 on the ground-truth joints of the test split."""
    hits = n = 0
    for b in dm.loader("test", shuffle=False):
        mask = torch.as_tensor(b["mask"], device=DEVICE)
        joints = mld.feats2joints(torch.as_tensor(b["motion"], device=DEVICE),
                                  mask)
        _, logits = metrics.classify(joints, b["length"])
        hits += int((logits.argmax(-1).cpu()
                     == torch.as_tensor(b["action"])).sum())
        n += len(b["action"])
    return hits / n


def evaluate_a2m(torch, cfg, dm, mld, preset, stages):
    """Evaluator.run (one replication) in the diffusion stage, and the vae
    stage's split where asked, with the launches of every batch checked."""
    from mld_tpu_torch.eval.pipeline import Evaluator

    out = {}
    for stage in stages:
        ev = Evaluator(cfg, mld, dm)
        want = _a2m_want(cfg, stage)
        a2m_batch = ev.a2m_batch

        def checked(*args, **kwargs):
            before = _read_counts()
            res = a2m_batch(*args, **kwargs)
            after = _read_counts()
            _check_counts({k: after[k] - before[k] for k in after}, want,
                          f"{preset} {stage} a2m batch")
            return res

        ev.a2m_batch = checked
        gen = torch.Generator(device=DEVICE).manual_seed(SEED + 11)
        t0 = time.perf_counter()
        if stage == "diffusion":
            res = ev.run(gen, replication_times=A2M_REPLICATIONS)
        else:
            res = ev.run_split_a2m(dm.loader("test", shuffle=False),
                                   stage=stage, generator=gen)
        _sync(torch)
        run_s = time.perf_counter() - t0
        for key in ("accuracy", "gt_accuracy", "FID", "Diversity"):
            if not math.isfinite(res.get(key, float("nan"))):
                raise RuntimeError(f"{preset} {stage}: no finite {key}: "
                                   f"{res}")
        if not all(math.isfinite(v) for v in res.values()):
            raise RuntimeError(f"{preset} {stage}: non-finite metric {res}")
        batch_ms = _ms(ev.times["a2m"])
        metric_s = sum(ev.times["metrics"])
        log(f"[a2m:{preset}] Evaluator {stage}: {len(ev.times['a2m'])} "
            f"batches of {cfg.eval.batch_size} in {run_s:.2f} s, median "
            f"{batch_ms:.2f} ms a batch (generation and the classifier; all: "
            f"{', '.join(f'{1e3 * t:.1f}' for t in ev.times['a2m'])}); host "
            f"metrics {metric_s:.3f} s; launches a batch {want}; "
            + ", ".join(f"{k} {v:.4f}" for k, v in sorted(res.items())
                        if not k.endswith("/conf95")))
        out[stage] = {"metrics": res, "batch_ms": batch_ms,
                      "metric_s": metric_s, "run_s": run_s,
                      "launches_a_batch": want}
    return out


def check_a2m_reference(torch, cfg, preset):
    """The joints of one batch of A2M_REF_B actions on the card (kernels)
    and on the CPU (plain versions), same weights and initial latents."""
    from mld_tpu_torch.models.mld import MLD, lengths_to_mask

    n = A2M_REF_B
    T = cfg.dataset.num_frames
    init = torch.randn(n, cfg.model.latent_size, cfg.model.latent_dim,
                       generator=torch.Generator().manual_seed(SEED + 12))
    actions = torch.arange(n) % cfg.model.nclasses
    lengths = [A2M_LENGTHS[i % len(A2M_LENGTHS)] for i in range(n)]
    out = {}
    for dev in (DEVICE, "cpu"):
        # K1 on the card and its plain version on the CPU
        mld = MLD(cfg, device=dev, fused_denoiser=True,
                  generator=torch.Generator().manual_seed(SEED))
        _reset_counts()
        out[dev] = mld.generate_joints(
            actions, lengths_to_mask(lengths, T, mld.device),
            init_latents=init).cpu()
        counts = _read_counts()
        del mld
        if dev == "cpu" and any(counts.values()):
            raise RuntimeError(f"the CPU run launched kernels: {counts}")
    scale = out["cpu"].abs().max().item()
    err = (out[DEVICE] - out["cpu"]).abs().max().item()
    log(f"[a2m:{preset}] card vs CPU joints, {n} actions: max_abs_err "
        f"{err:.3e} (scale {scale:.3e}, bar {E2E_RTOL:g} x max(scale, 1))")
    if not err <= E2E_RTOL * max(scale, 1.0):
        raise RuntimeError(f"{preset}: card joints disagree with the CPU")
    return {"err": err, "scale": scale}


def phase_action(torch, smi):
    """Action-to-motion on the card: the synthetic archives, the HumanAct12
    classifier trained on the card, generate_action for both presets, the
    a2m evaluation protocol and a card-vs-CPU batch."""
    import shutil

    from mld_tpu_torch.data.a2m import synth_humanact12_pkl
    from mld_tpu_torch.data.datamodule import get_datamodule
    from mld_tpu_torch.eval.a2m_train import (save_a2m_params,
                                              train_a2m_classifier)
    from mld_tpu_torch.metrics import HUMANACTMetrics
    from mld_tpu_torch.models.mld import MLD

    shutil.rmtree(A2M_ROOT, ignore_errors=True)
    runs = {}
    for preset in A2M_PRESETS:
        t_preset = time.perf_counter()
        cfg = _a2m_cfg(preset)
        m = cfg.model
        t0 = time.perf_counter()
        n_cls = m.nclasses
        pkl = os.path.join(cfg.dataset.root, "humanact12poses.pkl")
        synth_humanact12_pkl(pkl, n_per_class=A2M_CLIPS[preset],
                             num_classes=n_cls)
        if preset == "mld_uestc":
            os.rename(pkl, os.path.join(cfg.dataset.root, "uestc_poses.pkl"))
        dm = get_datamodule(cfg)
        sizes = {s: len(dm.dataset(s)) for s in ("train", "test")}
        log(f"[a2m:{preset}] denoiser {m.denoiser_num_layers}x"
            f"{m.latent_dim} over [z; t; action], ACTOR VAE {m.num_layers}x"
            f"{m.latent_dim}, {cfg.dataset.num_frames} frames, DDIM-"
            f"{m.scheduler.num_inference_timesteps}, CFG "
            f"{m.guidance_scale}, {n_cls} classes; synthetic archive "
            f"{n_cls} x {A2M_CLIPS[preset]} clips {sizes} in "
            f"{time.perf_counter() - t0:.1f} s (host). Cuts: the archive is "
            f"synthetic and replication_times {cfg.test.replication_times} "
            f"(the protocol's 20); eval batch {cfg.eval.batch_size}, "
            f"diversity_times {cfg.eval.diversity_times}, mm_num_times "
            f"{cfg.eval.mm_num_times}: the protocol's values")
        if not sizes["test"] > cfg.eval.diversity_times:
            raise RuntimeError("the test split is not above diversity_times")
        mld = MLD(cfg, device=DEVICE,
                  generator=torch.Generator().manual_seed(SEED))
        run = {}
        if preset == "mld_humanact12":
            t0 = time.perf_counter()
            params, report = train_a2m_classifier(
                cfg, dm, mld, steps=A2M_TRAIN_STEPS, seed=SEED, log_every=0)
            _sync(torch)
            train_s = time.perf_counter() - t0
            os.makedirs(m.humanact12_rec_path, exist_ok=True)
            save_a2m_params(os.path.join(m.humanact12_rec_path,
                                         "humanact12_gru_params.npz"), params)
            trained = _gt_accuracy(torch, mld, dm, HUMANACTMetrics(
                params=params, num_labels=n_cls, device=DEVICE))
            untrained = _gt_accuracy(torch, mld, dm, HUMANACTMetrics(
                num_labels=n_cls, device=DEVICE))
            log(f"[a2m:cls-train] {report['steps']} steps at B="
                f"{cfg.train.batch_size}: "
                f"{1e3 * train_s / report['steps']:.2f} ms a step (with "
                f"set-up, {train_s:.1f} s); ce {report['loss_first']:.4f} -> "
                f"{report['loss_last']:.4f}, batch top-1 "
                f"{report['train_acc_last']:.3f}; GT top-1 on the test split: "
                f"trained {trained:.4f}, random {untrained:.4f} (chance "
                f"{1 / n_cls:.4f})")
            if not trained > untrained:
                raise RuntimeError("the trained classifier's GT accuracy is "
                                   "not above the random one's")
            run.update(cls_train_ms=1e3 * train_s / report["steps"],
                       cls_top1=report["train_acc_last"],
                       gt_acc_trained=trained, gt_acc_random=untrained)
        run["generate"] = drive_a2m(torch, mld, preset)
        stages = (("diffusion", "vae") if preset == "mld_humanact12"
                  else ("diffusion",))
        run["eval"] = evaluate_a2m(torch, cfg, dm, mld, preset, stages)
        del mld
        torch.cuda.empty_cache()
        run["reference"] = check_a2m_reference(torch, cfg, preset)
        log(f"[time] a2m {preset}: {time.perf_counter() - t_preset:.1f} s; "
            f"{smi}")
        runs[preset] = run
    return runs


# ------------------------------------------- training: action presets, modes
# phase 9: the action presets' three stages and the two training modes of
# every configuration (bf16 mixed precision, remat). Each preset's synthetic
# archive in a root of its own, clips per class: 12 x 8 = 96 HumanAct12 clips
# (86 for training: one batch of TRAIN_B an epoch) and 40 x 2 = 80 UESTC
# clips (72); the modes train on phase 6's corpus
A2M_TRAIN_ROOT = os.path.join(REPO, "build", "a2m_train_smoke")
A2M_TRAIN_CLIPS = {"mld_humanact12": 8, "mld_uestc": 2}
# steps of each arm: step 1 a warm-up, step 5 traced (after step 4), the
# median over steps 2-4; cut from phase 6's 8 to keep the phase near a
# minute of the card
MODE_STEPS = 5
MODE_TRACED = (4, 5)
# bf16 mixed precision against f32, one full-width diffusion step on the
# same batch and draws, dropout 0: the bf16 step rounds weights and
# activations to bf16 (relative steps of 2^-8, ~4e-3 on a prediction after
# the 9 VAE encoder, 12 text and 9 denoiser layers), and the loss, a mean of
# squared errors over B x 256 latents, averages those roundings: the tiny
# CPU configuration (B x 32 latents) lands 3.3e-4 from its f32 step, the
# card's full width 9.5e-6 (H100, 700 W). 1e-3 leaves 3x over the first
BF16_LOSS_RTOL = 1e-3
# and the bf16 step must differ from the f32 one: its worst gradient leaf
# lies 1.98e-2 (relative L2) from the f32 step's at full width (H100,
# 700 W), a step that silently computed in f32 would lie 0 from it; the
# floor is 10x under the reading
BF16_GAP_FLOOR = 2e-3


def _a2m_train_cfg(preset, stage, dropout=None, **train):
    from mld_tpu_torch.config import load_config

    model = dict(TRAIN_MODEL)
    if dropout is not None:
        model["dropout"] = dropout
    return load_config(preset=preset, overrides={
        "name": f"smoke_{preset}_{stage}", "debug": True, "model": model,
        "dataset": {"root": os.path.join(A2M_TRAIN_ROOT, preset)},
        "train": {"stage": stage, "batch_size": TRAIN_B, **train},
        "logger": {"folder": os.path.join(A2M_TRAIN_ROOT, "experiments"),
                   "save_checkpoint_epoch": 10 ** 6,
                   "val_every_epochs": 10 ** 6}})


def _mode_cfg(stage, dtype="float32", remat=False, dropout=None):
    from mld_tpu_torch.config.core import (config_from_dict, config_to_dict,
                                           merge_dicts)

    cfg = _train_cfg(stage, dropout=dropout, remat=remat)
    return config_from_dict(merge_dicts(config_to_dict(cfg), {
        "name": f"smoke_{stage}_{dtype}_remat{int(remat)}",
        "model": {"dtype": dtype},
        "logger": {"folder": os.path.join(A2M_TRAIN_ROOT, "experiments")}}))


def _train_draws(torch, cfg, stage, B, seed):
    """A step's draws (steps' draws= keys) from CPU generators."""
    if stage == "diffusion":
        return _diffusion_draws(torch, cfg, B, seed)
    m = cfg.model
    g = torch.Generator().manual_seed(seed + 1)
    lat = (B, m.latent_size, m.latent_dim)
    return {"vae": {"eps": torch.randn(lat, generator=g)},
            "diffusion": _diffusion_draws(torch, cfg, B, seed),
            "gen_init": torch.randn(lat, generator=g)}


def check_a2m_train_reference(torch, preset, stage):
    """One full-width step of an action stage at B=REF_TRAIN_B, dropout 0:
    the card (kernels; K3 under autograd in the trainable attention, K1 in
    the generation pass) against the CPU (plain versions, K1's too), the
    same params, batch and draws."""
    from mld_tpu_torch.data.datamodule import get_datamodule
    from mld_tpu_torch.models.mld import MLD
    from mld_tpu_torch.train import steps

    cfg = _a2m_train_cfg(preset, stage, dropout=0.0)
    batch = steps.batch_to_device(next(iter(get_datamodule(cfg).loader(
        "train", batch_size=REF_TRAIN_B, prefetch=0, drop_last=True))), "cpu")
    draws = _train_draws(torch, cfg, stage, REF_TRAIN_B, SEED + 14)
    want = _train_want(cfg, stage)
    out = {}
    for dev in (DEVICE, "cpu"):
        mld = MLD(cfg, device=dev, fused_denoiser=True,
                  generator=torch.Generator().manual_seed(SEED))
        state = steps.create_train_state(mld, stage)
        dbatch = {k: v.to(dev) for k, v in batch.items()}
        _reset_counts()
        logs, grads = steps.compute_grads(state, dbatch, None, draws)
        _sync(torch)
        counts = _read_counts()
        if dev == "cpu":
            if any(counts.values()):
                raise RuntimeError(f"the CPU step launched kernels: {counts}")
        else:
            _check_counts(counts, want, f"{preset} {stage} reference step")
        out[dev] = ({k: v.cpu() for k, v in logs.items()},
                    {k: g.cpu() for k, g in grads.items()})
        del mld, state
    loss_err, grad_err = _grad_err(*out[DEVICE], *out["cpu"])
    log(f"[train9:{preset} {stage}:reference] full-width step B="
        f"{REF_TRAIN_B} dropout 0, card vs CPU: launches on the card {want}; "
        f"loss {float(out[DEVICE][0]['total']):.6f} vs "
        f"{float(out['cpu'][0]['total']):.6f} (rel err {loss_err:.2e}), "
        f"worst gradient leaf {grad_err:.2e} of its scale (bar "
        f"{TRAIN_REF_RTOL:g})")
    if not (loss_err <= TRAIN_REF_RTOL and grad_err <= TRAIN_REF_RTOL):
        raise RuntimeError(f"{preset} {stage}: the card's training step "
                           f"disagrees with the CPU")
    return {"loss_rel_err": loss_err, "grad_rel_err": grad_err,
            "launches": want}


def _val_want(cfg):
    """Kernel launches of one validation diffusion step (eval_step): the
    frozen VAE encode (K3 a layer), the prompts and the uncond row (K4),
    one K1 call for the denoiser."""
    m = cfg.model
    return {"skip_encoder": 1, "skip_decoder": 0, "skip_decoder_kernels": 0,
            "flash_causal": 2 * m.clip_layers if m.condition == "text" else 0,
            "flash_attention": m.num_layers}


def check_bf16_step(torch):
    """One full-width mld_humanml3d diffusion step, dropout 0, in bf16 mixed
    precision against the same step in f32: the same params, batch and
    draws. K3's bf16 arm runs in the frozen encode and, through its
    autograd.Function, in the denoiser. Then the validation step
    (eval_step) of each, whose denoiser is K1: in bf16 on the bf16 copies'
    matrices (K1's bf16-weight arm)."""
    from mld_tpu_torch.models.mld import MLD
    from mld_tpu_torch.train import steps

    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg = _mode_cfg("diffusion", dtype=dtype, dropout=0.0)
        if dtype == "float32":
            batch, dm = _batch(torch, cfg, TRAIN_B, DEVICE)
            draws = _diffusion_draws(torch, cfg, TRAIN_B, SEED + 15)
        mld = MLD(cfg, mean=dm.mean, std=dm.std, device=DEVICE,
                  generator=torch.Generator().manual_seed(SEED))
        state = steps.create_train_state(mld, "diffusion")
        _reset_counts()
        logs, grads = steps.compute_grads(state, batch, None, draws)
        _sync(torch)
        _check_counts(_read_counts(), _train_want(cfg, "diffusion"),
                      f"{dtype} diffusion step")
        _reset_counts()
        val = steps.eval_step(state, batch, None, draws)
        _sync(torch)
        _check_counts(_read_counts(), _val_want(cfg),
                      f"{dtype} validation diffusion step")
        out[dtype] = ({k: float(v) for k, v in logs.items()},
                      {k: g.detach().clone() for k, g in grads.items()},
                      float(val["total"]))
        del mld, state
    (f_logs, f_grads, f_val), (b_logs, b_grads, b_val) = (out["float32"],
                                                          out["bfloat16"])
    loss_err = abs(b_logs["total"] - f_logs["total"]) / abs(f_logs["total"])
    val_err = abs(b_val - f_val) / abs(f_val)
    grad_err = max(float((b_grads[k] - g).norm() / g.norm().clamp_min(1e-30))
                   for k, g in f_grads.items())
    log(f"[train9:bf16-vs-f32] full-width diffusion step B={TRAIN_B} "
        f"dropout 0: total loss bf16 {b_logs['total']:.6f} vs f32 "
        f"{f_logs['total']:.6f} (rel err {loss_err:.2e}, bar "
        f"{BF16_LOSS_RTOL:g}); worst gradient leaf rel L2 {grad_err:.2e} "
        f"(floor {BF16_GAP_FLOOR:g}: bf16 applied); launches "
        f"{_train_want(cfg, 'diffusion')}; validation step (K1) bf16 "
        f"{b_val:.6f} vs f32 {f_val:.6f} (rel err {val_err:.2e}, bar "
        f"{BF16_LOSS_RTOL:g}), launches {_val_want(cfg)}")
    if not (loss_err <= BF16_LOSS_RTOL and val_err <= BF16_LOSS_RTOL):
        raise RuntimeError("the bf16 step's loss is not the f32 step's")
    if not grad_err >= BF16_GAP_FLOOR:
        raise RuntimeError(f"the bf16 step's gradients lie {grad_err:.2e} "
                           f"from the f32 step's: bf16 was not applied")
    return {"loss_rel_err": loss_err, "grad_rel_l2_worst": grad_err,
            "val_loss_rel_err": val_err, "val_launches": _val_want(cfg)}


def phase_train_modes(torch, smi, train_runs):
    """The trainer's action presets and modes on the card: mld_humanact12's
    three stages (with a resumed step and the pretrained_vae handoff) and
    mld_uestc's diffusion stage, each action diffusion stage a card-vs-CPU
    step; bf16 mixed precision (vae, diffusion) and remat (vae) of
    mld_humanml3d, each against its f32 / no-remat twin, phase 6's run of
    the same configuration (`train_runs`), and a bf16-vs-f32 step."""
    import shutil

    from mld_tpu_torch.data.a2m import synth_humanact12_pkl
    from mld_tpu_torch.data.synthetic import build_synthetic_dataset
    from mld_tpu_torch.train.loop import train
    from mld_tpu_torch.utils.checkpoint import CheckpointManager

    shutil.rmtree(A2M_TRAIN_ROOT, ignore_errors=True)
    arm = {"steps": MODE_STEPS, "traced": MODE_TRACED}
    runs = {}
    for preset, n in A2M_TRAIN_CLIPS.items():
        cfg = _a2m_train_cfg(preset, "vae")
        pkl = os.path.join(cfg.dataset.root, "humanact12poses.pkl")
        synth_humanact12_pkl(pkl, n_per_class=n,
                             num_classes=cfg.model.nclasses)
        if preset == "mld_uestc":
            os.rename(pkl, os.path.join(cfg.dataset.root, "uestc_poses.pkl"))

    preset = "mld_humanact12"
    cfg = _a2m_train_cfg(preset, "vae")
    m = cfg.model
    log(f"[train9:{preset}] ACTOR VAE {m.num_layers}x{m.latent_dim}, denoiser "
        f"{m.denoiser_num_layers}x{m.latent_dim}, {cfg.dataset.num_frames} "
        f"frames, B={TRAIN_B}, dropout {m.dropout}; {MODE_STEPS} steps an "
        f"arm (phase 6: 8)")
    mld, _, runs[f"{preset} vae"] = run_stage(
        torch, cfg, "vae", smi, label=f"{preset} vae", **arm)
    del mld
    vae_dir = os.path.join(cfg.logger.folder, "mld", cfg.name, "checkpoints")
    mgr = CheckpointManager(vae_dir)
    saved = mgr.restore(map_location=DEVICE)
    watch = _StepWatch(torch, _train_want(cfg, "vae"))
    mld = train(cfg, max_steps=1, resume=True, device=DEVICE, on_step=watch)
    restored = [k for k, v in saved["state_dict"].items()
                if not torch.equal(watch.before[k], v)]
    if restored or mgr.latest_step() != saved["step"] + 1:
        raise RuntimeError(f"resume did not restore the checkpoint of epoch "
                           f"{saved['step']}: {restored[:5]}")
    log(f"[train9:{preset} vae] resumed from the checkpoint of epoch "
        f"{saved['step']}, one more step, saved epoch {mgr.latest_step()}")
    del mld, saved
    cfg = _a2m_train_cfg(preset, "diffusion", pretrained_vae=vae_dir)
    mld, _, runs[f"{preset} diffusion"] = run_stage(
        torch, cfg, "diffusion", smi, label=f"{preset} diffusion", **arm)
    handed = mgr.restore(map_location=DEVICE)["state_dict"]
    for k, p in mld.vae.named_parameters():
        if not torch.equal(p, handed["vae." + k]):
            raise RuntimeError(f"the diffusion stage's ACTOR VAE is not the "
                               f"handed-over one: vae.{k}")
    log(f"[train9:{preset} diffusion] its frozen ACTOR VAE is the vae "
        f"stage's checkpoint (epoch {mgr.latest_step()}), bit for bit")
    diff_dir = os.path.join(cfg.logger.folder, "mld", cfg.name,
                            "checkpoints")
    del mld, handed
    cfg = _a2m_train_cfg(preset, "vae_diffusion", pretrained=diff_dir)
    mld, _, runs[f"{preset} vae_diffusion"] = run_stage(
        torch, cfg, "vae_diffusion", smi, label=f"{preset} vae_diffusion",
        **arm)
    del mld
    cfg = _a2m_train_cfg("mld_uestc", "diffusion")
    mld, _, runs["mld_uestc diffusion"] = run_stage(
        torch, cfg, "diffusion", smi, label="mld_uestc diffusion", **arm)
    del mld
    torch.cuda.empty_cache()
    for stage in ("diffusion", "vae_diffusion"):
        runs[f"{preset} {stage} reference"] = check_a2m_train_reference(
            torch, preset, stage)
    torch.cuda.empty_cache()

    if not os.path.exists(os.path.join(TRAIN_ROOT, "humanml3d", "Std.npy")):
        build_synthetic_dataset(os.path.join(TRAIN_ROOT, "humanml3d"),
                                n_samples=TRAIN_CLIPS, seed=SEED)
    modes = (("vae", "float32", True), ("vae", "bfloat16", False),
             ("diffusion", "bfloat16", False))
    for stage, dtype, remat in modes:
        label = f"mld_humanml3d {stage} {dtype}{' remat' if remat else ''}"
        mld, _, runs[label] = run_stage(
            torch, _mode_cfg(stage, dtype, remat), stage, smi, label=label,
            **arm)
        del mld
        torch.cuda.empty_cache()
    # the f32 / no-remat twins: phase 6's vae and diffusion stages
    for stage in ("vae", "diffusion"):
        runs[f"mld_humanml3d {stage} float32"] = {
            k: train_runs[stage][k] for k in ("peak_mib", "step_median_ms")}
    peaks = {k: r["peak_mib"] for k, r in runs.items() if "peak_mib" in r}
    ms = {k: r["step_median_ms"] for k, r in runs.items()
          if "step_median_ms" in r}
    arm = "mld_humanml3d {} {}".format
    ratios = {"vae bf16 / f32": ("vae", "bfloat16", "vae", "float32"),
              "diffusion bf16 / f32": ("diffusion", "bfloat16", "diffusion",
                                       "float32"),
              "vae remat / none": ("vae", "float32 remat", "vae", "float32")}
    f32_vae, remat = peaks[arm("vae", "float32")], peaks[arm(
        "vae", "float32 remat")]
    log(f"[train9:memory] peak allocated a step, MiB (f32 twins: phase 6): "
        + ", ".join(f"{k} {v:.1f}" for k, v in peaks.items()) + "; "
        + ", ".join(f"{name}: peak {peaks[arm(*r[:2])] / peaks[arm(*r[2:])]:.3f}"
                    f", ms {ms[arm(*r[:2])] / ms[arm(*r[2:])]:.3f}"
                    for name, r in ratios.items())
        + ("" if remat < f32_vae else
           f" (remat did NOT lower the peak: {remat - f32_vae:+.1f} MiB)")
        + f"; {smi}")
    runs["bf16_vs_f32"] = check_bf16_step(torch)
    torch.cuda.empty_cache()
    return runs


# ------------------------------------------------ the text-family options
# phase 10: the model options of the text family at full width, each arm a
# configuration the JAX package builds and serves: (label, preset, model
# overrides, MLD keywords). The widths and depths are the preset's; only the
# option named changes
OPTIONS_ABLATION = {"vae_arch": "all_encoder", "mlp_dist": True,
                    "position_embedding": "sine", "normalize_before": True,
                    "skip_connect": False}
OPTION_ARMS = (
    ("hidden", "mld_humanml3d", {"clip_last_hidden": True}, {}),
    ("uncond", "mld_humanml3d", {"condition": "text_uncond"}, {}),
    ("ablation", "mld_humanml3d", OPTIONS_ABLATION, {}),
    ("vposert", "mld_humanml3d", {"vae_type": "vposert"}, {}),
    ("mld7_fused", "mld_humanml3d", {"latent_size": 7},
     {"fused_decode": True}),
    ("kit", "mld_kit", {}, {}),
    ("latent_dec", "mld_humanml3d", {"denoiser_arch": "trans_dec"}, {}),
    ("raw_enc", "novae_humanml3d", {
        "denoiser_arch": "trans_enc",
        "scheduler": {"kind": "ddim", "num_inference_timesteps": 50}}, {}),
)
# training arms of phase 10 at full width, B = TRAIN_B, dropout 0.1, on
# phase 6's corpus: (label, stage, model overrides); 3 steps each, the first
# a warm-up, the third traced, so the median is step 2's
OPTION_TRAIN_ARMS = (("hidden diffusion", "diffusion",
                      {"clip_last_hidden": True}),
                     ("ablation vae", "vae", OPTIONS_ABLATION))
OPTION_TRAIN_STEPS = 3
OPTION_TRAIN_TRACED = (2, 3)
# model overrides of the generation arms (none: the presets' full width)
OPTIONS_MODEL = {}


def _options_cfg(preset, model):
    from mld_tpu_torch.config import load_config
    from mld_tpu_torch.config.core import merge_dicts

    return load_config(preset=preset, overrides={
        "model": merge_dicts(OPTIONS_MODEL, model)})


def _options_want(mld):
    """Kernel launches of one generate call of an option arm, from the
    model: K4 a CLIP layer for the prompts (none under text_uncond with
    CFG, where only the uncond row is encoded) and for the uncond row; K1 a
    DDIM step where K1 serves the denoiser, else K3 in each denoiser layer
    (self-attention, and trans_dec's cross-attention too) every step; the
    VAE decode's K3 (the plain MLD VAE: self- and cross-attention a layer,
    all_encoder self-attention only; VPosert and raw motion none) or K5's
    one call with its kernels."""
    from mld_tpu_torch.models.vae import MldVae
    from mld_tpu_torch.ops.fused_seq_decoder import launch_count

    m = mld.cfg.model
    n_steps = len(mld.scheduler.timesteps())
    prompts = not (m.condition == "text_uncond" and mld.do_cfg)
    fused = mld.use_fused_denoiser()
    per_step = (2 if m.denoiser_arch == "trans_dec" else 1) \
        * m.denoiser_num_layers
    decode = 0
    if isinstance(mld.vae, MldVae) and not mld.fused_decode:
        decode = (1 if m.vae_arch == "all_encoder" else 2) * m.num_layers
    n_block = (m.num_layers - 1) // 2
    return {"skip_encoder": n_steps if fused else 0,
            "skip_decoder": int(mld.fused_decode),
            "skip_decoder_kernels": int(mld.fused_decode) * launch_count(
                n_block, m.latent_size),
            "flash_causal": m.clip_layers * (int(prompts) + int(mld.do_cfg)),
            "flash_attention": (0 if fused else per_step * n_steps) + decode}


# MLD-7 with random weights: after 50 CFG-7.5 steps its 7 latent tokens
# reach ~69, where the card's latents, 2.1e-6 of their scale from the CPU's,
# and the decoder's f32 roundoff at that scale move the joints by 2.4e-2 at
# a scale of 11.4, past the bar (H100, 700 W), while K5 at M=7 holds 5.4e-6
# against its plain version: on the CPU alone a random 1.45e-4 change of
# those latents moves the joints by 5e-3. Its arm is held stage by stage
# (the latents, and the decode of the CPU's latents), each at the bar, and
# its end-to-end error is printed
STAGED_REFERENCE = ("mld7_fused",)


def _options_reference(torch, label, cfg, mld, text, length, kw):
    """One prompt on the card (the arm's model with its text tower in f32)
    and on the CPU (plain versions, f32 text tower, the same seeded
    weights), from the same ids and initial latents; K1's plain version on
    the CPU where the card runs K1 (its LayerNorm eps 1e-5). Three errors,
    each against the bar E2E_RTOL x max(scale, 1): the latents after the
    reverse process, the joints the card decodes from the CPU's latents,
    and the joints end to end (not held for STAGED_REFERENCE)."""
    from mld_tpu_torch.config.core import (config_from_dict, config_to_dict,
                                           merge_dicts)
    from mld_tpu_torch.models.mld import MLD, lengths_to_mask

    cfg32 = config_from_dict(merge_dicts(config_to_dict(cfg), {
        "model": {"clip_compute_dtype": "float32"}}))
    fused = True if mld.use_fused_denoiser() else None
    shape = ((1, mld.max_frames, mld.nfeats) if mld.raw_motion else
             (1, mld.latent_size, mld.latent_dim))
    init = torch.randn(shape, generator=torch.Generator().manual_seed(
        SEED + 3))
    ids = mld.tokenize([text]).cpu()

    def latents(model):
        mask = lengths_to_mask([length], model.max_frames, model.device)
        return model.diffusion_reverse(model.condition_embedding(
            ids.to(model.device)), init_latents=init, mask=mask), mask

    def joints(model, z, mask):
        z = z.to(model.device)
        feats = (z * mask[..., None] if model.raw_motion
                 else model.decode_latent(z, mask))
        return model.masked_joints(feats, mask).cpu()

    tower = mld.clip.compute_dtype
    mld.clip.compute_dtype = torch.float32
    try:
        z_card, mask = latents(mld)
        j_card = joints(mld, z_card, mask)
        cpu = MLD(cfg32, device="cpu", fused_denoiser=fused,
                  generator=torch.Generator().manual_seed(SEED), **kw)
        _reset_counts()
        z_cpu, cpu_mask = latents(cpu)
        j_cpu = joints(cpu, z_cpu, cpu_mask)
        if any(_read_counts().values()):
            raise RuntimeError(f"the CPU run launched kernels: "
                               f"{_read_counts()}")
        j_decode = joints(mld, z_cpu, mask)
    finally:
        mld.clip.compute_dtype = tower

    def err(a, b):
        scale = b.abs().max().item()
        return (a.cpu() - b).abs().max().item(), scale

    errs = {"latents": err(z_card, z_cpu), "decode": err(j_decode, j_cpu),
            "joints": err(j_card, j_cpu)}
    held = [k for k in errs
            if not (k == "joints" and label in STAGED_REFERENCE)]
    bad = [k for k in held
           if not errs[k][0] <= E2E_RTOL * max(errs[k][1], 1.0)]
    return errs, held, bad


def drive_options(torch, label, cfg, mld, texts, lengths, kw):
    """One option arm: the demo prompts through MLD.generate, then
    generate_joints at B = 128 (first call, the median of 3 warm calls, one
    traced call), the launches of every call checked, and the card's
    joints for one prompt against the CPU's."""
    import numpy as np

    from mld_tpu_torch.models.mld import lengths_to_mask

    want = _options_want(mld)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 20)
    _reset_counts()
    t0 = time.perf_counter()
    motions = mld.generate(texts, lengths, generator=gen)
    _sync(torch)
    first = time.perf_counter() - t0
    _check_counts(_read_counts(), want, f"options {label} generate")
    for motion, n in zip(motions, lengths):
        if motion.shape != (n, mld.njoints, 3) or not np.isfinite(
                motion).all():
            raise RuntimeError(f"options {label}: bad motion {motion.shape} "
                               f"for length {n}")
    reps = -(-B_LARGE // len(texts))
    ids = mld.tokenize((texts * reps)[:B_LARGE])
    blengths = (lengths * reps)[:B_LARGE]
    mask = lengths_to_mask(blengths, mld.max_frames, mld.device)

    def call():
        _reset_counts()
        joints = mld.generate_joints(ids, mask, generator=gen)
        _sync(torch)
        _check_counts(_read_counts(), want,
                      f"options {label} generate_joints B={B_LARGE}")
        return joints

    _check_joints(torch, call(), mask,
                  (B_LARGE, mld.max_frames, mld.njoints, 3))
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        call()
        times.append(time.perf_counter() - t0)
    med = sorted(times)[1]
    wall, busy, kinds = _traced_busy(torch, call)
    errs, held, bad = _options_reference(torch, label, cfg, mld, texts[0],
                                         lengths[0], kw)
    log(f"[options:{label}] generate {len(texts)} prompts {first:.3f} s "
        f"(first call); generate_joints B={B_LARGE} (ids "
        f"{tuple(ids.shape)}): {', '.join(f'{t:.4f}' for t in times)} s "
        f"(median {med:.4f} s, {B_LARGE / med:.1f} motions/s); one traced "
        f"call: device busy {busy:.2f} ms, {100 * busy / (1e3 * med):.1f}% "
        f"of the median call ({wall:.2f} ms under the profiler); by layer: "
        + ", ".join(f"{k} {v:.2f}" for k, v in Counter(kinds).most_common())
        + f"; launches every call {want}; card vs CPU, one prompt, "
        f"max_abs_err (scale): " + ", ".join(
            f"{k} {e:.3e} ({sc:.3e})" + ("" if k in held else " not held")
            for k, (e, sc) in errs.items())
        + f"; bar {E2E_RTOL:g} x max(scale, 1)")
    if bad:
        raise RuntimeError(f"options {label}: the card disagrees with the "
                           f"CPU reference ({', '.join(bad)})")
    return {"launches": want, "median_s": med,
            "busy_share": busy / (1e3 * med), "busy_ms": busy,
            "by_layer_ms": kinds, "ref_errs": errs,
            "prompt_len": ids.shape[1]}


def _options_train_cfg(label, stage, model, dropout=None):
    from mld_tpu_torch.config.core import (config_from_dict, config_to_dict,
                                           merge_dicts)

    cfg = _train_cfg(stage, dropout=dropout)
    return config_from_dict(merge_dicts(config_to_dict(cfg), {
        "name": f"smoke_options_{label.replace(' ', '_')}",
        "model": model}))


def check_options_train_reference(torch, label, stage, model):
    """One full-width step of an option arm at B=REF_TRAIN_B, dropout 0,
    f32 text tower: the card (kernels; K3 under autograd in the trainable
    attention) against the CPU (plain versions), the same params, batch
    and draws."""
    from mld_tpu_torch.config.core import (config_from_dict, config_to_dict,
                                           merge_dicts)
    from mld_tpu_torch.models.mld import MLD
    from mld_tpu_torch.train import steps

    cfg = config_from_dict(merge_dicts(config_to_dict(
        _options_train_cfg(label, stage, model, dropout=0.0)),
        {"model": {"clip_compute_dtype": "float32"}}))
    batch, dm = _batch(torch, cfg, REF_TRAIN_B, "cpu")
    if stage == "diffusion":
        draws = _diffusion_draws(torch, cfg, REF_TRAIN_B, SEED + 21)
    else:
        m = cfg.model
        draws = {"eps": torch.randn(
            REF_TRAIN_B, m.latent_size, m.latent_dim,
            generator=torch.Generator().manual_seed(SEED + 21))}
    want = _train_want(cfg, stage)
    out = {}
    for dev in (DEVICE, "cpu"):
        mld = MLD(cfg, mean=dm.mean, std=dm.std, device=dev,
                  generator=torch.Generator().manual_seed(SEED))
        state = steps.create_train_state(mld, stage)
        dbatch = {k: v.to(dev) for k, v in batch.items()}
        _reset_counts()
        logs, grads = steps.compute_grads(state, dbatch, None, draws)
        _sync(torch)
        counts = _read_counts()
        if dev == "cpu":
            if any(counts.values()):
                raise RuntimeError(f"the CPU step launched kernels: {counts}")
        else:
            _check_counts(counts, want, f"options {label} reference step")
        out[dev] = ({k: v.cpu() for k, v in logs.items()},
                    {k: g.cpu() for k, g in grads.items()})
        del mld, state
    loss_err, grad_err = _grad_err(*out[DEVICE], *out["cpu"])
    log(f"[options-train:{label}:reference] full-width step B="
        f"{REF_TRAIN_B} dropout 0, card vs CPU: launches on the card {want}; "
        f"loss {float(out[DEVICE][0]['total']):.6f} vs "
        f"{float(out['cpu'][0]['total']):.6f} (rel err {loss_err:.2e}), "
        f"worst gradient leaf {grad_err:.2e} of its scale (bar "
        f"{TRAIN_REF_RTOL:g})")
    if not (loss_err <= TRAIN_REF_RTOL and grad_err <= TRAIN_REF_RTOL):
        raise RuntimeError(f"options {label}: the card's training step "
                           f"disagrees with the CPU")
    return {"loss_rel_err": loss_err, "grad_rel_err": grad_err,
            "launches": want}


def phase_options(torch, smi, texts, lengths):
    """The text family's model options on the card: each arm of
    OPTION_ARMS through MLD.generate and generate_joints with its launches
    and a card-vs-CPU check, then OPTION_TRAIN_ARMS through train() with a
    card-vs-CPU step each."""
    from mld_tpu_torch.data.synthetic import build_synthetic_dataset
    from mld_tpu_torch.models.mld import MLD

    runs = {}
    for label, preset, model, kw in OPTION_ARMS:
        t0 = time.perf_counter()
        cfg = _options_cfg(preset, model)
        m = cfg.model
        mld = MLD(cfg, device=DEVICE,
                  generator=torch.Generator().manual_seed(SEED), **kw)
        log(f"[options:{label}] {preset} with {model} {kw}: CLIP "
            f"{m.clip_layers}x{m.text_encoded_dim} {m.clip_compute_dtype} "
            f"({mld.clip_mode} mode, {m.condition}), denoiser "
            f"{m.denoiser_arch} {m.denoiser_num_layers}x{m.latent_dim} "
            f"(skip {m.skip_connect}, pre-norm {m.normalize_before}, PE "
            f"{m.position_embedding}, latent_size {m.latent_size}, K1 "
            f"{mld.use_fused_denoiser()}), VAE {type(mld.vae).__name__} "
            f"({m.vae_arch if m.vae_type == 'mld' else m.vae_type}, mlp_dist "
            f"{m.mlp_dist}, fused decode {mld.fused_decode}), "
            f"{cfg.dataset.nfeats} features, {cfg.dataset.njoints} joints, "
            f"{type(mld.scheduler).__name__}-"
            f"{len(mld.scheduler.timesteps())}, CFG {m.guidance_scale}")
        runs[label] = drive_options(torch, label, cfg, mld, texts, lengths,
                                    kw)
        del mld
        torch.cuda.empty_cache()
        log(f"[time] options {label}: {time.perf_counter() - t0:.1f} s")

    if not os.path.exists(os.path.join(TRAIN_ROOT, "humanml3d", "Std.npy")):
        build_synthetic_dataset(os.path.join(TRAIN_ROOT, "humanml3d"),
                                n_samples=TRAIN_CLIPS, seed=SEED)
    for label, stage, model in OPTION_TRAIN_ARMS:
        t0 = time.perf_counter()
        mld, _, runs[f"train {label}"] = run_stage(
            torch, _options_train_cfg(label, stage, model), stage, smi,
            steps=OPTION_TRAIN_STEPS, traced=OPTION_TRAIN_TRACED,
            label=f"options {label}")
        del mld
        torch.cuda.empty_cache()
        runs[f"train {label} reference"] = check_options_train_reference(
            torch, label, stage, model)
        torch.cuda.empty_cache()
        log(f"[time] options training {label}: "
            f"{time.perf_counter() - t0:.1f} s")
    return runs


# ------------------------------------------------------ end-to-end protocol
# CLIP pretraining at full width: mld_humanml3d's tower (12x768, bf16
# compute) on phase 6's 128-clip corpus, B=64 (its train split holds one
# batch, so each step is also an epoch of the loader), PRETRAIN_STEPS steps;
# the median of steps 2-N leaves out the traced step
PRETRAIN_B = 64
PRETRAIN_STEPS = 60
PRETRAIN_TRACED = 30
PRETRAIN_REF_B = 8
PRETRAIN_REF_STEPS = 2
# card (K4, cuBLAS) vs CPU (plain versions) over two pretraining steps of
# the f32 12x768 tower: f32 summation order through the 12 layers and
# their backward, as in phase 6's reference step (TRAIN_REF_RTOL): each
# step's loss, and the first step's gradients by leaf against the leaf's
# largest |g| (the key projections' biases, whose gradient is zero in exact
# arithmetic, against the tower's). The second step's gradients follow
# parameters that Adam moved by about lr x sign(g), and the sign of a
# gradient at rounding level differs between the devices, so only its loss
# is held
PRETRAIN_REF_RTOL = TRAIN_REF_RTOL
# the e2e drill: the port's script at its small scale with its budgets cut
# (--steps 150 a stage, 60 CLIP steps, 150 evaluator steps; the corpus,
# the protocol's constants and the evaluation stand) and the train()
# section at 2 of its 3 epochs
E2E_ROOT = os.path.join(REPO, "build", "e2e_smoke")
E2E_ARGV = ("--model-scale", "small", "--steps", "150", "--clip-steps", "60",
            "--eval-steps", "150")
E2E_LOOP_EPOCHS = 2
# the protocol's clip lengths for K3's masks (16-96 frames), cycled
E2E_FRAMES = 96
E2E_LENGTHS = (96, 81, 64, 47, 30, 16)


def _pretrain_cfg(B, **model):
    from mld_tpu_torch.config import load_config

    return load_config(preset="mld_humanml3d", overrides={
        "name": "smoke_pretrain", "debug": True,
        "model": {**TRAIN_MODEL, **model},
        "dataset": {"root": os.path.join(TRAIN_ROOT, "humanml3d")},
        "train": {"batch_size": B}})


def _e2e_cfg():
    """The drill's config, as the script resolves it."""
    from mld_tpu_torch.config import load_config
    from mld_tpu_torch.scripts import train_synthetic_e2e as e2e

    args = e2e.parse_args(list(E2E_ARGV) + ["--workdir", E2E_ROOT])
    return load_config(None, e2e.protocol_config(args), preset=args.preset)


def _bucket_of(torch, dm, B):
    """The EOT bucket of the first training batch: K4's S in pretraining."""
    from mld_tpu_torch.models.mld import crop_to_bucket

    batch = next(iter(dm.loader("train", batch_size=B, prefetch=0,
                                drop_last=True)))
    return crop_to_bucket(torch.as_tensor(batch["text_ids"])).shape[1]


def check_e2e_kernels(torch, s_full, s_small):
    """K1, K3 and K4 at the shapes the protocol gives them, each against its
    plain version: K4 in the full-width pretraining ([64, 12, S, 64]) and in
    the small tower ([16, 2, S, 32]); K1 at the small denoiser's widths
    (D = 64, 4 heads, F = 128, 3 layers, 3 tokens) over the evaluation's 32
    prompts under CFG; K3 at the small VAE's (4 heads of 16): the decode's
    self-attention over 96 frames and its cross-attention to the latent at
    the evaluation's batch, and the frozen encode's self-attention over
    [2 tokens; 96 frames] at the training batch."""
    from mld_tpu_torch.models.mld import init_params
    from mld_tpu_torch.ops import fused_layer
    from mld_tpu_torch.ops.fused_layer import (skip_encoder_stack,
                                               skip_encoder_stack_plain,
                                               stack_skip_encoder)
    from mld_tpu_torch.ops.transformer import SkipTransformerEncoder

    cfg = _e2e_cfg()
    m = cfg.model
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 11)
    big = _pretrain_cfg(PRETRAIN_B).model
    eval_b, train_b = cfg.eval.batch_size, cfg.train.batch_size
    res = {"flash_causal": check_flash_causal(torch, g, [
        (PRETRAIN_B, big.clip_heads, s_full,
         big.text_encoded_dim // big.clip_heads, "pretrain"),
        (train_b, m.clip_heads, s_small, m.text_encoded_dim // m.clip_heads,
         "small tower")])}
    s, n_block = m.latent_size + 2, (m.denoiser_num_layers - 1) // 2
    encoder = SkipTransformerEncoder(m.latent_dim, m.num_heads,
                                     m.denoiser_num_layers, m.ff_size)
    init_params(encoder, torch.Generator().manual_seed(SEED + 12))
    encoder.to(DEVICE)
    res["skip_encoder"] = {}
    for wname, wdt, atol in WEIGHT_ARMS:
        st = stack_skip_encoder(encoder, getattr(torch, wdt))
        x = torch.randn(2 * eval_b, s, m.latent_dim, device=DEVICE,
                        generator=g)
        res["skip_encoder"][wname] = _hold(
            torch, "skip_encoder",
            lambda: skip_encoder_stack(x, st, n_block, m.num_heads),
            lambda: skip_encoder_stack_plain(x, st, n_block, m.num_heads),
            atol, f"{wname} e2e small D={m.latent_dim} L="
            f"{m.denoiser_num_layers} F={m.ff_size} seqs={2 * eval_b}",
            lambda: fused_layer.LAUNCHES,
            work=_encoder_work(2 * eval_b, n_block, st, s, m.latent_dim,
                               m.ff_size))
    dh, T, n_tok = m.latent_dim // m.num_heads, E2E_FRAMES, 2 * m.latent_size
    res["flash_attention"] = check_flash(torch, None, g, (
        ("e2e decode self", eval_b, m.num_heads, T, T, dh, "e2e frames"),
        ("e2e decode cross", eval_b, m.num_heads, T, m.latent_size, dh,
         None),
        ("e2e encode self", train_b, m.num_heads, T + n_tok, T + n_tok, dh,
         "e2e tokens")))
    return res


class _PretrainWatch:
    """pretrain_clip_text's on_step: each step's wall ms from the previous
    step's end (both ends synchronized; the loader's batch included), its
    launches (checked), its peak allocated memory, its loss, and a
    torch.profiler trace of step `traced`."""

    def __init__(self, torch, want, traced):
        self.torch, self.want, self.traced = torch, want, traced
        self.ms, self.peak, self.losses = {}, {}, []
        self.counts = self.busy = self.prof = None

    def start(self):
        _sync(self.torch)
        _reset_counts()
        _reset_peak(self.torch)
        self.t = time.perf_counter()

    def __call__(self, n, loss):
        torch = self.torch
        _sync(torch)
        self.ms[n] = (time.perf_counter() - self.t) * 1e3
        self.peak[n] = _peak_mib(torch)
        self.counts = _read_counts()
        _check_counts(self.counts, self.want, f"pretraining step {n}")
        self.losses.append(float(loss))
        if n == self.traced:
            self.prof.__exit__(None, None, None)
            busy = sum(e.time_range.elapsed_us() for e in self.prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
            self.busy = {"wall_ms": self.ms[n], "busy_ms": busy / 1e3,
                         "busy_share": busy / 1e3 / self.ms[n]}
        if n == self.traced - 1:
            from torch.profiler import ProfilerActivity, profile
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.__enter__()
        _reset_counts()
        _reset_peak(torch)
        self.t = time.perf_counter()


def pretrain_full_width(torch, smi):
    """pretrain_clip_text on mld_humanml3d's tower at B = PRETRAIN_B: K4's
    launches every step (clip_layers), ms a step, peak memory, a falling
    finite style-MSE, every tower leaf moved, the tower's flags restored,
    the device busy share of one traced step."""
    from mld_tpu_torch.data.datamodule import get_datamodule
    from mld_tpu_torch.models.clip_text import ClipTokenizer
    from mld_tpu_torch.models.mld import MLD
    from mld_tpu_torch.train.pretrain import pretrain_clip_text

    cfg = _pretrain_cfg(PRETRAIN_B)
    m = cfg.model
    dm = get_datamodule(cfg, tokenizer=ClipTokenizer(m.clip_path))
    mld = MLD(cfg, mean=dm.mean, std=dm.std, device=DEVICE,
              generator=torch.Generator().manual_seed(SEED))
    mld.requires_grad_(False)       # as the training stages leave it
    before = {k: p.detach().clone() for k, p in mld.clip.named_parameters()}
    want = dict.fromkeys(_read_counts(), 0)
    want["flash_causal"] = m.clip_layers
    watch = _PretrainWatch(torch, want, PRETRAIN_TRACED)
    t0 = time.perf_counter()
    watch.start()
    report = pretrain_clip_text(cfg, dm, mld, steps=PRETRAIN_STEPS,
                                log_every=0, on_step=watch)
    wall = time.perf_counter() - t0
    moved = sum(not torch.equal(p, before[k])
                for k, p in mld.clip.named_parameters())
    if (moved != len(before) or any(p.requires_grad
                                    for p in mld.clip.parameters())):
        raise RuntimeError(f"pretraining: {moved} of {len(before)} tower "
                           f"leaves moved, or the tower's flags were not "
                           f"restored")
    first, last = report["style_mse_first"], report["style_mse_last"]
    if not (math.isfinite(first) and math.isfinite(last) and last < first
            and all(map(math.isfinite, watch.losses))):
        raise RuntimeError(f"pretraining's style-MSE did not fall: "
                           f"{first} -> {last}")
    kept = [ms for n, ms in watch.ms.items() if n > 1 and n != watch.traced]
    peak = max(mib for n, mib in watch.peak.items()
               if n > 1 and n != watch.traced)
    s = _bucket_of(torch, dm, PRETRAIN_B)
    b = watch.busy
    log(f"[e2e:pretrain] CLIP {m.clip_layers}x{m.text_encoded_dim} "
        f"{m.clip_compute_dtype} compute, B={PRETRAIN_B}, ids cropped to "
        f"S={s}, {report['steps']} steps (lr 1e-3, warmup "
        f"{max(20, PRETRAIN_STEPS // 10)}, end 0.05 lr): step median "
        f"{statistics.median(kept):.2f} ms (n={len(kept)}, steps 2-"
        f"{PRETRAIN_STEPS} but the traced one; the loader's batch "
        f"included; all: {', '.join(f'{v:.1f}' for v in watch.ms.values())}"
        f"); K4 {watch.counts['flash_causal']} launches a step under "
        f"autograd (every step checked: {want}); style-MSE first 10 "
        f"{first:.5f} -> last 10 {last:.5f}; every one of {moved} tower "
        f"leaves moved; peak allocated {peak:.1f} MiB a step; device busy "
        f"{100 * b['busy_share']:.1f}% of {b['wall_ms']:.1f} ms (step "
        f"{watch.traced} traced); {wall:.1f} s; {smi}")
    del mld
    torch.cuda.empty_cache()
    return {"step_median_ms": statistics.median(kept), "step_n": len(kept),
            "peak_mib": peak, "busy": b, "launches": watch.counts,
            "style_mse_first": first, "style_mse_last": last, "S": s,
            "seconds": wall}


def _pretrain_grad_err(a, b):
    """Worst leaf error of gradients `a` against `b` over the leaf's largest
    |g|; the key projections' biases over the tower's largest |g|."""
    top = max(float(g.abs().max()) for g in b.values())
    worst, name = 0.0, None
    for k, g in b.items():
        scale = top if k.endswith("k_proj.bias") else float(g.abs().max())
        err = float((a[k] - g).abs().max()) / max(scale, 1e-30)
        if err > worst:
            worst, name = err, k
    return worst, name


def check_pretrain_reference(torch):
    """PRETRAIN_REF_STEPS pretraining steps of the f32 12x768 tower at
    B = PRETRAIN_REF_B, card (K4) vs CPU (plain versions), from the same
    init on the same batches: each step's loss and the first step's
    gradients."""
    from mld_tpu_torch.data.datamodule import get_datamodule
    from mld_tpu_torch.models.clip_text import ClipTokenizer
    from mld_tpu_torch.models.mld import MLD
    from mld_tpu_torch.train.pretrain import pretrain_clip_text

    cfg = _pretrain_cfg(PRETRAIN_REF_B, clip_compute_dtype="float32")
    out = {}
    for dev in (DEVICE, "cpu"):
        dm = get_datamodule(cfg, tokenizer=ClipTokenizer(cfg.model.clip_path))
        mld = MLD(cfg, device=dev,
                  generator=torch.Generator().manual_seed(SEED))
        rec = {"losses": []}

        def on_step(n, loss, mld=mld, rec=rec):
            rec["losses"].append(float(loss))
            if n == 1:
                rec["grads"] = {k: p.grad.detach().cpu().clone()
                                for k, p in mld.clip.named_parameters()}

        _reset_counts()
        pretrain_clip_text(cfg, dm, mld, steps=PRETRAIN_REF_STEPS,
                           log_every=0, on_step=on_step)
        rec["counts"] = _read_counts()
        out[dev] = rec
        del mld
    want = PRETRAIN_REF_STEPS * cfg.model.clip_layers
    if (out[DEVICE]["counts"]["flash_causal"] != want
            or any(out["cpu"]["counts"].values())):
        raise RuntimeError(f"reference pretraining launches: card "
                           f"{out[DEVICE]['counts']}, CPU "
                           f"{out['cpu']['counts']}")
    loss_err = max(abs(a - b) / abs(b) for a, b in
                   zip(out[DEVICE]["losses"], out["cpu"]["losses"]))
    grad_err, leaf = _pretrain_grad_err(out[DEVICE]["grads"],
                                        out["cpu"]["grads"])
    log(f"[e2e:pretrain-reference] f32 tower {cfg.model.clip_layers}x"
        f"{cfg.model.text_encoded_dim}, B={PRETRAIN_REF_B}, "
        f"{PRETRAIN_REF_STEPS} steps, card (K4 {want} launches) vs CPU: "
        f"losses {out[DEVICE]['losses']} vs {out['cpu']['losses']} (worst "
        f"rel err {loss_err:.2e}); first step's worst gradient leaf "
        f"{grad_err:.2e} of its scale ({leaf}) (bar {PRETRAIN_REF_RTOL:g})")
    if not (loss_err <= PRETRAIN_REF_RTOL and grad_err <= PRETRAIN_REF_RTOL):
        raise RuntimeError("the card's pretraining disagrees with the CPU")
    return {"loss_rel_err": loss_err, "grad_rel_err": grad_err}


def _finite_metrics(what, metrics):
    bad = {k: v for k, v in metrics.items() if not math.isfinite(v)}
    if bad:
        raise RuntimeError(f"e2e drill: non-finite {what}: {bad}")


def e2e_drill(torch, smi):
    """python -m mld_tpu_torch.scripts.train_synthetic_e2e in-process at
    E2E_ARGV on the card, each section's seconds and launches read through
    wrappers (the train() section holds its own evaluation passes); every
    stage's loss must fall, every metric be finite, each training and
    evaluation call launch what its config derives, and the trained
    bundle load back through load_pretrained with its tower."""
    import shutil

    import numpy as np

    from mld_tpu_torch.config.core import config_from_dict
    from mld_tpu_torch.eval import pipeline, t2m_train
    from mld_tpu_torch.models.mld import MLD
    from mld_tpu_torch.scripts import train_synthetic_e2e as e2e
    from mld_tpu_torch.train import loop, pretrain
    from mld_tpu_torch.utils.checkpoint import (load_params_npz,
                                                load_pretrained)

    shutil.rmtree(E2E_ROOT, ignore_errors=True)
    os.makedirs(E2E_ROOT)
    sections = []
    patched = []

    def wrap(owner, attr, label):
        inner = getattr(owner, attr)

        def run(*args, **kwargs):
            _sync(torch)
            before, t = _read_counts(), time.perf_counter()
            out = inner(*args, **kwargs)
            _sync(torch)
            after = _read_counts()
            name = label(args) if callable(label) else label
            sections.append((name, time.perf_counter() - t,
                             {k: after[k] - before[k] for k in after}))
            return out

        patched.append((owner, attr, inner))
        setattr(owner, attr, run)

    wrap(t2m_train, "train_t2m_evaluator", "t2m evaluator")
    wrap(pretrain, "pretrain_clip_text", "clip pretrain")
    wrap(e2e, "run_stage", lambda a: f"{a[0].stage} stage")
    wrap(pipeline.Evaluator, "run_gt", "run_gt")
    wrap(pipeline.Evaluator, "run_split", "run_split")
    wrap(loop, "train", "train() section")
    report_path = os.path.join(E2E_ROOT, "report.json")
    argv = list(E2E_ARGV) + ["--workdir", E2E_ROOT, "--out", report_path,
                             "--device", DEVICE]
    epochs = e2e.LOOP_EPOCHS
    e2e.LOOP_EPOCHS = E2E_LOOP_EPOCHS
    _reset_counts()
    t0 = time.perf_counter()
    try:
        rc = e2e.main(argv)
    finally:
        e2e.LOOP_EPOCHS = epochs
        for owner, attr, inner in reversed(patched):
            setattr(owner, attr, inner)
    wall = time.perf_counter() - t0
    total = _read_counts()
    with open(report_path) as f:
        report = json.load(f)
    with open(os.path.join(E2E_ROOT, "cfg.json")) as f:
        cfg = config_from_dict(json.load(f))
    m = cfg.model
    steps = report["steps"]

    for name, first, last in (
            ("t2m evaluator", "loss_first", "loss_last"),
            ("clip_pretrain", "style_mse_first", "style_mse_last"),
            ("vae", "loss_first", "loss_last"),
            ("diffusion", "loss_first", "loss_last")):
        sec = report["t2m_evaluator" if name == "t2m evaluator" else name]
        if not (math.isfinite(sec[first]) and math.isfinite(sec[last])
                and sec[last] < sec[first]):
            raise RuntimeError(f"e2e drill: the {name} loss did not fall: "
                               f"{sec[first]} -> {sec[last]}")
    for key in ("eval_gt", "eval_random_init", "eval_trained"):
        _finite_metrics(key, report[key])
    curve = report["val_fid_curve"]
    if len(curve) != E2E_LOOP_EPOCHS:
        raise RuntimeError(f"e2e drill: {len(curve)} val metric points")
    for point in curve:
        _finite_metrics("val curve", {"FID": point["FID"],
                                      "R@1": point["R@1"]})

    # launches by section, from the config: the stages' steps, the tower's
    # layers a pretraining step, and a DDIM generation pass an evaluated
    # batch (K1 a step; K4 the prompts and the uncond row; K3 the plain
    # decode's self- and cross-attention a layer)
    per_batch = dict.fromkeys(total, 0)
    per_batch.update(skip_encoder=m.scheduler.num_inference_timesteps,
                     flash_causal=2 * m.clip_layers,
                     flash_attention=2 * m.num_layers)
    for name, _, counts in sections:
        if name in ("vae stage", "diffusion stage"):
            want = {k: steps * v for k, v in _train_want(
                cfg, name.split()[0]).items()}
        elif name == "clip pretrain":
            want = dict.fromkeys(total, 0)
            want["flash_causal"] = (report["clip_pretrain"]["steps"]
                                    * m.clip_layers)
        elif name in ("t2m evaluator", "run_gt"):
            want = dict.fromkeys(total, 0)
        elif name == "run_split":
            n = counts["skip_encoder"] // per_batch["skip_encoder"]
            want = {k: n * v for k, v in per_batch.items()}
            if n == 0:
                raise RuntimeError("e2e drill: an evaluation pass launched "
                                   "no K1")
        else:
            continue
        _check_counts(counts, want, f"e2e drill {name}")
    if not (total["skip_encoder"] and total["flash_causal"]
            and total["flash_attention"]) or total["skip_decoder"]:
        raise RuntimeError(f"e2e drill launches {total}")

    # the trained bundle in the JAX package's form: every module, the tower
    # included, loads back bit for bit, and the tower is the trained one
    mld = MLD(cfg, device=DEVICE, generator=torch.Generator().manual_seed(0))
    fresh = {k: p.detach().clone() for k, p in mld.clip.named_parameters()}
    tops = load_pretrained(mld, report["params_path"])
    saved = load_params_npz(report["params_path"])
    tree = mld.params_tree()

    def leaves(t, prefix=""):
        for k, v in t.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", v

    mine, theirs = dict(leaves(tree)), dict(leaves(saved))
    if (sorted(tops) != ["clip", "denoiser", "vae"] or set(mine) != set(theirs)
            or any(not np.array_equal(mine[k], theirs[k]) for k in mine)):
        raise RuntimeError(f"e2e drill: {report['params_path']} did not load "
                           f"back whole: {tops}")
    moved = sum(not torch.equal(p, fresh[k])
                for k, p in mld.clip.named_parameters())
    if moved == 0:
        raise RuntimeError("e2e drill: the bundle's tower is the init's")
    del mld

    by = {}
    for name, secs, counts in sections:
        s_, c_ = by.setdefault(name, [0.0, Counter()])
        by[name][0] += secs
        c_.update(counts)
    for name, (secs, counts) in by.items():
        log(f"[e2e:drill] {name}: {secs:.1f} s, launches "
            f"{dict(counts)}")
    ev, rnd = report["eval_trained"], report["eval_random_init"]
    log(f"[e2e:drill] {' '.join(E2E_ARGV)}, train() "
        f"{E2E_LOOP_EPOCHS} epochs: {wall:.1f} s; evaluator nce "
        f"{report['t2m_evaluator']['loss_first']:.3f} -> "
        f"{report['t2m_evaluator']['loss_last']:.3f}; style-MSE "
        f"{report['clip_pretrain']['style_mse_first']:.4f} -> "
        f"{report['clip_pretrain']['style_mse_last']:.4f}; vae "
        f"{report['vae']['loss_first']:.4f} -> "
        f"{report['vae']['loss_last']:.4f}; diffusion "
        f"{report['diffusion']['loss_first']:.4f} -> "
        f"{report['diffusion']['loss_last']:.4f}; GT R@1 "
        f"{report['eval_gt']['R_precision_top_1']:.3f}; random vs trained "
        f"R@1 {rnd['R_precision_top_1']:.3f} / {ev['R_precision_top_1']:.3f}"
        f", FID {rnd['FID']:.2f} / {ev['FID']:.2f}; val FID curve "
        f"{[round(p['FID'], 2) for p in curve]}; the script's learning "
        f"rule at this cut budget: {'PASS' if rc == 0 else 'FAIL'} (the "
        f"learning run's, not held here); launches {total}; bundle "
        f"{tops} loaded back bit for bit, its tower trained ({moved} "
        f"leaves off the init); {smi}")
    return {"seconds": wall, "launches": total, "rc": rc,
            "sections": {name: {"seconds": secs, "launches": dict(c)}
                         for name, (secs, c) in by.items()}}


def phase_e2e(torch, smi):
    """The synthetic end-to-end protocol on the card: the kernels at its
    shapes, CLIP pretraining at full width with a card-vs-CPU check, and a
    drill of the port's e2e script."""
    from mld_tpu_torch.data.datamodule import get_datamodule
    from mld_tpu_torch.data.synthetic import build_synthetic_dataset
    from mld_tpu_torch.models.clip_text import ClipTokenizer

    if not os.path.exists(os.path.join(TRAIN_ROOT, "humanml3d", "Std.npy")):
        build_synthetic_dataset(os.path.join(TRAIN_ROOT, "humanml3d"),
                                n_samples=TRAIN_CLIPS, seed=SEED)
    cfg = _pretrain_cfg(PRETRAIN_B)
    s_full = _bucket_of(torch, get_datamodule(
        cfg, tokenizer=ClipTokenizer(cfg.model.clip_path)), PRETRAIN_B)
    runs = {}
    t0 = time.perf_counter()
    with torch.no_grad():
        # the small tower's prompts are the same captions' ids
        runs["kernels"] = check_e2e_kernels(torch, s_full, s_full)
    log(f"[time] e2e kernels: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    runs["pretrain"] = pretrain_full_width(torch, smi)
    runs["pretrain_reference"] = check_pretrain_reference(torch)
    torch.cuda.empty_cache()
    log(f"[time] e2e pretraining: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    runs["drill"] = e2e_drill(torch, smi)
    torch.cuda.empty_cache()
    log(f"[time] e2e drill: {time.perf_counter() - t0:.1f} s")
    return runs


# ------------------------------------------------------------ 12. output path
OUTPUT_ROOT = os.path.join(REPO, "build", "output_smoke")
# the SMPL pickle's schema at full size: 6,890 vertices, 24 joints, 10
# betas, 207 pose blend shapes, 13,776 faces
OUTPUT_SMPL_V = 6890
OUTPUT_SMPL_F = 13776
OUTPUT_GMM_K = 8
OUTPUT_REPS = 2
OUTPUT_ACTIONS = (3, 7)
OUTPUT_SAMPLE_LENGTHS = (196, 120, 60)
OUTPUT_RECON_FRAMES = 120
# empty: the presets' full widths; the CPU rehearsal makes the model tiny
OUTPUT_MODEL = {}
# the fitter's defaults (fit.py): 300 Adam steps, a 25-step polish
OUTPUT_FIT_STEPS = 300
OUTPUT_POLISH_STEPS = 25
# card vs CPU on a motion the fabricated body can reach (the FK of a smooth
# seeded pose walk, 196 frames): Adam's loss at its first step (the same
# parameters: the objective itself), at every step (Adam's early transient
# amplifies rounding: the card parts from the CPU by 1.07e-4 at step 12)
# and at its last; Adam's iterate; after the polish the worst joint (a
# frame's accept or reject can flip at f32 rounding) and MPJPE; the mesh of
# one set of parameters against its scale. The demo's random-weight
# 196-frame motion is no human motion (the fits stay ~0.3 m off it) and
# ill-conditioned: the polish drives some rot6d pairs to within 1e-7 of
# parallel, where Gram-Schmidt amplifies rounding. It is held at Adam's
# first loss and MPJPE, and its trajectory against the CPU's own: each
# motion is fitted on the CPU a second time with its target moved by 1e-7
# of its scale (about one f32 ulp), and the card may part from the CPU by
# no more than OUTPUT_NUDGE_FACTOR times that nudge's divergence in the
# loss curve, the Adam iterate and the polished joints
OUTPUT_LOSS0_RTOL = 1e-6
OUTPUT_LOSS_RTOL = 2e-4
OUTPUT_LOSS_LAST_RTOL = 1e-4
OUTPUT_PARAM_ATOL = 1e-3
OUTPUT_JOINT_ATOL = 2e-3
OUTPUT_MPJPE_RTOL = 0.1
OUTPUT_VERT_RTOL = 1e-5
OUTPUT_NUDGE = 1e-7
OUTPUT_NUDGE_FACTOR = 10.0
# the loss curves' first steps past these relative gaps are printed
OUTPUT_GAPS = (1e-6, 1e-5, 1e-4, 1e-3)
OUTPUT_WALK_FRAMES = 196
# steps of each phase under torch.profiler (300 traced Adam steps are 260k
# device events, whose processing takes minutes)
OUTPUT_TRACE_STEPS = 20
OUTPUT_TRACE_POLISH = 4


def write_smpl_assets(root, V=None, F=None, seed=SEED):
    """A seeded SMPL-schema pickle (V vertices, 24 joints, 10 betas, 207
    pose blend shapes, F faces) and a gmm_08.pkl beside it (8 components
    over the 69 body-pose dims, covariances A A^T + I). The body is built
    around the offline skeleton's rest joints, so that the regressed joints
    make a human skeleton: each vertex belongs to a joint (skinning weights
    mostly its own), and J_regressor averages each joint's vertices."""
    import pickle

    import numpy as np

    from mld_tpu_torch.models.smpl import SMPL_PARENTS, _APPROX_OFFSETS_ABS

    V = V or OUTPUT_SMPL_V
    F = F or OUTPUT_SMPL_F
    rng = np.random.RandomState(seed)
    J = len(SMPL_PARENTS)
    owner = np.arange(V) % J
    v_template = (_APPROX_OFFSETS_ABS()[owner]
                  + 0.04 * rng.randn(V, 3)).astype(np.float32)
    reg = (owner[None] == np.arange(J)[:, None]).astype(np.float64)
    weights = 0.1 * rng.dirichlet(np.ones(J), V)
    weights[np.arange(V), owner] += 0.9
    data = {"v_template": v_template,
            "shapedirs": 0.01 * rng.randn(V, 3, 10),
            "J_regressor": reg / reg.sum(1, keepdims=True),
            "weights": weights,
            "posedirs": 0.01 * rng.randn(V, 3, 207),
            "kintree_table": np.stack([[4294967295] + SMPL_PARENTS[1:],
                                       list(range(J))]),
            "f": rng.randint(0, V, (F, 3))}
    os.makedirs(root, exist_ok=True)
    smpl_path = os.path.join(root, "SMPL_NEUTRAL.pkl")
    with open(smpl_path, "wb") as f:
        pickle.dump(data, f)
    A = 0.1 * rng.randn(OUTPUT_GMM_K, 69, 69)
    w = rng.rand(OUTPUT_GMM_K) + 0.5
    with open(os.path.join(root, "gmm_08.pkl"), "wb") as f:
        pickle.dump({"means": 0.2 * rng.randn(OUTPUT_GMM_K, 69),
                     "covars": A @ A.transpose(0, 2, 1) + np.eye(69),
                     "weights": w / w.sum()}, f)
    return smpl_path


def _output_cfgs(root):
    """The demo's config files (JSON, which YAML reads): the text model on
    phase 6's corpus, the action model in a root of its own."""
    paths = {}
    for name, dataset in (("t2m", os.path.join(TRAIN_ROOT, "humanml3d")),
                          ("a2m", os.path.join(root, "humanact12"))):
        paths[name] = os.path.join(root, f"{name}.json")
        with open(paths[name], "w") as f:
            json.dump({"model": dict(OUTPUT_MODEL),
                       "dataset": {"root": dataset}}, f)
    return paths


def _output_want(cfg, task):
    """Kernel launches of one demo generation: text K1 a DDIM step, K4 a
    tower layer for the prompts and the uncond row, K3 in each decoder
    layer's self- and cross-attention; action K1 and the ACTOR decode;
    random sampling the decode alone; reconstruction the encode (K3 a
    layer) and the decode."""
    m = cfg.model
    k1 = m.scheduler.num_inference_timesteps
    want = {"skip_encoder": 0, "skip_decoder": 0, "skip_decoder_kernels": 0,
            "flash_causal": 0, "flash_attention": 2 * m.num_layers}
    if task in ("text_motion", "action"):
        want["skip_encoder"] = k1
    if task == "text_motion":
        want["flash_causal"] = 2 * m.clip_layers
    if task == "reconstruction":
        want["flash_attention"] = 3 * m.num_layers
    return want


def output_demo(torch, cfgs, out_dir):
    """python -m mld_tpu_torch.demo in each task, launches read around each
    call: the demo prompts at --replication 2 --allinone, two action ids,
    three latent draws, one reconstruction."""
    import numpy as np

    from mld_tpu_torch import demo
    from mld_tpu_torch.config import load_config

    t2m = load_config(cfgs["t2m"], preset="mld_humanml3d")
    a2m = load_config(cfgs["a2m"], preset="mld_humanact12")
    texts, lengths = _demo_prompts()
    feats = np.random.RandomState(SEED + 12).randn(
        OUTPUT_RECON_FRAMES, t2m.dataset.nfeats).astype(np.float32)
    feats_path = os.path.join(OUTPUT_ROOT, "recon_feats.npy")
    np.save(feats_path, feats)
    runs = {}
    calls = (
        ("text_motion", t2m, OUTPUT_REPS,
         ["--cfg", cfgs["t2m"], "--example",
          os.path.join(REPO, "demo", "example.txt"), "--replication",
          str(OUTPUT_REPS), "--allinone"]),
        ("action", a2m, 1,
         ["--cfg", cfgs["a2m"], "--task", "action", "--action"]
         + [str(a) for a in OUTPUT_ACTIONS]),
        ("random_sampling", t2m, 1,
         ["--cfg", cfgs["t2m"], "--task", "random_sampling", "--length"]
         + [str(n) for n in OUTPUT_SAMPLE_LENGTHS]),
        ("reconstruction", t2m, 1,
         ["--cfg", cfgs["t2m"], "--task", "reconstruction", "--motion",
          feats_path]))
    for task, cfg, reps, argv in calls:
        want = _output_want(cfg, task)
        _reset_counts()
        t0 = time.perf_counter()
        result = demo.main(argv + ["--out", os.path.join(out_dir, task),
                                   "--device", DEVICE])
        _sync(torch)
        wall = time.perf_counter() - t0
        counts = _read_counts()
        _check_counts(counts, {k: reps * v for k, v in want.items()},
                      f"demo {task} ({reps} replication(s))")
        if task == "text_motion":
            shapes = [(n, 22, 3) for n in lengths] * reps
        elif task == "action":
            shapes = [(cfg.dataset.num_frames, 24, 3)] * len(OUTPUT_ACTIONS)
        elif task == "random_sampling":
            shapes = [(n, 22, 3) for n in OUTPUT_SAMPLE_LENGTHS]
        else:
            shapes = [(OUTPUT_RECON_FRAMES, 22, 3)] * 2
        got = [np.load(f) for f in result["files"]]
        if [g.shape for g in got] != shapes:
            raise RuntimeError(f"demo {task}: shapes {[g.shape for g in got]}"
                               f", expected {shapes}")
        if not all(np.isfinite(g).all() for g in got):
            raise RuntimeError(f"demo {task}: non-finite joints")
        log(f"[output:demo] {task}: {len(got)} npys in {wall:.2f} s "
            f"(model build included), launches {counts} = {reps} x {want}"
            + (f"; generate seconds a replication "
               f"{[round(t, 4) for t in result['times']]}"
               if result["times"] else ""))
        runs[task] = {"launches": want, "seconds": wall,
                      "times": result["times"], "files": result["files"]}
    allinone = np.load(os.path.join(out_dir, "text_motion",
                                    "text_motion_allinone.npy"))
    if allinone.shape != (len(texts), OUTPUT_REPS, max(lengths), 22, 3):
        raise RuntimeError(f"allinone {allinone.shape}")
    return runs


def _fit_gaps(a, b):
    """How far fit `a` parts from fit `b`: the loss curve (relative; at the
    first step, the worst, the last, and the first step past each of
    OUTPUT_GAPS), Adam's iterate, the polished joints and MPJPE."""
    import numpy as np

    rel = np.abs(a["losses"] / b["losses"] - 1)
    return {"loss_first": float(rel[0]), "loss": float(rel.max()),
            "loss_worst_step": int(rel.argmax()), "loss_last": float(rel[-1]),
            "loss_first_step_past": {
                str(g): (int(np.argmax(rel > g)) if (rel > g).any() else None)
                for g in OUTPUT_GAPS},
            "adam_iterate": max(float(np.abs(a["adam"][k]
                                             - b["adam"][k]).max())
                                for k in ("rot6d", "trans")),
            "polished_joints": float(np.abs(a["joints_fit"]
                                            - b["joints_fit"]).max()),
            "mpjpe": abs(a["mpjpe"] / b["mpjpe"] - 1)}


def output_fit_reference(torch, smpl_path, joints, label, bars, trace):
    """One motion fitted on the card, Adam and polish apart (each traced
    once after the untraced run when `trace`), then the same fit on the
    CPU, and on the CPU again with the target nudged by OUTPUT_NUDGE of its
    scale: the card against the CPU (the loss curve, Adam's iterate, the
    polished joints, MPJPE and the mesh) beside the CPU against its nudged
    self. The card-vs-CPU gaps `bars` names are held to their limits;
    "nudge" holds the loss curve, the iterate and the polished joints to
    OUTPUT_NUDGE_FACTOR times the nudge's."""
    import numpy as np

    from mld_tpu_torch.transforms.fitting import BatchedSMPLFitter
    from mld_tpu_torch.utils.precision import strict_f32

    kw = dict(num_steps=OUTPUT_FIT_STEPS, polish_steps=OUTPUT_POLISH_STEPS)
    scale = float(np.abs(joints[:, :22]).max())
    nudge = (OUTPUT_NUDGE * scale * np.random.RandomState(SEED + 13).randn(
        *joints[:, :22].shape)).astype(np.float32)
    sides = {}
    for name, device, shift in (("card", DEVICE, None), ("cpu", "cpu", None),
                                ("nudged", "cpu", nudge)):
        fitter = BatchedSMPLFitter(smpl_path, device=device, **kw)
        if not fitter.prior.available:
            raise RuntimeError("the GMM prior did not load")
        goal = joints[:, :22] if shift is None else joints[:, :22] + shift
        target = torch.as_tensor(goal, device=fitter.device)
        with strict_f32(), torch.no_grad():
            t0 = time.perf_counter()
            params, losses = fitter.adam(target)
            _sync(torch)
            t1 = time.perf_counter()
            polished = fitter.polish(params, target)
            fit_joints = fitter.smpl.joints(polished["rot6d"],
                                            polished["trans"])
            _sync(torch)
            t2 = time.perf_counter()
            side = {"adam": {k: v.cpu().numpy() for k, v in params.items()},
                    "losses": losses.cpu().numpy(),
                    "polished": {k: v.cpu().numpy()
                                 for k, v in polished.items()},
                    "joints_fit": fit_joints.cpu().numpy(),
                    "adam_s": t1 - t0, "polish_s": t2 - t1}
            if trace and name == "card":
                # a few steps of each phase traced (a step's launches do
                # not depend on the step), against the untraced run's time
                # a step
                short = BatchedSMPLFitter(
                    smpl_path, device=device, num_steps=OUTPUT_TRACE_STEPS,
                    polish_steps=OUTPUT_TRACE_POLISH)
                _, aw, aev = _traced(torch, lambda: short.adam(target))
                _, pw, pev = _traced(
                    torch, lambda: short.polish(params, target))
                ab, an = sum(ms for _, ms in aev), len(aev)
                pb, pn = sum(ms for _, ms in pev), len(pev)
                adam_ms = 1e3 * side["adam_s"] / OUTPUT_FIT_STEPS
                polish_ms = 1e3 * side["polish_s"] / OUTPUT_POLISH_STEPS
                side["trace"] = {
                    "adam_busy_ms_a_step": ab / OUTPUT_TRACE_STEPS,
                    "adam_busy_share": ab / OUTPUT_TRACE_STEPS / adam_ms,
                    "adam_events_a_step": an / OUTPUT_TRACE_STEPS,
                    "adam_traced_ms_a_step": aw / OUTPUT_TRACE_STEPS,
                    "polish_busy_ms_a_step": pb / OUTPUT_TRACE_POLISH,
                    "polish_busy_share": pb / OUTPUT_TRACE_POLISH
                    / polish_ms,
                    "polish_events_a_step": pn / OUTPUT_TRACE_POLISH,
                    "polish_traced_ms_a_step": pw / OUTPUT_TRACE_POLISH}
        # MPJPE against the motion itself, for the nudged fit too
        side["mpjpe"] = float(np.linalg.norm(
            side["joints_fit"][:, :22] - joints[:, :22], axis=-1).mean())
        side["fitter"] = fitter
        sides[name] = side
    card, cpu = sides["card"], sides["cpu"]
    T = len(joints)
    t = card.get("trace")
    log(f"[output:fit] {label} ({T} frames) on the card: adam "
        f"{card['adam_s']:.3f} s ({1e3 * card['adam_s'] / OUTPUT_FIT_STEPS:.2f}"
        f" ms a step), polish {card['polish_s']:.3f} s "
        f"({1e3 * card['polish_s'] / OUTPUT_POLISH_STEPS:.2f} ms a step), "
        f"{1e3 * (card['adam_s'] + card['polish_s']) / T:.2f} ms a frame, "
        f"MPJPE {card['mpjpe']:.5f} m; the CPU: adam {cpu['adam_s']:.3f} s, "
        f"polish {cpu['polish_s']:.3f} s")
    if t:
        log(f"[output:fit] {label} traced ({OUTPUT_TRACE_STEPS} Adam steps, "
            f"{OUTPUT_TRACE_POLISH} LM steps): adam device busy "
            f"{t['adam_busy_ms_a_step']:.3f} ms a step = "
            f"{100 * t['adam_busy_share']:.1f}% of the untraced step, "
            f"{t['adam_events_a_step']:.1f} device events a step "
            f"({t['adam_traced_ms_a_step']:.1f} ms a step under the "
            f"profiler); polish busy {t['polish_busy_ms_a_step']:.3f} ms a "
            f"step = {100 * t['polish_busy_share']:.1f}%, "
            f"{t['polish_events_a_step']:.1f} events a step "
            f"({t['polish_traced_ms_a_step']:.1f} ms under the profiler)")

    # the mesh of the card's fitted parameters, on each device
    verts = {n: sides[n]["fitter"].vertices(card["polished"]["rot6d"],
                                            card["polished"]["trans"])
             for n in ("card", "cpu")}
    errs = _fit_gaps(card, cpu)
    errs["vertices"] = (float(np.abs(verts["card"] - verts["cpu"]).max())
                        / float(np.abs(verts["cpu"]).max()))
    nudged = _fit_gaps(cpu, sides["nudged"])
    limits = {"loss_first": OUTPUT_LOSS0_RTOL, "loss": OUTPUT_LOSS_RTOL,
              "loss_last": OUTPUT_LOSS_LAST_RTOL,
              "adam_iterate": OUTPUT_PARAM_ATOL,
              "polished_joints": OUTPUT_JOINT_ATOL,
              "mpjpe": OUTPUT_MPJPE_RTOL, "vertices": OUTPUT_VERT_RTOL}
    held = [k for k in bars if k != "nudge"]
    if "nudge" in bars:
        for k in ("loss", "adam_iterate", "polished_joints"):
            limits[k] = OUTPUT_NUDGE_FACTOR * nudged[k]
            held.append(k)

    def fmt(v):
        return str(v) if isinstance(v, (dict, int)) else f"{v:.3g}"

    log(f"[output:fit] {label} card vs CPU (MPJPE {card['mpjpe']:.5f} / "
        f"{cpu['mpjpe']:.5f} m): "
        + ", ".join(f"{k} {fmt(v)}" + (f" (bar {limits[k]:.3g})"
                                       if k in held else "")
                    for k, v in errs.items()))
    log(f"[output:fit] {label} CPU vs the CPU with the target moved by "
        f"{OUTPUT_NUDGE:g} of its scale {scale:.3f} (MPJPE "
        f"{sides['nudged']['mpjpe']:.5f} m): "
        + ", ".join(f"{k} {fmt(v)}" for k, v in nudged.items()))
    for k in held:
        if not errs[k] <= limits[k]:
            raise RuntimeError(f"fit {label} card vs CPU: {k} {errs[k]} > "
                               f"{limits[k]}")
    return {"frames": T, "adam_s": card["adam_s"],
            "polish_s": card["polish_s"], "mpjpe": card["mpjpe"],
            "trace": t, "cpu_adam_s": cpu["adam_s"],
            "cpu_polish_s": cpu["polish_s"], "errors": errs,
            "nudged_errors": nudged,
            "bars": {k: limits[k] for k in held}}


def _walk_joints(torch, smpl_path, T):
    """The fabricated body's joints for a smooth seeded pose walk (the
    recovery study's generator): a motion the body can reach."""
    import numpy as np

    from mld_tpu_torch.models.smpl import SMPLLayer
    from mld_tpu_torch.scripts.fit_quality_study import synth_pose_sequence

    rot6d, trans = synth_pose_sequence(np.random.RandomState(SEED + 12), T)
    return SMPLLayer(smpl_path).joints(torch.from_numpy(rot6d),
                                       torch.from_numpy(trans)).numpy()


def output_fbx(npy, npz, ply_dir):
    """python -m mld_tpu_torch.scripts.fbx_export on a demo npy, its fit
    npz and its pkl tree; each file read back: bones and one key a frame."""
    import numpy as np

    from mld_tpu_torch.export import read_fbx
    from mld_tpu_torch.scripts import fbx_export

    written = fbx_export.main(["--npy", npy, "--npz", npz, "--pkl-dir",
                               ply_dir])
    frames = len(np.load(npy))
    out = []
    for path, bones in zip(written, (22, 24, 24)):
        _, roots = read_fbx(path)

        def find(nodes, name):
            return [m for n in nodes for m in
                    ([n] if n.name == name else []) + find(n.children, name)]

        models = len(find(roots, "Model"))
        keys = {len(n.props[0]) for n in find(roots, "KeyTime")}
        if models != bones or keys != {frames}:
            raise RuntimeError(f"{path}: {models} bones (expected {bones}), "
                               f"key counts {keys} (expected {frames})")
        out.append({"path": os.path.relpath(path, REPO),
                    "bytes": os.path.getsize(path), "bones": models})
        log(f"[output:fbx] {os.path.relpath(path, REPO)}: {models} bones, "
            f"{frames} keys a curve, {os.path.getsize(path)} bytes")
    return out


def phase_output(torch, smi):
    """The output path: the demo at full width in each task, the fit of
    every demo motion (mesh; ply and pkl on the shortest), one fit traced
    and held against the CPU, and FBX export read back."""
    import numpy as np

    from mld_tpu_torch import fit

    t0 = time.perf_counter()
    smpl_path = write_smpl_assets(OUTPUT_ROOT)
    cfgs = _output_cfgs(OUTPUT_ROOT)
    log(f"[output] fabricated assets in {time.perf_counter() - t0:.1f} s: "
        f"{os.path.relpath(smpl_path, REPO)} (V {OUTPUT_SMPL_V}, faces "
        f"{OUTPUT_SMPL_F}, seed {SEED}) and gmm_08.pkl ({OUTPUT_GMM_K} x 69)")
    out_dir = os.path.join(OUTPUT_ROOT, "demo")
    runs = {"demo": output_demo(torch, cfgs, out_dir)}

    # the first replication's six motions
    demo_dir = os.path.join(out_dir, "text_motion")
    files = runs["demo"]["text_motion"]["files"]
    files = files[: len(files) // OUTPUT_REPS]
    t0 = time.perf_counter()
    rows = fit.main(["--files", *files, "--smpl", smpl_path, "--mesh",
                     "--steps", str(OUTPUT_FIT_STEPS), "--device", DEVICE])
    fit_s = time.perf_counter() - t0
    if len(rows) != len(files):
        raise RuntimeError(f"fitted {len(rows)} of {len(files)} motions")
    for r in rows:
        stem = r["file"][: -len(".npy")]
        res = np.load(stem + "_fit.npz")
        mesh = np.load(stem + "_mesh.npy", mmap_mode="r")
        if (mesh.shape != (r["frames"], OUTPUT_SMPL_V, 3)
                or not all(np.isfinite(res[k]).all() for k in res.files)
                or not np.isfinite(r["mpjpe"])):
            raise RuntimeError(f"bad fit of {r['file']}: mesh {mesh.shape}")
        log(f"[output:fit] {os.path.basename(r['file'])}: {r['frames']} "
            f"frames, MPJPE {r['mpjpe']:.5f} m, adam {r['adam_s']:.3f} s, "
            f"polish {r['polish_s']:.3f} s, {r['ms_per_frame']:.2f} ms a "
            f"frame")
    log(f"[output:fit] {len(rows)} motions in {fit_s:.1f} s (mesh npys "
        f"written; the first fit includes the warm-up)")
    runs["fit_rows"] = rows

    shortest = min(rows, key=lambda r: r["frames"])["file"]
    t0 = time.perf_counter()
    fit.main(["--files", shortest, "--smpl", smpl_path, "--ply",
              "--steps", str(OUTPUT_FIT_STEPS), "--device", DEVICE])
    stem = os.path.basename(shortest)[: -len(".npy")]
    ply_dir = os.path.join(demo_dir, "results_smplfitting", "SMPLFit_" + stem)
    n_ply = len([f for f in os.listdir(ply_dir) if f.endswith(".ply")])
    if n_ply != len(np.load(shortest)):
        raise RuntimeError(f"{n_ply} plys for {shortest}")
    log(f"[output:fit] --ply {stem}: {n_ply} ply + pkl in "
        f"{time.perf_counter() - t0:.1f} s")

    longest = max(rows, key=lambda r: r["frames"])["file"]
    t0 = time.perf_counter()
    runs["reference_demo"] = output_fit_reference(
        torch, smpl_path, np.load(longest), os.path.basename(longest),
        bars=("loss_first", "mpjpe", "nudge"), trace=True)
    runs["reference_walk"] = output_fit_reference(
        torch, smpl_path, _walk_joints(torch, smpl_path, OUTPUT_WALK_FRAMES),
        f"pose walk {OUTPUT_WALK_FRAMES}",
        bars=("loss_first", "loss", "loss_last", "adam_iterate",
              "polished_joints", "mpjpe", "vertices"), trace=False)
    log(f"[output:fit] traced fit and CPU references in "
        f"{time.perf_counter() - t0:.1f} s")
    runs["fbx"] = output_fbx(shortest, shortest[: -len(".npy")] + "_fit.npz",
                             ply_dir)
    return runs


# --------------------------------------------- data parallelism and loader
# phase 13: the train CLI at phase 6's width and batch on phase 6's corpus,
# through the C++ loader and the data-parallel step (one rank here)
PAR_ROOT = os.path.join(TRAIN_ROOT, "parallel")
PAR_DEVICE = ["0"]                      # --device: the card's ordinal
PAR_STEPS = {"diffusion": 6, "vae_diffusion": 3}
# the one-rank group against no group: reducing over one rank changes
# nothing (bar of scale); two gloo ranks against one process: JAX's
# data-parallel bars (tests/test_parallel.py:69-75) on the loss and the
# updated parameters, and tests/test_torch_ddp.py's on the reduced
# gradients (of each leaf's largest |g|) and their norm. Adam's first step
# moves a weight by about lr = 1e-4, so the parameter bar alone cannot see
# a wrong reduction: the gradient bars can
PAR_WS1_RTOL = 1e-6
PAR_LOSS_RTOL = 2e-4
PAR_PARAM_ATOL = 2e-4
PAR_GRAD_RTOL = 1e-4
PAR_NORM_RTOL = 2e-4
PAR_MOTION_ATOL = 1e-5


def _par_over(name, stage, dropout=None, native=True, **train):
    model = dict(TRAIN_MODEL)
    if dropout is not None:
        model["dropout"] = dropout
    return {"name": name, "debug": True, "model": model,
            "dataset": {"root": os.path.join(TRAIN_ROOT, "humanml3d"),
                        "native_loader": native},
            "train": {"stage": stage, "batch_size": TRAIN_B, **train},
            "logger": {"folder": os.path.join(PAR_ROOT, "experiments"),
                       "save_checkpoint_epoch": 10 ** 6,
                       "val_every_epochs": 10 ** 6}}


def check_native_batches(torch):
    """The native collator's batches against the numpy collator's on one
    seed: lengths, masks, texts exactly, motion within 1e-5."""
    import numpy as np

    from mld_tpu_torch.config import load_config
    from mld_tpu_torch.data.datamodule import get_datamodule
    from mld_tpu_torch.native import batch_loader

    dms = {native: get_datamodule(load_config(preset="mld_humanml3d",
                                              overrides=_par_over(
                                                  "native_check", "vae",
                                                  native=native)))
           for native in (True, False)}
    if not dms[True].use_native or dms[False].use_native:
        raise RuntimeError(f"the native collator was not taken: "
                           f"{batch_loader.build_error()}")
    kw = dict(batch_size=TRAIN_B, seed=SEED, drop_last=True, prefetch=0)
    n, err = 0, 0.0
    for a, b in zip(dms[True].loader("train", **kw),
                    dms[False].loader("train", **kw), strict=True):
        if (a["text"] != b["text"]
                or not np.array_equal(a["length"], b["length"])
                or not np.array_equal(a["mask"], b["mask"])):
            raise RuntimeError("native and numpy batches differ")
        err = max(err, float(np.abs(a["motion"] - b["motion"]).max()))
        n += 1
    log(f"[parallel:loader] native collator (g++ library "
        f"{batch_loader.library_path().name}) vs numpy collator, {n} "
        f"batches of {TRAIN_B}, seed {SEED}: lengths, masks, texts equal; "
        f"motion max |diff| {err:.2e} (bar {PAR_MOTION_ATOL:g}); "
        f"use_native {dms[True].use_native}")
    if n == 0 or err > PAR_MOTION_ATOL:
        raise RuntimeError("the native batches disagree with numpy's")
    return {"batches": n, "motion_max_abs_err": err}


class _CliWatch:
    """Wraps the loop's train_step during a CLI run: each step's launches
    (checked against the config's count), its ms (synchronized before and
    after), the host gap from the previous step's return to its start,
    finite logs, and the params before the first step."""

    def __init__(self, torch, want):
        self.torch, self.want = torch, want
        self.ms, self.gap, self.logs, self.counts = [], [], [], None
        self.before = self.trainable = self.end = None

    def wrap(self, inner):
        torch = self.torch

        def step(state, *args, **kwargs):
            start = time.perf_counter()
            if self.end is not None:
                self.gap.append((start - self.end) * 1e3)
            if self.before is None:
                self.before = {k: p.detach().clone()
                               for k, p in state.mld.named_parameters()}
                self.trainable = set(state.params)
            _sync(torch)
            _reset_counts()
            t = time.perf_counter()
            logs = inner(state, *args, **kwargs)
            _sync(torch)
            self.ms.append((time.perf_counter() - t) * 1e3)
            self.counts = _read_counts()
            _check_counts(self.counts, self.want,
                          f"CLI training step {len(self.ms)}")
            vals = {k: float(v) for k, v in logs.items()}
            if not all(map(math.isfinite, vals.values())):
                raise RuntimeError(f"non-finite training logs {vals}")
            self.logs.append(vals)
            self.end = time.perf_counter()
            return logs

        return step


def run_cli(torch, smi, label, over, assets, steps):
    """python -m mld_tpu_torch.train's main() on --device PAR_DEVICE, the
    config and the --cfg_assets overlay written as files; checked and
    timed."""
    from mld_tpu_torch.config import load_config
    from mld_tpu_torch.train import __main__ as cli
    from mld_tpu_torch.train import loop

    os.makedirs(PAR_ROOT, exist_ok=True)
    cfg_path = os.path.join(PAR_ROOT, f"{label}.json")
    assets_path = os.path.join(PAR_ROOT, f"{label}_assets.json")
    with open(cfg_path, "w") as f:
        json.dump(over, f)      # JSON is YAML
    with open(assets_path, "w") as f:
        json.dump(assets, f)
    stage = over["train"]["stage"]
    cfg = load_config(cfg_path, assets, preset="mld_humanml3d")
    watch = _CliWatch(torch, _train_want(cfg, stage))
    inner = loop.train_step
    loop.train_step = watch.wrap(inner)
    t0 = time.perf_counter()
    try:
        mld = cli.main(["--cfg", cfg_path, "--cfg_assets", assets_path,
                        "--device", *PAR_DEVICE, "--max_steps", str(steps)])
    finally:
        loop.train_step = inner
    wall = time.perf_counter() - t0
    if mld is None or len(watch.ms) != steps:
        raise RuntimeError(f"{label}: the CLI ran {len(watch.ms)} of {steps} "
                           f"steps in this process")
    moved, n_train, n_frozen = _check_params(torch, label, watch, mld)
    kept = slice(1, None)       # steps 2 onwards
    step_ms = statistics.median(watch.ms[kept])
    gap_ms = statistics.median(watch.gap)
    log(f"[parallel:{label}] python -m mld_tpu_torch.train --device "
        f"{' '.join(PAR_DEVICE)} --cfg_assets ({', '.join(sorted(assets['train']))}"
        f"): {stage} B={TRAIN_B} dropout {cfg.model.dropout}, collator "
        f"{'native' if cfg.dataset.native_loader else 'numpy'}: {steps} steps;"
        f" launches a step {watch.counts}; train_step median {step_ms:.2f} "
        f"ms (steps 2-{steps}; all: "
        f"{', '.join(f'{v:.1f}' for v in watch.ms)}); host gap between "
        f"steps median {gap_ms:.2f} ms (all: "
        f"{', '.join(f'{v:.1f}' for v in watch.gap)}); trainable "
        f"{moved}/{n_train} tensors moved, {n_frozen} frozen unchanged; "
        f"total {watch.logs[0]['total']:.4f} -> {watch.logs[-1]['total']:.4f};"
        f" {wall:.1f} s with set-up; {smi}")
    return mld, {"launches": watch.counts, "step_median_ms": step_ms,
                 "step_ms": watch.ms, "gap_median_ms": gap_ms,
                 "gap_ms": watch.gap, "seconds": wall,
                 "collator": "native" if cfg.dataset.native_loader
                 else "numpy"}


def _step_of(torch, cfg, mean, std, batch, draws, shard=None):
    """One diffusion step from seeded weights on the batch's device:
    (logs, trainable params after it on the host, kernel launches, the
    reduced gradients on the host)."""
    from mld_tpu_torch.models.mld import MLD
    from mld_tpu_torch.train import steps

    mld = MLD(cfg, mean=mean, std=std, device=batch["motion"].device,
              generator=torch.Generator().manual_seed(SEED))
    state = steps.create_train_state(mld, "diffusion")
    _reset_counts()
    logs, grads = steps.compute_grads(state, batch, None, draws, shard)
    grads = {k: g.detach().cpu() for k, g in grads.items()}
    steps.apply_grads(state, logs["grad_norm"])
    if batch["motion"].is_cuda:
        torch.cuda.synchronize()
    counts = _read_counts()
    out = ({k: float(v) for k, v in logs.items()},
           {k: p.detach().cpu() for k, p in state.params.items()}, counts,
           grads)
    del mld, state
    return out


def _par_errs(a, b):
    """a's step against b's (each as _step_of returns it): the loss's and
    the gradient norm's relative errors; the worst updated parameter's
    |diff| and that over the parameter's scale; the worst reduced
    gradient's |diff| over its leaf's largest |g|."""
    def rel_err(key):
        return abs(a[0][key] - b[0][key]) / max(abs(b[0][key]), 1e-12)

    diff = max(float((a[1][k] - p).abs().max()) for k, p in b[1].items())
    rel = max(float((a[1][k] - p).abs().max())
              / max(float(p.abs().max()), 1e-12) for k, p in b[1].items())
    grad = max(float((a[3][k] - g).abs().max())
               / max(float(g.abs().max()), 1e-6) for k, g in b[3].items())
    return {"loss": rel_err("total"), "grad_norm": rel_err("grad_norm"),
            "param": diff, "param_rel": rel, "grad": grad}


def _gloo_rank(inputs_path, device):
    """A rank of the two-rank gloo check (spawned): one diffusion step on
    its rows of the saved global batch and draws; saves its logs and
    trainable params."""
    import torch

    from mld_tpu_torch.config import load_config
    from mld_tpu_torch.parallel import ddp
    from mld_tpu_torch.train.steps import batch_to_device

    inp = torch.load(inputs_path, weights_only=False)
    cfg = load_config(preset="mld_humanml3d", overrides=inp["over"])
    rank, world = ddp.rank(), ddp.world_size()
    batch = ddp.pad_batch_to_ranks(inp["batch"], world)
    shard = ddp.RowShard.of(batch, rank, world)
    local = batch_to_device(ddp.shard_rows(batch, rank, world), device)
    logs, params, counts, grads = _step_of(
        torch, cfg, inp["mean"], inp["std"], local, inp["draws"], shard)
    torch.save({"logs": logs, "params": params, "counts": counts,
                "grads": grads, "shard": (shard.start, shard.stop)},
               os.path.join(os.path.dirname(inputs_path), f"rank{rank}.pt"))


def check_parallel_steps(torch):
    """One B=TRAIN_B diffusion step, dropout 0, on one batch and one set of
    draws: with no process group; through the data-parallel path in a group
    of one (NCCL on the card); and over two gloo ranks on the one card
    (NCCL refuses two ranks on one device)."""
    from mld_tpu_torch.config import load_config
    from mld_tpu_torch.data.datamodule import get_datamodule
    from mld_tpu_torch.models.clip_text import ClipTokenizer
    from mld_tpu_torch.parallel import ddp
    from mld_tpu_torch.train.steps import batch_to_device

    over = _par_over("parallel_step", "diffusion", dropout=0.0)
    cfg = load_config(preset="mld_humanml3d", overrides=over)
    dm = get_datamodule(cfg, tokenizer=ClipTokenizer(cfg.model.clip_path))
    host = next(iter(dm.loader("train", batch_size=TRAIN_B, prefetch=0,
                               drop_last=True)))
    host = {k: host[k] for k in ("motion", "mask", "text_ids")}
    batch = batch_to_device(host, DEVICE)
    draws = _diffusion_draws(torch, cfg, TRAIN_B, SEED + 13)
    want = _train_want(cfg, "diffusion")
    single = _step_of(torch, cfg, dm.mean, dm.std, batch, draws)
    _check_counts(single[2], want, "the single-process step")

    ddp.init(0, 1, DEVICE)
    try:
        backend = torch.distributed.get_backend()
        one = _step_of(torch, cfg, dm.mean, dm.std, batch, draws,
                       ddp.RowShard.whole(batch))
    finally:
        ddp.teardown()
    _check_counts(one[2], want, "the one-rank data-parallel step")
    e1 = _par_errs(one, single)
    log(f"[parallel:ws1] diffusion step B={TRAIN_B} dropout 0 through the "
        f"data-parallel path in a {backend} group of one vs no group: "
        f"launches {one[2]}; loss {one[0]['total']:.6f} vs "
        f"{single[0]['total']:.6f} (rel err {e1['loss']:.2e}), grad_norm "
        f"rel err {e1['grad_norm']:.2e}, reduced grads worst leaf "
        f"{e1['grad']:.2e} of its largest |g|, updated params max |diff| "
        f"{e1['param']:.2e} (worst leaf {e1['param_rel']:.2e} of its "
        f"scale); bar {PAR_WS1_RTOL:g} on each")
    if max(e1["loss"], e1["grad_norm"], e1["grad"],
           e1["param_rel"]) > PAR_WS1_RTOL:
        raise RuntimeError("reducing over one rank changed the step")

    d = os.path.join(PAR_ROOT, "gloo")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "inputs.pt")
    torch.save({"over": over, "mean": dm.mean, "std": dm.std,
                "batch": host, "draws": {k: v.cpu() for k, v in
                                         draws.items()}}, path)
    t0 = time.perf_counter()
    ddp.spawn(_gloo_rank, [DEVICE] * 2, path, backend="gloo")
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)
             for r in range(2)]
    same = all(torch.equal(p, ranks[1]["params"][k])
               for k, p in ranks[0]["params"].items())
    e2 = _par_errs((ranks[0]["logs"], ranks[0]["params"], None,
                    ranks[0]["grads"]), single)
    log(f"[parallel:gloo] two gloo ranks on the one card (rows "
        f"{ranks[0]['shard']}, {ranks[1]['shard']}), one diffusion step "
        f"B={TRAIN_B} dropout 0 vs the single-process step: launches a rank "
        f"{ranks[0]['counts']}; loss {ranks[0]['logs']['total']:.6f} vs "
        f"{single[0]['total']:.6f} (rel err {e2['loss']:.2e}, bar "
        f"{PAR_LOSS_RTOL:g}), grad_norm rel err {e2['grad_norm']:.2e} (bar "
        f"{PAR_NORM_RTOL:g}), reduced grads worst leaf {e2['grad']:.2e} of "
        f"its largest |g| (bar {PAR_GRAD_RTOL:g}), updated params max "
        f"|diff| {e2['param']:.2e} (bar {PAR_PARAM_ATOL:g}); the ranks' "
        f"params {'bit-identical' if same else 'DIFFER'}; {spawn_s:.1f} s "
        f"with the ranks' start")
    if (not same or e2["loss"] > PAR_LOSS_RTOL
            or e2["grad_norm"] > PAR_NORM_RTOL or e2["grad"] > PAR_GRAD_RTOL
            or e2["param"] > PAR_PARAM_ATOL):
        raise RuntimeError("the two-rank step disagrees with one process")
    return {"ws1": {"backend": backend, **e1},
            "gloo2": {**e2, "ranks_identical": same, "seconds": spawn_s}}


def phase_parallel(torch, smi):
    """The training path's input pipeline and data parallelism: the native
    batches against numpy's, the train CLI on the card (diffusion with
    phase 6's VAE handed over by --cfg_assets, with the numpy collator,
    then the native one; vae_diffusion from the native run), then the
    one-rank and two-rank steps against one process."""
    import shutil

    shutil.rmtree(PAR_ROOT, ignore_errors=True)
    runs = {"loader": check_native_batches(torch)}
    from mld_tpu_torch.utils.checkpoint import CheckpointManager

    vae_dir = os.path.join(TRAIN_ROOT, "experiments", "mld", "smoke_vae",
                           "checkpoints")
    handed = CheckpointManager(vae_dir).restore(map_location=DEVICE)
    # the numpy collator's run first, the native one's second (an earlier
    # run had them the other way round: the first CLI run's steps were the
    # slower)
    for label, native in (("diffusion_numpy", False), ("diffusion", True)):
        mld, runs[label] = run_cli(
            torch, smi, label,
            _par_over(f"par_{label}", "diffusion", dropout=0.1,
                      native=native),
            {"train": {"pretrained_vae": vae_dir}}, PAR_STEPS["diffusion"])
        for k, p in mld.vae.named_parameters():
            if not torch.equal(p, handed["state_dict"]["vae." + k]):
                raise RuntimeError(f"the CLI's VAE is not the handed-over "
                                   f"one: vae.{k}")
        del mld
        torch.cuda.empty_cache()
    del handed
    diff_dir = os.path.join(PAR_ROOT, "experiments", "mld", "par_diffusion",
                            "checkpoints")
    mld, runs["vae_diffusion"] = run_cli(
        torch, smi, "vae_diffusion",
        _par_over("par_vae_diffusion", "vae_diffusion", dropout=0.1),
        {"train": {"pretrained": diff_dir}}, PAR_STEPS["vae_diffusion"])
    del mld
    torch.cuda.empty_cache()
    nat, num = runs["diffusion"], runs["diffusion_numpy"]
    log(f"[parallel:loader] host gap between diffusion steps (median of "
        f"steps 2-{PAR_STEPS['diffusion']}; {runs['loader']['batches']} "
        f"batch(es) an epoch): native collator {nat['gap_median_ms']:.2f} ms, numpy "
        f"collator {num['gap_median_ms']:.2f} ms; train_step "
        f"{nat['step_median_ms']:.2f} vs {num['step_median_ms']:.2f} ms; "
        f"recorded, not claimed; {smi}")
    runs["steps"] = check_parallel_steps(torch)
    return runs


# -------------------------------- 14. released-checkpoint path and the tools
TOOLS_ROOT = os.path.join(REPO, "build", "tools_smoke")
# the drill's cuts: 1 replication of the protocol's 20, no MultiModality
DRILL_ARGV = ("--replications", "1", "--no-mm")
# model and eval overrides (none: the preset's full width and the
# protocol's constants); a CPU rehearsal sets small ones
TOOLS_MODEL = {}
TOOLS_EVAL = {}
# flops: the batches counted on the card and on the CPU
FLOPS_BATCHES = (1, B_LARGE)
FLOPS_RTOL = 1e-6
TSNE_TEXTS = ("a person walks forward", "a person jumps",
              "someone sits down", "a person waves")
# the ablation's cuts: steps {10, 50} of {5, 10, 20, 50, 100}, 3 timed
# iterations of 10
ABLATION_STEPS = (10, 50)
ABLATION_BATCH = B_LARGE
ABLATION_ITERS = 3
# the model axis: B=64 diffusion steps at full width over two gloo ranks
# on the one card (1 data x 2 model), dropout 0 against one process and
# 0.1 for the residual stream across the model ranks; phase 13's bars
AXIS_B = TRAIN_B
AXIS_DROPOUT = 0.1
AXIS_ROOT = os.path.join(TOOLS_ROOT, "model_axis")
AXIS_FLASH_CASE = ("model-axis denoiser self", AXIS_B, 2, 3, 3, 64, None)


def _ckpt_state(torch, path):
    """The state dict of a fabricated reference checkpoint (its pickled
    hyper-parameter is an argparse.Namespace)."""
    import argparse
    with torch.serialization.safe_globals([argparse.Namespace]):
        return torch.load(path, map_location="cpu",
                          weights_only=True)["state_dict"]


def _tools_cfg(**model):
    from mld_tpu_torch.config import load_config

    return load_config(preset="mld_humanml3d", overrides={
        "model": {**TOOLS_MODEL, **model}})


def _f32_tower(cfg):
    from mld_tpu_torch.config.core import (config_from_dict, config_to_dict,
                                           merge_dicts)
    return config_from_dict(merge_dicts(
        config_to_dict(cfg), {"model": {"clip_compute_dtype": "float32"}}))


def tools_drill(torch, smi):
    """python -m mld_tpu_torch.scripts.parity_drill on fabricated assets at
    full width (phase 7's trained evaluators as finest.tar, its corpus as
    the dataset), with its launches, the converted weights against the
    file's, the hydrated tower on the card against the CPU, and AITS."""
    from mld_tpu_torch.models.clip_text import (ClipTextModel,
                                                load_hf_clip_weights)
    from mld_tpu_torch.scripts import drill_assets, parity_drill
    from mld_tpu_torch.utils.checkpoint import load_params_npz

    root = os.path.join(TOOLS_ROOT, "drill")
    t0 = time.perf_counter()
    paths = parity_drill.asset_paths(root)
    yml = None
    if TOOLS_MODEL or TOOLS_EVAL:
        # a rehearsal's overrides, given to the drill as --cfg
        import yaml
        os.makedirs(root, exist_ok=True)
        yml = os.path.join(root, "model.yaml")
        with open(yml, "w") as f:
            yaml.safe_dump({"model": TOOLS_MODEL, "eval": TOOLS_EVAL}, f)
    cfg = parity_drill.drill_config(root, paths, 1, yml)
    drill_assets.fabricate(
        root, cfg, seed=SEED,
        t2m_params=load_params_npz(os.path.join(EVAL_ROOT,
                                                "t2m_trained.npz")),
        corpus=os.path.join(EVAL_ROOT, "humanml3d"))
    fab_s = time.perf_counter() - t0
    out = os.path.join(root, "drill_report.json")
    argv = ["--assets-root", root, *DRILL_ARGV, "--out", out,
            "--device", DEVICE] + (["--cfg", yml] if yml else [])
    _reset_counts()
    t0 = time.perf_counter()
    code, report, built = parity_drill.run(parity_drill.parse_args(argv))
    _sync(torch)
    drill_s = time.perf_counter() - t0
    counts = _read_counts()
    steps = {s["step"]: s["ok"] for s in report["steps"]}
    if code != 1 or not report["verdict"].startswith("fail:") \
            or not all(steps.values()):
        raise RuntimeError(f"the drill on random weights: exit {code}, "
                           f"steps {steps}, verdict {report['verdict']}")
    mld, ev = built["mld"], built["evaluator"]
    batches = len(ev.times["main"])
    calls = batches + parity_drill.AITS_ITERS + 1
    per_call = _eval_want(mld.cfg)
    want = {k: v * calls for k, v in per_call.items()}
    _check_counts(counts, want, f"the drill ({batches} evaluated batches "
                  f"and {parity_drill.AITS_ITERS + 1} AITS calls)")
    # the converted weights are the file's
    state = _ckpt_state(torch, paths["ckpt"])
    own = mld.state_dict()
    n_conv = 0
    for k, v in own.items():
        if k.startswith(("vae.", "denoiser.")):
            if not torch.equal(v.cpu(), state[k]):
                raise RuntimeError(f"the drill's {k} is not the file's")
            n_conv += 1
    # the hydrated tower on the card against the file's tower on the CPU,
    # both computing in f32
    ids = mld.tokenize(list(TSNE_TEXTS))
    mld.clip.compute_dtype = torch.float32
    with torch.no_grad():
        card = mld.clip(ids, mode="features").cpu()
        m = mld.cfg.model
        cpu_tower = ClipTextModel(width=m.text_encoded_dim,
                                  layers=m.clip_layers, heads=m.clip_heads,
                                  projection_dim=m.text_encoded_dim)
        load_hf_clip_weights(paths["clip"], tower=cpu_tower)
        ref = cpu_tower(ids.cpu(), mode="features")
    scale = ref.abs().max().item()
    tower_err = (card - ref).abs().max().item()
    log(f"[tools:drill] fabricated assets ({fab_s:.1f} s, host) -> "
        f"parity_drill {' '.join(DRILL_ARGV)} on {DEVICE}: exit {code}, "
        f"steps {steps}, verdict '{report['verdict']}' (random weights "
        f"fail, as they must); {batches} evaluated batches + "
        f"{parity_drill.AITS_ITERS + 1} AITS calls, launches {counts} = "
        f"{calls} x {per_call}; {n_conv} converted tensors bit-equal to the "
        f"file's; the hydrated tower's features on the card vs the CPU "
        f"(f32): max_abs_err {tower_err:.3e} (scale {scale:.3e}, bar "
        f"{E2E_RTOL:g} x max(scale, 1)); {drill_s:.1f} s; {smi}")
    if not tower_err <= E2E_RTOL * max(scale, 1.0):
        raise RuntimeError("the hydrated tower on the card disagrees with "
                           "the CPU")
    aits = report["aits_sec"]
    log(f"[tools:drill] AITS {aits * 1e3:.2f} ms a motion (B=1, "
        f"DDIM-{mld.cfg.model.scheduler.num_inference_timesteps}, "
        f"mean of {parity_drill.AITS_ITERS} calls after a warm one), "
        f"{parity_drill.PAPER_AITS / aits:.1f}x the paper's 0.217 s on a "
        f"V100 (recorded, not claimed); {smi}")
    results = {k: v for k, v in report["results"].items()
               if not k.endswith("conf95")}
    _finite_metrics("the drill", results)
    del mld, ev, built
    torch.cuda.empty_cache()
    return {"launches": counts, "calls": calls, "batches": batches,
            "aits_ms": aits * 1e3, "tower_err": tower_err,
            "seconds": drill_s, "verdict": report["verdict"]}


def tools_converter(torch):
    """python -m mld_tpu_torch.scripts.convert_checkpoint at full width: its
    npz reloads through load_pretrained bit for bit."""
    from mld_tpu_torch.models.mld import MLD
    from mld_tpu_torch.scripts import convert_checkpoint, parity_drill
    from mld_tpu_torch.utils.checkpoint import load_pretrained

    root = os.path.join(TOOLS_ROOT, "drill")
    ckpt = parity_drill.asset_paths(root)["ckpt"]
    npz = os.path.join(TOOLS_ROOT, "converted_params.npz")
    t0 = time.perf_counter()
    argv = ["--ckpt", ckpt, "--out", npz, "--device", DEVICE]
    if TOOLS_MODEL or TOOLS_EVAL:
        argv += ["--cfg", os.path.join(root, "model.yaml")]
    tops = convert_checkpoint.main(argv)
    conv_s = time.perf_counter() - t0
    state = _ckpt_state(torch, ckpt)
    fresh = MLD(_tools_cfg(), device=DEVICE,
                generator=torch.Generator().manual_seed(SEED + 9))
    loaded = load_pretrained(fresh, npz)
    n = 0
    for k, v in fresh.state_dict().items():
        if k.startswith(("vae.", "denoiser.")):
            if not torch.equal(v.cpu(), state[k]):
                raise RuntimeError(f"the converted npz's {k} is not the "
                                   f"checkpoint's")
            n += 1
    log(f"[tools:convert] {tops} -> {os.path.getsize(npz) / 2 ** 20:.1f} MiB "
        f"npz in {conv_s:.1f} s; reloaded {sorted(loaded)} through "
        f"load_pretrained: {n} tensors bit-equal to the checkpoint's")
    del fresh
    return {"tensors": n, "seconds": conv_s}


def tools_flops(torch):
    """python -m mld_tpu_torch.scripts.flops at full width on the card
    (kernel counters + FlopCounterMode) and the same stages on the CPU
    (plain versions, counted by the mode; K1's plain version, an f32
    tower: the count does not depend on the dtype), at FLOPS_BATCHES."""
    from mld_tpu_torch.models.mld import MLD
    from mld_tpu_torch.scripts import flops

    cfg32 = _f32_tower(_tools_cfg())
    reports = {}
    for dev in (DEVICE, "cpu"):
        mld = MLD(cfg32 if dev == "cpu" else _tools_cfg(), device=dev,
                  fused_denoiser=True,
                  generator=torch.Generator().manual_seed(SEED))
        for B in FLOPS_BATCHES:
            t0 = time.perf_counter()
            reports[(dev, B)] = flops.analyze(mld, B, T_FRAMES)
            reports[(dev, B)]["seconds"] = time.perf_counter() - t0
        del mld
    out = {}
    for B in FLOPS_BATCHES:
        card, cpu = reports[(DEVICE, B)], reports[("cpu", B)]
        errs = {}
        for k, v in card.items():
            if isinstance(v, dict) and "flops" in v:
                ref = cpu[k]["flops"]
                errs[k] = abs(v["flops"] - ref) / max(ref, 1.0)
        parts = card["generate_parts"]
        ident = abs(parts["whole"] - (
            parts["text_condition"] + parts["sampler_preamble"]
            + parts["steps"] * parts["sampler_step"] + parts["vae_decode"])
        ) / parts["whole"]
        gflop = card["generate_feats"]["flops"] / B / 1e9
        log(f"[tools:flops] B={B}: generate_feats "
            f"{card['generate_feats']['flops']:.4e} FLOP ({gflop:.3f} GFLOP "
            f"a motion; text {parts['text_condition']:.3e} + preamble "
            f"{parts['sampler_preamble']:.3e} + {parts['steps']} x step "
            f"{parts['sampler_step']:.3e} + decode {parts['vae_decode']:.3e}"
            f", identity rel err {ident:.1e}), denoiser_step "
            f"{card['denoiser_step']['flops']:.4e}, vae_encode "
            f"{card['vae_encode']['flops']:.4e}, vae_decode "
            f"{card['vae_decode']['flops']:.4e}, clip_text "
            f"{card['clip_text']['flops']:.4e}, params "
            f"{card['param_count']}; card (kernel counters + aten) vs CPU "
            f"(plain versions) worst rel err {max(errs.values()):.1e} (bar "
            f"{FLOPS_RTOL:g}); {card['seconds']:.1f} s card, "
            f"{cpu['seconds']:.1f} s CPU")
        if max(errs.values()) > FLOPS_RTOL or ident > FLOPS_RTOL:
            raise RuntimeError(f"flops at B={B}: card vs CPU {errs}, "
                               f"identity {ident}")
        out[B] = {"gflop_a_motion": gflop, "errs": errs,
                  **{k: v["flops"] for k, v in card.items()
                     if isinstance(v, dict) and "flops" in v}}
    return out


def tools_tsne(torch, smi):
    """The latent trajectories at full width, 4 prompts, DDIM-50, PCA: the
    last latent on the card against the CPU (K1's plain version, f32 towers
    on both), the launches, and the plot (or the embedding where matplotlib
    is missing)."""
    import numpy as np

    from mld_tpu_torch.models.mld import MLD
    from mld_tpu_torch.scripts import tsne

    cfg32 = _f32_tower(_tools_cfg())
    init = None
    traj = {}
    for dev in (DEVICE, "cpu"):
        mld = MLD(cfg32, device=dev, fused_denoiser=True,
                  generator=torch.Generator().manual_seed(SEED))
        if init is None:
            init = torch.randn(len(TSNE_TEXTS), mld.latent_size,
                               mld.latent_dim,
                               generator=torch.Generator().manual_seed(
                                   SEED + 21))
        _reset_counts()
        t0 = time.perf_counter()
        cond = tsne.full_context_condition(mld, TSNE_TEXTS)
        traj[dev] = tsne.diffusion_reverse_trajectory(
            mld, cond, init_latents=init).cpu()
        if dev == DEVICE:
            _sync(torch)
            secs = time.perf_counter() - t0
            counts = _read_counts()
            n_steps = len(mld.scheduler.timesteps())
        del mld
    m = cfg32.model
    # the condition's one tower call (uncond rows and prompts together)
    want = {"skip_encoder": n_steps, "skip_decoder": 0,
            "skip_decoder_kernels": 0, "flash_causal": m.clip_layers,
            "flash_attention": 0}
    _check_counts(counts, want, "the trajectory")
    last, ref = traj[DEVICE][-1], traj["cpu"][-1]
    scale = ref.abs().max().item()
    err = (last - ref).abs().max().item()
    emb = tsne.embed(traj[DEVICE].numpy(), "pca")
    try:
        import matplotlib  # noqa: F401
        path = os.path.join(TOOLS_ROOT, "tsne_latents.png")
        tsne.plot(emb, TSNE_TEXTS, "pca", path)
        drawn = "drew"
    except ImportError:
        path = os.path.join(TOOLS_ROOT, "tsne_latents.npy")
        np.save(path, emb)
        drawn = "wrote"
        log(f"[tools:tsne] matplotlib is not installed: wrote the "
            f"embedding {emb.shape} as {os.path.relpath(path, REPO)} "
            f"instead of the plot")
    log(f"[tools:tsne] {len(TSNE_TEXTS)} prompts, DDIM-{n_steps}: "
        f"trajectory {tuple(traj[DEVICE].shape)} in {secs:.3f} s, launches "
        f"{counts}; last latent card vs CPU max_abs_err {err:.3e} (scale "
        f"{scale:.3e}, bar {E2E_RTOL:g} x max(scale, 1)); {drawn} "
        f"{os.path.relpath(path, REPO)}; {smi}")
    if not (np.isfinite(emb).all() and err <= E2E_RTOL * max(scale, 1.0)):
        raise RuntimeError("the trajectory on the card disagrees with the "
                           "CPU")
    return {"launches": counts, "err": err, "seconds": secs}


def tools_ablation(torch, smi):
    """python -m mld_tpu_torch.scripts.ablate_ddim_steps on phase 11's
    trained workdir at ABLATION_STEPS: each arm's metrics and motions/s,
    and K1's launches a generate call equal to its step count."""
    from mld_tpu_torch.scripts import ablate_ddim_steps as abl

    runs = {}
    for n_steps in ABLATION_STEPS:
        _reset_counts()
        t0 = time.perf_counter()
        arm = abl.run_arm(E2E_ROOT, n_steps, 2.5, torch.device(DEVICE),
                          ABLATION_BATCH, ABLATION_ITERS)
        secs = time.perf_counter() - t0
        counts = _read_counts()
        cfg = abl.arm_config(E2E_ROOT, n_steps, 2.5)
        calls = counts["flash_causal"] // (2 * cfg.model.clip_layers)
        if counts["skip_encoder"] != calls * n_steps or calls < 1 \
                + ABLATION_ITERS + 1:
            raise RuntimeError(f"the ablation's arm {n_steps}: launches "
                               f"{counts} for {calls} generate calls")
        _finite_metrics(f"the ablation's arm {n_steps}",
                        {k: v for k, v in arm.items()})
        runs[n_steps] = {**arm, "launches": counts, "calls": calls,
                         "seconds": secs}
        log(f"[tools:ablation] DDIM-{n_steps}: FID {arm['FID']:.3f}, R@1 "
            f"{arm['R_precision_top_1']:.3f}, {arm['motions_per_sec']:.1f} "
            f"motions/s at B={ABLATION_BATCH} ({arm['aits_ms']:.4f} ms a "
            f"motion, {ABLATION_ITERS} timed calls); {calls} generate calls"
            f", K1 {n_steps} a call; {secs:.1f} s; recorded, not claimed; "
            f"{smi}")
    return runs


def _axis_rank(inputs_path, device):
    """A rank of the model-axis check (spawned): the diffusion steps of the
    saved batch and draws on a denoiser split over a model axis of the two
    ranks; saves rank 0's logs, whole gradients and parameters, launches,
    and each rank's residual stream under dropout."""
    import torch

    from mld_tpu_torch.config import load_config
    from mld_tpu_torch.models.mld import MLD
    from mld_tpu_torch.parallel import ddp, partition
    from mld_tpu_torch.train import steps

    inp = torch.load(inputs_path, weights_only=False)
    axis = partition.make_groups(1, 2)
    out = {}
    for name, over in inp["over"].items():
        cfg = load_config(preset="mld_humanml3d", overrides=over)
        mld = MLD(cfg, mean=inp["mean"], std=inp["std"], device=device,
                  generator=torch.Generator().manual_seed(SEED))
        partition.shard_params(mld, axis)
        state = steps.create_train_state(mld, "diffusion")
        kinds = {k: getattr(p, "model_shard", None)
                 for k, p in state.params.items()}
        batch = steps.batch_to_device(inp["batch"], device)
        dropout = (partition.axis_generators(SEED + 31, axis, device)
                   if cfg.model.dropout > 0 else None)
        shard = ddp.RowShard.of(ddp.pad_batch_to_ranks(inp["batch"], 1), 0,
                                1, dropout)
        acts = []
        enc = mld.denoiser.encoder
        hooks = [layer.register_forward_hook(
            lambda _m, _i, o: acts.append(o.detach().cpu()))
            for layer in (list(enc.input_blocks) + [enc.middle_block]
                          + list(enc.output_blocks))]
        _reset_counts()
        logs, grads = steps.compute_grads(state, batch, None, inp["draws"],
                                          shard)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        counts = _read_counts()
        for h in hooks:
            h.remove()
        grads = partition.whole_state(grads, kinds, axis)
        steps.apply_grads(state, logs["grad_norm"])
        params = partition.whole_state(
            {k: p.detach() for k, p in state.params.items()}, kinds, axis)
        out[name] = {"logs": {k: float(v) for k, v in logs.items()},
                     "grads": grads, "params": params, "counts": counts,
                     "acts": acts, "kinds": kinds}
        del mld, state
    torch.save(out, os.path.join(os.path.dirname(inputs_path),
                                 f"rank{ddp.rank()}.pt"))


def tools_model_axis(torch, smi):
    """One B=AXIS_B diffusion step at full width with the denoiser split
    over a model axis of two gloo ranks on the one card, dropout 0, against
    the single-process step (phase 13's _step_of, the same batch and
    draws); then dropout AXIS_DROPOUT: the residual stream bit-identical on
    both model ranks; and K3 at a rank's shape against its plain
    version."""
    from mld_tpu_torch.config import load_config
    from mld_tpu_torch.data.datamodule import get_datamodule
    from mld_tpu_torch.models.clip_text import ClipTokenizer
    from mld_tpu_torch.parallel import ddp
    from mld_tpu_torch.train.steps import batch_to_device

    over = {name: _par_over(f"axis_{name}", "diffusion", dropout=d)
            for name, d in (("plain", 0.0), ("dropout", AXIS_DROPOUT))}
    cfg = load_config(preset="mld_humanml3d", overrides=over["plain"])
    dm = get_datamodule(cfg, tokenizer=ClipTokenizer(cfg.model.clip_path))
    host = next(iter(dm.loader("train", batch_size=AXIS_B, prefetch=0,
                               drop_last=True)))
    host = {k: host[k] for k in ("motion", "mask", "text_ids")}
    draws = _diffusion_draws(torch, cfg, AXIS_B, SEED + 17)
    single = _step_of(torch, cfg, dm.mean, dm.std,
                      batch_to_device(host, DEVICE), draws)
    want = _train_want(cfg, "diffusion")
    _check_counts(single[2], want, "the single-process step")

    os.makedirs(AXIS_ROOT, exist_ok=True)
    path = os.path.join(AXIS_ROOT, "inputs.pt")
    torch.save({"over": over, "mean": dm.mean, "std": dm.std, "batch": host,
                "draws": {k: v.cpu() for k, v in draws.items()}}, path)
    t0 = time.perf_counter()
    ddp.spawn(_axis_rank, [DEVICE] * 2, path, backend="gloo")
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(AXIS_ROOT, f"rank{r}.pt"),
                        weights_only=False) for r in range(2)]
    r0 = ranks[0]["plain"]
    _check_counts(r0["counts"], want, "a model-axis rank's step")
    e = _par_errs((r0["logs"], r0["params"], None, r0["grads"]), single)
    same = all(torch.equal(p, ranks[1]["plain"]["params"][k])
               for k, p in r0["params"].items())
    split = sum(1 for v in r0["kinds"].values() if v)
    log(f"[tools:axis] model axis of 2 gloo ranks on the one card "
        f"({split} of {len(r0['kinds'])} trainable leaves split: QKV by "
        f"heads, FFN, out projections), one diffusion step B={AXIS_B} "
        f"dropout 0 vs the single-process step: launches a rank "
        f"{r0['counts']}; loss {r0['logs']['total']:.6f} vs "
        f"{single[0]['total']:.6f} (rel err {e['loss']:.2e}, bar "
        f"{PAR_LOSS_RTOL:g}), grad_norm rel err {e['grad_norm']:.2e} (bar "
        f"{PAR_NORM_RTOL:g}), reassembled grads worst leaf {e['grad']:.2e} "
        f"of its largest |g| (bar {PAR_GRAD_RTOL:g}), updated params max "
        f"|diff| {e['param']:.2e} (bar {PAR_PARAM_ATOL:g}); the ranks' "
        f"reassembled params {'bit-identical' if same else 'DIFFER'}; "
        f"{spawn_s:.1f} s with the ranks' start")
    if (not same or e["loss"] > PAR_LOSS_RTOL
            or e["grad_norm"] > PAR_NORM_RTOL or e["grad"] > PAR_GRAD_RTOL
            or e["param"] > PAR_PARAM_ATOL):
        raise RuntimeError("the model-axis step disagrees with one process")
    a, b = ranks[0]["dropout"]["acts"], ranks[1]["dropout"]["acts"]
    stream_same = len(a) == len(b) > 0 and all(
        torch.equal(x, y) for x, y in zip(a, b))
    moved = ranks[0]["dropout"]["logs"]["total"] != r0["logs"]["total"]
    log(f"[tools:axis] dropout {AXIS_DROPOUT}: the residual stream (the "
        f"{len(a)} encoder layers' outputs) "
        f"{'bit-identical' if stream_same else 'DIFFERS'} on the two model "
        f"ranks; loss {ranks[0]['dropout']['logs']['total']:.6f} (dropout "
        f"{'moved' if moved else 'did not move'} it)")
    if not (stream_same and moved):
        raise RuntimeError("the residual stream parts across the model "
                           "ranks under dropout")
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 23)
    with torch.no_grad():
        flash = check_flash(torch, None, g, cases=(AXIS_FLASH_CASE,))
    return {"errs": e, "counts": r0["counts"], "seconds": spawn_s,
            "flash": flash}


def phase_tools(torch, smi):
    """The released-checkpoint path and the user scripts: the drill, the
    converter, the operation counts, the trajectories, the DDIM ablation
    and the model axis."""
    import shutil

    shutil.rmtree(TOOLS_ROOT, ignore_errors=True)
    os.makedirs(TOOLS_ROOT)
    runs = {}
    for name, fn in (("drill", lambda: tools_drill(torch, smi)),
                     ("convert", lambda: tools_converter(torch)),
                     ("flops", lambda: tools_flops(torch)),
                     ("tsne", lambda: tools_tsne(torch, smi)),
                     ("ablation", lambda: tools_ablation(torch, smi)),
                     ("axis", lambda: tools_model_axis(torch, smi))):
        t0 = time.perf_counter()
        runs[name] = fn()
        torch.cuda.empty_cache()
        log(f"[time] tools {name}: {time.perf_counter() - t0:.1f} s")
    return runs


def kernels_line(kr, runs, raw_runs, prompt_len, train_runs, eval_runs,
                 a2m_runs, mode_runs, option_runs, e2e_runs, output_runs,
                 parallel_runs, tools_runs):
    counts = runs["kernels"]["counts"]
    e2e_k = e2e_runs["kernels"]
    e2e_eval_b = _e2e_cfg().eval.batch_size
    layer_res, layer_rounding = kr["encoder_layer"]
    dec_res, dec_rounding, dec_traced = kr["skip_decoder"]
    axis_k = tools_runs["axis"]["flash"]

    def worst(results, dtype):
        return max(v["err"] for k, v in results.items() if k[0] == dtype)

    def arm(r, prefix=""):
        b = r["bound"]
        out = {"ms": r["ms"], "device_ms": r["device_ms"],
               "plain_ms": r["plain_ms"], "bound_ms": b["bound_ms"],
               "bound_by": b["bound_by"], "bound_peak": b["bound_peak"],
               "library_ms": r["library_ms"],
               "library_device_ms": r["library_device_ms"]}
        if "library_kernels" in r:
            out["library_kernels"] = r["library_kernels"]
        return {prefix + k: v for k, v in out.items()}

    def entry(name, source, replaces, launches, results, key, key16,
              **extra):
        # read at each stage's last checked step; K2 shares K1's counter,
        # so nothing in the run counts it apart
        train = {stage: (r["launches"][name] if name != "encoder_layer"
                         else None)
                 for stage, r in train_runs.items() if "launches" in r}
        # the evaluation protocol's main and MultiModality batches alike
        evals = (eval_runs["launches_a_batch"][name]
                 if name != "encoder_layer" else None)
        # phase 8: a generate_action call, an evaluated a2m batch by stage
        a2m = a2m_evals = a2m_train = None
        if name != "encoder_layer":
            # phase 9: a training step of each action stage
            a2m_train = {k: r["launches"][name] for k, r in mode_runs.items()
                         if k.startswith(A2M_PRESETS) and "peak_mib" in r}
            a2m = {p: r["generate"]["want"][name]
                   for p, r in a2m_runs.items()}
            a2m_evals = {f"{p} {stage}": e["launches_a_batch"][name]
                         for p, r in a2m_runs.items()
                         for stage, e in r["eval"].items()}
        # phase 10: a generate call of each option arm, a training step of
        # each option training arm
        options = ({k: r["launches"][name] for k, r in option_runs.items()
                    if "launches" in r and "reference" not in k}
                   if name != "encoder_layer" else None)
        # phase 11: a full-width pretraining step, each section of the e2e
        # drill
        e2e = ({"pretrain_step": e2e_runs["pretrain"]["launches"][name],
                "drill": {k: r["launches"][name] for k, r in
                          e2e_runs["drill"]["sections"].items()}}
               if name != "encoder_layer" else None)
        # phase 12: a demo generation of each task (the text task a
        # replication)
        output = ({task: r["launches"][name]
                   for task, r in output_runs["demo"].items()}
                  if name != "encoder_layer" else None)
        # phase 13: a step of the train CLI's runs, the last checked
        parallel = ({run: parallel_runs[run]["launches"][name]
                     for run in ("diffusion", "diffusion_numpy",
                                 "vae_diffusion")}
                    if name != "encoder_layer" else None)
        # phase 14: the drill's run (its evaluated batches and AITS calls),
        # a trajectory, each ablation arm, a model-axis rank's step
        tools = ({"drill": tools_runs["drill"]["launches"][name],
                  "drill_calls": tools_runs["drill"]["calls"],
                  "tsne": tools_runs["tsne"]["launches"][name],
                  "ablation": {str(n): r["launches"][name] for n, r in
                               tools_runs["ablation"].items()},
                  "model_axis_step": tools_runs["axis"]["counts"][name]}
                 if name != "encoder_layer" else None)
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": worst(results, key[0]), **arm(results[key]),
                "bf16_max_abs_err": worst(results, "bf16"),
                **arm(results[key16], "bf16_"),
                "train_launches_a_step": train,
                "eval_launches_a_batch": evals,
                "a2m_launches_a_call": a2m,
                "a2m_eval_launches_a_batch": a2m_evals,
                "a2m_train_launches_a_step": a2m_train,
                "options_launches": options,
                "e2e_launches": e2e,
                "output_demo_launches": output,
                "parallel_train_launches_a_step": parallel,
                "tools_launches": tools,
                **extra}

    return {"kernels": [
        entry("skip_encoder", "mld_tpu_torch/csrc/skip_encoder.cu",
              "mld_tpu/ops/fused_layer.py:202", counts["skip_encoder"],
              kr["skip_encoder"], ("f32", 2 * B_LARGE),
              ("bf16", 2 * B_LARGE),
              # mld_humanact12's 15-layer stack at 256 sequences
              a2m_l15_max_abs_err=worst(kr["skip_encoder_a2m"], "f32"),
              a2m_l15_bf16_max_abs_err=worst(kr["skip_encoder_a2m"], "bf16"),
              **arm(kr["skip_encoder_a2m"][("f32", 2 * B_LARGE)], "a2m_l15_"),
              **arm(kr["skip_encoder_a2m"][("bf16", 2 * B_LARGE)],
                    "a2m_l15_bf16_"),
              # the e2e protocol's small denoiser (D = 64, L = 3)
              **arm(e2e_k["skip_encoder"]["f32"], "e2e_small_"),
              **arm(e2e_k["skip_encoder"]["bf16"], "e2e_small_bf16_")),
        # no caller on the main path: launches of one compared call
        entry("encoder_layer", "mld_tpu_torch/csrc/skip_encoder.cu",
              "mld_tpu/ops/fused_layer.py:137",
              layer_res[("f32", 2 * B_LARGE)]["launches"], layer_res,
              ("f32", 2 * B_LARGE), ("bf16", 2 * B_LARGE),
              path="fused_encoder_layer entry",
              bf16_one_layer_rms_err=layer_rounding[0]),
        entry("skip_decoder", "mld_tpu_torch/csrc/skip_decoder.cu",
              "mld_tpu/ops/fused_seq_decoder.py:63", counts["skip_decoder"],
              dec_res, ("f32", B_LARGE), ("bf16", B_LARGE),
              device_kernels=counts["skip_decoder_kernels"],
              device_kernels_traced_one_call=dec_traced["f32"]["traced"],
              device_ms_by_kind=dec_traced["f32"]["device_ms_by_kind"],
              bf16_device_ms_by_kind=dec_traced["bf16"]["device_ms_by_kind"],
              bf16_one_layer_rms_err=dec_rounding[0]),
        # times at the main path's shape: bf16 tower, the prompts' bucket
        entry("flash_causal", "mld_tpu_torch/csrc/flash_causal.cu",
              "mld_tpu/ops/attention.py:188", counts["flash_causal"],
              kr["flash_causal"], ("f32", prompt_len), ("bf16", prompt_len),
              # the full-width pretraining's [64, 12, S, 64]
              **arm(e2e_k["flash_causal"][("f32", "pretrain")], "pretrain_"),
              **arm(e2e_k["flash_causal"][("bf16", "pretrain")],
                    "pretrain_bf16_")),
        # launches of the novae_stress_s512 call; times of one of its
        # self-attentions at the demo batch
        entry("flash_attention", "mld_tpu_torch/csrc/flash_attention.cu",
              "mld_tpu/ops/attention.py:77",
              raw_runs["novae_stress_s512"]["counts"]["flash_attention"],
              kr["flash_attention"], ("f32", FLASH_KEY), ("bf16", FLASH_KEY),
              # the ACTOR decoder's self-attention at B = 128
              **arm(kr["flash_attention"][("f32", ("actor decode self",
                                                   B_LARGE))], "a2m_"),
              **arm(kr["flash_attention"][("bf16", ("actor decode self",
                                                    B_LARGE))], "a2m_bf16_"),
              # the e2e protocol's small VAE decode (4 heads of 16)
              **arm(e2e_k["flash_attention"][("f32", ("e2e decode self",
                                                      e2e_eval_b))],
                    "e2e_dh16_"),
              **arm(e2e_k["flash_attention"][("bf16", ("e2e decode self",
                                                       e2e_eval_b))],
                    "e2e_dh16_bf16_"),
              # a model-axis rank's denoiser self-attention (half the heads)
              **arm(axis_k[("f32", (AXIS_FLASH_CASE[0], AXIS_B))],
                    "model_axis_"),
              **arm(axis_k[("bf16", (AXIS_FLASH_CASE[0], AXIS_B))],
                    "model_axis_bf16_")),
    ]}


def main():
    import torch

    smi = phase_device(torch)
    if not os.path.isdir(os.path.join(REPO, "mld_tpu_torch")):
        raise RuntimeError(f"no mld_tpu_torch package beside {__file__}: run "
                           f"chip_smoke.py from a checkout of the repo")
    sys.path.insert(0, REPO)
    t0 = time.perf_counter()
    phase_build()
    log(f"[time] build: {time.perf_counter() - t0:.1f} s")
    kr, runs, texts, lengths = phase_main_path(torch)
    raw_runs = phase_raw_motion(torch, texts, lengths)
    t0 = time.perf_counter()
    train_runs = phase_training(torch, smi)
    log(f"[time] training: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    eval_runs = phase_evaluation(torch, smi)
    log(f"[time] evaluation: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    a2m_runs = phase_action(torch, smi)
    log(f"[time] action-to-motion: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mode_runs = phase_train_modes(torch, smi, train_runs)
    log(f"[time] training presets and modes: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    option_runs = phase_options(torch, smi, texts, lengths)
    log(f"[time] text-family options: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    e2e_runs = phase_e2e(torch, smi)
    log(f"[time] end-to-end protocol: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    output_runs = phase_output(torch, smi)
    log(f"[time] output path: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    parallel_runs = phase_parallel(torch, smi)
    log(f"[time] data parallelism and loader: "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    tools_runs = phase_tools(torch, smi)
    log(f"[time] released-checkpoint path and tools: "
        f"{time.perf_counter() - t0:.1f} s")
    log(json.dumps(kernels_line(kr, runs, raw_runs,
                                runs["kernels"]["prompt_len"], train_runs,
                                eval_runs, a2m_runs, mode_runs,
                                option_runs, e2e_runs, output_runs,
                                parallel_runs, tools_runs)))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
