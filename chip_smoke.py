"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (one line each; any failure raises and the script exits non-zero):
  1 device   CUDA present; the card's name and power limit (nvidia-smi);
             TF32 off for matmuls and cuDNN convolutions
  2 build    nvcc builds the four kernels of talkshow_torch/csrc/ (sm_90a) and
             g++ the rasterizer, one process per source, all started together;
             loaded
  3 K1       the AR-decode kernel against its plain PyTorch version at full
             width (dim 256, 15 layers, K 2048, H 75), B in {1, 8, 32}:
             a) f32 tables, injected gumbel noise: free-run tokens equal,
                every emitted token = argmax(emitted logits + noise),
                teacher-forced logits within 1e-3 (same f32 math, summed in
                another order through 15 layers)
             b) bf16 tables against the plain version on the same
                bf16-rounded weights: teacher-forced logits within 1e-3 of
                max|logit| (activations are f32 on both sides, so only the
                summation order differs, and at B = 32, on the tensor cores,
                x's split into bf16 hi + lo, 2^-17 of it), and >= 97 % of the draws
                argmax(logits + noise) agree
             c) in-kernel Philox noise: seeded, in [0, K), and the sampled
                tokens' mean log-probability within 4 standard errors of the
                logits' mean negative entropy
             d) B = 1 and 8: a prefix of 30 of the 75 rows (f32 tables): tokens
                equal, forced rows kept, logits within 1e-3; 20 reruns with one
                Philox seed (bf16 tables) bit-equal in tokens and logits
  4 main     Pipeline.create(seed, device="cuda") at full width: generate()
             on a synthetic 10 s 16 kHz wav for S in {1, 8}; (S, 300, 265)
             finite output; K1 launched and the plain sampler not called; the
             face stage through K3 and K2 (one launch each per call, bf16
             tables), the plain face stage not called; then a 1 s clip against
             the same weights on the CPU (f32 decode and face tables, shared
             noise): equal tokens, motion within 1e-3 (bf16 tables reported)
  5 times    generate() p50 over 10 runs at S=1 and 5 runs at S=8 (CUDA
             events, fresh seed per run) with the fused face stage, in turns
             with the same pipeline on the plain face stage (the parent's
             generate); the S=1 stages (face fused and plain); K1 (bf16
             tables, Philox) at B = 1, 8, 32 and H = 75, 25: ms, us per row,
             us per dependent step (the slope
             between H = 75 and 25 over the steps of a row) and the launch's
             shape, and where a row's time goes (the kernel's %globaltimer
             probe, `decode_timeline`); the K1 decode against the plain
             decode at B = 1 and 8,
             H = 75; K1's device time by kernel (torch.profiler); each beside
             the card's name and limit
  6 K2       the wav2vec encoder-layer kernel against its plain version at
             full width (12 layers, 768 wide, 12 heads, FFN 3072, T = 300) on
             random weights: B = 1 unmasked, B = 8 masked (valid 300, 270, ..,
             90); two runs equal bit for bit; f32 tables within 1e-3 on valid
             rows (the same f32 math in another order through 12 post-norm
             layers), bf16 tables within 1e-2 of max|out| (both sides round
             every product's operands to bf16; an intermediate may round the
             other way), padded rows finite; then the Hopper GEMM that K2 and
             K3 share, alone, at each of their product shapes (B = 1 and 8):
             within 1e-4 of max|C| of torch.matmul on the same bf16 operands,
             and its TFLOP/s from a captured CUDA graph
  7 K3       the conv-extractor kernel against its plain version, full 7-conv
             512-channel stack, 10 s clip, B = 1 and 8, f32 within 1e-3 and
             bf16 within 1e-2 of max|out|; two runs equal bit for bit
  8 face     models/wav2vec_fused.face_apply_fused at full width, f32
             tables, on Pipeline.create(seed=0)'s weights, against the plain
             face stage (FaceGenerator.forward): unmasked B = 1 on the 10 s
             clip and masked B = 8 (clips of 10, 9, .., 3 s padded to 10 s),
             real frames within 1e-3; launch counts read around each call
             (K2 and K3 > 0 unmasked; K2 and the plain masked extractor > 0
             masked); bf16 tables reported beside them
  9 times    K2, K3 and face_apply_fused (bf16 tables) against their plain
             versions at B = 1 and 8, K2's library yardstick (one
             nn.TransformerEncoder call on the same weights, bf16, eager and
             replayed from a captured CUDA graph) and, at B = 1 and 8, the
             device time of one K2 and one K3 call by kernel (torch.profiler)
             with the device-idle share of the call (1 - device time / CUDA-event
             wall time), each beside the card
 10 K4       the nearest-code kernel against its plain version at full width
             (codebook 2048 x 64 and 2047 x 64, N in {1, 75, 2816}; each shape's
             plan: tile rows, cluster, CTAs): two runs equal bit for bit, exact
             ties between codes in different CTAs' slices take the lower index,
             indices equal to plain except on near-tie rows (best and
             second-best distances within 1e-5 (1 + |best|); the kernel sums
             ||e||^2 itself), and on every row the pick's distance within that
             tolerance of the minimum
 11 train    python -m talkshow_torch.train (its main()) for s2g_body_vq at full
             width (batch 128, window 88, num_hiddens 1024) on a synthetic
             dataset, one epoch of >= 10 steps: every logged loss finite,
             nearest_code launched twice per step, the plain search never,
             grad_stats and adam_apply once each a step, their twin never; a
             checkpoint, and resume + one step equal to the uninterrupted run's
             next step bit for bit; one step from one fresh state on CUDA
             against the CPU (B = 8, TF32 off): losses within 1e-4 relative,
             indices equal apart from near-ties, decoder gradients within 1e-3
             of max|g|; encoder gradients, whose f32 rounding reaches ~1e-2 of
             max|g| on either device (three levels of batch-statistics
             BatchNorm behind the straight-through estimator), within 2e-2 of
             an f64 CPU reference, the CPU's own f32 error beside them;
             BatchNorm statistics and VQ states within 1e-4, parameters within
             2 lr (Adam's first step moves each by about lr sign(g)) and at
             least 99 % of them within 1e-2 lr; make_token_encoder on a batch
             of 128 launches K4
 12 times    the body-VQ step p50 and windows/s at B = 128, T = 88, its device
             time by kernel (torch.profiler) and, for the record, its time with
             cuDNN's non-deterministic algorithms (TF32 off) and with TF32 on;
             K4 (bare, and through ops/vq.nearest_code as the step calls it), its
             plain version and the two-call yardstick argmin(addmm) at N = 75
             and 2816 with the bound share, the kernels one ops/vq.nearest_code
             call launches (torch.profiler; more than one fails); the token
             encode at B = 128; each beside the card
 13 continuity  generate(continuity=True) at full width on the 10 s clip: K1
             launched twice, K2 and K3 once, no plain sampler or face stage;
             (1, 300, 265) finite; the second decode's first gap // 4 rows
             equal the first decode's tokens; p50 over 5 runs; ms of
             get_mfcc_sepa against get_mfcc and of the two decodes against one
 14 serve    MotionServer(bucket_frames=32, max_batch=8) at full width:
             warmup(10) and its bucket count; 8 requests of 3-10 s in 4
             buckets, one flush: (frames, 265) finite each, per group one K1
             launch at B = 8 and one K2 launch (the plain masked extractor, as
             in JAX), no plain sampler or face stage; a served clip's face
             frames (f32 tables) within 1e-3 of its unpadded fused and plain
             face stages; flush p50 ms, requests/s, audio-seconds/s
 15 stream   StreamingSession(chunk_rows=8, context_rows=16) on the 10 s clip
             fed in 1.07 s chunks: blocks of 32 frames, (300, 265) finite; K1,
             K2 and K3 launched once at every step; the window's K3 and K2
             against their plain versions at 32, 64 and 96 frames (f32 within
             1e-3, bf16 within 1e-2 of max|out|); step p50 and the real-time
             factor; device time by kernel and the device-idle share of
             generate (phase 5), a flush and a whole session
 16 train-pixel  python -m talkshow_torch.train (its main()) for s2g_body_pixel at
             full width (batch 128, window 88, prior 256 x 15 over 2048 codes,
             audio encoder 256) on phase 11's ckpt-0.pt, 2 epochs of >= 10
             steps: every logged value finite; K4 twice per batch that missed
             the token cache and per batch of the epoch-end fill (the windows
             no batch brought), none in epoch 2, the plain search never;
             grad_stats and adam_apply once each a step of both epochs;
             cached token grids (brought and filled) equal a fresh encode bit
             for bit; ckpt-0 + epoch 2 equals
             the uninterrupted run bit for bit; one step from one state on
             CUDA against the CPU (B = 8, TF32 off, the same tokens and
             dropout mask): ce_loss and grad norm within 1e-4 relative, prior
             gradients within 1e-3 of max|g|, audio-encoder gradients within
             2e-2 (batch-statistics BatchNorm, as phase 11's encoder),
             BatchNorm statistics within 1e-4, parameters within 2 lr and at
             least 99 % within 1e-2 lr
 17 train-face  main() for s2g_face at full width (wav2vec 2.0 base, 12 x 768,
             with the face heads) on the CLI's synthetic 8 s raw clips: whole
             clips at batch 1 for 2 epochs, K3 (f32 tables) and grad_stats (the
             SGD step's flag and norm) once a step and the plain extractor
             never; then --face_bucket 32 --face_batch_size 2
             through the plain masked extractor (extractor_plain counted);
             logged values finite, the extractor's parameters bit-equal to
             their init and without .grad; ckpt-0 + epoch 2 bit-equal to the
             uninterrupted run; one step CUDA against CPU at stochastic=False
             (losses and grad norm within 1e-4 relative, gradients within
             1e-3 of max|g|, parameters within 1e-5 of max|p|); K3's frozen
             features within 1e-3 of max|out| of the plain extractor
 18 times    the body-pixel step p50 and windows/s with cached tokens (warm)
             and encoding in the step (cold), the encode's share and device
             time by kernel of each; the face step p50 at batch 1 on the 8 s
             clip with the frozen extractor on K3 and on the plain extractor
             in turns, and its device-idle share; both steps with TF32 on,
             for the record; each beside the card
 19 train-ae  main() for s2g_body_ae at full width (the AE of 1024 hidden over
             the 129 conv channels, batch 128, window 88) on the synthetic
             dataset, one epoch of >= 10 steps: every logged loss finite, none
             of K1-K4 launched (the AE has no quantizer), grad_stats and
             adam_apply once each a step; ckpt-0 + one step
             bit-equal to the uninterrupted run; one step from one state on
             CUDA against the CPU (B = 8, TF32 off): losses within 1e-4
             relative; every gradient within 2e-2 of max|g| of an f64 CPU
             reference, as phase 11's encoder: the AE's decoder reads the
             encoder's output, so all of its gradients lie behind three
             levels of batch-statistics BatchNorm (phase 11's 1e-3 is for VQ
             decoders, which read codebook rows equal on both devices);
             BatchNorm statistics within 1e-4, parameters within 2 lr and
             >= 99 % within 1e-2 lr; the step's p50
 20 eval     a synthetic SHOW test split (4 clips of 10 s, pkl + 16 kHz wav)
             through ShowDataset.from_root on the card (MFCC and raw), a
             synthetic SMPL-X rig of the official size (10 475 vertices, 55
             joints, 300 + 100 coefficients) through load_smplx_npz; the
             trained stages of phases 11, 16 and 19 through the eval CLI's
             loaders; eval_vq_capacity (K4 twice a clip, the plain search
             never), eval_body at 2 samples (K1 once a clip, the plain sampler
             never; LVD over the rig's joints, beat consistency from the
             clips' onsets) and eval_face on the raw clips (K3 and K2 once a
             clip, the plain face stage never; face-vertex LVD over all
             vertices): every metric finite; FGD on the card (f32 eigh)
             within 1e-3 relative of frechet_distance_np (f64) on the same
             features; `python -m talkshow_torch.eval body` (its main(), on
             the card by default) on the tree with the checkpoints: K1 once a
             clip; one 2 s clip on the card (f32 decode and face tables)
             against the CPU on the same weights and noise: tokens equal,
             l2, lvd, jaw_l1, exp_mse and face_lvd within 1e-4 relative (the
             same f32 math in another order: the face frames agree within
             1e-5, phase 8, on metrics of O(0.1-1))
 21 times    each runner's ms per clip and its parts (decode, AE extract, LBS,
             onset times, FGD, bootstrap; the VQ round trip; the face stage,
             LBS over the vertices), each beside the card
 22 train-ls3dcg  main() for s2g_LS3DCG at the stage-1 batch and window
             (B = 128, T = 88; the LS3DCG widths are fixed, 64 ... 1024) on the
             synthetic dataset, one epoch of >= 10 steps: logged values finite,
             none of K1-K4 launched, the Adam kernels once each an optimizer a
             step; ckpt-0 + one step bit-equal to the
             uninterrupted run; one step from one state on CUDA against the CPU
             (B = 8, TF32 off): losses within 1e-4 relative, both models'
             gradients within 2e-2 of max|g| (phase 19's tolerance behind
             batch-statistics BatchNorm), statistics within 1e-4, parameters
             within 2 lr and >= 99 % within 1e-2 lr; the step's p50, windows/s
 23 eval-ls3dcg  eval_ls3dcg on phase 20's split with phase 19's AE (finite,
             the CIs, no kernel) and its ms per clip; `python -m
             talkshow_torch.eval ls3dcg` on the card by default with phase 22's
             checkpoint; infer_on_audio on the 10 s clip: (2, 300, 265) finite, ms
 24 6-D      the convert_to_6d variant at full width: s2g_body_vq for one epoch
             (VQ-VAEs over 78 / 180 channels, 330-wide poses; K4 twice a step),
             s2g_body_pixel on its checkpoint with the 512 x 10 prior for two
             epochs (K4 twice per missed and per fill batch, none in epoch 2),
             eval_vq_capacity on phase 20's split converted to 6-D (K4 twice a
             clip); generate_conv_poses through K1 at dim 512, 10 layers on the
             10 s clip at B = 1, 2, 8: (B, 300, 258) finite, one launch, f32
             tables: tokens equal the plain sampler's under shared noise,
             teacher-forced logits within 1e-3; bf16 tables against the
             bf16-rounded plain version within 1e-3 of max|logit|, >= 97 % of
             draws equal; B = 32 raises before any launch and names the largest
             batch that fits, and generate_conv_poses decodes it in chunks of
             that size; K1's ms at B = 1, 8 and the largest batch, the plain
             decode at B = 1, the bound (as the K1 row's), the timeline
 25 SHOW     preprocess's filter and split on phase 20's tree; the train CLI
             without --synthetic on a synthetic SHOW train split (8 clips of 20
             s): s2g_body_vq on MFCC windows (K4 twice a step) and s2g_face on
             whole raw clips (K3 once a step)
 26 CLIs     the user entry points on the 10 s clip at full width, each through
             its main(argv) on the card (random weights from --seed): the demo's
             default mode (p50 of 3 calls; equal bit for bit to
             Pipeline.create(0).generate(seed=0); K1, K2, K3 once), --only_face
             (K2, K3), --continuity (K1 twice), --streaming (1 s feeds; K1, K2, K3
             once a step), --norm_stats, --model ls3dcg on phase 22's checkpoint
             (no kernel); diversity at 4 speakers x 3 samples (K1 4 times);
             continuity (K1 twice, K2, K3); convert_checkpoints on the golden
             fixtures, loaded by load_pipeline into a pipeline of their widths on
             the card (face output within 5e-4, hand decode within 2e-4 of
             expected.npz); each one's wall time and launches
 27 render   30 frames of the demo's motion, whole_body tiles without captions,
             over a synthetic SMPL-X rig of the official size (10 475 vertices):
             LBS on the card, then the native rasterizer, ms a frame for each;
             the native frames against the numpy rasterizer on 2 frames (frame 0
             and the rest pose): at most 0.5 % of the pixels differ by more than 2
             levels; the mp4 writer (cv2, the audio muxed where ffmpeg exists)
             on the 30 frames where cv2 is installed, else a line that says so
 28 vertical the bh_model=false prior: the train CLI's s2g_body_pixel with
             Model.bh_model false on phase 11's checkpoint (256 x 15, no horizontal
             stack; K4 on cache misses, no K1); one step CUDA against CPU from one
             state (phase 16's tolerances); Pipeline.generate on it raises the
             named ValueError before any K1 launch
 29 causal   the causal VQ-VAE at full width (1024 hidden, 2048 x 64) on 10 s of
             body (39) and hand (90) poses in 20-frame chunks: each K4 call's
             indices equal the plain search's on its latents (near-ties exempt),
             chunked tokens equal the full encode's (near-ties exempt), the
             chunked decode within 1e-4 of max|out| of the full decode; K4's
             launches and ms a chunk
 30 bf16     --bf16 through the train CLI at full width: s2g_body_pixel on phase
             11's checkpoint (the prior 256 x 15 in bf16, B = 128, T = 88; K4 for
             the token encode) and s2g_face (wav2vec 2.0 base in bf16, B = 1, 8 s
             clips; K3 on bf16 tables once a step); f32 masters; one step of each
             CUDA against CPU from one state within tests/test_torch_bf16.py's
             bounds; K3's bf16 features within 1e-2 of its plain version; each
             step's p50 in bf16 and in f32 on the same weights, in turns, and the
             bf16 step's device time by kernel and idle share
 31 schedule python -m talkshow_torch.full_schedule --smoke (its main()) at full
             width on a synthetic SHOW tree of one 29 s train and one 20 s test
             clip a speaker: body_vq, body_pixel (--bf16), face (--bf16
             --face_bucket 30), body_ae, ls3dcg, then the eval battery; wall
             seconds and K1-K4 launches per stage; the EVAL json holds every key
             of scripts/eval_full_schedule.py's results (read as text), all its
             numbers finite
 32 w2v-vq   Wav2VecVQEncoder (wav2vec 2.0 base, 1024 hidden) on the 10 s clip:
             one eval forward launches K3 and K2 once each, within 1e-3 of
             max|out| of the plain forward (f32 tables; bf16 reported); ms of the
             kernel route and the plain forward, in turns
 33 legacy   FaceGeneratorMeshtalk and FreeformS2G / S2GDiscriminator
             (tests/test_extras.py:148's widths) on the 10 s clip: CUDA within
             1e-4 of the CPU; ms on the card
 34 dp x tp  the body-VQ step at full width (1024 hidden, 2048 x 64, B = 128,
             T = 88) on (dp 2, tp 1) and (dp 1, tp 2): two ranks on this card
             in a gloo group over CUDA tensors (tests/torch_dist_check.py,
             each rank killed on failure or at its timeout), 5 steps a layout
             from one state; each step held against the one-process step from
             the same state on the same global batch: losses, running
             statistics, codebooks, gradients, and the parameters' changes
             (the share of elements off by more than 1e-2 lr, the L2 error)
             within twice that step's own spread under the batch's rows
             reversed, or the floors; a step that quantized a row to
             another code (a near-tie decided by rounding; at most 1e-2 of
             the rows) within 1e-3 in its losses and 0.2 in the L2 error of
             its parameters' changes; losses and states bit-equal on both ranks; one (1 x 2)
             step with a planted fault (the last tp rank never updates its
             slices) must fail that check; K4 once a quantizer a step on
             each rank; step p50 per layout; a one-rank NCCL all_reduce; dp 2
             on NCCL, a card per rank, where there are two cards; the train
             CLI under `torchrun --nproc_per_node 2` with parallel dp 2 (1
             epoch)
 35 sharded  Pipeline.generate_body_sharded at full width: a 10 s clip, S = 8
             on a dp = 4 mesh of this card: one K1 launch a shard (B = 2), no
             plain sampler call, each shard's tokens equal generate_conv(S = 2)
             under its noise; ms against the unsharded S = 8 call, in turns
 36 mesh srv MotionServer(mesh=dp 2 of this card, bucket_frames 32, max_batch 8)
             on phase 14's 8 clips: K1 and K2 once a shard a group, the plain
             masked extractor once a shard, no plain sampler or face stage;
             a flush reproduced bit for bit per seed; face columns within 2e-4
             of the unsharded server's (f32 tables); flush p50 against the
             unsharded server, in turns
 37 face dp  the face step at full width (wav2vec 2.0 base with the face
             heads, 8 s clips, T = 240, f32) on (dp 1, tp 2) with whole clips at
             B = 1 and on (dp 2, tp 1) with buckets of 32 frames at a global
             B = 2: two ranks on this card in a gloo group, 4 steps a layout
             from one state, SpecAugment and dropout drawn in the step for the
             global batch; each step held against the one-process step on the
             global batch with the global masks, beside that step computed in
             another order (tests/test_torch_parallel_face.py's bounds); losses and
             states bit-equal on both ranks; the frozen extractor whole and
             unchanged on both; K3 once a step a rank on whole clips, the plain
             masked extractor on buckets; one (1 x 2) step with a planted fault
             must fail; the train CLI's s2g_face under `torchrun
             --nproc_per_node 2` at tp 2, 1 epoch, its whole ckpt-0.pt loaded
             on one device for one more step; step p50 per layout and the
             phase's wall seconds
 38 adam     the Adam steps' two kernels (grad_stats, adam_apply) at the leaf
             lists of the benchmark's train-prior-3d (198 leaves, 24.1 M
             elements, clip at 5) and train-vq-6d (212, 71.0 M, no clip) cells:
             the flag equal, the norm within 1e-5 of the plain twin's and
             bit-equal over two calls, parameters and moments within 4 ulps (of
             the largest of the old value, the new and the change) of the plain
             twin's from the same norm, a NaN leaving every tensor
             bit-equal and the skip counted; CUDA-event ms of each kernel (on
             the device from a captured graph, and a call from the host), its
             plain twin and torch's fused Adam, beside the bytes bound; one
             launch each a call; the launches of the Adam steps in phases 11-37
Then one JSON line of kernels (launches of K1-K3: generate S=1 and 8,
continuity, the serve flush, the stream and the eval path (eval_body and
the eval CLI for K1, eval_face for K2 and K3), summed, K3 in phase 17 and
phase 25, K1 at dim 512 in phase 24, the entry points of phase 26,
phases 30-32 and 35-36; K4: phases 11, 16, eval_vq_capacity, 24, 25, 28,
29, 30, 31 and the ranks of phase 34; K3 also on the ranks of phase 37;
grad_stats and adam_apply, which replace no TPU kernel: every Adam step,
and for grad_stats every SGD step, this process runs in phases 11-37,
phase 38's own calls left out), the
nvidia-smi line, the total wall
time and the result line.  Several ranks on one card measure correctness,
not scaling.

"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time
import wave

import numpy as np
import torch

FULL = dict(dim=256, layers=15, K=2048, H=75)
#: published H100 SXM peaks: bytes/s, bf16 tensor-core FLOP/s, f32 FLOP/s
#: outside the tensor cores
HBM_BYTES_S, BF16_FLOP_S, F32_FLOP_S = 3.35e12, 989e12, 67e12
KERNELS = ("ar_decode", "wav2vec_layers", "wav2vec_extractor", "nearest_code")
#: stage-1 training at full width (talkshow_tpu/config.py:21,60-62,79)
TRAIN = dict(batch=128, window=88, num_hiddens=1024, codes=2048, dim=64)
#: stage-2 training at full width: batch and window as stage 1, the prior of
#: Pipeline.create (dim 256 x 15 layers over 2048 codes), a 256-wide audio
#: encoder (talkshow_tpu/config.py:63-65, scripts/train.py:146-151)
PIXEL = dict(dim=256, layers=15, codes=2048, audio=256)
#: stage-3 training: wav2vec 2.0 base (layers, hidden) with the face heads on
#: the CLI's synthetic raw clips of 240-269 frames (scripts/train.py:76-99)
FACE_WIDTH = (12, 768)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, reps: int = 1) -> float:
    """Mean device-clock ms of fn() over reps, after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def prior_case(B: int, seed: int, dev):
    from talkshow_torch.models.layers import init_weights_
    from talkshow_torch.models.pixelcnn import GatedPixelCNN, gumbel_noise
    gen = torch.Generator().manual_seed(seed)
    model = init_weights_(GatedPixelCNN(input_dim=FULL["K"], dim=FULL["dim"],
                                        n_layers=FULL["layers"]), gen)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    H, K = FULL["H"], FULL["K"]
    label = torch.randint(0, 4, (B,), generator=gen).to(dev)
    audio = torch.randn((B, H, 256), generator=gen).to(dev)
    given = torch.randint(0, K, (B, H, 2), generator=gen).to(dev)
    noise = gumbel_noise((H, 2, B, K), gen, dev)
    return model.to(dev).eval(), label, audio, given, noise


def phase3(dev) -> float:
    from talkshow_torch.kernels.ar_decode import (pack_decode_tables, round_like_tables,
                                                  sample_tokens_fused)
    from talkshow_torch.models.pixelcnn import sample_tokens
    H, K = FULL["H"], FULL["K"]
    worst = 0.0
    for B in (1, 8, 32):
        model, label, audio, given, noise = prior_case(B, B, dev)
        # (a) f32 tables
        t32 = pack_decode_tables(model, torch.float32)
        tok, lg_free = sample_tokens_fused(model, label, audio, tables=t32, noise=noise,
                                           return_logits=True)
        want = sample_tokens(model, label, audio, noise=noise)
        n_eq = int((tok == want).sum())
        if n_eq != tok.numel():
            raise AssertionError(f"3a B={B}: free-run tokens differ at "
                                 f"{tok.numel() - n_eq}/{tok.numel()} positions")
        draws = torch.argmax(lg_free + noise.permute(2, 0, 1, 3), dim=-1)
        if not torch.equal(draws, tok):
            raise AssertionError(f"3a B={B}: emitted tokens are not argmax(logits + noise)")
        _, lg = sample_tokens_fused(model, label, audio, tables=t32, noise=noise,
                                    prefix_tokens=given, prefix_len=H, return_logits=True)
        _, lg_ref = sample_tokens(model, label, audio, noise=noise, prefix_tokens=given,
                                  prefix_len=H, return_logits=True)
        err = (lg - lg_ref).abs().max().item()
        worst = max(worst, err)
        if not err <= 1e-3:
            raise AssertionError(f"3a B={B}: teacher-forced max|dlogit| {err} > 1e-3")
        log(f"phase 3a B={B}: f32 tables, free-run tokens equal {n_eq}/{tok.numel()}, "
            f"teacher-forced max|dlogit| {err:.3e} <= 1e-3")
        # (b) bf16 tables against the plain version on bf16-rounded weights
        t16 = pack_decode_tables(model, torch.bfloat16)
        rounded = round_like_tables(model, torch.bfloat16)
        _, lg16 = sample_tokens_fused(model, label, audio, tables=t16, noise=noise,
                                      prefix_tokens=given, prefix_len=H, return_logits=True)
        _, lg16_ref = sample_tokens(rounded, label, audio, noise=noise, prefix_tokens=given,
                                    prefix_len=H, return_logits=True)
        scale = lg16_ref.abs().max().item()
        rel = (lg16 - lg16_ref).abs().max().item() / scale
        g = noise.permute(2, 0, 1, 3)
        agree = (torch.argmax(lg16 + g, -1) == torch.argmax(lg16_ref + g, -1)).float().mean().item()
        if not (rel <= 1e-3 and agree >= 0.97):
            raise AssertionError(f"3b B={B}: rel err {rel}, draw agreement {agree}")
        log(f"phase 3b B={B}: bf16 tables, teacher-forced max|dlogit|/max|logit| "
            f"{rel:.3e} <= 1e-3, draws agree {agree:.4f} >= 0.97")
        # (c) Philox
        def run(seed, **kw):
            return sample_tokens_fused(model, label, audio, tables=t16,
                                       generator=torch.Generator().manual_seed(seed), **kw)
        a, b, c = run(11), run(11), run(12)
        if not (torch.equal(a, b) and not torch.equal(a, c)
                and int(a.min()) >= 0 and int(a.max()) < K):
            raise AssertionError(f"3c B={B}: Philox tokens not seeded or out of range")
        tok_p, lg_p = run(13, return_logits=True)
        logp = torch.log_softmax(lg_p.double(), dim=-1)
        picked = logp.gather(-1, tok_p[..., None])[..., 0]
        negent = (logp.exp() * logp).sum(-1)
        diff = (picked - negent).flatten()
        z = diff.mean().item() / (diff.std().item() / math.sqrt(diff.numel()))
        if not abs(z) <= 4.0:
            raise AssertionError(f"3c B={B}: sampled log-prob off by {z:.2f} standard errors")
        log(f"phase 3c B={B}: Philox seeded and in [0, {K}), mean log p(token) "
            f"{picked.mean().item():.4f} vs mean -entropy {negent.mean().item():.4f} "
            f"({z:+.2f} s.e.)")
    return worst


def phase3d(dev) -> None:
    """K1 with a prefix shorter than H, and reruns with one Philox seed:
    the kernel's roles meet only through flags, so a missing wait shows as a
    rerun that differs."""
    from talkshow_torch.kernels.ar_decode import pack_decode_tables, sample_tokens_fused
    from talkshow_torch.models.pixelcnn import sample_tokens
    P = 30
    for B in (1, 8):
        model, label, audio, given, noise = prior_case(B, 60 + B, dev)
        t32 = pack_decode_tables(model, torch.float32)
        tok, lg = sample_tokens_fused(model, label, audio, tables=t32, noise=noise,
                                      prefix_tokens=given, prefix_len=P, return_logits=True)
        want, want_lg = sample_tokens(model, label, audio, noise=noise, prefix_tokens=given,
                                      prefix_len=P, return_logits=True)
        err = (lg - want_lg).abs().max().item()
        if not (torch.equal(tok, want) and torch.equal(tok[:, :P], given[:, :P].long())
                and err <= 1e-3):
            raise AssertionError(f"3d B={B}: prefix {P}/{FULL['H']}: tokens equal "
                                 f"{int((tok == want).sum())}/{tok.numel()}, max|dlogit| {err}")
        t16 = pack_decode_tables(model, torch.bfloat16)
        runs = [sample_tokens_fused(model, label, audio, tables=t16, return_logits=True,
                                    generator=torch.Generator().manual_seed(21))
                for _ in range(20)]
        same = sum(torch.equal(t, runs[0][0]) and torch.equal(g, runs[0][1]) for t, g in runs)
        if same != len(runs):
            raise AssertionError(f"3d B={B}: {same}/{len(runs)} Philox reruns bit-equal")
        log(f"phase 3d B={B}: prefix {P} of {FULL['H']} rows (f32 tables): tokens equal "
            f"{tok.numel()}/{tok.numel()}, forced rows kept, max|dlogit| {err:.3e} <= 1e-3; "
            f"bf16 tables, {same}/{len(runs)} Philox reruns bit-equal (tokens and logits)")


def phase5_k1(dev, card: str) -> dict:
    """K1 (bf16 tables, Philox) at B = 1, 8, 32 and H = 75, 25: ms, us per
    row, us per dependent step (the slope between H = 75 and 25 over the
    steps of a row), the launch's shape and the timeline probe; the plain
    decode at B = 1 and 8 in the order plain, kernel, kernel, plain; one
    profiler line.  Returns (kernel ms, plain ms) per B."""
    from talkshow_torch.kernels import ar_decode
    from talkshow_torch.kernels.ar_decode import chain_steps
    from talkshow_torch.models.pixelcnn import sample_tokens
    steps = len(chain_steps(FULL["layers"], FULL["dim"], FULL["K"], 512)) + 2
    res = {}
    for B in (1, 8, 32):
        model, label, audio_b, _, _ = prior_case(B, 40 + B, dev)
        t16 = ar_decode.pack_decode_tables(model, torch.bfloat16)
        gen = torch.Generator().manual_seed(0)
        ms = {}
        for H in (75, 25):
            aud = audio_b[:, :H].contiguous()
            ms[H] = cuda_ms(lambda: ar_decode.sample_tokens_fused(
                model, label, aud, tables=t16, generator=gen), 5)
        step_us = (ms[75] - ms[25]) * 1e3 / 50 / steps
        shape = dict(ar_decode.last_launch)
        tl = ar_decode.decode_timeline(model, label, audio_b, t16,
                                       torch.Generator().manual_seed(1))
        log(f"phase 5 K1 B={B}: H=75 {ms[75]:.3f} ms, H=25 {ms[25]:.3f} ms, "
            f"{ms[75] * 1e3 / 75:.1f} us/row, {step_us:.3f} us per dependent step "
            f"({steps} per row); chain CTAs {shape['chain_ctas']}, vertical CTAs "
            f"{shape['vertical_ctas']}, shared memory {shape['smem_bytes']} B/CTA, "
            f"ring {shape['ring_stages']} x {ar_decode.CHUNK_BYTES} B [{card}]")
        log(f"phase 5 K1 B={B} timeline (%globaltimer, mean over rows "
            f"1-74, us): " + ", ".join(f"{k[:-3]} {v:.2f}" for k, v in tl.items()))
        if B in (1, 8):
            def kern():
                return ar_decode.sample_tokens_fused(model, label, audio_b, tables=t16,
                                                     generator=gen)

            def plain():
                return sample_tokens(model, label, audio_b, generator=gen)

            p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(kern, 5), cuda_ms(kern, 5), cuda_ms(plain)
            res[B] = ((k1 + k2) / 2, (p1 + p2) / 2)
            log(f"phase 5 ar_decode B={B} H=75: kernel (bf16 tables) {k1:.2f} / {k2:.2f} ms, "
                f"plain {p1:.2f} / {p2:.2f} ms [{card}]")
            if B == 1:
                log(f"phase 5 K1 B=1 device time by kernel: {kernel_breakdown(kern)} [{card}]")
    return res


def write_wav(path: str, seconds: float, seed: int) -> None:
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000.0
    x = 0.3 * np.sin(2 * np.pi * 220.0 * t) * (1 + np.sin(2 * np.pi * 3 * t))
    x = x + 0.05 * rng.standard_normal(t.shape)
    pcm = (np.clip(x, -1, 1) * 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())


def bound(nbytes: float, flops: float, peak: float = BF16_FLOP_S) -> tuple[float, str]:
    """Least ms the card could take: bytes over HBM rate vs operations over
    the peak rate for their type (bf16 tensor cores unless given),
    whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def w2v_encoder(seed: int, dev):
    """A full-width Wav2Vec2Encoder with random weights, biases and norm
    parameters (init_weights_ leaves biases 0 and norms 1)."""
    from talkshow_torch.models.layers import init_weights_
    from talkshow_torch.models.wav2vec import Wav2Vec2Encoder
    gen = torch.Generator().manual_seed(seed)
    enc = init_weights_(Wav2Vec2Encoder(), gen)
    with torch.no_grad():
        for p in enc.parameters():
            if p.dim() == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
    return enc.to(dev).eval()


def speech(B: int, seconds: float, seed: int, dev) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000.0
    x = 0.3 * np.sin(2 * np.pi * (180.0 + 20 * np.arange(B)[:, None]) * t) \
        + 0.05 * rng.standard_normal((B, t.size))
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def check_close(tag: str, out, want, valid, dtype) -> float:
    """max|out - want| over real rows; raises past the stated tolerance."""
    err, scale = 0.0, 0.0
    for b, n in enumerate(valid):
        err = max(err, (out[b, :n] - want[b, :n]).abs().max().item())
        scale = max(scale, want[b, :n].abs().max().item())
    tol = 1e-3 if dtype == torch.float32 else 1e-2 * scale
    finite = bool(torch.isfinite(out).all())
    if not (err <= tol and finite):
        raise AssertionError(f"{tag}: max|d| {err} > {tol} or non-finite output ({finite})")
    return err if dtype == torch.float32 else err / scale


def k2_ops(valid, T: int, tables) -> float:
    """Products of the layer stack over real rows and real keys."""
    L, H, F = tables["wqkv"].shape[0], tables["wqkv"].shape[2], tables["w1"].shape[1]
    rows = float(sum(valid))
    per_layer = 2 * rows * H * (4 * H + 2 * F) + 4 * sum(float(v) * v for v in valid) * H
    return L * per_layer


def k3_ops(B: int, N: int, tables) -> float:
    ops, n, cin = 0.0, N, 1
    for k, s, cout in tables["layers"]:
        n = (n - k) // s + 1
        ops += 2.0 * B * n * cout * k * cin
        cin = cout
    return ops


def phase6(dev) -> float:
    from talkshow_torch.kernels import wav2vec_layers as k2
    enc = w2v_encoder(6, dev)
    gen = torch.Generator().manual_seed(6)
    worst = 0.0
    for B, valid in ((1, [300]), (8, [300 - 30 * i for i in range(8)])):
        x = torch.randn((B, 300, 768), generator=gen).to(dev)
        vf = None if B == 1 else torch.tensor(valid, dtype=torch.int32, device=dev)
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            tables = k2.pack_encoder_tables(enc, dtype)
            out = k2.encoder_layers_kernel(tables, x, vf)
            if not torch.equal(out, k2.encoder_layers_kernel(tables, x, vf)):
                raise AssertionError(f"phase 6 K2 B={B} {dtype}: two runs differ")
            errs[dtype] = check_close(f"phase 6 K2 B={B} {dtype}", out,
                                      k2.encoder_layers_plain(tables, x, vf), valid, dtype)
        worst = max(worst, errs[torch.float32])
        log(f"phase 6 K2 B={B} {'masked ' + str(valid) if vf is not None else 'unmasked'}: "
            f"two runs equal; f32 tables max|d| {errs[torch.float32]:.3e} <= 1e-3, bf16 tables "
            f"max|d|/max|out| {errs[torch.bfloat16]:.3e} <= 1e-2, all rows finite")
    return worst


def gemm_shapes() -> dict:
    """(M, N, K, lda, a_batch, Z) of every product K2 and K3 run at full
    width: K2's four at B = 1 and 8 (T = 300), K3's six strided convs of a
    10 s clip at B = 1 and 8 (overlapping rows, one batch per clip)."""
    shapes = {}
    for B in (1, 8):
        M = 300 * B
        for name, N, K in (("qkv", 2304, 768), ("wo", 768, 768), ("w1", 3072, 768),
                           ("w2", 768, 3072)):
            shapes[f"K2 {name} M={M}"] = (M, N, K, K, 0, 1)
        T_in = 31999
        for i, k in enumerate((3, 3, 3, 3, 2, 2)):
            T_out = (T_in - k) // 2 + 1
            shapes[f"K3 layer{i + 1} B={B}"] = (T_out, 512, k * 512, 1024, T_in * 512, B)
            T_in = T_out
    return shapes


def graph_ms(fn, reps: int = 5) -> float:
    """Device ms of fn() replayed from a captured CUDA graph (host work out)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, reps)


def phase6_gemm(dev, card: str) -> None:
    """The Hopper GEMM that K2 and K3 share, alone, at every product shape
    they run: against torch.matmul on the same bf16 operands in f32 (TF32
    off; only the f32 summation order differs: within 1e-4 of max|C|), and
    its device time from a captured graph of 10 calls."""
    from talkshow_torch.kernels import wav2vec_layers as k2
    gen = torch.Generator().manual_seed(66)
    for name, (M, N, K, lda, ab, Z) in gemm_shapes().items():
        a = torch.randn((Z - 1) * ab + (M - 1) * lda + K, generator=gen).to(dev, torch.bfloat16)
        w = (torch.randn((N, K), generator=gen) / K ** 0.5).to(dev, torch.bfloat16)
        c = k2.gemm_kernel(a, w, M, lda, ab, Z)
        want = a.as_strided((Z, M, K), (ab, lda, 1)).float() @ w.float().T
        err = (c - want).abs().max().item() / want.abs().max().item()
        if not err <= 1e-4:
            raise AssertionError(f"phase 6 gemm {name}: max|d|/max|C| {err}")
        ms = graph_ms(lambda: [k2.gemm_kernel(a, w, M, lda, ab, Z) for _ in range(10)]) / 10
        wg, splits, kt = k2.gemm_plan(M, N, K, Z)
        log(f"phase 6 gemm {name} (M={M} N={N} K={K} z={Z}; {64 * wg}-row tiles, {splits} "
            f"split(s) of {kt} k tiles): max|d|/max|C| {err:.2e} <= 1e-4; {ms * 1e3:.2f} us, "
            f"{2.0 * M * N * K * Z / ms / 1e9:.1f} TFLOP/s [{card}]")


def phase7(dev) -> float:
    from talkshow_torch.kernels import wav2vec_extractor as k3
    enc = w2v_encoder(7, dev)
    worst = 0.0
    for B in (1, 8):
        wave = speech(B, 10.0, 70 + B, dev)
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            tables = k3.pack_extractor_tables(enc.feature_extractor, dtype)
            out = k3.extractor_kernel(tables, wave)
            if out.shape != (B, 499, 512) or not torch.equal(out, k3.extractor_kernel(tables, wave)):
                raise AssertionError(f"phase 7 K3 B={B}: shape {tuple(out.shape)} or runs differ")
            errs[dtype] = check_close(f"phase 7 K3 B={B} {dtype}", out,
                                      k3.extractor_plain(tables, wave), [499] * B, dtype)
        worst = max(worst, errs[torch.float32])
        log(f"phase 7 K3 B={B} 10 s: out (B, 499, 512), two runs equal; f32 tables max|d| "
            f"{errs[torch.float32]:.3e} <= 1e-3, bf16 tables max|d|/max|out| "
            f"{errs[torch.bfloat16]:.3e} <= 1e-2")
    return worst


def phase8(face, wav10: torch.Tensor) -> None:
    """face_apply_fused against the plain face stage, launch counts read
    around each call."""
    from talkshow_torch.kernels import counts
    from talkshow_torch.models.wav2vec_fused import face_apply_fused, pack_face_tables
    dev = wav10.device
    t32, t16 = (pack_face_tables(face, dt) for dt in (torch.float32, torch.bfloat16))
    seconds = [10 - i for i in range(8)]
    masked_wave = torch.zeros((8, 160000), device=dev)
    for i, sec in enumerate(seconds):
        masked_wave[i, :sec * 16000] = wav10[0, :sec * 16000]
    vs = torch.tensor([sec * 16000 for sec in seconds], dtype=torch.int32, device=dev)
    vf = vs * 30 // 16000
    cases = (("unmasked B=1", wav10, {}, [300]),
             ("masked B=8", masked_wave, dict(valid_samples=vs, valid_frames=vf), vf.tolist()))
    for tag, wave, kw, valid in cases:
        onehot = torch.zeros((wave.shape[0], 4), device=dev)
        counts.clear()
        out = face_apply_fused(face, wave, onehot, 300, tables=t32, **kw)
        torch.cuda.synchronize()
        seen = dict(counts)
        with torch.no_grad():
            want = face(wave, onehot, 300, **kw)
        err = check_close(f"phase 8 {tag}", out, want, valid, torch.float32)
        out16 = face_apply_fused(face, wave, onehot, 300, tables=t16, **kw)
        err16 = max((out16[b, :n] - want[b, :n]).abs().max().item() for b, n in enumerate(valid))
        k3_name = "wav2vec_extractor" if not kw else "extractor_plain"
        if not (seen.get("wav2vec_layers", 0) > 0 and seen.get(k3_name, 0) > 0
                and bool(torch.isfinite(out16).all())):
            raise AssertionError(f"phase 8 {tag}: launch counts {seen}")
        log(f"phase 8 face {tag}: face_apply_fused f32 tables vs plain face stage max|d| "
            f"{err:.3e} <= 1e-3 on real frames; counts {dict(sorted(seen.items()))}; "
            f"bf16 tables vs plain (f32) max|d| {err16:.3e} (reported)")


def kernel_breakdown(fn, reps: int = 3) -> str:
    """Device time per kernel name over reps calls (torch.profiler), as
    'name: total ms / launches'; 'not measured' when the trace holds no
    device time."""
    return device_breakdown(fn, reps)[1]


def device_rows(fn, reps: int = 3) -> list:
    """(device ms per call, launches per call, kernel name) of fn()'s
    kernels over reps calls (torch.profiler; a trace of many short launches
    may drop a few), largest first; [] when the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", 0) or getattr(ev, "cuda_time_total", 0)
        if dev_us > 0 and ev.count > 0 and getattr(ev, "device_type", None) is not None \
                and "CUDA" in str(ev.device_type):
            rows.append((dev_us / reps / 1e3, ev.count / reps, ev.key))
    return sorted(rows, reverse=True)


def launches_per_call(fn, reps: int = 20) -> float | None:
    """Kernel launches per fn() call: the CUDA runtime's launch calls that
    torch.profiler records on the host, over reps calls; None when it
    records none."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    n = sum(ev.count for ev in prof.key_averages() if ev.key.startswith("cudaLaunch"))
    return n / reps if n else None


def device_breakdown(fn, reps: int = 3) -> tuple[float | None, str]:
    """(device ms per call, kernel_breakdown's text); None when the trace
    holds no device time."""
    rows = device_rows(fn, reps)
    if not rows:
        return None, "not measured"
    total = sum(r[0] for r in rows)
    return total, f"total {total:.3f} ms; " + "; ".join(
        f"{key[:60]}: {ms:.3f} ms / {n:g}" for ms, n, key in rows[:8])


def idle_line(fn, wall_ms: float, reps: int = 3) -> str:
    """fn()'s device time by kernel (torch.profiler) and its device-idle
    share, 1 - device time / wall_ms."""
    dev_ms, text = device_breakdown(fn, reps)
    idle = "not measured" if dev_ms is None else f"{1 - dev_ms / wall_ms:.1%}"
    return f"device idle {idle} of {wall_ms:.2f} ms; {text}"


def library_encoder(tables, dtype):
    """nn.TransformerEncoder with K2's weights: the library yardstick."""
    L, _, H = tables["wqkv"].shape
    layer = torch.nn.TransformerEncoderLayer(H, tables["heads"], tables["w1"].shape[1],
                                             dropout=0.0, activation="gelu",
                                             layer_norm_eps=tables["eps"], batch_first=True,
                                             norm_first=False)
    lib = torch.nn.TransformerEncoder(layer, L, enable_nested_tensor=False)
    with torch.no_grad():
        for l, m in enumerate(lib.layers):
            m.self_attn.in_proj_weight.copy_(tables["wqkv"][l])
            m.self_attn.in_proj_bias.copy_(tables["bqkv"][l])
            m.self_attn.out_proj.weight.copy_(tables["wo"][l])
            m.self_attn.out_proj.bias.copy_(tables["bo"][l])
            m.linear1.weight.copy_(tables["w1"][l])
            m.linear1.bias.copy_(tables["b1"][l])
            m.linear2.weight.copy_(tables["w2"][l])
            m.linear2.bias.copy_(tables["b2"][l])
            for norm, p in ((m.norm1, tables["ln1"][l]), (m.norm2, tables["ln2"][l])):
                norm.weight.copy_(p[0])
                norm.bias.copy_(p[1])
    return lib.to(tables["wqkv"].device, dtype).eval()


def phase9(face, card: str) -> dict:
    """Times at B = 1 and 8 (bf16 tables), in the order plain, kernel,
    kernel, plain; returns the B = 1 numbers of K2 and K3 for the JSON."""
    from talkshow_torch.kernels import wav2vec_extractor as k3
    from talkshow_torch.kernels import wav2vec_layers as k2
    from talkshow_torch.models.wav2vec_fused import face_apply_fused, pack_face_tables
    dev = next(face.parameters()).device
    enc = face.audio_encoder
    t16 = pack_face_tables(face, torch.bfloat16)
    t32 = k2.pack_encoder_tables(enc, torch.float32)
    lib16, lib32 = library_encoder(t16["enc"], torch.bfloat16), library_encoder(t32, torch.float32)
    gen = torch.Generator().manual_seed(9)
    res = {}
    for B in (1, 8):
        x = torch.randn((B, 300, 768), generator=gen).to(dev)
        wave = speech(B, 10.0, 90 + B, dev)
        onehot = torch.zeros((B, 4), device=dev)
        pad = torch.zeros((B, 300), dtype=torch.bool, device=dev)
        with torch.no_grad():
            lib_err = (lib32(x, src_key_padding_mask=pad)
                       - k2.encoder_layers_plain(t32, x)).abs().max().item()
            x16 = x.to(torch.bfloat16)
            rows = {
                "K2 wav2vec_layers": (lambda: k2.encoder_layers_kernel(t16["enc"], x),
                                      lambda: k2.encoder_layers_plain(t16["enc"], x)),
                "K3 wav2vec_extractor": (lambda: k3.extractor_kernel(t16["ext"], wave),
                                         lambda: k3.extractor_plain(t16["ext"], wave)),
                "face_apply_fused": (lambda: face_apply_fused(face, wave, onehot, 300,
                                                              tables=t16),
                                     lambda: face(wave, onehot, 300)),
            }
            for name, (kern, plain) in rows.items():
                p1, k1, k2_, p2 = cuda_ms(plain), cuda_ms(kern, 5), cuda_ms(kern, 5), cuda_ms(plain)
                res[(name, B)] = ((k1 + k2_) / 2, (p1 + p2) / 2)
                extra = ""
                if name.startswith("K2"):
                    lib_ms = cuda_ms(lambda: lib16(x16, src_key_padding_mask=pad), 5)
                    lib_graph = graph_ms(lambda: lib16(x16))
                    res[("library", B)] = lib_ms
                    extra = (f"; library nn.TransformerEncoder bf16 {lib_ms:.3f} ms eager, "
                             f"{lib_graph:.3f} ms replayed from a CUDA graph (its f32 output vs "
                             f"the plain f32 stack max|d| {lib_err:.2e})")
                log(f"phase 9 {name} B={B}: kernel (bf16 tables) {k1:.3f} / {k2_:.3f} ms, "
                    f"plain {p1:.3f} / {p2:.3f} ms{extra} [{card}]")
            for name, fn in (("K2", rows["K2 wav2vec_layers"][0]),
                             ("K3", rows["K3 wav2vec_extractor"][0])):
                dev_ms, text = device_breakdown(fn)
                idle = ("not measured" if dev_ms is None else
                        f"{1 - dev_ms / cuda_ms(fn, 5):.1%} of the call's wall time")
                log(f"phase 9 {name} B={B} device time by kernel: {text}; device idle {idle} "
                    f"[{card}]")
    res["x1"] = torch.randn((1, 300, 768), generator=gen).to(dev)
    res["t16"] = t16
    return res


def code_distances(x, emb, e2):
    """-2 x.E^T + ||e||^2, the f32 expression both K4 versions minimise."""
    return -2.0 * (x @ emb.T) + e2[None, :]


def check_codes(tag: str, idx, x, emb, e2, want=None) -> tuple[int, int, float]:
    """Hold indices to the plain distance matrix of (x, emb): on every row
    the picked code's distance within 1e-5 (1 + |best|) of the row's
    minimum; against `want`, equal except on near-tie rows (best and
    second-best within that tolerance).  Returns (near-tie rows, rows that
    differ from want, largest distance excess of a pick)."""
    dist = code_distances(x, emb, e2)
    top2 = dist.topk(2, dim=1, largest=False).values
    tol = 1e-5 * (1 + top2[:, 0].abs())
    near = (top2[:, 1] - top2[:, 0]) <= tol
    excess = dist.gather(1, idx[:, None])[:, 0] - top2[:, 0]
    if not bool((excess <= tol).all()):
        raise AssertionError(f"{tag}: a picked code is {excess.max().item()} past the minimum")
    differ = 0
    if want is not None:
        diff = idx != want
        if bool((diff & ~near).any()):
            raise AssertionError(f"{tag}: indices differ on {int((diff & ~near).sum())} rows "
                                 f"that are not near-ties")
        differ = int(diff.sum())
    return int(near.sum()), differ, excess.max().item()


def phase10(dev) -> float:
    """K4 against its plain version at full width; returns the largest
    distance excess of the kernel's picks."""
    from talkshow_torch.kernels import nearest_code as k4
    K, D = TRAIN["codes"], TRAIN["dim"]
    gen = torch.Generator().manual_seed(10)
    limit = (6.0 / (K + D)) ** 0.5               # init_vq_state's codebook
    emb0 = (torch.rand((K, D), generator=gen) * 2 - 1) * limit
    dup = torch.arange(8) * 7
    emb0[K - 8:] = emb0[dup]                     # exact duplicates: the lower index must win
    emb0 = emb0.to(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    worst = 0.0
    for N, Kc in ((1, K), (75, K), (2816, K), (75, K - 1), (2816, K - 1)):
        emb = emb0[:Kc]                          # K - 1: a ragged last slice
        e2 = k4.code_norms(emb)
        plan = k4.search_plan(N, Kc, D, sms)
        twins = [(int(a), b) for a, b in zip(dup, range(K - 8, Kc))]
        if plan.cluster < 2 or any(a // plan.slice == b // plan.slice for a, b in twins):
            raise AssertionError(f"phase 10 K4 N={N} K={Kc}: a duplicated code shares its "
                                 f"twin's slice ({plan})")
        x = 0.05 * torch.randn((N, D), generator=gen)
        n8 = min(N, 8)
        x[:n8] = emb0[dup[:n8]].cpu()            # rows sitting on a duplicated code
        x = x.to(dev)
        idx = k4.nearest_code_kernel(x, emb)
        again = k4.nearest_code_kernel(x, emb)
        plain = k4.nearest_code_plain(x, emb, e2)
        torch.cuda.synchronize()
        if not (torch.equal(idx, again) and torch.equal(idx[:n8].cpu(), dup[:n8])):
            raise AssertionError(f"phase 10 K4 N={N} K={Kc}: runs differ or a tie took the "
                                 f"higher index")
        near, differ, excess = check_codes(f"phase 10 K4 N={N} K={Kc}", idx, x, emb, e2, plain)
        worst = max(worst, excess)
        log(f"phase 10 K4 N={N} codebook ({Kc}, {D}), plan {plan.rows}-row tiles x cluster "
            f"{plan.cluster} of {plan.slice} codes = {plan.ctas} CTAs, {plan.smem} B shared: "
            f"two runs equal bit for bit, exact ties across slices take the lower index, "
            f"indices equal to plain on {N - differ}/{N} rows ({differ} differ, all near-ties; "
            f"{near} near-tie rows; the kernel sums ||e||^2 itself in depth order, the plain "
            f"version with torch.sum, so e2 may differ by ulps), largest distance excess of a "
            f"pick {excess:.3e} <= 1e-5 (1 + |best|)")
    return worst


def write_stage_config(path: str, model_name: str, epochs: int, rep6d: bool = False) -> None:
    cfg = {"Data": {"pose": {"generate_length": TRAIN["window"], "convert_to_6d": rep6d}},
           "Model": {"model_name": model_name, "code_num": TRAIN["codes"],
                     "encoder_choice": "faceformer" if model_name == "s2g_face" else "mfcc"},
           "DataLoader": {"batch_size": TRAIN["batch"]},
           "Train": {"epochs": epochs, "learning_rate": {"generator_learning_rate": 1e-4}},
           "Log": {"save_every": 1, "print_every": 5, "name": model_name}}
    with open(path, "w") as f:
        json.dump(cfg, f)


def logged_values(run_dir: str) -> list:
    """Every number train.log and history.json hold."""
    import re
    with open(os.path.join(run_dir, "train.log")) as f:
        vals = [float(v) for line in f for _, v in re.findall(r"(\w+)=(\S+)", line)]
    with open(os.path.join(run_dir, "history.json")) as f:
        vals += [v for h in json.load(f) for k, v in h.items() if k != "epoch"]
    return vals


def flat_state(state) -> dict:
    out = {}
    for part, model in state.models.items():
        out.update({f"{part}.{k}": v for k, v in model.state_dict().items()})
        out.update({f"{part}.vq.{k}": v for k, v in state.vq[part]._asdict().items()})
    return out


def adam_once_a_step(seen: dict, steps: int) -> bool:
    """The counts of a run of full-width Adam steps: one launch of each
    Adam kernel a step (every leaf list fits one launch), no plain call."""
    return (seen.get("grad_stats", 0) == seen.get("adam_apply", 0) == steps
            and not seen.get("grad_stats_plain") and not seen.get("adam_apply_plain"))


def phase11(dev, tmp: str) -> dict:
    """Stage-1 training through `python -m talkshow_torch.train`'s entry
    point at full width; resume; one step CUDA against CPU; the token
    encode.  Returns what phase 12 times and the K4 launch count."""
    import copy

    from talkshow_torch.kernels import counts
    from talkshow_torch.kernels.nearest_code import code_norms, nearest_code_plain
    from talkshow_torch.models.vqvae import VQVAE
    from talkshow_torch.ops import vq as vq_ops
    from talkshow_torch.ops.pose import BODY_DIM, HAND_DIM
    from talkshow_torch.train.__main__ import main as train_main
    from talkshow_torch.train.steps import (PARTS, conv_channels, make_body_vq_step,
                                            make_token_encoder, part_losses)
    cfg = os.path.join(tmp, "body_vq.json")
    write_stage_config(cfg, "s2g_body_vq", 1)
    run_a, run_b = os.path.join(tmp, "run_a"), os.path.join(tmp, "run_b")
    argv = ["--config_file", cfg, "--synthetic", "--epochs", "1", "--device", str(dev)]
    counts.clear()
    t0 = time.time()
    trainer = train_main(argv + ["--run_dir", run_a])
    torch.cuda.synchronize()
    seen, steps = dict(counts), trainer.global_step
    width = trainer.state.models["body"].encoder.pre_vq_conv.in_channels
    if (steps < 10 or width != TRAIN["num_hiddens"] or seen.get("nearest_code", 0) != 2 * steps
            or seen.get("nearest_code_plain", 0) or not adam_once_a_step(seen, steps)):
        raise AssertionError(f"phase 11: {steps} steps, width {width}, counts {seen}")
    logged = logged_values(run_a)
    ckpt = os.path.join(run_a, "ckpt-0.pt")
    if not (logged and all(math.isfinite(v) for v in logged) and os.path.isfile(ckpt)):
        raise AssertionError(f"phase 11: logged values {logged[:12]}, checkpoint "
                             f"{os.path.isfile(ckpt)}")
    log(f"phase 11 train: python -m talkshow_torch.train s2g_body_vq, batch {TRAIN['batch']}, "
        f"window {TRAIN['window']}, num_hiddens {TRAIN['num_hiddens']}: {steps} steps in "
        f"{time.time() - t0:.1f} s (first cuDNN calls included); "
        f"{len(logged)} logged values all finite; nearest_code launches "
        f"{seen['nearest_code']} = 2 x {steps}, plain calls 0; grad_stats and adam_apply "
        f"launches {seen['adam_apply']} = {steps}, plain calls 0; {os.path.basename(ckpt)} "
        f"written")

    # resume + one step == the uninterrupted run's next step
    resumed = train_main(argv + ["--run_dir", run_b, "--resume", ckpt])
    batch = next(trainer.dataset.batches(TRAIN["batch"], np.random.default_rng(99)))
    batch = {"poses": batch["poses"]}
    _, m_a = trainer.step_fn(trainer.state, trainer.put_batch(batch))
    _, m_b = resumed.step_fn(resumed.state, resumed.put_batch(batch))
    fa, fb = flat_state(trainer.state), flat_state(resumed.state)
    same = all(float(m_a[k]) == float(m_b[k]) for k in m_a) and all(
        torch.equal(v, fb[k]) for k, v in fa.items())
    if not same:
        raise AssertionError("phase 11: resume + one step differs from the uninterrupted run")
    log(f"phase 11 resume: ckpt-0 + one step equals the uninterrupted run's next step bit for "
        f"bit ({len(fa)} tensors, {len(m_a)} metrics)")
    del resumed

    # one step from one state, CUDA against CPU (B = 8, full width, TF32 off)
    lr = 1e-4

    def fresh(device):
        vb = VQVAE(BODY_DIM, TRAIN["dim"], TRAIN["num_hiddens"])
        vh = VQVAE(HAND_DIM, TRAIN["dim"], TRAIN["num_hiddens"])
        init, step = make_body_vq_step(vb, vh, lr, code_num=TRAIN["codes"])
        return init(torch.Generator().manual_seed(11), device), step

    (s_cpu, step_cpu), (s_gpu, step_gpu) = fresh("cpu"), fresh(dev)
    poses8 = torch.as_tensor(batch["poses"][:8])
    conv8 = conv_channels(poses8)
    skip_codes, idx_note = {}, []
    for name, sl in PARTS:
        with torch.no_grad():
            zc = copy.deepcopy(s_cpu.models[name]).train().encoder(conv8[..., sl])
            zg = copy.deepcopy(s_gpu.models[name]).train().encoder(conv8[..., sl].to(dev))
        zc = zc.reshape(-1, TRAIN["dim"])
        emb = s_cpu.vq[name].embeddings
        want = nearest_code_plain(zc, emb)
        got = vq_ops.nearest_code(zg.reshape(-1, TRAIN["dim"]), s_gpu.vq[name].embeddings).cpu()
        near, differ, _ = check_codes(f"phase 11 {name} indices", got, zc, emb, code_norms(emb),
                                      want)
        skip_codes[name] = torch.cat([want[got != want], got[got != want]]).unique()
        idx_note.append(f"{name} {zc.shape[0] - differ}/{zc.shape[0]} equal ({near} near-ties)")
    # f64 reference gradients on the CPU: the encoder's (behind the
    # straight-through estimator and three levels of batch-statistics
    # BatchNorm, 1024 channels at 176 positions) carry ~1e-2 of max|g| of
    # f32 rounding on either device; the decoder's ~1e-4
    g64 = {}
    for name, sl in PARTS:
        m64 = copy.deepcopy(s_cpu.models[name]).double().train()
        vq64 = vq_ops.VQState(*(t.double() if t.is_floating_point() else t
                                for t in s_cpu.vq[name]))
        sum(part_losses(m64, vq64, conv8[..., sl].double())[:3]).backward()
        g64[name] = {k: p.grad for k, p in m64.named_parameters()}
        del m64
    _, mc = step_cpu(s_cpu, {"poses": poses8})
    _, mg = step_gpu(s_gpu, {"poses": poses8.to(dev)})
    rel = max(abs(float(mg[k]) - float(mc[k])) / max(abs(float(mc[k])), 1e-12)
              for k in mc if k != "nonfinite_skips")
    g_err = dec_err = enc_gpu = enc_cpu = p_err = stat_err = vq_err = 0.0
    within, total = 0, 0
    for name, _ in PARTS:
        pc = dict(s_cpu.models[name].named_parameters())
        pg = dict(s_gpu.models[name].named_parameters())
        gmax = max(g.abs().max().item() for g in g64[name].values())
        for k, p in pc.items():
            gc, gg, gr = p.grad.double(), pg[k].grad.cpu().double(), g64[name][k]
            g_err = max(g_err, (gg - gc).abs().max().item() / gmax)
            if k.startswith("decoder."):
                dec_err = max(dec_err, (gg - gc).abs().max().item() / gmax)
            else:
                enc_gpu = max(enc_gpu, (gg - gr).abs().max().item() / gmax)
                enc_cpu = max(enc_cpu, (gc - gr).abs().max().item() / gmax)
            d = (pg[k].detach().cpu() - p.detach()).abs()
            p_err = max(p_err, d.max().item())
            within += int((d <= 1e-2 * lr).sum())
            total += d.numel()
        bc, bg = s_cpu.models[name].state_dict(), s_gpu.models[name].state_dict()
        stat_err = max(stat_err, max((bg[k].cpu() - v).abs().max().item() for k, v in bc.items()
                                     if k.endswith(("running_mean", "running_var"))))
        keep = torch.ones(TRAIN["codes"], dtype=torch.bool)
        keep[skip_codes[name]] = False
        for a, b in zip(s_gpu.vq[name], s_cpu.vq[name]):
            a = a.cpu()
            vq_err = max(vq_err, (a[keep].double() - b[keep].double()).abs().max().item()
                         if a.dim() else abs(int(a) - int(b)))
    # Adam's first step moves a parameter by at most lr; 1e-3 of it covers
    # the rounding of the stored values.  It moves each by about lr sign(g),
    # so only parameters whose gradient is near zero beside its f32 rounding
    # (conv biases under batch-statistics BatchNorm, small encoder
    # gradients) may take another sign on the card: at least 99 % must land
    # within 1e-2 lr of the CPU's, which a missing, scaled or reversed
    # update fails
    share = within / total
    if not (rel <= 1e-4 and dec_err <= 1e-3 and enc_gpu <= 2e-2 and stat_err <= 1e-4
            and vq_err <= 1e-4 and p_err <= 2 * lr * (1 + 1e-3) and share >= 0.99):
        raise AssertionError(f"phase 11 CUDA vs CPU: losses rel {rel}, decoder grads {dec_err} "
                             f"of max, encoder grads vs f64 {enc_gpu} (CPU f32 {enc_cpu}), "
                             f"statistics {stat_err}, VQ states {vq_err}, params {p_err}, "
                             f"share within 1e-2 lr {share}")
    log(f"phase 11 CUDA vs CPU, one step from one state (B=8, T={TRAIN['window']}, full width, "
        f"TF32 off): indices {', '.join(idx_note)}; losses within {rel:.2e} relative <= 1e-4; "
        f"decoder gradients within {dec_err:.2e} of max|g| <= 1e-3; encoder gradients vs an "
        f"f64 CPU reference within {enc_gpu:.2e} of max|g| <= 2e-2 (the CPU's f32: "
        f"{enc_cpu:.2e}); all gradients CUDA vs CPU within {g_err:.2e} (reported); BatchNorm "
        f"statistics within {stat_err:.2e}, VQ states within {vq_err:.2e} <= 1e-4 (codes of "
        f"differing rows left out: {sum(len(v) for v in skip_codes.values())}); parameters "
        f"within {p_err:.2e} <= 2 lr = {2 * lr:g}, {share:.4%} of them within 1e-2 lr = "
        f"{1e-2 * lr:g} >= 99 %")
    del s_cpu, s_gpu

    # the frozen-token encode
    enc = make_token_encoder(trainer.state.models["body"], trainer.state.models["hand"],
                             trainer.state.vq)
    poses128 = torch.as_tensor(batch["poses"], device=dev)
    counts.clear()
    tok = enc(poses128)
    torch.cuda.synchronize()
    if counts["nearest_code"] != 2 or tuple(tok.shape) != (TRAIN["batch"], TRAIN["window"] // 4, 2):
        raise AssertionError(f"phase 11 token encode: shape {tuple(tok.shape)}, counts {dict(counts)}")
    log(f"phase 11 token encode: make_token_encoder on B={TRAIN['batch']} -> "
        f"{tuple(tok.shape)} int64, nearest_code launches {counts['nearest_code']}")
    return dict(trainer=trainer, batch=batch, encode=enc, poses=poses128,
                launches=seen["nearest_code"], steps=steps)


def phase12(train: dict, card: str) -> dict:
    """Times: the body-VQ step, K4 against its plain version and the
    two-call yardstick, the token encode; returns K4's numbers at N = 2816."""
    from talkshow_torch.kernels import nearest_code as k4
    from talkshow_torch.ops import vq as vq_ops
    trainer = train["trainer"]
    batch = trainer.put_batch(train["batch"])
    times = []
    for _ in range(11):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        trainer.step_fn(trainer.state, batch)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    p50 = float(np.median(times[1:]))
    log(f"phase 12 body-VQ step B={TRAIN['batch']} T={TRAIN['window']}: p50 {p50:.2f} ms over "
        f"{len(times) - 1} steps (min {min(times[1:]):.2f}, max {max(times[1:]):.2f}), "
        f"{TRAIN['batch'] / p50 * 1e3:.1f} windows/s [{card}]")
    log(f"phase 12 body-VQ step device time by kernel: "
        f"{kernel_breakdown(lambda: trainer.step_fn(trainer.state, batch), reps=1)} [{card}]")
    # for the record only, how the step time splits between determinism and
    # precision: cuDNN free to pick non-deterministic algorithms (by its
    # heuristics, then by timing them), still f32; then TF32 on, deterministic
    # again.  Both change what the port is held to (bit-equal resume, f32 sums)
    step_once = lambda: trainer.step_fn(trainer.state, batch)   # noqa: E731
    cudnn = torch.backends.cudnn
    cudnn.deterministic = False
    nondet_ms = cuda_ms(step_once, 5)
    cudnn.benchmark = True          # cuda_ms's warm-up call times the algorithms
    bench_ms = cuda_ms(step_once, 5)
    cudnn.deterministic, cudnn.benchmark = True, False
    torch.backends.cuda.matmul.allow_tf32 = cudnn.allow_tf32 = True
    tf32_ms = cuda_ms(step_once, 5)
    torch.backends.cuda.matmul.allow_tf32 = cudnn.allow_tf32 = False
    log(f"phase 12 body-VQ step, not the port's settings: TF32 off with cuDNN's "
        f"non-deterministic algorithms {nondet_ms:.2f} ms (heuristic choice), "
        f"{bench_ms:.2f} ms (cudnn.benchmark); TF32 on, deterministic {tf32_ms:.2f} ms "
        f"[{card}]")
    emb = trainer.state.vq["body"].embeddings
    e2 = k4.code_norms(emb)
    gen = torch.Generator().manual_seed(12)
    res = {}
    for N in (75, 2816):
        x = (0.05 * torch.randn((N, TRAIN["dim"]), generator=gen)).to(emb.device)
        kern = lambda: k4.nearest_code_kernel(x, emb)             # noqa: E731
        step_call = lambda: vq_ops.nearest_code(x, emb)           # noqa: E731
        plain = lambda: k4.nearest_code_plain(x, emb, e2)         # noqa: E731
        lib = lambda: torch.argmin(torch.addmm(e2, x, emb.T, alpha=-2), 1)  # noqa: E731
        # in turns: plain, kernel, yardstick, step call, step call, yardstick, kernel, plain
        p1, k1, l1, o1 = (cuda_ms(f, 50) for f in (plain, kern, lib, step_call))
        o2, l2, k2, p2 = (cuda_ms(f, 50) for f in (step_call, lib, kern, plain))
        res[N] = ((k1 + k2) / 2, (p1 + p2) / 2, (l1 + l2) / 2, x)
        bms, by = bound(nbytes(x, emb) + N * 8, 2.0 * N * emb.numel() + 2.0 * emb.numel(),
                        F32_FLOP_S)
        log(f"phase 12 K4 nearest_code N={N} K={TRAIN['codes']} D={TRAIN['dim']}: kernel "
            f"{k1:.4f} / {k2:.4f} ms, through ops/vq.nearest_code (the step's call, ||e||^2 "
            f"included) {o1:.4f} / {o2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms, two-call "
            f"yardstick argmin(addmm) {l1:.4f} / {l2:.4f} ms; bound {bms:.4f} ms ({by}), the "
            f"kernel at {bms / ((k1 + k2) / 2):.1%} of it [{card}]")
        launches = launches_per_call(step_call)
        if launches is not None and round(launches) != 1:
            raise AssertionError(f"phase 12 K4 N={N}: ops/vq.nearest_code launched {launches:g} "
                                 f"kernels a call")
        log(f"phase 12 K4 N={N} ops/vq.nearest_code device time by kernel: "
            f"{kernel_breakdown(step_call, reps=20)}; kernel launches a call (CUDA runtime "
            f"calls in the trace) {'not measured' if launches is None else f'{launches:g}'} "
            f"[{card}]")
    # why search_plan takes 8-row tiles at N = 75, 64-row tiles at 300, and
    # two passes a CTA at 2816: each choice's device time a launch
    K, D = emb.shape
    sms = torch.cuda.get_device_properties(emb.device).multi_processor_count
    alts = []
    for N, plans in ((75, [k4.tile_plan(75, K, D, 1), k4.tile_plan(75, K, D, 0)]),
                     (300, [k4.tile_plan(300, K, D, 1), k4.tile_plan(300, K, D, 0)]),
                     (2816, [k4.tile_plan(2816, K, D, 0), k4.tile_plan(2816, K, D, 0, 2)])):
        x = (0.05 * torch.randn((N, D), generator=gen)).to(emb.device)
        idx = torch.empty((N,), dtype=torch.int64, device=emb.device)
        for plan in plans:
            launch = lambda: k4._lib().talkshow_nearest_code(       # noqa: E731
                N, K, D, plan.variant, plan.cluster, plan.slice, x.data_ptr(), emb.data_ptr(),
                idx.data_ptr(), emb.device.index,
                torch._C._cuda_getCurrentRawStream(emb.device.index))
            if launch() or not torch.equal(idx, k4.nearest_code_plain(x, emb, e2)):
                raise AssertionError(f"phase 12 K4 N={N} {plan}: refused or not the plain indices")
            rows = device_rows(launch, reps=50)
            us = "not measured" if not rows else f"{rows[0][0] / rows[0][1] * 1e3:.2f} us"
            chosen = " (search_plan's)" if plan == k4.search_plan(N, K, D, sms) else ""
            alts.append(f"N={N} {plan.rows}-row tiles x cluster {plan.cluster}, {plan.passes} "
                        f"pass(es), {plan.ctas} CTAs{chosen}: {us}")
    log(f"phase 12 K4 plans, device time a launch: {'; '.join(alts)} [{card}]")
    enc_ms = cuda_ms(lambda: train["encode"](train["poses"]), 10)
    log(f"phase 12 token encode B={TRAIN['batch']} T={TRAIN['window']}: {enc_ms:.3f} ms [{card}]")
    res["emb"] = emb
    return res


def plain_face_pipeline(pipe):
    """`pipe` with the plain face stage on the card (FaceGenerator.forward,
    cuDNN / cuBLAS in f32, TF32 off): the parent's `generate`, for timing
    beside the fused one.  Shares the modules and the decode tables."""
    import dataclasses
    other = dataclasses.replace(pipe)
    other.__dict__["_decode_tables"] = pipe._decode_tables

    def plain(wav, onehot, frames, valid_samples=None, valid_frames=None):
        with torch.no_grad():
            return pipe.face_model(wav, onehot, frames, valid_samples, valid_frames)

    other.face_stage = plain
    return other


def generate_p50(pipe, plain, wav: str, S: int, runs: int) -> dict:
    """(p50, min, max) ms of generate() with the fused and with the plain
    face stage, CUDA events around each call, a fresh seed per run, the two
    in turns (fused, plain, plain, fused, ...) after one warm-up call each."""
    times = {"fused": [], "plain": []}
    for p in (pipe, plain):
        p.generate(wav, speaker="oliver", num_samples=S, seed=1)
    for i in range(runs):
        order = [("fused", pipe), ("plain", plain)]
        for name, p in (order if i % 2 == 0 else order[::-1]):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            p.generate(wav, speaker="oliver", num_samples=S, seed=100 * S + i)
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end))
    return {k: (float(np.median(v)), min(v), max(v)) for k, v in times.items()}


def phase13(pipe, wav10: str, card: str) -> dict:
    """Continuity at full width on the 10 s clip; returns the launch counts
    of one generate(continuity=True)."""
    from talkshow_torch.kernels import counts
    from talkshow_torch.ops.audio import get_mfcc_sepa
    counts.clear()
    motion = pipe.generate(wav10, speaker="oliver", num_samples=1, seed=13, continuity=True)
    torch.cuda.synchronize()
    seen = dict(counts)
    feat, gap = get_mfcc_sepa(wav10, sr=22000, device=pipe.device)
    conv, tok0, tok = pipe.generate_conv_continuity(feat, gap, 0, 1, seed=13)
    h0 = gap // 4
    if not (seen.get("ar_decode") == 2 and not seen.get("sample_tokens_plain")
            and seen.get("wav2vec_layers") == 1 and not seen.get("face_plain")
            and motion.shape == (1, 300, 265) and np.isfinite(motion).all()
            and tok0.shape[1] == h0 and torch.equal(tok[:, :h0], tok0)
            and bool(torch.isfinite(conv).all())):
        raise AssertionError(f"phase 13 continuity: counts {seen}, motion {motion.shape}, "
                             f"prefix rows kept {torch.equal(tok[:, :h0], tok0)}")
    times = []
    for i in range(6):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        pipe.generate(wav10, speaker="oliver", num_samples=1, seed=300 + i, continuity=True)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    from talkshow_torch.ops.audio import get_mfcc
    feat1 = get_mfcc(wav10, device=pipe.device)
    stages = {"get_mfcc_sepa": cuda_ms(lambda: get_mfcc_sepa(wav10, sr=22000,
                                                             device=pipe.device), 3),
              "get_mfcc": cuda_ms(lambda: get_mfcc(wav10, device=pipe.device), 3),
              "generate_conv_continuity": cuda_ms(lambda: pipe.generate_conv_continuity(
                  feat, gap, 0, 1, seed=14), 3),
              "generate_conv": cuda_ms(lambda: pipe.generate_conv(feat1, 0, 1, seed=14), 3)}
    log(f"phase 13 continuity: generate(continuity=True) on the 10 s clip -> {motion.shape}, "
        f"finite; gap {gap} feature frames, so the second decode's first {h0} of "
        f"{tok.shape[1]} rows equal the first decode's tokens; counts "
        f"{dict(sorted(seen.items()))}; p50 {float(np.median(times[1:])):.2f} ms over "
        f"{len(times) - 1} runs; stages (ms) " + ", ".join(f"{k} {v:.2f}" for k, v in
                                                             stages.items()) + f" [{card}]")
    return seen


#: MotionServer requests of phase 14 (seconds of the 10 s clip): buckets of 32
#: frames 96, 96, 160, 160, 224, 224, 320, 320
SERVE_SECONDS = (3.0, 3.2, 5.0, 5.3, 7.0, 7.1, 10.0, 9.8)


def phase14(pipe, wav10: str, card: str) -> dict:
    """MotionServer(bucket_frames=32, max_batch=8) at full width; returns
    the launch counts of one flush."""
    from talkshow_torch.kernels import counts
    from talkshow_torch.models import body as body_mod
    from talkshow_torch.ops.audio import load_wav
    from talkshow_torch.serving import MotionServer
    wav, _ = load_wav(wav10)
    server = MotionServer(pipe, bucket_frames=32, max_batch=8)
    t0 = time.perf_counter()
    n = server.warmup(10.0)
    log(f"phase 14 serve: warmup(10) ran {n} buckets at max_batch 8 in "
        f"{time.perf_counter() - t0:.1f} s [{card}]")
    clips = [wav[:int(16000 * sec)] for sec in SERVE_SECONDS]
    buckets = [-(-(len(c) * 30 // 16000) // 32) * 32 for c in clips]
    groups = sum(-(-buckets.count(b) // 8) for b in set(buckets))
    batches, fused = [], body_mod.sample_tokens_fused

    def spy(model, label, audio, **kw):
        batches.append(audio.shape[0])
        return fused(model, label, audio, **kw)

    body_mod.sample_tokens_fused = spy
    try:
        rids = [server.submit(c, speaker=i % 4) for i, c in enumerate(clips)]
        counts.clear()
        out = server.flush(seed=0)
        torch.cuda.synchronize()
        seen = dict(counts)
    finally:
        body_mod.sample_tokens_fused = fused
    shapes_ok = all(out[r].shape == (len(c) * 30 // 16000, 265) and np.isfinite(out[r]).all()
                    for r, c in zip(rids, clips))
    if not (shapes_ok and len(out) == len(clips) and seen.get("ar_decode") == groups
            and batches == [8] * groups and seen.get("wav2vec_layers") == groups
            and seen.get("extractor_plain") == groups and not seen.get("sample_tokens_plain")
            and not seen.get("face_plain")):
        raise AssertionError(f"phase 14 serve: shapes ok {shapes_ok}, {groups} groups, decode "
                             f"batches {batches}, counts {seen}")
    log(f"phase 14 serve: {len(clips)} requests of {min(SERVE_SECONDS)}-{max(SERVE_SECONDS)} s "
        f"in buckets {sorted(set(buckets))}, one flush -> (frames, 265) each, finite; "
        f"{groups} groups, K1 launched once a group at B = {sorted(set(batches))}; counts "
        f"{dict(sorted(seen.items()))}")
    # one clip's served face frames against its unpadded face stage, f32 tables
    p32 = pipe.with_face_dtype(torch.float32)
    s32 = MotionServer(p32, bucket_frames=32, max_batch=8)
    clip = clips[3]
    rid = s32.submit(clip, speaker=0)
    served = s32.flush(seed=0)[rid]
    want = p32.generate_face(clip)
    with torch.no_grad():
        plain = pipe.face_model(torch.as_tensor(clip, device=pipe.device)[None],
                                torch.zeros((1, 4), device=pipe.device),
                                len(clip) * 30 // 16000)[0].cpu().numpy()
    errs = [max(np.abs(served[:, :3] - w[:, :3]).max(), np.abs(served[:, -100:] - w[:, 3:]).max())
            for w in (want, plain)]
    if not max(errs) <= 1e-3:
        raise AssertionError(f"phase 14 serve face: served vs unpadded max|d| {errs}")
    log(f"phase 14 serve face: a {SERVE_SECONDS[3]} s clip served in bucket {buckets[3]} "
        f"(masked, f32 tables) vs its unpadded fused face stage max|d| {errs[0]:.2e}, vs the "
        f"unpadded plain stage {errs[1]:.2e}, <= 1e-3")
    del s32, p32
    times = []
    for i in range(6):
        for c in clips:
            server.submit(c, speaker=0)
        t0 = time.perf_counter()
        server.flush()
        times.append((time.perf_counter() - t0) * 1e3)
    p50 = float(np.median(times[1:]))
    log(f"phase 14 serve flush of {len(clips)} requests ({groups} groups of 8): p50 {p50:.2f} ms "
        f"over {len(times) - 1} flushes (min {min(times[1:]):.2f}, max {max(times[1:]):.2f}; "
        f"host clock, readback included), {len(clips) / p50 * 1e3:.1f} requests/s, "
        f"{sum(SERVE_SECONDS) / p50 * 1e3:.1f} audio-seconds/s [{card}]")

    def flush():
        for c in clips:
            server.submit(c, speaker=0)
        server.flush()

    log(f"phase 14 serve flush device time by kernel: {idle_line(flush, p50)} [{card}]")
    return seen


def phase15(pipe, wav10: str, card: str) -> dict:
    """StreamingSession(chunk_rows=8, context_rows=16) on the 10 s clip fed in
    1.07 s chunks; returns the launch counts of the session."""
    from talkshow_torch.kernels import counts
    from talkshow_torch.kernels import wav2vec_extractor as k3
    from talkshow_torch.kernels import wav2vec_layers as k2
    from talkshow_torch.models.wav2vec_fused import pack_face_tables
    from talkshow_torch.ops.audio import load_wav
    from talkshow_torch.streaming import StreamingSession, samples_for
    wav, _ = load_wav(wav10)
    sess = StreamingSession(pipe, speaker=0, chunk_rows=8, context_rows=16, seed=0)
    step, per_step, step_ms = sess._step, [], []

    def timed_step():
        before = dict(counts)
        t0 = time.perf_counter()
        out = step()                      # reads the step back: synchronizes
        step_ms.append((time.perf_counter() - t0) * 1e3)
        per_step.append({k: v - before.get(k, 0) for k, v in counts.items()
                         if v != before.get(k, 0) and k != "host_sync"})
        return out

    sess._step = timed_step
    chunk = int(16000 * 1.07)
    counts.clear()
    blocks = [sess.feed(wav[i:i + chunk]) for i in range(0, len(wav), chunk)]
    blocks.append(sess.finish())
    torch.cuda.synchronize()
    seen = dict(counts)
    blocks = [b for b in blocks if b is not None]
    motion = np.concatenate(blocks)
    want = {"ar_decode": 1, "wav2vec_layers": 1, "wav2vec_extractor": 1}
    if not (motion.shape == (300, 265) and np.isfinite(motion).all()
            and all(b.shape[0] % 32 == 0 for b in blocks[:-1])
            and all(d == want for d in per_step)):
        raise AssertionError(f"phase 15 stream: motion {motion.shape}, block frames "
                             f"{[b.shape[0] for b in blocks]}, per-step counts {per_step}")
    # the window's K3 and K2 against their plain versions at each window length
    dev = pipe.device
    t32 = pack_face_tables(pipe.face_model, torch.float32)
    notes = []
    with torch.no_grad():
        for frames in (32, 64, 96):
            x = torch.as_tensor(wav[:samples_for(frames)], device=dev)[None]
            errs = []
            for dtype, tables in ((torch.float32, t32), (torch.bfloat16, pipe._face_tables)):
                ext = k3.extractor_kernel(tables["ext"], x)
                n = ext.shape[1]
                errs.append(check_close(f"phase 15 K3 {frames} frames {dtype}", ext,
                                        k3.extractor_plain(tables["ext"], x), [n], dtype))
                hidden = pipe.face_model.audio_encoder.mid_stack(ext, frames)
                errs.append(check_close(f"phase 15 K2 {frames} frames {dtype}",
                                        k2.encoder_layers_kernel(tables["enc"], hidden),
                                        k2.encoder_layers_plain(tables["enc"], hidden),
                                        [frames], dtype))
            notes.append(f"{frames} frames ({x.shape[1]} samples, K3 -> {n} x {ext.shape[2]}): K3 f32 "
                         f"{errs[0]:.2e}, K2 f32 {errs[1]:.2e} <= 1e-3, K3 bf16 {errs[2]:.2e}, "
                         f"K2 bf16 {errs[3]:.2e} of max <= 1e-2")
    p50 = float(np.median(step_ms))
    chunk_ms = sess.chunk_rows * 4 / 30 * 1e3
    log(f"phase 15 stream: 10 s fed in {chunk / 16000:.2f} s chunks -> {len(per_step)} steps, "
        f"blocks {[b.shape[0] for b in blocks]} frames, {motion.shape} finite; every step "
        f"launched K1, K2 and K3 once ({want}); counts {dict(sorted(seen.items()))}")
    log("phase 15 stream window kernels vs plain: " + "; ".join(notes))
    def session():
        run = StreamingSession(pipe, speaker=0, chunk_rows=8, context_rows=16, seed=1)
        for i in range(0, len(wav), chunk):
            run.feed(wav[i:i + chunk])
        run.finish()

    idle = idle_line(session, cuda_ms(session, 2), reps=2)
    log(f"phase 15 stream step latency p50 {p50:.2f} ms over {len(step_ms)} steps (min "
        f"{min(step_ms):.2f}, max {max(step_ms):.2f}; host clock, readback included) for "
        f"{chunk_ms:.1f} ms of audio a step: real-time factor {p50 / chunk_ms:.4f} [{card}]")
    log(f"phase 15 stream, a whole 10 s session ({len(step_ms)} steps), device time by "
        f"kernel: {idle} [{card}]")
    return seen




def states_equal(a: dict, b: dict) -> bool:
    """Two nested state dicts equal bit for bit."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(states_equal(a[k], b[k]) for k in a)
    if torch.is_tensor(a):
        return torch.equal(a.cpu(), b.cpu())
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(states_equal(x, y) for x, y in zip(a, b))
    return a == b


def grad_errors(cpu_models: dict, gpu_models: dict) -> dict:
    """max |g_gpu - g_cpu| / max|g_cpu| per model."""
    out = {}
    for name, mc in cpu_models.items():
        pg = dict(gpu_models[name].named_parameters())
        gmax = max(p.grad.abs().max().item() for p in mc.parameters() if p.grad is not None)
        out[name] = max((pg[k].grad.cpu() - p.grad).abs().max().item()
                        for k, p in mc.named_parameters() if p.grad is not None) / gmax
    return out


def distinct_codes(cache: dict) -> str:
    """The distinct body and hand codes among a trainer's cached token grids."""
    grids = np.stack(list(cache.values()))
    return (f"{len(cache)} windows, {len(np.unique(grids[..., 0]))} distinct body codes and "
            f"{len(np.unique(grids[..., 1]))} distinct hand codes of {TRAIN['codes']}")


def phase16(dev, tmp: str, vq_ckpt: str) -> dict:
    """Stage-2 training through `python -m talkshow_torch.train`'s entry
    point at full width on phase 11's checkpoint; the token cache; resume;
    one step CUDA against CPU.  Returns what phase 18 times and K4's
    launches."""
    from talkshow_torch.config import Config
    from talkshow_torch.kernels import counts
    from talkshow_torch.models.pixelcnn import draw_aud_keep
    from talkshow_torch.train.__main__ import frozen_vqs, main as train_main
    cfg = os.path.join(tmp, "body_pixel.json")
    write_stage_config(cfg, "s2g_body_pixel", 2)
    run_a, run_b = os.path.join(tmp, "pixel_a"), os.path.join(tmp, "pixel_b")
    argv = ["--config_file", cfg, "--synthetic", "--device", str(dev), "--vq_ckpt", vq_ckpt]
    counts.clear()
    t0 = time.time()
    trainer = train_main(argv + ["--epochs", "1", "--run_dir", run_a])
    torch.cuda.synchronize()
    e1, steps1, t1 = dict(counts), trainer.global_step, time.time() - t0
    prior, audio = trainer.state.models["prior"], trainer.state.models["audio"]
    width = (prior.dim, prior.n_layers, prior.input_dim, audio._enc_3.conv.out_channels)
    # every batch of epoch 1 misses; the epoch then encodes the windows no
    # batch brought (the jitter's other offsets, the ragged tail) in
    # batches of 128
    keys = trainer.dataset.window_keys()
    fills = -(-(len(keys) - TRAIN["batch"] * steps1) // TRAIN["batch"])
    if (steps1 < 10 or width != (PIXEL["dim"], PIXEL["layers"], PIXEL["codes"], PIXEL["audio"])
            or e1.get("nearest_code", 0) != 2 * (steps1 + fills)
            or e1.get("nearest_code_plain", 0) or set(trainer._token_cache) != set(keys)
            or not adam_once_a_step(e1, steps1)):
        raise AssertionError(f"phase 16 epoch 1: {steps1} steps, widths {width}, counts {e1}, "
                             f"{fills} fill batches")
    seen = set(trainer._token_cache)
    misses = sum(not all(tuple(map(int, k)) in seen for k in b["window_key"])
                 for b in trainer.batch_iter(1))
    counts.clear()
    t0 = time.time()
    trainer.train(epochs=2)
    torch.cuda.synchronize()
    e2, steps2, t2 = dict(counts), trainer.global_step - steps1, time.time() - t0
    if (e2.get("nearest_code", 0) != 2 * misses or e2.get("nearest_code_plain", 0)
            or not e2.get("nearest_code", 0) < e1["nearest_code"]
            or not adam_once_a_step(e2, steps2)):
        raise AssertionError(f"phase 16 epoch 2: {misses} batches missed the cache, counts {e2}")
    logged = logged_values(run_a)
    if not (logged and all(math.isfinite(v) for v in logged)):
        raise AssertionError(f"phase 16: logged values {logged[:12]}")
    log(f"phase 16 train-pixel: python -m talkshow_torch.train s2g_body_pixel on "
        f"{os.path.relpath(vq_ckpt, tmp)}, batch {TRAIN['batch']}, window {TRAIN['window']}, "
        f"prior {PIXEL['dim']} x {PIXEL['layers']} over {PIXEL['codes']} codes, audio encoder "
        f"{PIXEL['audio']}: epoch 1 {steps1} steps in {t1:.1f} s, nearest_code launches "
        f"{e1['nearest_code']} = 2 x ({steps1} missed batches + {fills} batches filling the "
        f"cache with the {len(keys) - TRAIN['batch'] * steps1} windows no batch brought, of "
        f"{len(keys)}); epoch 2 {steps2} steps in {t2:.1f} s, {misses} batches missed, "
        f"nearest_code launches {e2.get('nearest_code', 0)}; plain search calls 0; "
        f"{len(logged)} logged values all finite")
    # cached tokens against a fresh encode of the same windows: windows a
    # batch brought, and windows the fill encoded
    first = next(iter(trainer.batch_iter(0)))
    brought = [tuple(map(int, k)) for k in first["window_key"]]
    in_batches = {tuple(map(int, k)) for b in trainer.batch_iter(0) for k in b["window_key"]}
    filled = [k for k in keys if k not in in_batches][:TRAIN["batch"]]
    for group in (brought, filled):
        cached = torch.as_tensor(np.stack([trainer._token_cache[k] for k in group]))
        poses = np.stack([trainer.dataset.window_poses(k) for k in group])
        fresh = trainer.token_encoder(trainer.put_batch({"poses": poses})["poses"]).cpu()
        if not torch.equal(cached, fresh):
            raise AssertionError("phase 16: cached tokens differ from a fresh encode")
    cached = torch.as_tensor(np.stack([trainer._token_cache[k] for k in brought]))
    # resume from epoch 1's checkpoint through epoch 2 (its cache refills)
    resumed = train_main(argv + ["--epochs", "2", "--run_dir", run_b, "--resume",
                                 os.path.join(run_a, "ckpt-0.pt")])
    if not (resumed.global_step == trainer.global_step
            and states_equal(resumed.state.state_dict(), trainer.state.state_dict())):
        raise AssertionError("phase 16: resume + epoch 2 differs from the uninterrupted run")
    log(f"phase 16 3-D token cache: {distinct_codes(trainer._token_cache)}")
    log(f"phase 16 cache and resume: the cached token grids of a batch's {len(brought)} "
        f"windows and of {len(filled)} filled ones equal a fresh encode bit for bit; ckpt-0 + epoch 2 ({steps2} steps, cache "
        f"refilled) equals the uninterrupted run bit for bit (parameters, BatchNorm "
        f"statistics, Adam moments)")
    del resumed

    # one step from one state, CUDA against CPU (B = 8, full width, TF32 off,
    # the same tokens and dropout mask)
    from talkshow_torch.models.pixelcnn import GatedPixelCNN
    from talkshow_torch.models.vqvae import AudioEncoder
    from talkshow_torch.train.steps import make_body_pixel_step

    def fresh_state(device):
        vb, vh, sts = frozen_vqs(Config.from_reference_json(cfg), vq_ckpt)
        init, step = make_body_pixel_step(
            GatedPixelCNN(input_dim=PIXEL["codes"], dim=PIXEL["dim"], n_layers=PIXEL["layers"]),
            AudioEncoder(num_hiddens=PIXEL["audio"]), vb, vh, sts, 1e-4, 5.0)
        return init(torch.Generator().manual_seed(16), device), step

    batch = trainer.put_batch({k: first[k][:8] for k in ("poses", "aud_feat", "speaker")})
    tokens = cached[:8]
    keep = draw_aud_keep(8, tokens.shape[1], torch.Generator().manual_seed(17), "cpu")
    cpu_batch = {"tokens": tokens, "aud_feat": batch["aud_feat"].cpu(),
                 "speaker": batch["speaker"].cpu(), "aud_keep": keep}
    gpu_batch = {k: v.to(dev) for k, v in cpu_batch.items()}
    (s_cpu, step_cpu), (s_gpu, step_gpu) = fresh_state("cpu"), fresh_state(dev)
    _, mc = step_cpu(s_cpu, cpu_batch)
    _, mg = step_gpu(s_gpu, gpu_batch)
    rel = max(abs(float(mg[k]) - float(mc[k])) / abs(float(mc[k])) for k in ("ce_loss", "grad"))
    g_err = grad_errors(s_cpu.models, s_gpu.models)
    p_err, within, total, stat_err = 0.0, 0, 0, 0.0
    for name, mcpu in s_cpu.models.items():
        pg = dict(s_gpu.models[name].named_parameters())
        for k, p in mcpu.named_parameters():
            d = (pg[k].detach().cpu() - p.detach()).abs()
            p_err = max(p_err, d.max().item())
            within += int((d <= 1e-2 * 1e-4).sum())
            total += d.numel()
        bg = s_gpu.models[name].state_dict()
        stat_err = max([stat_err] + [(bg[k].cpu() - v).abs().max().item()
                                     for k, v in mcpu.state_dict().items()
                                     if k.endswith(("running_mean", "running_var"))])
    share = within / total
    # Adam's first step moves each parameter by about lr sign(g): only those
    # whose gradient is rounding noise (conv biases under batch-statistics
    # BatchNorm) may take another sign on the card
    if not (rel <= 1e-4 and g_err["prior"] <= 1e-3 and g_err["audio"] <= 2e-2
            and stat_err <= 1e-4 and p_err <= 2e-4 * (1 + 1e-3) and share >= 0.99):
        raise AssertionError(f"phase 16 CUDA vs CPU: loss/norm rel {rel}, gradients {g_err}, "
                             f"statistics {stat_err}, params {p_err}, share {share}")
    log(f"phase 16 CUDA vs CPU, one step from one state (B=8, full width, TF32 off, the same "
        f"tokens and dropout mask): ce_loss and grad norm within {rel:.2e} relative <= 1e-4; "
        f"prior gradients within {g_err['prior']:.2e} of max|g| <= 1e-3, audio-encoder "
        f"gradients (three levels of batch-statistics BatchNorm) {g_err['audio']:.2e} <= 2e-2; "
        f"BatchNorm statistics within {stat_err:.2e} <= 1e-4; parameters within {p_err:.2e} "
        f"<= 2 lr, {share:.4%} within 1e-2 lr >= 99 %")
    del s_cpu, s_gpu
    return dict(trainer=trainer, batch=first,
                launches=e1.get("nearest_code", 0) + e2.get("nearest_code", 0))


def phase17(dev, tmp: str) -> dict:
    """Stage-3 training through the CLI's entry point at full width on the
    synthetic 8 s raw clips: whole clips (K3), bucketed (the plain masked
    extractor), resume, one step CUDA against CPU, K3's frozen features.
    Returns what phase 18 times and K3's launches."""
    from talkshow_torch.kernels import counts
    from talkshow_torch.kernels import wav2vec_extractor as k3
    from talkshow_torch.models.face import FaceGenerator
    from talkshow_torch.models.wav2vec_fused import frozen_features
    from talkshow_torch.train.__main__ import main as train_main
    from talkshow_torch.train.steps import make_face_step
    cfg = os.path.join(tmp, "face.json")
    write_stage_config(cfg, "s2g_face", 2)
    runs = {k: os.path.join(tmp, f"face_{k}") for k in ("a", "b", "c")}
    argv = ["--config_file", cfg, "--synthetic", "--device", str(dev)]
    init0, _ = make_face_step(FaceGenerator())
    ext0 = init0(torch.Generator().manual_seed(0), "cpu").face.audio_encoder \
        .feature_extractor.state_dict()
    counts.clear()
    t0 = time.time()
    trainer = train_main(argv + ["--run_dir", runs["a"]])
    torch.cuda.synchronize()
    seen, steps, wall = dict(counts), trainer.global_step, time.time() - t0
    face = trainer.state.face
    enc = face.audio_encoder
    shapes = [b["waveform"].shape for b in trainer.batch_iter(0)]
    ext1 = enc.feature_extractor.state_dict()
    frozen = all(torch.equal(v.cpu(), ext0[k]) for k, v in ext1.items()) and all(
        p.grad is None and not p.requires_grad for p in enc.feature_extractor.parameters())
    logged = logged_values(runs["a"])
    width = (enc.cfg.num_layers, enc.cfg.hidden_size)
    if (width != FACE_WIDTH or steps != 2 * len(shapes)
            or seen.get("wav2vec_extractor", 0) != steps or seen.get("extractor_plain", 0)
            or seen.get("face_plain", 0) or trainer.state.tables["w0"].dtype != torch.float32
            or seen.get("grad_stats", 0) != steps or seen.get("grad_stats_plain", 0)
            or seen.get("adam_apply", 0)
            or not frozen or not all(math.isfinite(v) for v in logged)):
        raise AssertionError(f"phase 17 whole clips: widths {width}, {steps} steps, counts "
                             f"{seen}, extractor frozen {frozen}, logged {logged[:12]}")
    log(f"phase 17 train-face: python -m talkshow_torch.train s2g_face, wav2vec 2.0 base "
        f"{width[0]} x {width[1]} with the face heads, {len(shapes)} whole clips of "
        f"{shapes[0][1] / 16000:.2f} s at batch 1, 2 epochs: {steps} steps in {wall:.1f} s; "
        f"wav2vec_extractor (K3, f32 tables) launches {seen['wav2vec_extractor']} = 1 a step, "
        f"plain extractor calls 0; grad_stats (the SGD step's flag and norm) "
        f"{seen['grad_stats']} = 1 a step; the extractor's parameters bit-equal to their init, no "
        f".grad; {len(logged)} logged values all finite")
    counts.clear()
    bucketed = train_main(argv + ["--run_dir", runs["b"], "--epochs", "1", "--face_bucket",
                                  "32", "--face_batch_size", "2"])
    torch.cuda.synchronize()
    seen_b = dict(counts)
    shapes_b = [b["gt"].shape[:2] for b in bucketed.batch_iter(0)]
    logged_b = logged_values(runs["b"])
    if (seen_b.get("extractor_plain", 0) != bucketed.global_step
            or seen_b.get("wav2vec_extractor", 0) or not all(math.isfinite(v) for v in logged_b)):
        raise AssertionError(f"phase 17 bucketed: counts {seen_b}, logged {logged_b[:12]}")
    log(f"phase 17 train-face --face_bucket 32 --face_batch_size 2: batches {shapes_b} "
        f"(clips, frames), {bucketed.global_step} steps through the plain masked extractor "
        f"(extractor_plain {seen_b['extractor_plain']}, K3 0, as JAX and serving); "
        f"{len(logged_b)} logged values all finite")
    del bucketed
    resumed = train_main(argv + ["--run_dir", runs["c"], "--resume",
                                 os.path.join(runs["a"], "ckpt-0.pt")])
    if not (resumed.global_step == trainer.global_step
            and states_equal(resumed.state.state_dict(), trainer.state.state_dict())):
        raise AssertionError("phase 17: resume + epoch 2 differs from the uninterrupted run")
    log(f"phase 17 resume: ckpt-0 + epoch 2 ({len(shapes)} steps, SpecAugment and dropout "
        f"from per-step generators) equals the uninterrupted run bit for bit")
    del resumed

    # K3's frozen features against the plain extractor module, 8 s clip
    first = next(iter(trainer.batch_iter(0)))
    wav = torch.as_tensor(first["waveform"], device=dev)
    with torch.no_grad():
        want = enc.feature_extractor(wav)
    got = frozen_features(enc, wav, tables=trainer.state.tables)
    f_err = (got - want).abs().max().item() / want.abs().max().item()
    if not (f_err <= 1e-3 and not got.requires_grad and got.shape == want.shape):
        raise AssertionError(f"phase 17 K3 features: {f_err} of max, shape {tuple(got.shape)}")

    # one step from one state, CUDA against CPU (stochastic=False, TF32 off)
    def fresh_state(device):
        init, step = make_face_step(FaceGenerator(), stochastic=False)
        return init(torch.Generator().manual_seed(17), device), step

    cpu_batch = {k: torch.as_tensor(v) for k, v in first.items()}
    (s_cpu, step_cpu), (s_gpu, step_gpu) = fresh_state("cpu"), fresh_state(dev)
    _, mc = step_cpu(s_cpu, cpu_batch)
    _, mg = step_gpu(s_gpu, {k: v.to(dev) for k, v in cpu_batch.items()})
    rel = max(abs(float(mg[k]) - float(mc[k])) / abs(float(mc[k]))
              for k in ("loss", "MSELoss", "exp_loss", "grad"))
    g_err = grad_errors({"face": s_cpu.face}, {"face": s_gpu.face})["face"]
    sc, sg = s_cpu.face.state_dict(), s_gpu.face.state_dict()
    top = max(v.abs().max().item() for v in sc.values())
    p_err = max((sg[k].cpu() - v).abs().max().item() for k, v in sc.items()) / top
    if not (rel <= 1e-4 and g_err <= 1e-3 and p_err <= 1e-5):
        raise AssertionError(f"phase 17 CUDA vs CPU: rel {rel}, gradients {g_err}, "
                             f"params {p_err}")
    log(f"phase 17 CUDA vs CPU, one step from one state (stochastic=False, TF32 off, the "
        f"{shapes[0][1] / 16000:.2f} s clip; K3 on the card, its plain version on the CPU): "
        f"losses and grad norm within {rel:.2e} relative <= 1e-4; gradients within "
        f"{g_err:.2e} of max|g| <= 1e-3; parameters within {p_err:.2e} of max|p| <= 1e-5 (SGD "
        f"moves each by lr times its gradient); K3's frozen features vs the plain extractor "
        f"{f_err:.2e} of max|out| <= 1e-3")
    del s_cpu, s_gpu
    return dict(trainer=trainer, batch=first, launches=seen["wav2vec_extractor"],
                k3_err=f_err)


def step_p50(fn, runs: int = 10) -> tuple[float, float, float]:
    """(p50, min, max) ms of fn() over runs after one warm-up, CUDA events
    around each call."""
    fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times)), min(times), max(times)


def phase18(pixel: dict, face: dict, card: str) -> None:
    """Times of both training steps, each beside the card."""
    from talkshow_torch.train import steps as steps_mod
    tr = pixel["trainer"]
    gen = torch.Generator(device=tr.device).manual_seed(18)
    warm = tr.device_batch(dict(pixel["batch"]), [])          # cached tokens
    cold = tr.put_batch({k: pixel["batch"][k] for k in ("poses", "aud_feat", "speaker")})
    rows = {}
    for name, batch in (("cold", cold), ("warm", warm)):
        rows[name] = step_p50(lambda: tr.step_fn(tr.state, batch, gen))
    enc_ms = cuda_ms(lambda: tr.token_encoder(cold["poses"]), 10)
    log(f"phase 18 body-pixel step B={TRAIN['batch']} T={TRAIN['window']}: p50 "
        f"{rows['warm'][0]:.2f} ms (min {rows['warm'][1]:.2f}, max {rows['warm'][2]:.2f}) with "
        f"cached tokens (warm), {TRAIN['batch'] / rows['warm'][0] * 1e3:.1f} windows/s; "
        f"{rows['cold'][0]:.2f} ms (min {rows['cold'][1]:.2f}, max {rows['cold'][2]:.2f}) "
        f"encoding in the step (cold), the encode {1 - rows['warm'][0] / rows['cold'][0]:.1%} "
        f"of it; the encode alone {enc_ms:.2f} ms [{card}]")
    for name, batch in (("cold", cold), ("warm", warm)):
        log(f"phase 18 body-pixel step ({name}) device time by kernel: " + idle_line(
            lambda: tr.step_fn(tr.state, batch, gen), rows[name][0], reps=2) + f" [{card}]")

    ft = face["trainer"]
    fbatch = ft.put_batch(dict(face["batch"]))
    fgen = torch.Generator(device=ft.device).manual_seed(18)
    k3_step = lambda: ft.step_fn(ft.state, fbatch, fgen)       # noqa: E731
    fused = steps_mod.frozen_features

    def plain_features(encoder, waveform, valid_samples=None, *, tables):
        with torch.no_grad():
            return encoder.feature_extractor(waveform, valid_samples)

    def plain_step():
        steps_mod.frozen_features = plain_features
        try:
            return ft.step_fn(ft.state, fbatch, fgen)
        finally:
            steps_mod.frozen_features = fused

    # in turns: plain, K3, K3, plain
    p1, f1, f2, p2 = (step_p50(f, 20) for f in (plain_step, k3_step, k3_step, plain_step))
    secs = fbatch["waveform"].shape[1] / 16000
    enc = ft.state.face.audio_encoder
    wav = fbatch["waveform"]
    ext = {"K3": lambda: fused(enc, wav, tables=ft.state.tables),
           "plain": lambda: plain_features(enc, wav, tables=None)}
    e1, k1, k2, e2 = (cuda_ms(ext[k], 20) for k in ("plain", "K3", "K3", "plain"))
    log(f"phase 18 face step B=1, {secs:.2f} s clip: p50 {f1[0]:.2f} / {f2[0]:.2f} ms with the "
        f"frozen extractor on K3 (f32 tables), {p1[0]:.2f} / {p2[0]:.2f} ms with the plain "
        f"extractor (cuDNN), in turns, 20 steps each; the frozen extractor alone: K3 "
        f"{k1:.3f} / {k2:.3f} ms, plain {e1:.3f} / {e2:.3f} ms [{card}]")
    log(f"phase 18 face step (K3) device time by kernel: "
        f"{idle_line(k3_step, (f1[0] + f2[0]) / 2, reps=2)} [{card}]")
    # for the record only: TF32 on (not the port's setting)
    cudnn = torch.backends.cudnn
    torch.backends.cuda.matmul.allow_tf32 = cudnn.allow_tf32 = True
    try:
        tf_pixel = step_p50(lambda: tr.step_fn(tr.state, warm, gen), 5)
        tf_face = step_p50(k3_step, 5)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = cudnn.allow_tf32 = False
    log(f"phase 18 with TF32 on, for the record: body-pixel step (warm) p50 {tf_pixel[0]:.2f} ms, "
        f"face step (K3) p50 {tf_face[0]:.2f} ms [{card}]")


# ---------------------------------------------------------------------------
# phases 19-21: the body AE and the evaluation path
# ---------------------------------------------------------------------------

#: the eval path: clips of a synthetic SHOW test split, samples a clip, the
#: SMPL-X rig's size (the official mesh: 10 475 vertices, 55 joints, 300
#: betas + 100 expression), frames of the card-against-CPU clip (2 s)
EVAL = dict(clips=4, seconds=10.0, samples=2, verts=10475, ref_frames=60)
SPEAKERS = ["oliver", "chemistry", "seth", "conan"]


def phase19(dev, tmp: str, card: str) -> dict:
    """The body AE (the FGD net) through `python -m talkshow_torch.train`'s
    entry point at full width; resume; one step CUDA against CPU; the
    step's p50.  Returns its checkpoint."""
    import copy

    from talkshow_torch.kernels import counts
    from talkshow_torch.models.vqvae import AE
    from talkshow_torch.ops.pose import CONV_DIM
    from talkshow_torch.train.__main__ import main as train_main
    from talkshow_torch.train.steps import conv_channels, make_body_ae_step, recon_losses
    cfg = os.path.join(tmp, "body_ae.json")
    write_stage_config(cfg, "s2g_body_ae", 1)
    run_a, run_b = os.path.join(tmp, "ae_a"), os.path.join(tmp, "ae_b")
    argv = ["--config_file", cfg, "--synthetic", "--epochs", "1", "--device", str(dev)]
    counts.clear()
    t0 = time.time()
    trainer = train_main(argv + ["--run_dir", run_a])
    torch.cuda.synchronize()
    seen, steps, t_epoch = dict(counts), trainer.global_step, time.time() - t0
    width = trainer.state.model.encoder.pre_vq_conv.in_channels
    logged = logged_values(run_a)
    ckpt = os.path.join(run_a, "ckpt-0.pt")
    if (steps < 10 or width != TRAIN["num_hiddens"] or any(seen.get(k) for k in KERNELS)
            or not adam_once_a_step(seen, steps) or not logged
            or not all(math.isfinite(v) for v in logged)
            or not os.path.isfile(ckpt)):
        raise AssertionError(f"phase 19: {steps} steps, width {width}, counts {seen}, logged "
                             f"{logged[:12]}, checkpoint {os.path.isfile(ckpt)}")
    log(f"phase 19 train-ae: python -m talkshow_torch.train s2g_body_ae, batch {TRAIN['batch']}, "
        f"window {TRAIN['window']}, num_hiddens {TRAIN['num_hiddens']}: {steps} steps in "
        f"{t_epoch:.1f} s (first cuDNN calls included); {len(logged)} logged values all finite; "
        f"none of K1-K4 launched (the AE has no quantizer); grad_stats and adam_apply "
        f"launches {seen['adam_apply']} = {steps}; {os.path.basename(ckpt)} written")

    # resume + one step == the uninterrupted run's next step
    resumed = train_main(argv + ["--run_dir", run_b, "--resume", ckpt])
    batch = next(trainer.dataset.batches(TRAIN["batch"], np.random.default_rng(99)))
    batch = trainer.put_batch({"poses": batch["poses"]})
    _, m_a = trainer.step_fn(trainer.state, batch)
    _, m_b = resumed.step_fn(resumed.state, resumed.put_batch({"poses": batch["poses"].cpu()}))
    if not (all(float(m_a[k]) == float(m_b[k]) for k in m_a)
            and states_equal(trainer.state.state_dict(), resumed.state.state_dict())):
        raise AssertionError("phase 19: resume + one step differs from the uninterrupted run")
    log(f"phase 19 resume: ckpt-0 + one step equals the uninterrupted run's next step bit for "
        f"bit (parameters, BatchNorm statistics, Adam moments; {len(m_a)} metrics)")
    del resumed

    # one step from one state, CUDA against CPU (B = 8, full width, TF32 off)
    lr = 1e-4

    def fresh(device):
        init, step = make_body_ae_step(AE(CONV_DIM, TRAIN["dim"], TRAIN["num_hiddens"]), lr)
        return init(torch.Generator().manual_seed(19), device), step

    (s_cpu, step_cpu), (s_gpu, step_gpu) = fresh("cpu"), fresh(dev)
    poses8 = batch["poses"][:8].cpu()
    conv8 = conv_channels(poses8).double()
    # an f64 reference on the CPU.  Every gradient of the AE lies behind the
    # encoder's three levels of batch-statistics BatchNorm (1024 channels at
    # 176 positions), the decoder's too, since it reads the encoder's output
    # (phase 11's VQ decoders read codebook rows, equal on both devices):
    # so all of them carry phase 11's encoder rounding, ~1e-2 of max|g| on
    # either device, and are held to the f64 reference as its encoder is
    m64 = copy.deepcopy(s_cpu.model).double().train()
    sum(recon_losses(m64(conv8), conv8)).backward()
    g64 = {k: p.grad for k, p in m64.named_parameters()}
    del m64
    _, mc = step_cpu(s_cpu, {"poses": poses8})
    _, mg = step_gpu(s_gpu, {"poses": poses8.to(dev)})
    rel = max(abs(float(mg[k]) - float(mc[k])) / max(abs(float(mc[k])), 1e-12)
              for k in ("rec_loss", "velocity_loss"))
    gmax = max(g.abs().max().item() for g in g64.values())
    pg = dict(s_gpu.model.named_parameters())
    errs = {(half, side): 0.0 for half in ("encoder", "decoder") for side in ("gpu", "cpu")}
    dec_err = p_err = 0.0
    within = total = 0
    for k, p in s_cpu.model.named_parameters():
        gc, gg, gr = p.grad.double(), pg[k].grad.cpu().double(), g64[k]
        half = k.split(".")[0]
        errs[half, "gpu"] = max(errs[half, "gpu"], (gg - gr).abs().max().item() / gmax)
        errs[half, "cpu"] = max(errs[half, "cpu"], (gc - gr).abs().max().item() / gmax)
        if half == "decoder":
            dec_err = max(dec_err, (gg - gc).abs().max().item() / gmax)
        d = (pg[k].detach().cpu() - p.detach()).abs()
        p_err = max(p_err, d.max().item())
        within += int((d <= 1e-2 * lr).sum())
        total += d.numel()
    bc, bg = s_cpu.model.state_dict(), s_gpu.model.state_dict()
    stat_err = max((bg[k].cpu() - v).abs().max().item() for k, v in bc.items()
                   if k.endswith(("running_mean", "running_var")))
    share = within / total
    g_gpu = max(errs["encoder", "gpu"], errs["decoder", "gpu"])
    if not (rel <= 1e-4 and g_gpu <= 2e-2 and stat_err <= 1e-4
            and p_err <= 2 * lr * (1 + 1e-3) and share >= 0.99):
        raise AssertionError(f"phase 19 CUDA vs CPU: losses rel {rel}, gradients vs f64 {errs}, "
                             f"statistics {stat_err}, params {p_err}, share within 1e-2 lr "
                             f"{share}")
    log(f"phase 19 CUDA vs CPU, one step from one state (B=8, T={TRAIN['window']}, full width, "
        f"TF32 off): losses within {rel:.2e} relative <= 1e-4; gradients vs an f64 CPU "
        f"reference within {errs['encoder', 'gpu']:.2e} (encoder) and "
        f"{errs['decoder', 'gpu']:.2e} (decoder) of max|g| <= 2e-2, all behind batch-statistics "
        f"BatchNorm (the CPU's f32: {errs['encoder', 'cpu']:.2e} and "
        f"{errs['decoder', 'cpu']:.2e}); decoder gradients CUDA vs CPU {dec_err:.2e} "
        f"(reported); BatchNorm statistics within {stat_err:.2e} <= 1e-4; parameters within "
        f"{p_err:.2e} <= 2 lr = {2 * lr:g}, {share:.4%} of them within 1e-2 lr >= 99 %")
    del s_cpu, s_gpu

    p50, lo, hi = step_p50(lambda: trainer.step_fn(trainer.state, batch))
    log(f"phase 19 body-AE step B={TRAIN['batch']} T={TRAIN['window']}: p50 {p50:.2f} ms (min "
        f"{lo:.2f}, max {hi:.2f}) over 10 steps, {TRAIN['batch'] / p50 * 1e3:.1f} windows/s "
        f"[{card}]")
    return dict(ckpt=ckpt, p50=p50)


def write_show_tree(root: str, clips: int, seconds: float, split: str = "test") -> None:
    """A synthetic SHOW split: `clips` clips of `seconds`, each a
    `<clip>.pkl` of SMPL-X parameters (the reference's keys; hands as 45
    PCA coefficients of which the loader keeps 12) and a 16 kHz `<clip>.wav`."""
    import pickle
    frames = int(round(seconds * 30))
    for i in range(clips):
        rng = np.random.default_rng(100 + i)
        d = os.path.join(root, SPEAKERS[i % 4], f"video{i}", split, f"clip{i}")
        os.makedirs(d)
        data = {"jaw_pose": 0.1 * rng.standard_normal((frames, 3)),
                "leye_pose": 0.1 * rng.standard_normal((frames, 3)),
                "reye_pose": 0.1 * rng.standard_normal((frames, 3)),
                "global_orient": 0.1 * rng.standard_normal((frames, 3)),
                "body_pose_axis": 0.2 * rng.standard_normal((frames, 63)),
                "left_hand_pose": 0.5 * rng.standard_normal((frames, 45)),
                "right_hand_pose": 0.5 * rng.standard_normal((frames, 45)),
                "expression": 0.5 * rng.standard_normal((frames, 100)),
                "betas": 0.5 * rng.standard_normal((1, 300))}
        with open(os.path.join(d, f"clip{i}.pkl"), "wb") as f:
            pickle.dump(data, f)
        write_wav(os.path.join(d, f"clip{i}.wav"), seconds, 200 + i)


def metric_values(res) -> list:
    """Every number of a runner's result (lists, CIs, per-clip values)."""
    if isinstance(res, dict):
        return [v for x in res.values() for v in metric_values(x)]
    if isinstance(res, (list, tuple)):
        return [v for x in res for v in metric_values(x)]
    return [float(res)]


def rel_err(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


def phase20(dev, tmp: str, ckpts: dict) -> dict:
    """The eval path at full width on the card: a synthetic SHOW tree
    through `ShowDataset.from_root`, a synthetic SMPL-X rig of the official
    size through `load_smplx_npz`, the three runners on the trained stages
    (phases 11, 16, 19), the eval CLI, FGD against an f64 reference, and one
    2 s clip against the CPU.  Returns what phase 21 times and the launches."""
    import contextlib
    import copy
    import io

    from talkshow_torch.data.dataset import Clip, ShowDataset
    from talkshow_torch.eval import runners
    from talkshow_torch.eval.__main__ import (ae_weights, main as eval_main, pixel_weights,
                                              vq_weights)
    from talkshow_torch.eval.fgd import FGDEvaluator, frechet_distance_np
    from talkshow_torch.kernels import counts
    from talkshow_torch.models.pixelcnn import gumbel_noise
    from talkshow_torch.models.vqvae import AE
    from talkshow_torch.ops.pose import CONV_DIM
    from talkshow_torch.ops.smplx_lbs import build_synthetic_smplx_arrays, load_smplx_npz
    from talkshow_torch.pipeline import Pipeline
    n = EVAL["clips"]
    root = os.path.join(tmp, "show")
    write_show_tree(root, n, EVAL["seconds"])
    t0 = time.time()
    ds = ShowDataset.from_root(root, SPEAKERS, "test", device=dev)
    ds_raw = ShowDataset.from_root(root, SPEAKERS, "test", feat="raw", device=dev)
    t_load = time.time() - t0
    frames = int(round(EVAL["seconds"] * 30))
    shapes = {(c.poses.shape, c.aud_feat.shape[1], r.aud_feat.shape) for c, r in
              zip(ds.clips, ds_raw.clips)}
    if len(ds.clips) != n or len(ds_raw.clips) != n or shapes != {
            ((frames, 165), 64, (int(16000 * EVAL["seconds"]), 1))}:
        raise AssertionError(f"phase 20 from_root: {len(ds.clips)} / {len(ds_raw.clips)} clips, "
                             f"shapes {shapes}")
    npz = os.path.join(tmp, "smplx_synthetic.npz")
    arrays = build_synthetic_smplx_arrays(num_verts=EVAL["verts"])
    np.savez(npz, **{k: v.astype(np.float32) if v.dtype == np.float64 else v
                     for k, v in arrays.items()})
    rig = load_smplx_npz(npz, device=dev)
    sizes = (rig.v_template.shape[0], len(rig.parents), rig.shapedirs.shape[-1])
    if sizes != (EVAL["verts"], 55, 400):
        raise AssertionError(f"phase 20 rig: {sizes}")
    log(f"phase 20 data: ShowDataset.from_root on a synthetic SHOW tree of {n} clips of "
        f"{EVAL['seconds']:.0f} s (pkl + 16 kHz wav), MFCC and raw features on the card, in "
        f"{t_load:.1f} s; SMPL-X rig through load_smplx_npz: {sizes[0]} vertices, {sizes[1]} "
        f"joints, {sizes[2]} shape + expression directions")

    def load(path):
        return torch.load(path, map_location="cpu", weights_only=True)

    weights = vq_weights(load(ckpts["vq"]))
    weights.update(pixel_weights(load(ckpts["pixel"])))
    pipe = Pipeline.create(seed=0, device=dev).load_converted(weights)
    ae = AE(CONV_DIM)
    ae.load_state_dict(ae_weights(load(ckpts["ae"])))
    ae.to(dev)
    states = {"body": pipe.body.vq_body_state, "hand": pipe.body.vq_hand_state}

    counts.clear()
    vq = runners.eval_vq_capacity(pipe.body.vq_body, pipe.body.vq_hand, states, ds)
    torch.cuda.synchronize()
    c_vq = dict(counts)
    ev = FGDEvaluator(ae)
    counts.clear()
    body = runners.eval_body(pipe, ae, ds, num_samples=EVAL["samples"], smplx_model=rig,
                             evaluator=ev)
    torch.cuda.synchronize()
    c_body = dict(counts)
    counts.clear()
    face = runners.eval_face(pipe.face_model, ds_raw, rig)
    torch.cuda.synchronize()
    c_face = dict(counts)
    values = metric_values([vq, body, face])
    if not (c_vq.get("nearest_code") == 2 * n and not c_vq.get("nearest_code_plain")
            and c_body.get("ar_decode") == n and not c_body.get("sample_tokens_plain")
            and c_face.get("wav2vec_extractor") == n and c_face.get("wav2vec_layers") == n
            and not c_face.get("face_plain") and not c_face.get("extractor_plain")
            and all(math.isfinite(v) for v in values)
            and {"lvd", "bc", "fgd_ci"} <= body.keys() and "face_lvd" in face):
        raise AssertionError(f"phase 20 runners: counts vq {c_vq}, body {c_body}, face {c_face}; "
                             f"keys {sorted(body)} {sorted(face)}; finite "
                             f"{all(math.isfinite(v) for v in values)}")
    gen, real = np.vstack(ev.gen_feats), np.vstack(ev.real_feats)
    fgd64 = frechet_distance_np(gen.astype(np.float64), real.astype(np.float64))
    fgd_rel = rel_err(body["fgd"], fgd64)
    if not fgd_rel <= 1e-3:
        raise AssertionError(f"phase 20 FGD: card (f32) {body['fgd']} vs f64 {fgd64}")
    log(f"phase 20 eval_vq_capacity: capacity_l1 {vq['capacity_l1']:.6f} over {vq['num_clips']} "
        f"clips; nearest_code launches {c_vq['nearest_code']} = 2 x {n}, plain 0")
    log(f"phase 20 eval_body (S={EVAL['samples']}, bf16 decode tables): fgd {body['fgd']:.4f} "
        f"(CI {body['fgd_ci']['p2_5']:.4f}-{body['fgd_ci']['p97_5']:.4f}), feat_mae "
        f"{body['feat_mae']:.4f}, l2 {body['l2']:.4f}, diversity {body['diversity']:.4f}, lvd "
        f"{body['lvd']:.4f}, bc {body['bc']:.4f}; ar_decode launches {c_body['ar_decode']} = 1 "
        f"a clip, plain sampler 0; FGD on the card (f32 eigh) within {fgd_rel:.2e} relative of "
        f"frechet_distance_np (f64) on the same {gen.shape[0]} + {real.shape[0]} features "
        f"<= 1e-3")
    log(f"phase 20 eval_face (f32 tables): jaw_l1 {face['jaw_l1']:.5f}, exp_mse "
        f"{face['exp_mse']:.5f}, face_lvd {face['face_lvd']:.5f} over {EVAL['verts']} "
        f"vertices; wav2vec_extractor {c_face['wav2vec_extractor']}, wav2vec_layers "
        f"{c_face['wav2vec_layers']} launches = 1 a clip each, plain face stage 0; "
        f"{len(values)} metric values all finite")

    # the eval CLI on the card by default (no --device), the same checkpoints
    out = io.StringIO()
    counts.clear()
    with contextlib.redirect_stdout(out):
        cli = eval_main(["body", "--data_root", root, "--vq_ckpt", ckpts["vq"], "--body_ckpt",
                         ckpts["pixel"], "--ae_ckpt", ckpts["ae"], "--smplx_npz", npz])
    torch.cuda.synchronize()
    c_cli = dict(counts)
    printed = json.loads(out.getvalue().strip().splitlines()[-1])
    if not (c_cli.get("ar_decode") == n and not c_cli.get("sample_tokens_plain")
            and printed["num_clips"] == n and all(math.isfinite(v) for v in metric_values(cli))):
        raise AssertionError(f"phase 20 CLI: counts {c_cli}, result {printed.get('num_clips')}")
    log(f"phase 20 eval CLI: python -m talkshow_torch.eval body (its main(), no --device) on the "
        f"tree with the phase 11 / 16 / 19 checkpoints and the rig: ar_decode launches "
        f"{c_cli['ar_decode']}, plain sampler 0; fgd {cli['fgd']:.4f}, l2 {cli['l2']:.4f}, lvd "
        f"{cli['lvd']:.4f} (the runner above: max relative difference "
        f"{max(rel_err(cli[k], body[k]) for k in ('fgd', 'l2', 'lvd')):.2e}, reported)")

    # one 2 s clip, card (f32 tables) against the CPU on the same weights and noise
    T = EVAL["ref_frames"]
    c0, r0 = ds.clips[0], ds_raw.clips[0]
    short = ShowDataset([Clip(c0.speaker, c0.poses[:T], c0.expression[:T], c0.aud_feat[:T],
                              c0.betas)])
    short_raw = ShowDataset([Clip(r0.speaker, r0.poses[:T], r0.expression[:T],
                                  r0.aud_feat[:T * 16000 // 30], r0.betas)])
    ref = Pipeline.create(seed=0, device="cpu").load_converted(weights)
    ae_cpu = copy.deepcopy(ae).cpu()
    rig_cpu = load_smplx_npz(npz, device="cpu")
    noise = gumbel_noise((T // 4, 2, EVAL["samples"], PIXEL["codes"]),
                         torch.Generator().manual_seed(20), "cpu")
    p32 = pipe.with_face_dtype(torch.float32)
    p32.table_dtype = torch.float32
    tokens = []
    decode = runners.generate_conv_poses

    def spy(*a, **k):
        res = decode(*a, **k)
        tokens.append(res[1].cpu())
        return res

    runners.generate_conv_poses = spy
    try:
        rb_gpu = runners.eval_body(p32, ae, short, EVAL["samples"], smplx_model=rig,
                                   noise=lambda ci: noise)
        rb_cpu = runners.eval_body(ref, ae_cpu, short, EVAL["samples"], smplx_model=rig_cpu,
                                   noise=lambda ci: noise)
    finally:
        runners.generate_conv_poses = decode
    rf_gpu = runners.eval_face(pipe.face_model, short_raw, rig)
    rf_cpu = runners.eval_face(ref.face_model, short_raw, rig_cpu)
    errs = {k: rel_err(rb_gpu[k], rb_cpu[k]) for k in ("l2", "lvd")}
    errs.update({k: rel_err(rf_gpu[k], rf_cpu[k]) for k in ("jaw_l1", "exp_mse", "face_lvd")})
    if not (len(tokens) == 2 and torch.equal(tokens[0], tokens[1])
            and max(errs.values()) <= 1e-4):
        raise AssertionError(f"phase 20 CUDA vs CPU: tokens equal "
                             f"{len(tokens) == 2 and torch.equal(tokens[0], tokens[1])}, "
                             f"relative errors {errs}")
    log(f"phase 20 CUDA vs CPU, one {T / 30:.0f} s clip (f32 decode and face tables, shared "
        f"noise): tokens equal ({tuple(tokens[0].shape)}); relative differences "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()) + " <= 1e-4; diversity "
        f"{rel_err(rb_gpu['diversity'], rb_cpu['diversity']):.2e}, fgd "
        f"{rel_err(rb_gpu['fgd'], rb_cpu['fgd']):.2e} (reported)")
    del ref, p32, ae_cpu, rig_cpu
    launches = {"ar_decode": c_body["ar_decode"] + c_cli["ar_decode"],
                "nearest_code": c_vq["nearest_code"],
                "wav2vec_layers": c_face["wav2vec_layers"],
                "wav2vec_extractor": c_face["wav2vec_extractor"]}
    return dict(pipe=pipe, ae=ae, ev=ev, ds=ds, ds_raw=ds_raw, rig=rig, states=states,
                launches=launches)


def phase21(p20: dict, card: str) -> None:
    """Each runner's ms per clip and its parts, beside the card."""
    from talkshow_torch.eval import runners
    from talkshow_torch.models.body import generate_conv_poses
    from talkshow_torch.models.wav2vec_fused import face_apply_fused, pack_face_tables
    from talkshow_torch.ops import pose as pose_ops
    from talkshow_torch.ops.audio import onset_times
    from talkshow_torch.ops.smplx_lbs import smplx_forward_talkshow
    pipe, ae, ev, ds, ds_raw, rig = (p20[k] for k in ("pipe", "ae", "ev", "ds", "ds_raw", "rig"))
    n, S, dev = len(ds.clips), EVAL["samples"], pipe.device
    vq_b, vq_h, states = pipe.body.vq_body, pipe.body.vq_hand, p20["states"]
    totals = {
        "eval_vq_capacity": cuda_ms(lambda: runners.eval_vq_capacity(vq_b, vq_h, states, ds)),
        "eval_body": cuda_ms(lambda: runners.eval_body(pipe, ae, ds, S, smplx_model=rig)),
        "eval_face": cuda_ms(lambda: runners.eval_face(pipe.face_model, ds_raw, rig)),
    }
    clip, raw = ds.clips[0], ds_raw.clips[0]
    T = clip.poses.shape[0] - clip.poses.shape[0] % 4
    conv = torch.as_tensor(runners._conv_channels(clip.poses[:T]), device=dev)[None]
    feat = torch.as_tensor(clip.aud_feat[:T], device=dev)[None].expand(S, -1, -1).contiguous()
    ids = torch.zeros(S, dtype=torch.long, device=dev)
    gen = torch.Generator().manual_seed(21)
    betas = torch.as_tensor(clip.betas, device=dev)
    full = pose_ops.part2full(torch.as_tensor(np.concatenate(
        [clip.poses[:T, :3], runners._conv_channels(clip.poses[:T]), clip.expression[:T]], -1),
        device=dev))
    full_face = torch.as_tensor(np.concatenate([raw.poses, raw.expression], -1), device=dev)
    wav = torch.as_tensor(raw.aud_feat.reshape(1, -1), device=dev)
    onehot = torch.zeros((1, 4), device=dev)
    tables = pack_face_tables(pipe.face_model, torch.float32)
    with torch.no_grad():
        pred = generate_conv_poses(pipe.body, feat, ids, generator=gen,
                                   tables=pipe._decode_tables)[0]
        parts = {
            "eval_vq_capacity": {"VQ round trip (K4 x 2)": cuda_ms(lambda: (
                vq_b(conv[..., :39], states["body"]), vq_h(conv[..., 39:], states["hand"])), 3)},
            "eval_body": {
                f"decode S={S} (audio encoder, K1, VQ decoders)": cuda_ms(
                    lambda: generate_conv_poses(pipe.body, feat, ids, generator=gen,
                                                tables=pipe._decode_tables), 3),
                "AE extract (real + generated)": cuda_ms(
                    lambda: (ev.extract(conv), ev.extract(pred)), 3),
                "LBS joints (real + generated)": cuda_ms(lambda: [smplx_forward_talkshow(
                    rig, betas, full, return_verts=False) for _ in range(2)], 3),
                "onset times": cuda_ms(lambda: onset_times(clip.audio_path, device=dev), 3),
                f"FGD over {n} clips / {n}": cuda_ms(ev.get_scores, 3) / n,
                f"bootstrap CI (200 draws, host f64) / {n}": cuda_ms(ev.bootstrap_fgd) / n,
            },
            "eval_face": {
                "face stage (K3 + K2, f32 tables)": cuda_ms(lambda: face_apply_fused(
                    pipe.face_model, wav, onehot, raw.poses.shape[0], tables=tables), 3),
                f"LBS vertices x 2 (V={EVAL['verts']})": cuda_ms(lambda: [
                    smplx_forward_talkshow(rig, betas, full_face) for _ in range(2)], 3),
            },
        }
    for name, total in totals.items():
        log(f"phase 21 {name}: {total / n:.2f} ms per {EVAL['seconds']:.0f} s clip ({n} clips, "
            f"{total:.1f} ms a call); parts per clip: "
            + ", ".join(f"{k} {v:.2f}" for k, v in parts[name].items()) + f" ms [{card}]")


def phase22(dev, tmp: str, card: str) -> dict:
    """The LS3DCG baseline through `python -m talkshow_torch.train`'s entry
    point at the stage-1 batch and window on the synthetic dataset; resume;
    one step CUDA against CPU; the step's p50.  Returns its checkpoint, its
    generator and the p50."""
    from talkshow_torch.kernels import counts
    from talkshow_torch.models.ls3dcg import LS3DCGDiscriminator, LS3DCGGenerator
    from talkshow_torch.train.__main__ import main as train_main
    from talkshow_torch.train.steps import make_ls3dcg_step
    cfg = os.path.join(tmp, "ls3dcg.json")
    write_stage_config(cfg, "s2g_LS3DCG", 1)
    run_a, run_b = os.path.join(tmp, "ls_a"), os.path.join(tmp, "ls_b")
    argv = ["--config_file", cfg, "--synthetic", "--epochs", "1", "--device", str(dev)]
    counts.clear()
    t0 = time.time()
    trainer = train_main(argv + ["--run_dir", run_a])
    torch.cuda.synchronize()
    seen, steps, t_epoch = dict(counts), trainer.global_step, time.time() - t0
    logged = logged_values(run_a)
    ckpt = os.path.join(run_a, "ckpt-0.pt")
    # no kernel of K1-K4; the Adam chain's two kernels once an optimizer a step
    launched = any(v for k, v in seen.items() if k not in ("host_sync", "grad_stats",
                                                           "adam_apply"))
    adam_ok = seen.get("grad_stats") == seen.get("adam_apply") == 2 * steps
    if (steps < 10 or launched or not adam_ok or not logged
            or not all(math.isfinite(v) for v in logged) or not os.path.isfile(ckpt)):
        raise AssertionError(f"phase 22: {steps} steps, counts {seen}, logged {logged[:12]}, "
                             f"checkpoint {os.path.isfile(ckpt)}")
    log(f"phase 22 train-ls3dcg: python -m talkshow_torch.train s2g_LS3DCG, batch "
        f"{TRAIN['batch']}, window {TRAIN['window']}: {steps} steps in {t_epoch:.1f} s (first "
        f"cuDNN calls included); {len(logged)} logged values all finite; none of K1-K4 "
        f"launched (the generator and discriminator are convolutions), the Adam kernels "
        f"{seen['adam_apply']} = 2 x {steps}; {os.path.basename(ckpt)} written")

    # resume + one step == the uninterrupted run's next step
    keys = ("poses", "expression", "aud_feat")
    resumed = train_main(argv + ["--run_dir", run_b, "--resume", ckpt])
    raw = next(trainer.dataset.batches(TRAIN["batch"], np.random.default_rng(99)))
    batch = trainer.put_batch({k: raw[k] for k in keys})
    _, m_a = trainer.step_fn(trainer.state, batch)
    _, m_b = resumed.step_fn(resumed.state, resumed.put_batch({k: raw[k] for k in keys}))
    if not (all(float(m_a[k]) == float(m_b[k]) for k in m_a)
            and states_equal(trainer.state.state_dict(), resumed.state.state_dict())):
        raise AssertionError("phase 22: resume + one step differs from the uninterrupted run")
    log(f"phase 22 resume: ckpt-0 + one step equals the uninterrupted run's next step bit for "
        f"bit (both models' parameters, BatchNorm statistics and Adam states; {len(m_a)} "
        f"metrics)")
    del resumed

    # one step from one state, CUDA against CPU (B = 8, TF32 off)
    lr = 1e-4

    def fresh(device):
        init, step = make_ls3dcg_step(LS3DCGGenerator(), LS3DCGDiscriminator(), lr)
        return init(torch.Generator().manual_seed(22), device), step

    (s_cpu, step_cpu), (s_gpu, step_gpu) = fresh("cpu"), fresh(dev)
    b8 = {k: torch.as_tensor(raw[k][:8]) for k in keys}
    _, mc = step_cpu(s_cpu, b8)
    _, mg = step_gpu(s_gpu, {k: v.to(dev) for k, v in b8.items()})
    rel = max(rel_err(float(mg[k]), float(mc[k])) for k in mc if k != "nonfinite_skips")
    g_err = grad_errors(s_cpu.models, s_gpu.models)
    stat_err = p_err = 0.0
    within = total = 0
    for name, mc_model in s_cpu.models.items():
        sg = s_gpu.models[name].state_dict()
        for k, v in mc_model.state_dict().items():
            d = (sg[k].cpu() - v).abs()
            if k.endswith(("running_mean", "running_var")):
                stat_err = max(stat_err, d.max().item())
            elif not k.endswith("num_batches_tracked"):
                p_err = max(p_err, d.max().item())
                within += int((d <= 1e-2 * lr).sum())
                total += d.numel()
    share = within / total
    if not (rel <= 1e-4 and max(g_err.values()) <= 2e-2 and stat_err <= 1e-4
            and p_err <= 2 * lr * (1 + 1e-3) and share >= 0.99):
        raise AssertionError(f"phase 22 CUDA vs CPU: losses rel {rel}, gradients {g_err}, "
                             f"statistics {stat_err}, params {p_err}, share {share}")
    log(f"phase 22 CUDA vs CPU, one step from one state (B=8, T={TRAIN['window']}, TF32 off): "
        f"losses within {rel:.2e} relative <= 1e-4; gradients within "
        + ", ".join(f"{k} {v:.2e}" for k, v in g_err.items())
        + f" of max|g| <= 2e-2 (behind batch-statistics BatchNorm, as phase 19); BatchNorm "
        f"statistics within {stat_err:.2e} <= 1e-4; parameters within {p_err:.2e} <= 2 lr, "
        f"{share:.4%} within 1e-2 lr >= 99 %")
    del s_cpu, s_gpu

    p50, lo, hi = step_p50(lambda: trainer.step_fn(trainer.state, batch))
    log(f"phase 22 LS3DCG step B={TRAIN['batch']} T={TRAIN['window']}: p50 {p50:.2f} ms (min "
        f"{lo:.2f}, max {hi:.2f}) over 10 steps, {TRAIN['batch'] / p50 * 1e3:.1f} windows/s "
        f"[{card}]")
    return dict(ckpt=ckpt, gen=trainer.state.models["gen"], p50=p50)


def phase23(p20: dict, ls: dict, tmp: str, ae_ckpt: str, wav10: str, card: str) -> None:
    """eval_ls3dcg on phase 20's synthetic SHOW split with phase 19's AE, its
    ms per clip; `python -m talkshow_torch.eval ls3dcg` on the card by
    default; infer_on_audio on the 10 s clip."""
    import contextlib
    import io

    from talkshow_torch.eval import runners
    from talkshow_torch.eval.__main__ import main as eval_main
    from talkshow_torch.kernels import counts
    from talkshow_torch.models.ls3dcg import infer_on_audio
    gen, ae, ds = ls["gen"], p20["ae"], p20["ds"]
    n = len(ds.clips)
    counts.clear()
    res = runners.eval_ls3dcg(gen, ae, ds)
    torch.cuda.synchronize()
    seen, values = dict(counts), metric_values(res)
    if not (res["num_clips"] == n and {"fgd_ci", "body_l1_ci"} <= res.keys()
            and all(math.isfinite(v) for v in values)
            and not any(v for k, v in seen.items() if k != "host_sync")):
        raise AssertionError(f"phase 23 eval_ls3dcg: {sorted(res)}, counts {seen}")
    total = cuda_ms(lambda: runners.eval_ls3dcg(gen, ae, ds))
    clip = ds.clips[0]
    T = clip.poses.shape[0] - clip.poses.shape[0] % 8
    feat = torch.as_tensor(clip.aud_feat[None, :T], device=next(gen.parameters()).device)
    with torch.no_grad():
        fwd = cuda_ms(lambda: gen(feat), 3)
    log(f"phase 23 eval_ls3dcg: body_l1 {res['body_l1']:.5f}, hand_l1 {res['hand_l1']:.5f}, "
        f"jaw_l1 {res['jaw_l1']:.5f}, exp_mse {res['exp_mse']:.5f}, fgd {res['fgd']:.4f} (CI "
        f"{res['fgd_ci']['p2_5']:.4f}-{res['fgd_ci']['p97_5']:.4f}) over {n} clips, "
        f"{len(values)} values finite, no kernel; {total / n:.2f} ms per "
        f"{EVAL['seconds']:.0f} s clip ({total:.1f} ms a call; the generator forward at T={T} "
        f"{fwd:.2f} ms) [{card}]")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli = eval_main(["ls3dcg", "--data_root", os.path.join(tmp, "show"), "--ls3dcg_ckpt",
                         ls["ckpt"], "--ae_ckpt", ae_ckpt])
    printed = json.loads(out.getvalue().strip().splitlines()[-1])
    if not (printed["num_clips"] == n and all(math.isfinite(v) for v in metric_values(cli))):
        raise AssertionError(f"phase 23 CLI: {printed.get('num_clips')} clips")
    log(f"phase 23 eval CLI: python -m talkshow_torch.eval ls3dcg (its main(), no --device) on "
        f"the tree with phase 22's ckpt-0 and phase 19's AE: body_l1 {cli['body_l1']:.5f}, fgd "
        f"{cli['fgd']:.4f} over {n} clips")
    motion = infer_on_audio(gen, wav10, num_samples=2)
    if motion.shape != (2, 300, 265) or not np.isfinite(motion).all():
        raise AssertionError(f"phase 23 infer_on_audio: {motion.shape}")
    ms = cuda_ms(lambda: infer_on_audio(gen, wav10), 3)
    log(f"phase 23 infer_on_audio: 10 s clip -> {motion.shape}, finite, {ms:.2f} ms (MFCC, "
        f"generator, reorder, part2full on the host) [{card}]")


def k1_bound(tables: dict, L: int, d: int, K: int, H: int) -> tuple[float, str]:
    """K1's bound for one decode of H rows from its tables: the MACs of both
    columns' vertical stack, v2h, fusion_v and the chain's streams per row;
    every table read once (column 1 reads every chain table, column 0 a
    part of wh), the tokens written, the per-call f32 inputs read."""
    from talkshow_torch.kernels import ar_decode
    steps = ar_decode.chain_steps(L, d, K, 512)
    chain_macs = sum(klen * n * urows for _, _, _, klen, n, urows in steps)
    esize = tables["emb"].element_size()
    chain_bytes = sum(esize * klen * n * urows for _, c, _, klen, n, urows in steps if c == 1)
    ops = 2.0 * H * (tables["wv0"].numel() + tables["wvB"].numel() + 2 * tables["wv2h"].numel()
                     + 2 * tables["wfv"].numel() + chain_macs)
    nb = nbytes(*(v for k, v in tables.items() if k != "chain")) + chain_bytes \
        + H * 2 * 4 + 4 * (L * 2 * d + 2 * H * d)
    return bound(nb, ops)


#: the 6-D variant (scripts/train.py:109-158): VQ-VAEs over 78 / 180
#: channels, the prior 512 wide and 10 layers deep
SIX_D = dict(body=78, hand=180, dim=512, layers=10)


def phase24(dev, tmp: str, wav10: str, card: str) -> dict:
    """The 6-D variant at full width: the s2g_body_vq CLI for one epoch (K4
    twice a step), s2g_body_pixel on its checkpoint with the 512 x 10
    prior for two epochs (K4 on cache misses only), eval_vq_capacity on
    phase 20's split in 6-D, and generate_conv_poses through K1 at dim 512,
    10 layers: tokens against the plain sampler, K1's ms and bound.
    Returns the launches and K1's row."""
    from talkshow_torch.data.dataset import ShowDataset
    from talkshow_torch.eval import runners
    from talkshow_torch.kernels import ar_decode, counts
    from talkshow_torch.models.body import BodyModels, generate_conv_poses
    from talkshow_torch.models.pixelcnn import gumbel_noise, sample_tokens
    from talkshow_torch.ops.audio import get_mfcc
    from talkshow_torch.train.__main__ import main as train_main
    cfg1, cfg2 = os.path.join(tmp, "body_vq_6d.json"), os.path.join(tmp, "body_pixel_6d.json")
    write_stage_config(cfg1, "s2g_body_vq", 1, rep6d=True)
    write_stage_config(cfg2, "s2g_body_pixel", 2, rep6d=True)
    base = ["--synthetic", "--device", str(dev), "--epochs", "1"]
    counts.clear()
    t0 = time.time()
    vq = train_main(["--config_file", cfg1, "--run_dir", os.path.join(tmp, "vq6d")] + base)
    torch.cuda.synchronize()
    c1, s1, t1 = dict(counts), vq.global_step, time.time() - t0
    vb, vh = vq.state.models["body"], vq.state.models["hand"]
    widths = (vb.decoder.project.out_channels, vh.decoder.project.out_channels,
              vq.dataset.clips[0].poses.shape[-1])
    logged = logged_values(os.path.join(tmp, "vq6d"))
    if (s1 < 10 or widths != (SIX_D["body"], SIX_D["hand"], 330)
            or c1.get("nearest_code", 0) != 2 * s1 or c1.get("nearest_code_plain", 0)
            or not all(math.isfinite(v) for v in logged)):
        raise AssertionError(f"phase 24 6-D stage 1: {s1} steps, widths {widths}, counts {c1}")
    log(f"phase 24 6-D s2g_body_vq: batch {TRAIN['batch']}, window {TRAIN['window']}, poses 330, "
        f"VQ-VAEs over {widths[0]} / {widths[1]} channels at {TRAIN['num_hiddens']} hidden: {s1} "
        f"steps in {t1:.1f} s; nearest_code launches {c1['nearest_code']} = 2 a step, plain 0; "
        f"{len(logged)} logged values finite")

    argv2 = ["--config_file", cfg2, "--run_dir", os.path.join(tmp, "pixel6d"), "--vq_ckpt",
             os.path.join(tmp, "vq6d", "ckpt-0.pt")] + base
    counts.clear()
    t0 = time.time()
    px = train_main(argv2)
    torch.cuda.synchronize()
    e1, s2, t2 = dict(counts), px.global_step, time.time() - t0
    prior = px.state.models["prior"]
    keys = px.dataset.window_keys()
    fills = -(-(len(keys) - TRAIN["batch"] * s2) // TRAIN["batch"])
    if ((prior.dim, prior.n_layers) != (SIX_D["dim"], SIX_D["layers"]) or s2 < 10
            or e1.get("nearest_code", 0) != 2 * (s2 + fills) or e1.get("nearest_code_plain", 0)):
        raise AssertionError(f"phase 24 6-D stage 2 epoch 1: prior {prior.dim} x "
                             f"{prior.n_layers}, {s2} steps, counts {e1}, {fills} fills")
    seen = set(px._token_cache)
    misses = sum(not all(tuple(map(int, k)) in seen for k in b["window_key"])
                 for b in px.batch_iter(1))
    counts.clear()
    t0 = time.time()
    px.train(epochs=2)
    torch.cuda.synchronize()
    e2, t3 = dict(counts), time.time() - t0
    logged = logged_values(os.path.join(tmp, "pixel6d"))
    if (e2.get("nearest_code", 0) != 2 * misses or e2.get("nearest_code_plain", 0)
            or not all(math.isfinite(v) for v in logged)):
        raise AssertionError(f"phase 24 6-D stage 2 epoch 2: {misses} misses, counts {e2}")
    log(f"phase 24 6-D s2g_body_pixel on its ckpt-0.pt: prior {prior.dim} x {prior.n_layers} "
        f"over {prior.input_dim} codes; epoch 1 {s2} steps in {t2:.1f} s, nearest_code "
        f"{e1['nearest_code']} = 2 x ({s2} missed batches + {fills} fill batches); epoch 2 in "
        f"{t3:.1f} s, nearest_code {e2.get('nearest_code', 0)} = 2 x {misses} misses; plain 0; "
        f"{len(logged)} logged values finite")
    log(f"phase 24 6-D token cache: {distinct_codes(px._token_cache)}")

    ds6 = ShowDataset.from_root(os.path.join(tmp, "show"), SPEAKERS, "test", convert_to_6d=True,
                                device=dev)
    counts.clear()
    cap = runners.eval_vq_capacity(vb, vh, vq.state.vq, ds6)
    torch.cuda.synchronize()
    c_cap = dict(counts)
    if (ds6.clips[0].poses.shape[-1] != 330 or c_cap.get("nearest_code") != 2 * len(ds6.clips)
            or c_cap.get("nearest_code_plain") or not math.isfinite(cap["capacity_l1"])):
        raise AssertionError(f"phase 24 eval_vq_capacity 6-D: {cap}, counts {c_cap}")
    log(f"phase 24 eval_vq_capacity on the 6-D split ({len(ds6.clips)} clips of 330-wide poses): "
        f"capacity_l1 {cap['capacity_l1']:.6f}; nearest_code launches {c_cap['nearest_code']} = "
        f"2 a clip, plain 0")

    body = BodyModels(vb.eval(), vh.eval(), vq.state.vq["body"], vq.state.vq["hand"],
                      px.state.models["audio"].eval(), prior.eval())
    feat10 = get_mfcc(wav10, device=dev)
    H, K = feat10.shape[0] // 4, prior.input_dim
    t32 = ar_decode.pack_decode_tables(prior, torch.float32)
    t16 = ar_decode.pack_decode_tables(prior, torch.bfloat16)
    rounded = ar_decode.round_like_tables(prior, torch.bfloat16)
    k1_launches = 0
    worst = 0.0
    for S in (1, 2, 8):
        feat = feat10[None].expand(S, -1, -1).contiguous()
        ids = torch.arange(S, device=dev) % 4
        noise = gumbel_noise((H, 2, S, K), torch.Generator().manual_seed(S), dev)
        counts.clear()
        conv, tok = generate_conv_poses(body, feat, ids, noise=noise, tables=t32)
        torch.cuda.synchronize()
        c = dict(counts)
        k1_launches += c.get("ar_decode", 0)
        with torch.no_grad():
            audio = body.audio_enc(feat)
            want = sample_tokens(prior, ids, audio, noise=noise)
            _, lg = ar_decode.sample_tokens_fused(prior, ids, audio, tables=t32, noise=noise,
                                                  prefix_tokens=want, prefix_len=H,
                                                  return_logits=True)
            _, lg_ref = sample_tokens(prior, ids, audio, noise=noise, prefix_tokens=want,
                                      prefix_len=H, return_logits=True)
            _, lg16 = ar_decode.sample_tokens_fused(prior, ids, audio, tables=t16, noise=noise,
                                                    prefix_tokens=want, prefix_len=H,
                                                    return_logits=True)
            _, lg16_ref = sample_tokens(rounded, ids, audio, noise=noise, prefix_tokens=want,
                                        prefix_len=H, return_logits=True)
        err = (lg - lg_ref).abs().max().item()
        worst = max(worst, err)
        rel16 = (lg16 - lg16_ref).abs().max().item() / lg16_ref.abs().max().item()
        g = noise.permute(2, 0, 1, 3)
        agree = (torch.argmax(lg16 + g, -1) == torch.argmax(lg16_ref + g, -1)).float().mean().item()
        if not (conv.shape == (S, 4 * H, 258) and torch.isfinite(conv).all()
                and torch.equal(tok, want) and c.get("ar_decode") == 1
                and not c.get("sample_tokens_plain") and err <= 1e-3 and rel16 <= 1e-3
                and agree >= 0.97):
            raise AssertionError(f"phase 24 K1 at dim 512 B={S}: shape {tuple(conv.shape)}, "
                                 f"tokens equal {torch.equal(tok, want)}, counts {c}, f32 "
                                 f"max|dlogit| {err}, bf16 rel {rel16}, agree {agree}")
        log(f"phase 24 K1 6-D prior (dim {prior.dim} x {prior.n_layers}) B={S}: "
            f"generate_conv_poses -> {tuple(conv.shape)} finite, K1 launched once (f32 tables, "
            f"shared noise): tokens equal the plain sampler's {tok.numel()}/{tok.numel()}, "
            f"teacher-forced max|dlogit| {err:.3e} <= 1e-3; bf16 tables vs the bf16-rounded "
            f"plain version max|dlogit|/max|logit| {rel16:.3e} <= 1e-3, draws agree "
            f"{agree:.4f} >= 0.97; launch: shared memory {ar_decode.last_launch['smem_bytes']} "
            f"B/CTA, ring {ar_decode.last_launch['ring_stages']} stages")

    # a batch past one launch: the wrapper raises before launching; the decode chunks
    fits = ar_decode.model_max_batch(prior, torch.bfloat16)
    S = 32
    feat = feat10[None].expand(S, -1, -1).contiguous()
    ids = torch.arange(S, device=dev) % 4
    gen = torch.Generator().manual_seed(24)
    with torch.no_grad():
        audio = body.audio_enc(feat)
    counts.clear()
    try:
        ar_decode.sample_tokens_fused(prior, ids, audio, tables=t16, generator=gen)
        raise AssertionError(f"phase 24: a batch of {S} at dim 512 launched")
    except ValueError as e:
        if f"largest batch that fits is {fits}" not in str(e) or counts.get("ar_decode"):
            raise
    conv, _ = generate_conv_poses(body, feat, ids, generator=gen, tables=t16)
    torch.cuda.synchronize()
    chunks = counts.get("ar_decode", 0)
    k1_launches += chunks
    if (chunks != -(-S // fits) or conv.shape != (S, 4 * H, 258)
            or counts.get("sample_tokens_plain")):
        raise AssertionError(f"phase 24 B={S}: {chunks} launches, {tuple(conv.shape)}")
    log(f"phase 24 K1 B={S} at dim 512: the wrapper raises before any launch (largest batch "
        f"{fits}); generate_conv_poses decodes it in {chunks} launches (chunks of {fits}), no "
        f"plain sampler")

    # times, bf16 tables and Philox, as phase 5
    ms = {}
    for S in (1, 8, fits):
        with torch.no_grad():
            aud = body.audio_enc(feat10[None].expand(S, -1, -1).contiguous())
        lab = torch.zeros(S, dtype=torch.long, device=dev)
        ms[S] = cuda_ms(lambda: ar_decode.sample_tokens_fused(prior, lab, aud, tables=t16,
                                                              generator=gen), 5)
        if S == 1:
            tl = ar_decode.decode_timeline(prior, lab, aud, t16, torch.Generator().manual_seed(1))
            plain = cuda_ms(lambda: sample_tokens(prior, lab, aud, generator=gen))
    steps = len(ar_decode.chain_steps(prior.n_layers, prior.dim, K, 512)) + 2
    bms, by = k1_bound(t16, prior.n_layers, prior.dim, K, H)
    log(f"phase 24 K1 6-D prior, H={H}, bf16 tables, Philox: B=1 {ms[1]:.3f} ms "
        f"({ms[1] * 1e3 / H:.1f} us/row, {steps} dependent steps a row), B=8 {ms[8]:.3f} ms, "
        f"B={fits} {ms[fits]:.3f} ms; plain decode B=1 {plain:.2f} ms; bound at B=1 {bms:.4f} ms "
        f"({by}) = {bms / ms[1]:.2%} of K1's time [{card}]")
    log("phase 24 K1 6-D B=1 timeline (%globaltimer, mean over rows 1-74, us): "
        + ", ".join(f"{k[:-3]} {v:.2f}" for k, v in tl.items()))
    return dict(ar_decode=k1_launches, nearest_code=c1["nearest_code"] + e1["nearest_code"]
                + e2.get("nearest_code", 0) + c_cap["nearest_code"], k1_ms=ms, k1_plain=plain,
                k1_bound=(bms, by), k1_err=worst)


#: the SHOW-layout train split of phase 25 (8 clips of 20 s: 5 batches of
#: 128 windows of 88 frames)
SHOW_TRAIN = dict(clips=8, seconds=20.0)


def phase25(dev, tmp: str, card: str) -> dict:
    """The SHOW layout: preprocess's filter and split on phase 20's tree;
    the train CLI without --synthetic for s2g_body_vq (MFCC windows, K4)
    and s2g_face (whole raw clips, K3) on a synthetic train split."""
    from talkshow_torch.data.preprocess import preprocess
    from talkshow_torch.kernels import counts
    from talkshow_torch.train.__main__ import main as train_main
    splits = preprocess(os.path.join(tmp, "show"), SPEAKERS, os.path.join(tmp, "split.json"))
    sizes = {k: len(v) for k, v in splits.items()}
    n = EVAL["clips"]
    if sizes != {"train": int(n * 0.8), "val": int(n * 0.1), "test": n - int(n * 0.8)
                 - int(n * 0.1)}:
        raise AssertionError(f"phase 25 preprocess: {sizes}")
    log(f"phase 25 preprocess on phase 20's tree: {n} clips scanned, all kept (readable wav, "
        f">= 90 frames, finite poses), split {sizes} (seed 0)")
    root = os.path.join(tmp, "show_train")
    write_show_tree(root, SHOW_TRAIN["clips"], SHOW_TRAIN["seconds"], split="train")
    out = {}
    for stage, kernel in (("s2g_body_vq", "nearest_code"), ("s2g_face", "wav2vec_extractor")):
        cfg = os.path.join(tmp, f"{stage}_show.json")
        write_stage_config(cfg, stage, 1)
        run = os.path.join(tmp, f"{stage}_show")
        counts.clear()
        t0 = time.time()
        tr = train_main(["--config_file", cfg, "--data_root", root, "--epochs", "1",
                         "--run_dir", run])
        torch.cuda.synchronize()
        c, steps, secs = dict(counts), tr.global_step, time.time() - t0
        logged = logged_values(run)
        feat = tr.dataset.clips[0].aud_feat.shape[-1]
        per = 2 if stage == "s2g_body_vq" else 1
        if (len(tr.dataset.clips) != SHOW_TRAIN["clips"] or steps < 3 or feat != (
                64 if per == 2 else 1) or c.get(kernel) != per * steps
                or c.get("nearest_code_plain") or c.get("extractor_plain")
                or not all(math.isfinite(v) for v in logged)):
            raise AssertionError(f"phase 25 {stage}: {len(tr.dataset.clips)} clips, {steps} "
                                 f"steps, feature width {feat}, counts {c}")
        out[kernel] = c[kernel]
        log(f"phase 25 {stage} on the SHOW layout (--data_root, no --synthetic): "
            f"{SHOW_TRAIN['clips']} train clips of {SHOW_TRAIN['seconds']:.0f} s through "
            f"from_root ({'MFCC windows' if per == 2 else 'whole raw 16 kHz clips'}), {steps} "
            f"steps in {secs:.1f} s (loading included); {kernel} launches {c[kernel]} = {per} a "
            f"step; {len(logged)} logged values finite [{card}]")
    return out


def cli_run(fn, argv: list, reps: int = 1):
    """fn(argv) `reps` times -> (the last result, p50 wall s, the last call's
    launch counts)."""
    from talkshow_torch.kernels import counts
    secs = []
    for _ in range(reps):
        counts.clear()
        t0 = time.time()
        out = fn(argv)
        torch.cuda.synchronize()
        secs.append(time.time() - t0)
        seen = dict(counts)
    return out, float(np.median(secs)), seen


def launch_line(c: dict) -> str:
    return ", ".join(f"{k} {c.get(k, 0)}" for k in KERNELS[:3])


def phase26(dev, tmp: str, wav10: str, card: str) -> dict:
    """The user entry points on the 10 s clip at full width (random weights
    from --seed), each through its main(argv) on the card: the demo's
    default mode (held to Pipeline.generate with the same seed, bit for
    bit), --only_face, --continuity, --streaming, --norm_stats, --model
    ls3dcg on phase 22's checkpoint; diversity at 4 x 3; continuity;
    convert_checkpoints on the golden fixtures, loaded back into a pipeline
    of their widths on the card.  Returns the K1-K3 launches and the
    default mode's motion."""
    from talkshow_torch import continuity, convert, convert_checkpoints, demo, diversity
    from talkshow_torch.pipeline import Pipeline, load_pipeline
    out = os.path.join(tmp, "demo")
    base = ["--audio_file", wav10, "--out_dir", out]
    total: dict = {}

    def record(tag, secs, c, want, what):
        if any(c.get(k, 0) != want.get(k, 0) for k in KERNELS[:3]) or c.get(
                "sample_tokens_plain") or c.get("face_plain"):
            raise AssertionError(f"phase 26 {tag}: counts {c}, expected {want}")
        for k in KERNELS[:3]:
            total[k] = total.get(k, 0) + c.get(k, 0)
        log(f"phase 26 {tag}: {what}; {secs * 1e3:.1f} ms wall (the CLI's main, pipeline "
            f"creation included); launches {launch_line(c)}, plain sampler and face stage "
            f"0 [{card}]")

    one = {"ar_decode": 1, "wav2vec_layers": 1, "wav2vec_extractor": 1}
    motion, secs, c = cli_run(demo.main, base + ["--seed", "0"], reps=3)
    saved = np.load(os.path.join(out, "speech10.npy"))
    ref = Pipeline.create(0, dev).generate(wav10, speaker=0, num_samples=1, seed=0)
    if not (motion.shape == (1, 300, 265) and np.isfinite(motion).all()
            and np.array_equal(saved, motion.reshape(-1, 265)) and np.array_equal(motion, ref)):
        raise AssertionError(f"phase 26 demo: {motion.shape}, equal to generate "
                             f"{np.array_equal(motion, ref)}")
    record("demo (default)", secs, c, one, f"(1, 300, 265) finite, saved (300, 265) as "
           f"speech10.npy, equal bit for bit to Pipeline.create(0).generate(seed=0) (p50 of 3)")
    for tag, extra, want in (("demo --only_face", ["--only_face"],
                              {"wav2vec_layers": 1, "wav2vec_extractor": 1}),
                             ("demo --continuity", ["--continuity"], dict(one, ar_decode=2))):
        m, secs, c = cli_run(demo.main, base + extra)
        if m.shape != (1, 300, 265) or not np.isfinite(m).all():
            raise AssertionError(f"phase 26 {tag}: {m.shape}")
        record(tag, secs, c, want, f"{m.shape} finite")
    m, secs, c = cli_run(demo.main, base + ["--streaming"])
    steps = c.get("ar_decode", 0)
    if m.shape != (1, 300, 265) or not np.isfinite(m).all() or steps < 9:
        raise AssertionError(f"phase 26 demo --streaming: {m.shape}, counts {c}")
    record("demo --streaming", secs, c, {k: steps for k in KERNELS[:3]},
           f"{m.shape} finite from 10 feeds of 1 s, {steps} session steps (K1, K2, K3 once a "
           f"step)")
    rng = np.random.default_rng(26)
    stats = np.stack([rng.standard_normal(165), rng.uniform(0.5, 1.5, 165)]).astype(np.float32)
    np.save(os.path.join(tmp, "norm_stats.npy"), stats)
    m, secs, c = cli_run(demo.main, base + ["--norm_stats", os.path.join(tmp, "norm_stats.npy")])
    if m.shape != (1, 300, 265) or not np.isfinite(m).all() or np.array_equal(m, motion):
        raise AssertionError(f"phase 26 demo --norm_stats: {m.shape}")
    record("demo --norm_stats", secs, c, one, f"{m.shape} finite, body denormalized")
    m, secs, c = cli_run(demo.main, base + ["--model", "ls3dcg", "--num_sample", "2",
                                            "--ls3dcg_ckpt", os.path.join(tmp, "ls_a",
                                                                          "ckpt-0.pt")])
    if m.shape != (2, 300, 265) or not np.isfinite(m).all():
        raise AssertionError(f"phase 26 demo --model ls3dcg: {m.shape}")
    record("demo --model ls3dcg", secs, c, {}, f"{m.shape} finite from phase 22's ckpt-0.pt "
           f"(no kernel: MFCC and the generator)")
    scores, secs, c = cli_run(diversity.main, ["--audio_file", wav10, "--num_sample", "3",
                                               "--out_dir", out])
    div = np.load(os.path.join(out, "speech10_diversity.npy"))
    if div.shape != (4, 3, 300, 129) or not all(math.isfinite(v) for v in scores.values()):
        raise AssertionError(f"phase 26 diversity: {div.shape}, {scores}")
    record("diversity 4 x 3", secs, c, {"ar_decode": 4},
           f"(4, 3, 300, 129) finite, scores " + ", ".join(f"{v:.4f}" for v in scores.values()))
    m, secs, c = cli_run(continuity.main, ["--audio_file", wav10, "--out_dir", out])
    if m.shape != (1, 300, 265) or not np.isfinite(m).all():
        raise AssertionError(f"phase 26 continuity: {m.shape}")
    record("continuity", secs, c, dict(one, ar_decode=2), f"{m.shape} finite, "
           f"speech10_continuity.npy")

    # the golden fixtures through convert_checkpoints, loaded into a pipeline
    # of their widths on the card
    gold = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures", "golden")
    with open(os.path.join(gold, "meta.json")) as f:
        meta = json.load(f)
    px = meta["pixel"]
    pipe = Pipeline.create(0, dev, convert.config_from_hf(meta["hf_wav2vec"]),
                           num_hiddens=meta["vq_hid"], code_num=px["K"], pixel_dim=px["dim"],
                           pixel_layers=px["n_layers"], audio_channels=px["aud_ch"])
    t0 = time.time()
    for kind in ("face", "body_vq", "body_pixel"):
        path = os.path.join(tmp, f"{kind}.pt")
        convert_checkpoints.main([kind, "--src", os.path.join(gold, f"{kind}.pth"),
                                  "--out", path])
        load_pipeline(path, template=pipe)
    secs = time.time() - t0
    exp = dict(np.load(os.path.join(gold, "expected.npz")))
    with torch.no_grad():
        wav = torch.as_tensor(exp["face_wav"], device=dev).reshape(1, -1)
        face = pipe.face_model(wav, torch.zeros((1, 4), device=dev),
                               exp["face_out"].shape[1]).cpu().numpy()
        idx = torch.as_tensor(exp["vq_idx_hand"], device=dev)
        rec = pipe.body.vq_hand.decode_latents(idx, pipe.body.vq_hand_state)
    d_face = float(np.abs(face - exp["face_out"]).max())
    d_rec = float(np.abs(rec.transpose(1, 2).cpu().numpy() - exp["vq_rec_hand"]).max())
    if d_face > 5e-4 or d_rec > 2e-4:
        raise AssertionError(f"phase 26 convert_checkpoints: face {d_face}, hand decode {d_rec}")
    log(f"phase 26 convert_checkpoints face / body_vq / body_pixel on the golden fixtures in "
        f"{secs * 1e3:.1f} ms, loaded by load_pipeline into a pipeline of their widths on the "
        f"card: the face module's output within {d_face:.2e} <= 5e-4 and the hand VQ decode "
        f"within {d_rec:.2e} <= 2e-4 of the replicas' (expected.npz); no kernel [{card}]")
    return dict(launches=total, motion=motion)


def phase27(dev, tmp: str, motion: np.ndarray, wav10: str, card: str) -> None:
    """Rendering 30 frames of the demo's motion in whole_body mode without
    captions: LBS on the card over the synthetic rig at the official size,
    then the native rasterizer; its frames held to the numpy rasterizer;
    the mp4 writer where cv2 is installed."""
    import importlib.util
    import shutil

    from talkshow_torch import native, render
    from talkshow_torch.ops import smplx_lbs
    npz = os.path.join(tmp, "smplx_synthetic.npz")
    np.savez(npz, **smplx_lbs.build_synthetic_smplx_arrays(num_verts=EVAL["verts"]))
    model = smplx_lbs.load_smplx_npz(npz, device=dev)
    frames = 30
    clip = motion[:, :frames]
    lbs_ms = cuda_ms(lambda: render.motion_vertices(model, clip), 3)
    verts = render.motion_vertices(model, clip).cpu().numpy()
    t0 = time.time()
    canvases = list(render.render_frames(verts, model.faces, "whole_body"))
    ras_ms = (time.time() - t0) * 1e3 / frames
    if len(canvases) != frames or canvases[0].shape != (1440, 800, 3):
        raise AssertionError(f"phase 27: {len(canvases)} frames of {canvases[0].shape}")
    w, h, xmag, ymag, cam_y, cam_z = render.camera_for_mode("whole_body")
    rest = render.motion_vertices(model, np.zeros((1, 1, 265), np.float32)).cpu().numpy()
    worst, covered = 0, []
    for tag, v, tile in (("frame 0", verts[0, 0], canvases[0]),
                         ("rest pose", rest[0, 0],
                          render.render_mesh_frame(rest[0, 0], model.faces, "whole_body"))):
        plain = render._rasterize_numpy(render.flip_yz(v), model.faces, xmag, ymag, cam_y, cam_z,
                                        render.LIGHT_RIG, render.AMBIENT, render.BASE_COLOR, w, h)
        differ = int((np.abs(tile.astype(int) - plain.astype(int)).max(-1) > 2).sum())
        worst = max(worst, differ)
        covered.append(int((tile < 255).any(-1).sum()))
    limit = int(0.005 * w * h)
    if worst > limit or covered[1] < 1000:
        raise AssertionError(f"phase 27: {worst} pixels differ (limit {limit}), covered {covered}")
    log(f"phase 27 render: {frames} frames of the demo's motion, whole_body {w} x {h} tiles, no "
        f"captions, synthetic rig of {model.v_template.shape[0]} vertices and "
        f"{len(model.faces)} faces: LBS on the card {lbs_ms / frames:.3f} ms a frame "
        f"({lbs_ms:.2f} ms for the batch of {frames}); native rasterizer (g++ -O3 -fopenmp, "
        f"{native.num_threads()} threads) {ras_ms:.2f} ms a frame [{card}]")
    log(f"phase 27 render vs the numpy rasterizer on 2 frames (frame 0 of the motion, {covered[0]} "
        f"pixels covered; the rest pose, {covered[1]}): at most {worst} pixels differ by more "
        f"than 2 levels <= {limit} (0.5 % of the tile)")
    if importlib.util.find_spec("cv2") is None:
        log("phase 27 render: the mp4 writer (render.write_video) needs cv2, which this machine "
            "lacks; the writer is not driven here")
        return
    path = os.path.join(tmp, "render.mp4")
    t0 = time.time()
    render.write_video(iter(canvases), path, 30, wav10)
    secs = time.time() - t0
    if not os.path.getsize(path):
        raise AssertionError("phase 27: the writer wrote an empty file")
    log(f"phase 27 render: cv2 present, render.write_video wrote the {frames} canvases as "
        f"{os.path.basename(path)} ({os.path.getsize(path)} bytes, "
        f"{'audio muxed by ffmpeg' if shutil.which('ffmpeg') else 'no ffmpeg: silent'}) in "
        f"{secs * 1e3 / frames:.2f} ms a frame [{card}]")


def phase28(dev, tmp: str, wav10: str, vq_ckpt: str, card: str) -> dict:
    """The bh_model=false (vertical-only) prior: the train CLI's stage 2 on
    phase 11's checkpoint; one step at full width CUDA against CPU from one
    state; Pipeline.generate refuses it before any K1 launch.  Returns the
    stage's K4 launches."""
    from talkshow_torch.config import Config
    from talkshow_torch.kernels import counts
    from talkshow_torch.models.pixelcnn import GatedPixelCNN, draw_aud_keep
    from talkshow_torch.models.vqvae import AudioEncoder
    from talkshow_torch.pipeline import Pipeline
    from talkshow_torch.train.__main__ import frozen_vqs, main as train_main
    from talkshow_torch.train.steps import make_body_pixel_step
    cfg = os.path.join(tmp, "body_pixel_vertical.json")
    write_stage_config(cfg, "s2g_body_pixel", 1)
    with open(cfg) as f:
        conf = json.load(f)
    conf["Model"]["bh_model"] = False
    with open(cfg, "w") as f:
        json.dump(conf, f)
    run = os.path.join(tmp, "pixel_vertical")
    counts.clear()
    t0 = time.time()
    tr = train_main(["--config_file", cfg, "--synthetic", "--device", str(dev), "--vq_ckpt",
                     vq_ckpt, "--epochs", "1", "--run_dir", run])
    torch.cuda.synchronize()
    c, steps, secs = dict(counts), tr.global_step, time.time() - t0
    prior = tr.state.models["prior"]
    keys = tr.dataset.window_keys()
    fills = -(-(len(keys) - TRAIN["batch"] * steps) // TRAIN["batch"])
    logged = logged_values(run)
    if (prior.bh_model or hasattr(prior, "fusion_h") or (prior.dim, prior.n_layers) != (
            PIXEL["dim"], PIXEL["layers"]) or steps < 10
            or c.get("nearest_code", 0) != 2 * (steps + fills) or c.get("ar_decode")
            or not all(math.isfinite(v) for v in logged)):
        raise AssertionError(f"phase 28 stage 2: bh_model {prior.bh_model}, {steps} steps, "
                             f"counts {c}")
    log(f"phase 28 vertical-only prior: python -m talkshow_torch.train s2g_body_pixel with "
        f"Model.bh_model false on phase 11's ckpt-0.pt, prior {prior.dim} x {prior.n_layers} "
        f"(no horizontal stack, no fusion_h) over {prior.input_dim} codes: {steps} steps in "
        f"{secs:.1f} s, nearest_code {c['nearest_code']} = 2 x ({steps} + {fills} fill "
        f"batches), no K1; {len(logged)} logged values finite")

    def fresh_state(device):
        vb, vh, sts = frozen_vqs(Config.from_reference_json(cfg), vq_ckpt)
        init, step = make_body_pixel_step(
            GatedPixelCNN(input_dim=PIXEL["codes"], dim=PIXEL["dim"], n_layers=PIXEL["layers"],
                          bh_model=False),
            AudioEncoder(num_hiddens=PIXEL["audio"]), vb, vh, sts, 1e-4, 5.0)
        return init(torch.Generator().manual_seed(28), device), step

    first = next(iter(tr.batch_iter(0)))
    tokens = torch.as_tensor(np.stack([tr._token_cache[tuple(map(int, k))]
                                       for k in first["window_key"][:8]]))
    keep = draw_aud_keep(8, tokens.shape[1], torch.Generator().manual_seed(29), "cpu")
    cpu_batch = {"tokens": tokens, "aud_feat": torch.as_tensor(first["aud_feat"][:8]),
                 "speaker": torch.as_tensor(first["speaker"][:8]), "aud_keep": keep}
    gpu_batch = {k: v.to(dev) for k, v in cpu_batch.items()}
    (s_cpu, step_cpu), (s_gpu, step_gpu) = fresh_state("cpu"), fresh_state(dev)
    _, mc = step_cpu(s_cpu, cpu_batch)
    _, mg = step_gpu(s_gpu, gpu_batch)
    rel = max(abs(float(mg[k]) - float(mc[k])) / abs(float(mc[k])) for k in ("ce_loss", "grad"))
    g_err = grad_errors(s_cpu.models, s_gpu.models)
    if not (rel <= 1e-4 and g_err["prior"] <= 1e-3 and g_err["audio"] <= 2e-2):
        raise AssertionError(f"phase 28 CUDA vs CPU: loss/norm rel {rel}, gradients {g_err}")
    log(f"phase 28 vertical-only prior, one step CUDA vs CPU from one state (B=8, "
        f"{PIXEL['dim']} x {PIXEL['layers']}, TF32 off, the same tokens and dropout mask): ce_loss {float(mg['ce_loss']):.4f}, "
        f"ce_loss and grad norm within {rel:.2e} relative <= 1e-4; prior gradients within "
        f"{g_err['prior']:.2e} of max|g| <= 1e-3, audio-encoder gradients {g_err['audio']:.2e} "
        f"<= 2e-2 (phase 16's tolerances)")
    del s_cpu, s_gpu

    pipe = Pipeline.create(0, dev, bh_model=False)
    pipe.load_converted({"prior": prior.state_dict(),
                         "audio_enc": tr.state.models["audio"].state_dict()})
    counts.clear()
    try:
        pipe.generate(wav10, num_samples=1, seed=0)
        raise AssertionError("phase 28: Pipeline.generate sampled the vertical-only prior")
    except ValueError as e:
        if "bh_model=false prior cannot be sampled" not in str(e) or counts.get("ar_decode") \
                or counts.get("sample_tokens_plain"):
            raise
        log(f"phase 28 Pipeline.generate on the vertical-only prior raises ValueError before "
            f"any K1 launch (ar_decode {counts.get('ar_decode', 0)}, plain sampler "
            f"{counts.get('sample_tokens_plain', 0)}): \"{str(e)[:90]}...\"")
    return dict(nearest_code=c["nearest_code"])


def phase29(dev, card: str) -> int:
    """The causal VQ-VAE at full width (1024 hidden, 2048 x 64 codebook) on
    a 10 s clip of body (39) and hand (90) poses in 20-frame chunks: every
    K4 call's indices against the plain search on the same latents, the
    chunked tokens against the full encode, the chunked decode against the
    full decode; K4's launches and ms a chunk.  Returns the launches."""
    from talkshow_torch.kernels import counts
    from talkshow_torch.kernels import nearest_code as k4
    from talkshow_torch.models.causal_vqvae import CausalVQVAE
    from talkshow_torch.models.layers import init_weights_
    from talkshow_torch.ops import vq as vq_ops
    gen = torch.Generator().manual_seed(29)
    T, chunk = 300, 20
    launches = 0
    for part, width in (("body", 39), ("hand", 90)):
        model = init_weights_(CausalVQVAE(width, TRAIN["dim"], TRAIN["num_hiddens"]),
                              gen).to(dev).eval()
        st = vq_ops.init_vq_state(gen, TRAIN["codes"], TRAIN["dim"], dev)
        emb = st.embeddings
        e2 = k4.code_norms(emb)
        x = (0.2 * torch.randn((1, T, width), generator=gen)).to(dev)
        with torch.no_grad():
            counts.clear()
            _, full_idx, _ = model.encode_chunk(x, st)
            z_full, _ = model.encode_latents(x)
            idx_parts, z_parts, states = [], [], None
            for i in range(0, T, chunk):
                z, _ = model.encode_latents(x[:, i:i + chunk], states)
                _, idx, states = model.encode_chunk(x[:, i:i + chunk], st, states)
                flat = z.reshape(-1, z.shape[-1])
                check_codes(f"phase 29 {part} chunk {i // chunk}", idx.reshape(-1), flat, emb, e2,
                            k4.nearest_code_plain(flat, emb, e2))
                idx_parts.append(idx)
                z_parts.append(z)
            torch.cuda.synchronize()
            c = dict(counts)
            chunked = torch.cat(idx_parts, dim=1)
            z_chunked = torch.cat(z_parts, dim=1)
            dz = (z_chunked - z_full).abs().max().item() / z_full.abs().max().item()
            flat = z_full.reshape(-1, z_full.shape[-1])
            near, differ, _ = check_codes(f"phase 29 {part} chunked vs full",
                                          chunked.reshape(-1), flat, emb, e2,
                                          full_idx.reshape(-1))
            full, _ = model.decode_chunk(full_idx, st)
            outs, states = [], None
            for i in range(0, T // 4, chunk // 4):
                out, states = model.decode_chunk(full_idx[:, i:i + chunk // 4], st, states)
                outs.append(out)
            dd = (torch.cat(outs, 1) - full).abs().max().item() / full.abs().max().item()
        n = T // chunk
        # the plain search runs only in the comparisons, once a chunk
        if (c.get("nearest_code") != 1 + n or c.get("nearest_code_plain") != n
                or full.shape != (1, T, width) or not torch.isfinite(full).all() or dd > 1e-4):
            raise AssertionError(f"phase 29 {part}: counts {c}, decode {tuple(full.shape)}, "
                                 f"chunked decode {dd}")
        launches += c["nearest_code"]
        with torch.no_grad():
            xc, zc = x[:, :chunk], z_full[0, :chunk // 4].contiguous()
            enc_ms = cuda_ms(lambda: model.encode_chunk(xc, st), 10)
            dec_ms = cuda_ms(lambda: model.decode_chunk(full_idx[:, :chunk // 4], st), 10)
            k4_ms = cuda_ms(lambda: vq_ops.nearest_code(zc, emb), 20)
            plain_ms = cuda_ms(lambda: k4.nearest_code_plain(zc, emb, e2), 20)
        log(f"phase 29 causal VQ-VAE {part} ({width} channels, {TRAIN['num_hiddens']} hidden, codebook "
            f"{TRAIN['codes']} x {TRAIN['dim']}) on a 10 s clip ({T} frames) in {n} chunks of "
            f"{chunk} frames: K4 launches {c['nearest_code']} (1 full encode + {n} chunks), the "
            f"plain search only in the {n} comparisons; each K4 call's indices equal the plain search's on its latents (near-ties "
            f"exempt); chunked latents within {dz:.2e} of max|z| of the full encode, tokens "
            f"equal on {T // 4 - differ}/{T // 4} rows ({differ} differ, all near-ties); chunked "
            f"decode within {dd:.2e} of max|out| <= 1e-4 of the full decode; a chunk: encode "
            f"{enc_ms:.3f} ms, decode {dec_ms:.3f} ms, K4 ({chunk // 4} rows) {k4_ms:.4f} ms, "
            f"plain search {plain_ms:.4f} ms [{card}]")
    return launches


# ---------------------------------------------------------------------------
# phases 30-33: --bf16, the full schedule, Wav2VecVQEncoder, the Meshtalk face
# and the legacy S2G family
# ---------------------------------------------------------------------------

#: one step CUDA against CPU under --bf16 is held to the bounds
#: tests/test_torch_bf16.py holds the port's bf16 steps to JAX's with
BF16_PIXEL = dict(ce=1e-3, grad=1.5e-2, moment=0.1, param_lr=2.0)
BF16_FACE = dict(loss=1e-2, grad=1e-2, moment=0.1, param_lr=0.1)


def phase30(dev, tmp: str, vq_ckpt: str, card: str) -> dict:
    """--bf16 at full width through the train CLI: s2g_body_pixel (the prior
    256 x 15 in bf16 at B = 128, T = 88; K4 for the token encode) and s2g_face
    (wav2vec 2.0 base in bf16 at B = 1 on 8 s clips; K3 on bf16 tables); one
    step of each CUDA against CPU from one state within tests/test_torch_bf16.py's
    bounds; K3's bf16 features against its plain version on the same tables;
    the step p50 in bf16 and in f32, in turns, with the device-idle share."""
    from talkshow_torch.config import Config
    from talkshow_torch.kernels import counts
    from talkshow_torch.kernels import wav2vec_extractor as k3
    from talkshow_torch.models.face import FaceGenerator
    from talkshow_torch.models.pixelcnn import GatedPixelCNN, draw_aud_keep
    from talkshow_torch.models.vqvae import AudioEncoder
    from talkshow_torch.models.wav2vec import Wav2Vec2Config
    from talkshow_torch.models.wav2vec_fused import frozen_features
    from talkshow_torch.train.__main__ import frozen_vqs, main as train_main
    from talkshow_torch.train.steps import make_body_pixel_step, make_face_step
    bf16, lr = torch.bfloat16, 1e-4
    pcfg, fcfg = os.path.join(tmp, "pixel16.json"), os.path.join(tmp, "face16.json")
    write_stage_config(pcfg, "s2g_body_pixel", 1)
    write_stage_config(fcfg, "s2g_face", 1)
    base = ["--synthetic", "--device", str(dev), "--bf16"]
    counts.clear()
    t0 = time.time()
    ptr = train_main(["--config_file", pcfg, "--vq_ckpt", vq_ckpt, "--run_dir",
                      os.path.join(tmp, "pixel16")] + base)
    torch.cuda.synchronize()
    pseen, pwall = dict(counts), time.time() - t0
    prior = ptr.state.models["prior"]
    plog = logged_values(os.path.join(tmp, "pixel16"))
    if (prior.dtype != bf16 or pseen.get("nearest_code", 0) < 2 * ptr.global_step
            or pseen.get("nearest_code_plain", 0) or not all(math.isfinite(v) for v in plog)
            or any(p.dtype != torch.float32 for p in prior.parameters())):
        raise AssertionError(f"phase 30 pixel: dtype {prior.dtype}, counts {pseen}, "
                             f"logged {plog[:12]}")
    counts.clear()
    t0 = time.time()
    ftr = train_main(["--config_file", fcfg, "--run_dir", os.path.join(tmp, "face16")] + base)
    torch.cuda.synchronize()
    fseen, fwall = dict(counts), time.time() - t0
    flog = logged_values(os.path.join(tmp, "face16"))
    if (ftr.state.tables["w0"].dtype != bf16 or fseen.get("wav2vec_extractor", 0)
            != ftr.global_step or fseen.get("extractor_plain", 0)
            or not all(math.isfinite(v) for v in flog)):
        raise AssertionError(f"phase 30 face: tables {ftr.state.tables['w0'].dtype}, counts "
                             f"{fseen}, logged {flog[:12]}")
    log(f"phase 30 --bf16 train CLI: s2g_body_pixel (prior {PIXEL['dim']} x {PIXEL['layers']} "
        f"in bf16, f32 parameters) {ptr.global_step} steps at B={TRAIN['batch']} "
        f"T={TRAIN['window']} in {pwall:.1f} s, nearest_code (K4, the token encode) launches "
        f"{pseen['nearest_code']}; s2g_face (wav2vec 2.0 base in bf16) {ftr.global_step} steps "
        f"at B=1 in {fwall:.1f} s, wav2vec_extractor (K3) launches {fseen['wav2vec_extractor']} "
        f"on bf16 tables, plain extractor 0; {len(plog) + len(flog)} logged values finite "
        f"[{card}]")

    # K3 on bf16 tables against its plain version on the same tables
    first = next(iter(ftr.batch_iter(0)))
    wav = torch.as_tensor(first["waveform"], device=dev)
    got = frozen_features(ftr.state.face.audio_encoder, wav, tables=ftr.state.tables)
    want = k3.extractor_plain(ftr.state.tables, wav)
    k3_err = (got - want).abs().max().item() / want.abs().max().item()
    if k3_err > 1e-2:
        raise AssertionError(f"phase 30 K3 bf16: {k3_err} of max|out|")

    # one pixel step CUDA against CPU (B = 8, the same tokens and dropout mask)
    def pixel_state(device, dtype):
        vb, vh, sts = frozen_vqs(Config.from_reference_json(pcfg), vq_ckpt)
        init, step = make_body_pixel_step(
            GatedPixelCNN(input_dim=PIXEL["codes"], dim=PIXEL["dim"], n_layers=PIXEL["layers"],
                          dtype=dtype),
            AudioEncoder(num_hiddens=PIXEL["audio"]), vb, vh, sts, lr, 5.0)
        return init(torch.Generator().manual_seed(30), device), step

    pb = next(iter(ptr.batch_iter(0)))
    batch8 = ptr.put_batch({k: pb[k][:8] for k in ("poses", "aud_feat", "speaker")})
    tokens = ptr.token_encoder(batch8["poses"]).cpu()
    keep = draw_aud_keep(8, tokens.shape[1], torch.Generator().manual_seed(31), "cpu")
    cpu_b = {"tokens": tokens, "aud_feat": batch8["aud_feat"].cpu(),
             "speaker": batch8["speaker"].cpu(), "aud_keep": keep}
    (sc, stc), (sg, stg) = pixel_state("cpu", bf16), pixel_state(dev, bf16)
    _, mc = stc(sc, cpu_b)
    _, mg = stg(sg, {k: v.to(dev) for k, v in cpu_b.items()})
    px = {"ce": rel_err(float(mg["ce_loss"]), float(mc["ce_loss"])),
          "grad": rel_err(float(mg["grad"]), float(mc["grad"])), "moment": 0.0, "param_lr": 0.0}
    for name, mcpu in sc.models.items():
        pg = dict(sg.models[name].named_parameters())
        top = max(sc.optimizer.adam.state[p]["exp_avg"].abs().max().item()
                  for p in mcpu.parameters())
        for k, p in mcpu.named_parameters():
            q = pg[k]
            px["moment"] = max(px["moment"], (sg.optimizer.adam.state[q]["exp_avg"].cpu()
                                              - sc.optimizer.adam.state[p]["exp_avg"]
                                              ).abs().max().item() / top)
            px["param_lr"] = max(px["param_lr"], (q.detach().cpu() - p.detach()).abs().max()
                                 .item() / lr)
            if q.dtype != torch.float32:
                raise AssertionError(f"phase 30: master {k} is {q.dtype}")
    del sc, sg

    # one face step CUDA against CPU (stochastic=False, the 8 s clip)
    def face_state(device):
        init, step = make_face_step(FaceGenerator(Wav2Vec2Config(dtype=bf16)), stochastic=False)
        return init(torch.Generator().manual_seed(30), device), step

    cpu_f = {k: torch.as_tensor(v) for k, v in first.items()}
    (fc, ftc), (fg, ftg) = face_state("cpu"), face_state(dev)
    _, mfc = ftc(fc, cpu_f)
    _, mfg = ftg(fg, {k: v.to(dev) for k, v in cpu_f.items()})
    fa = {"loss": max(rel_err(float(mfg[k]), float(mfc[k]))
                      for k in ("loss", "MSELoss", "exp_loss")),
          "grad": rel_err(float(mfg["grad"]), float(mfc["grad"]))}
    pg = dict(fg.face.named_parameters())
    bufs = [(fc.optimizer.inner.state[p]["momentum_buffer"],
             fg.optimizer.inner.state[pg[k]]["momentum_buffer"].cpu())
            for k, p in fc.face.named_parameters() if p.requires_grad]
    ttop = max(a.abs().max().item() for a, _ in bufs)
    fa["moment"] = max((b - a).abs().max().item() for a, b in bufs) / ttop
    fa["param_lr"] = max((pg[k].detach().cpu() - p.detach()).abs().max().item()
                         for k, p in fc.face.named_parameters()) / (1e-3 * ttop)
    del fc, fg
    log(f"phase 30 CUDA vs CPU, one --bf16 step from one state: body-pixel (B=8, full width, "
        f"the same tokens and dropout mask) ce {px['ce']:.2e} relative <= {BF16_PIXEL['ce']}, "
        f"grad norm {px['grad']:.2e} <= {BF16_PIXEL['grad']}, Adam's first moment "
        f"{px['moment']:.2e} of its largest <= {BF16_PIXEL['moment']}, f32 masters within "
        f"{px['param_lr']:.3f} lr <= {BF16_PIXEL['param_lr']}; face (B=1, "
        f"{first['waveform'].shape[1] / 16000:.2f} s, stochastic=False) losses "
        f"{fa['loss']:.2e} <= {BF16_FACE['loss']}, grad norm {fa['grad']:.2e} <= "
        f"{BF16_FACE['grad']}, momentum {fa['moment']:.2e} of its largest <= "
        f"{BF16_FACE['moment']}, masters within {fa['param_lr']:.2e} lr x that largest <= "
        f"{BF16_FACE['param_lr']}; K3 on bf16 tables vs its plain version {k3_err:.2e} of "
        f"max|out| <= 1e-2")
    bad = [f"pixel {k}" for k, v in px.items() if v > BF16_PIXEL[k] * (1 + 1e-3)] + \
        [f"face {k}" for k, v in fa.items() if v > BF16_FACE[k]]
    if bad:
        raise AssertionError(f"phase 30 CUDA vs CPU past the bound: {bad}")

    # step p50, bf16 against f32 on the same weights, in turns
    gen = torch.Generator(device=dev).manual_seed(30)
    warm = ptr.device_batch(dict(pb), [])
    vb, vh, sts = frozen_vqs(Config.from_reference_json(pcfg), vq_ckpt)
    init32, step32 = make_body_pixel_step(
        GatedPixelCNN(input_dim=PIXEL["codes"], dim=PIXEL["dim"], n_layers=PIXEL["layers"]),
        AudioEncoder(num_hiddens=PIXEL["audio"]), vb, vh, sts, lr, 5.0)
    s32 = init32(torch.Generator().manual_seed(0), dev)
    for name, m in s32.models.items():
        m.load_state_dict(ptr.state.models[name].state_dict())
    p16 = lambda: ptr.step_fn(ptr.state, warm, gen)              # noqa: E731
    p32 = lambda: step32(s32, warm, gen)                         # noqa: E731
    a32, a16, b16, b32 = (step_p50(f) for f in (p32, p16, p16, p32))
    log(f"phase 30 body-pixel step B={TRAIN['batch']} T={TRAIN['window']} (cached tokens): "
        f"p50 bf16 {a16[0]:.2f} / {b16[0]:.2f} ms, f32 {a32[0]:.2f} / {b32[0]:.2f} ms, in turns, "
        f"10 steps each [{card}]")
    log(f"phase 30 body-pixel step (bf16) device time by kernel: "
        f"{idle_line(p16, (a16[0] + b16[0]) / 2, reps=2)} [{card}]")
    fbatch = ftr.put_batch(dict(first))
    fgen = torch.Generator(device=dev).manual_seed(30)
    finit32, fstep32 = make_face_step(FaceGenerator())
    f32s = finit32(torch.Generator().manual_seed(0), dev)
    f32s.face.load_state_dict(ftr.state.face.state_dict())
    f16 = lambda: ftr.step_fn(ftr.state, fbatch, fgen)           # noqa: E731
    f32 = lambda: fstep32(f32s, fbatch, fgen)                    # noqa: E731
    c32, c16, d16, d32 = (step_p50(f, 20) for f in (f32, f16, f16, f32))
    log(f"phase 30 face step B=1, {first['waveform'].shape[1] / 16000:.2f} s clip: p50 bf16 "
        f"(K3 on bf16 tables) {c16[0]:.2f} / {d16[0]:.2f} ms, f32 (K3 on f32 tables) "
        f"{c32[0]:.2f} / {d32[0]:.2f} ms, in turns, 20 steps each [{card}]")
    log(f"phase 30 face step (bf16) device time by kernel: "
        f"{idle_line(f16, (c16[0] + d16[0]) / 2, reps=2)} [{card}]")
    return {"nearest_code": pseen.get("nearest_code", 0),
            "wav2vec_extractor": fseen.get("wav2vec_extractor", 0)}


def jax_eval_keys() -> set:
    """The keys scripts/eval_full_schedule.py writes into its results (read
    as text; `rep6d` only when its probe file exists)."""
    import re
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                           "eval_full_schedule.py")) as f:
        return set(re.findall(r'results\["(\w+)"\]', f.read())) - {"rep6d"}


def phase31(dev, tmp: str, card: str) -> dict:
    """The full schedule end to end at full width: python -m
    talkshow_torch.full_schedule --smoke (2 epochs a stage) on a synthetic
    SHOW tree of one 29 s train clip and one 20 s test clip per speaker, all
    five trainables and the eval battery; wall seconds and K1-K4 launches per
    stage; the EVAL json carries every key of the JAX script, its numbers
    finite."""
    from talkshow_torch import full_schedule
    from talkshow_torch.data.synthetic_show import write_show_tree
    root, run_root = os.path.join(tmp, "schedule_data"), os.path.join(tmp, "schedule")
    minutes = write_show_tree(root, clips_per_speaker=1)
    stages = ["body_vq", "body_pixel", "face", "body_ae", "ls3dcg"]
    t0 = time.time()
    out = full_schedule.main(["--data_root", root, "--run_root", run_root, "--smoke",
                              "--stages"] + stages + ["eval", "--smplx_npz",
                                                      os.path.join(tmp, "schedule_rig.npz"),
                                                      "--device", str(dev), "--tag", "smoke"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    status, res = out["status"]["stages"], out["eval"]

    def numbers(x):
        if isinstance(x, dict):
            return [v for y in x.values() for v in numbers(y)]
        if isinstance(x, list):
            return [v for y in x for v in numbers(y)]
        return [x] if isinstance(x, (int, float)) and not isinstance(x, bool) else []

    missing = jax_eval_keys() - set(res)
    summary = res["train_summary"]
    if (missing or set(summary) != set(stages) or not all(math.isfinite(v) for v in numbers(res))
            or any(status[s]["state"] != "done" for s in stages + ["eval"])
            or any(summary[s]["epochs"] != 2 for s in stages)):
        raise AssertionError(f"phase 31: missing keys {missing}, summary {summary}, status "
                             f"{status}")
    for s in stages + ["eval"]:
        st = status[s]
        log(f"phase 31 schedule {s}: {st['wall_s']:.1f} s, launches " + ", ".join(
            f"{k} {st['launches'][k]}" for k in KERNELS)
            + (f"; {full_schedule.CURVE_KEYS[s]} first {summary[s]['first']} last "
               f"{summary[s]['last']}" if s in summary else "") + f" [{card}]")
    log(f"phase 31 schedule: {minutes:.1f} min of synthetic SHOW motion, 5 trainables x 2 "
        f"epochs + the eval battery in {wall:.1f} s; EVAL json: {len(res)} keys, every one of "
        f"the JAX script's {len(jax_eval_keys())}, all numbers finite; fgd trained "
        f"{res['body_trained']['fgd']:.4f} vs random {res['body_random_prior']['fgd']:.4f}, "
        f"jaw L1 trained {res['face_trained']['jaw_l1']:.4f} vs random "
        f"{res['face_random_init']['jaw_l1']:.4f}, capacity "
        f"{res['vq_capacity']['capacity_l1']:.4f} [{card}]")
    return {k: sum(status[s]["launches"][k] for s in stages + ["eval"]) for k in KERNELS}


def phase32(dev, card: str) -> dict:
    """Wav2VecVQEncoder at full width (wav2vec 2.0 base, 1024 hidden) on the
    10 s clip: its eval forward launches K3 and K2 once each (f32 tables)
    and is within 1e-3 of max|out| (phase 8's bound) of the plain forward on
    the card; bf16 tables reported; ms of the kernel route (bf16 tables)
    against the plain forward, in turns."""
    from talkshow_torch.kernels import counts
    from talkshow_torch.models.layers import init_weights_
    from talkshow_torch.models.vqvae import Wav2VecVQEncoder
    enc = init_weights_(Wav2VecVQEncoder(num_hiddens=1024), torch.Generator().manual_seed(32))
    enc = enc.to(dev).eval()
    wav, frames = speech(1, 10.0, 32, dev), 300
    t32, t16 = enc.pack_tables(torch.float32), enc.pack_tables(torch.bfloat16)
    with torch.no_grad():
        counts.clear()
        out = enc(wav, frames, tables=t32)
        torch.cuda.synchronize()
        seen = dict(counts)
        plain = enc.head(enc.audio_encoder(wav, frames))
        out16 = enc(wav, frames, tables=t16)
        scale = plain.abs().max().item()
        err, err16 = ((o - plain).abs().max().item() / scale for o in (out, out16))
        if (seen.get("wav2vec_extractor") != 1 or seen.get("wav2vec_layers") != 1
                or seen.get("extractor_plain") or seen.get("encoder_layers_plain")
                or out.shape[:2] != (1, frames // 4) or err > 1e-3):
            raise AssertionError(f"phase 32: counts {seen}, shape {tuple(out.shape)}, err {err}")
        kern = lambda: enc(wav, frames, tables=t16)                     # noqa: E731
        pl = lambda: enc.head(enc.audio_encoder(wav, frames))           # noqa: E731
        p1, k1, k2, p2 = (cuda_ms(f, 5) for f in (pl, kern, kern, pl))
    log(f"phase 32 Wav2VecVQEncoder (wav2vec 2.0 base, 1024 hidden) on the 10 s clip: "
        f"(1, {frames}) -> {tuple(out.shape)}; one eval forward launches wav2vec_extractor "
        f"(K3) {seen['wav2vec_extractor']} and wav2vec_layers (K2) {seen['wav2vec_layers']}, "
        f"plain extractor / layer stack 0; vs the plain forward {err:.2e} of max|out| <= 1e-3 "
        f"(f32 tables), {err16:.2e} with bf16 tables (reported); kernel route (bf16 tables) "
        f"{k1:.3f} / {k2:.3f} ms, plain {p1:.3f} / {p2:.3f} ms, in turns [{card}]")
    return seen


def phase33(dev, wav10: str, card: str) -> None:
    """The Meshtalk face (FaceGeneratorMeshtalk) and the legacy S2G family
    (FreeformS2G and S2GDiscriminator at tests/test_extras.py:148's widths)
    on the 10 s clip, random weights: CUDA within 1e-4 of the CPU (TF32
    off; relative to max(1, max|out|)); ms on the card.  No kernel."""
    from talkshow_torch.models.face import FaceGeneratorMeshtalk
    from talkshow_torch.models.layers import init_weights_
    from talkshow_torch.models.s2g_legacy import FreeformS2G, S2GDiscriminator
    from talkshow_torch.ops.audio import audio_chunking, get_mfcc, load_wav
    gen = torch.Generator().manual_seed(33)
    x, _ = load_wav(wav10)
    chunks = audio_chunking(torch.as_tensor(x), 30, 16000)[None]
    onehot = torch.zeros((1, 4))
    onehot[0, 2] = 1.0
    spec = get_mfcc(wav10, device="cpu")[None]
    T = spec.shape[1]
    template = torch.randn((1, T, 16), generator=gen)
    models = {
        "meshtalk": (init_weights_(FaceGeneratorMeshtalk(), gen), (chunks, onehot), {}),
        "freeform_s2g": (init_weights_(FreeformS2G(64, 275, (3, 113, 90, 69), 16, 64), gen),
                         (spec,), {"noise": {"template": template}}),
        "s2g_discriminator": (init_weights_(S2GDiscriminator(275), gen),
                              (0.3 * torch.randn((1, T, 275), generator=gen),), {}),
    }
    parts = []
    with torch.no_grad():
        for name, (m, args, kw) in models.items():
            m.eval()
            want = m(*args, **kw)
            want = want[0] if isinstance(want, tuple) else want
            m.to(dev)
            gargs = tuple(a.to(dev) for a in args)
            gkw = {k: {kk: vv.to(dev) for kk, vv in v.items()} for k, v in kw.items()}

            def run(m=m, gargs=gargs, gkw=gkw):
                y = m(*gargs, **gkw)
                return y[0] if isinstance(y, tuple) else y

            got = run()
            err = (got.cpu() - want).abs().max().item() / max(1.0, want.abs().max().item())
            if got.shape != want.shape or not torch.isfinite(got).all() or err > 1e-4:
                raise AssertionError(f"phase 33 {name}: shape {tuple(got.shape)}, err {err}")
            parts.append(f"{name} {tuple(args[0].shape)} -> {tuple(got.shape)}, CUDA vs CPU "
                         f"{err:.2e} <= 1e-4, {cuda_ms(run, 5):.3f} ms")
    log("phase 33 (no kernel): " + "; ".join(parts) + f" [{card}]")


def new_phases(dev, tmp: str, vq_ckpt: str, wav10: str, card: str) -> dict:
    """Phases 30-33; returns their kernels' launches, each phase's counts
    read around its own main-path run."""
    bf16 = phase30(dev, tmp, vq_ckpt, card)
    sched = phase31(dev, tmp, card)
    vqenc = phase32(dev, card)
    phase33(dev, wav10, card)
    launches = {k: bf16.get(k, 0) + sched[k] + vqenc.get(k, 0) for k in KERNELS}
    log(f"launches in phases 30-33: --bf16 training nearest_code {bf16['nearest_code']}, "
        f"wav2vec_extractor {bf16['wav2vec_extractor']}; the schedule " + ", ".join(
            f"{k} {sched[k]}" for k in KERNELS) + f"; Wav2VecVQEncoder wav2vec_extractor "
        f"{vqenc.get('wav2vec_extractor', 0)}, wav2vec_layers {vqenc.get('wav2vec_layers', 0)}")
    return launches


def dist_check():
    """tests/torch_dist_check.py: the rank processes of phase 34 and their
    launcher."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import torch_dist_check
    return torch_dist_check


def run_group(world: int, args: list, timeout: float) -> list:
    """`world` ranks of tests/torch_dist_check.py (each killed on failure
    or at `timeout`); returns each rank's saved result."""
    sc = dist_check()
    out = args[args.index("--out") + 1]
    port = sc.free_port()
    env = dict(os.environ, OMP_NUM_THREADS="2")
    sc.launch(lambda r: sc.rank_argv(r, world, port, args), world, timeout, env)
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


#: the errors of a body-VQ step that phase 34 prints (torch_dist_check._errors)
STEP_ERRORS = ("losses", "bn", "vq", "grads", "grads_l2", "update_off", "update_l2", "moves")


def check_layout(tag: str, ranks: list, layout: str, steps: int) -> str:
    """Hold one layout's steps to tests/test_torch_parallel_dist.py's
    bounds (`torch_dist_check.step_failures`), and every rank's state to
    rank 0's, bit for bit; returns the phase line's part for it."""
    sc = dist_check()
    r0 = ranks[0][layout]
    if not all(r[layout]["losses"] == r0["losses"] for r in ranks):
        raise AssertionError(f"{tag} {layout}: losses differ across ranks")
    if not all(r[layout]["fingerprints"] == r0["fingerprints"] for r in ranks):
        raise AssertionError(f"{tag} {layout}: the ranks' states differ")
    k4 = [r[layout]["k4"] for r in ranks]
    plain = [r[layout]["k4_plain"] for r in ranks]
    if k4 != [2 * steps] * len(ranks) or any(plain):
        raise AssertionError(f"{tag} {layout}: K4 launches {k4}, plain searches {plain}")
    bad = sc.step_failures(r0)
    if bad:
        raise AssertionError(f"{tag} {layout}: " + "; ".join(bad))
    worst = {}
    for errors in r0["errors"]:
        for k in STEP_ERRORS:
            worst[k] = max(worst.get(k, 0.0), errors["mesh"][k])
            worst["spread " + k] = max(worst.get("spread " + k, 0.0), errors["f32"][k])
    ms = float(np.median(r0["ms"][1:]))
    return (f"{layout}: " + ", ".join(f"{k} {v:.1e}" for k, v in worst.items())
            + f"; states bit-equal on every rank; K4 launches per rank {k4}; step p50 "
            f"{ms:.1f} ms over {steps - 1} steps")


#: phase 34's body-VQ steps per layout (the first is left out of the p50)
DIST_STEPS = 5


def phase34(dev, tmp: str, card: str) -> dict:
    """The body-VQ step at full width on (dp 2, tp 1) and (dp 1, tp 2): two
    ranks on this card in a gloo group, and a planted fault that the check
    must catch; a one-rank NCCL all_reduce; dp 2 on NCCL where there are
    two cards; the train CLI under torchrun.  Returns the K4 launches of
    the ranks' main-path steps."""
    sc = dist_check()
    steps, layouts = DIST_STEPS, ("2x1", "1x2")
    out = os.path.join(tmp, "dist")
    t0 = time.perf_counter()
    ranks = run_group(2, ["--layouts", *layouts, "--steps", str(steps), "--width", "full",
                          "--fault", "1x2", "--device", dev.type, "--out", out,
                          "--timeout", "600"], 600.0)
    log(f"phase 34 dp x tp: body-VQ step at full width (1024 hidden, 2048 x 64 codebooks, "
        f"B = 128, T = 88), 2 ranks on one card (gloo over CUDA tensors), {steps} steps a "
        f"layout from one state, each held against the one-process step from the same state "
        f"on the same global batch, beside that step's spread under the rows reversed "
        f"[{time.perf_counter() - t0:.1f} s]")
    for layout in layouts:
        log(f"phase 34 {check_layout('phase 34', ranks, layout, steps)} [{card}]")
    fault = ranks[0]["fault"]["errors"][0]
    if not sc.step_failures(ranks[0]["fault"]):
        raise AssertionError(f"phase 34: the planted fault passed the check: {fault}")
    log("phase 34 planted fault (1x2, the last tp rank never updates its parameter slices), "
        "failed as it must: " + ", ".join(f"{k} {fault['mesh'][k]:.1e} (spread "
                                          f"{fault['f32'][k]:.1e})"
                                          for k in ("update_off", "update_l2")))
    k4 = sum(r[layout]["k4"] for r in ranks for layout in layouts)
    probe = run_group(1, ["--nccl_probe", "--out", out, "--timeout", "120"], 120.0)
    nccl = torch.load(os.path.join(out, "nccl.pt"))
    if not nccl["nccl_all_reduce"]:
        raise AssertionError(f"phase 34 nccl: {nccl}, {probe}")
    log("phase 34 nccl: a one-rank NCCL group on the card, one all_reduce: equal")
    if torch.cuda.device_count() >= 2:
        ranks = run_group(2, ["--layouts", "2x1", "--steps", str(steps), "--width", "full",
                              "--device", "cuda", "--backend", "nccl", "--out",
                              os.path.join(tmp, "dist_nccl"), "--timeout", "600"], 600.0)
        log(f"phase 34 nccl dp=2, a card per rank: "
            f"{check_layout('phase 34 nccl', ranks, '2x1', steps)} [{card}]")
        k4 += sum(r["2x1"]["k4"] for r in ranks)
    else:
        log(f"phase 34 nccl dp=2: {torch.cuda.device_count()} card, not run")
    # the train CLI under torchrun, config.parallel dp 2, both ranks on this card
    cfg = os.path.join(tmp, "dist_body_vq.json")
    write_stage_config(cfg, "s2g_body_vq", 1)
    with open(cfg) as f:
        raw = json.load(f)
    raw["parallel"] = {"dp": 2, "tp": 1}
    with open(cfg, "w") as f:
        json.dump(raw, f)
    run_dir = os.path.join(tmp, "dist_run")
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
                          "--master_port", str(sc.free_port()),
                          "-m", "talkshow_torch.train", "--config_file", cfg, "--synthetic",
                          "--epochs", "1", "--run_dir", run_dir, "--device", dev.type],
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, OMP_NUM_THREADS="2"))
    if res.returncode != 0:
        raise AssertionError(f"phase 34 torchrun: exit {res.returncode}\n{res.stderr[-4000:]}")
    vals = logged_values(run_dir)
    if not (os.path.exists(os.path.join(run_dir, "ckpt-0.pt")) and vals
            and np.isfinite(vals).all()):
        raise AssertionError(f"phase 34 torchrun: files {os.listdir(run_dir)}, values {vals}")
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("rank 0 of")]
    log(f"phase 34 torchrun: `torchrun --nproc_per_node 2 -m talkshow_torch.train` s2g_body_vq "
        f"with parallel dp 2 at full width, 1 epoch: {line[0] if line else res.stdout[-200:]}; "
        f"ckpt-0.pt and finite logs from rank 0, "
        f"{time.perf_counter() - t0:.1f} s of wall time")
    return {"nearest_code": k4}


def phase35(pipe, dev, wav10: str, card: str) -> dict:
    """generate_body_sharded at full width: a 10 s clip, S = 8 on a dp = 4
    mesh of this card; returns the launches of the sharded call."""
    from talkshow_torch.kernels import counts
    from talkshow_torch.models.pixelcnn import gumbel_noise
    from talkshow_torch.ops.audio import get_mfcc
    from talkshow_torch.parallel.mesh import make_mesh
    mesh = make_mesh(dp=4, devices=[dev] * 4)
    feat = get_mfcc(wav10, device=dev).cpu().numpy()
    H = feat.shape[0] // 4
    K = pipe.body.prior.input_dim
    noise = [gumbel_noise((H, 2, 2, K), torch.Generator().manual_seed(50 + i), dev)
             for i in range(4)]
    pipe.generate_conv_sharded(feat, 0, 8, mesh, noise=noise)       # tables packed
    counts.clear()
    parts = pipe.generate_conv_sharded(feat, 0, 8, mesh, noise=noise)
    torch.cuda.synchronize()
    seen = dict(counts)
    if seen.get("ar_decode") != 4 or seen.get("sample_tokens_plain"):
        raise AssertionError(f"phase 35: counts {seen}")
    for i, (conv, tok) in enumerate(parts):
        _, want = pipe.generate_conv(feat, 0, 2, noise=noise[i])
        if not (torch.equal(tok, want) and conv.shape == (2, 4 * H, 129)
                and torch.isfinite(conv).all()):
            raise AssertionError(f"phase 35 shard {i}: tokens equal {torch.equal(tok, want)}, "
                                 f"conv {tuple(conv.shape)}")
    body = pipe.generate_body_sharded(feat, 0, 8, mesh, seed=3)
    if body.shape != (8, 4 * H, 129) or not np.isfinite(body).all():
        raise AssertionError(f"phase 35: generate_body_sharded {body.shape}")
    times = {"sharded (4 x B=2)": [], "unsharded (B=8)": []}
    for r in range(12):
        for name in (times if r % 2 else reversed(list(times))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if name.startswith("sharded"):
                pipe.generate_body_sharded(feat, 0, 8, mesh, seed=r)
            else:
                pipe.generate_body(feat, 0, 8, seed=r)
            times[name].append((time.perf_counter() - t0) * 1e3)
    log(f"phase 35 generate_body_sharded: 10 s clip, S = 8 on a dp = 4 mesh of this card: "
        f"ar_decode launches {seen['ar_decode']} (one a shard, B = 2 each), plain sampler calls "
        f"0; each shard's tokens equal generate_conv(S = 2) under its noise; "
        + ", ".join(f"{k} p50 {float(np.median(v[2:])):.2f} ms" for k, v in times.items())
        + f" (host clock to the readback, in turns, 10 runs) [{card}]")
    return seen


def phase36(pipe, dev, wav10: str, card: str) -> dict:
    """MotionServer on a dp = 2 mesh of this card (bucket_frames 32,
    max_batch 8, phase 14's 8 clips); returns the launches of one flush."""
    from talkshow_torch.kernels import counts
    from talkshow_torch.ops.audio import load_wav
    from talkshow_torch.parallel.mesh import make_mesh
    from talkshow_torch.serving import MotionServer
    wav, _ = load_wav(wav10)
    mesh = make_mesh(dp=2, devices=[dev] * 2)
    clips = [wav[:int(16000 * sec)] for sec in SERVE_SECONDS]
    buckets = [-(-(len(c) * 30 // 16000) // 32) * 32 for c in clips]
    groups = sum(-(-buckets.count(b) // 8) for b in set(buckets))
    server = MotionServer(pipe, bucket_frames=32, max_batch=8, mesh=mesh)
    plain = MotionServer(pipe, bucket_frames=32, max_batch=8)
    server.warmup(10.0)
    rids = [server.submit(c, speaker=i % 4) for i, c in enumerate(clips)]
    counts.clear()
    out = server.flush(seed=0)
    torch.cuda.synchronize()
    seen = dict(counts)
    if not (len(out) == len(clips) and seen.get("ar_decode") == 2 * groups
            and seen.get("wav2vec_layers") == 2 * groups
            and seen.get("extractor_plain") == 2 * groups
            and not seen.get("sample_tokens_plain") and not seen.get("face_plain")
            and all(out[r].shape == (len(c) * 30 // 16000, 265) and np.isfinite(out[r]).all()
                    for r, c in zip(rids, clips))):
        raise AssertionError(f"phase 36: {groups} groups, counts {seen}")
    again = [server.submit(c, speaker=i % 4) for i, c in enumerate(clips)]
    out2 = server.flush(seed=0)
    if not all(np.array_equal(out[a], out2[b]) for a, b in zip(rids, again)):
        raise AssertionError("phase 36: a flush with the same seed is not reproduced")
    # face columns against the unsharded server: f32 tables (bf16 reported)
    errs = {}
    for name, p in (("f32", pipe.with_face_dtype(torch.float32)), ("bf16", pipe)):
        a, b = (MotionServer(p, bucket_frames=32, max_batch=8, mesh=m) for m in (mesh, None))
        ra = [a.submit(c, speaker=0) for c in clips]
        rb = [b.submit(c, speaker=0) for c in clips]
        oa, ob = a.flush(seed=1), b.flush(seed=1)
        errs[name] = max(max(np.abs(oa[x][:, :3] - ob[y][:, :3]).max(),
                             np.abs(oa[x][:, -100:] - ob[y][:, -100:]).max())
                         for x, y in zip(ra, rb))
    if not errs["f32"] <= 2e-4:
        raise AssertionError(f"phase 36: face columns sharded vs unsharded {errs}")
    times = {"mesh dp=2": [], "unsharded": []}
    for r in range(8):
        for name, s in ((("mesh dp=2", server), ("unsharded", plain)) if r % 2 else
                        (("unsharded", plain), ("mesh dp=2", server))):
            for c in clips:
                s.submit(c, speaker=0)
            t0 = time.perf_counter()
            s.flush()
            times[name].append((time.perf_counter() - t0) * 1e3)
    log(f"phase 36 mesh server: dp = 2 on this card, bucket_frames 32, max_batch 8, "
        f"{len(clips)} clips of {min(SERVE_SECONDS)}-{max(SERVE_SECONDS)} s in {groups} groups: "
        f"per group 2 shards of 4 rows, ar_decode {seen['ar_decode'] // groups}, wav2vec_layers "
        f"{seen['wav2vec_layers'] // groups}, plain masked extractor "
        f"{seen['extractor_plain'] // groups}; the same seed reproduces the flush bit for bit; "
        f"face columns vs the unsharded server max|d| {errs['f32']:.2e} (f32 tables, <= 2e-4), "
        f"{errs['bf16']:.2e} (bf16 tables, reported); flush p50 "
        + ", ".join(f"{k} {float(np.median(v[2:])):.2f} ms" for k, v in times.items())
        + f" (in turns, 6 flushes each) [{card}]")
    return seen


#: phase 37's face steps per layout (the first is left out of the p50)
FACE_DIST_STEPS = 4
#: the errors of a face step that phase 37 prints (torch_dist_check.face_case)
FACE_STEP_ERRORS = ("losses", "grad_norm", "grads", "grads_l2", "update_off", "update_l2",
                    "momentum", "masters")


def check_face_layout(tag: str, ranks: list, layout: str, steps: int, whole_clips: bool) -> str:
    """Hold one layout's face steps to tests/test_torch_parallel_face.py's
    bounds (`torch_dist_check.step_failures`), every rank's losses and state
    to rank 0's bit for bit, the frozen extractor whole and unchanged on
    every rank, and the extractor's route (K3 once a step a rank on whole
    clips, the plain masked extractor on buckets); returns the phase line's
    part for it."""
    sc = dist_check()
    r0 = ranks[0]["face"][layout]
    if not all(r["face"][layout]["losses"] == r0["losses"] for r in ranks):
        raise AssertionError(f"{tag} {layout}: losses differ across ranks")
    if not all(r["face"][layout]["fingerprints"] == r0["fingerprints"] for r in ranks):
        raise AssertionError(f"{tag} {layout}: the ranks' states differ")
    ext = [r["face"][layout]["extractor"] for r in ranks]
    if not all(e["whole"] and e["unchanged"] and not e["requires_grad"]
               and e["fingerprint"] == ext[0]["fingerprint"] for e in ext):
        raise AssertionError(f"{tag} {layout}: frozen extractor {ext}")
    k3 = [r["face"][layout]["k3"] for r in ranks]
    plain = [r["face"][layout]["k3_plain"] for r in ranks]
    want = ([steps] * len(ranks), [0] * len(ranks))
    if (k3, plain) != (want if whole_clips else want[::-1]):
        raise AssertionError(f"{tag} {layout}: K3 launches {k3}, plain extractor calls {plain}")
    bad = sc.step_failures(r0)
    if bad:
        raise AssertionError(f"{tag} {layout}: " + "; ".join(bad))
    worst = {}
    for errors in r0["errors"]:
        for k in FACE_STEP_ERRORS:
            worst[k] = max(worst.get(k, 0.0), errors["mesh"][k])
            worst["spread " + k] = max(worst.get("spread " + k, 0.0), errors["f32"][k])
    ms = float(np.median(r0["ms"][1:]))
    return (f"{layout} ({'whole clips, B = 1' if whole_clips else 'buckets of 32 frames, B = 2'}"
            f"): " + ", ".join(f"{k} {v:.1e}" for k, v in worst.items())
            + f"; losses and states bit-equal on every rank; the frozen extractor whole and "
            f"unchanged on every rank; K3 launches per rank {k3}, plain extractor calls per rank "
            f"{plain}; step p50 {ms:.1f} ms over {steps - 1} steps")


def phase37(dev, tmp: str, card: str) -> dict:
    """The face step at full width (wav2vec 2.0 base with the face heads,
    8 s clips) on (dp 1, tp 2) with whole clips and (dp 2, tp 1) with
    buckets: two ranks on this card in a gloo group, FACE_DIST_STEPS steps a
    layout from one state, each held against the one-process step on the
    global batch with the global masks; a planted fault that the check must
    catch; the train CLI's s2g_face under torchrun at tp 2, its checkpoint
    loaded on one device.  Returns the K3 launches of the ranks' steps."""
    from talkshow_torch.models.face import FaceGenerator
    from talkshow_torch.data.dataset import synthetic_face_dataset
    from talkshow_torch.train.steps import make_face_step
    sc = dist_check()
    steps, layouts = FACE_DIST_STEPS, ("1x2", "2x1")
    t_phase = time.perf_counter()
    out = os.path.join(tmp, "dist_face")
    ranks = run_group(2, ["--face", *layouts, "--face_width", "full", "--face_steps", str(steps),
                          "--face_fault", "1x2", "--device", dev.type, "--out", out,
                          "--timeout", "600"], 600.0)
    log(f"phase 37 dp x tp: the face step at full width (wav2vec 2.0 base with the face heads, "
        f"8 s clips, T = 240, f32, TF32 off), 2 ranks on one card (gloo over CUDA tensors), "
        f"{steps} steps a layout from one state, each held against the one-process step from "
        f"the same state on the same global batch with the same global masks (SpecAugment and "
        f"dropout drawn for the global batch), beside that step computed in another order "
        f"[{time.perf_counter() - t_phase:.1f} s]")
    for layout in layouts:
        log(f"phase 37 {check_face_layout('phase 37', ranks, layout, steps, layout == '1x2')} "
            f"[{card}]")
    fault = ranks[0]["face_fault"]["errors"][0]
    if not sc.step_failures(ranks[0]["face_fault"]):
        raise AssertionError(f"phase 37: the planted fault passed the check: {fault}")
    log("phase 37 planted fault (1x2, the last tp rank puts its parameter slices back), failed "
        "as it must: " + ", ".join(f"{k} {fault['mesh'][k]:.1e} (spread {fault['f32'][k]:.1e})"
                                   for k in ("update_l2", "masters")))
    k3 = sum(r["face"]["1x2"]["k3"] for r in ranks)
    # the train CLI under torchrun, config.parallel tp 2, both ranks on this card
    cfg = os.path.join(tmp, "dist_face.json")
    write_stage_config(cfg, "s2g_face", 1)
    with open(cfg) as f:
        raw = json.load(f)
    raw["parallel"] = {"dp": 1, "tp": 2}
    with open(cfg, "w") as f:
        json.dump(raw, f)
    run_dir = os.path.join(tmp, "dist_face_run")
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
                          "--master_port", str(sc.free_port()),
                          "-m", "talkshow_torch.train", "--config_file", cfg, "--synthetic",
                          "--epochs", "1", "--run_dir", run_dir, "--device", dev.type],
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, OMP_NUM_THREADS="2"))
    cli_s = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"phase 37 torchrun: exit {res.returncode}\n{res.stderr[-4000:]}")
    vals = logged_values(run_dir)
    ckpt_path = os.path.join(run_dir, "ckpt-0.pt")
    if not (os.path.exists(ckpt_path) and vals and np.isfinite(vals).all()):
        raise AssertionError(f"phase 37 torchrun: files {os.listdir(run_dir)}, values {vals}")
    # the whole checkpoint on one device: a strict load, then one more step
    init, step = make_face_step(FaceGenerator())
    state = init(torch.Generator().manual_seed(0), dev)
    ckpt = torch.load(ckpt_path, map_location="cpu")
    state.load_state_dict(ckpt["state"])
    batch = next(iter(synthetic_face_dataset(4, 240).face_batches()))
    state, m = step(state, {k: torch.as_tensor(v, device=dev) for k, v in batch.items()},
                    torch.Generator(device=dev).manual_seed(1))
    if not (ckpt["global_step"] == 4 and state.step == 5 and math.isfinite(float(m["loss"]))):
        raise AssertionError(f"phase 37 torchrun checkpoint: step {ckpt['global_step']}, "
                             f"{state.step}, loss {float(m['loss'])}")
    import re
    line = re.search(r"rank 0 of \d+: \w+ on [\w:]+", res.stdout)
    log(f"phase 37 torchrun: `torchrun --nproc_per_node 2 -m talkshow_torch.train` s2g_face "
        f"with parallel tp 2 at full width on the synthetic 8 s clips, 1 epoch (4 whole-clip "
        f"steps): {line[0] if line else res.stdout[-200:]}; finite logs; rank 0's whole "
        f"ckpt-0.pt loads strictly into a one-device FaceState, whose next step's loss is "
        f"{float(m['loss']):.4f}; {cli_s:.1f} s of wall time")
    log(f"phase 37 wall time {time.perf_counter() - t_phase:.1f} s; ranks sharing one card "
        f"measure correctness, not scaling [{card}]")
    return {"wav2vec_extractor": k3}


def multi_device_phases(dev, tmp: str, wav10: str, card: str) -> dict:
    """Phases 34-37; returns their kernels' launches."""
    from talkshow_torch.pipeline import Pipeline
    train = phase34(dev, tmp, card)
    pipe = Pipeline.create(seed=0, device=dev)
    sampled = phase35(pipe, dev, wav10, card)
    served = phase36(pipe, dev, wav10, card)
    del pipe
    face = phase37(dev, tmp, card)
    launches = {k: sampled.get(k, 0) + served.get(k, 0) + face.get(k, 0) for k in KERNELS}
    launches["nearest_code"] += train["nearest_code"]
    log("launches in phases 34-37: " + ", ".join(f"{k} {v}" for k, v in launches.items()))
    return launches


T_START = time.time()


#: the benchmark cells whose steps run the Adam kernels, and their models
ADAM_CELLS = {"train-prior-3d": ("talkshow-3d", "pixel", 5.0),
              "train-vq-6d": ("talkshow-6d", "vq", None)}


def adam_leaf_shapes(cell: str) -> list:
    """The shapes of the leaves the cell's optimizer steps, at the widths of
    benchmark/configs/<config>.json (built on the meta device): the 3-D
    prior and audio encoder, 198 leaves of 24.1 M elements; the 6-D VQ-VAEs,
    212 of 71.0 M."""
    from talkshow_torch.models.pixelcnn import GatedPixelCNN
    from talkshow_torch.models.vqvae import VQVAE, AudioEncoder
    config, models, _ = ADAM_CELLS[cell]
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "benchmark", "configs",
                           f"{config}.json")) as f:
        cfg = json.load(f)
    vq, pr, ae = cfg["vq"], cfg["prior"], cfg["audio_encoder"]
    with torch.device("meta"):
        if models == "pixel":
            mods = [GatedPixelCNN(input_dim=pr["input_dim"], dim=pr["dim"],
                                  n_layers=pr["n_layers"], n_classes=pr["n_classes"],
                                  audio_channels=ae["num_hiddens"], hidden=pr["hidden"]),
                    AudioEncoder(ae["in_dim"], num_hiddens=ae["num_hiddens"])]
        else:
            mods = [VQVAE(vq[f"{p}_channels"], vq["embedding_dim"], vq["num_hiddens"],
                          vq["num_residual_layers"]) for p in ("body", "hand")]
    return [tuple(p.shape) for m in mods for p in m.parameters()]


def adam_case(shapes, dev, seed: int) -> dict:
    """Random parameters, gradients and moments of these shapes, the
    counts at step 3 with one skip."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    rand = lambda s, scale: scale * torch.randn(s, generator=gen, device=dev)  # noqa: E731
    return {"params": [rand(s, 0.05) for s in shapes],
            "grads": [rand(s, 1e-3) for s in shapes],
            "exp_avgs": [rand(s, 1e-4) for s in shapes],
            "exp_avg_sqs": [rand(s, 1e-4).square() for s in shapes],
            "step": torch.full((), 3.0, device=dev),
            "skipped": torch.ones((), dtype=torch.int64, device=dev)}


def adam_copy(case: dict) -> dict:
    return {k: ([t.clone() for t in v] if isinstance(v, list) else v.clone())
            for k, v in case.items()}


def adam_call(fn, case: dict, stats, finite, max_norm, **kw) -> None:
    fn(case["params"], case["grads"], case["exp_avgs"], case["exp_avg_sqs"], stats, finite,
       case["step"], case["skipped"], 1e-4, max_norm, (0.9, 0.999), 1e-8, **kw)


#: the Adam kernels' largest gap from their plain twin, in ulps (adam_gap):
#: v's multiply-add may be fused on one side (1 ulp), which reaches the
#: update through a square root and two divisions, and the sum rounds once
ADAM_ULPS = 4


def adam_gap(got: list, want: list, before: list) -> float:
    """The largest |got - want| over every element, in f32 ulps of the
    largest of |want|, the value before the step and the step's change
    (where the update cancels the old value, want is near 0 and the
    update's own rounding is the error)."""
    worst, f32 = 0.0, torch.finfo(torch.float32)
    for a, b, c in zip(got, want, before):
        scale = torch.maximum(torch.maximum(b.abs(), c.abs()), (b - c).abs())
        worst = max(worst, float(((a - b).abs() / (f32.eps * scale.clamp_min(f32.tiny))).max()))
    return worst


def phase38(dev, card: str) -> list:
    """The Adam kernels at the two training cells' leaf lists against their
    plain twin; their times beside the bytes bound.  Returns the kernel
    rows: (name, shape, launches, max error, (ms, plain ms), bound, library
    ms) of each kernel at train-prior-3d's list."""
    from talkshow_torch.kernels import adam as adam_kernels
    from talkshow_torch.kernels import counts
    rows = []
    for cell, (_, _, max_norm) in ADAM_CELLS.items():
        shapes = adam_leaf_shapes(cell)
        n_el = sum(math.prod(s) for s in shapes)
        case = adam_case(shapes, dev, 38)
        work = adam_kernels.workspace(len(shapes), dev)
        counts.clear()
        stats, finite = adam_kernels.grad_stats_kernel(case["grads"], work)
        again, _ = adam_kernels.grad_stats_kernel(case["grads"], work)
        plain, plain_finite = adam_kernels.grad_stats_plain(case["grads"])
        norm_gap = float((stats[1] - plain[1]).abs() / plain[1])
        if not (bool(finite) and bool(plain_finite) and torch.equal(stats, again)
                and norm_gap <= 1e-5 and counts["grad_stats"] == 2):
            raise AssertionError(f"phase 38 {cell} grad_stats: finite {bool(finite)}, "
                                 f"norm {float(stats[1])} vs plain {float(plain[1])}, reruns "
                                 f"equal {torch.equal(stats, again)}, counts {dict(counts)}")
        gaps = {}     # at the cell's max_norm, and clipped at half the norm
        for label, mn in (("cell", max_norm), ("clipped", 0.5 * float(stats[1]))):
            k, q = adam_copy(case), adam_copy(case)
            adam_call(adam_kernels.adam_apply_kernel, k, stats, finite, mn, work=work)
            adam_call(adam_kernels.adam_apply_plain, q, stats, finite, mn)
            gaps[label] = [adam_gap(k[key], q[key], case[key])
                           for key in ("params", "exp_avgs", "exp_avg_sqs")]
            if (max(gaps[label]) > ADAM_ULPS or float(k["step"]) != 4.0
                    or int(k["skipped"]) != 1):
                raise AssertionError(f"phase 38 {cell} adam_apply ({label}): {gaps[label]} "
                                     f"ulps (p, m, v) from the plain twin, step "
                                     f"{float(k['step'])}, skipped {int(k['skipped'])}")
        bad = adam_copy(case)
        bad["grads"][len(shapes) // 2].view(-1)[7] = float("nan")
        before = adam_copy(bad)
        s_bad, f_bad = adam_kernels.grad_stats_kernel(bad["grads"], work)
        adam_call(adam_kernels.adam_apply_kernel, bad, s_bad, f_bad, max_norm, work=work)
        same = all(torch.equal(a, b) for key in ("params", "exp_avgs", "exp_avg_sqs")
                   for a, b in zip(bad[key], before[key]))
        if bool(f_bad) or not same or float(bad["step"]) != 3.0 or int(bad["skipped"]) != 2:
            raise AssertionError(f"phase 38 {cell} NaN step: finite {bool(f_bad)}, unchanged "
                                 f"{same}, step {float(bad['step'])}, skipped "
                                 f"{int(bad['skipped'])}")
        del bad, before
        # times: the kernels on the device (replayed from a captured graph) and
        # per call from the host (the leaf tables built too), their plain twin,
        # torch's fused Adam (no clip, no skip)
        k = adam_copy(case)
        gs_call = lambda: adam_kernels.grad_stats_kernel(k["grads"], work)  # noqa: E731
        aa_call = lambda: adam_call(adam_kernels.adam_apply_kernel, k, stats,  # noqa: E731
                                    finite, max_norm, work=work)
        gs_ms, aa_ms = graph_ms(gs_call, 50), graph_ms(aa_call, 50)
        gs_host, aa_host = cuda_ms(gs_call, 50), cuda_ms(aa_call, 50)
        gs_plain = cuda_ms(lambda: adam_kernels.grad_stats_plain(k["grads"]), 5)
        aa_plain = cuda_ms(lambda: adam_call(adam_kernels.adam_apply_plain, k, stats, finite,
                                             max_norm), 5)
        fused = adam_fused_ms(k)
        gs_bound = bound(4.0 * n_el, 0.0)
        aa_bound = bound(28.0 * n_el, 0.0)
        log(f"phase 38 adam {cell}: {len(shapes)} leaves, {n_el / 1e6:.2f} M elements; "
            f"grad_stats {gs_ms:.4f} ms on the device (bound {gs_bound[0]:.4f} ms, bytes: "
            f"{gs_bound[0] / gs_ms:.1%}), {gs_host:.4f} ms a call from the host, plain twin "
            f"{gs_plain:.3f} ms; adam_apply {aa_ms:.4f} ms (bound {aa_bound[0]:.4f} ms: "
            f"{aa_bound[0] / aa_ms:.1%}), {aa_host:.4f} ms a call, plain twin {aa_plain:.3f} "
            f"ms, torch's fused Adam {fused[0]:.4f} ms on the device, {fused[1]:.4f} ms a "
            f"call; norm {norm_gap:.1e} "
            f"from the plain twin, bit-equal reruns; adam_apply (p, m, v) "
            f"{', '.join(f'{g:.2f}' for g in gaps['cell'])} / "
            f"{', '.join(f'{g:.2f}' for g in gaps['clipped'])} ulps from the plain twin (the "
            f"cell's clip / clipped); a NaN left every tensor bit-equal [{card}]")
        if cell == "train-prior-3d":
            rows = [("grad_stats", f"{len(shapes)} leaves", 1, norm_gap, (gs_ms, gs_plain),
                     gs_bound, None),
                    ("adam_apply", f"{len(shapes)} leaves", 1, max(gaps["cell"]),
                     (aa_ms, aa_plain), aa_bound, fused[0])]
        del case, k, work
        torch.cuda.empty_cache()
    return rows


def adam_fused_ms(case: dict) -> tuple[float, float]:
    """torch.optim.Adam(fused=True, capturable=True)'s step over the case's
    leaves (its own moments; no clip, no skip): (device ms from a captured
    graph, ms a call from the host), the library yardstick."""
    params = [torch.nn.Parameter(p.clone()) for p in case["params"]]
    for p, g in zip(params, case["grads"]):
        p.grad = g
    opt = torch.optim.Adam(params, lr=1e-4, fused=True, capturable=True)
    ms = graph_ms(opt.step, 50), cuda_ms(opt.step, 50)
    del opt, params
    return ms


def main() -> int:
    # ---- phase 1: device ---------------------------------------------------
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    log(f"phase 1 device: {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    # ---- phase 2: build ------------------------------------------------------
    from concurrent.futures import ThreadPoolExecutor

    from talkshow_torch.kernels import (_build, ar_decode, counts, nearest_code,
                                        wav2vec_extractor, wav2vec_layers)
    from talkshow_torch import native
    t0 = time.time()
    from talkshow_torch.kernels import adam as adam_kernels
    with ThreadPoolExecutor(len(KERNELS) + 2) as pool:
        rasterizer = pool.submit(_build.build_shared, native.SOURCE, native.GXX)
        sos = list(pool.map(_build.build, KERNELS + ("adam",))) + [rasterizer.result()]
    for mod in (ar_decode, wav2vec_layers, wav2vec_extractor, nearest_code, adam_kernels):
        mod._lib()
    native.load_library()
    log(f"phase 2 build: {', '.join(os.path.relpath(so) for so in sos)} built (nvcc for the "
        f"five kernel sources, g++ for the rasterizer, all started together) and loaded in "
        f"{time.time() - t0:.1f} s")

    # the Adam kernels' launches over every phase that trains in this process
    adam_launches, launched = {"grad_stats": 0, "adam_apply": 0}, adam_kernels._launched

    def tally(name, err, n):
        launched(name, err, n)
        adam_launches[name] += n.value

    adam_kernels._launched = tally

    # ---- phase 3: K1 against its plain version -------------------------------
    max_err = phase3(dev)
    phase3d(dev)

    # ---- phase 4: the main path ----------------------------------------------
    from talkshow_torch.models.pixelcnn import gumbel_noise
    from talkshow_torch.pipeline import Pipeline
    pipe = Pipeline.create(seed=0, device="cuda")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    wav10, wav1 = os.path.join(tmp, "speech10.wav"), os.path.join(tmp, "speech1.wav")
    write_wav(wav10, 10.0, 0)
    write_wav(wav1, 1.0, 1)
    counts.clear()
    outs = {S: pipe.generate(wav10, speaker="oliver", num_samples=S, seed=S) for S in (1, 8)}
    torch.cuda.synchronize()
    main_counts = dict(counts)
    launches, plain_calls = counts["ar_decode"], counts["sample_tokens_plain"]
    for S, out in outs.items():
        if out.shape != (S, 300, 265) or not np.isfinite(out).all():
            raise AssertionError(f"phase 4: S={S} output {out.shape}, finite={np.isfinite(out).all()}")
    if (launches < 1 or plain_calls != 0 or counts["wav2vec_layers"] != 2
            or counts["wav2vec_extractor"] != 2 or counts["face_plain"] != 0):
        raise AssertionError(f"phase 4: counts {dict(counts)}")
    log(f"phase 4 main: generate S=1 -> {outs[1].shape}, S=8 -> {outs[8].shape}, finite; "
        f"ar_decode launches {launches}, plain sampler calls {plain_calls}; face stage fused: "
        f"wav2vec_extractor launches {counts['wav2vec_extractor']}, wav2vec_layers launches "
        f"{counts['wav2vec_layers']}, plain face stage calls {counts['face_plain']}")

    # CUDA with f32 decode and face tables against the CPU: same weights, noise
    ref = Pipeline.create(seed=0, device="cpu")
    p32 = pipe.with_face_dtype(torch.float32)
    p32.table_dtype = torch.float32
    from talkshow_torch.ops.audio import get_mfcc
    feat = get_mfcc(wav1, device="cpu").numpy()
    noise = gumbel_noise((feat.shape[0] // 4, 2, 2, FULL["K"]),
                         torch.Generator().manual_seed(5), "cpu")
    _, tok_gpu = p32.generate_conv(feat, 0, 2, noise=noise)
    _, tok_cpu = ref.generate_conv(feat, 0, 2, noise=noise)
    counts.clear()
    m_gpu = p32.generate(wav1, speaker=0, num_samples=2, noise=noise)
    torch.cuda.synchronize()
    ref_counts = dict(counts)
    m_cpu = ref.generate(wav1, speaker=0, num_samples=2, noise=noise)
    dm = float(np.abs(m_gpu - m_cpu).max())
    if not (torch.equal(tok_gpu.cpu(), tok_cpu) and dm <= 1e-3
            and ref_counts.get("wav2vec_layers") == 1 and not ref_counts.get("face_plain")):
        raise AssertionError(f"phase 4 reference: tokens equal "
                             f"{torch.equal(tok_gpu.cpu(), tok_cpu)}, max|dmotion| {dm}, "
                             f"counts {ref_counts}")
    dm16 = float(np.abs(pipe.generate(wav1, speaker=0, num_samples=2, noise=noise)
                        - m_cpu).max())
    log(f"phase 4 reference: 1 s clip, CUDA (f32 decode and face tables, face stage fused) vs "
        f"CPU on the same weights and noise: tokens equal, max|dmotion| {dm:.2e} <= 1e-3; "
        f"bf16 decode and face tables vs CPU max|dmotion| {dm16:.2e} (reported)")
    del ref, p32

    # ---- phase 5: times ------------------------------------------------------
    card = card_line()
    plain_face = plain_face_pipeline(pipe)
    gen_p50 = {}
    for S, runs in ((1, 10), (8, 5)):
        t = generate_p50(pipe, plain_face, wav10, S, runs)
        gen_p50[S] = t["fused"][0]
        log(f"phase 5 generate S={S} 10 s clip, face stage fused (bf16 tables): p50 "
            f"{t['fused'][0]:.2f} ms over {runs} runs (min {t['fused'][1]:.2f}, max "
            f"{t['fused'][2]:.2f}); the same pipeline with the plain face stage (the parent's "
            f"generate), in turns: p50 {t['plain'][0]:.2f} ms (min {t['plain'][1]:.2f}, max "
            f"{t['plain'][2]:.2f}) [{card}]")

    from talkshow_torch.ops.audio import load_wav
    wav, _ = load_wav(wav10)
    feat10 = get_mfcc(wav10, device=dev)
    x = feat10[None]
    ids = torch.zeros(1, dtype=torch.long, device=dev)
    with torch.no_grad():
        audio = pipe.body.audio_enc(x)
        tokens = ar_decode.sample_tokens_fused(pipe.body.prior, ids, audio,
                                               tables=pipe._decode_tables)
        stages = {
            "face (fused)": cuda_ms(lambda: pipe.generate_face(wav), 3),
            "face (plain)": cuda_ms(lambda: plain_face.generate_face(wav), 3),
            "mfcc": cuda_ms(lambda: get_mfcc(wav10, device=dev), 3),
            "audio_encoder": cuda_ms(lambda: pipe.body.audio_enc(x), 3),
            "ar_decode": cuda_ms(lambda: ar_decode.sample_tokens_fused(
                pipe.body.prior, ids, audio, tables=pipe._decode_tables), 3),
            "vq_decode": cuda_ms(lambda: (
                pipe.body.vq_body.decode_latents(tokens[..., 0], pipe.body.vq_body_state),
                pipe.body.vq_hand.decode_latents(tokens[..., 1], pipe.body.vq_hand_state)), 3),
        }
    log("phase 5 stages S=1 (ms): " + ", ".join(f"{k} {v:.2f}" for k, v in stages.items())
        + f" [{card}]")
    log("phase 5 generate S=1 device time by kernel: " + idle_line(
        lambda: pipe.generate(wav10, speaker="oliver", num_samples=1, seed=7), gen_p50[1])
        + f" [{card}]")

    decode = phase5_k1(dev, card)

    # ---- phases 6-9: the fused face stage (K2, K3) -------------------------------
    err_k2 = phase6(dev)
    phase6_gemm(dev, card)
    err_k3 = phase7(dev)
    phase8(pipe.face_model, speech(1, 10.0, 0, dev))
    times = phase9(pipe.face_model, card)

    # ---- phases 10-12: training stage 1 and K4 -----------------------------------
    err_k4 = phase10(dev)
    train = phase11(dev, tmp)
    k4_times = phase12(train, card)

    # ---- phases 13-15: continuity, serving, streaming ------------------------------
    paths = {"generate": main_counts, "continuity": phase13(pipe, wav10, card),
             "serve": phase14(pipe, wav10, card), "stream": phase15(pipe, wav10, card)}
    del pipe
    path_launches = {k: sum(c.get(k, 0) for c in paths.values()) for k in KERNELS}
    log("launches on the inference paths: " + "; ".join(
        f"{p}: " + ", ".join(f"{k} {c.get(k, 0)}" for k in KERNELS[:3]) for p, c in paths.items()))

    # ---- phases 16-18: training stages 2 and 3 (K4 on cache misses, K3 frozen) ----
    pixel = phase16(dev, tmp, os.path.join(tmp, "run_a", "ckpt-0.pt"))
    face = phase17(dev, tmp)
    phase18(pixel, face, card)
    path_launches["wav2vec_extractor"] += face["launches"]
    k4_launches = train["launches"] + pixel["launches"]
    log(f"launches in training: nearest_code {train['launches']} (stage 1) + "
        f"{pixel['launches']} (stage 2, cache misses); wav2vec_extractor {face['launches']} "
        f"(stage 3, whole clips)")

    # ---- phases 19-21: the body AE and the evaluation path (K1-K4) ------------------
    ae_run = phase19(dev, tmp, card)
    evals = phase20(dev, tmp, {"vq": os.path.join(tmp, "run_a", "ckpt-0.pt"),
                               "pixel": os.path.join(tmp, "pixel_a", "ckpt-1.pt"),
                               "ae": ae_run["ckpt"]})
    phase21(evals, card)
    for k, v in evals["launches"].items():
        path_launches[k] += v
    k4_launches += evals["launches"]["nearest_code"]
    log("launches on the eval path (the runners and the eval CLI): " + ", ".join(
        f"{k} {v}" for k, v in evals["launches"].items()))

    # ---- phases 22-25: LS3DCG, the 6-D variant (K1 at 512 x 10, K4), the SHOW layout ----
    ls = phase22(dev, tmp, card)
    phase23(evals, ls, tmp, ae_run["ckpt"], wav10, card)
    del evals, ls
    six = phase24(dev, tmp, wav10, card)
    show = phase25(dev, tmp, card)
    path_launches["ar_decode"] += six["ar_decode"]
    path_launches["wav2vec_extractor"] += show["wav2vec_extractor"]
    k4_launches += six["nearest_code"] + show["nearest_code"]
    log(f"launches on the new paths: ar_decode {six['ar_decode']} (6-D generate, dim 512), "
        f"nearest_code {six['nearest_code']} (6-D stages 1-2, eval_vq_capacity) + "
        f"{show['nearest_code']} (stage 1 on the SHOW layout), wav2vec_extractor "
        f"{show['wav2vec_extractor']} (the face stage on the SHOW layout); LS3DCG none")

    # ---- phases 26-29: the user entry points, rendering, the vertical-only
    # prior, the causal VQ-VAE ------------------------------------------------
    clis = phase26(dev, tmp, wav10, card)
    phase27(dev, tmp, clis["motion"], wav10, card)
    vertical = phase28(dev, tmp, wav10, os.path.join(tmp, "run_a", "ckpt-0.pt"), card)
    causal = phase29(dev, card)
    for k, v in clis["launches"].items():
        path_launches[k] += v
    k4_launches += vertical["nearest_code"] + causal
    log("launches on the entry points (phase 26): " + launch_line(clis["launches"])
        + f"; nearest_code {vertical['nearest_code']} (the vertical-only prior's stage 2) + "
        f"{causal} (the causal VQ-VAE)")

    # ---- phases 30-33: --bf16, the full schedule, Wav2VecVQEncoder, the
    # Meshtalk face and the legacy S2G family ---------------------------------
    new = new_phases(dev, tmp, os.path.join(tmp, "run_a", "ckpt-0.pt"), wav10, card)
    for k in KERNELS[:3]:
        path_launches[k] += new[k]
    k4_launches += new["nearest_code"]

    # ---- phases 34-37: dp x tp training, sharded sampling, the mesh server,
    # the face step on the mesh --------------------------------------------------
    multi = multi_device_phases(torch.device("cuda", torch.cuda.current_device()), tmp, wav10,
                                card)
    for k in KERNELS[:3]:
        path_launches[k] += multi[k]
    k4_launches += multi["nearest_code"]

    # ---- phase 38: the Adam steps' kernels ------------------------------------------
    in_steps = dict(adam_launches)
    adam_rows = phase38(dev, card)
    log(f"launches of the Adam kernels in the steps this process ran in phases 11-37: "
        f"grad_stats {in_steps['grad_stats']} (once an Adam or SGD step), adam_apply "
        f"{in_steps['adam_apply']} (once an Adam step; phases 11, 16, 17 and 19 check "
        f"those counts); "
        f"{adam_launches['grad_stats'] - in_steps['grad_stats']} and "
        f"{adam_launches['adam_apply'] - in_steps['adam_apply']} in phase 38's own calls, "
        f"left out of the kernels line")

    # bounds at B = 1 (K4: N = 2816, one quantizer's rows of a training batch)
    # from the timed inputs
    t1 = ar_decode.pack_decode_tables(prior_case(1, 41, dev)[0], torch.bfloat16)
    enc_t, ext_t = times["t16"]["enc"], times["t16"]["ext"]
    x1 = times["x1"]
    k2_bytes = nbytes(*(v for v in enc_t.values() if torch.is_tensor(v))) + 2 * nbytes(x1) + 4
    k3_bytes = nbytes(ext_t["w0"], ext_t["ws"], ext_t["gn"]) + 160000 * 4 + 499 * 512 * 4
    k4_ms, k4_plain, _, k4_x = k4_times[2816]
    N4, K4, D4 = k4_x.shape[0], TRAIN["codes"], TRAIN["dim"]
    k4_bytes = nbytes(k4_x, k4_times["emb"]) + N4 * 8
    rows = [
        ("ar_decode", "B=1", ar_decode, path_launches["ar_decode"], max(max_err, six["k1_err"]),
         decode[1], k1_bound(t1, FULL["layers"], FULL["dim"], FULL["K"], FULL["H"]), None),
        ("wav2vec_layers", "B=1", wav2vec_layers, path_launches["wav2vec_layers"], err_k2,
         times[("K2 wav2vec_layers", 1)], bound(k2_bytes, k2_ops([300], 300, enc_t)),
         times[("library", 1)]),
        ("wav2vec_extractor", "B=1", wav2vec_extractor, path_launches["wav2vec_extractor"],
         err_k3, times[("K3 wav2vec_extractor", 1)], bound(k3_bytes, k3_ops(1, 160000, ext_t)),
         None),
        # f32 sums, so the f32 peak; no single PyTorch call computes K4 (phase 12 times
        # the two-call argmin(addmm) yardstick)
        ("nearest_code", f"N={N4}", nearest_code, k4_launches, err_k4, (k4_ms, k4_plain),
         bound(k4_bytes, 2.0 * (N4 + 1) * K4 * D4, F32_FLOP_S), None),
    ] + [(name, shape, adam_kernels, in_steps[name], err, times_, bnd, lib)
         for name, shape, _, err, times_, bnd, lib in adam_rows]
    for name, shape, _, n, _, (ms, plain_ms), (bms, by), _ in rows:
        log(f"bound {name} {shape}: {bms:.4f} ms ({by}); kernel {ms:.4f} ms = {bms / ms:.1%} "
            f"of the bound's rate; launches on the main path {n}")
    bms, by = six["k1_bound"]
    log(f"bound ar_decode B=1 at the 6-D prior (dim 512 x 10): {bms:.4f} ms ({by}); kernel "
        f"{six['k1_ms'][1]:.4f} ms = {bms / six['k1_ms'][1]:.2%} of the bound's rate")
    log(f"total wall time {time.time() - T_START:.1f} s")
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": mod.SOURCE, "replaces": mod.REPLACES,
        "launches": n, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bms, "bound_by": by, "library_ms": lib_ms}
        for name, _, mod, n, err, (ms, plain_ms), (bms, by), lib_ms in rows]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
