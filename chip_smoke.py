#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check its kernels.

    python3 chip_smoke.py        # from the repository root, one CUDA device

Phases, each of which exits non-zero on failure:

1. card: the GPU's name and power limit (nvidia-smi), torch and CUDA.
2. build: every CUDA source under indonesian_image_captioning_tpu_torch/csrc
   is compiled by nvcc for sm_90a into build/torch_kernels/.
3. kernels: each hand-written kernel at the flagship widths (B=32 images,
   K=5 beams, P=196 pixels, E=2048, A=D=Emb=F=512, V=6,763), in float32
   and bfloat16, against its plain PyTorch version on the same inputs: the
   largest error with its tolerance, and the median time of each over 20
   runs (CUDA events, in turns plain, kernel, kernel, plain); kernels 1,
   2, 5, 6b, 6c, 7 and 13 also with their device time (torch.profiler),
   kernels 1 and 5 also cold (a 100 MB buffer written before each timed
   call, so the state comes from device memory, as the bound assumes)
   and the chains 2, 6c, 7 and 13 with the device time of their attention
   stage.  Kernel 2 is
   checked for all three model families (SCN and LSTM cells, with and
   without attention; pure_scn's form is kernel 6b).  Kernel 7 (the span decode) runs one S=4 call from
   a mid-decode state (two plain steps with a head biased toward <end>,
   then every fourth image dead), both cells; kernel 13 (the megakernel)
   one 51-step decode; their records must equal the plain version's but
   at near-ties (REC_TOL).  Kernel 13 also: 7 launches a step
   (csrc/step.cu's counter), then three decodes of one graph launch each
   and no capture, no launch of csrc/mma.cuh's or gemm.cuh's GEMM (the
   profiler's kernel names), the host ms of the graph's capture, of the
   copy of a decode's inputs into its workspace and of the other way to
   feed them (every kernel node's parameters set again on the executable
   graph), and the device ms by stage.  Kernel 10 (the top-k) runs on a
   (32, 5 x 6,763) float32 beam candidate table and must equal
   row_topk_iterative
   bitwise; torch.topk, one PyTorch call for the same values, is timed
   beside it as the library yardstick.  Kernel 5 (the int8 attention)
   with and without alpha, kernel 6c (the int8 fused step) for both cells,
   kernel 12 (the fused SCN cell) at attention_scn's input width (2,560)
   and pure_scn's (512), in float32 and bfloat16 (2 launches a call from
   csrc/scn.cu's counter, no gemm.cuh launch, device ms by launch), and
   kernel 11 (the vocab head, float32 only) on 160 rows: the same holds
   for each (error against
   its tolerance, median times, ids equal but at near-ties).  Kernel 14
   (the embedding gradient) on the ids and masked cotangent of 32 seeded
   captions (N = 32 x 51 = 1,632 tokens, V = 6,763, E = 512) in float32
   and bfloat16, at b1024 (N = 52,224) and on ids that are all 0 or 7:
   every element within EMBED_TOL of its column's sum of |g| against the
   plain version, two calls bitwise equal, and the medians of the kernel,
   the plain version, one index_add_ call (the library yardstick) and the
   one-hot product that embed_grad_impl="onehot" runs.  Beams past eight:
   kernels 1, 5 and 7 at K = 9, 32 and 64 (WIDE_K), held and timed the
   same way,
   and kernel 10 at k = 69 (three passes).  The
   tensor-core GEMM of the span chain (csrc/mma.cuh; its products run
   kernel 7) at two of the chain's products at R = 160 rows (In 2,560 ->
   2,048 and D 512 -> V 6,763), float32
   (3xTF32) and bfloat16: within GEMM_TOL of sum |a||w| of a float64
   product, as gemm.cuh's FFMA GEMM is, with the medians of both and of
   torch.matmul (the library yardstick).  The bounds of the kernels whose
   products run on the tensor cores (2, 6b, 6c, 7, 8, 9, 12, 13) are
   taken at float32 against the 3xTF32 peak
   (495 TFLOP/s for three products), the FFMA peak's printed beside.
4. serve: the main path.  A CaptionEngine on seeded random weights
   (ResNet-152 caption encoder and tagger with BatchNorm statistics
   calibrated on one seeded batch, attention_scn at V=6,763), buckets
   (1, 8, 32): warmup(256), the host time of packing the decode weights
   cold and from their cache, one 32-image caption_batch, then 12 requests
   through start/submit/stop.  The launch counters are zeroed just before
   and read just after; the decode must have resolved to "fused_span" and
   gone through kernel 7 once per span call (1 to ceil(51 / 4) per
   batch), with kernel 2's counter at 0 and the tensor-core GEMM's above
   0 (csrc/span.cu counts its launches).  Then a second engine on the same
   weights and BatchNorm statistics with enc_quant="int8": one 32-image
   caption_batch, whose decode must resolve to "fused_step" and launch
   kernel 6c once per decode step, kernel 2 not at all.
5. inference: caption_beam_search on the same encodings at float32 through
   four rungs, each with the counters zeroed just before and read just
   after: "steps" with record_alphas=True (kernel 1; alphas sum to 1),
   "fused_step" (kernel 2), "fused_span" (kernel 7) and "fused" (kernel
   13); each rung's beams equal the steps rung's except for rows whose
   first divergence is a near-tie (prefix scores within 1e-4).  Then one
   "steps" decode with the dense head and topk_backend="pallas" (kernel 10
   on its path), held the same way.  The opt-in modes on the same
   encodings, each path with the counters zeroed just before and read
   just after: int8 "steps" with alphas (kernel 5; alphas sum to 1) and
   int8 "fused_step" (kernel 6c; beams equal int8 "steps" but at
   near-ties), the rows where int8 agrees with float32 counted (the mode
   is lossy by contract); fused_cell=True on "steps" with alphas (kernel
   12; beams equal the unfused engine's but at near-ties); a pure_scn
   decoder on the same encodings and tags, "auto" (kernel 6b, "fused_step")
   and fused_cell "steps" (kernel 12), both held against pure_scn's
   "steps"; and the isolated vocab head of tools/profile_decode.py on the
   h rows of one kernel-2 step (kernel 11), whose candidates topv - lse
   and ids must equal the step's but at near-ties.  Then beams of 16 and
   40 through "auto" (kernel 7, "fused_span"), their beams equal to the
   "steps" rung's at the same width but at near-ties.  Then a breakdown per
   rung at B=32 (the int8 rungs too): the decode on the host clock,
   captions/s and the device busy share from torch.profiler, beside the
   encoders' time.
6. checkpoints and evaluation: the state that make_state builds written
   three ways (the reference's serve format, a caption file and a tagger
   file of state_dicts; its training format, whole modules of a class
   that cannot be imported at load time, so unpickling stubs it; the
   port's own checkpoint files) and each loaded
   onto the card through cli.common.load_caption_state and
   load_tagger_state, every leaf bitwise the state's, with the load time
   of each.  Then a TEST split of 64 seeded noise images, 5 Zipf-drawn
   captions each (CaptionDataset.from_arrays: the card's machine has no
   h5py), beam-decoded by eval_caption.decode_dataset in batches of 32 at
   beam 5, the counters zeroed just before and read just after (kernel 7
   launched, kernel 1 not), every hypothesis equal to a direct
   caption_beam_search's on the same batches, scored without METEOR (it
   needs nltk), its images/s and the two encoders' share; the tagger's
   TEST accuracy (eval_tagger.evaluate_dataset over
   TagDataset.from_arrays) equal to a plain computation over the same
   outputs, and its images/s; and one image through
   cli.inference.caption_image (uint8 in, no PIL) with the counters
   zeroed just before and read just after: the "steps" rung with kernel
   1, the alphas of every step after <start> summing to 1 within 1e-3,
   the caption equal to caption_batch's but at a near-tie (the two run
   on other rungs).
7. train: the cached-feature caption trainer, attention_scn at the
   flagship widths, V=6,763, T=51, B=32, decoder float32, encoders
   bfloat16.  Kernels 8 and 9 (the teacher-forcing scan, forward and
   backward) against their plain versions on the same inputs, float32 and
   bfloat16, SCN and LSTM cells: the error of every output and stream
   against TRAIN_TOL (forward) and TRAIN_BWD_TOL (backward), the median
   time of each over 20 runs beside its device time (torch.profiler), the
   six kernels of one call that take the most device time, the launches a
   step read from csrc/train.cu's counter (at most 4 forward and 5 in the
   backward's loop), and the host time of the weight packs made on every
   call.
   Then one caption_loss gradient through the kernels ("fused") and
   through the eager autograd scan ("xla") on the cached features of one
   batch, dropout off: every parameter within 5e-3 of its largest value,
   the loss within 1e-4.  Then the main path: 5 make_caption_train_step
   steps on those features, the counters zeroed just before and read just
   after (each step launches the forward and the backward chain once),
   with a finite and falling loss; a breakdown of one step (host clock,
   device busy share and device time by kernel group, torch.profiler); and
   one step with the chunked head, whose loss must equal the dense head's
   within 1e-5.
8. trainer: the trainer's main path, train.caption.train (the port's
   cli/train.py runs it from files) at the same widths with
   embed_grad_impl="pallas", on an in-memory corpus of 96 TRAIN and 32
   VAL seeded noise images, 5 Zipf-drawn captions each: BatchNorm
   calibrated on one batch, the feature cache on the device, 2 epochs
   with BLEU-4 and checkpoints, the counters zeroed just before and read
   just after (kernel 14 once per train step, kernels 8 and 9 once per
   train step and 8 once per validation step), every step loss finite,
   checkpoint_* and BEST_checkpoint_* written, the saved Adam moments
   bitwise the trainer's.  Then a resume with nothing left to run (Adam's
   moments bitwise the saved ones), a resume for epoch 3 (it starts
   there and runs kernel 14 once per step), one uncached epoch through
   the device image store (each step loss within UNCACHED_TOL of the
   cached run's), and a profile of one train step with kernel 14.  It
   prints the epoch seconds, train imgs/s and the feature-cache build
   time.
9. encoder training: the encoders' training paths at the same widths
   (ResNet-152s at 256 px, 1000 tags, V=6,763) on 128 TRAIN and 32 VAL
   seeded noise images held in memory.  The tagger trainer
   (train.tagger.train, float32, B=32, 2 epochs of 4 steps through the
   device image store): finite step losses, its checkpoint loaded
   through cli.common.load_tagger_state bitwise and scored by
   eval_tagger.evaluate_dataset equal to a plain computation, a resume
   that runs nothing with Adam's state bitwise.  Its step on one batch
   at tagger_dtype float32 and bfloat16 (weights with every residual
   branch damped, bn3 scale x ENC_DAMP): each dtype's loss falls over
   ENC_DTYPE_STEPS steps, masters and running statistics stay float32,
   the first losses agree within DTYPE_FIRST_TOL, and the first
   gradients in bf16 lie at a cosine of at least DTYPE_HEAD_COS to the
   float32 ones in the linear head and DTYPE_BACKBONE_COS in the median
   ResNet leaf; the step ms, imgs/s,
   peak memory and the device time by kernel.  One forward and backward
   at B=REMAT_B under encoder_remat False, "blocks" and "convs": the
   loss within REMAT_LOSS_TOL and every gradient within REMAT_GRAD_TOL
   of no remat's, each mode's ms and peak memory.  Then fine-tuning:
   train.caption.train with fine_tune_encoder=True and
   embed_grad_impl="pallas", the tagger above as its tagger_checkpoint,
   2 epochs of 4 steps at B=32, the counters zeroed just before and read
   just after (kernel 14 once a train step, kernel 8 once a validation
   step, kernel 9 never; printed on a line of their own, apart from the
   kernels line): the stem's conv1 and bn1 and all of layer1 bitwise,
   layer4 and the stem's running mean moved, and a resume that restores
   the encoder's Adam bitwise.  Each trainer's epoch s and each async
   save's wait, copy and write seconds.
10. data-parallel training and tools: corpus_score's unigram perplexity
   over phase 6's TEST hypotheses; two ranks on cuda:0 over NCCL, which
   refuses a card shared by two ranks (the error is printed); a
   GloVe-format file for the V=6,763 word map at E=512, loaded by
   utils/embedding.load_embeddings with its rows bitwise the file's.  Then
   DP_RANKS ranks spawned on cuda:0 over gloo (the transport, named by the
   phase; every tensor of the steps on cuda:0), the decoder's embedding
   from that file: 3 steps of parallel/train_step's
   make_parallel_caption_train_step (train/steps.make_caption_train_step
   given the mesh) at a global B=32 (16 rows a rank) at the flagship
   widths with embed_grad_impl="pallas", each rank's counters zeroed just
   before and read just after (kernels 8, 9 and 14 once a step), both
   ranks' metrics and parameters bitwise equal; each step held against
   one rank's step from the same state on the same global batch (the
   summed, clamped gradients within DP_GRAD_TOL and the update within
   DP_UPDATE_TOL, both relative in the 2-norm, the loss within
   DP_LOSS_TOL) and a control, rank 0's rows alone, that must fail those
   limits; the parameters' movement over the 3 steps within DP_PARAM_TOL
   of one rank's own run's; the same on two halves of 816 and 48 tokens,
   with DDP's average of the halves' means as a second control; a bare
   all_reduce of the gradients' size timed between two synchronizes; one
   step inside core.profiling.trace with annotate("train_step"), its
   Chrome trace holding the annotation and kernels 8 and 9; one epoch of
   train.caption.train at mesh (2, 1) on 64 + 32 in-memory noise images
   (kernels 8, 9 and 14 a step a rank), rank 0's checkpoint loaded by
   cli.common.load_caption_state bitwise each rank's state; and
   DP_TAGGER_STEPS tagger steps at f32 (global B=16, 256 px, residual
   branches damped), each held against one rank's from the same state
   (loss and running statistics within DP_TAGGER_TOL, gradients within
   DP_TAGGER_GRAD_TOL, the update within DP_TAGGER_UPDATE_TOL) with rank
   0's rows alone as the control.  It prints each rank's step ms, one
   rank's on the whole batch, the all_reduce's ms, StepTimer.summary(),
   every reading beside its limit and the phase's wall time beside the
   card's name and power limit.

The line before the last lists each kernel as JSON: the thirteen that
replace a TPU kernel, and the tensor-core GEMM of the decode chain
("replaces": null, no TPU kernel of its own), whose launches are counted
on the serving batch (kernel 7's chain, csrc/span.cu); the last line is
{"ok": true, "device": {...}}.  Without a CUDA device, or without the
repository beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

SEED = 0
B, K = 32, 5               # images per batch, beam width
VOCAB = 6763               # the reference vocabulary
IMAGE_SIZE = 256
TOL = {  # largest absolute error allowed against the plain version
    "float32": {"attend": 1e-4, "step_vals": 1e-4, "step_state": 1e-4},
    # a few bf16 ulps at the outputs' magnitudes (|h|, |c| < ~2, logits
    # < ~10): the kernel rounds once where the plain version rounds twice
    "bfloat16": {"attend": 3e-2, "step_vals": 1e-1, "step_state": 5e-2},
}
NEAR_TIE = 1e-4
# Kernels 7 and 13 against their plain versions, image by image: the
# records equal up to the first step whose picks differ, where the two
# picks' values must lie within "near" (a near-tie: the image's decode
# differs from there on, and its later records and state are not
# compared); until then vals and the carried scores within "vals", h and
# c within "state".  float32: summation order.  bfloat16: kernel 2's
# one-ulp differences in the logits (about 0.03 at |x| ~ 8) reach the
# log-probabilities and add up in the scores over the steps.
REC_TOL = {"float32": {"vals": 1e-4, "state": 1e-4, "near": NEAR_TIE},
           "bfloat16": {"vals": 0.25, "state": 5e-2, "near": 0.25}}
SPAN = 4                   # ModelConfig().decode_span
END_BIAS = 0.5             # kernel 7's call: a head biased toward <end>
NEG = -1e30
# Kernel 8 (forward): largest error against the plain version, relative to
# each output's largest magnitude.  float32: summation order, grown over
# 51 recurrent steps.  bfloat16: the kernel and the plain version round at
# the same points, but a float32 sum that lands on the other side of a
# bfloat16 rounding boundary moves a value by one ulp (2^-8), and the
# recurrence carries it on.
TRAIN_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# Kernel 9 (backward): the error's norm relative to the output's norm.  The
# relu mask rt(ea + dec) > 0 flips wherever ea + dec lies within an ulp of
# 0, because the kernel's dec sums in another order than cuBLAS's; each
# flip moves one ddec element by a whole pixel's term (measured at float32,
# B=32: 1.8e-5 against a largest ddec of 4.4e-4) and dh carries it to the
# earlier steps.  Rare flips leave the norm within these.
TRAIN_BWD_TOL = {"float32": 1e-3, "bfloat16": 5e-2}
GRAD_TOL, LOSS_TOL, HEAD_TOL = 5e-3, 1e-4, 1e-5
# Kernel 11 against its plain version: raw logits and log-sums within this
# share of their largest magnitude (float32 summation order over D=512).
FC_TOL = 1e-5
TRAIN_STEPS = 5
# Kernel 14 against its plain version: each table element within this
# share of its column's sum of |g| (float32 sums in another order; the
# plain version's index_add_ adds with atomics in a varying order).
EMBED_TOL = 1e-6
# The trainer phase: TRAIN and VAL images, captions per image, epochs
TRAINER_IMAGES, TRAINER_CPI, TRAINER_EPOCHS = (96, 32), 5, 2
# The checkpoints-and-evaluation phase: TEST images, captions per image,
# the evaluation's batch, and the share of tags set in its tag split; the
# module named by its training-format checkpoints' classes, absent at load
EVAL_IMAGES, EVAL_CPI, EVAL_BATCH, EVAL_TAG_RATE = 64, 5, 32, 0.01
REFERENCE_MODULE = "reference_models_not_installed"
# The encoder-training phase: TRAIN and VAL images (the tagger's and the
# fine-tune's splits, one caption an image), epochs, the share of tags set,
# the one-batch steps per tagger_dtype and their LR, the remat step's
# batch.  The one-batch and remat weights damp every residual branch (each
# bottleneck's bn3 scale times ENC_DAMP): a random ResNet in train mode is
# chaotic, so float32 and bfloat16 (or two summation orders) would
# otherwise give unrelated losses from the first step.  Tolerances: the
# first-step losses of the two dtypes (relative, absolute; JAX's
# tests/test_train_smoke.py), the remat modes' loss (relative) and
# gradients (of each leaf's largest).
ENC_IMAGES, ENC_EPOCHS, ENC_TAG_RATE = (128, 32), 2, 0.01
ENC_DTYPE_STEPS, ENC_LR, ENC_DAMP, REMAT_B = 8, 1e-3, 0.2, 8
DTYPE_FIRST_TOL, REMAT_LOSS_TOL, REMAT_GRAD_TOL = (0.05, 0.05), 1e-5, 1e-3
# The bf16 step's first gradients against float32's, as cosines: each of
# the head's two leaves, and the median over the ResNet's trainable leaves.
# bf16's rounding alone takes a ResNet leaf to 0.42-0.86 here (median 0.59;
# TF32 gives 0.92-0.99), the head to 0.9997 or more; a step with wrong
# features misses both (tests/test_torch_tagger_bf16.py's controls).
DTYPE_HEAD_COS, DTYPE_BACKBONE_COS = 0.99, 0.3
# one epoch through the uncached path (the device image store) against the
# cached run's first epoch: each step's loss within this share of it
UNCACHED_TOL = 1e-4
# The data-parallel phase: ranks on the one card, the global caption batch,
# the steps held against one rank's, the trainer's TRAIN and VAL images
# (TRAINER_CPI captions each), the tagger's global batch and steps.
# Each data-parallel step is held against one rank's step from the same
# state (parameters, Adam's moments, running statistics) on the whole
# global batch: the summed, clamped gradients and the update, each
# relative in the 2-norm, within DP_GRAD_TOL and DP_UPDATE_TOL (the
# tagger's DP_TAGGER_GRAD_TOL and DP_TAGGER_UPDATE_TOL), the loss within
# DP_LOSS_TOL relative, the tagger's loss and each running statistic
# within DP_TAGGER_TOL relative (of each leaf's largest; its residual
# branches damped by ENC_DAMP, as in the encoder-training phase).  A
# control, rank 0's rows alone (its own mean, nothing summed), and for
# the unequal halves DDP's average of the two halves' own means, must
# exceed those limits.  The parameters' movement over DP_STEPS caption
# steps lies within DP_PARAM_TOL (2-norm, relative) of one rank's own
# run over the same global batches.  No limit is per weight: Adam moves
# a weight by about lr whatever its gradient's size, so a near-zero
# gradient that takes the other sign moves it 2 lr the other way in a
# sound run.  Each limit lies between the sound reading and the
# control's, read on an H100: gradients 3.9e-07 against 0.17 (the
# tagger's 1.3e-03 against 0.19), update 2.0e-05 against 0.78 (the
# tagger's 0.059 against 1.2), statistics 6.6e-07 against 0.044, the
# loss 1.1e-07 against DDP's 2.2e-04 (at random weights every token's
# loss is near log V, so any weighting of the tokens moves the mean
# little), the movement over 3 steps 3.6e-05.
DP_RANKS, DP_B, DP_STEPS = 2, 32, 3
DP_TRAINER_IMAGES, DP_TAGGER_B, DP_TAGGER_STEPS = (64, 32), 16, 2
DP_GRAD_TOL, DP_UPDATE_TOL, DP_PARAM_TOL, DP_LOSS_TOL = 1e-4, 5e-3, 5e-3, 1e-5
DP_TAGGER_TOL, DP_TAGGER_GRAD_TOL, DP_TAGGER_UPDATE_TOL = 1e-4, 0.02, 0.25
DP_NCCL_TIMEOUT_S, DP_TIMEOUT_S = 120, 600
# The model-axis phase: a (data, model) mesh of ranks on the one card over
# gloo, attention_scn at the reference widths with the COCO-ID vocabulary
# (V = 38,732 = 4 x 9,683: the model axis must divide V, and the flagship
# 6,763 is odd), DP_B global rows, MA_STEPS steps a head, the trainer's
# TRAIN and VAL images and the evaluation's TEST images (TRAINER_CPI
# captions each).  Each step on every rank is held against one rank's
# unsharded step from the same state (the blocks gathered over the model
# group) on the whole global batch: the rank's clamped gradients (its
# vocabulary block against the matching slice) and its update, each
# relative in the 2-norm, within MA_GRAD_TOL and MA_UPDATE_TOL, the loss
# within MA_LOSS_TOL relative, top-5 within one token.  A control, d_h
# not summed over the model group, must exceed the gradient and update
# limits.  Each limit lies between the sound reading and the control's,
# read on an H100: gradients 3.4e-07-8.6e-07 against 0.35 (model rank 0)
# and 0.92 (rank 1), update 2.6e-06-2.0e-05 against 0.49 and 0.97, the
# loss up to 8.5e-08 (the control's forward is the same), top-5 equal.
# The embedding block's gradient alone is held to MA_GRAD_TOL too, so a
# wrong block is not diluted by the other leaves, and kernel 14 is held
# to its plain version on each rank's ids shifted into its block (most
# of them outside it) at EMBED_TOL.  MA_FT_STEPS fine-tune steps of
# MA_FT_B global images must leave the replicated leaves, their moments
# and the running statistics bitwise equal on every rank.
MA_MESH, MA_VOCAB, MA_STEPS = (2, 2), 38732, 3
MA_TRAINER_IMAGES, MA_TEST_IMAGES, MA_TIMEOUT_S = (64, 32), 32, 600
MA_FT_B, MA_FT_STEPS = 8, 2
MA_GRAD_TOL, MA_UPDATE_TOL, MA_LOSS_TOL = 1e-4, 5e-3, 1e-5
# The card's published peaks (NVIDIA H100 SXM data sheet) for bound_ms.
# "tf32x3": a float32 product as the tensor-core GEMM (csrc/mma.cuh)
# computes it, three TF32 products at 495 TFLOP/s.
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"float32": 67e12, "bfloat16": 989e12, "tf32x3": 495e12 / 3}
WIDE_K = (9, 32, 64)      # beam widths past eight; every kernel takes any K
# The tensor-core GEMM against a float64 product: each output within this
# share of sum_k |a_mk| |w_kn| (float32 sums; 3xTF32 keeps float32's
# precision), as gemm.cuh's FFMA GEMM is held.
GEMM_TOL = 1e-5


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def median_ms(fns, runs=20):
    """Median milliseconds per call of each of fns (CUDA events), timed in
    turns a, b, b, a so drift falls on both."""
    import torch

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    order = list(range(len(fns))) + list(reversed(range(len(fns))))
    for _ in range(runs // 2):
        for i in order:
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fns[i]()
            e.record()
            e.synchronize()
            times[i].append(s.elapsed_time(e))
    return [statistics.median(t) for t in times]


PROFILE_TRIES = 10
PROFILE_RETRIES = [0]   # profiles taken again: they missed kernels
# launches that open every profile (profile_cuda) and are not counted
PROFILE_LEAD = 8
# the CUDA calls that launch one kernel each, as torch.profiler names them
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")


@dataclasses.dataclass
class DeviceTime:
    """One name's device activity in a profile: its records (count) and
    their microseconds (self_device_time_total), as torch.profiler's
    key_averages name them."""
    key: str
    count: int
    self_device_time_total: float


def profile_cuda(fn, runs=1):
    """The device activity (kernels, copies) of runs calls of fn, a
    DeviceTime a name, from torch.profiler's CPU and CUDA activity.

    In a process that has run for a while, a profile on the card loses
    the kernel records of its first one or two launches (their launch
    calls are recorded; the later launches' kernels are not lost).  So
    every profile opens with PROFILE_LEAD launches of a spin kernel and a
    synchronize, which are not counted, and is complete only if every
    launch call of fn's (cudaLaunchKernel and kin) has its kernel record,
    matched by CUPTI correlation id.  An incomplete profile is taken
    again, up to PROFILE_TRIES times (PROFILE_RETRIES counts them), and
    SmokeFailure is raised if none is complete, so that no reader sees a
    time or a kernel list that was not measured.  Graph launches and
    copies add records that the launch calls do not count.  The card
    tests (tests/test_torch_cuda.py) and chip_compare.py read this helper
    too."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_LEAD):
                torch.cuda._sleep(100)
            torch.cuda.synchronize()
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        raw = prof.profiler.kineto_results.events()
        calls = sorted((e for e in raw if e.device_type() == DeviceType.CPU
                        and e.name() in LAUNCH_CALLS),
                       key=lambda e: e.start_ns())
        lead = {e.correlation_id() for e in calls[:PROFILE_LEAD]}
        device = [e for e in raw if e.device_type() == DeviceType.CUDA
                  and e.correlation_id() not in lead]
        seen = {e.correlation_id() for e in device}
        missing = sum(e.correlation_id() not in seen
                      for e in calls[PROFILE_LEAD:])
        if device and not missing:
            PROFILE_RETRIES[0] += attempt
            got = {}
            for e in device:
                d = got.setdefault(e.name(), DeviceTime(e.name(), 0, 0.0))
                d.count += 1
                d.self_device_time_total += (e.end_ns() - e.start_ns()) / 1e3
            return list(got.values())
    raise SmokeFailure(f"{PROFILE_TRIES} profiles of {fn} missed kernels: "
                       f"{missing} of {len(calls) - PROFILE_LEAD} launch "
                       f"calls without a record in the last, {len(device)} "
                       "device records")


def device_ms(fn, runs=20, by_kernel=None):
    """Milliseconds of device time per call of fn: the kernels' own time
    from torch.profiler (profile_cuda), without the host's launch gaps
    that the CUDA events of median_ms include when the card waits on the
    host.  by_kernel, a dict, receives the milliseconds of each kernel
    name."""
    times = {e.key: e.self_device_time_total / runs / 1e3
             for e in profile_cuda(fn, runs)}
    if by_kernel is not None:
        by_kernel.update(times)
    return sum(times.values())


def cold_ms(fn, runs=20, flush_bytes=100 << 20):
    """Median milliseconds of one call of fn (CUDA events) with a cold L2:
    a buffer of flush_bytes (twice the H100's 50 MB L2) is written just
    before each timed call, so fn's inputs come from device memory."""
    import torch

    flush = torch.empty(flush_bytes // 4, dtype=torch.float32,
                        device="cuda")
    fn()
    times = []
    for _ in range(runs):
        flush.fill_(1.0)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def kernel_counts(fn):
    """Launches of each kernel name in one call of fn (profile_cuda)."""
    return {e.key: e.count for e in profile_cuda(fn)}


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def kernel_phase(dev, dtype, cfg, B):
    """Kernels 1, 2, 7 and 13 against their plain versions at cfg's widths.
    Kernel 2 runs in all three of its forms: attention + SCN (cfg's
    family, the serving path), attention + LSTM (pure_attention) and SCN
    without attention (pure_scn, fused_decode_step_noattn)."""
    import torch

    from indonesian_image_captioning_tpu_torch.models import (attention,
                                                              decoders)

    P, E, A, D = cfg.num_pixels, cfg.encoder_dim, cfg.attention_dim, \
        cfg.decoder_dim
    gen = torch.Generator().manual_seed(SEED + 1)

    params = decoders.init_decoder(gen, cfg, device=dev)
    enc = torch.relu(torch.randn((B, P, E), generator=gen)).to(
        dev, dtype).contiguous()
    ea = attention.precompute(params["attention"],
                              enc.float()).to(dtype).contiguous()
    h = torch.tanh(torch.randn((B * K, D), generator=gen)).to(dev, dtype)
    res = {}

    res["attend"] = attend_case(dev, dtype, cfg, params, enc, ea, h, K)

    # kernel 2, then kernels 7 and 13 on the same weights
    res["step"] = step_case(dev, dtype, cfg, params, enc, gen)
    for family in ("pure_attention", "pure_scn"):
        fcfg = dataclasses.replace(cfg, model_type=family)
        fparams = decoders.init_decoder(gen, fcfg, device=dev)
        res[f"step_{family}"] = step_case(dev, dtype, fcfg, fparams, enc,
                                          gen)
        if family == "pure_attention":
            res["span_pure_attention"] = span_case(dev, dtype, fcfg,
                                                   fparams, enc, gen)
    res["span"] = span_case(dev, dtype, cfg, params, enc, gen)
    res["mega"] = mega_case(dev, dtype, cfg, params, enc, gen)

    # kernels 5 and 6c (the int8 state) and 12 (the fused SCN cell)
    res["attend_q"] = attend_q_case(dev, dtype, cfg, params, enc, h)
    res["step_q"] = step_case(dev, dtype, cfg, params, enc, gen, quant=True)
    fcfg = dataclasses.replace(cfg, model_type="pure_attention")
    res["step_q_pure_attention"] = step_case(
        dev, dtype, fcfg, decoders.init_decoder(gen, fcfg, device=dev), enc,
        gen, quant=True)
    for family in ("attention_scn", "pure_scn"):
        res[f"scn_{family}"] = scn_case(
            dev, dtype, dataclasses.replace(cfg, model_type=family), B, gen)

    # beams wider than eight: kernels 1 and 5 sum more lane groups a
    # load, kernel 7's selection in rounds that look past the last winner
    for k in WIDE_K:
        hk = torch.tanh(torch.randn((B * k, D), generator=gen)).to(dev, dtype)
        res[f"attend_k{k}"] = attend_case(dev, dtype, cfg, params, enc, ea,
                                          hk, k)
        res[f"attend_q_k{k}"] = attend_q_case(dev, dtype, cfg, params, enc,
                                              hk, k)
        res[f"span_k{k}"] = span_case(dev, dtype, cfg, params, enc, gen, k)
    return res


def attend_case(dev, dtype, cfg, params, enc, ea, h, k):
    """Kernel 1 at k lanes against its plain version, and both times."""
    import torch

    from indonesian_image_captioning_tpu_torch.ops import attention_cuda

    name = str(dtype).replace("torch.", "")
    tol = TOL[name]
    nb, A = enc.shape[0], cfg.attention_dim
    dec = ((h.float() @ params["attention"]["decoder_att"]["w"]
            + params["attention"]["decoder_att"]["b"])
           .to(dtype).reshape(nb, k, A).contiguous())
    wf = params["attention"]["full_att"]["w"].reshape(-1).contiguous()
    n0 = attention_cuda.attend_fused.launches
    awe, alpha = attention_cuda.attend_fused(enc, ea, dec, wf)
    p_awe, p_alpha = attention_cuda.attend_plain(enc, ea, dec, wf)
    torch.cuda.synchronize()
    check(attention_cuda.attend_fused.launches == n0 + 1,
          f"attend K={k}: the kernel was not launched")
    err = max(max_err(awe, p_awe), max_err(alpha, p_alpha))
    check(err <= tol["attend"], f"attend K={k} {name}: error {err} > "
          f"{tol['attend']}")
    def kernel():
        return attention_cuda.attend_fused(enc, ea, dec, wf)

    plain_ms, ms = median_ms([
        lambda: attention_cuda.attend_plain(enc, ea, dec, wf), kernel])
    dev_ms, c_ms = device_ms(kernel), cold_ms(kernel)
    bound_ms, bound_by = bound(*attend_work(cfg, nb, dtype.itemsize, k),
                               name)
    print(f"kernel attend_fused[K={k}] {name}: max_abs_err {err:.3g} (awe "
          f"{max_err(awe, p_awe):.3g}, alpha {max_err(alpha, p_alpha):.3g}; "
          f"tol {tol['attend']}) ms {ms:.4f} device_ms {dev_ms:.4f} cold_ms "
          f"{c_ms:.4f} plain_ms {plain_ms:.4f} bound_ms {bound_ms:.4f} "
          f"({bound_by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, device_ms=dev_ms,
                cold_ms=c_ms)


def attend_q_case(dev, dtype, cfg, params, enc, h, k=K):
    """Kernel 5 at k lanes on the int8 state of enc and its projection,
    with and without alpha, against its plain version; both times (with
    alpha)."""
    import torch

    from indonesian_image_captioning_tpu_torch.models import attention
    from indonesian_image_captioning_tpu_torch.ops import attention_q_cuda

    name = str(dtype).replace("torch.", "")
    tol = TOL[name]["attend"]
    nb, A = enc.shape[0], cfg.attention_dim
    state = (attention_q_cuda.quantize_pixels(enc)
             + attention_q_cuda.quantize_pixels(
                 attention.precompute(params["attention"], enc.float())))
    dec = ((h.float() @ params["attention"]["decoder_att"]["w"]
            + params["attention"]["decoder_att"]["b"])
           .to(dtype).reshape(nb, k, A).contiguous())
    wf = params["attention"]["full_att"]["w"].reshape(-1).contiguous()
    args = state + (dec, wf)
    n0 = attention_q_cuda.attend_fused_q.launches
    awe, alpha = attention_q_cuda.attend_fused_q(*args)
    awe_n, none = attention_q_cuda.attend_fused_q(*args, with_alpha=False)
    p_awe, p_alpha = attention_q_cuda.attend_q_plain(*args)
    torch.cuda.synchronize()
    check(attention_q_cuda.attend_fused_q.launches == n0 + 2,
          "attend_fused_q: the kernel was not launched")
    check(none is None and torch.equal(awe, awe_n),
          f"attend_fused_q {name}: awe without alpha differs")
    err = max(max_err(awe, p_awe), max_err(alpha, p_alpha))
    check(err <= tol, f"attend_fused_q {name}: error {err} > {tol}")
    def kernel():
        return attention_q_cuda.attend_fused_q(*args)

    plain_ms, ms = median_ms([
        lambda: attention_q_cuda.attend_q_plain(*args), kernel])
    dev_ms, c_ms = device_ms(kernel), cold_ms(kernel)
    bound_ms, bound_by = bound(*attend_q_work(cfg, nb, dtype.itemsize, k),
                               name)
    print(f"kernel attend_fused_q[K={k}] {name}: max_abs_err {err:.3g} (awe "
          f"{max_err(awe, p_awe):.3g}, alpha {max_err(alpha, p_alpha):.3g}; "
          f"tol {tol}); without alpha equal; ms {ms:.4f} device_ms "
          f"{dev_ms:.4f} cold_ms {c_ms:.4f} plain_ms {plain_ms:.4f} "
          f"bound_ms {bound_ms:.4f} ({bound_by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, device_ms=dev_ms,
                cold_ms=c_ms)


def scn_case(dev, dtype, cfg, nb, gen):
    """Kernel 12 on the step engine's B*K rows of cfg's family (input
    [emb; gate*awe] for attention_scn, emb for pure_scn) against its plain
    version; both times."""
    import torch

    from indonesian_image_captioning_tpu_torch.models import (decoders,
                                                              scn_cell)
    from indonesian_image_captioning_tpu_torch.ops import scn_cuda

    name = str(dtype).replace("torch.", "")
    tol = TOL[name]["step_state"]
    cell = decoders.cast_params(
        decoders.init_decoder(gen, cfg, device=dev)["decode_step"], dtype)
    In, D = decoders.cell_input_dim(cfg), cfg.decoder_dim
    x = (torch.randn((nb, K, In), generator=gen) * 0.5).to(dev, dtype)
    h = torch.tanh(torch.randn((nb, K, D), generator=gen)).to(dev, dtype)
    c = (torch.randn((nb, K, D), generator=gen) * 0.5).to(dev, dtype)
    tags = torch.rand((nb, cfg.semantic_dim), generator=gen).to(dev, dtype)
    sx, sh = (s[:, None] for s in scn_cell.semantic_projections(cell, tags))
    rows = scn_cuda.to_rows(cell, x, sx, sh, h, c)[:5]
    n0 = scn_cuda.scn_step_fused.launches
    out = scn_cuda.scn_step_fused(cell, x, sx, sh, h, c)
    ref = scn_cuda.scn_step_fused_plain(cell, *rows)
    torch.cuda.synchronize()
    check(scn_cuda.scn_step_fused.launches == n0 + 1,
          "scn_step_fused: the kernel was not launched")
    err = max(max_err(a.reshape(-1, D), b) for a, b in zip(out, ref))
    label = f"{cfg.model_type} In={In} {name}"
    check(err <= tol, f"scn_step_fused {label}: h/c error {err} > {tol}")
    n_call = scn_cuda.last_launches()
    check(n_call == 2, f"scn_step_fused {label}: {n_call} launches a call, "
          "not 2")
    plain_ms, ms = median_ms([
        lambda: scn_cuda.scn_step_fused_plain(cell, *rows),
        lambda: scn_cuda.scn_step_fused(cell, x, sx, sh, h, c)])
    parts = {}
    dev_ms = device_ms(lambda: scn_cuda.scn_step_fused(cell, x, sx, sh, h,
                                                        c), by_kernel=parts)
    check(any("small_gemm_kernel" in k for k in parts)
          and not any(library_gemm(k) for k in parts),
          f"scn_step_fused {label}: not mma_small.cuh's kernel alone, or "
          f"gemm.cuh's FFMA GEMM ran: {list(parts)}")
    split = scn_split(parts)
    bound_ms, bound_by, ffma_ms = chain_bound(
        scn_work(cfg, nb * K, dtype.itemsize), name)
    print(f"kernel scn_step_fused[{label}]: {nb * K} rows; max_abs_err h/c "
          f"{err:.3g} (tol {tol}); ms {ms:.4f} device_ms {dev_ms:.4f} "
          f"plain_ms {plain_ms:.4f} bound_ms {bound_ms:.4f} ({bound_by}; "
          f"FFMA peak {ffma_ms:.4f}); {n_call} launches a call (library "
          "counter); device ms by stage: "
          + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, device_ms=dev_ms,
                split=split)


def scn_split(parts):
    """Device ms of one kernel-12 call by launch, from its kernels' names
    (the wide GEMM's epilogue, the second template argument): S1 (tx and
    th, kSmF32Mul = 10), S2 (the gates and the cell, 11 or 12) and the
    rest (PyTorch's flattening of the rows)."""
    split = {"S1 tx th": 0.0, "S2 gates cell": 0.0, "rest": 0.0}
    for k, v in parts.items():
        if "small_gemm_kernel" in k and ", 10, " in k:
            split["S1 tx th"] += v
        elif "small_gemm_kernel" in k:
            split["S2 gates cell"] += v
        else:
            split["rest"] += v
    return split


def fc_topk_case(dev, cfg, nb):
    """Kernel 11 (float32 only) on B*K decoder rows and the vocab head of
    cfg's width: raw-logit values and log-sums against its plain version
    within FC_TOL of their magnitude, ids equal but at near-ties; both
    times.  No single PyTorch call computes it (library_ms null)."""
    import torch

    from indonesian_image_captioning_tpu_torch.models import decoders
    from indonesian_image_captioning_tpu_torch.ops import fc_topk

    gen = torch.Generator().manual_seed(SEED + 10)
    fc = decoders.init_decoder(gen, cfg, device=dev)["fc"]
    fc["b"] = (torch.randn((cfg.vocab_size,), generator=gen) * 0.1).to(dev)
    h = torch.tanh(torch.randn((nb * K, cfg.decoder_dim),
                               generator=gen)).to(dev)
    args = (h, fc["w"], fc["b"], K)
    n0 = fc_topk.fc_topk.launches
    tv, ti, lse = fc_topk.fc_topk(*args)
    rv, ri, rl = fc_topk.fc_topk_plain(*args)
    torch.cuda.synchronize()
    check(fc_topk.fc_topk.launches == n0 + 1,
          "fc_topk: the kernel was not launched")
    err = max(max_err(tv, rv), max_err(lse, rl))
    scale = max(float(rv.abs().max()), float(rl.abs().max()), 1.0)
    check(err <= FC_TOL * scale, f"fc_topk: error {err} > {FC_TOL} x "
          f"{scale:.3g}")
    ties = near_tie_rows(ti, ri, h @ fc["w"] + fc["b"], "fc_topk")
    plain_ms, ms = median_ms([lambda: fc_topk.fc_topk_plain(*args),
                              lambda: fc_topk.fc_topk(*args)])
    parts = {}
    dev_ms = device_ms(lambda: fc_topk.fc_topk(*args), by_kernel=parts)
    bound_ms, bound_by, ffma_ms = chain_bound(
        fc_topk_work(nb * K, cfg.decoder_dim, cfg.vocab_size, K), "float32")
    # the K-major pack of w, made once per tensor: its host time cold
    fc_topk._packs.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fc_topk.fc_pack(fc["w"])
    torch.cuda.synchronize()
    pack_ms = (time.perf_counter() - t0) * 1e3
    print(f"kernel fc_topk float32 ({nb * K}, {cfg.decoder_dim}) x "
          f"({cfg.decoder_dim}, {cfg.vocab_size}) k={K} "
          f"{fc_topk.fc_plan(nb * K, cfg.vocab_size, K)}: max_abs_err "
          f"{err:.3g} "
          f"(tol {FC_TOL} x {scale:.3g}); topi equal but {ties} near-tie "
          f"rows; ms {ms:.4f} device_ms {dev_ms:.4f} plain_ms "
          f"{plain_ms:.4f} bound_ms {bound_ms:.4f} ({bound_by}, 3xTF32; "
          f"FFMA {ffma_ms:.4f}); w's pack {pack_ms:.3f} ms once; device ms "
          "by launch: " + "; ".join(f"{n[:50]} {v:.4f}"
                                    for n, v in parts.items()))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, device_ms=dev_ms,
                ffma_bound_ms=ffma_ms)


def gemm_case(dev, dtype, M, K_in, N, label):
    """The tensor-core GEMM (csrc/mma.cuh, step_cuda.gemm) on one product
    of the span chain (kernels 7 and 13), M rows x K_in -> N, split-K
    scratch as the chain gives it: against gemm.cuh's FFMA GEMM and a float64 product on
    the same inputs (each within GEMM_TOL of sum |a||w|), and the medians
    of both and of torch.matmul (the library yardstick)."""
    import torch

    from indonesian_image_captioning_tpu_torch.ops import _build, step_cuda

    name = str(dtype).replace("torch.", "")
    gen = torch.Generator().manual_seed(SEED + M + K_in + N)
    a = torch.randn((M, K_in), generator=gen).to(dev, dtype)
    w = (torch.randn((K_in, N), generator=gen) * K_in ** -0.5).to(dev, dtype)
    lib = _build.load("step")
    code = {torch.float32: 0, torch.bfloat16: 1}[dtype]
    part = torch.empty(step_cuda.split_k_floats(M, N), device=dev)
    out = {e: torch.empty((M, N), device=dev)
           for e in ("iic_gemm", "iic_gemm_ffma")}
    # the tensor-core GEMM on the weight as the chain packs it; the FFMA
    # GEMM on the weight (K, N)
    hi, lo = step_cuda.pack_tc(w, dtype)
    wkw = {"iic_gemm": dict(w1=hi, w1_lo=lo, wt=True),
           "iic_gemm_ffma": dict(w1=w)}

    def run(entry):
        stream = torch.cuda.current_stream().cuda_stream
        step_cuda.gemm(lib, code, stream, epi=step_cuda.EPI_PRE, M=M, N=N,
                       a1=a, c=out[entry], part=part, entry=entry,
                       **wkw[entry])

    n0 = step_cuda.gemm.launches
    run("iic_gemm")
    run("iic_gemm_ffma")
    torch.cuda.synchronize()
    check(step_cuda.gemm.launches == n0 + 1,
          f"gemm {label}: the kernel was not launched")
    ref = a.double() @ w.double()
    scale = a.double().abs() @ w.double().abs()
    errs = {e: float(((out[e].double() - ref).abs() / scale).max())
            for e in out}
    for e, x in errs.items():
        check(x <= GEMM_TOL, f"gemm {label} {name} ({e}): error {x:.3g} of "
              f"sum|a||w| > {GEMM_TOL}")
    err = float((out["iic_gemm"].double() - ref).abs().max())
    ffma_ms, ms, lib_ms = median_ms([lambda: run("iic_gemm_ffma"),
                                     lambda: run("iic_gemm"),
                                     lambda: a @ w])
    dev = {k: device_ms(f) for k, f in (
        ("tc", lambda: run("iic_gemm")),
        ("ffma", lambda: run("iic_gemm_ffma")), ("matmul", lambda: a @ w))}
    work = (dtype.itemsize * (M * K_in + K_in * N) + 4 * M * N,
            2 * M * N * K_in)
    bound_ms, bound_by, ffma_bound = chain_bound(work, name)
    print(f"kernel gemm_tc[{label} {name}, {M} x {K_in} -> {N}]: error vs "
          f"float64 {errs['iic_gemm']:.3g} of sum|a||w| (FFMA GEMM "
          f"{errs['iic_gemm_ffma']:.3g}; tol {GEMM_TOL}), max_abs_err "
          f"{err:.3g}; ms {ms:.4f} FFMA GEMM (plain_ms) {ffma_ms:.4f} "
          f"torch.matmul {lib_ms:.4f} bound_ms {bound_ms:.4f} ({bound_by}; "
          f"FFMA peak {ffma_bound:.4f}); device time (profiler) "
          f"{dev['tc']:.4f}, FFMA GEMM {dev['ffma']:.4f}, torch.matmul "
          f"{dev['matmul']:.4f}: {work[1] / dev['tc'] / 1e9:.1f} TFLOP/s")
    return dict(max_abs_err=err, ms=ms, plain_ms=ffma_ms, library_ms=lib_ms,
                work=work, device_ms=dev["tc"])


def wide_gemm_case(dev, dtype, M, K_in, N, label):
    """The fused step's GEMM (csrc/mma_small.cuh at its wide batch tile,
    step_cuda.wide_gemm) on one of the step's products, M rows x K_in -> N:
    against a float64 product (within GEMM_TOL of sum |x||w|), with its
    device time beside torch.matmul's."""
    import torch

    from indonesian_image_captioning_tpu_torch.ops import step_cuda

    name = str(dtype).replace("torch.", "")
    gen = torch.Generator().manual_seed(SEED + M + K_in + N + 1)
    x = torch.randn((M, K_in), generator=gen).to(dev, dtype)
    w = (torch.randn((N, K_in), generator=gen) * K_in ** -0.5).to(dev, dtype)
    n0 = step_cuda.wide_gemm.launches
    out = step_cuda.wide_gemm(x, w)
    torch.cuda.synchronize()
    check(step_cuda.wide_gemm.launches == n0 + 1,
          f"wide gemm {label}: the kernel was not launched")
    ref = x.double() @ w.double().t()
    e = float(((out.double() - ref).abs()
               / (x.double().abs() @ w.double().abs().t())).max())
    check(e <= GEMM_TOL, f"wide gemm {label} {name}: error {e:.3g} of "
          f"sum|x||w| > {GEMM_TOL}")
    wt = w.t()
    ms, lib_ms = median_ms([lambda: step_cuda.wide_gemm(x, w),
                            lambda: x @ wt])
    dev_ms = device_ms(lambda: step_cuda.wide_gemm(x, w))
    lib_dev = device_ms(lambda: x @ wt)
    work = (dtype.itemsize * (M * K_in + K_in * N) + 4 * M * N,
            2 * M * N * K_in)
    bound_ms, bound_by, _ = chain_bound(work, name)
    print(f"kernel wide_gemm[{label} {name}, {M} x {K_in} -> {N}]: error "
          f"vs float64 {e:.3g} of sum|x||w| (tol {GEMM_TOL}); ms {ms:.4f} "
          f"device_ms {dev_ms:.4f} torch.matmul {lib_ms:.4f} (device "
          f"{lib_dev:.4f}) bound_ms {bound_ms:.4f} ({bound_by}); "
          f"{work[0] / dev_ms / 1e6:.0f} GB/s of its bytes")


def gemm_phase(dev, cfg):
    """The tensor-core GEMM of the span chain at two of its products at R =
    B*K = 160 rows: the SCN input factor ([emb | gawe], In = 2,560 -> 4F =
    2,048) and the head (D = 512 -> V = 6,763), in float32 and bfloat16;
    and the fused step's wide GEMM at its products of h (512 -> 4,608),
    gawe (2,048 -> 2,048) and the head."""
    import torch

    R, In = B * K, cfg.embed_dim + cfg.encoder_dim
    A, E, F4 = cfg.attention_dim, cfg.encoder_dim, 4 * cfg.factored_dim
    res = {}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).replace("torch.", "")
        res[name, "xfac"] = gemm_case(dev, dt, R, In, 4 * cfg.factored_dim,
                                      "xfac")
        res[name, "head"] = gemm_case(dev, dt, R, cfg.decoder_dim, VOCAB,
                                      "head")
        for label, k_in, n in (("h", cfg.decoder_dim, A + E + F4),
                               ("xfac", E, F4),
                               ("head", cfg.decoder_dim, VOCAB)):
            wide_gemm_case(dev, dt, R, k_in, n, label)
    return res


def embed_grad_inputs(dev, dtype, B, T, V, E, gen_seed, dup=False):
    """Kernel 14's inputs as the trainer's embedding backward gives them:
    the ids of B seeded captions' first T tokens (padded with id 0) and a
    (B*T, E) cotangent, zero at the positions the loss masks out (t >=
    caplen - 1, the padding and the <end> input).  dup: every id 0 or 7."""
    import numpy as np
    import torch

    rng = np.random.default_rng(gen_seed)
    caps, lens = captions(rng, B, V, T + 1)
    ids = caps[:, :T].reshape(-1)
    if dup:
        ids = (np.arange(B * T) % 2 * 7).astype(np.int32)
    live = (np.arange(T)[None] < lens[:, None] - 1).reshape(-1, 1)
    g = rng.standard_normal((B * T, E)).astype(np.float32) * live
    return (torch.from_numpy(ids).to(dev),
            torch.from_numpy(g).to(dev, dtype).contiguous())


def embed_work(N, V, E, isz=4):
    """Bytes and operations of kernel 14: ids and g read once, the (V, E)
    float32 table written once; one add per g element."""
    return V * E * 4 + N * E * isz + N * 4, N * E


def embed_grad_check(ids, g, V, label):
    """Kernel 14 on (ids, g) against its plain version (index_add_ over
    the ids in [0, V), which adds with atomics on the card, so its order
    varies): launched twice, the two calls bitwise equal, every element
    within EMBED_TOL of its column's sum of |g|.  -> the largest absolute
    error."""
    import torch

    from indonesian_image_captioning_tpu_torch.ops import embed_grad_cuda

    n0 = embed_grad_cuda.embed_grad_scatter.launches
    out = embed_grad_cuda.embed_grad_scatter(ids, g, V)
    again = embed_grad_cuda.embed_grad_scatter(ids, g, V)
    ref = embed_grad_cuda.embed_grad_plain(ids, g, V)
    torch.cuda.synchronize()
    check(embed_grad_cuda.embed_grad_scatter.launches == n0 + 2,
          f"embed_grad {label}: the kernel was not launched")
    check(torch.equal(out, again), f"embed_grad {label}: two calls differ")
    tol = EMBED_TOL * g.float().abs().sum(0)[None]
    diff = (out - ref).abs()
    check(bool((diff <= tol).all()), f"embed_grad {label}: error "
          f"{float((diff - tol).max())} past {EMBED_TOL} x sum|g| of a "
          "column")
    return float(diff.max())


def embed_grad_case(dev, dtype, B, T, V, E, dup=False, label=""):
    """Kernel 14 against its plain version (:func:`embed_grad_check`);
    median times of the kernel, the plain version, one index_add_ call
    (the library yardstick) and the one-hot product of "onehot"."""
    import torch

    from indonesian_image_captioning_tpu_torch.ops import embed_grad_cuda

    name = str(dtype).replace("torch.", "")
    ids, g = embed_grad_inputs(dev, dtype, B, T, V, E, SEED + 10 + B, dup)
    N = ids.shape[0]
    err = embed_grad_check(ids, g, V, label)
    ids64, g32 = ids.long(), g.float()
    table = torch.zeros((V, E), device=dev)
    cols = torch.arange(V, device=dev)

    def onehot():
        oh = (ids64[:, None] == cols[None, :]).to(g.dtype)
        return oh.to(torch.float32).T @ g32

    plain_ms, ms, lib_ms, oh_ms = median_ms([
        lambda: embed_grad_cuda.embed_grad_plain(ids, g, V),
        lambda: embed_grad_cuda.embed_grad_scatter(ids, g, V),
        lambda: table.zero_().index_add_(0, ids64, g32),
        onehot])
    parts = {}
    dev_ms = device_ms(lambda: embed_grad_cuda.embed_grad_scatter(ids, g, V),
                       by_kernel=parts)
    dev_lib = device_ms(lambda: table.zero_().index_add_(0, ids64, g32))
    bound_ms, bound_by = bound(*embed_work(N, V, E, dtype.itemsize))
    print(f"kernel embed_grad_scatter[{label} {name}, N={N}, V={V}, E={E}]: "
          f"max abs err {err:.3g} (tol {EMBED_TOL} x column sum|g|), two "
          f"calls bitwise equal; ms {ms:.4f} plain_ms {plain_ms:.4f} "
          f"index_add_ {lib_ms:.4f} onehot {oh_ms:.4f} bound_ms "
          f"{bound_ms:.4f} ({bound_by}); device time (profiler) kernel "
          f"{dev_ms:.4f} (" + ", ".join(
              f"{k.split('(')[0].replace('void ', '')} {v:.4f}"
              for k, v in parts.items()) + f") index_add_ {dev_lib:.4f}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, onehot_ms=oh_ms, bound_ms=bound_ms,
                device_ms=dev_ms, library_device_ms=dev_lib)


def embed_grad_phase(dev, cfg):
    """Kernel 14 at the trainer's shape (B=32 captions x T=51, V=6,763,
    E=512) in float32 and bfloat16, at b1024 (N=52,224) in float32, and on
    duplicate-heavy ids (every id 0 or 7)."""
    import torch

    T, V, E = cfg.max_caption_len - 1, cfg.vocab_size, cfg.embed_dim
    return {"float32": embed_grad_case(dev, torch.float32, B, T, V, E,
                                       label="B=32"),
            "bfloat16": embed_grad_case(dev, torch.bfloat16, B, T, V, E,
                                        label="B=32"),
            "b1024": embed_grad_case(dev, torch.float32, 1024, T, V, E,
                                     label="b1024"),
            "dup": embed_grad_case(dev, torch.float32, B, T, V, E, dup=True,
                                   label="ids 0 or 7")}


def near_tie_rows(got, ref, logits, label):
    """Ids (R, k) against the reference's: each difference must pick two
    logits within NEAR_TIE; returns the number of rows with one."""
    diff = (got != ref).nonzero().tolist()
    for r, q in diff:
        a, b = int(got[r, q]), int(ref[r, q])
        gap = abs(float(logits[r, a] - logits[r, b]))
        check(gap <= NEAR_TIE, f"{label}: ids differ at row {r} rank {q}: "
              f"{a} vs {b}, logit gap {gap}")
    return len({r for r, _ in diff})


def match_records(out, ref, tol, label):
    """Records (words, parents, vals (B, T, K)) of a kernel against its
    plain version's, per image as REC_TOL says.  Returns (the images
    whose decode diverged at a near-tie, the largest vals error before,
    a summary of the divergences)."""
    words, parents, vals = out
    same = ((words == ref[0]).all(2) & (parents == ref[1]).all(2)).cpu()
    gap = (vals - ref[2]).abs().amax(2).cpu()
    diverged, worst, gaps, steps = [], 0.0, [], []
    for b in range(words.shape[0]):
        bad = (~same[b]).nonzero()
        upto = int(bad[0]) if len(bad) else words.shape[1]
        if upto < words.shape[1]:
            g = float(gap[b, upto])
            check(g <= tol["near"], f"{label}: image {b} step {upto}: picks "
                  f"differ with values {g} apart (near-tie limit "
                  f"{tol['near']})")
            diverged.append(b)
            gaps.append(g)
            steps.append(upto)
        if upto:
            worst = max(worst, float(gap[b, :upto].max()))
    check(worst <= tol["vals"], f"{label}: vals error {worst} > "
          f"{tol['vals']}")
    summary = (f"{len(diverged)} images diverged at near-ties" + (
        f" (from step {min(steps)}, median {sorted(steps)[len(steps) // 2]};"
        f" gaps up to {max(gaps):.3g})" if diverged else ""))
    return diverged, worst, summary


def span_case(dev, dtype, cfg, params, enc, gen, k=K):
    """Kernel 7 for cfg's family at k lanes: one S=4 call from a
    mid-decode state against its plain version -- records, then h, c, sc,
    pw and alive of the images whose decode did not diverge -- and both
    times."""
    K = k
    import torch

    from indonesian_image_captioning_tpu_torch.models import decoders
    from indonesian_image_captioning_tpu_torch.ops import span_cuda

    name = str(dtype).replace("torch.", "")
    tol = REC_TOL[name]
    label = f"fused_decode_span[{cfg.model_type}, K={K}] {name}"
    nb, V = enc.shape[0], cfg.vocab_size
    cell = "scn" if cfg.uses_tags else "lstm"
    p = decoders.cast_params(params, dtype)
    tags = torch.rand((nb, cfg.semantic_dim), generator=gen).to(dev, dtype)
    ins = span_cuda.decode_inputs(p, cfg, enc, tags, K)
    w = (ins["weights"], ins["emb_tab"], ins["enc"], ins["ea"], ins["semx"],
         ins["semh"])
    sc, pw, alive = span_cuda.initial_carry(nb, K, V - 2, dev)
    # the mid-decode state: two plain steps from <start>; then in every
    # fourth image the rank-0 lane retired (as on emitting <end>) and
    # every fourth image dead
    _, _, _, h, c, sc, pw, alive = span_cuda.fused_decode_span_plain(
        *w, ins["h"], ins["c"], sc, pw, alive, span=2, end_id=V - 1,
        cell=cell)
    img = torch.arange(nb, device=dev)
    dead = img % 4 == 3
    retired = (img % 4 == 1).repeat_interleave(K) & (
        torch.arange(nb * K, device=dev) % K == 0)
    alive = torch.where(dead[:, None], torch.zeros_like(alive),
                        alive - (img % 4 == 1).to(alive.dtype)[:, None])
    sc = torch.where((dead.repeat_interleave(K) | retired)[:, None],
                     torch.full_like(sc, NEG), sc)
    n_live = int((sc > NEG).sum())
    # the call's head leans toward <end>, so lanes retire within it
    w[0]["fcb"] = w[0]["fcb"].clone()
    w[0]["fcb"][V - 1] += END_BIAS
    args = w + (h, c, sc, pw, alive)

    def kernel():
        return span_cuda.fused_decode_span(*args, span=SPAN, end_id=V - 1,
                                           cell=cell)

    def plain():
        return span_cuda.fused_decode_span_plain(*args, span=SPAN,
                                                 end_id=V - 1, cell=cell)

    n0 = span_cuda.fused_decode_span.launches
    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    check(span_cuda.fused_decode_span.launches == n0 + 1,
          f"{label}: the kernel was not launched")
    diverged, e_vals, summary = match_records(out[:3], ref[:3], tol, label)
    keep = [b for b in range(nb) if b not in diverged]
    rows = torch.tensor([b * K + k for b in keep for k in range(K)],
                        device=dev)
    e_state = max(max_err(out[i][rows], ref[i][rows]) for i in (3, 4))
    e_sc = max_err(out[5][rows], ref[5][rows])
    check(e_state <= tol["state"], f"{label}: h/c error {e_state}")
    check(e_sc <= tol["vals"], f"{label}: score error {e_sc}")
    check(torch.equal(out[6][rows], ref[6][rows])
          and torch.equal(out[7][keep], ref[7][keep]),
          f"{label}: previous words or alive counts differ")
    plain_ms, ms = median_ms([plain, kernel])
    parts = {}
    dev_ms = device_ms(kernel, runs=5, by_kernel=parts)
    att_ms = sum(v for n, v in parts.items() if "attend" in n)
    bound_ms, bound_by, ffma_ms = chain_bound(
        record_work(cfg, nb, SPAN, dtype.itemsize, k), name)
    print(f"kernel {label}: state {n_live} live lanes of {nb * K}, "
          f"{int(dead.sum())} dead images, {int(ref[7].sum())} live lanes "
          f"after; max_abs_err vals {max(e_vals, e_sc):.3g} (tol "
          f"{tol['vals']}), h/c {e_state:.3g} (tol {tol['state']}); "
          f"{summary}; ms {ms:.4f} plain_ms {plain_ms:.4f} bound_ms "
          f"{bound_ms:.4f} ({bound_by}; FFMA peak {ffma_ms:.4f}); device "
          f"time (profiler) {dev_ms:.4f}, of it the attention {att_ms:.4f}")
    return dict(max_abs_err=max(e_vals, e_sc, e_state), ms=ms,
                plain_ms=plain_ms, device_ms=dev_ms, attention_ms=att_ms)


def mega_case(dev, dtype, cfg, params, enc, gen):
    """Kernel 13: one 51-step decode from <start> against its plain
    version's records, and both times (10 runs each); its launches a step
    (csrc/step.cu's counter), one graph launch a decode and no capture
    after the first, no launch of csrc/mma.cuh's GEMM, the host time of
    the graph's capture, of copying a decode's inputs into its workspace
    and of the other way to feed it (every kernel node's parameters set
    again), and the device time by stage."""
    import torch

    from indonesian_image_captioning_tpu_torch.models import decoders
    from indonesian_image_captioning_tpu_torch.ops import (decode_cuda,
                                                           span_cuda)

    name = str(dtype).replace("torch.", "")
    label = f"beam_decode_records {name}"
    nb, V = enc.shape[0], cfg.vocab_size
    T = cfg.max_caption_len - 1
    p = decoders.cast_params(params, dtype)
    tags = torch.rand((nb, cfg.semantic_dim), generator=gen).to(dev, dtype)
    kw = dict(beam_size=K, start_id=V - 2, end_id=V - 1, max_steps=T)
    keys = ("words", "parents", "vals")

    def kernel():
        return decode_cuda.beam_decode_records(p, cfg, enc, tags, **kw)

    def plain():
        return decode_cuda.beam_decode_records_plain(p, cfg, enc, tags, **kw)

    n0 = decode_cuda.beam_decode_records.launches
    g0 = decode_cuda.graph_counts()
    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    check(decode_cuda.beam_decode_records.launches == n0 + 1,
          f"{label}: the kernel was not launched")
    _, err, summary = match_records([out[k] for k in keys],
                                    [ref[k] for k in keys], REC_TOL[name],
                                    label)
    graph = decode_cuda.beam_decode_records.last_graph
    n_step = decode_cuda.step_launches()
    check(n_step == 7, f"{label}: {n_step} launches a step, not 7")
    # the next decodes replay the graph: one launch each, no capture
    g1 = decode_cuda.graph_counts()
    for _ in range(3):
        kernel()
    torch.cuda.synchronize()
    g2 = decode_cuda.graph_counts()
    check(g2["graph_launches"] - g1["graph_launches"] == 3
          and g2["captures"] == g1["captures"],
          f"{label}: three decodes made {g2} after {g1}, not three graph "
          "launches and no capture")
    ran = int((ref["vals"] > NEG).any(2).any(0).sum())   # steps that ran
    plain_ms, ms = median_ms([plain, kernel], runs=10)
    # a decode's inputs: made and written into the workspace (what each
    # call does), and the copies alone
    ins = {k: v for k, v in span_cuda.decode_state(p, cfg, enc, tags,
                                                   K).items()
           if v is not None}
    stage_ms, copy_ms = median_ms([
        lambda: graph.stage(p, cfg, enc, tags),
        lambda: [graph.ws[k].copy_(v) for k, v in ins.items()]])
    try:
        nodes, update_ms = graph.update_probe()
    except RuntimeError as e:      # a measurement of the path not taken
        print(f"{label}: node update probe not measured ({e})")
        nodes, update_ms = 0, float("nan")
    parts = {}
    dev_ms = device_ms(kernel, runs=3, by_kernel=parts)
    check(any("small_gemm_kernel" in k for k in parts)
          and not any(library_gemm(k) for k in parts),
          f"{label}: the wide tile did not run, or csrc/mma.cuh's or "
          f"gemm.cuh's GEMM ran in the decode: {list(parts)}")
    split = mega_split(parts)
    bound_ms, bound_by, ffma_ms = chain_bound(
        record_work(cfg, nb, ran, dtype.itemsize), name)
    per_node = update_ms / max(nodes, 1)
    print(f"kernel {label}: {ran} steps ran; max_abs_err vals {err:.3g} "
          f"(tol {REC_TOL[name]['vals']}); {summary}; ms {ms:.4f} device_ms "
          f"{dev_ms:.4f} plain_ms {plain_ms:.4f} bound_ms {bound_ms:.4f} "
          f"({bound_by}; FFMA peak {ffma_ms:.4f}); {n_step} launches a step "
          f"(library counter), one graph launch a decode (captures "
          f"{g1['captures'] - g0['captures']} on the first call, 0 on the "
          f"next 3); graph capture {graph.capture_ms:.3f} ms host (with "
          f"packs and workspace {graph.setup_ms:.3f}); inputs made and "
          f"written into the workspace {stage_ms:.4f} ms (events), the "
          f"copies alone {copy_ms:.4f}; node update probe: "
          f"{nodes} kernel nodes set in {update_ms:.3f} ms host, "
          f"{per_node * 1e3:.2f} us a node, {4 * T * per_node:.3f} ms for "
          f"the {4 * T} nodes that read a decode's inputs; device ms by "
          "stage: " + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, steps=ran,
                device_ms=dev_ms, launches_per_step=n_step, split=split,
                capture_ms=graph.capture_ms, stage_ms=stage_ms,
                copy_ms=copy_ms, update_ms=update_ms)


def library_gemm(name):
    """Whether a kernel name is one of the GEMMs kernels 12 and 13 left:
    csrc/mma.cuh's tensor-core GEMM or gemm.cuh's FFMA GEMM and its
    split-K reduce (not mma_small.cuh's small_gemm_kernel)."""
    return any(f"iic::{n}" in name for n in (
        "gemm_tc_kernel", "gemm_kernel<", "gemm_reduce_kernel"))


def mega_split(parts):
    """Device ms of kernel 13's decode by stage, from its kernels' names:
    the products (the wide GEMM), the attention, the head, the selection,
    and the rest (the graph's start, the input copies, the records'
    copy)."""
    split = {"gemm": 0.0, "attention": 0.0, "head": 0.0, "select": 0.0,
             "rest": 0.0}
    for k, v in parts.items():
        if "small_gemm_kernel" in k:
            split["gemm"] += v
        elif "attend" in k:
            split["attention"] += v
        elif "head_topk" in k:
            split["head"] += v
        elif "select_kernel" in k:
            split["select"] += v
        else:
            split["rest"] += v
    return split


def host_us(fns, n=200):
    """Microseconds of host time per call of each of fns, enqueued n times
    without a synchronise (the wrapper's own cost, not the card's)."""
    import torch

    out = []
    for fn in fns:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        out.append((time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    return out


def topk_tables(dev, nb):
    """Kernel 10's tables: the dense head's (B, K*V) float32 candidate
    table (every other row one live lane, as at the first step) and the
    sparse head's (B*K, V) log-probabilities."""
    import torch

    gen = torch.Generator().manual_seed(SEED + 9)
    logp = torch.log_softmax(torch.randn((nb, K, VOCAB), generator=gen) * 2,
                             dim=-1)
    scores = -torch.rand((nb, K, 1), generator=gen) * 10
    scores[::2, 1:] = NEG
    cand = torch.clamp_min(scores + logp, NEG)
    cand = torch.where(scores <= NEG, torch.full_like(cand, NEG), cand)
    return (cand.reshape(nb, K * VOCAB).to(dev).contiguous(),
            logp.reshape(nb * K, VOCAB).to(dev).contiguous())


def topk_case(dev, nb):
    """Kernel 10 on the dense head's (B, K*V) candidate table at k = K and
    k = 69 (three passes), and on the sparse head's (B*K, V) table at k =
    K, float32 (the dense table in bf16 too): bitwise row_topk_iterative
    at each; torch.topk's values equal.  Events and device ms of the
    kernel, the plain version and torch.topk; the wrapper's host time by
    part.  Returns the dense table's k = K row for the kernels line."""
    import ctypes

    import torch

    from indonesian_image_captioning_tpu_torch.ops import _build, topk

    dense, sparse = topk_tables(dev, nb)
    out = None
    for label, x, k in (("dense", dense, K), ("dense", dense, 69),
                        ("sparse", sparse, K),
                        ("dense bf16", dense.bfloat16(), K)):
        R, V = x.shape
        n0 = topk.row_topk_pallas.launches
        vals, idx = topk.row_topk_pallas(x, k)
        ref_v, ref_i = topk.row_topk_iterative(x, k)
        lib_v, _ = torch.topk(x, k, dim=1)
        torch.cuda.synchronize()
        check(topk.row_topk_pallas.launches == n0 + 1,
              "row_topk_pallas: the kernel was not launched")
        check(torch.equal(idx.long(), ref_i) and torch.equal(vals, ref_v),
              f"row_topk_pallas ({R}, {V}) k={k} differs from "
              "row_topk_iterative")
        check(torch.equal(lib_v, ref_v), "torch.topk's values differ")
        plain_ms, ms, lib_ms = median_ms([
            lambda: topk.row_topk_iterative(x, k),
            lambda: topk.row_topk_pallas(x, k),
            lambda: torch.topk(x, k, dim=1)])
        dev_ms = device_ms(lambda: topk.row_topk_pallas(x, k))
        lib_dev_ms = device_ms(lambda: torch.topk(x, k, dim=1))
        work = topk_work(R, V, k, x.element_size())
        bound_ms, bound_by = bound(*work)
        plan = topk.topk_plan(R, V, k, x.element_size())
        print(f"kernel row_topk_pallas {label} ({R}, {V}) k={k} {plan}: "
              f"equal to row_topk_iterative bitwise; ms {ms:.4f} device_ms "
              f"{dev_ms:.4f} launches {len(topk.topk_passes(k, plan.kk))} "
              f"plain_ms {plain_ms:.4f} library_ms (torch.topk) "
              f"{lib_ms:.4f} library_device_ms {lib_dev_ms:.4f} bound_ms "
              f"{bound_ms:.4f} ({bound_by})")
        if out is None:
            out = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                       library_ms=lib_ms, device_ms=dev_ms,
                       library_device_ms=lib_dev_ms)
    # the wrapper's host time at the dense table, k = K, by part
    x, k = dense, K
    R, V = x.shape
    lib = _build.load("topk")
    plan = topk.topk_plan(R, V, k, 4)
    v0 = torch.empty((R, k), device=dev)
    i0 = torch.empty((R, k), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    parts = dict(zip(("wrapper", "outputs", "plan", "current_stream",
                      "raw stream", "load", "C call and launch"), host_us([
        lambda: topk.row_topk_pallas(x, k),
        lambda: (torch.empty((R, k), device=dev),
                 torch.empty((R, k), dtype=torch.int32, device=dev)),
        lambda: topk.topk_plan(R, V, k, x.element_size()),
        lambda: torch.cuda.current_stream(x.device).cuda_stream,
        lambda: topk._raw_stream(x.device),
        lambda: _build.load("topk"),
        lambda: lib.iic_row_topk(0, x.data_ptr(), R, V, k, v0.data_ptr(),
                                 i0.data_ptr(), ctypes.byref(plan),
                                 stream)])))
    print("kernel row_topk_pallas host us a call by part: " + ", ".join(
        f"{n} {v:.2f}" for n, v in parts.items()))
    out["host_us"] = parts["wrapper"]
    return out


def step_case(dev, dtype, cfg, params, enc, gen, quant=False):
    """Kernel 2 for cfg's family (6b for pure_scn; 6c with quant, on the
    int8 state) against its plain version: errors, topi at float32
    outside near-ties, and both times."""
    import torch

    from indonesian_image_captioning_tpu_torch.models import (attention,
                                                              scn_cell)
    from indonesian_image_captioning_tpu_torch.ops import (attention_q_cuda,
                                                           step_cuda)

    name = str(dtype).replace("torch.", "")
    tol = TOL[name]
    nb = enc.shape[0]
    R, V, D = nb * K, cfg.vocab_size, cfg.decoder_dim
    h = torch.tanh(torch.randn((R, D), generator=gen)).to(
        dev, dtype).contiguous()
    c = (torch.randn((R, D), generator=gen) * 0.5).to(dev, dtype).contiguous()
    weights = step_cuda.pack_step_weights(params, cfg, dtype)
    words = torch.randint(0, V, (R,), generator=gen).to(dev)
    emb = params["embedding"][words].to(dtype).contiguous()
    semx = semh = None
    cell = "scn" if cfg.uses_tags else "lstm"
    if cell == "scn":
        tags = torch.rand((nb, cfg.semantic_dim), generator=gen).to(dev)
        sx, sh = scn_cell.semantic_projections(params["decode_step"], tags)
        semx, semh = (s.reshape(nb, -1).repeat_interleave(K, 0).to(dtype)
                      .contiguous() for s in (sx, sh))
    scales = None
    if quant:
        ea = attention.precompute(params["attention"], enc.float())
        enc_q, enc_s = attention_q_cuda.quantize_pixels(enc)
        ea_q, ea_s = attention_q_cuda.quantize_pixels(ea)
        args = (weights, enc_q, ea_q, emb, h, c, semx, semh)
        scales = (enc_s, ea_s)
        counted = step_cuda.fused_decode_step_q

        def kernel():
            return step_cuda.fused_decode_step_q(
                weights, enc_q, enc_s, ea_q, ea_s, emb, h, c, semx, semh,
                cell=cell)
    elif cfg.uses_attention:
        ea = attention.precompute(params["attention"],
                                  enc.float()).to(dtype).contiguous()
        args = (weights, enc, ea, emb, h, c, semx, semh)
        counted = step_cuda.fused_decode_step

        def kernel():
            return step_cuda.fused_decode_step(*args, cell=cell)
    else:
        args = (weights, None, None, emb, h, c, semx, semh)
        counted = step_cuda.fused_decode_step_noattn

        def kernel():
            return step_cuda.fused_decode_step_noattn(
                weights, emb, h, c, semx, semh, beam_k=K)

    def plain():
        return step_cuda.fused_decode_step_plain(*args, cell=cell, topk=K,
                                                 scales=scales)

    label = f"{cfg.model_type}{' int8' if quant else ''} {name}"
    n0 = counted.launches
    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    check(counted.launches == n0 + 1,
          f"fused step {cfg.model_type}: the kernel was not launched")
    e_vals = max(max_err(out[0], ref[0]), max_err(out[2], ref[2]))
    e_state = max(max_err(out[3], ref[3]), max_err(out[4], ref[4]))
    check(e_vals <= tol["step_vals"],
          f"fused step {label}: topv/lse error {e_vals}")
    check(e_state <= tol["step_state"],
          f"fused step {label}: h/c error {e_state}")
    ties = ""
    if dtype == torch.float32:
        # topi must equal the plain version's outside near-ties
        lg = (ref[3] @ weights["fcw"] + weights["fcb"]).float()
        n = near_tie_rows(out[1], ref[1], lg, f"fused step {label}")
        ties = f", topi equal but {n} near-tie rows"
    # launches a step from csrc/step.cu's counter: 6 SCN with attention,
    # 5 the LSTM, 4 pure_scn (6b)
    want = 4 if not cfg.uses_attention else (
        6 if cell == "scn" else 5)
    n_step = step_cuda.last_launches()
    check(n_step == want, f"fused step {label}: {n_step} launches a step, "
          f"not {want}")
    plain_ms, ms = median_ms([plain, kernel])
    parts = {}
    dev_ms = device_ms(kernel, runs=5, by_kernel=parts)
    split = step_split(parts)
    bound_ms, bound_by, ffma_ms = chain_bound(
        step_work(cfg, nb, dtype.itemsize, quant), name)
    print(f"kernel {counted.__name__}[{cfg.model_type}] {name}: max_abs_err "
          f"topv/lse {e_vals:.3g} (tol {tol['step_vals']}), h/c "
          f"{e_state:.3g} (tol {tol['step_state']}){ties}; ms {ms:.4f} "
          f"device_ms {dev_ms:.4f} plain_ms {plain_ms:.4f} bound_ms "
          f"{bound_ms:.4f} ({bound_by}; FFMA peak {ffma_ms:.4f}); "
          f"{n_step} launches a step (library counter); device ms by "
          "stage: " + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
    return dict(max_abs_err=max(e_vals, e_state), ms=ms, plain_ms=plain_ms,
                device_ms=dev_ms, launches_per_step=n_step, split=split)


def step_split(parts):
    """Device ms of one fused step by stage, from its kernels' names: the
    products (the wide GEMM of csrc/mma_small.cuh), the attention (kernel
    1 or 5), the head and the rest."""
    split = {"gemm": 0.0, "attention": 0.0, "head": 0.0, "rest": 0.0}
    for k, v in parts.items():
        if "small_gemm_kernel" in k:
            split["gemm"] += v
        elif "attend" in k:
            split["attention"] += v
        elif "head_topk" in k:
            split["head"] += v
        else:
            split["rest"] += v
    return split


def make_state(dev, cfg, images_u8):
    """Seeded random weights; BatchNorm statistics calibrated on one
    batch (random-init eval-mode ResNet-152 features are about 1e10)."""
    import torch

    from indonesian_image_captioning_tpu_torch.core.config import TaggerConfig
    from indonesian_image_captioning_tpu_torch.models import (decoders,
                                                              encoders)

    gen = torch.Generator().manual_seed(SEED)
    state = {"params": decoders.init_decoder(gen, cfg, device=dev)}
    state["encoder"], enc_s = encoders.init_encoder_caption(
        gen, cfg.encoder_arch, device=dev)
    state["tagger"], tag_s = encoders.init_encoder_tagger(
        gen, TaggerConfig(semantic_size=cfg.semantic_dim), cfg.encoder_arch,
        device=dev)
    x = encoders.prep_images(torch.from_numpy(images_u8).to(dev))
    _, state["encoder_stats"] = encoders.apply_encoder_caption(
        state["encoder"], enc_s, x, train="calibrate",
        enc_image_size=cfg.enc_image_size, arch=cfg.encoder_arch)
    _, state["tagger_stats"] = encoders.apply_encoder_tagger(
        state["tagger"], tag_s, x, train="calibrate", arch=cfg.encoder_arch)
    return state


def prefix_scores(params, cfg, enc1, tags1, seqs, upto):
    """Summed log-probabilities of seqs[:, 1..upto] for one image (the
    plain step engine, dense head)."""
    import torch

    from indonesian_image_captioning_tpu_torch.models import decoders

    c2 = dataclasses.replace(cfg, sparse_head=False, attention_impl="xla")
    init_state, step_fn = decoders.make_beam_step(params, c2, enc1, tags1)
    n = seqs.shape[0]
    state = init_state(n)
    total = torch.zeros(n, device=seqs.device)
    lanes = torch.arange(n, device=seqs.device)
    for pos in range(1, upto + 1):
        logp, state, _ = step_fn(state, seqs[None, :, pos - 1].long())
        total += logp[0, lanes, seqs[:, pos].long()].float()
    return total


def word_map(V):
    """A word map of V ids in the reference's layout: <pad> 0, the words,
    then <unk>, <start>, <end>."""
    return {"<pad>": 0, **{f"w{i}": i for i in range(1, V - 3)},
            "<unk>": V - 3, "<start>": V - 2, "<end>": V - 1}


def captions(rng, n, V, L, lens=None):
    """n seeded captions of the reference's shape: (n, L) ids <start>,
    words, <end>, then <pad>, with caption lengths (<start> and <end>
    included) uniform in [3, L] (or the n given lens) and the words drawn
    Zipf-like (p ~ 1 / rank over the V - 4 word ids), as a corpus's are.
    Returns (caps, caplens)."""
    import numpy as np

    lens = rng.integers(3, L + 1, n) if lens is None else np.asarray(lens)
    p = 1.0 / np.arange(1, V - 3)
    words = rng.choice(np.arange(1, V - 3), size=(n, L), p=p / p.sum())
    pos = np.arange(L)[None]
    caps = np.where((pos >= 1) & (pos < lens[:, None] - 1), words, 0)
    caps[:, 0] = V - 2
    caps[np.arange(n), lens - 1] = V - 1
    return caps.astype(np.int32), lens.astype(np.int32)


RUNGS = {  # decode rung -> the kernel whose counter it moves
    "steps": "attend_fused", "fused_step": "fused_decode_step",
    "fused_span": "fused_decode_span", "fused": "beam_decode_records"}


def counters():
    """The launch counter of each kernel's wrapper, by name."""
    from indonesian_image_captioning_tpu_torch.ops import (attention_cuda,
                                                           attention_q_cuda,
                                                           decode_cuda,
                                                           embed_grad_cuda,
                                                           fc_topk, scn_cuda,
                                                           span_cuda,
                                                           step_cuda, topk,
                                                           train_cuda)

    return {"attend_fused": attention_cuda.attend_fused,
            "fused_decode_step": step_cuda.fused_decode_step,
            "fused_decode_step_noattn": step_cuda.fused_decode_step_noattn,
            "fused_decode_span": span_cuda.fused_decode_span,
            "beam_decode_records": decode_cuda.beam_decode_records,
            "row_topk_pallas": topk.row_topk_pallas,
            "attend_fused_q": attention_q_cuda.attend_fused_q,
            "fused_decode_step_q": step_cuda.fused_decode_step_q,
            "scn_step_fused": scn_cuda.scn_step_fused,
            "fc_topk": fc_topk.fc_topk,
            "train_fwd": train_cuda.train_fwd,
            "train_bwd": train_cuda.train_bwd,
            "embed_grad_scatter": embed_grad_cuda.embed_grad_scatter,
            "gemm_tc": step_cuda.gemm}


def zero_counters():
    for fn in counters().values():
        fn.launches = 0


def read_counters():
    return {name: fn.launches for name, fn in counters().items()}


def serve_and_inference(dev, cfg, B, image_size):
    """The serving main path, then the inference rungs on its encodings.
    Returns each decode kernel's launches on the path that runs it."""
    import numpy as np
    import torch

    from indonesian_image_captioning_tpu_torch.decode.api import \
        caption_beam_search
    from indonesian_image_captioning_tpu_torch.models import encoders
    from indonesian_image_captioning_tpu_torch.ops import step_cuda
    from indonesian_image_captioning_tpu_torch.serve import (CaptionEngine,
                                                             ServeConfig)

    V = cfg.vocab_size
    rng = np.random.default_rng(SEED)
    images = rng.integers(0, 256, size=(B, 3, image_size, image_size),
                          dtype=np.uint8)
    t0 = time.perf_counter()
    state = make_state(dev, cfg, images)
    torch.cuda.synchronize()
    print(f"serve: weights and BatchNorm calibration "
          f"{time.perf_counter() - t0:.1f} s")
    wm = word_map(V)
    buckets = tuple(sorted({1, 8, B}))
    engine = CaptionEngine(state, cfg, wm,
                           ServeConfig(batch_buckets=buckets,
                                       max_wait_ms=50.0), device=dev)
    t0 = time.perf_counter()
    engine.warmup(image_size)
    print(f"serve: warmup of buckets {buckets} "
          f"{time.perf_counter() - t0:.1f} s")
    pack_times(engine.state["params"], cfg)

    # ---- the main path: counters zeroed just before, read just after ----
    zero_counters()
    t0 = time.perf_counter()
    caps = engine.caption_batch(images)
    t_batch = time.perf_counter() - t0
    n_async = 12
    engine.start()
    try:
        t0 = time.perf_counter()
        futs = [engine.submit(images[i]) for i in range(n_async)]
        got = [f.result(timeout=600) for f in futs]
        t_async = time.perf_counter() - t0
    finally:
        engine.stop()
    launches = read_counters()
    # ---------------------------------------------------------------------
    calls = engine.stats.decode_calls
    n_span = -(-engine.beam_cfg.max_steps // cfg.decode_span)
    check(len(caps) == B and all(isinstance(s, str) for s in caps),
          f"caption_batch did not return {B} strings")
    check(len(got) == n_async and all(isinstance(s, str) for s in got),
          "a future gave no string")
    check(set(engine.stats.decode_impls) == {"fused_span"},
          f"decode resolved to {engine.stats.decode_impls}")
    check(launches["fused_decode_span"] == sum(calls) > 0
          and all(1 <= n <= n_span for n in calls),
          f"kernel 7 ran {launches['fused_decode_span']} times over decode "
          f"calls {calls} (1 to {n_span} per batch)")
    check(launches["fused_decode_step"] == 0 and launches["attend_fused"]
          == 0, f"the span rung launched other decode kernels: {launches}")
    check(launches["gemm_tc"] > 0, "kernel 7's chain ran no tensor-core GEMM")
    # rows may round differently at another batch size (cuDNN and cuBLAS
    # pick kernels by shape), so equal captions are counted, not required
    n_same = sum(a == b for a, b in zip(got, caps))
    print(f"serve: caption_batch({B}) {t_batch:.3f} s; {n_async} async "
          f"requests in batches {engine.stats.batches[1:]} {t_async:.3f} s, "
          f"{n_same} captions equal to the batch's; "
          f"decode {engine.stats.decode_impls[0]}, kernel 7 calls per "
          f"batch {calls}; kernel launches {launches}")
    print(f"serve: caption[0] = {caps[0][:80]!r}")
    found = {"fused_decode_span": launches["fused_decode_span"],
             "gemm_tc": launches["gemm_tc"]}

    # ---- the int8 encoder state: a second engine on the same weights and
    # BatchNorm statistics; counters zeroed just before, read just after --
    qcfg = dataclasses.replace(cfg, enc_quant="int8")
    qengine = CaptionEngine(engine.state, qcfg, wm,
                            ServeConfig(batch_buckets=(B,)), device=dev)
    zero_counters()
    t0 = time.perf_counter()
    qcaps = qengine.caption_batch(images)
    t_qbatch = time.perf_counter() - t0
    qlaunches = read_counters()
    # ---------------------------------------------------------------------
    qcalls = qengine.stats.decode_calls
    check(len(qcaps) == B and all(isinstance(s, str) for s in qcaps),
          f"the int8 caption_batch did not return {B} strings")
    check(qengine.stats.decode_impls == ["fused_step"],
          f"int8 decode resolved to {qengine.stats.decode_impls}")
    check(qlaunches["fused_decode_step_q"] == sum(qcalls) > 0
          and qlaunches["fused_decode_step"] == 0
          and qlaunches["attend_fused"] == 0,
          f"the int8 batch ran kernel 6c {qlaunches['fused_decode_step_q']} "
          f"times in {qcalls} decode calls; launches {qlaunches}")
    found["fused_decode_step_q"] = qlaunches["fused_decode_step_q"]
    # the int8 step's chain: kernel 5 inside it, its products on the wide
    # GEMM of csrc/mma_small.cuh (none on mma.cuh), 6 launches a step
    check(qlaunches["attend_fused_q"] == qlaunches["fused_decode_step_q"]
          and qlaunches["gemm_tc"] == 0 and step_cuda.last_launches() == 6,
          f"the int8 batch's chain: launches {qlaunches}, "
          f"{step_cuda.last_launches()} launches a step (6 expected)")
    print(f"serve: int8 caption_batch({B}) {t_qbatch:.3f} s; decode "
          f"{qengine.stats.decode_impls[0]}, {qcalls[0]} kernel 6c calls; "
          f"{sum(a == b for a, b in zip(qcaps, caps))} captions equal to "
          f"the float32 batch's; kernel launches "
          f"{ {k: v for k, v in qlaunches.items() if v} }")

    # ---- inference: each rung on the same encodings, float32 ----
    with torch.inference_mode():
        x = encoders.prep_images(torch.from_numpy(images).to(dev))
        tags = encoders.apply_encoder_tagger(
            engine.state["tagger"], engine.state["tagger_stats"], x,
            arch=cfg.encoder_arch)[0]
        enc = encoders.apply_encoder_caption(
            engine.state["encoder"], engine.state["encoder_stats"], x,
            enc_image_size=cfg.enc_image_size, arch=cfg.encoder_arch)[0]
        S = cfg.enc_image_size
        check(enc.shape == (B, S, S, cfg.encoder_dim)
              and bool(enc.isfinite().all()),
              f"encodings {tuple(enc.shape)} not finite or misshapen")
        check(bool(((tags >= 0) & (tags <= 1)).all()), "tags outside [0, 1]")
        kw = dict(start_id=wm["<start>"], end_id=wm["<end>"])
        params = engine.state["params"]
        outs = {}
        for impl, kernel in RUNGS.items():
            zero_counters()
            out = caption_beam_search(
                params, dataclasses.replace(cfg, decode_impl=impl), enc,
                tags, record_alphas=impl == "steps", **kw)
            ran = read_counters()
            want = out["decode_calls"]
            check(out["decode_impl"] == impl and ran[kernel] == want > 0,
                  f"rung {impl}: {kernel} ran {ran[kernel]} times in "
                  f"{want} calls")
            found.setdefault(kernel, ran[kernel])
            outs[impl] = out
        steps_out = outs["steps"]
        lens = steps_out["lengths"]
        pos = torch.arange(steps_out["alpha"].shape[1], device=dev)
        valid = (pos[None, :] >= 1) & (pos[None, :] < lens[:, None])
        sums = steps_out["alpha"].sum(-1)
        a_err = float((sums - 1).abs()[valid].max())
        check(a_err < 1e-3, f"alphas sum to 1 within {a_err}")
        zero_counters()
        outs["steps+pallas top-k"] = caption_beam_search(
            params, dataclasses.replace(cfg, decode_impl="steps",
                                        sparse_head=False,
                                        topk_backend="pallas"),
            enc, tags, **kw)
        ran = read_counters()["row_topk_pallas"]
        check(ran == outs["steps+pallas top-k"]["steps"] > 0,
              f"the dense head ran kernel 10 {ran} times")
        found["row_topk_pallas"] = ran
        for impl, out in outs.items():
            if impl != "steps":
                equal, ties = same_beams(params, cfg, enc, tags, steps_out,
                                         out, impl)
                print(f"inference: {impl} vs steps at float32: {equal}/{B} "
                      f"rows equal, {ties} near-tie rows; "
                      f"{out['decode_calls']} kernel calls")
        found.update(opt_in_modes(dev, cfg, params, enc, tags, steps_out, kw))
        for k in (16, 40):
            wide_beam(params, cfg, enc, tags, kw, k)
    print(f"inference: steps engine with alphas, {steps_out['steps']} steps, "
          f"alpha sums within {a_err:.2g} of 1; launches per path {found}")
    breakdown(engine, cfg, x, enc, tags, kw)
    return found


def wide_beam(params, cfg, enc, tags, kw, k=16):
    """A beam of k through "auto" on the serving encodings: kernel 7
    (counters zeroed just before, read just after), beams equal to the
    "steps" rung's at the same width (kernel 1 at k lanes) but at
    near-ties."""
    from indonesian_image_captioning_tpu_torch.core.config import BeamConfig
    from indonesian_image_captioning_tpu_torch.decode.api import \
        caption_beam_search

    bkw = dict(kw, beam_cfg=BeamConfig(beam_size=k))
    t0 = time.perf_counter()
    out, ran = decode_path(params, cfg, enc, tags, bkw, "fused_decode_span",
                           impl="fused_span")
    t_wide = time.perf_counter() - t0
    ref, _ = decode_path(params, dataclasses.replace(cfg, decode_impl="steps"),
                         enc, tags, bkw, "attend_fused", impl="steps")
    check(out["sequences"].shape[0] == enc.shape[0]
          and bool(out["scores"].isfinite().all()),
          f"K={k}: sequences {tuple(out['sequences'].shape)} or scores not "
          "finite")
    equal, ties = same_beams(params, cfg, enc, tags, ref, out, f"K={k} auto")
    print(f"inference: beam {k} through auto ({out['decode_impl']}, "
          f"{ran} kernel 7 calls, {t_wide:.3f} s): {equal}/{enc.shape[0]} "
          f"rows equal to steps at beam {k}, {ties} near-tie rows")
    # the fused step at the same width: B*K rows in batch tiles of 160
    t0 = time.perf_counter()
    fs, ran = decode_path(
        params, dataclasses.replace(cfg, decode_impl="fused_step"), enc,
        tags, bkw, "fused_decode_step", impl="fused_step")
    t_fs = time.perf_counter() - t0
    equal, ties = same_beams(params, cfg, enc, tags, ref, fs,
                             f"K={k} fused_step")
    print(f"inference: beam {k} through fused_step ({ran} kernel 2 calls, "
          f"{t_fs:.3f} s): {equal}/{enc.shape[0]} rows equal to steps at "
          f"beam {k}, {ties} near-tie rows")


def pack_times(params, cfg):
    """Host milliseconds of packing the decode chains' weights
    (step_cuda.pack_step_weights: transposes, TF32 splits; then the fused
    step's K-major packs, step_cuda.step_packs, and their bytes) from
    cold, as every decode paid it before packs were kept per parameter
    tree, and from the caches, as a decode pays it now; float32 and
    bfloat16."""
    import torch

    from indonesian_image_captioning_tpu_torch.ops import step_cuda

    cell = "scn" if cfg.uses_tags else "lstm"
    for dt in (torch.float32, torch.bfloat16):
        ms, step_ms = [], []
        for cold in (True, False):
            if cold:
                step_cuda._packed.clear()
                step_cuda._step_packs.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            w = step_cuda.pack_step_weights(params, cfg, dt)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            packs, _ = step_cuda.step_packs(w, cell)
            torch.cuda.synchronize()
            ms.append((t1 - t0) * 1e3)
            step_ms.append((time.perf_counter() - t1) * 1e3)
        mb = sum(t.numel() * t.element_size() for t in packs.values()) / 1e6
        print(f"serve: pack_step_weights {str(dt).replace('torch.', '')}: "
              f"cold {ms[0]:.3f} ms, cached {ms[1]:.4f} ms; the fused "
              f"step's K-major packs (step_cuda.step_packs, {mb:.1f} MB): "
              f"cold {step_ms[0]:.3f} ms, cached {step_ms[1]:.4f} ms (host, "
              "with a synchronize)")


def decode_path(params, cfg, enc, tags, kw, kernel, record_alphas=False,
                impl=None):
    """One caption_beam_search with the counters zeroed just before and
    read just after: kernel's wrapper must have launched once per decode
    call (and impl, when given, must be the rung).  Returns (the result,
    the launches)."""
    from indonesian_image_captioning_tpu_torch.decode.api import \
        caption_beam_search

    zero_counters()
    out = caption_beam_search(params, cfg, enc, tags,
                              record_alphas=record_alphas, **kw)
    ran = read_counters()[kernel]
    check(ran == out["decode_calls"] > 0
          and (impl is None or out["decode_impl"] == impl),
          f"{kernel} ran {ran} times in {out['decode_calls']} calls of "
          f"{out['decode_impl']}")
    return out, ran


def alpha_sum_err(out):
    """The largest gap from 1 of the recorded alphas' sums over the steps
    each beam ran."""
    import torch

    lens = out["lengths"]
    pos = torch.arange(out["alpha"].shape[1], device=lens.device)
    valid = (pos[None, :] >= 1) & (pos[None, :] < lens[:, None])
    return float((out["alpha"].sum(-1) - 1).abs()[valid].max())


def opt_in_modes(dev, cfg, params, enc, tags, steps_out, kw):
    """The beam decoder's opt-in modes on the serve phase's encodings and
    tags, each path with the counters zeroed just before and read just
    after: the int8 state on "steps" with alphas (kernel 5) and on
    "fused_step" (kernel 6c); the fused SCN cell on "steps" (kernel 12)
    for attention_scn and pure_scn; pure_scn's "auto" rung (kernel 6b);
    the isolated vocab head on one kernel-2 step (kernel 11).  Returns the
    launches of each kernel on its path."""
    import torch

    from indonesian_image_captioning_tpu_torch.decode.api import \
        caption_beam_search
    from indonesian_image_captioning_tpu_torch.models import decoders
    from indonesian_image_captioning_tpu_torch.ops import fc_topk

    nb = enc.shape[0]
    found = {}
    qcfg = dataclasses.replace(cfg, enc_quant="int8")
    q_steps, found["attend_fused_q"] = decode_path(
        params, dataclasses.replace(qcfg, decode_impl="steps"), enc, tags,
        kw, "attend_fused_q", record_alphas=True, impl="steps")
    a_err = alpha_sum_err(q_steps)
    check(a_err < 1e-3, f"int8 alphas sum to 1 within {a_err}")
    q_step, _ = decode_path(
        params, dataclasses.replace(qcfg, decode_impl="fused_step"), enc,
        tags, kw, "fused_decode_step_q", impl="fused_step")
    equal, ties = same_beams(params, qcfg, enc, tags, q_steps, q_step,
                             "int8 fused_step")
    agree = int(((q_steps["sequences"] == steps_out["sequences"]).all(1)
                 & (q_steps["lengths"] == steps_out["lengths"])).sum())
    print(f"inference: int8 steps (kernel 5), alpha sums within "
          f"{a_err:.2g} of 1; int8 fused_step (kernel 6c) vs int8 steps: "
          f"{equal}/{nb} rows equal, {ties} near-tie rows; int8 vs float32 "
          f"steps: {agree}/{nb} rows equal (lossy by contract, not checked)")

    fcfg = dataclasses.replace(cfg, decode_impl="steps", fused_cell=True)
    f_steps, found["scn_step_fused"] = decode_path(
        params, fcfg, enc, tags, kw, "scn_step_fused", record_alphas=True,
        impl="steps")
    equal, ties = same_beams(params, cfg, enc, tags, steps_out, f_steps,
                             "fused_cell steps")
    print(f"inference: fused_cell steps (kernel 12) vs steps: {equal}/{nb} "
          f"rows equal, {ties} near-tie rows; alpha sums within "
          f"{alpha_sum_err(f_steps):.2g} of 1")

    # pure_scn at the flagship widths on the same encodings and tags
    pcfg = dataclasses.replace(cfg, model_type="pure_scn")
    gen = torch.Generator().manual_seed(SEED + 11)
    pparams = decoders.init_decoder(gen, pcfg, device=dev)
    p_steps = caption_beam_search(
        pparams, dataclasses.replace(pcfg, decode_impl="steps"), enc, tags,
        **kw)
    p_auto, found["fused_decode_step_noattn"] = decode_path(
        pparams, pcfg, enc, tags, kw, "fused_decode_step_noattn",
        impl="fused_step")
    p_fused, _ = decode_path(
        pparams, dataclasses.replace(pcfg, decode_impl="steps",
                                     fused_cell=True),
        enc, tags, kw, "scn_step_fused", impl="steps")
    for label, out in (("auto (kernel 6b)", p_auto),
                       ("fused_cell steps (kernel 12)", p_fused)):
        equal, ties = same_beams(pparams, pcfg, enc, tags, p_steps, out,
                                 f"pure_scn {label}")
        print(f"inference: pure_scn {label} vs steps: {equal}/{nb} rows "
              f"equal, {ties} near-tie rows; {out['decode_calls']} kernel "
              "calls")

    # the isolated vocab head (tools/profile_decode.py) on the h rows of
    # one kernel-2 step
    init_state, step_fn = decoders.make_beam_step(params, cfg, enc, tags,
                                                  fused_step=True)
    start = torch.full((nb, K), kw["start_id"], dtype=torch.long,
                       device=dev)
    (cand_vals, cand_ids), state, _ = step_fn(init_state(K), start)
    h_rows = state["h"].reshape(nb * K, -1)
    zero_counters()
    topv, topi, lse = fc_topk.fc_topk(h_rows, params["fc"]["w"],
                                      params["fc"]["b"], K)
    found["fc_topk"] = read_counters()["fc_topk"]
    check(found["fc_topk"] == 1, "the vocab head did not run kernel 11")
    cand = (topv - lse[:, None]).reshape(nb, K, K)
    logits = h_rows @ params["fc"]["w"] + params["fc"]["b"]
    n_ties = near_tie_rows(topi, cand_ids.reshape(nb * K, K), logits,
                           "fc_topk vs the fused step")
    same = topi.reshape(nb, K, K) == cand_ids
    e_vals = float((cand - cand_vals).abs()[same].max())
    check(e_vals <= NEAR_TIE, f"fc_topk candidates differ from the fused "
          f"step's by {e_vals}")
    flat_v, _ = torch.topk(cand.reshape(nb, K * K), K, dim=1)
    print(f"inference: fc_topk (kernel 11) on one fused step's {nb * K} h "
          f"rows: candidates within {e_vals:.3g} of the step's, ids equal "
          f"but {n_ties} near-tie rows; best flat candidate "
          f"{float(flat_v[:, 0].max()):.4f}")
    return found


def same_beams(params, cfg, enc, tags, ref, out, label):
    """Rows whose beams equal ref's, and rows whose first divergence is a
    near-tie (prefix scores within NEAR_TIE); any other row fails."""
    import torch

    same = ((out["sequences"] == ref["sequences"]).all(1)
            & (out["lengths"] == ref["lengths"]))
    near_ties = 0
    for r in (~same).nonzero().flatten().tolist():
        s, f = ref["sequences"][r], out["sequences"][r]
        t = int((s != f).nonzero()[0]) if bool((s != f).any()) else \
            int(min(ref["lengths"][r], out["lengths"][r]))
        sc = prefix_scores(params, cfg, enc[r:r + 1], tags[r:r + 1],
                           torch.stack([s, f]), t)
        gap = abs(float(sc[0] - sc[1]))
        check(gap <= NEAR_TIE, f"{label} row {r}: beams diverge at step {t} "
              f"with prefix scores {sc.tolist()} (gap {gap})")
        near_ties += 1
    return int(same.sum()), near_ties


def breakdown(engine, cfg, x, enc, tags, kw):
    """Where one batch's time goes: the encoders, and the decode through
    each rung (and the int8 state's two) on the host clock (median of 3,
    each ending in a synchronise) with captions/s, and the decode's device
    busy share and top kernels from torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from indonesian_image_captioning_tpu_torch.decode.api import \
        caption_beam_search
    from indonesian_image_captioning_tpu_torch.models import encoders

    st = engine.state

    def run_encoders():
        encoders.apply_encoder_tagger(st["tagger"], st["tagger_stats"], x,
                                      arch=cfg.encoder_arch)
        encoders.apply_encoder_caption(
            st["encoder"], st["encoder_stats"], x,
            enc_image_size=cfg.enc_image_size, arch=cfg.encoder_arch)

    def host_s(fn):
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return statistics.median(times)

    nb = x.shape[0]
    with torch.inference_mode():
        t_enc = host_s(run_encoders)
        print(f"breakdown: batch of {nb}, {cfg.dtype}: encoders "
              f"{t_enc * 1e3:.1f} ms")
        rungs = [(impl, dataclasses.replace(cfg, decode_impl=impl))
                 for impl in RUNGS]
        rungs += [(f"int8 {impl}", dataclasses.replace(
            cfg, decode_impl=impl, enc_quant="int8"))
            for impl in ("steps", "fused_step")]
        for impl, rcfg in rungs:
            def run_decode():
                return caption_beam_search(st["params"], rcfg, enc, tags,
                                           **kw)

            t_dec = host_s(run_decode)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                run_decode()
                torch.cuda.synchronize()
                t_prof = time.perf_counter() - t0
            kernels = sorted(((e.self_device_time_total, e.key)
                              for e in prof.key_averages()
                              if e.device_type == DeviceType.CUDA),
                             reverse=True)
            busy = sum(t for t, _ in kernels) / 1e6
            top = ", ".join(f"{k.split('(')[0][:40]} {t / 1e3:.1f} ms"
                            for t, k in kernels[:3])
            # the profiler stretches the host side, not the kernels: the
            # busy share is taken against the unprofiled decode time
            print(f"breakdown[{impl}]: decode {t_dec * 1e3:.1f} ms, "
                  f"{nb / t_dec:.1f} captions/s; kernels {busy * 1e3:.1f} "
                  f"ms of it ({100 * busy / t_dec:.1f} % busy; "
                  f"{t_prof * 1e3:.1f} ms under the profiler); top: {top}")


def bound(nbytes, flops, dtype="float32"):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over the peak rate for the type."""
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = flops / PEAK_OPS_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def chain_bound(work, name):
    """(bound_ms, bound_by, ffma_bound_ms) of a kernel whose products run
    on the tensor cores (kernels 2, 6b, 6c, 7, 13 on csrc/mma.cuh; 8 and 9
    on csrc/mma_small.cuh and mma.cuh): at float32 against the 3xTF32
    peak, with the FFMA peak's bound beside it."""
    if name == "float32":
        ms, by = bound(*work, "tf32x3")
        return ms, by, bound(*work, "float32")[0]
    ms, by = bound(*work, name)
    return ms, by, ms


def attend_work(cfg, B, isz=4, k=K):
    """Bytes and operations of kernel 1 at B images x k lanes: enc, ea,
    dec and wf read once; awe and alpha written once."""
    P, E, A = cfg.num_pixels, cfg.encoder_dim, cfg.attention_dim
    nbytes = isz * (B * P * (E + A) + B * k * (A + E + P)) + 4 * A
    return nbytes, B * k * P * (3 * A + 2 * E)


def attend_q_work(cfg, B, isz=4, k=K):
    """Bytes and operations of kernel 5 at B images x k lanes: the int8
    enc and ea and their float32 scales, dec and wf read once; awe and
    alpha written once; kernel 1's operations and the dequantisation."""
    P, E, A = cfg.num_pixels, cfg.encoder_dim, cfg.attention_dim
    nbytes = B * P * (E + A + 8) + isz * B * k * (A + E + P) + 4 * A
    return nbytes, B * k * P * (3 * A + 2 * E) + B * P * A


def step_work(cfg, B, isz=4, quant=False, k=K):
    """Bytes and operations of kernel 2 at R = B*k rows for cfg's family:
    attention (none for pure_scn), the cell's products and the head; with
    quant, kernel 6c's (the encoder state int8 with float32 scales)."""
    K = k
    R, P = B * K, cfg.num_pixels
    E, A, D, V = cfg.encoder_dim, cfg.attention_dim, cfg.decoder_dim, \
        cfg.vocab_size
    Emb, F4 = cfg.embed_dim, 4 * cfg.factored_dim
    if cfg.model_type == "pure_attention":
        weights = D * A + D * E + (Emb + E) * 4 * D + D * 4 * D + D * V
    else:
        weights = Emb * F4 + D * F4 + 2 * F4 * D + D * V
        if cfg.uses_attention:
            weights += D * A + D * E + E * F4
    rows = R * (Emb + 4 * D + (2 * F4 if cfg.uses_tags else 0))
    enc = B * P * (E + A) if cfg.uses_attention else 0
    att = B * K * P * (3 * A + 2 * E) if cfg.uses_attention else 0
    nbytes = isz * (weights + rows) + 4 * R * (2 * K + 1)
    if quant:
        nbytes += enc + 8 * B * P
        att += B * P * A
    else:
        nbytes += isz * enc
    return nbytes, 2 * R * weights + att


def scn_work(cfg, R, isz=4):
    """Bytes and operations of kernel 12 at R rows of cfg's family: the
    weights, x, h, c and the two semantic factors read once, h' and c'
    written once; the four products (the cell's elementwise work is
    negligible beside them)."""
    from indonesian_image_captioning_tpu_torch.models.decoders import \
        cell_input_dim

    In, H, F4 = cell_input_dim(cfg), cfg.decoder_dim, 4 * cfg.factored_dim
    weights = In * F4 + H * F4 + 2 * F4 * H + 8 * H
    nbytes = isz * (weights + R * (In + 2 * H + 2 * F4 + 2 * H))
    return nbytes, 2 * R * (In + H) * F4 + 4 * R * F4 * H


def fc_topk_work(R, D, V, k):
    """Bytes and operations of kernel 11 (float32): h, w and b read once,
    topv, topi (R, k) and lse (R,) written once; the product."""
    return 4 * (R * D + D * V + V) + 8 * R * k + 4 * R, 2 * R * D * V


def record_work(cfg, B, steps, isz=4, k=K):
    """Bytes and operations of kernels 7 and 13 over `steps` steps of B
    images: kernel 2's bytes once (a call that kept them could read the
    weights, the encoder state and the carried rows once), the embedding
    rows of every step and the records; kernel 2's operations every
    step."""
    K = k
    nbytes, flops = step_work(cfg, B, isz, k=k)
    R = B * K
    nbytes += (isz * steps * R * cfg.embed_dim + 12 * B * steps * K
               + 16 * R + 8 * B)
    return nbytes, steps * flops


def topk_work(R, V, k, isz=4):
    """Bytes and operations of kernel 10: the (R, V) table read once, the
    (R, k) values and indices written once; one comparison per value."""
    return isz * R * V + (isz + 4) * R * k, R * V


def train_work(cfg, B, T, isz=4):
    """Bytes and operations of kernels 8 and 9 at B images x T steps: each
    input read once and each output written once; the products' and the
    attention's operations.  Returns ((fwd bytes, ops), (bwd bytes,
    ops))."""
    P, E, A, D = cfg.num_pixels, cfg.encoder_dim, cfg.attention_dim, \
        cfg.decoder_dim
    scn = cfg.model_type == "attention_scn"
    F4 = 4 * cfg.factored_dim if scn else 4 * D
    H = D
    weights = D * (A + E) + E * F4 + D * F4 + (2 * F4 * H if scn else 0)
    enc = B * P * (E + A)
    # per step: hall, xin, [hfac, gate pairs] | [h @ wh]; attention
    mm_fwd = D * (A + E) + E * F4 + (D * F4 + 2 * F4 * H if scn else D * F4)
    att = P * (3 * A + 2 * E)
    fwd_ops = B * T * (2 * mm_fwd + att)
    fwd_bytes = isz * (enc + weights + B * T * F4 + B * (2 * F4 + 2 * D)
                       + B * T * (2 * D + E)) + 4 * B * T * P
    # pass A (the same products at B*T rows) + per step: factor pairs,
    # d_awe, d_alpha, the softmax / mask backward, dh
    mm_bwd = mm_fwd + (2 * F4 * H if scn else 0) + F4 * E + (F4 + E + A) * D
    bwd_ops = B * T * (2 * mm_bwd + P * (2 * E + 4 * A))
    streams = (4 * H + E + A + E) + (3 * F4 if scn else 0) + F4
    bwd_bytes = (isz * (enc + weights + B * T * (F4 + 3 * D + E) + B * T
                        * streams) + 4 * (2 * B * T * P + B * P * A + A
                                          + B * (2 * F4 + 2 * D)))
    return (fwd_bytes, fwd_ops), (bwd_bytes, bwd_ops)


def train_inputs(dev, dtype, cfg, B, gen):
    """Kernels 8 and 9's inputs at cfg's widths, built as
    fused_teacher_forcing_scan builds them, on seeded random weights."""
    import torch

    from indonesian_image_captioning_tpu_torch.models import (attention,
                                                              decoders,
                                                              scn_cell)
    from indonesian_image_captioning_tpu_torch.ops import train_cuda

    T = cfg.max_caption_len - 1
    params = decoders.init_decoder(gen, cfg, device=dev)
    enc = torch.relu(torch.randn((B, cfg.num_pixels, cfg.encoder_dim),
                                 generator=gen)).to(dev)
    ea = attention.precompute(params["attention"], enc)
    caps = torch.randint(0, cfg.vocab_size, (B, T), generator=gen).to(dev)
    emb = params["embedding"][caps]
    step = params["decode_step"]
    cell = train_cuda.cell_of(cfg)
    semx = semh = None
    if cell == "scn":
        tags = torch.rand((B, cfg.semantic_dim), generator=gen).to(dev)
        sx, sh = scn_cell.semantic_projections(step, tags)
        semx, semh = (x.reshape(B, -1).to(dtype).contiguous()
                      for x in (sx, sh))
        w_x_emb = step["w_x"][:cfg.embed_dim]
    else:
        w_x_emb = step["w_ih"][:cfg.embed_dim]
    h0, c0 = decoders.init_hidden_state(params, enc)
    kw = {k: v.contiguous() for k, v in
          train_cuda.pack_train_weights(params, cfg, dtype).items()}
    return cell, (kw, enc.to(dtype).contiguous(), ea.to(dtype).contiguous(),
                  (emb @ w_x_emb).to(dtype).contiguous(), semx, semh,
                  h0.to(dtype).contiguous(), c0.to(dtype).contiguous())


def train_kernel_case(dev, dtype, cfg, B):
    """Kernels 8 and 9 against their plain versions for cfg's cell: every
    output and stream within TRAIN_TOL of its scale (forward) or
    TRAIN_BWD_TOL of its norm (backward), and both times.  The backward
    runs on the plain forward's residuals."""
    import torch

    from indonesian_image_captioning_tpu_torch.ops import train_cuda

    name = str(dtype).replace("torch.", "")
    gen = torch.Generator().manual_seed(SEED + 3)
    cell, args = train_inputs(dev, dtype, cfg, B, gen)
    label = f"{cfg.model_type} {name}"

    def compare(what, got, ref, tol, by_norm):
        """Every output within tol: of its largest magnitude (max error) or
        of its norm (by_norm).  Returns the largest absolute error."""
        worst = (0.0, "")
        for key in ref:
            a, b = got[key].float(), ref[key].float()
            check(bool(a.isfinite().all()), f"{what} {label}: {key} not "
                  "finite")
            if by_norm:
                rel = float((a - b).norm()) / max(float(b.norm()), 1e-30)
            else:
                rel = max_err(a, b) / max(float(b.abs().max()), 1e-30)
            check(rel <= tol, f"{what} {label}: {key} error {rel} of its "
                  f"{'norm' if by_norm else 'scale'} > {tol}")
            worst = max(worst, (rel, key))
        print(f"kernel {what}[{label}]: worst {worst[1]} {worst[0]:.3g} of "
              f"its {'norm' if by_norm else 'scale'} (tol {tol}); max abs "
              "errors " + ", ".join(f"{k} {max_err(got[k], ref[k]):.2g}"
                                    for k in sorted(ref)))
        return max(max_err(got[k], ref[k]) for k in ref)

    names = ("h_all", "c_all", "alphas", "awe_raw")
    n0 = train_cuda.train_fwd.launches
    out = dict(zip(names, train_cuda.train_fwd(*args, cell=cell)))
    ref = dict(zip(names, train_cuda.train_fwd_plain(*args, cell=cell)))
    torch.cuda.synchronize()
    check(train_cuda.train_fwd.launches == n0 + 1,
          f"train_fwd {label}: the kernel was not launched")
    e_fwd = compare("train_fwd", out, ref, TRAIN_TOL[name], False)
    gen2 = torch.Generator().manual_seed(SEED + 4)
    res = tuple(ref[k] for k in names)
    d_hall = (torch.randn(ref["h_all"].shape, generator=gen2) * 0.1).to(
        dev, dtype)
    d_alphas = (torch.randn(ref["alphas"].shape, generator=gen2)
                * 0.01).to(dev)
    bargs = args + res + (d_hall, d_alphas)
    n0 = train_cuda.train_bwd.launches
    got = train_cuda.train_bwd(*bargs, cell=cell)
    exp = train_cuda.train_bwd_plain(*bargs, cell=cell)
    torch.cuda.synchronize()
    check(train_cuda.train_bwd.launches == n0 + 1,
          f"train_bwd {label}: the kernel was not launched")
    check(set(got) == set(exp), f"train_bwd {label}: outputs {sorted(got)}"
          f" != {sorted(exp)}")
    e_bwd = compare("train_bwd", got, exp, TRAIN_BWD_TOL[name], True)
    f_plain, f_ms, b_plain, b_ms = median_ms([
        lambda: train_cuda.train_fwd_plain(*args, cell=cell),
        lambda: train_cuda.train_fwd(*args, cell=cell),
        lambda: train_cuda.train_bwd_plain(*bargs, cell=cell),
        lambda: train_cuda.train_bwd(*bargs, cell=cell)])
    T = cfg.max_caption_len - 1
    fwd_work, bwd_work = train_work(cfg, B, T, dtype.itemsize)
    calls = {"train_fwd": lambda: train_cuda.train_fwd(*args, cell=cell),
             "train_bwd": lambda: train_cuda.train_bwd(*bargs, cell=cell)}
    steps = {}
    for what, fn in calls.items():      # csrc/train.cu's launch counter
        fn()
        n = train_cuda.last_launches()
        steps[what] = (n["fwd"] if what == "train_fwd" else
                       n["bwd_loop"]) / T
        check(steps[what] <= {"train_fwd": 4, "train_bwd": 5}[what],
              f"{what} {label}: {steps[what]} launches a step")
    kw = args[0]
    pack_f, pack_b = median_ms([
        lambda: train_cuda.pack_fwd(kw, cell, dtype),
        lambda: train_cuda.pack_bwd(kw, cell, dtype)])
    print(f"kernel train[{label}]: launches a step (library counter) "
          f"forward {steps['train_fwd']:.2f}, backward loop "
          f"{steps['train_bwd']:.2f}; weight packs made every call: "
          f"forward {pack_f:.4f} ms, backward (pass A) {pack_b:.4f} ms")
    res = {}
    for what, fn, ms, plain, err, work in (
            ("train_fwd", calls["train_fwd"], f_ms, f_plain, e_fwd,
             fwd_work),
            ("train_bwd", calls["train_bwd"], b_ms, b_plain, e_bwd,
             bwd_work)):
        parts = {}
        dev_ms = device_ms(fn, runs=5, by_kernel=parts)
        counts = kernel_counts(fn)
        bound_ms, bound_by, ffma_ms = chain_bound(work, name)
        top = sorted(parts.items(), key=lambda kv: -kv[1])[:6]
        print(f"kernel {what}[{label}]: ms {ms:.4f} device_ms {dev_ms:.4f} "
              f"plain_ms {plain:.4f} bound_ms {bound_ms:.4f} ({bound_by}; "
              f"FFMA {ffma_ms:.4f}); launches per call "
              f"{sum(counts.values())} ({sum(counts.values()) / T:.1f} per "
              "step, profiler)")
        print(f"  {what}[{label}] top 6 by device time: " + "; ".join(
            f"{k.split('(')[0][:56]} x{counts.get(k, 0)} {v:.4f} ms"
            for k, v in top))
        res[what] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                         device_ms=dev_ms, launches_per_step=steps[what])
    return res


def train_phase(dev, cfg, B, image_size):
    """The trainer on the card: kernel checks, the fused-vs-eager gradient
    check and the main path (5 train steps).  Returns (kernel results,
    launches of the main path)."""
    import numpy as np
    import torch

    from indonesian_image_captioning_tpu_torch.core.config import \
        TrainConfig
    from indonesian_image_captioning_tpu_torch.models import decoders
    from indonesian_image_captioning_tpu_torch.ops import losses, train_cuda
    from indonesian_image_captioning_tpu_torch.train import steps

    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        for family in ("attention_scn", "pure_attention"):
            fcfg = dataclasses.replace(cfg, model_type=family)
            with torch.no_grad():
                res[(name, family)] = train_kernel_case(dev, dtype, fcfg, B)

    # ---- cached features of one batch: seeded ResNet-152s, bfloat16 ----
    tcfg = TrainConfig(batch_size=B)
    T = cfg.max_caption_len - 1
    rng = np.random.default_rng(SEED + 5)
    images = rng.integers(0, 256, size=(B, 3, image_size, image_size),
                          dtype=np.uint8)
    t0 = time.perf_counter()
    state = make_state(dev, cfg, images)
    encode = steps.make_encoders_fn(cfg, tcfg.encoder_dtype, dev)
    enc_out, tags = encode(state, {"images": images})
    torch.cuda.synchronize()
    S = cfg.enc_image_size
    check(enc_out.shape == (B, S, S, cfg.encoder_dim)
          and bool(enc_out.isfinite().all()) and bool(tags.isfinite().all()),
          "cached features not finite or misshapen")
    print(f"train: encoders ({tcfg.encoder_dtype}) and calibration "
          f"{time.perf_counter() - t0:.1f} s; features "
          f"|enc| {float(enc_out.abs().mean()):.3g}")
    del state
    caplens = torch.from_numpy(rng.integers(3, cfg.max_caption_len + 1,
                                            size=(B,))).to(dev)
    caps = torch.from_numpy(rng.integers(1, cfg.vocab_size,
                                         size=(B, T + 1))).to(dev)
    caps = torch.where(torch.arange(T + 1, device=dev)[None]
                       < caplens[:, None], caps, 0)

    # ---- fused (kernels 8, 9) against eager autograd, dropout off ----
    gen = torch.Generator().manual_seed(SEED + 6)
    params = decoders.init_decoder(gen, cfg, device=dev)
    leaves = steps.tree_leaves(params)
    grads, lossv = {}, {}
    for impl in ("fused", "xla"):
        icfg = dataclasses.replace(cfg, train_scan_impl=impl, dropout=0.0)
        for p in leaves:
            p.requires_grad_(True)
        n0 = (train_cuda.train_fwd.launches, train_cuda.train_bwd.launches)
        out = decoders.teacher_forcing(params, icfg, enc_out, tags, caps,
                                       caplens, train=True)
        loss, _ = losses.caption_loss(out, caps, tcfg.alpha_c)
        g = torch.autograd.grad(loss, leaves, allow_unused=True)
        torch.cuda.synchronize()
        ran = (train_cuda.train_fwd.launches - n0[0],
               train_cuda.train_bwd.launches - n0[1])
        check(ran == ((1, 1) if impl == "fused" else (0, 0)),
              f"gradient check {impl}: train kernels ran {ran}")
        grads[impl] = [torch.zeros_like(p) if x is None else x
                       for p, x in zip(leaves, g)]
        lossv[impl] = loss.item()
    worst = (0.0, None)
    for i, (gf, gx) in enumerate(zip(grads["fused"], grads["xla"])):
        scale = float(gx.abs().max())
        if scale < 1e-7:           # the full_att bias: exactly zero in math
            continue
        rel = float((gf - gx).abs().max()) / scale
        check(rel < GRAD_TOL, f"gradient leaf {i} {tuple(gx.shape)}: fused "
              f"vs eager {rel} >= {GRAD_TOL}")
        worst = max(worst, (rel, (i, tuple(gx.shape))))
    lrel = abs(lossv["fused"] - lossv["xla"]) / abs(lossv["xla"])
    check(lrel < LOSS_TOL, f"loss fused {lossv['fused']} vs eager "
          f"{lossv['xla']}: {lrel} >= {LOSS_TOL}")
    print(f"train: gradient check over {len(leaves)} leaves, fused vs "
          f"eager: worst {worst[0]:.3g} of scale, leaf {worst[1]} (tol "
          f"{GRAD_TOL}); loss "
          f"{lossv['fused']:.6f} vs {lossv['xla']:.6f} ({lrel:.2g})")
    del grads

    # ---- the main path: 5 train steps, counters zeroed just before ----
    opt = steps.make_optimizer(tcfg.decoder_lr, tcfg.grad_clip)
    _, step = steps.make_caption_train_step(cfg, tcfg, opt, device=dev)
    with torch.no_grad():
        snapshot = [p.detach().clone() for p in leaves]
    sub = {"params": params, "opt_state": opt.init(params)}
    dgen = torch.Generator(device=dev).manual_seed(SEED + 7)
    torch.cuda.synchronize()
    train_cuda.train_fwd.launches = 0
    train_cuda.train_bwd.launches = 0
    times, metrics = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        _, m = step(sub, enc_out, tags, caps, caplens, dgen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
    launches = {"train_fwd": train_cuda.train_fwd.launches,
                "train_bwd": train_cuda.train_bwd.launches}
    # ------------------------------------------------------------------
    loss_seq = [m["loss"] for m in metrics]
    check(all(np.isfinite(loss_seq)), f"losses {loss_seq} not finite")
    check(loss_seq[-1] < loss_seq[0], f"loss did not fall: {loss_seq}")
    check(launches == {"train_fwd": TRAIN_STEPS, "train_bwd": TRAIN_STEPS},
          f"{TRAIN_STEPS} steps launched the train kernels {launches}")
    step_s = statistics.median(times[1:])
    print(f"train: {TRAIN_STEPS} steps, head "
          f"{steps.resolve_head_impl(tcfg, cfg, B, dev)}, loss "
          + " -> ".join(f"{x:.4f}" for x in loss_seq)
          + f"; top5 {metrics[-1]['top5']:.2f}, n_tokens "
          f"{metrics[-1]['n_tokens']:.0f}; step ms "
          + ", ".join(f"{1e3 * x:.1f}" for x in times)
          + f"; median of steps 2-{TRAIN_STEPS} {1e3 * step_s:.1f} ms, "
          f"{B / step_s:.1f} imgs/s; launches {launches}")

    train_breakdown(step, sub, (enc_out, tags, caps, caplens), dgen, B)

    # ---- one step with the chunked head against the dense head ----
    head_loss, head_ms = {}, {}
    for head in ("dense", "chunked"):
        with torch.no_grad():
            for p, s0 in zip(leaves, snapshot):
                p.copy_(s0)
        hcfg = dataclasses.replace(tcfg, head_impl=head)
        hopt = steps.make_optimizer(hcfg.decoder_lr, hcfg.grad_clip)
        _, hstep = steps.make_caption_train_step(cfg, hcfg, hopt, device=dev)
        hsub = {"params": params, "opt_state": hopt.init(params)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m = hstep(hsub, enc_out, tags, caps, caplens,
                     torch.Generator(device=dev).manual_seed(SEED + 8))
        torch.cuda.synchronize()
        head_ms[head] = 1e3 * (time.perf_counter() - t0)
        head_loss[head] = float(m["loss"])
    hrel = abs(head_loss["chunked"] - head_loss["dense"]) / abs(
        head_loss["dense"])
    check(hrel < HEAD_TOL, f"chunked head loss {head_loss['chunked']} vs "
          f"dense {head_loss['dense']}: {hrel} >= {HEAD_TOL}")
    print(f"train: one step from the same weights, dense head "
          f"{head_loss['dense']:.6f} ({head_ms['dense']:.1f} ms), chunked "
          f"{head_loss['chunked']:.6f} ({head_ms['chunked']:.1f} ms), "
          f"{hrel:.2g} apart (tol {HEAD_TOL})")
    return res, launches


def trainer_phase(dev, cfg, image_size):
    """The trainer's main path: train.caption.train at cfg's widths with
    embed_grad_impl="pallas" on an in-memory corpus of seeded noise images
    and Zipf-drawn captions (TRAINER_IMAGES, TRAINER_CPI per image), the
    feature cache on the device, BatchNorm calibrated on one batch, two
    epochs with checkpoints; then a resume that runs nothing (Adam's
    moments bitwise the saved ones), a resume for a third epoch, one
    uncached epoch through the device image store (the cached run's
    losses), and a profile of one train step with kernel 14.  Returns the
    launches of the two-epoch run."""
    import tempfile

    import numpy as np
    import torch

    from indonesian_image_captioning_tpu_torch.core import checkpoint
    from indonesian_image_captioning_tpu_torch.core.config import \
        TrainConfig
    from indonesian_image_captioning_tpu_torch.data.datasets import \
        CaptionDataset
    from indonesian_image_captioning_tpu_torch.data.loader import \
        num_batches
    from indonesian_image_captioning_tpu_torch.train import caption, steps

    rng = np.random.default_rng(SEED + 9)
    V, L = cfg.vocab_size, cfg.max_caption_len

    def split(n, name):
        caps, lens = captions(rng, n * TRAINER_CPI, V, L)
        images = rng.integers(0, 256, size=(n, 3, image_size, image_size),
                              dtype=np.uint8)
        return CaptionDataset.from_arrays(images, caps, lens,
                                          cpi=TRAINER_CPI, split=name)

    train_ds, val_ds = (split(n, name) for n, name in
                        zip(TRAINER_IMAGES, ("TRAIN", "VAL")))
    wm = word_map(V)
    kcfg = dataclasses.replace(cfg, embed_grad_impl="pallas")
    name = "smoke_corpus"
    n_train = num_batches(len(train_ds), B)
    n_val = num_batches(len(val_ds), B)

    def run(ckdir, logs, resume=False, **kw):
        tcfg = TrainConfig(**{**dict(
            epochs=TRAINER_EPOCHS, batch_size=B, print_freq=5,
            cache_features=True, calibrate_encoder_stats=1,
            checkpoint_dir=ckdir), **kw})
        return caption.train("attention_scn", wm, train_ds, val_ds, tcfg,
                             model_cfg=kcfg, data_name=name, resume=resume,
                             log=logs.append, device=dev)

    with tempfile.TemporaryDirectory() as ckdir:
        # ---- the main path: counters zeroed just before, read just after
        logs = []
        torch.cuda.synchronize()
        zero_counters()
        t0 = time.perf_counter()
        state, summary = run(ckdir, logs)
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        launches = read_counters()
        # -----------------------------------------------------------------
        steps_run = TRAINER_EPOCHS * n_train
        check(launches["embed_grad_scatter"] == steps_run > 0,
              f"kernel 14 ran {launches['embed_grad_scatter']} times in "
              f"{steps_run} train steps")
        check(launches["train_bwd"] == steps_run and launches["train_fwd"]
              == steps_run + TRAINER_EPOCHS * n_val,
              f"kernels 8 and 9 ran {launches['train_fwd']} and "
              f"{launches['train_bwd']} times in {steps_run} train and "
              f"{TRAINER_EPOCHS * n_val} validation steps")
        losses = summary["step_losses"]
        check(sorted(losses) == list(range(TRAINER_EPOCHS))
              and all(len(v) == n_train and np.isfinite(v).all()
                      for v in losses.values()),
              f"step losses {losses}")
        bleu_lines = [x for x in logs if "BLEU-4 - " in x]
        check(len(bleu_lines) == TRAINER_EPOCHS,
              f"BLEU-4 computed {len(bleu_lines)} times")
        base = f"checkpoint_attention_scn_{name}"
        for f in (base, "BEST_" + base):
            check((Path(ckdir) / f).is_file(), f"{f} missing")
        saved = checkpoint.load_checkpoint(ckdir, "attention_scn", name)
        check(saved["epoch"] == TRAINER_EPOCHS - 1,
              f"the checkpoint holds epoch {saved['epoch']}")
        moments = adam_moments(state["opt_state"])
        check(same_moments(adam_moments(saved["state"]["opt_state"]),
                           moments), "the saved Adam moments differ from "
              "the trainer's")
        del state
        epoch_s = summary["timings"]["train_epoch"]
        print(f"trainer: {TRAINER_EPOCHS} epochs of {n_train} steps (B={B}, "
              f"{len(train_ds)} TRAIN / {len(val_ds)} VAL captions), "
              f"embed_grad_impl=pallas, {t_run:.1f} s in all; feature "
              f"cache build {summary['timings']['cache_build']:.3f} s; "
              "train epoch s (train imgs/s) " + ", ".join(
                  f"{epoch_s[e]:.3f} ({len(train_ds) / epoch_s[e]:.1f})"
                  for e in sorted(epoch_s))
              + f"; train_loss {summary['train_loss']:.4f},"
              f" BLEU-4 {summary['best_metric']:.3g}; launches "
              f"{ {k: v for k, v in launches.items() if v} }")
        print("trainer: " + bleu_lines[-1].strip())

        # ---- resume: nothing left to run, then a third epoch ----
        again, s2 = run(ckdir, [], resume=True)
        check(s2["start_epoch"] == TRAINER_EPOCHS and not s2["step_losses"],
              f"resume with {TRAINER_EPOCHS} epochs ran "
              f"{sorted(s2['step_losses'])} from {s2['start_epoch']}")
        check(same_moments(adam_moments(again["opt_state"]), moments),
              "resumed Adam moments differ from the saved ones")
        del again
        logs3 = []
        n0 = read_counters()["embed_grad_scatter"]
        _, s3 = run(ckdir, logs3, resume=True, epochs=TRAINER_EPOCHS + 1)
        check(s3["start_epoch"] == TRAINER_EPOCHS
              and sorted(s3["step_losses"]) == [TRAINER_EPOCHS]
              and f"Current epoch {TRAINER_EPOCHS + 1}\n" in logs3
              and "Current epoch 1\n" not in logs3,
              f"resume for epoch {TRAINER_EPOCHS + 1} ran "
              f"{sorted(s3['step_losses'])}")
        check(read_counters()["embed_grad_scatter"] - n0 == n_train,
              "the resumed epoch did not run kernel 14 once per step")
        print(f"trainer: resumed at epoch {s3['start_epoch'] + 1}, Adam "
              f"moments ({len(moments)} tensors) bitwise the saved ones; "
              f"epoch {TRAINER_EPOCHS + 1} loss {s3['train_loss']:.4f}")

    # ---- one epoch without the cache: pixels from the device store ----
    with tempfile.TemporaryDirectory() as ckdir:
        logs = []
        state, s4 = run(ckdir, logs, epochs=1, cache_features=False,
                        device_images="on")
        check(any("device image store [TRAIN]" in x for x in logs),
              "the uncached run did not build the device image store")
        a, b = np.array(s4["step_losses"][0]), np.array(losses[0])
        rel = float(np.abs(a - b).max() / np.abs(b).max())
        check(rel <= UNCACHED_TOL, f"uncached epoch losses {a} vs cached "
              f"{b}: {rel} > {UNCACHED_TOL}")
        print(f"trainer: one uncached epoch (device image store) "
              f"{s4['timings']['train_epoch'][0]:.3f} s, its {len(a)} step "
              f"losses within {rel:.2g} of the cached run's (tol "
              f"{UNCACHED_TOL})")

    # ---- where one train step's time goes, kernel 14 included ----
    tcfg = TrainConfig(batch_size=B)
    opt = steps.make_optimizer(tcfg.decoder_lr, tcfg.grad_clip)
    encode, step = steps.make_caption_train_step(kcfg, tcfg, opt, device=dev)
    batch = train_ds.gather(np.arange(B))
    enc_out, tags = encode(state, {"images": train_ds.gather_images(
        np.arange(B) // TRAINER_CPI)})
    caps = torch.from_numpy(batch["captions"]).to(dev)
    caplens = torch.from_numpy(batch["caplens"]).to(dev)
    sub = {"params": state["params"], "opt_state": state["opt_state"]}
    n0 = read_counters()["embed_grad_scatter"]
    train_breakdown(step, sub, (enc_out, tags, caps, caplens),
                    torch.Generator(device=dev).manual_seed(SEED + 11), B)
    check(read_counters()["embed_grad_scatter"] - n0 == 2,
          "the profiled steps did not run kernel 14")
    return {"embed_grad_scatter": launches["embed_grad_scatter"]}


def damp_residuals(params, factor=ENC_DAMP):
    """Scale every bottleneck's bn3 scale of a ResNet tree in place."""
    import torch

    with torch.no_grad():
        for stage in ("layer1", "layer2", "layer3", "layer4"):
            sp = params["resnet"][stage]
            for bp in [sp["first"], *sp["rest"]]:
                bp["bn3"]["scale"].mul_(factor)


def timed_steps(step, n):
    """Run step() n times, each ending in a synchronize; returns the
    results and the host ms of each."""
    import torch

    out, ms = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out.append(step())
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    return out, ms


def save_parts(timings):
    """The async saver's parts of each checkpoint, and the pinned host
    memory PyTorch's caching host allocator holds after them (the saver
    copies into pinned memory and the allocator keeps it), as printed
    text."""
    import torch

    stats = getattr(torch.cuda, "host_memory_stats", None)
    held = None if stats is None else stats().get(
        "allocated_bytes.current")
    return "; ".join(
        f"{t['bytes'] / 2**20:.0f} MiB: wait {t['wait']:.3f} s, copy "
        f"{t['copy']:.3f} s, write {t['write']:.3f} s" for t in timings) + (
        "; pinned host memory held: " + ("not measured" if held is None
                                         else f"{held / 2**20:.0f} MiB"))


def encoder_training_phase(dev, cfg, image_size):
    """The encoders' training paths at cfg's widths (ResNet-152s): the
    tagger trainer (train.tagger.train, 2 epochs through the device image
    store, its checkpoint through cli.common.load_tagger_state bitwise and
    eval_tagger.evaluate_dataset on it, a resume that runs nothing), its
    step at float32 and bfloat16 on one batch, one step under each remat
    mode; then encoder fine-tuning (train.caption.train with
    fine_tune_encoder=True and embed_grad_impl="pallas", the tagger above
    as its tagger_checkpoint, a resume that restores the encoder's Adam
    bitwise).  Returns the launches of the fine-tune run."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from indonesian_image_captioning_tpu_torch.cli import common
    from indonesian_image_captioning_tpu_torch.core.config import (
        TaggerConfig, TrainConfig, tagger_train_config)
    from indonesian_image_captioning_tpu_torch.data.datasets import (
        CaptionDataset, TagDataset)
    from indonesian_image_captioning_tpu_torch.data.loader import \
        num_batches
    from indonesian_image_captioning_tpu_torch.evaluation import eval_tagger
    from indonesian_image_captioning_tpu_torch.models import encoders
    from indonesian_image_captioning_tpu_torch.ops import losses
    from indonesian_image_captioning_tpu_torch.train import (caption, steps,
                                                             tagger)

    rng = np.random.default_rng(SEED + 13)
    arch = cfg.encoder_arch
    n_train, n_val = ENC_IMAGES
    images = rng.integers(0, 256, size=(n_train + n_val, 3, image_size,
                                        image_size), dtype=np.uint8)
    tags = (rng.random((n_train + n_val, cfg.semantic_dim))
            < ENC_TAG_RATE).astype(np.float32)
    tag_train = TagDataset.from_arrays(images[:n_train], tags[:n_train],
                                       split="TRAIN")
    tag_val = TagDataset.from_arrays(images[n_train:], tags[n_train:],
                                     split="VAL")
    tagger_cfg = TaggerConfig(semantic_size=cfg.semantic_dim,
                              encoder_arch=arch)
    name = "smoke_corpus"
    steps_per_epoch = num_batches(n_train, B)
    workdir = tempfile.mkdtemp(prefix="encoder_training_")
    try:
        # ---- the tagger trainer --------------------------------------
        tcfg = tagger_train_config(epochs=ENC_EPOCHS, batch_size=B,
                                   print_freq=2, device_images="on",
                                   checkpoint_dir=workdir)
        logs = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, summary = tagger.train(tag_train, tag_val, tcfg, tagger_cfg,
                                      data_name=name, log=logs.append,
                                      device=dev)
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        losses_by_epoch = summary["step_losses"]
        check(sorted(losses_by_epoch) == list(range(ENC_EPOCHS))
              and all(len(v) == steps_per_epoch and np.isfinite(v).all()
                      for v in losses_by_epoch.values()),
              f"tagger step losses {losses_by_epoch}")
        check(any("device image store [TRAIN]" in x for x in logs),
              "the tagger trainer did not build the device image store")
        ckpt_path = Path(workdir) / f"checkpoint_tagger_{name}"
        check(ckpt_path.is_file(), f"{ckpt_path.name} missing")
        epoch_s = summary["timings"]["train_epoch"]
        print(f"encoder training: tagger trainer, {ENC_EPOCHS} epochs of "
              f"{steps_per_epoch} steps (B={B}, {n_train} TRAIN / {n_val} "
              f"VAL images at {image_size} px, {arch}, float32), "
              f"{t_run:.1f} s in all; epoch s (train imgs/s) " + ", ".join(
                  f"{epoch_s[e]:.3f} ({n_train / epoch_s[e]:.1f})"
                  for e in sorted(epoch_s))
              + f"; best accuracy {summary['best_metric']:.3f}; checkpoint "
              f"{ckpt_path.stat().st_size / 2**20:.0f} MiB; async saves: "
              + save_parts(summary["timings"].get("save", [])))

        again, s2 = tagger.train(tag_train, tag_val, tcfg, tagger_cfg,
                                 data_name=name, resume=True,
                                 log=lambda x: None, device=dev)
        check(s2["start_epoch"] == ENC_EPOCHS and not s2["step_losses"]
              and same_moments(adam_moments(again["opt_state"]),
                               adam_moments(state["opt_state"])),
              "the tagger's resume ran steps or changed Adam's state")
        del again
        # the trainer's image store turned the splits' pixels off
        tag_train.load_images = tag_val.load_images = True
        t0 = time.perf_counter()
        params, stats = common.load_tagger_state(str(ckpt_path), arch,
                                                 device=dev)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        n_leaves = same_tree(params, state["params"], "tagger params")
        n_leaves += same_tree(stats, state["stats"], "tagger statistics")
        acc = eval_tagger.evaluate_dataset(params, stats, tag_val,
                                           batch_size=B, arch=arch,
                                           log=lambda x: None, device=dev)
        plain = plain_tagger_accuracy(params, stats, tag_val, B, arch, dev)
        check(acc == plain, f"trained tagger accuracy {acc} against the "
              f"plain computation's {plain}")
        print(f"encoder training: tagger resume ran nothing, Adam bitwise; "
              f"load_tagger_state {t_load:.2f} s, {n_leaves} leaves "
              f"bitwise; eval_tagger accuracy {acc:.4f} (plain {plain:.4f})")
        del state, params, stats

        # ---- one batch at float32 and bfloat16 -----------------------
        batch = tag_train.gather(np.arange(B))
        batch["valid"] = np.ones(B, np.float32)
        first, grads = {}, {}
        for dtype in ("float32", "bfloat16"):
            opt = steps.make_optimizer(ENC_LR, 5.0)
            st = tagger.init_state(torch.Generator().manual_seed(SEED),
                                   tagger_cfg, opt, device=dev)
            damp_residuals(st["params"])
            step = steps.make_tagger_train_step(
                TrainConfig(batch_size=B, decoder_lr=ENC_LR,
                            tagger_dtype=dtype), opt, dropout_rate=0.0,
                arch=arch, device=dev)
            def one_step():
                loss = float(step(st, batch)[1]["loss"])
                if dtype not in grads:   # the first step's, clamped
                    grads[dtype] = {k: p.grad.clone() for k, p in tree_items(
                        st["params"]) if p.requires_grad}
                return loss

            torch.cuda.reset_peak_memory_stats()
            out, ms = timed_steps(one_step, ENC_DTYPE_STEPS)
            peak = torch.cuda.max_memory_allocated() / 2**30
            first[dtype] = out[0]
            check(out[-1] < out[0], f"{dtype} tagger loss did not fall: "
                  f"{out}")
            check(all(x.dtype == torch.float32 for x in
                      steps.tree_leaves(st["params"])
                      + steps.tree_leaves(st["stats"])),
                  f"{dtype}: a master weight or statistic left float32")
            med = statistics.median(ms[1:])
            by_kernel = {}
            busy = device_ms(lambda: step(st, batch), runs=1,
                             by_kernel=by_kernel)
            top = ", ".join(f"{k.split('(')[0][:40]} {v:.1f} ms" for k, v in
                            sorted(by_kernel.items(), key=lambda kv: -kv[1])
                            [:4])
            print(f"encoder training: tagger step {dtype}, B={B}: "
                  f"{med:.1f} ms (median of steps 2-{ENC_DTYPE_STEPS}), "
                  f"{1e3 * B / med:.1f} imgs/s, peak "
                  f"{peak:.2f} GiB; one step's kernels {busy:.1f} ms "
                  f"({len(by_kernel)} names), top: {top}; losses "
                  + ", ".join(f"{x:.4f}" for x in out))
            del st, opt, step
        rel, ab = DTYPE_FIRST_TOL
        check(abs(first["bfloat16"] - first["float32"])
              < rel * abs(first["float32"]) + ab,
              f"first-step losses {first}")
        cos = {k: float((a * grads["bfloat16"][k]).sum() / (
            a.norm() * grads["bfloat16"][k].norm()).clamp_min(1e-30))
            for k, a in grads["float32"].items()}
        head = [c for k, c in cos.items() if k.startswith("/linear/")]
        body = [c for k, c in cos.items() if k.startswith("/resnet/")]
        check(len(head) == 2 and len(body) > 0
              and min(head) >= DTYPE_HEAD_COS
              and statistics.median(body) >= DTYPE_BACKBONE_COS,
              f"bf16 first gradients against float32's: head cosines {head},"
              f" median ResNet leaf {statistics.median(body or [0.0])}")
        print(f"encoder training: tagger first step, bfloat16 against "
              f"float32: loss {first['bfloat16']:.6f} / "
              f"{first['float32']:.6f}; gradient cosines: head "
              f"{min(head):.6f} (limit {DTYPE_HEAD_COS}), {len(body)} ResNet "
              f"leaves min {min(body):.4f}, median "
              f"{statistics.median(body):.4f} (limit {DTYPE_BACKBONE_COS})")
        del grads

        # ---- remat: the same step's loss and gradients ----------------
        x = encoders.prep_images(torch.from_numpy(
            tag_train.gather_images(np.arange(REMAT_B))).to(dev))
        tag_rows = torch.from_numpy(tags[:REMAT_B]).to(dev)
        p0, s0 = encoders.init_encoder_tagger(
            torch.Generator().manual_seed(SEED), tagger_cfg, arch=arch,
            device=dev)
        damp_residuals(p0)
        steps.set_trainable(p0, steps.tagger_trainable_mask(p0))
        ref, report = None, []
        def remat_pass(remat):
            for p in steps.tree_leaves(p0):
                p.grad = None
            probs, _ = encoders.apply_encoder_tagger(
                p0, s0, x, train=True, arch=arch, remat=remat)
            loss = losses.bce_loss(probs, tag_rows)
            loss.backward()
            return loss.item()

        for remat in (False, "blocks", "convs"):
            remat_pass(remat)           # cuDNN's first call at these shapes
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            loss = remat_pass(remat)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            peak = (torch.cuda.max_memory_allocated() - base) / 2**30
            got = (loss, [p.grad.clone() for p in steps.tree_leaves(p0)
                          if p.grad is not None])
            if ref is None:
                ref = got
            else:
                check(abs(got[0] - ref[0]) <= REMAT_LOSS_TOL * abs(ref[0]),
                      f"remat {remat}: loss {got[0]} against {ref[0]}")
                worst = max(float((a - b).abs().max())
                            / max(float(a.abs().max()), 1e-30)
                            for a, b in zip(ref[1], got[1], strict=True))
                check(worst <= REMAT_GRAD_TOL, f"remat {remat}: gradient "
                      f"error {worst}")
            report.append(f"{remat}: {ms:.1f} ms, {peak:.2f} GiB")
        print(f"encoder training: remat at B={REMAT_B} (one forward and "
              "backward after a first; peak memory above what was held "
              "before it) " + "; ".join(report)
              + f"; losses within {REMAT_LOSS_TOL}, gradients within "
              f"{REMAT_GRAD_TOL}")
        del p0, s0, ref, got, x

        # ---- encoder fine-tuning --------------------------------------
        V, L = cfg.vocab_size, cfg.max_caption_len
        caps, lens = captions(rng, n_train + n_val, V, L)
        cap_train = CaptionDataset.from_arrays(
            images[:n_train], caps[:n_train], lens[:n_train], cpi=1,
            split="TRAIN")
        cap_val = CaptionDataset.from_arrays(
            images[n_train:], caps[n_train:], lens[n_train:], cpi=1,
            split="VAL")
        kcfg = dataclasses.replace(cfg, embed_grad_impl="pallas")
        ft_dir = os.path.join(workdir, "finetune")
        ft_cfg = TrainConfig(epochs=ENC_EPOCHS, batch_size=B, print_freq=2,
                             fine_tune_encoder=True,
                             calibrate_encoder_stats=1, device_images="on",
                             checkpoint_dir=ft_dir)
        captured = {}
        init_state, calibrate = caption.init_state, caption._calibrate

        def keep_init(*a, **kw):
            st = init_state(*a, **kw)
            captured["encoder"] = steps.map_tree(st["encoder"],
                                                 torch.clone)
            return st

        def keep_calibrated(st, *a, **kw):
            calibrate(st, *a, **kw)
            captured["stats"] = steps.map_tree(st["encoder_stats"],
                                               torch.clone)

        caption.init_state, caption._calibrate = keep_init, keep_calibrated
        try:
            logs = []
            torch.cuda.synchronize()
            zero_counters()
            t0 = time.perf_counter()
            ft_state, ft_sum = caption.train(
                "attention_scn", word_map(V), cap_train, cap_val, ft_cfg,
                model_cfg=kcfg, tagger_checkpoint=str(ckpt_path),
                data_name=name, log=logs.append, device=dev)
            torch.cuda.synchronize()
            t_ft = time.perf_counter() - t0
            launches = read_counters()
        finally:
            caption.init_state, caption._calibrate = init_state, calibrate
        n_val_steps = num_batches(n_val, B)
        check(launches["embed_grad_scatter"] == ENC_EPOCHS * steps_per_epoch
              and launches["train_fwd"] == ENC_EPOCHS * n_val_steps
              and launches["train_bwd"] == 0,
              f"fine-tune launches {launches}: kernel 14 once a train step, "
              "kernel 8 once a validation step, kernel 9 never")
        ft_losses = ft_sum["step_losses"]
        check(all(len(v) == steps_per_epoch and np.isfinite(v).all()
                  for v in ft_losses.values()) and len(ft_losses)
              == ENC_EPOCHS, f"fine-tune step losses {ft_losses}")
        resnet, before = ft_state["encoder"]["resnet"], captured["encoder"]
        for part in ("conv1", "bn1", "layer1"):
            same_tree(resnet[part], before["resnet"][part],
                      f"frozen encoder {part}")
        check(any(not torch.equal(a, b) for a, b in zip(
            steps.tree_leaves(resnet["layer4"]),
            steps.tree_leaves(before["resnet"]["layer4"]))),
              "fine-tuning left layer4 unchanged")
        check(not torch.equal(
            ft_state["encoder_stats"]["resnet"]["bn1"]["mean"],
            captured["stats"]["resnet"]["bn1"]["mean"]),
              "the stem's running mean did not move")
        ft_path = Path(ft_dir) / f"checkpoint_attention_scn_{name}"
        epoch_s = ft_sum["timings"]["train_epoch"]
        print(f"encoder training: fine-tune, {ENC_EPOCHS} epochs of "
              f"{steps_per_epoch} steps (B={B}, embed_grad_impl=pallas, "
              f"tagger from the tagger trainer), {t_ft:.1f} s in all; "
              "epoch s (step ms, train imgs/s) " + ", ".join(
                  f"{epoch_s[e]:.3f} ({1e3 * epoch_s[e] / steps_per_epoch:.1f}"
                  f", {n_train / epoch_s[e]:.1f})" for e in sorted(epoch_s))
              + f"; checkpoint {ft_path.stat().st_size / 2**20:.0f} MiB; "
              "async saves: " + save_parts(ft_sum["timings"].get("save", []))
              + "; conv1, bn1 and layer1 bitwise, layer4 and the stem's "
              "running mean moved")
        print("encoder training: fine-tune launches " + json.dumps(
            {k: launches[k] for k in ("train_fwd", "train_bwd",
                                      "embed_grad_scatter")}))
        again, s3 = caption.train(
            "attention_scn", word_map(V), cap_train, cap_val, ft_cfg,
            model_cfg=kcfg, tagger_checkpoint=str(ckpt_path),
            data_name=name, resume=True, log=lambda x: None, device=dev)
        check(s3["start_epoch"] == ENC_EPOCHS and not s3["step_losses"]
              and same_moments(adam_moments(again["enc_opt_state"]),
                               adam_moments(ft_state["enc_opt_state"])),
              "the fine-tune resume ran steps or lost the encoder's Adam "
              "state")
        print(f"encoder training: fine-tune resume restored the encoder's "
              f"Adam ({len(adam_moments(again['enc_opt_state']))} tensors, "
              "step counts included) bitwise")
        del again

        return launches
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def adam_moments(opt):
    """Adam's moments and step counts, in parameter order, from a
    torch.optim.Adam or its state_dict."""
    sd = opt.state_dict() if hasattr(opt, "state_dict") else opt
    return [t for _, st in sorted(sd["state"].items())
            for t in (st["step"], st["exp_avg"], st["exp_avg_sq"])]


def same_moments(a, b):
    import torch

    return len(a) == len(b) > 0 and all(
        torch.equal(x.cpu(), y.cpu()) for x, y in zip(a, b))


def train_breakdown(step, sub, batch, gen, B):
    """Where one train step's time goes: the host clock, the device busy
    share and the device time by kernel group from torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(sub, *batch, gen)
    torch.cuda.synchronize()
    t_step = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(sub, *batch, gen)
        torch.cuda.synchronize()
    kernels = [(e.self_device_time_total, e.key)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(t for t, _ in kernels) / 1e3
    groups = {"train scan (iic)": 0.0, "embed grad (iic)": 0.0,
              "cuBLAS/cuBLASLt GEMM": 0.0, "other PyTorch": 0.0}
    for t, k in kernels:
        if "iic::embed_" in k:       # kernel 14's launches
            groups["embed grad (iic)"] += t / 1e3
        elif k.startswith(("void iic::", "iic::")):
            groups["train scan (iic)"] += t / 1e3
        elif "gemm" in k.lower() or "sm90_" in k or "cutlass" in k:
            groups["cuBLAS/cuBLASLt GEMM"] += t / 1e3
        else:
            groups["other PyTorch"] += t / 1e3
    top = ", ".join(f"{k.split('(')[0][:48]} {t / 1e3:.2f} ms"
                    for t, k in sorted(kernels, reverse=True)[:4])
    print(f"train breakdown: one step of {B} images {1e3 * t_step:.1f} ms; "
          f"kernels {busy:.1f} ms of it ({100 * busy / (1e3 * t_step):.1f} "
          "% busy); " + ", ".join(f"{g} {v:.2f} ms" for g, v in
                                  groups.items()) + f"; top: {top}")


def module_from_state_dict(sd, class_name):
    """A module tree holding ``sd`` under its keys (tensors as parameters,
    the BatchNorm statistics as buffers), its root an instance of a class
    of a module that exists only while this process saves it: unpickling
    it elsewhere must stub the class, as a reference training-format
    checkpoint's classes are when the reference package is absent."""
    import types

    import torch

    mod = sys.modules.setdefault(REFERENCE_MODULE,
                                 types.ModuleType(REFERENCE_MODULE))
    cls = getattr(mod, class_name, None)
    if cls is None:
        cls = type(class_name, (torch.nn.Module,),
                   {"__module__": REFERENCE_MODULE})
        setattr(mod, class_name, cls)
    root = cls()
    for key, v in sd.items():
        *path, leaf = key.split(".")
        m = root
        for name in path:
            if name not in m._modules:
                m.add_module(name, torch.nn.Module())
            m = m._modules[name]
        if leaf.startswith("running_"):
            m.register_buffer(leaf, v)
        else:
            m.register_parameter(leaf, torch.nn.Parameter(
                v, requires_grad=False))
    return root


def checkpoint_files(state, cfg, directory):
    """Write the inference state three ways into ``directory``: the
    reference's serve format (a caption file of encoder and decoder
    state_dicts, a tagger file of one), its training format (whole
    modules of classes unresolvable at load, optimizers None) and the
    port's own checkpoint (``core.checkpoint.save_checkpoint``, its
    tagger inside).  Returns {family: (caption file, tagger file)}."""
    import torch

    from indonesian_image_captioning_tpu_torch.core import checkpoint
    from indonesian_image_captioning_tpu_torch.models import convert

    d = Path(directory)
    enc_sd = convert.encoder_caption_to_torch(state["encoder"],
                                              state["encoder_stats"])
    dec_sd = convert.decoder_to_torch(state["params"], cfg)
    tag_sd = convert.encoder_tagger_to_torch(state["tagger"],
                                             state["tagger_stats"])
    files = {"serve": (d / "serve_caption.pth.tar",
                       d / "serve_tagger.pth.tar"),
             "training": (d / "train_caption.pth.tar",
                          d / "train_tagger.pth.tar")}
    torch.save({"encoder_model_state_dict": enc_sd,
                "decoder_model_state_dict": dec_sd}, files["serve"][0])
    torch.save({"model_state_dict": tag_sd}, files["serve"][1])
    try:
        torch.save({"epoch": 3, "epochs_since_improvement": 0,
                    "bleu-4": 0.25,
                    "encoder": module_from_state_dict(enc_sd,
                                                      "EncoderCaption"),
                    "decoder": module_from_state_dict(dec_sd,
                                                      "AttentionSCN"),
                    "encoder_optimizer": None, "decoder_optimizer": None},
                   files["training"][0])
        torch.save({"epoch": 3, "epochs_since_improvement": 0,
                    "accuracy": 90.0,
                    "encoder": module_from_state_dict(tag_sd,
                                                      "EncoderTagger"),
                    "encoder_optimizer": None}, files["training"][1])
    finally:
        sys.modules.pop(REFERENCE_MODULE, None)
    own = checkpoint.save_checkpoint(
        str(d), cfg.model_type, "smoke", {"state": state, "epoch": 0,
                                          "epochs_since_improvement": 0,
                                          "metric": 0.0}, is_best=False)
    # the tagger trainer's layout, which init_state(tagger_checkpoint=) reads
    own_tagger = d / "checkpoint_tagger_smoke"
    checkpoint.save_pytree(str(own_tagger), {"state": {
        "params": state["tagger"], "stats": state["tagger_stats"]}})
    files["own"] = (Path(own), own_tagger)
    return files


def tree_items(tree, prefix=""):
    """(path, leaf) pairs of a nested dict/list tree, in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_items(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from tree_items(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def same_tree(got, want, label):
    """Every leaf of got bitwise want's, on want's device; returns the
    number of leaves."""
    import torch

    g, w = dict(tree_items(got)), dict(tree_items(want))
    check(g.keys() == w.keys(), f"{label}: the trees' paths differ: "
          f"{sorted(g.keys() ^ w.keys())[:6]}")
    for path, t in w.items():
        check(g[path].device == t.device and g[path].dtype == t.dtype
              and torch.equal(g[path], t),
              f"{label}: leaf {path} differs from the state it came from")
    return len(w)


def load_families(files, cfg, state, dev):
    """Load each family through ``cli.common`` onto ``dev``; every leaf
    must be bitwise the state's.  Returns {family: load seconds}."""
    import torch

    from indonesian_image_captioning_tpu_torch.cli import common

    seconds = {}
    want_tagger = {"params": state["tagger"], "stats": state["tagger_stats"]}
    for family, (cap, tag) in files.items():
        t0 = time.perf_counter()
        got = common.load_caption_state(str(cap), cfg, str(tag), device=dev)
        params, stats = common.load_tagger_state(str(tag), cfg.encoder_arch,
                                                 device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        seconds[family] = time.perf_counter() - t0
        n = same_tree(got, state, f"the {family} caption file")
        same_tree({"params": params, "stats": stats}, want_tagger,
                  f"the {family} tagger file")
        print(f"checkpoints: {family} format loaded onto {dev} in "
              f"{seconds[family]:.2f} s, {n} leaves bitwise the state's")
    return seconds


def eval_split(rng, cfg, n, image_size):
    """A seeded TEST split: n noise images, EVAL_CPI Zipf-drawn captions
    each, and multi-hot tags for the tagger's split.  Returns
    (CaptionDataset, TagDataset)."""
    import numpy as np

    from indonesian_image_captioning_tpu_torch.data.datasets import (
        CaptionDataset, TagDataset)

    caps, lens = captions(rng, n * EVAL_CPI, cfg.vocab_size,
                          cfg.max_caption_len)
    images = rng.integers(0, 256, size=(n, 3, image_size, image_size),
                          dtype=np.uint8)
    tags = (rng.random((n, cfg.semantic_dim)) < EVAL_TAG_RATE).astype(
        np.float32)
    return (CaptionDataset.from_arrays(images, caps, lens, cpi=EVAL_CPI,
                                       split="TEST"),
            TagDataset.from_arrays(images, tags, split="TEST"))


def direct_hypotheses(state, cfg, ds, wm, batch, dev):
    """Each image's beam by caption_beam_search called directly on the
    evaluation's batches (the last padded with image 0, as the evaluation
    pads it), as word lists without the special tokens; and the host
    seconds of the two encoders alone on those batches."""
    import numpy as np
    import torch

    from indonesian_image_captioning_tpu_torch.decode.api import \
        caption_beam_search
    from indonesian_image_captioning_tpu_torch.models import encoders

    rev = {i: w for w, i in wm.items()}
    skip = {wm["<start>"], wm["<end>"], wm["<pad>"]}
    hyps, t_enc = [], 0.0
    n = ds.num_images
    for b0 in range(0, n, batch):
        idx = np.arange(b0, min(b0 + batch, n))
        img_idx = np.concatenate([idx, np.zeros(batch - len(idx), np.int64)])
        with torch.inference_mode():
            x = encoders.prep_images(
                torch.from_numpy(ds.gather_images(img_idx)).to(dev))
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            enc = encoders.apply_encoder_caption(
                state["encoder"], state["encoder_stats"], x,
                enc_image_size=cfg.enc_image_size, arch=cfg.encoder_arch)[0]
            tags = encoders.apply_encoder_tagger(
                state["tagger"], state["tagger_stats"], x,
                arch=cfg.encoder_arch)[0]
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t_enc += time.perf_counter() - t0
            out = caption_beam_search(state["params"], cfg, enc, tags,
                                      start_id=wm["<start>"],
                                      end_id=wm["<end>"])
        seqs, lens = out["sequences"].cpu(), out["lengths"].cpu()
        for row in range(len(idx)):
            hyps.append([rev[int(w)] for w in seqs[row, :int(lens[row])]
                         if int(w) not in skip])
    return hyps, t_enc


def plain_tagger_accuracy(params, stats, ds, batch, arch, dev):
    """The evaluation's accuracy computed by hand: the tagger on the same
    batches (the last padded with image 0), each valid row's share of
    tags on the right side of 0.5 in float32, x100, and their mean."""
    import numpy as np
    import torch

    from indonesian_image_captioning_tpu_torch.models import encoders

    rows = []
    n = len(ds)
    for b0 in range(0, n, batch):
        idx = np.arange(b0, min(b0 + batch, n))
        img_idx = np.concatenate([idx, np.zeros(batch - len(idx), np.int64)])
        with torch.inference_mode():
            probs = encoders.apply_encoder_tagger(
                params, stats, encoders.prep_images(
                    torch.from_numpy(ds.gather_images(img_idx)).to(dev)),
                arch=arch)[0][:len(idx)]
            truth = torch.from_numpy(ds.tags[idx]).to(dev)
            agree = ((probs >= 0.5) == (truth >= 0.5)).to(torch.float32)
            rows.append((agree.mean(dim=1) * 100.0).cpu().numpy())
    return float(np.mean(np.concatenate(rows).astype(np.float64)))


def checkpoints_and_evaluation(dev, cfg, image_size, n_images=EVAL_IMAGES,
                               batch=EVAL_BATCH):
    """The load and evaluation paths: the seeded state (make_state)
    written as the reference's serve and training formats and the port's
    own checkpoint, each loaded back onto the card bitwise; a TEST split
    beam-decoded and scored (eval_caption.decode_dataset: kernel 7 on the
    card, each hypothesis equal to a direct caption_beam_search); the
    tagger's TEST accuracy (eval_tagger.evaluate_dataset) against a plain
    computation; one image through cli.inference.caption_image (kernel 1:
    the alphas recorded), its caption against caption_batch's but at a
    near-tie.  Returns the TEST hypotheses."""
    import importlib.util
    import tempfile

    import numpy as np
    import torch

    from indonesian_image_captioning_tpu_torch.cli import inference
    from indonesian_image_captioning_tpu_torch.core.config import BeamConfig
    from indonesian_image_captioning_tpu_torch.evaluation import (
        eval_caption, eval_tagger, metrics)
    from indonesian_image_captioning_tpu_torch.serve import (CaptionEngine,
                                                             ServeConfig)

    rng = np.random.default_rng(SEED)
    calib = rng.integers(0, 256, size=(batch, 3, image_size, image_size),
                         dtype=np.uint8)
    state = make_state(dev, cfg, calib)
    wm = word_map(cfg.vocab_size)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        files = checkpoint_files(state, cfg, tmp)
        print(f"checkpoints: three families written in "
              f"{time.perf_counter() - t0:.2f} s ("
              + ", ".join(f"{f} {sum(p.stat().st_size for p in set(ps)) / 1e6:.0f} MB"
                          for f, ps in files.items()) + ")")
        load_s = load_families(files, cfg, state, dev)

    # ---- TEST-split evaluation: counters zeroed just before, read after --
    caps_ds, tag_ds = eval_split(np.random.default_rng(SEED + 12), cfg,
                                 n_images, image_size)
    beam_cfg = BeamConfig(beam_size=K)
    sync()
    zero_counters()
    t0 = time.perf_counter()
    refs, hyps = eval_caption.decode_dataset(
        state, cfg, caps_ds, wm, beam_cfg=beam_cfg, batch_size=batch,
        log=lambda s: None, device=dev)
    sync()
    t_eval = time.perf_counter() - t0
    ran = read_counters()
    # ---------------------------------------------------------------------
    direct, t_enc = direct_hypotheses(state, cfg, caps_ds, wm, batch, dev)
    check(len(hyps) == len(refs) == n_images
          and all(len(r) == EVAL_CPI for r in refs),
          f"{len(hyps)} hypotheses and {len(refs)} reference sets for "
          f"{n_images} images")
    bad = [i for i, (a, b) in enumerate(zip(hyps, direct)) if a != b]
    check(not bad, f"evaluation hypotheses of images {bad[:8]} differ from "
          "a direct caption_beam_search's")
    if on_card:
        check(ran["fused_decode_span"] > 0 and ran["attend_fused"] == 0,
              f"the evaluation's decode ran kernel 7 "
              f"{ran['fused_decode_span']} times; launches {ran}")
    scores = metrics.compute_metrics(refs, hyps, include_cider=False,
                                     include_meteor=False)
    check(all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in scores.values()),
          f"scores out of [0, 1]: {scores}")
    has_nltk = importlib.util.find_spec("nltk") is not None
    print(f"evaluation: {n_images} TEST images at beam {K}, batch {batch}: "
          f"{t_eval:.3f} s, {n_images / t_eval:.1f} images/s (host clock, "
          f"ending in a synchronize); the two encoders alone "
          f"{t_enc:.3f} s, {100 * t_enc / t_eval:.1f} % of it; kernel 7 "
          f"launches {ran['fused_decode_span']}; hypotheses equal to direct "
          f"caption_beam_search {n_images}/{n_images}; scores {scores} "
          f"(METEOR left out: nltk importable here: {has_nltk})")

    # ---- the tagger's TEST accuracy ----
    sync()
    t0 = time.perf_counter()
    acc = eval_tagger.evaluate_dataset(
        state["tagger"], state["tagger_stats"], tag_ds, batch_size=batch,
        arch=cfg.encoder_arch, log=lambda s: None, device=dev)
    sync()
    t_tag = time.perf_counter() - t0
    plain = plain_tagger_accuracy(state["tagger"], state["tagger_stats"],
                                  tag_ds, batch, cfg.encoder_arch, dev)
    check(acc == plain, f"tagger accuracy {acc} against the plain "
          f"computation's {plain}")
    print(f"evaluation: tagger accuracy {acc:.4f} % on {n_images} TEST "
          f"images (the plain computation's {plain:.4f}), {t_tag:.3f} s, "
          f"{n_images / t_tag:.1f} images/s")

    # ---- inference on one image: counters zeroed just before, read after --
    image = caps_ds.image(0)
    rev_tags = {i: f"tag{i}" for i in range(cfg.semantic_dim)}
    zero_counters()
    got = inference.caption_image(state, cfg, image, wm, beam_cfg=beam_cfg,
                                  rev_tag_map=rev_tags, device=dev)
    ran_inf = read_counters()
    # ---------------------------------------------------------------------
    n = len(got["seq"])
    check(got["decode_impl"] == "steps" and got["alphas"].shape
          == (n, cfg.num_pixels), f"inference ran {got['decode_impl']} with "
          f"alphas {got['alphas'].shape} for {n} steps")
    if on_card:
        check(ran_inf["attend_fused"] > 0,
              f"inference launched kernel 1 {ran_inf['attend_fused']} times")
    a_err = float(np.abs(got["alphas"][1:].sum(-1) - 1).max()) if n > 1 \
        else 0.0
    check(a_err < 1e-3, f"inference alphas sum to 1 within {a_err}")
    check(len(got["tags"]) == min(20, cfg.semantic_dim)
          and all(0.0 <= p <= 1.0
                                         for _, p in got["tags"]),
          f"inference tags {got['tags'][:3]}")
    engine = CaptionEngine(state, cfg, wm, ServeConfig(batch_buckets=(1,)),
                           device=dev)
    ref_caption = engine.caption_batch(image[None])[0]
    tie = ""
    if got["caption"] != ref_caption:
        from indonesian_image_captioning_tpu_torch.decode.api import \
            caption_beam_search
        from indonesian_image_captioning_tpu_torch.models import encoders
        with torch.inference_mode():
            x = encoders.prep_images(torch.from_numpy(image[None]).to(dev))
            enc = encoders.apply_encoder_caption(
                state["encoder"], state["encoder_stats"], x,
                enc_image_size=cfg.enc_image_size, arch=cfg.encoder_arch)[0]
            tags = encoders.apply_encoder_tagger(
                state["tagger"], state["tagger_stats"], x,
                arch=cfg.encoder_arch)[0]
            ref = caption_beam_search(state["params"], cfg, enc, tags,
                                      start_id=wm["<start>"],
                                      end_id=wm["<end>"], beam_cfg=beam_cfg)
            L = ref["sequences"].shape[1]
            seq = torch.tensor(got["seq"] + [0] * (L - n), device=dev)
            mine = {"sequences": seq[None], "lengths":
                    torch.tensor([n], device=dev)}
            same_beams(state["params"], cfg, enc, tags, ref, mine,
                       "inference against caption_batch")
        tie = " (a near-tie: they differ)"
    print(f"inference: caption_image on one image, {n} tokens, decode "
          f"{got['decode_impl']}, kernel 1 launches "
          f"{ran_inf['attend_fused']}, alpha sums within {a_err:.2g} of 1; "
          f"caption equal to caption_batch's: "
          f"{got['caption'] == ref_caption}{tie}; top tags "
          f"{got['tags'][:3]}")
    print("checkpoints and evaluation: load s "
          + ", ".join(f"{f} {s:.2f}" for f, s in load_s.items())
          + f"; TEST images/s {n_images / t_eval:.1f}; tagger images/s "
          f"{n_images / t_tag:.1f}")
    return hyps


def dp_batches(dev, cfg, n, lens=None, seed=SEED + 20):
    """n seeded global caption batches of DP_B rows on dev: float32
    features (post-ReLU-like, uniform [0, 1)), tags, Zipf captions (lens
    lengths when given)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    P = cfg.enc_image_size
    out = []
    for _ in range(n):
        caps, caplens = captions(rng, DP_B, cfg.vocab_size,
                                 cfg.max_caption_len, lens)
        out.append({
            "enc": torch.rand((DP_B, P, P, cfg.encoder_dim), device=dev,
                              generator=gen),
            "tags": torch.rand((DP_B, cfg.semantic_dim), device=dev,
                               generator=gen),
            "caps": torch.from_numpy(caps).long().to(dev),
            "caplens": torch.from_numpy(caplens).long().to(dev)})
    return out


def leaf_errors(a, b):
    """(largest, median) absolute difference over the leaves of two
    parameter trees."""
    import torch

    from indonesian_image_captioning_tpu_torch.train.steps import \
        tree_leaves
    errs = [float((x.detach() - y.detach()).abs().max())
            for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True)]
    return max(errs), float(statistics.median(errs))


def dp_flat(tensors):
    """Tensors as one flat float32 vector."""
    import torch

    return torch.cat([t.detach().reshape(-1).to(torch.float32)
                      for t in tensors])


def dp_flat_grads(opt_state):
    """The gradients an optimizer's last step applied (clamped; under a
    mesh summed over the ranks), flat, in its parameters' order."""
    return dp_flat([p.grad for g in opt_state.param_groups
                    for p in g["params"]])


def rel_err(a, b):
    """|a - b| / |b| in the 2-norm, in float64."""
    return float((a.double() - b.double()).norm()
                 / b.double().norm().clamp_min(1e-300))


def leaf_rel(a, b):
    """The largest of each leaf's largest absolute difference over its
    largest absolute value (two lists of tensors)."""
    return max(float((x - y).abs().max() / y.abs().max().clamp_min(1e-30))
               for x, y in zip(a, b, strict=True))


def dp_snapshot(state, params_key, *other):
    """A train state before a step: its parameters' values, its
    optimizer's state_dict and copies of the ``other`` trees."""
    import copy

    from indonesian_image_captioning_tpu_torch.train.steps import (
        map_tree, tree_leaves)
    return ([p.detach().clone() for p in tree_leaves(state[params_key])],
            copy.deepcopy(state["opt_state"].state_dict()),
            {k: map_tree(state[k], lambda t: t.clone()) for k in other})


def dp_replay(state, params_key, snap, lr, run, *other):
    """Load a snapshot into a one-rank state and take one step (run());
    -> (its clamped gradients, its update in units of lr, its loss)."""
    import torch

    from indonesian_image_captioning_tpu_torch.train.steps import (
        map_tree, tree_leaves)
    leaves = tree_leaves(state[params_key])
    with torch.no_grad():
        for p, s in zip(leaves, snap[0], strict=True):
            p.copy_(s)
    state["opt_state"].load_state_dict(snap[1])
    for k in other:
        state[k] = map_tree(snap[2][k], lambda t: t.clone())
    loss = float(run()["loss"])
    return (dp_flat_grads(state["opt_state"]),
            (dp_flat(leaves) - dp_flat(snap[0])) / lr, loss)


def dp_rank(rank, port, tmp, glove):
    """One rank of the data-parallel phase (spawned; rank 0 also runs the
    one-rank references).  Writes its results to tmp/rank{rank}.pt."""
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from indonesian_image_captioning_tpu_torch.cli import common
    from indonesian_image_captioning_tpu_torch.core import meshes, profiling
    from indonesian_image_captioning_tpu_torch.core.config import (
        ModelConfig, TaggerConfig, TrainConfig, tagger_train_config)
    from indonesian_image_captioning_tpu_torch.core.runtime import \
        get_device
    from indonesian_image_captioning_tpu_torch.data.datasets import \
        CaptionDataset
    from indonesian_image_captioning_tpu_torch.models import (decoders,
                                                              encoders)
    from indonesian_image_captioning_tpu_torch.parallel import sharding
    from indonesian_image_captioning_tpu_torch.parallel import \
        train_step as ptrain
    from indonesian_image_captioning_tpu_torch.train import caption, steps
    from indonesian_image_captioning_tpu_torch.train.steps import \
        tree_leaves
    from indonesian_image_captioning_tpu_torch.utils import embedding

    dev = get_device("cuda")
    meshes.initialize_distributed(
        init_method=f"tcp://localhost:{port}", world_size=DP_RANKS,
        rank=rank, backend="gloo", device="cuda", timeout_s=DP_TIMEOUT_S)
    mesh = meshes.make_mesh((DP_RANKS, 1))
    res = {"backend": dist.get_backend(), "device": str(dev)}
    cfg = ModelConfig(model_type="attention_scn", vocab_size=VOCAB,
                      embed_grad_impl="pallas", dropout=0.0)
    tcfg = TrainConfig(batch_size=DP_B)
    lr = tcfg.decoder_lr
    wm = word_map(VOCAB)
    t0 = time.perf_counter()
    emb, _ = embedding.load_embeddings(glove, wm, seed=SEED)
    res["embedding_load_s"] = time.perf_counter() - t0

    def fresh():
        params = decoders.init_decoder(
            torch.Generator().manual_seed(SEED + 20), cfg, device=dev)
        params = decoders.load_pretrained_embeddings(params, emb)
        opt = steps.make_optimizer(lr, tcfg.grad_clip)
        return {"params": params, "opt_state": opt.init(params)}, opt

    def one_rank(batches):
        """The same global batches through one rank's step (rank 0)."""
        sub, opt = fresh()
        _, step = steps.make_caption_train_step(cfg, tcfg, opt, device=dev)
        it = iter(batches)

        def run():
            b = next(it)
            return step(sub, b["enc"], b["tags"], b["caps"], b["caplens"])[1]

        out, ms = timed_steps(run, len(batches))
        return sub, [float(m["loss"]) for m in out], ms

    # one rank's step, replayed from the data-parallel state before a step
    ref, ref_opt = fresh()
    _, ref_step = steps.make_caption_train_step(cfg, tcfg, ref_opt,
                                                device=dev)

    def replay(snap, batch, rows=slice(None)):
        b = {k: v[rows] for k, v in batch.items()}
        return dp_replay(ref, "params", snap, lr, lambda: ref_step(
            ref, b["enc"], b["tags"], b["caps"], b["caplens"])[1])

    # ---- the caption steps: counters zeroed just before, read after ----
    batches = dp_batches(dev, cfg, DP_STEPS)
    sub, opt = fresh()
    sharding.place_state(mesh, sub)
    step = ptrain.make_parallel_caption_train_step(cfg, tcfg, opt, mesh,
                                                   device=dev)
    local = [sharding.place_batch(mesh, b) for b in batches]
    on_card = [str(t.device) for t in tree_leaves(sub["params"])
               + [t for b in local for t in b.values()]]
    check(set(on_card) == {"cuda:0"}, f"rank {rank}: tensors on "
          f"{sorted(set(on_card))}")
    timer = profiling.StepTimer()
    snaps, grads = [], []
    torch.cuda.synchronize()
    zero_counters()
    metrics = []
    for b in local:
        snaps.append(dp_snapshot(sub, "params"))
        timer.start()
        _, m = step(sub, b["enc"], b["tags"], b["caps"], b["caplens"])
        timer.stop(m)
        grads.append(dp_flat_grads(sub["opt_state"]))
        metrics.append({k: float(v) for k, v in m.items()})
    ran = read_counters()
    # ---------------------------------------------------------------------
    after = dp_flat(tree_leaves(sub["params"]))
    res.update(launches=ran, step_s=list(timer.times),
               timer=timer.summary(), metrics=metrics,
               rows=int(local[0]["caps"].shape[0]),
               digest=[float(after.double().sum()),
                       float(grads[-1].double().sum())])
    check(all(np.isfinite(m["loss"]) for m in metrics),
          f"rank {rank}: losses {metrics}")
    if rank == 0:
        # each step against one rank's from the same state on the same
        # global batch: the summed, clamped gradients, the update (in lr)
        # and the loss; the control is rank 0's rows alone (its own mean,
        # nothing summed), which must fail the same limits
        moved = [dp_flat(s[0]) for s in snaps] + [after]
        cmp = []
        for i, (snap, b) in enumerate(zip(snaps, batches)):
            g, u, loss = replay(snap, b)
            cmp.append({"grad": rel_err(grads[i], g),
                        "update": rel_err((moved[i + 1] - moved[i]) / lr,
                                          u),
                        "loss": abs(metrics[i]["loss"] - loss) / loss})
            if i == 0:
                g0, u0 = g, u
        g, u, _ = replay(snaps[0], batches[0], slice(0, DP_B // DP_RANKS))
        ref3, losses, ms = one_rank(batches)
        res.update(cmp=cmp, control={"grad": rel_err(g, g0),
                                     "update": rel_err(u, u0)},
                   one_rank_ms=ms, one_rank_losses=losses,
                   param_rel=rel_err(after - moved[0],
                                     dp_flat(tree_leaves(ref3["params"]))
                                     - moved[0]),
                   param_err=leaf_errors(sub["params"], ref3["params"]))
        del ref3, moved
    del snaps, grads
    meshes.barrier(mesh)

    # ---- the gradient all_reduce alone: a flat buffer of its size ----
    buf = torch.zeros(after.numel() + 4, device=dev)
    ar = []
    for _ in range(DP_STEPS):
        meshes.barrier(mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(buf)
        torch.cuda.synchronize()
        ar.append(time.perf_counter() - t0)
    res.update(all_reduce_s=ar, grad_mb=4 * buf.numel() / 2**20)
    del buf

    # ---- two halves whose token counts differ by at least 2x ----
    lens = [cfg.max_caption_len] * (DP_B // 2) + [4] * (DP_B // 2)
    uneven = dp_batches(dev, cfg, 1, lens=lens, seed=SEED + 22)
    sub, opt = fresh()
    step = ptrain.make_parallel_caption_train_step(cfg, tcfg, opt, mesh,
                                                   device=dev)
    b = sharding.place_batch(mesh, uneven[0])
    snap = dp_snapshot(sub, "params")
    _, m = step(sub, b["enc"], b["tags"], b["caps"], b["caplens"])
    res["uneven"] = {"tokens": int((b["caplens"] - 1).sum()),
                     "loss": float(m["loss"])}
    if rank == 0:
        # against one rank's step on the whole batch; the controls: rank
        # 0's half alone, and the mean of the two halves' own-mean
        # gradients (DDP's average), both of which must fail the limit
        g, u, loss = replay(snap, uneven[0])
        u_dp = (dp_flat(tree_leaves(sub["params"])) - dp_flat(snap[0])) / lr
        half = DP_B // DP_RANKS
        ga, _, la = replay(snap, uneven[0], slice(0, half))
        gb, _, lb = replay(snap, uneven[0], slice(half, None))
        res["uneven"].update(
            one_rank_loss=loss,
            grad=rel_err(dp_flat_grads(sub["opt_state"]), g),
            update=rel_err(u_dp, u),
            own=rel_err(ga, g), ddp=rel_err((ga + gb) / 2, g),
            ddp_loss=abs((la + lb) / 2 - loss) / loss)
    del snap
    del ref, ref_opt
    meshes.barrier(mesh)

    # ---- one step inside the profiler, with its annotation ----
    trace_dir = os.path.join(tmp, "trace")
    for attempt in range(PROFILE_TRIES):
        if rank == 0:
            with profiling.trace(trace_dir):
                for _ in range(PROFILE_LEAD):
                    torch.cuda._sleep(1000)
                torch.cuda.synchronize()
                with profiling.annotate("train_step"):
                    _, m = step(sub, b["enc"], b["tags"], b["caps"],
                                b["caplens"])
                    torch.cuda.synchronize()
            with open(os.path.join(trace_dir, profiling.TRACE_FILE)) as f:
                names = {e.get("name", "") for e in
                         json.load(f)["traceEvents"]}
            found = {"annotation": "train_step" in names,
                     "kernel 8": any("train_attend_kernel" in n
                                     for n in names),
                     "kernel 9": any("train_att_bwd_kernel" in n
                                     for n in names)}
            again = torch.tensor([0 if all(found.values()) else 1])
        else:
            _, m = step(sub, b["enc"], b["tags"], b["caps"], b["caplens"])
            again = torch.tensor([0])
        dist.broadcast(again, 0)
        if not int(again):
            break
    if rank == 0:
        res["trace"] = dict(found, takes=attempt + 1)
        check(all(found.values()), f"the trace of one step holds {found}")

    # ---- the trainer at mesh (2, 1): one epoch, rank 0's checkpoint ----
    rng = np.random.default_rng(SEED + 23)

    def split(n, name):
        caps, caplens = captions(rng, n * TRAINER_CPI, VOCAB,
                                 cfg.max_caption_len)
        images = rng.integers(0, 256, size=(n, 3, IMAGE_SIZE, IMAGE_SIZE),
                              dtype=np.uint8)
        return CaptionDataset.from_arrays(images, caps, caplens,
                                          cpi=TRAINER_CPI, split=name)

    train_ds, val_ds = (split(n, name) for n, name in
                        zip(DP_TRAINER_IMAGES, ("TRAIN", "VAL")))
    ckdir = os.path.join(tmp, "checkpoints")
    ttcfg = TrainConfig(epochs=1, batch_size=DP_B, print_freq=5,
                        cache_features=True, calibrate_encoder_stats=1,
                        checkpoint_dir=ckdir, mesh_shape=(DP_RANKS, 1))
    kcfg = ModelConfig(model_type="attention_scn", vocab_size=VOCAB,
                       embed_grad_impl="pallas")
    torch.cuda.synchronize()
    zero_counters()
    t0 = time.perf_counter()
    state, summary = caption.train("attention_scn", wm, train_ds, val_ds,
                                   ttcfg, model_cfg=kcfg,
                                   data_name="dp_corpus",
                                   log=lambda line: None, device=dev)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    ran = read_counters()
    n_train = len(train_ds) // DP_B
    n_val = -(-len(val_ds) // DP_B)
    check(ran["train_bwd"] == ran["embed_grad_scatter"] == n_train
          and ran["train_fwd"] == n_train + n_val,
          f"rank {rank}: the trainer's epoch ran kernels 8, 9 and 14 "
          f"{ran['train_fwd']}, {ran['train_bwd']} and "
          f"{ran['embed_grad_scatter']} times in {n_train} train and "
          f"{n_val} validation steps")
    check(all(np.isfinite(summary["step_losses"][0])),
          f"rank {rank}: trainer losses {summary['step_losses']}")
    meshes.barrier(mesh)
    t0 = time.perf_counter()
    loaded = common.load_caption_state(
        os.path.join(ckdir, "checkpoint_attention_scn_dp_corpus"), kcfg,
        device=dev)
    t_load = time.perf_counter() - t0
    for key in ("params", "encoder", "encoder_stats", "tagger",
                "tagger_stats"):
        same = all(torch.equal(x, y) for x, y in zip(
            tree_leaves(loaded[key]), tree_leaves(state[key]), strict=True))
        check(same, f"rank {rank}: rank 0's checkpoint differs from this "
              f"rank's {key}")
    res["trainer"] = {"s": t_run, "load_s": t_load,
                      "epoch_s": summary["timings"]["train_epoch"][0],
                      "cache_s": summary["timings"]["cache_build"],
                      "train_loss": summary["train_loss"],
                      "bleu4": summary["best_metric"],
                      "steps": n_train, "launches": ran}
    del state, loaded
    meshes.barrier(mesh)

    # ---- the tagger: DP_TAGGER_STEPS steps at float32 ----
    rng = np.random.default_rng(SEED + 24)
    tagger_cfg = TaggerConfig()
    tbatches = [{
        "images": torch.from_numpy(rng.integers(
            0, 256, size=(DP_TAGGER_B, 3, IMAGE_SIZE, IMAGE_SIZE),
            dtype=np.uint8)).to(dev),
        "tags": torch.from_numpy((rng.random(
            (DP_TAGGER_B, tagger_cfg.semantic_size)) < ENC_TAG_RATE
        ).astype(np.float32)).to(dev)} for _ in range(DP_TAGGER_STEPS)]
    ttc = tagger_train_config(batch_size=DP_TAGGER_B)

    def tagger_state():
        params, stats = encoders.init_encoder_tagger(
            torch.Generator().manual_seed(SEED + 25), tagger_cfg,
            device=dev)
        damp_residuals(params)
        topt = steps.make_optimizer(ttc.decoder_lr, ttc.grad_clip)
        return {"params": params, "stats": stats,
                "opt_state": topt.init(params)}, topt

    tstate, topt = tagger_state()
    sharding.place_state(mesh, tstate)
    tstep = ptrain.make_parallel_tagger_train_step(ttc, topt, mesh,
                                                   dropout_rate=0.0,
                                                   device=dev)
    tsnaps, tgrads, tstats, tout, tms = [], [], [], [], []
    for tb in tbatches:
        tsnaps.append(dp_snapshot(tstate, "params", "stats"))
        part = sharding.place_batch(mesh, tb)
        out, ms = timed_steps(lambda: tstep(tstate, part)[1], 1)
        tout += out
        tms += ms
        tgrads.append(dp_flat_grads(tstate["opt_state"]))
        tstats.append([t.clone() for t in tree_leaves(tstate["stats"])])
    res["tagger"] = {"losses": [float(m["loss"]) for m in tout], "ms": tms}
    if rank == 0:
        # each step against one rank's from the same state on the whole
        # batch: the loss, the new running statistics, the gradients and
        # the update; the control, rank 0's rows alone
        one, topt1 = tagger_state()
        step1 = steps.make_tagger_train_step(ttc, topt1, dropout_rate=0.0,
                                             device=dev)
        tlr = ttc.decoder_lr

        def treplay(snap, tb, rows=slice(None)):
            part = {k: v[rows] for k, v in tb.items()}
            g, u, loss = dp_replay(one, "params", snap, tlr,
                                   lambda: step1(one, part)[1], "stats")
            return g, u, loss, tree_leaves(one["stats"])

        moved = [dp_flat(s[0]) for s in tsnaps] + [
            dp_flat(tree_leaves(tstate["params"]))]
        cmp = []
        for i, (snap, tb) in enumerate(zip(tsnaps, tbatches)):
            g, u, loss, stats = treplay(snap, tb)
            cmp.append({
                "loss": abs(res["tagger"]["losses"][i] - loss) / loss,
                "stats": leaf_rel(tstats[i], stats),
                "grad": rel_err(tgrads[i], g),
                "update": rel_err((moved[i + 1] - moved[i]) / tlr, u)})
            if i == 0:
                g0, u0, s0 = g, u, stats
        g, u, _, stats = treplay(tsnaps[0], tbatches[0],
                                 slice(0, DP_TAGGER_B // DP_RANKS))
        res["tagger"].update(
            cmp=cmp, control={"grad": rel_err(g, g0),
                              "update": rel_err(u, u0),
                              "stats": leaf_rel(stats, s0)})
        del one
    del tsnaps, tgrads, tstats
    meshes.barrier(mesh)
    torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))
    dist.destroy_process_group()


def nccl_rank(rank, port):
    """Two ranks on cuda:0 over NCCL: one all_reduce (NCCL refuses a card
    shared by two ranks)."""
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=DP_RANKS, rank=rank)
    try:
        x = torch.ones(1, device="cuda")
        dist.all_reduce(x)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()


def spawn(fn, args, timeout_s, nprocs=DP_RANKS):
    """Run fn(rank, *args) on nprocs spawned processes; -> None, or the
    first failure's text.  Processes still running at timeout_s are
    killed."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                             start_method="spawn")
    deadline = time.perf_counter() + timeout_s
    try:
        while not ctx.join(timeout=2):
            if time.perf_counter() > deadline:
                return f"still running after {timeout_s} s"
    except Exception as e:  # a rank raised or died: its text
        return f"{type(e).__name__}: {e}"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    return None


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def data_parallel_phase(dev, cfg, card, hyps):
    """The data-parallel phase: DP_RANKS ranks on the one card over gloo
    (the NCCL refusal probed first), caption steps held against one
    rank's, the trainer at mesh (2, 1), the tagger steps, a profiled step;
    and corpus_score over the evaluation's TEST hypotheses."""
    import tempfile

    import numpy as np
    import torch

    from indonesian_image_captioning_tpu_torch.cli import corpus_score
    from indonesian_image_captioning_tpu_torch.core.config import \
        TrainConfig
    from indonesian_image_captioning_tpu_torch.utils import embedding

    t_phase = time.perf_counter()
    counts = corpus_score.unigram([[str(w) for w in h] for h in hyps])
    ppl = corpus_score.perplexity([[str(w) for w in h] for h in hyps],
                                  counts)
    check(np.isfinite(ppl) and ppl >= 1.0, f"perplexity {ppl}")
    print(f"corpus score: the evaluation's {len(hyps)} TEST hypotheses, "
          f"{sum(counts.values())} tokens, {len(counts)} distinct words, "
          f"unigram perplexity {ppl:.3f}")

    nccl = spawn(nccl_rank, (free_port(),), DP_NCCL_TIMEOUT_S)
    first = (nccl or "no error").strip().splitlines()
    dup = [x for x in first if "uplicate GPU" in x]
    print("data parallel: NCCL with two ranks on cuda:0: "
          + (dup[0].strip()[:200] if dup else (first[-1][:200] if first
                                                else "")))

    rng = np.random.default_rng(SEED + 26)
    wm = word_map(VOCAB)
    with tempfile.TemporaryDirectory() as tmp:
        glove = os.path.join(tmp, "glove.txt")
        words = [w for w in wm if w.startswith("w")]
        vecs = (rng.standard_normal((len(words), cfg.embed_dim)) * 0.1
                ).astype(np.float32)
        t0 = time.perf_counter()
        with open(glove, "w") as f:
            for w, v in zip(words, vecs):
                f.write(w + " " + " ".join(map(repr, v.tolist())) + "\n")
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        emb, dim = embedding.load_embeddings(glove, wm, seed=SEED)
        t_load = time.perf_counter() - t0
        rows = np.asarray([wm[w] for w in words])
        check(dim == cfg.embed_dim and emb.shape == (VOCAB, cfg.embed_dim)
              and np.array_equal(emb[rows], vecs),
              "load_embeddings' rows differ from the file's")
        print(f"embedding: a GloVe-format file of {len(words)} words x "
              f"{dim} written in {t_write:.2f} s, loaded by "
              f"utils/embedding.load_embeddings in {t_load:.2f} s, its "
              f"rows bitwise the file's, {VOCAB - len(words)} rows drawn")

        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        failed = spawn(dp_rank, (free_port(), tmp, glove), DP_TIMEOUT_S)
        t_ranks = time.perf_counter() - t0
        if failed:
            raise SmokeFailure(f"data-parallel ranks: {failed}")
        r = [torch.load(os.path.join(tmp, f"rank{i}.pt"), weights_only=False)
             for i in range(DP_RANKS)]

    for i, x in enumerate(r):
        check(x["backend"] == "gloo" and x["device"] == "cuda",
              f"rank {i} ran on {x['backend']} / {x['device']}")
        want = {"train_fwd": DP_STEPS, "train_bwd": DP_STEPS,
                "embed_grad_scatter": DP_STEPS}
        got = {k: x["launches"][k] for k in want}
        check(got == want, f"rank {i} launched {got} in {DP_STEPS} steps")
        check(x["metrics"] == r[0]["metrics"]
              and x["digest"] == r[0]["digest"],
              f"rank {i}'s metrics or parameters differ from rank 0's")
    lr = TrainConfig().decoder_lr
    worst = {k: max(c[k] for c in r[0]["cmp"])
             for k in ("grad", "update", "loss")}
    ctl = r[0]["control"]
    check(worst["grad"] <= DP_GRAD_TOL and worst["update"] <= DP_UPDATE_TOL
          and worst["loss"] <= DP_LOSS_TOL,
          f"{DP_STEPS} data-parallel steps against one rank's from the same "
          f"state: {r[0]['cmp']} (limits: gradients {DP_GRAD_TOL}, update "
          f"{DP_UPDATE_TOL}, loss {DP_LOSS_TOL})")
    check(ctl["grad"] > DP_GRAD_TOL and ctl["update"] > DP_UPDATE_TOL,
          f"the control (rank 0's rows alone, nothing summed) passes the "
          f"limits: {ctl}")
    prel = r[0]["param_rel"]
    err, med = r[0]["param_err"]
    check(prel <= DP_PARAM_TOL, f"the parameters' movement over {DP_STEPS} "
          f"data-parallel steps {prel} from one rank's own run's (limit "
          f"{DP_PARAM_TOL})")
    u = [x["uneven"] for x in r]
    urel = abs(u[0]["loss"] - u[0]["one_rank_loss"]) / u[0]["one_rank_loss"]
    check(u[0]["tokens"] >= 2 * u[1]["tokens"]
          and u[0]["grad"] <= DP_GRAD_TOL
          and u[0]["update"] <= DP_UPDATE_TOL and urel <= DP_LOSS_TOL,
          f"two halves of {u[0]['tokens']} and {u[1]['tokens']} tokens: "
          f"gradients {u[0]['grad']} (limit {DP_GRAD_TOL}), update "
          f"{u[0]['update']} (limit {DP_UPDATE_TOL}), loss {urel} "
          f"(limit {DP_LOSS_TOL}) from one rank's")
    check(min(u[0]["own"], u[0]["ddp"]) > DP_GRAD_TOL
          and u[0]["ddp_loss"] > DP_LOSS_TOL,
          f"the halves' controls pass the limits: gradients, rank 0's own "
          f"mean {u[0]['own']}, DDP's average {u[0]['ddp']}; DDP's loss "
          f"{u[0]['ddp_loss']}")
    tr = [x["trainer"] for x in r]
    tg = r[0]["tagger"]
    tworst = {k: max(c[k] for c in tg["cmp"])
              for k in ("loss", "stats", "grad", "update")}
    tctl = tg["control"]
    check(r[1]["tagger"]["losses"] == tg["losses"]
          and max(tworst["loss"], tworst["stats"]) <= DP_TAGGER_TOL
          and tworst["grad"] <= DP_TAGGER_GRAD_TOL
          and tworst["update"] <= DP_TAGGER_UPDATE_TOL,
          f"tagger steps against one rank's from the same state: "
          f"{tg['cmp']} (limits: loss and statistics {DP_TAGGER_TOL}, "
          f"gradients {DP_TAGGER_GRAD_TOL}, update {DP_TAGGER_UPDATE_TOL})")
    check(tctl["grad"] > DP_TAGGER_GRAD_TOL
          and tctl["stats"] > DP_TAGGER_TOL
          and tctl["update"] > DP_TAGGER_UPDATE_TOL,
          f"the tagger's control (rank 0's rows alone) passes the limits: "
          f"{tctl}")

    def ms(xs):
        return ", ".join(f"{1e3 * v:.1f}" for v in xs)

    def g(x):
        return f"{x:.3g}"

    print(f"data parallel: {card}; {DP_RANKS} ranks on cuda:0 over gloo "
          f"(the transport: NCCL refuses two ranks on one card), every "
          f"tensor of the steps on cuda:0; embedding loads "
          + ", ".join(f"{x['embedding_load_s']:.2f}" for x in r) + " s")
    print(f"data parallel: {DP_STEPS} caption steps at a global B={DP_B} "
          f"({r[0]['rows']} rows a rank), attention_scn V={VOCAB}, "
          f"embed_grad_impl=pallas: step ms rank 0 [{ms(r[0]['step_s'])}], "
          f"rank 1 [{ms(r[1]['step_s'])}]; one rank on the whole batch "
          f"[{', '.join(f'{v:.1f}' for v in r[0]['one_rank_ms'])}]; gradient "
          f"all_reduce alone ({r[0]['grad_mb']:.1f} MiB, host clock between "
          f"two synchronizes) ms rank 0 [{ms(r[0]['all_reduce_s'])}], rank 1 "
          f"[{ms(r[1]['all_reduce_s'])}]; launches a rank (8, 9, 14) "
          f"{DP_STEPS} each; StepTimer.summary() rank 0 {r[0]['timer']}")
    print(f"data parallel: each step against one rank's from the same state "
          f"on the same global batch, relative in the 2-norm: gradients "
          f"(summed, clamped) [{', '.join(g(c['grad']) for c in r[0]['cmp'])}]"
          f" (limit {DP_GRAD_TOL}), update "
          f"[{', '.join(g(c['update']) for c in r[0]['cmp'])}] (limit "
          f"{DP_UPDATE_TOL}), loss "
          f"[{', '.join(g(c['loss']) for c in r[0]['cmp'])}] (limit "
          f"{DP_LOSS_TOL}); the control, rank 0's rows alone, nothing "
          f"summed: gradients {g(ctl['grad'])}, update {g(ctl['update'])} "
          f"(both must exceed the limits); the parameters' movement over "
          f"{DP_STEPS} steps against one rank's own run {g(prel)} (limit "
          f"{DP_PARAM_TOL}), the largest weight's difference {g(err / lr)} "
          f"lr (median leaf {g(med / lr)} lr)")
    print(f"data parallel: two halves of {u[0]['tokens']} and "
          f"{u[1]['tokens']} tokens: gradients within {g(u[0]['grad'])} "
          f"(limit {DP_GRAD_TOL}), update {g(u[0]['update'])} (limit "
          f"{DP_UPDATE_TOL}), loss {g(urel)} (limit {DP_LOSS_TOL}); "
          f"controls: gradients, rank 0's own mean {g(u[0]['own'])} and "
          f"DDP's average of the halves' means {g(u[0]['ddp'])} (both must "
          f"exceed {DP_GRAD_TOL}), DDP's loss {g(u[0]['ddp_loss'])} (must "
          f"exceed {DP_LOSS_TOL})")
    print(f"data parallel: profiled step (rank 0, core.profiling.trace): "
          f"{r[0]['trace']}")
    print(f"data parallel: train.caption.train at mesh ({DP_RANKS}, 1), 1 "
          f"epoch of {tr[0]['steps']} steps, feature cache on the host: "
          + "; ".join(f"rank {i} {t['s']:.1f} s in all, epoch "
                      f"{t['epoch_s']:.3f} s, cache {t['cache_s']:.3f} s, "
                      f"checkpoint load {t['load_s']:.2f} s"
                      for i, t in enumerate(tr))
          + f"; train_loss {tr[0]['train_loss']:.4f}, BLEU-4 "
          f"{tr[0]['bleu4']:.3g}; rank 0's checkpoint bitwise both ranks' "
          "state")
    print(f"data parallel: tagger, {DP_TAGGER_STEPS} steps at f32, global "
          f"B={DP_TAGGER_B}, 256 px, each against one rank's from the same "
          f"state: loss [{', '.join(g(c['loss']) for c in tg['cmp'])}], "
          f"running statistics "
          f"[{', '.join(g(c['stats']) for c in tg['cmp'])}] (limit "
          f"{DP_TAGGER_TOL}), gradients "
          f"[{', '.join(g(c['grad']) for c in tg['cmp'])}] (limit "
          f"{DP_TAGGER_GRAD_TOL}), update "
          f"[{', '.join(g(c['update']) for c in tg['cmp'])}] (limit "
          f"{DP_TAGGER_UPDATE_TOL}); the control, rank 0's rows alone: "
          f"gradients {g(tctl['grad'])}, statistics {g(tctl['stats'])}, update "
          f"{g(tctl['update'])}; losses {tg['losses']}; step ms rank 0 "
          f"[{', '.join(f'{v:.1f}' for v in tg['ms'])}]")
    print(f"data parallel: the ranks {t_ranks:.1f} s; the phase "
          f"{time.perf_counter() - t_phase:.1f} s")


def digest(tensors):
    """A hash of tensors' bytes: equal digests, bitwise-equal tensors."""
    import hashlib

    h = hashlib.sha1()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def ma_blocks(leaves, dims, mesh):
    """Whole-vocabulary leaves (tree_leaves order) cut to this rank's
    vocabulary block where ``dims`` (index: dimension) says so."""
    from indonesian_image_captioning_tpu_torch.core import meshes

    out = []
    for i, t in enumerate(leaves):
        if i in dims:
            col0, width = meshes.vocab_block(t.shape[dims[i]], mesh)
            t = t.narrow(dims[i], col0, width)
        out.append(t)
    return out


def ma_rank(rank, port, tmp):
    """One rank of the model-axis phase (spawned).  Writes its results to
    tmp/rank{rank}.pt."""
    import copy

    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from indonesian_image_captioning_tpu_torch.cli import common
    from indonesian_image_captioning_tpu_torch.core import meshes
    from indonesian_image_captioning_tpu_torch.core.config import (
        BeamConfig, ModelConfig, TrainConfig)
    from indonesian_image_captioning_tpu_torch.core.runtime import \
        get_device
    from indonesian_image_captioning_tpu_torch.data.datasets import \
        CaptionDataset
    from indonesian_image_captioning_tpu_torch.evaluation import \
        eval_caption
    from indonesian_image_captioning_tpu_torch.models import decoders
    from indonesian_image_captioning_tpu_torch.parallel import sharding
    from indonesian_image_captioning_tpu_torch.parallel import \
        train_step as ptrain
    from indonesian_image_captioning_tpu_torch.train import caption, steps
    from indonesian_image_captioning_tpu_torch.train.steps import (
        map_tree, tree_leaves)

    dev = get_device("cuda")
    n_ranks = MA_MESH[0] * MA_MESH[1]
    meshes.initialize_distributed(
        init_method=f"tcp://localhost:{port}", world_size=n_ranks,
        rank=rank, backend="gloo", device="cuda", timeout_s=MA_TIMEOUT_S)
    mesh = meshes.make_mesh(MA_MESH)
    res = {"backend": dist.get_backend(), "device": str(dev),
           "coords": (mesh.data_index, mesh.model_index)}
    cfg = ModelConfig(model_type="attention_scn", vocab_size=MA_VOCAB,
                      embed_grad_impl="pallas", dropout=0.0)
    lr = TrainConfig().decoder_lr
    try:
        sharding.trainer_mesh(TrainConfig(mesh_shape=MA_MESH), VOCAB)
        res["refusal"] = None
    except ValueError as e:
        res["refusal"] = str(e)

    def fresh():
        params = decoders.init_decoder(
            torch.Generator().manual_seed(SEED + 30), cfg, device=dev)
        opt = steps.make_optimizer(lr, TrainConfig().grad_clip)
        return {"params": params, "opt_state": opt.init(params)}, opt

    def snapshot(sub):
        return {"params": map_tree(sub["params"], lambda t: t.detach()
                                   .clone()),
                "opt_state": copy.deepcopy(sub["opt_state"].state_dict())}

    def load(sub, snap):
        with torch.no_grad():
            for p, q in zip(tree_leaves(sub["params"]),
                            tree_leaves(snap["params"]), strict=True):
                p.copy_(q)
        sub["opt_state"].load_state_dict(snap["opt_state"])

    ref, ref_opt = fresh()              # whole vocabulary: the references
    dims = sharding.vocab_leaf_dims(ref["params"])
    batches = dp_batches(dev, cfg, MA_STEPS, seed=SEED + 30)
    local = [sharding.place_batch(mesh, b) for b in batches]
    rows = int(local[0]["caps"].shape[0])
    for head in ("dense", "chunked"):
        tcfg = TrainConfig(batch_size=DP_B, head_impl=head)
        sub, opt = fresh()
        sharding.place_state(mesh, sub)
        step = ptrain.make_parallel_caption_train_step(cfg, tcfg, opt, mesh,
                                                       device=dev)
        _, ref_step = steps.make_caption_train_step(cfg, tcfg, ref_opt,
                                                    device=dev)
        snaps, grads, embs, metrics, ms = [], [], [], [], []
        # ---- the steps: counters zeroed just before, read just after ----
        torch.cuda.synchronize()
        zero_counters()
        for b in local:
            snaps.append(snapshot(sub))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, m = step(sub, b["enc"], b["tags"], b["caps"], b["caplens"])
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            grads.append(dp_flat_grads(sub["opt_state"]))
            embs.append(sub["params"]["embedding"].grad.detach().clone())
            metrics.append({k: float(v) for k, v in m.items()})
        ran = read_counters()
        # -----------------------------------------------------------------
        snaps.append(snapshot(sub))
        leaves = tree_leaves(sub["params"])
        out = {"launches": ran, "ms": ms, "metrics": metrics,
               "blocks": digest([leaves[i] for i in sorted(dims)]),
               "replicated": digest([t for i, t in enumerate(leaves)
                                     if i not in dims]),
               "shapes": [tuple(leaves[i].shape) for i in sorted(dims)]}
        # each step against one rank's unsharded step from the same state
        # (gathered over the model group) on the whole global batch
        cmp, refs = [], []
        for i, b in enumerate(batches):
            steps.restore_state(ref, sharding.gather_payload(mesh,
                                                             snaps[i]))
            _, mr = ref_step(ref, b["enc"], b["tags"], b["caps"],
                             b["caplens"])
            g = dp_flat(ma_blocks([p.grad for p in tree_leaves(
                ref["params"])], dims, mesh))
            before = dp_flat(tree_leaves(snaps[i]["params"]))
            u = (dp_flat(ma_blocks(tree_leaves(ref["params"]), dims, mesh))
                 - before) / lr
            mine = (dp_flat(tree_leaves(snaps[i + 1]["params"])) - before) \
                / lr
            refs.append((g, u))
            emb = ma_blocks([ref["params"]["embedding"].grad], {0: 0},
                            mesh)[0]
            cmp.append({"grad": rel_err(grads[i], g),
                        "embed": rel_err(embs[i], emb),
                        "update": rel_err(mine, u),
                        "loss": abs(metrics[i]["loss"] - float(mr["loss"]))
                        / float(mr["loss"]),
                        "top5": abs(metrics[i]["top5"] - float(mr["top5"])),
                        "one_token": 100.0 / float(mr["n_tokens"])})
        out["cmp"] = cmp
        # the control: step 0 again with d_h not summed over the model
        # group (each rank's replicated weights see only its block's part)
        load(sub, snaps[0])
        summed = meshes.enter_vocab_region
        meshes.enter_vocab_region = lambda x, mesh: x
        try:
            b = local[0]
            step(sub, b["enc"], b["tags"], b["caps"], b["caplens"])
        finally:
            meshes.enter_vocab_region = summed
        before = dp_flat(tree_leaves(snaps[0]["params"]))
        out["control"] = {
            "grad": rel_err(dp_flat_grads(sub["opt_state"]), refs[0][0]),
            "update": rel_err((dp_flat(tree_leaves(sub["params"])) - before)
                              / lr, refs[0][1])}
        # one rank's step on the whole batch, the others waiting
        meshes.barrier(mesh)
        if rank == 0:
            b = batches[0]
            _, one_ms = timed_steps(lambda: ref_step(
                ref, b["enc"], b["tags"], b["caps"], b["caplens"]), MA_STEPS)
            out["one_rank_ms"] = one_ms
        meshes.barrier(mesh)
        res[head] = out
        del sub, opt, snaps, grads, embs

    # ---- kernel 14 on this rank's ids shifted into its block, as the
    # step's lookup gives them (the other blocks' ids fall outside) ----
    col0, width = meshes.vocab_block(MA_VOCAB, mesh)
    ids = (local[0]["caps"][:, :cfg.max_caption_len - 1].reshape(-1)
           - col0).to(torch.int32).contiguous()
    gen = torch.Generator().manual_seed(SEED + 32 + rank)
    res["embed_block"] = {
        "N": ids.shape[0], "V": width, "E": cfg.embed_dim,
        "outside": int(((ids < 0) | (ids >= width)).sum()),
        "err": {str(dt).replace("torch.", ""): embed_grad_check(
            ids, torch.randn((ids.shape[0], cfg.embed_dim),
                             generator=gen).to(dev, dt).contiguous(),
            width, f"rank {rank}'s block ids")
            for dt in (torch.float32, torch.bfloat16)}}

    # ---- fine-tune steps at the mesh: the replicated leaves, moments
    # and statistics bitwise equal on every rank; each broadcast's input
    # digested, to see whether the model ranks' own copies agreed ----
    fcfg = ModelConfig(model_type="attention_scn", vocab_size=MA_VOCAB,
                       embed_grad_impl="pallas")
    ftcfg = TrainConfig(batch_size=MA_FT_B, fine_tune_encoder=True)
    dec_opt = steps.make_optimizer(ftcfg.decoder_lr, ftcfg.grad_clip)
    enc_opt = steps.make_optimizer(ftcfg.encoder_lr, ftcfg.grad_clip)
    ft = caption.init_state(torch.Generator().manual_seed(SEED + 33), fcfg,
                            dec_opt, device=dev)
    ft["enc_opt_state"] = enc_opt.init(ft["encoder"])
    sharding.place_state(mesh, ft)
    tagger_fn, ft_step = ptrain.make_parallel_caption_finetune_step(
        fcfg, ftcfg, dec_opt, enc_opt, mesh, device=dev)
    frng = np.random.default_rng(SEED + 33)
    fcaps, flens = captions(frng, MA_FT_B, MA_VOCAB, fcfg.max_caption_len)
    fb = sharding.place_batch(mesh, {
        "images": frng.integers(0, 256, (MA_FT_B, 3, IMAGE_SIZE,
                                         IMAGE_SIZE), dtype=np.uint8),
        "caps": fcaps.astype(np.int64), "caplens": flens.astype(np.int64)})
    ftags = tagger_fn(ft, fb)
    drop = torch.Generator(device=dev).manual_seed(SEED + 34
                                                   + mesh.data_index)
    pre, ft_ms, ft_loss = [], [], []
    bcast = meshes.replicate_over_model

    def recorded(t, m):
        pre.append(digest([t]))
        return bcast(t, m)

    meshes.replicate_over_model = recorded
    try:
        for _ in range(MA_FT_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, m = ft_step(ft, fb["images"], ftags, fb["caps"],
                           fb["caplens"], gen=drop)
            torch.cuda.synchronize()
            ft_ms.append(1e3 * (time.perf_counter() - t0))
            ft_loss.append(float(m["loss"]))
    finally:
        meshes.replicate_over_model = bcast
    fdims = sharding.vocab_leaf_dims(ft["params"])
    dec = tree_leaves(ft["params"])

    def moments(opt, ps):
        return [opt.state[p][k] for p in ps for k in ("exp_avg",
                                                     "exp_avg_sq")]

    rep_dec = [p for i, p in enumerate(dec) if i not in fdims]
    blk_dec = [dec[i] for i in sorted(fdims)]
    enc = tree_leaves(ft["encoder"])
    res["finetune"] = {
        "replicated": digest(rep_dec + moments(ft["opt_state"], rep_dec)
                             + enc + moments(ft["enc_opt_state"], enc)
                             + tree_leaves(ft["encoder_stats"])),
        "blocks": digest(blk_dec + moments(ft["opt_state"], blk_dec)),
        "pre": pre, "ms": ft_ms, "loss": ft_loss,
        "arch": fcfg.encoder_arch}
    del ft, dec_opt, enc_opt, rep_dec, blk_dec, enc, dec
    torch.cuda.empty_cache()

    # ---- a bare model-group all_reduce of the embedded inputs' size ----
    buf = torch.zeros((rows, cfg.max_caption_len - 1, cfg.embed_dim),
                      device=dev)
    ar = []
    for _ in range(MA_STEPS):
        meshes.barrier(mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        meshes.model_all_reduce(buf, mesh)
        torch.cuda.synchronize()
        ar.append(1e3 * (time.perf_counter() - t0))
    res.update(all_reduce_ms=ar, all_reduce_mb=4 * buf.numel() / 2**20,
               rows=rows)
    del buf, ref, ref_opt

    # ---- the trainer at the mesh: one epoch, its checkpoint, a resume,
    # the evaluation over the mesh ----
    rng = np.random.default_rng(SEED + 31)
    wm = word_map(MA_VOCAB)

    def split(n, name):
        caps, caplens = captions(rng, n * TRAINER_CPI, MA_VOCAB,
                                 cfg.max_caption_len)
        images = rng.integers(0, 256, size=(n, 3, IMAGE_SIZE, IMAGE_SIZE),
                              dtype=np.uint8)
        return CaptionDataset.from_arrays(images, caps, caplens,
                                          cpi=TRAINER_CPI, split=name)

    train_ds, val_ds = (split(n, name) for n, name in
                        zip(MA_TRAINER_IMAGES, ("TRAIN", "VAL")))
    ckdir = os.path.join(tmp, "checkpoints")
    ttcfg = TrainConfig(epochs=1, batch_size=DP_B, print_freq=5,
                        cache_features=True, calibrate_encoder_stats=1,
                        checkpoint_dir=ckdir, mesh_shape=MA_MESH)
    kcfg = ModelConfig(model_type="attention_scn", vocab_size=MA_VOCAB,
                       embed_grad_impl="pallas")
    torch.cuda.synchronize()
    zero_counters()
    t0 = time.perf_counter()
    state, summary = caption.train("attention_scn", wm, train_ds, val_ds,
                                   ttcfg, model_cfg=kcfg,
                                   data_name="ma_corpus",
                                   log=lambda line: None, device=dev)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    ran = read_counters()
    n_train = len(train_ds) // DP_B
    n_val = -(-len(val_ds) // DP_B)
    check(ran["train_bwd"] == ran["embed_grad_scatter"] == n_train
          and ran["train_fwd"] == n_train + n_val,
          f"rank {rank}: the trainer's epoch at mesh {MA_MESH} ran kernels "
          f"8, 9 and 14 {ran['train_fwd']}, {ran['train_bwd']} and "
          f"{ran['embed_grad_scatter']} times in {n_train} train and "
          f"{n_val} validation steps")
    check(all(np.isfinite(summary["step_losses"][0])),
          f"rank {rank}: trainer losses {summary['step_losses']}")
    meshes.barrier(mesh)
    path = os.path.join(ckdir, "checkpoint_attention_scn_ma_corpus")
    t0 = time.perf_counter()
    loaded = common.load_caption_state(path, kcfg, device=dev)
    t_load = time.perf_counter() - t0
    whole = sharding.gather_payload(mesh, steps.state_payload(state))
    for key in ("params", "encoder", "encoder_stats", "tagger",
                "tagger_stats"):
        same = all(torch.equal(x, y) for x, y in zip(
            tree_leaves(loaded[key]), tree_leaves(whole[key]), strict=True))
        check(same, f"rank {rank}: rank 0's checkpoint, loaded at one rank,"
              f" differs from the {key} gathered over the model group")
    # a resume of the finished run trains nothing: the restored state
    opt = state["opt_state"]
    moments = [t for p in tree_leaves(state["params"])
               for t in (opt.state[p]["exp_avg"], opt.state[p]["exp_avg_sq"])]
    again, _ = caption.train("attention_scn", wm, train_ds, val_ds, ttcfg,
                             model_cfg=kcfg, data_name="ma_corpus",
                             resume=True, log=lambda line: None, device=dev)
    opt2 = again["opt_state"]
    restored = [t for p in tree_leaves(again["params"])
                for t in (opt2.state[p]["exp_avg"],
                          opt2.state[p]["exp_avg_sq"])]
    check(all(torch.equal(x, y) for x, y in zip(
        tree_leaves(again["params"]), tree_leaves(state["params"]),
        strict=True)) and all(torch.equal(x, y) for x, y in zip(
            restored, moments, strict=True)),
          f"rank {rank}: the resume did not restore this rank's blocks and "
          "moments bitwise")
    del again, loaded
    # the TEST split over the mesh against one rank's decode of the same
    # blocks of rows (kernel 7 on each data row)
    test_ds = split(MA_TEST_IMAGES, "TEST")
    beam = BeamConfig(beam_size=5)
    t0 = time.perf_counter()
    _, hyps = eval_caption.decode_dataset(
        state, kcfg, test_ds, wm, beam_cfg=beam, batch_size=DP_B,
        log=lambda line: None, device=dev, mesh=meshes.make_mesh(MA_MESH))
    t_eval = time.perf_counter() - t0
    res["trainer"] = {"s": t_run, "load_s": t_load, "eval_s": t_eval,
                      "epoch_s": summary["timings"]["train_epoch"][0],
                      "train_loss": summary["train_loss"],
                      "bleu4": summary["best_metric"], "steps": n_train,
                      "launches": ran, "hyps": hyps}
    if rank == 0:
        one = {**state, "params": whole["params"]}
        _, one_hyps = eval_caption.decode_dataset(
            one, kcfg, test_ds, wm, beam_cfg=beam,
            batch_size=DP_B // MA_MESH[0], log=lambda line: None,
            device=dev)
        res["trainer"]["one_rank_hyps"] = one_hyps
    del state, whole
    meshes.barrier(mesh)
    torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))
    dist.destroy_process_group()


def model_axis_phase(card):
    """The model-axis phase: MA_MESH ranks on the one card over gloo,
    vocab-sharded caption steps (dense and chunked heads) held against
    one rank's unsharded step, with a control that must fail; the
    refusal of an odd vocabulary; kernel 14 on each rank's block ids;
    fine-tune steps whose replicas must stay bitwise equal; the trainer
    at the mesh with its checkpoint, a resume and the evaluation over the
    mesh."""
    import tempfile

    import numpy as np
    import torch

    t_phase = time.perf_counter()
    n_ranks = MA_MESH[0] * MA_MESH[1]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        failed = spawn(ma_rank, (free_port(), tmp), MA_TIMEOUT_S,
                       nprocs=n_ranks)
        t_ranks = time.perf_counter() - t0
        if failed:
            raise SmokeFailure(f"model-axis ranks: {failed}")
        r = [torch.load(os.path.join(tmp, f"rank{i}.pt"), weights_only=False)
             for i in range(n_ranks)]

    def g(x):
        return f"{x:.3g}"

    def ms(xs):
        return ", ".join(f"{v:.1f}" for v in xs)

    for i, x in enumerate(r):
        check(x["backend"] == "gloo" and x["device"] == "cuda",
              f"rank {i} ran on {x['backend']} / {x['device']}")
        check(x["refusal"] is not None and f"vocab_size {VOCAB}" in
              x["refusal"] and f"model axis {MA_MESH[1]}" in x["refusal"],
              f"rank {i}: V={VOCAB} at M={MA_MESH[1]} gave {x['refusal']}")
    width = MA_VOCAB // MA_MESH[1]
    for head in ("dense", "chunked"):
        want = {"train_fwd": MA_STEPS, "train_bwd": MA_STEPS,
                "embed_grad_scatter": MA_STEPS}
        for i, x in enumerate(r):
            h = x[head]
            got = {k: h["launches"][k] for k in want}
            check(got == want, f"{head}: rank {i} launched {got} in "
                  f"{MA_STEPS} steps")
            check(h["metrics"] == r[0][head]["metrics"]
                  and h["replicated"] == r[0][head]["replicated"],
                  f"{head}: rank {i}'s metrics or replicated weights differ "
                  "from rank 0's")
            peer = [y for y in r if y["coords"][1] == x["coords"][1]]
            check(all(y[head]["blocks"] == h["blocks"] for y in peer)
                  and all(s[-1] == width or s[0] == width
                          for s in h["shapes"]),
                  f"{head}: rank {i}'s vocabulary blocks {h['shapes']} "
                  "differ from its model column's")
            worst = {k: max(c[k] for c in h["cmp"])
                     for k in ("grad", "update", "loss")}
            check(worst["grad"] <= MA_GRAD_TOL
                  and worst["update"] <= MA_UPDATE_TOL
                  and worst["loss"] <= MA_LOSS_TOL
                  and all(c["top5"] <= c["one_token"] for c in h["cmp"]),
                  f"{head}: rank {i}'s {MA_STEPS} steps against one rank's "
                  f"from the same state: {h['cmp']} (limits: gradients "
                  f"{MA_GRAD_TOL}, update {MA_UPDATE_TOL}, loss "
                  f"{MA_LOSS_TOL}, top-5 one token)")
            check(h["control"]["grad"] > MA_GRAD_TOL
                  and h["control"]["update"] > MA_UPDATE_TOL,
                  f"{head}: rank {i}'s control (d_h not summed over the "
                  f"model group) passes the limits: {h['control']}")
            check(max(c["embed"] for c in h["cmp"]) <= MA_GRAD_TOL,
                  f"{head}: rank {i}'s embedding block's gradient against "
                  f"the matching slice of one rank's: "
                  f"{[c['embed'] for c in h['cmp']]} (limit {MA_GRAD_TOL})")
    for i, x in enumerate(r):
        e = x["embed_block"]
        check(e["V"] == width and e["outside"] > 0,
              f"rank {i}: kernel 14's block check took V={e['V']} with "
              f"{e['outside']} ids outside the block")
        f = x["finetune"]
        check(f["replicated"] == r[0]["finetune"]["replicated"]
              and all(np.isfinite(f["loss"])),
              f"rank {i}: after {MA_FT_STEPS} fine-tune steps the replicated "
              "leaves, moments or statistics differ from rank 0's, or the "
              f"loss {f['loss']} is not finite")
        check(all(y["finetune"]["blocks"] == f["blocks"] for y in r
                  if y["coords"][1] == x["coords"][1]),
              f"rank {i}: the fine-tune steps' vocabulary blocks differ "
              "from its model column's")
    tr = [x["trainer"] for x in r]
    check(all(t["hyps"] == tr[0]["hyps"] for t in tr)
          and tr[0]["hyps"] == tr[0]["one_rank_hyps"],
          "the TEST split's hypotheses over the mesh differ between ranks "
          "or from one rank's decode of the gathered state")

    print(f"model axis: {card}; {n_ranks} ranks at mesh {MA_MESH} (data, "
          f"model) on cuda:0 over gloo, attention_scn V={MA_VOCAB} ({width} "
          f"columns a rank), global B={DP_B} ({r[0]['rows']} rows a data "
          f"row), embed_grad_impl=pallas; V={VOCAB} at M={MA_MESH[1]} "
          f"refused: {r[0]['refusal']}")
    for head in ("dense", "chunked"):
        h0 = r[0][head]
        print(f"model axis, {head} head: step ms "
              + "; ".join(f"rank {i} [{ms(x[head]['ms'])}]"
                          for i, x in enumerate(r))
              + f"; one rank on the whole batch [{ms(h0['one_rank_ms'])}]; "
              f"launches a rank (8, 9, 14) {MA_STEPS} each")
        for i, x in enumerate(r):
            c = x[head]["cmp"]
            print(f"model axis, {head} head, rank {i} {x['coords']}: "
                  f"against one rank's step, relative in the 2-norm: "
                  f"gradients [{', '.join(g(v['grad']) for v in c)}], the "
                  f"embedding block's alone "
                  f"[{', '.join(g(v['embed']) for v in c)}] (limit "
                  f"{MA_GRAD_TOL}), update "
                  f"[{', '.join(g(v['update']) for v in c)}] (limit "
                  f"{MA_UPDATE_TOL}), loss "
                  f"[{', '.join(g(v['loss']) for v in c)}] (limit "
                  f"{MA_LOSS_TOL}), top-5 "
                  f"[{', '.join(g(v['top5']) for v in c)}] (limit one token, "
                  f"{g(c[0]['one_token'])}); the control, d_h not summed: "
                  f"gradients {g(x[head]['control']['grad'])}, update "
                  f"{g(x[head]['control']['update'])} (both must exceed the "
                  "limits)")
    e0 = r[0]["embed_block"]
    print(f"model axis: kernel 14 on each rank's caption ids shifted into "
          f"its block (N={e0['N']}, V={e0['V']}, E={e0['E']}) against its "
          f"plain version, max abs err "
          + "; ".join(f"rank {i} " + ", ".join(
              f"{k} {g(v)}" for k, v in x["embed_block"]["err"].items())
              + f" ({x['embed_block']['outside']} ids outside the block)"
              for i, x in enumerate(r))
          + f" (limit {EMBED_TOL} x a column's sum|g|; two calls bitwise "
          "equal)")
    agree = [all(x["finetune"]["pre"][j] == y["finetune"]["pre"][j]
                 for x in r for y in r if x["coords"][0] == y["coords"][0])
             for j in range(len(r[0]["finetune"]["pre"]))]
    ft0 = r[0]["finetune"]
    print(f"model axis: {MA_FT_STEPS} fine-tune steps ({ft0['arch']} stages "
          f"2-4 and the decoder, {MA_FT_B} global images, dropout keyed by "
          f"data row): loss {r[0]['finetune']['loss']}; step ms "
          + "; ".join(f"rank {i} [{ms(x['finetune']['ms'])}]"
                      for i, x in enumerate(r))
          + "; replicated leaves, moments and statistics bitwise equal on "
          f"every rank; before each of the {len(agree)} broadcasts from "
          f"model rank 0 the model ranks' own copies were bitwise equal: "
          f"{agree}")
    print(f"model axis: a bare model-group all_reduce of the embedded "
          f"inputs ({r[0]['all_reduce_mb']:.2f} MiB, host clock between two "
          f"synchronizes) ms "
          + "; ".join(f"rank {i} [{ms(x['all_reduce_ms'])}]"
                      for i, x in enumerate(r)))
    print(f"model axis: train.caption.train at mesh {MA_MESH}, 1 epoch of "
          f"{tr[0]['steps']} steps, feature cache on the host: "
          + "; ".join(f"rank {i} {t['s']:.1f} s in all, epoch "
                      f"{t['epoch_s']:.3f} s, checkpoint load "
                      f"{t['load_s']:.2f} s, TEST decode {t['eval_s']:.2f} s"
                      for i, t in enumerate(tr))
          + f"; train_loss {tr[0]['train_loss']:.4f}, BLEU-4 "
          f"{tr[0]['bleu4']:.3g}; rank 0's checkpoint bitwise the gathered "
          f"blocks at one rank, the resume bitwise every rank's blocks and "
          f"moments, the {MA_TEST_IMAGES} TEST hypotheses over the mesh "
          "equal to one rank's")
    print(f"model axis: the ranks {t_ranks:.1f} s; the phase "
          f"{time.perf_counter() - t_phase:.1f} s")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        from indonesian_image_captioning_tpu_torch.core.config import \
            ModelConfig
        from indonesian_image_captioning_tpu_torch.core.runtime import \
            get_device
        from indonesian_image_captioning_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2

    dev = get_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc per source: "
          f"{ {k: round(v, 1) for k, v in _build.build_seconds.items()} })")
    for name in _build.SIGNATURES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line.lower():
                print(f"  ptxas {name}: {line.strip()}")

    cfg = ModelConfig(model_type="attention_scn", vocab_size=VOCAB)
    t_start = time.perf_counter()
    with torch.inference_mode():
        res = {str(dt).replace("torch.", ""): kernel_phase(dev, dt, cfg, B)
               for dt in (torch.float32, torch.bfloat16)}
        topk_res = topk_case(dev, B)
        fc_res = fc_topk_case(dev, cfg, B)
        embed_res = embed_grad_phase(dev, cfg)
        gemm_res = gemm_phase(dev, cfg)
    t0 = time.perf_counter()
    launches = serve_and_inference(dev, cfg, B, IMAGE_SIZE)
    print(f"phases: kernels {t0 - t_start:.1f} s, serve and inference "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    hyps = checkpoints_and_evaluation(dev, cfg, IMAGE_SIZE)
    print(f"phases: checkpoints and evaluation "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    train_res, train_launches = train_phase(dev, cfg, B, IMAGE_SIZE)
    launches.update(train_launches)
    print(f"phases: train {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches.update(trainer_phase(dev, cfg, IMAGE_SIZE))
    print(f"phases: trainer {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    encoder_training_phase(dev, cfg, IMAGE_SIZE)
    print(f"phases: encoder training {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    data_parallel_phase(dev, cfg, card, hyps)
    print(f"phases: data-parallel training and tools "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    model_axis_phase(card)
    print(f"phases: model axis {time.perf_counter() - t0:.1f} s")

    T = cfg.max_caption_len - 1
    fwd_work, bwd_work = train_work(cfg, B, T)
    pure_scn = dataclasses.replace(cfg, model_type="pure_scn")
    csrc = "indonesian_image_captioning_tpu_torch/csrc/"
    jax_ops = "indonesian_image_captioning_tpu/ops/"
    f32, bf16 = res["float32"], res["bfloat16"]
    chain = "tf32x3"           # float32 products on the tensor cores
    rows = (("attend_fused", "attend.cu", "attention_pallas.py:233",
             f32["attend"], bf16["attend"], attend_work(cfg, B)),
            ("fused_decode_step", "step.cu", "step_pallas.py:379",
             f32["step"], bf16["step"], step_work(cfg, B), chain),
            ("fused_decode_span", "span.cu", "span_pallas.py:521",
             f32["span"], bf16["span"], record_work(cfg, B, SPAN), chain),
            ("beam_decode_records", "step.cu", "decode_pallas.py:305",
             f32["mega"], bf16["mega"],
             record_work(cfg, B, f32["mega"]["steps"]), chain),
            ("gemm_tc", "mma.cuh", None,
             gemm_res["float32", "head"], gemm_res["bfloat16", "head"],
             gemm_res["float32", "head"]["work"], chain),
            ("row_topk_pallas", "topk.cu", "topk_pallas.py:85", topk_res,
             None, topk_work(B, K * VOCAB, K)),
            ("fused_decode_step_noattn", "step.cu", "step_pallas.py:422",
             f32["step_pure_scn"], bf16["step_pure_scn"],
             step_work(pure_scn, B), chain),
            ("attend_fused_q", "attend_q.cu", "attention_pallas.py:519",
             f32["attend_q"], bf16["attend_q"], attend_q_work(cfg, B)),
            ("fused_decode_step_q", "step.cu", "step_pallas.py:402",
             f32["step_q"], bf16["step_q"], step_work(cfg, B, quant=True),
             chain),
            ("scn_step_fused", "scn.cu", "scn_pallas.py:56",
             f32["scn_attention_scn"], bf16["scn_attention_scn"],
             scn_work(cfg, B * K), chain),
            ("fc_topk", "fc_topk.cu", "fc_topk_pallas.py:119", fc_res, None,
             fc_topk_work(B * K, cfg.decoder_dim, VOCAB, K), chain),
            ("train_fwd", "train.cu", "train_pallas.py:768",
             train_res[("float32", "attention_scn")]["train_fwd"],
             train_res[("bfloat16", "attention_scn")]["train_fwd"], fwd_work,
             chain),
            ("train_bwd", "train.cu", "train_pallas.py:856",
             train_res[("float32", "attention_scn")]["train_bwd"],
             train_res[("bfloat16", "attention_scn")]["train_bwd"],
             bwd_work, chain),
            ("embed_grad_scatter", "embed_grad.cu",
             "embed_grad_pallas.py:111", embed_res["float32"],
             embed_res["bfloat16"],
             embed_work(B * T, VOCAB, cfg.embed_dim)))
    kernels = []
    for name, source, replaces, r32, r16, (nbytes, flops), *peak in rows:
        check(launches.get(name, 0) > 0,
              f"{name} never launched on its path")
        bound_ms, bound_by = bound(nbytes, flops, *peak)
        kernels.append({
            "name": name, "route": "cuda", "source": csrc + source,
            "replaces": replaces and jax_ops + replaces,
            "launches": launches[name],
            "max_abs_err": r32["max_abs_err"], "ms": r32["ms"],
            "plain_ms": r32["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": r32.get("library_ms"),
            "device_ms": r32.get("device_ms"),
            "library_device_ms": r32.get("library_device_ms"),
            "ffma_bound_ms": r32.get("ffma_bound_ms"),
            "bf16_max_abs_err": r16 and r16["max_abs_err"],
            "bf16_ms": r16 and r16["ms"],
            "bf16_plain_ms": r16 and r16["plain_ms"]})
    print(f"phases: all {time.perf_counter() - t_start:.1f} s after the "
          f"build; profiles taken again (they missed kernels): "
          f"{PROFILE_RETRIES[0]}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
