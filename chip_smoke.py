#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tiseg_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--patch-batch 100] [--hover-patch-batch 32] [--cd-patch-batch 64]
                          [--save-pp-planes PATH]

1. Prints the card (nvidia-smi name, power limit), torch and CUDA versions,
   and builds every CUDA kernel from the sources in this checkout (one nvcc
   per source, all started together).
2. Holds each kernel bit-exact against its plain PyTorch version on seeded
   planes (hand-made hard cases at 64^2 and 256^2, 16 x 256^2 planes at
   CoNIC nucleus density, one 1000^2 plane), and times both:
   instance_postprocess_sweep (B1), ccl_sweep (B2, 4- and 8-connected),
   ccl_filter_sweep's size filter (B4, min_size 10, both connectivities),
   fill_holes_sweep (B3, on the route of ops/flood.py:fill_route, timed in
   turns against its earlier chain), and the watershed (B5) in its bounded (4, 64) and
   fixpoint modes, 4- and 8-connected, on (dist, markers, foreground) from
   the HoVer pipeline.
   On seven-class planes with seed planes (hand-made hard cases at 64^2 and
   256^2, 16 x 256^2 at CoNIC density, one 1000^2 plane) the same for the
   class-vectorized instance_postprocess_sweep (B7, radius 3) and
   mt_instance_postprocess_sweep (B6; 7 and 2 classes, align_time 1, 2 and
   20). B1, B5, B6 and B7 take the cluster route (one launch per batch, one
   cluster of 8 blocks per plane) on every set but the 1000^2 one, where B5
   and B6 take the global chain and B1 and B7 the strip route (one
   cooperative launch, a block per strip of rows), and two ragged sets
   (17 x 101 x 77, 1 x 251 x 243) check the cluster route alone, a 480^2
   plane B1's and B7's strip route, and batches of 3 (two classes) and 2
   (seven classes) 1000^2 planes the strip route in groups of planes, one
   launch per group; each call's route, cluster or strip geometry, shared
   bytes per block (held against ops/_cluster.py:cluster_route and
   ops/instance_pp.py:pp_route), resident clusters or blocks and waves are
   printed, and B1's and B7's launches on each route are held against
   pp_route's. Their timed cases on the
   cluster and strip routes are timed in turns against the earlier global
   chain on the same inputs.
   On every binary set (a 3 x 5 x 9 set among them) B2 on the route of
   ops/flood.py:ccl_route (cluster for two planes or more up to 408^2, else
   the global chain) and its other routes forced, ccl_filter_sweep at
   min_size 0, 1, 2, 10 and 20 (one fused cluster launch where 4-connected,
   else B2 then B4), both also on views 8 bytes past a 16-byte boundary,
   and B4 on the tile route of ops/flood.py:filter_route and its global
   kernel forced, each bit-exact with its launches per route held against
   the route functions; B4's global route at min_size 106 (a halo no
   block holds). B3 on every binary set on the route of fill_route (the
   cluster route up to 408^2, a single plane included, else the earlier
   chain), both its routes forced where they apply, and on the same views,
   its launches per route held against fill_route. B2 and B4 (min_size 10)
   are timed in turns against their earlier kernels on the timed sets.
   On the binary planes also the
   round-bounded ccl_rounds (B8a, both connectivities, 64 and 128 rounds) and
   fill_holes_rounds (B8b, H + W and 16 rounds), whose un-converged results
   on the spiral planes must equal the plain versions' too, with the rounds
   each kernel counted equal to those that change a pixel; the window count
   of 'pallas-rounds' (min_size 1, 2, 5) on B8a's un-converged labels; and
   the 3x3 neighbourhood max/min (B9, int32 and float32 planes with negative
   values, and the same planes cut to a width that is not a multiple of 4).
   B8b takes its block route (one block per plane, bit-packed) and B8a its
   cluster route on every set up to 408^2 (ragged sets included), B8b the
   block and B8a the global chain on a 480^2 plane, both their global chains
   on the 1000^2 plane; a 64^2 spiral checks both at rounds = needed - 1,
   needed and needed + 1. The timed cases of these routes are timed in
   turns against the earlier chains.
   fused_decode0_cls (B10) is held against its plain version at the full
   width of a 256^2 patch (B 8, G 128) and on a ragged grid, with two and
   three classes, in float32 (1e-4 of the largest logit: sums in another
   order) and bfloat16 (four bf16 steps of the largest logit, at least 0.15).
3. Drives the UNet eval path through its entry points at the full width of
   the reference UNet recipe (VGG16-BN + UNetHead, 2 classes, float32, seeded
   weights): one 1000^2 image, split 256/40 windows x 8 dihedral TTA views
   (200 patches), softmax mean, argmax and the B1 kernel (strip route, one
   launch, timed in turns against its earlier chain). Three times: the
   unfolded net (fast_eval=False), the BN-folded phase-space executor (the
   default), and the executor with TISEG_FUSED_TAIL=1 (B10, one launch per
   network forward). Launch counts are read from each run alone. The three
   fused maps must agree within 1e-4 and the predictions outside near-ties;
   each result is checked against the plain post-processor, the default
   route's also against the host scipy pipeline.
   Then trains the same recipe: UNet from the config on the card, the
   config's Adam (L2 5e-4) and step LR with linear warmup through the port's
   engine (build_train_state, make_train_step), batches of 8 x 256^2
   synthetic nuclei images with their 1px-eroded instances as targets and a
   weight map of ones. First the loss and every gradient leaf on 2 of the
   images on the card against the port's CPU path (float64: the loss within
   rtol 1e-10, each leaf within 1e-8; float32: the loss within rtol 1e-5,
   each leaf as close to the float64 gradient as 4 x the CPU float32 path's
   error, or 1e-4). Then 13 train steps, the last 10 timed (ms per step,
   images/s, peak memory, the first and last step's logs). Then one of the
   images through seg.inference (the executor must match the unfolded net
   and differ from its output before training) and seg.postprocess with
   device_postprocess True: one launch of B1 on its cluster route, the
   instances equal to the host pipeline's partition.
   Then UNet-S2D on the committed trained weights (bench_fixture.npz, read by
   utils/fixture.py) from its config with bench.py's test_cfg (whole image,
   device post-processing, radius 1): the held-out workload of
   bench.py:_heldout_aji (16 x 256^2, seeds 200-215) through
   seg.inference_and_postprocess on four routes (float32, bf16, int8-resident
   with bf16 and with float32 around the int8 convs; the int8 routes take
   out='pred' into B1), each with B1 once on its cluster route and 23 + 4
   int8 convs (or none), scored by the port's binary AJI, PQ, instance Dice
   and foreground Dice (and the device metrics' AJI), the AJI gated as
   bench.py:469-472 gates it against the fixture's recorded scores. Every
   int8 conv of the executor on that batch bit-exact against its plain
   version; on 2 images the float32 executor within 1e-4 + 1e-4 x |logit| of
   the port's CPU path, the int8 executor's activations equal to the CPU's
   and its argmax equal outside near-ties. Then, at the bench's batch of 128
   x 256^2, the bf16 and int8 executors timed forward only and forward +
   argmax + B1 (patches/s, peak memory), and each int8 conv site (the
   wrapper, torch._int_mm alone on operands of its shape, cuDNN's bf16
   convolution of the same shape, the bound).
   Then the data layer and the eval loop (dataset_paths), on files written in
   the MoNuSeg layout under build/dev/datasets/: UNet-S2D's held-out images as
   a dataset through single_device_test and evaluate (bAji within 0.02 of the
   direct batch of the same uint8 images, every device pre-eval package equal
   to the host one); the UNet config at full width over 3 x 1000^2 tiles of
   720 nuclei (predictions equal to direct InferenceRunner calls, B1 once per
   image, the device and host pre-eval of each image, the loop's ms per image
   pipelined and serial in turns, the dispatch's host time with and without a
   spin kernel queued first and the launches and waits the profiler sees in
   it); the recipe's train pipeline on 108 windows of 512^2 through the
   loader (a batch equal to the mapper on the same seeds, samples/s, loader-fed
   train steps against pre-staged ones in turns, the card's idle share).
   Then the training loop and its CLIs (train_cli_path): the unchanged UNet recipe
   through tiseg_tpu_torch.tools.train on 24 windows of 512^2 (3 iterations
   per epoch) with 2 val tiles of 1000^2, two epochs with the eval hook after
   each (B1 once per val image, strip route), a checkpoint per epoch with
   max_keep 1 and the best by AJI; the LR of every logged step against
   build_lr_schedule; auto-resume for a third epoch (the restored net and
   optimizer state equal to the checkpoint bit for bit, step 9); best.pt
   scored by tools/test.py equal to single_device_test + evaluate on the
   same weights; ms per iteration and per epoch, the card's idle share per
   epoch, the eval hook's ms per image, checkpoint save and load ms and MB;
   the loader on the C++ label maps against their numpy plain versions in
   turns (samples/s from 8 threads, ms per sample on one).
   Then the training of the CUNet and CDNet families and of DIST
   (family_train_path): CUNet, MultiTaskUNet, MultiTaskCUNet, CDNet,
   MultiTaskCDNet, a MultiTaskCDNet config with use_tploss, dir_weight_map,
   use_distance and use_ac, and DIST, each from its MoNuSeg recipe at full
   width on one batch of the recipe's own train pipeline (BoundLabelMake,
   DirectionLabelMake, UNetLabelMake or DistanceLabelMake in C++) at its
   samples_per_gpu x 256^2: the loss, every log
   value and every gradient on 2 images against the port's CPU path in
   float64 and float32, then 3 + 10 steps of make_train_step (ms per step,
   images/s, peak GiB). Then the CDNet recipe (batch 16) through the CLIs
   (cdnet_cli_path), cut as train_cli_path cuts the UNet one (1 iteration
   per epoch, step 3 after the resume; B1 once per val image per
   evaluation, strip route), and the C++ label maps of its windows against
   their numpy plain versions (bound_map bit for bit, dlm_point_maps and
   ddm_weight within the tolerances of tests/test_native_labelmaps.py,
   dir_gt equal off the sector boundaries).
   Then the training of HoVer-Net, DCAN, FullNet, MicroNet and CMicroNet
   (zoo_train_path), each from its MoNuSeg recipe at full width on one batch
   of the recipe's own train pipeline (HVLabelMake, BoundLabelMake or
   UNetLabelMake in C++) at its samples_per_gpu (HoVer-Net and FullNet 8 x
   256^2, DCAN 4 x 256^2, MicroNet and CMicroNet 4 x 252^2): with dropout off
   (models/nn.py:dropout_mask all ones), the loss, every log value and every
   gradient on the card against the port's CPU path in float64 and float32
   (HoVer-Net and FullNet on the top-left 128^2 of one image, DCAN of two,
   the MicroNets on one 252^2 image); then, dropout on, drawn from the step's
   generator, 3 + 10 steps (ms per step, images/s, peak GiB). Then the
   HoVer-Net recipe (batch 8) and the DCAN recipe (batch 4) through the CLIs
   as the CDNet one (hovernet_cli_path, dcan_cli_path; the best by Dice):
   HoVer-Net's eval hook on 256^2 val tiles launches per tile B2 twice on
   its cluster route with B4 fused, B3 and B5 once each on theirs; DCAN's B1
   once per 1000^2 tile on its strip route; the loader on HVLabelMake's C++
   hv_map against its numpy plain version in turns, and the two bit for bit
   on the 24 windows; HoVer-Net's best checkpoint also through tools/test.py
   with the recipe's own test_cfg (the host route: models/utils/postprocess.py
   with the cv2-free twins of utils/imgproc.py), its post-processing ms per
   tile and instances beside the device route's. Then the DIST recipe (batch
   16) through the CLIs as the CDNet one (dist_cli_path): the eval hook on
   1000^2 val tiles with device_postprocess=True launches per tile B9 once per
   reconstruction iteration, B2 and B5 once each on their global chains (one
   plane); tools/test.py with the recipe's own test_cfg (the host route),
   timed per tile; the loader on DistanceLabelMake's C++ dist_cdt_map
   against its numpy plain version in turns, and the two bit for bit on the
   24 windows; and both routes timed on the distance targets of the val
   tiles, the device route equal to the CPU path.
4. Drives the HoVer-Net eval path once through InferenceRunner at the full
   width of the CoNIC recipe (ResNetExt50 + three dense decoders, 7 classes,
   float32, seeded weights and BN statistics): 16 images of 256^2 at CoNIC
   density, 8 dihedral views (128 patches), softmax mean of sem/fore,
   first-view HV maps, and the HoVer post-processing through B2-B5, whose
   launch counts are read from that run alone (B2: two cluster-route
   launches, each with B4's size filter fused, no separate size filter; B3
   and B5: one cluster-route launch each, no global one). The instances are
   checked bit for bit against the same post-processing with the plain
   versions on the same fused maps. B2, the fused call, B4's tile route and
   B3 are timed on the main path's first inputs in turns against the
   earlier chains (ms per call and device time per launch), B5 in turns:
   cluster route, the earlier chain of one launch per wave, cluster route
   again.

5. Drives the CDNet eval path once through InferenceRunner at the full
   width of the CoNIC recipe (VGG16-BN + CDHead, 7 classes + boundary,
   float32, seeded weights): 16 images of 256^2, 8 views, per-view DDM, DDM
   enhancement, boundary strip and the B7 kernel, whose launch count is read
   from that run alone (cluster route, one launch, no global one; timed in
   turns against its earlier chain, and the cluster kernel at 1024 threads
   per block against 512); instances checked bit for bit against
   the plain version on the same semantic plane.
6. The same for MultiTaskCDNet (tc/sem/dir/point heads, B6, one
   cluster-route launch, timed in turns against the earlier chain as B5),
   and two images each through MultiTaskUNet and MultiTaskCUNet (B6;
   checked, not timed).
   The classifiers of these nets are rescaled on view 0 of the images so
   that every class occurs, and their background biases bisected so that
   about 40% of the fused map is foreground and 10% seeds.
   Then DCAN, FullNet, MicroNet and CMicroNet from their MoNuSeg recipes
   (zoo_eval_path; split 256/40 windows, the MicroNets' 252/40, x 8 views,
   device_postprocess=True) through InferenceRunner on 16 x 256^2 images,
   their classifiers shifted so that about 40% of the fused argmax is a
   nucleus (and 10% a contour for DCAN, the boundary class for CMicroNet):
   B1 once per batch on the route of pp_route, equal to the plain version on
   the same plane; one image on the card against the port's CPU path (the
   MicroNets on the identity view alone) within MAP_TOL, the argmax equal
   off the near-ties; e2e, forward and post-processing ms per image.
   Then DIST from its CoNIC recipe (dist_eval_path; 7 classes, split 256/40
   windows x 8 views, device_postprocess=True) through InferenceRunner on 16
   x 256^2 images, the seeded distance head rescaled so that its fused map is
   N(0, 5) (~40% of the pixels >= 1): the dynamic watershed of
   ops/dist_ws.py launches B9 once per reconstruction iteration (at most 256,
   the count printed), B2 (8-connected, the regional minima) and B5 (its
   fixpoint mode) once each on their cluster routes; the instances equal to
   the port's CPU path on the same fused maps bit for bit, and each kernel
   against its plain version on the inputs the route gives it; B9 timed on
   the reconstruction's seed plane beside F.max_pool2d on the negated plane,
   B2 and B5 in turns against their global chains; e2e, forward and
   post-processing ms per image. The same route and checks on the
   DistanceLabelMake(inst_norm=False) maps of 16 CoNIC-density instance
   planes.
   Then the int8 post-training-quantized eval (int8_eval_path): UNet from
   its MoNuSeg recipe on one 1000^2 image (calibrated on 16 centre crops of
   256^2), CDNet and HoVer-Net from their CoNIC recipes on 16 x 256^2
   (calibrated on the batch), each through InferenceRunner on three routes:
   float, the dequant int8 executor and the int8-resident one (heads/
   quant_decode.py, quant_cdnet.py, quant_hovernet.py; HoVer-Net's hv
   branch float), with the post-processing kernels' launches held per run
   (B1 strip; B7 cluster; B2 x 2 with B4 fused, B3, B5); forward ms per patch
   batch, e2e ms per image, peak GiB and the argmax share against the float
   route; every int8 convolution of both executors on the patch batch
   (ops/int8_conv.py: im2col and torch._int_mm) equal to its float64 plain
   version on its first patches; each executor against the port's CPU path
   at the same weights and int8 tree within the CPU tests' shares; the
   three heaviest int8 convolutions of each net against cuDNN float32.
   The same UNet whole, one view, on 16 x 256^2: the out='pred' route, B1
   once per batch on the argmax plane, equal to the resident logits'
   argmax. Last, tools/test.py --int8-calib 2 on the checkpoint and val
   tiles train_cli_path wrote (B1 once per tile, the resident executor per
   patch batch), beside the same CLI in float.
7. UNet.postprocess on 16 images of 256^2 under device_postprocess True (B1
   on its cluster route, one launch per image; timed in turns against its
   earlier chain on one image, and the cluster kernel at 1024 threads per
   block against 512, as on the CDNet batch),
   'xla' (B3 once per image on its cluster route, B2 twice on its global
   chain: fill_route and ccl_route decide for a single plane; on the first
   image's planes, for each, the chain's and the cluster kernel's launches
   in turns) and 'pallas-rounds' (B8b once on
   its block route, B8a twice on its cluster route, the window count once,
   no global chain, per image): each bit-exact against its plain version
   ('pallas-rounds' against the plain versions of all three, which launch
   no kernel), all three equal, post-processing ms per image printed;
   'pallas-rounds' in turns with its earlier design (global chains, the
   window count as tensor ops). On the first image's planes B8b, B8a and
   the window count are timed in turns against their earlier versions.
   With --save-pp-planes, the semantic planes that B1 and B7 get on the
   UNet, CDNet and UNet.postprocess paths, and the masks that B2 gets on
   the HoVer-Net and 'xla' paths, are saved to PATH (the input of
   tools/pp_phases.py and tools/flood_phases.py).
8. Two images through CUNet (executor on, boundary class stripped, radius 3,
   B1 on its cluster route), checked against the unfolded net and the plain
   post-processor.
9. B9 (max) against F.max_pool2d(3, 1, 1) on the same float32 16 x 256^2
   plane, each timed per call (ms, host time included) and per launch with
   L2 flushed and the host's enqueue hidden (device_ms), beside a copy of the
   plane; and the host time of its wrapper alone, with the call path that set
   up the entry point on every call beside it. B9's row in the kernels line
   is DIST's: its launches there and its times on DIST's seed plane; B2's and
   B5's rows carry DIST's numbers as ``dist_*`` beside HoVer-Net's.

10. The data-parallel path (data_parallel_path, after the int8 eval): two
   gloo ranks sharing the card (spawned; NCCL refuses two ranks on one
   device) run the UNet recipe at full width on a global batch of 8 (4 per
   rank) in float64 at 128^2 for 2 steps and FullNet with dropout for 1 step,
   every parameter and BN statistic held to the one-rank step on the card
   within tests/test_torch_ddp_step.py's tolerances; 5 float32 steps at 256^2
   timed per rank beside one rank on the whole batch (the collectives'
   overhead, not a speed-up), with the collectives and bytes per step; each
   rank's share of the eval hook on 2 val tiles of 1000^2 (B1 strip route
   once per tile per rank), merged and held to the one-rank loop by image
   name, exactly; tools/train.py under torch.distributed.run on one rank
   (nccl) against train_cli_path's first epoch (losses within rtol 2e-3);
   HoVer-Net's host route at scale_factor 0.5 and 2 on 4 CoNIC tiles, ms per
   tile.
11. The last modules (last_modules_path, after the data-parallel path): a
   loader batch of the UNet recipe's train pipeline with Resize,
   RandomSparseRotate, RandomRotate, RandomElasticDeform and
   AlbuColorJitter inserted before the crop (8 windows of 512^2, the batch
   held to the mapper on the same seeds) through one float32 UNet train
   step at 8 x 256^2; tools/inference.py on train_cli_path's best.pt and a
   1000^2 tile with --device-postprocess (B1 once on its strip route, the
   instances bit for bit B1's plain version on the CLI's own semantic map,
   the panel file of 1000 x 3016), timed; the seven registered ResNets at
   1 x 3 x 256^2 on the card against the same module on the CPU (each
   stage within 1e-4 of its largest magnitude); tools/get_inf_time.py and
   tools/get_flops.py on the UNet recipe at 8 x 256^2 (get_flops at 1 x
   256^2), their printed lines.
12. The compute dtype (bf16_path, after the last modules): the UNet / MoNuSeg
   cell of phase 3 (its weights, its 1000^2 image) with dtype=torch.bfloat16
   through InferenceRunner, on the executor and with TISEG_FUSED_TAIL=1, each
   run's launches read alone (B1 once, strip route; B10 once per network
   forward, in its bf16 mode), beside the float32 executor: B1's instances
   bit for bit its plain version on each run's plane, B10's first main-path
   launch within its bf16 tolerance of its plain version, timed with its
   bound at the bf16 rate and the unfused bf16 tail (cuDNN) as its library
   time; the share of sem_pred equal to the float32 route's (at least 97%),
   instances, e2e ms and peak memory. Then UNet (8 x 256^2), HoVer-Net
   (8 x 256^2) and DIST (16 x 256^2) from their MoNuSeg recipes on synthetic
   batches in bf16, 3 + 10 steps each: ms per step (host clock), the host's
   enqueue time and the card's span of each step (CUDA events), images/s,
   peak GiB, finite losses, parameters, optimizer state and BN statistics
   float32, beside the float32 steps that phases 3b, 3f and 3h timed at the
   same batch sizes. Then one eval batch of every other segmentor (2 x 256^2,
   the MicroNets' 252^2) in bf16 against its float32 heads, each head within
   6% of the float32 head's largest value. In bf16 the BN-fed convolutions
   sum bf16 products in float32 (cuDNN's TF32 mode, whose operands hold bf16
   values exactly), as the JAX package's program does: one such convolution
   (3x3, 128 -> 128 at 8 x 128^2) is held to a float64 convolution of the
   same bf16 operands, within 2^-12 of its largest value (an algorithm that
   transformed and rounded its operands would show there), and timed beside
   the plain bf16 and the float32 convolution.

TF32 is off for convolutions and matrix products in every comparison.
Prints, before its last two lines, one JSON object with each kernel's
numbers, then the card line; the last line is
{"ok": true, "device": {...}}. Any failure exits non-zero without it.
Needs one CUDA card; imports nothing of the JAX package.
"""
import argparse
import collections
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
UNET_CONFIG = 'configs/unet/unet_vgg16_adam-lr1e-4_bs8_256x256_300e_monuseg.py'
HOVER_CONFIG = 'configs/hovernet/hovernet_adam-lr0.0001_bs8_256x256_100e_conic.py'
CDNET_CONFIG = 'configs/cdnet/cdnet_adam-lr0.0005_bs16_256x256_100e_conic.py'
MT_CDNET_CONFIG = 'configs/multi_task_cdnet/multi_task_cdnet_adam-lr0.0005_bs16_256x256_100e_conic.py'
MT_UNET_CONFIG = 'configs/multi_task_unet/multi_task_unet_adam-lr0.0001_bs8_256x256_100e_conic.py'
CUNET_CONFIG = 'configs/cunet/cunet_adam-lr0.0005_bs16_256x256_300e_monuseg.py'
MT_CUNET_CONFIG = 'configs/multi_task_cunet/multi_task_cunet_adam-lr0.0005_bs16_256x256_100e_conic.py'
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
OPS_PER_S = 67e12  # H100 SXM 32-bit rate outside the tensor cores (data sheet, float32)
TF32_OPS_PER_S = 495e12  # H100 SXM tensor cores, TF32, dense (data sheet)
BF16_OPS_PER_S = 989e12  # H100 SXM tensor cores, bf16, dense (data sheet)
FLUSH_BYTES = 256 * 2 ** 20  # written before each device_ms launch: over five times the 50 MB L2
DIAMOND_MIN_SIZE = 10  # HoVer-Net's size filter (ops/hover.py)
UNBOUNDED = 10 ** 6  # a round budget no plane here exhausts
CONIC_CLASSES, CONIC_RADIUS, ALIGN_TIME = 7, 3, 20  # the CoNIC recipes' post-processing settings
CONIC_BATCH, CONIC_HW = 16, 256  # images per timed CDNet / MultiTaskCDNet batch, and their size
PP_ROUTES = ('cluster', 'strip', 'global')  # the routes of B1 and B7
PP_PLANES = {}  # the main paths' planes of B1, B2 and B7: name -> (planes, num_classes, radius)


def card_line() -> str:
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median over ``reps`` single calls, each timed with CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median over ``reps`` launches of device time alone: before each start
    event the card writes FLUSH_BYTES to a scratch buffer, which evicts the
    inputs from L2 and keeps the device busy while the host enqueues ``fn``,
    so the events bracket device work only."""
    scratch = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device='cuda')
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        scratch.fill_(1.0)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_us(fn, calls: int = 1000) -> float:
    """Host time of one call in microseconds: ``calls`` calls, one synchronize at the end."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def ptxas_report(out: str):
    """(kernel entry, registers, spill line) for each entry of an nvcc
    -Xptxas=-v output."""
    rows, entry, spills = [], None, ''
    for line in out.splitlines():
        if 'Compiling entry function' in line:
            entry = line.split("'")[1]
        elif 'spill stores' in line:
            spills = line.strip()
        elif entry and 'registers' in line:
            rows.append((entry, line.split('Used ')[1].split(' registers')[0], spills))
            entry = None
    return rows


def wall_ms(fn, reps: int) -> float:
    """Median host time of ``reps`` calls, each ending in a synchronize."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


# -- bounds: the least time for the same work on this card -----------------------
def bytes_ms(n_bytes: float) -> float:
    return n_bytes / HBM_BYTES_PER_S * 1e3


def ops_ms(n_ops: float) -> float:
    return n_ops / OPS_PER_S * 1e3


def bound(kernel: str, x: torch.Tensor, waves: int = 0, neigh: int = 4):
    """(bound ms, 'bytes' or 'operations') of ``kernel`` on input ``x``:
    each input read once and each output written once, or the operations
    these inputs need, whichever takes longer. ``waves``: the waves or rounds
    that change a pixel on these inputs; ``neigh``: neighbours per pixel."""
    px = x.numel()
    if kernel == 'instance_postprocess_sweep':  # int32 in, uint8 + int32 out
        byte_ms, op_ms = bytes_ms(9 * px), 0.0
    elif kernel == 'instance_postprocess_vectorized':  # the same planes; one compare per disk cell and pixel
        from tiseg_tpu_torch.ops.instance_pp import disk_offsets
        byte_ms, op_ms = bytes_ms(9 * px), ops_ms(px * len(disk_offsets(CONIC_RADIUS)))
    elif kernel == 'mt_instance_postprocess_sweep':  # 2 int32 in, uint8 + int32 out; 8 neighbours per pixel and wave
        byte_ms, op_ms = bytes_ms(13 * px), ops_ms(8 * px * waves)
    elif kernel == 'ccl_sweep':  # int32 mask in, int32 labels out
        byte_ms, op_ms = bytes_ms(8 * px), 0.0
    elif kernel == 'size_filter':  # int32 labels in and out; one compare per diamond cell and set pixel
        r = DIAMOND_MIN_SIZE - 1
        byte_ms, op_ms = bytes_ms(8 * px), ops_ms(int((x > 0).sum()) * (2 * r * r + 2 * r + 1))
    elif kernel == 'fill_holes_sweep':  # int32 mask in, bool out
        byte_ms, op_ms = bytes_ms(5 * px), 0.0
    elif kernel == 'ccl_rounds':  # int32 mask in, int32 labels out; one compare per neighbour, pixel and round
        byte_ms, op_ms = bytes_ms(8 * px), ops_ms(neigh * px * waves)
    elif kernel == 'fill_holes_rounds':  # int32 mask in, bool out; 4 compares per pixel and round
        byte_ms, op_ms = bytes_ms(5 * px), ops_ms(4 * px * waves)
    elif kernel == 'neighborhood_3x3':  # the plane in and out (4-byte elements); 8 compares per pixel
        byte_ms, op_ms = bytes_ms(8 * px), ops_ms(8 * px)
    else:  # watershed: f32 image, int32 markers and mask in, int32 out; 4 neighbours per pixel and wave
        byte_ms, op_ms = bytes_ms(16 * px), ops_ms(4 * px * waves)
    return (byte_ms, 'bytes') if byte_ms >= op_ms else (op_ms, 'operations')


def partition_bijective(a, b) -> bool:
    pairs = np.unique(np.stack([a.ravel(), b.ravel()]), axis=1)
    return pairs.shape[1] == len(np.unique(a)) == len(np.unique(b))


# -- phase 2: every kernel against its plain version -------------------------------
def hover_inputs(inst_planes: np.ndarray, seed: int):
    """(dist, markers, foreground) of the HoVer pipeline, on the card, for
    synthetic fore/HV maps drawn around each instance plane."""
    from tiseg_tpu_torch.datasets.synthetic import hover_maps
    from tiseg_tpu_torch.ops.hover import foreground, hover_energy, hover_markers
    fore, hv = zip(*[hover_maps(p, seed=seed + i) for i, p in enumerate(inst_planes)])
    blb = foreground(torch.from_numpy(np.stack(fore)).cuda())
    overall, dist = hover_energy(blb, torch.from_numpy(np.stack(hv)).cuda())
    return dist, hover_markers(blb, overall), blb


def kernel_cases(x: torch.Tensor, ws_in):
    """name -> (kernel call, plain call, input the bound is computed from) for one plane set."""
    from tiseg_tpu_torch.ops.flood import (ccl_plain, ccl_sweep, fill_holes_plain, fill_holes_sweep,
                                           size_filter, size_filter_plain)
    cases = pp_cases(x)
    for conn in (1, 2):
        lab = ccl_plain(x > 0, conn)
        cases[f'ccl_sweep conn{conn}'] = (lambda c=conn: ccl_sweep(x, connectivity=c),
                                          lambda c=conn: ccl_plain(x > 0, c), x)
        cases[f'size_filter conn{conn}'] = (lambda lab=lab: size_filter(lab, DIAMOND_MIN_SIZE),
                                            lambda lab=lab: size_filter_plain(lab, DIAMOND_MIN_SIZE), lab)
    cases['fill_holes_sweep'] = (lambda: fill_holes_sweep(x), lambda: fill_holes_plain(x > 0), x)
    cases.update(watershed_cases(ws_in))
    cases.update(round_and_stencil_cases(x))
    return cases


def pp_cases(x: torch.Tensor):
    """B1 (two classes, radius 1) on the binary planes ``x``."""
    from tiseg_tpu_torch.ops.instance_pp import instance_postprocess_plain, instance_postprocess_sweep
    return {'instance_postprocess_sweep': (lambda: instance_postprocess_sweep(x), lambda: instance_postprocess_plain(x),
                                           x)}


def watershed_cases(ws_in):
    """B5 in its bounded (4, 64) and fixpoint modes, 4- and 8-connected; the
    8-connected cases are checked, not timed (no input for the bound)."""
    from tiseg_tpu_torch.ops.watershed import watershed, watershed_plain
    dist, markers, blb = ws_in
    cases = {}
    for conn in (1, 2):
        for mode, (rounds, cleanup) in (('bounded', (4, 64)), ('fixpoint', (None, None))):
            cases[f'watershed {mode}' + (' conn2' if conn == 2 else '')] = (
                lambda r=rounds, c=cleanup, k=conn: watershed(dist, markers, blb, connectivity=k, rounds_per_level=r,
                                                              cleanup_rounds=c),
                lambda r=rounds, c=cleanup, k=conn: watershed_plain(dist, markers, blb, k, 64, r, c),
                dist if conn == 1 else None)
    return cases


def round_and_stencil_cases(x: torch.Tensor):
    """The same for the round-bounded propagation kernels and the 3x3
    stencil. A fourth entry gives (rounds that change a pixel, neighbours)."""
    cases = round_cases(x)
    cases.update(stencil_cases(x))
    return cases


def checked_only(cases):
    """``cases`` with no input for the bound: checked, not timed."""
    return {k: (f, g, None, *work) for k, (f, g, _, *work) in cases.items()}


def round_cases(x: torch.Tensor):
    """B8a (both connectivities, 64 and 128 rounds), B8b (H + W and 16
    rounds), and the window count (min_size 1, 2 and 5, checked only) on
    B8a's un-converged 4-connected labels."""
    from tiseg_tpu_torch.ops.rounds import (ccl_rounds, ccl_rounds_needed, ccl_rounds_plain, fill_holes_rounds,
                                            fill_holes_rounds_needed, fill_holes_rounds_plain, small_component_mask,
                                            window_count_mask)
    cases = {}
    for conn in (1, 2):
        for rounds in (64, 128):
            cases[f'ccl_rounds conn{conn} r{rounds}'] = (
                lambda c=conn, r=rounds: ccl_rounds(x, r, c), lambda c=conn, r=rounds: ccl_rounds_plain(x > 0, r, c),
                x, lambda c=conn, r=rounds: (ccl_rounds_needed(x > 0, r, c), 4 * c))
    for rounds in (None, 16):
        cases[f'fill_holes_rounds {"default" if rounds is None else f"r{rounds}"}'] = (
            lambda r=rounds: fill_holes_rounds(x, r), lambda r=rounds: fill_holes_rounds_plain(x > 0, r), x,
            lambda r=rounds: (fill_holes_rounds_needed(x > 0, r), 4))
    lab = ccl_rounds_plain(x > 0, 64, 1)
    for k in (1, 2, 5):
        cases[f'window_count_mask min{k}'] = (lambda k=k: window_count_mask(lab, k),
                                              lambda k=k: small_component_mask(lab, k), None)
    return cases


def round_boundary_cases(x: torch.Tensor):
    """B8a (both connectivities) and B8b at rounds = needed - 1, needed and
    needed + 1, where needed is the rounds that change a pixel with no
    budget: an early stop one round off shows here. Checked, not timed."""
    from tiseg_tpu_torch.ops.rounds import (ccl_rounds, ccl_rounds_needed, ccl_rounds_plain, fill_holes_rounds,
                                            fill_holes_rounds_needed, fill_holes_rounds_plain)
    cases = {}
    for conn in (1, 2):
        needed = ccl_rounds_needed(x > 0, UNBOUNDED, conn)
        for rounds in (needed - 1, needed, needed + 1):
            cases[f'ccl_rounds conn{conn} needed{rounds - needed:+d}'] = (
                lambda c=conn, r=rounds: ccl_rounds(x, r, c), lambda c=conn, r=rounds: ccl_rounds_plain(x > 0, r, c),
                None, lambda n=needed, r=rounds, c=conn: (min(n, r), 4 * c))
    needed = fill_holes_rounds_needed(x > 0, UNBOUNDED)
    for rounds in (needed - 1, needed, needed + 1):
        cases[f'fill_holes_rounds needed{rounds - needed:+d}'] = (
            lambda r=rounds: fill_holes_rounds(x, r), lambda r=rounds: fill_holes_rounds_plain(x > 0, r), None,
            lambda n=needed, r=rounds: (min(n, r), 4))
    return cases


def stencil_cases(x: torch.Tensor):
    """B9 on an int32 label plane and a float32 plane, both with negative
    values up to the plane edge, and both cut to a width that is not a
    multiple of 4."""
    from tiseg_tpu_torch.ops.flood import ccl_plain
    from tiseg_tpu_torch.ops.stencil import neighborhood_3x3, neighborhood_3x3_plain
    lab = ccl_plain(x > 0, 2) - 5
    planes = {'int32': lab, 'float32': lab.float() * 0.37 - 11.5}
    planes.update({f'{k} ragged': p[..., :-3].contiguous() for k, p in planes.items()})  # W % 4 == 1
    cases = {}
    for dtype, plane in planes.items():
        for op, minimum in (('max', False), ('min', True)):
            cases[f'neighborhood_3x3 {op} {dtype}'] = (lambda p=plane, m=minimum: neighborhood_3x3(p, m),
                                                       lambda p=plane, m=minimum: neighborhood_3x3_plain(p, m), plane)
    return cases


def check_round_budget(case_sets):
    """The round budget is part of B8a/B8b: on the nuclei planes 128 rounds
    converge and equal the union-find kernels (B2, B3); on the 256^2 hard
    planes (spirals) they do not, and the kernels still equal their plain
    versions (checked by check_kernels)."""
    from tiseg_tpu_torch.ops.flood import ccl_sweep, fill_holes_sweep
    from tiseg_tpu_torch.ops.rounds import ccl_rounds, fill_holes_rounds
    x = case_sets['conic16x256'][0]
    for conn in (1, 2):
        if not torch.equal(ccl_rounds(x, 128, conn), ccl_sweep(x, connectivity=conn)):
            raise AssertionError(f'ccl_rounds(128, conn {conn}) differs from ccl_sweep on the nuclei planes')
    if not torch.equal(fill_holes_rounds(x), fill_holes_sweep(x)):
        raise AssertionError('fill_holes_rounds differs from fill_holes_sweep on the nuclei planes')
    hard = case_sets['hard256'][0]
    left = int((ccl_rounds(hard, 128, 2) != ccl_sweep(hard, connectivity=2)).sum())
    if left == 0:
        raise AssertionError('the 256^2 hard planes converged in 128 rounds: they no longer test the round budget')
    print(f'round budget: ccl_rounds(128) and fill_holes_rounds equal B2/B3 on conic16x256; on hard256 {left} pixels '
          f'keep un-converged labels after 128 rounds, as in the plain version', flush=True)


# the fused filter keeps everything at <= 1; 20 takes B4's tile past its 12 unrolled rings
FLOOD_MIN_SIZES = (0, 1, 2, DIAMOND_MIN_SIZE, 20)
LARGE_HALO_MIN_SIZE = 106  # a 242^2 tile exceeds a block's shared memory: B4's global route


def check_flood(flood_sets):
    """B2, the fused ccl_filter_sweep and B4 on every binary plane set, each
    route against the plain versions: ccl_sweep on the route of ccl_route
    (both connectivities), its global chain and, where cluster_route admits
    the planes, its cluster kernel forced; ccl_filter_sweep at min_size 0,
    1, 2, 10 and 20 (one fused launch where 4-connected and cluster_route
    admits the planes, else B2 then B4); the size filter on the tile route
    of filter_route and its global kernel forced; B2 and the fused call on
    views that start 8 bytes past a 16-byte boundary; on the 64^2 hard
    planes B4's global route at a halo no block holds. Every call's route
    and counters are held against the route functions."""
    from tiseg_tpu_torch.ops import flood
    from tiseg_tpu_torch.ops._cluster import cluster_route
    from tiseg_tpu_torch.ops.flood import (ccl_filter_sweep, ccl_plain, ccl_route, ccl_sweep, fill_holes_plain,
                                           fill_holes_sweep, fill_route, filter_route, size_filter, size_filter_plain)

    def same(got, want, what):
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f'{what} differs from its plain version: {int((got != want).sum())} pixels')

    def counts():
        return (ccl_sweep.cluster_launches, ccl_sweep.global_launches, ccl_filter_sweep.fused_launches,
                size_filter.tile_launches, size_filter.global_launches)

    def ran(before, what, want):
        got = tuple(a - b for a, b in zip(counts(), before))
        if got != want:
            raise AssertionError(f'{what}: launches (B2 cluster, B2 global, fused, B4 tile, B4 global) {got}, '
                                 f'expected {want}')

    def check_fill(x, what):
        """B3 on the route of fill_route, its launches per route held against it, and both private
        launches where they apply, on (B, H, W) or (H, W) planes ``x``. Returns the route."""
        planes = x.reshape(-1, *x.shape[-2:])  # a view: the same pointer
        want, route = fill_holes_plain(planes > 0), fill_route(*planes.shape)
        before = (fill_holes_sweep.cluster_launches, fill_holes_sweep.global_launches)
        same(fill_holes_sweep(x), want.reshape(x.shape), f'fill_holes_sweep {what}')
        ran = (fill_holes_sweep.cluster_launches - before[0], fill_holes_sweep.global_launches - before[1])
        if ran != ((1, 0) if route.route == 'cluster' else (0, 1)) or fill_holes_sweep.last_route[:3] != tuple(route):
            raise AssertionError(f'fill_holes_sweep {what}: launches (cluster, global) {ran}, route '
                                 f'{fill_holes_sweep.last_route}; fill_route gives {route}')
        same(flood._launch_global_fill(planes), want, f'fill_holes_sweep {what} (global chain)')
        if cluster_route(*planes.shape).route == 'cluster':
            same(flood._launch_cluster_fill(planes), want, f'fill_holes_sweep {what} (cluster kernel)')
        return route.route

    for set_name, x in flood_sets.items():
        shape = tuple(x.shape)
        print(f'B3 ({check_fill(x, f"{set_name} {shape}")} route) {set_name} {shape}: bit-exact vs plain, the other '
              f'route forced too; launches per route as fill_route gives', flush=True)
        cluster, b2_route = cluster_route(*shape), ccl_route(*shape)
        b2 = (1, 0) if b2_route.route == 'cluster' else (0, 1)
        for conn in (1, 2):
            what = f'ccl_sweep conn{conn} {set_name} {shape}'
            want = ccl_plain(x > 0, conn)
            before = counts()
            same(ccl_sweep(x, connectivity=conn), want, what)
            ran(before, what, (*b2, 0, 0, 0))
            if ccl_sweep.last_route[:3] != tuple(b2_route):
                raise AssertionError(f'{what}: the kernel took {ccl_sweep.last_route}, ccl_route gives {b2_route}')
            same(flood._launch_global_ccl(x, conn), want, f'{what} (global chain)')
            if cluster.route == 'cluster':
                same(flood._launch_cluster_ccl(x, conn), want, f'{what} (cluster kernel)')
            for k in FLOOD_MIN_SIZES:
                what = f'ccl_filter_sweep conn{conn} min_size {k} {set_name} {shape}'
                want_k = size_filter_plain(want, k)
                tile = filter_route(*shape, k)
                fused = conn == 1 and cluster.route == 'cluster'
                before = counts()
                same(ccl_filter_sweep(x, k, connectivity=conn), want_k, what)
                ran(before, what, (1, 0, 1, 0, 0) if fused else (*b2, 0, 1, 0))
                before = counts()
                same(size_filter(want, k), want_k, f'size_filter conn{conn} min_size {k} {set_name} {shape}')
                ran(before, what, (0, 0, 0, 1, 0))
                if tile.route != 'tile' or size_filter.last_route != tuple(tile):
                    raise AssertionError(f'size_filter on {shape}: {size_filter.last_route}, filter_route gives {tile}')
                same(flood._launch_global_filter(want, k), want_k, f'size_filter {set_name} (global kernel)')
        print(f'B2 ({b2_route.route} route), fused ccl_filter_sweep ({cluster.route} route) and B4 (tile route) '
              f'{set_name} {shape}: bit-exact vs plain at connectivity 1 and 2, min_size {FLOOD_MIN_SIZES}, the other '
              f'routes forced too; launches per route as the route functions give', flush=True)
    # views that start 8 bytes past a 16-byte boundary of their storage: the 16-byte loads must not take them
    m = flood_sets['conic16x256'][:3, :95, :98].contiguous()
    for view, b2 in ((m[1:], (1, 0)), (m[1], (0, 1))):  # B2: cluster route on two planes, the chain on one
        what = f'a view {tuple(view.shape)} at {view.data_ptr() % 16} bytes into 16'
        if view.data_ptr() % 16 != 8:
            raise AssertionError(f'{what}: expected 8')
        want = ccl_plain(view.reshape(-1, 95, 98) > 0, 1)
        before = counts()
        same(ccl_sweep(view, connectivity=1), want.reshape(view.shape), f'ccl_sweep on {what}')
        same(ccl_filter_sweep(view, DIAMOND_MIN_SIZE, connectivity=1),
             size_filter_plain(want, DIAMOND_MIN_SIZE).reshape(view.shape), f'ccl_filter_sweep on {what}')
        ran(before, what, (b2[0] + 1, b2[1], 1, 0, 0))
        check_fill(view, f'on {what}')
    print('B2, the fused ccl_filter_sweep and B3 on views 8 bytes past a 16-byte boundary (2 x 95 x 98, 95 x 98): '
          'bit-exact', flush=True)
    x = flood_sets['hard64']
    labels = ccl_plain(x > 0, 1)
    before = counts()
    same(size_filter(labels, LARGE_HALO_MIN_SIZE), size_filter_plain(labels, LARGE_HALO_MIN_SIZE),
         f'size_filter min_size {LARGE_HALO_MIN_SIZE} hard64')
    ran(before, 'size_filter with a large halo', (0, 0, 0, 0, 1))
    print(f'B4 at min_size {LARGE_HALO_MIN_SIZE} on hard64: global route (the halo does not fit a block), bit-exact',
          flush=True)


def growth_waves(seed: torch.Tensor, canvas: torch.Tensor) -> int:
    """The growth waves that change a pixel on these planes (at most ALIGN_TIME - 1)."""
    from tiseg_tpu_torch.ops.flood import ccl_plain
    from tiseg_tpu_torch.ops.mt_instance_pp import align_foreground_plain
    return align_foreground_plain(ccl_plain(seed > 0, 1), canvas > 0, ALIGN_TIME)[1]


def multiclass_kernel_cases(x: torch.Tensor, seed: torch.Tensor):
    """The same for the seven-class planes ``x`` and their seed planes."""
    return {**vectorized_cases(x), **mt_cases(x, seed)}


def vectorized_cases(x: torch.Tensor):
    """B7 (seven classes, radius 3) on the planes ``x``."""
    from tiseg_tpu_torch.ops.instance_pp import instance_postprocess_sweep, instance_postprocess_vectorized_plain
    return {'instance_postprocess_vectorized': (
        lambda: instance_postprocess_sweep(x, radius=CONIC_RADIUS, num_classes=CONIC_CLASSES),
        lambda: instance_postprocess_vectorized_plain(x, CONIC_RADIUS, 5, CONIC_CLASSES), x)}


def mt_cases(x: torch.Tensor, seed: torch.Tensor):
    """B6 with 7 classes and align_time 20 (timed), and with 7 and 2 classes
    at align_time 1, 2 and 20 (checked, not timed)."""
    from tiseg_tpu_torch.ops.mt_instance_pp import mt_instance_postprocess_plain, mt_instance_postprocess_sweep
    cases = {}
    for nc, at in ((CONIC_CLASSES, ALIGN_TIME), (CONIC_CLASSES, 1), (CONIC_CLASSES, 2), (2, 1), (2, 2),
                   (2, ALIGN_TIME)):
        name = 'mt_instance_postprocess_sweep' + ('' if (nc, at) == (CONIC_CLASSES, ALIGN_TIME) else f' c{nc} a{at}')
        cases[name] = (lambda nc=nc, at=at: mt_instance_postprocess_sweep(x, seed, num_classes=nc, align_time=at),
                       lambda nc=nc, at=at: mt_instance_postprocess_plain(x, seed, nc, 5, at),
                       x if (nc, at) == (CONIC_CLASSES, ALIGN_TIME) else None)
    return cases


def routed_kernels():
    """name -> (wrapper, the pure function that gives its route and layout,
    the wrapper's attribute with its waves or rounds, if any) of the kernels
    with more than one route (B1, B2, B3, B4 at HoVer-Net's min_size, B5,
    B6, B7, B8a, B8b)."""
    from tiseg_tpu_torch.ops import flood
    from tiseg_tpu_torch.ops._cluster import cluster_route
    from tiseg_tpu_torch.ops.flood import ccl_route, ccl_sweep, filter_route, size_filter
    from tiseg_tpu_torch.ops.instance_pp import instance_postprocess_sweep
    from tiseg_tpu_torch.ops.mt_instance_pp import mt_instance_postprocess_sweep
    from tiseg_tpu_torch.ops.rounds import ccl_rounds, fill_holes_rounds, fill_route
    from tiseg_tpu_torch.ops.watershed import watershed
    return {'instance_postprocess_sweep': (instance_postprocess_sweep, pp_layout, None),
            'ccl_sweep': (ccl_sweep, ccl_route, None),
            'fill_holes_sweep': (flood.fill_holes_sweep, flood.fill_route, None),
            'size_filter': (size_filter, lambda B, H, W: filter_route(B, H, W, DIAMOND_MIN_SIZE), None),
            'instance_postprocess_vectorized': (instance_postprocess_sweep, pp_layout, None),
            'watershed': (watershed, cluster_route, 'last_waves'),
            'mt_instance_postprocess_sweep': (mt_instance_postprocess_sweep, cluster_route, 'last_waves'),
            'ccl_rounds': (ccl_rounds, cluster_route, 'last_rounds'),
            'fill_holes_rounds': (fill_holes_rounds, fill_route, 'last_rounds')}


def pp_layout(B: int, H: int, W: int):
    """B1's and B7's route on this card (ops/instance_pp.py:pp_route): the
    route, rows per block, blocks per plane and shared bytes per block, as
    the wrapper's ``last_route`` reports them."""
    from tiseg_tpu_torch.ops.instance_pp import pp_route
    return pp_route(B, H, W, torch.cuda.get_device_properties(0).multi_processor_count)[:4]


def pp_launches(fn):
    """B1's and B7's launch counters, by route."""
    return {r: getattr(fn, f'{r}_launches') for r in PP_ROUTES}


def check_pp_launches(fn, before, shape) -> int:
    """The launches of B1's or B7's last call on each route (the counters
    against ``before``), held against pp_route: all on its route, one per
    group of planes. Returns them."""
    from tiseg_tpu_torch.ops.instance_pp import pp_route
    route = pp_route(*shape, torch.cuda.get_device_properties(0).multi_processor_count)
    ran = {r: n - before[r] for r, n in pp_launches(fn).items()}
    want = {r: route.launches if r == route.route else 0 for r in PP_ROUTES}
    if ran != want:
        raise AssertionError(f'{fn.__name__} on {tuple(shape)} launched {ran}, pp_route gives {route}')
    return route.launches


def expected_route(kernel: str, set_name: str) -> str:
    """The route a kernel must take on a plane set: the 1000^2 planes exceed
    a block's and a cluster's shared memory (B1 and B7 take strips of rows);
    the 480^2 plane fits B8b's block, not a cluster; every other set fits
    both. B4's tile holds the halo of min_size 10 on every plane."""
    strip = kernel.startswith('instance_postprocess')
    if kernel == 'size_filter':
        return 'tile'
    if set_name.endswith('1000'):
        return 'strip' if strip else 'global'
    if kernel == 'fill_holes_rounds':
        return 'block'
    if set_name.endswith('480'):
        return 'strip' if strip else 'global'
    return 'cluster'


def route_note(fn, route_of, counts, shape) -> str:
    """The last call's route and layout, held against the route function on
    ``shape``, and its waves or rounds."""
    route, *layout = fn.last_route
    want = route_of(*shape)
    if route != want[0] or (route != 'global' and tuple(layout[:len(want) - 1]) != tuple(want[1:])):
        raise AssertionError(f'{fn.__name__} on {tuple(shape)}: the kernel took {fn.last_route}, the route function '
                             f'gives {want}')
    if route == 'tile':
        note = f'tile route ({layout[0]}^2 output tiles, {layout[1]} B shared per block)'
    elif route == 'cluster' and len(layout) == 5:
        note = (f'cluster route ({layout[0]} rows x cluster {layout[1]}, {layout[4]} threads and {layout[2]} B shared '
                f'per block, {layout[3]} clusters resident)')
    elif route == 'cluster':
        note = f'cluster route (cluster {layout[0]}, {layout[1]} B shared per block, {layout[2]} clusters resident'
        note += f', {layout[3]} threads per block)' if len(layout) == 4 else ')'
    elif route == 'strip':
        note = (f'strip route ({layout[0]} rows x {layout[1]} strips per plane, {layout[4]} threads and {layout[2]} B '
                f'shared per block, {layout[3]} blocks resident)')
    elif route == 'block':
        note = f'block route ({layout[0]} B shared per block{", transposed" if layout[1] else ""})'
    else:
        note = 'global route'
    if counts is None:
        return f', {note}'
    c = getattr(fn, counts)
    budget, needed, ran = c
    return f', {note}, {counts[5:]}: budget {budget}, needed {needed} (mean per plane {c.mean_needed:.1f}), run {ran}'


def check_kernels(case_sets):
    """Each kernel bit-exact against its plain version on every plane set
    (``case_sets``: set name -> (planes, seeds, cases)); B5, B6, B8a and B8b
    also on the route the set selects, and B8a and B8b with the rounds they
    counted equal to those that change a pixel. Prints kernel ms, plain ms
    and bound for the cases with an input for the bound (the others are
    checked only); a routed kernel is timed in turns against its earlier
    chain. Returns each kernel's largest |kernel - plain| and the timings by
    (case, set)."""
    routed = routed_kernels()
    max_err, timed = {}, {}
    for set_name, (x, seed, cases) in case_sets.items():
        for name, (kernel, plain, bound_in, *work) in cases.items():
            kname = name.split()[0]
            fn, route_of, counts = routed.get(kname, (None, None, None))
            before = pp_launches(fn) if kname.startswith('instance_postprocess') else None
            got = kernel()
            torch.cuda.synchronize()
            want = plain()
            got, want = (got if isinstance(got, tuple) else (got,)), (want if isinstance(want, tuple) else (want,))
            for g, w in zip(got, want):
                if not torch.equal(g, w):
                    raise AssertionError(f'{name} differs from its plain version on {set_name}: '
                                         f'{int((g != w).sum())} pixels')
                err = int((g.long() - w.long()).abs().max())
                max_err[kname] = max(max_err.get(kname, 0), err)
            waves, neigh, extra, route = 0, 4, '', None
            if fn is not None:
                route = fn.last_route[0]
                if route != expected_route(kname, set_name):
                    raise AssertionError(f'{name} took the {route} route on {set_name}')
                extra = route_note(fn, route_of, counts, got[0].shape)
            if before is not None:
                extra += f', {check_pp_launches(fn, before, got[0].shape)} launch(es)'
            if work:
                waves, neigh = work[0]()
                extra += f', {waves} rounds change a pixel'
                if route != 'global' and tuple(fn.last_rounds)[1:] != (waves, min(waves + 1, fn.last_rounds.budget)):
                    raise AssertionError(f'{name} on {set_name}: the kernel counted {tuple(fn.last_rounds)}, '
                                         f'{waves} rounds change a pixel')
            elif name.startswith('mt_') and bound_in is not None:
                waves = growth_waves(seed, want[0])
                extra += f' ({waves} change a pixel)'
            if bound_in is None:
                print(f'{name} {set_name} {tuple(x.shape)}: bit-exact vs plain{extra}', flush=True)
                continue
            row = {}
            if route not in (None, 'global'):
                # the new route, the earlier chain on the same inputs, the new route again
                k_ms, row['earlier_ms'], _ = time_in_turns(kernel, lambda: on_chain(kernel))
                extra += f', earlier chain {row["earlier_ms"]:.4f} ms ({row["earlier_ms"] / k_ms:.2f}x)'
            else:
                k_ms = cuda_ms(kernel, reps=25)
            if name.startswith('watershed'):
                # the bound's count, as in earlier rows: the waves the chain
                # needed on the batch (each level until no plane changes)
                on_chain(kernel)
                waves = fn.last_waves[1]
                extra += f', the chain needed {waves}'
            p_ms = cuda_ms(plain, reps=3, warmup=1)
            b_ms, b_by = bound(kname, bound_in, waves, neigh)
            print(f'{name} {set_name} {tuple(x.shape)}: bit-exact vs plain, kernel {k_ms:.4f} ms, plain {p_ms:.2f} '
                  f'ms, bound {b_ms * 1e3:.2f} us ({b_by}, {b_ms / k_ms:.2%} of the kernel time){extra}', flush=True)
            timed[(name, set_name)] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, **row)
    return max_err, timed


def on_chain(call, window_ops: bool = False):
    """``call()`` with B1, B2, B4, B5, B6, B7, B8a and B8b routed to their
    earlier global chains whatever the plane size (so ``ccl_filter_sweep``
    to B2's chain then B4's); with ``window_ops`` also the window count of
    ``'pallas-rounds'`` as the tensor ops it replaced."""
    from tiseg_tpu_torch.ops._cluster import Route
    from tiseg_tpu_torch.ops.flood import FilterRoute
    from tiseg_tpu_torch.ops.rounds import FillRoute
    mods = [sys.modules[f'tiseg_tpu_torch.ops.{m}'] for m in ('flood', 'watershed', 'mt_instance_pp', 'rounds')]
    flood, rounds, ipp = mods[0], mods[-1], sys.modules['tiseg_tpu_torch.ops.instance_pp']
    saved = [m.cluster_route for m in mods] + [flood.filter_route, rounds.fill_route, rounds.window_count_mask]
    saved_pp = ipp._launch_cluster, ipp._launch_strip
    for m in mods:
        m.cluster_route = lambda B, H, W: Route('global', 0, 0)
    flood.filter_route = lambda B, H, W, min_size: FilterRoute('global', 0, 0)
    rounds.fill_route = lambda B, H, W: FillRoute('global', 0, False)
    ipp._launch_cluster = lambda sem, radius, min_size, nc, vec: ipp._launch_global(sem, radius, min_size, nc, vec)
    ipp._launch_strip = lambda sem, radius, min_size, nc, vec, route: ipp._launch_global(sem, radius, min_size, nc,
                                                                                          vec)
    if window_ops:
        rounds.window_count_mask = rounds.small_component_mask
    try:
        return call()
    finally:
        for m, f in zip(mods, saved):
            m.cluster_route = f
        flood.filter_route, rounds.fill_route, rounds.window_count_mask = saved[-3:]
        ipp._launch_cluster, ipp._launch_strip = saved_pp


def time_in_turns(kernel, earlier, reps=25):
    """(ms, earlier_ms, the two kernel readings): the kernel, the earlier
    design and the kernel again, each the median of ``reps`` calls."""
    first = cuda_ms(kernel, reps=reps)
    earlier_ms = cuda_ms(earlier, reps=reps)
    again = cuda_ms(kernel, reps=reps)
    return (first + again) / 2, earlier_ms, [first, again]


# -- phase 2b: the fused last decode stage (B10) against its plain version -------------
MAP_TOL = 1e-4  # fused softmax maps of two routes of one net: float32 sums in other orders
BF16_STEPS = 4  # bf16 tolerance, in steps (2^-8 relative) of the largest logit


def fused_decode_bound(x: torch.Tensor, z: torch.Tensor, out: torch.Tensor, F_t: int, F_c: int):
    """Each of x, z and the logits moved once, or the operations of the
    function itself (4x4/s2 transposed conv, 3x3 conv over its output and
    the skip, 1x1 classifier: not the 1.78x of the phase form) at the rate
    of the units the kernel uses: three times over at the TF32 rate for
    float32 (its hi/lo split), once at the bf16 rate for bfloat16. Also
    returns the bound at the float32 rate outside the tensor cores, which
    the kernel was held to when it ran on the FMA units."""
    B, G, _, Cx = x.shape
    C0, nc, px = z.shape[-1] // 4, out.shape[-1], B * (2 * G) ** 2
    byte_ms = bytes_ms(sum(t.numel() * t.element_size() for t in (x, z, out)))
    n_ops = 2 * px * (4 * Cx * F_t + 9 * (F_t + C0) * F_c + F_c * nc)
    op_ms = (3 * n_ops / TF32_OPS_PER_S if out.dtype == torch.float32 else n_ops / BF16_OPS_PER_S) * 1e3
    b_ms, b_by = (byte_ms, 'bytes') if byte_ms >= op_ms else (op_ms, 'operations')
    return b_ms, b_by, max(byte_ms, ops_ms(n_ops))


def last_stage(seg):
    """(HWIO phase weights of the last decode stage + classifier, the stage's
    executor entry) of a UNet-family segmentor's folded head."""
    from tiseg_tpu_torch.models.heads.fast_decode import _hwio
    head = seg.prepare_inference()['head']
    st = head['stages'][0]
    weights = (_hwio(st['Wt']), st['bt'], _hwio(st['Wc_t']), _hwio(st['Wc_s_phase']), st['bc'], head['cls_kernel'],
               head['cls_bias'])
    return weights, {'stages': {0: st}, 'cls_kernel': head['cls_kernel'], 'cls_bias': head['cls_bias']}


def unfused_tail(fp, x, z):
    """The executor's own last stage on the same inputs, in their dtype: four
    cuDNN convolutions, a matrix product and the depth-to-space copy."""
    from tiseg_tpu_torch.models.heads.fast_decode import PhaseSkip, apply_fast_unet_head
    return apply_fast_unet_head(fp, x, [PhaseSkip(z, z.shape[-1] // 4)], dtype=x.dtype)


def time_fused_decode(label, x, z, weights, fp, reps=25, dtype=torch.float32):
    """Kernel, plain and unfused-tail ms of B10 on (x, z) in ``dtype``, with its bound."""
    from tiseg_tpu_torch.ops.fused_decode import fused_decode0_cls, fused_decode0_cls_plain
    os.environ.pop('TISEG_FUSED_TAIL', None)  # the yardstick is the unfused tail
    with torch.inference_mode():
        out = fused_decode0_cls(x, z, *weights, dtype=dtype)
        k_ms = cuda_ms(lambda: fused_decode0_cls(x, z, *weights, dtype=dtype), reps=reps)
        p_ms = cuda_ms(lambda: fused_decode0_cls_plain(x, z, *weights, dtype=dtype), reps=3, warmup=1)
        lib_ms = cuda_ms(lambda: unfused_tail(fp, x, z), reps=reps)
    b_ms, b_by, fma_ms = fused_decode_bound(x, z, out, weights[0].shape[-1] // 4, weights[2].shape[-1] // 4)
    print(f'fused_decode0_cls {label} x {tuple(x.shape)} z {tuple(z.shape)} {str(dtype).split(".")[-1]}: kernel '
          f'{k_ms:.4f} ms, plain {p_ms:.2f} ms, unfused tail (4 cuDNN convolutions + matmul + d2s, {x.dtype}) '
          f'{lib_ms:.4f} ms, bound {b_ms * 1e3:.2f} us ({b_by}; {fma_ms * 1e3:.2f} us at the 67 TFLOP/s float32 '
          f'rate)', flush=True)
    return dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, bound_ms_f32_fma=fma_ms)


def check_fused_decode(args):
    """B10 against its plain version at the full width of a 256^2 patch (B 8,
    G 128, Cx 32, C0 64, F_t 16, F_c 16), two and three classes, float32 and
    bfloat16, and on a ragged grid (G 20), with the folded weights of the
    seeded UNet / CUNet and signed inputs. Returns the largest float32 error."""
    from tiseg_tpu_torch.models import build_segmentor
    from tiseg_tpu_torch.models.heads.fast_decode import _mask_edges_flat
    from tiseg_tpu_torch.ops.fused_decode import fused_decode0_cls, fused_decode0_cls_plain
    gen = torch.Generator().manual_seed(args.seed + 21)
    worst = 0.0
    for model, nc in (('UNet', 2), ('CUNet', 3)):
        seg = build_segmentor(dict(type=model, num_classes=2, test_cfg=dict()), device='cuda', seed=args.seed)
        randomize_bn_(seg.net, torch.Generator().manual_seed(args.seed + 2))
        weights, fp = last_stage(seg)
        for B, G in ((8, 128), (2, 20)):
            x = torch.randn((B, G, G, 32), generator=gen).cuda()
            z = _mask_edges_flat(torch.randn((B, G + 1, G + 1, 256), generator=gen).cuda(), 64)
            for dtype in (torch.float32, torch.bfloat16):
                with torch.inference_mode():
                    got = fused_decode0_cls(x, z, *weights, dtype=dtype)
                    torch.cuda.synchronize()
                    want = fused_decode0_cls_plain(x, z, *weights, dtype=dtype)
                top = float(want.float().abs().max())
                err = float((got.float() - want.float()).abs().max())
                tol = 1e-4 * top if dtype == torch.float32 else max(0.15, BF16_STEPS * 2.0 ** -8 * top)
                if not (got.shape == (B, 2 * G, 2 * G, nc) and got.dtype == dtype and err <= tol and top > 0.5):
                    raise AssertionError(f'fused_decode0_cls {model} B {B} G {G} {dtype}: max |kernel - plain| {err:.3e} '
                                         f'> {tol:.3e} (largest logit {top:.3f}, shape {tuple(got.shape)})')
                if dtype == torch.float32:
                    worst, want32 = max(worst, err), want
                print(f'fused_decode0_cls {model} ({nc} classes) B {B} G {G} {str(dtype).split(".")[-1]}: max |kernel - '
                      f'plain| {err:.3e} (tolerance {tol:.3e}, largest logit {top:.3f})', flush=True)
            if G == 128:
                unf = unfused_tail(fp, x, z)
                if float((unf - want32).abs().max()) > 1e-4 * float(want32.abs().max()):
                    raise AssertionError('the unfused tail differs from the float32 plain version')
                time_fused_decode(f'{model} kernel phase', x, z, weights, fp)
        del seg
    return worst


# -- phase 3: the UNet eval path -------------------------------------------------------
UNET_HW = 1000  # the MoNuSeg tiles the UNet recipe evaluates


def unet_recipe_seg(args):
    """UNet from the MoNuSeg recipe (device_postprocess, ``args.patch_batch``) with seeded weights, and one
    1000^2 image; the classifier bias puts ~40% of view 0's pixels on the foreground side, so that the
    random-weight net gives the post-processor a plane with objects. Float32; ``bf16_path`` copies its
    weights into a bfloat16 twin."""
    from tiseg_tpu_torch.datasets.synthetic import make_nuclei, nuclei_density
    from tiseg_tpu_torch.models import build_segmentor
    from tiseg_tpu_torch.utils import Config
    cfg = Config.fromfile(os.path.join(ROOT, UNET_CONFIG))
    cfg.model.test_cfg = dict(cfg.model.test_cfg, device_postprocess=True, patch_batch=args.patch_batch)
    print(f'UNet model: {UNET_CONFIG}, test_cfg {cfg.model.test_cfg}', flush=True)
    seg = build_segmentor(cfg.model, device='cuda', seed=args.seed)
    img = make_nuclei(args.seed + 9000, UNET_HW, nuclei_density(UNET_HW))[0][None]
    logit = seg.forward_heads(torch.from_numpy(img).cuda())['sem']
    bias = -float(torch.quantile((logit[..., 1] - logit[..., 0]).flatten()[::7], 0.6))
    with torch.no_grad():
        seg.net.head.postprocess.bias.copy_(torch.tensor([0.0, bias]))
    return seg, img


def unet_main_path(args):
    """The UNet path three times: the unfolded net (``fast_eval=False``),
    the BN-folded phase-space executor (the default), and the executor with
    the fused last stage (``TISEG_FUSED_TAIL=1``, B10)."""
    from tiseg_tpu_torch.apis import InferenceRunner
    from tiseg_tpu_torch.models.segmentors.unet import instance_postprocess
    from tiseg_tpu_torch.ops import fused_decode
    from tiseg_tpu_torch.ops.fused_decode import fused_decode0_cls
    from tiseg_tpu_torch.ops.instance_pp import instance_postprocess_plain, instance_postprocess_sweep

    hw = UNET_HW
    seg, img = unet_recipe_seg(args)
    img_t = torch.from_numpy(img).cuda()
    runner = InferenceRunner(seg)
    device_pp = seg._device_instance_pp
    captured = {}

    def capturing_pp(sem_pred):
        captured['sem_pred'] = sem_pred
        return device_pp(sem_pred)

    runs = {}
    for name, fast_eval, fused_tail in (('unfolded net', False, False), ('executor', True, False),
                                        ('executor + fused tail', True, True)):
        seg.test_cfg['fast_eval'] = fast_eval
        os.environ['TISEG_FUSED_TAIL'] = '1' if fused_tail else '0'
        seg._device_instance_pp = capturing_pp
        try:
            runner.dispatch(img, (hw, hw))  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            instance_postprocess_sweep.launches = fused_decode0_cls.launches = 0
            instance_postprocess_sweep.strip_launches = instance_postprocess_sweep.global_launches = 0
            out = runner.dispatch(img, (hw, hw))
            torch.cuda.synchronize()
            launches = {'instance_postprocess_sweep': instance_postprocess_sweep.launches,
                        'strip route': instance_postprocess_sweep.strip_launches,
                        'global route': instance_postprocess_sweep.global_launches,
                        'fused_decode0_cls': fused_decode0_cls.launches}
            peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        finally:
            seg._device_instance_pp = device_pp
        n_forwards = -(-200 // args.patch_batch)  # 25 windows x 8 views, in chunks of patch_batch
        if launches != {'instance_postprocess_sweep': 1, 'strip route': 1, 'global route': 0,
                        'fused_decode0_cls': n_forwards if fused_tail else 0}:
            raise AssertionError(f'UNet {name}: launches {launches}, expected 1 of B1 on the strip route and '
                                 f'{n_forwards if fused_tail else 0} of B10')
        sem_pred, sem_out, inst_out = captured['sem_pred'], out['sem_pred'], out['inst_pred']
        if not (sem_out.shape == inst_out.shape == (1, hw, hw) and sem_out.dtype == torch.uint8
                and inst_out.dtype == torch.int32 and sem_out.is_cuda):
            raise AssertionError(f'bad outputs {sem_out.shape} {sem_out.dtype} {inst_out.shape} {inst_out.dtype}')
        fg = float((sem_pred > 0).float().mean())
        n_inst = len(torch.unique(inst_out)) - 1
        if not (0.1 <= fg <= 0.5 and n_inst > 0):
            raise AssertionError(f'degenerate plane: foreground {fg:.3f}, {n_inst} instances')
        ps, pi = instance_postprocess_plain(sem_pred)
        if not (torch.equal(sem_out, ps) and torch.equal(inst_out, pi)):
            raise AssertionError(f'UNet {name}: main-path instances differ from the plain post-processor')
        fused = seg.inference(img_t)['sem']
        if not (fused.shape == (1, hw, hw, 2) and torch.isfinite(fused).all()
                and torch.allclose(fused.sum(-1), torch.ones((), device='cuda'), atol=1e-5)):
            raise AssertionError('fused maps are not finite probabilities of the expected shape')
        e2e_ms = wall_ms(lambda: runner.dispatch(img, (hw, hw)), reps=5)
        fwd_ms = wall_ms(lambda: seg.inference(img_t), reps=5)
        pp_ms = wall_ms(lambda: device_pp(seg._device_sem_pred({'sem': fused})), reps=20)
        print(f'UNet {name}: launches {launches}, foreground {fg:.4f}, {n_inst} instances, equal to the plain '
              f'post-processor; e2e {e2e_ms:.2f} ms per {hw}^2 image (median of 5, patch_batch {args.patch_batch}), '
              f'forward + TTA fuse {fwd_ms:.2f} ms ({fwd_ms / e2e_ms:.1%}), argmax + instance pp {pp_ms:.3f} ms '
              f'({pp_ms / e2e_ms:.2%}); peak memory {peak_gib:.3f} GiB', flush=True)
        runs[name] = dict(fused=fused, sem_pred=sem_pred, sem_out=sem_out, inst_out=inst_out, launches=launches)
    del seg.test_cfg['fast_eval']

    # one more forward with the fused tail, to keep the first launch's inputs: a full patch batch
    launch_fused = fused_decode._launch_cuda

    def capturing_launch(*call_args):
        captured.setdefault('fused_args', call_args)
        return launch_fused(*call_args)

    fused_decode._launch_cuda = capturing_launch
    try:
        seg.inference(img_t)
    finally:
        fused_decode._launch_cuda = launch_fused
        os.environ.pop('TISEG_FUSED_TAIL', None)

    # the three forwards agree: maps within MAP_TOL; where two such maps can disagree on the
    # argmax the class margin is at most 2 * MAP_TOL, and those near-ties are rare
    for a, b in (('executor', 'unfolded net'), ('executor + fused tail', 'executor')):
        fa, fb = runs[a]['fused'], runs[b]['fused']
        diff = float((fa - fb).abs().max())
        near_tie = (fb[..., 1] - fb[..., 0]).abs() <= 2 * MAP_TOL
        differs = runs[a]['sem_pred'] != runs[b]['sem_pred']
        if not (diff <= MAP_TOL and float(near_tie.float().mean()) < 0.01 and not bool((differs & ~near_tie).any())):
            raise AssertionError(f'UNet {a} vs {b}: fused maps differ by {diff:.3e}, near-ties on '
                                 f'{float(near_tie.float().mean()):.4f}, {int((differs & ~near_tie).sum())} '
                                 f'predictions differ outside them')
        print(f'UNet {a} vs {b}: fused maps within {diff:.3e} (bound {MAP_TOL}), class margin <= {2 * MAP_TOL} on '
              f'{float(near_tie.float().mean()):.4%} of the pixels (bound 1%), sem_pred differs on {int(differs.sum())} pixels, '
              f'all near-ties', flush=True)
    main = runs['executor']
    host_s, host_i = instance_postprocess(main['sem_pred'][0].cpu().numpy().astype(np.uint8), radius=1)
    if not (np.array_equal(host_s, main['sem_out'][0].cpu().numpy())
            and partition_bijective(host_i, main['inst_out'][0].cpu().numpy())):
        raise AssertionError('main-path instances differ from the host scipy pipeline')
    print("UNet executor: instances equal to the host pipeline's partition", flush=True)

    stats = {'instance_postprocess_sweep': time_pp_main_path('UNet', main['sem_pred'], 1, 2,
                                                             main['launches']['instance_postprocess_sweep'])}
    # B10 on the first patch batch the main path gave it
    x, z, *weights, _ = captured.pop('fused_args')
    _, fp = last_stage(seg)
    with torch.inference_mode():
        got, want = fused_decode0_cls(x, z, *weights), unfused_tail(fp, x, z)
    err = float((got - want).abs().max())
    if err > 1e-4 * float(want.abs().max()):
        raise AssertionError(f'fused_decode0_cls differs from the unfused tail on the main-path batch by {err:.3e}')
    del got, want
    stats['fused_decode0_cls'] = dict(launches=runs['executor + fused tail']['launches']['fused_decode0_cls'],
                                      **time_fused_decode('UNet main path', x, z, weights, fp, reps=10))
    return stats


# -- phase 3b: the UNet train step ----------------------------------------------------
TRAIN_BATCH, TRAIN_HW = 8, 256  # the main recipe's samples_per_gpu and crop (configs/unet/monuseg.py)
TRAIN_WARMUP, TRAIN_TIMED = 3, 10
TRAIN_CHECK_BATCH = 2  # images of the card-against-CPU check
# 12 MoNuSeg training images x 9 windows of 512^2 at stride 256 (tools/convert_dataset/monuseg.py), batches of 8
# with drop_last: 13 iterations per epoch, so the step decay of epoch 200 falls on iteration 2600
TRAIN_ITERS_PER_EPOCH = 13
# card against CPU on the same weights and batch. float64 on both sides checks the card's path (cuDNN, BN,
# losses) with little rounding. In float32 the gradients of the seeded net carry ~1% of rounding noise on
# either device (the check prints the CPU float32 path's largest error against its float64 path, on the deep
# BN leaves of the 2 x 256^2 check batch): the card's float32 gradient must be about as close to the float64 one
# as the CPU's. tests/test_torch_train_step.py holds the port's CPU float32 gradient against JAX's
F64_LOSS_RTOL, F64_GRAD_RTOL = 1e-10, 1e-8
F32_LOSS_RTOL, F32_GRAD_FACTOR, F32_GRAD_FLOOR = 1e-5, 4.0, 1e-4
# the dice metrics (x 100 of argmax counts, float32 in either path): float64 logits of the two paths agree to ~1e-13,
# so no argmax moves; in float32 a near-tie may move a few pixels of the 2 x 256^2 check batch, ~0.005 points each
F64_METRIC_ATOL, F32_METRIC_ATOL = 1e-4, 0.05
# loss terms with a looser float32 bound, and the total by their share: MultiTaskCDNet's topological loss reads
# an argmax of the logits (its contour from the tc argmax and, with tploss_weight, its weights from the direction
# argmax), and in float32 a near-tie moves a pixel of either (2e-5 of the term seen on the card); HoVer-Net's
# gradient MSE squares the difference of two Sobel-filtered HV maps, which cancels most of them (1.06e-5 of the
# term on the card, 1 x 128^2, the rest of the loss within 6e-6)
ARGMAX_LOSS_TERMS, F32_ARGMAX_RTOL = ('dir_tp_loss', 'hv_msge_loss'), 1e-4
TRAIN_LOGS = ('loss', 'sem_ce_loss', 'sem_dice_loss', 'sem_tdice', 'sem_mdice')


def train_batch(seed: int, n: int, hw: int, device) -> dict:
    """Synthetic nuclei images at MoNuSeg density, their 1px-eroded
    instances as ``sem_gt_inner``, and a weight map of ones (UNetLabelMake's
    border weights come with the data layer)."""
    from tiseg_tpu_torch.datasets.synthetic import make_nuclei, multiclass_nuclei, nuclei_density
    imgs = np.stack([make_nuclei(seed + i, hw, nuclei_density(hw))[0] for i in range(n)])
    inner = np.stack([multiclass_nuclei(seed + i, hw, nuclei_density(hw), num_classes=2)[1] for i in range(n)])
    return {'data': {'img': torch.from_numpy(imgs).to(device)},
            'label': {'sem_gt_inner': torch.from_numpy(inner).to(device),
                      'loss_weight_map': torch.ones(inner.shape, device=device)}}


def batch_on(batch: dict, device, dtype) -> dict:
    """A batch's tensors on ``device``, the image and the float labels in ``dtype``."""
    return {'data': {k: v.to(device, dtype) for k, v in batch['data'].items()},
            'label': {k: v.to(device, dtype) if v.is_floating_point() else v.to(device)
                      for k, v in batch['label'].items()}}


def loss_and_grads(seg, batch):
    for p in seg.net.parameters():
        p.grad = None
    total, logs = seg.loss(batch)
    total.backward()
    grads = {k: p.grad.cpu().double() for k, p in seg.net.named_parameters() if p.requires_grad}
    for p in seg.net.parameters():
        p.grad = None
    return float(total.detach()), grads, {k: float(v.detach()) for k, v in logs.items()}


def relative_errors(grads, want):
    return {k: float((grads[k] - g).norm() / g.norm()) for k, g in want.items()}


def logs_differ(got: dict, want: dict, loss_rtol: float, metric_atol: float, argmax_rtol: float) -> dict:
    """The log values outside their bounds: the loss terms relative to the CPU's (those that read an argmax of
    the logits within ``argmax_rtol``), the dice metrics (x 100, argmax counts) in points."""
    def bound(k, v):
        if 'loss' not in k:
            return metric_atol
        return (argmax_rtol if k in ARGMAX_LOSS_TERMS else loss_rtol) * abs(v)
    return {k: (got.get(k), v) for k, v in want.items() if k not in got or abs(got[k] - v) > bound(k, v)}


def check_train_gradients(cfg, seed: int, batch: dict, name: str = 'UNet',
                          grad_floor: float = F32_GRAD_FLOOR) -> None:
    """The loss, every log value and every gradient leaf of ``seg.loss`` on
    the card against the port's CPU path, on the same seeded weights and
    batch, in float64 and in float32 (each float32 leaf within
    max(F32_GRAD_FACTOR x the CPU's float32 error, ``grad_floor``) of the
    float64 gradient)."""
    from tiseg_tpu_torch.models import build_segmentor
    got = {}
    for device in ('cuda', 'cpu'):
        seg = build_segmentor(cfg.model, device=device, seed=seed)
        for dtype in (torch.float64, torch.float32):
            seg.net.to(dtype)
            got[device, dtype] = loss_and_grads(seg, batch_on(batch, device, dtype))
    (l64, g64, o64), (l32, g32, o32) = got['cpu', torch.float64], got['cpu', torch.float32]
    (c64, gc64, oc64), (c32, gc32, oc32) = got['cuda', torch.float64], got['cuda', torch.float32]
    e64, e32, e_cpu32 = relative_errors(gc64, g64), relative_errors(gc32, g64), relative_errors(g32, g64)
    bound32 = {k: max(F32_GRAD_FACTOR * e_cpu32[k], grad_floor) for k in g64}
    w64, w32 = max(e64, key=e64.get), max(e32, key=lambda k: e32[k] / bound32[k])
    w_cpu = max(e_cpu32, key=e_cpu32.get)
    bad_logs = {**logs_differ(oc64, o64, F64_LOSS_RTOL, F64_METRIC_ATOL, F64_LOSS_RTOL),
                **{f'{k} (float32)': v for k, v in logs_differ(oc32, o32, F32_LOSS_RTOL, F32_METRIC_ATOL,
                                                                 F32_ARGMAX_RTOL).items()}}
    argmax_part = sum(F32_ARGMAX_RTOL * abs(o32[k]) for k in ARGMAX_LOSS_TERMS if k in o32)
    ok = (len(g64) == len(gc64) == len(gc32) and abs(c64 - l64) <= F64_LOSS_RTOL * abs(l64)
          and abs(c32 - l32) <= F32_LOSS_RTOL * abs(l32) + argmax_part and e64[w64] <= F64_GRAD_RTOL
          and all(e32[k] <= bound32[k] for k in g64) and not bad_logs and oc64.keys() == o64.keys())
    print(f'{name} train, card against CPU ({batch["data"]["img"].shape[0]} x {batch["data"]["img"].shape[1]}^2, '
          f'{len(g64)} gradient leaves, {len(o64)} log values): float64 loss {c64!r} / {l64!r} (bound rtol '
          f'{F64_LOSS_RTOL}), worst leaf {w64} at '
          f'{e64[w64]:.3e} (bound {F64_GRAD_RTOL}); float32 loss {c32!r} / {l32!r} (bound rtol {F32_LOSS_RTOL}), '
          f'against the float64 gradient the card\'s worst leaf relative to its bound is {w32} at {e32[w32]:.3e} '
          f'(the CPU\'s float32 path {e_cpu32[w32]:.3e}; bound max({F32_GRAD_FACTOR} x the CPU\'s, '
          f'{grad_floor})), medians card {statistics.median(e32.values()):.3e}, CPU '
          f'{statistics.median(e_cpu32.values()):.3e}, largest card {max(e32.values()):.3e}, CPU '
          f'{e_cpu32[w_cpu]:.3e} ({w_cpu}); card against CPU in float32: worst '
          f'{max(relative_errors(gc32, g32).values()):.3e}; log values outside their bounds (loss terms as the loss, '
          f'{ARGMAX_LOSS_TERMS} within rtol {F32_ARGMAX_RTOL} in float32, dice metrics within {F64_METRIC_ATOL} '
          f'points in float64, {F32_METRIC_ATOL} in float32): {bad_logs}',
          flush=True)
    if not ok:
        raise AssertionError(f'{name} train: the card\'s loss, logs or gradients differ from the CPU\'s beyond the '
                             f'bounds above')


def unet_train_path(args):
    """The main recipe's train step on the card: UNet from the config,
    Adam with its L2 and the step LR with linear warmup through the port's
    engine, batches of 8 x 256^2. Checks the loss and every gradient leaf
    against the port's CPU path on 2 images, times the step, then evaluates
    one of the batch's images through ``seg.inference`` and
    ``seg.postprocess`` (B1) with the trained weights."""
    from tiseg_tpu_torch.apis import build_train_state
    from tiseg_tpu_torch.engine import make_train_step, trainable_parameters
    from tiseg_tpu_torch.models import build_segmentor
    from tiseg_tpu_torch.models.segmentors.unet import instance_postprocess
    from tiseg_tpu_torch.ops.instance_pp import instance_postprocess_sweep
    from tiseg_tpu_torch.utils import Config

    cfg = Config.fromfile(os.path.join(ROOT, UNET_CONFIG))
    cfg.model.test_cfg = dict(cfg.model.test_cfg, device_postprocess=True)
    seg = build_segmentor(cfg.model, device='cuda', seed=args.seed)
    batch = train_batch(args.seed + 20000, TRAIN_BATCH, TRAIN_HW, 'cuda')
    n_params = sum(p.numel() for p in trainable_parameters(seg.net))
    print(f'UNet train: {UNET_CONFIG}, optimizer {dict(cfg.optimizer)}, lr_config {dict(cfg.lr_config)}, '
          f'{TRAIN_ITERS_PER_EPOCH} iterations per epoch; batch {TRAIN_BATCH} x {TRAIN_HW}^2, float32, TF32 off; '
          f'{n_params} trained parameters', flush=True)

    # check 1: loss and gradients on the card against the port's CPU path, same weights and batch
    t0 = time.perf_counter()
    check_train_gradients(cfg, args.seed, {part: {k: v[:TRAIN_CHECK_BATCH] for k, v in items.items()}
                                           for part, items in batch.items()})
    print(f'UNet train, gradient check: {time.perf_counter() - t0:.1f} s', flush=True)

    img = batch['data']['img'][:1]
    before = seg.inference(img)['sem']
    state = build_train_state(seg, cfg, iters_per_epoch=TRAIN_ITERS_PER_EPOCH, seed=args.seed)
    train_step = make_train_step(seg)
    logs_first = None
    for _ in range(TRAIN_WARMUP):
        state, logs = train_step(state, batch)
        logs_first = logs_first or {k: float(logs[k]) for k in TRAIN_LOGS}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the optimizer's share of each step: CUDA events and the host clock around ChainOptimizer.step
    opt_spans = []

    def opt_pre(*_):
        opt_spans.append([torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True),
                          time.perf_counter()])
        opt_spans[-1][0].record()

    def opt_post(*_):
        opt_spans[-1][1].record()
        opt_spans[-1][2] = (time.perf_counter() - opt_spans[-1][2]) * 1e3

    hooks = [state.tx.register_step_pre_hook(opt_pre), state.tx.register_step_post_hook(opt_post)]
    times = []
    for _ in range(TRAIN_TIMED):
        t0 = time.perf_counter()
        state, logs = train_step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    for h in hooks:
        h.remove()
    opt_device_ms = statistics.median(a.elapsed_time(b) for a, b, _ in opt_spans)
    opt_host_ms = statistics.median(host for _, _, host in opt_spans)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    logs_last = {k: float(logs[k]) for k in TRAIN_LOGS}
    step_ms = statistics.median(times)
    if not all(np.isfinite(v) for v in (*logs_first.values(), *logs_last.values())):
        raise AssertionError(f'UNet train: logs not finite: {logs_first} {logs_last}')
    print(f'UNet train step: {step_ms:.2f} ms per step (median of {TRAIN_TIMED} after {TRAIN_WARMUP} warm-ups, '
          f'each ended by a synchronize; min {min(times):.2f}, max {max(times):.2f}), '
          f'{TRAIN_BATCH / step_ms * 1e3:.1f} images/s, peak memory {peak_gib:.3f} GiB; steps {state.step}, '
          f'lr of the last {state.tx.lr_schedule(state.step - 1)!r}', flush=True)
    print(f'UNet train step, optimizer (ChainOptimizer.step, {len(trainable_parameters(seg.net))} leaves): '
          f'{opt_device_ms:.3f} ms on the card\'s stream from the end of the backward to the end of the update '
          f'({opt_device_ms / step_ms:.1%} of the step), {opt_host_ms:.3f} ms on the host clock (medians of '
          f'{len(opt_spans)} steps)', flush=True)
    print(f'UNet train logs, step 0: {json.dumps(logs_first)}', flush=True)
    print(f'UNet train logs, step {state.step - 1}: {json.dumps(logs_last)}', flush=True)

    # check 2: evaluate the trained net; the executor folds the trained weights and statistics
    if seg.net.training:
        raise AssertionError('UNet train: the net is not back in eval mode')
    fused = seg.inference(img)['sem']
    seg.test_cfg['fast_eval'] = False
    unfolded = seg.inference(img)['sem']
    del seg.test_cfg['fast_eval']
    diff, moved = float((fused - unfolded).abs().max()), float((fused - before).abs().max())
    if not (diff <= MAP_TOL < moved):
        raise AssertionError(f'UNet train: executor against unfolded net {diff:.3e} (bound {MAP_TOL}), '
                             f'against the executor before training {moved:.3e} (must exceed {MAP_TOL})')
    instance_postprocess_sweep.launches = instance_postprocess_sweep.cluster_launches = 0
    out = seg.postprocess({'sem': fused[0].cpu().numpy()})
    launches = (instance_postprocess_sweep.launches, instance_postprocess_sweep.cluster_launches)
    sem_pred = fused[0].argmax(-1).cpu().numpy().astype(np.uint8)
    host_s, host_i = instance_postprocess(sem_pred, radius=cfg.model.test_cfg['radius'])
    n_inst = len(np.unique(out['inst_pred'])) - 1
    if not (launches == (1, 1) and np.array_equal(host_s, out['sem_pred'])
            and partition_bijective(host_i, out['inst_pred']) and n_inst > 0):
        raise AssertionError(f'UNet train, eval: B1 launches (all, cluster) {launches}, {n_inst} instances, '
                             f'equal to the host pipeline: {np.array_equal(host_s, out["sem_pred"])}')
    print(f'UNet train, eval of the trained net on one image: executor within {diff:.3e} of the unfolded net '
          f'(bound {MAP_TOL}), {moved:.3e} from the executor before training; B1 launches {launches[0]} '
          f'(cluster route), foreground {float((sem_pred > 0).mean()):.4f}, {n_inst} instances, equal to the host '
          f"pipeline's partition", flush=True)
    return {'config': UNET_CONFIG, 'batch': TRAIN_BATCH, 'ms_per_step': step_ms, 'ms_min': min(times),
            'ms_max': max(times), 'images_per_s': TRAIN_BATCH / step_ms * 1e3, 'peak_gib': peak_gib}


# -- phase 3c: UNet-S2D on the committed trained weights --------------------------------
S2D_CONFIG = 'configs/unet_s2d/unet-s2d_adam-lr1e-4_bs8_256x256_300e_monuseg.py'
S2D_TEST_CFG = dict(mode='whole', device_postprocess=True, radius=1)  # bench.py's test_cfg
S2D_SEED0, S2D_HELDOUT = 200, 16  # bench.py:_heldout_aji: held-out seeds 200-215, 256^2 each
S2D_BATCH, S2D_TIMED = 128, 25  # bench.py's throughput batch; CUDA-event-timed calls per median
S2D_CHECK = 2  # images of the card-against-CPU check
S2D_F32_ATOL, S2D_F32_RTOL = 1e-4, 1e-4  # float32 executor, card against CPU: sums in other orders
# (route, the executors' dtype, int8-resident); the bench's int8 route keeps bfloat16 around the int8 convs
S2D_ROUTES = (('float32', torch.float32, False), ('bf16', torch.bfloat16, False),
              ('int8', torch.bfloat16, True), ('int8, float32 around', torch.float32, True))
S2D_GATE_TOL = 0.5  # bench.py:469-472: AJI points (x 100) the bf16 and int8 routes may lose
INT8_OPS_PER_S = 1979e12  # H100 SXM tensor cores, int8, dense (data sheet)
# the int8 convs of the executor in call order: stem, stages, per decoder the tconv and the split concat
# conv's two halves, decode0's two halves
S2D_SITES = (['stem0', 'stem1'] + [f's{s}c{c}' for s, n in zip(range(1, 5), (2, 3, 3, 3)) for c in range(n)]
             + [f'dec{i}.{p}' for i in range(4, 0, -1) for p in ('pt', 'pc/up', 'pc/skip')]
             + ['dec0.c/up', 'dec0.c/skip'])


def s2d_segs(device, sd, fpq):
    """UNet-S2D from its config with bench.py's test_cfg, one per executor
    dtype, holding the fixture's weights and int8 tree."""
    from tiseg_tpu_torch.models import build_segmentor
    from tiseg_tpu_torch.utils import Config
    cfg = Config.fromfile(os.path.join(ROOT, S2D_CONFIG))
    segs = {}
    for dtype in (torch.float32, torch.bfloat16):
        seg = segs[dtype] = build_segmentor(dict(cfg.model, test_cfg=dict(S2D_TEST_CFG)), device=device, dtype=dtype)
        seg.net.load_state_dict(sd)
        seg._int8_fpq = fpq
    return segs


def s2d_scores(seg, data, int8: bool):
    """``seg.inference_and_postprocess`` on the held-out images (``ori_hw``
    None, as bench.py:_heldout_aji calls it) and the port's metrics of the
    instance maps against the synthetic ground truth: binary AJI x 100 (the
    bench's reducer), binary PQ, instance Dice, the foreground's Dice, and
    the AJI of the device metrics (ops/inst_metrics.py)."""
    from tiseg_tpu_torch.ops.inst_metrics import pre_eval_all_device
    from tiseg_tpu_torch.utils.metrics import (pre_eval_all_semantic_metric, pre_eval_bin_aji, pre_eval_bin_pq,
                                               pre_eval_to_bin_aji, pre_eval_to_bin_pq, pre_eval_to_inst_dice,
                                               pre_eval_to_sem_metrics)
    seg.test_cfg['int8_eval'] = int8
    img = torch.from_numpy(np.stack([d[0] for d in data])).to(seg.device)
    out = seg.inference_and_postprocess(img)
    sem, inst = out['sem_pred'], out['inst_pred']
    if inst.shape != img.shape[:3] or inst.dtype != torch.int32 or sem.dtype != torch.uint8:
        raise AssertionError(f'UNet-S2D: inst_pred {inst.dtype} {tuple(inst.shape)}, sem_pred {sem.dtype}')
    inst_np, sem_np = inst.cpu().numpy(), sem.cpu().numpy()
    aji = [pre_eval_bin_aji(inst_np[i], d[2]) for i, d in enumerate(data)]
    pq = [pre_eval_bin_pq(inst_np[i], d[2]) for i, d in enumerate(data)]
    sem_pre = [pre_eval_all_semantic_metric(sem_np[i], d[1], 2) for i, d in enumerate(data)]
    dev = [pre_eval_all_device(sem[i], inst[i], torch.from_numpy(d[1]).to(seg.device),
                               torch.from_numpy(d[2]).to(seg.device), 2)[1] for i, d in enumerate(data)]
    return inst_np, {'aji': round(float(pre_eval_to_bin_aji(aji)['Aji']) * 100, 3),
                     'pq': float(pre_eval_to_bin_pq(pq)['PQ']), 'inst_dice': float(pre_eval_to_inst_dice(pq)['InstDice']),
                     'dice': float(pre_eval_to_sem_metrics(sem_pre, ['Dice'])['Dice'][0]),
                     'device_aji': float(sum(float(i) for i, _ in dev) / sum(float(u) for _, u in dev)) * 100}


def s2d_int8_calls(seg, img):
    """Every int8 convolution of one int8-resident forward of ``img``:
    [(site, input, kernel, output, plain version)] in call order."""
    from tiseg_tpu_torch.models.heads import s2d_exec
    from tiseg_tpu_torch.ops import int8_conv
    calls = []

    def rec(fn, plain):
        def call(x, W):
            y = fn(x, W)
            calls.append((S2D_SITES[len(calls)], x, W, y, plain))
            return y
        return call

    conv, tconv = s2d_exec._conv_i8, s2d_exec._tconv
    s2d_exec._conv_i8 = rec(conv, int8_conv.conv2d_i8_plain)
    s2d_exec._tconv = rec(tconv, int8_conv.conv_transpose2x_i8_plain)
    try:
        prep = seg.prepare_inference()
        s2d_exec.apply_s2d_q8(prep['s2d'], seg._int8_fpq, img, dtype=seg.dtype, out='pred')
    finally:
        s2d_exec._conv_i8, s2d_exec._tconv = conv, tconv
    if len(calls) != len(S2D_SITES):
        raise AssertionError(f'UNet-S2D: {len(calls)} int8 convolutions, expected {len(S2D_SITES)}')
    return calls


def int8_conv_shape(x: torch.Tensor, W: torch.Tensor):
    """(M, K, N, products) of the ``torch._int_mm`` calls of one int8 conv:
    channels padded to multiples of 8; a transposed conv is four products
    of 2 x 2 taps."""
    Cp, Np = -(-W.shape[2] // 8) * 8, -(-W.shape[3] // 8) * 8
    M = x.shape[0] * x.shape[1] * x.shape[2]
    if W.shape[0] == 4:
        return M, 4 * Cp, Np, 4
    return M, W.shape[0] * W.shape[1] * Cp, Np, 1


def time_int8_site(site, x, W):
    """One int8 conv site at the main path's shape: the wrapper (im2col and
    torch._int_mm), torch._int_mm alone on operands of the same shape,
    cuDNN's bf16 convolution of the same shape, and the bound (the product's
    operations at the int8 tensor-core rate, or the input, kernel and int32
    output bytes, whichever is longer)."""
    import torch.nn.functional as F

    from tiseg_tpu_torch.ops import int8_conv
    tconv = W.shape[0] == 4
    fn = int8_conv.conv_transpose2x_i8 if tconv else int8_conv.conv2d_i8
    M, K, N, n_mm = int8_conv_shape(x, W)
    a = torch.randint(-127, 128, (M, K), dtype=torch.int8, device='cuda')
    b = torch.randint(-127, 128, (N, K), dtype=torch.int8, device='cuda').t()
    xb = x.to(torch.bfloat16).permute(0, 3, 1, 2)
    if tconv:
        wb = W.to(torch.bfloat16).flip(0, 1).permute(2, 3, 0, 1).contiguous()
        ref = lambda: F.conv_transpose2d(xb, wb, stride=2, padding=1)  # noqa: E731
    else:
        wb = W.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        ref = lambda: F.conv2d(xb, wb, padding=W.shape[0] // 2)  # noqa: E731
    out_px = x.shape[0] * x.shape[1] * x.shape[2] * (4 if tconv else 1)
    ops = 2.0 * M * K * N * n_mm
    n_bytes = x.numel() + W.numel() + 4 * out_px * W.shape[3]
    op_ms, byte_ms = ops / INT8_OPS_PER_S * 1e3, bytes_ms(n_bytes)
    return {'site': site, 'x': list(x.shape), 'w': list(W.shape), 'mm': [M, K, N, n_mm],
            'ms': cuda_ms(lambda: fn(x, W), S2D_TIMED),
            'int_mm_ms': cuda_ms(lambda: [torch._int_mm(a, b) for _ in range(n_mm)], S2D_TIMED),
            'cudnn_bf16_ms': cuda_ms(ref, S2D_TIMED),
            'bound_ms': max(op_ms, byte_ms), 'bound_by': 'operations' if op_ms >= byte_ms else 'bytes'}


def time_s2d_executor(seg, img, int8: bool):
    """ms per batch (median of S2D_TIMED CUDA-event-timed calls after 3
    warm-ups) and peak GiB of the executor alone (``forward_heads`` with the
    folded weights built once) and of the whole eval step
    (``inference_and_postprocess``: the fold, the executor, argmax or the
    pred route, B1)."""
    seg.test_cfg['int8_eval'] = int8
    prep = seg.prepare_inference()
    out = {}
    for what, fn in (('forward', lambda: seg.forward_heads(img, prep=prep)),
                     ('e2e', lambda: seg.inference_and_postprocess(img))):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(fn, S2D_TIMED)
        out[f'{what}_ms'] = ms
        out[f'{what}_patches_per_s'] = img.shape[0] / ms * 1e3
        out[f'{what}_peak_gib'] = torch.cuda.max_memory_allocated() / 2 ** 30
    return out


def unet_s2d_path(args):
    """UNet-S2D on the fixture's trained weights: the held-out AJI of the
    float32, bf16 and int8-resident routes, gated as bench.py gates it live;
    every int8 conv bit-exact against its plain version; the float32 and
    int8 executors against the CPU; the executors and each int8 conv site
    timed at the bench's batch."""
    from tiseg_tpu_torch.datasets.synthetic import make_nuclei
    from tiseg_tpu_torch.ops import int8_conv
    from tiseg_tpu_torch.ops.instance_pp import instance_postprocess_sweep
    from tiseg_tpu_torch.utils.fixture import FIXTURE_PATH, load_fixture

    t0 = time.perf_counter()
    sd, fpq, meta = load_fixture(device='cuda')
    segs = s2d_segs('cuda', sd, fpq)
    rec = meta['s2d']
    print(f'UNet-S2D: {S2D_CONFIG} on {os.path.relpath(FIXTURE_PATH, ROOT)} ({len(sd)} tensors, '
          f'{len(fpq["wq"])} int8 sites) read in {time.perf_counter() - t0:.1f} s; recorded {json.dumps(rec)}',
          flush=True)
    data = [make_nuclei(S2D_SEED0 + i) for i in range(S2D_HELDOUT)]
    img = torch.from_numpy(np.stack([d[0] for d in data])).cuda()
    scores, insts = {}, {}
    for name, dtype, int8 in S2D_ROUTES:
        seg = segs[dtype]
        before = pp_launches(instance_postprocess_sweep)
        int8_conv.conv2d_i8.launches = int8_conv.conv_transpose2x_i8.launches = 0
        insts[name], scores[name] = s2d_scores(seg, data, int8)
        check_pp_launches(instance_postprocess_sweep, before, img.shape[:3])
        convs = (int8_conv.conv2d_i8.launches, int8_conv.conv_transpose2x_i8.launches)
        if convs != ((23, 4) if int8 else (0, 0)):
            raise AssertionError(f'UNet-S2D {name}: int8 conv launches {convs}')
        s = scores[name]
        print(f'UNet-S2D held-out, {name}: binary AJI x 100 {s["aji"]:.3f} (device metrics {s["device_aji"]:.3f}), '
              f'PQ {s["pq"]:.4f}, instance Dice {s["inst_dice"]:.4f}, foreground Dice {s["dice"]:.4f}; B1 '
              f'{route_note(instance_postprocess_sweep, pp_layout, None, img.shape[:3])[2:]}; int8 conv launches '
              f'{convs[0]} + {convs[1]} transposed', flush=True)
    bf16, int8 = scores['bf16']['aji'], scores['int8']['aji']
    gates = {'bf16 >= std_bf16_aji - 0.5': bf16 >= rec['std_bf16_aji'] - S2D_GATE_TOL,
             'bf16 >= s2d_bf16_aji - 1.0': bf16 >= rec['s2d_bf16_aji'] - 2 * S2D_GATE_TOL,
             'int8 >= bf16 - 0.5': int8 >= bf16 - S2D_GATE_TOL,
             'int8 >= std_bf16_aji - 0.5': int8 >= rec['std_bf16_aji'] - S2D_GATE_TOL}
    print(f'UNet-S2D gates (bench.py:469-472): {json.dumps(gates)}', flush=True)
    if not all(gates.values()):
        raise AssertionError(f'UNet-S2D: a held-out AJI gate failed: {scores}')

    # every int8 conv of the executor on the held-out batch against its plain version (float64) on the card
    calls = s2d_int8_calls(segs[torch.bfloat16], img)
    bad = [site for site, x, W, y, plain in calls if not torch.equal(y, plain(x, W))]
    if bad:
        raise AssertionError(f'UNet-S2D: int8 convs differ from their plain version at {bad}')
    print(f'UNet-S2D int8 convs: {len(calls)} calls on {S2D_HELDOUT} x 256^2 bit-exact against the plain '
          f'version: {", ".join(f"{s} {tuple(x.shape)}x{tuple(W.shape)}" for s, x, W, _, _ in calls)}', flush=True)
    del calls

    # the card against the port's CPU path on S2D_CHECK images: the float32 executor's logits, and the int8
    # executor's activations (exact sums, one rounding per float operation on both devices) and argmax
    cpu_segs = s2d_segs('cpu', {k: v.cpu() for k, v in sd.items()},
                        {'act': {k: v.cpu() for k, v in fpq['act'].items()},
                         'wq': {k: (w.cpu(), s.cpu()) for k, (w, s) in fpq['wq'].items()}})
    pair = (segs[torch.float32], cpu_segs[torch.float32])
    x = [img[:S2D_CHECK].to(seg.device) for seg in pair]
    logits, q8 = [], []
    for seg, xi in zip(pair, x):
        seg.test_cfg['int8_eval'] = False
        logits.append(seg.forward_heads(xi)['sem'].cpu())
        seg.test_cfg['int8_eval'] = True
        q8.append(seg.forward_heads(xi)['sem'].cpu())
    f32_err = (logits[0] - logits[1]).abs()
    f32_ok = bool((f32_err <= S2D_F32_ATOL + S2D_F32_RTOL * logits[1].abs()).all())
    acts = [[c[1].cpu() for c in s2d_int8_calls(seg, xi)] for seg, xi in zip(pair, x)]
    act_diff = sum(int((a != b).sum()) for a, b in zip(*acts))
    flips = q8[0].argmax(-1) != q8[1].argmax(-1)
    far = flips & ((q8[1][..., 1] - q8[1][..., 0]).abs() > S2D_F32_ATOL)
    print(f'UNet-S2D card against CPU on {S2D_CHECK} images: float32 logits within {float(f32_err.max()):.3e} '
          f'(bound {S2D_F32_ATOL} + {S2D_F32_RTOL} x |logit|, largest {float(logits[1].abs().max()):.2f}); int8 '
          f'activations differing {act_diff} of {sum(a.numel() for a in acts[1])}; int8 argmax pixels differing '
          f'{int(flips.sum())}, {int(far.sum())} of them outside near-ties', flush=True)
    if not (f32_ok and act_diff == 0 and not far.any()):
        raise AssertionError('UNet-S2D: the card differs from the CPU beyond the bounds')
    del cpu_segs

    # timing at the bench's batch: the executors, then each int8 conv site
    imgs = torch.from_numpy(np.stack([d[0] for d in data] * (S2D_BATCH // S2D_HELDOUT))).cuda()
    timing = {name: time_s2d_executor(segs[dtype], imgs, int8) for name, dtype, int8 in S2D_ROUTES[1:3]}
    for name, t in timing.items():
        print(f'UNet-S2D {name} at {S2D_BATCH} x 256^2: forward {t["forward_ms"]:.3f} ms '
              f'({t["forward_patches_per_s"]:.1f} patches/s, peak {t["forward_peak_gib"]:.3f} GiB); forward + argmax '
              f'+ B1 {t["e2e_ms"]:.3f} ms ({t["e2e_patches_per_s"]:.1f} patches/s, peak {t["e2e_peak_gib"]:.3f} GiB)',
              flush=True)
    sites = [time_int8_site(site, x, W) for site, x, W, _, _ in s2d_int8_calls(segs[torch.bfloat16], imgs)]
    for s in sites:
        print(f'UNet-S2D int8 site {s["site"]}: {s["x"]} x {s["w"]}: {s["ms"]:.4f} ms (torch._int_mm alone '
              f'{s["int_mm_ms"]:.4f}, cuDNN bf16 conv {s["cudnn_bf16_ms"]:.4f}, bound {s["bound_ms"]:.4f} by '
              f'{s["bound_by"]})', flush=True)
    print(json.dumps({'unet_s2d': {'heldout': scores, 'gates': gates, 'timing': timing, 'int8_sites': sites,
                                   'card_vs_cpu': {'f32_max_abs': float(f32_err.max()),
                                                   'int8_acts_differing': act_diff,
                                                   'int8_argmax_differing': int(flips.sum())}}}), flush=True)


# -- phase 3d: the data layer and the eval loop ------------------------------------------
DATA_DIR = os.path.join(ROOT, 'build', 'dev', 'datasets')  # gitignored; written anew on every run
LOOP_HW, LOOP_TILES = 1000, 3  # the converter's w0_s0 eval images
# MoNuSeg 2018's training set: ~21,600 nuclei in 30 images of 1000^2, ~720 per tile (nuclei_density(1000),
# 2,288, would send every tile past the device metrics' cap of 1024 instances)
LOOP_NUCLEI = 720
WINDOW_HW, WINDOW_NUCLEI = 512, 189  # the converter's w512_s256 windows: 720 x (512 / 1000)^2 nuclei
WINDOWS = 108  # 12 training images x 9 windows: 13 batches of 8 per epoch, as TRAIN_ITERS_PER_EPOCH
LOADER_WARMUP, LOADER_TIMED = 3, 10  # loader-fed train steps of one epoch: warm-ups, then timed
LOOP_FOREGROUND = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6)  # the seeded classifier's foreground shares tried
SPIN_CYCLES = 10 ** 9  # torch.cuda._sleep: ~0.5 s at the H100's 1.98 GHz
S2D_AJI_TOL = 0.02  # AJI points: the dataset loop (batch 1) against the direct batch of 16
PQ_IOU_RTOL = 1e-6  # the device PQ's float32 sum of paired IoUs against the host's float64 one


def write_tiles(name: str, seeds, hw: int, n_inst: int):
    """``make_nuclei`` images, uint8-quantized, in the MoNuSeg layout under
    DATA_DIR/name; returns the dataset's keyword arguments and the data."""
    from tiseg_tpu_torch.datasets.synthetic import make_nuclei, write_monuseg_layout
    root = os.path.join(DATA_DIR, name)
    data = [make_nuclei(s, hw, n_inst) for s in seeds]
    write_monuseg_layout(root, [f'{name}_{s}' for s in seeds], [np.round(d[0] * 255) for d in data],
                         [d[1] for d in data], [d[2] for d in data])
    return dict(type='MoNuSegDataset', data_root=root, img_dir='', ann_dir='', split='split.txt'), data


def packages_equal(device, host) -> bool:
    """A device pre-eval package against the host one of the same prediction:
    the semantic histograms and the AJI and PQ counts equal, the PQ's IoU
    sum within PQ_IOU_RTOL."""
    d_pq, h_pq = device['bin_pq_pre_eval_res'], host['bin_pq_pre_eval_res']
    return (tuple(device['bin_aji_pre_eval_res']) == tuple(host['bin_aji_pre_eval_res'])
            and tuple(d_pq[:3]) == tuple(h_pq[:3]) and abs(d_pq[3] - h_pq[3]) <= PQ_IOU_RTOL * abs(h_pq[3])
            and all(np.array_equal(a, b) for a, b in zip(device['sem_pre_eval_res'], host['sem_pre_eval_res'])))


def check_pre_eval_routes(label, ds, preds, cap=1024):
    """Every prediction's device pre-eval package against its host one;
    prints the route each image took (the device, or the host past the cap)."""
    routes = []
    for i, pred in enumerate(preds):
        n = max(len(np.unique(pred['inst_pred'])) - 1, len(np.unique(ds._load_gts(i)[1])) - 1)
        routes.append(f'{n} instances, {"device" if n <= cap else "host (cap)"}')
        device, host = ds.pre_eval_device(pred, i, max_instances=cap, device='cuda')[0], ds.pre_eval(pred, i)[0]
        if not packages_equal(device, host):
            raise AssertionError(f'{label}, image {i}: device pre-eval {device} differs from host {host}')
    print(f'{label}: every device pre-eval package equals the host one; routes {routes}', flush=True)


def serial_test(seg, ds):
    """The loop without the pipeline: dispatch, wait, consume, image by image."""
    from tiseg_tpu_torch.apis.test import InferenceRunner, fetch_later
    runner, results = InferenceRunner(seg), []
    for i in range(len(ds)):
        item = ds[i]
        out = fetch_later(runner.dispatch(item['data']['img'][None], item['metas']['ori_hw']))()
        results.extend(ds.pre_eval_device({k: v[0] for k, v in out.items()}, i, device=seg.device))
    return results


def dataset_paths(args):
    """The data layer and the eval loop on the card (``single_device_test``,
    datasets, pipelines, loader): UNet-S2D's held-out images as a dataset,
    the main recipe's eval over 1000^2 tiles, and its train pipeline feeding
    the train step through the loader."""
    import shutil
    from tiseg_tpu_torch.apis import InferenceRunner, build_train_state, single_device_test
    from tiseg_tpu_torch.datasets import build_dataloader, build_dataset, collate, sample_seed
    from tiseg_tpu_torch.engine import make_train_step
    from tiseg_tpu_torch.models import build_segmentor
    from tiseg_tpu_torch.ops.instance_pp import instance_postprocess_sweep
    from tiseg_tpu_torch.utils import Config
    from tiseg_tpu_torch.utils.fixture import load_fixture
    from tiseg_tpu_torch.utils.metrics import pre_eval_bin_aji, pre_eval_to_bin_aji

    shutil.rmtree(DATA_DIR, ignore_errors=True)
    print(f'datasets: host {os.cpu_count()} cores; files under {os.path.relpath(DATA_DIR, ROOT)} (MoNuSeg layout: '
          f'.tif, _sem.png, _inst.npy, split.txt; PIL writes and reads them)', flush=True)

    # part 1: UNet-S2D on the fixture's weights over its held-out images as a dataset
    t0 = time.perf_counter()
    s2d_cfg = Config.fromfile(os.path.join(ROOT, S2D_CONFIG))
    kw, data = write_tiles('heldout', range(S2D_SEED0, S2D_SEED0 + S2D_HELDOUT), 256, 150)
    ds = build_dataset(dict(kw, processes=s2d_cfg.data.test.processes))
    sd, fpq, _ = load_fixture(device='cuda')
    seg = s2d_segs('cuda', sd, fpq)[torch.float32]
    seg.test_cfg['device_metrics'] = True
    results = single_device_test(seg, ds, progress=False)
    loop_aji = ds.evaluate(results)[0]['bAji']
    img = torch.from_numpy(np.stack([np.round(d[0] * 255).astype(np.float32) / 255. for d in data])).cuda()
    inst = seg.inference_and_postprocess(img)['inst_pred'].cpu().numpy()
    direct_aji = pre_eval_to_bin_aji([pre_eval_bin_aji(inst[i], d[2]) for i, d in enumerate(data)])['Aji'] * 100
    print(f'datasets, UNet-S2D held-out as a dataset ({S2D_HELDOUT} x 256^2 uint8, test_processes '
          f'{[p["type"] for p in s2d_cfg.data.test.processes]}, float32, device metrics): '
          f'evaluate bAji {loop_aji:.2f}; the direct batch of the same images {direct_aji:.3f}; PR 13 on float '
          f'images 65.379', flush=True)
    if abs(loop_aji - direct_aji) > S2D_AJI_TOL:
        raise AssertionError(f'UNet-S2D dataset loop bAji {loop_aji} against the direct batch {direct_aji:.3f}')
    preds = single_device_test(seg, ds, pre_eval=False, progress=False)
    check_pre_eval_routes('datasets, UNet-S2D held-out', ds, preds)
    del seg, sd, fpq
    torch.cuda.empty_cache()
    print(f'datasets, part 1: {time.perf_counter() - t0:.1f} s', flush=True)

    # part 2: the main recipe's eval at full width over 1000^2 tiles, seeded weights
    t0 = time.perf_counter()
    cfg = Config.fromfile(os.path.join(ROOT, UNET_CONFIG))
    cfg.model.test_cfg = dict(cfg.model.test_cfg, device_postprocess=True, device_metrics=True,
                              patch_batch=args.patch_batch)
    kw, _ = write_tiles('w0_s0', range(args.seed + 30000, args.seed + 30000 + LOOP_TILES), LOOP_HW, LOOP_NUCLEI)
    ds = build_dataset(dict(kw, processes=cfg.data.test.processes))
    seg = build_segmentor(cfg.model, device='cuda', seed=args.seed)
    # classifier bias: of the biases that put a share of view 0's pixels on the foreground side, the one whose
    # instance count through the whole eval path comes nearest to the tiles' nuclei
    runner = InferenceRunner(seg)
    item = ds[0]
    margin = seg.forward_heads(torch.from_numpy(item['data']['img'][None]).cuda())['sem'].diff(dim=-1).flatten()[::7]
    scan = {}
    for fg in LOOP_FOREGROUND:
        bias = -float(torch.quantile(margin, 1 - fg))
        with torch.no_grad():
            seg.net.head.postprocess.bias.copy_(torch.tensor([0.0, bias]))
        out = runner.dispatch(item['data']['img'][None], item['metas']['ori_hw'])
        scan[fg] = (bias, len(torch.unique(out['inst_pred'])) - 1)
    fg = min(scan, key=lambda f: abs(scan[f][1] - LOOP_NUCLEI))
    with torch.no_grad():
        seg.net.head.postprocess.bias.copy_(torch.tensor([0.0, scan[fg][0]]))
    print(f'datasets, UNet seeded classifier: instances of tile 0 per foreground share of view 0 '
          f'{ {f: n for f, (_, n) in scan.items()} }; bias {scan[fg][0]:.4f} ({fg:.0%})', flush=True)
    del margin
    before = (instance_postprocess_sweep.launches, instance_postprocess_sweep.strip_launches)
    preds = single_device_test(seg, ds, pre_eval=False, progress=False)
    launches = (instance_postprocess_sweep.launches - before[0], instance_postprocess_sweep.strip_launches - before[1])
    if launches != (LOOP_TILES, LOOP_TILES):
        raise AssertionError(f'UNet loop: B1 launches (all, strip route) {launches}, expected one per image')
    for i, pred in enumerate(preds):
        item = ds[i]
        want = runner(item['data']['img'][None], item['metas']['ori_hw'])
        if not (np.array_equal(pred['inst_pred'], want['inst_pred'][0])
                and np.array_equal(pred['sem_pred'], want['sem_pred'][0])):
            raise AssertionError(f'UNet loop, image {i}: the loop prediction differs from a direct InferenceRunner call')
        if pred['inst_pred'].max() <= 0:
            raise AssertionError(f'UNet loop, image {i}: no instance')
    print(f'datasets, UNet {UNET_CONFIG} over {LOOP_TILES} x {LOOP_HW}^2 tiles ({LOOP_NUCLEI} nuclei each), test_cfg '
          f'{dict(seg.test_cfg)}: inst_pred equal to direct InferenceRunner calls; B1 launches {launches[0]} '
          f'(strip route), one per image', flush=True)
    check_pre_eval_routes('datasets, UNet 1000^2', ds, preds)
    # a host sync inside dispatch would make it wait for a spin kernel queued before it
    spans = {}
    for spin in (0, 0, SPIN_CYCLES):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(spin)
        t1 = time.perf_counter()
        runner.dispatch(item['data']['img'][None], item['metas']['ori_hw'])
        t2 = time.perf_counter()
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        torch.cuda.synchronize()
        spans[spin] = ((t2 - t1) * 1e3, start.elapsed_time(end))
    # what the host does inside dispatch behind the spin kernel: the CUDA runtime calls the profiler sees
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function('dispatch'):
            runner.dispatch(item['data']['img'][None], item['metas']['ori_hw'])
    torch.cuda.synchronize()
    span = next(e.time_range for e in prof.events() if e.name == 'dispatch')
    calls = collections.Counter(e.name for e in prof.events() if span.start <= e.time_range.start <= span.end
                                and (e.name.startswith('cuda') or e.name == 'Command Buffer Full'))
    launches = sum(n for name, n in calls.items() if name.startswith('cudaLaunch'))
    waits = {name: n for name, n in calls.items() if 'ynchronize' in name or 'Alloc' in name or 'Full' in name}
    print(f'datasets, UNet dispatch: returns after {spans[0][0]:.2f} ms of a {spans[0][1]:.2f} ms image; behind a '
          f'spin kernel of {spans[SPIN_CYCLES][1] - spans[0][1]:.2f} ms queued first, after {spans[SPIN_CYCLES][0]:.2f} '
          f'ms; inside it (torch.profiler, behind the spin kernel) {launches} kernel launches and the calls that wait '
          f'{waits}', flush=True)
    loops = {'pipelined': lambda: single_device_test(seg, ds, progress=False), 'serial': lambda: serial_test(seg, ds)}
    ms = {name: [] for name in loops}
    for name in ('pipelined', 'serial', 'serial', 'pipelined'):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        results = loops[name]()
        ms[name].append((time.perf_counter() - t1) * 1e3 / LOOP_TILES)
    res = ds.evaluate(results)[0]
    print(f'datasets, UNet loop ms per {LOOP_HW}^2 image with device metrics, in turns: pipelined '
          f'{ms["pipelined"][0]:.2f}, {ms["pipelined"][1]:.2f}; serial {ms["serial"][0]:.2f}, {ms["serial"][1]:.2f} '
          f'(PERF.md section 5, InferenceRunner alone: 438-463); bAji of the seeded net {res["bAji"]}', flush=True)
    del seg, runner
    torch.cuda.empty_cache()
    print(f'datasets, part 2: {time.perf_counter() - t0:.1f} s', flush=True)

    # part 3: the recipe's train pipeline feeding the train step through the loader
    t0 = time.perf_counter()
    kw, _ = write_tiles('w512_s256', range(args.seed + 40000, args.seed + 40000 + WINDOWS), WINDOW_HW, WINDOW_NUCLEI)
    ds = build_dataset(dict(kw, processes=cfg.data.train.processes))
    loader = build_dataloader(ds, samples_per_gpu=cfg.data.samples_per_gpu, workers_per_gpu=cfg.data.workers_per_gpu,
                              seed=args.seed)
    print(f'datasets, train: {len(ds)} windows of {WINDOW_HW}^2 ({WINDOW_NUCLEI} nuclei each) written in '
          f'{time.perf_counter() - t0:.1f} s; processes {[p["type"] for p in cfg.data.train.processes]}; batches of '
          f'{loader.batch_size}, {loader.num_workers} worker threads, {len(loader)} per epoch', flush=True)
    t1 = time.perf_counter()
    for i in range(8):
        ds.sample(i, i)
    serial_ms = (time.perf_counter() - t1) * 1e3 / 8
    t1 = time.perf_counter()
    batches = list(loader)
    loader_s = time.perf_counter() - t1
    n = sum(len(b['metas']) for b in batches)
    idx = loader.batches()[0]
    want = collate([ds.sample(int(i), sample_seed(args.seed, 0, int(i))) for i in idx])
    got = batches[0]
    same = all(np.array_equal(got[g][k], want[g][k]) and got[g][k].dtype == want[g][k].dtype
               for g in ('data', 'label') for k in want[g]) and got['metas'] == want['metas']
    shapes = {f'{g}/{k}': (tuple(v.shape), str(v.dtype)) for g in ('data', 'label') for k, v in got[g].items()}
    if not (same and shapes == {'data/img': ((8, 256, 256, 3), 'float32'), 'label/sem_gt': ((8, 256, 256), 'int32'),
                                'label/sem_gt_inner': ((8, 256, 256), 'int32'),
                                'label/loss_weight_map': ((8, 256, 256), 'float32')}):
        raise AssertionError(f'datasets, train: loader batch equal to the mapper on the same seeds: {same}; {shapes}')
    print(f'datasets, train: the first loader batch equals the mapper on its indices and seeds; {shapes}; one sample '
          f'through the pipeline {serial_ms:.1f} ms on one thread; the loader alone {n / loader_s:.1f} samples/s '
          f'({n} samples in {loader_s:.2f} s)', flush=True)

    seg = build_segmentor(cfg.model, device='cuda', seed=args.seed)
    state = build_train_state(seg, cfg, iters_per_epoch=len(loader), seed=args.seed)
    step = make_train_step(seg)
    staged = [{g: {k: torch.from_numpy(v).cuda() for k, v in b[g].items()} for g in ('data', 'label')}
              for b in batches]

    def run_epoch(epoch, source):
        """One epoch of steps; ms per timed step (host clock, one synchronize at the end) and the summed
        CUDA-event time of the timed steps."""
        loader.set_epoch(epoch)
        events = []
        it = iter(loader) if source == 'loader' else iter(staged)
        for k in range(LOADER_WARMUP):
            state_box[0], _ = step(state_box[0], next(it))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for k in range(LOADER_TIMED):
            batch = next(it)
            events.append((torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)))
            events[-1][0].record()
            state_box[0], logs = step(state_box[0], batch)
            events[-1][1].record()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t1) * 1e3
        for _ in it:  # the rest of the epoch: the loader's threads end with it
            pass
        if not np.isfinite(float(logs['loss'])):
            raise AssertionError(f'datasets, train: loss not finite {logs}')
        return wall / LOADER_TIMED, sum(a.elapsed_time(b) for a, b in events) / wall

    state_box = [state]
    read = {'loader': [], 'staged': []}
    for epoch, source in enumerate(('loader', 'staged', 'staged', 'loader')):
        read[source].append(run_epoch(epoch + 1, source))
    steps = state_box[0].step
    # the card's work per step: the pre-staged steps' CUDA-event time (the host runs ahead of them); the events of a
    # loader-fed step also span the gaps in which its enqueue waits for the interpreter lock
    work_ms = statistics.median(ms * busy for ms, busy in read['staged'])
    idle = [1 - work_ms / ms for ms, _ in read['loader']]
    print(f'datasets, train steps ({steps} in all, {LOADER_TIMED} timed per epoch after {LOADER_WARMUP}, in turns): '
          f'fed by the loader {read["loader"][0][0]:.2f}, {read["loader"][1][0]:.2f} ms per step '
          f'({cfg.data.samples_per_gpu * 1e3 / read["loader"][0][0]:.1f}, '
          f'{cfg.data.samples_per_gpu * 1e3 / read["loader"][1][0]:.1f} images/s), the card idle {idle[0]:.1%}, '
          f'{idle[1]:.1%} of the wall time ({work_ms:.2f} ms of work per step; the CUDA events of the loader-fed steps '
          f'span {read["loader"][0][1]:.1%}, {read["loader"][1][1]:.1%} of it); pre-staged on the card '
          f'{read["staged"][0][0]:.2f}, {read["staged"][1][0]:.2f} ms, events {read["staged"][0][1]:.1%}, '
          f'{read["staged"][1][1]:.1%} (PR 12: 71.42 ms, 112 images/s)', flush=True)
    if steps < 10 + 2 * (LOADER_WARMUP + LOADER_TIMED):
        raise AssertionError(f'datasets, train: {steps} steps')
    print(json.dumps({'datasets': {'s2d_loop_bAji': loop_aji, 's2d_direct_aji': direct_aji,
                                   'unet_loop_ms': ms, 'loader_samples_per_s': n / loader_s,
                                   'pipeline_ms_per_sample_one_thread': serial_ms,
                                   'train_ms_event_share': read, 'train_work_ms': work_ms, 'train_idle': idle,
                                   'host_cores': os.cpu_count()}}), flush=True)
    print(f'datasets, part 3: {time.perf_counter() - t0:.1f} s', flush=True)


CLI_WINDOWS, CLI_VAL_TILES = 24, 2  # 3 batches of 8 per epoch; the eval hook's images
CLI_EPOCHS, CLI_RESUMED_EPOCHS = 2, 3  # the first run, then the resumed one
CLI_STAGED_TIMED = 5  # pre-staged train steps timed for the card's work per step
B1_COUNTERS = ('launches', 'vectorized_launches', 'cluster_launches', 'strip_launches', 'global_launches')
SQ_PQ_TOL = 0.01  # the PQ's float32 sum of paired IoUs, summed in another order: one rounding step of the table


@contextlib.contextmanager
def plain_label_maps():
    """The recipe's label maps on their numpy plain versions in place of the C++ calls."""
    from tiseg_tpu_torch.datasets.ops import label_maps
    from tiseg_tpu_torch.datasets.utils import instance
    swaps = [(label_maps, 'fix_instance', instance.fix_instance_plain),
             (label_maps, 'instance_boxes', label_maps.instance_boxes_plain)]
    swaps += [(cls, name, vars(cls)[f'{name}_plain'])  # the descriptors: static and class methods stay so
              for cls, name in ((label_maps.UNetLabelMake, '_remove_1px_boundary'),
                                (label_maps.UNetLabelMake, '_get_weight_map'), (label_maps.BoundLabelMake, '_bound_map'),
                                (label_maps.DirectionLabelMake, 'calculate_point_map'),
                                (label_maps.DirectionLabelMake, 'calculate_weight_map'),
                                (label_maps.HVLabelMake, '_hv_map'), (label_maps.DistanceLabelMake, '_dist_map'))]
    saved = [(obj, name, vars(obj)[name] if isinstance(obj, type) else getattr(obj, name)) for obj, name, _ in swaps]
    for obj, name, value in swaps:
        setattr(obj, name, value)
    try:
        yield
    finally:
        for obj, name, value in saved:
            setattr(obj, name, value)


def b1_counters() -> dict:
    """B1's counters, name -> (wrapper, attribute)."""
    from tiseg_tpu_torch.ops.instance_pp import instance_postprocess_sweep
    return {name: (instance_postprocess_sweep, name) for name in B1_COUNTERS}


def hover_counters() -> dict:
    """The counters of HoVer-Net's post-processing kernels (B2 with B4 fused, B4 alone, B3, B5)."""
    from tiseg_tpu_torch.ops.flood import ccl_filter_sweep, ccl_sweep, fill_holes_sweep, size_filter
    from tiseg_tpu_torch.ops.watershed import watershed
    return {'ccl_sweep': (ccl_sweep, 'launches'), 'ccl_sweep cluster': (ccl_sweep, 'cluster_launches'),
            'ccl_sweep global': (ccl_sweep, 'global_launches'),
            'ccl_filter_sweep fused': (ccl_filter_sweep, 'fused_launches'),
            'size_filter': (size_filter, 'launches'), 'fill_holes_sweep': (fill_holes_sweep, 'launches'),
            'fill_holes_sweep cluster': (fill_holes_sweep, 'cluster_launches'),
            'fill_holes_sweep global': (fill_holes_sweep, 'global_launches'),
            'watershed': (watershed, 'launches'), 'watershed cluster': (watershed, 'cluster_launches'),
            'watershed global': (watershed, 'global_launches')}


# per plane of up to 408^2: B2 twice on its cluster route with B4 fused, B3 and B5 once each on theirs
HOVER_LAUNCHES = {'ccl_sweep': 2, 'ccl_sweep cluster': 2, 'ccl_sweep global': 0, 'ccl_filter_sweep fused': 2,
                  'size_filter': 0, 'fill_holes_sweep': 1, 'fill_holes_sweep cluster': 1, 'fill_holes_sweep global': 0,
                  'watershed': 1, 'watershed cluster': 1, 'watershed global': 0}
# per 1000^2 plane through the two-class B1: one launch on its strip route
B1_STRIP_LAUNCHES = {'launches': 1, 'vectorized_launches': 0, 'cluster_launches': 0, 'strip_launches': 1,
                     'global_launches': 0}


def zero_counts(counters: dict) -> None:
    for fn, attr in counters.values():
        setattr(fn, attr, 0)


def read_counts(counters: dict) -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in counters.items()}


def train_cli_path(args):
    """The MoNuSeg UNet recipe through the port's train and test CLIs on the card (``recipe_cli_path``)."""
    recipe_cli_path(args, 'train CLI', UNET_CONFIG, 'cli', 60000, args.patch_batch)


def recipe_cli_path(args, label: str, config: str, name: str, seed0: int, patch_batch: int, save_best=None,
                    val_hw: int = LOOP_HW, counters=None, per_image=None, host_route: bool = False):
    """A MoNuSeg recipe through the port's train and test CLIs on the card: two epochs with the eval hook,
    a checkpoint and the best (by the recipe's metric, or ``save_best``); auto-resume for a third epoch; the best
    checkpoint scored by tools/test.py against a direct evaluation; the loader on the C++ label maps against
    their numpy plain versions. The eval hook runs on val tiles of ``val_hw``^2 and launches, per tile, the
    kernels of ``counters`` as often as ``per_image`` says (default: B1 once on its strip route; counters that
    ``per_image`` does not name are printed, not held). With ``host_route``, tools/test.py also scores the best
    checkpoint with the recipe's own test_cfg (no device post-processing: the host route), timed per tile
    beside the device route. Returns the train windows' data (image, semantic and instance maps)."""
    counters = counters or b1_counters()
    per_image = per_image or B1_STRIP_LAUNCHES
    import shutil
    from tiseg_tpu_torch.apis import build_train_state, single_device_test
    from tiseg_tpu_torch.datasets import build_dataloader, build_dataset
    from tiseg_tpu_torch.engine import CheckpointManager, build_lr_schedule, make_train_step
    from tiseg_tpu_torch.engine import runner as runner_mod
    from tiseg_tpu_torch.engine.checkpoint import load_net_state
    from tiseg_tpu_torch.models import build_segmentor
    from tiseg_tpu_torch.tools import test as test_cli, train as train_cli
    from tiseg_tpu_torch.utils import Config, JsonlLogger

    t0 = time.perf_counter()
    train_kw, windows = write_tiles(f'{name}_w512_s256', range(args.seed + seed0, args.seed + seed0 + CLI_WINDOWS),
                                    WINDOW_HW, WINDOW_NUCLEI)
    val_nuclei = round(LOOP_NUCLEI * (val_hw / LOOP_HW) ** 2)
    val_kw, _ = write_tiles(f'{name}_w0_s0', range(args.seed + seed0 + 1000, args.seed + seed0 + 1000 + CLI_VAL_TILES),
                            val_hw, val_nuclei)
    work = os.path.join(ROOT, 'build', 'dev', f'{name}_train')
    shutil.rmtree(work, ignore_errors=True)
    cfg = Config.fromfile(os.path.join(ROOT, config))
    test_cfg = ['model.test_cfg.device_postprocess=True', 'model.test_cfg.device_metrics=True',
                f'model.test_cfg.patch_batch={patch_batch}']
    data = [f'data.{split}.{k}={kw[k]}' for split, kw in (('train', train_kw), ('val', val_kw))
            for k in ('data_root', 'img_dir', 'ann_dir', 'split')]
    # log_config.interval=1: a train record per iteration (the recipe's 10 is more than an epoch here)
    hooks = ['evaluation.interval=1', 'checkpoint_config.interval=1', 'checkpoint_config.max_keep_ckpts=1',
             'log_config.interval=1'] + ([f'evaluation.save_best={save_best}'] if save_best else [])
    metric = save_best or cfg.evaluation['save_best']
    print(f'{label}: {config}; {CLI_WINDOWS} windows of {WINDOW_HW}^2 ({WINDOW_NUCLEI} nuclei) and {CLI_VAL_TILES} val tiles '
          f'of {val_hw}^2 ({val_nuclei} nuclei) written in {time.perf_counter() - t0:.1f} s', flush=True)

    val_ds = build_dataset(dict(val_kw, processes=cfg.data.test.processes), default_args=dict(test_mode=True))
    model = dict(cfg.model, test_cfg=dict(cfg.model.test_cfg, device_postprocess=True, device_metrics=True,
                                          patch_batch=patch_batch))

    # timers on the runner's hooks and the checkpoint manager (wrapped for this phase only)
    spans = collections.defaultdict(list)
    restored = {}

    def timed(owner, name, label, after=None):
        inner = getattr(owner, name)

        def call(self, *a, **k):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = inner(self, *a, **k)
            torch.cuda.synchronize()
            spans[label].append((time.perf_counter() - t1) * 1e3)
            if after is not None:
                after(self, out)
            return out
        return owner, name, inner, call

    def keep_restored(runner, _):
        sd = runner.state.net.state_dict()
        restored['net'] = {k: v.detach().clone() for k, v in sd.items()}
        opt = runner.state.tx.state_dict()  # its moments are the live tensors, which the next step replaces
        restored['optimizer'] = dict(opt, state={i: {k: v.clone() if torch.is_tensor(v) else v for k, v in leaves.items()}
                                                 for i, leaves in opt['state'].items()})
        restored['step'] = runner.state.step
        restored['start_epoch'] = runner.start_epoch

    wraps = [timed(runner_mod.EpochBasedRunner, 'evaluate', 'eval_hook'),
             timed(CheckpointManager, 'save', 'checkpoint_save'), timed(CheckpointManager, 'save_best', 'best_save'),
             timed(CheckpointManager, 'restore', 'checkpoint_restore'),
             timed(runner_mod.EpochBasedRunner, 'resume', 'resume', keep_restored)]
    for owner, name, _, call in wraps:
        setattr(owner, name, call)
    argv = [config, '--work-dir', work, '--seed', str(args.seed), '--options', *data, *hooks, *test_cfg]
    try:
        # first run: two epochs
        zero_counts(counters)
        t1 = time.perf_counter()
        state = train_cli.main(argv + [f'runner.max_epochs={CLI_EPOCHS}'])
        torch.cuda.synchronize()
        run1_s = time.perf_counter() - t1
        k_first = read_counts(counters)
        ckpt_dir = os.path.join(work, 'checkpoints')
        files = sorted(os.listdir(ckpt_dir))
        saved = torch.load(os.path.join(ckpt_dir, f'{state.step}.pt'), map_location='cpu', weights_only=True)
        records = JsonlLogger(os.path.join(work, 'log.jsonl')).read()
        # the resumed run: a third epoch
        zero_counts(counters)
        t1 = time.perf_counter()
        resumed = train_cli.main(argv + [f'runner.max_epochs={CLI_RESUMED_EPOCHS}', '--resume-from', 'auto'])
        torch.cuda.synchronize()
        run2_s = time.perf_counter() - t1
        k_resumed = read_counts(counters)
    finally:
        for owner, name, inner, _ in wraps:
            setattr(owner, name, inner)

    iters = len(build_dataloader(build_dataset(dict(train_kw, processes=cfg.data.train.processes)),
                                 cfg.data.samples_per_gpu, 0, drop_last=True))
    train = [r for r in records if r['mode'] == 'train']
    val = [r for r in records if r['mode'] == 'val']
    schedule = build_lr_schedule(cfg.lr_config, cfg.optimizer['lr'], iters, iters * CLI_EPOCHS)
    want_lrs = [schedule(s) for s in range(1, iters * CLI_EPOCHS + 1)]
    ok = (state.step == iters * CLI_EPOCHS and iters == CLI_WINDOWS // cfg.data.samples_per_gpu
          and len(train) == iters * CLI_EPOCHS and [r['lr'] for r in train] == want_lrs
          and all(np.isfinite(r['loss']) for r in train) and len(val) == CLI_EPOCHS
          and files == [f'{state.step}.pt', 'best.pt', 'best_meta.json'])
    expect_first = {k: n * CLI_VAL_TILES * CLI_EPOCHS for k, n in per_image.items()}
    expect_resumed = {k: n * CLI_VAL_TILES for k, n in per_image.items()}
    print(f'{label}, first run ({run1_s:.1f} s): step {state.step}; {len(train)} train records, LR {[r["lr"] for r in train]} '
          f'(build_lr_schedule {want_lrs}); losses {[round(r["loss"], 4) for r in train]}; val mAji '
          f'{[r.get("mAji") for r in val]}, mDice {[r.get("mDice") for r in val]}; checkpoints {files}; eval hook launches {k_first}',
          flush=True)
    if not ok or {k: k_first[k] for k in per_image} != expect_first:
        raise AssertionError(f'{label}, first run: step {state.step}, records {records}, files {files}, eval hook '
                             f'launches {k_first} (expected {expect_first})')
    with open(os.path.join(ckpt_dir, 'best_meta.json')) as f:
        meta = json.load(f)
    if meta['metric'] != metric or not np.isfinite(meta['value']):
        raise AssertionError(f'{label}: best_meta.json {meta}')

    # the resumed run: restored bit for bit, epoch 3 only, step 9
    same_net = (restored['net'].keys() == saved['net'].keys()
                and all(torch.equal(restored['net'][k].cpu(), saved['net'][k]) for k in saved['net']))
    opt_a, opt_b = restored['optimizer'], saved['optimizer']
    same_opt = (opt_a['count'] == opt_b['count'] and opt_a['state'].keys() == opt_b['state'].keys()
                and all(torch.equal(opt_a['state'][i][k].cpu(), opt_b['state'][i][k])
                        for i in opt_b['state'] for k in opt_b['state'][i]))
    records2 = JsonlLogger(os.path.join(work, 'log.jsonl')).read()[len(records):]
    files2 = sorted(os.listdir(ckpt_dir))
    print(f'{label}, resumed run ({run2_s:.1f} s): restored step {restored["step"]}, start epoch '
          f'{restored["start_epoch"]}; net and optimizer state equal to {state.step}.pt bit for bit: {same_net}, '
          f'{same_opt}; ends at step {resumed.step}; records {[(r["mode"], r["epoch"]) for r in records2]}; checkpoints '
          f'{files2}; eval hook launches {k_resumed}', flush=True)
    # the resumed runner keeps the best score: best.pt stays the net of the best of the three evaluations
    vals = [r[f'm{metric}'] for r in val + records2 if r['mode'] == 'val' and np.isfinite(r[f'm{metric}'])]
    with open(os.path.join(ckpt_dir, 'best_meta.json')) as f:
        meta2 = json.load(f)
    print(f'{label}, best after the resume: {meta2} (val m{metric} {vals})', flush=True)
    if not vals or meta2['metric'] != metric or meta2['value'] != max(vals):
        raise AssertionError(f'{label}: best_meta.json {meta2} after the resume, val m{metric} {vals}')
    last = iters * CLI_RESUMED_EPOCHS
    if not (same_net and same_opt and restored['step'] == iters * CLI_EPOCHS and restored['start_epoch'] == CLI_EPOCHS
            and resumed.step == last
            and [(r['mode'], r['epoch']) for r in records2] == [('train', 3)] * iters + [('val', 3)]
            and files2 == [f'{last}.pt', 'best.pt', 'best_meta.json']
            and {k: k_resumed[k] for k in per_image} == expect_resumed):
        raise AssertionError(f'{label}: the resumed run differs from the checkpoint or the schedule')

    # score best.pt through tools/test.py against single_device_test + evaluate on the same weights
    best = os.path.join(ckpt_dir, 'best.pt')
    test_data = [f'data.test.{k}={val_kw[k]}' for k in ('data_root', 'img_dir', 'ann_dir', 'split')]
    t1 = time.perf_counter()
    got = test_cli.main([config, best, '--options', *test_data, *test_cfg])
    test_s = time.perf_counter() - t1
    seg = build_segmentor(model, device='cuda')
    load_net_state(seg.net, CheckpointManager(work).load_variables(best))
    want = val_ds.evaluate(single_device_test(seg, val_ds, progress=False))[0]
    differ = {k: (got[k], want[k]) for k in want if not (got[k] == want[k] or (np.isnan(got[k]) and np.isnan(want[k])))}
    print(f'{label}, tools/test.py on best.pt ({test_s:.1f} s): {dict(got)}; keys that differ from the direct '
          f'evaluation {differ}', flush=True)
    if (got.keys() != want.keys() or got[f'm{metric}'] != meta2['value']
            or any(not (k.endswith(('SQ', 'PQ')) and abs(a - b) <= SQ_PQ_TOL) for k, (a, b) in differ.items())):
        raise AssertionError(f'{label}: tools/test.py {got} against the direct evaluation {want}')
    if host_route:
        host_route_run(label, config, best, test_data, seg, val_ds, val_hw)

    # the card's work per step: pre-staged loader batches on the trained net, back to back
    train_ds = build_dataset(dict(train_kw, processes=cfg.data.train.processes))
    loader = build_dataloader(train_ds, cfg.data.samples_per_gpu, cfg.data.workers_per_gpu, seed=args.seed)
    staged = [{g: {k: torch.from_numpy(v).cuda() for k, v in b[g].items()} for g in ('data', 'label')} for b in loader]
    st, step = build_train_state(seg, cfg, iters_per_epoch=iters, seed=args.seed), make_train_step(seg)
    events = []
    for i in range(2 + CLI_STAGED_TIMED):
        events.append((torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)))
        events[-1][0].record()
        st, _ = step(st, staged[i % len(staged)])
        events[-1][1].record()
    torch.cuda.synchronize()
    work_ms = statistics.median(a.elapsed_time(b) for a, b in events[2:])
    times = [r['time'] * 1e3 for r in train] + [r['time'] * 1e3 for r in records2 if r['mode'] == 'train']
    # per epoch: the loader starts with the epoch and prefetches while the first iteration waits, so an iteration's
    # time alone says little; the epoch's mean does. The first epoch also holds cuDNN's first calls.
    epoch_ms = [statistics.mean(times[e * iters:(e + 1) * iters]) for e in range(len(times) // iters)]
    idle = [1 - work_ms / ms for ms in epoch_ms]
    eval_ms = [ms / CLI_VAL_TILES for ms in spans['eval_hook']]
    sizes = {f: os.path.getsize(os.path.join(ckpt_dir, f)) / 2 ** 20 for f in (f'{last}.pt', 'best.pt')}
    t1 = time.perf_counter()
    torch.load(os.path.join(ckpt_dir, f'{last}.pt'), map_location='cpu', weights_only=True)
    load_ms = (time.perf_counter() - t1) * 1e3
    del st, staged, seg
    torch.cuda.empty_cache()

    # the loader on the recipe's pipeline: the C++ label maps and their numpy plain versions, in turns
    rates, one_ms = collections.defaultdict(list), collections.defaultdict(list)
    for route in ('cpp', 'numpy', 'cpp'):  # one numpy pass: CDNet's numpy route reads 1.2-2 samples/s
        with plain_label_maps() if route == 'numpy' else contextlib.nullcontext():
            t1 = time.perf_counter()
            for i in range(8):
                train_ds.sample(i, i)
            one_ms[route].append((time.perf_counter() - t1) * 1e3 / 8)
            loader.set_epoch(len(rates[route]) + 10)
            t1 = time.perf_counter()
            n = sum(len(b['metas']) for b in loader)
            rates[route].append(n / (time.perf_counter() - t1))
    card = card_line()
    print(f'{label} numbers ({card}): ms per iteration (the runner\'s time field) {[round(t, 2) for t in times]}, '
          f'per epoch {[round(ms, 2) for ms in epoch_ms]}; the card\'s work per step {work_ms:.2f} ms (pre-staged '
          f'batches, CUDA events), idle {[f"{i:.1%}" for i in idle]} of each epoch\'s loader-fed iterations; eval hook '
          f'{[round(ms, 2) for ms in eval_ms]} ms per {val_hw}^2 image; checkpoint save {[round(ms, 1) for ms in spans["checkpoint_save"]]} '
          f'ms, best save {[round(ms, 1) for ms in spans["best_save"]]} ms, restore {[round(ms, 1) for ms in spans["checkpoint_restore"]]} '
          f'ms, torch.load alone {load_ms:.1f} ms; on disk {sizes} MB', flush=True)
    print(f'{label} loader ({card}; {os.cpu_count()} host cores; batches of {loader.batch_size}, {loader.num_workers} '
          f'threads, {CLI_WINDOWS} windows, in turns C++, numpy, C++): samples/s C++ label maps '
          f'{[round(r, 2) for r in rates["cpp"]]}, numpy plain versions {[round(r, 2) for r in rates["numpy"]]}; '
          f'one sample on one thread C++ {[round(ms, 1) for ms in one_ms["cpp"]]} ms, numpy '
          f'{[round(ms, 1) for ms in one_ms["numpy"]]} ms', flush=True)
    print(json.dumps({label.replace(' ', '_').lower(): {'iter_ms': times, 'epoch_iter_ms': epoch_ms, 'work_ms': work_ms, 'idle': idle,
                                    'eval_hook_ms_per_image': eval_ms, 'checkpoint_ms': dict(spans),
                                    'torch_load_ms': load_ms, 'checkpoint_mb': sizes, 'loader_samples_per_s': rates,
                                    'pipeline_ms_per_sample_one_thread': one_ms, 'test_cli': {k: float(v) for k, v in got.items()},
                                    'eval_hook_launches': [k_first, k_resumed], 'host_cores': os.cpu_count()}}),
          flush=True)
    return windows


def host_route_run(label, config, best, test_data, seg, val_ds, val_hw):
    """tools/test.py on ``best`` with the recipe's own test_cfg (``device_postprocess`` unset: the host route
    of the segmentor's ``postprocess``), its post-processing timed per tile, beside the device route's instances
    on the same tiles (``seg``, loaded with the same checkpoint)."""
    from tiseg_tpu_torch.apis import single_device_test
    from tiseg_tpu_torch.tools import test as test_cli
    cls = type(seg)
    inner = cls.postprocess
    spans, host_inst = [], []

    def timed_postprocess(self, fused):
        t1 = time.perf_counter()
        out = inner(self, fused)
        spans.append((time.perf_counter() - t1) * 1e3)
        host_inst.append(len(np.unique(out['inst_pred'])) - 1)
        return out

    cls.postprocess = timed_postprocess
    try:
        t1 = time.perf_counter()
        got = test_cli.main([config, best, '--options', *test_data])
        host_s = time.perf_counter() - t1
    finally:
        cls.postprocess = inner
    device = single_device_test(seg, val_ds, pre_eval=False, progress=False)
    device_inst = [int((np.unique(p['inst_pred']) > 0).sum()) for p in device]
    print(f'{label}, tools/test.py with the recipe\'s own test_cfg (the host route; {card_line()}): {host_s:.1f} s '
          f'for {len(spans)} tiles of {val_hw}^2; host post-processing {[round(ms, 1) for ms in spans]} ms per tile; '
          f'instances host route {host_inst}, device route {device_inst}; {dict(got)}', flush=True)
    print(json.dumps({f'{label.replace(" ", "_").lower()}_host_route': {
        'seconds': host_s, 'postprocess_ms_per_tile': spans, 'tile_hw': val_hw, 'instances_host': host_inst,
        'instances_device': device_inst, 'metrics': {k: float(v) for k, v in got.items()}}}), flush=True)
    if len(spans) != len(val_ds) or not got:  # a seeded net a few steps in may find no nucleus on a tile
        raise AssertionError(f'{label}: the host route post-processed {len(spans)} of {len(val_ds)} tiles: {got}')


# -- phase 3f: training of the CUNet and CDNet families ------------------------------------
FAMILY_TRAIN = (  # (name, MoNuSeg recipe): the five nets of the family, one flag-heavy MultiTaskCDNet config, DIST
    ('CUNet', 'configs/cunet/cunet_adam-lr0.0005_bs16_256x256_300e_monuseg.py'),
    ('MultiTaskUNet', 'configs/multi_task_unet/multi_task_unet_adam-lr0.0001_bs8_256x256_300e_monuseg.py'),
    ('MultiTaskCUNet', 'configs/multi_task_cunet/multi_task_cunet_adam-lr0.0005_bs16_256x256_300e_monuseg.py'),
    ('CDNet', 'configs/cdnet/cdnet_adam-lr0.0005_bs16_256x256_300e_monuseg.py'),
    ('MultiTaskCDNet', 'configs/multi_task_cdnet/multi_task_cdnet_adam-lr0.0005_bs16_256x256_300e_monuseg.py'),
    ('MultiTaskCDNet (tploss, dir_weight_map, distance, ac)',
     'configs/multi_task_cdnet/monuseg/distance/jour_dist_tp_dirw_ac0.py'),
    ('DIST', 'configs/dist/dist_adam-lr0.001_bs16_256x256_300e_monuseg.py'),
)
CDNET_MONUSEG_CONFIG = FAMILY_TRAIN[3][1]
FAMILY_WINDOWS = 16  # the largest samples_per_gpu of the recipes: one batch of each from one loader epoch
FAMILY_CHECK_HW = 128  # the gradient check on the top-left 128^2 of 2 images: the CPU's float64 path bounds its time
# the float32 gradient's floor for these nets: UNet's 1e-4 failed on a MultiTaskCDNet head leaf at 1.8e-4 on one H100,
# where the CPU's float32 path happened to read 3.1e-5; the medians of either device's float32 errors are 1e-3
# to 7e-3, so a leaf within 2e-3 of the float64 gradient is inside float32's own noise
FAMILY_F32_GRAD_FLOOR = 2e-3


def family_train_path(args):
    """Each net of the CUNet and CDNet families, and DIST, from its MoNuSeg recipe at full width: one batch of the recipe's
    own train pipeline (the C++ label maps) at its samples_per_gpu x 256^2; the loss, every log value and every
    gradient on 2 of its images (their top-left 128^2) against the port's CPU path in float64 and float32; 3
    warm-up and 10 timed steps of make_train_step."""
    from tiseg_tpu_torch.apis import build_train_state
    from tiseg_tpu_torch.datasets import build_dataloader, build_dataset
    from tiseg_tpu_torch.engine import make_train_step, trainable_parameters
    from tiseg_tpu_torch.models import build_segmentor
    from tiseg_tpu_torch.utils import Config

    t0 = time.perf_counter()
    kw, _ = write_tiles('family_w512_s256', range(args.seed + 70000, args.seed + 70000 + FAMILY_WINDOWS), WINDOW_HW,
                        WINDOW_NUCLEI)
    card = card_line()
    print(f'family train: {FAMILY_WINDOWS} windows of {WINDOW_HW}^2 ({WINDOW_NUCLEI} nuclei) written in '
          f'{time.perf_counter() - t0:.1f} s; float32, TF32 off; {card}', flush=True)
    out = {}
    for name, config in FAMILY_TRAIN:
        t0 = time.perf_counter()
        cfg = Config.fromfile(os.path.join(ROOT, config))
        n = cfg.data.samples_per_gpu
        loader = build_dataloader(build_dataset(dict(kw, processes=cfg.data.train.processes)), n,
                                  cfg.data.workers_per_gpu, seed=args.seed)
        t1 = time.perf_counter()
        host = list(loader)[0]  # the whole epoch: the loader's threads end with it
        pipeline_s = time.perf_counter() - t1
        host.pop('metas')
        want = set(next(p for p in cfg.data.train.processes if p['type'] == 'Formatting')['label_keys'])
        if set(host['label']) != want or host['data']['img'].shape != (n, TRAIN_HW, TRAIN_HW, 3):
            raise AssertionError(f'{name} train: batch {[(k, v.shape) for k, v in host["label"].items()]}')
        batch = {g: {k: torch.from_numpy(v).cuda() for k, v in host[g].items()} for g in ('data', 'label')}
        check_train_gradients(cfg, args.seed, {g: {k: v[:TRAIN_CHECK_BATCH, :FAMILY_CHECK_HW, :FAMILY_CHECK_HW]
                                                   for k, v in items.items()} for g, items in batch.items()}, name,
                               FAMILY_F32_GRAD_FLOOR)
        check_s = time.perf_counter() - t1 - pipeline_s

        seg = build_segmentor(cfg.model, device='cuda', seed=args.seed)
        state = build_train_state(seg, cfg, iters_per_epoch=WINDOWS // n, seed=args.seed)
        step = make_train_step(seg)
        for _ in range(TRAIN_WARMUP):
            state, logs = step(state, batch)
        first = {k: float(v) for k, v in logs.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(TRAIN_TIMED):
            t1 = time.perf_counter()
            state, logs = step(state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
        last = {k: float(v) for k, v in logs.items()}
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        step_ms = statistics.median(times)
        if seg.net.training or not all(np.isfinite(v) for v in (*first.values(), *last.values())):
            raise AssertionError(f'{name} train: logs {first} {last}, net in train mode {seg.net.training}')
        out[name] = {'config': config, 'batch': n, 'ms_per_step': step_ms, 'ms_min': min(times),
                     'ms_max': max(times), 'images_per_s': n / step_ms * 1e3, 'peak_gib': peak_gib,
                     'pipeline_s': pipeline_s, 'loss_first': first['loss'], 'loss_last': last['loss']}
        print(f'{name} train step ({card}): {config}, batch {n} x {TRAIN_HW}^2, '
              f'{len(trainable_parameters(seg.net))} trained leaves; {step_ms:.2f} ms per step (median of '
              f'{TRAIN_TIMED} after {TRAIN_WARMUP} warm-ups, each ended by a synchronize; min {min(times):.2f}, max '
              f'{max(times):.2f}), {n / step_ms * 1e3:.1f} images/s, peak memory {peak_gib:.3f} GiB; the batch '
              f'through the loader {pipeline_s:.2f} s, the gradient check {check_s:.1f} s, the phase '
              f'{time.perf_counter() - t0:.1f} s; logs at step {state.step - 1}: {json.dumps(last)}', flush=True)
        del seg, state, step, batch
        torch.cuda.empty_cache()
    print(json.dumps({'family_train': out}), flush=True)
    return out


def check_label_maps_on(windows):
    """The C++ label maps of BoundLabelMake and DirectionLabelMake against their numpy plain versions on the
    instance maps of ``windows``: bound_map bit for bit; dlm_point_maps' centres, point map and distances bit for
    bit, its gradient within rtol 1e-4, atol 2e-5 (tests/test_native_labelmaps.py:95); ddm_weight within 1e-6
    (:122) on the same direction and distance maps; dir_gt equal but where the numpy gradient's angle lies within
    1e-3 degrees of a sector boundary or its magnitude is under 2e-5."""
    from tiseg_tpu_torch import native
    from tiseg_tpu_torch.datasets.ops import label_maps as lm

    def one(inst):
        inst = native.fix_instance(inst)
        bound_ok = np.array_equal(native.bound_map(inst, 3, 3), lm.BoundLabelMake()._bound_map_plain(inst))
        p_c, g_c, d_c = lm.DirectionLabelMake.calculate_point_map(inst)
        p_n, g_n, d_n = lm.DirectionLabelMake.calculate_point_map_plain(inst)
        grad_err = float(np.max(np.abs(g_c - g_n) - 1e-4 * np.abs(g_n)))
        dir_c = lm.DirectionLabelMake.calculate_dir_map(inst, g_c, 8)
        dir_n = lm.DirectionLabelMake.calculate_dir_map(inst, g_n, 8)
        angle = np.degrees(np.arctan2(g_n[..., 0], g_n[..., 1]))
        offset = np.mod(angle + 180.0 - 22.5, 45.0)
        allowed = (np.minimum(offset, 45.0 - offset) <= 1e-3) | (np.hypot(g_n[..., 0], g_n[..., 1]) < 2e-5)
        w_c = lm.DirectionLabelMake.calculate_weight_map(dir_n, d_n, 8)
        w_n = lm.DirectionLabelMake.calculate_weight_map_plain(dir_n, d_n, 8)
        return {'instances': int(inst.max()), 'bound': bound_ok, 'point': np.array_equal(p_c, p_n),
                'dist': np.array_equal(d_c, d_n), 'grad_excess': grad_err, 'dir_differ': int((dir_c != dir_n).sum()),
                'dir_differ_unexplained': int(((dir_c != dir_n) & ~allowed).sum()),
                'weight_err': float(np.max(np.abs(w_c - w_n) - 1e-6 * np.abs(w_n)))}

    t0 = time.perf_counter()
    boxes = lm.instance_boxes
    lm.instance_boxes = lm.instance_boxes_plain  # the numpy route's boxes too
    # one thread: the numpy route holds the interpreter lock; 8 threads took 52 s for 24 windows, and the loader's
    # numpy route gave 1.9 samples/s from 8 threads against ~7 from one (measured on one H100)
    try:
        res = [one(w[2]) for w in windows]
    finally:
        lm.instance_boxes = boxes
    bad = [r for r in res if not (r['bound'] and r['point'] and r['dist'] and r['grad_excess'] <= 2e-5
                                  and r['dir_differ_unexplained'] == 0 and r['weight_err'] <= 1e-6)]
    print(f'label maps on the {len(windows)} windows ({sum(r["instances"] for r in res)} instances, '
          f'{time.perf_counter() - t0:.1f} s): bound_map, centres, point and distance maps equal to the numpy plain '
          f'versions: {all(r["bound"] and r["point"] and r["dist"] for r in res)}; gradient within rtol 1e-4 + atol '
          f'2e-5 (largest excess over rtol {max(r["grad_excess"] for r in res):.3e}); dir_gt pixels that differ '
          f'{sum(r["dir_differ"] for r in res)}, of them off a sector boundary and not flat '
          f'{sum(r["dir_differ_unexplained"] for r in res)}; ddm_weight largest excess over rtol 1e-6 '
          f'{max(r["weight_err"] for r in res):.3e}', flush=True)
    if bad:
        raise AssertionError(f'label maps: the C++ differs from the numpy plain versions on {len(bad)} windows: {bad}')


def cdnet_cli_path(args):
    """The CDNet MoNuSeg recipe (batch 16) through tools/train.py and tools/test.py, cut as train_cli_path cuts
    the UNet one (``recipe_cli_path``), the best kept by Dice; then the C++ label maps against their numpy plain
    versions on the windows it wrote."""
    # the best by Dice: with one step per epoch the seeded net finds no nucleus in the first two evaluations
    # (mAji nan, which is never a best; mDice 0) and takes every pixel for one in the third (my first chip run)
    windows = recipe_cli_path(args, 'CDNet CLI', CDNET_MONUSEG_CONFIG, 'cdnet_cli', 62000, args.cd_patch_batch,
                              save_best='Dice')
    check_label_maps_on(windows)


# -- phase 3g: HoVer-Net's training, and DCAN, FullNet, MicroNet and CMicroNet ------------------------
ZOO_TRAIN = (  # (name, MoNuSeg recipe, images and crop of the card-against-CPU check)
    ('HoverNet', 'configs/hovernet/hovernet_adam-lr0.0001_bs8_256x256_300e_monuseg.py', 1, 128),
    ('DCAN', 'configs/dcan/dcan_adam-lr0.0001_bs4_256x256_300e_monuseg.py', 2, 128),
    ('FullNet', 'configs/fullnet/fullnet_adam-lr0.001_bs8_256x256_300e_monuseg.py', 1, 128),
    ('MicroNet', 'configs/micronet/micronet_adam-lr0.0001_bs4_252x252_300e_monuseg.py', 1, 252),
    ('CMicroNet', 'configs/cmicronet/cmicronet_adam-lr0.0001_bs4_252x252_300e_monuseg.py', 1, 252),
)
ZOO_CONFIG = {name: config for name, config, *_ in ZOO_TRAIN}


@contextlib.contextmanager
def dropout_off():
    """Every dropout of the port's nets the identity (``models/nn.py:dropout_mask`` all ones), for the checks
    against the CPU: the two devices' generators draw different masks."""
    from tiseg_tpu_torch.models import nn as port_nn
    saved = port_nn.dropout_mask
    port_nn.dropout_mask = lambda shape, p, generator, device, dtype: torch.ones(shape, device=device, dtype=dtype)
    try:
        yield
    finally:
        port_nn.dropout_mask = saved


def zoo_train_path(args):
    """HoVer-Net, DCAN, FullNet, MicroNet and CMicroNet, each from its MoNuSeg recipe at full width: one batch of
    the recipe's own train pipeline (HVLabelMake, BoundLabelMake or UNetLabelMake in C++) at its samples_per_gpu;
    with dropout off, the loss, every log value and every gradient on the card against the port's CPU path in
    float64 and float32 (HoVer-Net and FullNet on the top-left 128^2 of one image, DCAN of two, MicroNet and
    CMicroNet on one whole 252^2 image); then, with dropout on (drawn from the step's generator), 3 warm-up and 10
    timed steps of make_train_step."""
    from tiseg_tpu_torch.apis import build_train_state
    from tiseg_tpu_torch.datasets import build_dataloader, build_dataset
    from tiseg_tpu_torch.engine import make_train_step, trainable_parameters
    from tiseg_tpu_torch.models import build_segmentor
    from tiseg_tpu_torch.utils import Config

    t0 = time.perf_counter()
    kw, _ = write_tiles('zoo_w512_s256', range(args.seed + 72000, args.seed + 72000 + FAMILY_WINDOWS), WINDOW_HW,
                        WINDOW_NUCLEI)
    card = card_line()
    print(f'zoo train: {FAMILY_WINDOWS} windows of {WINDOW_HW}^2 ({WINDOW_NUCLEI} nuclei) written in '
          f'{time.perf_counter() - t0:.1f} s; float32, TF32 off; {card}', flush=True)
    out = {}
    for name, config, check_n, check_hw in ZOO_TRAIN:
        t0 = time.perf_counter()
        cfg = Config.fromfile(os.path.join(ROOT, config))
        n = cfg.data.samples_per_gpu
        crop = next(p for p in cfg.data.train.processes if p['type'] == 'RandomCrop')['crop_size'][0]
        loader = build_dataloader(build_dataset(dict(kw, processes=cfg.data.train.processes)), n,
                                  cfg.data.workers_per_gpu, seed=args.seed)
        t1 = time.perf_counter()
        host = list(loader)[0]  # the whole epoch: the loader's threads end with it
        pipeline_s = time.perf_counter() - t1
        host.pop('metas')
        want = set(next(p for p in cfg.data.train.processes if p['type'] == 'Formatting')['label_keys'])
        if set(host['label']) != want or host['data']['img'].shape != (n, crop, crop, 3):
            raise AssertionError(f'{name} train: batch {[(k, v.shape) for k, v in host["label"].items()]}')
        batch = {g: {k: torch.from_numpy(v).cuda() for k, v in host[g].items()} for g in ('data', 'label')}
        with dropout_off():
            check_train_gradients(cfg, args.seed, {g: {k: v[:check_n, :check_hw, :check_hw] for k, v in items.items()}
                                                   for g, items in batch.items()}, name, FAMILY_F32_GRAD_FLOOR)
        check_s = time.perf_counter() - t1 - pipeline_s

        seg = build_segmentor(cfg.model, device='cuda', seed=args.seed)
        state = build_train_state(seg, cfg, iters_per_epoch=WINDOWS // n, seed=args.seed)
        step = make_train_step(seg)
        for _ in range(TRAIN_WARMUP):
            state, logs = step(state, batch)
        first = {k: float(v) for k, v in logs.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(TRAIN_TIMED):
            t1 = time.perf_counter()
            state, logs = step(state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
        last = {k: float(v) for k, v in logs.items()}
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        step_ms = statistics.median(times)
        if seg.net.training or not all(np.isfinite(v) for v in (*first.values(), *last.values())):
            raise AssertionError(f'{name} train: logs {first} {last}, net in train mode {seg.net.training}')
        n_params = sum(p.numel() for p in trainable_parameters(seg.net))
        out[name] = {'config': config, 'batch': n, 'crop': crop, 'ms_per_step': step_ms, 'ms_min': min(times),
                     'ms_max': max(times), 'images_per_s': n / step_ms * 1e3, 'peak_gib': peak_gib,
                     'pipeline_s': pipeline_s, 'loss_first': first['loss'], 'loss_last': last['loss'],
                     'trained_parameters': n_params}
        print(f'{name} train step ({card}): {config}, batch {n} x {crop}^2, {len(trainable_parameters(seg.net))} '
              f'trained leaves ({n_params} parameters), dropout on; {step_ms:.2f} ms per step (median of '
              f'{TRAIN_TIMED} after {TRAIN_WARMUP} warm-ups, each ended by a synchronize; min {min(times):.2f}, max '
              f'{max(times):.2f}), {n / step_ms * 1e3:.1f} images/s, peak memory {peak_gib:.3f} GiB; the batch '
              f'through the loader {pipeline_s:.2f} s, the gradient check {check_s:.1f} s, the phase '
              f'{time.perf_counter() - t0:.1f} s; logs at step {state.step - 1}: {json.dumps(last)}', flush=True)
        del seg, state, step, batch
        torch.cuda.empty_cache()
    print(json.dumps({'zoo_train': out}), flush=True)
    return out


def nucleus_share_(seg, imgs, conv) -> None:
    """~40% of the pixels a nucleus (the background bias of the classifier ``conv``, bisected)."""
    background_bias_(seg, imgs, 'sem', conv, lambda m: m.argmax(-1) == 1, share=0.4)


def dcan_shares_(seg, imgs) -> None:
    """~10% of the pixels a contour, then ~40% a nucleus."""
    background_bias_(seg, imgs, 'cont', seg.net.up_conv_6_cont.conv, lambda m: m.argmax(-1) > 0, share=0.1)
    nucleus_share_(seg, imgs, seg.net.up_conv_6_cell.conv)


def micronet_shares_(seg, imgs) -> None:
    nucleus_share_(seg, imgs, seg.net.final_sem_conv)


@torch.no_grad()
def cmicronet_shares_(seg, imgs) -> None:
    """~10% of the pixels the boundary class (its bias, bisected), then ~40% a nucleus."""
    conv = seg.net.final_sem_conv
    start = float(conv.bias[2])
    bisect_share_(seg, imgs, 'sem', lambda m: m.argmax(-1) == 2, 0.1, lambda t: conv.bias.__setitem__(2, start - t))
    nucleus_share_(seg, imgs, conv)


@torch.no_grad()
def fullnet_shares_(seg, imgs) -> None:
    """Half the pixels background, then ~40% a nucleus."""
    fullnet_class_share_(seg, imgs, 0, share=0.5)
    fullnet_class_share_(seg, imgs, 1, share=0.4)


# (name, the classifier shifts that set the class shares of a seeded net; the views of a seeded net disagree about the
# classes, and its padded convolutions give the fused plane a frame of one class: a frame of nuclei encloses the
# plane, and B1's hole filling then takes all of it, as it does for MicroNet and FullNet here)
ZOO_EVAL = (('DCAN', dcan_shares_), ('FullNet', fullnet_shares_), ('MicroNet', micronet_shares_),
            ('CMicroNet', cmicronet_shares_))
ZOO_EVAL_IMAGES, ZOO_EVAL_HW, ZOO_EVAL_TIMED = 16, 256, 2  # images, their size, timed e2e batches
# patches per network forward: DCAN resizes 2048 channels of taps to each 256^2 patch (2 GB per 64 patches and tap)
ZOO_PATCH_BATCH = {'DCAN': 16, 'FullNet': 32, 'MicroNet': 32, 'CMicroNet': 32}


def zoo_eval_path(args):
    """DCAN, FullNet, MicroNet and CMicroNet from their MoNuSeg recipes (split 256/40 windows, MicroNet's 252/40,
    x 8 views, device_postprocess=True) through InferenceRunner on 16 x 256^2 images: B1 once per batch on the
    route pp_route gives, its output equal to the plain version on the same semantic plane; on one image the card's
    fused maps against the port's CPU path (MicroNet and CMicroNet on the identity view alone) within MAP_TOL and
    their argmax equal off the near-ties; ms per image."""
    from tiseg_tpu_torch.apis import InferenceRunner
    from tiseg_tpu_torch.datasets.synthetic import make_nuclei, nuclei_density
    from tiseg_tpu_torch.models import build_segmentor
    from tiseg_tpu_torch.ops.instance_pp import instance_postprocess_plain, instance_postprocess_sweep, pp_route
    from tiseg_tpu_torch.utils import Config

    n_img, hw = ZOO_EVAL_IMAGES, ZOO_EVAL_HW
    imgs = np.stack([make_nuclei(args.seed + 73000 + i, hw, nuclei_density(hw))[0] for i in range(n_img)])
    img_t = torch.from_numpy(imgs).cuda()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out_stats = {}
    for name, set_shares in ZOO_EVAL:
        t0 = time.perf_counter()
        cfg = Config.fromfile(os.path.join(ROOT, ZOO_CONFIG[name]))
        cfg.model.test_cfg = dict(cfg.model.test_cfg, device_postprocess=True, patch_batch=ZOO_PATCH_BATCH[name])
        seg = build_segmentor(cfg.model, device='cuda', seed=args.seed)
        set_shares(seg, img_t)
        runner = InferenceRunner(seg)
        counters = {'instance_postprocess_sweep': (instance_postprocess_sweep, 'launches'),
                    'cluster route': (instance_postprocess_sweep, 'cluster_launches'),
                    'strip route': (instance_postprocess_sweep, 'strip_launches'),
                    'global route': (instance_postprocess_sweep, 'global_launches')}
        route = pp_route(n_img, hw, hw, sms).route
        expect = {'cluster route': int(route == 'cluster'), 'strip route': int(route == 'strip'), 'global route': 0}
        out, (sem_pred,), launches, peak_gib = drive_once(runner, seg, '_device_instance_pp', imgs, hw, counters,
                                                          expect=expect)
        radius = seg.test_cfg.get('radius', seg.device_pp_default_radius)
        want = instance_postprocess_plain(sem_pred.cpu(), radius, 5, seg.num_classes)
        sem_out, inst_out = out['sem_pred'], out['inst_pred']
        if not (sem_out.shape == inst_out.shape == (n_img, hw, hw) and sem_out.dtype == torch.uint8
                and inst_out.dtype == torch.int32 and inst_out.is_cuda
                and instance_postprocess_sweep.last_route[0] == route
                and torch.equal(sem_out.cpu(), want[0]) and torch.equal(inst_out.cpu(), want[1])):
            raise AssertionError(f'{name} eval: outputs differ from the plain B1 on the same plane, or route '
                                 f'{instance_postprocess_sweep.last_route} against pp_route {route!r}')
        n_inst = sum(int((torch.unique(inst_out[b]) > 0).sum()) for b in range(n_img))
        fg, fg_in = float((sem_out > 0).float().mean()), float((sem_pred == 1).float().mean())

        # one image on the card against the port's CPU path (MicroNet: the identity view alone, for the CPU's time)
        check_cfg = dict(seg.test_cfg)
        if name.endswith('MicroNet'):
            check_cfg.update(rotate_degrees=[0], flip_directions=['none'])
        cpu = build_segmentor(dict(cfg.model, test_cfg=check_cfg), device='cpu')
        cpu.net.load_state_dict({k: v.cpu() for k, v in seg.net.state_dict().items()})
        saved_cfg, seg.test_cfg = seg.test_cfg, check_cfg
        try:
            card_fused = {k: v.cpu() for k, v in seg.inference(img_t[:1]).items()}
        finally:
            seg.test_cfg = saved_cfg
        t1 = time.perf_counter()
        cpu_fused = cpu.inference(torch.from_numpy(imgs[:1]))
        cpu_s = time.perf_counter() - t1
        diff = max(float((card_fused[k] - cpu_fused[k]).abs().max()) for k in cpu_fused)
        top2 = cpu_fused['sem'].topk(2, -1).values
        near = (top2[..., 0] - top2[..., 1]) <= 2 * MAP_TOL
        moved = int(((card_fused['sem'].argmax(-1) != cpu_fused['sem'].argmax(-1)) & ~near).sum())
        if not (diff <= MAP_TOL and moved == 0 and n_inst > 0 and 0.05 <= fg_in <= 0.95):
            raise AssertionError(f'{name} eval: card against CPU {diff:.3e} (bound {MAP_TOL}), {moved} argmax pixels '
                                 f'off the near-ties differ; B1 given {fg_in:.3f} nuclei, {n_inst} instances out')
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fused = seg.inference(img_t)
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t1) * 1e3 / n_img
        # the share of pixels that the device route strips (DCAN's contours, the boundary class) or, for
        # CMicroNet, keeps as a class of its own (MicroNet's flags: no strip)
        edge = float((fused['cont'].argmax(-1) > 0).float().mean() if name == 'DCAN' else
                     (fused['sem'].argmax(-1) == seg.num_classes).float().mean())
        print(f'{name} eval: {ZOO_CONFIG[name]}, test_cfg {seg.test_cfg}; B1 launches {launches} (route {route!r}, '
              f'{instance_postprocess_sweep.last_route}), equal to the plain version on the same plane; nuclei '
              f'{fg_in:.4f} of its input, foreground {fg:.4f} of its output, contour or boundary class on '
              f'{edge:.4f} of the fused argmax, {n_inst} instances in {n_img} images; one image on the card against '
              f'the CPU path ({cpu_s:.1f} s there): fused maps within {diff:.3e} (bound {MAP_TOL}), argmax equal off '
              f'{int(near.sum())} near-tie pixels; peak memory {peak_gib:.3f} GiB; phase '
              f'{time.perf_counter() - t0:.1f} s', flush=True)
        e2e_ms = wall_ms(lambda: runner.dispatch(imgs, (hw, hw)), reps=ZOO_EVAL_TIMED) / n_img
        pp_ms = wall_ms(lambda: seg._device_instance_pp(seg._device_sem_pred(fused)), reps=5) / n_img
        print(f'{name} eval ({card_line()}): e2e {e2e_ms:.2f} ms per {hw}^2 image (median of {ZOO_EVAL_TIMED} '
              f'batches of {n_img}, patch_batch {ZOO_PATCH_BATCH[name]}); forward + TTA fuse {fwd_ms:.2f} ms (one '
              f'batch; {fwd_ms / e2e_ms:.1%}), argmax + B1 {pp_ms:.3f} ms ({pp_ms / e2e_ms:.2%})', flush=True)
        out_stats[name] = {'e2e_ms_per_image': e2e_ms, 'forward_ms_per_image': fwd_ms, 'pp_ms_per_image': pp_ms,
                           'launches': launches, 'route': route, 'instances': n_inst, 'foreground': fg,
                           'nuclei_in': fg_in, 'edge': edge, 'peak_gib': peak_gib, 'cpu_diff': diff}
        del seg, cpu, runner, fused
        torch.cuda.empty_cache()
    print(json.dumps({'zoo_eval': out_stats}), flush=True)


HOVER_MONUSEG_CONFIG = ZOO_CONFIG['HoverNet']
DCAN_MONUSEG_CONFIG = ZOO_CONFIG['DCAN']
HOVER_VAL_HW = 256  # val tiles within the cluster routes (408^2): B2 with B4 fused, B3 and B5 on one launch each


def check_hv_maps_on(windows):
    """HVLabelMake's C++ maps against its numpy plain version on the instance maps of ``windows``, bit for bit."""
    from tiseg_tpu_torch.datasets.ops import label_maps as lm
    t0 = time.perf_counter()
    n_inst, bad = 0, []
    for i, (_, _, inst) in enumerate(windows):
        boxes = lm.padded_boxes(inst)
        n_inst += len(boxes)
        if not np.array_equal(lm.HVLabelMake._hv_map(inst, boxes), lm.HVLabelMake._hv_map_plain(inst, boxes)):
            bad.append(i)
    print(f'hv_map on the {len(windows)} windows ({n_inst} instances, {time.perf_counter() - t0:.1f} s): the C++ '
          f'maps equal to the numpy plain version: {not bad}', flush=True)
    if bad:
        raise AssertionError(f'hv_map: the C++ differs from the numpy plain version on windows {bad}')


def hovernet_cli_path(args):
    """The HoVer-Net MoNuSeg recipe (batch 8) through tools/train.py and tools/test.py (``recipe_cli_path``), the
    best kept by Dice, the eval hook on 256^2 val tiles (B2 with B4 fused, B3, B5), tools/test.py also with the
    recipe's own test_cfg (the host route); then HVLabelMake's C++ maps against their numpy plain version on the
    windows it wrote."""
    windows = recipe_cli_path(args, 'HoVer-Net CLI', HOVER_MONUSEG_CONFIG, 'hover_cli', 64000, args.hover_patch_batch,
                              save_best='Dice', val_hw=HOVER_VAL_HW, counters=hover_counters(),
                              per_image=HOVER_LAUNCHES, host_route=True)
    check_hv_maps_on(windows)


def dcan_cli_path(args):
    """The DCAN MoNuSeg recipe (batch 4) through tools/train.py and tools/test.py (``recipe_cli_path``), the best
    kept by Dice; B1 once per 1000^2 val tile on its strip route."""
    recipe_cli_path(args, 'DCAN CLI', DCAN_MONUSEG_CONFIG, 'dcan_cli', 66000, ZOO_PATCH_BATCH['DCAN'], save_best='Dice')


# -- phase 3h: DIST through the CLIs, its eval and its dynamic watershed (B9, B2, B5) -------------
DIST_MONUSEG_CONFIG = FAMILY_TRAIN[-1][1]
DIST_CONIC_CONFIG = 'configs/dist/dist_adam-lr0.001_bs16_256x256_100e_conic.py'
DIST_PATCH_BATCH = 64  # patches per network forward: 8 views of 16 images of 256^2 in two
DIST_STD = 5.0  # the fused distance map standardized to N(0, 5): ~42% of the pixels >= 1, its top near 20


def dist_counters() -> dict:
    """The counters of DIST's dynamic watershed: B9 (one launch per reconstruction iteration), B2, B5."""
    from tiseg_tpu_torch.ops.flood import ccl_sweep
    from tiseg_tpu_torch.ops.stencil import neighborhood_3x3
    from tiseg_tpu_torch.ops.watershed import watershed
    return {'neighborhood_3x3': (neighborhood_3x3, 'launches'), 'ccl_sweep cluster': (ccl_sweep, 'cluster_launches'),
            'ccl_sweep global': (ccl_sweep, 'global_launches'), 'watershed cluster': (watershed, 'cluster_launches'),
            'watershed global': (watershed, 'global_launches')}


# per 1000^2 val tile of the eval hook (a batch of one plane): B2 and B5 on their global chains (B2's cluster
# route takes two planes or more, B5's planes up to 408^2), B9 once per reconstruction iteration (printed)
DIST_TILE_LAUNCHES = {'ccl_sweep cluster': 0, 'ccl_sweep global': 1, 'watershed cluster': 0, 'watershed global': 1}


def check_dist_maps_on(windows):
    """DistanceLabelMake's C++ map against its numpy plain version on the instance maps of ``windows``, with
    ``inst_norm`` False (the recipes') and True, bit for bit."""
    from tiseg_tpu_torch.datasets.ops import DistanceLabelMake
    from tiseg_tpu_torch.datasets.ops import label_maps as lm
    from tiseg_tpu_torch.datasets.utils.instance import fix_instance
    t0 = time.perf_counter()
    n_inst, bad = 0, []
    for i, (_, _, inst) in enumerate(windows):
        inst = fix_instance(inst)
        boxes = lm.padded_boxes(inst)
        n_inst += len(boxes)
        for norm in (False, True):
            maker = DistanceLabelMake(inst_norm=norm)
            if not np.array_equal(maker._dist_map(inst, boxes), maker._dist_map_plain(inst, boxes)):
                bad.append((i, norm))
    print(f'dist_cdt_map on the {len(windows)} windows ({n_inst} instances, {time.perf_counter() - t0:.1f} s): the '
          f'C++ maps equal to the numpy plain version, inst_norm False and True: {not bad}', flush=True)
    if bad:
        raise AssertionError(f'dist_cdt_map: the C++ differs from the numpy plain version on (window, inst_norm) {bad}')


def dist_cli_path(args):
    """The DIST MoNuSeg recipe (batch 16) through tools/train.py and tools/test.py (``recipe_cli_path``), the best
    kept by Dice: the eval hook on 1000^2 val tiles with device_postprocess=True (B9, B2 and B5 per tile), and
    tools/test.py also with the recipe's own test_cfg (the host route, timed per tile); then DistanceLabelMake's
    C++ map against its numpy plain version on the windows it wrote."""
    windows = recipe_cli_path(args, 'DIST CLI', DIST_MONUSEG_CONFIG, 'dist_cli', 68000, DIST_PATCH_BATCH,
                              save_best='Dice', counters=dist_counters(), per_image=DIST_TILE_LAUNCHES,
                              host_route=True)
    check_dist_maps_on(windows)
    dist_routes_on_tiles(args)


def dist_routes_on_tiles(args):
    """DIST's two post-processing routes on the distance targets (DistanceLabelMake(inst_norm=False)) of the
    CLI's 1000^2 val tiles: a seeded net a few steps in regresses no distance worth flooding, so these maps give
    the routes real work. The host route (models/utils/postprocess.py:dynamic_watershed) and the device route
    (B9, B2 and B5 on one plane: B2's and B5's global chains) timed per tile; each tile's device route equal to
    the port's CPU path."""
    from tiseg_tpu_torch.datasets.ops import DistanceLabelMake
    from tiseg_tpu_torch.datasets.synthetic import make_nuclei
    from tiseg_tpu_torch.models.utils.postprocess import dynamic_watershed
    from tiseg_tpu_torch.ops import dist_ws
    host_ms, device_ms_, counts, equal, iters = [], [], [], [], []
    seeds = range(args.seed + 68000 + 1000, args.seed + 68000 + 1000 + CLI_VAL_TILES)  # the CLI's val tiles
    for seed in seeds:
        inst = make_nuclei(seed, LOOP_HW, LOOP_NUCLEI)[2]
        data = {'inst_gt': inst, 'sem_gt': (inst > 0).astype(np.int32), 'seg_fields': []}
        p_img = DistanceLabelMake(inst_norm=False)(data)['dist_gt'].astype(np.int32)
        t1 = time.perf_counter()
        host = dynamic_watershed(p_img, 0.0, 0.5)
        host_ms.append((time.perf_counter() - t1) * 1e3)
        p_dev = torch.from_numpy(p_img).cuda()
        dev = dist_ws.dynamic_watershed_device(p_dev)
        device_ms_.append(wall_ms(lambda: dist_ws.dynamic_watershed_device(p_dev), reps=3))
        iters.append(dist_ws.reconstruction_by_erosion.last_iterations)
        equal.append(torch.equal(dev.cpu(), dist_ws.dynamic_watershed_device(p_dev.cpu())))
        counts.append((len(np.unique(host)) - 1, len(torch.unique(dev)) - 1))
    print(f'DIST routes on the distance targets of the {LOOP_HW}^2 val tiles ({card_line()}): host route '
          f'{[round(ms, 1) for ms in host_ms]} ms per tile, device route {[round(ms, 3) for ms in device_ms_]} ms per '
          f'tile ({iters} reconstruction iterations; median of 3, host clock, each ending in a synchronize); '
          f'instances (host, device) {counts}; the device route equal to the CPU path: {equal}', flush=True)
    print(json.dumps({'dist_routes_on_tiles': {'host_ms': host_ms, 'device_ms': device_ms_, 'instances': counts,
                                               'iterations': iters}}), flush=True)
    if not all(equal) or not all(h > 0 and d > 0 for h, d in counts):
        raise AssertionError(f'DIST routes on the val tiles: instances {counts}, device equal to the CPU {equal}')


@torch.no_grad()
def standardize_fused_(seg, imgs, head: str, conv: torch.nn.Conv2d, mean: float, std: float) -> None:
    """Rescale and shift the 1x1 conv of a one-channel raw head so that its TTA-fused map (``seg.inference`` on
    ``imgs``, linear in the conv) has ``mean`` and ``std``."""
    fused = seg.inference(imgs)[head]
    gain = std / float(fused.std())
    conv.weight.mul_(gain)
    conv.bias.copy_((conv.bias - float(fused.mean())) * gain + mean)


def dist_steps(p_img: torch.Tensor):
    """The inputs DIST's dynamic watershed gives its kernels (``ops/dist_ws.py`` with lamb 0): the foreground,
    the inverted map (``hrecons``), the reconstruction's seed (B9's first plane), the regional minima (B2's mask)
    and the markers."""
    from tiseg_tpu_torch.ops import dist_ws
    from tiseg_tpu_torch.ops.ccl import connected_components
    b_img = p_img > 0.5
    hrecons = 255.0 - torch.clamp(p_img.to(torch.float32), 0, 255)
    seed = torch.clamp(hrecons + 1.0, max=255.0)
    maxima = ((dist_ws.reconstruction_by_erosion(seed, hrecons) - hrecons) > 0) & b_img
    return b_img, hrecons, seed, maxima, connected_components(maxima, connectivity=2)


def dist_route_check(label: str, p_img: torch.Tensor):
    """DIST's dynamic watershed on a (B, H, W) int32 card batch: its launches (B9 once per reconstruction
    iteration, B2 and B5 once each on their cluster routes), its instances equal to the port's CPU path (every
    step on its plain version) bit for bit, and each kernel against its plain version on the inputs the route
    gives it. Returns (instances, iterations, launches)."""
    from tiseg_tpu_torch.ops import dist_ws
    from tiseg_tpu_torch.ops.flood import ccl_plain, ccl_sweep
    from tiseg_tpu_torch.ops.stencil import neighborhood_3x3_plain, neighborhood_min_3x3
    from tiseg_tpu_torch.ops.watershed import watershed, watershed_plain
    counters = dist_counters()
    zero_counts(counters)
    got = dist_ws.dynamic_watershed_device(p_img)
    torch.cuda.synchronize()
    launches = read_counts(counters)
    iters = dist_ws.reconstruction_by_erosion.last_iterations
    routes = (ccl_sweep.last_route[0], watershed.last_route[0])
    t1 = time.perf_counter()
    want = dist_ws.dynamic_watershed_device(p_img.cpu())
    cpu_s = time.perf_counter() - t1
    b_img, hrecons, seed, maxima, markers = dist_steps(p_img)
    checks = {
        'route': torch.equal(got.cpu(), want),
        'B9 (the seed plane)': torch.equal(neighborhood_min_3x3(seed).cpu(), neighborhood_3x3_plain(seed.cpu(), True)),
        'B2 (the regional minima)': torch.equal(markers.cpu(), ccl_plain(maxima.cpu(), 2)),
        'B5 (fixpoint mode)': torch.equal(watershed(hrecons, markers, b_img, 1, 64, None, None).cpu(),
                                          watershed_plain(hrecons.cpu(), markers.cpu(), b_img.cpu(), 1, 64, None,
                                                          None))}
    expect = {'neighborhood_3x3': iters, 'ccl_sweep cluster': 1, 'ccl_sweep global': 0, 'watershed cluster': 1,
              'watershed global': 0}
    n_inst = sum(len(torch.unique(got[b])) - 1 for b in range(len(got)))
    print(f'{label} {tuple(p_img.shape)}: launches {launches} (the reconstruction ran {iters} iterations, '
          f'{dist_ws.MAX_ITERS} at most); routes B2 {ccl_sweep.last_route}, B5 {watershed.last_route}; {n_inst} '
          f'instances; equal to the CPU path ({cpu_s:.2f} s) and each kernel to its plain version: {checks}',
          flush=True)
    if launches != expect or routes != ('cluster', 'cluster') or not all(checks.values()) or not 0 < iters <= 256:
        raise AssertionError(f'{label}: launches {launches} (expected {expect}), routes {routes}, checks {checks}')
    return got, iters, launches


def dist_kernel_rows(hrecons, seed, maxima, markers, b_img, launches):
    """B9, B2 and B5 on the inputs DIST's main path gave them, each in turns against its earlier design where it
    has one (B2's and B5's global chains): ms per call, device ms per launch (L2 flushed), plain ms, bound; B9
    beside F.max_pool2d on the negated plane (the same minimum)."""
    from tiseg_tpu_torch.ops import flood
    from tiseg_tpu_torch.ops.flood import ccl_plain, ccl_sweep
    from tiseg_tpu_torch.ops.stencil import neighborhood_3x3_plain, neighborhood_min_3x3
    from tiseg_tpu_torch.ops.watershed import _launch_global as ws_global
    from tiseg_tpu_torch.ops.watershed import watershed, watershed_plain
    rows = {}
    neg = -seed
    pool = lambda: torch.nn.functional.max_pool2d(neg[:, None], 3, 1, 1)  # noqa: E731
    b9 = lambda: neighborhood_min_3x3(seed)  # noqa: E731
    if not torch.equal(-pool()[:, 0], b9()):
        raise AssertionError('neighborhood_min_3x3 differs from -F.max_pool2d(-x, 3, 1, 1) on DIST\'s seed plane')
    b_ms, b_by = bound('neighborhood_3x3', seed)
    rows['neighborhood_3x3'] = dict(
        launches=launches['neighborhood_3x3'], ms=cuda_ms(b9, reps=25), device_ms=device_ms(b9),
        plain_ms=cuda_ms(lambda: neighborhood_3x3_plain(seed, True), reps=3, warmup=1), bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(pool, reps=25), library_device_ms=device_ms(pool), copy_device_ms=device_ms(seed.clone),
        plane=list(seed.shape))
    mask = maxima.to(torch.int32)
    b2 = lambda: ccl_sweep(mask, connectivity=2)  # noqa: E731
    k_ms, earlier_ms, turns = time_in_turns(b2, lambda: flood._launch_global_ccl(mask, 2))
    b_ms, b_by = bound('ccl_sweep', mask)
    rows['ccl_sweep'] = dict(launches=launches['ccl_sweep cluster'], ms=k_ms, earlier_ms=earlier_ms, ms_turns=turns,
                             device_ms=device_ms(b2), plain_ms=cuda_ms(lambda: ccl_plain(maxima, 2), reps=3, warmup=1),
                             bound_ms=b_ms, bound_by=b_by, route=list(ccl_sweep.last_route))
    b_i = b_img.to(torch.int32)
    b5 = lambda: watershed(hrecons, markers, b_i, 1, 64, None, None)  # noqa: E731
    k_ms, earlier_ms, turns = time_in_turns(b5, lambda: ws_global(hrecons, markers, b_i, 1, 64, None, None))
    ws_global(hrecons, markers, b_i, 1, 64, None, None)
    waves = watershed.last_waves[1]  # the bound's count, as B5's other rows: the waves the chain needed on the batch
    b5()
    b_ms, b_by = bound('watershed', hrecons, waves)
    rows['watershed'] = dict(launches=launches['watershed cluster'], ms=k_ms, earlier_ms=earlier_ms, ms_turns=turns,
                             plain_ms=cuda_ms(lambda: watershed_plain(hrecons, markers, b_img, 1, 64, None, None),
                                              reps=3, warmup=1),
                             bound_ms=b_ms, bound_by=b_by, waves_needed_chain=waves,
                             waves=list(watershed.last_waves)[:3], route=list(watershed.last_route))
    for name, row in rows.items():
        print(f'DIST main-path kernel {name} {tuple(hrecons.shape)}: {row["ms"]:.4f} ms per call x {row["launches"]} '
              f'launches, plain {row["plain_ms"]:.2f} ms, bound {row["bound_ms"] * 1e3:.2f} us ({row["bound_by"]}); '
              + ', '.join(f'{k} {v}' for k, v in row.items() if k not in ('ms', 'launches', 'plain_ms', 'bound_ms',
                                                                           'bound_by')), flush=True)
    return rows


def dist_eval_path(args):
    """DIST from its CoNIC recipe (7 classes; split 256/40 windows x 8 views, device_postprocess=True) through
    InferenceRunner on 16 x 256^2 images, the seeded distance head standardized so that its fused map spans about
    0-15 with ~40% of the pixels >= 1: B9 once per reconstruction iteration, B2 and B5 once each on their cluster
    routes; the instances equal to the port's CPU path on the same fused maps; each kernel against its plain
    version on the main path's inputs and timed there; ms per image. Then the same route on the
    DistanceLabelMake(inst_norm=False) maps of 16 CoNIC-density instance planes. Returns the kernel rows."""
    from tiseg_tpu_torch.apis import InferenceRunner
    from tiseg_tpu_torch.datasets.ops import DistanceLabelMake
    from tiseg_tpu_torch.datasets.synthetic import CONIC_NUCLEI_PER_PATCH, make_nuclei
    from tiseg_tpu_torch.models import build_segmentor
    from tiseg_tpu_torch.models.segmentors import dist as dist_mod
    from tiseg_tpu_torch.utils import Config

    t0 = time.perf_counter()
    n_img, hw = CONIC_BATCH, CONIC_HW
    cfg = Config.fromfile(os.path.join(ROOT, DIST_CONIC_CONFIG))
    cfg.model.test_cfg = dict(cfg.model.test_cfg, device_postprocess=True, patch_batch=DIST_PATCH_BATCH)
    seg = build_segmentor(cfg.model, device='cuda', seed=args.seed)
    imgs = conic_images(args.seed + 76000, n_img, hw)
    img_t = torch.from_numpy(imgs).cuda()
    standardize_classifier_(seg, img_t, 'sem', seg.net.sem_head, [1.0] + [0.0] * (CONIC_CLASSES - 1))
    standardize_fused_(seg, img_t, 'dist', seg.net.dist_head, 0.0, DIST_STD)
    runner = InferenceRunner(seg)
    captured = {}
    route, inference = dist_mod.dynamic_watershed_device, seg.inference

    def capturing(p_img, *a):
        captured['p_img'] = p_img
        return route(p_img, *a)

    def capturing_inference(*a, **k):
        captured['fused'] = inference(*a, **k)
        return captured['fused']

    counters = dist_counters()
    dist_mod.dynamic_watershed_device, seg.inference = capturing, capturing_inference
    try:
        runner.dispatch(imgs, (hw, hw))  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(counters)
        out = runner.dispatch(imgs, (hw, hw))
        torch.cuda.synchronize()
        launches = read_counts(counters)
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        dist_mod.dynamic_watershed_device = route
        del seg.inference
    from tiseg_tpu_torch.ops import dist_ws
    iters = dist_ws.reconstruction_by_erosion.last_iterations
    p_img, fused = captured['p_img'], captured['fused']
    sem_out, inst_out = out['sem_pred'], out['inst_pred']
    want_inst = dist_ws.dynamic_watershed_device(p_img.cpu())
    dist = fused['dist'][..., 0]
    checks = {'shapes and types': (sem_out.shape == inst_out.shape == (n_img, hw, hw) and sem_out.dtype == torch.uint8
                                   and inst_out.dtype == torch.int32 and inst_out.is_cuda
                                   and fused['sem'].shape == (n_img, hw, hw, CONIC_CLASSES)
                                   and fused['dist'].shape == (n_img, hw, hw, 1)),
              'finite': bool(torch.isfinite(fused['sem']).all() and torch.isfinite(dist).all()),
              'distance clipped and truncated': torch.equal(p_img, torch.clamp(dist, 0, 255).to(torch.int32)),
              'sem_pred the argmax': torch.equal(sem_out, torch.argmax(fused['sem'], -1).to(torch.uint8)),
              'instances equal to the CPU path': torch.equal(inst_out.cpu(), want_inst)}
    ok = all(checks.values())
    expect = {'neighborhood_3x3': iters, 'ccl_sweep cluster': 1, 'ccl_sweep global': 0, 'watershed cluster': 1,
              'watershed global': 0}
    n_inst = sum(len(torch.unique(inst_out[b])) - 1 for b in range(n_img))
    share = float((dist >= 1).float().mean())
    print(f'DIST eval: {DIST_CONIC_CONFIG}, test_cfg {seg.test_cfg}; launches {launches} (the reconstruction ran '
          f'{iters} iterations); fused distance map mean {float(dist.mean()):.3f}, std {float(dist.std()):.3f}, max '
          f'{float(dist.max()):.2f}, {share:.4f} of the pixels >= 1; {n_inst} instances in {n_img} images; checks '
          f'{checks}; classes {torch.unique(sem_out).tolist()}; peak memory '
          f'{peak_gib:.3f} GiB', flush=True)
    if not ok or launches != expect or not (0.25 <= share <= 0.6 and n_inst > 100):
        raise AssertionError(f'DIST eval: outputs or launches differ ({launches}, expected {expect}), or the plane '
                             f'is degenerate ({share:.3f} of the pixels >= 1, {n_inst} instances)')
    dist_route_check('DIST main-path route', p_img)
    b_img, hrecons, seed, maxima, markers = dist_steps(p_img)
    rows = dist_kernel_rows(hrecons, seed, maxima, markers, b_img, launches)
    e2e_ms = wall_ms(lambda: runner.dispatch(imgs, (hw, hw)), reps=5) / n_img
    fwd_ms = wall_ms(lambda: seg.inference(img_t), reps=5) / n_img
    pp_ms = wall_ms(lambda: route(p_img), reps=5) / n_img
    print(f'DIST eval ({card_line()}): e2e {e2e_ms:.2f} ms per {hw}^2 image (median of 5 batches of {n_img}, '
          f'patch_batch {DIST_PATCH_BATCH}); forward + TTA fuse {fwd_ms:.2f} ms ({fwd_ms / e2e_ms:.1%}), the dynamic '
          f'watershed {pp_ms:.3f} ms ({pp_ms / e2e_ms:.2%}; {iters} B9 launches, B2 and B5 one each, per batch)',
          flush=True)

    # the route on the distance targets of 16 instance planes at CoNIC density
    maps = []
    for i in range(n_img):
        inst = make_nuclei(args.seed + 77000 + i, hw, CONIC_NUCLEI_PER_PATCH)[2]
        data = {'inst_gt': inst, 'sem_gt': (inst > 0).astype(np.int32), 'seg_fields': []}
        maps.append(DistanceLabelMake(inst_norm=False)(data)['dist_gt'])
    target = torch.from_numpy(np.stack(maps).astype(np.int32)).cuda()
    _, t_iters, _ = dist_route_check('DIST route on DistanceLabelMake(inst_norm=False) maps', target)
    for name, row in rows.items():
        row['target_iterations'] = t_iters
    print(json.dumps({'dist_eval': {'e2e_ms_per_image': e2e_ms, 'forward_ms_per_image': fwd_ms,
                                    'pp_ms_per_image': pp_ms, 'iterations': iters, 'launches': launches,
                                    'instances': n_inst, 'share_ge_1': share, 'peak_gib': peak_gib,
                                    'target_iterations': t_iters, 'phase_s': time.perf_counter() - t0}}), flush=True)
    del seg, runner, fused
    torch.cuda.empty_cache()
    return rows


# -- phase 6c: int8 post-training-quantized eval ----------------------------------------------
INT8_CALIB_CROPS, INT8_CALIB_HW = 16, 256  # tools/test.py's calibration: centre crops of its hw (256^2)
INT8_PLAIN_PATCHES = 2  # patches of each int8 conv's input held against the float64 plain version on the card
INT8_TIMED = 5  # CUDA-event-timed forwards per median
INT8_E2E_REPS = 3  # timed dispatches per median
# the card-against-CPU check: (images, side) per net; UNet and CDNet need 2 x 128^2 for more than 16 rows at the
# bottom (torch._int_mm refuses 16), HoVer-Net's stride-8 trunk takes one 128^2 image
INT8_CHECK = {'UNet': (2, 128), 'CDNet': (2, 128), 'HoverNet': (1, 128)}
# the bounds of the CPU tests against the jitted JAX program (tests/test_torch_quant_*.py): share of any site's
# int8 values, share of all of them, share of argmax pixels
INT8_SHARES = {'UNet': (0.01, 0.002, 0.005), 'CDNet': (0.5, 0.3, 0.08), 'HoverNet': (0.9, 0.3, 0.2)}
INT8_ROUTES = ('float', 'int8 dequant', 'int8 resident')


@contextlib.contextmanager
def int8_recorded(keep_cpu: bool = False):
    """ops/int8_conv.py's routes wrapped for one run, each call recorded as a dict (kind, input, kernel, args,
    output shape): the card's route (im2col and torch._int_mm), whose output on its first INT8_PLAIN_PATCHES
    patches is held against the float64 plain version on the same card there and then (a difference raises);
    with ``keep_cpu``, also the CPU's route (the plain version), each input kept as a CPU copy and nothing held.
    The routes are wrapped, not conv2d_i8 itself, whose body counts its launches on the module's name."""
    from tiseg_tpu_torch.ops import int8_conv
    calls = []
    routes = {'_conv2d_i8_mm': ('conv', int8_conv.conv2d_i8_plain),
              '_conv_transpose2x_i8_mm': ('tconv', int8_conv.conv_transpose2x_i8_plain)}
    if keep_cpu:
        routes.update({'conv2d_i8_plain': ('conv', None), 'conv_transpose2x_i8_plain': ('tconv', None)})
    saved = {name: getattr(int8_conv, name) for name in routes}

    def wrap(fn, kind, plain):
        def call(x, w, *a):
            y = fn(x, w, *a)
            if not keep_cpu:
                k = min(INT8_PLAIN_PATCHES, x.shape[0])
                if not torch.equal(y[:k], plain(x[:k], w, *a)):
                    raise AssertionError(f'int8 {kind} {tuple(x.shape)} x {tuple(w.shape)} {a}: the _int_mm route '
                                         f'differs from the plain version')
            calls.append(dict(kind=kind, x=x.cpu() if keep_cpu else x, w=w, args=a, y=tuple(y.shape)))
            return y
        return call

    for name, (kind, plain) in routes.items():
        setattr(int8_conv, name, wrap(saved[name], kind, plain))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(int8_conv, name, fn)


def int8_call_ops(c) -> float:
    """Multiply-adds x 2 of one recorded int8 call (the convolution's own, groups counted as such)."""
    kh, kw, cin, f = c['w'].shape
    if c['kind'] == 'tconv':  # each output pixel of the 4 x 4 / stride-2 transposed conv takes 2 x 2 taps
        return 2.0 * np.prod(c['y'][:3]) * 4 * cin * f
    return 2.0 * np.prod(c['y'][:3]) * kh * kw * cin * f


def int8_form(c) -> str:
    kh, kw, _, _ = c['w'].shape
    if c['kind'] == 'tconv':
        return f'tconv 4x4/2 {tuple(c["x"].shape)} -> {c["y"]}'
    stride, padding, groups = c['args'] if c['args'] else (1, 'SAME', 1)
    return (f'{kh}x{kw}/{stride if isinstance(stride, int) else stride[0]} {padding} g{groups} '
            f'{tuple(c["x"].shape)} x {tuple(c["w"].shape)}')


def time_int8_call(c):
    """One recorded int8 conv at its main-path shape: the wrapper (im2col and torch._int_mm) against cuDNN's
    float32 convolution of the same shape (TF32 off), and the bound (the product's operations at the int8
    tensor-core rate, or its input, kernel and int32 output bytes)."""
    import torch.nn.functional as F

    from tiseg_tpu_torch.ops import int8_conv
    x, w = c['x'], c['w']
    xf = x.float().permute(0, 3, 1, 2)
    if c['kind'] == 'tconv':
        fn = lambda: int8_conv.conv_transpose2x_i8(x, w)  # noqa: E731
        wf = w.float().flip(0, 1).permute(2, 3, 0, 1).contiguous()
        ref = lambda: F.conv_transpose2d(xf, wf, stride=2, padding=1)  # noqa: E731
    else:
        stride, padding, groups = c['args'] if c['args'] else (1, 'SAME', 1)
        fn = lambda: int8_conv.conv2d_i8(x, w, stride, padding, groups)  # noqa: E731
        (pt, pb), (pl, pr) = int8_conv.conv_pads(padding, x.shape[1], x.shape[2], w.shape[0], w.shape[1], stride)
        xp = F.pad(xf, (pl, pr, pt, pb)) if (pt, pl) != (pb, pr) else xf
        wf = w.float().permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        pad = 0 if (pt, pl) != (pb, pr) else (pt, pl)
        ref = lambda: F.conv2d(xp, wf, stride=stride, padding=pad, groups=groups)  # noqa: E731
    ops = int8_call_ops(c)
    n_bytes = x.numel() + w.numel() + 4 * int(np.prod(c['y']))
    op_ms, byte_ms = ops / INT8_OPS_PER_S * 1e3, bytes_ms(n_bytes)
    return {'form': int8_form(c), 'gop': ops / 1e9, 'ms': cuda_ms(fn, INT8_TIMED), 'cudnn_f32_ms': cuda_ms(ref, INT8_TIMED),
            'bound_ms': max(op_ms, byte_ms), 'bound_by': 'operations' if op_ms >= byte_ms else 'bytes'}


@contextlib.contextmanager
def int8_route(name: str, route: str):
    """The segmentor's int8 eval forced onto one executor: ``int8 resident`` is the segmentors' own choice;
    ``int8 dequant`` swaps the resident executor for the dequant one."""
    from tiseg_tpu_torch.models.heads import quant_cdnet, quant_decode, quant_hovernet
    module, attr, fn = {'UNet': (quant_decode, 'resident_ok', lambda fp: False),
                        'CDNet': (quant_cdnet, 'resident_ok', lambda fpq: False),
                        'HoverNet': (quant_hovernet, 'apply_hovernet_q8', quant_hovernet.apply_hovernet_q)}[name]
    before = getattr(module, attr)
    if route == 'int8 dequant':
        setattr(module, attr, fn)
    try:
        yield
    finally:
        setattr(module, attr, before)


def int8_executors(name: str):
    """(fold, {route: executor(prep, fpq, x) -> heads}) of one net: ``fold(seg)`` gives the executors' folded
    parameters."""
    from tiseg_tpu_torch.models.heads import quant_cdnet as qc, quant_decode as qd, quant_hovernet as qh
    f32 = torch.float32
    if name == 'UNet':
        return (lambda seg: seg._fold(),
                {'int8 dequant': lambda fp, q, x: {'sem': qd.apply_fast_unet_q(fp['vgg'], fp['head'], q, x, dtype=f32)},
                 'int8 resident': lambda fp, q, x: {'sem': qd.apply_fast_unet_q8(fp['vgg'], fp['head'], q, x,
                                                                                 dtype=f32)}})
    if name == 'CDNet':
        return (lambda seg: qc.build_cdnet_fp(seg.net),
                {'int8 dequant': lambda fp, q, x: qc.apply_cdnet_q(fp, q, x, dtype=f32),
                 'int8 resident': lambda fp, q, x: qc.apply_cdnet_q8(fp, q, x, dtype=f32)})
    return (lambda seg: qh.build_hovernet_fp(seg.net),
            {'int8 dequant': lambda fp, q, x: qh.apply_hovernet_q(fp, q, x, dtype=f32),
             'int8 resident': lambda fp, q, x: qh.apply_hovernet_q8(fp, q, x, dtype=f32)})


def tree_to(fpq, device):
    return {'act': {k: v.to(device) for k, v in fpq['act'].items()},
            'wq': {k: (w.to(device), s.to(device)) for k, (w, s) in fpq['wq'].items()}}


def int8_card_vs_cpu(name: str, seg, fpq, patches) -> dict:
    """Each int8 executor on the card against the same executor on the port's CPU path, at the same weights,
    int8 tree and INT8_CHECK images (cut from ``patches``): the share of differing int8 inputs per site and overall, and the share of
    differing argmax pixels per head, within the CPU tests' bounds (INT8_SHARES); the largest logit difference
    printed beside them."""
    fold, execs = int8_executors(name)
    cpu = type(seg)(seg.num_classes, test_cfg=dict(seg.test_cfg), device='cpu')
    cpu.net.load_state_dict({k: v.cpu() for k, v in seg.net.state_dict().items()})
    n, side = INT8_CHECK[name]
    x = torch.from_numpy(np.ascontiguousarray(patches[:n, :side, :side]))
    site_bound, all_bound, argmax_bound = INT8_SHARES[name]
    out = {}
    with torch.inference_mode():
        for route, run in execs.items():
            got = {}
            for dev, s, q in (('cuda', seg, fpq), ('cpu', cpu, tree_to(fpq, 'cpu'))):
                with int8_recorded(keep_cpu=True) as calls:
                    heads = run(fold(s), q, x.to(dev))
                got[dev] = ({k: v.float().cpu() for k, v in heads.items()}, [c['x'] for c in calls])
            (h_gpu, a_gpu), (h_cpu, a_cpu) = got['cuda'], got['cpu']
            shares = [float((a != b).float().mean()) for a, b in zip(a_gpu, a_cpu)]
            overall = sum(int((a != b).sum()) for a, b in zip(a_gpu, a_cpu)) / sum(a.numel() for a in a_cpu)
            flips = {k: float((h_gpu[k].argmax(-1) != h_cpu[k].argmax(-1)).float().mean()) for k in h_cpu
                     if k in ('sem', 'fore', 'dir')}  # the class heads (not point, nor hv's regression)
            err = {k: float((h_gpu[k] - h_cpu[k]).abs().max() / h_cpu[k].abs().max()) for k in h_cpu}
            ok = (len(a_gpu) == len(a_cpu) and max(shares) <= site_bound and overall <= all_bound
                  and max(flips.values()) <= argmax_bound)
            print(f'{name} {route}, card against CPU on {n} x {side}^2: {len(a_cpu)} int8 convs, int8 inputs '
                  f'differing at most {max(shares):.4%} of a site (bound {site_bound:.1%}), {overall:.4%} of all '
                  f'(bound {all_bound:.1%}); argmax pixels differing {flips} (bound {argmax_bound:.1%}); largest '
                  f'difference over the largest value {err}', flush=True)
            if not ok:
                raise AssertionError(f'{name} {route}: the card differs from the CPU beyond the bounds')
            out[route] = {'convs': len(a_cpu), 'max_site_share': max(shares), 'share': overall,
                          'argmax_share': flips, 'rel_err': err}
    return out


def int8_net_routes(name: str, seg, imgs, hw: int, hook: str, counters, expect, patch_batch: int):
    """One net through InferenceRunner on the float, dequant int8 and resident int8 routes: the launches of its
    post-processing kernels held by drive_once, the predictions' argmax share against the float route, e2e ms per
    image and peak GiB, the executors' forward ms on one patch batch; every int8 conv of both executors on that
    batch held against its plain version; the card against the CPU; the three heaviest int8 sites timed against
    cuDNN float32. ``seg`` holds its int8 tree already."""
    from tiseg_tpu_torch.apis import InferenceRunner
    card = card_line()
    runner = InferenceRunner(seg)
    fold, execs = int8_executors(name)
    crops = [im[y:y + 256, x:x + 256] for im in imgs for y in range(0, hw - 255, 248) for x in range(0, hw - 255, 248)]
    patches_np = np.stack([crops[i % len(crops)] for i in range(patch_batch)])  # the network's batch of 256^2 windows
    patches = torch.from_numpy(patches_np).cuda()
    res, preds = {}, {}
    for route in INT8_ROUTES:
        seg.test_cfg['int8_eval'] = route != 'float'
        with int8_route(name, route):
            out, _, launches, peak = drive_once(runner, seg, hook, imgs, hw, counters, expect)
            e2e = wall_ms(lambda: runner.dispatch(imgs, (hw, hw)), INT8_E2E_REPS) / len(imgs)
            prep = seg.prepare_inference()
            fwd = cuda_ms(lambda: seg.forward_heads(patches, prep=prep), INT8_TIMED)
        preds[route] = out['sem_pred']
        res[route] = {'forward_ms_per_batch': fwd, 'e2e_ms_per_image': e2e, 'e2e_peak_gib': peak,
                      'launches': launches,
                      'argmax_share_vs_float': float((preds[route] != preds['float']).float().mean())}
        print(f'{name} {route} ({card}): forward {fwd:.3f} ms per batch of {patch_batch} x 256^2, e2e {e2e:.2f} ms per '
              f'{hw}^2 image (median of {INT8_E2E_REPS} dispatches of {len(imgs)}), peak {peak:.3f} GiB; post-processing '
              f'launches {launches}; sem_pred differing from the float route on '
              f'{res[route]["argmax_share_vs_float"]:.4%} of the pixels', flush=True)
    seg.test_cfg['int8_eval'] = False

    # every int8 conv of both executors on the patch batch: the _int_mm route against the plain version
    fp, forms, resident = fold(seg), set(), None
    with torch.inference_mode():
        for route, run in execs.items():
            with int8_recorded() as calls:
                run(fp, seg._int8_fpq, patches)
            forms |= {int8_form(c) for c in calls}
            if route == 'int8 resident':
                resident = calls
            print(f'{name} {route}: {len(calls)} int8 convs on {patch_batch} x 256^2, each equal to its plain version '
                  f'on its first {INT8_PLAIN_PATCHES} patches', flush=True)
        heavy = sorted(resident, key=int8_call_ops, reverse=True)[:3]
        sites = [time_int8_call(c) for c in heavy]
    del resident, heavy
    for s in sites:
        print(f'{name} int8 site {s["form"]} ({s["gop"]:.1f} GOP, {card}): {s["ms"]:.4f} ms against cuDNN float32 '
              f'{s["cudnn_f32_ms"]:.4f} ms; bound {s["bound_ms"]:.4f} ms by {s["bound_by"]}', flush=True)
    res['card_vs_cpu'] = int8_card_vs_cpu(name, seg, seg._int8_fpq, patches_np)
    res['int8_forms'] = sorted(forms)
    res['heaviest_sites'] = sites
    return res


def int8_eval_path(args):
    """The int8 eval of UNet, CDNet and HoVer-Net (heads/quant_decode.py, quant_cdnet.py, quant_hovernet.py)
    through InferenceRunner, each net on its float, dequant int8 and resident int8 routes (int8_net_routes); the
    UNet's out='pred' route on 16 x 256^2 whole images (B1 once per batch, its plane the argmax of the resident
    logits bit for bit); tools/test.py --int8-calib 2 on the UNet checkpoint and val tiles of train_cli_path."""
    from tiseg_tpu_torch.datasets.synthetic import make_nuclei, nuclei_density
    from tiseg_tpu_torch.models.heads import quant_decode as qd
    from tiseg_tpu_torch.ops.instance_pp import instance_postprocess_sweep
    from tiseg_tpu_torch.tools import test as test_cli

    results = {}
    # UNet: the MoNuSeg recipe's test_cfg on one 1000^2 image, calibrated on 16 centre crops of 256^2
    seg, img = unet_recipe_seg(args)
    calib = np.stack([make_nuclei(args.seed + 9100 + i, 320, nuclei_density(320))[0][32:288, 32:288]
                      for i in range(INT8_CALIB_CROPS)])
    t0 = time.perf_counter()
    seg.calibrate_int8(calib)
    torch.cuda.synchronize()
    print(f'UNet int8: calibrated on {INT8_CALIB_CROPS} x {INT8_CALIB_HW}^2 in {time.perf_counter() - t0:.2f} s; '
          f'{len(seg._int8_fpq["wq"])} int8 sites', flush=True)
    results['UNet'] = int8_net_routes('UNet', seg, img, UNET_HW, '_device_instance_pp', b1_counters(),
                                      B1_STRIP_LAUNCHES, args.patch_batch)

    # the out='pred' route: the same net whole, one view, on 16 x 256^2: B1 once per batch, on the argmax plane
    whole = type(seg)(2, test_cfg=dict(mode='whole', rotate_degrees=[0], flip_directions=['none'],
                                       device_postprocess=True, radius=1, int8_eval=True), device='cuda')
    whole.net.load_state_dict(seg.net.state_dict())
    whole._int8_fpq = seg._int8_fpq
    imgs = conic_images(args.seed + 9200, CONIC_BATCH, CONIC_HW)
    outs, run_q8 = [], qd.apply_fast_unet_q8

    def spy(*a, **kw):
        outs.append(kw.get('out', 'logits'))
        return run_q8(*a, **kw)

    counters = b1_counters()
    img_t = torch.from_numpy(imgs).cuda()
    captured, device_pp = {}, whole._device_instance_pp

    def capturing_pp(sem_pred):
        captured['plane'] = sem_pred
        return device_pp(sem_pred)

    whole._device_instance_pp = capturing_pp
    qd.apply_fast_unet_q8 = spy
    try:
        whole.inference_and_postprocess(img_t)  # warm-up
        torch.cuda.synchronize()
        zero_counts(counters)
        outs.clear()
        captured.clear()
        out = whole.inference_and_postprocess(img_t)
        torch.cuda.synchronize()
        launches = read_counts(counters)
    finally:
        qd.apply_fast_unet_q8 = run_q8
        whole._device_instance_pp = device_pp
    plane = captured['plane']
    with torch.inference_mode():
        fp = whole._fold()
        want = run_q8(fp['vgg'], fp['head'], whole._int8_fpq, img_t, dtype=torch.float32).argmax(-1).to(torch.int32)
    b1_cluster = {'launches': 1, 'vectorized_launches': 0, 'cluster_launches': 1, 'strip_launches': 0,
                  'global_launches': 0}
    if outs != ['pred'] or launches != b1_cluster or not torch.equal(plane, want):
        raise AssertionError(f"UNet out='pred': executor calls {outs}, B1 launches {launches}, plane equal to the "
                             f'argmax: {torch.equal(plane, want)}')
    print(f"UNet out='pred' route on {CONIC_BATCH} x {CONIC_HW}^2 whole images: B1 launches {launches} per batch; the "
          f'plane equals the argmax of the resident logits bit for bit; foreground {float((plane > 0).float().mean()):.4f}, '
          f'{sum(len(torch.unique(out["inst_pred"][b])) - 1 for b in range(CONIC_BATCH))} instances', flush=True)
    results['UNet']['pred_route_launches'] = launches
    del seg, whole
    torch.cuda.empty_cache()

    # CDNet: the CoNIC recipe on 16 x 256^2 (B7), calibrated on the batch itself
    seg, imgs = cdnet_conic_seg(args)
    seg.calibrate_int8(imgs)
    counters = {'instance_postprocess_vectorized': (instance_postprocess_sweep, 'vectorized_launches'),
                'cluster route': (instance_postprocess_sweep, 'cluster_launches'),
                'global route': (instance_postprocess_sweep, 'global_launches')}
    results['CDNet'] = int8_net_routes('CDNet', seg, imgs, CONIC_HW, '_device_instance_pp', counters,
                                       {'global route': 0}, args.cd_patch_batch)
    del seg
    torch.cuda.empty_cache()

    # HoVer-Net: the CoNIC recipe on 16 x 256^2 (B2 with B4 fused, B3, B5), the hv branch in float
    seg, imgs = hovernet_conic_seg(args)
    seg.calibrate_int8(imgs)
    results['HoverNet'] = int8_net_routes('HoverNet', seg, imgs, CONIC_HW, '_instances', hover_counters(),
                                          HOVER_LAUNCHES, args.hover_patch_batch)
    del seg
    torch.cuda.empty_cache()

    # the entry point users run: tools/test.py --int8-calib 2 on train_cli_path's checkpoint and val tiles
    work = os.path.join(ROOT, 'build', 'dev', 'cli_train')
    best = os.path.join(work, 'checkpoints', 'best.pt')
    test_data = [f'data.test.data_root={os.path.join(DATA_DIR, "cli_w0_s0")}', 'data.test.img_dir=',
                 'data.test.ann_dir=', 'data.test.split=split.txt']
    test_cfg = ['model.test_cfg.device_postprocess=True', 'model.test_cfg.device_metrics=True',
                f'model.test_cfg.patch_batch={args.patch_batch}']
    counters = b1_counters()
    scores = {}
    for label, extra in (('float', []), ('int8', ['--int8-calib', '2'])):
        outs.clear()
        qd.apply_fast_unet_q8 = spy
        zero_counts(counters)
        t0 = time.perf_counter()
        try:
            scores[label] = test_cli.main([UNET_CONFIG, best, *extra, '--options', *test_data, *test_cfg])
        finally:
            qd.apply_fast_unet_q8 = run_q8
        test_s = time.perf_counter() - t0
        launches = read_counts(counters)
        n_fwd = -(-200 // args.patch_batch) * CLI_VAL_TILES  # 25 windows x 8 views per tile, in chunks
        if launches != {k: n * CLI_VAL_TILES for k, n in B1_STRIP_LAUNCHES.items()} or \
                len(outs) != (n_fwd if label == 'int8' else 0):
            raise AssertionError(f'tools/test.py {label}: B1 launches {launches}, resident executor calls {len(outs)}')
        print(f'tools/test.py {" ".join(extra) or "(float)"} on {os.path.relpath(best, ROOT)} over {CLI_VAL_TILES} val '
              f'tiles ({test_s:.1f} s, {card_line()}): {dict(scores[label])}; B1 launches {launches}, resident int8 '
              f'forwards {len(outs)}', flush=True)
    if not all(np.isfinite(v) for v in scores['int8'].values() if isinstance(v, float)):
        raise AssertionError(f'tools/test.py --int8-calib 2: {scores["int8"]}')
    results['test_cli'] = {k: {m: float(v) for m, v in s.items()} for k, s in scores.items()}
    print(json.dumps({'int8_eval': results}, default=str), flush=True)


def time_pp_main_path(model: str, sem_pred: torch.Tensor, radius: int, num_classes: int, launches: int):
    """B1 or B7 on a main path's semantic planes: the route, the earlier
    global chain and the route again, each the median of 25 calls; the
    route held against pp_route; the plain version and the bound."""
    from tiseg_tpu_torch.ops.instance_pp import (_launch_cluster, _launch_global, instance_postprocess_plain,
                                                 instance_postprocess_sweep, instance_postprocess_vectorized_plain)
    vectorized = num_classes > 2
    name = 'instance_postprocess_vectorized' if vectorized else 'instance_postprocess_sweep'
    PP_PLANES[f'main path {model} {tuple(sem_pred.shape)}'] = (sem_pred.cpu(), num_classes, radius)
    kernel = lambda: instance_postprocess_sweep(sem_pred, radius=radius, num_classes=num_classes)  # noqa: E731
    k_ms, earlier_ms, turns = time_in_turns(kernel, lambda: _launch_global(sem_pred, radius, 5, num_classes,
                                                                           vectorized))
    row = {}
    if pp_layout(*sem_pred.shape)[0] == 'cluster':
        # the cluster kernel's two widths in turns on the same planes
        width = {t: (lambda t=t: _launch_cluster(sem_pred, radius, 5, num_classes, vectorized, t)) for t in (512, 1024)}
        if not all(torch.equal(a, b) for a, b in zip(width[512](), width[1024]())):
            raise AssertionError(f'{model}: the cluster kernel gives other outputs at 512 and 1024 threads')
        row['ms_1024_threads'], row['ms_512_threads'], row['ms_turns_1024_threads'] = time_in_turns(width[1024],
                                                                                                  width[512])
    kernel()
    note = route_note(instance_postprocess_sweep, pp_layout, None, sem_pred.shape)
    if row:
        note += (f'; 1024 threads {row["ms_1024_threads"]:.4f} ms (readings {row["ms_turns_1024_threads"][0]:.4f} / '
                 f'{row["ms_turns_1024_threads"][1]:.4f}), 512 threads {row["ms_512_threads"]:.4f} ms in turns')
    plain = instance_postprocess_vectorized_plain if vectorized else instance_postprocess_plain
    p_ms = cuda_ms(lambda: plain(sem_pred, radius, 5, num_classes), reps=3, warmup=1)
    b_ms, b_by = bound(name, sem_pred)
    print(f'{model} main-path kernel {name} {tuple(sem_pred.shape)}: {k_ms:.4f} ms (readings {turns[0]:.4f} / '
          f'{turns[1]:.4f}), earlier chain {earlier_ms:.4f} ms in turns ({earlier_ms / k_ms:.2f}x), plain {p_ms:.2f} '
          f'ms, bound {b_ms * 1e3:.2f} us ({b_by}){note}', flush=True)
    return dict(launches=launches, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, earlier_ms=earlier_ms,
                ms_turns=turns, plane_route=list(instance_postprocess_sweep.last_route), **row)


# -- phase 4: the HoVer-Net eval path --------------------------------------------------
@contextlib.contextmanager
def plain_flood_ops():
    """Run ops/hover.py's flood steps through the plain versions (on the
    same device) while the block is open."""
    from tiseg_tpu_torch.ops import hover
    from tiseg_tpu_torch.ops.flood import ccl_plain, fill_holes_plain, size_filter_plain
    from tiseg_tpu_torch.ops.watershed import watershed_plain
    saved = hover.ccl_filter_sweep, hover.fill_holes_sweep, hover.watershed
    hover.ccl_filter_sweep = lambda m, min_size, connectivity: size_filter_plain(ccl_plain(m > 0, connectivity),
                                                                                 min_size)
    hover.fill_holes_sweep = lambda m: fill_holes_plain(m > 0)
    hover.watershed = lambda image, markers, mask, connectivity, num_levels, rounds_per_level, cleanup_rounds: \
        watershed_plain(image, markers, mask, connectivity, num_levels, rounds_per_level, cleanup_rounds)
    try:
        yield
    finally:
        hover.ccl_filter_sweep, hover.fill_holes_sweep, hover.watershed = saved


@torch.no_grad()
def randomize_bn_(net: torch.nn.Module, generator: torch.Generator) -> None:
    """Draw every BN layer's scale, shift and running statistics from the
    seed (scale and variance in [0.5, 1.5), shift and mean ~ N(0, 0.1^2)).
    With every BN an identity, the seeded trunk's HV maps lack the steep
    ramps that make watershed markers, and the plane has no instances."""
    for m in net.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            n, dev = m.num_features, m.weight.device
            m.weight.copy_((torch.rand(n, generator=generator) + 0.5).to(dev))
            m.bias.copy_((0.1 * torch.randn(n, generator=generator)).to(dev))
            m.running_mean.copy_((0.1 * torch.randn(n, generator=generator)).to(dev))
            m.running_var.copy_((torch.rand(n, generator=generator) + 0.5).to(dev))


def hovernet_conic_seg(args):
    """HoVer-Net from its CoNIC recipe (device_postprocess, ``args.hover_patch_batch``) with seeded weights and
    BN layers, and CONIC_BATCH images of CONIC_HW^2 at CoNIC density; the np classifier bias puts ~40% of view
    0's pixels on the foreground side."""
    from tiseg_tpu_torch.datasets.synthetic import CONIC_NUCLEI_PER_PATCH, make_nuclei
    from tiseg_tpu_torch.models import build_segmentor
    from tiseg_tpu_torch.utils import Config
    cfg = Config.fromfile(os.path.join(ROOT, HOVER_CONFIG))
    cfg.model.test_cfg = dict(cfg.model.test_cfg, device_postprocess=True, patch_batch=args.hover_patch_batch)
    print(f'HoVer-Net model: {HOVER_CONFIG}, test_cfg {cfg.model.test_cfg}', flush=True)
    seg = build_segmentor(cfg.model, device='cuda', seed=args.seed)
    randomize_bn_(seg.net, torch.Generator().manual_seed(args.seed + 1))
    imgs = np.stack([make_nuclei(args.seed + 5000 + i, CONIC_HW, CONIC_NUCLEI_PER_PATCH)[0]
                     for i in range(CONIC_BATCH)])
    logit = seg.forward_heads(torch.from_numpy(imgs).cuda())['fore']
    bias = -float(torch.quantile((logit[..., 1] - logit[..., 0]).flatten()[::7], 0.6))
    with torch.no_grad():
        seg.net.decoder['np'].u0[2].bias.copy_(torch.tensor([0.0, bias]))
    return seg, imgs


def hover_main_path(args):
    from tiseg_tpu_torch.apis import InferenceRunner
    from tiseg_tpu_torch.ops import hover
    from tiseg_tpu_torch.ops.flood import ccl_filter_sweep, ccl_sweep, fill_holes_sweep, size_filter
    from tiseg_tpu_torch.ops.hover import hover_post_proc_device
    from tiseg_tpu_torch.ops.watershed import _launch_global as ws_global
    from tiseg_tpu_torch.ops.watershed import watershed, watershed_plain

    n_img, hw = CONIC_BATCH, CONIC_HW
    seg, imgs = hovernet_conic_seg(args)
    runner = InferenceRunner(seg)
    captured = {}
    instances = seg._instances

    def capturing(fused):
        captured['fused'] = fused
        return instances(fused)

    seg._instances = capturing
    runner.dispatch(imgs, (hw, hw))  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # (wrapper, counter): the route must launch B2 twice on its cluster route, each with B4's size filter fused,
    # B3 once and B5 once, both on their cluster routes, and no global chain and no separate size filter
    counters, expected = hover_counters(), HOVER_LAUNCHES
    zero_counts(counters)
    out = runner.dispatch(imgs, (hw, hw))
    torch.cuda.synchronize()
    launches = read_counts(counters)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    seg._instances = instances
    if launches != expected:
        raise AssertionError(f'HoVer-Net main path: launches {launches}, expected {expected}')

    fused = captured['fused']
    sem_out, inst_out = out['sem_pred'], out['inst_pred']
    if not (sem_out.shape == inst_out.shape == (n_img, hw, hw) and sem_out.dtype == torch.uint8
            and inst_out.dtype == torch.int32 and inst_out.is_cuda):
        raise AssertionError(f'bad outputs {sem_out.shape} {sem_out.dtype} {inst_out.shape} {inst_out.dtype}')
    shapes = {'sem': (n_img, hw, hw, 7), 'fore': (n_img, hw, hw, 2), 'hv': (n_img, hw, hw, 2)}
    for k, shape in shapes.items():
        if fused[k].shape != shape or not torch.isfinite(fused[k]).all():
            raise AssertionError(f'fused {k} is not finite of shape {shape}: {tuple(fused[k].shape)}')
    for k in ('sem', 'fore'):
        if not torch.allclose(fused[k].sum(-1), torch.ones((), device='cuda'), atol=1e-5):
            raise AssertionError(f'fused {k} maps are not probabilities')
    fg = float((fused['fore'][..., 1] >= 0.5).float().mean())
    n_inst = sum(len(torch.unique(inst_out[b])) - 1 for b in range(n_img))
    if not (0.1 <= fg <= 0.6 and n_inst > 0):
        raise AssertionError(f'degenerate HoVer output: foreground {fg:.3f}, {n_inst} instances')
    with plain_flood_ops():
        want = hover_post_proc_device(fused['fore'][..., 1], fused['hv'])
    if not torch.equal(inst_out, want):
        raise AssertionError(f'HoVer main-path instances differ from the plain post-processing: '
                             f'{int((inst_out != want).sum())} pixels')
    if not torch.equal(sem_out, torch.argmax(fused['sem'], -1).to(torch.uint8)):
        raise AssertionError('HoVer main-path sem_pred is not the argmax of the fused sem map')
    print(f'HoVer-Net main path: launches {launches}, foreground {fg:.4f}, '
          f'{n_inst} instances in {n_img} images, '
          f'equal to the plain post-processing; peak memory {peak_gib:.3f} GiB '
          f'(patch_batch {args.hover_patch_batch})', flush=True)

    img_t = torch.from_numpy(imgs).cuda()
    e2e_ms = wall_ms(lambda: runner.dispatch(imgs, (hw, hw)), reps=5) / n_img
    fwd_ms = wall_ms(lambda: seg.inference(img_t), reps=5) / n_img
    pp_ms = wall_ms(lambda: seg._instances(fused), reps=5) / n_img
    print(f'HoVer-Net e2e {e2e_ms:.2f} ms per {hw}^2 image (median of 5 batches of {n_img}); forward + TTA fuse '
          f'{fwd_ms:.2f} ms ({fwd_ms / e2e_ms:.1%}), argmax + HoVer post-processing {pp_ms:.3f} ms '
          f'({pp_ms / e2e_ms:.2%})', flush=True)

    # each kernel on the inputs the main path gave it (first call of each)
    fore = fused['fore'][..., 1]
    mask = (fore >= 0.5).to(torch.int32)
    labels = ccl_sweep(mask, connectivity=1)
    blb = ccl_filter_sweep(mask, DIAMOND_MIN_SIZE, connectivity=1) > 0
    overall, dist = hover.hover_energy(blb, fused['hv'])
    marker = (blb & ~(overall >= 0.4)).to(torch.int32)
    markers = hover.hover_markers(blb, overall)
    blb_i = blb.to(torch.int32)
    PP_PLANES[f'main path HoVer-Net foreground mask {tuple(mask.shape)}'] = (mask.cpu(), 2, 1)
    stats = flood_main_path('HoVer main-path', mask, labels, marker, launches['ccl_sweep'],
                            launches['fill_holes_sweep'])
    # per batch: B2 with the size filter fused, twice; B3; B5
    pp_kernel_ms = (stats['ccl_sweep']['fused_ms'] * launches['ccl_filter_sweep fused']
                    + stats['fill_holes_sweep']['ms'] * launches['fill_holes_sweep'])

    # B5: the cluster route, the earlier chain of one launch per wave, the cluster route again
    def call():
        return watershed(dist, markers, blb_i)

    extra = {}
    k_ms, extra['earlier_ms'], extra['ms_turns'] = time_in_turns(call, lambda: ws_global(dist, markers, blb_i))
    # the bound keeps the definition of earlier rows: the waves the
    # earlier chain needed on the batch (each level until no plane changes)
    ws_global(dist, markers, blb_i)
    waves = extra['waves_needed_chain'] = watershed.last_waves[1]
    call()
    extra['waves_budget'], extra['waves_needed'], extra['waves_run'] = watershed.last_waves
    extra['waves_mean'] = watershed.last_waves.mean_needed
    extra['plane_route'] = list(watershed.last_route)
    b_ms, b_by = bound('watershed', dist, waves)
    p_ms = cuda_ms(lambda: watershed_plain(dist, markers, blb), reps=3, warmup=1)
    n_ws = launches['watershed']
    stats['watershed'] = dict(launches=n_ws, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, **extra)
    pp_kernel_ms += k_ms * n_ws
    turns = extra['ms_turns']
    print(f'HoVer main-path kernel watershed {tuple(dist.shape)}: {k_ms:.4f} ms per call x {n_ws} launches, plain '
          f'{p_ms:.2f} ms, bound {b_ms * 1e3:.2f} us ({b_by})', flush=True)
    print(f'HoVer main-path watershed: cluster route {turns[0]:.4f} / {turns[1]:.4f} ms, earlier chain '
          f'{extra["earlier_ms"]:.4f} ms ({extra["earlier_ms"] / k_ms:.2f}x); route {extra["plane_route"]} '
          f'(route, cluster size, shared bytes per block, clusters resident); waves budget '
          f'{extra["waves_budget"]}, needed {extra["waves_needed"]} (mean per plane '
          f'{extra["waves_mean"]:.2f}), run {extra["waves_run"]}; the earlier chain needed {waves} waves '
          f'on the batch (the bound\'s count)', flush=True)
    print(f'HoVer post-processing: kernels {pp_kernel_ms / n_img:.3f} ms of {pp_ms:.3f} ms per image '
          f'(CUDA events x main-path launches / {n_img}: fused B2 {stats["ccl_sweep"]["fused_ms"]:.4f} x 2, B3 '
          f'{stats["fill_holes_sweep"]["ms"]:.4f}, B5 {stats["watershed"]["ms"]:.4f})', flush=True)
    return stats


def flood_main_path(label: str, mask: torch.Tensor, labels: torch.Tensor, marker: torch.Tensor, launches: int,
                    fill_launches: int):
    """B2 (4-connected), the fused ccl_filter_sweep (min_size 10) and B4's
    tile route on a main path's mask and 4-connected labels, and B3 on its
    marker mask, each in turns against the earlier chains (B2's union-find
    chain, that chain then B4's global kernel, B4's global kernel, B3's
    chain): ms per call (host time included) and device_ms per launch (L2
    flushed, enqueue hidden). Returns the rows of B2 (with the fused call's
    numbers), B4 and B3; B4 has no launch of its own on the main paths."""
    from tiseg_tpu_torch.ops import flood
    from tiseg_tpu_torch.ops.flood import (ccl_filter_sweep, ccl_plain, ccl_sweep, fill_holes_plain, fill_holes_sweep,
                                           filter_route, size_filter, size_filter_plain)
    k = DIAMOND_MIN_SIZE
    rows = {}
    for name, call, earlier, plain, x in (
            ('ccl_sweep', lambda: ccl_sweep(mask, connectivity=1), lambda: flood._launch_global_ccl(mask, 1),
             lambda: ccl_plain(mask > 0, 1), mask),
            ('fused', lambda: ccl_filter_sweep(mask, k, connectivity=1),
             lambda: flood._launch_global_filter(flood._launch_global_ccl(mask, 1), k),
             lambda: size_filter_plain(ccl_plain(mask > 0, 1), k), mask),
            ('size_filter', lambda: size_filter(labels, k), lambda: flood._launch_global_filter(labels, k),
             lambda: size_filter_plain(labels, k), labels),
            ('fill_holes_sweep', lambda: fill_holes_sweep(marker), lambda: flood._launch_global_fill(marker),
             lambda: fill_holes_plain(marker > 0), marker)):
        got = call()
        route = list({'size_filter': size_filter, 'fill_holes_sweep': fill_holes_sweep}.get(name, ccl_sweep).last_route)
        torch.cuda.synchronize()
        if not (torch.equal(got, plain()) and torch.equal(earlier(), got)):
            raise AssertionError(f'{label} {name} differs from its plain version or the earlier chain')
        want_route = filter_route(*x.shape, k) if name == 'size_filter' else ('cluster',)
        if route[:len(want_route)] != list(want_route):
            raise AssertionError(f'{label} {name}: route {route}, expected {want_route}')
        k_ms, earlier_ms, turns = time_in_turns(call, earlier)
        k_dev, earlier_dev = device_ms(call), device_ms(earlier)
        p_ms = cuda_ms(plain, reps=3, warmup=1)
        b_ms, b_by = bound('ccl_sweep' if name == 'fused' else name, x)
        rows[name] = dict(ms=k_ms, earlier_ms=earlier_ms, ms_turns=turns, device_ms=k_dev,
                          earlier_device_ms=earlier_dev, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, plane_route=route)
        print(f'{label} {name} {tuple(x.shape)}: {k_ms:.4f} ms (readings {turns[0]:.4f} / {turns[1]:.4f}), earlier '
              f'{earlier_ms:.4f} ms in turns ({earlier_ms / k_ms:.2f}x); device {k_dev * 1e3:.2f} us per launch '
              f'against {earlier_dev * 1e3:.2f} (L2 flushed); plain {p_ms:.2f} ms, bound {b_ms * 1e3:.2f} us '
              f'({b_by}); route {route}', flush=True)
    fused = rows.pop('fused')
    b2 = dict(launches=launches, library_ms=None, **rows['ccl_sweep'],
              **{f'fused_{key}': v for key, v in fused.items() if key != 'plane_route'})
    b4 = dict(launches=0, library_ms=None, **rows['size_filter'])
    b3 = dict(launches=fill_launches, library_ms=None, **rows['fill_holes_sweep'])
    return {'ccl_sweep': b2, 'size_filter': b4, 'fill_holes_sweep': b3}


# -- phases 5 and 6: the CDNet and the multi-task eval paths ---------------------------
@torch.no_grad()
def standardize_classifier_(seg, imgs, head: str, conv: torch.nn.Conv2d, shifts, scale: float = 2.0) -> None:
    """Rescale and shift a 1x1 classifier so that, on view 0 of ``imgs``,
    channel ``c`` of ``head`` has mean ``shifts[c]`` and std ``scale``. The
    seeded trunk's logits have per-channel offsets that swamp their
    variation, so one class would take every pixel. A head that gates
    others (point -> dir -> tc/sem) goes first."""
    logit = seg.forward_heads(imgs)[head].reshape(-1, len(shifts))
    gain = scale / logit.std(0)
    conv.weight.mul_(gain[:, None, None, None])
    conv.bias.copy_((conv.bias - logit.mean(0)) * gain + torch.tensor(shifts, device=gain.device))


@torch.no_grad()
def background_bias_(seg, imgs, head: str, conv: torch.nn.Conv2d, hit, share: float, steps: int = 8) -> None:
    """Bisect the background bias of the ``head`` classifier until ``share``
    of the first two images' pixels are ``hit(fused[head])`` in the
    TTA-fused map of ``seg.inference``. The views of a seeded net disagree
    about the classes but not about the background, so a share set on view 0
    alone shrinks to a few percent in the mean over the views."""
    start = float(conv.bias[0])
    bisect_share_(seg, imgs, head, hit, share, lambda t: conv.bias.__setitem__(0, start + t), steps)


@torch.no_grad()
def bisect_share_(seg, imgs, head: str, hit, share: float, set_offset, steps: int = 8) -> None:
    """Bisect ``set_offset(t)``, t in [-16, 16], whose larger values mean fewer hits, until ``share`` of the
    first two images' pixels are ``hit(fused[head])`` in the TTA-fused map of ``seg.inference``."""
    lo, hi = -16.0, 16.0
    for step in range(steps + 1):
        set_offset((lo + hi) / 2)
        if step < steps:
            if float(hit(seg.inference(imgs[:2])[head]).float().mean()) > share:
                lo = (lo + hi) / 2
            else:
                hi = (lo + hi) / 2


@torch.no_grad()
def fullnet_class_share_(seg, imgs, cls: int, share: float) -> None:
    """FullNet's classifier has no bias: bisect instead the shift of the last BN's output channel that raises
    class ``cls``'s logit most against both others, until ``share`` of the pixels take that class. That
    channel's 3x3 taps are first gathered into the centre one, so that the shift is the same at the border,
    where the others would read the zero padding (and draw a ring of one class around the plane)."""
    conv = seg.net.conv2
    w = conv.weight.sum((2, 3))
    lead = torch.stack([w[cls] - w[c] for c in range(w.shape[0]) if c != cls]).min(0).values
    j = int(lead.argmax())
    conv.weight[:, j] = 0
    conv.weight[:, j, 1, 1] = w[:, j]
    bn, gain = seg.net.blocks.trans7.bn, 1.0 / float(lead[j])
    start = float(bn.bias[j])
    bisect_share_(seg, imgs, 'sem', lambda m: m.argmax(-1) == cls, share,
                  lambda t: bn.bias.__setitem__(j, start - t * gain))


def foreground(sem_map: torch.Tensor) -> torch.Tensor:
    """Pixels whose fused argmax over the classes (a boundary channel aside) is not the background."""
    return sem_map[..., :CONIC_CLASSES].argmax(-1) > 0


def drive_once(runner, seg, hook: str, imgs, hw: int, counters, expect=None):
    """Warm up, then one run of the main path with the launch counts at 0.
    ``hook`` names the segmentor's post-processing method, whose arguments
    are captured. Every count must be 1, or what ``expect`` gives for its
    name. Returns (outputs, captured arguments, launches, peak GiB)."""
    captured = {}
    method = getattr(seg, hook)

    def capturing(*call_args):
        captured['args'] = call_args
        return method(*call_args)

    setattr(seg, hook, capturing)
    try:
        runner.dispatch(imgs, (hw, hw))  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        out = runner.dispatch(imgs, (hw, hw))
        torch.cuda.synchronize()
        launches = {name: getattr(fn, attr) for name, (fn, attr) in counters.items()}
    finally:
        delattr(seg, hook)
    for name, n in launches.items():
        want = (expect or {}).get(name, 1)
        if n != want:
            raise AssertionError(f'{name}: {n} launches on the {type(seg).__name__} main path, expected {want}')
    return out, captured['args'], launches, torch.cuda.max_memory_allocated() / 2 ** 30


def check_instances(name, out, want, n_img, hw, min_inst):
    """Shapes and types, bit-equality with the plain version's ``want``, and
    a plane that is not degenerate."""
    sem_out, inst_out = out['sem_pred'], out['inst_pred']
    if not (sem_out.shape == inst_out.shape == (n_img, hw, hw) and sem_out.dtype == torch.uint8
            and inst_out.dtype == torch.int32 and inst_out.is_cuda):
        raise AssertionError(f'{name}: bad outputs {sem_out.shape} {sem_out.dtype} {inst_out.shape} {inst_out.dtype}')
    if not (torch.equal(sem_out, want[0]) and torch.equal(inst_out, want[1])):
        raise AssertionError(f'{name}: main-path instances differ from the plain post-processing: '
                             f'{int((inst_out != want[1]).sum())} pixels')
    classes = torch.unique(sem_out).tolist()
    n_inst = sum(len(torch.unique(inst_out[b])) - 1 for b in range(n_img))
    fg = float((sem_out > 0).float().mean())
    if not (len(classes) > 2 and n_inst > min_inst and 0.05 <= fg <= 0.8):
        raise AssertionError(f'{name}: degenerate output: classes {classes}, {n_inst} instances, foreground {fg:.3f}')
    return classes, n_inst, fg


def conic_images(seed: int, n_img: int, hw: int = 256) -> np.ndarray:
    from tiseg_tpu_torch.datasets.synthetic import CONIC_NUCLEI_PER_PATCH, make_nuclei
    return np.stack([make_nuclei(seed + i, hw, CONIC_NUCLEI_PER_PATCH)[0] for i in range(n_img)])


def time_path(name, runner, seg, imgs, hw, pp, patch_batch):
    """Prints e2e, forward and post-processing ms per image (host clock, median of 5)."""
    n_img = len(imgs)
    img_t = torch.from_numpy(imgs).cuda()
    e2e_ms = wall_ms(lambda: runner.dispatch(imgs, (hw, hw)), reps=5) / n_img
    fwd_ms = wall_ms(lambda: seg.inference(img_t), reps=5) / n_img
    pp_ms = wall_ms(pp, reps=5) / n_img
    print(f'{name} e2e {e2e_ms:.2f} ms per {hw}^2 image (median of 5 batches of {n_img}, patch_batch {patch_batch}); '
          f'forward + TTA fuse {fwd_ms:.2f} ms ({fwd_ms / e2e_ms:.1%}), argmax + instance pp {pp_ms:.3f} ms '
          f'({pp_ms / e2e_ms:.2%})', flush=True)


def cdnet_conic_seg(args):
    """CDNet from its CoNIC recipe (device_postprocess, ``args.cd_patch_batch``) with seeded weights, and
    CONIC_BATCH images of CONIC_HW^2; the three classifiers standardized on view 0 and the background bias set
    so that ~40% of the fused map is foreground."""
    from tiseg_tpu_torch.models import build_segmentor
    from tiseg_tpu_torch.utils import Config
    cfg = Config.fromfile(os.path.join(ROOT, CDNET_CONFIG))
    cfg.model.test_cfg = dict(cfg.model.test_cfg, device_postprocess=True, patch_batch=args.cd_patch_batch)
    print(f'CDNet model: {CDNET_CONFIG}, test_cfg {cfg.model.test_cfg}', flush=True)
    seg = build_segmentor(cfg.model, device='cuda', seed=args.seed)
    imgs = conic_images(args.seed + 11000, CONIC_BATCH, CONIC_HW)
    img_t = torch.from_numpy(imgs).cuda()
    dgm = seg.net.head.postprocess
    standardize_classifier_(seg, img_t, 'point', dgm.point_conv, [0.3], scale=0.5)
    # the background direction 9 above the others, or every pixel is a DDM boundary
    standardize_classifier_(seg, img_t, 'dir', dgm.dir_conv, [9.0] + [0.0] * 8, scale=3.0)
    standardize_classifier_(seg, img_t, 'sem', dgm.mask_conv, [0.0] * CONIC_CLASSES + [-1.0])
    background_bias_(seg, img_t, 'sem', dgm.mask_conv, foreground, share=0.4)
    return seg, imgs


def cdnet_main_path(args):
    from tiseg_tpu_torch.apis import InferenceRunner
    from tiseg_tpu_torch.ops.instance_pp import instance_postprocess_sweep, instance_postprocess_vectorized_plain

    n_img, hw = CONIC_BATCH, CONIC_HW
    seg, imgs = cdnet_conic_seg(args)
    img_t = torch.from_numpy(imgs).cuda()
    runner = InferenceRunner(seg)
    counters = {'instance_postprocess_vectorized': (instance_postprocess_sweep, 'vectorized_launches'),
                'cluster route': (instance_postprocess_sweep, 'cluster_launches'),
                'global route': (instance_postprocess_sweep, 'global_launches')}
    out, (sem_pred,), launches, peak_gib = drive_once(runner, seg, '_device_instance_pp', imgs, hw, counters,
                                                      expect={'global route': 0})

    want = instance_postprocess_vectorized_plain(sem_pred, CONIC_RADIUS, 5, CONIC_CLASSES)
    classes, n_inst, fg = check_instances('CDNet', out, want, n_img, hw, min_inst=100)
    fused = seg.inference(img_t)
    boundary = float((fused['sem'].argmax(-1) == CONIC_CLASSES).float().mean())
    if not (fused['sem'].shape == (n_img, hw, hw, CONIC_CLASSES + 1) and torch.isfinite(fused['sem']).all()
            and fused['dir_map'].shape == (n_img, hw, hw) and boundary > 0
            and len(torch.unique(fused['dir_map'])) >= 5):
        raise AssertionError(f'CDNet fused maps: shape {tuple(fused["sem"].shape)}, boundary share {boundary:.4f}, '
                             f'directions {torch.unique(fused["dir_map"]).tolist()}')
    print(f'CDNet main path: launches {launches}, classes {classes}, foreground {fg:.4f}, boundary class on '
          f'{boundary:.4f} of the fused argmax, {n_inst} instances in {n_img} images, equal to the plain '
          f'post-processing; peak memory {peak_gib:.3f} GiB', flush=True)

    device_pp = seg._device_instance_pp
    time_path('CDNet', runner, seg, imgs, hw, lambda: device_pp(seg._device_sem_pred(fused)), args.cd_patch_batch)
    name = 'instance_postprocess_vectorized'
    return {name: time_pp_main_path('CDNet', sem_pred, CONIC_RADIUS, CONIC_CLASSES, launches[name])}


def multi_task_path(args, config: str, n_img: int, timed: bool):
    """One multi-task segmentor (MultiTaskCDNet, MultiTaskUNet or
    MultiTaskCUNet) through InferenceRunner; returns the B6 numbers when
    ``timed``."""
    from tiseg_tpu_torch.apis import InferenceRunner
    from tiseg_tpu_torch.models import build_segmentor
    from tiseg_tpu_torch.ops.mt_instance_pp import _launch_global as mt_global
    from tiseg_tpu_torch.ops.mt_instance_pp import mt_instance_postprocess_plain, mt_instance_postprocess_sweep
    from tiseg_tpu_torch.utils import Config

    hw = CONIC_HW
    cfg = Config.fromfile(os.path.join(ROOT, config))
    cfg.model.test_cfg = dict(cfg.model.test_cfg, device_postprocess=True, patch_batch=args.cd_patch_batch)
    model = cfg.model.type
    print(f'{model} model: {config}, test_cfg {cfg.model.test_cfg}', flush=True)
    seg = build_segmentor(cfg.model, device='cuda', seed=args.seed)
    imgs = conic_images(args.seed + 13000, n_img, hw)
    img_t = torch.from_numpy(imgs).cuda()
    branches = seg.net.head.postprocess
    if model == 'MultiTaskCDNet':
        seed_head, seed_conv = 'tc', branches.tc_mask_conv
        standardize_classifier_(seg, img_t, 'point', branches.point_conv, [0.3], scale=0.5)
        standardize_classifier_(seg, img_t, 'dir', branches.dir_conv, [9.0] + [0.0] * 8, scale=3.0)
    else:
        seed_head, seed_conv = 'aux', branches.aux_mask_conv
    standardize_classifier_(seg, img_t, seed_head, seed_conv, [0.0, 0.0] if model == 'MultiTaskUNet' else [0.0, 0.0, 1.5])
    background_bias_(seg, img_t, seed_head, seed_conv, lambda p: p.argmax(-1) == 1, share=0.1)
    standardize_classifier_(seg, img_t, 'sem', branches.mask_conv, [0.0] * CONIC_CLASSES)
    background_bias_(seg, img_t, 'sem', branches.mask_conv, foreground, share=0.4)
    runner = InferenceRunner(seg)
    counters = {'mt_instance_postprocess_sweep': (mt_instance_postprocess_sweep, 'launches'),
                'cluster route': (mt_instance_postprocess_sweep, 'cluster_launches'),
                'global route': (mt_instance_postprocess_sweep, 'global_launches')}
    out, (sem_pred, seed), launches, peak_gib = drive_once(runner, seg, '_device_mt_instance_pp', imgs, hw, counters,
                                                           expect={'global route': 0})

    want = mt_instance_postprocess_plain(sem_pred, seed, CONIC_CLASSES, 5, ALIGN_TIME)
    classes, n_inst, fg = check_instances(model, out, want, n_img, hw, min_inst=100 if timed else 10)
    grown = int(((out['inst_pred'] > 0) & (seed == 0)).sum())
    seeds_inside = float((out['sem_pred'] > 0)[seed > 0].float().mean())
    fused = seg.inference(img_t)
    boundary = float((fused[seed_head].argmax(-1) == 2).float().mean())
    if grown < 1 or (model != 'MultiTaskUNet' and boundary == 0):
        raise AssertionError(f'{model}: growth claimed {grown} pixels, boundary class on {boundary:.4f}')
    print(f'{model} main path: launches {launches}, classes {classes}, canvas {fg:.4f}, seeds on '
          f'{float((seed > 0).float().mean()):.4f} of the pixels ({seeds_inside:.3f} of them inside the canvas), '
          f'boundary class on {boundary:.4f}, growth claimed {grown} pixels in '
          f'{growth_waves(seed, out["sem_pred"])} waves, {n_inst} instances in {n_img} images, equal to the plain '
          f'post-processing; peak memory {peak_gib:.3f} GiB', flush=True)
    if not timed:
        return {}

    def pp():
        sem = torch.argmax(fused['sem'], dim=-1).to(torch.int32)
        return seg._device_mt_instance_pp(sem, seg._device_seed_pred(fused))

    time_path(model, runner, seg, imgs, hw, pp, args.cd_patch_batch)
    name = 'mt_instance_postprocess_sweep'
    # the cluster route, the earlier chain, the cluster route again
    k_ms, earlier_ms, turns = time_in_turns(lambda: seg._device_mt_instance_pp(sem_pred, seed),
                                            lambda: mt_global(sem_pred, seed, CONIC_CLASSES, 5, ALIGN_TIME))
    seg._device_mt_instance_pp(sem_pred, seed)
    fn = mt_instance_postprocess_sweep
    budget, needed, ran = fn.last_waves
    route = list(fn.last_route)
    p_ms = cuda_ms(lambda: mt_instance_postprocess_plain(sem_pred, seed, CONIC_CLASSES, 5, ALIGN_TIME), reps=3,
                   warmup=1)
    b_ms, b_by = bound(name, sem_pred, growth_waves(seed, out['sem_pred']))
    print(f'{model} main-path kernel {name} {tuple(sem_pred.shape)}: {k_ms:.4f} ms (cluster route {turns[0]:.4f} / '
          f'{turns[1]:.4f}), earlier chain {earlier_ms:.4f} ms ({earlier_ms / k_ms:.2f}x), plain {p_ms:.2f} ms, bound '
          f'{b_ms * 1e3:.2f} us ({b_by}); route {route} (route, cluster size, shared bytes per block, clusters '
          f'resident); growth waves budget {budget}, needed {needed}, run {ran}', flush=True)
    return {name: dict(launches=launches[name], ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                       earlier_ms=earlier_ms, ms_turns=turns, plane_route=route, waves_budget=budget,
                       waves_needed=needed, waves_run=ran)}


# -- phase 7: UNet.postprocess under the three device routes ---------------------------
def unet_postprocess_routes(args):
    """16 images of 256^2 at CoNIC density through ``seg.inference`` once,
    then ``seg.postprocess`` per image with device_postprocess True (B1),
    'xla' (B3 on the route of fill_route, B2 twice on the route of
    ccl_route) and 'pallas-rounds' (B8b on its block route, B8a
    twice on its cluster route, the window count once; no global chain).
    The 'pallas-rounds' route and its kernels on the first image's planes
    are timed in turns against the earlier design (the global chains and
    the window count's tensor ops)."""
    from tiseg_tpu_torch.models import build_segmentor
    from tiseg_tpu_torch.ops.flood import ccl_sweep, fill_holes_sweep, fill_route
    from tiseg_tpu_torch.ops.instance_pp import instance_postprocess_plain, instance_postprocess_sweep
    from tiseg_tpu_torch.ops.rounds import (ccl_rounds, ccl_rounds_needed, ccl_rounds_plain, fill_holes_rounds,
                                            fill_holes_rounds_needed, fill_holes_rounds_plain,
                                            instance_postprocess_rounds_plain, small_component_mask,
                                            window_count_mask)
    from tiseg_tpu_torch.utils import Config

    n_img, hw = CONIC_BATCH, CONIC_HW
    cfg = Config.fromfile(os.path.join(ROOT, UNET_CONFIG))
    cfg.model.test_cfg = dict(cfg.model.test_cfg, patch_batch=args.patch_batch)
    seg = build_segmentor(cfg.model, device='cuda', seed=args.seed)
    imgs = conic_images(args.seed + 15000, n_img, hw)
    img_t = torch.from_numpy(imgs).cuda()
    logit = seg.forward_heads(img_t)['sem']
    bias = -float(torch.quantile((logit[..., 1] - logit[..., 0]).flatten()[::7], 0.6))
    with torch.no_grad():
        seg.net.head.postprocess.bias.copy_(torch.tensor([0.0, bias]))
    fused = seg.inference(img_t)['sem'].cpu().numpy()
    sem_pred = torch.from_numpy(fused.argmax(-1).astype(np.int32)).cuda()
    want = instance_postprocess_plain(sem_pred)  # the exact per-class function, plain
    # (wrapper, counter, launches per image): every counter the route must move, and those it must not; 'xla'
    # calls B3 and B2 per image, on the routes fill_route and ccl_route give a single plane
    fill_cluster = int(fill_route(1, hw, hw).route == 'cluster')
    routes = {True: [(instance_postprocess_sweep, 'launches', 1), (instance_postprocess_sweep, 'cluster_launches', 1),
                     (instance_postprocess_sweep, 'global_launches', 0)],
              'xla': [(fill_holes_sweep, 'launches', 1), (fill_holes_sweep, 'cluster_launches', fill_cluster),
                      (fill_holes_sweep, 'global_launches', 1 - fill_cluster), (ccl_sweep, 'launches', 2),
                      (ccl_sweep, 'cluster_launches', 0), (ccl_sweep, 'global_launches', 2)],
              'pallas-rounds': [(fill_holes_rounds, 'launches', 1), (fill_holes_rounds, 'block_launches', 1),
                                (fill_holes_rounds, 'global_launches', 0), (ccl_rounds, 'launches', 2),
                                (ccl_rounds, 'cluster_launches', 2), (ccl_rounds, 'global_launches', 0),
                                (window_count_mask, 'launches', 1)]}
    round_kernels = [(fn, c) for fn, c, _ in routes['pallas-rounds']]
    for fn, c in round_kernels:
        setattr(fn, c, 0)
    # the reference of 'pallas-rounds': the plain versions of the two propagation functions and of the window count
    rounds_ref = [instance_postprocess_rounds_plain(sem_pred[i]) for i in range(n_img)]
    if any(getattr(fn, c) for fn, c in round_kernels):
        raise AssertionError('instance_postprocess_rounds_plain launched a kernel')
    launches, n_inst = {}, 0
    for mode, counters in routes.items():
        seg.test_cfg['device_postprocess'] = mode
        seg.postprocess({'sem': fused[0]})  # warm-up
        for fn, c, _ in counters:
            setattr(fn, c, 0)
        outs = [seg.postprocess({'sem': fused[i]}) for i in range(n_img)]
        torch.cuda.synchronize()
        for fn, c, per_image in counters:
            if getattr(fn, c) != per_image * n_img:
                raise AssertionError(f'device_postprocess={mode!r}: {fn.__name__}.{c} = {getattr(fn, c)} for {n_img} '
                                     f'images, expected {per_image} per image')
            launches[f'{fn.__name__}.{c}'] = getattr(fn, c)
        for i, out in enumerate(outs):
            ref = (want[0][i], want[1][i]) if mode != 'pallas-rounds' else rounds_ref[i]
            if not (out['sem_pred'].dtype == np.uint8 and out['inst_pred'].dtype == np.int32
                    and np.array_equal(out['sem_pred'], ref[0].cpu().numpy())
                    and np.array_equal(out['inst_pred'], ref[1].cpu().numpy())):
                raise AssertionError(f'device_postprocess={mode!r}: image {i} differs from the plain version')
            if not np.array_equal(out['inst_pred'], want[1][i].cpu().numpy()):
                raise AssertionError(f'device_postprocess={mode!r}: image {i} differs from the exact instances')
        n_inst = sum(len(np.unique(o['inst_pred'])) - 1 for o in outs)
        per_image = [lambda i=i: seg.postprocess({'sem': fused[i]}) for i in range(n_img)]
        ms = statistics.median(wall_ms(f, reps=3) for f in per_image)
        extra = ''
        if mode == 'pallas-rounds':
            # in turns: the route, the earlier design on the same images, the route again
            earlier = statistics.median(wall_ms(lambda f=f: on_chain(f, window_ops=True), reps=3) for f in per_image)
            again = statistics.median(wall_ms(f, reps=3) for f in per_image)
            extra = (f'; readings {ms:.3f} and {again:.3f} in turns with the earlier design (global chains, window '
                     f'count as tensor ops) {earlier:.3f} ms ({earlier / ((ms + again) / 2):.2f}x)')
            ms = (ms + again) / 2
        print(f'UNet.postprocess device_postprocess={mode!r}: {ms:.3f} ms per {hw}^2 image (host argmax and copies '
              f'included; median over {n_img} images of the median of 3), counters '
              f'{ {f"{fn.__name__}.{c}": launches[f"{fn.__name__}.{c}"] for fn, c, _ in counters} } for {n_img} '
              f'images, equal to the plain version{extra}', flush=True)
    fg = float((sem_pred > 0).float().mean())
    if not (0.1 <= fg <= 0.6 and n_inst > n_img):
        raise AssertionError(f'degenerate planes: foreground {fg:.3f}, {n_inst} instances')
    print(f'UNet.postprocess routes: foreground {fg:.4f}, {n_inst} instances in {n_img} images, the three device '
          f'routes equal', flush=True)

    # B1 on the 256^2 planes of device_postprocess True, one image a call, in turns against the earlier chain
    time_pp_main_path('UNet.postprocess True', sem_pred[:1], 1, 2, launches['instance_postprocess_sweep.launches'])
    # the route's kernels on the planes it gave them for the first image, each in turns against its earlier chain
    mask = (sem_pred[:1] == 1).to(torch.int32)
    filled = fill_holes_rounds(mask).to(torch.int32)
    xla_plane = fill_holes_sweep(mask).to(torch.int32)
    PP_PLANES[f"UNet.postprocess 'xla' filled plane {tuple(xla_plane.shape)}"] = (xla_plane.cpu(), 2, 1)
    stats = {'ccl_sweep_xla': time_xla_kernel('ccl_sweep', xla_plane),
             'fill_holes_sweep_xla': time_xla_kernel('fill_holes_sweep', mask)}
    cc4 = ccl_rounds(filled, 128, 1)
    if not torch.equal(window_count_mask(cc4, 5), small_component_mask(cc4, 5)):
        raise AssertionError('window_count_mask differs from small_component_mask on the route\'s labels')
    w_ms, w_plain = time_in_turns(lambda: window_count_mask(cc4, 5), lambda: small_component_mask(cc4, 5))[:2]
    print(f'UNet.postprocess window count {tuple(cc4.shape)} (min_size 5, 81 window cells): kernel {w_ms:.4f} ms, '
          f'small_component_mask\'s ~400 tensor ops {w_plain:.4f} ms in turns ({w_plain / w_ms:.1f}x), '
          f'bit-exact', flush=True)
    for name, fn, kernel, plain, x, conn, budget, work in (
            ('fill_holes_rounds', fill_holes_rounds, lambda: fill_holes_rounds(mask),
             lambda: fill_holes_rounds_plain(mask > 0), mask, 1, 2 * hw, lambda: fill_holes_rounds_needed(mask > 0)),
            ('ccl_rounds', ccl_rounds, lambda: ccl_rounds(filled, 128, 1), lambda: ccl_rounds_plain(filled > 0, 128, 1),
             filled, 1, 128, lambda: ccl_rounds_needed(filled > 0, 128, 1))):
        if not torch.equal(kernel(), plain()):
            raise AssertionError(f'{name} differs from its plain version on the route\'s plane')
        route = fn.last_route
        counts = tuple(fn.last_rounds)
        waves = work()
        if counts != (budget, waves, min(waves + 1, budget)):
            raise AssertionError(f'{name}: the kernel counted {counts}, {waves} rounds change a pixel')
        k_ms, earlier_ms, readings = time_in_turns(kernel, lambda: on_chain(kernel))
        p_ms = cuda_ms(plain, reps=3, warmup=1)
        b_ms, b_by = bound(name, x, waves, 4 * conn)
        print(f'UNet.postprocess kernel {name} {tuple(x.shape)}: {route[0]} route {k_ms:.4f} ms (readings '
              f'{readings[0]:.4f}, {readings[1]:.4f}), earlier chain {earlier_ms:.4f} ms in turns '
              f'({earlier_ms / k_ms:.2f}x), plain {p_ms:.2f} ms, bound {b_ms * 1e3:.2f} us ({b_by}, '
              f'{b_ms / k_ms:.2%} of the route\'s time); rounds: budget {counts[0]}, needed {counts[1]}, run '
              f'{counts[2]} (the chain runs {budget})', flush=True)
        stats[name] = dict(launches=launches[f'{name}.launches'], ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                           earlier_ms=earlier_ms, ms_turns=readings, ratio=earlier_ms / k_ms, plane_route=list(route),
                           rounds_budget=counts[0], rounds_needed=counts[1], rounds_run=counts[2],
                           bound_share=b_ms / k_ms)
    return stats


def time_xla_kernel(name: str, x: torch.Tensor):
    """B2 or B3 as 'xla' calls it on one image: B2 4-connected on the
    filled 256^2 plane, B3 on the class mask. The earlier chain's and the
    cluster kernel's launches (1024 threads: one cluster is resident that
    way), the two sides of the single-plane choice of ccl_route and
    fill_route, in turns through their private launches (the wrapper's own
    work is the same on both); ms per call and device_ms per call. Returns
    the row of the route the wrapper takes and the other side's times."""
    from tiseg_tpu_torch.ops import flood
    if name == 'ccl_sweep':
        wrapper, route_of, want = flood.ccl_sweep, flood.ccl_route, flood.ccl_plain(x > 0, 1)
        call, chain, cluster = (lambda: flood.ccl_sweep(x, connectivity=1), lambda: flood._launch_global_ccl(x, 1),
                                lambda: flood._launch_cluster_ccl(x, 1))
    else:
        wrapper, route_of, want = flood.fill_holes_sweep, flood.fill_route, flood.fill_holes_plain(x > 0)
        call, chain, cluster = (lambda: flood.fill_holes_sweep(x), lambda: flood._launch_global_fill(x),
                                lambda: flood._launch_cluster_fill(x))
    if not torch.equal(call(), want):
        raise AssertionError(f"{name} differs from its plain version on the 'xla' route's plane")
    route = list(wrapper.last_route)
    if route[:3] != list(route_of(*x.shape)) or not (torch.equal(cluster(), want) and torch.equal(chain(), want)):
        raise AssertionError(f"'xla' plane: {name} took {route}, or a private launch differs from plain")
    taken, other = (cluster, chain) if route[0] == 'cluster' else (chain, cluster)
    k_ms, other_ms, turns = time_in_turns(taken, other)
    k_dev, other_dev = device_ms(taken), device_ms(other)
    other_name = 'chain' if route[0] == 'cluster' else 'cluster'
    print(f"UNet.postprocess 'xla' kernel {name} {tuple(x.shape)}: {route[0]} route {k_ms:.4f} ms (readings "
          f"{turns[0]:.4f}, {turns[1]:.4f}), {other_name} {other_ms:.4f} ms in turns ({other_ms / k_ms:.2f}x); "
          f"device {k_dev * 1e3:.2f} us per call against {other_dev * 1e3:.2f} (L2 flushed); route {route}",
          flush=True)
    return {'ms': k_ms, f'{other_name}_ms': other_ms, 'ms_turns': turns, 'device_ms': k_dev,
            f'{other_name}_device_ms': other_dev, 'plane_route': route}


# -- phase 8: CUNet through the executor -------------------------------------------------
def cunet_path(args):
    """Two images through InferenceRunner: executor on, boundary class
    stripped, radius 3, B1. Checked against the unfolded net and the plain
    post-processor; not timed."""
    from tiseg_tpu_torch.apis import InferenceRunner
    from tiseg_tpu_torch.models import build_segmentor
    from tiseg_tpu_torch.ops.instance_pp import instance_postprocess_plain, instance_postprocess_sweep
    from tiseg_tpu_torch.utils import Config

    n_img, hw = 2, CONIC_HW
    cfg = Config.fromfile(os.path.join(ROOT, CUNET_CONFIG))
    cfg.model.test_cfg = dict(cfg.model.test_cfg, device_postprocess=True, patch_batch=args.cd_patch_batch)
    print(f'CUNet model: {CUNET_CONFIG}, test_cfg {cfg.model.test_cfg}', flush=True)
    seg = build_segmentor(cfg.model, device='cuda', seed=args.seed)
    nc = seg.num_classes
    imgs = conic_images(args.seed + 17000, n_img, hw)
    img_t = torch.from_numpy(imgs).cuda()
    cls = seg.net.head.postprocess
    standardize_classifier_(seg, img_t, 'sem', cls, [0.0] * nc + [-1.0])  # the boundary class 1 below, as CDNet's
    background_bias_(seg, img_t, 'sem', cls, lambda p: (p.argmax(-1) > 0) & (p.argmax(-1) < nc), share=0.3)
    counters = {'instance_postprocess_sweep': (instance_postprocess_sweep, 'launches'),
                'cluster route': (instance_postprocess_sweep, 'cluster_launches'),
                'global route': (instance_postprocess_sweep, 'global_launches')}
    out, (sem_pred,), launches, peak_gib = drive_once(InferenceRunner(seg), seg, '_device_instance_pp', imgs, hw,
                                                      counters, expect={'global route': 0})
    want = instance_postprocess_plain(sem_pred, radius=3, num_classes=nc)
    if not (torch.equal(out['sem_pred'], want[0]) and torch.equal(out['inst_pred'], want[1])
            and out['inst_pred'].shape == (n_img, hw, hw)):
        raise AssertionError('CUNet: main-path instances differ from the plain post-processor')
    fused = seg.inference(img_t)['sem']
    seg.test_cfg['fast_eval'] = False
    unfolded = seg.inference(img_t)['sem']
    diff = float((fused - unfolded).abs().max())
    boundary = float((fused.argmax(-1) == nc).float().mean())
    n_inst = sum(len(torch.unique(out['inst_pred'][b])) - 1 for b in range(n_img))
    if not (fused.shape == (n_img, hw, hw, nc + 1) and diff <= 1e-4 and boundary > 0 and n_inst > n_img
            and int(out['sem_pred'].max()) < nc):
        raise AssertionError(f'CUNet: executor vs unfolded net {diff:.3e}, boundary class on {boundary:.4f}, '
                             f'{n_inst} instances, sem_pred up to {int(out["sem_pred"].max())}')
    print(f'CUNet main path: launches {launches}, executor within {diff:.3e} of the unfolded net (bound 1e-4), '
          f'boundary class on {boundary:.4f} of the fused argmax and stripped, {n_inst} instances in {n_img} images, '
          f'equal to the plain post-processor; peak memory {peak_gib:.3f} GiB', flush=True)


# -- phase 9: B9 against its library call, and its wrapper's host time ------------------
def stencil_call_unbound(x: torch.Tensor) -> torch.Tensor:
    """B9's call path before the bind-once helper, kept to time the
    wrapper against: argument types set, a device guard entered and a
    Stream object built on every call."""
    import ctypes
    from tiseg_tpu_torch.ops import _build
    if x.dim() not in (2, 3) or x.dtype not in (torch.int32, torch.float32) or x.numel() > 2 ** 31 - 1:
        raise ValueError('stencil_call_unbound: bad plane')
    x = x.contiguous()
    H, W = x.shape[-2:]
    lib = _build.load('tiseg_stencil')
    lib.tiseg_neighborhood_3x3.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.tiseg_neighborhood_3x3.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        out = torch.empty_like(x)
        err = lib.tiseg_neighborhood_3x3(x.data_ptr(), out.data_ptr(), x.numel() // max(H * W, 1), H, W,
                                         int(x.dtype == torch.float32), 0,
                                         torch.cuda.current_stream(x.device).cuda_stream)
    _build.raise_on_error(lib, err, 'neighborhood_3x3')
    return out


def stencil_yardstick(case_sets, timed, dist_row):
    """B9's row: DIST's main path (``dist_row``: its launches, one per reconstruction iteration, and B9 (min) on
    DIST's float32 16 x 256^2 seed plane beside F.max_pool2d on the negated plane), and, as ``max_*``, B9 (max)
    and F.max_pool2d(3, 1, 1) on the same float32 16 x 256^2 plane with negative values as earlier rows measured
    it: ms per call (host time included), device_ms per launch, beside a copy of the plane (the same bytes read and
    written: what a launch of this size costs at the least); the wrapper's host time now and with the call path
    before the bind-once helper."""
    from tiseg_tpu_torch.ops.stencil import neighborhood_3x3
    plane = case_sets['conic16x256'][2]['neighborhood_3x3 max float32'][2]
    pool = lambda: torch.nn.functional.max_pool2d(plane[:, None], 3, 1, 1)  # noqa: E731
    kern = lambda: neighborhood_3x3(plane)  # noqa: E731
    if not torch.equal(pool()[:, 0], kern()):
        raise AssertionError('neighborhood_3x3 differs from F.max_pool2d(3, 1, 1) on the float32 plane')
    out = dict(timed[('neighborhood_3x3 max float32', 'conic16x256')],
               ms_int32=timed[('neighborhood_3x3 max int32', 'conic16x256')]['ms'])
    out.update(ms=cuda_ms(kern, reps=25), library_ms=cuda_ms(pool, reps=25), device_ms=device_ms(kern),
               library_device_ms=device_ms(pool), copy_device_ms=device_ms(plane.clone), host_us=host_us(kern),
               host_us_unbound=host_us(lambda: stencil_call_unbound(plane)))
    print(f'neighborhood_3x3 max on the float32 16 x 256^2 plane: {out["ms"]:.4f} ms '
          f'per call, {out["device_ms"] * 1e3:.2f} us per launch (L2 flushed), bound {out["bound_ms"] * 1e3:.2f} us; '
          f'F.max_pool2d(3, 1, 1) {out["library_ms"]:.4f} ms, {out["library_device_ms"] * 1e3:.2f} us; a copy of the '
          f'plane (the same bytes moved) {out["copy_device_ms"] * 1e3:.2f} us per launch; int32 plane '
          f'{out["ms_int32"]:.4f} ms; wrapper host time {out["host_us"]:.2f} us per call ({out["host_us_unbound"]:.2f} us '
          f'with the entry point set up on every call; 1000 calls, one synchronize)', flush=True)
    print(f'neighborhood_3x3 min on DIST\'s seed plane {dist_row["plane"]} ({dist_row["launches"]} launches on DIST\'s '
          f'main path): {dist_row["ms"]:.4f} ms per call, {dist_row["device_ms"] * 1e3:.2f} us per launch (L2 '
          f'flushed), bound {dist_row["bound_ms"] * 1e3:.2f} us; F.max_pool2d(3, 1, 1) on the negated plane '
          f'{dist_row["library_ms"]:.4f} ms, {dist_row["library_device_ms"] * 1e3:.2f} us; a copy '
          f'{dist_row["copy_device_ms"] * 1e3:.2f} us', flush=True)
    return dict(dist_row, **{f'max_{k}': v for k, v in out.items()})


DP_RANKS = 2  # two gloo ranks sharing the card: NCCL refuses two ranks on one device
DP_BATCH = 8  # the recipe's samples_per_gpu as the global batch: 4 per rank
DP_CHECK_HW, DP_TIMED_HW = 128, 256  # the float64 checks; the float32 timing
DP_WARMUP, DP_TIMED = 2, 5  # float32 steps before timing, then timed
DP_TOL = dict(logs=1e-10, displacement=1e-7, stats=1e-9)  # tests/test_torch_ddp_step.py's tolerances
DP_F32_LOSS_RTOL = 1e-5  # the float32 first step's loss, two ranks against one: sums in another order
DP_HOVER_TILES, DP_HOVER_SCALES = 4, (0.5, 2)


def dp_state_diff(got: dict, want: dict, start: dict) -> dict:
    """Each parameter's largest error over its largest displacement and each
    BN statistic's largest relative error, where they pass DP_TOL's bounds:
    the entries outside them (empty when all hold)."""
    bad = {}
    for name, w in want.items():
        if name.endswith('num_batches_tracked'):
            continue
        g = got[name].double()
        if name.endswith(('running_mean', 'running_var')):
            err = float(((g - w.double()).abs() / w.double().abs().clamp_min(1e-300)).max())
            if err > DP_TOL['stats']:
                bad[name] = err
        else:
            moved, err = float((w.double() - start[name].double()).abs().max()), float((g - w.double()).abs().max())
            if err > DP_TOL['displacement'] * moved and not moved == err == 0:
                bad[name] = (err, moved)
    return bad


def dp_logs_diff(got: list, want: list) -> dict:
    return {(t, k): (got[t].get(k), x) for t, logs in enumerate(want) for k, x in logs.items()
            if k not in got[t] or abs(got[t][k] - x) > DP_TOL['logs'] * abs(x)}


def dp_rank(rank: int, init_file: str, jobs_file: str, out_file: str) -> None:
    """One of the DP_RANKS ranks sharing cuda:0 (spawned): the float64 check
    cases, the float32 steps timed, and its share of the eval hook."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(DP_RANKS), LOCAL_RANK=str(rank))
    sys.path[:0] = [ROOT, os.path.join(ROOT, 'tests')]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    import torch_ddp_worker
    from tiseg_tpu_torch import parallel
    from tiseg_tpu_torch.apis import build_train_state, gather_object_shards, multi_process_test
    from tiseg_tpu_torch.datasets import build_dataset
    from tiseg_tpu_torch.engine import make_train_step
    from tiseg_tpu_torch.models import build_segmentor
    from tiseg_tpu_torch.utils import Config
    parallel.init_distributed(backend='gloo', init_method=f'file://{init_file}', device='cuda:0')
    try:
        jobs = torch.load(jobs_file, weights_only=False)
        out = {'checks': {name: torch_ddp_worker.run_case(case, 'cuda:0') for name, case in jobs['checks'].items()}}

        # float32 steps on this rank's rows of one global batch: ms per step (CUDA events; each step waits for the
        # other rank in its collectives) and the collectives of a step
        timed = jobs['timed']
        cfg = Config.fromfile(os.path.join(ROOT, UNET_CONFIG))
        seg = build_segmentor(cfg.model, device='cuda', seed=timed['seed'])
        state = build_train_state(seg, cfg, iters_per_epoch=1, seed=timed['seed'])
        step = make_train_step(seg, group=torch.distributed.group.WORLD)
        batch = torch_ddp_worker.batch_to(torch_ddp_worker.rows(timed['batch'], rank, DP_RANKS), 'cuda',
                                          torch.float32)
        events, counts, losses = [], [], []
        for i in range(DP_WARMUP + DP_TIMED):
            parallel.data.COUNTS.update(collectives=0, bytes=0)
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            state, logs = step(state, batch)
            b.record()
            events.append((a, b))
            counts.append(dict(parallel.data.COUNTS))
            losses.append(logs['loss'])
        torch.cuda.synchronize()
        out['timed'] = {'ms': [a.elapsed_time(b) for a, b in events[DP_WARMUP:]], 'counts': counts[-1],
                        'loss': float(losses[0])}
        del state, step, seg, batch
        torch.cuda.empty_cache()

        # the eval hook's share: multi_process_test + gather_object_shards, B1's launches on this rank
        ev = jobs['eval']
        seg = build_segmentor(ev['model'], device='cuda')
        seg.net.load_state_dict(ev['state'])
        ds = build_dataset(ev['dataset'], default_args=dict(test_mode=True))
        counters = b1_counters()
        zero_counts(counters)
        shard = multi_process_test(seg, ds)
        torch.cuda.synchronize()
        out['eval'] = {'shard': shard, 'merged': gather_object_shards(shard), 'b1': read_counts(counters)}
        torch.save(out, out_file)
    finally:
        torch.distributed.destroy_process_group()


def dp_spawn(jobs: dict, tmp: str, timeout: float = 300):
    """The DP_RANKS ranks of ``dp_rank`` on ``jobs``; their outputs, in rank
    order. Raises if a rank fails or outlives ``timeout``."""
    import multiprocessing
    jobs_file, init = os.path.join(tmp, 'jobs.pt'), os.path.join(tmp, 'init')
    torch.save(jobs, jobs_file)
    outs = [os.path.join(tmp, f'rank{r}.pt') for r in range(DP_RANKS)]
    ctx = multiprocessing.get_context('spawn')
    procs = [ctx.Process(target=dp_rank, args=(r, init, jobs_file, outs[r])) for r in range(DP_RANKS)]
    for p in procs:
        p.start()
    deadline = time.perf_counter() + timeout
    try:
        for p in procs:
            p.join(max(deadline - time.perf_counter(), 1))
    finally:
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join()
    if alive or any(p.exitcode for p in procs):
        raise RuntimeError(f'data-parallel ranks: exit codes {[p.exitcode for p in procs]}'
                           + (f', {len(alive)} killed after {timeout} s' if alive else ''))
    return [torch.load(o, weights_only=False) for o in outs]


def dp_global_batch(seed: int, hw: int) -> dict:
    """DP_BATCH images of ``hw``^2 (numpy, float64) with the UNet recipe's labels and FullNet's
    ``sem_gt_w_bound`` (its recipe's BoundLabelMake)."""
    from tiseg_tpu_torch.datasets.ops import BoundLabelMake
    from tiseg_tpu_torch.datasets.synthetic import make_nuclei, nuclei_density
    batch = train_batch(seed, DP_BATCH, hw, 'cpu')
    out = {g: {k: v.numpy().astype(np.float64) if v.is_floating_point() else v.numpy() for k, v in batch[g].items()}
           for g in ('data', 'label')}
    bound = BoundLabelMake(edge_id=2, selem_radius=(0, 2))
    out['label']['sem_gt_w_bound'] = np.stack([
        bound({'inst_gt': inst, 'sem_gt': (inst > 0).astype(np.int32), 'seg_fields': []})['sem_gt_w_bound']
        for inst in (make_nuclei(seed + i, hw, nuclei_density(hw))[2] for i in range(DP_BATCH))]).astype(np.int32)
    return out


def same_tree(a, b) -> bool:
    """Nested dicts, lists and arrays equal entry for entry."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(same_tree(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return isinstance(b, (list, tuple)) and len(a) == len(b) and all(map(same_tree, a, b))
    return np.array_equal(np.asarray(a), np.asarray(b))


def data_parallel_path(args):
    """The data-parallel path on the card (``parallel/``, the global-batch BatchNorm, dropout, heads and labels,
    the gradient sum): DP_RANKS ``gloo`` ranks sharing the card against the one-rank step in this process
    (``dp_ranks_check``); the train CLI under ``torch.distributed.run`` on ``nccl`` (``dp_cli_check``);
    HoVer-Net's host route at ``scale_factor`` 0.5 and 2 (``dp_hover_scale``)."""
    numbers = dp_ranks_check(args)
    numbers['cli_s'] = dp_cli_check(args)
    numbers['hover_scale'] = dp_hover_scale(args)
    print(json.dumps({'data_parallel': numbers}), flush=True)


def dp_ranks_check(args) -> dict:
    """The float64 checks (UNet 2 steps, FullNet 1 step with dropout), the float32 steps timed and the sharded
    eval hook on DP_RANKS ranks sharing the card, against one rank in this process."""
    import shutil
    import tempfile
    sys.path.insert(0, os.path.join(ROOT, 'tests'))
    import torch_ddp_worker
    from tiseg_tpu_torch.apis import build_train_state, single_device_test
    from tiseg_tpu_torch.datasets import build_dataset
    from tiseg_tpu_torch.engine import make_train_step
    from tiseg_tpu_torch.models import build_segmentor
    from tiseg_tpu_torch.utils import Config

    card = card_line()
    cfg = Config.fromfile(os.path.join(ROOT, UNET_CONFIG))
    fullnet_cfg = Config.fromfile(os.path.join(ROOT, ZOO_CONFIG['FullNet']))
    optimizer = dict(cfg.optimizer)

    def check_case(model, seed, batches):
        seg = build_segmentor(model, device='cpu', seed=seed)
        seg.net.double()
        return dict(model=model, state=seg.net.state_dict(), batches=batches, optimizer=optimizer,
                    dtype=torch.float64)

    checks = {'UNet': check_case(cfg.model, args.seed + 40, [dp_global_batch(args.seed + 41000 + 10 * t, DP_CHECK_HW)
                                                           for t in range(2)]),
              'FullNet': check_case(fullnet_cfg.model, args.seed + 41, [dp_global_batch(args.seed + 41100, DP_CHECK_HW)])}
    timed_batch = dp_global_batch(args.seed + 41200, DP_TIMED_HW)
    timed = dict(seed=args.seed, batch=timed_batch)
    eval_seg, _ = unet_recipe_seg(args)
    eval_seg.test_cfg['device_metrics'] = True
    val_kw, _ = write_tiles('dp_w0_s0', range(args.seed + 42000, args.seed + 42000 + DP_RANKS), LOOP_HW, LOOP_NUCLEI)
    dataset = dict(val_kw, processes=cfg.data.test.processes)
    jobs = {'checks': checks, 'timed': timed,
            'eval': dict(model=dict(cfg.model, test_cfg=dict(eval_seg.test_cfg)), dataset=dataset,
                         state={k: v.cpu() for k, v in eval_seg.net.state_dict().items()})}

    # the one-rank references on the card, before the ranks start
    t0 = time.perf_counter()
    one = {name: torch_ddp_worker.run_case(case, 'cuda') for name, case in checks.items()}
    val_ds = build_dataset(dataset, default_args=dict(test_mode=True))
    counters = b1_counters()
    zero_counts(counters)
    one_eval = single_device_test(eval_seg, val_ds, progress=False)
    one_b1 = read_counts(counters)
    seg = build_segmentor(cfg.model, device='cuda', seed=args.seed)
    state, step = build_train_state(seg, cfg, iters_per_epoch=1, seed=args.seed), make_train_step(seg)
    batch = torch_ddp_worker.batch_to(timed_batch, 'cuda', torch.float32)
    events, losses = [], []
    for i in range(DP_WARMUP + DP_TIMED):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        state, logs = step(state, batch)
        b.record()
        events.append((a, b))
        losses.append(logs['loss'])
    torch.cuda.synchronize()
    one_ms = [a.elapsed_time(b) for a, b in events[DP_WARMUP:]]
    one_loss = float(losses[0])
    del state, step, seg, batch, eval_seg
    torch.cuda.empty_cache()
    refs_s = time.perf_counter() - t0

    os.makedirs(os.path.join(ROOT, 'build', 'dev'), exist_ok=True)
    tmp = tempfile.mkdtemp(dir=os.path.join(ROOT, 'build', 'dev'))
    t0 = time.perf_counter()
    try:
        ranks = dp_spawn(jobs, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ranks_s = time.perf_counter() - t0

    # float64 checks: rank 0 against the one-rank step; both ranks hold one state
    for name, want in one.items():
        got = [r['checks'][name] for r in ranks]
        state_bad = dp_state_diff(got[0]['state'], want['state'], checks[name]['state'])
        logs_bad = dp_logs_diff(got[0]['logs'], want['logs'])
        same = all(torch.equal(got[0]['state'][k], got[1]['state'][k]) for k in got[0]['state'])
        worst = max(((float((got[0]['state'][k].double() - w.double()).abs().max()), k)
                     for k, w in want['state'].items() if not k.endswith('num_batches_tracked')))
        print(f'data parallel, {name} float64 ({DP_RANKS} gloo ranks on cuda:0, global batch {DP_BATCH} x '
              f'{DP_CHECK_HW}^2, {len(want["logs"])} step(s)): losses {[l["loss"] for l in got[0]["logs"]]} against one '
              f'rank {[l["loss"] for l in want["logs"]]}; largest entry error {worst[0]:.3e} ({worst[1]}); outside the '
              f'bounds {DP_TOL}: logs {logs_bad}, state {list(state_bad.items())[:5]}; ranks bit-equal {same}; '
              f'collectives per step {got[0]["collectives"][-1]}', flush=True)
        if state_bad or logs_bad or not same:
            raise AssertionError(f'data parallel, {name}: the {DP_RANKS}-rank step differs from the one-rank step')

    # the sharded eval hook: every rank merged both shares; equal to the one-rank loop by image name, exactly
    merged = [{p['name']: p for p in r['eval']['merged']} for r in ranks]
    want = {p['name']: p for p in one_eval}
    shards = [[p['name'] for p in r['eval']['shard']] for r in ranks]
    b1 = [r['eval']['b1'] for r in ranks]
    same_eval = all(same_tree(m, want) for m in merged)
    print(f'data parallel, eval hook ({DP_RANKS} ranks, {len(want)} val tiles of {LOOP_HW}^2): shares {shards}; merged '
          f'packages equal the one-rank loop by name: {same_eval}; B1 launches per rank {b1} (one rank over both tiles: '
          f'{one_b1})', flush=True)
    if not same_eval or any(c != B1_STRIP_LAUNCHES for c in b1) or sorted(sum(shards, [])) != sorted(want):
        raise AssertionError('data parallel: the sharded eval hook differs from the one-rank loop')

    # float32 timing: two ranks sharing one card measure the collectives' overhead, not a speed-up
    rank_ms = [statistics.median(r['timed']['ms']) for r in ranks]
    counts = ranks[0]['timed']['counts']
    n_params = sum(v.numel() for k, v in checks['UNet']['state'].items() if not k.endswith(('running_mean',
                   'running_var', 'num_batches_tracked')))
    loss_rel = abs(ranks[0]['timed']['loss'] - one_loss) / abs(one_loss)
    print(f'data parallel numbers ({card}; UNet float32, global batch {DP_BATCH} x {DP_TIMED_HW}^2, {DP_TIMED} steps '
          f'after {DP_WARMUP}): ms per step, {DP_RANKS} gloo ranks sharing the card (4 images each) {rank_ms} (each '
          f'{[round(ms, 2) for ms in ranks[0]["timed"]["ms"]]}), one rank on the whole batch '
          f'{statistics.median(one_ms):.2f}: this is the collectives\' overhead of two ranks on one card, not a '
          f'speed-up; collectives per step {counts["collectives"]}, bytes reduced per step {counts["bytes"]} '
          f'({n_params} parameters in the net); the first step\'s loss relative to the one rank\'s {loss_rel:.2e}; '
          f'one-rank '
          f'references {refs_s:.1f} s, ranks {ranks_s:.1f} s', flush=True)
    if not np.isfinite(rank_ms).all() or counts['collectives'] < 1 or loss_rel > DP_F32_LOSS_RTOL:
        raise AssertionError('data parallel: the float32 steps')
    return {'rank_ms_per_step': rank_ms, 'one_rank_ms_per_step': statistics.median(one_ms),
            'collectives_per_step': counts['collectives'], 'bytes_reduced_per_step': counts['bytes']}


def dp_cli_check(args) -> float:
    """tools/train.py under torch.distributed.run on one rank (nccl) against the first epoch of
    ``train_cli_path``'s run on the same windows and seed (run that phase first); returns its seconds."""
    import shutil
    from tiseg_tpu_torch.utils import JsonlLogger
    work = os.path.join(ROOT, 'build', 'dev', 'dp_cli_train')
    shutil.rmtree(work, ignore_errors=True)
    data = [f'data.{split}.{k}={v}' for split, name in (('train', 'cli_w512_s256'), ('val', 'cli_w0_s0'))
            for k, v in (('data_root', os.path.join(DATA_DIR, name)), ('img_dir', ''), ('ann_dir', ''),
                         ('split', 'split.txt'))]
    options = [*data, 'evaluation.interval=1', 'checkpoint_config.interval=1', 'checkpoint_config.max_keep_ckpts=1',
               'log_config.interval=1', 'model.test_cfg.device_postprocess=True', 'model.test_cfg.device_metrics=True',
               f'model.test_cfg.patch_batch={args.patch_batch}', 'runner.max_epochs=1']
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, '-m', 'torch.distributed.run', '--standalone', '--nproc_per_node', '1', '-m',
                          'tiseg_tpu_torch.tools.train', UNET_CONFIG, '--work-dir', work, '--seed', str(args.seed),
                          '--options', *options], cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, NVIDIA_TF32_OVERRIDE='0'))  # TF32 off, as in this process
    cli_s = time.perf_counter() - t0
    if run.returncode != 0:
        raise AssertionError(f'torch.distributed.run tools/train.py: {run.stdout[-3000:]}{run.stderr[-3000:]}')
    group_line = [l for l in run.stdout.splitlines() if 'process group: ' in l]
    got = [r for r in JsonlLogger(os.path.join(work, 'log.jsonl')).read() if r['mode'] == 'train']
    first = [r for r in JsonlLogger(os.path.join(ROOT, 'build', 'dev', 'cli_train', 'log.jsonl')).read()
             if r['mode'] == 'train' and r['epoch'] == 1]
    rel = [abs(a['loss'] - b['loss']) / abs(b['loss']) for a, b in zip(got, first)]
    print(f'data parallel, torch.distributed.run --nproc_per_node 1 tools/train.py ({cli_s:.1f} s): '
          f'{group_line[-1].split(" - ")[-1] if group_line else "no process group line"}; losses '
          f'{[round(r["loss"], 5) for r in got]} against the non-distributed run\'s first epoch '
          f'{[round(r["loss"], 5) for r in first]}, largest relative difference {max(rel) if rel else None}', flush=True)
    if (not group_line or 'backend nccl, world size 1' not in group_line[-1] or len(got) != len(first) or not first
            or max(rel) > 2e-3):
        raise AssertionError('data parallel: the nccl train CLI run differs from the non-distributed one')
    return cli_s


def dp_hover_scale(args) -> dict:
    """HoVer-Net's host route at scale_factor 0.5 and 2 on DP_HOVER_TILES CoNIC tiles (the device route
    declines), beside the host route at 1; ms per tile."""
    card = card_line()
    seg, imgs = hovernet_conic_seg(args)
    fused = {k: v.cpu().numpy() for k, v in seg.inference(torch.from_numpy(imgs[:DP_HOVER_TILES]).cuda()).items()}
    seg.test_cfg['device_postprocess'] = False
    base = [seg.postprocess({k: v[i] for k, v in fused.items()})['inst_pred'] for i in range(DP_HOVER_TILES)]
    seg.test_cfg['device_postprocess'] = True
    per_scale = {}
    for scale in DP_HOVER_SCALES:
        seg.test_cfg['scale_factor'] = scale
        if seg.inference_and_postprocess(torch.from_numpy(imgs[:1]).cuda()) is not None:
            raise AssertionError(f'HoVer-Net at scale_factor {scale}: the device route took the call')
        t0 = time.perf_counter()
        out = [seg.postprocess({k: v[i] for k, v in fused.items()}) for i in range(DP_HOVER_TILES)]
        ms = (time.perf_counter() - t0) * 1e3 / DP_HOVER_TILES
        inst = [o['inst_pred'] for o in out]
        fg_iou = [float(((a > 0) & (b > 0)).sum() / max(((a > 0) | (b > 0)).sum(), 1)) for a, b in zip(inst, base)]
        per_scale[scale] = dict(ms_per_tile=ms, instances=[int(len(np.unique(a)) - 1) for a in inst],
                                foreground_iou_vs_scale1=fg_iou)
        if any(a.shape != (CONIC_HW, CONIC_HW) or a.dtype != np.int32 for a in inst) or not any(
                len(np.unique(a)) > 1 for a in inst):
            raise AssertionError(f'HoVer-Net at scale_factor {scale}: instances {per_scale[scale]}')
    print(f'data parallel, HoVer-Net host route ({card}; {DP_HOVER_TILES} CoNIC tiles of {CONIC_HW}^2, the host '
          f'route at scale_factor 1 beside): {per_scale}; instances at scale 1 '
          f'{[int(len(np.unique(a)) - 1) for a in base]}', flush=True)
    return {str(k): v for k, v in per_scale.items()}


# -- phase 11: the last modules ---------------------------------------------------------
LAST_WINDOWS = 8  # one batch of the recipe's samples_per_gpu
NEW_OPS = [dict(type='Resize', scale_factor=1.25, resize_mode='scale'), dict(type='RandomSparseRotate', prob=1.0),
           dict(type='RandomRotate', prob=1.0, degree=30), dict(type='RandomElasticDeform', prob=1.0),
           dict(type='AlbuColorJitter', prob=1.0)]  # every op draws and changes every sample
RESNET_HW, RESNET_RTOL = 256, 1e-4  # each stage within RESNET_RTOL of its largest magnitude, card against CPU
RESNETS = ('TorchResNet', 'ResNet18', 'ResNet34', 'ResNet50', 'ResNet101', 'DeeplabResNet50', 'DeeplabResNet101')


def last_modules_path(args) -> dict:
    """The five new transforms feeding a train step, the inference CLI on a port checkpoint, the seven ResNets
    and the two timing tools (phase 11 of the module docstring). Returns B1's launches on the CLI's path."""
    import io
    from PIL import Image
    from tiseg_tpu_torch.apis import build_train_state
    from tiseg_tpu_torch.datasets import build_dataloader, build_dataset, collate, sample_seed
    from tiseg_tpu_torch.datasets.synthetic import make_nuclei
    from tiseg_tpu_torch.engine import make_train_step
    from tiseg_tpu_torch.models import build_backbone, build_segmentor
    from tiseg_tpu_torch.models.segmentors.base import BaseSegmentor
    from tiseg_tpu_torch.ops.instance_pp import instance_postprocess_plain
    from tiseg_tpu_torch.tools import get_flops, get_inf_time, inference
    from tiseg_tpu_torch.utils import Config

    # part 1: the new transforms through the loader into a train step
    t0 = time.perf_counter()
    cfg = Config.fromfile(os.path.join(ROOT, UNET_CONFIG))
    kw, _ = write_tiles('last_w512', range(args.seed + 70000, args.seed + 70000 + LAST_WINDOWS), WINDOW_HW,
                        WINDOW_NUCLEI)
    processes = list(cfg.data.train.processes)
    crop = next(i for i, p in enumerate(processes) if p['type'] == 'RandomCrop')
    processes = processes[:crop] + NEW_OPS + processes[crop:]
    ds = build_dataset(dict(kw, processes=processes))
    loader = build_dataloader(ds, samples_per_gpu=cfg.data.samples_per_gpu, workers_per_gpu=cfg.data.workers_per_gpu,
                              seed=args.seed)
    t1 = time.perf_counter()
    batch = next(iter(loader))
    loader_s = time.perf_counter() - t1
    want = collate([ds.sample(int(i), sample_seed(args.seed, 0, int(i))) for i in loader.batches()[0]])
    same = all(np.array_equal(batch[g][k], want[g][k]) for g in ('data', 'label') for k in want[g])
    shapes = {f'{g}/{k}': tuple(v.shape) for g in ('data', 'label') for k, v in batch[g].items()}
    if not (same and shapes['data/img'] == (8, 256, 256, 3)):
        raise AssertionError(f'last modules, train: loader batch equal to the mapper: {same}; {shapes}')
    seg = build_segmentor(cfg.model, device='cuda', seed=args.seed)
    state = build_train_state(seg, cfg, iters_per_epoch=1, seed=args.seed)
    step = make_train_step(seg)
    staged = {g: {k: torch.from_numpy(v).cuda() for k, v in batch[g].items()} for g in ('data', 'label')}
    state, logs = step(state, staged)
    loss = float(logs['loss'])
    if not np.isfinite(loss):
        raise AssertionError(f'last modules, train: loss not finite {logs}')
    print(f'last modules, train: processes {[p["type"] for p in processes]}; the first loader batch ({shapes}) in '
          f'{loader_s:.2f} s, equal to the mapper on its indices and seeds; one float32 train step on the card, '
          f'loss {loss:.5f}; part 1 {time.perf_counter() - t0:.1f} s', flush=True)
    del seg, state, step, staged
    torch.cuda.empty_cache()

    # part 2: tools/inference.py on the train CLI's best checkpoint and a 1000^2 tile
    t0 = time.perf_counter()
    best = os.path.join(ROOT, 'build', 'dev', 'cli_train', 'checkpoints', 'best.pt')
    tile = os.path.join(DATA_DIR, 'inference_tile.png')
    Image.fromarray(np.round(make_nuclei(args.seed + 71000, UNET_HW, LOOP_NUCLEI)[0] * 255).astype(np.uint8)).save(tile)
    panel = os.path.join(DATA_DIR, 'inference_tile_panel.png')
    cli = [os.path.join(ROOT, UNET_CONFIG), best, tile, '--out', panel, '--device-postprocess']
    captured = []
    device_pp = BaseSegmentor._device_instance_pp

    def capturing_pp(self, sem_pred):
        captured.append(sem_pred)
        return device_pp(self, sem_pred)

    counters = b1_counters()
    BaseSegmentor._device_instance_pp = capturing_pp
    try:
        inference.main(cli)  # warm-up: the card's first convolutions of this shape
        zero_counts(counters)
        captured.clear()
        out = io.StringIO()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            pred = inference.main(cli)
        cli_s = time.perf_counter() - t1
        launches = read_counts(counters)
    finally:
        BaseSegmentor._device_instance_pp = device_pp
    line = out.getvalue().splitlines()[-1]
    if launches != B1_STRIP_LAUNCHES or len(captured) != 1:
        raise AssertionError(f'inference CLI: B1 launches {launches}, expected {B1_STRIP_LAUNCHES}; '
                             f'{len(captured)} post-processing calls')
    ps, pi = instance_postprocess_plain(captured[0])
    if not (np.array_equal(pred['sem_pred'], ps[0].cpu().numpy()) and np.array_equal(pred['inst_pred'],
                                                                                     pi[0].cpu().numpy())):
        raise AssertionError("inference CLI: instances differ from B1's plain version on the CLI's semantic map")
    with Image.open(panel) as im:
        panel_shape = (im.height, im.width, len(im.getbands()))
    if panel_shape != (UNET_HW, 3 * UNET_HW + 16, 3) or line != f'saved {panel}; instances: {pred["inst_pred"].max()}':
        raise AssertionError(f'inference CLI: panel {panel_shape}, last line {line!r}')
    print(f'last modules, inference CLI on {os.path.relpath(best, ROOT)} and a {UNET_HW}^2 tile: {line!r}; B1 '
          f'{launches}, instances equal to its plain version on the CLI\'s semantic map; panel {panel_shape}; '
          f'{cli_s:.3f} s per call (config, net build, checkpoint load, inference, panel); part 2 '
          f'{time.perf_counter() - t0:.1f} s', flush=True)

    # part 3: the seven ResNets, card against CPU
    t0 = time.perf_counter()
    x = torch.from_numpy(np.random.default_rng(args.seed).standard_normal((1, 3, RESNET_HW, RESNET_HW),
                                                                          dtype=np.float32))
    errs = {}
    for name in RESNETS:
        torch.manual_seed(args.seed)
        net = build_backbone(dict(type=name), device='cpu').eval()
        with torch.no_grad():
            want = net(x)
            got = net.cuda()(x.cuda())
        errs[name] = max(float((g.cpu() - w).abs().max() / w.abs().max()) for g, w in zip(got, want))
        if len(got) != 4 or errs[name] > RESNET_RTOL:
            raise AssertionError(f'{name}: {len(got)} stages, card against CPU {errs[name]:.2e} (bound {RESNET_RTOL})')
        del net, got
    print(f'last modules, ResNets at 1 x 3 x {RESNET_HW}^2, card against CPU (largest relative error per net, '
          f'bound {RESNET_RTOL}): {json.dumps(errs)}; part 3 {time.perf_counter() - t0:.1f} s', flush=True)
    torch.cuda.empty_cache()

    # part 4: the timing tools on the UNet recipe
    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        inf_s = get_inf_time.main([os.path.join(ROOT, UNET_CONFIG), '--batch', '8', '--iters', '20', '--shape',
                                   '256', '256', '--warmup', '5'])
        n_params, flops = get_flops.main([os.path.join(ROOT, UNET_CONFIG), '--shape', '256', '256'])
    lines = out.getvalue().splitlines()
    if not (lines[0].startswith('160 images in ') and len(lines) == 4 and n_params > 0 and flops > 0):
        raise AssertionError(f'timing tools: {lines}')
    print(f'last modules, tools/get_inf_time.py: {lines[0]!r}; tools/get_flops.py: {lines[1:]}; part 4 '
          f'{time.perf_counter() - t0:.1f} s', flush=True)
    print(json.dumps({'last_modules': {'train_loss': loss, 'loader_first_batch_s': loader_s, 'inference_cli_s': cli_s,
                                       'inference_cli_b1': launches, 'resnet_card_vs_cpu': errs,
                                       'get_inf_time_img_per_s': 160 / inf_s, 'get_inf_time_s': inf_s,
                                       'params': n_params, 'gflops_256': flops / 1e9}}), flush=True)
    return {'inference_cli_launches': launches['launches']}

# -- phase 12: the compute dtype, bfloat16 eval and training ------------------------------------
# a bf16 head of a net against its float32 head on the same weights and input, in units of the float32 head's
# largest value: tests/test_torch_bf16_zoo.py's bound (2.8 % seen on the CPU at 64^2)
BF16_EVAL_BOUND = 0.06
# the share of the bf16 UNet's sem_pred equal to the float32 executor's on the 1000^2 image: the seeded net's bias
# sits at the 60th percentile of its logit margin, so many pixels are near-ties (98.76-98.77% seen in the first run)
BF16_SEM_PRED_SHARE = 0.97
BF16_TRAIN = (  # (name, MoNuSeg recipe, batch of 256^2): the recipes' samples_per_gpu, as their float32 phases
    ('UNet', UNET_CONFIG, TRAIN_BATCH),
    ('HoverNet', ZOO_CONFIG['HoverNet'], 8),
    ('DIST', DIST_MONUSEG_CONFIG, 16),
)
# a BN-fed convolution of the bf16 step (models/nn.py:_ConvIntoNorm): its float32 sums against a float64
# convolution of the same bf16 operands, in units of the largest output; a bf16 step is 2^-8 of a value
BF16_DIAG_PAIRS = 4  # bf16 steps timed with the garbage collector on and off, in turns
BF16_DIAG_TOP = 4  # the host operators listed from a profiled bf16 step
BF16_CONV_PROBE = (8, 128, 128)  # batch, channels in and out, side: UNet's second stage at 256^2 crops
BF16_CONV_TOL = 2.0 ** -12
BF16_EVAL_NETS = ('CUNet', 'CDNet', 'MultiTaskUNet', 'MultiTaskCUNet', 'MultiTaskCDNet', 'HoverNet', 'DCAN',
                  'FullNet', 'UNetS2D', 'DIST', 'MicroNet', 'CMicroNet')
BF16_EVAL_IMAGES = 2


def bf16_train_batch(name: str, seed: int, n: int, hw: int) -> dict:
    """``n`` synthetic nuclei images at MoNuSeg density with the labels ``name``'s loss reads: UNet's of
    ``train_batch``, HoVer-Net's ``sem_gt`` and HVLabelMake's ``hv_gt``, DIST's ``sem_gt`` of BoundLabelMake
    (edge 2) and DistanceLabelMake's ``dist_gt`` (its recipe's label makers), on the card."""
    from tiseg_tpu_torch.datasets.ops import BoundLabelMake, DistanceLabelMake, HVLabelMake
    from tiseg_tpu_torch.datasets.synthetic import make_nuclei, nuclei_density
    if name == 'UNet':
        return train_batch(seed, n, hw, 'cuda')
    imgs, labels = [], collections.defaultdict(list)
    for i in range(n):
        img, _, inst = make_nuclei(seed + i, hw, nuclei_density(hw))
        data = {'inst_gt': inst, 'sem_gt': (inst > 0).astype(np.int32), 'seg_fields': []}
        if name == 'HoverNet':
            labels['sem_gt'].append(data['sem_gt'])
            labels['hv_gt'].append(HVLabelMake()(data)['hv_gt'].astype(np.float32))
        else:
            data = DistanceLabelMake(inst_norm=False)(BoundLabelMake(edge_id=2, selem_radius=(2, 2))(data))
            labels['sem_gt'].append(data['sem_gt'].astype(np.int32))
            labels['dist_gt'].append(data['dist_gt'].astype(np.float32))
        imgs.append(img)
    return {'data': {'img': torch.from_numpy(np.stack(imgs)).cuda()},
            'label': {k: torch.from_numpy(np.stack(v)).cuda() for k, v in labels.items()}}


def bf16_unet_eval(args) -> dict:
    """The UNet / MoNuSeg cell of ``unet_main_path`` (its weights, its 1000^2 image, split 256/40 windows x 8
    views, device_postprocess) with dtype=torch.bfloat16 through InferenceRunner: the executor, then the executor
    with TISEG_FUSED_TAIL=1 (B10 in its bf16 mode), each with the counts read from that run alone; B1 bit for
    bit against its plain version on the bf16 run's plane, B10's first launch within its bf16 tolerance of its
    plain version on the same inputs, timed with its bound and the unfused bf16 tail; the share of sem_pred
    equal to the float32 executor's, instances, e2e ms and peak memory beside the float32 executor's."""
    from tiseg_tpu_torch.apis import InferenceRunner
    from tiseg_tpu_torch.models import build_segmentor
    from tiseg_tpu_torch.ops import fused_decode
    from tiseg_tpu_torch.ops.fused_decode import fused_decode0_cls, fused_decode0_cls_plain
    from tiseg_tpu_torch.ops.instance_pp import instance_postprocess_plain
    from tiseg_tpu_torch.utils import Config

    hw = UNET_HW
    seg32, img = unet_recipe_seg(args)
    cfg = Config.fromfile(os.path.join(ROOT, UNET_CONFIG))
    cfg.model.test_cfg = dict(seg32.test_cfg)
    seg16 = build_segmentor(cfg.model, device='cuda', seed=args.seed, dtype=torch.bfloat16)
    seg16.net.load_state_dict(seg32.net.state_dict())
    counters = {**b1_counters(), 'fused_decode0_cls': (fused_decode0_cls, 'launches')}
    captured = {}
    launch_fused = fused_decode._launch_cuda

    def capturing_launch(*call_args):
        captured.setdefault('fused_args', call_args)
        return launch_fused(*call_args)

    runs = {}
    for name, seg, fused_tail in (('float32 executor', seg32, False), ('bf16 executor', seg16, False),
                                  ('bf16 executor + fused tail', seg16, True)):
        runner = InferenceRunner(seg)
        device_pp = seg._device_instance_pp

        def capturing_pp(sem_pred, pp=device_pp):
            captured['sem_pred'] = sem_pred
            return pp(sem_pred)

        os.environ['TISEG_FUSED_TAIL'] = '1' if fused_tail else '0'
        try:
            runner.dispatch(img, (hw, hw))  # warm-up: the card's first convolutions of these shapes
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            captured.clear()
            seg._device_instance_pp, fused_decode._launch_cuda = capturing_pp, capturing_launch
            zero_counts(counters)
            out = runner.dispatch(img, (hw, hw))
            torch.cuda.synchronize()
            launches = read_counts(counters)
            seg._device_instance_pp, fused_decode._launch_cuda = device_pp, launch_fused
            peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
            e2e_ms = wall_ms(lambda: runner.dispatch(img, (hw, hw)), reps=5)
        finally:
            seg._device_instance_pp, fused_decode._launch_cuda = device_pp, launch_fused
            os.environ.pop('TISEG_FUSED_TAIL', None)
        n_forwards = -(-200 // args.patch_batch)
        want = dict(B1_STRIP_LAUNCHES, fused_decode0_cls=n_forwards if fused_tail else 0)
        if launches != want:
            raise AssertionError(f'UNet {name}: launches {launches}, expected {want}')
        sem_pred, sem_out, inst_out = captured['sem_pred'], out['sem_pred'], out['inst_pred']
        ps, pi = instance_postprocess_plain(sem_pred)
        if not (torch.equal(sem_out, ps) and torch.equal(inst_out, pi)):
            raise AssertionError(f'UNet {name}: B1 differs from its plain version on the main-path plane')
        n_inst = len(torch.unique(inst_out)) - 1
        fg = float((sem_pred > 0).float().mean())
        if not (0.1 <= fg <= 0.5 and n_inst > 0):
            raise AssertionError(f'UNet {name}: degenerate plane, foreground {fg:.3f}, {n_inst} instances')
        runs[name] = dict(sem_pred=sem_pred, launches=launches, instances=n_inst, foreground=fg, e2e_ms=e2e_ms,
                          peak_gib=peak_gib, fused_args=captured.get('fused_args'))
        print(f'bf16 path, UNet {name}: launches {launches}, foreground {fg:.4f}, {n_inst} instances, B1 equal to its '
              f'plain version; e2e {e2e_ms:.2f} ms per {hw}^2 image (median of 5, patch_batch {args.patch_batch}), '
              f'peak memory {peak_gib:.3f} GiB', flush=True)
    ref = runs['float32 executor']['sem_pred']
    for name in ('bf16 executor', 'bf16 executor + fused tail'):
        runs[name]['sem_pred_equal_to_float32'] = float((runs[name]['sem_pred'] == ref).float().mean())
    if not all(runs[n]['sem_pred_equal_to_float32'] >= BF16_SEM_PRED_SHARE
               for n in ('bf16 executor', 'bf16 executor + fused tail')):
        raise AssertionError(f'bf16 path: sem_pred equal to the float32 route on '
                             f'{[runs[n]["sem_pred_equal_to_float32"] for n in runs if "bf16" in n]} of the pixels')

    # B10 in bf16 on the first patch batch of the main path
    x, z, *weights, dtype = runs['bf16 executor + fused tail']['fused_args']
    if dtype != torch.bfloat16 or x.dtype != torch.bfloat16:
        raise AssertionError(f'B10 on the bf16 path ran in {dtype} on {x.dtype} inputs')
    with torch.inference_mode():
        got = fused_decode0_cls(x, z, *weights, dtype=dtype)
        torch.cuda.synchronize()
        want = fused_decode0_cls_plain(x, z, *weights, dtype=dtype)
    top = float(want.float().abs().max())
    err = float((got.float() - want.float()).abs().max())
    tol = max(0.15, BF16_STEPS * 2.0 ** -8 * top)
    if err > tol:
        raise AssertionError(f'B10 bf16 on the main path: max |kernel - plain| {err:.3e} > {tol:.3e}')
    print(f'bf16 path, B10 on the first main-path patch batch: max |kernel - plain| {err:.3e} (tolerance {tol:.3e}, '
          f'largest logit {top:.3f})', flush=True)
    _, fp = last_stage(seg16)
    b10 = dict(launches=runs['bf16 executor + fused tail']['launches']['fused_decode0_cls'], max_abs_err=err,
               **time_fused_decode('UNet bf16 main path', x, z, weights, fp, reps=10, dtype=dtype))
    b1 = runs['bf16 executor + fused tail']['launches']['launches'] + runs['bf16 executor']['launches']['launches']
    summary = {n: {k: v for k, v in r.items() if k not in ('sem_pred', 'fused_args')} for n, r in runs.items()}
    del seg32, seg16, runs, captured, x, z, weights
    return {'unet_eval': summary, 'b10': b10, 'b1_launches': b1}


def bf16_train_row(args, name: str, config: str, n: int, dtype: torch.dtype) -> dict:
    """``name`` from its MoNuSeg recipe in ``dtype`` on a synthetic batch of ``n`` x 256^2 through
    build_train_state and make_train_step: TRAIN_WARMUP + TRAIN_TIMED steps, each timed on the host clock (to
    its synchronize) with the host's enqueue time (to the step's return) and the card's span (CUDA events
    around the step); ms per step, images/s, peak GiB; the losses finite, the parameters, optimizer moments and
    BN statistics float32 after the steps."""
    from tiseg_tpu_torch.apis import build_train_state
    from tiseg_tpu_torch.engine import make_train_step
    from tiseg_tpu_torch.models import build_segmentor
    from tiseg_tpu_torch.utils import Config
    cfg = Config.fromfile(os.path.join(ROOT, config))
    batch = bf16_train_batch(name, args.seed + 23000, n, TRAIN_HW)
    seg = build_segmentor(cfg.model, device='cuda', seed=args.seed, dtype=dtype)
    state = build_train_state(seg, cfg, iters_per_epoch=TRAIN_ITERS_PER_EPOCH, seed=args.seed)
    step = make_train_step(seg)
    for _ in range(TRAIN_WARMUP):
        state, logs = step(state, batch)
    first = float(logs['loss'])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, enqueue, spans = [], [], []
    for _ in range(TRAIN_TIMED):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        state, logs = step(state, batch)
        end.record()
        enqueue.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        spans.append(start.elapsed_time(end))
    last, ms = float(logs['loss']), statistics.median(times)
    floats = [t for t in (*seg.net.parameters(), *seg.net.buffers(),
                          *(v for s in state.tx.state.values() for v in s.values() if torch.is_tensor(v)))
              if t.is_floating_point()]
    if not (np.isfinite(first) and np.isfinite(last) and all(t.dtype == torch.float32 for t in floats)):
        raise AssertionError(f'{name} {dtype} train: losses {first} {last}, '
                             f'{sorted({str(t.dtype) for t in floats})} state')
    row = dict(config=config, batch=n, ms_per_step=ms, ms_min=min(times), ms_max=max(times),
               enqueue_ms=statistics.median(enqueue), device_span_ms=statistics.median(spans),
               images_per_s=n / ms * 1e3, peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30, loss_first=first,
               loss_last=last, steps=state.step)
    if dtype == torch.bfloat16:
        row.update(step_diagnosis(step, state, batch))
    del seg, state, step, batch
    torch.cuda.empty_cache()
    return row


def step_diagnosis(step, state, batch) -> dict:
    """Where a short step's time goes, after its timed steps: the Python heap's objects, BF16_DIAG_PAIRS pairs of
    steps with the garbage collector on and off in turns (after one gc.collect), the caching allocator's
    cudaMalloc calls over them, one step under torch.profiler tracing the card (its kernel time) and one tracing
    the host (its self time summed over the operators, and the BF16_DIAG_TOP operators that took most of it)."""
    import gc

    from torch.profiler import ProfilerActivity, profile
    gc.collect()
    mallocs = torch.cuda.memory_stats().get('num_device_alloc', 0)
    times = {True: [], False: []}
    for _ in range(BF16_DIAG_PAIRS):
        for enabled in (True, False):
            if not enabled:
                gc.disable()
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, _ = step(state, batch)
                torch.cuda.synchronize()
                times[enabled].append((time.perf_counter() - t0) * 1e3)
            finally:
                gc.enable()
    mallocs = torch.cuda.memory_stats().get('num_device_alloc', 0) - mallocs
    profiled = {}
    for activity in (ProfilerActivity.CUDA, ProfilerActivity.CPU):  # apart: tracing the host slows the card's work
        with profile(activities=[activity]) as prof:
            state, _ = step(state, batch)
            torch.cuda.synchronize()
        profiled[activity] = prof.key_averages()
    kernel_us = sum(getattr(e, 'self_device_time_total', 0) for e in profiled[ProfilerActivity.CUDA])
    host = sorted(((e.self_cpu_time_total, e.key, e.count) for e in profiled[ProfilerActivity.CPU]), reverse=True)
    return dict(heap_objects=len(gc.get_objects()), gc_on_ms=statistics.median(times[True]),
                gc_off_ms=statistics.median(times[False]), cuda_mallocs=mallocs, kernel_ms=kernel_us / 1e3,
                host_ops_ms=sum(t for t, _, _ in host) / 1e3,
                top_host_ops=[(name, round(t / 1e3, 3), n) for t, name, n in host[:BF16_DIAG_TOP]])


def bf16_train(args, float32_steps: dict) -> dict:
    """UNet, HoVer-Net and DIST from their MoNuSeg recipes in bfloat16 (bf16_train_row), each beside the
    float32 step of the same recipe and batch size that an earlier phase of this run timed
    (``float32_steps``: unet_train_path, zoo_train_path, family_train_path), with step_diagnosis: the bf16
    steps are short enough for the host to set their pace."""
    out = {}
    for name, config, n in BF16_TRAIN:
        f32 = float32_steps[name]
        if f32['batch'] != n:
            raise AssertionError(f'{name}: the float32 phase timed batches of {f32["batch"]}, this phase {n}')
        row = bf16_train_row(args, name, config, n, torch.bfloat16)
        out[name] = {'bfloat16': row, 'float32': {k: f32[k] for k in ('ms_per_step', 'images_per_s', 'peak_gib')},
                     'float32_over_bfloat16': f32['ms_per_step'] / row['ms_per_step']}
        print(f'bf16 path, {name} train bfloat16 ({config}, batch {n} x {TRAIN_HW}^2): {row["ms_per_step"]:.2f} ms '
              f'per step (median of {TRAIN_TIMED} after {TRAIN_WARMUP} warm-ups; min {row["ms_min"]:.2f}, max '
              f'{row["ms_max"]:.2f}; the host returns from the step after {row["enqueue_ms"]:.2f} ms, the card\'s '
              f'span {row["device_span_ms"]:.2f} ms), {row["images_per_s"]:.1f} images/s, peak memory '
              f'{row["peak_gib"]:.3f} GiB, loss {row["loss_first"]:.5f} -> {row["loss_last"]:.5f} (steps '
              f'{row["steps"]}); float32 in its phase {f32["ms_per_step"]:.2f} ms, {f32["images_per_s"]:.1f} '
              f'images/s, {f32["peak_gib"]:.3f} GiB: {out[name]["float32_over_bfloat16"]:.2f} x; then, with the '
              f'garbage collector on and off in turns, {row["gc_on_ms"]:.2f} and {row["gc_off_ms"]:.2f} ms per '
              f'step ({row["heap_objects"]} objects on the heap, {row["cuda_mallocs"]} cudaMalloc calls over '
              f'those steps); profiled steps: the card\'s kernels {row["kernel_ms"]:.2f} ms, the host\'s '
              f'operators {row["host_ops_ms"]:.2f} ms, most of it in {row["top_host_ops"]}', flush=True)
    return out


def bf16_conv_probe(args) -> dict:
    """One BN-fed convolution of the bf16 train step (models/nn.py:_ConvIntoNorm, 3x3 of BF16_CONV_PROBE) on
    the card: its float32 output against a float64 convolution of the same bf16 operands (the largest gap in
    units of the largest output, and the share of outputs equal to the float64 sum rounded to float32), beside
    the float32 convolution with TF32 off on the same operands; each timed, with the plain bf16 convolution
    (rounded output). Fails if the TF32 route's gap exceeds BF16_CONV_TOL."""
    import torch.nn.functional as F

    from tiseg_tpu_torch.models.nn import Conv2d, set_compute_dtype
    b, ch, hw = BF16_CONV_PROBE
    g = torch.Generator(device='cuda').manual_seed(args.seed + 25000)
    conv = Conv2d(ch, ch, 3, padding=1, bias=False, device='cuda', into_norm=True).requires_grad_(False)
    conv.weight.copy_(torch.randn(conv.weight.shape, device='cuda', generator=g) * (2.0 / (9 * ch)) ** 0.5)
    set_compute_dtype(conv, torch.bfloat16)
    x = torch.randn(b, ch, hw, hw, device='cuda', generator=g).to(torch.bfloat16)
    w = conv.weight.to(torch.bfloat16)
    routes = {'tf32_into_norm': lambda: conv(x), 'float32': lambda: F.conv2d(x.float(), w.float(), padding=1),
              'bf16': lambda: F.conv2d(x, w, padding=1)}
    with torch.no_grad():
        ref = F.conv2d(x.double(), w.double(), padding=1)
        scale = float(ref.abs().max())
        row = {}
        for name, fn in routes.items():
            y = fn()
            if name != 'bf16' and y.dtype != torch.float32:
                raise AssertionError(f'bf16 conv probe: {name} gave {y.dtype}')
            row[name] = dict(max_gap=float((y.double() - ref).abs().max()) / scale,
                             equal_share=float((y.float() == ref.float()).float().mean()), ms=wall_ms(fn, reps=10))
    if not row['tf32_into_norm']['max_gap'] <= BF16_CONV_TOL:
        raise AssertionError(f'bf16 conv probe: the TF32 route is {row["tf32_into_norm"]["max_gap"]:.3e} of the '
                             f'largest output from the float64 sums of the same operands (tolerance {BF16_CONV_TOL})')
    print(f'bf16 path, a BN-fed conv (3x3 {ch} -> {ch}, {b} x {hw}^2, bf16 operands) against float64 sums of the '
          f'same operands, gaps in units of the largest output: {json.dumps(row)}', flush=True)
    return row


def bf16_eval_nets(args) -> dict:
    """One eval batch (2 x 256^2; the MicroNets' 252^2) of every other segmentor in bfloat16 against the same
    seeded net in float32 on the card: each head within BF16_EVAL_BOUND of the float32 head's largest value."""
    from tiseg_tpu_torch.datasets.synthetic import make_nuclei, nuclei_density
    from tiseg_tpu_torch.models import build_segmentor
    out = {}
    for name in BF16_EVAL_NETS:
        hw = 252 if 'Micro' in name else TRAIN_HW
        img = torch.from_numpy(np.stack([make_nuclei(args.seed + 24000 + i, hw, nuclei_density(hw))[0]
                                         for i in range(BF16_EVAL_IMAGES)])).cuda()
        heads = {}
        for dtype in (torch.float32, torch.bfloat16):
            seg = build_segmentor(dict(type=name, num_classes=2, test_cfg=dict(mode='whole')), device='cuda',
                                  seed=args.seed, dtype=dtype)
            heads[dtype] = {k: v.float() for k, v in seg.forward_heads(img).items()}
            del seg
        errs = {k: float((heads[torch.bfloat16][k] - v).abs().max() / v.abs().max())
                for k, v in heads[torch.float32].items()}
        if not all(np.isfinite(e) and e <= BF16_EVAL_BOUND for e in errs.values()):
            raise AssertionError(f'bf16 path, {name} eval: heads against float32 {errs} (bound {BF16_EVAL_BOUND})')
        out[name] = errs
        torch.cuda.empty_cache()
    print(f'bf16 path, one eval batch of each other net against its float32 heads ({BF16_EVAL_IMAGES} x 256^2, the '
          f'MicroNets\' 252^2; bound {BF16_EVAL_BOUND} of the float32 head\'s largest value): {json.dumps(out)}',
          flush=True)
    return out


def bf16_path(args, float32_steps: dict) -> dict:
    """Phase 12 of the module docstring; ``float32_steps``: the float32 train steps of UNet, HoVer-Net and DIST
    from their phases of this run. Returns the kernels line's bf16 keys of B1 and B10."""
    card = card_line()
    t0 = time.perf_counter()
    ev = bf16_unet_eval(args)
    t1 = time.perf_counter()
    probe = bf16_conv_probe(args)
    train = bf16_train(args, float32_steps)
    t2 = time.perf_counter()
    nets = bf16_eval_nets(args)
    print(json.dumps({'bf16': {'card': card, 'unet_eval': ev['unet_eval'], 'conv_probe': probe, 'train': train,
                               'eval_nets': nets, 'b10': ev['b10']}}), flush=True)
    print(f'bf16 path ({card}): UNet eval {t1 - t0:.1f} s, train {t2 - t1:.1f} s, other nets '
          f'{time.perf_counter() - t2:.1f} s', flush=True)
    b10 = ev['b10']
    return {'instance_postprocess_sweep': {'bf16_launches': ev['b1_launches']},
            'fused_decode0_cls': {'bf16_launches': b10['launches'], 'bf16_max_abs_err': b10['max_abs_err'],
                                  **{f'bf16_{k}': b10[k] for k in ('ms', 'plain_ms', 'bound_ms', 'bound_by',
                                                                    'library_ms')}}}


SOURCES = {
    'instance_postprocess_sweep': ('tiseg_tpu_torch/csrc/instance_pp.cu', 'tiseg_tpu/ops/pallas_sweep.py:478'),
    'instance_postprocess_vectorized': ('tiseg_tpu_torch/csrc/instance_pp.cu', 'tiseg_tpu/ops/pallas_sweep.py:353'),
    'mt_instance_postprocess_sweep': ('tiseg_tpu_torch/csrc/mt_instance_pp.cu', 'tiseg_tpu/ops/pallas_sweep.py:561'),
    'ccl_sweep': ('tiseg_tpu_torch/csrc/flood.cu', 'tiseg_tpu/ops/pallas_sweep.py:619'),
    'size_filter': ('tiseg_tpu_torch/csrc/flood.cu', 'tiseg_tpu/ops/pallas_sweep.py:597'),
    'fill_holes_sweep': ('tiseg_tpu_torch/csrc/flood.cu', 'tiseg_tpu/ops/pallas_sweep.py:641'),
    'watershed': ('tiseg_tpu_torch/csrc/watershed.cu', 'tiseg_tpu/ops/pallas_postproc.py:173'),
    'ccl_rounds': ('tiseg_tpu_torch/csrc/rounds.cu', 'tiseg_tpu/ops/pallas_postproc.py:66'),
    'fill_holes_rounds': ('tiseg_tpu_torch/csrc/rounds.cu', 'tiseg_tpu/ops/pallas_postproc.py:107'),
    'neighborhood_3x3': ('tiseg_tpu_torch/csrc/stencil.cu', 'tiseg_tpu/ops/pallas_kernels.py:43'),
    'fused_decode0_cls': ('tiseg_tpu_torch/csrc/fused_decode.cu', 'tiseg_tpu/attic/pallas_decode.py:146'),
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--patch-batch', type=int, default=100, help='UNet patches per network forward')
    p.add_argument('--hover-patch-batch', type=int, default=32, help='HoVer-Net patches per network forward')
    p.add_argument('--cd-patch-batch', type=int, default=64,
                   help='CDNet and multi-task patches per network forward')
    p.add_argument('--save-pp-planes', help="save the main paths' planes of B1, B2 and B7 to this file")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from tiseg_tpu_torch.datasets.synthetic import (CONIC_NUCLEI_PER_PATCH, hard_planes, hard_planes_multiclass,
                                                    make_nuclei, multiclass_nuclei, spiral)
    from tiseg_tpu_torch.ops import _build
    from tiseg_tpu_torch.ops.flood import ccl_plain

    card = card_line()
    print(f'card: {card}; torch {torch.__version__}; CUDA {torch.version.cuda}; '
          f'{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}', flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print('TF32 off: torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False')
    t0 = time.perf_counter()
    reports = _build.build(verbose=True)
    print(f'built {sorted(_build.SOURCES.values())} in {time.perf_counter() - t0:.2f} s', flush=True)
    for name, kernel in (('tiseg_fused_decode', 'k_fused_decode'), ('tiseg_stencil', 'k_neighborhood'),
                         ('tiseg_ws', 'k_ws_cluster'), ('tiseg_mt_pp', 'k_mt_cluster'),
                         ('tiseg_pp', 'k_pp_cluster'), ('tiseg_pp', 'k_pp_strip'),
                         ('tiseg_rounds', 'k_fill_block'), ('tiseg_rounds', 'k_ccl_cluster'),
                         ('tiseg_rounds', 'k_window_count'), ('tiseg_flood', 'k_ccl_cluster'),
                         ('tiseg_flood', 'k_diamond_tile')):
        for entry, regs, spills in ptxas_report(reports.get(name, '')):
            if kernel in entry:
                what = ' (hole filling)' if name == 'tiseg_flood' and 'Lb1E' in entry else ''  # kFill = true
                print(f'ptxas {_build.SOURCES[name]} {entry}{what}: {regs} registers, {spills}', flush=True)

    # -- phase 2 ---------------------------------------------------------------
    def hard(hw):
        sem = hard_planes(hw)
        return sem, ccl_plain(torch.from_numpy(sem) > 0, 2).numpy()

    def nuclei(n, hw, seed):
        inst = np.stack([make_nuclei(seed + i, hw, CONIC_NUCLEI_PER_PATCH * hw * hw // 256 ** 2)[2]
                         for i in range(n)])
        return (inst > 0).astype(np.int32), inst

    def multiclass(n, hw, seed):
        planes = [multiclass_nuclei(seed + i, hw, CONIC_NUCLEI_PER_PATCH * hw * hw // 256 ** 2) for i in range(n)]
        return np.stack([p[0] for p in planes]), np.stack([p[1] for p in planes])

    t0 = time.perf_counter()
    case_sets, flood_sets = {}, {}
    for set_name, (sem, inst) in {'hard64': hard(64), 'hard256': hard(256), 'conic16x256': nuclei(16, 256, args.seed),
                                  'conic1000': nuclei(1, 1000, args.seed + 7000)}.items():
        x = flood_sets[set_name] = torch.from_numpy(sem).cuda()
        case_sets[set_name] = (x, None, kernel_cases(x, hover_inputs(inst, args.seed)))
    for set_name, (sem, seed) in {'7class-hard64': hard_planes_multiclass(64),
                                  '7class-hard256': hard_planes_multiclass(256),
                                  '7class-conic16x256': multiclass(16, 256, args.seed),
                                  '7class-conic1000': multiclass(1, 1000, args.seed + 7000)}.items():
        x, seed = torch.from_numpy(sem).cuda(), torch.from_numpy(seed).cuda()
        case_sets[set_name] = (x, seed, multiclass_kernel_cases(x, seed))
    # ragged planes for the cluster and block routes: H not a multiple of the cluster size, odd W, B = 17 and B = 1
    for shape in ((17, 101, 77), (1, 251, 243)):
        B, h, w = shape
        _, inst = nuclei(B, 256, args.seed + 9000)
        inst = np.ascontiguousarray(inst[:, :h, :w])
        ws_in = hover_inputs(inst, args.seed)
        cases = watershed_cases(ws_in)
        x = flood_sets[f'ragged{B}x{h}x{w}'] = torch.from_numpy((inst > 0).astype(np.int32)).cuda()
        cases.update(checked_only({**pp_cases(x), **round_cases(x)}))
        case_sets[f'ragged{B}x{h}x{w}'] = (ws_in[0], None, cases)
        sem, seed = (np.ascontiguousarray(a[:, :h, :w]) for a in multiclass(B, 256, args.seed + 9000))
        x, seed = torch.from_numpy(sem).cuda(), torch.from_numpy(seed).cuda()
        case_sets[f'7class-ragged{B}x{h}x{w}'] = (x, seed, checked_only({**vectorized_cases(x), **mt_cases(x, seed)}))
    # a 480^2 plane: the round kernels (B8b's block route, B8a's global chain) and B1 and B7 (strip route); the
    # round kernels at the round budget's boundary on a spiral (B8a's cluster and B8b's block route)
    x = flood_sets['conic480'] = torch.from_numpy(nuclei(1, 480, args.seed + 8000)[0]).cuda()
    case_sets['conic480'] = (x, None, checked_only({**pp_cases(x), **round_cases(x)}))
    x = torch.from_numpy(multiclass(1, 480, args.seed + 8000)[0]).cuda()
    case_sets['7class-conic480'] = (x, None, checked_only(vectorized_cases(x)))
    # batches of 1000^2 planes that B1's and B7's strips take in groups of planes, one launch per group
    x = torch.from_numpy(nuclei(3, 1000, args.seed + 7100)[0]).cuda()
    case_sets['conic3x1000'] = (x, None, checked_only(pp_cases(x)))
    x = torch.from_numpy(multiclass(2, 1000, args.seed + 7100)[0]).cuda()
    case_sets['7class-conic2x1000'] = (x, None, checked_only(vectorized_cases(x)))
    x = flood_sets['spiral64'] = torch.from_numpy(spiral(64)[None].astype(np.int32)).cuda()
    case_sets['spiral64'] = (x, None, round_boundary_cases(x))
    # a plane smaller than a radius-9 diamond: B4 masked, most blocks of B2's cluster hold no row
    flood_sets['small3x5x9'] = torch.from_numpy(
        (np.random.default_rng(args.seed).random((3, 5, 9)) < 0.6).astype(np.int32)).cuda()
    max_err, timed = check_kernels(case_sets)
    check_flood(flood_sets)
    check_round_budget(case_sets)
    max_err['fused_decode0_cls'] = check_fused_decode(args)
    print(f'kernel phase: {time.perf_counter() - t0:.1f} s', flush=True)

    # -- phases 3 and 4 ------------------------------------------------------------
    t0 = time.perf_counter()
    stats = unet_main_path(args)
    print(f'UNet phase: {time.perf_counter() - t0:.1f} s', flush=True)
    t0 = time.perf_counter()
    float32_steps = {'UNet': unet_train_path(args)}
    print(f'UNet train phase: {time.perf_counter() - t0:.1f} s', flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    unet_s2d_path(args)
    print(f'UNet-S2D phase: {time.perf_counter() - t0:.1f} s', flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dataset_paths(args)
    print(f'datasets phase: {time.perf_counter() - t0:.1f} s', flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train_cli_path(args)
    print(f'train CLI phase: {time.perf_counter() - t0:.1f} s', flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    float32_steps['DIST'] = family_train_path(args)['DIST']
    print(f'family train phase: {time.perf_counter() - t0:.1f} s', flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cdnet_cli_path(args)
    print(f'CDNet CLI phase: {time.perf_counter() - t0:.1f} s', flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    float32_steps['HoverNet'] = zoo_train_path(args)['HoverNet']
    print(f'zoo train phase: {time.perf_counter() - t0:.1f} s', flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    hovernet_cli_path(args)
    print(f'HoVer-Net CLI phase: {time.perf_counter() - t0:.1f} s', flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dcan_cli_path(args)
    print(f'DCAN CLI phase: {time.perf_counter() - t0:.1f} s', flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dist_cli_path(args)
    print(f'DIST CLI phase: {time.perf_counter() - t0:.1f} s', flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    stats.update(hover_main_path(args))
    print(f'HoVer-Net phase: {time.perf_counter() - t0:.1f} s', flush=True)
    torch.cuda.empty_cache()

    # -- phases 5 and 6 ------------------------------------------------------------
    t0 = time.perf_counter()
    stats.update(cdnet_main_path(args))
    print(f'CDNet phase: {time.perf_counter() - t0:.1f} s', flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    stats.update(multi_task_path(args, MT_CDNET_CONFIG, n_img=CONIC_BATCH, timed=True))
    print(f'MultiTaskCDNet phase: {time.perf_counter() - t0:.1f} s', flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    for config in (MT_UNET_CONFIG, MT_CUNET_CONFIG):
        multi_task_path(args, config, n_img=2, timed=False)
    print(f'MultiTaskUNet and MultiTaskCUNet phase: {time.perf_counter() - t0:.1f} s', flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    zoo_eval_path(args)
    print(f'zoo eval phase: {time.perf_counter() - t0:.1f} s', flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dist_rows = dist_eval_path(args)
    print(f'DIST eval phase: {time.perf_counter() - t0:.1f} s', flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    int8_eval_path(args)
    print(f'int8 eval phase: {time.perf_counter() - t0:.1f} s', flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    data_parallel_path(args)
    print(f'data-parallel phase: {time.perf_counter() - t0:.1f} s', flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    stats['instance_postprocess_sweep'].update(last_modules_path(args))
    print(f'last modules phase: {time.perf_counter() - t0:.1f} s', flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    for name, row in bf16_path(args, float32_steps).items():
        stats[name].update(row)
    print(f'bf16 phase: {time.perf_counter() - t0:.1f} s', flush=True)
    torch.cuda.empty_cache()

    # -- phases 7 and 8 ------------------------------------------------------------
    t0 = time.perf_counter()
    stats.update(unet_postprocess_routes(args))
    cunet_path(args)
    print(f'UNet.postprocess routes and CUNet phase: {time.perf_counter() - t0:.1f} s', flush=True)
    stats['neighborhood_3x3'] = stencil_yardstick(case_sets, timed, dist_rows['neighborhood_3x3'])
    for name in ('ccl_sweep', 'watershed'):
        stats[name].update({f'dist_{k}': v for k, v in dist_rows[name].items()})
    if args.save_pp_planes:
        os.makedirs(os.path.dirname(os.path.abspath(args.save_pp_planes)), exist_ok=True)
        torch.save(PP_PLANES, args.save_pp_planes)

    for name in ('ccl_sweep', 'fill_holes_sweep'):
        stats[name].update({f'xla_{k}': v for k, v in stats.pop(f'{name}_xla').items()})
    keys = ('launches', 'ms', 'plain_ms', 'bound_ms', 'bound_by')
    kernels = [dict(name=name, route='cuda', source=src, replaces=rep, max_abs_err=max_err[name],
                    **{k: stats[name][k] for k in keys}, library_ms=stats[name].get('library_ms'),
                    **{k: v for k, v in stats[name].items() if k not in keys and k != 'library_ms'})
               for name, (src, rep) in SOURCES.items()]
    print(json.dumps({'kernels': kernels}))
    print(card)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
