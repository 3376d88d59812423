#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/H100 port (transfer_em_tpu_torch).

    python3 chip_smoke.py [--out DIR] [--int8-only | --parallel-only |
                                       --examples-only | --wide-only |
                                       --benches-only]

``--out DIR`` also writes every JSON line (chip_smoke.jsonl) and the
compilers' output with ptxas register counts (chip_smoke_build.log) to DIR.
Needs one CUDA card and nvcc (CUDA toolkit under $CUDA_HOME or
/usr/local/cuda); imports nothing of JAX or of the JAX package.  Phases,
each printing one JSON line:

1. env      nvidia-smi name and power limit, torch/CUDA versions, TF32 off.
2. build    the kernels from transfer_em_tpu_torch/csrc/ with nvcc (sm_90a).
3. kernel   every kernel against its plain PyTorch version on the card at
            the main paths' shapes (wf=8, B=128 tiles of 74^3): conv3 in
            f32 and bf16, with and without the LeakyReLU epilogue, at the
            generator's 8 k3 layer shapes (each through the kernel its
            shape picks: tensor-core or direct) and at three more (wf=4
            and wf=16 widths, a ragged small shape), and in f32 at the
            discriminator's 4; preprocess, postprocess and LeakyReLU at
            theirs (LeakyReLU also at the discriminator's, at an odd length
            and on a misaligned view; postprocess also on its scalar path:
            odd tpad, OW % 4 != 0).  Times (CUDA events) of the kernel, the
            plain version and one library call, beside the card's bound;
            LeakyReLU's, preprocess's, postprocess's and their library
            calls' also from a CUDA graph replay (device time without the
            launches' host cost).  Each f32 conv3 with O <= 32 runs in the
            tensor-core kernel's kw form (``form``), beside it both forms'
            times with each launched straight, in turns (``kw_ms``,
            ``tap_ms``).  Then conv3 and LeakyReLU, checked only,
            at the train step's second-round batch (64 tiles), for both
            networks, every kernel on a strided view (a crop) against its
            plain version on the same view (``kernel_strided``), and the kw
            form's planted fault (``conv3_kw_fault``: the row shifted by
            two columns left out of the epilogue's sum, at each narrow
            generator layer, must miss conv3's f32 tolerance).
4. golden   the port's generator (kernels on) against the frozen TF output
            tests/goldens/gen_3d.npz, f32 and bf16, and the 3D
            discriminator against tests/goldens/disc_3d.npz: PSNR >= 40 dB.
5. serve    ModelService(device="cuda") on 127.0.0.1 with the batcher on,
            over a seeded wf=8 export and a seeded, smoothed 384^3 uint8
            volume: 6 chunk requests of 128^3 (5 of them concurrent, one on
            the volume's far edge), then the same five again under
            torch.profiler (device busy share, device time by kernel).
            The written blocks must match predict_tiled through the plain
            versions on the same card (f32) within one level on at most
            1e-3 of the voxels, and every kernel's launch count must have
            risen during the timed requests.
5b. serve_ng  which of tensorstore, requests, PIL and google.cloud.storage
            import here; serve's six requests again through ModelService
            from a .npy location (NumpyVolume) and, with tensorstore, from a
            file:// ng-precomputed copy (TensorstoreVolume, first read
            bit-equal to NumpyVolume at every tile corner), with each
            request's backend read seconds, block-write seconds and wall
            (timers of this script around ``read`` and
            ``model_service.write_ng_blocks``), the blocks held to serve's
            bar; predict_ng_cube over tensorstore and, with requests,
            through the port's DataService on 127.0.0.1 (in-process);
            TransferEMPredictor (base64) and NgOutputPredictor (local
            destination, blocks and info read back).  A sub-check whose
            package is missing is listed under ``not_run``.
6. volume   predict_volume at bench_infer.py's request (a 360^3 region at
            (20, 20, 20) of a seeded smoothed 400^3 volume, 1000 tiles),
            wf=8 seeded generator, f32, B=128: device (from the host
            array, its copies in z slabs through pinned slots; each call's
            slab counts equal to the schedule's, none copied whole, the
            pinned bytes held made once and bounded, its Mvox/s beside
            VOL_DEVICE_BEFORE_MVOX), slab (the volume uploaded once),
            stream (np.memmap source and out=, at a 160 MB
            budget, one chunk, at a 19 MB one, five chunks, and at the
            block of a 40-tile chunk, 30 chunks each at its own batch) and
            tiles,
            one warm and 3 timed calls each (wall, Mvox/s, tiles/s, peak
            memory, launches) and one call under torch.profiler.  Under
            cudnn.deterministic stream (each budget twice, its out= and
            pinned host blocks first filled with one of two sentinels),
            auto and tiles must equal device bit for bit; device and slab
            must be within one level on at most 1e-3 of the voxels of the
            same mode through the plain versions (slab against device is
            printed, not gated); bf16 device against f32 >= 40 dB, not
            equal to it, with every conv3 launch on bf16 operands, its
            weights packed on the first call only (6 packs, then 0) and its
            output bit-equal to a call with the pack cache cleared, its
            transposed and down convs on cuDNN's, none of its conv3
            launches in the kw form; device
            mode at the 40-tile chunks' batch bit-equal to B=128; every
            kernel call of one slab forward (conv3 at all 8 layers,
            down4 at both down convs, LeakyReLU at 2, after the up convs,
            preprocess, postprocess),
            recorded at its own shape, against its plain version, with
            times beside the bound; device mode at B = 64, 128, 256 over
            the volume on the card (used in place: no slab uploaded); every
            kernel must launch in every mode, every f32 mode's narrow k3
            layers in conv3's kw form (``conv3_tc_kw`` above 0, by mode in
            the line), its transposed convs as the phase conv and its down
            convs on the down4 kernel (none on cuDNN's), with no weight
            packed after its warm call.
7. train_check  one CycleGAN train step (wf=8, B=4, dropout off) through
            the kernels and one through the plain versions on the card, from
            the same state: 7-loss vectors within rtol 1e-4, every
            parameter's gradient within GRAD_TOL of its own largest |g|;
            beside them the plain step's own spread under 1e-5 forward
            noise (3 seeds) and what three planted faults in conv3's
            backward read, each of which must exceed GRAD_TOL in every
            network.
8. train    create_state + make_train_step at the default CycleGANConfig
            (3D, wf=8, 74^3, f32, B=64, dropout on): 5 steps (finite losses,
            all four networks updated, conv3 tc/direct, LeakyReLU and
            weight-pack counts per step equal to those derived from the
            networks), median step time of steps 2-5, tiles/s, peak memory,
            then one step under torch.profiler (busy share, device time by
            kernel and by launching op).
9. em2em    the training entry point as a user runs it (the README quick
            start in 3D): datasets from 64 seeded 74^3 cubes of a smoothed
            256^3 uint8 volume (target; source through make_warp_map) and a
            streaming dataset over corner_stream, one epoch of each timed
            alone; EM2EM(74, wf=8) trains 2 epochs at B=16 (f32, dropout
            on; per-epoch seconds and tiles/s from the metrics log, peak
            memory, launch and pack counts per step against those derived
            from the networks, finite losses, all four networks updated);
            a second EM2EM of the same experiment auto-restores epoch 2
            bit-equal and trains a third epoch on fixed batches, which the
            first model also takes uninterrupted: under cuDNN's
            deterministic algorithms the two end bit-equal; restore(1) into
            the first model, whose conv3 weights are packed, then predict
            must repack
            and match a fresh model restored at 1 bit for bit; save_model
            from epoch 3 -> load_generator -> predict_tiled on a 128^3
            chunk within one grey level on at most 1e-3 of the voxels of
            the plain versions.  All four kernels must launch in the phase.
10. twod    the 2D CycleGAN (wf=8, 74^2 -> 40^2, f32), whose convs all run
            on cuDNN as JAX keeps them on XLA: preprocess (B=128, 74^2),
            postprocess on a rank-4 (128, 40, 40, 1) batch at tpad 2 and 0
            and on the scalar path, LeakyReLU at the 2D generator's 11
            activations (B=128, summed), each against its plain version
            and timed beside the bound and the library call; the 2D
            generator and discriminator against gen_2d.npz / disc_2d.npz
            (PSNR >= 40 dB, LeakyReLU launching, conv3 not); one 2D train
            step through the kernels against one through the plain
            versions (rtol 1e-4, GRAD_TOL); then, counted, the README
            quick start in 2D: EM2EM(74, is3d=False, wf=8) on 256 seeded
            74^2 patches of a smoothed 1024^2 image (source through
            make_warp_map) trains 2 epochs at B=64 (per-epoch seconds,
            tiles/s, peak memory, launch counts per step), an auto-restored
            model trains a third epoch bit-equal to the uninterrupted one
            under cudnn.deterministic, and save_model(is3d=False) ->
            load_generator -> make_tile_step over 128 tiles with tpad 2
            comes within one grey level on at most 1e-3 of the pixels of
            the plain versions.  preprocess, postprocess and LeakyReLU must
            launch, conv3 must not.
11. train_bf16  bf16 training and the training opt-ins: conv3's backward
            on bf16 operands at the train step's 12 k3 shapes (B=128) by
            the port's engine (cuDNN's f32 engines on the bf16 values, TF32
            allowed, rounded), cuDNN's bf16 engines and its FP32 engines,
            timed and held against the float64 gradients (the port's must
            stay within BWD_MAX_STEPS and be the fastest); conv3 and
            LeakyReLU in bf16 at those shapes against their plain versions,
            timed by events and graph replay beside the bound and the
            library call; conv3's output and gradients at those shapes
            against the exact function rounded once (BF16_MISS_TOL), beside
            the plain version and three planted faults of rounding size; a
            bf16 step (wf=8, B=4, dropout off, cudnn.deterministic) through
            the kernels against the plain versions, each network's L2
            gradient gap within BF16_GRAD_TOL, beside the noise floor and
            planted faults, and again with ``use_norm`` and its tile step
            (``use_norm_bfloat16``: the losses within BF16_LOSS_RTOL and
            one level on at most 1e-3 of the voxels against the plain step
            on the kernels' conv3 roundings wherever those are correct,
            none that is not, a planted dropped tap flagged, and the plain
            step on its own roundings and its noise floor read beside);
            5 bf16 steps at B=64 as in phase 8 (every conv3
            and LeakyReLU launch on bf16); remat on and off in f32 and bf16
            at B=64 (seconds, peak memory, bit-equal under
            cudnn.deterministic with dropout on); make_scan_train_step
            (window 2) bit-equal to two sequential steps; ensemble_apps
            against batched_apps in f32 (GRAD_TOL) and bf16
            (BF16_GRAD_TOL); then, counted, the bf16 quick start:
            EM2EM(74, wf=8, compute_dtype="bfloat16") in 3D at B=16 and in
            2D at B=64, 2 epochs of 4 steps each, an auto-restored third
            epoch bit-equal to the uninterrupted one, save_model ->
            load_generator -> make_tile_step within one grey level on at
            most 1e-3 of the voxels of the plain versions.  Every kernel,
            conv3 and LeakyReLU on bf16 among them, must launch.
12. int8    the int8 serving opt-in (UNetGenerator(int8_conv=True)) and
            the phase-decomposed transposed conv: at every conv of the
            int8 generator, 3D and 2D, wf=8 at B=128 and wf=1 (64-256
            channels) at B=4, the quantize kernel against its plain
            version on the activation a forward gives it (codes and
            scale bit-equal) and conv_int8 against its plain version (the
            exact integer conv in float64) on the codes (int32
            accumulators and dequantized outputs bit-equal), times beside
            the bounds (bytes, or int8 operations at 1,979 TOPS); three
            planted faults of the quantize kernel (built with
            -DTEM_QUANT_FAULT: roundf, a reciprocal product, the max of
            half the tensor) each breaking its equality on those
            activations or two tie-rich ones; the port's int8 convs (k3
            with its epilogue, k4 stride-2, transposed, one with an odd
            Cout; f32 and bf16 out; N(0, 1) and tie-rich inputs)
            bit-equal to an independent float64 reference, and each of
            three planted faults (roundf quantization, one weight scale
            per tensor, a dropped tap) breaking that equality; the
            shapes the port once refused (``c12``: SAME at stride 2 and
            3, transposed at k1, k2, k3, k5 stride 2, 3D and 2D, f32 and
            bf16 out), through the phase plan, bit-equal to an
            independent float64 reference and to the plain versions on
            the CPU, each launching both kernels once; the int8
            goldens (PSNR >= 40 dB, the card's output within 1e-5 of the
            CPU's); the transposed conv's phase form on conv3
            (phase_decompose=True, the default of an f32 inference call)
            against cuDNN's (False), TF32 off, at up1.up / up0.up (B=128),
            the slab's B=1 up0.up and wf=1's two up convs (B=16), f32 (at
            conv3's f32 tolerance) and bf16, both timed; the k4 stride-2
            down conv on the down4 kernel (the default of an f32
            inference call) against its plain version, TF32 off, at
            conv3's f32 tolerance, at down1.down / down2.down /
            disc.down1.down (B=128) and wf=1's two down convs (B=16),
            timed beside its bound, its plain version and F.conv3d,
            bf16's default cuDNN (the slab's B=1 planes are checked in
            the volume phase at their own shapes); with
            TensorFlow, a Keras .h5 -> load_generator -> make_tile_step
            round trip (else listed under ``not_run``); then, counted,
            the int8 tile step (make_tile_step, tpad 2) against f32 and
            bf16 of the same weights at wf=8 B=128, wf=1 B=4 and B=16:
            ms a batch, Mvox/s, peak memory, within one level on at most
            1e-3 of the voxels of the int8 step through the plain
            versions, int8 against f32 (read), one profiled batch in
            which no PyTorch op quantizes or pads an activation.
            quantize_int8, conv_int8, preprocess, postprocess and
            LeakyReLU must launch, conv3 must not.  ``--int8-only``
            builds the kernels and runs this phase alone (its two
            entries of the kernels line).
14. parallel  data and halo parallelism (run after int8) on meshes whose
            positions take the visible cards in turn (``_cards``:
            ``[cuda:0] * k`` on one card): under cudnn.deterministic,
            predict_tiled on a 128^3 chunk, ModelService serving it, and
            predict_volume at the volume phase's 360^3 request in device
            and stream mode, each on a data=2 mesh bit-equal to the
            unmeshed call at the same batch a device, Mvox/s beside it;
            halo_predict in f32 over 4 shards (z over 4 on a 160x234x234
            input, z x y over 2 x 2 on 80x80x234), each shard bit-equal
            to the generator on its block of the padded volume, and at
            the JAX tests' N(0, 0.02) init within their bar (rtol 1e-4,
            atol 1e-5) of one pass over the padded volume, whose gap at
            the fan-in-scaled weights is printed; make_dp_train_step on 2
            positions at global B=16 against make_train_step at B=16 from
            the same state: dropout off, losses rtol 1e-4 and every
            reduced gradient within GRAD_TOL; dropout on, losses rtol
            1e-4; a second DP step packs each card's weights once;
            EM2EM(74, wf=8).to_mesh trains 4 steps at B=16 and its
            checkpoint restores bit-equal into an unmeshed model;
            EM2EM(74, is3d=False, wf=8, disc_prior=p).to_mesh, each
            disc_y replica's prior on its own device, 2 steps against
            the unmeshed model (losses rtol 1e-4, gradients GRAD_TOL); worker
            processes of this script (``--parallel-worker``): two on one
            card over gloo, else one a card over NCCL, a DP step on their
            rows against the single-process step and a halo ring across
            the process boundaries; one NCCL rank (world size 1) running
            a DP step; with two or more cards, device-mode Mvox/s and DP
            tiles/s on 1, 2 and every card.  The counts are zeroed just
            before each meshed call and read just after it (every
            unmeshed reference outside), summed per path: tile and volume
            must launch all four kernels, halo and DP conv3 and
            LeakyReLU; each worker's DP steps and ring the same two.
            ``--parallel-only`` builds the kernels and runs this phase
            alone (no kernels line).
15. examples  the user recipes of examples/torch/ on the card, each in a
            temporary directory at wf=8 (cloudrun_test_3d keeps its
            wf=32) with few epochs: run_local_predict (a seeded EM2EM's
            checkpoint -> save_model -> load_generator -> predict_tiled
            at 72^3, within one level on at most 1e-3 of the voxels of
            the same recipe with device="cpu"), simple_training_2d (2
            epochs), generator_training_3d (two smoothed 256^3 volumes
            behind an in-process DataService, 1 epoch of 8 tiles at B=4,
            bfloat16), streaming_training_3d_local (2 epochs of 16
            tiles), cloudrun_test_3d (its overlap-stitching assert),
            run_cloud_predict_service and multichip_inference (every
            visible card, or this card four times over: the DP step, DP
            tiled inference equal to one device, halo inference within
            the JAX recipe's bar); migrate_tf_assets (TF interop, held
            on the CPU) is listed as not run.  The counts are zeroed just
            before each recipe's main and read just after it: the 3D
            inference recipes and multichip_inference must launch all
            four kernels, the 3D training recipes conv3 and LeakyReLU,
            simple_training_2d LeakyReLU.  One line a recipe (wall
            seconds of its main, launches, ok), the recipes' own prints
            under --out as examples_<name>.log.  ``--examples-only``
            builds the kernels and runs this phase alone.
16. wide    the model at its full widths (wf=1, 64-256 channels), every
            k3 shape from the wf=1 networks' own forward: conv3 in f32 and
            bf16, with and without the epilogue, at the generator's 8 k3
            layers (B=16, the wf=1 tile step's batch) and the
            discriminator's 4 (B=16, the train step's first round at
            B=8), against its plain version at phase 3's tolerances,
            timed beside the bound and F.conv3d (+ F.leaky_relu), each
            layer's plan printed (tensor-core channel blocks and output
            chunks, blockIdx.y > 0; the direct kernel's O > 8 splits);
            tensors past 2^31 elements (the stem, LeakyReLU and down1.conv
            at B=128, f32) against their plain versions slice by slice;
            preprocess, postprocess and LeakyReLU (f32, bf16) at the
            B=16 tile step's shapes; one f32 train step at wf=1 (B=2,
            dropout off) through the kernels against the plain versions
            (as phase 7: losses rtol 1e-4, GRAD_TOL, noise floor, planted
            faults) and one bf16 step (as phase 11's check,
            BF16_GRAD_TOL); bench.train.measure at bench_wf1.py's first
            three configs in bf16 (B=8, B=8 remat, B=16 accum=2) and f32
            B=4 (steps 2-5 timed, tiles/s, peak memory, the step's FLOPs
            and share of peak; one bf16 and one f32 step profiled);
            EM2EM(74, wf=1) 2 steps -> checkpoint -> save_model ->
            load_generator -> ModelService at its default batch (16), three
            128^3 chunks within one level on at most 1e-3 of the voxels of
            predict_tiled through the plain versions; bench.infer.measure
            over a seeded 220^3 volume (a 180^3 request): bf16 device mode
            at B = 8, 16, 32 and slab, then f32 device mode against the
            plain versions (one level, 1e-3).  The counts are zeroed just
            before each counted call and read just after, summed by path:
            train must launch conv3 and LeakyReLU, serve and volume all
            four kernels.  ``--wide-only`` builds the kernels and runs this
            phase alone.
17. benches  each module of transfer_em_tpu_torch/bench/ started as a
            user starts it (``python -m``, a process of its own) at the
            reduced counts of BENCH_RUNS: fidelity (f32, bf16), serve
            model (8 requests), data (workers 0 and 4), soak (1000 data
            and 100 model requests; then 20 with two models churning),
            combined, dp (3 steps), int8, baseline_configs (config2's two
            lower rungs, config4 over 2 epochs).  Gated on each exit
            code, PSNR >= 40 dB (fidelity, int8), the soak bars and the
            launches each run must count (conv3 and LeakyReLU on
            fidelity, serve, combined and dp; the uint8 edges on serve;
            conv_int8 and quantize_int8 on int8; LeakyReLU and the edges
            on config2, a 2D model, whose convs all run on cuDNN, so no
            conv3 there); each bench's JSON line printed, and the seconds
            of each run.  ``--benches-only`` builds the kernels and runs
            this phase alone.
13. the card's nvidia-smi line, then the ``kernels`` line (``launches``
   from the served round, ``volume_launches`` from the volume phase's timed
   calls, ``train_launches`` from the 5 train steps, ``em2em_launches``
   from the em2em phase, ``serve_ng_launches`` from the serve_ng phase,
   ``twod_launches`` from the twod phase's quick start,
   ``train_bf16_launches`` from the bf16 quick start, ``int8_launches``
   from the int8 tile step (``launches`` for conv_int8 and
   quantize_int8; down4's times and bound from the int8 phase's down conv
   cases, the generator's two at B=128 summed), ``twod`` the 2D
   shapes' kernel times, ``train_bf16`` conv3's and LeakyReLU's bf16 times
   at the train step's shapes, ``slab_shapes`` from the volume phase's
   kernel checks, ``parallel_launches`` from phase 14's meshed calls,
   ``parallel_launches_by_path`` split by path, ``examples_launches``
   from phase 15's recipes, ``examples_launches_by_recipe`` split by
   recipe, ``wide_launches`` and ``wide_launches_by_path`` from phase 16,
   ``wide`` the kernels' times at the wf=1 shapes, ``benches_launches``
   and ``benches_launches_by_run`` from phase 17's bench processes), then
   the ``ok`` line.  Any failed check exits non-zero
   before the last line.
"""

import concurrent.futures as cf
import contextlib
import gzip
import json
import math
import os
import signal
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = None  # set by --out
LOG = []

# Published H100 SXM peaks (NVIDIA data sheet, dense): device memory rate and
# the arithmetic rates by operand type.  Bounds use these at the full 700 W.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
# float32-accurate products on the tensor cores by 3xTF32 (three TF32
# products per f32 product): the f32 conv3 bound.  67 TFLOP/s (f32 on the
# CUDA cores) is kept beside it as ``bound_ms_cuda_core``.
TF32X3_FLOPS = 495e12 / 3

B = 128  # the service's device batch at wf=8 (default_batch_size)
# (layer, input side, Cin, O, LeakyReLU epilogue on the main path)
CONV_LAYERS = [("stem", 74, 1, 8, True), ("down1.conv", 72, 8, 8, True),
               ("down2.conv", 34, 8, 16, True), ("up1.conv", 15, 16, 32, True),
               ("mid", 26, 32, 32, True), ("up0.conv", 24, 32, 16, True),
               ("head", 44, 16, 16, True), ("out", 42, 16, 1, False)]
# more conv3 shapes: wf=4 widths (mid at wf=4 is 32 -> 64 at 26^3 in,
# smaller batch), wf=16 widths (down2.conv 4 -> 8), a ragged small shape
CONV_EXTRA = [("wf4.32to64", (8, 26, 26, 26), 32, 64),
              ("wf16.4to8", (16, 34, 34, 34), 4, 8),
              ("ragged", (2, 9, 11, 13), 8, 16)]
# the activations after down1.down, down2.down, up1.up, up0.up
LEAKY_SHAPES = [(B, 34, 34, 34, 8), (B, 15, 15, 15, 16), (B, 26, 26, 26, 16),
                (B, 44, 44, 44, 8)]
MS_X, MS_Y = (0.12, 0.85), (0.05, 0.6)
# The train step (CycleGANConfig().batch_size = 64) runs both generators and
# both discriminators at 2 x 64 = B tiles in its first round and at 64 in
# its second (the cycles, the frozen discriminators on the fakes).
TRAIN_B = 64
# the 3D discriminator's k3 convs at wf=8 (layer, input side, Cin, O), each
# with the LeakyReLU epilogue
DISC_CONV_LAYERS = [("disc.down1.conv", 40, 1, 8), ("disc.hack", 18, 8, 16),
                    ("disc.down2.conv", 16, 16, 32),
                    ("disc.down3.conv", 6, 32, 32)]
# its standalone LeakyReLUs: after down1.down, down2.down, down3.down, again
# on down3's (the reference applies it twice) and after the 1x1 head
DISC_LEAKY_SHAPES = [(B, 18, 18, 18, 8), (B, 6, 6, 6, 32)] + [
    (B, 1, 1, 1, 32)] * 3


def emit(obj):
    line = json.dumps(obj)
    LOG.append(line)
    print(line, flush=True)


def fail(phase, msg, **extra):
    emit({"phase": phase, "ok": False, "error": msg, **extra})
    _write_log()
    sys.exit(1)


def _write_out(name, text):
    if OUT_DIR is not None:
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, name), "w") as f:
            f.write(text)


def _write_log():
    _write_out("chip_smoke.jsonl", "\n".join(LOG) + "\n")


def nvidia_smi_line():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return res.stdout.strip().splitlines()[0] if res.stdout.strip() else ""


def cuda_ms(fn, reps=5):
    """Mean time of fn() on the card over reps launches, after one warm-up
    (CUDA events around the run, then synchronise)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps=20):
    """Mean device time of fn() over reps launches replayed from one CUDA
    graph: the launches' host cost (Python, ctypes, allocation) drops out,
    which cuda_ms keeps where the host is slower than the kernel."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes, flops, dtype, peak=None):
    """Least time (ms) for the work: max of bytes over the memory rate and
    operations over the peak (default: the peak for the operand type)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (peak or PEAK_FLOPS[dtype]) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def conv3_peak(dtype):
    return TF32X3_FLOPS if dtype == torch.float32 else PEAK_FLOPS[dtype]


def psnr(got, want):
    """PSNR (dB) with the reference output's dynamic range as peak."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    mse = np.mean((got - want) ** 2)
    peak = max(want.max() - want.min(), 1e-6)
    return 10 * np.log10(peak ** 2 / max(mse, 1e-20))


# -- phase 3: kernels against their plain versions ---------------------------

def _conv3_case(dev, gen, dtype, rel_tol, name, shape, c, o, act,
                graph=False, extra=None):
    """One conv3 check and its times (with ``graph``, also the kernel's and
    the library call's by CUDA graph replay); returns the record, with
    ``extra``'s keys."""
    from transfer_em_tpu_torch.ops import cuda_conv

    x = torch.randn(shape + (c,), generator=gen, device=dev)
    w = torch.randn((3, 3, 3, c, o), generator=gen, device=dev)
    x, w = x.to(dtype), (w / (27 * c) ** 0.5).to(dtype)
    w_lib, x_lib = w.permute(4, 3, 0, 1, 2), x.permute(0, 4, 1, 2, 3)
    n_out = shape[0] * o * math.prod(s - 2 for s in shape[1:])
    nbytes = (x.numel() + w.numel() + n_out) * x.element_size()
    flops = 2.0 * n_out * 27 * c
    b_ms, b_by = bound(nbytes, flops, dtype, conv3_peak(dtype))
    leaky = 0.3 if act else None
    got = cuda_conv.conv3(x, w, leaky)
    ref = cuda_conv.conv3_plain(x, w, leaky)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    ref_max = ref.float().abs().max().item()
    tol = rel_tol * max(1.0, ref_max)
    del got, ref

    def lib():
        y = F.conv3d(x_lib, w_lib)
        return F.leaky_relu(y, 0.3) if act else y

    k_ms = cuda_ms(lambda: cuda_conv.conv3(x, w, leaky))
    path = cuda_conv.conv3_path(c, o)
    plan = cuda_conv.conv3_plan(c, o, dtype) if path == "tc" else None
    rec = {"phase": "kernel", "kernel": "conv3", "layer": name,
           "path": path,
           "form": "direct" if plan is None else "kw" if plan.kw else "tap",
           "dtype": str(dtype).replace("torch.", ""),
           "shape": list(shape) + [c], "out_channels": o, "epilogue": act,
           "max_abs_err": err, "ref_max_abs": ref_max, "tol": tol,
           "ok": err <= tol,
           "kernel_ms": k_ms,
           "plain_ms": cuda_ms(lambda: cuda_conv.conv3_plain(x, w, leaky)),
           "library_ms": cuda_ms(lib), "bound_ms": b_ms, "bound_by": b_by,
           "share": b_ms / k_ms, "tflops": flops / k_ms / 1e9,
           "t_bytes": nbytes / HBM_BYTES_PER_S * 1e3,
           "t_ops": flops / conv3_peak(dtype) * 1e3}
    if dtype == torch.float32:
        rec["bound_ms_cuda_core"] = bound(nbytes, flops, dtype)[0]
    if plan is not None and plan.kw:
        rec.update(form_times(x, w, leaky))
    if graph:
        rec["graph_ms"] = graph_ms(lambda: cuda_conv.conv3(x, w, leaky))
        rec["library_graph_ms"] = graph_ms(lib)
    rec.update(extra or {})
    emit(rec)
    return rec


def form_times(x, w, leaky, rounds=3, reps=10):
    """The tensor-core kernel's two forms on one f32 conv, each launched
    straight (``cuda_conv.conv3_tc``, no wrapper), in turns: the median of
    ``rounds`` timings of ``reps`` launches each, ``kw_ms`` for the kw form
    and ``tap_ms`` for the tap form it replaced."""
    from transfer_em_tpu_torch.ops import cuda_conv

    c, o = w.shape[3], w.shape[4]
    y = torch.empty(x.shape[:1] + tuple(n - 2 for n in x.shape[1:4]) + (o,),
                    device=x.device)
    runs = {}
    for name, kw in (("kw_ms", True), ("tap_ms", False)):
        plan = cuda_conv.tc_plan(c, o, torch.float32, kw)
        runs[name] = (plan, cuda_conv.pack_conv3_weights(w, torch.float32,
                                                         plan))
    times = {name: [] for name in runs}
    for _ in range(rounds):
        for name, (plan, wp) in runs.items():
            times[name].append(cuda_ms(
                lambda: cuda_conv.conv3_tc(x, wp, y, plan, leaky), reps))
    return {name: statistics.median(t) for name, t in times.items()}


def _down4_case(dev, gen, name, shape, c, o, dtype=torch.float32,
                act=True):
    """The k4 stride-2 VALID conv at (``shape`` + (c,)) x (4, 4, 4, c, o),
    TF32 off, under inference_mode: the counts of conv_nd's default route
    (``default_route``), F.conv3d's time (``library_ms``, its LeakyReLU
    after it with ``act``); in float32 also the down4 kernel against its
    plain version (``down4_plain``, the 2x2x2-tap conv over x's
    space-to-depth) without and with the epilogue at conv3's f32 tolerance
    (1e-4 max(1, |ref|)), and the kernel's and the plain version's times
    (with ``act``'s epilogue) beside the bound (bytes of x, w and y once at
    HBM_BYTES_PER_S, or the 64 taps' products at 495 TFLOP/s)."""
    from transfer_em_tpu_torch.ops import convs, cuda_down
    from transfer_em_tpu_torch.ops.cuda_kernels import LEAKY_SLOPE

    x = torch.randn(shape + (c,), generator=gen, device=dev).to(dtype)
    w = torch.randn((4, 4, 4, c, o), generator=gen,
                    device=dev) / (64 * c) ** 0.5
    leaky = LEAKY_SLOPE if act else None
    x_lib, w_lib = x.permute(0, 4, 1, 2, 3), w.to(dtype).permute(4, 3, 0, 1, 2)

    def lib():
        y = F.conv3d(x_lib, w_lib, stride=2)
        return F.leaky_relu(y, LEAKY_SLOPE) if act else y

    rec = {"kernel": "down4", "layer": name, "shape": list(x.shape),
           "out_channels": o, "dtype": str(dtype).replace("torch.", ""),
           "epilogue": act}
    with cudnn_tf32(False), torch.inference_mode():
        reset_counts()
        convs.conv_nd(x, w, stride=2)
        rec["default_route"] = {k: read_counts()[k]
                                for k in ("down_k4", "down_cudnn", "down4")}
        rec["library_ms"] = cuda_ms(lib)
        if dtype != torch.float32:
            rec["ok"] = True
            return rec
        errs = []
        for slope in (None, LEAKY_SLOPE):
            ref = cuda_down.down4_plain(x, w, slope)
            got = cuda_down.down4(x, w, slope)
            ref_max = float(ref.abs().max())
            errs.append((float((got - ref).abs().max()), ref_max,
                         1e-4 * max(1.0, ref_max)))
            del ref, got
        n_out = shape[0] * math.prod(s // 2 - 1 for s in shape[1:]) * o
        b_ms, b_by = bound(4 * (x.numel() + w.numel() + n_out),
                           2.0 * n_out * 64 * c, dtype, peak=495e12)
        rec.update({
            "max_abs_err": max(e for e, _, _ in errs),
            "ref_max_abs": errs[0][1],
            "rel_err": max(e / m for e, m, _ in errs),
            "tol": errs[0][2], "ok": all(e <= t for e, _, t in errs),
            "errs_by_epilogue": {"none": errs[0][0], "leaky": errs[1][0]},
            "ms": cuda_ms(lambda: cuda_down.down4(x, w, leaky)),
            "plain_ms": cuda_ms(lambda: cuda_down.down4_plain(x, w, leaky)),
            "bound_ms": b_ms, "bound_by": b_by,
            "nc": cuda_down.down4_plan(c, o).nc})
    return rec


def check_conv3(dev, gen):
    """Every conv3 case in f32 (tol 1e-4 max(1, |ref|)) and bf16 (1e-2);
    per dtype, totals over the served batch's 8 calls, overall and by path;
    in f32 also the discriminator's 4 k3 convs at the train step's B tiles,
    totalled apart (``disc``).  ``rel_err``: the largest max_abs_err /
    max |ref| of the f32 train-path cases (the gradient check's noise level
    is set against it)."""
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_ms_cuda_core",
            "t_bytes", "t_ops")
    agg = {}
    for dtype, rel_tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
        tot = {k: 0.0 for k in keys}
        tot.update(max_abs_err=0.0, checks=0, passed=0, paths={}, rel_err=0.0)
        cases = [(n, (B, s, s, s), c, o, m, "gen")
                 for n, s, c, o, m in CONV_LAYERS]
        cases += [(n, shp, c, o, None, "extra") for n, shp, c, o in CONV_EXTRA]
        if dtype == torch.float32:  # the train step runs float32 only
            cases += [(n, (B, s, s, s), c, o, True, "disc")
                      for n, s, c, o in DISC_CONV_LAYERS]
        for name, shape, c, o, main_act, net in cases:
            for act in (False, True) if net != "disc" else (True,):
                rec = _conv3_case(dev, gen, dtype, rel_tol, name, shape, c, o,
                                  act)
                tot["checks"] += 1
                tot["passed"] += int(rec["ok"])
                if act != main_act:
                    continue  # not the main path's own call
                tot["rel_err"] = max(tot["rel_err"], rec["max_abs_err"]
                                     / max(rec["ref_max_abs"], 1e-30))
                if rec["form"] == "kw":  # each narrow f32 layer's times
                    tot.setdefault("kw", []).append(
                        {k: rec[k] for k in ("layer", "kernel_ms", "kw_ms",
                                             "tap_ms", "bound_ms",
                                             "bound_by")})
                if net == "disc":
                    group = tot.setdefault("disc", {**{k: 0.0 for k in keys},
                                                    "max_abs_err": 0.0,
                                                    "layers": []})
                    parts = (group,)
                else:
                    group = tot["paths"].setdefault(
                        rec["path"], {**{k: 0.0 for k in keys},
                                      "max_abs_err": 0.0, "layers": []})
                    parts = (tot, group)
                group["layers"].append(name)
                for t in parts:
                    t["ms"] += rec["kernel_ms"]
                    for k in keys[1:]:
                        t[k] += rec.get(k, 0.0)
                    t["max_abs_err"] = max(t["max_abs_err"],
                                           rec["max_abs_err"])
        for t in (tot, *tot["paths"].values(), *([tot["disc"]]
                                                 if "disc" in tot else [])):
            t["bound_by"] = ("operations" if t.pop("t_ops") > t.pop("t_bytes")
                             else "bytes")
            if dtype != torch.float32:
                t.pop("bound_ms_cuda_core")
        agg[str(dtype).replace("torch.", "")] = tot
    return agg


def check_conv3_kw_fault(dev, gen):
    """The kw form's planted fault: csrc/conv3_tc.cu built with
    -DTEM_CONV3_KW_FAULT=1 leaves the row shifted by two columns out of the
    epilogue's sum.  At each narrow f32 layer of the generator (B=8, the
    LeakyReLU epilogue) the faulty build must miss the plain version by more
    than conv3's f32 tolerance, 1e-4 max(1, |ref|), where the library's own
    build meets it."""
    from transfer_em_tpu_torch import kernels
    from transfer_em_tpu_torch.ops import cuda_conv

    lib = kernels.build_variant("conv3_tc.cu", "conv3_kw_fault",
                                ["TEM_CONV3_KW_FAULT=1"])
    cases = {}
    for name, s, c, o, _ in CONV_LAYERS:
        plan = cuda_conv.conv3_plan(c, o, torch.float32) if (
            cuda_conv.conv3_path(c, o) == "tc") else None
        if plan is None or not plan.kw:
            continue
        x = torch.randn((8, s, s, s, c), generator=gen, device=dev)
        w = torch.randn((3, 3, 3, c, o), generator=gen, device=dev) / (
            27 * c) ** 0.5
        ref = cuda_conv.conv3_plain(x, w, 0.3)
        tol = 1e-4 * max(1.0, ref.abs().max().item())
        wp = cuda_conv.packed_weights(w)
        errs = {}
        for build, which in (("sound", None), ("fault", lib)):
            y = torch.empty_like(ref)
            cuda_conv.conv3_tc(x, wp, y, plan, 0.3, lib=which)
            errs[build] = (y - ref).abs().max().item()
        cases[name] = {**errs, "tol": tol,
                       "ok": errs["sound"] <= tol < errs["fault"]}
        del x, ref, y
    torch.cuda.empty_cache()
    rec = {"phase": "conv3_kw_fault", "cases": cases,
           "ok": bool(cases) and all(v["ok"] for v in cases.values())}
    emit(rec)
    return rec


def check_strided(dev, gen):
    """Each kernel's wrapper on a strided view (a crop, as a caller slicing
    a padded volume hands the generator), against its plain version on the
    same view: conv3 (tensor-core and direct paths, with the epilogue)
    within 1e-4 max(1, |ref|), the elementwise three bit-equal."""
    from transfer_em_tpu_torch.ops import cuda_conv
    from transfer_em_tpu_torch.ops import cuda_kernels as ck

    def crop(t):  # drop one plane a face of the first two spatial axes
        return t[:, 1:-1, 1:-1]

    cases = {}
    for c, o in ((8, 16), (1, 8)):
        x = crop(torch.randn((2, 20, 20, 18, c), generator=gen, device=dev))
        w = torch.randn((3, 3, 3, c, o), generator=gen, device=dev) / (
            27 * c) ** 0.5
        got = cuda_conv.conv3(x, w, 0.3)
        ref = cuda_conv.conv3_plain(x, w, 0.3)
        err = (got - ref).abs().max().item()
        cases[f"conv3.{cuda_conv.conv3_path(c, o)}"] = {
            "max_abs_err": err,
            "ok": err <= 1e-4 * max(1.0, ref.abs().max().item())}
    u8 = crop(torch.randint(0, 256, (2, 20, 20, 20), generator=gen,
                            device=dev, dtype=torch.uint8))
    y = crop(torch.randn((2, 20, 20, 20, 1), generator=gen, device=dev))
    v = crop(torch.randn((2, 20, 20, 20, 8), generator=gen, device=dev))
    for name, got, ref in (
            ("preprocess_u8", ck.preprocess_u8(u8, MS_X),
             ck.preprocess_u8_plain(u8, MS_X)),
            ("postprocess_u8", ck.postprocess_u8(y, MS_Y, 2),
             ck.postprocess_u8_plain(y, MS_Y, 2)),
            ("leaky_relu", ck.leaky_relu(v), ck.leaky_relu_plain(v))):
        cases[name] = {"ok": bool(torch.equal(got, ref))}
    rec = {"phase": "kernel_strided", "cases": cases,
           "ok": all(c["ok"] for c in cases.values())}
    emit(rec)
    return rec


def check_train_shapes(dev, gen):
    """conv3 (f32, with each layer's own epilogue) and LeakyReLU (f32)
    against their plain versions at the train step's second-round batch,
    TRAIN_B tiles: both networks' shapes (the first round's, at B, are
    checked and timed above).  Checked only, not timed; the same tolerances
    (1e-4 max(1, |ref|) for conv3, bit-identical for LeakyReLU)."""
    from transfer_em_tpu_torch.ops import cuda_conv
    from transfer_em_tpu_torch.ops import cuda_kernels as ck

    res = {"conv3_checks": 0, "conv3_passed": 0, "leaky_checks": 0,
           "leaky_passed": 0, "max_abs_err": 0.0, "rel_err": 0.0}
    convs = [(n, s, c, o, act) for n, s, c, o, act in CONV_LAYERS]
    convs += [(n, s, c, o, True) for n, s, c, o in DISC_CONV_LAYERS]
    for name, s, c, o, act in convs:
        x = torch.randn((TRAIN_B, s, s, s, c), generator=gen, device=dev)
        w = torch.randn((3, 3, 3, c, o), generator=gen, device=dev)
        w = w / (27 * c) ** 0.5
        leaky = ck.LEAKY_SLOPE if act else None
        ref = cuda_conv.conv3_plain(x, w, leaky)
        err = (cuda_conv.conv3(x, w, leaky) - ref).abs().max().item()
        ref_max = ref.abs().max().item()
        ok = err <= 1e-4 * max(1.0, ref_max)
        emit({"phase": "kernel", "kernel": "conv3", "layer": name,
              "path": cuda_conv.conv3_path(c, o), "dtype": "float32",
              "shape": [TRAIN_B, s, s, s, c], "out_channels": o,
              "epilogue": act, "max_abs_err": err, "ref_max_abs": ref_max,
              "ok": ok})
        res["conv3_checks"] += 1
        res["conv3_passed"] += int(ok)
        res["max_abs_err"] = max(res["max_abs_err"], err)
        res["rel_err"] = max(res["rel_err"], err / max(ref_max, 1e-30))
        del x, w, ref
    for shape in LEAKY_SHAPES + DISC_LEAKY_SHAPES:
        v = torch.randn((TRAIN_B,) + shape[1:], generator=gen, device=dev)
        ok = torch.equal(ck.leaky_relu(v), ck.leaky_relu_plain(v))
        emit({"phase": "kernel", "kernel": "leaky_relu", "dtype": "float32",
              "shape": list(v.shape), "ok": ok})
        res["leaky_checks"] += 1
        res["leaky_passed"] += int(ok)
        del v
    return res


def _tie_voxels(y, meanstd, tpad):
    t = slice(tpad, -tpad) if tpad else slice(None)
    z = y[(slice(None),) + (t,) * (y.dim() - 2) + (0,)].double()
    z = z * meanstd[1] + meanstd[0]
    z = (z + 1.0) * 127.5
    return (z - z.floor() - 0.5).abs() < 1e-6


def post_check(y, tpad):
    """postprocess against its plain version: bit-identical except at exact
    .5 ties of the f32 value, where one level is allowed."""
    from transfer_em_tpu_torch.ops import cuda_kernels as ck

    got = ck.postprocess_u8(y, MS_Y, tpad)
    ref = ck.postprocess_u8_plain(y, MS_Y, tpad)
    diff = (got.int() - ref.int()).abs()
    ties = _tie_voxels(y, MS_Y, tpad)
    off_tie = int(diff[~ties].max().item()) if (~ties).any() else 0
    return {"max_abs_err": float(diff.max().item()), "tol": 0,
            "tie_voxels": int(ties.sum().item()),
            "differing_voxels": int((diff > 0).sum().item()),
            "ok": off_tie == 0 and int(diff.max().item()) <= 1}


def _pre_case(x):
    """preprocess on uint8 ``x`` against its plain version (within 1e-6),
    with its times beside the bound."""
    from transfer_em_tpu_torch.ops import cuda_kernels as ck

    got, ref = ck.preprocess_u8(x, MS_X), ck.preprocess_u8_plain(x, MS_X)
    err = (got - ref).abs().max().item()
    del got, ref
    a, b = ck.preprocess_affine(MS_X)
    b_ms, b_by = bound(x.numel() * 5, 2.0 * x.numel(), torch.float32)
    return {"max_abs_err": err, "tol": 1e-6, "ok": err <= 1e-6,
            "ms": cuda_ms(lambda: ck.preprocess_u8(x, MS_X), 20),
            "plain_ms": cuda_ms(lambda: ck.preprocess_u8_plain(x, MS_X), 20),
            "library_ms": cuda_ms(lambda: x.float() * a + b, 20),
            "graph_ms": graph_ms(lambda: ck.preprocess_u8(x, MS_X)),
            "library_graph_ms": graph_ms(lambda: x.float() * a + b),
            "bound_ms": b_ms, "bound_by": b_by}


def _post_case(y):
    """postprocess on the (B, 40^3, 1) model output ``y`` at tpad 2 (the
    tile step's trim, read in place: the vector path) against its plain
    version (post_check), with its times beside the bound."""
    from transfer_em_tpu_torch.ops import cuda_kernels as ck

    rec = post_check(y, 2)
    n_out = y.shape[0] * 36 ** 3
    b_ms, b_by = bound(n_out * 5, 5.0 * n_out, torch.float32)
    lib = lambda: (y[:, 2:-2, 2:-2, 2:-2, 0] * MS_Y[1] + MS_Y[0] + 1.0).mul(
        127.5).round().clamp(0, 255).to(torch.uint8)
    rec.update({
        "ms": cuda_ms(lambda: ck.postprocess_u8(y, MS_Y, 2), 20),
        "plain_ms": cuda_ms(lambda: ck.postprocess_u8_plain(y, MS_Y, 2), 20),
        "library_ms": cuda_ms(lib, 20),
        "graph_ms": graph_ms(lambda: ck.postprocess_u8(y, MS_Y, 2)),
        "library_graph_ms": graph_ms(lib), "bound_ms": b_ms,
        "bound_by": b_by})
    return rec


def _leaky_case(v):
    """LeakyReLU on ``v`` against its plain version (bit-identical), with
    its times beside the bound."""
    from transfer_em_tpu_torch.ops import cuda_kernels as ck

    got, ref = ck.leaky_relu(v), ck.leaky_relu_plain(v)
    err = (got.float() - ref.float()).abs().max().item()
    del got, ref
    b_ms, b_by = bound(2 * v.numel() * v.element_size(), 2.0 * v.numel(),
                       v.dtype)
    return {"max_abs_err": err, "tol": 0.0, "ok": err == 0.0,
            "ms": cuda_ms(lambda: ck.leaky_relu(v), 20),
            "plain_ms": cuda_ms(lambda: ck.leaky_relu_plain(v), 20),
            "library_ms": cuda_ms(lambda: F.leaky_relu(v, 0.3), 20),
            "graph_ms": graph_ms(lambda: ck.leaky_relu(v)),
            "library_graph_ms": graph_ms(lambda: F.leaky_relu(v, 0.3)),
            "bound_ms": b_ms, "bound_by": b_by}


def check_elementwise(dev, gen):
    from transfer_em_tpu_torch.ops import cuda_kernels as ck

    out = {}
    # preprocess: (B, 74^3) uint8 -> (B, 74^3, 1) f32
    x = torch.randint(0, 256, (B, 74, 74, 74), generator=gen, device=dev,
                      dtype=torch.uint8)
    rec = _pre_case(x)
    emit({"phase": "kernel", "kernel": "preprocess_u8",
          "shape": list(x.shape), **rec})
    out["preprocess_u8"] = rec
    del x

    # postprocess: (B, 40^3, 1) f32, tpad 2 read in place -> (B, 36^3) u8
    # (the vector path), timed; then the scalar path (odd tpad, OW % 4 != 0)
    # and tpad 0, checked only.
    y = torch.randn((B, 40, 40, 40, 1), generator=gen, device=dev)
    rec = _post_case(y)
    emit({"phase": "kernel", "kernel": "postprocess_u8", "path": "vector",
          "shape": list(y.shape), "tpad": 2, **rec})
    del y
    for side, tpad, path in ((42, 1, "scalar: odd tpad"),
                             (42, 2, "scalar: OW % 4 != 0"),
                             (40, 0, "vector: tpad 0")):
        case = post_check(torch.randn((8, side, side, side, 1), generator=gen,
                                      device=dev), tpad)
        emit({"phase": "kernel", "kernel": "postprocess_u8", "path": path,
              "shape": [8, side, side, side, 1], "tpad": tpad, **case})
        rec["ok"] = rec["ok"] and case["ok"]
    out["postprocess_u8"] = rec

    # LeakyReLU at the generator's four activations the conv epilogue cannot
    # absorb, and (f32, the train step's dtype) at the discriminator's
    for net, dtype, shapes in (("", torch.float32, LEAKY_SHAPES),
                               ("", torch.bfloat16, LEAKY_SHAPES),
                               ("disc_", torch.float32, DISC_LEAKY_SHAPES)):
        tot = {"max_abs_err": 0.0, "ok": True, "ms": 0.0, "plain_ms": 0.0,
               "library_ms": 0.0, "bound_ms": 0.0, "bound_by": "bytes",
               "graph_ms": 0.0, "library_graph_ms": 0.0}
        for shape in shapes:
            v = torch.randn(shape, generator=gen, device=dev).to(dtype)
            rec = _leaky_case(v)
            emit({"phase": "kernel", "kernel": "leaky_relu",
                  "net": net.rstrip("_") or "gen",
                  "dtype": str(dtype).replace("torch.", ""),
                  "shape": list(shape), **rec})
            for k in ("ms", "plain_ms", "library_ms", "bound_ms", "graph_ms",
                      "library_graph_ms"):
                tot[k] += rec[k]
            tot["max_abs_err"] = max(tot["max_abs_err"], rec["max_abs_err"])
            tot["ok"] = tot["ok"] and rec["ok"]
            del v
        out["leaky_relu_" + net + str(dtype).replace("torch.", "")] = tot
        if net:
            continue
        # an odd length (scalar tail) and a view 1 element off 16-byte
        # alignment (the scalar kernel): bit-identical, not timed
        base = torch.randn((1_000_004,), generator=gen, device=dev).to(dtype)
        for label, v in (("odd_length", base[:1_000_003]),
                         ("misaligned", base[1:])):
            got, ref = ck.leaky_relu(v), ck.leaky_relu_plain(v)
            ok = torch.equal(got, ref)
            emit({"phase": "kernel", "kernel": "leaky_relu", "case": label,
                  "dtype": str(dtype).replace("torch.", ""),
                  "shape": list(v.shape), "ok": ok})
            tot["ok"] = tot["ok"] and ok
    return out


# -- phase 4: golden fidelity ------------------------------------------------

def check_golden(dev):
    from transfer_em_tpu_torch.models import UNetGenerator
    from transfer_em_tpu_torch.models.convert import params_from_tf_order

    data = np.load(os.path.join(ROOT, "tests", "goldens", "gen_3d.npz"))
    sd = params_from_tf_order(data)
    x = torch.from_numpy(data["x"]).to(dev)
    res = {}
    for cd in (None, "bfloat16"):
        gen = UNetGenerator(wf=8, compute_dtype=cd)
        gen.load_state_dict(sd)
        gen = gen.to(dev).eval()
        with torch.inference_mode():
            got = gen(x).cpu().numpy()
        res[cd or "float32"] = psnr(got, data["y"])
    return res


def check_disc_golden(dev):
    """The port's 3D discriminator (kernels on, f32) against the frozen TF
    output tests/goldens/disc_3d.npz: PSNR >= 40 dB."""
    from transfer_em_tpu_torch.models import Discriminator
    from transfer_em_tpu_torch.models.convert import (DISC_ORDER_3D,
                                                      params_from_tf_order)

    data = np.load(os.path.join(ROOT, "tests", "goldens", "disc_3d.npz"))
    disc = Discriminator(wf=8)
    disc.load_state_dict(params_from_tf_order(data, DISC_ORDER_3D))
    reset_counts()
    with torch.inference_mode():
        got = disc.to(dev).eval()(torch.from_numpy(data["x"]).to(dev))
    launches = read_counts()
    got = got.cpu().numpy()
    err = float(np.abs(got - data["y"]).max())
    return {"psnr_db": psnr(got, data["y"]), "max_abs_err": err,
            "launches": launches}


# -- phase 5: serving --------------------------------------------------------

def seeded_generator(seed, dev, is3d=True, wf=8, **kw):
    """wf=8 (or ``wf``) generator (3D, or 2D) with numpy-seeded weights of
    std 1/sqrt(fan-in), so the outputs vary over the whole uint8 range;
    ``kw`` goes to UNetGenerator (compute_dtype, int8_conv)."""
    from transfer_em_tpu_torch.models import UNetGenerator

    rng = np.random.default_rng(seed)
    gen = UNetGenerator(wf=wf, is3d=is3d, **kw)
    sd = {k: torch.from_numpy(rng.normal(
        0, float(np.prod(v.shape[:-1])) ** -0.5, tuple(v.shape)).astype(
            np.float32)) for k, v in gen.state_dict().items()}
    gen.load_state_dict(sd)
    return gen.to(dev).eval()


def smooth_volume(side, seed, dev, ndim=3):
    """Seeded uint8 zyx volume of side^3 (or, ndim=2, a yx image of side^2):
    uniform noise smoothed on the card (two 3^n box filters), standardized
    to mean 128, std 40 grey levels."""
    g = torch.Generator(device=dev).manual_seed(seed)
    v = torch.rand((1, 1) + (side,) * ndim, generator=g, device=dev)
    pool = F.avg_pool3d if ndim == 3 else F.avg_pool2d
    for _ in range(2):
        v = pool(v, 3, stride=1, padding=1, count_include_pad=False)
    v = (v - v.mean()) / v.std() * 40.0 + 128.0
    return v[0, 0].round().clamp(0, 255).to(torch.uint8).cpu().numpy()


@contextlib.contextmanager
def plain_versions(noise=0.0, seed=5):
    """Route the models and the tile step through the plain PyTorch versions
    (on CUDA tensors too, differentiable by autograd): the reference path of
    the serving and train checks.  ``noise`` > 0 multiplies every conv3's
    and down4's f32 sums by (1 + noise * N(0, 1)), drawn from ``seed``,
    before they round to the input's dtype: a perturbation of the plain
    path's forward of a chosen relative size."""
    from transfer_em_tpu_torch.infer import device_stitch, slab, tiling
    from transfer_em_tpu_torch.models import blocks
    from transfer_em_tpu_torch.ops import (convs, cuda_conv, cuda_down,
                                           cuda_int8, quant)
    from transfer_em_tpu_torch.ops import cuda_kernels as ck

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def noisy(plain):
        def conv(x, w, leaky=None):
            if not noise:
                return plain(x, w, leaky)
            # the noise on the f32 sums, before they round to x's dtype
            y = plain(x.float(), w.to(x.dtype).float())
            y = (y * (1.0 + noise * torch.randn(
                y.shape, generator=gen, device=y.device))).to(x.dtype)
            return y if leaky is None else torch.where(y >= 0, y, y * leaky)
        return conv

    conv3 = noisy(cuda_conv.conv3_plain)
    swaps = [(convs, "conv3", conv3),
             (convs, "down4", noisy(cuda_down.down4_plain)),
             (blocks, "leaky_relu", ck.leaky_relu_plain),
             (convs, "leaky_relu", ck.leaky_relu_plain),
             (quant, "conv_int8", cuda_int8.conv_int8_plain),
             (quant, "quantize_int8", quant.quantize_int8_plain),
             *[(m, n, f) for m in (tiling, device_stitch, slab)
               for n, f in (("preprocess_u8", ck.preprocess_u8_plain),
                            ("postprocess_to_u8", ck.postprocess_u8_plain))]]
    saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
    try:
        for m, n, f in swaps:
            setattr(m, n, f)
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)


@contextlib.contextmanager
def recorded_calls():
    """Record the distinct kernel-wrapper calls of the generator and the
    slab path: yields a list of ("conv3", x shape, O, epilogue), ("down4",
    x shape, O, epilogue), ("leaky_relu", shape), ("preprocess_u8", shape)
    and ("postprocess_u8", shape, tpad) in the order of their first
    call.  conv3's calls are the model's k3 convs, whose kernel is a
    parameter; the phase conv's, on a kernel derived from one, are held
    in phase 12."""
    from transfer_em_tpu_torch.infer import slab
    from transfer_em_tpu_torch.models import blocks
    from transfer_em_tpu_torch.ops import convs

    calls = []

    def recording(m, name, key):
        f = getattr(m, name)

        def wrapped(*args):
            k = key(*args)
            if k is not None and k not in calls:
                calls.append(k)
            return f(*args)
        return wrapped

    swaps = [
        (convs, "conv3", lambda x, w, leaky=None: (
            "conv3", tuple(x.shape), w.shape[-1], leaky is not None)
         if isinstance(w, torch.nn.Parameter) else None),
        (convs, "down4", lambda x, w, leaky=None: (
            "down4", tuple(x.shape), w.shape[-1], leaky is not None)),
        (blocks, "leaky_relu", lambda v, *_: ("leaky_relu", tuple(v.shape))),
        (convs, "leaky_relu", lambda v, *_: ("leaky_relu", tuple(v.shape))),
        (slab, "preprocess_u8", lambda x, ms: ("preprocess_u8",
                                               tuple(x.shape))),
        (slab, "postprocess_to_u8", lambda y, ms, tpad=0: (
            "postprocess_u8", tuple(y.shape), tpad))]
    saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
    try:
        for m, n, key in swaps:
            setattr(m, n, recording(m, n, key))
        yield calls
    finally:
        for m, n, f in saved:
            setattr(m, n, f)


def profile_round(run):
    """Device time by kernel over ``run()`` from torch.profiler (CUPTI):
    the device's busy share of the wall time and where its time goes."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue  # host-side ops; their kernels are listed on their own
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            rows.append((e.key, us / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    groups = {"port_kernels": 0.0, "copies": 0.0, "other": 0.0}
    for name, ms, _ in rows:
        if "tem::" in name:
            groups["port_kernels"] += ms
        elif "memcpy" in name.lower() or "memset" in name.lower():
            groups["copies"] += ms
        else:
            groups["other"] += ms
    device_ms = sum(groups.values())
    return {"wall_s": wall, "device_ms": device_ms,
            "device_busy_share": device_ms / 1e3 / wall,
            "by_group_ms": groups,
            "top": [{"name": n[:100], "ms": ms, "calls": c}
                    for n, ms, c in rows[:16]]}


def counters():
    """The four kernels of the main path, as ``read_counts()`` keys."""
    return ("conv3", "preprocess_u8", "postprocess_u8", "leaky_relu")


def reset_counts():
    from transfer_em_tpu_torch.ops.counts import reset_counts as reset
    reset()


def read_counts():
    """Launches per kernel, conv3 also per path (tc, direct), conv3's and
    LeakyReLU's on bfloat16 operands, and the weight packs (plain torch,
    not a kernel launch); conv_int8's and quantize_int8's, which only the
    int8 path launches, and the int8 weights made, beside them: the port's
    one reader, ``ops/counts.py``."""
    from transfer_em_tpu_torch.ops.counts import read_counts as read
    return read()


def post_chunk(url, location, start, size, model_name, dest):
    """One chunk request to a ModelService at ``url``: the size^3 region
    at ``start`` (xyz) of ``location`` through ``model_name``, its blocks
    written to ``dest``.  Returns (body, seconds)."""
    cfg = {"location": location, "start": list(start),
           "glbstart": [0, 0, 0], "size": [size] * 3,
           "model_name": model_name, "dest": dest}
    t0 = time.perf_counter()
    req = urllib.request.Request(
        url + "/", data=json.dumps(cfg).encode(),
        headers={"Content-type": "application/json"})
    body = urllib.request.urlopen(req, timeout=600).read()
    return body, time.perf_counter() - t0


def check_serving(dev, smi):
    from transfer_em_tpu_torch.config import ExportMeta
    from transfer_em_tpu_torch.infer import export_generator, predict_tiled
    from transfer_em_tpu_torch.native import gather_box
    from transfer_em_tpu_torch.serve import (ModelService, NumpyVolume,
                                             register_volume)

    side, size = 384, 128
    vol = smooth_volume(side, seed=7, dev=dev)
    register_volume("smoke/vol", NumpyVolume(vol))
    with tempfile.TemporaryDirectory() as tmp:
        model_dir = os.path.join(tmp, "models", "smoke", "v1")
        meta = ExportMeta(buffer=17, outdimsize=40, meanstd_x=MS_X,
                          meanstd_y=MS_Y, dimsize=74, is3d=True, wf=8)
        gen_ref = seeded_generator(3, dev)
        export_generator(gen_ref, meta, model_dir)

        starts = [(0, 0, 0), (128, 64, 192), (256, 256, 256), (64, 192, 0),
                  (192, 0, 128), (256, 128, 64)]
        svc = ModelService(model_root=os.path.join(tmp, "models"),
                           device=dev)
        svc.start()

        def request(i, start, tag=""):
            return post_chunk(svc.url, "smoke/vol", start, size, "smoke:v1",
                              os.path.join(tmp, f"out{i}{tag}"))

        try:
            reset_counts()
            body, first_s = request(0, starts[0])  # includes the model load
            if body != b"success":
                fail("serve", f"request 0 answered {body!r}")
            t0 = time.perf_counter()
            with cf.ThreadPoolExecutor(max_workers=5) as ex:
                futs = [ex.submit(request, i, s)
                        for i, s in enumerate(starts) if i > 0]
                results = [f.result(timeout=900) for f in futs]
            wall = time.perf_counter() - t0
            launches = read_counts()
            stats = svc.cache.stats()

            def profiled():  # the same five requests again, traced
                with cf.ThreadPoolExecutor(max_workers=5) as ex:
                    futs = [ex.submit(request, i, s, "p")
                            for i, s in enumerate(starts) if i > 0]
                    if any(f.result(timeout=900)[0] != b"success"
                           for f in futs):
                        fail("serve", "a traced request failed")

            trace = profile_round(profiled)
        finally:
            svc.stop()
        for body, _ in results:
            if body != b"success":
                fail("serve", f"a request answered {body!r}")

        # Reference: the plain versions on the same card, float32.
        outs = {}
        with plain_versions():
            for i, s in enumerate(starts):
                outs[i] = predict_tiled(
                    lambda c, n: gather_box(vol, c, (n,) * 3), gen_ref, s,
                    (size,) * 3, meta.outdimsize, meta.buffer, MS_X, MS_Y,
                    batch_size=64, device=dev)
        worst, frac = 0, 0.0
        for i, s in enumerate(starts):
            got, n_blocks = read_ng_blocks(os.path.join(tmp, f"out{i}"), s,
                                           (size,) * 3)
            if n_blocks != (size // 64) ** 3:
                fail("serve", f"request {i}: {n_blocks} blocks written")
            diff = np.abs(got.astype(int) - outs[i].astype(int))
            worst = max(worst, int(diff.max()))
            frac = max(frac, float((diff > 0).mean()))
        spread = float(np.std(outs[1]))
    n_tiles = (len(starts) - 1) * (-(-size // 36)) ** 3
    rec = {"phase": "serve", "requests": len(starts), "concurrent": 5,
           "first_request_s": first_s, "concurrent_wall_s": wall,
           "tiles_per_s": n_tiles / wall,
           "mvox_per_s": (len(starts) - 1) * size ** 3 / wall / 1e6,
           "request_latency_s": [r[1] for r in results],
           "batcher": stats.get("batcher"), "launches": launches,
           "u8_max_diff": worst, "u8_frac_differing": frac,
           "output_std": spread, "card": smi, "profiled_round": trace}
    rec["ok"] = (worst <= 1 and frac <= 1e-3 and spread > 2.0
                 and all(launches[k] > 0 for k in (*counters(), "conv3_tc",
                                                    "conv3_direct")))
    emit(rec)
    return rec


# -- phase 5b: ng-precomputed volumes, the data service, the predictors -----

NG_PACKAGES = ("tensorstore", "requests", "PIL", "google.cloud.storage")


def has_module(name):
    """Whether ``name`` imports here (find_spec, without importing it)."""
    import importlib.util
    try:
        return importlib.util.find_spec(name) is not None
    except ModuleNotFoundError:  # a parent package is missing
        return False


def write_ng_volume(path, vol_zyx):
    """The zyx volume as a local ng-precomputed volume (raw, 64^3 chunks);
    returns its file:// location."""
    import tensorstore as ts
    spec = {"driver": "neuroglancer_precomputed",
            "kvstore": {"driver": "file", "path": path},
            "scale_metadata": {"size": list(vol_zyx.shape[::-1]),
                               "resolution": [8, 8, 8],
                               "chunk_size": [64, 64, 64], "encoding": "raw"},
            "multiscale_metadata": {"data_type": "uint8", "num_channels": 1,
                                    "type": "image"},
            "create": True}
    ts.open(spec).result()[...] = vol_zyx.transpose(2, 1, 0)[..., None]
    return "file://" + path


def read_ng_blocks(dest, start, size):
    """Stitch the gzip 64^3 blocks under ``dest`` into a zyx array."""
    got = np.zeros(size[::-1], np.uint8)
    names = sorted(os.listdir(dest))
    for nm in names:
        (x0, x1), (y0, y1), (z0, z1) = (
            tuple(int(v) for v in p.split("-")) for p in nm.split("_"))
        raw = gzip.decompress(open(os.path.join(dest, nm), "rb").read())
        got[z0 - start[2]:z1 - start[2], y0 - start[1]:y1 - start[1],
            x0 - start[0]:x1 - start[0]] = np.frombuffer(
                raw, np.uint8).reshape(z1 - z0, y1 - y0, x1 - x0)
    return got, len(names)


@contextlib.contextmanager
def host_timers(backend, tile_owner):
    """Seconds of ``backend.read`` (the instance open_volume caches) by
    request, ``tile_owner(corner)`` naming a read's request, and of
    model_service.write_ng_blocks by destination: timers of this script
    only, around the package's own functions."""
    from transfer_em_tpu_torch.serve import model_service

    reads, writes = {}, {}
    read, write = backend.read, model_service.write_ng_blocks

    def timed_read(start, size):
        t0 = time.perf_counter()
        out = read(start, size)
        key = tile_owner(tuple(start))
        reads[key] = reads.get(key, 0.0) + time.perf_counter() - t0
        return out

    def timed_write(data, dest, offset, **kw):
        t0 = time.perf_counter()
        write(data, dest, offset, **kw)
        writes[dest] = writes.get(dest, 0.0) + time.perf_counter() - t0

    backend.read, model_service.write_ng_blocks = timed_read, timed_write
    try:
        yield reads, writes
    finally:
        del backend.read
        model_service.write_ng_blocks = write


def check_serve_ng(dev, smi):
    """Serving from remote-style sources on the card: serve's six 128^3
    requests (one alone, then five concurrent) through ModelService from a
    .npy location (NumpyVolume) and, with tensorstore, from a file://
    ng-precomputed copy of the same volume (TensorstoreVolume, read
    bit-equal to NumpyVolume at every tile corner first), each request's
    backend read seconds, block-write seconds and wall; the blocks against
    predict_tiled through the plain versions (serve's bar); predict_ng_cube
    over tensorstore and (with requests) through the port's DataService on
    127.0.0.1; TransferEMPredictor (base64) and NgOutputPredictor (a local
    destination, read back).  A sub-check whose package is missing is
    listed as not run."""
    from transfer_em_tpu_torch.config import ExportMeta
    from transfer_em_tpu_torch.infer import (export_generator, plan_tiles,
                                             predict_tiled)
    from transfer_em_tpu_torch.infer.tiling import predict_ng_cube
    from transfer_em_tpu_torch.native import gather_box
    from transfer_em_tpu_torch.serve import (DataService, ModelService,
                                             NgOutputPredictor, NumpyVolume,
                                             TensorstoreVolume,
                                             TransferEMPredictor, open_volume)

    t_phase = time.perf_counter()
    have = {m: has_module(m) for m in NG_PACKAGES}
    rec = {"phase": "serve_ng", "card": smi, "packages": have,
           "not_run": {}, "checks": {}}
    side, size = 384, 128
    starts = [(0, 0, 0), (128, 64, 192), (256, 256, 256), (64, 192, 0),
              (192, 0, 128), (256, 128, 64)]
    vol = smooth_volume(side, seed=7, dev=dev)  # serve's volume
    gen_ref = seeded_generator(3, dev)

    def bar(got, want):
        worst, frac = _u8_diff(got, want)
        return {"u8_max_diff": worst, "u8_frac_differing": frac,
                "ok": worst <= 1 and frac <= 1e-3}

    with plain_versions():
        want = [predict_tiled(lambda c, n: gather_box(vol, c, (n,) * 3),
                              gen_ref, s, (size,) * 3, 40, 17, MS_X, MS_Y,
                              batch_size=64, device=dev) for s in starts]
    owner = {}
    for i, s in enumerate(starts):
        for c in plan_tiles(s, (size,) * 3, 40, 17).corners:
            owner[c] = i if owner.get(c, i) == i else "shared"

    with tempfile.TemporaryDirectory() as tmp:
        meta = ExportMeta(buffer=17, outdimsize=40, meanstd_x=MS_X,
                          meanstd_y=MS_Y, dimsize=74, is3d=True, wf=8)
        model_dir = os.path.join(tmp, "models", "smoke", "v1")
        export_generator(gen_ref, meta, model_dir)
        npy = os.path.join(tmp, "vol.npy")
        np.save(npy, vol)
        locations = {"numpy": npy}
        if have["tensorstore"]:
            ng = write_ng_volume(os.path.join(tmp, "ng"), vol)
            locations["tensorstore"] = ng
            tsv, npv = TensorstoreVolume(ng), NumpyVolume(vol)
            t0 = time.perf_counter()
            mismatched = sum(
                not np.array_equal(tsv.read(c, (74,) * 3),
                                   npv.read(c, (74,) * 3))
                for c in owner)
            rec["checks"]["tensorstore_reads_equal_numpy"] = {
                "corners": len(owner), "mismatched": mismatched,
                "seconds": time.perf_counter() - t0, "ok": mismatched == 0}
        else:
            rec["not_run"]["tensorstore"] = [
                "TensorstoreVolume reads against NumpyVolume",
                "ModelService over a file:// ng volume",
                "predict_ng_cube over tensorstore",
                "the predictors over tensorstore"]

        svc = ModelService(model_root=os.path.join(tmp, "models"),
                           device=dev)
        svc.start()

        def request(i, loc, tag):
            cfg = {"location": loc, "start": list(starts[i]),
                   "glbstart": [0, 0, 0], "size": [size] * 3,
                   "model_name": "smoke:v1",
                   "dest": os.path.join(tmp, f"{tag}{i}")}
            t0 = time.perf_counter()
            body = urllib.request.urlopen(urllib.request.Request(
                svc.url + "/", data=json.dumps(cfg).encode(),
                headers={"Content-type": "application/json"}),
                timeout=600).read()
            if body != b"success":
                fail("serve_ng", f"{tag} request {i} answered {body!r}")
            return time.perf_counter() - t0

        reset_counts()
        rec["served"] = {}
        try:
            for kind, loc in locations.items():
                backend = open_volume(loc)
                with host_timers(backend, owner.get) as (reads, writes):
                    walls = {0: request(0, loc, kind)}
                    t0 = time.perf_counter()
                    with cf.ThreadPoolExecutor(max_workers=5) as ex:
                        futs = {i: ex.submit(request, i, loc, kind)
                                for i in range(1, len(starts))}
                        walls.update({i: f.result(timeout=900)
                                      for i, f in futs.items()})
                    wall = time.perf_counter() - t0
                if open_volume(loc) is not backend:
                    fail("serve_ng", f"open_volume did not cache {loc}")
                per = []
                for i, s in enumerate(starts):
                    got, n_blocks = read_ng_blocks(
                        os.path.join(tmp, f"{kind}{i}"), s, (size,) * 3)
                    dest = os.path.join(tmp, f"{kind}{i}")
                    per.append({"start": list(s), "wall_s": walls[i],
                                "read_s": reads.get(i, 0.0),
                                "write_s": writes.get(dest, 0.0),
                                "blocks": n_blocks, **bar(got, want[i])})
                rec["served"][kind] = {
                    "backend": type(backend).__name__,
                    "concurrent_wall_s": wall,
                    "tiles_per_s": 5 * (-(-size // 36)) ** 3 / wall,
                    "shared_corner_read_s": reads.get("shared", 0.0),
                    "requests": per,
                    "ok": all(r["ok"] and r["blocks"] == 8 for r in per)}
        finally:
            svc.stop()

        # predict_ng_cube, the data service and the predictors
        s1 = starts[1]
        if have["tensorstore"]:
            rec["checks"]["predict_ng_cube_tensorstore"] = bar(
                predict_ng_cube(locations["tensorstore"], s1, (size,) * 3,
                                gen_ref, MS_X, MS_Y, outdimsize=40,
                                buffer=17, device=dev), want[1])
        data_svc = None
        if have["requests"]:
            data_svc = DataService()
            data_svc.start()
        else:
            rec["not_run"]["requests"] = [
                "predict_ng_cube through the DataService"]
        try:
            if data_svc is not None:
                for kind, loc in locations.items():
                    rec["checks"][f"predict_ng_cube_data_service_{kind}"] = bar(
                        predict_ng_cube(loc, s1, (size,) * 3, gen_ref, MS_X,
                                        MS_Y, data_svc.url, outdimsize=40,
                                        buffer=17, device=dev), want[1])
            # the predictors: over tensorstore, else through the service
            if have["tensorstore"]:
                inst = {"location": locations["tensorstore"],
                        "cloudrun": None}
            elif data_svc is not None:
                inst = {"location": npy, "cloudrun": data_svc.url}
            else:
                inst = None
                rec["not_run"]["predictors"] = "neither tensorstore nor "\
                    "requests"
            if inst is not None:
                inst.update(start=list(s1), size=[size] * 3)
                rec["predictors_source"] = (
                    "tensorstore" if inst["cloudrun"] is None
                    else "data_service")
                pred = TransferEMPredictor.from_path(model_dir, device=dev)
                try:
                    (b64,) = pred.predict([dict(inst)])
                finally:
                    pred.close()
                import base64
                rec["checks"]["transfer_em_predictor"] = bar(
                    np.frombuffer(base64.b64decode(b64), np.uint8).reshape(
                        (size,) * 3), want[1])
                ng_root = os.path.join(tmp, "ng_out")
                pred = NgOutputPredictor.from_path(model_dir, device=dev,
                                                   dest_root=ng_root)
                try:
                    (url,) = pred.predict([dict(inst)])
                finally:
                    pred.close()
                (run,) = os.listdir(ng_root)
                info = json.load(open(os.path.join(ng_root, run, "info")))
                scale = info["scales"][0]
                got, n_blocks = read_ng_blocks(
                    os.path.join(ng_root, run, "64_64_64"), (0, 0, 0),
                    (size,) * 3)
                info_ok = (info["data_type"] == "uint8"
                           and info["num_channels"] == 1
                           and scale["size"] == [size] * 3
                           and scale["chunk_sizes"] == [[64, 64, 64]]
                           and scale["encoding"] == "raw"
                           and scale["key"] == "64_64_64")
                out = bar(got, want[1])
                out.update(blocks=n_blocks, info_ok=info_ok,
                           url_ok=f"precomputed://{ng_root}" in url)
                out["ok"] = (out["ok"] and info_ok and out["url_ok"]
                             and n_blocks == 8)
                rec["checks"]["ng_output_predictor"] = out
        finally:
            if data_svc is not None:
                data_svc.stop()
    launches = read_counts()
    rec["launches"] = launches
    rec["phase_s"] = time.perf_counter() - t_phase
    rec["ok"] = bool(
        all(v["ok"] for v in rec["served"].values())
        and all(v["ok"] for v in rec["checks"].values())
        and all(launches[k] > 0 for k in counters()))
    emit(rec)
    return rec


# -- phase 6: large-volume inference (predict_volume) ------------------------

# bench_infer.py's request: a 360^3 region at (20, 20, 20) of a 400^3
# volume, 1000 tiles of 36^3 at B=128 in the tile-grid modes.
VOL_SIDE, VOL_START, VOL_SIZE, VOL_B = 400, (20, 20, 20), (360,) * 3, 128
# Stream budgets: bench_infer.py's 160 MB, which holds this request in one
# chunk (398^3 bytes, 63 MB); and 120 * 398^2 bytes (19 MB), five chunks of
# 360 x 360 x 72 (200 tiles each), so that the pipeline overlaps; and the
# haloed block of a 360 x 144 x 36 chunk (40 tiles, fewer than the batch:
# 30 chunks), where each chunk runs at its own batch on CUDA.
SMALL_CHUNK = (360, 144, 36)
VOL_BUDGETS = {"stream": 160 << 20, "stream_5_chunks": 120 * 398 ** 2,
               "stream_40_tile_chunks": math.prod(c + 2 * 19
                                                  for c in SMALL_CHUNK)}
VOL_SWEEP = (64, 128, 256)
SENTINELS = (0xA5, 0x5A)  # stream's exactness runs, one call each
# device mode from the host array at this request before its copies moved
# in slabs through pinned slots (one pageable copy each way around the
# batch loop): median of 7 calls, NVIDIA H100 80GB HBM3 at 700 W
VOL_DEVICE_BEFORE_MVOX = 237.5
VOL_COPY_COUNTS = ("volume_slabs_in", "volume_slabs_out", "volume_pageable")


def volume_copy_counts():
    """The volume modes' copy counts (``telemetry``): slabs uploaded and
    downloaded through device mode's staging, calls copied whole."""
    from transfer_em_tpu_torch import telemetry
    counts = telemetry.totals()["counts"]
    return {k: counts.get(k, 0) for k in VOL_COPY_COUNTS}


def poison_pinned(shapes, fill, n=4):
    """Fill the pinned host blocks the caching host allocator holds for
    uint8 tensors of ``shapes`` (and more, up to ``n`` a shape) with
    ``fill``, then free them: the next pinned allocations of those shapes
    start from ``fill``, not from an earlier call's data."""
    held = [torch.full(shape, fill, dtype=torch.uint8, pin_memory=True)
            for shape in shapes for _ in range(n)]
    del held


def _timed(run, reps=3):
    """One warm call, then ``reps`` synchronised calls with the launch
    counts zeroed just before them: (last result, seconds per call, peak
    device memory of the timed calls, launches of the timed calls)."""
    run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = read_counts()
    return out, times, torch.cuda.max_memory_allocated(), launches


def _u8_diff(got, want):
    diff = np.abs(np.asarray(got).astype(np.int16)
                  - np.asarray(want).astype(np.int16))
    return int(diff.max()), float((diff > 0).mean())


def check_volume(dev, smi):
    """predict_volume on the card at bench_infer.py's request: device (from
    the host array, its copies in slabs: counted against the schedule, the
    pinned bytes held bounded and made once), slab (the volume uploaded
    once), stream (np.memmap source and out=, at two budgets) and tiles,
    f32, one warm and 3 timed calls each (wall, Mvox/s,
    tiles/s, peak memory, launches: every f32 mode's transposed convs on
    the phase conv and its down convs on the down4 kernel, none on cuDNN's,
    and no weight packed after the warm call) and one profiled call; under
    cudnn.deterministic stream (behind sentinels), auto and tiles bit-equal
    to device; device and slab within one level on at most 1e-3 of the
    voxels of the same mode through the plain versions; bf16 device against
    f32 (PSNR >= 40 dB, not equal, bf16 conv3 launches only, its transposed
    and down convs on cuDNN's); every kernel
    call of one slab forward against its plain version at its shape;
    device mode at B in VOL_SWEEP."""
    from transfer_em_tpu_torch.infer import plan_tiles, predict_volume
    from transfer_em_tpu_torch.infer.device_stitch import (
        SLOT_BYTES, SLOTS, pinned_staging_bytes, slab_schedule)
    from transfer_em_tpu_torch.infer.stream import plan_chunks
    from transfer_em_tpu_torch.infer.tiling import tile_batch
    from transfer_em_tpu_torch.models import UNetGenerator
    from transfer_em_tpu_torch.ops import cuda_kernels as ck

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    gen = seeded_generator(3, dev)
    vol = smooth_volume(VOL_SIDE, seed=31, dev=dev)
    t0 = time.perf_counter()
    vol_d = torch.from_numpy(vol).to(dev)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    nvox = math.prod(VOL_SIZE)
    n_tiles = plan_tiles(VOL_START, VOL_SIZE, 40, 17).num_tiles
    args = (VOL_START, VOL_SIZE, MS_X, MS_Y)
    rec = {"phase": "volume", "card": smi, "request": {
        "volume": [VOL_SIDE] * 3, "start": VOL_START, "size": VOL_SIZE,
        "tiles": n_tiles, "batch": VOL_B, "wf": 8, "dtype": "float32"},
        "upload_s": upload_s, "chunks": {
            k: plan_chunks(VOL_START, VOL_SIZE, 40, 17, b).num_chunks
            for k, b in VOL_BUDGETS.items()}}
    small = plan_chunks(VOL_START, VOL_SIZE, 40, 17,
                        VOL_BUDGETS["stream_40_tile_chunks"])
    chunk_tiles = plan_tiles((0, 0, 0), small.chunk, 40, 17).num_tiles
    if small.chunk != SMALL_CHUNK or chunk_tiles >= VOL_B:
        fail("volume", f"the small budget plans {small.chunk} chunks of "
             f"{chunk_tiles} tiles")
    # C2: tiles computed at each chunk's own batch against the request's
    c2 = {"budget": VOL_BUDGETS["stream_40_tile_chunks"],
          "chunk": list(small.chunk), "chunks": small.num_chunks,
          "chunk_tiles": chunk_tiles,
          "chunk_batch": tile_batch(chunk_tiles, VOL_B),
          "request_tiles": n_tiles,
          "tiles_computed_at_chunk_batch":
              small.num_chunks * -(-chunk_tiles // tile_batch(
                  chunk_tiles, VOL_B)) * tile_batch(chunk_tiles, VOL_B),
          "tiles_computed_at_request_batch":
              small.num_chunks * -(-chunk_tiles // VOL_B) * VOL_B}
    with tempfile.TemporaryDirectory() as tmp:
        src = np.memmap(os.path.join(tmp, "src.u8"), np.uint8, "w+",
                        shape=vol.shape)
        src[:] = vol
        src.flush()
        out_mm = np.memmap(os.path.join(tmp, "out.u8"), np.uint8, "w+",
                           shape=VOL_SIZE[::-1])

        def mode_run(mode, source=vol_d, g=gen, bsz=VOL_B, **kw):
            return lambda: predict_volume(source, g, *args, mode=mode,
                                          batch_size=bsz, device=dev, **kw)

        runs = {"device": mode_run("device", vol), "slab": mode_run("slab")}
        for name, budget in VOL_BUDGETS.items():
            runs[name] = mode_run("stream", src, max_block_bytes=budget,
                                  out=out_mm)
        runs["tiles"] = mode_run("tiles", vol)
        modes, outs = {}, {}
        for name, run in runs.items():
            copies0 = volume_copy_counts()
            out, times, peak, launches = _timed(run)
            copies = {k: v - copies0[k]
                      for k, v in volume_copy_counts().items()}
            med = sorted(times)[len(times) // 2]
            outs[name] = np.array(out)
            modes[name] = {"wall_s": times, "median_s": med,
                           "mvox_per_s": nvox / med / 1e6,
                           "tiles_per_s": n_tiles / med,
                           "peak_memory_gb": peak / 1e9,
                           "launches": launches,
                           "volume_copies": copies,
                           "profiled": profile_round(run)}
            emit({"phase": "volume_mode", "mode": name, **modes[name]})
        rec["modes"] = modes
        # device mode from the host array moves every call's copies in the
        # schedule's slabs (the warm call and 3 timed ones), none whole;
        # its pinned slots are made once and bounded
        slabs = slab_schedule(plan_tiles(VOL_START, VOL_SIZE, 40, 17),
                              tile_batch(n_tiles, VOL_B), VOL_SIDE)
        want_copies = {
            "volume_slabs_in": 4 * sum(z1 > z0 for (z0, z1), _ in slabs),
            "volume_slabs_out": 4 * sum(o1 > o0 for _, (o0, o1) in slabs),
            "volume_pageable": 0}
        pinned = pinned_staging_bytes()
        rec["device_copies"] = {
            "slabs_per_call": [[list(i), list(o)] for i, o in slabs],
            "counts": modes["device"]["volume_copies"],
            "expected": want_copies,
            "pinned_staging_bytes": pinned,
            "pinned_staging_bound": 2 * SLOTS * SLOT_BYTES,
            "device_mvox_per_s": modes["device"]["mvox_per_s"],
            "device_mvox_per_s_before": VOL_DEVICE_BEFORE_MVOX}
        emit({"phase": "volume_copies", **rec["device_copies"]})
        # every f32 mode runs its narrow k3 layers in the kw form, its
        # transposed convs as the phase conv and its down convs on the down4
        # kernel, and packs no weight after its warm call
        launches_ok = all(
            m["launches"][k] > 0 for m in modes.values()
            for k in (*counters(), "conv3_tc", "conv3_tc_kw",
                      "conv3_direct", "transpose_phase", "down_k4",
                      "down4")) and all(
            m["launches"][k] == 0 for m in modes.values()
            for k in ("transpose_cudnn", "down_cudnn", "conv3_weight_packs",
                      "down4_weight_packs"))
        # the narrow f32 layers' launches in the kw form, by mode
        rec["conv3_tc_kw"] = {name: m["launches"]["conv3_tc_kw"]
                              for name, m in modes.items()}

        # exactness: the tile-grid modes bit-equal under cuDNN's
        # deterministic algorithms (its defaults need not repeat bit for
        # bit; tools/train_repeat_probe.py).  Each stream budget runs twice,
        # into an out= and pinned host blocks filled first with one of two
        # sentinels, so that no voxel of an earlier call can pass for this
        # one's: a dropped chunk write or a write before its download landed
        # reads a sentinel, and no voxel equals both.
        with cudnn_deterministic():
            exact = {name: np.array(runs[name]())
                     for name in ("device", "tiles")}
            exact["auto"] = mode_run("auto", vol)()
            # C2: device mode at the small chunks' own batch
            exact["device_at_chunk_batch"] = np.array(mode_run(
                "device", bsz=c2["chunk_batch"])())
            for name, budget in VOL_BUDGETS.items():
                plan = plan_chunks(VOL_START, VOL_SIZE, 40, 17, budget)
                for fill in SENTINELS:
                    poison_pinned((plan.chunk[::-1], plan.block[::-1]), fill)
                    out_mm[:] = fill
                    exact[f"{name}_{fill:#x}"] = np.array(runs[name]())
        ref = exact["device"]
        equal = {k: bool(np.array_equal(v, ref)) for k, v in exact.items()
                 if k != "device"}
        rec["bit_equal_to_device"] = equal
        rec["differing_voxels_vs_device"] = {
            k: int((v != ref).sum()) for k, v in exact.items()
            if k != "device"}
        c2["device_bit_equal_at_chunk_batch"] = equal["device_at_chunk_batch"]
        c2["stream_bit_equal"] = all(
            v for k, v in equal.items()
            if k.startswith("stream_40_tile_chunks"))
        rec["c2_chunk_batch"] = c2
    slab_diff = _u8_diff(outs["slab"], ref)
    rec["slab_vs_device"] = {"u8_max_diff": slab_diff[0],
                             "u8_frac_differing": slab_diff[1]}

    # the plain versions, the same modes
    with plain_versions():
        plain = {name: runs[name]() for name in ("device", "slab")}
    rec["vs_plain"] = {}
    for name, want in plain.items():
        worst, frac = _u8_diff(exact["device"] if name == "device"
                               else outs["slab"], want)
        rec["vs_plain"][name] = {"u8_max_diff": worst,
                                 "u8_frac_differing": frac}
    plain_ok = all(v["u8_max_diff"] <= 1 and v["u8_frac_differing"] <= 1e-3
                   for v in rec["vs_plain"].values())

    # bf16: the same weights, activations in bf16.  C1: its conv3 weights
    # pack on the first call only (6 tensor-core layers), and the output
    # equals the one with the pack cache cleared before the call.
    gen16 = UNetGenerator(wf=8, compute_dtype="bfloat16")
    gen16.load_state_dict(gen.state_dict())
    gen16 = gen16.to(dev).eval()
    run16 = mode_run("device", g=gen16)
    packs16, outs16 = [], []
    with cudnn_deterministic():
        for clear in (False, False, False, True):
            if clear:
                for p in gen16.parameters():
                    getattr(p.untyped_storage(), "_conv3_packs", {}).clear()
            packs0 = read_counts()["conv3_weight_packs"]
            outs16.append(np.array(run16()))
            packs16.append(read_counts()["conv3_weight_packs"] - packs0)
    rec["c1_bf16_packs"] = {
        "packs_per_call": packs16[:3], "packs_cache_cleared": packs16[3],
        "bit_equal_to_cache_cleared": all(
            np.array_equal(o, outs16[3]) for o in outs16[:3])}
    c1_ok = (packs16 == [6, 0, 0, 6]
             and rec["c1_bf16_packs"]["bit_equal_to_cache_cleared"])
    del outs16
    out16, times16, peak16, launches16 = _timed(run16)
    med16 = sorted(times16)[1]
    diff16 = _u8_diff(out16, ref)
    rec["bf16_device"] = {"wall_s": times16, "mvox_per_s": nvox / med16 / 1e6,
                          "peak_memory_gb": peak16 / 1e9,
                          "psnr_db_vs_f32": psnr(out16, ref),
                          "u8_max_diff_vs_f32": diff16[0],
                          "u8_frac_differing_vs_f32": diff16[1],
                          "launches": launches16}
    # bf16 ran: every conv3 launch on bf16 operands, none in f32 device
    # mode, and the output is not f32's
    bf16_ok = (rec["bf16_device"]["psnr_db_vs_f32"] >= 40
               and launches16["conv3_bf16"] == launches16["conv3"] > 0
               and launches16["conv3_tc_kw"] == 0
               and launches16["transpose_cudnn"] > 0
               and launches16["transpose_phase"] == 0
               and launches16["down_cudnn"] > 0
               and launches16["down_k4"] == launches16["down4"] == 0
               and modes["device"]["launches"]["conv3_bf16"] == 0
               and diff16[0] > 0)
    del gen16, out16

    # batch sweep, device mode over the volume on the card (in place: no
    # slab uploaded)
    rec["batch_sweep"] = {}
    for bsz in VOL_SWEEP:
        copies0 = volume_copy_counts()
        _, times, peak, _ = _timed(mode_run("device", bsz=bsz))
        med = sorted(times)[1]
        rec["batch_sweep"][bsz] = {
            "wall_s": times, "median_s": med,
            "mvox_per_s": nvox / med / 1e6, "peak_memory_gb": peak / 1e9,
            "slabs_in": volume_copy_counts()["volume_slabs_in"]
            - copies0["volume_slabs_in"]}
    copies_ok = (rec["device_copies"]["counts"] == want_copies
                 and all(v["slabs_in"] == 0
                         for v in rec["batch_sweep"].values())
                 and 0 < pinned == pinned_staging_bytes()
                 <= 2 * SLOTS * SLOT_BYTES)

    # every kernel call of one slab forward, at its own shape, against its
    # plain version: conv3 and down4 f32 (each layer's epilogue; 1e-4
    # max(1, |ref|)), LeakyReLU (bit-identical), preprocess (1e-6),
    # postprocess (ties)
    with recorded_calls() as calls:
        predict_volume(vol_d, gen, VOL_START, VOL_SIZE[:2] + (40,), MS_X,
                       MS_Y, mode="slab", device=dev)
    torch.cuda.synchronize()
    del vol_d, gen
    torch.cuda.empty_cache()
    layer = {(c, o): n for n, _, c, o, _ in CONV_LAYERS}
    down = {(c, o): n for n, _, c, o in DOWN_CONV_CASES[:2]}
    g = torch.Generator(device=dev).manual_seed(41)
    slab_kernels = []
    for call in calls:
        kind, shape = call[:2]
        if kind == "conv3":
            c, o, act = shape[-1], call[2], call[3]
            slab_kernels.append(_conv3_case(
                dev, g, torch.float32, 1e-4,
                "slab." + layer.get((c, o), f"{c}to{o}"),
                shape[:-1], c, o, act))
            continue
        if kind == "down4":
            c, o, act = shape[-1], call[2], call[3]
            k = _down4_case(dev, g, "slab." + down.get((c, o), f"{c}to{o}"),
                            shape[:-1], c, o, act=act)
            emit({"phase": "kernel", **k})
            slab_kernels.append(k)
            torch.cuda.empty_cache()
            continue
        if kind == "leaky_relu":
            k = _leaky_case(torch.randn(shape, generator=g, device=dev))
        elif kind == "preprocess_u8":
            k = _pre_case(torch.randint(0, 256, shape, generator=g,
                                        device=dev, dtype=torch.uint8))
        else:  # postprocess: B * OD thread blocks (40 at the slab's shape)
            tpad = call[2]
            y = torch.randn(shape, generator=g, device=dev)
            k = post_check(y, tpad)
            n_out = shape[0] * math.prod(s - 2 * tpad for s in shape[1:4])
            b_ms, b_by = bound(n_out * 5, 5.0 * n_out, torch.float32)
            t = (slice(None),) + tuple(slice(tpad, s - tpad)
                                       for s in shape[1:4]) + (0,)
            lib = lambda: (y[t] * MS_Y[1] + MS_Y[0] + 1.0).mul(
                127.5).round().clamp(0, 255).to(torch.uint8)
            k.update({
                "tpad": tpad, "blocks": shape[0] * (shape[1] - 2 * tpad),
                "ms": cuda_ms(lambda: ck.postprocess_u8(y, MS_Y, tpad), 20),
                "plain_ms": cuda_ms(
                    lambda: ck.postprocess_u8_plain(y, MS_Y, tpad), 20),
                "library_ms": cuda_ms(lib, 20),
                "graph_ms": graph_ms(lambda: ck.postprocess_u8(y, MS_Y, tpad)),
                "library_graph_ms": graph_ms(lib), "bound_ms": b_ms,
                "bound_by": b_by})
        k.update(kernel=kind, layer="slab." + kind, shape=list(shape))
        emit({"phase": "kernel", **k})
        slab_kernels.append(k)
        torch.cuda.empty_cache()
    rec["slab_kernels"] = slab_kernels
    slab_counts = {n: sum(k["kernel"] == n for k in slab_kernels)
                   for n in counters()}
    slab_counts["down4"] = sum(k["kernel"] == "down4" for k in slab_kernels)
    rec["slab_kernel_checks"] = slab_counts
    slab_ok = (all(k["ok"] for k in slab_kernels)
               and slab_counts["conv3"] == len(CONV_LAYERS)
               and slab_counts["down4"] == len(down)
               and all(slab_counts.values()))

    rec["launches"] = {k: sum(m["launches"][k] for m in modes.values())
                       for k in modes["device"]["launches"]}
    rec["phase_s"] = time.perf_counter() - t_phase
    rec["ok"] = bool(
        all(equal.values()) and plain_ok and launches_ok and bf16_ok
        and c1_ok and slab_ok and copies_ok and float(np.std(ref)) > 2.0)
    emit(rec)
    return rec


# -- phases 7-8: the train step -----------------------------------------------

TREES = ("gg", "gf", "dx", "dy")


def smooth_batches(n, std, seed, dev, ndim=3):
    """Two seeded (n, 74, 74, 74, 1) float32 batches on the card (ndim=2:
    (n, 74, 74, 1)): uniform noise smoothed by two 3^n box filters (like
    the serve volume), standardized to mean 0 and ``std``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    v = torch.rand((2 * n, 1) + (74,) * ndim, generator=g, device=dev)
    pool = F.avg_pool3d if ndim == 3 else F.avg_pool2d
    for _ in range(2):
        v = pool(v, 3, stride=1, padding=1, count_include_pad=False)
    v = ((v - v.mean()) / v.std() * std).movedim(1, -1).contiguous()
    return v[:n], v[n:]


def redraw(state, seed):
    """Every parameter drawn again on the card: kernels with std
    1/sqrt(fan-in), 1-D params N(0, 0.1).  All four networks' outputs and
    gradients are then O(1); at the N(0, 0.02) init the discriminators'
    gradients sit at float32 rounding level, too small to compare."""
    g = torch.Generator(device=state.gg.stem.kernel.device).manual_seed(seed)
    with torch.no_grad():
        for t in TREES:
            for p in getattr(state, t).parameters():
                std = 0.1 if p.dim() == 1 else math.prod(p.shape[:-1]) ** -0.5
                p.copy_(torch.randn(p.shape, generator=g, device=p.device)
                        * std)


def expected_step_counts(state):
    """Launches and weight packs per train step, derived from the networks:
    with batched_apps each generator runs twice (round 1 on 2B tiles, then
    its cycle) and each discriminator twice (real + detached fake, then
    frozen on the fake).  A k3 conv launches conv3 on the path its (C, O)
    picks; a standalone LeakyReLU follows each DownBlock's k4 conv and
    UpBlock's transposed conv (two with use_norm), each 1x1 conv +
    LeakyReLU, and the discriminator's double LeakyReLU.  Each tensor-core
    weight is packed once a step, after the previous update (the frozen
    discriminators' detached aliases hit that pack)."""
    from transfer_em_tpu_torch.models import Discriminator
    from transfer_em_tpu_torch.models.blocks import (ConvActND, ConvND,
                                                     DownBlock, UpBlock)
    from transfer_em_tpu_torch.ops.convs import conv_form
    from transfer_em_tpu_torch.ops.cuda_conv import conv3_path

    def on_conv3(m):
        x = torch.empty((1, 8, 8, 8, m.kernel.shape[-2]), device="meta")
        return conv_form(x, m.kernel, m.stride, m.padding) == "conv3"

    out = dict.fromkeys(("conv3_tc", "conv3_direct", "leaky_relu",
                         "conv3_weight_packs"), 0)
    for t in TREES:
        net = getattr(state, t)
        per_app = dict.fromkeys(("conv3_tc", "conv3_direct", "leaky_relu"), 0)
        for m in net.modules():
            if isinstance(m, ConvND) and on_conv3(m):
                per_app["conv3_" + conv3_path(*m.kernel.shape[3:])] += 1
            elif isinstance(m, ConvActND):
                per_app["leaky_relu"] += 1
            elif isinstance(m, (DownBlock, UpBlock)):
                per_app["leaky_relu"] += 2 if m.use_norm else 1
        if isinstance(net, Discriminator):
            per_app["leaky_relu"] += 1
        for k, v in per_app.items():
            out[k] += 2 * v
        out["conv3_weight_packs"] += per_app["conv3_tc"]
    out["conv3"] = out["conv3_tc"] + out["conv3_direct"]
    return out


def _grad_errors(state, ref_state):
    """{network: {parameter: max |g - g_ref| / max |g_ref|}}: each
    parameter's gradient against its own largest reference gradient (a
    parameter that got no gradient counts as a zero one)."""
    out = {}
    for t in TREES:
        out[t] = {}
        for (n, p), q in zip(getattr(state, t).named_parameters(),
                             getattr(ref_state, t).parameters()):
            g = p.grad if p.grad is not None else torch.zeros_like(q.grad)
            out[t][n] = ((g - q.grad).abs().max()
                         / q.grad.abs().max().clamp_min(1e-30)).item()
    return out


def _grad_l2(state, ref_state):
    """{network: ||g - g_ref|| / ||g_ref||} over all its parameters (a
    parameter that got no gradient counts as a zero one): the L2 gap, which
    weighs every element where the max-based gap reads the worst one."""
    out = {}
    for t in TREES:
        num = den = 0.0
        for p, q in zip(getattr(state, t).parameters(),
                        getattr(ref_state, t).parameters()):
            g = p.grad if p.grad is not None else torch.zeros_like(q.grad)
            num += float(((g - q.grad).double() ** 2).sum())
            den += float((q.grad.double() ** 2).sum())
        out[t] = (num / max(den, 1e-300)) ** 0.5
    return out


def _worst(errs):
    """Per network, the largest of its parameters' errors."""
    return {t: max(e.values()) for t, e in errs.items()}


@contextlib.contextmanager
def planted_fault(kind):
    """conv3's backward made wrong on purpose, for the train check to show
    that its gradient tolerance catches such a fault: ``dx_dropped`` returns
    no input gradient; ``mask_inverted`` puts the epilogue's LeakyReLU slope
    on the non-negative outputs instead of the negative ones; ``slope_0.2``
    uses slope 0.2 for 0.3 in that mask."""
    from transfer_em_tpu_torch.ops import cuda_conv

    right = cuda_conv._Conv3.__dict__["backward"]

    def wrong(ctx, g):
        x, w, y = ctx.saved_tensors
        if ctx.leaky is not None:
            if kind == "mask_inverted":
                g = torch.where(y >= 0, g * ctx.leaky, g)
            else:
                g = torch.where(y >= 0, g, g * (
                    0.2 if kind == "slope_0.2" else ctx.leaky))
        dx, dw = cuda_conv.conv3_backward(x, w.to(x.dtype), g,
                                          *ctx.needs_input_grad[:2])
        return ((None if kind == "dx_dropped" else dx),
                None if dw is None else dw.to(w.dtype), None)

    cuda_conv._Conv3.backward = staticmethod(wrong)
    try:
        yield
    finally:
        cuda_conv._Conv3.backward = right


# The train check's gradient tolerance: every parameter's gradient within
# GRAD_TOL of its own largest |g| in the plain step.  The float32 conv3
# kernel's outputs differ from cuDNN's by up to ~1e-5 of a layer's largest
# output (3xTF32 summed in the tensor cores; the kernel phase's rel_err),
# and the step's gradients are not smooth in the forward: a LeakyReLU input
# or a cycle difference |real - cycled| that sits within that error of 0
# sends a different gradient back.  The check measures how far that moves
# the gradients in the same run (``noise_floor``): the plain step against
# itself with every conv3 output times (1 + 1e-5 N(0, 1)), over NOISE_SEEDS,
# the largest reading per parameter; and what three planted faults in
# conv3's backward read (``faults``).  GRAD_TOL sits between the two: on
# an H100 80GB HBM3 at 700 W the floor read 1.3e-2 to 2.4e-2 by network,
# the weakest fault (slope_0.2) 0.19 to 0.36, and the kernels' step 1.1e-4
# to 7.6e-3.  The check fails unless every fault reads above GRAD_TOL in
# every network.
GRAD_TOL = 5e-2
NOISE = 1e-5
NOISE_SEEDS = (5, 6, 7)
FAULTS = ("dx_dropped", "mask_inverted", "slope_0.2")


@contextlib.contextmanager
def leaky_gates(gates, replay=False):
    """The models' LeakyReLU gates (pre-activation >= 0) of every conv3
    epilogue and standalone LeakyReLU, in call order: recorded into the
    list ``gates``, or (``replay``) applied from it in that order in place
    of the ones each call computes: where(gate, v, v * slope) on the
    pre-activation v, which is the plain versions' function wherever the
    gate agrees with v >= 0, and has the same gradient rule."""
    from transfer_em_tpu_torch.models import blocks
    from transfer_em_tpu_torch.ops import convs

    replayed = iter(gates)

    def gated_conv3(conv3):
        def f(x, w, slope=None):
            if slope is None:
                return conv3(x, w)
            if not replay:
                y = conv3(x, w, slope)
                gates.append(y >= 0)
                return y
            v = conv3(x, w)
            return torch.where(next(replayed), v, v * slope)
        return f

    def gated_leaky(leaky):
        def f(x, slope):
            if not replay:
                gates.append(x >= 0)
                return leaky(x, slope)
            return torch.where(next(replayed), x, x * slope)
        return f

    # conv_nd's calls, and the blocks' LeakyReLU (after a transposed conv)
    saved = [(convs, "conv3", convs.conv3),
             (blocks, "leaky_relu", blocks.leaky_relu),
             (convs, "leaky_relu", convs.leaky_relu)]
    for m, n, f in saved:
        setattr(m, n, (gated_conv3 if n == "conv3" else gated_leaky)(f))
    try:
        yield gates
    finally:
        for m, n, f in saved:
            setattr(m, n, f)


# The f32 sums' error bound of a bf16 conv3 output, as a multiple of
# n * 2^-24 * sum|x w| (n = 27 Cin products, each exact in f32): the plain
# version's sums round to nearest (n u), a tensor core's may truncate (2 n u),
# and the bound takes twice the two together's 3 n u, rounded up.
ROUNDING_SLACK = 4.0


def _bf16_bounds(s, slack, slope):
    """The least and the greatest value that a bf16 conv3 output may take
    for an f32 sum within ``slack`` of ``s``: the interval rounded outward
    to bf16 (by the bits: the upper 16 of an f32 are its bf16 value toward
    0), then the epilogue in bf16 as conv3_plain applies it; both steps are
    monotone.  float32 tensors."""
    def outward(v, up):
        bits = v.view(torch.int32) & -65536
        toward_zero = bits.view(torch.float32)
        away = (bits + 65536).view(torch.float32)
        return torch.where(toward_zero == v, v,
                           torch.where((v > 0) == up, away, toward_zero))

    def epilogue(v):
        v = v.to(torch.bfloat16)
        return (v if slope is None else torch.where(v >= 0, v, v * slope)
                ).float()

    return epilogue(outward(s - slack, False)), epilogue(outward(s + slack,
                                                                 True))


@contextlib.contextmanager
def conv3_rounding(outputs, replay=False, misses=None, fault=None):
    """The models' bf16 conv3 outputs, in call order: recorded into the
    list ``outputs`` from the kernels' step, or (``replay``, inside
    plain_versions) checked and taken from it by the plain step.  A
    recorded output is taken where it is a bf16 rounding, epilogue after,
    of a sum within the f32 sums' error bound (ROUNDING_SLACK) of the plain
    version's own f32 sum; elsewhere the plain version's value stays and
    the element counts in ``misses["n"]`` (``misses["of"]`` counts every
    element).  Both steps then run one bf16 function wherever the kernels
    round as a correct conv3 may, and the gradient is the plain version's
    (the recorded value enters as a constant offset).  ``fault``
    ("tap_dropped"): the recorded kernels' conv3 runs with every kernel's
    first tap zeroed, for the check to show that the replay flags it."""
    from transfer_em_tpu_torch.ops import convs, cuda_conv

    conv3 = convs.conv3
    replayed = iter(outputs)

    def recorded(x, w, slope=None):
        if fault == "tap_dropped":
            mask = torch.ones(w.shape[:3], device=w.device)
            mask[0, 0, 0] = 0
            w = w * mask[..., None, None]
        y = conv3(x, w, slope)
        outputs.append(y.detach().clone())
        return y

    def replaying(x, w, slope=None):
        y = conv3(x, w, slope)
        got = next(replayed)
        with torch.no_grad():
            xf, wf = x.float(), w.to(x.dtype).float()
            s = cuda_conv.conv3_plain(xf, wf)
            slack = (ROUNDING_SLACK * 27 * x.shape[-1] * 2.0 ** -24
                     * cuda_conv.conv3_plain(xf.abs(), wf.abs()))
            lo, hi = _bf16_bounds(s, slack, slope)
            got = got.float()
            ok = (got >= lo) & (got <= hi)
            misses["n"] += int((~ok).sum())
            misses["of"] += ok.numel()
            offset = torch.where(ok, got, y.float()) - y.float()
        return (y.float() + offset).to(y.dtype)

    if replay:
        misses.update(n=0, of=0)
    convs.conv3 = replaying if replay else recorded
    try:
        yield outputs
    finally:
        convs.conv3 = conv3


def check_train_plain(dev, kernel_rel_err, wf=8, batch=4,
                      phase="train_check", same_gates=False,
                      use_norm=False):
    """One train step through the kernels and one through the plain
    versions, on the card, from the same state and batches (``wf``,
    ``batch``, dropout off): the 7-loss vectors within rtol 1e-4, every
    parameter's gradient within GRAD_TOL of its own largest |g|; beside
    them the noise floor and the planted faults' readings (see GRAD_TOL),
    and the check fails unless every fault reads above GRAD_TOL in every
    network.  Batches have std 0.3 so that |real - cycled| stays far from
    2, where the focal CE's clip makes the gradient jump; the weights are
    redrawn so that every network's gradients are O(1).

    ``same_gates``: the plain steps (the reference and the noise floor's)
    take the kernels' step's LeakyReLU gates (:func:`leaky_gates`), so the
    two steps differentiate one piecewise-linear function and the
    comparison reads the arithmetic alone; the plain step on its own gates
    is read beside it (``free_gates``: its gradient gap and how many
    gates the two steps set differently), not gated.  A LeakyReLU input
    within the kernels' rounding of 0 (f32 conv3 sums differ from cuDNN's
    by up to ~6e-5 of a layer's largest output at wf=1) flips its gate, and
    one flipped gate moves a whole output channel's weight gradient.
    ``use_norm``: the networks with their InstanceNorm sites on."""
    import copy

    from transfer_em_tpu_torch.config import CycleGANConfig
    from transfer_em_tpu_torch.train import build_step_fn, create_state

    cfg = CycleGANConfig(wf=wf, use_norm=use_norm)
    state = create_state(cfg, seed=1, device=dev)
    redraw(state, 2)
    fresh = copy.deepcopy(state)
    ref_state = copy.deepcopy(fresh)
    x, y = smooth_batches(batch, 0.3, 11, dev)
    step = build_step_fn(cfg, deterministic=True)
    gates = []

    def plain(**kw):  # the reference path, on the kernels' gates if asked
        ctx = contextlib.ExitStack()
        ctx.enter_context(plain_versions(**kw))
        if same_gates:
            ctx.enter_context(leaky_gates(gates, replay=True))
        return ctx

    reset_counts()
    with leaky_gates(gates) if same_gates else contextlib.nullcontext():
        got = step(state, x, y, 0).cpu().numpy()
    launches = read_counts()
    with plain():
        want = step(ref_state, x, y, 0).cpu().numpy()
    loss_rel = float(np.max(np.abs(got - want) / np.abs(want)))
    errs = _grad_errors(state, ref_state)
    free = None
    if same_gates:
        free_state, free_gates = copy.deepcopy(fresh), []
        with plain_versions(), leaky_gates(free_gates):
            step(free_state, x, y, 0)
        flipped = sum(int((a != b).sum()) for a, b in zip(gates, free_gates))
        free = {"grad_max_err_over_own_max": _worst(
                    _grad_errors(state, free_state)),
                "gates": sum(g.numel() for g in gates),
                "gates_flipped": flipped}
        del free_state, free_gates
    del state
    floor = {t: dict.fromkeys(e, 0.0) for t, e in errs.items()}
    for seed in NOISE_SEEDS:
        noisy = copy.deepcopy(fresh)
        with plain(noise=NOISE, seed=seed):
            step(noisy, x, y, 0)
        for t, e in _grad_errors(noisy, ref_state).items():
            for n, v in e.items():
                floor[t][n] = max(floor[t][n], v)
        del noisy
    faults = {}
    for kind in FAULTS:
        broken = copy.deepcopy(fresh)
        with planted_fault(kind):
            step(broken, x, y, 0)
        faults[kind] = _worst(_grad_errors(broken, ref_state))
        del broken
    gates.clear()
    worst = {t: [{"param": n, "err": v, "noise_floor": floor[t][n]}
                 for n, v in sorted(e.items(), key=lambda kv: kv[1])[-3:]]
             for t, e in errs.items()}
    grad = _worst(errs)
    caught = {k: min(v.values()) > GRAD_TOL for k, v in faults.items()}
    rec = {"phase": phase, "wf": wf, "batch": batch, "use_norm": use_norm,
           "same_gates": same_gates, "losses": got.tolist(),
           "plain_losses": want.tolist(), "loss_max_rel_err": loss_rel,
           "loss_rtol": 1e-4, "grad_max_err_over_own_max": grad,
           "grad_tol": GRAD_TOL, "kernel_rel_err": kernel_rel_err,
           "noise": NOISE, "noise_seeds": list(NOISE_SEEDS),
           "noise_floor": _worst(floor), "faults": faults,
           "faults_caught": caught, "worst_params": worst,
           "free_gates": free, "launches": launches}
    rec["ok"] = (loss_rel <= 1e-4
                 and all(v <= GRAD_TOL for v in grad.values())
                 and all(caught.values())
                 and launches["conv3_tc"] > 0 and launches["conv3_direct"] > 0
                 and launches["leaky_relu"] > 0)
    emit(rec)
    return rec


def check_norm_tile_step(dev, dtype, bsz=16):
    """The fused tile step of a wf=8 generator with ``use_norm`` (its
    InstanceNorm sites on; numpy-seeded weights) in ``dtype`` on ``bsz``
    tiles of a smooth volume, through the kernels and through the plain
    versions: within one grey level on at most 1e-3 of the voxels, every
    kernel launching.  Beside it, read and not gated, the plain step's own
    spread: the plain versions with NOISE on conv3's sums (NOISE_SEEDS)
    against the plain step.

    In bf16 that spread is wider than the bar (bf16 InstanceNorm turns a
    conv's last-bit differences into whole levels; on an H100: 7.5%), so
    the plain step there takes the kernels' conv3 outputs where they are
    a correct rounding of its own sums (:func:`conv3_rounding`; the share
    of the rest, ``rounding_misses``, must be 0); the plain step on its own
    roundings is read beside it (``free``), and the replay must flag the
    planted fault ``tap_dropped`` (misses and the share above the bar)."""
    from transfer_em_tpu_torch.infer import make_tile_step

    bf16 = dtype == "bfloat16"
    gen = seeded_generator(66, dev, use_norm=True,
                           compute_dtype=dtype if bf16 else None)
    tiles = _int8_tiles(smooth_volume(INT8_VOL, seed=67, dev=dev), bsz, 68)
    step = make_tile_step(gen, MS_X, MS_Y, 2)
    outs, misses = [], {}
    reset_counts()
    with conv3_rounding(outs) if bf16 else contextlib.nullcontext():
        got = step(tiles)
    launches = read_counts()
    with plain_versions():
        free = step(tiles)
    floor = []
    for seed in NOISE_SEEDS:
        with plain_versions(noise=NOISE, seed=seed):
            floor.append(_u8_diff(step(tiles), free))
    rec = {"dtype": dtype, "batch": bsz, "frac_bar": 1e-3,
           "noise_floor": [{"u8_max_diff": d, "u8_frac_differing": f}
                           for d, f in floor],
           "launches": launches, "output_std": float(got.std())}
    want = free
    caught = True
    if bf16:
        with plain_versions(), conv3_rounding(outs, True, misses):
            want = step(tiles)
        outs.clear()
        rec["free"] = dict(zip(("u8_max_diff", "u8_frac_differing"),
                               _u8_diff(got, free)))
        rec["rounding_misses"] = misses["n"] / misses["of"]
        bad, bad_misses = [], {}
        with conv3_rounding(bad, fault="tap_dropped"):
            broken = step(tiles)
        with plain_versions(), conv3_rounding(bad, True, bad_misses):
            fault = _u8_diff(broken, step(tiles))
        bad.clear()
        rec["fault_tap_dropped"] = {
            "rounding_misses": bad_misses["n"] / bad_misses["of"],
            "u8_max_diff": fault[0], "u8_frac_differing": fault[1]}
        caught = bad_misses["n"] > 0 and fault[1] > 1e-3
        rec["fault_caught"] = caught
    diff, frac = _u8_diff(got, want)
    rec.update(u8_max_diff=diff, u8_frac_differing=frac)
    rec["ok"] = bool(diff <= 1 and frac <= 1e-3 and caught
                     and misses.get("n", 0) == 0
                     and got.shape == (bsz, 36, 36, 36)
                     and all(launches[k] > 0 for k in counters()))
    return rec


def check_use_norm(dev, kernel_rel_err, dtype):
    """``use_norm`` on the card (phases 7 and 11): a train step (wf=8,
    B=4) through the kernels against the plain versions, GRAD_TOL in f32,
    BF16_GRAD_TOL in bf16, and the tile step's uint8 bar."""
    if dtype == "float32":
        train = check_train_plain(dev, kernel_rel_err,
                                  phase="train_check_norm", use_norm=True)
    else:
        train = check_train_bf16_plain(dev, phase="train_bf16_check_norm",
                                       use_norm=True)
    tile = check_norm_tile_step(dev, dtype)
    rec = {"phase": f"use_norm_{dtype}", "train_check_ok": train["ok"],
           "tile_step": tile, "ok": train["ok"] and tile["ok"]}
    emit(rec)
    return rec


def profile_train_step(run):
    """Device time of one train step by kernel and by what launched it
    (torch.profiler, CUPTI): conv3's kernels and LeakyReLU by name; cuDNN's
    kernels by the op that launched them, split into dgrad / wgrad / other
    by kernel name: conv3's backward (traced under a ``conv3.backward``
    range for this step only), the k4, transposed and 1x1 convs' forward
    and backward; the rest is torch's elementwise, reductions and copies."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from transfer_em_tpu_torch.ops import cuda_conv

    plain_bwd = cuda_conv.conv3_backward

    def traced_bwd(*args, **kwargs):
        with record_function("conv3.backward"):
            return plain_bwd(*args, **kwargs)

    cuda_conv.conv3_backward = traced_bwd
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        cuda_conv.conv3_backward = plain_bwd
    by_name = {"conv3_forward_kernels": 0.0, "leaky_relu_kernel": 0.0}
    total = 0.0
    rows = []
    for e in prof.key_averages():
        # device rows; the range's own mirror on the device timeline would
        # count its kernels twice
        if (not str(e.device_type).endswith("CUDA")
                or e.key == "conv3.backward"):
            continue
        us = getattr(e, "self_device_time_total", None)
        ms = (e.self_cuda_time_total if us is None else us) / 1e3
        rows.append((e.key[:100], ms, e.count))
        total += ms
        if "tem::" in e.key and "conv3" in e.key:
            by_name["conv3_forward_kernels"] += ms
        elif "tem::" in e.key and "leaky" in e.key:
            by_name["leaky_relu_kernel"] += ms
    by_op = {}
    for e in prof.events():
        kernels = [k for k in getattr(e, "kernels", ()) if "tem::" not in k.name]
        if not kernels:
            continue
        chain, p = [], e
        while p is not None:
            chain.append(p.name)
            p = p.cpu_parent
        if "conv3.backward" in chain:
            cat = "conv3_backward_cudnn"
        elif any("convolution_backward" in n for n in chain):
            cat = "k4_transposed_1x1_backward_cudnn"
        elif any("convolution" in n for n in chain):
            cat = "k4_transposed_1x1_forward_cudnn"
        else:
            cat = "torch_elementwise_and_other"
        for k in kernels:
            low = k.name.lower()
            sub = "dgrad" if "dgrad" in low else (
                "wgrad" if "wgrad" in low else "other")
            part = by_op.setdefault(cat, {"ms": 0.0})
            part["ms"] += k.duration / 1e3
            part[sub] = part.get(sub, 0.0) + k.duration / 1e3
    attributed = sum(by_name.values()) + sum(v["ms"] for v in by_op.values())
    top = sorted(rows, key=lambda r: -r[1])[:16]
    return {"wall_s": wall, "device_ms": total,
            "device_busy_share": total / 1e3 / wall,
            "by_kernel_name_ms": by_name, "by_launching_op_ms": by_op,
            "unattributed_ms": total - attributed,
            "top": [{"name": n, "ms": ms, "calls": c} for n, ms, c in top]}


def check_train(dev, smi, cfg=None, phase="train"):
    """The default CycleGANConfig (3D, wf=8, 74^3, float32, B=64, dropout
    on), or ``cfg``: create_state and 5 steps of make_train_step on seeded
    smoothed batches (std 1), then one step under the profiler."""
    import statistics

    from transfer_em_tpu_torch.config import CycleGANConfig
    from transfer_em_tpu_torch.train import create_state, make_train_step

    cfg = cfg or CycleGANConfig()
    bsz = cfg.batch_size
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = create_state(cfg, seed=0, device=dev)
    expected = expected_step_counts(state)
    before = {t: [p.detach().clone() for p in getattr(state, t).parameters()]
              for t in TREES}
    x, y = smooth_batches(bsz, 1.0, 12, dev)
    step = make_train_step(cfg, device=dev)
    times, losses, counts = [], [], []
    for _ in range(5):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        loss = step(state, x, y, 0)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts.append(read_counts())
        losses.append(loss.cpu().tolist())
    peak = torch.cuda.max_memory_allocated()
    changed = {t: any(not torch.equal(a, b) for a, b in zip(
        before[t], getattr(state, t).parameters())) for t in TREES}
    median = statistics.median(times[1:])
    trace = profile_train_step(lambda: step(state, x, y, 0))
    totals = {k: sum(c[k] for c in counts) for k in counts[0]}
    counts_ok = all(c[k] == v for c in counts for k, v in expected.items())
    if cfg.compute_dtype == "bfloat16":  # every launch on bf16 operands
        counts_ok = counts_ok and all(
            c["conv3_bf16"] == c["conv3"] and c["leaky_relu_bf16"]
            == c["leaky_relu"] for c in counts)
    finite = bool(np.all(np.isfinite(losses)))
    rec = {"phase": phase, "config": f"CycleGANConfig(compute_dtype="
           f"{cfg.compute_dtype!r}) 3D wf=8 74^3", "batch": bsz,
           "steps": len(times), "step_s": times,
           "median_step_s_2_to_5": median, "tiles_per_s": bsz / median,
           "peak_memory_gb": peak / 1e9, "losses": losses,
           "losses_finite": finite, "trees_changed": changed,
           "per_step_counts": counts, "expected_per_step": expected,
           "counts_ok": counts_ok, "launches": totals,
           "profiled_step": trace, "card": smi}
    rec["ok"] = finite and counts_ok and all(changed.values())
    emit(rec)
    return rec


# -- phase 9: EM2EM, the training entry point --------------------------------

EM_SIDE, EM_CUBES, EM_BATCH, EM_WF = 256, 64, 16, 8


def _state_tensors(state):
    """Every parameter and Adam moment of a train state, in a fixed order,
    and its step and Adam counts."""
    tensors, ints = [], [state.step]
    for t in TREES:
        tensors += list(getattr(state, t).parameters())
        opt = getattr(state, "opt_" + t)
        tensors += [opt.mu[k] for k in sorted(opt.mu)]
        tensors += [opt.nu[k] for k in sorted(opt.nu)]
        ints.append(opt.count)
    return tensors, ints


def _states_equal(a, b):
    ta, ia = _state_tensors(a)
    tb, ib = _state_tensors(b)
    return ia == ib and len(ta) == len(tb) and all(
        torch.equal(x, y) for x, y in zip(ta, tb))


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN restricted to its deterministic algorithms for the block."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


def _epoch_s(datasets):
    """Seconds for one synchronised epoch of the datasets, zipped."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = 0
    for batches in zip(*datasets):
        n += 1
        for b in batches:
            if b.device.type != "cuda":
                fail("em2em", f"a batch came on {b.device}")
    torch.cuda.synchronize()
    return time.perf_counter() - t0, n


def check_em2em(dev, smi):
    """The README quick start in 3D at full width on the card: datasets from
    64 seeded 74^3 cubes of a smoothed 256^3 volume (target; source through
    make_warp_map) and a streaming dataset over corner_stream, 2 epochs of
    EM2EM.train (wf=8, B=16, float32, dropout on, a checkpoint each epoch),
    an auto-restored second model that trains a third epoch bit-equal to
    the first model's uninterrupted one, restore(1)
    into the trained model then predict (against a fresh model restored at
    1), and save_model -> load_generator -> predict_tiled on a 128^3 chunk
    against the plain versions."""
    from transfer_em_tpu_torch import (EM2EM, create_dataset_from_generator,
                                       create_dataset_from_tensors)
    from transfer_em_tpu_torch.data.sources import (_parallel_fetch,
                                                    corner_stream)
    from transfer_em_tpu_torch.infer import (load_generator, predict_tiled,
                                             save_model)
    from transfer_em_tpu_torch.native import gather_box
    from transfer_em_tpu_torch.ops.warp import make_warp_map

    torch.cuda.empty_cache()
    rec = {"phase": "em2em", "config": f"EM2EM(74, is3d=True, wf={EM_WF}) f32",
           "batch": EM_BATCH, "cubes": EM_CUBES, "card": smi}
    vol = smooth_volume(EM_SIDE, seed=21, dev=dev)
    hi = EM_SIDE - 74
    corners = np.random.default_rng(22).integers(0, hi + 1, (EM_CUBES, 3))
    cubes = [vol[z:z + 74, y:y + 74, x:x + 74] for z, y, x in corners]
    fetch = lambda c: vol[c[2]:c[2] + 74, c[1]:c[1] + 74, c[0]:c[0] + 74]

    t0 = time.perf_counter()
    target, ms_y = create_dataset_from_tensors(cubes, batch_size=EM_BATCH,
                                               device=dev)
    source, ms_x = create_dataset_from_tensors(
        cubes, batch_size=EM_BATCH, custom_map=make_warp_map(5), device=dev)
    streamed, ms_s = create_dataset_from_generator(
        lambda: _parallel_fetch(corner_stream(((0, 0, 0), (hi, hi, hi)), 74,
                                              seed=23), fetch, 4),
        batch_size=EM_BATCH, epoch_size=EM_CUBES, device=dev)
    rec["datasets_build_s"] = time.perf_counter() - t0
    rec["meanstd"] = {"x": ms_x, "y": ms_y, "streamed": ms_s}
    pipe_s, pairs = _epoch_s((source, target))
    stream_s, n_stream = _epoch_s((streamed,))
    rec["pipeline"] = {"pair_batches": pairs, "epoch_s": pipe_s,
                       "tiles_per_s": pairs * EM_BATCH / pipe_s,
                       "stream_batches": n_stream, "stream_epoch_s": stream_s,
                       "stream_tiles_per_s": n_stream * EM_BATCH / stream_s}

    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "ckpt")
        log = os.path.join(tmp, "metrics.jsonl")
        model = EM2EM(74, "smoke", wf=EM_WF, checkpoint_root=root,
                      device=dev)
        expected = expected_step_counts(model.state)
        before = {t: [p.detach().clone() for p in
                      getattr(model.state, t).parameters()] for t in TREES}
        per_step = []
        step = model.train_step

        def counted_step(x, y):
            c0 = read_counts()
            out = step(x, y)
            per_step.append({k: v - c0[k] for k, v in read_counts().items()})
            return out

        model.train_step = counted_step
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        model.train(source, target, epochs=2, check_freq=1, metrics_log=log)
        train_s = time.perf_counter() - t0
        model.train_step = step
        epochs = [json.loads(line) for line in open(log)]
        rec["train"] = {
            "wall_s": train_s, "epochs": epochs,
            "tiles_per_s": [e["steps"] * EM_BATCH / e["seconds"]
                            for e in epochs],
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "per_step_counts": per_step, "expected_per_step": expected}
        losses_ok = all(np.isfinite(list(e["loss"].values())).all()
                        for e in epochs)
        changed = {t: any(not torch.equal(a, b) for a, b in zip(
            before[t], getattr(model.state, t).parameters())) for t in TREES}
        counts_ok = len(per_step) == 2 * EM_CUBES // EM_BATCH and all(
            c[k] == v for c in per_step for k, v in expected.items())
        rec["train"].update(losses_finite=losses_ok, trees_changed=changed,
                            counts_ok=counts_ok)

        # auto-restore: a second model of the same experiment
        resumed = EM2EM(74, "smoke", wf=EM_WF, checkpoint_root=root,
                        device=dev)
        restored_equal = _states_equal(resumed.state, model.state)
        # The resumed model trains epoch 3 and the first one the same
        # batches, uninterrupted: they must end bit-equal.  cuDNN's default
        # conv gradients do not repeat bit for bit (tools/
        # train_repeat_probe.py), so both run its deterministic ones.
        steps = EM_CUBES // EM_BATCH
        bx, by = source.take_batches(steps), target.take_batches(steps)
        with cudnn_deterministic():
            resumed.train(bx, by, epochs=1, start=2, check_freq=1,
                          metrics_log=log)
            for x, y in zip(bx, by):
                model.train_step(x, y)
        del bx, by
        third = json.loads(open(log).read().splitlines()[-1])
        rec["resume"] = {"step": resumed.state.step,
                         "restored_bit_equal": restored_equal,
                         "epoch3_cudnn_deterministic": third,
                         "continued_bit_equal": _states_equal(
                             resumed.state, model.state),
                         "losses_finite": bool(np.isfinite(
                             list(third["loss"].values())).all())}

        # restore(1) into the model whose conv3 weights are packed from
        # epoch 3, then predict at once: a stale pack would give epoch 3's.
        # Bit-equality needs cuDNN's deterministic algorithms: the
        # transposed convs' default (a dgrad algorithm) need not repeat
        # bit for bit, which the record shows beside the check.
        x = target.take_batches(1)[0][:4]
        with cudnn_deterministic():
            before = model.predict(x)
            packs0 = read_counts()["conv3_weight_packs"]
            model.restore(1)
            got = model.predict(x)
            packs = read_counts()["conv3_weight_packs"] - packs0
            fresh = EM2EM(74, "fresh", wf=EM_WF, checkpoint_root=root,
                          device=dev, ckpt_restore=os.path.join(
                              model.checkpoint_path, "1"))
            want = fresh.predict(x)
        again = [fresh.predict(x) for _ in range(2)]
        rec["restore_then_predict"] = {
            "packs": packs, "bit_equal_to_fresh": bool(torch.equal(got, want)),
            "differs_from_epoch3": not torch.equal(got, before),
            "default_cudnn_repeat_max_abs_diff":
                (again[0] - again[1]).abs().max().item()}

        # export from the epoch-3 checkpoint and serve a 128^3 chunk
        export = os.path.join(tmp, "export")
        save_model(export, os.path.join(resumed.checkpoint_path, "3"), ms_x,
                   ms_y, 74, True, EM_WF, device=dev)
        gen, meta = load_generator(export, device=dev)
        start, size = (64, 32, 96), (128,) * 3
        args = (lambda c, n: gather_box(vol, c, (n,) * 3), gen, start, size,
                meta.outdimsize, meta.buffer, meta.meanstd_x, meta.meanstd_y)
        t0 = time.perf_counter()
        out = predict_tiled(*args, batch_size=64, device=dev)
        serve_s = time.perf_counter() - t0
        launches = read_counts()
        with plain_versions():
            ref = predict_tiled(*args, batch_size=64, device=dev)
        diff = np.abs(out.astype(int) - ref.astype(int))
        rec["export_serve"] = {"predict_tiled_s": serve_s,
                               "u8_max_diff": int(diff.max()),
                               "u8_frac_differing": float((diff > 0).mean()),
                               "output_std": float(out.std())}
        del model, resumed, fresh, gen
    rec["launches"] = launches
    serve_ok = (rec["export_serve"]["u8_max_diff"] <= 1
                and rec["export_serve"]["u8_frac_differing"] <= 1e-3)
    restore_ok = (packs > 0 and rec["restore_then_predict"][
        "bit_equal_to_fresh"] and rec["restore_then_predict"][
        "differs_from_epoch3"])
    rec["ok"] = bool(
        pairs == EM_CUBES // EM_BATCH and n_stream == EM_CUBES // EM_BATCH
        and losses_ok and all(changed.values()) and counts_ok
        and restored_equal and rec["resume"]["continued_bit_equal"]
        and rec["resume"]["step"] == 3 * EM_CUBES // EM_BATCH
        and rec["resume"]["losses_finite"] and restore_ok and serve_ok
        and all(launches[k] > 0 for k in counters()))
    emit(rec)
    return rec


# -- phase 10: 2D, the README quick start ------------------------------------

TWOD_B, TWOD_TRAIN_B, TWOD_WF = 128, 64, 8
TWOD_SIDE, TWOD_PATCHES = 1024, 256
SUMMARY = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
           "max_abs_err", "graph_ms", "library_graph_ms")


def _twod_leaky_shapes(dev):
    """The shapes of the 2D generator's LeakyReLU calls (every one of its
    activations: in 2D no conv epilogue absorbs one) at TWOD_B tiles, as
    one forward makes them, and that forward's launch count."""
    from transfer_em_tpu_torch.models import UNetGenerator

    gen = UNetGenerator(wf=TWOD_WF, is3d=False).to(dev).eval()
    reset_counts()
    with recorded_calls() as calls, torch.inference_mode():
        gen(torch.zeros((TWOD_B, 74, 74, 1), device=dev))
    launches = read_counts()["leaky_relu"]
    return [c[1] for c in calls if c[0] == "leaky_relu"], launches


def _twod_kernels(dev, gen):
    """preprocess on (B, 74, 74) uint8, postprocess on a rank-4 (B, 40, 40,
    1) batch at tpad 2 (the tile step's) and 0 plus the scalar path's odd
    shapes, LeakyReLU at the 2D generator's activations (B = TWOD_B,
    summed): each against its plain version, timed beside the bound and
    one library call (events and graph replay)."""
    from transfer_em_tpu_torch.ops import cuda_kernels as ck

    out = {}
    x = torch.randint(0, 256, (TWOD_B, 74, 74), generator=gen, device=dev,
                      dtype=torch.uint8)
    rec = _pre_case(x)
    emit({"phase": "twod_kernel", "kernel": "preprocess_u8",
          "shape": list(x.shape), **rec})
    out["preprocess_u8"] = dict(rec, shape=list(x.shape))
    del x

    y = torch.randn((TWOD_B, 40, 40, 1), generator=gen, device=dev)
    post = {}
    for tpad in (2, 0):
        rec = post_check(y, tpad)
        side = 40 - 2 * tpad
        n_out = TWOD_B * side * side
        b_ms, b_by = bound(n_out * 5, 5.0 * n_out, torch.float32)
        win = (slice(None), slice(tpad, 40 - tpad), slice(tpad, 40 - tpad), 0)

        def lib():
            return (y[win] * MS_Y[1] + MS_Y[0] + 1.0).mul(127.5).round() \
                .clamp(0, 255).to(torch.uint8)

        def kern():
            return ck.postprocess_u8(y, MS_Y, tpad)

        rec.update({
            "ms": cuda_ms(kern, 20),
            "plain_ms": cuda_ms(lambda: ck.postprocess_u8_plain(y, MS_Y, tpad),
                                20),
            "library_ms": cuda_ms(lib, 20), "graph_ms": graph_ms(kern),
            "library_graph_ms": graph_ms(lib), "bound_ms": b_ms,
            "bound_by": b_by, "shape": list(y.shape), "tpad": tpad})
        emit({"phase": "twod_kernel", "kernel": "postprocess_u8",
              "path": "vector", **rec})
        post[tpad] = rec
    rec = dict(post[2], tpad0={k: post[0][k] for k in SUMMARY})
    rec["ok"] = post[2]["ok"] and post[0]["ok"]
    for side, tpad, path in ((42, 1, "scalar: odd tpad"),
                             (42, 2, "scalar: OW % 4 != 0")):
        case = post_check(torch.randn((8, side, side, 1), generator=gen,
                                      device=dev), tpad)
        emit({"phase": "twod_kernel", "kernel": "postprocess_u8",
              "path": path, "shape": [8, side, side, 1], "tpad": tpad,
              **case})
        rec["ok"] = rec["ok"] and case["ok"]
    out["postprocess_u8"] = rec
    del y

    shapes, launches = _twod_leaky_shapes(dev)
    tot = {"max_abs_err": 0.0, "ok": len(shapes) == launches > 0,
           "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
           "bound_by": "bytes", "graph_ms": 0.0, "library_graph_ms": 0.0,
           "shapes": [list(s) for s in shapes]}
    for shape in shapes:
        v = torch.randn(shape, generator=gen, device=dev)
        case = _leaky_case(v)
        emit({"phase": "twod_kernel", "kernel": "leaky_relu", "net": "gen2d",
              "shape": list(shape), **case})
        for k in ("ms", "plain_ms", "library_ms", "bound_ms", "graph_ms",
                  "library_graph_ms"):
            tot[k] += case[k]
        tot["max_abs_err"] = max(tot["max_abs_err"], case["max_abs_err"])
        tot["ok"] = tot["ok"] and case["ok"]
        del v
    out["leaky_relu"] = tot
    return out


def _twod_golden(dev):
    """The 2D generator and discriminator (wf=8, kernels on) against the
    frozen TF outputs gen_2d.npz (74^2 -> 40^2) and disc_2d.npz (40^2 ->
    6^2): PSNR >= 40 dB; LeakyReLU must launch and conv3 must not (JAX
    keeps its Pallas conv to 3D)."""
    from transfer_em_tpu_torch.models import Discriminator, UNetGenerator
    from transfer_em_tpu_torch.models.convert import (DISC_ORDER_2D,
                                                      params_from_tf_order)

    res = {}
    for name, net, order in (
            ("gen_2d", UNetGenerator(wf=8, is3d=False), None),
            ("disc_2d", Discriminator(wf=8, is3d=False), DISC_ORDER_2D)):
        data = np.load(os.path.join(ROOT, "tests", "goldens", name + ".npz"))
        net.load_state_dict(params_from_tf_order(data, order) if order
                            else params_from_tf_order(data))
        reset_counts()
        with torch.inference_mode():
            got = net.to(dev).eval()(torch.from_numpy(data["x"]).to(dev))
        launches = read_counts()
        got = got.cpu().numpy()
        res[name] = {"psnr_db": psnr(got, data["y"]),
                     "max_abs_err": float(np.abs(got - data["y"]).max()),
                     "leaky_relu_launches": launches["leaky_relu"],
                     "conv3_launches": launches["conv3"]}
    ok = all(r["psnr_db"] >= 40 and r["leaky_relu_launches"] > 0
             and r["conv3_launches"] == 0 for r in res.values())
    return res, ok


def _twod_train_check(dev):
    """One 2D train step (wf=8, B=4, dropout off) through the kernels and
    one through the plain versions, from the same state and batches: the
    7-loss vectors within rtol 1e-4, every parameter's gradient within
    GRAD_TOL of its own largest |g|."""
    import copy

    from transfer_em_tpu_torch.config import CycleGANConfig
    from transfer_em_tpu_torch.train import build_step_fn, create_state

    cfg = CycleGANConfig(is3d=False, wf=TWOD_WF)
    state = create_state(cfg, seed=1, device=dev)
    redraw(state, 2)
    ref_state = copy.deepcopy(state)
    x, y = smooth_batches(4, 0.3, 11, dev, ndim=2)
    step = build_step_fn(cfg, deterministic=True)
    reset_counts()
    got = step(state, x, y, 0).cpu().numpy()
    launches = read_counts()
    with plain_versions():
        want = step(ref_state, x, y, 0).cpu().numpy()
    loss_rel = float(np.max(np.abs(got - want) / np.abs(want)))
    grad = _worst(_grad_errors(state, ref_state))
    rec = {"batch": 4, "losses": got.tolist(), "plain_losses": want.tolist(),
           "loss_max_rel_err": loss_rel, "loss_rtol": 1e-4,
           "grad_max_err_over_own_max": grad, "grad_tol": GRAD_TOL,
           "launches": launches}
    rec["ok"] = (loss_rel <= 1e-4 and all(v <= GRAD_TOL for v in grad.values())
                 and launches["leaky_relu"] > 0 and launches["conv3"] == 0)
    return rec


def _tile_grid(img, n, out=36, side=74):
    """n tiles of side^2 from a yx image on a grid of stride ``out``."""
    per_row = (img.shape[1] - side) // out + 1
    return np.stack([img[(i // per_row) * out:(i // per_row) * out + side,
                         (i % per_row) * out:(i % per_row) * out + side]
                     for i in range(n)])


def check_twod(dev, smi):
    """The 2D CycleGAN at wf=8, 74^2 -> 40^2, f32: the kernels at the 2D
    shapes, the 2D goldens, a 2D train check, then the README quick start
    on the card (the main path, counted): EM2EM(74, is3d=False, wf=8) on
    TWOD_PATCHES seeded 74^2 patches of a smoothed 1024^2 image (target;
    source through make_warp_map) trains 2 epochs at B=64; a second model
    of the experiment auto-restores bit-equal and trains a third epoch on
    fixed batches, as the first does uninterrupted (bit-equal under
    cudnn.deterministic); save_model(is3d=False) -> load_generator ->
    make_tile_step over 128 tiles of the image with tpad 2, within one
    grey level on at most 1e-3 of the pixels of the same step through the
    plain versions; the same for a seeded 2D generator's export (weights
    of std 1/sqrt(fan-in), whose output spreads over the grey levels
    where three epochs from the N(0, 0.02) init barely leave one).
    preprocess, postprocess and LeakyReLU must launch, conv3 must not."""
    from transfer_em_tpu_torch import EM2EM, create_dataset_from_tensors
    from transfer_em_tpu_torch.config import ExportMeta
    from transfer_em_tpu_torch.infer import (export_generator, load_generator,
                                             make_tile_step, save_model)
    from transfer_em_tpu_torch.ops.warp import make_warp_map

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(40)
    rec = {"phase": "twod", "config": f"EM2EM(74, is3d=False, wf={TWOD_WF}) "
           "f32", "card": smi}
    rec["kernels"] = _twod_kernels(dev, gen)
    rec["golden"], golden_ok = _twod_golden(dev)
    rec["train_check"] = _twod_train_check(dev)

    img = smooth_volume(TWOD_SIDE, seed=41, dev=dev, ndim=2)
    corners = np.random.default_rng(42).integers(0, TWOD_SIDE - 74 + 1,
                                                 (TWOD_PATCHES, 2))
    patches = [img[y:y + 74, x:x + 74] for y, x in corners]
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "ckpt")
        log = os.path.join(tmp, "metrics.jsonl")
        reset_counts()  # the main path's counts run from here
        target, ms_y = create_dataset_from_tensors(
            patches, batch_size=TWOD_TRAIN_B, device=dev)
        source, ms_x = create_dataset_from_tensors(
            patches, batch_size=TWOD_TRAIN_B, custom_map=make_warp_map(5),
            device=dev)
        model = EM2EM(74, "smoke2d", is3d=False, wf=TWOD_WF,
                      checkpoint_root=root, device=dev)
        expected = expected_step_counts(model.state)
        before = {t: [p.detach().clone() for p in
                      getattr(model.state, t).parameters()] for t in TREES}
        per_step, step = [], model.train_step

        def counted_step(x, y):
            c0 = read_counts()
            loss = step(x, y)
            per_step.append({k: v - c0[k] for k, v in read_counts().items()})
            return loss

        model.train_step = counted_step
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model.train(source, target, epochs=2, check_freq=1, metrics_log=log)
        train_s = time.perf_counter() - t0
        model.train_step = step
        epochs = [json.loads(line) for line in open(log)]
        steps = TWOD_PATCHES // TWOD_TRAIN_B
        changed = {t: any(not torch.equal(a, b) for a, b in zip(
            before[t], getattr(model.state, t).parameters())) for t in TREES}
        rec["train"] = {
            "batch": TWOD_TRAIN_B, "patches": TWOD_PATCHES, "wall_s": train_s,
            "epochs": epochs,
            "tiles_per_s": [e["steps"] * TWOD_TRAIN_B / e["seconds"]
                            for e in epochs],
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "per_step_counts": per_step, "expected_per_step": expected,
            "counts_ok": len(per_step) == 2 * steps and all(
                c[k] == v for c in per_step for k, v in expected.items()),
            "losses_finite": all(np.isfinite(list(e["loss"].values())).all()
                                 for e in epochs),
            "trees_changed": changed}

        resumed = EM2EM(74, "smoke2d", is3d=False, wf=TWOD_WF,
                        checkpoint_root=root, device=dev)
        restored_equal = _states_equal(resumed.state, model.state)
        bx, by = source.take_batches(steps), target.take_batches(steps)
        with cudnn_deterministic():
            resumed.train(bx, by, epochs=1, start=2, check_freq=1,
                          metrics_log=log)
            for x, y in zip(bx, by):
                model.train_step(x, y)
        rec["resume"] = {"step": resumed.state.step,
                         "restored_bit_equal": restored_equal,
                         "continued_bit_equal": _states_equal(
                             resumed.state, model.state)}

        exports = {"trained": os.path.join(tmp, "trained"),
                   "seeded": os.path.join(tmp, "seeded")}
        save_model(exports["trained"], os.path.join(resumed.checkpoint_path,
                                                    "3"),
                   ms_x, ms_y, 74, False, TWOD_WF, device=dev)
        meta = ExportMeta(buffer=17, outdimsize=40, meanstd_x=MS_X,
                          meanstd_y=MS_Y, dimsize=74, is3d=False, wf=TWOD_WF)
        export_generator(seeded_generator(43, dev, is3d=False), meta,
                         exports["seeded"])
        tiles = _tile_grid(img, TWOD_B)
        rec["tile_step"], outs, steps_2d = {}, {}, {}
        for name, path in exports.items():
            g2d, meta = load_generator(path, device=dev)
            steps_2d[name] = make_tile_step(g2d, meta.meanstd_x,
                                            meta.meanstd_y, 2, device=dev)
            outs[name] = steps_2d[name](tiles)
            times = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                steps_2d[name](tiles)
                times.append(time.perf_counter() - t0)
            med = sorted(times)[len(times) // 2]
            rec["tile_step"][name] = {
                "batch": TWOD_B, "tpad": 2,
                "out_shape": list(outs[name].shape), "median_s": med,
                "tiles_per_s": TWOD_B / med,
                "output_std": float(outs[name].std())}
        launches = read_counts()  # ... to here
        for name, step_2d in steps_2d.items():
            with plain_versions():
                ref = step_2d(tiles)
            diff = np.abs(outs[name].astype(int) - ref.astype(int))
            rec["tile_step"][name].update(
                u8_max_diff=int(diff.max()),
                u8_frac_differing=float((diff > 0).mean()))
        del model, resumed, g2d, steps_2d
    rec["launches"] = launches
    rec["phase_s"] = time.perf_counter() - t_phase
    tr = rec["train"]
    rec["ok"] = bool(
        all(v["ok"] for v in rec["kernels"].values()) and golden_ok
        and rec["train_check"]["ok"] and tr["counts_ok"]
        and tr["losses_finite"] and all(changed.values())
        and restored_equal and rec["resume"]["continued_bit_equal"]
        and rec["resume"]["step"] == 3 * steps
        and all(ts["out_shape"] == [TWOD_B, 36, 36] and ts["u8_max_diff"] <= 1
                and ts["u8_frac_differing"] <= 1e-3
                for ts in rec["tile_step"].values())
        and rec["tile_step"]["seeded"]["output_std"] > 1
        and all(launches[k] > 0 for k in ("preprocess_u8", "postprocess_u8",
                                          "leaky_relu"))
        and launches["conv3"] == 0)
    emit(rec)
    return rec


# -- phase 11: bf16 training and the training opt-ins -------------------------

# the train step's k3 convs in its first round (2 x TRAIN_B = B tiles), both
# networks: (layer, input side, Cin, O, LeakyReLU epilogue)
TRAIN_CONV3 = CONV_LAYERS + [(n, s, c, o, True)
                             for n, s, c, o in DISC_CONV_LAYERS]


@contextlib.contextmanager
def cudnn_tf32(on):
    """cuDNN's float32 convolutions allowed on the TF32 tensor cores, or
    not, for the block."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def _bwd_engines():
    """conv3's backward on bf16 operands by each candidate engine, each a
    function (x, w, g, need_x, need_w) -> (dx, dw) in bf16: ``port``, the
    port's own cuda_conv.conv3_backward (cuDNN's float32 engines on the
    bf16 values with the TF32 tensor cores allowed, rounded to bf16);
    ``bf16``, cuDNN's bf16 engines on the bf16 tensors; ``f32_math``,
    cuDNN's FP32 engines on the bf16 values, rounded to bf16."""
    from transfer_em_tpu_torch.ops.cuda_conv import (conv3_backward,
                                                     conv_backward_in_dtype)

    def port(x, w, g, nx=True, nw=True):
        return conv3_backward(x, w, g, nx, nw)

    def bf16(x, w, g, nx=True, nw=True):
        return conv_backward_in_dtype(x, w, g, nx, nw)

    def f32_math(x, w, g, nx=True, nw=True):
        f = torch.float32
        with cudnn_tf32(False):
            got = conv3_backward(x.to(f), w.to(f), g.to(f), nx, nw)
        return tuple(None if t is None else t.to(x.dtype) for t in got)

    return {"port": port, "bf16": bf16, "f32_math": f32_math}


def _bwd_errors(got, ref):
    """(dx, dw) against the float64 reference: the largest |error| in bf16
    steps at the largest |ref| (a result rounded once from the exact one
    reads at most 0.5), the L2 gap, and the share of elements that are not
    the reference rounded to nearest bf16."""
    out = {}
    for k, a, r in zip(("dx", "dw"), got, ref):
        e = a.double() - r
        top = r.abs().max().item()
        ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
        out[k] = {"steps_at_max": e.abs().max().item() / ulp,
                  "l2": (e.norm() / r.norm()).item(),
                  "not_nearest": (a.double() != r.to(torch.bfloat16).double()
                                  ).double().mean().item()}
        del e
    return out


# An engine serves conv3's bf16 backward only if its dx and dw stay within
# bf16 rounding of the exact (float64) gradients at every shape: the
# largest error at most one bf16 step at the largest |g| (the rounding's
# half step and as much again for the f32 sums' own error).
BWD_MAX_STEPS = 1.0


def check_bwd_engines(dev, gen):
    """conv3's backward on bf16 operands at the train step's first-round
    shapes (B tiles) by the candidate engines (:func:`_bwd_engines`), each
    held against the float64 gradients of the same bf16 values
    (:func:`_bwd_errors`; cuDNN's float64 engines) and timed by CUDA events
    for dx alone and dw alone, beside the bf16 bound; ``f32_unrounded`` is
    the FP32 engines' result before it rounds, the f32 sums' own error.
    ``ok`` needs the port's engine within BWD_MAX_STEPS at every shape and
    no slower than the bf16 and FP32 engines in all."""
    from transfer_em_tpu_torch.ops import cuda_conv

    engines = _bwd_engines()
    rows = []
    tot = {e: {"dx_ms": 0.0, "dw_ms": 0.0} for e in engines}
    tot["bound_ms"] = 0.0
    bf, f64 = torch.bfloat16, torch.float64
    for name, s, c, o, _ in TRAIN_CONV3:
        x = torch.randn((B, s, s, s, c), generator=gen, device=dev).to(bf)
        w = (torch.randn((3, 3, 3, c, o), generator=gen, device=dev)
             / (27 * c) ** 0.5).to(bf)
        g = torch.randn((B, s - 2, s - 2, s - 2, o), generator=gen,
                        device=dev).to(bf)
        ref = cuda_conv.conv3_backward(x.to(f64), w.to(f64), g.to(f64))
        with cudnn_tf32(False):
            unrounded = cuda_conv.conv3_backward(
                x.float(), w.float(), g.float())
        row = {"layer": name, "shape": [B, s, s, s, c], "out_channels": o,
               "errors": {"f32_unrounded": _bwd_errors(unrounded, ref)}}
        del unrounded
        for e, run in engines.items():
            got = run(x, w, g)
            row["errors"][e] = _bwd_errors(got, ref)
            del got
            t = {"dx_ms": cuda_ms(lambda: run(x, w, g, True, False), 3),
                 "dw_ms": cuda_ms(lambda: run(x, w, g, False, True), 3)}
            row[e] = t
            for k, v in t.items():
                tot[e][k] += v
        del ref
        n_out = g.numel()
        nbytes = 2 * (2 * x.numel() + 2 * w.numel() + g.numel())
        row["bound_ms"], row["bound_by"] = bound(
            nbytes, 2 * 2.0 * n_out * 27 * c, bf)
        tot["bound_ms"] += row["bound_ms"]
        emit({"phase": "bwd_engine", **row})
        rows.append(row)
        del x, w, g
    worst = {e: {k: max(r["errors"][e][k]["steps_at_max"] for r in rows)
                 for k in ("dx", "dw")}
             for e in list(engines) + ["f32_unrounded"]}
    within = {e: all(v <= BWD_MAX_STEPS for v in worst[e].values())
              for e in engines}
    ms = {e: tot[e]["dx_ms"] + tot[e]["dw_ms"] for e in engines}
    rec = {"total": tot, "ms": ms, "worst_steps_at_max": worst,
           "within_bf16_rounding": within, "max_steps": BWD_MAX_STEPS,
           "layers": rows}
    rec["ok"] = within["port"] and ms["port"] <= min(ms.values())
    return rec


# The bf16 step check's bound, set as GRAD_TOL is (see there) from what the
# same run reads, under cudnn.deterministic so that every run reads the
# same: the kernels' bf16 step against the plain one; the plain step's own
# spread with every conv3's f32 sums times (1 + BF16_NOISE N(0, 1)) before
# they round to bf16 (the noise floor); and the f32 check's planted faults.
# In bf16 a rounding-level change anywhere in the forward moves a B=4
# step's gradients by several percent, so the bound is on each network's
# L2 gap (_grad_l2), above the noise floor: on an H100 80GB HBM3 at 700 W
# the kernels' step read 1.0e-2 to 1.6e-2 by network, the noise floor
# 1.9e-2 to 0.15, dx_dropped and mask_inverted 0.63 to 0.86 (both gated)
# and slope_0.2 7.8e-2 to 0.15, within the floor (read, not gated).  A
# fault of rounding size moves a step no more than the floor does; the
# per-layer check (check_bf16_layers) gates those.
BF16_GRAD_TOL = 0.3
BF16_LOSS_RTOL = 1e-3
BF16_NOISE = 1e-5
BF16_FAULTS = ("dx_dropped", "mask_inverted")

# The per-layer check's bounds, for conv3's output y and gradients dx and dw
# on bf16 operands against the same function evaluated exactly (float64
# sums of the bf16 values, each result rounded once to bf16; y with its
# LeakyReLU in bf16 on the rounded sum): the share of elements that are not
# that rounded value ("miss") must stay within BF16_MISS_TOL, and the
# largest error of y and dw within BWD_MAX_STEPS bf16 steps at the largest
# |value|.  y and dx sum at most 864 products, so f32 sums land on the
# rounded value but for about 1e-4 of the elements; dw sums up to 48
# million, and the TF32 engines' sums miss at up to 0.24 of them (FP32:
# 0.03; cuDNN's bf16 engines: 0.93).  dx's largest error is read, not
# gated: where a sum lies within the f32 sums' error of 0, the LeakyReLU's
# mask flips and that element's cotangent changes by 0.7 g, which reads up
# to 10 steps at the largest |dx| in the plain version as in the kernels.
# The plain version (conv3_plain and its autograd) is read beside the
# kernels; the planted faults of rounding size (BF16_LAYER_FAULTS) must
# each miss above the bound somewhere.  On an H100 80GB HBM3 at 700 W the
# kernels missed at most 4.4e-4 (y), 6.5e-4 (dx) and 0.24 (dw), and the
# faults read dw_unrounded 1.0 (dw), conv_f32 1.0 (y), slope_unrounded
# 0.24 (y).
BF16_MISS_TOL = {"y": 0.01, "dx": 0.01, "dw": 0.5}
BF16_LAYER_FAULTS = ("dw_unrounded", "conv_f32", "slope_unrounded")


def _bf16_exact(x, w, g, slope):
    """conv3's bf16 function on (x, w) with output cotangent g, evaluated
    exactly: ``exact`` the float64 y, dx and dw; ``rounded`` each rounded
    once to bf16, y with the LeakyReLU in bf16 on the rounded sum and the
    mask taken from that y, as the port computes it."""
    from transfer_em_tpu_torch.ops.cuda_conv import conv3_backward

    f64, bf = torch.float64, torch.bfloat16
    xd, wd = x.to(f64), w.to(bf).to(f64)
    pre = F.conv3d(xd.permute(0, 4, 1, 2, 3), wd.permute(4, 3, 0, 1, 2))
    pre = pre.permute(0, 2, 3, 4, 1)
    y, exact_y = pre.to(bf), pre
    if slope is not None:
        y = torch.where(y >= 0, y, y * slope)
        g = torch.where(y >= 0, g, g * slope)
        exact_y = torch.where(pre >= 0, pre, pre * slope)
    dx, dw = conv3_backward(xd, wd, g.to(f64))
    return {"exact": (exact_y, dx, dw),
            "rounded": (y, dx.to(bf), dw.to(bf))}


def _miss(got, ref):
    """Per tensor: the share of elements that are not ref's rounded value
    and the largest error in bf16 steps at the largest |exact|."""
    out = {}
    for k, a, r, e in zip(("y", "dx", "dw"), got, ref["rounded"],
                          ref["exact"]):
        a = a.detach().double()
        ulp = 2.0 ** (math.floor(math.log2(e.abs().max().item())) - 7)
        out[k] = {"miss": (a != r.double()).double().mean().item(),
                  "steps_at_max": (a - e).abs().max().item() / ulp}
    return out


@contextlib.contextmanager
def dw_unrounded():
    """conv3's weight gradient on bf16 taken in f32 math on the bf16 values
    and not rounded to bf16 (a planted fault)."""
    from transfer_em_tpu_torch.ops import cuda_conv

    right = cuda_conv._Conv3.__dict__["backward"]

    def wrong(ctx, g):
        x, w, y = ctx.saved_tensors
        if ctx.leaky is not None:
            g = torch.where(y >= 0, g, g * ctx.leaky)
        f = torch.float32
        dx, _ = cuda_conv.conv3_backward(x, w.to(x.dtype), g, True, False)
        _, dw = cuda_conv.conv3_backward(x.to(f), w.to(x.dtype).to(f),
                                         g.to(f), False, True)
        return dx, dw, None

    cuda_conv._Conv3.backward = staticmethod(wrong)
    try:
        yield
    finally:
        cuda_conv._Conv3.backward = right


def check_bf16_layers(dev, gen):
    """conv3 on bf16 at the train step's 12 first-round shapes (B tiles),
    each with the train step's epilogue (bf16(0.3)) and its f32 parameter,
    forward and backward through the port (cuda_conv.conv3 under autograd)
    at a fixed cotangent, against the exact function (:func:`_bf16_exact`,
    :func:`_miss`); beside it the plain version and three planted faults of
    rounding size: ``dw_unrounded`` (:func:`dw_unrounded`), ``conv_f32``
    (the conv run in float32, its output and dw not rounded to bf16) and
    ``slope_unrounded`` (the epilogue's slope 0.3 for bf16(0.3)).  ``ok``
    needs every layer's y, dx and dw within BF16_MISS_TOL, y and dw within
    BWD_MAX_STEPS, and every fault above BF16_MISS_TOL at some layer."""
    from transfer_em_tpu_torch.ops import cuda_conv
    from transfer_em_tpu_torch.ops.cuda_kernels import slope_in

    bf = torch.bfloat16
    s16 = slope_in(bf)

    def run(conv, x, w, g, slope):
        xr = x.detach().requires_grad_(True)
        wr = w.detach().requires_grad_(True)
        y = conv(xr, wr, slope)
        y.backward(g.to(y.dtype))
        return y, xr.grad, wr.grad

    faults = {
        "dw_unrounded": (dw_unrounded, cuda_conv.conv3),
        "conv_f32": (contextlib.nullcontext, lambda x, w, s: cuda_conv.conv3(
            x.float(), w, None if s is None else 0.3)),
        "slope_unrounded": (contextlib.nullcontext,
                            lambda x, w, s: cuda_conv.conv3(
                                x, w, None if s is None else 0.3))}
    rows, caught = [], dict.fromkeys(BF16_LAYER_FAULTS, False)
    for name, s, c, o, act in TRAIN_CONV3:
        slope = s16 if act else None
        x = torch.randn((B, s, s, s, c), generator=gen, device=dev).to(bf)
        w = torch.randn((3, 3, 3, c, o), generator=gen,
                        device=dev) / (27 * c) ** 0.5
        g = torch.randn((B, s - 2, s - 2, s - 2, o), generator=gen,
                        device=dev).to(bf)
        ref = _bf16_exact(x, w, g, slope)
        row = {"layer": name, "shape": [B, s, s, s, c], "out_channels": o,
               "kernels": _miss(run(cuda_conv.conv3, x, w, g, slope), ref),
               "plain": _miss(run(cuda_conv.conv3_plain, x, w, g, slope),
                              ref), "faults": {}}
        for kind in BF16_LAYER_FAULTS:
            planted, conv = faults[kind]
            with planted():
                got = _miss(run(conv, x, w, g, slope), ref)
            row["faults"][kind] = {k: v["miss"] for k, v in got.items()}
            caught[kind] = caught[kind] or any(
                v > BF16_MISS_TOL[k] for k, v in row["faults"][kind].items())
        row["ok"] = all(v["miss"] <= BF16_MISS_TOL[k]
                        and (k == "dx" or v["steps_at_max"] <= BWD_MAX_STEPS)
                        for k, v in row["kernels"].items())
        emit({"phase": "bf16_layer", **row})
        rows.append(row)
        del x, w, g, ref
    worst = {src: {k: {m: max(r[src][k][m] for r in rows)
                       for m in ("miss", "steps_at_max")}
                   for k in ("y", "dx", "dw")}
             for src in ("kernels", "plain")}
    fault_max = {f: {k: max(r["faults"][f][k] for r in rows)
                     for k in ("y", "dx", "dw")} for f in BF16_LAYER_FAULTS}
    return {"worst": worst, "faults": fault_max, "faults_caught": caught,
            "miss_tol": BF16_MISS_TOL, "max_steps": BWD_MAX_STEPS,
            "ok": all(r["ok"] for r in rows) and all(caught.values())}


def check_train_bf16_plain(dev, wf=8, batch=4, phase="train_bf16_check",
                           use_norm=False):
    """One bf16 step through the kernels and one through the plain
    versions from the same state and batches (``wf``, ``batch``, dropout
    off,
    weights redrawn, batches of std 0.3, as check_train_plain), under
    cudnn.deterministic: the 7 losses within BF16_LOSS_RTOL, each network's
    L2 gradient gap within BF16_GRAD_TOL, the noise floor and the planted
    faults read beside it; fails unless the BF16_FAULTS read above
    BF16_GRAD_TOL in every network.

    ``use_norm``: the networks with their InstanceNorm sites on.  Their
    discriminators' outputs then follow the generators' last bits, and the
    plain step's losses move by up to 1e-2 under BF16_NOISE (the noise
    floor, read beside), ten times BF16_LOSS_RTOL; so the plain step takes
    the kernels' conv3 outputs where they are a correct rounding of its own
    sums (:func:`conv3_rounding`), the share of the rest
    (``rounding_misses``) must be 0, and the losses and gradients are held
    to the same bars against that step.  The plain step on its own
    roundings is read beside it (``free``; its gradient gap gated by
    BF16_GRAD_TOL as well), and the replay must flag the planted fault
    ``tap_dropped`` (misses, and the losses off by more than
    BF16_LOSS_RTOL)."""
    import copy

    from transfer_em_tpu_torch.config import CycleGANConfig
    from transfer_em_tpu_torch.train import build_step_fn, create_state

    def rel(a, b):
        return float(np.max(np.abs(a - b) / np.abs(b)))

    cfg = CycleGANConfig(wf=wf, compute_dtype="bfloat16", use_norm=use_norm)
    outs, misses = [], {}
    with cudnn_deterministic():
        state = create_state(cfg, seed=1, device=dev)
        redraw(state, 2)
        fresh = copy.deepcopy(state)
        ref_state = copy.deepcopy(fresh)
        x, y = smooth_batches(batch, 0.3, 11, dev)
        step = build_step_fn(cfg, deterministic=True)
        reset_counts()
        with conv3_rounding(outs) if use_norm else contextlib.nullcontext():
            got = step(state, x, y, 0).cpu().numpy()
        launches = read_counts()
        free_state = copy.deepcopy(fresh) if use_norm else ref_state
        with plain_versions():
            free = step(free_state, x, y, 0).cpu().numpy()
        want = free
        if use_norm:
            with plain_versions(), conv3_rounding(outs, True, misses):
                want = step(ref_state, x, y, 0).cpu().numpy()
            outs.clear()
        grad = _grad_l2(state, ref_state)
        grad_free = _grad_l2(state, free_state)
        del state
        floor = dict.fromkeys(TREES, 0.0)
        floor_loss = 0.0
        for seed in NOISE_SEEDS:
            noisy = copy.deepcopy(fresh)
            with plain_versions(noise=BF16_NOISE, seed=seed):
                lw = step(noisy, x, y, 0).cpu().numpy()
            floor_loss = max(floor_loss, rel(lw, free))
            for t, v in _grad_l2(noisy, free_state).items():
                floor[t] = max(floor[t], v)
            del noisy
        faults = {}
        for kind in FAULTS:
            broken = copy.deepcopy(fresh)
            with planted_fault(kind):
                step(broken, x, y, 0)
            faults[kind] = _grad_l2(broken, free_state)
            del broken
        fwd_fault = None
        if use_norm:
            bad, bad_misses = [], {}
            with conv3_rounding(bad, fault="tap_dropped"):
                lb = step(copy.deepcopy(fresh), x, y, 0).cpu().numpy()
            with plain_versions(), conv3_rounding(bad, True, bad_misses):
                lp = step(copy.deepcopy(fresh), x, y, 0).cpu().numpy()
            bad.clear()
            fwd_fault = {"rounding_misses": bad_misses["n"] / bad_misses["of"],
                         "loss_max_rel_err": rel(lb, lp)}
            fwd_fault["caught"] = (bad_misses["n"] > 0 and
                                   fwd_fault["loss_max_rel_err"]
                                   > BF16_LOSS_RTOL)
    loss_rel = rel(got, want)
    caught = {k: min(faults[k].values()) > BF16_GRAD_TOL
              for k in BF16_FAULTS}
    rec = {"phase": phase, "wf": wf, "batch": batch, "use_norm": use_norm,
           "losses": got.tolist(),
           "plain_losses": want.tolist(), "loss_max_rel_err": loss_rel,
           "loss_rtol": BF16_LOSS_RTOL,
           "noise_floor_loss_rel": floor_loss, "grad_l2": grad,
           "grad_tol": BF16_GRAD_TOL, "noise": BF16_NOISE,
           "noise_seeds": list(NOISE_SEEDS), "noise_floor_l2": floor,
           "faults": faults, "faults_caught": caught, "launches": launches}
    if use_norm:
        rec["free"] = {"plain_losses": free.tolist(),
                       "loss_max_rel_err": rel(got, free),
                       "grad_l2": grad_free}
        rec["rounding_misses"] = misses["n"] / misses["of"]
        rec["fault_tap_dropped"] = fwd_fault
    rec["ok"] = (loss_rel <= BF16_LOSS_RTOL
                 and all(v <= BF16_GRAD_TOL for v in grad.values())
                 and all(v <= BF16_GRAD_TOL for v in grad_free.values())
                 and all(caught.values())
                 and misses.get("n", 0) == 0
                 and (fwd_fault is None or fwd_fault["caught"])
                 and launches["conv3_bf16"] == launches["conv3"] > 0
                 and launches["leaky_relu_bf16"] > 0)
    emit(rec)
    return rec


def _bf16_train_kernels(dev, gen):
    """conv3 (each layer with its own epilogue) and LeakyReLU in bf16 at the
    train step's first-round shapes (B tiles), the generator's and the
    discriminator's, each against its plain version, timed by CUDA events
    and by graph replay beside the bound and the library call (F.conv3d +
    F.leaky_relu; F.leaky_relu), summed by network."""
    keys = ("ms", "plain_ms", "library_ms", "graph_ms", "library_graph_ms",
            "bound_ms")
    bf = torch.bfloat16
    out = {}
    for net, layers in (("gen", CONV_LAYERS),
                        ("disc", [(n, s_, c, o, True)
                                  for n, s_, c, o in DISC_CONV_LAYERS])):
        tot = {**dict.fromkeys(keys, 0.0), "max_abs_err": 0.0, "ok": True,
               "t_bytes": 0.0, "t_ops": 0.0, "layers": []}
        for name, side, c, o, act in layers:
            rec = _conv3_case(dev, gen, bf, 1e-2, name, (B, side, side, side),
                              c, o, act, graph=True)
            rec["ms"] = rec["kernel_ms"]
            for k in keys + ("t_bytes", "t_ops"):
                tot[k] += rec[k]
            tot["max_abs_err"] = max(tot["max_abs_err"], rec["max_abs_err"])
            tot["ok"] = tot["ok"] and rec["ok"]
            tot["layers"].append(name)
        t_ops, t_bytes = tot.pop("t_ops"), tot.pop("t_bytes")
        tot["bound_by"] = "operations" if t_ops > t_bytes else "bytes"
        out["conv3_" + net] = tot
    for net, shapes in (("gen", LEAKY_SHAPES), ("disc", DISC_LEAKY_SHAPES)):
        tot = {**dict.fromkeys(keys, 0.0), "max_abs_err": 0.0, "ok": True,
               "bound_by": "bytes"}
        for shape in shapes:
            v = torch.randn(shape, generator=gen, device=dev).to(bf)
            rec = _leaky_case(v)
            emit({"phase": "kernel", "kernel": "leaky_relu", "net": net,
                  "dtype": "bfloat16", "shape": list(shape), **rec})
            for k in keys:
                tot[k] += rec[k]
            tot["max_abs_err"] = max(tot["max_abs_err"], rec["max_abs_err"])
            tot["ok"] = tot["ok"] and rec["ok"]
            del v
        out["leaky_relu_" + net] = tot
    return out


def _grads_equal(a, b):
    return all(
        (p.grad is None and q.grad is None)
        or (p.grad is not None and q.grad is not None
            and torch.equal(p.grad, q.grad))
        for t in TREES for p, q in zip(getattr(a, t).parameters(),
                                       getattr(b, t).parameters()))


def check_remat(dev):
    """remat on and off at the default config, float32 and bfloat16, B=64,
    dropout on: two steps of each from one state under cudnn.deterministic,
    in the order off, on, on, off, their seconds and peak memory; losses,
    gradients and the updated states must be bit-equal."""
    import copy
    import dataclasses

    from transfer_em_tpu_torch.config import CycleGANConfig
    from transfer_em_tpu_torch.train import build_step_fn, create_state

    x, y = smooth_batches(TRAIN_B, 1.0, 12, dev)
    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg = CycleGANConfig(compute_dtype=dtype)
        base = create_state(cfg, seed=0, device=dev)
        first, times, peaks = {}, {False: [], True: []}, {}
        for remat in (False, True, True, False):
            st = copy.deepcopy(base)
            step = build_step_fn(dataclasses.replace(cfg, remat=remat))
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            with cudnn_deterministic():
                t0 = time.perf_counter()
                loss = step(st, x, y, 0)
                torch.cuda.synchronize()
                times[remat].append(time.perf_counter() - t0)
            peaks[remat] = max(peaks.get(remat, 0.0),
                               torch.cuda.max_memory_allocated() / 1e9)
            first.setdefault(remat, (st, loss))
            del st
        (a, la), (b, lb) = first[False], first[True]
        out[dtype] = {m: {"step_s": times[k], "peak_memory_gb": peaks[k]}
                      for m, k in (("off", False), ("on", True))}
        out[dtype].update(losses_bit_equal=bool(torch.equal(la, lb)),
                          grads_bit_equal=_grads_equal(a, b),
                          states_bit_equal=_states_equal(a, b))
        del first, a, b, base
    out["ok"] = all(v["losses_bit_equal"] and v["grads_bit_equal"]
                    and v["states_bit_equal"] for v in out.values())
    return out


def check_scan_window(dev):
    """make_scan_train_step(window=2) against two sequential
    make_train_step calls from one state (bf16, wf=8, B=4, dropout on),
    under cudnn.deterministic: losses and states bit-equal."""
    import copy

    from transfer_em_tpu_torch.config import CycleGANConfig
    from transfer_em_tpu_torch.train import (create_state,
                                             make_scan_train_step,
                                             make_train_step)

    cfg = CycleGANConfig(compute_dtype="bfloat16")
    base = create_state(cfg, seed=3, device=dev)
    xs, ys = (b.reshape((2, 4) + b.shape[1:])
              for b in smooth_batches(8, 1.0, 13, dev))
    seq, scanned = copy.deepcopy(base), copy.deepcopy(base)
    step = make_train_step(cfg, device=dev)
    scan = make_scan_train_step(cfg, 2, device=dev)
    with cudnn_deterministic():
        want = torch.stack([step(seq, xs[i], ys[i], 5) for i in range(2)])
        got = scan(scanned, xs, ys, 5)
    rec = {"window": 2, "batch": 4, "losses": got.tolist(),
           "losses_bit_equal": bool(torch.equal(got, want)),
           "states_bit_equal": _states_equal(seq, scanned),
           "step": scanned.step}
    rec["ok"] = (rec["losses_bit_equal"] and rec["states_bit_equal"]
                 and scanned.step == 2)
    return rec


def check_ensemble(dev):
    """One step with ensemble_apps against one with batched_apps from one
    state (wf=8, B=4, dropout on, weights redrawn, cudnn.deterministic),
    float32 and bfloat16:
    the 7 losses within the train checks' loss tolerance, the gradients
    within their bounds (f32: every parameter's within GRAD_TOL of its own
    largest |g|; bf16: each network's L2 gap within BF16_GRAD_TOL); conv3
    launches once per stacked network, LeakyReLU once per stack."""
    import copy
    import dataclasses

    from transfer_em_tpu_torch.config import CycleGANConfig
    from transfer_em_tpu_torch.train import build_step_fn, create_state

    x, y = smooth_batches(4, 0.3, 11, dev)
    out = {}
    for dtype, tol, rtol in (("float32", GRAD_TOL, 1e-4),
                             ("bfloat16", BF16_GRAD_TOL, BF16_LOSS_RTOL)):
        cfg = CycleGANConfig(compute_dtype=dtype)
        state = create_state(cfg, seed=1, device=dev)
        redraw(state, 2)
        ens = copy.deepcopy(state)
        with cudnn_deterministic():
            reset_counts()
            want = build_step_fn(cfg)(state, x, y, 7).cpu().numpy()
            batched = read_counts()
            reset_counts()
            got = build_step_fn(dataclasses.replace(cfg, ensemble_apps=True))(
                ens, x, y, 7).cpu().numpy()
            launches = read_counts()
        l2 = _grad_l2(ens, state)
        grad = l2 if dtype == "bfloat16" else _worst(_grad_errors(ens, state))
        loss_rel = float(np.max(np.abs(got - want) / np.abs(want)))
        out[dtype] = {"losses": got.tolist(), "batched_losses": want.tolist(),
                      "loss_max_rel_err": loss_rel, "loss_rtol": rtol,
                      "grad_gap": grad, "grad_tol": tol, "grad_l2": l2,
                      "grad_max_err_over_own_max": _worst(
                          _grad_errors(ens, state)),
                      "launches": launches, "batched_launches": batched}
        out[dtype]["ok"] = (loss_rel <= rtol
                            and all(v <= tol for v in grad.values())
                            and launches["conv3"] == batched["conv3"]
                            and 0 < launches["leaky_relu"]
                            < batched["leaky_relu"])
        del state, ens
    out["ok"] = all(v["ok"] for v in out.values())
    return out


def _bf16_quick_start(dev, is3d):
    """The README quick start in bf16: 3D at B=16 on EM_CUBES seeded 74^3
    cubes of a smoothed 256^3 volume, or 2D at B=64 on TWOD_PATCHES 74^2
    patches of a smoothed 1024^2 image (source through make_warp_map);
    EM2EM(74, wf=8, compute_dtype="bfloat16") trains 2 epochs of 4 steps;
    a second model of the experiment auto-restores bit-equal and trains a
    third epoch on fixed batches, as the first does uninterrupted
    (bit-equal under cudnn.deterministic); save_model -> load_generator ->
    make_tile_step (tpad 2) on 16 cubes (3D) or 128 patches (2D) within one
    grey level on at most 1e-3 of the voxels of the plain versions."""
    from transfer_em_tpu_torch import EM2EM, create_dataset_from_tensors
    from transfer_em_tpu_torch.infer import (load_generator, make_tile_step,
                                             save_model)
    from transfer_em_tpu_torch.ops.warp import make_warp_map

    ndim = 3 if is3d else 2
    bsz, n, side = ((EM_BATCH, EM_CUBES, EM_SIDE) if is3d
                    else (TWOD_TRAIN_B, TWOD_PATCHES, TWOD_SIDE))
    vol = smooth_volume(side, seed=30 + ndim, dev=dev, ndim=ndim)
    corners = np.random.default_rng(32).integers(0, side - 74 + 1, (n, ndim))
    items = [vol[tuple(slice(c, c + 74) for c in cc)] for cc in corners]
    target, ms_y = create_dataset_from_tensors(items, batch_size=bsz,
                                               device=dev)
    source, ms_x = create_dataset_from_tensors(
        items, batch_size=bsz, custom_map=make_warp_map(5), device=dev)
    kw = {"is3d": is3d, "wf": 8, "compute_dtype": "bfloat16", "device": dev}
    rec = {"config": f"EM2EM(74, is3d={is3d}, wf=8, compute_dtype="
                     "'bfloat16')", "batch": bsz, "items": n}
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "ckpt")
        log = os.path.join(tmp, "metrics.jsonl")
        name = f"bf16_{ndim}d"
        model = EM2EM(74, name, checkpoint_root=root, **kw)
        before = [p.detach().clone() for p in model.state.gg.parameters()]
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model.train(source, target, epochs=2, check_freq=1, metrics_log=log)
        rec["wall_s"] = time.perf_counter() - t0
        epochs = [json.loads(line) for line in open(log)]
        rec["epochs"] = epochs
        rec["tiles_per_s"] = [e["steps"] * bsz / e["seconds"] for e in epochs]
        rec["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        rec["losses_finite"] = all(
            np.isfinite(list(e["loss"].values())).all() for e in epochs)
        rec["generator_changed"] = any(not torch.equal(a, b) for a, b in zip(
            before, model.state.gg.parameters()))
        resumed = EM2EM(74, name, checkpoint_root=root, **kw)
        rec["restored_bit_equal"] = _states_equal(resumed.state, model.state)
        steps = n // bsz
        bx, by = source.take_batches(steps), target.take_batches(steps)
        with cudnn_deterministic():
            resumed.train(bx, by, epochs=1, start=2, check_freq=1,
                          metrics_log=log)
            for x, y in zip(bx, by):
                model.train_step(x, y)
        rec["continued_bit_equal"] = _states_equal(resumed.state, model.state)
        rec["step"] = resumed.state.step
        export = os.path.join(tmp, "export")
        save_model(export, os.path.join(resumed.checkpoint_path, "3"), ms_x,
                   ms_y, 74, is3d, 8, device=dev)
        gen, meta = load_generator(export, device=dev)
        tiles = np.stack(items[:16]) if is3d else _tile_grid(vol, TWOD_B)
        tile_step = make_tile_step(gen, meta.meanstd_x, meta.meanstd_y, 2,
                                   device=dev)
        got = tile_step(tiles)
        with plain_versions():
            ref = tile_step(tiles)
        diff = np.abs(got.astype(int) - ref.astype(int))
        rec["tile_step"] = {"tiles": len(tiles), "out_shape": list(got.shape),
                            "u8_max_diff": int(diff.max()),
                            "u8_frac_differing": float((diff > 0).mean())}
        del model, resumed, gen
    rec["ok"] = bool(
        rec["losses_finite"] and rec["generator_changed"]
        and rec["restored_bit_equal"] and rec["continued_bit_equal"]
        and rec["step"] == 3 * steps and rec["tile_step"]["u8_max_diff"] <= 1
        and rec["tile_step"]["u8_frac_differing"] <= 1e-3)
    return rec


def check_train_bf16(dev, smi):
    """bf16 training and the opt-ins (phase 11): conv3's backward engines,
    conv3 and LeakyReLU in bf16 at the train step's shapes, conv3's output
    and gradients per layer against the exact function (BF16_MISS_TOL), a
    bf16 step through the kernels against the plain versions
    (BF16_GRAD_TOL), 5 timed
    bf16 steps at B=64 (one profiled), remat, the scan window,
    ensemble_apps, then the bf16 quick start in 3D and 2D: the main path,
    counted."""
    from transfer_em_tpu_torch.config import CycleGANConfig

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(50)
    cfg = CycleGANConfig(compute_dtype="bfloat16")
    rec = {"phase": "train_bf16", "card": smi}
    rec["bwd_engines"] = check_bwd_engines(dev, gen)
    rec["kernels"] = _bf16_train_kernels(dev, gen)
    rec["layers"] = check_bf16_layers(dev, gen)
    emit({"phase": "bf16_layers", **rec["layers"]})
    rec["train_check"] = check_train_bf16_plain(dev)
    rec["use_norm"] = check_use_norm(dev, None, "bfloat16")
    rec["step"] = check_train(dev, smi, cfg=cfg, phase="train_bf16_step")
    rec["remat"] = check_remat(dev)
    emit({"phase": "remat", **rec["remat"]})
    rec["scan_window"] = check_scan_window(dev)
    emit({"phase": "scan_window", **rec["scan_window"]})
    rec["ensemble_apps"] = check_ensemble(dev)
    emit({"phase": "ensemble_apps", **rec["ensemble_apps"]})
    reset_counts()  # the main path's counts run from here
    rec["quick_start"] = {"3d": _bf16_quick_start(dev, True),
                          "2d": _bf16_quick_start(dev, False)}
    launches = read_counts()  # ... to here
    rec["launches"] = launches
    rec["phase_s"] = time.perf_counter() - t_phase
    rec["ok"] = bool(
        all(v["ok"] for v in rec["kernels"].values())
        and rec["bwd_engines"]["ok"] and rec["layers"]["ok"]
        and rec["train_check"]["ok"] and rec["use_norm"]["ok"]
        and rec["step"]["ok"] and rec["remat"]["ok"] and rec["scan_window"]["ok"]
        and rec["ensemble_apps"]["ok"]
        and all(q["ok"] for q in rec["quick_start"].values())
        and all(launches[k] > 0 for k in counters())
        and launches["conv3_bf16"] > 0 and launches["leaky_relu_bf16"] > 0)
    emit(rec)
    return rec


# -- phase 12: int8 serving and the phase-decomposed transposed conv ----------

INT8_TOPS = 1979e12  # H100 SXM int8 dense, tensor cores
# the int8 generator's conv calls in order; "up" is a phase conv (a k3
# kernel with 2^n * Cout outputs whose true taps are 2^n of its 3^n)
INT8_LAYERS = ["stem", "down1.conv", "down1.down", "down2.conv",
               "down2.down", "up1.conv", "up1.up", "mid", "up0.conv",
               "up0.up", "head", "out"]
# (rank, wf, B) of the kernel checks: the wf=8 tile step's batch and the
# reference's full width (wf=1, 64-256 channels)
INT8_CHECKS = [(3, 8, B), (3, 1, 4), (2, 8, B), (2, 1, 4)]
# (wf, B) of the timed tile steps, int8 against f32 and bf16
INT8_STEPS = [(8, B), (1, 4), (1, 16)]
INT8_VOL = 192  # side of the seeded volume the tiles come from


@contextlib.contextmanager
def recorded_int8():
    """Record every int8 conv of the block in call order: its kernel's
    shape and kind (the int8_weights call), its activation and the codes'
    layout (the quantize_int8 call), then the conv_int8 call's operands
    (codes, weight codes, scales, out dtype, epilogue, and the packed
    operand and phases), one dict a conv."""
    from transfer_em_tpu_torch.ops import quant

    calls, fw = [], quant.int8_weights
    fq, fc = quant.quantize_int8, quant.conv_int8

    def rec_w(kernel, layout, transpose=False):
        calls.append({"kernel": tuple(kernel.shape), "transpose": transpose})
        return fw(kernel, layout, transpose)

    def rec_q(x, layout):
        calls[-1].update(x=x, layout=layout)
        return fq(x, layout)

    def rec_c(qx, qk, sx, sk, out_dtype=torch.float32, leaky=None, **kw):
        calls[-1]["conv"] = (qx, qk, sx, sk, out_dtype, leaky)
        calls[-1]["kw"] = kw
        return fc(qx, qk, sx, sk, out_dtype, leaky, **kw)

    quant.int8_weights, quant.quantize_int8, quant.conv_int8 = (rec_w, rec_q,
                                                                rec_c)
    try:
        yield calls
    finally:
        quant.int8_weights, quant.quantize_int8, quant.conv_int8 = fw, fq, fc


def _int8_work(rec):
    """(operations, bytes) of one int8 conv as the JAX function defines it,
    from its own operands (``recorded_int8``'s record), not the codes'
    layout: each output's multiply-adds x 2, i.e. its kernel's taps (the
    k4 stride-2 transposed conv's 2^n of 4^n) x the activation's channels;
    each activation value read once as one int8 code, the kernel's codes
    and its O scales read once, the output written once."""
    x, k = rec["x"], rec["kernel"]
    qx, qk, _, _, out_dtype, _ = rec["conv"]
    n = x.dim() - 2
    # the output's elements: the unit conv's voxels x its outputs (a phase
    # conv's 2^n * Cout at S^n voxels are the (2S)^n * Cout of the output)
    out_sp = [a - b + 1 for a, b in zip(qx.shape[1:-1], qk.shape[:n])]
    outs = qx.shape[0] * math.prod(out_sp) * qk.shape[-1]
    taps = 2 ** n if rec["transpose"] else math.prod(k[:n])
    es = torch.empty((), dtype=out_dtype).element_size()
    nbytes = x.numel() + math.prod(k) + 4 * k[-1] + outs * es
    return 2 * outs * taps * x.shape[-1], nbytes


def _quant_work(x):
    """(operations, bytes) of one quantize_int8 call as the function
    defines it: the activation read once, one code a value and the scale
    written once (the layout's padding and copies not counted); an abs, a
    max and a division a value (float32 on the CUDA cores)."""
    return 3 * x.numel(), x.numel() * x.element_size() + x.numel() + 4


def _quant_case(x, layout):
    """quantize_int8 against its plain version on one activation: codes and
    scale bit-equal; times of the kernel and the plain version (events),
    the bound."""
    from transfer_em_tpu_torch.ops import quant

    q, sx = quant.quantize_int8_cuda(x, layout)
    q_ref, sx_ref = quant.quantize_int8_plain(x, layout)
    torch.cuda.synchronize()
    ops, nbytes = _quant_work(x)
    b_ms, b_by = bound(nbytes, ops, torch.float32)
    ms = cuda_ms(lambda: quant.quantize_int8_cuda(x, layout))
    return {"x": list(x.shape), "dtype": str(x.dtype).replace("torch.", ""),
            "codes": list(q.shape), "layout": layout._asdict(),
            "equal": bool(torch.equal(q, q_ref) and torch.equal(sx, sx_ref)),
            "codes_differing": int((q != q_ref).sum()),
            "max_abs_err": float((q.int() - q_ref.int()).abs().max()),
            "ms": ms, "plain_ms": cuda_ms(
                lambda: quant.quantize_int8_plain(x, layout), reps=2),
            "bound_ms": b_ms, "bound_by": b_by, "ops": ops, "bytes": nbytes,
            "gb_per_s": nbytes / ms / 1e6}


def _int8_layer_checks(dev, rank, wf, bsz):
    """The int8 site's two kernels against their plain versions at every
    layer of the int8 generator (rank, wf, B), on the activations and codes
    a forward of a seeded generator over a seeded batch gives them:
    quantize_int8's codes and scale, conv_int8's int32 accumulators and
    dequantized output (its dtype, epilogue and interleaving), each
    bit-equal; times of the kernels (events) and the plain versions, the
    bounds."""
    from transfer_em_tpu_torch.ops import cuda_int8

    gen = seeded_generator(60 + wf, dev, is3d=rank == 3, wf=wf,
                           int8_conv=True)
    x = torch.from_numpy(np.random.default_rng(61).uniform(
        -1, 1, (bsz,) + (74,) * rank + (1,)).astype(np.float32)).to(dev)
    with torch.inference_mode(), recorded_int8() as calls:
        gen(x)
    rows, quant_rows = [], []
    for layer, rec in zip(INT8_LAYERS, calls):
        quant_rows.append({"layer": layer, **_quant_case(rec["x"],
                                                         rec["layout"])})
        call, kw = rec["conv"], rec["kw"]
        qx, qk, sx, sk, od, leaky = call
        acc = cuda_int8.conv_int8(qx, qk, sx, sk, torch.int32, **kw)
        acc_ref = cuda_int8.conv_int8_plain(qx, qk, sx, sk, torch.int32,
                                            **kw)
        y = cuda_int8.conv_int8(*call, **kw)
        y_ref = cuda_int8.conv_int8_plain(*call, **kw)
        torch.cuda.synchronize()
        ops, nbytes = _int8_work(rec)
        b_ms, b_by = bound(nbytes, ops, None, peak=INT8_TOPS)
        ms = cuda_ms(lambda: cuda_int8.conv_int8(*call, **kw))
        plan = kw["packed"].plan
        rows.append({
            "layer": layer, "x": list(qx.shape), "kernel": list(qk.shape),
            "out_dtype": str(od).replace("torch.", ""),
            "epilogue": leaky is not None, "phases": kw.get("phases", False),
            "plan": plan._asdict(),
            "acc_equal": bool(torch.equal(acc, acc_ref)),
            "out_equal": bool(torch.equal(y, y_ref)),
            "max_abs_err": float((y.float() - y_ref.float()).abs().max()),
            "acc_max_abs": int(acc_ref.abs().max()),
            "ms": ms, "plain_ms": cuda_ms(
                lambda: cuda_int8.conv_int8_plain(*call, **kw), reps=2),
            "bound_ms": b_ms, "bound_by": b_by, "ops": ops,
            "bytes": nbytes, "tops": ops / ms / 1e9})
        del acc, acc_ref, y, y_ref
    inputs = [(c["x"], c["layout"]) for c in calls]
    del calls
    torch.cuda.empty_cache()
    return {"rank": rank, "wf": wf, "batch": bsz, "layers": rows,
            "quantize": quant_rows, "inputs": inputs,
            "ok": len(rows) == len(INT8_LAYERS)
            and all(r["acc_equal"] and r["out_equal"] for r in rows)
            and all(r["equal"] for r in quant_rows)}


QUANT_FAULTS = {"roundf": 1, "reciprocal": 2, "partial_max": 3}


_FAULT_LIBS = {}


def _quant_fault_lib(name):
    """The quantize kernel built with planted fault ``name`` (QUANT_FAULTS),
    once a run."""
    from transfer_em_tpu_torch import kernels

    if name not in _FAULT_LIBS:
        _FAULT_LIBS[name] = kernels.build_variant(
            "quant_int8.cu", f"quant_fault_{name}",
            [f"TEM_QUANT_FAULT={QUANT_FAULTS[name]}"])
    return _FAULT_LIBS[name]


def _quant_fault_checks(dev, inputs):
    """Three planted faults of the quantize kernel, each built from
    csrc/quant_int8.cu with -DTEM_QUANT_FAULT (roundf rounding, a multiply
    by the scale's reciprocal, the max over the first half of the tensor):
    on the wf=8 B=128 3D layers' activations and two tie-rich ones (every
    a / scale an exact half; the max at the first and at the last element),
    each fault must make some codes or scales differ from the plain
    version's.  Then one NaN in the tie-rich input: the kernel's scale must
    be NaN, as the plain version's is (the max carries it)."""
    from transfer_em_tpu_torch.ops import quant

    gen = torch.Generator(device=dev).manual_seed(64)
    ties = _tie_rich((B, 24, 24, 24, 32), gen, dev)
    last = ties.clone()
    last.view(-1)[0] = 1.5
    last.view(-1)[-1] = -127.0
    layout = quant.conv_layout(ties.shape, (3, 3, 3, 32, 32), 1, "VALID")
    cases = list(inputs) + [(ties, layout), (last, layout)]
    refs = [quant.quantize_int8_plain(x, lay) for x, lay in cases]
    out = {}
    for name in QUANT_FAULTS:
        lib = _quant_fault_lib(name)
        broken = []
        for i, ((x, lay), (q_ref, s_ref)) in enumerate(zip(cases, refs)):
            q, sx = quant.quantize_int8_cuda(x, lay, lib=lib)
            if not (torch.equal(q, q_ref) and torch.equal(sx, s_ref)):
                broken.append(i)
        out[name] = {"cases_broken": len(broken), "of": len(cases),
                     "first": broken[:4]}
    del refs, cases
    nan = ties.clone()
    nan.view(-1)[nan.numel() // 3] = float("nan")
    q, sx = quant.quantize_int8_cuda(nan, layout)
    q_ref, s_ref = quant.quantize_int8_plain(nan, layout)
    nan_case = {"scale_nan": bool(torch.isnan(sx).all()),
                "plain_scale_nan": bool(torch.isnan(s_ref).all()),
                "codes_equal": bool(torch.equal(q, q_ref))}
    del nan, q, q_ref, ties, last
    torch.cuda.empty_cache()
    return {"faults": out, "nan": nan_case,
            "ok": all(f["cases_broken"] > 0 for f in out.values())
            and nan_case["scale_nan"] and nan_case["plain_scale_nan"]}


def _int8_reference(x, w, kind, out_dtype, leaky=None):
    """The JAX package's int8 conv written independently of the port: the
    scales and codes as jnp computes them (true division, round half to
    even), the integer conv in float64 (exact) by the conv's own
    definition (VALID stride 1 or 2; the transposed conv as
    ``F.conv_transpose{2,3}d(stride=2, padding=1)`` of the codes, the TF-
    SAME k4 transposed conv), dequantized as float(acc) * (sx * sk)."""
    n = x.dim() - 2

    def q(a, axes):
        a = a.float()
        s = torch.clamp(a.abs().amax(dim=axes, keepdim=True),
                        min=1e-12) / a.new_full((), 127.0)
        return torch.clamp(torch.round(a / s), -127, 127), s

    qx, sx = q(x, tuple(range(x.dim())))
    qk, sk = q(w, tuple(range(n + 1)))
    xc = qx.double().permute(0, n + 1, *range(1, n + 1))
    if kind == "up":
        conv = F.conv_transpose3d if n == 3 else F.conv_transpose2d
        acc = conv(xc, qk.double().permute(n, n + 1, *range(n)), stride=2,
                   padding=1)
    else:
        conv = F.conv3d if n == 3 else F.conv2d
        acc = conv(xc, qk.double().permute(n + 1, n, *range(n)),
                   stride=2 if kind == "down" else 1)
    acc = acc.permute(0, *range(2, n + 2), 1)
    y = (acc.float() * (sx.reshape(()) * sk.reshape(-1))).to(out_dtype)
    return y if leaky is None else torch.where(y >= 0, y, y * leaky)


def _tie_rich(shape, gen, dev):
    """Activations whose every value / scale is an exact half (amax 127,
    scale 1, values k + 0.5): where round half to even and roundf part."""
    v = torch.randint(-126, 126, shape, generator=gen, device=dev).float()
    v = v + 0.5
    v.view(-1)[0] = 127.0
    return v


@contextlib.contextmanager
def int8_fault(kind):
    """A planted fault in the port's int8 conv: ``roundf`` quantizes the
    activations with round half away from zero (the quantize kernel built
    so); ``weight_per_tensor`` takes one weight scale for all output
    channels; ``dropped_tap`` zeroes the kernel's first tap (and repacks
    it)."""
    from transfer_em_tpu_torch.ops import quant

    saved_q, saved_c = quant.quantize_sym, quant.conv_int8
    saved_a = quant.quantize_int8

    def a_roundf(x, layout):
        return quant.quantize_int8_cuda(x, layout,
                                        lib=_quant_fault_lib("roundf"))

    def q_per_tensor(a, axes):
        if a.dim() - 1 in axes:  # activations
            return saved_q(a, axes)
        q, s = saved_q(a, tuple(range(a.dim())))
        return q, s.expand(*([1] * (a.dim() - 1)), a.shape[-1])

    def c_dropped(qx, qk, sx, sk, out_dtype=torch.float32, leaky=None,
                  **kw):
        qk = qk.clone()
        qk[(0,) * (qk.dim() - 2)] = 0
        return saved_c(qx, qk, sx, sk, out_dtype, leaky,
                       phases=kw.get("phases", False))

    if kind == "roundf":
        quant.quantize_int8 = a_roundf
    elif kind == "weight_per_tensor":
        quant.quantize_sym = q_per_tensor
    else:
        quant.conv_int8 = c_dropped
    try:
        yield
    finally:
        quant.quantize_sym, quant.conv_int8 = saved_q, saved_c
        quant.quantize_int8 = saved_a


INT8_FAULTS = ("roundf", "weight_per_tensor", "dropped_tap")


def _int8_conv_checks(dev, gen):
    """The port's int8 convs (the quantize kernel, the weights, conv_int8
    with its epilogue) against _int8_reference at the wf=8 layer kinds
    (B=16, f32 and bf16 out, 3D and 2D): a k3 conv with its epilogue, a k4
    stride-2 down conv, a transposed conv (and one with an odd Cout, whose
    phases do not pair channels), each on N(0, 1) activations, on
    tie-rich ones and on a strided (not contiguous) view; bit-equal.  Each planted fault must break the
    equality of at least one of them.  Each call takes a fresh copy of the
    weights, so that the weight cache remakes them (under a fault too)."""
    from transfer_em_tpu_torch.ops import quant
    from transfer_em_tpu_torch.ops.cuda_kernels import slope_in

    cases = []
    for rank in (3, 2):
        for kind, side, c, o in (("k3", 24, 32, 16), ("down", 34, 8, 8),
                                 ("up", 13, 32, 16), ("up", 9, 8, 3)):
            k = {"k3": 3, "down": 4, "up": 4}[kind]
            w = torch.randn((k,) * rank + (c, o), generator=gen, device=dev)
            shape = (16,) + (side,) * rank + (c,)
            for data in ("normal", "ties", "strided"):
                x = (_tie_rich(shape, gen, dev) if data == "ties"
                     else torch.randn(shape, generator=gen, device=dev))
                if data == "strided":  # the same shape, not contiguous
                    x = x.transpose(1, 2).contiguous().transpose(1, 2)
                for od in (torch.float32, torch.bfloat16):
                    cases.append((rank, kind, data, od, x, w))

    def run(rank, kind, data, od, x, w):
        leaky = slope_in(od) if kind == "k3" else None
        if kind == "up":
            got = quant.conv_transpose_nd_int8(x, w.clone(), out_dtype=od)
        else:
            got = quant.conv_nd_int8(x, w.clone(),
                                     stride=2 if kind == "down" else 1,
                                     out_dtype=od, leaky=leaky)
        return torch.equal(got, _int8_reference(x, w, kind, od, leaky))

    rows = [{"rank": r, "kind": k, "data": d,
             "dtype": str(od).replace("torch.", ""),
             "equal": run(r, k, d, od, x, w)} for r, k, d, od, x, w in cases]
    faults = {}
    for fault in INT8_FAULTS:
        with int8_fault(fault):
            broken = [f"{r}d.{k}.{d}.{str(od)[6:]}"
                      for r, k, d, od, x, w in cases
                      if not run(r, k, d, od, x, w)]
        faults[fault] = {"cases_broken": len(broken), "of": len(cases),
                         "first": broken[:4]}
    return {"cases": rows, "faults": faults,
            "ok": all(r["equal"] for r in rows)
            and all(f["cases_broken"] > 0 for f in faults.values())}


def _int8_general_reference(x, w, kind, stride, out_dtype):
    """The JAX package's int8 conv (as _int8_reference) at the shapes that
    take the port's phase plan: ``"same"`` a SAME conv at ``stride``, the
    input zero-padded by XLA's split (ceil(n / s) outputs, the odd voxel
    after) then a VALID strided conv; ``"up"`` the TF-SAME transposed conv
    at any k, as ``F.conv_transpose`` of the codes unpadded, cropped by
    max(k - s, 0) split (lo = half, rounded down)."""
    n = x.dim() - 2
    k = w.shape[0]

    def q(a, axes):
        a = a.float()
        s = torch.clamp(a.abs().amax(dim=axes, keepdim=True),
                        min=1e-12) / a.new_full((), 127.0)
        return torch.clamp(torch.round(a / s), -127, 127), s

    qx, sx = q(x, tuple(range(x.dim())))
    qk, sk = q(w, tuple(range(n + 1)))
    xc = qx.double().permute(0, n + 1, *range(1, n + 1))
    if kind == "up":
        conv = F.conv_transpose3d if n == 3 else F.conv_transpose2d
        acc = conv(xc, qk.double().permute(n, n + 1, *range(n)),
                   stride=stride)
        total = max(k - stride, 0)
        lo, hi = total // 2, total - total // 2
        acc = acc[(slice(None), slice(None)) + tuple(
            slice(lo, acc.shape[2 + a] - hi) for a in range(n))]
    else:
        pads = []
        for d in reversed(x.shape[1:-1]):
            total = max((-(-d // stride) - 1) * stride + k - d, 0)
            pads += [total // 2, total - total // 2]
        conv = F.conv3d if n == 3 else F.conv2d
        acc = conv(F.pad(xc, pads), qk.double().permute(n + 1, n, *range(n)),
                   stride=stride)
    acc = acc.permute(0, *range(2, n + 2), 1)
    return (acc.float() * (sx.reshape(()) * sk.reshape(-1))).to(out_dtype)


# the C12 int8 shapes: (kind, k, stride, side, C, O)
INT8_C12_CASES = [("same", 3, 2, 15, 8, 8), ("same", 4, 2, 16, 8, 8),
                  ("same", 3, 3, 16, 8, 4), ("up", 3, 2, 9, 8, 4),
                  ("up", 2, 2, 9, 8, 4), ("up", 5, 2, 7, 8, 4),
                  ("up", 1, 2, 9, 4, 4)]


def _int8_c12_checks(dev, gen):
    """conv_nd_int8 SAME at stride 2 and 3 and conv_transpose_nd_int8 at
    k1, k2, k3, k5 stride 2 (the shapes the JAX package takes and the
    port once refused, now the phase plan through the quantize kernel and
    conv_int8's stride-1 VALID layout), 3D and 2D, B=4, f32 and bf16 out:
    bit-equal to _int8_general_reference and to the plain versions on the
    CPU, each call launching both kernels."""
    from transfer_em_tpu_torch.ops import quant

    rows = []
    for rank in (3, 2):
        for kind, k, s, side, c, o in INT8_C12_CASES:
            w = torch.randn((k,) * rank + (c, o), generator=gen, device=dev)
            x = torch.randn((4,) + (side,) * rank + (c,), generator=gen,
                            device=dev)
            for od in (torch.float32, torch.bfloat16):
                reset_counts()
                if kind == "up":
                    got = quant.conv_transpose_nd_int8(x, w, stride=s,
                                                       out_dtype=od)
                    cpu = quant.conv_transpose_nd_int8(
                        x.cpu(), w.cpu(), stride=s, out_dtype=od)
                else:
                    got = quant.conv_nd_int8(x, w, stride=s, padding="SAME",
                                             out_dtype=od)
                    cpu = quant.conv_nd_int8(x.cpu(), w.cpu(), stride=s,
                                             padding="SAME", out_dtype=od)
                n = read_counts()
                want = _int8_general_reference(x, w, kind, s, od)
                rows.append({
                    "rank": rank, "kind": kind, "k": k, "stride": s,
                    "shape": list(got.shape),
                    "dtype": str(od).replace("torch.", ""),
                    "equal_reference": bool(torch.equal(got, want)),
                    "equal_plain_cpu": bool(torch.equal(got.cpu(), cpu)),
                    "conv_int8": n["conv_int8"],
                    "quantize_int8": n["quantize_int8"]})
    ok = all(r["equal_reference"] and r["equal_plain_cpu"]
             and r["conv_int8"] == 1 and r["quantize_int8"] == 1
             for r in rows)
    return {"cases": rows, "ok": ok}


def _int8_goldens(dev):
    """The int8 generator (wf=8) with the goldens' weights, f32 and bf16,
    3D and 2D: PSNR against the frozen TF output, and the card's output
    against the CPU's (plain versions, which the CPU tests hold equal to
    the JAX package's int8 output)."""
    from transfer_em_tpu_torch.models import UNetGenerator
    from transfer_em_tpu_torch.models.convert import params_from_tf_order

    out = {}
    for name in ("gen_3d", "gen_2d"):
        data = np.load(os.path.join(ROOT, "tests", "goldens", name + ".npz"))
        sd = params_from_tf_order(data)
        for cd in (None, "bfloat16"):
            got = []
            for where in (dev, "cpu"):
                g = UNetGenerator(wf=8, is3d=name == "gen_3d", int8_conv=True,
                                  compute_dtype=cd)
                g.load_state_dict(sd)
                with torch.inference_mode():
                    got.append(g.to(where).eval()(
                        torch.from_numpy(data["x"]).to(where)).cpu().numpy())
            out[f"{name}.{cd or 'float32'}"] = {
                "psnr_db": psnr(got[0], data["y"]),
                "card_vs_cpu_max_abs": float(np.abs(got[0] - got[1]).max())}
    return out


def _int8_tiles(vol, n, seed):
    """n tiles of 74^3 at seeded corners of a zyx volume."""
    rng = np.random.default_rng(seed)
    cs = rng.integers(0, vol.shape[0] - 74 + 1, (n, 3))
    return np.stack([vol[z:z + 74, y:y + 74, x:x + 74] for z, y, x in cs])


def _int8_step_case(dev, vol, wf, bsz, counted):
    """make_tile_step over one batch of bsz tiles with the same seeded
    weights in int8, f32 and bf16: ms a batch and Mvox/s (one warm and 3
    timed calls, host clock around the synchronised step), peak memory;
    int8 against the same step through the plain versions (one level on
    at most 1e-3 of the voxels) and against f32 (read).  With ``counted``
    the int8 step's timed calls are the phase's main path: the counts run
    from just before them to just after, and one of its batches is
    profiled."""
    from transfer_em_tpu_torch.infer import make_tile_step

    tiles = _int8_tiles(vol, bsz, 70 + wf)
    rec, outs = {"wf": wf, "batch": bsz, "tpad": 2}, {}
    for name, kw in (("int8", {"int8_conv": True}), ("float32", {}),
                     ("bfloat16", {"compute_dtype": "bfloat16"})):
        gen = seeded_generator(62, dev, wf=wf, **kw)
        step = make_tile_step(gen, MS_X, MS_Y, 2)
        out, times, peak, launches = _timed(lambda: step(tiles))
        med = sorted(times)[len(times) // 2]
        outs[name] = out
        rec[name] = {"ms": med * 1e3, "times_s": times,
                     "mvox_per_s": bsz * 36 ** 3 / med / 1e6,
                     "tiles_per_s": bsz / med, "peak_gb": peak / 1e9,
                     "launches": launches}
        if name == "int8":
            if counted:
                rec["profile"] = profile_round(lambda: step(tiles))
                rec["aten_on_activations"] = _aten_counts(
                    lambda: step(tiles), QUANT_ATEN_OPS)
            with plain_versions():
                ref = step(tiles)
            rec[name]["u8_max_diff"], rec[name]["u8_frac_differing"] = \
                _u8_diff(out, ref)
        del gen, step
        torch.cuda.empty_cache()
    rec["int8_vs_f32"] = dict(zip(("u8_max_diff", "u8_frac_differing"),
                                  _u8_diff(outs["int8"], outs["float32"])))
    rec["int8_vs_f32"]["psnr_db"] = psnr(outs["int8"], outs["float32"])
    i8 = rec["int8"]
    rec["ok"] = bool(i8["u8_max_diff"] <= 1 and i8["u8_frac_differing"]
                     <= 1e-3 and outs["int8"].shape == (bsz, 36, 36, 36)
                     and i8["launches"]["conv_int8"] > 0
                     and i8["launches"]["quantize_int8"] > 0
                     and not any(rec.get("aten_on_activations",
                                         {}).values()))
    return rec


# PyTorch ops that quantized or rearranged the activations before the
# quantize kernel: none may run in an int8 tile step on the card
QUANT_ATEN_OPS = ("aten::abs", "aten::div", "aten::round", "aten::clamp",
                  "aten::amax", "aten::constant_pad_nd")


def _aten_counts(run, names):
    """How often each of the PyTorch ops ``names`` ran in ``run()`` (host
    side of torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
        torch.cuda.synchronize()
    counts = dict.fromkeys(names, 0)
    for e in prof.key_averages():
        if e.key in counts:
            counts[e.key] += e.count
    return counts


# (layer, x shape without channels, Cin, Cout) of the up convs whose
# transposed conv the phase form serves: wf=8 at the device batch, the
# slab's B=1 up0.up, and wf=1 (64-256 channels) at its device batch
PHASE_CONV_CASES = [("up1.up", (B, 13, 13, 13), 32, 16),
                    ("up0.up", (B, 22, 22, 22), 16, 8),
                    ("slab.up0.up", (1, 22, 182, 182), 16, 8),
                    ("wf1.up1.up", (16, 13, 13, 13), 256, 128),
                    ("wf1.up0.up", (16, 22, 22, 22), 128, 64)]


def _phase_conv_cases(dev, gen):
    """The transposed conv at PHASE_CONV_CASES, TF32 off: the phase conv on
    conv3 (phase_decompose=True) against cuDNN's transposed conv (False),
    f32 gated at conv3's f32 tolerance (1e-4 max(1, |ref|)) and bf16 read,
    ms of both by events (``ms_phase``, ``ms_cudnn``); and the default form
    under inference_mode with the counts it launched, which must be: f32
    below PHASE_CIN_COUT_LIMIT the phase conv (its k3 conv one conv3
    launch), the rest cuDNN's."""
    from transfer_em_tpu_torch.ops.convs import (PHASE_CIN_COUT_LIMIT,
                                                 conv_transpose_nd)

    def phase(x, w):
        return conv_transpose_nd(x, w, phase_decompose=True)

    def cudnn(x, w):
        return conv_transpose_nd(x, w, phase_decompose=False)

    out = []
    for name, shape, cin, cout in PHASE_CONV_CASES:
        x = torch.randn(shape + (cin,), generator=gen, device=dev)
        w = torch.randn((4, 4, 4, cin, cout), generator=gen,
                        device=dev) / (64 * cin) ** 0.5
        for dtype in (torch.float32, torch.bfloat16):
            xd = x.to(dtype)
            on = dtype == torch.float32 and cin * cout < PHASE_CIN_COUT_LIMIT
            with cudnn_tf32(False), torch.inference_mode():
                ref = cudnn(xd, w)
                got = phase(xd, w)
                err = float((got.float() - ref.float()).abs().max())
                ref_max = float(ref.float().abs().max())
                del ref, got
                reset_counts()
                conv_transpose_nd(xd, w)
                route = {k: read_counts()[k] for k in (
                    "transpose_phase", "transpose_cudnn", "conv3")}
                out.append({
                    "layer": name, "x": list(xd.shape), "cout": cout,
                    "dtype": str(dtype).replace("torch.", ""),
                    "max_abs_err": err, "ref_max_abs": ref_max,
                    "rel_err": err / ref_max,
                    "tol": 1e-4 * max(1.0, ref_max),
                    "default_route": route,
                    "route_ok": route == {"transpose_phase": int(on),
                                          "transpose_cudnn": int(not on),
                                          "conv3": int(on)},
                    "ms_phase": cuda_ms(lambda: phase(xd, w)),
                    "ms_cudnn": cuda_ms(lambda: cudnn(xd, w))})
            emit({"phase": "phase_conv", **out[-1]})
        del x, w, xd
        torch.cuda.empty_cache()
    return {"cases": out, "ok": all(
        (r["max_abs_err"] <= r["tol"] or r["dtype"] != "float32")
        and r["route_ok"] for r in out)}


# (layer, x shape without channels, Cin, Cout) of the k4 stride-2 down convs
# that the down4 kernel serves: wf=8 at the device batch (the generator's
# two, which name the slab's calls in the volume phase, and the
# discriminator's first) and wf=1 (64-128 channels) at its device batch;
# and the discriminator's down2.down (6^3 out), which the route leaves to
# cuDNN.  The slab's B=1 planes are checked at their own shapes in the
# volume phase.
DOWN_CONV_CASES = [("down1.down", (B, 70, 70, 70), 8, 8),
                   ("down2.down", (B, 32, 32, 32), 16, 16),
                   ("disc.down1.down", (B, 38, 38, 38), 8, 8),
                   ("wf1.down1.down", (16, 70, 70, 70), 64, 64),
                   ("wf1.down2.down", (16, 32, 32, 32), 128, 128),
                   ("disc.down2.down", (B, 14, 14, 14), 32, 32)]


def _down_conv_cases(dev, gen):
    """The k4 stride-2 VALID conv at DOWN_CONV_CASES in f32 and bf16
    (:func:`_down4_case`): f32 with at least DOWN_MIN_OUT outputs an axis
    must take the down4 kernel by default (one down4 launch), the rest and
    bf16 cuDNN's; in f32 the kernel must match its plain version."""
    from transfer_em_tpu_torch.ops.convs import DOWN_MIN_OUT

    out = []
    for name, shape, cin, cout in DOWN_CONV_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            rec = _down4_case(dev, gen, name, shape, cin, cout, dtype)
            k4 = int(dtype == torch.float32
                     and min(shape[1:]) // 2 - 1 >= DOWN_MIN_OUT)
            rec["route_ok"] = rec["default_route"] == {
                "down_k4": k4, "down_cudnn": 1 - k4, "down4": k4}
            rec["ok"] = rec["ok"] and rec["route_ok"]
            out.append(rec)
            emit({"phase": "down_conv", **rec})
            torch.cuda.empty_cache()
    return {"cases": out, "ok": all(r["ok"] for r in out)}


def _int8_tf_interop(dev, vol):
    """With TensorFlow: the seeded wf=8 generator's weights in a Keras
    reference-architecture model saved as .h5 with a meta.json beside it,
    load_generator of the .h5, make_tile_step over 16 tiles, bit-equal to
    the same step on the seeded generator."""
    from transfer_em_tpu_torch import compat
    from transfer_em_tpu_torch.config import ExportMeta
    from transfer_em_tpu_torch.infer import load_generator, make_tile_step

    gen = seeded_generator(62, dev)
    sd = {k: v.cpu().numpy() for k, v in gen.state_dict().items()}
    model, layers = compat.keras_generator(8, True, 74)
    for (path, sub), layer in zip(compat.GEN_SLOTS, layers):
        k = sd[(path if sub is None else f"{path}.{sub}") + ".kernel"]
        layer.set_weights([np.swapaxes(k, -1, -2) if sub == "up" else k])
    with tempfile.TemporaryDirectory() as tmp:
        h5 = os.path.join(tmp, "gen.h5")
        model.save(h5)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            f.write(ExportMeta(17, 40, MS_X, MS_Y).to_json())
        loaded, meta = load_generator(h5)
    tiles = _int8_tiles(vol, 16, 80)
    got = make_tile_step(loaded, MS_X, MS_Y, 2)(tiles)
    want = make_tile_step(gen, MS_X, MS_Y, 2)(tiles)
    return {"wf": meta.wf, "is3d": meta.is3d,
            "bit_equal": bool(np.array_equal(got, want)),
            "ok": bool(np.array_equal(got, want)) and meta.wf == 8}


def check_int8(dev, smi):
    """int8 serving (phase 12): conv_int8 against its plain version at
    every int8 layer (INT8_CHECKS), the int8 convs against an independent
    reference with three planted faults, the int8 goldens, the
    phase-decomposed transposed conv against cuDNN's default, the down
    convs' down4 kernel against its plain version, TF interop
    where TensorFlow imports, then the int8 tile step against f32 and bf16
    (INT8_STEPS; the first's int8 timed calls are the main path, counted)."""
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(60)
    rec = {"phase": "int8", "card": smi, "not_run": {}}
    rec["layers"] = [_int8_layer_checks(dev, *c) for c in INT8_CHECKS]
    inputs = [c.pop("inputs") for c in rec["layers"]][0]  # 3D wf=8 B=128
    rec["quant_faults"] = _quant_fault_checks(dev, inputs)
    del inputs
    rec["convs"] = _int8_conv_checks(dev, gen)
    rec["c12"] = _int8_c12_checks(dev, gen)
    rec["golden"] = _int8_goldens(dev)
    rec["phase_conv"] = _phase_conv_cases(dev, gen)
    rec["down_conv"] = _down_conv_cases(dev, gen)
    vol = smooth_volume(INT8_VOL, seed=63, dev=dev)
    tf_found = has_module("tensorflow")
    rec["packages"] = {"tensorflow": tf_found}
    if tf_found:
        rec["tf_interop"] = _int8_tf_interop(dev, vol)
    else:
        rec["not_run"]["tensorflow"] = [
            "compat: .h5 -> load_generator -> make_tile_step (TensorFlow "
            "does not import here; held on the CPU by "
            "tests/test_torch_compat.py)"]
    rec["steps"] = []
    for i, (wf, bsz) in enumerate(INT8_STEPS):
        rec["steps"].append(_int8_step_case(dev, vol, wf, bsz, i == 0))
        if i == 0:
            launches = rec["steps"][0]["int8"]["launches"]
    rec["launches"] = launches
    rec["phase_s"] = time.perf_counter() - t_phase
    rec["ok"] = bool(
        all(c["ok"] for c in rec["layers"]) and rec["convs"]["ok"]
        and rec["c12"]["ok"] and rec["quant_faults"]["ok"]
        and all(g["psnr_db"] >= 40 and g["card_vs_cpu_max_abs"] <= 1e-5
                for g in rec["golden"].values())
        and rec["phase_conv"]["ok"] and rec["down_conv"]["ok"]
        and rec.get("tf_interop", {"ok": True})["ok"]
        and all(s["ok"] for s in rec["steps"])
        and all(launches[k] > 0 for k in ("conv_int8", "quantize_int8",
                                          "preprocess_u8", "postprocess_u8",
                                          "leaky_relu"))
        and launches["conv3"] == 0)
    emit(rec)
    return rec


def _int8_sums(rows, peak=INT8_TOPS):
    """Times and bound of a generator's conv_int8 (or quantize_int8) calls,
    summed."""
    t_ops = sum(r.get("ops", 0) for r in rows) / peak * 1e3
    t_bytes = sum(r["bytes"] for r in rows) / HBM_BYTES_PER_S * 1e3
    return {"ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "library_ms": None}


def down4_kernel_line(cases, served, trained):
    """The ``kernels`` line's down4 entry from the int8 phase's
    DOWN_CONV_CASES (:func:`_down_conv_cases`): times, plain and library
    times and bound summed over the generator's two down convs of one
    B=128 tile batch (f32), the wf=1 pair at B=16 beside them; launches
    of the serving phase (``served``) and the train phase (``trained``).
    The slab's calls join it as ``slab_shapes`` from the volume phase."""
    f32 = {r["layer"]: r for r in cases if r["dtype"] == "float32"}
    keys = ("ms", "plain_ms", "library_ms", "bound_ms")

    def summed(names):
        rows = [f32[n] for n in names]
        return {**{k: sum(r[k] for r in rows) for k in keys},
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "bound_by": "+".join(sorted({r["bound_by"] for r in rows}))}

    gen_names = [c[0] for c in DOWN_CONV_CASES[:2]]
    checked = [r for r in f32.values() if "ms" in r]
    return {"name": "down4", "route": "cuda",
            "source": "transfer_em_tpu_torch/csrc/down4_tc.cu",
            "replaces": "transfer_em_tpu/ops/convs.py:62 (not a Pallas "
                        "kernel: XLA's conv, lax.conv_general_dilated, of "
                        "conv_nd's k4 stride-2 down convs)",
            "launches": served["down4"], **summed(gen_names),
            "train_launches": trained["down4"],
            "weight_packs": served["down4_weight_packs"],
            "per": "the generator's 2 down convs of one B=128 tile batch "
                   "(down1.down, down2.down), float32, LeakyReLU fused",
            "wf1_b16": summed(["wf1.down1.down", "wf1.down2.down"]),
            "checks": len(checked),
            "passed": sum(r["ok"] for r in checked),
            "layers": [{k: r.get(k) for k in (
                "layer", "shape", "out_channels", "nc", "ms", "plain_ms",
                "library_ms", "bound_ms", "bound_by", "max_abs_err",
                "default_route")} for r in f32.values()]}


def int8_kernel_lines(int8):
    """The ``kernels`` line's conv_int8 and quantize_int8 entries: times
    summed over the 12 convs (12 activations) of one int8 tile batch (3D,
    wf=8, B=128, float32 out), launches from the int8 phase's main path
    (the counted tile step)."""
    by = {(c["rank"], c["wf"]): c for c in int8["layers"]}
    main = by[(3, 8)]
    layers = [{k: r[k] for k in ("layer", "x", "kernel", "ms", "plain_ms",
                                 "bound_ms", "bound_by", "tops")}
              for r in main["layers"]]
    checks = [r for c in int8["layers"] for r in c["layers"]]
    conv = {"name": "conv_int8", "route": "cuda",
            "source": "transfer_em_tpu_torch/csrc/conv_int8.cu",
            "replaces": "transfer_em_tpu/ops/quant.py:65 (not a Pallas "
                        "kernel: the XLA int8 conv, lax.conv_general_dilated "
                        "at :65 and :89, of conv_nd_int8 and "
                        "conv_transpose_nd_int8, quant.py:56-95)",
            "launches": int8["launches"]["conv_int8"],
            **_int8_sums(main["layers"]),
            "per": "the 12 convs of one B=128 int8 tile batch (3D, wf=8, "
                   "float32 out); library_ms null: no PyTorch call "
                   "computes an int8 conv on CUDA",
            "checks": 2 * len(checks),
            "passed": sum(r["acc_equal"] + r["out_equal"] for r in checks),
            "layers": layers,
            "wf1_b4": _int8_sums(by[(3, 1)]["layers"]),
            "twod_b128": _int8_sums(by[(2, 8)]["layers"]),
            "twod_wf1_b4": _int8_sums(by[(2, 1)]["layers"])}
    f32 = PEAK_FLOPS[torch.float32]
    qrows = [r for c in int8["layers"] for r in c["quantize"]]
    quant = {"name": "quantize_int8", "route": "cuda",
             "source": "transfer_em_tpu_torch/csrc/quant_int8.cu",
             "replaces": "transfer_em_tpu/ops/quant.py:43 (not a Pallas "
                         "kernel: the XLA quantization quantize_sym :43-53, "
                         "called at :64 and :88; the redesign of the "
                         "conv_int8 site)",
             "launches": int8["launches"]["quantize_int8"],
             **_int8_sums(main["quantize"], peak=f32),
             "per": "the 12 activations of one B=128 int8 tile batch (3D, "
                    "wf=8, float32); library_ms null: no single PyTorch "
                    "call quantizes into the conv's layout",
             "checks": len(qrows),
             "passed": sum(r["equal"] for r in qrows),
             "layers": [{k: r[k] for k in ("layer", "x", "codes", "ms",
                                           "plain_ms", "bound_ms",
                                           "gb_per_s")}
                        for r in main["quantize"]],
             "faults": int8["quant_faults"]["faults"],
             "wf1_b4": _int8_sums(by[(3, 1)]["quantize"], peak=f32),
             "twod_b128": _int8_sums(by[(2, 8)]["quantize"], peak=f32),
             "twod_wf1_b4": _int8_sums(by[(2, 1)]["quantize"], peak=f32)}
    return [conv, quant]


# -- phase 14: data and halo parallelism ----------------------------------------

PAR_REQUEST = ((64, 64, 64), (128,) * 3)  # one 128^3 chunk: 64 tiles
PAR_B = 128                               # the batch a meshed call is given
HALO_RTOL, HALO_ATOL = 1e-4, 1e-5  # the JAX tests' bar (tests/test_parallel.py)
DP_B = 16                          # the DP step's global batch
# (name, mesh kwargs, input zyx extents, halo kwargs)
HALO_CASES = (("z4", dict(data=1, space=4), (160, 234, 234), {}),
              ("z2y2", dict(data=1, space=2, space_y=2), (80, 80, 234),
               dict(y_axis="space_y")))
# the kernels each meshed path must launch (halo and DP feed the generator
# floats: no pre/postprocess)
PATH_KERNELS = {"tile": ("conv3", "preprocess_u8", "postprocess_u8",
                         "leaky_relu"),
                "volume": ("conv3", "preprocess_u8", "postprocess_u8",
                           "leaky_relu"),
                "halo": ("conv3", "leaky_relu"),
                "dp": ("conv3", "leaky_relu")}
SCALE_TILES = 16                   # the DP step's tiles a card when scaling


def _cards(k):
    """k mesh positions over the visible cards in turn: ``[cuda:0] * k`` on
    one card, one position a card on k or more."""
    n = torch.cuda.device_count()
    return [torch.device("cuda", i % n) for i in range(k)]


def _workers():
    """The processes of the two-process part and their backend: two on one
    card over gloo (NCCL refuses two ranks on one device), else one a card
    over NCCL."""
    n = torch.cuda.device_count()
    return (2, "gloo") if n == 1 else (n, "nccl")


class MeshedCounts:
    """The launch counts of the meshed calls alone, summed per path: a
    window zeroes the counts as it opens and reads them as it closes (into
    the dict it yields), and every unmeshed reference runs outside the
    windows."""

    def __init__(self):
        self.paths = {}

    @contextlib.contextmanager
    def window(self, path):
        got = {}
        reset_counts()
        yield got
        got.update(read_counts())
        acc = self.paths.setdefault(path, dict.fromkeys(got, 0))
        for k, v in got.items():
            acc[k] += v

    def ok(self, paths=PATH_KERNELS):
        """Every kernel of every path launched in that path's windows."""
        return all(self.paths.get(p, {}).get(k, 0) > 0
                   for p, ks in paths.items() for k in ks)


MESHED = MeshedCounts()


def _sync_all():
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _standardized(vol_u8, dev):
    """A uint8 volume as the generator's float input, (Z, Y, X, 1)."""
    v = torch.from_numpy(np.ascontiguousarray(vol_u8)).to(dev).float()
    return ((v - 128.0) / 40.0)[..., None].contiguous()


def _halo_case(dev, gen, vol, mesh_kw, kw):
    """halo_predict over ``_cards(4)``: wall time, and each shard against
    the generator on that shard's block of the zero-padded volume (bit for
    bit under cudnn.deterministic: what halo_predict defines)."""
    from transfer_em_tpu_torch.parallel import make_mesh
    from transfer_em_tpu_torch.parallel.halo import halo_predict_fn

    mesh = make_mesh(devices=_cards(4), **mesh_kw)
    split = (0, 1) if "y_axis" in kw else (0,)
    f = halo_predict_fn(gen, mesh, 17, vol.shape[0], y_axis=kw.get("y_axis"),
                        y_extent=vol.shape[1] if "y_axis" in kw else None)
    with MESHED.window("halo"):
        f(None, vol)  # warm
        _sync_all()
        t0 = time.perf_counter()
        out = f(None, vol)
        _sync_all()
        wall = time.perf_counter() - t0
    pad = [0, 0, 0, 0, 0, 0]
    for a in split:  # F.pad's order: last axis first; channel axis unpadded
        pad[2 * (2 - a)] = pad[2 * (2 - a) + 1] = 17
    padded = F.pad(vol[..., 0], pad)[..., None]
    exact = True
    with torch.inference_mode():
        for s in out.addressable_shards:
            block = tuple(slice(s.index[a].start, s.index[a].stop + 34)
                          if a in split else slice(None) for a in range(3))
            exact = exact and torch.equal(
                s.data.to(dev), gen(padded[block][None].contiguous())[0])
    return out.gather(dev), padded, wall, exact


def check_halo(dev):
    """halo_predict in f32 on one card as 4 shards: z over 4 and z x y over
    2 x 2, each on a uint8-derived volume (a crop of a seeded smoothed
    volume, standardized).  Gates: every shard bit-equal to the generator
    on its block of the padded volume; at the JAX tests' N(0, 0.02) init,
    the whole output within their bar of one generator pass over the
    padded volume.  With the fan-in-scaled weights that whole-pass gap is
    recorded, not gated: the transposed convs' TF-SAME edges make a slab's
    last planes differ from the whole pass's (so in the JAX package too)."""
    from transfer_em_tpu_torch.models import UNetGenerator
    from transfer_em_tpu_torch.parallel import halo_predict, make_mesh

    scaled = seeded_generator(3, dev)
    init = UNetGenerator(wf=8, generator=torch.Generator().manual_seed(5))
    init = init.to(dev).eval()
    src = smooth_volume(240, seed=41, dev=dev)
    rows = {}
    with cudnn_deterministic():
        for name, mesh_kw, shape, kw in HALO_CASES:
            vol = _standardized(src[:shape[0], :shape[1], :shape[2]], dev)
            got, padded, wall, exact = _halo_case(dev, scaled, vol, mesh_kw,
                                                  kw)
            with torch.inference_mode():
                whole = scaled(padded[None])[0]
                whole0 = init(padded[None])[0]
            with MESHED.window("halo"):
                got0 = halo_predict(init, None, vol, make_mesh(
                    devices=_cards(4), **mesh_kw), 17, **kw).to(dev)
            gap = (got - whole).abs()
            ok0 = bool(torch.allclose(got0, whole0, rtol=HALO_RTOL,
                                      atol=HALO_ATOL))
            rows[name] = {
                "input": list(vol.shape), "output": list(got.shape),
                "mesh": mesh_kw, "wall_s": wall,
                "mvox_per_s": got.numel() / wall / 1e6,
                "shards_bit_equal": exact,
                "whole_pass_max_abs": float(gap.max()),
                "whole_pass_max_rel": float(gap.max() / whole.abs().max()),
                "whole_pass_planes_off": int((gap.amax(dim=(1, 2, 3))
                                              > 1e-4).sum()),
                "jax_init_within_bar": ok0,
                "jax_init_max_abs_err": float((got0 - whole0).abs().max()),
                "jax_init_output_max_abs": float(whole0.abs().max())}
    return rows


def check_dp(dev):
    """The DP step on ``_cards(2)`` at global B=16 against make_train_step
    at B=16 from the same state (redrawn weights, std-0.3 batches): dropout
    off, the 7 losses within rtol 1e-4 and every reduced gradient within
    GRAD_TOL of its own largest |g|; dropout on, the losses within rtol
    1e-4 (global masks); a second DP step packs each card's copy of the
    weights once (the state's on the first card, a replica's on another:
    it repacks after its parameter refresh)."""
    import copy

    from transfer_em_tpu_torch.config import CycleGANConfig
    from transfer_em_tpu_torch.parallel import (make_dp_train_step,
                                                make_mesh, shard_state)
    from transfer_em_tpu_torch.train import (build_step_fn, create_state,
                                             make_train_step)

    cfg = CycleGANConfig()
    state = create_state(cfg, seed=1, device=dev)
    redraw(state, 2)
    x, y = smooth_batches(DP_B, 0.3, 13, dev)
    devices = _cards(2)
    mesh = make_mesh(devices=devices)
    rec = {"batch": DP_B, "shards": 2, "devices": [str(d) for d in devices]}
    for dropout in (False, True):
        single = copy.deepcopy(state)
        meshed = shard_state(copy.deepcopy(state), mesh)
        one = (make_train_step(cfg, device=dev) if dropout
               else build_step_fn(cfg, deterministic=True))
        dp = make_dp_train_step(cfg, mesh, deterministic=not dropout)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = one(single, x, y, 7).cpu().numpy()
        single_s = time.perf_counter() - t0
        with MESHED.window("dp"):
            t0 = time.perf_counter()
            got = dp(meshed, x, y, 7).cpu().numpy()
            dp_s = time.perf_counter() - t0
        key = "dropout_on" if dropout else "dropout_off"
        rec[key] = {"losses": got.tolist(), "single_losses": want.tolist(),
                    "loss_max_rel_err": float(np.max(
                        np.abs(got - want) / np.abs(want))),
                    "single_step_s": single_s, "first_step_s": dp_s}
        if not dropout:
            rec[key]["grad_max_err_over_own_max"] = _worst(
                _grad_errors(meshed, single))
            with MESHED.window("dp") as second:
                _sync_all()
                t0 = time.perf_counter()
                dp(meshed, x, y, 8)
                _sync_all()
                rec[key]["second_step_s"] = time.perf_counter() - t0
            rec[key]["second_step_packs"] = second["conv3_weight_packs"]
            rec[key]["packs_per_single_step"] = expected_step_counts(
                state)["conv3_weight_packs"]
        del single, meshed
    off, on = rec["dropout_off"], rec["dropout_on"]
    rec["ok"] = (off["loss_max_rel_err"] <= 1e-4
                 and on["loss_max_rel_err"] <= 1e-4
                 and all(v <= GRAD_TOL for v in
                         off["grad_max_err_over_own_max"].values())
                 and off["second_step_packs"]
                 == len(set(devices)) * off["packs_per_single_step"])
    return rec


def check_to_mesh(dev):
    """EM2EM(74, wf=8).to_mesh(_cards(2)) trains one epoch of 4 steps at
    B=16 (seconds, finite losses); its checkpoint restores bit-equal into
    an unmeshed model."""
    from transfer_em_tpu_torch.parallel import make_mesh
    from transfer_em_tpu_torch.train import EM2EM

    batches = [smooth_batches(DP_B, 0.3, 20 + i, dev) for i in range(4)]
    with tempfile.TemporaryDirectory() as tmp:
        model = EM2EM(74, "par", wf=8, checkpoint_root=tmp, device=dev)
        model.to_mesh(make_mesh(devices=_cards(2)))
        log = os.path.join(tmp, "metrics.jsonl")
        with MESHED.window("dp"):
            _sync_all()
            t0 = time.perf_counter()
            model.train([b[0] for b in batches], [b[1] for b in batches],
                        epochs=1, metrics_log=log)
            _sync_all()
            epoch_s = time.perf_counter() - t0
        epoch = json.loads(open(log).read().splitlines()[-1])
        restored = EM2EM(74, "par", wf=8, checkpoint_root=tmp, device=dev,
                         seed=9)
        equal = _states_equal(model.state, restored.state)
    losses = list(epoch["loss"].values())
    return {"epoch_s": epoch_s, "steps": epoch["steps"], "losses": losses,
            "tiles_per_s": 4 * DP_B / epoch_s,
            "restored_unmeshed_bit_equal": equal,
            "ok": (equal and epoch["steps"] == 4
                   and all(math.isfinite(v) for v in losses))}


def check_to_mesh_prior(dev):
    """EM2EM(74, is3d=False, wf=8, disc_prior=p).to_mesh(_cards(2))
    against the same model unmeshed, both redrawn as check_dp's state:
    disc_y's copy on each position's device runs a prior of its own there
    (``mesh.replicas``).  Two steps at
    B=16 (dropout on, the global masks): the 7 losses within rtol 1e-4 and,
    after the first, every gradient within GRAD_TOL of its own largest
    |g|."""
    from transfer_em_tpu_torch.parallel import make_mesh
    from transfer_em_tpu_torch.parallel.mesh import replicas
    from transfer_em_tpu_torch.train import EM2EM
    from transfer_em_tpu_torch.train.cgan import _tap_prior

    def prior():
        return _tap_prior(seeded_generator(65, dev, is3d=False), "down1")

    devices = _cards(2)
    rec = {"batch": DP_B, "devices": [str(d) for d in devices], "steps": []}
    with tempfile.TemporaryDirectory() as tmp:
        kw = dict(is3d=False, wf=8, checkpoint_root=tmp, device=dev, seed=0)
        one = EM2EM(74, "prior_one", disc_prior=prior(), **kw)
        dp = EM2EM(74, "prior_dp", disc_prior=prior(), **kw)
        for m in (one, dp):  # O(1) gradients in every network
            redraw(m.state, 2)
        dp.to_mesh(make_mesh(devices=devices))
        for i in range(2):
            x, y = smooth_batches(DP_B, 0.3, 40 + i, dev, ndim=2)
            want = one.train_step(x, y).cpu().numpy()
            with MESHED.window("dp"):
                got = dp.train_step(x, y).cpu().numpy()
            row = {"losses": got.tolist(), "single_losses": want.tolist(),
                   "loss_max_rel_err": float(np.max(
                       np.abs(got - want) / np.abs(want)))}
            if i == 0:
                row["grad_max_err_over_own_max"] = _worst(
                    _grad_errors(dp.state, one.state))
            rec["steps"].append(row)
        reps = replicas(dp.state.dy, devices)
        rec["prior_devices"] = [
            str(next(iter(r.disc_prior.params.values())).device)
            for r in reps]
        rec["prior_on_own_device"] = all(
            next(iter(r.disc_prior.params.values())).device == d
            for r, d in zip(reps, devices))
    rec["ok"] = bool(
        rec["prior_on_own_device"]
        and all(r["loss_max_rel_err"] <= 1e-4 for r in rec["steps"])
        and all(v <= GRAD_TOL for v in
                rec["steps"][0]["grad_max_err_over_own_max"].values()))
    return rec


def check_mesh_inference(dev, gen, vol, vol_d):
    """Each inference mesh= path on ``_cards(2)`` (data=2) against the
    unmeshed call at the same batch a device, bit for bit under
    cudnn.deterministic, with Mvox/s of each (one warm call, one timed)
    with cuDNN's default algorithms and under cudnn.deterministic:
    predict_tiled on a 128^3 chunk, ModelService serving it (deterministic
    only), and predict_volume at the volume phase's 360^3 request in device
    and stream mode."""
    from transfer_em_tpu_torch.config import ExportMeta
    from transfer_em_tpu_torch.infer import (export_generator, predict_tiled,
                                             predict_volume)
    from transfer_em_tpu_torch.infer.tiling import plan_tiles, tile_batch
    from transfer_em_tpu_torch.native import gather_box
    from transfer_em_tpu_torch.parallel import make_mesh
    from transfer_em_tpu_torch.serve import (ModelService, NumpyVolume,
                                             register_volume)

    mesh = make_mesh(devices=_cards(2))
    start, size = PAR_REQUEST
    n_chunk = plan_tiles(start, size, 40, 17).num_tiles
    chunk_b = tile_batch(n_chunk, PAR_B, 2) // 2  # tiles a device a step

    def fetch(c, n):
        return gather_box(vol, c, (n,) * 3)

    def tiled(m, b):
        return predict_tiled(fetch, gen, start, size, 40, 17, MS_X, MS_Y,
                             batch_size=b, mesh=m, device=dev)

    def volume(mode):
        src = vol_d if mode == "device" else vol
        return lambda m, b: predict_volume(src, gen, VOL_START, VOL_SIZE,
                                           MS_X, MS_Y, mode=mode,
                                           batch_size=b, mesh=m, device=dev)

    # (run, voxels, batch meshed, batch unmeshed, the path it counts for)
    runs = {"predict_tiled": (tiled, math.prod(size), PAR_B, chunk_b,
                              "tile"),
            "device": (volume("device"), math.prod(VOL_SIZE), PAR_B, PAR_B,
                       "volume"),
            "stream": (volume("stream"), math.prod(VOL_SIZE), PAR_B, PAR_B,
                       "volume")}
    rows, outs = {}, {}
    for det in (False, True):
        ctx = cudnn_deterministic() if det else contextlib.nullcontext()
        with ctx:
            for name, (run, nvox, b_mesh, b_single, path) in runs.items():
                row = rows.setdefault(name, {"batch_a_device": b_single})
                for tag, m, b in (("single", None, b_single),
                                  ("mesh", mesh, b_mesh)):
                    key = tag + ("_deterministic" if det else "")
                    with (MESHED.window(path) if m is not None
                          else contextlib.nullcontext()):
                        run(m, b)
                        _sync_all()
                        t0 = time.perf_counter()
                        outs[name, tag] = np.asarray(run(m, b))
                        row[key + "_s"] = time.perf_counter() - t0
                    row[key + "_mvox_per_s"] = nvox / row[key + "_s"] / 1e6
                if det:
                    row["bit_equal"] = bool(np.array_equal(
                        outs[name, "mesh"], outs[name, "single"]))
    with cudnn_deterministic():
        register_volume("smoke/par", NumpyVolume(vol))
        with tempfile.TemporaryDirectory() as tmp:
            export_generator(gen, ExportMeta(17, 40, MS_X, MS_Y, dimsize=74,
                                             wf=gen.wf),
                             os.path.join(tmp, "models", "par", "v1"))
            row, blocks = {}, {}
            # 4 tiles a device a batch however the request's tiles group:
            # the batcher pads a group of k tiles to min(8 ceil(k / 8),
            # max(max_batch, k)) rounded up to the data axis
            for tag, m, mb in (("single", None, 4), ("mesh", mesh, 8)):
                svc = ModelService(model_root=os.path.join(tmp, "models"),
                                   mesh=m, max_batch=mb, device=dev)
                svc.start()
                try:
                    with (MESHED.window("tile") if m is not None
                          else contextlib.nullcontext()):
                        for rep in range(2):  # the first loads the model
                            dest = os.path.join(tmp, f"out_{tag}{rep}")
                            cfg = {"location": "smoke/par",
                                   "start": list(start),
                                   "glbstart": [0, 0, 0], "size": list(size),
                                   "model_name": "par:v1", "dest": dest}
                            req = urllib.request.Request(
                                svc.url + "/", data=json.dumps(cfg).encode(),
                                headers={"Content-type": "application/json"})
                            t0 = time.perf_counter()
                            body = urllib.request.urlopen(
                                req, timeout=600).read()
                            wall = time.perf_counter() - t0
                            if body != b"success":
                                fail("parallel",
                                     f"ModelService {tag}: {body!r}")
                finally:
                    svc.stop()
                blocks[tag] = {n: gzip.decompress(open(os.path.join(
                    dest, n), "rb").read()) for n in sorted(os.listdir(dest))}
                row[tag + "_deterministic_s"] = wall
                row[tag + "_deterministic_mvox_per_s"] = (math.prod(size)
                                                          / wall / 1e6)
            row["bit_equal"] = (
                len(blocks["mesh"]) == math.prod(s // 64 for s in size)
                and blocks["mesh"] == blocks["single"])
            rows["model_service"] = row
    return rows


def parallel_worker(rank, port, outdir):
    """One process of the two-process part (``_workers()``: two on one card
    over gloo, else one a card over NCCL): one DP step on this process's
    rows of the global B=16 batch (dropout off), a halo ring of one 40-deep
    shard a process across the process boundaries (this process's shard
    against the generator on its slab of the padded volume); the launch
    counts of the DP steps and of the ring, each read just after them;
    rank 0 also writes the reduced gradients for the parent to hold against
    its single-process step."""
    import torch.distributed as dist

    from transfer_em_tpu_torch.config import CycleGANConfig
    from transfer_em_tpu_torch.parallel import (halo_predict_fn,
                                                host_local_batch,
                                                make_dp_train_step, make_mesh,
                                                shard_state)
    from transfer_em_tpu_torch.parallel.distributed import (barrier,
                                                            initialize)
    from transfer_em_tpu_torch.device import float32_exact
    from transfer_em_tpu_torch.train import create_state

    float32_exact()
    torch.backends.cudnn.deterministic = True
    nproc, backend = _workers()
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    initialize(f"127.0.0.1:{port}", nproc, rank, backend=backend,
               timeout_s=300)
    mesh = make_mesh(devices=[dev])
    res = {"rank": rank, "backend": dist.get_backend(), "device": str(dev),
           "mesh": repr(mesh), "launches": {}}
    cfg = CycleGANConfig()
    state = create_state(cfg, seed=1, device=dev)
    redraw(state, 2)
    x, y = smooth_batches(DP_B, 0.3, 13, dev)
    per = DP_B // nproc
    rows = slice(rank * per, (rank + 1) * per)
    shard_state(state, mesh)
    step = make_dp_train_step(cfg, mesh, deterministic=True)
    xs, ys = host_local_batch(x[rows], mesh), host_local_batch(y[rows], mesh)
    reset_counts()
    t0 = time.perf_counter()
    res["losses"] = step(state, xs, ys, 7).tolist()
    res["dp_first_step_s"] = time.perf_counter() - t0
    if rank == 0:
        torch.save({t: {n: p.grad.cpu() for n, p in
                        getattr(state, t).named_parameters()} for t in TREES},
                   os.path.join(outdir, "grads.pt"))
    t0 = time.perf_counter()
    step(state, xs, ys, 8).tolist()
    res["dp_second_step_s"] = time.perf_counter() - t0
    res["launches"]["dp"] = read_counts()
    gen = seeded_generator(3, dev)
    depth = 40 * nproc
    vol = _standardized(smooth_volume(depth, seed=43, dev=dev)[:, :74, :74],
                        dev)
    smesh = make_mesh(devices=[dev], data=1, space=nproc)
    reset_counts()
    t0 = time.perf_counter()
    out = halo_predict_fn(gen, smesh, 17, depth)(None, vol)
    torch.cuda.synchronize()
    res["halo_s"] = time.perf_counter() - t0
    res["launches"]["halo"] = read_counts()
    padded = F.pad(vol, (0, 0, 0, 0, 0, 0, 17, 17))
    res["halo_shards"] = []
    with torch.inference_mode():
        for s in out.addressable_shards:
            lo = s.index[0].start
            res["halo_shards"].append({
                "z": [lo, s.index[0].stop],
                "bit_equal": bool(torch.equal(
                    s.data, gen(padded[None, lo:lo + 74])[0]))})
    barrier("parallel_worker_done")
    with open(os.path.join(outdir, f"worker_{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def check_two_processes(dev):
    """The processes of ``_workers()`` (this script, ``--parallel-worker``):
    their DP step against the single-process step from the same state and
    batches (the losses within rtol 1e-4, rank 0's reduced gradients within
    GRAD_TOL), every rank's losses equal, each halo shard bit-equal, and in
    every worker the DP steps and the ring each launching conv3 and
    LeakyReLU."""
    import copy

    from transfer_em_tpu_torch.config import CycleGANConfig
    from transfer_em_tpu_torch.train import build_step_fn, create_state

    nproc, backend = _workers()
    with tempfile.TemporaryDirectory() as tmp:
        port = str(_free_port())
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--parallel-worker",
             str(rank), port, tmp], cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for rank in range(nproc)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=300)[0])
        finally:
            for p in procs:  # a failed or hung group must not outlive us
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        wall = time.perf_counter() - t0
        codes = [p.returncode for p in procs]
        if any(codes):
            fail("parallel", "a worker process failed", codes=codes,
                 logs=[lg[-3000:] for lg in logs])
        workers = [json.load(open(os.path.join(tmp, f"worker_{r}.json")))
                   for r in range(nproc)]
        grads = torch.load(os.path.join(tmp, "grads.pt"))
    cfg = CycleGANConfig()
    state = create_state(cfg, seed=1, device=dev)
    redraw(state, 2)
    x, y = smooth_batches(DP_B, 0.3, 13, dev)
    single = copy.deepcopy(state)
    with cudnn_deterministic():
        want = build_step_fn(cfg, deterministic=True)(single, x, y, 7)
    want = want.cpu().numpy()
    got = np.asarray(workers[0]["losses"])
    errs = {}
    for t in TREES:
        errs[t] = max(float((grads[t][n] - p.grad.cpu()).abs().max()
                            / p.grad.cpu().abs().max().clamp_min(1e-30))
                      for n, p in getattr(single, t).named_parameters())
    rec = {"processes": nproc, "wall_s": wall, "workers": workers,
           "loss_max_rel_err": float(np.max(np.abs(got - want)
                                            / np.abs(want))),
           "ranks_equal": all(w["losses"] == workers[0]["losses"]
                              for w in workers),
           "grad_max_err_over_own_max": errs}
    rec["ok"] = (rec["loss_max_rel_err"] <= 1e-4 and rec["ranks_equal"]
                 and all(v <= GRAD_TOL for v in errs.values())
                 and all(s["bit_equal"] for w in workers
                         for s in w["halo_shards"])
                 and all(w["backend"] == backend for w in workers)
                 and all(w["launches"][p][k] > 0 for w in workers
                         for p in ("dp", "halo")
                         for k in PATH_KERNELS[p]))
    return rec


def check_nccl(dev):
    """One rank over NCCL (world size 1): initialize, make_mesh() over the
    local card, one DP step (dropout off, its gradient all-reduce and
    shard_state's broadcast on NCCL) against the single-process step."""
    import copy

    import torch.distributed as dist

    from transfer_em_tpu_torch.config import CycleGANConfig
    from transfer_em_tpu_torch.parallel import (make_dp_train_step,
                                                make_mesh, shard_state)
    from transfer_em_tpu_torch.parallel.distributed import initialize
    from transfer_em_tpu_torch.train import build_step_fn, create_state

    cfg = CycleGANConfig()
    state = create_state(cfg, seed=1, device=dev)
    redraw(state, 2)
    x, y = smooth_batches(DP_B // 2, 0.3, 17, dev)
    single = copy.deepcopy(state)
    want = build_step_fn(cfg, deterministic=True)(single, x, y, 7)
    t0 = time.perf_counter()
    initialize(f"127.0.0.1:{_free_port()}", 1, 0, backend="nccl",
               timeout_s=120)
    try:
        init_s = time.perf_counter() - t0
        backend = dist.get_backend()
        mesh = make_mesh()
        shard_state(state, mesh)
        with MESHED.window("dp"):
            got = make_dp_train_step(cfg, mesh, deterministic=True)(
                state, x, y, 7)
            torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    rel = float(((got - want).abs() / want.abs()).max())
    return {"backend": backend, "init_s": init_s, "mesh": repr(mesh),
            "loss_max_rel_err": rel,
            "ok": backend == "nccl" and rel <= 1e-4}


def check_scaling(dev):
    """With two or more cards: predict_volume(mode="device") at the volume
    phase's 360^3 request (B=128 a card) and the DP step (dropout on) at
    16 tiles a card, each on 1, 2 and every card (one position a card):
    Mvox/s and tiles/s (the median of three timed calls or of steps 2-4);
    under cudnn.deterministic the every-card volume bit-equal to the
    one-card one."""
    import statistics

    from transfer_em_tpu_torch.config import CycleGANConfig
    from transfer_em_tpu_torch.infer import predict_volume
    from transfer_em_tpu_torch.parallel import (make_dp_train_step,
                                                make_mesh, shard_state)
    from transfer_em_tpu_torch.train import create_state, make_train_step

    n = torch.cuda.device_count()
    ks = sorted({1, 2, n})
    gen = seeded_generator(3, dev)
    vol = torch.from_numpy(smooth_volume(VOL_SIDE, 31, dev)).to(dev)

    def volume(k):
        mesh = make_mesh(devices=_cards(k)) if k > 1 else None
        return predict_volume(vol, gen, VOL_START, VOL_SIZE, MS_X, MS_Y,
                              mode="device", batch_size=VOL_B, mesh=mesh,
                              device=dev, as_numpy=False)

    rec = {"cards": n, "mvox_per_s": {}, "dp_step_s": {},
           "dp_tiles_per_s": {}, "dp_tiles_a_card": SCALE_TILES}
    for k in ks:
        volume(k)
        times = []
        for _ in range(3):
            _sync_all()
            t0 = time.perf_counter()
            volume(k)
            _sync_all()
            times.append(time.perf_counter() - t0)
        rec["mvox_per_s"][k] = (math.prod(VOL_SIZE)
                                / statistics.median(times) / 1e6)
    with cudnn_deterministic():
        rec["volume_bit_equal"] = bool(torch.equal(volume(1), volume(n)))
    del vol
    cfg = CycleGANConfig()
    for k in ks:
        state = create_state(cfg, seed=1, device=dev)
        redraw(state, 2)
        x, y = smooth_batches(SCALE_TILES * k, 0.3, 13, dev)
        if k == 1:
            step = make_train_step(cfg, device=dev)
        else:
            mesh = make_mesh(devices=_cards(k))
            shard_state(state, mesh)
            step = make_dp_train_step(cfg, mesh)
        times = []
        for i in range(4):
            t0 = time.perf_counter()
            step(state, x, y, i).cpu()
            times.append(time.perf_counter() - t0)
        rec["dp_step_s"][k] = statistics.median(times[1:])
        rec["dp_tiles_per_s"][k] = SCALE_TILES * k / rec["dp_step_s"][k]
        del state, step
        torch.cuda.empty_cache()
    rec["ok"] = rec["volume_bit_equal"]
    return rec


def check_parallel(dev, smi):
    """Phase 14: every mesh= of the port on ``_cards(k)`` meshes (this card
    repeated, or one position a card), halo_predict, the DP step and
    EM2EM.to_mesh, the worker processes and one NCCL rank; with two or
    more cards, the scaling timings too.  The launch counts are those of
    the meshed calls alone (``MESHED``'s windows, per path); each worker
    process counts its own."""
    t_phase = time.perf_counter()
    MESHED.paths.clear()
    gen = seeded_generator(3, dev)
    vol = smooth_volume(VOL_SIDE, seed=31, dev=dev)
    vol_d = torch.from_numpy(vol).to(dev)
    inference = check_mesh_inference(dev, gen, vol, vol_d)
    halo = check_halo(dev)
    dp = check_dp(dev)
    to_mesh = check_to_mesh(dev)
    to_mesh_prior = check_to_mesh_prior(dev)
    del vol_d
    torch.cuda.empty_cache()
    two = check_two_processes(dev)
    nccl = check_nccl(dev)
    scaling = (check_scaling(dev) if torch.cuda.device_count() > 1
               else None)
    by_path = {p: dict(c) for p, c in MESHED.paths.items()}
    launches = {k: sum(c[k] for c in by_path.values())
                for k in next(iter(by_path.values()))}
    rec = {"phase": "parallel", "card": smi,
           "cards": torch.cuda.device_count(), "inference": inference,
           "halo": halo, "dp": dp, "to_mesh": to_mesh,
           "to_mesh_prior": to_mesh_prior,
           "two_processes": two, "nccl": nccl, "scaling": scaling,
           "launches": launches, "launches_by_path": by_path,
           "seconds": time.perf_counter() - t_phase}
    rec["ok"] = (all(r["bit_equal"] for r in inference.values())
                 and all(r["shards_bit_equal"] and r["jax_init_within_bar"]
                         for r in halo.values())
                 and dp["ok"] and to_mesh["ok"] and to_mesh_prior["ok"]
                 and two["ok"] and nccl["ok"]
                 and (scaling is None or scaling["ok"])
                 and MESHED.ok())
    emit(rec)
    return rec


# -- phase 15: the user recipes (examples/torch/) ----------------------------

EXAMPLES_DIR = os.path.join(ROOT, "examples", "torch")
ALL_FOUR = ("preprocess_u8", "conv3", "leaky_relu", "postprocess_u8")
# The kernels each recipe's path must launch: the 3D inference recipes all
# four, the 3D training recipes conv3 and LeakyReLU, the 2D recipe LeakyReLU
# (its convs stay on cuDNN, as JAX keeps its Pallas conv to 3D).
EXAMPLE_KERNELS = {
    "run_local_predict": ALL_FOUR,
    "simple_training_2d": ("leaky_relu",),
    "generator_training_3d": ("conv3", "leaky_relu"),
    "streaming_training_3d_local": ("conv3", "leaky_relu"),
    "cloudrun_test_3d": ALL_FOUR,
    "run_cloud_predict_service": ALL_FOUR,
    "multichip_inference": ALL_FOUR,
}
EX_WF = 8  # the JAX recipes' default width (cloudrun_test_3d keeps its 32)


def load_example(name):
    """The recipe ``examples/torch/<name>.py`` as a module of its own."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_example_" + name, os.path.join(EXAMPLES_DIR, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ex_local_predict(dev, ex, counted):
    """A seeded wf=8 EM2EM's checkpoint at step 1 (the generator's weights
    of std 1/sqrt(fan-in), so the output spans the uint8 range), then the
    recipe on the card (counted) and on the CPU from the same checkpoint:
    within one level on at most 1e-3 of the voxels."""
    from transfer_em_tpu_torch.train import EM2EM

    model = EM2EM(74, "lp_smoke", wf=EX_WF, device=dev)
    model.state.gg.load_state_dict(seeded_generator(41, dev).state_dict())
    model.make_checkpoint(1)
    model.wait_until_finished()
    got = counted(lambda: ex.main(1, "lp_smoke", wf=EX_WF, device="cuda"))
    want = ex.main(1, "lp_smoke", wf=EX_WF, device="cpu")
    worst, share = _u8_diff(got, want)
    return {"shape": list(got.shape),
            "vs_cpu": {"max": worst, "share": share},
            "range": [int(got.min()), int(got.max())],
            "ok": (got.shape == want.shape == (72, 72, 72)
                   and worst <= 1 and share <= 1e-3
                   and int(got.max()) - int(got.min()) > 64)}


def _ex_simple_2d(dev, ex, counted):
    counted(lambda: ex.main(epochs=2, wf=EX_WF, device="cuda"))
    with open("simple2d_metrics.jsonl") as f:
        logged = [json.loads(line) for line in f]
    return {"epochs_logged": len(logged),
            "png": os.path.exists("simple2d_sample.png"),
            "ok": len(logged) == 2 and os.path.exists("simple2d_sample.png")}


def _ex_generator_3d(dev, ex, counted):
    """Two smoothed 256^3 volumes behind the port's DataService on
    127.0.0.1; 1 epoch of 8 tiles at B=4, in the recipe's bfloat16."""
    from transfer_em_tpu_torch.serve import (DataService, NumpyVolume,
                                             register_volume)

    register_volume("ex/x", NumpyVolume(smooth_volume(256, 51, dev)))
    register_volume("ex/y", NumpyVolume(smooth_volume(256, 52, dev)))
    svc = DataService()
    svc.start()
    try:
        model = counted(lambda: ex.main(
            "ex/x", "ex/y", cloudrun=svc.url, epochs=1, wf=EX_WF,
            batch_size=4, epoch_size=8, bbox=((0, 0, 0), (256, 256, 256)),
            exp_name="gen3d_smoke", device="cuda"))
    finally:
        svc.stop()
    finite = all(bool(torch.isfinite(p).all())
                 for p in model.state.gg.parameters())
    return {"steps": int(model.state.step),
            "compute_dtype": str(model.config.compute_dtype),
            "ok": int(model.state.step) == 2 and finite}


def _ex_streaming_3d(dev, ex, counted):
    rmse = counted(lambda: ex.main(epochs=2, wf=EX_WF, batch_size=4,
                                   epoch_size=16, device="cuda"))
    return {"rmse": rmse, "ok": bool(np.isfinite(rmse))}


def _ex_as_is(dev, ex, counted):
    """The recipe's main at its defaults; its own asserts (the stitching's,
    the services') are the check."""
    counted(lambda: ex.main(device="cuda"))
    return {"ok": True}


def _ex_multichip(dev, ex, counted):
    """Every visible card, or this card four times over."""
    devices = (None if torch.cuda.device_count() > 1
               else [torch.device("cuda", 0)] * 4)
    losses = counted(lambda: ex.main(wf=EX_WF, steps=2,
                                     exp_name="multichip_smoke",
                                     device="cuda", devices=devices))
    return {"devices": (torch.cuda.device_count() if devices is None
                        else [str(d) for d in devices]),
            "losses": [float(v) for v in losses],
            "ok": bool(np.all(np.isfinite(losses)))}


EXAMPLE_RUNS = (("run_local_predict", _ex_local_predict),
                ("simple_training_2d", _ex_simple_2d),
                ("generator_training_3d", _ex_generator_3d),
                ("streaming_training_3d_local", _ex_streaming_3d),
                ("cloudrun_test_3d", _ex_as_is),
                ("run_cloud_predict_service", _ex_as_is),
                ("multichip_inference", _ex_multichip))


def run_example(dev, name, check):
    """One recipe in a fresh temporary directory: its set-up, its main on
    the card between reset_counts and read_counts (wall seconds around that
    call alone), then its checks.  The recipe's own prints go to
    ``examples_<name>.log`` under --out.  An exception fails the recipe;
    its record carries the error."""
    import contextlib
    import io
    import traceback

    window = {}

    def counted(run):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        window["seconds"] = time.perf_counter() - t0
        window["launches"] = read_counts()
        return out

    rec = {"phase": "examples", "example": name}
    cwd = os.getcwd()
    printed = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            with contextlib.redirect_stdout(printed):
                rec.update(check(dev, load_example(name), counted))
        except Exception as e:  # noqa: BLE001 — recorded, then failed
            rec.update(ok=False, error=f"{type(e).__name__}: {e}",
                       traceback=traceback.format_exc()[-2000:])
        finally:
            os.chdir(cwd)
    _write_out(f"examples_{name}.log", printed.getvalue())
    launches = window.get("launches", {})
    rec["seconds"] = window.get("seconds")
    rec["launches"] = launches
    rec["must_launch"] = list(EXAMPLE_KERNELS[name])
    launched = all(launches.get(k, 0) > 0 for k in EXAMPLE_KERNELS[name])
    rec["ok"] = bool(rec.get("ok")) and launched
    if not launched and "error" not in rec:
        rec["error"] = "a kernel of the recipe's path did not launch"
    emit(rec)
    return rec


def check_examples(dev, smi):
    """Phase 15: every recipe of examples/torch/ on the card at wf=8 (the
    JAX recipes' default; cloudrun_test_3d keeps its wf=32), each in a
    temporary directory with few epochs, its kernel launches counted alone
    and gated above zero for the kernels its path runs, its own asserts
    holding, run_local_predict's output against the same recipe on the
    CPU.  migrate_tf_assets, TensorFlow interop, is held on the CPU
    (tests/test_torch_examples.py) and listed here as not run."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    recipes = {name: run_example(dev, name, check)
               for name, check in EXAMPLE_RUNS}
    not_run = {"migrate_tf_assets": {
        "run": False, "why": "no tensorflow on the card's machine"}}
    rec = {"phase": "examples", "card": smi,
           "seconds": time.perf_counter() - t_phase,
           "recipes": {n: {k: r.get(k) for k in ("seconds", "ok", "error")}
                       for n, r in recipes.items()},
           "not_run": not_run,
           "launches_by_recipe": {n: r["launches"]
                                  for n, r in recipes.items()},
           "ok": all(r["ok"] for r in recipes.values())}
    emit(rec)
    return rec


# -- phase 16: the model at its full widths (wf=1) ---------------------------

WIDE_WF = 1
WIDE_B = 16        # the wf=1 tile step's batch (default_batch_size)
WIDE_DISC_B = 16   # the discriminators' first round at bench B=8 (2 x 8)
WIDE_CHECK_B = 2   # the wf=1 train checks' batch
# a stem activation of 128 * 72^3 * 64 = 3.06e9 elements, past 2^31
WIDE_BIG_B = 128
# bench_wf1.py's first three configs in bf16, and one in f32
WIDE_BENCH = (("bfloat16", dict(batch=8)), ("bfloat16", dict(batch=8,
                                                             remat=True)),
              ("bfloat16", dict(batch=16, accum=2)),
              ("float32", dict(batch=4)))
WIDE_PROFILED = ("bfloat16 B=8", "float32 B=4")
WIDE_VOL_SIDE = 220            # a 180^3 request: 125 tiles
WIDE_VOL_BATCHES = (8, 16, 32)
WIDE_SERVE = ((0, 0, 0), (128, 64, 0), (64, 128, 128))  # of a 256^3 volume
WIDE_PATHS = {"train": ("conv3", "leaky_relu"),
              "serve": ("conv3", "preprocess_u8", "postprocess_u8",
                        "leaky_relu"),
              "volume": ("conv3", "preprocess_u8", "postprocess_u8",
                         "leaky_relu")}


def wide_layers():
    """The wf=1 networks' k3 convs as (layer, input side, C, O, epilogue
    on the main path), generator and discriminator, and the generator's
    standalone LeakyReLUs (after its k4 down and transposed convs) as
    one tile's shape: from the modules' own forward
    (bench.train.conv_layers, on fake tensors)."""
    from transfer_em_tpu_torch.bench.train import conv_layers
    from transfer_em_tpu_torch.models import Discriminator, UNetGenerator

    gen = conv_layers(lambda: UNetGenerator(wf=WIDE_WF), (1, 74, 74, 74, 1))
    disc = conv_layers(lambda: Discriminator(wf=WIDE_WF), (1, 40, 40, 40, 1))

    def k3(layers, prefix):
        return [(prefix + r["name"], r["in_shape"][1], r["kernel"][3],
                 r["kernel"][4], not (prefix == "" and r["name"] == "out"))
                for r in layers if r["kind"] == "k3"]

    leaky = [r["out_shape"][1:] for r in gen
             if r["kind"] in ("k4_down", "transposed")]
    return k3(gen, ""), k3(disc, "disc."), leaky


def conv3_plan_record(c, o, dtype):
    """How conv3 tiles a (C -> O) conv in ``dtype``: the tensor-core plan
    (channel blocks, output chunks = blockIdx.y, residency) or the direct
    kernel's channel passes and output splits."""
    from transfer_em_tpu_torch.ops import cuda_conv

    if cuda_conv.conv3_path(c, o) == "direct":
        ot = next(n for n in (1, 2, 4, 8) if n >= min(o, 8))
        return {"path": "direct", "c_passes": -(-c // 4), "ot": ot,
                "o_splits": -(-o // ot)}
    p = cuda_conv.conv3_plan(c, o, dtype)
    return {"path": "tc", "cb": p.cb, "n_cb": p.n_cb, "nc": p.nc,
            "n_chunks": p.n_chunks, "planes": p.planes,
            "resident": p.resident, "smem_bytes": p.smem_bytes}


def _wide_conv3(dev, gen, gen_k3, disc_k3):
    """conv3 in f32 and bf16, with and without the epilogue, at every wf=1
    k3 shape (the generator's ``gen_k3`` at WIDE_B tiles, the
    discriminator's ``disc_k3`` at WIDE_DISC_B), against its plain version
    at phase 3's tolerances, timed beside the bound and F.conv3d (+
    F.leaky_relu), each with its plan; per dtype and network, totals over
    the main path's own calls."""
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "t_bytes", "t_ops")
    out = {}
    for dtype, rel_tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
        dname = str(dtype).replace("torch.", "")
        for net, layers, bsz in (("gen", gen_k3, WIDE_B),
                                 ("disc", disc_k3, WIDE_DISC_B)):
            tot = {**dict.fromkeys(keys, 0.0), "max_abs_err": 0.0,
                   "rel_err": 0.0, "checks": 0, "passed": 0, "layers": []}
            for name, s, c, o, main_act in layers:
                plan = conv3_plan_record(c, o, dtype)
                for act in (False, True):
                    rec = _conv3_case(
                        dev, gen, dtype, rel_tol, name, (bsz, s, s, s), c, o,
                        act, extra={"phase": "wide_kernel", "wf": WIDE_WF,
                                    "plan": plan})
                    tot["checks"] += 1
                    tot["passed"] += int(rec["ok"])
                    if act != main_act:
                        continue
                    tot["layers"].append(name)
                    tot["ms"] += rec["kernel_ms"]
                    for k in keys[1:]:
                        tot[k] += rec[k]
                    tot["max_abs_err"] = max(tot["max_abs_err"],
                                             rec["max_abs_err"])
                    tot["rel_err"] = max(tot["rel_err"], rec["max_abs_err"]
                                         / max(rec["ref_max_abs"], 1e-30))
            tot["bound_by"] = ("operations" if tot.pop("t_ops")
                               > tot.pop("t_bytes") else "bytes")
            out[f"{net}_{dname}"] = tot
            torch.cuda.empty_cache()
    return out


def _wide_past_2_31(dev, gen):
    """Tensors past 2^31 elements through the kernels' 64-bit offsets, f32,
    B = WIDE_BIG_B: the stem (direct kernel, with its epilogue; 3.06e9
    outputs), LeakyReLU on that output, and down1.conv (tensor-core
    kernel) on it (2.81e9 outputs), each against its plain version 16
    tiles at a time (conv3 within 1e-4 max(1, |ref|), LeakyReLU
    bit-equal)."""
    from transfer_em_tpu_torch.ops import cuda_conv
    from transfer_em_tpu_torch.ops import cuda_kernels as ck

    b = WIDE_BIG_B
    res = {}

    def sliced(name, got, plain, src, rel_tol):
        err = ref_max = 0.0
        for i in range(0, b, 16):
            ref = plain(src[i:i + 16])
            err = max(err, (got[i:i + 16] - ref).abs().max().item())
            ref_max = max(ref_max, ref.abs().max().item())
            del ref
        tol = rel_tol * max(1.0, ref_max)
        res[name] = {"numel": got.numel(), "max_abs_err": err, "tol": tol,
                     "ok": err <= tol and got.numel() > 2 ** 31 - 1}

    with torch.no_grad():
        x = torch.randn((b, 74, 74, 74, 1), generator=gen, device=dev)
        w1 = torch.randn((3, 3, 3, 1, 64), generator=gen,
                         device=dev) / 27 ** 0.5
        w2 = torch.randn((3, 3, 3, 64, 64), generator=gen,
                         device=dev) / (27 * 64) ** 0.5
        reset_counts()
        y = cuda_conv.conv3(x, w1, 0.3)
        sliced("conv3.direct stem", y,
               lambda t: cuda_conv.conv3_plain(t, w1, 0.3), x, 1e-4)
        z = ck.leaky_relu(y)
        sliced("leaky_relu", z, ck.leaky_relu_plain, y, 0.0)
        del z
        u = cuda_conv.conv3(y, w2, 0.3)
        sliced("conv3.tc down1.conv", u,
               lambda t: cuda_conv.conv3_plain(t, w2, 0.3), y, 1e-4)
        launches = read_counts()
        del u, y, x
    torch.cuda.empty_cache()
    rec = {"phase": "wide_past_2_31", "batch": b, "cases": res,
           "launches": {k: launches[k] for k in ("conv3_direct", "conv3_tc",
                                                 "leaky_relu")},
           "ok": all(c["ok"] for c in res.values())}
    emit(rec)
    return rec


def _wide_elementwise(dev, gen, leaky_shapes):
    """preprocess, postprocess and LeakyReLU (f32 and bf16, at the
    generator's 4 standalone activations ``leaky_shapes``, summed) at the
    wf=1 tile step's shapes (WIDE_B tiles), each against its plain
    version, timed as in phase 3."""
    out = {}
    x = torch.randint(0, 256, (WIDE_B, 74, 74, 74), generator=gen,
                      device=dev, dtype=torch.uint8)
    out["preprocess_u8"] = _pre_case(x)
    y = torch.randn((WIDE_B, 40, 40, 40, 1), generator=gen, device=dev)
    out["postprocess_u8"] = _post_case(y)
    del x, y
    for dtype in (torch.float32, torch.bfloat16):
        tot = {"max_abs_err": 0.0, "ok": True, "ms": 0.0, "plain_ms": 0.0,
               "library_ms": 0.0, "bound_ms": 0.0, "bound_by": "bytes",
               "graph_ms": 0.0, "library_graph_ms": 0.0, "shapes": []}
        for shape in leaky_shapes:
            v = torch.randn((WIDE_B,) + tuple(shape), generator=gen,
                            device=dev).to(dtype)
            rec = _leaky_case(v)
            for k in ("ms", "plain_ms", "library_ms", "bound_ms", "graph_ms",
                      "library_graph_ms"):
                tot[k] += rec[k]
            tot["max_abs_err"] = max(tot["max_abs_err"], rec["max_abs_err"])
            tot["ok"] = tot["ok"] and rec["ok"]
            tot["shapes"].append(list(v.shape))
            del v
        out["leaky_relu_" + str(dtype).replace("torch.", "")] = tot
    for name, rec in out.items():
        emit({"phase": "wide_kernel", "kernel": name, "wf": WIDE_WF,
              "batch": WIDE_B, **rec})
    return out


def _wide_bench_train(dev):
    """bench.train.measure at WIDE_BENCH (5 steps, steps 2-5 timed; one
    step of WIDE_PROFILED under torch.profiler), the counts zeroed just
    before each config and read just after; a config that runs out of
    memory is reported, not hidden."""
    from transfer_em_tpu_torch.bench import train as bench_train

    recs, total = [], None
    for dtype, c in WIDE_BENCH:
        tag = f"{dtype} {bench_train.config_tag(**c)}"
        torch.cuda.synchronize()
        reset_counts()
        try:
            rec = bench_train.measure(
                wf=WIDE_WF, dtype=dtype, steps=5, device=dev,
                profile=profile_train_step if tag in WIDE_PROFILED else None,
                **c)
        except torch.cuda.OutOfMemoryError as e:
            rec = {"config": bench_train.config_tag(**c), "dtype": dtype,
                   "oom": True, "error": str(e).splitlines()[0][:200]}
        counts = read_counts()
        rec.update(phase="wide_train", tag=tag, launches=counts)
        if not rec.get("oom"):
            rec["ok"] = (rec["losses_finite"] and counts["conv3"] > 0
                         and counts["leaky_relu"] > 0
                         and (dtype != "bfloat16"
                              or counts["conv3_bf16"] == counts["conv3"]))
            total = counts if total is None else {
                k: total[k] + v for k, v in counts.items()}
        emit(rec)
        recs.append(rec)
        torch.cuda.empty_cache()
    ok = (not recs[0].get("oom")
          and all(r.get("oom") or r["ok"] for r in recs))
    return {"configs": recs, "launches": total, "ok": ok}


def _wide_serve(dev, smi):
    """The training entry point and serving at wf=1, f32: EM2EM(74, wf=1)
    with redrawn weights takes 2 steps (B=2), a checkpoint, save_model ->
    load_generator -> ModelService(device="cuda") on 127.0.0.1 at its
    default batch (16 at wf=1); WIDE_SERVE's 128^3 chunks of a smoothed
    256^3 volume, counted, then held within one level on at most 1e-3 of
    the voxels of predict_tiled through the plain versions on this card."""
    from transfer_em_tpu_torch.infer import (load_generator, predict_tiled,
                                             save_model)
    from transfer_em_tpu_torch.infer.tiling import default_batch_size
    from transfer_em_tpu_torch.native import gather_box
    from transfer_em_tpu_torch.serve import (ModelService, NumpyVolume,
                                             register_volume)
    from transfer_em_tpu_torch.train import EM2EM

    size = 128
    vol = smooth_volume(256, seed=17, dev=dev)
    register_volume("wide/vol", NumpyVolume(vol))
    with tempfile.TemporaryDirectory() as tmp:
        model = EM2EM(74, "wide", wf=WIDE_WF, checkpoint_root=tmp,
                      device=dev)
        redraw(model.state, 21)
        x, y = smooth_batches(WIDE_CHECK_B, 0.3, 13, dev)
        losses = [model.train_step(x, y).cpu().tolist() for _ in range(2)]
        model.make_checkpoint(2)
        model.wait_until_finished()
        out_dir = os.path.join(tmp, "models", "wide", "v1")
        save_model(out_dir, os.path.join(model.checkpoint_path, "2"), MS_X,
                   MS_Y, 74, wf=WIDE_WF, device=dev)
        gen, meta = load_generator(out_dir, device=dev)
        same = all(torch.equal(a, b) for a, b in zip(
            gen.state_dict().values(), model.state.gg.state_dict().values()))
        del model
        svc = ModelService(model_root=os.path.join(tmp, "models"),
                           device=dev)
        svc.start()
        try:
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            results = [post_chunk(svc.url, "wide/vol", s, size, "wide:v1",
                                  os.path.join(tmp, f"out{i}"))
                       for i, s in enumerate(WIDE_SERVE)]
            wall = time.perf_counter() - t0
            launches = read_counts()
            stats = svc.cache.stats()
        finally:
            svc.stop()
        for body, _ in results:
            if body != b"success":
                fail("wide", f"a wf=1 request answered {body!r}")
        batch = default_batch_size(gen)
        worst, frac, spread = 0, 0.0, 0.0
        with plain_versions():
            for i, s in enumerate(WIDE_SERVE):
                want = predict_tiled(
                    lambda c, n: gather_box(vol, c, (n,) * 3), gen, s,
                    (size,) * 3, meta.outdimsize, meta.buffer, MS_X, MS_Y,
                    batch_size=batch, device=dev)
                got, n_blocks = read_ng_blocks(os.path.join(tmp, f"out{i}"),
                                               s, (size,) * 3)
                if n_blocks != (size // 64) ** 3:
                    fail("wide", f"request {i}: {n_blocks} blocks written")
                diff = np.abs(got.astype(int) - want.astype(int))
                worst = max(worst, int(diff.max()))
                frac = max(frac, float((diff > 0).mean()))
                spread = max(spread, float(np.std(want)))
    n_tiles = len(WIDE_SERVE) * (-(-size // 36)) ** 3
    rec = {"phase": "wide_serve", "wf": meta.wf, "train_losses": losses,
           "export_equals_model": same, "batch": batch,
           "requests": len(WIDE_SERVE), "wall_s": wall,
           "request_s": [r[1] for r in results],
           "tiles_per_s": n_tiles / wall,
           "mvox_per_s": len(WIDE_SERVE) * size ** 3 / wall / 1e6,
           "batcher": stats.get("batcher"), "launches": launches,
           "u8_max_diff": worst, "u8_frac_differing": frac,
           "output_std": spread, "card": smi}
    rec["ok"] = (meta.wf == WIDE_WF and same and batch == 16
                 and bool(np.all(np.isfinite(losses)))
                 and worst <= 1 and frac <= 1e-3 and spread > 2.0
                 and all(launches[k] > 0 for k in WIDE_PATHS["serve"]))
    emit(rec)
    return rec


def _wide_bench_infer(dev):
    """bench.infer.measure at wf=1 over a seeded WIDE_VOL_SIDE^3 volume:
    bf16 device mode at WIDE_VOL_BATCHES and slab mode (2 timed calls
    each, the counts zeroed before and read after each call of measure);
    then f32 device mode at B=16 against the same mode through the plain
    versions (one level, at most 1e-3 of the voxels)."""
    from transfer_em_tpu_torch.bench import infer as bench_infer
    from transfer_em_tpu_torch.infer import predict_volume

    vol_np = bench_infer.make_volume(WIDE_VOL_SIDE, seed=1)
    vol = torch.from_numpy(vol_np).to(dev)
    gen16 = bench_infer.seeded_generator(WIDE_WF, 0, "bfloat16", dev)
    runs, total = [], None
    for i, b in enumerate(WIDE_VOL_BATCHES):
        torch.cuda.synchronize()
        reset_counts()
        rec = bench_infer.measure(
            gen=gen16, vol=vol_np if i == 0 else vol, batch=b,
            modes=("device", "slab") if b == 16 else ("device",), reps=2,
            device=dev)
        counts = read_counts()
        rec.update(phase="wide_volume", launches=counts)
        emit(rec)
        runs.append(rec)
        total = counts if total is None else {
            k: total[k] + v for k, v in counts.items()}
    gen32 = bench_infer.seeded_generator(WIDE_WF, 0, "float32", dev)
    start, size = bench_infer.request(WIDE_VOL_SIDE)
    kw = dict(mode="device", batch_size=16, device=dev)
    torch.cuda.synchronize()
    reset_counts()
    got = predict_volume(vol, gen32, start, size, bench_infer.MS,
                         bench_infer.MS, **kw)
    counts = read_counts()
    with plain_versions():
        want = predict_volume(vol, gen32, start, size, bench_infer.MS,
                              bench_infer.MS, **kw)
    diff = np.abs(got.astype(int) - want.astype(int))
    check = {"phase": "wide_volume_check", "dtype": "float32", "batch": 16,
             "u8_max_diff": int(diff.max()),
             "u8_frac_differing": float((diff > 0).mean()),
             "output_std": float(want.std()), "launches": counts}
    check["ok"] = (check["u8_max_diff"] <= 1
                   and check["u8_frac_differing"] <= 1e-3
                   and check["output_std"] > 2.0
                   and all(counts[k] > 0 for k in WIDE_PATHS["volume"]))
    emit(check)
    total = {k: total[k] + v for k, v in counts.items()}
    ok = check["ok"] and all(
        all(r["launches"][k] > 0 for k in WIDE_PATHS["volume"])
        for r in runs)
    return {"runs": runs, "check": check, "launches": total, "ok": ok}


def check_wide(dev, smi):
    """Phase 16: the wf=1 model (64-256 channels) on the card (see the
    module docstring).  Returns the phase's summary, its launches by path
    (``train``, ``serve``, ``volume``: each call counted alone) and ok."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(16)
    gen_k3, disc_k3, leaky_shapes = wide_layers()
    conv = _wide_conv3(dev, gen, gen_k3, disc_k3)
    big = _wide_past_2_31(dev, gen)
    elem = _wide_elementwise(dev, gen, leaky_shapes)
    kernels_ok = (all(v["passed"] == v["checks"] for v in conv.values())
                  and big["ok"] and all(v["ok"] for v in elem.values()))
    train_check = check_train_plain(
        dev, max(conv["gen_float32"]["rel_err"],
                 conv["disc_float32"]["rel_err"]),
        wf=WIDE_WF, batch=WIDE_CHECK_B, phase="wide_train_check",
        same_gates=True)
    bf16_check = check_train_bf16_plain(dev, wf=WIDE_WF, batch=WIDE_CHECK_B,
                                        phase="wide_train_bf16_check")
    bench = _wide_bench_train(dev)
    serve = _wide_serve(dev, smi)
    volume = _wide_bench_infer(dev)
    by_path = {"train": bench["launches"], "serve": serve["launches"],
               "volume": volume["launches"]}
    launches_ok = all(by_path[p] is not None
                      and all(by_path[p][k] > 0 for k in ks)
                      for p, ks in WIDE_PATHS.items())
    rec = {"phase": "wide", "wf": WIDE_WF, "seconds": time.perf_counter() - t0,
           "kernels_ok": kernels_ok, "train_check_ok": train_check["ok"],
           "train_bf16_check_ok": bf16_check["ok"], "bench_ok": bench["ok"],
           "serve_ok": serve["ok"], "volume_ok": volume["ok"],
           "launches_ok": launches_ok, "launches_by_path": by_path,
           "card": smi}
    rec["ok"] = (kernels_ok and train_check["ok"] and bf16_check["ok"]
                 and bench["ok"] and serve["ok"] and volume["ok"]
                 and launches_ok)
    emit(rec)
    return {**rec, "conv3": conv, "elementwise": elem}


def wide_kernel_fields(wide, name):
    """The kernels line's ``wide_launches`` (summed over the phase's paths),
    ``wide_launches_by_path`` and, for the four kernels, ``wide``: the
    times at the wf=1 shapes (conv3 by network and dtype, summed over the
    main path's layers; LeakyReLU by dtype over the 4 activations)."""
    by_path = wide["launches_by_path"]
    out = {"wide_launches": sum(c[name] for c in by_path.values()
                                if c is not None),
           "wide_launches_by_path": {p: (c[name] if c is not None else None)
                                     for p, c in by_path.items()}}
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "max_abs_err")
    if name == "conv3":
        out["wide"] = {k: {**{kk: v[kk] for kk in keys},
                           "layers": v["layers"]}
                       for k, v in wide["conv3"].items()}
        out["wide"]["per"] = (f"the wf=1 k3 convs of one generator at B="
                              f"{WIDE_B} / discriminator at B={WIDE_DISC_B}"
                              ", summed")
    elif name == "leaky_relu":
        out["wide"] = {d: {k: wide["elementwise"]["leaky_relu_" + d][k]
                           for k in keys}
                       for d in ("float32", "bfloat16")}
    elif name in wide["elementwise"]:
        out["wide"] = {k: wide["elementwise"][name][k] for k in keys}
    return out


# -- phase 17: the benches, as a user starts them ---------------------------

# (name, module and arguments, the metrics its lines must carry, seconds
# allowed); the counts as reduced as a run that still reads each section's
# metric
BENCH_RUNS = [
    ("fidelity", ["fidelity", "--dtype", "f32,bf16", "--wf1"],
     ["golden_psnr_db_min"] * 2, 240),
    ("serve_model", ["serve", "model", "--reqs", "8", "--reps", "2"],
     ["serve_fleet_mvox_per_sec"], 240),
    ("serve_data", ["serve", "data", "--reqs-per-client", "8",
                    "--workers", "0,4", "--reps", "1"],
     ["data_fleet_req_per_sec"], 240),
    ("serve_soak", ["serve", "soak", "--soak-data-reqs", "1000",
                    "--soak-model-reqs", "100"],
     ["serve_soak_data_req_per_sec", "serve_soak_model_req_per_sec"], 300),
    ("serve_soak_churn", ["serve", "soak", "--models", "2",
                          "--soak-model-reqs", "20"],
     ["serve_soak_model_churn2_req_per_sec"], 240),
    ("serve_combined", ["serve", "combined", "--batch", "4",
                        "--epoch-size", "8", "--extent", "160",
                        "--clients", "8", "--combined-workers", "4"],
     ["combined_stream_train_tiles74_per_sec"], 300),
    ("dp", ["dp", "--steps", "3"], ["dp_train_tiles_per_sec"], 240),
    ("int8", ["int8", "--reps", "3"], ["int8_speedup_b128_wf8"], 300),
    ("baseline_configs", ["baseline_configs", "--ladder", "4096,16384",
                          "--steps", "5", "--epochs", "2",
                          "--epoch-size", "16"],
     ["inference2d_mvox_per_sec", "stream_train_tiles74_per_sec"], 300),
]
# the kernels each metric's section must launch: the tile step's four
# where a section serves uint8 tiles, conv3 and LeakyReLU where it runs
# the 3D networks on floats; fidelity runs float inputs (no uint8 edges),
# config2 is 2D (every 2D conv on cuDNN, as JAX keeps its Pallas conv to
# 3D: no conv3), the data sections none
_TILE = ("conv3", "leaky_relu", "preprocess_u8", "postprocess_u8")
BENCH_KERNELS = {
    "golden_psnr_db_min": ("conv3", "leaky_relu"),
    "serve_fleet_mvox_per_sec": _TILE,
    "data_fleet_req_per_sec": (),
    "serve_soak_data_req_per_sec": (),
    "serve_soak_model_req_per_sec": _TILE,
    "serve_soak_model_churn2_req_per_sec": _TILE,
    "combined_stream_train_tiles74_per_sec": ("conv3", "leaky_relu"),
    "dp_train_tiles_per_sec": ("conv3", "leaky_relu"),
    "int8_speedup_b128_wf8": ("conv_int8", "quantize_int8", "preprocess_u8",
                              "postprocess_u8"),
    "inference2d_mvox_per_sec": ("leaky_relu", "preprocess_u8",
                                 "postprocess_u8"),
    "stream_train_tiles74_per_sec": ("conv3", "leaky_relu"),
}


def _run_bench(args, timeout):
    """``python -m transfer_em_tpu_torch.bench.<args>`` in its own process
    group from the repo root: (exit code, its JSON lines, stderr's tail,
    seconds).  At the time limit the whole group is killed (a data
    service it started included)."""
    cmd = [sys.executable, "-m", f"transfer_em_tpu_torch.bench.{args[0]}",
           *args[1:]]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
        rc = proc.returncode
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        rc = "timeout"
    lines = []
    for line in out.splitlines():
        if line.startswith("{"):
            try:
                lines.append(json.loads(line))
            except json.JSONDecodeError:
                pass
    return rc, lines, err[-2000:], time.perf_counter() - t0


def _bench_gates(lines, metrics):
    """The bench's own bars: the metrics expected, in order, PSNR >= 40 dB
    (fidelity, int8), the soak bars, and each line's kernels
    (BENCH_KERNELS) launched."""
    gates = {"metrics": [r.get("metric") for r in lines] == metrics}
    for i, rec in enumerate(lines):
        got = rec.get("launches") or {}
        for k in BENCH_KERNELS.get(rec.get("metric"), ()):
            gates[f"{i}.{k}_launched"] = got.get(k, 0) > 0
        if rec.get("metric") == "golden_psnr_db_min":
            gates[f"{i}.psnr_ge_40"] = rec["value"] >= 40.0
        if rec.get("bench") == "int8":
            gates[f"{i}.psnr_ge_40"] = rec["golden_psnr_db_min"] >= 40.0
        if "pass" in rec:
            gates[f"{i}.bars"] = bool(rec["pass"])
    return gates


def check_benches(dev, smi):
    """Each bench module of ``transfer_em_tpu_torch/bench/`` started as a
    user starts it (``python -m``, a process of its own, after the kernels
    are built), at the reduced counts of BENCH_RUNS: gated on its exit
    code, its metrics, its own bars and the launches of the kernels each
    section must reach (BENCH_KERNELS).  Each bench's JSON line is
    printed."""
    del dev
    t_phase = time.perf_counter()
    runs = {}
    for name, args, metrics, timeout in BENCH_RUNS:
        rc, lines, err, secs = _run_bench(args, timeout)
        gates = _bench_gates(lines, metrics)
        ok = rc == 0 and all(gates.values())
        for line in lines:
            emit({"phase": "bench_line", "run": name, **line})
        runs[name] = {"rc": rc, "seconds": secs, "ok": ok,
                      "failed_gates": [g for g, v in gates.items() if not v],
                      "launches": [line.get("launches") or {}
                                   for line in lines],
                      "stderr_tail": None if ok else err}
    rec = {"phase": "benches", "card": smi, "runs": runs,
           "phase_s": time.perf_counter() - t_phase,
           "ok": all(r["ok"] for r in runs.values())}
    emit(rec)
    return rec


def main():
    global OUT_DIR
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="directory for the JSON lines and the build log")
    ap.add_argument("--parallel-worker", nargs=3, default=None,
                    metavar=("RANK", "PORT", "DIR"),
                    help="run as one of the parallel phase's worker "
                         "processes (the phase starts them itself)")
    ap.add_argument("--parallel-only", action="store_true",
                    help="build the kernels and run the parallel phase "
                         "alone (on two or more cards with its scaling "
                         "timings); prints no kernels line")
    ap.add_argument("--int8-only", action="store_true",
                    help="build the kernels and run the int8 phase alone; "
                         "prints the int8 entries of the kernels line")
    ap.add_argument("--examples-only", action="store_true",
                    help="build the kernels and run the examples phase "
                         "alone; prints its launches by recipe")
    ap.add_argument("--wide-only", action="store_true",
                    help="build the kernels and run the wide (wf=1) phase "
                         "alone; prints its launches by path")
    ap.add_argument("--benches-only", action="store_true",
                    help="build the kernels and run the benches phase "
                         "alone; prints each bench's JSON line")
    args = ap.parse_args()
    OUT_DIR = args.out
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "runs only on a CUDA card", file=sys.stderr)
        sys.exit(2)
    if args.parallel_worker is not None:
        rank, port, outdir = args.parallel_worker
        parallel_worker(int(rank), port, outdir)
        return
    from transfer_em_tpu_torch import kernels
    from transfer_em_tpu_torch.device import float32_exact, resolve_device

    float32_exact()
    dev = resolve_device("cuda")
    smi = nvidia_smi_line()
    emit({"phase": "env", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32})

    built = kernels.ensure_built(ptxas_verbose=True)
    _write_out("chip_smoke_build.log", built["log"])
    emit({"phase": "build", "seconds": built["seconds"],
          "sources": [os.path.relpath(p, ROOT) for p in kernels.sources()],
          "ok": True})
    if args.parallel_only:
        par = check_parallel(dev, smi)
        _write_log()
        for line in subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=60).stdout.splitlines():
            print(line, flush=True)
        if not par["ok"]:
            fail("parallel", "the parallel phase failed a check")
        return
    if args.examples_only:
        strided = check_strided(
            dev, torch.Generator(device=dev).manual_seed(0))
        ex = check_examples(dev, smi)
        _write_log()
        print(smi, flush=True)
        emit({"examples": ex["launches_by_recipe"]})
        if not strided["ok"]:
            fail("kernel", "a kernel disagrees with its plain version on a "
                 "strided input")
        if not ex["ok"]:
            fail("examples", "the examples phase failed a check")
        return
    if args.wide_only:
        wide = check_wide(dev, smi)
        _write_log()
        print(smi, flush=True)
        emit({"wide": {name: wide_kernel_fields(wide, name)
                       for name in counters()}})
        if not wide["ok"]:
            fail("wide", "the wide (wf=1) phase failed a check")
        return
    if args.benches_only:
        benches = check_benches(dev, smi)
        _write_log()
        print(smi, flush=True)
        emit({"benches": {n: r["seconds"] for n, r in
                          benches["runs"].items()}})
        if not benches["ok"]:
            fail("benches", "a bench failed its run or its bars")
        return
    if args.int8_only:
        int8 = check_int8(dev, smi)
        _write_log()
        print(smi, flush=True)
        emit({"kernels": int8_kernel_lines(int8)})
        if not int8["ok"]:
            fail("int8", "the int8 phase failed a check")
        return

    gen = torch.Generator(device=dev).manual_seed(0)
    conv = check_conv3(dev, gen)
    elem = check_elementwise(dev, gen)
    shapes = check_train_shapes(dev, gen)
    strided = check_strided(dev, gen)
    kw_fault = check_conv3_kw_fault(dev, gen)
    kernel_ok = (all(v["passed"] == v["checks"] for v in conv.values())
                 and all(v["ok"] for v in elem.values()) and strided["ok"]
                 and kw_fault["ok"]
                 and shapes["conv3_passed"] == shapes["conv3_checks"]
                 and shapes["leaky_passed"] == shapes["leaky_checks"])
    emit({"phase": "kernels_checked", "ok": kernel_ok})
    if not kernel_ok:
        fail("kernel", "a kernel disagrees with its plain version")

    golden = check_golden(dev)
    emit({"phase": "golden", "psnr_db": golden, "bar_db": 40,
          "ok": all(v >= 40 for v in golden.values())})
    if not all(v >= 40 for v in golden.values()):
        fail("golden", "PSNR below 40 dB")

    disc = check_disc_golden(dev)
    disc_ok = disc["psnr_db"] >= 40 and disc["launches"]["conv3"] > 0
    emit({"phase": "disc_golden", **disc, "bar_db": 40, "ok": disc_ok})
    if not disc_ok:
        fail("disc_golden", "discriminator PSNR below 40 dB")

    serve = check_serving(dev, smi)
    if not serve["ok"]:
        fail("serve", "serving check failed")

    serve_ng = check_serve_ng(dev, smi)
    if not serve_ng["ok"]:
        fail("serve_ng", "the serve_ng phase failed a check")

    volume = check_volume(dev, smi)
    if not volume["ok"]:
        fail("volume", "the volume phase failed a check")

    train_check = check_train_plain(
        dev, max(conv["float32"]["rel_err"], shapes["rel_err"]))
    norm = check_use_norm(
        dev, max(conv["float32"]["rel_err"], shapes["rel_err"]), "float32")
    train = check_train(dev, smi)
    if not train_check["ok"]:
        fail("train_check", "the kernels' train step disagrees with the "
             "plain versions'")
    if not norm["ok"]:
        fail("use_norm_float32", "with use_norm the kernels' train or tile "
             "step disagrees with the plain versions'")
    if not train["ok"]:
        fail("train", "train step check failed")

    em2em = check_em2em(dev, smi)
    if not em2em["ok"]:
        fail("em2em", "the EM2EM phase failed a check")

    twod = check_twod(dev, smi)
    if not twod["ok"]:
        fail("twod", "the 2D phase failed a check")

    bf16 = check_train_bf16(dev, smi)
    if not bf16["ok"]:
        fail("train_bf16", "the bf16 training phase failed a check")

    int8 = check_int8(dev, smi)
    if not int8["ok"]:
        fail("int8", "the int8 phase failed a check")

    par = check_parallel(dev, smi)
    if not par["ok"]:
        fail("parallel", "the parallel phase failed a check")

    examples = check_examples(dev, smi)
    if not examples["ok"]:
        fail("examples", "the examples phase failed a check")

    wide = check_wide(dev, smi)
    if not wide["ok"]:
        fail("wide", "the wide (wf=1) phase failed a check")

    benches = check_benches(dev, smi)
    if not benches["ok"]:
        fail("benches", "a bench failed its run or its bars")

    def entry(name, source, replaces, rec, launches, extra):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"],
                "library_ms": rec["library_ms"], **extra}

    la, lt = serve["launches"], train["launches"]
    c32, c16 = conv["float32"], conv["bfloat16"]
    conv_src = {"tc": "transfer_em_tpu_torch/csrc/conv3_tc.cu",
                "direct": "transfer_em_tpu_torch/csrc/conv3_direct.cu"}
    summary = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
               "max_abs_err")
    disc_leaky = elem["leaky_relu_disc_float32"]
    paths = [entry(f"conv3.{p}", conv_src[p],
                   "transfer_em_tpu/ops/pallas_conv.py:174", rec,
                   la[f"conv3_{p}"],
                   {"train_launches": lt[f"conv3_{p}"],
                    "layers": rec["layers"],
                    "bound_ms_cuda_core": rec["bound_ms_cuda_core"],
                    "bf16": {k: c16["paths"][p][k] for k in summary}})
             for p, rec in sorted(c32["paths"].items())]
    lines = [
        entry("conv3", " + ".join(conv_src.values()),
              "transfer_em_tpu/ops/pallas_conv.py:174", c32, la["conv3"],
              {"train_launches": lt["conv3"],
               "train_weight_packs": lt["conv3_weight_packs"],
               "checks": c32["checks"] + c16["checks"]
               + shapes["conv3_checks"],
               "passed": c32["passed"] + c16["passed"]
               + shapes["conv3_passed"],
               "per": "8 k3 convs of one B=128 tile batch, float32",
               "bound_ms_cuda_core": c32["bound_ms_cuda_core"],
               "weight_packs": la["conv3_weight_packs"],
               "bf16": {k: c16[k] for k in summary}, "paths": paths,
               "kw_layers": c32.get("kw", []),
               "train_disc": {**{k: c32["disc"][k] for k in summary},
                              "layers": c32["disc"]["layers"],
                              "per": "the discriminator's 4 k3 convs at "
                                     "B=128, float32"}}),
        entry("preprocess_u8", "transfer_em_tpu_torch/csrc/elementwise.cu",
              "transfer_em_tpu/ops/pallas_kernels.py:71",
              elem["preprocess_u8"], la["preprocess_u8"],
              {"train_launches": lt["preprocess_u8"],
               "passed": elem["preprocess_u8"]["ok"],
               "graph_ms": elem["preprocess_u8"]["graph_ms"],
               "library_graph_ms": elem["preprocess_u8"]["library_graph_ms"]}),
        entry("postprocess_u8", "transfer_em_tpu_torch/csrc/elementwise.cu",
              "transfer_em_tpu/ops/pallas_kernels.py:110",
              elem["postprocess_u8"], la["postprocess_u8"],
              {"train_launches": lt["postprocess_u8"],
               "passed": elem["postprocess_u8"]["ok"],
               "graph_ms": elem["postprocess_u8"]["graph_ms"],
               "library_graph_ms":
                   elem["postprocess_u8"]["library_graph_ms"]}),
        entry("leaky_relu", "transfer_em_tpu_torch/csrc/elementwise.cu",
              "transfer_em_tpu/ops/pallas_kernels.py:141",
              elem["leaky_relu_float32"], la["leaky_relu"],
              {"train_launches": lt["leaky_relu"],
               "passed": elem["leaky_relu_float32"]["ok"]
               and elem["leaky_relu_bfloat16"]["ok"],
               "graph_ms": elem["leaky_relu_float32"]["graph_ms"],
               "library_graph_ms":
                   elem["leaky_relu_float32"]["library_graph_ms"],
               "per": "4 activations of one B=128 tile batch, float32",
               "train_disc": {**{k: disc_leaky[k] for k in summary},
                              "graph_ms": disc_leaky["graph_ms"],
                              "per": "the discriminator's 5 activations "
                                     "at B=128, float32"}}),
    ]
    lines.append(down4_kernel_line(int8["down_conv"]["cases"], la, lt))
    le, lv, ln = em2em["launches"], volume["launches"], serve_ng["launches"]
    l2, lb = twod["launches"], bf16["launches"]
    for line in lines:
        line["em2em_launches"] = le[line["name"]]
        line["volume_launches"] = lv[line["name"]]
        line["serve_ng_launches"] = ln[line["name"]]
        line["twod_launches"] = l2[line["name"]]
        line["train_bf16_launches"] = lb[line["name"]]
        bk = bf16["kernels"]
        if line["name"] + "_gen" in bk:
            line["train_bf16"] = {
                net: {k: bk[line["name"] + "_" + net][k]
                      for k in SUMMARY}
                for net in ("gen", "disc")}
            line["train_bf16"]["per"] = (
                "the train step's first round (B=128 tiles, bfloat16), "
                "summed over the network's calls")
        if line["name"] in twod["kernels"]:
            k2 = twod["kernels"][line["name"]]
            line["twod"] = {**{k: k2[k] for k in SUMMARY},
                            "shape": k2.get("shape"), "shapes": k2.get(
                                "shapes"), "tpad0": k2.get("tpad0")}
    for p in paths:
        path = "conv3_" + p["name"].split(".")[1]
        p["em2em_launches"] = le[path]
        p["volume_launches"] = lv[path]
        p["serve_ng_launches"] = ln[path]
        p["twod_launches"] = l2[path]
        p["train_bf16_launches"] = lb[path]
    slab_keys = ("layer", "shape", "path", "kernel_ms", "ms", "graph_ms", "plain_ms",
                 "library_ms", "library_graph_ms", "bound_ms", "bound_by",
                 "max_abs_err")
    for line in lines:
        line["slab_shapes"] = [
            {k: r[k] for k in slab_keys if k in r}
            for r in volume["slab_kernels"]
            if r["kernel"] == line["name"]]
    for line in lines:
        line["int8_launches"] = int8["launches"][line["name"]]
    for line in int8_kernel_lines(int8):
        for key, src in (("train_launches", lt), ("em2em_launches", le),
                         ("volume_launches", lv),
                         ("serve_ng_launches", ln), ("twod_launches", l2),
                         ("train_bf16_launches", lb)):
            line[key] = src[line["name"]]
        lines.append(line)
    for line in lines:
        line["parallel_launches"] = par["launches"][line["name"]]
        line["parallel_launches_by_path"] = {
            path: c[line["name"]]
            for path, c in par["launches_by_path"].items()}
    for p in paths:
        p["parallel_launches"] = par["launches"][
            "conv3_" + p["name"].split(".")[1]]
    by_recipe = examples["launches_by_recipe"]
    for line in lines:
        line["examples_launches"] = sum(c[line["name"]]
                                        for c in by_recipe.values())
        line["examples_launches_by_recipe"] = {
            n: c[line["name"]] for n, c in by_recipe.items()}
    for p in paths:
        key = "conv3_" + p["name"].split(".")[1]
        p["examples_launches"] = sum(c[key] for c in by_recipe.values())
    for line in lines:
        line.update(wide_kernel_fields(wide, line["name"]))
    for p in paths:
        key = "conv3_" + p["name"].split(".")[1]
        p["wide_launches"] = sum(c[key] for c in
                                 wide["launches_by_path"].values()
                                 if c is not None)
    for line in lines:
        by_run = {n: sum(c.get(line["name"], 0) for c in r["launches"])
                  for n, r in benches["runs"].items()}
        line["benches_launches"] = sum(by_run.values())
        line["benches_launches_by_run"] = by_run
    print(smi, flush=True)
    emit({"kernels": lines})
    _write_log()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
