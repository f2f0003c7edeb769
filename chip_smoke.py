"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--profile]

Builds the port's CUDA kernels from ``sparkdl_tpu_torch/csrc`` (one nvcc
per source, in parallel, into ``build/sparkdl_tpu_torch/``; the native
image loader beside them with g++ where its headers are found) and counts
the ``HGMMA`` instructions in each library's SASS (``cuobjdump -sass``):
the tensor-core bodies of ``sep2d`` and ``pw1x1`` must have some. Then it
checks each kernel against its plain PyTorch version at the shapes the
featurize paths give it and times both (and the PyTorch library call that
computes the same function, as a yardstick the port never calls); each
``sep2d``/``pw1x1`` row names its launch plan and the body that ran.
``preproc_resize`` is also held bit for bit against the exact-order
resize (row taps, then column taps, each multiply and add rounded in
float32) at 256×256 and 512×384 → 299×299 in float32, 256×256 → 299×299
in bf16 and 256×256 → 224×224 in float32, with each shape's launch plan
and registers (``preproc_plan``),
and the kernel gate's verdict on the 256×256 float32 site is printed
(``preproc_audition``: recorded, not stored). The two bf16 bodies that
only rows TMA cannot stride reach (``sep2d``'s ``simt_bf16``,
``pw1x1``'s ``mma``) are checked and timed on inputs 8 bytes off a
16-byte boundary at 19×19 728→728 and 8×8 2048→448; the main path
launches neither.

The probe phase checks the three depthwise probes of
``sparkdl_tpu_torch/experiments/probe.py`` (``fma9``, ``dw2d``,
``sep2d_probe``) against their plain versions at the probe's full shape
(B = 128, all rows, the dead pad rows included) and at a ragged batch of
3 images (``fma9`` and ``dw2d`` bit for bit, ``sep2d_probe`` within one
bf16 ulp); prints the launch plans of ``dw2d`` and ``sep2d_probe``
(``probe_plan`` lines: tile, rings, cluster, blocks, shared memory,
depthwise recompute factor, pw bytes a call) beside their kernels'
registers and spills from ``ptxas -v`` and the ``HGMMA`` count of
``sep2d_probe``'s SASS (> 0); then runs the probe script's ``main()``:
each probe and its library yardstick timed by chaining it on its own
output inside CUDA graphs, each graph replay counting the launches it
holds.

Then it drives five featurize phases through ``transform(...).collect()``
with ``EngineConfig.pallas_kernels = "force"`` (every eligible site runs
its kernel), each on 32 images at batch 16 after one warm-up pass:

- ``featurize_resized`` / ``featurize_native``:
  ``DeepImageFeaturizer(modelName="Xception")`` on 256×256 images
  (resized on the card by ``preproc_resize``; the network then runs in
  float32 with bf16-rounded weights) and on 299×299 images (no resize;
  bf16), with ``sep2d`` at its 34 sites per forward;
- ``inception_featurize_resized``:
  ``DeepImageFeaturizer(modelName="InceptionV3")``, the default fast path
  (BN folded, branch 1×1 convs fused, plain convs), on 256×256 images;
- ``inception_module_native`` / ``inception_module_resized``:
  ``TorchImageTransformer`` over ``build_featurizer("InceptionV3",
  fast=False)``, the module path, with ``pw1x1`` at its 39 sites per
  forward, on 299×299 images (bf16) and 256×256 images (float32).

Each phase also counts its launches by body
(``kernels.launches_by_body``): every bf16 ``sep2d``/``pw1x1`` launch must
have taken the tensor-core body, every float32 one the float32 SIMT
mainloop (``simt_f32``, ``csrc/simt_f32.cuh``). The float32 kernel-check
rows print that body's plan (tile, layout, producers, units, ``waves``,
last-round ``fill``, depthwise ``recompute``) and its kernel's registers
and spills from ``ptxas -v``.

Five more phases run the user's default gate, ``"autotune"``, each with a
fresh verdict store (a temporary ``SPARKDL_COMPILE_CACHE_DIR``):
``featurize_native`` and ``inception_module_native`` in the default bf16
precision, which, as in the reference, audition and launch nothing; the
same two in float32 (``EngineConfig.inference_precision``), whose
warm-up pass auditions every kernel site against its library twin; and
Xception's module built with ``dtype="bfloat16"`` under the float32
precision, which, as the reference's, stays kernel-routable and
auditions its bf16 sites. Each
phase prints every verdict, its launches must equal the calls per forward
of the adopted sites × forwards, and its ``*_first_sight`` line gives the
wall time of its warm-up pass and the summed time of its auditions. The
store check then forgets the verdicts in memory (``kernels.reset()``) and
repeats the float32 Xception autotune phase, which must settle every site
from the store with no audition.

Each phase is checked against the port's own CPU run of the same weights
on two images, and the launch counters, set to 0 just before the phase and
read just after, show that it went through exactly the kernels it should.

Every featurize phase runs through captured CUDA graphs
(``ModelFunction.jitted``): its warm-up pass captures one graph per bucket
rung (``graphs``, ``rungs``, ``capture_s``, and ``graph_pool_mib``: the
MiB each capture added to the model's graph memory pool), and its counted
pass only replays them (each replay adds the launches its capture
recorded to the counters). Each phase line also holds the graphs' outputs
``torch.equal`` to the eager forward of the same padded chunks
(``graph_equal``), the images per second of the counted pass
(``images_per_s``) and of the same chunks through the graphs and through
the eager forward, each with its upload and fetch
(``graph_forward_images_per_s``, ``eager_images_per_s``: a yardstick the
path never takes), and the counted pass's phase timers (``phase_stats``,
``host_ms_per_partition``), ``overlap_stats()``, its staging streams'
summed ``PrefetchStats`` and its health counters.
``featurize_native_multichunk`` featurizes one partition of 40 images at
batch 16: chunks of 16, 16 and 8, so two graphs, staged ahead on the
prefetch thread.

Five phases drive the rest of the Flax model zoo the same way, each at
its spec's input size and feature width, 32 images at batch 16:
``resnet50_native`` (``DeepImageFeaturizer("ResNet50")`` on 224×224
sources under the default ``"autotune"`` gate and bf16 precision: no
site is collected, nothing launches), ``resnet50_resized`` (256×256
sources under ``"force"``: ``preproc_resize`` once per forward, then the
float32 network with bf16-rounded weights), ``vgg16_native`` (fc2's
4096 features), ``mobilenet_v2_native`` (1280 features) and
``testnet_predict`` (``DeepImagePredictor("TestNet",
decodePredictions=True, topK=5)`` on 32×32 sources in float32: the
decoded probabilities, and their classes, against the CPU run's). A
phase whose spec has the model's FLOPs per image (ResNet50,
InceptionV3) also gives its graphs' forward rate in TFLOP/s. Then
ResNet101, ResNet152 and VGG19 each run as such a phase on 16 224×224
images (``depth_*``, one forward), and ``resnet_fast_vs_module``
times ResNet50's fast apply (``models/resnet_fast.py``, BN folded) beside
the module through the same graphs, in bf16: a number only, since the
registry does not select it, as in the reference.

Partition-parallel featurize follows: three frames of 64 images in 16
partitions of 4, featurized through ``transform(df).collect()`` on 8
partition threads (``EngineConfig.max_workers``) at batch 16, each once
with ``EngineConfig.coalesce`` on (the default) and once off, each run
after its own warm-up pass: ``featurize_partitioned`` (Xception,
299×299, ``"force"``, bf16: ``sep2d``'s tensor-core body, 34 a
forward), ``resnet50_partitioned_resized`` (ResNet50, 256×256,
``"force"``: ``preproc_resize`` once a forward) and
``resnet50_partitioned`` (ResNet50, 224×224, ``"autotune"``, bf16: no
kernel of ours). Each run's line gives images/s, its forwards (the
program's replays in the pass, ``Compiled.replays``) and the graphs
captured in it, the executor's instruments (coalesced requests and rows
per launch, queue wait p50/p99, the coalescer's host ms per window),
its phase timers summed over threads beside the wall and the worker
count, and the two runs' features against each other (``torch.equal``,
max|Δ|). The coalesced run must make fewer forwards than there are
partitions; in both, every launch count equals per-forward × forwards
(a capture in the pass adds its warm-up forward), no task fails, the
executor ends empty, and every row of both runs agrees with the port's
CPU run of all 64 images within the phase's tolerance, as the two runs
do with each other. Every earlier phase is one partition, a solo
request: its line's ``executor`` instruments must stay empty.

``oom_rechunk`` then arms the ``device_oom`` injection point once at
bucket 16 on one partition of 32 Xception images (the chunk re-chunks
at 8, one ``oom_rechunk`` event, rung 8 captured, the features within
bf16 tolerance of the uninjected run), once inside a coalesced window of
``featurize_partitioned``'s frame (the window splits back per request,
each replayed on its own partition thread), and makes one real
allocation fail (32 TiB): ``classify`` must call it OOM, and a graph's
replay after it must equal the one before.

int8 weight-only quantization (``EngineConfig.inference_precision =
"int8"``: per-channel int8 weights dequantized to bf16 inside each
graph) runs as four more phases, each over the weights of a bf16 phase
of the same model: ``featurize_native_int8`` (Xception, 299×299,
``"force"``: the network in bf16, ``sep2d``'s tensor-core body 34 times
a forward), ``featurize_resized_int8`` (256×256: ``preproc_resize`` once
a forward, then the network in float32 with the bf16-dequantized
weights, ``sep2d``'s ``simt_f32`` 34 times a forward),
``featurize_native_int8_autotune`` (``"autotune"`` with a fresh store:
int8 stays kernel-routable, so its bf16 sites are auditioned) and
``vgg16_native_int8`` (fc2). Each ``*_weights`` line gives the model's
``weight_bytes`` in float32, bf16 and int8 (int8 at most 0.27 of
float32), and the graph pool MiB, images/s and error against the CPU
run beside those of the bf16 phase.

Streaming consumption of ``featurize_partitioned``'s frame follows:
``featurize_streamed`` loops over ``streamPartitions(prefetch=2)``, then
``prefetch=7``, each after a warm-up loop: images/s, forwards, the peak
of partitions started and not yet yielded (at most prefetch + 1), queue
wait p50/p99, every row against the CPU run of the partitioned phase and
the two runs against each other. ``stream_early_break`` leaves the loop
after two partitions: at most 2 + prefetch + 1 partitions' op chains may
have run (``partitions_started``, the health counters), and the pool's
``sparkdl-part`` threads are as many as before.

Then the path users run from image files: ``files_setup`` writes 64
seeded 256×256 and 64 384×384 photo-like JPEGs (quality 90; PNGs from a
standard-library encoder where Pillow is missing) into a temporary
directory and prints the host's CPUs, partition threads, /dev/shm and
the decoder that serves ``readImages`` (the native loader, built in the
``build`` phase where g++ finds ``jpeglib.h`` and ``png.h``, else Pillow,
with the compiler's reason). ``files_featurize`` reads the 256×256 files
with ``readImages(dir, numPartition=4)`` and featurizes them with
``DeepImageFeaturizer("Xception")`` under ``"force"`` on 8 partition
threads (``preproc_resize`` once a forward; the network in float32, so
``sep2d``'s ``simt_f32``): images/s with the decode, the decode and
device ms a partition, the idle share, every row against the port's CPU
run of the same files and every decoded image equal to its file's row
decode. ``files_featurize_pool`` runs the same through the decode pool
(4 spawned workers): its pixels equal the inline run's, its queue depth,
workers busy, decode time p50/p99, adopted chunk spans and respawns (0),
the 64 decodes timed alone through the pool and inline, and the workers'
memory and mappings (no libtorch: this file imports no torch when a
worker runs it as ``__mp_main__``; no CUDA driver); after ``shutdown()``
no worker and no segment is left. ``decode_faults`` adds two corrupt
files and reads the frame in one partition with ``decode_error`` at a
seeded rate, with the pool on (one ``decode_pool_worker_crash`` too) and
off: the same null rows and ``decode_degraded`` counts, one respawn, the
other rows' pixels and features those of the pool phase.
``files_host_resize`` featurizes the 384×384 files with
``EngineConfig.fused_preprocess = False``: the host resizes them to
299×299 (the native ``sdl_resize_batch``, or numpy without the loader)
and the network runs in bf16 (``sep2d``'s tensor-core body, no
``preproc_resize``), four rows against the CPU run of the same path.

Then the reference's flagship workflow (``examples/flagship_pipeline.py``)
on the card, ``flagship_pipeline``: 64 299×299 JPEGs in two classes
(class c brightens channel c) → ``readImages(dir, numPartition=4)`` → a
``label`` column → ``randomSplit([0.75, 0.25], seed=0)`` →
``Pipeline([DeepImageFeaturizer("Xception"), LogisticRegression(
maxIter=100, regParam=0.01)]).fit(train)`` under ``"force"`` in bf16 (the
features, then the port's own L-BFGS on the card) → ``transform`` and
``MulticlassClassificationEvaluator`` accuracy and f1 on train and test →
``save`` → ``load`` → ``transform`` (probabilities ``np.array_equal`` to
the original model's) → ``registerImageUDF`` and ``sql("SELECT
featurize(image) AS features, label FROM images WHERE label = 1")``
(exactly the label-1 rows, features within bf16 tolerance of the
featurizer's). The card's fit is held to the port's CPU fit of the same
collected features by what 48 rows determine: the objective, the test
probabilities and equal predictions (``compare_fits`` also prints the
coefficients' and intercepts' differences). Its line splits the fit's
seconds into featurize and L-BFGS and gives iterations, ms and host
syncs per iteration, transform
images/s, save and load seconds, and ``sep2d``'s launches by body (the
tensor-core body, 34 a forward, forwards and captures counted).
``lr_fit_scale`` fits ``LogisticRegression(maxIter=100, regParam=0.01)``
on 16,384 × 2048 seeded float32 features in 10 classes (128 MiB, one
frame with a 2-D column) on the card and on the CPU: collect ms, fit
seconds, iterations, ms, line-search steps and host syncs per
iteration, the CPU fit's seconds, and the two fits held to each other
(objective, parameters, predictions); ``--profile`` adds the card's idle
share during the solve alone (``fit_softmax``, without the collect).

Four phases serve online (``serving/``), Xception in bf16 under
``"force"`` with ``EngineConfig.serving_warmup`` on:

- ``serving_predict``: a ``ModelRegistry`` deploys ``xception``/``v1``
  (the featurizer built with ``precision="bfloat16"``, batch 16, a
  250 ms latency target); its warm-up captures rungs 8 and 16 in float32
  and uint8, and the first request after it must capture nothing; 8
  client threads then send 32 single 299×299 rows each to a
  ``ModelServer``. Every answer is held against the eager forward of its
  row on the card, 8 rows against the port's CPU run of the same float32
  weights; ``sep2d`` launches must be 34 × forwards, all on the
  tensor-core body. Printed: requests/s, ``request_s`` p50/p99, forwards,
  rows a coalesced window, the card's idle share (a shorter profiled
  load);
- ``serving_hot_swap``: ``v2`` (another seed) deployed dark, a quarter
  of the traffic shadowed to it, a cutover after 96 answers and a
  rollback after 192: every request answered once, each answer against
  its version's eager forward, the shadow comparisons every fourth
  request resolved before the cutover, 2 ``serving_cutover`` events;
- ``serving_slo``: a ``ModelServer(admission="shed", slo_window_s=2)``
  inside ``Telemetry(window_s=2, export_interval_s=0.25, slo_rules=
  default_serving_rules(...))``, its latency target set from an
  unloaded calibration, while featurize_partitioned's frame floods the
  bulk lane in float32, then the clients alone: a shed, the per-model
  rule's ``slo_breach`` then ``slo_recovered``, snapshots at the cadence
  with a final flush, the Prometheus file, the report's ``timeline``;
- ``serving_residency``: ``xception``, ``vgg16`` and ``resnet50``
  (256×256 rows through ``resized``: ``preproc_resize``) under a
  ``ResidencyManager`` budget of VGG16's and Xception's bf16
  ``weight_bytes()`` + 1 MiB, requested so that LRU evicts twice:
  the evictions in LRU's order, ``memory_allocated`` falling by at least
  each victim's ``weight_bytes()``, the reloaded vgg16's answer
  ``torch.equal`` to its first; cold-start seconds and each resident's
  graph pool MiB (not in the budget) are printed.

Then durable jobs and the cluster plane, on featurize_partitioned's
frame (Xception bf16 under ``"force"``, 64 299×299 images in 16
partitions of 4, batch 16):

- ``durable_featurize``: a child (``python3 chip_smoke.py
  --durable-child <dir>``) runs the frame with ``EngineConfig.
  durable_dir`` in a temporary directory (its filesystem is printed)
  and ``process_kill`` armed at the 6th commit, and must die by
  SIGKILL; this process resumes the job: ``durable_resumed`` 1,
  ``durable_partition_restored`` equal to the records committed, tasks
  only for the rest, ``sep2d`` 34 × forwards (``wgmma``), each restored
  partition's encoding equal to its spill's sha256, all 64 rows within
  the CPU run's tolerance; commit and journal-rewrite ms p50/p99 and
  the spill bytes are printed;
- ``cluster_featurize_2`` / ``_4``: ``EngineConfig.cluster_workers`` 2,
  then 4 (a warm-up pass that spawns the workers and captures, then a
  counted pass): images/s beside the in-process coalesced pass, each
  worker's boot seconds (spawn, imports, CUDA init, the op chain with
  its weights), tasks, op-chain seconds, forwards and
  ``memory_reserved`` over its life; the counted pass's forwards and
  ``sep2d`` launches summed over the workers (all ``wgmma``, 34 a
  forward: the difference of the workers' counts pulled just before and
  just after the pass), the router's results per worker (no late
  duplicate), every row held;
- ``cluster_worker_kill``: ``cluster_worker_kill`` fires once, with the
  journal on: one ``cluster_worker_lost``, re-dispatches equal to the
  dead worker's in-flight tasks, each partition's result delivered once
  and committed once, every row held;
- ``cluster_trace``: a 2-worker pass inside a ``Telemetry`` scope: every
  ``sparkdl.cluster_task`` span carries its worker's pid and parents
  under a ``sparkdl.cluster_dispatch`` span of this process, and the
  merged Chrome trace labels ``coordinator`` and each worker.

Then the cluster serving plane: ``EngineConfig.serving_cluster`` on one
router of 2 workers sharing the card, each holding a replica of
serving_predict's deployment (Xception's featurizer in bf16 under
``"force"``, batch 16, ``latency_target_ms=250``, ``serving_warmup``, the
``"pow2"`` ladder); the deployments' loaders build their seeded weights
in the workers:

- ``cluster_serving_predict``: each replica warmed (one probe predict
  each), then 8 clients × 16 single-row predicts: requests/s and latency
  p50/p99 beside serving_predict's in-process numbers, the replica map,
  each worker's ``memory_allocated`` and ``memory_reserved``, the
  workers' captures over the counted traffic (0) and their ``sep2d``
  launches (34 × forwards, all ``wgmma``: the difference of two pulls of
  their counts), every answer within ``5e-2·max|ref|`` of the eager
  forward of the same weights in this process;
- ``cluster_serving_cutover``: v1 → v2 → rollback while 8 clients
  stream: no request that started after the first answer of the new
  version ended gets the old one (for the cutover and for the
  rollback), every answer held against its version's eager forward; then
  a v3 whose loader raises in the worker named ``...-1``:
  ``CutoverFailed``, one ``serving_prepare_failed``, v1 active and
  answering on every replica, ``report_section()["prepare_failures"]``
  1;
- ``cluster_serving_failover``: ``serving_worker_kill`` fires once under
  8 clients' traffic: every request answered within its deadline (a
  survivor holds the deployment, so none may fail), one
  ``serving_failover`` event per moved request (the router's ledger
  agrees), the moved requests' ids and seconds, the survivor's answers
  held, its launches counted.

Then training (``train/``): ``Xception(classes=10)`` behind its registry
preprocessing, with seeded weights, on 299×299 seeded uint8 images whose
colour follows one of 10 classes (12 batches of 32):

- ``train_step_vs_cpu``: one float32 SGD step (lr 0.01) of
  ``Trainer.from_module`` at batch 4 from one seeded state, on the card
  and on the host's CPU: the loss and every param and BN buffer after
  the step held within ``TRAIN_STEP_REL·max(1, max|cpu|)`` (TF32 is off
  for cuBLAS and cuDNN in this script; the line says so);
- ``train_f32``: ``fit`` with adam (lr 1e-4), 24 steps over 2 epochs,
  ``sync_every=8``, ``prefetch=2``, under ``torch.profiler`` (CUDA
  activity): the loss descends (the mean of the last 4 steps below the
  first 4's); ms a step p50/p99 between CUDA events recorded after each
  step (and the first step's), images/s over the fit and at the p50
  step, host syncs a step, the card's idle share across the fit (and
  the steady steps' estimate: mean busy ms a step over the mean step
  interval) and its 15 heaviest kernels (device ms a step), peak
  ``memory_allocated``; no kernel of ours launches (train mode takes the
  plain body);
- ``train_bf16``: the same with ``compute_dtype=torch.bfloat16``; the
  params, the optimizer's moments and the running statistics stay
  float32;
- ``train_resume``: with ``torch.use_deterministic_algorithms(True,
  warn_only=True)`` and deterministic cuDNN, an uninterrupted fit, then
  the same fit with ``checkpoint_every=8`` and the ``preemption`` fault
  at step 13, then a fit that resumes: the restored step 8 equal bit for
  bit to the state saved there (manifest verified), steps redone ≤ 8,
  the final params against the uninterrupted run's (bit for bit, or
  max|Δ| within the Adam sign-flip bound 2·lr·steps), checkpoint save ms
  (the host copy inside the loop, and a synchronous save) and bytes;
- ``train_featurize``: the f32 fit's weights (``variables_of``) →
  ``DeepImageFeaturizer("Xception")`` over 32 of the images, ``"force"``,
  bf16: ``sep2d`` 34 launches a forward on the tensor-core body, rows
  within ``BF16_REL·max|ref|`` of the same pass under ``"off"`` (the
  plain layers); then the featurizer's model on a grad-recording input
  under ``"force"`` raises the routes' ``ValueError``.

The line ``{"phase": "total", ...}`` gives the script's seconds so far.

``--profile`` adds device times from ``torch.profiler`` beside each event
time, and one profiled pass per phase: device time by kernel, the device
time of each of the port's kernels by body, and the device's idle share
(also in the phase line, with those of the graph and eager yardsticks).

Prints one JSON object per phase; the line before the last is the kernels
summary and the card's ``name, power.limit``; the last line is the
``{"ok": true, "device": ...}`` record. Any failure raises (exit code ≠ 0,
no result line). Exits 2 when CUDA is not available.
"""

import concurrent.futures
import functools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

if __name__ != "__mp_main__":
    # a spawned decode-pool worker runs this file again as __mp_main__;
    # it needs nothing of the card's stack, so it does not import torch
    import torch

SEED = 0
BATCH = 16
N_IMAGES = 32
TOP_K = 5             # DeepImagePredictor's decoded classes per row
F32_REL = 1e-3        # float32 whole-slice tolerance, relative to max|ref|
BF16_REL = 5e-2       # bf16 whole-slice tolerance, relative to max|ref|
F32_KERNEL_REL = 1e-5  # float32 kernel tolerance, relative to max(1, |ref|)
H100_BYTES_PER_S = 3.35e12
H100_FLOPS = {"bfloat16": 989e12,  # dense tensor-core peak
              "float32": 67e12}    # float32 outside the tensor cores
SEP2D_SHAPES = [(147, 147, 64, 128), (37, 37, 256, 728), (19, 19, 728, 728),
                (10, 10, 1536, 2048)]
# InceptionV3's 1×1 sites at 35×35, 17×17 and 8×8 (widest of each grid);
# the last entry of each case is ``relu``
PW1X1_CASES = [(35, 35, 192, 64, True), (17, 17, 768, 192, True),
               (8, 8, 2048, 448, True), (35, 35, 192, 64, False)]
#: (source H, W), target (H, W) and output dtype of each preproc_resize
#: check: the 299×299 models' resized sources, and the 224×224 models'
PREPROC_CASES = [((256, 256), (299, 299), "float32"),
                 ((512, 384), (299, 299), "float32"),
                 ((256, 256), (299, 299), "bfloat16"),
                 ((256, 256), (224, 224), "float32")]
TARGET = (299, 299)  # Xception's and InceptionV3's input size
PROFILE = "--profile" in sys.argv[1:]
#: the launch counter of each kernel gate site kind
COUNTER_OF_SITE = {"sep2d": "sep2d", "pw1x1": "pw1x1", "pw1x1_relu": "pw1x1",
                   "preproc": "preproc_resize"}


STARTED = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line gets ``t_s``, the script's seconds
    when it was printed."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - STARTED}
    print(json.dumps(obj), flush=True)


def timed_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 10) -> float:
    """Mean device time of ``fn()`` from ``torch.profiler``: the kernels'
    own durations, without the host's launch gaps that CUDA events see."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / iters


def timings(kernel, plain, library) -> dict:
    """Event times of the kernel, its plain version and the library call;
    with ``--profile`` also their device times."""
    out = {"ms": timed_ms(kernel), "plain_ms": timed_ms(plain),
           "library_ms": timed_ms(library)}
    if PROFILE:
        out.update(device_ms=device_ms(kernel),
                   plain_device_ms=device_ms(plain),
                   library_device_ms=device_ms(library))
    return out


def peak_flops(dtype) -> float:
    return H100_FLOPS[str(dtype).removeprefix("torch.")]


def bound_ms(flops: float, nbytes: float, dtype) -> tuple:
    t_ops = flops / peak_flops(dtype)
    t_bytes = nbytes / H100_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def launched_body(kernels, name, fn):
    """``fn()``'s result and the one body of kernel ``name`` it launched
    (the per-body counters before and after)."""
    before = dict(kernels.launches_by_body[name])
    out = fn()
    torch.cuda.synchronize()
    ran = [b for b, n in kernels.launches_by_body[name].items()
           if n != before[b]]
    assert len(ran) == 1, f"{name}: bodies launched {ran}"
    return out, ran[0]


def plan_row(plan) -> dict:
    row = {"body": plan.body, "tile": [plan.bm, plan.bn],
           "stages": plan.stages, "splits": plan.splits,
           "grid": list(plan.grid), "blocks": plan.blocks,
           "smem": plan.smem, "note": plan.note}
    if plan.body == "simt_f32":
        row.update(layout=plan.layout, producers=plan.producers,
                   units=plan.units, groups=plan.groups, waves=plan.waves,
                   fill=plan.fill, recompute=plan.recompute)
    return row


def f32_ptxas(name, plan) -> dict:
    """Registers and spills of the float32 mainloop kernel ``plan`` runs
    in the library built from ``csrc/<name>.cu``."""
    part = f"mainloopILi{plan.bn // 8}ELb{int(name == 'sep2d')}E"
    return one_function(ptxas_by_function(name), part)


def f32_layout(w, dtype):
    """The weight as the routes hand it to the body of ``dtype``: the
    float32 body's (Cin, Cout) contiguous, made once per weight; the
    tensor-core bodies' transposed (Cout, Cin)."""
    return w.contiguous() if dtype == torch.float32 else w


def sass_hgmma(name) -> int:
    """HGMMA instructions in the SASS of the library built from
    ``csrc/<name>.cu`` (``cuobjdump -sass``)."""
    return sum(sass_hgmma_by_function(name).values())


@functools.lru_cache(maxsize=None)
def sass_hgmma_by_function(name) -> dict:
    """HGMMA instructions by kernel (mangled name) in the SASS of the
    library built from ``csrc/<name>.cu`` (disassembled once)."""
    import shutil

    from sparkdl_tpu_torch.core import cuda_build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(cuda_build.library_path(name))],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    counts, function = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            function = line.split("Function :", 1)[1].strip()
            counts.setdefault(function, 0)
        elif "HGMMA" in line and function is not None:
            counts[function] += 1
    return counts


def ptxas_by_function(name) -> dict:
    """Registers, spills and stack of each kernel (mangled name) in the
    library built from ``csrc/<name>.cu``, from ``nvcc -Xptxas -v``."""
    import re

    from sparkdl_tpu_torch.core import cuda_build

    out, function = {}, None
    for line in cuda_build.build_log(name).splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            function = entry.group(1)
            out[function] = {}
            continue
        if function is None:
            continue
        spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
        if spill:
            out[function].update(stack=int(spill.group(1)),
                                 spill_stores=int(spill.group(2)),
                                 spill_loads=int(spill.group(3)))
        used = re.search(r"Used (\d+) registers", line)
        if used:
            out[function]["registers"] = int(used.group(1))
    return out


def one_function(table: dict, part: str):
    """The entry of ``table`` whose mangled name holds ``part``."""
    found = [v for k, v in table.items() if part in k]
    assert len(found) == 1, f"{part}: {len(found)} kernels match"
    return found[0]


def check_sep2d(kernels, dev):
    """sep2d against plain_sep2d and the library's depthwise → 1×1 conv →
    affine, at the main path's first, middle-flow and last shapes."""
    import torch.nn.functional as F

    rows = []
    gen = torch.Generator().manual_seed(SEED)
    for h, w, cin, cout in SEP2D_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(BATCH, h, w, cin, generator=gen).to(dev, dtype)
            dw9 = (torch.randn(9, cin, generator=gen) * 0.2).to(dev, dtype)
            # (Cin, Cout) as the routes hand it to the body of dtype
            pw = f32_layout((torch.randn(cout, cin, generator=gen)
                             / cin ** 0.5).to(dev, dtype).t(), dtype)
            scale = (torch.rand(cout, generator=gen) + 0.5).to(dev)
            shift = (torch.randn(cout, generator=gen) * 0.1).to(dev)
            y, body = launched_body(kernels, "sep2d", lambda: kernels.sep2d(
                x, dw9, pw, scale, shift))
            ref = kernels.plain_sep2d(x, dw9, pw, scale, shift)
            torch.cuda.synchronize()
            err = float((y.float() - ref.float()).abs().max())
            limit = (F32_KERNEL_REL * max(1.0, float(ref.float().abs().max()))
                     if dtype == torch.float32 else kernels.BF16_TOLERANCE)
            assert err <= limit, f"sep2d {h}x{w} {cin}->{cout} {dtype}: " \
                                 f"max|err| {err} > {limit}"
            xn = x.permute(0, 3, 1, 2)
            w_dw = dw9.t().reshape(cin, 1, 3, 3).contiguous()
            w_pw = pw.t().reshape(cout, cin, 1, 1).contiguous()
            sc, sh = scale.to(dtype).view(1, cout, 1, 1), \
                shift.to(dtype).view(1, cout, 1, 1)

            def library():
                t = F.conv2d(xn, w_dw, padding=1, groups=cin)
                return F.conv2d(t, w_pw) * sc + sh

            item = x.element_size()
            pos = BATCH * h * w
            flops = pos * (18 * cin + 2 * cin * cout)
            nbytes = (pos * (cin + cout) + 9 * cin + cin * cout) * item \
                + 2 * cout * 4
            b_ms, b_by = bound_ms(flops, nbytes, dtype)
            plan = kernels.plan_sep2d(BATCH, h, w, cin, cout, dtype)
            assert body == plan.body == ("simt_f32" if dtype == torch.float32
                                         else "wgmma"), (body, plan.body)
            rows.append({
                "shape": [BATCH, h, w, cin, cout],
                "dtype": str(dtype).replace("torch.", ""),
                "body": body, "plan": plan_row(plan),
                **({"ptxas": f32_ptxas("sep2d", plan)}
                   if body == "simt_f32" else {}),
                "max_abs_err": err, "tolerance": limit,
                **timings(lambda: kernels.sep2d(x, dw9, pw, scale, shift),
                          lambda: kernels.plain_sep2d(x, dw9, pw, scale,
                                                      shift),
                          library),
                "bound_ms": b_ms, "bound_by": b_by, "gflop": flops / 1e9,
                "mbytes": nbytes / 1e6})
            emit({"phase": "kernel_check", "kernel": "sep2d", **rows[-1]})
    return rows


def check_pw1x1(kernels, dev):
    """pw1x1 against plain_pw1x1 and the library's matmul → affine → relu,
    at InceptionV3's module-path shapes, in float32 and bf16."""
    rows = []
    gen = torch.Generator().manual_seed(SEED + 2)
    for h, w, cin, cout, relu in PW1X1_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(BATCH, h, w, cin, generator=gen).to(dev, dtype)
            w2 = f32_layout((torch.randn(cout, cin, generator=gen)
                             / cin ** 0.5).to(dev, dtype).t(), dtype)
            # scale < 1 keeps |y| under 8, where one bf16 ulp is below 0.05
            scale = (torch.rand(cout, generator=gen) * 0.5 + 0.5).to(dev)
            shift = (torch.randn(cout, generator=gen) * 0.1).to(dev)
            y, body = launched_body(kernels, "pw1x1", lambda: kernels.pw1x1(
                x, w2, scale, shift, relu=relu))
            ref = kernels.plain_pw1x1(x, w2, scale, shift, relu=relu)
            torch.cuda.synchronize()
            err = float((y.float() - ref.float()).abs().max())
            limit = (F32_KERNEL_REL * max(1.0, float(ref.float().abs().max()))
                     if dtype == torch.float32 else kernels.BF16_TOLERANCE)
            assert err <= limit, f"pw1x1 {h}x{w} {cin}->{cout} {dtype}: " \
                                 f"max|err| {err} > {limit}"
            x2 = x.reshape(-1, cin)
            sc, sh = scale.to(dtype), shift.to(dtype)

            def library():
                y = torch.matmul(x2, w2) * sc + sh
                return torch.relu(y) if relu else y

            item = x.element_size()
            n = BATCH * h * w
            flops = 2 * n * cin * cout
            nbytes = (n * (cin + cout) + cin * cout) * item + 2 * cout * 4
            b_ms, b_by = bound_ms(flops, nbytes, dtype)
            plan = kernels.plan_pw1x1(n, cin, cout, dtype)
            assert body == plan.body == ("simt_f32" if dtype == torch.float32
                                         else "wgmma"), (body, plan.body)
            rows.append({
                "shape": [BATCH, h, w, cin, cout], "relu": relu,
                "dtype": str(dtype).replace("torch.", ""),
                "body": body, "plan": plan_row(plan),
                **({"ptxas": f32_ptxas("pw1x1", plan)}
                   if body == "simt_f32" else {}),
                "max_abs_err": err, "tolerance": limit,
                **timings(lambda: kernels.pw1x1(x, w2, scale, shift,
                                                relu=relu),
                          lambda: kernels.plain_pw1x1(x, w2, scale, shift,
                                                      relu=relu),
                          library),
                "bound_ms": b_ms, "bound_by": b_by, "gflop": flops / 1e9,
                "mbytes": nbytes / 1e6})
            emit({"phase": "kernel_check", "kernel": "pw1x1", **rows[-1]})
    return rows


def preproc_ptxas(plan, in_dtype, out_dtype):
    """Registers and spills of the ``preproc_resize`` kernel ``plan``
    launches for the dtype pair (None where its mangled name is not
    found once)."""
    code = {torch.uint8: "h", torch.float32: "f",
            torch.bfloat16: "13__nv_bfloat16"}
    part = (f"preproc_kernelI{code[in_dtype]}{code[out_dtype]}"
            f"Lb{int(plan.staged)}ELb{int(plan.dense)}E")
    found = [v for k, v in ptxas_by_function("preproc_resize").items()
             if part in k]
    return found[0] if len(found) == 1 else None


def check_preproc(kernels, dev):
    """preproc_resize against plain_preproc (within the float32 kernel
    tolerance, or one bf16 ulp on the [0, 255] scale), bit for bit
    against the exact-order resize, and timed beside cast +
    F.interpolate, at the featurize paths' resized sources (to 299×299
    and to 224×224); prints each
    shape's launch plan (``preproc_plan``: band rows, staged bytes, shared
    memory, grid, registers)."""
    import torch.nn.functional as F

    from sparkdl_tpu_torch.experiments.preproc_breakdown import exact_order

    rows = []
    gen = torch.Generator().manual_seed(SEED + 1)
    for (h, w), target, dtype_name in PREPROC_CASES:
        out_dtype = getattr(torch, dtype_name)
        x = torch.randint(0, 256, (BATCH, h, w, 3), generator=gen,
                          dtype=torch.uint8).to(dev)
        y = kernels.preproc_resize(x, target, out_dtype)
        ref = kernels.plain_preproc(x, target, out_dtype)
        torch.cuda.synchronize()
        err = float((y.float() - ref.float()).abs().max())
        limit = (F32_KERNEL_REL * max(1.0, float(ref.abs().max()))
                 if out_dtype == torch.float32 else 2.0)
        assert err <= limit, f"preproc {h}x{w}->{target}: max|err| {err} " \
                             f"> {limit}"
        exact = torch.equal(y, exact_order(x, *target, out_dtype))
        assert exact, f"preproc {h}x{w}->{target}: not the exact-order " \
                      f"resize"
        plan = kernels.plan_preproc(BATCH, h, w, 3, *target, torch.uint8,
                                    out_dtype)
        name = str(out_dtype).replace("torch.", "")
        emit({"phase": "preproc_plan", "shape": [BATCH, h, w, 3, *target],
              "dtype": f"uint8->{name}", "band_rows": plan.band_rows,
              "bands": plan.bands, "staged": plan.staged,
              "staged_bytes": plan.staged_bytes, "dense": plan.dense,
              "smem": plan.smem, "grid": list(plan.grid),
              "blocks": plan.blocks, "note": plan.note,
              "ptxas": preproc_ptxas(plan, torch.uint8, out_dtype)})

        def library():
            return F.interpolate(x.permute(0, 3, 1, 2).to(out_dtype),
                                 size=target, mode="bilinear",
                                 align_corners=False, antialias=False)

        outs = BATCH * target[0] * target[1] * 3
        flops = outs * 9  # 6 multiplies + 3 adds per output element
        nbytes = x.numel() + outs * y.element_size()
        b_ms, b_by = bound_ms(flops, nbytes, torch.float32)
        rows.append({
            "shape": [BATCH, h, w, 3, *target], "dtype": f"uint8->{name}",
            "max_abs_err": err, "tolerance": limit, "exact_order": exact,
            "plan": {"band_rows": plan.band_rows, "smem": plan.smem,
                     "grid": list(plan.grid)},
            **timings(lambda: kernels.preproc_resize(x, target, out_dtype),
                      lambda: kernels.plain_preproc(x, target, out_dtype),
                      library),
            "bound_ms": b_ms, "bound_by": b_by, "gflop": flops / 1e9,
            "mbytes": nbytes / 1e6})
        emit({"phase": "kernel_check", "kernel": "preproc_resize",
              **rows[-1]})
    return rows


def preproc_audition(kernels, dev):
    """The gate's verdict on the featurize path's preproc site (16 uint8
    images of 256×256 → 299×299 float32) under its float32 contract,
    bit for bit against cast + F.interpolate: recorded, not stored."""
    site = kernels.Site("preproc", "smoke", (BATCH, 256, 256, 3, *TARGET),
                        "uint8->float32")
    verdict = kernels._audition(site, dev)
    emit({"phase": "preproc_audition", "site": kernels._site_key(site, dev),
          **verdict})
    return verdict


def unaligned(x):
    """A copy of ``x`` that starts 8 bytes off a 16-byte boundary."""
    buf = torch.empty(x.numel() + 8 // x.element_size(), dtype=x.dtype,
                      device=x.device)
    out = buf[8 // x.element_size():].view(x.shape)
    out.copy_(x)
    assert out.data_ptr() % 16 == 8
    return out


def check_unaligned_bodies(kernels, dev):
    """The two bf16 bodies that take rows TMA cannot stride, each at a
    real shape of its path on an input 8 bytes off a 16-byte boundary:
    ``sep2d``'s ``simt_bf16`` at 19×19 728→728 and ``pw1x1``'s ``mma`` at
    8×8 2048→448, against their plain versions and library calls. The
    main path launches neither (its inputs are aligned)."""
    import torch.nn.functional as F

    rows = []
    gen = torch.Generator().manual_seed(SEED + 5)
    for name, (h, w, cin, cout), body in (
            ("sep2d", (19, 19, 728, 728), "simt_bf16"),
            ("pw1x1", (8, 8, 2048, 448), "mma")):
        dt = torch.bfloat16
        x = unaligned(torch.randn(BATCH, h, w, cin, generator=gen).to(dev, dt))
        wt = (torch.randn(cout, cin, generator=gen) / cin ** 0.5).to(dev, dt).t()
        scale = (torch.rand(cout, generator=gen) * 0.5 + 0.5).to(dev)
        shift = (torch.randn(cout, generator=gen) * 0.1).to(dev)
        sc, sh = scale.to(dt), shift.to(dt)
        n = BATCH * h * w
        if name == "sep2d":
            dw9 = (torch.randn(9, cin, generator=gen) * 0.2).to(dev, dt)
            args = (x, dw9, wt, scale, shift)
            plain = kernels.plain_sep2d
            plan = kernels.plan_sep2d(BATCH, h, w, cin, cout, dt,
                                      aligned=False)
            xn = x.permute(0, 3, 1, 2)
            w_dw = dw9.t().reshape(cin, 1, 3, 3).contiguous()
            w_pw = wt.t().reshape(cout, cin, 1, 1).contiguous()

            def library():
                t = F.conv2d(xn, w_dw, padding=1, groups=cin)
                return F.conv2d(t, w_pw) * sc.view(1, cout, 1, 1) \
                    + sh.view(1, cout, 1, 1)

            flops = n * (18 * cin + 2 * cin * cout)
            nbytes = (n * (cin + cout) + 9 * cin + cin * cout) * 2 \
                + 2 * cout * 4
        else:
            args = (x, wt, scale, shift)
            plain = kernels.plain_pw1x1
            plan = kernels.plan_pw1x1(n, cin, cout, dt, aligned=False)
            x2 = x.reshape(-1, cin)

            def library():
                return torch.matmul(x2, wt) * sc + sh

            flops = 2 * n * cin * cout
            nbytes = (n * (cin + cout) + cin * cout) * 2 + 2 * cout * 4
        fn = getattr(kernels, name)
        y, ran = launched_body(kernels, name, lambda: fn(*args))
        assert ran == plan.body == body, (name, ran, plan.body)
        ref = plain(*args)
        torch.cuda.synchronize()
        err = float((y.float() - ref.float()).abs().max())
        assert err <= kernels.BF16_TOLERANCE, f"{name}/{body}: max|err| {err}"
        b_ms, b_by = bound_ms(flops, nbytes, dt)
        rows.append({
            "kernel": name, "body": body, "shape": [BATCH, h, w, cin, cout],
            "dtype": "bfloat16", "offset_bytes": 8, "plan": plan_row(plan),
            "max_abs_err": err, "tolerance": kernels.BF16_TOLERANCE,
            **timings(lambda: fn(*args), lambda: plain(*args), library),
            "bound_ms": b_ms, "bound_by": b_by, "gflop": flops / 1e9,
            "mbytes": nbytes / 1e6})
        emit({"phase": "kernel_check", **rows[-1]})
    return rows


def check_probes(probe, dev):
    """Each probe kernel against its plain version at the probe's full
    shape (B = 128, every row, the dead pad rows included) and at a ragged
    batch (b = 3: 1,104 rows, not a whole number of 128-row tiles), the
    plain version timed; the launch plans of ``dw2d`` and
    ``sep2d_probe`` with their kernels' registers and spills (``ptxas
    -v``) and the ``HGMMA`` count of ``sep2d_probe``'s SASS; then the
    probe script's ``main()`` (its own check, and the chained timing of
    the three kernels and the two library yardsticks), with the launches
    counted from 0 over that run."""
    def cases(v):
        rest = (v["pw"], v["sc"], v["sh"])
        return {"fma9": (probe.fma9, probe.plain_fma9, (v["k9"],)),
                "dw2d": (probe.dw2d, probe.plain_dw2d, (v["k9"],)),
                "sep2d_probe": (probe.sep2d_probe, probe.plain_sep2d_probe,
                                (v["k9"], *rest))}

    ragged = {}
    v = probe.operands(dev, b=3, seed=SEED + 4)
    for name, (kernel, plain, args) in cases(v).items():
        y, ref = kernel(v["x2"], *args), plain(v["x2"], *args)
        torch.cuda.synchronize()
        assert probe.matches_plain(name, y, ref), \
            f"{name}: differs from its plain version at b = 3"
        ragged[name] = float((y.float() - ref.float()).abs().max())
    del v
    ptxas = ptxas_by_function("probes")
    hgmma = sass_hgmma_by_function("probes")
    full_rows = probe.B * probe.P_PAD
    plans = {"dw2d": probe.plan_dw2d(full_rows),
             "sep2d_probe": probe.plan_sep2d_probe(full_rows)}
    kernel_of = {"dw2d": "dw2d_kernel",  # mangled-name parts
                 "sep2d_probe":
                 f"sep2d_probe_kernelILi{plans['sep2d_probe'].cluster}E"}
    sep_hgmma = one_function(hgmma, kernel_of["sep2d_probe"])
    assert sep_hgmma > 0, "no HGMMA in sep2d_probe's SASS"
    for name, plan in plans.items():
        emit({"phase": "probe_plan", "kernel": name, "plan": plan.row(),
              "ptxas": one_function(ptxas, kernel_of[name]),
              "sass_hgmma": one_function(hgmma, kernel_of[name])})
    v = probe.operands(dev)
    rows = {}
    for name, (kernel, plain, args) in cases(v).items():
        y = kernel(v["x2"], *args)
        ref = plain(v["x2"], *args)
        torch.cuda.synchronize()
        err = float((y.float() - ref.float()).abs().max())
        tolerance = ("bit for bit" if name != "sep2d_probe" else
                     f"|err| <= {probe.SEP_ULP_REL}*|ref| + {probe.SEP_ABS}")
        assert probe.matches_plain(name, y, ref), \
            f"{name}: differs from its plain version ({tolerance}); " \
            f"max|err| {err}"
        dead = ref.float().reshape(-1, probe.P_PAD, probe.C)[:, probe.P:]
        rows[name] = {"max_abs_err": err, "tolerance": tolerance,
                      "ragged_b3_max_abs_err": ragged[name],
                      "dead_rows_max_abs": float(dead.abs().max()),
                      "plain_ms": timed_ms(lambda: plain(v["x2"], *args),
                                           iters=5, warmup=1)}
    del v, y, ref
    probe.reset_launches()
    timing = probe.main(dev)
    launches = dict(probe.launches)
    rows_per_app = probe.B * probe.P_PAD
    elems = rows_per_app * probe.C
    dw_flops = elems * 18
    pw_flops = rows_per_app * probe.C * probe.C * 2
    work = {  # (bound ms, bound by, FLOPs per application, library)
        "fma9": (dw_flops, 2 * elems * 2 + 9 * probe.C * 2, "library_fma9"),
        "dw2d": (dw_flops, 2 * elems * 2 + 9 * probe.C * 2, "library_dw"),
        "sep2d_probe": (pw_flops + dw_flops,
                        (2 * elems + 9 * probe.C + probe.C * probe.C
                         + 2 * probe.C) * 2, "library_sep")}
    for name, plan in plans.items():
        rows[name].update(plan=plan.row(),
                          ptxas=one_function(ptxas, kernel_of[name]),
                          sass_hgmma=one_function(hgmma, kernel_of[name]))
    for name, (flops, nbytes, library) in work.items():
        ms = timing[name]["us_per_app"] / 1e3
        if name == "sep2d_probe":  # tensor cores and CUDA cores overlap
            t_ops = max(pw_flops / peak_flops(torch.bfloat16),
                        dw_flops / peak_flops(torch.float32))
        else:  # float32 arithmetic on the CUDA cores
            t_ops = flops / peak_flops(torch.float32)
        t_bytes = nbytes / H100_BYTES_PER_S
        rows[name].update(
            ms=ms, library_ms=(timing[library]["us_per_app"] / 1e3
                               if library else None),
            bound_ms=max(t_ops, t_bytes) * 1e3,
            bound_by="operations" if t_ops > t_bytes else "bytes",
            launches=launches[name], us_per_app=ms * 1e3,
            img_per_s=timing[name]["img_per_s"],
            gb_per_s=nbytes / (ms * 1e-3) / 1e9,
            tflops=flops / (ms * 1e-3) / 1e12,
            shape=[probe.B * probe.P_PAD, probe.C], dtype="bfloat16")
        emit({"phase": "probe", "kernel": name, **rows[name],
              "library": library and {k: timing[library][k]
                                      for k in ("us_per_app", "img_per_s",
                                                "tflops")}})
    return rows


def featurize(s, model, images, weights, batch_size, parts=1):
    """The user-facing transformer of one phase and its frame. ``model``
    is (name, "named") for ``DeepImageFeaturizer(modelName=name)``,
    (name, "predict") for ``DeepImagePredictor(modelName=name,
    decodePredictions=True, topK=TOP_K)``, or (name, "module") for
    ``TorchImageTransformer`` over ``build_featurizer(name, fast=False)``
    (``"module_bf16"``: built with ``dtype="bfloat16"``, every layer
    computing in bf16 as the reference's Flax ``dtype``). The output
    column is ``features`` in each; the frame has ``parts`` partitions."""
    from sparkdl_tpu_torch.image import imageIO
    from sparkdl_tpu_torch.models import registry

    df = s.DataFrame.fromColumns({"image": imageIO.imageArraysToStructColumn(
        images, [f"img_{i}" for i in range(len(images))])},
        numPartitions=parts)
    name, path = model
    if path == "named":
        feat = s.DeepImageFeaturizer(inputCol="image", outputCol="features",
                                     modelName=name, weights=weights,
                                     batchSize=batch_size)
    elif path == "predict":
        feat = s.DeepImagePredictor(inputCol="image", outputCol="features",
                                    modelName=name, weights=weights,
                                    decodePredictions=True, topK=TOP_K,
                                    batchSize=batch_size)
    else:
        dtype = "bfloat16" if path == "module_bf16" else None
        feat = s.TorchImageTransformer(
            inputCol="image", outputCol="features", outputMode="vector",
            modelFunction=registry.build_featurizer(name, weights=weights,
                                                    fast=False, dtype=dtype),
            batchSize=batch_size)
    return feat, df


def model_function(s, feat):
    """The ModelFunction a phase's transformer runs (before the
    executor's flatten, resize and precision wrappers)."""
    if isinstance(feat, s.DeepImageFeaturizer):
        return feat._model_function("featurize")
    if isinstance(feat, s.DeepImagePredictor):
        return feat._model_function("predict")
    return feat.getModelFunction()


def row_vectors(rows):
    """The ``features`` column as float32 rows, and, for decoded
    predictions, each row's top classes (their probabilities are the
    rows); else None."""
    cells = [r["features"] for r in rows]
    if cells and isinstance(cells[0], list) and isinstance(cells[0][0],
                                                            dict):
        return (np.asarray([[d["probability"] for d in c] for c in cells],
                           np.float32),
                [[d["class"] for d in c] for c in cells])
    return np.stack([np.asarray(c, np.float32) for c in cells]), None


def model_state(s, feat):
    """The float32 weights of a phase's model, on the CPU."""
    return {k: v.detach().cpu().clone()
            for k, v in model_function(s, feat).variables.state_dict().items()}


def executed_model(s, feat, size, precision=None):
    """The model the executor ran: flattened, resized to the model's own
    input size if needed, in ``precision`` (None: the configured one;
    each wrapper is memoized, so these are the same objects, holding the
    same captured graphs)."""
    mf = model_function(s, feat)
    target = mf.input_spec.spatial_size()
    run = mf.flattened()
    if tuple(size) != target:
        run = run.resized(size, target)
    return run.with_dtype(precision or s.EngineConfig.inference_precision)


def autotune_expectation(s, kernels, feat, size, dev):
    """The verdict of every kernel site the phase's model routes through
    (each must have one) and the launches per forward they predict: the
    calls per forward of each adopted site."""
    from sparkdl_tpu_torch.core.model_function import torch_dtype

    run = executed_model(s, feat, size)
    per_forward, verdicts = {}, []
    if not run.kernel_routable:  # bf16, as in the reference: no site
        return per_forward, verdicts
    x = torch.empty((BATCH, *size, 3),
                    dtype=torch_dtype(run.input_spec.dtype), device="meta")
    for site, calls in sorted(kernels.collect_sites(run, x,
                                                    run.variables).items()):
        v = kernels.verdict_for(site, dev)
        assert v is not None, f"no verdict for {site}"
        name = COUNTER_OF_SITE[site.kernel]
        per_forward[name] = per_forward.get(name, 0) \
            + (calls if v["adopted"] else 0)
        verdicts.append({
            "site": kernels._site_key(site, dev), "calls_per_forward": calls,
            "kernel_ms": v["kernel_s"] * 1e3, "twin_ms": v["twin_s"] * 1e3,
            "max_abs_err": v["max_abs_err"], "adopted": v["adopted"],
            "reason": v["reason"], "audition_s": v["audition_s"]})
    return per_forward, verdicts


def graph_vs_eager(run, images, dev, repeats: int = 3):
    """The phase's padded chunks (the power-of-two ladder, as the path's
    cold planner pads them) through its captured graphs and through the
    eager forward of the same model, each with its upload and its one
    fetch: whether every graph output is ``torch.equal`` to the eager
    one, and the images per second of each (the median of ``repeats``
    passes). The eager forward is a yardstick the path never takes."""
    from sparkdl_tpu_torch.core import batching
    from sparkdl_tpu_torch.core.model_function import torch_dtype

    compiled = run.jitted(dev)
    spec = torch_dtype(run.input_spec.dtype)
    chunks = [(torch.from_numpy(c).pin_memory(), n) for c, n in
              batching.iter_batches(np.stack(images), BATCH)]

    def graph_pass():
        outs = [compiled(c, n) for c, n in chunks]
        return torch.cat(outs).float().cpu(), outs

    def eager_pass():
        outs = [run(c.to(dev, non_blocking=True).to(spec))[:n]
                for c, n in chunks]
        return torch.cat(outs).float().cpu(), outs

    with torch.inference_mode():
        equal = all(torch.equal(a, b) for a, b in
                    zip(graph_pass()[1], eager_pass()[1]))
        rates = {}
        for label, fn in (("graph", graph_pass), ("eager", eager_pass)):
            times = []
            for _ in range(repeats):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                times.append(time.perf_counter() - t0)
            rates[label] = len(images) / sorted(times)[len(times) // 2]
        idle = {}
        if PROFILE:
            for label, fn in (("graph", graph_pass), ("eager", eager_pass)):
                idle[label] = profiled(fn)["idle_share"]
    return equal, rates, idle


def profiled(fn):
    """``fn()`` once under ``torch.profiler``: wall ms, device busy ms,
    the device's idle share and the device events by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # user annotations (the port's record_function phases) also appear
    # on the device's timeline; they are ranges, not device work
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0
               and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(ms for _, ms, _ in kernels)
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": (1.0 - busy_ms / wall_ms) if busy_ms else None,
            "kernels": kernels}


def profile_pass(name, feat, df, top: int = 12):
    """One more featurize pass under ``torch.profiler``: device time by
    kernel and the device's idle share of the pass's wall time."""
    got = profiled(lambda: feat.transform(df).collect())
    wall_ms, busy_ms, kernels = (got["wall_ms"], got["device_busy_ms"],
                                 got["kernels"])
    kernels.sort(key=lambda k: -k[1])
    port = {}
    for key, ms, n in kernels:
        body = port_kernel(key)
        if body is not None:
            entry = port.setdefault(body, {"ms": 0.0, "calls": 0})
            entry["ms"] += ms
            entry["calls"] += n
    for entry in port.values():
        entry["share"] = entry["ms"] / busy_ms
    emit({"phase": f"{name}_profile", "wall_ms": wall_ms,
          "device_busy_ms": busy_ms, "idle_share": got["idle_share"],
          "port_kernels": port,
          "top_kernels": [{"name": k[:90], "ms": ms, "calls": n,
                           "share": ms / busy_ms}
                          for k, ms, n in kernels[:top]]})
    return got["idle_share"]


def port_kernel(key: str):
    """``kernel/body`` of one of the port's kernels from its profiler
    name, else None."""
    if "simt32::mainloop" in key:
        return ("sep2d" if ", true>" in key else "pw1x1") + "/simt_f32"
    for kernel, bodies in (("sep2d", (("tc::", "wgmma"),
                                      ("simt::", "simt_bf16"))),
                           ("pw1x1", (("tc::", "wgmma"), ("mma::", "mma"),
                                      ("splitk_reduce", "wgmma")))):
        if f"{kernel}_kernel" in key or (kernel == "pw1x1"
                                         and "splitk_reduce" in key):
            body = next((b for part, b in bodies if part in key), "other")
            return f"{kernel}/{body}"
    if "preproc_kernel" in key or "preproc_resize" in key:
        return "preproc_resize"
    return None


#: every staging stream run_batched opened (RecordedPrefetcher)
STREAMS = []


def record_streams():
    """Make run_batched's staging pipeline keep each stream it opens, so
    a phase can sum their PrefetchStats."""
    from sparkdl_tpu_torch.core import pipeline

    class RecordedPrefetcher(pipeline.DevicePrefetcher):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            STREAMS.append(self)

    pipeline.DevicePrefetcher = RecordedPrefetcher


def prefetch_totals(streams):
    """The PrefetchStats of ``streams`` summed (max_depth: the largest),
    with the number of streams and of those staged on a thread."""
    out = {"streams": len(streams),
           "threaded": sum(1 for p in streams if p.depth > 0)}
    for p in streams:
        for k, v in p.stats.as_dict().items():
            out[k] = max(out.get(k, 0), v) if k == "max_depth" \
                else out.get(k, 0) + v
    return out


def host_ms(phase_stats, seconds, workers=1):
    """The counted pass's ms by phase timer and its wall ms. With one
    partition thread, also the ms of its wall outside
    ``sparkdl.device_apply`` (the frame's own work: the column's stack,
    ``collect()``'s rows); with several, the timers are summed over
    threads that overlap, so they stand beside the wall and the worker
    count and nothing is subtracted."""
    out = {k: v["total_s"] * 1e3 for k, v in phase_stats.items()}
    out["pass"] = seconds * 1e3
    if workers > 1:
        out["workers"] = workers
        out["timers_summed_over_threads"] = True
    else:
        out["outside_device_apply"] = out["pass"] - out.get(
            "sparkdl.device_apply", 0.0)
    return out


class GaugePeaks:
    """The largest value each telemetry gauge was set to while the block
    ran (a gauge keeps only its last value)."""

    def __init__(self, telemetry):
        self.telemetry = telemetry
        self.peaks = {}

    def __enter__(self):
        self.gauge_set = self.telemetry.gauge_set

        def gauge_set(name, value):
            self.peaks[name] = max(self.peaks.get(name, value), value)
            self.gauge_set(name, value)

        self.telemetry.gauge_set = gauge_set
        return self

    def __exit__(self, *exc):
        self.telemetry.gauge_set = self.gauge_set


def decode_pool_metrics(tel, peaks):
    """The decode pool's instruments of a telemetry scope: the peak
    queue depth (chunks in flight) and workers busy, each blob's decode
    time in its worker (count, mean, p50, p99, max), and the pool spans
    and adopted worker chunk spans; None where no pool ran."""
    from sparkdl_tpu_torch.core import telemetry

    h = tel.metrics.snapshot()["histograms"].get(
        telemetry.M_DECODE_POOL_DECODE_S)
    if h is None:
        return None
    summary = tel.tracer.summary()
    return {"queue_depth_peak": peaks.peaks.get(
                telemetry.M_DECODE_POOL_DEPTH),
            "workers_busy_peak": peaks.peaks.get(
                telemetry.M_DECODE_POOL_BUSY),
            "decode_s": {"count": h["count"], "mean": h["sum"] / h["count"],
                         "p50": h["p50"], "p99": h["p99"], "max": h["max"]},
            "pool_spans": len(tel.tracer.spans(telemetry.SPAN_DECODE_POOL)),
            "chunk_spans_adopted": summary["remote_adopted"],
            "chunk_spans_rejected": summary["remote_rejected"]}


def executor_metrics(tel):
    """The coalescing executor's instruments of a telemetry scope: each
    histogram's count, mean, max, p50 and p99 (None where nothing was
    observed), and its gauges."""
    from sparkdl_tpu_torch.core import telemetry

    snap = tel.metrics.snapshot()
    out = {}
    for key, name in (("coalesce_requests", telemetry.M_COALESCE_REQUESTS),
                      ("coalesce_rows", telemetry.M_COALESCE_ROWS),
                      ("queue_wait_s", telemetry.M_QUEUE_WAIT_S),
                      ("launch_s", telemetry.M_LAUNCH_S)):
        h = snap["histograms"].get(name)
        out[key] = None if h is None else {
            "count": h["count"], "mean": h["sum"] / h["count"],
            "max": h["max"], "p50": h["p50"], "p99": h["p99"]}
    out["dedup_hits"] = snap["counters"].get(telemetry.M_COALESCE_DEDUP, 0)
    return out


#: each main-path phase's transformer, by phase: a later phase over the
#: same model (the int8 phases) reuses it, and with it the model's
#: float32 weights
FEATURIZERS = {}


def main_path(s, kernels, name, model, size, per_forward, rel_tol,
              mode="force", precision="bfloat16", n_images=N_IMAGES,
              feat=None):
    """Featurize ``n_images`` seeded images of ``size`` on the card under
    the kernel gate's ``mode`` and ``EngineConfig.inference_precision``
    (one warm-up pass, which captures a CUDA graph per bucket rung, then
    the counted and timed pass, all replays), check the launch counts
    against ``per_forward`` launches per forward (under "autotune", those
    its verdicts predict) and the bodies they took (every bf16 launch of
    sep2d and pw1x1 on the tensor-core body), check two of the features
    against the port's CPU run of the same weights, and hold the graphs'
    outputs ``torch.equal`` to the eager forward of the same chunks (and
    time both). Sizes and widths are the model's spec's (decoded
    predictions: their TOP_K probabilities, and their classes against the
    CPU run's). The line carries the counted pass's phase timers, staging
    streams and health counters, and the graphs' forward rate in TFLOP/s
    where the spec has the model's FLOPs per image. ``feat``: the
    transformer of an earlier phase over the same model, reused."""
    from sparkdl_tpu_torch.core import health, profiling, telemetry
    from sparkdl_tpu_torch.models import registry

    spec = registry.get_model_spec(model[0])
    s.EngineConfig.inference_precision = precision
    rng = np.random.default_rng(SEED + size[0])
    images = [rng.integers(0, 256, size=(*size, 3), dtype=np.uint8)
              for _ in range(n_images)]
    s.EngineConfig.device = "cuda"
    s.EngineConfig.pallas_kernels = mode
    if feat is None:
        feat, df = featurize(s, model, images, "random", BATCH)
    else:
        df = featurize(s, model, images, "random", BATCH)[1]
    FEATURIZERS[name] = feat
    # warm-up (builds, allocator, cuDNN plans; under "autotune", the
    # auditions of every site at its first sight; a graph per rung)
    profiling.reset_phase_stats()
    t0 = time.perf_counter()
    feat.transform(df).collect()
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    capture = profiling.phase_stats().get("sparkdl.compile",
                                          {"total_s": 0.0, "count": 0})
    verdicts = None
    if mode == "autotune":
        per_forward, verdicts = autotune_expectation(s, kernels, feat, size,
                                                     torch.device("cuda"))
    kernels.reset_launches()
    profiling.reset_phase_stats()
    del STREAMS[:]
    with health.HealthMonitor(name) as monitor, \
            telemetry.Telemetry(name) as tel:
        t0 = time.perf_counter()
        rows = feat.transform(df).collect()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    # one partition is a solo request: the inline path, no coalescing
    coalescing = executor_metrics(tel)
    assert coalescing["coalesce_requests"] is None \
        and coalescing["queue_wait_s"] is None, \
        f"{name}: a one-partition frame went through the coalescer"
    counts = dict(kernels.launches)
    phase_stats = profiling.phase_stats()
    overlap = profiling.overlap_stats()
    prefetch = prefetch_totals(STREAMS)
    by_body = {k: dict(v) for k, v in kernels.launches_by_body.items()}
    for kernel, bodies in by_body.items():
        assert sum(bodies.values()) == counts[kernel], (name, by_body)
        # the network's dtype: bf16 when built so, or under the bf16 or
        # int8 precision when no resize brings it back to float32 (ROADMAP
        # Queue 3)
        if kernel not in ("sep2d", "pw1x1"):
            continue
        if model[1] == "module_bf16" or (precision in ("bfloat16", "int8")
                                         and tuple(size) == spec.input_size):
            assert bodies["wgmma"] == counts[kernel], \
                f"{name}: bf16 {kernel} launches off the tensor-core " \
                f"body: {bodies}"
        else:
            assert bodies["simt_f32"] == counts[kernel], \
                f"{name}: float32 {kernel} launches off the float32 " \
                f"mainloop: {bodies}"
    gpu, gpu_classes = row_vectors(rows)
    width = TOP_K if model[1] == "predict" else spec.feature_dim
    assert gpu.shape == (n_images, width), gpu.shape
    assert np.isfinite(gpu).all(), "non-finite features"
    forwards = -(-n_images // BATCH)
    expected = {k: per_forward.get(k, 0) * forwards for k in counts}
    assert counts == expected, f"{name}: launches {counts} != {expected}"
    assert "sparkdl.compile" not in phase_stats, \
        f"{name}: the counted pass captured again: {phase_stats}"

    dev = torch.device("cuda")
    run = executed_model(s, feat, size)
    graphs = sorted(((k[0][0], g) for k, g in run.jitted(dev).graphs.items()),
                    key=lambda item: item[0])
    rungs = [rung for rung, _ in graphs]
    assert rungs, f"{name}: no graph captured"
    graph_equal, rates, idle = graph_vs_eager(run, images, dev)
    assert graph_equal, f"{name}: a graph's output differs from the " \
                        f"eager forward of the same chunk"

    s.EngineConfig.device = "cpu"
    cpu_feat, cpu_df = featurize(s, model, images[:2], model_state(s, feat),
                                 2)
    cpu, cpu_classes = row_vectors(cpu_feat.transform(cpu_df).collect())
    s.EngineConfig.device = "cuda"
    err = float(np.max(np.abs(gpu[:2] - cpu)))
    limit = rel_tol * float(np.max(np.abs(cpu)))
    assert err <= limit, f"{name}: features differ from the CPU run by " \
                         f"{err} > {limit}"
    assert gpu_classes is None or gpu_classes[:2] == cpu_classes, \
        f"{name}: top classes {gpu_classes[:2]} != {cpu_classes}"
    out = {"phase": name, "model": model[0], "path": model[1],
           "images": n_images, "source_size": list(size),
           "batch_size": BATCH, "pallas_kernels": mode,
           "precision": s.EngineConfig.inference_precision,
           "warmup_s": warmup_s, "seconds": seconds,
           "images_per_s": n_images / seconds,
           "graphs": len(rungs), "rungs": rungs,
           "graph_pool_mib": [g.pool_bytes / 2 ** 20 for _, g in graphs],
           "capture_s": capture["total_s"], "captures": capture["count"],
           "graph_equal": graph_equal,
           "graph_forward_images_per_s": rates["graph"],
           "eager_images_per_s": rates["eager"],
           # the rate the graphs' forward achieves at the reference spec's
           # FLOPs per image (2·MACs at the input size)
           "flops_per_image": spec.flops_per_image,
           "graph_forward_tflops": (rates["graph"] * spec.flops_per_image
                                    / 1e12 if spec.flops_per_image
                                    else None),
           "host_ms_per_partition": host_ms(phase_stats, seconds),
           "phase_stats": phase_stats, "overlap": overlap,
           "prefetch": prefetch, "health": monitor.counters(),
           "executor": coalescing,
           "launches": counts, "launches_by_body": by_body,
           "max_abs_err_vs_cpu": err,
           "tolerance": limit, "feature_max_abs": float(np.abs(cpu).max())}
    if verdicts is not None:
        out["verdicts"] = verdicts
    if PROFILE:
        out["idle_share"] = profile_pass(name, feat, df)
        out["graph_forward_idle_share"] = idle["graph"]
        out["eager_idle_share"] = idle["eager"]
    emit(out)
    return out


# (phase, (model, path), source size, launches per forward, tolerance)
PHASES = [
    ("featurize_resized", ("Xception", "named"), (256, 256),
     {"sep2d": 34, "preproc_resize": 1}, F32_REL),
    ("featurize_native", ("Xception", "named"), TARGET, {"sep2d": 34},
     BF16_REL),
    ("inception_featurize_resized", ("InceptionV3", "named"), (256, 256),
     {"preproc_resize": 1}, F32_REL),
    ("inception_module_native", ("InceptionV3", "module"), TARGET,
     {"pw1x1": 39}, BF16_REL),
    ("inception_module_resized", ("InceptionV3", "module"), (256, 256),
     {"pw1x1": 39, "preproc_resize": 1}, F32_REL),
]
# The 224×224 models (and TestNet's 32×32): (phase, (model, path),
# source size, launches per forward, tolerance, gate, precision). None of
# them routes sep2d or pw1x1, as in the reference; a resized source
# launches preproc_resize once per forward. resnet50_native runs the
# user's default gate, "autotune", where bf16 collects no site.
ZOO_PHASES = [
    ("resnet50_native", ("ResNet50", "named"), (224, 224), None, BF16_REL,
     "autotune", "bfloat16"),
    ("resnet50_resized", ("ResNet50", "named"), (256, 256),
     {"preproc_resize": 1}, F32_REL, "force", "bfloat16"),
    ("vgg16_native", ("VGG16", "named"), (224, 224), {}, BF16_REL, "force",
     "bfloat16"),
    ("mobilenet_v2_native", ("MobileNetV2", "named"), (224, 224), {},
     BF16_REL, "force", "bfloat16"),
    ("testnet_predict", ("TestNet", "predict"), (32, 32), {}, F32_REL,
     "force", "float32"),
]
#: the deeper members of the 224×224 families, each a phase of BATCH
#: images (one forward) under "force" in bf16, checked as the others
DEPTH_CHECKS = ("ResNet101", "ResNet152", "VGG19")


def resnet_fast_vs_module(dev, n_images=4 * BATCH, repeats=5):
    """ResNet50's fast apply (``models/resnet_fast.py``: BN folded, each
    downsampling block's ``conv_0`` and ``conv_1`` as one conv, computing
    in bf16) against the module the default featurizer runs (the
    registry's, under the bf16 precision), both through captured graphs
    of the same padded chunks of seeded 224×224 images with upload and
    fetch: images/s of each (the median of ``repeats`` passes, in turns
    module, fast, fast, module) and their max|Δ|. A number only: the
    registry does not select the fast apply, as in the reference."""
    from sparkdl_tpu_torch.core import batching
    from sparkdl_tpu_torch.core.model_function import ModelFunction
    from sparkdl_tpu_torch.models import registry
    from sparkdl_tpu_torch.models.resnet_fast import resnet_fast_apply

    spec = registry.get_model_spec("ResNet50")
    module_mf = registry.build_featurizer("ResNet50", seed=SEED)
    fast = ModelFunction.fromFunction(
        lambda m, x: resnet_fast_apply(m, x, compute_dtype=torch.bfloat16),
        module_mf.variables, module_mf.input_spec, name="ResNet50_fast")
    runs = {"module": module_mf.flattened().with_dtype("bfloat16"),
            "fast": fast.with_preprocess(spec.preprocess).flattened()}
    rng = np.random.default_rng(SEED + 8)
    images = rng.integers(0, 256, size=(n_images, *spec.input_size, 3),
                          dtype=np.uint8)
    chunks = [(torch.from_numpy(c).pin_memory(), n)
              for c, n in batching.iter_batches(images, BATCH)]
    outs, times = {}, {"module": [], "fast": []}
    with torch.inference_mode():
        for label, run in runs.items():
            run.to(dev)
            compiled = run.jitted(dev)
            outs[label] = torch.cat([compiled(c, n) for c, n in chunks]
                                    ).float().cpu()
        for label in ["module", "fast", "fast", "module"] * repeats:
            compiled = runs[label].jitted(dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            torch.cat([compiled(c, n) for c, n in chunks]).float().cpu()
            times[label].append(time.perf_counter() - t0)
    rates = {k: n_images / sorted(v)[len(v) // 2] for k, v in times.items()}
    for label, out in outs.items():
        assert out.shape == (n_images, spec.feature_dim), (label, out.shape)
        assert torch.isfinite(out).all(), f"{label}: non-finite features"
    diff = float((outs["fast"] - outs["module"]).abs().max())
    out = {"phase": "resnet_fast_vs_module", "images": n_images,
           "batch_size": BATCH, "source_size": list(spec.input_size),
           "dtype": "bfloat16", "passes": 2 * repeats,
           "module_images_per_s": rates["module"],
           "fast_images_per_s": rates["fast"],
           "fast_over_module": rates["fast"] / rates["module"],
           "max_abs_diff": diff,
           "feature_max_abs": float(outs["module"].abs().max()),
           "registry_selects_fast": module_mf.fast_path}
    emit(out)
    return out


# int8 weight-only quantization under "force": (phase, (model, path),
# source size, launches per forward, tolerance, the bf16 phase whose
# transformer, and so whose float32 weights, it reuses). Without a resize
# the network runs in bf16 (sep2d's tensor-core body); behind the resize
# in float32 with the bf16-dequantized weights (simt_f32), as the
# reference's flow does (ROADMAP Queue 3).
INT8_PHASES = [
    ("featurize_native_int8", ("Xception", "named"), TARGET, {"sep2d": 34},
     BF16_REL, "featurize_native"),
    ("featurize_resized_int8", ("Xception", "named"), (256, 256),
     {"sep2d": 34, "preproc_resize": 1}, F32_REL, "featurize_resized"),
    ("vgg16_native_int8", ("VGG16", "named"), (224, 224), {}, BF16_REL,
     "vgg16_native"),
]
#: int8 holds a model's weights in at most this share of float32's bytes
INT8_WEIGHT_SHARE = 0.27


def int8_weights(s, phases, name, size, against):
    """``weight_bytes`` of the int8 phase's model in each precision, the
    graph pool MiB and images/s beside those of the bf16 phase
    ``against`` over the same weights; int8 must hold at most
    INT8_WEIGHT_SHARE of float32's bytes."""
    feat = FEATURIZERS[name]
    held = {p: (model_function(s, feat) if p == "float32"
                else executed_model(s, feat, size, p)).weight_bytes()
            for p in ("float32", "bfloat16", "int8")}
    share = held["int8"] / held["float32"]
    out = {"phase": f"{name}_weights", "weight_bytes": held,
           "int8_over_float32": share, "against": against}
    for key in ("graph_pool_mib", "images_per_s",
                "graph_forward_images_per_s", "max_abs_err_vs_cpu"):
        out[key] = {name: phases[name][key], against: phases[against][key]}
    emit(out)
    assert share <= INT8_WEIGHT_SHARE, \
        f"{name}: int8 holds {share:.3f} of float32's weight bytes"
    return out


#: the partitioned frames: images, partitions, partition threads
PART_IMAGES = 64
PARTITIONS = 16
WORKERS = 8
# (phase, (model, path), source size, launches per forward, tolerance,
# gate, precision): each run with coalescing on and off
PARTITIONED_PHASES = [
    ("featurize_partitioned", ("Xception", "named"), TARGET, {"sep2d": 34},
     BF16_REL, "force", "bfloat16"),
    ("resnet50_partitioned_resized", ("ResNet50", "named"), (256, 256),
     {"preproc_resize": 1}, F32_REL, "force", "bfloat16"),
    ("resnet50_partitioned", ("ResNet50", "named"), (224, 224), {},
     BF16_REL, "autotune", "bfloat16"),
]


def partitioned_pass(s, kernels, name, feat, df, compiled, per_forward,
                     body="wgmma"):
    """One counted pass of a partitioned frame on the card: its rows,
    and its launches, forwards (the program's replays, its first sights
    included), the graphs captured during the pass, the executor's and
    the decode pool's instruments, phase timers and health. Every launch
    count must be per-forward × forwards, every ``sep2d``/``pw1x1``
    launch on ``body`` (the tensor-core body of a bf16 network, or
    ``simt_f32``)."""
    from sparkdl_tpu_torch.core import executor, health, profiling, \
        telemetry

    kernels.reset_launches()
    profiling.reset_phase_stats()
    replays = compiled.replays
    with health.HealthMonitor(name) as monitor, \
            telemetry.Telemetry(name) as tel, \
            GaugePeaks(telemetry) as peaks:
        t0 = time.perf_counter()
        rows = feat.transform(df).collect()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    counts = dict(kernels.launches)
    by_body = {k: dict(v) for k, v in kernels.launches_by_body.items()}
    stats = profiling.phase_stats()
    captures = stats.get("sparkdl.compile", {"count": 0})["count"]
    # a capture runs one eager warm-up forward (counted by the wrappers)
    # before the graph's first replay
    forwards = compiled.replays - replays
    expected = {k: per_forward.get(k, 0) * (forwards + captures)
                for k in counts}
    assert counts == expected, \
        f"{name}: launches {counts} != per-forward × forwards {expected}"
    for kernel in ("sep2d", "pw1x1"):
        assert by_body[kernel][body] == counts[kernel], \
            f"{name}: {kernel} off the {body} body: {by_body}"
    failed = monitor.count(health.TASK_FAILED)
    assert failed == 0, f"{name}: {failed} task(s) failed"
    status = executor.status()
    assert status["queued_requests"] == 0 and status["inflight"] == 0, \
        f"{name}: requests left in the executor: {status}"
    return rows, {
        "seconds": seconds, "images_per_s": len(rows) / seconds,
        "forwards": forwards, "captures_in_pass": captures,
        "launches": counts, "launches_by_body": by_body,
        "executor": executor_metrics(tel), "health": monitor.counters(),
        "decode_pool": decode_pool_metrics(tel, peaks),
        "host_ms": host_ms(stats, seconds, workers=WORKERS),
        "phase_stats": stats}


def partitioned_path(s, kernels, name, model, size, per_forward, rel_tol,
                     mode, precision):
    """Featurize PART_IMAGES seeded images of ``size`` in PARTITIONS
    partitions on WORKERS partition threads, through ``transform(df).
    collect()``, once with ``EngineConfig.coalesce`` on (the default) and
    once off, each after its own warm-up pass. The coalesced run must
    make fewer forwards than there are partitions; both runs' launches
    are per-forward × forwards; every row of both agrees with the port's
    CPU run of the same weights on the same images within ``rel_tol``,
    and so do the two runs with each other (``torch.equal`` and max|Δ|
    printed). Emits one line per run and returns both."""
    from sparkdl_tpu_torch.models import registry

    spec = registry.get_model_spec(model[0])
    s.EngineConfig.inference_precision = precision
    s.EngineConfig.device = "cuda"
    s.EngineConfig.pallas_kernels = mode
    s.EngineConfig.max_workers = WORKERS
    rng = np.random.default_rng(SEED + 100 + size[0])
    images = [rng.integers(0, 256, size=(*size, 3), dtype=np.uint8)
              for _ in range(PART_IMAGES)]
    feat, df = featurize(s, model, images, "random", BATCH,
                         parts=PARTITIONS)
    assert df.numPartitions == PARTITIONS
    dev = torch.device("cuda")
    run = executed_model(s, feat, size)
    compiled = run.jitted(dev)
    results, feats = {}, {}
    for coalesce in (True, False):
        s.EngineConfig.coalesce = coalesce
        t0 = time.perf_counter()
        feat.transform(df).collect()  # warm-up: graphs of new rungs
        torch.cuda.synchronize()
        warmup_s = time.perf_counter() - t0
        label = name if coalesce else f"{name}_uncoalesced"
        rows, out = partitioned_pass(s, kernels, label, feat, df, compiled,
                                     per_forward)
        feats[coalesce] = row_vectors(rows)[0]
        out.update({"phase": label, "model": model[0], "path": model[1],
                    "coalesce": coalesce, "images": PART_IMAGES,
                    "partitions": PARTITIONS, "workers": WORKERS,
                    "source_size": list(size), "batch_size": BATCH,
                    "pallas_kernels": mode, "precision": precision,
                    "warmup_s": warmup_s})
        if PROFILE:
            out["idle_share"] = profile_pass(label, feat, df)
        results[coalesce] = out
    s.EngineConfig.coalesce = True
    coalesced, plain = results[True], results[False]
    assert plain["forwards"] >= PARTITIONS, plain["forwards"]
    assert coalesced["forwards"] < PARTITIONS, \
        f"{name}: {coalesced['forwards']} forwards for {PARTITIONS} " \
        f"partitions: nothing coalesced"
    assert coalesced["executor"]["coalesce_requests"]["max"] >= 2

    graphs = sorted(((k[0][0], g) for k, g in compiled.graphs.items()),
                    key=lambda item: item[0])
    graph_equal, rates, _ = graph_vs_eager(run, images, dev)
    assert graph_equal, f"{name}: a graph's output differs from the " \
                        f"eager forward of the same chunk"
    # every row on the CPU: the rows of the partitions that coalesced
    # windows carried, not only the inline first partition's
    s.EngineConfig.device = "cpu"
    s.EngineConfig.max_workers = 1
    t0 = time.perf_counter()
    cpu_feat, cpu_df = featurize(s, model, images, model_state(s, feat),
                                 BATCH)
    cpu, _ = row_vectors(cpu_feat.transform(cpu_df).collect())
    cpu_s = time.perf_counter() - t0
    s.EngineConfig.device = "cuda"
    limit = rel_tol * float(np.max(np.abs(cpu)))
    a, b = torch.from_numpy(feats[True]), torch.from_numpy(feats[False])
    between = {"torch_equal": bool(torch.equal(a, b)),
               "max_abs_diff": float((a - b).abs().max()),
               "feature_max_abs": float(b.abs().max())}
    assert between["max_abs_diff"] <= limit, \
        f"{name}: coalesced and uncoalesced features differ by " \
        f"{between['max_abs_diff']} > {limit}"
    for coalesce, out in results.items():
        gpu = feats[coalesce]
        assert gpu.shape == (PART_IMAGES, spec.feature_dim), gpu.shape
        assert np.isfinite(gpu).all(), f"{name}: non-finite features"
        per_row = np.max(np.abs(gpu - cpu), axis=1)
        err = float(per_row.max())
        assert err <= limit, f"{out['phase']}: row {int(per_row.argmax())} " \
                             f"differs from the CPU run by {err} > {limit}"
        out.update({"max_abs_err_vs_cpu": err, "rows_vs_cpu": len(per_row),
                    "cpu_run_s": cpu_s, "tolerance": limit,
                    "graphs": len(graphs),
                    "rungs": [rung for rung, _ in graphs],
                    "graph_equal": graph_equal,
                    "graph_forward_images_per_s": rates["graph"],
                    "coalesced_vs_uncoalesced": between})
        emit(out)
    return coalesced, plain, df, feat, cpu


#: the prefetch of each streamed run, and the partitions a loop takes
#: before it breaks
STREAM_PREFETCH = (2, 7)
STREAM_BREAK_AFTER = 2


class InFlight:
    """Partitions started and not yet yielded: ``start`` runs first in
    each partition's op chain (it adds a column), the consumer calls
    ``took`` for each partition it gets."""

    def __init__(self):
        import threading

        self.lock = threading.Lock()
        self.started = self.yielded = self.peak = 0

    def start(self, batch):
        with self.lock:
            self.started += 1
            self.peak = max(self.peak, self.started - self.yielded)
        return np.zeros(batch.num_rows, np.int8)

    def took(self):
        with self.lock:
            self.yielded += 1


def part_threads() -> int:
    import threading

    return sum(t.name.startswith("sparkdl-part")
               for t in threading.enumerate())


def stream_pass(s, kernels, label, feat, df, compiled, prefetch,
                per_forward, break_after=None):
    """One loop over ``feat.transform(df).streamPartitions(prefetch)``
    on the card, left after ``break_after`` partitions if given: the
    features it took, and its line's numbers. Launches must be
    per-forward × forwards, every bf16 launch on the tensor-core body,
    the executor must end empty and no task may fail."""
    from sparkdl_tpu_torch.core import executor, health, profiling, \
        telemetry

    tracker = InFlight()
    out = feat.transform(df.withColumnBatch("started", tracker.start))
    kernels.reset_launches()
    profiling.reset_phase_stats()
    replays = compiled.replays
    taken = []
    with health.HealthMonitor(label) as monitor, \
            telemetry.Telemetry(label) as tel:
        t0 = time.perf_counter()
        stream = out.streamPartitions(prefetch=prefetch)
        for part in stream:
            tracker.took()
            taken.append(np.asarray(part.column("features"), np.float32))
            if len(taken) == break_after:
                break
        stream.close()  # an abandoned stream: cancel, then drain
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    counts = dict(kernels.launches)
    by_body = {k: dict(v) for k, v in kernels.launches_by_body.items()}
    stats = profiling.phase_stats()
    captures = stats.get("sparkdl.compile", {"count": 0})["count"]
    forwards = compiled.replays - replays
    expected = {k: per_forward.get(k, 0) * (forwards + captures)
                for k in counts}
    assert counts == expected, \
        f"{label}: launches {counts} != per-forward × forwards {expected}"
    assert by_body["sep2d"]["wgmma"] == counts["sep2d"], by_body
    assert monitor.count(health.TASK_FAILED) == 0, monitor.counters()
    status = executor.status()
    assert status["queued_requests"] == 0 and status["inflight"] == 0, \
        f"{label}: requests left in the executor: {status}"
    rows = sum(len(t) for t in taken)
    return np.concatenate(taken), {
        "phase": label, "prefetch": prefetch, "seconds": seconds,
        "images_per_s": rows / seconds, "rows": rows,
        "partitions_taken": len(taken), "forwards": forwards,
        "captures_in_pass": captures,
        "partitions_started": tracker.started,
        "peak_in_flight": tracker.peak, "launches": counts,
        "launches_by_body": by_body, "executor": executor_metrics(tel),
        "health": monitor.counters(),
        "host_ms": host_ms(stats, seconds, workers=WORKERS)}


def streamed_path(s, kernels, feat, df, cpu, rel_tol):
    """``featurize_partitioned``'s frame (Xception, 64 299×299 images in
    16 partitions of 4, "force", bf16, WORKERS partition threads)
    consumed by a loop over ``streamPartitions``, once at each prefetch
    of STREAM_PREFETCH after a warm-up loop: images/s, forwards, the
    peak of partitions started and not yet yielded (at most prefetch +
    1), queue wait p50/p99; every row against ``cpu`` (the port's CPU run
    of the same weights on the same images) and the runs against each
    other. Then ``stream_early_break``: a loop that breaks after
    STREAM_BREAK_AFTER partitions must have started at most
    STREAM_BREAK_AFTER + prefetch + 1 partitions' op chains, and leaves
    the pool's threads as it found them."""
    s.EngineConfig.inference_precision = "bfloat16"
    s.EngineConfig.device = "cuda"
    s.EngineConfig.pallas_kernels = "force"
    s.EngineConfig.max_workers = WORKERS
    s.EngineConfig.coalesce = True
    compiled = executed_model(s, feat, TARGET).jitted(torch.device("cuda"))
    per_forward = {"sep2d": 34}
    limit = rel_tol * float(np.max(np.abs(cpu)))
    runs = {}
    for prefetch in STREAM_PREFETCH:
        t0 = time.perf_counter()
        stream_pass(s, kernels, "warmup", feat, df, compiled, prefetch,
                    per_forward)
        warmup_s = time.perf_counter() - t0
        label = "featurize_streamed"
        if prefetch != STREAM_PREFETCH[0]:
            label += f"_prefetch{prefetch}"
        gpu, out = stream_pass(s, kernels, label, feat, df, compiled,
                               prefetch, per_forward)
        assert gpu.shape == cpu.shape and np.isfinite(gpu).all()
        assert out["peak_in_flight"] <= prefetch + 1, out
        per_row = np.max(np.abs(gpu - cpu), axis=1)
        err = float(per_row.max())
        assert err <= limit, f"{label}: row {int(per_row.argmax())} " \
            f"differs from the CPU run by {err} > {limit}"
        out.update({"images": PART_IMAGES, "partitions": PARTITIONS,
                    "workers": WORKERS, "warmup_s": warmup_s,
                    "max_abs_err_vs_cpu": err, "rows_vs_cpu": len(per_row),
                    "tolerance": limit})
        runs[prefetch] = (gpu, out)
    (a, first), (b, second) = (runs[p] for p in STREAM_PREFETCH)
    between = {"torch_equal": bool(np.array_equal(a, b)),
               "max_abs_diff": float(np.max(np.abs(a - b)))}
    assert between["max_abs_diff"] <= limit, between
    for _, out in runs.values():
        out["prefetch_runs_against_each_other"] = between
        emit(out)

    threads_before = part_threads()
    prefetch = STREAM_PREFETCH[0]
    taken, out = stream_pass(s, kernels, "stream_early_break", feat, df,
                             compiled, prefetch, per_forward,
                             break_after=STREAM_BREAK_AFTER)
    bound = STREAM_BREAK_AFTER + prefetch + 1
    out.update({"partitions": PARTITIONS, "bound": bound,
                "partitions_never_started": PARTITIONS
                - out["partitions_started"],
                "part_threads_before": threads_before,
                "part_threads_after": part_threads()})
    emit(out)
    assert out["partitions_taken"] == STREAM_BREAK_AFTER, out
    assert out["partitions_started"] <= bound, out
    assert out["health"].get("task_started", 0) \
        == out["partitions_started"], out  # health.TASK_STARTED
    assert out["part_threads_after"] == threads_before, out
    assert np.max(np.abs(taken - cpu[:len(taken)])) <= limit
    return first, second, out


def oom_rechunk(s, kernels, part_frame):
    """The resilience paths on the card, on Xception (force, bf16):

    1. one partition of 32 299×299 images at batch 16, with the
       ``device_oom`` injection point armed once at bucket 16: the chunk
       re-chunks at 8 (one ``oom_rechunk`` event), rung 8 is captured,
       and the features agree with the uninjected run;
    2. ``device_oom`` armed once inside a coalesced window of
       ``featurize_partitioned``'s frame: the window splits back per
       request, each request completing on its own partition thread;
    3. one real allocation that cannot fit: ``classify`` calls it OOM,
       and a replay after it equals the one before, so the context
       survived."""
    import threading

    from sparkdl_tpu_torch.core import executor, health, resilience

    s.EngineConfig.inference_precision = "bfloat16"
    s.EngineConfig.device = "cuda"
    s.EngineConfig.pallas_kernels = "force"
    s.EngineConfig.coalesce = True
    rng = np.random.default_rng(SEED + 7)
    images = [rng.integers(0, 256, size=(*TARGET, 3), dtype=np.uint8)
              for _ in range(2 * BATCH)]
    feat, df = featurize(s, ("Xception", "named"), images, "random", BATCH)
    dev = torch.device("cuda")
    compiled = executed_model(s, feat, TARGET).jitted(dev)
    clean, _ = row_vectors(feat.transform(df).collect())
    rungs_before = sorted(k[0][0] for k in compiled.graphs)
    assert BATCH // 2 not in rungs_before, rungs_before
    kernels.reset_launches()
    with resilience.FaultInjector.seeded(0, device_oom=resilience.Fault(
            times=1, when=lambda c: c["rows"] == BATCH)) as inj, \
            health.HealthMonitor("oom_rechunk") as mon:
        injected, _ = row_vectors(feat.transform(df).collect())
    torch.cuda.synchronize()
    rungs_after = sorted(k[0][0] for k in compiled.graphs)
    a, b = torch.from_numpy(clean), torch.from_numpy(injected)
    diff = float((a - b).abs().max())
    limit = BF16_REL * float(a.abs().max())
    assert inj.fired["device_oom"] == 1
    assert mon.count(health.OOM_RECHUNK) == 1, mon.counters()
    (event,) = mon.events(health.OOM_RECHUNK)
    assert (event["bucket"], event["half"]) == (BATCH, BATCH // 2), event
    assert BATCH // 2 in rungs_after, rungs_after
    assert diff <= limit, f"oom_rechunk: {diff} > {limit}"
    injected_launches = dict(kernels.launches)
    injected_by_body = {k: dict(v)
                        for k, v in kernels.launches_by_body.items()}

    # a coalesced window of the partitioned frame, failed once
    feat_p, df_p = part_frame
    s.EngineConfig.max_workers = WORKERS
    replayed = []
    replay_alone = executor.DeviceExecutor._replay_alone

    def recording(self, state, request):
        replayed.append(threading.current_thread().name)
        return replay_alone(self, state, request)

    executor.DeviceExecutor._replay_alone = recording
    try:
        reference, _ = row_vectors(feat_p.transform(df_p).collect())
        replayed.clear()
        with resilience.FaultInjector.seeded(
                0, device_oom=resilience.Fault(
                    times=1, when=lambda c: threading.current_thread().name
                    .startswith("sparkdl-exec"))) as inj_w, \
                health.HealthMonitor("oom_window") as mon_w:
            split, _ = row_vectors(feat_p.transform(df_p).collect())
    finally:
        executor.DeviceExecutor._replay_alone = replay_alone
    assert inj_w.fired["device_oom"] == 1, "no coalesced window formed"
    (window,) = mon_w.events(health.OOM_RECHUNK)
    assert mon_w.count(health.TASK_FAILED) == 0, mon_w.counters()
    assert len(replayed) >= window["requests"] >= 2, (replayed, window)
    assert all(n.startswith("sparkdl-part") for n in replayed), replayed
    ra, rb = torch.from_numpy(reference), torch.from_numpy(split)
    window_diff = float((ra - rb).abs().max())
    assert window_diff <= BF16_REL * float(ra.abs().max()), window_diff

    # a real allocation failure, then a replay of a captured graph
    chunk = torch.from_numpy(np.stack(images[:BATCH])).pin_memory()
    with torch.inference_mode():
        before = compiled(chunk, BATCH)
        try:
            torch.empty(1 << 45, dtype=torch.uint8, device=dev)
            raise AssertionError("a 32 TiB allocation succeeded")
        except torch.OutOfMemoryError as e:
            real_kind = resilience.classify(e)
            real_error = str(e).splitlines()[0][:160]
        after = compiled(chunk, BATCH)
        torch.cuda.synchronize()
    assert real_kind == resilience.OOM, real_kind
    survived = bool(torch.equal(before, after))
    assert survived, "a replay after the failed allocation differs"
    out = {"phase": "oom_rechunk", "images": len(images),
           "batch_size": BATCH, "injected_at_bucket": BATCH,
           "rechunk_event": event, "rungs_before": rungs_before,
           "rungs_after": rungs_after,
           "torch_equal_vs_uninjected": bool(torch.equal(a, b)),
           "max_abs_diff_vs_uninjected": diff, "tolerance": limit,
           "launches": injected_launches,
           "launches_by_body": injected_by_body,
           "window_event": window, "window_requests_replayed": len(replayed),
           "window_replay_threads": sorted(set(replayed)),
           "window_torch_equal": bool(torch.equal(ra, rb)),
           "window_max_abs_diff": window_diff,
           "window_health": mon_w.counters(),
           "real_oom_classified": real_kind, "real_oom_error": real_error,
           "replay_equal_after_real_oom": survived}
    emit(out)
    return out


# (phase, (model, path), source size, tolerance, precision), under
# "autotune": bf16 (the default) auditions nothing, as in the reference;
# float32 exercises the gate on the card
#: the files phases: seeded images written as files, read back through
#: readImages and featurized by Xception on PARTITION threads
FILES_IMAGES = 64
FILES_PARTITIONS = 4
FILES_QUALITY = 90
FILES_SOURCE = (256, 256)       # upscaled to 299×299 on the card
FILES_HOST_SOURCE = (384, 384)  # downscaled to 299×299 on the host
POOL_WORKERS = 4
#: the share of rows decode_faults drops with an injected decode_error
FAULT_RATE = 0.1


def png_bytes(arr) -> bytes:
    """A PNG of an HWC uint8 array, written with the standard library
    alone (zlib, struct): the files phases' encoder where Pillow is
    missing."""
    import struct
    import zlib

    h, w, c = arr.shape

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))
    color = {1: 0, 3: 2, 4: 6}[c]
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0,
                                         0))
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def write_files(root, size, seed, classes: int = 0) -> str:
    """FILES_IMAGES seeded photo-like images of ``size`` (soft-edged colour
    blocks with a little noise, which compress about as photos do, where
    uniform noise would not) written under ``root`` as JPEGs of quality
    FILES_QUALITY, or as PNGs where Pillow is missing; returns the format
    written. With ``classes``, image ``i`` is of class ``i % classes``:
    its blocks span 0-99 and its channel ``i % classes`` is brightened by
    150 (the flagship example's two-class set, photo-like)."""
    try:
        from PIL import Image
    except ImportError:
        Image = None
    rng = np.random.default_rng(seed)
    h, w = size
    for i in range(FILES_IMAGES):
        coarse = rng.integers(0, 256, (-(-h // 32), -(-w // 32), 3),
                              dtype=np.uint8)
        field = np.repeat(np.repeat(coarse, 32, axis=0), 32,
                          axis=1)[:h, :w]
        # a 3-tap blur along each axis softens the blocks' edges
        for axis in (0, 1):
            field = (np.roll(field, 1, axis).astype(np.uint16) + 2 * field
                     + np.roll(field, -1, axis)) // 4
        arr = np.clip(field + rng.integers(-1, 2, field.shape), 0,
                      255).astype(np.uint8)
        if classes:
            arr = (arr.astype(np.uint16) * 100 // 256).astype(np.uint8)
            arr[..., i % classes] += 150
        if Image is not None:
            Image.fromarray(arr).save(os.path.join(root, f"img_{i:03d}.jpg"),
                                      quality=FILES_QUALITY)
        else:
            with open(os.path.join(root, f"img_{i:03d}.png"), "wb") as f:
                f.write(png_bytes(arr))
    return "jpeg" if Image is not None else "png (stdlib encoder: no Pillow)"


def loader_headers() -> dict:
    """Whether the host's g++ finds each header the native loader
    includes."""
    import shutil

    if shutil.which("g++") is None:
        return {"jpeglib.h": False, "png.h": False, "g++": False}
    found = {}
    for header in ("jpeglib.h", "png.h"):
        proc = subprocess.run(["g++", "-E", "-x", "c++", "-"],
                              input=f"#include <{header}>\n",
                              capture_output=True, text=True, timeout=60)
        found[header] = proc.returncode == 0
    return found


def decoder_info() -> dict:
    """Which decoder serves readImages here: the native loader (with the
    threads each of its batch calls starts) or Pillow, and why."""
    from sparkdl_tpu_torch.native import loader

    if loader.available():
        return {"decoder": "native",
                "native_threads_per_call": os.cpu_count()}
    return {"decoder": "pil", "why_not_native": loader.unavailable_reason}


def shm_info() -> dict:
    """/dev/shm's size and free bytes (the decode pool returns pixels
    through it)."""
    st = os.statvfs("/dev/shm")
    return {"shm_total_bytes": st.f_blocks * st.f_frsize,
            "shm_free_bytes": st.f_bavail * st.f_frsize}


def pool_workers(shm_free: int, size) -> int:
    """POOL_WORKERS, or fewer where /dev/shm cannot hold 2 × workers
    chunks of 32 decoded images of ``size`` in flight."""
    chunk = 32 * size[0] * size[1] * 3
    return max(1, min(POOL_WORKERS, shm_free // (2 * chunk) // 2))


def row_pixels(rows) -> dict:
    """Each row's decoded pixels by file path (None for a null image)."""
    from sparkdl_tpu_torch.image import imageIO

    return {r["filePath"]: None if r["image"] is None
            else imageIO.imageStructToArray(r["image"]) for r in rows}


def row_features(rows) -> dict:
    """Each row's features by file path (None for a null image)."""
    return {r["filePath"]: None if r["features"] is None
            else np.asarray(r["features"], np.float32) for r in rows}


def pool_processes(pool) -> dict:
    """The decode pool's worker processes: pids, resident MiB, whether
    each maps libtorch or the CUDA driver, and the processes that
    ``nvidia-smi`` lists on the card."""
    def maps(pid):
        with open(f"/proc/{pid}/maps") as f:
            return f.read()

    def rss_mib(pid):
        with open(f"/proc/{pid}/status") as f:
            line = next(ln for ln in f if ln.startswith("VmRSS:"))
        return int(line.split()[1]) / 1024

    pids = [w.proc.pid for w in pool._workers]
    smi = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.split()
    return {"worker_pids": pids,
            "worker_rss_mib": [rss_mib(p) for p in pids],
            "workers_map_libtorch": any("libtorch" in maps(p) for p in pids),
            "workers_map_libcuda": any("libcuda" in maps(p) for p in pids),
            "card_processes": [int(p) for p in smi], "parent_pid": os.getpid()}


def files_pass(s, kernels, name, feat, df, compiled, per_forward, body):
    """One warm-up and one counted pass of ``feat`` over a readImages
    frame (its decode included), then one profiled pass: the counted
    pass's rows and its line, with images/s, the decode and device
    timers per partition and the device's idle share."""
    t0 = time.perf_counter()
    feat.transform(df).collect()
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    rows, out = partitioned_pass(s, kernels, name, feat, df, compiled,
                                 per_forward, body=body)
    stats = out["phase_stats"]
    parts = df.numPartitions
    decode = stats["sparkdl.decode"]
    apply = stats["sparkdl.device_apply"]
    out.update({
        "phase": name, "images": len(rows), "partitions": parts,
        "workers": WORKERS, "warmup_s": warmup_s,
        "decode_ms_per_partition": decode["total_s"] * 1e3 / decode["count"],
        "decode_ms_per_image": decode["total_s"] * 1e3 / len(rows),
        # one partition's decode against the pass's wall: the partitions
        # decode at once on their threads
        "decode_share_of_wall": decode["total_s"] / decode["count"]
        / out["seconds"],
        "device_apply_ms_per_partition": apply["total_s"] * 1e3
        / apply["count"],
        "idle_share": profile_pass(name, feat, df),
        **decoder_info()})
    return rows, out


def files_path(s, kernels):
    """Image files → ``readImages`` → ``DeepImageFeaturizer("Xception")``
    on the card, under ``"force"`` in bf16, on WORKERS partition threads:

    - ``files_featurize``: FILES_IMAGES 256×256 JPEGs in
      FILES_PARTITIONS partitions, decoded inline (``decode_workers=0``),
      ``preproc_resize`` once a forward (the upscale to 299×299 stays on
      the card), so the network runs in float32 (``sep2d``'s
      ``simt_f32``); every row against the port's CPU run of the same
      files (float32 tolerance), every decoded image ``np.array_equal``
      to the row decode of its file;
    - ``files_featurize_pool``: the same files through the decode pool
      (POOL_WORKERS spawned workers, fewer if /dev/shm is small): pixels
      ``np.array_equal`` to ``files_featurize``'s, features within its
      tolerance of them; the pool's instruments; the workers map no
      libtorch and no CUDA driver, and after ``shutdown()`` no worker
      and no ``sdlshm_`` segment is left;
    - ``files_host_resize``: FILES_IMAGES 384×384 JPEGs with
      ``fused_preprocess=False``: the host resizes to 299×299 (the native
      loader's ``sdl_resize_batch``, numpy without it) and Xception runs
      in bf16 (``sep2d``'s tensor-core body, no ``preproc_resize``); four
      rows against the port's CPU run of the same path;
    - ``decode_faults``: the pool phase's files and two corrupt ones in
      one partition, ``decode_error`` armed at a seeded FAULT_RATE, once
      with the pool on (and one ``decode_pool_worker_crash``) and once
      off: the same null rows and ``decode_degraded`` counts, one
      respawn, and every other row's pixels equal to
      ``files_featurize_pool``'s and its features within tolerance.

    Returns each phase's line, by phase."""
    import random
    import shutil

    from sparkdl_tpu_torch.core import decode_pool, health, resilience
    from sparkdl_tpu_torch.image import imageIO

    s.EngineConfig.inference_precision = "bfloat16"
    s.EngineConfig.device = "cuda"
    s.EngineConfig.pallas_kernels = "force"
    s.EngineConfig.max_workers = WORKERS
    s.EngineConfig.coalesce = True
    s.EngineConfig.decode_workers = 0
    dev = torch.device("cuda")
    root = tempfile.mkdtemp(prefix="sparkdl_files_")
    phases = {}
    try:
        small, large = os.path.join(root, "256"), os.path.join(root, "384")
        os.mkdir(small)
        os.mkdir(large)
        t0 = time.perf_counter()
        encoding = write_files(small, FILES_SOURCE, SEED + 300)
        write_files(large, FILES_HOST_SOURCE, SEED + 301)
        write_s = time.perf_counter() - t0
        shm = shm_info()
        workers = pool_workers(shm["shm_free_bytes"], FILES_HOST_SOURCE)
        emit({"phase": "files_setup", "root": root, "files": 2 * FILES_IMAGES,
              "encoding": encoding, "quality": FILES_QUALITY,
              "bytes_256": sum(os.path.getsize(os.path.join(small, f))
                               for f in os.listdir(small)),
              "write_s": write_s, "cpu_count": os.cpu_count(),
              "partition_threads": WORKERS, "pool_workers": workers,
              **shm, **decoder_info()})

        # files_featurize: inline decode
        feat = s.DeepImageFeaturizer(inputCol="image", outputCol="features",
                                     modelName="Xception", weights="random",
                                     batchSize=BATCH)
        df = s.readImages(small, numPartition=FILES_PARTITIONS)
        compiled = executed_model(s, feat, FILES_SOURCE).jitted(dev)
        per_forward = {"sep2d": 34, "preproc_resize": 1}
        rows, out = files_pass(s, kernels, "files_featurize", feat, df,
                               compiled, per_forward, "simt_f32")
        pixels, feats = row_pixels(rows), row_features(rows)
        files = sorted(pixels)
        assert len(files) == FILES_IMAGES and all(
            pixels[f] is not None for f in files)
        for f in files:
            assert np.array_equal(pixels[f], imageIO.decodeImageFile(f)), f
        s.EngineConfig.device = "cpu"
        s.EngineConfig.max_workers = 1
        t0 = time.perf_counter()
        cpu_feat = s.DeepImageFeaturizer(
            inputCol="image", outputCol="features", modelName="Xception",
            weights=model_state(s, feat), batchSize=BATCH)
        cpu = row_features(cpu_feat.transform(
            s.readImages(small, numPartition=FILES_PARTITIONS)).collect())
        cpu_s = time.perf_counter() - t0
        s.EngineConfig.device = "cuda"
        s.EngineConfig.max_workers = WORKERS
        limit = F32_REL * max(float(np.abs(v).max()) for v in cpu.values())
        err = max(float(np.abs(feats[f] - cpu[f]).max()) for f in files)
        assert err <= limit, f"files_featurize: {err} > {limit} vs the CPU"
        out.update({"max_abs_err_vs_cpu": err, "rows_vs_cpu": len(files),
                    "tolerance": limit, "cpu_run_s": cpu_s,
                    "pixels_equal_row_decode": True})
        emit(out)
        phases["files_featurize"] = out

        # files_featurize_pool: the same files through the decode pool
        s.EngineConfig.decode_workers = workers
        t0 = time.perf_counter()
        pool = decode_pool.maybe_pool()
        pool.decode(imageIO._read_blobs(files[:2]))
        pool_start_s = time.perf_counter() - t0
        rows, out = files_pass(s, kernels, "files_featurize_pool", feat, df,
                               compiled, per_forward, "simt_f32")
        procs = pool_processes(pool)
        # the same 64 decodes alone on this thread, no partition threads
        # around: the pool's round trips against the inline loop
        blobs = imageIO._read_blobs(files)
        alone = {}
        for label, fn in (("inline", lambda: [imageIO.decodePoolBlob(b)
                                              for b in blobs]),
                          ("pool", lambda: pool.decode(blobs))):
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                fn()
                times.append(time.perf_counter() - t0)
            alone[f"{label}_ms"] = sorted(times)[1] * 1e3
        pool_pixels, pool_feats = row_pixels(rows), row_features(rows)
        assert sorted(pool_pixels) == files
        assert all(np.array_equal(pool_pixels[f], pixels[f]) for f in files)
        pool_err = max(float(np.abs(pool_feats[f] - feats[f]).max())
                       for f in files)
        assert pool_err <= limit, f"files_featurize_pool: {pool_err}"
        assert pool.respawns == 0, pool.respawns
        assert not procs["workers_map_libcuda"], procs
        assert not any(p in procs["card_processes"]
                       for p in procs["worker_pids"]), procs
        assert len(procs["card_processes"]) <= 1, procs
        assert out["decode_pool"]["chunk_spans_adopted"] > 0, out
        decode_pool.shutdown()
        left = [n for n in os.listdir("/dev/shm") if n.startswith(
            f"sdlshm_{os.getpid():x}_")]
        alive = [p for p in procs["worker_pids"]
                 if os.path.exists(f"/proc/{p}")
                 and open(f"/proc/{p}/stat").read().split()[2] != "Z"]
        assert not left and not alive, (left, alive)
        out.update({"pool_workers": workers, "pool_start_s": pool_start_s,
                    "decode_alone_64": alone,
                    "switch_interval_s": sys.getswitchinterval(),
                    "respawns": pool.respawns, **procs,
                    "pixels_equal_inline": True,
                    "max_abs_diff_vs_inline": pool_err, "tolerance": limit,
                    "segments_left": left, "workers_alive": alive})
        emit(out)
        phases["files_featurize_pool"] = out

        # decode_faults: two corrupt files, decode_error at a seeded
        # rate, and one worker crash with the pool on
        for i in range(2):
            with open(os.path.join(small, f"img_zz_bad_{i}.jpg"), "wb") as f:
                f.write(b"\xff\xd8\xff" + bytes(64 * (i + 1)))
        faulty = s.readImages(small, numPartition=1)
        runs = {}
        for on in (True, False):
            s.EngineConfig.decode_workers = workers if on else 0
            draws = random.Random(SEED + 17)
            faults = {"decode_error": resilience.Fault(
                times=-1, when=lambda ctx: draws.random() < FAULT_RATE)}
            if on:
                faults["decode_pool_worker_crash"] = 1
            kernels.reset_launches()
            with resilience.FaultInjector.seeded(SEED, **faults) as inj, \
                    health.HealthMonitor("decode_faults") as monitor:
                t0 = time.perf_counter()
                got = feat.transform(faulty).collect()
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
            runs[on] = {"rows": got, "fired": dict(inj.fired),
                        "seconds": seconds, "health": monitor.counters(),
                        "launches": dict(kernels.launches),
                        "launches_by_body": {
                            k: dict(v)
                            for k, v in kernels.launches_by_body.items()}}
        decode_pool.shutdown()
        on, off = runs[True], runs[False]
        nulls = {k: sorted(r["filePath"] for r in run["rows"]
                           if r["image"] is None) for k, run in runs.items()}
        degraded = {k: run["health"].get(health.DECODE_DEGRADED, 0)
                    for k, run in runs.items()}
        assert nulls[True] == nulls[False], nulls
        assert degraded[True] == degraded[False] == len(nulls[True]), \
            degraded
        assert on["fired"]["decode_error"] == off["fired"]["decode_error"]
        assert on["fired"]["decode_pool_worker_crash"] == 1
        assert on["health"].get(health.DECODE_POOL_RESPAWN, 0) == 1, on
        bad = [f for f in nulls[True] if "zz_bad" in f]
        assert len(bad) == 2, nulls
        kept = [f for f in files if f not in nulls[True]]
        fault_err = 0.0
        for run in runs.values():
            px, ft = row_pixels(run["rows"]), row_features(run["rows"])
            assert all(np.array_equal(px[f], pool_pixels[f]) for f in kept)
            fault_err = max(fault_err, max(
                float(np.abs(ft[f] - pool_feats[f]).max()) for f in kept))
        assert fault_err <= limit, f"decode_faults: {fault_err} > {limit}"
        out = {"phase": "decode_faults", "files": len(on["rows"]),
               **decoder_info(),
               "corrupt": 2, "fault_rate": FAULT_RATE,
               "decode_error_fired": on["fired"]["decode_error"],
               "null_rows": len(nulls[True]),
               "decode_degraded": degraded,
               "respawns": on["health"].get(health.DECODE_POOL_RESPAWN, 0),
               "seconds": {"pool_on": on["seconds"],
                           "pool_off": off["seconds"]},
               "max_abs_diff_vs_pool_phase": fault_err, "tolerance": limit,
               "launches": {k: on["launches"].get(k, 0)
                            + off["launches"].get(k, 0)
                            for k in on["launches"]},
               "launches_by_body": {
                   k: {b: n + off["launches_by_body"][k][b]
                       for b, n in v.items()}
                   for k, v in on["launches_by_body"].items()},
               "health": {"pool_on": on["health"],
                          "pool_off": off["health"]}}
        emit(out)
        phases["decode_faults"] = out

        # files_host_resize: 384×384 files, resized on the host
        s.EngineConfig.decode_workers = 0
        s.EngineConfig.fused_preprocess = False
        df = s.readImages(large, numPartition=FILES_PARTITIONS)
        compiled = executed_model(s, feat, TARGET).jitted(dev)
        rows, out = files_pass(s, kernels, "files_host_resize", feat, df,
                               compiled, {"sep2d": 34}, "wgmma")
        assert out["launches"]["preproc_resize"] == 0, out["launches"]
        host = out["phase_stats"]["sparkdl.host_resize"]
        gpu = {os.path.basename(f): v for f, v in row_features(rows).items()}
        few = os.path.join(root, "384_few")
        os.mkdir(few)
        for name in sorted(gpu)[:4]:
            os.link(os.path.join(large, name), os.path.join(few, name))
        s.EngineConfig.device = "cpu"
        s.EngineConfig.max_workers = 1
        cpu = {os.path.basename(f): v for f, v in row_features(
            cpu_feat.transform(s.readImages(few)).collect()).items()}
        s.EngineConfig.device = "cuda"
        s.EngineConfig.max_workers = WORKERS
        limit = BF16_REL * max(float(np.abs(v).max()) for v in cpu.values())
        err = max(float(np.abs(gpu[f] - cpu[f]).max()) for f in cpu)
        assert err <= limit, f"files_host_resize: {err} > {limit}"
        from sparkdl_tpu_torch.native import loader

        out.update({"host_resize_ms_per_partition": host["total_s"] * 1e3
                    / host["count"],
                    "host_resizer": "sdl_resize_batch" if loader.available()
                    else "resizeBatchArray (numpy)",
                    "max_abs_err_vs_cpu": err, "rows_vs_cpu": len(cpu),
                    "tolerance": limit})
        emit(out)
        phases["files_host_resize"] = out
    finally:
        s.EngineConfig.fused_preprocess = True
        s.EngineConfig.decode_workers = 0
        s.EngineConfig.device = "cuda"
        decode_pool.shutdown()
        shutil.rmtree(root, ignore_errors=True)
    return phases


#: the flagship workflow's fit (examples/flagship_pipeline.py)
LR_MAX_ITER = 100
LR_REG = 0.01
#: The card's fit against the port's CPU fit of the same rows: the
#: objective (evaluated once, on the CPU) within OBJ_REL, and the
#: predictions equal (lr_fit_scale: on AGREE of the rows).
#: lr_fit_scale's 16,384 rows determine the solution, which both fits
#: reach before the iteration cap: its parameters in the space the
#: solve ran in (the coefficients scaled by each feature's std, and the
#: intercepts) are held as one vector to PARAM_REL of its max|cpu|, the
#: float32 slice tolerance. The flagship's 48 rows of 2048 features do
#: not determine them: most directions are the 0.01 penalty's alone,
#: both fits stop at the 100-iteration cap with the gradient above
#: ``tol``, and two float32 runs that sum in other orders drift apart
#: along those flat directions. Its fit is held where it is well posed,
#: by the objective, the test probabilities within PROB_ABS and the
#: predictions; its coefficients and intercepts are printed, not held.
OBJ_REL = 1e-4
PARAM_REL = 1e-3
PROB_ABS = 1e-3
AGREE = 0.999
#: lr_fit_scale: Xception's feature width over a 16k-image set
SCALE_ROWS, SCALE_DIM, SCALE_CLASSES = 16384, 2048, 10
SCALE_CENTER = 0.04      # class centres' scale against unit noise


def launch_counts(kernels) -> tuple:
    return (dict(kernels.launches),
            {k: dict(v) for k, v in kernels.launches_by_body.items()})


def compare_fits(card, cpu, x, y) -> dict:
    """The card's and the CPU's ``LogisticRegressionModel`` over the same
    rows ``x``, ``y``: each objective (evaluated on the CPU, in the
    standardized space the fits solved in) and their relative
    difference; the parameters' max|Δ| in that space, the coefficients'
    and the intercepts' apart and together, and the CPU's max|param|
    there; the coefficients' max|Δ| on the original scale; both
    iteration counts. Asserts nothing."""
    from sparkdl_tpu_torch.ml.classification import SoftmaxObjective
    from sparkdl_tpu_torch.ml.linear_utils import weighted_feature_std

    std = weighted_feature_std(x, None).astype(np.float32)
    objective = SoftmaxObjective(torch.from_numpy(x / std),
                                 torch.from_numpy(np.asarray(y)),
                                 card.numClasses, LR_REG, True)

    def params(m):
        return np.concatenate([(m.coefficients * std[:, None]).reshape(-1),
                               m.intercept])

    def value(m):
        return float(objective(torch.from_numpy(params(m)))[0])

    obj = {"card": value(card), "cpu": value(cpu)}
    n_coef = card.coefficients.size
    delta = np.abs(params(card) - params(cpu))
    return {
        "objective": obj,
        "objective_rel_diff": abs(obj["card"] - obj["cpu"]) / abs(obj["cpu"]),
        "objective_tolerance": OBJ_REL,
        "coef_scaled_max_abs_err": float(delta[:n_coef].max()),
        "intercept_max_abs_err": float(delta[n_coef:].max()),
        "param_scaled_max_abs_err": float(delta.max()),
        "param_scaled_max_abs": float(np.abs(params(cpu)).max()),
        "coef_max_abs_err_original_scale": float(np.abs(
            card.coefficients - cpu.coefficients).max()),
        "coef_max_abs_original_scale": float(np.abs(cpu.coefficients).max()),
        "intercept_max_abs": float(np.abs(cpu.intercept).max()),
        "iterations": {"card": card.numIterations,
                       "cpu": cpu.numIterations}}


def check_fits(name, cmp, held) -> None:
    for err, tol in held:
        assert cmp[err] <= cmp[tol], f"{name}: {err} over {tol}: {cmp}"


OBJECTIVE_HELD = ("objective_rel_diff", "objective_tolerance")
PARAMS_HELD = ("param_scaled_max_abs_err", "param_scaled_tolerance")


def flagship_path(s, kernels):
    """The reference's flagship workflow (``examples/flagship_pipeline.py``)
    on the card, Xception under ``"force"`` in bf16 on WORKERS partition
    threads:

    - FILES_IMAGES 299×299 JPEGs in two classes (class c brightens
      channel c) → ``readImages(dir, numPartition=4)`` → a ``label``
      column by ``withColumn`` → ``randomSplit([0.75, 0.25], seed=0)``;
    - ``Pipeline([DeepImageFeaturizer("Xception", batchSize=16),
      LogisticRegression(maxIter=100, regParam=0.01)]).fit(train)``: the
      features, then L-BFGS on the card, held to the port's CPU fit of
      the very features the card's fit collected: its objective within
      OBJ_REL, its test probabilities within PROB_ABS and its
      predictions equal;
    - ``transform`` of test and train, ``MulticlassClassificationEvaluator``
      accuracy and f1 on each;
    - ``save`` → ``load`` → ``transform(test)``: probabilities
      ``np.array_equal`` to the original model's (both with
      ``coalesce=False``, so each partition is its own chunk);
    - ``registerImageUDF("featurize", <the featurizer's model function>)``
      and ``sql("SELECT featurize(image) AS features, label FROM images
      WHERE label = 1")``: exactly the label-1 rows, their features
      within BF16_REL of the featurizer's.

    Every ``sep2d`` launch is the tensor-core body, 34 a forward."""
    import shutil

    from sparkdl_tpu_torch.core import profiling
    from sparkdl_tpu_torch.engine import dataframe as engine
    from sparkdl_tpu_torch.udf import udf_registry

    s.EngineConfig.inference_precision = "bfloat16"
    s.EngineConfig.device = "cuda"
    s.EngineConfig.pallas_kernels = "force"
    s.EngineConfig.max_workers = WORKERS
    s.EngineConfig.coalesce = True
    s.EngineConfig.decode_workers = 0
    dev = torch.device("cuda")
    root = tempfile.mkdtemp(prefix="sparkdl_flagship_")
    try:
        images = os.path.join(root, "images")
        os.mkdir(images)
        write_files(images, TARGET, SEED + 400, classes=2)
        df = s.readImages(images, numPartition=FILES_PARTITIONS).withColumn(
            "label", lambda path: int(os.path.basename(path)[4:7]) % 2,
            inputCols=["filePath"])
        t0 = time.perf_counter()
        train, test = df.randomSplit([0.75, 0.25], seed=SEED)
        split_s = time.perf_counter() - t0
        feat = s.DeepImageFeaturizer(inputCol="image", outputCol="features",
                                     modelName="Xception", batchSize=BATCH)
        lr = s.LogisticRegression(maxIter=LR_MAX_ITER, regParam=LR_REG)
        # keep what the fit collected, to fit the same rows on the CPU
        seen = {}
        collect_xy = lr._collect_xy

        def keep(dataset):
            seen["xy"] = collect_xy(dataset)
            return seen["xy"]

        lr._collect_xy = keep
        compiled = executed_model(s, feat, TARGET).jitted(dev)
        replays = compiled.replays
        kernels.reset_launches()
        profiling.reset_phase_stats()
        t0 = time.perf_counter()
        model = s.Pipeline(stages=[feat, lr]).fit(train)
        fit_s = time.perf_counter() - t0
        fitted = model.stages[1]
        stats = fitted.fitStats
        assert stats["device"].startswith("cuda"), stats
        scored, rates = {}, {}
        for name, frame in (("test", test), ("train", train)):
            t0 = time.perf_counter()
            scored[name] = model.transform(frame).cache()
            rows = scored[name].count()
            rates[name] = rows / (time.perf_counter() - t0)
        evaluation = {
            metric: {name: s.MulticlassClassificationEvaluator(
                metricName=metric).evaluate(frame)
                for name, frame in scored.items()}
            for metric in ("accuracy", "f1")}
        test_rows = scored["test"].collect()
        train_rows = scored["train"].collect()

        # the same features fit on the CPU
        x, y, _, _ = seen["xy"]
        s.EngineConfig.device = "cpu"
        t0 = time.perf_counter()
        cpu = s.LogisticRegression(maxIter=LR_MAX_ITER, regParam=LR_REG).fit(
            s.DataFrame.fromColumns({"features": x, "label": y.tolist()}))
        cpu_fit_s = time.perf_counter() - t0
        test_feats = np.stack([np.asarray(r["features"], np.float32)
                               for r in test_rows])
        cpu_rows = cpu.transform(s.DataFrame.fromColumns(
            {"features": test_feats})).collect()
        s.EngineConfig.device = "cuda"
        cmp = compare_fits(fitted, cpu, x, y)
        cmp["prob_max_abs_err"] = max(
            float(np.abs(np.asarray(a["probability"])
                         - np.asarray(b["probability"])).max())
            for a, b in zip(test_rows, cpu_rows))
        cmp["prob_tolerance"] = PROB_ABS
        cmp["predictions_equal"] = [r["prediction"] for r in test_rows] \
            == [r["prediction"] for r in cpu_rows]
        check_fits("flagship_pipeline", cmp, [OBJECTIVE_HELD])
        assert cmp["prob_max_abs_err"] <= PROB_ABS, cmp
        assert cmp["predictions_equal"], cmp

        # save -> load -> transform, each partition its own chunk
        s.EngineConfig.coalesce = False
        before = model.transform(test).collect()
        saved = os.path.join(root, "fitted_pipeline")
        t0 = time.perf_counter()
        model.save(saved)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = s.load(saved)
        loaded_compiled = executed_model(s, loaded.stages[0],
                                         TARGET).jitted(dev)
        load_s = time.perf_counter() - t0
        after = loaded.transform(test).collect()
        s.EngineConfig.coalesce = True
        assert all(np.array_equal(a["probability"], b["probability"])
                   and a["prediction"] == b["prediction"]
                   for a, b in zip(before, after)), "reload differs"

        # the model as a SQL UDF over a temp view
        s.registerImageUDF("featurize", feat._model_function("featurize"),
                           batchSize=BATCH)
        df.createOrReplaceTempView("images")
        t0 = time.perf_counter()
        served = s.sql("SELECT featurize(image) AS features, label "
                       "FROM images WHERE label = 1").collect()
        sql_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        counts, by_body = launch_counts(kernels)
        stats_all = profiling.phase_stats()
        udf_registry.unregister("featurize")
        engine._temp_views.pop("images", None)

        paths = [r["filePath"] for r in df.select("filePath", "label")
                 .collect() if r["label"] == 1]
        assert len(served) == len(paths) == FILES_IMAGES // 2, len(served)
        assert all(r["label"] == 1 for r in served)
        by_path = {r["filePath"]: np.asarray(r["features"], np.float32)
                   for r in train_rows + test_rows}
        ref = np.stack([by_path[p] for p in paths])
        got = np.stack([np.asarray(r["features"], np.float32)
                        for r in served])
        sql_err = float(np.abs(got - ref).max())
        sql_tol = BF16_REL * float(np.abs(ref).max())
        assert sql_err <= sql_tol, f"sql features {sql_err} > {sql_tol}"

        forwards = (compiled.replays - replays) + loaded_compiled.replays
        captures = stats_all.get("sparkdl.compile", {"count": 0})["count"]
        expected = {k: (34 if k == "sep2d" else 0) * (forwards + captures)
                    for k in counts}
        assert counts == expected, f"launches {counts} != {expected}"
        assert by_body["sep2d"]["wgmma"] == counts["sep2d"] > 0, by_body
        iters = fitted.numIterations
        out = {"phase": "flagship_pipeline", "files": FILES_IMAGES,
               "size": list(TARGET), "partitions": FILES_PARTITIONS,
               "workers": WORKERS, "train_rows": train.count(),
               "test_rows": test.count(), "split_s": split_s,
               "fit_s": fit_s, "fit_featurize_s": stats["collect_s"],
               "fit_lbfgs_s": stats["fit_s"], "iterations": iters,
               "ms_per_iteration": stats["fit_s"] * 1e3 / iters,
               "linesearch_steps": stats["linesearch_steps"],
               "evaluations": stats["evaluations"],
               "host_syncs": stats["syncs"],
               "host_syncs_per_iteration": stats["syncs"] / iters,
               "transform_images_per_s": rates, "evaluation": evaluation,
               "cpu_fit_s": cpu_fit_s, "vs_cpu_fit": cmp,
               "save_s": save_s, "load_s": load_s,
               "reload_probabilities_equal": True,
               "sql_rows": len(served), "sql_s": sql_s,
               "sql_max_abs_err": sql_err, "sql_tolerance": sql_tol,
               "forwards": forwards, "captures": captures,
               "launches": counts, "launches_by_body": by_body}
        emit(out)
        return {"flagship_pipeline": out}
    finally:
        s.EngineConfig.coalesce = True
        s.EngineConfig.device = "cuda"
        shutil.rmtree(root, ignore_errors=True)


def lr_fit_scale(s, kernels):
    """The classifier a user trains after featurizing a 16k-image set:
    SCALE_ROWS × SCALE_DIM float32 features (Xception's width) in
    SCALE_CLASSES seeded Gaussian classes, one frame with a 2-D feature
    column, ``LogisticRegression(maxIter=100, regParam=0.01)`` on the card
    (after a 2-iteration warm-up fit) and on the CPU, held to each other
    by ``compare_fits`` (the objective within OBJ_REL, the parameters
    within PARAM_REL, predictions alike on AGREE of the rows). With
    ``--profile``, the idle share is ``fit_softmax``'s alone (upload,
    L-BFGS, download: what ``fitStats["fit_s"]`` times), without the
    collect."""
    s.EngineConfig.device = "cuda"
    rng = np.random.default_rng(SEED + 500)
    t0 = time.perf_counter()
    y = rng.integers(0, SCALE_CLASSES, SCALE_ROWS)
    centers = SCALE_CENTER * rng.standard_normal(
        (SCALE_CLASSES, SCALE_DIM), dtype=np.float32)
    x = rng.standard_normal((SCALE_ROWS, SCALE_DIM), dtype=np.float32)
    x += centers[y]
    gen_s = time.perf_counter() - t0
    df = s.DataFrame.fromColumns({"features": x, "label": y},
                                 numPartitions=8)
    lr = s.LogisticRegression(maxIter=LR_MAX_ITER, regParam=LR_REG)
    kernels.reset_launches()
    lr.copy({lr.maxIter: 2}).fit(df)  # warm-up: cuBLAS, allocator
    t0 = time.perf_counter()
    gpu = lr.fit(df)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts, by_body = launch_counts(kernels)
    stats = gpu.fitStats
    assert stats["device"].startswith("cuda"), stats
    solve_idle = None
    if PROFILE:
        from sparkdl_tpu_torch.ml.classification import fit_softmax
        from sparkdl_tpu_torch.ml.linear_utils import weighted_feature_std

        std = weighted_feature_std(x, None).astype(np.float32)
        solve_idle = profiled(lambda: fit_softmax(
            x, y, SCALE_CLASSES, max_iter=LR_MAX_ITER, reg=LR_REG,
            tol=lr.getTol(), fit_intercept=True, feature_scale=std,
            device="cuda"))["idle_share"]
    s.EngineConfig.device = "cpu"
    t0 = time.perf_counter()
    cpu = lr.fit(df)
    cpu_s = time.perf_counter() - t0
    s.EngineConfig.device = "cuda"

    cmp = compare_fits(gpu, cpu, x, y)
    cmp["prediction_agreement"] = float(np.mean(
        np.argmax(x @ gpu.coefficients + gpu.intercept, axis=1)
        == np.argmax(x @ cpu.coefficients + cpu.intercept, axis=1)))
    cmp["agreement_floor"] = AGREE
    cmp["param_scaled_tolerance"] = PARAM_REL * cmp["param_scaled_max_abs"]
    check_fits("lr_fit_scale", cmp, [OBJECTIVE_HELD, PARAMS_HELD])
    assert cmp["prediction_agreement"] >= AGREE, cmp
    assert not any(counts.values()), counts
    iters = gpu.numIterations
    out = {"phase": "lr_fit_scale", "rows": SCALE_ROWS,
           "features": SCALE_DIM, "classes": SCALE_CLASSES,
           "feature_mib": x.nbytes / 2 ** 20, "gen_s": gen_s,
           "collect_ms": stats["collect_s"] * 1e3, "fit_s": stats["fit_s"],
           "wall_s": wall_s, "iterations": iters,
           "ms_per_iteration": stats["fit_s"] * 1e3 / iters,
           "linesearch_steps_per_iteration":
               stats["linesearch_steps"] / iters,
           "evaluations": stats["evaluations"],
           "host_syncs_per_iteration": stats["syncs"] / iters,
           "solve_idle_share": solve_idle, "cpu_fit_s": cpu_s,
           "cpu_collect_ms": cpu.fitStats["collect_s"] * 1e3,
           "vs_cpu_fit": cmp,
           "launches": counts, "launches_by_body": by_body}
    emit(out)
    return {"lr_fit_scale": out}


# -- the online serving plane -------------------------------------------------

SERVE_SEED = SEED + 300     # v1's weights; v2's are SERVE_SEED + 1
SERVE_BATCH = 16            # the deployment's batch size: rungs 8 and 16
SERVE_TARGET_MS = 250.0     # serving_predict's latency target
SERVE_CLIENTS = 8
SERVE_REQUESTS = 32         # single-row predicts a client sends
SERVE_ROWS = 32             # distinct 299×299 rows the clients draw from
SERVE_CPU_ROWS = 8          # rows held against the port's CPU run
SHADOW_FRACTION = 0.25
CUTOVER_AT, ROLLBACK_AT = 96, 192   # answered requests before each flip
RESIDENT_BATCH = 8          # the residency deployments' batch: rung 8
RESIDENT_SOURCE = (256, 256)        # resnet50's rows, resized to 224×224
# (model, served name, source size): the residency phase's deployments,
# and its requests by served name, chosen so that LRU evicts twice
# (vgg16 when resnet50 comes in, resnet50 when vgg16 comes back)
RESIDENTS = [("Xception", "xception", TARGET),
             ("VGG16", "vgg16", (224, 224)),
             ("ResNet50", "resnet50", RESIDENT_SOURCE)]
RESIDENT_ORDER = ["vgg16", "xception", "resnet50", "xception", "vgg16"]
SLO_WINDOW_S = 2.0
SLO_EXPORT_S = 0.25
SLO_HOLD_S = 0.5
SLO_CALIBRATE_S = 1.0       # unloaded clients before the flood
# The latency target: a bound of telemetry.DEFAULT_TIME_BOUNDS (the rule
# resolves no finer), the one between the unloaded request p99 (20-36 ms
# at this target's coalesce window) and the flood's admitted requests
# (p50 42-60 ms) on an H100 80GB HBM3 at 700 W
SLO_TARGET_MS = 51.2
SLO_ROOM = 1.25             # the target over the unloaded request p99, at least
SLO_FLOOD_S = 3.0
SLO_RECOVER_S = 5.5


def served_model(name, seed, source=None):
    """A deployment's loader: the registry's featurizer of ``name`` built
    in bf16 (``precision="bfloat16"``: a bf16 copy of the seeded weights,
    which the executor then runs as it is), behind ``resized(source)``
    where the rows are of another size."""
    from sparkdl_tpu_torch.models import registry

    def load():
        mf = registry.build_featurizer(name, seed=seed, precision="bfloat16")
        if source is not None and tuple(source) != \
                mf.input_spec.spatial_size():
            mf = mf.resized(source)
        return mf

    return load


def on_card(model) -> None:
    """No fallback: a served model whose weights are not on the card
    raises."""
    off = [n for n, t in model.variables.state_dict().items()
           if not t.is_cuda]
    if off:
        raise RuntimeError(f"{model.name}: weights off the card: {off[:3]}")


def bf16_weight_bytes(name) -> int:
    """``weight_bytes()`` of ``name``'s bf16 featurizer, from its module
    built on the meta device (no weights made)."""
    from sparkdl_tpu_torch.models import registry

    spec = registry.get_model_spec(name)
    kwargs = dict(spec.featurize_kwargs
                  or {"include_top": False, "pooling": "avg"})
    with torch.device("meta"):
        module = spec.builder(**kwargs, dtype=None)
    module = module.to(torch.bfloat16)
    return sum(t.nbytes for t in [*module.parameters(), *module.buffers()])


def serving_rows(size, n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, *size, 3),
                                                dtype=np.uint8)


def eager_rows(model, rows):
    """``model``'s eager forward of ``rows`` on the card, 16 at a time
    (a yardstick: the serving path replays graphs)."""
    dev = torch.device("cuda")
    outs = []
    with torch.inference_mode():
        for i in range(0, len(rows), 16):
            x = torch.from_numpy(rows[i:i + 16]).to(dev)
            outs.append(model(x.to(torch.float32)).float().cpu())
    return torch.cat(outs).numpy()


def held_rows(label, results, refs, tol_rel=BF16_REL) -> float:
    """Every ``(row index, output)`` of ``results`` against ``refs[row]``
    within ``tol_rel · max|refs|``; returns the largest error."""
    limit = tol_rel * float(np.abs(refs).max())
    worst = 0.0
    for idx, out in results:
        assert out.shape == refs[idx].shape and np.isfinite(out).all(), \
            f"{label}: row {idx} shape {out.shape}"
        err = float(np.abs(out - refs[idx]).max())
        assert err <= limit, f"{label}: row {idx} off by {err} > {limit}"
        worst = max(worst, err)
    return worst


def latency_ms(latencies) -> dict:
    lat = np.asarray(latencies, np.float64) * 1e3
    if not len(lat):
        return {"count": 0}
    return {"count": int(len(lat)), "p50": float(np.percentile(lat, 50)),
            "p99": float(np.percentile(lat, 99)), "max": float(lat.max())}


def run_clients(srv, name, rows, clients, requests, on_result=None,
                deadline_ms=None):
    """``clients`` threads, each sending ``requests`` single-row predicts
    of ``rows`` (client t's i-th request takes row (t·requests + i) mod
    len(rows)), each with ``deadline_ms``; returns ``[(client, i, row,
    result, t_done)]`` in answer order, and the seconds from the first
    send to the last answer. Any error in a client raises here."""
    import threading

    answers, errors = [], []
    lock = threading.Lock()
    barrier = threading.Barrier(clients, timeout=120)

    def client(t):
        try:
            barrier.wait()
            for i in range(requests):
                idx = (t * requests + i) % len(rows)
                res = srv.predict(name, rows[idx], deadline_ms=deadline_ms)
                with lock:
                    answers.append((t, i, idx, res, time.perf_counter()))
                    n = len(answers)
                if on_result is not None:
                    on_result(n)
        except BaseException as e:  # noqa: BLE001 - raised below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(t,))
               for t in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
        assert not t.is_alive(), "a serving client hung"
    if errors:
        raise errors[0]
    return answers, time.perf_counter() - t0


def serving_predict(s, kernels, reg, srv, rows):
    """Deploy ``xception``/``v1`` (Xception's featurizer in bf16, batch
    16, ``latency_target_ms=250``) under ``serving_warmup`` and
    ``"force"``, then 8 clients × 32 single-row predicts of 299×299 rows.
    Held: the warm-up captured every rung, the first request after it
    captures nothing, every answer against the eager forward of its row
    on the card, SERVE_CPU_ROWS rows against the port's CPU run of the
    same float32 weights, ``sep2d`` launches = 34 × forwards, all on the
    tensor-core body."""
    from sparkdl_tpu_torch.core import health, telemetry
    from sparkdl_tpu_torch.models import registry

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    with health.HealthMonitor("serving_deploy") as mon:
        dep = reg.deploy("xception", "v1",
                         loader=served_model("Xception", SERVE_SEED),
                         latency_target_ms=SERVE_TARGET_MS,
                         batch_size=SERVE_BATCH)
    deploy_s = time.perf_counter() - t0
    (warm,) = mon.events(health.WARMUP_COMPLETED)
    model = dep.model()
    on_card(model)
    compiled = model.jitted(dev)
    warm_graphs = sorted((k[0][0], str(k[1]).removeprefix("torch."))
                         for k in compiled.graphs)
    assert warm_graphs == [(8, "float32"), (8, "uint8"), (16, "float32"),
                           (16, "uint8")], warm_graphs
    eager = eager_rows(model, rows)
    kernels.reset_launches()
    before = dict(compiled.graphs)
    first = srv.predict("xception", rows[0])
    first_captures = len(set(compiled.graphs) - set(before))
    assert first_captures == 0, "the first request after warm-up captured"
    assert first.output.shape == (2048,) and first.version == "v1"

    kernels.reset_launches()
    replays = compiled.replays
    with health.HealthMonitor("serving_predict") as mon, \
            telemetry.Telemetry("serving_predict") as tel:
        answers, seconds = run_clients(srv, "xception", rows, SERVE_CLIENTS,
                                       SERVE_REQUESTS)
        torch.cuda.synchronize()
    counts, by_body = launch_counts(kernels)
    forwards = compiled.replays - replays
    n = SERVE_CLIENTS * SERVE_REQUESTS
    assert len(answers) == n
    assert {(t, i) for t, i, _, _, _ in answers} == \
        {(t, i) for t in range(SERVE_CLIENTS) for i in range(SERVE_REQUESTS)}
    assert counts == {"sep2d": 34 * forwards, "pw1x1": 0,
                      "preproc_resize": 0}, (counts, forwards)
    assert by_body["sep2d"]["wgmma"] == counts["sep2d"], by_body
    err = held_rows("serving_predict", [(idx, r.output)
                                        for _, _, idx, r, _ in answers],
                    eager)
    snap = tel.metrics.snapshot()["histograms"]
    req = snap[telemetry.M_SERVING_REQUEST_S]
    rows_h = snap.get(telemetry.M_COALESCE_ROWS)
    # the port's CPU run of the same (float32) weights
    s.EngineConfig.device = "cpu"
    cpu_model = registry.build_featurizer("Xception", seed=SERVE_SEED)
    with torch.inference_mode():
        cpu = cpu_model(torch.from_numpy(rows[:SERVE_CPU_ROWS]).float()
                        ).numpy()
    s.EngineConfig.device = "cuda"
    del cpu_model
    by_row = {idx: r.output for _, _, idx, r, _ in answers}
    cpu_err = float(max(np.abs(by_row[i] - cpu[i]).max()
                        for i in range(SERVE_CPU_ROWS)))
    cpu_tol = BF16_REL * float(np.abs(cpu).max())
    assert cpu_err <= cpu_tol, f"serving_predict: {cpu_err} > {cpu_tol}"
    # the card's idle share over a shorter load, profiled
    prof = profiled(lambda: run_clients(srv, "xception", rows,
                                        SERVE_CLIENTS, 8))
    kernels.reset_launches()
    out = {"phase": "serving_predict", "model": "Xception",
           "deploy_s": deploy_s, "warmup_s": warm["seconds"],
           "warmup_rungs": warm["rungs"],
           "warmup_graphs": [list(g) for g in warm_graphs],
           "first_request_captures": first_captures,
           "requests": n, "clients": SERVE_CLIENTS, "seconds": seconds,
           "requests_per_s": n / seconds,
           "request_s": {"p50": req["p50"], "p99": req["p99"],
                         "max": req["max"]},
           "request_ms_measured": latency_ms(
               [r.latency_s for _, _, _, r, _ in answers]),
           "forwards": forwards,
           "coalesced_windows": None if rows_h is None else rows_h["count"],
           "rows_per_coalesced_window": (None if rows_h is None
                                         else rows_h["sum"]
                                         / rows_h["count"]),
           "executor": executor_metrics(tel), "health": mon.counters(),
           "launches": counts, "launches_by_body": by_body,
           "sep2d_by_body": by_body["sep2d"],
           "max_abs_err_vs_eager": err, "eager_tolerance":
               BF16_REL * float(np.abs(eager).max()),
           "max_abs_err_vs_cpu": cpu_err, "cpu_tolerance": cpu_tol,
           "cpu_rows": SERVE_CPU_ROWS,
           "idle_share": prof["idle_share"],
           "profiled_wall_ms": prof["wall_ms"],
           "profiled_busy_ms": prof["device_busy_ms"],
           "graph_pool_mib": sum(g.pool_bytes for g in
                                 compiled.graphs.values()) / 2 ** 20}
    emit(out)
    return out, eager


def serving_hot_swap(s, kernels, reg, srv, rows, eager_v1):
    """Deploy ``v2`` (weights from another seed) dark, shadow a quarter of
    the traffic to it, and run 8 clients × 32 requests, cutting over to
    v2 after CUTOVER_AT answers and rolling back after ROLLBACK_AT.
    Held: every request answered exactly once, each answer against the
    eager forward of the version it names, the shadow comparisons those
    the accumulator dictates for the requests resolved before the
    cutover (every 4th), exactly 2 ``serving_cutover`` events."""
    import threading

    from sparkdl_tpu_torch.core import health, telemetry

    dev = torch.device("cuda")
    dep2 = reg.deploy("xception", "v2",
                      loader=served_model("Xception", SERVE_SEED + 1),
                      latency_target_ms=SERVE_TARGET_MS,
                      batch_size=SERVE_BATCH)
    v2 = dep2.model()
    on_card(v2)
    eager = {"v1": eager_v1, "v2": eager_rows(v2, rows)}
    reg.shadow("xception", "v2", fraction=SHADOW_FRACTION)
    # resolves and flips under one lock, so the count of requests
    # resolved before the cutover is exact
    flip = threading.Lock()
    resolved = [0]
    plain_resolve = reg.resolve

    def counted_resolve(name):
        with flip:
            resolved[0] += 1
            return plain_resolve(name)

    reg.resolve = counted_resolve
    marks = {}
    done = {"cutover": threading.Event(), "rollback": threading.Event()}

    def on_result(n):
        if n == CUTOVER_AT:
            with flip:
                marks["pre_cutover_resolves"] = resolved[0]
                marks["cutover_t"] = time.perf_counter()
                assert srv.cutover("xception", "v2") == "v1"
            done["cutover"].set()
        elif n == ROLLBACK_AT:
            done["cutover"].wait(60)
            marks["rollback_t"] = time.perf_counter()
            assert srv.rollback("xception") == "v2"
            done["rollback"].set()

    kernels.reset_launches()
    compiled = {v: d.model().jitted(dev)
                for v, d in (("v1", reg.deployment("xception", "v1")),
                             ("v2", dep2))}
    replays = {v: c.replays for v, c in compiled.items()}
    with health.HealthMonitor("serving_hot_swap") as mon, \
            telemetry.Telemetry("serving_hot_swap") as tel:
        t0 = time.perf_counter()
        answers, seconds = run_clients(srv, "xception", rows, SERVE_CLIENTS,
                                       SERVE_REQUESTS, on_result=on_result)
        torch.cuda.synchronize()
    reg.resolve = plain_resolve
    counts, by_body = launch_counts(kernels)
    n = SERVE_CLIENTS * SERVE_REQUESTS
    keys = [(t, i) for t, i, _, _, _ in answers]
    assert len(keys) == n and len(set(keys)) == n, "dropped or doubled"
    errs = {}
    for v in ("v1", "v2"):
        mine = [(idx, r.output) for _, _, idx, r, _ in answers
                if r.version == v]
        assert mine, f"no answer from {v}"
        errs[v] = held_rows(f"serving_hot_swap {v}", mine, eager[v])
    shadowed = sum(r.shadowed for _, _, _, r, _ in answers)
    compared = mon.count(health.SERVING_SHADOW_COMPARED)
    expected = int(marks["pre_cutover_resolves"] * SHADOW_FRACTION
                   + 1e-9)
    assert shadowed == compared == expected, \
        (shadowed, compared, marks["pre_cutover_resolves"])
    assert mon.count(health.SERVING_SHADOW_ERROR) == 0
    assert mon.count(health.SERVING_CUTOVER) == 2
    div = tel.metrics.snapshot()["histograms"][
        telemetry.M_SERVING_SHADOW_DIVERGENCE]
    assert div["count"] == compared and div["min"] > 0.0

    def segment(lo, hi):
        done_t = [t_done for _, _, _, _, t_done in answers
                  if lo <= t_done < hi]
        lat = [r.latency_s for _, _, _, r, t_done in answers
               if lo <= t_done < hi]
        span = hi - lo
        return {"answers": len(done_t), "seconds": span,
                "requests_per_s": len(done_t) / span,
                "latency_ms": latency_ms(lat)}

    end = max(t_done for *_, t_done in answers)
    forwards = {v: compiled[v].replays - replays[v] for v in compiled}
    assert counts["sep2d"] == 34 * sum(forwards.values()), \
        (counts, forwards)
    assert by_body["sep2d"]["wgmma"] == counts["sep2d"], by_body
    out = {"phase": "serving_hot_swap", "requests": n,
           "seconds": seconds, "requests_per_s": n / seconds,
           "before_cutover": segment(t0, marks["cutover_t"]),
           "across_flip": segment(marks["cutover_t"], marks["rollback_t"]),
           "after_rollback": segment(marks["rollback_t"], end + 1e-9),
           "request_ms": latency_ms([r.latency_s for *_, r, _ in answers]),
           "answers_by_version": {v: sum(r.version == v
                                         for *_, r, _ in answers)
                                  for v in ("v1", "v2")},
           "pre_cutover_resolves": marks["pre_cutover_resolves"],
           "shadowed": shadowed, "shadow_compared": compared,
           "shadow_divergence": {"p50": div["p50"], "max": div["max"]},
           "cutover_events": mon.count(health.SERVING_CUTOVER),
           "max_abs_err_vs_eager": errs, "forwards": forwards,
           "health": mon.counters(),
           "launches": counts, "launches_by_body": by_body}
    emit(out)
    return out, eager


class MemoryAtEvents:
    """A HealthMonitor that stamps ``torch.cuda.memory_allocated()`` and,
    after ``torch.cuda.empty_cache()``, ``memory_reserved()`` on each cold
    start (after the load and its warm-up, before any victim is released)
    and each eviction record."""

    def __new__(cls, name):
        from sparkdl_tpu_torch.core import health

        class Monitor(health.HealthMonitor):
            def record(self, event, n=1, **ctx):
                if event in (health.SERVING_COLD_START,
                             health.SERVING_EVICTED):
                    torch.cuda.synchronize()
                    ctx["memory_allocated"] = torch.cuda.memory_allocated()
                    torch.cuda.empty_cache()
                    ctx["memory_reserved"] = torch.cuda.memory_reserved()
                super().record(event, n=n, **ctx)

        return Monitor(name)


def resident_model(res, name):
    """The model ``res`` holds for (name, "v1"), or None, read without an
    acquire (which would move it up the LRU order)."""
    with res._cond:
        return res._residents[(name, "v1")].model


def graph_pools(model) -> dict:
    """The graph memory pools of ``model`` and its variants on the card,
    each with the bytes the caching allocator holds for it now (not in
    the residency budget)."""
    from sparkdl_tpu_torch.core import model_function

    dev = torch.device("cuda", torch.cuda.current_device())
    return {p._pool: model_function._pool_bytes(dev, p._pool)
            for m in model.device_variants() for p in m._programs.values()
            if p.device == dev and p._pool is not None}


def pools_left(pools) -> int:
    """Bytes the caching allocator still holds for any of ``pools``."""
    from sparkdl_tpu_torch.core import model_function

    dev = torch.device("cuda", torch.cuda.current_device())
    return sum(model_function._pool_bytes(dev, pool) for pool in pools)


def serving_residency(s, kernels):
    """Three deployments under one byte budget of VGG16's bf16
    ``weight_bytes`` + Xception's + 1 MiB, each unpinned so LRU may evict
    it: ``xception`` (299×299 rows), ``vgg16`` (224×224) and ``resnet50``
    (256×256 rows through ``resized``: ``preproc_resize`` a forward).
    Requests go in RESIDENT_ORDER. Held: the evictions are the two LRU
    dictates, in order; across each (from after the load and its warm-up
    to after the request with ``gc.collect()``), ``memory_allocated``
    falls by at least the victim's ``weight_bytes()``, the allocator
    holds nothing more of the victim's graph pools, and
    ``memory_reserved`` (each read after ``empty_cache()``) falls by at
    least what those pools held before; the reloaded vgg16 answers its
    request ``torch.equal`` to its first answer, at the same rung."""
    import gc

    from sparkdl_tpu_torch import serving
    from sparkdl_tpu_torch.core import health, telemetry

    sizes = {served: bf16_weight_bytes(model)
             for model, served, _ in RESIDENTS}
    budget = sizes["vgg16"] + sizes["xception"] + 2 ** 20
    res = serving.ResidencyManager(budget, policy="lru")
    reg = serving.ModelRegistry(residency=res)
    srv = serving.ModelServer(reg)
    rows = {}
    # deployed cold (a warm-up at deploy would load each one now), then
    # unpinned; every load below is a request's cold start, warmed
    s.EngineConfig.serving_warmup = False
    for i, (model, served, size) in enumerate(RESIDENTS):
        reg.deploy(served, "v1",
                   loader=served_model(model, SERVE_SEED + 10 + i, size),
                   batch_size=RESIDENT_BATCH)
        res.pin(served, "v1", pinned=False)
        rows[served] = serving_rows(size, 1, SERVE_SEED + 20 + i)[0]
    s.EngineConfig.serving_warmup = True
    # simulate LRU over the planned requests: the evictions expected
    ledger, expected = [], []
    for served in RESIDENT_ORDER:
        if served in ledger:
            ledger.remove(served)
        else:
            while sum(sizes[m] for m in ledger) + sizes[served] > budget:
                expected.append(ledger.pop(0))
        ledger.append(served)
    assert len(expected) == 2, expected
    kernels.reset_launches()
    steps, answers, evicted = [], {}, []
    with MemoryAtEvents("serving_residency") as mon, \
            telemetry.Telemetry("serving_residency") as tel:
        for served in RESIDENT_ORDER:
            n_events = len(mon.events())
            res_before = res.is_resident(served, "v1")
            pools = {m: graph_pools(resident_model(res, m))
                     for _, m, _ in RESIDENTS if res.is_resident(m, "v1")}
            t0 = time.perf_counter()
            result = srv.predict(served, rows[served])
            seconds = time.perf_counter() - t0
            gc.collect()
            torch.cuda.synchronize()
            after = torch.cuda.memory_allocated()
            torch.cuda.empty_cache()
            reserved_after = torch.cuda.memory_reserved()
            events = mon.events()[n_events:]
            cold = [e for e in events
                    if e["event"] == health.SERVING_COLD_START]
            gone = [e for e in events
                    if e["event"] == health.SERVING_EVICTED]
            model = resident_model(res, served)
            on_card(model)
            assert model.weight_bytes() == sizes[served], \
                (served, model.weight_bytes(), sizes[served])
            step = {"request": served, "was_resident": res_before,
                    "seconds": seconds, "cold_start_s": (
                        cold[0]["seconds"] if cold else None),
                    "evicted": [e["model"] for e in gone],
                    "memory_allocated_after": after,
                    "memory_reserved_after": reserved_after,
                    "graph_pool_mib": {
                        m: sum(graph_pools(resident_model(res, m)).values())
                        / 2 ** 20
                        for _, m, _ in RESIDENTS if res.is_resident(m, "v1")},
                    "resident_mib": res.resident_bytes() / 2 ** 20}
            del model
            if cold:
                step["memory_allocated_at_cold_start"] = \
                    cold[0]["memory_allocated"]
                step["memory_reserved_at_cold_start"] = \
                    cold[0]["memory_reserved"]
            if gone:
                freed = cold[0]["memory_allocated"] - after
                victim_bytes = sum(sizes[e["model"]] for e in gone)
                victim_pools = {pool: n for e in gone
                                for pool, n in pools[e["model"]].items()}
                pool_bytes = sum(victim_pools.values())
                reserved_freed = cold[0]["memory_reserved"] - reserved_after
                left = pools_left(victim_pools)
                step.update(freed=freed, victim_weight_bytes=victim_bytes,
                            reserved_freed=reserved_freed,
                            victim_pool_bytes=pool_bytes,
                            victim_pool_bytes_left=left)
                assert freed >= victim_bytes, \
                    f"evicting {step['evicted']} freed {freed} B < " \
                    f"{victim_bytes} B"
                assert pool_bytes > 0 and left == 0, \
                    f"evicting {step['evicted']}: {left} B of its " \
                    f"{pool_bytes} B of graph pools still held"
                assert reserved_freed >= pool_bytes, \
                    f"evicting {step['evicted']} gave back {reserved_freed}" \
                    f" B reserved < {pool_bytes} B of graph pools"
                evicted.extend(step["evicted"])
            answers.setdefault(served, []).append(result.output)
            steps.append(step)
            if served == "resnet50":
                r50 = resident_model(res, "resnet50")
                r50_replays = r50.jitted(torch.device("cuda")).replays
                r50_graphs = len(r50.jitted(torch.device("cuda")).graphs)
                del r50
    counts, by_body = launch_counts(kernels)
    assert evicted == expected, (evicted, expected)
    first, again = answers["vgg16"]
    reload_equal = bool(torch.equal(torch.from_numpy(first),
                                    torch.from_numpy(again)))
    assert reload_equal, "the reloaded vgg16 answered differently"
    # one preproc_resize a forward of resnet50: its warm-up (one eager
    # forward a capture, one replay a rung and dtype) and its request
    assert counts["preproc_resize"] == r50_replays + r50_graphs, \
        (counts, r50_replays, r50_graphs)
    status = res.status()
    out = {"phase": "serving_residency", "budget_bytes": budget,
           "weight_bytes": sizes, "requests": RESIDENT_ORDER,
           "evictions": evicted, "expected_evictions": expected,
           "steps": steps, "reload_torch_equal": reload_equal,
           "cold_starts": status["cold_starts"],
           "evictions_counted": status["evictions"],
           "evictions_metric": tel.metrics.snapshot()["counters"].get(
               telemetry.M_SERVING_EVICTIONS),
           "model_load_spans": len(tel.tracer.spans(
               telemetry.SPAN_MODEL_LOAD)),
           "health": mon.counters(),
           "launches": counts, "launches_by_body": by_body}
    emit(out)
    return out


def serving_slo(s, kernels, reg, rows, part_frame):
    """The live plane under a flood: ``xception`` served to 8 interactive
    clients by a ``ModelServer(admission="shed", slo_window_s=2)`` inside
    ``Telemetry(window_s=2, export_interval_s=0.25, slo_rules=
    default_serving_rules(...))``, while featurize_partitioned's frame
    floods the bulk lane (in float32: three times the card time of a bf16
    window) for SLO_FLOOD_S, then the clients go on alone.

    The latency target SLO_TARGET_MS is a bound of
    ``DEFAULT_TIME_BOUNDS``: the rule reads a window's p99 as the
    geometric midpoint of its bucket, clamped to the window's largest
    sample, so a window breaches exactly when its p99 request lies above
    the target.

    Held: the unloaded clients' request p99, measured first at the same
    target (so at the same coalesce window), is at most the target /
    SLO_ROOM; a ``ServingOverloaded`` and a ``serving_shed``; the rule
    ``serving_request_p99_xception`` breaches while the flood runs, its
    events alternate ``slo_breach``/``slo_recovered`` and end recovered;
    once the flood's queue waits and requests have left both windows
    (two windows after it ended) every snapshot judges the rule on
    requests of its window and finds it unbreached, the final flush
    included; snapshots at the cadence, the last one the final flush;
    the Prometheus file names ``sparkdl_serving_request_s``; the
    report's ``timeline`` has entries."""
    import json
    import shutil
    import threading

    from sparkdl_tpu_torch import serving
    from sparkdl_tpu_torch.core import health, slo, telemetry

    feat, df = part_frame
    model = reg.deployment("xception", "v1").model()

    def clients(server, stop, log):
        def client(t):
            i = 0
            while not stop.is_set():
                idx = (t * 7 + i) % len(rows)
                i += 1
                try:
                    res = server.predict("xception", rows[idx])
                    log.append(("ok", time.perf_counter(), res.latency_s))
                except serving.ServingOverloaded:
                    log.append(("shed", time.perf_counter(), None))
                    stop.wait(0.005)

        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(SERVE_CLIENTS)]
        for t in threads:
            t.start()
        return threads

    def join(threads):
        for t in threads:
            t.join(300)
            assert not t.is_alive(), "a thread of serving_slo hung"

    # unloaded clients at the target, admitted without shedding
    target_ms = SLO_TARGET_MS
    assert target_ms / 1e3 in telemetry.DEFAULT_TIME_BOUNDS, target_ms
    cal_reg = serving.ModelRegistry()
    cal_reg.deploy("xception", "v1", model=model,
                   latency_target_ms=target_ms, batch_size=SERVE_BATCH)
    stop, log = threading.Event(), []
    threads = clients(serving.ModelServer(cal_reg, admission="block"),
                      stop, log)
    time.sleep(SLO_CALIBRATE_S)
    stop.set()
    join(threads)
    unloaded = latency_ms([lat for kind, _, lat in log if kind == "ok"])
    assert SLO_ROOM * unloaded["p99"] <= target_ms, \
        f"serving_slo: unloaded request p99 {unloaded['p99']} ms leaves " \
        f"less than {SLO_ROOM}x room under the {target_ms} ms target"
    slo_reg = serving.ModelRegistry()
    slo_reg.deploy("xception", "v1", model=model,
                   latency_target_ms=target_ms, batch_size=SERVE_BATCH)
    srv = serving.ModelServer(slo_reg, admission="shed",
                              slo_window_s=SLO_WINDOW_S)
    # the flood's float32 graphs, captured before the clock starts
    s.EngineConfig.inference_precision = "float32"
    s.EngineConfig.max_workers = WORKERS
    feat.transform(df).collect()
    torch.cuda.synchronize()
    out_dir = tempfile.mkdtemp(prefix="sparkdl_slo_")
    rule = "serving_request_p99_xception"
    kernels.reset_launches()
    try:
        stop, log, flood_stop = threading.Event(), [], threading.Event()
        passes = [0]

        def flood():
            while not flood_stop.is_set():
                feat.transform(df).collect()
                passes[0] += 1

        # room in the event log for every shed, so the SLO events after
        # them are kept in order
        with health.HealthMonitor("serving_slo",
                                  max_events=1 << 17) as mon, \
                telemetry.Telemetry(
                    "serving_slo", out_dir=out_dir, window_s=SLO_WINDOW_S,
                    export_interval_s=SLO_EXPORT_S,
                    slo_rules=slo.default_serving_rules(
                        slo_reg.targets(), window_s=SLO_WINDOW_S,
                        for_s=SLO_HOLD_S)) as tel:
            t0 = time.perf_counter()
            threads = clients(srv, stop, log)
            time.sleep(0.5)
            flooder = threading.Thread(target=flood)
            flood_t = (time.perf_counter(), None)
            flooder.start()
            time.sleep(SLO_FLOOD_S)
            flood_stop.set()
            flooder.join(300)
            assert not flooder.is_alive(), "the flood hung"
            flood_t = (flood_t[0], time.perf_counter())
            time.sleep(SLO_RECOVER_S)
            stop.set()
            join(threads)
            wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        counts, by_body = launch_counts(kernels)
        exp = tel.exporter
        lines = [json.loads(line) for line in open(exp.snapshot_path)]
        prom = open(exp.prom_path).read()
        report = json.load(open(tel.report_path))
    finally:
        s.EngineConfig.inference_precision = "bfloat16"
        shutil.rmtree(out_dir, ignore_errors=True)
    slo_events = [(e["event"], e["rule"]) for e in mon.events()
                  if e["event"] in (health.SLO_BREACH, health.SLO_RECOVERED)]
    mine = [ev for ev, r in slo_events if r == rule]
    shed = sum(1 for kind, _, _ in log if kind == "shed")
    expected_lines = wall / SLO_EXPORT_S

    def first_line(pred):
        return next((line["uptime_s"] for line in lines if pred(line)),
                    None)

    breach_s = first_line(lambda ln: ln.get("slo", {}).get(
        rule, {}).get("breached"))
    recovered_s = next((line["uptime_s"] for line in lines
                        if breach_s is not None
                        and line["uptime_s"] > breach_s
                        and not line["slo"][rule]["breached"]), None)
    ok = [(t, lat) for kind, t, lat in log if kind == "ok"]
    start, end = flood_t[0] - t0, flood_t[1] - t0
    # two windows and a snapshot's interval after the flood's end (the
    # scope's uptime starts just before t0): its queue waits have left
    # the admission's window, and its requests the rule's
    settled = [line for line in lines if line["uptime_s"]
               >= end + 2 * SLO_WINDOW_S + SLO_EXPORT_S]

    def window_p99(line, metric):
        h = line["windowed"]["histograms"].get(metric)
        return None if h is None else h["p99"]

    out = {"phase": "serving_slo", "latency_target_ms": target_ms,
           "unloaded_request_ms": unloaded,
           "queue_wait_budget_ms": target_ms * 0.5,
           "window_s": SLO_WINDOW_S, "export_interval_s": SLO_EXPORT_S,
           "hold_s": SLO_HOLD_S, "flood_s": [start, end],
           "flood_passes": passes[0], "seconds": wall,
           "answered": len(ok), "shed": shed,
           "request_ms_before_flood": latency_ms(
               [lat for t, lat in ok if t < flood_t[0]]),
           "request_ms_during_flood": latency_ms(
               [lat for t, lat in ok if flood_t[0] <= t < flood_t[1]]),
           "request_ms_after_flood": latency_ms(
               [lat for t, lat in ok if t >= flood_t[1]]),
           "slo_events": slo_events,
           "breach_uptime_s": breach_s, "recovered_uptime_s": recovered_s,
           "settled_snapshots": len(settled),
           # what the rule observed at each of its recoveries (None: an
           # empty window)
           "recovered_observed": [
               e["observed"] for e in mon.events()
               if e["event"] == health.SLO_RECOVERED and e["rule"] == rule],
           # each snapshot: uptime, the rule's windowed p99 and verdict,
           # the windowed queue-wait p99, sheds so far
           "snapshot_trace": [
               [line["uptime_s"],
                window_p99(line, telemetry.serving_request_metric(
                    "xception")),
                line.get("slo", {}).get(rule, {}).get("breached"),
                window_p99(line, telemetry.M_QUEUE_WAIT_S),
                line["cumulative"]["counters"].get(
                    telemetry.HEALTH_METRIC_PREFIX + health.SERVING_SHED,
                    0)] for line in lines],
           "snapshots": len(lines), "snapshots_expected": expected_lines,
           "exporter_errors": exp.errors,
           "timeline_entries": len(report["timeline"]["entries"]),
           "health": mon.counters(),
           "launches": counts, "launches_by_body": by_body}
    emit(out)
    assert mon.dropped_events() == 0, "serving_slo: events dropped"
    assert mine and mine == [health.SLO_BREACH, health.SLO_RECOVERED] \
        * (len(mine) // 2), f"serving_slo: {rule} events {slo_events}"
    assert breach_s is not None and start <= breach_s <= end, \
        f"serving_slo: {rule} breached at {breach_s}, flood {start}-{end}"
    assert len(settled) >= 2 and settled[-1].get("final"), \
        f"serving_slo: {len(settled)} snapshots after the flood settled"
    for line in settled:
        verdict = line["slo"][rule]
        assert verdict["observed"] is not None \
            and not verdict["breached"], \
            f"serving_slo: {rule} at {line['uptime_s']} s: {verdict}"
    assert shed >= 1 and mon.count(health.SERVING_SHED) == shed, \
        (shed, mon.count(health.SERVING_SHED))
    assert len(lines) >= 0.5 * expected_lines and lines[-1].get("final"), \
        (len(lines), expected_lines)
    assert all(a["seq"] + 1 == b["seq"] for a, b in zip(lines, lines[1:]))
    assert "sparkdl_serving_request_s" in prom
    assert report["timeline"]["entries"], "empty timeline"
    return out


def serving_path(s, kernels, part_frame):
    """The four serving phases, on the card under ``"force"`` in bf16,
    with ``serving_warmup`` on and the blind power-of-two ladder (a tuned
    ladder may adopt a rung after the warm-up, whose first request would
    then capture; and the deployments and the flood's featurizer share a
    model name, so they would share one tuned planner). Returns the
    phases, the rows served and each version's eager answers to them."""
    from sparkdl_tpu_torch import serving

    s.EngineConfig.device = "cuda"
    s.EngineConfig.pallas_kernels = "force"
    s.EngineConfig.inference_precision = "bfloat16"
    s.EngineConfig.coalesce = True
    s.EngineConfig.serving_warmup = True
    s.EngineConfig.bucket_ladder = "pow2"
    try:
        rows = serving_rows(TARGET, SERVE_ROWS, SERVE_SEED + 2)
        reg = serving.ModelRegistry()
        srv = serving.ModelServer(reg)
        phases = {}
        phases["serving_predict"], eager = serving_predict(s, kernels, reg,
                                                           srv, rows)
        phases["serving_hot_swap"], eager = serving_hot_swap(
            s, kernels, reg, srv, rows, eager)
        phases["serving_slo"] = serving_slo(s, kernels, reg, rows,
                                            part_frame)
        phases["serving_residency"] = serving_residency(s, kernels)
        return phases, rows, eager
    finally:
        s.EngineConfig.serving_warmup = False
        s.EngineConfig.bucket_ladder = "tuned"
        s.EngineConfig.inference_precision = "bfloat16"


# -- durable jobs and the cluster inference plane ----------------------------

#: the commit after which the durable child SIGKILLs itself (0-based: the
#: 6th commit)
DURABLE_KILL_AFTER = 5
#: the worker counts of cluster_featurize
CLUSTER_WORKERS = (2, 4)
#: the dispatch after which cluster_worker_kill fires (0-based)
CLUSTER_KILL_AFTER = 5


def partitioned_frame(s):
    """featurize_partitioned's transformer and frame, built as
    ``partitioned_path`` builds them (the same seeded images, the same
    seeded weights), with its engine settings: a process of its own
    builds the same job."""
    s.EngineConfig.inference_precision = "bfloat16"
    s.EngineConfig.device = "cuda"
    s.EngineConfig.pallas_kernels = "force"
    s.EngineConfig.max_workers = WORKERS
    s.EngineConfig.coalesce = True
    rng = np.random.default_rng(SEED + 100 + TARGET[0])
    images = [rng.integers(0, 256, size=(*TARGET, 3), dtype=np.uint8)
              for _ in range(PART_IMAGES)]
    return featurize(s, ("Xception", "named"), images, "random", BATCH,
                     parts=PARTITIONS)


def durable_child(root: str) -> int:
    """``python3 chip_smoke.py --durable-child <root>``: run
    featurize_partitioned's frame as a durable job under ``root`` with
    ``process_kill`` armed at the 6th commit. Returns 3 if it was not
    killed."""
    import sparkdl_tpu_torch as s
    from sparkdl_tpu_torch.core.resilience import Fault, FaultInjector

    feat, df = partitioned_frame(s)
    s.EngineConfig.durable_dir = root
    with FaultInjector.seeded(0, process_kill=Fault(
            times=1, after=DURABLE_KILL_AFTER)):
        feat.transform(df).collect()
    return 3


def filesystem_of(path: str) -> dict:
    """The mount point and filesystem type that hold ``path``."""
    real = os.path.realpath(path)
    best = ("", "unknown")
    with open("/proc/mounts") as f:
        for line in f:
            fields = line.split()
            mnt, fstype = fields[1], fields[2]
            if (real == mnt or real.startswith(mnt.rstrip("/") + "/")) \
                    and len(mnt) > len(best[0]):
                best = (mnt, fstype)
    return {"path": real, "mount": best[0], "type": best[1]}


def percentiles(values) -> dict:
    if not values:
        return {"p50": None, "p99": None, "n": 0}
    arr = np.asarray(values, np.float64)
    return {"p50": float(np.percentile(arr, 50)),
            "p99": float(np.percentile(arr, 99)), "n": len(values)}


def rows_held(name, rows, cpu, rel_tol) -> dict:
    """Every row of a pass against the CPU run within ``rel_tol`` of
    max|cpu| (a recomputed or worker-computed row is not bit-identical
    to an in-process one on the card, Queue 3 of ROADMAP.md)."""
    gpu, _ = row_vectors(rows)
    assert gpu.shape == cpu.shape, f"{name}: rows {gpu.shape} != {cpu.shape}"
    assert np.isfinite(gpu).all(), f"{name}: non-finite features"
    limit = rel_tol * float(np.max(np.abs(cpu)))
    per_row = np.max(np.abs(gpu - cpu), axis=1)
    err = float(per_row.max())
    assert err <= limit, f"{name}: row {int(per_row.argmax())} differs " \
                         f"from the CPU run by {err} > {limit}"
    return {"max_abs_err_vs_cpu": err, "rows_vs_cpu": len(per_row),
            "tolerance": limit}


def check_worker_launches(name, dev, per_forward=34) -> None:
    """The workers' summed counts: every ``sep2d`` launch on the
    tensor-core body, 34 a forward (a capture's warm-up counts as one)."""
    forwards = dev["forwards"] + dev["captures"]
    assert dev["forwards"] > 0, f"{name}: the workers ran no forward"
    assert dev["launches"]["sep2d"] == per_forward * forwards, \
        f"{name}: sep2d launches {dev['launches']} != {per_forward} × " \
        f"{forwards}"
    assert dev["launches_by_body"]["sep2d"]["wgmma"] \
        == dev["launches"]["sep2d"], \
        f"{name}: sep2d off the wgmma body: {dev['launches_by_body']}"


def worker_lines(rep) -> dict:
    """Each worker's tasks, seconds inside its op chains and its forwards,
    boot seconds, forwards and reserved card memory, over the worker's
    whole life (its end-of-run snapshot)."""
    out = {}
    for wname, snap in sorted(rep["workers"].items()):
        dev = snap["device"]
        phases = snap.get("phases") or {}
        out[wname] = {"pid": snap["pid"], "tasks": snap["tasks"],
                      "exec_s": snap["exec_s"],
                      "device_apply_s": (phases.get("sparkdl.device_apply")
                                         or {}).get("total_s"),
                      "boot": dev["boot"], "forwards": dev["forwards"],
                      "captures": dev["captures"],
                      "memory_reserved_mib":
                          dev["memory_reserved"] / 2 ** 20}
    return out


def durable_featurize(s, kernels, feat, df, cpu, rel_tol):
    """Kill a durable run of the frame in a child process at its 6th
    commit, then resume the job here: the committed partitions come from
    their spills (held bit for bit by sha256), only the others run."""
    import hashlib
    import signal

    from sparkdl_tpu_torch.core import durability, health, profiling

    root = tempfile.mkdtemp(prefix="sparkdl_durable_")
    fs = filesystem_of(root)
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--durable-child", root],
        capture_output=True, text=True, timeout=600)
    child_s = time.perf_counter() - t0
    assert child.returncode == -signal.SIGKILL, \
        f"durable child exited {child.returncode}, not by SIGKILL:\n" \
        f"{child.stderr[-3000:]}"
    (job,) = [d for d in os.listdir(root)
              if os.path.isdir(os.path.join(root, d))]
    killed = {r["partition"]: r for r in
              durability.PartitionJournal(root, job, PARTITIONS).records()}
    assert len(killed) > DURABLE_KILL_AFTER, killed.keys()

    run = executed_model(s, feat, TARGET)
    compiled = run.jitted(s.EngineConfig.device)
    s.EngineConfig.durable_dir = root
    kernels.reset_launches()
    profiling.reset_phase_stats()
    durability.reset_commit_stats()
    replays = compiled.replays
    try:
        with health.HealthMonitor("durable_featurize") as monitor:
            t0 = time.perf_counter()
            batches = list(feat.transform(df).partitionsIter())
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
    finally:
        s.EngineConfig.durable_dir = None
    stats = durability.commit_stats()
    counts = dict(kernels.launches)
    by_body = {k: dict(v) for k, v in kernels.launches_by_body.items()}
    captures = profiling.phase_stats().get(
        "sparkdl.compile", {"count": 0})["count"]
    forwards = compiled.replays - replays
    recomputed = PARTITIONS - len(killed)
    assert monitor.count(health.DURABLE_RESUMED) == 1
    assert monitor.count(health.DURABLE_PARTITION_RESTORED) == len(killed)
    assert monitor.count(health.TASK_STARTED) == recomputed, \
        monitor.counters()
    assert forwards > 0 and counts["sep2d"] == 34 * (forwards + captures), \
        f"durable_featurize: sep2d {counts} != 34 × {forwards + captures}"
    assert by_body["sep2d"]["wgmma"] == counts["sep2d"], by_body
    for i, rec in killed.items():
        got = hashlib.sha256(durability.encode_batch(batches[i])).hexdigest()
        assert got == rec["sha256"], \
            f"durable_featurize: restored partition {i} is not its spill"
    rows = [r for b in batches for r in
            [{"features": f} for f in b.column("features")]]
    held = rows_held("durable_featurize", rows, cpu, rel_tol)
    job_dir = os.path.join(root, job)
    spills = [os.path.join(job_dir, n) for n in os.listdir(job_dir)
              if n.endswith(".spill")]
    out = {"phase": "durable_featurize", "durable_dir": fs,
           "child_s": child_s, "child_rc": child.returncode,
           "committed_before_kill": sorted(killed),
           "restored": len(killed), "recomputed": recomputed,
           "seconds": seconds, "images_per_s": PART_IMAGES / seconds,
           "forwards": forwards, "captures_in_pass": captures,
           "launches": counts, "launches_by_body": by_body,
           "health": monitor.counters(),
           "commit_ms": percentiles(stats["commit_ms"]),
           "journal_rewrite_ms": percentiles(stats["rewrite_ms"]),
           "spill_bytes_resume": stats["spill_bytes"],
           "spill_bytes_total": sum(os.path.getsize(p) for p in spills),
           "spills": len(spills), **held}
    emit(out)
    return out


def pass_counts(label, before, after) -> dict:
    """The workers' summed device counts of one pass: the difference of
    two pulls of every worker's ``device`` section, one just before the
    pass and one just after."""
    from sparkdl_tpu_torch.cluster import aggregate

    assert before and set(before) == set(after), \
        f"{label}: workers answered {sorted(before)} then {sorted(after)}"
    b, a = (aggregate.sum_device_counts([{"device": d} for d in x.values()])
            for x in (before, after))
    return {"launches": {k: n - b["launches"].get(k, 0)
                         for k, n in a["launches"].items()},
            "launches_by_body": {
                k: {body: n - b["launches_by_body"].get(k, {}).get(body, 0)
                    for body, n in bodies.items()}
                for k, bodies in a["launches_by_body"].items()},
            "forwards": a["forwards"] - b["forwards"],
            "captures": a["captures"] - b["captures"]}


def cluster_run(s, label, feat, df, workers, inj=None):
    """The frame on ``workers`` cluster workers, then the router shut
    down (its report merges the workers' snapshots). Without ``inj``: a
    warm-up pass (spawn, weights, captures), then a counted pass whose
    launch counts are the difference of the workers' counts pulled just
    before and just after it. With ``inj`` armed: one pass, which spawns
    the workers, counted by their end-of-run snapshots."""
    from sparkdl_tpu_torch.cluster import router as cluster_router
    from sparkdl_tpu_torch.core import health

    s.EngineConfig.cluster_workers = workers
    counted = None
    try:
        with health.HealthMonitor(label) as monitor:
            t0 = time.perf_counter()
            if inj is None:
                feat.transform(df).collect()  # warm-up
                before = cluster_router.maybe_router().device_sections()
            warmup_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            if inj is not None:
                with inj:
                    rows = feat.transform(df).collect()
            else:
                rows = feat.transform(df).collect()
            seconds = time.perf_counter() - t0
            router = cluster_router.maybe_router()
            if inj is None:
                counted = pass_counts(label, before,
                                      router.device_sections())
            t0 = time.perf_counter()
            cluster_router.shutdown()
            close_s = time.perf_counter() - t0
    finally:
        s.EngineConfig.cluster_workers = 0
    rep = cluster_router.last_cluster_report()
    for w in router._workers:
        w.proc.join(timeout=30)
        assert not w.proc.is_alive(), f"{label}: {w.proc.name} still runs"
    return rows, rep, monitor, {"warmup_s": warmup_s, "seconds": seconds,
                                "close_s": close_s}, counted


def cluster_featurize(s, kernels, feat, df, cpu, rel_tol, workers,
                      in_process):
    """The frame on ``workers`` worker processes sharing the card, beside
    the in-process coalesced pass of featurize_partitioned: images/s,
    each worker's boot (spawn, imports, CUDA init, the op chain with its
    weights), forwards and ``sep2d`` launches summed over the workers,
    each worker's ``memory_reserved``, every row held."""
    from sparkdl_tpu_torch.core import health

    name = f"cluster_featurize_{workers}"
    rows, rep, monitor, times, dev = cluster_run(
        s, name, feat, df, workers)
    assert rep["worker_count"] == workers, rep["worker_count"]
    check_worker_launches(name, dev)
    check_worker_launches(f"{name} (warm-up and pass)", rep["device"])
    assert rep["results"]["late"] == 0, rep["results"]
    assert monitor.count(health.CLUSTER_WORKER_LOST) == 0
    held = rows_held(name, rows, cpu, rel_tol)
    out = {"phase": name, "workers": workers, **times,
           "images_per_s": PART_IMAGES / times["seconds"],
           "in_process_images_per_s": in_process,
           "forwards": dev["forwards"], "captures": dev["captures"],
           "launches": dev["launches"],
           "launches_by_body": dev["launches_by_body"],
           "sep2d_launches_warmup_and_pass":
               rep["device"]["launches"]["sep2d"],
           "per_worker": worker_lines(rep),
           "results": rep["results"], "health": monitor.counters(), **held}
    emit(out)
    return out


def cluster_worker_kill(s, kernels, feat, df, cpu, rel_tol):
    """``cluster_worker_kill`` once, with the journal on: one worker
    lost, each of its in-flight partitions re-dispatched once, every
    partition computed once and committed once, every row held."""
    from sparkdl_tpu_torch.core import durability, health
    from sparkdl_tpu_torch.core.resilience import Fault, FaultInjector

    root = tempfile.mkdtemp(prefix="sparkdl_cluster_kill_")
    s.EngineConfig.durable_dir = root
    inj = FaultInjector.seeded(0, cluster_worker_kill=Fault(
        times=1, after=CLUSTER_KILL_AFTER))
    try:
        rows, rep, monitor, times, _ = cluster_run(
            s, "cluster_worker_kill", feat, df, 2, inj=inj)
    finally:
        s.EngineConfig.durable_dir = None
    assert inj.fired == {"cluster_worker_kill": 1}, inj.fired
    (lost,) = monitor.events(health.CLUSTER_WORKER_LOST)
    moved = [e["partition"] for e in
             monitor.events(health.CLUSTER_REDISPATCH)]
    assert len(moved) == lost["in_flight"] == len(set(moved)) > 0, \
        (moved, lost)
    # every partition ran once: the dead worker's delivered results, the
    # survivor's, no late duplicate
    assert sum(rep["results"]["per_worker"].values()) == PARTITIONS \
        and rep["results"]["late"] == 0, rep["results"]
    (job,) = [d for d in os.listdir(root)
              if os.path.isdir(os.path.join(root, d))]
    records = durability.PartitionJournal(root, job, PARTITIONS).records()
    assert [r["partition"] for r in records] == list(range(PARTITIONS))
    assert all(r["attempts"] == 1 for r in records), records
    assert rep["worker_count"] == 1
    check_worker_launches("cluster_worker_kill", rep["device"])
    held = rows_held("cluster_worker_kill", rows, cpu, rel_tol)
    out = {"phase": "cluster_worker_kill", **times,
           "lost": lost["worker"], "in_flight_at_death": lost["in_flight"],
           "redispatched": sorted(moved), "results": rep["results"],
           "committed": len(records),
           "launches": rep["device"]["launches"],
           "launches_by_body": rep["device"]["launches_by_body"],
           "per_worker": worker_lines(rep),
           "health": monitor.counters(), **held}
    emit(out)
    return out


def cluster_trace(s, kernels, feat, df, cpu, rel_tol):
    """A 2-worker pass inside a ``Telemetry`` scope: each worker's
    ``sparkdl.cluster_task`` spans carry its pid and parent under a
    ``sparkdl.cluster_dispatch`` span of this process, and the merged
    Chrome trace names this process and every worker."""
    from sparkdl_tpu_torch.cluster import router as cluster_router
    from sparkdl_tpu_torch.core import health, telemetry

    out_dir = tempfile.mkdtemp(prefix="sparkdl_cluster_trace_")
    s.EngineConfig.cluster_workers = 2
    try:
        with health.HealthMonitor("cluster_trace") as monitor, \
                telemetry.Telemetry("cluster_trace", out_dir=out_dir) as tel:
            t0 = time.perf_counter()
            rows = feat.transform(df).collect()
            seconds = time.perf_counter() - t0
            cluster_router.shutdown()
    finally:
        s.EngineConfig.cluster_workers = 0
    rep = cluster_router.last_cluster_report()
    spans = {sp["span_id"]: sp for sp in tel.tracer.spans()}
    tasks = [sp for sp in spans.values()
             if sp["name"] == telemetry.SPAN_CLUSTER_TASK]
    pids = {snap["pid"]: w for w, snap in rep["workers"].items()}
    assert len(tasks) == PARTITIONS, len(tasks)
    for sp in tasks:
        assert sp["pid"] in pids and sp["pid"] != os.getpid(), sp
        parent = spans.get(sp["parent_id"])
        assert parent is not None \
            and parent["name"] == telemetry.SPAN_CLUSTER_DISPATCH, sp
        assert parent.get("pid", os.getpid()) == os.getpid()
    with open(tel.trace_path) as f:
        doc = json.load(f)
    labels = {e["pid"]: e["args"]["name"] for e in doc["traceEvents"]
              if e["name"] == "process_name"}
    assert labels.get(os.getpid()) == "coordinator", labels
    assert set(pids.values()) <= set(labels.values()), (labels, pids)
    assert rep["trace"]["span_rings_lost"] == []
    check_worker_launches("cluster_trace", rep["device"])
    held = rows_held("cluster_trace", rows, cpu, rel_tol)
    out = {"phase": "cluster_trace", "seconds": seconds,
           "task_spans": len(tasks),
           "task_spans_by_worker": {
               w: sum(sp["pid"] == p for sp in tasks)
               for p, w in pids.items()},
           "process_names": sorted(labels.values()),
           "trace": rep["trace"], "trace_path": tel.trace_path,
           "launches": rep["device"]["launches"],
           "launches_by_body": rep["device"]["launches_by_body"],
           "health": monitor.counters(), **held}
    emit(out)
    return out


def cluster_path(s, kernels, part_frame, cpu, in_process):
    """The durable and cluster phases on featurize_partitioned's frame
    (Xception bf16 under ``"force"``, 64 299×299 images in 16 partitions
    of 4, batch 16)."""
    feat, df = part_frame
    s.EngineConfig.inference_precision = "bfloat16"
    s.EngineConfig.device = "cuda"
    s.EngineConfig.pallas_kernels = "force"
    s.EngineConfig.max_workers = WORKERS
    s.EngineConfig.coalesce = True
    phases = {"durable_featurize": durable_featurize(
        s, kernels, feat, df, cpu, BF16_REL)}
    for workers in CLUSTER_WORKERS:
        phases[f"cluster_featurize_{workers}"] = cluster_featurize(
            s, kernels, feat, df, cpu, BF16_REL, workers, in_process)
    phases["cluster_worker_kill"] = cluster_worker_kill(
        s, kernels, feat, df, cpu, BF16_REL)
    phases["cluster_trace"] = cluster_trace(s, kernels, feat, df, cpu,
                                            BF16_REL)
    return phases


# -- the cluster serving plane ------------------------------------------------

#: single-row predicts each of the 8 clients sends in a cluster phase
CLUSTER_SERVE_REQUESTS = 16
#: a cluster phase's per-request deadline: a request that neither answers
#: nor fails classified within it fails the phase
CLUSTER_SERVE_DEADLINE_MS = 60_000.0
#: answers of each version the cutover phase waits for: of v1 before the
#: cutover, of v2 before the rollback, of v1 again before it ends
CLUSTER_CUTOVER_AT = 32
#: the dispatch (0-based) that carries the armed serving_worker_kill
CLUSTER_SERVE_KILL_AFTER = 24


def refusing_model(name, seed):
    """:func:`served_model`, except in the cluster worker whose process
    name ends in ``-1``, where the loader raises (a prepare that fails on
    one replica)."""
    load = served_model(name, seed)

    def refusing():
        import multiprocessing

        if multiprocessing.current_process().name.endswith("-1"):
            raise RuntimeError(f"{name} v3 refuses to load here")
        return load()

    return refusing


def worker_memory(sections) -> dict:
    """Each worker's ``memory_allocated`` and ``memory_reserved`` in MiB,
    from a pull of the workers' ``device`` sections."""
    return {w: {"memory_allocated_mib": d["memory_allocated"] / 2 ** 20,
                "memory_reserved_mib": d["memory_reserved"] / 2 ** 20}
            for w, d in sorted(sections.items())}


def answers_summary(answers, seconds) -> dict:
    n = len(answers)
    return {"requests": n, "seconds": seconds, "requests_per_s": n / seconds,
            "request_ms": latency_ms([r.latency_s for *_, r, _ in answers])}


def no_version_mix(label, answers, old, new, lo, hi) -> int:
    """Of the requests that started at ``lo`` or later and ended before
    ``hi`` (a request starts at its answer's time less its latency),
    none that started after the first answer of ``new`` ended may be
    answered by ``old``. Returns how many such later requests there
    were."""
    window = [(t_done - r.latency_s, t_done, r.version)
              for *_, r, t_done in answers
              if t_done - r.latency_s >= lo and t_done < hi]
    ends = [t1 for _, t1, v in window if v == new]
    assert ends, f"{label}: no answer from {new}"
    later = [v for t0, _, v in window if t0 > min(ends)]
    assert all(v == new for v in later), \
        f"{label}: {later.count(old)} {old} answer(s) after the first {new}"
    return len(later)


def cluster_serving_predict(s, kernels, reg, srv, rows, eager, in_process):
    """Deploy serving_predict's v1 under a name of its own, spawn the
    workers with the first predict, warm the other replica with a probe
    predict on each, then 8 clients × CLUSTER_SERVE_REQUESTS single rows.
    Held: every answer v1 and within the bf16 tolerance of ``eager``,
    one forward a request and no capture over the counted traffic,
    ``sep2d`` 34 × forwards on ``wgmma`` (the workers' pulled counts),
    both replicas resident. Returns the phase line and the served name."""
    from sparkdl_tpu_torch.cluster import router as cluster_router
    from sparkdl_tpu_torch.core import health
    from sparkdl_tpu_torch.serving import cluster as serving_cluster

    name = "xception_cluster"
    t0 = time.perf_counter()
    reg.deploy(name, "v1", loader=served_model("Xception", SERVE_SEED),
               latency_target_ms=SERVE_TARGET_MS, batch_size=SERVE_BATCH)
    with health.HealthMonitor("cluster_serving_warm") as mon:
        # the first predict spawns the workers; one replica cold-loads
        # and warms. Then one probe predict on each replica warms the
        # other: locality routing sends all traffic to the warm replicas
        first = srv.predict(name, rows[0],
                            deadline_ms=CLUSTER_SERVE_DEADLINE_MS)
        first_s = time.perf_counter() - t0
        cluster = serving_cluster.maybe_cluster_serving()
        each = cluster.predict_each(name, reg, rows[0],
                                    deadline_ms=CLUSTER_SERVE_DEADLINE_MS)
    warm_s = time.perf_counter() - t0
    router = cluster_router.maybe_router()
    assert len(each) == 2 and all(v == "v1" for _, v in each.values())
    held_rows("cluster_serving_predict warm-up",
              [(0, first.output)] + [(0, out) for out, _ in each.values()],
              eager["v1"])
    before = router.device_sections()
    with health.HealthMonitor("cluster_serving_predict") as mon:
        answers, seconds = run_clients(
            srv, name, rows, SERVE_CLIENTS, CLUSTER_SERVE_REQUESTS,
            deadline_ms=CLUSTER_SERVE_DEADLINE_MS)
    after = router.device_sections()
    dev = pass_counts("cluster_serving_predict", before, after)
    n = SERVE_CLIENTS * CLUSTER_SERVE_REQUESTS
    assert len(answers) == n and all(r.version == "v1"
                                     for *_, r, _ in answers)
    assert dev["captures"] == 0, f"captured after warm-up: {dev}"
    assert dev["forwards"] == n, (dev["forwards"], n)  # one row each
    check_worker_launches("cluster_serving_predict", dev)
    err = held_rows("cluster_serving_predict",
                    [(idx, r.output) for _, _, idx, r, _ in answers],
                    eager["v1"])
    replicas = srv.status()["cluster"][name]["replicas"]
    assert len(replicas) == 2 and all(
        v["resident"] == ["v1"] for v in replicas.values()), replicas
    out = {"phase": "cluster_serving_predict", "workers": 2,
           "first_request_s": first_s, "warm_s": warm_s,
           **answers_summary(answers, seconds),
           "in_process_requests_per_s": in_process["requests_per_s"],
           "in_process_request_ms": in_process["request_ms_measured"],
           "replicas": replicas, "per_worker": worker_memory(after),
           "forwards": dev["forwards"], "captures": dev["captures"],
           "launches": dev["launches"],
           "launches_by_body": dev["launches_by_body"],
           "forwards_by_worker": {
               w: after[w]["forwards"] - before[w]["forwards"]
               for w in sorted(after)},
           "max_abs_err_vs_eager": err,
           "eager_tolerance": BF16_REL * float(np.abs(eager["v1"]).max()),
           "health": mon.counters()}
    emit(out)
    return out, name


def stream_clients(srv, name, rows, clients, stop, answers, errors):
    """``clients`` threads sending single-row predicts of ``rows`` until
    ``stop`` is set, each with CLUSTER_SERVE_DEADLINE_MS; each answer is
    appended to ``answers`` as ``(client, i, row, result, t_done)``, each
    error to ``errors``. Returns the threads, started."""
    import threading

    lock = threading.Lock()

    def client(t):
        i = 0
        while not stop.is_set():
            idx = (t * 7 + i) % len(rows)
            try:
                res = srv.predict(name, rows[idx],
                                  deadline_ms=CLUSTER_SERVE_DEADLINE_MS)
            except Exception as e:  # noqa: BLE001 - raised by the caller
                with lock:
                    errors.append(e)
                return
            with lock:
                answers.append((t, i, idx, res, time.perf_counter()))
            i += 1

    threads = [threading.Thread(target=client, args=(t,))
               for t in range(clients)]
    for t in threads:
        t.start()
    return threads


def cluster_serving_cutover(s, kernels, reg, srv, rows, eager, name):
    """v2 (serving_hot_swap's weights) deployed dark, then 8 streaming
    clients: CLUSTER_CUTOVER_AT v1 answers, the cutover to v2 (its
    prepare loads and warms v2 in both workers), as many v2 answers, the
    rollback, as many v1 answers. Held: no version mix either way, each
    answer against its version's eager forward, 2 ``serving_cutover``
    events. Then v3, whose loader raises in the worker named ``...-1``:
    ``CutoverFailed``, one ``serving_prepare_failed``, v1 active and
    answering on each replica, one prepare failure in the router's
    report."""
    import threading

    from sparkdl_tpu_torch.cluster import router as cluster_router
    from sparkdl_tpu_torch.core import health
    from sparkdl_tpu_torch.serving import cluster as serving_cluster

    router = cluster_router.maybe_router()
    cluster = serving_cluster.maybe_cluster_serving()
    reg.deploy(name, "v2", loader=served_model("Xception", SERVE_SEED + 1),
               latency_target_ms=SERVE_TARGET_MS, batch_size=SERVE_BATCH)
    answers, errors = [], []
    stop = threading.Event()
    marks = {}

    def wait_for(version, count, since):
        deadline = time.monotonic() + CLUSTER_SERVE_DEADLINE_MS / 1e3
        while time.monotonic() < deadline and not errors:
            if sum(r.version == version and t_done - r.latency_s > since
                   for *_, r, t_done in list(answers)) >= count:
                return
            time.sleep(0.01)
        raise AssertionError(f"cluster_serving_cutover: fewer than {count} "
                             f"{version} answers: {errors[:1]}")

    before = router.device_sections()
    with health.HealthMonitor("cluster_serving_cutover") as mon:
        t0 = time.perf_counter()
        threads = stream_clients(srv, name, rows, SERVE_CLIENTS, stop,
                                 answers, errors)
        try:
            wait_for("v1", CLUSTER_CUTOVER_AT, t0)
            marks["cutover_t"] = time.perf_counter()
            assert srv.cutover(name, "v2") == "v1"
            marks["cutover_done_t"] = time.perf_counter()
            wait_for("v2", CLUSTER_CUTOVER_AT, marks["cutover_done_t"])
            marks["rollback_t"] = time.perf_counter()
            assert srv.rollback(name) == "v2"
            marks["rollback_done_t"] = time.perf_counter()
            wait_for("v1", CLUSTER_CUTOVER_AT, marks["rollback_done_t"])
        finally:
            stop.set()
            for t in threads:
                t.join(CLUSTER_SERVE_DEADLINE_MS / 1e3)
                assert not t.is_alive(), "a serving client hung"
        seconds = time.perf_counter() - t0
    if errors:
        raise errors[0]
    after = router.device_sections()
    dev = pass_counts("cluster_serving_cutover", before, after)
    assert mon.count(health.SERVING_CUTOVER) == 2
    keys = [(t, i) for t, i, _, _, _ in answers]
    assert len(set(keys)) == len(keys), "an answer came twice"
    errs = {v: held_rows(f"cluster_serving_cutover {v}",
                         [(idx, r.output) for _, _, idx, r, _ in answers
                          if r.version == v], eager[v])
            for v in ("v1", "v2")}
    end = max(t_done for *_, t_done in answers) + 1.0
    later_cutover = no_version_mix("cluster_serving_cutover", answers, "v1",
                                   "v2", t0, marks["rollback_t"])
    later_rollback = no_version_mix("cluster_serving_cutover rollback",
                                    answers, "v2", "v1",
                                    marks["cutover_done_t"], end)
    check_worker_launches("cluster_serving_cutover", dev)

    def segment(lo, hi):
        mine = [r.latency_s for *_, r, t_done in answers if lo <= t_done < hi]
        return {"answers": len(mine), "seconds": hi - lo,
                "requests_per_s": len(mine) / (hi - lo),
                "latency_ms": latency_ms(mine)}

    # a prepare that fails on one replica: v3's loader raises in -1
    reg.deploy(name, "v3", loader=refusing_model("Xception", SERVE_SEED + 2),
               latency_target_ms=SERVE_TARGET_MS, batch_size=SERVE_BATCH)
    with health.HealthMonitor("cluster_serving_prepare") as prep:
        t1 = time.perf_counter()
        try:
            srv.cutover(name, "v3")
        except serving_cluster.CutoverFailed as e:
            failure = str(e)
        else:
            raise AssertionError("the cutover to v3 did not fail")
        failed_s = time.perf_counter() - t1
    assert "still serving everywhere" in failure, failure
    assert prep.count(health.SERVING_PREPARE_FAILED) == 1
    assert prep.count(health.SERVING_CUTOVER) == 0
    assert reg.active_version(name) == "v1"
    each = cluster.predict_each(name, reg, rows[:2],
                                deadline_ms=CLUSTER_SERVE_DEADLINE_MS)
    assert len(each) == 2 and all(v == "v1" for _, v in each.values())
    each_err = held_rows("cluster_serving_cutover v1 on each replica",
                         [(i, out[i]) for out, _ in each.values()
                          for i in range(2)], eager["v1"])
    section = cluster.report_section()
    assert section["prepare_failures"] == 1, section
    assert section["deployments"][name]["active"] == "v1"
    out = {"phase": "cluster_serving_cutover",
           **answers_summary(answers, seconds),
           "answers_by_version": {v: sum(r.version == v
                                         for *_, r, _ in answers)
                                  for v in ("v1", "v2")},
           "cutover_s": marks["cutover_done_t"] - marks["cutover_t"],
           "rollback_s": marks["rollback_done_t"] - marks["rollback_t"],
           "before_cutover": segment(t0, marks["cutover_t"]),
           "during_cutover": segment(marks["cutover_t"],
                                     marks["cutover_done_t"]),
           "on_v2": segment(marks["cutover_done_t"], marks["rollback_t"]),
           "after_rollback": segment(marks["rollback_done_t"], end - 1.0
                                     + 1e-9),
           "requests_checked_after_first_v2": later_cutover,
           "requests_checked_after_first_v1_again": later_rollback,
           "max_abs_err_vs_eager": errs,
           "failed_prepare": {"error": failure, "seconds": failed_s,
                              "v1_on_each_replica_err": each_err,
                              "replicas": sorted(each)},
           "router": {k: section[k] for k in ("predicts", "cutovers",
                                              "prepare_failures")},
           "forwards": dev["forwards"], "captures": dev["captures"],
           "launches": dev["launches"],
           "launches_by_body": dev["launches_by_body"],
           "per_worker": worker_memory(after),
           "health": {**mon.counters(), **prep.counters()}}
    emit(out)
    return out


def cluster_serving_failover(s, kernels, reg, srv, rows, eager, name):
    """8 clients × CLUSTER_SERVE_REQUESTS with ``serving_worker_kill``
    armed at dispatch CLUSTER_SERVE_KILL_AFTER: the worker that receives
    it SIGKILLs itself. Held: every request answered within its deadline
    (none may fail: a survivor holds the deployment), one
    ``cluster_worker_lost``, one
    ``serving_failover`` event per moved request (the router's ledger
    agrees), the answers held, the survivor's launches counted."""
    import threading

    from sparkdl_tpu_torch.cluster import router as cluster_router
    from sparkdl_tpu_torch.core import health
    from sparkdl_tpu_torch.core.resilience import Fault, FaultInjector
    from sparkdl_tpu_torch.serving import cluster as serving_cluster

    router = cluster_router.maybe_router()
    cluster = serving_cluster.maybe_cluster_serving()
    before = router.device_sections()
    failovers0 = cluster.report_section()["failovers"]
    inj = FaultInjector.seeded(0, serving_worker_kill=Fault(
        times=1, after=CLUSTER_SERVE_KILL_AFTER))
    answers, errors = [], []
    lock = threading.Lock()

    def client(t):
        for i in range(CLUSTER_SERVE_REQUESTS):
            idx = (t * CLUSTER_SERVE_REQUESTS + i) % len(rows)
            try:
                res = srv.predict(name, rows[idx],
                                  deadline_ms=CLUSTER_SERVE_DEADLINE_MS)
            except Exception as e:  # noqa: BLE001 - fails the phase below
                with lock:
                    errors.append((t, i, e))
                continue
            with lock:
                answers.append((t, i, idx, res, time.perf_counter()))

    with health.HealthMonitor("cluster_serving_failover") as mon, inj:
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(SERVE_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(CLUSTER_SERVE_DEADLINE_MS / 1e3 * CLUSTER_SERVE_REQUESTS)
            assert not t.is_alive(), "a serving client hung"
        seconds = time.perf_counter() - t0
    assert inj.fired == {"serving_worker_kill": 1}, inj.fired
    # a survivor holds the deployment and every deadline is far off, so a
    # working failover answers every request, the moved ones included
    assert not errors, [f"{t}/{i}: {e!r}" for t, i, e in errors]
    n = SERVE_CLIENTS * CLUSTER_SERVE_REQUESTS
    assert len(answers) == n, "a request was lost"
    (lost,) = mon.events(health.CLUSTER_WORKER_LOST)
    events = mon.events(health.SERVING_FAILOVER)
    moved = [e["request"] for e in events]
    assert moved and len(moved) == len(set(moved)), moved
    section = cluster.report_section()
    assert section["failovers"] - failovers0 == len(events), section
    assert set(moved) <= set(section["moved_requests"])
    moved_s = {r: section["moved_latency_s"][r] for r in moved}
    assert all(v < CLUSTER_SERVE_DEADLINE_MS / 1e3 for v in moved_s.values())
    err = held_rows("cluster_serving_failover",
                    [(idx, r.output) for _, _, idx, r, _ in answers],
                    eager["v1"])
    after = router.device_sections()
    assert len(after) == 1 and lost["worker"] not in after, (after, lost)
    dev = pass_counts("cluster_serving_failover",
                      {w: before[w] for w in after}, after)
    check_worker_launches("cluster_serving_failover (survivor)", dev)
    # the router spawns no replacement after a death (only a preemption
    # drain does); any spawn would have been topped up with the replicas
    spawned = [e["worker"] for e in router.autoscale_events
               if e["action"] == "spawn"]
    replicas = srv.status()["cluster"][name]["replicas"]
    assert set(spawned) <= set(replicas), (spawned, replicas)
    out = {"phase": "cluster_serving_failover",
           **answers_summary(answers, seconds),
           "lost_worker": lost["worker"],
           "moved_requests": moved, "moved_latency_s": moved_s,
           "failover_events": len(events), "respawned": spawned,
           "replicas": replicas, "max_abs_err_vs_eager": err,
           "forwards": dev["forwards"], "captures": dev["captures"],
           "launches": dev["launches"],
           "launches_by_body": dev["launches_by_body"],
           "launches_cover": "the surviving worker (the killed one's "
                             "counts die with it)",
           "health": mon.counters()}
    emit(out)
    return out


def cluster_serving_path(s, kernels, rows, eager, in_process):
    """The three cluster serving phases on one router of 2 workers sharing
    the card (the settings of serving_path, taken by the workers at their
    spawn), then the router shut down: its merged report's ``serving``
    section and no worker left."""
    import multiprocessing

    from sparkdl_tpu_torch import serving
    from sparkdl_tpu_torch.cluster import router as cluster_router
    from sparkdl_tpu_torch.serving import cluster as serving_cluster

    s.EngineConfig.device = "cuda"
    s.EngineConfig.pallas_kernels = "force"
    s.EngineConfig.inference_precision = "bfloat16"
    s.EngineConfig.coalesce = True
    s.EngineConfig.serving_warmup = True
    s.EngineConfig.bucket_ladder = "pow2"
    s.EngineConfig.cluster_workers = 2
    s.EngineConfig.serving_cluster = True
    phases = {}
    t0 = time.perf_counter()
    try:
        reg = serving.ModelRegistry()
        srv = serving.ModelServer(reg)
        phases["cluster_serving_predict"], name = cluster_serving_predict(
            s, kernels, reg, srv, rows, eager, in_process)
        phases["cluster_serving_cutover"] = cluster_serving_cutover(
            s, kernels, reg, srv, rows, eager, name)
        phases["cluster_serving_failover"] = cluster_serving_failover(
            s, kernels, reg, srv, rows, eager, name)
        router = cluster_router.maybe_router()
        cluster_router.shutdown()
    finally:
        s.EngineConfig.cluster_workers = 0
        s.EngineConfig.serving_cluster = False
        s.EngineConfig.serving_warmup = False
        s.EngineConfig.bucket_ladder = "tuned"
        cluster_router.shutdown()
        serving_cluster.reset()
    for w in router._workers:
        w.proc.join(timeout=30)
        assert not w.proc.is_alive(), f"{w.proc.name} still runs"
    assert not [p for p in multiprocessing.active_children()
                if p.name.startswith("sparkdl-cluster")]
    rep = cluster_router.last_cluster_report()
    srv_rep = rep["serving"]
    fail = phases["cluster_serving_failover"]
    assert srv_rep["router"]["failovers"] == fail["failover_events"]
    assert srv_rep["router"]["cutovers"] == 2
    emit({"phase": "cluster_serving_report",
          "seconds_all_phases": time.perf_counter() - t0,
          "router": {k: v for k, v in srv_rep["router"].items()
                     if k != "moved_latency_s"},
          "workers": {w: {k: v[k] for k in ("predicts", "errors",
                                            "resident_bytes")}
                      for w, v in srv_rep["workers"].items()},
          "lost_workers": rep.get("trace", {}).get("span_rings_lost"),
          "worker_count": rep["worker_count"]})
    return phases


AUTOTUNE_PHASES = [
    ("featurize_native_autotune", ("Xception", "named"), TARGET, BF16_REL,
     "bfloat16"),
    ("inception_module_native_autotune", ("InceptionV3", "module"), TARGET,
     BF16_REL, "bfloat16"),
    ("featurize_native_autotune_f32", ("Xception", "named"), TARGET, F32_REL,
     "float32"),
    ("inception_module_native_autotune_f32", ("InceptionV3", "module"),
     TARGET, F32_REL, "float32"),
    # the registry's dtype: the module computes in bf16 and stays
    # kernel-routable, so its bf16 sites are auditioned as the reference's
    ("featurize_module_bf16_autotune", ("Xception", "module_bf16"), TARGET,
     BF16_REL, "float32"),
    # int8 keeps the model kernel-routable, as the reference's does: its
    # bf16 sites are auditioned
    ("featurize_native_int8_autotune", ("Xception", "named"), TARGET,
     BF16_REL, "int8"),
]


TRAIN_CLASSES = 10
TRAIN_BATCH = 32
TRAIN_BATCHES = 12     # an epoch; 2 epochs = 24 steps
TRAIN_LR = 1e-4
TRAIN_STEP_REL = 1e-4  # one float32 step, card against CPU
TRAIN_PREEMPT_AT = 13
TRAIN_CKPT_EVERY = 8


def train_net(seed=SEED):
    """``Xception(classes=10)`` behind the registry's preprocessing for
    Xception, with Flax's default initializers from a seeded generator."""
    from sparkdl_tpu_torch.models import layers, registry
    from sparkdl_tpu_torch.models.xception import Xception

    preprocess = registry.get_model_spec("Xception").preprocess

    class TrainNet(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.net = Xception(classes=TRAIN_CLASSES)

        def forward(self, x):
            return self.net(preprocess(x))

    model = TrainNet()
    gen = torch.Generator().manual_seed(seed)
    for sub in model.modules():
        if isinstance(sub, (layers.Conv2d, layers.Dense)):
            layers.lecun_normal_(sub.weight, gen)
    return model


def train_batches(n=TRAIN_BATCHES, batch=TRAIN_BATCH, seed=SEED):
    """Seeded 299×299 uint8 images, each tinted by its class's colour, and
    one-hot labels of the 10 classes."""
    rng = np.random.default_rng(seed + 7)
    ids = rng.integers(0, TRAIN_CLASSES, n * batch)
    x = rng.integers(0, 128, size=(n * batch, *TARGET, 3), dtype=np.uint8)
    tint = (np.arange(TRAIN_CLASSES)[:, None]
            * np.array([37, 71, 113])) % 128
    x += tint.astype(np.uint8)[ids][:, None, None, :]
    y = np.eye(TRAIN_CLASSES, dtype=np.float32)[ids]
    return [(x[i * batch:(i + 1) * batch], y[i * batch:(i + 1) * batch])
            for i in range(n)]


def ours_launched(kernels) -> dict:
    counts, by_body = launch_counts(kernels)
    return {"launches": counts, "launches_by_body": by_body}


def train_step_vs_cpu(s, kernels, batches):
    """One float32 SGD step from one seeded state on the card and on the
    CPU: the loss and every param and buffer after it."""
    from sparkdl_tpu_torch.train import Trainer

    x, y = batches[0][0][:4], batches[0][1][:4]
    kernels.reset_launches()
    got = {}
    for device in ("cpu", "cuda"):
        trainer, state = Trainer.from_module(
            train_net(), optimizer="sgd", learning_rate=0.01, device=device)
        step = trainer.make_train_step()
        xd = torch.from_numpy(x).to(device).float()
        yd = torch.from_numpy(y).to(device)
        t0 = time.perf_counter()
        state, metrics = step(state, xd, yd)
        loss = float(metrics["loss"])
        got[device] = (loss, time.perf_counter() - t0,
                       {k: v.detach().cpu() for k, v in
                        {**state.params, **state.model_state}.items()})
        del trainer, state
    (cpu_loss, cpu_s, cpu), (gpu_loss, gpu_s, gpu) = got["cpu"], got["cuda"]
    worst, worst_rel, worst_name = 0.0, 0.0, None
    for name, ref in cpu.items():
        err = float((gpu[name] - ref).abs().max())
        rel = err / max(1.0, float(ref.abs().max()))
        if rel > worst_rel:
            worst, worst_rel, worst_name = err, rel, name
    loss_rel = abs(gpu_loss - cpu_loss) / abs(cpu_loss)
    out = {"phase": "train_step_vs_cpu", "model": "Xception",
           "classes": TRAIN_CLASSES, "batch": 4, "optimizer": "sgd",
           "learning_rate": 0.01, "tensors": len(cpu),
           "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
           "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
           "loss_cpu": cpu_loss, "loss_card": gpu_loss,
           "loss_rel_err": loss_rel, "max_abs_err": worst,
           "max_rel_err": worst_rel, "worst_tensor": worst_name,
           "tolerance_rel": TRAIN_STEP_REL, "card_step_s": gpu_s,
           "cpu_step_s": cpu_s, **ours_launched(kernels)}
    emit(out)
    assert loss_rel <= TRAIN_STEP_REL, out
    assert worst_rel <= TRAIN_STEP_REL, out
    assert not any(out["launches"].values()), out["launches"]
    return out


def timed_fit(trainer, state, batches, profile_fit=False, **kw):
    """``trainer.fit`` with a CUDA event recorded after each step (the
    card's step intervals, no host sync added), optionally under
    ``torch.profiler`` (CUDA activity) for the card's idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    events = []
    inner = trainer.make_train_step()

    def step(st, x, y):
        out = inner(st, x, y)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        return out

    trainer.make_train_step = lambda: step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    busy_ms = None
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    if profile_fit:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            state = trainer.fit(state, batches, **kw)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        by_kernel = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                            for e in prof.key_averages()
                            if e.device_type == DeviceType.CUDA
                            and e.self_device_time_total > 0
                            and not getattr(e, "is_user_annotation",
                                            False)),
                           key=lambda k: -k[1])
        busy_ms = sum(ms for _, ms, _ in by_kernel)
    else:
        state = trainer.fit(state, batches, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    del trainer.make_train_step
    steps = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    stats = dict(trainer.fit_stats)
    n_steps = max(1, len(events))
    out = {"fit_s": wall, "steps": stats["steps"],
           "first_step_ms": (start.elapsed_time(events[0]) if events
                             else None),
           "host_syncs": stats["syncs"],
           "host_syncs_per_step": stats["syncs"] / max(1, stats["steps"]),
           "step_ms": percentiles(steps),
           "step_ms_mean": float(np.mean(steps)) if steps else None,
           "peak_memory_allocated_mib":
               torch.cuda.max_memory_allocated() / 2 ** 20,
           "checkpoint_save_ms": [t * 1e3
                                  for t in stats["checkpoint_save_s"]]}
    if busy_ms is not None:
        # the whole fit's, its first step (lazy kernel loads, first
        # allocations) included; and the steady steps' estimate: the
        # device's mean busy ms a step against the mean step interval
        out.update(device_busy_ms=busy_ms,
                   top_kernels=[{"name": k[:110], "ms_per_step": ms / n_steps,
                                 "calls_per_step": c / n_steps,
                                 "share": ms / busy_ms}
                                for k, ms, c in by_kernel[:15]],
                   idle_share=1.0 - busy_ms / (wall * 1e3),
                   steady_idle_share_est=(
                       1.0 - busy_ms / len(events) / out["step_ms_mean"]
                       if steps else None))
    return state, out


def train_fit_phase(s, kernels, name, batches, compute_dtype=None):
    """``Trainer.from_module`` → ``fit``: 2 epochs, adam, profiled."""
    from sparkdl_tpu_torch.train import MetricsLogger, Trainer

    kernels.reset_launches()
    trainer, state = Trainer.from_module(
        train_net(), optimizer="adam", learning_rate=TRAIN_LR,
        compute_dtype=compute_dtype, device="cuda")
    log = MetricsLogger(sinks=[lambda r: None])
    state, fit = timed_fit(trainer, state, batches, profile_fit=True,
                           epochs=2, metrics_logger=log, sync_every=8,
                           prefetch=2)
    losses = [r["loss"] for r in log.history]
    images = len(losses) * TRAIN_BATCH
    floats = {"params": {str(p.dtype) for p in state.params.values()},
              "moments": {str(t.dtype) for slot in ("mu", "nu")
                          for t in state.opt_state[slot].values()},
              "model_state": {str(b.dtype)
                              for b in state.model_state.values()}}
    out = {"phase": name, "model": "Xception", "classes": TRAIN_CLASSES,
           "source_size": list(TARGET), "batch": TRAIN_BATCH,
           "optimizer": "adam", "learning_rate": TRAIN_LR,
           "compute_dtype": str(compute_dtype or torch.float32),
           "epochs": 2, "sync_every": 8, "prefetch": 2,
           "losses": losses, "accuracy_last": log.history[-1]["accuracy"],
           "images": images, "images_per_s": images / fit["fit_s"],
           "steady_images_per_s": (TRAIN_BATCH * 1e3
                                   / fit["step_ms"]["p50"]),
           "dtypes": {k: sorted(v) for k, v in floats.items()},
           "profiled": True, **fit, **ours_launched(kernels)}
    emit(out)
    assert len(losses) == 2 * TRAIN_BATCHES and np.isfinite(losses).all()
    assert np.mean(losses[-4:]) < np.mean(losses[:4]), \
        f"{name}: the loss did not descend: {losses}"
    assert all(v == ["torch.float32"] for v in out["dtypes"].values()), \
        f"{name}: masters, moments or statistics left float32: {floats}"
    assert not any(out["launches"].values()), \
        f"{name}: a kernel of ours launched in train mode"
    return out, trainer, state


def keeping_checkpoints(directory):
    """A CheckpointManager that also keeps, in memory, the host copy of
    each state it saved: what a restore must give back bit for bit."""
    from sparkdl_tpu_torch.train import CheckpointManager
    from sparkdl_tpu_torch.train.checkpoint import to_host

    class Keeping(CheckpointManager):
        def __init__(self, d):
            super().__init__(d)
            self.kept = {}

        def save(self, step, state, synchronous=False):
            self.kept[int(step)] = to_host(state)
            return super().save(step, state, synchronous)

    return Keeping(directory)


def _tree_equal(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_tree_equal(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_tree_equal, a, b))
    return a == b


def train_resume(s, kernels, batches):
    """Preempted at step 13 with checkpoints every 8 steps, resumed, held
    against an uninterrupted fit under deterministic algorithms."""
    from sparkdl_tpu_torch.core.resilience import (
        Fault, FaultInjector, InjectedFault,
    )
    from sparkdl_tpu_torch.train import Trainer
    from sparkdl_tpu_torch.train.checkpoint import to_host

    def fresh():
        return Trainer.from_module(train_net(), optimizer="adam",
                                   learning_rate=TRAIN_LR, device="cuda")

    kw = dict(epochs=2, sync_every=8, prefetch=2)
    kernels.reset_launches()
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    root = tempfile.mkdtemp(prefix="sparkdl_train_ckpt_")
    try:
        trainer, ref = fresh()
        ref, ref_fit = timed_fit(trainer, ref, batches, **kw)
        ckpt = keeping_checkpoints(os.path.join(root, "run"))
        trainer, state = fresh()
        with FaultInjector.seeded(0, preemption=Fault(
                when=lambda c: c["step"] == TRAIN_PREEMPT_AT)) as inj:
            try:
                timed_fit(trainer, state, batches, checkpoint=ckpt,
                          checkpoint_every=TRAIN_CKPT_EVERY, **kw)
            except InjectedFault:
                pass
        fired = inj.fired["preemption"]
        first = dict(trainer.fit_stats)
        saved = ckpt.latest_step()
        _, template = fresh()
        t0 = time.perf_counter()
        restored = ckpt.restore(template)
        restore_s = time.perf_counter() - t0
        restored_equal = _tree_equal(to_host(restored), ckpt.kept[saved])
        trainer, resumed = fresh()
        resumed, resume_fit = timed_fit(trainer, resumed, batches,
                                        checkpoint=ckpt, **kw)
        redone = first["steps"] + resume_fit["steps"] - 2 * TRAIN_BATCHES
        step_bytes = ckpt.step_bytes(saved)
        sync_dir = keeping_checkpoints(os.path.join(root, "sync"))
        t0 = time.perf_counter()
        sync_dir.save(int(resumed.step), resumed, synchronous=True)
        sync_save_s = time.perf_counter() - t0
        sync_dir.close()
        ckpt.close()
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
        import shutil

        shutil.rmtree(root, ignore_errors=True)
    diffs = {k: float((resumed.params[k] - ref.params[k]).abs().max()
                      .detach()) for k in ref.params}
    bit_for_bit = all(torch.equal(resumed.params[k], ref.params[k])
                      for k in ref.params)
    bound = 2 * TRAIN_LR * 2 * TRAIN_BATCHES
    out = {"phase": "train_resume", "preempted_at": TRAIN_PREEMPT_AT,
           "fired": fired, "checkpoint_every": TRAIN_CKPT_EVERY,
           "resumed_from": saved, "steps_first_run": first["steps"],
           "steps_resumed_run": resume_fit["steps"], "steps_redone": redone,
           "restored_equals_saved": restored_equal, "restore_s": restore_s,
           "deterministic": "use_deterministic_algorithms(warn_only) + "
                            "cudnn.deterministic",
           "final_bit_for_bit": bit_for_bit,
           "final_max_abs_diff": max(diffs.values()),
           "final_tensors_differing": sum(d > 0 for d in diffs.values()),
           "tolerance_abs": bound,
           "checkpoint_save_ms_in_loop": first["checkpoint_save_s"]
           and [t * 1e3 for t in first["checkpoint_save_s"]],
           "checkpoint_sync_save_ms": sync_save_s * 1e3,
           "checkpoint_bytes": step_bytes,
           "uninterrupted_step_ms": ref_fit["step_ms"],
           "resumed_step_ms": resume_fit["step_ms"],
           **ours_launched(kernels)}
    emit(out)
    assert fired == 1 and saved == TRAIN_CKPT_EVERY, out
    assert restored_equal, "the restored step differs from the saved one"
    assert 0 <= redone <= TRAIN_CKPT_EVERY, out
    assert int(resumed.step) == 2 * TRAIN_BATCHES, out
    assert bit_for_bit or out["final_max_abs_diff"] <= bound, out
    return out


def train_featurize(s, kernels, weights, batches):
    """The trained weights featurized through the hand-written sep2d, held
    against the plain layers; a grad-recording forward refused."""
    from sparkdl_tpu_torch.core import health

    images = list(batches[0][0])
    s.EngineConfig.device = "cuda"
    s.EngineConfig.inference_precision = "bfloat16"
    feat, df = featurize(s, ("Xception", "named"), images, weights, BATCH)
    rows = {}
    counts = {}
    for mode in ("force", "off"):
        s.EngineConfig.pallas_kernels = mode
        feat.transform(df).collect()           # warm-up: captures
        kernels.reset_launches()
        with health.HealthMonitor("train_featurize"):
            t0 = time.perf_counter()
            got = feat.transform(df).collect()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        rows[mode] = (row_vectors(got)[0], seconds)
        counts[mode] = ours_launched(kernels)
    s.EngineConfig.pallas_kernels = "force"
    gpu, ref = rows["force"][0], rows["off"][0]
    err = float(np.max(np.abs(gpu - ref)))
    limit = BF16_REL * float(np.max(np.abs(ref)))
    forwards = -(-len(images) // BATCH)
    mf = model_function(s, feat).to("cuda")  # the float32 module
    x = torch.from_numpy(np.stack(images[:2])).to("cuda").float()
    x.requires_grad_(True)
    try:
        mf(x)
        refused = None
    except ValueError as e:
        refused = str(e)[:200]
    out = {"phase": "train_featurize", "model": "Xception",
           "weights": "train_f32's variables_of", "images": len(images),
           "batch_size": BATCH, "precision": "bfloat16",
           "pallas_kernels": "force", "forwards": forwards,
           "seconds": rows["force"][1], "plain_seconds": rows["off"][1],
           "images_per_s": len(images) / rows["force"][1],
           "plain_images_per_s": len(images) / rows["off"][1],
           "max_abs_err_vs_plain": err, "tolerance": limit,
           "feature_max_abs": float(np.max(np.abs(ref))),
           "grad_recording_forward": refused,
           "plain_launches": counts["off"]["launches"], **counts["force"]}
    emit(out)
    assert gpu.shape == (len(images), 2048) and np.isfinite(gpu).all()
    assert out["launches"]["sep2d"] == 34 * forwards, out["launches"]
    assert out["launches_by_body"]["sep2d"]["wgmma"] == 34 * forwards
    assert not any(out["plain_launches"].values()), out["plain_launches"]
    assert err <= limit, f"train_featurize: {err} > {limit}"
    assert refused is not None and "no backward" in refused, refused
    return out


def train_path(s, kernels):
    """The training phases, in order; the f32 fit's weights feed the
    featurize phase."""
    batches = train_batches()
    phases = {"train_step_vs_cpu": train_step_vs_cpu(s, kernels, batches)}
    phases["train_f32"], trainer, state = train_fit_phase(
        s, kernels, "train_f32", batches)
    weights = {k[len("net."):]: v.detach().cpu()
               for k, v in trainer.variables_of(state).items()}
    del trainer, state
    phases["train_bf16"] = train_fit_phase(
        s, kernels, "train_bf16", batches, torch.bfloat16)[0]
    phases["train_resume"] = train_resume(s, kernels, batches)
    phases["train_featurize"] = train_featurize(s, kernels, weights,
                                                batches)
    torch.cuda.empty_cache()
    return phases


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke run needs an "
              "NVIDIA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    emit({"phase": "environment", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(),
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
          "nvidia_smi": smi})

    import sparkdl_tpu_torch as s
    from sparkdl_tpu_torch.core import cuda_build, kernels
    from sparkdl_tpu_torch.experiments import probe

    from sparkdl_tpu_torch.native import loader

    t0 = time.perf_counter()
    # the native image loader builds beside the kernels where its headers
    # are found (then a failed build is an error); elsewhere its failed
    # attempt is timed and its reason printed, and Pillow decodes
    headers = loader_headers()
    native = all(headers.values())
    per_source = cuda_build.build_all(cuda_build.KERNEL_SOURCES
                                      + (("image_loader",) if native else ()))
    t1 = time.perf_counter()
    built = loader.available()
    loader_s = per_source.pop("image_loader", time.perf_counter() - t1)
    assert built or not native, \
        f"the native loader did not build: {loader.unavailable_reason}"
    ptxas = [line.strip() for n in per_source
             for line in cuda_build.build_log(n).splitlines()
             if "registers" in line or "spill" in line]
    with concurrent.futures.ThreadPoolExecutor(len(per_source)) as pool:
        hgmma = dict(zip(per_source, pool.map(sass_hgmma, per_source)))
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_s": per_source, "sass_hgmma": hgmma, "ptxas": ptxas,
          "image_loader": {"headers": headers, "built": built,
                           "seconds": loader_s,
                           "why_not": loader.unavailable_reason}})
    assert hgmma["sep2d"] > 0 and hgmma["pw1x1"] > 0, \
        f"no HGMMA in the tensor-core kernels' SASS: {hgmma}"

    dev = torch.device("cuda")
    s.EngineConfig.pallas_kernels = "force"
    sep_rows = check_sep2d(kernels, dev)
    pw_rows = check_pw1x1(kernels, dev)
    pre_rows = check_preproc(kernels, dev)
    preproc_audition(kernels, dev)
    odd_rows = check_unaligned_bodies(kernels, dev)
    probe_rows = check_probes(probe, dev)

    record_streams()
    phases = {name: main_path(s, kernels, name, model, size, per_forward,
                              tol)
              for name, model, size, per_forward, tol in PHASES}
    # one partition of 40 images at batch 16: chunks of 16, 16 and 8, so
    # two graphs (rungs 16 and 8) and the staging thread runs
    name = "featurize_native_multichunk"
    phases[name] = main_path(s, kernels, name, ("Xception", "named"),
                             TARGET, {"sep2d": 34}, BF16_REL, n_images=40)
    assert phases[name]["rungs"] == [8, 16], phases[name]["rungs"]
    assert phases[name]["prefetch"]["threaded"] == 1 \
        and phases[name]["prefetch"]["staged"] == 3, phases[name]["prefetch"]

    # The user's default: each phase with a fresh verdict store; the
    # auditions on the card are counted, and their seconds summed, where
    # ensure_verdict calls them (the phase's CPU reference run settles
    # its own CPU sites, which reject without timing anything).
    auditions = []
    audition = kernels._audition

    def counted_audition(site, device):
        verdict = audition(site, device)
        if torch.device(device).type == "cuda":
            auditions.append(verdict["audition_s"])
        return verdict

    kernels._audition = counted_audition
    stores = {}
    for name, model, size, tol, precision in AUTOTUNE_PHASES:
        stores[name] = tempfile.mkdtemp(prefix="sparkdl_verdicts_")
        os.environ[kernels.COMPILE_CACHE_DIR_ENV] = stores[name]
        kernels.reset()
        before = len(auditions)
        phases[name] = main_path(s, kernels, name, model, size, None, tol,
                                 mode="autotune", precision=precision)
        phases[name]["auditions"] = len(auditions) - before
        phases[name]["audition_s"] = sum(auditions[before:])
        emit({"phase": f"{name}_first_sight", "auditions":
              phases[name]["auditions"],
              "audition_s": phases[name]["audition_s"],
              "warmup_s": phases[name]["warmup_s"],
              "seconds_per_pass": phases[name]["seconds"]})
        if precision == "bfloat16":
            assert phases[name]["auditions"] == 0 \
                and not any(phases[name]["launches"].values()), \
                f"{name}: bf16 auditioned or launched a kernel"
        else:
            assert phases[name]["auditions"] > 0, \
                f"{name}: nothing auditioned"
    name, model, size, tol, precision = AUTOTUNE_PHASES[2]
    os.environ[kernels.COMPILE_CACHE_DIR_ENV] = stores[name]
    kernels.reset()
    before = len(auditions)
    again = main_path(s, kernels, f"{name}_from_store", model, size, None,
                      tol, mode="autotune", precision=precision)
    settled = len(again["verdicts"])
    emit({"phase": "verdict_store_check", "store": stores[name],
          "sites_settled": settled, "auditions": len(auditions) - before,
          "warmup_s": again["warmup_s"]})
    assert settled > 0 and len(auditions) == before, \
        "the store did not settle every site"
    assert [v["adopted"] for v in again["verdicts"]] \
        == [v["adopted"] for v in phases[name]["verdicts"]]
    kernels._audition = audition
    del os.environ[kernels.COMPILE_CACHE_DIR_ENV]

    # the 224×224 models (and TestNet), their deeper members, and
    # ResNet's fast apply beside its module
    for name, model, size, per_forward, tol, mode, precision in ZOO_PHASES:
        phases[name] = main_path(s, kernels, name, model, size, per_forward,
                                 tol, mode=mode, precision=precision)
    assert phases["resnet50_native"]["verdicts"] == [], \
        "resnet50_native: bf16 collected kernel sites"
    for name in DEPTH_CHECKS:
        main_path(s, kernels, f"depth_{name}", (name, "named"), (224, 224),
                  {}, BF16_REL, n_images=BATCH)
    resnet_fast_vs_module(dev)

    # int8 weight-only quantization over the bf16 phases' weights
    for name, model, size, per_forward, tol, against in INT8_PHASES:
        phases[name] = main_path(s, kernels, name, model, size, per_forward,
                                 tol, precision="int8",
                                 feat=FEATURIZERS[against])
        int8_weights(s, phases, name, size, against)

    # partition-parallel featurize: each frame coalesced and not, then
    # the resilience paths
    part_frame = None
    for (name, model, size, per_forward, tol, mode,
         precision) in PARTITIONED_PHASES:
        coalesced, plain, df, feat, cpu = partitioned_path(
            s, kernels, name, model, size, per_forward, tol, mode,
            precision)
        phases[name] = coalesced
        phases[f"{name}_uncoalesced"] = plain
        if name == "featurize_partitioned":
            part_frame = (feat, df)
            part_cpu = cpu
    # the same frame streamed, at two prefetches, then left early
    (phases["featurize_streamed"], phases["featurize_streamed_prefetch7"],
     phases["stream_early_break"]) = streamed_path(
        s, kernels, *part_frame, part_cpu, BF16_REL)
    phases["oom_rechunk"] = oom_rechunk(s, kernels, part_frame)
    # image files → readImages → featurize, the decode pool, the host
    # downscale and decode faults
    phases.update(files_path(s, kernels))
    # the flagship workflow: featurize, fit on the card, evaluate, save and
    # load, serve as a SQL UDF; then the classifier at a 16k-image scale
    phases.update(flagship_path(s, kernels))
    phases.update(lr_fit_scale(s, kernels))
    # online serving: predict, hot swap, the live plane under a flood,
    # then residency under a byte budget
    serving_phases, serve_rows, serve_eager = serving_path(s, kernels,
                                                           part_frame)
    phases.update(serving_phases)
    # durable jobs and the cluster plane on the partitioned frame: a
    # durable run killed by SIGKILL and resumed, then 2 and 4 worker
    # processes sharing the card, a worker killed, the merged trace
    phases.update(cluster_path(
        s, kernels, part_frame, part_cpu,
        phases["featurize_partitioned"]["images_per_s"]))
    # the cluster serving plane: replicas of serving_predict's deployment
    # on 2 workers sharing the card, a cutover and a rollback under
    # traffic, a failed prepare, a replica killed under traffic
    phases.update(cluster_serving_path(s, kernels, serve_rows, serve_eager,
                                       phases["serving_predict"]))
    # training: one step against the CPU, float32 and bf16 fits, a
    # preempted fit resumed, the trained weights featurized through sep2d
    phases.update(train_path(s, kernels))
    s.EngineConfig.inference_precision = "bfloat16"
    emit({"phase": "total", "seconds": time.perf_counter() - STARTED})

    def summary(name, source, replaces, rows, headline, by_phase=None,
                on_path=True):
        if by_phase is None:
            by_phase = {p: out["launches"][name] for p, out in phases.items()}
        launches = sum(by_phase.values())
        assert launches > 0 or not on_path, \
            f"{name} never launched on the main path"
        by_body = {}
        for out in phases.values():
            for body, n in out["launches_by_body"].get(name, {}).items():
                by_body[body] = by_body.get(body, 0) + n
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "launches_by_phase": by_phase,
                "launches_by_body": by_body or None,
                **{k: headline[k] for k in ("max_abs_err", "ms", "plain_ms",
                                            "bound_ms", "bound_by",
                                            "library_ms", "shape", "dtype")},
                "kernel_ms": headline["ms"], "shapes": rows}

    def probe_summary(name, line):
        row = probe_rows[name]
        out = summary(name, "sparkdl_tpu_torch/csrc/probes.cu",
                      f"experiments/pallas_probe.py:{line}", [row], row,
                      by_phase={"probe": row["launches"]})
        out.update({k: row[k] for k in ("plan", "ptxas", "sass_hgmma")
                    if k in row})
        return out

    def body_summary(name, source, replaces, rows, headline, body,
                     on_path=True):
        """One body of a kernel: its launches on the main path by phase
        (none for a body only unaligned inputs take), its rows, its
        headline shape."""
        by_phase = {p: out["launches_by_body"][name][body]
                    for p, out in phases.items()}
        out = summary(name, source, replaces, rows, headline, by_phase,
                      on_path)
        out.update(name=f"{name}_{body}", body=body,
                   plan=headline["plan"], ptxas=headline.get("ptxas"))
        return out

    sep_mid = next(r for r in sep_rows
                   if r["shape"][1:] == [19, 19, 728, 728]
                   and r["dtype"] == "bfloat16")
    pw_mid = next(r for r in pw_rows
                  if r["shape"][1:] == [17, 17, 768, 192]
                  and r["dtype"] == "bfloat16")
    sep_f32 = [r for r in sep_rows if r["dtype"] == "float32"]
    pw_f32 = [r for r in pw_rows if r["dtype"] == "float32"]
    emit({"kernels": [
        summary("sep2d", "sparkdl_tpu_torch/csrc/sep2d.cu",
                "sparkdl_tpu/core/kernels.py:454", sep_rows, sep_mid),
        summary("preproc_resize", "sparkdl_tpu_torch/csrc/preproc_resize.cu",
                "sparkdl_tpu/core/kernels.py:586", pre_rows, pre_rows[0]),
        summary("pw1x1", "sparkdl_tpu_torch/csrc/pw1x1.cu",
                "sparkdl_tpu/core/kernels.py:516", pw_rows, pw_mid),
        probe_summary("fma9", 80),
        probe_summary("dw2d", 137),
        probe_summary("sep2d_probe", 160),
        body_summary("sep2d", "sparkdl_tpu_torch/csrc/simt_f32.cuh",
                     "sparkdl_tpu/core/kernels.py:454", sep_f32,
                     next(r for r in sep_f32
                          if r["shape"][1:] == [19, 19, 728, 728]),
                     "simt_f32"),
        body_summary("pw1x1", "sparkdl_tpu_torch/csrc/simt_f32.cuh",
                     "sparkdl_tpu/core/kernels.py:516", pw_f32,
                     next(r for r in pw_f32
                          if r["shape"][1:] == [8, 8, 2048, 448]),
                     "simt_f32"),
        body_summary("sep2d", "sparkdl_tpu_torch/csrc/sep2d.cu",
                     "sparkdl_tpu/core/kernels.py:454", odd_rows[:1],
                     odd_rows[0], "simt_bf16", on_path=False),
        body_summary("pw1x1", "sparkdl_tpu_torch/csrc/pw1x1.cu",
                     "sparkdl_tpu/core/kernels.py:516", odd_rows[1:],
                     odd_rows[1], "mma", on_path=False),
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--durable-child"]:
        sys.exit(durable_child(sys.argv[2]))
    sys.exit(main())
