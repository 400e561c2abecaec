#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``srt_tpu_torch``) once on one NVIDIA GPU.

Usage: ``python3 chip_smoke.py`` from the repository root (no arguments:
every phase, one card).  It imports neither JAX nor the JAX package.

Phases, one line each; the last line is printed only when all pass:

1. Device: the card's name and ``nvidia-smi`` name/power limit.  Exits
   nonzero without a CUDA device.
2. Build: nvcc builds ``srt_tpu_torch/csrc`` into ``build/srt_tpu_torch``.
   With ``cuobjdump``, the instructions each bound counts from the SASS
   (threefry's a point, K2's a slab test) are checked against the build.
3. Kernel vs plain PyTorch version, on the card, at the headline scene's
   tables (101,760 triangles, 50 superclusters) and 65,536 rays per case:
   outputs must be equal; median times of both.  B2 also at tile 32 on
   one tile and on eight (closest and any-hit; some any-hit tile must end
   early); B3 also at G = 8 and G = 1024 and on warps of axis-parallel
   rays (infinite reciprocals, origins on box faces and zero
   coordinates).  B4 also on few groups
   (256 rays at G = 32, so each group's list is split over P > 1
   blocks), at G = 8 and G = 1024 (4,096 rays), and on the sphere's
   tables repeated (every hit an exact tie, which the first copy must
   win; twice, and often enough that lists outgrow the entries the kernel
   stages in shared memory).  B1 also on partly dead tiles (every fourth
   tile dead, half the next) and on the bounce rays at tile 128.  Also the
   counted tiled walk (B2c) there, and the threefry
   lattice kernel at 18 slots x 1M columns (``full`` and ``rows_at``, bit
   for bit).
4. The headline render at full size: ``make_render_plan`` on
   ``uv_sphere(160, 320, radius=2.0)``, 1024x1024, spp 1, max_depth 4,
   probe + schedule discovery, then one untimed frame in which every
   kernel launch is recorded and replayed through its plain version (the
   main path's own inputs and ray counts; outputs must be equal), then
   10 timed frames; overflow 0, a finite image, every kernel of the path
   launched; Mrays/s with ``bench.py``'s accounting.
5. A 128x128 frame from one injected uniform array (numpy seed 0) through
   the kernels and through the plain versions: equal stats, allclose
   image (rtol 1e-4, atol 1e-5).
6. The config8 scene (``bench_suite.py`` config8): ``uv_sphere(360, 700,
   radius=2.0)``, 502,600 triangles in 3,927 clusters, above the stream
   threshold, so the plan walks with the streamed kernels.  (a) B1 (246
   supers; also partly dead tiles and bounce rays), B2s, B3
   (246 supers: four chunks of staged boxes) and B4s against their plain
   versions at 65,536 rays on its tables, B2s at tile 32 on one and eight
   tiles, and B4s on 256 rays at G = 32 (P > 1);
   (b) resident vs streamed kernels on both scenes' tables, same rays,
   equal outputs, ms of both; (c) one untimed 512x512, max_depth 2 frame
   whose every launch is replayed through its plain version and which
   must launch the streamed walks and not the resident ones; (d) 10 timed
   frames: overflow 0, a finite image, Mrays/s.
7. Eval counters (B2c) on the full-frame primaries of both scenes through
   ``model_hit(count_evals=True)``: equal to the plain counters; mean
   supers processed and clusters evaluated per tile.
8. The pair-binned and mask-scan walks on the headline scene.  (a) B5,
   B6 and B7 against their plain versions at 65,536 rays (bounce rays,
   tile 128, a third dead; primaries; shadow segments), B7 on 4,096 rays
   with five live groups (its kernels must split the few tiles' clusters
   into more work items than tiles) and on the sphere's tables repeated
   (exact ties: the first copy must win), and the pair
   tiles of ``binned_pairs`` through B2 against plain B2; (b) the
   headline render with ``walks="tiled@256,binned"``,
   ``walks_shadow="binned"``: one replayed frame and 10 timed frames as
   in phase 4, printing per frame the walk calls that took the pair
   branch, those that fell back, and total / capacity of each call; the
   pair branch must be taken; (c) the same with ``"pg"``; (d)
   ``model_hit(binned=True, pair_factor=1)`` on the bounce rays falls
   back once and equals the tiled walk exactly.
9. The scan integrator (``pathtracer.render``: every bounce at the full
   width, no compaction), ``bench_suite.py``'s forward passes.  (a)
   config1: the default sphere scene, 256x256, 2 bounces, from one
   injected uniform array (numpy seed 1) through ``trace_with_uniforms``
   on the card and on the CPU: equal stats, >= 99.5% of pixels within
   rtol 1e-4 / atol 1e-5; max |err| and the share of pixels that differ.
   (b) config2: ``render_spheres``, 512x512, spp 16, 4 bounces: one
   untimed and 3 timed frames, Mrays/s with config2's accounting (size^2
   x spp x 4 x 2 over the time).  (c) config6: the headline mesh
   (101,760 triangles), 256x256, 2 bounces, bounce re-sort, through
   ``render(mesh_hit_fn(scene, method="walk"))``: one untimed frame whose
   every launch is replayed through its plain version and timed beside its
   bound, its rays traced (the same sample's stats), then 3 timed frames;
   B1, B2 and threefry launched.  (d) config3: ``rubik_grid()``, 512x512,
   camera (0, 20, 20) toward (0, 1, -1), 4 bounces, ``mesh_hit_fn(scene,
   ray_tile=8192)`` (the walk ignores ``ray_tile``, as JAX's does): as
   (c); one supercluster, so B2 and threefry and no B1.  (e) a 256x256
   frame of the sphere scene and the headline mesh through
   ``union_hit_fn``, every launch replayed as in (c): finite, unlike
   either part alone, B1, B2 and threefry launched.  The phase prints its
   seconds.
10. Gradients and the trainer (``bench_suite.py``'s backward passes and
   config10b), ``torch.autograd`` through the scan integrator.  (a)
   config6: d mean(image) / d (mat_diffuse, positions) of the headline
   mesh through ``with_positions`` at 256x256, 2 bounces, bounce re-sort:
   one differentiated frame whose every kernel launch is replayed through
   its plain version, then forward and forward + backward wall seconds
   (median of 3 after a warm call), their ratio, peak
   ``max_memory_allocated``; finite, nonzero gradients; B1, B2 and
   threefry launched.  (b) config10b: ``run_inverse_rendering`` from
   (mat_diffuse * 0.9, positions * 1.001) toward the image of the true
   parameters (key 3), 6 fixed-noise Adam steps at 1e-3: s/step (mean of
   steps 1-5), finite losses.  (c) config2: d mean / d albedo of the
   sphere scene at 512x512, spp 16, 4 bounces.  (d) config3: d mean / d
   mat_diffuse of ``rubik_grid()`` at 512x512, 4 bounces, ``ray_tile``
   8192.  (e) parity: at ``uv_sphere(12, 18)``, 32x32 the walk's
   gradients on the card against the port's CPU run and against the
   dense sweep on the card, on the pixels whose three images agree
   (``GRAD_TOL``, L2);
   ``refit_accel`` of the headline mesh on the card against the host
   build (cluster boxes equal, Woop rows within rtol 2e-4 / atol 2e-5 of
   the triangle's scale) and a config6 frame on the refit tables against
   the uploaded ones (the image criterion of 5).  No kernel has a
   backward: the walks are candidate searches outside the autograd graph.
11. Textures and next-event estimation (``bench_suite.py``'s config9 and
   config11).  (a) config9: the headline mesh with the procedural
   512x512 checker x gradient map in a 6-level mip atlas (``pack_atlas``;
   ``mip_lod_scale`` 512 / (2 pi 2), every material textured), 1024x1024,
   4 bounces, bounce re-sort, ray cones, through ``trace_wavefront`` as
   config9's ``make_run`` calls it: one untimed frame whose every kernel
   launch is replayed through its plain version, then 3 timed frames
   textured and 3 untextured on the same key; Mrays/s and the
   textured/untextured time ratio; a finite image, B1, B2 and threefry
   launched, the atlas tables on the card, and the textured albedo of the
   primary hits unlike Kd.  (b) the textured headline through
   ``make_render_plan`` with ray cones, 1024x1024, 4 bounces: one
   replayed and 3 timed frames (overflow 0, B1-B4 and threefry), and 3
   frames of the untextured plan for the ratio.  (c) config11: the lamp
   and receiver cubes (``pad_to=128``: one supercluster), 512x512, 3
   bounces, ``trace_image_compact`` at the full-width schedule with NEE
   off and on: one replayed frame per arm, then 16 keys
   (``rng.split(rng.key(11), 16)``, JAX's ``jax.random.split``) each:
   frame ms of both arms and their ratio, the relative luminance std on
   the emitter-lit pixels as ``bench_suite.py`` computes it; overflow 0,
   finite images, B2 and threefry launched and B1 not, more shadow
   queries with NEE; a ``make_render_plan`` with ``nee=True`` renders
   one frame with overflow 0.  (d) 64x64 textured
   (``uv_sphere(40, 60)``) and NEE frames on the card against the port's
   CPU run from the same key: equal stats, the image criterion of 9a.
   (e) d mean / d atlas (``quad_pack=False``) and d mean / d
   mat_emissive on the card: finite and nonzero.  The phase prints its
   seconds.
12. The app layer (``srt_tpu_torch.app.RenderSession``).  (a) A
   ``RenderSession(fast=True)`` on the headline mesh at 1024x1024, the
   headline camera, 4 bounces: its probed schedule, 8 frames (launch
   counts zeroed just before and read just after: B1-B4 and threefry,
   launches a frame), frames_accumulated, a finite display in [0, 1];
   then 10 rounds of one frame of a render plan built at the session's
   pose, one ``step(fetch=True)`` and one ``step(fetch=False)``, each
   timed (host clock, ending in ``torch.cuda.synchronize()``): ms a frame,
   fps and Mrays/s from a ``RaysPerSecondMeter`` fed with the plan's
   stats.  (b) ``move(forward=0.5)`` clears the accumulation, and the
   next frame equals, bit for bit, the frame of ``make_render_plan`` at
   ``camera.config(cam)`` from the same folded key.  (c) A session probed
   from (0, 1, -5) facing away from the sphere (the minimum schedule),
   then ``rotate(180, 0)``: the next frame overflows once, is traced again
   at full width (equal bit for bit to the full-width frame at that
   pose), and the schedule stays widened.  (d) One session frame whose
   every kernel launch is replayed through its plain version and timed
   beside its bound.  (e) Sessions on ``uv_sphere(40, 60)`` (the scan
   over the walk) and ``uv_sphere(80, 120)`` (the fast path), 64x64, 2
   frames, a move and a frame, on the card against the CPU: the image
   criterion of 9a on the accumulation buffers.  (f) ``validate_every=2``
   on a headline session: the report is ok; an injected NaN texel is
   healed (count 1).  (g) config10b's trainer with ``checkpoint_path``
   in a temporary directory: 6 steps twice straight, and 3 steps plus a
   resume to 6; the resumed parameters differ from the straight run's by
   no more than the two straight runs differ.  The phase prints its
   seconds.
13. Edge-aware gradients (``bench_suite.py``'s config10a).  (a) config10a:
   ``rubik_grid()`` flattened with ``pad_to=128`` (one supercluster),
   256x256 from (0, 20, 20) toward (0, 1, -1), 2 bounces,
   ``render_edge_aware_mesh(method="walk", search="ring", rings=1)``
   through ``with_positions``: the target from key 7, one forward whose
   every kernel launch is replayed through its plain version and timed
   beside its bound, the forward and the
   forward + backward (median of 3 after a warm call), then 6 fixed-noise
   Adam steps at 2e-3 from positions x 1.002 through
   ``optim.run_inverse_rendering``: s/step (mean of steps 1-5), finite
   losses with min <= first, launches a step (B2 and threefry, no B1),
   peak memory.  (b) One ``trace_edge_aware_mesh`` frame of the headline
   mesh (50 superclusters) at 256x256, walk, ring search, whose every
   kernel launch is replayed through its plain version and timed beside
   its bound: B1, B2 and threefry.  (c) config10a at 32x32 on the card
   and on the CPU: equal primary winners, the image criterion of 9a, and
   the gradients of the image mean over the agreeing pixels within the
   CPU tests' tolerance (rtol 1e-4, atol 1e-4 x max), per welded vertex
   (rows at equal coordinates summed: where two edges are equally near,
   an ulp decides whose corner rows take the gradient).  (d)
   ``uv_sphere(64, 104)`` with vertex normals (13,312 triangles,
   ``pad_to=128``), 64x64, 1 bounce, ``search="global"``,
   ``soft_shadow_band=0.1``: one forward and one forward + backward after
   a warm call, peak memory; card vs CPU at 28x24 as (c).  (e) The sphere
   route: ``trace_edge_aware`` and ``trace_edge_aware_reflection`` of the
   default sphere scene at 256x256 (median of 3), and card vs CPU at
   32x32 as (c) (gradients w.r.t. centres and radii).  The phase prints
   its seconds.
14. Sharded rendering (``srt_tpu_torch.parallel``, ``bench_suite.py``'s
   config5 and config7) and the BVH stack route.  (a) A world of 1 on the
   card (NCCL; ``device_mesh(1, 1)`` starts it on an in-process store):
   config5 (the default sphere scene, 256x256, spp 2, 3 bounces) and
   config7 (``uv_sphere(24, 36)``, ``pad_to=1``, the dense sweep, (0, 1,
   5) toward the origin, 128x128, spp 2, 2 + 1 bounces) through
   ``render_sharded`` on one shard: each image equal bit for bit to the
   unsharded ``trace_wavefront`` of the same ``_draw_uniforms``, threefry
   launched, Mpaths/s with ``bench_suite.py``'s accounting (size^2 x spp
   over the median of 3 calls after a warm call); the 2-, 4- and 8-shard
   rows are printed as not measured (one card).  (b) The sharded walk
   frame: the headline mesh through ``render_sharded(mesh_hit_fn(scene,
   method="walk"))``, the headline camera, 1024x1024, spp 1, 2 bounces:
   one frame whose every kernel launch is replayed through its plain
   version and timed beside its bound (B1, B2 and threefry), then the
   frame ms (median of 3) and its launches.  (c) A world of 2 on the one
   card (gloo, both ranks on ``cuda:0``, started with ``spawn`` after the
   kernels are built, under a time limit): the headline walk frame at
   256x256 and config7 gathered on each rank against the world of 1
   (rtol 1e-5 / atol 1e-6; the pixels not equal bit for bit printed),
   ``render_multihost`` equal to the gathered frame, config7's d
   mean(image^2) / d (mat_diffuse, positions) against the world of 1's
   (rtol 5e-4 / atol 1e-6), B1, B2 and threefry launched on each rank,
   and the host ms of one all-gather of the frame's radiance and one
   all-reduce of config7's gradient buffer; no scaling figure (two ranks
   share one card).  (d) ``wavefront.hit_ids`` on 16,384 headline
   primaries: the BVH ids equal the dense ids; the ms of one BVH, dense
   and walk call each; a ``refit_accel``-ed scene refuses the BVH route.  The
   phase prints its seconds.
15. The port's entry points (``srt_tpu_torch.bench``, ``bench_suite``,
   ``tools``) in this process at the card's full sizes.  (a)
   ``bench.run`` (``bench.main``'s body: 1024x1024, 10 timed frames):
   its JSON line, overflow 0, a finite rate, B1-B4 and threefry
   launched, and its plan's frame for ``rng.key(1)`` equal bit for bit to
   phase 4's plan frame for that key.  (b) ``bench_suite.main`` for each
   of configs 1-11: every line it prints; no ``FAILED`` line, finite
   values, config1's oracle flag (max |err| < 2e-3 against
   ``models/reference_cpu.py``) and the flags of config6, config8 and
   config10 at 1.0, and each config's kernels exactly those of its path
   (config8: the streamed walks B2s and B4s).  (c) ``render_demo`` at
   512x512, spp 4, into a temporary directory (both images written,
   finite, not flat) and ``interactive_session``'s cases (their JSON
   lines, fps finite).  The phase prints its seconds.
16. The measurement tools (``srt_tpu_torch.tools``).  (a) K1
   (``add_one``) on [8, 128], on [8192, 8192], on 1028 floats (a last
   block part filled), and on odd-length and 4-byte-aligned views (its
   scalar path), torch's ``x + 1.0`` beside it at both sizes as its
   library yardstick; K2 (``occupancy_cf``) on 262,144 rays
   component-first, 10 boxes, tile 512, at JAX's g = 8 and 64 (one launch
   on the card), on micro_occ's own normal draws and on ``mixed_data``
   (share of ones in [0.2, 0.8]), then on mixed data at tiles 6 (scalar
   path), 8, 48 and 4096, at C = 1 and 32, and on rows that are not
   16-byte aligned (scalar path): each against its plain version, equal
   exactly.  (b) ``micro_occ.run`` (the path of K1 and K2), and a host
   line from its records: µs a call over 10,000 calls back to back of K1,
   of torch's ``x + 1.0`` and of one B1 ``traversal.cull`` at micro_occ's
   shape.  (c) Every other tool's
   ``run()`` at the card's sizes (1024x1024 headline frames on phase 3's
   scene, 512x512 Rubik frames, ``parity_smoke`` on phase 3's and phase
   6's scenes), reps 3: each tool's printout, its records' times finite
   and positive, its path's kernels launched, every ``parity_smoke`` case
   passing JAX's thresholds, ``eval_counts``' fit, device operations in
   both profiled frames, and ``parse_trace`` agreeing with
   ``profile_fastpath``'s sum.  The phase prints its seconds.
17. The summary: the seconds of all phases, then the ``kernels`` line.

Each path (the headline frames, the config8 frames, the counter run, the
binned frames, the pg frames, the scan frames of phase 9, the backward
passes and the optimizer steps of phase 10, the config9, textured-plan
and config11 frames of phase 11, the session frames of phase 12,
config10a's optimizer steps and the global-search frames of phase 13, the
one-shard config5 and config7 frames, the sharded walk frames and each
rank's walk frame in the world of 2 of phase 14, ``bench``'s frames, each
suite config and each tool of phase 15, each tool of phase 16) is
driven with
the launch counts set to 0 just before it and read just after; every
kernel must be launched by its path.  Each replayed B4/B4s launch also prints its groups, the clusters
its lists name and the split P its wrapper chose; each B7 launch its
groups with work, set bits, tile size K, lanes L, chunk and work items;
each B1 launch its S and live rays; each B3 launch its
groups and the super and cluster tests a two-level cull needs; each
B2/B2s launch its tiles, the supers processed and clusters evaluated
(B2c's counters) and its lanes per ray L.  Every kernel case also
prints its bound: the larger of the bytes
its inputs and outputs must move over 3.35 TB/s and the operations these
inputs need over 67 TFLOP/s (FP32 outside the tensor cores; the H100 SXM
data sheet's peaks), or, for threefry's integer instructions, over the
INT32 issue rate of 16.7 Tops/s.

A kernel's time is its device time (``device_median``: calls enqueued
back to back behind a spin kernel, so the host's dispatch is hidden);
the wrapper time (CUDA events around one call) is printed beside it.
The two agree on large launches; on launches of a few thousand rays the
wrapper time is the host's dispatch.  Plain versions are timed around
one call.

``--profile PATH`` also writes ``torch.profiler`` tables of one more
frame of each render (headline, config8, binned, pg, and phase 9's
config2, config6 and config3, phase 11's config9, textured and
untextured plan and config11 NEE frames) and of phase 10's config6
forward + backward, config2's and config3's, of one step of phase 12's
headline session, of phase 13's config10a forward and forward +
backward and of one sharded walk frame of phase 14 to PATH (the source
of PERF.md section 5).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import inspect
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

TP = "srt_tpu/ops/traversal_pallas.py"
KERNELS = {
    # name: (module, source, what it replaces)
    "cull": ("traversal", "srt_tpu_torch/csrc/cull.cu", f"{TP}:134"),
    "intersect": ("traversal", "srt_tpu_torch/csrc/intersect.cu",
                  f"{TP}:1061"),
    "cull_pg2": ("traversal", "srt_tpu_torch/csrc/cull_pg2.cu", f"{TP}:527"),
    "pgwalk2": ("traversal", "srt_tpu_torch/csrc/pgwalk2.cu", f"{TP}:697"),
    "intersect_stream": ("traversal", "srt_tpu_torch/csrc/intersect.cu",
                         f"{TP}:1061"),
    "pgwalk2_stream": ("traversal", "srt_tpu_torch/csrc/pgwalk2.cu",
                       f"{TP}:697"),
    "intersect_count": ("traversal", "srt_tpu_torch/csrc/intersect.cu",
                        f"{TP}:1061"),
    # Not a TPU kernel: JAX's threefry (XLA), srt_tpu/ops/rng.py:48.
    "threefry": ("rng", "srt_tpu_torch/csrc/threefry.cu",
                 "srt_tpu/ops/rng.py:48"),
    "cull_perray": ("traversal", "srt_tpu_torch/csrc/cull_perray.cu",
                    f"{TP}:284"),
    "cull_gmask": ("traversal", "srt_tpu_torch/csrc/cull_gmask.cu",
                   f"{TP}:436"),
    "pgwalk": ("traversal", "srt_tpu_torch/csrc/pgwalk.cu", f"{TP}:937"),
    # The two kernels of JAX's launch-cost micro-benchmark (phase 16).
    "add_one": ("micro_occ", "srt_tpu_torch/csrc/micro_occ.cu",
                "tools/micro_occ.py:45"),
    "occupancy_cf": ("micro_occ", "srt_tpu_torch/csrc/micro_occ.cu",
                     "tools/micro_occ.py:76"),
}
# The path whose run gives each kernel's launch count.
HEADLINE_PATH = ("cull", "intersect", "cull_pg2", "pgwalk2", "threefry")
CONFIG8_PATH = ("cull", "intersect_stream", "cull_pg2", "pgwalk2_stream",
                "threefry")
COUNTER_PATH = ("intersect_count",)
BINNED_PATH = ("cull", "intersect", "cull_perray", "threefry")
PG_PATH = ("cull", "intersect", "cull_gmask", "pgwalk", "threefry")
HEADLINE_CAMERA = dict(origin=(0.0, 1.0, 5.0), look_at=(0.0, 0.0, 0.0))
# The scan integrator's paths (phase 9).  A one-super model (the Rubik
# grid: 384 triangles, 3 clusters) takes the trivial cluster list and no
# B1 launch, as the JAX package's dispatch does
# (srt_tpu/ops/traversal_pallas.py:1689).
SCAN_MESH_PATH = ("cull", "intersect", "threefry")
ONE_SUPER_PATH = ("intersect", "threefry")
SPHERE_PATH = ("threefry",)
CONFIG3_CAMERA = dict(origin=(0.0, 20.0, 20.0), look_at=(0.0, 1.0, -1.0))
UNION_CAMERA = dict(origin=(0.0, 2.0, 5.0), look_at=(0.0, 0.0, -2.0))
# Sizes: scenes (uv_sphere rows, cols), frame widths, kernel-case rays,
# threefry block columns.
HEADLINE_SPHERE, CONFIG8_SPHERE = (160, 320), (360, 700)
HEADLINE_SIZE, CONFIG8_SIZE = 1024, 512
CASE_RAYS, THREEFRY_COLS = 65536, 1 << 20
# Phase 9 (bench_suite.py's config1, config2, config6 and config3 forward
# passes through the scan integrator, and the union frame): image sizes,
# config2's samples per pixel, config3's ray chunk, timed frames.
CONFIG1_SIZE, CONFIG2_SIZE, CONFIG2_SPP = 256, 512, 16
CONFIG6_SIZE, CONFIG3_SIZE, UNION_SIZE = 256, 512, 256
CONFIG3_RAY_TILE, SCAN_FRAMES = 8192, 3
# Phase 10 (gradients, bench_suite.py's config6/config2/config3 backward
# passes and config10b): timed repetitions after a warm call, config10b's
# optimizer steps, the small config6 of the parity checks (uv_sphere rows,
# cols; image size) and their tolerance: |card - other| / |other| (L2
# norms) of the gradients on the pixels whose images agree, against the
# port's CPU run and the dense sweep on the card (the same paths; only
# rounding and scatter-add order differ).
GRAD_REPS, CONFIG10B_STEPS = 3, 6
GRAD_SMALL_SPHERE, GRAD_SMALL_SIZE = (12, 18), 32
GRAD_TOL = 1e-3
# Phase 11 (textures and NEE, bench_suite.py's config9 and config11):
# config9's image size, map size, mip levels and timed frames a variant;
# the textured plan's size; config11's image size and keys an arm; the
# card-vs-CPU parity frames (uv_sphere rows, cols; image size).
CONFIG9_SIZE, CONFIG9_FRAMES = 1024, 3
TEX_PLAN_SIZE = 1024
CONFIG11_SIZE, CONFIG11_KEYS = 512, 16
PARITY11_SPHERE, PARITY11_SIZE = (40, 60), 64
# Phase 12 (the app layer): the headline session's untimed and timed
# frames, the pose whose probe sees only sky (the session's camera looks
# down -z from its origin, away from the sphere), the card-vs-CPU
# sessions' image size and their second mesh (uv_sphere rows, cols: 10
# superclusters, above the session's fast-path threshold of 8).
SESSION_FRAMES, SESSION_TIMED = 8, 10
OVERFLOW_CAMERA = dict(origin=(0.0, 1.0, -5.0), look_at=(0.0, 1.0, -6.0))
PARITY12_SIZE, SESSION_PARITY_SPHERE = 64, (80, 120)
# Phase 13 (edge-aware gradients, bench_suite.py's config10a): the
# image size and Adam steps of config10a, the multi-super walk frame's
# size, the card-vs-CPU frames' size, the global search's sphere (rows,
# cols) and image sizes (the card's frame, the card-vs-CPU frame), the
# sphere route's frame size.
CONFIG10A_SIZE, CONFIG10A_STEPS = 256, 6
EA_WALK_SIZE, EA_PARITY_SIZE = 256, 32
GLOBAL_SPHERE, GLOBAL_SIZE, GLOBAL_PARITY = (64, 104), 64, (28, 24)
EA_SPHERE_SIZE = 256
# Phase 14 (sharded rendering, bench_suite.py's config5 and config7, and
# the BVH route): config5's and config7's image sizes, the sharded walk
# frame's size in the world of 1 and in the world of 2, the BVH route's
# primaries (a square image of that side), the world of 2's time limit in
# seconds (spawn to join; each rank's rendezvous and collectives too).
CONFIG5_SIZE, CONFIG7_SIZE = 256, 128
SHARD_WALK_SIZE, WORLD2_WALK_SIZE = 1024, 256
BVH_SIZE, WORLD2_TIMEOUT = 128, 300.0
# Phase 15 (the entry points): ``render_demo``'s image size and samples,
# ``interactive_session``'s headline sizes and timed frames a case (the
# tools' defaults).
DEMO_SIZE, DEMO_SPP = 512, 4
SESSION_SIZES, SESSION_CASE_FRAMES = (1024, 512, 256), 12
# Phase 16 (the measurement tools): K2's rays, boxes, tile and tiles a
# block (micro_occ's), the tools' headline and Rubik frame sizes and
# repetitions, parity_smoke's (camera side, random rays) a scene (its own
# defaults when None).
OCC_N, OCC_BOXES, OCC_TILE, OCC_GROUPS = 262144, 10, 512, (8, 64)
# K1's large case and the calls back to back of micro_occ's host µs a
# launch; K2's other cases (tile, rays; boxes), on mixed data.
ADD_ONE_LARGE, HOST_REPS = (8192, 8192), 10_000
OCC_TILE_CASES = ((6, 196608), (8, 262144), (48, 196608), (4096, 262144))
OCC_BOX_CASES = (1, 32)
TOOLS_SIZE, TOOLS_RUBIK_SIZE, TOOLS_REPS = 1024, 512, 3
PARITY_SIZES = None
# Phase 16d (the last seven tools, JAX's sizes): micro_gather's,
# micro_soa's and micro_layout's N, micro_binned's random rays, the
# micro_pg2_split dump's bounce indices micro_sortkeys reads (JAX's
# default 2, and 1: the 593,120 live rays of bounce 2), multihost_2proc's
# method.
TOOLS_N, BINNED_RAYS = 512 * 512, 262144
SORTKEY_BOUNCES, MULTIHOST_METHOD = (2, 1), "walk"
# The kernels each tool's run() must launch on the card (phase 16); the
# Rubik grid is one super, so its walks launch no B1.
RUBIK_PATH = ("intersect", "threefry")
TOOL_PATHS = {
    "micro_occ": ("add_one", "occupancy_cf", "cull"),
    "wavefronts": SCAN_MESH_PATH,
    "eval_counts": SCAN_MESH_PATH + ("intersect_count",),
    "profile_bounces": SCAN_MESH_PATH,
    "profile_breakdown": RUBIK_PATH + ("cull",),
    "profile_bench": RUBIK_PATH + ("cull",),
    "profile_frame": RUBIK_PATH,
    "profile_scan": RUBIK_PATH,
    "profile_fastpath": HEADLINE_PATH,
    "profile_trace": RUBIK_PATH,
    "parity_smoke": ("cull", "intersect", "cull_pg2", "pgwalk2",
                     "intersect_stream", "pgwalk2_stream"),
    "micro_bounce_real": SCAN_MESH_PATH,
    "micro_pg2_split": SCAN_MESH_PATH + ("cull_pg2", "pgwalk2"),
    "micro_pgwalk": SCAN_MESH_PATH + ("cull_pg2", "pgwalk2", "cull_gmask",
                                      "pgwalk"),
    "micro_binned": ("cull", "cull_perray", "intersect"),
    # The world's ranks render uv_sphere(12, 18), one super: no B1; the
    # parent's one-process render launches what each rank does.
    "multihost_2proc": ONE_SUPER_PATH,
}
# Rays of the few-group B4/B4s cases (8 groups at G = 32), and the list
# entries B4 stages in shared memory (LIST_SH, csrc/pgwalk2.cu).
FEW_RAYS, LIST_STAGED = 256, 256
# The few-group B7 cases: rays (as the pg frame's deep bounces), and the
# groups of 8 that stay live.
FEW_GROUP_RAYS, FEW_LIVE_GROUPS = 4096, (3, 4, 100, 301, 480)
# The case each kernel's entry of the ``kernels`` line reports, where it is
# not the kernel's first: B5's and B6's headline bounce case (phase 8a),
# not config8's, which phase 6a runs before it.
LINE_CASES = {"cull_perray": "bounce (a third dead) rays",
              "cull_gmask": "bounce (a third dead) rays"}
# Outputs of each kernel that are float (compared for max_abs_err too);
# all outputs must be equal.
FLOAT_OUTPUTS = {"cull": (1,), "intersect": (0,), "cull_pg2": (),
                 "pgwalk2": (0,), "intersect_stream": (0,),
                 "pgwalk2_stream": (0,), "intersect_count": (0,),
                 "threefry": (0,), "cull_perray": (0,), "cull_gmask": (),
                 "pgwalk": (0,), "add_one": (0,), "occupancy_cf": ()}
# Bounds: NVIDIA's H100 SXM data-sheet peaks and the
# operations per unit of work, read from the CUDA sources: a slab test
# (traversal_common.cuh ``slab``: 6 subtractions, 6 multiplies, 11
# minima/maxima, 3 compares) per (ray, box); a Woop evaluation
# (``woop_eval`` plus the walk's merge: 43 multiplies and adds, a
# division, 8 compares, minima and sign operations) per (ray, triangle);
# a threefry lattice point: the integer instructions per point of the
# built kernel's SASS (``cuobjdump -sass``, sm_90a; ``threefry_sass_ops``
# checks the two counts below against every build): 72 in all, 70 for the
# 20 rounds of add, rotate and xor, the key injections and schedule and
# the lattice index (21 LOP3, 20 SHF, 18 IMAD.IADD, 9 IADD3, a VIADD and
# an IMAD) and 2 for the float (an xor and a LEA.HI); the per-thread index
# division is the kernel's and not counted.  Which rate each counts
# against: the slab tests and Woop evaluations are float operations, at
# the FP32 rate (67 TFLOP/s, the only CUDA-core rate of the data sheet;
# built with -fmad=false, no multiply-add fuses, so the card issues them
# at most at half that rate).  Threefry's instructions split over two
# pipes that issue side by side: LOP3, SHF, IADD3 and LEA on the integer
# ALU pipe (52 a point), IMAD.IADD, IMAD and VIADD on the FMA pipe (20; a
# VIADD counted there, where it makes the bound the smaller).  Each pipe
# takes 64 lanes per SM a clock (Hopper white paper: 64 INT32 lanes; the
# FMA pipe's integer half), 132 SMs x 64 x 1.98 GHz = 16.7 Tops/s, and a
# point is bound by the busier pipe, the ALU's 52.  K2 (occupancy_cf) the
# same way, from its box loop in the SASS (``occupancy_sass_ops``: one box
# against a thread's 4 rays): FMNMX (min.NaN / max.NaN), FSETP, FSEL and
# logic ops on the ALU pipe at 16.7 Tops/s, FADD and FMUL (no FFMA) on the
# FMA pipe at 128 FP32 lanes an SM a clock (33.5 T instructions/s, half
# the 67 TFLOP/s that counts a multiply-add as two); a test is bound by
# the busier pipe.  B1, B3, B5 and B6 still count SLAB_OPS at 67 TFLOP/s.
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
PEAK_INT32_OPS_S = 132 * 64 * 1.98e9
PEAK_FP32_INSTR_S = PEAK_OPS_S / 2
SLAB_OPS = 26
WOOP_OPS = 52
THREEFRY_ALU_OPS, THREEFRY_FMA_OPS = 52, 20
# K2's instructions a box iteration of its OCC_SASS_RAYS rays a thread (as
# many slab tests) in the vector-path kernel: ALU, FMA.
OCC_SASS_RAYS, OCC_ALU_OPS, OCC_FMA_OPS = 4, 65, 48


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def kernel_module(name):
    from srt_tpu_torch.ops import rng, traversal
    from srt_tpu_torch.tools import micro_occ
    return {"traversal": traversal, "rng": rng,
            "micro_occ": micro_occ}[KERNELS[name][0]]


def as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def timed_median(fn, reps=10):
    """Median CUDA-event time (ms) of ``fn()`` over ``reps`` runs after one
    warm-up; returns (ms, last result)."""
    import torch
    out = fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2], out


_SPIN_CYCLES_PER_MS = []


def spin_cycles_per_ms():
    """Clock cycles per ms of ``torch.cuda._sleep`` on this card, timed
    once."""
    import torch
    if not _SPIN_CYCLES_PER_MS:
        cycles = 20_000_000
        torch.cuda._sleep(cycles // 10)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        torch.cuda._sleep(cycles)
        b.record()
        torch.cuda.synchronize()
        _SPIN_CYCLES_PER_MS.append(cycles / a.elapsed_time(b))
    return _SPIN_CYCLES_PER_MS[0]


def device_median(fn, reps=5):
    """Median device time (ms) of one ``fn()`` call: the kernels of n calls
    run back to back between two CUDA events, enqueued behind a spin
    kernel that lasts until the host has enqueued them all, so the events
    time the kernels and not the host's dispatch (which CUDA events
    around one small call measure instead).  n brings the calls to about
    20 ms.  Returns (ms, n, queued): ``queued`` is False if the spin ended
    before the host had enqueued every call even after three longer
    spins, and the time then holds host gaps."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    call_ms = (time.perf_counter() - t0) * 1e3
    n = max(3, min(50, int(20.0 / call_ms)))
    spin_ms = 2.0 * n * call_ms + 2.0
    times = []
    queued = True
    for _ in range(reps):
        for attempt in range(4):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            torch.cuda._sleep(int(spin_ms * spin_cycles_per_ms()))
            a.record()
            for _ in range(n):
                fn()
            b.record()
            covered = not a.query()
            torch.cuda.synchronize()
            if covered:
                break
            spin_ms *= 2.0
        queued = queued and covered
        times.append(a.elapsed_time(b) / n)
    times.sort()
    return times[len(times) // 2], n, queued


def device_note(n, queued):
    """How a ``device_median`` time was taken, for a printed line."""
    return (f"device, {n} back to back" if queued
            else f"{n} back to back, host-bound: holds host gaps")


def card_line():
    proc = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def compare(name, case, k_out, p_out):
    """Check a kernel's outputs equal its plain version's; returns the max
    abs difference of the float outputs (0.0 when equal)."""
    import torch
    errs = [0.0]
    for q, (a, b) in enumerate(zip(as_tuple(k_out), as_tuple(p_out))):
        if q in FLOAT_OUTPUTS[name]:
            diff = (a - b).abs()
            finite = torch.isfinite(a) & torch.isfinite(b)
            errs.append(float(diff[finite].max()) if finite.any() else 0.0)
            check(torch.equal(torch.isfinite(a), torch.isfinite(b)),
                  f"{name} {case}: output {q} finiteness differs")
        n_bad = int((a != b).sum())
        check(n_bad == 0, f"{name} {case}: output {q} differs from the "
                          f"plain version in {n_bad} entries")
    return max(errs)


def build_scene(device, rows, cols):
    from srt_tpu_torch.models import mesh
    from srt_tpu_torch.utils.flatten import flatten_models
    from srt_tpu_torch.utils.procgen import uv_sphere
    t0 = time.perf_counter()
    scene = mesh.upload(flatten_models([uv_sphere(rows, cols, radius=2.0)],
                                       pad_to=128), device=device)
    return scene, time.perf_counter() - t0


def primary_rays(scene, size, tile):
    """Pixel-centre primary rays of the headline camera at size x size, in
    Morton order, packed for the tiled walk: (origins, dirs, rays8)."""
    import torch

    from srt_tpu_torch.camera import derive_viewport, generate_rays
    from srt_tpu_torch.config import CameraConfig
    from srt_tpu_torch.ops import traversal as tr
    from srt_tpu_torch.ops.morton import morton_perm, permute_rays
    dev = scene.device
    cam = CameraConfig(width=size, height=size, **HEADLINE_CAMERA)
    jit = torch.full((2, size * size), 0.5, device=dev)
    o, d = generate_rays(derive_viewport(cam, device=dev), size, size, jit)
    o, d = permute_rays(o, d, morton_perm(size, size)[0])
    return o, d, tr.pack_rays(scene, 0, o, d, float("inf"), tile)[0]


def walk_rays(scene):
    """Kernel-case rays: primaries (256x256, tile 256) and bounce-like rays
    (``bounce_rays``; tile 128) for closest hits and as shadow segments."""
    from srt_tpu_torch.ops import traversal as tr
    size = int(CASE_RAYS ** 0.5)
    prim8 = primary_rays(scene, size, 256)[2]
    bo, bd, t_closest, t_seg = bounce_rays(scene)
    bounce8, _, _ = tr.pack_rays(scene, 0, bo, bd, t_closest, 128)
    shadow8, _, _ = tr.pack_rays(scene, 0, bo, bd, t_seg, 128, t_lo=1e-3)
    return prim8, bounce8, shadow8


def bounce_rays(scene):
    """CASE_RAYS bounce-like rays: random origins around the sphere aimed
    at points inside it, a third dead, in the integrator's 6-D coherence
    order: (origins [3, N], dirs [3, N], closest-hit t_max, shadow-segment
    t_max)."""
    import numpy as np
    import torch

    from srt_tpu_torch.models.pathtracer import _bounce_sort_keys
    dev = scene.device
    n = CASE_RAYS
    rng = np.random.default_rng(0)
    ro = rng.uniform(-4.0, 4.0, (n, 3)).astype(np.float32)
    ro += np.sign(ro) * 2.0
    rd = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32) - ro
    bo = torch.as_tensor(ro.T.copy(), device=dev)
    bd = torch.as_tensor(rd.T.copy(), device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    alive[::3] = False
    order = torch.argsort(_bounce_sort_keys(bo, bd, alive, 1), stable=True)
    bo, bd, alive = bo[:, order], bd[:, order], alive[order]
    t_closest = torch.where(alive, float("inf"), 0.0)
    seg = torch.as_tensor(rng.uniform(1.0, 6.0, n).astype(np.float32),
                          device=dev)[order]
    t_seg = torch.where(alive, seg, 0.0)
    return bo, bd, t_closest, t_seg


def nbytes(*xs):
    return sum(x.numel() * x.element_size() for x in xs)


def popcount(words):
    """Set bits of the low 16 bits of each word, summed."""
    w = words.long() & 0xFFFF
    return sum(int(((w >> k) & 1).sum()) for k in range(16))


def listed_clusters(clist, bits, counts):
    """Clusters a B4/B4s call walks: the set bits of its listed words."""
    import torch
    listed = (torch.arange(clist.shape[1], device=bits.device)[None, :]
              < counts)
    return popcount(torch.where(listed, bits, 0))


def pgwalk2_split(rays8, clist, group):
    """(groups, threads per block, blocks per group P) of a B4/B4s call
    on these operands, as its wrapper chooses them."""
    import torch

    from srt_tpu_torch.ops import traversal as tr
    n_groups = rays8.shape[0] // group
    sms = torch.cuda.get_device_properties(rays8.device).multi_processor_count
    return (n_groups, *tr.pgwalk2_shape(n_groups, clist.shape[1], group,
                                        sms))


def ptxas_lines(log):
    """nvcc's -Xptxas -v output, one line per kernel: its name (from the
    mangled name: the namespace, then the name, each length-prefixed, and
    an int or bool template argument), its registers and its spills."""
    import re
    out, name, spill = [], "?", ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '_ZN(\d+)(\w+)'", ln)
        if m:  # _ZN <namespace> <name> [I Li<arg> E] E ...
            rest = m.group(2)[int(m.group(1)):]
            n = re.match(r"\d+", rest).group()
            name = rest[len(n):len(n) + int(n)]
            arg = re.match(r"IL[ib](\d+)E", rest[len(n) + int(n):])
            name += f"<{arg.group(1)}>" if arg else ""
        elif "spill" in ln:
            spill = ln.strip()
        elif "registers" in ln:
            out.append(f"{name}: {ln.split(':', 1)[1].strip()}; {spill}")
    return out


def threefry_sass_ops(sass):
    """(ALU-pipe, FMA-pipe) integer instructions per lattice point of the
    built threefry kernel: its SASS (``sass_of``) from after the
    last key or column load to the output store, less uniform-datapath,
    predicated, compare, move, load, store and address instructions and
    the float subtraction; IMAD and VIADD forms count on the FMA pipe."""
    import re
    body = sass.split("threefry_kernel", 1)[1].split("Function :", 1)[0]
    ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]+);", body)
    last_load = max(i for i, t in enumerate(ops) if "LDG" in t)
    store = max(i for i, t in enumerate(ops) if "STG" in t)
    skip = ("U", "@", "ISETP", "LDC", "LDG", "S2R", "STG", "EXIT", "FADD",
            "BRA", "MOV")
    address = {"LEA", "LEA.HI.X", "IMAD.WIDE.U32", "IMAD.MOV.U32", "IMAD.MOV"}
    counted = [t.split()[0] for t in ops[last_load + 1:store]
               if not t.strip().startswith(skip)
               and t.split()[0] not in address]
    fma = sum(op.startswith(("IMAD", "VIADD")) for op in counted)
    return len(counted) - fma, fma


def sass_of(lib_path):
    """The built library's SASS (``cuobjdump -sass``), or None without
    cuobjdump."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    return subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=300).stdout


def occupancy_sass_ops(sass):
    """(ALU-pipe, FMA-pipe) instructions of K2's box loop (one box against
    a thread's rays) in the vector-path kernel's SASS: the loop is the
    backward branch's body with the most FMNMX; FMNMX, FSETP, FSEL, SEL,
    LOP3, PLOP3 and SHF count on the ALU pipe, FADD, FMUL and FFMA on the
    FMA pipe; loop counters, loads and branches are not counted."""
    import re
    fun = next(f for f in sass.split("Function : ")[1:]
               if "19occupancy_cf_kernelILb1EE" in f.split(None, 1)[0])
    addr, labels, ops = {}, {}, []
    pending = []
    for ln in fun.splitlines():
        lab = re.match(r"\s*(\.L_x_\d+):", ln)
        if lab:
            pending.append(lab.group(1))
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+([^;]+);", ln)
        if m:
            a = int(m.group(1), 16)
            for name in pending:
                labels[name] = a
            pending = []
            ops.append((a, m.group(2).strip()))
    for i, (a, _) in enumerate(ops):
        addr[a] = i
    best = None
    for i, (a, text) in enumerate(ops):
        m = re.search(r"BRA\s+(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))", text)
        if not m:
            continue
        target = labels.get(m.group(1)) if m.group(1) else int(m.group(2), 16)
        if target is None or target >= a or target not in addr:
            continue
        body = [re.sub(r"^@!?U?P[T0-9]\s+", "", t).split()[0]
                for _, t in ops[addr[target]:i]]
        fmnmx = sum(op.startswith("FMNMX") for op in body)
        if best is None or fmnmx > best[0]:
            best = (fmnmx, body)
    body = best[1]
    alu = sum(op.split(".")[0] in ("FMNMX", "FSETP", "FSEL", "SEL", "LOP3",
                                   "PLOP3", "SHF") for op in body)
    fma = sum(op.split(".")[0] in ("FADD", "FMUL", "FFMA") for op in body)
    return alu, fma


def pgwalk_split(mask, rays8, woop, any_hit):
    """The work split of a B7 call on these operands, as its kernels
    chose it: one more launch's device plan (``pgwalk_device_plan``),
    checked equal to its host mirror (``traversal.pgwalk_shape``,
    ``traversal.pgwalk_plan``), which also gives the tiles with work.
    Returns a printable summary and the (tiles with work, items) pair."""
    import torch

    from srt_tpu_torch.ops import traversal as tr
    sms = torch.cuda.get_device_properties(rays8.device).multi_processor_count
    k, lanes, min_chunk, target = tr.pgwalk_shape(mask.shape[0], sms)
    cnt, chunk, items = tr.pgwalk_plan(mask, k, min_chunk, target)
    device = tr.pgwalk_device_plan(mask, rays8, woop, any_hit)
    check(device == (chunk, items), f"pgwalk's device plan (chunk, items) "
                                    f"{device}, its host mirror "
                                    f"{(chunk, items)}")
    busy = int((cnt > 0).sum())
    text = (f"{int((mask != 0).any(1).sum())} groups with work, "
            f"{popcount(mask)} set bits, K={k} L={lanes}, {busy} tiles with "
            f"work, chunk {chunk}, {items} items (device plan)")
    return text, busy, items


def cull_tests(args):
    """(super tests, cluster tests) a two-level cull (B3, B6) needs on
    these inputs: S per live ray, and 16 per (live ray, super it enters
    before its t_max), the supers entered counted with B1's slab pass at
    width 1 (``traversal._super_entries``)."""
    from srt_tpu_torch.ops import traversal as tr
    rays8, s = args["rays8"], args["s_count"]
    sbounds = args.get("sbounds")
    if sbounds is None:
        sbounds = tr.super_bounds(args["cb8"], s)
    live = int((rays8[:, 6] > 0).sum())
    entered = int((tr._super_entries(rays8, sbounds, 1) < tr.BIG).sum())
    return live * s, entered * tr.SUPER


def walk_counts(name, args, out):
    """(supers processed, clusters evaluated) of a tiled-walk call: B2c's
    counters on the same inputs."""
    from srt_tpu_torch.ops import traversal as tr
    ctr = out[2] if name == "intersect_count" else tr.intersect_count(
        args["counts"], args["clist"], args["elist"], args["rays8"],
        args["cb"], args["woop"], args["tile"], args["any_hit"],
        stream=name == "intersect_stream")[2]
    return tuple(ctr.sum(0).tolist())


def intersect_lanes(rays8, tile):
    """Lanes per ray of a B2/B2s/B2c call on these operands, as its
    wrapper chooses them."""
    import torch

    from srt_tpu_torch.ops import traversal as tr
    sms = torch.cuda.get_device_properties(rays8.device).multi_processor_count
    return tr.intersect_threads(tile, rays8.shape[0], sms) // tile


def bound_of(name, args, out):
    """(bound_ms, bound_by, work) of one kernel call: the larger of the
    bytes its tensor inputs and outputs must move (each once) over the
    card's memory rate and the operations these inputs need over its FP32
    rate (threefry, K2: their busier pipe's instructions over that
    pipe's rate); ``work`` says what was counted.  The
    walks count the clusters
    their gates admit on these inputs (B2: B2c's counters on the same
    call; B4, B7: the set bits of the words they walk); B1 and B5 count
    the live rays' super slab tests, B3 and B6 the tests of a two-level
    cull (``cull_tests``)."""
    import torch

    from srt_tpu_torch.ops import traversal as tr
    out = as_tuple(out)
    moved = nbytes(*[v for v in args.values() if torch.is_tensor(v)], *out)
    work = ""
    peak = PEAK_OPS_S
    if name == "threefry":
        ops = out[0].numel() * max(THREEFRY_ALU_OPS, THREEFRY_FMA_OPS)
        peak = PEAK_INT32_OPS_S
    elif name == "add_one":
        ops = out[0].numel()
    elif name == "occupancy_cf":
        # The 7 used rows of rays_cf, the 6 box rows and the output once;
        # a slab test per (ray, box) on the busier of its two pipes.
        n, c = args["rays_cf"].shape[1], args["bounds"].shape[1]
        moved = (7 * n + 6 * c) * 4 + nbytes(out[0])
        alu, fma = OCC_ALU_OPS / OCC_SASS_RAYS, OCC_FMA_OPS / OCC_SASS_RAYS
        ops, peak = max((n * c * alu, PEAK_INT32_OPS_S),
                        (n * c * fma, PEAK_FP32_INSTR_S),
                        key=lambda p: p[0] / p[1])
        work = (f"{n * c} slab tests, {alu} ALU-pipe and {fma} FMA-pipe "
                f"instructions each")
    else:
        live = int((args["rays8"][:, 6] > 0).sum())
    if name in ("cull", "cull_perray"):
        ops = live * args["sbounds"].shape[1] * SLAB_OPS
        if name == "cull_perray":
            work = f"{live * args['sbounds'].shape[1]} super tests"
    elif name in ("cull_pg2", "cull_gmask"):
        supers, clusters = cull_tests(args)
        ops = (supers + clusters) * SLAB_OPS
        work = f"{supers} super + {clusters} cluster tests"
    elif name.startswith("intersect"):
        supers, clusters = walk_counts(name, args, out)
        ops = args["tile"] * (supers * tr.SUPER * SLAB_OPS
                              + clusters * tr.CLUSTER * WOOP_OPS)
        work = (f"{supers} supers processed, {clusters} clusters evaluated, "
                f"L={intersect_lanes(args['rays8'], args['tile'])}")
    elif name.startswith("pgwalk2"):
        ops = (listed_clusters(args["clist"], args["bits"], args["counts"])
               * args["group"] * tr.CLUSTER * WOOP_OPS)
    elif name == "pgwalk":
        ops = popcount(args["mask"]) * tr.GROUP * tr.CLUSTER * WOOP_OPS
    b_ms, o_ms = moved / PEAK_BYTES_S * 1e3, ops / peak * 1e3
    return max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations", work


class Cases:
    """Kernel-vs-plain cases, by kernel name."""

    def __init__(self, card):
        self.card = card
        self.results = {k: {"cases": []} for k in KERNELS}

    def run(self, tag, name, case, *args, **kw):
        """Time the kernel wrapper ``name`` on ``args`` and its plain
        version on the same inputs, check them equal, compute the call's
        bound; returns the kernel's output."""
        fn = getattr(kernel_module(name), name)
        bound = inspect.signature(fn).bind(*args, **kw)
        bound.apply_defaults()
        w_ms, k_out = timed_median(lambda: fn(*args, **kw))
        k_ms, n, queued = device_median(lambda: fn(*args, **kw))
        p_ms, p_out = timed_median(lambda: fn(*args, **kw, plain=True))
        err = compare(name, case, k_out, p_out)
        b_ms, b_by, work = bound_of(name, dict(bound.arguments), k_out)
        self.results[name]["cases"].append(dict(
            case=case, ms=k_ms, wrapper_ms=w_ms, plain_ms=p_ms,
            max_abs_err=err, bound_ms=b_ms, bound_by=b_by))
        print(f"[{tag}] {name:16s} {case:40s} kernel {k_ms:9.4f} ms "
              f"({device_note(n, queued)}; wrapper {w_ms:.4f} ms)  plain "
              f"{p_ms:9.3f} ms  bound {b_ms:.5f} ms ({b_by}, "
              f"{100 * b_ms / k_ms:.2f}% reached)  equal (max_abs_err "
              f"{err}){f'  [{work}]' if work else ''}  [{self.card}]",
              flush=True)
        return k_out

    def replayed(self, name, case, p_ms, err):
        self.results[name]["cases"].append(dict(case=case, ms=None,
                                                plain_ms=p_ms,
                                                max_abs_err=err))


def phase_kernels(scene, cases):
    """Phase 3: every resident kernel, B2c and threefry against their plain
    versions on the card."""
    import torch

    from srt_tpu_torch.ops import rng
    from srt_tpu_torch.ops import traversal as tr

    woop, cb, sbounds, cb8, s_count, _ = tr.model_tables(scene, 0)
    prim8, bounce8, shadow8 = walk_rays(scene)
    n = bounce8.shape[0]
    clist, elist, counts = cases.run(3, "cull", "primary tile 256", prim8,
                                     sbounds, 256)
    cull_cases(3, "", prim8, bounce8, sbounds, cases)
    for any_hit in (False, True):
        kind = "any" if any_hit else "closest"
        cases.run(3, "intersect", f"primary tile 256 {kind}-hit", counts,
                  clist, elist, prim8, cb, woop, 256, any_hit)
    few_tile_cases(3, "intersect", scene, woop, cases)
    for group in (128, 32):
        for any_hit, rays8 in ((False, bounce8), (True, shadow8)):
            kind = "any" if any_hit else "closest"
            pg = cases.run(3, "cull_pg2", f"bounce G={group} {kind}-hit rays",
                           rays8, cb8, s_count, group, sbounds)
            cases.run(3, "pgwalk2", f"bounce G={group} {kind}-hit", *pg,
                      rays8, woop, group, any_hit)
    for group in (8, 1024):
        cases.run(3, "cull_pg2", f"bounce G={group} closest-hit rays",
                  bounce8, cb8, s_count, group, sbounds)
    cases.run(3, "cull_pg2", "axis-parallel warps G=32",
              axis_rays(bounce8, cb8), cb8, s_count, 32, sbounds)
    hits = int((tr.pgwalk2(*tr.cull_pg2(bounce8, cb8, s_count, 32, sbounds),
                           bounce8, woop, 32)[1] >= 0).sum())
    check(hits > n // 4, f"only {hits} of {n} bounce rays hit the sphere")
    pgwalk2_split_cases(3, "pgwalk2", "", bounce8, shadow8, cb8, s_count,
                        sbounds, woop, cases)
    for group in (8, 1024):
        rays8 = bounce8[:FEW_RAYS * 16]
        pg = tr.cull_pg2(rays8, cb8, s_count, group, sbounds)
        cases.run(3, "pgwalk2", f"{rays8.shape[0]} bounce rays G={group} "
                  f"closest-hit P={pgwalk2_split(rays8, pg[0], group)[2]}",
                  *pg, rays8, woop, group)
    exact_tie_cases(scene, bounce8, cases)
    cases.run(3, "intersect_count", "headline primary tile 256 closest-hit",
              counts, clist, elist, prim8, cb, woop, 256)

    # SlotBlock.full() and rows_at() are these two threefry calls.
    n, sub = THREEFRY_COLS, rng.fold_in(rng.key(0, scene.device), 1)
    cases.run(3, "threefry", f"full() 18 x {n}", sub, 0, 18, n)
    cols = torch.randperm(n, device=scene.device)
    cases.run(3, "threefry", f"rows_at(0, 18, {n} permuted cols)", sub, 0,
              18, n, cols)


def axis_rays(rays8, cb8):
    """rays8 with every other warp of 32 rays made axis-parallel (each ray
    along +-x, +-y or +-z, so two infinite reciprocals), some of those
    from an origin with a zero coordinate or on a cluster's box face on
    an axis its direction does not move along."""
    import torch
    r = rays8.clone()
    idx = torch.arange(r.shape[0], device=r.device)
    axis = idx % 3
    rows = idx[(idx // 32) % 2 == 1]
    d = torch.zeros((rows.numel(), 3), device=r.device)
    d[torch.arange(rows.numel()), axis[rows]] = torch.where(
        (rows // 3) % 2 == 0, 1.0, -1.0)
    r[rows, 3:6] = d
    zero = rows[rows % 9 == 0]
    r[zero, (axis[zero] + 1) % 3] = 0.0
    face = rows[rows % 9 == 3]
    real = int((~torch.isnan(cb8[0])).sum())
    r[face, (axis[face] + 2) % 3] = cb8[(axis[face] + 2) % 3, face % real]
    return r


def partly_dead(rays8, tile):
    """rays8 with every fourth tile all dead and every other ray of the
    tile after it dead."""
    import torch
    r = rays8.clone()
    idx = torch.arange(r.shape[0], device=r.device)
    t = (idx // tile) % 4
    r[(t == 0) | ((t == 1) & (idx % 2 == 0)), 6] = 0.0
    return r


def cull_cases(tag, label, prim8, bounce8, sbounds, cases):
    """B1 on partly dead tiles of primaries (tile 256, two rays a thread;
    tile 32, one: ``traversal.cull_rays_per_thread``) and on the bounce
    rays (tile 128, a third dead in bounce order)."""
    from srt_tpu_torch.ops import traversal as tr
    s = sbounds.shape[1]
    for tile in (256, 32):
        rpt = tr.cull_rays_per_thread(tile)
        cases.run(tag, "cull", f"{label}primary tile {tile} partly dead S={s} "
                  f"{rpt} ray(s)/thread", partly_dead(prim8, tile), sbounds,
                  tile)
    cases.run(tag, "cull", f"{label}bounce tile 128 S={s}", bounce8,
              sbounds, 128)


def few_tile_cases(tag, name, scene, woop, cases):
    """B2 or B2s (``name``) at tile 32 on 8 tiles of rays from the
    headline camera to a 16x16 grid of points of the square [-1, 1]^2 at
    z = 0 (inside the sphere's silhouette, so every ray hits), and on the
    tile of them with the longest list, closest and any-hit.  Any-hit
    must end some tile early: every ray resolved and fewer supers
    processed than listed."""
    import torch

    from srt_tpu_torch.ops import traversal as tr
    _, cb, sbounds, _, _, _ = tr.model_tables(scene, 0)
    dev = scene.device
    g = torch.linspace(-1.0, 1.0, 16, device=dev)
    target = torch.stack([g.repeat(16), g.repeat_interleave(16),
                          torch.zeros(256, device=dev)])
    origin = torch.tensor(HEADLINE_CAMERA["origin"], device=dev)[:, None]
    rays8 = tr.pack_rays(scene, 0, origin.expand(3, 256), target - origin,
                         float("inf"), 32)[0]
    lists = cases.run(tag, "cull", "8 tiles of 32 primaries", rays8, sbounds,
                      32)
    t = int(lists[2][:, 0].argmax())
    one = [x[t:t + 1] for x in lists]
    for label, (clist, elist, counts), r8 in (
            ("1 tile", one, rays8[32 * t:32 * (t + 1)]),
            ("8 tiles", lists, rays8)):
        for any_hit in (False, True):
            kind = "any" if any_hit else "closest"
            cases.run(tag, name, f"{label} of 32 primaries {kind}-hit",
                      counts, clist, elist, r8, cb, woop, 32, any_hit)
    clist, elist, counts = lists
    _, i, ctr = tr.intersect_count(counts, clist, elist, rays8, cb, woop, 32,
                                   True, stream=name == "intersect_stream")
    resolved = ((i >= 0) | (rays8[:, 6:7] <= 0)).view(-1, 32).all(1)
    early = int((resolved & (ctr[:, 0] < counts[:, 0])).sum())
    check(early > 0, f"{name} any-hit on 8 tiles of 32: no tile ended early")
    print(f"[{tag}] {name} any-hit, 8 tiles of 32: {early} tiles ended "
          f"early (supers processed per tile {ctr[:, 0].tolist()} of "
          f"{counts[:, 0].tolist()} listed)", flush=True)


def pgwalk2_split_cases(tag, name, label, bounce8, shadow8, cb8, s_count,
                        sbounds, woop, cases):
    """B4 or B4s on FEW_RAYS bounce rays and the same rays as shadow
    segments at G = 32: few groups, so each group's list is split over
    P > 1 blocks."""
    from srt_tpu_torch.ops import traversal as tr
    for any_hit, rays8 in ((False, bounce8[:FEW_RAYS]),
                           (True, shadow8[:FEW_RAYS])):
        kind = "any" if any_hit else "closest"
        pg = tr.cull_pg2(rays8, cb8, s_count, 32, sbounds)
        parts = pgwalk2_split(rays8, pg[0], 32)[2]
        check(parts > 1, f"{name} on {FEW_RAYS} rays: P={parts}, no split")
        cases.run(tag, name, f"{label}{FEW_RAYS} bounce rays G=32 {kind}-hit "
                  f"P={parts}", *pg, rays8, woop, 32, any_hit)


def exact_tie_cases(scene, bounce8, cases):
    """B4 on one model's tables holding the sphere several times (the
    padded cluster table repeated): every triangle has identical copies in
    other clusters, each hit is an exact tie, and the first copy's
    (smaller) index must win, across blocks too.  Kernel against plain,
    and both against the single sphere's result.  Two copies, then
    enough copies that some list is longer than the LIST_STAGED entries
    the kernel stages in shared memory (the rest are read from global
    memory)."""
    import torch

    from srt_tpu_torch.ops import traversal as tr
    _, _, sbounds, cb8, s_count, _ = tr.model_tables(scene, 0)
    woop = tr.stream_table(scene, 0)
    few = bounce8[:FEW_RAYS]
    many = LIST_STAGED // int(tr.cull_pg2(few, cb8, s_count, 32,
                                          sbounds)[2].max()) + 1
    for copies, rays8 in ((2, few), (2, bounce8), (many, few)):
        pg = tr.cull_pg2(rays8, torch.cat([cb8] * copies, 1),
                         copies * s_count, 32,
                         torch.cat([sbounds] * copies, 1))
        longest = int(pg[2].max())
        check(copies == 2 or longest > LIST_STAGED,
              f"sphere x{copies}: longest list {longest} entries, not above "
              f"{LIST_STAGED}")
        parts = pgwalk2_split(rays8, pg[0], 32)[2]
        t, i = cases.run(3, "pgwalk2", f"sphere x{copies} {rays8.shape[0]} "
                         f"rays G=32 P={parts} ({longest} entries)", *pg,
                         rays8, torch.cat([woop] * copies), 32)
        ref = tr.pgwalk2(*tr.cull_pg2(rays8, cb8, s_count, 32, sbounds),
                         rays8, woop, 32)
        check(torch.equal(t, ref[0]) and torch.equal(i, ref[1]),
              f"sphere x{copies}: exact ties did not go to the first copy")
        check(bool((i >= 0).any()), f"sphere x{copies}: no hits")


@contextlib.contextmanager
def recorded_launches():
    """While the block runs, record each kernel wrapper call: yields a list
    of (name, bound arguments, outputs), tensors cloned."""
    calls = []
    saved = {name: getattr(kernel_module(name), name) for name in KERNELS}

    def recorder(name, fn):
        sig = inspect.signature(fn)

        def call(*args, **kw):
            out = fn(*args, **kw)
            bound = sig.bind(*args, **kw)
            bound.apply_defaults()
            calls.append((name, {k: v.clone() if hasattr(v, "clone") else v
                                 for k, v in bound.arguments.items()},
                          tuple(o.clone() for o in as_tuple(out))))
            return out
        return call

    for name, fn in saved.items():
        setattr(kernel_module(name), name, recorder(name, fn))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(kernel_module(name), name, fn)


def replay_frame(tag, frame, cases):
    """Render one untimed frame (``frame()``) recording every kernel
    launch, replay each through its plain version, and time each launch
    again on its recorded inputs (device time, ``device_median`` of 3, and
    wrapper time, CUDA events around one call, median of 5) beside its
    bound; prints the per-frame sums by kernel and returns the set of
    kernels launched."""
    import torch

    from srt_tpu_torch.ops import traversal as tr
    with recorded_launches() as calls:
        frame()
    torch.cuda.synchronize()
    per_frame = {}
    for k, (name, args, k_out) in enumerate(calls):
        check(not args["plain"], f"{name}: the render path ran the plain "
                                 f"version")
        if name == "threefry":
            m = args["n"] if args["cols"] is None else args["cols"].shape[0]
            case = (f"frame launch {k}: rows {args['lo']}..+{args['rows']} "
                    f"x {m} cols of n={args['n']}"
                    f"{' (fold_in)' if args['raw'] else ''}")
        else:
            rays8 = args["rays8"]
            mode = (f"G={args['group']}" if "group" in args
                    else f"tile {args['tile']}" if "tile" in args
                    else "G=8")
            if "any_hit" in args:
                mode += " any-hit" if args["any_hit"] else " closest-hit"
            if name.startswith("pgwalk2"):
                n_groups, _, parts = pgwalk2_split(rays8, args["clist"],
                                                   args["group"])
                listed = listed_clusters(args["clist"], args["bits"],
                                         args["counts"])
                mode += f", {n_groups} groups, {listed} listed, P={parts}"
            elif name == "cull_pg2":
                mode += f", {rays8.shape[0] // args['group']} groups"
            elif name in ("cull_perray", "cull_gmask"):
                n_groups = rays8.shape[0] // 8
                live_groups = int((rays8[:, 6] > 0).view(-1, 8).any(1).sum())
                sms = torch.cuda.get_device_properties(
                    rays8.device).multi_processor_count
                gpw = tr.group_cull_shape(n_groups, sms, (
                    tr.CULL_WARP_GROUPS if name == "cull_perray"
                    else tr.CULL_GMASK_WARP_GROUPS))[0]
                mode += (f", {n_groups} groups ({live_groups} live), "
                         f"S={args['sbounds'].shape[1]}, {gpw} a warp")
            elif name == "cull":
                mode += f", S={args['sbounds'].shape[1]}"
            elif name == "pgwalk":
                split = pgwalk_split(args["mask"], rays8, args["woop"],
                                     args["any_hit"])[0]
                mode += f", {split}"
            elif name.startswith("intersect"):
                mode += f", {rays8.shape[0] // args['tile']} tiles"
            case = (f"frame launch {k}: {rays8.shape[0]} rays "
                    f"({int((rays8[:, 6] > 0).sum())} live), {mode}")
        fn = getattr(kernel_module(name), name)
        t0 = time.perf_counter()
        p_out = fn(**{**args, "plain": True})
        torch.cuda.synchronize()
        p_ms = (time.perf_counter() - t0) * 1e3
        err = compare(name, case, k_out, p_out)
        cases.replayed(name, case, p_ms, err)
        w_ms = timed_median(lambda: fn(**args), reps=5)[0]
        k_ms, n, queued = device_median(lambda: fn(**args), reps=3)
        b_ms, b_by, work = bound_of(name, args, k_out)
        acc = per_frame.setdefault(name, [0, 0.0, 0.0, 0.0, 0.0])
        for q, v in enumerate((1, k_ms, w_ms, b_ms, p_ms)):
            acc[q] += v
        print(f"[{tag}] {name:16s} {case:56s} kernel {k_ms:.4f} ms "
              f"({device_note(n, queued)}; wrapper {w_ms:.4f} ms), bound "
              f"{b_ms:.5f} ms ({b_by}); equals plain (plain {p_ms:.1f} ms, "
              f"max_abs_err {err}){f'; {work}' if work else ''}  "
              f"[{cases.card}]", flush=True)
    for name, (n, k_ms, w_ms, b_ms, p_ms) in per_frame.items():
        print(f"[{tag}] per frame {name:16s} {n:2d} launches, kernel "
              f"{k_ms:.4f} ms (device), bound {b_ms:.5f} ms "
              f"({100 * b_ms / k_ms:.2f}% reached), wrapper {w_ms:.4f} ms, "
              f"plain {p_ms:.1f} ms  [{cases.card}]", flush=True)
    return set(per_frame)


def check_image(label, img, size):
    """A [size, size, 3] image of finite pixels with a plausible mean;
    returns the mean."""
    import torch
    check(tuple(img.shape) == (size, size, 3), f"{label}: image shape "
                                               f"{tuple(img.shape)}")
    check(bool(torch.isfinite(img).all()), f"{label}: non-finite pixels")
    mean = float(img.mean())
    check(1e-4 < mean < 10.0, f"{label}: image mean {mean} out of range")
    return mean


def timed_frames(tag, plan, cases, path, size, label, after_frame=None,
                 frames=10):
    """``frames`` timed frames (keys 1..) with the launch counts zeroed
    just before and read just after; checks and prints the frame results.
    ``after_frame(i)``, if given, runs after frame i's timing ends."""
    import torch

    from srt_tpu_torch.ops import rng
    from srt_tpu_torch.ops import traversal as tr
    dev = plan.lights.position.device  # the scene's device
    tr.reset_launch_counts()
    times = []
    for i in range(frames):
        key = rng.key(i + 1, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, stats, overflow = plan.render(key)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        check(int(overflow) == 0, f"{label} frame {i}: overflow "
                                  f"{int(overflow)}")
        if after_frame:
            after_frame(i)
    launches = dict(tr.launch_counts)
    for name in path:
        check(launches[name] > 0, f"kernel {name} never launched by the "
                                  f"{label} path")
        cases.results[name].setdefault("launches", launches[name])
    mean = check_image(label, img, size)
    dt = sum(times) / len(times)
    rays = int(stats.sum())
    print(f"[{tag}] stats per bounce (traced, shadow): {stats.tolist()}, "
          f"image mean {mean:.6f}, launches {launches}", flush=True)
    print(f"[{tag}] frame times (s): {[round(t, 6) for t in times]}",
          flush=True)
    print(f"[{tag}] {label}: {rays / dt / 1e6:.4f} Mrays/s ({rays} "
          f"rays/frame, mean frame {dt * 1e3:.3f} ms)  [{cases.card}]",
          flush=True)
    return launches, dt


def profile_frame(frame, label, frame_s, path):
    """Append a torch.profiler table of one more frame (``frame()``) to
    ``path`` and print the device time against the mean frame time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        frame()
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    # Device rows only, as the table's own total counts them (the CPU op
    # rows repeat their kernels' time).
    dev_us = sum(e.self_device_time_total for e in avgs
                 if e.device_type == DeviceType.CUDA
                 and not e.is_user_annotation)
    table = avgs.table(sort_by="cuda_time_total", row_limit=40)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "a") as f:
        f.write(f"== {label}: device time {dev_us / 1e3:.3f} ms, mean frame "
                f"{frame_s * 1e3:.3f} ms\n{table}\n")
    print(f"[profile] {label}: device time {dev_us / 1e3:.3f} ms of a "
          f"{frame_s * 1e3:.3f} ms mean frame (busy "
          f"{100 * dev_us / 1e3 / (frame_s * 1e3):.1f}%)\n" + "\n".join(
              table.splitlines()[:14]), flush=True)


def phase_render(scene, cases, profile):
    """Phase 4: the headline render at full size."""
    import torch

    from srt_tpu_torch.config import CameraConfig, RenderConfig
    from srt_tpu_torch.models.fastpath import make_render_plan
    from srt_tpu_torch.ops import rng
    from srt_tpu_torch.scene import model_scene_lights

    dev = scene.device
    cam = CameraConfig(width=HEADLINE_SIZE, height=HEADLINE_SIZE,
                       **HEADLINE_CAMERA)
    cfg = RenderConfig(max_depth=4, rr_bounces=0, spp=1)
    t0 = time.perf_counter()
    plan = make_render_plan(scene, model_scene_lights(dev), cam, cfg)
    torch.cuda.synchronize()
    print(f"[4] plan: probe + schedule discovery "
          f"{time.perf_counter() - t0:.3f} s, schedule {plan.schedule}",
          flush=True)
    # One untimed frame (as bench.py renders first), recording every
    # kernel launch; each is then replayed through its plain version.
    launched = replay_frame(4, lambda: plan.render(rng.key(0, dev)), cases)
    check(launched == set(HEADLINE_PATH),
          f"the untimed headline frame launched {sorted(launched)}")
    _, dt = timed_frames(4, plan, cases, HEADLINE_PATH, HEADLINE_SIZE,
                         f"headline ({scene.model_tri_count[0]}-tri uv_sphere, "
                         f"{HEADLINE_SIZE}x{HEADLINE_SIZE}, spp 1, 4 bounces)")
    if profile:
        profile_frame(lambda: plan.render(rng.key(99, dev)), "headline", dt,
                      profile)
    return plan


def phase_parity(scene, plan, card):
    """Phase 5: reduced frame, kernels vs plain versions, one uniform
    array."""
    import dataclasses

    import torch

    from srt_tpu_torch.models.fastpath import build_hit_fns, default_walks
    from srt_tpu_torch.models.wavefront_compact import trace_image_compact
    from srt_tpu_torch.ops.rng import ArrayStream, host_uniforms, total_slots

    dev = scene.device
    cam = dataclasses.replace(plan.cam, width=128, height=128)
    cfg = plan.cfg
    n = cam.width * cam.height
    nb = cfg.max_depth + cfg.rr_bounces
    u = torch.as_tensor(host_uniforms(0, n, total_slots(plan.lights.count,
                                                         nb)), device=dev)
    walks, walks_sh = default_walks(scene, nb)
    out = {}
    for plain in (False, True):
        fns = build_hit_fns(scene, walks, walks_sh, plain=plain)
        out[plain] = trace_image_compact(fns, plan.lights, cam, cfg,
                                         ArrayStream(u), (n,) * nb,
                                         return_stats=True)
    (img_k, st_k, ov_k), (img_p, st_p, ov_p) = out[False], out[True]
    check(torch.equal(st_k, st_p), f"stats differ: kernels {st_k.tolist()} "
                                   f"plain {st_p.tolist()}")
    check(int(ov_k) == 0 and int(ov_p) == 0, "overflow in the parity frame")
    close = torch.isclose(img_k, img_p, rtol=1e-4, atol=1e-5)
    check(bool(close.all()), f"{int((~close).sum())} image values differ "
                             f"beyond rtol 1e-4 / atol 1e-5")
    print(f"[5] 128x128 parity: stats equal {st_k.tolist()}, image max abs "
          f"diff {float((img_k - img_p).abs().max())}, mean "
          f"{float(img_k.mean()):.6f}  [{card}]", flush=True)


def stream_cases(scene, cases):
    """Phase 6a: B2s and B4s against their plain versions on the config8
    tables."""
    from srt_tpu_torch.ops import traversal as tr

    _, cb, sbounds, cb8, s_count, _ = tr.model_tables(scene, 0)
    woop_s = tr.stream_table(scene, 0)
    prim8, bounce8, shadow8 = walk_rays(scene)
    clist, elist, counts = cases.run("6a", "cull",
                                     f"config8 primary tile 256 S={s_count}",
                                     prim8, sbounds, 256)
    cull_cases("6a", "config8 ", prim8, bounce8, sbounds, cases)
    for any_hit in (False, True):
        kind = "any" if any_hit else "closest"
        cases.run("6a", "intersect_stream",
                  f"config8 primary tile 256 {kind}-hit", counts, clist,
                  elist, prim8, cb, woop_s, 256, any_hit)
    few_tile_cases("6a", "intersect_stream", scene, woop_s, cases)
    for group in (128, 32):
        for any_hit, rays8 in ((False, bounce8), (True, shadow8)):
            kind = "any" if any_hit else "closest"
            pg = cases.run("6a", "cull_pg2",
                           f"config8 bounce G={group} {kind}-hit rays",
                           rays8, cb8, s_count, group, sbounds)
            cases.run("6a", "pgwalk2_stream",
                      f"config8 bounce G={group} {kind}-hit", *pg, rays8,
                      woop_s, group, any_hit)
    pgwalk2_split_cases("6a", "pgwalk2_stream", "config8 ", bounce8, shadow8,
                        cb8, s_count, sbounds, woop_s, cases)
    cases.run("6a", "intersect_count",
              "config8 primary tile 256 stream closest-hit", counts, clist,
              elist, prim8, cb, woop_s, 256, stream=True)
    # B5 and B6 are off config8's path (its walks stream), but its tables
    # stage several chunks of supers (S = 246).
    b5_b6_cases("6a", f"config8 bounce rays S={s_count}", bounce8, cb8,
                s_count, sbounds, cases)


def resident_vs_stream(label, scene, card):
    """Phase 6b: the resident and streamed walks on one scene's tables and
    the same rays, timed in turns (resident, stream, stream, resident);
    outputs must be equal.  Returns {case: (resident ms, stream ms)}."""
    import torch

    from srt_tpu_torch.ops import traversal as tr

    woop, cb, sbounds, cb8, s_count, _ = tr.model_tables(scene, 0)
    woop_s = tr.stream_table(scene, 0)
    prim8, bounce8, shadow8 = walk_rays(scene)
    clist, elist, counts = tr.cull(prim8, sbounds, 256)
    pairs = {}
    for any_hit in (False, True):
        def b2(walk, w, a=any_hit):
            return walk(counts, clist, elist, prim8, cb, w, 256, a)
        pairs[f"B2 primary tile 256 {'any' if any_hit else 'closest'}"] = (
            lambda w, b2=b2: b2(tr.intersect, w),
            lambda w, b2=b2: b2(tr.intersect_stream, w))
    for group, any_hit, rays8 in ((128, False, bounce8), (32, True, shadow8)):
        def b4(walk, w, pg=tr.cull_pg2(rays8, cb8, s_count, group, sbounds),
               r=rays8, g=group, a=any_hit):
            return walk(*pg, r, w, g, a)
        pairs[f"B4 bounce G={group} {'any' if any_hit else 'closest'}"] = (
            lambda w, b4=b4: b4(tr.pgwalk2, w),
            lambda w, b4=b4: b4(tr.pgwalk2_stream, w))
    out = {}
    for case, (res_fn, str_fn) in pairs.items():
        r1, a = timed_median(lambda: res_fn(woop))
        s1, b = timed_median(lambda: str_fn(woop_s))
        s2, _ = timed_median(lambda: str_fn(woop_s))
        r2, _ = timed_median(lambda: res_fn(woop))
        check(all(torch.equal(x, y) for x, y in zip(a, b)),
              f"{label} {case}: streamed output differs from resident")
        out[case] = ((r1 + r2) / 2, (s1 + s2) / 2)
        print(f"[6b] {label:8s} {case:32s} resident {r1:8.3f}/{r2:8.3f} ms  "
              f"stream {s1:8.3f}/{s2:8.3f} ms  outputs equal  [{card}]",
              flush=True)
    return out


def phase_config8(scene8, headline, cases, profile):
    """Phase 6: the config8 streamed scene."""
    import torch

    from srt_tpu_torch.config import CameraConfig, RenderConfig
    from srt_tpu_torch.models.fastpath import make_render_plan
    from srt_tpu_torch.ops import rng
    from srt_tpu_torch.ops import traversal as tr
    from srt_tpu_torch.scene import model_scene_lights

    n_clusters = scene8.woop.shape[0]
    check(scene8.model_tri_count[0] == 502600 and n_clusters == 3927,
          f"config8 scene has {scene8.model_tri_count[0]} triangles, "
          f"{n_clusters} clusters")
    check(n_clusters > tr.STREAM_THRESHOLD_CLUSTERS,
          "config8 must be above the stream threshold")
    stream_cases(scene8, cases)
    resident_vs_stream("headline", headline, cases.card)
    resident_vs_stream("config8", scene8, cases.card)

    dev = scene8.device
    cam = CameraConfig(width=CONFIG8_SIZE, height=CONFIG8_SIZE,
                       **HEADLINE_CAMERA)
    cfg = RenderConfig(max_depth=2, rr_bounces=0, spp=1)
    t0 = time.perf_counter()
    plan = make_render_plan(scene8, model_scene_lights(dev), cam, cfg)
    torch.cuda.synchronize()
    print(f"[6c] plan: probe + schedule discovery "
          f"{time.perf_counter() - t0:.3f} s, schedule {plan.schedule}",
          flush=True)
    launched = replay_frame("6c", lambda: plan.render(rng.key(0, dev)), cases)
    check(launched == set(CONFIG8_PATH),
          f"the untimed config8 frame launched {sorted(launched)}")
    launches, dt = timed_frames(
        "6d", plan, cases, CONFIG8_PATH, CONFIG8_SIZE,
        f"config8 ({scene8.model_tri_count[0]}-tri uv_sphere, streamed walks, "
        f"{CONFIG8_SIZE}x{CONFIG8_SIZE}, spp 1, 2 bounces)")
    check(launches["intersect"] == 0 and launches["pgwalk2"] == 0,
          f"the config8 frames launched resident walks: {launches}")
    if profile:
        profile_frame(lambda: plan.render(rng.key(99, dev)), "config8", dt,
                      profile)


def phase_counters(scenes, cases):
    """Phase 7: B2c through ``model_hit(count_evals=True)`` on the
    full-frame primaries of each scene, launch counts zeroed just before
    and read just after."""
    import torch

    from srt_tpu_torch.ops import traversal as tr

    rays = {label: primary_rays(scene, size, 256)[:2]
            for label, (scene, size) in scenes.items()}
    tr.reset_launch_counts()
    got = {label: tr.model_hit(scenes[label][0], 0, o, d, float("inf"),
                               tile=256, count_evals=True)
           for label, (o, d) in rays.items()}
    torch.cuda.synchronize()
    launches = dict(tr.launch_counts)
    for name in COUNTER_PATH:
        check(launches[name] > 0, f"kernel {name} never launched by the "
                                  f"counter run")
        cases.results[name].setdefault("launches", launches[name])
    for label, (o, d) in rays.items():
        ref = tr.model_hit(scenes[label][0], 0, o, d, float("inf"), tile=256,
                           count_evals=True, plain=True)
        for a, b in zip(got[label], ref):
            check(torch.equal(a, b), f"{label} counters/hits differ from "
                                     f"the plain counted walk")
        ctr = got[label][4]
        busy = ctr[:, 0] > 0
        mean_all = ctr.float().mean(0).tolist()
        mean_busy = ctr[busy].float().mean(0).tolist()
        print(f"[7] B2c {label:8s} {ctr.shape[0]} tiles of 256 primaries: "
              f"per tile supers processed {mean_all[0]:.4f}, clusters "
              f"evaluated {mean_all[1]:.4f} (most {int(ctr[:, 1].max())}); "
              f"over the {int(busy.sum())} tiles that processed a super: "
              f"{mean_busy[0]:.4f} / {mean_busy[1]:.4f}; equal to plain  "
              f"[{cases.card}]", flush=True)


def b5_b6_cases(tag, label, rays8, cb8, s_count, sbounds, cases):
    """B5 and B6 against their plain versions on the same rays."""
    cases.run(tag, "cull_perray", label, rays8, sbounds)
    cases.run(tag, "cull_gmask", label, rays8, cb8, s_count, sbounds)


def binned_cases(scene, cases):
    """Phase 8a: B5, B6, B7 and the pair tiles through B2 against their
    plain versions on the headline tables."""
    import torch

    from srt_tpu_torch.ops import traversal as tr

    woop, cb, sbounds, cb8, s_count, _ = tr.model_tables(scene, 0)
    prim8, bounce8, shadow8 = walk_rays(scene)
    for label, rays8 in (("bounce (a third dead)", bounce8),
                         ("primary (live)", prim8),
                         ("axis-parallel warps", axis_rays(bounce8, cb8))):
        b5_b6_cases("8a", f"{label} rays", rays8, cb8, s_count, sbounds,
                    cases)
    for any_hit, label, rays8 in ((False, "bounce closest", bounce8),
                                  (True, "shadow any", shadow8),
                                  (False, "primary closest", prim8)):
        mask = tr.cull_gmask(rays8, cb8, s_count, sbounds)
        cases.run("8a", "pgwalk", f"{label}-hit", mask, rays8, woop, any_hit)
    pgwalk_few_and_tie_cases(scene, bounce8, shadow8, cases)
    # These random rays need more pair slots than the frames' 8 per group:
    # each case takes the smallest pair_factor that holds its pairs.
    tile = 128
    gpt = tile // tr.GROUP
    for any_hit, label, rays8 in ((False, "bounce closest", bounce8),
                                  (True, "shadow any", shadow8)):
        e = tr.cull_perray(rays8, sbounds)
        n_groups = rays8.shape[0] // tr.GROUP
        full = tr.pair_capacity(n_groups, s_count, gpt, s_count)
        factor = -(-int(tr.binned_pairs(e, gpt, full)[3]) // n_groups)
        p_cap = tr.pair_capacity(n_groups, s_count, gpt, factor)
        pair_grp, tile_super, tile_counts, total = tr.binned_pairs(e, gpt,
                                                                   p_cap)
        check(int(total) <= p_cap, f"{label}: {int(total)} pairs overflow "
                                   f"{p_cap}")
        pair_rays = tr.pair_rays(rays8, pair_grp)
        elist0 = torch.zeros((p_cap // gpt, 1), device=rays8.device)
        cases.run("8a", "intersect",
                  f"pair tiles {label}-hit ({int(total)}/{p_cap} slots, "
                  f"pair_factor {factor})",
                  tile_counts, tile_super, elist0, pair_rays, cb, woop, tile,
                  any_hit)


def pgwalk_few_and_tie_cases(scene, bounce8, shadow8, cases):
    """B7 on FEW_GROUP_RAYS bounce rays with all but a few groups dead
    (long masks in few tiles: the kernels must split the tiles' clusters
    into more work items than tiles), closest and any-hit; then on the
    sphere's tables repeated (every hit an exact tie, which the first copy
    must win), on those rays and on all the bounce rays."""
    import torch

    from srt_tpu_torch.ops import traversal as tr
    _, _, sbounds, cb8, s_count, _ = tr.model_tables(scene, 0)
    woop = tr.stream_table(scene, 0)
    idx = torch.arange(FEW_GROUP_RAYS, device=bounce8.device)
    live = torch.isin(idx // tr.GROUP, torch.tensor(FEW_LIVE_GROUPS,
                                                    device=idx.device))
    few = {}
    for any_hit, kind, rays8 in ((False, "closest", bounce8),
                                 (True, "any", shadow8)):
        r8 = rays8[:FEW_GROUP_RAYS].clone()
        r8[~live, 6] = 0.0
        few[any_hit] = r8
        b5_b6_cases("8a", f"{FEW_GROUP_RAYS} rays ({int((r8[:, 6] > 0).sum())}"
                    f" live) {kind}-hit", r8, cb8, s_count, sbounds, cases)
        mask = tr.cull_gmask(r8, cb8, s_count, sbounds)
        text, busy, items = pgwalk_split(mask, r8, woop, any_hit)
        check(items > busy, f"pgwalk on {FEW_GROUP_RAYS} rays, {kind}-hit: "
                            f"{items} items for {busy} tiles, no split")
        cases.run("8a", "pgwalk", f"{FEW_GROUP_RAYS} rays "
                  f"({int((r8[:, 6] > 0).sum())} live) {kind}-hit: {text}",
                  mask, r8, woop, any_hit)
    cb8_2 = torch.cat([cb8, cb8], 1)
    sbounds_2 = tr.super_bounds(cb8_2, 2 * s_count)
    for label, rays8 in ((f"{FEW_GROUP_RAYS} rays", few[False]),
                         (f"{bounce8.shape[0]} bounce rays", bounce8)):
        mask = tr.cull_gmask(rays8, cb8_2, 2 * s_count, sbounds_2)
        woop2 = torch.cat([woop, woop])
        t, i = cases.run("8a", "pgwalk", f"sphere x2 {label} closest-hit: "
                         f"{pgwalk_split(mask, rays8, woop2, False)[0]}",
                         mask, rays8, woop2)
        ref = tr.pgwalk(tr.cull_gmask(rays8, cb8, s_count, sbounds), rays8,
                        woop)
        check(torch.equal(t, ref[0]) and torch.equal(i, ref[1]),
              f"pgwalk sphere x2 {label}: exact ties did not go to the "
              f"first copy")
        check(bool((i >= 0).any()), f"pgwalk sphere x2 {label}: no hits")


@contextlib.contextmanager
def pair_log():
    """While the block runs, record each ``binned_pairs`` call's (total,
    capacity): yields the list."""
    from srt_tpu_torch.ops import traversal as tr
    log = []
    fn = tr.binned_pairs

    def call(e_group, gpt, p_cap):
        out = fn(e_group, gpt, p_cap)
        log.append((out[3], p_cap))
        return out
    tr.binned_pairs = call
    try:
        yield log
    finally:
        tr.binned_pairs = fn


def walk_render(tag, scene, cases, walk, path, profile):
    """Phases 8b, 8c: the headline render with ``walk`` for every bounce
    after the primaries and for every shadow batch: one replayed frame,
    then 10 timed frames, each printing its pair-branch decisions."""
    import torch

    from srt_tpu_torch.config import CameraConfig, RenderConfig
    from srt_tpu_torch.models.fastpath import make_render_plan
    from srt_tpu_torch.ops import rng
    from srt_tpu_torch.scene import model_scene_lights

    dev = scene.device
    cam = CameraConfig(width=HEADLINE_SIZE, height=HEADLINE_SIZE,
                       **HEADLINE_CAMERA)
    cfg = RenderConfig(max_depth=4, rr_bounces=0, spp=1)
    t0 = time.perf_counter()
    plan = make_render_plan(scene, model_scene_lights(dev), cam, cfg,
                            walks=f"tiled@256,{walk}", walks_shadow=walk)
    torch.cuda.synchronize()
    print(f"[{tag}] plan walks=tiled@256,{walk} walks_shadow={walk}: probe "
          f"+ schedule discovery {time.perf_counter() - t0:.3f} s, schedule "
          f"{plan.schedule}", flush=True)
    launched = replay_frame(tag, lambda: plan.render(rng.key(0, dev)), cases)
    check(launched == set(path),
          f"the untimed {walk} frame launched {sorted(launched)}")
    with pair_log() as log:
        def after_frame(i):
            calls = [(int(total), p_cap) for total, p_cap in log]
            log.clear()
            if walk == "binned":
                n_pairs = sum(total <= p_cap for total, p_cap in calls)
                print(f"[{tag}] frame {i}: {n_pairs} walk calls took the "
                      f"pair branch, {len(calls) - n_pairs} fell back; "
                      f"total/capacity "
                      f"{', '.join(f'{t}/{c}' for t, c in calls)}",
                      flush=True)
        launches, dt = timed_frames(
            tag, plan, cases, path, HEADLINE_SIZE,
            f"headline walks=tiled@256,{walk} ({HEADLINE_SIZE}x"
            f"{HEADLINE_SIZE}, spp 1, 4 bounces)", after_frame)
    if walk == "binned":
        check(launches["binned_pairs"] > 0,
              "no binned walk call took the pair branch")
    if profile:
        profile_frame(lambda: plan.render(rng.key(99, dev)),
                      f"headline {walk}", dt, profile)


def phase_binned(scene, cases, profile):
    """Phase 8: the pair-binned and mask-scan walks."""
    import torch

    from srt_tpu_torch.ops import traversal as tr

    binned_cases(scene, cases)
    walk_render("8b", scene, cases, "binned", BINNED_PATH, profile)
    walk_render("8c", scene, cases, "pg", PG_PATH, profile)
    bo, bd, t_closest, _ = bounce_rays(scene)
    tr.reset_launch_counts()
    got = tr.model_hit(scene, 0, bo, bd, t_closest, tile=128, binned=True,
                       pair_factor=1)
    counts = (tr.launch_counts["binned_fallback"],
              tr.launch_counts["binned_pairs"])
    check(counts == (1, 0), f"pair_factor=1: (fallbacks, pair calls) "
                            f"{counts}, expected (1, 0)")
    ref = tr.model_hit(scene, 0, bo, bd, t_closest, tile=128)
    check(all(torch.equal(a, b) for a, b in zip(got, ref)),
          "the pair_factor=1 fallback differs from the tiled walk")
    print(f"[8d] model_hit(binned=True, pair_factor=1) on {bo.shape[1]} "
          f"bounce rays: one fallback, equal to the tiled walk "
          f"({int((ref[1] >= 0).sum())} hits)  [{cases.card}]", flush=True)


def image_agreement(a, b):
    """(share of pixels within rtol 1e-4 / atol 1e-5, max |a - b|) of two
    [H, W, 3] images: the port's image criterion."""
    import torch
    close = torch.isclose(a, b, rtol=1e-4, atol=1e-5).all(-1)
    return float(close.float().mean()), float((a - b).abs().max())


def scan_frames(tag, label, frame, dev, path, size, rays, card):
    """``SCAN_FRAMES`` timed frames (``frame(key)``, keys 1..) with the
    launch counts zeroed just before and read just after: every kernel of
    ``path`` launched, a finite image; Mrays/s of ``rays`` a frame."""
    import torch

    from srt_tpu_torch.ops import rng
    from srt_tpu_torch.ops import traversal as tr
    tr.reset_launch_counts()
    times = []
    for i in range(SCAN_FRAMES):
        key = rng.key(i + 1, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = frame(key)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = {k: v for k, v in tr.launch_counts.items() if v}
    for name in path:
        check(launches.get(name, 0) > 0, f"kernel {name} never launched by "
                                          f"the {label} path")
    mean = check_image(label, img, size)
    dt = sum(times) / len(times)
    print(f"[{tag}] {label}: frame times (s) "
          f"{[round(t, 6) for t in times]}, mean {dt * 1e3:.3f} ms, "
          f"{rays / dt / 1e6:.4f} Mrays/s ({rays} rays a frame), image "
          f"mean {mean:.6f}, launches in {SCAN_FRAMES} frames {launches}  "
          f"[{card}]", flush=True)
    return dt


def scan_mesh_render(tag, label, hit, lights, cam, cfg, path, cases,
                     profile):
    """Phases 9c, 9d: a mesh frame through ``pathtracer.render``: one
    untimed frame whose every kernel launch is replayed through its plain
    version and timed beside its bound, its rays traced (the same sample
    through ``trace_image_sample``'s stats, equal image), then
    ``SCAN_FRAMES`` timed frames."""
    import torch

    from srt_tpu_torch.models import pathtracer
    from srt_tpu_torch.ops import rng
    dev = lights.position.device
    key0 = rng.key(0, dev)
    out = []
    launched = replay_frame(
        tag, lambda: out.append(pathtracer.render(hit, lights, cam, cfg,
                                                  key0)),
        cases)
    check(launched == set(path),
          f"the untimed {label} frame launched {sorted(launched)}")
    n = cam.width * cam.height
    img, stats = pathtracer.trace_image_sample(
        hit, lights, cam, cfg, rng.KeyStream(rng.fold_in(key0, 0), n),
        return_stats=True)
    check(torch.equal(img, out[0]), f"{label}: render and its sample 0 "
                                    f"differ")
    rays = int(stats.sum())
    print(f"[{tag}] {label}: stats per bounce (traced, shadow) "
          f"{stats.tolist()}", flush=True)
    dt = scan_frames(tag, label, lambda k: pathtracer.render(
        hit, lights, cam, cfg, k), dev, path, cam.width, rays, cases.card)
    if profile:
        profile_frame(lambda: pathtracer.render(hit, lights, cam, cfg,
                                                rng.key(99, dev)),
                      f"{label} (scan)", dt, profile)


def phase_scan(scene, cases, profile, dev):
    """Phase 9: the scan integrator (``pathtracer.render``): config1,
    config2's, config6's and config3's forward passes and a union frame."""
    import torch

    from srt_tpu_torch.config import CameraConfig, RenderConfig
    from srt_tpu_torch.models import mesh, pathtracer
    from srt_tpu_torch.ops import rng
    from srt_tpu_torch.ops import traversal as tr
    from srt_tpu_torch.scene import (default_sphere_scene,
                                     model_scene_lights, sphere_scene_lights)
    from srt_tpu_torch.utils.flatten import flatten_models
    from srt_tpu_torch.utils.procgen import rubik_grid

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")

    # (a) config1: 2 bounces from one injected uniform array, the card
    # against the port's own CPU run.
    size = CONFIG1_SIZE
    cam = CameraConfig(width=size, height=size)
    cfg = RenderConfig(max_depth=2, rr_bounces=0)
    u = rng.host_uniforms(1, size * size, rng.total_slots(2, 2))
    got = {}
    for d in (dev, cpu):
        hit = pathtracer.spheres_hit_fn(default_sphere_scene(d))
        lights = sphere_scene_lights(d)
        ut = torch.as_tensor(u, device=d)
        img = pathtracer.trace_with_uniforms(hit, lights, cam, cfg, ut)
        _, stats = pathtracer.trace_image_sample(
            hit, lights, cam, cfg, rng.ArrayStream(ut), return_stats=True)
        got[d.type] = (img.cpu(), stats.cpu())
    (img_d, st_d), (img_c, st_c) = got[dev.type], got["cpu"]
    check(torch.equal(st_d, st_c), f"config1 stats: card {st_d.tolist()}, "
                                   f"CPU {st_c.tolist()}")
    check_image("config1", img_d, size)
    share, err = image_agreement(img_d, img_c)
    check(share >= 0.995, f"config1: {100 * share:.3f}% of pixels within "
                          f"rtol 1e-4 / atol 1e-5 of the CPU run")
    print(f"[9a] config1 spheres {size}x{size}, 2 bounces, injected "
          f"uniforms: card vs CPU stats equal {st_d.tolist()}, max |err| "
          f"{err}, {100 * (1 - share):.4f}% of pixels differ beyond rtol "
          f"1e-4 / atol 1e-5  [{cases.card}]", flush=True)

    # (b) config2's forward pass: 16 samples a pixel, 4 bounces.
    size, spp = CONFIG2_SIZE, CONFIG2_SPP
    spheres, lights = default_sphere_scene(dev), sphere_scene_lights(dev)
    cam = CameraConfig(width=size, height=size)
    cfg = RenderConfig(max_depth=4, rr_bounces=0, spp=spp)

    def config2(key):
        return pathtracer.render_spheres(spheres, lights, cam, cfg, key)

    config2(rng.key(0, dev))
    label = f"config2 spheres {size}x{size} spp {spp} 4 bounces"
    dt = scan_frames("9b", label, config2, dev, SPHERE_PATH, size,
                     size * size * spp * cfg.max_depth * 2, cases.card)
    if profile:
        profile_frame(lambda: config2(rng.key(99, dev)), label, dt, profile)

    # (c) config6's forward pass through the scan: the headline mesh.
    cam = CameraConfig(width=CONFIG6_SIZE, height=CONFIG6_SIZE,
                       **HEADLINE_CAMERA)
    cfg = RenderConfig(max_depth=2, rr_bounces=0, sort_bounces=True)
    scan_mesh_render(
        "9c", f"config6 ({scene.model_tri_count[0]}-tri uv_sphere, "
        f"{CONFIG6_SIZE}x{CONFIG6_SIZE}, 2 bounces)",
        mesh.mesh_hit_fn(scene, method="walk"), model_scene_lights(dev), cam,
        cfg, SCAN_MESH_PATH, cases, profile)

    # (d) config3's forward pass: the Rubik grid, config3's ray_tile (the
    # walk ignores it, as JAX's does: one walk a query).
    rubik = mesh.upload(flatten_models([rubik_grid()], pad_to=128), dev)
    cam = CameraConfig(width=CONFIG3_SIZE, height=CONFIG3_SIZE,
                       **CONFIG3_CAMERA)
    cfg = RenderConfig(max_depth=4, rr_bounces=0)
    scan_mesh_render(
        "9d", f"config3 (rubik_grid, {rubik.num_triangles} triangles, "
        f"{rubik.woop.shape[0]} clusters, {CONFIG3_SIZE}x{CONFIG3_SIZE}, "
        f"4 bounces, ray_tile {CONFIG3_RAY_TILE})",
        mesh.mesh_hit_fn(rubik, ray_tile=CONFIG3_RAY_TILE),
        model_scene_lights(dev), cam, cfg, ONE_SUPER_PATH, cases, profile)

    # (e) the sphere scene and the headline mesh (50 supers) in one scene:
    # shadow rays from sphere hits reach B1 and B2 with a finite t_max.
    spheres_only = pathtracer.spheres_hit_fn(spheres)
    mesh_only = mesh.mesh_hit_fn(scene, method="walk")
    union = pathtracer.union_hit_fn(spheres_only, mesh_only)
    cam = CameraConfig(width=UNION_SIZE, height=UNION_SIZE, **UNION_CAMERA)
    cfg = RenderConfig(max_depth=2, rr_bounces=0)
    key0 = rng.key(0, dev)
    out, launches = [], {}

    def union_frame():
        tr.reset_launch_counts()
        out.append(pathtracer.render(union, lights, cam, cfg, key0))
        launches.update((k, v) for k, v in tr.launch_counts.items() if v)

    launched = replay_frame("9e", union_frame, cases)
    check(launched == set(SCAN_MESH_PATH),
          f"the union frame launched {sorted(launched)}")
    img = out[0]
    mean = check_image("union", img, UNION_SIZE)
    covered = [float(((img - pathtracer.render(alone, lights, cam, cfg, key0))
                      .abs().amax(-1) > 0).float().mean())
               for alone in (spheres_only, mesh_only)]
    check(min(covered) > 0.01, f"union: differs from the spheres alone and "
                               f"the mesh alone on {covered} of pixels")
    print(f"[9e] union of the sphere scene and the headline mesh, "
          f"{UNION_SIZE}x{UNION_SIZE}, 2 bounces: image mean {mean:.6f}, "
          f"{100 * covered[0]:.2f}% of pixels differ from the spheres alone "
          f"and {100 * covered[1]:.2f}% from the mesh alone, launches "
          f"{launches}  [{cases.card}]", flush=True)
    print(f"[9] scan phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def synchronize():
    """``torch.cuda.synchronize()`` where there is a card (a spawned rank
    of a CPU rehearsal has none)."""
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def host_median(fn, reps=GRAD_REPS):
    """Median wall seconds of ``fn()`` (each call synchronized) over
    ``reps`` calls after one warm call; returns (s, last result)."""
    out = fn()
    synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        synchronize()
        times.append(time.perf_counter() - t0)
    return sorted(times)[reps // 2], out


def grad_of(loss, params, key):
    """Gradients of the scalar ``loss(leaves, key)`` with respect to
    fresh leaf copies of ``params``."""
    leaves = [p.detach().clone().requires_grad_(True) for p in params]
    loss(leaves, key).backward()
    return [x.grad for x in leaves]


def rel_err(a, b):
    """The largest |x - y| / |y| (L2 norms) over pairs of tensors (x in a,
    y in b), on the host."""
    return max(float((x.cpu() - y.cpu()).norm())
               / max(float(y.norm()), 1e-30) for x, y in zip(a, b))


def check_grads(label, grads):
    """Finite and nonzero gradients; returns their largest |entry|s."""
    import torch
    for g in grads:
        check(bool(torch.isfinite(g).all()), f"{label}: non-finite gradient")
    peak = [float(g.abs().max()) for g in grads]
    check(min(peak) > 0.0, f"{label}: a zero gradient ({peak})")
    return peak


def path_launches(label, path, launches):
    """Check every kernel of ``path`` in the counts ``launches``; returns
    the nonzero counts."""
    found = {k: v for k, v in launches.items() if v}
    for name in path:
        check(found.get(name, 0) > 0, f"kernel {name} never launched by the "
                                      f"{label} path")
    return found


def refit_scale(scene):
    """Per triangle, the largest term its Woop rows sum (|A^-1| |v0|, and
    |A^-1|), in float64 on the host: the scale of the float32 rounding
    that a refit's inverse and translation carry."""
    import numpy as np
    v0, v1, v2 = (getattr(scene, f).cpu().numpy().astype(np.float64)
                  for f in ("tri_v0", "tri_v1", "tri_v2"))
    e1, e2 = v1 - v0, v2 - v0
    a = np.stack([e1, e2, np.cross(e1, e2)], -1)
    ok = np.abs(np.linalg.det(a)) > 1e-12
    inv = np.abs(np.linalg.inv(np.where(ok[:, None, None], a, np.eye(3))))
    return np.maximum((inv @ np.abs(v0)[:, :, None])[:, :, 0].max(1),
                      inv.max((1, 2)))


def phase_grad(scene, cases, profile, dev):
    """Phase 10: gradients and the trainer (``bench_suite.py``'s config6
    backward, config10b's optimizer steps, config2's and config3's
    backward passes) and their parity on the card."""
    import numpy as np
    import torch

    from srt_tpu_torch import optim
    from srt_tpu_torch.bench_suite import mesh_loss
    from srt_tpu_torch.config import CameraConfig, RenderConfig
    from srt_tpu_torch.models import mesh, pathtracer
    from srt_tpu_torch.ops import rng
    from srt_tpu_torch.ops import traversal as tr
    from srt_tpu_torch.scene import (default_sphere_scene,
                                     model_scene_lights, sphere_scene_lights)
    from srt_tpu_torch.utils.flatten import flatten_models
    from srt_tpu_torch.utils.procgen import rubik_grid

    t_phase = time.perf_counter()
    card = cases.card
    gib = 2.0 ** 30
    lights = model_scene_lights(dev)
    cam6 = CameraConfig(width=CONFIG6_SIZE, height=CONFIG6_SIZE,
                        **HEADLINE_CAMERA)
    cfg6 = RenderConfig(max_depth=2, rr_bounces=0, spp=1, sort_bounces=True)
    image6, loss6 = mesh_loss(scene, lights, cam6, cfg6)
    params6 = (scene.mat_diffuse, scene.positions)
    key0 = rng.key(0, dev)

    # (a) config6's backward: (mat_diffuse, positions) of the headline
    # mesh.  One differentiated frame with every launch replayed through
    # its plain version, then forward and backward timed.
    out = []
    launched = replay_frame(
        "10a", lambda: out.append(grad_of(loss6, params6, key0)), cases)
    check(launched == set(SCAN_MESH_PATH),
          f"the differentiated config6 frame launched {sorted(launched)}")
    tr.reset_launch_counts()
    with torch.no_grad():
        fwd_s, _ = host_median(lambda: loss6(params6, key0))
    torch.cuda.reset_peak_memory_stats(dev)
    bwd_s, grads = host_median(lambda: grad_of(loss6, params6, key0))
    peak = torch.cuda.max_memory_allocated(dev) / gib
    found = path_launches("config6 backward", SCAN_MESH_PATH,
                          tr.launch_counts)
    mags = check_grads("config6", grads)
    again = rel_err(grad_of(loss6, params6, key0), grads)
    print(f"[10a] config6 backward ({scene.model_tri_count[0]}-tri uv_sphere,"
          f" {CONFIG6_SIZE}x{CONFIG6_SIZE}, 2 bounces, d mean / d "
          f"(mat_diffuse, positions)): forward {fwd_s:.6f} s, forward + "
          f"backward {bwd_s:.6f} s (median of {GRAD_REPS} after a warm "
          f"call), bwd/fwd {bwd_s / fwd_s:.2f}x, peak memory {peak:.3f} "
          f"GiB; gradients finite, max |g| {mags}; a second backward "
          f"differs by {again:.3e} (L2, relative; scatter-add order); "
          f"launches {found}  [{card}]", flush=True)
    if profile:
        profile_frame(lambda: grad_of(loss6, params6, key0),
                      "config6 forward + backward", bwd_s, profile)

    # (b) config10b: Adam steps on (mat_diffuse, positions) toward the
    # image of the true parameters (key 3); step 0 dropped from the mean.
    with torch.no_grad():
        target = image6(params6, rng.key(3, dev))
    params0 = (scene.mat_diffuse * 0.9, scene.positions * 1.001)
    stamps = [time.perf_counter()]
    tr.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    res = optim.run_inverse_rendering(
        image6, params0, target, rng.key(3, dev), steps=CONFIG10B_STEPS,
        learning_rate=1e-3, fixed_noise=True, log_every=0,
        callback=lambda i, p, loss: stamps.append(time.perf_counter()))
    peak = torch.cuda.max_memory_allocated(dev) / gib
    found = path_launches("config10b", SCAN_MESH_PATH, tr.launch_counts)
    losses = res.losses
    check(len(losses) == CONFIG10B_STEPS and np.isfinite(losses).all(),
          f"config10b: losses {losses}")
    check(min(losses) <= losses[0], f"config10b: losses {losses}")
    step_s = float(np.diff(stamps)[1:].mean())
    print(f"[10b] config10b ({CONFIG10B_STEPS} fixed-noise Adam steps at "
          f"1e-3 on (mat_diffuse * 0.9, positions * 1.001), "
          f"{CONFIG6_SIZE}x{CONFIG6_SIZE}): {step_s:.6f} s/step (mean of "
          f"steps 1-{CONFIG10B_STEPS - 1}), step 0 "
          f"{stamps[1] - stamps[0]:.6f} s, losses {losses}, last/first "
          f"{losses[-1] / losses[0]:.6f}, peak memory {peak:.3f} GiB, "
          f"launches {found}  [{card}]", flush=True)

    # (c) config2's backward: d mean / d albedo, 16 samples, 4 bounces.
    spheres = default_sphere_scene(dev)
    s_lights = sphere_scene_lights(dev)
    cam = CameraConfig(width=CONFIG2_SIZE, height=CONFIG2_SIZE)
    cfg = RenderConfig(max_depth=4, rr_bounces=0, spp=CONFIG2_SPP)

    def loss2(params, key):
        s = dataclasses.replace(spheres, materials=dataclasses.replace(
            spheres.materials, albedo=params[0]))
        return pathtracer.render_spheres(s, s_lights, cam, cfg, key).mean()

    tr.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    bwd_s, grads = host_median(
        lambda: grad_of(loss2, (spheres.materials.albedo,), key0))
    peak = torch.cuda.max_memory_allocated(dev) / gib
    found = path_launches("config2 backward", SPHERE_PATH, tr.launch_counts)
    finite = bool(torch.isfinite(grads[0]).all())
    check(finite, "config2: non-finite gradient")
    print(f"[10c] config2 backward (spheres {CONFIG2_SIZE}x{CONFIG2_SIZE}, "
          f"spp {CONFIG2_SPP}, 4 bounces, d mean / d albedo): forward + "
          f"backward {bwd_s:.6f} s (median of {GRAD_REPS}), peak memory "
          f"{peak:.3f} GiB, gradient finite {finite}, max |g| "
          f"{float(grads[0].abs().max())}, launches {found}  [{card}]",
          flush=True)
    if profile:
        profile_frame(lambda: grad_of(loss2, (spheres.materials.albedo,),
                                      key0),
                      "config2 forward + backward", bwd_s, profile)

    # (d) config3's backward: d mean / d mat_diffuse of the Rubik grid.
    rubik = mesh.upload(flatten_models([rubik_grid()], pad_to=128), dev)
    cam = CameraConfig(width=CONFIG3_SIZE, height=CONFIG3_SIZE,
                       **CONFIG3_CAMERA)
    cfg = RenderConfig(max_depth=4, rr_bounces=0)

    def loss3(params, key):
        s = dataclasses.replace(rubik, mat_diffuse=params[0])
        return pathtracer.render(
            mesh.mesh_hit_fn(s, ray_tile=CONFIG3_RAY_TILE), lights, cam, cfg,
            key).mean()

    tr.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    bwd_s, grads = host_median(lambda: grad_of(loss3, (rubik.mat_diffuse,),
                                               key0))
    peak = torch.cuda.max_memory_allocated(dev) / gib
    found = path_launches("config3 backward", ONE_SUPER_PATH,
                          tr.launch_counts)
    finite = bool(torch.isfinite(grads[0]).all())
    check(finite, "config3: non-finite gradient")
    print(f"[10d] config3 backward (rubik_grid, {CONFIG3_SIZE}x"
          f"{CONFIG3_SIZE}, 4 bounces, ray_tile {CONFIG3_RAY_TILE}, d mean / "
          f"d mat_diffuse): forward + backward {bwd_s:.6f} s (median of "
          f"{GRAD_REPS}), peak memory {peak:.3f} GiB, gradient finite "
          f"{finite}, max |g| {float(grads[0].abs().max())}, launches "
          f"{found}  [{card}]", flush=True)
    if profile:
        profile_frame(lambda: grad_of(loss3, (rubik.mat_diffuse,), key0),
                      "config3 forward + backward", bwd_s, profile)

    # (e) Parity.  At config6's small size: the walk's gradients on the
    # card against the port's CPU run and against the dense sweep on the
    # card, on the pixels whose three images agree (an ulp on the card, or
    # the walk's edge slop, can flip one pixel's path, and vertex
    # gradients are sparse enough for one pixel to move them by percents).
    # CUDA's scatter-adds have no fixed order, so no gradient is bit for
    # bit.
    cpu = torch.device("cpu")
    cam = CameraConfig(width=GRAD_SMALL_SIZE, height=GRAD_SMALL_SIZE,
                       **HEADLINE_CAMERA)
    runs = {}
    for label, d, method in (("card walk", dev, "walk"),
                             ("CPU walk", cpu, "walk"),
                             ("card dense", dev, "dense")):
        small, _ = build_scene(d, *GRAD_SMALL_SPHERE)
        image, _ = mesh_loss(small, model_scene_lights(d), cam, cfg6, method)
        params = (small.mat_diffuse, small.positions)
        with torch.no_grad():
            runs[label] = (image, params, d, image(params, rng.key(0, d))
                           .cpu())
    imgs = [r[3] for r in runs.values()]
    stable = torch.ones(imgs[0].shape[:2], dtype=torch.bool)
    for x in imgs[1:]:
        stable &= torch.isclose(x, imgs[0], rtol=1e-4, atol=1e-5).all(-1)
    share = float(stable.float().mean())
    check(share >= 0.99, f"small config6: {100 * share:.2f}% of pixels agree")
    got = {}
    for label, (image, params, d, _) in runs.items():
        w = stable.to(d, torch.float32)[:, :, None] / float(stable.sum())
        got[label] = grad_of(lambda p, k: (image(p, k) * w).sum(), params,
                             rng.key(0, d))
        check_grads(f"small config6 {label}", got[label])
    e_cpu = rel_err(got["card walk"], got["CPU walk"])
    e_dense = rel_err(got["card walk"], got["card dense"])
    check(e_cpu <= GRAD_TOL, f"small config6: card vs CPU gradients "
                             f"differ by {e_cpu:.3e}")
    check(e_dense <= GRAD_TOL, f"small config6: walk vs dense gradients "
                               f"differ by {e_dense:.3e}")
    print(f"[10e] small config6 (uv_sphere{GRAD_SMALL_SPHERE}, "
          f"{GRAD_SMALL_SIZE}x{GRAD_SMALL_SIZE}) d mean / d (mat_diffuse, "
          f"positions) over the {int(stable.sum())} of {stable.numel()} "
          f"pixels whose images agree: |card walk - CPU walk| / |CPU walk| "
          f"{e_cpu:.3e}, |card walk - card dense| / |card dense| "
          f"{e_dense:.3e} (tolerance {GRAD_TOL}, L2 norms)  [{card}]",
          flush=True)

    # refit_accel on the card against the host build of the headline mesh:
    # the cluster boxes equal, the Woop rows within JAX's test tolerance
    # (rtol 2e-4, atol 2e-5) relative to the larger of |entry| and the
    # triangle's summed terms (``refit_scale``; a float32 refit of a thin
    # triangle cancels large terms, in the JAX package too).  Then a
    # frame on the refit tables against the frame on the uploaded ones.
    refit = mesh.refit_accel(scene)
    torch.cuda.synchronize()
    check(torch.equal(refit.cluster_min, scene.cluster_min)
          and torch.equal(refit.cluster_max, scene.cluster_max),
          "refit: cluster boxes differ from the host build")
    w = refit.woop.cpu().numpy().transpose(1, 0, 2).reshape(16, -1)
    h = scene.woop.cpu().numpy().transpose(1, 0, 2).reshape(16, -1)
    check(np.array_equal(np.isfinite(w), np.isfinite(h)),
          "refit: non-finite entries differ from the host build")
    fin = np.isfinite(h)
    err = np.abs(np.where(fin, w, 0.0) - np.where(fin, h, 0.0))
    scale = np.maximum(np.abs(np.where(fin, h, 0.0)), refit_scale(scene))
    beyond = int((err > 2e-5 + 2e-4 * scale).sum())
    plain_beyond = int((err > 2e-5 + 2e-4 * np.abs(np.where(fin, h, 0.0)))
                       .sum())
    check(beyond == 0, f"refit: {beyond} Woop entries beyond the tolerance")
    with torch.no_grad():
        a = image6(params6, key0)
        b = pathtracer.render(mesh.mesh_hit_fn(refit), lights, cam6, cfg6,
                              key0)
    share, max_err = image_agreement(b, a)
    same = float((a == b).all(-1).float().mean())
    check(share >= 0.995, f"refit frame: {100 * share:.3f}% of pixels within "
                          f"rtol 1e-4 / atol 1e-5")
    print(f"[10e] refit_accel of the headline mesh on the card: cluster "
          f"boxes equal to the host build, Woop rows within rtol 2e-4 / "
          f"atol 2e-5 of the triangle's scale ({plain_beyond} entries "
          f"beyond 2e-4 of |entry| alone; max |err| {float(err.max())}); "
          f"a config6 frame on the refit tables: {100 * same:.4f}% of "
          f"pixels bit-equal to the uploaded tables', max |err| {max_err}"
          f"  [{card}]", flush=True)
    print(f"[10] gradient phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def phase_textures_nee(scene, cases, profile, dev):
    """Phase 11: textures and next-event estimation (``bench_suite.py``'s
    config9 and config11), the textured render plan, card-vs-CPU parity
    and gradients."""
    import numpy as np
    import torch

    from srt_tpu_torch.bench_suite import (CONFIG11_CAMERA, config9_run,
                                           config9_scene, config11_frame,
                                           config11_scene)
    from srt_tpu_torch.camera import derive_viewport, generate_rays
    from srt_tpu_torch.config import CameraConfig, RenderConfig
    from srt_tpu_torch.models import mesh
    from srt_tpu_torch.models.emitters import (build_emitters,
                                               emitter_indices,
                                               scene_emitters)
    from srt_tpu_torch.models.fastpath import make_render_plan
    from srt_tpu_torch.ops import rng
    from srt_tpu_torch.ops import traversal as tr
    from srt_tpu_torch.scene import model_scene_lights
    from srt_tpu_torch.utils.flatten import flatten_models
    from srt_tpu_torch.utils.procgen import uv_sphere

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    lights = model_scene_lights(dev)

    # (a) config9: the headline mesh textured, through the scan.
    size = CONFIG9_SIZE
    t0 = time.perf_counter()
    tex = config9_scene(flatten_models([uv_sphere(*HEADLINE_SPHERE,
                                                  radius=2.0)],
                                       pad_to=128), dev)
    check(all(x.is_cuda for x in (tex.atlas, tex.atlas_rects,
                                  tex.atlas_mip_rects, tex.atlas_quad)),
          "config9: the atlas tables are not on the card")
    print(f"[11a] config9 scene: atlas {tuple(tex.atlas.shape)}, "
          f"{tex.atlas_mip_rects.shape[1]} levels, quad table "
          f"{tuple(tex.atlas_quad.shape)}, built in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    run_tex, hit_tex = config9_run(tex, lights, size)
    run_plain, hit_plain = config9_run(scene, lights, size)
    key0 = rng.key(0, dev)
    out = []
    launched = replay_frame("11a", lambda: out.append(run_tex(key0)), cases)
    check(launched == set(SCAN_MESH_PATH),
          f"the untimed config9 frame launched {sorted(launched)}")
    stats = out[0][1]
    rays = int(stats.sum())
    times, results, launches = {}, {}, {}
    for label, run in (("textured", run_tex), ("untextured", run_plain)):
        tr.reset_launch_counts()
        ts = []
        for _ in range(CONFIG9_FRAMES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results[label] = run(key0)
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        times[label] = ts
        launches[label] = path_launches(f"config9 {label}", SCAN_MESH_PATH,
                                        dict(tr.launch_counts))
    color, st = results["textured"]
    check(torch.equal(st, stats), "config9: the timed frame's stats differ "
                                  "from the replayed frame's")
    img = color.T.reshape(size, size, 3)
    mean = check_image("config9", img, size)
    # The textured albedo at the primary hits, against the untextured Kd.
    n = size * size
    cam = CameraConfig(width=size, height=size, **HEADLINE_CAMERA)
    o, d = generate_rays(derive_viewport(cam, device=dev), size, size,
                         torch.full((2, n), 0.5, device=dev))
    zero = torch.zeros(n, device=dev)
    rec_t = hit_tex(o, d, 1e-3, float("inf"), cone=(zero, zero))
    rec_p = hit_plain(o, d, 1e-3, float("inf"))
    hit = rec_p.hit
    check(torch.equal(rec_t.hit, hit), "config9: textured and untextured "
                                       "primaries hit differently")
    alb_diff = float((rec_t.mat.albedo - rec_p.mat.albedo).abs().amax(0)
                     [hit].mean())
    alb_std = float(rec_t.mat.albedo[:, hit].std(1).max())
    check(alb_diff > 0.05 and alb_std > 0.05,
          f"config9: textured albedo differs from Kd by {alb_diff} (mean), "
          f"spread {alb_std}")
    dt = {k: sum(v) / len(v) for k, v in times.items()}
    print(f"[11a] config9 textured {tex.model_tri_count[0]}-tri uv_sphere "
          f"{size}x{size}, 4 bounces, mip atlas + ray cones: frame times "
          f"(s) {[round(x, 6) for x in times['textured']]}, mean "
          f"{dt['textured'] * 1e3:.3f} ms, {rays / dt['textured'] / 1e6:.4f}"
          f" Mrays/s ({rays} rays a frame); untextured "
          f"{[round(x, 6) for x in times['untextured']]}, mean "
          f"{dt['untextured'] * 1e3:.3f} ms; textured / untextured time "
          f"{dt['textured'] / dt['untextured']:.4f}; image mean {mean:.6f}; "
          f"primary albedo vs Kd {alb_diff:.4f} (mean max-channel |diff|), "
          f"std {alb_std:.4f}; launches in {CONFIG9_FRAMES} frames "
          f"{launches['textured']}  [{cases.card}]", flush=True)
    if profile:
        profile_frame(lambda: run_tex(rng.key(99, dev)),
                      f"config9 textured {size}x{size} (scan)",
                      dt["textured"], profile)

    # (b) the textured headline through the render plan, ray cones on.
    cam = CameraConfig(width=TEX_PLAN_SIZE, height=TEX_PLAN_SIZE,
                       **HEADLINE_CAMERA)
    t0 = time.perf_counter()
    plan = make_render_plan(tex, lights, cam, RenderConfig(
        max_depth=4, rr_bounces=0, spp=1, ray_cones=True))
    torch.cuda.synchronize()
    print(f"[11b] textured plan: probe + schedule discovery "
          f"{time.perf_counter() - t0:.3f} s, schedule {plan.schedule}",
          flush=True)
    launched = replay_frame("11b", lambda: plan.render(rng.key(0, dev)),
                            cases)
    check(launched == set(HEADLINE_PATH),
          f"the untimed textured plan frame launched {sorted(launched)}")
    dt_plan = {}
    for label, s_ in (("textured", tex), ("untextured", scene)):
        if label == "untextured":
            plan = make_render_plan(s_, lights, cam, plan.cfg)
        dt_plan[label] = timed_frames(
            "11b", plan, cases, HEADLINE_PATH, TEX_PLAN_SIZE,
            f"{label} headline plan ({TEX_PLAN_SIZE}x{TEX_PLAN_SIZE}, 4 "
            f"bounces, ray cones)", frames=CONFIG9_FRAMES)[1]
        if profile:
            profile_frame(lambda: plan.render(rng.key(99, dev)),
                          f"{label} headline plan, ray cones",
                          dt_plan[label], profile)
    print(f"[11b] textured / untextured plan frame time "
          f"{dt_plan['textured'] / dt_plan['untextured']:.4f}  "
          f"[{cases.card}]", flush=True)
    del plan, run_tex, hit_tex

    # (c) config11: NEE off and on, the same hit fn and driver.
    scene11, dim = config11_scene(dev)
    hit11 = mesh.mesh_hit_fn(scene11, method="walk")
    em = scene_emitters(scene11)
    check(em is not None and em.v0.shape[0] == 12
          and all(x.is_cuda for x in em), "config11: emitter tables")
    size = CONFIG11_SIZE
    keys = rng.split(rng.key(11, dev), CONFIG11_KEYS)
    arms = {}
    for nee in (False, True):
        tag = "11c nee" if nee else "11c hit-only"
        frame = config11_frame(hit11, dim, em, size, nee)
        first = []
        launched = replay_frame(tag, lambda: first.append(frame(keys[0])),
                                cases)
        check(launched == set(ONE_SUPER_PATH),
              f"the config11 {tag} frame launched {sorted(launched)}")
        frames = []
        tr.reset_launch_counts()
        t0 = time.perf_counter()
        for k in keys:
            img, st, ovf = frame(k)
            check(int(ovf) == 0, f"config11 {tag}: overflow {int(ovf)}")
            frames.append(img.cpu().numpy())
        dt11 = (time.perf_counter() - t0) / len(keys)
        found = path_launches(f"config11 {tag}", ONE_SUPER_PATH,
                              dict(tr.launch_counts))
        check("cull" not in found, f"config11 {tag}: B1 launched on a "
                                   f"one-super scene")
        frames = np.stack(frames)
        check(bool(np.isfinite(frames).all()), f"config11 {tag}: "
                                               f"non-finite pixels")
        arms[nee] = (dt11, frames, first[0][1])
        print(f"[{tag}] config11 {size}x{size}, 3 bounces: "
              f"{dt11 * 1e3:.3f} ms a frame ({len(keys)} keys, host "
              f"clock with the copy out, as bench_suite.py), stats "
              f"{first[0][1].tolist()}, image mean {frames.mean():.6f}, "
              f"launches in {len(keys)} frames {found}  [{cases.card}]",
              flush=True)
    shadow = {nee: int(arms[nee][2][:, 1].sum()) for nee in arms}
    check(shadow[True] > shadow[False],
          f"config11: NEE shadow queries {shadow[True]} not above the "
          f"hit-only frame's {shadow[False]}")
    lum = arms[False][1].sum(-1)
    lit = lum.mean(0) > np.percentile(lum.mean(0), 80)
    rel_std = {nee: float(arms[nee][1].sum(-1).std(0)[lit].mean()
                          / max(arms[nee][1].sum(-1).mean(), 1e-9))
               for nee in arms}
    print(f"[11c] config11: frame {arms[True][0] * 1e3:.3f} ms with NEE, "
          f"{arms[False][0] * 1e3:.3f} ms without, ratio "
          f"{arms[True][0] / arms[False][0]:.4f}; emitter-lit relative "
          f"luminance std {rel_std[True]:.6f} with NEE, {rel_std[False]:.6f}"
          f" without, ratio {rel_std[True] / rel_std[False]:.4f}; shadow "
          f"queries {shadow[True]} vs {shadow[False]}  [{cases.card}]",
          flush=True)
    if profile:
        profile_frame(lambda: config11_frame(hit11, dim, em, size, True)(
            rng.key(99, dev)), f"config11 NEE {size}x{size}",
            arms[True][0], profile)
    cam11 = CameraConfig(width=size, height=size, **CONFIG11_CAMERA)
    plan11 = make_render_plan(scene11, dim, cam11, RenderConfig(
        max_depth=3, rr_bounces=0, nee=True))
    img, st, ovf = plan11.render(rng.key(1, dev))
    check(int(ovf) == 0 and plan11.emitters is not None,
          f"config11 NEE plan: overflow {int(ovf)}")
    check_image("config11 NEE plan", img, size)
    print(f"[11c] make_render_plan(nee=True): schedule {plan11.schedule}, "
          f"overflow 0, stats {st.tolist()}", flush=True)

    # (d) the card against the port's CPU run, one key on both devices.
    small_flat = flatten_models([uv_sphere(*PARITY11_SPHERE, radius=2.0)],
                                pad_to=128)
    size = PARITY11_SIZE
    got = {}
    for d_ in (dev, cpu):
        run, _ = config9_run(config9_scene(small_flat, d_),
                             model_scene_lights(d_), size)
        color, st = run(rng.key(5, d_))
        sc, dm = config11_scene(d_)
        img11, st11, _ = config11_frame(mesh.mesh_hit_fn(sc), dm,
                                        scene_emitters(sc), size,
                                        True)(rng.key(6, d_))
        got[d_.type] = ((color.T.reshape(size, size, 3).cpu(), st.cpu()),
                        (img11.cpu(), st11.cpu()))
    for k, label in enumerate(("textured + cones", "NEE")):
        (img_d, st_d), (img_c, st_c) = got[dev.type][k], got["cpu"][k]
        check(torch.equal(st_d, st_c), f"{label}: card stats "
                                       f"{st_d.tolist()}, CPU {st_c.tolist()}")
        check_image(label, img_d, size)
        share, err = image_agreement(img_d, img_c)
        check(share >= 0.995, f"{label}: {100 * share:.3f}% of pixels "
                              f"within rtol 1e-4 / atol 1e-5 of the CPU run")
        print(f"[11d] {label} {size}x{size}: card vs CPU stats equal "
              f"{st_d.tolist()}, max |err| {err}, {100 * (1 - share):.4f}% "
              f"of pixels differ beyond rtol 1e-4 / atol 1e-5  "
              f"[{cases.card}]", flush=True)

    # (e) gradients on the card: the atlas (no quad table), the emission.
    tex_g = config9_scene(small_flat, dev, quad_pack=False)
    atlas = tex_g.atlas.clone().requires_grad_(True)
    run, _ = config9_run(dataclasses.replace(tex_g, atlas=atlas), lights,
                         size)
    run(rng.key(5, dev))[0].mean().backward()
    peak_a = check_grads("d mean / d atlas", [atlas.grad])
    sc, dm = config11_scene(dev)
    ke = sc.mat_emissive.clone().requires_grad_(True)
    sc = dataclasses.replace(sc, mat_emissive=ke)
    em_g = build_emitters(sc, emitter_indices(sc))
    config11_frame(mesh.mesh_hit_fn(sc), dm, em_g, size, True)(
        rng.key(6, dev))[0].mean().backward()
    peak_k = check_grads("d mean / d mat_emissive", [ke.grad])
    print(f"[11e] gradients on the card: d mean / d atlas max |g| "
          f"{peak_a[0]:.6e} ({int((atlas.grad != 0).sum())} texels), d mean "
          f"/ d mat_emissive {ke.grad.tolist()}, max |g| {peak_k[0]:.6e}  "
          f"[{cases.card}]", flush=True)
    print(f"[11] texture and NEE phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def session_step(session, fetch):
    """One ``session.step(fetch=fetch)`` on the host clock, ending when the
    display is on the host (``fetch``) or finished on the card; returns
    (seconds, display)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    display = session.step(fetch=fetch)
    if not fetch:
        torch.cuda.synchronize()
    return time.perf_counter() - t0, display


def check_display(label, display, size):
    """A display image (numpy or tensor): [size, size, 3], finite, within
    [0, 1]; returns (min, max, mean)."""
    import torch
    d = torch.as_tensor(display)
    check(tuple(d.shape) == (size, size, 3),
          f"{label}: display shape {tuple(d.shape)}")
    check(bool(torch.isfinite(d).all()), f"{label}: non-finite display")
    lo, hi = float(d.min()), float(d.max())
    check(0.0 <= lo and hi <= 1.0, f"{label}: display in [{lo}, {hi}]")
    return lo, hi, float(d.mean())


def phase_app(scene, cases, profile, dev):
    """Phase 12: the app layer, ``RenderSession``'s progressive frame
    loop on the headline mesh, and the trainer's checkpoint resume."""
    import tempfile

    import torch

    from srt_tpu_torch import app, optim
    from srt_tpu_torch.bench_suite import mesh_loss
    from srt_tpu_torch.config import CameraConfig, RenderConfig
    from srt_tpu_torch.models.fastpath import make_render_plan
    from srt_tpu_torch.models.wavefront_compact import GRANULE
    from srt_tpu_torch.ops import rng
    from srt_tpu_torch.ops import traversal as tr
    from srt_tpu_torch.ops.rng import KeyStream
    from srt_tpu_torch.scene import model_scene_lights
    from srt_tpu_torch.utils.profiling import RaysPerSecondMeter

    t_phase = time.perf_counter()
    card = cases.card
    size = HEADLINE_SIZE
    n = size * size
    lights = model_scene_lights(dev)
    cam = CameraConfig(width=size, height=size, **HEADLINE_CAMERA)
    cfg = RenderConfig(max_depth=4, rr_bounces=0, spp=1)
    key0 = rng.key(0, dev)

    # (a) The headline session: SESSION_FRAMES frames with the launch
    # counts zeroed just before and read just after, then SESSION_TIMED
    # rounds of one plan frame at the session's pose (the key of the
    # session's next frame), one fetch=True and one fetch=False step.
    t0 = time.perf_counter()
    session = app.RenderSession(None, lights, cam, cfg, scene=scene,
                                fast=True)
    torch.cuda.synchronize()
    check(session._fast, "the headline session did not take the fast path")
    print(f"[12a] session: probe + schedule {time.perf_counter() - t0:.3f} s,"
          f" schedule {session.schedule}; camera {session.camera.position} "
          f"toward {session.camera.look_at()}", flush=True)
    tr.reset_launch_counts()
    for _ in range(SESSION_FRAMES):
        display = session.step()
    found = path_launches("session", HEADLINE_PATH, tr.launch_counts)
    check(session.frames_accumulated == SESSION_FRAMES,
          f"session: {session.frames_accumulated} frames accumulated")
    lo, hi, mean = check_display("session", display, size)
    print(f"[12a] {SESSION_FRAMES} frames: frames_accumulated "
          f"{session.frames_accumulated}, display finite in [{lo}, {hi}], "
          f"mean {mean:.6f}; launches {found}, a frame "
          f"{ {k: v / SESSION_FRAMES for k, v in found.items()} }",
          flush=True)
    plan = make_render_plan(scene, lights, session.camera.config(cam), cfg)
    runs = {"plan at the session's pose": [],
            "session, fetch=True": [], "session, fetch=False": []}
    meters = {k: RaysPerSecondMeter() for k in runs}
    for _ in range(SESSION_TIMED):
        key = rng.fold_in(key0, session._frame_index)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, stats, overflow = plan.render(key)
        torch.cuda.synchronize()
        steps = [time.perf_counter() - t0]
        check(int(overflow) == 0, "session-pose plan: overflow")
        steps.append(session_step(session, True)[0])
        dt, display = session_step(session, False)
        steps.append(dt)
        for (label, ts), dt in zip(runs.items(), steps):
            ts.append(dt)
            meters[label].add(stats, dt)
    check(isinstance(display, torch.Tensor) and display.is_cuda,
          "fetch=False: the display is not a tensor on the card")
    check_display("session, fetch=False", display, size)
    rays = int(stats.sum())
    for label, ts in runs.items():
        mean = sum(ts) / len(ts)
        print(f"[12a] {label}: {mean * 1e3:.3f} ms a frame (mean of "
              f"{len(ts)}, median {sorted(ts)[len(ts) // 2] * 1e3:.3f} ms; "
              f"{1.0 / mean:.3f} fps), {meters[label].mrays_per_s:.4f} "
              f"Mrays/s (RaysPerSecondMeter, the plan's stats: {rays} rays "
              f"a frame)  [{card}]", flush=True)
    print(f"[12a] times (s): " + "; ".join(
        f"{label} {[round(t, 6) for t in ts]}" for label, ts in runs.items()),
        flush=True)
    if profile:
        profile_frame(lambda: session.step(fetch=False),
                      "headline session step (fetch=False)",
                      sum(runs["session, fetch=False"]) / SESSION_TIMED,
                      profile)

    # (b) A move clears the accumulation; the next frame's sample is the
    # frame of a plan built at the moved pose from the same folded key.
    session.move(forward=0.5)
    check(session.frames_accumulated == 0 and not bool(session._accum.any()),
          "move: the accumulation was not cleared")
    index = session._frame_index
    session.step(fetch=False)
    moved = make_render_plan(scene, lights, session.camera.config(cam), cfg)
    img, stats, overflow = moved.render(rng.fold_in(key0, index))
    check(int(overflow) == 0, "moved plan: overflow")
    share, err = image_agreement(session._accum, img)
    check(torch.equal(session._accum, img),
          f"the moved session frame differs from the plan's frame at that "
          f"pose: max |err| {err}, {100 * share:.4f}% of pixels within "
          f"rtol 1e-4 / atol 1e-5")
    print(f"[12b] move(forward=0.5): frames_accumulated 0, then frame "
          f"{index} at {session.camera.position} equals make_render_plan at "
          f"camera.config(cam) on fold_in(key(0), {index}) bit for bit "
          f"(session schedule {session.schedule}, plan schedule "
          f"{moved.schedule})  [{card}]", flush=True)

    # (c) The overflow path: a session probed facing away from the sphere
    # (all sky: the minimum schedule), then turned to face it.
    away = CameraConfig(width=size, height=size, **OVERFLOW_CAMERA)
    turned = app.RenderSession(None, lights, away, cfg, scene=scene,
                               fast=True)
    least = turned.schedule
    check(least == (n,) + (GRANULE,) * 3,
          f"facing away: schedule {least}, not the minimum")
    turned.rotate(180.0, 0.0)
    calls = []
    real = app.trace_image_compact

    def spy(*args, **kw):
        calls.append(args[5])
        return real(*args, **kw)

    app.trace_image_compact = spy
    try:
        turned.step(fetch=False)
        first = turned._accum.clone()
        retraced = list(calls)
        calls.clear()
        turned.step(fetch=False)
        after = list(calls)
    finally:
        app.trace_image_compact = real
    full = (n,) * 4
    check(retraced == [least, full], f"turned frame: schedules {retraced}, "
                                     f"not one overflow and a full retrace")
    check(turned.schedule == full and after == [full],
          f"the widened schedule did not stay: {turned.schedule}, {after}")
    want, stats, overflow = real(
        turned._hit_fns, lights, away, turned._fast_cfg,
        KeyStream(rng.fold_in(key0, 0), n), full,
        origin=turned.camera.position, look_at=turned.camera.look_at(),
        return_stats=True)
    check(int(overflow) == 0 and torch.equal(first, want),
          f"the retraced frame differs from the full-width frame at its pose"
          f" (max |err| {float((first - want).abs().max())})")
    print(f"[12c] overflow: probed facing away from {away.origin}, schedule "
          f"{least}; after rotate(180, 0) the next frame overflowed (alive "
          f"{stats[:, 0].tolist()}), was traced again at {full}, equals the "
          f"full-width frame at that pose bit for bit, and the schedule "
          f"stayed {turned.schedule}  [{card}]", flush=True)
    del turned, first, want

    # (d) Every kernel launch of one session frame replayed through its
    # plain version (outputs equal) and timed beside its bound.
    launched = replay_frame("12d", lambda: session.step(fetch=False), cases)
    check(launched == set(HEADLINE_PATH),
          f"the replayed session frame launched {sorted(launched)}")

    # (e) The card against the CPU: a session on the phase-11 parity mesh
    # (3 superclusters: the scan over the walk) and one on a mesh of 10
    # (the fast path), 2 frames, a move and 1 frame on both devices.
    cpu = torch.device("cpu")
    for rows_cols in (PARITY11_SPHERE, SESSION_PARITY_SPHERE):
        got = {}
        for d_ in (dev, cpu):
            sc, _ = build_scene(d_, *rows_cols)
            s = app.RenderSession(
                None, model_scene_lights(d_),
                CameraConfig(width=PARITY12_SIZE, height=PARITY12_SIZE,
                             **HEADLINE_CAMERA), cfg, scene=sc, fast=True)
            s.run(2)
            s.move(forward=0.5, strafe=0.25)
            s.step()
            got[d_.type] = (s._fast, s.schedule, s._accum.cpu())
        (fast_d, sched_d, acc_d), (fast_c, sched_c, acc_c) = \
            got[dev.type], got["cpu"]
        check(fast_d == fast_c and sched_d == sched_c,
              f"uv_sphere{rows_cols}: card and CPU sessions differ in route "
              f"or schedule ({fast_d}, {sched_d}; {fast_c}, {sched_c})")
        share, err = image_agreement(acc_d, acc_c)
        check(share >= 0.995, f"uv_sphere{rows_cols} session: "
                              f"{100 * share:.3f}% of pixels within rtol "
                              f"1e-4 / atol 1e-5 of the CPU run")
        print(f"[12e] uv_sphere{rows_cols} session "
              f"({'fast path' if fast_d else 'scan'}), {PARITY12_SIZE}x"
              f"{PARITY12_SIZE}, 3 frames and a move: card vs CPU max |err| "
              f"{err}, {100 * (1 - share):.4f}% of pixels differ beyond "
              f"rtol 1e-4 / atol 1e-5  [{card}]", flush=True)

    # (f) Validation: every second frame of a headline session; an
    # injected NaN texel is healed.
    checked = app.RenderSession(None, lights, cam, cfg, scene=scene,
                                fast=True, validate_every=2)
    checked.run(2)
    report = checked.metrics["last_report"]
    check(report is not None and report.ok, f"validation: {report}")
    checked._accum[5, 7, 1] = float("nan")
    checked.run(2)
    healed = checked.metrics["healed_texels"]
    check(healed == 1 and bool(torch.isfinite(checked._accum).all()),
          f"validation: {healed} texels healed, "
          f"{checked.metrics['last_report']}")
    print(f"[12f] validate_every=2: frame 2 {report}; a NaN texel injected "
          f"before frame 3 is healed at frame 4 (healed_texels {healed})  "
          f"[{card}]", flush=True)
    del checked

    # (g) config10b's trainer with a checkpoint: CONFIG10B_STEPS steps
    # twice straight, and half of them plus a resume to the end; the
    # resumed parameters may differ from the straight run's by no more
    # than the two straight runs differ.
    cam6 = CameraConfig(width=CONFIG6_SIZE, height=CONFIG6_SIZE,
                        **HEADLINE_CAMERA)
    cfg6 = RenderConfig(max_depth=2, rr_bounces=0, spp=1, sort_bounces=True)
    image6, _ = mesh_loss(scene, lights, cam6, cfg6)
    with torch.no_grad():
        target = image6((scene.mat_diffuse, scene.positions),
                        rng.key(3, dev))
    params0 = (scene.mat_diffuse * 0.9, scene.positions * 1.001)

    def train(steps, path=None):
        return optim.run_inverse_rendering(
            image6, params0, target, rng.key(3, dev), steps=steps,
            learning_rate=1e-3, fixed_noise=True, log_every=0,
            checkpoint_path=path, checkpoint_every=1)

    half = CONFIG10B_STEPS // 2
    straight = [train(CONFIG10B_STEPS) for _ in range(2)]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "config10b.npz")
        first = train(half, path)
        resumed = train(CONFIG10B_STEPS, path)
    check(len(first.losses) == half
          and len(resumed.losses) == CONFIG10B_STEPS - half,
          f"checkpoint resume ran {len(first.losses)} + "
          f"{len(resumed.losses)} steps")
    spread = rel_err(straight[1].params, straight[0].params)
    off = rel_err(resumed.params, straight[0].params)
    check(off <= spread, f"the resumed parameters differ from the straight "
                         f"run's by {off:.3e} (L2, relative), two straight "
                         f"runs by {spread:.3e}")
    print(f"[12g] config10b checkpoint: {half} steps, then a resume to "
          f"{CONFIG10B_STEPS}: losses {first.losses} + {resumed.losses}, "
          f"straight {straight[0].losses}; parameters differ from the "
          f"straight run's by {off:.3e}, two straight runs by {spread:.3e} "
          f"(L2, relative)  [{card}]", flush=True)
    print(f"[12] app phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def welded(grad, positions):
    """Rows of a vertex-buffer gradient summed per welded vertex (rows of
    ``positions`` equal to 1e-6: a ``uv_sphere`` seam repeats its vertices
    at coordinates 1e-15 apart)."""
    import torch
    _, inv = torch.unique(torch.round(positions.detach().cpu() * 1e6),
                          dim=0, return_inverse=True)
    return torch.zeros((int(inv.max()) + 1, 3), dtype=torch.float64
                       ).index_add_(0, inv, grad.cpu().double())


def ea_parity(tag, label, make, dev, card, weld=False):
    """Phase 13's card-vs-CPU gate.  ``make(d)`` returns (image(params),
    params) on device d.  The images meet the image criterion of 9a; the
    gradients of their mean over the pixels whose images agree meet the
    CPU tests' tolerance (rtol 1e-4, atol 1e-4 x max |CPU|, entry by
    entry), with ``weld`` per welded vertex: ``procgen`` meshes keep each
    triangle's corners, and where two copies of one edge are equally near
    (a shared edge met from both sides, a sphere's seam), an ulp decides
    whose rows take the gradient (ROADMAP.md C)."""
    import torch
    runs = {}
    for d in (dev, torch.device("cpu")):
        image, params = make(d)
        with torch.no_grad():
            img = image(params)
        runs[d.type] = (image, params, d, img.cpu())
    img_d, img_c = runs[dev.type][3], runs["cpu"][3]
    check(bool(torch.isfinite(img_d).all()), f"{label}: non-finite pixels")
    share, err = image_agreement(img_d, img_c)
    check(share >= 0.995, f"{label}: {100 * share:.3f}% of pixels within "
                          f"rtol 1e-4 / atol 1e-5 of the CPU run")
    stable = torch.isclose(img_d, img_c, rtol=1e-4, atol=1e-5).all(-1)
    grads = {}
    for name, (image, params, d, _) in runs.items():
        w = stable.to(d, torch.float32)[:, :, None] / float(stable.sum())
        grads[name] = grad_of(lambda p, _k: (image(p) * w).sum(), params,
                              None)
    worst = 0.0
    for k, (g_d, g_c) in enumerate(zip(grads[dev.type], grads["cpu"])):
        g_d = g_d.cpu()
        if weld:
            pos = runs["cpu"][1][k]
            g_d, g_c = welded(g_d, pos), welded(g_c, pos)
        scale = float(g_c.abs().max())
        check(scale > 0.0 and bool(torch.isfinite(g_d).all()),
              f"{label}: a zero or non-finite gradient")
        worst = max(worst, float(((g_d - g_c).abs()
                                  / (1e-4 * g_c.abs() + 1e-4 * scale)).max()))
    check(worst <= 1.0, f"{label}: card gradients beyond rtol 1e-4 / atol "
                        f"1e-4 x max of the CPU run's ({worst:.3f} of it)")
    print(f"[{tag}] {label}: card vs CPU image max |err| {err}, "
          f"{100 * (1 - share):.4f}% of pixels beyond rtol 1e-4 / atol 1e-5;"
          f" gradients{' per welded vertex' if weld else ''} over the "
          f"{int(stable.sum())} agreeing pixels within {worst:.4f} of rtol "
          f"1e-4 / atol 1e-4 x max  [{card}]", flush=True)


def phase_edge_aware(scene, cases, profile, dev):
    """Phase 13: edge-aware gradients (``bench_suite.py``'s config10a,
    the walk on a multi-super mesh, soft shadows with the global search,
    the sphere route) and their parity with the CPU."""
    import numpy as np
    import torch

    from srt_tpu_torch import optim
    from srt_tpu_torch.camera import derive_viewport, generate_rays
    from srt_tpu_torch.config import CameraConfig, RenderConfig
    from srt_tpu_torch.models import edge_aware, edge_aware_mesh, mesh
    from srt_tpu_torch.ops import rng
    from srt_tpu_torch.ops import traversal as tr
    from srt_tpu_torch.scene import (default_sphere_scene,
                                     model_scene_lights, sphere_scene_lights)
    from srt_tpu_torch.utils.flatten import flatten_models
    from srt_tpu_torch.utils.obj_loader import compute_vertex_normals
    from srt_tpu_torch.utils.procgen import rubik_grid, uv_sphere

    t_phase = time.perf_counter()
    card = cases.card
    gib = 2.0 ** 30
    cfg = RenderConfig(max_depth=2, rr_bounces=0, morton_order=False)

    def config10a(d, size):
        """The Rubik grid (324 triangles, one super) and config10a's
        ``render_ea`` (``bench_suite.py:497-503``) on device d."""
        rubik = mesh.upload(flatten_models([rubik_grid()], pad_to=128), d)
        cam = CameraConfig(width=size, height=size, **CONFIG3_CAMERA)
        lights = model_scene_lights(d)

        def image(positions, key):
            return edge_aware_mesh.render_edge_aware_mesh(
                mesh.with_positions(rubik, positions), lights, cam, cfg, key,
                method="walk", search="ring", rings=1)
        return rubik, cam, image

    # (a) config10a: 6 fixed-noise Adam steps on the vertex buffer toward
    # the image of the true vertices (key 7), step 0 dropped from the mean.
    rubik, cam, image = config10a(dev, CONFIG10A_SIZE)
    key7 = rng.key(7, dev)
    with torch.no_grad():
        target = image(rubik.positions, key7)
        fwd_s, _ = host_median(lambda: image(rubik.positions, key7))
    check_image("config10a target", target, CONFIG10A_SIZE)
    # A step's kernels are its forward's (no kernel runs in a backward):
    # every launch of one forward replayed through its plain version.
    launched = replay_frame("13a", lambda: image(rubik.positions, key7),
                            cases)
    check(launched == set(ONE_SUPER_PATH),
          f"the config10a forward launched {sorted(launched)}")

    def loss(params, key):
        return image(params[0], key).mean()

    torch.cuda.reset_peak_memory_stats(dev)
    bwd_s, grads = host_median(lambda: grad_of(loss, (rubik.positions,),
                                               key7))
    bwd_peak = torch.cuda.max_memory_allocated(dev) / gib
    mags = check_grads("config10a", grads)
    stamps = [time.perf_counter()]
    tr.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    res = optim.run_inverse_rendering(
        image, rubik.positions * 1.002, target, key7, steps=CONFIG10A_STEPS,
        learning_rate=2e-3, fixed_noise=True, log_every=0,
        callback=lambda i, p, loss_i: stamps.append(time.perf_counter()))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) / gib
    launches = {k: v for k, v in tr.launch_counts.items() if v}
    check(launches.get("intersect", 0) > 0 and launches.get("threefry", 0)
          > 0 and not launches.get("cull"),
          f"config10a launched {launches} (B2 and threefry, no B1: one "
          f"super)")
    losses = res.losses
    check(len(losses) == CONFIG10A_STEPS and np.isfinite(losses).all()
          and min(losses) <= losses[0], f"config10a: losses {losses}")
    step_s = float(np.diff(stamps)[1:].mean())
    per_step = {k: v / CONFIG10A_STEPS for k, v in launches.items()}
    print(f"[13a] config10a (rubik_grid, {CONFIG10A_SIZE}x{CONFIG10A_SIZE}, "
          f"2 bounces, render_edge_aware_mesh walk, ring search, 1 ring; "
          f"{CONFIG10A_STEPS} fixed-noise Adam steps at 2e-3 from positions "
          f"x 1.002): {step_s:.6f} s/step (mean of steps 1-"
          f"{CONFIG10A_STEPS - 1}), step 0 {stamps[1] - stamps[0]:.6f} s, "
          f"losses {losses}, min/first {min(losses) / losses[0]:.6f}; "
          f"forward {fwd_s * 1e3:.3f} ms, forward + backward "
          f"{bwd_s * 1e3:.3f} ms (median of {GRAD_REPS} after a warm call),"
          f" max |g| {mags}; peak memory {peak:.3f} GiB in the steps, "
          f"{bwd_peak:.3f} GiB in a gradient; launches a step {per_step}  "
          f"[{card}]", flush=True)
    if profile:
        profile_frame(lambda: image(rubik.positions, key7),
                      "config10a forward", fwd_s, profile)
        profile_frame(lambda: grad_of(loss, (rubik.positions,), key7),
                      "config10a forward + backward", bwd_s, profile)

    # (b) The walk on a multi-super mesh: one trace_edge_aware_mesh frame
    # of the headline mesh (50 supers) whose every launch is replayed
    # through its plain version and timed beside its bound.
    size = EA_WALK_SIZE
    cam = CameraConfig(width=size, height=size, **HEADLINE_CAMERA)
    lights = model_scene_lights(dev)
    stream0 = rng.fold_in(rng.key(0, dev), 0)
    out = []
    launched = replay_frame(
        "13b", lambda: out.append(edge_aware_mesh.trace_edge_aware_mesh(
            scene, lights, cam, cfg, rng.KeyStream(stream0, size * size),
            method="walk", search="ring", rings=1)), cases)
    check(launched == set(SCAN_MESH_PATH),
          f"the edge-aware headline frame launched {sorted(launched)}")
    mean = check_image("edge-aware headline", out[0], size)
    print(f"[13b] edge-aware headline frame ({scene.model_tri_count[0]}-tri "
          f"uv_sphere, {size}x{size}, 2 bounces, walk, ring search): image "
          f"mean {mean:.6f}  [{card}]", flush=True)

    # (c) config10a's frame and vertex gradient at 32x32 on the card
    # against the CPU; the primary winners equal.
    def make10a(d):
        rub, _, img = config10a(d, EA_PARITY_SIZE)
        return (lambda p: img(p[0], rng.key(7, d))), [rub.positions]

    winners = {}
    for d in (dev, torch.device("cpu")):
        rub, cam_s, _ = config10a(d, EA_PARITY_SIZE)
        n = EA_PARITY_SIZE * EA_PARITY_SIZE
        jitter = rng.KeyStream(rng.fold_in(rng.key(7, d), 0), n).take(2)
        o, dd = generate_rays(derive_viewport(cam_s, device=d),
                              EA_PARITY_SIZE, EA_PARITY_SIZE, jitter)
        hit, _, tri, _ = edge_aware_mesh._primary_winner(rub, o, dd,
                                                         cfg.t_min, "walk")
        winners[d.type] = (hit.cpu(), tri.cpu())
    check(all(torch.equal(a, b) for a, b in zip(winners[dev.type],
                                                winners["cpu"])),
          "config10a 32x32: card and CPU primary winners differ")
    ea_parity("13c", f"config10a {EA_PARITY_SIZE}x{EA_PARITY_SIZE} (primary "
              f"winners equal, {int(winners['cpu'][0].sum())} hits)",
              make10a, dev, card, weld=True)

    # (d) Soft shadows and the global search on a 13,312-triangle sphere
    # (the production-scale scene of tests/test_mesh_silhouette.py).
    def global_scene(d):
        flat = flatten_models([compute_vertex_normals(
            uv_sphere(*GLOBAL_SPHERE, radius=2.0))], pad_to=128)
        return mesh.upload(flat, d)

    cfg_g = RenderConfig(max_depth=1, rr_bounces=0, morton_order=False)

    def global_image(d, w, h):
        sc = global_scene(d)
        cam_g = CameraConfig(width=w, height=h, **HEADLINE_CAMERA)
        lights_g = model_scene_lights(d)
        key = rng.fold_in(rng.key(17, d), 0)

        def img(params):
            return edge_aware_mesh.trace_edge_aware_mesh(
                mesh.with_positions(sc, params[0]), lights_g, cam_g, cfg_g,
                rng.KeyStream(key, w * h), method="walk", search="global",
                soft_shadow_band=0.1)
        return img, [sc.positions]

    img_g, params_g = global_image(dev, GLOBAL_SIZE, GLOBAL_SIZE)
    n_tris = 2 * GLOBAL_SPHERE[0] * GLOBAL_SPHERE[1]
    tr.reset_launch_counts()
    with torch.no_grad():
        g_fwd_s, frame = host_median(lambda: img_g(params_g), reps=1)
    check_image("global search", frame, GLOBAL_SIZE)
    torch.cuda.reset_peak_memory_stats(dev)
    g_bwd_s, grads = host_median(
        lambda: grad_of(lambda p, _k: img_g(p).mean(), params_g, None),
        reps=1)
    g_peak = torch.cuda.max_memory_allocated(dev) / gib
    mags = check_grads("global search", grads)
    found = path_launches("global search", SCAN_MESH_PATH, tr.launch_counts)
    print(f"[13d] uv_sphere{GLOBAL_SPHERE} with vertex normals "
          f"({n_tris} triangles), {GLOBAL_SIZE}x"
          f"{GLOBAL_SIZE}, 1 bounce, global search, soft_shadow_band 0.1: "
          f"forward {g_fwd_s * 1e3:.3f} ms, forward + backward "
          f"{g_bwd_s * 1e3:.3f} ms (one after a warm call), peak memory "
          f"{g_peak:.3f} GiB, max |g| {mags}, launches {found}  [{card}]",
          flush=True)
    w, h = GLOBAL_PARITY
    ea_parity("13d", f"global search {w}x{h}",
              lambda d: global_image(d, w, h), dev, card, weld=True)

    # (e) The sphere route (plain PyTorch: threefry is its only kernel).
    size = EA_SPHERE_SIZE
    spheres, s_lights = default_sphere_scene(dev), sphere_scene_lights(dev)
    cam = CameraConfig(width=size, height=size)
    key = rng.fold_in(rng.key(9, dev), 0)
    times = {}
    for name, fn in (("trace_edge_aware", edge_aware.trace_edge_aware),
                     ("trace_edge_aware_reflection",
                      edge_aware.trace_edge_aware_reflection)):
        with torch.no_grad():
            times[name], img = host_median(lambda: fn(
                spheres, s_lights, cam, cfg, rng.KeyStream(key, size * size)))
        check_image(name, img, size)
    print(f"[13e] spheres {size}x{size}, 2 bounces: trace_edge_aware "
          f"{times['trace_edge_aware'] * 1e3:.3f} ms, "
          f"trace_edge_aware_reflection "
          f"{times['trace_edge_aware_reflection'] * 1e3:.3f} ms (median of "
          f"{GRAD_REPS} after a warm call)  [{card}]", flush=True)
    for name in ("trace_edge_aware", "trace_edge_aware_reflection"):
        def make_s(d, name=name):
            sph = default_sphere_scene(d)
            lts = sphere_scene_lights(d)
            cam_s = CameraConfig(width=EA_PARITY_SIZE, height=EA_PARITY_SIZE)
            k = rng.fold_in(rng.key(9, d), 0)
            return (lambda p: getattr(edge_aware, name)(
                dataclasses.replace(sph, center=p[0], radius=p[1]), lts,
                cam_s, cfg, rng.KeyStream(k, EA_PARITY_SIZE ** 2))), \
                [sph.center, sph.radius]
        ea_parity("13e", f"{name} {EA_PARITY_SIZE}x{EA_PARITY_SIZE}", make_s,
                  dev, card)
    print(f"[13] edge-aware phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def sharded_walk(scene, lights, mesh, size, key, multihost=False):
    """Phase 14b/c: the headline mesh through the walk at size x size, the
    headline camera, spp 1, 2 bounces: ``render_sharded`` over ``mesh``,
    or with ``multihost`` ``render_multihost`` of ``fold_in(key, 0)`` (the
    same uniforms: a numpy image)."""
    from srt_tpu_torch.config import CameraConfig, RenderConfig
    from srt_tpu_torch.models import mesh as mesh_mod
    from srt_tpu_torch.ops import rng
    from srt_tpu_torch.parallel import render_sharded
    from srt_tpu_torch.parallel.multihost import render_multihost
    cam = CameraConfig(width=size, height=size, **HEADLINE_CAMERA)
    cfg = RenderConfig(max_depth=2, rr_bounces=0)

    def walk(s):
        return mesh_mod.mesh_hit_fn(s, method="walk")
    if multihost:
        return render_multihost(walk, scene, lights, cam, cfg,
                                rng.fold_in(key, 0), mesh)
    return render_sharded(walk, scene, lights, cam, cfg, key, mesh)


def config7_grads(c7, mesh, key):
    """d mean(image^2) / d (mat_diffuse, positions) of config7 through
    ``render_sharded`` (``tests/test_parallel.py:171-205``'s train step):
    (loss, d diffuse, d positions, elements all-reduced a step)."""
    import torch

    from srt_tpu_torch.models.mesh import with_positions
    from srt_tpu_torch.parallel import render_sharded
    make_hit, scene, lights, cam, cfg = c7
    diffuse = scene.mat_diffuse.clone().requires_grad_(True)
    positions = scene.positions.clone().requires_grad_(True)
    s = with_positions(dataclasses.replace(scene, mat_diffuse=diffuse),
                       positions)
    loss = (render_sharded(make_hit, s, lights, cam, cfg, key, mesh)
            ** 2).mean()
    g_d, g_p = torch.autograd.grad(loss, (diffuse, positions))
    # The tensors _Replicated routes: mat_diffuse, positions, tri_v0..2.
    elems = sum(x.numel() for x in (s.mat_diffuse, s.positions, s.tri_v0,
                                    s.tri_v1, s.tri_v2))
    return float(loss.detach()), g_d, g_p, elems


def unsharded_image(make_hit, scene, lights, cam, cfg, key):
    """What ``render_sharded`` computes, with no mesh: ``trace_wavefront``
    over ``_draw_uniforms(fold_in(key, s))`` for each sample, averaged."""
    import torch

    from srt_tpu_torch.camera import derive_viewport, generate_rays
    from srt_tpu_torch.models.pathtracer import trace_wavefront
    from srt_tpu_torch.ops import rng
    from srt_tpu_torch.parallel.render_sharded import _draw_uniforms
    n = cam.width * cam.height
    acc = torch.zeros((3, n), device=key.device)
    for s in range(cfg.spp):
        u = _draw_uniforms(rng.fold_in(key, s), n, lights.count,
                           cfg.max_depth + cfg.rr_bounces)
        o, d = generate_rays(derive_viewport(cam, device=key.device),
                             cam.width, cam.height, u[:, 0:2].T)
        stream = rng.ArrayStream(u)
        stream.take(2)
        acc = acc + trace_wavefront(make_hit(scene), lights, o, d, stream,
                                    cfg)
    return (acc / cfg.spp).T.reshape(cam.height, cam.width, 3)


def sharded_rank(rank, world, device, sphere, walk_size, c7_size):
    """Phase 14c: one rank of the gloo world on the one card (``device``
    None: ``cuda:0`` for every rank; the sizes are passed, as a spawned
    rank imports this module afresh).  Returns the headline walk frame
    (gathered, and through ``render_multihost``) with its launch counts,
    config7's image and gradients, and the host ms of one all-gather of
    the walk frame's radiance and one all-reduce of config7's gradient
    buffer at this world's shapes."""
    import torch
    import torch.distributed as dist

    from srt_tpu_torch.bench_suite import config7_case
    from srt_tpu_torch.ops import rng
    from srt_tpu_torch.ops import traversal as tr
    from srt_tpu_torch.parallel import device_mesh
    from srt_tpu_torch.parallel.mesh import rank_device
    from srt_tpu_torch.parallel.render_sharded import (_gather_columns,
                                                       _rays_order)
    from srt_tpu_torch.scene import model_scene_lights
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = rank_device(device)
    mesh = device_mesh(world, 1, device=device)
    scene, _ = build_scene(dev, *sphere)
    lights = model_scene_lights(dev)
    key = rng.key(14, dev)
    tr.reset_launch_counts()
    img = sharded_walk(scene, lights, mesh, walk_size, key)
    synchronize()
    launches = {k: v for k, v in tr.launch_counts.items() if v}
    tile_img = sharded_walk(scene, lights, mesh, walk_size, key,
                            multihost=True)
    c7 = config7_case(dev, c7_size)
    img7 = render_sharded_of(c7, rng.key(7, dev), mesh)
    loss, g_d, g_p, elems = config7_grads(c7, mesh, rng.key(3, dev))
    group = mesh.get_group("rays")
    order = _rays_order(mesh, group)
    local = torch.rand((3, walk_size ** 2 // world), device=dev)
    flat = torch.rand((elems,), device=dev)
    gather_s, _ = host_median(lambda: _gather_columns(local, group, order),
                              reps=5)
    reduce_s, _ = host_median(lambda: dist.all_reduce(flat, group=group),
                              reps=5)
    return dict(
        walk=img.cpu(), launches=launches, multihost=tile_img,
        config7=img7.cpu(), grads=(loss, g_d.cpu(), g_p.cpu()),
        gather=(gather_s * 1e3, local.numel()),
        reduce=(reduce_s * 1e3, elems))


def render_sharded_of(case, key, mesh):
    from srt_tpu_torch.parallel import render_sharded
    make_hit, scene, lights, cam, cfg = case
    return render_sharded(make_hit, scene, lights, cam, cfg, key, mesh)


def phase_sharded(scene, cases, profile, dev):
    """Phase 14: sharded rendering (``srt_tpu_torch.parallel``) in a world
    of 1 (NCCL) and a world of 2 (gloo, both ranks on the card), and the
    BVH stack route."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from srt_tpu_torch.bench_suite import config5_case, config7_case
    from srt_tpu_torch.camera import derive_viewport, generate_rays
    from srt_tpu_torch.config import CameraConfig
    from srt_tpu_torch.models import mesh as mesh_mod
    from srt_tpu_torch.models import wavefront
    from srt_tpu_torch.ops import rng
    from srt_tpu_torch.ops import traversal as tr
    from srt_tpu_torch.parallel import device_mesh
    from srt_tpu_torch.parallel.launch import spawn_world
    from srt_tpu_torch.scene import model_scene_lights

    t_phase = time.perf_counter()
    card = cases.card
    device = None if dev.type == "cuda" else dev
    mesh1 = device_mesh(1, 1, device=device)
    print(f"[14] world of 1: backend {dist.get_backend()}, mesh "
          f"{mesh1.mesh.tolist()}", flush=True)
    try:
        # (a) config5 and config7, one shard: Mpaths/s as bench_suite.py
        # counts them, and the image against the unsharded trace.
        c5 = config5_case(dev, CONFIG5_SIZE)
        c7 = config7_case(dev, CONFIG7_SIZE)
        key0 = rng.key(0, dev)
        for label, case in (("config5", c5), ("config7", c7)):
            make_hit, sc, lights, cam, cfg = case
            tr.reset_launch_counts()
            img = render_sharded_of(case, key0, mesh1)
            torch.cuda.synchronize()
            found = path_launches(label, SPHERE_PATH, tr.launch_counts)
            check_image(label, img, cam.width)
            ref = unsharded_image(make_hit, sc, lights, cam, cfg, key0)
            check(torch.equal(img, ref), f"{label}: the one-shard image "
                                         f"differs from the unsharded trace")
            s, _ = host_median(lambda: render_sharded_of(case, key0, mesh1))
            paths = cam.width * cam.height * cfg.spp
            print(f"[14a] {label} {cam.width}x{cam.height}, spp {cfg.spp}, "
                  f"{cfg.max_depth}+{cfg.rr_bounces} bounces, 1 shard: "
                  f"{paths / s / 1e6:.4f} Mpaths/s ({s * 1e3:.3f} ms, median "
                  f"of {GRAD_REPS} after a warm call); equal to the unsharded "
                  f"trace bit for bit; launches {found}  [{card}]",
                  flush=True)
            print(f"[14a] {label} 2, 4, 8 shards: not measured (one card)",
                  flush=True)

        # (b) The sharded walk frame: every launch replayed, then timed.
        lights = model_scene_lights(dev)
        key = rng.key(14, dev)
        out = []
        launched = replay_frame("14b", lambda: out.append(sharded_walk(
            scene, lights, mesh1, SHARD_WALK_SIZE, key)), cases)
        check(launched == set(SCAN_MESH_PATH),
              f"the sharded walk frame launched {sorted(launched)}")
        tr.reset_launch_counts()
        s, img = host_median(lambda: sharded_walk(scene, lights, mesh1,
                                                  SHARD_WALK_SIZE, key))
        per_frame = {k: v // (GRAD_REPS + 1)
                     for k, v in tr.launch_counts.items() if v}
        check(torch.equal(img, out[0]), "the sharded walk frame is not "
                                        "deterministic")
        check_image("sharded walk frame", img, SHARD_WALK_SIZE)
        print(f"[14b] sharded walk frame {SHARD_WALK_SIZE}x{SHARD_WALK_SIZE}"
              f", 2 bounces, 1 shard: {s * 1e3:.3f} ms (median of "
              f"{GRAD_REPS} after a warm call), launches a frame "
              f"{per_frame}  [{card}]", flush=True)
        if profile:
            profile_frame(lambda: sharded_walk(scene, lights, mesh1,
                                               SHARD_WALK_SIZE, key),
                          "sharded walk frame (world of 1)", s, profile)

        # (c) A gloo world of 2 on the one card against the world of 1.
        ref_walk = sharded_walk(scene, lights, mesh1, WORLD2_WALK_SIZE,
                                key).cpu()
        ref7 = render_sharded_of(c7, rng.key(7, dev), mesh1).cpu()
        ref_g = config7_grads(c7, mesh1, rng.key(3, dev))
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            ranks = spawn_world(
                sharded_rank, 2, (device, HEADLINE_SPHERE, WORLD2_WALK_SIZE,
                                  CONFIG7_SIZE),
                workdir=tmp, backend="gloo", device=device,
                timeout=WORLD2_TIMEOUT)
        world_s = time.perf_counter() - t0
        for r, res in enumerate(ranks):
            path_launches(f"world of 2, rank {r}", SCAN_MESH_PATH,
                          res["launches"])
            for label, got, want in (
                    ("walk frame", res["walk"], ref_walk),
                    ("config7", res["config7"], ref7)):
                check(bool(torch.allclose(got, want, rtol=1e-5, atol=1e-6)),
                      f"world of 2, rank {r}: the {label} is beyond rtol "
                      f"1e-5 / atol 1e-6 of the world of 1")
                print(f"[14c] rank {r} {label}: "
                      f"{int((got != want).any(-1).sum())} of "
                      f"{got.shape[0] * got.shape[1]} pixels not equal bit "
                      f"for bit to the world of 1 (max |err| "
                      f"{float((got - want).abs().max()):.3e})", flush=True)
            check(np.array_equal(res["multihost"], res["walk"].numpy()),
                  f"world of 2, rank {r}: render_multihost differs from "
                  f"the gathered walk frame")
            loss, g_d, g_p = res["grads"]
            check(abs(loss - ref_g[0]) <= 1e-5 * abs(ref_g[0]),
                  f"world of 2, rank {r}: config7 loss {loss} vs {ref_g[0]}")
            for name, got, want in (("mat_diffuse", g_d, ref_g[1]),
                                    ("positions", g_p, ref_g[2])):
                check(bool(torch.allclose(got, want.cpu(), rtol=5e-4,
                                          atol=1e-6)),
                      f"world of 2, rank {r}: d / d {name} beyond rtol 5e-4 "
                      f"/ atol 1e-6 of the world of 1")
            print(f"[14c] rank {r}: launches {res['launches']}; "
                  f"render_multihost equals the gathered frame; config7 "
                  f"gradients within rtol 5e-4 / atol 1e-6 (max |err| "
                  f"{float((g_d - ref_g[1].cpu()).abs().max()):.3e}, "
                  f"{float((g_p - ref_g[2].cpu()).abs().max()):.3e}); "
                  f"all-gather of {res['gather'][1]} floats "
                  f"{res['gather'][0]:.3f} ms, all-reduce of "
                  f"{res['reduce'][1]} floats {res['reduce'][0]:.3f} ms "
                  f"(gloo through host memory)  [{card}]", flush=True)
        print(f"[14c] world of 2 (gloo, both ranks on one card): "
              f"{world_s:.1f} s, spawn to join", flush=True)

        # (d) The BVH route: ids against the dense sweep's.
        n_side = BVH_SIZE
        cam = CameraConfig(width=n_side, height=n_side, **HEADLINE_CAMERA)
        o, d = generate_rays(derive_viewport(cam, device=dev), n_side, n_side,
                             torch.full((2, n_side * n_side), 0.5,
                                        device=dev))
        o, d = o.T.contiguous(), d.T.contiguous()
        ids, times = {}, {}
        for method in ("bvh", "dense", "walk"):
            synchronize()
            t0 = time.perf_counter()
            ids[method], _ = wavefront.hit_ids(scene, o, d, method=method)
            synchronize()
            times[method] = (time.perf_counter() - t0) * 1e3
        check(torch.equal(ids["bvh"], ids["dense"]),
              f"BVH ids differ from dense ids on "
              f"{int((ids['bvh'] != ids['dense']).sum())} rays")
        try:
            wavefront.hit_ids(mesh_mod.refit_accel(scene), o[:64], d[:64],
                              method="bvh")
            refused = False
        except ValueError:
            refused = True
        check(refused, "a refit_accel-ed scene did not refuse the BVH route")
        print(f"[14d] hit_ids on {o.shape[0]} headline primaries: bvh "
              f"{times['bvh']:.3f} ms, dense {times['dense']:.3f} ms, walk "
              f"{times['walk']:.3f} ms; bvh ids equal dense ids "
              f"({int((ids['bvh'] >= 0).sum())} hits), walk ids equal on "
              f"{int((ids['walk'] == ids['dense']).sum())}; the refit scene "
              f"refuses bvh  [{card}]", flush=True)
    finally:
        dist.destroy_process_group()
    print(f"[14] sharded phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)


# The kernels each ``bench_suite`` config launches on the card (phase 15),
# and the configs whose ``vs_baseline`` is a correctness flag.  config1
# injects its uniforms (no kernel); configs 3 and 11 render one-super
# scenes (no B1; config10's Rubik half too, its headline half launches B1).
SUITE_PATHS = {"1": (), "2": SPHERE_PATH, "3": ONE_SUPER_PATH,
               "4": HEADLINE_PATH, "5": SPHERE_PATH, "6": SCAN_MESH_PATH,
               "7": SPHERE_PATH, "8": CONFIG8_PATH, "9": SCAN_MESH_PATH,
               "10": SCAN_MESH_PATH, "11": ONE_SUPER_PATH}
SUITE_FLAGGED = ("1", "6", "8", "10")


def kernel_launches():
    """The nonzero kernel launch counts since the last reset."""
    from srt_tpu_torch.ops import traversal as tr
    return {k: v for k, v in tr.launch_counts.items() if v and k in KERNELS}


def phase_entry_points(plan, cases, dev):
    """Phase 15: ``bench``, ``bench_suite`` and the tools of the port,
    in this process, at the card's full sizes; ``plan`` is phase 4's."""
    import io
    import math
    import tempfile

    import numpy as np
    import torch

    from srt_tpu_torch import bench, bench_suite
    from srt_tpu_torch.ops import rng
    from srt_tpu_torch.ops import traversal as tr
    from srt_tpu_torch.tools import interactive_session, render_demo

    t_phase = time.perf_counter()
    card = cases.card
    check(not os.environ.get("SRT_SUITE_SMALL"),
          "SRT_SUITE_SMALL is set: phase 15 runs the card's full sizes")

    # (a) bench: its line, and its plan's frame against phase 4's.
    t0 = time.perf_counter()
    tr.reset_launch_counts()
    record, bench_plan, rays = bench.run(dev)
    found = path_launches("bench", HEADLINE_PATH, kernel_launches())
    secs = time.perf_counter() - t0
    print(f"[15a] {json.dumps(record)}", flush=True)
    check(math.isfinite(record["value"]) and record["value"] > 0,
          f"bench: rate {record['value']}")
    key1 = rng.key(1, dev)
    mine, ref = bench_plan.render(key1), plan.render(key1)
    check(all(torch.equal(a, b) for a, b in zip(mine, ref)),
          "bench: its plan's frame for key 1 differs from phase 4's")
    print(f"[15a] bench: {secs:.1f} s, schedule {bench_plan.schedule}, "
          f"{rays} rays a frame, overflow 0; its frame for key 1 equals "
          f"phase 4's plan frame bit for bit; launches in 11 frames "
          f"{found}  [{card}]", flush=True)
    del bench_plan, mine, ref

    # (b) bench_suite: each config through main(), its lines and kernels.
    for p in sorted(bench_suite.ALL, key=int):
        buf = io.StringIO()
        t0 = time.perf_counter()
        tr.reset_launch_counts()
        with contextlib.redirect_stdout(buf):
            rc = bench_suite.main([p, "--device", str(dev)])
        synchronize()
        secs = time.perf_counter() - t0
        launches = kernel_launches()
        lines = [json.loads(ln) for ln in buf.getvalue().splitlines()
                 if ln.startswith("{")]
        for rec in lines:
            print(f"[15b] {json.dumps(rec)}", flush=True)
        check(rc == 0 and lines
              and not any("FAILED" in r["metric"] for r in lines),
              f"config{p}: exit {rc}, lines {lines}")
        check(all(math.isfinite(r["value"]) for r in lines),
              f"config{p}: a value is not finite")
        if p in SUITE_FLAGGED:
            check(all(r["vs_baseline"] == 1.0 for r in lines),
                  f"config{p}: a correctness flag is not 1.0")
        check(set(launches) == set(SUITE_PATHS[p]),
              f"config{p} launched {sorted(launches)}, its path is "
              f"{sorted(SUITE_PATHS[p])}")
        print(f"[15b] config{p}: {len(lines)} lines in {secs:.1f} s, "
              f"launches {launches}  [{card}]", flush=True)

    # (c) the tools.
    t0 = time.perf_counter()
    tr.reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        images = render_demo.run(tmp, DEMO_SIZE, DEMO_SPP, dev)
        for name, (path, srgb) in images.items():
            check(os.path.getsize(path) > 0, f"render_demo: {path} empty")
            check(srgb.shape == (DEMO_SIZE, DEMO_SIZE, 3)
                  and bool(np.isfinite(srgb).all()) and srgb.std() > 0.0,
                  f"render_demo: {name} is not a finite, varied image")
            print(f"[15c] render_demo {name}: {os.path.basename(path)}, "
                  f"sRGB mean {srgb.mean():.6f}, std {srgb.std():.6f}",
                  flush=True)
    found = path_launches("render_demo", SCAN_MESH_PATH, kernel_launches())
    print(f"[15c] render_demo {DEMO_SIZE}x{DEMO_SIZE}, spp {DEMO_SPP}: "
          f"{time.perf_counter() - t0:.1f} s, launches {found}  [{card}]",
          flush=True)
    t0 = time.perf_counter()
    tr.reset_launch_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        records = interactive_session.run(dev, SESSION_SIZES,
                                          SESSION_CASE_FRAMES)
    found = path_launches("interactive_session", HEADLINE_PATH,
                          kernel_launches())
    for rec in records:
        print(f"[15c] {json.dumps(rec)}", flush=True)
        check(all(math.isfinite(rec[k]) and rec[k] > 0
                  for k in ("fps", "fps_after_move")),
              f"interactive_session {rec['case']}: fps")
    print(f"[15c] interactive_session: {len(records)} cases in "
          f"{time.perf_counter() - t0:.1f} s, launches {found}  [{card}]",
          flush=True)
    print(f"[15] entry-point phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def tool_run(tag, name, fn, card):
    """Run one tool's ``run()`` with the launch counts set to 0 just
    before it; print its printout, each line prefixed with ``[tag]``, and
    its seconds; check the kernels its path must launch.  Returns (its
    records, the nonzero launch counts)."""
    import io

    from srt_tpu_torch.ops import traversal as tr
    buf = io.StringIO()
    t0 = time.perf_counter()
    tr.reset_launch_counts()
    with contextlib.redirect_stdout(buf):
        records = fn()
    synchronize()
    secs = time.perf_counter() - t0
    launches = kernel_launches()
    for ln in buf.getvalue().splitlines():
        print(f"[{tag}] {ln}", flush=True)
    found = path_launches(name, TOOL_PATHS.get(name, ()), launches)
    check(bool(records), f"{name}: no records")
    print(f"[{tag}] {name}: {len(records)} records in {secs:.1f} s, "
          f"launches {found}  [{card}]", flush=True)
    return records, found


def finite_times(name, records, keys):
    """Every ``keys`` value of every record that has one is finite and
    positive."""
    import math
    for rec in records:
        for k in keys:
            if rec.get(k) is not None:
                check(math.isfinite(rec[k]) and rec[k] > 0,
                      f"{name}: {k} = {rec[k]} in {rec}")


def phase_micro_occ(cases, dev):
    """Phase 16a: K1 and K2 against their plain versions at micro_occ's
    shapes and the others of its docstring entry, torch's x + 1.0 as K1's
    library yardstick."""
    import torch

    from srt_tpu_torch.tools import micro_occ

    card = cases.card
    gen = torch.Generator().manual_seed(16)
    x = torch.randn((8, 128), generator=gen).to(dev)
    cases.run("16a", "add_one", "[8, 128] f32", x)
    lib_ms, n, queued = device_median(lambda: x + 1.0)
    cases.results["add_one"]["library_ms"] = lib_ms
    print(f"[16a] add_one library: torch x + 1.0 on [8, 128] {lib_ms:.5f} ms "
          f"({device_note(n, queued)})  [{card}]", flush=True)
    # A last block part filled (1028 = 257 float4), then the scalar path.
    flat = torch.randn(4097, generator=gen).to(dev)
    for case, view in (("1028 f32 (257 float4)", flat[:1028]),
                       ("4095 f32 (odd length)", flat[1:4096]),
                       ("4096 f32 at a 4-byte offset", flat[1:])):
        cases.run("16a", "add_one", case, view)
    big = torch.randn(ADD_ONE_LARGE, device=dev,
                      generator=torch.Generator(dev).manual_seed(16))
    shape = f"[{ADD_ONE_LARGE[0]}, {ADD_ONE_LARGE[1]}]"
    cases.run("16a", "add_one", f"{shape} f32", big)
    lib_ms, n, queued = device_median(lambda: big + 1.0)
    print(f"[16a] add_one library: torch x + 1.0 on {shape} {lib_ms:.5f} ms "
          f"({device_note(n, queued)})  [{card}]", flush=True)
    del big

    own = micro_occ.own_data(OCC_N, OCC_BOXES, 0)[1:]
    mixed = micro_occ.mixed_data(OCC_N, OCC_BOXES, OCC_TILE, 1)
    for data, arrays in (("own", own), ("mixed", mixed)):
        rays_cf, bounds = (torch.as_tensor(a, device=dev) for a in arrays)
        for g in OCC_GROUPS:
            occ_case(cases, f"{OCC_N} rays, {OCC_BOXES} boxes, tile "
                     f"{OCC_TILE}, g={g}, {data} data", rays_cf, bounds,
                     OCC_TILE, g, data == "mixed")
    extra = [(tile, n, OCC_BOXES) for tile, n in OCC_TILE_CASES]
    extra += [(OCC_TILE, OCC_N, c) for c in OCC_BOX_CASES]
    for tile, n, c in extra:
        rays_cf, bounds = (torch.as_tensor(a, device=dev)
                           for a in micro_occ.mixed_data(n, c, tile, 1))
        occ_case(cases, f"{n} rays, {c} boxes, tile {tile}, mixed data",
                 rays_cf, bounds, tile, 1, True)
    # Rows at a 4-byte offset: the scalar loads at a tile of 512.
    rays_cf, bounds = (torch.as_tensor(a, device=dev) for a in mixed)
    store = torch.empty(8 * OCC_N + 1, device=dev)
    shifted = store[1:].view(8, OCC_N)
    shifted.copy_(rays_cf)
    occ_case(cases, f"{OCC_N} rays, {OCC_BOXES} boxes, tile {OCC_TILE}, "
             f"rows at a 4-byte offset", shifted, bounds, OCC_TILE, 1, True)


def occ_case(cases, case, rays_cf, bounds, tile, g, mixed):
    """One K2 case against its plain version, with its share of ones
    (in [0.2, 0.8] on mixed data)."""
    occ = cases.run("16a", "occupancy_cf", case, rays_cf, bounds, tile, g)
    ones = float(occ.float().mean())
    print(f"[16a] occupancy_cf {case}: share of ones {ones:.6f}", flush=True)
    if mixed:
        check(0.2 <= ones <= 0.8, f"occupancy_cf {case}: mixed data gave "
                                  f"{ones} ones")


def phase_tools(scene, scene8, cases, dev):
    """Phase 16: K1 and K2 against their plain versions, micro_occ's path,
    then every other measurement tool's ``run()`` at the card's sizes on
    the headline (phase 3) and config8 (phase 6) scenes."""
    import tempfile

    from srt_tpu_torch.tools import (eval_counts, micro_bounce_real,
                                     micro_occ, micro_pg2_split,
                                     micro_pgwalk, parity_smoke, parse_trace,
                                     profile_bench, profile_bounces,
                                     profile_breakdown, profile_fastpath,
                                     profile_frame, profile_scan,
                                     profile_trace, wavefronts)

    t_phase = time.perf_counter()
    card = cases.card

    # (a) K1 and K2 against their plain versions.
    phase_micro_occ(cases, dev)

    # (b) micro_occ's own run (the path of K1 and K2), and the host line
    # from its records.
    records, found = tool_run("16b", "micro_occ", lambda: micro_occ.run(
        dev, OCC_N, OCC_BOXES, OCC_TILE, OCC_GROUPS, reps=TOOLS_REPS,
        launch_reps=HOST_REPS), card)
    finite_times("micro_occ", records, ("ms", "device_ms", "us_a_launch"))
    us = {r["variant"]: r["us_a_launch"] for r in records
          if "us_a_launch" in r}
    print(f"[16b] host: K1 add_one [8, 128] {us['v0']:.3f} µs a launch, "
          f"torch x + 1.0 {us['v0c']:.3f} µs ({us['v0'] / us['v0c']:.3f}x); "
          f"B1 cull ({OCC_N} rays, {OCC_BOXES} boxes, tile {OCC_TILE}) "
          f"{us['v1']:.3f} µs a call; {HOST_REPS} calls back to back "
          f"each  [{card}]", flush=True)
    for k in ("add_one", "occupancy_cf"):
        cases.results[k].setdefault("launches", found.get(k, 0))

    # (c) every other tool at the card's sizes.
    size, rsize, reps = TOOLS_SIZE, TOOLS_RUBIK_SIZE, TOOLS_REPS
    time_keys = ("ms", "cull_ms", "walk_ms", "tiled_ms", "frame_ms",
                 "ms_min", "seconds", "device_ms", "cull_device_ms",
                 "walk_device_ms", "b2_ms")
    with tempfile.TemporaryDirectory() as tmp:
        runs = {
            "wavefronts": lambda: wavefronts.run(dev, scene, size=size),
            "eval_counts": lambda: eval_counts.run(dev, scene, size=size,
                                                   reps=reps),
            "profile_bounces": lambda: profile_bounces.run(
                dev, scene, size=size, reps=reps),
            "profile_breakdown": lambda: profile_breakdown.run(
                dev, size=rsize, reps=reps),
            "profile_bench": lambda: profile_bench.run(dev, size=rsize,
                                                       reps=reps),
            "profile_frame": lambda: profile_frame.run(dev, size=rsize,
                                                       reps=reps),
            "profile_scan": lambda: profile_scan.run(dev, size=rsize,
                                                     reps=reps),
            "profile_fastpath": lambda: profile_fastpath.run(
                dev, scene, size=size, reps=reps,
                trace_dir=os.path.join(tmp, "fastpath"), top=15),
            "profile_trace": lambda: profile_trace.run(
                dev, size=rsize, trace_dir=os.path.join(tmp, "rubik"),
                top=15),
            "parity_smoke": lambda: parity_smoke.run(
                dev, scene, scene8, sizes=PARITY_SIZES,
                out=os.path.join(tmp, "parity.json")),
            "micro_bounce_real": lambda: micro_bounce_real.run(
                dev, scene, size=size, reps=reps),
            "micro_pg2_split": lambda: micro_pg2_split.run(
                dev, scene, size=size, reps=reps),
            "micro_pgwalk": lambda: micro_pgwalk.run(dev, scene, size=size,
                                                     reps=reps),
        }
        results = {}
        for name, fn in runs.items():
            results[name] = tool_run("16c", name, fn, card)[0]
            finite_times(name, results[name], time_keys)
        fit = [r for r in results["eval_counts"] if r["bounce"] == "fit"]
        check(len(fit) == 1, "eval_counts: no fit")
        failed = [c["case"] for c in results["parity_smoke"] if not c["pass"]]
        check(not failed, f"parity_smoke: cases failed {failed}")
        check(all((r["device_ms"] or 0) > 0 and r["events"] > 0
                  for k in ("profile_fastpath", "profile_trace")
                  for r in results[k]), "a profiled frame shows no device "
                                        "operations")
        rec = results["profile_fastpath"][0]
        summary = parse_trace.run(rec["trace"], top=5, verbose=False)
        total = rec["device_ms"] or 0.0
        check(abs(summary["total_ms"] - total) <= 1e-9 * max(1.0, total),
              "parse_trace disagrees with profile_fastpath's sum")
        print(f"[16c] parse_trace of the fastpath trace: "
              f"{summary['total_ms']:.3f} ms across {summary['events']} "
              f"device events  [{card}]", flush=True)
        # (d) The last seven tools at JAX's sizes.
        phase_tools_more(scene, cases, dev, tmp)
    print(f"[16] tools phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def no_kernel(name, found):
    """A tool that launches no kernel launched none."""
    launched = sorted(k for k in found if k in KERNELS)
    check(not launched, f"{name}: launched {launched}")


def phase_tools_more(scene, cases, dev, tmp):
    """Phase 16d: micro_gather, micro_soa, micro_layout, micro_binned
    (with its B5 and pair-tile B2 launches replayed through their plain
    versions), micro_footprint on the headline's wavefronts,
    micro_sortkeys on a micro_pg2_split dump and multihost_2proc's world
    of 2, each at JAX's sizes; ``tmp`` a directory for the dump and the
    world."""
    from srt_tpu_torch.tools import (micro_binned, micro_footprint,
                                     micro_gather, micro_layout,
                                     micro_pg2_split, micro_soa,
                                     micro_sortkeys, multihost_2proc,
                                     wavefronts)

    t_part = time.perf_counter()
    card, reps = cases.card, TOOLS_REPS
    time_keys = ("ms", "device_ms", "tiled_ms", "binned_ms",
                 "tiled_device_ms", "binned_device_ms", "kernel_ms",
                 "single_process_frame_s", "multi_process_tile_s")
    for name, tool in (("micro_gather", micro_gather),
                       ("micro_soa", micro_soa),
                       ("micro_layout", micro_layout)):
        recs, found = tool_run("16d", name, lambda t=tool: t.run(
            dev, n=TOOLS_N, reps=reps), card)
        no_kernel(name, found)
        finite_times(name, recs, time_keys + ("launches",))
        check(all(r["device_ms"] is not None
                  and r.get("device_queued", True) for r in recs),
              f"{name}: a case has no device time, or a host-bound one")

    # micro_binned: the binned walk's branch follows the pair total, as
    # JAX's lax.cond; B5 and B2 on the pair tiles equal their plain
    # versions on the tool's sorted rays.
    recs, found = tool_run("16d", "micro_binned", lambda: micro_binned.run(
        dev, scene, n=BINNED_RAYS, reps=reps), card)
    finite_times("micro_binned", recs, time_keys + ("tiled_launches",
                                                    "binned_launches"))
    pairs = next(r for r in recs if r["case"] == "pairs")
    sorted_hit = next(r for r in recs if r.get("order") == "sorted")
    want = "tiled fallback" if pairs["overflow"] else "pairs"
    check(sorted_hit["branch"] == want,
          f"micro_binned: the sorted binned walk took {sorted_hit['branch']}"
          f", its pair total {pairs['total']} against {pairs['capacity']}")
    check(all(r["kernel_ms"] for r in recs if r.get("kernel")),
          "micro_binned: a kernel stage has no device time")
    _, _, o_s, d_s = micro_binned.random_rays(BINNED_RAYS, dev)
    rays8, sbounds = micro_binned.front(scene, o_s, d_s)
    with recorded_launches() as calls:
        micro_binned.pipeline(scene, rays8, sbounds)
    synchronize()
    check([c[0] for c in calls] == ["cull_perray", "intersect"],
          f"micro_binned's stages launched {[c[0] for c in calls]}")
    for name, args, k_out in calls:
        rays = args["rays8"].shape[0]
        case = (f"micro_binned {BINNED_RAYS} sorted rays: "
                + (f"{rays // 8} groups, S={args['sbounds'].shape[1]}"
                   if name == "cull_perray" else
                   f"{rays // 8} pair slots, {rays // args['tile']} tiles"))
        fn = getattr(kernel_module(name), name)
        t0 = time.perf_counter()
        p_out = fn(**{**args, "plain": True})
        synchronize()
        p_ms = (time.perf_counter() - t0) * 1e3
        err = compare(name, case, k_out, p_out)
        cases.replayed(name, case, p_ms, err)
        print(f"[16d] {name:16s} {case}: equals plain (plain {p_ms:.1f} ms, "
              f"max_abs_err {err})  [{card}]", flush=True)

    # micro_footprint on the headline's wavefronts, captured once here.
    waves = wavefronts.headline(scene, TOOLS_SIZE)
    recs, found = tool_run("16d", "micro_footprint", lambda: (
        micro_footprint.run(dev, scene, size=TOOLS_SIZE, waves=waves)), card)
    no_kernel("micro_footprint", found)
    check(len(recs) >= 2 and all(r["mean"] > 0 for r in recs),
          "micro_footprint: fewer than two bounces with footprints")
    del waves

    # micro_sortkeys on a micro_pg2_split dump of the same frame.
    dump = os.path.join(tmp, "rays.npz")
    t0 = time.perf_counter()
    micro_pg2_split.run(dev, scene, size=TOOLS_SIZE, dump=dump,
                        dump_only=True, verbose=False)
    print(f"[16d] micro_pg2_split dump: {os.path.getsize(dump)} bytes in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for bounce in SORTKEY_BOUNCES:
        recs, found = tool_run("16d", "micro_sortkeys", lambda b=bounce: (
            micro_sortkeys.run(dev, scene, dump=dump, bounce=b)), card)
        no_kernel("micro_sortkeys", found)
        check(recs[0]["live"] > 0 and sum(r["case"] == "key"
                                           for r in recs) >= 8,
              f"micro_sortkeys bounce index {bounce}: no live rays or keys")
    os.remove(dump)

    # multihost_2proc: a gloo world of 2 on the card against one process.
    recs, found = tool_run("16d", "multihost_2proc", lambda: (
        multihost_2proc.run(dev, MULTIHOST_METHOD,
                            workdir=os.path.join(tmp, "world"),
                            timeout=WORLD2_TIMEOUT)), card)
    rep = recs[0]
    finite_times("multihost_2proc", [rep], time_keys)
    check(rep["bit_equal_to_single_process"] or rep["max_abs_diff"] < 1e-6,
          f"multihost_2proc: the world of 2 differs by {rep['max_abs_diff']}")
    for r in rep["per_process"]:
        path_launches(f"multihost_2proc rank {r['proc']}",
                      TOOL_PATHS["multihost_2proc"], r["launches"])
    print(f"[16d] multihost_2proc {MULTIHOST_METHOD}: bit equal "
          f"{rep['bit_equal_to_single_process']}, max |diff| "
          f"{rep['max_abs_diff']}, efficiency {rep['scaling_efficiency']:.4f}"
          f", rank launches {[r['launches'] for r in rep['per_process']]}  "
          f"[{card}]", flush=True)
    print(f"[16d] the last seven tools: {time.perf_counter() - t_part:.1f} s",
          flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="PATH")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's GPU path cannot run",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "srt_tpu_torch", "csrc")):
        print("chip_smoke: srt_tpu_torch/ not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    # Plain float32 matmuls on the card (the references use no TF32).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from srt_tpu_torch.ops import cuda_lib

    t_start = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"[1] device: {name}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; count {torch.cuda.device_count()}",
          flush=True)
    print(card, flush=True)

    t0 = time.perf_counter()
    lib = cuda_lib.load()
    ptxas = ptxas_lines(lib.log)
    print(f"[2] build: {lib.build_seconds:.3f} s nvcc ({lib.path.name}), "
          f"load {time.perf_counter() - t0:.3f} s", flush=True)
    for ln in ptxas:
        print(f"[2] {ln.strip()}", flush=True)
    sass = sass_of(lib.path)
    for label, count, want in (
            ("threefry", threefry_sass_ops, (THREEFRY_ALU_OPS,
                                             THREEFRY_FMA_OPS)),
            ("occupancy_cf", occupancy_sass_ops, (OCC_ALU_OPS,
                                                  OCC_FMA_OPS))):
        got = count(sass) if sass else None
        check(got in (None, want), f"{label}'s SASS has {got} (ALU, FMA) "
                                   f"instructions where its bound counts "
                                   f"{want}")
        print(f"[2] {label}: {want} (ALU-pipe, FMA-pipe) instructions "
              f"counted by its bound, "
              f"{'checked in the SASS' if sass else 'not checked (no cuobjdump)'}",
              flush=True)

    dev = torch.device("cuda", 0)
    cases = Cases(card)
    if args.profile and os.path.exists(args.profile):
        os.remove(args.profile)
    scene, secs = build_scene(dev, *HEADLINE_SPHERE)
    print(f"[3] headline scene: {scene.woop.shape[0]} clusters, "
          f"{scene.num_triangles} triangles, built in {secs:.3f} s",
          flush=True)
    phase_kernels(scene, cases)
    plan = phase_render(scene, cases, args.profile)
    phase_parity(scene, plan, card)

    scene8, secs = build_scene(dev, *CONFIG8_SPHERE)
    print(f"[6] config8 scene: {scene8.woop.shape[0]} clusters, "
          f"{scene8.model_tri_count[0]} triangles, built in {secs:.3f} s",
          flush=True)
    phase_config8(scene8, scene, cases, args.profile)
    phase_counters({"headline": (scene, HEADLINE_SIZE),
                    "config8": (scene8, CONFIG8_SIZE)}, cases)
    phase_binned(scene, cases, args.profile)
    phase_scan(scene, cases, args.profile, dev)
    phase_grad(scene, cases, args.profile, dev)
    phase_textures_nee(scene, cases, args.profile, dev)
    phase_app(scene, cases, args.profile, dev)
    phase_edge_aware(scene, cases, args.profile, dev)
    phase_sharded(scene, cases, args.profile, dev)
    phase_entry_points(plan, cases, dev)
    phase_tools(scene, scene8, cases, dev)

    # Each kernel's first case, or its LINE_CASES case: device ms, plain ms
    # and bound of one call.  No single PyTorch call computes a cull, a
    # walk, the threefry lattice or K2's occupancy, so library_ms is null
    # for those; K1's is torch's x + 1.0.
    kernels = []
    for k, (_, src, replaces) in KERNELS.items():
        rec = cases.results[k]
        want = LINE_CASES.get(k, rec["cases"][0]["case"])
        first = next((c for c in rec["cases"] if c["case"] == want), None)
        check(first is not None, f"{k}: no case {want!r} for the kernels line")
        kernels.append(dict(
            name=k, route="cuda", source=src, replaces=replaces,
            launches=rec["launches"],
            max_abs_err=max(c["max_abs_err"] for c in rec["cases"]),
            ms=first["ms"], plain_ms=first["plain_ms"],
            bound_ms=first["bound_ms"], bound_by=first["bound_by"],
            library_ms=rec.get("library_ms")))
    print(f"[17] all phases passed in {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
