#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's hand-written CUDA kernels from ``coarsegrainingvae_tpu_torch/
csrc`` with nvcc (one nvcc per source, started together), holds each kernel,
forward and backward, against its plain PyTorch version on the card at the
shapes the served and the trained model give it, then drives the port's two
main paths at the full ``bench.py::dipeptide_config`` width (n_basis 600,
enc 4 / dec 5, pseudo decoder, bf16 matmuls) from seeded random weights:

- serve: dipeptide backmapping through ``Backmapper.backmap``;
- train: ``Trainer.train_step`` at batch 128 over a ``DeviceDataset`` on the
  card (bench.py's recipe: Adam with bf16 moments, lr 3.2e-4, beta 0.05,
  gamma 25, clip 0.01), 100 steps then 100 timed steps, a profiled window,
  one f32 step held against the same step on the CPU, and a 2-epoch
  ``Trainer.fit``;
- captured: the epoch as one program (``Trainer.run_epoch_scan``): an
  eager and a captured epoch from the same state held bit for bit, then
  ms/step, device busy and launches of the eager epoch against the
  replayed one over 100 steps at batch 128 and 32;
- cgae: ``learn_map``'s 1,500 steps on the card against the CPU from the
  same numpy draws, then ``get_mapping("cgae")`` on the card, timed;
- cv: the k-fold workflow, ``cli.run_cgvae.main`` (the README quickstart's
  recipe, cgae mapping and pseudo decoder, at batch 128 on 640 synthetic
  frames, 2 of 5 folds, 2 epochs, 16 x 16 samples, graph metrics), checked
  artifact by artifact; then ``Backmapper.from_run`` of fold 0 against the
  model the fold trained, a resumed fold 0 (``--resume`` to 3 epochs, the
  restored state held bit for bit to the saved one) and one epoch of the
  default cross decoder;
- runfiles: the JAX package's run files on the cv run's fold 0: its
  checkpoint through ``convert.train_state_to_flax``, the flax msgpack
  codec's bytes and back (every tensor and the re-written bytes bit for
  bit), ``Backmapper.from_run`` of a copy holding that state against the
  original fold (one request, bit for bit), and one epoch of
  ``Trainer.fit(resume=True)`` from each (the parameters after, bit for
  bit);
- steric: the committed ``examples/results/steric_ab`` recipes. The
  ``dip_full_c6_hprojecteval`` step (zeta 100, h_project_eval, zeta_warmup
  cut to 50): one f32 step card vs CPU mid-ramp, an eager and a captured
  epoch bit for bit across the ramp's end, ms/step captured at batch 128
  and 32 beside the captured phase's zeta-0 step; then ``run_cgvae`` with
  the ``dip_full_z100`` flags plus ``--h_project_eval`` and the
  ``chig_full_z200w`` recipe (chignolin, 209 atoms, 6 beads, cross decoder
  dec 9, n_rbf 10, batch 16), one fold each cut in depth, read back by
  ``from_run``;
- sparse: the sparse ``CGequiVAE`` at the same width, pseudo then pseudo2
  decoder: one f32 step card vs CPU, an eager and a captured epoch bit for
  bit, ms/step, device busy and peak memory captured at batch 128 and 32
  beside the dense model's, no kernel launched; then ``run_cgvae --sparse``
  cut in depth and ``from_run(sparse=True)``;
- native: the host C++ (``native/``) built with g++ on this machine, the
  cell list against the dense radius graph at N 300 and on the covid
  stand-in's frames (10,333 atoms, synthesised here and cached), the bond
  diff against the dense metrics at 2,000 atoms and at the covid N, with
  each route's host seconds;
- pcn: ``cli.run_pcn`` with the committed p7 and p7s recipes
  (``examples/results/pcn_demo``: n_basis 256, dec 4, cross, batch 8,
  zeta 20, bond_project, well-posed 50-80-residue proteins), cut to 80
  proteins x 2 epochs, every artifact checked (``params.msgpack`` read
  back into a fresh model on the card); the p7 step card vs CPU
  (f32 on the loss's smooth terms, float64 on the whole recipe), two
  steps from one state bit for bit, ms/step, device busy and peak memory;
- covid: ``cli.run_cgvae`` with the committed covid recipe
  (``examples/results/_r5_live/covid2``: sparse, degree_norm, 500
  seqpartition beads, n_basis 192, cross, batch 2), one fold of one epoch
  on 7 frames with the graph metrics, checked to have taken the cell list
  and the bond diff, its wall time by part; then its step eager and
  captured with peak memory;
- diffpool: ``cli.run_diffpool`` with the committed v6 recipe
  (``examples/results/diffpool_demo``: n_cgs 8, F 512, enc 2 / dec 3,
  cross, batch 32, graph_grad and zeta on 5,000-step ramps, h_project,
  sample_hard) at full width, cut to 320 frames x 2 epochs x 2 folds
  after 2 pretraining epochs, every file checked; the step card vs CPU at
  f32 mid-ramp (with the CPU's float64 step beside it), two steps from
  one state bit for bit, ms/step, device busy, host launch calls and peak
  memory;
- baseline: ``cli.run_baseline`` with the committed
  ``examples/results/baseline_demo`` recipe (equimlp), cut to 400 frames
  x 3 epochs; one step of each of the seven zoo entries card vs CPU; the
  recipe's step timed;
- hpo: ``cli.hpo`` with the committed ``examples/results/hpo_demo`` recipe
  (ASHA, 6 trials, 8 epochs, 2 folds per trial run) on the card; it
  raises if a trial failed, and holds the message kernels' launches to the
  count worked out from the trials' configs; then the recipe cut to 2
  trials x 2 epochs on one process and on two gloo ranks sharing the card
  (each trial data-parallel), the same trial directories and rows, each
  value within 1e-3;
- multigpu: data-parallel training and the halo stack (``parallel/``) on
  the one card. One rank of an NCCL process group through
  ``Trainer(mesh=make_mesh())``: its captured epoch, the all-reduce in the
  graph, bit for bit the plain trainer's at batch 128 and 32, both timed
  in turns, with the collective's bytes per step; then two spawned ranks
  sharing the card on gloo (NCCL refuses two ranks on one device): 3 f32
  steps at batch 128 against the one-rank run, ZeRO-1 against the
  replicated optimizer, each rank's kernel launches as counted; and on
  those ranks the halo stack on the covid stand-in's first frame (10,333
  atoms, F 192, 2 layers) against the unsharded ``EquiStack``, with each
  rank's peak memory;
- tensor: tensor parallelism on a (1, 2) ('data', 'model') mesh of two gloo
  ranks sharing the card, the dipeptide at full width (each rank's
  message blocks run kernels 1-4 on F 300): 3 f32 steps at batch 128
  against the one-rank run, each rank's launches as counted, its shards,
  moments and peak memory;
- examples: the JAX repo's example tools on the port (``examples/*_torch.py``)
  through their importable functions, cut to fit 60 s: the kernel shape
  table at its seven shapes (pseudo M 3, 6, 100, 300; message N 27, 209,
  500; F 600, fwd+bwd, each row's kernels against the plain version and
  timed), the quickstart at 2 epochs, the validity census on its test
  reconstructions, the A/B harness (float32 and bfloat16+bf16adam) at 2
  epochs, and the ablation's captured step and parts at the flagship width.

The kernel checks include the tensor-parallel slices (F 300 timed, F 150).
Every phase raises on failure; there is no CPU fallback. The phases that
launch none of the four kernels (cgae, native, pcn, covid, diffpool,
baseline) run first, while nvcc builds the kernels beside them. Output, in
order: the card's name and power limit (nvidia-smi), those phases' checks
and timings, the build with each main-path kernel's ptxas registers and
spills, each kernel against its plain version (with, at the main path's
shapes, its time and the plain version's from CUDA graph replays, and its
roofline bound from ``kernel_cost``; the wide kernels, R+1 > 16, at n_rbf
16, 20 and the largest each takes; the chignolin recipe's shapes), the
serve, train and captured checks and timings, the cv phase's checks and
its wall time by part, the runfiles, steric, sparse, hpo, multigpu,
tensor and examples phases' checks and timings, the seconds of every phase, one JSON line with
one entry per kernel and timed shape, and last one JSON line ``{"ok":
true, "device": {...}}``. The profiles' tables go to
``chiprun_out/train_profile.txt``, ``captured_profile_b{128,32}.txt`` and
``sparse_{pseudo,pseudo2}_profile_b{128,32}.txt``, ``pcn_profile.txt``,
``covid_profile_b2.txt``, ``diffpool_profile.txt`` and
``baseline_profile.txt``, the dipeptide data to ``chiprun_out/cv_data/``,
the cv runs (the covid fold's too) to ``build/cv_smoke/``, the PCN, DiffPool,
baseline and hpo runs to ``build/{pcn,diffpool,baseline,hpo}_smoke/``, the
multigpu and tensor phases' stores and one-rank parameters to
``build/multigpu_smoke/`` and ``build/tensor_smoke/``, the example tools'
files to ``build/examples_smoke/`` and their rows to
``chiprun_out/examples_smoke.json``.
Needs one CUDA device; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

# kernel comparison: max |kernel - plain| / max |plain| per output (f32,
# different summation order only; the backward's d_w also sums the batch in
# another order)
KERNEL_RTOL = 1e-4
# serving: f32 model on the card vs the same model on the CPU (plain path),
# 5 decoder layers of f32 GEMMs and kernels summed in another order
SERVE_RTOL = 1e-4
# training: one f32 step on the card vs the same step on the CPU, every
# gradient and every updated parameter, relative to the tensor's max |ref|
TRAIN_RTOL = 1e-4
N_REQUESTS, FRAMES_PER_REQUEST, N_SAMPLES = 4, 4, 64
ENCODER_LAYERS, PRIOR_LAYERS, DECODER_LAYERS = 4, 4, 5
TRAIN_BATCH, TRAIN_FRAMES, TRAIN_STEPS, PROFILE_STEPS = 128, 256, 100, 5
# the wide kernels' timed basis size (R+1 = 21 > 16)
WIDE_RBF = 20
# the captured phase: bench.py's batch and the README quickstart's, an
# epoch of CAPTURE_STEPS steps timed eager and captured
CAPTURE_BATCHES, CAPTURE_STEPS = (128, 32), 100
# the cgae phase: learn_map's 1,500 steps on 640 frames; card vs CPU on the
# same draws, the final logits within 1e-3 of their range (f32 in another
# summation order, through 1,500 Adam steps that scale each update to ~lr)
CGAE_FRAMES, CGAE_STEPS, CGAE_LOGIT_ATOL = 640, 1500, 1e-3
# the cv phase: the README quickstart's recipe (cgae mapping, pseudo
# decoder) at bench.py's width and batch, cut in depth
CV_WIDTH = ["-n_basis", "600", "-n_rbf", "8", "-enc_nconv", "4", "-dec_nconv", "5",
            "-batch_size", "128"]
CV_RECIPE = ["-dataset", "dipeptide", "-cg_method", "cgae", "-n_cgs", "3", "-atom_cutoff", "8.5",
             "-cg_cutoff", "9.5", "-edgeorder", "2", "-lr", "8e-5", "-beta", "0.05",
             "-gamma", "25", "--graph_eval"]
CV_FRAMES, CV_SPLITS, CV_FOLDS, CV_EPOCHS, CV_ENSEMBLE, CV_EVALS = 640, 5, 2, 2, 16, 16
# from_run vs the in-memory model: the same kernels and weights
FROM_RUN_RTOL = 1e-6
OUT_DIR = Path("chiprun_out")
CV_DIR = Path("build") / "cv_smoke"
# the steric recipes (examples/results/steric_ab): the dipeptide's step at
# zeta 100 with zeta_warmup cut from 500 to STERIC_WARMUP, so that a
# CAPTURE_STEPS-step epoch crosses the ramp's end; the chignolin recipe's
# batch and basis
STERIC_RECIPES = Path(__file__).resolve().parent / "examples" / "results" / "steric_ab"
STERIC_WARMUP = 50
CHIG_BATCH, CHIG_RBF, CHIG_FRAMES, CHIG_EVALS = 16, 10, 160, 4
# the sparse phase: eager vs captured, and each timed epoch, over
# SPARSE_STEPS steps (its step is ~10x the dense one's and device-bound)
SPARSE_STEPS = 20
# the native phase: the cell list against the dense path on NATIVE_FRAMES
# random frames at N 300 and on the covid stand-in's first frames; the
# bond diff against the dense metrics on BOND_DIFF_SAMPLES jittered copies
# of a BOND_DIFF_ATOMS-atom structure
NATIVE_FRAMES, NATIVE_ATOMS, NATIVE_CUTOFF = 8, 300, 4.5
BOND_DIFF_ATOMS, BOND_DIFF_SAMPLES = 2000, 4
# evaluate_samples' default route switch (1,500 atoms, as in the JAX package)
BOND_DIFF_THRESHOLD = 1500
# the pcn phase: the committed PCN recipes (p7 and its --stochastic twin
# p7s), cut in depth to PCN_NDATA proteins and PCN_EPOCHS epochs; the step
# timed over PCN_STEPS steps
PCN_RECIPES = Path(__file__).resolve().parent / "examples" / "results" / "pcn_demo"
PCN_NDATA, PCN_EPOCHS, PCN_STEPS = 80, 2, 20
PCN_DIR = Path("build") / "pcn_smoke"
# the covid phase: the committed covid recipe (sparse, degree_norm, 500
# seqpartition beads), one fold of one epoch on COVID_FRAMES frames (of
# its 5 splits: 4 train frames, 2 batches of 2, 1 val and 2 test frames),
# COVID_ENSEMBLE samples of COVID_EVALS test frames
COVID_RECIPE = Path(__file__).resolve().parent / "examples" / "results" / "_r5_live"
COVID_FRAMES, COVID_ENSEMBLE, COVID_EVALS, COVID_SEED = 7, 4, 2, 123

# the diffpool phase: the committed v6 recipe (examples/results/diffpool_demo)
# through run_diffpool, cut in depth to DIFFPOOL_NDATA frames, DIFFPOOL_EPOCHS
# epochs and DIFFPOOL_PRETRAIN pretraining epochs (both of its 2 folds); the
# step timed over DIFFPOOL_STEPS eager steps
DIFFPOOL_RECIPE = Path(__file__).resolve().parent / "examples" / "results" / "diffpool_demo"
DIFFPOOL_NDATA, DIFFPOOL_EPOCHS, DIFFPOOL_PRETRAIN, DIFFPOOL_STEPS = 320, 2, 2, 20
DIFFPOOL_DIR = Path("build") / "diffpool_smoke"
DIFFPOOL_CV_COLUMNS = ["fold", "test_entropy", "test_graph", "test_kl", "test_loss",
                       "test_recon", "test_reg", "test_steric", "sample_valid_ratio",
                       "sample_allatom_valid_ratio", "sample_ged", "sample_allatom_ged"]
# the baseline phase: the committed examples/results/baseline_demo recipe
# (equimlp), cut to BASELINE_NDATA frames and BASELINE_EPOCHS epochs
BASELINE_RECIPE = Path(__file__).resolve().parent / "examples" / "results" / "baseline_demo"
BASELINE_NDATA, BASELINE_EPOCHS = 400, 3
# beads of the zoo's card-vs-CPU steps (the recipe's knn 3 then reaches
# half the other beads; baseline_phase says why not the recipe's 3)
BASELINE_CHECK_CGS = 6
BASELINE_DIR = Path("build") / "baseline_smoke"
# the hpo phase: the committed examples/results/hpo_demo recipe, as its
# README runs it (6 trials, ASHA, 8 epochs; each trial runs both folds)
HPO_RECIPE = ["-strategy", "asha", "-n_trials", "6", "-dataset", "dipeptide", "-n_cgs", "3",
              "-ndata", "400", "-nepochs", "8", "-batch_size", "32", "-nsplits", "2",
              "-max_folds", "1", "-cg_method", "newman", "-seed", "7", "-patience", "8"]
HPO_DIR = Path("build") / "hpo_smoke"
# the multigpu phase (A14): one NCCL rank through the captured step at the
# captured phase's batches, MULTIGPU_STEPS-step epochs held bit for bit to
# the plain trainer's and timed beside them; then MULTIGPU_RANKS ranks
# sharing the card on gloo (NCCL refuses two ranks on one device):
# MULTIGPU_TRAIN_STEPS f32 steps at TRAIN_BATCH against the one-rank run
# (TRAIN_RTOL of each parameter's max |ref|), ZeRO-1 against the
# replicated optimizer, and the halo stack at the covid recipe's width,
# HALO_LAYERS layers, on the covid stand-in's first frame (HALO_RTOL of
# max |ref|, forward and parameter gradients)
MULTIGPU_RANKS, MULTIGPU_STEPS, MULTIGPU_TRAIN_STEPS, HALO_LAYERS = 2, 20, 3, 2
HALO_RTOL = 1e-4
MULTIGPU_DIR = Path("build") / "multigpu_smoke"
# the tensor phase (A14b): TENSOR_MESH = (data, model) ranks sharing the
# card on gloo, the dipeptide at full width, so each model rank runs the
# kernels on TENSOR_F = 600 / 2 features; MULTIGPU_TRAIN_STEPS f32 steps at
# TRAIN_BATCH against the one-rank run (TRAIN_RTOL of each max |ref|)
TENSOR_MESH, TENSOR_F = (1, 2), 300
TENSOR_DIR = Path("build") / "tensor_smoke"
# the hpo phase's search on MULTIGPU_RANKS gloo ranks sharing the card,
# the recipe cut to HPO_RANKS_CUT, against one process (HPO_RANKS_RTOL,
# the CLI test's tolerance for data-parallel bf16 runs)
HPO_RANKS_CUT = ["-n_trials", "2", "-nepochs", "2"]
HPO_RANKS_RTOL = 1e-3
# runfiles: the served request of a converted fold, and its copies
RUNFILES_SAMPLES = 64
RUNFILES_DIR = Path("build") / "runfiles_smoke"
# the examples phase: the JAX repo's example tools on the port
# (examples/*_torch.py), cut to fit its budget: the kernel shape table's
# graphs of EXAMPLES_KERNEL_STEPS steps, the quickstart and the A/B harness
# at EXAMPLES_EPOCHS epochs, the ablation's step and parts at
# EXAMPLES_FLAGSHIP_STEPS steps
EXAMPLES_DIR = Path("build") / "examples_smoke"
EXAMPLES_KERNEL_STEPS, EXAMPLES_EPOCHS, EXAMPLES_FLAGSHIP_STEPS = 2, 2, 5
EXAMPLES_AB_VARIANTS = "float32,bfloat16+bf16adam"


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def ptxas_summary(log: str) -> dict:
    """Each kernel's registers, shared memory and spills from the
    ``-Xptxas -v`` output of a build: {mangled kernel name: summary}."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            out[name] = ""
        elif name is not None and ("spill" in line or "Used" in line):
            out[name] = (out[name] + "; " + line.split(":", 1)[-1].strip()).strip("; ")
    return out


def print_ptxas(label: str, log: str, ra: int = 9) -> None:
    """The ptxas lines of the main path's instantiations (the templated
    kernels exist for every R+1 in 2..16, the first template argument,
    mangled ``ILi<R+1>E``) and of the wide kernels (R+1 > 16)."""
    for kernel, line in ptxas_summary(log).items():
        if "ILi" not in kernel or f"ILi{ra}E" in kernel or "wide" in kernel:
            print(f"  ptxas {label} {kernel}: {line}", flush=True)


LIBRARY_NOTE = ("no single PyTorch call computes this function; the plain version under "
                "torch.compile (examples/profile_kernels_torch.py --compile) is a yardstick, "
                "not a port")


def kernel_inputs(kind: str, b: int, n: int, s: int, f: int, r: int, seed: int):
    """Seeded inputs on the card; every second batch element has its last
    node masked out."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    xyz = randn(b, n, 3) * 3.0
    mask = torch.ones(b, n, device="cuda")
    mask[::2, -1] = 0.0
    if kind.startswith("message"):
        args = (xyz, mask, randn(b, n, s, f), randn(b, n, 3, f), randn(r + 1, s, f) * 0.3)
        cts = (randn(b, n, f), randn(b, n, 3, f))
    else:
        args = (xyz, mask, randn(b, n, 9, f), randn(b, n, f), randn(b, n, f),
                randn(b, n, 3, f), randn(b, n, 3, f), randn(r + 1, 9, f) * 0.3)
        cts = (randn(b, n, f), randn(b, n, f), randn(b, n, 3, f), randn(b, n, 3, f))
    return args + cts if kind.endswith("vjp") else args


def kernel_cases() -> list:
    """(kernel, (B, N, S, n_rbf), cutoff, label, timed[, F]) of every case
    ``check_kernels`` holds to its plain version; F is 600 unless given."""
    from coarsegrainingvae_tpu_torch.ops import fused_message as mo
    from coarsegrainingvae_tpu_torch.ops import fused_pseudo as po

    # (kernel, (B, N, S, n_rbf), cutoff, label, timed): the shapes the served
    # model (B = 64 samples) and the trained model (B = 128 frames) give each
    # kernel, the cross variant, N beyond one 32-partner chunk, the smallest
    # and largest n_rbf the kernels take (the message kernels at N = 27, the
    # pseudo kernels at M = 3 and 6; their radial sines come from a
    # recurrence whose error grows with the index), and the pseudo kernels'
    # chunked path (M > 6)
    cases = [
        ("message", (64, 3, 3, 8), 9.5, "prior serve B=64 M=3 S=3", True),
        ("message", (128, 27, 3, 8), 9.5, "encoder train B=128 N=27 S=3", True),
        ("message", (128, 3, 3, 8), 9.5, "prior train B=128 M=3 S=3", True),
        ("message", (64, 27, 4, 8), 9.5, "cross B=64 N=27 S=4", False),
        ("message", (16, 70, 4, 8), 9.5, "three partner chunks B=16 N=70 S=4", False),
        ("pseudo", (64, 3, 9, 8), 8.5, "decoder serve B=64 M=3", True),
        ("pseudo", (128, 3, 9, 8), 8.5, "decoder train B=128 M=3", True),
        ("pseudo", (64, 6, 9, 8), 8.5, "decoder B=64 M=6", False),
        ("message_vjp", (128, 27, 3, 8), 9.5, "encoder train B=128 N=27 S=3", True),
        ("message_vjp", (128, 3, 3, 8), 9.5, "prior train B=128 M=3 S=3", True),
        ("message_vjp", (64, 27, 4, 8), 9.5, "cross B=64 N=27 S=4", False),
        ("message_vjp", (16, 70, 3, 8), 9.5, "three partner chunks B=16 N=70 S=3", False),
        ("message_vjp", (16, 70, 4, 8), 9.5, "three partner chunks B=16 N=70 S=4", False),
        ("pseudo_vjp", (128, 3, 9, 8), 8.5, "decoder train B=128 M=3", True),
        # the cv phase's new shapes: the cross decoder trains the message
        # kernels at S 4, M 3; sample_ensemble reconstructs one frame at a
        # time (B 1) and generates n_ensemble samples (B 16)
        ("message", (128, 3, 4, 8), 8.5, "cross decoder train B=128 M=3 S=4", True),
        ("message_vjp", (128, 3, 4, 8), 8.5, "cross decoder train B=128 M=3 S=4", True),
        ("message", (1, 27, 3, 8), 9.5, "encoder eval B=1 N=27 S=3", True),
        ("message", (1, 3, 3, 8), 9.5, "prior eval B=1 M=3 S=3", True),
        ("pseudo", (1, 3, 9, 8), 8.5, "decoder eval B=1 M=3", True),
        ("message", (16, 3, 3, 8), 9.5, "prior sample B=16 M=3 S=3", True),
        ("pseudo", (16, 3, 9, 8), 8.5, "decoder sample B=16 M=3", True),
        ("pseudo_vjp", (64, 6, 9, 8), 8.5, "decoder B=64 M=6", False),
    ] + [(kind, (64, 27, s, r), 9.5, f"B=64 N=27 S={s} n_rbf={r}", False)
         for kind in ("message", "message_vjp") for s, r in ((3, 1), (3, 15), (4, 1), (4, 15))
         ] + [(kind, (64, m, 9, r), 8.5, f"B=64 M={m} n_rbf={r}", False)
              for kind in ("pseudo", "pseudo_vjp") for m in (3, 6) for r in (1, 15)
              ] + [(kind, (16, 70, 9, 8), 8.5, "chunked path B=16 M=70", False)
                   for kind in ("pseudo", "pseudo_vjp")]
    # the wide kernels (R+1 > 16): n_rbf 16, 20 and the largest each takes,
    # timed at n_rbf 20 at the training shapes
    cases += [(kind, (b, 27, s, r), 9.5, f"wide B={b} N=27 S={s} n_rbf={r}", False)
              for kind in ("message", "message_vjp") for s in (3, 4)
              for b, r in ((64, 16), (64, 20), (16, mo.MAX_RBF))]
    cases += [(kind, (b, m, 9, r), 8.5, f"wide B={b} M={m} n_rbf={r}", False)
              for kind in ("pseudo", "pseudo_vjp") for m in (3, 6)
              for b, r in ((64, 16), (64, 20), (16, po.MAX_RBF))]
    cases += [(kind, (128, n, s, WIDE_RBF), cut, f"wide {label} n_rbf={WIDE_RBF}", True)
              for kind, n, s, cut, label in (
                  ("message", 27, 3, 9.5, "encoder train B=128 N=27 S=3"),
                  ("message_vjp", 27, 3, 9.5, "encoder train B=128 N=27 S=3"),
                  ("pseudo", 3, 9, 8.5, "decoder train B=128 M=3"),
                  ("pseudo_vjp", 3, 9, 8.5, "decoder train B=128 M=3"))]
    # the chignolin recipe's shapes (chig_full_z200w: batch 16, n_rbf 10):
    # the encoder at N 209 under the CG cutoff 25, the prior at M 6 and the
    # cross decoder at M 6, S 4 under the atom cutoff 12; the pseudo kernels
    # at the same M, B and n_rbf, which no chignolin recipe runs
    cases += [(kind, (CHIG_BATCH, n, s, CHIG_RBF), cut, f"chignolin {label}", True)
              for base, n, s, cut, label in (
                  ("message", 209, 3, 25.0, "encoder train B=16 N=209 S=3 n_rbf=10"),
                  ("message", 6, 3, 25.0, "prior train B=16 M=6 S=3 n_rbf=10"),
                  ("message", 6, 4, 12.0, "cross decoder train B=16 M=6 S=4 n_rbf=10"),
                  ("pseudo", 6, 9, 12.0, "pseudo size B=16 M=6 n_rbf=10"))
              for kind in (base, base + "_vjp")]
    # tensor parallelism: each model rank runs the kernels on its F/m
    # features, F 300 at m = 2 (the tensor phase's shapes, timed) and F 150
    # at m = 4; neither is a multiple of the kernels' 32-feature block
    cases += [(kind, (128, n, s, 8), cut, f"TP F={fs} {label}", fs == TENSOR_F, fs)
              for fs in (TENSOR_F, 150)
              for base, n, s, cut, label in (
                  ("message", 27, 3, 9.5, "encoder train B=128 N=27 S=3"),
                  ("message", 3, 3, 9.5, "prior train B=128 M=3 S=3"),
                  ("pseudo", 3, 9, 8.5, "decoder train B=128 M=3"))
              for kind in (base, base + "_vjp")]
    # the kernel shape table's new shapes (examples/profile_kernels_torch.py,
    # timed there fwd+bwd): the pseudo kernels' chunked path at PCN-scale M
    # 100 and 300, the message kernels at N 500, S 4; every output checked
    cases += [(kind, (b, n, s, 8), cut, f"shape table B={b} {label}", False)
              for base, b, n, s, cut, label in (
                  ("pseudo", 4, 100, 9, 21.0, "M=100"), ("pseudo", 1, 300, 9, 21.0, "M=300"),
                  ("message", 2, 500, 4, 9.5, "N=500 S=4"))
              for kind in (base, base + "_vjp")]
    return cases


def check_kernels(cases=None, timer=None, extra=None) -> list:
    """Every kernel against its plain version at each case of ``cases``
    (``kernel_cases()``); the timed cases' numbers, one dict per (kernel,
    shape). ``timer(fn)`` gives a call's ms (``graph_ms``); ``extra(plain,
    args, ref)`` returns more columns for a timed row."""
    import torch

    from coarsegrainingvae_tpu_torch.ops import fused_message as mo
    from coarsegrainingvae_tpu_torch.ops import fused_pseudo as po
    from coarsegrainingvae_tpu_torch.ops.geometry import pair_filter_basis
    from coarsegrainingvae_tpu_torch.utils.profiling import bound, graph_ms, kernel_cost, rel_err

    f = 600
    timer = timer or graph_ms
    fns = {"message": (mo.fused_message, mo.message_reference),
           "pseudo": (po.fused_pseudo_message, po.pseudo_reference),
           "message_vjp": (mo.fused_message_vjp, mo.message_vjp_reference),
           "pseudo_vjp": (po.fused_pseudo_vjp, po.pseudo_vjp_reference)}
    timed = []
    for seed, (kind, (b, n, s, r), cut, label, is_timed, *width) in enumerate(
            kernel_cases() if cases is None else cases):
        kern, plain = fns[kind]
        fc = width[0] if width else f
        args = kernel_inputs(kind, b, n, s, fc, r, seed) + (cut, r)
        with torch.no_grad():
            out = kern(*args)
            ref = plain(*args)
            torch.cuda.synchronize()
            rel, err = rel_err(out, ref)
            line = f"kernel {kind} [{label}]: max|err| {err:.3e}, max|err|/max|ref| {rel:.3e}"
            if not rel <= KERNEL_RTOL:
                raise RuntimeError(f"{kind} kernel [{label}] disagrees with its plain version: "
                                   f"{rel:.3e} > {KERNEL_RTOL}")
            if is_timed:
                ms, plain_ms = timer(lambda: kern(*args)), timer(lambda: plain(*args))
                pairs = int(pair_filter_basis(args[0], args[1], cut, r)[1].sum().item())
                n_bytes, flops = kernel_cost(kind, b, n, s if kind.startswith("message") else 9,
                                             fc, r, pairs)
                bound_ms, bound_by, resource = bound(n_bytes, flops)
                timed.append({"kind": kind, "shape": label, "f": fc, "n_rbf": r,
                              "max_abs_err": err, "max_rel_err": rel, "ms": ms,
                              "plain_ms": plain_ms, "bytes": n_bytes, "flops": flops,
                              "pairs": pairs, "bound_ms": bound_ms, "bound_by": bound_by,
                              "bound_resource": resource, "share": bound_ms / ms,
                              **(extra(plain, args, ref) if extra else {})})
                line += (f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                         f"({resource}: {n_bytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP over "
                         f"{pairs} pairs), {100 * bound_ms / ms:.1f} % of it")
        print(line, flush=True)
    return timed


def reset_counts() -> None:
    from coarsegrainingvae_tpu_torch.ops import kernel_counters

    for fn in kernel_counters():
        fn.launches = 0


def read_counts() -> dict:
    from coarsegrainingvae_tpu_torch.ops import kernel_counters

    return {fn.__name__: fn.launches for fn in kernel_counters()}


def dipeptide_model_cfg(**kw):
    """bench.py::dipeptide_config's model, at the port's full width."""
    from coarsegrainingvae_tpu_torch.config import ModelConfig

    return ModelConfig(**{**dict(n_cgs=3, n_basis=600, n_rbf=8, atom_cutoff=8.5, cg_cutoff=9.5,
                                 enc_nconv=4, dec_nconv=5, activation="swish",
                                 dec_type="pseudo", breaksym=True), **kw})


def serve() -> dict:
    import dataclasses

    import numpy as np
    import torch

    from coarsegrainingvae_tpu_torch.config import ExperimentConfig
    from coarsegrainingvae_tpu_torch.data.dataset import _segment_mean_np
    from coarsegrainingvae_tpu_torch.data.mappings import newman_mapping
    from coarsegrainingvae_tpu_torch.data.synthetic import synthetic_peptide
    from coarsegrainingvae_tpu_torch.models.dense_cgvae import DenseCGVAE
    from coarsegrainingvae_tpu_torch.serve import Backmapper

    t0 = time.perf_counter()
    n_frames = N_REQUESTS * FRAMES_PER_REQUEST
    z, frames, bonds = synthetic_peptide("dipeptide", n_frames=n_frames, seed=0, device="cuda")
    mapping = newman_mapping(bonds, z.shape[0], 3, seed=0)
    cg = _segment_mean_np(frames, mapping, 3)
    print(f"serve setup: dipeptide {z.shape[0]} atoms, 3 beads, {n_frames} CG frames "
          f"({time.perf_counter() - t0:.2f} s)", flush=True)

    model_cfg = dipeptide_model_cfg()
    cfg = ExperimentConfig(model=model_cfg)
    model = DenseCGVAE(model_cfg, generator=torch.Generator().manual_seed(0))
    bm = Backmapper(model, mapping, z, cfg, device="cuda")
    bm.backmap(cg[0], n_samples=N_SAMPLES, seed=99)       # warm-up request

    reset_counts()
    outs, lat = [], []
    for q in range(N_REQUESTS):
        req = cg[q * FRAMES_PER_REQUEST:(q + 1) * FRAMES_PER_REQUEST]
        torch.cuda.synchronize()
        t = time.perf_counter()
        outs.append(bm.backmap(req, n_samples=N_SAMPLES, seed=q))
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t)
    launches = read_counts()

    ens = np.stack(outs)                     # (requests, frames, samples, N, 3)
    want = (N_REQUESTS, FRAMES_PER_REQUEST, N_SAMPLES, z.shape[0], 3)
    if ens.shape != want or not np.isfinite(ens).all():
        raise RuntimeError(f"served ensembles: shape {ens.shape} (want {want}) or not finite")
    flat_cg = cg[:n_frames].reshape(N_REQUESTS, FRAMES_PER_REQUEST, 3, 3)
    com_err = max(
        np.abs(ens[..., mapping == k, :].mean(-2) - flat_cg[:, :, None, k]).max()
        for k in range(3)
    )
    if not com_err < 1e-3:
        raise RuntimeError(f"centre-of-mass constraint broken: {com_err:.3e} A")
    spread = np.abs(ens[:, :, 0] - ens[:, :, 1]).max()
    if not spread > 1e-5:
        raise RuntimeError("samples of one frame do not differ")
    n_calls = N_REQUESTS * FRAMES_PER_REQUEST
    expect = {"fused_message": PRIOR_LAYERS * n_calls, "fused_message_vjp": 0,
              "fused_pseudo_message": DECODER_LAYERS * n_calls, "fused_pseudo_vjp": 0}
    if launches != expect:
        raise RuntimeError(f"kernel launches {launches}, expected {expect}")
    print(f"serve checks: shape {ens.shape}, finite, COM error {com_err:.2e} A, "
          f"sample spread {spread:.3f} A, launches {launches} (expected {expect})", flush=True)
    lat_ms = [x * 1e3 for x in lat]
    samples = FRAMES_PER_REQUEST * N_SAMPLES
    print(f"serve latency per request ({FRAMES_PER_REQUEST} frames x {N_SAMPLES} samples, bf16): "
          f"{', '.join(f'{x:.2f}' for x in lat_ms)} ms; median {np.median(lat_ms):.2f} ms, "
          f"{samples / np.median(lat):.1f} samples/s", flush=True)

    # f32 model on the card vs the same parameters and eps on the CPU
    cfg32 = dataclasses.replace(model_cfg, compute_dtype="float32")
    gpu32 = DenseCGVAE(cfg32, generator=torch.Generator().manual_seed(0)).to("cuda").eval()
    cpu32 = DenseCGVAE(cfg32, generator=torch.Generator().manual_seed(0)).eval()
    worst = 0.0
    with torch.inference_mode():
        for k, frame in enumerate(cg[:FRAMES_PER_REQUEST]):
            batch = bm._make_batch(np.repeat(frame[None], N_SAMPLES, axis=0))
            eps = torch.randn((N_SAMPLES, 3, 600), generator=torch.Generator().manual_seed(k))
            out_gpu = gpu32.generate(batch, eps=eps).cpu()
            out_cpu = cpu32.generate(batch.to("cpu"), eps=eps)
            worst = max(worst, ((out_gpu - out_cpu).abs().max() / out_cpu.abs().max()).item())
    print(f"serve f32 card vs CPU plain path: max|err|/max|ref| {worst:.3e} "
          f"(tolerance {SERVE_RTOL:g})", flush=True)
    if not worst <= SERVE_RTOL:
        raise RuntimeError("served f32 output disagrees with the CPU plain path")
    return launches


def window_starts(n_frames: int, bs: int, steps: int):
    """bench.py::window_starts: batch windows cycling over the frames."""
    import numpy as np

    return (np.arange(steps) * bs) % (n_frames - bs + 1)


def f32_step_card_vs_cpu(ds, cfg=None, build=None, tables=None, at_step: int = 0) -> tuple:
    """One f32 train step at full width (batch 8) on the card and on the
    CPU from the same parameters: (worst max|err|/max|ref| over every
    gradient, the same over every updated parameter). The reference update
    is the CPU's optimizer applied to the card's gradient: Adam's first
    step maps g to g / (|g| + 1e-8), which turns rounding-level gradient
    differences of entries near zero into update differences up to lr, so
    the gradients are compared first and the update on its own. ``cfg``
    defaults to bench.py's recipe at f32, ``build`` to the dense model;
    ``tables`` are steric tables, and ``at_step`` the step counter both
    states start from (where a warm-up ramp stands)."""
    import numpy as np
    import torch

    from coarsegrainingvae_tpu_torch.config import DataConfig, ExperimentConfig, TrainConfig
    from coarsegrainingvae_tpu_torch.models.dense_cgvae import DenseCGVAE
    from coarsegrainingvae_tpu_torch.train.trainer import Trainer

    if cfg is None:
        cfg = ExperimentConfig(
            model=dipeptide_model_cfg(compute_dtype="float32", det=True),
            data=DataConfig(batch_size=8),
            train=TrainConfig(lr=3.2e-4, beta=0.05, gamma=25.0, grad_clip=0.01,
                              adam_moment_dtype="bfloat16"))
    build = build or DenseCGVAE
    batch = ds.batch(np.arange(8))
    steps = {}
    for device in ("cuda", "cpu"):
        tr = Trainer(build(cfg.model, generator=torch.Generator().manual_seed(1)), cfg,
                     device=device, steric_tables=tables)
        state = tr.init_state(batch)
        with torch.no_grad():
            state.step.fill_(at_step)
        loss, _, grads = tr.loss_and_grads(state, batch.to(device))
        steps[device] = (tr, state, loss, grads)
    tr, state, loss, grads = steps["cuda"]
    state, ok = tr.apply_gradients(state, loss, grads)
    card_params = [p.detach().cpu() for p in state.params.values()]
    card_grads = [g.cpu() for g in grads]
    tr, state, _, ref_grads = steps["cpu"]
    state, ok_ref = tr.apply_gradients(state, loss.cpu(), card_grads)
    if not (bool(ok) and bool(ok_ref)):
        raise RuntimeError("the f32 check step was rejected by the skip guard")

    def worst(got, want):
        return max((a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
                   for a, b in zip(got, want))

    return worst(card_grads, ref_grads), worst(card_params, list(state.params.values()))


def train() -> dict:
    import numpy as np
    import torch

    from coarsegrainingvae_tpu_torch.config import DataConfig, ExperimentConfig, TrainConfig
    from coarsegrainingvae_tpu_torch.data.dataset import build_dataset
    from coarsegrainingvae_tpu_torch.data.device import DeviceDataset
    from coarsegrainingvae_tpu_torch.data.mappings import newman_mapping
    from coarsegrainingvae_tpu_torch.data.synthetic import synthetic_peptide
    from coarsegrainingvae_tpu_torch.models.dense_cgvae import DenseCGVAE
    from coarsegrainingvae_tpu_torch.train.trainer import Trainer
    from coarsegrainingvae_tpu_torch.utils import profiling

    t0 = time.perf_counter()
    # bench.py::dipeptide_dataset
    z, frames, bonds = synthetic_peptide("dipeptide", n_frames=TRAIN_FRAMES, seed=0, device="cuda")
    mapping = newman_mapping(bonds, z.shape[0], 3, seed=0)
    ds = build_dataset(mapping, frames, atom_cutoff=8.5, cg_cutoff=9.5, atomic_nums=z,
                       bonds=bonds, order=2, rotate=True)
    # bench.py::dipeptide_config(128)
    cfg = ExperimentConfig(
        model=dipeptide_model_cfg(), data=DataConfig(batch_size=TRAIN_BATCH),
        train=TrainConfig(lr=1.6e-4 * (TRAIN_BATCH / 64), beta=0.05, gamma=25.0,
                          grad_clip=0.01, adam_moment_dtype="bfloat16"))
    tr = Trainer(DenseCGVAE(cfg.model, generator=torch.Generator().manual_seed(0)), cfg,
                 device="cuda")
    dds = DeviceDataset.from_dataset(ds, "cuda")
    state = tr.init_state(ds.batch(np.arange(TRAIN_BATCH)))
    n_params = sum(p.numel() for p in state.params.values())
    print(f"train setup: {len(ds)} frames, {len(ds.bonds)} graph-loss edges, "
          f"{n_params} parameters ({time.perf_counter() - t0:.2f} s)", flush=True)

    starts = window_starts(len(ds), TRAIN_BATCH, TRAIN_STEPS)
    idx = torch.as_tensor(starts[:, None] + np.arange(TRAIN_BATCH)[None, :],
                          dtype=torch.long, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def run(state, record):
        for i in range(TRAIN_STEPS):
            state, m = tr.train_step(state, dds.gather(idx[i]), gen)
            record.append(m)
        return state

    first, second = [], []
    t = time.perf_counter()
    state = run(state, first)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t

    reset_counts()
    t = time.perf_counter()
    state = run(state, second)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    launches = read_counts()

    def series(rec, key):
        return torch.stack([m[key] for m in rec]).float().cpu().numpy()

    loss = np.concatenate([series(first, "loss"), series(second, "loss")])
    recon = np.concatenate([series(first, "recon"), series(second, "recon")])
    skipped = float(series(first, "skipped").sum() + series(second, "skipped").sum())
    ms = dt / TRAIN_STEPS * 1e3
    print(f"train: {TRAIN_STEPS} steps in {warm_s:.2f} s, then {TRAIN_STEPS} timed steps in "
          f"{dt:.3f} s: {ms:.3f} ms/step, {TRAIN_STEPS * TRAIN_BATCH / dt:.1f} samples/s "
          f"(batch {TRAIN_BATCH}, bf16 matmuls, bf16 Adam moments)", flush=True)
    print(f"train loss: first 10 mean {loss[:10].mean():.4f}, last 10 mean "
          f"{loss[-10:].mean():.4f}; recon first 10 {recon[:10].mean():.4f}, last 10 "
          f"{recon[-10:].mean():.4f} (not gated); skipped batches {skipped:.0f}", flush=True)
    if not np.isfinite(loss).all():
        raise RuntimeError("a training loss is not finite")
    if not loss[-10:].mean() < loss[:10].mean():
        raise RuntimeError("the total loss did not fall over 200 steps")
    per_step = {"fused_message": ENCODER_LAYERS + PRIOR_LAYERS,
                "fused_message_vjp": ENCODER_LAYERS + PRIOR_LAYERS,
                "fused_pseudo_message": DECODER_LAYERS, "fused_pseudo_vjp": DECODER_LAYERS}
    expect = {k: v * TRAIN_STEPS for k, v in per_step.items()}
    print(f"train launches over the {TRAIN_STEPS} timed steps: {launches} (expected {expect})",
          flush=True)
    if launches != expect:
        raise RuntimeError(f"train kernel launches {launches}, expected {expect}")

    # where the time goes: a profiled window of a few steps
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i in range(PROFILE_STEPS):
            state, _ = tr.train_step(state, dds.gather(idx[i]), gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    p = profiling.device_profile(prof, wall_ms, PROFILE_STEPS)
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "train_profile.txt").write_text(
        prof.key_averages().table(sort_by="self_device_time_total", row_limit=40))
    print(f"train profile ({PROFILE_STEPS} steps, {wall_ms / PROFILE_STEPS:.3f} ms/step profiled): "
          f"device busy {p['busy_ms'] / PROFILE_STEPS:.3f} ms/step = {100 * p['busy_share']:.1f} % "
          f"of wall; {p['device_events_per_step']:.0f} device events and "
          f"{p['host_launch_calls_per_step']:.0f} host launch calls per step", flush=True)
    for name, ms_step, n in p["top"]:
        print(f"  device {ms_step:.3f} ms/step, {n}/step: {name}", flush=True)

    grad_err, param_err = f32_step_card_vs_cpu(ds)
    print(f"train f32 step card vs CPU (batch 8): every gradient max|err|/max|ref| "
          f"{grad_err:.3e}, every updated parameter {param_err:.3e} "
          f"(tolerance {TRAIN_RTOL:g})", flush=True)
    if not max(grad_err, param_err) <= TRAIN_RTOL:
        raise RuntimeError("the f32 train step on the card disagrees with the CPU")

    # Trainer.fit, 2 epochs on a 224/32 split
    reset_counts()
    fit_tr = Trainer(DenseCGVAE(cfg.model, generator=torch.Generator().manual_seed(2)), cfg,
                     device="cuda")
    fit_state = fit_tr.init_state(ds.batch(np.arange(TRAIN_BATCH)))
    t = time.perf_counter()
    fit_state, hist = fit_tr.fit(fit_state, ds.subset(np.arange(224)),
                                 ds.subset(np.arange(224, 256)), nepochs=2)
    fit_launches = read_counts()
    if len(hist) != 2 or not all(np.isfinite(v) for row in hist for v in row.values()):
        raise RuntimeError(f"fit history is not 2 finite rows: {hist}")
    print(f"fit: 2 epochs in {time.perf_counter() - t:.2f} s, train_loss "
          f"{[round(r['train_loss'], 4) for r in hist]}, val_loss "
          f"{[round(r['val_loss'], 4) for r in hist]}, launches {fit_launches}", flush=True)
    if min(fit_launches.values()) == 0:
        raise RuntimeError(f"fit did not launch every kernel: {fit_launches}")
    return {"train": launches, "fit": fit_launches}


def train_cfg(batch_size: int, **model_kw):
    """bench.py::dipeptide_config(batch_size) at the port's full width."""
    from coarsegrainingvae_tpu_torch.config import DataConfig, ExperimentConfig, TrainConfig

    return ExperimentConfig(
        model=dipeptide_model_cfg(**model_kw), data=DataConfig(batch_size=batch_size),
        train=TrainConfig(lr=1.6e-4 * (batch_size / 64), beta=0.05, gamma=25.0,
                          grad_clip=0.01, adam_moment_dtype="bfloat16"))


def dipeptide_device_data(device: str = "cuda", n_frames: int = TRAIN_FRAMES):
    """bench.py's 256 dipeptide frames (newman mapping) and a maker of
    DeviceDatasets of n frames, the 256 repeated."""
    import numpy as np

    from coarsegrainingvae_tpu_torch.data.dataset import build_dataset
    from coarsegrainingvae_tpu_torch.data.device import DeviceDataset
    from coarsegrainingvae_tpu_torch.data.mappings import newman_mapping
    from coarsegrainingvae_tpu_torch.data.synthetic import synthetic_peptide

    z, frames, bonds = synthetic_peptide("dipeptide", n_frames=n_frames, seed=0, device=device)
    ds = build_dataset(newman_mapping(bonds, z.shape[0], 3, seed=0), frames, atom_cutoff=8.5,
                       cg_cutoff=9.5, atomic_nums=z, bonds=bonds, order=2, rotate=True)

    def dataset(n):
        return DeviceDataset.from_dataset(ds.subset(np.resize(np.arange(len(ds)), n)), device)

    return ds, dataset, z, bonds


def state_tensors(st) -> tuple:
    return (*st.params.values(), st.opt_state.count, st.opt_state.mu, st.opt_state.nu, st.step)


def eager_equals_captured(tr, state, cases, bs: int, label: str) -> None:
    """For each (n_steps, DeviceDataset): one epoch of the static step run
    eagerly and one replayed from its CUDA graph, from the same parameters,
    moments and generator state, held bit for bit (after one step, a
    difference within TRAIN_RTOL is tolerated); the state is restored
    after. Raises if they differ."""
    import numpy as np
    import torch

    from coarsegrainingvae_tpu_torch.data.device import epoch_index_batches

    start = [t.detach().clone() for t in state_tensors(state)]
    for n_steps, dds in cases:
        batches = epoch_index_batches(dds.n_frames, bs, np.random.default_rng(1))
        runs = []
        for capture in (False, True):
            with torch.no_grad():
                for t, v in zip(state_tensors(state), start):
                    t.copy_(v)
            gen = torch.Generator(device="cuda").manual_seed(11)
            st, _ = tr._run_program(state, dds, batches, gen, True, capture)
            prog = tr._programs[(id(dds), True)]
            runs.append((prog.metrics[:n_steps].clone(),
                         [t.detach().clone() for t in state_tensors(st)], gen.get_state()))
        (m_e, p_e, g_e), (m_c, p_c, g_c) = runs
        exact = (torch.equal(m_e, m_c) and torch.equal(g_e, g_c)
                 and all(torch.equal(a, b) for a, b in zip(p_e, p_c)))
        rel = max(((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30)
                   ).item() for a, b in zip(p_c, p_e))
        loss_rel = ((m_c[:, 0] - m_e[:, 0]).abs().max() / m_e[:, 0].abs().max()).item()
        print(f"{label}captured vs eager, {n_steps} step(s) at batch {bs} from the same state "
              f"and generator: bit for bit {exact}; parameters and moments max|err|/max|ref| "
              f"{rel:.3e}, losses {loss_rel:.3e}", flush=True)
        if not exact and not (n_steps == 1 and rel <= TRAIN_RTOL):
            raise RuntimeError(f"{label}the captured epoch disagrees with the eager one")
    with torch.no_grad():
        for t, v in zip(state_tensors(state), start):
            t.copy_(v)
    tr.release_graphs()


def timed_epochs(tr, state, dds, dds_prof, bs: int, per_step: dict, label: str,
                 kinds=("eager", "captured", "eager", "captured"), profile_name=None):
    """Epochs over ``dds`` (n_frames / bs steps) of each of ``kinds`` in turn (eager:
    ``run_epoch_device``; captured: ``run_epoch_scan``, captured before the
    first timed one), each held to ``per_step`` launches per step; then a
    profiled PROFILE_STEPS-step epoch of each kind. Prints one line per
    kind with ms/step, samples/s, device busy and the peak memory allocated
    over the epochs. Returns (state, {kind: [ms/step]}, captured launches,
    peak GB)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from coarsegrainingvae_tpu_torch.utils import profiling

    steps = dds.n_frames // bs
    gen = torch.Generator(device="cuda").manual_seed(12)
    rng = np.random.default_rng(2)
    timings, total = {}, dict.fromkeys(per_step, 0)
    torch.cuda.reset_peak_memory_stats()
    for kind in kinds:
        if kind == "captured" and (id(dds), True) not in tr._programs:
            state, _ = tr.run_epoch_scan(state, dds, gen, shuffle_rng=rng)  # capture
        reset_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        if kind == "eager":
            state, m = tr.run_epoch_device(state, dds, gen, shuffle_rng=rng)
        else:
            state, m = tr.run_epoch_scan(state, dds, gen, shuffle_rng=rng)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        launches = read_counts()
        expect = {k: v * steps for k, v in per_step.items()}
        if launches != expect or m["n_steps"] != steps or not np.isfinite(m["loss"]):
            raise RuntimeError(f"{label}{kind} epoch at batch {bs}: launches {launches} "
                               f"(expected {expect}), n_steps {m['n_steps']}, loss {m['loss']}")
        if kind == "captured":
            for k in total:
                total[k] += launches[k]
        timings.setdefault(kind, []).append(dt / steps * 1e3)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    state, _ = tr.run_epoch_scan(state, dds_prof, gen)      # capture outside the window
    busy = {}
    for kind in dict.fromkeys(kinds):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t = time.perf_counter()
            if kind == "eager":
                state, _ = tr.run_epoch_device(state, dds_prof, gen)
            else:
                state, _ = tr.run_epoch_scan(state, dds_prof, gen)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
        busy[kind] = profiling.device_profile(prof, wall_ms, PROFILE_STEPS)
        busy[kind]["wall_ms"] = wall_ms / PROFILE_STEPS
        if kind == "captured" and profile_name:
            (OUT_DIR / profile_name).write_text(
                prof.key_averages().table(sort_by="self_device_time_total", row_limit=40))
    tr.release_graphs()
    for kind in busy:
        ms = timings[kind]
        p = busy[kind]
        print(f"{label}{kind} epoch, batch {bs}, {steps} steps: "
              f"{', '.join(f'{x:.3f}' for x in ms)} ms/step, "
              f"{', '.join(f'{bs * 1e3 / x:.1f}' for x in ms)} samples/s; profiled "
              f"{PROFILE_STEPS} steps {p['wall_ms']:.3f} ms/step, device busy "
              f"{p['busy_ms'] / PROFILE_STEPS:.3f} ms/step ({100 * p['busy_share']:.1f} %), "
              f"{p['device_events_per_step']:.0f} device events and "
              f"{p['host_launch_calls_per_step']:.0f} host launch calls per step; launches "
              f"{per_step} per step; peak allocated {peak_gb:.3f} GB", flush=True)
    if "captured" in busy:
        for name, ms_step, n in busy["captured"]["top"]:
            print(f"  {label}captured b{bs} device {ms_step:.3f} ms/step, {n}/step: {name}",
                  flush=True)
    return state, timings, total, peak_gb


DENSE_PER_STEP = {"fused_message": ENCODER_LAYERS + PRIOR_LAYERS,
                  "fused_message_vjp": ENCODER_LAYERS + PRIOR_LAYERS,
                  "fused_pseudo_message": DECODER_LAYERS, "fused_pseudo_vjp": DECODER_LAYERS}


def captured() -> tuple:
    """The epoch as one program (``Trainer.run_epoch_scan``): one epoch of
    the static step run eagerly and one replayed from its CUDA graph, from
    the same parameters, moments and generator state, held bit for bit
    (one step, then CAPTURE_STEPS); then ms/step of the eager epoch
    (``run_epoch_device``, the step in a Python loop) against the captured
    one at batch 128 and 32, their device busy time per step, launches and
    peak memory. Raises on any failed check. Returns (the captured epochs'
    launches, {batch: (captured ms/step runs, peak GB)})."""
    import numpy as np
    import torch

    from coarsegrainingvae_tpu_torch.models.dense_cgvae import DenseCGVAE
    from coarsegrainingvae_tpu_torch.train.trainer import Trainer

    ds, dataset, _, _ = dipeptide_device_data()
    total = dict.fromkeys(DENSE_PER_STEP, 0)
    summary = {}
    for bs in CAPTURE_BATCHES:
        tr = Trainer(DenseCGVAE(train_cfg(bs).model, generator=torch.Generator().manual_seed(0)),
                     train_cfg(bs), device="cuda")
        state = tr.init_state(ds.batch(np.arange(bs)))
        dds_long = dataset(bs * CAPTURE_STEPS)
        if bs == CAPTURE_BATCHES[0]:
            eager_equals_captured(tr, state, ((1, dataset(bs)), (CAPTURE_STEPS, dds_long)), bs, "")
        state, timings, launches, peak = timed_epochs(
            tr, state, dds_long, dataset(bs * PROFILE_STEPS), bs, DENSE_PER_STEP, "",
            profile_name=f"captured_profile_b{bs}.txt")
        for k in total:
            total[k] += launches[k]
        summary[bs] = (timings["captured"], peak)
        del tr, state, dds_long
        torch.cuda.empty_cache()
    return total, summary


def cgae_phase(device: str = "cuda", n_frames: int = CGAE_FRAMES,
               n_steps: int = CGAE_STEPS) -> None:
    """``learn_map_core`` on ``device`` and on the CPU from the same
    initial parameters, batch indices and noise, drawn with numpy: the same
    mapping, the final logits within CGAE_LOGIT_ATOL of their range; then
    the production ``get_mapping("cgae")`` on ``device`` for the dipeptide,
    timed, with every bead populated. Raises on any failed check."""
    import numpy as np
    import torch

    from coarsegrainingvae_tpu_torch.data.mappings import get_mapping
    from coarsegrainingvae_tpu_torch.data.synthetic import synthetic_peptide
    from coarsegrainingvae_tpu_torch.models import cgae

    z, frames, bonds = synthetic_peptide("dipeptide", n_frames=n_frames, seed=0, device=device)
    data = cgae.centred_frames(frames)
    f, n, k = data.shape[0], data.shape[1], 3
    b = min(32, f)
    rng = np.random.default_rng(0)
    logits0 = (rng.normal(size=(n, k)) * 0.1).astype(np.float32)
    decode0 = (rng.normal(size=(n, k)) / np.sqrt(k)).astype(np.float32)
    idx = rng.integers(0, f, size=(n_steps, b))
    u = rng.uniform(1e-10, 1.0, size=(n_steps, b, n, k)).astype(np.float32)
    out = {}
    for dev in (device, "cpu"):
        def put(a, dtype=torch.float32):
            return torch.as_tensor(a, dtype=dtype).to(dev)

        if dev != "cpu":
            torch.cuda.synchronize()
        t = time.perf_counter()
        logits, _ = cgae.learn_map_core(put(data), put(logits0), put(decode0),
                                        zip(put(idx, torch.long), put(u)))
        logits = logits.cpu()
        out[dev] = (logits, time.perf_counter() - t)
    (got, got_s), (want, want_s) = out[device], out["cpu"]
    err = (got - want).abs().max().item() / (want.max() - want.min()).item()
    same = np.array_equal(cgae.hard_mapping(got), cgae.hard_mapping(want))
    print(f"cgae learn_map, {n_steps} steps on {n_frames} frames from numpy draws: {device} "
          f"{got_s:.3f} s, cpu {want_s:.3f} s; equal mapping {same}; logits max|err| / their "
          f"range {err:.3e} (tolerance {CGAE_LOGIT_ATOL:g})", flush=True)
    if not (same and err <= CGAE_LOGIT_ATOL):
        raise RuntimeError("learn_map on the card disagrees with the CPU")
    with PartTimes([(cgae, "learn_map", "learn_map")]) as times:
        t = time.perf_counter()
        mapping = get_mapping("cgae", k, z.shape[0], bonds=bonds, frames=frames, seed=0,
                              device=device)
        wall = time.perf_counter() - t
    sizes = np.bincount(mapping, minlength=k)
    print(f"cgae get_mapping on {device}: {wall:.3f} s ({times.line()}), beads "
          f"{sizes.tolist()} atoms", flush=True)
    if mapping.shape != (z.shape[0],) or not (sizes > 0).all() or sizes.size != k:
        raise RuntimeError(f"cgae mapping does not populate {k} beads: {sizes}")


class PartTimes:
    """Wall seconds and calls per part of the cv phase: each (owner,
    attribute, label) is wrapped with a timer on entry and restored on
    exit. Every timed part ends in a host read of device results, so the
    host clock covers its device work."""

    def __init__(self, parts):
        self.parts = parts
        self.seconds, self.calls = defaultdict(float), defaultdict(int)
        self._saved = []

    def _timed(self, fn, label):
        def timed(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.seconds[label] += time.perf_counter() - t
                self.calls[label] += 1
        return timed

    def __enter__(self):
        for owner, attr, label in self.parts:
            fn = getattr(owner, attr)
            self._saved.append((owner, attr, fn))
            setattr(owner, attr, self._timed(fn, label))
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)
        self._saved.clear()

    def line(self) -> str:
        return ", ".join(f"{k} {v:.3f} s ({self.calls[k]}x)" for k, v in self.seconds.items())


def cv_expected_launches(width: list, n_frames: int, folds: int, epochs, evals: int,
                         dec_type: str, splits: int = CV_SPLITS) -> dict:
    """Kernel launches of ``run_cgvae`` over its first ``folds`` folds of
    ``splits``: per fold, ``epochs`` (one count, or one per fold) x (train
    steps + val steps) model forwards and train steps backwards,
    ``reconstruct_all``'s batches, and per evaluated frame one
    reconstruction (B 1) and one generation (prior and decoder only). Each
    forward runs enc_nconv encoder and enc_nconv prior message layers and
    dec_nconv decoder layers (pseudo kernels, or message kernels for the
    cross decoder)."""
    import numpy as np

    arg = dict(zip(width[::2], width[1::2]))
    bs, enc, dec = int(arg["-batch_size"]), int(arg["-enc_nconv"]), int(arg["-dec_nconv"])
    out = dict.fromkeys(("fused_message", "fused_message_vjp", "fused_pseudo_message",
                         "fused_pseudo_vjp"), 0)
    per_fold = [epochs] * folds if isinstance(epochs, int) else list(epochs)
    for test, epochs in zip(np.array_split(np.arange(n_frames), splits)[:folds], per_fold):
        n_full = n_frames - len(test)
        n_val = max(int(n_full * 0.1), 1)
        steps, val_steps = max((n_full - n_val) // bs, 1), max(n_val // bs, 1)
        n_eval = min(evals, len(test))
        forwards = epochs * (steps + val_steps) + -(-len(test) // bs) + n_eval
        backwards = epochs * steps
        out["fused_message"] += 2 * enc * forwards + enc * n_eval
        out["fused_message_vjp"] += 2 * enc * backwards
        dec_fwd, dec_bwd = ("fused_message", "fused_message_vjp") if dec_type == "cross" else (
            "fused_pseudo_message", "fused_pseudo_vjp")
        out[dec_fwd] += dec * (forwards + n_eval)
        out[dec_bwd] += dec * backwards
    return out


def check_cv_run(run: Path, n_folds: int, n_epochs: int) -> list:
    """The run's cv_stats.csv (header CV_STAT_FIELDS, finite rows) and every
    artifact of each fold; returns the rows."""
    import csv
    import math

    from coarsegrainingvae_tpu_torch.cli.run_cgvae import CV_STAT_FIELDS
    from coarsegrainingvae_tpu_torch.train.checkpoint import CheckpointManager

    with open(run / "cv_stats.csv", newline="") as f:
        reader = csv.reader(f)
        header, rows = next(reader), list(reader)
    if header != CV_STAT_FIELDS:
        raise RuntimeError(f"cv_stats.csv header {header} != CV_STAT_FIELDS")
    if len(rows) != n_folds:
        raise RuntimeError(f"cv_stats.csv has {len(rows)} rows, expected {n_folds}")
    # sample RMSDs average over valid samples only; NaN when none is valid
    may_be_nan = {"sample_all_rmsd", "sample_heavy_rmsd"}
    bad = [(row[0], k) for row in rows for k, v in zip(header, row)
           if not math.isfinite(float(v)) and k not in may_be_nan]
    if bad:
        raise RuntimeError(f"cv_stats.csv has values that are not finite: {bad}")
    names = ["mapping.json", "train_log.csv", "test_recon.xyz", "test_samples.xyz"] + [
        f"rotate_{k}.xyz" for k in ("ensemble", "data", "recon", "cg")]
    for row in rows:
        fold = run / f"fold{row[0]}"
        missing = [n for n in names if not (fold / n).is_file()]
        if missing or (fold / "FAILED.txt").exists():
            raise RuntimeError(f"{fold}: missing {missing} or FAILED.txt present")
        if CheckpointManager(str(fold / "ckpt")).latest_step() != n_epochs - 1:
            raise RuntimeError(f"{fold}: no checkpoint of epoch {n_epochs - 1}")
        with open(fold / "train_log.csv") as f:
            if len(f.read().splitlines()) != 1 + n_epochs:
                raise RuntimeError(f"{fold}/train_log.csv does not have {n_epochs} rows")
    for name in ("modelparams.json",) + (("cv_stats_summary.json",) if n_folds > 1 else ()):
        if not (run / name).is_file():
            raise RuntimeError(f"{run}: missing {name}")
    return rows


def cv(device: str = "cuda", width: list = CV_WIDTH, n_frames: int = CV_FRAMES) -> dict:
    """The k-fold workflow through ``cli.run_cgvae``: the main run (counted
    as path ``cv``), ``Backmapper.from_run``, a resumed fold and a fold of
    the cross decoder (path ``cv_cross``). Raises on any failed check.
    The chip smoke run calls it on the card at full width; the CPU and a
    small width rehearse its control flow (the kernels count no launches
    there)."""
    import dataclasses

    import torch

    from coarsegrainingvae_tpu_torch.cli import run_cgvae
    from coarsegrainingvae_tpu_torch.config import ExperimentConfig
    from coarsegrainingvae_tpu_torch.data.proteins import save_npz_traj
    from coarsegrainingvae_tpu_torch.data.synthetic import synthetic_peptide
    from coarsegrainingvae_tpu_torch.eval import sampling
    from coarsegrainingvae_tpu_torch.models import cgae
    from coarsegrainingvae_tpu_torch.train.checkpoint import STATE_FILE, CheckpointManager
    from coarsegrainingvae_tpu_torch.train.trainer import Trainer

    shutil.rmtree(CV_DIR, ignore_errors=True)
    data = OUT_DIR / "cv_data"
    data.mkdir(parents=True, exist_ok=True)
    t = time.perf_counter()
    z, frames, bonds = synthetic_peptide("dipeptide", n_frames=n_frames, seed=0, device=device)
    save_npz_traj(str(data / "dipeptide.npz"), z, frames, bonds)
    os.environ["COARSEGRAININGVAE_DATA"] = str(data)
    print(f"cv data: {n_frames} synthetic dipeptide frames relaxed on {device} and written to "
          f"{data / 'dipeptide.npz'} in {time.perf_counter() - t:.3f} s", flush=True)

    trained = []

    class RecordingTrainer(Trainer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            trained.append(self)

    parts = [(run_cgvae, "load_frames", "load_frames"),
             (run_cgvae, "build_fold_mapping", "mapping"),
             (cgae, "learn_map", "learn_map (inside mapping)"),
             (run_cgvae, "build_dataset", "datasets"),
             (Trainer, "fit", "fit"),
             (CheckpointManager, "save", "checkpoint save"),
             (CheckpointManager, "restore", "checkpoint restore"),
             (run_cgvae, "reconstruct_all", "reconstruct_all"),
             (run_cgvae, "sample_ensemble", "sample_ensemble"),
             (sampling, "evaluate_samples", "metrics (inside both)"),
             (run_cgvae, "write_xyz", "xyz dumps"),
             (run_cgvae, "save_grid_snapshots", "movies")]
    depth = ["-ndata", str(n_frames), "-nsplits", str(CV_SPLITS), "-n_ensemble",
             str(CV_ENSEMBLE), "-nevals", str(CV_EVALS), "--device", device]
    main_args = CV_RECIPE + width + depth + [
        "-logdir", str(CV_DIR / "run"), "--dec_type", "pseudo", "-max_folds", str(CV_FOLDS),
        "-nepochs", str(CV_EPOCHS)]
    run_cgvae.Trainer = RecordingTrainer
    try:
        reset_counts()
        t = time.perf_counter()
        with PartTimes(parts) as times:
            rows = run_cgvae.main(main_args)
        wall = time.perf_counter() - t
        launches = read_counts()
    finally:
        run_cgvae.Trainer = Trainer
    (run,) = [p for p in CV_DIR.iterdir() if p.name.startswith("run")]
    check_cv_run(run, CV_FOLDS, CV_EPOCHS)
    if len(rows) != CV_FOLDS:
        raise RuntimeError(f"run_cgvae returned {len(rows)} rows, expected {CV_FOLDS}")
    expect = cv_expected_launches(width, n_frames, CV_FOLDS, CV_EPOCHS, CV_EVALS, "pseudo")
    print(f"cv run: {CV_FOLDS} folds x {CV_EPOCHS} epochs in {wall:.3f} s; fold wall_s "
          f"{[round(r['wall_s'], 3) for r in rows]}; test recon RMSD "
          f"{[round(r['test_all_recon_rmsd'], 4) for r in rows]} A; sample heavy valid "
          f"{[r['sample_heavy_valid_ratio'] for r in rows]}; launches {launches} "
          f"(expected {expect})", flush=True)
    if device == "cuda" and launches != expect:
        raise RuntimeError(f"cv kernel launches {launches}, expected {expect}")
    epoch_s = []
    for k in range(CV_FOLDS):
        with open(run / f"fold{k}" / "train_log.csv") as f:
            epoch_s.append([round(float(line.split(",")[-1]), 3)
                            for line in f.read().splitlines()[1:]])
    ckpt_mb = os.path.getsize(run / "fold0" / "ckpt" / str(CV_EPOCHS - 1) / STATE_FILE) / 1e6
    print(f"cv wall time by part (both folds): {times.line()}; fit epochs {epoch_s} s; "
          f"checkpoints written {times.calls['checkpoint save']} x {ckpt_mb:.1f} MB", flush=True)

    # from_run: fold 0 read back from disk against the model the fold trained
    rel, load_s = fold_from_run(run, trained[0], device)
    print(f"cv from_run: fold 0 loaded in {load_s:.3f} s; backmap of 4 frames x "
          f"{CV_ENSEMBLE} samples vs the in-memory model: max|err|/max|ref| {rel:.3e} "
          f"(tolerance {FROM_RUN_RTOL:g})", flush=True)
    if not rel <= FROM_RUN_RTOL:
        raise RuntimeError("Backmapper.from_run disagrees with the model the fold trained")
    cfg = ExperimentConfig.load(str(run / "modelparams.json"))

    # resume fold 0 to CV_EPOCHS + 1 epochs: the restored state against the file
    restored = []
    original_restore = CheckpointManager.restore

    def recording_restore(self, template, step=None):
        t = time.perf_counter()
        state, meta, step = original_restore(self, template, step)
        if state.step.device.type == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        restored.append((self.directory, step, {k: p.detach().cpu().clone()
                                                for k, p in state.params.items()},
                         state.opt_state.mu.cpu().clone(), state.opt_state.nu.cpu().clone(),
                         seconds))
        return state, meta, step

    resume_cfg = dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, nepochs=CV_EPOCHS + 1))
    CheckpointManager.restore = recording_restore
    try:
        t = time.perf_counter()
        resumed = run_cgvae.run_cv(resume_cfg, n_ensemble=CV_ENSEMBLE, nevals=CV_EVALS,
                                   graph_eval=True, resume=True, max_folds=1, device=device)
        resume_s = time.perf_counter() - t
    finally:
        CheckpointManager.restore = original_restore
    if len(restored) != 1 or restored[0][1] != CV_EPOCHS - 1:
        raise RuntimeError(f"resume restored {[(d, s) for d, s, *_ in restored]}")
    directory, step, params, mu, nu, restore_s = restored[0]
    saved = torch.load(Path(directory) / str(step) / STATE_FILE, weights_only=True)
    same = (set(params) == set(saved["params"])
            and all(torch.equal(params[k], saved["params"][k]) for k in params)
            and torch.equal(mu, saved["opt_state"]["mu"])
            and torch.equal(nu, saved["opt_state"]["nu"]))
    with open(run / "fold0" / "train_log.csv") as f:
        log_epochs = [int(line.split(",")[0]) for line in f.read().splitlines()[1:]]
    print(f"cv resume: fold 0 restored epoch {step} in {restore_s:.3f} s (parameters, mu, nu "
          f"bit-identical to the file: {same}), ran epoch {resumed[0]['epoch'] if resumed else None} in "
          f"{resume_s:.3f} s; train_log epochs {log_epochs}", flush=True)
    continued = [r["epoch"] for r in resumed] == [CV_EPOCHS]
    if not (same and continued and log_epochs == list(range(CV_EPOCHS + 1))):
        raise RuntimeError("the resumed fold did not continue from its checkpoint")

    # one fold, one epoch, of the CLI's default decoder (cross)
    cross_args = CV_RECIPE + width + depth + [
        "-logdir", str(CV_DIR / "cross"), "-max_folds", "1", "-nepochs", "1"]
    reset_counts()
    t = time.perf_counter()
    cross_rows = run_cgvae.main(cross_args)
    cross_s = time.perf_counter() - t
    cross_launches = read_counts()
    (cross_run,) = list(CV_DIR.glob("cross*"))
    check_cv_run(cross_run, 1, 1)
    expect = cv_expected_launches(width, n_frames, 1, 1, CV_EVALS, "cross")
    print(f"cv cross decoder: 1 fold x 1 epoch in {cross_s:.3f} s, test recon RMSD "
          f"{cross_rows[0]['test_all_recon_rmsd']:.4f} A, launches {cross_launches} "
          f"(expected {expect})", flush=True)
    if device == "cuda" and cross_launches != expect:
        raise RuntimeError(f"cross kernel launches {cross_launches}, expected {expect}")
    return {"cv": launches, "cv_cross": cross_launches}


def read_payload_tensors(payload: dict) -> list:
    """(name, tensor) of every tensor of a checkpoint payload, in order."""
    out = [(f"params/{k}", v) for k, v in payload["params"].items()]
    out += [(f"opt_state/{k}", v) for k, v in payload["opt_state"].items()]
    return out + [("step", payload["step"]), ("lr", payload["lr"])]


def same_bits(a: dict, b: dict) -> list:
    """Names of the tensors of payload ``a`` that ``b`` does not hold with
    the same name, order, dtype, shape and bits."""
    ta, tb = read_payload_tensors(a), read_payload_tensors(b)
    if [n for n, _ in ta] != [n for n, _ in tb]:
        return ["names or order"]
    return [n for (n, x), (_, y) in zip(ta, tb)
            if x.dtype != y.dtype or x.shape != y.shape or not torch_equal(x, y)]


def torch_equal(x, y) -> bool:
    """The same bits (a NaN equals a NaN of the same payload)."""
    import torch

    def bits(t):
        if not t.is_floating_point():
            return t
        return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])

    return bool(torch.equal(bits(x), bits(y)))


def state_round_trip(fold: Path, cfg) -> tuple:
    """Runfiles (a): the fold's latest checkpoint through
    ``train_state_to_flax``, the codec's bytes, back through the codec and
    ``train_state_from_flax``. Raises unless every param, mu, nu, count,
    step and lr comes back bit for bit and re-writing the read tree gives
    the same bytes. Returns (payload read back, metadata, step, line)."""
    from coarsegrainingvae_tpu_torch.convert import train_state_from_flax, train_state_to_flax
    from coarsegrainingvae_tpu_torch.train.checkpoint import CheckpointManager
    from coarsegrainingvae_tpu_torch.utils import flax_msgpack

    payload, meta, step = CheckpointManager(str(fold / "ckpt")).read()
    t0 = time.perf_counter()
    data = flax_msgpack.dumps(train_state_to_flax(payload, cfg))
    t1 = time.perf_counter()
    tree = flax_msgpack.loads(data)
    t2 = time.perf_counter()
    rewritten = flax_msgpack.dumps(tree) == data
    back = train_state_from_flax(tree, cfg)
    t3 = time.perf_counter()
    differ = same_bits(payload, back)
    line = (f"runfiles (a): step {step} of {fold} ({len(payload['params'])} params, "
            f"{sum(p.numel() for p in payload['params'].values())} entries, moments "
            f"{payload['opt_state']['mu'].dtype}) -> JAX's TrainState tree -> {len(data) / 1e6:.1f} MB "
            f"of flax msgpack in {t1 - t0:.3f} s, read {t2 - t1:.3f} s, back to the port "
            f"{t3 - t2:.3f} s; every tensor bit for bit: {not differ}; re-written bytes "
            f"identical: {rewritten}")
    if differ or not rewritten:
        raise RuntimeError(f"runfiles: the state round trip changed {differ[:8]} or the bytes")
    return back, meta, step, line


def copy_fold(run: Path, fold: str, dst: Path, step: int, payload=None, meta=None) -> Path:
    """A copy of ``run/fold`` under ``dst`` (modelparams.json, mapping.json
    and the checkpoint of ``step``): the checkpoint copied as it is, or
    ``payload`` written in its place."""
    from coarsegrainingvae_tpu_torch.train.checkpoint import CheckpointManager

    shutil.rmtree(dst, ignore_errors=True)
    (dst / fold / "ckpt").mkdir(parents=True)
    shutil.copy(run / "modelparams.json", dst)
    shutil.copy(run / fold / "mapping.json", dst / fold)
    src = run / fold / "ckpt"
    if payload is None:
        shutil.copytree(src / str(step), dst / fold / "ckpt" / str(step))
        if (src / f"meta_{step}.json").exists():
            shutil.copy(src / f"meta_{step}.json", dst / fold / "ckpt")
    else:
        CheckpointManager(str(dst / fold / "ckpt")).save_payload(step, payload, meta)
    return dst / fold


def serve_converted(original: Path, converted: Path, device: str) -> tuple:
    """Runfiles (b): one request (4 CG frames x RUNFILES_SAMPLES samples,
    seed 3) served by ``Backmapper.from_run`` of the converted fold and of
    the original; raises unless bit for bit. Returns (launches of the
    converted fold's request, line)."""
    import numpy as np

    from coarsegrainingvae_tpu_torch.data.dataset import _segment_mean_np
    from coarsegrainingvae_tpu_torch.serve import Backmapper

    def load(fold: Path):
        return Backmapper.from_run(str(fold.parent / "modelparams.json"), str(fold),
                                   device=device)

    conv, orig = load(converted), load(original)
    mapping = np.asarray(json.loads((original / "mapping.json").read_text()))
    cg = _segment_mean_np(np.repeat(orig.ref_xyz[None], 4, 0)
                          + np.random.default_rng(0).normal(size=(4,) + orig.ref_xyz.shape) * 0.2,
                          mapping, orig.cfg.model.n_cgs)
    reset_counts()
    t = time.perf_counter()
    got = conv.backmap(cg, n_samples=RUNFILES_SAMPLES, seed=3)
    seconds = time.perf_counter() - t
    launches = read_counts()
    want = orig.backmap(cg, n_samples=RUNFILES_SAMPLES, seed=3)
    same = got.shape == want.shape and bool(np.array_equal(got, want))
    line = (f"runfiles (b): from_run of the converted fold served {got.shape} in {seconds:.3f} s; "
            f"bit for bit the original fold's: {same}; launches {launches}")
    if not (same and np.isfinite(got).all()):
        raise RuntimeError("runfiles: the converted fold serves other bits than the original")
    return launches, line


def resume_one_epoch(fold: Path, device: str) -> tuple:
    """``Trainer.fit(resume=True)`` of ``fold`` (a run directory's fold k)
    for one epoch past its latest checkpoint, on the fold's own data as
    ``run_cv`` builds it. Returns (parameters after, launches, seconds)."""
    import numpy as np
    import torch

    from coarsegrainingvae_tpu_torch.cli.run_cgvae import fold_datasets
    from coarsegrainingvae_tpu_torch.config import ExperimentConfig
    from coarsegrainingvae_tpu_torch.data.dataset import kfold_indices
    from coarsegrainingvae_tpu_torch.data.proteins import load_frames
    from coarsegrainingvae_tpu_torch.models.cgvae import build_flagship_model
    from coarsegrainingvae_tpu_torch.train.checkpoint import CheckpointManager
    from coarsegrainingvae_tpu_torch.train.trainer import Trainer

    cfg = ExperimentConfig.load(str(fold.parent / "modelparams.json"))
    k = int(fold.name[len("fold"):])
    mapping = np.asarray(json.loads((fold / "mapping.json").read_text()), np.int32)
    z, frames, bonds = load_frames(cfg.data.dataset, cfg.data.ndata, seed=cfg.data.seed,
                                   device=device)
    train_idx, test_idx = kfold_indices(frames.shape[0], cfg.data.nsplits, cfg.data.seed)[k]
    ds_tr, ds_val, _ = fold_datasets(cfg, mapping, z, frames, bonds, train_idx, test_idx)
    model = build_flagship_model(cfg.model,
                                 generator=torch.Generator().manual_seed(cfg.data.seed))
    trainer = Trainer(model, cfg, device=device)
    state = trainer.init_state(ds_tr.batch(np.arange(min(cfg.data.batch_size, len(ds_tr)))))
    ckpt = CheckpointManager(str(fold / "ckpt"))
    step = ckpt.latest_step()
    reset_counts()
    t = time.perf_counter()
    state, history = trainer.fit(state, ds_tr, ds_val, nepochs=step + 2, ckpt=ckpt, resume=True)
    if device == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    launches = read_counts()
    if [h["epoch"] for h in history] != list(range(step + 2)):
        raise RuntimeError(f"runfiles: resumed epochs {[h['epoch'] for h in history]}")
    return {n: p.detach().cpu().clone() for n, p in state.params.items()}, launches, seconds


def add_counts(*counts: dict) -> dict:
    out = defaultdict(int)
    for c in counts:
        for k, v in c.items():
            out[k] += v
    return dict(out)


def runfiles_phase(device: str = "cuda", run: Path = None) -> dict:
    """The JAX package's run files on the fold the cv phase trained (its
    ``run``, fold 0 at full width by default): (a) the train state through
    JAX's tree and the flax msgpack codec and back, bit for bit; (b)
    ``Backmapper.from_run`` of a copy of the fold holding (a)'s state
    against the original fold, one request bit for bit; (c) one epoch of
    ``Trainer.fit(resume=True)`` from (a)'s state and from the original,
    the parameters after bit for bit. Counted as path ``runfiles``: the
    converted fold's request (kernels 1 and 3) and resumed epoch (1-4).
    Raises on any failed check."""
    from coarsegrainingvae_tpu_torch.config import ExperimentConfig

    t_phase = time.perf_counter()
    if run is None:
        (run,) = [p for p in CV_DIR.iterdir() if p.name.startswith("run")]
    cfg = ExperimentConfig.load(str(run / "modelparams.json"))
    back, meta, step, line = state_round_trip(run / "fold0", cfg)
    print(line, flush=True)
    original = copy_fold(run, "fold0", RUNFILES_DIR / "original", step)
    converted = copy_fold(run, "fold0", RUNFILES_DIR / "converted", step, back, meta)
    served, line = serve_converted(original, converted, device)
    print(line, flush=True)
    after_conv, resumed, conv_s = resume_one_epoch(converted, device)
    after_orig, _, orig_s = resume_one_epoch(original, device)
    same = set(after_conv) == set(after_orig) and all(
        torch_equal(after_conv[k], after_orig[k]) for k in after_conv)
    print(f"runfiles (c): fit(resume=True) one epoch past step {step}, from the converted state "
          f"in {conv_s:.3f} s and from the original in {orig_s:.3f} s; parameters after bit for "
          f"bit: {same}; launches {resumed}", flush=True)
    if not same:
        raise RuntimeError("runfiles: the epoch resumed from the converted state differs")
    total = add_counts(served, resumed)
    print(f"runfiles: {time.perf_counter() - t_phase:.1f} s for the phase; launches {total}",
          flush=True)
    return {"runfiles": total}


def recipe_flags(name: str, directory: Path = STERIC_RECIPES) -> list:
    """run_cgvae flags of a committed recipe (``<name>_modelparams.json`` in
    ``directory``): its model, data and train fields, depth flags left to
    the caller."""
    cfg = json.loads((directory / f"{name}_modelparams.json").read_text())
    m, d, t = cfg["model"], cfg["data"], cfg["train"]
    flags = ["-n_cgs", m["n_cgs"], "-n_basis", m["n_basis"], "-n_rbf", m["n_rbf"],
             "-atom_cutoff", m["atom_cutoff"], "-cg_cutoff", m["cg_cutoff"],
             "-enc_nconv", m["enc_nconv"], "-dec_nconv", m["dec_nconv"],
             "-activation", m["activation"], "--dec_type", m["dec_type"],
             "-dataset", d["dataset"], "-batch_size", d["batch_size"],
             "-cg_method", d["cg_method"], "-edgeorder", d["edgeorder"],
             "-nsplits", d["nsplits"], "-seed", d["seed"], "-lr", t["lr"], "-beta", t["beta"],
             "-gamma", t["gamma"], "-zeta", t["zeta"], "-steric_margin", t["steric_margin"],
             "-zeta_warmup", t["zeta_warmup"], "-patience", t["patience"],
             "-factor", t["lr_factor"], "-lr_patience", t["lr_patience"],
             "-min_lr", t["min_lr"], "-loss_skip_factor", t["loss_skip_factor"],
             "--adam_dtype", t["adam_moment_dtype"]]
    flags = [str(v) for v in flags]
    for flag, on in (("--h_project_eval", m.get("h_project_eval")),
                     ("--h_project", m.get("h_project")), ("--det", m.get("det")),
                     ("--sparse", m.get("sparse")), ("--degree_norm", m.get("degree_norm")),
                     ("--steric_data_margin", t.get("steric_data_margin"))):
        if on:
            flags.append(flag)
    return flags


def recipe_cfg(name: str, batch_size: int, **train_kw):
    """A committed recipe's ExperimentConfig at ``batch_size``, with
    ``train_kw`` replaced."""
    import dataclasses

    from coarsegrainingvae_tpu_torch.config import ExperimentConfig

    cfg = ExperimentConfig.load(str(STERIC_RECIPES / f"{name}_modelparams.json"))
    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, batch_size=batch_size),
        train=dataclasses.replace(cfg.train, **train_kw))


def fold_from_run(run: Path, trained, device: str, sparse: bool = False) -> tuple:
    """``Backmapper.from_run`` of fold 0 against the in-memory model the
    fold trained, with the bonds and reference frame from_run reads: (max
    |err| / max |ref| of 4 frames x CV_ENSEMBLE samples, seconds to load)."""
    import numpy as np

    from coarsegrainingvae_tpu_torch.config import ExperimentConfig
    from coarsegrainingvae_tpu_torch.data.dataset import _segment_mean_np
    from coarsegrainingvae_tpu_torch.serve import Backmapper

    t = time.perf_counter()
    bm = Backmapper.from_run(str(run / "modelparams.json"), str(run / "fold0"), sparse=sparse,
                             device=device)
    load_s = time.perf_counter() - t
    cfg = ExperimentConfig.load(str(run / "modelparams.json"))
    mapping = np.asarray(json.loads((run / "fold0" / "mapping.json").read_text()))
    ref = Backmapper(trained.model, mapping, bm.z, cfg, device=device, bonds=bm.bonds,
                     ref_xyz=bm.ref_xyz)
    cg = _segment_mean_np(np.repeat(bm.ref_xyz[None], 4, 0)
                          + np.random.default_rng(0).normal(size=(4,) + bm.ref_xyz.shape) * 0.2,
                          mapping, cfg.model.n_cgs)
    got = bm.backmap(cg, n_samples=CV_ENSEMBLE, seed=3)
    want = ref.backmap(cg, n_samples=CV_ENSEMBLE, seed=3)
    if got.shape != want.shape or not np.isfinite(got).all():
        raise RuntimeError(f"from_run served {got.shape}, want {want.shape}, or not finite")
    return float(np.abs(got - want).max() / np.abs(want).max()), load_s


def cli_fold(args: list, label: str, dec_type: str, width: list, n_frames: int,
             evals: int, epochs: int, sparse: bool = False, device: str = "cuda") -> dict:
    """One fold of ``run_cgvae.main(args)`` on ``device``, its artifacts
    checked, its launches against ``cv_expected_launches`` on the card (all
    0 for the sparse model, which runs no kernel), and fold 0 served by
    ``from_run`` with 0 difference from the model it trained. Returns the
    launches. The CPU and a small width rehearse its control flow."""
    import torch

    from coarsegrainingvae_tpu_torch.cli import run_cgvae
    from coarsegrainingvae_tpu_torch.train.trainer import Trainer

    trained = []

    class RecordingTrainer(Trainer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            trained.append(self)

    logdir = CV_DIR / label
    run_cgvae.Trainer = RecordingTrainer
    try:
        reset_counts()
        t = time.perf_counter()
        rows = run_cgvae.main(args + ["-logdir", str(logdir), "-max_folds", "1",
                                      "-nepochs", str(epochs), "--device", device])
        wall = time.perf_counter() - t
        launches = read_counts()
    finally:
        run_cgvae.Trainer = Trainer
    (run,) = list(CV_DIR.glob(f"{label}*"))
    check_cv_run(run, 1, epochs)
    expect = (dict.fromkeys(launches, 0) if sparse else
              cv_expected_launches(width, n_frames, 1, epochs, evals, dec_type))
    (tr,) = trained
    rel, _ = fold_from_run(run, tr, device, sparse=sparse)
    print(f"{label}: run_cgvae 1 fold x {epochs} epochs in {wall:.3f} s ({type(tr.model).__name__}"
          f", steric tables {tr.steric_tables is not None}); test recon RMSD "
          f"{rows[0]['test_all_recon_rmsd']:.4f} A, sample heavy valid "
          f"{rows[0]['sample_heavy_valid_ratio']}; launches {launches} (expected {expect}); "
          f"from_run vs the in-memory model max|err|/max|ref| {rel:.3e}", flush=True)
    if device == "cuda" and launches != expect:
        raise RuntimeError(f"{label} kernel launches {launches}, expected {expect}")
    if rel != 0.0:
        raise RuntimeError(f"{label}: from_run disagrees with the model the fold trained")
    del trained, tr
    if device == "cuda":
        torch.cuda.empty_cache()
    return launches


def steric(dense: dict) -> dict:
    """The steric recipes. The dip_full_c6_hprojecteval step (zeta 100,
    h_project_eval; zeta_warmup cut to STERIC_WARMUP): one f32 step card vs
    CPU mid-ramp, an eager and a captured epoch across the ramp's end bit
    for bit, ms/step captured at batch 128 and 32 beside the zeta-0 step
    of the captured phase; then run_cgvae with the dip_full_z100 flags
    plus --h_project_eval, and the chig_full_z200w recipe at full width,
    each one fold cut in depth, read back by from_run. Raises on any
    failed check."""
    import dataclasses

    import numpy as np
    import torch

    from coarsegrainingvae_tpu_torch.data.proteins import save_npz_traj
    from coarsegrainingvae_tpu_torch.data.synthetic import synthetic_peptide
    from coarsegrainingvae_tpu_torch.models.dense_cgvae import DenseCGVAE
    from coarsegrainingvae_tpu_torch.train.losses import build_steric_tables
    from coarsegrainingvae_tpu_torch.train.trainer import Trainer

    name = "dip_full_c6_hprojecteval"
    ds, dataset, z, bonds = dipeptide_device_data()
    base = recipe_cfg(name, 8)
    tables = build_steric_tables(z, bonds, margin=base.train.steric_margin)
    print(f"steric: recipe {name} (zeta {base.train.zeta}, h_project_eval "
          f"{base.model.h_project_eval}), zeta_warmup cut from {base.train.zeta_warmup} to "
          f"{STERIC_WARMUP} so that a {CAPTURE_STEPS}-step epoch crosses the ramp's end; "
          f"{int(tables[1].sum())} nonbonded pairs in the tables", flush=True)
    cfg32 = recipe_cfg(name, 8, zeta_warmup=STERIC_WARMUP)
    cfg32 = dataclasses.replace(cfg32, model=dataclasses.replace(
        cfg32.model, compute_dtype="float32", det=True))
    grad_err, param_err = f32_step_card_vs_cpu(ds, cfg32, tables=tables,
                                               at_step=STERIC_WARMUP // 2)
    print(f"steric f32 step card vs CPU (batch 8, ramp at 0.5): every gradient "
          f"max|err|/max|ref| {grad_err:.3e}, every updated parameter {param_err:.3e} "
          f"(tolerance {TRAIN_RTOL:g})", flush=True)
    if not max(grad_err, param_err) <= TRAIN_RTOL:
        raise RuntimeError("the f32 steric step on the card disagrees with the CPU")

    total = dict.fromkeys(DENSE_PER_STEP, 0)
    for bs in CAPTURE_BATCHES:
        cfg = recipe_cfg(name, bs, zeta_warmup=STERIC_WARMUP)
        tr = Trainer(DenseCGVAE(cfg.model, generator=torch.Generator().manual_seed(0)), cfg,
                     device="cuda", steric_tables=tables)
        state = tr.init_state(ds.batch(np.arange(bs)))
        dds_long = dataset(bs * CAPTURE_STEPS)
        if bs == CAPTURE_BATCHES[0]:
            eager_equals_captured(tr, state, ((CAPTURE_STEPS, dds_long),), bs, "steric ")
        state, timings, launches, peak = timed_epochs(
            tr, state, dds_long, dataset(bs * PROFILE_STEPS), bs, DENSE_PER_STEP, "steric ",
            kinds=("captured", "captured"))
        zeta0, zeta0_peak = dense[bs]
        print(f"steric vs zeta 0, batch {bs}, captured: {', '.join(f'{x:.3f}' for x in timings['captured'])}"
              f" vs {', '.join(f'{x:.3f}' for x in zeta0)} ms/step (the captured phase, this "
              f"call); peak allocated {peak:.3f} vs {zeta0_peak:.3f} GB", flush=True)
        for k in total:
            total[k] += launches[k]
        del tr, state, dds_long
        torch.cuda.empty_cache()

    # the recipes through the CLI, cut in depth: the CV phase's dipeptide
    # frames, and chignolin frames relaxed on the card
    depth = ["-ndata", str(CV_FRAMES), "-n_ensemble", str(CV_ENSEMBLE), "-nevals",
             str(CV_EVALS), "--graph_eval"]
    dip = recipe_flags("dip_full_z100") + ["--h_project_eval"]
    out = {"steric": total,
           "steric_cv": cli_fold(dip + depth, "steric_dip", "pseudo", dip, CV_FRAMES,
                                 CV_EVALS, CV_EPOCHS)}
    t = time.perf_counter()
    zc, frames, bonds_c = synthetic_peptide("chignolin", n_frames=CHIG_FRAMES, seed=0,
                                            device="cuda")
    save_npz_traj(str(OUT_DIR / "cv_data" / "chignolin.npz"), zc, frames, bonds_c)
    print(f"chignolin data: {CHIG_FRAMES} synthetic frames of {zc.shape[0]} atoms relaxed on "
          f"the card in {time.perf_counter() - t:.3f} s", flush=True)
    chig = recipe_flags("chig_full_z200w")
    out["chig"] = cli_fold(chig + ["-ndata", str(CHIG_FRAMES), "-n_ensemble", "4", "-nevals",
                                   str(CHIG_EVALS), "--graph_eval"],
                           "chig", "cross", chig, CHIG_FRAMES, CHIG_EVALS, 2)
    return out


def sparse(dense: dict) -> dict:
    """The sparse CGequiVAE at bench.py's width, pseudo decoder then
    pseudo2: one f32 step card vs CPU, an eager and a captured epoch bit
    for bit, ms/step, device busy and peak memory captured at batch 128 and
    32 beside the dense model's (the captured phase, this call), no kernel
    launched; then run_cgvae --sparse cut in depth and from_run(sparse=True).
    Raises on any failed check."""
    import dataclasses

    import numpy as np
    import torch

    from coarsegrainingvae_tpu_torch.models.cgvae import CGequiVAE
    from coarsegrainingvae_tpu_torch.train.trainer import Trainer

    ds, dataset, _, _ = dipeptide_device_data()
    none = dict.fromkeys(DENSE_PER_STEP, 0)
    total = dict(none)
    for dec_type in ("pseudo", "pseudo2"):
        cfg32 = train_cfg(8, dec_type=dec_type, sparse=True, compute_dtype="float32", det=True)
        cfg32 = dataclasses.replace(cfg32, train=dataclasses.replace(cfg32.train, lr=3.2e-4))
        grad_err, param_err = f32_step_card_vs_cpu(ds, cfg32, build=CGequiVAE)
        print(f"sparse {dec_type} f32 step card vs CPU (batch 8): every gradient "
              f"max|err|/max|ref| {grad_err:.3e}, every updated parameter {param_err:.3e} "
              f"(tolerance {TRAIN_RTOL:g})", flush=True)
        if not max(grad_err, param_err) <= TRAIN_RTOL:
            raise RuntimeError(f"the f32 sparse {dec_type} step on the card disagrees with the CPU")
        for bs in CAPTURE_BATCHES:
            cfg = train_cfg(bs, dec_type=dec_type, sparse=True)
            tr = Trainer(CGequiVAE(cfg.model, generator=torch.Generator().manual_seed(0)), cfg,
                         device="cuda")
            state = tr.init_state(ds.batch(np.arange(bs)))
            if bs == CAPTURE_BATCHES[0]:
                n_params = sum(p.numel() for p in state.params.values())
                print(f"sparse {dec_type}: {n_params} parameters; atom edges per batch "
                      f"{int(ds.nbr_mask[:bs].sum())}, CG edges {int(ds.cg_nbr_mask[:bs].sum())}",
                      flush=True)
                eager_equals_captured(tr, state, ((1, dataset(bs)), (SPARSE_STEPS, dataset(
                    bs * SPARSE_STEPS))), bs, f"sparse {dec_type} ")
            state, timings, launches, peak = timed_epochs(
                tr, state, dataset(bs * SPARSE_STEPS), dataset(bs * PROFILE_STEPS), bs, none,
                f"sparse {dec_type} ", kinds=("captured", "captured"),
                profile_name=f"sparse_{dec_type}_profile_b{bs}.txt")
            for k in total:
                total[k] += launches[k]
            dense_ms, dense_peak = dense[bs]
            print(f"sparse {dec_type} vs dense, batch {bs}, captured: "
                  f"{', '.join(f'{x:.3f}' for x in timings['captured'])} vs "
                  f"{', '.join(f'{x:.3f}' for x in dense_ms)} ms/step; peak allocated "
                  f"{peak:.3f} vs {dense_peak:.3f} GB", flush=True)
            del tr, state
            torch.cuda.empty_cache()
    args = CV_RECIPE + CV_WIDTH + ["-ndata", str(CV_FRAMES), "-nsplits", str(CV_SPLITS),
                                   "-n_ensemble", str(CV_ENSEMBLE), "-nevals", str(CV_EVALS),
                                   "--dec_type", "pseudo", "--sparse"]
    return {"sparse": total,
            "sparse_cv": cli_fold(args, "sparse_cv", "pseudo", CV_WIDTH, CV_FRAMES, CV_EVALS,
                                  CV_EPOCHS, sparse=True)}


def covid_frames(device: str = "cuda", n_frames: int = COVID_FRAMES) -> tuple:
    """The covid stand-in's frames as ``run_cgvae`` loads them (the
    synthetic generator, relaxed on ``device``, cached under the JAX
    package's key): ((z, frames, bonds), seconds)."""
    from coarsegrainingvae_tpu_torch.data.proteins import load_frames

    t = time.perf_counter()
    out = load_frames("covid", n_frames, seed=COVID_SEED, device=device)
    return out, time.perf_counter() - t


def _rows_by_receiver(edges, mask):
    import numpy as np

    e = edges[mask]
    return e[np.lexsort((e[:, 1], e[:, 0]))]


def native_phase(device: str = "cuda", covid_n_frames: int = COVID_FRAMES,
                 dense_frames: int = 2) -> None:
    """The host C++ routes on this machine: both libraries built with g++,
    the cell list against the dense numpy path (the same mask, the same
    edges per receiver) at N 300 and at the covid stand-in's N, the bond
    diff's metrics against the dense ones past 1,500 atoms, and each
    route's host seconds at the covid N against its dense version's.
    Synthesises the covid frames (cached for the covid phase) and prints
    their synthesis seconds. Raises on any disagreement."""
    import numpy as np

    from coarsegrainingvae_tpu_torch.data import neighbors
    from coarsegrainingvae_tpu_torch.eval import metrics
    from coarsegrainingvae_tpu_torch.native import bond_diff, build, cell_list

    t = time.perf_counter()
    cell_list._lib()
    bond_diff._lib()
    print(f"native: both libraries ready in {time.perf_counter() - t:.3f} s (g++: "
          f"{', '.join(f'{k} {v:.3f} s' for k, v in build.BUILD_SECONDS.items()) or 'cached'}) "
          f"in {build.BUILD_DIR}", flush=True)

    def check_cell_list(frames, cutoff, label):
        t = time.perf_counter()
        e, m = cell_list.radius_graph_frames(frames, cutoff)
        cell_s = time.perf_counter() - t
        sub = frames[:dense_frames]
        t = time.perf_counter()
        de, dm = neighbors.radius_graph_frames_dense(sub, cutoff, chunk=1)
        dense_s = time.perf_counter() - t
        same = (np.array_equal(m[:dense_frames, :dm.shape[1]], dm)
                and not m[:dense_frames, dm.shape[1]:].any()
                and all(np.array_equal(_rows_by_receiver(e[k], m[k]),
                                       _rows_by_receiver(de[k], dm[k]))
                        for k in range(sub.shape[0])))
        print(f"native cell list, {label}: {frames.shape[0]} frames x {frames.shape[1]} atoms, "
              f"cutoff {cutoff}: edges per frame {m.sum(1).tolist()}, {cell_s:.3f} s for all "
              f"frames; the dense path {dense_s:.3f} s for {sub.shape[0]}; mask and edges per "
              f"receiver equal: {same}", flush=True)
        if not same:
            raise RuntimeError(f"the cell list disagrees with the dense path ({label})")
        return m.sum(1)

    rng = np.random.default_rng(0)
    frames = (rng.normal(size=(NATIVE_FRAMES, NATIVE_ATOMS, 3)) * 8.0).astype(np.float32)
    check_cell_list(frames, NATIVE_CUTOFF, f"N {NATIVE_ATOMS}")
    (z, frames, _), synth_s = covid_frames(device, covid_n_frames)
    print(f"native: {covid_n_frames} covid stand-in frames ({z.shape[0]} atoms) synthesised "
          f"and relaxed on {device} in {synth_s:.3f} s", flush=True)
    atom_cutoff = json.loads((COVID_RECIPE / "covid2_modelparams.json").read_text()
                             )["model"]["atom_cutoff"]
    check_cell_list(frames, atom_cutoff, "covid")

    n = min(BOND_DIFF_ATOMS, z.shape[0])
    for label, zz, ref, n_dense in (("N %d" % n, z[:n], frames[0, :n], BOND_DIFF_SAMPLES),
                                    ("covid", z, frames[0], 1)):
        gen = ref[None] + rng.normal(
            scale=np.linspace(0.0, 0.6, BOND_DIFF_SAMPLES)[:, None, None],
            size=(BOND_DIFF_SAMPLES,) + ref.shape).astype(np.float32)
        calls = bond_diff.calls
        t = time.perf_counter()
        cell = metrics.evaluate_samples(ref, gen, zz, large_n_threshold=BOND_DIFF_THRESHOLD)
        cell_s = time.perf_counter() - t
        if bond_diff.calls != calls + 2:
            raise RuntimeError(f"evaluate_samples at N {zz.shape[0]} did not take the bond diff")
        t = time.perf_counter()
        dense = metrics.evaluate_samples(ref, gen[:n_dense], zz, large_n_threshold=10**9)
        dense_s = time.perf_counter() - t
        want = metrics.evaluate_samples(ref, gen[:n_dense], zz,
                                        large_n_threshold=BOND_DIFF_THRESHOLD)
        keys = ("valid_ratio", "valid_allatom_ratio", "graph_val_ratio",
                "graph_allatom_val_ratio", "graph_edit_ratio", "graph_allatom_edit_ratio")
        same = all(np.isclose(want[k], dense[k], rtol=1e-9, atol=0) for k in keys)
        print(f"native bond diff, {label}: {BOND_DIFF_SAMPLES} samples in {cell_s:.3f} s "
              f"(valid {cell['valid_allatom_ratio']}, edit ratio "
              f"{cell['graph_allatom_edit_ratio']:.4f}); the dense metrics {dense_s:.3f} s for "
              f"{n_dense}; equal on those: {same}", flush=True)
        if not same:
            raise RuntimeError(f"the bond diff disagrees with the dense metrics ({label})")


def pcn_flags(name: str) -> list:
    """run_pcn flags of a committed PCN recipe (``<name>_modelparams.json``),
    its logdir and data source left out."""
    return json_recipe_flags(PCN_RECIPES / f"{name}_modelparams.json",
                             skip=("logdir", "data_pkl"), long=("dec_type",))


def check_params_file(path: Path, cfg, model, forward) -> None:
    """A run's ``params.msgpack``: its bytes survive the port's codec read
    then write; ``convert.load_params`` maps it (every leaf consumed, or it
    raises) onto the fresh ``model`` (strict load, on its device), and
    ``forward(model)`` is finite."""
    import torch

    from coarsegrainingvae_tpu_torch.convert import load_params
    from coarsegrainingvae_tpu_torch.utils import flax_msgpack

    data = path.read_bytes()
    if flax_msgpack.dumps(flax_msgpack.loads(data)) != data:
        raise RuntimeError(f"{path}: the bytes changed through the codec")
    model.load_state_dict(load_params(str(path), cfg))
    with torch.no_grad():
        out = forward(model)
    if not all(torch.isfinite(t).all() for t in out):
        raise RuntimeError(f"{path}: the loaded model's forward is not finite")


def check_pcn_run(run: Path, a, n_epochs: int, items, device: str) -> list:
    """The run's artifacts: every file, train_log.csv with one row per
    epoch, test_results.csv with the JAX package's columns and finite rows,
    params.msgpack read into a fresh model on ``device`` (its forward on
    the first two proteins ``items``, finite). Returns the test rows."""
    import csv
    import math

    import torch

    from coarsegrainingvae_tpu_torch.cli.run_pcn import model_config
    from coarsegrainingvae_tpu_torch.data.sidechain import build_pcn_dataset
    from coarsegrainingvae_tpu_torch.models.cgvae import PCN, StochasticPCN
    from coarsegrainingvae_tpu_torch.models.cgvae import flatten_batch

    stochastic = a.stochastic
    names = ["modelparams.json", "train_log.csv", "test_results.csv", "params.msgpack"] + [
        f"recon_{i}.pdb" for i in range(a.n_dump)]
    missing = [n for n in names if not (run / n).is_file()]
    if missing:
        raise RuntimeError(f"{run}: missing {missing}")
    with open(run / "train_log.csv", newline="") as f:
        log = list(csv.DictReader(f))
    with open(run / "test_results.csv", newline="") as f:
        reader = csv.DictReader(f)
        rows = list(reader)
    header = ["protein", "seq_len", "rmsd", "drmsd", "ged", "inference_s"] + (
        ["sample_best_rmsd", "sample_mean_rmsd"] if stochastic else [])
    if reader.fieldnames != header or len(log) != n_epochs:
        raise RuntimeError(f"{run}: test columns {reader.fieldnames}, {len(log)} epochs logged")
    bad = [(r["protein"], k) for r in rows for k, v in r.items() if not math.isfinite(float(v))]
    if bad or not rows:
        raise RuntimeError(f"{run}: test_results.csv has values that are not finite: {bad}")
    cfg = model_config(a)
    model = (StochasticPCN if stochastic else PCN)(cfg).to(device)
    batch, cam, _, _ = next(build_pcn_dataset(items[:2], cg_cutoff=a.cutoff).iter_batches(2))
    g = flatten_batch(batch.to(device))
    cam = torch.as_tensor(cam, dtype=torch.bool, device=device)
    check_params_file(run / "params.msgpack", cfg, model,
                      lambda m: (m(g, cam, generator=torch.Generator(device).manual_seed(0))
                                 if stochastic else m(g, cam)).xyz_recon[None])
    return rows


def worst_rel(got, want) -> float:
    """max over tensors of max|got - want| / max|want|."""
    return max((x.detach().cpu().double() - y.detach().cpu().double()).abs().max().item()
               / max(y.detach().abs().max().item(), 1e-30) for x, y in zip(got, want))


def pcn_step_grads(device, batch, cam, quads, qmask, cfg, kw, aux, step, dtype):
    """One PCN step's loss and gradients at ``dtype`` ("float32" or
    "float64": model, coordinates and arithmetic) on ``device``, from the
    weights of seed 1: (trainer, state, loss, gradients)."""
    import dataclasses

    import torch

    from coarsegrainingvae_tpu_torch.models.cgvae import PCN
    from coarsegrainingvae_tpu_torch.train.pcn_trainer import PCNTrainer

    model = PCN(dataclasses.replace(cfg, compute_dtype=dtype),
                generator=torch.Generator().manual_seed(1))
    if dtype == "float64":
        model = model.double()
        batch = dataclasses.replace(batch, xyz=batch.xyz.double(), cg_xyz=batch.cg_xyz.double())
    tr = PCNTrainer(model, device=device, **kw)
    state = tr.init_state()
    b, c, q, qm = tr._inputs(batch, cam, quads, qmask)
    loss, _ = tr._loss(b, c, q, qm, aux, tr.zeta_at(step))
    params = list(state.params.values())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
    return tr, state, loss.detach(), grads


def step_card_vs_cpu(card, ref) -> tuple:
    """(worst gradient error, worst updated-parameter error) of a step on
    the card against the same step on the CPU; the CPU's update applies
    its own optimizer to the card's gradients. Raises if the guard
    rejects either step."""
    from coarsegrainingvae_tpu_torch.train.trainer import guarded_update

    (tr, state, loss, grads), (tr_ref, state_ref, _, grads_ref) = card, ref
    grad_err = worst_rel(grads, grads_ref)
    _, ok = guarded_update(tr.tx, list(state.params.values()), grads, loss, state.opt_state,
                           state.lr, float("inf"))
    _, ok_ref = guarded_update(tr_ref.tx, list(state_ref.params.values()),
                               [g.cpu() for g in grads], loss.cpu(), state_ref.opt_state,
                               state_ref.lr, float("inf"))
    if not (bool(ok) and bool(ok_ref)):
        raise RuntimeError("the skip guard rejected a PCN check step")
    return grad_err, worst_rel(state.params.values(), list(state_ref.params.values()))


def pcn_phase(device: str = "cuda", ndata: int = PCN_NDATA, epochs: int = PCN_EPOCHS,
              steps: int = PCN_STEPS, width: tuple = ()) -> dict:
    """PCN and StochasticPCN through ``cli.run_pcn`` with the p7 and p7s
    recipes' flags (full width, cut in depth), every artifact checked; then
    the p7 step on the recipe's batch of 8: card vs CPU (gradients, then
    the update) at f32 on the loss's smooth terms and at float64 on the
    whole recipe, and at f32 on the whole recipe within the f32
    conditioning the CPU shows; two card steps from one state bit for
    bit, ms/step, device busy, host launch calls and peak memory. PCN runs
    none of the four kernels (its sums are segment sums): their counters
    stay 0. Raises on any failed check. ``width`` flags (given after the
    recipe's) and the depth arguments let the CPU rehearse it."""
    import dataclasses

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from coarsegrainingvae_tpu_torch.cli import run_pcn
    from coarsegrainingvae_tpu_torch.data.sidechain import build_pcn_dataset
    from coarsegrainingvae_tpu_torch.models.cgvae import PCN
    from coarsegrainingvae_tpu_torch.train.pcn_trainer import PCNTrainer
    from coarsegrainingvae_tpu_torch.utils import profiling

    cuda = device == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    shutil.rmtree(PCN_DIR, ignore_errors=True)
    loaded = {}
    real_load = run_pcn.load_protein_items
    paths = {}
    for name in ("p7", "p7s"):
        def timed_load(*args, _name=name, **kwargs):
            sync()
            t = time.perf_counter()
            items = real_load(*args, **kwargs)
            sync()
            loaded[_name] = (items, time.perf_counter() - t)
            return items

        flags = pcn_flags(name) + list(width) + ["-ndata", str(ndata), "-nepochs", str(epochs)]
        a = run_pcn.build_parser().parse_args(flags)
        run_pcn.load_protein_items = timed_load
        try:
            reset_counts()
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            rows = run_pcn.main(flags + ["-logdir", str(PCN_DIR / name), "--device", device])
            wall = time.perf_counter() - t
            paths[f"pcn_{name}"] = read_counts()
        finally:
            run_pcn.load_protein_items = real_load
        (run,) = list(PCN_DIR.glob(f"{name}_*"))
        items, synth_s = loaded[name]
        check_pcn_run(run, a, epochs, items, device)
        # epoch_time_s, the 11th column with or without the KL columns after it
        epoch_s = [round(float(line.split(",")[10]), 3)
                   for line in (run / "train_log.csv").read_text().splitlines()[1:]]
        peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else float("nan")
        extra = (f", best-of-{a.n_ensemble} sample RMSD "
                 f"{np.mean([r['sample_best_rmsd'] for r in rows]):.4f} A" if a.stochastic else "")
        print(f"pcn {name}: run_pcn {ndata} proteins x {epochs} epochs in {wall:.3f} s "
              f"(n_basis {a.n_basis}, dec {a.dec_nconv}, {a.dec_type}, batch {a.batch_size}); "
              f"synthetic_protein(well_posed=True) on {device} {synth_s:.3f} s for {len(items)} "
              f"proteins ({synth_s / len(items):.3f} s each); epochs {epoch_s} s; test RMSD "
              f"mean {np.mean([r['rmsd'] for r in rows]):.4f} A over {len(rows)} proteins"
              f"{extra}; peak allocated {peak:.3f} GB; launches {paths[f'pcn_{name}']}",
              flush=True)
        if cuda and any(paths[f"pcn_{name}"].values()):
            raise RuntimeError(f"pcn {name} launched a kernel: {paths[f'pcn_{name}']}")

    # the p7 step on its own
    a = run_pcn.build_parser().parse_args(pcn_flags("p7") + list(width))
    items = loaded["p7"][0]
    ds = build_pcn_dataset(items, cg_cutoff=a.cutoff)
    bs = a.batch_size
    cfg = run_pcn.model_config(a)
    kw = dict(gamma=a.gamma, kappa=a.kappa, lr=a.lr, grad_clip=a.grad_clip, seed=a.seed,
              aux_warmup=a.aux_warmup, zeta=a.zeta, steric_margin=a.steric_margin,
              zeta_warmup=a.zeta_warmup, bond_project=a.bond_project)
    aux = 1.0 / a.aux_warmup if a.aux_warmup else 1.0
    batch, cam, quads, qmask = next(ds.iter_batches(bs))
    n_atoms = int(batch.atom_mask.sum())
    print(f"pcn step batch: {bs} proteins, {n_atoms} atoms (padded {batch.z.numel()}), "
          f"{int(batch.cg_mask.sum())} residues, {int(batch.cg_nbr_mask.sum())} C-alpha edges, "
          f"{int(batch.bond_mask.sum())} bonds", flush=True)

    # card vs CPU: gradients, then the CPU's update from the card's gradients
    # (Adam's first step turns rounding-level gradient differences of
    # entries near zero into lr-sized updates). The recipe's loss at random
    # weights is ill-conditioned in float32: its dihedral term wraps at
    # +-pi (atan2) and the rooted projection divides by decoded bond
    # lengths near zero, so f32 rounding alone moves some gradients by
    # 1e-3-1e-1. The 1e-4 gate holds the f32 step of the loss's smooth
    # terms (recon, graph, steric mid-ramp) and the float64 step of the
    # whole recipe. The whole recipe's f32 gradients are held to that
    # conditioning, as measured in this run on the CPU ("own": the CPU's
    # f32 against its float64): the card's f32 no farther from the CPU's
    # float64 than max(2 * own, 1e-4), and from the CPU's f32 than
    # max(own, 1e-4).
    smooth = dict(kw, kappa=0.0, bond_project=False)
    at = a.zeta_warmup // 2
    cpu64 = pcn_step_grads("cpu", batch, cam, quads, qmask, cfg, kw, aux, at, "float64")
    for label, dtype, step_kw in (("f32, smooth terms", "float32", smooth),
                                  ("float64, the whole recipe", "float64", kw),
                                  ("f32, the whole recipe", "float32", kw)):
        card = pcn_step_grads(device, batch, cam, quads, qmask, cfg, step_kw, aux, at, dtype)
        ref = (cpu64 if (dtype, step_kw) == ("float64", kw) else
               pcn_step_grads("cpu", batch, cam, quads, qmask, cfg, step_kw, aux, at, dtype))
        grad_err, param_err = step_card_vs_cpu(card, ref)
        line = (f"pcn step card vs CPU ({label}; batch {bs}, aux {aux:.4f}, zeta "
                f"{card[0].zeta_at(at):g}): every gradient max|err|/max|ref| {grad_err:.3e}, "
                f"every updated parameter {param_err:.3e}")
        grad_tol = TRAIN_RTOL
        ok = True
        if label.startswith("f32, the whole"):
            own = worst_rel(ref[3], cpu64[3])
            exact = worst_rel(card[3], cpu64[3])
            grad_tol = max(own, TRAIN_RTOL)
            exact_tol = max(2.0 * own, TRAIN_RTOL)
            line += (f" (tolerance {grad_tol:.3e}); card f32 vs CPU float64 gradients "
                     f"{exact:.3e} (tolerance {exact_tol:.3e}); the CPU's own f32 vs float64 "
                     f"{own:.3e}; updated parameters (tolerance {TRAIN_RTOL:g})")
            ok = exact <= exact_tol
        else:
            line += f" (tolerance {TRAIN_RTOL:g})"
        print(line, flush=True)
        if not (ok and grad_err <= grad_tol and param_err <= TRAIN_RTOL):
            raise RuntimeError(f"the PCN step on the card disagrees with the CPU ({label})")
    del card, ref, cpu64

    # the recipe's step (bf16 matmuls): two steps from one state, then timed
    tr = PCNTrainer(PCN(cfg, generator=torch.Generator().manual_seed(1)), device=device, **kw)
    state = tr.init_state()
    start = {k: p.detach().clone() for k, p in state.params.items()}
    opt0 = state.opt_state
    after = []
    for _ in range(2):
        with torch.no_grad():
            for k, p in state.params.items():
                p.copy_(start[k])
        new, _ = tr.train_step(dataclasses.replace(state, opt_state=opt0), batch, cam, quads,
                               qmask, aux)
        after.append([p.detach().clone() for p in new.params.values()]
                     + [new.opt_state.mu.clone(), new.opt_state.nu.clone()])
    same = all(torch.equal(x, y) for x, y in zip(*after))
    print(f"pcn two steps from one state: parameters and moments bit for bit: {same}",
          flush=True)
    if not same:
        raise RuntimeError("two PCN steps from one state differ")
    state = new
    batches = []
    rng = np.random.default_rng(0)
    while len(batches) < steps + 3:
        batches += list(ds.iter_batches(bs, rng=rng))
    for b in batches[:3]:
        state, _ = tr.train_step(state, *b, aux)
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    metrics = []
    for b in batches[3:steps + 3]:
        state, m = tr.train_step(state, *b, aux)
        metrics.append(m["loss"])
    losses = torch.stack(metrics).float().cpu().numpy()        # ends in a sync
    ms = (time.perf_counter() - t) / steps * 1e3
    peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else float("nan")
    line = (f"pcn step (p7, batch {bs}, bf16 matmuls, eager): {ms:.3f} ms/step over {steps} "
            f"steps (host clock ending in a sync), loss finite {bool(np.isfinite(losses).all())}; "
            f"peak allocated {peak:.3f} GB")
    if cuda:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            sync()
            t = time.perf_counter()
            for b in batches[3:3 + PROFILE_STEPS]:
                state, _ = tr.train_step(state, *b, aux)
            sync()
            wall_ms = (time.perf_counter() - t) * 1e3
        p = profiling.device_profile(prof, wall_ms, PROFILE_STEPS)
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / "pcn_profile.txt").write_text(
            prof.key_averages().table(sort_by="self_device_time_total", row_limit=40))
        line += (f"; profiled {wall_ms / PROFILE_STEPS:.3f} ms/step, device busy "
                 f"{p['busy_ms'] / PROFILE_STEPS:.3f} ms/step ({100 * p['busy_share']:.1f} %), "
                 f"{p['device_events_per_step']:.0f} device events and "
                 f"{p['host_launch_calls_per_step']:.0f} host launch calls per step")
    print(line, flush=True)
    if cuda:
        for name, ms_step, n in p["top"]:
            print(f"  pcn device {ms_step:.3f} ms/step, {n}/step: {name}", flush=True)
    if not np.isfinite(losses).all():
        raise RuntimeError("a timed PCN step's loss is not finite")
    return paths


def covid_phase(device: str = "cuda", n_frames: int = COVID_FRAMES, width: tuple = ()) -> dict:
    """The committed covid recipe (covid2: sparse CGequiVAE, degree_norm,
    500 seqpartition beads, n_basis 192, cross decoder, batch 2) through
    ``run_cgvae`` on the synthetic covid frames, cut in depth to one fold
    of one epoch on ``n_frames`` frames and COVID_ENSEMBLE samples of
    COVID_EVALS test frames, with the graph metrics; the fold's artifacts
    checked, the atom graphs built by the cell list and the metrics by the
    bond diff, the fold's wall time by part; then the step eager and
    captured with its peak memory. Raises on any failed check."""
    import numpy as np
    import torch

    from coarsegrainingvae_tpu_torch.cli import run_cgvae
    from coarsegrainingvae_tpu_torch.data import dataset as dataset_mod
    from coarsegrainingvae_tpu_torch.data.device import DeviceDataset
    from coarsegrainingvae_tpu_torch.eval import sampling
    from coarsegrainingvae_tpu_torch.native import bond_diff, cell_list
    from coarsegrainingvae_tpu_torch.train.checkpoint import CheckpointManager
    from coarsegrainingvae_tpu_torch.train.trainer import Trainer

    cuda = device == "cuda"
    flags = recipe_flags("covid2", COVID_RECIPE) + list(width)
    a = run_cgvae.build_parser().parse_args(flags)
    trained, datasets = [], []

    class RecordingTrainer(Trainer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            trained.append(self)

    def recording_build(*args, **kwargs):
        datasets.append(real_build(*args, **kwargs))
        return datasets[-1]

    real_build = run_cgvae.build_dataset
    logdir = CV_DIR / "covid"
    for old in CV_DIR.glob("covid*"):
        shutil.rmtree(old, ignore_errors=True)
    parts = [(run_cgvae, "load_frames", "load_frames"),
             (run_cgvae, "build_fold_mapping", "mapping"),
             (run_cgvae, "build_dataset", "datasets"),
             (dataset_mod, "radius_graph_frames", "radius graphs (inside datasets)"),
             (Trainer, "fit", "fit"),
             (CheckpointManager, "save", "checkpoint save"),
             (run_cgvae, "reconstruct_all", "reconstruct_all"),
             (run_cgvae, "sample_ensemble", "sample_ensemble"),
             (sampling, "evaluate_samples", "metrics (inside both)"),
             (run_cgvae, "write_xyz", "xyz dumps"),
             (run_cgvae, "save_grid_snapshots", "movies")]
    depth = ["-ndata", str(n_frames), "-n_ensemble", str(COVID_ENSEMBLE), "-nevals",
             str(COVID_EVALS), "--graph_eval", "-max_folds", "1", "-nepochs", "1",
             "-logdir", str(logdir), "--device", device]
    cells, diffs = cell_list.calls, bond_diff.calls
    run_cgvae.Trainer = RecordingTrainer
    run_cgvae.build_dataset = recording_build
    try:
        reset_counts()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        with PartTimes(parts) as times:
            rows = run_cgvae.main(flags + depth)
        wall = time.perf_counter() - t
        launches = read_counts()
    finally:
        run_cgvae.Trainer = Trainer
        run_cgvae.build_dataset = real_build
    peak_fold = torch.cuda.max_memory_allocated() / 1e9 if cuda else float("nan")
    (run,) = list(CV_DIR.glob("covid*"))
    check_cv_run(run, 1, 1)
    cells, diffs = cell_list.calls - cells, bond_diff.calls - diffs
    ds_train = datasets[0]
    n_atoms = ds_train.n_atoms
    edges = ds_train.nbr_mask.sum(1)
    print(f"covid run: run_cgvae 1 fold x 1 epoch in {wall:.3f} s ({type(trained[0].model).__name__},"
          f" {n_atoms} atoms, {a.n_cgs} beads, n_basis {a.n_basis}, batch {a.batch_size}); atom "
          f"edges per frame {edges.tolist()} (budget {ds_train.nbrs.shape[1]}), CG edges per "
          f"frame {ds_train.cg_nbr_mask.sum(1).tolist()}; cell-list calls {cells}, bond-diff "
          f"calls {diffs}; test recon RMSD {rows[0]['test_all_recon_rmsd']:.4f} A, recon valid "
          f"{rows[0]['recon_all_valid_ratio']}; peak allocated {peak_fold:.3f} GB; launches "
          f"{launches}", flush=True)
    print(f"covid wall time by part: {times.line()}", flush=True)
    if n_atoms >= 256 and cells < 2:
        raise RuntimeError(f"the cell list built {cells} graph stacks, expected the atom graphs")
    if n_atoms > 1500 and diffs == 0:
        raise RuntimeError("the bond diff computed no metric")
    if cuda and any(launches.values()):
        raise RuntimeError(f"the sparse covid model launched a kernel: {launches}")

    if not cuda:
        return {"covid": launches}
    # the step: eager and captured epochs over the fold's train frames
    tr = trained[0]
    n_val = max(int(len(ds_train) * 0.1), 1)
    ds_tr = ds_train.subset(np.arange(n_val, len(ds_train)))
    bs = a.batch_size
    steps = max(len(ds_tr) // bs, 1)
    dds = DeviceDataset.from_dataset(ds_tr.subset(np.resize(np.arange(len(ds_tr)), steps * bs)),
                                     "cuda")
    dds_prof = DeviceDataset.from_dataset(
        ds_tr.subset(np.resize(np.arange(len(ds_tr)), PROFILE_STEPS * bs)), "cuda")
    state = tr.init_state(ds_tr.batch(np.arange(bs)))
    none = dict.fromkeys(DENSE_PER_STEP, 0)
    _, timings, _, peak = timed_epochs(tr, state, dds, dds_prof, bs, none, "covid ",
                                       kinds=("eager", "captured", "captured"),
                                       profile_name=f"covid_profile_b{bs}.txt")
    print(f"covid step, batch {bs}: eager {timings['eager'][0]:.3f} ms/step, captured "
          f"{', '.join(f'{x:.3f}' for x in timings['captured'])} ms/step; step peak allocated "
          f"{peak:.3f} GB (fold {peak_fold:.3f} GB)", flush=True)
    return {"covid": launches}



def dipeptide_data(device: str, n_frames: int) -> None:
    """Point the data root at ``chiprun_out/cv_data/dipeptide.npz``, made
    from synthetic frames relaxed on ``device`` unless it already holds
    ``n_frames`` frames (the cv phase writes 640)."""
    import numpy as np

    from coarsegrainingvae_tpu_torch.data.proteins import save_npz_traj
    from coarsegrainingvae_tpu_torch.data.synthetic import synthetic_peptide

    data = OUT_DIR / "cv_data"
    path = data / "dipeptide.npz"
    os.environ["COARSEGRAININGVAE_DATA"] = str(data)
    if path.is_file():
        with np.load(path) as d:
            if d["xyz"].shape[0] >= n_frames:
                return
    data.mkdir(parents=True, exist_ok=True)
    t = time.perf_counter()
    save_npz_traj(str(path), *synthetic_peptide("dipeptide", n_frames=n_frames, seed=0,
                                                device=device))
    print(f"data: {n_frames} synthetic dipeptide frames relaxed on {device} and written to "
          f"{path} in {time.perf_counter() - t:.3f} s", flush=True)


def json_recipe_flags(path: Path, skip=("logdir",), long=()) -> list:
    """CLI flags of a committed run's modelparams.json (the JAX CLI's
    ``vars(args)``): ``-key value`` (``--key value`` for the keys in
    ``long``), and ``--key`` for a true switch."""
    flags = []
    for k, v in json.loads(path.read_text()).items():
        if k in skip:
            continue
        if isinstance(v, bool):
            if v:
                flags.append(f"--{k}")
        else:
            flags += [f"--{k}" if k in long else f"-{k}", str(v)]
    return flags


def read_csv(path: Path) -> tuple:
    import csv

    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        return reader.fieldnames, list(reader)


def check_finite_rows(path: Path, header: list, n_rows: int) -> list:
    """The CSV's header and row count, every value finite; returns the rows."""
    import math

    fields, rows = read_csv(path)
    if fields != header or len(rows) != n_rows:
        raise RuntimeError(f"{path}: header {fields}, {len(rows)} rows; expected {header}, "
                           f"{n_rows} rows")
    bad = [(i, k) for i, r in enumerate(rows) for k, v in r.items() if not math.isfinite(float(v))]
    if bad:
        raise RuntimeError(f"{path}: values that are not finite: {bad}")
    return rows




def timed_steps(step, batches, cuda: bool, label: str, profile_name: str) -> str:
    """ms/step of ``step(batch)`` over ``batches`` (eager; host clock ending
    in a sync, after 3 warm-up steps) and peak memory, then on the card a
    profiled window: device busy, device events and host launch calls per
    step, the profile's table to ``chiprun_out/<profile_name>``. Returns
    the line it prints; raises if a loss is not finite."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from coarsegrainingvae_tpu_torch.utils import profiling

    def sync():
        if cuda:
            torch.cuda.synchronize()

    for b in batches[:3]:
        step(b)
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    losses = [step(b) for b in batches[3:]]
    losses = torch.stack(losses).float().cpu().numpy()           # ends in a sync
    n = len(batches) - 3
    ms = (time.perf_counter() - t) / n * 1e3
    peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else float("nan")
    line = (f"{label}: {ms:.3f} ms/step over {n} steps (eager, host clock ending in a sync), "
            f"loss finite {bool(np.isfinite(losses).all())}; peak allocated {peak:.3f} GB")
    top = []
    if cuda:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            sync()
            t = time.perf_counter()
            for b in batches[3:3 + PROFILE_STEPS]:
                step(b)
            sync()
            wall_ms = (time.perf_counter() - t) * 1e3
        p = profiling.device_profile(prof, wall_ms, PROFILE_STEPS)
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / profile_name).write_text(
            prof.key_averages().table(sort_by="self_device_time_total", row_limit=40))
        line += (f"; profiled {wall_ms / PROFILE_STEPS:.3f} ms/step, device busy "
                 f"{p['busy_ms'] / PROFILE_STEPS:.3f} ms/step ({100 * p['busy_share']:.1f} %), "
                 f"{p['device_events_per_step']:.0f} device events and "
                 f"{p['host_launch_calls_per_step']:.0f} host launch calls per step")
        top = p["top"]
    print(line, flush=True)
    for name, ms_step, count in top:
        print(f"  {label} device {ms_step:.3f} ms/step, {count}/step: {name}", flush=True)
    if not np.isfinite(losses).all():
        raise RuntimeError(f"a timed {label} loss is not finite")
    return line


def diffpool_trainer(a, n_atoms: int, device: str, z=None, bonds=None, dtype="float32"):
    """The DiffPoolTrainer of run_diffpool's arguments ``a`` on ``device``
    (weights from the recipe's seed, drawn on the CPU), with the recipe's
    steric tables when zeta > 0."""
    import dataclasses

    from coarsegrainingvae_tpu_torch.cli.run_diffpool import config_from_args
    from coarsegrainingvae_tpu_torch.train.diffpool_trainer import DiffPoolTrainer
    from coarsegrainingvae_tpu_torch.train.losses import build_steric_tables

    cfg = dataclasses.replace(config_from_args(a, n_atoms), compute_dtype=dtype)
    steric = build_steric_tables(z, bonds, margin=a.steric_margin) if a.zeta > 0 else None
    return DiffPoolTrainer(cfg, beta=a.beta, gamma=a.gamma, lr=a.lr, seed=a.seed, zeta=a.zeta,
                           steric_tables=steric, graph_grad=a.graph_grad,
                           zeta_warmup=a.zeta_warmup, graph_warmup=a.graph_warmup,
                           h_project=a.h_project, device=device)


def diffpool_step_grads(tr, batch, step: int, u, eps) -> tuple:
    """(trainer, state, tracked loss, gradients) of one train step's
    objective at ``step`` with the draws (u, eps) handed to the model; a
    float64 trainer gets a float64 model, tables and batch."""
    import dataclasses

    import torch

    device = tr.device
    if tr.cfg.compute_dtype == "float64":
        tr.model.double()
        tr.steric_tables = tuple(t.double() if t.is_floating_point() else t
                                 for t in tr.steric_tables or ()) or None
        batch = dataclasses.replace(batch, xyz=batch.xyz.double(), adj=batch.adj.double())
    tr.noise = lambda key, batch_size: (None if u is None else u.to(device), eps.to(device))
    state = tr.init_state()
    total, metrics = tr.loss(batch.to(device), step, (0,))
    params = list(state.params.values())
    grads = torch.autograd.grad(total, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
    return tr, state, metrics["loss"].detach(), grads


def diffpool_phase(device: str = "cuda", ndata: int = DIFFPOOL_NDATA,
                   epochs: int = DIFFPOOL_EPOCHS, pretrain: int = DIFFPOOL_PRETRAIN,
                   steps: int = DIFFPOOL_STEPS, width: tuple = ()) -> dict:
    """The committed DiffPool v6 recipe (examples/results/diffpool_demo:
    n_cgs 8, F 512, enc 2 / dec 3, cross, batch 32, graph_grad and zeta
    with 5,000-step ramps, h_project, sample_hard) through
    ``cli.run_diffpool`` at full width, cut in depth; every file checked.
    Then the recipe's step: card vs CPU at f32 mid-ramp (the same weights
    and draws; the CPU's float64 step shows the loss's own f32
    conditioning), two steps from one state bit for bit, and ms/step,
    device busy, host launch calls and peak memory. DiffPool runs none of
    the four kernels: their counters stay 0. Raises on any failed check.
    ``width`` flags (given after the recipe's) let the CPU rehearse it."""
    import dataclasses

    import numpy as np
    import torch

    from coarsegrainingvae_tpu_torch.cli import run_diffpool
    from coarsegrainingvae_tpu_torch.data.diffpool import build_diffpool_dataset
    from coarsegrainingvae_tpu_torch.data.proteins import load_frames
    from coarsegrainingvae_tpu_torch.models.cgae import uniform_noise

    cuda = device == "cuda"
    shutil.rmtree(DIFFPOOL_DIR, ignore_errors=True)
    dipeptide_data(device, ndata)
    recipe = json_recipe_flags(DIFFPOOL_RECIPE / "v6_modelparams.json")
    full = run_diffpool.build_parser().parse_args(recipe)
    depth = ["-ndata", str(ndata), "-nepochs", str(epochs), "-n_pretrain", str(pretrain)]
    flags = recipe + list(width) + depth
    a = run_diffpool.build_parser().parse_args(flags)
    print(f"diffpool: the v6 recipe (n_cgs {a.n_cgs}, F {a.num_features}, n_rbf {a.n_rbf}, "
          f"enc {a.enc_nconv} / dec {a.dec_nconv}, {a.activation}, batch {a.batch_size}, "
          f"lr {a.lr}, beta {a.beta}, gamma {a.gamma}, zeta {a.zeta} over {a.zeta_warmup} steps, "
          f"graph_grad over {a.graph_warmup}, h_project {a.h_project}, tau_min {a.tau_min}, "
          f"sample_hard {a.sample_hard}) cut in depth: ndata {full.ndata} -> {a.ndata}, nepochs "
          f"{full.nepochs} -> {a.nepochs}, n_pretrain {full.n_pretrain} -> {a.n_pretrain}, "
          f"folds {a.nsplits} of {a.nsplits}", flush=True)
    reset_counts()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    rows = run_diffpool.main(flags + ["-logdir", str(DIFFPOOL_DIR / "v6"), "--device", device])
    wall = time.perf_counter() - t
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else float("nan")
    (run,) = list(DIFFPOOL_DIR.glob("v6_*"))
    check_finite_rows(run / "cv_stats.csv", DIFFPOOL_CV_COLUMNS, a.nsplits)
    z, frames, bonds = load_frames(a.dataset, a.ndata, seed=a.seed, device=device)
    n_atoms = z.shape[0]
    sample_batch = build_diffpool_dataset(frames[:8], z, bonds).batch(np.arange(8))
    epoch_s = []
    for k in range(a.nsplits):
        fold = run / f"fold{k}"
        log = check_finite_rows(fold / "train_log.csv", [
            "epoch", "lr", "train_loss", "val_loss", "train_recon", "val_recon", "train_KL",
            "val_KL", "train_graph", "val_graph", "tau", "epoch_time_s"], a.nepochs)
        epoch_s.append([round(float(r["epoch_time_s"]), 3) for r in log])
        samples = np.load(fold / "test_samples.npy")
        if samples.shape != (8, n_atoms, 3) or not np.isfinite(samples).all():
            raise RuntimeError(f"{fold}/test_samples.npy: {samples.shape}, finite "
                               f"{np.isfinite(samples).all()}")
        fresh = diffpool_trainer(a, n_atoms, device, z, bonds)
        check_params_file(fold / "params.msgpack", fresh.cfg, fresh.model,
                          lambda m: (fresh.sample(sample_batch, a.seed, a.sample_hard),))
    if not (run / "modelparams.json").is_file():
        raise RuntimeError(f"{run}: missing modelparams.json")
    print(f"diffpool run: {a.nsplits} folds x {a.nepochs} epochs (after {a.n_pretrain} "
          f"pretraining epochs) in {wall:.3f} s; epochs {epoch_s} s; test recon "
          f"{[round(r['test_recon'], 4) for r in rows]}, sample valid "
          f"{[r['sample_valid_ratio'] for r in rows]}; peak allocated {peak:.3f} GB; "
          f"launches {launches}", flush=True)
    if any(launches.values()):
        raise RuntimeError(f"run_diffpool launched a kernel: {launches}")

    # the recipe's step on its own: card vs CPU mid-ramp at f32, with the
    # CPU's float64 step beside it (the loss's own f32 conditioning)
    ds = build_diffpool_dataset(frames, z, bonds, rotate=True, seed=a.seed)
    bs = a.batch_size
    batch = ds.batch(np.arange(bs))
    at = max(a.zeta_warmup, a.graph_warmup) // 2
    gen = torch.Generator().manual_seed(5)
    shape = diffpool_trainer(a, n_atoms, "cpu", z, bonds).model.pooler.noise_shape(bs, n_atoms)
    u = None if shape is None else uniform_noise(shape, gen, "cpu")
    eps = torch.randn((bs, a.n_cgs, a.num_features), generator=gen)
    card = diffpool_step_grads(diffpool_trainer(a, n_atoms, device, z, bonds), batch, at, u, eps)
    ref = diffpool_step_grads(diffpool_trainer(a, n_atoms, "cpu", z, bonds), batch, at, u, eps)
    ref64 = diffpool_step_grads(diffpool_trainer(a, n_atoms, "cpu", z, bonds, "float64"),
                                batch, at, None if u is None else u.double(), eps.double())
    own = worst_rel(ref[3], ref64[3])
    grad_err, param_err = step_card_vs_cpu(card, ref)
    print(f"diffpool step card vs CPU (f32, batch {bs}, step {at}: tau "
          f"{card[0].tau_at(at):.4f}, zeta and graph weight at {at / a.zeta_warmup:.2f} of "
          f"their ramps, h_project {a.h_project}; the same weights and draws): every gradient "
          f"max|err|/max|ref| {grad_err:.3e}, every updated parameter {param_err:.3e} "
          f"(tolerance {TRAIN_RTOL:g}); the CPU's own f32 vs float64 gradients {own:.3e}",
          flush=True)
    if not (grad_err <= TRAIN_RTOL and param_err <= TRAIN_RTOL):
        raise RuntimeError("the DiffPool step on the card disagrees with the CPU")
    del card, ref, ref64

    # two steps from one state, then timed
    tr = diffpool_trainer(a, n_atoms, device, z, bonds)
    state = tr.init_state()
    start = {k: p.detach().clone() for k, p in state.params.items()}
    after = []
    for _ in range(2):
        with torch.no_grad():
            for k, p in state.params.items():
                p.copy_(start[k])
        new, _ = tr.train_step(dataclasses.replace(state, step=at), batch, (0, 1))
        after.append([p.detach().clone() for p in new.params.values()]
                     + [new.opt_state.mu.clone(), new.opt_state.nu.clone()])
    same = all(torch.equal(x, y) for x, y in zip(*after))
    print(f"diffpool two steps from one state: parameters and moments bit for bit: {same}",
          flush=True)
    if not same:
        raise RuntimeError("two DiffPool steps from one state differ")
    batches = []
    rng = np.random.default_rng(0)
    while len(batches) < steps + 3:
        batches += list(ds.iter_batches(bs, rng=rng))
    box = {"state": new}

    def step(b):
        box["state"], m = tr.train_step(box["state"], b, (1, box["state"].step))
        return m["loss"]

    timed_steps(step, batches[:steps + 3], cuda,
                f"diffpool step (v6, batch {bs}, F {a.num_features}, f32)", "diffpool_profile.txt")
    return {"diffpool": launches}



def baseline_step_grads(name: str, a, n_atoms: int, mapping, batch, device: str) -> tuple:
    """(trainer, state, loss, gradients) of one step of the zoo entry
    ``name`` with run_baseline's arguments ``a`` on ``device`` (weights of
    the recipe's seed, drawn on the CPU)."""
    import torch

    from coarsegrainingvae_tpu_torch.cli.run_baseline import model_kwargs
    from coarsegrainingvae_tpu_torch.models.baseline import build_baseline
    from coarsegrainingvae_tpu_torch.train.baseline_trainer import BaselineTrainer

    kw = model_kwargs(argparse.Namespace(**dict(vars(a), model=name)), mapping)
    model = build_baseline(name, a.n_cgs, n_atoms, mapping,
                           generator=torch.Generator().manual_seed(a.seed), **kw)
    tr = BaselineTrainer(model, gamma=a.gamma, lr=a.lr, seed=a.seed, device=device)
    state = tr.init_state()
    total, metrics = tr.loss(batch.to(tr.device))
    params = list(state.params.values())
    grads = torch.autograd.grad(total, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
    return tr, state, metrics["loss"].detach(), grads


def baseline_phase(device: str = "cuda", ndata: int = BASELINE_NDATA,
                   epochs: int = BASELINE_EPOCHS, steps: int = DIFFPOOL_STEPS,
                   width: tuple = ()) -> dict:
    """The committed baseline recipe (examples/results/baseline_demo:
    equimlp, n_cgs 3, newman, knn 3, width 1, depth 1, batch 32, lr 3e-4,
    gamma 5, 2 folds) through ``cli.run_baseline``, cut in depth, every
    file checked; then one step of every zoo entry card vs CPU at f32 on
    the same weights and batch, and the recipe's step timed. No kernel
    runs on this path: the counters stay 0. Raises on any failed check.
    ``width`` flags (given after the recipe's) let the CPU rehearse it."""
    import numpy as np
    import torch

    from coarsegrainingvae_tpu_torch.cli import run_baseline
    from coarsegrainingvae_tpu_torch.data.diffpool import build_diffpool_dataset
    from coarsegrainingvae_tpu_torch.data.mappings import get_mapping
    from coarsegrainingvae_tpu_torch.data.proteins import load_frames
    from coarsegrainingvae_tpu_torch.models.baseline import BASELINE_ZOO

    cuda = device == "cuda"
    shutil.rmtree(BASELINE_DIR, ignore_errors=True)
    dipeptide_data(device, ndata)
    recipe = json_recipe_flags(BASELINE_RECIPE / "modelparams.json")
    full = run_baseline.build_parser().parse_args(recipe)
    flags = recipe + list(width) + ["-ndata", str(ndata), "-nepochs", str(epochs)]
    a = run_baseline.build_parser().parse_args(flags)
    reset_counts()
    t = time.perf_counter()
    rows = run_baseline.main(flags + ["-logdir", str(BASELINE_DIR / "demo"), "--device", device])
    wall = time.perf_counter() - t
    launches = read_counts()
    (run,) = list(BASELINE_DIR.glob("demo_*"))
    check_finite_rows(run / "cv_stats.csv",
                      ["fold", "test_recon_rmsd", "test_graph", "test_loss", "test_recon"],
                      a.nsplits)
    for k in range(a.nsplits):
        check_finite_rows(run / f"fold{k}" / "train_log.csv", [
            "epoch", "lr", "train_loss", "val_loss", "train_recon", "val_recon", "train_graph",
            "val_graph", "epoch_time_s"], a.nepochs)
    print(f"baseline run: the baseline_demo recipe ({a.model}, n_cgs {a.n_cgs}, {a.cg_method}, "
          f"knn {a.knn}, batch {a.batch_size}, lr {a.lr}, gamma {a.gamma}) cut in depth: ndata "
          f"{full.ndata} -> {a.ndata}, nepochs {full.nepochs} -> {a.nepochs}; {a.nsplits} folds "
          f"in {wall:.3f} s; test recon RMSD {[round(r['test_recon_rmsd'], 4) for r in rows]} "
          f"A; launches {launches}", flush=True)
    if any(launches.values()):
        raise RuntimeError(f"run_baseline launched a kernel: {launches}")

    z, frames, bonds = load_frames(a.dataset, a.ndata, seed=a.seed, device=device)
    n_atoms = z.shape[0]
    ds = build_diffpool_dataset(frames, z, bonds)
    batch = ds.batch(np.arange(a.batch_size))
    # the zoo's steps at BASELINE_CHECK_CGS beads: at the recipe's 3 the
    # knn (clamped to 2) reaches every other bead, each edge comes with its
    # reverse at the same length, the edge sums cancel, and equimlp's
    # gradients (and edgesetmlp's last bias) are 0 up to rounding, which
    # no relative gate can read
    ca = argparse.Namespace(**dict(vars(a), n_cgs=BASELINE_CHECK_CGS))
    mapping = get_mapping(a.cg_method, ca.n_cgs, n_atoms, bonds=bonds, frames=frames,
                          seed=a.seed, device=device)
    worst = []
    for name in BASELINE_ZOO:
        card = baseline_step_grads(name, ca, n_atoms, mapping, batch, device)
        ref = baseline_step_grads(name, ca, n_atoms, mapping, batch, "cpu")
        worst.append((name, *step_card_vs_cpu(card, ref)))
    print("baseline steps card vs CPU (f32, batch {}, n_cgs {} for the check, knn {}; "
          "max|err|/max|ref| of every gradient, every updated parameter; tolerance {:g}): "
          "{}".format(a.batch_size, ca.n_cgs, a.knn, TRAIN_RTOL,
                      ", ".join(f"{n} {g:.3e} {p:.3e}" for n, g, p in worst)), flush=True)
    if not all(g <= TRAIN_RTOL and p <= TRAIN_RTOL for _, g, p in worst):
        raise RuntimeError("a baseline step on the card disagrees with the CPU")

    mapping = get_mapping(a.cg_method, a.n_cgs, n_atoms, bonds=bonds, frames=frames,
                          seed=a.seed, device=device)
    tr, state, _, _ = baseline_step_grads(a.model, a, n_atoms, mapping, batch, device)
    batches = []
    rng = np.random.default_rng(0)
    while len(batches) < steps + 3:
        batches += list(ds.iter_batches(a.batch_size, rng=rng))
    box = {"state": state}

    def step(b):
        box["state"], m = tr.train_step(box["state"], b)
        return m["loss"]

    timed_steps(step, batches[:steps + 3], cuda, f"baseline step ({a.model}, batch "
                f"{a.batch_size})", "baseline_profile.txt")
    return {"baseline": launches}


def hpo_expected_launches(run: Path, rows: list, a) -> dict:
    """The hpo run's kernel launches worked out from its trials: per trial
    (``trial_%04d`` in row order), ``cv_expected_launches`` of its config
    over every fold of ``-nsplits`` at the epochs each fold logged, with
    the objective's 4 evaluated frames and the CLI's decoder."""
    total = dict.fromkeys(("fused_message", "fused_message_vjp", "fused_pseudo_message",
                           "fused_pseudo_vjp"), 0)
    for i, row in enumerate(rows):
        trial = run / f"trial_{i:04d}"
        epochs = [len(read_csv(trial / f"fold{k}" / "train_log.csv")[1])
                  for k in range(a.nsplits)]
        width = ["-batch_size", a.batch_size, "-enc_nconv", row["enc_nconv"],
                 "-dec_nconv", row["dec_nconv"]]
        per = cv_expected_launches(width, a.ndata, a.nsplits, epochs, 4, a.dec_type, a.nsplits)
        for k, v in per.items():
            total[k] += v
    return total


def hpo_phase(device: str = "cuda", recipe: list = HPO_RECIPE, width: tuple = ()) -> dict:
    """The committed hpo recipe (examples/results/hpo_demo: ASHA over the
    CGequiVAE search space, 6 trials, 8 epochs, 400 dipeptide frames, 2
    folds per trial) through ``cli.hpo``: every trial's CV run goes through
    the dense model's message kernels on the card (the CLI's default cross
    decoder runs them at S 4 too). Raises if any trial failed, or if the
    launches differ from the count worked out from the trials' configs.
    ``width`` flags (given after the recipe's) let the CPU rehearse it."""
    import torch

    from coarsegrainingvae_tpu_torch.cli import hpo

    shutil.rmtree(HPO_DIR, ignore_errors=True)
    flags = list(recipe) + list(width) + ["-logdir", str(HPO_DIR), "--device", device]
    a = hpo.build_parser().parse_args(flags)
    dipeptide_data(device, a.ndata)
    # the search logs a trial's error only when the log's first row has
    # one; the trial results are read where the search makes them
    trials = []
    evaluate = hpo._evaluate

    def recording(*args):
        trials.append(evaluate(*args))
        return trials[-1]

    reset_counts()
    hpo._evaluate = recording
    try:
        t = time.perf_counter()
        best, value = hpo.main(flags)
        wall = time.perf_counter() - t
    finally:
        hpo._evaluate = evaluate
    launches = read_counts()
    log = HPO_DIR / ("hpo_asha_log.csv" if a.strategy == "asha" else "hpo_log.csv")
    _, rows = read_csv(log)
    failed = [(i, cfg.get("error")) for i, (cfg, _, bad, _) in enumerate(trials) if bad]
    if len(trials) != len(rows) or any(r["failed"] != str(bad) for r, (_, _, bad, _) in
                                       zip(rows, trials)):
        raise RuntimeError(f"{log} does not hold the {len(trials)} trial runs")
    print(f"hpo run: {a.strategy}, {a.n_trials} trials, {len(rows)} trial runs of "
          f"{a.nsplits} folds in {wall:.3f} s; per run (rung, epochs, n_basis, enc/dec, value, "
          f"wall s): {[(r.get('rung'), r.get('epochs'), r['n_basis'], r['enc_nconv'] + '/' + r['dec_nconv'], round(float(r['value']), 4), float(r['wall_s'])) for r in rows]}; "
          f"best {best} at {value:.4f}; failed {failed}", flush=True)
    if failed:
        raise RuntimeError(f"hpo trials failed: {failed}")
    expect = hpo_expected_launches(HPO_DIR, rows, a)
    print(f"hpo launches {launches} (expected {expect}; "
          f"{launches['fused_message'] / len(rows):.0f} message forwards per trial run)",
          flush=True)
    if device == "cuda" and (launches != expect or not (
            launches["fused_message"] and launches["fused_message_vjp"])):
        raise RuntimeError(f"hpo kernel launches {launches}, expected {expect}, both message "
                           "kernels launched")
    if device == "cuda":
        torch.cuda.synchronize()
    return {"hpo": launches, "hpo_ranks": hpo_on_ranks(device, list(recipe) + list(width))}


def hpo_rank(flags: list, space: dict) -> dict:
    """One rank of the hpo phase's spawned ranks (gloo): ``cli.hpo.main``
    over the process group the launcher formed, in the parent's search
    space; this rank's kernel launches and result."""
    from coarsegrainingvae_tpu_torch.cli import hpo

    hpo.CGVAE_SPACE = space
    reset_counts()
    best, value = hpo.main(flags)
    return {"launches": read_counts(), "best": best, "value": value}


def hpo_on_ranks(device: str, flags: list) -> dict:
    """The hpo search cut to HPO_RANKS_CUT on one process, then on
    MULTIGPU_RANKS gloo ranks sharing the device (each trial
    data-parallel): the same trial directories and rows, each value within
    HPO_RANKS_RTOL, written once. Returns the ranks' launches, summed."""
    import torch

    from coarsegrainingvae_tpu_torch.cli import hpo
    from coarsegrainingvae_tpu_torch.parallel.launch import spawn_ranks

    cut = flags + HPO_RANKS_CUT + ["--device", device]
    one, many = HPO_DIR / "one", HPO_DIR / "ranks"
    t = time.perf_counter()
    hpo.main(cut + ["-logdir", str(one)])
    one_s = time.perf_counter() - t
    store = HPO_DIR / f"store_{os.getpid()}"
    store.unlink(missing_ok=True)
    t = time.perf_counter()
    ranks = spawn_ranks(hpo_rank, MULTIGPU_RANKS, str(store),
                        (cut + ["-logdir", str(many)], hpo.CGVAE_SPACE), backend="gloo", threads=2)
    ranks_s = time.perf_counter() - t
    want, got = (read_csv(d / "hpo_asha_log.csv")[1] for d in (one, many))
    dirs = [sorted(p.name for p in d.iterdir() if p.name.startswith("trial_")) for d in (one, many)]
    worst = 0.0
    if len(got) != len(want) or dirs[0] != dirs[1]:
        raise RuntimeError(f"hpo on {MULTIGPU_RANKS} ranks wrote {len(got)} rows in {dirs[1]}, "
                           f"one process {len(want)} in {dirs[0]}")
    for g, w in zip(got, want):
        if {k: v for k, v in g.items() if k not in ("value", "wall_s")} != \
                {k: v for k, v in w.items() if k not in ("value", "wall_s")}:
            raise RuntimeError(f"hpo on {MULTIGPU_RANKS} ranks ran {g}, one process {w}")
        worst = max(worst, abs(float(g["value"]) - float(w["value"])) / abs(float(w["value"])))
    total = dict.fromkeys(DENSE_PER_STEP, 0)
    for r in ranks:
        for k in total:
            total[k] += r["launches"][k]
    print(f"hpo on {MULTIGPU_RANKS} gloo ranks sharing the {device}, the recipe cut to "
          f"{' '.join(HPO_RANKS_CUT)}: {len(got)} trial runs in {ranks_s:.1f} s (one process "
          f"{one_s:.1f} s), the same trial directories {dirs[1]} and rows, values within "
          f"{worst:.3e} of one process's (relative); best {[r['value'] for r in ranks]} on the "
          f"ranks; launches per rank {[r['launches'] for r in ranks]}", flush=True)
    if not worst <= HPO_RANKS_RTOL or len({r["value"] for r in ranks}) != 1:
        raise RuntimeError(f"hpo on {MULTIGPU_RANKS} ranks disagrees with one process: {worst:.3e}")
    if device == "cuda" and not all(r["launches"]["fused_message"] for r in ranks):
        raise RuntimeError("hpo on ranks: a rank launched no message kernel")
    if device == "cuda":
        torch.cuda.synchronize()
    return total


def one_rank_mesh(device: str):
    """A process group of one rank over a FileStore (NCCL on the card,
    gloo on the CPU) and its mesh."""
    import torch
    import torch.distributed as dist

    from coarsegrainingvae_tpu_torch.parallel.mesh import TIMEOUT, make_mesh

    MULTIGPU_DIR.mkdir(parents=True, exist_ok=True)
    store = MULTIGPU_DIR / f"store_one_{os.getpid()}"
    store.unlink(missing_ok=True)
    kw = {"device_id": torch.device("cuda", 0)} if device == "cuda" else {}
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            store=dist.FileStore(str(store), 1), rank=0, world_size=1,
                            timeout=TIMEOUT, **kw)
    return make_mesh(device=device)


def halo_inputs(n: int, f: int, seed: int = 5) -> tuple:
    """Seeded (s (n, f), v (n, 3, f)) node features for the halo stack."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, f)).astype(np.float32),
            rng.normal(size=(n, 3, f)).astype(np.float32))


def multigpu_rank(device: str, cfg, ds, order, n_steps: int, ref_path: str, halo: tuple) -> dict:
    """One rank of the multigpu phase's spawned ranks (gloo): the
    data-parallel trainer's ``n_steps`` steps over ``ds``'s global batches
    in ``order``, replicated and ZeRO-1, against the one-rank parameters at
    ``ref_path``; then this rank's block of the halo stack, forward and
    parameter gradients (summed over the ranks). Returns what the parent
    checks and prints."""
    import dataclasses

    import numpy as np
    import torch

    from coarsegrainingvae_tpu_torch.config import ParallelConfig
    from coarsegrainingvae_tpu_torch.models.dense_cgvae import DenseCGVAE
    from coarsegrainingvae_tpu_torch.parallel import halo as halo_mod
    from coarsegrainingvae_tpu_torch.parallel.mesh import all_reduce_, make_mesh
    from coarsegrainingvae_tpu_torch.train.trainer import Trainer

    cuda = device == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    reset_counts()
    mesh = make_mesh(device=device)
    bs = cfg.data.batch_size
    out = {"rank": mesh.rank, "transport": mesh.transport}
    ref = torch.load(ref_path, weights_only=True)
    trained = {}
    for zero in (False, True):
        c = dataclasses.replace(cfg, parallel=ParallelConfig(zero_optimizer=zero))
        tr = Trainer(DenseCGVAE(c.model, generator=torch.Generator().manual_seed(0)), c,
                     device=device, mesh=mesh)
        st = tr.init_state(ds.batch(order[:bs]))
        gen = torch.Generator(device=device).manual_seed(21)
        ms = []
        for i in range(n_steps):
            batch = ds.batch(order[i * bs:(i + 1) * bs]).to(device)
            sync()
            t = time.perf_counter()
            st, m = tr.train_step(st, batch, gen)
            sync()
            ms.append((time.perf_counter() - t) * 1e3)
            if float(m["grad_ok"]) != 1.0:
                raise RuntimeError(f"rank {mesh.rank}: step {i} was rejected")
        trained[zero] = {k: p.detach().cpu().clone() for k, p in st.params.items()}
        out["zero_ms" if zero else "ms"] = ms
        out["zero_moments" if zero else "moments"] = st.opt_state.mu.numel()
        del tr, st
    out["launches"] = read_counts()
    out["dp_err"] = worst_rel([trained[False][k] for k in ref], [ref[k] for k in ref])
    out["zero_equal"] = all(torch.equal(trained[True][k], trained[False][k]) for k in ref)
    out["zero_err"] = worst_rel([trained[True][k] for k in ref],
                                [trained[False][k] for k in ref])

    xyz, edges, kw = halo
    plan = halo_mod.plan_halo(xyz, edges, mesh.size, halo_mod.min_halo(xyz, edges, mesh.size))
    stack = halo_mod.EquiStack(**kw, generator=torch.Generator().manual_seed(0)).to(device)
    s, v = halo_inputs(xyz.shape[0], kw["feat_dim"])

    def block(a):
        return torch.as_tensor(plan.block(plan.pad(a), mesh.rank)).to(device)

    s_b, v_b, xyz_b = block(s), block(v), block(xyz)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    sync()
    t = time.perf_counter()
    so, vo = halo_mod.halo_stack_apply(stack, s_b, v_b, xyz_b, plan, mesh)
    loss = (so ** 2).sum() + (vo ** 2).sum()
    grads = torch.cat([g.reshape(-1) for g in torch.autograd.grad(loss, list(stack.parameters()))])
    all_reduce_(grads, mesh)
    sync()
    out["halo"] = {"s": so.detach().cpu().numpy(), "v": vo.detach().cpu().numpy(),
                   "grads": grads.cpu().numpy(), "halo": plan.halo, "shard": plan.shard_size,
                   "edges": int(plan.edge_mask[mesh.rank].sum()),
                   "seconds": time.perf_counter() - t,
                   "peak_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda else None}
    return out


def multigpu_phase(device: str = "cuda", batches=CAPTURE_BATCHES, steps: int = MULTIGPU_STEPS,
                   model_kw=None, n_frames: int = TRAIN_FRAMES, train_batch: int = TRAIN_BATCH,
                   halo_frame=None, dense=None) -> dict:
    """Multi-GPU training (A14) on one card. (a) One rank of an NCCL
    process group (gloo on the CPU) through ``Trainer(mesh=make_mesh())``:
    at each of ``batches`` a ``steps``-step captured epoch, its all-reduce
    in the graph, held bit for bit to the plain trainer's from the same
    weights and draws, then both timed in turns, with the bytes the
    collective moves per step. (b) MULTIGPU_RANKS spawned ranks sharing the
    card on gloo: MULTIGPU_TRAIN_STEPS f32 steps at ``train_batch`` against
    the one-rank run, ZeRO-1 against the replicated optimizer, the kernels'
    launches on each rank against their counts (none on the CPU, where the
    wrappers run their plain versions). (c) On the same ranks the
    halo stack on ``halo_frame`` = (xyz (N, 3), cutoff, n_rbf, activation,
    feat_dim) (default: the covid stand-in's first frame at the covid
    recipe's width and cutoff) against the unsharded ``EquiStack`` on the
    device, with each rank's peak memory. ``dense`` is the captured
    phase's summary, printed beside. Raises on any failed check; returns
    {"multigpu": the launches of (a) and of every rank in (b)}."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from coarsegrainingvae_tpu_torch.data.device import epoch_index_batches
    from coarsegrainingvae_tpu_torch.data.neighbors import radius_graph_frames
    from coarsegrainingvae_tpu_torch.models.dense_cgvae import DenseCGVAE
    from coarsegrainingvae_tpu_torch.parallel.halo import EquiStack, plan_halo
    from coarsegrainingvae_tpu_torch.parallel.launch import spawn_ranks
    from coarsegrainingvae_tpu_torch.parallel.mesh import Mesh
    from coarsegrainingvae_tpu_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    cuda = device == "cuda"
    model_kw = model_kw or {}

    def sync():
        if cuda:
            torch.cuda.synchronize()

    ds, dataset, _, _ = dipeptide_device_data(device, n_frames)
    total = dict.fromkeys(DENSE_PER_STEP, 0)
    model = dipeptide_model_cfg(**model_kw)
    per_step = {"fused_message": 2 * model.enc_nconv, "fused_message_vjp": 2 * model.enc_nconv,
                "fused_pseudo_message": model.dec_nconv, "fused_pseudo_vjp": model.dec_nconv}
    mesh = one_rank_mesh(device)
    single = Mesh(0, 1, None, None, torch.device(device))
    try:
        for bs in batches:
            cfg = train_cfg(bs, **model_kw)
            dds = dataset(bs * steps)
            idx = epoch_index_batches(dds.n_frames, bs, np.random.default_rng(1))
            runs = {}
            for label, on in (("plain", single), ("one rank", mesh)):
                tr = Trainer(DenseCGVAE(cfg.model, generator=torch.Generator().manual_seed(0)),
                             cfg, device=device, mesh=on)
                st = tr.init_state(ds.batch(np.arange(bs)))
                gen = torch.Generator(device=device).manual_seed(11)
                reset_counts()
                st, _ = tr._run_program(st, dds, idx, gen, True, tr.captures)
                launches = read_counts()
                prog = tr._programs[(id(dds), True)]
                runs[label] = dict(tr=tr, st=st, launches=launches, keys=prog.keys,
                                   metrics=prog.metrics[:steps].clone(), gen=gen.get_state(),
                                   tensors=[t.detach().clone() for t in state_tensors(st)])
            ref, got = runs["plain"], runs["one rank"]
            expect = {k: v * steps for k, v in per_step.items()}
            if got["launches"] != expect:
                raise RuntimeError(f"multigpu: one rank at batch {bs} launched "
                                   f"{got['launches']}, expected {expect}")
            for k in total:
                total[k] += got["launches"][k]
            exact = (torch.equal(ref["metrics"], got["metrics"])
                     and torch.equal(ref["gen"], got["gen"])
                     and all(torch.equal(a, b) for a, b in zip(ref["tensors"], got["tensors"])))
            rel = worst_rel(got["tensors"], ref["tensors"])
            n_params = sum(p.numel() for p in got["st"].params.values())
            # the all-reduced buffer: [gradient, loss, the loss terms]
            n_bytes = 4 * (n_params + 1 + len(got["keys"]) - 2)
            print(f"multigpu one {mesh.backend} rank, batch {bs}: {steps}-step epoch "
                  f"{'captured' if got['tr'].captures else 'in a loop'} with the all-reduce in the "
                  f"step, against the plain trainer from the same weights and draws: bit for bit "
                  f"{exact}, parameters and moments max|err|/max|ref| {rel:.3e}; launches "
                  f"{got['launches']}; the collective moves {n_bytes} bytes "
                  f"({n_bytes / 1e6:.1f} MB) per step", flush=True)
            if not exact and not rel <= TRAIN_RTOL:
                raise RuntimeError(f"multigpu: one rank disagrees with the plain trainer at "
                                   f"batch {bs}")
            timings = {"plain": [], "one rank": []}
            for label in ("plain", "one rank", "one rank", "plain"):
                r = runs[label]
                gen = torch.Generator(device=device).manual_seed(12)
                sync()
                t = time.perf_counter()
                r["st"], _ = r["tr"]._run_program(r["st"], dds, idx, gen, True, r["tr"].captures)
                sync()
                timings[label].append((time.perf_counter() - t) / steps * 1e3)
            beside = ""
            if dense is not None and bs in dense:
                beside = (f"; the captured phase, this call: "
                          f"{', '.join(f'{x:.3f}' for x in dense[bs][0])} ms/step")
            print(f"multigpu one rank, batch {bs}: "
                  f"{', '.join(f'{x:.3f}' for x in timings['one rank'])} ms/step against the plain "
                  f"trainer's {', '.join(f'{x:.3f}' for x in timings['plain'])} in turns{beside}",
                  flush=True)
            for r in runs.values():
                r["tr"].release_graphs()
            del runs, ref, got, dds
            if cuda:
                torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()

    # (b) the one-rank reference at f32 for the spawned ranks
    cfg = train_cfg(train_batch, compute_dtype="float32", **model_kw)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                             adam_moment_dtype="float32"))
    order = np.resize(np.random.default_rng(3).permutation(len(ds)),
                      train_batch * MULTIGPU_TRAIN_STEPS)
    tr = Trainer(DenseCGVAE(cfg.model, generator=torch.Generator().manual_seed(0)), cfg,
                 device=device, mesh=single)
    st = tr.init_state(ds.batch(order[:train_batch]))
    gen = torch.Generator(device=device).manual_seed(21)
    for i in range(MULTIGPU_TRAIN_STEPS):
        st, _ = tr.train_step(st, ds.batch(order[i * train_batch:(i + 1) * train_batch]
                                           ).to(device), gen)
    ref_path = MULTIGPU_DIR / "one_rank_params.pt"
    torch.save({k: p.detach().cpu() for k, p in st.params.items()}, ref_path)
    del tr, st

    # (c) the unsharded halo stack on the device
    if halo_frame is None:
        recipe = json.loads((COVID_RECIPE / "covid2_modelparams.json").read_text())["model"]
        (_, frames, _), _ = covid_frames(device)
        halo_frame = (frames[0], recipe["atom_cutoff"], recipe["n_rbf"], recipe["activation"],
                      recipe["n_basis"])
    xyz, cutoff, n_rbf, activation, feat_dim = halo_frame
    xyz = np.asarray(xyz, np.float32)
    e, emask = radius_graph_frames(xyz[None], cutoff)
    edges = e[0][emask[0]]
    kw = dict(n_conv=HALO_LAYERS, feat_dim=feat_dim, n_rbf=n_rbf, activation=activation,
              cutoff=cutoff)
    stack = EquiStack(**kw, generator=torch.Generator().manual_seed(0)).to(device)
    s, v = halo_inputs(xyz.shape[0], feat_dim)
    s_ref, v_ref = stack(*(torch.as_tensor(a).to(device) for a in (s, v, xyz)),
                         torch.as_tensor(edges, dtype=torch.long).to(device))
    loss = (s_ref ** 2).sum() + (v_ref ** 2).sum()
    g_ref = torch.cat([g.reshape(-1) for g in torch.autograd.grad(loss, list(stack.parameters()))])
    s_ref, v_ref, g_ref = (t.detach().cpu().numpy() for t in (s_ref, v_ref, g_ref))
    del stack

    store = MULTIGPU_DIR / f"store_ranks_{os.getpid()}"
    store.unlink(missing_ok=True)
    t = time.perf_counter()
    ranks = spawn_ranks(multigpu_rank, MULTIGPU_RANKS, str(store),
                        (device, cfg, ds, order, MULTIGPU_TRAIN_STEPS, str(ref_path),
                         (xyz, edges, kw)), backend="gloo", threads=2)
    spawn_s = time.perf_counter() - t
    expect = {k: v * 2 * MULTIGPU_TRAIN_STEPS * cuda for k, v in per_step.items()}
    n_params = sum(np.prod(p.shape) for p in torch.load(ref_path, weights_only=True).values())
    for r in ranks:
        print(f"multigpu rank {r['rank']} of {MULTIGPU_RANKS} sharing the {device} on "
              f"{r['transport']}: {MULTIGPU_TRAIN_STEPS} f32 steps at batch {train_batch} "
              f"(its {train_batch // MULTIGPU_RANKS} rows) against the one-rank run, "
              f"max|err|/max|ref| {r['dp_err']:.3e}; ZeRO-1 against the replicated optimizer: "
              f"bit for bit {r['zero_equal']}, {r['zero_err']:.3e}, moments "
              f"{r['zero_moments']} of {n_params} (replicated {r['moments']}); "
              f"{', '.join(f'{x:.1f}' for x in r['ms'])} ms/step replicated, "
              f"{', '.join(f'{x:.1f}' for x in r['zero_ms'])} ZeRO-1; launches {r['launches']}",
              flush=True)
        if not r["dp_err"] <= TRAIN_RTOL or not r["zero_err"] <= TRAIN_RTOL:
            raise RuntimeError(f"multigpu: rank {r['rank']} disagrees with the one-rank run")
        if r["zero_moments"] != -(-n_params // MULTIGPU_RANKS) or r["moments"] != n_params:
            raise RuntimeError(f"multigpu: rank {r['rank']} holds {r['zero_moments']} moments")
        if r["launches"] != expect:
            raise RuntimeError(f"multigpu: rank {r['rank']} launched {r['launches']}, "
                               f"expected {expect}")
        for k in total:
            total[k] += r["launches"][k]
    h = ranks[0]["halo"]
    plan = plan_halo(xyz, edges, MULTIGPU_RANKS, h["halo"])
    s_h = np.concatenate([r["halo"]["s"] for r in ranks])[plan.inv_order]
    v_h = np.concatenate([r["halo"]["v"] for r in ranks])[plan.inv_order]
    errs = tuple(worst_rel([torch.as_tensor(a)], [torch.as_tensor(b)])
                 for a, b in ((s_h, s_ref), (v_h, v_ref), (h["grads"], g_ref)))
    print(f"multigpu halo stack, {MULTIGPU_RANKS} ranks on {device}: {xyz.shape[0]} atoms, "
          f"{len(edges)} edges (cutoff {cutoff}), F {feat_dim}, {HALO_LAYERS} layers; slabs of "
          f"{h['shard']} atoms, halo {h['halo']}; against the unsharded EquiStack: s "
          f"{errs[0]:.3e}, v {errs[1]:.3e}, parameter gradients {errs[2]:.3e} "
          f"(max|err|/max|ref|); per rank " + ", ".join(
              f"rank {r['rank']} {r['halo']['edges']} edges, {r['halo']['seconds']:.3f} s, peak "
              + (f"{r['halo']['peak_gb']:.3f} GB" if r['halo']['peak_gb'] is not None else "n/a")
              for r in ranks), flush=True)
    if not max(errs) <= HALO_RTOL:
        raise RuntimeError("multigpu: the halo stack disagrees with the unsharded stack")
    print(f"multigpu: {spawn_s:.1f} s for the spawned ranks, {time.perf_counter() - t_phase:.1f} s "
          f"for the phase", flush=True)
    return {"multigpu": total}


def tensor_rank(device: str, cfg, ds, order, n_steps: int, ref_path: str) -> dict:
    """One rank of the tensor phase's spawned ranks (gloo): the dense
    model on the ('data', 'model') mesh of ``cfg.parallel.model_devices``,
    ``n_steps`` steps over ``ds``'s global batches in ``order`` against the
    one-rank parameters at ``ref_path``; what the parent checks."""
    import numpy as np
    import torch

    from coarsegrainingvae_tpu_torch.models.dense_cgvae import DenseCGVAE
    from coarsegrainingvae_tpu_torch.parallel.mesh import make_mesh
    from coarsegrainingvae_tpu_torch.train.trainer import Trainer

    cuda = device == "cuda"
    mesh = make_mesh(model_devices=cfg.parallel.model_devices, device=device)
    tr = Trainer(DenseCGVAE(cfg.model, generator=torch.Generator().manual_seed(0)), cfg,
                 device=device, mesh=mesh)
    bs = cfg.data.batch_size
    st = tr.init_state(ds.batch(order[:bs]))
    gen = torch.Generator(device=device).manual_seed(21)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    ms = []
    for i in range(n_steps):
        batch = ds.batch(order[i * bs:(i + 1) * bs]).to(device)
        if cuda:
            torch.cuda.synchronize()
        t = time.perf_counter()
        st, m = tr.train_step(st, batch, gen)
        if cuda:
            torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        if float(m["grad_ok"]) != 1.0:
            raise RuntimeError(f"rank {mesh.rank}: step {i} was rejected")
    launches = read_counts()
    ref = torch.load(ref_path, weights_only=True)
    shards = tr.shards(st)
    blocks = [mod.feature_split for mod in tr.model.modules()
              if getattr(mod, "feature_split", None) is not None]
    return {"rank": mesh.rank, "mesh": mesh.shape, "transport": mesh.transport, "ms": ms,
            "launches": launches,
            "err": worst_rel([st.params[k] for k in ref], [ref[k] for k in ref]),
            "features": sorted({(b.lo, b.hi) for b in blocks}), "blocks": len(blocks),
            "shards": len(shards), "shard_bytes": sum(t.numel() * t.element_size()
                                                     for t in shards.values()),
            "moments": st.opt_state.mu.numel(),
            "moment_bytes": 2 * st.opt_state.mu.numel() * st.opt_state.mu.element_size(),
            "param_bytes": int(np.sum([p.numel() * p.element_size()
                                       for p in st.params.values()])),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda else None}


def tensor_phase(device: str = "cuda", model_kw=None, n_frames: int = TRAIN_FRAMES,
                 train_batch: int = TRAIN_BATCH, mesh_shape=TENSOR_MESH) -> dict:
    """Tensor parallelism (A14b) on one card: data * model gloo ranks
    sharing it on a ('data', 'model') mesh (NCCL refuses two ranks on one
    device), the dipeptide at full width, f32: MULTIGPU_TRAIN_STEPS steps
    at ``train_batch`` against the one-rank run, each rank's kernel
    launches against the count worked out from the model (every message
    layer on the rank's F/m features), its shards, moments and peak
    memory. Raises on any failed check; returns {"tensor": the ranks'
    launches, summed}."""
    import dataclasses

    import numpy as np
    import torch

    from coarsegrainingvae_tpu_torch.config import ParallelConfig
    from coarsegrainingvae_tpu_torch.models.dense_cgvae import DenseCGVAE
    from coarsegrainingvae_tpu_torch.parallel.launch import spawn_ranks
    from coarsegrainingvae_tpu_torch.parallel.mesh import Mesh
    from coarsegrainingvae_tpu_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    cuda = device == "cuda"
    data, model = mesh_shape
    ds, _, _, _ = dipeptide_device_data(device, n_frames)
    cfg = train_cfg(train_batch, compute_dtype="float32", **(model_kw or {}))
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                             adam_moment_dtype="float32"))
    order = np.resize(np.random.default_rng(3).permutation(len(ds)),
                      train_batch * MULTIGPU_TRAIN_STEPS)
    tr = Trainer(DenseCGVAE(cfg.model, generator=torch.Generator().manual_seed(0)), cfg,
                 device=device, mesh=Mesh(0, 1, None, None, torch.device(device)))
    st = tr.init_state(ds.batch(order[:train_batch]))
    gen = torch.Generator(device=device).manual_seed(21)
    ref_ms = []
    for i in range(MULTIGPU_TRAIN_STEPS):
        batch = ds.batch(order[i * train_batch:(i + 1) * train_batch]).to(device)
        if cuda:
            torch.cuda.synchronize()
        t = time.perf_counter()
        st, _ = tr.train_step(st, batch, gen)
        if cuda:
            torch.cuda.synchronize()
        ref_ms.append((time.perf_counter() - t) * 1e3)
    TENSOR_DIR.mkdir(parents=True, exist_ok=True)
    ref_path = TENSOR_DIR / "one_rank_params.pt"
    torch.save({k: p.detach().cpu() for k, p in st.params.items()}, ref_path)
    n_params = sum(p.numel() for p in st.params.values())
    del tr, st
    if cuda:
        torch.cuda.empty_cache()

    tp = dataclasses.replace(cfg, parallel=ParallelConfig(model_devices=model))
    store = TENSOR_DIR / f"store_{os.getpid()}"
    store.unlink(missing_ok=True)
    t = time.perf_counter()
    ranks = spawn_ranks(tensor_rank, data * model, str(store),
                        (device, tp, ds, order, MULTIGPU_TRAIN_STEPS, str(ref_path)),
                        backend="gloo", threads=2)
    spawn_s = time.perf_counter() - t
    m = cfg.model
    per_step = {"fused_message": 2 * m.enc_nconv, "fused_message_vjp": 2 * m.enc_nconv,
                "fused_pseudo_message": m.dec_nconv, "fused_pseudo_vjp": m.dec_nconv}
    expect = {k: v * MULTIGPU_TRAIN_STEPS * cuda for k, v in per_step.items()}
    f = m.n_basis // model
    total = dict.fromkeys(DENSE_PER_STEP, 0)
    for r in ranks:
        print(f"tensor rank {r['rank']} of mesh {r['mesh']} (data, model) sharing the {device} on "
              f"{r['transport']}: {r['blocks']} message blocks on features {r['features']} "
              f"(F/m {f}), {MULTIGPU_TRAIN_STEPS} f32 steps at batch {train_batch} against the "
              f"one-rank run, max|err|/max|ref| {r['err']:.3e}; "
              f"{', '.join(f'{x:.1f}' for x in r['ms'])} ms/step (one rank "
              f"{', '.join(f'{x:.1f}' for x in ref_ms)}); {r['shards']} sharded tensors, "
              f"{r['shard_bytes'] / 1e6:.1f} MB of shards; moments {r['moments']} of "
              f"{n_params} ({r['moment_bytes'] / 1e6:.1f} MB); gathered parameters "
              f"{r['param_bytes'] / 1e6:.1f} MB; peak "
              + (f"{r['peak_gb']:.3f} GB" if r["peak_gb"] is not None else "n/a")
              + f"; launches {r['launches']}", flush=True)
        if not r["err"] <= TRAIN_RTOL:
            raise RuntimeError(f"tensor: rank {r['rank']} disagrees with the one-rank run")
        if r["mesh"] != (data, model) or r["blocks"] != sum(per_step.values()) // 2 \
                or len(r["features"]) != 1 or r["features"][0][1] - r["features"][0][0] != f:
            raise RuntimeError(f"tensor: rank {r['rank']} split {r['blocks']} blocks over "
                               f"{r['features']}, expected F/m {f}")
        if not r["shards"] or r["moments"] >= n_params:
            raise RuntimeError(f"tensor: rank {r['rank']} holds {r['moments']} moments")
        if r["launches"] != expect:
            raise RuntimeError(f"tensor: rank {r['rank']} launched {r['launches']}, "
                               f"expected {expect}")
        for k in total:
            total[k] += r["launches"][k]
    print(f"tensor: {spawn_s:.1f} s for the spawned ranks, {time.perf_counter() - t_phase:.1f} s "
          f"for the phase", flush=True)
    return {"tensor": total}


def load_example(name: str):
    """``examples/<name>.py`` as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, Path(__file__).resolve().parent / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def examples_phase(device: str = "cuda", kernel_f: int = 600, n_basis: int = 600,
                   ab_n_basis: int = 128, quick_ndata: int = 400,
                   kernel_steps: int = EXAMPLES_KERNEL_STEPS, epochs: int = EXAMPLES_EPOCHS,
                   flagship_steps: int = EXAMPLES_FLAGSHIP_STEPS) -> dict:
    """The JAX repo's example tools on the port, each through its importable
    functions: the kernel shape table at its seven shapes (``--f``
    ``kernel_f``; each row's kernels checked against the plain version
    inside the tool, timed, no ``--compile``), the quickstart cut to
    ``epochs`` epochs, the census on its test reconstructions, the A/B
    harness on EXAMPLES_AB_VARIANTS cut to ``epochs`` epochs, and the
    ablation's step and parts (``--only step,parts``) at the flagship width.
    Raises on a failed check; returns {"examples": the kernels' launches}."""
    import contextlib
    import math

    import numpy as np

    from coarsegrainingvae_tpu_torch.utils.xyz import write_xyz

    t_phase = time.perf_counter()
    shutil.rmtree(EXAMPLES_DIR, ignore_errors=True)
    EXAMPLES_DIR.mkdir(parents=True)
    dipeptide_data(device, CV_FRAMES)
    reset_counts()
    seconds, results = {}, {}

    def finite(*xs) -> bool:
        return all(x is not None and math.isfinite(x) for x in xs)

    t = time.perf_counter()
    rows = load_example("profile_kernels_torch").main(
        ["--steps", str(kernel_steps), "--f", str(kernel_f), "--device", device])
    kernel_rows = [r for r in rows if "_pallas_" in r["label"]]
    if len(rows) != 14 or not all(finite(r["ms_per_step"], r["plain_ms"]) and
                                  r["max_rel_err"] <= KERNEL_RTOL for r in kernel_rows):
        raise RuntimeError(f"examples: the kernel shape table failed: {rows}")
    results["profile_kernels"] = rows
    seconds["profile_kernels"] = time.perf_counter() - t

    t = time.perf_counter()
    res = load_example("quickstart_torch").run(str(EXAMPLES_DIR / "quickstart"), quick_ndata,
                                                epochs, device)
    n_atoms = len(res.data.z)
    if not (finite(res.recon["all_atom_rmsd"], res.recon["heavy_atom_rmsd"])
            and res.ensemble.shape == (8, n_atoms, 3) and np.isfinite(res.ensemble).all()
            and np.isfinite(res.samples["sample_xyzs"]).all()
            and (EXAMPLES_DIR / "quickstart" / "ensemble.xyz").stat().st_size > 0):
        raise RuntimeError("examples: the quickstart's outputs are not finite or misshapen")
    recon_path = EXAMPLES_DIR / "quickstart" / "test_recon.xyz"
    write_xyz(str(recon_path), res.recon["recon_xyzs"], res.data.z)
    results["quickstart"] = {"rmsd": res.recon["all_atom_rmsd"],
                             "heavy_rmsd": res.recon["heavy_atom_rmsd"],
                             "ensemble": list(res.ensemble.shape),
                             "val_recon": res.history[-1]["val_recon"]}
    seconds["quickstart"] = time.perf_counter() - t

    t = time.perf_counter()
    with open(EXAMPLES_DIR / "census.json", "w") as f, contextlib.redirect_stdout(f):
        rep = load_example("validity_census_torch").main(
            ["-xyz", str(recon_path), "-dataset", "dipeptide", "-ndata", str(quick_ndata),
             "-seed", "0"])
    if rep["frames"] != len(res.data.test) or not 0.0 <= rep["all_valid_ratio"] <= 1.0:
        raise RuntimeError(f"examples: the census read {rep['frames']} frames")
    results["census"] = {k: rep[k] for k in ("frames", "all_valid_ratio", "heavy_valid_ratio")}
    seconds["census"] = time.perf_counter() - t

    t = time.perf_counter()
    ab = load_example("accuracy_ab_torch").main(
        ["--variants", EXAMPLES_AB_VARIANTS, "--epochs", str(epochs), "--n_basis",
         str(ab_n_basis), "--device", device])
    if [r["variant"] for r in ab] != EXAMPLES_AB_VARIANTS.split(",") or not all(
            r["epochs_ran"] == epochs and finite(r["test_rmsd_all_atom"], r["final_val_loss"])
            for r in ab):
        raise RuntimeError(f"examples: the A/B rows failed: {ab}")
    results["accuracy_ab"] = ab
    seconds["accuracy_ab"] = time.perf_counter() - t

    t = time.perf_counter()
    fl = load_example("profile_flagship_torch").main(
        ["--only", "step,parts", "--steps", str(flagship_steps), "--device", device],
        n_basis=n_basis)
    labels = [r["label"] for r in fl]
    if labels != ["shape", "train_step_full", "value_and_grad", "forward_loss"] or not all(
            finite(r["ms_per_step"]) for r in fl[1:]) or not finite(fl[1]["loss"]):
        raise RuntimeError(f"examples: the ablation rows failed: {fl}")
    results["profile_flagship"] = fl
    seconds["profile_flagship"] = time.perf_counter() - t

    counts = read_counts()
    if min(counts.values()) == 0:
        raise RuntimeError(f"examples: a kernel was not launched on this path: {counts}")
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "examples_smoke.json").write_text(json.dumps(
        {"results": results, "seconds": seconds, "launches": counts}, indent=1))
    print(f"examples: {time.perf_counter() - t_phase:.1f} s for the phase "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in seconds.items())}); quickstart "
          f"{epochs} epochs recon RMSD {res.recon['all_atom_rmsd']:.3f} A; census "
          f"{rep['frames']} frames, all-atom valid {rep['all_valid_ratio']:.3f}; launches "
          f"{counts}", flush=True)
    return {"examples": counts}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one GPU", file=sys.stderr)
        return 1
    try:
        from coarsegrainingvae_tpu_torch.ops import cuda_build
        from coarsegrainingvae_tpu_torch.ops import fused_message as message_ops
        from coarsegrainingvae_tpu_torch.ops import fused_pseudo as pseudo_ops
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 1

    print(card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    seconds = {}

    def phase(name, fn, *args, **kwargs):
        t = time.perf_counter()
        out = fn(*args, **kwargs)
        seconds[name] = round(time.perf_counter() - t, 1)
        return out

    # one nvcc per source, together, while the phases that launch none of
    # the four kernels run on the card (their launch counts stay 0)
    t0 = time.perf_counter()
    paths = {}
    with ThreadPoolExecutor(2) as pool:
        builds = [pool.submit(ops.build) for ops in (message_ops, pseudo_ops)]
        phase("cgae", cgae_phase)
        phase("native", native_phase)
        paths.update(phase("pcn", pcn_phase))
        paths.update(phase("covid", covid_phase))
        paths.update(phase("diffpool", diffpool_phase))
        paths.update(phase("baseline", baseline_phase))
        for b in builds:
            b.result()
    print(f"build: both kernel sources ready {time.perf_counter() - t0:.2f} s after the start, "
          f"beside the phases that launch no kernel (nvcc: "
          f"{', '.join(f'{k} {v:.2f} s' for k, v in cuda_build.BUILD_SECONDS.items())})",
          flush=True)
    for source, log in cuda_build.BUILD_LOG.items():
        print_ptxas(source, log)

    timed = phase("kernels", check_kernels)
    paths["serve"] = phase("serve", serve)
    paths.update(phase("train", train))
    reset_counts()
    paths["captured"], dense = phase("captured", captured)
    paths.update(phase("cv", cv))
    paths.update(phase("runfiles", runfiles_phase))
    paths.update(phase("steric", steric, dense))
    paths.update(phase("sparse", sparse, dense))
    paths.update(phase("hpo", hpo_phase))
    paths.update(phase("multigpu", multigpu_phase, dense=dense))
    paths.update(phase("tensor", tensor_phase))
    paths.update(phase("examples", examples_phase))
    print(f"phase seconds: {seconds}; {time.perf_counter() - t0:.1f} s in all", flush=True)

    source = "coarsegrainingvae_tpu_torch/csrc/"
    rows = {"message": ("fused_message", "fused_message.cu", "pallas_message.py:126"),
            "message_vjp": ("fused_message_vjp", "fused_message.cu", "pallas_message.py:202"),
            "pseudo": ("fused_pseudo_message", "fused_pseudo.cu", "pallas_pseudo.py:192"),
            "pseudo_vjp": ("fused_pseudo_vjp", "fused_pseudo.cu", "pallas_pseudo.py:210")}
    kernels = []
    for t in timed:                             # one entry per (kernel, timed shape)
        name, src, tpu = rows[t["kind"]]
        by_path = {path: counts[name] for path, counts in paths.items()}
        kernels.append({
            "name": name, "shape": t["shape"], "route": "cuda", "source": source + src,
            "replaces": "coarsegrainingvae_tpu/ops/" + tpu,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": t["max_abs_err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "bound_resource": t["bound_resource"], "share": t["share"],
            "library_ms": None, "library_note": LIBRARY_NOTE})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
