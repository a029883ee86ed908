"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own line(s); any failure exits non-zero:
  1. device: refuse to run without CUDA; print torch/CUDA versions and the
     card's name and power limit (nvidia-smi);
  2. build: compile the port's CUDA kernels from csrc/*.cu;
  3. kernels: each chamfer kernel against its plain PyTorch version at the
     flagship shapes (B=32, P=20, N=1000), part counts drawn from the
     everyday mix: distances bit for bit, witnesses exactly, gradients
     bit for bit against the plain version on the CPU and within a stated
     tolerance of it on the card.  B1/B3 (one kernel, both directions a
     launch) and B2/B4 (one kernel, both directions a launch, with dy and
     dx only) also on [20] * 8, on tie-heavy clouds (a 1/64 grid with
     duplicated points), on fully overlapping parts, on parts spread over
     [-2, 2]^3 and on collapsed parts (the second cloud's parts shrunk to
     4 points each); in the whole-shape mode the pruned part-pair list
     against the dense list (the main path's), bit for bit, and the card's
     keep rule against the plain one, which must drop pairs of the spread
     parts; both lists and both backward forms timed on the everyday mix,
     the spread and the collapsed parts, with pairs a second, the share of
     the bound and each kernel's device time behind one call
     (torch.profiler).  The unfused route's kernel
     (B8) also in the B*P one-part diagonal form, and against B1 on the
     same clouds (witnesses renumbered), both timed; the reference API's
     kernel (B7) on one repulsion scan row (640 clouds, 1000 points against
     1000) and on 32 clouds of 1000 against 2500 points.  Then both
     sampling kernels (dense, and chunked on the table's face-major
     records, whose bytes and build time are printed) against their plain
     versions on the synthetic everyday set's tables and on a ragged set of
     triangle soups, at an everyday batch's row count and at the dense
     bound K = B*P: points bit for bit, face draws exactly, and dense equal
     to chunked; their times with the L2 flushed before each launch (the
     kernels line's) and warm, beside two floor probes launched on the same
     grid: an empty kernel, and one that only reads the uniforms and writes
     the points.  B2/B4 launched three times on each input kind, both forms,
     with either cotangent null too: bitwise equal every time, and bitwise
     equal to the plain version on the CPU.
     Kernel and plain times from CUDA events, each beside its bound (the
     larger of its operations over the card's peak and its bytes over the
     memory rate; the samplers' bytes counted on the run's draws); a
     kernel timed under its bound fails the run.  Then L1 (phase_lap,
     csrc/matching.cu, the linear assignment of semantic matching) against
     its plain version on the card, identical assignments required, and
     against scipy's optimum (objective within 1e-6 relative), on a
     semantic batch's block-masked costs (M = S x B = 160 and M = B = 32,
     n = 20), random and tie-heavy costs at n = 20, 2, 3 and 32; kernel and
     plain times by CUDA events at the main path's shapes.  Then L2
     (phase_lap_cost, csrc/matching.cu, the block-masked LAP cost) against
     the plain masked cost on the five subsamples of a semantic batch (B =
     32, n = 100): in-group entries within the card tests' tolerance, the
     rest exactly, two launches bitwise, L1's assignments on both costs
     equal but on a near-tie; its time beside its bound (the in-group point
     pairs) and the plain version's.  Then the masked
     batch norm's kernels (phase_masked_bn, csrc/masked_bn.cu) at the
     flagship PointNet's five layers against the plain version: the
     moments within 1e-6, the apply bit for bit, dx within 2^-8, d(weight)
     and d(bias) within 1e-4; each direction's time on device work alone
     beside its bytes bound, the plain version's and the library's batch
     norm's over the compacted valid rows (library_ms).  Then the
     PointNet's max-pool kernels (phase_max_pool, csrc/max_pool.cu) at the
     PN-Transformer's and RGL-Net's widths: the max, its tie count and dx
     bit for bit the plain version's on the card; each direction's time
     beside its bytes bound, the plain version's and the library's
     `torch.amax` then cast (library_ms);
  4. slice: one PN-Transformer MoN loss and its gradients on the card
     against the same step on the CPU (plain chamfer), same weights, with
     the quaternion and with the 6D pose head, and the eval logs of the
     same batch with the full metric set, card against CPU (Euler metrics
     within 1e-3 degrees, the rest within 1e-5); then repulsion_cd_loss
     forward and backward at flagship shapes through B7, its scan route
     against its dense route, the kernel against the plain version on the
     card, and the card against the CPU at a small size.  The launch
     counters are reset just before the repulsion runs and read just
     after: they give B7's launches.  The same MoN check for each other
     geometric family (Global, LSTM, DGL, RGL-Net, PN-Transformer-Refine,
     Identity) on its everyday config at published width, LSTM's and
     RGL-Net's draws made on the host and given to both sides.  The
     semantic slice: one MoN step (S = 5) of the partnet_chair
     PN-Transformer at full width on two shapes of a synthetic PartNet
     set, card against CPU with the head noise and the match subsamples
     given to both (loss 1e-4, gradients 1e-3 relative L2), and its eval
     logs (losses, part_acc, connectivity_acc) within 1e-5 on flag-first
     contact matrices, connectivity_acc above 0;
  5. main path: scripts/train_torch.py's main on the flagship config at
     full width on a synthetic everyday set, runs of three epochs (12
     steps of batch 32) and a validation each: the host wire
     (data.device_sampling False), the device-sampling wire with the auto
     table layout, with the dense layout, the host wire again (one epoch,
     to make room for phase 8), and the dense layout through the unfused
     chamfer route (fused mode 'off');
     then a sixth run of one epoch with the 6D pose head.  Each run resets
     the launch counters and requires its route's kernels to have launched
     in training and in validation, and the other route's never, and the
     masked batch norm's kernels 5 times (moments, apply, backward) a
     traced train step body and never in validation (eval mode), and the
     max-pool's once forward and once backward a traced train step body
     and forward alone in validation; each
     gates the full val metric set and its one checkpoint, and prints the
     checkpoint's save time on the training thread, its writer's time and
     the val export's.  Every host batch is placed on the loaders'
     placement thread; the host-wire runs ship packed f16 rows, exactly K
     of them, and each run prints its bytes a batch beside its data wait;
  6. resume: the flagship on the dense slot wire, fused route, 2 epochs
     with a validation and a checkpoint each (counters reset just before,
     read at the end): scripts/test_torch.py from the second checkpoint
     bitwise against the trainer's test(); a new Trainer on the same
     ckp_dir starts at epoch 2 with every parameter, buffer and Adam
     moment bitwise; the checkpoint loads into a CPU trainer, whose save
     loads back onto the card, bitwise; one more epoch in both trainers
     from the same generator states gives bitwise the same losses and
     weights.  Save, resume and val-export times printed;
  7. families: scripts/train_torch.py's main on each other family's
     everyday config at published width, one epoch (4 steps of batch 32)
     on the dense slot wire, a validation and a checkpoint each; the
     counters reset before each run, B1-B4 must launch exactly T times a
     train step (T = 3 for DGL, RGL-Net and Refine, which supervise every
     iteration; identity launches B1 and B3 and never B2/B4), the dense
     sampler once a batch, and B7, B8 and the chunked sampler never; step
     time, data wait, peak memory, and one torch.profiler run of two more
     steps (device kernels a step, device idle share); then DGL trains 2
     epochs, resumes and trains one more, bitwise as phase 6.  No
     geometric run launches L1;
  8. semantic: scripts/train_torch.py's main on the partnet_chair
     PN-Transformer config at full width (S = 5 MoN samples, 32-d noise)
     on a synthetic PartNet set (128 shapes of 2 to 20 parts of 1000
     points; 96 train, 32 val), three epochs (9 steps) and a validation
     with part_acc and connectivity_acc and a checkpoint, on the slot wire
     (the resident f16 table) and on the host wire; B1-B4 and L1 must
     launch exactly S x T times a train step and S x (1, 2, 1) times a val
     batch for B1, B3 and L1; step time, data wait, peak memory.  The
     slot-wire run then resumes (bitwise, as phase 6), and one
     torch.profiler run gives kernels a step, device idle, and the device
     time of L1 and of the LAP cost.  Each other family then trains one
     epoch on its partnet_chair config at published width on the slot
     wire, gated the same way (T = 3 for DGL, RGL-Net and Refine);
  9. encoders: the flagship config with DGCNN, PointNet++ SSG and MSG at
     full width.  One MoN step of each in f32 on one shape of the slice
     batch, card against CPU, the card given the CPU's kNN graphs, FPS
     samples and ball sets (how many rows differ when it makes its own is
     printed): loss 1e-4, gradients 1e-3 relative L2 plus twice the card
     gradient's movement under 1e-7/1e-6 nudges, DGCNN's gradients bitwise
     from one card run to the next, and the eval logs; then
     scripts/train_torch.py's main with each, one epoch (4 steps) at batch
     32 (MSG at 16 when 32 does not fit the card, said so) on the dense
     slot wire with a validation and a checkpoint, gated as phase 7 with
     T = 1 (PointNet++ SSG and MSG run eager steps, by train/step.py's
     rule: their activations do not fit the card twice); step time, data
     wait, peak memory, and one torch.profiler run
     of two steps: kernels a step, device idle, and the device and host
     time of the ranges knn, neighborhood_reduce (and _backward),
     furthest_point_sample and ball_query;
 10. ddp: data parallelism on two gloo ranks sharing the card (NCCL
     refuses two ranks on one device), each a subprocess of this script
     (`--ddp-rank`) with torchrun's variables and a timeout.  One
     flagship step at published width in f32, dropout off, split 2 x 16
     across the ranks against this process's step at 32 on the same
     weights and batch (loss 1e-4 relative, gradients 1e-3 relative L2;
     with sync batch norm against the whole batch, per-replica against
     JAX's per-group rule), both ranks' weights bitwise equal after Adam,
     B1-B4 once a rank; then scripts/train_torch.py's main on both ranks:
     the flagship at 16 a rank, one epoch on the dense slot wire, gated
     as phase 7, a validation whose metrics both ranks report
     identically, one checkpoint written by rank 0, a fresh Trainer on
     each rank resuming from it bitwise; printed, labelled "gloo, 2 ranks
     sharing one card": step time, data wait, the device and host time
     of the profiler range grad_all_reduce, and each rank's peak memory;
 11. graph: the compiled step (train/step.py) on the flagship's dense slot
     wire, host wire, chunked layout and unfused route and the semantic
     PN-Transformer's two wires, each at full width: 24 steps (the first
     alone, then groups of up to 8, exp.steps_per_call 8) replayed from
     one captured CUDA graph against as many eager steps from the same
     weights, batches and generator states: every logged value, parameter,
     buffer and Adam tensor bitwise after the first step and after the
     last (else the largest relative difference printed, held under
     1e-6; the unfused route under PyTorch's deterministic algorithms,
     whose index_add_ sorts where it would add by atomics); the
     wrapper launches exactly the traced step bodies' (two warm-up steps,
     undone, and the capture) and the sampler's once a batch; the kernels
     of a replayed step by torch.profiler (B1/B3's kernel 2 x S x T, B2
     and B4 S x T, L1 and L2 S x T, B8 4 x S x T on the unfused route); eager
     against graphed step time, device idle share, peak memory and capture
     seconds, beside the card's name and power limit.  The first groups
     place their batches on the training thread, so that the sampler
     counts once a dispatched batch; the last group, timed and profiled,
     takes the same batches as the loader's placement thread prepares
     them in an epoch;
 12. placement: on the host wire and both slot-wire layouts, two train
     batches prepared by the loader's placement thread (train/trainer.py
     `DevicePlacement`: the copy, the expansion, B5/B6) against the same
     host batches placed on the training thread, bitwise; the card's
     expansion of the f16 rows against the CPU's, bitwise; B5/B6 launched
     from the placement thread.  Then a graphed flagship trainer saves
     with its write held back while it replays two more steps: the
     checkpoint holds the state at the save, bitwise; the training
     thread's save time and the writer's time are printed.
Since the compiled step, every training run of phases 5-9 trains through
the graphed trainer (one rank on the card): each checks that every train
step was a replay of one capture; the launch counters count the traced
step bodies, not replays, so the exact gates of phases 7-9 read T (or
S x T) times the traced bodies, and torch.profiler counts the kernels of a
replayed step; phases 7 and 9 time eager against graphed steps on
batches placed by the loader's placement thread; the
resumed epochs of phases 6-8 run through the trainer's own (graphed)
epoch loop.  Phase 10's two ranks run eagerly.
The smoke prints its total wall time; the line before the last is a JSON
summary of the kernels; the last line is {"ok": true, "device": {...}}.
"""

import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
import types

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, 'scripts'))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# the H100's peaks (unfused f32, HBM3) and B1/B3's bound, counted in
# benchmark/harness/roofline.py
from benchmark.harness.roofline import (  # noqa: E402
    PAIR_OPS, PEAK_BYTES, PEAK_OPS, bound_s, pair_bound_s)
from multi_part_assembly_tpu_torch.datasets import \
    device_sampler as DS  # noqa: E402
from multi_part_assembly_tpu_torch.datasets import mesh_io  # noqa: E402
from multi_part_assembly_tpu_torch.datasets.mesh_io import \
    MeshSampler  # noqa: E402
from multi_part_assembly_tpu_torch.ops import chamfer as C  # noqa: E402
from multi_part_assembly_tpu_torch.ops import cuda_build  # noqa: E402
from multi_part_assembly_tpu_torch.ops import knn as KNN  # noqa: E402
from multi_part_assembly_tpu_torch.ops import \
    matching as LAP  # noqa: E402
from multi_part_assembly_tpu_torch.ops import \
    masked_bn as MBN  # noqa: E402
from multi_part_assembly_tpu_torch.ops import \
    max_pool as MP  # noqa: E402
from multi_part_assembly_tpu_torch.ops import \
    sampling as SMP  # noqa: E402
from multi_part_assembly_tpu_torch.train.step import (  # noqa: E402
    WARMUP_STEPS, uncapturable)
from multi_part_assembly_tpu_torch.utils import tracing  # noqa: E402

FLAGSHIP_CFG = os.path.join(
    ROOT, 'configs/pn_transformer/pn_transformer/'
    'pn_transformer-32x1-cosine_400e-everyday.py')
# everyday-like part-count mix of bench.py:125-126
PART_POOL = [2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 5, 5, 6, 6, 7, 8, 10, 12, 16, 20]
B, P, N = 32, 20, 1000
DATA_KEYS = ('part_ids', 'valid_matrix')
CHAMFER_CU = 'multi_part_assembly_tpu_torch/csrc/chamfer.cu'
SAMPLER_CU = 'multi_part_assembly_tpu_torch/csrc/device_sampler.cu'
MATCHING_CU = 'multi_part_assembly_tpu_torch/csrc/matching.cu'
MASKED_BN_CU = 'multi_part_assembly_tpu_torch/csrc/masked_bn.cu'
MAX_POOL_CU = 'multi_part_assembly_tpu_torch/csrc/max_pool.cu'
TPU = 'multi_part_assembly_tpu/ops/chamfer.py'
TPU_DS = 'multi_part_assembly_tpu/datasets/device_sampler.py'
# (name, launch counter, TPU computation it replaces, source): B1-B8 replace
# Pallas kernels; L1 (lap) the XLA solve `_solve_lap_single`; L2 (lap_cost)
# the XLA pair chamfer cost and its block mask
KERNELS = [
    ('chamfer_pair[parts]', 'nn_parts', f'{TPU}:483', CHAMFER_CU),
    ('chamfer_pair[diag]', 'nn_diag', f'{TPU}:556', CHAMFER_CU),
    ('chamfer_grad[parts]', 'bwd_parts', f'{TPU}:632', CHAMFER_CU),
    ('chamfer_grad[diag]', 'bwd_diag', f'{TPU}:687', CHAMFER_CU),
    ('sample_dense', 'sample_dense', f'{TPU_DS}:212', SAMPLER_CU),
    ('sample_chunked', 'sample_chunked', f'{TPU_DS}:269', SAMPLER_CU),
    ('nn_parts[off]', 'nn_off', f'{TPU}:284', CHAMFER_CU),
    ('nn_dir', 'nn_dir', f'{TPU}:110', CHAMFER_CU),
    ('lap', 'lap', 'multi_part_assembly_tpu/ops/matching.py:25', MATCHING_CU),
    ('lap_cost', 'lap_cost', 'none (XLA: the JAX package\'s '
     '_pair_chamfer_cost, multi_part_assembly_tpu/ops/matching.py:111)',
     MATCHING_CU),
    ('masked_bn[fwd]', 'bn_apply', 'none (XLA fuses the JAX package\'s '
     'models/modules/norm.py)', MASKED_BN_CU),
    ('masked_bn[bwd]', 'bn_backward', 'none (XLA fuses the JAX package\'s '
     'models/modules/norm.py)', MASKED_BN_CU),
    ('max_pool[fwd]', 'pool_fwd', 'none (XLA fuses the JAX package\'s '
     'PointNet pool, models/modules/encoders.py)', MAX_POOL_CU),
    ('max_pool[bwd]', 'pool_bwd', 'none (XLA fuses the JAX package\'s '
     'PointNet pool, models/modules/encoders.py)', MAX_POOL_CU),
]
# the flagship PointNet's batch-norm widths (3-64-64-64-128-256), each
# followed by a ReLU but the last
BN_WIDTHS = (64, 64, 64, 128, 256)
# the PointNet's pooled widths: the PN-Transformer's 256 (the kernels
# rows'), RGL-Net's 128
POOL_WIDTHS = (256, 128)
FUSED_KEYS = ('nn_parts', 'nn_diag', 'bwd_parts', 'bwd_diag')
# the kernels' counters `launch.<key>` (ops/cuda_build.py `launch`)
SAMPLER_KEYS = ('sample_dense', 'sample_chunked')
BN_KEYS = ('bn_moments', 'bn_apply', 'bn_backward')
POOL_KEYS = ('pool_fwd', 'pool_bwd')
LAUNCH_KEYS = FUSED_KEYS + ('nn_off', 'nn_dir') + SAMPLER_KEYS + \
    ('lap', 'lap_cost') + BN_KEYS + POOL_KEYS
# face counts of the ragged soup set: sub-chunk, exactly one chunk, many
RAGGED_FACES = [37, 512, 3000, 20000]
# B2/B4 add a row's terms in a fixed order, the plain version's on the CPU,
# where index_add_ adds in index order: the kernel must give its bits.  On
# the card the plain index_add_ adds by global atomics in a varying order,
# so there the kernel is held to |kernel - plain| <= GRAD_RTOL * max|plain|
# + GRAD_ATOL.
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-6
# B2/B4's two forms: (need_dy, label); the kernels line reports the first
BWD_FORMS = ((True, 'with dy'), (False, 'dx only'))
# B7 and B8 serve one direction a launch, and a chamfer launches them
# twice: each launch computes every pair's distance and one minimum,
# DIR_OPS operations a pair and a launch (B1/B3's PAIR_OPS count both
# directions from one distance).
DIR_OPS = 9


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: this smoke runs only on a GPU')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]
    print(f'device: torch {torch.__version__}, CUDA {torch.version.cuda}, '
          f'{torch.cuda.get_device_name(0)}, '
          f'{torch.cuda.device_count()} device(s)', flush=True)
    print(smi.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# Floor probes of the samplers, launched on their grid (one block of 256
# points a row and a 256-point slice): an empty kernel, and one that reads a
# point's three uniforms and writes them as its point (24 bytes a point, no
# table).  What they take cold, no sampler design can remove.
PROBE_CU = r'''
#include <cuda_runtime.h>

__global__ void probe_empty() {}

__global__ void probe_uniforms(const float* __restrict__ u,
                               float* __restrict__ out, int N) {
  const int n = blockIdx.y * 256 + threadIdx.x;
  if (n >= N) return;
  const long long p = (long long)blockIdx.x * N + n;
  const float* uk = u + p * 3 - 2 * n;
  const float u0 = __ldg(uk), u1 = __ldg(uk + N), u2 = __ldg(uk + 2 * N);
  out[p * 3] = u0;
  out[p * 3 + 1] = u1;
  out[p * 3 + 2] = u2;
}

extern "C" int probe_sampler(int mode, const float* u, float* out, int K,
                             int N, void* stream) {
  const dim3 grid(K, (N + 255) / 256);
  if (mode == 0)
    probe_empty<<<grid, 256, 0, (cudaStream_t)stream>>>();
  else
    probe_uniforms<<<grid, 256, 0, (cudaStream_t)stream>>>(u, out, N);
  return (int)cudaGetLastError();
}
'''
_probe_lib = None


def phase_build(tmp):
    """The port's kernels, with the floor probes compiled beside them."""
    global _probe_lib
    import ctypes
    src, lib = os.path.join(tmp, 'probe.cu'), os.path.join(tmp, 'probe.so')
    with open(src, 'w') as f:
        f.write(PROBE_CU)
    probe = subprocess.Popen(
        [cuda_build._nvcc(), '-shared', *cuda_build.NVCC_FLAGS, src, '-o',
         lib], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        cuda_build.load_library()
        _, err = probe.communicate(timeout=600)
    finally:
        probe.kill()
    if probe.returncode != 0:
        raise RuntimeError(f'nvcc failed on the floor probes:\n{err}')
    _probe_lib = ctypes.CDLL(lib)
    _probe_lib.probe_sampler.restype = ctypes.c_int
    _probe_lib.probe_sampler.argtypes = [ctypes.c_int] + \
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    print(f'build: {cuda_build.build_seconds():.2f} s '
          f'(nvcc {" ".join(cuda_build.NVCC_FLAGS)})', flush=True)


def _probe(mode, u, out):
    rc = _probe_lib.probe_sampler(mode, u.data_ptr(), out.data_ptr(),
                                  u.shape[0], u.shape[-1],
                                  torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f'probe_sampler: CUDA error {rc}')


def _cuda_ms(fn, iters):
    """Mean device milliseconds of fn() over `iters` runs, by CUDA events.
    The runs queue up behind a device sleep of about 25 ms, so a kernel
    shorter than its own launch cost is timed on the device, not at the
    host's enqueue rate."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _cold_ms(fn, iters):
    """Mean device milliseconds of fn() with a cold L2: before each run a
    256 MB buffer is written (the H100's L2 holds 50 MB), and each run is
    timed alone by its own CUDA events, all queued behind a device sleep.
    What a kernel costs when its inputs come from HBM, as a train step's
    table reads do."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device='cuda')
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(50_000_000)
    for start, end in events:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def _call_ms(fn, iters):
    """Mean host milliseconds per call of fn(), synchronised at the end:
    what one call costs a caller that launches it once per step."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return 1000.0 * (time.perf_counter() - t0) / iters


def _bound(ops=0.0, nbytes=0.0):
    """(bound_ms, bound_by): `bound_s` in milliseconds, the least time the
    card could take for `ops` operations and `nbytes` bytes."""
    s, by = bound_s(ops, nbytes)
    return 1e3 * s, by


def _pair_bound(pairs, b):
    """`pair_bound_s` in milliseconds: a B1/B3 launch over `pairs` point
    pairs of a [b, P, N] batch."""
    s, by = pair_bound_s(pairs, b, P, N)
    return 1e3 * s, by


def _dir_bound(pairs, points):
    """Bound of the two launches of a one-direction nearest neighbour (B7,
    B8), each over `pairs` point pairs: DIR_OPS operations a pair and a
    launch; bytes: each launch reads both clouds (`points` points in all,
    12 bytes each) and writes a distance and an index (8 bytes) for each
    of its queries, which are one cloud's points."""
    return _bound(2 * DIR_OPS * pairs, 2 * 12 * points + 8 * points)


def _clouds(counts, seed, kind='everyday'):
    """Two posed part clouds [B, P, N, 3]: each part a 0.1-scale cloud
    around a centre in [-0.4, 0.4]^3, the second a jittered copy.  'ties':
    both on a 1/64 grid, with every fourth point duplicated, so that exact
    distance ties abound; 'overlap': every centre at 0, so that no part
    pair can be pruned; 'spread': centres in [-2, 2]^3, so that pruning
    drops the pairs of distant parts; 'collapsed': every part of the second
    cloud shrunk to its first 4 points, so that the witnesses of both
    directions crowd onto a few points (the backward's worst contention)."""
    g = torch.Generator(device='cuda').manual_seed(seed)
    b = len(counts)
    centres = (torch.rand((b, P, 1, 3), generator=g, device='cuda') - 0.5) \
        * (4.0 if kind == 'spread' else 0.8)
    if kind == 'overlap':
        centres.zero_()
    x = centres + 0.1 * torch.randn((b, P, N, 3), generator=g, device='cuda')
    y = x + 0.02 * torch.randn((b, P, N, 3), generator=g, device='cuda')
    if kind == 'ties':
        x, y = torch.round(x * 64) / 64, torch.round(y * 64) / 64
        x[:, :, 1::4] = x[:, :, 0::4]
        y[:, :, 2::4] = y[:, :, 1::4]
    if kind == 'collapsed':
        y = y[:, :, torch.arange(N, device='cuda') % 4]
    valids = (torch.arange(P, device='cuda')[None] <
              torch.as_tensor(counts, device='cuda')[:, None]).float()
    x = x * valids[:, :, None, None]
    y = y * valids[:, :, None, None]
    return x.contiguous(), y.contiguous(), valids


def _profile(fn, iters):
    """{kernel name: mean device ms per call of fn()} over `iters` calls,
    from torch.profiler."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, 'device_time_total', None)
        if us is None:
            us = getattr(ev, 'cuda_time_total', 0.0)
        if us and ev.device_type == torch.autograd.DeviceType.CUDA:
            name = ev.key.replace('(anonymous namespace)::', '')
            out[name.split('(')[0].strip() or name] = us / 1e3 / iters
    return out


def _check_pair(counts, seed, diagonal, timed, kind='everyday'):
    """The B1/B3 kernel (the main path's dense list) against its plain
    version, bit for bit; in the whole-shape mode also the pruned list
    against the dense list and the card's keep rule against the plain one
    (on 'spread' clouds it must drop pairs); then B2/B4 on the witnesses,
    with dy and dx only, exact zeros at padded parts.  Returns (fwd, bwd)
    rows (err, ms, plain ms, bound ms, bound by), the forward's for the
    dense list, the backward's with dy."""
    x, y, valids = _clouds(counts, seed, kind)
    n_parts = valids.to(torch.int32).sum(1, dtype=torch.int32)
    b = len(counts)
    sizes = [min(int(c), P) for c in counts]
    dense_pairs = sum((s if diagonal else s * s) for s in sizes) * N * N

    kern = C.nn_pair_cuda(x, y, n_parts, diagonal)
    d1p, d2p, w1p, w2p = C.nn_pair_plain(x, y, n_parts, diagonal)
    torch.cuda.synchronize()
    d1k, d2k, w1k, w2k = kern
    fwd_err = max(float((d1k - d1p).abs().max()),
                  float((d2k - d2p).abs().max()))
    mismatches = int((w1k != w1p).sum() + (w2k != w2p).sum())
    mode = 'diag' if diagonal else 'parts'
    tag = f'{kind} counts={sorted(counts, reverse=True)[:3]}.. B={b}'
    print(f'kernels: chamfer_pair[{mode}] {tag}: max|d kernel - d plain| = '
          f'{fwd_err:.3e} (bitwise required), witness mismatches = '
          f'{mismatches}', flush=True)
    if fwd_err != 0.0 or mismatches != 0:
        raise AssertionError(f'chamfer_pair[{mode}] {kind} disagrees with '
                             'its plain version')
    kept_pairs = dense_pairs
    if not diagonal:
        work = torch.empty(1 + b * P * P, dtype=torch.int32, device='cuda')
        pruned = C.nn_pair_cuda(x, y, n_parts, False, prune=True, work=work)
        same = all(torch.equal(k, d) for k, d in zip(pruned, kern))
        keep_k = C.work_keep(work, b, P)
        keep_p = C.prune_keep_plain(x, y, n_parts)
        keep_diff = int((keep_k != keep_p).sum())
        kept_pairs = int(keep_k.sum()) * N * N
        print(f'kernels: chamfer_pair[parts] {tag}: pruned list bitwise '
              f'equal to the dense list {same}; kept part pairs '
              f'{int(keep_k.sum())} of {dense_pairs // (N * N)} (share '
              f'{kept_pairs / dense_pairs:.4f}); keep mask card vs plain '
              f'mismatches {keep_diff}', flush=True)
        if not same or keep_diff:
            raise AssertionError(f'chamfer_pair[parts] {kind}: pruning '
                                 'changed the result or the keep rule')
        if kind == 'spread' and not kept_pairs < dense_pairs:
            raise AssertionError('chamfer_pair[parts] spread: pruning '
                                 'dropped no part pair')

    # cotangents over every point, padded parts included: their gradients
    # must still be exactly 0
    g = torch.Generator(device='cuda').manual_seed(seed + 1)
    g1 = torch.rand(d1k.shape, generator=g, device='cuda')
    g2 = torch.rand(d2k.shape, generator=g, device='cuda')
    pad = torch.arange(P, device='cuda')[None] >= n_parts[:, None]

    def bwd(grad, need_dy):
        return lambda: grad(x, y, n_parts, w1p, w2p, g1, g2, diagonal,
                            need_dy)

    def bits(t):
        return None if t is None else t.view(torch.int32)

    bwd_err = {}
    for need_dy, form in BWD_FORMS:
        kern_g = bwd(C.chamfer_grad_cuda, need_dy)()
        plain_g = bwd(C.chamfer_grad_plain, need_dy)()
        cpu_args = [a.cpu() if isinstance(a, torch.Tensor) else a for a in
                    (x, y, n_parts, w1p, w2p, g1, g2, diagonal, need_dy)]
        cpu_g = C.chamfer_grad_plain(*cpu_args)
        # three launches a cotangent pattern, either cotangent null too:
        # the same bits every time
        repeats = compared = 0
        for c1, c2 in ((g1, g2), (None, g2), (g1, None)):
            runs = [C.chamfer_grad_cuda(x, y, n_parts, w1p, w2p, c1, c2,
                                        diagonal, need_dy) for _ in range(3)]
            for run in runs[1:]:
                same = [torch.equal(bits(k), bits(f))
                        for k, f in zip(run, runs[0]) if f is not None]
                repeats += same.count(False)
                compared += len(same)
        torch.cuda.synchronize()
        outs = [(k, p, c) for k, p, c in zip(kern_g, plain_g, cpu_g)
                if p is not None]
        err = max(float((k - p).abs().max()) for k, p, _ in outs)
        cpu_err = bwd_err[need_dy] = max(float((k.cpu() - c).abs().max())
                                         for k, _, c in outs)
        tol = GRAD_RTOL * max(float(p.abs().max()) for _, p, _ in outs) + \
            GRAD_ATOL
        pad_nonzero = sum(int((k[pad] != 0).sum()) for k, _, _ in outs)
        print(f'kernels: chamfer_grad[{mode}] {form} {tag}: max|grad kernel '
              f'- grad plain on the CPU| = {cpu_err:.3e} (bitwise required), '
              f'on the card = {err:.3e} (tolerance {tol:.3e}); repeat '
              f'launches differing from the first = {repeats} of {compared} '
              f'(bitwise required); nonzero gradients at padded parts = '
              f'{pad_nonzero}', flush=True)
        if cpu_err != 0.0 or not err <= tol or repeats or pad_nonzero or \
                (kern_g[1] is None) == need_dy:
            raise AssertionError(f'chamfer_grad[{mode}] {form} {kind} '
                                 'disagrees with its plain version or '
                                 'between launches')
    if not timed:
        return None

    def kernel(prune):
        return lambda: C.nn_pair_cuda(x, y, n_parts, diagonal, prune=prune)

    lists = [('dense', False, dense_pairs)]
    if not diagonal:
        lists.append(('pruned', True, kept_pairs))
    times = {}
    for label, prune, pairs in lists:
        ms = times[label] = _cuda_ms(kernel(prune), 20)
        bound_ms, _ = _pair_bound(pairs, b)
        split = ', '.join(f'{name} {t:.4f} ms' for name, t in sorted(
            _profile(kernel(prune), 20).items(), key=lambda kv: -kv[1]))
        print(f'kernels: chamfer_pair[{mode}] {kind} both directions, '
              f'{label} list: kernel {ms:.4f} ms, {pairs / (ms / 1e3):.4e} '
              f'pairs/s, bound {bound_ms:.4f} ms ({PAIR_OPS} operations a '
              f'pair at {PEAK_OPS:.3e}/s), share of the bound '
              f'{bound_ms / ms:.3f}; device time by kernel: '
              f'{split or "not recorded"}', flush=True)
    p_ms = _cuda_ms(lambda: C.nn_pair_plain(x, y, n_parts, diagonal), 3)
    print(f'kernels: chamfer_pair[{mode}] plain {p_ms:.4f} ms', flush=True)
    valid_pts = sum(sizes) * N
    bwd_rows = {}
    for need_dy, form in BWD_FORMS:
        # a valid point reads x, y (12 bytes each), w1, w2, g1, g2 (4 each)
        # and writes dx (and dy); a padded point writes its zero dx (and dy)
        point, padded = (64, 24) if need_dy else (52, 12)
        bound = _bound(nbytes=point * valid_pts +
                       padded * (b * P * N - valid_pts))
        k_ms = _cuda_ms(bwd(C.chamfer_grad_cuda, need_dy), 50)
        pl_ms = _cuda_ms(bwd(C.chamfer_grad_plain, need_dy), 3)
        split = ', '.join(f'{name} {t:.4f} ms' for name, t in sorted(
            _profile(bwd(C.chamfer_grad_cuda, need_dy), 20).items(),
            key=lambda kv: -kv[1]))
        print(f'kernels: chamfer_grad[{mode}] {kind} {form}: kernel '
              f'{k_ms:.4f} ms, plain {pl_ms:.4f} ms, bound {bound[0]:.4f} ms '
              f'({point} bytes a valid point, {padded} a padded one), share '
              f'{bound[0] / k_ms:.3f}; device time by kernel: '
              f'{split or "not recorded"}', flush=True)
        bwd_rows[need_dy] = (bwd_err[need_dy], k_ms, pl_ms, *bound)
    return {'fwd': (fwd_err, times['dense'], p_ms,
                    *_pair_bound(dense_pairs, b)),
            'bwd': bwd_rows[True]}


def _check_nn_parts(counts, seed, timed):
    """B8 against its plain version and against B1 on the same clouds, in
    the whole-shape form and the B*P one-part diagonal form; returns (err,
    kernel ms, plain ms, bound ms, bound by) of the whole-shape form, both
    directions (two launches).  B8 is B1's machinery in one direction, so
    the two times side by side show what the second direction a launch
    saves."""
    x, y, valids = _clouds(counts, seed)
    b = len(counts)
    npad = (N + 127) // 128 * 128
    forms = {
        'whole': (x, y, valids.to(torch.int32).sum(1, dtype=torch.int32)),
        'diag': (x.view(b * P, 1, N, 3), y.view(b * P, 1, N, 3),
                 valids.to(torch.int32).reshape(b * P)),
    }
    tag = f'counts={sorted(counts, reverse=True)[:3]}.. B={b}'
    result = None
    for form, (q, t, n_p) in forms.items():
        def fwd(nn):
            return nn(q, t, n_p) + nn(t, q, n_p)

        def fused(prune=False):
            return C.nn_pair_cuda(q, t, n_p, False, prune=prune)

        d1k, i1k, d2k, i2k = fwd(C.nn_parts_cuda)
        d1p, i1p, d2p, i2p = fwd(C.nn_parts_plain)
        d1f, d2f, w1f, w2f = fused()
        torch.cuda.synchronize()
        err = max(float((d1k - d1p).abs().max()),
                  float((d2k - d2p).abs().max()))
        mismatches = int((i1k != i1p).sum() + (i2k != i2p).sum())
        # B8's JAX numbering part * npad + local (0 at padded parts) against
        # B1's part * N + local (-1 at padded parts)
        valid = (torch.arange(q.shape[1], device='cuda')[None] <
                 n_p[:, None])[..., None].expand(d1k.shape)

        def renumber(i):
            i = i.long()
            return torch.where(valid, i // npad * N + i % npad, -1)

        b1_err = max(float((d1k - d1f).abs().max()),
                     float((d2k - d2f).abs().max()))
        b1_mismatches = int((renumber(i1k) != w1f).sum() +
                            (renumber(i2k) != w2f).sum())
        pad_nonzero = int((i1k[~valid] != 0).sum() + (i2k[~valid] != 0).sum()
                          + (d1k[~valid] != 0).sum() + (d2k[~valid] != 0).sum())
        print(f'kernels: nn_parts[off] {form} {tag}: max|d kernel - d plain| '
              f'= {err:.3e} (bitwise required), index mismatches = '
              f'{mismatches}; against chamfer_pair[parts]: max|d| = '
              f'{b1_err:.3e}, witness mismatches after renumbering = '
              f'{b1_mismatches}, nonzero distances or indices at padded '
              f'parts = {pad_nonzero}', flush=True)
        if err != 0.0 or mismatches or b1_err != 0.0 or b1_mismatches or \
                pad_nonzero:
            raise AssertionError(f'nn_parts[off] {form} disagrees with its '
                                 'plain version or with chamfer_pair[parts]')
        if not timed:
            continue
        k_ms = _cuda_ms(lambda: fwd(C.nn_parts_cuda), 20)
        k1_ms = _cuda_ms(lambda: C.nn_parts_cuda(q, t, n_p), 20)
        p_ms = _cuda_ms(lambda: fwd(C.nn_parts_plain), 3)
        f_ms = _cuda_ms(lambda: fused(True), 20)
        fd_ms = _cuda_ms(fused, 20)
        # the same part pairs in both forms: every pair of valid parts of a
        # shape, or each valid part against itself
        sizes = [min(int(c), P) for c in counts]
        pairs = sum((s * s if form == 'whole' else s) for s in sizes) * N * N
        bound = _dir_bound(pairs, 2 * q.shape[0] * q.shape[1] * N)
        split = ', '.join(f'{name} {t_:.4f} ms' for name, t_ in sorted(
            _profile(lambda: C.nn_parts_cuda(q, t, n_p), 20).items(),
            key=lambda kv: -kv[1]))
        print(f'kernels: nn_parts[off] {form} both directions (two '
              f'launches): kernel {k_ms:.4f} ms (one direction {k1_ms:.4f} '
              f'ms), plain {p_ms:.4f} ms, bound {bound[0]:.4f} ms '
              f'({DIR_OPS} operations a pair and a launch, {pairs:.4e} '
              f'pairs a launch), share {bound[0] / k_ms:.3f}; '
              f'chamfer_pair[parts] on the same clouds {f_ms:.4f} ms (pruned '
              f'list), {fd_ms:.4f} ms (dense list); device time of one '
              f'direction by kernel: {split or "not recorded"}', flush=True)
        if form == 'whole':
            result = (err, k_ms, p_ms, *bound)
    return result


def _time_routes(counts, seed):
    """Forward and backward of chamfer_parts and chamfer_diag, as the loss
    calls them once a step, through each chamfer route, in the order
    fused, unfused, unfused, fused: device time by CUDA events and host
    time per call."""
    x, y, valids = _clouds(counts, seed)
    x.requires_grad_()

    def step():
        d1, d2 = C.chamfer_parts(x, y, valids)
        e1, e2 = C.chamfer_diag(x, y, valids)
        torch.autograd.grad(d1.sum() + d2.sum() + e1.sum() + e2.sum(), x)

    prev, times = C.fused_mode(), {'auto': [], 'off': []}
    try:
        for mode in ('auto', 'off', 'off', 'auto'):
            C.set_fused_mode(mode)
            times[mode].append((_cuda_ms(step, 20), _call_ms(step, 20)))
    finally:
        C.set_fused_mode(prev)
    for mode, label in (('auto', 'fused'), ('off', 'unfused')):
        (d1, h1), (d2, h2) = times[mode]
        print(f'kernels: {label} chamfer route, chamfer_parts + chamfer_diag '
              f'forward and backward: {d1:.4f} / {d2:.4f} ms on the device, '
              f'{h1:.4f} / {h2:.4f} ms per call by the host clock',
              flush=True)


def _check_nn_dir(x, y, label, timed):
    """B7 against its plain version, both directions; returns (err, kernel
    ms, plain ms) of both directions."""
    def fwd(nn):
        return nn(x, y) + nn(y, x)

    d1k, i1k, d2k, i2k = fwd(C.nn_dir_cuda)
    d1p, i1p, d2p, i2p = fwd(C.nn_dir_plain)
    torch.cuda.synchronize()
    err = max(float((d1k - d1p).abs().max()), float((d2k - d2p).abs().max()))
    mismatches = int((i1k != i1p).sum() + (i2k != i2p).sum())
    finite = bool(torch.isfinite(d1k).all() and torch.isfinite(d2k).all())
    print(f'kernels: nn_dir {label} [{x.shape[0]}, {x.shape[1]}] x '
          f'[{y.shape[0]}, {y.shape[1]}]: max|d kernel - d plain| = '
          f'{err:.3e} (bitwise required), index mismatches = {mismatches}',
          flush=True)
    if err != 0.0 or mismatches or not finite:
        raise AssertionError(f'nn_dir {label} disagrees with its plain '
                             'version')
    if not timed:
        return None
    k_ms = _cuda_ms(lambda: fwd(C.nn_dir_cuda), 20)
    k1_ms = _cuda_ms(lambda: C.nn_dir_cuda(x, y), 20)
    p_ms = _cuda_ms(lambda: fwd(C.nn_dir_plain), 3)
    pairs = x.shape[0] * x.shape[1] * y.shape[1]  # a launch's
    bound = _dir_bound(pairs, x.shape[0] * x.shape[1] +
                       y.shape[0] * y.shape[1])
    print(f'kernels: nn_dir {label} both directions (two launches): kernel '
          f'{k_ms:.4f} ms (one direction {k1_ms:.4f} ms; '
          f'{2 * pairs / (k_ms / 1e3):.3e} pair distances/s), plain '
          f'{p_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}, {DIR_OPS} '
          f'operations a pair and a launch), share {bound[0] / k_ms:.3f}',
          flush=True)
    return (err, k_ms, p_ms, *bound)


def phase_kernels():
    rng = np.random.default_rng(0)
    mix = rng.choice(PART_POOL, B)
    mix[0] = 20
    results = {}
    for diagonal in (False, True):
        mode = 'diag' if diagonal else 'parts'
        r = _check_pair(mix.tolist(), 1, diagonal, timed=True)
        results[f'nn_{mode}'] = r['fwd']
        results[f'bwd_{mode}'] = r['bwd']
        for counts, seed, kind in (([20] * 8, 2, 'everyday'),
                                   (mix.tolist(), 3, 'ties'),
                                   (mix.tolist(), 4, 'overlap'),
                                   (mix.tolist(), 5, 'spread'),
                                   (mix.tolist(), 6, 'collapsed')):
            _check_pair(counts, seed, diagonal,
                        timed=kind in ('spread', 'collapsed'), kind=kind)
    results['nn_off'] = _check_nn_parts(mix.tolist(), 1, timed=True)
    _check_nn_parts([20] * 8, 2, timed=False)
    _time_routes(mix.tolist(), 1)
    # one repulsion scan row: part 0 of every shape against all its parts
    parts, _, _ = _clouds(mix.tolist(), 6)
    row = parts[:, 0, None].expand(B, P, N, 3).reshape(B * P, N, 3)
    results['nn_dir'] = _check_nn_dir(
        row.contiguous(), parts.reshape(B * P, N, 3), 'repulsion scan row',
        timed=True)
    g = torch.Generator(device='cuda').manual_seed(7)
    _check_nn_dir(torch.randn((B, N, 3), generator=g, device='cuda'),
                  torch.randn((B, 2500, 3), generator=g, device='cuda'),
                  'N1 != N2', timed=True)
    return results


def phase_masked_bn():
    """The masked batch norm's kernels (csrc/masked_bn.cu) at the flagship's
    five PointNet layers, [32, 20, 1000, C] bf16 on the everyday mix,
    padded clouds filled with 3e4: the moments within 1e-6 of the plain
    f32 ones (the mean relative to |mean| + std), the apply bit for bit
    given the plain factor and offset, dx within 2^-8 and d(weight),
    d(bias) within 1e-4 relative L2 of autograd of the plain formulas in
    f32 (as tests/test_torch_cuda.py).  Each direction timed by CUDA events
    over the five layers on device work alone (forward: moments, the [C]
    expressions, apply, as the program calls them; backward:
    `backward_cuda`, the two passes and the finalize, on the forward's
    saved tensors, no autograd engine), beside its bytes bound (forward:
    the valid rows read once, every row read and written; backward: dy and
    x read twice, dx written), the plain version's time (moments_plain,
    affine, normalize_plain and autograd's backward of them) and the
    library's batch norm over the compacted valid rows ([rows, C];
    aten.native_batch_norm and its backward called directly), a yardstick
    the program never calls.  Returns the kernels rows {'bn_apply':
    forward, 'bn_backward': backward}: (largest absolute error, ms, plain
    ms, bound ms, bound by, library ms); the forward's error is the
    moments' (mean and var, f32) against the plain ones, the backward's
    dx's against the f32 autograd."""
    rng = np.random.default_rng(0)
    counts = rng.choice(PART_POOL, B)
    valid = (torch.arange(P, device='cuda')[None] <
             torch.as_tensor(counts, device='cuda')[:, None]).float()
    mask = valid[..., None]
    w, fan = MBN.row_weights(mask, (B, P, N, 1))
    g = torch.Generator(device='cuda').manual_seed(11)
    layers = []
    for C in BN_WIDTHS:
        x = 1.5 * torch.randn((B, P, N, C), generator=g, device='cuda') + 0.3
        x = torch.where(valid[:, :, None, None] > 0, x,
                        torch.full_like(x, 3e4)).to(torch.bfloat16)
        layers.append({
            'x': x, 'dy': torch.randn(x.shape, generator=g, device='cuda')
            .to(torch.bfloat16),
            'weight': torch.rand(C, generator=g, device='cuda') + 0.5,
            'bias': 0.1 * torch.randn(C, generator=g, device='cuda'),
            'relu': len(layers) < 4})
    fwd_err = bwd_err = 0.0
    for L in layers:
        x, C = L['x'], L['x'].shape[-1]
        mean, var, denom = MBN.moments_cuda(x, w, fan)
        pm, pv, pd = MBN.moments_plain(x, mask)
        rel = max(float(((mean - pm).abs() / (pm.abs() + pv.sqrt())).max()),
                  float(((var - pv).abs() / pv).max()))
        _, factor, offset = MBN.affine(L['weight'], L['bias'], pm, pv, 1e-5)
        y = MBN.apply_cuda(x, factor.to(x.dtype), offset.to(x.dtype),
                           L['relu'])
        same = torch.equal(y.view(torch.int16), MBN.normalize_plain(
            x, factor, offset, L['relu']).view(torch.int16))
        if rel > 1e-6 or not same or float(denom) != float(pd):
            raise AssertionError(f'masked_bn C={C}: moments off by '
                                 f'{rel:.2e} (limit 1e-6), apply bitwise '
                                 f'{same}, denom {float(denom)} vs '
                                 f'{float(pd)}')
        fwd_err = max(fwd_err, float((mean - pm).abs().max()),
                      float((var - pv).abs().max()))
        xk = x.clone().requires_grad_(True)
        wk, bk = (L[k].clone().requires_grad_(True) for k in ('weight',
                                                             'bias'))
        MBN.masked_bn(xk, wk, bk, pm, pv, 1e-5, L['relu'], w, fan,
                      pd).backward(L['dy'])
        xf = x.float().requires_grad_(True)
        wf, bf = (L[k].clone().requires_grad_(True) for k in ('weight',
                                                             'bias'))
        m2, v2, _ = MBN.moments_plain(xf, mask)
        _, f2, o2 = MBN.affine(wf, bf, m2, v2, 1e-5)
        z = xf * f2 + o2
        z = z + (MBN.normalize_plain(x, f2, o2).float() - z).detach()
        (torch.relu(z) if L['relu'] else z).backward(L['dy'].float())
        rels = [float((a.float() - b).norm() / b.norm())
                for a, b in ((xk.grad, xf.grad), (wk.grad, wf.grad),
                             (bk.grad, bf.grad))]
        if rels[0] > 2.0**-8 or max(rels[1:]) > 1e-4:
            raise AssertionError(f'masked_bn C={C}: dx, dweight, dbias off '
                                 f'by {rels} relative L2 (limits 2^-8, '
                                 '1e-4, 1e-4)')
        bwd_err = max(bwd_err, float((xk.grad.float() - xf.grad).abs()
                                     .max()))
        del xk, xf, z

    def forward(plain):
        out = []
        for L in layers:
            x = L['x'].requires_grad_(True)
            wt = L['weight'].requires_grad_(True)
            bs = L['bias'].requires_grad_(True)
            if plain:
                mean, var, _ = MBN.moments_plain(x, mask)
                _, factor, offset = MBN.affine(wt, bs, mean, var, 1e-5)
                y = MBN.normalize_plain(x, factor, offset, L['relu'])
            else:
                mean, var, denom = MBN.moments_cuda(x.detach(), w, fan)
                y = MBN.masked_bn(x, wt, bs, mean, var, 1e-5, L['relu'], w,
                                  fan, denom)
            out.append((y, (x, wt, bs), L['dy']))
        return out

    def backward(outs):
        for y, inputs, dy in outs:
            torch.autograd.grad(y, inputs, dy, retain_graph=True)

    # the kernels' backward on what the forward saves
    saved = []
    with torch.no_grad():
        for L in layers:
            x = L['x'].detach()
            mean, var, denom = MBN.moments_cuda(x, w, fan)
            rstd, factor, offset = MBN.affine(L['weight'], L['bias'], mean,
                                              var, 1e-5)
            saved.append((L['dy'], x, factor.to(x.dtype),
                          offset.to(x.dtype), w, fan, L['weight'], mean,
                          rstd, denom, L['relu']))

    def kernel_backward():
        for args in saved:
            MBN.backward_cuda(*args)

    rows = valid.reshape(-1).repeat_interleave(N) > 0
    lib = []
    for L in layers:
        C = L['x'].shape[-1]
        lib.append((L['x'].detach().reshape(-1, C)[rows].contiguous(),
                    L['dy'].reshape(-1, C)[rows].contiguous(), L['weight'],
                    L['bias']))
    native = torch.ops.aten.native_batch_norm
    native_bwd = torch.ops.aten.native_batch_norm_backward
    with torch.no_grad():
        lib_saved = [native(xv, wt, bs, None, None, True, 0.1, 1e-5)
                     for xv, _, wt, bs in lib]

    def library_forward():
        for xv, _, wt, bs in lib:
            native(xv, wt, bs, None, None, True, 0.1, 1e-5)

    def library_backward():
        for (xv, dyv, wt, _), (_, sm, si) in zip(lib, lib_saved):
            native_bwd(dyv, xv, wt, None, None, sm, si, True, 1e-5,
                       [True, True, True])

    valid_rows = int(valid.sum()) * N
    rows_all = B * P * N
    fwd_bytes = sum(2 * C * (valid_rows + 2 * rows_all) for C in BN_WIDTHS)
    bwd_bytes = sum(2 * C * 5 * rows_all for C in BN_WIDTHS)
    with torch.no_grad():
        k_f = _cuda_ms(lambda: forward(False), 10)
        p_f = _cuda_ms(lambda: forward(True), 3)
        l_f = _cuda_ms(library_forward, 5)
        k_b = _cuda_ms(kernel_backward, 10)
        l_b = _cuda_ms(library_backward, 5)
    plain_outs = forward(True)
    p_b = _cuda_ms(lambda: backward(plain_outs), 3)
    del plain_outs
    out = {}
    for key, label, k_ms, p_ms, l_ms, nbytes, err in (
            ('bn_apply', 'forward', k_f, p_f, l_f, fwd_bytes, fwd_err),
            ('bn_backward', 'backward', k_b, p_b, l_b, bwd_bytes, bwd_err)):
        bound = _bound(nbytes=nbytes)
        print(f'kernels: masked_bn {label}, five PointNet layers (C '
              f'{"-".join(map(str, BN_WIDTHS))}, {valid_rows} of {rows_all} '
              f'rows valid): kernels {k_ms:.4f} ms, plain {p_ms:.4f} ms, '
              f'the library\'s batch norm on the valid rows {l_ms:.4f} ms, '
              f'bound {bound[0]:.4f} ms ({nbytes / 1e9:.3f} GB), share '
              f'{bound[0] / k_ms:.3f}; largest absolute error {err:.2e} '
              f'({"the moments" if key == "bn_apply" else "dx"})',
              flush=True)
        out[key] = (err, k_ms, p_ms, *bound, l_ms)
    split = ', '.join(f'{name} {t:.4f} ms' for name, t in sorted(
        _profile(lambda: (forward(False), kernel_backward()), 5).items(),
        key=lambda kv: -kv[1]))
    print(f'kernels: masked_bn forward and backward, device time by kernel: '
          f'{split or "not recorded"}', flush=True)
    return out



def _pool_inputs(C, seed):
    """The PointNet's last output as the pool sees it, [B, P, N, C] bf16 on
    the everyday mix: valid clouds random, padded clouds one point repeated
    (padded parts are zeros, so their points are alike), one NaN column in
    a valid cloud; the cotangent f32 [B, P, C], negative on half the
    channels."""
    rng = np.random.default_rng(seed)
    counts = rng.choice(PART_POOL, B)
    valid = (torch.arange(P, device='cuda')[None] <
             torch.as_tensor(counts, device='cuda')[:, None])
    g = torch.Generator(device='cuda').manual_seed(seed)
    x = torch.randn((B, P, N, C), generator=g, device='cuda')
    x = torch.where(valid[:, :, None, None], x, x[:, :, :1])
    x[0, 0, 17:19, 5] = float('nan')
    cot = torch.randn((B, P, C), generator=g, device='cuda')
    cot[..., :C // 2] = -cot[..., :C // 2].abs()
    return x.to(torch.bfloat16), cot


def phase_max_pool():
    """The PointNet's max-pool kernels (csrc/max_pool.cu) at the
    PN-Transformer's [32, 20, 1000, 256] and RGL-Net's [32, 20, 1000, 128]
    bf16 outputs (`_pool_inputs`): the max, the tie count and dx bit for
    bit those of the plain version on the card (`max_pool_plain`,
    `x.float().amax(-2)`, and autograd's backward of it), signed zeros and
    the NaN column included.  Each direction timed by CUDA events beside
    its bytes bound (forward: x read once, the max and count written;
    backward: x, the max, count and cotangent read, dx written), the plain
    version's time (forward; autograd's backward of it on its saved
    tensors) and the library's call, `torch.amax` on the bf16 x then
    `.float()` (forward; autograd's backward of it), a yardstick the
    program never calls.  Returns the kernels rows {'pool_fwd': forward,
    'pool_bwd': backward} at the PN-Transformer's width: (largest absolute
    error, ms, plain ms, bound ms, bound by, library ms)."""
    out = {}
    for C in POOL_WIDTHS:
        x, g = _pool_inputs(C, seed=C)
        pooled, count = MP.max_pool_cuda(x)
        dx = MP.max_pool_grad_cuda(x, pooled, count, g)
        xp = x.clone().requires_grad_(True)
        p_out = MP.max_pool_plain(xp)
        p_dx, = torch.autograd.grad(p_out, xp, g, retain_graph=True)
        p_count = (x.float() == p_out.detach().unsqueeze(-2)).sum(-2)
        same = {'max': torch.equal(pooled.view(torch.int32),
                                   p_out.detach().view(torch.int32)),
                'count': torch.equal(count.long(), p_count),
                'dx': torch.equal(dx.view(torch.int16),
                                  p_dx.view(torch.int16))}
        signed = int((torch.signbit(dx) & (dx == 0)).sum())
        nans = int(torch.isnan(pooled).sum())
        if not all(same.values()) or not signed or not nans:
            raise AssertionError(f'max_pool C={C}: bitwise {same}, -0.0 in '
                                 f'dx {signed}, NaN maxima {nans}')
        xl = x.clone().requires_grad_(True)
        l_out = torch.amax(xl, -2).float()
        R = B * P
        fwd_bytes = x.numel() * 2 + R * C * 8
        bwd_bytes = 2 * x.numel() * 2 + R * C * 12
        with torch.no_grad():
            k_f = _cuda_ms(lambda: MP.max_pool_cuda(x), 20)
            k_b = _cuda_ms(lambda: MP.max_pool_grad_cuda(x, pooled, count,
                                                         g), 20)
            p_f = _cuda_ms(lambda: MP.max_pool_plain(x), 10)
            l_f = _cuda_ms(lambda: torch.amax(x, -2).float(), 10)
        p_b = _cuda_ms(lambda: torch.autograd.grad(p_out, xp, g,
                                                   retain_graph=True), 10)
        l_b = _cuda_ms(lambda: torch.autograd.grad(l_out, xl, g,
                                                   retain_graph=True), 10)
        for key, label, k_ms, p_ms, l_ms, nbytes in (
                ('pool_fwd', 'forward', k_f, p_f, l_f, fwd_bytes),
                ('pool_bwd', 'backward', k_b, p_b, l_b, bwd_bytes)):
            bound = _bound(nbytes=nbytes)
            print(f'kernels: max_pool {label} [{B}, {P}, {N}, {C}] bf16: '
                  f'kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, the '
                  f'library\'s amax then cast {l_ms:.4f} ms, bound '
                  f'{bound[0]:.4f} ms ({nbytes / 1e9:.4f} GB), share '
                  f'{bound[0] / k_ms:.3f}; bitwise the plain version (max, '
                  f'count, dx; {signed} signed zeros in dx, {nans} NaN '
                  f'maxima)', flush=True)
            if C == POOL_WIDTHS[0]:
                out[key] = (0.0, k_ms, p_ms, *bound, l_ms)
        split = ', '.join(f'{name} {t:.4f} ms' for name, t in sorted(
            _profile(lambda: MP.max_pool_grad_cuda(
                x, *MP.max_pool_cuda(x), g), 5).items(),
            key=lambda kv: -kv[1]))
        print(f'kernels: max_pool C={C} forward and backward, device time '
              f'by kernel: {split or "not recorded"}', flush=True)
        del xp, p_out, xl, l_out
    return out

def _write_soups(folder):
    """Random triangle soups with the RAGGED_FACES face counts."""
    os.makedirs(folder, exist_ok=True)
    paths = []
    for i, nf in enumerate(RAGGED_FACES):
        v = np.random.default_rng(100 + i).normal(size=(nf * 3, 3))
        path = os.path.join(folder, f'soup{i}.obj')
        with open(path, 'w') as f:
            f.writelines(f'v {x:.6f} {y:.6f} {z:.6f}\n' for x, y, z in v)
            f.writelines(f'f {3 * j + 1} {3 * j + 2} {3 * j + 3}\n'
                         for j in range(nf))
        paths.append(path)
    return paths


def _sampler_fns(layout, t):
    """(kernel, plain version) of a layout, each a function of (slots, u)
    on the inputs the kernel takes: the table's face-major records."""
    records = DS.table_records(t.table)
    if layout == 'chunked':
        return (lambda s, u: DS.sample_chunked_cuda(records, t.n_faces, s, u),
                lambda s, u: DS.sample_records_plain(records, t.n_faces, s,
                                                     u))
    return (lambda s, u: DS.sample_dense_cuda(records, t.n_faces, s, u),
            lambda s, u: DS.sample_dense_records_plain(records, t.n_faces, s,
                                                       u))


def _distinct(slots, idx, mask=None):
    """How many distinct (slot, index) pairs a [K, N] index holds (where
    `mask` is true)."""
    keys = slots.long()[:, None] * (1 << 33) + idx.long()
    return int(torch.unique(keys if mask is None else keys[mask]).numel())


def _sampler_bytes(layout, t, slots, u, draws):
    """The least bytes a sampling call moves on this run's draws: the
    uniforms read and the points written (24 a point), the slots and the
    pieces' face counts (and chunked: first chunks), and each table value
    the draws need read once: prob of each distinct first draw f0 (dense:
    its alias too where the alias was taken), and the triangle of each
    distinct face drawn (chunked: f0's own or its inlined alias triangle).
    Faces drawn again cost nothing more."""
    K, n = u.shape[0], u.shape[-1]
    pieces = int(torch.unique(slots).numel())
    dense = layout == 'dense'
    nf = t.n_faces if dense else t.n_faces[DS._META_NF]
    f0, frac = DS._draw_face(u[:, 0], nf[slots.long()])
    nbytes = 24 * K * n + 4 * K + (4 if dense else 8) * pieces + \
        4 * _distinct(slots, f0) + 36 * _distinct(slots, draws)
    if dense:
        prob = DS.jax_table(t.table)[slots.long()[:, None], DS._ROW_PROB,
                                     f0]
        nbytes += 4 * _distinct(slots, f0, frac >= prob)
    return nbytes


def _check_sampler(name, tables, slots, seed):
    """Both sampling kernels against their plain versions on one slot
    array (on the records, the kernels' inputs, and on the table itself),
    and dense against chunked, then their times, cold (the kernels line's)
    and warm, and the floor probes'; returns {layout: (err, kernel ms,
    plain ms, bound ms, bound by)}."""
    g = torch.Generator(device='cuda').manual_seed(seed)
    u = torch.rand((slots.shape[0], 3, N), generator=g, device='cuda')
    out, tag = {}, f'{name} K={slots.shape[0]} N={N}'
    for layout, t in tables.items():
        pk, dk = DS._sample_points(t.table, t.n_faces, slots, u,
                                   return_draws=True)
        records_plain = DS.sample_records_plain if layout == 'chunked' \
            else DS.sample_dense_records_plain
        plains = [DS.sample_packed_ref(DS.jax_table(t.table), t.n_faces,
                                       slots, u, return_draws=True),
                  records_plain(DS.table_records(t.table), t.n_faces, slots,
                                u, return_draws=True)]
        torch.cuda.synchronize()
        err = max(float((pk - pp).abs().max()) for pp, _ in plains)
        mismatches = sum(int((dk != dp).sum()) for _, dp in plains)
        finite = bool(torch.isfinite(pk).all())
        out[layout] = [err, pk, dk]
        print(f'kernels: sample_{layout} {tag}: max|p kernel - p plain| = '
              f'{err:.3e} (bitwise required), draw mismatches = '
              f'{mismatches} (plain versions on the table and on the '
              'records)', flush=True)
        if err != 0.0 or mismatches != 0 or not finite:
            raise AssertionError(f'sample_{layout} disagrees with its plain '
                                 f'version on {tag}')
    (_, pd, fd), (_, pc, fc) = out['dense'], out['chunked']
    # a chunked draw that took the alias triangle names f0 (as -1 - f0):
    # resolve it through the dense table's alias row
    f0 = torch.where(fc < 0, -1 - fc, fc).long()
    alias = DS.jax_table(tables['dense'].table)[slots.long()[:, None],
                                                DS._ROW_ALIAS, f0]
    resolved = torch.where(fc < 0, (alias + 0.5).to(torch.int32), fc)
    same_faces = int((resolved != fd).sum())
    print(f'kernels: dense vs chunked {tag}: points bitwise equal '
          f'{torch.equal(pd, pc)}, face mismatches {same_faces}, alias '
          f'taken for {float((fc < 0).float().mean()):.3f} of the points',
          flush=True)
    if not torch.equal(pd, pc) or same_faces:
        raise AssertionError(f'dense and chunked kernels disagree on {tag}')
    probe_out = torch.empty((slots.shape[0], N, 3), device='cuda')
    _probe(1, u, probe_out)
    if not torch.equal(probe_out, u.transpose(1, 2)):
        raise AssertionError('probe_uniforms: points are not the uniforms')
    empty_ms = _cold_ms(lambda: _probe(0, u, probe_out), 100)
    copy_ms = _cold_ms(lambda: _probe(1, u, probe_out), 100)
    copy_warm = _cuda_ms(lambda: _probe(1, u, probe_out), 100)
    print(f'kernels: sampler floor probes {tag}, on the samplers\' grid, '
          f'cold: empty kernel {empty_ms:.4f} ms, uniforms read and points '
          f'written (24 bytes a point, no table) {copy_ms:.4f} ms '
          f'({copy_warm:.4f} ms warm)', flush=True)
    result = {}
    for layout, t in tables.items():
        kern, plain = _sampler_fns(layout, t)
        k_ms = _cold_ms(lambda: kern(slots, u), 100)
        warm_ms = _cuda_ms(lambda: kern(slots, u), 100)
        p_ms = _cold_ms(lambda: plain(slots, u), 20)
        k_call = _call_ms(lambda: kern(slots, u), 100)
        nbytes = _sampler_bytes(layout, t, slots, u, out[layout][2])
        bound = _bound(nbytes=nbytes)
        print(f'kernels: sample_{layout} {tag}: kernel {k_ms:.4f} ms on the '
              f'device with a cold L2 ({warm_ms:.4f} ms warm, back to back; '
              f'{k_call:.4f} ms per call by the host clock), plain '
              f'{p_ms:.4f} ms cold ({t.nbytes} table bytes), bound '
              f'{bound[0]:.4f} ms (bytes: {nbytes} on these draws, '
              f'{nbytes / slots.shape[0] / N:.1f} a point), share '
              f'{bound[0] / k_ms:.3f} cold, {bound[0] / warm_ms:.3f} warm',
              flush=True)
        if bound[0] > k_ms:
            raise AssertionError(f'sample_{layout} {tag}: {k_ms:.4f} ms is '
                                 f'under its bound {bound[0]:.4f} ms')
        result[layout] = (out[layout][0], k_ms, p_ms, *bound)
    return result


def phase_sampler(data_dir, tmp):
    """B5/B6 on the everyday set's tables and on ragged soups, at an
    everyday batch's K and at the dense bound B*P."""
    from multi_part_assembly_tpu_torch.datasets import GeometryPartDataset
    ds = GeometryPartDataset(data_dir, 'everyday.train.txt', DATA_KEYS,
                             num_points=N, max_num_part=P)
    sets = {'everyday': (ds.all_mesh_paths(), ds.sampler),
            'ragged': (_write_soups(os.path.join(tmp, 'soups')),
                       ds.sampler)}
    rng = np.random.default_rng(5)
    results = None
    for name, (paths, sampler) in sets.items():
        tables = {}
        for layout in ('dense', 'chunked'):
            t0 = time.perf_counter()
            tables[layout] = DS.build_device_tables(paths, sampler, 'cuda',
                                                    layout=layout)
            torch.cuda.synchronize()
            print(f'kernels: {name} {layout} tables of {len(paths)} pieces '
                  f'built in {time.perf_counter() - t0:.2f} s, '
                  f'{tables[layout].nbytes} bytes in all', flush=True)
        for layout, t in tables.items():
            records = DS.table_records(t.table)
            print(f'kernels: {name} {layout} records (the table, stored '
                  f'face-major; built above): {records.numel() * 4} bytes, '
                  f'contiguous {records.is_contiguous()}', flush=True)
        if name == 'everyday':  # the slots of one real batch
            ds._device_tables = tables['dense']
            order = rng.permutation(len(ds))[:B].tolist()
            slots = ds.collate_batch(order)['part_slots__packed']
        else:  # as many rows, drawn over the ragged pieces
            slots = rng.integers(0, len(paths), len(slots))
        for i, rows in enumerate((slots, rng.integers(0, len(paths), B * P))):
            rows = torch.as_tensor(rows, dtype=torch.int32, device='cuda')
            r = _check_sampler(name, tables, rows, seed=10 + i)
            if name == 'everyday' and i == 0:
                results = {f'sample_{k}': v for k, v in r.items()}
    return results


SLICE_COUNTS = [12, 5]
EULER_KEYS = ('rot_mse', 'rot_rmse', 'rot_mae')
EVAL_KEYS = ('part_acc',) + tuple(f'{k}_{m}' for k in ('trans', 'rot')
                                  for m in ('mse', 'rmse', 'mae'))


class _indices:
    """The port's kNN graphs, FPS samples and ball sets handed over
    (consumed in order) and/or recorded, for as long as the block runs;
    yields (kNN results, {'fps': [...], 'ball': [...]}) when recording."""

    def __init__(self, graph=(), fps=(), ball=(), record=False):
        self.args = (list(graph), list(fps), list(ball), record)

    def __enter__(self):
        graph, fps, ball, record = self.args
        KNN.set_knn_override(graph, record=record)
        SMP.set_sampling_override(fps, ball, record=record)
        return KNN.knn_calls(), SMP.sampling_calls()

    def __exit__(self, *exc):
        KNN.set_knn_override()
        SMP.set_sampling_override()


def _given(graph, sampling):
    """_indices' keywords that replay a recording."""
    return dict(graph=list(graph), fps=list(sampling['fps']),
                ball=list(sampling['ball']))


def _slice_batch(counts=SLICE_COUNTS, seed=3):
    """One flagship batch on the card: parts of shapes of `counts` parts
    (default: the small slice batch), random unit quaternions and
    translations."""
    x, _, valids = _clouds(counts, seed)
    b = len(counts)
    g = torch.Generator(device='cuda').manual_seed(seed + 1)
    return {
        'part_pcs': x, 'part_valids': valids,
        'part_quat': torch.nn.functional.normalize(
            torch.randn((b, P, 4), generator=g, device='cuda'), dim=-1)
        * valids[..., None],
        'part_trans': 0.3 * torch.randn((b, P, 3), generator=g,
                                        device='cuda') * valids[..., None],
        'part_label': torch.zeros((b, P, 0), device='cuda'),
        'instance_label': torch.zeros((b, P, 0), device='cuda'),
    }


def _slice_rot_type(rot_type, batch):
    """MoN loss + gradients of the batch in train mode, then the eval logs
    with the full metric set, on the card (kernels) against the CPU (plain
    chamfer), the same f32 weights and batch-norm statistics."""
    from multi_part_assembly_tpu_torch.models import build_model
    from multi_part_assembly_tpu_torch.train.core import mon_loss
    from multi_part_assembly_tpu_torch.utils import load_cfg_file
    cfg = load_cfg_file(FLAGSHIP_CFG)
    cfg.exp.bf16 = False
    cfg.model.rot_type = rot_type
    torch.manual_seed(0)
    model = build_model(cfg).train()
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    out = {}
    for device in ('cpu', 'cuda'):
        m = model.to(device)
        m.zero_grad()
        loss, _ = mon_loss(m, {k: v.to(device) for k, v in batch.items()},
                           cfg=cfg, training=True)
        loss.backward()
        out[device] = (float(loss.detach()), torch.cat(
            [p.grad.reshape(-1).cpu() for p in m.parameters()]))
    (l_cpu, g_cpu), (l_gpu, g_gpu) = out['cpu'], out['cuda']
    rel_loss = abs(l_gpu - l_cpu) / abs(l_cpu)
    rel_grad = float((g_gpu - g_cpu).norm() / g_cpu.norm())
    print(f'slice[{rot_type}]: mon_loss card {l_gpu:.7f} vs CPU {l_cpu:.7f} '
          f'(rel {rel_loss:.2e}, tolerance 1e-4); gradient rel. L2 diff '
          f'{rel_grad:.2e} (tolerance 1e-3)', flush=True)
    if not (math.isfinite(l_gpu) and rel_loss <= 1e-4 and rel_grad <= 1e-3):
        raise AssertionError(f'the card disagrees with the CPU on one step '
                             f'({rot_type})')
    _check_eval_logs(rot_type, model, cfg, batch)


def _check_eval_logs(tag, model, cfg, batch):
    """The eval logs of the batch with the full metric set, card against
    CPU: the Euler metrics within 1e-3 degrees, the rest within 1e-5.  The
    card takes the CPU's kNN graphs, FPS samples and ball sets."""
    from multi_part_assembly_tpu_torch.train.core import mon_loss
    logs = {}
    model.eval()
    with torch.no_grad():
        with _indices(record=True) as (graph, sampling):
            m = model.to('cpu')
            _, lg = mon_loss(m, {k: v.cpu() for k, v in batch.items()},
                             cfg=cfg, training=False, reduce=False)
            logs['cpu'] = {k: v.cpu().double() for k, v in lg.items()}
            given = _given(graph, sampling)
        with _indices(**given):
            m = model.to('cuda')
            _, lg = mon_loss(m, {k: v.cuda() for k, v in batch.items()},
                             cfg=cfg, training=False, reduce=False)
            logs['cuda'] = {k: v.cpu().double() for k, v in lg.items()}
    worst = {}
    for k, cpu in logs['cpu'].items():
        gpu = logs['cuda'][k]
        if k in EULER_KEYS:  # degrees: rot_mse compared as its root
            root = (lambda t: t.sqrt()) if k == 'rot_mse' else \
                (lambda t: t)
            worst[k] = (float((root(gpu) - root(cpu)).abs().max()), 1e-3)
        else:  # 1e-5, relative to values above 1
            worst[k] = (float(((gpu - cpu).abs() /
                               cpu.abs().clamp(min=1.0)).max()), 1e-5)
    missing = [k for k in EVAL_KEYS if k not in logs['cuda']]
    finite = all(bool(torch.isfinite(v).all()) for v in logs['cuda'].values())
    print(f'slice[{tag}]: eval logs of one batch, card vs CPU, largest '
          f'difference (tolerance): ' + ', '.join(
              f'{k} {d:.2e} ({t:g})' for k, (d, t) in sorted(worst.items())),
          flush=True)
    if missing or not finite or any(d > t for d, t in worst.values()):
        raise AssertionError(f'eval logs ({tag}): missing {missing}, '
                             f'finite {finite}, or the card disagrees with '
                             'the CPU')


def phase_slice():
    """One small flagship-width batch, quaternion and 6D heads: the MoN
    loss and gradients, and the eval metrics, card against CPU."""
    batch = _slice_batch()
    for rot_type in ('quat', 'rmat'):
        _slice_rot_type(rot_type, batch)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def phase_repulsion():
    """repulsion_cd_loss forward and backward through B7 at flagship
    shapes: scan route against dense route, kernel against plain version
    on the card, and the card against the CPU at B=2, P=6, N=200.  Returns
    the counters of the kernel runs, reset just before them."""
    from multi_part_assembly_tpu_torch.utils import loss as L
    rng = np.random.default_rng(0)
    counts = rng.choice(PART_POOL, B)
    counts[0] = 20
    parts, _, valids = _clouds(counts.tolist(), 8)
    thre = 0.01
    routes = {'scan': 0, 'dense': 2**62}
    default = 'scan' if B * P * P * N * N > 2**27 else 'dense'

    def run(limit, plain, pts=parts, v=valids):
        p = pts.clone().requires_grad_()
        cd = L.repulsion_cd_matrix(p.detach(), limit, plain=plain)
        loss = L.repulsion_cd_loss(p, v, thre, limit, plain=plain)
        loss.sum().backward()
        return cd, loss.detach(), p.grad

    tracing.reset()
    kern = {name: run(limit, False) for name, limit in routes.items()}
    torch.cuda.synchronize()
    counters = _launches()
    expected = 2 * (2 * P + 2)  # matrix + loss; scan 2 a part, dense 2
    print(f'slice: repulsion_cd_loss B={B} P={P} N={N}, scan and dense '
          f'routes (the default here: {default}): kernel launches '
          f'{counters}', flush=True)
    if counters['nn_dir'] != expected or any(
            v for k, v in counters.items() if k != 'nn_dir'):
        raise AssertionError(f'repulsion: expected {expected} nn_dir '
                             f'launches and no other, got {counters}')
    (cd_s, l_s, g_s), (cd_d, l_d, g_d) = kern['scan'], kern['dense']
    cd_rel, loss_rel = _rel(cd_s, cd_d), _rel(l_s, l_d)
    finite = all(bool(torch.isfinite(t).all()) for t in (cd_s, l_s, g_s))
    print(f'slice: repulsion scan vs dense: cd matrices rel {cd_rel:.3e}, '
          f'losses rel {loss_rel:.3e} (tolerance 1e-6); loss mean '
          f'{float(l_s.mean()):.6f}, cd mean {float(cd_s.mean()):.6f}',
          flush=True)
    if not (finite and cd_rel <= 1e-6 and loss_rel <= 1e-6 and
            l_s.shape == (B, ) and cd_s.shape == (B, P, P)):
        raise AssertionError('repulsion: the scan and dense routes disagree')
    for name, limit in routes.items():
        _, l_p, g_p = run(limit, True)
        _, l_k, g_k = kern[name]
        err = float((g_k - g_p).abs().max())
        tol = GRAD_RTOL * float(g_p.abs().max()) + GRAD_ATOL
        print(f'slice: repulsion {name} route kernel vs plain: loss bitwise '
              f'equal {torch.equal(l_k, l_p)}, max|grad kernel - grad plain| '
              f'= {err:.3e} (tolerance {tol:.3e})', flush=True)
        if not torch.equal(l_k, l_p) or not err <= tol:
            raise AssertionError(f'repulsion {name}: kernel disagrees with '
                                 'the plain version')
    with torch.no_grad():
        k_ms = _cuda_ms(lambda: L.repulsion_cd_loss(parts, valids, thre), 5)
        p_ms = _cuda_ms(lambda: L.repulsion_cd_loss(parts, valids, thre,
                                                    plain=True), 1)
    print(f'slice: repulsion forward, default ({default}) route: kernel '
          f'{k_ms:.4f} ms, plain {p_ms:.4f} ms', flush=True)
    small, _, small_v = _clouds([3, 6], 9)
    small = small[:, :6, :200].contiguous()
    small_v = small_v[:, :6].contiguous()
    for name, limit in (('scan', 0), ('dense', 2**27)):
        _, l_k, _ = run(limit, False, small, small_v)
        _, l_c, _ = run(limit, True, small.cpu(), small_v.cpu())
        rel = _rel(l_k.cpu(), l_c)
        print(f'slice: repulsion {name} route B=2 P=6 N=200, card vs CPU: '
              f'loss rel {rel:.3e} (tolerance 1e-5)', flush=True)
        if not rel <= 1e-5:
            raise AssertionError(f'repulsion {name}: the card disagrees '
                                 'with the CPU')
    return counters


def _make_everyday_set(root):
    """Synthetic everyday-format set: 128 shapes, part counts from the
    everyday mix (one with 20 parts), detail-8 box meshes."""
    from make_synthetic_data import generate
    rng = np.random.default_rng(0)
    counts = rng.choice(PART_POOL, 128)
    counts[0] = 20
    lines = []
    for i, n in enumerate(counts):
        generate(root, n_shapes=1, min_parts=int(n), max_parts=int(n),
                 seed=i, category=f'S{i:03d}', detail=8)
        lines.append(f'S{i:03d}/obj000')
    for split in ('train', 'val'):
        with open(os.path.join(root, f'everyday.{split}.txt'), 'w') as f:
            f.write('\n'.join(lines) + '\n')
    return int(counts.sum())


def _launches():
    """The kernels' launches since the last `tracing.reset()`, by key."""
    counted = tracing.counters()
    return {k: counted.get('launch.' + k, 0) for k in LAUNCH_KEYS}


def _loss_launches(launches):
    """launches without the PointNet's (the masked batch norm's and the
    max-pool's): the loss's, the LAP's and the sampler's kernels, which the
    phases that count them a step compare exactly (the PointNet's are
    checked on the flagship's main runs, `_train_run`)."""
    return {k: v for k, v in launches.items()
            if k not in BN_KEYS + POOL_KEYS}


DENSE = ['data.device_sampling', 'True', 'data.device_table_layout', 'dense']
# (label, extra --opts, table layout expected (None: the host wire), the
# sampling kernel that must launch, chamfer fused mode).  On the 768-face
# boxes the auto rule picks chunked: dense scans 2 x 768 one-hot columns,
# chunked 2 x 512.
RUNS = [
    ('host wire', ['data.device_sampling', 'False'], None, None, 'auto'),
    ('device sampling, auto layout', ['data.device_sampling', 'True'],
     'chunked', 'sample_chunked', 'auto'),
    ('device sampling, dense layout', DENSE, 'dense', 'sample_dense',
     'auto'),
    # last as well as first, so that an order effect shows; one epoch
    # (4 steps), to make room for the semantic phases
    ('host wire, again', ['data.device_sampling', 'False', 'exp.num_epochs',
                          '1', 'exp.val_every', '1'], None, None, 'auto'),
    ('unfused chamfer route, dense layout', DENSE, 'dense', 'sample_dense',
     'off'),
    # the 6D pose head: B1-B4 take points rotated by matrices
    ('6D rotations, dense layout', DENSE + [
        'model.rot_type', 'rmat', 'exp.num_epochs', '1', 'exp.val_every',
        '1'], 'dense', 'sample_dense', 'auto'),
]


class _Timed:
    """Wall seconds of each call of some Trainer methods, the methods
    wrapped while the context is open."""

    def __init__(self, *names):
        from multi_part_assembly_tpu_torch.train.trainer import Trainer
        self.cls, self.names = Trainer, names
        self.seconds = {name: [] for name in names}

    def __enter__(self):
        self.saved = {name: getattr(self.cls, name) for name in self.names}
        for name, fn in self.saved.items():
            setattr(self.cls, name, self._wrap(name, fn))
        return self

    def _wrap(self, name, fn):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                self.seconds[name].append(time.perf_counter() - t0)
        return timed

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.cls, name, fn)

    def ms(self, name):
        return ', '.join(f'{1000 * t:.1f}' for t in self.seconds[name])


def _check_metrics(tag, metrics, prefix='val', names=EVAL_KEYS):
    """The full metric set of a validation, present and finite."""
    keys = [f'{prefix}/{k}' for k in names]
    missing = [k for k in keys if k not in metrics]
    bad = [k for k, v in metrics.items() if not math.isfinite(v)]
    print(f'{tag}: ' + ', '.join(
        f'{k} {metrics[k]:.6f}' for k in keys if k in metrics), flush=True)
    if missing or bad:
        raise AssertionError(f'{tag}: missing metrics {missing}, '
                             f'non-finite {bad}')


def _check_replayed(tag, trainer):
    """Every train step of the run a replay of the trainer's one captured
    CUDA graph (train/step.py); prints the capture's wall time."""
    compiled = trainer.compiled
    if compiled is None or compiled.captures != 1 or \
            compiled.replays != trainer.step:
        got = None if compiled is None else \
            (compiled.captures, compiled.replays)
        raise AssertionError(f'{tag}: expected {trainer.step} replays of '
                             f'one capture, got {got}')
    print(f'{tag}: {compiled.replays} train steps, each a replay of one '
          f'CUDA graph captured in {compiled.capture_seconds:.2f} s '
          f'({WARMUP_STEPS} warm-up steps undone, {compiled.traced} step '
          f'bodies traced); groups of {trainer.steps_per_call}', flush=True)


def _wire_stats(batch):
    """(bytes a host batch ships to the card, its packed f16 rows' shape
    and their K when the batch is the host wire's, else None)."""
    nbytes = sum(v.numel() * v.element_size() for v in batch.values()
                 if torch.is_tensor(v))
    rows = batch.get('part_pcs_raw__packed')
    if rows is None:
        return nbytes, None
    return nbytes, (str(rows.dtype), tuple(rows.shape),
                    int(batch['part_counts'].sum()))


class _Wire:
    """Records each host batch the trainer's placement stage receives
    (train/trainer.py `device_batch`, looked up at each call), from
    whichever thread runs it: its wire statistics and the thread's name."""

    def __init__(self):
        from multi_part_assembly_tpu_torch.train import trainer as TR
        self.module, self.batches = TR, []

    def __enter__(self):
        self.real = self.module.device_batch

        def recording(batch, cfg, device):
            self.batches.append(_wire_stats(batch) + (
                len(batch['part_counts']),
                threading.current_thread().name))
            return self.real(batch, cfg, device)

        self.module.device_batch = recording
        return self

    def __exit__(self, *exc):
        self.module.device_batch = self.real

    def train(self):
        """The train batches' (bytes, host rows) (batch B; validation runs
        2B), each placed on the loader's transform thread."""
        out = [(n, rows) for n, rows, b, _ in self.batches if b == B]
        where = {t for *_, t in self.batches}
        if where != {'loader-transform'}:
            raise AssertionError(f'host batches placed on {where}')
        return out


def _train_run(index, data_dir, tmp):
    """One flagship run through train_torch.main: three epochs and a
    validation, every launch counter reset just before it."""
    import train_torch
    from multi_part_assembly_tpu_torch.train.trainer import Trainer
    label, opts, layout, sampler_key, mode = RUNS[index]
    launches = {}
    validate = Trainer.validate
    prev_mode = C.fused_mode()

    def counted_validate(self, epoch):
        launches['train'] = _launches()
        metrics = validate(self, epoch)
        launches['val'] = {k: v - launches['train'][k]
                           for k, v in _launches().items()}
        return metrics

    run_dir = os.path.join(tmp, f'run{index}')
    Trainer.validate = counted_validate
    C.set_fused_mode(mode)
    try:
        with _Timed('save_checkpoint', '_export_val_vis') as timed, \
                _Wire() as wire:
            torch.cuda.reset_peak_memory_stats()
            tracing.reset()
            t0 = time.perf_counter()
            trainer = train_torch.main([
                '--cfg_file', FLAGSHIP_CFG, '--ckp_dir', run_dir,
                '--opts', 'data.data_dir', data_dir, 'exp.num_epochs', '3',
                'exp.val_every', '3', *opts])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            totals = _launches()
    finally:
        Trainer.validate = validate
        C.set_fused_mode(prev_mode)
    with open(os.path.join(run_dir, 'metrics.jsonl')) as f:
        records = [json.loads(line) for line in f]
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    tag = f'main[{label}]'
    train = [r for r in records if 'train/loss' in r]
    losses = [r['train/loss'] for r in train]
    steps = trainer.step_seconds
    if len(steps) < 4:
        raise AssertionError(f'{tag}: expected >= 4 train steps, ran '
                             f'{len(steps)}')
    if not all(math.isfinite(v) for v in losses + list(
            trainer.metrics.values())):
        raise AssertionError(f'{tag}: non-finite loss: {losses} '
                             f'{trainer.metrics}')
    ms = 1000.0 * sum(steps[1:]) / len(steps[1:])
    waits = [1000.0 * r['train/data_time'] for r in train]
    wait_ms = sum(waits[1:]) / len(waits[1:])
    tables = trainer.tables['train']
    where = 'host-sampled clouds' if tables is None else \
        f'{tables.layout} tables of {tables.nbytes} bytes'
    print(f'{tag}: {where}; {len(steps)} train steps of batch {B}, first '
          f'{1000 * steps[0]:.1f} ms, then {ms:.2f} ms/step = '
          f'{B / (ms / 1000):.1f} samples/s; data wait {wait_ms:.3f} ms/step '
          f'(at most {max(waits[1:]):.1f}; first step {waits[0]:.1f} ms); '
          f'peak memory {peak_gib:.2f} GiB; wall {wall:.1f} s', flush=True)
    print(f'{tag}: train losses {["%.5f" % v for v in losses]}; val '
          f'part_acc {trainer.metrics["val/part_acc"]:.4f}, val loss '
          f'{trainer.metrics["val/loss"]:.5f}', flush=True)
    _check_metrics(tag, trainer.metrics)
    # the wire: packed f16 rows, exactly K of them, on the host wire
    sent = wire.train()
    bad = [rows for _, rows in sent if layout is None and (
        rows is None or rows[0] != 'torch.float16' or
        rows[1][0] != rows[2] or rows[1][1:] != (N, 3))]
    if not sent or bad or (layout is not None and any(
            rows is not None for _, rows in sent)):
        raise AssertionError(f'{tag}: wire batches {bad or sent[:2]}')
    nbytes = sum(n for n, _ in sent) / len(sent)
    print(f'{tag}: {len(sent)} train batches on the wire, '
          f'{nbytes:.0f} bytes a batch (the f32 dense batch would be '
          f'{B * P * N * 3 * 4} bytes)' + ('' if layout is not None else
                                          f'; packed f16 rows, exactly K '
                                          f'(K = {sent[0][1][2]}, ...)'),
          flush=True)
    saved = trainer.ckpt_mgr.all_steps()
    writes = ', '.join(f'{1000 * t:.1f}'
                       for t in trainer.ckpt_mgr.write_seconds)
    print(f'{tag}: checkpoint save on the training thread '
          f'{timed.ms("save_checkpoint")} ms, its writer {writes} ms; val '
          f'export of {trainer.cfg.exp.val_sample_vis} shapes a split '
          f'{timed.ms("_export_val_vis")} ms; checkpoints kept {saved}',
          flush=True)
    if saved != [trainer.cfg.exp.num_epochs - 1]:
        raise AssertionError(f'{tag}: expected one checkpoint, got {saved}')
    print(f'{tag}: kernel launches in training {launches["train"]}, in '
          f'validation {launches["val"]}', flush=True)
    _check_replayed(tag, trainer)

    if (None if tables is None else tables.layout) != layout or \
            (trainer.tables['val'] is None) != (layout is None):
        raise AssertionError(f'{tag}: expected the {layout or "host"} wire')
    # per route: the fused run launches B1-B4 (the diagonal forward in
    # validation) and never B8; the unfused run B8 in training and in
    # validation and never B1-B4; no geometric run launches B7 or L1
    train_keys = ('nn_off', ) if mode == 'off' else FUSED_KEYS
    val_key = 'nn_off' if mode == 'off' else 'nn_diag'
    never = FUSED_KEYS + ('nn_dir', 'lap', 'lap_cost') if mode == 'off' \
        else ('nn_off', 'nn_dir', 'lap', 'lap_cost')
    for key in train_keys:
        if launches['train'][key] <= 0:
            raise AssertionError(f'{tag}: {key} never launched in training')
    if launches['val'][val_key] <= 0:
        raise AssertionError(f'{tag}: {val_key} never launched in '
                             'validation')
    for key in never:
        for split in ('train', 'val'):
            if launches[split][key]:
                raise AssertionError(
                    f'{tag}: {key} launched {launches[split][key]} times in '
                    f'{split} on the {mode} route')
    for key in SAMPLER_KEYS:
        for split in ('train', 'val'):
            if (launches[split][key] > 0) != (key == sampler_key):
                raise AssertionError(
                    f'{tag}: {key} launched {launches[split][key]} times in '
                    f'{split}')
    # the PointNet's five batch norms take the kernels in every traced
    # train step body (moments, apply, backward once a layer) and the plain
    # arithmetic in validation (eval mode)
    bn_train = {k: len(BN_WIDTHS) * trainer.compiled.traced
                for k in BN_KEYS}
    for split, want in (('train', bn_train),
                        ('val', dict.fromkeys(BN_KEYS, 0))):
        got = {k: launches[split][k] for k in BN_KEYS}
        if got != want:
            raise AssertionError(f'{tag}: masked batch norm launches in '
                                 f'{split} {got}, expected {want}')
    # its max-pool takes the kernels once forward and once backward a
    # traced train step body, and forward alone in validation
    got, val = ({k: launches[split][k] for k in POOL_KEYS}
                for split in ('train', 'val'))
    want = dict.fromkeys(POOL_KEYS, trainer.compiled.traced)
    if got != want or val['pool_fwd'] <= 0 or val['pool_bwd']:
        raise AssertionError(f'{tag}: max-pool launches in training {got} '
                             f'(expected {want}), in validation {val}')
    return totals, (ms, wait_ms, losses[0], nbytes)


def phase_main(data_dir, tmp):
    totals, times = {}, []
    for index in range(len(RUNS)):
        launches, t = _train_run(index, data_dir, tmp)
        times.append(t)
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
    print('main: ' + '; '.join(
        f'{label} {ms:.2f} ms/step, data wait {wait:.3f} ms, '
        f'{nbytes:.0f} bytes a batch'
        for (label, *_), (ms, wait, _, nbytes) in zip(RUNS, times)),
        flush=True)
    fused, unfused = times[2][2], times[4][2]
    print(f'main: first-step train loss, dense layout: fused route '
          f'{fused:.7f}, unfused route {unfused:.7f} (rel '
          f'{abs(unfused - fused) / abs(fused):.2e}; printed, not a gate)',
          flush=True)
    return totals


def _state(trainer):
    """Every parameter, buffer and optimizer tensor of a trainer, as
    (name, tensor) on the CPU."""
    out = list(trainer.model.state_dict().items())
    opt = trainer.optimizer.state_dict()
    for pid, st in sorted(opt['state'].items()):
        out += [(f'opt.{pid}.{k}', v) for k, v in sorted(st.items())]
    return [(n, v.detach().cpu()) for n, v in out]


def _differing(a, b):
    """Names of the tensors of two _state lists that are not bitwise equal
    (dtype and shape included)."""
    if [n for n, _ in a] != [n for n, _ in b]:
        return ['<names>']
    return [n for (n, x), (_, y) in zip(a, b)
            if x.dtype != y.dtype or not torch.equal(x, y)]


def _adam_steps_placed(trainer):
    """Adam's step counts in f32 where the optimizer keeps them: on the
    card for a capturable one (one rank on the card), else on the CPU."""
    return all(
        st['step'].dtype == torch.float32 and st['step'].device.type ==
        (trainer.device.type if g['capturable'] else 'cpu')
        for g in trainer.optimizer.param_groups
        for st in (trainer.optimizer.state[p] for p in g['params']))


def _epoch_losses(trainer, epoch):
    """One epoch of the trainer's own loop (graphed where it replays);
    the losses of its steps as logged."""
    rows = []
    trainer.logger.log = lambda record, step=None, echo=None: \
        rows.append(record)
    try:
        trainer.train_epoch(epoch)
    finally:
        del trainer.logger.log
    return [r['train/loss'] for r in rows if 'train/loss' in r]


def phase_resume(data_dir, tmp):
    """The flagship on the dense slot wire, fused route: 2 epochs with a
    validation and a checkpoint each; test_torch.py from the second
    checkpoint against the trainer's test(), bit for bit; a new Trainer on
    the same ckp_dir resumes at epoch 2 with every parameter, buffer and
    Adam moment bitwise; the checkpoint loads into a CPU trainer and back;
    then one more epoch in each trainer from the same generator states
    gives bitwise the same losses and weights.  Returns the launch counts
    of the run, reset just before it."""
    import test_torch
    import train_torch
    from multi_part_assembly_tpu_torch.train.trainer import Trainer
    ckp = os.path.join(tmp, 'resume')
    opts = ['data.data_dir', data_dir, 'exp.num_epochs', '2',
            'exp.val_every', '1', *DENSE]
    cfg = train_torch.build_cfg(train_torch.parse_args(
        ['--cfg_file', FLAGSHIP_CFG, '--ckp_dir', ckp, '--opts', *opts]))
    tracing.reset()
    with _Timed('save_checkpoint', '_export_val_vis', '_try_resume') as timed:
        first = Trainer(cfg, 'cuda', ckp_dir=ckp)
        t0 = time.perf_counter()
        first.fit()
        fit_s = time.perf_counter() - t0
        kept = first.ckpt_mgr.all_steps()
        _check_metrics('resume[fit]', first.metrics)
        if kept != [0, 1] or first.tables['train'].layout != 'dense':
            raise AssertionError(f'resume: expected checkpoints [0, 1] on '
                                 f'the dense wire, got {kept}')
        # test_torch.py in-process against the trainer's own test()
        step_dir = os.path.join(ckp, 'models', '1')
        first.generator.manual_seed(cfg.exp.seed)
        ref = first.test()
        got = test_torch.main(['--cfg_file', FLAGSHIP_CFG, '--device',
                               'cuda', '--weight', step_dir, '--opts', *opts])
        diff = sorted(k for k in ref if got.get(k) != ref[k])
        print(f'resume: test_torch.py --weight models/1 against the '
              f'trainer\'s test(): {len(ref)} test/* metrics, bitwise '
              f'different {diff}', flush=True)
        if diff or set(got) != set(ref):
            raise AssertionError(f'resume: test_torch.py differs on {diff}')
        _check_metrics('resume[test]', got, prefix='test')

        t0 = time.perf_counter()
        second = Trainer(cfg, 'cuda', ckp_dir=ckp)
        build_s = time.perf_counter() - t0
        differ = _differing(_state(second), _state(first))
        print(f'resume: new Trainer on the ckp_dir: start_epoch '
              f'{second.start_epoch}, step {second.step} (first trainer '
              f'{first.step}); tensors not bitwise equal to the first '
              f'trainer\'s: {differ} of {len(_state(first))}; Adam steps '
              f'in f32 on the card (capturable) {_adam_steps_placed(second)}',
              flush=True)
        if second.start_epoch != 2 or second.step != first.step or differ \
                or not _adam_steps_placed(second):
            raise AssertionError('resume: the resumed state differs')

        # card -> CPU -> card: the checkpoint loads into a CPU trainer,
        # whose own save loads back onto the card
        cpu_cfg = cfg.clone()
        cpu_cfg.defrost()
        cpu_cfg.data.device_sampling = False
        cpu = Trainer(cpu_cfg, 'cpu', ckp_dir=os.path.join(tmp, 'cpu'),
                      resume=False, quiet=True)
        cpu.load_weights(step_dir)
        cpu_differ = _differing(_state(cpu), _state(first))
        cpu.save_checkpoint(1, first.metrics)
        cpu.ckpt_mgr.wait_until_finished()  # the save is asynchronous
        second.load_weights(os.path.join(tmp, 'cpu', 'models', '1'))
        back_differ = _differing(_state(second), _state(first))
        print(f'resume: card checkpoint loaded on the CPU, tensors not '
              f'bitwise equal {cpu_differ}, Adam steps on the CPU in f32 '
              f'{_adam_steps_placed(cpu)}; the CPU trainer\'s checkpoint '
              f'loaded on the card: not bitwise equal {back_differ}, Adam '
              f'steps on the card in f32 {_adam_steps_placed(second)}',
              flush=True)
        if cpu_differ or back_differ or not _adam_steps_placed(cpu) or \
                not _adam_steps_placed(second):
            raise AssertionError('resume: a checkpoint changed crossing '
                                 'devices')
        cpu.close()

        # one more epoch in each from the same generator states
        states = (first.generator.get_state(), torch.get_rng_state(),
                  torch.cuda.get_rng_state())
        losses = _epoch_losses(first, 2)
        second.generator.set_state(states[0])
        torch.set_rng_state(states[1])
        torch.cuda.set_rng_state(states[2])
        again = _epoch_losses(second, 2)
        torch.cuda.synchronize()
    launches = _launches()
    after = _differing(_state(second), _state(first))
    print(f'resume: epoch 2 in both trainers from the same generator '
          f'states: losses {["%.7f" % v for v in losses]} and '
          f'{["%.7f" % v for v in again]}, bitwise equal {again == losses}; '
          f'tensors not bitwise equal after it: {after}', flush=True)
    print(f'resume: fit of 2 epochs {fit_s:.2f} s; checkpoint saves (the '
          f'fit\'s two, then the CPU trainer\'s) '
          f'{timed.ms("save_checkpoint")} ms; val export '
          f'{timed.ms("_export_val_vis")} ms a validation; resume (load '
          f'and restore) {1000 * timed.seconds["_try_resume"][-1]:.1f} ms '
          f'within a Trainer build of {build_s:.2f} s', flush=True)
    if again != losses or after or not all(map(math.isfinite, losses)):
        raise AssertionError('resume: the resumed epoch differs from the '
                             'uninterrupted one')
    print(f'resume: kernel launches {launches}', flush=True)
    for key in FUSED_KEYS + ('sample_dense', ):
        if launches[key] <= 0:
            raise AssertionError(f'resume: {key} never launched')
    for key in ('nn_off', 'nn_dir', 'sample_chunked', 'lap', 'lap_cost'):
        if launches[key]:
            raise AssertionError(f'resume: {key} launched {launches[key]} '
                                 'times')
    first.close()
    second.close()
    return launches


# the other geometric families: (everyday config, supervised iterations
# a train step T, which B1-B4 launch T times)
FAMILIES = {
    'global': ('configs/global/global-32x1-cosine_200e-everyday.py', 1),
    'lstm': ('configs/lstm/lstm-32x1-cosine_200e-everyday.py', 1),
    'dgl': ('configs/dgl/dgl-32x1-cosine_200e-everyday.py', 3),
    'rgl_net': ('configs/rgl_net/rgl_net-32x1-cosine_200e-everyday.py', 3),
    'pn_transformer_refine': (
        'configs/pn_transformer/pn_transformer_refine/'
        'pn_transformer_refine-32x1-cosine_400e-everyday.py', 3),
    'identity': ('configs/identity/identity-32x1-cosine_200e-everyday.py',
                 1),
}


def _grads(model):
    """Every parameter's gradient, flat on the CPU (None as zeros)."""
    return torch.cat([(torch.zeros_like(p) if p.grad is None else p.grad)
                      .reshape(-1).cpu() for p in model.parameters()])


def _step(model, batch, cfg, device):
    """One train-mode MoN loss and its gradients on `device`."""
    from multi_part_assembly_tpu_torch.train.core import mon_loss
    m = model.to(device)
    m.zero_grad(set_to_none=True)
    loss, _ = mon_loss(m, {k: v.to(device) for k, v in batch.items()},
                       cfg=cfg, training=True)
    if loss.requires_grad:
        loss.backward()
    return float(loss.detach()), _grads(m)


def _slice_family(family, batch):
    """One MoN loss and its gradients in train mode on the card (kernels)
    against the CPU (plain chamfer), the same f32 weights and batch-norm
    statistics, dropout off, and the same draws (LSTM's hidden noise and
    teacher-forcing flag, RGL-Net's initial hidden states, made on the
    host); then the eval logs of the batch.  Identity: loss and logs.

    DGL's and RGL-Net's batch norms run over every row with the batch's
    statistics, which makes their gradient ill-conditioned: it moves when
    the inputs move by an ulp (tests/test_torch_dgl.py).  So the gradient
    limit, 1e-3 relative L2 as the flagship's, adds twice the card
    gradient's own movement under relative 1e-7 and 1e-6 nudges of the
    clouds, printed beside it (for Global and LSTM that term is small)."""
    from multi_part_assembly_tpu_torch.models import build_model
    from multi_part_assembly_tpu_torch.utils import load_cfg_file
    cfg = load_cfg_file(os.path.join(ROOT, FAMILIES[family][0]))
    cfg.exp.bf16 = False
    torch.manual_seed(0)
    model = build_model(cfg, 'cpu').train()
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    b = batch['part_valids'].shape[0]
    g = torch.Generator().manual_seed(5)
    if family == 'lstm':
        model.hidden_noise_override = torch.randn((2, b, 16), generator=g)
        model.teacher_force_override = True
    if family == 'rgl_net':
        model.hidden_noise_override = torch.randn(
            (cfg.model.gnn_iter, 1, 2, b, 2 * cfg.model.pc_feat_dim),
            generator=g)
    (l_cpu, g_cpu), (l_gpu, g_gpu) = (_step(model, batch, cfg, d)
                                      for d in ('cpu', 'cuda'))
    rel_loss = abs(l_gpu - l_cpu) / abs(l_cpu)
    if family == 'identity':
        ok = not g_gpu.any() and not g_cpu.any()
        print(f'slice[{family}]: mon_loss card {l_gpu:.7f} vs CPU '
              f'{l_cpu:.7f} (rel {rel_loss:.2e}, tolerance 1e-4); no '
              f'gradient on either side {ok}', flush=True)
    else:
        jitter = 0.0
        for eps in (1e-7, 1e-6):
            nudged = dict(batch)
            d = torch.randn(batch['part_pcs'].shape,
                            generator=torch.Generator().manual_seed(9))
            nudged['part_pcs'] = batch['part_pcs'] * (1 + eps * d.cuda())
            g_n = _step(model, nudged, cfg, 'cuda')[1]
            jitter = max(jitter, float((g_n - g_gpu).norm() / g_gpu.norm()))
        rel_grad = float((g_gpu - g_cpu).norm() / g_cpu.norm())
        tol = 1e-3 + 2 * jitter
        ok = rel_grad <= tol
        print(f'slice[{family}]: mon_loss card {l_gpu:.7f} vs CPU '
              f'{l_cpu:.7f} (rel {rel_loss:.2e}, tolerance 1e-4); gradient '
              f'rel. L2 diff {rel_grad:.2e} (tolerance 1e-3 + 2 x '
              f'{jitter:.2e}, the card gradient\'s movement under nudges '
              f'of 1e-7 and 1e-6)', flush=True)
    if not (math.isfinite(l_gpu) and rel_loss <= 1e-4 and ok):
        raise AssertionError(f'the card disagrees with the CPU on one step '
                             f'({family})')
    _check_eval_logs(family, model, cfg, batch)


def phase_family_slices():
    """The flagship's slice check for each other family, on its everyday
    config at its published width."""
    batch = _slice_batch()
    v = batch['part_valids']
    batch['part_ids'] = torch.where(
        v > 0, torch.arange(P, device='cuda').float(), 0.0)
    batch['valid_matrix'] = v[:, :, None] * v[:, None, :]
    for family in FAMILIES:
        _slice_family(family, batch)


def _profile_steps(trainer, steps=2, tries=2, ranges=()):
    """(device kernels a step, device busy ms a step, wall ms a step,
    {range: (device ms, host ms) a step}) over `steps` train steps after a
    warm one, from torch.profiler: one run, enough to see how far the host
    keeps the card idle.  A range's device time is that of the kernels
    inside the device-side spans of the record_function ranges of that
    name (None when the profiler records no such span), its host time
    that of the host-side ranges.  A run in which the profiler records no
    device event is tried again; after `tries` such runs, None (not
    measured)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(tries):
        trainer.train_loader.set_epoch(1 + attempt)
        batches = iter(trainer.train_loader)
        trainer.train_step(next(batches))
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                trainer.train_step(next(batches))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        batches.close()
        kernels = _device_kernels(prof)
        if kernels:
            busy_us = sum(ev.time_range.elapsed_us() for ev in kernels)
            times = {name: _range_ms(prof, kernels, name, steps)
                     for name in ranges}
            return len(kernels) / steps, busy_us / 1e3 / steps, \
                1e3 * wall / steps, times
    return None


def _range_ms(prof, kernels, name, steps):
    """(device ms, host ms) a step of the record_function ranges `name`."""
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    host = sum(ev.cpu_time_total for ev in prof.events()
               if ev.name == name and ev.device_type == cpu)
    spans = [(ev.time_range.start, ev.time_range.end)
             for ev in prof.events() if ev.name == name and
             ev.device_type == cuda and getattr(ev, 'is_user_annotation',
                                                False)]
    dev = None
    if spans:
        dev = sum(k.time_range.elapsed_us() for k in kernels
                  if any(s <= k.time_range.start and k.time_range.end <= e
                         for s, e in spans)) / 1e3 / steps
    return dev, host / 1e3 / steps


def _device_kernels(prof):
    """The profiler's device events, less the device-side mirrors of
    record_function ranges (user annotations), which overlap the kernels
    they span."""
    return [ev for ev in prof.events()
            if ev.device_type == torch.autograd.DeviceType.CUDA and
            not getattr(ev, 'is_user_annotation', False)]


def _profile_line(profile):
    if profile is None:
        return 'the profiler recorded no device event: not measured'
    kernels, busy, step_ms, times = profile
    return (f'{kernels:.0f} device kernels a step, {busy:.2f} ms of device '
            f'time in {step_ms:.2f} ms a step (device idle '
            f'{100 * (1 - busy / step_ms):.1f}%)' + ''.join(
                f'; {k} ' + ('device not measured' if d is None else
                             f'{d:.3f} ms device') + f', {h:.3f} ms host'
                for k, (d, h) in times.items()))


def _family_run(family, data_dir, tmp):
    """scripts/train_torch.py's main on the family's everyday config at its
    published width, on the dense slot wire (see _epoch_run)."""
    path, T = FAMILIES[family]
    return _epoch_run(f'family[{family}]', os.path.join(ROOT, path), T,
                      [], data_dir, os.path.join(tmp, f'family_{family}'),
                      identity=family == 'identity')


def _epoch_run(tag, path, T, opts, data_dir, run_dir, batch=B, ranges=(),
               identity=False, graph_steps=4):
    """scripts/train_torch.py's main on a config, on the dense slot wire:
    one epoch (4 steps of batch 32, 8 of 16) and a validation with its
    checkpoint.
    The launch counters are reset just before it: B1-B4 must launch T
    times a train step (identity: B1 and B3 once, B2 and B4 never, since
    nothing needs a gradient), the dense sampler once a batch, and B7, B8
    and the chunked sampler never.  Then one torch.profiler run of two
    more steps (with the device time of `ranges`)."""
    import train_torch
    from multi_part_assembly_tpu_torch.train.trainer import Trainer
    launches = {}
    validate = Trainer.validate

    def counted_validate(self, epoch):
        launches['train'] = _launches()
        metrics = validate(self, epoch)
        launches['val'] = {k: v - launches['train'][k]
                           for k, v in _launches().items()}
        return metrics

    Trainer.validate = counted_validate
    try:
        with _Timed('save_checkpoint', '_export_val_vis') as timed:
            torch.cuda.reset_peak_memory_stats()
            tracing.reset()
            t0 = time.perf_counter()
            trainer = train_torch.main([
                '--cfg_file', path, '--ckp_dir', run_dir,
                '--opts', 'data.data_dir', data_dir, 'exp.num_epochs', '1',
                'exp.val_every', '1', 'exp.batch_size', str(batch), *DENSE,
                *opts])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            totals = _launches()
    finally:
        Trainer.validate = validate
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    with open(os.path.join(run_dir, 'metrics.jsonl')) as f:
        train = [r for r in map(json.loads, f) if 'train/loss' in r]
    losses = [r['train/loss'] for r in train]
    steps = trainer.step_seconds
    n_steps = 4 * B // batch  # the set's 128 train shapes
    if len(steps) != n_steps or not all(map(math.isfinite, losses)):
        raise AssertionError(f'{tag}: expected {n_steps} finite train '
                             f'steps, got {losses}')
    ms = 1000.0 * sum(steps[1:]) / len(steps[1:])
    waits = [1000.0 * r['train/data_time'] for r in train]
    wait_ms = sum(waits[1:]) / len(waits[1:])
    print(f'{tag}: {trainer.tables["train"].layout} tables; {len(steps)} '
          f'train steps of batch {batch}, first {1000 * steps[0]:.1f} ms, '
          f'then {ms:.2f} ms/step = {batch / (ms / 1000):.1f} samples/s; '
          f'data wait {wait_ms:.3f} ms/step; peak memory {peak_gib:.2f} '
          f'GiB; wall {wall:.1f} s; train losses '
          f'{["%.5f" % v for v in losses]}', flush=True)
    _check_metrics(tag, trainer.metrics)
    saved = trainer.ckpt_mgr.all_steps()
    print(f'{tag}: checkpoint save {timed.ms("save_checkpoint")} ms, val '
          f'export {timed.ms("_export_val_vis")} ms; checkpoints kept '
          f'{saved}', flush=True)
    if saved != [0] or trainer.tables['train'].layout != 'dense':
        raise AssertionError(f'{tag}: expected one checkpoint on the dense '
                             f'wire, got {saved}')
    n = len(steps)
    reason = uncapturable(trainer.cfg)
    if reason is None:
        _check_replayed(tag, trainer)
        # the wrappers count the step bodies traced (warm-ups and the
        # capture), not the replays; the sampler runs once a batch in front
        traced = trainer.compiled.traced
    elif trainer.compiled is not None:
        raise AssertionError(f'{tag}: captured a config that runs eagerly')
    else:
        print(f'{tag}: eager steps by rule ({reason})', flush=True)
        traced = n
    per_step = _step_expected(1, T, 'auto', False, identity)
    expected = {k: v * traced for k, v in per_step.items()}
    expected.update(sample_dense=n, sample_chunked=0)
    print(f'{tag}: kernel launches in training {launches["train"]} '
          f'(expected {traced} step bodies run x {per_step}: T = {T} a '
          f'step; the sampler once a batch), in validation '
          f'{launches["val"]}', flush=True)
    if _loss_launches(launches['train']) != expected:
        raise AssertionError(f'{tag}: training launches differ from the '
                             'expected counts')
    val = launches['val']
    if val['nn_diag'] <= 0 or val['sample_dense'] <= 0 or any(
            val[k] for k in ('bwd_parts', 'bwd_diag', 'nn_off', 'nn_dir',
                             'sample_chunked', 'lap', 'lap_cost')):
        raise AssertionError(f'{tag}: validation launches {val}')
    profile = _profile_steps(trainer, ranges=ranges) if ranges else None
    if ranges:
        print(f'{tag}: torch.profiler over 2 eager steps: '
              f'{_profile_line(profile)}', flush=True)
    if reason is not None:
        trainer.close()
        return totals, (ms, wait_ms, peak_gib, profile, None)
    graph = _eager_vs_graph(tag, trainer, n=graph_steps)
    replay = graph[-1]
    want = _replay_expected(1, T, 'auto', False, identity)
    if replay is None or {k: round(v, 3) for k, v in replay[0].items()} \
            != want:
        raise AssertionError(f'{tag}: a replayed step\'s kernels '
                             f'{None if replay is None else replay[0]}, '
                             f'expected {want}')
    print(f'{tag}: kernels of a replayed step by torch.profiler '
          f'{replay[0]} (expected {want}), {replay[1]:.0f} kernels, '
          f'{replay[2]:.2f} ms of device time a step', flush=True)
    trainer.close()
    return totals, (ms, wait_ms, peak_gib, profile, graph[:-1])


def _family_resume(family, data_dir, tmp):
    """2 epochs with a validation and a checkpoint each; a new Trainer on
    the same ckp_dir resumes at epoch 2 with every parameter, buffer and
    Adam moment bitwise; one more epoch in both from the same generator
    states gives bitwise the same losses and weights."""
    import train_torch
    from multi_part_assembly_tpu_torch.train.trainer import Trainer
    ckp = os.path.join(tmp, f'resume_{family}')
    cfg = train_torch.build_cfg(train_torch.parse_args([
        '--cfg_file', os.path.join(ROOT, FAMILIES[family][0]), '--ckp_dir',
        ckp, '--opts', 'data.data_dir', data_dir, 'exp.num_epochs', '2',
        'exp.val_every', '1', *DENSE]))
    tag = f'family[{family}] resume'
    first = Trainer(cfg, 'cuda', ckp_dir=ckp, quiet=True)
    first.fit()
    second = Trainer(cfg, 'cuda', ckp_dir=ckp, quiet=True)
    differ = _differing(_state(second), _state(first))
    print(f'{tag}: checkpoints {first.ckpt_mgr.all_steps()}; new Trainer '
          f'start_epoch {second.start_epoch}, step {second.step}; tensors '
          f'not bitwise equal: {differ} of {len(_state(first))}',
          flush=True)
    if first.ckpt_mgr.all_steps() != [0, 1] or second.start_epoch != 2 or \
            second.step != first.step or differ:
        raise AssertionError(f'{tag}: the resumed state differs')
    states = (first.generator.get_state(), torch.get_rng_state(),
              torch.cuda.get_rng_state())
    losses = _epoch_losses(first, 2)
    second.generator.set_state(states[0])
    torch.set_rng_state(states[1])
    torch.cuda.set_rng_state(states[2])
    again = _epoch_losses(second, 2)
    after = _differing(_state(second), _state(first))
    print(f'{tag}: epoch 2 in both from the same generator states: losses '
          f'{["%.7f" % v for v in losses]}, bitwise equal {again == losses}'
          f'; tensors not bitwise equal after it: {after}', flush=True)
    if again != losses or after or not all(map(math.isfinite, losses)):
        raise AssertionError(f'{tag}: the resumed epoch differs from the '
                             'uninterrupted one')
    first.close()
    second.close()


def phase_families(data_dir, tmp):
    """Each other family's main path (see _family_run), then DGL's resume.
    Returns the launch counts of all these runs."""
    totals, rows = {}, {}
    for family in FAMILIES:
        launches, rows[family] = _family_run(family, data_dir, tmp)
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
    print('families: ' + '; '.join(
        f'{f} {ms:.2f} ms/step in the epoch, wait {w:.3f} ms, {mem:.2f} '
        f'GiB; {_graph_summary(g)}'
        for f, (ms, w, mem, _, g) in rows.items()), flush=True)
    tracing.reset()
    _family_resume('dgl', data_dir, tmp)
    for k, v in _launches().items():
        totals[k] += v
    return totals


# ---------------------------------------------------------------------------
# the semantic (PartNet) path: L1, one MoN step card vs CPU, training
# ---------------------------------------------------------------------------

PARTNET_CFG = os.path.join(
    ROOT, 'configs/pn_transformer/pn_transformer/'
    'pn_transformer-32x1-cosine_400e-partnet_chair.py')
SEM_KEYS = ('part_acc', 'connectivity_acc')
# the other families' partnet_chair configs: (config, supervised
# iterations a sample T)
SEM_FAMILIES = {
    'global': ('configs/global/global-32x1-cosine_200e-partnet_chair.py', 1),
    'lstm': ('configs/lstm/lstm-32x1-cosine_200e-partnet_chair.py', 1),
    'dgl': ('configs/dgl/dgl-32x1-cosine_300e-partnet_chair.py', 3),
    'rgl_net': ('configs/rgl_net/rgl_net-32x1-cosine_300e-partnet_chair.py',
                3),
    'pn_transformer_refine': (
        'configs/pn_transformer/pn_transformer_refine/'
        'pn_transformer_refine-32x1-cosine_400e-partnet_chair.py', 3),
    'identity': ('configs/identity/identity-32x1-cosine_200e-'
                 'partnet_chair.py', 1),
}
# L1's cases: (M problems, n), the main path's M = B = 32 at n = P = 20
# first, then M = S x B, and small and the widest n
LAP_SHAPES = [(32, 20), (160, 20), (64, 2), (64, 3), (64, 32)]
LAP_RTOL = 1e-6  # objective against scipy's, in f64 (scipy may tie-break
#                  to another optimum)
# L2 against the plain f32 cost: tests/test_torch_lap_cost.py's tolerance
# (relative, and absolute in units of the largest squared norm of a point);
# L1 on the two costs may differ only where the objectives differ by less
# than LAP_COST_TIE
LAP_COST_RTOL, LAP_COST_ATOL = 1e-6, 2e-6
LAP_COST_TIE = 1e-4


def _make_partnet_set(root):
    """Synthetic PartNet-format set: 128 shapes of 2 to 20 parts of 1000
    points, equivalent duplicates among the parts, 96 train and 32 val."""
    from make_synthetic_data import generate_partnet
    generate_partnet(root, n_shapes=128, min_parts=2, max_parts=20,
                     num_points=N, seed=0, same_val=False,
                     split_prefix='Chair.')
    return root


def _partnet_batch(data_dir, indices):
    """Shapes of the train split through the host wire, on the CPU, as the
    trainer unpacks them."""
    from multi_part_assembly_tpu_torch.datasets.geometry import unpack_parts
    from multi_part_assembly_tpu_torch.datasets.partnet import \
        PartNetPartDataset
    from multi_part_assembly_tpu_torch.utils import load_cfg_file
    cfg = load_cfg_file(PARTNET_CFG)
    ds = PartNetPartDataset(
        data_dir, cfg.data.data_fn.format('train'), cfg.data.data_keys,
        num_part_category=cfg.data.num_part_category,
        max_num_part=cfg.data.max_num_part)
    b = ds.collate_batch(list(indices))
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()
         if k not in ('data_id', 'shape_id')}
    t['part_pcs'] = unpack_parts(t.pop('part_pcs__packed').float(),
                                 t.pop('pack_index'), t['part_valids'])
    return t


def _semantic_samples(data_dir):
    """A semantic batch's LAP-cost inputs, moved as match_parts moves them:
    32 train shapes, predicted poses the GT's jittered, S = 5 subsamples
    of 100 points -> ([(a, b)] * S, each [32, 20, 100, 3] f32 on the card,
    match_ids [32, 20] int32)."""
    from multi_part_assembly_tpu_torch.utils.transforms import transform_pc
    batch = {k: v.cuda() for k, v in _partnet_batch(
        data_dir, range(B)).items()}
    g = torch.Generator(device='cuda').manual_seed(3)
    v = batch['part_valids'][..., None]
    quat = torch.nn.functional.normalize(batch['part_quat'] + 0.3 * v * (
        torch.randn(batch['part_quat'].shape, generator=g, device='cuda')),
        dim=-1)
    trans = batch['part_trans'] + 0.05 * v * torch.randn(
        batch['part_trans'].shape, generator=g, device='cuda')
    samples = []
    for _ in range(5):
        idx = torch.randperm(N, generator=g, device='cuda')[:100]
        pts = batch['part_pcs'][:, :, idx]
        samples.append((
            transform_pc(trans, quat, pts, rot_type='quat').contiguous(),
            transform_pc(batch['part_trans'], batch['part_quat'], pts,
                         rot_type='quat').contiguous()))
    return samples, batch['match_ids'].to(torch.int32).contiguous()


def _semantic_costs(data_dir):
    """The block-masked LAP costs of `_semantic_samples`, by the plain
    functions: [S * 32, 20, 20] on the card."""
    samples, ids = _semantic_samples(data_dir)
    return torch.cat([LAP.lap_cost(LAP._pair_chamfer_cost(a, b), ids)
                      for a, b in samples]).contiguous()


def _objective(cost, perm):
    c = cost.double().cpu()
    return c.gather(2, perm.long().cpu()[..., None]).sum((1, 2))


def phase_lap(data_dir):
    """L1 against solve_lap_plain on the card (identical assignments) and
    against scipy's optimum, on random, tie-heavy and a semantic batch's
    block-masked costs; times of both at the main path's shapes.  Returns
    the kernels line's entry (M = 32, n = 20, the semantic costs)."""
    rng = np.random.default_rng(0)
    sem = _semantic_costs(data_dir)
    cases = [(f'semantic blocks M={sem.shape[0]} n=20', sem),
             ('semantic blocks M=32 n=20', sem[:B].contiguous())]
    for M_, n in LAP_SHAPES:
        cases.append((f'random M={M_} n={n}', torch.tensor(
            rng.random((M_, n, n)).astype(np.float32), device='cuda')))
        cases.append((f'ties M={M_} n={n}', torch.tensor(
            rng.integers(0, 3, (M_, n, n)).astype(np.float32),
            device='cuda')))
    for label, cost in cases:
        k = LAP.solve_lap(cost)
        p = LAP.solve_lap_plain(cost)
        torch.cuda.synchronize()
        differ = int((k != p).any(-1).sum())
        best = _objective(cost, torch.from_numpy(
            LAP.hungarian_scipy(cost.cpu().numpy())))
        got = _objective(cost, k)
        gap = float(((got - best).abs() / best.abs().clamp(min=1e-12)).max())
        print(f'lap: {label}: problems whose assignment differs from the '
              f'plain version {differ} (0 required); objective against '
              f"scipy's optimum, largest relative gap {gap:.2e} "
              f'(tolerance {LAP_RTOL:g})', flush=True)
        if differ or gap > LAP_RTOL:
            raise AssertionError(f'lap {label}: the kernel disagrees')
    out = None
    for label, cost in cases[:2]:
        M_, n = cost.shape[0], cost.shape[1]
        k_ms = _cuda_ms(lambda: LAP.solve_lap(cost), 50)
        p_ms = _cuda_ms(lambda: LAP.solve_lap_plain(cost), 3)
        # at least one Dijkstra step a row (4 operations a column: an
        # addition, two subtractions, a comparison); bytes: the cost read
        # once, the assignment written
        bound = _bound(ops=4 * M_ * n * n, nbytes=4 * M_ * n * n + 4 * M_ * n)
        print(f'lap: {label}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms '
              f'({p_ms / k_ms:.0f}x), bound {bound[0]:.5f} ms ({bound[1]}; '
              f'launch- and latency-bound at this size), share '
              f'{bound[0] / k_ms:.4f}', flush=True)
        if M_ == B:
            out = (0.0, k_ms, p_ms, *bound)
    return out


def phase_lap_cost(data_dir):
    """L2 against the plain masked cost on the card at the main path's
    shape (S = 5 samples of a semantic batch of 32, n = 100): in-group
    entries within the card tests' tolerance (tests/test_torch_lap_cost.py),
    every other entry exactly the plain one, a second launch bitwise the
    first, and L1's assignments on it the plain cost's, but on a near-tie
    (objectives on the plain cost within LAP_COST_TIE); then its time beside
    its bound and the plain version's.  Returns the kernels line's entry
    (one launch, one sample)."""
    samples, ids = _semantic_samples(data_dir)
    inb = (ids[:, :, None] == ids[:, None, :]) & (ids[:, :, None] > 0)
    err = 0.0
    for s, (a, b) in enumerate(samples):
        k = LAP.lap_cost_cuda(a, b, ids)
        again = LAP.lap_cost_cuda(a, b, ids)
        p = LAP.lap_cost(LAP._pair_chamfer_cost(a, b), ids)
        r2 = float(torch.stack([a, b]).square().sum(-1).max())
        d = (k - p)[inb].abs()
        over = int((d > LAP_COST_RTOL * p[inb].abs()
                    + LAP_COST_ATOL * r2).sum())
        err = max(err, float(d.max()))
        perm_k, perm_p = LAP.solve_lap(k), LAP.solve_lap(p)
        differ = (perm_k != perm_p).any(-1).cpu()
        gap = (_objective(p, perm_k) - _objective(p, perm_p)).abs()
        tie = float(gap[differ].max()) if differ.any() else 0.0
        print(f'lap_cost: sample {s}: max|cost kernel - cost plain| over '
              f'{int(inb.sum())} in-group entries {float(d.max()):.3e}, '
              f'{over} over the tolerance ({LAP_COST_RTOL:g} relative + '
              f'{LAP_COST_ATOL:g} x {r2:.3f}; 0 required); other entries '
              f'equal {torch.equal(k[~inb], p[~inb])}; second launch '
              f'bitwise {torch.equal(k, again)}; L1\'s assignments differ '
              f'on {int(differ.sum())} of {B} shapes, objective gap there '
              f'{tie:.2e} (near-tie limit {LAP_COST_TIE:g})', flush=True)
        if over or tie > LAP_COST_TIE or not torch.equal(k, again) or \
                not torch.equal(k[~inb], p[~inb]):
            raise AssertionError(f'lap_cost sample {s}: the kernel '
                                 'disagrees with the plain cost')
    a, b = samples[0]
    k_ms = _cuda_ms(lambda: LAP.lap_cost_cuda(a, b, ids), 50)
    p_ms = _cuda_ms(lambda: LAP.lap_cost(LAP._pair_chamfer_cost(a, b), ids),
                    5)
    # the in-group point pairs at PAIR_OPS operations (both directions'
    # minima from one distance); bytes: both clouds and the ids read once,
    # the cost written
    n = a.shape[2]
    pairs = int(inb.sum()) * n * n
    bound = _bound(ops=PAIR_OPS * pairs,
                   nbytes=4 * (2 * a.numel() + ids.numel() + B * P * P))
    print(f'lap_cost: [{B}, {P}, {n}] one sample: kernel {k_ms:.4f} ms, '
          f'plain {p_ms:.4f} ms ({p_ms / k_ms:.0f}x), bound {bound[0]:.5f} ms '
          f'({bound[1]}; {pairs:.4g} in-group point pairs of '
          f'{B * P * P * n * n:.4g}), share {bound[0] / k_ms:.4f}',
          flush=True)
    return (err, k_ms, p_ms, *bound)


def _noise_and_idx(b, S, seed):
    g = torch.Generator().manual_seed(seed)
    noise = [torch.randn((b, P, 32), generator=g) for _ in range(S)]
    idx = [torch.randperm(N, generator=g)[:100] for _ in range(S)]
    return noise, idx


def _chained_contacts(valids, seed=12):
    """Flag-first contact matrices [B, P, P, 4], as
    tests/test_torch_semantic.py builds them: each valid part touches the
    next at a point of [-0.1, 0.1]^3, its partner's copy 0.001 away (the
    synthetic set's contact files put the flag last, which the metric, as
    the JAX package's, reads as no contact)."""
    rng = np.random.RandomState(seed)
    b, p = valids.shape
    contacts = np.zeros((b, p, p, 4), np.float32)
    for i, n in enumerate(valids.sum(1).long().tolist()):
        for j in range(n - 1):
            pt = rng.uniform(-0.1, 0.1, 3)
            contacts[i, j, j + 1] = [1, *pt]
            contacts[i, j + 1, j] = [1, *(pt + 0.001)]
    return torch.from_numpy(contacts)


def phase_semantic_slice(data_dir):
    """One MoN step (S = 5) of the partnet_chair PN-Transformer at full
    width in f32, card against CPU, the same weights, head noise and match
    subsamples: loss within 1e-4, gradients within 1e-3 relative L2; then
    the eval logs of the batch (losses, part_acc, connectivity_acc) within
    1e-5, on flag-first contact matrices (`_chained_contacts`), with which
    connectivity_acc must be above 0."""
    from multi_part_assembly_tpu_torch.models import build_model
    from multi_part_assembly_tpu_torch.train.core import mon_loss
    from multi_part_assembly_tpu_torch.utils import load_cfg_file
    cfg = load_cfg_file(PARTNET_CFG)
    cfg.exp.bf16 = False
    S = cfg.loss.sample_iter
    batch = _partnet_batch(data_dir, range(2))
    batch['contact_points'] = _chained_contacts(batch['part_valids'])
    torch.manual_seed(0)
    model = build_model(cfg, 'cpu').train()
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    noise, idx = _noise_and_idx(2, S, 11)
    out = {}
    for device in ('cpu', 'cuda'):
        m = model.to(device)
        m.zero_grad(set_to_none=True)
        m.head.noise_override = list(noise)
        loss, _ = mon_loss(m, {k: v.to(device) for k, v in batch.items()},
                           cfg=cfg, training=True, match_idx=idx)
        loss.backward()
        out[device] = (float(loss.detach()), _grads(m))
    (l_cpu, g_cpu), (l_gpu, g_gpu) = out['cpu'], out['cuda']
    rel_loss = abs(l_gpu - l_cpu) / abs(l_cpu)
    rel_grad = float((g_gpu - g_cpu).norm() / g_cpu.norm())
    print(f'semantic slice: {S} samples, mon_loss card {l_gpu:.7f} vs CPU '
          f'{l_cpu:.7f} (rel {rel_loss:.2e}, tolerance 1e-4); gradient rel. '
          f'L2 diff {rel_grad:.2e} (tolerance 1e-3)', flush=True)
    if not (math.isfinite(l_gpu) and rel_loss <= 1e-4 and rel_grad <= 1e-3):
        raise AssertionError('semantic slice: the card disagrees with the '
                             'CPU')
    logs = {}
    model.eval()
    with torch.no_grad():
        for device in ('cpu', 'cuda'):
            m = model.to(device)
            m.head.noise_override = list(noise)
            _, lg = mon_loss(m, {k: v.to(device) for k, v in batch.items()},
                             cfg=cfg, training=False, reduce=False,
                             match_idx=idx)
            logs[device] = {k: v.cpu().double() for k, v in lg.items()}
    worst = {k: float(((logs['cuda'][k] - v).abs() /
                       v.abs().clamp(min=1.0)).max())
             for k, v in logs['cpu'].items()}
    print('semantic slice: eval logs card vs CPU, largest difference '
          '(tolerance 1e-5): ' + ', '.join(
              f'{k} {d:.2e}' for k, d in sorted(worst.items())) +
          f'; part_acc {logs["cuda"]["part_acc"].tolist()}, '
          f'connectivity_acc {logs["cuda"]["connectivity_acc"].tolist()} '
          '(above 0 required)', flush=True)
    if any(k not in logs['cuda'] for k in SEM_KEYS) or \
            not bool((logs['cuda']['connectivity_acc'] > 0).all()) or \
            any(d > 1e-5 for d in worst.values()) or \
            any(k.startswith(('trans_m', 'trans_r', 'rot_m', 'rot_r'))
                for k in logs['cuda']):
        raise AssertionError('semantic slice: eval logs differ')


def _profile_semantic(trainer, steps=2):
    """_profile_steps's line plus the device time a step of L1 and of L2
    (the LAP cost), from one run."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    trainer.train_loader.set_epoch(7)
    batches = iter(trainer.train_loader)
    trainer.train_step(next(batches))
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            trainer.train_step(next(batches))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    batches.close()
    kernels = _device_kernels(prof)
    if not kernels:
        return 'the profiler recorded no device event: not measured'
    busy = sum(ev.time_range.elapsed_us() for ev in kernels) / 1e3 / steps
    lap_ms, cost_ms = (sum(ev.time_range.elapsed_us() for ev in kernels
                           if name in ev.name) / 1e3 / steps
                       for name in ('lap_kernel', 'lap_cost_kernel'))
    step_ms = 1e3 * wall / steps
    return (f'{len(kernels) / steps:.0f} device kernels a step, {busy:.2f} ms '
            f'of device time in {step_ms:.2f} ms a step (device idle '
            f'{100 * (1 - busy / step_ms):.1f}%); L1 {lap_ms:.4f} ms, '
            f'L2 {cost_ms:.4f} ms of device time a step')


def _semantic_run(tag, cfg_path, opts, data_dir, run_dir, S, T, epochs):
    """train_torch.main on a partnet_chair config at published width: the
    given epochs and one validation with its checkpoint, the counters
    reset just before it.  B1-B4 and L1 must launch exactly S x T a train
    step (identity: B2/B4 never), S x (1, 2, 1) times a val batch for
    B1, B3 and L1, and no other kernel ever."""
    import train_torch
    from multi_part_assembly_tpu_torch.train.trainer import Trainer
    launches = {}
    validate = Trainer.validate

    def counted_validate(self, epoch):
        launches['train'] = _launches()
        metrics = validate(self, epoch)
        launches['val'] = {k: v - launches['train'][k]
                           for k, v in _launches().items()}
        return metrics

    Trainer.validate = counted_validate
    try:
        with _Timed('save_checkpoint', '_export_val_vis') as timed:
            torch.cuda.reset_peak_memory_stats()
            tracing.reset()
            t0 = time.perf_counter()
            trainer = train_torch.main([
                '--cfg_file', cfg_path, '--ckp_dir', run_dir, '--opts',
                'data.data_dir', data_dir, 'exp.num_epochs', str(epochs),
                'exp.val_every', str(epochs), *opts])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            totals = _launches()
    finally:
        Trainer.validate = validate
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    with open(os.path.join(run_dir, 'metrics.jsonl')) as f:
        train = [r for r in map(json.loads, f) if 'train/loss' in r]
    losses = [r['train/loss'] for r in train]
    steps = trainer.step_seconds
    n = len(steps)
    if n < 3 or not all(map(math.isfinite, losses)):
        raise AssertionError(f'{tag}: expected >= 3 finite train steps, got '
                             f'{losses}')
    ms = 1000.0 * sum(steps[1:]) / len(steps[1:])
    waits = [1000.0 * r['train/data_time'] for r in train]
    wait_ms = sum(waits[1:]) / len(waits[1:])
    table = trainer.part_tables['train']
    where = 'host wire (packed f16 rows)' if table is None else \
        f'resident part table of {table.nbytes} bytes'
    print(f'{tag}: {where}; {n} train steps of batch {B}, S = {S}, first '
          f'{1000 * steps[0]:.1f} ms, then {ms:.2f} ms/step = '
          f'{B / (ms / 1000):.1f} samples/s; data wait {wait_ms:.3f} ms/step;'
          f' peak memory {peak_gib:.2f} GiB; wall {wall:.1f} s; train '
          f'losses {["%.5f" % v for v in losses]}', flush=True)
    _check_metrics(tag, trainer.metrics, names=SEM_KEYS + ('loss', ))
    bad = [k for k in trainer.metrics if k.startswith(
        ('val/trans_m', 'val/trans_r', 'val/rot_m', 'val/rot_r'))]
    saved = trainer.ckpt_mgr.all_steps()
    print(f'{tag}: checkpoint save {timed.ms("save_checkpoint")} ms, val '
          f'export {timed.ms("_export_val_vis")} ms; checkpoints kept '
          f'{saved}', flush=True)
    if saved != [epochs - 1] or bad:
        raise AssertionError(f'{tag}: expected one checkpoint and no '
                             f'geometric metrics, got {saved}, {bad}')
    _check_replayed(tag, trainer)
    # the wrappers count the step bodies traced (warm-ups and the capture)
    traced = trainer.compiled.traced
    expected = {k: 0 for k in _loss_launches(_launches())}
    expected.update({k: v * traced for k, v in _step_expected(
        S, T, 'auto', True, 'identity' in cfg_path).items()})
    nv = len(trainer.val_loader)
    val_expected = {k: 0 for k in _loss_launches(_launches())}
    val_expected.update(nn_parts=S * nv, nn_diag=2 * S * nv, lap=S * nv,
                        lap_cost=S * nv)
    print(f'{tag}: kernel launches in training {launches["train"]} '
          f'(expected S x T x traced step bodies = {S} x {T} x {traced}), '
          f'in validation {launches["val"]} (expected {val_expected})',
          flush=True)
    if _loss_launches(launches['train']) != expected or \
            _loss_launches(launches['val']) != val_expected:
        raise AssertionError(f'{tag}: launches differ from the expected '
                             'counts')
    return trainer, totals, (ms, wait_ms, peak_gib)


def phase_semantic(data_dir, tmp):
    """The partnet_chair PN-Transformer at full width through
    scripts/train_torch.py: three epochs, a validation and a checkpoint on
    the slot wire (resident f16 table) and on the host wire; the slot-wire
    run then resumes, its next epoch bitwise the uninterrupted one's; then
    each other family one epoch on the slot wire.  Returns the launch
    counts of these runs."""
    from multi_part_assembly_tpu_torch.train.trainer import Trainer
    from multi_part_assembly_tpu_torch.utils import load_cfg_file
    S = load_cfg_file(PARTNET_CFG).loss.sample_iter
    totals, rows = {}, {}

    def add(launches):
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
    runs = {}
    for label, word in (('slot wire', 'True'), ('host wire', 'False')):
        run_dir = os.path.join(tmp, f'semantic_{word}')
        runs[label] = run_dir
        trainer, launches, rows[label] = _semantic_run(
            f'semantic[{label}]', PARTNET_CFG, ['data.device_table', word],
            data_dir, run_dir, S, 1, 3)
        add(launches)
        if (trainer.part_tables['train'] is None) != (word == 'False'):
            raise AssertionError(f'semantic[{label}]: wrong wire')
        if label == 'slot wire':
            first = trainer

    # resume the slot-wire run: a new Trainer on its ckp_dir starts at
    # epoch 3 with every tensor bitwise; epoch 3 in both from the same
    # generator states gives the same losses and weights
    tag = 'semantic[slot wire] resume'
    tracing.reset()
    second = Trainer(first.cfg, 'cuda', ckp_dir=runs['slot wire'],
                     quiet=True)
    differ = _differing(_state(second), _state(first))
    print(f'{tag}: start_epoch {second.start_epoch}, step {second.step}; '
          f'tensors not bitwise equal: {differ} of {len(_state(first))}',
          flush=True)
    if second.start_epoch != 3 or second.step != first.step or differ:
        raise AssertionError(f'{tag}: the resumed state differs')
    states = (first.generator.get_state(), torch.get_rng_state(),
              torch.cuda.get_rng_state())
    losses = _epoch_losses(first, 3)
    second.generator.set_state(states[0])
    torch.set_rng_state(states[1])
    torch.cuda.set_rng_state(states[2])
    again = _epoch_losses(second, 3)
    after = _differing(_state(second), _state(first))
    print(f'{tag}: epoch 3 in both from the same generator states: losses '
          f'{["%.7f" % v for v in losses]}, bitwise equal {again == losses}'
          f'; tensors not bitwise equal after it: {after}', flush=True)
    if again != losses or after or not all(map(math.isfinite, losses)):
        raise AssertionError(f'{tag}: the resumed epoch differs from the '
                             'uninterrupted one')
    add(_launches())
    print(f'semantic[slot wire]: torch.profiler over 2 steps: '
          f'{_profile_semantic(first)}', flush=True)
    first.close()
    second.close()

    for family, (path, T) in SEM_FAMILIES.items():
        # no PLY export: the PN-Transformer runs above exercise it
        trainer, launches, rows[family] = _semantic_run(
            f'semantic[{family}]', os.path.join(ROOT, path),
            ['data.device_table', 'True', 'exp.val_sample_vis', '0'],
            data_dir,
            os.path.join(tmp, f'semantic_{family}'), S, T, 1)
        add(launches)
        trainer.close()
    print('semantic: ' + '; '.join(
        f'{k} {ms:.2f} ms/step, wait {w:.3f} ms, {mem:.2f} GiB'
        for k, (ms, w, mem) in rows.items()), flush=True)
    return totals


# ---------------------------------------------------------------------------
# the DGCNN and PointNet++ encoders on the flagship: card vs CPU, training
# ---------------------------------------------------------------------------

ENCODER_ARCHS = ('dgcnn', 'pointnet2_ssg', 'pointnet2_msg')
# profiler ranges (record_function) of the encoders' plain-PyTorch ops
ENCODER_RANGES = ('knn', 'neighborhood_reduce', 'neighborhood_reduce_backward',
                  'furthest_point_sample', 'ball_query')


def _differ(a, b, sets):
    """How many rows of two index tensors differ ([..., k]: as sets when
    `sets`, else elementwise), and of how many."""
    if sets:
        a, b = a.sort(-1).values, b.sort(-1).values
        return int((a != b).any(-1).sum()), a[..., 0].numel()
    return int((a != b).sum()), a.numel()


def _slice_encoder(arch, batch):
    """One MoN step of the flagship config with the encoder at full width
    in f32, card against CPU, the same weights: the card takes the CPU's
    kNN graphs, FPS samples and ball sets, where an ulp can flip a
    neighbour at the k-th distance or a point at the ball's radius (how
    many differ when the card makes its own is printed).  Loss within
    1e-4; gradients within 1e-3 relative L2 plus twice the card gradient's
    own movement under relative 1e-7 and 1e-6 nudges of the clouds (the
    same indices); two card runs bitwise equal for DGCNN, whose backward
    adds by sorted index (printed for PointNet++); then the eval logs."""
    from multi_part_assembly_tpu_torch.models import build_model
    from multi_part_assembly_tpu_torch.utils import load_cfg_file
    cfg = load_cfg_file(FLAGSHIP_CFG)
    cfg.exp.bf16 = False
    cfg.model.encoder = arch
    torch.manual_seed(0)
    model = build_model(cfg, 'cpu').train()
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    tag = f'encoder slice[{arch}]'
    with _indices(record=True) as (graph, sampling):
        l_cpu, g_cpu = _step(model, batch, cfg, 'cpu')
        given = _given(graph, sampling)
    runs = []
    for _ in range(2):
        with _indices(**given):
            runs.append(_step(model, batch, cfg, 'cuda'))
    (l_gpu, g_gpu), (_, g_again) = runs
    bitwise = torch.equal(g_gpu, g_again)
    with _indices(record=True) as (graph, sampling):
        _step(model, batch, cfg, 'cuda')
        own = _given(graph, sampling)
    counts = []
    valid = batch['part_valids'].reshape(-1).cpu() > 0
    for key, sets in (('graph', True), ('fps', False), ('ball', True)):
        pairs = [_differ(a[valid], b[valid], sets)
                 for a, b in zip(own[key], given[key])]
        counts.append(f'{key} {sum(d for d, _ in pairs)} of '
                      f'{sum(n for _, n in pairs)}')
    jitter = 0.0
    for eps in (1e-7, 1e-6):
        nudged = dict(batch)
        d = torch.randn(batch['part_pcs'].shape,
                        generator=torch.Generator().manual_seed(9))
        nudged['part_pcs'] = batch['part_pcs'] * (1 + eps * d.cuda())
        with _indices(**given):
            g_n = _step(model, nudged, cfg, 'cuda')[1]
        jitter = max(jitter, float((g_n - g_gpu).norm() / g_gpu.norm()))
    rel_loss = abs(l_gpu - l_cpu) / abs(l_cpu)
    rel_grad = float((g_gpu - g_cpu).norm() / g_cpu.norm())
    tol = 1e-3 + 2 * jitter
    print(f'{tag}: mon_loss card {l_gpu:.7f} vs CPU {l_cpu:.7f} (rel '
          f'{rel_loss:.2e}, tolerance 1e-4); gradient rel. L2 diff '
          f'{rel_grad:.2e} (tolerance 1e-3 + 2 x {jitter:.2e}, the card '
          f"gradient's movement under nudges of 1e-7 and 1e-6); two card "
          f'runs bitwise equal: {bitwise}; where the card makes its own '
          f'indices, rows of the valid parts that differ from the CPU\'s: '
          f'{", ".join(counts)}',
          flush=True)
    if not (math.isfinite(l_gpu) and rel_loss <= 1e-4 and rel_grad <= tol
            and (bitwise or arch != 'dgcnn')):
        raise AssertionError(f'{tag}: the card disagrees with the CPU')
    _check_eval_logs(arch, model, cfg, batch)


def _encoder_run(arch, data_dir, tmp, batch):
    """_epoch_run of the flagship config with the encoder at `batch`, with
    the device time of its ops' profiler ranges."""
    return _epoch_run(
        f'encoder[{arch}]', FLAGSHIP_CFG, 1,
        ['model.encoder', arch, 'exp.val_sample_vis', '0'], data_dir,
        os.path.join(tmp, f'encoder_{arch}_{batch}'), batch=batch,
        ranges=ENCODER_RANGES, graph_steps=2)


def phase_encoders(data_dir, tmp):
    """The flagship with DGCNN, PointNet++ SSG and MSG: the card-vs-CPU
    step of each on the first shape of the slice batch (12 of 20 parts
    valid), then one epoch of each at batch 32 on the dense slot wire
    (_epoch_run: B1-B4 once a step), MSG at batch 16 if 32 does not fit
    the card.  Returns the launch counts of the training runs."""
    batch = {k: v[:1] for k, v in _slice_batch().items()}
    for arch in ENCODER_ARCHS:
        _slice_encoder(arch, batch)
    totals, rows = {}, {}
    for arch in ENCODER_ARCHS:
        oom, size = None, B
        try:
            launches, row = _encoder_run(arch, data_dir, tmp, B)
        except torch.cuda.OutOfMemoryError as e:
            if arch != 'pointnet2_msg':
                raise
            oom = str(e).splitlines()[0]
        if oom is not None:  # the failed run's tensors are garbage now
            import gc
            gc.collect()
            torch.cuda.empty_cache()
            size = B // 2
            print(f'encoder[{arch}]: batch {B} does not fit the card '
                  f'({oom}); batch {size} instead', flush=True)
            launches, row = _encoder_run(arch, data_dir, tmp, size)
        rows[arch] = (size, ) + row
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
    print('encoders: ' + '; '.join(
        f'{a} batch {b}: {ms:.2f} ms/step in the epoch, wait {w:.3f} ms, '
        f'{mem:.2f} GiB, eager {_profile_line(prof)}; {_graph_summary(g)}'
        for a, (b, ms, w, mem, prof, g) in rows.items()), flush=True)
    return totals


# ---------------------------------------------------------------------------
# the compiled step: CUDA-graph replays against eager steps (train/step.py)
# ---------------------------------------------------------------------------

GRAPH_GROUP = 8  # exp.steps_per_call of phase_graph's runs
GRAPH_GROUPS = 3  # groups a run: 24 steps
GRAPH_RTOL = 1e-6  # the most a graphed value may differ, relative, if any
# (label, config, --opts, chamfer fused mode, MoN samples S)
GRAPH_RUNS = [
    ('flagship, dense slot wire', FLAGSHIP_CFG, DENSE, 'auto', 1),
    ('flagship, host wire', FLAGSHIP_CFG, ['data.device_sampling', 'False'],
     'auto', 1),
    ('flagship, chunked slot wire', FLAGSHIP_CFG,
     ['data.device_sampling', 'True', 'data.device_table_layout',
      'chunked'], 'auto', 1),
    # (deterministic algorithms on: see _graph_run)
    ('flagship, unfused route', FLAGSHIP_CFG, DENSE, 'off', 1),
    ('semantic, slot wire', PARTNET_CFG, ['data.device_table', 'True'],
     'auto', 5),
    ('semantic, host wire', PARTNET_CFG, ['data.device_table', 'False'],
     'auto', 5),
]
# kernel names a replayed step's profile counts: B1 and B3 are one kernel
# (`chamfer_pair_kernel<2>`), B2 and B4 two, B8 the one-direction pair
# kernel, L1 the LAP kernel, L2 the LAP cost's
REPLAY_KERNELS = {'B1+B3': 'chamfer_pair_kernel<2>',
                  'B2': 'chamfer_grad_kernel<false>',
                  'B4': 'chamfer_grad_kernel<true>',
                  'B8': 'chamfer_pair_kernel<1>', 'L1': 'lap_kernel',
                  'L2': 'lap_cost_kernel'}


def _replay_expected(S, T, mode, semantic, identity=False):
    """Kernels of one train step by REPLAY_KERNELS' names."""
    n = S * T
    grad = 0 if identity else n
    fused = mode != 'off'
    return {'B1+B3': 2 * n if fused else 0, 'B2': grad if fused else 0,
            'B4': grad if fused else 0, 'B8': 0 if fused else 4 * n,
            'L1': n if semantic else 0, 'L2': n if semantic else 0}


def _step_expected(S, T, mode, semantic, identity=False):
    """Wrapper launches of one step body by launch counter."""
    n = S * T
    grad = 0 if identity or mode == 'off' else n
    fused = mode != 'off'
    return {'nn_parts': n if fused else 0, 'nn_diag': n if fused else 0,
            'bwd_parts': grad, 'bwd_diag': grad,
            'nn_off': 0 if fused else 4 * n, 'nn_dir': 0,
            'lap': n if semantic else 0, 'lap_cost': n if semantic else 0}


def _host_batches(trainer, n, placed=False):
    """The first n train batches, epoch after epoch; each may be used
    again.  Unless `placed`, as the loader collates them with its placement
    stage off (host tensors and slot-wire handles): each step then places
    its batch on the training thread, so that the sampler counts once a
    dispatched batch.  With `placed`, as `train_epoch` takes them: placed
    on the card by the loader's placement thread, so that a step only
    waits on the batch's event, and a timed step holds no placement."""
    loader = trainer.train_loader
    transform = loader.transform
    if not placed:
        loader.transform = None
    out, epoch = [], 0
    try:
        while len(out) < n:
            loader.set_epoch(epoch)
            out += list(loader)
            epoch += 1
    finally:
        loader.transform = transform
    return out[:n]


def _run_groups(trainer, groups):
    """Each group of host batches dispatched as one group of steps, as the
    epoch loop does, then one flush; returns the rows the flush logged."""
    rows = []
    trainer.logger.log = lambda record, step=None, echo=None: \
        rows.append(dict(record, step=step))
    try:
        for group in groups:
            trainer._dispatch(group, [0.0] * len(group))
        trainer._flush_train_logs()
    finally:
        del trainer.logger.log
    return rows


def _timed_groups(trainer, groups):
    """(rows, ms a step) of _run_groups, its flush synchronising."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = _run_groups(trainer, groups)
    steps = sum(map(len, groups))
    return rows, 1000.0 * (time.perf_counter() - t0) / steps


def _profile_groups(trainer, groups):
    """(device kernels by REPLAY_KERNELS name a step, all device kernels a
    step, device ms a step, wall ms a step) of the groups' steps under
    torch.profiler; None when it records no device event."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        _run_groups(trainer, groups)
        wall = time.perf_counter() - t0
    kernels = _device_kernels(prof)
    if not kernels:
        return None
    steps = sum(map(len, groups))
    named = {k: sum(name in ev.name for ev in kernels) / steps
             for k, name in REPLAY_KERNELS.items()}
    busy = sum(ev.time_range.elapsed_us() for ev in kernels) / 1e3 / steps
    return named, len(kernels) / steps, busy, 1e3 * wall / steps


def _largest_rel(a, b):
    """(largest relative difference, name) of two _state lists."""
    worst, where = 0.0, None
    for (name, x), (_, y) in zip(a, b):
        if torch.equal(x, y):
            continue
        x, y = x.double(), y.double()
        rel = float((x - y).abs().max() / y.abs().max().clamp_min(1e-30))
        if rel >= worst:
            worst, where = rel, name
    return worst, where


def _graph_run(label, path, opts, mode, S, data_dir, tmp):
    """phase_graph's check of one path: a graphed and an eager Trainer
    from the same seed take GRAPH_GROUPS groups of GRAPH_GROUP steps on the
    same batches from the same generator states; returns the row of
    numbers printed."""
    import train_torch
    from multi_part_assembly_tpu_torch.train.trainer import Trainer
    tag = f'graph[{label}]'
    prev_mode = C.fused_mode()
    C.set_fused_mode(mode)
    # the unfused route's plain backward adds by index_add_, whose atomics
    # add in an order that varies from run to run on the card; PyTorch's
    # deterministic algorithms sort instead, so that the graphed and the
    # eager steps can be held to each other bit for bit
    determined = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(mode == 'off', warn_only=True)
    try:
        trainers = {}
        for name in ('graph', 'eager'):
            run_dir = os.path.join(tmp, f'graph_{len(os.listdir(tmp))}')
            cfg = train_torch.build_cfg(train_torch.parse_args([
                '--cfg_file', path, '--ckp_dir', run_dir, '--opts',
                'data.data_dir', data_dir, 'exp.val_sample_vis', '0',
                'exp.steps_per_call', str(GRAPH_GROUP), *opts]))
            trainers[name] = Trainer(cfg, 'cuda', ckp_dir=run_dir,
                                     resume=False, quiet=True)
        graph, eager = trainers['graph'], trainers['eager']
        semantic = graph.cfg.data.dataset != 'geometry'
        eager.compiled = None
        if graph.compiled is None or graph.steps_per_call != GRAPH_GROUP:
            raise AssertionError(f'{tag}: the trainer does not replay a '
                                 f'graph in groups of {GRAPH_GROUP}')
        batches = _host_batches(graph, GRAPH_GROUP * GRAPH_GROUPS)
        # the first step alone (its state is compared on its own), then
        # the rest of the first group, then whole groups; the last is
        # timed and profiled on the same batches placed as in an epoch
        groups = [batches[:1], batches[1:GRAPH_GROUP]] + [
            batches[i:i + GRAPH_GROUP]
            for i in range(GRAPH_GROUP, len(batches), GRAPH_GROUP)]
        groups[-1] = _host_batches(graph, len(batches),
                                   placed=True)[-GRAPH_GROUP:]
        rng = torch.cuda.get_rng_state()  # dropout's stream
        out, totals = {}, {}
        for name, trainer in (('graph', graph), ('eager', eager)):
            torch.cuda.set_rng_state(rng)
            tracing.reset()
            torch.cuda.reset_peak_memory_stats()
            rows = _run_groups(trainer, groups[:1])
            first = _state(trainer)
            rows += _run_groups(trainer, groups[1:-1])
            launches = _launches()
            more, ms = _timed_groups(trainer, groups[-1:])
            out[name] = (rows + more, _state(trainer), ms,
                         torch.cuda.max_memory_allocated() / 2**30,
                         launches, first)
            for k, v in _launches().items():
                totals[k] = totals.get(k, 0) + v
        profile = {name: _profile_groups(trainer, groups[-1:])
                   for name, trainer in (('graph', graph),
                                         ('eager', eager))}
        synced_ms = _synced_ms(eager, groups[-1])
        compiled = graph.compiled
        graph.close()
        eager.close()
    finally:
        C.set_fused_mode(prev_mode)
        torch.use_deterministic_algorithms(determined)

    (g_rows, g_state, g_ms, g_peak, g_launch, g_first) = out['graph']
    (e_rows, e_state, e_ms, e_peak, _, e_first) = out['eager']
    for when, g, e, gr, er in (
            ('after the first step', g_first, e_first, g_rows[:1],
             e_rows[:1]),
            (f'after {len(g_rows)} steps', g_state, e_state, g_rows,
             e_rows)):
        differ = _differing(g, e)
        print(f'{tag}: {when}: logs bitwise equal to the eager steps\' '
              f'{gr == er}; tensors not bitwise equal {len(differ)} of '
              f'{len(e)}', flush=True)
        if not differ and gr == er:
            continue
        worst, where = _largest_rel(g, e)
        rows_rel = max((abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
                        for a, b in zip(gr, er) for k in a
                        if k.startswith('train/')), default=0.0)
        print(f'{tag}: {when}: largest relative difference {worst:.3e} in '
              f'{where}, {rows_rel:.3e} in the logs (limit {GRAPH_RTOL})',
              flush=True)
        if max(worst, rows_rel) > GRAPH_RTOL:
            raise AssertionError(f'{tag}: graphed steps differ from eager '
                                 'steps')
    print(f'{tag}: {len(g_rows)} steps in groups of up to {GRAPH_GROUP}, '
          f'{compiled.captures} capture(s) ({compiled.capture_seconds:.2f} '
          f's, {WARMUP_STEPS} warm-up steps undone), {compiled.replays} '
          'replays', flush=True)
    if len(g_rows) != GRAPH_GROUP * GRAPH_GROUPS or compiled.captures != 1 \
            or compiled.replays != len(g_rows) + GRAPH_GROUP:
        raise AssertionError(f'{tag}: expected every step a replay of one '
                             'capture')
    per_body = _step_expected(S, 1, mode, semantic)
    n_batches = GRAPH_GROUP * (GRAPH_GROUPS - 1)
    want = {k: v * compiled.traced for k, v in per_body.items()}
    sampler = None if semantic or 'False' in opts else \
        ('sample_chunked' if 'chunked' in opts else 'sample_dense')
    for key in SAMPLER_KEYS:
        want[key] = n_batches if key == sampler else 0
    print(f'{tag}: wrapper launches of the graphed run {g_launch} (expected '
          f'{compiled.traced} traced bodies x {per_body}, the sampler once '
          f'a batch)', flush=True)
    if _loss_launches(g_launch) != want:
        raise AssertionError(f'{tag}: wrapper launches differ')
    replay = profile['graph']
    expected = _replay_expected(S, 1, mode, semantic)
    if replay is None:
        raise AssertionError(f'{tag}: the profiler recorded no kernel of a '
                             'replayed step')
    named = {k: round(v, 3) for k, v in replay[0].items()}
    print(f'{tag}: kernels of a replayed step by torch.profiler {named} '
          f'(expected {expected}), {replay[1]:.0f} kernels in all',
          flush=True)
    if named != expected:
        raise AssertionError(f'{tag}: a replayed step launched other '
                             'kernels')
    print(f'{tag}: eager steps that each wait for their logs (the loop '
          f'before the compiled step) {synced_ms:.2f} ms/step', flush=True)
    return _graph_line(tag, e_ms, g_ms, profile, e_peak, g_peak,
                       compiled.capture_seconds), totals


def _graph_summary(row):
    if row is None:
        return 'eager steps by rule (train/step.py uncapturable)'
    e_ms, g_ms, e_idle, g_idle, e_peak, g_peak, capture_s = row
    return (f'eager {e_ms:.2f} / graphed {g_ms:.2f} ms/step, idle '
            f'{e_idle} / {g_idle}, peak {e_peak:.2f} / {g_peak:.2f} GiB, '
            f'capture {capture_s:.2f} s')


def _synced_ms(trainer, batches):
    """ms a step of eager `train_step`s, each fetching its logs."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for batch in batches:
        trainer.train_step(batch)
    return 1000.0 * (time.perf_counter() - t0) / len(batches)


def _idle(profile):
    if profile is None:
        return 'not measured'
    _, _, busy, wall = profile
    return f'{100 * (1 - busy / wall):.1f}%'


def _graph_line(tag, e_ms, g_ms, profile, e_peak, g_peak, capture_s):
    """Prints and returns the eager-against-graphed numbers of a path."""
    print(f'{tag}: eager {e_ms:.2f} ms/step, graphed {g_ms:.2f} ms/step '
          f'({e_ms / g_ms:.2f}x); device idle (profiled) eager '
          f'{_idle(profile["eager"])}, graphed {_idle(profile["graph"])}; '
          f'peak memory eager {e_peak:.2f} GiB, graphed {g_peak:.2f} GiB; '
          f'capture {capture_s:.2f} s', flush=True)
    return e_ms, g_ms, _idle(profile['eager']), _idle(profile['graph']), \
        e_peak, g_peak, capture_s


def _eager_vs_graph(tag, trainer, n=4):
    """A trained Trainer's step both ways on its next batches: a group of
    2 steps to warm (the graphed one captures again if the trainer was
    closed), n timed, 2 profiled.  Returns _graph_line's numbers (the
    capture seconds of the trainer's first capture) and the graphed
    profile."""
    batches = _host_batches(trainer, n + 4, placed=True)
    compiled, times = trainer.compiled, {}
    if compiled is None:
        raise AssertionError(f'{tag}: the trainer replays no graph')
    capture_s = compiled.capture_seconds
    for name in ('eager', 'graph'):
        trainer.compiled = compiled if name == 'graph' else None
        torch.cuda.reset_peak_memory_stats()  # the capture included
        _run_groups(trainer, [batches[:2]])
        _, ms = _timed_groups(trainer, [batches[2:2 + n]])
        peak = torch.cuda.max_memory_allocated() / 2**30
        times[name] = (ms, peak, _profile_groups(trainer, [batches[-2:]]))
    trainer.compiled = compiled
    profile = {k: v[2] for k, v in times.items()}
    return _graph_line(tag, times['eager'][0], times['graph'][0], profile,
                       times['eager'][1], times['graph'][1],
                       capture_s) + (profile['graph'], )


def phase_graph(data_dir, partnet_dir, tmp):
    """The compiled step (train/step.py) on the flagship's dense slot wire,
    host wire, chunked layout and unfused route, and the semantic
    PN-Transformer's two wires: GRAPH_GROUPS x GRAPH_GROUP replayed steps
    against as many eager steps from the same weights and generator
    states (losses, parameters, Adam state, BN statistics bitwise; else
    the largest relative difference printed and held under GRAPH_RTOL),
    the wrapper launches of the traced bodies exactly, a replayed step's
    kernels by torch.profiler, and eager against graphed step time,
    device idle share, peak memory and capture seconds."""
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.splitlines()[0].strip()
    rows, totals = {}, {}
    for label, path, opts, mode, S in GRAPH_RUNS:
        rows[label], launches = _graph_run(
            label, path, opts, mode, S,
            partnet_dir if path == PARTNET_CFG else data_dir, tmp)
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
    print(f'graph ({smi}): ' + '; '.join(
        f'{k} {_graph_summary(r)}' for k, r in rows.items()), flush=True)
    return totals


# ---------------------------------------------------------------------------
# data parallelism: two gloo ranks sharing the card (parallel/dist.py)
# ---------------------------------------------------------------------------

DDP_WORLD = 2
DDP_LABEL = 'gloo, 2 ranks sharing one card'
DDP_TIMEOUT = 300  # seconds the ranks may take, imports included


def _tensors_equal(got, want):
    """Keys whose tensors are not bitwise equal (dtype, shape and device
    type included) in two device batches."""
    if set(got) != set(want):
        return ['<keys>']
    return [k for k, v in want.items()
            if got[k].dtype != v.dtype or got[k].device != v.device or
            not torch.equal(got[k], v)]


def _saved_state(path):
    """A checkpoint's tensors as _state lists them."""
    from multi_part_assembly_tpu_torch.train.checkpoint import load_state
    state = load_state(path, 'cpu')
    out = list(state['model'].items())
    for pid, st in sorted(state['optimizer']['state'].items()):
        out += [(f'opt.{pid}.{k}', v) for k, v in sorted(st.items())]
    return out


PLACEMENT_WIRES = [
    ('host wire', ['data.device_sampling', 'False'], None),
    ('dense layout', DENSE, 'sample_dense'),
    ('chunked layout', ['data.device_sampling', 'True',
                        'data.device_table_layout', 'chunked'],
     'sample_chunked'),
]


def _placement_wire(label, opts, sampler, data_dir, trainer=None):
    """Two train batches placed by the loader's placement stage against the
    same host batches placed on this thread: bitwise, the card's expansion
    of the host wire's f16 rows against the CPU's too; which threads
    launched the sampler.  The loader is `trainer`'s when given, else one
    built from `opts`."""
    import train_torch
    from multi_part_assembly_tpu_torch.datasets import build_dataloader
    from multi_part_assembly_tpu_torch.datasets.geometry import (
        enable_device_sampling, expand_geometry_batch)
    from multi_part_assembly_tpu_torch.train import trainer as TR
    tag = f'placement[{label}]'
    device = torch.device('cuda')
    if trainer is not None:
        cfg, loader, consumer = trainer.cfg, trainer.train_loader, trainer
    else:
        cfg = train_torch.build_cfg(train_torch.parse_args([
            '--cfg_file', FLAGSHIP_CFG, '--opts', 'data.data_dir', data_dir,
            *opts]))
        loader, _ = build_dataloader(cfg)
        if sampler is not None and \
                enable_device_sampling(loader, cfg, device) is None:
            raise AssertionError(f'{tag}: no sampling tables')
        consumer = types.SimpleNamespace(cfg=cfg, device=device)
    transform = loader.transform or TR.DevicePlacement(cfg, device)
    launched = []
    real = {name: getattr(DS, name)
            for name in ('sample_dense_cuda', 'sample_chunked_cuda')}

    def spy(name, fn):
        def counted(*args, **kwargs):
            launched.append((name, threading.current_thread().name))
            return fn(*args, **kwargs)
        return counted

    for name, fn in real.items():
        setattr(DS, name, spy(name, fn))
    try:
        loader.set_epoch(0)
        loader.transform = None
        batches = iter(loader)
        hosts = [next(batches) for _ in range(2)]
        batches.close()
        loader.transform = transform
        batches = iter(loader)
        placed = [TR.Trainer._device_batch(consumer, next(batches))
                  for _ in range(2)]
        batches.close()
        on_thread = list(launched)
        inline = [TR.Trainer._device_batch(consumer, h) for h in hosts]
        torch.cuda.synchronize()
        inline_launches = launched[len(on_thread):]
    finally:
        for name, fn in real.items():
            setattr(DS, name, fn)
    differ = [_tensors_equal(p, i) for p, i in zip(placed, inline)]
    threads = sorted({t for _, t in on_thread})
    print(f'{tag}: 2 batches from the placement thread against the same '
          f'host batches placed on the training thread: keys not bitwise '
          f'equal {differ}; sampler launches from the placement stage '
          f'{len(on_thread)} on {threads}, inline {len(inline_launches)}',
          flush=True)
    if any(differ):
        raise AssertionError(f'{tag}: placed batches differ')
    if sampler is None:
        if launched:
            raise AssertionError(f'{tag}: the host wire sampled on the '
                                 'card')
        for h, p in zip(hosts, placed):
            rows = h['part_pcs_raw__packed']
            if rows.dtype != torch.float16 or \
                    rows.shape[0] != int(h['part_counts'].sum()):
                raise AssertionError(f'{tag}: host rows {rows.dtype} '
                                     f'{tuple(rows.shape)}')
            cpu = expand_geometry_batch(
                rows, h['part_counts'], max_parts=P,
                data_keys=tuple(cfg.data.data_keys))
            got = {k: v.cpu() for k, v in p.items()}
            if _tensors_equal(got, cpu):
                raise AssertionError(f'{tag}: the card\'s expansion differs '
                                     f'from the CPU\'s in '
                                     f'{_tensors_equal(got, cpu)}')
        print(f'{tag}: the card\'s expansion of the f16 rows bitwise the '
              f'CPU\'s', flush=True)
    elif len(on_thread) < 2 or threads != ['loader-transform'] or \
            {n for n, _ in launched} != {f'{sampler}_cuda'}:
        raise AssertionError(f'{tag}: sampler launches {launched}')


def _held_save(monkeypatch_module):
    """Holds the checkpoint writer's torch.save until the event returned
    is set; returns (event, restore)."""
    go = threading.Event()
    real = monkeypatch_module.torch.save

    def held(obj, path):
        if not go.wait(120):
            raise TimeoutError('the held checkpoint write was never '
                               'released')
        real(obj, path)

    monkeypatch_module.torch.save = held
    return go, lambda: setattr(monkeypatch_module.torch, 'save', real)


def _graphed_save(trainer):
    """A graphed flagship trainer: a save whose write is held while the
    trainer replays two more steps, the checkpoint bitwise the state at the
    save; then saves timed on the training thread, and their writer's
    time."""
    from multi_part_assembly_tpu_torch.train import checkpoint as CK
    tag = 'placement[async save]'
    trainer.train_loader.set_epoch(0)
    batches = iter(trainer.train_loader)
    trainer._dispatch([next(batches), next(batches)], [0.0, 0.0])
    trainer._flush_train_logs()
    at_save = _state(trainer)
    go, restore = _held_save(CK)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.save_checkpoint(0, {'val/part_acc': 0.5})
        first_ms = 1000 * (time.perf_counter() - t0)
        writing = trainer.ckpt_mgr._writer.is_alive()
        trainer._dispatch([next(batches), next(batches)], [0.0, 0.0])
        trainer._flush_train_logs()  # the replays are done
        after = _state(trainer)
        on_disk = os.path.isdir(os.path.join(trainer.ckpt_mgr.directory,
                                             '0'))
    finally:
        go.set()
        restore()
    trainer.ckpt_mgr.wait_until_finished()
    batches.close()
    saved = _saved_state(os.path.join(trainer.ckpt_mgr.directory, '0'))
    differ, moved = _differing(saved, at_save), _differing(after, at_save)
    print(f'{tag}: a save returned in {first_ms:.2f} ms (its pinned buffer '
          f'allocated) with its write pending {writing}, on '
          f'disk after 2 more graphed steps {on_disk}; the checkpoint\'s '
          f'tensors not bitwise the state at the save {differ}; tensors '
          f'the 2 steps changed {len(moved)} of {len(after)}', flush=True)
    if not writing or on_disk or differ or not moved or \
            trainer.compiled is None or trainer.compiled.captures != 1:
        raise AssertionError(f'{tag}: the save did not overlap the steps '
                             'or wrote another state')
    times = []
    for epoch in (1, 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.save_checkpoint(epoch, {'val/part_acc': 0.5})
        returned = time.perf_counter() - t0
        torch.cuda.synchronize()
        copied = time.perf_counter() - t0
        trainer.ckpt_mgr.wait_until_finished()
        times.append((returned, copied, trainer.ckpt_mgr.write_seconds[-1]))
    trainer.close()
    print(f'{tag}: the training thread\'s save (returned; with its copy to '
          f'the host done) ' + ', '.join(
              f'{1000 * r:.2f} ms; {1000 * c:.2f} ms' for r, c, _ in times) +
          '; the writer\'s ' + ', '.join(f'{1000 * w:.1f} ms'
                                         for *_, w in times), flush=True)
    return times


def phase_placement(data_dir, tmp):
    """The loader's placement stage (train/trainer.py `DevicePlacement`) on
    the host wire and both slot-wire layouts, the dense one a graphed
    flagship trainer's, and the asynchronous save beside that trainer's
    graphed steps."""
    import train_torch
    from multi_part_assembly_tpu_torch.train.trainer import Trainer
    run_dir = os.path.join(tmp, 'placement')
    cfg = train_torch.build_cfg(train_torch.parse_args([
        '--cfg_file', FLAGSHIP_CFG, '--ckp_dir', run_dir, '--opts',
        'data.data_dir', data_dir, 'exp.val_sample_vis', '0', *DENSE]))
    trainer = Trainer(cfg, 'cuda', ckp_dir=run_dir, resume=False,
                      quiet=True)
    for label, opts, sampler in PLACEMENT_WIRES:
        _placement_wire(label, opts, sampler, data_dir,
                        trainer if opts is DENSE else None)
    return _graphed_save(trainer)


def _ddp_step_cfg(sync_bn):
    """The flagship config at its published width, f32 (the card-vs-CPU
    gates' precision), no warmup, so that step 0 moves the weights."""
    from multi_part_assembly_tpu_torch.utils import load_cfg_file
    cfg = load_cfg_file(FLAGSHIP_CFG)
    cfg.merge_from_list(['optimizer.warmup_ratio', '0.0'])
    cfg.exp.bf16 = False
    cfg.exp.sync_bn = sync_bn
    return cfg


def _no_dropout(model):
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return model


def _ddp_rank_step(inp, sync_bn, device):
    """This rank's half of the global batch through the trainer's
    `optimize_step`: the mean loss, the averaged gradients and the weights
    after Adam (flat, on the CPU), and the kernel launches of the step."""
    from multi_part_assembly_tpu_torch.models import build_model
    from multi_part_assembly_tpu_torch.parallel import dist
    from multi_part_assembly_tpu_torch.train.state import build_optimizer
    from multi_part_assembly_tpu_torch.train.trainer import optimize_step
    cfg = _ddp_step_cfg(sync_bn)
    model = _no_dropout(build_model(cfg, device))
    model.load_state_dict(inp['state'])
    dist.broadcast_module(model)
    opt, schedule = build_optimizer(cfg, 1, model)
    for group in opt.param_groups:
        group['lr'] = schedule(0)
    n = B // dist.world()
    rows = slice(dist.rank() * n, (dist.rank() + 1) * n)
    data = {k: v[rows].to(device) for k, v in inp['batch'].items()}
    tracing.reset()
    logs = optimize_step(model, opt, cfg, data)
    torch.cuda.synchronize()
    launches = _launches()
    return {'loss': logs['loss'], 'grads': _grads(model),
            'params': torch.cat([p.detach().reshape(-1).cpu()
                                 for p in model.parameters()]),
            'launches': launches}


def _ddp_rank_trainer(data_dir, run_dir):
    """train_torch.main on this rank: the flagship config (bf16, published
    width) at B/2 a rank for one epoch on the dense slot wire, a
    validation and a rank-0 checkpoint; then a fresh Trainer resumes from
    it; then one torch.profiler run of two steps with the range
    grad_all_reduce."""
    import train_torch
    from multi_part_assembly_tpu_torch.train.trainer import Trainer
    launches = {}
    validate = Trainer.validate

    def counted_validate(self, epoch):
        torch.cuda.synchronize()
        launches['train'] = _launches()
        metrics = validate(self, epoch)
        torch.cuda.synchronize()
        launches['val'] = {k: v - launches['train'][k]
                           for k, v in _launches().items()}
        return metrics

    Trainer.validate = counted_validate
    try:
        torch.cuda.reset_peak_memory_stats()
        tracing.reset()
        t0 = time.perf_counter()
        trainer = train_torch.main([
            '--cfg_file', FLAGSHIP_CFG, '--ckp_dir', run_dir, '--opts',
            'data.data_dir', data_dir, 'exp.num_epochs', '1',
            'exp.val_every', '1', 'exp.batch_size', str(B // DDP_WORLD),
            *DENSE])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        Trainer.validate = validate
    peak = torch.cuda.max_memory_allocated() / 2**30
    resumed = Trainer(trainer.cfg, 'cuda', ckp_dir=run_dir, quiet=True)
    differ = _differing(_state(resumed), _state(trainer))
    out = {'metrics': trainer.metrics, 'steps': trainer.step_seconds,
           'launches': launches, 'peak_gib': peak, 'wall': wall,
           'saved': trainer.ckpt_mgr.all_steps(),
           'shapes': len(trainer.train_loader.dataset),
           'layout': trainer.tables['train'].layout,
           'resume': (resumed.start_epoch, resumed.step, differ,
                      len(_state(trainer)))}
    resumed.close()
    out['profile'] = _profile_steps(trainer, tries=1,
                                    ranges=('grad_all_reduce', ))
    trainer.close()
    return out


def ddp_rank(folder):
    """One rank of phase_ddp (`chip_smoke.py --ddp-rank FOLDER`, under
    torchrun's variables): (a) the flagship step with sync and with
    per-replica batch norm, (b) the trainer; writes FOLDER/rank{r}.pt."""
    from multi_part_assembly_tpu_torch.parallel import dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = dist.init_distributed('cuda')
    inp = torch.load(os.path.join(folder, 'in.pt'), weights_only=False)
    res = {'rank': dist.rank(), 'world': dist.world(), 'device': str(device),
           'backend': torch.distributed.get_backend()}
    for sync_bn in (True, False):
        res[f'step_sync_{sync_bn}'] = _ddp_rank_step(inp, sync_bn, device)
    res['trainer'] = _ddp_rank_trainer(inp['data_dir'], inp['run_dir'])
    torch.save(res, os.path.join(folder, f'rank{dist.rank()}.pt'))
    dist.barrier()
    dist.destroy()


def _spawn_ddp_ranks(folder):
    """Both ranks of phase_ddp as subprocesses with torchrun's variables,
    each on cuda:0; a rank that fails or outlives DDP_TIMEOUT fails the
    smoke (the other is killed)."""
    import socket
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(DDP_WORLD):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(DDP_WORLD),
                   LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(DDP_WORLD),
                   MASTER_ADDR='127.0.0.1', MASTER_PORT=str(port))
        env.setdefault('GLOO_SOCKET_IFNAME', 'lo')  # both ranks are local
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), '--ddp-rank',
             folder], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        deadline = time.perf_counter() + DDP_TIMEOUT
        for p in procs:
            out, _ = p.communicate(
                timeout=max(1.0, deadline - time.perf_counter()))
            logs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for r, (p, log) in enumerate(zip(procs, logs)):
        for line in log.splitlines():
            if not line.startswith('[W'):  # c10d's socket notices
                print(f'ddp rank {r}| {line}', flush=True)
        if p.returncode != 0:
            raise AssertionError(f'ddp: rank {r} exited with '
                                 f'{p.returncode}')
    return [torch.load(os.path.join(folder, f'rank{r}.pt'),
                       weights_only=False) for r in range(DDP_WORLD)]


def _ddp_reference(model, batch, cfg, sync_bn):
    """The one-process step's (loss, gradient) on the global batch: with
    sync batch norm the whole batch at once; per-replica, JAX's groups
    (norm.py:88-121): each half with its own moments, the losses and the
    gradients averaged."""
    if sync_bn:
        return _step(model, batch, cfg, 'cuda')
    halves = [_step(model, {k: v[rows] for k, v in batch.items()}, cfg,
                    'cuda')
              for rows in (slice(0, B // 2), slice(B // 2, B))]
    return (sum(h[0] for h in halves) / 2,
            sum(h[1] for h in halves) / 2)


def phase_ddp(data_dir, tmp):
    """Data parallelism on two gloo ranks sharing the card (one card: NCCL
    refuses two ranks on one device).  (a) One flagship step at published
    width, f32, dropout off, split 2 x B/2 across the ranks against this
    process's step at B on the same weights and batch: loss within 1e-4
    relative, gradients 1e-3 relative L2 (the card-vs-CPU gates), both
    ranks' weights bitwise equal after Adam, B1-B4 once on each rank; with
    sync batch norm against the whole batch, and per-replica against JAX's
    per-group rule.  (b) train_torch.py's main on each rank: the flagship
    (bf16) at B/2 a rank for one epoch on the dense slot wire, a
    validation (identical metrics on both ranks) and one checkpoint by
    rank 0; a fresh Trainer on each rank resumes from it bitwise.  (c) the
    backend, the world, the step time and data wait, the all-reduce's
    device and host time a step, and each rank's peak memory.  Returns the
    launch counts of this process and of the ranks."""
    from multi_part_assembly_tpu_torch.models import build_model
    tracing.reset()
    folder = os.path.join(tmp, 'ddp')
    run_dir = os.path.join(folder, 'run')
    os.makedirs(folder)
    # a global batch of B shapes, part counts from the everyday mix
    batch = _slice_batch(np.random.default_rng(7).choice(PART_POOL, B), 11)
    torch.manual_seed(0)
    model = _no_dropout(build_model(_ddp_step_cfg(True), 'cuda')).train()
    state = {k: v.detach().cpu().clone()
             for k, v in model.state_dict().items()}
    refs = {}
    for sync_bn in (True, False):
        model.load_state_dict(state)
        refs[sync_bn] = _ddp_reference(model, batch, _ddp_step_cfg(sync_bn),
                                       sync_bn)
    torch.save({'state': state,
                'batch': {k: v.cpu() for k, v in batch.items()},
                'data_dir': data_dir, 'run_dir': run_dir},
               os.path.join(folder, 'in.pt'))
    del model
    torch.cuda.empty_cache()
    totals = _launches()
    t0 = time.perf_counter()
    ranks = _spawn_ddp_ranks(folder)
    wall = time.perf_counter() - t0
    for r, res in enumerate(ranks):
        if (res['rank'], res['world'], res['device'], res['backend']) != \
                (r, DDP_WORLD, 'cuda:0', 'gloo'):
            raise AssertionError(f'ddp: rank {r} ran as {res}')

    # (a) the step split across the ranks
    for sync_bn in (True, False):
        key = f'step_sync_{sync_bn}'
        ref_loss, ref_grads = refs[sync_bn]
        mode = 'sync' if sync_bn else 'per-replica'
        a, b = ranks[0][key], ranks[1][key]
        same = torch.equal(a['params'], b['params']) and \
            torch.equal(a['grads'], b['grads']) and a['loss'] == b['loss']
        for r, res in enumerate(ranks):
            got = res[key]
            rel_loss = abs(got['loss'] - ref_loss) / abs(ref_loss)
            rel_grad = float((got['grads'] - ref_grads).norm() /
                             ref_grads.norm())
            fused = {k: got['launches'][k] for k in FUSED_KEYS}
            print(f'ddp[{mode} BN] rank {r}: loss {got["loss"]:.7f} vs one '
                  f'process {ref_loss:.7f} (rel {rel_loss:.2e}, tolerance '
                  f'1e-4); gradient rel. L2 {rel_grad:.2e} (tolerance '
                  f'1e-3); B1-B4 launches {fused}', flush=True)
            if not (math.isfinite(got['loss']) and rel_loss <= 1e-4 and
                    rel_grad <= 1e-3):
                raise AssertionError(f'ddp[{mode} BN]: rank {r} disagrees '
                                     'with the one-process step')
            if any(v != 1 for v in fused.values()):
                raise AssertionError(f'ddp[{mode} BN]: rank {r} launched '
                                     f'B1-B4 {fused}, expected once each')
        print(f'ddp[{mode} BN]: both ranks\' weights after Adam bitwise '
              f'equal: {same}', flush=True)
        if not same:
            raise AssertionError(f'ddp[{mode} BN]: the ranks diverged')

    # (b) the trainer on both ranks
    tr = [res['trainer'] for res in ranks]
    n = len(tr[0]['steps'])
    n_steps = tr[0]['shapes'] // DDP_WORLD // (B // DDP_WORLD)
    expected = {'nn_parts': n, 'nn_diag': n, 'bwd_parts': n, 'bwd_diag': n,
                'sample_dense': n, 'sample_chunked': 0, 'nn_off': 0,
                'nn_dir': 0, 'lap': 0, 'lap_cost': 0}
    for r, t in enumerate(tr):
        start, step, differ, count = t['resume']
        print(f'ddp[trainer] rank {r}: {t["layout"]} tables; {n} train '
              f'steps of batch {B // DDP_WORLD}; checkpoints {t["saved"]}; '
              f'launches in training {t["launches"]["train"]}, in '
              f'validation {t["launches"]["val"]}; resumed at epoch '
              f'{start}, step {step}, tensors not bitwise equal: {differ} '
              f'of {count}', flush=True)
        if len(t['steps']) != n_steps or t['layout'] != 'dense' or \
                t['saved'] != [0]:
            raise AssertionError(f'ddp[trainer]: rank {r} ran '
                                 f'{len(t["steps"])} steps on '
                                 f'{t["layout"]}, saved {t["saved"]}')
        if _loss_launches(t['launches']['train']) != expected:
            raise AssertionError(f'ddp[trainer]: rank {r} training '
                                 f'launches differ from {expected}')
        val = t['launches']['val']
        if val['nn_diag'] <= 0 or val['sample_dense'] <= 0 or any(
                val[k] for k in ('bwd_parts', 'bwd_diag', 'nn_off',
                                 'nn_dir', 'sample_chunked', 'lap',
                                 'lap_cost')):
            raise AssertionError(f'ddp[trainer]: rank {r} validation '
                                 f'launches {val}')
        if (start, step) != (1, n) or differ:
            raise AssertionError(f'ddp[trainer]: rank {r} resumed state '
                                 'differs from the trained one')
    _check_metrics('ddp[trainer] rank 0', tr[0]['metrics'])
    if tr[0]['metrics'] != tr[1]['metrics']:
        raise AssertionError(f'ddp[trainer]: the ranks\' val metrics differ: '
                             f'{tr[0]["metrics"]} vs {tr[1]["metrics"]}')
    print('ddp[trainer]: both ranks report identical val metrics',
          flush=True)

    # (c) what it cost
    with open(os.path.join(run_dir, 'metrics.jsonl')) as f:
        waits = [1000.0 * r['train/data_time'] for r in map(json.loads, f)
                 if 'train/data_time' in r]
    parts = []
    for r, t in enumerate(tr):
        ms = 1000.0 * sum(t['steps'][1:]) / len(t['steps'][1:])
        prof = t['profile']
        if prof is None:
            ar = 'grad_all_reduce not measured (no device events)'
        else:
            dev, host = prof[3]['grad_all_reduce']
            ar = ('grad_all_reduce device ' + (
                'not measured' if dev is None else f'{dev:.3f} ms') +
                f', host {host:.3f} ms a step')
        parts.append(f'rank {r}: {ms:.2f} ms/step (first '
                     f'{1000 * t["steps"][0]:.1f} ms), peak memory '
                     f'{t["peak_gib"]:.2f} GiB, {ar}; {_profile_line(prof)}')
    print(f'ddp ({DDP_LABEL}; backend gloo, world {DDP_WORLD}, '
          f'{B // DDP_WORLD} a rank = global batch {B}): data wait (rank 0) '
          f'{sum(waits[1:]) / max(1, len(waits[1:])):.3f} ms/step; '
          + '; '.join(parts) + f'; both ranks\' wall {wall:.1f} s. Not a '
          'scaling figure: the ranks share one card and stage every '
          'collective through host memory', flush=True)
    for res in ranks:
        for step in ('step_sync_True', 'step_sync_False'):
            for k, v in res[step]['launches'].items():
                totals[k] += v
        for split in ('train', 'val'):
            for k, v in res['trainer']['launches'][split].items():
                totals[k] += v
    return totals


def _timed(phase, *args):
    """phase(*args), its wall time printed."""
    t0 = time.perf_counter()
    out = phase(*args)
    print(f'{phase.__name__}: {time.perf_counter() - t0:.1f} s', flush=True)
    return out


def main():
    t_start = time.perf_counter()
    phase_device()
    with tempfile.TemporaryDirectory() as tmp:
        phase_build(tmp)
        os.environ['MPA_MESH_CACHE_DIR'] = os.path.join(tmp, 'mesh_cache')
        data_dir = os.path.join(tmp, 'everyday')
        n_pieces = _make_everyday_set(data_dir)
        print(f'data: {n_pieces} pieces in 128 shapes (detail-8 boxes, '
              f'768 faces each)', flush=True)
        print(f'data: host mesh sampler native (C++) '
              f'{MeshSampler().is_native}, library {mesh_io._LIB_PATH}',
              flush=True)
        partnet_dir = _make_partnet_set(os.path.join(tmp, 'partnet'))
        print('data: synthetic PartNet set of 128 shapes (2-20 parts of '
              f'{N} points; 96 train, 32 val)', flush=True)
        results = _timed(phase_kernels)
        results.update(_timed(phase_sampler, data_dir, tmp))
        results['lap'] = _timed(phase_lap, partnet_dir)
        results['lap_cost'] = _timed(phase_lap_cost, partnet_dir)
        results.update(_timed(phase_masked_bn))
        results.update(_timed(phase_max_pool))
        _timed(phase_slice)
        _timed(phase_family_slices)
        _timed(phase_semantic_slice, partnet_dir)
        repulsion_launches = _timed(phase_repulsion)
        launches = _timed(phase_main, data_dir, tmp)
        # the PointNet kernels' rows count the flagship's main runs alone
        main_bn = {k: launches[k] for k in (*BN_KEYS, *POOL_KEYS)}
        _timed(phase_placement, data_dir, tmp)
        for phase in (_timed(phase_resume, data_dir, tmp),
                      _timed(phase_families, data_dir, tmp),
                      _timed(phase_semantic, partnet_dir, tmp),
                      _timed(phase_encoders, data_dir, tmp),
                      _timed(phase_graph, data_dir, partnet_dir, tmp),
                      _timed(phase_ddp, data_dir, tmp)):
            for k, v in phase.items():
                launches[k] += v
    # B7 runs on no training path: its count is the repulsion runs'
    launches['nn_dir'] = repulsion_launches['nn_dir']
    launches.update(main_bn)
    # no single PyTorch call returns a nearest neighbour with its index, a
    # witness scatter with its gather, an alias-table surface sample or a
    # linear assignment: library_ms is null for those kernels; the masked
    # batch norm's is F.batch_norm over the compacted valid rows, the
    # max-pool's torch.amax on the bf16 clouds
    summary = {'kernels': [
        {'name': name, 'route': 'cuda', 'source': source, 'replaces': rep,
         'launches': launches[key], 'max_abs_err': results[key][0],
         'ms': results[key][1], 'plain_ms': results[key][2],
         'bound_ms': results[key][3], 'bound_by': results[key][4],
         'library_ms': (results[key][5:] or [None])[0]}
        for name, key, rep, source in KERNELS]}
    for row in summary['kernels']:
        if row['bound_ms'] > row['ms']:
            raise AssertionError(f'{row["name"]}: {row["ms"]:.4f} ms is under '
                                 f'its bound {row["bound_ms"]:.4f} ms')
    print(f'smoke: total wall time {time.perf_counter() - t_start:.1f} s',
          flush=True)
    print(json.dumps(summary), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    if sys.argv[1:2] == ['--ddp-rank']:
        ddp_rank(sys.argv[2])
    else:
        main()
