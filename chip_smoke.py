#!/usr/bin/env python3
"""Drive the PyTorch/H100 port's serving and training paths on the card.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (``nvcc``, ``cuobjdump``) and this
checkout; it imports nothing of JAX or of the JAX package.  Phases, each of
which raises on failure (the script then exits non-zero and prints no
result), each printing its elapsed time.  A watchdog bounds every phase
(``PHASE_BUDGET_S``): a phase that overruns its budget, say a kernel that
never returns, ends the run with exit code 1 after ``faulthandler`` has
printed every thread's stack to stderr, below the phase's start line.

1. the card's name and power limit (``nvidia-smi``);
2. build every kernel of both paths from ``swapnet_tpu_torch/csrc``, one
   ``nvcc`` per source, all at once, and check in ``cuobjdump -sass`` that
   each tensor-core conv3x3 instantiation holds ``HMMA`` instructions;
3. each kernel against its plain PyTorch version on the same CUDA tensors,
   at the paths' shapes, in float32 (TF32 off) and bfloat16, then timed
   (device time by CUDA-graph replay) beside the plain version, a library
   call where one computes the same function, and the least time the card
   could take: ROI-Align at B=1 and 8; conv3x3 at the 13 forward and 13
   input-gradient shapes of the VGG16 at 128^2, B=8, at edge shapes (B 1
   and 2, 8^2, 2^2, 5x7, C=3, N=3, ragged M, N and K), and split-K: each
   slice's partial sums against the plain form's, the unsplit sum against
   the split one, and a split conv run twice to equal bits;
4. ROI-Align's gradient through its autograd function on the card against
   the plain form's autograd gradient;
5. serving at full width: both generators at 128^2 from a seeded
   ``torch.Generator``, written as a JAX-layout checkpoint directory,
   rebuilt by ``build_fused_swap`` in bfloat16 and served by
   ``SwapService``: 16 single-image requests and one batch of 8, with the
   kernels' launch counts set to 0 just before and read just after;
6. one float32 request on the card (TF32 off) against the same service on
   the CPU, and a profile of one batch-1 request;
7. training at full width: ``TextureSystem`` at 128^2, batch 8, bfloat16,
   ``train_step`` for ``TRAIN_STEPS`` steps from seeded generators, with the
   launch counts set to 0 just before and read just after (39 conv3x3 and 1
   ROI-Align launch per step, and the planned split-K reduces), and a
   profile of one step;
8. one float32 train step (TF32 off) at batch 2 on the card against the
   same step on the CPU: every metric and every updated parameter.

The last lines are the card line, the kernels' JSON line and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import faulthandler
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

SIZE = 128
NUM_ROI = 12
CLOTH = 19
# H100 SXM peaks (NVIDIA data sheet), for the bound of each kernel
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
STATS = (([0.5, 0.5, 0.5], [0.25, 0.25, 0.25]), ([0.5, 0.5, 0.5], [0.25, 0.25, 0.25]))
F32_TOL = 1e-5  # kernel vs plain in float32: the same taps, sums in another order
BF16_ULP = 2.0 ** -7  # kernel vs plain in bf16: at most one ulp apart after rounding
STAGE_TOL = 1e-4  # card vs CPU per stage in float32 (TF32 off): ~20 convs, tanh-bounded
MAX_FLIP_SHARE = 5e-3  # card vs CPU: warp argmax flips at near-ties
KERNEL_PATHS = {
    "roi_align": ("swapnet_tpu_torch/csrc/roi_align.cu",
                  "swapnet_tpu/ops/pallas_kernels.py:80"),
    "conv3x3": ("swapnet_tpu_torch/csrc/conv3x3.cu", "swapnet_tpu/ops/conv3x3.py:80"),
}
BF16_FLOPS = 989e12  # dense tensor-core peak, the conv's operations bound
BATCH = 8
TRAIN_STEPS = 10
# VGG16 convs at 128^2: (size, C_in, C_out) in order
VGG_CONVS = [(128, 3, 64), (128, 64, 64), (64, 64, 128), (64, 128, 128),
             (32, 128, 256), (32, 256, 256), (32, 256, 256),
             (16, 256, 512), (16, 512, 512), (16, 512, 512),
             (8, 512, 512), (8, 512, 512), (8, 512, 512)]
CONV_F32_TOL = 5e-5  # kernel vs plain in float32 on O(1) outputs: sums of <= 4608 terms
GRAD_REL_TOL = 1e-5  # ROI-Align gradient, card vs plain, relative to its largest value
METRIC_REL_TOL = 1e-4  # train step card vs CPU in float32: losses
# updated parameters card vs CPU, in units of each optimizer's lr.  Adam's
# first step moves every element by lr * g / (|g| + eps), so where g is
# round-off (conv biases ahead of an instance norm, whose true gradient is
# 0, and single elements whose sum cancels) the sign, and with it the move,
# may differ by up to 2 lr.  Everywhere else the two agree closely
PARAM_MEDIAN_TOL_LR = 1e-3  # the median element
PARAM_SHARE_TOL = 1e-2  # the share of elements further apart than lr / 100
# conv3x3 edge shapes, (B, H, W, C, N, relu): batch 1 and 2, 8^2, 2^2 and a
# non-square image (M not a multiple of 128), C = 3 and N = 3 (element-wise
# gathers, the narrow tile), C and N multiples of 8 but not of 32 (a ragged
# last K step and N tile; the last two with a ragged M on the tiles that run
# two blocks per SM), an N that is not a multiple of 8, an odd N in a split
EDGE_CONVS = [(1, 8, 8, 512, 512, True), (2, 2, 2, 512, 512, False), (2, 5, 7, 64, 128, True),
              (1, 5, 7, 3, 64, True), (2, 5, 7, 64, 3, False), (1, 2, 2, 3, 3, True),
              (2, 9, 11, 24, 40, True), (1, 16, 16, 512, 20, False), (1, 8, 8, 256, 13, True),
              (2, 95, 97, 24, 72, True), (2, 95, 97, 24, 40, False)]
# split-K checks, (B, H, W, C, N): the two deep VGG shapes and an odd N
SPLIT_CONVS = [(BATCH, 16, 16, 512, 512), (BATCH, 8, 8, 512, 512), (1, 8, 8, 256, 13)]
# watchdog per phase, seconds: each at least 10 times what the phase takes on
# an H100 (0.1-15 s; the cold build ~9 s), all of them together within the
# run's 1200 s
PHASE_BUDGET_S = {"build": 300, "roi_align vs plain": 60, "conv3x3 vs plain": 180,
                  "roi_align gradient": 30, "checkpoints": 90, "serving": 90,
                  "serving profile": 30, "serving card vs cpu": 90, "training": 90,
                  "training card vs cpu": 120}


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(name: str, fn, *args):
    """Run one phase under its watchdog: past ``PHASE_BUDGET_S[name]``
    seconds faulthandler prints every thread's stack and exits with 1."""
    budget = PHASE_BUDGET_S[name]
    log(f"[phase] {name} starts (watchdog {budget} s)")
    faulthandler.dump_traceback_later(budget, exit=True)
    t0 = time.perf_counter()
    try:
        out = fn(*args)
    finally:
        faulthandler.cancel_dump_traceback_later()
    log(f"[phase] {name} took {time.perf_counter() - t0:.1f} s")
    return out


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


def cuda_time_ms(fn, iters: int, warmup: int = 5) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_time_ms(fn, replays: int = 20, per_graph: int = 10) -> float:
    """Device time of one call of ``fn``: ``per_graph`` calls captured in a
    CUDA graph, replayed back to back, so host overhead drops out."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    return cuda_time_ms(graph.replay, replays, warmup=2) / per_graph


def nchw_features(gen, B: int, dtype):
    """(B, H, W, 3) features that lie in memory as NCHW, as the texture
    stage hands them to ROI-Align (its permutes are then views)."""
    import torch

    return torch.randn(B, 3, SIZE, SIZE, generator=gen).to("cuda", dtype).permute(0, 2, 3, 1)


def make_boxes(rng, kind: str, B: int, size: int = SIZE):
    import numpy as np

    if kind == "random":
        x1, y1 = rng.uniform(0, size / 2, (2, B, NUM_ROI))
        x2 = x1 + rng.uniform(2, size / 2, (B, NUM_ROI))
        y2 = y1 + rng.uniform(2, size / 2, (B, NUM_ROI))
    elif kind == "out_of_bounds":
        x1, y1 = rng.uniform(-size, size, (2, B, NUM_ROI))
        x2 = x1 + rng.uniform(1, 2 * size, (B, NUM_ROI))
        y2 = y1 + rng.uniform(1, 2 * size, (B, NUM_ROI))
    else:  # degenerate: zero, inverted and sub-pixel boxes at the edges
        x1 = rng.choice([0.0, size - 1.0, size - 0.5, 3.0], (B, NUM_ROI))
        y1 = rng.choice([0.0, size - 1.0, size - 0.5, 5.0], (B, NUM_ROI))
        x2 = x1 + rng.choice([0.0, -2.0, 0.25, 1.0], (B, NUM_ROI))
        y2 = y1 + rng.choice([0.0, -3.0, 0.5, 1.0], (B, NUM_ROI))
    return np.stack([x1, y1, x2, y2], -1).astype(np.float32)


def roi_align_bound(B: int, itemsize: int):
    """(bound_ms, bound_by) of ROI-Align at the path's shapes: each input
    read once and the output written once, against the operations that one
    output (b, r, i, j) takes: ~22 for its two sample positions and taps,
    9 per channel for the bilinear blend."""
    feats = B * SIZE * SIZE * 3 * itemsize
    rois = B * NUM_ROI * 4 * 4
    out = B * NUM_ROI * 3 * SIZE * SIZE * itemsize
    ops = B * NUM_ROI * SIZE * SIZE * (22 + 9 * 3)
    t_bytes = (feats + rois + out) / HBM_BYTES_PER_S
    t_ops = ops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_build() -> None:
    from swapnet_tpu_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build(list(KERNEL_PATHS))
    log(f"[build] {len(KERNEL_PATHS)} CUDA source(s) ready in {time.perf_counter() - t0:.2f} s "
        f"({', '.join(logs) + ' compiled now' if logs else 'already built'})")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"[build] {name}: {line.strip()}")
    hmma = sass_hmma_counts(_build.library_path("conv3x3"))
    tc = {fn: n for fn, n in hmma.items() if "conv3x3_tc_kernel" in fn}
    log(f"[build] conv3x3 SASS, HMMA instructions per kernel: "
        f"{ {short_name(fn): n for fn, n in hmma.items()} }")
    if not tc or min(tc.values()) == 0:
        raise AssertionError(f"the tensor-core conv3x3 kernels hold no HMMA: {tc}")


def short_name(fn: str) -> str:
    """A mangled kernel name cut to its name and tile arguments."""
    for base in ("conv3x3_tc_kernel", "conv3x3_splitk_reduce", "conv3x3_kernel"):
        if base in fn:
            tile = fn.split("TcTileILi", 1)[1].split("EEE")[0] if "TcTile" in fn else ""
            return base + (f"<{tile.replace('ELi', ',').replace('ELb', ',')}>" if tile else "")
    return fn


def sass_hmma_counts(library) -> dict:
    """HMMA instructions in ``cuobjdump -sass`` of a built library, by
    kernel (mangled name)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        line = line.strip()
        if line.startswith("Function :"):
            fn = line.split(":", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and "HMMA" in line:
            counts[fn] += 1
    return counts


def phase_kernel_vs_plain() -> dict:
    import numpy as np
    import torch

    from swapnet_tpu_torch.ops.roi_align import roi_align, roi_align_plain

    rng = np.random.RandomState(0)
    gen = torch.Generator().manual_seed(0)
    worst = 0.0
    for B in (1, 8):
        for dtype in (torch.float32, torch.bfloat16):
            for kind in ("random", "out_of_bounds", "degenerate"):
                feats = nchw_features(gen, B, dtype)
                rois = torch.from_numpy(make_boxes(rng, kind, B)).cuda()
                got = roi_align(feats, rois).float()
                ref = roi_align_plain(feats, rois).float()
                torch.cuda.synchronize()
                err = (got - ref).abs()
                if dtype == torch.float32:
                    ok, limit = bool((err <= F32_TOL).all()), f"{F32_TOL:g}"
                else:
                    ok = bool((err <= BF16_ULP * ref.abs() + 1e-6).all())
                    limit = "1 bf16 ulp of the plain result"
                log(f"[kernel] roi_align B={B} {str(dtype)[6:]} {kind}: "
                    f"max|kernel-plain| {err.max().item():.3e} (limit {limit})")
                if not ok:
                    raise AssertionError(f"roi_align kernel disagrees with plain: B={B} {dtype} {kind}")
                worst = max(worst, err.max().item())

    timings = {}
    for B in (1, 8):
        feats = nchw_features(gen, B, torch.bfloat16)
        rois = torch.from_numpy(make_boxes(rng, "random", B)).cuda()
        kernel_fn = lambda: roi_align(feats, rois)  # noqa: E731
        plain_fn = lambda: roi_align_plain(feats, rois)  # noqa: E731
        ms, plain_ms = device_time_ms(kernel_fn), device_time_ms(plain_fn)
        eager_ms, eager_plain_ms = cuda_time_ms(kernel_fn, 200), cuda_time_ms(plain_fn, 50)
        # no single PyTorch call computes this function: torchvision (whose
        # roi_align does) is not installed, and grid_sample's edge rules differ
        library_ms = None
        bound_ms, bound_by = roi_align_bound(B, 2)
        timings[B] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=bound_ms, bound_by=bound_by)
        log(f"[kernel] roi_align B={B} bf16 128^2 R=12, device time (CUDA graph replay, L2 "
            f"warm as after the preceding op): kernel_ms {ms:.6f}, plain_ms {plain_ms:.6f}, "
            f"library_ms {library_ms}, bound_ms {bound_ms:.6f} ({bound_by}); per eager call "
            f"(host included): kernel {eager_ms:.6f} ms, plain {eager_plain_ms:.6f} ms")
    return {"max_abs_err": worst, **timings[1], "at_batch_8": timings[8],
            "times_at": "one bf16 call at B=1 (B=8 in the log)"}


def write_checkpoints(root: str, seed: int = 0):
    """Both generators at full width from a seeded torch.Generator, written
    as the JAX package's checkpoint directories."""
    import torch

    from swapnet_tpu_torch.models.texture import TextureModule
    from swapnet_tpu_torch.models.warp import WarpModule
    from swapnet_tpu_torch.utils.checkpoint import save_generator_weights
    from swapnet_tpu_torch.utils.from_jax import jax_variables_from_module

    g = torch.Generator().manual_seed(seed)
    warp = WarpModule(body_channels=3, cloth_channels=CLOTH, generator=g)
    tex = TextureModule(texture_channels=3, cloth_channels=CLOTH, num_roi=NUM_ROI,
                        norm_type="instance", img_size=SIZE, generator=g)
    n_params = sum(p.numel() for m in (warp, tex) for p in m.parameters())
    dirs = []
    for name, module, args in (
        ("warp", warp, {"body_representation": "rgb", "cloth_representation": "labels",
                        "body_channels": NUM_ROI, "cloth_channels": CLOTH}),
        ("texture", tex, {"texture_channels": 3, "cloth_channels": CLOTH,
                          "body_channels": NUM_ROI, "crop_size": SIZE, "norm": "instance"}),
    ):
        d = os.path.join(root, name)
        save_generator_weights(d, "latest", jax_variables_from_module(module))
        with open(os.path.join(d, "args.json"), "w") as f:
            json.dump(args, f)
        dirs.append(d)
    return dirs[0], dirs[1], n_params


def make_requests(rng, B: int):
    import numpy as np

    return (rng.randint(0, 256, (B, SIZE, SIZE, 3)).astype(np.uint8),
            rng.randint(0, CLOTH, (B, SIZE, SIZE)).astype(np.uint8),
            rng.randint(0, 256, (B, SIZE, SIZE, 3)).astype(np.uint8),
            make_boxes(rng, "random", B))


def check_output(out, B: int) -> None:
    import numpy as np

    if out.shape != (B, SIZE, SIZE, 3) or out.dtype != np.uint8:
        raise AssertionError(f"swap returned {out.shape} {out.dtype}")
    if out.std() == 0:
        raise AssertionError("swap returned a constant image")


def phase_slice(warp_dir: str, tex_dir: str, card: str) -> dict:
    import numpy as np
    import torch

    from swapnet_tpu_torch.ops.roi_align import roi_align
    from swapnet_tpu_torch.serving import SwapService, build_fused_swap

    t0 = time.perf_counter()
    fused, _ = build_fused_swap(warp_dir, tex_dir, dtype=torch.bfloat16)
    svc = SwapService(fused, *STATS)
    log(f"[slice] bf16 service built from checkpoints in {time.perf_counter() - t0:.2f} s")
    rng = np.random.RandomState(1)
    singles = [make_requests(rng, 1) for _ in range(16)]
    batch = make_requests(rng, 8)
    for req in (singles[0], batch):  # warm-up: cuDNN picks its algorithms
        svc.swap(*req)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    roi_align.launches = 0  # the main path's run starts here
    lat = []
    for req in singles:
        t = time.perf_counter()
        out = svc.swap(*req)
        lat.append((time.perf_counter() - t) * 1e3)
        check_output(out, 1)
    t = time.perf_counter()
    out = svc.swap(*batch)
    batch_ms = (time.perf_counter() - t) * 1e3
    launches = {"roi_align": roi_align.launches}  # ... and ends here
    check_output(out, 8)
    calls = len(singles) + 1
    if launches["roi_align"] != calls:
        raise AssertionError(f"roi_align launched {launches['roi_align']} times in {calls} swaps")
    p50, p95 = np.percentile(lat, [50, 95])
    log(f"[slice] bf16 batch-1 latency over {len(lat)} requests: p50 {p50:.3f} ms, "
        f"p95 {p95:.3f} ms (host clock, uint8 in to uint8 out; {card})")
    log(f"[slice] bf16 batch-8 request: {batch_ms:.3f} ms, {8e3 / batch_ms:.1f} img/s ({card})")
    log(f"[slice] launches in the main path's run: {launches} for {calls} swaps; "
        f"max_memory_allocated {torch.cuda.max_memory_allocated()} B")
    return {"launches": launches, "svc": svc, "single": singles[0]}


def phase_card_vs_cpu(warp_dir: str, tex_dir: str, devices=("cuda", "cpu")) -> None:
    import numpy as np
    import torch

    from swapnet_tpu_torch.data.codec import labels_to_onehot
    from swapnet_tpu_torch.serving import SwapService, build_fused_swap

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    services = {dev: SwapService(build_fused_swap(warp_dir, tex_dir, dtype=torch.float32,
                                                  device=dev)[0], *STATS)
                for dev in devices}
    body_u8, labels, tex_u8, rois = make_requests(np.random.RandomState(2), 1)
    body = (torch.from_numpy(body_u8).permute(0, 3, 1, 2).float() / 255.0 - 0.5) / 0.25
    tex = (torch.from_numpy(tex_u8).permute(0, 3, 1, 2).float() / 255.0 - 0.5) / 0.25
    cloth = labels_to_onehot(torch.from_numpy(labels), CLOTH)
    rois_t = torch.from_numpy(rois)
    logits, stage = {}, {}
    with torch.inference_mode():
        for dev, svc in services.items():
            logits[dev] = svc.fused.warp(body.to(dev), cloth.to(dev)).cpu()
        onehot = labels_to_onehot(logits[devices[1]].argmax(1), CLOTH)
        for dev, svc in services.items():
            stage[dev] = svc.fused.texture(tex.to(dev), rois_t.to(dev), onehot.to(dev)).cpu()
    out = {dev: svc.swap(body_u8, labels, tex_u8, rois) for dev, svc in services.items()}
    card, host = devices
    warp_err = (logits[card] - logits[host]).abs().max().item()
    tex_err = (stage[card] - stage[host]).abs().max().item()
    flips = (logits[card].argmax(1) != logits[host].argmax(1)).numpy()
    diff = np.abs(out[card].astype(np.int16) - out[host].astype(np.int16))[0].max(-1)
    outside = int(diff[~flips[0]].max())
    log(f"[card-vs-cpu] f32, TF32 off: warp logits max diff {warp_err:.3e} (limit {STAGE_TOL:g}); "
        f"texture stage on the same one-hot {tex_err:.3e} (limit {STAGE_TOL:g}); argmax flips "
        f"{int(flips.sum())} of {flips.size} (limit {MAX_FLIP_SHARE:g} share); uint8 swap max "
        f"diff {outside} outside flips (limit 1)")
    if warp_err > STAGE_TOL or tex_err > STAGE_TOL or flips.mean() > MAX_FLIP_SHARE or outside > 1:
        raise AssertionError("card and CPU disagree beyond the stated tolerances")


def phase_profile(fn, what: str) -> None:
    """Device time of one call of ``fn`` by kind of kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    kinds, busy, count = {}, 0.0, 0
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = evt.device_time / 1e3
        name = evt.name
        kind = ("roi_align (CUDA kernel)" if "roi_align_kernel" in name
                else "conv3x3 (tensor-core kernel)" if "conv3x3_tc_kernel" in name
                else "conv3x3 (split-K reduce)" if "conv3x3_splitk_reduce" in name
                else "conv3x3 (CUDA-core kernel)" if "conv3x3_kernel" in name
                else "convolution (cuDNN)" if ("conv" in name.lower() or "xmma" in name or "cutlass" in name
                                       or "gemm" in name.lower())
                else "layout transpose" if ("nchwToNhwc" in name or "nhwcToNchw" in name)
                else "reduction" if "reduce" in name.lower()
                else "copy/cast" if ("copy" in name.lower() or "Memcpy" in name or "Memset" in name)
                else "elementwise/other")
        k = kinds.setdefault(kind, [0.0, 0])
        k[0] += ms
        k[1] += 1
        busy += ms
        count += 1
    if count == 0:
        log("[profile] the profiler recorded no device time: not measured")
        return
    log(f"[profile] {what}: {count} device ops, device busy {busy:.3f} ms of "
        f"{wall_ms:.3f} ms wall under the profiler (idle share {1 - busy / wall_ms:.3f})")
    for kind, (ms, n) in sorted(kinds.items(), key=lambda kv: -kv[1][0]):
        log(f"[profile]   {kind}: {ms:.3f} ms over {n} ops")


def conv_bound(B: int, S: int, C: int, N: int, itemsize: int):
    """(bound_ms, bound_by) of one 3x3 conv: 2*B*S*S*9*C*N operations at the
    bf16 tensor-core peak, against x, the weights, the bias and y, each
    moved once."""
    flops = 2 * B * S * S * 9 * C * N
    moved = (B * S * S * C + 9 * C * N + N + B * S * S * N) * itemsize
    t_ops, t_bytes = flops / BF16_FLOPS, moved / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def conv_rows():
    """The 26 GEMMs of a train step's VGG: each forward conv (ReLU, bias)
    and its input gradient (g has C_out channels, flipped weights, no ReLU,
    zero bias), as (label, S, C_in of the GEMM, N of the GEMM, relu, grad)."""
    rows = [(f"fwd {c}->{n} @{s}", s, c, n, True, False) for s, c, n in VGG_CONVS]
    rows += [(f"dx  {n}->{c} @{s}", s, n, c, False, True) for s, c, n in VGG_CONVS]
    return rows


def conv_operands(gen, H: int, W: int, C: int, N: int, grad: bool, dtype, B: int = BATCH):
    """x (B, H, W, C), the GEMM's weight matrix and bias on the card."""
    import torch

    from swapnet_tpu_torch.ops.conv3x3 import input_grad_matrix, weight_matrix

    x = torch.randn(B, H, W, C, generator=gen).to("cuda", dtype)
    if grad:  # the VGG weight is (C_out=C, C_in=N, 3, 3); the GEMM maps C -> N
        w = (torch.randn(C, N, 3, 3, generator=gen) / (9 * N) ** 0.5).cuda()
        wmat, bias = input_grad_matrix(w, dtype), torch.zeros(N, dtype=dtype, device="cuda")
        w_direct = w.flip(2, 3).transpose(0, 1).contiguous().to(dtype)
    else:
        w = (torch.randn(N, C, 3, 3, generator=gen) / (9 * C) ** 0.5).cuda()
        wmat, bias = weight_matrix(w, dtype), (0.1 * torch.randn(N, generator=gen)).to("cuda", dtype)
        w_direct = w.to(dtype)
    return x, wmat, bias, w_direct


def plan_of(x, wmat):
    from swapnet_tpu_torch.ops.conv3x3 import conv3x3_plan

    B, H, W, C = x.shape
    return conv3x3_plan(B, H, W, C, wmat.shape[1], x.dtype)


def conv_error(x, wmat, bias, relu: bool, splits=None):
    """The kernel against the plain form on the same tensors: (max error,
    whether every element is within the limit, the limit, the output)."""
    import torch

    from swapnet_tpu_torch.ops.conv3x3 import conv3x3_gemm, conv3x3_gemm_plain

    out = conv3x3_gemm(x, wmat, bias, relu, splits)
    got = out.float()
    ref = conv3x3_gemm_plain(x, wmat, bias, relu).float()
    torch.cuda.synchronize()
    err = (got - ref).abs()
    if x.dtype == torch.float32:
        return err.max().item(), bool((err <= CONV_F32_TOL).all()), f"{CONV_F32_TOL:g}", out
    # the float32 sums (which differ by up to the float32 limit where terms
    # cancel) may straddle a bf16 rounding boundary, once for the sum and
    # once after the bias: two ulps of each
    acc = conv3x3_gemm_plain(x.float(), wmat.float(), torch.zeros_like(bias).float(), False)
    ok = bool((err <= BF16_ULP * (acc.abs() + ref.abs()) + CONV_F32_TOL).all())
    return err.max().item(), ok, f"2 bf16 ulps of |sum| + |result|, + {CONV_F32_TOL:g}", out


def plan_text(plan) -> str:
    return f"{plan.tile} S={plan.splits} blocks={plan.blocks}"


def check_split(gen, B: int, H: int, W: int, C: int, N: int) -> float:
    """Split-K on the card: each slice's float32 partial sums against the
    plain form's, the sum of the planned slices (in order) against the
    unsplit sum, both within the float32 limit; the unsplit and the split
    conv against the plain form; the split conv twice, to equal bits."""
    import torch

    from swapnet_tpu_torch.ops.conv3x3 import conv3x3_partials, conv3x3_partials_plain

    x, wmat, bias, _ = conv_operands(gen, H, W, C, N, False, torch.bfloat16, B)
    plan = plan_of(x, wmat)
    S = plan.splits
    if S < 2:
        raise AssertionError(f"B={B} {H}x{W} {C}->{N} was meant to split: {plan}")
    parts = conv3x3_partials(x, wmat, S)
    whole = conv3x3_partials(x, wmat, 1)[0]
    slices_err = (parts - conv3x3_partials_plain(x, wmat, S)).abs().max().item()
    total = parts[0].clone()
    for s in range(1, S):
        total += parts[s]
    sum_err = (total - whole).abs().max().item()
    errs = {}
    for splits in (1, S):
        err, ok, limit, _ = conv_error(x, wmat, bias, True, splits)
        errs[splits] = err
        if not ok:
            raise AssertionError(f"conv3x3 S={splits} disagrees with plain: B={B} {H}x{W} "
                                 f"{C}->{N} max {err:.3e} (limit {limit})")
    first = conv_error(x, wmat, bias, True)[3]
    again = conv_error(x, wmat, bias, True)[3]
    same = torch.equal(first, again)
    log(f"[conv3x3] split B={B} {H}x{W} {C}->{N} bf16, {plan_text(plan)}: slices vs plain "
        f"slices {slices_err:.3e}, sum of {S} slices vs unsplit sum {sum_err:.3e} (limit "
        f"{CONV_F32_TOL:g}); vs plain S=1 {errs[1]:.3e}, S={S} {errs[S]:.3e}; repeat "
        f"bitwise equal: {same}")
    if slices_err > CONV_F32_TOL or sum_err > CONV_F32_TOL or not same:
        raise AssertionError(f"split-K check failed at B={B} {H}x{W} {C}->{N}")
    return max(errs.values())


def phase_conv3x3() -> dict:
    import torch
    import torch.nn.functional as F

    from swapnet_tpu_torch.ops.conv3x3 import conv3x3_gemm, conv3x3_gemm_plain

    gen = torch.Generator().manual_seed(3)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    limits = f"limits {CONV_F32_TOL:g}; 2 bf16 ulps + {CONV_F32_TOL:g}"
    for label, S, C, N, relu, grad in conv_rows():
        for dtype in (torch.float32, torch.bfloat16):
            x, wmat, bias, _ = conv_operands(gen, S, S, C, N, grad, dtype)
            err, ok, limit, _ = conv_error(x, wmat, bias, relu)
            worst[dtype] = max(worst[dtype], err)
            if not ok:
                raise AssertionError(f"conv3x3 kernel disagrees with plain: {label} {dtype} "
                                     f"max {err:.3e} (limit {limit})")
        log(f"[conv3x3] {label} B={BATCH} ({plan_text(plan_of(x, wmat))}): max|kernel-plain| "
            f"f32 {worst[torch.float32]:.3e}, bf16 {worst[torch.bfloat16]:.3e} so far ({limits})")
    for B, H, W, C, N, relu in EDGE_CONVS:
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            x, wmat, bias, _ = conv_operands(gen, H, W, C, N, False, dtype, B)
            err, ok, limit, _ = conv_error(x, wmat, bias, relu)
            errs[str(dtype)[6:]] = f"{err:.3e}"
            worst[dtype] = max(worst[dtype], err)
            if not ok:
                raise AssertionError(f"conv3x3 kernel disagrees with plain: edge B={B} {H}x{W} "
                                     f"{C}->{N} {dtype} max {err:.3e} (limit {limit})")
        log(f"[conv3x3] edge B={B} {H}x{W} {C}->{N} relu={relu} ({plan_text(plan_of(x, wmat))}): "
            f"max|kernel-plain| {errs} ({limits})")
    for B, H, W, C, N in SPLIT_CONVS:
        worst[torch.bfloat16] = max(worst[torch.bfloat16], check_split(gen, B, H, W, C, N))

    totals = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, ops=0.0)
    by = {"operations": 0.0, "bytes": 0.0}  # bound time by what bounds each launch
    for label, S, C, N, relu, grad in conv_rows():
        x, wmat, bias, w_direct = conv_operands(gen, S, S, C, N, grad, torch.bfloat16)
        x_nchw = x.permute(0, 3, 1, 2)  # channels-last memory, as cuDNN takes it

        def library():
            y = F.conv2d(x_nchw, w_direct, bias, padding=1)
            return y.relu_() if relu else y

        ms = device_time_ms(lambda: conv3x3_gemm(x, wmat, bias, relu), replays=5, per_graph=5)
        plain_ms = device_time_ms(lambda: conv3x3_gemm_plain(x, wmat, bias, relu),
                                  replays=5, per_graph=5)
        library_ms = device_time_ms(library, replays=5, per_graph=5)
        bound_ms, bound_by = conv_bound(BATCH, S, C, N, 2)
        # the forward convs run twice a step (fakes and targets), the input
        # gradients once
        times = 1 if grad else 2
        for key, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", library_ms),
                       ("bound_ms", bound_ms)):
            totals[key] += times * v
        totals["ops"] += times * 2 * BATCH * S * S * 9 * C * N
        by[bound_by] += times * bound_ms
        log(f"[conv3x3] {label} B={BATCH} bf16 ({plan_text(plan_of(x, wmat))}): kernel_ms "
            f"{ms:.6f}, plain_ms {plain_ms:.6f}, library_ms (cuDNN) {library_ms:.6f}, bound_ms "
            f"{bound_ms:.6f} ({bound_by}); {2 * BATCH * S * S * 9 * C * N / ms / 1e9:.2f} TFLOP/s")
    log(f"[conv3x3] one train step's 39 launches (13 fwd x 2 + 13 dx), bf16: kernel "
        f"{totals['ms']:.3f} ms ({totals['ops'] / totals['ms'] / 1e9:.2f} TFLOP/s), plain "
        f"{totals['plain_ms']:.3f} ms, cuDNN {totals['library_ms']:.3f} ms, bound "
        f"{totals['bound_ms']:.3f} ms")
    return {"max_abs_err": max(worst.values()), "ms": totals["ms"],
            "plain_ms": totals["plain_ms"], "library_ms": totals["library_ms"],
            "bound_ms": totals["bound_ms"], "bound_by": max(by, key=by.get),
            "times_at": "the 39 launches of one train step, B=8, 128^2, bf16"}


def phase_roi_align_grad() -> None:
    """The gradient through the kernel's autograd function on the card
    against the plain form's autograd gradient, float32."""
    import numpy as np
    import torch

    from swapnet_tpu_torch.ops.roi_align import roi_align, roi_align_plain

    rng = np.random.RandomState(4)
    gen = torch.Generator().manual_seed(4)
    for kind in ("random", "out_of_bounds", "degenerate"):
        base = nchw_features(gen, BATCH, torch.float32)
        rois = torch.from_numpy(make_boxes(rng, kind, BATCH)).cuda()
        weight = torch.randn(BATCH, NUM_ROI, SIZE, SIZE, 3, generator=gen).cuda()
        grads = []
        for fn in (roi_align, roi_align_plain):
            feats = base.detach().requires_grad_(True)
            out = fn(feats, rois)
            if out.grad_fn is None:
                raise AssertionError(f"{fn.__name__} output carries no gradient")
            (out * weight).sum().backward()
            grads.append(feats.grad)
        torch.cuda.synchronize()
        err = (grads[0] - grads[1]).abs().max().item()
        scale = grads[1].abs().max().item()
        log(f"[roi-grad] B={BATCH} f32 {kind}: max|kernel grad - plain grad| {err:.3e} of "
            f"max {scale:.3e} (limit {GRAD_REL_TOL:g} relative)")
        if err > GRAD_REL_TOL * scale:
            raise AssertionError(f"ROI-Align gradient disagrees on the card: {kind}")


def texture_batch(B: int, device, seed: int = 0):
    """The texture stage's batch, as bench.py builds it, in NCHW."""
    import numpy as np
    import torch

    r = np.random.RandomState(seed)
    rois = r.uniform(2, SIZE - 2, (B, NUM_ROI, 4)).astype(np.float32)
    rois[..., 2:] = np.minimum(rois[..., :2] + SIZE // 4, SIZE - 1)
    onehot = np.eye(CLOTH, dtype=np.float32)[r.randint(0, CLOTH, (B, SIZE, SIZE))]

    def nchw(a):
        return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2))).to(device)

    return {"input_textures": nchw(r.randn(B, SIZE, SIZE, 3).astype(np.float32)),
            "rois": torch.from_numpy(rois).to(device), "cloths": nchw(onehot),
            "target_textures": nchw(r.randn(B, SIZE, SIZE, 3).astype(np.float32))}


def phase_train(card: str) -> dict:
    import math

    import torch

    from swapnet_tpu_torch.ops.conv3x3 import conv3x3_bias_act, conv3x3_plan
    from swapnet_tpu_torch.ops.roi_align import roi_align
    from swapnet_tpu_torch.training.texture_system import TextureSystem

    t0 = time.perf_counter()
    system = TextureSystem(img_size=SIZE, dtype=torch.bfloat16)
    state = system.init_state(0)
    batch = texture_batch(BATCH, "cuda")
    counts = {n: sum(p.numel() for p in m.parameters())
              for n, m in (("G", state.G), ("D", state.D), ("VGG", state.vgg))}
    log(f"[train] TextureSystem 128^2 bf16 built in {time.perf_counter() - t0:.2f} s: "
        f"parameters {counts}")
    state, _ = system.train_step(state, batch)  # warm-up: cuDNN picks its algorithms
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # the planned split-K convs of a step: forward ones twice, gradients once
    reduces_per_step = sum((1 if grad else 2) for _, S, C, N, _, grad in conv_rows()
                           if conv3x3_plan(BATCH, S, S, C, N, torch.bfloat16).splits > 1)
    conv3x3_bias_act.launches = roi_align.launches = 0  # the main path's run starts here
    conv3x3_bias_act.splitk_reduces = 0
    t = time.perf_counter()
    history = []
    for _ in range(TRAIN_STEPS):
        state, metrics = system.train_step(state, batch)
        history.append(metrics)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) * 1e3 / TRAIN_STEPS
    launches = {"conv3x3": conv3x3_bias_act.launches, "roi_align": roi_align.launches}
    reduces = conv3x3_bias_act.splitk_reduces  # ... and ends here
    for metrics in history:
        bad = {k: v.item() for k, v in metrics.items() if not math.isfinite(v.item())}
        if bad:
            raise AssertionError(f"non-finite train metrics: {bad}")
    if launches != {"conv3x3": 39 * TRAIN_STEPS, "roi_align": TRAIN_STEPS}:
        raise AssertionError(f"launches {launches} in {TRAIN_STEPS} steps, expected 39 "
                             "conv3x3 and 1 roi_align per step")
    if reduces != reduces_per_step * TRAIN_STEPS:
        raise AssertionError(f"{reduces} split-K reduces in {TRAIN_STEPS} steps, planned "
                             f"{reduces_per_step} per step")
    last = {k: round(v.item(), 5) for k, v in history[-1].items()}
    log(f"[train] {TRAIN_STEPS} steps at 128^2, batch {BATCH}, bf16: {step_ms:.3f} ms/step, "
        f"{BATCH * 1e3 / step_ms:.1f} img/s (host clock around synchronised steps; {card})")
    log(f"[train] launches in the main path's run: {launches}, of which conv3x3 split-K "
        f"reduces {reduces} ({reduces_per_step} per step, as planned); max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} B; last metrics {last}")
    phase_profile(lambda: system.train_step(state, batch), "one bf16 train step")
    return {"launches": launches, "splitk_reduces": reduces}


def _params(state):
    return {f"{net}.{name}": p.detach().cpu().clone()
            for net, m in (("G", state.G), ("D", state.D)) for name, p in m.named_parameters()}


def phase_train_card_vs_cpu(devices=("cuda", "cpu")) -> None:
    """One float32 step (TF32 off) on the card and on the CPU from the same
    weights.  Dropout is off and labels are fixed: the card's and the CPU's
    generators draw different numbers from one seed."""
    import torch

    from swapnet_tpu_torch.losses.gan import GANLossConfig
    from swapnet_tpu_torch.training.texture_system import TextureSystem

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    metrics, before, after, lrs = {}, {}, {}, {}
    card, host = devices
    for dev in devices:
        system = TextureSystem(img_size=SIZE, dtype=torch.float32, dropout=0.0,
                               gan_cfg=GANLossConfig(smooth_labels=False), device=dev)
        state = system.init_state(0)
        before[dev] = _params(state)
        t = time.perf_counter()
        state, m = system.train_step(state, texture_batch(2, dev, seed=5))
        metrics[dev] = {k: v.item() for k, v in m.items()}
        log(f"[train-card-vs-cpu] f32 step at batch 2 on {dev}: "
            f"{time.perf_counter() - t:.2f} s")
        after[dev] = _params(state)
        lrs = {"G": system.g_opt_cfg.lr, "D": system.d_opt_cfg.lr}
    for k in metrics[host]:
        a, b = metrics[card][k], metrics[host][k]
        if abs(a - b) > METRIC_REL_TOL * max(1.0, abs(b)):
            raise AssertionError(f"{k}: card {a} vs CPU {b}")
    errs = []
    for name, p_cpu in after[host].items():
        if not torch.equal(before[card][name], before[host][name]):
            raise AssertionError(f"{name}: the two runs started from different weights")
        lr = lrs[name.split(".")[0]]
        errs.append(((after[card][name] - p_cpu).abs() / lr).flatten())
    errs = torch.cat(errs)
    median, far = errs.median().item(), (errs > 0.01).double().mean().item()
    log(f"[train-card-vs-cpu] metrics within {METRIC_REL_TOL:g} relative: "
        f"{ {k: (round(metrics[card][k], 6), round(metrics[host][k], 6)) for k in metrics[host]} }")
    log(f"[train-card-vs-cpu] updated parameters, |card - CPU| in lr: median {median:.2e} "
        f"(limit {PARAM_MEDIAN_TOL_LR:g}), 99.9th percentile "
        f"{torch.quantile(errs[::97].double(), 0.999).item():.3f}, max {errs.max().item():.3f}; "
        f"share beyond lr/100 {far:.2e} (limit {PARAM_SHARE_TOL:g}) of {errs.numel()}")
    if median > PARAM_MEDIAN_TOL_LR or far > PARAM_SHARE_TOL:
        raise AssertionError("card and CPU train steps disagree beyond the stated limits")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import swapnet_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable next to this script: {e}", file=sys.stderr)
        return 1

    t_start = time.perf_counter()
    card = card_line()
    log(f"[card] {card}")
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    # every float32 comparison in full float32: plain ROI-Align's einsums,
    # the plain conv3x3 and the card-vs-CPU runs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    timed("build", phase_build)
    roi = timed("roi_align vs plain", phase_kernel_vs_plain)
    conv = timed("conv3x3 vs plain", phase_conv3x3)
    timed("roi_align gradient", phase_roi_align_grad)
    with tempfile.TemporaryDirectory() as root:
        warp_dir, tex_dir, n_params = timed("checkpoints", write_checkpoints, root)
        log(f"[slice] {n_params} parameters at 128^2 written as JAX-layout checkpoints")
        slice_ = timed("serving", phase_slice, warp_dir, tex_dir, card)
        timed("serving profile", phase_profile,
              lambda: slice_["svc"].swap(*slice_["single"]), "one batch-1 bf16 swap")
        timed("serving card vs cpu", phase_card_vs_cpu, warp_dir, tex_dir)
    del slice_["svc"]
    train = timed("training", phase_train, card)
    timed("training card vs cpu", phase_train_card_vs_cpu)
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")

    launches = {name: {"serving": slice_["launches"].get(name, 0),
                       "training": train["launches"][name]} for name in KERNEL_PATHS}
    entries = []
    for name, (source, replaces) in KERNEL_PATHS.items():
        kernel = {"roi_align": roi, "conv3x3": conv}[name]
        entries.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(launches[name].values()), "launches_by_path": launches[name],
            "max_abs_err": kernel["max_abs_err"], "ms": kernel["ms"],
            "plain_ms": kernel["plain_ms"], "bound_ms": kernel["bound_ms"],
            "bound_by": kernel["bound_by"], "library_ms": kernel["library_ms"],
            "times_at": kernel["times_at"],
        })
        if name == "conv3x3":
            entries[-1]["splitk_reduces"] = train["splitk_reduces"]
    log("kernels: " + json.dumps(list(KERNEL_PATHS)))
    log(card)
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0

if __name__ == "__main__":
    sys.exit(main())
