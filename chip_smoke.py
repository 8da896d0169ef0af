#!/usr/bin/env python3
"""Drive the PyTorch/H100 port's serving path once on the card.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (``nvcc``) and this checkout; it
imports nothing of JAX or of the JAX package.  Phases, each of which raises
on failure (the script then exits non-zero and prints no result):

1. the card's name and power limit (``nvidia-smi``);
2. build every kernel of the path from ``swapnet_tpu_torch/csrc``;
3. each kernel against its plain PyTorch version on the same CUDA tensors,
   at the path's shapes, in float32 and bfloat16, then timed (device time
   by CUDA-graph replay) beside the plain version and the least time the
   card could take;
4. the slice at full width: both generators at 128^2 from a seeded
   ``torch.Generator``, written as a JAX-layout checkpoint directory,
   rebuilt by ``build_fused_swap`` in bfloat16 and served by
   ``SwapService``: 16 single-image requests and one batch of 8, with the
   kernels' launch counts set to 0 just before and read just after;
5. one float32 request on the card (TF32 off) against the same service on
   the CPU, where ROI-Align takes its plain form;
6. a profile of one batch-1 request: device time by kind of kernel.

The last lines are the card line, the kernels' JSON line and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
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
}


def log(msg: str) -> None:
    print(msg, flush=True)


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
        f"({', '.join(logs) or 'already built'} compiled now)")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


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
    return {"max_abs_err": worst, **timings[1], "at_batch_8": timings[8]}


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


def phase_profile(svc, request) -> None:
    """Device time of one batch-1 bf16 swap by kind of kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        svc.swap(*request)
        wall_ms = (time.perf_counter() - t) * 1e3
    kinds, busy, count = {}, 0.0, 0
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = evt.device_time / 1e3
        name = evt.name
        kind = ("roi_align (CUDA kernel)" if "roi_align_kernel" in name
                else "convolution" if ("conv" in name.lower() or "xmma" in name or "cutlass" in name
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
    log(f"[profile] one batch-1 bf16 swap: {count} device ops, device busy {busy:.3f} ms of "
        f"{wall_ms:.3f} ms wall under the profiler (idle share {1 - busy / wall_ms:.3f})")
    for kind, (ms, n) in sorted(kinds.items(), key=lambda kv: -kv[1][0]):
        log(f"[profile]   {kind}: {ms:.3f} ms over {n} ops")


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
    torch.backends.cuda.matmul.allow_tf32 = False  # plain ROI-Align's einsums in full f32
    phase_build()
    kernel = phase_kernel_vs_plain()
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        warp_dir, tex_dir, n_params = write_checkpoints(root)
        log(f"[slice] {n_params} parameters at 128^2 written as JAX-layout checkpoints in "
            f"{time.perf_counter() - t0:.2f} s")
        slice_ = phase_slice(warp_dir, tex_dir, card)
        phase_profile(slice_["svc"], slice_["single"])
        phase_card_vs_cpu(warp_dir, tex_dir)
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")

    entries = []
    for name, (source, replaces) in KERNEL_PATHS.items():
        entries.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": slice_["launches"][name], "max_abs_err": kernel["max_abs_err"],
            "ms": kernel["ms"], "plain_ms": kernel["plain_ms"], "bound_ms": kernel["bound_ms"],
            "bound_by": kernel["bound_by"], "library_ms": kernel["library_ms"],
        })
    log("kernels: " + json.dumps(list(KERNEL_PATHS)))
    log(card)
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
