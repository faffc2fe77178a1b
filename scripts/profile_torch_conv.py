"""Time the VGG prefix's conv kernels on one CUDA card.

    python scripts/profile_torch_conv.py [--batch 8] [--height 368] \
        [--width 432] [--reps 5] [--seed 0]

The port's counterpart of the JAX package's ``scripts/profile_fused_conv.py``
and ``scripts/profile_block1.py``. With the seeded weights of the port's
``VGG19Backbone`` and seeded bf16 frames it runs vgg2016's blocks 1, 2 and
3 through ``conv_chain`` (each block's input is the twin's output of the
block before; block 1 must launch ``block1_fused`` once, blocks 2 and 3
``conv3x3_sm90`` once per layer, as the wrappers' counts show), blocks
1, 2 and 3 in float32 through ``conv_chain`` (one ``conv3x3_f32`` launch
per layer, each block's input the float32 twin's output of the block
before), block 1 through ``conv1_fused`` and ``block1_fused``, conv1_2 +
pool and each layer of blocks 2 and 3 through ``conv3x3_sm90`` alone
(each layer's input the twin's output of the layer before), and a narrow
bf16 chain (block 1 at 32 channels, seeded weights) that only
``conv_chain.cu`` takes. For each it prints the max error relative to
max|twin| against the plain twin (float32 sums, TF32 off), the kernel's,
the twin's and cuDNN's time (the same convs + bias + ReLU + pool in the
input's dtype, ``channels_last``, TF32 off, the library yardstick), the
kernel's TFLOP/s and share of the dtype's peak, and its bound (from the
shapes). Times are means of ``--reps`` calls by CUDA events, in turns:
twin, kernel, cuDNN, cuDNN, kernel, twin.

Then the prefix path: ``prefix_forward`` with each block-1 route in bf16
and the ``conv_chain`` route in float32, against ``backbone[:19]`` on
cuDNN in bf16 ``channels_last`` and in float32 with TF32 off, each bf16
route timed in turns with cuDNN's, and the float32 pass in turns with
cuDNN's float32 ``backbone[:19]``.

``chip_smoke.py`` loads this file by path and uses its helpers. It runs
only on a card.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import os
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)

#: NVIDIA H100 SXM, dense (data sheet): bf16 tensor cores, float32 outside
#: them, and HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, by CUDA events,
    after one warm-up call."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def turns(fns, reps: int):
    """Mean times of ``fns``, measured in turns: in order, then reversed."""
    first = [time_ms(fn, reps) for fn in fns]
    second = [time_ms(fn, reps) for fn in reversed(fns)][::-1]
    return [(a + b) / 2 for a, b in zip(first, second)]


@contextlib.contextmanager
def no_tf32():
    """float32 convolutions in full float32 (cuDNN's default is TF32)."""
    import torch

    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = old


def bound_ms(flops: float, nbytes: float, dtype) -> tuple:
    """(least time in ms, "operations" or "bytes") on an H100 at its
    published peaks."""
    ops = flops / PEAK_FLOPS[str(dtype).split(".")[-1]] * 1e3
    mem = nbytes / HBM_BYTES_PER_S * 1e3
    return (ops, "operations") if ops >= mem else (mem, "bytes")


def chain_work(x, params, out) -> tuple:
    """(FLOPs, bytes) of a SAME 3x3 conv chain: 2 * pixels * 9 * ci * co
    per layer; each input, weight (in x's dtype), bias (float32) and
    output counted once."""
    b, h, w, _ = x.shape
    flops = sum(2 * b * h * w * 9 * wt.shape[2] * wt.shape[3]
                for wt, _ in params)
    nbytes = (x.numel() + out.numel() + sum(wt.numel() for wt, _ in params)) \
        * x.element_size() + sum(bs.numel() * 4 for _, bs in params)
    return flops, nbytes


def cudnn_chain(params, pool: bool, dtype):
    """The library yardstick: the chain as cuDNN convs + bias + ReLU
    (+ max pool) in ``dtype``, ``channels_last``; NHWC in, NCHW
    ``channels_last`` out."""
    import torch
    import torch.nn.functional as F

    ws = [(w.permute(3, 2, 0, 1).to(dtype).contiguous(
        memory_format=torch.channels_last), b.to(dtype))
        for w, b in params]

    def run(x):
        y = x.permute(0, 3, 1, 2)       # NHWC storage: channels_last, no copy
        for w, b in ws:
            y = F.relu(F.conv2d(y, w, b, padding=1), inplace=True)
        return F.max_pool2d(y, 2, 2) if pool else y

    return run


def counted() -> dict:
    """name -> (wrapper, kernel source) of each conv kernel; each wrapper
    counts its own kernel's launches in ``.launches``."""
    from torch_ekpose_tpu_torch.ops import block1, conv_chain as cc

    return {"conv_chain": (cc.conv_chain, "csrc/conv_chain.cu"),
            "conv3x3_sm90": (cc.conv3x3_sm90, "csrc/conv3x3_sm90.cu"),
            "conv3x3_f32": (cc.conv3x3_f32, "csrc/conv3x3_f32.cu"),
            "conv1_fused": (block1.conv1_fused, "csrc/block1_sm90.cu"),
            "block1_fused": (block1.block1_fused, "csrc/block1_sm90.cu")}


def launch_counts() -> dict:
    return {name: f.launches for name, (f, _) in counted().items()}


def launched_since(before: dict) -> dict:
    """name -> launches since ``before`` (a :func:`launch_counts`), for
    each kernel that launched."""
    now = launch_counts()
    return {n: now[n] - before[n] for n in now if now[n] != before[n]}



def _sm90_layer_twin(x, w, b, pool=False):
    from torch_ekpose_tpu_torch.ops.conv_chain import conv_chain_torch

    return conv_chain_torch(x, [(w, b)], pool)


def prefix_cases(model, x1):
    """The prefix path's kernel calls at the shapes it gives them: blocks
    1-3 through ``conv_chain`` in bf16 (blocks 2 and 3 on the twin's output
    of the block before) and in float32 (on the float32 twin's outputs),
    block 1 through ``conv1_fused`` and ``block1_fused``; each with the
    launches it must make (bf16 block 1 one ``block1_fused``, bf16 blocks 2
    and 3 one ``conv3x3_sm90`` per layer, float32 one ``conv3x3_f32`` per
    layer)."""
    from torch_ekpose_tpu_torch.models.vgg import chain_params
    from torch_ekpose_tpu_torch.ops import block1, conv_chain as cc

    p = [chain_params(model, blk) for blk in (1, 2, 3)]
    cases = []
    for dtype in (x1.dtype, "float32"):
        xs = [x1 if dtype != "float32" else x1.float()]
        with no_tf32():
            for i in (0, 1):
                xs.append(cc.conv_chain_torch(xs[-1], p[i], True))
        for i, x in enumerate(xs):
            if dtype == "float32":
                name, label = "conv3x3_f32", f"block{i + 1} float32"
                launches = {"conv3x3_f32": len(p[i])}
            else:
                name, label = "conv_chain", f"block{i + 1}"
                launches = ({"block1_fused": 1} if i == 0
                            else {"conv3x3_sm90": len(p[i])})
            cases.append(dict(name=name, label=label, kernel=cc.conv_chain,
                              twin=cc.conv_chain_torch, args=(x, p[i]),
                              kwargs={"pool": True}, params=p[i], pool=True,
                              launches=launches))
    cases.append(dict(name="conv1_fused", label="conv1_1",
                      kernel=block1.conv1_fused, twin=block1.conv1_fused_torch,
                      args=(x1, *p[0][0]), kwargs={}, params=p[0][:1],
                      pool=False, launches={"conv1_fused": 1}))
    cases.append(dict(name="block1_fused", label="block1",
                      kernel=block1.block1_fused,
                      twin=block1.block1_fused_torch,
                      args=(x1, *p[0][0], *p[0][1]), kwargs={}, params=p[0],
                      pool=True, launches={"block1_fused": 1}))
    return cases


def narrow_cases(x1, seed: int = 0):
    """A bf16 chain that only ``conv_chain.cu`` takes, on the prefix's
    frames: block 1 at 32 channels (``[3, 32, 32]`` + pool), seeded
    weights scaled by sqrt(2 / fan-in)."""
    import torch

    from torch_ekpose_tpu_torch.ops import conv_chain as cc

    gen = torch.Generator(device=x1.device).manual_seed(seed)
    params = [(torch.randn((3, 3, ci, co), generator=gen, device=x1.device)
               * (2 / (9 * ci)) ** 0.5,
               torch.randn((co,), generator=gen, device=x1.device) * 0.1)
              for ci, co in ((3, 32), (32, 32))]
    return [dict(name="conv_chain", label="block1 narrow 3-32-32",
                 kernel=cc.conv_chain, twin=cc.conv_chain_torch,
                 args=(x1, params), kwargs={"pool": True}, params=params,
                 pool=True, launches={"conv_chain": 1})]


def sm90_layer_cases(model, x1):
    """conv1_2 + pool (the ``conv1_fused`` route's second call, N tile 64)
    and each layer of blocks 2 and 3 (conv2_1 .. conv3_4, the pool with
    each block's last, N tile 128) through ``conv3x3_sm90`` alone, on the
    twin's output of the layer before."""
    from torch_ekpose_tpu_torch.models.vgg import chain_params
    from torch_ekpose_tpu_torch.ops import conv_chain as cc

    (w1, b1), (w2, b2) = chain_params(model, 1)
    with no_tf32():
        x = cc.conv_chain_torch(x1, [(w1, b1)], False)
    cases = [dict(name="conv3x3_sm90", label="conv1_2", kernel=cc.conv3x3_sm90,
                  twin=_sm90_layer_twin, args=(x, w2, b2),
                  kwargs={"pool": True}, params=[(w2, b2)], pool=True,
                  launches={"conv3x3_sm90": 1})]
    with no_tf32():
        x = _sm90_layer_twin(x, w2, b2, True)
    for blk in (2, 3):
        params = chain_params(model, blk)
        for j, (w, b) in enumerate(params):
            pool = j == len(params) - 1
            cases.append(dict(name="conv3x3_sm90", label=f"conv{blk}_{j + 1}",
                              kernel=cc.conv3x3_sm90, twin=_sm90_layer_twin,
                              args=(x, w, b), kwargs={"pool": pool},
                              params=[(w, b)], pool=pool,
                              launches={"conv3x3_sm90": 1}))
            with no_tf32():
                x = _sm90_layer_twin(x, w, b, pool)
    return cases


def check_case(case, tol: float) -> tuple:
    """One call against the twin (TF32 off): the conv kernels' counts rise
    by exactly ``case["launches"]`` (name -> launches) and the max error
    is within ``tol`` of max|twin|. Returns (kernel output, max_abs_err,
    max_rel_err)."""
    import torch

    kernel, args, kwargs = case["kernel"], case["args"], case["kwargs"]
    before = launch_counts()
    got = kernel(*args, **kwargs)
    with no_tf32():
        want = case["twin"](*args, **kwargs)
    torch.cuda.synchronize()
    launched = launched_since(before)
    if launched != case["launches"]:
        raise AssertionError(f"{case['name']} {case['label']}: launched "
                             f"{launched}, not {case['launches']}")
    if got.shape != want.shape or got.dtype != want.dtype or not bool(
            torch.isfinite(got).all()):
        raise AssertionError(f"{case['name']}: {got.dtype} {tuple(got.shape)}"
                             f" vs twin {want.dtype} {tuple(want.shape)}")
    err = float((got.float() - want.float()).abs().max())
    rel = err / float(want.float().abs().max())
    if not rel <= tol:
        raise AssertionError(f"{case['name']} {case['label']}: relative "
                             f"error {rel} > {tol}")
    return got, err, rel


def measure_case(case, reps: int) -> dict:
    """Check one case (within 1e-4 of max|twin| in float32, 0.02 in bf16)
    and time the twin, the kernel and cuDNN in turns. ``launched`` and
    ``source`` are the kernels the checked call launched, as their counts
    showed."""
    import torch

    kernel, twin, args, kwargs = (case["kernel"], case["twin"], case["args"],
                                  case["kwargs"])
    x = args[0]
    out, err, rel = check_case(
        case, 1e-4 if x.dtype == torch.float32 else 0.02)
    lib = cudnn_chain(case["params"], case["pool"], x.dtype)
    with no_tf32():
        plain_ms, ms, library_ms = turns(
            [lambda: twin(*args, **kwargs), lambda: kernel(*args, **kwargs),
             lambda: lib(x)], reps)
    flops, nbytes = chain_work(x, case["params"], out)
    bound, bound_by = bound_ms(flops, nbytes, x.dtype)
    sources = counted()
    return {"name": case["name"], "shape": case["label"],
            "launched": case["launches"],
            "source": " ".join(sources[n][1] for n in case["launches"]),
            "input": list(x.shape), "max_abs_err": err, "max_rel_err": rel,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound, "bound_by": bound_by, "gflop": flops / 1e9,
            "tflops": flops / ms / 1e9,
            "peak_share": flops / ms / 1e-3
            / PEAK_FLOPS[str(x.dtype).split(".")[-1]]}


def print_case(r: dict) -> None:
    print(f"{r['name']} {r['shape']} (launched {r['launched']}) "
          f"{r['input']}: rel err "
          f"{r['max_rel_err']:.3e} (abs {r['max_abs_err']:.3e}); kernel "
          f"{r['ms']:.4f} ms, twin {r['plain_ms']:.4f} ms, cuDNN "
          f"{r['library_ms']:.4f} ms; {r['gflop']:.1f} GFLOP, "
          f"{r['tflops']:.1f} TFLOP/s = {100 * r['peak_share']:.1f}% of "
          f"the dtype's peak; bound {r['bound_ms']:.4f} ms by {r['bound_by']}",
          flush=True)


#: each conv kernel's launches in one bf16 pass of the prefix path, per
#: block-1 route: block 1's kernels (the ``conv_chain`` route sends the
#: pooled [3, 64, 64] chain to ``block1_fused``; the ``conv1_fused`` route
#: runs conv1_2 + pool as one ``conv3x3_sm90`` at N tile 64), then blocks
#: 2 and 3 as six ``conv3x3_sm90``; the fused ``conv_chain`` kernel none
PREFIX_LAUNCHES = {
    "conv_chain": {"block1_fused": 1, "conv3x3_sm90": 6},
    "block1_fused": {"block1_fused": 1, "conv3x3_sm90": 6},
    "conv1_fused": {"conv1_fused": 1, "conv3x3_sm90": 7},
}
#: the same for a float32 pass of the ``conv_chain`` route: one
#: ``conv3x3_f32`` launch per layer (2 + 2 + 4), the fused ``conv_chain``
#: kernel none
PREFIX_LAUNCHES_F32 = {"conv3x3_f32": 8}


def drive_prefix(model, x) -> tuple:
    """The prefix path once per block-1 route: (route -> NHWC output,
    route -> the conv kernels' launches during that route, which must be
    :data:`PREFIX_LAUNCHES`)."""
    from torch_ekpose_tpu_torch.models.vgg import BLOCK1_ROUTES, prefix_forward

    outs, launched = {}, {}
    for route in BLOCK1_ROUTES:
        before = launch_counts()
        outs[route] = prefix_forward(model, x, route)
        launched[route] = launched_since(before)
    if launched != PREFIX_LAUNCHES:
        raise AssertionError(f"prefix path launched {launched}, not "
                             f"{PREFIX_LAUNCHES}")
    return outs, launched


def drive_prefix_f32(model, x) -> dict:
    """The ``conv_chain`` route of the prefix path once in float32 on
    ``x``: it must launch :data:`PREFIX_LAUNCHES_F32` and stay within 1e-4
    of max|ref| of ``backbone[:19]`` on cuDNN in float32 with TF32 off.
    Returns the launches, the relative error and the pass's time (one
    call, CUDA events)."""
    import torch

    from torch_ekpose_tpu_torch.models.vgg import PREFIX_END, prefix_forward

    x = x.float()
    before = launch_counts()
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    start.record()
    out = prefix_forward(model, x, "conv_chain")
    end.record()
    end.synchronize()
    launched = launched_since(before)
    if launched != PREFIX_LAUNCHES_F32:
        raise AssertionError(f"float32 prefix path launched {launched}, not "
                             f"{PREFIX_LAUNCHES_F32}")
    with torch.no_grad(), no_tf32():
        ref = model.backbone[:PREFIX_END](
            x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    rel = float((out - ref).abs().max() / ref.abs().max())
    if out.shape != ref.shape or not rel <= 1e-4:
        raise AssertionError(f"float32 prefix: {tuple(out.shape)}, rel {rel}")
    return {"launched": launched, "rel_err_vs_cudnn_f32": rel,
            "ms": start.elapsed_time(end)}


def time_prefix_f32(model, x, reps: int) -> tuple:
    """(kernels ms, cuDNN ms): the float32 pass of the ``conv_chain``
    route and cuDNN's float32 ``backbone[:19]`` (TF32 off), in turns."""
    import torch

    from torch_ekpose_tpu_torch.models.vgg import PREFIX_END, prefix_forward

    x = x.float()
    ref = model.backbone[:PREFIX_END]
    with torch.no_grad(), no_tf32():
        return tuple(turns([lambda: prefix_forward(model, x, "conv_chain"),
                            lambda: ref(x.permute(0, 3, 1, 2))], reps))


def cudnn_prefix(model):
    """``backbone[:19]`` in bf16 ``channels_last`` on cuDNN: NHWC in, NHWC
    (a view) out."""
    import torch

    from torch_ekpose_tpu_torch.models.vgg import PREFIX_END

    ref = copy.deepcopy(model.backbone[:PREFIX_END]).to(
        dtype=torch.bfloat16, memory_format=torch.channels_last)
    return lambda x: ref(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def check_prefix(model, x, outs: dict) -> dict:
    """Each route against cuDNN's bf16 ``backbone[:19]`` (max error within
    0.05 of max|cuDNN|: both round to bf16 after each of 8 layers, in
    other places) and against float32 with TF32 off (cosine > 0.999, and
    cuDNN's bf16 cosine beside it)."""
    import torch

    from torch_ekpose_tpu_torch.models.vgg import PREFIX_END

    with torch.no_grad(), no_tf32():
        ref16 = cudnn_prefix(model)(x).float()
        ref32 = model.backbone[:PREFIX_END](
            x.float().permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def cos(a, b):
        a, b = a.double().ravel(), b.double().ravel()
        return float(a @ b / (a.norm() * b.norm()))

    report = {"cudnn_bf16_cosine_vs_f32": cos(ref16, ref32)}
    for route, out in outs.items():
        if out.shape != ref16.shape or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"prefix {route}: {tuple(out.shape)}")
        rel = float((out.float() - ref16).abs().max() / ref16.abs().max())
        c = cos(out.float(), ref32)
        report[route] = {"rel_err_vs_cudnn_bf16": rel, "cosine_vs_f32": c}
        if not (rel <= 0.05 and c > 0.999):
            raise AssertionError(f"prefix {route}: rel {rel}, cosine {c}")
    return report


def time_prefix(model, x, reps: int) -> tuple:
    """(route -> kernels ms, cuDNN ms): each block-1 route of the prefix
    path and cuDNN's bf16 ``channels_last`` ``backbone[:19]``, in turns."""
    import torch

    from torch_ekpose_tpu_torch.models.vgg import BLOCK1_ROUTES, prefix_forward

    ref = cudnn_prefix(model)
    fns = [lambda r=r: prefix_forward(model, x, r) for r in BLOCK1_ROUTES]
    with torch.no_grad():
        *times, cudnn_ms = turns(fns + [lambda: ref(x)], reps)
    return dict(zip(BLOCK1_ROUTES, times)), cudnn_ms


def device_ms(fn, kernel: str, reps: int) -> tuple:
    """(device ms of the kernels whose name holds ``kernel``, device ms of
    every kernel) per call of ``fn``, from one ``torch.profiler`` pass over
    ``reps`` calls after a warm-up: the wrapper's own work (weight
    packing, allocation) is the difference."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(3):   # a pass whose trace lacks the kernel is taken again
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        mine = total = 0.0
        for evt in prof.key_averages():
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                total += evt.device_time_total
                if kernel in evt.key:
                    mine += evt.device_time_total
        if mine > 0:
            return mine / reps / 1e3, total / reps / 1e3
        seen.append(sorted({e.key[:60] for e in prof.key_averages()
                            if e.device_time_total > 0}))
    raise AssertionError(f"the profiler saw no device time of {kernel} in "
                         f"3 passes; it saw {seen}")


def main(argv=None) -> int:
    sys.path.insert(0, ROOT)
    import torch

    from torch_ekpose_tpu_torch.models.vgg import VGG19Backbone

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--height", type=int, default=368)
    parser.add_argument("--width", type=int, default=432)
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_conv: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    print(card, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    torch.manual_seed(args.seed)
    model = VGG19Backbone(device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    x = torch.randn((args.batch, args.height, args.width, 3), generator=gen,
                    device="cuda").to(torch.bfloat16)
    with torch.no_grad():
        results = [measure_case(case, args.reps)
                   for case in prefix_cases(model, x)]
        for r in results:
            print_case(r)
        for case in sm90_layer_cases(model, x) + narrow_cases(x):
            print_case(measure_case(case, args.reps))
        report = check_prefix(model, x, drive_prefix(model, x)[0])
        print(f"prefix path vs backbone[:19]: {report}")
        print(f"float32 prefix path: {drive_prefix_f32(model, x)}")
        route_ms, cudnn_ms = time_prefix(model, x, args.reps)
        f32_ms, cudnn_f32_ms = time_prefix_f32(model, x, args.reps)
    print(f"prefix path (blocks 1-3), batch {args.batch} at {args.height}x"
          f"{args.width} bf16, by block-1 route: {route_ms} ms; cuDNN "
          f"{cudnn_ms:.4f} ms; float32 (conv3x3_f32) {f32_ms:.4f} ms, cuDNN "
          f"float32 {cudnn_f32_ms:.4f} ms, on {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
