"""A/B of the per-layer LSTM stack against the wavefront on one GPU, the
counterpart of ``scripts/bench_wavefront.py``.

Times a G-layer stack in bf16 at encoder shapes, forward and forward +
backward:

- per layer: ``ops/lstm.run_lstm_layer`` for each layer (K1, or under a
  gradient K3a + K3b);
- the wavefront: ``ops/wavefront.run_lstm_stack_wavefront`` (K8-fwd, or
  under a gradient K8-fwd storing the gates + K8-bwd).

Prints the largest difference between the two and the ms of each (CUDA
events, after warm-up), with the card's name and power limit:

    python -m caiman_asr_tpu_torch.bench_wavefront [--large] [-B 96] [-T 200]
        [-G 2] [--t-blk 4] [--i0 0] [--fwd-only]

Runs on the card; raises when there is none.
"""

from __future__ import annotations

import argparse
import math
import subprocess
from typing import Dict, List, Optional, Sequence

import torch

from caiman_asr_tpu_torch.device import resolve_device
from caiman_asr_tpu_torch.ops.lstm import run_lstm_layer
from caiman_asr_tpu_torch.ops.wavefront import run_lstm_stack_wavefront

LEAVES = ("w_ih", "w_hh", "b_ih", "b_hh")


def make_stack(G: int, H: int, I0: int, B: int, T: int, device, seed: int = 0,
               dtype=torch.bfloat16):
    """Random layers (uniform in ±1/sqrt(H), as the JAX package's init; the
    matrices in ``dtype``, the biases fp32, each wanting a gradient), x
    [T, B, I0], zero h0 / c0 [G, B, H] and a cotangent wy [T, B, H]."""
    g = torch.Generator(device=device).manual_seed(seed)
    bound = 1.0 / math.sqrt(H)

    def u(*shape, dt=dtype):
        w = (torch.rand(shape, generator=g, device=device) * 2 - 1) * bound
        return w.to(dt).requires_grad_()

    layers = [{"w_ih": u(4 * H, I0 if l == 0 else H), "w_hh": u(4 * H, H),
               "b_ih": u(4 * H, dt=torch.float32), "b_hh": u(4 * H, dt=torch.float32)}
              for l in range(G)]
    x = torch.randn((T, B, I0), generator=g, device=device).to(dtype)
    h0 = torch.zeros((G, B, H), dtype=dtype, device=device)
    wy = torch.randn((T, B, H), generator=g, device=device).to(dtype)
    return layers, x, h0, h0.clone(), wy


def perlayer_fwd(layers, x, h0, c0) -> torch.Tensor:
    """The top layer's outputs through one ``run_lstm_layer`` per layer."""
    out = x
    for l, p in enumerate(layers):
        out, _ = run_lstm_layer(p, out, h0[l], c0[l])
    return out


def wavefront_fwd(layers, x, h0, c0, t_blk: int = 4, **kw) -> torch.Tensor:
    """The top layer's outputs through the wavefront."""
    return run_lstm_stack_wavefront(layers, x, h0, c0, t_blk=t_blk, **kw)[0][-1]


def grads(fwd, layers, x, h0, c0, wy, **kw) -> List[torch.Tensor]:
    """Gradients of ``sum(fwd(...) * wy)`` (fp32) for every layer's weights."""
    leaves = [p[k] for p in layers for k in LEAVES]
    with torch.enable_grad():
        loss = (fwd(layers, x, h0, c0, **kw) * wy).float().sum()
        return list(torch.autograd.grad(loss, leaves))


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device time of fn() over reps calls, with CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def max_rel(got: Sequence[torch.Tensor], want: Sequence[torch.Tensor]) -> float:
    """The largest difference of a pair, over the largest magnitude of its
    second."""
    return max(((a.float() - b.float()).abs().max()
                / (1e-6 + b.float().abs().max())).item() for a, b in zip(got, want))


def ab(G: int, H: int, I0: int, B: int, T: int, t_blk: int = 4, fwd_only: bool = False,
       device="cuda", reps: int = 10) -> Dict[str, float]:
    """Per-layer stack against the wavefront at one shape, bf16: the largest
    forward difference and gradient difference (relative to each gradient's
    largest magnitude) and the ms of each, forward and forward + backward."""
    layers, x, h0, c0, wy = make_stack(G, H, I0, B, T, device)
    out: Dict[str, float] = {}
    with torch.no_grad():
        a = perlayer_fwd(layers, x, h0, c0)
        b = wavefront_fwd(layers, x, h0, c0, t_blk)
        out["fwd_max_abs_diff"] = (a.float() - b.float()).abs().max().item()
        out["fwd_perlayer_ms"] = cuda_ms(lambda: perlayer_fwd(layers, x, h0, c0), reps)
        out["fwd_wavefront_ms"] = cuda_ms(lambda: wavefront_fwd(layers, x, h0, c0, t_blk),
                                          reps)
    if not fwd_only:
        out["grad_max_rel_diff"] = max_rel(grads(wavefront_fwd, layers, x, h0, c0, wy),
                                           grads(perlayer_fwd, layers, x, h0, c0, wy))
        out["fb_perlayer_ms"] = cuda_ms(lambda: grads(perlayer_fwd, layers, x, h0, c0, wy),
                                        reps)
        out["fb_wavefront_ms"] = cuda_ms(lambda: grads(wavefront_fwd, layers, x, h0, c0, wy),
                                         reps)
    return out


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--large", action="store_true", help="H=1536 (large-196M) instead of 1024")
    ap.add_argument("-B", type=int, default=96)
    ap.add_argument("-T", type=int, default=200)
    ap.add_argument("-G", type=int, default=2)
    ap.add_argument("--t-blk", type=int, default=4)
    ap.add_argument("--i0", type=int, default=0, help="layer-0 input width (default H)")
    ap.add_argument("--fwd-only", action="store_true")
    args = ap.parse_args(argv)
    device = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    H = 1536 if args.large else 1024
    I0 = args.i0 or H
    r = ab(args.G, H, I0, args.B, args.T, args.t_blk, args.fwd_only, device)
    print(card())
    print(f"G={args.G} H={H} I0={I0} B={args.B} T={args.T} t_blk={args.t_blk} bfloat16")
    print(f"fwd max |diff| = {r['fwd_max_abs_diff']:.3e}")
    print(f"fwd  per-layer: {r['fwd_perlayer_ms']:8.3f} ms   wavefront: "
          f"{r['fwd_wavefront_ms']:8.3f} ms ({r['fwd_perlayer_ms'] / r['fwd_wavefront_ms']:.2f}x)")
    if not args.fwd_only:
        print(f"grad max rel diff = {r['grad_max_rel_diff']:.3e}")
        print(f"f+b  per-layer: {r['fb_perlayer_ms']:8.3f} ms   wavefront: "
              f"{r['fb_wavefront_ms']:8.3f} ms ({r['fb_perlayer_ms'] / r['fb_wavefront_ms']:.2f}x)")


if __name__ == "__main__":
    main()
